"""Host helpers in C++ (``oket_native.cpp``), loaded through ctypes: the
mapped-file reader and the row-sparse plan kernels.  Built with g++ on first
use; without a compiler, or with ``OKET_DISABLE_NATIVE`` set, the callers
run their numpy branches."""

from open_knowledge_graph_embeddings_tpu_torch.native.loader import (  # noqa: F401
    grad_plan_native,
    native_available,
    read_triple_file_native,
    unique_remap_native,
)
