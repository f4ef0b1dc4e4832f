"""Data parallelism across processes on ``torch.distributed``: the world and
its collectives (``distributed``), the [data, model] mesh of ranks
(``mesh``), and which batch arrays split over which axis (``sharding``)."""

from open_knowledge_graph_embeddings_tpu_torch.parallel.distributed import (  # noqa: F401
    all_processes_sum,
    local_eval_mesh,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from open_knowledge_graph_embeddings_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    default_mesh,
    make_mesh,
)
from open_knowledge_graph_embeddings_tpu_torch.parallel.sharding import (  # noqa: F401
    block,
    train_batch_shardings,
)
