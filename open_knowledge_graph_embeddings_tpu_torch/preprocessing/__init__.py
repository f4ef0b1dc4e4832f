"""The OLPBench creation pipeline: pure Python over the standard library and
numpy (no torch), the port's copy of
``open_knowledge_graph_embeddings_tpu/preprocessing/``."""

from open_knowledge_graph_embeddings_tpu_torch.preprocessing.pipeline import PipelineJob  # noqa: F401
from open_knowledge_graph_embeddings_tpu_torch.preprocessing.search import TripleSearchIndex  # noqa: F401
