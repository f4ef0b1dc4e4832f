"""Data and model parallelism across processes on ``torch.distributed``: the
world, its groups and its collectives (``distributed``), the [data, model]
mesh of ranks (``mesh``), which leaves and batch arrays split over which axis
(``sharding``), and the explicit-collective lookup step (``shard_map_score``)."""

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
    opt_state_shardings,
    shard_variables,
    slab_bounds,
    train_batch_shardings,
    variables_shardings,
)
