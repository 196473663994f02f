"""Multi-rank scaling over ``torch.distributed`` (port of
``aloam_tpu/parallel``): streams split over the "data" axis, the map
tables and the reference points of the neighbour search over "model"."""

from aloam_tpu_torch.parallel.sharding import (  # noqa: F401
    batched_init, batched_step_fn, batched_step_jit, gather_outputs,
    gather_tables, graphed, make_mesh, model_shard, shard_tables, sharded_knn)
from aloam_tpu_torch.parallel import distributed  # noqa: F401
