"""Mesh parallelism: dp over a window's frames, sp over rows
(parallel/mesh.py), the sharded step (parallel/step.py), the multi-process
feed (parallel/multihost.py) and the dry run (parallel/dryrun.py).
torch.distributed is imported only where a mesh spans processes."""

from gstbad_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, ShardedBatch, make_mesh, pipeline_shardings, shard_batch,
    shard_spatial)
from gstbad_tpu_torch.parallel.multihost import feed_window  # noqa: F401
