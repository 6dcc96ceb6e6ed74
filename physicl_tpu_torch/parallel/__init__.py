"""Multi-device runs: the particle axis sharded over a 1-D device mesh.

Counterpart of ``physicl_tpu/parallel``. Particles are independent, so a
run shards its photons across the mesh (pure data parallelism); only the
measurement records and the global exit test cross shards. In one process
a mesh is any ordered list of devices, a device possibly repeated
(:func:`make_mesh`); runs across processes are not ported yet
(:mod:`physicl_tpu_torch.parallel.distributed`).
"""

from physicl_tpu_torch.parallel.sharding import (
    PHOTON_AXIS,
    Mesh,
    ShardedState,
    make_mesh,
    shard_state,
)
from physicl_tpu_torch.parallel.distributed import (
    init_distributed,
    is_multiprocess,
    make_pod_mesh,
)

__all__ = ["make_mesh", "shard_state", "PHOTON_AXIS", "make_pod_mesh",
           "is_multiprocess", "init_distributed", "Mesh", "ShardedState"]
