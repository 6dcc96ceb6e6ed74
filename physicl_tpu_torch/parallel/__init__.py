"""Multi-device runs: the particle axis sharded over a 1-D device mesh.

Counterpart of ``physicl_tpu/parallel``. Particles are independent, so a
run shards its photons across the mesh (pure data parallelism); only the
measurement records and the global exit test cross shards. In one process
a mesh is any ordered list of devices, a device possibly repeated
(:func:`make_mesh`); across processes, :func:`init_distributed` sets up the
process group and :func:`make_pod_mesh` the mesh over every process's
shards (:mod:`physicl_tpu_torch.parallel.distributed`).
"""

from physicl_tpu_torch.parallel.sharding import (
    PHOTON_AXIS,
    Mesh,
    ShardedState,
    make_mesh,
    shard_state,
)
from physicl_tpu_torch.parallel.distributed import (
    fetch_to_every_host,
    init_distributed,
    is_multiprocess,
    local_shard_np,
    make_pod_mesh,
    mesh_spans_processes,
    process_local_slice,
    shard_state_multiprocess,
)

__all__ = ["make_mesh", "shard_state", "PHOTON_AXIS", "make_pod_mesh",
           "is_multiprocess", "init_distributed", "Mesh", "ShardedState",
           "mesh_spans_processes", "process_local_slice",
           "fetch_to_every_host", "local_shard_np",
           "shard_state_multiprocess"]
