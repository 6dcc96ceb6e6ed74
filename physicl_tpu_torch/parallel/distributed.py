"""Process-spanning runs: not ported yet.

Counterpart of ``physicl_tpu/parallel/distributed.py``. In one process a
pod mesh is the plain mesh (:func:`make_pod_mesh` is
:func:`physicl_tpu_torch.parallel.make_mesh`, as the JAX package's own
docstring says) and :func:`is_multiprocess` is False. Setting up a process
group and any mesh that spans processes (the pod mesh across hosts, the
multi-process divergence guard, the E-list allgather, shard-local traces)
are ROADMAP.md queue 1 item 2: they raise ``NotImplementedError`` by name
rather than run on one process in silence.
"""

from __future__ import annotations

import torch

__all__ = ["init_distributed", "make_pod_mesh", "is_multiprocess"]

_WHAT = ("process-spanning meshes (torch.distributed across processes; "
         "ROADMAP.md queue 1 item 2)")


def _refuse(what: str):
    from physicl_tpu_torch.engine import _not_ported

    _not_ported(f"{what}: {_WHAT}")


def is_multiprocess() -> bool:
    """True iff this process belongs to an initialized ``torch.distributed``
    group of more than one process."""
    dist = torch.distributed
    return bool(dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, **kwargs) -> None:
    """Process-group set-up for a mesh across processes: not ported yet
    (raises ``NotImplementedError``)."""
    _refuse("init_distributed")


def make_pod_mesh(devices=None):
    """The 1-D photon mesh over every device of the run. In one process
    this is :func:`physicl_tpu_torch.parallel.make_mesh` over ``devices``
    (default: every CUDA device); across processes it is not ported yet."""
    from physicl_tpu_torch.parallel.sharding import make_mesh

    if is_multiprocess():
        _refuse("make_pod_mesh")
    return make_mesh(devices=devices)
