"""Runs across processes: one identical script per process, one mesh over
every process's shards.

Counterpart of ``physicl_tpu/parallel/distributed.py``. Particles are
independent, so a run across processes is the one-process mesh split by
owner: each process holds the shards of one contiguous span of the
particle axis and launches its own kernels on them; only the measurement
records, the exit test and the chunk-boundary edits cross processes, as
collectives of ``torch.distributed``. Launch recipe (every process runs
the same script, SPMD: populations, steps, seeds and mid-run edits match
across processes)::

    # torchrun --nproc-per-node=4 run.py   (one process per card)
    init_distributed()
    mesh = make_pod_mesh()
    sim = Simulation(mesh=mesh, ...)

:func:`init_distributed` sets up the process group from its arguments or
from the variables ``torchrun`` sets. The group's collectives on host
tensors (record rows, the divergence guard's row) go over gloo; where every
process has a card of its own, a second group over NCCL carries the device
tensors (planes gathered at an edit), and elsewhere (the CPU, several
processes on one card, where NCCL refuses two ranks on one device) they
are staged through host memory over gloo. Every collective here must be
called by every process at the same point of the run: the engine calls
them on its run thread, in an order that depends only on values identical
on every process.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["init_distributed", "make_pod_mesh", "is_multiprocess",
           "mesh_spans_processes", "process_local_slice",
           "fetch_to_every_host", "local_shard_np",
           "shard_state_multiprocess", "process_index", "process_count"]

DEFAULT_TIMEOUT = 600.0  # seconds a collective waits for a lost process

# the NCCL group for device tensors, where every process has its own card
_device_group = None


def _dist():
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    """The number of processes of the run (1 outside a process group)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def is_multiprocess() -> bool:
    """True iff this process belongs to an initialized ``torch.distributed``
    group of more than one process."""
    return process_count() > 1


def _own_card() -> Optional[torch.device]:
    """The process's own card: ``cuda:LOCAL_RANK``, else ``cuda:0``; None
    without a card."""
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout: float = DEFAULT_TIMEOUT, **kwargs) -> None:
    """Set up the process group (wraps
    ``torch.distributed.init_process_group``); call once per process,
    before :func:`make_pod_mesh`.

    With no arguments it reads what ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` names
    the process's card). Otherwise pass the coordinator's ``"host:port"``
    (it becomes ``tcp://host:port``), the process count and this process's
    rank. The group runs over gloo; where every process has a card of its
    own (distinct ``(host, card)`` pairs) an NCCL group also carries the
    device tensors, and elsewhere they are staged through host memory.
    A one-process group opens no NCCL group (nothing crosses processes).
    ``timeout`` (seconds) bounds every collective's wait,
    so that a lost process fails the others instead of hanging them.
    ``kwargs`` go to ``init_process_group``."""
    global _device_group
    env = os.environ
    if coordinator_address is None:
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError(
                "init_distributed: pass coordinator_address='host:port', or "
                "set MASTER_ADDR and MASTER_PORT (torchrun sets them)")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist = torch.distributed
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout)), **kwargs)
    _device_group = None
    if dist.get_world_size() == 1:
        return
    card = _own_card()
    mine = (socket.gethostname(), None if card is None else card.index)
    everyone: List = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine)
    if (all(c is not None for _, c in everyone)
            and len(set(everyone)) == len(everyone)):
        torch.cuda.set_device(card)
        _device_group = dist.new_group(backend="nccl")


def device_collectives() -> bool:
    """True iff device tensors cross processes over NCCL (every process
    has a card of its own), not through host memory."""
    return _device_group is not None


def mesh_spans_processes(mesh) -> bool:
    """True iff the mesh holds shards owned by other processes (their
    planes live there: reading them is a collective)."""
    return bool(getattr(mesh, "spans_processes", False))


def make_pod_mesh(devices=None):
    """The 1-D photon mesh over every process's shards, process-major:
    rank 0's shards first, each process's shards contiguous (the JAX
    package's CPU-cluster order). ``devices`` lists this process's own
    shards' devices (a device may repeat, to put several shards on one
    card); every process passes the same count. The default is the
    process's own card (``cuda:LOCAL_RANK``, else ``cuda:0``). In one
    process this is :func:`physicl_tpu_torch.parallel.make_mesh` over
    ``devices`` (default: every CUDA device)."""
    from physicl_tpu_torch.parallel.sharding import Mesh, make_mesh

    if not is_multiprocess():
        return make_mesh(devices=devices)
    if devices is None:
        card = _own_card()
        if card is None:
            raise RuntimeError("make_pod_mesh: no CUDA device; pass "
                               "devices=['cpu'] for a mesh on the CPU")
        devices = [card]
    local = list(make_mesh(devices=devices))
    dist = torch.distributed
    names: List = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local])
    counts = [len(n) for n in names]
    if len(set(counts)) != 1:
        raise ValueError(f"make_pod_mesh: every process must hold the same "
                         f"number of shards, got {counts} by rank")
    rank = dist.get_rank()
    shards, owners = [], []
    for r, ns in enumerate(names):
        shards += local if r == rank else [torch.device(n) for n in ns]
        owners += [r] * len(ns)
    return Mesh(shards, owners=owners, rank=rank)


def process_local_slice(mesh, global_shape: tuple) -> tuple:
    """(start, size) of this process's contiguous span of the particle axis.

    Valid for process-major meshes built by :func:`make_pod_mesh`, where
    each process's shards occupy one contiguous block of the 1-D mesh.
    """
    owners = getattr(mesh, "owners", None)
    owners = (list(owners) if owners is not None
              else [process_index()] * len(mesh))
    n = len(owners)
    cap = int(global_shape[-1])
    if cap % n:
        raise ValueError(f"capacity {cap} does not divide mesh size {n}")
    per_dev = cap // n
    me = getattr(mesh, "rank", process_index())
    mine = [i for i, o in enumerate(owners) if o == me]
    if not mine:
        raise ValueError("mesh contains no local devices")
    if mine != list(range(mine[0], mine[0] + len(mine))):
        raise ValueError("pod mesh must be ICI-major (local devices "
                         "contiguous); use make_pod_mesh()")
    return mine[0] * per_dev, len(mine) * per_dev


# -- collectives -------------------------------------------------------------


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.detach().reshape(-1).contiguous().view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: Sequence[torch.Tensor]):
    out, o = [], 0
    for x in like:
        n = x.numel() * x.element_size()
        # a copy of its own: a slice at an odd offset cannot be viewed
        # as a wider type
        out.append(buf[o:o + n].clone().view(x.dtype).reshape(x.shape))
        o += n
    return out


def _packed(tensors: Sequence[torch.Tensor]):
    """One byte buffer of ``tensors``, on the device the collective uses:
    the first tensor's card with the NCCL group, else the host."""
    dev = tensors[0].device if tensors else torch.device("cpu")
    if dev.type != "cuda" or _device_group is None:
        dev = torch.device("cpu")
    if not tensors:
        return torch.zeros(0, dtype=torch.uint8), dev
    buf = torch.cat([_as_bytes(x).to(dev) for x in tensors])
    return buf, dev


def all_gather_tensors(tensors: Sequence[torch.Tensor]
                       ) -> List[List[torch.Tensor]]:
    """Every process's ``tensors`` (the same shapes and dtypes on every
    process), in rank order, each on the device of this process's tensor
    of the same place: one collective for the lot."""
    tensors = list(tensors)
    dist = torch.distributed
    buf, dev = _packed(tensors)
    group = _device_group if dev.type == "cuda" else None
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, buf, group=group)
    return [[y.to(x.device) for y, x in zip(_from_bytes(o, tensors),
                                            tensors)] for o in outs]


def broadcast_tensors(tensors: Sequence[torch.Tensor],
                      src: int) -> List[torch.Tensor]:
    """Process ``src``'s ``tensors`` on every process (each process passes
    tensors of the same shapes and dtypes; only ``src``'s values count),
    on the devices of this process's tensors: one collective."""
    tensors = list(tensors)
    buf, dev = _packed(tensors)
    group = _device_group if dev.type == "cuda" else None
    torch.distributed.broadcast(buf, src=int(src), group=group)
    return [y.to(x.device) for y, x in zip(_from_bytes(buf, tensors),
                                           tensors)]


def all_gather_varlen(x: torch.Tensor) -> List[torch.Tensor]:
    """Every process's 1-D ``x`` (lengths may differ), in rank order, on
    ``x``'s device: two collectives (the lengths, then the values padded
    to the longest)."""
    n = torch.tensor([x.numel()], dtype=torch.int64)
    sizes = [int(s[0]) for (s,) in all_gather_tensors([n])]
    if not max(sizes):
        return [x[:0] for _ in sizes]
    pad = torch.zeros(max(sizes), dtype=x.dtype, device=x.device)
    pad[:x.numel()] = x
    return [p[:s] for (p,), s in zip(all_gather_tensors([pad]), sizes)]


def fetch_to_every_host(x, mesh=None) -> np.ndarray:
    """``np.asarray`` of a particle-axis record channel, complete on every
    process.

    ``x`` is this process's span of the channel (the particle axis last).
    On a mesh that spans processes every process's span is all-gathered and
    joined in global slot order, so EVERY process assembles the identical,
    complete measurement; it must be called in lockstep on every process
    (the engine's record harvest is: it runs the same loop everywhere).
    Elsewhere it is a plain fetch: the collective costs nothing when it is
    not needed.
    """
    t = torch.as_tensor(x)
    if mesh_spans_processes(mesh):
        t = torch.cat([p for (p,) in all_gather_tensors([t])], dim=-1)
    return t.detach().cpu().numpy()


def local_shard_np(x, mesh=None):
    """``(host_array, col0)``: this process's contiguous span of a
    particle-axis channel, plus the global index of its first column.

    The shard-local counterpart of :func:`fetch_to_every_host` for channels
    too large to allgather (trace stream buffers). ``x`` is this process's
    span (a tensor or a host array), the particle axis last; ``col0`` is
    where the span starts in the global axis, found by
    :func:`process_local_slice` (which requires this process's shards to be
    contiguous, as :func:`make_pod_mesh` makes them). Off a mesh that spans
    processes ``x`` is the whole channel and ``col0`` 0.
    """
    host = torch.as_tensor(x).detach().cpu().numpy()
    if not mesh_spans_processes(mesh):
        return host, 0
    width = host.shape[-1] * len(mesh) // len(mesh.local)
    return host, process_local_slice(mesh, (width,))[0]


def shard_state_multiprocess(state, mesh, keys=None, seed: int = 0):
    """Place a SimState onto a process-spanning mesh (what
    :func:`physicl_tpu_torch.parallel.shard_state` does on one).

    Host-replicated input (the initial population, a checkpoint loaded on
    every process, or planes gathered at an edit; SPMD construction from
    the same seed): each process keeps its local span of the particle axis
    (:func:`process_local_slice`), with no transfer between processes, and
    splits it over its own shards. ``keys`` gives those shards their
    generators; without it local shard ``idx`` (global index) takes one
    seeded with ``shard_seed(seed, idx)``. A state that is already sharded
    over ``mesh`` is returned as it is; one over another mesh is gathered
    (a collective every process makes, guaranteed by the consensus-gated
    edit application, ``population.PopulationManager.check_divergence``)
    and split again.
    """
    from physicl_tpu_torch.parallel.sharding import ShardedState, split_span

    if isinstance(state, ShardedState):
        if state.mesh is mesh:
            return state
        state = state.gather()
    start, size = process_local_slice(mesh, (state.capacity,))
    return split_span(state, mesh, start, size, keys=keys, seed=seed)
