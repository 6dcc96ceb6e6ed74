"""Structure-of-arrays simulation state as torch tensors.

Counterpart of ``physicl_tpu/state.py``: the same fields, the same ``(3, C)``
component-major vectors and the same capacity padding, so a state moves
between the two packages field by field (:meth:`SimState.from_numpy` /
:meth:`SimState.to_numpy`). Every tensor lives on the ``device`` the
state was built for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["SimState", "OBJ_GENERIC", "OBJ_PHOTON", "pad_capacity",
           "mod_floor"]

OBJ_GENERIC = 0
OBJ_PHOTON = 1

_LANE = 128

# per-particle fields (scalars and (3, C) vectors), then the scalar clocks
_VEC = ("r", "dr", "v", "dv", "a")
# object attributes that are core fields, not extras (``w`` has its plane)
_CORE = frozenset(_VEC + ("E", "w"))
_SCALAR_DTYPES = {"t": torch.float32, "dt": torch.float32,
                  "t_comp": torch.float32, "n_spawned": torch.int32}


def pad_capacity(n: int) -> int:
    """Round a particle count up to a multiple of 128 * 128 = 16384 slots.

    Kept identical to the JAX package so both lay a population out in the
    same slots: the fused tier's random draws are keyed on the slot index.
    """
    tile = _LANE * _LANE
    return max(tile, ((n + tile - 1) // tile) * tile)


def mod_floor(x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``x mod L`` (L > 0) spelled out as floor, div, mul, sub, each
    rounded on its own (the JAX package's ``state.mod_floor``, and the
    transport kernel's ``mod_floor``), so every path computes the same
    value. The two guards absorb the 1-ulp cases where the floored
    quotient lands the remainder at exactly L or just below 0."""
    y = x - torch.floor(x / L) * L
    y = torch.where(y < 0, y + L, y)
    return torch.where(y >= L, y - L, y)


@dataclasses.dataclass(frozen=True)
class SimState:
    """Particle state on one device.

    Vector fields are ``(3, C)`` float32 (float64 for a float64 run),
    per-particle scalars ``(C,)``, ``alive`` is bool and ``otype`` int32.
    ``t``/``dt``/``t_comp`` are 0-d tensors of the state's dtype
    (``t_comp`` is the Kahan compensation of the clock) and ``n_spawned`` a
    0-d int32 spawn mark. ``key`` is the ``torch.Generator`` the generic
    step tier draws from (it is mutable: states derived from one another
    share it); the fused tier draws from its counter hash instead and never
    touches it. Values are in code units.
    """

    r: torch.Tensor
    dr: torch.Tensor
    v: torch.Tensor
    dv: torch.Tensor
    a: torch.Tensor
    E: torch.Tensor
    alive: torch.Tensor
    otype: torch.Tensor
    w: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    key: Optional[torch.Generator] = None
    n_spawned: Optional[torch.Tensor] = None
    t_comp: Optional[torch.Tensor] = None
    extras: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        dev = self.r.device
        if self.n_spawned is None:
            object.__setattr__(self, "n_spawned",
                               torch.zeros((), dtype=torch.int32, device=dev))
        if self.t_comp is None:
            object.__setattr__(self, "t_comp",
                               torch.zeros((), dtype=self.t.dtype, device=dev))

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    @property
    def capacity(self) -> int:
        return self.r.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.r.device

    @property
    def n_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    @staticmethod
    def make_key(seed: int, device) -> torch.Generator:
        """Seeded generator on ``device`` for the generic step tier."""
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g

    @staticmethod
    def from_numpy(fields: Dict[str, np.ndarray], device,
                   seed: int = 0, dtype=torch.float32) -> "SimState":
        """Build a state from one numpy array per field — the layout that
        ``jax.device_get`` gives for a ``physicl_tpu`` state, so a JAX run's
        state carries across unchanged. ``key`` is not carried (JAX keys and
        torch generators are different streams): a generator seeded with
        ``seed`` takes its place. ``extras`` is an optional dict of arrays.
        ``dtype`` is the float planes' and clocks' dtype."""
        dev = torch.device(device)

        def t(arr, dtype=None):
            # a copy: device_get hands out read-only arrays
            return torch.tensor(np.asarray(arr), device=dev, dtype=dtype)

        kw = {name: t(fields[name], dtype) for name in _VEC + ("E", "w")}
        kw["alive"] = t(fields["alive"], torch.bool)
        kw["otype"] = t(fields["otype"], torch.int32)
        for name, sdt in _SCALAR_DTYPES.items():
            if name in fields:
                sdt = dtype if sdt == torch.float32 else sdt
                kw[name] = t(fields[name], sdt).reshape(())
        kw["extras"] = {k: t(v) for k, v in
                        (fields.get("extras") or {}).items()}
        return SimState(key=SimState.make_key(seed, dev), **kw)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Inverse of :meth:`from_numpy`: one host array per field."""
        out = {name: getattr(self, name).cpu().numpy()
               for name in _VEC + ("E", "alive", "otype", "w")
               + tuple(_SCALAR_DTYPES)}
        out["extras"] = {k: v.cpu().numpy() for k, v in self.extras.items()}
        return out

    @staticmethod
    def from_population(objects, bulks=(), device="cpu", seed: int = 0,
                        capacity: int | None = None,
                        dtype=torch.float32) -> "SimState":
        """Build the state from host ``Object`` instances plus bulk
        populations (:func:`physicl_tpu_torch.light.generate_photon_state`
        dicts, with numpy arrays or tensors), in the slot order and float32
        rounding of the JAX package's host path: objects first, then each
        bulk. The arrays are allocated on ``device`` and only the occupied
        slots are copied there; a bulk built on the device is never staged
        through the host.

        Numeric object attributes beyond the core fields, and a bulk's
        ``"extras"`` dict of ``(k,)`` or ``(3, k)`` arrays, become
        ``state.extras[name]``: a scalar as a ``(C,)`` plane, a 3-vector as
        ``(3, C)``, of ``dtype``, zero in the slots that lack it (the JAX
        package's rule, e.g. :class:`~physicl_tpu_torch.newton.
        ChargedObject`'s ``q`` and ``m``). ``dtype`` (float32 or float64)
        is the float planes' and clocks' dtype; host float64 values round
        to it once."""
        from physicl_tpu_torch.units import raw_code_value

        dev = torch.device(device)
        n_obj = len(objects)
        n_bulk = sum(int(b["n"]) for b in bulks)
        n = n_obj + n_bulk
        cap = capacity if capacity is not None else pad_capacity(max(n, 1))
        if cap < n:
            raise ValueError(f"capacity {cap} < object count {n}")

        f32 = dtype
        np_f = np.float64 if dtype == torch.float64 else np.float32
        vec = {name: torch.zeros((3, cap), dtype=f32, device=dev)
               for name in _VEC}
        E = torch.zeros((cap,), dtype=f32, device=dev)
        otype = torch.zeros((cap,), dtype=torch.int32, device=dev)
        w = torch.ones((cap,), dtype=f32, device=dev)
        alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
        alive[:n] = True

        def put(dst, x):
            """Copy one source array into a slice of the state: numpy
            float64 rounds to the state's dtype on the host (as numpy
            assignment does), a tensor converts where it lies."""
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x, dtype=np_f))
            dst.copy_(x.to(dtype=dst.dtype))

        # extras: first-seen order over the objects' attributes, then the
        # bulks' dicts; 0 = a (C,) plane, 3 = a (3, C) one
        extras_dim: Dict[str, int] = {}
        for o in objects:
            for name, val in vars(o).items():
                if name.startswith("_") or name in _CORE:
                    continue
                shape = np.asarray(raw_code_value(val), np.float64).shape
                if shape in ((), (3,)):
                    extras_dim.setdefault(name, 3 if shape else 0)
        for b in bulks:
            for name, arr in b.get("extras", {}).items():
                ndim = (arr.dim() if isinstance(arr, torch.Tensor)
                        else np.ndim(arr))
                extras_dim.setdefault(name, 0 if ndim == 1 else 3)
        extras = {name: torch.zeros((3, cap) if dim else (cap,), dtype=f32,
                                    device=dev)
                  for name, dim in extras_dim.items()}

        if n_obj:
            host = {name: np.zeros((3, n_obj), np_f) for name in _VEC}
            E_o = np.zeros((n_obj,), np_f)
            w_o = np.ones((n_obj,), np_f)
            t_o = np.zeros((n_obj,), np.int32)
            x_o = {name: np.zeros((3, n_obj) if dim else (n_obj,), np_f)
                   for name, dim in extras_dim.items()}
            for i, o in enumerate(objects):
                for name in host:
                    host[name][:, i] = raw_code_value(
                        getattr(o, name)).reshape(3)
                E_o[i] = float(raw_code_value(getattr(o, "E", 0.0)))
                w_o[i] = float(raw_code_value(getattr(o, "w", 1.0)))
                t_o[i] = getattr(o, "_obj_type_code", OBJ_GENERIC)
                for name, dim in extras_dim.items():
                    if hasattr(o, name):
                        val = raw_code_value(getattr(o, name))
                        if dim:
                            x_o[name][:, i] = np.asarray(val).reshape(3)
                        else:
                            x_o[name][i] = float(val)
            for name in host:
                put(vec[name][:, :n_obj], host[name])
            put(E[:n_obj], E_o)
            put(w[:n_obj], w_o)
            otype[:n_obj] = torch.from_numpy(t_o).to(dev)
            for name, arr in x_o.items():
                put(extras[name][..., :n_obj], arr)
        off = n_obj
        for b in bulks:
            k = int(b["n"])
            sl = slice(off, off + k)
            put(vec["r"][:, sl], b["r"])
            put(vec["v"][:, sl], b["v"])
            put(E[sl], b["E"])
            if "w" in b:
                put(w[sl], b["w"])
            otype[sl] = int(b["otype"])
            for name, arr in b.get("extras", {}).items():
                put(extras[name][..., sl], arr)
            off += k

        return SimState(
            **vec, E=E, alive=alive, otype=otype, w=w,
            t=torch.zeros((), dtype=dtype, device=dev),
            dt=torch.zeros((), dtype=dtype, device=dev),
            key=SimState.make_key(seed, dev),
            n_spawned=torch.full((), n, dtype=torch.int32, device=dev),
            extras=extras)
