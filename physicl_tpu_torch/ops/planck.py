"""Bulk Planck-spectrum generation: the CUDA kernel's wrapper, its plain
PyTorch twin, and the piecewise-polynomial inverse CDF they share with the
transport kernel's ``emit`` op.

Counterpart of the JAX package's Pallas generation kernel
(``_planck_gen_kernel_fn`` / ``_planck_kernel_sampler``) and of its traced
inverse CDF ``_poly_icdf_eval``.

* On a CUDA device :func:`planck_gen` launches ``csrc/planck_gen.cu`` or
  raises; on the CPU it runs :func:`planck_gen_reference`.
* Both draw sample ``g``'s uniform from the fused chunk's counter hash with
  the seed as the chunk seed, iteration 0, draw 1 and slot ``g``
  (``(bits >> 8) * 2**-24``). The TPU kernel's hardware PRNG has no
  counterpart off the TPU, so the kernel is held bitwise to its twin and
  statistically to the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["icdf_table", "poly_icdf_reference", "planck_gen",
           "planck_gen_reference"]

SEGS = 32
DEG = 7
# offsets in one packed table (csrc/sampling.cuh, kIcdf*)
_PB = 0
_MID = _PB + SEGS + 1
_HALF = _MID + SEGS
_COEF = _HALF + SEGS
_LO = _COEF + SEGS * (DEG + 1)
_HI = _LO + 1
TABLE_SIZE = 360


def icdf_table(data) -> np.ndarray:
    """Pack ``light._planck_poly_data``'s ``(pb, mids, halves, coeffs,
    (E_lo, E_hi))`` into the flat float32 layout the kernels read."""
    pb, mids, halves, coeffs, (e_lo, e_hi) = data
    t = np.zeros(TABLE_SIZE, np.float32)
    t[_PB:_MID] = pb
    t[_MID:_HALF] = mids
    t[_HALF:_COEF] = halves
    t[_COEF:_LO] = np.asarray(coeffs, np.float32).reshape(-1)
    t[_LO], t[_HI] = e_lo, e_hi
    return t


def _as_table(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.float32)
    if not isinstance(data, np.ndarray):
        data = icdf_table(data)
    return torch.from_numpy(data).to(device)


def poly_segment(u: torch.Tensor, data) -> torch.Tensor:
    """Segment index ``s`` with ``pb[s] <= u < pb[s+1]``, or -1 where no
    segment holds ``u``."""
    t = _as_table(data, u.device)
    pb = t[_PB:_MID]
    s = torch.searchsorted(pb, u, right=True) - 1
    inside = (u >= pb[0]) & (u < pb[SEGS])
    return torch.where(inside, s.clamp(0, SEGS - 1), -1)


def poly_icdf_reference(u: torch.Tensor, data) -> torch.Tensor:
    """The JAX package's ``_poly_icdf_eval`` in plain PyTorch: float32
    uniforms in [0, 1) -> energies.

    ``data`` is ``light._planck_poly_data``'s tuple or its packed table. The
    segment is found directly (the same ``pb[s] <= u < pb[s+1]`` predicate
    as the JAX mask sum), the half-width is accumulated as ``1 + (half_s -
    1)`` exactly as the mask sum rounds it, ``x = (u - mid) / half`` is a
    true division, then degree-7 Horner (separate multiply and add) and a
    clip to ``[E_lo, E_hi]``. A ``u`` outside every segment evaluates the
    zero polynomial, as the mask sum does.
    """
    t = _as_table(data, u.device)
    u = u.to(torch.float32)
    s = poly_segment(u, t)
    inside = s >= 0
    sc = s.clamp(min=0)
    one = torch.ones((), dtype=torch.float32, device=u.device)
    mid = torch.where(inside, t[_MID + sc], 0.0)
    half = torch.where(inside, one + (t[_HALF + sc] - one), one)
    x = (u - mid) / half
    coef = t[_COEF:_LO].reshape(SEGS, DEG + 1)[sc]
    coef = torch.where(inside.unsqueeze(-1), coef, 0.0)
    acc = coef[..., DEG]
    for j in range(DEG - 1, -1, -1):
        acc = acc * x + coef[..., j]
    return torch.minimum(torch.maximum(acc, t[_LO]), t[_HI])


def planck_gen_reference(seed: int, n: int, table, scale: float = 1.0,
                         device="cpu") -> torch.Tensor:
    """Plain PyTorch version of ``csrc/planck_gen.cu``: ``n`` float32
    energies on ``device``, multiplied by ``float32(scale)`` unless it is 1.
    Runs on any device; :func:`planck_gen` uses it for the CPU only."""
    from physicl_tpu_torch.ops.fused import _HashRng, _f32, _slot_term

    dev = torch.device(device)
    g = torch.arange(int(n), dtype=torch.int64, device=dev)
    u = _HashRng(int(seed), 0, _slot_term(g)).uniform()
    E = poly_icdf_reference(u, _as_table(table, dev))
    if scale != 1.0:
        E = E * _f32(scale).to(dev)
    return E


def planck_gen(seed: int, n: int, table, scale: float = 1.0,
               device="cuda") -> torch.Tensor:
    """``n`` Planck energies on ``device``: the CUDA kernel on a CUDA
    device (raises if it cannot build or launch), the plain twin on the
    CPU. ``table`` is :func:`icdf_table`'s array or a tensor of it.
    ``planck_gen.launches`` counts kernel launches."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return planck_gen_reference(seed, n, table, scale, dev)
    if dev.type != "cuda":
        raise ValueError(f"planck_gen: unsupported device {dev}")
    from physicl_tpu_torch.ops import _build

    lib = _build.load()["planck_gen"]
    t = _as_table(table, dev).contiguous()
    if t.numel() != TABLE_SIZE:
        raise ValueError(f"planck_gen: table must hold {TABLE_SIZE} floats")
    out = torch.empty(int(n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.planck_gen_launch(out.data_ptr(), int(n),
                                    int(seed) & 0xFFFFFFFF, t.data_ptr(),
                                    float(np.float32(scale)),
                                    _build.stream_of(out))
    _build.check(err, "planck_gen launch")
    planck_gen.launches += 1
    return out


planck_gen.launches = 0
