"""Photon-transport toolkit (counterpart of ``physicl_tpu/light.py``, ported
subset): constants, the photon model, the Planck spectrum and its samplers,
bulk photon populations (host or device), the continuous photon source,
density fields (C expressions, layered and voxel media), isotropic,
Henyey-Greenstein, Rayleigh, tabulated (Mie) and Compton scattering (cold
and thermal electrons), the refractive interface, absorption with implicit
capture, roulette, the exponential transform, fluorescence and deposition
tallies, the sign, plane-crossing (counts, sums, per-photon energy lists)
and spherical-shell measurements, energy spectra and spatial tallies
(``ReduceMeasureStep`` histograms), and path tracing.

Statistical-parity details kept from the JAX package: the inclusive
``pcoll >= rand`` collision test and the angle-uniform (not area-uniform)
resample ``theta = 2*pi*U, phi = pi*U``. Options outside the ported slice
are stored and refused by the fused prover with a named code.

Every step's generic-tier ``apply`` (the emitter, isotropic,
Henyey-Greenstein, Rayleigh, tabulated or callable phase-function and
Compton scatter, the refractive interface, absorption
(``ScatterDeleteStep`` and the independent ``ScatterDeleteStepReference``),
the measures, path tracing and population control (``ImportanceSplitStep``,
``WeightWindowStep``)) follows the JAX package's operation and draw order
(:class:`physicl_tpu_torch.engine.StepContext`), with libm
transcendentals where the fused kernel uses its polynomial forms.
"""

from __future__ import annotations

import numpy as np
import torch

from typing import Callable, List

from physicl_tpu_torch.engine import (
    MeasureStep,
    Object,
    ReduceMeasureStep,
    Step,
)
from physicl_tpu_torch.ops import fields as _fields
from physicl_tpu_torch.ops.planck import (
    icdf_table,
    planck_gen,
    poly_icdf_reference,
)
from physicl_tpu_torch.parallel.distributed import (
    local_shard_np,
    mesh_spans_processes,
)
from physicl_tpu_torch.state import OBJ_PHOTON, is_traced
from physicl_tpu_torch.units import Measurement, raw_code_value

__all__ = [
    "c", "h", "kB", "m_e", "refresh_constants", "PhotonObject",
    "E_from_wavelength", "wavelength_from_E",
    "planck_distribution", "planck_probability", "planck_phot_distribution",
    "planck_cdf", "planck_sample_E", "PlanckSampler", "poly_icdf_reference",
    "generate_photon_state", "generate_photons", "generate_photons_from_E",
    "PhotonEmitterStep",
    "layered_density", "voxel_density",
    "ScatterDeleteStep", "ScatterDeleteStepReference",
    "ScatterIsotropicStep",
    "ScatterSphericalStep", "ScatterHenyeyGreensteinStep",
    "ScatterRayleighStep", "ScatterPhaseFunctionStep", "ScatterComptonStep",
    "RefractiveInterfaceStep", "mie_phase_table", "phase_knots",
    "ScatterMeasureStep", "ScatterSignMeasureStep",
    "SphericalShellMeasureStep", "TracePathMeasureStep",
    "SpectrumMeasureStep", "MeshTallyStep",
    "ImportanceSplitStep", "WeightWindowStep",
]

c = Measurement(np.double(299792458), "m**1 s**-1")
h = Measurement(np.double(6.62607015e-34), "J**1 s**1")
kB = Measurement(np.double(1.380649e-23), "J**1 K**-1")
m_e = Measurement(np.double(9.1093837015e-31), "kg**1")


def refresh_constants() -> None:
    """Rebuild c/h/kB/m_e under the current code scale."""
    global c, h, kB, m_e
    c = Measurement(np.double(299792458), "m**1 s**-1")
    h = Measurement(np.double(6.62607015e-34), "J**1 s**1")
    kB = Measurement(np.double(1.380649e-23), "J**1 K**-1")
    m_e = Measurement(np.double(9.1093837015e-31), "kg**1")


def _as_code(x):
    """Code-unit float of a step constant. A tensor that carries a graph
    (:func:`physicl_tpu_torch.state.is_traced`: a ``grad`` input, a
    ``vmap`` batch) passes through untouched, so that the step's
    arithmetic keeps it in the graph; the fused prover refuses a step that
    holds one (the generic step tier runs it)."""
    if is_traced(x):
        return x
    if isinstance(x, torch.Tensor):
        return float(x)
    return float(raw_code_value(x))


def _host_code(x, what: str) -> float:
    """Code-unit float of a constant that folds on the host (the
    Klein-Nishina constants); a tensor that carries a graph is refused, as
    the JAX package refuses a traced one."""
    if is_traced(x):
        raise TypeError(f"{what} folds to a host constant: pass a number, "
                        "not a tensor that carries a graph")
    return _as_code(x)


def _as_float(x):
    """SI (unscaled) float: the Planck functions' convention (they unscale
    their arguments, as the reference does)."""
    return float(x.__unscaled__()) if isinstance(x, Measurement) else float(x)


class PhotonObject(Object):
    """A photon: requires an energy ``E`` and |v| == c."""

    _obj_type_code = OBJ_PHOTON

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not np.isclose(float(np.linalg.norm(np.asarray(self.v, np.double))),
                          float(np.linalg.norm(np.asarray(c, np.double))),
                          rtol=1e-12):
            raise Exception("Not a valid speed.")
        if "E" not in kwargs:
            raise Exception("Needs a valid energy.")


def E_from_wavelength(wavelength):
    """lambda [m] -> E [J]."""
    return (h * c) / wavelength


def wavelength_from_E(E):
    """E [J] -> lambda [m]."""
    return (h * c) / E


# ---------------------------------------------------------------------------
# Planck (Wien-form) spectrum: p(E) = 15/(pi^4 kB T) x^3 e^-x, x = E/(kB T).
# The host math is numpy float64, copied from the JAX package line for line
# so that its arrays equal the JAX ones exactly.
# ---------------------------------------------------------------------------


def planck_distribution(E, T):
    """Normalized blackbody density (the reference's Wien-approximation form)."""
    E_conv = E.__unscaled__() if isinstance(E, Measurement) else E
    T_conv = T.__unscaled__() if isinstance(T, Measurement) else T
    kB_conv = kB.__unscaled__()
    x = E_conv / (kB_conv * T_conv)
    val = 15.0 / (np.pi ** 4 * kB_conv * T_conv) * x ** 3 * np.exp(-x)
    return Measurement(val, "J**-1")


def _wien_antideriv(x):
    """Closed-form antiderivative: d/dx [-e^-x (x^3+3x^2+6x+6)] = x^3 e^-x."""
    return -np.exp(-x) * (x ** 3 + 3 * x ** 2 + 6 * x + 6)


def planck_probability(E_min, E_max, T, integrator=None):
    """Integral of the density over [E_min, E_max] -> (value, abs_error).
    The default is the exact closed form; ``integrator(fn, a, b)`` takes the
    reference's call signature instead."""
    if integrator is not None:
        return integrator(lambda x: planck_distribution(x, T), E_min, E_max)
    a, b, T_v = _as_float(E_min), _as_float(E_max), _as_float(T)
    kT = float(kB.__unscaled__()) * T_v
    val = 15.0 / np.pi ** 4 * (_wien_antideriv(b / kT) - _wien_antideriv(a / kT))
    return (float(val), 0.0)


_planck_cache: dict = {}


def planck_cdf(E_min, E_max, T, bins: int = 1000):
    """Memoized per-bin CDF of the Wien-form density: ``(E_edges, cdf)`` as
    float64 arrays; ``E_edges`` has ``bins`` entries and ``cdf[i]`` is the
    normalized cumulative probability up to edge ``i+1``."""
    key = (_as_float(E_min), _as_float(E_max), _as_float(T), int(bins))
    if key in _planck_cache:
        return _planck_cache[key]
    a, b, T_v, nb = key
    kT = float(kB.__unscaled__()) * T_v
    E = np.linspace(a, b, nb)
    F = _wien_antideriv(E / kT)
    gamma = F[1:] - F[:-1]                  # per-bin mass (exact)
    cdf = np.cumsum(gamma / gamma.sum())
    _planck_cache[key] = (E, cdf)
    return E, cdf


def planck_phot_distribution(E_min, E_max, T, bins: int = 1000):
    """Inverse-CDF sample ONE photon energy from numpy's global generator:
    a draw in mass bin ``x`` returns the bin's lower edge ``E[x]`` (a draw
    below ``cdf[0]`` returns ``E[0]``)."""
    E, cdf = planck_cdf(E_min, E_max, T, bins)
    rand = np.random.rand()
    idx = int(np.searchsorted(cdf, rand, side="left"))
    return Measurement(E[min(idx, len(E) - 1)], "J**1")


_planck_inv_cache: dict = {}
_INV_TABLE = 4096
_planck_poly_cache: dict = {}
_POLY_SEGS = 32
_POLY_DEG = 7


def _planck_poly_data(E_min, E_max, T, bins):
    """Memoized piecewise-polynomial inverse-CDF fit: 32 segments with
    breakpoints warped-uniform in energy (``E_lo + (E_hi-E_lo) t**1.5``),
    a degree-7 monomial fit each. Returns ``(pb, mids, halves, coeffs,
    (E_lo, E_hi))`` as float32 scalars (``ops/planck.icdf_table`` packs
    them for the kernels)."""
    cache_key = ("data", _as_float(E_min), _as_float(E_max), _as_float(T),
                 int(bins))
    if cache_key in _planck_poly_cache:
        return _planck_poly_cache[cache_key]

    E, cdf = planck_cdf(E_min, E_max, T, bins)
    probs = np.concatenate([[0.0], cdf])
    Eb = E[0] + (E[-1] - E[0]) * np.linspace(0.0, 1.0, _POLY_SEGS + 1) ** 1.5
    pb = np.interp(Eb, E, probs)
    pb[0], pb[-1] = 0.0, 1.0 + 1e-7

    mids = 0.5 * (pb[1:] + pb[:-1])
    halves = np.maximum(0.5 * (pb[1:] - pb[:-1]), 1e-12)
    coeffs = np.zeros((_POLY_SEGS, _POLY_DEG + 1))
    nodes = np.cos(np.pi * (np.arange(128) + 0.5) / 128)  # Chebyshev nodes
    for s in range(_POLY_SEGS):
        # fit on nodes sampled within the segment (well-conditioned even
        # for near-zero-mass tail segments)
        ps = mids[s] + halves[s] * nodes
        ch = np.polynomial.chebyshev.Chebyshev.fit(
            ps, np.interp(ps, probs, E), _POLY_DEG,
            domain=[pb[s], pb[s + 1]])
        coeffs[s] = np.polynomial.chebyshev.cheb2poly(ch.coef)

    data = (
        [np.float32(x) for x in pb],
        [np.float32(x) for x in mids],
        [np.float32(x) for x in halves],
        [[np.float32(c) for c in row] for row in coeffs],
        (np.float32(E[0]), np.float32(E[-1])),
    )
    _planck_poly_cache[cache_key] = data
    return data


def _planck_inverse_table(E_min, E_max, T, bins):
    """Memoized inverse-CDF table: probability grid -> energy (host f64)."""
    key = (_as_float(E_min), _as_float(E_max), _as_float(T), int(bins))
    if key not in _planck_inv_cache:
        E, cdf = planck_cdf(E_min, E_max, T, bins)
        # cdf[i] is cumulative mass up to edge E[i+1]; prepend (0, E[0])
        probs = np.concatenate([[0.0], cdf])
        _planck_inv_cache[key] = np.interp(
            np.linspace(0.0, 1.0, _INV_TABLE), probs, E)
    return _planck_inv_cache[key]


def _torch_device(device) -> torch.device:
    """``device=True`` means the card; a string or torch.device names one."""
    return torch.device("cuda" if device is True else device)


def _generator(key, seed: int, device) -> torch.Generator:
    if key is not None:
        return key
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class PlanckSampler:
    """Blackbody photon-energy sampler (Wien-form density) for every tier:

    * ``sampler(generator, k)``: ``k`` energies from a ``torch.Generator``'s
      uniforms through the plain inverse CDF, on the generator's device;
    * ``sampler.icdf(u)``: the inverse CDF over float32 uniforms, the
      function the transport kernel's ``emit`` op evaluates in-kernel for
      ``PhotonEmitterStep(E=sampler)``;
    * ``sampler.sample_device(seed, n, device="cuda")``: the bulk generation
      kernel ``csrc/planck_gen.cu`` (its plain twin on the CPU).

    Energies are in code units: the SI spectrum times the joule's code
    factor ``_code``, captured at construction.
    """

    def __init__(self, E_min, E_max, T, bins: int = 1000):
        self.E_min = _as_float(E_min)
        self.E_max = _as_float(E_max)
        self.T = _as_float(T)
        self.bins = int(bins)
        self._code = float(raw_code_value(Measurement(1.0, "J**1")))
        self._tables = {}  # device -> packed fit table

    @property
    def data(self):
        """``_planck_poly_data`` of this sampler's window."""
        return _planck_poly_data(self.E_min, self.E_max, self.T, self.bins)

    def table(self, device="cpu") -> torch.Tensor:
        """The packed fit table (``ops/planck.icdf_table``) on ``device``,
        built once per device."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        t = self._tables.get(dev)
        if t is None:
            t = self._tables[dev] = torch.from_numpy(
                icdf_table(self.data)).to(dev)
        return t

    def _scaled(self, E: torch.Tensor) -> torch.Tensor:
        if self._code == 1.0:
            return E
        return E * torch.tensor(self._code, dtype=torch.float32,
                                device=E.device)

    def __call__(self, generator: torch.Generator, k):
        u = torch.rand(int(k), generator=generator, dtype=torch.float32,
                       device=generator.device)
        return self.icdf(u)

    def icdf(self, u: torch.Tensor) -> torch.Tensor:
        return self._scaled(poly_icdf_reference(u, self.table(u.device)))

    def sample_device(self, seed: int, n: int, device="cuda") -> torch.Tensor:
        dev = _torch_device(device)
        return planck_gen(int(seed), int(n), self.table(dev), self._code, dev)


def planck_sample_E(n, E_min, E_max, T, bins: int = 1000, key=None,
                    seed: int = 0, device=False,
                    device_method: str = "auto"):
    """Sample ``n`` photon energies at once.

    ``key`` is a ``torch.Generator`` (default: one seeded with ``seed`` on
    the target device). ``device=False`` returns host float64 energies (the
    lower edge of each sampled CDF bin); ``device=True`` (the card) or a
    device name returns a float32 tensor there, ready for
    ``generate_photon_state(..., device=...)``. ``device_method``:

    * "kernel": the bulk generation kernel ``csrc/planck_gen.cu`` on the
      counter hash keyed on ``seed`` (its plain twin on the CPU);
    * "auto" (default) == "kernel". The JAX package's "auto" means "poly",
      its fastest route on the TPU; on the port the hand-written kernel is
      the route;
    * "poly": the generator's uniforms through the plain inverse CDF;
    * "table": exact inverse-CDF table interpolation (the accuracy oracle).
    """
    if device is not False and device is not None:
        dev = _torch_device(device)
        if device_method == "auto":
            device_method = "kernel"
        if device_method == "kernel":
            if key is not None and seed == 0:
                # a stable integer seed from the generator's own seed
                seed = int(key.initial_seed()) & 0x7FFFFFFF
            table = torch.from_numpy(icdf_table(
                _planck_poly_data(E_min, E_max, T, bins))).to(dev)
            return planck_gen(int(seed), int(n), table, 1.0, dev)
        gen = _generator(key, seed, dev)
        u = torch.rand(int(n), generator=gen, dtype=torch.float32,
                       device=dev)
        if device_method == "poly":
            return poly_icdf_reference(u, _planck_poly_data(E_min, E_max, T,
                                                            bins))
        if device_method != "table":
            raise ValueError(f"unknown device_method {device_method!r}")
        table = torch.tensor(_planck_inverse_table(E_min, E_max, T, bins),
                             dtype=torch.float32, device=dev)
        x = u * (_INV_TABLE - 1)
        i0 = torch.floor(x).to(torch.int64)
        frac = x - i0
        i0 = i0.clamp(0, _INV_TABLE - 2)
        return table[i0] * (1 - frac) + table[i0 + 1] * frac
    gen = _generator(key, seed, "cpu")
    u = torch.rand(int(n), generator=gen, dtype=torch.float32)
    E, cdf = planck_cdf(E_min, E_max, T, bins)
    # lower-edge bin convention, as planck_phot_distribution
    idx = torch.searchsorted(torch.from_numpy(cdf.astype(np.float32)), u)
    return E[idx.clamp(0, len(E) - 1).numpy()]


def generate_photons_from_E(E) -> List[PhotonObject]:
    """One +x photon at c per energy in ``E`` (the JAX package's and the
    reference's host-object constructor)."""
    return [PhotonObject(E=x, v=c * [1, 0, 0]) for x in E]


def generate_photons(n, fn=None, min=0, max=0, bins=-1) -> List[PhotonObject]:
    """``n`` host photon objects moving along +x at c with ``E = min + (max
    - min) * sample``; the default sample is ``np.random.power(3)``. ``fn``
    is a vectorised sampler ``fn(size)`` or the reference's zero-argument
    scalar one (called once per photon). ``bins`` is accepted and unused,
    as in the JAX package."""
    n = int(n)
    if fn is None:
        samples = np.random.power(3, size=n)
    else:
        try:
            samples = np.asarray(fn(n), np.double)
            if samples.shape != (n,):
                raise TypeError
        except TypeError:
            samples = np.array([fn() for _ in range(n)], np.double)
    return [PhotonObject(E=min + (max - min) * samples[i],
                         v=Measurement([c, 0, 0], "m**1 s**-1"))
            for i in range(n)]


def generate_photon_state(n, E, v=None, r=None, device=False,
                          w=None, extras=None) -> dict:
    """Bulk photon population for ``Simulation.add_photons``.

    ``E``: scalar or (n,) energies [code units]; ``v``: (3,) or (3, n)
    velocities (default +x at c); ``r``: (3,) or (3, n) positions (default
    origin); ``w``: scalar or (n,) statistical weights. ``extras``: a dict
    of per-photon planes, each a scalar / (n,) value or a (3,) / (3, n)
    3-vector, stored as ``state.extras[name]`` (readable by user steps
    declaring ``extras=("name", ...)``).

    ``device=False`` builds float64 numpy arrays exactly as the JAX
    package's host path does. ``device=True`` (the card) or a device name
    builds float32 tensors there, with no host staging; ``E`` may then be a
    tensor, e.g. straight from ``PlanckSampler.sample_device``.
    """
    n = int(n)
    c_val = float(raw_code_value(c))

    def extras_out(as_tensor):
        """Each extras value as a (n,) or (3, n) plane (the JAX package's
        shapes: a scalar or (n,) first, then a 3-vector or (3, n))."""
        out = {}
        for name, val in (extras or {}).items():
            arr = as_tensor(val)
            if arr.dim() <= 1 and arr.numel() in (1, n):
                out[name] = arr.reshape(-1).expand(n)
            elif arr.dim() <= 2 and arr.numel() in (3, 3 * n):
                out[name] = arr.reshape(3, -1).expand(3, n)
            else:
                raise ValueError(
                    f"extras[{name!r}] must be scalar/({n},) or "
                    f"(3,)/(3, {n}), got shape {tuple(arr.shape)}")
        return out

    if device is not False and device is not None:
        dev = _torch_device(device)
        f32 = torch.float32

        def tensor(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=dev, dtype=f32)
            return torch.as_tensor(np.asarray(raw_code_value(x), np.float64),
                                   dtype=f32, device=dev)

        def vec3(x):
            return tensor(x).reshape(3, -1).expand(3, n)

        E_arr = tensor(E).reshape(-1).expand(n)
        if v is None:
            v_arr = torch.zeros((3, n), dtype=f32, device=dev)
            v_arr[0] = c_val
        else:
            v_arr = vec3(v)
        r_arr = (torch.zeros((3, n), dtype=f32, device=dev) if r is None
                 else vec3(r))
        out = {"n": n, "E": E_arr, "v": v_arr, "r": r_arr,
               "otype": OBJ_PHOTON}
        if w is not None:
            w_arr = tensor(w).reshape(-1)
            if w_arr.shape[0] not in (1, n):
                raise ValueError(f"w must be scalar or length {n}")
            out["w"] = w_arr.expand(n)
        if extras:
            out["extras"] = extras_out(tensor)
        return out
    E_flat = np.asarray(raw_code_value(E), np.float64).reshape(-1)
    if E_flat.size not in (1, n):
        raise ValueError(f"E must be scalar or length {n}")
    E_arr = np.broadcast_to(E_flat, (n,)).copy()
    if v is None:
        v_arr = np.zeros((3, n))
        v_arr[0, :] = c_val
    else:
        v_arr = np.broadcast_to(np.asarray(raw_code_value(v), np.float64)
                                .reshape(3, -1), (3, n)).copy()
    if r is None:
        r_arr = np.zeros((3, n))
    else:
        r_arr = np.broadcast_to(np.asarray(raw_code_value(r), np.float64)
                                .reshape(3, -1), (3, n)).copy()
    out = {"n": n, "E": E_arr, "v": v_arr, "r": r_arr, "otype": OBJ_PHOTON}
    if w is not None:
        w_flat = np.asarray(raw_code_value(w), np.float64).reshape(-1)
        if w_flat.size not in (1, n):
            raise ValueError(f"w must be scalar or length {n}")
        out["w"] = np.broadcast_to(w_flat, (n,)).copy()
    if extras:
        out["extras"] = {k: v.contiguous().numpy() for k, v in extras_out(
            lambda x: torch.as_tensor(np.asarray(raw_code_value(x),
                                                 np.float64))).items()}
    return out


class PhotonEmitterStep(Step):
    """Continuous photon source: ``n_per_step`` photons every iteration, in
    slots ``[n_spawned, n_spawned + n_per_step)``; emission stops when the
    capacity is full, and the engine recycles dead slots (compaction) when
    the arena runs short. ``E`` is a constant or a :class:`PlanckSampler`
    (sampled in-kernel through its inverse CDF); ``v`` defaults to +x at c,
    ``isotropic=True`` draws angle-uniform directions; ``r`` is the
    emission point.

    Polarized sources: ``stokes=(Q, U, V)`` emits photons carrying that
    normalized Stokes vector (the population must come from
    ``polarization.polarized_photon_state``, so that the Stokes planes
    exist). For a directed source the ``Q > 0`` axis is ``pol_ref``
    (default: z-hat where possible) projected perpendicular to ``v``; an
    ``isotropic=True`` source may carry circular polarization (``V``) only,
    with a zero frame. Default: unpolarized (zeroed Stokes and frame rows).

    A callable ``E`` other than a ``PlanckSampler``, ``E(generator, k)
    -> (k,)`` (as ``PlanckSampler.__call__``), cannot be inlined into the
    CUDA kernel: the prover refuses it (``emitter-sampler``) and the
    generic tier runs it. There the emission is a masked write at the spawn
    mark, skipped (on the device) when the ``k`` slots do not fit.
    """

    needs_capacity_headroom = True  # slots must stay free for emission

    def __init__(self, n_per_step: int, E=1.0, v=None, r=(0.0, 0.0, 0.0),
                 isotropic: bool = False, stokes=None, pol_ref=None):
        self.n_per_step = int(n_per_step)
        self.E = E
        self.v = v
        self.r = np.asarray(raw_code_value(r), np.float64).reshape(3)
        self.isotropic = isotropic
        self.stokes = (None if stokes is None else
                       np.asarray(raw_code_value(stokes),
                                  np.float64).reshape(3))
        self.pol_ref = pol_ref
        if self.stokes is not None:
            deg = float((self.stokes ** 2).sum())
            if deg > 1.0 + 1e-9:
                raise ValueError(
                    f"emitter stokes degree sqrt(Q^2+U^2+V^2) must be <= 1,"
                    f" got {deg ** 0.5:.6f}")
            if isotropic and (self.stokes[0] != 0 or self.stokes[1] != 0):
                raise ValueError(
                    "isotropic polarized emission supports circular (V) "
                    "polarization only: linear Q/U has no well-defined "
                    "transverse frame across random directions; use a "
                    "directed source (v=...) for linear polarization")
        elif pol_ref is not None:
            raise ValueError("pol_ref= without stokes= has no effect; "
                             "pass the emitted Stokes vector too")
        self._c = None
        self._emit_e1 = None

    def setup(self, sim) -> None:
        self._c = float(raw_code_value(c))
        if self.stokes is None or self.isotropic:
            # an isotropic V-only source: a zero frame (any transverse axis
            # serves pure circular light)
            self._emit_e1 = ((0.0, 0.0, 0.0) if self.stokes is not None
                             else None)
            return
        vv = (np.array([1.0, 0.0, 0.0]) if self.v is None
              else np.asarray(raw_code_value(self.v),
                              np.float64).reshape(3))
        d = vv / max(np.linalg.norm(vv), 1e-300)
        ref = (np.asarray(raw_code_value(self.pol_ref),
                          np.float64).reshape(3)
               if self.pol_ref is not None
               else (np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9
                     else np.array([0.0, 1.0, 0.0])))
        p = ref - float(ref @ d) * d
        nrm = float(np.linalg.norm(p))
        if nrm < 1e-6:
            raise ValueError(
                "emitter pol_ref is (near-)parallel to v; the Q-axis must "
                "have a component perpendicular to the flight direction")
        self._emit_e1 = tuple(float(x) for x in p / nrm)

    def apply(self, state, ctx):
        if self._c is None:
            self.setup(None)
        if self.stokes is not None and (
                "stokes" not in state.extras
                or "pol_ref" not in state.extras):
            raise ValueError(
                "polarized emitter (stokes=) but the population carries no "
                "Stokes planes: build the initial population with "
                "physicl_tpu_torch.polarization.polarized_photon_state(...) "
                "so the 'stokes'/'pol_ref' extras exist")
        k = self.n_per_step
        dtype, dev = state.r.dtype, state.device
        C = state.capacity
        start = state.n_spawned
        if callable(self.E):
            E_new = torch.as_tensor(self.E(ctx.generator, k), dtype=dtype,
                                    device=dev)
        else:
            E_new = torch.full((k,), float(raw_code_value(self.E)),
                               dtype=dtype, device=dev)
        if self.isotropic:
            u = ctx.uniform((2, k), dtype)
            theta, phi = u[0] * (2 * np.pi), u[1] * np.pi
            v_new = torch.stack([
                torch.sin(theta) * torch.cos(phi),
                torch.sin(theta) * torch.sin(phi),
                torch.cos(theta),
            ]) * self._c
        elif self.v is None:
            v_new = torch.zeros((3, k), dtype=dtype, device=dev)
            v_new[0] = self._c
        else:
            v_new = torch.tensor(np.asarray(raw_code_value(self.v),
                                            np.float64).reshape(3, -1),
                                 dtype=dtype, device=dev).expand(3, k)
        fill = {}
        if self.stokes is not None:
            fill["stokes"] = self.stokes
            fill["pol_ref"] = self._emit_e1
        # slots [start, start + k), written only if they all fit; the gate
        # stays on the device, so the spawn mark never reaches the host. A
        # full arena writes k slots' own values back (k <= C: the indices
        # wrap onto distinct slots). Out of place: a snapshot may hold the
        # state's planes.
        fits = start + k <= C
        idx = (start.long() + torch.arange(k, device=dev)) % C

        def put(dst, src):
            old = dst.index_select(-1, idx)
            src = torch.as_tensor(src, dtype=dst.dtype, device=dev)
            return dst.index_copy(-1, idx, torch.where(fits, src, old))

        extras = {}
        for name, arr in state.extras.items():
            val = (np.asarray(fill[name], np.float64)[:, None]
                   if name in fill else 0.0)
            extras[name] = put(arr, val)
        return state.replace(
            r=put(state.r, self.r[:, None]), v=put(state.v, v_new),
            dr=put(state.dr, 0.0), dv=put(state.dv, 0.0),
            E=put(state.E, E_new), alive=put(state.alive, True),
            otype=put(state.otype, OBJ_PHOTON),
            # recycled slots may carry a stale weight and stale planes
            w=put(state.w, 1.0), extras=extras,
            n_spawned=torch.where(fits, start + k, start).to(torch.int32))


def _field_value(fn, value, label: str, like: torch.Tensor) -> torch.Tensor:
    """A field callable's value on the generic tier, as a tensor of
    ``like``'s dtype and device. A callable that leaves torch (numpy on
    the values) or the state's device fails here by name: it is never
    evaluated quietly on the host while the run is on the card."""
    if isinstance(value, (bool, int, float)):
        return torch.full((), float(value), dtype=like.dtype,
                          device=like.device)
    if not isinstance(value, torch.Tensor) or value.device != like.device:
        what = (f"a {value.device} tensor" if isinstance(value, torch.Tensor)
                else type(value).__name__)
        raise TypeError(
            f"{label} callable {getattr(fn, '__qualname__', repr(fn))} "
            f"returned {what}: a field callable must compute with torch on "
            f"the state's device ({like.device})")
    return value.to(like.dtype)


def _dr_norm(state) -> torch.Tensor:
    return torch.sqrt((state.dr * state.dr).sum(dim=0))


def _compile_field_expr(fn_or_expr, varnames, label):
    """A user field: a callable is returned as it is (the prover records a
    torch callable into the same expression program, or refuses one it
    cannot record, code ``field-fn-callable``); a
    C-expression string over ``<var>[gid]`` in the reference's grammar
    (physicl/light.py:295-299) becomes a torch callable with the field
    program each plan's form library compiles
    (:mod:`physicl_tpu_torch.ops.fields`)."""
    if callable(fn_or_expr):
        return fn_or_expr
    return _fields.compile_expr(fn_or_expr, tuple(varnames), label)


def _compile_variable_n(fn_or_expr):
    """Number-density field n(r) as a torch callable over (r0, r1, r2)."""
    return _compile_field_expr(fn_or_expr, ("r0", "r1", "r2"),
                               "variable_n_fn")


def layered_density(edges, values, axis: str = "x",
                    center=(0.0, 0.0, 0.0), outside: float = 0.0):
    """Piecewise-constant layered medium as a ``variable_n_fn`` callable:
    layer ``i`` spans ``edges[i] <= coord < edges[i+1]`` (strictly
    increasing edges, one value per layer), ``coord`` is x, y, z or
    ``|r - center|`` (``axis="r"``), and ``outside`` is the density beyond
    the edge range. The kernel reads edges and values from its auxiliary
    table and finds the layer by bisection, so the layer count costs
    log2(layers) per evaluation."""
    edges = [float(raw_code_value(e)) for e in np.asarray(edges).ravel()]
    values = [float(raw_code_value(v)) for v in np.asarray(values).ravel()]
    if len(edges) < 2 or len(values) != len(edges) - 1:
        raise ValueError(f"need len(values) == len(edges) - 1 >= 1, got "
                         f"{len(values)} values / {len(edges)} edges")
    if not all(b > a for a, b in zip(edges, edges[1:])):
        raise ValueError("edges must be strictly increasing")
    if axis not in _fields.LAYER_AXES:
        raise ValueError(f"axis must be 'x', 'y', 'z' or 'r', got {axis!r}")
    center = tuple(float(raw_code_value(v)) for v in center)
    spec = {"kind": "layered", "axis": _fields.LAYER_AXES[axis],
            "edges": np.asarray(edges, np.float32),
            "values": np.asarray(values, np.float32),
            "center": center, "outside": float(raw_code_value(outside))}
    fn = _fields.layered_fn(spec)
    fn.spec = spec
    return fn


def voxel_density(grid, origin=(0.0, 0.0, 0.0), spacing=1.0,
                  interp: str = "nearest", outside: float = 0.0,
                  quantize: int | None = None):
    """3-D gridded medium (CT phantom / simulation snapshot) as a
    ``variable_n_fn`` callable: ``grid[ix, iy, iz]`` is the density at
    ``origin + (ix, iy, iz) * spacing``.

    ``interp="nearest"`` snaps to the closest voxel center (coverage
    ``origin - spacing/2`` to ``origin + (shape - 1/2) * spacing``);
    ``"trilinear"`` interpolates the 8 surrounding voxels (coverage the
    voxel-center hull, at least 2 voxels per axis). Positions outside the
    coverage read ``outside``.

    Any grid below 2**31 voxels that fits on the card fuses exactly: the
    kernel reads the flat float32 grid straight from device memory (the JAX
    package's in-VMEM table caps and codebook tiers do not apply).
    ``quantize=K`` (2-256) snaps the grid to K quantile-balanced levels
    first, as declared semantics on every path; the largest snap error is
    ``fn.quantize_err``. ``fn.vox_spec`` holds the grid's ``shape``,
    ``origin`` and ``spacing``, on which ``Simulation(spatial_sort=K)``
    keys its reorder.
    """
    grid = np.asarray(raw_code_value(grid), np.float32)
    if grid.ndim != 3:
        raise ValueError(f"grid must be 3-D (nx, ny, nz), got {grid.shape}")
    if interp not in ("nearest", "trilinear"):
        raise ValueError(f"interp must be 'nearest' or 'trilinear', "
                         f"got {interp!r}")
    origin = np.asarray(raw_code_value(origin), np.float64).reshape(3)
    spacing = np.broadcast_to(
        np.asarray(raw_code_value(spacing), np.float64).ravel(), (3,))
    if (spacing <= 0).any():
        raise ValueError("spacing must be positive")
    nx, ny, nz = grid.shape
    if interp == "trilinear" and min(grid.shape) < 2:
        raise ValueError("trilinear interpolation needs at least 2 voxels "
                         "per axis")
    outside = float(raw_code_value(outside))

    flat_np = grid.reshape(-1)
    quantize_err = 0.0
    if quantize is not None:
        q = int(raw_code_value(quantize))
        if not 2 <= q <= 256:
            raise ValueError(f"quantize must be in [2, 256], got {q}")
        if np.unique(flat_np).size > q:
            # quantile-balanced bins (equal voxel mass per level), each
            # represented by its bin mean (the JAX package's arithmetic)
            edges = np.unique(np.quantile(
                flat_np, np.linspace(0.0, 1.0, q + 1)[1:-1]))
            bins = np.searchsorted(edges, flat_np, side="right")
            sums = np.bincount(bins, weights=flat_np.astype(np.float64),
                               minlength=edges.size + 1)
            cnts = np.bincount(bins, minlength=edges.size + 1)
            reps = (sums / np.maximum(cnts, 1)).astype(np.float32)
            snapped = reps[bins]
            quantize_err = float(np.abs(snapped - flat_np).max())
            flat_np = snapped
    spec = {"kind": "voxel", "flat": np.ascontiguousarray(flat_np),
            "shape": (int(nx), int(ny), int(nz)),
            "origin": tuple(float(o) for o in origin),
            "spacing": tuple(float(s) for s in spacing),
            "outside": outside, "interp": interp}
    fn = _fields.voxel_fn(spec)
    fn.spec = spec
    # the grid's shape, origin and spacing key Simulation(spatial_sort=K)
    fn.vox_spec = spec
    fn.quantize_err = quantize_err
    return fn


class ScatterDeleteStep(MeasureStep):
    """Absorption: a photon is deleted with probability
    ``pcoll = A * A_fn(E) * n(r) * |dr|`` (inclusive ``pcoll >= u`` test);
    with ``variable_n`` the field ``n(r)`` replaces the constant ``n``.

    * ``implicit_capture=True``: survival biasing, ``w *= 1 - min(pcoll, 1)``
      with no draw and no death;
    * ``roulette=(w_min, w_survive)``: a photon whose weight fell below
      ``w_min`` survives with probability ``w / w_survive`` at weight
      ``w_survive`` (one uniform per slot, drawn after the weight update);
    * ``stretch=b`` (0 < b < 1), ``stretch_dir=d``: the exponential
      transform; the analog kill is biased to ``p (1 - b mu)`` with ``mu``
      the cosine between ``dr`` and the normalised ``d`` (capped at 7/8
      where ``p < 1``), survivors carry the likelihood ratio ``(1 - p) /
      (1 - p')`` and a killed photon deposits ``w E p / p'``;
    * ``fluorescence=(Y, E_f)``, ``fluorescence_edge=E_edge`` (default
      ``E_f``): an absorbed photon with ``E >= E_edge`` is re-emitted
      true-isotropically at ``E_f`` with probability ``Y`` (it deposits
      ``w (E - E_f)``) instead of dying;
    * ``measure_deposition=True``: ``data`` rows ``[t, E_dep]`` per
      iteration, ``sum(w*E)`` over killed photons (analog) or
      ``sum(w*min(pcoll,1)*E)`` (implicit capture); CSV through ``out_fn``.

    ``A_fn`` and ``variable_n_fn`` take a C-expression string, a field
    callable (``layered_density``, ``voxel_density``) or a torch callable,
    which the prover records into an expression program (``A_fn(E)``,
    ``variable_n_fn(r0, r1, r2)``; one it cannot record is refused as
    ``field-fn-callable`` and runs on the generic tier, which calls it on
    the planes and fails by name where it leaves torch). ``stretch`` and
    ``fluorescence`` are analog only and exclude each other, as in the JAX
    package."""

    mesh_records = {"t": "once", "dep": "sum"}

    def __init__(self, n, A, A_fn=None, variable_n=False,
                 variable_n_fn=None, implicit_capture=False, roulette=None,
                 measure_deposition=False, out_fn=None, stretch=None,
                 stretch_dir=(1.0, 0.0, 0.0), fluorescence=None,
                 fluorescence_edge=None):
        super().__init__(out_fn)
        self.measure_deposition = bool(measure_deposition)
        if stretch is not None:
            if implicit_capture:
                raise ValueError("stretch biases the analog kill; "
                                 "implicit_capture has no kill to bias "
                                 "(use one or the other)")
            b = float(raw_code_value(stretch))
            if not (0.0 < b < 1.0):
                raise ValueError(f"stretch must be in (0, 1), got {b}")
            d = np.asarray(raw_code_value(stretch_dir), np.float64)
            if d.shape != (3,) or not np.isfinite(d).all() or not d.any():
                raise ValueError("stretch_dir must be a nonzero 3-vector")
            d = d / np.linalg.norm(d)
            stretch = (b, float(d[0]), float(d[1]), float(d[2]))
        self.stretch = stretch
        self.n = _as_code(n)
        self.A = _as_code(A)
        self._a_fn = (None if A_fn is None else
                      _compile_field_expr(A_fn, ("E",), "A_fn"))
        if variable_n and variable_n_fn is None:
            raise ValueError("variable_n=True requires variable_n_fn")
        self._n_fn = (_compile_variable_n(variable_n_fn) if variable_n
                      else None)
        self.implicit_capture = bool(implicit_capture)
        if roulette is not None:
            if not self.implicit_capture:
                raise ValueError("roulette requires implicit_capture=True "
                                 "(analog transport kills outright)")
            w_min, w_survive = (float(roulette[0]), float(roulette[1]))
            if not (0.0 < w_min <= w_survive):
                raise ValueError("roulette=(w_min, w_survive) needs "
                                 "0 < w_min <= w_survive")
            roulette = (w_min, w_survive)
        self.roulette = roulette
        # fluorescent re-emission replaces the analog kill, which implicit
        # capture and the exponential transform have already reshaped
        if fluorescence is not None:
            if self.implicit_capture:
                raise ValueError("fluorescence replaces the analog kill; "
                                 "implicit_capture has no kill to replace "
                                 "(use one or the other)")
            if self.stretch is not None:
                raise ValueError("fluorescence + stretch would need the "
                                 "likelihood ratio threaded through the "
                                 "re-emit branch; unsupported — pick one")
            Y = float(raw_code_value(fluorescence[0]))
            E_f = float(raw_code_value(fluorescence[1]))
            if not (0.0 < Y <= 1.0):
                raise ValueError(f"fluorescence yield must be in (0, 1], "
                                 f"got {Y}")
            if not (E_f > 0.0):
                raise ValueError(f"fluorescence line energy must be "
                                 f"positive, got {E_f}")
            edge = (E_f if fluorescence_edge is None
                    else float(raw_code_value(fluorescence_edge)))
            if edge < E_f:
                raise ValueError(
                    f"fluorescence_edge ({edge}) below the line energy "
                    f"({E_f}) would re-emit photons ABOVE their absorbed "
                    f"energy (negative deposition)")
            fluorescence = (Y, E_f, edge)
        elif fluorescence_edge is not None:
            raise ValueError("fluorescence_edge requires fluorescence=")
        self.fluorescence = fluorescence

    @property
    def _c(self):
        # the re-emission speed, read at plan time so that a code-scale
        # change after construction is honoured
        return float(raw_code_value(c))

    @property
    def _coef(self):
        # family convention: variable_n REPLACES the constant n
        return self.A * (1.0 if self._n_fn is not None else self.n)

    def apply(self, state, ctx):
        norm = _dr_norm(state)
        dtype = norm.dtype
        pcoll = norm * self._coef
        if self._a_fn is not None:
            pcoll = pcoll * _field_value(self._a_fn, self._a_fn(state.E),
                                         "A_fn", norm)
        if self._n_fn is not None:
            pcoll = pcoll * _field_value(
                self._n_fn, self._n_fn(state.r[0], state.r[1], state.r[2]),
                "variable_n_fn", norm)
        sel = (state.otype == OBJ_PHOTON) & state.alive
        if self.implicit_capture:
            p = pcoll.clamp(0.0, 1.0)
            w = torch.where(sel, state.w * (1.0 - p), state.w)
            if self.measure_deposition:  # the exact expected w*p*E
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", torch.where(
                    sel, state.w * p * state.E, 0.0).sum())
            if self.roulette is None:
                return state.replace(w=w)
            w_min, w_sur = self.roulette
            u = ctx.uniform(norm.shape, dtype)
            low = sel & (w < w_min)
            # survive with probability w / w_survive at weight w_survive
            kill = low & (u * w_sur >= w)
            w = torch.where(low & ~kill, w_sur, w)
            return state.replace(w=w, alive=state.alive & ~kill)
        u = ctx.uniform(norm.shape, dtype)
        if self.stretch is not None:
            tiny = torch.finfo(dtype).tiny
            b, dx, dy, dz = self.stretch
            mu = ((state.dr[0] * dx + state.dr[1] * dy + state.dr[2] * dz)
                  / norm.clamp(min=tiny))
            p_true = pcoll.clamp(0.0, 1.0)
            p_bias = (pcoll * (1.0 - b * mu)).clamp(0.0, 1.0)
            # cap the biased kill where p_true < 1, so that survivors exist
            # and the likelihood ratio stays finite
            p_bias = torch.where(p_true < 1.0, p_bias.clamp(max=7.0 / 8.0),
                                 p_bias)
            hit = (p_bias >= u) & sel
            ratio = (1.0 - p_true) / (1.0 - p_bias).clamp(min=tiny)
            w = torch.where(sel & ~hit, state.w * ratio, state.w)
            if self.measure_deposition:
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", torch.where(
                    hit, state.w * state.E
                    * (p_true / p_bias.clamp(min=tiny)), 0.0).sum())
            return state.replace(w=w, alive=state.alive & ~hit)
        hit = (pcoll >= u) & sel
        if self.fluorescence is not None:
            Y, E_f, E_edge = self.fluorescence
            y = ctx.uniform(norm.shape, dtype)
            fluo = hit & (y < Y) & (state.E >= E_edge)
            killed = hit & ~fluo
            if self.measure_deposition:
                # re-emission deposits the line deficit, absorption all E
                ctx.record(self, "t", state.t)
                ctx.record(self, "dep", torch.where(
                    killed, state.w * state.E, torch.where(
                        fluo, state.w * (state.E - E_f), 0.0)).sum())
            cu = ctx.uniform(norm.shape, dtype)
            au = ctx.uniform(norm.shape, dtype)
            # true isotropic (physical emission): cos theta uniform
            cos_t = 2.0 * cu - 1.0
            sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp(min=0.0))
            phi = au * (2 * np.pi)
            v_new = torch.stack([sin_t * torch.cos(phi),
                                 sin_t * torch.sin(phi), cos_t]) * self._c
            v = torch.where(fluo, v_new, state.v)
            # dv only on re-emitted lanes: an upstream scatter's flags
            # this iteration survive
            dv = torch.where(fluo, v_new - state.v, state.dv)
            E = torch.where(fluo, E_f, state.E)
            extras = dict(state.extras)
            for nm in ("stokes", "pol_ref"):
                if nm in extras:  # fluorescence light is unpolarized
                    extras[nm] = torch.where(fluo, 0.0, extras[nm])
            return state.replace(E=E, v=v, dv=dv, extras=extras,
                                 alive=state.alive & ~killed)
        if self.measure_deposition:  # analog: killed photons dump w*E
            ctx.record(self, "t", state.t)
            ctx.record(self, "dep", torch.where(
                hit, state.w * state.E, 0.0).sum())
        return state.replace(alive=state.alive & ~hit)

    def collect(self, sim, records) -> None:
        if not self.measure_deposition:
            return
        for i in range(len(records["t"])):
            self.data.append([float(records["t"][i]),
                              float(records["dep"][i])])


class ScatterDeleteStepReference(Step):
    """Constant-medium absorption written a second, independent way (the
    JAX package's rebuild through its declarative kernel bridge, the
    reference's CLProgram twin): kill a photon where ``A * n * |dr| >=
    rand`` with ``A * n`` folded in float32, ``|dr|`` summed from the three
    gathered components and one uniform per slot; no deposition tally. It
    cross-checks :class:`ScatterDeleteStep` statistically and runs on the
    generic tier (the fused prover refuses it, ``unsupported-step``)."""

    mesh_records = {}

    def __init__(self, n, A):
        self.n = float(raw_code_value(n))
        self.A = float(raw_code_value(A))
        # the bridge's float32 constants, multiplied in float32
        self._an = float(np.float32(self.A) * np.float32(self.n))

    def apply(self, state, ctx):
        d0, d1, d2 = state.dr[0], state.dr[1], state.dr[2]
        norm = torch.sqrt(d0 * d0 + d1 * d1 + d2 * d2)
        rand = ctx.uniform((state.capacity,), torch.float32)
        valid = state.alive & (state.otype == OBJ_PHOTON)
        res = valid & (self._an * norm >= rand)
        return state.replace(alive=state.alive & ~res)


class ScatterIsotropicStep(Step):
    """Isotropic scatter with optional lambda^-4 weighting and variable
    number density: ``pcoll = A * n(r) * |dr| * ((h c / E)^-4 if
    wavelength_dep_scattering)``, where ``n(r)`` is the constant ``n`` or,
    with ``variable_n``, the field ``variable_n_fn`` (C expression,
    ``layered_density``, ``voxel_density`` or a torch callable the prover
    records). Resample at |v| = c with theta=2*pi*U,
    phi=pi*U and ``dv = v_new - v_old``."""

    mesh_records = {}

    def __init__(self, **kwargs):
        self.n = _as_code(kwargs.get("n", 1))
        self.A = _as_code(kwargs.get("A", 1))
        self.wavelength_dep_scattering = kwargs.get(
            "wavelength_dep_scattering", False)
        self.variable_n = kwargs.get("variable_n", False)
        self.variable_n_fn = kwargs.get("variable_n_fn", None)
        self._n_fn = (_compile_variable_n(self.variable_n_fn)
                      if self.variable_n else None)
        self._c = None
        self._coef = None
        self._wl_base = None

    def setup(self, sim) -> None:
        self._c = float(raw_code_value(c))
        hc = float(raw_code_value(h)) * float(raw_code_value(c))
        # fold the static factors in float64 on the host, as the JAX
        # package does: pcoll = coef * norm * n(r) * (E * wl_base)^4, where
        # a variable n(r) replaces the constant n in the fold
        folded = self.A * (1.0 if self.variable_n else self.n)
        if self.wavelength_dep_scattering:
            self._wl_base = (1.0 / hc) * folded ** 0.25
            self._coef = 1.0
        else:
            self._wl_base = None
            self._coef = folded

    def _pcoll(self, state, norm):
        """``A * n(r) * |dr|`` with the optional lambda^-4 weighting (the
        scatter family's collision probability)."""
        pcoll = norm * self._coef
        if self._n_fn is not None:
            pcoll = pcoll * _field_value(
                self._n_fn, self._n_fn(state.r[0], state.r[1], state.r[2]),
                "variable_n_fn", norm)
        if self._wl_base is not None:
            base = state.E * self._wl_base
            base2 = base * base
            pcoll = pcoll * (base2 * base2)
        return pcoll

    def apply(self, state, ctx):
        if self._c is None:
            self.setup(None)
        dtype = state.r.dtype
        norm = _dr_norm(state)
        pcoll = self._pcoll(state, norm)
        u3 = ctx.uniform((3,) + tuple(norm.shape), dtype)
        theta = u3[0] * (2 * np.pi)
        phi = u3[1] * np.pi
        scatter = ((pcoll >= u3[2]) & (state.otype == OBJ_PHOTON)
                   & state.alive)
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        sin_p, cos_p = torch.sin(phi), torch.cos(phi)
        v_new = torch.stack([sin_t * cos_p, sin_t * sin_p, cos_t]) * self._c
        v = torch.where(scatter, v_new, state.v)
        dv = torch.where(scatter, v_new - state.v, torch.zeros_like(state.v))
        return state.replace(v=v, dv=dv)


ScatterSphericalStep = ScatterIsotropicStep


# ---------------------------------------------------------------------------
# Anisotropic and energy-changing scatter: the angle samplers, Klein-Nishina
# and thermal electrons, as float32 torch arithmetic in the JAX package's
# operation order (physicl_tpu/light.py:1286-1904). ``fast=True`` is the
# fused kernel's form (polynomial log2/exp2 and sines, no libm
# transcendental); the libm form is the generic tier's.
# ---------------------------------------------------------------------------


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor holding ``v`` in ``like``'s dtype on its device (a
    divisor as a tensor: torch divides by a Python scalar on the card as a
    product with its reciprocal, rounded twice). A tensor parameter (one
    that carries a graph) keeps it."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _scalar_like(x: torch.Tensor, v: float) -> torch.Tensor:
    """A 0-d float32 tensor holding float32(v) on ``x``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=x.device)


def _hg_direction(d, cos_t, sin_t, cos_p, sin_p):
    """Rotate the unit direction ``d`` (three component tensors) by the
    polar angle theta and the azimuth phi around it, on the branch-free
    orthonormal basis of Duff et al. (2017), robust at +-z."""
    x, y, z = d
    sign = torch.where(z >= 0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = x * y * a
    e1 = (1.0 + sign * x * x * a, sign * b, -sign * x)
    e2 = (b, sign + y * y * a, -y)
    return tuple(cos_t * dd + sin_t * (cos_p * u + sin_p * w)
                 for dd, u, w in zip((x, y, z), e1, e2))


def _rayleigh_cos_theta(u, fast=False):
    """Exact inverse CDF of the Rayleigh phase function (3/8)(1 + cos^2):
    Cardano's root ``A - 1/A``, ``A = cbrt(w + sqrt(w^2 + 1))``, ``w = 4u -
    2``; the cube root as ``2^(log2(.)/3)`` with the polynomial forms when
    ``fast``, else ``exp(log(.)/3)``."""
    from physicl_tpu_torch.ops.fused import _c32, _fast_exp2, _fast_log2, \
        _sqrt_rn

    w = 4.0 * u - 2.0
    s = _sqrt_rn(w * w + 1.0)
    if fast:
        a = _fast_exp2(_fast_log2(w + s) * _c32(1.0 / 3.0))
    else:
        a = torch.exp(torch.log(w + s) * _c32(1.0 / 3.0))
    return (a - 1.0 / a).clamp(-1.0, 1.0)  # a NaN stays NaN, as jnp.clip


# Koblinger's direct method is exact (and rejection-free) for alpha >= 1 +
# sqrt(3); below that Kahn's rejection method takes over, per photon.
_KOBLINGER_ALPHA = 1.0 + np.sqrt(3.0)

# Chebyshev-node interpolant (degree 12 on [0, 0.55]) of the cancelling
# bracket (2a(1+a)/(1+2a) - ln(1+2a)) / a^3 (the JAX package's coefficients)
_KN_BRACKET_COEF = (
    1.333333331559978, -3.9999989065937434, 9.599886818715182,
    -21.32866514870082, 45.6125841138609, -94.65335761570726,
    187.33218719339675, -337.6267278947943, 517.0327212167587,
    -620.1496910093555, 530.1148157280105, -281.973132286615,
    69.37461960979472)


def _kn_sigma_ratio(alpha, fast=False):
    """sigma_KN(alpha) / sigma_Thomson in float32: the Taylor series below
    alpha = 0.01, the cancellation-free bracket polynomial below 0.5, the
    closed form above (``fast``: ln through the polynomial log2)."""
    from physicl_tpu_torch.ops.fused import _c32, _fast_log2, _horner

    a = torch.maximum(alpha, _scalar_like(alpha, 1e-6))
    b = 1.0 + 2.0 * a
    log_b = _c32(np.log(2.0)) * _fast_log2(b) if fast else torch.log(b)
    exact = 0.75 * (
        (1.0 + a) / (a * a * a) * (2.0 * a * (1.0 + a) / b - log_b)
        + log_b / (2.0 * a)
        - (1.0 + 3.0 * a) / (b * b))
    g = _horner(_KN_BRACKET_COEF, a)
    mid = 0.75 * ((1.0 + a) * g + log_b / (2.0 * a)
                  - (1.0 + 3.0 * a) / (b * b))
    a0 = alpha
    series = 1.0 + a0 * (-2.0 + a0 * (_c32(26.0 / 5.0)
                                      + a0 * _c32(-133.0 / 10.0)))
    return torch.where(a0 < _c32(0.01), series,
                       torch.where(a0 < _c32(0.5), mid, exact))


def _kn_try(two_a, b, p_branch_a, r1, r2, r3, eta, cos_t, accepted):
    """One Kahn rejection try: branch A (eta uniform on [1, 1 + 2a],
    accepted with 4(1/eta - 1/eta^2)) with probability (1+2a)/(9+2a), else
    branch B (eta ~ 1/eta^2, accepted with (cos^2 + 1/eta)/2). The first
    accepted try wins."""
    br_a = r1 <= p_branch_a
    eta_a = 1.0 + two_a * r2
    inv_a = 1.0 / eta_a
    ok_a = r3 <= 4.0 * (inv_a - inv_a * inv_a)
    eta_b = b * inv_a
    cos_b = 1.0 - 2.0 * (1.0 - r2) * inv_a
    ok_b = r3 <= 0.5 * (cos_b * cos_b + eta_a / b)
    ok = (br_a & ok_a) | (~br_a & ok_b)
    take = ok & ~accepted
    eta = torch.where(take, torch.where(br_a, eta_a, eta_b), eta)
    cos_t = torch.where(take, torch.where(br_a, 1.0 - 2.0 * r2, cos_b),
                        cos_t)
    return eta, cos_t, accepted | ok


def _kn_koblinger_tail(alpha, a, two_a, b, u_pick, u_inv, eta, cos_t,
                       accepted, fast=False):
    """Koblinger's direct sampling on the lanes with alpha >= 1 + sqrt(3),
    from the first Kahn try's r1 and r2; the clip of cos theta to [-1, 1]
    on every lane."""
    from physicl_tpu_torch.ops.fused import _c32, _fast_exp2, _fast_log2, \
        _rsqrt_max

    inv_a1 = 1.0 / a
    inv_a2 = inv_a1 * inv_a1
    if fast:
        log2_b = _fast_log2(b)
        log_b = _c32(np.log(2.0)) * log2_b
        x1 = _fast_exp2(u_inv * log2_b)               # 1/x piece: b^u
    else:
        log_b = torch.log(b)
        x1 = torch.exp(u_inv * log_b)
    w1 = (1.0 - 2.0 * inv_a1 - 2.0 * inv_a2) * log_b
    w2 = (2.0 * inv_a1 + inv_a2) * (two_a / b)
    inv_b2 = 1.0 / (b * b)
    w3 = 0.5 * (1.0 - inv_b2)
    w4 = inv_a2 * two_a
    t = u_pick * (w1 + w2 + w3 + w4)
    x2 = b / (b - two_a * u_inv)                      # 1/x^2 piece
    # 1/x^3 piece in the cancellation-free form (1 - u) + u / b^2
    x3 = _rsqrt_max((1.0 - u_inv) + u_inv * inv_b2)
    x4 = 1.0 + two_a * u_inv                          # constant piece
    x = torch.where(t < w1, x1,
                    torch.where(t < w1 + w2, x2,
                                torch.where(t < w1 + w2 + w3, x3, x4)))
    hi = alpha >= _c32(_KOBLINGER_ALPHA)
    eta = torch.where(hi, x, eta)
    cos_t = torch.where(hi, 1.0 - (x - 1.0) * inv_a1, cos_t)
    return cos_t.clamp(-1.0, 1.0), eta, accepted | hi


def _kn_cos_eta(alpha, triples, fast=False):
    """Sample the Klein-Nishina angle for ``alpha = E / m_e c^2``:
    ``(cos theta, eta = E / E', accepted)``. ``triples`` are the Kahn
    tries' ``(r1, r2, r3)``; lanes still unaccepted after every try report
    ``accepted=False`` (the caller suppresses the scatter). Koblinger's
    method replaces Kahn's at alpha >= 1 + sqrt(3)."""
    a = torch.maximum(alpha, _scalar_like(alpha, 1e-9))
    two_a = 2.0 * a
    b = 1.0 + two_a
    eta = torch.ones_like(a)
    cos_t = torch.ones_like(a)
    accepted = torch.zeros_like(a, dtype=torch.bool)
    p_branch_a = b / (b + 8.0)
    for r1, r2, r3 in triples:
        eta, cos_t, accepted = _kn_try(two_a, b, p_branch_a, r1, r2, r3,
                                       eta, cos_t, accepted)
    return _kn_koblinger_tail(alpha, a, two_a, b, triples[0][0],
                              triples[0][1], eta, cos_t, accepted, fast=fast)


def _gauss3_from_uniform(u4, fast_trig=False):
    """Three standard normals from four uniforms by Box-Muller (the fourth
    normal is dropped); ``fast_trig``: polynomial sines and the extracted
    log (the fused kernel's form)."""
    from physicl_tpu_torch.ops.fused import _c32, _fast_neg2log, \
        _fast_sinpi, _sqrt_rn, _wrap1

    tiny = _scalar_like(u4[0], 1e-12)
    if fast_trig:
        r1 = _sqrt_rn(_fast_neg2log(torch.maximum(u4[0], tiny)))
        r2 = _sqrt_rn(_fast_neg2log(torch.maximum(u4[2], tiny)))
        two_a1 = 2.0 * u4[1]
        two_a2 = 2.0 * u4[3]
        cos_a1 = _fast_sinpi(_wrap1(two_a1 + 0.5))
        sin_a1 = _fast_sinpi(_wrap1(two_a1))
        cos_a2 = _fast_sinpi(_wrap1(two_a2 + 0.5))
        return (r1 * cos_a1, r1 * sin_a1, r2 * cos_a2)
    r1 = _sqrt_rn(-2.0 * torch.log(torch.maximum(u4[0], tiny)))
    r2 = _sqrt_rn(-2.0 * torch.log(torch.maximum(u4[2], tiny)))
    a1 = u4[1] * _c32(2 * np.pi)
    a2 = u4[3] * _c32(2 * np.pi)
    return (r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2))


def _aberrate(n, beta, bn, b2, gamma, sign):
    """Relativistic aberration of the unit direction ``n`` under a boost
    ``beta`` (``bn = beta . n``, ``b2 = |beta|^2``); ``sign`` -1 boosts into
    the electron frame, +1 back. Returns ``(n', doppler)`` with ``E' = E
    doppler``; ``n'`` is not renormalised."""
    coef = (gamma - 1.0) * bn / torch.maximum(b2, _scalar_like(b2, 1e-20)) \
        + sign * gamma
    doppler = gamma * (1.0 + sign * bn)
    inv = 1.0 / doppler
    return tuple((n[i] + beta[i] * coef) * inv for i in range(3)), doppler


def _sum3(xs):
    """Python's ``sum`` of three tensors: ((0 + x0) + x1) + x2."""
    return (0 + xs[0]) + xs[1] + xs[2]


def _ic_thermal_scatter(E, n, inv_mec2, theta_e, u4, kn_sample, u_phi,
                        fast_trig=False):
    """One inverse-Compton scatter off a thermal electron, exact in the
    electron's rest frame: a Maxwell electron (per-axis Gaussian, sigma^2 =
    theta_e, |beta| clipped at 0.9) from ``u4``, the photon boosted into
    its frame, the Klein-Nishina scatter ``kn_sample(alpha1)`` at the
    boosted energy with the azimuth ``u_phi``, and the boost back. Returns
    ``(E', n', alpha1, flux, accepted)``: ``flux = 1 - beta . n`` is the
    rate factor the caller folds into pcoll."""
    from physicl_tpu_torch.ops.fused import _c32, _fast_sinpi, _rsqrt_max, \
        _sqrt_rn, _wrap1

    sq = _sqrt_rn(_scalar_like(E, theta_e))
    g3 = _gauss3_from_uniform(u4, fast_trig=fast_trig)
    beta = tuple(g * sq for g in g3)
    b2 = _sum3([b * b for b in beta])
    b = _sqrt_rn(b2)
    # tensor / tensor: torch's ``scalar / tensor`` multiplies by the
    # reciprocal, which rounds twice
    scale = torch.minimum(
        _scalar_like(E, 1.0),
        _scalar_like(b, 0.9) / torch.maximum(b, _scalar_like(b, 1e-12)))
    beta = tuple(bc * scale for bc in beta)
    b2 = b2 * (scale * scale)
    gamma = 1.0 / _sqrt_rn(torch.maximum(1.0 - b2, _scalar_like(b2, 1e-4)))
    bn = _sum3([beta[i] * n[i] for i in range(3)])
    flux = 1.0 - bn
    n1, dop1 = _aberrate(n, beta, bn, b2, gamma, -1.0)
    inv_n1 = _rsqrt_max(_sum3([x * x for x in n1]))
    n1 = tuple(x * inv_n1 for x in n1)
    E1 = E * dop1
    alpha1 = E1 * _c32(inv_mec2)
    cos_t, eta, accepted = kn_sample(alpha1)
    E1p = E1 / eta
    sin_t = _sqrt_rn(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    if fast_trig:
        two_pu = 2.0 * u_phi
        cos_phi = _fast_sinpi(_wrap1(two_pu + 0.5))
        sin_phi = _fast_sinpi(_wrap1(two_pu))
    else:
        phi = u_phi * _c32(2 * np.pi)
        cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    n1p = _hg_direction(n1, cos_t, sin_t, cos_phi, sin_phi)
    inv_n1p = _rsqrt_max(_sum3([x * x for x in n1p]))
    n1p = tuple(x * inv_n1p for x in n1p)
    bnp = _sum3([beta[i] * n1p[i] for i in range(3)])
    n_new, dop2 = _aberrate(n1p, beta, bnp, b2, gamma, 1.0)
    inv_nn = _rsqrt_max(_sum3([x * x for x in n_new]))
    n_new = tuple(x * inv_nn for x in n_new)
    return E1p * dop2, n_new, alpha1, flux, accepted


def phase_knots(mu, pdf, bins=64):
    """The knot table of a tabulated phase function ``pdf(mu)`` over a grid
    ``mu`` in [-1, 1]: the trapezoid CDF inverted onto ``bins`` uniform
    segments in u, as float32 segment starts ``m0`` and slopes ``dm`` (the
    JAX package's ``_tabulated_cos_icdf`` constants). ``cos theta(u) =
    m0[s] + (u bins - s) dm[s]`` on segment ``s = min(floor(u bins), bins -
    1)``: the kernel reads them from its auxiliary table."""
    mu = np.asarray(mu, np.float64)
    pdf = np.asarray(pdf, np.float64)
    if mu.ndim != 1 or mu.size < 2 or pdf.shape != mu.shape:
        raise ValueError("phase_table needs matching 1-D (mu, pdf) arrays "
                         "with >= 2 points")
    if not (np.all(np.diff(mu) > 0) and mu[0] >= -1.0 - 1e-9
            and mu[-1] <= 1.0 + 1e-9):
        raise ValueError("phase_table mu grid must be strictly increasing "
                         "within [-1, 1]")
    if np.any(pdf < 0) or not np.isfinite(pdf).all():
        raise ValueError("phase_table pdf must be finite and nonnegative")
    areas = 0.5 * (pdf[1:] + pdf[:-1]) * np.diff(mu)
    total = areas.sum()
    if total <= 0:
        raise ValueError("phase_table pdf integrates to zero")
    cdf = np.concatenate([[0.0], np.cumsum(areas)]) / total
    knots = np.interp(np.linspace(0.0, 1.0, int(bins) + 1), cdf, mu)
    m0 = np.asarray([float(x) for x in knots[:-1]], np.float32)
    dm = np.asarray([float(b - a) for a, b in zip(knots[:-1], knots[1:])],
                    np.float32)
    return m0, dm


def phase_icdf(u, m0, dm):
    """The knot table's inverse CDF on float32 uniforms ``u``: the JAX
    mask-multiply sum over the segments is this one term (its other terms
    are +0.0, which the trailing ``+ 0.0`` reproduces for a -0.0)."""
    nb = int(m0.shape[0])
    x = u * float(nb)
    s = torch.clamp(torch.floor(x), max=nb - 1).to(torch.int64)
    m0_t = torch.from_numpy(m0).to(u.device)
    dm_t = torch.from_numpy(dm).to(u.device)
    return (m0_t[s] + (x - s.to(torch.float32)) * dm_t[s]) + 0.0


def mie_phase_table(x, m=1.33 + 0.0j, n_mu=361):
    """Mie scattering phase function of a homogeneous sphere (Bohren &
    Huffman series) as ``(mu, pdf, g)`` for
    :class:`ScatterPhaseFunctionStep`: ``x = 2 pi a / lambda`` the size
    parameter, ``m`` the relative refractive index, ``g`` the asymmetry
    parameter from the coefficient series. Host numpy, line for line the
    JAX package's, so arrays and ``g`` are equal."""
    x = float(x)
    if x <= 0:
        raise ValueError(f"size parameter x must be positive, got {x}")
    m = complex(m)
    mu = np.linspace(-1.0, 1.0, int(n_mu))
    N = max(3, int(np.ceil(x + 4.05 * x ** (1.0 / 3.0) + 2)))

    # logarithmic derivative D_n(mx) by downward recurrence (stable)
    mx = m * x
    nmx = max(N, int(np.ceil(abs(mx)))) + 16
    D = np.zeros(nmx + 1, np.complex128)
    for k in range(nmx, 0, -1):
        D[k - 1] = k / mx - 1.0 / (D[k] + k / mx)

    # Riccati-Bessel psi, chi by upward recurrence; xi = psi - i*chi
    psi = np.zeros(N + 1)
    chi = np.zeros(N + 1)
    psi_m1, chi_m1 = np.cos(x), -np.sin(x)  # psi_{-1}, chi_{-1}
    psi[0], chi[0] = np.sin(x), np.cos(x)
    for k in range(1, N + 1):
        psi[k] = (2 * k - 1) / x * psi[k - 1] - (psi[k - 2]
                                                 if k >= 2 else psi_m1)
        chi[k] = (2 * k - 1) / x * chi[k - 1] - (chi[k - 2]
                                                 if k >= 2 else chi_m1)
    xi = psi - 1j * chi
    n_arr = np.arange(1, N + 1)
    Dn = D[1:N + 1]
    fa = Dn / m + n_arr / x
    fb = Dn * m + n_arr / x
    a = (fa * psi[1:] - psi[:-1]) / (fa * xi[1:] - xi[:-1])
    b = (fb * psi[1:] - psi[:-1]) / (fb * xi[1:] - xi[:-1])

    # angular functions pi_n, tau_n and the amplitude sums
    S1 = np.zeros_like(mu, np.complex128)
    S2 = np.zeros_like(mu, np.complex128)
    pi_nm1 = np.zeros_like(mu)   # pi_0
    pi_n = np.ones_like(mu)      # pi_1
    for k in range(1, N + 1):
        tau_n = k * mu * pi_n - (k + 1) * pi_nm1
        f = (2 * k + 1) / (k * (k + 1))
        S1 += f * (a[k - 1] * pi_n + b[k - 1] * tau_n)
        S2 += f * (a[k - 1] * tau_n + b[k - 1] * pi_n)
        pi_nm1, pi_n = pi_n, ((2 * k + 1) * mu * pi_n
                              - (k + 1) * pi_nm1) / k
    pdf = 0.5 * (np.abs(S1) ** 2 + np.abs(S2) ** 2)

    # asymmetry parameter from the coefficient series (BH eq. 4.63)
    qsca = (2.0 / x ** 2) * np.sum((2 * n_arr + 1)
                                   * (np.abs(a) ** 2 + np.abs(b) ** 2))
    g_sum = np.sum(n_arr[:-1] * (n_arr[:-1] + 2) / (n_arr[:-1] + 1)
                   * np.real(a[:-1] * np.conj(a[1:])
                             + b[:-1] * np.conj(b[1:])))
    g_sum += np.sum((2 * n_arr + 1) / (n_arr * (n_arr + 1))
                    * np.real(a * np.conj(b)))
    g = (4.0 / (x ** 2 * qsca)) * g_sum
    return mu, pdf, float(g)


class ScatterHenyeyGreensteinStep(Step):
    """Anisotropic scatter with the Henyey-Greenstein phase function:
    ``pcoll = A * n(r) * |dr|`` (optional ``variable_n`` and
    ``wavelength_dep_scattering``, inclusive ``pcoll >= U``), the outgoing
    direction drawn relative to the incoming one with ``cos theta = (1 + g^2
    - ((1 - g^2) / (1 - g + 2 g U))^2) / (2 g)`` (``<cos theta> = g``; g = 0
    is area-uniform) and a uniform azimuth, ``|v|`` renormalised to c."""

    mesh_records = {}

    def __init__(self, **kwargs):
        self.g = float(kwargs.get("g", 0.0))
        if not -1.0 < self.g < 1.0:
            raise ValueError(f"g must be in (-1, 1), got {self.g}")
        self.n = _as_code(kwargs.get("n", 1))
        self.A = _as_code(kwargs.get("A", 1))
        self.wavelength_dep_scattering = kwargs.get(
            "wavelength_dep_scattering", False)
        self.variable_n = kwargs.get("variable_n", False)
        self.variable_n_fn = kwargs.get("variable_n_fn", None)
        self._n_fn = (_compile_variable_n(self.variable_n_fn)
                      if self.variable_n else None)
        self._c = None
        self._coef = None
        self._wl_base = None

    # pcoll folding and the collision probability are the isotropic
    # family's
    setup = ScatterIsotropicStep.setup
    _pcoll = ScatterIsotropicStep._pcoll

    def _cos_theta(self, u):
        """The polar cosine from the uniform ``u`` (the HG inverse CDF; g =
        0 the exact isotropic limit)."""
        if abs(self.g) < 1e-7:
            return 2.0 * u - 1.0
        g = _const(self.g, u)
        s = (1.0 - g * g) / (1.0 - g + 2.0 * g * u)
        return ((1.0 + g * g - s * s) / (2.0 * g)).clamp(-1.0, 1.0)

    def _rotated_velocity(self, state, scatter, cos_t, u_phi):
        """Rotate each scattering photon's velocity by the polar cosine
        ``cos_t`` relative to its direction and a uniform azimuth from
        ``u_phi``, renormalised to |v| = c; returns ``(v, dv)``."""
        sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp(min=0.0))
        phi = u_phi * (2 * np.pi)
        cos_p, sin_p = torch.cos(phi), torch.sin(phi)
        v = state.v
        inv_v = torch.rsqrt((v * v).sum(dim=0).clamp(min=1e-30))
        d = tuple(v[i] * inv_v for i in range(3))
        n_new = _hg_direction(d, cos_t, sin_t, cos_p, sin_p)
        inv_n = torch.rsqrt(_sum3([x * x for x in n_new]))
        c_val = _const(self._c, inv_n) * inv_n
        v_new = torch.stack([x * c_val for x in n_new])
        return (torch.where(scatter, v_new, v),
                torch.where(scatter, v_new - v, torch.zeros_like(v)))

    def apply(self, state, ctx):
        if self._c is None:
            self.setup(None)
        norm = _dr_norm(state)
        pcoll = self._pcoll(state, norm)
        u3 = ctx.uniform((3,) + tuple(norm.shape), norm.dtype)
        scatter = ((pcoll >= u3[0]) & (state.otype == OBJ_PHOTON)
                   & state.alive)
        cos_t = self._cos_theta(u3[1])
        v, dv = self._rotated_velocity(state, scatter, cos_t, u3[2])
        return state.replace(v=v, dv=dv)


class ScatterPhaseFunctionStep(ScatterHenyeyGreensteinStep):
    """Anisotropic scatter with a user phase function, in the HG family's
    collision model and rotation: ``phase_table=(mu_grid, pdf)`` (e.g.
    :func:`mie_phase_table`) becomes a piecewise-linear inverse CDF over
    ``table_bins`` (default 64) uniform-in-u knots that the kernel reads
    from its auxiliary table; ``cos_theta_icdf=<callable>``, a torch
    function ``u -> cos(theta)``, is recorded by the prover into an
    expression program that the kernel evaluates at the draw (a callable
    the recorder cannot take is refused, ``field-fn-callable``). Both are
    clipped to [-1, 1]. Unknown options raise."""

    _OPTIONS = {"n", "A", "wavelength_dep_scattering", "variable_n",
                "variable_n_fn", "cos_theta_icdf", "phase_table",
                "table_bins"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self._OPTIONS
        if unknown:
            raise ValueError(f"unknown option(s) {sorted(unknown)}; "
                             f"supported: {sorted(self._OPTIONS)}")
        icdf = kwargs.pop("cos_theta_icdf", None)
        table = kwargs.pop("phase_table", None)
        bins = int(kwargs.pop("table_bins", 64))
        if (icdf is None) == (table is None):
            raise ValueError("pass exactly one of cos_theta_icdf= or "
                             "phase_table=(mu_grid, pdf)")
        self._icdf = None
        self._knots = None
        if icdf is not None:
            if not callable(icdf):
                raise TypeError("cos_theta_icdf must be a callable "
                                "u -> cos(theta)")
            self._icdf = icdf
        else:
            self._knots = phase_knots(table[0], table[1], bins)
        super().__init__(**kwargs)

    def _cos_theta(self, u):
        if self._knots is not None:
            return phase_icdf(u, *self._knots).clamp(-1.0, 1.0)
        return _field_value(self._icdf, self._icdf(u), "cos_theta_icdf",
                            u).clamp(-1.0, 1.0)


class ScatterRayleighStep(ScatterHenyeyGreensteinStep):
    """Rayleigh scatter with the dipole phase function (3/8)(1 + cos^2
    theta) (``<cos^2 theta> = 2/5``), sampled by the closed-form Cardano
    inverse CDF relative to the incoming direction; options as
    :class:`ScatterHenyeyGreensteinStep` (``wavelength_dep_scattering`` for
    the lambda^-4 cross-section)."""

    def __init__(self, **kwargs):
        kwargs.pop("g", None)  # no anisotropy parameter: the phase is fixed
        super().__init__(**kwargs)

    def _cos_theta(self, u):
        return _rayleigh_cos_theta(u)


class ScatterComptonStep(ScatterHenyeyGreensteinStep):
    """Compton scatter off free electrons: the exact Klein-Nishina angle
    (Kahn's rejection below alpha = 1 + sqrt(3), Koblinger's direct method
    above, at most ``kn_max_tries`` Kahn tries, default 12) and the recoil
    ``E' = E / (1 + alpha (1 - cos theta))``, ``alpha = E / m_e c^2``
    (``mec2`` overrides the rest energy, default m_e c^2 in code units).
    ``kn_cross_section=True`` multiplies pcoll by sigma_KN / sigma_Thomson.

    ``theta_e`` (kT_e / m_e c^2) or ``T_e`` (Kelvin) scatters off thermal
    electrons (non-relativistic Maxwell, |beta| <= 0.9; valid for theta_e
    <= ~0.05, accepted with a RuntimeWarning up to 0.2): the collision rate
    carries the flux factor ``1 - beta . n`` and the scatter is exact
    Klein-Nishina in the electron frame, which gives the Kompaneets drift
    ``<dE/E> = 4 theta_e - alpha``. Keep ``pcoll`` unsaturated (<= ~0.5):
    where ``pcoll * flux`` clips at 1 the drift falls toward 3 theta_e.

    ``measure_deposition=True``: ``data`` rows ``[t, E_dep]``, the net
    energy given to electrons, ``sum(w (E - E'))`` over scatters (negative
    where inverse Compton heats the photons); CSV through ``out_fn``."""

    _ALLOWED_KW = frozenset({"A", "n", "variable_n", "variable_n_fn"})

    mesh_records = {"t": "once", "dep": "sum"}

    def __init__(self, **kwargs):
        if kwargs.pop("wavelength_dep_scattering", False):
            raise ValueError(
                "ScatterComptonStep has no lambda^-4 option; use "
                "kn_cross_section=True for the physical Klein-Nishina "
                "energy dependence")
        self.measure_deposition = bool(kwargs.pop("measure_deposition",
                                                  False))
        self.out_fn = kwargs.pop("out_fn", None)
        self.data = []
        if "g" in kwargs:
            raise ValueError(
                "ScatterComptonStep has no anisotropy parameter g: the "
                "angular law IS the Klein-Nishina distribution")
        self.kn_cross_section = bool(kwargs.pop("kn_cross_section", False))
        self.mec2 = kwargs.pop("mec2", None)
        self.kn_max_tries = int(kwargs.pop("kn_max_tries", 12))
        if self.kn_max_tries < 1:
            raise ValueError("kn_max_tries must be >= 1")
        theta_e = kwargs.pop("theta_e", None)
        T_e = kwargs.pop("T_e", None)
        if theta_e is not None and T_e is not None:
            raise ValueError("pass theta_e (= kT_e / m_e c^2) OR T_e "
                             "(Kelvin), not both")
        self.theta_e = None if theta_e is None else float(theta_e)
        self.T_e = T_e
        if self.theta_e is not None:
            if not 0.0 <= self.theta_e <= 0.2:
                raise ValueError(
                    f"theta_e must be in [0, 0.2] (Maxwell electron "
                    f"sampling validity; ~100 keV), got {self.theta_e}")
            if self.theta_e > 0.05:
                import warnings

                warnings.warn(
                    f"theta_e = {self.theta_e}: above ~0.05 the "
                    "non-relativistic Maxwell electron draw degrades — "
                    "P(|beta| > 0.9) grows to O(10%) and the hard clip "
                    "plus missing Maxwell-Juttner corrections bias the "
                    "Doppler kernel by O(theta_e)", RuntimeWarning,
                    stacklevel=2)
        unknown = set(kwargs) - self._ALLOWED_KW
        if unknown:
            raise ValueError(
                f"ScatterComptonStep: unknown option(s) {sorted(unknown)}; "
                f"supported: {sorted(self._ALLOWED_KW)} + kn_cross_section/"
                "mec2/kn_max_tries/theta_e/T_e")
        super().__init__(**kwargs)
        self._inv_mec2 = None
        self._theta_e = None

    def setup(self, sim) -> None:
        super().setup(sim)
        mec2 = (_host_code(self.mec2, "mec2") if self.mec2 is not None
                else float(raw_code_value(m_e))
                * float(raw_code_value(c)) ** 2)
        if mec2 <= 0:
            raise ValueError("mec2 must be positive")
        self._inv_mec2 = 1.0 / float(mec2)
        if self.T_e is not None:
            kT = _host_code(self.T_e, "T_e") * float(raw_code_value(kB))
            self._theta_e = float(kT * self._inv_mec2)
            if not 0.0 <= self._theta_e <= 0.2:
                raise ValueError(
                    f"T_e gives theta_e = {self._theta_e:.3g}; Maxwell "
                    "electron sampling is valid for theta_e <= 0.2")
        else:
            self._theta_e = self.theta_e

    def apply(self, state, ctx):
        if self._c is None or self._inv_mec2 is None:
            self.setup(None)
        norm = _dr_norm(state)
        pcoll = self._pcoll(state, norm)
        T = self.kn_max_tries
        thermal = self._theta_e is not None and self._theta_e > 0.0
        n_extra = 4 if thermal else 0
        # u[0] the collision, u[1] the azimuth, (thermal: u[2:6] the
        # electron,) then the Kahn tries' triples
        u = ctx.uniform((2 + n_extra + 3 * T,) + tuple(norm.shape),
                        norm.dtype)
        triples = [(u[2 + n_extra + 3 * i], u[3 + n_extra + 3 * i],
                    u[4 + n_extra + 3 * i]) for i in range(T)]
        photon = (state.otype == OBJ_PHOTON) & state.alive
        if thermal:
            v = state.v
            inv_v = torch.rsqrt((v * v).sum(dim=0).clamp(min=1e-30))
            nhat = tuple(v[i] * inv_v for i in range(3))
            E_new, n_new, alpha1, flux, accepted = _ic_thermal_scatter(
                state.E, nhat, self._inv_mec2, self._theta_e, u[2:6],
                lambda a1: _kn_cos_eta(a1, triples), u[1])
            pcoll = pcoll * flux
            if self.kn_cross_section:
                pcoll = pcoll * _kn_sigma_ratio(alpha1)
            scatter = (pcoll >= u[0]) & photon & accepted
            c_val = _const(self._c, v)
            v_new = torch.stack([x * c_val for x in n_new])
            v_out = torch.where(scatter, v_new, v)
            dv = torch.where(scatter, v_new - v, torch.zeros_like(v))
        else:
            alpha = state.E * _const(self._inv_mec2, state.E)
            if self.kn_cross_section:
                pcoll = pcoll * _kn_sigma_ratio(alpha)
            cos_t, eta, accepted = _kn_cos_eta(alpha, triples)
            scatter = (pcoll >= u[0]) & photon & accepted
            v_out, dv = self._rotated_velocity(state, scatter, cos_t, u[1])
            E_new = state.E / eta
        if self.measure_deposition:
            ctx.record(self, "t", state.t)
            ctx.record(self, "dep", torch.where(
                scatter, state.w * (state.E - E_new), 0.0).sum())
        return state.replace(v=v_out, dv=dv,
                             E=torch.where(scatter, E_new, state.E))

    def collect(self, sim, records) -> None:
        if not self.measure_deposition:
            return
        for i in range(len(records["t"])):
            self.data.append([float(records["t"][i]),
                              float(records["dep"][i])])

    # CSV at terminate, as every MeasureStep
    terminate = MeasureStep.terminate


class RefractiveInterfaceStep(Step):
    """Fresnel reflection and Snell refraction at the plane ``r[axis] ==
    loc`` between media of refractive index ``n_lo`` (``r[axis] < loc``)
    and ``n_hi``. A photon whose segment ``[r - dr, r]`` crossed the plane
    is reflected with the unpolarised Fresnel reflectance ``R = (rs^2 +
    rp^2) / 2`` (``R = 1`` beyond the critical angle) or refracted, by one
    uniform draw; it moves to the intersection and retraces the rest of its
    step in the outgoing direction. ``E`` is kept and ``dv`` not marked.
    ``match_speed=True`` sets the outgoing speed to ``c / n`` of the
    receiving medium (the rest of the step keeps its time), which turns the
    const-norm path off."""

    mesh_records = {}

    def __init__(self, loc, n_lo, n_hi, axis: int = 2,
                 match_speed: bool = False):
        self.loc = _as_code(loc)
        self.n_lo = float(n_lo)
        self.n_hi = float(n_hi)
        if not (self.n_lo > 0.0 and self.n_hi > 0.0):
            raise ValueError("refractive indices must be positive")
        self.axis = int(axis)
        if self.axis not in (0, 1, 2):
            raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
        self.match_speed = bool(match_speed)
        self._c = None

    def setup(self, sim) -> None:
        self._c = float(raw_code_value(c))

    def apply(self, state, ctx):
        if self._c is None:
            self.setup(None)
        ax = self.axis
        r, dr, v = state.r, state.dr, state.v
        loc = _const(self.loc, r)
        z1 = r[ax]
        z0 = z1 - dr[ax]
        side0 = z0 >= loc
        crossed = ((side0 != (z1 >= loc)) & (state.otype == OBJ_PHOTON)
                   & state.alive)
        inv_speed = torch.rsqrt((v * v).sum(dim=0).clamp(min=1e-30))
        d = v * inv_speed  # the unit incident direction
        # the media each crosser sees: from the lo side (going up) or not
        going_up = ~side0
        n_lo, n_hi = _const(self.n_lo, r), _const(self.n_hi, r)
        nf = torch.where(going_up, n_lo, n_hi)
        nt = torch.where(going_up, n_hi, n_lo)
        cos_i = d[ax].abs().clamp(0.0, 1.0)
        sin2_i = 1.0 - cos_i * cos_i
        mu = nf / nt
        sin2_t = mu * mu * sin2_i
        tir = sin2_t > 1.0
        cos_t = torch.sqrt((1.0 - sin2_t).clamp(0.0, 1.0))
        rs = (nf * cos_i - nt * cos_t) / (nf * cos_i + nt * cos_t)
        rp = (nf * cos_t - nt * cos_i) / (nf * cos_t + nt * cos_i)
        R = torch.where(tir, 1.0, (0.5 * (rs * rs + rp * rp)).clamp(0.0,
                                                                    1.0))
        u = ctx.uniform(z1.shape, z1.dtype)
        reflect = crossed & (u < R)
        # the segment's intersection with the plane: r0 + s dr
        dz = z1 - z0
        s = (loc - z0) / torch.where(crossed, dz, torch.ones_like(dz))
        r0 = r - dr
        p = r0 + s * dr
        seg = torch.sqrt((dr * dr).sum(dim=0))
        # outgoing unit directions: the mirror, or Snell's bend
        d_ref = d.clone()
        d_ref[ax] = -d[ax]
        sgn = torch.where(d[ax] >= 0, 1.0, -1.0).to(d.dtype)
        d_tr = mu * d
        d_tr[ax] = sgn * cos_t
        d_tr = d_tr * torch.rsqrt((d_tr * d_tr).sum(dim=0).clamp(min=1e-30))
        d_out = torch.where(reflect, d_ref, d_tr)
        if self.match_speed:
            speed_out = _const(self._c, r) / torch.where(reflect, nf, nt)
        else:
            speed_out = 1.0 / inv_speed
        # the rest of the step's time, at the outgoing speed
        rem = (1.0 - s) * seg * speed_out * inv_speed
        r_new = p + d_out * rem
        v_new = d_out * speed_out
        return state.replace(r=torch.where(crossed, r_new, r),
                             v=torch.where(crossed, v_new, v),
                             dr=torch.where(crossed, r_new - r0, dr))


class ScatterSignMeasureStep(MeasureStep):
    """Counts alive objects with strictly positive vx/vy/vz each iteration;
    ``data`` rows are ``[t, n, count_x, count_y, count_z]`` (``n`` only with
    ``measure_n``). ``weighted=True`` sums statistical weights instead of
    counting (the isotropy tally under implicit capture)."""

    mesh_records = {"t": "once", "n": "sum", "signs": "sum"}

    def __init__(self, out_fn=None, measure_n: bool = True,
                 weighted: bool = False):
        super().__init__(out_fn)
        self.measure_n = measure_n
        self.weighted = bool(weighted)

    def apply(self, state, ctx):
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        pos = (state.v > 0) & state.alive[None, :]
        if self.weighted:
            ctx.record(self, "signs",
                       torch.where(pos, state.w[None, :], 0.0).sum(dim=1))
        else:
            ctx.record(self, "signs", pos.sum(dim=1, dtype=torch.int32))
        return state

    def collect(self, sim, records) -> None:
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            row.extend(records["signs"][i])
            self.data.append(np.array(row))


class ScatterMeasureStep(MeasureStep):
    """Counts photons crossing axis-aligned planes each iteration. A plane
    is a 3-vector whose non-axis coordinates are NaN; a photon crossed it
    when ``r - dr <= L <= r`` in either direction. ``data`` rows are ``[t,
    n, count0, (E0,) count1, ...]``.

    ``weighted=True`` reports each plane's weight sum over crossing photons
    instead of the count, and energy flux as ``sum(w*E)``. ``measure_E=True``
    adds each plane's energies: in ``measure_E_mode="list"`` (the default,
    the reference's row format) the list of the crossing photons' energies,
    ordered by slot, and the row is an object array; in ``"sum"`` their
    sum. The kernel writes the energies into a stream plane (E where
    crossed, NaN elsewhere); the engine compacts it on the device and
    copies only the crossing photons' energies to the host."""

    mesh_records = {"t": "once", "n": "sum", "count": "sum",
                    "Esum": "sum", "E": "cat"}

    def __init__(self, out_fn=None, measure_n: bool = True, measure_locs=(),
                 measure_E: bool = False, measure_E_mode: str = "list",
                 weighted: bool = False):
        super().__init__(out_fn)
        self.measure_locs = list(measure_locs)
        self.measure_n = measure_n
        self.measure_E = measure_E
        self.weighted = bool(weighted)
        if measure_E_mode not in ("list", "sum"):
            raise ValueError("measure_E_mode must be 'list' or 'sum'")
        self.measure_E_mode = measure_E_mode
        self._axes = []
        for loc in self.measure_locs:
            loc = np.asarray(loc, np.double)
            axis = (0 if not np.isnan(loc[0])
                    else (1 if not np.isnan(loc[1]) else 2))
            self._axes.append((axis, float(loc[axis])))

    def apply(self, state, ctx):
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        for j, (axis, L) in enumerate(self._axes):
            hi = state.r[axis]
            lo = hi - state.dr[axis]
            crossed = (((lo <= L) & (L <= hi)) | ((lo >= L) & (L >= hi)))
            crossed = crossed & state.alive
            if self.weighted:
                ctx.record(self, f"count{j}",
                           torch.where(crossed, state.w, 0.0).sum())
            else:
                ctx.record(self, f"count{j}",
                           crossed.sum(dtype=torch.int32))
            if self.measure_E and self.measure_E_mode == "sum":
                flux = state.w * state.E if self.weighted else state.E
                ctx.record(self, f"Esum{j}",
                           torch.where(crossed, flux, 0.0).sum())
            elif self.measure_E:
                ctx.record(self, f"E{j}",
                           torch.where(crossed, state.E, float("nan")))
        return state

    def collect(self, sim, records) -> None:
        lists = self.measure_E and self.measure_E_mode == "list"
        # per-iteration arrays of the crossing photons' energies: a stream
        # record on the fused tier, (iterations, C) arrays on the generic
        E_lists = ([_per_iteration(records[f"E{j}"])
                    for j in range(len(self._axes))] if lists else None)
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            for j in range(len(self._axes)):
                row.append(records[f"count{j}"][i])
                if lists:
                    row.append(list(E_lists[j][i]))
                elif self.measure_E:
                    row.append(float(records[f"Esum{j}"][i]))
            self.data.append(np.array(row, dtype=object) if lists
                             else np.array(row))


def _per_iteration(rec) -> List[np.ndarray]:
    if hasattr(rec, "per_iteration"):
        return rec.per_iteration()
    return [row[~np.isnan(row)] for row in np.asarray(rec)]


class SphericalShellMeasureStep(MeasureStep):
    """Counts particles crossing the spherical shell ``|r - center| =
    radius`` each iteration: the escape-flux counterpart of the plane
    tally, with its endpoint convention (``|r - dr - c|`` and ``|r - c|``
    straddle the radius, either direction; a chord that enters and leaves
    within one step is not counted). ``weighted=True`` sums statistical
    weights. ``data`` rows ``[t(, n), crossings]``; CSV through
    ``out_fn``."""

    mesh_records = {"t": "once", "n": "sum", "count": "sum"}

    def __init__(self, out_fn=None, radius=1.0, center=(0.0, 0.0, 0.0),
                 measure_n: bool = True, weighted: bool = False):
        super().__init__(out_fn)
        self.radius = float(raw_code_value(radius))
        if self.radius <= 0:
            raise ValueError(f"radius must be positive, got {self.radius}")
        self.center = tuple(
            float(x) for x in np.asarray(raw_code_value(center),
                                         np.float64).reshape(3))
        self.measure_n = measure_n
        self.weighted = bool(weighted)

    def apply(self, state, ctx):
        ctx.record(self, "t", state.t)
        if self.measure_n:
            ctx.record(self, "n", state.n_alive)
        dtype = state.r.dtype
        c0 = torch.tensor(self.center, dtype=dtype,
                          device=state.device)[:, None]
        d1 = state.r - c0
        d0 = d1 - state.dr
        r1 = (d1 * d1).sum(dim=0)
        r0 = (d0 * d0).sum(dim=0)
        R2 = torch.tensor(self.radius * self.radius, dtype=dtype,
                          device=state.device)
        crossed = (((r0 <= R2) & (R2 <= r1))
                   | ((r0 >= R2) & (R2 >= r1))) & state.alive
        if self.weighted:
            ctx.record(self, "count0",
                       torch.where(crossed, state.w, 0.0).sum())
        else:
            ctx.record(self, "count0", crossed.sum(dtype=torch.int32))
        return state

    def collect(self, sim, records) -> None:
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            row.append(records["count0"][i])
            self.data.append(np.array(row))


def _histogram_names(edges, underflow, overflow):
    """Validated float64 edges and the bins' output names."""
    edges = np.asarray(edges, dtype=np.float64)
    if edges.ndim != 1 or edges.size < 2:
        raise ValueError("edges must be a 1-D array of >= 2 bin edges")
    if not (np.diff(edges) > 0).all():
        raise ValueError("edges must be strictly increasing")
    names = tuple(f"bin{i}" for i in range(edges.size - 1))
    if underflow:
        names += ("underflow",)
    if overflow:
        names += ("overflow",)
    return edges, names


def _binned(coord, val, e, underflow, overflow):
    """Per-bin contributions: the mask (a count) or ``val`` where the
    coordinate falls in the bin (lower-edge convention ``e[i] <= coord <
    e[i+1]``; the capture bins outside the range)."""
    def put(m):
        return m if val is None else torch.where(m, val, 0.0)

    out = {f"bin{i}": put((coord >= e[i]) & (coord < e[i + 1]))
           for i in range(len(e) - 1)}
    if underflow:
        out["underflow"] = put(coord < e[0])
    if overflow:
        out["overflow"] = put(coord >= e[-1])
    return out


class Binning:
    """A histogram tally's structure, which the fused prover lowers to
    kernel 1i's binned reduce (one bin index and one grouped sum a slot,
    ``ops/pipeline.py``) in place of a sum per output: the coordinate
    ``coord`` (``"E"``, ``"rx"``, ``"ry"``, ``"rz"``, or ``"r"`` for ``|r -
    center|``), the value a particle adds (``None`` for a count, ``"E"``,
    ``"w"``, ``"Ew"``, ``"dr"`` for ``|dr|``, ``"drw"``), the float64
    ``edges`` and the capture bins. :meth:`contributions` is the step's
    function (per-bin masks, as the JAX package's step returns them), built
    on :meth:`coord_value`, which the prover records."""

    def __init__(self, coord, value, edges, underflow, overflow,
                 center=(0.0, 0.0, 0.0)):
        self.coord = coord
        self.value = value
        self.edges = tuple(float(v) for v in edges)
        self.underflow = bool(underflow)
        self.overflow = bool(overflow)
        self.center = tuple(float(v) for v in center)

    def coord_value(self, p):
        """``(coordinate, value or None)`` of a ``ParticleView``: the
        operations of the JAX package's contributions, in its order."""
        if self.coord == "r":
            cx, cy, cz = self.center
            coord = torch.sqrt((p.rx - cx) ** 2 + (p.ry - cy) ** 2
                               + (p.rz - cz) ** 2)
        else:
            coord = getattr(p, self.coord)
        val = None
        if self.value in ("E", "Ew"):
            val = p.E
        elif self.value in ("dr", "drw"):
            val = torch.sqrt(p.drx ** 2 + p.dry ** 2 + p.drz ** 2)
        if self.value in ("w", "Ew", "drw"):
            val = p.w if val is None else val * p.w
        return coord, val

    def contributions(self, p):
        coord, val = self.coord_value(p)
        return _binned(coord, val, self.edges, self.underflow, self.overflow)


class SpectrumMeasureStep(ReduceMeasureStep):
    """Per-iteration energy histogram over alive particles, summed in the
    transport kernel's float record columns (a :class:`ReduceMeasureStep`
    whose contributions are per-bin masks or masked energies; the fused
    tier runs it as a binned reduce, :class:`Binning`).

    ``edges`` is an increasing 1-D array of bin edges (bin i counts
    ``edges[i] <= E < edges[i+1]``, the edges rounded to float32 as the
    comparisons round them). ``weight="count"`` tallies photons,
    ``weight="energy"`` their energies. ``underflow`` / ``overflow`` add
    capture bins outside the range; ``weighted=True`` multiplies every
    contribution by the statistical weight ``w``. ``data`` rows are ``[t(,
    n), bin_0, ..., (underflow,) (overflow,)]``, CSV via ``out_fn``. The
    record row holds 128 float columns: at most ~120 bins per plan (the
    prover refuses more as ``record-columns``); counts are integer-exact to
    2**24 per iteration."""

    def __init__(self, out_fn=None, edges=None, measure_n: bool = False,
                 weight: str = "count", underflow: bool = False,
                 overflow: bool = False, weighted: bool = False):
        edges, names = _histogram_names(edges, underflow, overflow)
        if weight not in ("count", "energy"):
            raise ValueError(f"weight must be 'count' or 'energy', "
                             f"got {weight!r}")
        self.edges = edges
        self.weight = weight
        value = "E" if weight == "energy" else None
        if weighted:
            value = "w" if value is None else "Ew"
        self.binning = Binning("E", value, edges, underflow, overflow)
        super().__init__(out_fn, self.binning.contributions, outputs=names,
                         measure_n=measure_n)


class MeshTallyStep(ReduceMeasureStep):
    """Per-iteration spatial histogram over alive particles, summed in the
    transport kernel's float record columns: the cell tally or dose map
    beside :class:`SpectrumMeasureStep` (a binned reduce on the fused tier,
    :class:`Binning`).

    ``axis`` is ``"x"``, ``"y"``, ``"z"`` (slabs) or ``"r"`` (shells of
    ``|r - center|``); ``edges`` as in SpectrumMeasureStep, with
    ``underflow`` / ``overflow``. ``value`` is what a particle deposits in
    its end-of-iteration cell: ``"count"``, ``"energy"`` (``E``) or
    ``"pathlength"`` (``|dr|``, the track-length estimator); ``weighted``
    multiplies by ``w``. ``data`` rows ``[t(, n), bin_0, ...]``, CSV via
    ``out_fn``."""

    def __init__(self, out_fn=None, axis: str = "x", edges=None,
                 value: str = "count", center=(0.0, 0.0, 0.0),
                 measure_n: bool = False, weighted: bool = False,
                 underflow: bool = False, overflow: bool = False):
        edges, names = _histogram_names(edges, underflow, overflow)
        if axis not in ("x", "y", "z", "r"):
            raise ValueError(f"axis must be 'x', 'y', 'z' or 'r', "
                             f"got {axis!r}")
        if value not in ("count", "energy", "pathlength"):
            raise ValueError(f"value must be 'count', 'energy' or "
                             f"'pathlength', got {value!r}")
        if axis == "r" and (edges < 0).any():
            raise ValueError("radial bin edges must be non-negative")
        self.axis = axis
        self.value = value
        self.edges = edges
        self.center = tuple(float(_as_float(v)) for v in center)
        val = {"count": None, "energy": "E", "pathlength": "dr"}[value]
        if weighted:
            val = "w" if val is None else val + "w"
        self.binning = Binning("r" + axis if axis != "r" else "r", val,
                               edges, underflow, overflow, self.center)
        super().__init__(out_fn, self.binning.contributions, outputs=names,
                         measure_n=measure_n)


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) as the float32 values they encode."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


class TracePathMeasureStep(MeasureStep):
    """Records every object's position each sampled iteration;
    ``terminate`` builds the reference's t-aligned matrix: first row
    ``["t", t0, ...]``, then per slot ``[id_info(, freq), r vectors...,
    NaN padding after death]``.

    The kernel writes the positions into the chunk's stream buffer on the
    device; each chunk's buffer stays there (one buffer shared by every
    trace step of the chunk) until the matrix is assembled (``data`` /
    :meth:`as_arrays` / CSV), except that chunks beyond
    ``device_hold_bytes`` move to host memory oldest first.

    ``trace_every=k`` samples the iterations that are global multiples of
    k (the kernel's stream stride is the gcd of every trace step's);
    ``trace_dtype="bfloat16"`` records rounded positions (8-bit mantissa,
    float32 range; the transport stays float32) at half the stream bytes;
    ``trace_dv=True`` adds each slot's scatter-event count after its id
    (every iteration only). Slots must stay put for the rows to mean one
    photon each, so a traced run never recycles slots
    (``needs_stable_ids``).

    On the generic tier the step records each iteration's positions, alive
    mask and scatter flags as device records (``device_records``), which
    stay on the device under the same hold budget.

    A mesh across processes traces shard-locally: each process assembles
    only its contiguous span of the particle axis (rows keep global slot
    ids; ``col0`` is the global id of local column 0, and CSV paths gain a
    ``.p{rank}`` suffix), so no stream buffer crosses processes. Mid-run
    capacity growth is refused there (it would move the spans); size
    ``capacity=`` for the peak population."""

    needs_stable_ids = True
    device_records = ("pos", "alive", "scat")
    device_hold_bytes = 4 << 30
    _data_override = None
    _cached_rows = None

    mesh_records = {"pos": "local", "alive": "local", "scat": "local"}

    def __init__(self, out_fn=None, trace_type=Object,
                 id_info_fn: Callable = lambda x: str(type(x)),
                 trace_dv: bool = False, trace_every: int = 1,
                 trace_dtype: str = "float32"):
        super().__init__(out_fn)
        self.trace_type = trace_type
        self.id_info_fn = id_info_fn
        self.trace_dv = trace_dv
        self.trace_every = int(trace_every)
        self.trace_dtype = str(trace_dtype)
        if self.trace_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"trace_dtype {trace_dtype!r} not supported; use 'float32' "
                "or 'bfloat16'")
        if self.trace_every < 1:
            raise ValueError("trace_every must be >= 1")
        if self.trace_dv and self.trace_every > 1:
            raise ValueError(
                "trace_dv counts scatter events at every iteration and is "
                "incompatible with strided tracing (trace_every > 1)")
        # per chunk: the stream record (_TraceRaw) of the fused tier, or the
        # generic tier's (k, 3, C) positions with (k, C) alive masks
        self._pos: List = []
        self._alive: List = []
        self._freq = None       # generic tier: (C,) scatter-event counts
        self._seen = 0          # valid global iterations consumed
        self._gidx: List = []   # per chunk: sampled global iterations
        self._mesh = None       # a mesh across processes: shard-local
        self.col0 = 0           # set at assembly: global id of column 0

    def setup(self, sim) -> None:
        mesh = getattr(sim, "mesh", None) if sim is not None else None
        self._mesh = mesh if mesh_spans_processes(mesh) else None


    def apply(self, state, ctx):
        pos = (state.r.to(torch.bfloat16)
               if self.trace_dtype == "bfloat16" else state.r)
        ctx.record(self, "pos", pos)
        ctx.record(self, "alive", state.alive)
        if self.trace_dv:
            scat = (state.dv != 0).any(dim=0) & state.alive
            ctx.record(self, "scat", scat.to(torch.int32))
        return state

    def collect(self, sim, records) -> None:
        S = self.trace_every
        if "traceraw" not in records:
            # generic tier: device records, trimmed to the valid prefix
            pos, alive = records["pos"], records["alive"]
            k = int(pos.shape[0])
            if S > 1:
                g = self._seen + np.arange(k)
                keep = np.flatnonzero((g % S) == 0)
                self._gidx.append(g[keep])
                idx = torch.from_numpy(keep).to(pos.device)
                pos, alive = pos[idx], alive[idx]
            self._seen += k
            self._pos.append(pos)
            self._alive.append(alive)
            if self.trace_dv and "scat" in records:
                s = records["scat"].sum(dim=0, dtype=torch.int64)
                self._freq = s if self._freq is None else self._freq + s
            self._maybe_spill()
            return
        # the chunk's raw stream buffer, trimmed to its valid iterations
        x = records["traceraw"]
        n_it = x.n_valid if x.n_valid >= 0 else x.buf.shape[0] * x.every
        if S > 1:
            # buffer row m holds iteration seen + m * every: keep the rows
            # on global multiples of trace_every
            m = np.arange(-(-n_it // x.every))
            g = self._seen + m * x.every
            keep = (g % S) == 0
            x.rows = m[keep]
            self._gidx.append(g[keep])
        self._seen += n_it
        self._pos.append(x)
        self._alive.append(None)
        self._maybe_spill()

    def _held(self, i) -> int:
        x = self._pos[i]
        if hasattr(x, "buf"):
            return (x.buf.numel() * x.buf.element_size()
                    if isinstance(x.buf, torch.Tensor) else 0)
        return sum(y.numel() * y.element_size()
                   for y in (x, self._alive[i]) if isinstance(y, torch.Tensor))

    def _maybe_spill(self) -> None:
        """Move the oldest held chunks to host memory once the held total
        exceeds ``device_hold_bytes`` (a tensor is held, a numpy array
        spilled: on the CPU too, so the policy runs the same there)."""
        total = sum(self._held(i) for i in range(len(self._pos)))
        for i, x in enumerate(self._pos):
            if total <= self.device_hold_bytes:
                break
            held = self._held(i)
            if not held:
                continue
            total -= held
            # this process's span only, on a mesh across processes
            if not hasattr(x, "buf"):
                self._pos[i], _ = local_shard_np(x.float(), self._mesh)
                self._alive[i], _ = local_shard_np(self._alive[i],
                                                   self._mesh)
                continue
            # through the shared holder: every trace step's record of this
            # chunk references the same buffer
            buf = x.buf
            if buf.dtype == torch.bfloat16:
                bits, _ = local_shard_np(buf.view(torch.int16), self._mesh)
                x.hold.arr = bits.view(np.uint16)
            else:
                x.hold.arr, _ = local_shard_np(buf, self._mesh)

    def _chunk_np(self, i):
        """Chunk i as host arrays: positions (rows, 3, C) float32, alive
        (rows, C) and scatter flags (rows, C) or None, and the global id of
        column 0 (on a mesh across processes C is this process's span,
        :func:`~physicl_tpu_torch.parallel.distributed.local_shard_np`).
        Only this step's sampled rows and planes leave the device."""
        x = self._pos[i]
        if not hasattr(x, "buf"):  # the generic tier's records
            x, col0 = local_shard_np(
                x.float() if isinstance(x, torch.Tensor) else x, self._mesh)
            alive, _ = local_shard_np(self._alive[i], self._mesh)
            return np.asarray(x, np.float32), np.asarray(alive), None, col0
        buf = x.buf
        n_it = x.n_valid if x.n_valid >= 0 else buf.shape[0] * x.every
        rows = (x.rows if x.rows is not None
                else np.arange(-(-n_it // x.every)))
        npl = 4 if x.scat else 3
        if isinstance(buf, torch.Tensor):
            idx = torch.from_numpy(rows).to(buf.device)
            sub = buf[idx, x.p0:x.p0 + npl].float()
        else:
            sub = buf[rows, x.p0:x.p0 + npl]
            if sub.dtype == np.uint16:  # spilled bfloat16 bits
                sub = _bf16_bits_to_f32(sub)
        sub, col0 = local_shard_np(sub, self._mesh)
        alive = ~np.isnan(sub[:, 0, :])
        return (sub[:, :3, :], alive, (sub[:, 3, :] if x.scat else None),
                col0)

    @property
    def data(self):
        """The reference's t-aligned trace matrix, assembled on first
        access after the run (use :meth:`as_arrays` for the dense form)."""
        if self._data_override is not None:
            return self._data_override
        if self._cached_rows is None:
            self._cached_rows = self._build_rows()
        return self._cached_rows

    @data.setter
    def data(self, value):
        self._data_override = value

    def as_arrays(self):
        """Dense trace: ``(ts list, positions (T, 3, C) float32, alive (T,
        C), freq (C,) int64 or None)``. The host assembly point: held
        chunks are fetched here, one chunk at a time."""
        if not self._pos:
            return [], np.zeros((0, 3, 0)), np.zeros((0, 0), bool), None
        chunks = [self._chunk_np(i) for i in range(len(self._pos))]
        col0s = {c[3] for c in chunks}
        if len(col0s) > 1:
            # shard-local assembly across processes: the span moved between
            # chunks (capacity growth re-splits the particle axis), so the
            # chunks' column blocks no longer align to one global offset
            raise NotImplementedError(
                "TracePathMeasureStep on a process-spanning mesh does not "
                f"support mid-run capacity growth (local spans {col0s}); "
                "pre-size capacity= for the peak population")
        self.col0 = col0s.pop()
        T = sum(p.shape[0] for p, _, _, _ in chunks)
        cmax = max(p.shape[-1] for p, _, _, _ in chunks)
        pos = np.zeros((T, 3, cmax), np.float32)
        alive = np.zeros((T, cmax), bool)
        # scatter-event counts: the generic tier's on the device, the fused
        # tier's summed from each chunk's flag plane
        freq = (None if self._freq is None
                else np.pad(self._freq.cpu().numpy(),
                            (0, cmax - self._freq.shape[0])))
        t0 = 0
        for p, a, scat, _ in chunks:
            t1 = t0 + p.shape[0]
            pos[t0:t1, :, :p.shape[-1]] = p
            alive[t0:t1, :a.shape[-1]] = a
            if scat is not None:
                s = np.nan_to_num(scat).sum(axis=0).astype(np.int64)
                s = np.pad(s, (0, cmax - s.shape[0]))
                freq = s if freq is None else freq + s
            t0 = t1
        if self.trace_every > 1:
            # strided: the t row carries only the sampled iterations' times
            g = (np.concatenate(self._gidx)
                 if self._gidx else np.zeros(0, np.int64))
            ts = [self._ts[int(i)] for i in g if i < len(self._ts)]
        else:
            ts = self._ts
        return ts, pos, alive, freq

    def _build_rows(self):
        ts, pos, alive, freq = self.as_arrays()
        if pos.shape[0] == 0:
            return [["t"]]
        T = pos.shape[0]
        rows: List[list] = [["t"] + list(ts)]
        # columns are the global slots [col0, col0 + C): the whole
        # population on one process, this process's span across processes
        # (rows keep the global slot id; the processes' matrices tile the
        # whole one)
        lo = self.col0
        for g in range(lo, min(self._n_rows, lo + pos.shape[-1])):
            i = g - lo
            info = (self.id_info_fn(self._objs[g])
                    if g < len(self._objs) else str(g))
            row = [info]
            if self.trace_dv:
                row.append(int(freq[i]) if freq is not None
                           and i < len(freq) else 0)
            for ti in range(T):
                if alive[ti, i]:
                    row.append(np.array(pos[ti, :, i]))
                else:
                    row.extend([np.nan, np.nan, np.nan])
            rows.append(row)
        return rows

    def terminate(self, sim) -> None:
        self._data_override = None
        self._cached_rows = None
        self._ts = list(sim.ts)
        self._n_rows = max(sim._initial_count, getattr(sim, "_hwm", 0))
        self._objs = list(sim._pending_objects)
        if self._mesh is not None and self.out_fn is not None:
            # shard-local matrices: every process writes its span, to a
            # path of its own (the .pN files, joined row-wise, tile the
            # whole matrix)
            saved = self.out_fn
            try:
                self.out_fn = f"{saved}.p{self._mesh.rank}"
                super().terminate(sim)
            finally:
                self.out_fn = saved
            return
        super().terminate(sim)  # writes CSV (builds rows) only if out_fn set


# ---------------------------------------------------------------------------
# Population control: splitting and Russian roulette
# ---------------------------------------------------------------------------


class _SplitBase(Step):
    """Shared mechanics of particle splitting and Russian roulette.

    A split replaces one particle of weight ``w`` with ``n`` identical
    particles of weight ``w / n``: total weight is conserved exactly per
    event. Roulette is the inverse move: survive with probability ``q < 1``
    carrying ``w / q`` (unbiased in expectation). Copies take contiguous
    slots ``[n_spawned, n_spawned + k)``, as an emitter's photons do; where
    the arena is full, copies that do not fit are not made and the
    survivor keeps the larger share ``w / n_eff`` (total weight still
    exact). No offset is read to the host: the exclusive prefix sum, the
    capacity clip and the copies (each slot of the new window gathers from
    its source particle, one pass a plane, where the JAX package makes
    ``max_split - 1`` scatter passes with out-of-range writes dropped: the
    same result) all stay on the device.

    Subclasses give ``_ratios(state) -> (split_q, roul_q)``: ``split_q >=
    1`` the target copy count (its fraction realized by a Bernoulli draw,
    capped at ``max_split``) and ``roul_q < 1`` a survival probability.

    ``at="step"`` applies every iteration, on the generic tier (the fused
    prover refuses data-dependent growth as ``unsupported-step``);
    ``at="chunk"`` applies once per chunk boundary, between dispatches
    (:mod:`physicl_tpu_torch.population`), so the transport keeps the
    fused tier. The draws: one uniform per slot for the split, a second
    for the roulette (the JAX package's ``fold_in(key, 1)``).
    """

    needs_capacity_headroom = True  # copies need free slots, as emission
    n_per_step = 1  # headroom signal only: the growth is data-dependent

    def __init__(self, max_split: int = 8, roulette: bool = True,
                 at: str = "step"):
        self.max_split = int(max_split)
        self.roulette = bool(roulette)
        if self.max_split < 2:
            raise ValueError("max_split must be >= 2")
        if at not in ("step", "chunk"):
            raise ValueError(f"at must be 'step' or 'chunk', got {at!r}")
        self.at_boundary = (at == "chunk")

    def _ratios(self, state):
        raise NotImplementedError

    def boundary_apply(self, state, ctx):
        """One population-control pass at a chunk boundary."""
        return self.apply(state, ctx)

    def apply(self, state, ctx):
        split_q, roul_q = self._ratios(state)
        return self._apply_ratios(state, ctx, split_q, roul_q)

    def _apply_ratios(self, state, ctx, split_q, roul_q):
        dtype, dev = state.r.dtype, state.device
        C = state.capacity
        alive = state.alive
        split_q = torch.where(alive, torch.as_tensor(split_q, dtype=dtype,
                                                     device=dev), 1.0)
        # split: n = floor(q) + Bernoulli(frac(q)) copies, capped
        u = ctx.uniform((C,), dtype)
        n_i = torch.floor(split_q)
        n = (n_i.to(torch.int32)
             + (u < (split_q - n_i)).to(torch.int32))
        extra = torch.where(alive, n.clamp(1, self.max_split) - 1, 0)
        start = state.n_spawned.to(torch.int64)
        csum = torch.cumsum(extra, 0)
        off = start + csum - extra  # exclusive prefix sum
        # copies that fit the arena: clip(C - off, 0, extra)
        n_fit = torch.minimum((C - off).clamp(min=0), extra)
        n_eff = (1 + n_fit).to(dtype)
        w = state.w / n_eff
        if self.roulette:
            roul_q = torch.where(alive, torch.as_tensor(
                roul_q, dtype=dtype, device=dev), 1.0)
            do_r = roul_q < 1.0
            surv = ctx.uniform((C,), dtype) < roul_q
            alive = torch.where(do_r & ~surv, False, alive)
            w = torch.where(do_r & surv,
                            w / roul_q.clamp(min=torch.finfo(dtype).tiny), w)
        # copy j of particle i goes to slot off[i] + j (dropped at C and
        # beyond): the copies fill [start, start + total) in particle
        # order, so each slot of that window gathers from the particle
        # whose range [off, off + extra) holds it, one pass a plane
        total = extra.sum()
        end = off + extra  # non-decreasing
        slots = torch.arange(C, device=dev)
        win = (slots >= start) & (slots < torch.clamp(start + total, max=C))
        src = torch.searchsorted(end, slots, right=True).clamp(max=C - 1)

        def fill(x, val=None):
            return torch.where(win, x[..., src] if val is None else val, x)

        return state.replace(
            alive=fill(alive, True), w=fill(w), E=fill(state.E),
            otype=fill(state.otype),
            extras={k: fill(v) for k, v in state.extras.items()},
            n_spawned=torch.clamp(start + total, max=C).to(torch.int32),
            **{f: fill(getattr(state, f))
               for f in ("r", "dr", "v", "dv", "a")})


class ImportanceSplitStep(_SplitBase):
    """Geometric importance splitting (MCNP's): a particle that moved into
    higher importance splits, one that moved down plays Russian roulette.

    ``importance`` is a positive torch callable ``I(rx, ry, rz)`` over the
    position planes (e.g. ``lambda x, y, z: 2.0 ** torch.floor(x / 0.5)``
    doubles it every half unit of depth). Each iteration the ratio ``q =
    I(r) / I(r - dr)`` across the segment just flown gives the split
    (``q > 1``, capped at ``max_split``) or, with ``roulette=True``, the
    survival probability (``q < 1``).

    With ``at="chunk"`` the ratio is taken against each particle's position
    at the previous chunk boundary (a device-resident snapshot, primed from
    the initial positions and dropped whenever compaction moves slots), so
    the whole climb across the chunk counts.
    """

    def __init__(self, importance, max_split: int = 8,
                 roulette: bool = True, at: str = "step"):
        super().__init__(max_split=max_split, roulette=roulette, at=at)
        if not callable(importance):
            raise TypeError("importance must be a callable I(rx, ry, rz) "
                            "over position arrays")
        self.importance = importance
        self._prev_r = None  # at="chunk": positions at the last boundary

    def _q(self, state, r_prev):
        tiny = torch.finfo(state.r.dtype).tiny
        I1 = _field_value(self.importance,
                          self.importance(state.r[0], state.r[1],
                                          state.r[2]), "importance",
                          state.r[0])
        I0 = _field_value(self.importance,
                          self.importance(r_prev[0], r_prev[1], r_prev[2]),
                          "importance", state.r[0])
        q = I1 / I0.clamp(min=tiny)
        return q.clamp(min=1.0), q.clamp(min=tiny).clamp(max=1.0)

    def _ratios(self, state):
        return self._q(state, state.r - state.dr)

    def prime_snapshot(self, state) -> None:
        """Seed the ``at="chunk"`` snapshot from the initial positions."""
        if self.at_boundary and self._prev_r is None:
            self._prev_r = state.r

    def boundary_apply(self, state, ctx):
        if self._prev_r is None:
            # first boundary after a reset: snapshot only
            self._prev_r = state.r
            return state
        split_q, roul_q = self._q(state, self._prev_r)
        state = self._apply_ratios(state, ctx, split_q, roul_q)
        # copies inherit the source position, so the new r is the next
        # snapshot for originals and copies alike
        self._prev_r = state.r
        return state


class WeightWindowStep(_SplitBase):
    """Weight-window population control (MCNP's WWN): particles heavier
    than ``w_hi`` split toward ``w_target``, lighter than ``w_lo`` play
    Russian roulette up toward it (``w_target`` defaults to ``sqrt(w_lo *
    w_hi)``). Total weight is conserved exactly by splits and in
    expectation by roulette. ``at="chunk"`` enforces the window between
    fused dispatches."""

    def __init__(self, w_lo: float, w_hi: float, w_target=None,
                 max_split: int = 8, at: str = "step"):
        super().__init__(max_split=max_split, roulette=True, at=at)
        self.w_lo = float(raw_code_value(w_lo))
        self.w_hi = float(raw_code_value(w_hi))
        self.w_target = (float(raw_code_value(w_target))
                         if w_target is not None
                         else float(np.sqrt(self.w_lo * self.w_hi)))
        if not (0.0 < self.w_lo <= self.w_target <= self.w_hi):
            raise ValueError("need 0 < w_lo <= w_target <= w_hi "
                             f"(got {self.w_lo}, {self.w_target}, "
                             f"{self.w_hi})")

    def _ratios(self, state):
        w = state.w
        q = w / torch.tensor(self.w_target, dtype=w.dtype, device=w.device)
        split_q = torch.where(w > self.w_hi, q.clamp(min=1.0), 1.0)
        roul_q = torch.where(w < self.w_lo, q.clamp(max=1.0), 1.0)
        return split_q, roul_q
