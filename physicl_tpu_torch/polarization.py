"""Polarized photon transport: Stokes-vector Rayleigh/Thomson and Compton
scatter.

Counterpart of ``physicl_tpu/polarization.py``. Each photon carries two
extra per-particle planes in ``SimState.extras``:

* ``"stokes"``: ``(3, C)`` normalized Stokes components ``(Q, U, V)`` with
  ``I = 1`` (intensity rides the statistical weight ``w``);
* ``"pol_ref"``: ``(3, C)`` unit vector perpendicular to ``v`` that defines
  the local frame: ``Q > 0`` is linear polarization along ``pol_ref``. The
  frame ``(e1, e2, d)`` is right-handed with ``e1 = pol_ref``, ``d =
  v/|v|``, ``e2 = d x e1``.

A scatter through polar angle theta (``c = cos theta``, ``s2 = sin^2
theta``) and azimuth phi (from ``e1`` toward ``e2``) applies the Fano phase
matrix in the scattering-plane frame, ``kappa = E/E' + E'/E`` (2 for
Rayleigh/Thomson, where it is the dipole Mueller matrix)::

    I' = (kappa - s2) -       s2  * Q_r        Q_r = Q cos2phi + U sin2phi
    Q' =         -s2  + (1 + c^2) * Q_r        U_r = U cos2phi - Q sin2phi
    U' =                   2 c    * U_r
    V' =               kappa c    * V

and renormalizes to ``I = 1``. theta comes from the unpolarized marginal
(the dipole's Cardano inverse CDF, or Klein-Nishina for Compton), phi |
theta from the exact conditional ``1 + a cos2phi + b sin2phi`` (``a = r
Q``, ``b = r U``, ``r = -s2 / (kappa - s2)``) by monotone bisection; no
weight changes.

The steps run on the fused tier: ops ``"pol"``, ``"polc"`` and
``"polmeas"`` of :mod:`physicl_tpu_torch.ops.fused`, whose CUDA kernel
keeps the six Stokes and frame rows as extras planes and writes them back
(``FusedPlan.extras_writeback``). Their ``apply`` is the generic step tier,
which is not ported: it raises, naming it. :func:`_bisect_phi` and
:func:`_apply_phase_matrix` are the generic tier's plain torch forms of the
azimuth inversion and the phase-matrix update, kept as references.
"""

from __future__ import annotations

import numpy as np
import torch

from physicl_tpu_torch.engine import MeasureStep, Step, _generic_missing
from physicl_tpu_torch.light import (ScatterIsotropicStep, _as_code,
                                     _compile_variable_n, _torch_device,
                                     generate_photon_state)
from physicl_tpu_torch.units import raw_code_value

__all__ = [
    "polarized_photon_state",
    "ScatterPolarizedRayleighStep",
    "ScatterPolarizedComptonStep",
    "StokesMeasureStep",
]

_MISSING_PLANES_MSG = (
    "population carries no Stokes planes: build it with "
    "physicl_tpu_torch.polarization.polarized_photon_state(...) (extras "
    "'stokes' (3,n) and 'pol_ref' (3,n)) instead of generate_photon_state"
)


def _xp(x):
    """The array module of ``x``: torch for a tensor, else numpy."""
    return torch if isinstance(x, torch.Tensor) else np


def _perp_candidate(d):
    """Elementwise unit vector never parallel to ``d``: z-hat where |dz| <
    0.9, else y-hat (numpy or torch components)."""
    xp = _xp(d[0])
    use_z = xp.abs(d[2]) < 0.9
    zero = xp.zeros_like(d[0])
    one = xp.ones_like(d[0])
    return (zero, xp.where(use_z, zero, one), xp.where(use_z, one, zero))


def _orthonormal_ref(d, ref, eps=1e-12):
    """``ref`` projected perpendicular to the unit direction ``d`` and
    normalized; returns ``(e1, norm before normalization)`` so that a
    caller can detect a degenerate (parallel or zero) reference."""
    dot = d[0] * ref[0] + d[1] * ref[1] + d[2] * ref[2]
    p = tuple(ref[i] - dot * d[i] for i in range(3))
    xp = _xp(p[0])
    n = xp.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2)
    safe = n.clamp_min(eps) if xp is torch else np.maximum(n, eps)
    return tuple(p[i] / safe for i in range(3)), n


def polarized_photon_state(n, E, v=None, r=None, w=None,
                           stokes=(0.0, 0.0, 0.0), pol_ref=None,
                           device=False) -> dict:
    """Bulk photon population carrying Stokes planes: the polarized
    counterpart of :func:`physicl_tpu_torch.light.generate_photon_state`
    (same core arguments and device path).

    ``stokes``: ``(3,)`` or ``(3, n)`` normalized ``(Q, U, V)`` (degree
    ``sqrt(Q^2+U^2+V^2) <= 1``; default unpolarized). ``pol_ref``: ``(3,)``
    or ``(3, n)`` reference direction for ``Q > 0``, projected
    perpendicular to each photon's ``v`` and normalized (an error if
    parallel). Default: z-hat where possible, y-hat for photons flying
    along z. ``device=False`` builds float64 numpy planes (and checks the
    degree and ``pol_ref``); ``device=True`` (the card) or a device name
    builds float32 tensors there without those host checks, as the JAX
    package's device path does.
    """
    bulk = generate_photon_state(n, E, v=v, r=r, device=device, w=w)
    n = int(n)
    on_dev = device is not False and device is not None
    if on_dev:
        dev = _torch_device(device)

        def arr(x):
            if isinstance(x, torch.Tensor):
                return x.to(device=dev, dtype=torch.float32)
            return torch.as_tensor(np.asarray(raw_code_value(x), np.float64),
                                   dtype=torch.float32, device=dev)

        vv = bulk["v"]
        inv = 1.0 / torch.sqrt(vv[0] ** 2 + vv[1] ** 2 + vv[2] ** 2)
    else:
        def arr(x):
            return np.asarray(raw_code_value(x), np.float64)

        vv = np.asarray(bulk["v"], np.float64)
        inv = 1.0 / np.sqrt(vv[0] ** 2 + vv[1] ** 2 + vv[2] ** 2)
    d = tuple(vv[i] * inv for i in range(3))

    st = arr(stokes).reshape(3, -1)
    st = st.expand(3, n) if on_dev else np.broadcast_to(st, (3, n))
    deg = st[0] ** 2 + st[1] ** 2 + st[2] ** 2
    if not on_dev and float(np.max(deg)) > 1.0 + 1e-6:
        raise ValueError(
            f"degree of polarization sqrt(Q^2+U^2+V^2) must be <= 1, got "
            f"max {float(np.max(deg)) ** 0.5:.6f}")

    if pol_ref is None:
        ref = _perp_candidate(d)
    else:
        pr = arr(pol_ref).reshape(3, -1)
        pr = pr.expand(3, n) if on_dev else np.broadcast_to(pr, (3, n))
        ref = (pr[0], pr[1], pr[2])
    e1, norm = _orthonormal_ref(d, ref)
    if pol_ref is not None and not on_dev and float(np.min(norm)) < 1e-6:
        raise ValueError(
            "pol_ref is (near-)parallel to v for at least one photon; the "
            "Q-axis must have a component perpendicular to the flight "
            "direction")
    bulk.setdefault("extras", {})
    if on_dev:
        bulk["extras"]["stokes"] = st.contiguous()
        bulk["extras"]["pol_ref"] = torch.stack(
            [torch.broadcast_to(x, (n,)) for x in e1])
    else:
        bulk["extras"]["stokes"] = np.asarray(st, np.float64)
        bulk["extras"]["pol_ref"] = np.stack(
            [np.broadcast_to(np.asarray(x, np.float64), (n,)) for x in e1])
    return bulk


def _bisect_phi(u, a, b, iters: int = 26):
    """Invert the conditional-azimuth CDF ``F(phi) = (phi + (a/2) sin2phi +
    (b/2)(1 - cos2phi)) / 2pi`` for ``F(phi) = u`` by monotone bisection on
    [0, 2pi] (26 halvings resolve phi to ~1e-7): the generic tier's form,
    with libm sines at every midpoint; ``phi = 2pi u`` where a = b = 0."""
    target = u * (2.0 * np.pi)
    lo = torch.zeros_like(u)
    hi = torch.full_like(u, 2.0 * np.pi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        f = mid + 0.5 * a * torch.sin(2.0 * mid) \
            + 0.5 * b * (1.0 - torch.cos(2.0 * mid))
        go_hi = f < target
        lo, hi = torch.where(go_hi, mid, lo), torch.where(go_hi, hi, mid)
    return 0.5 * (lo + hi)


def _apply_phase_matrix(v, stokes, pol_ref, scatter, cos_t, u_phi, kappa,
                        c_speed):
    """The generic tier's phase-matrix core on tensors: the frame
    re-orthonormalized against ``v`` (a fresh perpendicular where it is
    degenerate), phi | theta by :func:`_bisect_phi`, the Fano matrix, the
    renormalization to I = 1 with the over-purity clamp, and the rotated
    direction and frame. Returns ``(v_out, dv, stokes_out, pol_ref_out)``;
    the caller applies a Compton recoil."""
    inv_v = torch.rsqrt(torch.clamp_min((v * v).sum(0), 1e-30))
    d = tuple(v[i] * inv_v for i in range(3))
    e1, e1n = _orthonormal_ref(d, (pol_ref[0], pol_ref[1], pol_ref[2]),
                               eps=1e-20)
    fb, _ = _orthonormal_ref(d, _perp_candidate(d), eps=1e-20)
    degen = e1n < 1e-4
    e1 = tuple(torch.where(degen, fb[i], e1[i]) for i in range(3))
    e2 = (d[1] * e1[2] - d[2] * e1[1],
          d[2] * e1[0] - d[0] * e1[2],
          d[0] * e1[1] - d[1] * e1[0])

    q, u_st, v_st = stokes[0], stokes[1], stokes[2]
    c2 = cos_t * cos_t
    s2_ = 1.0 - c2
    r_t = -s2_ / (kappa - s2_)
    phi = _bisect_phi(u_phi, r_t * q, r_t * u_st)
    cos_p, sin_p = torch.cos(phi), torch.sin(phi)
    cos2p = cos_p * cos_p - sin_p * sin_p
    sin2p = 2.0 * sin_p * cos_p

    q_r = q * cos2p + u_st * sin2p
    u_r = u_st * cos2p - q * sin2p
    i_new = (kappa - s2_) - s2_ * q_r
    inv_i = 1.0 / torch.clamp_min(i_new, 1e-7)
    q_new = ((-s2_ + (1.0 + c2) * q_r) * inv_i).clamp(-1.0, 1.0)
    u_new = (2.0 * cos_t * u_r * inv_i).clamp(-1.0, 1.0)
    v_new = (kappa * cos_t * v_st * inv_i).clamp(-1.0, 1.0)
    pscale = torch.rsqrt(torch.clamp_min(q_new * q_new + u_new * u_new
                                         + v_new * v_new, 1.0))
    q_new, u_new, v_new = q_new * pscale, u_new * pscale, v_new * pscale

    sin_t = torch.sqrt(torch.clamp_min(s2_, 0.0))
    a_vec = tuple(cos_p * e1[i] + sin_p * e2[i] for i in range(3))
    d_new = tuple(cos_t * d[i] + sin_t * a_vec[i] for i in range(3))
    inv_dn = torch.rsqrt(torch.clamp_min(sum(x * x for x in d_new), 1e-30))
    v_new_vec = torch.stack([x * (c_speed * inv_dn) for x in d_new])
    e1_new = tuple(cos_t * a_vec[i] - sin_t * d[i] for i in range(3))
    inv_e1 = torch.rsqrt(torch.clamp_min(sum(x * x for x in e1_new), 1e-30))
    e1_new = torch.stack([x * inv_e1 for x in e1_new])

    v_out = torch.where(scatter, v_new_vec, v)
    dv = torch.where(scatter, v_new_vec - v, torch.zeros_like(v))
    st_out = torch.where(scatter, torch.stack([q_new, u_new, v_new]),
                         stokes)
    pr_out = torch.where(scatter, e1_new, torch.stack(e1))
    return v_out, dv, st_out, pr_out


# the roadmap item that ports the generic apply of the polarized steps
_POLARIZED_GENERIC = ("ROADMAP queue 1 item 4, next: the polarized steps' "
                      "generic apply")


def _check_planes(state, names=("stokes", "pol_ref")):
    if any(nm not in state.extras for nm in names):
        raise ValueError(_MISSING_PLANES_MSG)


class ScatterPolarizedRayleighStep(Step):
    """Rayleigh/Thomson scatter with the full Stokes phase matrix (the
    module docstring gives the formalism). The scalar family's collision
    model: ``pcoll = A * n(r) * |dr|`` with the inclusive ``>=`` test,
    optional ``wavelength_dep_scattering`` (lambda^-4) and ``variable_n`` /
    ``variable_n_fn``.

    A scattering photon gets its direction (the exact polarized angular
    distribution), ``dv = v_new - v_old``, the normalized Stokes vector and
    the frame ``pol_ref``, which every iteration re-orthonormalizes against
    the direction (scattering or not), so float32 drift never accumulates.
    Weights are untouched. Needs a population from
    :func:`polarized_photon_state` (the prover refuses others as
    ``polarization-planes``). Fused op ``"pol"``.
    """

    _ALLOWED = {"n", "A", "wavelength_dep_scattering", "variable_n",
                "variable_n_fn"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self._ALLOWED
        if unknown:
            raise ValueError(
                f"unknown option(s) {sorted(unknown)}; supported: "
                f"{sorted(self._ALLOWED)}")
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

    # pcoll folding is the scalar scatter family's
    setup = ScatterIsotropicStep.setup

    generic_missing = _POLARIZED_GENERIC

    def apply(self, state, ctx):
        _check_planes(state)
        _generic_missing(self)


class ScatterPolarizedComptonStep(Step):
    """Compton scatter off cold electrons with the full Stokes phase matrix
    (Fano 1949 / McMaster 1961): the Klein-Nishina angle (Kahn below alpha
    = 1 + sqrt(3), Koblinger above, at most ``kn_max_tries`` Kahn tries),
    then phi | theta from the exact conditional with ``kappa = eta +
    1/eta``, ``eta = E/E' = 1 + alpha (1 - cos theta)``, the Fano matrix
    and the recoil ``E' = E / eta``. In the Thomson limit it is
    :class:`ScatterPolarizedRayleighStep`'s dipole matrix.

    Options: ``A``, ``n`` / ``variable_n`` / ``variable_n_fn``, ``mec2``
    (the electron rest energy in code units; default m_e c^2),
    ``kn_max_tries``, ``kn_cross_section`` (pcoll *= sigma_KN(E) /
    sigma_T), ``measure_deposition`` (``data`` rows ``[t, sum w (E -
    E')]``; CSV through ``out_fn``). Thermal electrons are not supported
    (the scalar ``light.ScatterComptonStep(T_e=)`` has them). Fused op
    ``"polc"``; needs :func:`polarized_photon_state` planes.
    """

    _ALLOWED = {"n", "A", "variable_n", "variable_n_fn", "mec2",
                "kn_max_tries", "kn_cross_section", "measure_deposition",
                "out_fn"}

    def __init__(self, **kwargs):
        unknown = set(kwargs) - self._ALLOWED
        if unknown:
            raise ValueError(
                f"unknown option(s) {sorted(unknown)}; supported: "
                f"{sorted(self._ALLOWED)}")
        self.out_fn = kwargs.get("out_fn", None)
        self.n = _as_code(kwargs.get("n", 1))
        self.A = _as_code(kwargs.get("A", 1))
        self.wavelength_dep_scattering = False
        self.variable_n = kwargs.get("variable_n", False)
        self.variable_n_fn = kwargs.get("variable_n_fn", None)
        self._n_fn = (_compile_variable_n(self.variable_n_fn)
                      if self.variable_n else None)
        self.mec2 = kwargs.get("mec2", None)
        self.kn_max_tries = int(kwargs.get("kn_max_tries", 12))
        self.kn_cross_section = bool(kwargs.get("kn_cross_section", False))
        self.measure_deposition = bool(kwargs.get("measure_deposition",
                                                  False))
        self.data = []
        self._c = None
        self._coef = None
        self._wl_base = None
        self._inv_mec2 = None

    def setup(self, sim) -> None:
        ScatterIsotropicStep.setup(self, sim)
        # read at set-up: light.refresh_constants() rebinds c and m_e on a
        # code-scale change
        from physicl_tpu_torch.light import c as _c, m_e

        mec2 = (_as_code(self.mec2) if self.mec2 is not None
                else float(raw_code_value(m_e))
                * float(raw_code_value(_c)) ** 2)
        if mec2 <= 0:
            raise ValueError("mec2 must be positive")
        self._inv_mec2 = 1.0 / float(mec2)

    generic_missing = _POLARIZED_GENERIC

    def apply(self, state, ctx):
        _check_planes(state)
        _generic_missing(self)

    def collect(self, sim, records) -> None:
        if not self.measure_deposition:
            return
        for i in range(len(records["t"])):
            self.data.append([float(records["t"][i]),
                              float(records["dep"][i])])

    terminate = MeasureStep.terminate


class StokesMeasureStep(MeasureStep):
    """Per-iteration polarization summary over alive particles: the mean
    degree of polarization ``<sqrt(Q^2+U^2+V^2)>`` and the mean circular
    polarization ``<V>`` (both invariant under each photon's frame
    rotation), and with ``local_qu=True`` the local-frame ``<Q>``, ``<U>``
    (meaningful only while the frames are aligned, e.g. an unscattered
    beam).

    ``data`` rows are ``[t(, n), p_mean, V_mean(, Q_mean, U_mean)]``; CSV
    through ``out_fn``. ``weighted=True`` weights every mean by ``w``.
    Fused op ``"polmeas"``: the kernel sums the weight, p, V (and Q, U)
    into float record columns and the host divides by the weight sum.
    """

    def __init__(self, out_fn=None, measure_n: bool = True,
                 weighted: bool = False, local_qu: bool = True):
        super().__init__(out_fn)
        self.measure_n = measure_n
        self.weighted = bool(weighted)
        self.local_qu = bool(local_qu)

    generic_missing = _POLARIZED_GENERIC

    def apply(self, state, ctx):
        _check_planes(state, ("stokes",))
        _generic_missing(self)

    def collect(self, sim, records) -> None:
        for i in range(len(records["t"])):
            row = [records["t"][i]]
            if self.measure_n:
                row.append(records["n"][i])
            row.extend([records["p_mean"][i], records["V_mean"][i]])
            if self.local_qu:
                row.extend([records["Q_mean"][i], records["U_mean"][i]])
            self.data.append(np.array(row))
