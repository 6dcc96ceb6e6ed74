"""Newtonian kinematics, charged particles and the boundaries (counterpart
of ``physicl_tpu/newton.py``).

On the fused tier ``NewtonianKinematicsStep`` is the kernel's ``kin`` op
(``dr = v * dt; r += dr`` for every slot), ``LorentzForceStep`` its
``lorentz`` op (the Boris push), ``AbsorbingBoundaryStep`` its ``absorb``
op, ``ReflectingBoundaryStep`` its ``reflect`` op, ``PeriodicBoundaryStep``
its ``periodic`` op and ``AbsorbingSphereStep`` its ``sabsorb`` op. Each
step's ``apply`` is the same physics as torch ops on the whole state, for
the generic step tier, in the JAX package's operation order.
"""

from __future__ import annotations

import numpy as np
import torch

from physicl_tpu_torch.engine import Object, Step
from physicl_tpu_torch.state import OBJ_GENERIC, OBJ_PHOTON, mod_floor
from physicl_tpu_torch.units import Measurement, raw_code_value

__all__ = ["NewtonianKinematicsStep", "AbsorbingBoundaryStep",
           "ReflectingBoundaryStep", "PeriodicBoundaryStep",
           "AbsorbingSphereStep", "ChargedObject", "LorentzForceStep",
           "generate_particle_state"]


def generate_particle_state(n, v=None, r=None, device=False, w=None) -> dict:
    """Bulk massive-particle population for ``Simulation.add_particles``:
    the generic-species counterpart of
    :func:`physicl_tpu_torch.light.generate_photon_state` (``E`` = 0,
    ``otype`` generic). ``v`` / ``r``: (3,) or (3, n) in code units,
    default zero; ``w``: scalar or (n,) weights. ``device=False`` builds
    float64 numpy arrays as the JAX package's host path does; a device
    (``True`` = the card) builds float32 tensors there."""
    from physicl_tpu_torch.light import generate_photon_state

    out = generate_photon_state(n, E=0.0, v=np.zeros(3) if v is None else v,
                                r=r, device=device, w=w)
    out["otype"] = OBJ_GENERIC
    return out


class NewtonianKinematicsStep(Step):
    """Euler position update: ``dr = v * dt; r += dr`` for every object.

    ``integrate_acceleration=True`` (the JAX package's semi-implicit
    extension: ``dv = a*dt; v += dv; dr = v*dt; r += dr``) runs on the
    generic tier (the fused prover refuses it: the packed state has no
    ``a`` plane)."""

    def __init__(self, integrate_acceleration: bool = False):
        self.integrate_acceleration = integrate_acceleration

    def apply(self, state, ctx):
        if self.integrate_acceleration:
            dv = state.a * state.dt
            v = state.v + dv
            dr = v * state.dt
            return state.replace(dv=dv, v=v, dr=dr, r=state.r + dr)
        dr = state.v * state.dt
        return state.replace(dr=dr, r=state.r + dr)


def _parse_bounds(bounds):
    """Accept the reference's ``sim.bounds`` 3-vector (box [0, b] per axis)
    or an explicit ((lo0,hi0),(lo1,hi1),(lo2,hi2)); returns host (lo, hi)
    float64 3-vectors."""
    b = np.asarray(raw_code_value(bounds), np.float64)
    if b.shape == (3,):
        return np.zeros(3), b
    if b.shape == (3, 2):
        return b[:, 0], b[:, 1]
    raise ValueError("bounds must be (3,) or (3, 2)")


def _static_bounds(step, sim):
    """Host-side ((lo, hi) per axis) floats for the fused-plan prover."""
    lo, hi = _parse_bounds(step.bounds if step.bounds is not None
                           else sim.bounds)
    return tuple((float(lo[d]), float(hi[d])) for d in range(3))


class _BoxStep(Step):
    """A step on the box ``bounds`` (``None``: ``sim.bounds``)."""

    def __init__(self, bounds=None):
        self.bounds = bounds
        self._sim_bounds = None

    def setup(self, sim) -> None:
        if self.bounds is None:
            self._sim_bounds = sim.bounds

    def _box(self, like):
        """``(lo, hi)`` as ``(3, 1)`` tensors of ``like``'s dtype."""
        lo, hi = _parse_bounds(self.bounds if self.bounds is not None
                               else self._sim_bounds)
        return (torch.tensor(lo, dtype=like.dtype,
                             device=like.device)[:, None],
                torch.tensor(hi, dtype=like.dtype,
                             device=like.device)[:, None])


class AbsorbingBoundaryStep(_BoxStep):
    """Deletes particles outside the box ``lo <= r <= hi`` (inclusive at
    both walls, every axis). ``bounds=None`` uses ``sim.bounds``."""

    def apply(self, state, ctx):
        lo, hi = self._box(state.r)
        inside = ((state.r >= lo) & (state.r <= hi)).all(dim=0)
        return state.replace(alive=state.alive & inside)


class ReflectingBoundaryStep(_BoxStep):
    """Specular reflection at the box walls: the position is folded back
    inside (a triangle wave, so an overshoot of any number of box widths in
    one dt folds correctly), the velocity component flips on an odd number
    of folds, and ``dr`` becomes the straight segment from the old to the
    folded position. ``bounds=None`` uses ``sim.bounds``."""

    def apply(self, state, ctx):
        lo, hi = self._box(state.r)
        # y in [0, 2L) is one reflection period; its descending half is a
        # position reflected an odd number of times
        L = hi - lo
        y = mod_floor(state.r - lo, 2 * L)
        odd = y > L
        r = lo + torch.where(odd, 2 * L - y, y)
        outside = (state.r > hi) | (state.r < lo)
        v = torch.where(outside & odd, -state.v, state.v)
        r = torch.where(outside, r, state.r)
        dr = r - (state.r - state.dr)
        return state.replace(r=r, dr=dr, v=v)


class PeriodicBoundaryStep(_BoxStep):
    """Periodic (wrap-around) box: a particle leaving through one face
    re-enters through the opposite one, velocity unchanged; ``r`` folds into
    ``[lo, hi)`` by ``state.mod_floor`` (any number of box lengths per dt).
    ``dr`` is left unchanged, so the segment ``[r - dr, r]`` is the
    translated image of the true path. ``bounds=None`` uses ``sim.bounds``.
    """

    def apply(self, state, ctx):
        lo, hi = self._box(state.r)
        return state.replace(r=lo + mod_floor(state.r - lo, hi - lo))


class AbsorbingSphereStep(Step):
    """Deletes particles outside (default) or inside a sphere: an escape
    sphere (``|r - center| > radius`` dies) or, with ``kill_inside=True``,
    a perfectly absorbing central body. Pair with
    :class:`physicl_tpu_torch.light.SphericalShellMeasureStep` just inside
    the kill radius to tally the escape flux."""

    def __init__(self, radius, center=(0.0, 0.0, 0.0),
                 kill_inside: bool = False):
        self.radius = float(raw_code_value(radius))
        if self.radius <= 0:
            raise ValueError(f"radius must be positive, got {self.radius}")
        self.center = tuple(
            float(x) for x in np.asarray(raw_code_value(center),
                                         np.float64).reshape(3))
        self.kill_inside = bool(kill_inside)

    def apply(self, state, ctx):
        c = torch.tensor(self.center, dtype=state.r.dtype,
                         device=state.device)[:, None]
        d = state.r - c
        inside = (d * d).sum(dim=0) <= torch.tensor(
            self.radius * self.radius, dtype=state.r.dtype,
            device=state.device)
        keep = ~inside if self.kill_inside else inside
        return state.replace(alive=state.alive & keep)


class ChargedObject(Object):
    """A charged massive particle: requires charge ``q`` and mass ``m``
    (Measurements or raw code-unit scalars), which land in
    ``state.extras["q"]`` and ``["m"]`` like any extra Object attribute;
    :class:`LorentzForceStep` with ``q_over_m=None`` reads them."""

    def __init__(self, **kwargs):
        if "q" not in kwargs or "m" not in kwargs:
            raise ValueError("ChargedObject requires q= and m=")
        if float(raw_code_value(kwargs["m"])) <= 0.0:
            raise ValueError("ChargedObject mass must be positive")
        super().__init__(**kwargs)


def _field_fn(field, name):
    """Normalise a field: a constant 3-vector (Measurement or raw) or a
    callable ``(rx, ry, rz) -> 3 arrays``; None is no field. Returns
    ``(callable over the position planes or None, the constant as a
    3-tuple or None)``: the prover folds a constant into the kernel's plan
    and refuses a callable."""
    if field is None:
        return None, None
    if callable(field):
        return field, None
    try:
        vec = np.asarray(raw_code_value(field), np.float64).reshape(3)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"{name} must be a 3-vector (Measurement or raw) or a callable "
            f"(rx, ry, rz) -> 3 arrays; got {field!r}") from e

    def const(rx, ry, rz):
        one = torch.ones_like(rx)
        return (vec[0] * one, vec[1] * one, vec[2] * one)

    return const, tuple(float(x) for x in vec)


class LorentzForceStep(Step):
    """Charged-particle dynamics in electromagnetic fields: the Boris push
    for ``F = q (E + v x B)``, a half E kick, the exact B rotation and a
    second half E kick, so a gyro-orbit keeps ``|v|`` to rounding:

    ``h = (q/m) dt / 2;  v- = v + h E``
    ``t = h B;  v' = v- + v- x t;  v+ = v- + v' x 2t/(1+|t|^2)``
    ``v_new = v+ + h E``

    ``E_field`` / ``B_field``: constant 3-vectors (Measurements or raw code
    units), or torch callables ``(rx, ry, rz) -> 3-tuple``, which the fused
    prover refuses (``field-fn-callable``) and the generic tier evaluates.
    ``q_over_m``: one charge-to-mass ratio for the species, or None to read
    per-particle ``q`` / ``m`` (:class:`ChargedObject`; without objects
    declaring them the fused prover refuses, ``lorentz-per-particle``, and
    the generic tier reads the ``q`` and ``m`` planes). Photons and dead
    particles are never pushed; ``dv`` records the step's velocity change
    and, on the generic tier, ``a`` the effective acceleration ``dv/dt``.
    Pair with :class:`NewtonianKinematicsStep` after this step. The dt is
    the one the step sees at its place relative to ``UpdateTimeStep``. On
    the fused tier ``state.a`` keeps its initial value (the packed state
    has no ``a`` plane)."""

    def __init__(self, E_field=None, B_field=None, q_over_m=None):
        self._e_fn, self._e_const = _field_fn(E_field, "E_field")
        self._b_fn, self._b_const = _field_fn(B_field, "B_field")
        if isinstance(q_over_m, Measurement):
            q_over_m = raw_code_value(q_over_m)
        self.q_over_m = None if q_over_m is None else float(q_over_m)

    def apply(self, state, ctx):
        from physicl_tpu_torch.light import _field_value

        dtype = state.v.dtype
        if self.q_over_m is not None:
            qm = torch.tensor(self.q_over_m, dtype=dtype,
                              device=state.device)
        else:
            if "q" not in state.extras or "m" not in state.extras:
                raise ValueError(
                    "LorentzForceStep(q_over_m=None) needs per-particle "
                    "charge/mass: add objects with q= and m= kwargs "
                    "(newton.ChargedObject) or pass q_over_m=")
            m = state.extras["m"]
            qm = torch.where(m != 0, state.extras["q"]
                             / torch.where(m != 0, m, torch.ones_like(m)),
                             0.0)
        push = state.alive & (state.otype != OBJ_PHOTON)
        h = 0.5 * qm * state.dt

        def field(fn, label):
            comps = fn(state.r[0], state.r[1], state.r[2])
            return torch.broadcast_tensors(*[
                _field_value(fn, x, label, state.r[0]) for x in comps])

        if self._e_fn is not None:
            ef = torch.stack(field(self._e_fn, "E_field"))
            v = state.v + h * ef
        else:
            v = state.v
        if self._b_fn is not None:
            tx, ty, tz = [x * h for x in field(self._b_fn, "B_field")]
            # v' = v- + v- x t
            vpx = v[0] + (v[1] * tz - v[2] * ty)
            vpy = v[1] + (v[2] * tx - v[0] * tz)
            vpz = v[2] + (v[0] * ty - v[1] * tx)
            s = 2.0 / (1.0 + tx * tx + ty * ty + tz * tz)
            # v+ = v- + v' x s*t
            v = torch.stack([
                v[0] + s * (vpy * tz - vpz * ty),
                v[1] + s * (vpz * tx - vpx * tz),
                v[2] + s * (vpx * ty - vpy * tx),
            ])
        if self._e_fn is not None:
            v = v + h * ef
        v_new = torch.where(push, v, state.v)
        dv = v_new - state.v
        nz = state.dt != 0
        inv_dt = torch.where(nz, 1.0 / torch.where(
            nz, state.dt, torch.ones_like(state.dt)), 0.0)
        return state.replace(v=v_new, dv=dv, a=dv * inv_dt)
