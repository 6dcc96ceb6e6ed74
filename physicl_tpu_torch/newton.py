"""Newtonian kinematics, charged particles and the boundaries (counterpart
of ``physicl_tpu/newton.py``).

On the fused tier ``NewtonianKinematicsStep`` is the kernel's ``kin`` op
(``dr = v * dt; r += dr`` for every slot), ``LorentzForceStep`` its
``lorentz`` op (the Boris push), ``AbsorbingBoundaryStep`` its ``absorb``
op, ``ReflectingBoundaryStep`` its ``reflect`` op, ``PeriodicBoundaryStep``
its ``periodic`` op and ``AbsorbingSphereStep`` its ``sabsorb`` op.
"""

from __future__ import annotations

import numpy as np
import torch

from physicl_tpu_torch.engine import Object, Step
from physicl_tpu_torch.state import OBJ_GENERIC
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
    extension) is accepted and refused by the fused prover."""

    def __init__(self, integrate_acceleration: bool = False):
        self.integrate_acceleration = integrate_acceleration


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


class AbsorbingBoundaryStep(_BoxStep):
    """Deletes particles outside the box ``lo <= r <= hi`` (inclusive at
    both walls, every axis). ``bounds=None`` uses ``sim.bounds``."""


class ReflectingBoundaryStep(_BoxStep):
    """Specular reflection at the box walls: the position is folded back
    inside (a triangle wave, so an overshoot of any number of box widths in
    one dt folds correctly), the velocity component flips on an odd number
    of folds, and ``dr`` becomes the straight segment from the old to the
    folded position. ``bounds=None`` uses ``sim.bounds``."""


class PeriodicBoundaryStep(_BoxStep):
    """Periodic (wrap-around) box: a particle leaving through one face
    re-enters through the opposite one, velocity unchanged; ``r`` folds into
    ``[lo, hi)`` by ``state.mod_floor`` (any number of box lengths per dt).
    ``dr`` is left unchanged, so the segment ``[r - dr, r]`` is the
    translated image of the true path. ``bounds=None`` uses ``sim.bounds``.
    """


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
    units); a callable ``(rx, ry, rz) -> 3-tuple`` is accepted and refused
    by the fused prover (``field-fn-callable``: a Python callable cannot be
    inlined into the kernel). ``q_over_m``: one charge-to-mass ratio for
    the species, or None to read per-particle ``q`` / ``m``
    (:class:`ChargedObject`). Photons and dead particles are never pushed;
    ``dv`` records the step's velocity change. Pair with
    :class:`NewtonianKinematicsStep` after this step. The dt is the one the
    step sees at its place relative to ``UpdateTimeStep``. On the fused tier
    ``state.a`` keeps its initial value (the packed state has no ``a``
    plane)."""

    def __init__(self, E_field=None, B_field=None, q_over_m=None):
        self._e_fn, self._e_const = _field_fn(E_field, "E_field")
        self._b_fn, self._b_const = _field_fn(B_field, "B_field")
        if isinstance(q_over_m, Measurement):
            q_over_m = raw_code_value(q_over_m)
        self.q_over_m = None if q_over_m is None else float(q_over_m)

    def apply(self, state, ctx):
        raise NotImplementedError("LorentzForceStep.apply is the generic "
                                  "step tier, which is not ported; the "
                                  "fused tier pushes in-kernel")
