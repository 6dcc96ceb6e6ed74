"""Newtonian kinematics and the boundaries (counterpart of
``physicl_tpu/newton.py``).

On the fused tier ``NewtonianKinematicsStep`` is the kernel's ``kin`` op
(``dr = v * dt; r += dr`` for every slot), ``AbsorbingBoundaryStep`` its
``absorb`` op, ``ReflectingBoundaryStep`` its ``reflect`` op,
``PeriodicBoundaryStep`` its ``periodic`` op and ``AbsorbingSphereStep``
its ``sabsorb`` op.
"""

from __future__ import annotations

import numpy as np

from physicl_tpu_torch.engine import Step
from physicl_tpu_torch.units import raw_code_value

__all__ = ["NewtonianKinematicsStep", "AbsorbingBoundaryStep",
           "ReflectingBoundaryStep", "PeriodicBoundaryStep",
           "AbsorbingSphereStep"]


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
