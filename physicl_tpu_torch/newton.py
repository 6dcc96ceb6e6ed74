"""Newtonian kinematics and the absorbing box (counterpart of
``physicl_tpu/newton.py``).

On the fused tier ``NewtonianKinematicsStep`` is the kernel's ``kin`` op
(``dr = v * dt; r += dr`` for every slot) and ``AbsorbingBoundaryStep`` its
``absorb`` op.
"""

from __future__ import annotations

import numpy as np

from physicl_tpu_torch.engine import Step
from physicl_tpu_torch.units import raw_code_value

__all__ = ["NewtonianKinematicsStep", "AbsorbingBoundaryStep"]


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


class AbsorbingBoundaryStep(Step):
    """Deletes particles outside the box ``lo <= r <= hi`` (inclusive at
    both walls, every axis). ``bounds=None`` uses ``sim.bounds``."""

    def __init__(self, bounds=None):
        self.bounds = bounds
        self._sim_bounds = None

    def setup(self, sim) -> None:
        if self.bounds is None:
            self._sim_bounds = sim.bounds
