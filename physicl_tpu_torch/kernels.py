"""Custom physics as a ``SimState -> SimState`` map: the port's counterpart
of ``physicl_tpu/kernels.py``'s :class:`KernelStep`.

``KernelStep(fn, elementwise=True)`` keeps the fused tier: the prover
records ``fn`` once over the kernel's facade state
(:func:`physicl_tpu_torch.ops.record.record_kernelstep`) into a program the
transport kernel runs for every particle. Without ``elementwise=True``, or
with ``record_fn``, the prover refuses it (codes ``unsupported-step`` and
``kernelstep-records``) and the step runs on the generic step tier, which
calls ``fn`` on the whole state. The declarative ``KernelInput`` /
``KernelOutput`` / ``KernelProgram`` bridge is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from physicl_tpu_torch.engine import Step
from physicl_tpu_torch.state import SimState

__all__ = ["KernelStep"]


class KernelStep(Step):
    """Embed a custom per-particle map in the simulation loop.

    ``fn(state, ctx) -> state``. ``elementwise=True`` is the user's
    contract that ``fn`` is a pure per-particle map, which lets the prover
    record it into the fused kernel:

    * no reductions, gathers or cross-particle mixing;
    * only the packed transport fields ``r, dr, v, dv, E, w`` and ``alive``
      (which can only clear); ``state.a`` and ``state.extras`` are refused
      (``kernelstep-state``; use :class:`physicl_tpu_torch.engine.
      ElementwiseStep` with ``extras=`` for extras planes), as are writes to
      them or to ``t``, ``dt``, ``n_spawned``, ``t_comp``
      (``kernelstep-ignored-write``);
    * no ``ctx`` (``kernelstep-ctx``: randomness needs ElementwiseStep's
      ``p.uniform()``, measurement ReduceMeasureStep), and no
      ``record_fn`` (``kernelstep-records``).

    ``state.otype`` reads each particle's species (on a mixed population,
    the packed otype plane). On the generic tier ``fn`` gets the whole
    :class:`~physicl_tpu_torch.state.SimState` and the
    :class:`~physicl_tpu_torch.engine.StepContext` (draws through
    ``ctx.uniform``); ``record_fn(state) -> {name: value}`` adds record
    channels, collected into ``data`` as one dict per iteration. Example,
    an exponential drag::

        def drag(state, ctx):
            return state.replace(v=state.v * (1.0 - 1e-7))

        sim.add_step(3, KernelStep(drag, elementwise=True))
    """

    def __init__(self, fn: Callable[[SimState, object], SimState],
                 record_fn: Optional[Callable[[SimState], Dict]] = None,
                 elementwise: bool = False):
        super().__init__()
        self.fn = fn
        self.record_fn = record_fn
        self.elementwise = bool(elementwise)
        self.data: List = []

    def apply(self, state, ctx):
        prev_alive = state.alive
        state = self.fn(state, ctx)
        if self.elementwise:
            # alive only clears, as in the kernel
            state = state.replace(alive=prev_alive & state.alive)
        if self.record_fn is not None:
            for k, v in self.record_fn(state).items():
                ctx.record(self, k, v)
        return state

    def collect(self, sim, records):
        n = len(next(iter(records.values()))) if records else 0
        for i in range(n):
            self.data.append({k: v[i] for k, v in records.items()})
