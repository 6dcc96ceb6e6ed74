"""Differentiable runs: the step pipeline as a plain function.

Counterpart of ``physicl_tpu/functional.py``. ``scan_steps`` applies the
same ``Step.apply`` transforms as the engine's generic step tier, as a
``(state, seed) -> state`` function with no thread and no host loop over
chunks, so a run composes with torch autograd (``torch.autograd.grad``,
``.backward()``) and ``torch.func`` (``grad``, ``vmap`` over parameters)
like any other PyTorch code. Calling it again is the counterpart of a
``jax.jit``-compiled call: there is nothing to compile.

Differentiate smooth observables: implicit-capture weighted transport
(``ScatterDeleteStep(implicit_capture=True)`` without roulette decays the
weight deterministically as ``w *= 1 - min(pcoll, 1)``), positions and
velocities under deterministic dynamics (``LorentzForceStep``). Analog
kills and roulette are discrete events, whose derivatives are zero almost
everywhere.

Pass a step parameter as a tensor that requires grad (or that
``torch.func`` batches): the step constructors keep such a tensor in the
graph (:func:`physicl_tpu_torch.state.is_traced`) and fold any other value
to a host float. Example, fit an absorption cross-section to a measured
transmission::

    def transmission(A):
        steps = [UpdateTimeStep(lambda x: 1e-3),
                 newton.NewtonianKinematicsStep(),
                 light.ScatterDeleteStep(n=1.0, A=A, implicit_capture=True)]
        out = functional.scan_steps(steps, state0, n_iters=200)
        return (out.w * out.alive).sum() / n_photons

    A = torch.tensor(0.5, requires_grad=True)
    (g,) = torch.autograd.grad(transmission(A), A)   # exact dT/dA
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from physicl_tpu_torch.engine import Step, StepContext
from physicl_tpu_torch.state import SimState

__all__ = ["scan_steps", "FunctionalSim"]


class FunctionalSim:
    """Minimal stand-in for ``Simulation`` handed to ``Step.setup`` and
    user lambdas on the functional path: only the host attributes steps
    read (``bounds``, ``seed``)."""

    def __init__(self, bounds=None, seed: int = 0):
        self.bounds = np.zeros(3) if bounds is None else bounds
        self.seed = seed


def _generator(key, device: torch.device) -> torch.Generator:
    if isinstance(key, torch.Generator):
        if torch.device(key.device) != torch.device(device):
            raise ValueError(f"key is a generator on {key.device}; the "
                             f"state lies on {device}")
        return key
    return SimState.make_key(int(key), device)


def _iteration(steps, state, generator, shim):
    ctx = StepContext(generator, shim, state.device)
    for s in steps:
        state = s.apply(state, ctx)
    return state, ctx.records


def scan_steps(steps: List[Step], state, n_iters: int, key=None,
               sim: Optional[object] = None, record: bool = False,
               remat: bool = False):
    """Apply ``steps`` in list order (the reference's insertion order)
    ``n_iters`` times, in a plain Python loop that autograd and
    ``torch.func`` trace through.

    ``key``: an int seed or a ``torch.Generator`` on the state's device,
    the only source of the steps' draws (``StepContext.uniform``); the
    default is ``sim.seed``, else 0, so ``FunctionalSim(seed=7)`` seeds the
    run. ``sim``: a :class:`FunctionalSim` (or a ``Simulation``) for steps
    whose ``setup`` reads host attributes such as ``bounds``. With
    ``record=True`` returns ``(state, records)``, the per-iteration
    records stacked along a first axis and keyed ``"s{i}/{name}"`` in step
    order; otherwise the final state.

    A sharded state (:func:`physicl_tpu_torch.parallel.shard_state`) runs
    as the engine's generic tier runs it on a mesh (shard-local steps shard
    by shard, any other step on the gathered planes) and comes back
    sharded, its records combined across shards as the engine combines
    them. Each shard's generator is seeded with the mesh's per-shard rule
    from an int ``key``, or from one draw of a ``torch.Generator`` key, so
    that a generator advances from call to call on a mesh as on one
    device.

    ``remat=True`` wraps each iteration in ``torch.utils.checkpoint``: the
    backward pass keeps the state between iterations and recomputes each
    iteration's forward, which cuts the residuals from O(n_iters x
    intermediates) to O(n_iters x state). The checkpoint restores only the
    default generators, not the run's own, so each iteration starts from a
    snapshot of the run's generator that its recomputation replays: a
    remat gradient equals the plain one bitwise, draws included.

    ``torch.func.vmap`` maps over parameters (the ``A`` of a
    transmission). A run with draws needs ``vmap(..., randomness="same")``
    (every member draws what its own run with the same ``key`` draws) or
    ``"different"``; vmap does not map over ``key`` itself, so an ensemble
    over seeds is a loop over ``key`` (one run per seed) or one run with
    the ensemble folded into the particle axis.
    """
    from physicl_tpu_torch.parallel.sharding import (
        ShardedState,
        sharded_iteration,
        shard_state,
    )

    shim = sim if sim is not None else FunctionalSim()
    if key is None:
        key = int(getattr(shim, "seed", 0) or 0)
    for i, s in enumerate(steps):
        s._step_uid = f"s{i}"
        s.setup(shim)
    if isinstance(state, ShardedState):
        if isinstance(key, torch.Generator):
            # one draw of the generator's current state (it advances)
            key = torch.randint(0x7FFFFFFF, (), generator=key,
                                device=key.device)
        seed = int(key)
        # a fresh split: each shard gets its generator from the seed
        state = shard_state(state.gather(), state.mesh, seed=seed)

        def one(st, _gen):
            return sharded_iteration(
                steps, st, lambda g, dev: StepContext(g, shim, dev))
        gen = None
    else:
        gen = _generator(key, state.device)

        def one(st, g):
            return _iteration(steps, st, g, shim)

    rows = []
    for _ in range(int(n_iters)):
        if remat:
            state, recs = _remat_iteration(one, state, gen)
        else:
            state, recs = one(state, gen)
        if record:
            rows.append(recs)
    if not record:
        return state
    records = {k: torch.stack([torch.as_tensor(r[k]) for r in rows])
               for k in (rows[0] if rows else {})}
    return state, records


def _remat_iteration(one, state, gen: Optional[torch.Generator]):
    """One checkpointed iteration whose draws replay in the recompute: it
    draws from generators restored from the run's generators at the
    iteration's start (``gen``, or each shard's ``key`` of a sharded
    state; in the forward and again in the recomputation), and the run's
    generators then move past those draws, as an unchecked iteration
    leaves them."""
    from physicl_tpu_torch.parallel.sharding import ShardedState

    sharded = gen is None
    gens = [s.key for s in state.shards] if sharded else [gen]
    start = [g.get_state() for g in gens]
    end = []

    def rekey(st, keys):
        return ShardedState([s.replace(key=k) for s, k in zip(st.shards,
                                                               keys)],
                            st.mesh)

    def body(st):
        copies = []
        for g0, s0 in zip(gens, start):
            g = torch.Generator(device=g0.device)
            g.set_state(s0)
            copies.append(g)
        if sharded:
            out = one(rekey(st, copies), None)
        else:
            out = one(st, copies[0])
        if not end:  # the forward pass, not the recomputation
            end.extend(g.get_state() for g in copies)
        return out

    out, recs = checkpoint(body, state, use_reentrant=False,
                           preserve_rng_state=False)
    for g, s in zip(gens, end):
        g.set_state(s)
    return (rekey(out, gens) if sharded else out), recs
