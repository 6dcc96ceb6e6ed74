"""physicl_tpu_torch — the PyTorch/CUDA port of physicl_tpu.

The main path of the JAX package — bulk photons, ``UpdateTimeStep`` ->
``NewtonianKinematicsStep`` -> ``ScatterIsotropicStep`` (and plain
``ScatterDeleteStep``) -> ``ScatterSignMeasureStep``, driven as fused
multi-iteration chunks — on torch tensors. On a CUDA device each chunk is
one launch of the hand-written kernel ``csrc/fused_transport.cu``, built
with ``nvcc`` at the first CUDA dispatch (importing the package needs no
``nvcc``); on the CPU it is the kernel's plain PyTorch twin, which the
tests hold draw for draw against the JAX package. Later slices add the
Planck source, media, geometry and streams, the scatter family, charged
particles, polarized transport (:mod:`physicl_tpu_torch.polarization`)
and user code (``ElementwiseStep``, ``ReduceMeasureStep``,
:class:`physicl_tpu_torch.kernels.KernelStep`), recorded into programs that
each plan's form library compiles to straight-line code, as it compiles
the fields (C-expression strings and recorded torch callables). Where the fused prover refuses a plan, or with
``Simulation(fuse="off")``, the run goes to the generic step tier: every
step's ``apply`` as PyTorch tensor ops in an early-exit chunk loop. Runs
take mid-run ``add_obj`` / ``add_photons`` / ``remove_obj`` edits and
``spatial_sort``, checkpoint in the JAX package's format
(:mod:`physicl_tpu_torch.utils.checkpoint`), and profile through
:mod:`physicl_tpu_torch.utils.profiling`; ``KernelInput`` /
``KernelOutput`` / ``KernelProgram`` are the declarative kernel bridge. The
package imports ``torch`` and never ``jax``.
"""

from physicl_tpu_torch.units import (
    Measurement,
    MeasurementError,
    set_code_scale,
    reset_code_scale,
    raw_code_value,
)
from physicl_tpu_torch.engine import (
    Step,
    UpdateTimeStep,
    MeasureStep,
    Object,
    Simulation,
    IndexException,
    UntilT,
    ExtinctionExit,
    PlanReport,
    ParticleView,
    ElementwiseStep,
    ReduceMeasureStep,
    StepContext,
)
from physicl_tpu_torch.state import SimState
from physicl_tpu_torch.ops.fused import clear_kernel_cache

from physicl_tpu_torch import newton  # noqa: F401
from physicl_tpu_torch import light  # noqa: F401
from physicl_tpu_torch import polarization  # noqa: F401
from physicl_tpu_torch import kernels  # noqa: F401
from physicl_tpu_torch import utils  # noqa: F401
from physicl_tpu_torch import functional  # noqa: F401
from physicl_tpu_torch.kernels import (
    KernelInput,
    KernelOutput,
    KernelProgram,
)

__version__ = "0.1.0"

__all__ = [
    "Measurement",
    "MeasurementError",
    "set_code_scale",
    "reset_code_scale",
    "raw_code_value",
    "Step",
    "UpdateTimeStep",
    "MeasureStep",
    "Object",
    "Simulation",
    "IndexException",
    "UntilT",
    "ExtinctionExit",
    "PlanReport",
    "ParticleView",
    "ElementwiseStep",
    "ReduceMeasureStep",
    "StepContext",
    "SimState",
    "clear_kernel_cache",
    "newton",
    "light",
    "polarization",
    "kernels",
    "utils",
    "functional",
    "KernelInput",
    "KernelOutput",
    "KernelProgram",
]
