"""Runtime utilities: checkpoints (:mod:`.checkpoint`), profiling
(:mod:`.profiling`) and the CSV writer (:mod:`.io`)."""

from physicl_tpu_torch.utils import checkpoint, profiling  # noqa: F401
from physicl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint", "profiling"]
