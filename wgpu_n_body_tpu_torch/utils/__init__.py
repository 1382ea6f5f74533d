"""Host-side utilities: profiling, checkpointing."""

from wgpu_n_body_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from wgpu_n_body_tpu_torch.utils.profiling import StepTimer

__all__ = ["StepTimer", "save_checkpoint", "load_checkpoint"]
