"""Steps (eval side in this slice)."""

from .steps import compute_losses, make_fused_eval_step

__all__ = ["compute_losses", "make_fused_eval_step"]
