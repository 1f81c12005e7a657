"""Hand-written device kernels (with their plain-torch versions)."""
from soap3dp_tpu_torch.kernels.banded_dp import DPScores, dp_forward, dp_traceback

__all__ = ["DPScores", "dp_forward", "dp_traceback"]
