"""Checkpoints of parameter trees and of the flat DWFL buffer (the
reference's ``repro.checkpoint``, in its format)."""
from repro_torch.checkpoint.checkpoint import (restore, restore_flat,
                                               resume_carry, save, save_flat,
                                               trajectory_state)

__all__ = ["restore", "restore_flat", "resume_carry", "save", "save_flat",
           "trajectory_state"]
