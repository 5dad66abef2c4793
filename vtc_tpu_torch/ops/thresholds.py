"""Proximal / thresholding operators: counterpart of
vtc_tpu/ops/thresholds.py:18-59 (soft, nonneg-soft, hard, nonneg-hard and
``select``).  ``t`` is sparsity_weight * stepsize, a float or a 0-d
tensor.  ``group_shrink`` waits for the subspace slice (ROADMAP.md §1).
"""
import torch


def soft_threshold(x, t):
  """Soft threshold: sign(x) * max(|x| - t, 0)."""
  return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def soft_threshold_nonneg(x, t):
  """Shifted rectified-linear: max(x - t, 0)."""
  return torch.clamp(x - t, min=0.0)


def hard_threshold(x, t):
  """Zero where |x| < t, identity elsewhere."""
  return torch.where(torch.abs(x) < t, 0.0, x)


def hard_threshold_nonneg(x, t):
  """Zero where x < t, identity elsewhere (kills all negatives)."""
  return torch.where(x < t, 0.0, x)


def select(nonnegative_only: bool, hard: bool):
  """Return the thresholding callable for a (nonneg, hard) flag pair."""
  if hard:
    return hard_threshold_nonneg if nonnegative_only else hard_threshold
  return soft_threshold_nonneg if nonnegative_only else soft_threshold
