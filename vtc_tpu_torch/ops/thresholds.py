"""Proximal / thresholding operators: counterpart of
vtc_tpu/ops/thresholds.py:18-59 (soft, nonneg-soft, hard, nonneg-hard,
the subspace solvers' ``group_shrink`` and ``select``).  ``t`` is
sparsity_weight * stepsize, a float or a 0-d tensor.
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


def group_shrink(grouped_codes, group_norms, t):
  """Block (group) soft threshold of the subspace solvers: every
  coefficient of a group scaled by max(1 - t/||g||_2, 0), with the
  ``norm == 0 -> 1`` divide-by-zero guard (vtc_tpu thresholds.py:38-52).

  Args:
    grouped_codes: (b, num_groups, max_group_size) packed group tensor.
    group_norms: (b, num_groups, 1) l2 norms over the last axis.
    t: scalar threshold = sparsity_weight * stepsize.
  """
  safe_norms = torch.where(group_norms == 0.0, 1.0, group_norms)
  scale = torch.clamp(1.0 - t / safe_norms, min=0.0)
  return grouped_codes * scale


def select(nonnegative_only: bool, hard: bool):
  """Return the thresholding callable for a (nonneg, hard) flag pair."""
  if hard:
    return hard_threshold_nonneg if nonnegative_only else hard_threshold
  return soft_threshold_nonneg if nonnegative_only else soft_threshold
