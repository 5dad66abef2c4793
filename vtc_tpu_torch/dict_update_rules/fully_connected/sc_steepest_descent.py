"""Steepest-descent dictionary update, fully-connected: counterpart of
vtc_tpu/dict_update_rules/fully_connected/sc_steepest_descent.py:19-60.

  D <- D - eta * codes^T (codes D - X) / b,  then row-renormalize

repeated ``num_iters`` times, in the inputs' own float type, under the
precision pins.  Pure: returns the new dictionary.  ``_update`` is also
the steepest half of the fused train step's plain version
(ops/fused_train_step.fused_train_segment_plain), which passes
``norm_floor`` (the fused kernels' floored renorm).
"""
import torch

from vtc_tpu_torch.ops.precision import matmul_precision


def renormalize_rows(dictionary, norm_floor=False):
  """Rows to unit l2.  ``norm_floor`` divides by max(|row|, 1e-30), as
  vtc_tpu's fused kernels do (pallas_train_step.py:530), so a zero row
  stays zero; its per-batch rules divide by the norm itself."""
  norms = torch.linalg.vector_norm(dictionary, dim=1, keepdim=True)
  if norm_floor:
    norms = torch.clamp(norms, min=1e-30)
  return dictionary / norms


def _update(images, dictionary, codes, stepsize, num_iters,
            normalize_dictionary, precision=None, norm_floor=False):
  batch = codes.shape[0]
  d = dictionary
  with matmul_precision(precision):
    for _ in range(int(num_iters)):
      grad = codes.T @ (codes @ d - images) / batch
      d = d - stepsize * grad
      if normalize_dictionary:
        d = renormalize_rows(d, norm_floor)
  return d


def run(images, dictionary, codes, stepsize=0.001, num_iters=1,
        normalize_dictionary=True):
  """One or more steepest-descent steps on the dictionary.

  Args:
    images: (b, n) batch of flattened patches.
    dictionary: (s, n) current dictionary; the update runs on its device.
    codes: (b, s) codes inferred for this batch.
    stepsize: learning rate eta.
    num_iters: number of descent steps.
    normalize_dictionary: renormalize rows to unit l2 after each step.

  Returns:
    (s, n) float32 updated dictionary.
  """
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device
  return _update(
      torch.as_tensor(images, dtype=torch.float32, device=device),
      dictionary, torch.as_tensor(codes, dtype=torch.float32, device=device),
      float(stepsize), int(num_iters), bool(normalize_dictionary))
