"""Hessian-diagonal-scaled ("cheap quadratic") dictionary update, fc:
counterpart of vtc_tpu/dict_update_rules/fully_connected/
sc_cheap_quadratic_descent.py:20-61.

The steepest-descent gradient is divided per dictionary row by
``hessian_diagonal + lowest_code_val`` before the step.  The trainer keeps
the Hessian-diagonal EMA with ``hessian_diagonal_ema``.  Pure: returns the
new dictionary.  ``_update`` and ``hessian_diagonal_ema`` are also the
cheap-quadratic half of the fused train step's plain version
(ops/fused_train_step.fused_train_segment_plain).
"""
import torch

from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_steepest_descent)
from vtc_tpu_torch.ops.precision import matmul_precision


def _update(images, dictionary, codes, hessian_diagonal, stepsize,
            num_iters, lowest_code_val, normalize_dictionary,
            precision=None, norm_floor=False):
  batch = codes.shape[0]
  scale = (hessian_diagonal + lowest_code_val)[:, None]
  d = dictionary
  with matmul_precision(precision):
    for _ in range(int(num_iters)):
      grad = codes.T @ (codes @ d - images) / batch
      d = d - stepsize * grad / scale
      if normalize_dictionary:
        d = sc_steepest_descent.renormalize_rows(d, norm_floor)
  return d


def run(images, dictionary, codes, hessian_diagonal, stepsize=0.001,
        num_iters=1, lowest_code_val=0.001, normalize_dictionary=True):
  """Approximate quadratic descent steps on the dictionary.

  Args:
    images: (b, n); dictionary: (s, n); codes: (b, s).
    hessian_diagonal: (s,) EMA estimate of the code second moments.
    stepsize, num_iters, lowest_code_val, normalize_dictionary: as in
      vtc_tpu's ``run``.

  Returns:
    (s, n) float32 updated dictionary on the dictionary's device.
  """
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device

  def as_f32(x):
    return torch.as_tensor(x, dtype=torch.float32, device=device)

  return _update(as_f32(images), dictionary, as_f32(codes),
                 as_f32(hessian_diagonal), float(stepsize), int(num_iters),
                 float(lowest_code_val), bool(normalize_dictionary))


def hessian_diagonal_ema(hessian_diagonal, codes):
  """Trainer-side EMA: h <- 0.99 h + mean(codes^2, axis=0) / 100
  (vtc_tpu sc_cheap_quadratic_descent.py:58-61)."""
  return 0.99 * hessian_diagonal + torch.mean(codes ** 2, dim=0) / 100.0
