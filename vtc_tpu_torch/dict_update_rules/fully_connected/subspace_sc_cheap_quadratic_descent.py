"""Subspace cheap-quadratic dictionary update, fully-connected:
counterpart of vtc_tpu/dict_update_rules/fully_connected/
subspace_sc_cheap_quadratic_descent.py:23-72.

The cheap-quadratic step plus the within-group anti-alignment
regularizer weighted by ``alignment_penalty``; with a penalty of 0 it is
the fc rule.  Pure: returns the new dictionary.
"""
import torch

from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_cheap_quadratic_descent, sc_steepest_descent)
from vtc_tpu_torch.dict_update_rules.fully_connected._subspace_common import (
    alignment_regularization_gradients)
from vtc_tpu_torch.ops.precision import matmul_precision


def _update_with_reg(images, dictionary, codes, gather_inds, valid_mask,
                     hessian_diagonal, alignment_penalty, stepsize,
                     num_iters, lowest_code_val, normalize_dictionary,
                     precision=None, norm_floor=False):
  batch = codes.shape[0]
  scale = (hessian_diagonal + lowest_code_val)[:, None]
  d = dictionary
  with matmul_precision(precision):
    for _ in range(int(num_iters)):
      reg = alignment_regularization_gradients(
          d, gather_inds, valid_mask, normalize_dictionary)
      grad = (codes.T @ (codes @ d - images) / batch
              + alignment_penalty * reg)
      d = d - stepsize * grad / scale
      if normalize_dictionary:
        d = sc_steepest_descent.renormalize_rows(d, norm_floor)
  return d


def run(images, dictionary, codes, group_assignments, hessian_diagonal,
        alignment_penalty, stepsize=0.001, num_iters=1,
        lowest_code_val=0.001, normalize_dictionary=True):
  """Cheap-quadratic descent with the within-group anti-alignment penalty.

  Args mirror vtc_tpu's ``run``; ``group_assignments`` is a list of index
  lists (groups may overlap).

  Returns:
    (s, n) float32 updated dictionary on the dictionary's device.
  """
  if alignment_penalty == 0:
    return sc_cheap_quadratic_descent.run(
        images, dictionary, codes, hessian_diagonal, stepsize, num_iters,
        lowest_code_val, normalize_dictionary)
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device

  def as_f32(x):
    return torch.as_tensor(x, dtype=torch.float32, device=device)

  gather_inds, valid_mask, _ = subspace_ista_fista.group_layout(
      group_assignments, dictionary.shape[0], device)
  return _update_with_reg(
      as_f32(images), dictionary, as_f32(codes), gather_inds, valid_mask,
      as_f32(hessian_diagonal), float(alignment_penalty), float(stepsize),
      int(num_iters), float(lowest_code_val), bool(normalize_dictionary))
