"""Subspace steepest-descent dictionary update, fully-connected:
counterpart of vtc_tpu/dict_update_rules/fully_connected/
subspace_sc_steepest_descent.py:24-64.

Plain steepest descent on the reconstruction error plus the within-group
anti-alignment regularizer weighted by ``alignment_penalty``; with a
penalty of 0 it is the fc rule.  Pure: returns the new dictionary.
"""
import torch

from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_steepest_descent)
from vtc_tpu_torch.dict_update_rules.fully_connected._subspace_common import (
    alignment_regularization_gradients)
from vtc_tpu_torch.ops.precision import matmul_precision


def _update_with_reg(images, dictionary, codes, gather_inds, valid_mask,
                     alignment_penalty, stepsize, num_iters,
                     normalize_dictionary, precision=None, norm_floor=False):
  batch = codes.shape[0]
  d = dictionary
  with matmul_precision(precision):
    for _ in range(int(num_iters)):
      reg = alignment_regularization_gradients(
          d, gather_inds, valid_mask, normalize_dictionary)
      grad = (codes.T @ (codes @ d - images) / batch
              + alignment_penalty * reg)
      d = d - stepsize * grad
      if normalize_dictionary:
        d = sc_steepest_descent.renormalize_rows(d, norm_floor)
  return d


def run(images, dictionary, codes, group_assignments, alignment_penalty,
        stepsize=0.001, num_iters=1, normalize_dictionary=True):
  """Steepest descent with the within-group anti-alignment penalty.

  Returns:
    (s, n) float32 updated dictionary on the dictionary's device.
  """
  if alignment_penalty == 0:
    return sc_steepest_descent.run(images, dictionary, codes, stepsize,
                                   num_iters, normalize_dictionary)
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device
  gather_inds, valid_mask, _ = subspace_ista_fista.group_layout(
      group_assignments, dictionary.shape[0], device)
  return _update_with_reg(
      torch.as_tensor(images, dtype=torch.float32, device=device),
      dictionary, torch.as_tensor(codes, dtype=torch.float32, device=device),
      gather_inds, valid_mask, float(alignment_penalty), float(stepsize),
      int(num_iters), bool(normalize_dictionary))
