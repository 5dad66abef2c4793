"""The within-group anti-alignment regularization gradient of the subspace
update rules: counterpart of vtc_tpu/dict_update_rules/fully_connected/
_subspace_common.py:30-66.

The penalty is the sum of unsigned pairwise cosine similarities of the
dictionary elements within each group; its gradient with respect to
element i of a group is

  sum_j sign(cos_ij) * (phi_j / (||phi_i|| ||phi_j||)
                        - cos_ij * phi_i / ||phi_i||^2)

which reduces, for unit-norm dictionaries, to
``sum_j sign(cos_ij) * (phi_j - cos_ij phi_i)``.  An element in several
groups accumulates a contribution from each.  The groups run batched over
the packed (G, M) layout of ``subspace_ista_fista.pack_group_indices``;
padded slots have zero rows, hence zero cosines and sign 0, and add
nothing (their norms are guarded to 1).  The sum back to (s, n) is
``unpack_codes_summed``'s fixed-order gather-sum.
"""
import torch

from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista)
from vtc_tpu_torch.ops.precision import matmul_precision


def alignment_regularization_gradients(dictionary, gather_inds, valid_mask,
                                       dict_is_normalized: bool):
  """Accumulated anti-alignment gradients, shape (s, n).

  Args:
    dictionary: (s, n).
    gather_inds: (G, M) group membership indices (0 where padded).
    valid_mask: (G, M) 1/0 validity mask.
    dict_is_normalized: use the simplified unit-norm expression.
  """
  code_size, n = dictionary.shape
  mask = valid_mask.to(dictionary.dtype)
  with matmul_precision():
    dg = dictionary[gather_inds] * mask[:, :, None]        # (G, M, n)
    inner = dg @ dg.transpose(1, 2)                        # (G, M, M)
    if dict_is_normalized:
      cos = inner
      axis0 = cos[..., None] * dg[:, :, None, :]           # cos_ij phi_i
      axis1 = dg[:, None, :, :].expand_as(axis0)           # phi_j
    else:
      norms = torch.linalg.vector_norm(dg, dim=2, keepdim=True)
      norms = torch.where(mask[:, :, None] > 0, norms, 1.0)
      norm_outer = norms @ norms.transpose(1, 2)
      cos = inner / norm_outer
      axis0 = (cos / norms**2)[..., None] * dg[:, :, None, :]
      axis1 = dg[:, None, :, :] / norm_outer[..., None]
    grads = torch.sign(cos)[..., None] * (axis1 - axis0)
    group_grads = grads.sum(dim=2) * mask[:, :, None]      # (G, M, n)
  # the members' rows summed back to (s, n): the codes' fixed-order sum,
  # with the n columns in the batch place
  flat = group_grads.reshape(-1, n).T
  return subspace_ista_fista.unpack_codes_summed(
      flat, gather_inds, valid_mask, code_size).T
