"""Subspace (group) ISTA / FISTA sparse inference: counterpart of
vtc_tpu/analysis_transforms/fully_connected/subspace_ista_fista.py:36-227.

Group LASSO with ragged groups that may overlap.  The groups are packed
into a zero-padded (b, G, M) code tensor (G groups, M the largest group)
against a grouped dictionary (G*M, n) that repeats each member's row and
holds zero rows for the padding; the group prox shrinks each group's
norm; the duplicated memberships are summed back into (b, s) codes.

* ``pack_group_indices`` gives the (G, M) gather indices and validity
  mask, as in vtc_tpu; ``unpack_index`` gives the inverse, the (s, R)
  slots each code sums (R its largest membership count).
* ``unpack_codes_summed`` is deterministic on every device: a gather-sum
  over the slots of each code in ascending slot order, the order of
  vtc_tpu's ``segment_sum``; no atomics.
* Formulations as in JAX: 'gram' (G = Dg Dg^T and c = X Dg^T once, the
  stepsize folded in: ``ops/fused_group_fista.fused_group_fista_plain``,
  the kernel's plain version), 'direct' (two products per iteration) and
  'pallas', which keeps its JAX spelling and selects the hand-written
  CUDA kernel K4 (``ops/fused_group_fista``; the plain version for CPU
  tensors).  With ``early_stopping_epsilon`` K4 runs the batch-global
  stop test on the device at every batch size, where vtc_tpu's kernel
  takes it only when the batch fits one VMEM tile and runs the XLA loop
  otherwise: the same rule, so the same codes.

``mxu_precision`` is the 'pallas' formulation's tier, as in
``ista_fista.run`` (K4's ``mxu``; a tier with a stop on a batch outside
vtc_tpu's tile, ``group_early_stop_tile_fits``, runs at full precision).
"""
import functools
from typing import Optional

import numpy as np
import torch

from vtc_tpu_torch.ops import fused_group_fista
from vtc_tpu_torch.ops import lipschitz as lipschitz_ops
from vtc_tpu_torch.ops.precision import matmul_precision, resolve_tier
from vtc_tpu_torch.ops.solver import proximal_gradient_loop


def pack_group_indices(group_assignments, code_size: int):
  """Index arrays describing a ragged group structure.

  Returns:
    gather_inds: (G, M) int64, index into the s axis (0 where padded).
    valid_mask:  (G, M) float32, 1.0 for real members, 0.0 for padding.
  with G = len(group_assignments), M = max group size, on the CPU.
  """
  num_groups = len(group_assignments)
  max_gs = max(len(g) for g in group_assignments)
  gather = np.zeros((num_groups, max_gs), dtype=np.int64)
  mask = np.zeros((num_groups, max_gs), dtype=np.float32)
  for g_idx, members in enumerate(group_assignments):
    members = list(members)
    assert all(0 <= m < code_size for m in members)
    gather[g_idx, :len(members)] = members
    mask[g_idx, :len(members)] = 1.0
  return torch.from_numpy(gather), torch.from_numpy(mask)


def unpack_index(gather_inds, valid_mask, code_size: int):
  """(s, R) int64 packed-slot indices summed into each code, ascending,
  padded with G*M (the index of an appended zero slot); R is the largest
  membership count (at least 1).  Built on the host."""
  gather = np.asarray(gather_inds.cpu()).reshape(-1)
  mask = np.asarray(valid_mask.cpu()).reshape(-1)
  slots = [[] for _ in range(code_size)]
  for flat, (code, valid) in enumerate(zip(gather, mask)):
    if valid > 0:
      slots[int(code)].append(flat)
  width = max(1, max(len(s) for s in slots))
  index = np.full((code_size, width), gather.size, dtype=np.int64)
  for code, members in enumerate(slots):
    index[code, :len(members)] = members
  return torch.from_numpy(index)


@functools.lru_cache(maxsize=16)
def _layout(groups, code_size, device):
  """(gather_inds, valid_mask, unpack index) on ``device``, once per
  group structure: a solve inside a loop copies nothing to the device."""
  gather, mask = pack_group_indices(groups, code_size)
  index = unpack_index(gather, mask, code_size)
  return gather.to(device), mask.to(device), index.to(device)


def group_layout(group_assignments, code_size, device):
  """``_layout`` for any group container (lists of index lists)."""
  groups = tuple(tuple(int(m) for m in g) for g in group_assignments)
  return _layout(groups, int(code_size), torch.device(device))


def build_grouped_dictionary(dictionary, gather_inds, valid_mask):
  """(G*M, n) dictionary with rows duplicated per group membership and
  zero rows for group padding (vtc_tpu subspace_ista_fista.py:56-61)."""
  grouped = dictionary[gather_inds] * valid_mask[:, :, None]
  g, m = gather_inds.shape
  return grouped.reshape(g * m, dictionary.shape[1])


def pack_codes(codes, gather_inds, valid_mask):
  """(b, s) -> (b, G, M) zero-padded group tensor."""
  return codes[:, gather_inds] * valid_mask[None, :, :]


def unpack_codes_summed(grouped_codes, gather_inds, valid_mask, code_size,
                        index=None):
  """(b, G, M) or (b, G*M) -> (b, s), summing duplicated memberships
  (vtc_tpu subspace_ista_fista.py:69-78) in a fixed order: each code
  adds its slots in ascending slot order.  ``index``: ``unpack_index``'s
  result, when the caller has it already."""
  b = grouped_codes.shape[0]
  flat = (grouped_codes.reshape((b,) + tuple(valid_mask.shape))
          * valid_mask[None]).reshape(b, -1)
  if index is None:
    index = unpack_index(gather_inds, valid_mask, code_size).to(flat.device)
  vals = torch.cat([flat, flat.new_zeros((b, 1))], dim=1)
  out = vals[:, index[:, 0]]
  for r in range(1, index.shape[1]):
    out = out + vals[:, index[:, r]]
  return out


def _solve(images, grouped_dictionary, gather_inds, valid_mask,
           sparsity_weight, num_iters, stepsize, init_grouped, variant,
           hard_threshold, early_stopping_epsilon, formulation, code_size,
           ret_summed, index=None, psum_axes=None):
  """vtc_tpu subspace_ista_fista.py:86-128: the 'gram' solve of packed
  codes, or for any other ``formulation`` the two-product iteration;
  (b, s) summed codes, or the (b, G*M) packed ones.  ``psum_axes``: the
  ``parallel.Mesh`` of the data-parallel stop test (``ops/solver``)."""
  b = images.shape[0]
  g, m = gather_inds.shape
  init = init_grouped.reshape(b, g * m)
  if formulation == "gram":
    flat = fused_group_fista.fused_group_fista_plain(
        images, grouped_dictionary, m, sparsity_weight, num_iters, stepsize,
        initial_grouped=init, variant=variant, hard=hard_threshold,
        early_stopping_epsilon=early_stopping_epsilon, psum_axes=psum_axes)
  else:

    def grad_fn(z):
      return (z @ grouped_dictionary - images) @ grouped_dictionary.T

    def prox_fn(x, ss):
      return fused_group_fista.group_prox(x, m, sparsity_weight * ss,
                                          hard_threshold)

    with matmul_precision():
      flat = proximal_gradient_loop(
          grad_fn, prox_fn, init, stepsize, num_iters, variant=variant,
          early_stopping_epsilon=early_stopping_epsilon,
          psum_axes=psum_axes)
  if ret_summed:
    return unpack_codes_summed(flat, gather_inds, valid_mask, code_size,
                               index)
  return flat


def run(images, dictionary, group_assignments, sparsity_weight, num_iters,
        variant="fista", ret_summed_gduplicates=True, initial_codes=None,
        early_stopping_epsilon=None, hard_threshold=False, *,
        stepsize: Optional[torch.Tensor] = None,
        lipschitz_method: str = "eigvalsh", formulation: str = "gram",
        mxu_precision: str = "highest"):
  """Infer group-sparse codes for a batch of images.

  Args:
    images: (b, n) batch of flattened patches (tensor or array).
    dictionary: (s, n) dictionary; the solve runs on its device.
    group_assignments: list of index lists; groups may overlap and have
      different sizes.
    sparsity_weight: lambda on the sum of group norms.
    num_iters: max number of iterations.
    variant: 'ista' or 'fista'.
    ret_summed_gduplicates: True (default) returns (b, s) codes with the
      duplicates summed; False returns (flat_grouped_codes (b, G*M),
      grouped_dictionary (G*M, n)).
    initial_codes: optional (b, s) warm start (not mutated).
    early_stopping_epsilon / hard_threshold: as in ista_fista.run; hard
      thresholding zeroes the groups whose norm is below the threshold.
    stepsize: optional precomputed 1/L of the grouped Gram.
    lipschitz_method: 'eigvalsh' (exact) or 'power'.
    formulation: 'gram' | 'direct' | 'pallas' (the CUDA kernel K4).
    mxu_precision: the 'pallas' formulation's tier, as ista_fista.run's.

  Returns:
    (b, s) float32 codes, or the tuple above, on the dictionary's device.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if formulation not in ("gram", "direct", "pallas"):
    raise ValueError("formulation must be 'gram', 'direct' or 'pallas'")
  mxu_precision = resolve_tier(mxu_precision)
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device
  images = torch.as_tensor(images, dtype=torch.float32, device=device)
  code_size = dictionary.shape[0]
  gather_inds, valid_mask, index = group_layout(group_assignments, code_size,
                                                device)
  grouped_dict = build_grouped_dictionary(dictionary, gather_inds,
                                          valid_mask)
  if early_stopping_epsilon is not None:
    early_stopping_epsilon = float(early_stopping_epsilon)
  if stepsize is None:
    # the top eigenvalue of the *grouped* Gram (vtc_tpu :169-172)
    stepsize = lipschitz_ops.fista_stepsize(grouped_dict, lipschitz_method)
  b = images.shape[0]
  g, m = gather_inds.shape
  if initial_codes is None:
    init_grouped = torch.zeros((b, g, m), dtype=torch.float32, device=device)
  else:
    init_grouped = pack_codes(
        torch.as_tensor(initial_codes, dtype=torch.float32, device=device),
        gather_inds, valid_mask)
  if formulation == "pallas":
    if early_stopping_epsilon is not None and not (
        fused_group_fista.group_early_stop_tile_fits(b, g * m, g)):
      mxu_precision = "highest"  # vtc_tpu's full-precision fallback
    flat = fused_group_fista.fused_group_fista_solve(
        images, grouped_dict, m, float(sparsity_weight), int(num_iters),
        stepsize, initial_grouped=(
            None if initial_codes is None
            else init_grouped.reshape(b, g * m).contiguous()),
        variant=variant, hard=bool(hard_threshold),
        early_stopping_epsilon=early_stopping_epsilon, mxu=mxu_precision)
    if not ret_summed_gduplicates:
      return flat, grouped_dict
    return unpack_codes_summed(flat, gather_inds, valid_mask, code_size,
                               index)
  stepsize = torch.as_tensor(stepsize, dtype=torch.float32, device=device)
  out = _solve(images, grouped_dict, gather_inds, valid_mask,
               float(sparsity_weight), int(num_iters), stepsize,
               init_grouped, variant, bool(hard_threshold),
               early_stopping_epsilon,
               "direct" if formulation == "direct" else "gram", code_size,
               bool(ret_summed_gduplicates), index)
  if ret_summed_gduplicates:
    return out
  return out, grouped_dict
