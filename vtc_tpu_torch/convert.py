"""Bring the JAX package's parameters across to the port.

vtc_tpu's dictionaries travel as numpy arrays: ``np.asarray`` of its jax
arrays, or the framework-agnostic pickled checkpoints, which the port
reads and writes with its own copy of vtc_tpu/utils/checkpoint.py
(``vtc_tpu_torch/utils/checkpoint.py``, the same on-disk format).  The
encode path needs the (s, n) dictionary, or the (s, c, kh, kw) kernels of
a convolutional one; the fc trainer also carries the Hessian-diagonal EMA (s,) and the warm Lipschitz
eigenvector -- (min(s, n),), or (min(G*M, n),) of the grouped Gram for
the subspace trainer -- and resumes from the train-state sidecar that
vtc_tpu's trainers write beside each dictionary checkpoint.  The ICA
trainers take a square (n, n) dictionary and its tracked inverse
(``ica_state_from_numpy``); a fitted ``PCACoder`` is its (k, n)
principal directions and its (n,) component means (``pca_from_numpy``).
The code-sharded trainer's state on one rank is its row shard of the
dictionary and of the Hessian, the replicated (n,) eigenvector of the
n x n Gram and, with groups, its slice of ``code_shard_group_arrays``
(``code_shard_state_from_numpy``); ``code_shard_state_to_numpy``
gathers the shards back into vtc_tpu's global arrays.
"""
import numpy as np
import torch


def dictionary_from_numpy(array, device):
  """A float32 contiguous tensor on ``device`` from an (s, n) dictionary
  or (s, c, kh, kw) convolutional kernels."""
  array = np.ascontiguousarray(array, dtype=np.float32)
  if array.ndim not in (2, 4):
    raise ValueError("expected an (s, n) dictionary or (s, c, kh, kw) "
                     "kernels, got shape %s" % (array.shape,))
  return torch.tensor(array, device=device)


def load_dictionary(path, device):
  """Load a ``checkpoint_dictionary_iter_<N>`` file onto ``device``."""
  from vtc_tpu_torch.utils.checkpoint import load_dictionary_checkpoint
  return dictionary_from_numpy(load_dictionary_checkpoint(path), device)


def train_state_from_numpy(dictionary, hessian, eigvec, device,
                          group_assignments=None):
  """(dictionary, hessian, eigvec) as float32 tensors on ``device``: the
  state ``ops.fused_train_step.fused_train_segment`` carries, or with
  ``group_assignments`` the state of
  ``ops.fused_group_train_step.fused_group_train_segment``, whose
  eigenvector has min(G*M, n) entries (G groups, M the largest;
  vtc_tpu pallas_train_step.py:1328-1329)."""
  s, n = np.shape(dictionary)
  dim = s
  if group_assignments is not None:
    dim = len(group_assignments) * max(len(g) for g in group_assignments)
  shapes = ((s, n), (s,), (min(dim, n),))
  out = []
  for name, array, shape in zip(("dictionary", "hessian", "eigvec"),
                                (dictionary, hessian, eigvec), shapes):
    array = np.ascontiguousarray(array, dtype=np.float32)
    if array.shape != shape:
      raise ValueError("expected %s of shape %s, got %s"
                       % (name, shape, array.shape))
    out.append(torch.tensor(array, device=device))
  return tuple(out)


def code_shard_state_from_numpy(dictionary, hessian, eigvec, mesh, device,
                                group_assignments=None):
  """This rank's code-sharded train state on ``device`` from vtc_tpu's
  global (s, n) dictionary, (s,) Hessian EMA and (n,) eigenvector (s > n):
  the dict of ``fused_code_shard_train.fused_code_sharded_train_segment``'s
  arguments -- 'dict_shard' and 'hessian_shard', the rows of
  ``mesh.code_shard``; 'eigvec', replicated; with ``group_assignments``
  (a disjoint partition with no group across a shard boundary)
  'expand_local' and 'comem_local', the rank's slices of
  ``code_shard_group_arrays``."""
  from vtc_tpu_torch.ops.fused_code_shard_train import (
      code_shard_group_arrays)
  s, n = np.shape(dictionary)
  d, h, v = train_state_from_numpy(dictionary, hessian, eigvec, device)
  if v.shape[0] != n:
    raise ValueError("the code-sharded state's eigenvector is the n x n "
                     "Gram's: it needs s > n, got s=%d, n=%d" % (s, n))
  state = {"dict_shard": mesh.code_shard(d).contiguous(),
           "hessian_shard": mesh.code_shard(h).contiguous(), "eigvec": v}
  if group_assignments is not None:
    arrays = code_shard_group_arrays(group_assignments, s, mesh.code_size)
    if arrays is None:
      raise ValueError("the groups must be a disjoint partition of the rows "
                       "with no group across a shard boundary")
    state["expand_local"] = torch.tensor(arrays[0][mesh.code_index],
                                         device=device)
    state["comem_local"] = torch.tensor(arrays[1][mesh.code_index],
                                        device=device)
  return state


def code_shard_state_to_numpy(mesh, dict_shard, hessian_shard, eigvec):
  """The inverse of ``code_shard_state_from_numpy``: the shards gathered
  over the mesh's 'code' axis (every rank of it calls this together) as
  vtc_tpu's global float32 (dictionary, hessian, eigvec)."""
  return tuple(np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)
               for t in (mesh.all_gather_code(dict_shard),
                         mesh.all_gather_code(hessian_shard), eigvec))


def load_train_state(checkpoint_dir, device):
  """The newest checkpoint of ``checkpoint_dir`` and its train-state
  sidecar, as the port's trainers take them.

  Returns (dictionary, resume_state, iteration): the dictionary as a
  tensor on ``device``; resume_state, for all_params['resume_state'],
  holds 'hessian_diagonal' (a tensor on ``device``) and
  'train_iteration' (an int), or is None when the checkpoint has no
  sidecar.
  """
  from vtc_tpu_torch.utils.checkpoint import resume_training_state
  dictionary, state, iteration = resume_training_state(checkpoint_dir)
  if state is not None:
    state = {"hessian_diagonal": torch.tensor(
                 np.asarray(state["hessian_diagonal"], np.float32),
                 device=device),
             "train_iteration": int(state["train_iteration"])}
  return dictionary_from_numpy(dictionary, device), state, iteration


def _tensor(name, array, shape, device):
  array = np.ascontiguousarray(array, dtype=np.float32)
  if array.shape != shape:
    raise ValueError("expected %s of shape %s, got %s"
                     % (name, shape, array.shape))
  return torch.tensor(array, device=device)


def ica_state_from_numpy(dictionary, inverse, device):
  """(dictionary, inverse) as float32 (n, n) tensors on ``device``: the
  state ``ops.fused_ica_train.fused_ica_train_segment`` carries.  With
  ``inverse`` None it is the exact inverse of the dictionary, the seed
  vtc_tpu's scanned ICA trainer starts from."""
  n = np.shape(dictionary)[0]
  d = _tensor("dictionary", dictionary, (n, n), device)
  if inverse is None:
    from vtc_tpu_torch.analysis_transforms.fully_connected import (
        invertible_linear)
    return d, invertible_linear.exact_inverse(d)
  return d, _tensor("inverse", inverse, (n, n), device)


def pca_from_numpy(dictionary, component_means, device):
  """A fitted PCACoder's (k, n) principal directions and (n,) component
  means as float32 tensors on ``device``."""
  k, n = np.shape(dictionary)
  return (_tensor("dictionary", dictionary, (k, n), device),
          _tensor("component_means", component_means, (n,), device))
