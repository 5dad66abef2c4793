"""Bring the JAX package's parameters across to the port.

vtc_tpu's dictionaries travel as numpy arrays: ``np.asarray`` of its jax
arrays, or the framework-agnostic pickled checkpoints of
vtc_tpu/utils/checkpoint.py (which imports neither framework and is
shared, not copied).  For the encode path the only parameter is the
(s, n) dictionary; the trainer slice adds the Hessian EMA and the warm
eigenvector here.
"""
import numpy as np
import torch


def dictionary_from_numpy(array, device):
  """A float32 contiguous tensor on ``device`` from an (s, n) array."""
  array = np.ascontiguousarray(array, dtype=np.float32)
  if array.ndim != 2:
    raise ValueError("expected an (s, n) dictionary, got shape %s"
                     % (array.shape,))
  return torch.tensor(array, device=device)


def load_dictionary(path, device):
  """Load a ``checkpoint_dictionary_iter_<N>`` file onto ``device``."""
  # imported here: only reading a checkpoint loads anything of vtc_tpu
  from vtc_tpu.utils.checkpoint import load_dictionary_checkpoint
  return dictionary_from_numpy(load_dictionary_checkpoint(path), device)
