"""Checkpointing with the reference's framework-agnostic on-disk contract:
the port's own copy of vtc_tpu/utils/checkpoint.py:1-84, byte for byte in
what it writes and reads, so either package resumes from the other's
checkpoints (tests/test_torch_port_host_layer.py holds the round trip).

Contract (reference training/sparse_coding.py:170-175, 493-496;
utils/misc.py:9-22): the dictionary is a raw pickled NumPy array in a file
named ``checkpoint_dictionary_iter_<N>`` under the logging folder, and the
training params are dumped to ``training_params.yaml``.  Any NumPy-capable
consumer can read these without this framework installed.

Extension: an optional full-state sidecar
(``checkpoint_trainstate_iter_<N>.npz``) capturing everything needed for
exact resume -- hessian-diagonal EMA, iteration counter, PRNG key --
which the reference never saved (its "resume" was re-init from the
dictionary alone).
"""
import os
import pickle
from pathlib import Path

import numpy as np

_DICT_PREFIX = "checkpoint_dictionary_iter_"
_STATE_PREFIX = "checkpoint_trainstate_iter_"


def save_dictionary_checkpoint(logging_folder, iteration, dictionary):
  """Pickle the dictionary as a NumPy array (the public contract)."""
  path = Path(logging_folder) / (_DICT_PREFIX + str(iteration))
  with open(path, "wb") as f:
    pickle.dump(np.asarray(dictionary), f)
  return path


def save_trainstate_sidecar(logging_folder, iteration, **state_arrays):
  """Save optional full-resume state (hessian EMA, iter, prng key...)."""
  path = Path(logging_folder) / (_STATE_PREFIX + str(iteration) + ".npz")
  np.savez(path, **{k: np.asarray(v) for k, v in state_arrays.items()})
  return path


def load_dictionary_checkpoint(path):
  with open(path, "rb") as f:
    return pickle.load(f)


def load_newest_dictionary_checkpoint(checkpoint_dir):
  """Load the dictionary with the highest iteration number
  (reference utils/misc.py:9-22).  Returns (dictionary, iteration)."""
  checkpoint_dir = Path(checkpoint_dir)
  iters = []
  for name in os.listdir(checkpoint_dir):
    if name.startswith(_DICT_PREFIX) and not name.endswith(".npz"):
      try:
        iters.append(int(name[len(_DICT_PREFIX):]))
      except ValueError:
        continue
  if not iters:
    raise FileNotFoundError(
        "no dictionary checkpoints in " + str(checkpoint_dir))
  newest = max(iters)
  return load_dictionary_checkpoint(
      checkpoint_dir / (_DICT_PREFIX + str(newest))), newest


def load_trainstate_sidecar(checkpoint_dir, iteration):
  """Load the full-resume sidecar for an iteration, or None if absent."""
  path = Path(checkpoint_dir) / (_STATE_PREFIX + str(iteration) + ".npz")
  if not path.exists():
    return None
  with np.load(path) as data:
    return dict(data)


def resume_training_state(checkpoint_dir):
  """Everything needed to resume from the newest checkpoint.

  Returns (dictionary, state_dict_or_None, iteration).  The reference's
  resume story is dictionary-only re-init (utils/misc.py:9-22); when the
  full-state sidecar exists this also restores the Hessian-diagonal EMA
  and the iteration counter, making resume exact.
  """
  dictionary, iteration = load_newest_dictionary_checkpoint(
      checkpoint_dir)
  state = load_trainstate_sidecar(checkpoint_dir, iteration)
  return dictionary, state, iteration
