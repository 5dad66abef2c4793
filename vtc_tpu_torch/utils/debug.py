"""Numeric health checks: the port's own copy of vtc_tpu/utils/debug.py.

An accelerator raises no exception when a dictionary overflows -- the
eigensolve just returns inf/nan and training silently corrupts.  The
trainers call ``assert_dictionary_healthy`` at host-boundary events
(checkpoints), which costs one device sync there and nothing in the hot
loop.
"""
import numpy as np


def assert_dictionary_healthy(dictionary, where=""):
  """Raise FloatingPointError (with per-element norms, like the
  reference's diagnostic) if the dictionary has nonfinite values."""
  arr = np.asarray(dictionary)
  if np.isfinite(arr).all():
    return
  flat = arr.reshape(arr.shape[0], -1)
  norms = np.linalg.norm(flat, axis=1)
  raise FloatingPointError(
      "dictionary contains nonfinite values{}; per-element norms:\n{}"
      .format(" at " + where if where else "", norms))
