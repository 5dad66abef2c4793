"""ICA natural-gradient dictionary update: counterpart of
vtc_tpu/dict_update_rules/fully_connected/ica_natural_gradient.py:1-51.

  D <- D + eta * ((codes^T sign(codes) / b) - I) D     (gradient ascent)

No images are needed.  Pure: returns the new dictionary.
"""
import torch

from vtc_tpu_torch.ops.precision import matmul_precision


def _update_from_stat(dictionary, stat, stepsize, num_iters):
  """Ascent iterations from the batch-mean statistic
  ``stat = codes^T sign(codes) / b``, constant across iterations."""
  eye = torch.eye(stat.shape[0], dtype=dictionary.dtype,
                  device=dictionary.device)
  d = dictionary
  with matmul_precision():
    for _ in range(int(num_iters)):
      d = d + stepsize * ((stat - eye) @ d)
  return d


def _update(dictionary, codes, stepsize, num_iters):
  with matmul_precision():
    stat = codes.T @ torch.sign(codes) / codes.shape[0]
  return _update_from_stat(dictionary, stat, stepsize, num_iters)


def run(dictionary, codes, stepsize=0.001, num_iters=1):
  """Natural-gradient ascent steps on a square ICA dictionary.

  Args:
    dictionary: (s, n) tensor (square for ICA).
    codes: (b, s), moved to the dictionary's device.

  Returns:
    (s, n) float32 updated dictionary.
  """
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  codes = torch.as_tensor(codes, dtype=torch.float32,
                          device=dictionary.device)
  return _update(dictionary, codes, float(stepsize), int(num_iters))
