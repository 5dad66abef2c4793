"""Matmul-precision policy: counterpart of vtc_tpu/ops/precision.py:1-35.

The repo's parity contract (codes within 1e-4 of the float64 oracle)
needs IEEE float32 products.  On Hopper three switches can quietly drop
float32 matmuls or convolutions to TF32; this module pins all three and
sets them when it is imported:

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")

``VTC_MATMUL_PRECISION`` overrides the default with the JAX package's
spellings ('highest' | 'float32' | 'tensorfloat32' | 'bfloat16'); anything
but the first two gives up parity grade.
"""
import contextlib
import os

import torch

# JAX precision spelling -> torch.set_float32_matmul_precision value
_SPELLINGS = {
    "highest": "highest",
    "float32": "highest",
    "tensorfloat32": "high",
    "bfloat16": "medium",
}


def _resolve(precision):
  if precision not in _SPELLINGS:
    raise ValueError(
        "unknown matmul precision %r; expected one of %s"
        % (precision, sorted(_SPELLINGS)))
  return _SPELLINGS[precision]


_DEFAULT = os.environ.get("VTC_MATMUL_PRECISION", "highest")
_resolve(_DEFAULT)


def _apply(torch_precision):
  ieee = torch_precision == "highest"
  torch.backends.cuda.matmul.allow_tf32 = not ieee
  torch.backends.cudnn.allow_tf32 = not ieee
  torch.set_float32_matmul_precision(torch_precision)


@contextlib.contextmanager
def matmul_precision(precision=None):
  """Pin the three float32 switches for the body, then restore them."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
  _apply(_resolve(_DEFAULT if precision is None else precision))
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


_apply(_resolve(_DEFAULT))
