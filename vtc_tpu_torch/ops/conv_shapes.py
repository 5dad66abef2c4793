"""Shape, padding and mask helpers of the convolutional transforms:
counterpart of vtc_tpu/ops/conv_shapes.py:15-54.

``padding=None`` and ``((0, 0), (0, 0))`` are both valid and equivalent
(the mask is built from explicit index ranges, so a zero trailing pad
works).  Code dims round UP, as vtc_tpu's do: where the padded image is
not stride-exact ((H - kh) % stride != 0) they differ from a VALID
convolution's, and every conv formulation of both packages refuses such
a geometry (``require_stride_exact``).
"""
import math

import torch


def get_padding_amt(image_dim: int, kernel_dim: int, dim_stride: int):
  """Leading/trailing padding so strided kernels cover the image:
  kernel - stride each, plus a stride-remainder correction on the
  trailing edge."""
  leading = kernel_dim - dim_stride
  trailing = kernel_dim - dim_stride
  if image_dim % dim_stride != 0:
    trailing += dim_stride - (image_dim % dim_stride)
  return leading, trailing


def code_dim_from_padded_img_dim(padded_image_dim: int, kernel_dim: int,
                                 dim_stride: int) -> int:
  """Spatial extent of the code map (rounds up)."""
  return 1 + int(math.ceil((padded_image_dim - kernel_dim) / dim_stride))


def require_stride_exact(padded_hw, kernel_hw, kernel_stride):
  """Raise ValueError unless (padded - kernel) % stride == 0 on both
  axes.  vtc_tpu fails on such a geometry in every formulation (its
  ceil code dims meet a floor-sized VALID convolution); the port says
  so up front."""
  for dim, k, st in zip(padded_hw, kernel_hw, kernel_stride):
    if (dim - k) % st:
      raise ValueError(
          "padded image dims %s are not stride-exact for kernels %s at "
          "stride %s: (padded - kernel) %% stride must be 0 (pad with "
          "get_padding_amt)" % (tuple(padded_hw), tuple(kernel_hw),
                                tuple(kernel_stride)))


def normalize_padding(padding):
  """((lead_v, trail_v), (lead_h, trail_h)) as ints, or None."""
  if padding is None:
    return None
  return tuple(tuple(int(x) for x in p) for p in padding)


def create_mask(padded_shape, padding, dtype=torch.float32, device=None):
  """A (1, 1, h, w) {0, 1} mask that zeroes the padded border, to
  broadcast over batch and channels.

  Args:
    padded_shape: (b, c, h, w) of the padded image batch.
    padding: ((lead_v, trail_v), (lead_h, trail_h)) or None.
  """
  _, _, h, w = padded_shape
  if padding is None:
    return torch.ones((1, 1, h, w), dtype=dtype, device=device)
  (lead_v, trail_v), (lead_h, trail_h) = padding
  rows = torch.arange(h, device=device)
  cols = torch.arange(w, device=device)
  row_ok = (rows >= lead_v) & (rows < h - trail_v)
  col_ok = (cols >= lead_h) & (cols < w - trail_h)
  return (row_ok[:, None] & col_ok[None, :]).to(dtype)[None, None]
