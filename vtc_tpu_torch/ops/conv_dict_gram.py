"""Exact code-space kernel gradient of convolutional sparse coding:
counterpart of vtc_tpu/ops/conv_dict_gram.py:58-215.

The conv kernel gradient is the correlation of the codes with the masked
reconstruction residual.  It splits exactly into

  grad = T1(D; C) - T2

with T2 = (1/b) sum codes * unfold(mask * X) independent of D (once per
training step) and T1 a cheap recombination of D with mask-weighted code
autocorrelations over the tile-overlap offsets: interior minus row and
column corrections plus corners, the identity of ops/conv_gram.py.  The
conv update rules take it as their 'gram' formulation.
"""
import numpy as np
import torch
import torch.nn.functional as F

from vtc_tpu_torch.ops.conv_gram import _overlap_range, _special_positions
from vtc_tpu_torch.ops.precision import matmul_precision

# beyond this many overlap offsets the autocorrelation stack stops paying
# for itself; callers use the image-space gradient
_MAX_OFFSETS = 49


def supported(kernel_shape, kernel_stride):
  """True when the offset stack is small enough to beat image space."""
  ry = (kernel_shape[2] - 1) // kernel_stride[0]
  rx = (kernel_shape[3] - 1) // kernel_stride[1]
  return (2 * ry + 1) * (2 * rx + 1) <= _MAX_OFFSETS


def unfold(images, kernel_hw, stride, code_hw):
  """Strided patches: (b, c, H, W) -> (b, sh, sw, c, kh, kw)."""
  b, c = images.shape[:2]
  kh, kw = kernel_hw
  patches = F.unfold(images, (kh, kw), stride=tuple(stride))
  return patches.reshape(b, c, kh, kw, code_hw[0], code_hw[1]).permute(
      0, 4, 5, 1, 2, 3)


def _shifted_stack(codes, ry, rx):
  """(O, b, s, sh, sw) stack of codes[b, j, p+dy, q+dx] (zero outside)."""
  _, _, code_h, code_w = codes.shape
  zp = F.pad(codes, (rx, rx, ry, ry))
  return torch.stack([zp[:, :, ry + dy:ry + dy + code_h,
                         rx + dx:rx + dx + code_w]
                      for dy in range(-ry, ry + 1)
                      for dx in range(-rx, rx + 1)])


def build_dict_gradient_stats(images_padded, codes, kernel_shape,
                              kernel_stride, padding):
  """Everything in the gradient that does not depend on the dictionary.

  Args:
    images_padded: (b, c, H, W); codes: (b, s, sh, sw), fixed.
    kernel_shape: (s, c, kh, kw); kernel_stride: (sv, sh).
    padding: ((lead_v, trail_v), (lead_h, trail_h)) or None.

  Returns:
    dict for dictionary_gradient_from_stats (batch-averaged).
  """
  b, s, code_h, code_w = codes.shape
  _, c, kh, kw = kernel_shape
  sv, sh_ = kernel_stride
  height, width = images_padded.shape[2], images_padded.shape[3]
  ry, rx = (kh - 1) // sv, (kw - 1) // sh_
  if padding is None:
    (lead_v, trail_v), (lead_h, trail_h) = (0, 0), (0, 0)
  else:
    (lead_v, trail_v), (lead_h, trail_h) = padding
  dtype, device = codes.dtype, codes.device
  spec_py, mrow = _special_positions(code_h, sv, kh, lead_v, trail_v,
                                     height, dtype, device)
  spec_px, mcol = _special_positions(code_w, sh_, kw, lead_h, trail_h,
                                     width, dtype, device)

  with matmul_precision():
    shifted = _shifted_stack(codes, ry, rx)
    c_int = torch.einsum("bipq,objpq->oij", codes, shifted) / b
    cw_rows = cw_cols = cw_corners = None
    if spec_py:
      c_rows = torch.einsum("bipq,objpq->poij", codes[:, :, spec_py, :],
                            shifted[:, :, :, spec_py, :]) / b
      cw_rows = torch.einsum("pr,poij->orij", torch.stack(mrow), c_rows)
    if spec_px:
      c_cols = torch.einsum("bipq,objpq->qoij", codes[:, :, :, spec_px],
                            shifted[:, :, :, :, spec_px]) / b
      cw_cols = torch.einsum("qw,qoij->owij", torch.stack(mcol), c_cols)
    if spec_py and spec_px:
      py = torch.as_tensor(spec_py, device=device)[:, None]
      px = torch.as_tensor(spec_px, device=device)[None, :]
      c_corners = torch.einsum("bipq,objpq->pqoij", codes[:, :, py, px],
                               shifted[:, :, :, py, px]) / b
      cw_corners = torch.einsum("pr,qw,pqoij->orwij", torch.stack(mrow),
                                torch.stack(mcol), c_corners)
    # the image term: unfold(mask * X) once and one product
    masked = images_padded
    if padding is not None:
      rowmask = np.ones(height, np.float32)
      rowmask[:lead_v] = 0.0
      if trail_v:
        rowmask[height - trail_v:] = 0.0
      colmask = np.ones(width, np.float32)
      colmask[:lead_h] = 0.0
      if trail_h:
        colmask[width - trail_h:] = 0.0
      masked = images_padded * torch.as_tensor(
          rowmask[:, None] * colmask[None, :], dtype=dtype, device=device)
    patches = unfold(masked, (kh, kw), kernel_stride, (code_h, code_w))
    t_img = torch.einsum(
        "bipq,bpqk->ik", codes,
        patches.reshape(b, code_h, code_w, c * kh * kw)).reshape(
            s, c, kh, kw) / b
  return {"c_int": c_int, "cw_rows": cw_rows, "cw_cols": cw_cols,
          "cw_corners": cw_corners, "t_img": t_img, "ry": ry, "rx": rx}


def dictionary_gradient_from_stats(stats, dictionary, kernel_stride):
  """grad = T1(D; stats) - T2, the cheap dictionary-dependent part."""
  s, c, kh, kw = dictionary.shape
  sv, sh_ = kernel_stride
  ry, rx = stats["ry"], stats["rx"]
  c_int = stats["c_int"]
  cw_rows, cw_cols = stats["cw_rows"], stats["cw_cols"]
  cw_corners = stats["cw_corners"]
  out = torch.zeros_like(dictionary)
  with matmul_precision():
    o = 0
    for dy in range(-ry, ry + 1):
      r0, r1 = _overlap_range(kh, dy * sv)
      for dx in range(-rx, rx + 1):
        c0, c1 = _overlap_range(kw, dx * sh_)
        if r0 >= r1 or c0 >= c1:
          o += 1
          continue
        dsl = dictionary[:, :, r0 - dy * sv:r1 - dy * sv,
                         c0 - dx * sh_:c1 - dx * sh_]
        upd = torch.einsum("ij,jcrw->icrw", c_int[o], dsl)
        if cw_rows is not None:
          upd = upd - torch.einsum("rij,jcrw->icrw", cw_rows[o, r0:r1], dsl)
        if cw_cols is not None:
          upd = upd - torch.einsum("wij,jcrw->icrw", cw_cols[o, c0:c1], dsl)
        if cw_corners is not None:
          upd = upd + torch.einsum("rwij,jcrw->icrw",
                                   cw_corners[o, r0:r1, c0:c1], dsl)
        out[:, :, r0:r1, c0:c1] += upd
        o += 1
  return out - stats["t_img"]
