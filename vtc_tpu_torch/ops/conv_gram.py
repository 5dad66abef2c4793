"""Exact code-space Gram operator of convolutional sparse inference:
counterpart of vtc_tpu/ops/conv_gram.py:42-236.

The conv gradient A(mask * (S(z) - X)) is L(z) - A(mask * X), with
L(z) = A(mask * S(z)) a linear operator on codes that couples only code
positions whose tiles overlap (offsets |dy| <= (kh-1)//sv,
|dx| <= (kw-1)//sh).  The separable padding mask enters linearly, so

  L = L_interior - L_rows - L_cols + L_corners

with L_interior translation-invariant (one (s, s) channel mix per
offset, ``g_int``) and the corrections supported on the few "special"
code rows and columns whose tiles touch the masked border.  The K11
kernel (ops/fused_conv_fista.py) runs this operator; ``apply_gram`` is
its plain PyTorch version and the 'gram' formulation's.
"""
import torch
import torch.nn.functional as F

from vtc_tpu_torch.ops.precision import matmul_precision


def _overlap_range(k, shift):
  """Tile-p pixel rows that overlap tile p+offset (offset*stride =
  shift)."""
  return max(0, shift), min(k, k + shift)


def _special_positions(num_positions, stride, kernel, lead, trail, size,
                       dtype, device):
  """Code positions whose tiles touch the masked border (a first pixel
  before ``lead`` or a last one at or past ``size - trail``), with the
  in-tile masked-pixel indicator of each, (kernel,) of ``dtype`` made on
  ``device``: a copy from the host would wait for the device's queued
  work."""
  specials = [p for p in range(num_positions)
              if p * stride < lead or p * stride + kernel > size - trail]
  masks = []
  for p in specials:
    pix = torch.arange(p * stride, p * stride + kernel, device=device)
    masks.append(((pix < lead) | (pix >= size - trail)).to(dtype))
  return specials, masks


def build_gram_operator(dictionary, kernel_stride, padding, padded_hw,
                        code_hw, precision=None):
  """The offset matrices of L(z) = A(mask * S(z)).

  Args:
    dictionary: (s, c, kh, kw) kernels.
    kernel_stride: (sv, sh).
    padding: ((lead_v, trail_v), (lead_h, trail_h)) or None.
    padded_hw: (H, W) of the padded images.
    code_hw: (sh, sw) code spatial dims.

  Returns:
    dict: 'g_int' (O, s, s), 'g_rows' (P, O, s, s), 'g_cols' (Q, O, s, s),
    'g_corners' (P, Q, O, s, s) on the dictionary's device, the special
    rows 'spec_py' and columns 'spec_px', 'ry', 'rx' and 'code_hw'.
  """
  s, _, kh, kw = dictionary.shape
  sv, sh_ = kernel_stride
  height, width = padded_hw
  code_h, code_w = code_hw
  ry, rx = (kh - 1) // sv, (kw - 1) // sh_
  if padding is None:
    (lead_v, trail_v), (lead_h, trail_h) = (0, 0), (0, 0)
  else:
    (lead_v, trail_v), (lead_h, trail_h) = padding
  dtype, device = dictionary.dtype, dictionary.device
  spec_py, mrow = _special_positions(code_h, sv, kh, lead_v, trail_v,
                                     height, dtype, device)
  spec_px, mcol = _special_positions(code_w, sh_, kw, lead_h, trail_h,
                                     width, dtype, device)

  # each offset's overlapping kernel slices, the right-hand side
  # reshaped once for the 1 + P + Q + P*Q matrices that share it
  parts = []
  for dy in range(-ry, ry + 1):
    r0, r1 = _overlap_range(kh, dy * sv)
    for dx in range(-rx, rx + 1):
      c0, c1 = _overlap_range(kw, dx * sh_)
      if r0 >= r1 or c0 >= c1:
        parts.append(None)
        continue
      b = dictionary[:, :, r0 - dy * sv:r1 - dy * sv,
                     c0 - dx * sh_:c1 - dx * sh_]
      parts.append((r0, r1, c0, c1, dictionary[:, :, r0:r1, c0:c1],
                    b.reshape(s, -1).T))

  def gram(weight_rows, weight_cols):
    """(O, s, s): Result[o][i, j] = sum_{r,c,ch} w_r[r] w_c[c]
    D[i,ch,r,c] D[j,ch,r - dy*sv, c - dx*sh]."""
    mats = []
    for part in parts:
      if part is None:
        mats.append(torch.zeros((s, s), dtype=dtype, device=device))
        continue
      r0, r1, c0, c1, a, bt = part
      if weight_rows is not None:
        a = a * weight_rows[r0:r1][None, None, :, None]
      if weight_cols is not None:
        a = a * weight_cols[c0:c1][None, None, None, :]
      mats.append(a.reshape(s, -1) @ bt)
    return torch.stack(mats)

  with matmul_precision(precision):
    g_int = gram(None, None)
    empty = torch.zeros((0,) + tuple(g_int.shape), dtype=dtype,
                        device=device)
    g_rows = (torch.stack([gram(m, None) for m in mrow])
              if spec_py else empty)
    g_cols = (torch.stack([gram(None, m) for m in mcol])
              if spec_px else empty)
    g_corners = (torch.stack([
        torch.stack([gram(mr, mc) for mc in mcol])
        for mr in mrow]) if spec_py and spec_px else
                 empty.reshape((0, 0) + tuple(g_int.shape)))
  return {"g_int": g_int, "g_rows": g_rows, "g_cols": g_cols,
          "g_corners": g_corners, "spec_py": tuple(spec_py),
          "spec_px": tuple(spec_px), "ry": ry, "rx": rx,
          "code_hw": (code_h, code_w)}


def apply_gram(z, op, precision=None):
  """L(z) for codes z (b, s, sh, sw): the translation-invariant part as
  one (s x s)-channel-mix convolution, then the border corrections on
  the special rows, columns and corners (vtc_tpu conv_gram.py:160-200)."""
  _, s, code_h, code_w = z.shape
  ry, rx = op["ry"], op["rx"]
  spec_py, spec_px = list(op["spec_py"]), list(op["spec_px"])
  offs = [(dy, dx) for dy in range(-ry, ry + 1) for dx in range(-rx, rx + 1)]
  with matmul_precision(precision):
    # out[b,i,y,x] = sum_{o,j} g_int[o,i,j] z[b,j,y+dy,x+dx]
    kernel = op["g_int"].reshape(2 * ry + 1, 2 * rx + 1, s, s).permute(
        2, 3, 0, 1)
    out = F.conv2d(z, kernel, padding=(ry, rx))
    zp = F.pad(z, (rx, rx, ry, ry))
    if spec_py:
      rows = torch.stack([
          torch.stack([zp[:, :, p + ry + dy, rx + dx:rx + dx + code_w]
                       for p in spec_py], dim=2)
          for dy, dx in offs])                       # (O, b, j, P, w)
      out[:, :, spec_py, :] -= torch.einsum("objpw,poij->bipw", rows,
                                            op["g_rows"])
    if spec_px:
      cols = torch.stack([
          torch.stack([zp[:, :, ry + dy:ry + dy + code_h, q + rx + dx]
                       for q in spec_px], dim=3)
          for dy, dx in offs])                       # (O, b, j, h, Q)
      out[:, :, :, spec_px] -= torch.einsum("objhq,qoij->bihq", cols,
                                            op["g_cols"])
    if spec_py and spec_px:
      corners = torch.stack([
          torch.stack([
              torch.stack([zp[:, :, p + ry + dy, q + rx + dx]
                           for q in spec_px], dim=2)
              for p in spec_py], dim=2)
          for dy, dx in offs])                       # (O, b, j, P, Q)
      py = torch.as_tensor(spec_py, device=z.device)
      px = torch.as_tensor(spec_px, device=z.device)
      out[:, :, py[:, None], px[None, :]] += torch.einsum(
          "objpq,pqoij->bipq", corners, op["g_corners"])
  return out


def inference_gradient_gram(images_padded, z, dictionary, stride, mask,
                            op=None, corr=None):
  """The code gradient through the code-space Gram: L(z) - A(mask*X)."""
  from vtc_tpu_torch.ops import convolutions as conv_ops
  if op is None:
    raise ValueError("pass op=build_gram_operator(...)")
  if corr is None:
    corr = conv_ops.analyze(mask * images_padded, dictionary, stride)
  return apply_gram(z, op) - corr
