"""Strided convolutional synthesis and analysis: counterpart of
vtc_tpu/ops/convolutions.py:42-100.

  synthesize: codes (b, s, sh, sw) -> images (b, c, H, W), the transposed
      strided convolution with the kernels (F.conv_transpose2d);
  analyze:    images (b, c, H, W) -> codes (b, s, sh, sw), the strided
      cross-correlation (F.conv2d), the exact adjoint of synthesize;

plus the masked residual, the code gradient and the kernel gradient of
the masked reconstruction error.  Every convolution runs under
``ops/precision.matmul_precision`` so cuDNN cannot take TF32 products.
Layouts are the JAX package's: NCHW data, (s, c, kh, kw) kernels.

vtc_tpu routes both operators through ops/conv_matmul.py, an MXU-shaped
rewrite of the same maps, when kernel % stride == 0; the port has no need
of it (ROADMAP.md §1 item 7).
"""
import torch.nn.functional as F

from vtc_tpu_torch.ops.precision import matmul_precision


def analyze(images, dictionary, stride, precision=None):
  """Strided cross-correlation: (b,c,h,w) x (s,c,kh,kw) -> (b,s,sh,sw)."""
  with matmul_precision(precision):
    return F.conv2d(images, dictionary, stride=tuple(stride))


def synthesize(codes, dictionary, stride, precision=None):
  """Transposed strided convolution: (b,s,sh,sw) x (s,c,kh,kw) ->
  (b,c,(sh-1)*sv+kh,(sw-1)*sh+kw), the adjoint of ``analyze``."""
  with matmul_precision(precision):
    return F.conv_transpose2d(codes, dictionary, stride=tuple(stride))


def masked_residual(images_padded, codes, dictionary, stride, mask):
  """mask * (synthesize(codes) - images)."""
  return mask * (synthesize(codes, dictionary, stride) - images_padded)


def inference_gradient(images_padded, z, dictionary, stride, mask):
  """Gradient of 0.5 ||mask * (S(z) - X)||^2 with respect to the codes:
  analyze(mask * (S(z) - X))."""
  return analyze(
      masked_residual(images_padded, z, dictionary, stride, mask),
      dictionary, stride)


def dictionary_gradient(images_padded, codes, dictionary, stride, mask):
  """Batch-averaged gradient of the masked reconstruction error with
  respect to the kernels: the reference's batch/channel-transposed
  conv2d with dilation = stride (conv/sc_steepest_descent.py:59-66)."""
  _, _, kh, kw = dictionary.shape
  resid = masked_residual(images_padded, codes, dictionary, stride, mask)
  with matmul_precision():
    grad = F.conv2d(resid.transpose(0, 1), codes.transpose(0, 1),
                    dilation=tuple(stride))
  return grad[:, :, :kh, :kw].transpose(0, 1) / images_padded.shape[0]
