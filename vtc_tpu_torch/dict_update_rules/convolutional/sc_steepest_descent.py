"""Steepest-descent dictionary update for convolutional sparse coding:
counterpart of vtc_tpu/dict_update_rules/convolutional/
sc_steepest_descent.py:22-108.

The batch-averaged kernel gradient of the masked reconstruction error,
rescaled to the dictionary's Frobenius norm so the stepsize is
dimensionless, then per-kernel renormalization.  Three formulations of
the same gradient, as in JAX:

* 'block': stride-block space, the code stack built once per update and
  two deep products per iteration (ops/fused_conv_direct.py; needs its
  ``supported`` gate);
* 'gram': code space, dictionary-independent autocorrelations once and a
  cheap recombination per iteration (ops/conv_dict_gram.py);
* 'direct': image space (ops/convolutions.dictionary_gradient);

and 'auto' picks block > gram > direct by geometry.  Pure: returns the
new dictionary.
"""
import torch

from vtc_tpu_torch.ops import conv_dict_gram, conv_shapes, fused_conv_direct
from vtc_tpu_torch.ops import convolutions as conv_ops
from vtc_tpu_torch.ops.precision import matmul_precision


def resolve_formulation(images_shape, dictionary_shape, kernel_stride):
  """'auto' -> 'block' > 'gram' > 'direct' by geometry (vtc_tpu
  sc_steepest_descent.py:94-100, sparse_coding.py:275-282)."""
  if fused_conv_direct.supported(images_shape, dictionary_shape,
                                 kernel_stride):
    return "block"
  if conv_dict_gram.supported(dictionary_shape, kernel_stride):
    return "gram"
  return "direct"


def gradient_fn(images_padded, codes, dictionary_shape, mask, kernel_stride,
                padding, formulation, precision=None):
  """d -> the batch-averaged kernel gradient at fixed codes; ``precision``
  (the block formulation's products, default 'highest')."""
  if formulation == "block":
    stats = fused_conv_direct.build_block_update_stats(
        images_padded, codes, dictionary_shape, kernel_stride, padding)
    return lambda d: fused_conv_direct.dictionary_gradient_from_block_stats(
        stats, d, precision)
  if formulation == "gram":
    stats = conv_dict_gram.build_dict_gradient_stats(
        images_padded, codes, dictionary_shape, kernel_stride, padding)
    return lambda d: conv_dict_gram.dictionary_gradient_from_stats(
        stats, d, kernel_stride)
  if formulation != "direct":
    raise ValueError("formulation must be 'block', 'gram', 'direct' or "
                     "'auto', got %r" % (formulation,))
  return lambda d: conv_ops.dictionary_gradient(images_padded, codes, d,
                                                kernel_stride, mask)


def renormalize_kernels(dictionary, norm_floor=False):
  """Each kernel to unit l2.  ``norm_floor`` floors the squared norm at
  1e-30, as vtc_tpu's fused kernels do (pallas_conv_train.py:495), so a
  zero kernel stays zero."""
  sq = torch.sum(dictionary ** 2, dim=(1, 2, 3), keepdim=True)
  if norm_floor:
    sq = torch.clamp(sq, min=1e-30)
  return dictionary / torch.sqrt(sq)


def rescale_gradient(grad, dictionary, norm_floor=False):
  """The dimensionless step's gradient: grad scaled to the Frobenius norm
  of the dictionary, its own norm floored at 1e-30 with ``norm_floor``
  (pallas_conv_train.py:490)."""
  grad_norm = torch.linalg.vector_norm(grad)
  if norm_floor:
    grad_norm = torch.clamp(grad_norm, min=1e-30)
  return grad * (torch.linalg.vector_norm(dictionary) / grad_norm)


def _update(images_padded, dictionary, codes, mask, kernel_stride, stepsize,
            num_iters, normalize_dictionary, padding=None,
            formulation="direct", precision=None, norm_floor=False):
  grad_fn = gradient_fn(images_padded, codes, dictionary.shape, mask,
                        kernel_stride, padding, formulation, precision)
  d = dictionary
  with matmul_precision():
    for _ in range(int(num_iters)):
      grad = rescale_gradient(grad_fn(d), d, norm_floor)
      d = d - stepsize * grad
      if normalize_dictionary:
        d = renormalize_kernels(d, norm_floor)
  return d


def run(images_padded, dictionary, codes, kernel_stride, padding_dims,
        stepsize=0.001, num_iters=1, normalize_dictionary=True,
        formulation="auto"):
  """Steepest-descent steps on the convolutional dictionary.

  Args:
    images_padded: (b, c, H, W); dictionary: (s, c, kh, kw);
      codes: (b, s, sh, sw).
    kernel_stride: (stride_v, stride_h).
    padding_dims: ((lead_v, trail_v), (lead_h, trail_h)) or None.
    formulation: 'block' | 'gram' | 'direct' | 'auto'.

  Returns:
    (s, c, kh, kw) float32 updated dictionary on the dictionary's device.
  """
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device
  images_padded = torch.as_tensor(images_padded, dtype=torch.float32,
                                  device=device)
  codes = torch.as_tensor(codes, dtype=torch.float32, device=device)
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding_dims)
  if formulation == "auto":
    formulation = resolve_formulation(images_padded.shape, dictionary.shape,
                                      kernel_stride)
  mask = conv_shapes.create_mask(images_padded.shape, padding,
                                 torch.float32, device)
  return _update(images_padded, dictionary, codes, mask, kernel_stride,
                 float(stepsize), int(num_iters), bool(normalize_dictionary),
                 padding, formulation)
