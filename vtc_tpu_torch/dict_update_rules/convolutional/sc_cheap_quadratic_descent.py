"""Cheap-quadratic dictionary update for convolutional sparse coding:
counterpart of vtc_tpu/dict_update_rules/convolutional/
sc_cheap_quadratic_descent.py:21-105.

The steepest-descent kernel gradient divided per kernel by
``hessian_diagonal + lowest_code_val`` and then rescaled to the
dictionary's Frobenius norm (the reference's order), in the formulations
of ``sc_steepest_descent``.  The trainer keeps the Hessian-diagonal EMA
with ``hessian_diagonal_ema`` (a spatial sum of squared codes).  Pure:
returns the new dictionary.
"""
import torch

from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_steepest_descent as conv_sd)
from vtc_tpu_torch.ops import conv_shapes
from vtc_tpu_torch.ops.precision import matmul_precision


def _update(images_padded, dictionary, codes, hessian_diagonal, mask,
            kernel_stride, stepsize, num_iters, lowest_code_val,
            normalize_dictionary, padding=None, formulation="direct",
            precision=None, norm_floor=False):
  scale = (hessian_diagonal + lowest_code_val)[:, None, None, None]
  grad_fn = conv_sd.gradient_fn(images_padded, codes, dictionary.shape,
                                mask, kernel_stride, padding, formulation,
                                precision)
  d = dictionary
  with matmul_precision():
    for _ in range(int(num_iters)):
      grad = conv_sd.rescale_gradient(grad_fn(d) / scale, d, norm_floor)
      d = d - stepsize * grad
      if normalize_dictionary:
        d = conv_sd.renormalize_kernels(d, norm_floor)
  return d


def run(images_padded, dictionary, codes, hessian_diagonal, kernel_stride,
        padding_dims, stepsize=0.001, num_iters=1, lowest_code_val=0.001,
        normalize_dictionary=True, formulation="auto"):
  """Cheap-quadratic descent steps on the convolutional dictionary.

  formulation: 'block' | 'gram' | 'direct' | 'auto' (block > gram >
  direct by geometry).

  Returns:
    (s, c, kh, kw) float32 updated dictionary on the dictionary's device.
  """
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device

  def as_f32(x):
    return torch.as_tensor(x, dtype=torch.float32, device=device)

  images_padded = as_f32(images_padded)
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding_dims)
  if formulation == "auto":
    formulation = conv_sd.resolve_formulation(
        images_padded.shape, dictionary.shape, kernel_stride)
  mask = conv_shapes.create_mask(images_padded.shape, padding,
                                 torch.float32, device)
  return _update(images_padded, dictionary, as_f32(codes),
                 as_f32(hessian_diagonal), mask, kernel_stride,
                 float(stepsize), int(num_iters), float(lowest_code_val),
                 bool(normalize_dictionary), padding, formulation)


def hessian_diagonal_ema(hessian_diagonal, codes):
  """Trainer-side conv EMA: h <- 0.99 h + mean_b(sum_spatial codes^2)/100
  (vtc_tpu sc_cheap_quadratic_descent.py:101-105)."""
  return 0.99 * hessian_diagonal + torch.mean(
      torch.sum(codes ** 2, dim=(2, 3)), dim=0) / 100.0
