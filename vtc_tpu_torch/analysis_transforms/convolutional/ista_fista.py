"""Convolutional ISTA / FISTA sparse inference: counterpart of
``code_spatial_dims``, ``_solve`` and ``run`` (vtc_tpu/analysis_transforms/
convolutional/ista_fista.py:26-196), with the same arguments and
formulations (``_solve`` also takes vtc_tpu's ``psum_axes``, the
data-parallel stop test of the psum-per-op step):

* 'gram' (the default, as in JAX): the code-space Gram operator
  (ops/conv_gram.py), grad = L(z) - A(mask * X):
  ``ops/fused_conv_fista.fused_conv_fista_plain``, K11's plain version;
* 'direct': the reference's literal synthesize / mask / analyze
  iteration (ops/convolutions.py);
* 'pallas': keeps its JAX spelling and selects the hand-written CUDA
  kernels with the JAX dispatch (:133-173): K10
  (``ops/fused_conv_direct``) when its gate ``supported(...)`` holds,
  else K11 (``ops/fused_conv_fista``); CPU tensors take their plain
  versions.  ``early_stopping_epsilon`` runs the batch-global stop test
  in either kernel on the card, decided on the device; CPU tensors run
  it in the plain versions.

Padded images must be stride-exact ((H - kh) % sv == 0): vtc_tpu fails
on other geometries in every formulation, and the port raises ValueError
(ops/conv_shapes.require_stride_exact).  Only ``mxu_precision='highest'``
exists: the reduced-precision tiers wait (ROADMAP.md §1 item 3a.2.2).
"""
from typing import Optional

import torch

from vtc_tpu_torch.ops import conv_gram, conv_shapes, fused_conv_direct
from vtc_tpu_torch.ops import fused_conv_fista
from vtc_tpu_torch.ops import convolutions as conv_ops
from vtc_tpu_torch.ops import lipschitz as lipschitz_ops
from vtc_tpu_torch.ops import thresholds
from vtc_tpu_torch.ops.solver import proximal_gradient_loop


def code_spatial_dims(padded_shape, kernel_shape, kernel_stride):
  """(sh, sw) implied by padded image dims, kernel dims and strides."""
  return (conv_shapes.code_dim_from_padded_img_dim(
              padded_shape[2], kernel_shape[2], kernel_stride[0]),
          conv_shapes.code_dim_from_padded_img_dim(
              padded_shape[3], kernel_shape[3], kernel_stride[1]))


def _solve(images_padded, dictionary, mask, sparsity_weight, num_iters,
           stepsize, initial_codes, kernel_stride, variant, nonnegative_only,
           hard_threshold, early_stopping_epsilon, formulation="direct",
           padding=None, psum_axes=None):
  """vtc_tpu's ``_solve`` (:35-76): the 'gram' loop (code-space Gram
  operator, grad = L(z) - A(mask * X); it needs the padding that made
  ``mask``) or the 'direct' one.  ``psum_axes`` is the ``parallel.Mesh``
  of the data-parallel stop test (ops/solver.py), or None."""
  threshold_fn = thresholds.select(nonnegative_only, hard_threshold)
  if formulation == "gram":
    op = conv_gram.build_gram_operator(
        dictionary, kernel_stride, padding, tuple(images_padded.shape[2:]),
        tuple(initial_codes.shape[2:]))
    corr = conv_ops.analyze(mask * images_padded, dictionary, kernel_stride)

    def grad_fn(z):
      return conv_gram.apply_gram(z, op) - corr
  else:

    def grad_fn(z):
      return conv_ops.inference_gradient(images_padded, z, dictionary,
                                         kernel_stride, mask)

  def prox_fn(x, ss):
    return threshold_fn(x, sparsity_weight * ss)

  return proximal_gradient_loop(
      grad_fn, prox_fn, initial_codes, stepsize, num_iters, variant=variant,
      early_stopping_epsilon=early_stopping_epsilon, psum_axes=psum_axes)


def run(images_padded, dictionary, kernel_stride, padding_dims,
        sparsity_weight, num_iters, variant="fista", initial_codes=None,
        early_stopping_epsilon=None, nonnegative_only=False,
        hard_threshold=False, *,
        stepsize: Optional[torch.Tensor] = None,
        lipschitz_method: str = "eigvalsh", formulation: str = "gram",
        mxu_precision: str = "highest"):
  """Infer convolutional sparse codes for a batch of padded images.

  Args:
    images_padded: (b, c, H, W) images, already padded (see
      ops/conv_shapes.get_padding_amt).
    dictionary: (s, c, kh, kw) kernels.  The solve runs on the
      dictionary's device; arrays land on the CPU.
    kernel_stride: (stride_v, stride_h).
    padding_dims: ((lead_v, trail_v), (lead_h, trail_h)) or None; the
      reconstruction error inside this border is masked out.
    sparsity_weight, num_iters, variant, initial_codes,
    early_stopping_epsilon, nonnegative_only, hard_threshold: as in the
      fully-connected solver.
    stepsize: optional precomputed 1/L of the flattened kernels.
    lipschitz_method: 'eigvalsh' (exact) or 'power'.
    formulation: 'gram' | 'direct' | 'pallas' (the CUDA kernels).
    mxu_precision: 'highest' only.

  Returns:
    (b, s, sh, sw) float32 codes on the dictionary's device.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if formulation not in ("gram", "direct", "pallas"):
    raise ValueError("formulation must be 'gram', 'direct' or 'pallas'")
  if mxu_precision != "highest":
    raise NotImplementedError(
        "mxu_precision=%r: the conv tiers wait, ROADMAP.md §1 item 3a.2.2"
        % (mxu_precision,))
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device
  images_padded = torch.as_tensor(images_padded, dtype=torch.float32,
                                  device=device)
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding_dims)
  conv_shapes.require_stride_exact(images_padded.shape[2:],
                                   dictionary.shape[2:], kernel_stride)
  sh, sw = code_spatial_dims(images_padded.shape, dictionary.shape,
                             kernel_stride)
  code_shape = (images_padded.shape[0], dictionary.shape[0], sh, sw)
  if initial_codes is not None:
    initial_codes = torch.as_tensor(
        initial_codes, dtype=torch.float32, device=device).contiguous()
    if tuple(initial_codes.shape) != code_shape:
      raise ValueError("initial_codes must have shape %s, got %s" % (
          code_shape, tuple(initial_codes.shape)))
  if early_stopping_epsilon is not None:
    early_stopping_epsilon = float(early_stopping_epsilon)
  if stepsize is None:
    stepsize = lipschitz_ops.fista_stepsize(
        dictionary.reshape(dictionary.shape[0], -1), lipschitz_method)
  flags = dict(kernel_stride=kernel_stride, padding=padding,
               initial_codes=initial_codes, variant=variant,
               nonneg=bool(nonnegative_only), hard=bool(hard_threshold))
  lam = float(sparsity_weight)
  direct_gate = fused_conv_direct.supported(
      images_padded.shape, dictionary.shape, kernel_stride)
  if formulation == "pallas":
    # K10 where its gate holds, else K11 (vtc_tpu runs its XLA gram loop
    # there with a stop, :163-176: K11 computes the same function); both
    # take the stop test in the kernel on the card
    solve = (fused_conv_direct.fused_conv_direct_solve if direct_gate
             else fused_conv_fista.fused_conv_fista_solve)
    return solve(images_padded, dictionary, lam, num_iters, stepsize,
                 early_stopping_epsilon=early_stopping_epsilon, **flags)
  if formulation == "gram":
    return fused_conv_fista.fused_conv_fista_plain(
        images_padded, dictionary, lam, num_iters, stepsize,
        early_stopping_epsilon=early_stopping_epsilon, **flags)
  if initial_codes is None:
    initial_codes = torch.zeros(code_shape, dtype=torch.float32,
                                device=device)
  mask = conv_shapes.create_mask(images_padded.shape, padding,
                                 torch.float32, device)
  return _solve(
      images_padded, dictionary, mask, lam, num_iters,
      torch.as_tensor(stepsize, dtype=torch.float32, device=device),
      initial_codes, kernel_stride, variant, bool(nonnegative_only),
      bool(hard_threshold), early_stopping_epsilon)
