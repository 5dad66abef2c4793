"""Fully-connected ISTA / FISTA sparse inference: counterpart of
``run`` and ``_solve`` (vtc_tpu/analysis_transforms/fully_connected/
ista_fista.py:34-152), with the same arguments and formulations:

* 'gram' (the default, as in JAX): G = D D^T and c = X D^T once, then one
  (b,s)x(s,s) product per iteration with the stepsize folded in,
  z + z @ (-eta G) + eta c: ``ops/fused_fista.fused_fista_plain``, the
  kernel's plain version;
* 'direct': the reference's literal two-product iteration;
* 'pallas': keeps its JAX spelling so callers' parameters carry over, and
  selects the hand-written CUDA kernel (``ops/fused_fista``; the plain
  PyTorch version for CPU tensors).  ``early_stopping_epsilon`` runs the
  batch-global stop test inside the kernel on every batch size, where
  vtc_tpu's kernel takes it only when the batch fits one VMEM tile
  (``early_stop_tile_fits``) and runs the XLA loop otherwise: the same
  rule, so the same codes.

``mxu_precision`` ('highest', 'bf16x5', 'bf16x3', 'default' or its
training spelling 'bf16') is the tier of the 'pallas' formulation's
iteration product, as in vtc_tpu (``fused_fista_solve``'s ``mxu``); 'gram'
and 'direct' keep full precision.  A tier with an early stop on a batch
that vtc_tpu's K1 cannot hold in one tile (``early_stop_tile_fits``) runs
at full precision, as vtc_tpu's fallback to its 'gram' path does.
"""
from typing import Optional

import torch

from vtc_tpu_torch.ops import fused_fista
from vtc_tpu_torch.ops import lipschitz as lipschitz_ops
from vtc_tpu_torch.ops import thresholds
from vtc_tpu_torch.ops.precision import matmul_precision, resolve_tier
from vtc_tpu_torch.ops.solver import proximal_gradient_loop


def _solve_direct(images, dictionary, sparsity_weight, num_iters, stepsize,
                  initial_codes, variant, nonnegative_only, hard_threshold,
                  early_stopping_epsilon, psum_axes=None):
  threshold_fn = thresholds.select(nonnegative_only, hard_threshold)

  def grad_fn(z):
    return (z @ dictionary - images) @ dictionary.T

  def prox_fn(x, ss):
    return threshold_fn(x, sparsity_weight * ss)

  with matmul_precision():
    return proximal_gradient_loop(
        grad_fn, prox_fn, initial_codes, stepsize, num_iters,
        variant=variant, early_stopping_epsilon=early_stopping_epsilon,
        psum_axes=psum_axes)


def _solve(images, dictionary, sparsity_weight, num_iters, stepsize,
           initial_codes, variant, nonnegative_only, hard_threshold,
           early_stopping_epsilon, formulation, psum_axes=None):
  """vtc_tpu's ``_solve`` (:39-73): the 'gram' loop, or for any other
  ``formulation`` the two-product iteration, on tensors of one device.
  ``psum_axes``: the ``parallel.Mesh`` of the data-parallel stop test
  (``ops/solver``), which the data-parallel step passes."""
  if formulation == "gram":
    return fused_fista.fused_fista_plain(
        images, dictionary, sparsity_weight, num_iters, stepsize,
        initial_codes=initial_codes, variant=variant, nonneg=nonnegative_only,
        hard=hard_threshold, early_stopping_epsilon=early_stopping_epsilon,
        psum_axes=psum_axes)
  stepsize = torch.as_tensor(stepsize, dtype=images.dtype,
                             device=images.device)
  return _solve_direct(images, dictionary, sparsity_weight, num_iters,
                       stepsize, initial_codes, variant, nonnegative_only,
                       hard_threshold, early_stopping_epsilon, psum_axes)


def run(images, dictionary, sparsity_weight, num_iters, variant="fista",
        initial_codes=None, early_stopping_epsilon=None,
        nonnegative_only=False, hard_threshold=False, *,
        stepsize: Optional[torch.Tensor] = None,
        lipschitz_method: str = "eigvalsh",
        formulation: str = "gram",
        mxu_precision: str = "highest"):
  """Infer sparse codes for a batch of images.

  Args:
    images: (b, n) batch of flattened patches (tensor or array).
    dictionary: (s, n) dictionary, rows are basis elements.  The solve
      runs on the dictionary's device; arrays land on the CPU.
    sparsity_weight: lambda weighting the sparsity penalty.
    num_iters: max number of ISTA/FISTA steps.
    variant: 'ista' or 'fista'.
    initial_codes: optional (b, s) warm start (not mutated).
    early_stopping_epsilon: optional float; stop when the mean absolute
      code change per component, over the stepsize, drops below this
      (after the first iteration).
    nonnegative_only, hard_threshold: threshold variants.
    stepsize: optional precomputed 1/L; skips the eigenvalue solve.
    lipschitz_method: 'eigvalsh' (exact) or 'power'.
    formulation: 'gram' | 'direct' | 'pallas' (the CUDA kernel K1, its
      stop test on the device; CPU tensors take its plain version).
    mxu_precision: the 'pallas' formulation's tier: 'highest' (fp32),
      'bf16x5', 'bf16x3' or 'default' ('bf16', one bf16 pass).

  Returns:
    (b, s) float32 codes on the dictionary's device.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if formulation not in ("gram", "direct", "pallas"):
    raise ValueError("formulation must be 'gram', 'direct' or 'pallas'")
  mxu_precision = resolve_tier(mxu_precision)
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  device = dictionary.device
  images = torch.as_tensor(images, dtype=torch.float32, device=device)
  if initial_codes is not None:
    initial_codes = torch.as_tensor(
        initial_codes, dtype=torch.float32, device=device).contiguous()
  if early_stopping_epsilon is not None:
    early_stopping_epsilon = float(early_stopping_epsilon)
  if stepsize is None:
    stepsize = lipschitz_ops.fista_stepsize(dictionary, lipschitz_method)
  flags = dict(initial_codes=initial_codes, variant=variant,
               nonneg=bool(nonnegative_only), hard=bool(hard_threshold))
  if formulation == "pallas":
    if early_stopping_epsilon is not None and not (
        fused_fista.early_stop_tile_fits(images.shape[0],
                                         dictionary.shape[0])):
      mxu_precision = "highest"
    return fused_fista.fused_fista_solve(
        images, dictionary, float(sparsity_weight), num_iters, stepsize,
        early_stopping_epsilon=early_stopping_epsilon, mxu=mxu_precision,
        **flags)
  if formulation != "direct":
    return fused_fista.fused_fista_plain(
        images, dictionary, float(sparsity_weight), num_iters, stepsize,
        early_stopping_epsilon=early_stopping_epsilon, **flags)
  if initial_codes is None:
    initial_codes = torch.zeros(
        (images.shape[0], dictionary.shape[0]), dtype=torch.float32,
        device=device)
  stepsize = torch.as_tensor(stepsize, dtype=torch.float32, device=device)
  return _solve_direct(images, dictionary, float(sparsity_weight),
                       num_iters, stepsize, initial_codes, variant,
                       bool(nonnegative_only), bool(hard_threshold),
                       early_stopping_epsilon)
