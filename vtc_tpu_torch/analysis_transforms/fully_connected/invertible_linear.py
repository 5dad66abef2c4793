"""Exact linear analysis transform of a square dictionary: counterpart of
vtc_tpu/analysis_transforms/fully_connected/invertible_linear.py:1-129.

``codes = X D^{-1}`` is the solution of ``codes D = X``, i.e. of
``D^T codes^T = X^T``: a linear solve instead of an explicit inverse.  The
ICA trainers track the inverse warm with Newton-Schulz refinements
(``newton_refine_inverse``) under a residual guard with an LU fallback
(``refine_inverse_guarded``).  A singular dictionary gives non-finite
values here, as it does in vtc_tpu, instead of raising.

The refinements' ``precision`` is vtc_tpu's XLA spelling with the TPU's
meaning (vtc_tpu/training/ica.py:126-128): 'tensorfloat32' is the 3-pass
bf16x3 product and 'bfloat16' the single bf16 pass, both computed as
``ops/precision.ns_dot`` computes them, never as torch's TF32.  On the
CPU vtc_tpu's XLA runs every precision in float32, so the CPU tests hold
these passes to vtc_tpu's fused ICA kernel at the same tier, which runs
the same passes.
"""
import torch

from vtc_tpu_torch.ops.precision import matmul_precision, ns_dot, xla_tier


def _solve_nonortho(images, dictionary):
  """codes with codes @ dictionary = images."""
  with matmul_precision():
    return torch.linalg.solve_ex(dictionary.T, images.T)[0].T


def _solve_ortho(images, dictionary):
  with matmul_precision():
    return images @ dictionary.T


def exact_inverse(dictionary):
  """D^{-1} by LU: the warm-tracking seed (once per training run)."""
  with matmul_precision():
    return torch.linalg.inv_ex(dictionary)[0]


def newton_refine_inverse(dictionary, inverse_estimate, num_iters=5,
                          precision=None):
  """Warm inverse tracking: ``X <- X (2I - D X)`` num_iters times, which
  squares the residual ``I - D X`` each time.  ``precision`` is the
  refinements' XLA precision (default 'highest'; see the module
  docstring)."""
  return newton_refine_tier(dictionary, inverse_estimate, num_iters,
                            xla_tier(precision))


def newton_refine_tier(dictionary, inverse_estimate, num_iters, mxu,
                       precision=None):
  """``newton_refine_inverse`` with each product at the tier ``mxu``
  (``ns_dot``, vtc_tpu's fused ICA kernel's ``ns_body``,
  pallas_ica_train.py:142-143); at 'highest' the products run at the
  matmul ``precision`` (torch's meaning, default 'highest')."""
  x = inverse_estimate
  eye2 = 2.0 * torch.eye(dictionary.shape[0], dtype=x.dtype, device=x.device)
  for _ in range(int(num_iters)):
    x = ns_dot(x, eye2 - ns_dot(dictionary, x, mxu, precision), mxu,
               precision)
  return x


def inverse_residual(dictionary, inverse_estimate):
  """max |D X - I| at parity precision (a 0-d tensor; NaN stays NaN)."""
  with matmul_precision():
    eye = torch.eye(dictionary.shape[0], dtype=inverse_estimate.dtype,
                    device=inverse_estimate.device)
    return torch.max(torch.abs(dictionary @ inverse_estimate - eye))


def refine_inverse_guarded(dictionary, inverse_estimate, num_iters=5,
                           residual_tol=1e-3, precision=None,
                           boost_tol=None):
  """``newton_refine_inverse`` with vtc_tpu's divergence guard (:65-110).

  After the refinements the residual max|D X - I| is checked at parity
  precision.  With ``boost_tol``, a residual above it runs two more
  refinements and is recomputed (a NaN residual skips the boost).  Then
  ``not (resid < residual_tol)`` -- so that a NaN residual also takes it --
  falls back to the exact LU inverse.  The two branches are decided on
  the host, one synchronization each.
  """
  x = newton_refine_inverse(dictionary, inverse_estimate, num_iters,
                            precision=precision)
  resid = inverse_residual(dictionary, x)
  if boost_tol is not None and bool(resid > boost_tol):
    x = newton_refine_inverse(dictionary, x, 2, precision=precision)
    resid = inverse_residual(dictionary, x)
  if not bool(resid < residual_tol):
    return exact_inverse(dictionary)
  return x


def run(images, dictionary, orthonormal=False):
  """Infer codes via the exact inverse of a square dictionary.

  Args:
    images: (b, n) batch of flattened images (a tensor, or anything numpy
      reads, moved to the dictionary's device).
    dictionary: (n, n) square dictionary tensor.
    orthonormal: use the transpose (exact for orthonormal dictionaries).

  Returns:
    (b, n) float32 codes on the dictionary's device.
  """
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32)
  images = torch.as_tensor(images, dtype=torch.float32,
                           device=dictionary.device)
  if orthonormal:
    return _solve_ortho(images, dictionary)
  return _solve_nonortho(images, dictionary)
