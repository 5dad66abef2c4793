"""Lipschitz constant (largest Gram eigenvalue): counterpart of
vtc_tpu/ops/lipschitz.py:25-117.

Both backends work on whichever of D D^T (s x s) or D^T D (n x n) is
smaller, since the nonzero spectra coincide.  ``eigvalsh`` runs on the
tensor's own device; it is the only one on the encode path
(vtc_tpu/encode.py:204-206).  The power start vector comes from a CPU
``torch.Generator`` seeded by ``seed`` and is moved to the device, so
it is the same on every device -- and differs from
``jax.random.normal(PRNGKey(seed))``: compare eigenvalues, not starts.
"""
import torch

from vtc_tpu_torch.ops.precision import matmul_precision


def _smaller_gram(matrix):
  """Return G = M M^T or M^T M, whichever is smaller."""
  s, n = matrix.shape
  if s <= n:
    return matrix @ matrix.T
  return matrix.T @ matrix


def top_gram_eigenvalue_exact(matrix):
  """Largest eigenvalue of matrix @ matrix.T via eigvalsh (0-d tensor)."""
  with matmul_precision():
    return torch.linalg.eigvalsh(_smaller_gram(matrix))[-1]


def _power(gram, v, num_iters):
  for _ in range(num_iters):
    w = gram @ v
    v = w / torch.linalg.vector_norm(w)
  return v @ (gram @ v), v


def top_gram_eigenvalue_power(matrix, num_iters: int = 50, seed: int = 0):
  """Largest eigenvalue of matrix @ matrix.T via power iteration, from a
  start vector fixed by ``seed``."""
  with matmul_precision():
    gram = _smaller_gram(matrix)
    gen = torch.Generator().manual_seed(int(seed))
    v0 = torch.randn(gram.shape[0], generator=gen, dtype=gram.dtype)
    v0 = v0.to(gram.device)
    return _power(gram, v0 / torch.linalg.vector_norm(v0), num_iters)[0]


def power_iterate(matrix, v, num_iters: int = 4):
  """Refine an eigenvector estimate of the Gram of ``matrix``.

  Returns (top_eigenvalue_estimate, refreshed_unit_eigenvector)."""
  with matmul_precision():
    return power_iterate_gram(_smaller_gram(matrix), v, num_iters)


def power_iterate_gram(gram, v, num_iters: int = 4):
  """``power_iterate`` on a given Gram (n x n): for a Gram summed over the
  row shards of a dictionary.  Returns (eigenvalue estimate, unit
  eigenvector)."""
  with matmul_precision():
    return _power(gram, v / torch.linalg.vector_norm(v), num_iters)


def top_gram_eigenpair(matrix):
  """Exact (top_eigenvalue, unit_eigenvector) of the smaller Gram."""
  with matmul_precision():
    vals, vecs = torch.linalg.eigh(_smaller_gram(matrix))
    return vals[-1], vecs[:, -1]


def top_gram_eigenvalue(matrix, method: str = "eigvalsh"):
  """Dispatch on method in {'eigvalsh', 'power'}."""
  if method == "eigvalsh":
    return top_gram_eigenvalue_exact(matrix)
  if method == "power":
    return top_gram_eigenvalue_power(matrix)
  raise KeyError("Unrecognized lipschitz method: " + method)


def fista_stepsize(dictionary_2d, method: str = "eigvalsh"):
  """1 / L where L is the top eigenvalue of the dictionary Gram matrix
  (a 0-d tensor on the dictionary's device)."""
  return 1.0 / top_gram_eigenvalue(dictionary_2d, method)
