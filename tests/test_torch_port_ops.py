"""vtc_tpu_torch.ops against vtc_tpu.ops on the CPU: precision pins,
thresholds, the proximal-gradient loop and the Lipschitz stepsize.

The same numpy inputs (from a seed) go through the JAX function and its
port.  Tolerance: atol 1e-4, the repo's parity contract (CLAUDE.md);
each test prints the observed max |d|.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtc_tpu.ops import lipschitz as jax_lipschitz
from vtc_tpu.ops import solver as jax_solver
from vtc_tpu.ops import thresholds as jax_thresholds
from vtc_tpu.ops.precision import matmul_precision as jax_precision
from vtc_tpu_torch.ops import lipschitz, precision, solver, thresholds

ATOL = 1e-4


def assert_close(got, want, what, atol=ATOL):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _problem(rng, b=16, s=48, n=32):
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return rng.randn(b, n).astype(np.float32), d


def test_precision_pinned_at_import():
  assert not torch.backends.cuda.matmul.allow_tf32
  assert not torch.backends.cudnn.allow_tf32
  assert torch.get_float32_matmul_precision() == "highest"


def test_precision_context_restores():
  with precision.matmul_precision("tensorfloat32"):
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"
  assert not torch.backends.cuda.matmul.allow_tf32
  assert torch.get_float32_matmul_precision() == "highest"
  with pytest.raises(ValueError):
    with precision.matmul_precision("fastest-ever"):
      pass


def test_precision_env_override():
  script = ("import torch, vtc_tpu_torch; "
            "print(torch.get_float32_matmul_precision(), "
            "torch.backends.cuda.matmul.allow_tf32)")
  env = dict(os.environ, VTC_MATMUL_PRECISION="bfloat16")
  out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, timeout=120, check=True)
  assert out.stdout.split() == ["medium", "True"], out.stdout + out.stderr


@pytest.mark.parametrize("nonneg,hard", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_thresholds_match_jax(rng, nonneg, hard):
  x = rng.randn(64, 40).astype(np.float32)
  x[0, :4] = [0.3, -0.3, 0.0, 0.29999998]  # at and around the threshold
  t = np.float32(0.3)
  want = np.asarray(jax_thresholds.select(nonneg, hard)(jnp.asarray(x), t))
  fn = thresholds.select(nonneg, hard)
  got = fn(torch.from_numpy(x), torch.tensor(t))
  assert got.dtype == torch.float32
  assert fn.__name__ == jax_thresholds.select(nonneg, hard).__name__
  assert_close(got, want, "threshold nonneg=%s hard=%s" % (nonneg, hard),
               atol=0.0)


def _loop_problem(rng):
  x, d = _problem(rng, b=13, s=37, n=24)
  step = np.float32(1.0 / np.linalg.eigvalsh(
      d.astype(np.float64).T @ d)[-1])
  return x, d, step


def _jax_loop(x, d, step, lam, iters, variant, eps, fold):
  x, d = jnp.asarray(x), jnp.asarray(d)
  with jax_precision():
    gram, corr = d @ d.T, x @ d.T
    prestep = (lambda z: z + z @ (-step * gram) + step * corr) if fold \
        else None
    return np.asarray(jax_solver.proximal_gradient_loop(
        lambda z: z @ gram - corr,
        lambda v, ss: jax_thresholds.soft_threshold(v, lam * ss),
        jnp.zeros((x.shape[0], d.shape[0]), jnp.float32),
        jnp.float32(step), iters, variant=variant,
        early_stopping_epsilon=eps, prestep_fn=prestep))


def _torch_loop(x, d, step, lam, iters, variant, eps, fold):
  x, d = torch.from_numpy(x), torch.from_numpy(d)
  eta = torch.tensor(step)
  with precision.matmul_precision():
    gram, corr = d @ d.T, x @ d.T
    prestep = (lambda z: z + z @ (-eta * gram) + eta * corr) if fold \
        else None
    return solver.proximal_gradient_loop(
        lambda z: z @ gram - corr,
        lambda v, ss: thresholds.soft_threshold(v, lam * ss),
        torch.zeros((x.shape[0], d.shape[0])), eta, iters,
        variant=variant, early_stopping_epsilon=eps, prestep_fn=prestep)


@pytest.mark.parametrize("variant", ["ista", "fista"])
@pytest.mark.parametrize("eps", [None, 3e-2])
@pytest.mark.parametrize("fold", [False, True])
def test_solver_loop_matches_jax(rng, variant, eps, fold):
  x, d, step = _loop_problem(rng)
  lam, iters = 0.1, 60
  want = _jax_loop(x, d, step, lam, iters, variant, eps, fold)
  got = _torch_loop(x, d, step, lam, iters, variant, eps, fold)
  assert_close(got, want, "loop %s eps=%s fold=%s" % (variant, eps, fold))
  if eps is not None:
    # the stop really triggered: the full run lands elsewhere
    full = _torch_loop(x, d, step, lam, iters, variant, None, fold)
    assert float((got - full).abs().max()) > 1e-5


def test_solver_rejects_psum_axes_and_bad_variant(rng):
  """psum_axes no longer waits: it is the mesh the stop test averages
  over, asked once per iteration after the first (worlds of 2 and 4 run in
  tests/test_torch_port_parallel.py).  A bad variant is still rejected."""
  x, d, step = _loop_problem(rng)
  x, d, step = torch.from_numpy(x), torch.from_numpy(d), float(step)

  class OneRank:
    calls = 0

    def mean(self, value):
      OneRank.calls += 1
      return value

  def grad_fn(z):
    return (z @ d - x) @ d.T

  def prox_fn(z, ss):
    return thresholds.select(False, False)(z, 0.1 * ss)

  z = torch.zeros(x.shape[0], d.shape[0])
  got = solver.proximal_gradient_loop(grad_fn, prox_fn, z, step, 60,
                                      early_stopping_epsilon=3e-2,
                                      psum_axes=OneRank())
  want = solver.proximal_gradient_loop(grad_fn, prox_fn, z, step, 60,
                                       early_stopping_epsilon=3e-2)
  assert bool((got == want).all())
  assert 1 <= OneRank.calls < 59  # it stopped early, asking each time
  with pytest.raises(ValueError):
    solver.proximal_gradient_loop(None, None, z, 0.1, 3, variant="adam")


def test_fista_momentum_in_float32():
  t = np.float32(1)
  for _ in range(50):
    t, beta = solver.fista_momentum(t)
    assert type(t) is np.float32 and type(beta) is np.float32
  want = np.float32(1)
  for _ in range(50):
    want = (np.float32(1) + np.sqrt(np.float32(1) + np.float32(4) * want
                                    * want)) / np.float32(2)
  assert t == want


@pytest.mark.parametrize("shape", [(48, 32), (24, 40)])
def test_lipschitz_matches_jax(rng, shape):
  d = rng.randn(*shape).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  dj, dt = jnp.asarray(d), torch.from_numpy(d)
  exact = float(jax_lipschitz.top_gram_eigenvalue_exact(dj))
  assert_close(float(lipschitz.top_gram_eigenvalue_exact(dt)), exact,
               "eigvalsh")
  # power iteration: different start vectors, same converged eigenvalue
  assert_close(float(lipschitz.top_gram_eigenvalue_power(dt, 500)),
               float(jax_lipschitz.top_gram_eigenvalue_power(dj, 500)),
               "power", atol=1e-3 * exact)
  assert_close(float(lipschitz.fista_stepsize(dt)),
               float(jax_lipschitz.fista_stepsize(dj)), "stepsize")
  assert_close(float(lipschitz.fista_stepsize(dt, "power")),
               float(jax_lipschitz.fista_stepsize(dj, "power")),
               "power stepsize", atol=1e-3 / exact)
  val, vec = lipschitz.top_gram_eigenpair(dt)
  jval, jvec = jax_lipschitz.top_gram_eigenpair(dj)
  assert_close(float(val), float(jval), "eigenpair value")
  assert_close(abs(float(vec @ torch.tensor(np.array(jvec)))), 1.0,
               "eigenpair |cos|")
  v0 = rng.randn(min(shape)).astype(np.float32)
  pval, pvec = lipschitz.power_iterate(dt, torch.from_numpy(v0), 4)
  jpval, jpvec = jax_lipschitz.power_iterate(dj, jnp.asarray(v0), 4)
  assert_close(float(pval), float(jpval), "power_iterate value")
  assert_close(pvec, jpvec, "power_iterate vector")
  with pytest.raises(KeyError):
    lipschitz.top_gram_eigenvalue(dt, "lanczos")
