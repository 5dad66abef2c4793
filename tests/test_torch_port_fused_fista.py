"""The K1 port (vtc_tpu_torch/ops/fused_fista.py) against the TPU kernel
and the float64 oracle.

On the CPU, ``fused_fista_plain`` and ``fused_fista_solve`` (which takes
the plain version for CPU tensors) are held against
``vtc_tpu.ops.pallas_fista.fista_solve_pallas`` in interpret mode, run
as tests/test_pallas_fista.py runs it, and against
``numpy_oracle.fc_ista_fista``.  The CUDA kernel itself runs only on a
card: its comparison skips here.  Tolerance: atol 1e-4, the repo's
parity contract (CLAUDE.md); each test prints the observed max |d|.
"""
import os

import numpy as np
import pytest
import torch

from vtc_tpu.ops.pallas_fista import fista_solve_pallas
from vtc_tpu_torch.ops import _build, fused_fista

import numpy_oracle as oracle

ATOL = 1e-4


def assert_close(got, want, what, atol=ATOL):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _problem(rng, b=16, s=48, n=32):
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = rng.randn(b, n)
  step = np.float32(oracle.fc_stepsize(d.astype(np.float32)
                                       .astype(np.float64)))
  return x.astype(np.float32), d.astype(np.float32), step


def _port(fn, x, d, lam, iters, step, init=None, **flags):
  return fn(torch.from_numpy(x), torch.from_numpy(d), lam, iters,
            torch.tensor(step),
            initial_codes=None if init is None else torch.from_numpy(init),
            **flags).numpy()


def _pallas(x, d, lam, iters, step, init=None, **flags):
  return np.asarray(fista_solve_pallas(
      x, d, lam, iters, step, initial_codes=init, batch_tile=8,
      interpret=True, **flags))


CASES = [  # (variant, nonneg, hard)
    ("fista", False, False), ("ista", False, False),
    ("fista", True, False), ("fista", False, True), ("ista", True, True),
]


@pytest.mark.parametrize("variant,nonneg,hard", CASES)
@pytest.mark.parametrize("fn", ["plain", "solve"])
def test_matches_pallas_and_oracle(rng, fn, variant, nonneg, hard):
  x, d, step = _problem(rng)
  lam, iters = 0.1, 25
  flags = dict(variant=variant, nonneg=nonneg, hard=hard)
  got = _port(getattr(fused_fista, "fused_fista_" + fn), x, d, lam, iters,
              step, **flags)
  want = oracle.fc_ista_fista(x.astype(np.float64), d.astype(np.float64),
                              lam, iters, variant, nonneg=nonneg, hard=hard)
  assert_close(got, want, "%s vs oracle %s" % (fn, flags))
  assert_close(got, _pallas(x, d, lam, iters, step, **flags),
               "%s vs pallas %s" % (fn, flags))


def test_warm_start(rng):
  x, d, step = _problem(rng)
  lam = 0.1
  init = oracle.fc_ista_fista(x.astype(np.float64), d.astype(np.float64),
                              lam, 30, "fista").astype(np.float32)
  got = _port(fused_fista.fused_fista_solve, x, d, lam, 5, step, init)
  want = oracle.fc_ista_fista(x.astype(np.float64), d.astype(np.float64),
                              lam, 5, "fista",
                              initial_codes=init.astype(np.float64))
  assert_close(got, want, "warm start vs oracle")
  assert_close(got, _pallas(x, d, lam, 5, step, init), "warm vs pallas")


def test_ragged_shape(rng):
  x, d, step = _problem(rng, b=13, s=37, n=24)
  lam, iters = 0.08, 20
  got = _port(fused_fista.fused_fista_solve, x, d, lam, iters, step)
  assert got.shape == (13, 37)
  assert_close(got, oracle.fc_ista_fista(
      x.astype(np.float64), d.astype(np.float64), lam, iters, "fista"),
               "ragged vs oracle")
  assert_close(got, _pallas(x, d, lam, iters, step), "ragged vs pallas")


def test_num_iters_is_dynamic(rng):
  """num_iters is a runtime argument; zero iterations return the start,
  and more iterations converge closer to the long-run solution."""
  x, d, step = _problem(rng)
  lam = 0.1
  ref = oracle.fc_ista_fista(x.astype(np.float64), d.astype(np.float64),
                             lam, 2000, "fista")
  init = np.full((16, 48), 0.5, np.float32)
  assert np.array_equal(
      _port(fused_fista.fused_fista_solve, x, d, lam, 0, step, init), init)
  dists = []
  for k in (5, 25, 100):
    got = _port(fused_fista.fused_fista_solve, x, d, lam, k, step)
    assert_close(got, _pallas(x, d, lam, k, step), "num_iters=%d" % k)
    dists.append(np.linalg.norm(got - ref))
  assert dists[2] < dists[1] < dists[0]


def test_wrapper_refuses_what_it_does_not_run(rng):
  x, d, step = _problem(rng)
  xt, dt = torch.from_numpy(x), torch.from_numpy(d)
  # the early stop runs on CPU tensors too: the plain version's stop test
  stopped = fused_fista.fused_fista_solve(xt, dt, 0.1, 50, step,
                                          early_stopping_epsilon=1e-3)
  assert torch.equal(stopped, fused_fista.fused_fista_plain(
      xt, dt, 0.1, 50, step, early_stopping_epsilon=1e-3))
  with pytest.raises(ValueError):
    fused_fista.fused_fista_solve(xt, dt, 0.1, 5, step, variant="adam")
  # neither CPU nor CUDA: no silent plain path
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fused_fista.fused_fista_solve(xt.to("meta"), dt.to("meta"), 0.1, 5,
                                  step)
  assert fused_fista.launches == 0  # CPU tensors never count a launch


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  monkeypatch.setenv("PATH", str(tmp_path))
  assert _build.find_nvcc() is None
  with pytest.raises(_build.BuildError, match="nvcc not found"):
    _build.build(build_dir=tmp_path / "build")
  assert not (tmp_path / "build").exists()


def test_build_raises_with_compiler_output(tmp_path, monkeypatch):
  fake = tmp_path / "bin" / "nvcc"
  fake.parent.mkdir()
  fake.write_text("#!/bin/sh\necho 'fused_fista.cu(1): error: broken' >&2"
                  "\nexit 2\n")
  fake.chmod(0o755)
  monkeypatch.setenv("CUDA_HOME", str(tmp_path))
  with pytest.raises(_build.BuildError, match="error: broken"):
    _build.build(build_dir=tmp_path / "build")
  assert os.listdir(tmp_path / "build") == []  # no half-written library


def test_kernel_matches_plain_on_cuda(rng):
  """The CUDA kernel against its plain version on the card (ragged and
  flagship-width shapes); chip_smoke.py runs the full set."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  dev = torch.device("cuda", 0)
  for b, s, n in ((13, 37, 24), (250, 256, 256)):
    x, d, step = _problem(rng, b, s, n)
    args = (torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev), 0.08,
            25, torch.tensor(step, device=dev))
    before = fused_fista.launches
    got = fused_fista.fused_fista_solve(*args)
    assert fused_fista.launches == before + 1
    want = fused_fista.fused_fista_plain(*args)
    assert_close(got.cpu(), want.cpu(), "cuda kernel %dx%dx%d" % (b, s, n))
