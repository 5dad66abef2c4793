"""The K2 port (vtc_tpu_torch/ops/fused_train_step.py) against the TPU
kernel on the CPU.

``fused_train_segment`` on CPU tensors runs its plain version, which is
held against ``vtc_tpu.ops.pallas_train_step.fused_train_segment_pallas``
in interpret mode, as tests/test_pallas_train_step.py runs it: its
single-tile kernel and, with ``batch_tile=8``, its batch-tiled kernel.
Inputs come from a seed with numpy, at s = 24, n = 16, b = 10, k = 3 as in
the JAX tests.  Tolerances are the JAX test's own, for the same reason:
2e-5 after one step; over several steps FISTA with the cheap-quadratic
update turns ~1e-7 rounding differences into shrinkage-threshold flips,
so there the codes get 5e-3 and the Hessian EMA 1e-3, everything else
2e-5.  The CUDA kernels run only on a card: their tests skip here.
"""
import numpy as np
import pytest
import torch

from vtc_tpu.ops.pallas_train_step import fused_train_segment_pallas
from vtc_tpu_torch.ops import fused_train_step, lipschitz

NAMES = ("dict", "hessian", "eigvec", "codes")
STRICT = 2e-5


def assert_close(got, want, what, atol):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _problem(rng, k=3, b=10, s=24, n=16):
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  batches = rng.randn(k, b, n).astype(np.float32)
  h = np.abs(rng.rand(s)).astype(np.float32) * 0.01
  v = rng.randn(min(s, n)).astype(np.float32)
  return d, h, v, batches


def _port(d, h, v, batches, *args, **kwargs):
  out = fused_train_step.fused_train_segment(
      *map(torch.from_numpy, (d, h, v, batches)), *args, **kwargs)
  return [t.numpy() for t in out]


def _pallas(*args, **kwargs):
  return [np.asarray(t) for t in fused_train_segment_pallas(
      *args, interpret=True, **kwargs)]


@pytest.mark.parametrize("variant,update_alg", [
    ("fista", "sc_cheap_quadratic_descent"),
    ("fista", "sc_steepest_descent"),
    ("ista", "sc_cheap_quadratic_descent"),
])
@pytest.mark.parametrize("batch_tile", [None, 8])
def test_matches_pallas(rng, variant, update_alg, batch_tile):
  d, h, v, batches = _problem(rng)
  flags = dict(variant=variant, update_alg=update_alg, power_iters=2)
  want = _pallas(d, h, v, batches[:1], 0.05, 12, 0.1,
                 batch_tile=batch_tile, **flags)
  got = _port(d, h, v, batches[:1], 0.05, 12, 0.1, **flags)
  for w, g, name in zip(want, got, NAMES):
    assert g.shape == w.shape and g.dtype == np.float32
    assert_close(g, w, "1 step %s tile=%s %s" % (flags, batch_tile, name),
                 STRICT)
  want = _pallas(d, h, v, batches, 0.05, 12, 0.1, batch_tile=batch_tile,
                 **flags)
  got = _port(d, h, v, batches, 0.05, 12, 0.1, **flags)
  chaotic = variant == "fista" and update_alg == "sc_cheap_quadratic_descent"
  tols = {"dict": STRICT, "hessian": 1e-3 if chaotic else STRICT,
          "eigvec": STRICT, "codes": 5e-3 if chaotic else STRICT}
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, "3 steps %s tile=%s %s" % (flags, batch_tile, name),
                 tols[name])


def test_overcomplete_multi_update(rng):
  """s > n: the n x n power Gram; upd_num_iters=3: the inner descent."""
  d, h, v, batches = _problem(rng, k=2, b=7, s=33, n=12)
  want = _pallas(d, h, v, batches, 0.03, 8, 0.05, upd_num_iters=3,
                 power_iters=2)
  got = _port(d, h, v, batches, 0.03, 8, 0.05, upd_num_iters=3,
              power_iters=2)
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, "overcomplete upd3 " + name, STRICT)


def test_nonneg_and_hard(rng):
  d, h, v, batches = _problem(rng, k=2)
  want = _pallas(d, h, v, batches, 0.05, 10, 0.1, nonneg=True,
                 power_iters=2)
  got = _port(d, h, v, batches, 0.05, 10, 0.1, nonneg=True, power_iters=2)
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, "nonneg " + name, STRICT)
  want = _pallas(d, h, v, batches[:1], 0.05, 10, 0.1, hard=True,
                 update_alg="sc_steepest_descent", power_iters=2)
  got = _port(d, h, v, batches[:1], 0.05, 10, 0.1, hard=True,
              update_alg="sc_steepest_descent", power_iters=2)
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, "hard " + name, STRICT)


def test_plain_version_in_float64_and_no_renorm(rng):
  """The plain version keeps the inputs' type (float64 is the oracle the
  card's kernels are held against), and renormalize=False leaves the
  row norms free."""
  d, h, v, batches = _problem(rng, k=2)
  args = [torch.from_numpy(a).double() for a in (d, h, v, batches)]
  out = fused_train_step.fused_train_segment_plain(
      *args, 0.05, 12, 0.1, power_iters=2)
  assert all(t.dtype == torch.float64 for t in out)
  f32 = _port(d, h, v, batches, 0.05, 12, 0.1, power_iters=2)
  assert_close(out[0], f32[0], "fp64 vs fp32 dict", 1e-4)
  free = _port(d, h, v, batches, 0.05, 12, 0.1, power_iters=2,
               renormalize=False)
  want = _pallas(d, h, v, batches, 0.05, 12, 0.1, power_iters=2,
                 renormalize=False)
  assert_close(free[0], want[0], "no renorm dict", STRICT)
  assert np.abs(np.linalg.norm(free[0], axis=1) - 1.0).max() > 1e-4


def test_inputs_are_not_modified_and_stepsize_returned(rng):
  d, h, v, batches = _problem(rng, k=2)
  tensors = [torch.from_numpy(a.copy()) for a in (d, h, v, batches)]
  out = fused_train_step.fused_train_segment(*tensors, 0.05, 12, 0.1,
                                             power_iters=2,
                                             return_stepsize=True)
  for t, a in zip(tensors, (d, h, v, batches)):
    assert np.array_equal(t.numpy(), a)
  # the last step's stepsize: 1/eigval of the refresh from the dictionary
  # the first step left
  first = fused_train_step.fused_train_segment(
      *(t[:1] if i == 3 else t for i, t in enumerate(tensors)), 0.05, 12,
      0.1, power_iters=2)
  eig, _ = lipschitz.power_iterate(first[0], first[2], 2)
  assert out[4].shape == (1,)
  assert_close(out[4], 1.0 / eig, "last stepsize", 1e-7)


def test_early_stop_on_cpu_runs_the_plain_stop_test(rng):
  d, h, v, batches = _problem(rng, k=2)
  full = _port(d, h, v, batches, 0.05, 60, 0.01, power_iters=2)
  stopped = _port(d, h, v, batches, 0.05, 60, 0.01, power_iters=2,
                  early_stopping_epsilon=5e-2)
  assert np.abs(full[3] - stopped[3]).max() > 1e-6


def test_wrapper_refuses_what_it_does_not_run(rng):
  d, h, v, batches = (torch.from_numpy(a) for a in _problem(rng, k=1))
  # the tiers run (tests/test_torch_port_tiers.py); an unknown
  # tier is refused
  full = fused_train_step.fused_train_segment(d, h, v, batches, 0.05, 5, 0.1)
  tier = fused_train_step.fused_train_segment(d, h, v, batches, 0.05, 5, 0.1,
                                              mxu="bf16x3")
  assert 0.0 < float((tier[0] - full[0]).abs().max()) < 1e-3
  with pytest.raises(ValueError, match="tier"):
    fused_train_step.fused_train_segment(d, h, v, batches, 0.05, 5, 0.1,
                                         mxu="tf32x3")
  with pytest.raises(ValueError):
    fused_train_step.fused_train_segment(d, h, v, batches, 0.05, 5, 0.1,
                                         variant="adam")
  with pytest.raises(ValueError):
    fused_train_step.fused_train_segment(d, h, v, batches, 0.05, 5, 0.1,
                                         update_alg="ica")
  with pytest.raises(ValueError, match="k >= 1"):
    fused_train_step.fused_train_segment(d, h, v, batches[:0], 0.05, 5,
                                         0.1)
  # neither CPU nor CUDA: no silent plain path
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fused_train_step.fused_train_segment(
        *(t.to("meta") for t in (d, h, v, batches)), 0.05, 5, 0.1)
  assert fused_train_step.launches == 0  # CPU tensors never count


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the fused train kernels have no CPU "
                "mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_early_stop_raises(rng):
  # the stop now runs on the card: K2 with it matches its plain version,
  # and the step counts agree with the plain loop's
  dev = _cuda_device()
  arrays = _problem(rng, k=2)
  flags = dict(early_stopping_epsilon=5e-2, power_iters=2)
  before = fused_train_step.launches
  got = fused_train_step.fused_train_segment(
      *(torch.from_numpy(a).to(dev) for a in arrays), 0.05, 60, 0.01,
      **flags)
  assert fused_train_step.launches == before + 2
  assert fused_train_step.last_iters.shape == (2,)
  want = _port(*arrays, 0.05, 60, 0.01, **flags)
  for g, w, what in zip(got, want, ("dictionary", "hessian", "eigvec",
                                    "codes")):
    assert_close(g.cpu(), w, "K2 early stop " + what, 1e-4)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(rng):
  """The kernels against their plain version on the card, one step
  (chip_smoke.py runs the full set at the flagship width)."""
  dev = _cuda_device()
  for k, b, s, n in ((1, 13, 37, 24), (1, 20, 33, 12)):
    arrays = _problem(rng, k=k, b=b, s=s, n=n)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    before = fused_train_step.launches
    got = fused_train_step.fused_train_segment(*args, 0.05, 12, 0.1,
                                               power_iters=2)
    assert fused_train_step.launches == before + k
    want = fused_train_step.fused_train_segment_plain(*args, 0.05, 12, 0.1,
                                                      power_iters=2)
    for g, w, name in zip(got, want, NAMES):
      assert_close(g.cpu(), w.cpu(), "cuda %dx%dx%d %s" % (b, s, n, name),
                   STRICT)
