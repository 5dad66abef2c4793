"""The conv family's early stop (K10, K11, K12, K17) against vtc_tpu on the
CPU.

vtc_tpu runs the batch-global stop test inside its conv kernels: after
iteration k > 0 a solve ends when (sum |codes_k - codes_{k-1}| / count) /
eta < eps, and returns codes_k.  The port runs it inside its CUDA kernels
(csrc/conv_gemm.cuh, "The early stop"); a CPU tensor takes each kernel's
plain version with the stop, which this file holds to vtc_tpu:

* K10's plain version against ``conv_direct_solve_pallas(...,
  early_stopping_epsilon=, interpret=True)``, FISTA and ISTA, soft, nonneg
  and hard thresholds, at a geometry whose kernels are stride multiples
  and at a zero-extended one, each with an eps that stops at k = 1, one
  that stops mid-run and 0 (never);
* K11's plain version against vtc_tpu's ``run(formulation='gram')`` with
  the same eps, and ``run('pallas')`` off K10's gate (K11) against
  vtc_tpu's;
* K12's plain segment against ``fused_conv_train_segment_pallas`` with
  eps, and K17's at a world of 1 against ``fused_conv_dp_train_segment_
  pallas`` with eps on a one-device axis; K17 at worlds 2 and 4 (spawned
  ranks, tests/torch_port_dp_worker.py) against vtc_tpu's K17 on as many
  of its CPU devices, every rank bitwise equal;
* the trainers' routing with eps: the data-parallel scanned trainer takes
  K17 with the stop where vtc_tpu takes its K17 with the stop
  (vtc_tpu tests/test_conv_early_stop.py:208), the single-device one
  matches vtc_tpu's fused K12 with the stop (:157), the per-batch trainer
  K10's stop.

The eps of a case come from the port's plain means (``solver.last_avgs``):
1.5 times the first (stops at k = 1), the geometric mean of a new low and
the lowest mean before it (mid-run, a few percent from either), or 0.
Tolerance: 1e-4 of the largest code (the repo's parity contract) for
solves; the conv trainers' state at vtc_tpu's own bounds
(tests/test_torch_port_conv_scanned.py's, 2e-5 relative for one step);
the trainers at vtc_tpu's 5e-5.  The card's checks are chip_smoke.py's
phase 44.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

import torch_port_dp_worker as worker
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.analysis_transforms.convolutional import (
    ista_fista as jax_conv_ista_fista)
from vtc_tpu.ops import lipschitz as jax_lip
from vtc_tpu.ops import pallas_conv_direct
from vtc_tpu.ops import pallas_conv_dp_train as jax_conv_dp
from vtc_tpu.ops import pallas_conv_train as jax_k12
from vtc_tpu.training import compiled_epoch as jax_compiled_epoch
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu_torch import parallel
from vtc_tpu_torch.analysis_transforms.convolutional import ista_fista
from vtc_tpu_torch.ops import (conv_shapes, fused_conv_direct,
                               fused_conv_dp_train, fused_conv_fista,
                               fused_conv_train, solver)
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import sparse_coding as sc

ATOL = 1e-4
ITERS = 40
LAM = 0.05
STOPS = ("early", "mid", "never")
MODES = {"soft": {}, "nonneg": {"nonneg": True}, "hard": {"hard": True}}
CQ, SD = "sc_cheap_quadratic_descent", "sc_steepest_descent"


def assert_close(got, want, what, rel=ATOL):
  """|got - want| <= rel * max(1, max |want|) everywhere."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want, np.float64)
  err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
  bound = rel * max(1.0, float(np.abs(want).max()))
  print("%s: max|d| = %.3e (bound %.1e)" % (what, err, bound))
  assert err <= bound, "%s: max|d| %.3e > %.1e" % (what, err, bound)


def stop_eps(avgs, which):
  """An eps from a plain run's means (avgs[k - 1] after iteration k):
  'early' stops at k = 1, 'mid' at the first new low past the first
  quarter 5% under every earlier mean, 'never' is 0."""
  if which == "never":
    return 0.0
  if which == "early":
    return 1.5 * avgs[0]
  for k in range(max(2, len(avgs) // 4), len(avgs)):
    low = min(avgs[:k])
    if avgs[k] < 0.95 * low:
      return float(np.sqrt(avgs[k] * low))
  raise AssertionError("no clear new low in %s" % (avgs,))


def check_count(which, iters, what):
  """The plain loop's count: 2 at 'early', past 2 and short of ITERS at
  'mid', ITERS at 'never'."""
  want = {"early": lambda n: n == 2, "mid": lambda n: 2 < n < ITERS,
          "never": lambda n: n == ITERS}[which]
  assert want(iters), "%s: %d iterations at eps %s" % (what, iters, which)


def _t(x):
  return torch.from_numpy(np.array(x, dtype=np.float32))


def _images(rng, b, c, img, padding, scale=0.3):
  (lv, tv), (lh, th) = padding
  x = np.zeros((b, c, img + lv + tv, img + lh + th), np.float32)
  x[:, :, lv:lv + img, lh:lh + img] = scale * rng.randn(b, c, img, img)
  return x


def _kernels(rng, s, c, k, sigma=None):
  d = rng.randn(s, c, k, k)
  if sigma is not None:  # a Gaussian window: localized kernels
    yy = np.arange(k) - (k - 1) / 2.0
    d = d * np.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * sigma ** 2))
  return (d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))).astype(
      np.float32)


def _step(d):
  """1/L of the flattened kernels, vtc_tpu's 'eigvalsh' stepsize."""
  return float(jax_lip.fista_stepsize(jnp.asarray(d).reshape(d.shape[0], -1),
                                      "eigvalsh"))


def _solve_problem(name):
  """(x, d, stride, padding, stepsize) of a K10 geometry: 4x4 kernels at
  stride 4 (stride multiples, the flat-kernel stepsize exact, as vtc_tpu's
  conv stop tests), or 3x3 kernels at stride 2, zero-extended to 4x4, at
  half the flat-kernel stepsize (overlapping tiles)."""
  rng = np.random.RandomState(18)
  if name == "4x4/4":
    pad = conv_shapes.get_padding_amt(16, 4, 4)
    x, d = _images(rng, 4, 1, 16, (pad, pad)), _kernels(rng, 8, 1, 4)
    return x, d, (4, 4), (pad, pad), _step(d)
  padding = ((1, 2), (1, 2))  # (15 - 3) % 2 == 0
  x, d = _images(rng, 3, 1, 12, padding), _kernels(rng, 6, 1, 3, sigma=0.8)
  return x, d, (2, 2), padding, 0.5 * _step(d)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("variant", ["fista", "ista"])
@pytest.mark.parametrize("geo", ["4x4/4", "3x3/2 zero-extended"])
def test_k10_stop_matches_the_pallas_kernel(geo, variant, mode):
  x, d, stride, padding, step = _solve_problem(geo)
  geometry = fused_conv_direct.geometry(x.shape, d.shape, stride)
  assert (geometry["ekh"] > 0) == ("zero" in geo)
  assert pallas_conv_direct.early_stop_supported(x.shape, d.shape, stride)
  kw = dict(kernel_stride=stride, padding=padding, variant=variant,
            **MODES[mode])
  xt, dt = _t(x), _t(d)
  fused_conv_direct.fused_conv_direct_plain(xt, dt, LAM, ITERS, step,
                                            early_stopping_epsilon=0.0, **kw)
  avgs = list(solver.last_avgs)
  for which in STOPS:
    eps = stop_eps(avgs, which)
    label = "K10 %s %s %s eps %s" % (geo, variant, mode, which)
    got = fused_conv_direct.fused_conv_direct_solve(
        xt, dt, LAM, ITERS, step, early_stopping_epsilon=eps, **kw)
    check_count(which, solver.last_iters, label)
    plain = fused_conv_direct.fused_conv_direct_plain(
        xt, dt, LAM, ITERS, step, early_stopping_epsilon=eps, **kw)
    assert torch.equal(got, plain)  # a CPU tensor: the plain version
    want = np.asarray(pallas_conv_direct.conv_direct_solve_pallas(
        jnp.asarray(x), jnp.asarray(d), LAM, ITERS, step, interpret=True,
        early_stopping_epsilon=eps, **kw))
    assert_close(got, want, label)
  assert fused_conv_direct.launches == 0


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("variant", ["fista", "ista"])
def test_k11_stop_matches_the_gram_run(variant, mode):
  """K11's plain version with the stop against vtc_tpu's 'gram' run, at a
  geometry with border corrections."""
  rng = np.random.RandomState(11)
  padding = ((2, 2), (2, 2))
  x, d = _images(rng, 3, 1, 12, padding), _kernels(rng, 6, 1, 4, sigma=0.8)
  step = 0.5 * _step(d)
  kw = dict(variant=variant, nonnegative_only=mode == "nonneg",
            hard_threshold=mode == "hard", stepsize=step)
  flags = dict(kernel_stride=(2, 2), padding=padding, variant=variant,
               **MODES[mode])
  fused_conv_fista.fused_conv_fista_plain(_t(x), _t(d), LAM, ITERS, step,
                                          early_stopping_epsilon=0.0,
                                          **flags)
  avgs = list(solver.last_avgs)
  for which in STOPS:
    eps = stop_eps(avgs, which)
    label = "K11 %s %s eps %s" % (variant, mode, which)
    got = fused_conv_fista.fused_conv_fista_solve(
        _t(x), _t(d), LAM, ITERS, step, early_stopping_epsilon=eps, **flags)
    check_count(which, solver.last_iters, label)
    want = np.asarray(jax_conv_ista_fista.run(
        x, d, (2, 2), padding, LAM, ITERS, early_stopping_epsilon=eps,
        formulation="gram", **kw))
    assert_close(got, want, label)
  assert fused_conv_fista.launches == 0


def test_run_pallas_off_the_k10_gate_takes_k11_with_the_stop():
  """run('pallas') off K10's gate (c * sv * sh = 12 * 8 * 8 > 512) takes
  K11 (its plain version here) with the stop, against vtc_tpu's 'pallas',
  which runs its gram loop with the stop there."""
  rng = np.random.RandomState(12)
  variant, mode = "fista", "soft"
  kw = dict(variant=variant, nonnegative_only=False, hard_threshold=False)
  x12 = _images(rng, 2, 12, 16, ((8, 8), (8, 8)))
  d12 = _kernels(rng, 4, 12, 16, sigma=3.0)
  assert not fused_conv_direct.supported(x12.shape, d12.shape, (8, 8))
  step12 = 0.5 * _step(d12)
  kw12 = dict(kw, stepsize=step12)
  fused_conv_fista.fused_conv_fista_plain(
      _t(x12), _t(d12), LAM, ITERS, step12, early_stopping_epsilon=0.0,
      kernel_stride=(8, 8), padding=((8, 8), (8, 8)), variant=variant,
      **MODES[mode])
  eps = stop_eps(list(solver.last_avgs), "mid")
  got = ista_fista.run(x12, _t(d12), (8, 8), ((8, 8), (8, 8)), LAM, ITERS,
                       early_stopping_epsilon=eps, formulation="pallas",
                       **kw12)
  check_count("mid", solver.last_iters, "run('pallas') off K10's gate")
  want = np.asarray(jax_conv_ista_fista.run(
      x12, d12, (8, 8), ((8, 8), (8, 8)), LAM, ITERS,
      early_stopping_epsilon=eps, formulation="pallas", **kw12))
  assert_close(got, want, "run('pallas') off K10's gate %s %s" % (variant,
                                                                   mode))
  assert fused_conv_fista.launches == fused_conv_direct.launches == 0


# ---------------------------------------------------------------------------
# K12 and K17: vtc_tpu's conv stop problem (tests/test_conv_early_stop.py:
# 25-42), stride equal to the kernel, so FISTA converges and the stop fires
# ---------------------------------------------------------------------------
SEG_EPS = 5e-3  # vtc_tpu's


def _segment_problem(seed=0, k=3, b=4, s=8, kdim=4, stride=4, img=16):
  rng = np.random.RandomState(seed)
  pad = conv_shapes.get_padding_amt(img, kdim, stride)
  x = np.stack([_images(rng, b, 1, img, (pad, pad)) for _ in range(k)])
  d = _kernels(rng, s, 1, kdim)
  h = (np.abs(rng.rand(s)) * 0.01).astype(np.float32)
  v = rng.randn(s).astype(np.float32)
  return dict(d=d, h=h, v=v, x=x, stride=(stride, stride),
              padding=(pad, pad))


SEGMENT = _segment_problem()
NAMES = ("dictionary", "hessian", "eigvec", "codes")


@pytest.mark.parametrize("variant,update_alg,eps", [
    ("fista", CQ, SEG_EPS), ("fista", SD, SEG_EPS), ("ista", CQ, SEG_EPS),
    ("fista", CQ, 10.0), ("fista", CQ, 0.0)])
def test_k12_stop_matches_the_pallas_kernel(variant, update_alg, eps):
  p = SEGMENT
  kw = dict(kernel_stride=p["stride"], padding=p["padding"], power_iters=2,
            variant=variant, update_alg=update_alg,
            early_stopping_epsilon=eps)
  want = jax_k12.fused_conv_train_segment_pallas(
      p["d"], p["h"], p["v"], p["x"], LAM, ITERS, 0.02, interpret=True, **kw)
  got = fused_conv_train.fused_conv_train_segment(
      _t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), LAM, ITERS, 0.02, **kw)
  # the last step's solve: k = 1 at eps 10, the whole run at 0, else between
  which = {10.0: "early", 0.0: "never"}.get(eps, "mid")
  check_count(which, solver.last_iters, "K12 %s %s" % (variant, update_alg))
  for g, w, name in zip(got, want, NAMES):
    assert_close(g, np.asarray(w), "K12 eps %g %s %s %s" % (
        eps, variant, update_alg, name), 2e-5)
  assert fused_conv_train.launches == 0


def jax_k17(world, upd, eps):
  """vtc_tpu's K17 with the stop on ``world`` of its CPU devices, the batch
  sharded over 'data': the replicated (dictionary, hessian, eigvec)."""
  p = SEGMENT

  def body(d, h, v, x):
    return jax_conv_dp.fused_conv_dp_train_segment_pallas(
        d, h, v, x, LAM, ITERS, 0.02, kernel_stride=p["stride"],
        padding=p["padding"], axis_name="data", axis_size=world,
        upd_num_iters=upd, power_iters=2, interpret=True,
        early_stopping_epsilon=eps)[:3]

  rep = PartitionSpec()
  fn = jax.jit(jax.shard_map(
      body, mesh=jax_parallel.make_mesh(data=world),
      in_specs=(rep, rep, rep, PartitionSpec(None, "data")),
      out_specs=(rep,) * 3, check_vma=False))
  return tuple(np.asarray(a) for a in fn(p["d"], p["h"], p["v"], p["x"]))


@functools.lru_cache(maxsize=None)
def jax_k17_cached(world, upd, eps):
  return jax_k17(world, upd, eps)


@pytest.mark.parametrize("upd,eps", [(1, SEG_EPS), (3, SEG_EPS), (1, 10.0)])
def test_k17_stop_matches_the_pallas_kernel(upd, eps):
  """A world of 1: what a CPU tensor runs is K17's plain version with the
  stop; the gradient form (one update iteration) and the gram form."""
  p = SEGMENT
  calls = fused_conv_dp_train.launches
  got = fused_conv_dp_train.fused_conv_dp_train_segment(
      _t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), LAM, ITERS, 0.02,
      mesh=parallel.make_mesh(), kernel_stride=p["stride"],
      padding=p["padding"], upd_num_iters=upd, power_iters=2,
      early_stopping_epsilon=eps)
  assert fused_conv_dp_train.launches == calls
  check_count("early" if eps == 10.0 else "mid", solver.last_iters, "K17")
  for g, w, name in zip(got, jax_k17_cached(1, upd, eps), NAMES):
    assert_close(g, w, "K17 world 1 upd %d eps %g %s" % (upd, eps, name),
                 2e-5)
  # K12's segment on the same batches: the same stop, the same state
  single = fused_conv_train.fused_conv_train_segment(
      _t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), LAM, ITERS, 0.02,
      kernel_stride=p["stride"], padding=p["padding"], upd_num_iters=upd,
      power_iters=2, early_stopping_epsilon=eps)
  for g, w, name in zip(got[:3], single[:3], NAMES):
    assert_close(g, w.numpy(), "K17 world 1 vs K12 %s" % name, 2e-5)


@functools.lru_cache(maxsize=None)
def rank_results(world):
  p = SEGMENT
  cases = [("K17 stop upd %d" % upd, "conv_dp_runner", dict(
      d=p["d"], h=p["h"], v=p["v"], batches=p["x"], sw=LAM, n_it=ITERS,
      upd_step=0.02, inference_alg="fista", update_alg=CQ,
      config=dict(kernel_stride=p["stride"], padding=p["padding"],
                  upd_num_iters=upd, early_eps=SEG_EPS)))
           for upd in (1, 3)]
  return worker.run_ranks(world, cases)


@pytest.mark.parametrize("world", (2, 4))
def test_k17_stop_across_ranks(world):
  """K17's plain version with the stop on ``world`` spawned ranks: the
  ranks bitwise equal, and equal to vtc_tpu's K17 with the stop on as many
  devices."""
  ranks = rank_results(world)
  for upd in (1, 3):
    key = "K17 stop upd %d" % upd
    for out in ranks:
      for a, b in zip(out[key], ranks[0][key]):
        assert np.array_equal(a, b), "%s: the ranks differ" % key
    for g, w, name in zip(ranks[0][key], jax_k17(world, upd, SEG_EPS),
                          NAMES):
      assert_close(g, w, "K17 world %d upd %d %s" % (world, upd, name), 2e-5)


# ---------------------------------------------------------------------------
# the trainers' routing with eps (vtc_tpu tests/test_conv_early_stop.py)
# ---------------------------------------------------------------------------
def _trainer_params(**extra):
  p = SEGMENT
  params = {
      "mode": "convolutional", "num_epochs": 2,
      "code_inference_algorithm": "fista",
      "dictionary_update_algorithm": CQ,
      "inference_param_schedule": {
          0: {"sparsity_weight": LAM, "num_iters": ITERS}},
      "dict_update_param_schedule": {0: {"stepsize": 0.02, "num_iters": 1}},
      "strides": p["stride"], "padding": p["padding"],
      "conv_formulation": "pallas", "early_stopping_epsilon": SEG_EPS}
  params.update(extra)
  return params


def _spy(monkeypatch, module, name, calls):
  original = getattr(module, name)

  def spy(*args, **kw):
    calls.append(kw.get("early_eps", args[-1] if args else None))
    return original(*args, **kw)

  monkeypatch.setattr(module, name, spy)


def test_dp_scanned_trainer_takes_k17_with_the_stop(monkeypatch):
  """conv + data_parallel + eps: K17 with the stop, as vtc_tpu selects
  its K17 with the stop on its 4-device mesh; the same dictionary."""
  p = SEGMENT
  x = p["x"].reshape((-1,) + p["x"].shape[2:])
  x = np.concatenate([x, x]).reshape((3, 8) + x.shape[1:])
  jax_calls, calls = [], []
  _spy(monkeypatch, jax_compiled_epoch, "_dp_rdma_conv_segment_runner",
       jax_calls)
  _spy(monkeypatch, compiled_epoch, "_dp_conv_segment_runner", calls)
  want = np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      x, x[:1], p["d"].copy(),
      _trainer_params(data_parallel=jax_parallel.make_mesh(data=4))))
  got = compiled_epoch.train_dictionary_scanned(
      x, x[:1], _t(p["d"]), _trainer_params(data_parallel=True),
      device="cpu")
  assert jax_calls and jax_calls[0] == pytest.approx(SEG_EPS)
  assert calls and calls[0] == pytest.approx(SEG_EPS), (
      "conv + data_parallel + eps must take K17 with the stop")
  assert_close(got, want, "data-parallel scanned trainer with the stop",
               5e-5)


def test_scanned_trainer_matches_the_fused_stop(monkeypatch):
  """conv + eps on one device: vtc_tpu's scanned trainer takes its fused
  K12 with the stop (its backend faked as a TPU, the kernel in interpret
  mode, as vtc_tpu's own test does); the port's CPU run (the per-step
  path, K10's plain solve with the stop) gives the same dictionary."""
  p = SEGMENT
  calls = []
  _spy(monkeypatch, jax_compiled_epoch, "_fused_conv_segment_runner", calls)
  original = jax_k12.fused_conv_train_segment_pallas

  def interpreted(*args, **kw):
    kw["interpret"] = True
    return original(*args, **kw)

  monkeypatch.setattr(jax_k12, "fused_conv_train_segment_pallas",
                      interpreted)
  monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
  want = np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      p["x"], p["x"][:1], p["d"].copy(), _trainer_params()))
  monkeypatch.undo()
  assert calls and calls[0] == pytest.approx(SEG_EPS)
  got = compiled_epoch.train_dictionary_scanned(
      p["x"], p["x"][:1], _t(p["d"]), _trainer_params(), device="cpu")
  assert_close(got, want, "scanned trainer with the stop", 5e-5)


def test_per_batch_trainer_takes_k10_with_the_stop(monkeypatch):
  """The per-batch conv trainer with eps: every solve K10's (its plain
  version here, with the stop), the dictionary vtc_tpu's."""
  p = SEGMENT
  params = _trainer_params()
  want = np.asarray(jax_sc.train_dictionary(p["x"], p["x"][:1],
                                            p["d"].copy(), params))
  calls = []
  original = fused_conv_direct.fused_conv_direct_solve

  def spy(*args, **kw):
    calls.append(kw.get("early_stopping_epsilon"))
    return original(*args, **kw)

  monkeypatch.setattr(fused_conv_direct, "fused_conv_direct_solve", spy)
  got = sc.train_dictionary(p["x"], p["x"][:1], _t(p["d"]), params,
                            device="cpu")
  assert len(calls) == 2 * p["x"].shape[0]
  assert all(c == pytest.approx(SEG_EPS) for c in calls)
  assert_close(got, want, "per-batch trainer with the stop", 5e-5)


def test_k13_keeps_its_refusal():
  """vtc_tpu's K13 has no stop, and neither has the port's: it still
  raises, naming the data-parallel stop's item."""
  p = SEGMENT
  with pytest.raises(NotImplementedError, match="item 3a.1"):
    fused_conv_train.conv_solve_stats(
        _t(p["d"]), _t(p["v"]), _t(p["x"][0]), LAM, 5,
        kernel_stride=p["stride"], padding=p["padding"],
        early_stopping_epsilon=1e-3)


@pytest.mark.cuda
def test_cuda_conv_stop_matches_plain():
  """On the card: K10, K11, K12 and K17 with the stop at the plain
  version's count and within 1e-4 of it; the scanned trainer runs K12
  with the stop."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the conv stop runs in CUDA kernels")
  dev = torch.device("cuda", 0)
  x, d, stride, padding, step = _solve_problem("4x4/4")
  kw = dict(kernel_stride=stride, padding=padding)
  for solve, plain, mod in (
      (fused_conv_direct.fused_conv_direct_solve,
       fused_conv_direct.fused_conv_direct_plain, fused_conv_direct),
      (fused_conv_fista.fused_conv_fista_solve,
       fused_conv_fista.fused_conv_fista_plain, fused_conv_fista)):
    plain(_t(x).to(dev), _t(d).to(dev), LAM, ITERS, step,
          early_stopping_epsilon=0.0, **kw)
    eps = stop_eps(list(solver.last_avgs), "mid")
    before = mod.launches
    got = solve(_t(x).to(dev), _t(d).to(dev), LAM, ITERS, step,
                early_stopping_epsilon=eps, **kw)
    assert mod.launches == before + 1
    want = plain(_t(x).to(dev), _t(d).to(dev), LAM, ITERS, step,
                 early_stopping_epsilon=eps, **kw)
    assert int(mod.last_iters.item()) == solver.last_iters
    assert_close(got.cpu(), want.cpu().numpy(), solve.__name__)
  p = SEGMENT
  args = [_t(p[k]).to(dev) for k in ("d", "h", "v", "x")]
  flags = dict(kernel_stride=p["stride"], padding=p["padding"],
               power_iters=2, early_stopping_epsilon=SEG_EPS)
  for mod, run, extra in (
      (fused_conv_train, fused_conv_train.fused_conv_train_segment, {}),
      (fused_conv_dp_train, fused_conv_dp_train.fused_conv_dp_train_segment,
       {"mesh": parallel.make_mesh()})):
    got = run(*args, LAM, ITERS, 0.02, **flags, **extra)
    want = run(*[a.cpu() for a in args], LAM, ITERS, 0.02, **flags, **extra)
    assert int(mod.last_iters[-1].item()) == solver.last_iters
    for g, w, name in zip(got, want, NAMES):
      assert_close(g.cpu(), w.numpy(), "%s %s" % (mod.__name__, name), 2e-5)
  before = fused_conv_train.launches
  compiled_epoch.train_dictionary_scanned(
      args[3], args[3][:1], args[0], _trainer_params(), device=dev)
  assert fused_conv_train.launches == before + 2 * p["x"].shape[0]
