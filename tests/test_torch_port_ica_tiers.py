"""The precision tiers (bf16x5, bf16x3, bf16) of the ICA kernels (K8, K9,
K18) and of the scanned ICA trainer against vtc_tpu on the CPU.

vtc_tpu builds the Newton-Schulz refreshes (the boost's too) and the codes
of its fused ICA kernels with ``_make_ns_dot(mxu)``
(vtc_tpu/ops/pallas_ica_train.py:57-83): both operands of each product are
split into bf16 terms and the single-pass bf16 products summed in float32;
the guard residual, the statistic and the update stay float32.  The port's
plain versions compute the same passes (``ops/precision.ns_dot``, summed as
the card's tensor cores sum them); on the card ``csrc/ica_segment.cuh``'s
tier tile runs them.  The same seeded numpy inputs (an orthogonal
dictionary, the inverse seed, mixtures of sources at least 0.05 from zero,
so that no code meets sign()'s discontinuity; n 128, which vtc_tpu's K8
asserts, a batch of 16, three steps) go through vtc_tpu's Pallas kernels
in interpret mode and the port:

* K8 ``fused_ica_segment``, K9 ``ica_solve_stats`` and K18 at a world of 1
  (a one-device 'data' axis) and of 2 (spawned ranks,
  tests/torch_port_dp_worker.py, against vtc_tpu's K18 on two of its CPU
  devices, the ranks bitwise equal), each at the tier's guard and boost
  tolerances (vtc_tpu/training/ica.py:143-153), from the exact inverse;
* the boost at each tier: a stale seed (STALE) whose residual after the
  refreshes sits well above the tier's boost tolerance, so that the boost
  fires in both packages and the boosted residual falls below it;
* the scanned trainer at each tier with ``use_fused`` (K8's plain
  version), without it (the per-step guarded path) and with
  ``data_parallel`` (K18's plain version), against vtc_tpu's trainer with
  ``use_fused=True`` (its K8, or with ``data_parallel`` on a one-device
  axis its K18, in interpret mode).  vtc_tpu's per-step path runs XLA
  precisions, which its CPU computes in float32 whatever the tier
  (tests/test_training.py:301-341); on a TPU 'tensorfloat32' and 'bfloat16'
  are K8's bf16x3 and bf16 passes (vtc_tpu/training/ica.py:126-128), which
  the port computes, so the port's per-step path is held to vtc_tpu's K8
  at the tier; at bf16x5 both per-step paths run 'highest';
* a forced divergence (stepsize 40) at each tier rolls back onto the
  per-step path at the tier;
* vtc_tpu's refusals, kept: an unknown tier, a tier with warm_inverse off;
  the per-batch trainer reads no tier in either package;
* ``newton_refine_inverse(precision='tensorfloat32')``: the 3-pass
  product, not torch's TF32 setting;
* the ICA entries' ctypes declarations against their C definitions.

Tolerance and control: tests/test_torch_port_tiers.py's ``check_tier``,
per tier the larger of its floor and vtc_tpu's own spread under five
random-direction one-ulp nudges of both the batches and the dictionary
(the seed follows the dictionary; ROADMAP.md §3), with that file's
Frobenius control, so a port that ignored the tier fails.  The trainers
take K8's spread of the dictionary: with ``use_fused`` vtc_tpu's trainer
is its K8 from the exact inverse.  Every vtc_tpu reference is cached.
The tier tile itself runs only on a card: chip_smoke.py phase 49, whose
checks the cuda test here names.
"""
import ctypes
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

import torch_port_dp_worker as worker
from test_torch_port_dp_tiers import _c_kinds, _declared_kind
from test_torch_port_tiers import check_tier, nudged
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.analysis_transforms.fully_connected import (
    invertible_linear as jax_il)
from vtc_tpu.ops import pallas_ica_train as jax_k8
from vtc_tpu.training import ica as jax_ica
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    invertible_linear)
from vtc_tpu_torch.ops import _build, fused_ica_train, precision
from vtc_tpu_torch.training import ica

TIERS = ("bf16x5", "bf16x3", "bf16")
STEP, REFINE = 0.02, 3
# each tier's boost tolerance (vtc_tpu/training/ica.py:143-153)
BOOST = {tier: jax_ica._TIERS[tier][2] for tier in ("highest",) + TIERS}
# stale seeds c X: the residual after three refreshes is (c - 1)^8, 2.3e-4,
# 1.7e-2 and 0.43, above each tier's boost (1e-4, 3e-3, 0.25) by 2-6x, and
# after the boost's two more (c - 1)^32, below it
STALE = {"bf16x5": 1.35, "bf16x3": 1.6, "bf16": 1.9}


def _t(x):
  return torch.from_numpy(np.array(x, dtype=np.float32))


def flat(outs):
  return np.concatenate([np.asarray(o, np.float64).ravel() for o in outs])


@functools.lru_cache(maxsize=None)
def _problem():
  """An orthogonal dictionary (n 128) and three batches of 16 mixtures of
  sources at least 0.05 from zero."""
  rng = np.random.RandomState(23)
  n, b, k = 128, 16, 3
  d = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
  src = np.sign(rng.randn(k * b, n)) * (0.05 + rng.laplace(size=(k * b, n)))
  return (src @ d).astype(np.float32).reshape(k, b, n), d


def _seed(d, stale=1.0):
  return (stale * np.linalg.inv(d.astype(np.float64))).astype(np.float32)


def _reference(fn, tier):
  """(vtc_tpu's fn(x, d, tier), at 'highest', its spread at the tier under
  five nudges of both the batches and the dictionary)."""
  x, d = _problem()
  want = fn(x, d, tier)
  moved = [fn(nudged(x, seed), nudged(d, seed + 5), tier) - want
           for seed in range(5)]
  return want, fn(x, d, "highest"), (
      max(float(np.abs(m).max()) for m in moved),
      max(float(np.linalg.norm(m)) for m in moved))


# ---------------------------------------------------------------------------
# K8 and the boost
# ---------------------------------------------------------------------------
def _jax_k8(boost_tol, stale, x, d, mxu):
  return flat(jax_k8.fused_ica_train_segment_pallas(
      d, _seed(d, stale), x, STEP, refine_iters=REFINE, mxu=mxu,
      boost_tol=boost_tol, interpret=True))


@functools.lru_cache(maxsize=None)
def _k8_reference(tier, stale=1.0):
  return _reference(functools.partial(_jax_k8, BOOST[tier], stale), tier)


def _port_k8(x, d, mxu, boost_tol, stale=1.0):
  return flat(fused_ica_train.fused_ica_train_segment(
      _t(d), _t(_seed(d, stale)), _t(x), STEP, refine_iters=REFINE, mxu=mxu,
      boost_tol=boost_tol))


@pytest.mark.parametrize("tier", TIERS)
def test_k8_matches_pallas_at_each_tier(tier):
  """K8's plain version at the tier from the exact inverse: D, X and the
  segment's largest residual; a CPU tensor launches nothing."""
  x, d = _problem()
  want, full, moved = _k8_reference(tier)
  before = (fused_ica_train.launches, fused_ica_train.tier_launches)
  check_tier(lambda mxu: _port_k8(x, d, mxu, BOOST[tier]), want, full, moved,
             tier, "K8 exact seed")
  assert (fused_ica_train.launches, fused_ica_train.tier_launches) == before
  assert 0.0 <= want[-1] < BOOST[tier]  # no boost from the exact seed


@pytest.mark.parametrize("tier", TIERS)
def test_boost_fires_at_each_tier(tier):
  """From the stale seed the residual after the refreshes is above the
  tier's boost tolerance in both packages (without the boost the segment's
  largest residual shows it), the boost fires in both and brings it below;
  the boosted segment is held to vtc_tpu's as K8's."""
  x, d = _problem()
  stale = STALE[tier]
  for boost_tol in (None, BOOST[tier]):
    res = (_jax_k8(boost_tol, stale, x, d, tier)[-1],
           _port_k8(x, d, tier, boost_tol, stale)[-1])
    print("%s stale %.2f, boost_tol %s: largest residual vtc_tpu %.3e, the "
          "port %.3e" % (tier, stale, boost_tol, *res))
    for r in res:
      assert (r > BOOST[tier]) if boost_tol is None else (0.0 <= r
                                                          < BOOST[tier])
  want, full, moved = _k8_reference(tier, stale)
  check_tier(lambda mxu: _port_k8(x, d, mxu, BOOST[tier], stale), want, full,
             moved, tier, "K8 stale seed %.2f" % stale)


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------
def _jax_k9(boost_tol, x, d, mxu):
  return flat(jax_k8.ica_solve_stats_pallas(
      d, _seed(d), x[0], refine_iters=REFINE, mxu=mxu, boost_tol=boost_tol,
      interpret=True))


@functools.lru_cache(maxsize=None)
def _k9_reference(tier):
  return _reference(functools.partial(_jax_k9, BOOST[tier]), tier)


@pytest.mark.parametrize("tier", TIERS)
def test_k9_matches_pallas_at_each_tier(tier):
  """K9's plain version: the refreshed inverse, the shard's unaveraged
  statistic codes^T sign(codes) and the residual."""
  x, d = _problem()
  want, full, moved = _k9_reference(tier)
  before = fused_ica_train.stats_tier_launches
  check_tier(lambda mxu: flat(fused_ica_train.ica_solve_stats(
      _t(d), _t(_seed(d)), _t(x[0]), refine_iters=REFINE, mxu=mxu,
      boost_tol=BOOST[tier])), want, full, moved, tier, "K9")
  assert fused_ica_train.stats_tier_launches == before


# ---------------------------------------------------------------------------
# K18 at worlds 1 and 2
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_k18_fn(world, mxu, boost_tol):
  def body(d, xi, x):
    return jax_k8.fused_ica_dp_train_segment_pallas(
        d, xi, x, jnp.float32(STEP), axis_name="data", axis_size=world,
        refine_iters=REFINE, mxu=mxu, boost_tol=boost_tol, interpret=True)

  rep = PartitionSpec()
  mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(world), ("data",))
  return jax.jit(jax.shard_map(
      body, mesh=mesh, in_specs=(rep, rep, PartitionSpec(None, "data")),
      out_specs=(rep,) * 3, check_vma=False))


def _jax_k18(world, boost_tol, x, d, mxu):
  """vtc_tpu's K18 on ``world`` of its CPU devices, the batch sharded over
  'data'."""
  return flat(_jax_k18_fn(world, mxu, boost_tol)(d, _seed(d), x))


@functools.lru_cache(maxsize=None)
def _k18_reference(tier):
  return _reference(functools.partial(_jax_k18, 1, BOOST[tier]), tier)


@pytest.mark.parametrize("tier", TIERS)
def test_k18_world_of_one_matches_pallas_at_each_tier(tier):
  from vtc_tpu_torch import parallel
  x, d = _problem()
  want, full, moved = _k18_reference(tier)
  before = fused_ica_train.dp_tier_launches
  check_tier(lambda mxu: flat(fused_ica_train.fused_ica_dp_train_segment(
      _t(d), _t(_seed(d)), _t(x), STEP, mesh=parallel.make_mesh(),
      refine_iters=REFINE, mxu=mxu, boost_tol=BOOST[tier])), want, full,
             moved, tier, "K18 world 1")
  assert fused_ica_train.dp_tier_launches == before


@functools.lru_cache(maxsize=None)
def _world_of_two():
  """Both ranks' runs of ``ica._dp_kernel_segment_runner`` (the tier's
  boost) at each tier and at 'highest'."""
  x, d = _problem()
  return worker.run_ranks(2, [(tier, "dp_segment", dict(
      family="ica", d=d, v=_seed(d), batches=x, config=dict(
          upd_num_iters=1, refine_iters=REFINE, stepsize=STEP, mxu=tier)))
                              for tier in TIERS + ("highest",)])


@pytest.mark.parametrize("tier", TIERS)
def test_k18_world_of_two_matches_pallas(tier):
  """Two spawned ranks, each its shard of 8: the ranks bitwise equal, and
  at vtc_tpu's K18 on two devices under the tier's check (vtc_tpu's spread
  at a world of 1, its 'highest' on two devices; the runner's boost is each
  tier's own, so is the reference's: the sum over the shards moves the
  last bits of every step's statistic, which at bf16x5 is as far as the
  tier moves the state)."""
  x, d = _problem()
  ranks = _world_of_two()
  for key in TIERS + ("highest",):
    for a, b in zip(ranks[0][key], ranks[1][key]):
      assert np.array_equal(a, b), "%s: the ranks differ" % key
  moved = _k18_reference(tier)[2]
  check_tier(lambda mxu: flat(ranks[0][mxu]),
             _jax_k18(2, BOOST[tier], x, d, tier),
             _jax_k18(2, BOOST["highest"], x, d, "highest"), moved, tier,
             "K18 world 2")


# ---------------------------------------------------------------------------
# the scanned trainer
# ---------------------------------------------------------------------------
def _params(tier, stepsize=STEP, **extra):
  params = {
      "num_epochs": 1,
      "dictionary_update_algorithm": "ica_natural_gradient",
      "dict_update_param_schedule": {0: {"stepsize": stepsize,
                                         "num_iters": 1}},
      "refine_iters": REFINE, "train_precision": tier,
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


MODES = {"fused": dict(use_fused=True), "per-step": dict(use_fused=False),
         "data_parallel": dict(use_fused=True, data_parallel=True)}


@functools.lru_cache(maxsize=None)
def _jax_trained(mode, tier):
  """vtc_tpu's scanned trainer: with use_fused its K8 in interpret mode,
  with data_parallel on a one-device 'data' axis its K18; 'per-step' at
  bf16x5 and 'highest' its per-step path, elsewhere its K8 (see the module
  docstring)."""
  x, d = _problem()
  extra = dict(use_fused=True)
  if mode == "data_parallel":
    extra["data_parallel"] = jax_parallel.make_mesh(data=1)
  elif mode == "per-step" and tier in ("bf16x5", "highest"):
    extra["use_fused"] = False
  return np.asarray(jax_ica.train_dictionary_scanned(
      x, d.copy(), _params(tier, **extra)), np.float64).ravel()


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tier", TIERS)
def test_scanned_trainer_matches_vtc_tpu(tier, mode):
  x, d = _problem()
  want = _jax_trained(mode, tier)
  spread = _k8_reference(tier)[2]
  if mode == "fused":  # vtc_tpu's trainer is its K8 from the exact inverse
    assert float(np.abs(want - _k8_reference(tier)[0][:d.size]).max()) <= (
        max(1e-6, spread[0]))
  check_tier(lambda mxu: ica.train_dictionary_scanned(
      x, d, _params(mxu, **MODES[mode]), device="cpu").numpy().ravel(), want,
             _jax_trained(mode, "highest"), spread, tier,
             "scanned ICA trainer " + mode)


@pytest.mark.parametrize("tier", TIERS)
def test_divergence_rolls_back_onto_the_tiers_fallback(tier, monkeypatch):
  """At stepsize 40 the fused path's residual fails the tier's guard; the
  trainer rolls back and reruns on the per-step guarded path at the tier's
  XLA precision (vtc_tpu's _drain_guard, :500-523), landing bitwise on
  use_fused=False's run."""
  x, d = _problem()
  seen = []
  original = invertible_linear.refine_inverse_guarded

  def spy(*args, **kw):
    seen.append((kw.get("precision"), kw.get("residual_tol")))
    return original(*args, **kw)

  monkeypatch.setattr(invertible_linear, "refine_inverse_guarded", spy)
  before = ica.rollbacks
  fused = ica.train_dictionary_scanned(x, d, _params(tier, 40.0,
                                                     use_fused=True),
                                       device="cpu")
  assert ica.rollbacks == before + 1
  assert set(seen) == {tuple(ica._TIERS[tier][:2])}
  stepped = ica.train_dictionary_scanned(x, d, _params(tier, 40.0,
                                                       use_fused=False),
                                         device="cpu")
  assert ica.rollbacks == before + 1
  assert torch.equal(fused, stepped)
  assert bool(torch.isfinite(stepped).all())


def test_per_batch_trainer_reads_no_tier():
  """vtc_tpu's per-batch train_dictionary reads no 'train_precision'
  (vtc_tpu/training/ica.py:38-107): in both packages a run with 'bf16' is
  bitwise the run without it, and the two packages agree."""
  x, d = _problem()
  base = _params("highest")
  del base["train_precision"], base["refine_iters"]
  with_tier = dict(base, train_precision="bf16")
  jax_runs = [np.asarray(jax_ica.train_dictionary(x, d.copy(), p))
              for p in (base, with_tier)]
  runs = [ica.train_dictionary(x, d, p, device="cpu").numpy()
          for p in (base, with_tier)]
  assert np.array_equal(*jax_runs) and np.array_equal(*runs)
  assert float(np.abs(runs[1] - jax_runs[1]).max()) <= 2e-5


def test_refusals_kept_from_vtc_tpu():
  """vtc_tpu's scanned trainer asserts a known tier and, at a tier, warm
  inverse tracking (:420-426); the port raises ValueError for both."""
  x, d = _problem()
  for extra in (dict(train_precision="bf32"),
                dict(train_precision="bf16x3", warm_inverse=False)):
    params = dict(_params("highest"), **extra)
    with pytest.raises(AssertionError, match="train_precision"):
      jax_ica.train_dictionary_scanned(x, d.copy(), params)
    with pytest.raises(ValueError, match="train_precision"):
      ica.train_dictionary_scanned(x, d, params, device="cpu")
  # 'highest' without warm inverse runs in both
  ica.train_dictionary_scanned(x, d, dict(_params("highest"),
                                          warm_inverse=False), device="cpu")


# ---------------------------------------------------------------------------
# newton_refine_inverse's precision: the TPU's passes, not TF32
# ---------------------------------------------------------------------------
def _bf16(a):
  return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16),
                    np.float64)


def _three_pass(a, b):
  """a_hi b_hi + a_lo b_hi + a_hi b_lo of float32 a, b, in float64."""
  a_hi, b_hi = _bf16(a), _bf16(b)
  a_lo = _bf16(np.float32(a) - np.float32(a_hi))
  b_lo = _bf16(np.float32(b) - np.float32(b_hi))
  return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo


def test_newton_refine_inverse_runs_the_tpus_passes():
  """precision='tensorfloat32' is the TPU's 3-pass bf16x3 product (what
  vtc_tpu's per-step path runs there), 'bfloat16' its single pass, and
  torch's own float32-matmul setting changes none of them: one refresh
  sits within float32 rounding of a float64 evaluation of the three
  passes and ten times further from the float32 refresh."""
  x, d = _problem()
  xi = _t(_seed(d, 1.2))
  dt = _t(d)
  got = invertible_linear.newton_refine_inverse(dt, xi, 1,
                                                precision="tensorfloat32")
  saved = torch.get_float32_matmul_precision()
  try:
    torch.set_float32_matmul_precision("high")
    again = invertible_linear.newton_refine_inverse(
        dt, xi, 1, precision="tensorfloat32")
  finally:
    torch.set_float32_matmul_precision(saved)
  assert torch.equal(got, again)
  assert torch.equal(got, invertible_linear.newton_refine_tier(dt, xi, 1,
                                                               "bf16x3"))
  assert torch.equal(
      invertible_linear.newton_refine_inverse(dt, xi, 1, precision="bfloat16"),
      invertible_linear.newton_refine_tier(dt, xi, 1, "bf16"))
  full = invertible_linear.newton_refine_inverse(dt, xi, 1)
  assert torch.equal(full, invertible_linear.newton_refine_inverse(
      dt, xi, 1, precision="float32"))
  e = (2.0 * np.eye(d.shape[0]) - _three_pass(d, xi.numpy())).astype(
      np.float32)
  oracle = _three_pass(xi.numpy(), e)
  err = float(np.abs(got.numpy() - oracle).max())
  off = float(np.abs(full.numpy() - oracle).max())
  print("one refresh at 'tensorfloat32': %.3e from the 3-pass oracle, the "
        "float32 refresh %.3e" % (err, off))
  assert err <= 4e-7 and 10.0 * err <= off
  with pytest.raises(ValueError, match="unknown matmul precision"):
    invertible_linear.newton_refine_inverse(dt, xi, 1, precision="tf32")


# ---------------------------------------------------------------------------
# the C entries
# ---------------------------------------------------------------------------
ICA_ENTRIES = ("vtc_ica_train_segment", "vtc_ica_solve_stats",
               "vtc_ica_dp_train_segment", "vtc_ica_persistent_segment")


def test_ica_entries_take_the_tier(monkeypatch):
  """The four ICA C entries take the tier (an int) before the stream, and
  ``ops/_build.load_library`` declares each as its definition reads: a
  missing or misplaced declaration would pass the tier as the stream."""
  class FakeLib:
    def __getattr__(self, name):
      fn = type("Fn", (), {})()
      setattr(self, name, fn)
      return fn

  monkeypatch.setattr(_build, "build", lambda *a, **k: "unbuilt")
  monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
  lib = _build.load_library.__wrapped__()
  source = (pathlib.Path(_build.CSRC) / "fused_ica_train_step.cu").read_text()
  for name in ICA_ENTRIES:
    found = re.search(r"\nint\s+%s\(([^)]*)\)\s*\{" % name, source)
    params = [p.strip() for p in found.group(1).split(",")]
    assert params[-2:] == ["int tier", "void* stream_ptr"], name
    declared = [_declared_kind(a) for a in getattr(lib, name).argtypes]
    assert declared == _c_kinds(params), name
    assert declared[-2:] == [ctypes.c_int, ctypes.c_void_p], name
  assert precision.TIER_CODES == {"highest": 0, "bf16": 1, "bf16x3": 2,
                                  "bf16x5": 3}
  codes = (pathlib.Path(_build.CSRC) / "tier_codes.cuh").read_text()
  assert ("kTierHighest = 0, kTierBf16 = 1, kTierBf16x3 = 2, kTierBf16x5 = 3"
          in codes)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_ica_tiers_match_plain_on_both_routes():
  """K8 at every tier on both routes, forced: the same bits, and within the
  tier's floor of the plain version at the tier (chip_smoke.py phase 49
  holds the flagship to the three rules, and K9 and K18 too)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier tile has no CPU mode")
  dev = torch.device("cuda", 0)
  x, d = _problem()
  args = [_t(a).to(dev) for a in (d, _seed(d), x)]
  floor = {"bf16x5": 1e-5, "bf16x3": 2e-5, "bf16": 2e-3}
  for tier in TIERS:
    runs = [fused_ica_train._launch(args[0].clone(), args[1].clone(),
                                    args[2], STEP, REFINE, 1, BOOST[tier],
                                    tier, route=route)
            for route in ("steps", "persistent")]
    for a, b in zip(*runs):
      assert torch.equal(a.view(torch.int32), b.view(torch.int32)), tier
    want = fused_ica_train.fused_ica_train_plain(
        *args, STEP, refine_iters=REFINE, boost_tol=BOOST[tier], mxu=tier)
    for g, w in zip(runs[1], want):
      assert float((g - w).abs().max()) <= floor[tier] * max(
          1.0, float(w.abs().max())), tier
