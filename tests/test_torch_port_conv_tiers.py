"""The precision tiers (bf16x5, bf16x3, bf16) of the conv family (K10, K12,
K13, K17), its solver, encode and trainers against vtc_tpu on the CPU.

vtc_tpu's conv kernels split their deep-contraction products by
``_make_deep_dot(mxu)`` (vtc_tpu/ops/pallas_conv_train.py:240-267): the
weights (dstk, dall) into bf16 terms once per solve, the stacked source per
use, single-pass bf16 products summed in float32, the weights on the left;
corr = A(mask * X), the synthesis (masked after the product) and the
analysis run at the tier, the prox, the momentum, the stop test, the Gram,
the refresh, the statistics and the update stay float32.  The port's plain
versions compute the same passes as float32 products of the bf16 values
with TF32 off (``fused_conv_direct.conv_deep_dot``); on the card
``csrc/conv_gemm_tier.cuh`` runs them on the tensor cores.  The same seeded
numpy inputs go through vtc_tpu's Pallas kernels in interpret mode and the
port's plain versions:

* K10 ``conv_direct_solve_pallas(mxu_precision=)``, FISTA soft and ISTA
  hard nonneg; a two-step K12 segment ``fused_conv_train_segment_pallas
  (mxu=)``; K13 ``conv_solve_stats_pallas(mxu=)`` in gradient and gram
  form; K17 at a world of 1 (a one-device 'data' axis) and of 2 (spawned
  ranks, tests/torch_port_dp_worker.py, against vtc_tpu's K17 on two of
  its CPU devices, the ranks bitwise equal);
* the entries ``ista_fista.run(formulation='pallas', mxu_precision=)``,
  ``encode_dataset(mode='convolutional')`` with and without
  ``data_parallel``, and ``train_dictionary_scanned(mode='convolutional',
  train_precision=)`` with and without ``data_parallel`` (vtc_tpu's fused
  K12 runner with its backend faked as a TPU, its K17 runner on a
  one-device mesh);
* a tier with the early stop inside vtc_tpu's one K10 tile: the count and
  the codes;
* vtc_tpu's refusals, in both packages: a tier with 'gram' or 'direct', a
  tier off K10's gate (K11 has no tier), a tier with a stop on a batch
  beyond vtc_tpu's one tile (33 images; its tiles hold at most 32); and the
  scanned trainer off K12's gate, which runs 'highest' whatever the tier,
  bitwise.

Tolerance and control: tests/test_torch_port_tiers.py's ``check_tier``, per
tier the larger of its floor and vtc_tpu's own spread, here under five
random-direction one-ulp nudges of both the input and the dictionary
(ROADMAP.md §3), with that file's Frobenius control, so a port that
ignored the tier fails.  The problems are tiny (4x4 kernels at stride 2,
s 6, b <= 4, 6 iterations) and their kernels lie under a 0.8-px Gaussian
window: the conv stepsize (1/L of the flattened kernels) diverges on
random overlapping kernels, in both packages alike.  Every vtc_tpu
reference is cached.  The tier kernel itself runs only on a card:
chip_smoke.py phase 48, whose checks the cuda test here names.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

import torch_port_dp_worker as worker
from test_torch_port_tiers import check_tier, nudged
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.analysis_transforms.convolutional import (
    ista_fista as jax_conv_ista_fista)
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.ops import lipschitz as jax_lip
from vtc_tpu.ops import pallas_conv_direct
from vtc_tpu.ops import pallas_conv_dp_train as jax_k17
from vtc_tpu.ops import pallas_conv_train as jax_k12
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu_torch import parallel
from vtc_tpu_torch.analysis_transforms.convolutional import ista_fista
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import (fused_conv_direct, fused_conv_dp_train,
                               fused_conv_fista, fused_conv_train, lipschitz,
                               solver)
from vtc_tpu_torch.training import compiled_epoch

TIERS = ("bf16x5", "bf16x3", "bf16")
LAM, ITERS, UPD = 0.05, 6, 0.05
STRIDE, PADDING = (2, 2), ((2, 2), (2, 2))
CQ = "sc_cheap_quadratic_descent"
K10_CASES = {"fista soft": dict(variant="fista"),
             "ista hard nonneg": dict(variant="ista", hard=True,
                                      nonneg=True)}


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _kernels(rng, s, c, k, sigma=0.8):
  """Unit-norm kernels under a Gaussian window of ``sigma`` pixels."""
  yy = np.arange(k) - (k - 1) / 2.0
  d = rng.randn(s, c, k, k) * np.exp(
      -(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * sigma ** 2))
  return (d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))).astype(
      np.float32)


def _images(rng, shape, padding=PADDING):
  """(*shape[:-2], H, W) images with a zero border of ``padding``."""
  (lv, tv), (lh, th) = padding
  x = np.zeros(shape[:-2] + (shape[-2] + lv + tv, shape[-1] + lh + th),
               np.float32)
  x[..., lv:lv + shape[-2], lh:lh + shape[-1]] = 0.3 * rng.randn(*shape)
  return x


@functools.lru_cache(maxsize=None)
def _problem():
  """Two batches of 4 images (1 x 12 x 12, padded to 16 x 16), 6 windowed
  4x4 kernels at stride 2, vtc_tpu's 'eigvalsh' stepsize, and the
  trainers' exact eigenvector seed."""
  rng = np.random.RandomState(22)
  x = _images(rng, (2, 4, 1, 12, 12))
  d = _kernels(rng, 6, 1, 4)
  eta = float(jax_lip.fista_stepsize(jnp.asarray(d).reshape(6, -1),
                                     "eigvalsh"))
  v0 = lipschitz.top_gram_eigenpair(_t(d).reshape(6, -1))[1].numpy()
  return x, d, eta, v0


def spread(fn, x, d, want):
  """How far fn(x, d) moves from want under five nudges of both x and d:
  the largest max-abs and Frobenius distances."""
  moved = [np.asarray(fn(nudged(x, seed), nudged(d, seed + 5)), np.float64)
           - want for seed in range(5)]
  return (max(float(np.abs(m).max()) for m in moved),
          max(float(np.linalg.norm(m)) for m in moved))


def flat(outs):
  return np.concatenate([np.asarray(o, np.float64).ravel() for o in outs])


def _reference(fn, x, d, tier):
  """(vtc_tpu's fn(x, d, tier), at 'highest', its spread at the tier)."""
  want = fn(x, d, tier)
  return want, fn(x, d, "highest"), spread(lambda a, b: fn(a, b, tier), x,
                                           d, want)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------
def _jax_k10(case, x, d, mxu, eps=None):
  _, _, eta, _ = _problem()
  return np.asarray(pallas_conv_direct.conv_direct_solve_pallas(
      jnp.asarray(x), jnp.asarray(d), LAM, ITERS, eta, kernel_stride=STRIDE,
      padding=PADDING, interpret=True, mxu_precision=mxu,
      early_stopping_epsilon=eps, **K10_CASES[case]))


@functools.lru_cache(maxsize=None)
def _k10_reference(case, tier):
  x, d, _, _ = _problem()
  return _reference(functools.partial(_jax_k10, case), x[0], d, tier)


@pytest.mark.parametrize("case", sorted(K10_CASES))
@pytest.mark.parametrize("tier", TIERS)
def test_k10_matches_pallas_at_each_tier(case, tier):
  x, d, eta, _ = _problem()
  want, full, moved = _k10_reference(case, tier)
  check_tier(lambda mxu: fused_conv_direct.fused_conv_direct_solve(
      _t(x[0]), _t(d), LAM, ITERS, eta, kernel_stride=STRIDE,
      padding=PADDING, mxu=mxu, **K10_CASES[case]), want, full, moved, tier,
             "K10 " + case)
  assert fused_conv_direct.launches == fused_conv_direct.tier_launches == 0


@pytest.mark.parametrize("tier", TIERS)
def test_run_pallas_matches_vtc_tpu_at_each_tier(tier):
  """run('pallas') takes K10 at the tier ('bf16' spelled 'default', the
  solvers' name), as vtc_tpu's run does."""
  x, d, eta, _ = _problem()
  spelled = "default" if tier == "bf16" else tier
  want, full, moved = _k10_reference("fista soft", tier)
  got = np.asarray(jax_conv_ista_fista.run(
      x[0], d, STRIDE, PADDING, LAM, ITERS, formulation="pallas",
      stepsize=eta, mxu_precision=spelled))
  assert float(np.abs(got - want).max()) <= 1e-6  # vtc_tpu's run is its K10
  check_tier(lambda mxu: ista_fista.run(
      x[0], _t(d), STRIDE, PADDING, LAM, ITERS, formulation="pallas",
      stepsize=eta, mxu_precision="default" if mxu == "bf16" else mxu),
             want, full, moved, tier, "run('pallas')")


@pytest.mark.parametrize("tier", ("bf16x3",))
def test_k10_stop_inside_the_tile_matches_pallas(tier):
  """A tier with the stop on a batch inside vtc_tpu's one tile: the plain
  loop stops where vtc_tpu's kernel does (an eps between two of its means,
  mid-run), with vtc_tpu's codes."""
  x, d, eta, _ = _problem()
  assert fused_conv_direct.early_stop_supported(x[0].shape, d.shape, STRIDE)
  assert pallas_conv_direct.early_stop_supported(x[0].shape, d.shape,
                                                 STRIDE)
  kw = dict(kernel_stride=STRIDE, padding=PADDING, mxu=tier)
  fused_conv_direct.fused_conv_direct_plain(_t(x[0]), _t(d), LAM, ITERS,
                                            eta, early_stopping_epsilon=0.0,
                                            **kw)
  # avgs[j]: the mean after iteration j + 2 (the test starts at the second)
  avgs = list(solver.last_avgs)
  # the first new low: eps between it and the lowest mean before it stops
  # there, at count j + 2
  j = next(j for j in range(1, len(avgs)) if avgs[j] < min(avgs[:j]))
  eps = float(np.sqrt(avgs[j] * min(avgs[:j])))
  got = fused_conv_direct.fused_conv_direct_solve(
      _t(x[0]), _t(d), LAM, ITERS, eta, early_stopping_epsilon=eps, **kw)
  count = solver.last_iters
  assert count == j + 2 < ITERS, (count, avgs)
  want = _jax_k10("fista soft", x[0], d, tier, eps)
  # vtc_tpu stopped at the same count: its codes are that run's
  assert np.array_equal(want, np.asarray(
      pallas_conv_direct.conv_direct_solve_pallas(
          jnp.asarray(x[0]), jnp.asarray(d), LAM, count, eta,
          kernel_stride=STRIDE, padding=PADDING, interpret=True,
          mxu_precision=tier)))
  _, full, moved = _k10_reference("fista soft", tier)
  err = float(np.abs(got.numpy() - want).max())
  bound = max(1e-5, moved[0])
  assert err <= bound, "K10 stop %s: max|d| %.3e > %.3e" % (tier, err, bound)


# ---------------------------------------------------------------------------
# K12, K13, K17
# ---------------------------------------------------------------------------
def _jax_k12(x, d, mxu):
  _, _, _, v0 = _problem()
  return flat(jax_k12.fused_conv_train_segment_pallas(
      d, np.zeros(6, np.float32), v0, x, LAM, ITERS, UPD,
      kernel_stride=STRIDE, padding=PADDING, power_iters=2, interpret=True,
      mxu=mxu))


@functools.lru_cache(maxsize=None)
def _k12_reference(tier, kernels_only=False):
  """vtc_tpu's K12 reference; kernels_only: of the kernels alone (the
  scanned trainer's result)."""
  x, d, _, _ = _problem()
  fn = _jax_k12
  if kernels_only:
    fn = lambda a, b, mxu: _jax_k12(a, b, mxu)[:d.size]
  return _reference(fn, x, d, tier)


@pytest.mark.parametrize("tier", TIERS)
def test_k12_segment_matches_pallas_at_each_tier(tier):
  """Two steps: the kernels, the Hessian EMA, the eigenvector and the last
  codes, from the trainers' exact seed."""
  x, d, _, v0 = _problem()
  want, full, moved = _k12_reference(tier)
  check_tier(lambda mxu: flat(fused_conv_train.fused_conv_train_segment(
      _t(d), torch.zeros(6), _t(v0), _t(x), LAM, ITERS, UPD,
      kernel_stride=STRIDE, padding=PADDING, power_iters=2, mxu=mxu)),
             want, full, moved, tier, "K12 segment")
  assert fused_conv_train.launches == fused_conv_train.tier_launches == 0


def _jax_k13(gram, x, d, mxu):
  _, _, _, v0 = _problem()
  return flat(jax_k12.conv_solve_stats_pallas(
      d, v0, x, LAM, ITERS, kernel_stride=STRIDE, padding=PADDING,
      power_iters=2, gram_stats=gram, interpret=True, mxu=mxu))


@functools.lru_cache(maxsize=None)
def _k13_reference(gram, tier):
  x, d, _, _ = _problem()
  return _reference(functools.partial(_jax_k13, gram), x[0], d, tier)


@pytest.mark.parametrize("gram,tier", [(False, t) for t in TIERS]
                         + [(True, "bf16x3")],
                         ids=["gradient-" + t for t in TIERS]
                         + ["gram-bf16x3"])
def test_k13_matches_pallas_at_each_tier(gram, tier):
  """One shard's solve at the tier and its fp32 statistics: the codes, the
  gradient sum or (bx, cm), stat, the eigenvector and eta.  The gram form's
  statistics are fp32 at every tier, so it runs at one."""
  x, d, _, v0 = _problem()
  want, full, moved = _k13_reference(gram, tier)
  check_tier(lambda mxu: flat(fused_conv_train.conv_solve_stats(
      _t(d), _t(v0), _t(x[0]), LAM, ITERS, kernel_stride=STRIDE,
      padding=PADDING, power_iters=2, gram_stats=gram, mxu=mxu)),
             want, full, moved, tier,
             "K13 %s" % ("gram" if gram else "gradient"))
  assert fused_conv_train.stats_tier_launches == 0


@functools.lru_cache(maxsize=None)
def _jax_k17_fn(world, mxu):
  def body(d, h, v, x):
    return jax_k17.fused_conv_dp_train_segment_pallas(
        d, h, v, x, LAM, ITERS, UPD, kernel_stride=STRIDE, padding=PADDING,
        axis_name="data", axis_size=world, power_iters=2, interpret=True,
        mxu=mxu)[:3]

  rep = PartitionSpec()
  return jax.jit(jax.shard_map(
      body, mesh=jax_parallel.make_mesh(data=world),
      in_specs=(rep, rep, rep, PartitionSpec(None, "data")),
      out_specs=(rep,) * 3, check_vma=False))


def _jax_k17(world, x, d, mxu):
  """vtc_tpu's K17 on ``world`` of its CPU devices, the batch sharded over
  'data': the replicated kernels, Hessian and eigenvector."""
  _, _, _, v0 = _problem()
  return flat(_jax_k17_fn(world, mxu)(d, np.zeros(6, np.float32), v0, x))


@functools.lru_cache(maxsize=None)
def _k17_reference(tier, kernels_only=False):
  """vtc_tpu's K17 reference at a world of 1; kernels_only: of the kernels
  alone (the data-parallel trainer's result)."""
  x, d, _, _ = _problem()
  fn = functools.partial(_jax_k17, 1)
  if kernels_only:
    fn = lambda a, b, mxu: _jax_k17(1, a, b, mxu)[:d.size]
  return _reference(fn, x, d, tier)


@pytest.mark.parametrize("tier", TIERS)
def test_k17_world_of_one_matches_pallas_at_each_tier(tier):
  x, d, _, v0 = _problem()
  want, full, moved = _k17_reference(tier)
  check_tier(lambda mxu: flat(fused_conv_dp_train.fused_conv_dp_train_segment(
      _t(d), torch.zeros(6), _t(v0), _t(x), LAM, ITERS, UPD,
      mesh=parallel.make_mesh(), kernel_stride=STRIDE, padding=PADDING,
      power_iters=2, mxu=mxu)[:3]), want, full, moved, tier, "K17 world 1")
  assert fused_conv_dp_train.tier_launches == 0


WORLD_TIERS = ("bf16x3",)


@functools.lru_cache(maxsize=None)
def _world_of_two():
  x, d, _, v0 = _problem()
  cases = [(tier, "conv_dp_runner", dict(
      d=d, h=np.zeros(6, np.float32), v=v0, batches=x, sw=LAM, n_it=ITERS,
      upd_step=UPD, inference_alg="fista", update_alg=CQ,
      config=dict(kernel_stride=STRIDE, padding=PADDING, upd_num_iters=1,
                  mxu=tier))) for tier in WORLD_TIERS + ("highest",)]
  return worker.run_ranks(2, cases)


@pytest.mark.parametrize("tier", WORLD_TIERS)
def test_k17_world_of_two_matches_pallas(tier):
  """Two spawned ranks, each its shard of 2: the ranks bitwise equal, and
  at vtc_tpu's K17 on two devices under the tier's check (vtc_tpu's spread
  and 'highest' at a world of 1: the sum over the shards differs from the
  whole batch's in the last bits only, which the noise takes in)."""
  x, d, _, _ = _problem()
  ranks = _world_of_two()
  for key in WORLD_TIERS + ("highest",):
    for a, b in zip(ranks[0][key], ranks[1][key]):
      assert np.array_equal(a, b), "%s: the ranks differ" % key
  _, full, moved = _k17_reference(tier)
  check_tier(lambda mxu: flat(ranks[0][mxu]), _jax_k17(2, x, d, tier), full,
             moved, tier, "K17 world 2")


# ---------------------------------------------------------------------------
# the encode and the trainers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tier,data_parallel", [("bf16x5", False),
                                                ("bf16", True)],
                         ids=["bf16x5", "bf16 data-parallel"])
def test_conv_encode_matches_vtc_tpu(tier, data_parallel):
  """encode_dataset(mode='convolutional', formulation='pallas') at a tier
  ('bf16' spelled as the trainers do), one batch of 4: vtc_tpu's encode,
  which is its K10 on that batch."""
  x, d, _, _ = _problem()
  jax_mesh = jax_parallel.make_mesh(data=1) if data_parallel else None
  kw = dict(mode="convolutional", kernel_stride=STRIDE, padding=PADDING,
            batch_size=4, chunk_batches=1, formulation="pallas")
  want = np.asarray(jax_encode_dataset(x[0], d, LAM, ITERS,
                                       mxu_precision=tier,
                                       data_parallel=jax_mesh, **kw))
  ref, full, moved = _k10_reference("fista soft", tier)
  assert float(np.abs(want - ref).max()) <= 1e-6
  mesh = parallel.make_mesh() if data_parallel else None
  check_tier(lambda mxu: encode_dataset(
      x[0], d, LAM, ITERS, mxu_precision=mxu, device="cpu",
      data_parallel=mesh, **kw), want, full, moved, tier,
             "encode_dataset conv%s" % (" DP" if data_parallel else ""))


def _trainer_params(tier, **extra):
  params = {
      "mode": "convolutional", "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "dictionary_update_algorithm": CQ,
      "inference_param_schedule": {0: {"sparsity_weight": LAM,
                                       "num_iters": ITERS}},
      "dict_update_param_schedule": {0: {"stepsize": UPD, "num_iters": 1}},
      "strides": STRIDE, "padding": PADDING, "conv_formulation": "pallas",
      "train_precision": tier, "stdout_print_interval": 10**9}
  params.update(extra)
  return params


def test_vtc_tpu_scanned_trainer_takes_its_fused_k12_at_the_tier(
    monkeypatch):
  """vtc_tpu's scanned trainer on one device, its backend faked as a TPU
  so that it takes its fused K12 runner (the kernel in interpret mode), as
  vtc_tpu's own tests do: the runner gets the tier, and the kernels are its
  K12's two-step segment's at that tier (its seed is its own eigh's: equal
  up to that rounding)."""
  x, d, _, _ = _problem()
  original = jax_k12.fused_conv_train_segment_pallas

  def interpreted(*args, **kw):
    kw["interpret"] = True
    return original(*args, **kw)

  calls = []
  runner = jax_ce._fused_conv_segment_runner

  def spy(*args, **kw):
    calls.append(kw.get("mxu"))
    return runner(*args, **kw)

  monkeypatch.setattr(jax_k12, "fused_conv_train_segment_pallas",
                      interpreted)
  monkeypatch.setattr(jax_ce, "_fused_conv_segment_runner", spy)
  monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
  got = np.asarray(jax_ce.train_dictionary_scanned(
      x, x[:1], d.copy(), _trainer_params("bf16x3")))
  monkeypatch.undo()
  assert calls == ["bf16x3"]
  want, _, moved = _k12_reference("bf16x3", kernels_only=True)
  assert float(np.abs(got.ravel() - want).max()) <= max(1e-5, moved[0])


@pytest.mark.parametrize("tier", TIERS)
def test_scanned_trainer_matches_vtc_tpu(monkeypatch, tier):
  """train_dictionary_scanned(mode='convolutional', train_precision=) on
  one device takes K12 at the tier (its plain version here), as vtc_tpu's
  takes its fused K12: the kernels of vtc_tpu's two-step K12 segment from
  the trainers' exact seed."""
  x, d, _, _ = _problem()
  want, full, moved = _k12_reference(tier, kernels_only=True)
  seen = []
  original = fused_conv_train.fused_conv_train_segment

  def spy(*args, **kw):
    seen.append(kw.get("mxu"))
    return original(*args, **kw)

  monkeypatch.setattr(fused_conv_train, "fused_conv_train_segment", spy)
  check_tier(lambda mxu: compiled_epoch.train_dictionary_scanned(
      x, x[:1], _t(d), _trainer_params(mxu), device="cpu").numpy(),
             want.reshape(d.shape), full.reshape(d.shape), moved, tier,
             "scanned conv trainer")
  assert tier in seen and set(seen) <= {tier, "highest"}


@functools.lru_cache(maxsize=None)
def _jax_dp_trainer(tier):
  """vtc_tpu's scanned conv trainer with data_parallel on a 'data' axis of
  4 of its 8 CPU devices at the tier (off a TPU its whole-segment K17
  route needs a spare device, compiled_epoch.py:711-719): two steps of the
  problem's 8 images, a shard of two each.  Returns (the batches, its
  dictionary, the tiers its K17 runner was built with)."""
  x, d, _, _ = _problem()
  x8 = x.reshape(8, *x.shape[2:])
  x8 = np.stack([x8, x8[::-1]])
  built = []
  original = jax_ce._dp_rdma_conv_segment_runner

  def spy(*args, **kw):
    built.append(kw.get("mxu"))
    return original(*args, **kw)

  jax_ce._dp_rdma_conv_segment_runner = spy
  try:
    got = np.asarray(jax_ce.train_dictionary_scanned(
        x8, x8[0, :1], d.copy(), _trainer_params(
            tier, data_parallel=jax_parallel.make_mesh(data=4))))
  finally:
    jax_ce._dp_rdma_conv_segment_runner = original
  return x8, got, tuple(built)


@pytest.mark.parametrize("tier", TIERS)
def test_dp_scanned_trainer_matches_vtc_tpu_k17(monkeypatch, tier):
  """vtc_tpu's data-parallel conv trainer builds its K17 runner at the tier
  and then replaces it with its psum-per-op runner (the last branch of
  vtc_tpu/training/compiled_epoch.py:1160-1232 does not exclude
  dp_rdma_conv), so it runs full precision at every tier: its 'bf16' run
  on a 'data' axis of 4 of its CPU devices is its 'highest' run.  The
  port's trainer runs K17
  at 'highest' whatever the tier (bitwise its own 'highest' run, within
  test_torch_port_conv_parallel.py's relative 2e-5 of vtc_tpu's trainer at
  the tier), and K17 keeps its tiers: ``_dp_conv_segment_runner`` called
  directly at the tier is held to the kernels of vtc_tpu's two-step K17
  segment on a one-device axis from the exact seed."""
  x8, jax_bf16, built = _jax_dp_trainer("bf16")
  assert built == ("bf16",)  # K17's runner, built at the tier, then replaced
  assert np.array_equal(jax_bf16, _jax_dp_trainer("highest")[1])
  x, d, _, v0 = _problem()
  seen = []
  original = fused_conv_dp_train.fused_conv_dp_train_segment

  def spy(*args, **kw):
    seen.append(kw.get("mxu"))
    return original(*args, **kw)

  monkeypatch.setattr(fused_conv_dp_train, "fused_conv_dp_train_segment",
                      spy)
  runs = {mxu: compiled_epoch.train_dictionary_scanned(
      x8, x8[0, :1], _t(d), _trainer_params(mxu, data_parallel=True),
      device="cpu") for mxu in (tier, "highest")}
  assert seen and set(seen) == {"highest"}
  assert torch.equal(runs[tier], runs["highest"])
  want = _jax_dp_trainer(tier)[1]
  err = float(np.abs(runs[tier].numpy() - want).max())
  print("DP conv trainer at %s: max|d| %.3e from vtc_tpu's trainer" % (
      tier, err))
  assert err <= 2e-5 * max(1.0, float(np.abs(want).max()))
  monkeypatch.undo()
  want, full, moved = _k17_reference(tier, kernels_only=True)
  check_tier(lambda mxu: compiled_epoch._dp_conv_segment_runner(
      parallel.make_mesh(), "fista", CQ, 1, False, False, True, STRIDE,
      PADDING, mxu=mxu)(_t(d), torch.zeros(6), _t(v0), _t(x), LAM, ITERS,
                        UPD)[0].numpy(), want.reshape(d.shape),
             full.reshape(d.shape), moved, tier, "K17 runner")


def test_scanned_trainer_off_the_k12_gate_runs_highest():
  """s 20 kernels of 4x4 at stride 2 on one channel: s > R*cpx (16), off
  K12's gate, so the trainer runs the per-step scan at full precision
  whatever the tier (vtc_tpu's docstring: the XLA scan paths always run
  parity precision), bitwise its 'highest' run."""
  rng = np.random.RandomState(5)
  x = _images(rng, (2, 2, 1, 12, 12))
  d = _kernels(rng, 20, 1, 4)
  assert not fused_conv_train.fused_conv_segment_supported(
      x.shape[1:], d.shape, STRIDE, "fista", CQ)
  runs = {tier: compiled_epoch.train_dictionary_scanned(
      x, x[:1], _t(d), _trainer_params(tier), device="cpu")
          for tier in ("highest", "bf16x3", "bf16")}
  assert torch.equal(runs["bf16x3"], runs["highest"])
  assert torch.equal(runs["bf16"], runs["highest"])
  assert float((runs["highest"] - _t(d)).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# vtc_tpu's refusals, kept
# ---------------------------------------------------------------------------
def test_tiers_refused_where_vtc_tpu_refuses():
  x, d, eta, _ = _problem()
  kw = dict(stepsize=eta, mxu_precision="bf16x3")
  # 'gram' and 'direct' have no tier
  for formulation in ("gram", "direct"):
    with pytest.raises(AssertionError, match="pallas"):
      jax_conv_ista_fista.run(x[0], d, STRIDE, PADDING, LAM, ITERS,
                              formulation=formulation, **kw)
    with pytest.raises(ValueError, match="'pallas' formulation only"):
      ista_fista.run(x[0], _t(d), STRIDE, PADDING, LAM, ITERS,
                     formulation=formulation, **kw)
  # off K10's gate (c * sv * sh = 12 * 8 * 8 > 512): K11 has no tier
  rng = np.random.RandomState(12)
  x12 = _images(rng, (1, 12, 16, 16), ((8, 8), (8, 8)))
  d12 = _kernels(rng, 4, 12, 16, sigma=3.0)
  assert not fused_conv_direct.supported(x12.shape, d12.shape, (8, 8))
  with pytest.raises(AssertionError, match="direct conv kernel"):
    jax_conv_ista_fista.run(x12, d12, (8, 8), ((8, 8), (8, 8)), LAM, ITERS,
                            formulation="pallas", **kw)
  with pytest.raises(ValueError, match="K11"):
    ista_fista.run(x12, _t(d12), (8, 8), ((8, 8), (8, 8)), LAM, ITERS,
                   formulation="pallas", **kw)
  with pytest.raises(ValueError, match="no precision tier"):
    fused_conv_fista.fused_conv_fista_solve(
        _t(x12), _t(d12), LAM, ITERS, eta, kernel_stride=(8, 8),
        padding=((8, 8), (8, 8)), mxu="bf16x3")
  # a stop on 33 images: beyond vtc_tpu's one tile (at most 32)
  x33 = _images(rng, (33, 1, 12, 12))
  assert not pallas_conv_direct.early_stop_supported(x33.shape, d.shape,
                                                     STRIDE)
  assert not fused_conv_direct.early_stop_supported(x33.shape, d.shape,
                                                    STRIDE)
  assert fused_conv_direct.early_stop_supported(x33[:32].shape, d.shape,
                                                STRIDE)
  with pytest.raises(AssertionError, match="direct conv kernel"):
    jax_conv_ista_fista.run(x33, d, STRIDE, PADDING, LAM, ITERS,
                            formulation="pallas",
                            early_stopping_epsilon=1e-3, **kw)
  with pytest.raises(ValueError, match="one K10 tile"):
    ista_fista.run(x33, _t(d), STRIDE, PADDING, LAM, ITERS,
                   formulation="pallas", early_stopping_epsilon=1e-3, **kw)
  with pytest.raises(ValueError, match="early_stop_supported"):
    fused_conv_direct.fused_conv_direct_solve(
        _t(x33), _t(d), LAM, ITERS, eta, kernel_stride=STRIDE,
        padding=PADDING, mxu="bf16", early_stopping_epsilon=1e-3)
  # ... where 'highest' takes the stop on any batch (K10 on the card)
  fused_conv_direct.fused_conv_direct_solve(
      _t(x33), _t(d), LAM, 2, eta, kernel_stride=STRIDE, padding=PADDING,
      early_stopping_epsilon=1e-3)
  # the encode's CPU default 'gram' refuses a tier, as vtc_tpu's asserts
  with pytest.raises(ValueError, match="'pallas' formulation only"):
    encode_dataset(x[0], d, LAM, ITERS, mode="convolutional",
                   kernel_stride=STRIDE, padding=PADDING, batch_size=4,
                   mxu_precision="bf16x3", device="cpu")
  with pytest.raises(ValueError, match="tier"):
    fused_conv_direct.fused_conv_direct_solve(
        _t(x[0]), _t(d), LAM, ITERS, eta, kernel_stride=STRIDE,
        padding=PADDING, mxu="bf16x4")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_conv_tiers_match_plain():
  """K10, K12, K13 and K17 at every tier on the card against their plain
  versions at the tier, within the tier's floor; each launch counted as a
  tier launch (chip_smoke.py phase 48 holds the flagship shapes to phase
  46's three rules)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier kernel has no CPU mode")
  from test_torch_port_tiers import FLOOR
  dev = torch.device("cuda", 0)
  x, d, eta, v0 = _problem()
  xs, dt, vt = _t(x).to(dev), _t(d).to(dev), _t(v0).to(dev)
  h = torch.zeros(6, device=dev)
  kw = dict(kernel_stride=STRIDE, padding=PADDING)
  for tier in TIERS:
    runs = [
        (fused_conv_direct, "tier_launches", 1,
         lambda mod, m: fused_conv_direct.fused_conv_direct_solve(
             xs[0], dt, LAM, ITERS, eta, mxu=m, **kw),
         lambda m: fused_conv_direct.fused_conv_direct_plain(
             xs[0], dt, LAM, ITERS, eta, mxu=m, **kw)),
        (fused_conv_train, "tier_launches", 2,
         lambda mod, m: fused_conv_train.fused_conv_train_segment(
             dt, h, vt, xs, LAM, ITERS, UPD, power_iters=2, mxu=m, **kw),
         lambda m: fused_conv_train.fused_conv_train_plain(
             dt, h, vt, xs, LAM, ITERS, UPD, power_iters=2, mxu=m, **kw)),
        (fused_conv_train, "stats_tier_launches", 1,
         lambda mod, m: fused_conv_train.conv_solve_stats(
             dt, vt, xs[0], LAM, ITERS, power_iters=2, mxu=m, **kw),
         lambda m: fused_conv_train.conv_solve_stats_plain(
             dt, vt, xs[0], LAM, ITERS, power_iters=2, mxu=m, **kw)),
        (fused_conv_dp_train, "tier_launches", 2,
         lambda mod, m: fused_conv_dp_train.fused_conv_dp_train_segment(
             dt, h, vt, xs, LAM, ITERS, UPD, mesh=parallel.make_mesh(),
             power_iters=2, mxu=m, **kw),
         lambda m: fused_conv_dp_train.fused_conv_dp_train_plain(
             dt, h, vt, xs, LAM, ITERS, UPD, mesh=parallel.make_mesh(),
             power_iters=2, mxu=m, **kw))]
    for mod, counter, steps, run, plain in runs:
      before = getattr(mod, counter)
      got = run(mod, tier)
      assert getattr(mod, counter) == before + steps
      want = plain(tier)
      for g, w in zip(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,)):
        assert float((g - w).abs().max()) <= FLOOR[tier] * max(
            1.0, float(w.abs().max())), (mod.__name__, tier)
