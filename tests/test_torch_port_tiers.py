"""The precision tiers (bf16x5, bf16x3, bf16) of the fc/subspace solve and
trainers (K1, K4, K2, K6) against vtc_tpu on the CPU.

vtc_tpu splits each float32 operand of the iteration product into bfloat16
terms and sums single-pass bf16 products in float32 (``_make_iter_dot``,
``_make_group_prox``; vtc_tpu/ops/pallas_train_step.py:103-320).  The
port's plain versions compute the same passes as float32 products of the
bf16 values with TF32 off (``vtc_tpu_torch/ops/precision.py``); on the card
``csrc/fista_tier.cuh`` runs them on the tensor cores.  Here the same
seeded numpy inputs go through vtc_tpu's Pallas kernels in interpret mode
and the port's plain versions:

* K1: ``fista_solve_pallas``, fista soft and ista hard nonneg;
* K4: ``group_fista_solve_pallas`` on the packed codes, contiguous
  groups of 4 (the rotate-and-add prox) and a ragged layout of M = 6,
  where ``_make_prox_dots`` rounds the window sums and the scale
  (``K4_CASES`` says why the ragged cases are short);
* K2 and K6: two-step segments, K6 on a ragged M = 3 layout, so that at
  'bf16' the bf16 pass of c and the rounded unpack run too;
* the entries ``ista_fista.run``, ``subspace_ista_fista.run``,
  ``encode_dataset`` (fc and subspace, 'pallas') and
  ``train_dictionary_scanned`` with ``train_precision`` (held to vtc_tpu's
  fused segment kernel at the tier, which its trainer runs on a TPU);
* a tier with the early stop on a batch inside vtc_tpu's one-tile gate
  (its kernel's while_loop at the tier) and one beyond it, where vtc_tpu
  and the port solve at full precision: the port's codes there equal its
  'highest' codes bit for bit.

Tolerance, per tier: the larger of a floor (FLOOR, times the largest
value) and vtc_tpu's own spread, the most its result moves under five
random-direction one-ulp nudges of the input (ROADMAP.md §3's method):
'bf16' is discontinuous, since a one-ulp change of z can flip its
rounding.  Control: the port sits at least CONTROL times closer (in the
Frobenius norm, which a few flipped hard-threshold codes do not dominate)
to vtc_tpu's same tier than vtc_tpu's tier sits to its 'highest', so a
port that ignored the tier would fail.  That takes the noise, the larger
of vtc_tpu's own Frobenius spread under the nudges and the port's
distance from vtc_tpu at 'highest', to be below a tenth of the tier's
effect (bf16x3's split turns last-bit differences into up to 2^-17 of a
value, so the two packages sit one to two noises apart).  Where it is
not (bf16x3 through a trainer's updates or a stepsize of each package's
own eigvalsh: a spread of 3.3e-5 against a tier effect of 1.06e-4
measured on the K6 case, so no implementation could show 5x), the
control is instead that the port sits within three times the noise of
vtc_tpu's tier and that its own tier moves it from its own 'highest' by
within a factor of 2 of what vtc_tpu's tier moves vtc_tpu.
The tier kernel itself runs only on a card: chip_smoke.py phase 46.
"""
import functools

import numpy as np
import pytest
import torch

from vtc_tpu.analysis_transforms.fully_connected import (
    ista_fista as jax_fc)
from vtc_tpu.analysis_transforms.fully_connected import (
    subspace_ista_fista as jax_sub)
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.ops.pallas_fista import early_stop_tile_fits, fista_solve_pallas
from vtc_tpu.ops.pallas_group_fista import (group_early_stop_tile_fits,
                                            group_fista_solve_pallas,
                                            membership_matrix)
from vtc_tpu.ops.pallas_train_step import (fused_group_train_segment_pallas,
                                           fused_train_segment_pallas,
                                           roll_prox_window)
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista as sub)
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import fused_fista, fused_group_fista
from vtc_tpu_torch.ops import fused_group_train_step, fused_train_step
from vtc_tpu_torch.ops import lipschitz, precision
from vtc_tpu_torch.training import compiled_epoch, sparse_coding

TIERS = ("bf16x5", "bf16x3", "bf16")
SOLVE_TIER = {"bf16x5": "bf16x5", "bf16x3": "bf16x3", "bf16": "default"}
FLOOR = {"bf16x5": 1e-5, "bf16x3": 2e-5, "bf16": 2e-3}
CONTROL = 5.0
LAM, ITERS = 0.1, 50
B, N, S = 64, 64, 128
CONTIGUOUS = [list(range(i, i + 4)) for i in range(0, 64, 4)]
RAGGED = []
for _lo, _hi in zip([0, 6, 9, 14, 15, 21, 25, 31, 34, 39, 45, 48, 54, 58],
                    [6, 9, 14, 15, 21, 25, 31, 34, 39, 45, 48, 54, 58, 64]):
  RAGGED.append(list(range(_lo, _hi)))  # M = 6, sizes 1 to 6
GROUPS = {"contiguous": CONTIGUOUS, "ragged": RAGGED}
SEG_GROUPS = [[0, 1, 2], [3, 4], [5, 6, 7], [8], [9, 10, 11], [12, 13],
              [14, 15, 16], [17, 18, 19], [20, 21], [22, 23]]  # M = 3
# The segments and trainers run SEG_ITERS iterations a step, the encodes
# ENC_ITERS: bf16x3's split turns a one-ulp difference of z near a bf16
# rounding boundary into one of 2^-17 of z, and the update and a stepsize
# of each package's own eigvalsh carry such differences on, so that at 12
# iterations a step vtc_tpu's own nudge spread reached a fifth of its
# tier's distance from 'highest', where no implementation could show the
# control (measured on these inputs).
SEG_ITERS, ENC_ITERS = 4, 20


def nudged(a, seed):
  """a with every entry moved one ulp up or down at random."""
  up = np.random.RandomState(seed).rand(*a.shape) < 0.5
  return np.where(up, np.nextafter(a, np.float32(np.inf)),
                  np.nextafter(a, np.float32(-np.inf))).astype(np.float32)


def spread(fn, a, want):
  """How far fn moves from want under five nudges of its input a: the
  largest max-abs and Frobenius distances."""
  moved = [np.asarray(fn(nudged(a, seed)), np.float64) - want
           for seed in range(5)]
  return (max(float(np.abs(m).max()) for m in moved),
          max(float(np.linalg.norm(m)) for m in moved))


_PORT_FULL = {}  # the port's 'highest' result of each case, by its label


def check_tier(port, want, full, moved, tier, what):
  """port(mxu): the port's result at a tier; want and full: vtc_tpu's at
  the tier and at 'highest'; moved: vtc_tpu's spread at the tier; what:
  the case's label, the same at every tier."""
  got = np.asarray(port(tier), np.float64)
  if what not in _PORT_FULL:
    _PORT_FULL[what] = np.asarray(port("highest"), np.float64)
  own_full = _PORT_FULL[what]
  want, full = np.asarray(want, np.float64), np.asarray(full, np.float64)
  bound = max(FLOOR[tier] * max(1.0, float(np.abs(want).max())), moved[0])
  err = float(np.abs(got - want).max())
  dist = float(np.linalg.norm(got - want))
  control = float(np.linalg.norm(want - full))
  noise = max(moved[1], float(np.linalg.norm(own_full - full)))
  own = float(np.linalg.norm(got - own_full))
  print("%s %s: max|d| %.3e (bound %.3e); %.3e from vtc_tpu's tier, which "
        "is %.3e from its 'highest' (noise %.3e; the port's tier moves it "
        "%.3e)" % (what, tier, err, bound, dist, control, noise, own))
  assert err <= bound, "%s %s: max|d| %.3e > %.3e" % (what, tier, err, bound)
  if 2.0 * CONTROL * noise <= control:
    assert CONTROL * dist <= control, (
        "%s %s: %.3e from vtc_tpu's tier, which is %.3e from its 'highest'"
        % (what, tier, dist, control))
  else:
    assert dist <= 3.0 * noise, "%s %s: %.3e from vtc_tpu's tier > three " \
        "times the noise %.3e" % (what, tier, dist, noise)
    assert 0.5 * control <= own <= 2.0 * control, (
        "%s %s: the port's tier moves it %.3e, vtc_tpu's %.3e"
        % (what, tier, own, control))


@functools.lru_cache(maxsize=None)
def _problem():
  rng = np.random.RandomState(0)
  basis = rng.randn(16, N) / 4
  x = (rng.randn(B, 16) @ basis + 0.05 * rng.randn(B, N)).astype(np.float32)
  d = rng.randn(S, N).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  eta = np.float32(1.0 / np.linalg.eigvalsh(
      (d @ d.T).astype(np.float64)).max())
  return x, d, eta


K1_CASES = {"fista": dict(variant="fista"),
            "ista hard nonneg": dict(variant="ista", hard=True, nonneg=True)}


@functools.lru_cache(maxsize=None)
def _k1_reference(case, tier):
  """vtc_tpu's K1 at the tier and at 'highest', and its nudge spread."""
  x, d, eta = _problem()

  def solve(images, mxu):
    return np.asarray(fista_solve_pallas(
        images, d, LAM, ITERS, eta, interpret=True, mxu_precision=mxu,
        **K1_CASES[case]))

  want = solve(x, SOLVE_TIER[tier])
  return want, solve(x, "highest"), spread(
      lambda a: solve(a, SOLVE_TIER[tier]), x, want)


@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("tier", TIERS)
def test_k1_matches_pallas_at_each_tier(case, tier):
  x, d, eta = _problem()
  want, full, moved = _k1_reference(case, tier)
  check_tier(lambda mxu: fused_fista.fused_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), LAM, ITERS,
      torch.tensor(eta), mxu=mxu, **K1_CASES[case]), want, full, moved,
             tier, "K1 " + case)


@functools.lru_cache(maxsize=None)
def _groups_problem(layout):
  """An overcomplete group problem (64 atoms of n 32), the stepsize of its
  grouped dictionary (given to both packages) and a random warm start."""
  rng = np.random.RandomState(1)
  basis = rng.randn(8, 32) / 3
  x = (rng.randn(B, 8) @ basis + 0.05 * rng.randn(B, 32)).astype(np.float32)
  d = rng.randn(64, 32).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  gather, mask, _ = sub.group_layout(GROUPS[layout], 64, "cpu")
  dg = sub.build_grouped_dictionary(torch.from_numpy(d), gather,
                                    mask).numpy()
  eta = np.float32(1.0 / np.linalg.eigvalsh(
      (dg @ dg.T).astype(np.float64)).max())
  z0 = (rng.randn(B, 64) * 0.5).astype(np.float32)
  return x, d, eta, z0


@functools.lru_cache(maxsize=None)
def _packed(layout):
  """K4's own inputs for a layout: the grouped dictionary, its window M,
  vtc_tpu's membership operand and rotate window, the packed warm start."""
  x, d, _, z0 = _groups_problem(layout)
  gather, mask, _ = sub.group_layout(GROUPS[layout], 64, "cpu")
  dg = sub.build_grouped_dictionary(torch.from_numpy(d), gather,
                                    mask).numpy()
  g, m = gather.shape
  init = sub.pack_codes(torch.from_numpy(z0), gather, mask).reshape(
      B, g * m).numpy()
  expand = membership_matrix(g, m, mask.numpy().astype(np.float32))
  return dg, m, expand, roll_prox_window(GROUPS[layout]), init


# K4's cases: (layout, variant, hard, iterations, warm start).  On the
# ragged layout the frameworks' float32 sums differ by an ulp in many
# entries every iteration, which FISTA and ISTA carry forward as fast as
# bf16x5's and bf16x3's own effect (3-4x apart after 10 iterations, 9-12x
# after one; measured on these inputs), so its cases take one iteration
# from a random start: enough to hold the prox-dot rounding and the
# control.  The contiguous layout runs the full solve.
K4_CASES = {"contiguous fista": ("contiguous", "fista", False, ITERS, False),
            "ragged soft": ("ragged", "fista", False, 1, True),
            "ragged hard": ("ragged", "ista", True, 1, True)}


@functools.lru_cache(maxsize=None)
def _k4_reference(case, tier):
  layout, variant, hard, iters, warm = K4_CASES[case]
  x, _, eta, _ = _groups_problem(layout)
  dg, _, expand, roll, init = _packed(layout)

  def solve(images, mxu):
    return np.asarray(group_fista_solve_pallas(
        images, dg, expand, LAM, iters, eta,
        initial_grouped=init if warm else None, variant=variant, hard=hard,
        interpret=True, mxu_precision=mxu, roll_window=roll))

  want = solve(x, SOLVE_TIER[tier])
  return want, solve(x, "highest"), spread(
      lambda a: solve(a, SOLVE_TIER[tier]), x, want)


@pytest.mark.parametrize("case", sorted(K4_CASES))
@pytest.mark.parametrize("tier", TIERS)
def test_k4_matches_pallas_at_each_tier(case, tier):
  layout, variant, hard, iters, warm = K4_CASES[case]
  x, _, eta, _ = _groups_problem(layout)
  dg, m, _, _, init = _packed(layout)
  want, full, moved = _k4_reference(case, tier)
  check_tier(lambda mxu: fused_group_fista.fused_group_fista_solve(
      torch.from_numpy(x), torch.from_numpy(dg), m, LAM, iters,
      torch.tensor(eta), initial_grouped=(torch.from_numpy(init) if warm
                                          else None),
      variant=variant, hard=hard, mxu=mxu), want, full, moved, tier,
             "K4 " + case)


def _segment_problem(s=24, n=16, b=10, k=2):
  rng = np.random.RandomState(3)
  basis = rng.randn(6, n)
  batches = (rng.randn(k * b, 6) @ basis + 0.1 * rng.randn(k * b, n)).astype(
      np.float32).reshape(k, b, n)
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  h = (rng.rand(s) * 0.01).astype(np.float32)
  return d, h, batches


@functools.lru_cache(maxsize=None)
def _segment_reference(kind, tier):
  """vtc_tpu's K2 or K6 segment at the tier and at 'highest' (the final
  dictionary and codes), and the nudge spread of both."""
  d, h, batches = _segment_problem()
  if kind == "K2":
    v = np.ones(16, np.float32)

    def run(x, mxu):
      out = fused_train_segment_pallas(
          d, h, v, x, 0.05, SEG_ITERS, 0.1, variant="fista",
          update_alg="sc_steepest_descent", power_iters=2, interpret=True,
          mxu=mxu)
      return np.concatenate([np.asarray(out[0]).ravel(),
                             np.asarray(out[3]).ravel()])
  else:
    v = np.ones(16, np.float32)

    def run(x, mxu):
      out = fused_group_train_segment_pallas(
          d, h, v, x, 0.05, SEG_ITERS, 0.1, group_assignments=SEG_GROUPS,
          variant="fista", update_alg="subspace_sc_steepest_descent",
          power_iters=2, interpret=True, mxu=mxu)
      return np.concatenate([np.asarray(out[0]).ravel(),
                             np.asarray(out[3]).ravel()])

  want = run(batches, tier)
  return want, run(batches, "highest"), spread(
      lambda a: run(a, tier), batches, want)


@pytest.mark.parametrize("kind", ["K2", "K6"])
@pytest.mark.parametrize("tier", TIERS)
def test_segments_match_pallas_at_each_tier(kind, tier):
  d, h, batches = _segment_problem()
  want, full, moved = _segment_reference(kind, tier)
  args = [torch.from_numpy(a) for a in (d, h, np.ones(16, np.float32),
                                        batches)]

  def port(mxu):
    if kind == "K2":
      out = fused_train_step.fused_train_segment(
          *args, 0.05, SEG_ITERS, 0.1, variant="fista",
          update_alg="sc_steepest_descent", power_iters=2, mxu=mxu)
    else:
      out = fused_group_train_step.fused_group_train_segment(
          *args, 0.05, SEG_ITERS, 0.1, group_assignments=SEG_GROUPS,
          variant="fista", update_alg="subspace_sc_steepest_descent",
          power_iters=2, mxu=mxu)
    return np.concatenate([out[0].numpy().ravel(), out[3].numpy().ravel()])

  check_tier(port, want, full, moved, tier, kind + " 2 steps")


@pytest.mark.parametrize("tier", TIERS)
def test_fc_run_matches_jax_at_each_tier(tier):
  x, d, eta = _problem()
  want = np.asarray(jax_fc.run(x, d, LAM, ITERS, stepsize=eta,
                               formulation="pallas",
                               mxu_precision=SOLVE_TIER[tier]))
  _, full, moved = _k1_reference("fista", tier)
  # 'default' and 'bf16' name one tier in the solvers, as in vtc_tpu
  check_tier(lambda mxu: ista_fista.run(
      x, d, LAM, ITERS, stepsize=torch.tensor(eta), formulation="pallas",
      mxu_precision=SOLVE_TIER[mxu] if mxu in SOLVE_TIER else mxu), want,
             full, moved, tier, "ista_fista.run")
  # 'gram' keeps full precision whatever the tier, as in vtc_tpu
  assert torch.equal(
      ista_fista.run(x, d, LAM, 5, mxu_precision=tier),
      ista_fista.run(x, d, LAM, 5))


@pytest.mark.parametrize("tier", TIERS)
def test_subspace_run_matches_jax_at_each_tier(tier):
  x, d, eta, _ = _groups_problem("contiguous")
  kw = dict(stepsize=eta, formulation="pallas")
  want = np.asarray(jax_sub.run(x, d, CONTIGUOUS, LAM, ITERS,
                                mxu_precision=SOLVE_TIER[tier], **kw))
  full = np.asarray(jax_sub.run(x, d, CONTIGUOUS, LAM, ITERS, **kw))
  moved = _k4_reference("contiguous fista", tier)[2]
  check_tier(lambda mxu: sub.run(
      x, d, CONTIGUOUS, LAM, ITERS, mxu_precision=mxu,
      **dict(kw, stepsize=torch.tensor(eta))), want, full, moved, tier,
             "subspace run")


@functools.lru_cache(maxsize=None)
def _encode_problem(groups):
  kw = dict(batch_size=32, chunk_batches=2, formulation="pallas")
  if groups is None:
    x, d, _ = _problem()
  else:
    x, d, _, _ = _groups_problem(groups)
    kw["group_assignments"] = GROUPS[groups]
  full = np.asarray(jax_encode_dataset(x, d, LAM, ENC_ITERS, **kw))
  return x, d, kw, full


@pytest.mark.parametrize("groups", [None, "contiguous"])
@pytest.mark.parametrize("tier", TIERS)
def test_encode_dataset_matches_jax_at_each_tier(groups, tier):
  """Each package takes the stepsize from its own eigvalsh here, so the
  spread nudges the dictionary, which moves that stepsize too."""
  x, d, kw, full = _encode_problem(groups)

  def encode(dictionary):
    return np.asarray(jax_encode_dataset(x, dictionary, LAM, ENC_ITERS,
                                         mxu_precision=tier, **kw))

  want = encode(d)
  check_tier(lambda mxu: encode_dataset(x, d, LAM, ENC_ITERS,
                                        mxu_precision=mxu, device="cpu",
                                        **kw),
             want, full, spread(encode, d, want), tier,
             "encode_dataset %s" % groups)


def _trainer_params(tier, groups):
  params = {
      "mode": "fully-connected", "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {0: {"sparsity_weight": 0.05,
                                       "num_iters": SEG_ITERS}},
      "dictionary_update_algorithm": "sc_steepest_descent",
      "dict_update_param_schedule": {0: {"stepsize": 0.1, "num_iters": 1}},
      "fc_formulation": "pallas", "train_precision": tier,
      "stdout_print_interval": 10**9,
  }
  if groups is not None:
    params.update(code_inference_algorithm="subspace_fista",
                  dictionary_update_algorithm="subspace_sc_steepest_descent",
                  group_assignments=groups)
  return params


@pytest.mark.parametrize("groups", [None, SEG_GROUPS],
                         ids=["fc", "subspace"])
@pytest.mark.parametrize("tier", TIERS)
def test_scanned_trainer_runs_the_tier(groups, tier):
  """train_dictionary_scanned at a tier is vtc_tpu's fused segment at the
  tier (what its trainer runs on a TPU; on the CPU its trainer takes the
  full-precision XLA path), from the same exact eigenvector seed."""
  d, _, batches = _segment_problem()
  kind = "K2" if groups is None else "K6"
  # the trainer's own exact seed (compiled_epoch's seed_eigvec)
  v0 = lipschitz.top_gram_eigenpair(sparse_coding.lipschitz_matrix(
      torch.from_numpy(d), "fista" if groups is None else "subspace_fista",
      groups))[1].numpy()

  def run(x, mxu):
    kw = dict(variant="fista", power_iters=2, interpret=True, mxu=mxu)
    if groups is None:
      out = fused_train_segment_pallas(
          d, np.zeros(24, np.float32), v0, x, 0.05, SEG_ITERS, 0.1,
          update_alg="sc_steepest_descent", **kw)
    else:
      out = fused_group_train_segment_pallas(
          d, np.zeros(24, np.float32), v0, x, 0.05, SEG_ITERS, 0.1,
          group_assignments=groups,
          update_alg="subspace_sc_steepest_descent", **kw)
    return np.asarray(out[0])

  want = run(batches, tier)
  check_tier(lambda mxu: compiled_epoch.train_dictionary_scanned(
      batches, batches[:1], d, _trainer_params(mxu, groups), device="cpu"),
             want, run(batches, "highest"),
             spread(lambda a: run(a, tier), batches, want), tier,
             "train_dictionary_scanned " + kind)


def test_tier_with_stop_inside_vtc_tpus_tile():
  x, d, eta = _problem()
  assert early_stop_tile_fits(B, S) and fused_fista.early_stop_tile_fits(B, S)
  kw = dict(stepsize=eta, formulation="pallas", early_stopping_epsilon=2e-2)
  want = np.asarray(jax_fc.run(x, d, LAM, 200, mxu_precision="bf16x3", **kw))
  full = np.asarray(jax_fc.run(x, d, LAM, 200, **kw))
  moved = spread(lambda a: np.asarray(jax_fc.run(
      a, d, LAM, 200, mxu_precision="bf16x3", **kw)), x, want)
  check_tier(lambda mxu: ista_fista.run(
      x, d, LAM, 200, mxu_precision=mxu,
      **dict(kw, stepsize=torch.tensor(eta))), want, full, moved, "bf16x3",
             "stopped run")


def test_tier_with_stop_beyond_vtc_tpus_tile_runs_highest():
  """Beyond vtc_tpu's one-tile gate a tier with a stop solves at full
  precision (vtc_tpu falls back to its 'gram' loop), fc and subspace."""
  rng = np.random.RandomState(5)
  b, n = 4100, 16
  x = rng.randn(b, n).astype(np.float32)
  d = rng.randn(S, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  assert not early_stop_tile_fits(b, S)
  assert not fused_fista.early_stop_tile_fits(b, S)
  kw = dict(formulation="pallas", early_stopping_epsilon=1e-3)
  full = ista_fista.run(x, d, LAM, 10, **kw)
  for tier in TIERS:
    assert torch.equal(ista_fista.run(x, d, LAM, 10, mxu_precision=tier,
                                      **kw), full)
  want = np.asarray(jax_fc.run(x, d, LAM, 10, mxu_precision="bf16x3", **kw))
  assert float(np.abs(full.numpy() - want).max()) <= 2e-5
  gm, g = len(CONTIGUOUS) * 4, len(CONTIGUOUS)
  assert not group_early_stop_tile_fits(b, gm, g)
  assert not fused_group_fista.group_early_stop_tile_fits(b, gm, g)
  assert fused_group_fista.group_early_stop_tile_fits(B, gm, g)
  full = sub.run(x, d[:64], CONTIGUOUS, LAM, 10, **kw)
  assert torch.equal(sub.run(x, d[:64], CONTIGUOUS, LAM, 10,
                             mxu_precision="bf16", **kw), full)


def test_tier_helpers_split_as_vtc_tpu():
  """split_hi_lo and split3 are vtc_tpu's: hi + mid + lo is x exactly,
  hi + lo carries about 16 bits; a tier takes the tier kernel and no
  forced route."""
  x = torch.from_numpy(np.random.RandomState(2).randn(4096).astype(
      np.float32))
  hi, mid, lo = precision.split3(x)
  assert torch.equal(hi + mid + lo, x)
  for term in (hi, mid, lo):
    assert torch.equal(term.to(torch.bfloat16).float(), term)
  h2, l2 = precision.split_hi_lo(x)
  assert torch.equal(h2, hi) and torch.equal(l2, mid)
  assert float(((h2 + l2 - x).abs() / x.abs()).max()) < 2.0 ** -15
  assert precision.resolve_tier("default") == "bf16"
  with pytest.raises(ValueError, match="tier"):
    precision.resolve_tier("tf32x3")
  gram, corr = torch.eye(8), torch.zeros(2, 8)
  for launch, args in ((fused_fista._launch, (0, 0)),
                       (fused_group_fista._launch, (2, 1, 0))):
    with pytest.raises(ValueError, match="route must be 'auto'"):
      launch(gram, corr, None, torch.ones(1), LAM, 1, *args,
             route="classic", mxu="bf16x3")


@pytest.mark.cuda
def test_cuda_tier_kernel_matches_plain():
  """The tier kernel against its plain version on the card: one
  iteration from random codes, every tier, K1 and K4 (chip_smoke.py phase
  46 runs the full set at the flagship width)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier kernel has no CPU mode")
  dev = torch.device("cuda", 0)
  x, d, eta = _problem()
  xt, dt = torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)
  z0 = torch.from_numpy(np.random.RandomState(4).randn(B, S).astype(
      np.float32)).to(dev)
  for tier in TIERS:
    before = fused_fista.launches
    got = fused_fista.fused_fista_solve(xt, dt, LAM, 1, eta, mxu=tier,
                                        initial_codes=z0)
    assert fused_fista.launches == before + 1
    assert fused_fista.last_route in fused_fista.TIER_ROUTES
    want = fused_fista.fused_fista_plain(xt, dt, LAM, 1, eta, mxu=tier,
                                         initial_codes=z0)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    flat = fused_group_fista.fused_group_fista_solve(
        xt, dt[:60], 6, LAM, 1, eta, mxu=tier,
        initial_grouped=z0[:, :60].contiguous())
    want = fused_group_fista.fused_group_fista_plain(
        xt, dt[:60], 6, LAM, 1, eta, mxu=tier,
        initial_grouped=z0[:, :60].contiguous())
    assert float((flat - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def _stop_eps(avgs, which):
  """chip_smoke.py's stop_eps: stop at k = 1, at a clear new low past the
  first quarter, or never."""
  if which == "never":
    return 0.0
  if which == "early":
    return 1.5 * avgs[0]
  for k in range(max(2, len(avgs) // 4), len(avgs)):
    low = min(avgs[:k])
    if avgs[k] < 0.95 * low:
      return float(np.sqrt(avgs[k] * low))
  return float(avgs[len(avgs) // 2])


@pytest.mark.cuda
def test_cuda_tier_stop_matches_plain():
  """The tier routes' STOP builds on the card (the resident route's stop
  warp at this shape): K1 and K4 at every tier with eps at k = 1, mid-run
  and never stop at the plain version's count, give the tier kernel's
  codes without the stop at that count bit for bit, and stay within the
  tier's floor of plain (chip_smoke.py phase 46 runs the full set)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier kernel has no CPU mode")
  from vtc_tpu_torch.ops import solver
  dev = torch.device("cuda", 0)
  x, d, eta = _problem()
  xt, dt = torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)
  cases = {
      "K1": (fused_fista, lambda it, mxu, eps=None: (
          fused_fista.fused_fista_solve(xt, dt, LAM, it, eta, mxu=mxu,
                                        early_stopping_epsilon=eps)),
             lambda it, mxu, eps=None: fused_fista.fused_fista_plain(
                 xt, dt, LAM, it, eta, mxu=mxu, early_stopping_epsilon=eps)),
      "K4": (fused_group_fista, lambda it, mxu, eps=None: (
          fused_group_fista.fused_group_fista_solve(
              xt, dt, 4, LAM, it, eta, mxu=mxu, early_stopping_epsilon=eps)),
             lambda it, mxu, eps=None: (
                 fused_group_fista.fused_group_fista_plain(
                     xt, dt, 4, LAM, it, eta, mxu=mxu,
                     early_stopping_epsilon=eps)))}
  for mod, run, plain in cases.values():
    for tier in TIERS:
      plain(ITERS, tier, 0.0)
      avgs = list(solver.last_avgs)
      for which in ("early", "mid", "never"):
        eps = _stop_eps(avgs, which)
        got = run(ITERS, tier, eps)
        assert mod.last_route in fused_fista.TIER_ROUTES
        its = int(mod.last_iters.item())
        want = plain(ITERS, tier, eps)
        assert its == solver.last_iters, (tier, which)
        assert torch.equal(got, run(its, tier)), (tier, which)
        assert float((got - want).abs().max()) <= FLOOR[tier] * max(
            1.0, float(want.abs().max())), (tier, which)
