"""The precision tiers (bf16x5, bf16x3, bf16) of K19, the residual-form
segment for big dictionaries, and of its runner against vtc_tpu on the
CPU, at a code axis of 1.

vtc_tpu's K19 takes the tier on the solve's two products, the
reconstruction z D and the gradient (z D - X) D^T, with both operands split
into bf16 terms (``_make_tier_dots``, vtc_tpu/ops/pallas_code_shard_train.py
:88-117), and rounds the group prox's window sums and scale at the tier
on its membership products, but not on its rotate window
(``_make_group_prox``, :241); the Gram, the refresh, the update and the
regularizer stay float32.  The port's plain version computes the same
passes (``ops/precision.ns_dot``; z D a kSplitK chunk at a time,
``precision.split_k_dot``, as the kernels' split sum adds them) and rounds
the member table's prox where vtc_tpu's membership products do
(``fused_code_shard_train.prox_plan``).  The same seeded numpy inputs (k
2, b 8, s 128, n 32, FISTA 5) go through vtc_tpu's K19 in interpret mode
on a 1 x 1 mesh (tests/test_torch_port_code_shard.py's ``_pallas``) and
the port's plain version:

* FISTA cheap-quad, ISTA nonneg, hard thresholds and the early stop (fc);
* contiguous groups of 4 (vtc_tpu's rotate window: float32 sums), a
  ragged partition (the membership prox at the tier) and the regularizer;
* the two layouts where the port's own window rule and vtc_tpu's rotate
  rule disagree: contiguous groups of 8 in reversed column order (the
  port has a window, vtc_tpu the membership products, so the port rounds)
  and contiguous groups of 64 (vtc_tpu's rotate window, wider than the
  port's in-warp 32, so the port's member table sums in float32); each
  pinned by the form vtc_tpu sits nearer to;
* the runner (``compiled_epoch._code_shard_segment_runner``) at each tier
  against vtc_tpu's runner on ``make_mesh(data=1, code=1)``, fc and
  grouped; and an unknown tier, which raises ValueError.

Tolerance, per tier: tests/test_torch_port_tiers.py's bound, the larger of
the tier's floor (FLOOR, times the largest value) and vtc_tpu's own spread,
the most its result moves under five random-direction one-ulp nudges of
both the batches and the dictionary (ROADMAP.md §3: nudge both), ten for
the hard case: at bf16 its last codes hold one at the hard threshold's
edge, which a one-ulp nudge of the dictionary flips by 0.037 in both
packages (measured: 2 of 8 nudges of the port, 1 of 6 of vtc_tpu), and five
nudges did not reach it. The spread costs an interpret-mode run a nudge
(0.8 s), so it is taken only where the floor alone does not hold the port:
the bound is the same. Control (Frobenius), where vtc_tpu's tier moves it
from its 'highest' by at least ten times the packages' distance at
'highest': the port sits nearer to vtc_tpu's tier than to vtc_tpu's
'highest' (the identity rule of chip_smoke.py's tier_verdict), and its own
tier moves it within a factor of 2 of what vtc_tpu's tier moves vtc_tpu; a
port that ignored the tier fails both. Where the tier's effect is within
ten times vtc_tpu's own spread (the flipped hard code), check_tier's
three-noise rule stands for the first. Every vtc_tpu reference is cached.
The kernels run only on a card: chip_smoke.py phase 50.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_port_code_shard import (_contiguous, _pallas, _port,
                                        _problem, _ragged)
from test_torch_port_tiers import FLOOR, nudged
from vtc_tpu.ops import pallas_code_shard_train as jcs
from vtc_tpu_torch.ops import fused_code_shard_train as cs
from vtc_tpu_torch.training import compiled_epoch

TIERS = ("bf16x5", "bf16x3", "bf16")
NUDGES = {"fista hard": 10}  # nudges of a case's spread (default 5)
ARGS = (0.1, 5, 0.05)  # sparsity weight, FISTA iterations, update stepsize
S = 128
SUB_CQ = "subspace_sc_cheap_quadratic_descent"
SUB_SD = "subspace_sc_steepest_descent"
LAYOUTS = {
    "contiguous 4s": lambda: _contiguous(S, 4),
    "ragged": lambda: _ragged(np.random.RandomState(3), S),
    "reversed 8s": lambda: _contiguous(S, 8)[::-1],
    "64s": lambda: _contiguous(S, 64),
}
# name -> (layout or None, alignment penalty, flags)
CASES = {
    "fista cheap-quad": (None, 0.0, dict(
        update_alg="sc_cheap_quadratic_descent")),
    "ista nonneg": (None, 0.0, dict(variant="ista", nonneg=True,
                                    update_alg="sc_steepest_descent")),
    "fista hard": (None, 0.0, dict(hard=True,
                                   update_alg="sc_steepest_descent")),
    "fista early stop": (None, 0.0, dict(update_alg="sc_steepest_descent",
                                         early_stopping_epsilon=5e-2)),
    "contiguous 4s": ("contiguous 4s", 0.0, dict(update_alg=SUB_CQ)),
    "ragged": ("ragged", 0.0, dict(update_alg=SUB_CQ)),
    "ragged penalty 0.15": ("ragged", 0.15, dict(update_alg=SUB_SD)),
}
# the layouts where the window rules part (test_prox_form_follows_...)
CASES.update({"reversed 8s": ("reversed 8s", 0.0, dict(update_alg=SUB_CQ)),
              "64s": ("64s", 0.0, dict(update_alg=SUB_CQ))})
MAIN = list(CASES)[:7]


def flat(outs):
  return np.concatenate([np.asarray(o, np.float64).ravel() for o in outs])


@functools.lru_cache(maxsize=None)
def _inputs():
  return _problem(np.random.RandomState(24))


@functools.lru_cache(maxsize=None)
def _arrays(layout):
  return cs.code_shard_group_arrays(LAYOUTS[layout](), S, 1)


def _kw(case):
  layout, penalty, flags = CASES[case]
  kw = dict(flags)
  if layout is not None:
    kw.update(group_arrays=_arrays(layout), penalty=penalty)
  return kw


def _vtc(case, mxu, x=None, d=None):
  d0, h, v, x0 = _inputs()
  return flat(_pallas(d0 if d is None else d, h, v, x0 if x is None else x,
                      *ARGS, mxu=mxu, **_kw(case)))


@functools.lru_cache(maxsize=None)
def _vtc_cached(case, mxu):
  return _vtc(case, mxu)


@functools.lru_cache(maxsize=None)
def _vtc_spread(case, mxu):
  """vtc_tpu's (max-abs, Frobenius) spread at the tier under the case's
  NUDGES of both the batches and the dictionary."""
  d, _, _, x = _inputs()
  want = _vtc_cached(case, mxu)
  count = NUDGES.get(case, 5)
  moved = [_vtc(case, mxu, nudged(x, seed), nudged(d, seed + count)) - want
           for seed in range(count)]
  return (max(float(np.abs(m).max()) for m in moved),
          max(float(np.linalg.norm(m)) for m in moved))


def _port_case(case, mxu, **extra):
  kw = _kw(case)
  if "group_arrays" in kw:
    kw["roll_window"] = jcs.roll_window_from_expand_arrays(
        kw["group_arrays"][0])
  kw.update(extra)
  return flat(_port(*_inputs(), *ARGS, mxu=mxu, **kw))


def check(label, tier, got, own_full, want, full, spread):
  """The tier bound and the control (see the module's docstring); spread()
  gives vtc_tpu's spread, called only where needed."""
  floor = FLOOR[tier] * max(1.0, float(np.abs(want).max()))
  err = float(np.abs(got - want).max())
  dist = float(np.linalg.norm(got - want))
  control = float(np.linalg.norm(want - full))
  hi_noise = float(np.linalg.norm(own_full - full))
  own = float(np.linalg.norm(got - own_full))
  moved = spread() if err > floor else None
  bound = max(floor, moved[0]) if moved else floor
  print("%s %s: max|d| %.3e (bound %.3e%s); %.3e from vtc_tpu's tier, "
        "which is %.3e from its 'highest' (the packages %.3e apart there; "
        "the port's tier moves it %.3e)" % (
            label, tier, err, bound, ", with the spread" if moved else "",
            dist, control, hi_noise, own))
  assert err <= bound, "%s %s: max|d| %.3e > %.3e" % (label, tier, err, bound)
  if control < 10.0 * hi_noise:
    return
  if moved and 10.0 * moved[1] > control:
    # the tier's effect within ten times vtc_tpu's own spread (a flipped
    # hard-thresholded code): check_tier's three-noise rule
    noise = max(moved[1], hi_noise)
    assert dist <= 3.0 * noise and 0.5 * control <= own <= 2.0 * control, (
        "%s %s: %.3e from vtc_tpu's tier (noise %.3e); the port's tier "
        "moves it %.3e, vtc_tpu's %.3e" % (label, tier, dist, noise, own,
                                           control))
    return
  nearer = float(np.linalg.norm(got - full))
  assert dist < nearer and 0.5 * control <= own <= 2.0 * control, (
      "%s %s: %.3e from vtc_tpu's tier and %.3e from its 'highest'; the "
      "port's tier moves it %.3e, vtc_tpu's %.3e" % (label, tier, dist,
                                                     nearer, own, control))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", MAIN)
def test_plain_matches_pallas_at_each_tier(case, tier):
  """D, h, v and the last codes of a two-step segment at the tier; a CPU
  tensor launches nothing."""
  before = (cs.launches, cs.tier_launches)
  got = _port_case(case, tier)
  assert (cs.launches, cs.tier_launches) == before
  check(case, tier, got, _port_case(case, "highest"),
        _vtc_cached(case, tier), _vtc_cached(case, "highest"),
        lambda: _vtc_spread(case, tier))


@pytest.mark.parametrize("layout", ["reversed 8s", "64s", "contiguous 4s",
                                    "ragged"])
def test_prox_form_follows_vtc_tpus_rotate_rule(layout):
  """prox_plan at every tier: 'highest' and vtc_tpu's rotate window sum in
  float32 (the port's window where it has one, else its member table);
  without the rotate window the member table rounds.  The two layouts
  where the rules part, at bf16 (where the rounding shows most): the port
  holds the tier bound, and vtc_tpu sits nearer to the form prox_plan
  picks than to the other."""
  expand = _arrays(layout)[0]
  roll = jcs.roll_window_from_expand_arrays(expand)
  assert roll == cs.roll_window_from_expand_arrays(expand)
  window = cs.group_members(expand[0])[1]
  assert (roll, window) == {"reversed 8s": (None, 8), "64s": (64, None),
                            "contiguous 4s": (4, 4),
                            "ragged": (None, None)}[layout]
  for tier in ("highest",) + TIERS:
    _, got_window, rounds = cs.prox_plan(expand[0], tier, roll)
    assert rounds == (tier != "highest" and roll is None)
    assert got_window == (None if rounds else window)
  if layout not in ("reversed 8s", "64s"):
    return
  want = _vtc_cached(layout, "bf16")
  picked = _port_case(layout, "bf16")
  check(layout, "bf16", picked, _port_case(layout, "highest"), want,
        _vtc_cached(layout, "highest"), lambda: _vtc_spread(layout, "bf16"))
  # the other form, through the plain version (the wrapper refuses a
  # roll_window that is not vtc_tpu's): a rotate window named (float32
  # sums), or none (the sums rounded)
  d, h, v, x = map(torch.from_numpy, _inputs())
  other = flat(cs.fused_code_sharded_train_segment_plain(
      d, h, v, x, *ARGS, expand_local=expand[0], power_iters=2, mxu="bf16",
      roll_window=8 if roll is None else None, **CASES[layout][2]))
  near, far = (float(np.linalg.norm(a - want)) for a in (picked, other))
  print("%s at bf16: %.3e from vtc_tpu with prox_plan's form, %.3e with "
        "the other" % (layout, near, far))
  assert near < far


def test_unknown_tier_raises():
  d, h, v, x = map(torch.from_numpy, _inputs())
  for mxu in ("default", "tf32", None):
    with pytest.raises(ValueError, match="unknown MXU tier"):
      cs.fused_code_sharded_train_segment(d, h, v, x, *ARGS, mxu=mxu)
    with pytest.raises(ValueError, match="unknown MXU tier"):
      compiled_epoch._code_shard_segment_runner(
          None, 1, 1, "fista", "sc_steepest_descent", 1, False, False, True,
          mxu=mxu)(d, h, v, x, *ARGS)


def _runner_flags(grouped):
  return ("fista", SUB_CQ if grouped else "sc_cheap_quadratic_descent", 1,
          False, False, True)


def _runner_inputs():
  d, h, v, x = _inputs()
  return d, h, v, x * 0.5  # test_torch_port_code_shard.py's runner scale


def _jax_runner(grouped, mxu, x=None, d=None):
  from vtc_tpu.parallel import make_mesh
  from vtc_tpu.training import compiled_epoch as jce
  d0, h, v, x0 = _runner_inputs()
  kw = dict(group_arrays=_arrays("contiguous 4s")) if grouped else {}
  out = jce._code_shard_segment_runner(
      make_mesh(data=1, code=1), 1, 1, *_runner_flags(grouped), mxu=mxu,
      **kw)(*map(jnp.asarray, (d0 if d is None else d, h, v,
                               x0 if x is None else x)),
            jnp.float32(ARGS[0]), jnp.int32(ARGS[1]), jnp.float32(ARGS[2]))
  return flat(out)


@functools.lru_cache(maxsize=None)
def _jax_runner_cached(grouped, mxu):
  return _jax_runner(grouped, mxu)


@functools.lru_cache(maxsize=None)
def _jax_runner_spread(grouped, mxu):
  d, _, _, x = _runner_inputs()
  want = _jax_runner_cached(grouped, mxu)
  moved = [_jax_runner(grouped, mxu, nudged(x, seed), nudged(d, seed + 5))
           - want for seed in range(5)]
  return (max(float(np.abs(m).max()) for m in moved),
          max(float(np.linalg.norm(m)) for m in moved))


def _port_runner(grouped, mxu):
  kw = dict(group_arrays=_arrays("contiguous 4s")) if grouped else {}
  return flat(compiled_epoch._code_shard_segment_runner(
      None, 1, 1, *_runner_flags(grouped), mxu=mxu, **kw)(
          *map(torch.from_numpy, _runner_inputs()), *ARGS))


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("grouped", [False, True])
def test_runner_matches_vtc_tpu_at_each_tier(grouped, tier):
  """The slice: the port's runner at the tier against vtc_tpu's runner on a
  1 x 1 mesh over a two-step segment (D, h and v)."""
  check("runner grouped" if grouped else "runner fc", tier,
        _port_runner(grouped, tier), _port_runner(grouped, "highest"),
        _jax_runner_cached(grouped, tier),
        _jax_runner_cached(grouped, "highest"),
        lambda: _jax_runner_spread(grouped, tier))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_k19_tiers_match_plain_on_both_routes():
  """K19 at every tier on both routes, forced, fc and ragged groups: the
  same bits, a tier launch a step, and within the tier's floor of the
  plain version at the tier (chip_smoke.py phase 50 holds bench's width to
  the three rules, the stop and the ranks)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier tile has no CPU mode")
  dev = torch.device("cuda", 0)
  d, h, v, x = (torch.from_numpy(a).to(dev) for a in _inputs())
  for layout in (None, "ragged"):
    table, window, rounds = None, None, False
    pk = {}
    for tier in TIERS:
      if layout is not None:
        expand = _arrays(layout)[0]
        table, window, rounds = cs.prox_plan(expand[0], tier, None)
        pk = dict(expand_local=expand[0])
      flags = dict(variant="fista", update_alg=SUB_CQ if layout else
                   "sc_cheap_quadratic_descent", upd_num_iters=1,
                   nonneg=False, hard=False, renormalize=True, power_iters=2,
                   lowest_code_val=0.001, alignment_penalty=0.0)
      runs = []
      for route in ("steps", "persistent"):
        before = cs.tier_launches
        runs.append(cs._launch(d, h, v, x, table, window, None, None,
                               *ARGS, route=route, mxu=tier,
                               prox_round=rounds, **flags))
        assert cs.tier_launches == before + x.shape[0]
      for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), tier
      want = cs.fused_code_sharded_train_segment_plain(
          d, h, v, x, *ARGS, mxu=tier, **pk, **flags)
      for g, w in zip(runs[1], want):
        assert float((g - w).abs().max()) <= FLOOR[tier] * max(
            1.0, float(w.abs().max())), tier
