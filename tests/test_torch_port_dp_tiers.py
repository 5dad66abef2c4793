"""The precision tiers (bf16x5, bf16x3, bf16) of the data-parallel fc and
subspace kernels K3, K7, K15 and K16, the data-parallel trainers and the
data-parallel encode against vtc_tpu on the CPU, at a world of one.

vtc_tpu's data-parallel kernels run the iteration product at the tier
(``_make_iter_dot``, its group prox through ``_make_prox_dots``) and keep
the Gram, the warm refresh, the statistics C, B and stat and the update at
'highest'; at 'bf16' c = X D^T is one bf16 pass
(vtc_tpu/ops/pallas_train_step.py:854-925, :1010-1080,
pallas_dp_train.py:129-190, pallas_group_dp_train.py:94-231).  The same
seeded numpy inputs (tests/test_torch_port_tiers.py's two-step segment
problem: s 24, n 16, batches of 10, FISTA 4) go through vtc_tpu's kernels
in interpret mode and the port's plain versions:

* K3 and K7 at each tier against ``fused_solve_stats_pallas`` and
  ``fused_group_solve_stats_pallas``, the codes, C, B, stat, the
  eigenvector and eta; K7 on the identity layout (contiguous groups of 4,
  where at 'bf16' K7 rounds every code slot, its unpack a bf16 product
  with no identity shortcut) and on a ragged layout of M = 3;
* K15 and K16 at each tier, two-step segments, against vtc_tpu's kernels
  in a ``shard_map`` over a one-device 'data' axis; K16 on both layouts
  (at 'bf16' vtc_tpu's K16 skips the rounding on the identity layout,
  pallas_group_dp_train.py:230-231, and so does the port);
* ``train_dictionary_scanned`` with ``data_parallel`` (a mesh of one: K15,
  K16) at each tier, fc and subspace, against vtc_tpu's trainer on its
  one-device mesh, where it takes its K15 and K16; a configuration that
  resolves to the psum-per-op step ('gram') bitwise its 'highest' run;
* ``encode_dataset(data_parallel=...)`` fc and subspace at each tier
  against vtc_tpu's encode on its one-device mesh;
* the refusals that stay: ICA (item 3a.2.3) and the code-sharded K19
  (item 3a.2.4); conv with data parallelism runs its tiers since K10's
  tier kernel (tests/test_torch_port_conv_tiers.py), and the conv encode
  refuses one only where vtc_tpu asserts (a formulation other than
  'pallas').

The worlds of 2 and 4 run in tests/test_torch_port_dp_segments.py's spawn.

Tolerance and control: tests/test_torch_port_tiers.py's ``check_tier``,
per tier the larger of its floor and vtc_tpu's own spread, here under five
random-direction one-ulp nudges of both the input and the dictionary
(ROADMAP.md §3), with that file's Frobenius control, so a port that
ignored the tier fails.  The kernels themselves run only on a card:
chip_smoke.py phase 47, whose checks the two cuda tests here name.
"""
import ctypes
import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec

from test_torch_port_tiers import SEG_ITERS, _segment_problem, check_tier
from test_torch_port_tiers import nudged
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.ops import pallas_dp_train as jax_k15
from vtc_tpu.ops import pallas_group_dp_train as jax_k16
from vtc_tpu.ops.pallas_train_step import (fused_group_solve_stats_pallas,
                                           fused_solve_stats_pallas)
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu_torch import parallel
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import (_build, fused_dp_train, fused_group_dp_train,
                               fused_group_train_step, fused_train_step,
                               lipschitz)
from vtc_tpu_torch.training import compiled_epoch, ica, sparse_coding

TIERS = ("bf16x5", "bf16x3", "bf16")
SW, UPD = 0.05, 0.1
CQ = "sc_cheap_quadratic_descent"
SUB_CQ = "subspace_" + CQ
IDENTITY = [list(range(i, i + 4)) for i in range(0, 24, 4)]
RAGGED = [[0, 1, 2], [3, 4], [5, 6, 7], [8], [9, 10, 11], [12, 13],
          [14, 15, 16], [17, 18, 19], [20, 21], [22, 23]]  # M = 3
LAYOUTS = {"identity": IDENTITY, "ragged": RAGGED}
ENC_ITERS = 20  # tests/test_torch_port_tiers.py's encode iterations


def spread(fn, x, d, want):
  """How far fn(x, d) moves from want under five nudges of both x and d:
  the largest max-abs and Frobenius distances."""
  moved = [np.asarray(fn(nudged(x, seed), nudged(d, seed + 5)), np.float64)
           - want for seed in range(5)]
  return (max(float(np.abs(m).max()) for m in moved),
          max(float(np.linalg.norm(m)) for m in moved))


def flat(outs):
  return np.concatenate([np.asarray(o, np.float64).ravel() for o in outs])


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _v0():
  return np.ones(16, np.float32)  # both packages normalize it first


# ---------------------------------------------------------------------------
# K3 and K7: one shard's solve and statistics
# ---------------------------------------------------------------------------
def _jax_stats(layout, x, d, mxu):
  kw = dict(power_iters=2, interpret=True, mxu=mxu)
  if layout is None:
    return flat(fused_solve_stats_pallas(d, _v0(), x, SW, SEG_ITERS, **kw))
  return flat(fused_group_solve_stats_pallas(
      d, _v0(), x, SW, SEG_ITERS, group_assignments=LAYOUTS[layout], **kw))


@functools.lru_cache(maxsize=None)
def _stats_reference(layout, tier):
  d, _, batches = _segment_problem()
  want = _jax_stats(layout, batches[0], d, tier)
  return want, _jax_stats(layout, batches[0], d, "highest"), spread(
      lambda x, dd: _jax_stats(layout, x, dd, tier), batches[0], d, want)


def _port_stats(layout, mxu):
  d, _, batches = _segment_problem()
  args = (_t(d), _t(_v0()), _t(batches[0]), SW, SEG_ITERS)
  if layout is None:
    return flat(fused_train_step.fused_solve_stats(*args, power_iters=2,
                                                   mxu=mxu))
  return flat(fused_group_train_step.fused_group_solve_stats(
      *args, group_assignments=LAYOUTS[layout], power_iters=2, mxu=mxu))


@pytest.mark.parametrize("layout", [None, "identity", "ragged"],
                         ids=["K3", "K7 identity", "K7 ragged"])
@pytest.mark.parametrize("tier", TIERS)
def test_solve_stats_match_pallas_at_each_tier(layout, tier):
  want, full, moved = _stats_reference(layout, tier)
  check_tier(lambda mxu: _port_stats(layout, mxu), want, full, moved, tier,
             "K3" if layout is None else "K7 " + layout)


# ---------------------------------------------------------------------------
# K15 and K16: whole segments on a one-device 'data' axis
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_segment_fn(layout, mxu):
  """vtc_tpu's K15 (layout None) or K16 in interpret mode inside a jitted
  shard_map over a one-device 'data' axis, built once per case."""
  rep = PartitionSpec()
  kw = dict(axis_name="data", axis_size=1, interpret=True, mxu=mxu,
            power_iters=2, variant="fista")
  if layout is None:
    kernel = functools.partial(jax_k15.fused_dp_train_segment_pallas,
                               update_alg=CQ, **kw)
  else:
    kernel = functools.partial(
        jax_k16.fused_group_dp_train_segment_pallas, update_alg=SUB_CQ,
        group_assignments=tuple(tuple(g) for g in LAYOUTS[layout]), **kw)

  def body(d, h, v, xs):
    return kernel(d, h, v, xs, SW, SEG_ITERS, UPD)

  return jax.jit(jax.shard_map(
      body, mesh=Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                      ("data", "code")),
      in_specs=(rep, rep, rep, PartitionSpec(None, "data", None)),
      out_specs=(rep,) * 4, check_vma=False))


def _jax_segment(layout, x, d, mxu):
  _, h, _ = _segment_problem()
  return flat(_jax_segment_fn(layout, mxu)(d, h, _v0(), x))


@functools.lru_cache(maxsize=None)
def _segment_reference(layout, tier):
  d, _, batches = _segment_problem()
  want = _jax_segment(layout, batches, d, tier)
  return want, _jax_segment(layout, batches, d, "highest"), spread(
      lambda x, dd: _jax_segment(layout, x, dd, tier), batches, d, want)


def _port_segment(layout, mxu):
  d, h, batches = _segment_problem()
  args = (_t(d), _t(h), _t(_v0()), _t(batches), SW, SEG_ITERS, UPD)
  kw = dict(mesh=parallel.make_mesh(), power_iters=2, mxu=mxu)
  if layout is None:
    return flat(fused_dp_train.fused_dp_train_segment(*args, update_alg=CQ,
                                                      **kw))
  return flat(fused_group_dp_train.fused_group_dp_train_segment(
      *args, update_alg=SUB_CQ, group_assignments=LAYOUTS[layout], **kw))


@pytest.mark.parametrize("layout", [None, "identity", "ragged"],
                         ids=["K15", "K16 identity", "K16 ragged"])
@pytest.mark.parametrize("tier", TIERS)
def test_dp_segments_match_pallas_at_each_tier(layout, tier):
  want, full, moved = _segment_reference(layout, tier)
  check_tier(lambda mxu: _port_segment(layout, mxu), want, full, moved, tier,
             "K15" if layout is None else "K16 " + layout)


def test_k7_rounds_the_identity_layout_and_k16_does_not():
  """At 'bf16' on the identity layout vtc_tpu's K7 returns bf16-rounded
  codes (its unpack is a bf16 product) and its K16 the solve's own codes;
  so do the port's; elsewhere neither rounds on that layout."""
  def bf16_exact(a):
    a = torch.from_numpy(np.asarray(a, np.float32))
    return bool(torch.equal(a, a.to(torch.bfloat16).float()))

  d, h, batches = _segment_problem()
  n_codes = batches.shape[1] * 24
  for mxu in ("bf16", "bf16x3"):
    k7 = _port_stats("identity", mxu)[:n_codes]
    k16 = _port_segment("identity", mxu)[-n_codes:]
    jk7 = _jax_stats("identity", batches[0], d, mxu)[:n_codes]
    jk16 = _jax_segment("identity", batches, d, mxu)[-n_codes:]
    assert np.abs(k7).max() > 0 and np.abs(k16).max() > 0
    rounds = mxu == "bf16"
    assert (bf16_exact(k7), bf16_exact(jk7)) == (rounds, rounds), mxu
    assert not bf16_exact(k16) and not bf16_exact(jk16), mxu


# ---------------------------------------------------------------------------
# the trainers and the encode
# ---------------------------------------------------------------------------
def _trainer_params(tier, groups, **extra):
  params = {
      "mode": "fully-connected", "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {0: {"sparsity_weight": SW,
                                       "num_iters": SEG_ITERS}},
      "dictionary_update_algorithm": CQ,
      "dict_update_param_schedule": {0: {"stepsize": UPD, "num_iters": 1}},
      "fc_formulation": "pallas", "train_precision": tier,
      "stdout_print_interval": 10**9,
  }
  if groups is not None:
    params.update(code_inference_algorithm="subspace_fista",
                  dictionary_update_algorithm=SUB_CQ,
                  group_assignments=groups)
  params.update(extra)
  return params


def _seed(d, groups):
  """The trainers' exact eigenvector seed (compiled_epoch's seed_eigvec)."""
  return lipschitz.top_gram_eigenpair(sparse_coding.lipschitz_matrix(
      torch.from_numpy(d), "fista" if groups is None else "subspace_fista",
      groups))[1].numpy()


@functools.lru_cache(maxsize=None)
def _jax_trained(family, tier):
  d, _, batches = _segment_problem()
  groups = None if family == "fc" else RAGGED
  return np.asarray(jax_ce.train_dictionary_scanned(
      batches, batches[:1], d.copy(), _trainer_params(
          tier, groups, data_parallel=jax_parallel.make_mesh(data=1))))


@functools.lru_cache(maxsize=None)
def _jax_trainer_spread(family, tier):
  """vtc_tpu's spread of its trainer's segment: its K15 or K16 from the
  trainer's exact seed, the dictionary out, under the nudges."""
  d, _, batches = _segment_problem()
  layout = None if family == "fc" else "ragged"
  v0 = _seed(d, LAYOUTS.get(layout))
  h0 = np.zeros(24, np.float32)

  def run(x, dd):
    return np.asarray(_jax_segment_fn(layout, tier)(dd, h0, v0, x)[0])

  return spread(run, batches, d, run(batches, d))


@pytest.mark.parametrize("family", ["fc", "subspace"])
@pytest.mark.parametrize("tier", TIERS)
def test_dp_trainer_matches_vtc_tpu_at_each_tier(monkeypatch, family, tier):
  """data_parallel=True without a process group is a mesh of one: the
  trainer takes K15 or K16 at the tier, as vtc_tpu's does on its
  one-device mesh, to vtc_tpu's dictionary."""
  d, _, batches = _segment_problem()
  groups = None if family == "fc" else RAGGED
  mod, name = ((fused_dp_train, "fused_dp_train_segment") if groups is None
               else (fused_group_dp_train, "fused_group_dp_train_segment"))
  tiers_seen = []
  original = getattr(mod, name)

  def spy(*args, **kw):
    tiers_seen.append(kw.get("mxu"))
    return original(*args, **kw)

  monkeypatch.setattr(mod, name, spy)

  def port(mxu):
    return compiled_epoch.train_dictionary_scanned(
        batches, batches[:1], d, _trainer_params(mxu, groups,
                                                 data_parallel=True),
        device="cpu").numpy()

  check_tier(port, _jax_trained(family, tier),
             _jax_trained(family, "highest"),
             _jax_trainer_spread(family, tier), tier,
             "DP train_dictionary_scanned " + family)
  assert tiers_seen and set(tiers_seen) <= {tier, "highest"}
  assert tier in tiers_seen


@pytest.mark.parametrize("family", ["fc", "subspace"])
def test_psum_per_op_route_keeps_full_precision(monkeypatch, family):
  """'gram' resolves to the psum-per-op step, which runs full precision
  whatever the tier (vtc_tpu/training/compiled_epoch.py:466-468): bitwise
  the 'highest' run, and no kernel wrapper is called."""
  d, _, batches = _segment_problem()
  groups = None if family == "fc" else RAGGED
  for mod, name in ((fused_dp_train, "fused_dp_train_segment"),
                    (fused_group_dp_train, "fused_group_dp_train_segment"),
                    (fused_train_step, "fused_solve_stats"),
                    (fused_group_train_step, "fused_group_solve_stats")):
    monkeypatch.setattr(mod, name, None)  # calling one fails the test
  runs = {tier: compiled_epoch.train_dictionary_scanned(
      batches, batches[:1], d, _trainer_params(
          tier, groups, data_parallel=True, fc_formulation="gram"),
      device="cpu") for tier in ("highest", "bf16x3", "bf16")}
  assert torch.equal(runs["bf16x3"], runs["highest"])
  assert torch.equal(runs["bf16"], runs["highest"])
  assert float((runs["highest"] - _t(d)).abs().max()) > 1e-3


@functools.lru_cache(maxsize=None)
def _encode_case(family):
  d, _, batches = _segment_problem()
  x = batches.reshape(-1, batches.shape[-1])
  kw = dict(batch_size=10, chunk_batches=1, formulation="pallas")
  if family == "subspace":
    kw["group_assignments"] = RAGGED
  return x, d, kw


def _jax_encode(family, x, d, mxu):
  _, _, kw = _encode_case(family)
  return np.asarray(jax_encode_dataset(
      x, d, SW, ENC_ITERS, mxu_precision=mxu,
      data_parallel=jax_parallel.make_mesh(data=1), **kw))


@pytest.mark.parametrize("family", ["fc", "subspace"])
@pytest.mark.parametrize("tier", TIERS)
def test_dp_encode_matches_vtc_tpu_at_each_tier(family, tier):
  x, d, kw = _encode_case(family)
  want = _jax_encode(family, x, d, tier)
  check_tier(lambda mxu: encode_dataset(
      x, d, SW, ENC_ITERS, mxu_precision=mxu, device="cpu",
      data_parallel=parallel.make_mesh(), **kw), want,
             _jax_encode(family, x, d, "highest"),
             spread(lambda xx, dd: _jax_encode(family, xx, dd, tier), x, d,
                    want), tier, "DP encode_dataset " + family)


# ---------------------------------------------------------------------------
# what still refuses a tier, and the C entries' declarations
# ---------------------------------------------------------------------------
def test_refusals_that_stay():
  rng = np.random.RandomState(7)
  images = rng.randn(2, 4, 1, 12, 12).astype(np.float32)
  kernels = rng.randn(6, 1, 4, 4).astype(np.float32)
  kernels /= np.sqrt((kernels ** 2).sum(axis=(1, 2, 3), keepdims=True))
  conv = dict(_trainer_params("bf16x3", None), mode="convolutional",
              strides=(2, 2), padding=((2, 2), (2, 2)), data_parallel=True)
  # conv with data parallelism runs its tiers (item 3a.2.2 is done): K17's
  # plain version at the tier, near the 'highest' run and not on it
  got = compiled_epoch.train_dictionary_scanned(images, images[:1], kernels,
                                                conv, device="cpu")
  full = compiled_epoch.train_dictionary_scanned(
      images, images[:1], kernels, dict(conv, train_precision="highest"),
      device="cpu")
  assert 0.0 < float((got - full).abs().max()) < 1e-3
  # the encode's CPU default 'gram' refuses a tier, where vtc_tpu asserts
  with pytest.raises(ValueError, match="'pallas' formulation only"):
    encode_dataset(images[0], kernels, SW, 5, mode="convolutional",
                   kernel_stride=(2, 2), batch_size=2, mxu_precision="bf16",
                   data_parallel=True, device="cpu")
  mixing = np.linalg.qr(rng.randn(16, 16))[0].astype(np.float32)
  ica_params = {"num_epochs": 1, "dictionary_update_algorithm":
                "ica_natural_gradient", "dict_update_param_schedule": {
                    0: {"stepsize": 0.01, "num_iters": 1}},
                "use_fused": True, "train_precision": "bf16x3",
                "data_parallel": True, "stdout_print_interval": 10**9}
  with pytest.raises(NotImplementedError, match=r"item 3a\.2\.3"):
    ica.train_dictionary_scanned(rng.randn(2, 8, 16).astype(np.float32),
                                 mixing, ica_params, device="cpu")
  # the code-sharded route: the trainer hands the tier to K19's runner,
  # whose wrapper refuses it (a 'code' axis above 1 needs ranks:
  # tests/test_torch_port_dp_segments.py holds the trainer there)
  d, h, batches = _segment_problem(s=32)
  runner = compiled_epoch._code_shard_segment_runner(
      None, 1, 1, "fista", CQ, 1, False, False, True, mxu="bf16x3")
  with pytest.raises(NotImplementedError, match=r"item 3a\.2\.4"):
    runner(_t(d), _t(h), _t(np.ones(16, np.float32)), _t(batches), SW,
           SEG_ITERS, UPD)


def _c_kinds(params):
  kinds = []
  for p in params:
    if "*" in p or p.split()[0] in ("SumHook", "RankHook", "AxisSumHook"):
      kinds.append(ctypes.c_void_p)
    else:
      kinds.append({"float": ctypes.c_float, "int64_t": ctypes.c_int64,
                    "unsigned": ctypes.c_uint}.get(p.split()[0], ctypes.c_int))
  return kinds


def _declared_kind(argtype):
  if isinstance(argtype, type) and issubclass(argtype, ctypes._Pointer):
    return ctypes.c_void_p
  return argtype


def test_c_entry_declarations_match_the_sources(monkeypatch):
  """Every entry ``ops/_build.load_library`` declares takes the arguments
  its definition in csrc/*.cu has, in number and kind (int, float,
  pointer): ctypes passes extra or mistyped arguments unchecked."""
  class FakeLib:
    def __getattr__(self, name):
      fn = type("Fn", (), {})()
      setattr(self, name, fn)
      return fn

  monkeypatch.setattr(_build, "build", lambda *a, **k: "unbuilt")
  monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
  lib = _build.load_library.__wrapped__()
  source = "".join(p.read_text() for p in sorted(
      pathlib.Path(_build.CSRC).glob("*.cu")))
  checked = 0
  for name, fn in vars(lib).items():
    found = re.search(r"\n(?:int|int64_t|void)\s+%s\(([^)]*)\)\s*\{" % name,
                      source)
    if found is None:  # a one-line definition, checked by its callers
      continue
    params = [p.strip() for p in found.group(1).split(",") if p.strip()]
    assert [_declared_kind(a) for a in fn.argtypes] == _c_kinds(params), (
        name)
    checked += 1
  assert checked >= 45
  for name in ("vtc_solve_stats", "vtc_group_solve_stats",
               "vtc_dp_train_segment", "vtc_group_dp_train_segment"):
    assert len(getattr(lib, name).argtypes) > 20, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier kernel has no CPU mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_solve_stats_tiers_match_plain():
  """K3 and K7 (both layouts) at every tier on the card against their
  plain versions at the tier, within the tier's floor (chip_smoke.py phase
  47 holds the flagship shapes to the three rules)."""
  dev = _card()
  d, _, batches = _segment_problem()
  args = [_t(a).to(dev) for a in (d, _v0(), batches[0])]
  for tier in TIERS:
    before = fused_train_step.stats_tier_launches
    got = fused_train_step.fused_solve_stats(*args, SW, SEG_ITERS,
                                             power_iters=2, mxu=tier)
    assert fused_train_step.stats_tier_launches == before + 1
    want = fused_train_step.fused_solve_stats_plain(
        *args, SW, SEG_ITERS, power_iters=2, mxu=tier)
    _close(got, want, tier)
    for groups in LAYOUTS.values():
      got = fused_group_train_step.fused_group_solve_stats(
          *args, SW, SEG_ITERS, group_assignments=groups, power_iters=2,
          mxu=tier)
      want = fused_group_train_step.fused_group_solve_stats_plain(
          *args, SW, SEG_ITERS, group_assignments=groups, power_iters=2,
          mxu=tier)
      _close(got, want, tier)


def _close(got, want, tier):
  from test_torch_port_tiers import FLOOR
  for g, w in zip(got, want):
    assert float((g - w).abs().max()) <= FLOOR[tier] * max(
        1.0, float(w.abs().max())), tier


@pytest.mark.cuda
def test_cuda_dp_segment_tiers_match_plain():
  """K15 and K16 (both layouts) at every tier on the card, two steps on a
  mesh of one, with and without a stop, against their plain versions: the
  same counts, within the tier's floor."""
  dev = _card()
  d, h, batches = _segment_problem()
  args = [_t(a).to(dev) for a in (d, h, _v0(), batches)]
  mesh = parallel.make_mesh()
  cases = [(fused_dp_train, fused_dp_train.fused_dp_train_segment,
            fused_dp_train.fused_dp_train_plain, dict(update_alg=CQ))]
  for groups in LAYOUTS.values():
    cases.append((fused_group_dp_train,
                  fused_group_dp_train.fused_group_dp_train_segment,
                  fused_group_dp_train.fused_group_dp_train_plain,
                  dict(update_alg=SUB_CQ, group_assignments=groups)))
  for mod, seg, plain, kw in cases:
    for tier in TIERS:
      for eps in (None, 1e-3):
        kw_all = dict(kw, mesh=mesh, power_iters=2, mxu=tier,
                      early_stopping_epsilon=eps)
        before = mod.tier_launches
        got = seg(*args, SW, SEG_ITERS, UPD, **kw_all)
        assert mod.tier_launches == before + batches.shape[0]
        want = plain(*args, SW, SEG_ITERS, UPD, **kw_all)
        if eps is not None:
          assert mod.last_iters.tolist() == mod.plain_iters
        _close(got, want, tier)
