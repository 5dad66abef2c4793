"""The port's whole-segment data-parallel kernels against vtc_tpu on the CPU:
the plain versions of K15 (fc), K16 (subspace) and K18 (ICA), their
runners at worlds of 1, 2 and 4, and the scanned trainers' choice of them.

The same seeded numpy inputs go through both packages, at small sizes
(s 16 or 24, n 16 or 24, a global batch of 16, 3 steps; ICA at n 128, which
vtc_tpu's kernel needs lane-aligned).  vtc_tpu's kernels run in interpret
mode inside a ``shard_map`` over a 'data' axis of the same size as the
port's world, as tests/test_pallas_dp_train.py runs them.

* Each plain version (what a CPU tensor runs) at a world of 1 against
  vtc_tpu's kernel on a one-device axis: K15 with ista and fista, steepest
  and cheap-quadratic, 1 and 3 update iterations, nonneg and hard, s > n;
  K16 with and without the anti-alignment regularizer, contiguous groups
  (vtc_tpu's roll prox) and a ragged overlapping partition (its gsel and
  expand matrices); K18 from an exact seed and from a stale one that fires
  the boost, with the residual.
* The runners at worlds of 2 and 4, spawned CPU processes in one gloo
  group (tests/torch_port_dp_worker.py, one spawn per world size for the
  file), against vtc_tpu's kernel at the same axis size and against the
  port's world of 1.  Replicated state must be bitwise equal on every rank.
* The trainers' choice: a world of 1 and a mesh without a 'dcn' axis go
  through K15, K16 and K18's wrappers and not K3, K7 or K9's; a mesh with
  a 'dcn' axis takes K3, K7 and K9's composition, and an early-stopped run
  the psum-per-op step, neither of them.

Tolerances, each as the existing data-parallel tests state them: 2e-5 of
max(1, |largest value|) on the state, vtc_tpu's own bound for its DP
runners and kernels (tests/test_parallel.py:397-400,
tests/test_pallas_dp_train.py); a cheap-quadratic segment of three steps
does not amplify rounding past it (ROADMAP.md §3 measures 8e-5 to 2.2e-4
after twelve).  The ragged overlapping groups' singular grouped Gram grows
last-bit differences, so K16 there is held at 3e-5, the bound of
tests/test_torch_port_parallel.py's K7 case.  K18's inverse at 2e-4 and
residual at 1e-5, K8's and K9's bounds (tests/test_pallas_ica_train.py).
The ICA sources sit at least 0.05 from zero, so no code meets sign()'s
discontinuity, where a last-bit difference would move the statistic by a
whole code.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

import torch_port_dp_worker as worker
from test_torch_port_tiers import FLOOR, _stop_eps, check_tier, nudged
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.analysis_transforms.fully_connected import (
    subspace_ista_fista as jax_sub)
from vtc_tpu.ops import lipschitz as jax_lip
from vtc_tpu.ops import pallas_dp_train as jax_k15
from vtc_tpu.ops import pallas_group_dp_train as jax_k16
from vtc_tpu.ops import pallas_ica_train as jax_k18
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.training import compiled_epoch as jax_compiled_epoch
from vtc_tpu_torch import parallel
from vtc_tpu_torch.ops import (fused_dp_train, fused_group_dp_train,
                               fused_ica_train, solver)
from vtc_tpu_torch.training import compiled_epoch, ica

WORLDS = (2, 4)
SW, N_IT, UPD_STEP = 0.2, 10, 0.01
CQ, SD = "sc_cheap_quadratic_descent", "sc_steepest_descent"
SUB_CQ, SUB_SD = "subspace_" + CQ, "subspace_" + SD
ICA_STEP, ICA_REFINE, ICA_BOOST = 0.02, 3, 1e-6  # the 'highest' tier's boost


def assert_close(got, want, what, rel=2e-5):
  """|got - want| <= rel * max(1, |want|max) everywhere."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want, np.float64)
  err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
  bound = rel * max(1.0, float(np.abs(want).max()))
  print("%s: max|d| = %.3e (bound %.1e)" % (what, err, bound))
  assert err <= bound, "%s: max|d| %.3e > %.1e" % (what, err, bound)


def _t(x):
  return torch.from_numpy(np.array(x, dtype=np.float32))


def _unit_rows(rng, s, n):
  d = rng.randn(s, n).astype(np.float32)
  return d / np.linalg.norm(d, axis=1, keepdims=True)


def _eigvec(matrix):
  """vtc_tpu's exact eigenvector seed, as numpy: both sides start from it."""
  return np.asarray(jax_lip.top_gram_eigenpair(jnp.asarray(matrix))[1])


def _sparse_problem(seed, s, n, groups=None, k=3, b=16):
  """A unit-norm dictionary, a small Hessian, the exact seed of the (grouped)
  Gram's eigenvector and (k, b, n) sparse-synthesizable batches."""
  rng = np.random.RandomState(seed)
  d = _unit_rows(rng, s, n)
  basis = rng.randn(6, n)
  x = ((rng.randn(k * b, 6) * 0.5) @ basis + 0.1 * rng.randn(k * b, n))
  h = (0.05 + 0.05 * rng.rand(s)).astype(np.float32)
  lip = d
  if groups is not None:
    gi, vm = jax_sub.pack_group_indices(groups, s)
    lip = np.asarray(jax_sub.build_grouped_dictionary(jnp.asarray(d), gi, vm))
  return dict(d=d, h=h, v=_eigvec(lip),
              x=x.astype(np.float32).reshape(k, b, n))


def _ica_problem(seed, stale, k=3, b=16, n=128):
  """An orthogonal mixing matrix as the dictionary, its inverse (times
  ``stale``) as the seed, and mixtures of sources at least 0.05 from
  zero."""
  rng = np.random.RandomState(seed)
  d = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
  src = np.sign(rng.randn(k * b, n)) * (0.05 + rng.laplace(size=(k * b, n)))
  x = (src @ d).astype(np.float32).reshape(k, b, n)
  xi = (stale * np.linalg.inv(d.astype(np.float64))).astype(np.float32)
  return dict(d=d, v=xi, x=x)


def _jax_mesh(p):
  return Mesh(np.asarray(jax.devices()[:p]).reshape(p, 1), ("data", "code"))


def _jax_dp(kernel, p, state, x, scalars, **kw):
  """vtc_tpu's whole-segment DP kernel in interpret mode inside a shard_map
  over a 'data' axis of ``p`` devices: ``state`` the replicated arrays
  before the batches, ``scalars`` the arguments after them."""

  def body(*args):
    xs = args[-1]
    return kernel(*args[:-1], xs.reshape(xs.shape[0], -1, xs.shape[-1]),
                  *scalars, axis_name="data", axis_size=p, interpret=True,
                  **kw)

  rep = PartitionSpec()
  n_out = 3 if kernel is jax_k18.fused_ica_dp_train_segment_pallas else 4
  fn = jax.jit(jax.shard_map(
      body, mesh=_jax_mesh(p),
      in_specs=(rep,) * len(state) + (PartitionSpec(None, "data", None),),
      out_specs=(rep,) * n_out, check_vma=False))
  return tuple(np.asarray(a) for a in fn(*state, x))


# ---------------------------------------------------------------------------
# the cases: (family, problem, flags, relative bound)
# ---------------------------------------------------------------------------
RAGGED = [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0]]
GROUPS16 = [list(range(i, i + 4)) for i in range(0, 16, 4)]
CASES = {
    "K15 fista cheap-quad upd 1": ("fc", (0, 16, 16), {}, 2e-5),
    "K15 ista steepest upd 3": ("fc", (1, 16, 16), {
        "variant": "ista", "update_alg": SD, "upd_num_iters": 3}, 2e-5),
    "K15 fista nonneg hard": ("fc", (2, 16, 16), {
        "nonneg": True, "hard": True}, 2e-5),
    "K15 s > n cheap-quad upd 3": ("fc", (3, 24, 16), {
        "upd_num_iters": 3}, 2e-5),
    "K16 contiguous cheap-quad (roll prox)": ("group", (4, 16, 16, GROUPS16),
                                              {}, 2e-5),
    "K16 contiguous steepest upd 2, penalty 0.1": (
        "group", (5, 16, 16, GROUPS16), {
            "variant": "ista", "update_alg": SUB_SD, "upd_num_iters": 2,
            "alignment_penalty": 0.1}, 2e-5),
    "K16 ragged overlapping, penalty 0.1 (gsel, expand)": (
        "group", (6, 14, 24, RAGGED), {"alignment_penalty": 0.1}, 3e-5),
    "K18 exact seed, boost armed": ("ica", (7, 1.0), {}, None),
    "K18 stale seed, boost fires, upd 2": ("ica", (8, 1.35), {
        "upd_num_iters": 2}, None),
}
# the cases the worlds of 2 and 4 run: one of each kernel
WORLD_CASES = ("K15 s > n cheap-quad upd 3",
               "K16 ragged overlapping, penalty 0.1 (gsel, expand)",
               "K18 stale seed, boost fires, upd 2")
ICA_LIMITS = (2e-5, 2e-4, 1e-5)  # dictionary, inverse, residual (absolute)


@functools.lru_cache(maxsize=None)
def problem(name):
  family, args, _, _ = CASES[name]
  if family == "ica":
    return _ica_problem(*args)
  groups = args[3] if family == "group" else None
  return _sparse_problem(args[0], args[1], args[2], groups)


def _flags(name):
  family, args, flags, _ = CASES[name]
  if family == "ica":
    return dict(dict(upd_num_iters=1), **flags)
  base = dict(variant="fista", upd_num_iters=1)
  if family == "fc":
    base.update(update_alg=CQ, nonneg=False, hard=False)
  else:
    base.update(update_alg=SUB_CQ, group_assignments=args[3],
                alignment_penalty=0.0)
  return dict(base, **flags)


@functools.lru_cache(maxsize=None)
def jax_segment(name, p=1, mxu="highest"):
  """vtc_tpu's kernel over the case's global batches on ``p`` devices, at
  the tier ``mxu`` (fc and subspace)."""
  family = CASES[name][0]
  pr, flags = problem(name), _flags(name)
  if family != "ica":
    flags["mxu"] = mxu
  if family == "ica":
    return _jax_dp(jax_k18.fused_ica_dp_train_segment_pallas, p,
                   (pr["d"], pr["v"]), pr["x"], (jnp.float32(ICA_STEP),),
                   refine_iters=ICA_REFINE, boost_tol=ICA_BOOST, **flags)
  kernel = (jax_k15.fused_dp_train_segment_pallas if family == "fc"
            else jax_k16.fused_group_dp_train_segment_pallas)
  if family == "group":
    flags["group_assignments"] = tuple(tuple(g) for g in
                                       flags["group_assignments"])
  return _jax_dp(kernel, p, (pr["d"], pr["h"], pr["v"]), pr["x"],
                 (jnp.float32(SW), jnp.int32(N_IT), jnp.float32(UPD_STEP)),
                 power_iters=2, **flags)


def _check(name, got, want, label):
  family, _, _, rel = CASES[name]
  if family == "ica":
    for what, g, w, atol in zip(("dictionary", "inverse", "residual"), got,
                                want, ICA_LIMITS):
      err = float(np.max(np.abs(np.asarray(g, np.float64)
                                - np.asarray(w, np.float64))))
      print("%s %s: max|d| = %.3e (atol %.1e)" % (label, what, err, atol))
      assert err <= atol, "%s %s: %.3e > %.1e" % (label, what, err, atol)
    return
  for what, g, w in zip(("dictionary", "hessian", "eigvec", "last codes"),
                        got, want):
    assert tuple(np.shape(g)) == tuple(np.shape(w)), what
    assert_close(g, w, "%s %s" % (label, what), rel)


@functools.lru_cache(maxsize=None)
def port_world_of_one(name, mxu="highest"):
  """The port's wrapper on CPU tensors (its plain version) on a mesh of
  one, at the tier ``mxu`` (fc and subspace)."""
  family = CASES[name][0]
  pr, flags = problem(name), _flags(name)
  if family != "ica":
    flags["mxu"] = mxu
  mesh = parallel.make_mesh()
  if family == "ica":
    return tuple(t.numpy() for t in fused_ica_train.fused_ica_dp_train_segment(
        _t(pr["d"]), _t(pr["v"]), _t(pr["x"]), ICA_STEP, mesh=mesh,
        refine_iters=ICA_REFINE, boost_tol=ICA_BOOST, **flags))
  fn = (fused_dp_train.fused_dp_train_segment if family == "fc"
        else fused_group_dp_train.fused_group_dp_train_segment)
  return tuple(t.numpy() for t in fn(
      _t(pr["d"]), _t(pr["h"]), _t(pr["v"]), _t(pr["x"]), SW, N_IT, UPD_STEP,
      mesh=mesh, power_iters=2, **flags))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_the_pallas_kernel(name):
  """What a CPU tensor runs at a world of 1 against vtc_tpu's kernel on a
  one-device axis; no kernel launches on the CPU."""
  counters = (fused_dp_train.launches, fused_group_dp_train.launches,
              fused_ica_train.dp_launches)
  got = port_world_of_one(name)
  assert counters == (fused_dp_train.launches, fused_group_dp_train.launches,
                      fused_ica_train.dp_launches)
  assert float(np.abs(got[0] - problem(name)["d"]).max()) > 1e-3  # trained
  _check(name, got, jax_segment(name), name)
  if CASES[name][0] != "ica":
    density = float((got[3] != 0).mean())
    print("code density %.3f" % density)
    assert density > 0.0  # not dead
    if CASES[name][0] == "fc":
      assert density < 1.0  # sparse


def test_the_stale_seed_fires_the_boost():
  """The stale seed's first residual, three refreshes from 1.35 X, is above
  the boost tolerance; the segment's largest residual, the boosted one, is
  far below it (vtc_tpu's kernel gives the same, the test above), and
  both segments stay under the trainer's guard."""
  stale = port_world_of_one("K18 stale seed, boost fires, upd 2")
  exact = port_world_of_one("K18 exact seed, boost armed")
  pr = problem("K18 stale seed, boost fires, upd 2")
  _, _, unboosted = fused_ica_train.ica_solve_stats_plain(
      _t(pr["d"]), _t(pr["v"]), _t(pr["x"][0]), refine_iters=ICA_REFINE)
  print("residual: unboosted first step %.3e, stale segment %.3e, exact "
        "segment %.3e" % (float(unboosted), float(stale[2]),
                          float(exact[2])))
  assert float(unboosted) > ICA_BOOST
  assert 0.0 <= float(stale[2]) < 1e-2 * float(unboosted)
  assert 0.0 <= float(exact[2]) < 1e-3


def test_the_gates_and_refusals():
  pr, flags = problem("K15 fista cheap-quad upd 1"), _flags(
      "K15 fista cheap-quad upd 1")
  mesh = parallel.make_mesh()
  args = (_t(pr["d"]), _t(pr["h"]), _t(pr["v"]), _t(pr["x"]), SW, N_IT,
          UPD_STEP)
  gflags = _flags("K16 contiguous cheap-quad (roll prox)")
  # the tiers run (tests/test_torch_port_dp_tiers.py holds them to
  # vtc_tpu): a CPU tensor takes the plain version at the tier
  for seg, plain, kw in (
      (fused_dp_train.fused_dp_train_segment,
       fused_dp_train.fused_dp_train_plain, flags),
      (fused_group_dp_train.fused_group_dp_train_segment,
       fused_group_dp_train.fused_group_dp_train_plain, gflags)):
    got = seg(*args, mesh=mesh, **kw, mxu="bf16x3")
    for g, w in zip(got, plain(*args, mesh=mesh, **kw, mxu="bf16x3")):
      assert torch.equal(g, w)
    assert not torch.equal(got[0], seg(*args, mesh=mesh, **kw)[0])
  # the early stop runs (tests/test_torch_port_dp_early_stop.py holds it
  # to vtc_tpu): each step's count, every one short of N_IT at eps 10
  for mod, fn, kw in (
      (fused_dp_train, fused_dp_train.fused_dp_train_segment, flags),
      (fused_group_dp_train, fused_group_dp_train.fused_group_dp_train_segment,
       gflags)):
    got = fn(*args, mesh=mesh, early_stopping_epsilon=10.0, **kw)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert mod.plain_iters == [2] * pr["x"].shape[0]
  # K18's tiers run since item 3a.2.3 (tests/test_torch_port_ica_tiers.py
  # holds them to vtc_tpu): near the 'highest' run and not on it
  ipr = problem("K18 exact seed, boost armed")
  tiered, full = (fused_ica_train.fused_ica_dp_train_segment(
      _t(ipr["d"]), _t(ipr["v"]), _t(ipr["x"]), ICA_STEP, mesh=mesh,
      mxu=mxu)[0] for mxu in ("bf16x3", "highest"))
  assert 0.0 < float((tiered - full).abs().max()) < 1e-3
  # the regularizer's unit-norm form needs renormalization, as vtc_tpu's
  assert not fused_group_dp_train.fused_group_dp_segment_supported(
      8, 16, 16, GROUPS16, alignment_penalty=0.1, renormalize=False)
  with pytest.raises(ValueError, match="fused_group_dp_segment_supported"):
    fused_group_dp_train.fused_group_dp_train_segment(
        *args, mesh=mesh, group_assignments=GROUPS16, alignment_penalty=0.1,
        renormalize=False)
  # K3's, K7's and K8's gates, and vtc_tpu's at the shapes it takes
  for b, s, n in ((16, 16, 16), (4, 24, 16), (125, 256, 256)):
    assert fused_dp_train.fused_dp_segment_supported(b, s, n)
    assert jax_k15.fused_dp_segment_supported(b, s, n, 4)
    assert fused_group_dp_train.fused_group_dp_segment_supported(
        b, s, n, GROUPS16)
  assert fused_ica_train.fused_ica_dp_segment_supported(128, 8)
  assert fused_ica_train.fused_ica_dp_segment_supported(100, 8)  # any n
  assert not fused_ica_train.fused_ica_dp_segment_supported(128, 8, 64)
  assert not fused_dp_train.fused_dp_segment_supported(0, 16, 16)


# ---------------------------------------------------------------------------
# worlds of 2 and 4: one spawn per world size
# ---------------------------------------------------------------------------
ROUTE = _sparse_problem(10, 16, 16, k=4)
ROUTE_DATA, ROUTE_D0 = ROUTE["x"], ROUTE["d"]
ROUTE_ICA = _ica_problem(11, 1.0, k=4)


def _route_params(family, **extra):
  if family == "ica":
    params = {"num_epochs": 2,
              "dictionary_update_algorithm": "ica_natural_gradient",
              "dict_update_param_schedule": {
                  0: {"stepsize": ICA_STEP, "num_iters": 1},
                  5: {"stepsize": 0.01, "num_iters": 2}},
              "use_fused": True, "stdout_print_interval": 10 ** 9}
  else:
    params = {"mode": "fully-connected", "num_epochs": 2,
              "code_inference_algorithm": "fista",
              "inference_param_schedule": {
                  0: {"sparsity_weight": SW, "num_iters": 8}},
              "dictionary_update_algorithm": CQ,
              "dict_update_param_schedule": {
                  0: {"stepsize": 0.01, "num_iters": 1},
                  5: {"stepsize": 0.005, "num_iters": 2}},
              "fc_formulation": "pallas", "stdout_print_interval": 10 ** 9}
    if family == "subspace":
      params.update(code_inference_algorithm="subspace_fista",
                    dictionary_update_algorithm=SUB_CQ,
                    group_assignments=GROUPS16,
                    subspace_alignment_penalty=0.1)
  params.update(extra)
  return params


def _route_case(family, dcn=1, **extra):
  if family == "ica":
    return dict(family=family, batches=ROUTE_ICA["x"], d0=ROUTE_ICA["d"],
                params=_route_params(family, **extra), dcn=dcn)
  return dict(family=family, batches=ROUTE_DATA, d0=ROUTE_D0,
              params=_route_params(family, **extra), dcn=dcn)


ROUTES = {"fc": _route_case("fc"), "subspace": _route_case("subspace"),
          "ica": _route_case("ica"),
          "fc dcn=2": _route_case("fc", 2),
          "subspace dcn=2": _route_case("subspace", 2),
          "ica dcn=2": _route_case("ica", 2)}


@functools.lru_cache(maxsize=None)
def rank_results(world):
  cases = []
  for name in WORLD_CASES:
    family = CASES[name][0]
    pr = problem(name)
    config = _flags(name)
    if family == "ica":
      config.update(refine_iters=ICA_REFINE, stepsize=ICA_STEP)
      cases.append((name, "dp_segment", dict(family=family, d=pr["d"],
                                             v=pr["v"], batches=pr["x"],
                                             config=config)))
    else:
      config.update(sw=SW, n_it=N_IT, upd_step=UPD_STEP)
      cases.append((name, "dp_segment", dict(family=family, d=pr["d"],
                                             h=pr["h"], v=pr["v"],
                                             batches=pr["x"],
                                             config=config)))
  for name, kw in ROUTES.items():
    cases.append(("route " + name, "routes", kw))
  for name, tier in TIER_WORLD_CASES:
    cases.append(("%s at %s" % (name, tier), "dp_segment",
                  _tier_case(name, tier)))
    cases.append(("%s at %s with the stop" % (name, tier), "dp_stop",
                  _tier_stop_case(name, tier)))
  if world == 2:
    for key, kw in TIER_ROUTES.items():
      cases.append(("route " + key, "routes", kw))
    cases.append(("encode at bf16x3", "encode", TIER_ENCODE))
    for tier in ("bf16x3", "highest"):
      cases.append(("code-sharded at " + tier, "cs_train",
                    _code_sharded_case(tier)))
  return worker.run_ranks(world, cases)


# ---------------------------------------------------------------------------
# the tiers across ranks (tests/test_torch_port_dp_tiers.py holds the world
# of one to vtc_tpu at every tier)
# ---------------------------------------------------------------------------
WORLD_TIERS = ("bf16x3", "bf16")
TIER_WORLD_CASES = [(name, tier) for name in WORLD_CASES[:2]
                    for tier in WORLD_TIERS]
# one segment of the route problem's four steps (a whole vtc_tpu trainer
# run then takes half a second, and its spread five more)
TIER_ROUTE_PARAMS = dict(num_epochs=1, dict_update_param_schedule={
    0: {"stepsize": 0.01, "num_iters": 1}})
TIER_ROUTES = {"%s dcn=2 at %s" % (family, tier): _route_case(
    family, 2, train_precision=tier, **TIER_ROUTE_PARAMS)
               for family in ("fc", "subspace")
               for tier in ("highest", "bf16x5", "bf16x3", "bf16")}
TIER_ENCODE = dict(data=ROUTE_DATA.reshape(-1, 16), d=ROUTE_D0, sw=SW,
                   n_it=8, kw=dict(batch_size=16, formulation="pallas",
                                   mxu_precision="bf16x3"))


def _code_sharded_case(tier):
  """The scanned fc trainer at train_precision ``tier`` on a 'code' axis
  of 2 (K19's code-shard route; the rows doubled so that the global s > n
  holds on shards of the route problem's rows)."""
  return dict(batches=ROUTE_DATA, d0=np.concatenate([ROUTE_D0, ROUTE_D0]),
              params=_route_params("fc", train_precision=tier),
              mesh_spec=dict(code=2))


def _tier_case(name, tier):
  family = CASES[name][0]
  pr = problem(name)
  config = dict(_flags(name), sw=SW, n_it=N_IT, upd_step=UPD_STEP, mxu=tier)
  return dict(family=family, d=pr["d"], h=pr["h"], v=pr["v"],
              batches=pr["x"], config=config)


@functools.lru_cache(maxsize=None)
def _tier_stop_eps(name, tier):
  """A mid-run eps from the world of one's means at the tier."""
  kw = _tier_stop_case(name, tier, eps=0.0)
  worker.CASES["dp_stop"](**kw)
  return _stop_eps(list(solver.last_avgs), "mid")


def _tier_stop_case(name, tier, eps=None):
  kw = _tier_case(name, tier)
  flags = kw["config"]
  kw["config"] = dict(
      update_alg=flags["update_alg"],
      group_assignments=flags.get("group_assignments"),
      alignment_penalty=flags.get("alignment_penalty", 0.0),
      early_eps=_tier_stop_eps(name, tier) if eps is None else eps,
      sw=SW, n_it=N_IT, upd_step=UPD_STEP, mxu=tier)
  return kw


def _tier_bound(want, tier):
  return FLOOR[tier] * max(1.0, float(np.abs(want).max()))


def _spread(fn, x, d, want):
  """How far fn(x, d) moves from want under five one-ulp nudges of both
  x and d (tests/test_torch_port_dp_tiers.py's spread)."""
  moved = [np.asarray(fn(nudged(x, seed), nudged(d, seed + 5)), np.float64)
           - want for seed in range(5)]
  return (max(float(np.abs(m).max()) for m in moved),
          max(float(np.linalg.norm(m)) for m in moved))


@functools.lru_cache(maxsize=None)
def _jax_tier_fn(name, tier):
  """vtc_tpu's kernel of the case at the tier on a one-device 'data' axis,
  jitted once: (d, h, v, x) -> the replicated state, flattened."""
  flags = dict(_flags(name), mxu=tier, power_iters=2)
  if CASES[name][0] == "fc":
    kernel = jax_k15.fused_dp_train_segment_pallas
  else:
    kernel = jax_k16.fused_group_dp_train_segment_pallas
    flags["group_assignments"] = tuple(tuple(g) for g in
                                       flags["group_assignments"])
  rep = PartitionSpec()

  def body(d, h, v, xs):
    out = kernel(d, h, v, xs, SW, N_IT, UPD_STEP, axis_name="data",
                 axis_size=1, interpret=True, **flags)
    return jnp.concatenate([jnp.ravel(a) for a in out[:3]])

  return jax.jit(jax.shard_map(
      body, mesh=_jax_mesh(1),
      in_specs=(rep, rep, rep, PartitionSpec(None, "data", None)),
      out_specs=rep, check_vma=False))


@functools.lru_cache(maxsize=None)
def _tier_spread(name, tier):
  """vtc_tpu's own spread of the case's segment at the tier (on one
  device: the sums over the ranks change only the order of additions)."""
  pr = problem(name)
  fn = _jax_tier_fn(name, tier)
  run = lambda x, d: np.asarray(fn(d, pr["h"], pr["v"], x))
  return _spread(run, pr["x"], pr["d"], run(pr["x"], pr["d"]))


@pytest.mark.parametrize("name,tier", TIER_WORLD_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_tier_runners_match_vtc_tpu_at_their_world(world, name, tier):
  """K15 and K16 at bf16x3 and bf16 over this rank's shards at a world of
  2 or 4: the ranks bitwise equal, within the tier's floor of vtc_tpu's
  kernel at the same axis size and of the port's world of one, and held
  by check_tier's control against both packages' 'highest' runs, within
  the larger of the tier's floor and vtc_tpu's own spread."""
  got = np.concatenate([np.ravel(a) for a in _replicated(
      world, "%s at %s" % (name, tier))])
  own_full = np.concatenate([np.ravel(a) for a in _replicated(world, name)])
  want = np.concatenate([np.ravel(a) for a in jax_segment(name, world,
                                                          tier)[:3]])
  full = np.concatenate([np.ravel(a) for a in jax_segment(name, world)[:3]])
  check_tier(lambda mxu: got if mxu == tier else own_full, want, full,
             _tier_spread(name, tier), tier, "world %d %s" % (world, name))
  one = np.concatenate([np.ravel(a)
                        for a in port_world_of_one(name, tier)[:3]])
  assert_close(got, one, "world %d vs world 1 at %s" % (world, tier),
               FLOOR[tier])


@pytest.mark.parametrize("name,tier", TIER_WORLD_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_tier_stop_across_ranks(world, name, tier):
  """K15 and K16 at a tier with a mid-run stop: every rank bitwise equal
  with the same counts, the counts of the world of one, every state
  within the tier's floor of it."""
  got = _replicated(world, "%s at %s with the stop" % (name, tier))
  one = worker.CASES["dp_stop"](**_tier_stop_case(name, tier))
  assert got["counts"] == one["counts"], (got["counts"], one["counts"])
  assert min(got["counts"]) < N_IT, got["counts"]  # it stopped
  for what, g, w in zip(("dictionary", "hessian", "eigvec"), got["state"],
                        one["state"]):
    assert_close(g, w, "world %d %s at %s with the stop: %s" % (
        world, name, tier, what), FLOOR[tier])


def _jax_dcn_trained(family, tier, x=ROUTE_DATA, d0=ROUTE_D0):
  kw = TIER_ROUTES["%s dcn=2 at %s" % (family, tier)]
  return np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      x, x[:1], d0.copy(), dict(
          kw["params"], data_parallel=jax_parallel.make_mesh(dcn=2,
                                                             data=1))))


@pytest.mark.parametrize("tier", ["bf16x5", "bf16x3", "bf16"])
@pytest.mark.parametrize("family", ["fc", "subspace"])
def test_tier_trainers_on_a_dcn_mesh_match_vtc_tpu(family, tier):
  """train_precision on a mesh of two slices: K3's or K7's composition
  every step at the tier, the ranks bitwise equal, held to vtc_tpu's
  trainer on its (dcn 2, data 1) mesh at the tier."""
  step = {"fc": "K3", "subspace": "K7"}[family]
  got = _replicated(2, "route %s dcn=2 at %s" % (family, tier))
  assert {k: v for k, v in got["calls"].items() if v} == {
      step: ROUTE_DATA.shape[0]}, got["calls"]
  own_full = _replicated(2, "route %s dcn=2 at highest" % family)
  want = _jax_dcn_trained(family, tier)
  check_tier(lambda mxu: (got if mxu == tier else own_full)["dictionary"],
             want, _jax_dcn_trained(family, "highest"),
             _spread(lambda x, d: _jax_dcn_trained(family, tier, x, d),
                     ROUTE_DATA, ROUTE_D0, want), tier,
             "%s on a dcn mesh" % family)


def test_tier_encode_and_code_sharded_refusal_across_ranks():
  """encode_dataset at bf16x3 on a world of 2: every rank the codes of
  vtc_tpu's encode on a 'data' axis of 2 within the tier's floor.  The
  trainer on a 'code' axis of 2 hands the tier to K19, which refused it
  before item 3a.2.4 and now runs it: K19's route alone, the ranks bitwise
  equal, within the tier's floor (or vtc_tpu's spread under five nudges of
  both the batches and the dictionary, where the floor does not hold) of
  vtc_tpu's trainer at bf16x3 on its (data 1, code 2) mesh, and moved from
  the port's own 'highest' run."""
  got = _replicated(2, "encode at bf16x3")
  kw = TIER_ENCODE
  want = np.asarray(jax_encode_dataset(
      kw["data"], kw["d"], kw["sw"], kw["n_it"],
      data_parallel=jax_parallel.make_mesh(data=2), **kw["kw"]))
  assert_close(got, want, "DP encode at bf16x3 across 2 ranks",
               FLOOR["bf16x3"])
  got = _replicated(2, "code-sharded at bf16x3")
  assert got["calls"]["K19"] > 0 and sum(got["calls"].values()) == (
      got["calls"]["K19"]), got["calls"]
  kw = _code_sharded_case("bf16x3")

  def jax_trained(x, d0):
    return np.asarray(jax_compiled_epoch.train_dictionary_scanned(
        x, x[:1], d0.copy(), dict(
            kw["params"], data_parallel=jax_parallel.make_mesh(code=2))))

  want = jax_trained(kw["batches"], kw["d0"])
  err = float(np.abs(got["dictionary"] - want).max())
  bound = FLOOR["bf16x3"] * max(1.0, float(np.abs(want).max()))
  if err > bound:
    bound = max(bound, _spread(jax_trained, kw["batches"], kw["d0"],
                               want)[0])
  print("code-sharded trainer at bf16x3 across 2 ranks: max|d| %.3e "
        "(bound %.3e)" % (err, bound))
  assert err <= bound
  full = _replicated(2, "code-sharded at highest")["dictionary"]
  assert np.abs(got["dictionary"] - full).max() > 0.0


def _assert_same(a, b, key):
  """a and b, one rank's result and another's, are bitwise equal."""
  if isinstance(a, dict):
    assert a.keys() == b.keys(), key
    for k in a:
      _assert_same(a[k], b[k], key)
  elif isinstance(a, (tuple, list)):
    assert len(a) == len(b), key
    for x, y in zip(a, b):
      _assert_same(x, y, key)
  else:
    assert np.array_equal(a, b), "%s differs across ranks" % key


def _replicated(world, key):
  results = rank_results(world)
  first = results[0][key]
  for other in results[1:]:
    _assert_same(first, other[key], key)
  return first


@pytest.mark.parametrize("name", WORLD_CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_runners_match_vtc_tpu_at_their_world(world, name):
  """The runner over this rank's shards at a world of 2 or 4 against
  vtc_tpu's kernel at the same axis size, and against the port's world of
  1; the ranks bitwise equal."""
  got = _replicated(world, name)
  want = jax_segment(name, world)
  if CASES[name][0] == "ica":
    _check(name, got, want, "world %d vs vtc_tpu's kernel" % world)
    _check(name, got, port_world_of_one(name), "world %d vs world 1" % world)
    return
  # the runners return the replicated state; the last codes are a shard's
  _check(name, got, want[:3], "world %d vs vtc_tpu's kernel" % world)
  _check(name, got, port_world_of_one(name)[:3],
         "world %d vs world 1" % world)


@pytest.mark.parametrize("family", ["fc", "subspace", "ica"])
@pytest.mark.parametrize("world", WORLDS)
def test_trainers_take_the_segment_kernels_off_a_dcn_mesh(world, family):
  """data_parallel=True on a world of 2 or 4: K15, K16 or K18 once per
  segment, no K3, K7 or K9; a mesh of two slices ('dcn'): K3, K7 or K9
  once per step, as vtc_tpu takes them, to the same numbers."""
  whole = {"fc": "K15", "subspace": "K16", "ica": "K18"}[family]
  step = {"fc": "K3", "subspace": "K7", "ica": "K9"}[family]
  flat = _replicated(world, "route " + family)
  sliced = _replicated(world, "route %s dcn=2" % family)
  steps = 2 * (ROUTE_ICA["x"] if family == "ica" else ROUTE_DATA).shape[0]
  # two epochs of 4 steps, cut at step 5: segments [0, 4), [4, 5), [5, 8)
  assert {k: v for k, v in flat["calls"].items() if v} == {whole: 3}, (
      flat["calls"])
  assert {k: v for k, v in sliced["calls"].items() if v} == {step: steps}, (
      sliced["calls"])
  assert float(np.abs(flat["dictionary"] - (
      ROUTE_ICA["d"] if family == "ica" else ROUTE_D0)).max()) > 1e-3
  assert_close(sliced["dictionary"], flat["dictionary"],
               "%s: K%s's composition vs the segment kernel" % (family, step))


# ---------------------------------------------------------------------------
# a world of 1, in this process, with no process group
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["fc", "subspace", "ica"])
def test_world_of_one_takes_the_segment_kernels(family):
  assert not torch.distributed.is_initialized()
  whole = {"fc": "K15", "subspace": "K16", "ica": "K18"}[family]
  got = worker.CASES["routes"](**ROUTES[family])
  assert {k: v for k, v in got["calls"].items() if v} == {whole: 3}, (
      got["calls"])
  kw = ROUTES[family]
  params = dict(kw["params"])
  if family == "ica":
    single = ica.train_dictionary_scanned(kw["batches"], kw["d0"], params,
                                          device="cpu")
  else:
    single = compiled_epoch.train_dictionary_scanned(
        kw["batches"], kw["batches"][:1], kw["d0"], params, device="cpu")
  assert_close(got["dictionary"], single, "a mesh of one vs one device")


def test_early_stop_takes_neither():
  """An early-stopped data-parallel run takes neither K3's composition nor
  the psum-per-op step: it takes K15 with its stop, once per segment, as
  vtc_tpu takes its K15 with the stop (the other families in
  tests/test_torch_port_dp_early_stop.py)."""
  got = worker.CASES["routes"](**_route_case(
      "fc", lipschitz_method="power_warm", early_stopping_epsilon=1e-2))
  assert {k: v for k, v in got["calls"].items() if v} == {"K15": 3}, (
      got["calls"])
  assert fused_dp_train.plain_iters is not None
  assert np.isfinite(got["dictionary"]).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda(*tensors):
  return [t.cuda() for t in tensors]


def _cuda_case(name):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K15, K16 and K18 have no CPU mode")
  for case in CASES:
    if case.startswith(name):
      pr, flags = problem(case), _flags(case)
      yield case, pr, flags


@pytest.mark.cuda
def test_cuda_k15_matches_plain():
  mesh = parallel.make_mesh()
  for case, pr, flags in _cuda_case("K15"):
    before = fused_dp_train.launches
    got = fused_dp_train.fused_dp_train_segment(
        *_cuda(_t(pr["d"]), _t(pr["h"]), _t(pr["v"]), _t(pr["x"])), SW,
        N_IT, UPD_STEP, mesh=mesh, power_iters=2, **flags)
    assert fused_dp_train.launches == before + pr["x"].shape[0]
    _check(case, [g.cpu().numpy() for g in got], port_world_of_one(case),
           "cuda " + case)


@pytest.mark.cuda
def test_cuda_k16_matches_plain():
  mesh = parallel.make_mesh()
  for case, pr, flags in _cuda_case("K16"):
    before = fused_group_dp_train.launches
    got = fused_group_dp_train.fused_group_dp_train_segment(
        *_cuda(_t(pr["d"]), _t(pr["h"]), _t(pr["v"]), _t(pr["x"])), SW,
        N_IT, UPD_STEP, mesh=mesh, power_iters=2, **flags)
    assert fused_group_dp_train.launches == before + pr["x"].shape[0]
    _check(case, [g.cpu().numpy() for g in got], port_world_of_one(case),
           "cuda " + case)


@pytest.mark.cuda
def test_cuda_k18_matches_plain():
  mesh = parallel.make_mesh()
  for case, pr, flags in _cuda_case("K18"):
    before = fused_ica_train.dp_launches
    got = fused_ica_train.fused_ica_dp_train_segment(
        *_cuda(_t(pr["d"]), _t(pr["v"]), _t(pr["x"])), ICA_STEP, mesh=mesh,
        refine_iters=ICA_REFINE, boost_tol=ICA_BOOST, **flags)
    assert fused_ica_train.dp_launches == before + pr["x"].shape[0]
    _check(case, [g.cpu().numpy() for g in got], port_world_of_one(case),
           "cuda " + case)
