"""The port's data-parallel layer against vtc_tpu on the CPU: the mesh, the
per-shard solve+stats kernels' plain versions, the data-parallel steps and
both segment runners.

The same seeded numpy inputs go through both packages, at the sizes of
tests/test_parallel.py (s 24, n 16, b 32, 3 steps).

* The plain K3, K7 and K9 (what a CPU tensor runs) against vtc_tpu's
  Pallas kernels in interpret mode: atol 2e-5; K7 with overlapping groups
  at 3e-5 of the largest value, the bound of the JAX test for a singular
  grouped Gram (ROADMAP.md §3); K9's inverse at 2e-4 and residual at 1e-5,
  K8's bounds in tests/test_pallas_ica_train.py.
* The port's steps and runners at worlds of 2 and 4 -- spawned CPU
  processes in one gloo group over a file:// store (tests/
  torch_port_dp_worker.py) -- against vtc_tpu's on its virtual 8-device
  CPU mesh and against the port's single-device result: the bounds of
  tests/test_parallel.py (codes and dictionary 1e-5, Hessian 1e-6 for one
  step; 2e-5 for a segment, :88-90).  vtc_tpu's result does not depend on
  the size of its mesh beyond those bounds; one case runs it at the port's
  own world size.
* Replicated state must be bitwise equal across the ranks.
* The data-parallel early stop: every rank leaves the solver at the same
  iteration and the gathered codes equal the single-device solve on the
  global batch.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_dp_worker as worker
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.analysis_transforms.fully_connected import (
    subspace_ista_fista as jax_sub)
from vtc_tpu.ops import lipschitz as jax_lip
from vtc_tpu.ops import pallas_ica_train as jax_k9
from vtc_tpu.ops import pallas_train_step as jax_k
from vtc_tpu.parallel import data_parallel as jax_dp
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu_torch import convert, parallel
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.ops import (fused_group_train_step, fused_ica_train,
                               fused_train_step)
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import sparse_coding as sc

WORLDS = (2, 4)
SW, N_IT, UPD_STEP = 0.05, 10, 0.1
GROUPS16 = [list(range(i, i + 4)) for i in range(0, 16, 4)]


def assert_close(got, want, atol, what):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.1e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.1e" % (what, err, atol)


def _t(x):
  return torch.from_numpy(np.array(x, dtype=np.float32))


def _unit_rows(rng, s, n):
  d = rng.randn(s, n).astype(np.float32)
  return d / np.linalg.norm(d, axis=1, keepdims=True)


def _eigvec(matrix):
  """vtc_tpu's exact eigenvector seed, as numpy: both sides start from it."""
  return np.asarray(jax_lip.top_gram_eigenpair(jnp.asarray(matrix))[1])


def _grouped(d, groups):
  gi, vm = jax_sub.pack_group_indices(groups, d.shape[0])
  return np.asarray(jax_sub.build_grouped_dictionary(jnp.asarray(d), gi, vm))


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
STATS_NAMES = ("codes", "cmat", "bmat", "stat", "eigvec", "stepsize")


@pytest.mark.parametrize("case,s,n,flags", [
    ("fista", 24, 16, {}),
    ("ista nonneg", 24, 16, {"variant": "ista", "nonneg": True}),
    ("fista hard", 24, 16, {"hard": True}),
    ("s < n", 12, 16, {}),
])
def test_k3_plain_matches_pallas(rng, case, s, n, flags):
  d = _unit_rows(rng, s, n)
  batch = rng.randn(32, n).astype(np.float32)
  v0 = _eigvec(d)
  want = jax_k.fused_solve_stats_pallas(
      jnp.asarray(d), jnp.asarray(v0), jnp.asarray(batch), jnp.float32(SW),
      jnp.int32(N_IT), power_iters=2, interpret=True, **flags)
  got = fused_train_step.fused_solve_stats(_t(d), _t(v0), _t(batch), SW, N_IT,
                                           power_iters=2, **flags)
  assert got[0].shape == (32, s) and got[1].shape == (s, s)
  assert got[2].shape == (s, n) and got[3].shape == (s,)
  assert got[4].shape == (min(s, n),) and got[5].shape == ()
  for name, g, w in zip(STATS_NAMES, got, want):
    assert_close(g, w, 2e-5, "K3 %s %s" % (case, name))


@pytest.mark.parametrize("case,s,n,groups,rel", [
    ("contiguous", 16, 16, GROUPS16, None),
    ("overlapping ragged", 14, 24,
     [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0]], 3e-5),
    ("G*M > n", 16, 8, [[(i + m) % 16 for m in range(4)]
                        for i in range(0, 16, 2)], 3e-5),
])
def test_k7_plain_matches_pallas(rng, case, s, n, groups, rel):
  d = _unit_rows(rng, s, n)
  batch = rng.randn(32, n).astype(np.float32)
  v0 = _eigvec(_grouped(d, groups))
  kw = dict(group_assignments=groups, power_iters=2)
  want = jax_k.fused_group_solve_stats_pallas(
      jnp.asarray(d), jnp.asarray(v0), jnp.asarray(batch), jnp.float32(SW),
      jnp.int32(N_IT), interpret=True, **kw)
  got = fused_group_train_step.fused_group_solve_stats(
      _t(d), _t(v0), _t(batch), SW, N_IT, **kw)
  gm = len(groups) * max(len(g) for g in groups)
  assert got[0].shape == (32, s) and got[4].shape == (min(gm, n),)
  for name, g, w in zip(STATS_NAMES, got, want):
    # a singular grouped Gram grows last-bit differences between the
    # frameworks (ROADMAP.md §3): the JAX test's relative bound there
    atol = 2e-5 if rel is None else max(
        2e-5, rel * float(np.abs(np.asarray(w)).max()))
    assert_close(g, w, atol, "K7 %s %s" % (case, name))


@pytest.mark.parametrize("case,stale,boost_tol", [
    ("healthy", 1.0, None), ("healthy boost armed", 1.0, 1e-6),
    ("stale seed boost", 1.35, 1e-6)])
def test_k9_plain_matches_pallas(rng, case, stale, boost_tol):
  n = 128  # the TPU kernel wants lane-aligned n
  d = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
  d += 0.05 * rng.randn(n, n).astype(np.float32)
  batch = (0.5 * rng.randn(16, n)).astype(np.float32)
  xi0 = (stale * np.linalg.inv(d)).astype(np.float32)
  kw = dict(refine_iters=3, boost_tol=boost_tol)
  want = jax_k9.ica_solve_stats_pallas(
      jnp.asarray(d), jnp.asarray(xi0), jnp.asarray(batch), interpret=True,
      **kw)
  got = fused_ica_train.ica_solve_stats(_t(d), _t(xi0), _t(batch), **kw)
  assert got[0].shape == (n, n) and got[1].shape == (n, n)
  assert got[2].shape == ()
  for name, g, w, atol in zip(("inverse", "statistic", "residual"), got, want,
                              (2e-4, 2e-5, 1e-5)):
    assert_close(g, w, atol, "K9 %s %s" % (case, name))


def test_gates_drop_the_vmem_rule():
  """The port's gates keep what the CUDA kernels need: the one-block power
  refresh holds two vectors of min(s, n) floats in 227 KB."""
  assert fused_train_step.fused_solve_stats_supported(125, 256, 256)
  assert fused_train_step.fused_solve_stats_supported(4096, 8192, 8192)
  assert not jax_k.fused_solve_stats_supported(4096, 8192, 8192)  # VMEM
  assert fused_train_step.fused_solve_stats_supported(8, 29039, 40000)
  assert not fused_train_step.fused_solve_stats_supported(8, 29040, 40000)
  assert not fused_train_step.fused_solve_stats_supported(0, 16, 16)
  big = [list(range(i, i + 4)) for i in range(0, 8192, 4)]
  assert fused_group_train_step.fused_group_solve_stats_supported(
      2048, 8192, 8192, big)
  assert not jax_k.fused_group_solve_stats_supported(2048, 8192, 8192, big)
  assert not fused_group_train_step.fused_group_solve_stats_supported(
      8, 40000, 40000, [list(range(40000))])


def test_wrappers_refuse_the_tiers(rng):
  """K3, K7 and K9 run the tiers (held to vtc_tpu in
  tests/test_torch_port_dp_tiers.py and test_torch_port_ica_tiers.py): a
  CPU tensor takes the plain version at the tier, which the tier moves off
  'highest'; what stays refused is what vtc_tpu refuses."""
  d, batch = _unit_rows(rng, 16, 16), rng.randn(8, 16).astype(np.float32)
  v = np.ones(16, np.float32)
  args = (_t(d), _t(v), _t(batch), SW, 5)
  for wrapper, plain, kw in (
      (fused_train_step.fused_solve_stats,
       fused_train_step.fused_solve_stats_plain, dict(mxu="bf16x3")),
      (fused_group_train_step.fused_group_solve_stats,
       fused_group_train_step.fused_group_solve_stats_plain,
       dict(group_assignments=GROUPS16, mxu="bf16"))):
    got = wrapper(*args, **kw)
    for g, w in zip(got, plain(*args, **kw)):
      assert torch.equal(g, w)
    full = wrapper(*args, **dict(kw, mxu="highest"))
    assert not torch.equal(got[0], full[0])
  sq = _t(np.linalg.qr(rng.randn(16, 16))[0])
  got = fused_ica_train.ica_solve_stats(sq, sq.T, _t(batch), mxu="bf16")
  for g, w in zip(got, fused_ica_train.ica_solve_stats_plain(
      sq, sq.T, _t(batch), mxu="bf16")):
    assert torch.equal(g, w)
  full = fused_ica_train.ica_solve_stats(sq, sq.T, _t(batch))
  assert not torch.equal(got[0], full[0])
  with pytest.raises(ValueError, match="unknown MXU tier"):
    fused_ica_train.ica_solve_stats(sq, sq.T, _t(batch), mxu="bf32")
  with pytest.raises(ValueError, match="square"):
    fused_ica_train.ica_solve_stats(_t(d[:8]), _t(d), _t(batch))


@pytest.mark.cuda
def test_cuda_solve_stats_kernels_match_plain(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K3, K7 and K9 have no CPU mode")
  d = _t(_unit_rows(rng, 24, 16)).cuda()
  batch = _t(rng.randn(32, 16)).cuda()
  v = torch.linalg.eigh(d.T @ d)[1][:, -1].contiguous()
  before = fused_train_step.stats_launches
  got = fused_train_step.fused_solve_stats(d, v, batch, SW, N_IT)
  assert fused_train_step.stats_launches == before + 1
  want = fused_train_step.fused_solve_stats_plain(d, v, batch, SW, N_IT)
  for g, w in zip(got, want):
    assert_close(g.cpu(), w.cpu(), 1e-5, "K3 on the card")
  sq = _t(np.linalg.qr(rng.randn(16, 16))[0]).cuda()
  got = fused_ica_train.ica_solve_stats(sq, sq.T.contiguous(), batch)
  want = fused_ica_train.ica_solve_stats_plain(sq, sq.T, batch)
  for g, w in zip(got, want):
    assert_close(g.cpu(), w.cpu(), 1e-5, "K9 on the card")
  dg = _t(_unit_rows(rng, 16, 16)).cuda()
  vg = torch.linalg.eigh(dg @ dg.T)[1][:, -1].contiguous()
  kw = dict(group_assignments=GROUPS16)
  got = fused_group_train_step.fused_group_solve_stats(dg, vg, batch, SW,
                                                       N_IT, **kw)
  want = fused_group_train_step.fused_group_solve_stats_plain(
      dg, vg, batch, SW, N_IT, **kw)
  for g, w in zip(got, want):
    assert_close(g.cpu(), w.cpu(), 1e-5, "K7 on the card")


# ---------------------------------------------------------------------------
# the problems of the multi-rank cases, and vtc_tpu's results for them
# ---------------------------------------------------------------------------
def _problem(seed, k=3, b=32, s=24, n=16):
  rng = np.random.RandomState(seed)
  return {"d": _unit_rows(rng, s, n),
          "h": np.abs(rng.rand(s)).astype(np.float32) * 0.01,
          "batches": rng.randn(k, b, n).astype(np.float32)}


FC = _problem(0)
SUB = _problem(1, s=16)
STEP_CASES = {  # name: (problem, inference, update, config)
    "fc steepest": (FC, "fista", "sc_steepest_descent", {}),
    "fc cheap-quad": (FC, "fista", "sc_cheap_quadratic_descent", {}),
    "subspace penalty 0.2": (
        SUB, "subspace_fista", "subspace_sc_cheap_quadratic_descent",
        {"group_assignments": GROUPS16, "alignment_penalty": 0.2}),
    "fc direct upd 2": (FC, "ista", "sc_cheap_quadratic_descent",
                        {"fc_formulation": "direct", "upd_num_iters": 2,
                         "nonneg": True}),
}
RUNNER_CASES = {  # name: (problem, inference, update, config)
    "fc steepest": (FC, "fista", "sc_steepest_descent", {}),
    "fc cheap-quad": (FC, "fista", "sc_cheap_quadratic_descent", {}),
    "group steepest": (SUB, "subspace_fista", "subspace_sc_steepest_descent",
                       {"group_assignments": GROUPS16}),
    "group cheap-quad": (SUB, "subspace_fista",
                         "subspace_sc_cheap_quadratic_descent",
                         {"group_assignments": GROUPS16}),
    "group cheap-quad penalty 0.2": (
        SUB, "subspace_fista", "subspace_sc_cheap_quadratic_descent",
        {"group_assignments": GROUPS16, "alignment_penalty": 0.2}),
}
COLD_CASES = {
    "fc cheap-quad eigvalsh": (FC, "fista", "sc_cheap_quadratic_descent", {}),
    "subspace steepest ista": (
        SUB, "subspace_ista", "subspace_sc_steepest_descent",
        {"group_assignments": GROUPS16}),
}
RUNNER_KW = dict(upd_num_iters=2, power_iters=2)


def _runner_seed(prob, config):
  groups = config.get("group_assignments")
  return _eigvec(prob["d"] if groups is None
                 else _grouped(prob["d"], groups))


def _jax_args(prob, *extra):
  return tuple(jnp.asarray(prob[name]) for name in ("d", "h")) + extra


@functools.lru_cache(maxsize=None)
def jax_step(name):
  prob, inf, upd, config = STEP_CASES[name]
  groups = config.get("group_assignments")
  mesh = jax_parallel.make_mesh(data=4 if groups else 8)
  step = jax_parallel.build_shard_map_train_step(
      mesh, "fully-connected", inf, upd, **config)
  return tuple(np.asarray(x) for x in step(
      *_jax_args(prob, jnp.asarray(prob["batches"][0])), jnp.float32(SW),
      jnp.int32(N_IT), jnp.float32(UPD_STEP)))


@functools.lru_cache(maxsize=None)
def jax_fused_runner(name, size=8):
  prob, inf, upd, config = RUNNER_CASES[name]
  build = (jax_dp.build_dp_group_fused_local_step
           if "group_assignments" in config
           else jax_dp.build_dp_fused_local_step)
  runner = jax_ce._dp_fused_segment_runner(
      build(size, inf, upd, **config, **RUNNER_KW),
      jax_parallel.make_mesh(data=size))
  return tuple(np.asarray(x) for x in runner(
      *_jax_args(prob, jnp.asarray(_runner_seed(prob, config)),
                 jnp.asarray(prob["batches"])),
      jnp.float32(SW), jnp.int32(N_IT), jnp.float32(UPD_STEP)))


@functools.lru_cache(maxsize=None)
def jax_cold_runner(name):
  prob, inf, upd, config = COLD_CASES[name]
  runner = jax_ce._dp_segment_runner(
      jax_dp.build_dp_local_step(8, "fully-connected", inf, upd, **config),
      jax_parallel.make_mesh(data=8), False)
  out = runner(*_jax_args(prob, jnp.zeros(1), jnp.asarray(prob["batches"])),
               jnp.float32(SW), jnp.int32(N_IT), jnp.float32(UPD_STEP))
  return tuple(np.asarray(x) for x in out[:2])


EARLY = {"d": _unit_rows(np.random.RandomState(5), 24, 16),
         "batch": (np.random.RandomState(6).randn(32, 16) * 0.3).astype(
             np.float32),
         "sw": 0.05, "n_it": 200, "eps": 2e-3}


@functools.lru_cache(maxsize=None)
def rank_results(world):
  """Every multi-rank case of this file, in one spawn per world size."""
  cases = [("mesh", "mesh", {})]
  if world == 4:
    cases.append(("mesh dcn", "mesh", {"dcn": 2}))
    prob, inf, upd, config = STEP_CASES["fc cheap-quad"]
    cases.append(("step dcn", "shard_map_step", dict(
        d=prob["d"], h=prob["h"], batch=prob["batches"][0], sw=SW, n_it=N_IT,
        upd_step=UPD_STEP, mode="fully-connected", inference_alg=inf,
        update_alg=upd, config=config, dcn=2)))
  for name, (prob, inf, upd, config) in STEP_CASES.items():
    cases.append(("step " + name, "shard_map_step", dict(
        d=prob["d"], h=prob["h"], batch=prob["batches"][0], sw=SW, n_it=N_IT,
        upd_step=UPD_STEP, mode="fully-connected", inference_alg=inf,
        update_alg=upd, config=config)))
  for name, (prob, inf, upd, config) in RUNNER_CASES.items():
    cases.append(("fused " + name, "fused_runner", dict(
        d=prob["d"], h=prob["h"], v=_runner_seed(prob, config),
        batches=prob["batches"], sw=SW, n_it=N_IT, upd_step=UPD_STEP,
        inference_alg=inf, update_alg=upd, config=dict(config, **RUNNER_KW))))
  for name, (prob, inf, upd, config) in COLD_CASES.items():
    cases.append(("cold " + name, "cold_runner", dict(
        d=prob["d"], h=prob["h"], batches=prob["batches"], sw=SW, n_it=N_IT,
        upd_step=UPD_STEP, inference_alg=inf, update_alg=upd, config=config)))
  for formulation in ("gram", "direct"):
    cases.append(("early stop " + formulation, "early_stop",
                  dict(EARLY, formulation=formulation)))
  return worker.run_ranks(world, cases)


def _replicated(world, key, count):
  """The case's first ``count`` outputs of rank 0, after asserting that
  every rank holds bitwise the same."""
  ranks = rank_results(world)
  for other in ranks[1:]:
    for a, b in zip(ranks[0][key][:count], other[key][:count]):
      assert np.array_equal(a, b), "%s differs across ranks" % key
  return ranks[0][key]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_on_a_process_group(world):
  x = np.arange(8 * world * 3, dtype=np.float32).reshape(8 * world, 3)
  for rank, out in enumerate(rank_results(world)):
    m = out["mesh"]
    assert m["axis_names"] == ("data", "code") and m["dp_axes"] == ("data",)
    assert m["shape"] == {"data": world, "code": 1}
    assert (m["size"], m["index"]) == (world, rank)
    assert np.array_equal(m["shard"], x[8 * rank:8 * (rank + 1)])
    assert np.array_equal(m["sum"], x[:2] * (world * (world + 1) / 2))
    assert np.array_equal(m["mean"], x[:2])
    assert np.array_equal(m["gathered"], x)
    assert m["object"] == {"rank": 0}


def test_multislice_mesh():
  for rank, out in enumerate(rank_results(4)):
    m = out["mesh dcn"]
    assert m["axis_names"] == ("dcn", "data", "code")
    assert m["dp_axes"] == ("dcn", "data")
    assert m["shape"] == {"dcn": 2, "data": 2, "code": 1}
    assert m["position"] == {"dcn": rank // 2, "data": rank % 2, "code": 0}
    assert (m["size"], m["index"]) == (4, rank)


def test_mesh_of_one_rank_needs_no_group():
  assert not torch.distributed.is_initialized()
  mesh = parallel.make_mesh()
  assert (mesh.size, mesh.index, mesh.group) == (1, 0, None)
  assert mesh.shape == {"data": 1, "code": 1}
  assert parallel.dp_axes(mesh) == ("data",)
  x = torch.arange(6.0).reshape(3, 2)
  assert mesh.shard(x) is x and mesh.sum(x) is x and mesh.mean(x) is x
  assert mesh.all_gather(x) is x and mesh.broadcast_object(7) == 7
  a, b = mesh.sum(x, x + 1)
  assert a is x and bool((b == x + 1).all())
  assert parallel.resolve_mesh(True).size == 1
  assert parallel.resolve_mesh(mesh) is mesh
  with pytest.raises(TypeError, match="data_parallel"):
    parallel.resolve_mesh(object())
  with pytest.raises(ValueError, match="process group"):
    parallel.make_mesh(data=2)
  with pytest.raises(ValueError, match="divide"):
    parallel.Mesh(2, group=object(), index=1).shard_bounds(5)


def test_code_axis_and_gspmd_wait():
  """The 'code' axis and the GSPMD step run (their multi-rank cases are in
  tests/test_torch_port_code_shard_parallel.py and _trainer.py): here a
  code axis without a group of its ranks is refused, and
  ``build_pjit_train_step`` on a mesh of one rank is the single-device
  raw step, rows sharded or not."""
  for build in (lambda: parallel.make_mesh(code=2),
                lambda: parallel.Mesh(1, code=2)):
    with pytest.raises(ValueError, match="process group"):
      build()
  rng = np.random.RandomState(3)
  d = rng.randn(24, 8).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  d, batch = torch.from_numpy(d), torch.from_numpy(
      rng.randn(10, 8).astype(np.float32))
  h = torch.zeros(24)
  want = sc.build_raw_step_fn("fully-connected", "fista",
                              "sc_steepest_descent")(d, h, batch, 0.05, 6,
                                                     0.1, 1, None)
  for shard in (False, True):
    got = parallel.build_pjit_train_step(
        parallel.make_mesh(), "fully-connected", "fista",
        "sc_steepest_descent", shard_code_axis=shard)(d, h, batch, 0.05, 6,
                                                      0.1)
    for g, w in zip(got, want):
      np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the steps and the runners at worlds of 2 and 4
# ---------------------------------------------------------------------------
def _single_step(name):
  prob, inf, upd, config = STEP_CASES[name]
  config = dict(config)
  upd_iters = config.pop("upd_num_iters", 1)
  step = sc.build_raw_step_fn("fully-connected", inf, upd, **config)
  return step(_t(prob["d"]), _t(prob["h"]), _t(prob["batches"][0]), SW, N_IT,
              UPD_STEP, upd_iters, None)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_step_matches_vtc_tpu_and_single_device(world, name):
  d, h, codes = _replicated(world, "step " + name, 3)
  for what, got, want, single, atol in zip(
      ("dictionary", "hessian", "codes"), (d, h, codes), jax_step(name),
      _single_step(name), (1e-5, 1e-6, 1e-5)):
    assert_close(got, want, atol, "%s vs vtc_tpu's mesh" % what)
    assert_close(got, single, atol, "%s vs the port's single device" % what)


def test_multislice_step_matches_vtc_tpu():
  d, h, codes = _replicated(4, "step dcn", 3)
  flat = rank_results(4)[0]["step fc cheap-quad"]
  for got, want in zip((d, h, codes), flat):
    assert np.array_equal(got, want)  # the same ranks, named on two axes
  for got, want, atol in zip((d, h, codes), jax_step("fc cheap-quad"),
                             (1e-5, 1e-6, 1e-5)):
    assert_close(got, want, atol, "dcn x data step")


def _single_fused(name):
  prob, inf, upd, config = RUNNER_CASES[name]
  args = convert.train_state_from_numpy(
      prob["d"], prob["h"], _runner_seed(prob, config), "cpu",
      config.get("group_assignments")) + (_t(prob["batches"]), SW, N_IT,
                                          UPD_STEP)
  if "group_assignments" in config:
    return fused_group_train_step.fused_group_train_segment(
        *args, variant=inf[9:], update_alg=upd, **config, **RUNNER_KW)[:3]
  return fused_train_step.fused_train_segment(
      *args, variant=inf, update_alg=upd, **RUNNER_KW)[:3]


@pytest.mark.parametrize("name", sorted(RUNNER_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_fused_runner_matches_vtc_tpu_and_single_device(world, name):
  got = _replicated(world, "fused " + name, 3)
  for what, g, want, single in zip(("dictionary", "hessian", "eigvec"), got,
                                   jax_fused_runner(name),
                                   _single_fused(name)):
    assert_close(g, want, 2e-5, "%s vs vtc_tpu's mesh" % what)
    assert_close(g, single, 2e-5, "%s vs the port's fused segment" % what)


@pytest.mark.parametrize("world", WORLDS)
def test_fused_runner_matches_vtc_tpu_at_its_own_world(world):
  got = _replicated(world, "fused fc cheap-quad", 3)
  for what, g, want in zip(("dictionary", "hessian", "eigvec"), got,
                           jax_fused_runner("fc cheap-quad", world)):
    assert_close(g, want, 2e-5, "%s vs vtc_tpu at data=%d" % (what, world))


def _single_cold(name):
  prob, inf, upd, config = COLD_CASES[name]
  step = sc.build_raw_step_fn("fully-connected", inf, upd, **config)
  runner = compiled_epoch._segment_runner(step, 1, False, None)
  return runner(_t(prob["d"]), _t(prob["h"]), torch.zeros(1),
                _t(prob["batches"]), SW, N_IT, UPD_STEP)[:2]


@pytest.mark.parametrize("name", sorted(COLD_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_cold_runner_matches_vtc_tpu_and_single_device(world, name):
  got = _replicated(world, "cold " + name, 2)
  for what, g, want, single in zip(("dictionary", "hessian"), got,
                                   jax_cold_runner(name), _single_cold(name)):
    assert_close(g, want, 2e-5, "%s vs vtc_tpu's mesh" % what)
    assert_close(g, single, 2e-5, "%s vs the port's single device" % what)


@pytest.mark.parametrize("formulation", ["gram", "direct"])
@pytest.mark.parametrize("world", WORLDS)
def test_early_stop_is_batch_global(world, formulation):
  ranks = rank_results(world)
  key = "early stop " + formulation
  counts = {out[key]["reductions"] for out in ranks}
  assert len(counts) == 1  # every rank left at the same iteration
  iterations = counts.pop() + 1  # no test before the second iteration
  assert 2 < iterations < EARLY["n_it"], iterations
  d, batch = _t(EARLY["d"]), _t(EARLY["batch"])
  single = ista_fista.run(batch, d, EARLY["sw"], EARLY["n_it"],
                          early_stopping_epsilon=EARLY["eps"],
                          formulation=formulation)
  full = ista_fista.run(batch, d, EARLY["sw"], EARLY["n_it"],
                        formulation=formulation)
  assert float((single - full).abs().max()) > 0  # it did stop early
  for out in ranks:
    assert np.array_equal(out[key]["codes"], ranks[0][key]["codes"])
  # 1e-5, tests/test_parallel.py's bound on codes: the shards' products
  # round otherwise than the whole batch's; one iteration more or fewer
  # would move the codes by about eps * stepsize, a hundred times that
  assert_close(ranks[0][key]["codes"], single, 1e-5,
               "codes vs the single-device early-stopped solve")
