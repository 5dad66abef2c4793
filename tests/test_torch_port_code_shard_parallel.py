"""K19 across ranks on the CPU: the 'code' mesh axis and the plain version
of the residual-form segment with dictionary rows sharded over 'code' (and
the batch over 'data'), against vtc_tpu.

Spawned CPU ranks in one gloo group per world size for the file
(tests/torch_port_dp_worker.py): a world of 2 holds a (data 1, code 2)
mesh, a world of 4 a (data 2, code 2) and a (dcn 2, data 1, code 2) mesh.
vtc_tpu's side runs in this process on its 8-device CPU mesh:
``fused_code_sharded_train_segment_pallas`` in interpret mode under a
``shard_map`` over a (data, code) mesh, as
tests/test_pallas_code_shard_group.py:33-70 runs it.

* The mesh: axis names, shape and positions against the device grid of
  vtc_tpu's ``make_mesh``; the row and batch shards; sums and gathers over
  the code group and over the data group.
* The plain segment (what a CPU tensor runs) at (1, 2) and (2, 2) against
  vtc_tpu's kernel on a mesh of the same shape (steepest and
  cheap-quadratic at 1 update iteration; grouped with the anti-alignment
  regularizer) or of shape (1, 2) (3 update iterations, nonneg ISTA, contiguous
  groups at penalty 0, a ragged partition inside each shard, a shard of
  s_l <= n with the global s > n, and the in-kernel stop test at (2, 2)).
  The ranks must hold bitwise the same eigenvector and stepsize, and the
  gathered shards must match vtc_tpu.
* The tiers across ranks: the cheap-quadratic segment and the stop's
  problem at bf16x3 and bf16 on (1, 2) and (2, 2), against vtc_tpu's K19
  at the tier on a mesh of the same shape; the stopped ranks agree on
  their counts, which are below the iteration count.  Tolerance:
  tests/test_torch_port_code_shard_tiers.py's bound, the larger of the
  tier's floor (tests/test_torch_port_tiers.py's FLOOR, times the largest
  value) and vtc_tpu's spread under five one-ulp nudges of both the
  batches and the dictionary, taken only where the floor does not hold.

Inputs come from numpy seeds: k 1 to 2, a global batch of 16, s 64 (32 for
the s_l <= n case), n 16.  Tolerance: rtol and atol 3e-5, vtc_tpu's own
code-shard-versus-single-chip limit (tests/test_pallas_code_shard_train.py:
120-121) on the dictionary and the eigenvector, 3e-6 absolute on the
Hessian EMA and 3e-5 on the codes (its :67-75); two cheap-quadratic
steps stay well inside ROADMAP.md §3's rounding floor (8e-5 to 2.2e-4 after
twelve steps), so the same limit holds for them.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch_port_dp_worker as worker
from test_torch_port_tiers import FLOOR, nudged
from vtc_tpu.ops import pallas_code_shard_train as jcs
from vtc_tpu.parallel import make_mesh as jax_make_mesh
from vtc_tpu_torch import parallel
from vtc_tpu_torch.ops import fused_code_shard_train as cs

MESHES = {2: [dict(data=1, code=2)],
          4: [dict(data=2, code=2), dict(dcn=2, data=1, code=2)]}
SW, N_IT, UPD = 0.1, 4, 0.05
SUB_CQ = "subspace_sc_cheap_quadratic_descent"
SUB_SD = "subspace_sc_steepest_descent"


def _problem(seed, k=2, b=16, s=64, n=16):
  rng = np.random.RandomState(seed)
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = (rng.randn(k, b, n) * 0.5).astype(np.float32)
  h = (np.abs(rng.randn(s)) * 0.01).astype(np.float32)
  v = np.linalg.eigh(d.astype(np.float64).T @ d)[1][:, -1].astype(np.float32)
  return d, h, v, x


def _contiguous(s, m):
  return [list(range(i, i + m)) for i in range(0, s, m)]


def _ragged_in_shards(seed, s, shards):
  """A disjoint partition of range(s) into shuffled groups of 1 to 6 rows,
  none across a boundary of ``shards`` equal row shards."""
  rng, groups, per = np.random.RandomState(seed), [], s // shards
  for lo in range(0, s, per):
    perm, at = lo + rng.permutation(per), 0
    while at < per:
      size = int(rng.randint(1, 7))
      groups.append(sorted(int(i) for i in perm[at:at + size]))
      at += size
  return groups


# name -> (seed, problem sizes, the segment's flags, groups, vtc_tpu meshes:
# 'same' runs vtc_tpu at each port mesh's shape, else the one (data, code))
SEGMENTS = {
    "steepest upd 1": (1, {}, dict(update_alg="sc_steepest_descent"), None,
                       "same"),
    "steepest upd 3": (2, {}, dict(update_alg="sc_steepest_descent",
                                   upd_num_iters=3), None, (1, 2)),
    "cheap-quad upd 1": (3, {}, dict(), None, "same"),
    "cheap-quad upd 3": (4, {}, dict(upd_num_iters=3), None, (1, 2)),
    "nonneg ista": (5, {}, dict(variant="ista", nonneg=True,
                                update_alg="sc_steepest_descent"), None,
                    (1, 2)),
    "groups penalty 0": (6, {}, dict(update_alg=SUB_CQ),
                         _contiguous(64, 4), (1, 2)),
    "groups penalty 0.4": (7, {}, dict(update_alg=SUB_SD,
                                       alignment_penalty=0.4),
                           _contiguous(64, 4), "same"),
    "ragged groups": (8, {}, dict(update_alg=SUB_CQ),
                      _ragged_in_shards(8, 64, 2), (1, 2)),
    "s_l <= n < s": (9, dict(s=32), dict(), None, (1, 2)),
}
# the in-kernel stop test, vtc_tpu test_pallas_code_shard_group.py:243-276
STOP = (10, dict(k=1, s=64, n=16), dict(early_stopping_epsilon=3e-2), 0.05,
        20, 0.005)


def _jax_segment(data, code, d, h, v, x, sw, n_it, upd, groups=None,
                 alignment_penalty=0.0, **kw):
  """vtc_tpu's K19 under a shard_map over a (data, code) mesh, global
  arrays in and out (tests/test_pallas_code_shard_group.py:33-70)."""
  mesh = Mesh(np.asarray(jax.devices()[:data * code]).reshape(data, code),
              ("data", "code"))
  expand_all = comem_all = None
  if groups is not None:
    arrays = jcs.code_shard_group_arrays(groups, d.shape[0], code)
    expand_all, comem_all = map(jnp.asarray, arrays)

  def body(d_shard, h_shard, v_, x_):
    gkw = dict(kw)
    if expand_all is not None:
      idx = jax.lax.axis_index("code")
      gkw["expand_local"] = jax.lax.dynamic_index_in_dim(
          expand_all, idx, keepdims=False)
      if alignment_penalty != 0.0:
        gkw["comem_local"] = jax.lax.dynamic_index_in_dim(
            comem_all, idx, keepdims=False)
      gkw["alignment_penalty"] = alignment_penalty
    return jcs.fused_code_sharded_train_segment_pallas(
        d_shard, h_shard, v_, x_, jnp.float32(sw), jnp.int32(n_it),
        jnp.float32(upd), axis_name="code",
        axis_size=code, data_axis_name="data" if data > 1 else None,
        data_axis_size=data, code_stride=1, data_stride=code,
        interpret=True, power_iters=2, **gkw)

  fn = jax.jit(jax.shard_map(
      body, mesh=mesh,
      in_specs=(P("code", None), P("code"), P(), P(None, "data", None)),
      out_specs=(P("code", None), P("code"), P(), P("data", "code")),
      check_vma=False))
  out = fn(*map(jnp.asarray, (d, h, v, x)))
  return tuple(np.asarray(o) for o in out)


def _segment_inputs(name):
  seed, sizes, flags, groups, _ = SEGMENTS[name]
  return _problem(seed, **sizes), flags, groups


@functools.lru_cache(maxsize=None)
def jax_segment(name, data, code):
  (d, h, v, x), flags, groups = _segment_inputs(name)
  return _jax_segment(data, code, d, h, v, x, SW, N_IT, UPD, groups=groups,
                      **flags)


@functools.lru_cache(maxsize=None)
def jax_stop():
  seed, sizes, flags, sw, n_it, upd = STOP
  d, h, v, x = _problem(seed, **sizes)
  return _jax_segment(2, 2, d, h, v, x, sw, n_it, upd, **flags)


def _key(spec):
  return "x".join("%s%d" % (a, spec[a]) for a in sorted(spec))


# the tiers across ranks: a segment and the stop's problem at each tier
WORLD_TIERS = ("bf16x3", "bf16")
TIER_SEGMENT = "cheap-quad upd 1"


def _tier_case(stop, tier):
  """(d, h, v, x, sw, n_it, upd, flags) of the segment (stop False) or
  the stop's problem at the tier."""
  if stop:
    seed, sizes, flags, sw, n_it, upd = STOP
    return (*_problem(seed, **sizes), sw, n_it, upd, dict(flags, mxu=tier))
  (d, h, v, x), flags, _ = _segment_inputs(TIER_SEGMENT)
  return d, h, v, x, SW, N_IT, UPD, dict(flags, mxu=tier)


def _tier_key(stop, tier, spec):
  return "%s at %s %s" % ("stop" if stop else TIER_SEGMENT, tier,
                          _key(spec))


@functools.lru_cache(maxsize=None)
def jax_tier(stop, tier, data, code, seed=None):
  """vtc_tpu's K19 at the tier on a (data, code) mesh, flattened; with
  seed, on the batches and dictionary nudged by seed and seed + 5."""
  d, h, v, x, sw, n_it, upd, flags = _tier_case(stop, tier)
  if seed is not None:
    d, x = nudged(d, seed + 5), nudged(x, seed)
  return np.concatenate([np.asarray(a, np.float64).ravel() for a in
                         _jax_segment(data, code, d, h, v, x, sw, n_it, upd,
                                      **flags)])


@functools.lru_cache(maxsize=None)
def rank_results(world):
  """Every case of the file at this world size, in one spawn."""
  cases = []
  for spec in MESHES[world]:
    cases.append(("mesh " + _key(spec), "code_mesh",
                  dict(mesh_spec=spec)))
    if "dcn" in spec:
      continue
    for name in SEGMENTS:
      (d, h, v, x), flags, groups = _segment_inputs(name)
      cases.append(("%s %s" % (name, _key(spec)), "cs_segment", dict(
          mesh_spec=spec, d=d, h=h, v=v, batches=x, sw=SW, n_it=N_IT,
          upd_step=UPD, kw=flags, groups=groups)))
    for stop in (False, True):
      for tier in WORLD_TIERS:
        d, h, v, x, sw, n_it, upd, flags = _tier_case(stop, tier)
        cases.append((_tier_key(stop, tier, spec), "cs_segment", dict(
            mesh_spec=spec, d=d, h=h, v=v, batches=x, sw=sw, n_it=n_it,
            upd_step=upd, kw=flags)))
    if spec == dict(data=2, code=2):
      seed, sizes, flags, sw, n_it, upd = STOP
      d, h, v, x = _problem(seed, **sizes)
      cases.append(("stop", "cs_segment", dict(
          mesh_spec=spec, d=d, h=h, v=v, batches=x, sw=sw, n_it=n_it,
          upd_step=upd, kw=flags)))
  return worker.run_ranks(world, cases)


def assert_close(got, want, what, atol=3e-5, rtol=3e-5):
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  err = float(np.max(np.abs(got - want) - rtol * np.abs(want)))
  print("%s: max|d| = %.3e" % (what, float(np.max(np.abs(got - want)))))
  assert err <= atol, "%s: max|d| - rtol|want| %.3e > %.0e" % (what, err,
                                                               atol)


def _check_state(got, want, label):
  for name, g, w, atol in zip(("dictionary", "hessian", "eigvec", "codes"),
                              got, want, (3e-5, 3e-6, 3e-5, 3e-5)):
    assert g.shape == w.shape, (label, name, g.shape, w.shape)
    assert_close(g, w, "%s %s" % (label, name), atol=atol)


def _same_on_every_rank(ranks, key):
  for other in ranks[1:]:
    for part in ("eigvec", "eta"):
      assert np.array_equal(ranks[0][key][part], other[key][part]), (
          "%s: the %s differs across ranks" % (key, part))
    for a, b in zip(ranks[0][key]["state"], other[key]["state"]):
      assert np.array_equal(a, b), key + ": gathered state differs"


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,at", [(2, 0), (4, 0), (4, 1)])
def test_code_mesh_against_vtc_tpu_grid(world, at):
  spec = MESHES[world][at]
  jmesh = jax_make_mesh(**spec)
  grid = np.vectorize(lambda dev: dev.id)(jmesh.devices)
  ranks = rank_results(world)
  code, size = spec["code"], world // spec["code"]
  rows = 4 * world
  x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
  for rank, out in enumerate(ranks):
    m = out["mesh " + _key(spec)]
    assert m["axis_names"] == tuple(jmesh.axis_names)
    assert m["shape"] == dict(jmesh.shape)
    # vtc_tpu's device at this rank's coordinates is the device of its id
    coords = tuple(m["position"][a] for a in jmesh.axis_names)
    assert grid[coords] == rank
    assert (m["rank"], m["code_index"], m["index"]) == (
        rank, rank % code, rank // code)
    assert (m["code_size"], m["size"]) == (code, size)
    assert m["dp_axes"] == (("dcn", "data") if "dcn" in spec else ("data",))
    lo = (rank % code) * rows // code
    assert m["row_bounds"] == (lo, lo + rows // code)
    assert np.array_equal(m["rows"], x[lo:lo + rows // code])
    b_lo = (rank // code) * rows // size
    assert np.array_equal(m["batch"], x[b_lo:b_lo + rows // size])
    # the data group: the ranks at this code position
    data_ranks = range(rank % code, world, code)
    assert np.array_equal(m["sum"], x[:2] * sum(r + 1 for r in data_ranks))
    # the code group: the ranks at this data-axes position
    code_ranks = range((rank // code) * code, (rank // code + 1) * code)
    assert m["in place"]
    assert np.array_equal(m["sum_code_"], (x[:2] * sum(
        r + 1 for r in code_ranks)).reshape(-1))
    assert np.array_equal(m["gather"], x)
    assert np.array_equal(m["gather_code"], x.T)
    assert m["object"] == {"rank": 0}


def test_code_mesh_refusals():
  with pytest.raises(ValueError, match="process group"):
    parallel.make_mesh(code=2)  # no group of 2 ranks here
  with pytest.raises(ValueError, match="'code' axis of 2 ranks needs"):
    parallel.Mesh(1, code=2)
  with pytest.raises(ValueError, match="code position"):
    parallel.Mesh(1, code=2, code_group=object(), code_index=2)
  with pytest.raises(ValueError, match="process group of the whole mesh"):
    parallel.Mesh(2, code=2, group=object(), index=1, code_group=object(),
                  code_index=1)
  mesh = parallel.Mesh(2, code=2, group=object(), index=1,
                       code_group=object(), code_index=1,
                       world_group=object())
  assert (mesh.rank, mesh.position) == (3, {"data": 1, "code": 1})
  assert mesh.code_shard_bounds(8) == (4, 8)
  with pytest.raises(ValueError, match="divide by the 'code' size 2"):
    mesh.code_shard_bounds(5)
  one = parallel.make_mesh()
  x = np.arange(6.0)
  assert one.code_shard(x) is x and one.code_size == 1
  assert (one.code_group, one.world_group) == (None, None)


def test_code_mesh_on_a_subgroup_is_refused(monkeypatch):
  """data and 'code' both above 1 on a subgroup of the default group:
  the subgroups it would create need every process of the default group
  (here a group of 4 in a default group of 8, faked: no process enters a
  collective)."""
  sub = object()
  dist = parallel.mesh.dist
  monkeypatch.setattr(dist, "is_initialized", lambda: True)
  monkeypatch.setattr(dist, "get_world_size",
                      lambda group=None: 4 if group is sub else 8)
  monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
  with pytest.raises(ValueError, match="span the default group"):
    parallel.make_mesh(data=2, code=2, group=sub)
  # one axis above 1 creates no subgroup: the group itself is the mesh's
  mesh = parallel.make_mesh(data=1, code=4, group=sub)
  assert mesh.code_group is sub and mesh.world_group is sub


# ---------------------------------------------------------------------------
# the plain K19 segment across ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SEGMENTS))
@pytest.mark.parametrize("world", [2, 4])
def test_plain_segment_matches_the_pallas_kernel(world, name):
  spec = MESHES[world][0]
  key = "%s %s" % (name, _key(spec))
  ranks = rank_results(world)
  _same_on_every_rank(ranks, key)
  where = SEGMENTS[name][4]
  data, code = ((spec["data"], spec["code"]) if where == "same" else where)
  want = jax_segment(name, data, code)
  _check_state(ranks[0][key]["state"], want,
               "%s at %s vs vtc_tpu at (%d, %d)" % (name, _key(spec), data,
                                                    code))


def test_stop_test_matches_the_pallas_kernel():
  ranks = rank_results(4)
  _same_on_every_rank(ranks, "stop")
  got, want = ranks[0]["stop"]["state"], jax_stop()
  _check_state(got, want, "in-kernel stop at (2, 2)")
  # the stop fired: the full 20 iterations move the dictionary elsewhere
  seed, sizes, _, sw, n_it, upd = STOP
  d, h, v, x = _problem(seed, **sizes)
  full = cs.fused_code_sharded_train_segment_plain(
      *map(torch.from_numpy, (d, h, v, x)), sw, n_it, upd, power_iters=2)
  assert np.abs(full[0].numpy() - got[0]).max() > 1e-6


@pytest.mark.parametrize("stop", [False, True])
@pytest.mark.parametrize("tier", WORLD_TIERS)
@pytest.mark.parametrize("world", [2, 4])
def test_plain_segment_at_a_tier_matches_the_pallas_kernel(world, tier,
                                                           stop):
  spec = MESHES[world][0]
  key = _tier_key(stop, tier, spec)
  ranks = rank_results(world)
  _same_on_every_rank(ranks, key)
  data, code = spec["data"], spec["code"]
  want = jax_tier(stop, tier, data, code)
  got = np.concatenate([np.asarray(a, np.float64).ravel()
                        for a in ranks[0][key]["state"]])
  bound = FLOOR[tier] * max(1.0, float(np.abs(want).max()))
  err = float(np.abs(got - want).max())
  if err > bound:  # vtc_tpu's own spread, where the floor does not hold
    bound = max(bound, max(float(np.abs(jax_tier(stop, tier, data, code,
                                                 seed) - want).max())
                           for seed in range(5)))
  print("%s: max|d| %.3e (bound %.3e)" % (key, err, bound))
  assert err <= bound
  if stop:
    counts = [r[key]["iters"] for r in ranks]
    assert all(c == counts[0] for c in counts), counts
    assert min(counts[0]) < STOP[4], counts[0]  # it stopped


def test_shard_below_n_was_refused_before():
  """The global s > n rule (vtc_tpu compiled_epoch.py:596): a shard of
  s_l = n rows runs; a global s <= n is refused."""
  assert cs.code_shard_segment_supported(16, 16, 16, 2)
  assert cs.code_shard_segment_supported(8, 8, 16, 4)
  assert not cs.code_shard_segment_supported(16, 8, 16, 2)
  assert jcs.code_shard_segment_supported(16, 16, 16, 2)


@pytest.mark.cuda
def test_cuda_kernel_across_ranks_matches_plain():
  """K19 across two ranks on the card against its float64 plain version
  (chip_smoke.py phase 36 runs bench's width at worlds of 2 and 4)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the residual-form kernels have no "
                "CPU mode")
  d, h, v, x = _problem(11)
  ranks = worker.run_ranks(2, [("k19", "cs_cuda", dict(
      mesh_spec=MESHES[2][0], d=d, h=h, v=v, batches=x, sw=SW, n_it=N_IT,
      upd_step=UPD))])
  got, want = ranks[0]["k19"]
  for name, g, w in zip(("dictionary", "hessian", "eigvec"), got, want):
    assert_close(g, w, "cuda across ranks " + name, atol=1e-5, rtol=0)
