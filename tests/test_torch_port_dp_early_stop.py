"""The early stop of the data-parallel segments K15 and K16 and of the
big-dictionary segment K19 against vtc_tpu on the CPU.

vtc_tpu runs the batch-global stop test inside those kernels: after
iteration j > 0 a step's solve ends when the sum of |codes - old| over every
device's shard, times 1 / count, over eta is below eps, every device at the
same count (pallas_dp_train.py:206-248, pallas_group_dp_train.py:189-229,
pallas_code_shard_train.py:387-431).  The port runs it on the card in its
CUDA kernels; a CPU tensor takes each kernel's plain version with the same
test (each rank's sum, ``Mesh.sum``, then the scale), which this file holds
to vtc_tpu:

* K15 and K16 (contiguous groups of 4 and the anti-alignment regularizer)
  through their runners with ``early_eps`` at a world of 1, in this
  process, against vtc_tpu's kernel in interpret mode on a one-device
  'data' axis, each with an eps that stops at j = 1, one picked from the
  port's means to stop mid-run, and 0 (never);
* the same at worlds of 2 and 4 (spawned ranks, tests/torch_port_dp_
  worker.py, one spawn per world for the file): every rank bitwise equal,
  every step's count that of the world of 1; the mid-run stop against
  vtc_tpu's kernel on as many CPU devices (its slot all-reduce an
  iteration costs 3-9 s a run in interpret mode, so only that eps runs
  there), the stops at j = 1 and never against the world of 1, which is
  held to vtc_tpu above;
* the scanned trainers' routing: fc and subspace with data_parallel and
  eps take K15 and K16 with the stop where vtc_tpu takes its K15 and K16
  with the stop (vtc_tpu tests/test_dp_early_stop.py:152-218), the
  runners spied on both sides, to the same dictionary;
* K19 at one rank, fc and 16 contiguous groups of 4, against vtc_tpu's
  K19 in interpret mode on a 1 x 1 mesh at the trainer's stop count (the
  grouped codes' G * M); its stop across ranks at (2, 2) is held by
  tests/test_torch_port_code_shard_parallel.py.

The eps of a case come from the port's means (``solver.last_avgs``,
``fused_code_shard_train.plain_avgs``) of the first step's solve: 1.5
times the first, the geometric mean of a new low and the lowest mean
before it (a few percent from either), or 0.  Tolerances: the replicated
state within 2e-5 of max(1, |largest value|), the existing data-parallel
tests' bound (tests/test_torch_port_dp_segments.py), the codes at one
rank too; K19 as tests/test_torch_port_code_shard.py holds it (3e-5, the
codes 1e-4); the trainers at vtc_tpu's 5e-5.  The card's checks are
chip_smoke.py's phase 45.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

import torch_port_dp_worker as worker
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.ops import lipschitz as jax_lip
from vtc_tpu.ops import pallas_code_shard_train as jax_k19
from vtc_tpu.ops import pallas_dp_train as jax_k15
from vtc_tpu.ops import pallas_group_dp_train as jax_k16
from vtc_tpu.training import compiled_epoch as jax_compiled_epoch
from vtc_tpu_torch.ops import fused_code_shard_train as cs
from vtc_tpu_torch.ops import fused_dp_train, fused_group_dp_train, solver
from vtc_tpu_torch.training import compiled_epoch

SW, N_IT, UPD = 0.2, 8, 0.01
CQ = "sc_cheap_quadratic_descent"
SUB_CQ = "subspace_" + CQ
STOPS = ("early", "mid", "never")
GROUPS = [list(range(i, i + 4)) for i in range(0, 16, 4)]
FAMILIES = {"fc": dict(update_alg=CQ),
            "group": dict(update_alg=SUB_CQ, group_assignments=GROUPS,
                          alignment_penalty=0.1)}
WORLDS = (2, 4)
REL = 2e-5


def assert_close(got, want, what, rel=REL):
  """|got - want| <= rel * max(1, |want|max) everywhere."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want, np.float64)
  err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
  bound = rel * max(1.0, float(np.abs(want).max()))
  print("%s: max|d| = %.3e (bound %.1e)" % (what, err, bound))
  assert err <= bound, "%s: max|d| %.3e > %.1e" % (what, err, bound)


def _t(x):
  return torch.from_numpy(np.array(x, dtype=np.float32))


def stop_eps(avgs, which):
  """An eps from a plain run's means (avgs[j - 1] after iteration j):
  'early' stops at j = 1, 'mid' at the first new low past the first quarter
  5% under every earlier mean (eps between the two), 'never' is 0."""
  if which == "never":
    return 0.0
  if which == "early":
    return 1.5 * avgs[0]
  for j in range(max(2, len(avgs) // 4), len(avgs)):
    low = min(avgs[:j])
    if avgs[j] < 0.95 * low:
      return float(np.sqrt(avgs[j] * low))
  raise AssertionError("no clear low in the means %s" % avgs)


@functools.lru_cache(maxsize=None)
def problem(family):
  """A unit-norm dictionary (s 16, n 16), a small Hessian, the exact seed of
  the Gram's eigenvector (the contiguous groups' Dg is D) and two global
  batches of 16 sparse-synthesizable patches."""
  rng = np.random.RandomState(19 if family == "fc" else 20)
  d = rng.randn(16, 16).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  basis = rng.randn(6, 16)
  x = (rng.randn(32, 6) * 0.5) @ basis + 0.1 * rng.randn(32, 16)
  h = (0.05 + 0.05 * rng.rand(16)).astype(np.float32)
  v = np.array(jax_lip.top_gram_eigenpair(jnp.asarray(d))[1])  # writable
  return dict(d=d, h=h, v=v, x=x.astype(np.float32).reshape(2, 16, 16))


def _config(family, eps):
  return dict(FAMILIES[family], early_eps=eps, sw=SW, n_it=N_IT,
              upd_step=UPD)


def _case(family, eps):
  pr = problem(family)
  return dict(family=family, d=pr["d"], h=pr["h"], v=pr["v"],
              batches=pr["x"], config=_config(family, eps))


@functools.lru_cache(maxsize=None)
def eps_of(family):
  """{which: eps} from the port's means of the first step's solve."""
  pr = problem(family)
  plain = (fused_dp_train.fused_dp_train_plain if family == "fc"
           else fused_group_dp_train.fused_group_dp_train_plain)
  kw = dict(FAMILIES[family])
  plain(_t(pr["d"]), _t(pr["h"]), _t(pr["v"]), _t(pr["x"][:1]), SW, N_IT,
        UPD, mesh=worker.parallel.make_mesh(), power_iters=2,
        early_stopping_epsilon=0.0, **kw)
  avgs = list(solver.last_avgs)
  return {which: stop_eps(avgs, which) for which in STOPS}


@functools.lru_cache(maxsize=None)
def world_of_one(family, which):
  """The port's runner with the stop in this process (a mesh of one)."""
  return worker.CASES["dp_stop"](**_case(family, eps_of(family)[which]))


@functools.lru_cache(maxsize=None)
def jax_segment(family, which, p):
  """vtc_tpu's K15 or K16 with the stop over the global batches on ``p``
  devices of a 'data' axis, in interpret mode: the replicated state and
  the last codes (a shard's above one device)."""
  pr = problem(family)
  kw = dict(FAMILIES[family], power_iters=2,
            early_stopping_epsilon=eps_of(family)[which])
  if family == "fc":
    kernel = jax_k15.fused_dp_train_segment_pallas
  else:
    kernel = jax_k16.fused_group_dp_train_segment_pallas
    kw["group_assignments"] = tuple(tuple(g) for g in GROUPS)

  def body(d, h, v, xs):
    return kernel(d, h, v, xs, jnp.float32(SW), jnp.int32(N_IT),
                  jnp.float32(UPD), axis_name="data", axis_size=p,
                  interpret=True, **kw)

  rep = PartitionSpec()
  mesh = Mesh(np.asarray(jax.devices()[:p]).reshape(p, 1), ("data", "code"))
  fn = jax.jit(jax.shard_map(
      body, mesh=mesh, in_specs=(rep,) * 3 + (PartitionSpec(None, "data",
                                                             None),),
      out_specs=(rep,) * 3 + (PartitionSpec("data", None),),
      check_vma=False))
  return tuple(np.asarray(a) for a in fn(pr["d"], pr["h"], pr["v"], pr["x"]))


def _check_counts(family, which, counts):
  """The counts of a stop: 2 at j = 1, N_IT never, else some of the steps
  short of N_IT and none at 2 or below (mid-run)."""
  assert len(counts) == problem(family)["x"].shape[0]
  if which == "early":
    assert counts == [2] * len(counts), counts
  elif which == "never":
    assert counts == [N_IT] * len(counts), counts
  else:
    assert all(2 < c <= N_IT for c in counts) and min(counts) < N_IT, counts


@pytest.mark.parametrize("which", STOPS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_world_of_one_matches_the_pallas_kernel(family, which):
  """What a CPU tensor runs at a world of 1 (the runner, K15's or K16's
  plain version with the stop) against vtc_tpu's kernel with the stop on
  a one-device axis; the counts."""
  got = world_of_one(family, which)
  _check_counts(family, which, got["counts"])
  want = jax_segment(family, which, 1)
  for what, g, w in zip(("dictionary", "hessian", "eigvec"), got["state"],
                        want):
    assert_close(g, w, "%s eps %s world 1 %s" % (family, which, what))
  # the last codes, through the segment itself (the runner drops them)
  pr = problem(family)
  fn = (fused_dp_train.fused_dp_train_segment if family == "fc"
        else fused_group_dp_train.fused_group_dp_train_segment)
  codes = fn(_t(pr["d"]), _t(pr["h"]), _t(pr["v"]), _t(pr["x"]), SW, N_IT,
             UPD, mesh=worker.parallel.make_mesh(), power_iters=2,
             early_stopping_epsilon=eps_of(family)[which],
             **FAMILIES[family])[3]
  assert_close(codes, want[3], "%s eps %s world 1 last codes" % (family,
                                                                  which))


@functools.lru_cache(maxsize=None)
def rank_results(world):
  return worker.run_ranks(world, [
      ("%s %s" % (family, which), "dp_stop",
       _case(family, eps_of(family)[which]))
      for family in sorted(FAMILIES) for which in STOPS])


@pytest.mark.parametrize("which", STOPS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_and_match_the_pallas_kernel(world, family, which):
  """The runner with the stop on ``world`` spawned ranks: every rank
  bitwise the same state and counts, the counts the world of 1's; against
  vtc_tpu's kernel with the stop on as many devices (the mid-run stop) or
  the world of 1 (the stops at j = 1 and never)."""
  ranks = rank_results(world)
  key = "%s %s" % (family, which)
  first = ranks[0][key]
  for out in ranks[1:]:
    assert out[key]["counts"] == first["counts"], key
    for a, b in zip(out[key]["state"], first["state"]):
      assert np.array_equal(a, b), "%s: the ranks differ" % key
  one = world_of_one(family, which)
  assert first["counts"] == one["counts"], (first["counts"], one["counts"])
  want = (jax_segment(family, which, world)[:3] if which == "mid"
          else one["state"])
  for what, g, w in zip(("dictionary", "hessian", "eigvec"), first["state"],
                        want):
    assert_close(g, w, "%s world %d %s" % (key, world, what))


# ---------------------------------------------------------------------------
# the trainers' routing with eps (vtc_tpu tests/test_dp_early_stop.py)
# ---------------------------------------------------------------------------
def _spy(monkeypatch, module, name, calls):
  original = getattr(module, name)

  def spy(*args, **kw):
    calls.append(kw.get("early_eps", args[-1] if args else None))
    return original(*args, **kw)

  monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trainers_take_k15_and_k16_with_the_stop(monkeypatch, family):
  """fc or subspace + data_parallel + eps: the port's scanned trainer takes
  K15's or K16's runner with the stop exactly where vtc_tpu's takes its
  K15 or K16 runner with the stop (here on a 2-device 'data' axis, its
  interpret mode's spare-thread rule), to the same dictionary."""
  pr = problem(family)
  eps = eps_of(family)["mid"]
  params = {
      "mode": "fully-connected", "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {0: {"sparsity_weight": SW,
                                        "num_iters": N_IT}},
      "dictionary_update_algorithm": CQ,
      "dict_update_param_schedule": {0: {"stepsize": UPD, "num_iters": 1}},
      "fc_formulation": "pallas", "early_stopping_epsilon": eps,
      "stdout_print_interval": 10 ** 9}
  names = ("_dp_rdma_segment_runner", "_dp_fc_segment_runner")
  if family == "group":
    params.update(code_inference_algorithm="subspace_fista",
                  dictionary_update_algorithm=SUB_CQ,
                  group_assignments=GROUPS, subspace_alignment_penalty=0.1)
    names = ("_dp_rdma_group_segment_runner", "_dp_group_segment_runner")
  jax_calls, calls = [], []
  _spy(monkeypatch, jax_compiled_epoch, names[0], jax_calls)
  _spy(monkeypatch, compiled_epoch, names[1], calls)
  want = np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      pr["x"], pr["x"][:1], pr["d"].copy(),
      dict(params, data_parallel=jax_parallel.make_mesh(data=2))))
  got = compiled_epoch.train_dictionary_scanned(
      pr["x"], pr["x"][:1], _t(pr["d"]), dict(params, data_parallel=True),
      device="cpu")
  assert jax_calls and jax_calls[0] == pytest.approx(eps)
  assert calls and calls[0] == pytest.approx(eps), (
      "%s + data_parallel + eps must take the segment runner with the stop"
      % family)
  assert_close(got, want, "%s data-parallel trainer with the stop" % family,
               5e-5)


# ---------------------------------------------------------------------------
# K19 at one rank (its stop across ranks:
# tests/test_torch_port_code_shard_parallel.py)
# ---------------------------------------------------------------------------
K19_GROUPS = [list(range(i, i + 4)) for i in range(0, 64, 4)]


@functools.lru_cache(maxsize=None)
def k19_problem():
  rng = np.random.RandomState(21)
  d = rng.randn(64, 16).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = rng.randn(2, 8, 16).astype(np.float32)
  h = np.abs(rng.randn(64)).astype(np.float32) * 0.01
  v = np.linalg.eigh(d.astype(np.float64).T @ d)[1][:, -1].astype(np.float32)
  return d, h, v, x


@pytest.mark.parametrize("grouped", [False, True], ids=["fc", "groups"])
def test_k19_stop_matches_the_pallas_kernel(grouped):
  """K19's plain version with the stop at one rank against vtc_tpu's K19
  with the stop at the trainer's count, an eps picked to stop mid-run;
  the stop fired, so the state differs from the full solve's."""
  d, h, v, x = k19_problem()
  kw, jkw = {}, {}
  count = x.shape[1] * d.shape[0]
  update_alg = CQ
  if grouped:
    arrays = cs.code_shard_group_arrays(K19_GROUPS, d.shape[0], 1)
    kw["expand_local"] = arrays[0][0]
    jkw = dict(expand_local=jnp.asarray(arrays[0][0]),
               roll_window=jax_k19.roll_window_from_expand_arrays(arrays[0]))
    count = x.shape[1] * len(K19_GROUPS) * 4
    update_alg = SUB_CQ

  def port(eps):
    return [t.numpy() for t in cs.fused_code_sharded_train_segment(
        *map(torch.from_numpy, (d, h, v, x)), SW, 20, UPD, power_iters=2,
        update_alg=update_alg, early_stopping_epsilon=eps, stop_count=count,
        **kw)]

  port(0.0)
  eps = stop_eps(list(cs.plain_avgs), "mid")
  got = port(eps)
  assert min(cs.plain_iters) < 20, cs.plain_iters
  mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "code"))

  def body(d_, h_, v_, x_):
    return jax_k19.fused_code_sharded_train_segment_pallas(
        d_, h_, v_, x_, jnp.float32(SW), jnp.int32(20), jnp.float32(UPD),
        axis_name="code", axis_size=1, interpret=True, power_iters=2,
        update_alg=update_alg, early_stopping_epsilon=eps, stop_count=count,
        **jkw)

  rep = PartitionSpec()
  fn = jax.jit(jax.shard_map(
      body, mesh=mesh,
      in_specs=(PartitionSpec("code", None), PartitionSpec("code"), rep,
                rep),
      out_specs=(PartitionSpec("code", None), PartitionSpec("code"), rep,
                 PartitionSpec(None, "code")), check_vma=False))
  want = [np.asarray(t) for t in fn(*map(jnp.asarray, (d, h, v, x)))]
  for what, g, w, tol in zip(("dictionary", "hessian", "eigvec", "codes"),
                             got, want, (3e-5, 3e-5, 3e-5, 1e-4)):
    err = float(np.abs(g.astype(np.float64) - w).max())
    print("K19 %s stop %s: max|d| %.3e (atol %.0e)" % (
        "groups" if grouped else "fc", what, err, tol))
    assert err <= tol
  full = port(None)
  assert np.abs(full[0] - got[0]).max() > 1e-6


@pytest.mark.cuda
def test_cuda_dp_stop_matches_plain():
  """On the card: K15 and K16 with the stop against the same kernel without
  it at the reported counts and against their plain versions, K19's two
  routes with the stop; chip_smoke.py phase 45 makes the check at the
  flagship widths (the card's machine has no jax, so this file cannot run
  there)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the stop builds have no CPU mode")
  pr = problem("fc")
  mesh = worker.parallel.make_mesh()
  args = [t.cuda() for t in (_t(pr["d"]), _t(pr["h"]), _t(pr["v"]),
                             _t(pr["x"]))]
  eps = eps_of("fc")["mid"]
  got = fused_dp_train.fused_dp_train_segment(
      *args, SW, N_IT, UPD, mesh=mesh, power_iters=2,
      early_stopping_epsilon=eps)
  counts = fused_dp_train.last_iters.tolist()
  fused_dp_train.fused_dp_train_segment(
      *(t.cpu() for t in args), SW, N_IT, UPD, mesh=mesh, power_iters=2,
      early_stopping_epsilon=eps)
  assert counts == fused_dp_train.plain_iters
  assert all(bool(torch.isfinite(t).all()) for t in got)
