"""The port's data-parallel entry points against vtc_tpu on the CPU: both
sparse-coding trainers, the scanned ICA trainer, PCA and encode_dataset
with ``data_parallel``.

Worlds of 2 and 4 are spawned CPU processes in one gloo group over a
file:// store (tests/torch_port_dp_worker.py); every rank calls the entry
point with the same global arrays, as a user's ranks would.  Each result is
held to vtc_tpu's on its virtual 8-device CPU mesh and to the port's
single-device result, and must be bitwise the same on every rank.

Tolerances: 2e-5 on dictionaries, tests/test_parallel.py's bound for a
data-parallel trainer against the single-device one (:120, :229, :344,
:467).  The scanned cheap-quadratic runs amplify rounding (ROADMAP.md §3),
so they are held to 2e-5 or to twice the distance vtc_tpu's own
data-parallel run moves when its initial dictionary moves by one ulp,
whichever is larger, as tests/test_torch_port_trainer.py holds the
single-device trainer.  PCA is compared up to the sign of each row (1e-3 on
the overlap, :491); encoded codes at 1e-5.  A world of 1 runs in this
process, with no process group.
"""
import functools

import numpy as np
import pytest
import torch

import torch_port_dp_worker as worker
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu.training import ica as jax_ica
from vtc_tpu.training import pca as jax_pca
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu_torch import parallel
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import (fused_dp_train, fused_group_dp_train,
                               fused_group_train_step, fused_ica_train,
                               fused_train_step)
from vtc_tpu_torch.training import compiled_epoch, ica, pca
from vtc_tpu_torch.training import sparse_coding as sc

WORLDS = (2, 4)
ATOL = 2e-5
GROUPS16 = [list(range(i, i + 4)) for i in range(0, 16, 4)]


def assert_close(got, want, atol, what):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.1e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.1e" % (what, err, atol)


def _data(seed, k=4, b=16, s=16, n=16):
  """Sparse-synthesizable batches (noise at these stepsizes diverges on
  every backend) and a unit-norm initial dictionary."""
  rng = np.random.RandomState(seed)
  basis = rng.randn(6, n)
  w = rng.randn(k * b, 6) * 2.0
  data = (w @ basis + 0.2 * rng.randn(k * b, n)).astype(
      np.float32).reshape(k, b, n)
  d0 = rng.randn(s, n).astype(np.float32)
  d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
  return data, d0


def _params(**extra):
  params = {
      "mode": "fully-connected",
      "num_epochs": 2,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 8}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": 0.01, "num_iters": 1},
          5: {"stepsize": 0.005, "num_iters": 2}},
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


_SUBSPACE = dict(
    code_inference_algorithm="subspace_fista",
    dictionary_update_algorithm="subspace_sc_cheap_quadratic_descent",
    group_assignments=GROUPS16, subspace_alignment_penalty=0.1)
DATA, D0 = _data(0)
TRAIN_CASES = {  # name: (trainer, params)
    "scanned fc fused": ("scanned", _params(fc_formulation="pallas")),
    "scanned subspace fused": ("scanned", _params(fc_formulation="pallas",
                                                  **_SUBSPACE)),
    "scanned fc cold steepest": ("scanned", _params(
        dictionary_update_algorithm="sc_steepest_descent",
        fc_formulation="gram", lipschitz_method="eigvalsh")),
    "scanned fc early stop": ("scanned", _params(
        dictionary_update_algorithm="sc_steepest_descent",
        lipschitz_method="eigvalsh", early_stopping_epsilon=1e-2,
        inference_param_schedule={0: {"sparsity_weight": 0.05,
                                      "num_iters": 60}})),
    "per-batch fc": ("per_batch", _params()),
    "per-batch subspace": ("per_batch", _params(**_SUBSPACE)),
}
ICA_N = 16
ICA_BATCHES = (0.5 * np.random.RandomState(3).randn(6, 32, ICA_N)).astype(
    np.float32)
ICA_D0 = np.linalg.qr(np.random.RandomState(4).randn(ICA_N, ICA_N))[0].astype(
    np.float32)


def _ica_params(**extra):
  params = {"num_epochs": 2,
            "dictionary_update_algorithm": "ica_natural_gradient",
            "dict_update_param_schedule": {
                0: {"stepsize": 0.02, "num_iters": 1},
                4: {"stepsize": 0.01, "num_iters": 2}},
            "stdout_print_interval": 10**9}
  params.update(extra)
  return params


ICA_CASES = {"warm": {}, "lu solve": {"warm_inverse": False},
             "fused": {"use_fused": True}}
PCA_DATA = np.random.RandomState(5).randn(320, 24).astype(np.float32)
PCA_DATA -= PCA_DATA.mean(axis=0)
ENC_X = np.random.RandomState(6).randn(70, 16).astype(np.float32)
ENC_CASES = {"fc": dict(batch_size=16, chunk_batches=2),
             "subspace": dict(batch_size=16, chunk_batches=2,
                              group_assignments=GROUPS16),
             "fc ista nonneg": dict(batch_size=32, variant="ista",
                                    nonnegative_only=True)}
SHUFFLE = _params(shuffle_each_epoch=True, shuffle_seed=11, num_epochs=3)
EVENTS_RP = {5: {"filter_type": "random",
                 "filter_params": {"num_to_modify": 2}, "action": "prune"}}


@functools.lru_cache(maxsize=None)
def rank_results(world, tmp):
  """Every multi-rank case of this file, in one spawn per world size."""
  cases = []
  for name, (trainer, params) in TRAIN_CASES.items():
    cases.append((name, "train", dict(trainer=trainer, batches=DATA,
                                      val=DATA[:1], d0=D0, params=params)))
  events = _params(fc_formulation="pallas", checkpoint_schedule={3, 8},
                   logging_folder_fullpath=tmp,
                   dict_element_rp_schedule=EVENTS_RP)
  cases.append(("events", "train", dict(trainer="scanned", batches=DATA,
                                        val=DATA[:1], d0=D0, params=events)))
  cases.append(("visited", "visited", dict(batches=DATA, d0=D0,
                                           params=SHUFFLE)))
  for name, extra in ICA_CASES.items():
    cases.append(("ica " + name, "ica", dict(batches=ICA_BATCHES, d0=ICA_D0,
                                             params=_ica_params(**extra))))
  cases.append(("ica rollback", "ica", dict(
      batches=ICA_BATCHES, d0=ICA_D0,
      params=_ica_params(use_fused=True, dict_update_param_schedule={
          0: {"stepsize": 40.0, "num_iters": 1}}))))
  cases.append(("pca", "pca", dict(data=PCA_DATA)))
  for name, kw in ENC_CASES.items():
    cases.append(("encode " + name, "encode", dict(data=ENC_X, d=D0, sw=0.05,
                                                   n_it=15, kw=kw)))
  return worker.run_ranks(world, cases)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """ranks(world) -> the per-rank results; one spawn per world size."""
  def get(world):
    return rank_results(world, str(tmp_path_factory.getbasetemp()
                                   / ("dp_events_%d" % world)))
  return get


def _replicated(results, key):
  first = results[0][key]
  for other in results[1:]:
    a, b = first, other[key]
    if isinstance(a, dict):
      a, b = a["dictionary"], b["dictionary"]
    assert np.array_equal(a, b), "%s differs across ranks" % key
  return first


# ---------------------------------------------------------------------------
# the sparse-coding trainers
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_trained(name):
  """(vtc_tpu's data-parallel result on its 8-device mesh, the bound the
  port is held to)."""
  trainer, params = TRAIN_CASES[name]
  fn = (jax_ce.train_dictionary_scanned if trainer == "scanned"
        else jax_sc.train_dictionary)
  params = dict(params, data_parallel=jax_parallel.make_mesh(data=8))
  want = np.asarray(fn(DATA, DATA[:1], D0.copy(), params))
  if "cheap" not in params["dictionary_update_algorithm"]:
    return want, ATOL
  nudged = np.nextafter(D0, np.float32(2)).astype(np.float32)
  moved = np.asarray(fn(DATA, DATA[:1], nudged, params))
  return want, max(ATOL, 2.0 * float(np.abs(moved - want).max()))


def _single(name):
  trainer, params = TRAIN_CASES[name]
  fn = (compiled_epoch.train_dictionary_scanned if trainer == "scanned"
        else sc.train_dictionary)
  return fn(DATA, DATA[:1], D0, params, device="cpu")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_trainer_matches_vtc_tpu_and_single_device(ranks, world, name):
  got = _replicated(ranks(world), name)
  want, bound = jax_trained(name)
  assert got.shape == D0.shape and np.isfinite(got).all()
  assert float(np.abs(got - D0).max()) > 1e-3  # it trained
  assert_close(got, want, bound, "vs vtc_tpu on its 8-device mesh")
  if "fused" not in name:
    # the same stepsize rule on one device: the same trajectory (the fused
    # cases track the stepsize warm; the next test holds them)
    assert_close(got, _single(name), bound, "vs the port's single device")


@pytest.mark.parametrize("name", ["scanned fc fused",
                                  "scanned subspace fused"])
@pytest.mark.parametrize("world", WORLDS)
def test_fused_dp_trainer_matches_single_device_fused(ranks, world, name):
  """The fused-DP composition keeps the warm tracking of the single-device
  fused path ('pallas' on CPU tensors: the kernels' plain versions)."""
  got = _replicated(ranks(world), name)
  assert_close(got, _single(name), jax_trained(name)[1],
               "vs the port's single-device fused trainer")


@pytest.mark.parametrize("world", WORLDS)
def test_events_keep_the_ranks_in_step(ranks, world, tmp_path_factory):
  """A prune that draws random numbers and checkpoints on the way: rank 0
  writes, every rank takes rank 0's draw, the state stays replicated."""
  got = _replicated(ranks(world), "events")
  assert got.shape == (D0.shape[0] - 2, D0.shape[1])
  assert np.isfinite(got).all()
  logdir = tmp_path_factory.getbasetemp() / ("dp_events_%d" % world)
  names = sorted(p.name for p in logdir.iterdir())
  assert names == ["checkpoint_dictionary_iter_3",
                   "checkpoint_dictionary_iter_8",
                   "checkpoint_trainstate_iter_3.npz",
                   "checkpoint_trainstate_iter_8.npz",
                   "training_params.yaml"], names
  from vtc_tpu_torch.utils import checkpoint as ckpt
  assert ckpt.load_dictionary_checkpoint(
      logdir / "checkpoint_dictionary_iter_8").shape == got.shape
  np.testing.assert_array_equal(ckpt.load_dictionary_checkpoint(
      logdir / "checkpoint_dictionary_iter_8"), got)


@pytest.mark.parametrize("world", WORLDS)
def test_shuffle_visits_the_single_device_order(ranks, world, monkeypatch):
  visited = _replicated(ranks(world), "visited")
  seen = []

  def recording_runner(raw_step, upd_num_iters, warm_power, lip_matrix_fn):
    def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
      seen.append(batches.numpy().copy())
      return dictionary, hessian, eigvec
    return run

  monkeypatch.setattr(compiled_epoch, "_segment_runner", recording_runner)
  compiled_epoch.train_dictionary_scanned(DATA, DATA[:1], D0, SHUFFLE,
                                          device="cpu")
  single = np.concatenate(seen)
  assert single.shape == visited.shape == (3 * DATA.shape[0],) + DATA.shape[1:]
  assert np.array_equal(visited, single)
  flat = np.sort(DATA.reshape(-1, DATA.shape[-1]), axis=0)
  for epoch in range(3):  # each epoch is a permutation of the samples
    part = visited[epoch * DATA.shape[0]:(epoch + 1) * DATA.shape[0]]
    assert np.array_equal(np.sort(part.reshape(flat.shape), axis=0), flat)
  assert not np.array_equal(visited[:DATA.shape[0]], DATA)


# ---------------------------------------------------------------------------
# ICA, PCA and encode_dataset
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def jax_ica_trained(warm):
  return np.asarray(jax_ica.train_dictionary_scanned(
      ICA_BATCHES, ICA_D0, _ica_params(
          warm_inverse=warm, data_parallel=jax_parallel.make_mesh(data=8))))


@pytest.mark.parametrize("name", sorted(ICA_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_ica_trainer_matches_vtc_tpu_and_single_device(ranks, world, name):
  got = _replicated(ranks(world), "ica " + name)
  assert got["rollbacks"] == 0
  want = jax_ica_trained(ICA_CASES[name].get("warm_inverse", True))
  assert_close(got["dictionary"], want, ATOL, "vs vtc_tpu on its mesh")
  single = ica.train_dictionary_scanned(
      ICA_BATCHES, ICA_D0, _ica_params(**ICA_CASES[name]), device="cpu")
  assert_close(got["dictionary"], single, ATOL, "vs the port's single device")


@pytest.mark.parametrize("world", WORLDS)
def test_ica_guard_rolls_back_on_every_rank(ranks, world):
  """Stepsize 40: the fused data-parallel segment's residual trips the lazy
  guard on every rank alike, and the rerun on the plain data-parallel
  runner lands where the per-step guarded path does."""
  results = ranks(world)
  for out in results:
    assert out["ica rollback"]["rollbacks"] >= 1
  got = _replicated(results, "ica rollback")["dictionary"]
  tracked = ica.train_dictionary_scanned(
      ICA_BATCHES, ICA_D0, _ica_params(
          use_fused=False, dict_update_param_schedule={
              0: {"stepsize": 40.0, "num_iters": 1}}), device="cpu")
  assert np.isfinite(got).all()
  # stepsize 40 blows the entries up to about 1e18 in 12 steps, and the
  # shards' statistic is summed in another order: 1e-3 of the largest
  scale = float(np.abs(tracked.numpy()).max())
  assert_close(got / scale, tracked.numpy() / scale, 1e-3,
               "rolled-back run vs the per-step guarded path")


@pytest.mark.parametrize("world", WORLDS)
def test_pca_matches_vtc_tpu_up_to_sign(ranks, world):
  got = _replicated(ranks(world), "pca")
  want = np.asarray(jax_pca.train_dictionary(
      PCA_DATA, data_parallel=jax_parallel.make_mesh(data=8)))
  single = pca.train_dictionary(PCA_DATA, device="cpu").numpy()
  for other in (want, single):
    overlap = np.abs(np.sum(got * other, axis=1))
    np.testing.assert_allclose(overlap, 1.0, atol=1e-3)
  np.testing.assert_allclose(got @ got.T, np.eye(24), atol=1e-4)


@functools.lru_cache(maxsize=None)
def jax_encoded(name):
  return np.asarray(jax_encode_dataset(
      ENC_X, D0, 0.05, 15, data_parallel=jax_parallel.make_mesh(data=8),
      **ENC_CASES[name]))


@pytest.mark.parametrize("name", sorted(ENC_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_encode_dataset_matches_vtc_tpu_and_single_device(ranks, world, name):
  got = _replicated(ranks(world), "encode " + name)
  assert got.shape == (ENC_X.shape[0], D0.shape[0])
  assert_close(got, jax_encoded(name), 1e-5, "vs vtc_tpu on its mesh")
  single = encode_dataset(ENC_X, D0, 0.05, 15, device="cpu",
                          **ENC_CASES[name])
  assert_close(got, single, 1e-5, "vs the port's single device")


# ---------------------------------------------------------------------------
# a world of 1, with no process group
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_world_of_one_needs_no_process_group(name):
  assert not torch.distributed.is_initialized()
  trainer, params = TRAIN_CASES[name]
  fn = (compiled_epoch.train_dictionary_scanned if trainer == "scanned"
        else sc.train_dictionary)
  for data_parallel in (True, parallel.make_mesh()):
    got = fn(DATA, DATA[:1], D0, dict(params, data_parallel=data_parallel),
             device="cpu")
    want, bound = jax_trained(name)
    assert_close(got, want, bound, "a mesh of one vs vtc_tpu's mesh of 8")


def test_world_of_one_runs_the_solve_stats_steps(monkeypatch):
  """With 'pallas' the data-parallel scanned trainers go through the
  whole-segment wrappers of K15, K16 and K18, one call per segment, whose
  plain versions on CPU tensors run K3, K7 and K9's plain steps, one per
  step; never through K3, K7 or K9's own wrappers (their per-step
  composition, which a mesh with a 'dcn' axis takes) nor the single-device
  segment wrappers."""
  calls = {key: 0 for key in ("k15", "k16", "k18", "k3", "k7", "k9")}

  def counting(module, name, key):
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
      calls[key] += 1
      return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)

  def forbidden(*args, **kwargs):
    raise AssertionError("a single-device segment or the per-step "
                         "composition ran at a world of 1")

  counting(fused_dp_train, "fused_dp_train_segment", "k15")
  counting(fused_group_dp_train, "fused_group_dp_train_segment", "k16")
  counting(fused_ica_train, "fused_ica_dp_train_segment", "k18")
  counting(fused_train_step, "fused_solve_stats_plain", "k3")
  counting(fused_group_train_step, "fused_group_solve_stats_plain", "k7")
  counting(fused_ica_train, "ica_solve_stats_plain", "k9")
  for module, name in (
      (fused_train_step, "fused_train_segment"),
      (fused_train_step, "fused_solve_stats"),
      (fused_group_train_step, "fused_group_train_segment"),
      (fused_group_train_step, "fused_group_solve_stats"),
      (fused_ica_train, "fused_ica_train_segment"),
      (fused_ica_train, "ica_solve_stats")):
    monkeypatch.setattr(module, name, forbidden)
  steps = 2 * DATA.shape[0]
  for name in ("scanned fc fused", "scanned subspace fused"):
    compiled_epoch.train_dictionary_scanned(
        DATA, DATA[:1], D0, dict(TRAIN_CASES[name][1], data_parallel=True),
        device="cpu")
  # two epochs of 4 steps, cut at step 5: three segments
  assert (calls["k15"], calls["k16"]) == (3, 3)
  assert (calls["k3"], calls["k7"]) == (steps, steps)
  ica.train_dictionary_scanned(
      ICA_BATCHES, ICA_D0, _ica_params(use_fused=True, data_parallel=True),
      device="cpu")
  # two epochs of 6 steps, cut at step 4: three segments
  assert calls["k18"] == 3
  assert calls["k9"] == 2 * ICA_BATCHES.shape[0]


def test_world_of_one_ica_pca_encode():
  mesh = parallel.make_mesh()
  for name, extra in ICA_CASES.items():
    got = ica.train_dictionary_scanned(
        ICA_BATCHES, ICA_D0, _ica_params(data_parallel=mesh, **extra),
        device="cpu")
    single = ica.train_dictionary_scanned(
        ICA_BATCHES, ICA_D0, _ica_params(**extra), device="cpu")
    assert_close(got, single, 1e-6, "ICA %s on a mesh of one" % name)
  assert np.array_equal(
      pca.train_dictionary(PCA_DATA, data_parallel=mesh, device="cpu"),
      pca.train_dictionary(PCA_DATA, device="cpu"))
  wide = PCA_DATA[:16]  # n > D: the single-device branch, as in vtc_tpu
  wide = wide - wide.mean(axis=0)
  assert np.array_equal(
      pca.train_dictionary(wide, data_parallel=mesh, device="cpu"),
      pca.train_dictionary(wide, device="cpu"))
  for name, kw in ENC_CASES.items():
    assert np.array_equal(
        encode_dataset(ENC_X, D0, 0.05, 15, device="cpu", data_parallel=mesh,
                       **kw),
        encode_dataset(ENC_X, D0, 0.05, 15, device="cpu", **kw))


def test_refusals_that_still_hold():
  with pytest.raises(ValueError, match="per-batch ICA trainer"):
    ica.train_dictionary(ICA_BATCHES, ICA_D0,
                         _ica_params(data_parallel=True), device="cpu")
  with pytest.raises(ValueError, match="divide by the DP size"):
    encode_dataset(ENC_X, D0, 0.05, 5, batch_size=15, device="cpu",
                   data_parallel=parallel.Mesh(2, group=object(), index=0))


@pytest.mark.cuda
def test_cuda_dp_trainers_run_the_stats_kernels():
  """On the card a world of 1 runs the whole-segment kernels K15, K16 and
  K18 every step, and not K3, K7 or K9 (the 'dcn' composition)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K15, K16 and K18 have no CPU mode")
  steps = 2 * DATA.shape[0]
  for name, module, segment in (
      ("scanned fc fused", fused_train_step, fused_dp_train),
      ("scanned subspace fused", fused_group_train_step,
       fused_group_dp_train)):
    module.stats_launches = module.launches = segment.launches = 0
    params = dict(TRAIN_CASES[name][1], data_parallel=True)
    params.pop("fc_formulation")  # 'pallas' is the default on the card
    got = compiled_epoch.train_dictionary_scanned(DATA, DATA[:1], D0, params,
                                                  device="cuda")
    assert (segment.launches, module.stats_launches,
            module.launches) == (steps, 0, 0)
    assert_close(got.cpu(), _single(name), 1e-3, "cuda vs cpu")
  fused_ica_train.stats_launches = fused_ica_train.dp_launches = 0
  ica.train_dictionary_scanned(ICA_BATCHES, ICA_D0,
                               _ica_params(data_parallel=True), device="cuda")
  assert fused_ica_train.dp_launches == 2 * ICA_BATCHES.shape[0]
  assert fused_ica_train.stats_launches == 0
