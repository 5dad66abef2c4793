"""The port's fc trainer slice against vtc_tpu on the CPU:
``build_raw_step_fn``, ``train_dictionary`` (schedules, checkpoints,
resume from the train-state sidecar, reset/prune),
``train_dictionary_scanned``, ``compute_metrics``, ``SparseCoder.fit``,
``BatchIterator`` and ``convert``'s trainer state.

The same seeded numpy inputs go through both packages, at s = 24,
n = 16, b = 10.  Tolerance: atol 2e-5 on dictionaries after a dozen
steps, the JAX package's own bound for two trainers on one trajectory
(tests/test_compiled_epoch.py); the Hessian EMA gets 1e-3 where FISTA
with the cheap-quadratic update amplifies rounding into threshold flips,
as in tests/test_pallas_train_step.py.  The scanned trainer's longer
cheap-quadratic runs are held to 2e-5 or to twice the distance vtc_tpu
itself moves when its initial dictionary moves by one ulp, whichever is
larger: that distance, measured in the test, is the trajectory's own
rounding floor (8e-5 to 2.2e-4 on these inputs).  Reset/prune draws from numpy's
generator: both trainers get the same seeded one.  Shuffling draws from
a torch.Generator in the port and from jax.random in vtc_tpu (ROADMAP.md
§3), so trajectories run unshuffled and shuffling is tested by its
property.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtc_tpu import api as jax_api
from vtc_tpu.data.dataset_generation import BatchIterator as JaxBatches
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu.training import reset_prune
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu.utils import checkpoint as ckpt_util
from vtc_tpu_torch import convert
from vtc_tpu_torch.api import SparseCoder
from vtc_tpu_torch.data.dataset_generation import BatchIterator
from vtc_tpu_torch.ops import fused_fista, fused_train_step
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import reset_prune as port_reset_prune
from vtc_tpu_torch.training import sparse_coding as sc

ATOL = 2e-5


def assert_close(got, want, what, atol=ATOL):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _data(rng, k=6, b=10, s=24, n=16):
  """Sparse-synthesizable batches (pure noise at these stepsizes diverges
  on every backend) and a unit-norm initial dictionary."""
  basis = rng.randn(8, n)
  w = rng.randn(k * b, 8) * 2.0
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
          0: {"sparsity_weight": 0.05, "num_iters": 10},
          7: {"sparsity_weight": 0.04, "num_iters": 20}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": 0.05, "num_iters": 1},
          9: {"stepsize": 0.02, "num_iters": 2}},
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


def _jax_scanned_and_floor(data, val, d0, params):
  """vtc_tpu's scanned result and the bound the port is held to:
  max(ATOL, 2 x how far vtc_tpu moves for a one-ulp change of d0)."""
  want = np.asarray(jax_ce.train_dictionary_scanned(data, val, d0, params))
  nudged = np.nextafter(d0, np.float32(2)).astype(np.float32)
  moved = np.asarray(jax_ce.train_dictionary_scanned(data, val, nudged,
                                                     params))
  return want, max(ATOL, 2.0 * float(np.abs(moved - want).max()))


@pytest.fixture
def seeded_reset_prune(monkeypatch):
  """Each trainer calls its own package's reset_prune module (the port's
  is a copy of vtc_tpu's); give every call the same seeded generator."""
  for module in (reset_prune, port_reset_prune):
    original = module.reset_or_prune_dict_elements

    def seeded(*args, _original=original, **kwargs):
      kwargs.setdefault("rng", np.random.default_rng(7))
      return _original(*args, **kwargs)

    monkeypatch.setattr(module, "reset_or_prune_dict_elements", seeded)


@pytest.mark.parametrize("formulation", ["gram", "direct", "pallas"])
@pytest.mark.parametrize("update_alg", ["sc_cheap_quadratic_descent",
                                        "sc_steepest_descent"])
@pytest.mark.parametrize("in_step", [True, False])
def test_raw_step_matches_jax(rng, formulation, update_alg, in_step):
  data, d0 = _data(rng, k=1)
  h0 = (rng.rand(24) * 0.01).astype(np.float32)
  flags = dict(fc_formulation=formulation, compute_stepsize_in_step=in_step)
  jstep = jax_sc.build_raw_step_fn("fully-connected", "fista", update_alg,
                                   **flags)
  step = sc.build_raw_step_fn("fully-connected", "fista", update_alg,
                              **flags)
  eta = np.float32(0.2)
  want = jstep(jnp.asarray(d0), jnp.asarray(h0), jnp.asarray(data[0]),
               jnp.float32(0.05), jnp.int32(15), jnp.float32(0.05), 2,
               jnp.float32(eta))
  got = step(torch.from_numpy(d0), torch.from_numpy(h0),
             torch.from_numpy(data[0]), 0.05, 15, 0.05, 2,
             torch.tensor(eta))
  for w, g, name in zip(want, got, ("dict", "hessian", "codes")):
    # codes reach ~10 on these batches: the bound scales with them
    w = np.asarray(w)
    assert_close(g, w, "%s %s in_step=%s %s" % (
        formulation, update_alg, in_step, name),
                 atol=ATOL * max(1.0, float(np.abs(w).max())))


def test_train_dictionary_matches_jax(rng, tmp_path, seeded_reset_prune):
  """A schedule change at 7 and 9, checkpoints at 4 and 8, a reset at 5,
  then a resume from each trainer's sidecar, against vtc_tpu."""
  data, d0 = _data(rng)
  params = _params(dict_element_rp_schedule={
      5: {"filter_type": "random", "filter_params": {"num_to_modify": 2},
          "action": "reset"}}, checkpoint_schedule={4, 8})
  jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
  want = np.asarray(jax_sc.train_dictionary(
      data, data[:1], d0, dict(params, logging_folder_fullpath=jax_dir)))
  got = sc.train_dictionary(data, data[:1], d0,
                            dict(params, logging_folder_fullpath=port_dir),
                            device="cpu")
  assert got.dtype == torch.float32 and got.shape == d0.shape
  assert_close(got, want, "train_dictionary")
  for it in (4, 8):
    name = "checkpoint_dictionary_iter_%d" % it
    assert_close(ckpt_util.load_dictionary_checkpoint(port_dir / name),
                 ckpt_util.load_dictionary_checkpoint(jax_dir / name),
                 "checkpoint %d" % it)
    jstate = ckpt_util.load_trainstate_sidecar(jax_dir, it)
    pstate = ckpt_util.load_trainstate_sidecar(port_dir, it)
    assert int(pstate["train_iteration"]) == it
    assert_close(pstate["hessian_diagonal"], jstate["hessian_diagonal"],
                 "sidecar hessian %d" % it, atol=1e-3)
  assert (port_dir / "training_params.yaml").exists()

  # resume from the newest checkpoint (8) for one more epoch: the port
  # from the checkpoint the JAX trainer wrote, and from its own
  resume = dict(params, num_epochs=1, checkpoint_schedule=None,
                dict_element_rp_schedule=None)
  jd, jstate, it = ckpt_util.resume_training_state(jax_dir)
  assert it == 8
  want = np.asarray(jax_sc.train_dictionary(
      data, data[:1], jd, dict(resume, resume_state=jstate)))
  for folder in (jax_dir, port_dir):
    d, state, it = convert.load_train_state(folder, "cpu")
    assert it == 8 and state["train_iteration"] == 8
    got = sc.train_dictionary(data, data[:1], d,
                              dict(resume, resume_state=state),
                              device="cpu")
    assert_close(got, want, "resume from %s" % folder.name, atol=1e-4)


def test_train_dictionary_prune_and_stepsize_interval(rng,
                                                      seeded_reset_prune):
  data, d0 = _data(rng, k=4)
  params = _params(num_epochs=1, stepsize_update_interval=2,
                   lipschitz_method="power", dict_element_rp_schedule={
                       2: {"filter_type": "random",
                           "filter_params": {"num_to_modify": 3},
                           "action": "prune"}})
  want = np.asarray(jax_sc.train_dictionary(data, data[:1], d0, params))
  got = sc.train_dictionary(data, data[:1], d0, params, device="cpu")
  assert got.shape == (21, 16)
  # the power stepsize starts from another vector in each framework
  # (ROADMAP.md §3): both converge to the top eigenvalue only to ~1e-3
  assert_close(got, want, "pruned, power stepsize every 2 steps", atol=1e-3)


@pytest.mark.parametrize("extra", [
    {},  # default: warm power tracking, 'gram' on the CPU
    {"lipschitz_method": "eigvalsh"},
    {"dictionary_update_algorithm": "sc_steepest_descent",
     "code_inference_algorithm": "ista"},
    {"fc_formulation": "pallas", "nonnegative_only": True},
])
def test_scanned_matches_jax(rng, extra):
  data, d0 = _data(rng)
  params = _params(**extra)
  want, bound = _jax_scanned_and_floor(data, data[:1], d0, params)
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cpu")
  assert got.dtype == torch.float32
  assert_close(got, want, "scanned %s" % extra, atol=bound)
  assert fused_train_step.launches == 0  # CPU: the per-step runner


def test_scanned_events_match_jax(rng, tmp_path, seeded_reset_prune):
  """Checkpoints, a reset (the warm eigenvector is re-seeded after it)
  and validation metrics at segment boundaries."""
  data, d0 = _data(rng, k=4)
  params = _params(
      num_epochs=2, checkpoint_schedule={3, 7},
      training_visualization_schedule={6},
      dict_element_rp_schedule={5: {"filter_type": "random",
                                    "filter_params": {"num_to_modify": 2},
                                    "action": "reset"}})
  runs = {}
  for name, start in (("jax", d0),
                      ("nudged", np.nextafter(d0, np.float32(2)))):
    runs[name] = np.asarray(jax_ce.train_dictionary_scanned(
        data, data[:2], start.astype(np.float32),
        dict(params, logging_folder_fullpath=tmp_path / name)))
  got = compiled_epoch.train_dictionary_scanned(
      data, data[:2], d0, dict(params, logging_folder_fullpath=tmp_path
                               / "port"), device="cpu")

  def floor(jax_value, nudged_value):
    return max(ATOL, 2.0 * float(np.abs(nudged_value - jax_value).max()))

  assert_close(got, runs["jax"], "scanned with events",
               atol=floor(runs["jax"], runs["nudged"]))
  for it in (3, 7):
    name = "checkpoint_dictionary_iter_%d" % it
    jax_ckpt, nudged_ckpt, port_ckpt = (
        ckpt_util.load_dictionary_checkpoint(tmp_path / run / name)
        for run in ("jax", "nudged", "port"))
    assert_close(port_ckpt, jax_ckpt, "scanned checkpoint %d" % it,
                 atol=floor(jax_ckpt, nudged_ckpt))
  assert list((tmp_path / "port").glob("events.out.tfevents.*"))


def test_scanned_shuffling_changes_order_not_quality(rng):
  data, d0 = _data(rng, k=4)
  base = _params(num_epochs=3, dictionary_update_algorithm=(
      "sc_steepest_descent"))
  cpu = dict(device="cpu")
  plain = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, base,
                                                  **cpu)
  shuffled = compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, dict(base, shuffle_each_epoch=True), **cpu)
  again = compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, dict(base, shuffle_each_epoch=True), **cpu)
  other = compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, dict(base, shuffle_each_epoch=True,
                               shuffle_seed=1), **cpu)
  assert not torch.allclose(plain, shuffled)  # the order changed
  assert torch.equal(shuffled, again)         # ... reproducibly
  assert not torch.allclose(shuffled, other)  # ... by the seed
  np.testing.assert_allclose(
      torch.linalg.vector_norm(shuffled, dim=1).numpy(), 1.0, atol=1e-4)


def test_compute_metrics_matches_jax(rng):
  data, d0 = _data(rng, k=1)
  codes = (rng.randn(10, 24) * (rng.rand(10, 24) < 0.3)).astype(np.float32)
  prev = d0 + 0.01
  want = jax_sc.compute_metrics(data[0], codes, d0, prev,
                                mode="fully-connected", sparsity_weight=0.05)
  got = sc.compute_metrics(torch.from_numpy(data[0]), torch.from_numpy(codes),
                           torch.from_numpy(d0), prev,
                           mode="fully-connected", sparsity_weight=0.05)
  assert sorted(got) == sorted(want)
  for key in want:
    assert_close(got[key], want[key], key, atol=1e-5 * max(1, abs(want[key])))


def test_sparse_coder_fit_matches_jax(rng):
  basis = rng.randn(8, 16)
  x = (rng.randn(300, 8) @ basis + 0.1 * rng.randn(300, 16)).astype(
      np.float32)
  kw = dict(sparsity_weight=0.05, inference_iters=10, update_stepsize=0.05)
  want = jax_api.SparseCoder(24, **kw).fit(x, num_epochs=2, batch_size=50)
  before = fused_fista.launches
  got = SparseCoder(24, formulation="pallas", device="cpu", **kw).fit(
      x, num_epochs=2, batch_size=50)
  assert fused_fista.launches == before  # CPU: the plain version
  assert isinstance(got.dictionary, torch.Tensor)
  assert_close(got.dictionary, np.asarray(want.dictionary), "fit")
  codes = got.encode(x[:20])
  assert codes.shape == (20, 24) and bool(torch.isfinite(codes).all())


def test_batch_iterator_matches_vtc_tpu():
  samples = np.arange(70 * 3, dtype=np.float32).reshape(70, 3)
  for kw in ({}, {"shuffle": False, "drop_last": False}):
    mine, theirs = BatchIterator(samples, 16, seed=3, **kw), JaxBatches(
        samples, 16, seed=3, **kw)
    assert len(mine) == len(theirs)
    for _ in range(2):  # reshuffles per epoch, identically
      for a, b in zip(mine, theirs, strict=True):
        assert np.array_equal(a, b)


def test_train_state_from_numpy(rng):
  d = rng.randn(24, 16).astype(np.float32)
  d_t, h_t, v_t = convert.train_state_from_numpy(d, np.zeros(24),
                                                 np.ones(16), "cpu")
  assert (d_t.dtype, h_t.shape, v_t.shape) == (torch.float32, (24,), (16,))
  with pytest.raises(ValueError, match="eigvec"):
    convert.train_state_from_numpy(d, np.zeros(24), np.ones(24), "cpu")


# a subspace configuration: the refusals hold for it too
_SUBSPACE = {"code_inference_algorithm": "subspace_fista",
             "dictionary_update_algorithm":
                 "subspace_sc_cheap_quadratic_descent",
             "group_assignments": [[i, i + 1] for i in range(0, 24, 2)]}


@pytest.mark.parametrize("trainer,change,item", [
    (trainer, change, item)
    for trainer in ("per_batch", "scanned")
    for change, item in (({"mode": "convolutional"}, "item 7"),
                         ({"data_parallel": True}, "item 9"),
                         (dict(_SUBSPACE, data_parallel=True), "item 9"))
] + [
    ("per_batch", {"profile_dir": "trace"}, "item 8"),
    ("per_batch", dict(_SUBSPACE, profile_dir="trace"), "item 8"),
    ("scanned", {"hbm_chunk_steps": 2}, "item 8"),
    # the tiers run in every family, data-parallel or not: item 3a.2.2 is
    # the conv tiers' (tests/test_torch_port_tiers.py,
    # tests/test_torch_port_dp_tiers.py, tests/test_torch_port_conv_tiers.py)
    ("scanned", {"mode": "convolutional", "data_parallel": True,
                 "train_precision": "bf16x3"}, "item 3a.2.2"),
    ("scanned", {"mode": "convolutional", "train_precision": "bf16x3"},
     "item 3a.2.2"),
])
def test_trainers_refuse_what_waits(rng, trainer, change, item):
  data, d0 = _data(rng, k=2)
  fn = (sc.train_dictionary if trainer == "per_batch"
        else compiled_epoch.train_dictionary_scanned)
  if change.get("mode") == "convolutional":
    # conv images and kernels: item 7 is done and both conv trainers run
    # (held to vtc_tpu in tests/test_torch_port_conv_train.py and
    # tests/test_torch_port_conv_scanned.py)
    data = rng.randn(2, 3, 1, 12, 12).astype(np.float32)
    d0 = rng.randn(6, 1, 4, 4).astype(np.float32)
    d0 /= np.sqrt((d0 ** 2).sum(axis=(1, 2, 3), keepdims=True))
    change = dict(change, strides=(2, 2), padding=((2, 2), (2, 2)))
    if "train_precision" in change:
      # the conv tiers run: K12 (K17 with data_parallel) at the tier, their
      # plain versions on the CPU, near the 'highest' run and not on it
      got = fn(data, data[:1], d0, _params(**change), device="cpu")
      full = dict(change)
      del full["train_precision"]
      want = fn(data, data[:1], d0, _params(**full), device="cpu")
      assert bool(torch.isfinite(got).all())
      assert 0.0 < float((got - want).abs().max()) < 1e-3
      return
    got = fn(data, data[:1], d0, _params(**change), device="cpu")
    assert got.shape == d0.shape and bool(torch.isfinite(got).all())
    # ... and so does conv with data_parallel: True without a process group
    # is a mesh of one rank, the single-device trainer's numbers (worlds of
    # 2 and 4 in tests/test_torch_port_conv_parallel.py)
    change = dict(change, lipschitz_method="eigvalsh")
    want = fn(data, data[:1], d0, _params(**change), device="cpu")
    got = fn(data, data[:1], d0, _params(data_parallel=True, **change),
             device="cpu")
    assert_close(got, want, "conv data_parallel=True on one rank")
    return
  if change.get("data_parallel") and "train_precision" not in change:
    # item 9's layer is done for fc and subspace: True without a process
    # group is a mesh of one rank (tests/test_torch_port_parallel_train.py
    # holds worlds of 2 and 4 to vtc_tpu), and lands on the single-device
    # trainer with the same stepsize rule
    change = dict(change, lipschitz_method="eigvalsh")
    got = fn(data, data[:1], d0, _params(**change), device="cpu")
    single = dict(change)
    del single["data_parallel"]
    want = fn(data, data[:1], d0, _params(**single), device="cpu")
    assert_close(got, want, "data_parallel=True on one rank")
    assert float((got - torch.from_numpy(d0)).abs().max()) > 1e-3
    return
  with pytest.raises(NotImplementedError, match=item):
    fn(data, data[:1], d0, _params(**change), device="cpu")


@pytest.mark.cuda
def test_cuda_scanned_early_stop_raises(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the fused train kernels have no CPU "
                "mode")
  # K2 stops each step's solve on the card and matches the plain run; a
  # data-parallel run takes K15 with the stop and lands on the same
  # dictionary
  data, d0 = _data(rng, k=2)
  params = _params(early_stopping_epsilon=1e-3)
  fused_train_step.launches = 0
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cuda")
  assert fused_train_step.launches == 2
  want = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                 device="cpu")
  assert_close(got.cpu(), want, "cuda scanned early stop vs cpu", atol=1e-3)
  from vtc_tpu_torch.ops import fused_dp_train
  before = fused_dp_train.launches
  dp = compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, dict(params, data_parallel=True), device="cuda")
  assert fused_dp_train.launches == before + 2
  assert_close(dp.cpu(), got.cpu(), "K15 with the stop vs K2 with it",
               atol=1e-4)
  # the raw step's K1 solve stops on the card too
  step = sc.build_raw_step_fn(
      "fully-connected", "fista", "sc_steepest_descent",
      fc_formulation="pallas", early_stopping_epsilon=1e-3)
  args = (torch.from_numpy(d0), torch.zeros(24),
          torch.from_numpy(data[0]))
  fused_fista.launches = 0
  got = step(*(a.cuda() for a in args), 0.05, 10, 0.05, 1, None)
  assert fused_fista.launches == 1
  want = step(*args, 0.05, 10, 0.05, 1, None)
  for g, w, what in zip(got, want, ("dictionary", "hessian", "codes")):
    assert_close(g.cpu(), w, "raw step early stop " + what, atol=1e-4)


@pytest.mark.cuda
def test_cuda_scanned_runs_the_fused_kernels(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the fused train kernels have no CPU "
                "mode")
  data, d0 = _data(rng)
  params = _params()
  fused_train_step.launches = 0
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cuda")
  assert fused_train_step.launches == 12
  want = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                 device="cpu")
  assert_close(got.cpu(), want, "cuda scanned vs cpu", atol=1e-3)


def test_raw_step_takes_any_dictionary_size(rng):
  """The raw step holds no shape: a pruned dictionary needs no rebuild."""
  data, d0 = _data(rng, k=1)
  step = functools.partial(
      sc.build_raw_step_fn("fully-connected", "fista",
                           "sc_steepest_descent"), sparsity_weight=0.05,
      inf_num_iters=5, upd_stepsize=0.05, upd_num_iters=1, inf_stepsize=None)
  for s in (24, 20):
    d = torch.from_numpy(d0[:s].copy())
    new, _, codes = step(d, torch.zeros(s), torch.from_numpy(data[0]))
    assert new.shape == (s, 16) and codes.shape == (10, s)
