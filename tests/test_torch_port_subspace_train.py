"""The port's subspace (group-sparse) trainer slice against vtc_tpu on the
CPU: the anti-alignment regularizer, the subspace update rules, the K6
wrapper's plain version ``fused_group_train_segment_plain`` against the
Pallas kernel ``fused_group_train_segment_pallas`` in interpret mode, the
subspace raw step, ``train_dictionary`` (with a prune that remaps the
groups), ``train_dictionary_scanned``, ``compute_metrics`` and
``convert``'s grouped train state.

The same seeded numpy inputs go through both packages.  The K6 cases run
at the JAX test's size, draws and tolerance (s 14, n 16, b 10, k 3, atol
3e-5; tests/test_pallas_train_step.py:187-297), the tolerance scaled by
the largest value where that exceeds 1: on these unstructured batches
the codes reach ~10, and the grouped Gram (G*M > n) is singular, so
FISTA grows the frameworks' last-bit differences in the products to
~1e-5 of the codes within 10 iterations.  Trainer trajectories are held
to atol 2e-5, or for the scanned trainer's longer cheap-quadratic runs
to twice the distance vtc_tpu itself moves when its initial dictionary
moves by one ulp, whichever is larger (ROADMAP.md §3).  The CUDA kernels
run only on a card: their tests skip here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtc_tpu.analysis_transforms.fully_connected import (
    subspace_ista_fista as jax_sub)
from vtc_tpu.dict_update_rules.fully_connected import (
    _subspace_common as jax_common)
from vtc_tpu.dict_update_rules.fully_connected import (
    subspace_sc_cheap_quadratic_descent as jax_sub_cqd)
from vtc_tpu.dict_update_rules.fully_connected import (
    subspace_sc_steepest_descent as jax_sub_sd)
from vtc_tpu.ops.pallas_train_step import (fused_group_train_segment_pallas,
                                           group_selection_matrix)
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu.training import reset_prune
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu_torch import convert
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista as sub)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    _subspace_common, subspace_sc_cheap_quadratic_descent,
    subspace_sc_steepest_descent)
from vtc_tpu_torch.ops import fused_group_train_step as fgts
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import reset_prune as port_reset_prune
from vtc_tpu_torch.training import sparse_coding as sc

ATOL = 2e-5
K6_ATOL = 3e-5
NAMES = ("dict", "hessian", "eigvec", "codes")
CHEAP = "subspace_sc_cheap_quadratic_descent"
STEEP = "subspace_sc_steepest_descent"
RAGGED = [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0]]
# the trainers' groups over s = 24: contiguous pairs and overlapping
# ragged triples
TRAIN_GROUPS = ([[i, i + 1] for i in range(0, 12, 2)]
                + [[12, 13, 14], [14, 15], [16, 17, 18, 19], [20, 21, 22, 23],
                   [0, 23]])


def assert_close(got, want, what, atol=ATOL):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _unit_rows(rng, s, n):
  d = rng.randn(s, n).astype(np.float32)
  return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("normalized", [True, False])
def test_alignment_regularization_matches_jax(rng, normalized):
  groups = RAGGED + [[0, 1]]
  d = rng.randn(14, 16).astype(np.float32)
  if normalized:
    d /= np.linalg.norm(d, axis=1, keepdims=True)
  jg, jm = jax_sub.pack_group_indices(groups, 14)
  want = np.asarray(jax_common.alignment_regularization_gradients(
      jnp.asarray(d), jg, jm, normalized))
  gather, mask = sub.pack_group_indices(groups, 14)
  got = _subspace_common.alignment_regularization_gradients(
      torch.from_numpy(d), gather, mask, normalized)
  assert got.shape == (14, 16)
  assert_close(got, want, "alignment gradient normalized=%s" % normalized,
               1e-5)


@pytest.mark.parametrize("penalty", [0.0, 0.4])
@pytest.mark.parametrize("normalize", [True, False])
def test_subspace_update_rules_match_jax(rng, penalty, normalize):
  groups = RAGGED + [[0, 1]]
  d = _unit_rows(rng, 14, 16)
  x = rng.randn(10, 16).astype(np.float32)
  codes = (rng.randn(10, 14) * (rng.rand(10, 14) < 0.4)).astype(np.float32)
  h = (rng.rand(14) * 0.01).astype(np.float32)
  want = np.asarray(jax_sub_sd.run(x, d, codes, groups, penalty, 0.05, 3,
                                   normalize))
  got = subspace_sc_steepest_descent.run(x, d, codes, groups, penalty, 0.05,
                                         3, normalize)
  assert_close(got, want, "subspace steepest penalty=%g normalize=%s"
               % (penalty, normalize))
  want = np.asarray(jax_sub_cqd.run(x, d, codes, groups, h, penalty, 0.002,
                                    2, 0.001, normalize))
  got = subspace_sc_cheap_quadratic_descent.run(
      x, d, codes, groups, h, penalty, 0.002, 2, 0.001, normalize)
  assert_close(got, want, "subspace cheap-quad penalty=%g normalize=%s"
               % (penalty, normalize))


def _k6_problem(rng, groups, s=14, n=16, b=10, k=3):
  """The JAX test's draws, in its order (test_pallas_train_step.py:198)."""
  d = _unit_rows(rng, s, n)
  batches = rng.randn(k, b, n).astype(np.float32)
  h = np.abs(rng.rand(s)).astype(np.float32) * 0.01
  gm = len(groups) * max(len(g) for g in groups)
  v = rng.randn(min(gm, n)).astype(np.float32)
  return d, h, v, batches


K6_CASES = {
    # ragged, overlapping groups; G*M = 20 > n: the n-side power Gram
    "ragged cheap": (RAGGED, {}, {}),
    "ragged steepest": (RAGGED, {"update_alg": STEEP}, {}),
    "penalty cheap": (RAGGED + [[0, 1]], {"alignment_penalty": 0.4}, {}),
    "penalty steepest": (RAGGED + [[0, 1]], {"alignment_penalty": 0.4,
                                             "update_alg": STEEP}, {}),
    # the groups tile range(s) in order: the identity selection, M = 4
    "identity M4 ista": ([list(range(i, i + 4)) for i in range(0, 16, 4)],
                         {"variant": "ista"}, {"s": 16, "n": 24}),
    # ragged with G*M = 20 < n = 24: the grouped Gram's own power side
    "ragged GM<n": (RAGGED, {}, {"n": 24}),
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_plain_segment_matches_pallas(rng, case):
  groups, flags, shape = K6_CASES[case]
  d, h, v, batches = _k6_problem(rng, groups, **shape)
  flags = dict(flags, group_assignments=groups, power_iters=2)
  for k in (1, 3):
    want = fused_group_train_segment_pallas(
        d, h, v, batches[:k], 0.05, 10, 0.1, interpret=True, **flags)
    got = fgts.fused_group_train_segment(
        *map(torch.from_numpy, (d, h, v, batches[:k])), 0.05, 10, 0.1,
        **flags)
    for w, g, name in zip(want, got, NAMES):
      w = np.asarray(w)
      assert g.shape == w.shape and g.dtype == torch.float32
      # codes and the Hessian EMA reach ~10 and ~50 on these unstructured
      # batches, and float32 rounding is relative: the bound scales
      assert_close(g, w, "%s, %d steps: %s" % (case, k, name),
                   K6_ATOL * max(1.0, float(np.abs(w).max())))
  assert fgts.launches == 0  # CPU tensors: the plain version


def test_index_lists_match_the_tpu_matrices():
  groups = RAGGED + [[0, 1]]
  gsel = group_selection_matrix(groups, 14)
  sel = fgts.group_selection_index(groups)
  want = np.where(gsel.any(axis=1), gsel.argmax(axis=1), -1)
  assert np.array_equal(sel, want)
  # the unpack: the codes' sums are grouped_codes @ gsel
  gather, mask = sub.pack_group_indices(groups, 14)
  grouped = np.random.RandomState(1).randn(3, gsel.shape[0]).astype(
      np.float32)
  assert_close(sub.unpack_codes_summed(torch.from_numpy(grouped), gather,
                                       mask, 14), grouped @ gsel,
               "unpack vs grouped @ gsel", 1e-6)
  comem = fgts.comembership_counts(groups, 14)
  assert comem[0, 1] == 2 and comem[1, 0] == 2 and comem[0, 13] == 1
  assert np.trace(comem) == 0


def test_gate():
  groups = [[0, 1], [2, 3]]
  assert fgts.fused_group_segment_supported(
      "subspace_fista", CHEAP, groups, batch_size=250, code_size=4,
      input_size=16)
  assert fgts.fused_group_segment_supported(
      "subspace_ista", STEEP, groups, alignment_penalty=0.5)
  assert not fgts.fused_group_segment_supported(  # unit-norm form only
      "subspace_fista", CHEAP, groups, alignment_penalty=0.5,
      renormalize=False)
  assert not fgts.fused_group_segment_supported(
      "fista", "sc_cheap_quadratic_descent", None)
  assert not fgts.fused_group_segment_supported(  # the one-block refresh
      "subspace_fista", CHEAP, [list(range(40000))], batch_size=8,
      code_size=40000, input_size=40000)


def test_wrapper_refuses_what_it_does_not_run(rng):
  d, h, v, batches = (torch.from_numpy(a)
                      for a in _k6_problem(rng, RAGGED, k=1))
  args = (d, h, v, batches, 0.05, 5, 0.1)
  # the tiers run (tests/test_torch_port_tiers.py); an unknown
  # tier is refused
  full = fgts.fused_group_train_segment(*args, group_assignments=RAGGED)
  tier = fgts.fused_group_train_segment(*args, group_assignments=RAGGED,
                                        mxu="bf16x3")
  assert 0.0 < float((tier[0] - full[0]).abs().max()) < 1e-3
  with pytest.raises(ValueError, match="tier"):
    fgts.fused_group_train_segment(*args, group_assignments=RAGGED,
                                   mxu="tf32x3")
  with pytest.raises(ValueError, match="renormalize"):
    fgts.fused_group_train_segment(*args, group_assignments=RAGGED,
                                   alignment_penalty=0.4, renormalize=False)
  with pytest.raises(ValueError):
    fgts.fused_group_train_segment(*args, group_assignments=RAGGED,
                                   update_alg="sc_cheap_quadratic_descent")
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fgts.fused_group_train_segment(
        *(t.to("meta") for t in (d, h, v, batches)), 0.05, 5, 0.1,
        group_assignments=RAGGED)
  # CPU tensors: the plain version, its stop test included
  full = fgts.fused_group_train_segment(*args, group_assignments=RAGGED,
                                        power_iters=2)
  stopped = fgts.fused_group_train_segment(
      d, h, v, batches, 0.05, 60, 0.1, group_assignments=RAGGED,
      power_iters=2, early_stopping_epsilon=5e-2)
  assert float((full[3] - stopped[3]).abs().max()) > 0
  assert fgts.launches == 0


def _data(rng, k=6, b=10, s=24, n=16):
  """Group-sparse synthesizable batches and a unit-norm initial
  dictionary."""
  basis = rng.randn(8, n)
  w = rng.randn(k * b, 8) * 2.0
  data = (w @ basis + 0.2 * rng.randn(k * b, n)).astype(
      np.float32).reshape(k, b, n)
  return data, _unit_rows(rng, s, n)


def _params(**extra):
  params = {
      "mode": "fully-connected",
      "num_epochs": 2,
      "code_inference_algorithm": "subspace_fista",
      "group_assignments": TRAIN_GROUPS,
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 10},
          7: {"sparsity_weight": 0.04, "num_iters": 20}},
      "dictionary_update_algorithm": CHEAP,
      "dict_update_param_schedule": {
          0: {"stepsize": 0.05, "num_iters": 1},
          9: {"stepsize": 0.02, "num_iters": 2}},
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


@pytest.mark.parametrize("formulation", ["gram", "direct", "pallas"])
@pytest.mark.parametrize("update_alg,penalty", [
    (CHEAP, 0.0), (STEEP, 0.0), (CHEAP, 0.4), (STEEP, 0.4)])
def test_raw_step_matches_jax(rng, formulation, update_alg, penalty):
  data, d0 = _data(rng, k=1)
  h0 = (rng.rand(24) * 0.01).astype(np.float32)
  for inf_alg, in_step in (("subspace_fista", True),
                           ("subspace_ista", False)):
    flags = dict(group_assignments=TRAIN_GROUPS, alignment_penalty=penalty,
                 fc_formulation=formulation,
                 compute_stepsize_in_step=in_step)
    jstep = jax_sc.build_raw_step_fn("fully-connected", inf_alg, update_alg,
                                     **flags)
    step = sc.build_raw_step_fn("fully-connected", inf_alg, update_alg,
                                **flags)
    want = jstep(jnp.asarray(d0), jnp.asarray(h0), jnp.asarray(data[0]),
                 jnp.float32(0.05), jnp.int32(15), jnp.float32(0.02), 2,
                 jnp.float32(0.2))
    got = step(torch.from_numpy(d0), torch.from_numpy(h0),
               torch.from_numpy(data[0]), 0.05, 15, 0.02, 2,
               torch.tensor(0.2))
    for w, g, name in zip(want, got, ("dict", "hessian", "codes")):
      w = np.asarray(w)
      assert g.shape == w.shape
      assert_close(g, w, "%s %s %s penalty=%g %s" % (
          formulation, inf_alg, update_alg, penalty, name),
                   atol=ATOL * max(1.0, float(np.abs(w).max())))


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


def test_train_dictionary_matches_jax(rng, seeded_reset_prune):
  """Schedule changes at 7 and 9, validation metrics at 3, and a prune
  at 5 that removes rows and remaps the groups."""
  data, d0 = _data(rng)
  params = _params(subspace_alignment_penalty=0.2, dict_element_rp_schedule={
      5: {"filter_type": "random", "filter_params": {"num_to_modify": 3},
          "action": "prune"}})
  want = np.asarray(jax_sc.train_dictionary(data, data[:1], d0, params))
  got = sc.train_dictionary(data, data[:1], d0, params, device="cpu")
  assert got.shape == want.shape == (21, 16)
  assert_close(got, want, "subspace train_dictionary with a prune")


def _jax_scanned_and_floor(data, val, d0, params):
  """vtc_tpu's scanned result and the bound the port is held to:
  max(ATOL, 2 x how far vtc_tpu moves for a one-ulp change of d0)."""
  want = np.asarray(jax_ce.train_dictionary_scanned(data, val, d0, params))
  nudged = np.nextafter(d0, np.float32(2)).astype(np.float32)
  moved = np.asarray(jax_ce.train_dictionary_scanned(data, val, nudged,
                                                     params))
  return want, max(ATOL, 2.0 * float(np.abs(moved - want).max()))


@pytest.mark.parametrize("extra", [
    {},  # default: warm power tracking on the grouped Gram, 'gram' here
    {"lipschitz_method": "eigvalsh", "subspace_alignment_penalty": 0.3},
    {"dictionary_update_algorithm": STEEP,
     "code_inference_algorithm": "subspace_ista", "fc_formulation": "pallas"},
])
def test_scanned_matches_jax(rng, extra):
  data, d0 = _data(rng)
  params = _params(**extra)
  want, bound = _jax_scanned_and_floor(data, data[:1], d0, params)
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cpu")
  assert got.dtype == torch.float32
  assert_close(got, want, "scanned %s" % extra, atol=bound)
  assert fgts.launches == 0  # CPU: the per-step runner


def test_scanned_prune_and_metrics_match_jax(rng, tmp_path,
                                             seeded_reset_prune):
  """A prune at 4 (the groups are remapped, the eigenvector re-seeded on
  the new grouped Gram) and validation metrics at 6."""
  data, d0 = _data(rng, k=4)
  params = _params(
      dictionary_update_algorithm=STEEP, training_visualization_schedule={6},
      dict_element_rp_schedule={4: {"filter_type": "random",
                                    "filter_params": {"num_to_modify": 2},
                                    "action": "prune"}})
  want = np.asarray(jax_ce.train_dictionary_scanned(
      data, data[:2], d0, dict(params, logging_folder_fullpath=tmp_path
                               / "jax")))
  got = compiled_epoch.train_dictionary_scanned(
      data, data[:2], d0, dict(params, logging_folder_fullpath=tmp_path
                               / "port"), device="cpu")
  assert got.shape == want.shape == (22, 16)
  assert_close(got, want, "scanned subspace with a prune")
  assert list((tmp_path / "port").glob("events.out.tfevents.*"))


def test_compute_metrics_subspace_matches_jax(rng):
  data, d0 = _data(rng, k=1)
  codes = (rng.randn(10, 24) * (rng.rand(10, 24) < 0.3)).astype(np.float32)
  kw = dict(mode="fully-connected", sparsity_weight=0.05,
            group_assignments=TRAIN_GROUPS, is_subspace=True)
  want = jax_sc.compute_metrics(data[0], codes, d0, d0 + 0.01, **kw)
  got = sc.compute_metrics(torch.from_numpy(data[0]), torch.from_numpy(codes),
                           torch.from_numpy(d0), d0 + 0.01, **kw)
  assert sorted(got) == sorted(want)
  for key in want:
    assert_close(got[key], want[key], key, atol=1e-5 * max(1, abs(want[key])))


@pytest.mark.parametrize("trainer", ["per_batch", "scanned"])
def test_trainers_reject_bad_groups(rng, trainer):
  data, d0 = _data(rng, k=2)
  fn = (sc.train_dictionary if trainer == "per_batch"
        else compiled_epoch.train_dictionary_scanned)
  with pytest.raises(ValueError, match="repeats a member"):
    fn(data, data[:1], d0, _params(group_assignments=[[0, 1, 0]]))
  with pytest.raises(ValueError, match="need group_assignments"):
    fn(data, data[:1], d0, _params(group_assignments=None))


def test_train_state_from_numpy_with_groups(rng):
  d = rng.randn(14, 16).astype(np.float32)
  _, _, v = convert.train_state_from_numpy(d, np.zeros(14), np.ones(16),
                                           "cpu", group_assignments=RAGGED)
  assert v.shape == (16,)  # min(G*M = 20, n = 16)
  groups = [[0, 1], [2, 3]]
  _, _, v = convert.train_state_from_numpy(d, np.zeros(14), np.ones(4),
                                           "cpu", group_assignments=groups)
  assert v.shape == (4,)
  with pytest.raises(ValueError, match="eigvec"):
    convert.train_state_from_numpy(d, np.zeros(14), np.ones(14), "cpu",
                                   group_assignments=groups)


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the fused group train kernels have no "
                "CPU mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_early_stop_raises(rng):
  # K6 stops each step's group solve on the card and matches its plain
  # version; the scanned trainer takes it; a data-parallel run takes K16
  # with the stop and lands on the same dictionary
  dev = _cuda_device()
  arrays = _k6_problem(rng, RAGGED, k=2)
  flags = dict(group_assignments=RAGGED, early_stopping_epsilon=1e-3,
               power_iters=2)
  before = fgts.launches
  got = fgts.fused_group_train_segment(
      *(torch.from_numpy(a).to(dev) for a in arrays), 0.05, 20, 0.1,
      **flags)
  assert fgts.launches == before + 2
  want = fgts.fused_group_train_segment(
      *(torch.from_numpy(a) for a in arrays), 0.05, 20, 0.1, **flags)
  for g, w, what in zip(got, want, ("dictionary", "hessian", "eigvec",
                                    "codes")):
    assert_close(g.cpu(), w, "K6 early stop " + what, atol=1e-4)
  data, d0 = _data(rng, k=2)
  params = _params(early_stopping_epsilon=1e-3)
  before = fgts.launches
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cuda")
  assert fgts.launches == before + 4
  want = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                 device="cpu")
  assert_close(got.cpu(), want, "scanned early stop vs cpu", atol=1e-3)
  from vtc_tpu_torch.ops import fused_group_dp_train
  before = fused_group_dp_train.launches
  dp = compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, dict(params, data_parallel=True), device="cuda")
  assert fused_group_dp_train.launches == before + 4
  assert_close(dp.cpu(), got.cpu(), "K16 with the stop vs K6 with it",
               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_cuda_kernels_match_plain(rng, case):
  """The kernels against their plain version on the card, one step
  (chip_smoke.py runs the flagship width)."""
  dev = _cuda_device()
  groups, flags, shape = K6_CASES[case]
  args = [torch.from_numpy(a).to(dev)
          for a in _k6_problem(rng, groups, k=1, **shape)]
  flags = dict(flags, group_assignments=groups, power_iters=2)
  before = fgts.launches
  got = fgts.fused_group_train_segment(*args, 0.05, 10, 0.1, **flags)
  assert fgts.launches == before + 1
  want = fgts.fused_group_train_segment_plain(*args, 0.05, 10, 0.1, **flags)
  for g, w, name in zip(got, want, NAMES):
    assert_close(g.cpu(), w.cpu(), "cuda %s %s" % (case, name), K6_ATOL)


@pytest.mark.cuda
def test_cuda_scanned_runs_the_fused_group_kernels(rng):
  dev = _cuda_device()
  data, d0 = _data(rng)
  params = _params()
  fgts.launches = 0
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device=dev)
  assert fgts.launches == 12
  want = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                 device="cpu")
  assert_close(got.cpu(), want, "cuda scanned vs cpu", atol=1e-3)
