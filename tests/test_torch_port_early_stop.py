"""The early stop of the fc/subspace solve and of the single-device
trainers (K1, K4, K2, K6) against vtc_tpu on the CPU.

vtc_tpu runs the batch-global stop test (after iteration k > 0, stop when
mean |codes_k - codes_{k-1}| / stepsize < eps) inside its kernels where
the batch fits one VMEM tile (``early_stop_tile_fits``,
``fused_segment_supported``) and in the XLA loop otherwise.  The port's
kernels take it at every batch (csrc/fista_core.cuh, "The early stop");
CPU tensors run their plain versions, whose loop is ``ops/solver``'s.
Here the same seeded numpy inputs go through both packages:

* K1 and K4's plain versions against ``fista_solve_pallas`` and
  ``group_fista_solve_pallas`` with the stop, in interpret mode: fista and
  ista, soft, nonneg and hard, a warm start, M in {1, 2, 4} and ragged
  groups, and three eps each: one that stops at k = 1, one mid-run and one
  that never stops (0), picked from a float64 numpy run of the same
  iteration so that the stop is at least 2% clear of eps; the plain
  loop's stop iteration must be that run's;
* ``ista_fista.run`` and ``subspace_ista_fista.run`` with 'pallas' at a
  batch inside vtc_tpu's one-tile gate (its kernel) and one beyond it (its
  XLA loop);
* the K2 and K6 segments (3 steps) against ``fused_train_segment_pallas``
  and ``fused_group_train_segment_pallas``, with each step's stop count;
* ``train_dictionary_scanned`` and ``train_dictionary`` with
  ``fc_formulation='pallas'`` and a stop, inside and beyond the gate;
* the Python mirror of the stop's route and device array
  (``fused_fista.stop_route``, ``stop_words``), pinned at the H100's
  numbers and against the header's constants.

Tolerances: 2e-5 between the solves' plain versions and vtc_tpu's
kernels (the port's kernel tests use 1e-5 to 2e-5 between two float32
solves); the repo's 1e-4 contract, scaled by the largest value, for the
segments (40 iterations a step with the cheap-quadratic update amplify
rounding past the 3e-5 that tests/test_torch_port_subspace_train.py uses
at 10); and the trainers' floor of tests/test_torch_port_trainer.py: 2e-5
or twice how far vtc_tpu moves for a one-ulp change of the initial
dictionary.  The kernels themselves run only on a card: chip_smoke.py
phase 43.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vtc_tpu.analysis_transforms.fully_connected import (
    ista_fista as jax_fc)
from vtc_tpu.analysis_transforms.fully_connected import (
    subspace_ista_fista as jax_sub)
from vtc_tpu.ops.pallas_fista import early_stop_tile_fits, fista_solve_pallas
from vtc_tpu.ops.pallas_group_fista import (group_early_stop_tile_fits,
                                            group_fista_solve_pallas,
                                            membership_matrix)
from vtc_tpu.ops.pallas_train_step import (fused_group_train_segment_pallas,
                                           fused_segment_supported,
                                           fused_train_segment_pallas)
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista as sub)
from vtc_tpu_torch.ops import fused_fista as K1
from vtc_tpu_torch.ops import fused_group_fista as K4
from vtc_tpu_torch.ops import fused_group_train_step as K6
from vtc_tpu_torch.ops import fused_train_step as K2
from vtc_tpu_torch.ops import solver
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import sparse_coding as sc

KERNEL_ATOL = 2e-5
SEGMENT_ATOL = 1e-4
ATOL = 2e-5
LAM = 0.1
ITERS = 40
HEADER = (pathlib.Path(__file__).resolve().parent.parent / "vtc_tpu_torch"
          / "csrc" / "fista_core.cuh")
H100_SMS, H100_CLUSTER_SLOTS, H100_PAIR_SLOTS = 132, 15, 66


def assert_close(got, want, what, atol):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _problem(rng, b=24, s=32, n=24):
  """Sparse mixtures of a unit-norm dictionary, so the solves converge
  and the stop tests have a trajectory to cut."""
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  codes = (rng.rand(b, s) < 0.15) * rng.randn(b, s)
  x = codes @ d + 0.05 * rng.randn(b, n)
  return x.astype(np.float32), d.astype(np.float32)


def _stepsize(d):
  return np.float32(1.0 / np.linalg.eigvalsh(
      d.astype(np.float64) @ d.T.astype(np.float64))[-1])


def _shrink(x, t, nonneg, hard):
  if hard:
    return np.where((x if nonneg else np.abs(x)) < t, 0.0, x)
  if nonneg:
    return np.maximum(x - t, 0.0)
  return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)


def _group_shrink(x, m, t, hard):
  g = x.reshape(x.shape[0], -1, m)
  norms = np.linalg.norm(g, axis=2, keepdims=True)
  if hard:
    return np.where(norms < t, 0.0, g).reshape(x.shape)
  scale = np.maximum(1.0 - t / np.where(norms == 0, 1.0, norms), 0.0)
  return (g * scale).reshape(x.shape)


def _trajectory(x, d, eta, prox, variant, init=None, iters=ITERS):
  """mean |codes_k - codes_{k-1}| / eta for every iteration k of a float64
  numpy run of the solve (the index is k)."""
  x, d, eta = (np.asarray(a, np.float64) for a in (x, d, eta))
  gram, corr = d @ d.T, x @ d.T
  z = old = (np.zeros((x.shape[0], d.shape[0])) if init is None
             else np.asarray(init, np.float64))
  t_k, avgs = 1.0, []
  for _ in range(iters):
    codes = prox(z - eta * (z @ gram - corr), LAM * eta)
    avgs.append(np.abs(codes - old).mean() / eta)
    if variant == "fista":
      t_next = (1.0 + np.sqrt(1.0 + 4.0 * t_k * t_k)) / 2.0
      z = codes + ((t_k - 1.0) / t_next) * (codes - old)
      t_k = t_next
    else:
      z = codes
    old = codes
  return avgs


def _eps_and_count(avgs, which):
  """(eps, the iterations a solve with it runs): 'early' stops at k = 1,
  'mid' at the first new low past the first quarter that is 5% under
  every earlier one (eps between the two), 'never' is 0."""
  if which == "never":
    return 0.0, len(avgs)
  if which == "early":
    return 1.5 * avgs[1], 2
  for k in range(len(avgs) // 4, len(avgs)):
    low = min(avgs[1:k])
    if avgs[k] < 0.95 * low:
      return float(np.sqrt(avgs[k] * low)), k + 1
  raise AssertionError("no clear stop past the middle of the trajectory")


def _counted(monkeypatch):
  """The iterations of every plain loop the port runs from now on."""
  counts = []
  real = solver.proximal_gradient_loop

  def loop(*args, **kwargs):
    out = real(*args, **kwargs)
    counts.append(solver.last_iters)
    return out

  for module in (K1, K4):
    monkeypatch.setattr(module, "proximal_gradient_loop", loop)
  return counts


K1_CASES = [
    # (variant, nonneg, hard, warm, eps)
    ("fista", False, False, False, "early"),
    ("fista", False, False, False, "mid"),
    ("fista", False, False, False, "never"),
    ("ista", False, False, False, "mid"),
    ("fista", True, False, False, "mid"),
    ("fista", False, True, False, "mid"),
    ("ista", True, True, True, "mid"),
    ("fista", False, False, True, "early"),
]


@pytest.mark.parametrize("variant,nonneg,hard,warm,which", K1_CASES)
def test_k1_stop_matches_pallas(rng, monkeypatch, variant, nonneg, hard,
                                warm, which):
  x, d = _problem(rng)
  eta = _stepsize(d)
  init = None
  if warm:
    init = K1.fused_fista_plain(torch.from_numpy(x), torch.from_numpy(d),
                                LAM, 3, eta, variant=variant, nonneg=nonneg,
                                hard=hard).numpy()
  avgs = _trajectory(x, d, eta, lambda v, t: _shrink(v, t, nonneg, hard),
                     variant, init)
  eps, count = _eps_and_count(avgs, which)
  assert early_stop_tile_fits(*x.shape[:1], d.shape[0])
  flags = dict(variant=variant, nonneg=nonneg, hard=hard)
  want = np.asarray(fista_solve_pallas(
      x, d, LAM, ITERS, eta, initial_codes=init, interpret=True,
      early_stopping_epsilon=eps, **flags))
  counts = _counted(monkeypatch)
  got = K1.fused_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), LAM, ITERS,
      torch.tensor(eta), early_stopping_epsilon=eps,
      initial_codes=None if init is None else torch.from_numpy(init),
      **flags).numpy()
  assert counts == [count], (counts, count)
  assert np.abs(want).max() > 0
  assert_close(got, want, "K1 %s eps %s (%g, %d it)" % (
      flags, which, eps, count), KERNEL_ATOL)


def _grouped(d, groups):
  gather, mask = sub.pack_group_indices(groups, d.shape[0])
  gd = sub.build_grouped_dictionary(torch.from_numpy(d), gather, mask)
  return gd, gather.shape, mask.numpy()


K4_CASES = [
    # (M or 'ragged', variant, hard, warm, eps)
    (1, "fista", False, False, "mid"),
    (2, "fista", True, False, "mid"),
    (4, "fista", False, False, "early"),
    (4, "fista", False, False, "mid"),
    (4, "fista", False, False, "never"),
    (4, "ista", False, True, "mid"),
    (4, "fista", True, True, "mid"),
    ("ragged", "fista", False, False, "mid"),
]
RAGGED = [[0, 1, 2, 3, 4], [5, 6], [7, 8, 9, 10, 11, 12, 13], [14],
          [15, 16, 17, 18, 19, 20, 21, 22, 23], [24, 25, 26, 27, 28, 29],
          [30, 31], [2, 9, 30]]


@pytest.mark.parametrize("m,variant,hard,warm,which", K4_CASES)
def test_k4_stop_matches_pallas(rng, monkeypatch, m, variant, hard, warm,
                                which):
  x, d = _problem(rng)
  if m == "ragged":
    groups = RAGGED
  else:
    groups = [list(range(i, i + m)) for i in range(0, 32, m)]
  gd, (g, width), mask = _grouped(d, groups)
  eta = _stepsize(gd.numpy())
  init = None
  if warm:
    init = K4.fused_group_fista_plain(torch.from_numpy(x), gd, width, LAM, 3,
                                      eta, variant=variant, hard=hard)
  avgs = _trajectory(x, gd.numpy(), eta,
                     lambda v, t: _group_shrink(v, width, t, hard), variant,
                     None if init is None else init.numpy())
  eps, count = _eps_and_count(avgs, which)
  assert group_early_stop_tile_fits(x.shape[0], g * width, g)
  want = np.asarray(group_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(gd.numpy()),
      membership_matrix(g, width, mask), jnp.float32(LAM), jnp.int32(ITERS),
      jnp.float32(eta), interpret=True, variant=variant, hard=hard,
      initial_grouped=None if init is None else jnp.asarray(init.numpy()),
      early_stopping_epsilon=eps))
  counts = _counted(monkeypatch)
  got = K4.fused_group_fista_solve(
      torch.from_numpy(x), gd, width, LAM, ITERS, torch.tensor(eta),
      initial_grouped=init, variant=variant, hard=hard,
      early_stopping_epsilon=eps).numpy()
  assert counts == [count], (counts, count)
  assert np.abs(want).max() > 0
  assert_close(got, want, "K4 M %s %s hard %s eps %s (%g, %d it)" % (
      m, variant, hard, which, eps, count), KERNEL_ATOL)


@pytest.mark.parametrize("b", [24, 4200])
def test_solvers_stop_as_vtc_tpu_inside_and_beyond_its_tile(rng, b):
  """run(formulation='pallas') with a stop: vtc_tpu's kernel at b 24, its
  XLA loop at b 4200 (past early_stop_tile_fits); the port's plain
  version, the kernels' stand-in here, at both."""
  x, d = _problem(rng, b=b)
  eta = _stepsize(d)
  fits = early_stop_tile_fits(b, d.shape[0])
  assert fits == (b == 24)
  eps = _eps_and_count(_trajectory(
      x, d, eta, lambda v, t: _shrink(v, t, False, False), "fista"),
      "mid")[0]
  want = np.asarray(jax_fc.run(x, d, LAM, ITERS, formulation="pallas",
                               early_stopping_epsilon=eps, stepsize=eta))
  got = ista_fista.run(x, d, LAM, ITERS, formulation="pallas",
                       early_stopping_epsilon=eps, stepsize=eta)
  assert_close(got, want, "fc run b %d (vtc_tpu's %s)" % (
      b, "kernel" if fits else "XLA loop"), KERNEL_ATOL)
  groups = [list(range(i, i + 4)) for i in range(0, 32, 4)]
  gd, (g, width), _ = _grouped(d, groups)
  assert group_early_stop_tile_fits(b, g * width, g) == (b == 24)
  geta = _stepsize(gd.numpy())
  eps = _eps_and_count(_trajectory(
      x, gd.numpy(), geta, lambda v, t: _group_shrink(v, width, t, False),
      "fista"), "mid")[0]
  want = np.asarray(jax_sub.run(x, d, groups, LAM, ITERS,
                                formulation="pallas",
                                early_stopping_epsilon=eps, stepsize=geta))
  got = sub.run(x, d, groups, LAM, ITERS, formulation="pallas",
                early_stopping_epsilon=eps, stepsize=geta)
  assert_close(got, want, "subspace run b %d" % b, KERNEL_ATOL)


def _segment_problem(rng, groups=None, k=3, b=10, s=24, n=16):
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  basis = rng.randn(6, n)
  batches = (rng.randn(k * b, 6) @ basis + 0.2 * rng.randn(k * b, n))
  h = np.abs(rng.rand(s)) * 0.01
  gm = s if groups is None else len(groups) * max(len(g) for g in groups)
  v = rng.randn(min(gm, n))
  return (d.astype(np.float32), h.astype(np.float32), v.astype(np.float32),
          batches.reshape(k, b, n).astype(np.float32))


NAMES = ("dictionary", "hessian", "eigvec", "codes")


@pytest.mark.parametrize("variant,update_alg,nonneg,hard,eps", [
    ("fista", "sc_cheap_quadratic_descent", False, False, 0.1),
    ("fista", "sc_steepest_descent", False, False, 10.0),
    ("ista", "sc_steepest_descent", True, False, 0.1),
    ("fista", "sc_cheap_quadratic_descent", False, True, 0.0),
])
def test_k2_segment_stop_matches_pallas(rng, monkeypatch, variant,
                                        update_alg, nonneg, hard, eps):
  d, h, v, batches = _segment_problem(rng)
  flags = dict(variant=variant, update_alg=update_alg, nonneg=nonneg,
               hard=hard, power_iters=2, early_stopping_epsilon=eps)
  assert fused_segment_supported(
      "fully-connected", variant, update_alg, batch_size=10, code_size=24,
      input_size=16, early_stopping_epsilon=eps)
  want = fused_train_segment_pallas(d, h, v, batches, 0.05, ITERS, 0.05,
                                    interpret=True, **flags)
  counts = _counted(monkeypatch)
  got = K2.fused_train_segment(*map(torch.from_numpy, (d, h, v, batches)),
                               0.05, ITERS, 0.05, **flags)
  print("K2 %s eps %g: stop counts %s" % (variant, eps, counts))
  assert len(counts) == 3
  if eps == 0.0:
    assert counts == [ITERS] * 3
  elif eps >= 10.0:
    assert counts == [2] * 3
  else:  # a step that stops mid-run
    assert any(2 < c < ITERS for c in counts)
  for w, g, name in zip(want, got, NAMES):
    w = np.asarray(w)
    assert_close(g, w, "K2 %s eps %g: %s" % (variant, eps, name),
                 SEGMENT_ATOL * max(1.0, float(np.abs(w).max())))


K6_GROUPS = {
    "ragged": [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0]],
    "M2": [[i, i + 1] for i in range(0, 14, 2)],
    "M4 identity": [list(range(i, i + 4)) for i in range(0, 16, 4)],
}


@pytest.mark.parametrize("case,variant,hard,update_alg,eps", [
    ("ragged", "fista", False, "subspace_sc_cheap_quadratic_descent", 0.3),
    ("M2", "fista", True, "subspace_sc_steepest_descent", 0.3),
    ("M4 identity", "ista", False, "subspace_sc_cheap_quadratic_descent",
     0.3),
    ("M4 identity", "fista", False, "subspace_sc_steepest_descent", 10.0),
])
def test_k6_segment_stop_matches_pallas(rng, monkeypatch, case, variant,
                                        hard, update_alg, eps):
  groups = K6_GROUPS[case]
  s = 16 if case == "M4 identity" else 14
  d, h, v, batches = _segment_problem(rng, groups, s=s)
  flags = dict(group_assignments=groups, variant=variant, hard=hard,
               update_alg=update_alg, power_iters=2,
               early_stopping_epsilon=eps)
  want = fused_group_train_segment_pallas(d, h, v, batches, 0.05, ITERS,
                                          0.05, interpret=True, **flags)
  counts = _counted(monkeypatch)
  got = K6.fused_group_train_segment(
      *map(torch.from_numpy, (d, h, v, batches)), 0.05, ITERS, 0.05,
      **flags)
  print("K6 %s eps %g: stop counts %s" % (case, eps, counts))
  assert len(counts) == 3
  if eps >= 10.0:
    assert counts == [2] * 3
  else:  # a step that stops before the last iteration
    assert min(counts) < ITERS
  for w, g, name in zip(want, got, NAMES):
    w = np.asarray(w)
    assert_close(g, w, "K6 %s eps %g: %s" % (case, eps, name),
                 SEGMENT_ATOL * max(1.0, float(np.abs(w).max())))


def _train_data(rng, k, b, s=24, n=16):
  basis = rng.randn(8, n)
  data = (rng.randn(k * b, 8) * 2.0 @ basis + 0.2 * rng.randn(k * b, n))
  d0 = rng.randn(s, n)
  d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
  return (data.astype(np.float32).reshape(k, b, n), d0.astype(np.float32))


def _train_params(**extra):
  params = {
      "mode": "fully-connected",
      "num_epochs": 2,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 30}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": 0.05, "num_iters": 1}},
      "stdout_print_interval": 10**9,
      "fc_formulation": "pallas",
      "early_stopping_epsilon": 1e-2,
  }
  params.update(extra)
  return params


@pytest.mark.parametrize("b,extra", [
    (10, {}),
    (4000, {}),
    (10, {"code_inference_algorithm": "subspace_fista",
          "dictionary_update_algorithm":
              "subspace_sc_cheap_quadratic_descent",
          "group_assignments": [list(range(i, i + 4))
                                for i in range(0, 24, 4)]}),
])
def test_scanned_trainer_stops_as_vtc_tpu(rng, b, extra):
  """The scanned trainer with fc_formulation='pallas' and a stop: vtc_tpu
  takes its fused segment kernel at b 10 and its XLA steps at b 4000 (past
  its one tile), the port its plain per-step runner on the CPU (K2 / K6
  on a card)."""
  data, d0 = _train_data(rng, k=3, b=b)
  params = _train_params(**extra)
  if "group_assignments" not in extra:
    assert fused_segment_supported(
        "fully-connected", "fista", "sc_cheap_quadratic_descent",
        batch_size=b, code_size=24, input_size=16,
        early_stopping_epsilon=1e-2) == (b == 10)
  want = np.asarray(jax_ce.train_dictionary_scanned(data, data[:1], d0,
                                                    params))
  nudged = np.nextafter(d0, np.float32(2)).astype(np.float32)
  moved = np.asarray(jax_ce.train_dictionary_scanned(data, data[:1], nudged,
                                                     params))
  bound = max(ATOL, 2.0 * float(np.abs(moved - want).max()))
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cpu")
  assert_close(got, want, "scanned b %d %s" % (b, sorted(extra)), bound)


@pytest.mark.parametrize("b", [10, 4000])
def test_per_batch_trainer_stops_as_vtc_tpu(rng, b):
  data, d0 = _train_data(rng, k=3, b=b)
  params = _train_params(lipschitz_method="eigvalsh")
  want = np.asarray(jax_sc.train_dictionary(data, data[:1], d0, params))
  nudged = np.nextafter(d0, np.float32(2)).astype(np.float32)
  moved = np.asarray(jax_sc.train_dictionary(data, data[:1], nudged, params))
  bound = max(ATOL, 2.0 * float(np.abs(moved - want).max()))
  got = sc.train_dictionary(data, data[:1], d0, params, device="cpu")
  assert_close(got, want, "train_dictionary b %d" % b, bound)


def test_stop_constants_are_the_headers():
  text = HEADER.read_text()
  found = {name: int(value) for name, value in re.findall(
      r"constexpr int (k\w+) = (\d+);", text)}
  assert (found["kStopLaneWords"], found["kStopCtlWords"]) == (
      K1.STOP_LANE_WORDS, K1.STOP_CTL_WORDS)
  # the stop builds' threads and shared memory, as the header forms them
  assert "return (threads + 31) / 32 * 32 + 32;" in text
  assert "return (2 * ((threads + 31) / 32 * 32) + 4)" in text
  assert (K1.stop_threads(72), K1.stop_smem(72)) == (128, (2 * 96 + 4) * 4)


@pytest.mark.parametrize("b,s,m,route,words", [
    (250, 256, 1, "cluster", 2 * 14 * 8),   # the trainers' batch
    (250, 256, 4, "cluster", 2 * 14 * 8),
    (125, 256, 2, "cluster", 2 * 13 * 8),   # a DP shard's size
    (2048, 256, 1, "wide", 2 * 64 * 2),     # the encodes' batch
    (2048, 256, 4, "wide", 2 * 64 * 2),
    (4096, 256, 1, "classic", 3 + 256),     # two waves of the wide kernel
    (1000, 256, 1, "classic", 3 + 63),      # 32 clusters for 15 slots
    (2048, 320, 1, "classic", 3 + 128),     # no wide layout past s 288
    (250, 256, 8, "classic", 3 + 16),       # M outside {1, 2, 4}
    (250, 96, 3, "classic", 3 + 16),
    (250, 704, 1, "classic", 3 + 16),       # no cluster layout
])
def test_stop_route_and_words_at_the_h100(b, s, m, route, words):
  taken = K1.stop_route(b, s, m, H100_SMS, H100_CLUSTER_SLOTS,
                        H100_PAIR_SLOTS)
  assert taken == route
  assert K1.stop_words(taken, b, s, m, H100_CLUSTER_SLOTS,
                       H100_PAIR_SLOTS) == words


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 4096), s=st.integers(1, 1200),
       m=st.sampled_from([1, 2, 3, 4, 8, 26]), sms=st.integers(8, 264),
       slots=st.integers(1, 40), wslots=st.integers(1, 140))
def test_stop_route_only_takes_one_resident_wave(b, s, m, sms, slots,
                                                 wslots):
  """A stop route other than the classic one is the solve's own route,
  its grid one wave of the slots given, within the gather's 256 CTAs, with
  room for the stop warp; its words are two per CTA."""
  route = K1.stop_route(b, s, m, sms, slots, wslots)
  assert route in ("classic", K1.solve_route(b, s, m, sms))
  words = K1.stop_words(route, b, s, m, slots, wslots)
  if route == "classic":
    assert words == K1.STOP_CTL_WORDS + -(-b // K1.ROWS)
    return
  assert 4 % m == 0
  if route == "cluster":
    rows, size, cap = K1.cluster_rows(b, s, m, slots), K1.CLUSTER, slots
    lay = K1.cluster_layout(s, m, rows)
    assert K1.stop_threads(lay["threads"]) <= K1.CLUSTER_MAX_THREADS
  else:
    rows, size, cap = (K1.wide_rows(b, s, m, wslots), K1.wide_cluster(s, m),
                       wslots)
    lay = K1.wide_layout(s, size, rows)
    assert K1.stop_threads(lay["threads"]) <= K1.WIDE_MAX_THREADS
  clusters = -(-b // rows)
  assert clusters <= cap and clusters * size <= 32 * K1.STOP_LANE_WORDS
  assert lay["smem"] + K1.stop_smem(lay["threads"]) <= 232448
  assert words == 2 * clusters * size
