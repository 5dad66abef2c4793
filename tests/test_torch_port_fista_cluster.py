"""The fc/subspace solve's route and its thread-block-cluster layout
(vtc_tpu_torch/csrc/fista_core.cuh, mirrored in ops/fused_fista.py).

``fused_fista.solve_route`` picks, per shape, the classic kernel or the
cluster kernel, and ``cluster_rows`` / ``cluster_layout`` give the cluster
kernel's layout; the C header computes the same.  Here, on the CPU:

* the route sends the trainers' batch of 250 and its data-parallel shard
  of 125 (s 256, groups of 1, 2 and 4) to the cluster kernel, and a
  group that would cross two CTAs' columns or an s past the shared-memory
  budget to the classic one (the encode batch of 2048 takes the wide
  kernel: tests/test_torch_port_fista_wide.py);
* every shape routed to the cluster kernel has a layout within a block's
  227 KB of shared memory and 512 threads, a grid that is a multiple of
  the cluster size, and threads that own every (row, column) of a
  cluster's tile once, each group inside one thread or one CTA;
* the Python constants are the header's;
* the plain versions, which stand for both kernels here, hold vtc_tpu's
  Pallas kernels (interpret mode) at a ragged shape of the cluster route
  (b 37, s 40: padded rows and columns), within 1e-5, the JAX tests' own
  bound between two float32 solves.

The kernels themselves run only on a card: the two tests marked cuda
skip here, and chip_smoke.py phase 39 makes their checks there.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from vtc_tpu.ops.pallas_fista import fista_solve_pallas
from vtc_tpu.ops.pallas_group_fista import (group_fista_solve_pallas,
                                            membership_matrix)
from vtc_tpu_torch.ops import fused_fista as K1
from vtc_tpu_torch.ops import fused_group_fista as K4

HEADER = (pathlib.Path(__file__).resolve().parent.parent / "vtc_tpu_torch"
          / "csrc" / "fista_core.cuh")
SMEM = 232448  # a block's opt-in shared memory on Hopper
H100_SMS = 132
KERNEL_ATOL = 1e-5


def test_constants_are_the_headers():
  text = HEADER.read_text()
  found = {name: int(value) for name, value in re.findall(
      r"constexpr int (k\w+) = (\d+);", text)}
  assert (found["kRows"], found["kChunk"], found["kCluster"],
          found["kClusterMaxRows"], found["kClusterMaxThreads"],
          found["kSmemPerBlock"]) == (
              K1.ROWS, K1.CHUNK, K1.CLUSTER, K1.CLUSTER_MAX_ROWS,
              K1.CLUSTER_MAX_THREADS, SMEM)
  # a cluster's slices are whole float4s of the padded depth
  assert K1.CHUNK % (4 * K1.CLUSTER) == 0


@pytest.mark.parametrize("b,s,m", [
    (250, 256, 1), (125, 256, 1), (250, 256, 2), (125, 256, 2),
    (250, 256, 4), (125, 256, 4), (37, 40, 1), (37, 40, 4), (1024, 256, 1),
    (250, 512, 1), (250, 256, 8), (125, 96, 3)])
def test_small_batches_take_the_cluster_kernel(b, s, m):
  assert K1.solve_route(b, s, m, H100_SMS) == "cluster"


@pytest.mark.parametrize("b,s,m,why", [
    (2048, 256, 8, "a group of 8 is not whole in a wide thread's columns"),
    (2048, 320, 1, "past the wide layout's shared-memory budget"),
    (13, 104, 26, "a group of 26 crosses a CTA's 16 columns"),
    (250, 40, 3, "a group of 3 crosses a CTA's 8 columns"),
    (250, 1024, 1, "past the shared-memory budget"),
    (250, 768, 4, "past the shared-memory budget"),
    (64, 2048, 1, "past the shared-memory budget")])
def test_other_shapes_take_the_classic_kernel(b, s, m, why):
  assert K1.solve_route(b, s, m, H100_SMS) == "classic", why


def test_the_budget_sets_the_widest_cluster_shape():
  """The shared memory, not a width cap, ends the cluster route: the G
  slice (sk^2 / 8 floats) and two rows fit at s 640 (sk 640), not at s
  641 (sk 672); wider rows fit fewer batch rows a cluster."""
  assert K1.cluster_max_rows(256, 1) == K1.CLUSTER_MAX_ROWS
  assert 2 <= K1.cluster_max_rows(576, 1) < K1.CLUSTER_MAX_ROWS
  assert K1.cluster_max_rows(640, 1) >= 2
  assert K1.cluster_max_rows(641, 1) == 0
  assert K1.cluster_layout(641, 1, 2)["smem"] > SMEM


@pytest.mark.parametrize("b,rows,clusters", [
    (250, 18, 14), (125, 10, 13), (37, 4, 10), (13, 2, 7), (2048, 32, 64)])
def test_rows_spread_the_batch_over_the_cluster_slots(b, rows, clusters):
  """At 15 slots (the H100's clusters of 8 at one CTA per SM) the batch
  takes as few rows a cluster as fit it in the slots."""
  got = K1.cluster_rows(b, 256, 1, 15)
  assert (got, -(-b // got)) == (rows, clusters)
  assert K1.cluster_grid(b, got) == clusters * K1.CLUSTER


def owners(s, m, rows):
  """{(row, column): owner} over one cluster's tile, from the kernel's
  index arithmetic: CTA q, thread t = (ty, tx), rows 2 ty and 2 ty + 1,
  columns q w + 4 tx .. +3."""
  lay = K1.cluster_layout(s, m, rows)
  w = lay["w"]
  own = {}
  for q in range(K1.CLUSTER):
    for t in range(lay["threads"]):
      ty, tx = divmod(t, w // 4)
      for r in (2 * ty, 2 * ty + 1):
        for c in range(4):
          key = (r, q * w + 4 * tx + c)
          assert key not in own, "%s owned twice" % (key,)
          own[key] = (q, t)
  return own, lay


SWEEP = [(b, s, m, slots)
         for b in (1, 13, 37, 125, 250, 1000, 2048)
         for s in (1, 24, 37, 40, 96, 200, 256, 300, 512, 576, 640, 1024)
         for m in (1, 2, 3, 4, 6, 8, 16)
         for slots in (7, 15, 16, 33)
         if s % m == 0]


@pytest.mark.parametrize("m", [1, 2, 3, 4, 6, 8, 16])
def test_every_cluster_shape_fits_and_covers_its_tile(m):
  routed = 0
  for b, s, mm, slots in SWEEP:
    if mm != m or K1.solve_route(b, s, m, H100_SMS) != "cluster":
      continue
    routed += 1
    rows = K1.cluster_rows(b, s, m, slots)
    lay = K1.cluster_layout(s, m, rows)
    assert rows % 2 == 0 and 2 <= rows <= K1.CLUSTER_MAX_ROWS
    assert lay["smem"] <= SMEM and lay["threads"] <= K1.CLUSTER_MAX_THREADS
    assert K1.cluster_grid(b, rows) % K1.CLUSTER == 0
    assert K1.cluster_grid(b, rows) // K1.CLUSTER * rows >= b
    assert lay["w"] % 4 == 0 and lay["w"] % m == 0
    assert lay["w"] * K1.CLUSTER == lay["sk"] >= s
    if rows < K1.cluster_max_rows(s, m):  # not capped: one CTA an SM
      assert -(-b // rows) <= slots
  assert routed > 0


@pytest.mark.parametrize("s,m,rows", [(256, 4, 18), (40, 4, 4), (96, 3, 10),
                                      (256, 8, 2), (512, 1, 24)])
def test_threads_own_the_tile_once_and_groups_stay_whole(s, m, rows):
  own, lay = owners(s, m, rows)
  sk = lay["sk"]
  assert set(own) == {(r, j) for r in range(rows) for j in range(sk)}
  for r in range(rows):
    for g in range(0, sk, m):
      ctas = {own[(r, g + i)][0] for i in range(m)}
      threads = {own[(r, g + i)] for i in range(m)}
      assert len(ctas) == 1, "group %d crosses CTAs" % g
      if 4 % m == 0:  # the register prox: one thread holds the group
        assert len(threads) == 1, "group %d crosses threads" % g


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 4096), s=st.integers(1, 1200),
       m=st.sampled_from([1, 2, 3, 4, 5, 6, 8, 16, 26, 32]),
       sms=st.integers(8, 264), slots=st.integers(1, 40))
def test_route_and_layout_agree(b, s, m, sms, slots):
  """Whatever the route sends to the cluster kernel has a layout that
  fits; a shape whose group crosses a CTA never goes there."""
  route = K1.solve_route(b, s, m, sms)
  rows = K1.cluster_rows(b, s, m, slots)
  sk = -(-s // K1.CHUNK) * K1.CHUNK
  if (sk // K1.CLUSTER) % m:
    assert route == "classic" and rows == 0
  if route == "cluster":
    lay = K1.cluster_layout(s, m, rows)
    assert rows >= 2 and lay["smem"] <= SMEM
    assert lay["threads"] <= K1.CLUSTER_MAX_THREADS
    assert 2 * -(-b // K1.ROWS) <= sms


def _problem(rng, b=37, s=40, n=24):
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return rng.randn(b, n).astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("variant,nonneg,hard,warm", [
    ("fista", False, False, False), ("ista", True, False, True),
    ("fista", False, True, True), ("fista", True, True, False)])
def test_plain_matches_pallas_at_a_ragged_cluster_shape(rng, variant, nonneg,
                                                        hard, warm):
  x, d = _problem(rng)
  assert K1.solve_route(37, 40, 1, H100_SMS) == "cluster"
  flags = dict(variant=variant, nonneg=nonneg, hard=hard)
  init = None
  if warm:
    init = K1.fused_fista_plain(torch.from_numpy(x), torch.from_numpy(d),
                                0.08, 5, 0.05, **flags).numpy()
  got = K1.fused_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), 0.08, 20, torch.tensor(0.05),
      initial_codes=None if init is None else torch.from_numpy(init),
      **flags).numpy()
  want = np.asarray(fista_solve_pallas(
      x, d, 0.08, 20, np.float32(0.05), initial_codes=init, batch_tile=8,
      interpret=True, **flags))
  assert np.abs(want).max() > 0
  err = float(np.abs(got - want).max())
  print("b 37 s 40 %s: max|d| %.3e" % (flags, err))
  assert err <= KERNEL_ATOL


@pytest.mark.parametrize("m,hard", [(1, False), (2, True), (4, False),
                                    (4, True)])
def test_group_plain_matches_pallas_at_a_ragged_cluster_shape(rng, m, hard):
  x, d = _problem(rng)
  assert K1.solve_route(37, 40, m, H100_SMS) == "cluster"
  want = np.asarray(group_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(d),
      membership_matrix(40 // m, m, np.ones((40 // m, m), np.float32)),
      jnp.float32(0.08), jnp.int32(20), jnp.float32(0.05), hard=hard,
      interpret=True))
  got = K4.fused_group_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), m, 0.08, 20,
      torch.tensor(0.05), hard=hard).numpy()
  assert np.abs(want).max() > 0
  err = float(np.abs(got - want).max())
  print("b 37 gm 40 M %d hard %s: max|d| %.3e" % (m, hard, err))
  assert err <= KERNEL_ATOL


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the solve kernels have no CPU mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_cluster_kernel_matches_classic_bitwise(rng):
  """Both kernels, forced, on the same inputs: the same bits (chip_smoke.py
  phase 39 runs the full set)."""
  dev = _cuda_device()
  for b, s, m in ((250, 256, 1), (125, 256, 4), (37, 40, 2)):
    x, d = _problem(rng, b, s, 64)
    xt, dt = torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)
    gram, corr = (dt @ dt.T).contiguous(), (xt @ dt.T).contiguous()
    eta = torch.tensor([0.05], device=dev)
    if m == 1:
      run = lambda route: K1._launch(gram, corr, None, eta, 0.02, 25, True,
                                     0, route=route)
    else:
      run = lambda route: K4._launch(gram, corr, None, eta, 0.02, 25, m,
                                     True, False, route=route)
    assert torch.equal(run("classic"), run("cluster"))


@pytest.mark.cuda
def test_cuda_trainers_launch_the_cluster_kernel(rng):
  """A b-250 fc trainer segment launches fista_cluster_kernel once a step
  and fista_kernel never (chip_smoke.py phase 39 profiles the fc, subspace
  and data-parallel trainers)."""
  dev = _cuda_device()
  from torch.profiler import ProfilerActivity, profile

  from vtc_tpu_torch.training import compiled_epoch
  x = torch.from_numpy(rng.randn(5, 250, 64).astype(np.float32)).to(dev)
  d, _ = _problem(rng, 1, 64, 64)
  params = {
      "mode": "fully-connected", "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 10}},
      "dictionary_update_algorithm": "sc_steepest_descent",
      "dict_update_param_schedule": {0: {"stepsize": 0.01, "num_iters": 1}},
      "stdout_print_interval": 5}
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    compiled_epoch.train_dictionary_scanned(x, x[:1], torch.from_numpy(d)
                                            .to(dev), params)
    torch.cuda.synchronize()
  names = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
  assert sum("fista_cluster_kernel" in n for n in names) == 5
  assert not any("fista_kernel" in n for n in names)
