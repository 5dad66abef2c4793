"""The fc/subspace solve's large-batch route: the wide cluster kernel
(vtc_tpu_torch/csrc/fista_core.cuh, mirrored in ops/fused_fista.py).

``fused_fista.solve_route`` sends a batch whose classic grid would fill
more than half of the SMs to ``fista_wide_kernel`` where its layout
fits; ``wide_cluster``, ``wide_rows`` and ``wide_layout`` give that
layout, and the C header computes the same.  Here, on the CPU:

* the route sends the encode's batch of 2048, a ragged 1,100 and 4,096
  (s 256, groups of 1, 2 and 4) to the wide kernel on a 132-SM card,
  batches of at most 1,056 to the cluster kernel as before, and a group
  of another size or an s past the layout's budget to the classic one;
* every shape routed to the wide kernel has a layout within a block's
  227 KB of shared memory and at most 256 threads, fills the card in one
  wave at b 2048 in clusters of one or two CTAs (s up to 256), and has
  threads that own every (row, column) of a cluster's tile once, each
  group inside one thread;
* the Python constants are the header's;
* the plain versions, which stand for the kernels here, hold vtc_tpu's
  Pallas kernels (interpret mode) at a ragged shape of the wide route
  (b 1,061, s 40: padded rows and columns), within 1e-5, the JAX tests'
  own bound between two float32 solves.

The kernels themselves run only on a card: the two tests marked cuda
skip here, and chip_smoke.py phase 42 makes their checks there.
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


# clusters of 1, 2, 4 and 8 CTAs resident at one CTA per SM, as the
# 132-SM NVIDIA H100 80GB HBM3 reports them (chip_smoke.py phases 39, 42)
H100_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15}


def test_constants_are_the_headers():
  found = {name: int(value) for name, value in re.findall(
      r"constexpr int (k\w+) = (\d+);", HEADER.read_text())}
  assert (found["kWideRowsPerThread"], found["kWideMaxThreads"],
          found["kWideMinThreads"], found["kWideMaxCluster"],
          found["kSmemPerBlock"], found["kChunk"], found["kRows"]) == (
              K1.WIDE_ROWS_PER_THREAD, K1.WIDE_MAX_THREADS,
              K1.WIDE_MIN_THREADS, K1.WIDE_MAX_CLUSTER, SMEM, K1.CHUNK,
              K1.ROWS)
  assert K1.ROUTES == {"auto": 0, "classic": 1, "cluster": 2, "wide": 3}
  assert "kRouteWide = 3" in HEADER.read_text()


@pytest.mark.parametrize("b,s,m,route", [
    (2048, 256, 1, "wide"), (2048, 256, 2, "wide"), (2048, 256, 4, "wide"),
    (1100, 256, 1, "wide"), (1100, 256, 2, "wide"), (1100, 256, 4, "wide"),
    (4096, 256, 1, "wide"), (4096, 256, 2, "wide"), (4096, 256, 4, "wide"),
    (2047, 256, 4, "wide"), (1057, 256, 1, "wide"), (2048, 40, 1, "wide"),
    (2048, 96, 4, "wide"), (2048, 288, 1, "wide"),
    (1056, 256, 1, "cluster"), (250, 256, 4, "cluster"),
    (125, 256, 2, "cluster"), (1024, 256, 4, "cluster"),
    (2048, 256, 8, "classic"), (2048, 96, 3, "classic"),
    (2048, 320, 1, "classic"), (2048, 512, 1, "classic"),
    (2048, 1024, 4, "classic")])
def test_the_route_table(b, s, m, route):
  """b > 1,056 at s 256 (the classic grid past half of the 132 SMs) and
  M in {1, 2, 4} takes the wide kernel; b <= 1,056 the cluster kernel as
  before; another M or s 320 and past it the classic kernel."""
  assert K1.solve_route(b, s, m, H100_SMS) == route


def test_the_flagship_layout():
  """s 256: pairs of CTAs, 128-column slices, 32 rows a cluster and 64
  clusters (128 CTAs of 128 threads) at b 2048 on 66 pair slots."""
  assert K1.wide_cluster(256, 1) == 2
  assert K1.wide_max_rows(256, 1, 2) == 48
  rows = K1.wide_rows(2048, 256, 1, H100_SLOTS[2])
  lay = K1.wide_layout(256, 2, rows)
  assert (rows, K1.wide_grid(2048, 256, 1, rows)) == (32, 128)
  assert (lay["w"], lay["threads"], lay["smem"]) == (128, 128, 197632)
  # 4,096 rows take two even waves, 1,100 one of 46 clusters
  assert K1.wide_rows(4096, 256, 1, H100_SLOTS[2]) == 32
  assert K1.wide_rows(1100, 256, 4, H100_SLOTS[2]) == 24


def test_the_budget_ends_the_wide_route():
  """Four warps of rows fit at s 288 (clusters of 4), not at s 289 and
  past it, in any cluster size up to 8."""
  assert K1.wide_cluster(288, 1) == 4
  for s in (289, 320, 384, 512, 640):
    assert K1.wide_cluster(s, 1) == 0
    for cluster in (1, 2, 4, 8):
      rows = K1.wide_max_rows(s, 1, cluster)
      assert K1.wide_layout(s, cluster, rows)["threads"] < 128


def owners(s, m, rows):
  """{(row, column): owner} over one wide cluster's tile, from the
  kernel's index arithmetic: CTA q, thread t = (ty, tx), rows 8 ty .. +7,
  columns q w + 4 tx .. +3."""
  cluster = K1.wide_cluster(s, m)
  lay = K1.wide_layout(s, cluster, rows)
  w = lay["w"]
  own = {}
  for q in range(cluster):
    for t in range(lay["threads"]):
      ty, tx = divmod(t, w // 4)
      for r in range(8 * ty, 8 * ty + 8):
        for c in range(4):
          key = (r, q * w + 4 * tx + c)
          assert key not in own, "%s owned twice" % (key,)
          own[key] = (q, t)
  return own, lay


SWEEP = [(b, s, m) for b in (1057, 1100, 1500, 2047, 2048, 3000, 4096)
         for s in (1, 24, 37, 40, 96, 160, 200, 224, 256, 288, 300)
         for m in (1, 2, 4) if s % m == 0]


@pytest.mark.parametrize("m", [1, 2, 4])
def test_every_wide_shape_fits_and_covers_its_tile(m):
  routed = 0
  for b, s, mm in SWEEP:
    if mm != m or K1.solve_route(b, s, m, H100_SMS) != "wide":
      continue
    routed += 1
    cluster = K1.wide_cluster(s, m)
    slots = H100_SLOTS[cluster]
    rows = K1.wide_rows(b, s, m, slots)
    lay = K1.wide_layout(s, cluster, rows)
    assert rows % 8 == 0 and 8 <= rows <= K1.wide_max_rows(s, m, cluster)
    assert lay["smem"] <= SMEM and lay["threads"] <= K1.WIDE_MAX_THREADS
    assert lay["w"] % 4 == 0 and lay["w"] * cluster == lay["sk"] >= s
    clusters = -(-b // rows)
    assert K1.wide_grid(b, s, m, rows) == clusters * cluster
    if b <= 2048 and cluster <= 2:  # one wave: each CTA an SM of its own
      assert clusters <= slots
    own, _ = owners(s, m, rows)
    assert set(own) == {(r, j) for r in range(rows)
                        for j in range(lay["sk"])}
    for r in range(rows):
      for g in range(0, lay["sk"], m):
        assert len({own[(r, g + i)] for i in range(m)}) == 1, (
            "group %d crosses threads" % g)
  assert routed > 0


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 8192), s=st.integers(1, 700),
       m=st.sampled_from([1, 2, 3, 4, 5, 6, 8, 16]),
       sms=st.integers(8, 264), slots=st.integers(1, 140))
def test_route_and_layout_agree(b, s, m, sms, slots):
  """Whatever the route sends to the wide kernel has a layout that fits
  with at least four warps at its most rows, and the rows for any slot
  count fit it; an M that does not divide 4 never goes there."""
  route = K1.solve_route(b, s, m, sms)
  cluster = K1.wide_cluster(s, m)
  if 4 % m:
    assert route != "wide" and cluster == 0
  if route == "wide":
    assert 2 * -(-b // K1.ROWS) > sms
    assert cluster in (1, 2, 4, 8)
    most = K1.wide_max_rows(s, m, cluster)
    assert K1.wide_layout(s, cluster, most)["threads"] >= 128
    rows = K1.wide_rows(b, s, m, slots)
    lay = K1.wide_layout(s, cluster, rows)
    assert 8 <= rows <= most and rows % 8 == 0
    assert lay["smem"] <= SMEM and lay["threads"] <= K1.WIDE_MAX_THREADS
    # the fewest waves the most rows allow
    waves = -(-b // (slots * most))
    assert -(-b // rows) <= waves * slots
  elif route == "cluster":
    assert 2 * -(-b // K1.ROWS) <= sms


def _problem(rng, b, s, n=24):
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return rng.randn(b, n).astype(np.float32), d.astype(np.float32)


WIDE_B, WIDE_S = 1061, 40  # ragged rows and columns on the wide route


@pytest.mark.parametrize("variant,nonneg,hard,warm", [
    ("fista", False, False, False), ("ista", True, False, True),
    ("fista", False, True, True), ("fista", True, True, False)])
def test_plain_matches_pallas_at_a_ragged_wide_shape(rng, variant, nonneg,
                                                     hard, warm):
  x, d = _problem(rng, WIDE_B, WIDE_S)
  assert K1.solve_route(WIDE_B, WIDE_S, 1, H100_SMS) == "wide"
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
      x, d, 0.08, 20, np.float32(0.05), initial_codes=init, batch_tile=128,
      interpret=True, **flags))
  assert np.abs(want).max() > 0
  err = float(np.abs(got - want).max())
  print("b %d s %d %s: max|d| %.3e" % (WIDE_B, WIDE_S, flags, err))
  assert err <= KERNEL_ATOL


@pytest.mark.parametrize("m,hard", [(1, False), (2, True), (4, False),
                                    (4, True)])
def test_group_plain_matches_pallas_at_a_ragged_wide_shape(rng, m, hard):
  x, d = _problem(rng, WIDE_B, WIDE_S)
  assert K1.solve_route(WIDE_B, WIDE_S, m, H100_SMS) == "wide"
  want = np.asarray(group_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(d),
      membership_matrix(WIDE_S // m, m,
                        np.ones((WIDE_S // m, m), np.float32)),
      jnp.float32(0.08), jnp.int32(20), jnp.float32(0.05), hard=hard,
      interpret=True))
  got = K4.fused_group_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), m, 0.08, 20,
      torch.tensor(0.05), hard=hard).numpy()
  assert np.abs(want).max() > 0
  err = float(np.abs(got - want).max())
  print("b %d gm %d M %d hard %s: max|d| %.3e" % (WIDE_B, WIDE_S, m, hard,
                                                   err))
  assert err <= KERNEL_ATOL


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the solve kernels have no CPU mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_wide_kernel_matches_classic_bitwise(rng):
  """Both kernels, forced, on the same inputs: the same bits (chip_smoke.py
  phase 42 runs the full set)."""
  dev = _cuda_device()
  for b, s, m in ((2048, 256, 1), (1100, 256, 4), (2047, 40, 2)):
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
    assert torch.equal(run("classic"), run("wide"))


@pytest.mark.cuda
def test_cuda_encode_launches_the_wide_kernel(rng):
  """A b-2048 fc encode launches fista_wide_kernel once a batch and
  neither fista_kernel nor fold_gram_kernel (chip_smoke.py phase 42
  profiles the fc and subspace encodes at the flagship)."""
  dev = _cuda_device()
  from torch.profiler import ProfilerActivity, profile

  from vtc_tpu_torch.encode import encode_dataset
  x, d = _problem(rng, 4096, 256, 256)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    encode_dataset(x, torch.from_numpy(d).to(dev), 0.008, 20,
                   batch_size=2048)
    torch.cuda.synchronize()
  names = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
  assert sum("fista_wide_kernel" in n for n in names) == 2
  assert not any("fista_kernel" in n or "fold_gram_kernel" in n
                 for n in names)
