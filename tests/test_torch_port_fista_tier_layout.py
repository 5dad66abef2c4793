"""The tier routes of the fc/subspace solve: fista_tier_cluster_kernel's
resident layouts (vtc_tpu_torch/csrc/fista_tier.cuh, mirrored in
ops/fused_fista.py).

At a tier other than 'highest', ``fused_fista.tier_route`` sends a solve
to the tier cluster route (small batches), the tier wide route (batches
that fill the card) or fista_tier_kernel; ``tier_plan`` gives the layout.
Here, on the CPU and in seconds (no solve runs):

* the Python constants are the header's;
* every shape the rule sends to a resident route fits a block's 227 KB
  and its threads, has rows a multiple of 16 and, up to one wave of the
  most rows, a grid of one resident wave; its warps own each (row,
  column) of a cluster's tile once, and a lane's columns hold whole
  groups (with its neighbour lane at M 4);
* the route table of the callers: K1 and K4 at b 2048 take the tier wide
  route, K2 and K6 at b 250 and K3 and K7 at b 125 the tier cluster
  route, phase 46's ragged 13 x 37 x 24 and M 26 fista_tier_kernel, and
  a stop across ranks the classic stop route;
* the stop's words follow the route.

The kernels run only on a card: the tests marked cuda skip here, and
chip_smoke.py phases 46, 47 and 52 make their checks there.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from vtc_tpu_torch.ops import fused_fista as K1
from vtc_tpu_torch.ops import fused_group_fista as K4

HEADER = (pathlib.Path(__file__).resolve().parent.parent / "vtc_tpu_torch"
          / "csrc" / "fista_tier.cuh")
SMEM = 232448  # a block's opt-in shared memory on Hopper
MAX_THREADS = 1024
H100_SMS = 132
# the clusters an NVIDIA H100 80GB HBM3 holds at one CTA an SM, by cluster
# size (cudaOccupancyMaxActiveClusters, read on the card: its 132 SMs sit
# in GPCs that take 30 clusters of 4)
H100_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15}
TIERS = ("bf16", "bf16x3", "bf16x5")


def slots(cluster):
  return H100_SLOTS[cluster]


def test_constants_are_the_headers():
  text = HEADER.read_text()
  found = {name: int(value) for name, value in re.findall(
      r"constexpr int (k\w+) = (\d+);", text)}
  assert (found["kTierUnit"], found["kTierMaxWarps"],
          found["kTierMaxCluster"]) == (K1.TIER_UNIT, K1.TIER_MAX_WARPS,
                                        K1.TIER_MAX_CLUSTER)
  assert "kTierMaxThreads = 32 * (kTierMaxWarps + 1)" in text
  # the route codes are fista_core.cuh's
  core = HEADER.with_name("fista_core.cuh").read_text()
  for name, code in (("kRouteTier", 4), ("kRouteTierCluster", 5),
                     ("kRouteTierWide", 6)):
    assert re.search(r"%s = %d" % (name, code), core), name
    assert K1.TIER_ROUTE_CODES[{"kRouteTier": "tier",
                      "kRouteTierCluster": "tier_cluster",
                      "kRouteTierWide": "tier_wide"}[name]] == code


def _owners(lay, rows):
  """{(row, column): count} of the C fragment entries the warps of one CTA
  hold (mt, unit, lane, n8 tile, register), as the kernel indexes them."""
  units = lay["w"] // K1.TIER_UNIT
  own = {}
  for warp in range(lay["warps"]):
    mt, un = divmod(warp, units)
    for lane in range(32):
      for t in range(2):
        for c in range(4):
          key = (mt * 16 + (lane >> 2) + 8 * (c >> 1),
                 un * K1.TIER_UNIT + 8 * t + 2 * (lane & 3) + (c & 1))
          own[key] = own.get(key, 0) + 1
  return own


SHAPES = [(b, s, m, tier) for tier in TIERS for m in (1, 2, 4)
          for s in (32, 48, 96, 128, 256, 288) for b in (1, 13, 125, 250,
                                                         1056, 1100, 2048)]


@pytest.mark.parametrize("tier", TIERS)
def test_every_resident_shape_fits(tier):
  """Every shape the rule sends to a resident route: shared memory, threads,
  rows in m16 tiles, one resident wave up to the wave's rows, each (row,
  column) of a CTA's tile owned once, a lane's groups whole."""
  taken = 0
  for b, s, m, t in SHAPES:
    if t != tier:
      continue
    route, cluster, rows, bufs = K1.tier_plan(b, s, m, tier, H100_SMS,
                                              slots)
    if route == "tier":
      continue
    taken += 1
    lay = K1.tier_layout(tier, s, cluster, rows, bufs)
    assert lay["smem"] <= SMEM, (b, s, m)
    assert lay["threads"] + 32 <= MAX_THREADS  # with the stop warp
    assert 1 <= lay["warps"] <= K1.TIER_MAX_WARPS
    assert rows % 16 == 0 and rows >= 16
    clusters = -(-b // rows)
    # one wave wherever some layout holds the batch in one
    if any(b <= slots(p) * K1.tier_max_rows(tier, s, m, p, bufs)
           for p in (1, 2, 4, 8) for bufs in (1, 2)):
      assert clusters <= slots(cluster), (b, s, m, tier, cluster, rows)
    own = _owners(lay, rows)
    assert len(own) == rows * lay["w"] and set(own.values()) == {1}
    # a lane holds two neighbouring columns from an even one: M 1 and 2
    # whole, M 4 with the neighbour lane (lanes 4k, 4k+1 / 4k+2, 4k+3)
    assert K1.TIER_UNIT % 8 == 0 and 8 % m == 0
  assert taken > 40


@pytest.mark.parametrize("b,s,m,route", [
    (2048, 256, 1, "tier_wide"), (2048, 256, 4, "tier_wide"),
    (250, 256, 1, "tier_cluster"), (250, 256, 4, "tier_cluster"),
    (125, 256, 1, "tier_cluster"), (125, 256, 4, "tier_cluster"),
    (13, 37, 1, "tier"), (13, 104, 26, "tier"), (250, 256, 8, "tier"),
    (250, 96, 3, "tier"), (2048, 40, 1, "tier")])
def test_the_callers_routes(b, s, m, route):
  """K1 / K4 encodes at b 2048, K2 / K6 at b 250, K3 / K7 shards at b 125;
  phase 46's ragged 13 x 37 x 24 and M 26, other M and s not a multiple
  of 16 on fista_tier_kernel, at every tier."""
  for tier in TIERS:
    assert K1.tier_route(b, s, m, tier, H100_SMS) == route
    assert K1.tier_plan(b, s, m, tier, H100_SMS, slots)[0] == route


def test_the_encode_and_trainer_layouts():
  """The layouts the callers get on the 132-SM card: at b 2048 one wave
  of 128 CTAs at bf16 and bf16x3 (clusters of 1 and 2); at bf16x5 no
  layout holds 2,048 rows in one wave (30 clusters of 4 take 1,920), so
  two waves of clusters of 2 with one z buffer, and its stop on
  fista_tier_kernel; at b 250 clusters of 4 and at b 125 of 8, one wave,
  with the stop in the same launch.  With 32 slots of 4, bf16x5 would
  take one wave of clusters of 4 with one z buffer."""
  want = {"bf16": ("tier_wide", 1, 16, 2), "bf16x3": ("tier_wide", 2, 32, 2),
          "bf16x5": ("tier_wide", 2, 16, 1)}
  for tier in TIERS:
    assert K1.tier_plan(2048, 256, 1, tier, H100_SMS, slots) == want[tier]
    assert K1.tier_plan(2048, 256, 4, tier, H100_SMS, slots,
                        stop=True) == (want[tier] if tier != "bf16x5" else
                                       ("tier", 0, 0, 0))
    assert K1.tier_plan(250, 256, 4, tier, H100_SMS, slots, stop=True) == (
        "tier_cluster", 4, 16, 2)
    assert K1.tier_plan(125, 256, 4, tier, H100_SMS, slots, stop=True) == (
        "tier_cluster", 8, 16, 2)
  assert K1.tier_plan(2048, 256, 1, "bf16x5", H100_SMS,
                      {1: 132, 2: 66, 4: 32, 8: 15}.get, stop=True) == (
                          "tier_wide", 4, 64, 1)
  # one z buffer in one wave, the stop in the same launch (phase 52)
  assert K1.tier_plan(1100, 256, 1, "bf16x5", H100_SMS, slots,
                      stop=True) == ("tier_wide", 8, 80, 1)
  # past one wave the wide route runs in waves, its stop on the classic
  # route
  assert K1.tier_plan(4096, 256, 1, "bf16", H100_SMS, slots)[0] == (
      "tier_wide")
  assert K1.tier_plan(4096, 256, 1, "bf16", H100_SMS, slots,
                      stop=True)[0] == "tier"


def test_a_stop_across_ranks_takes_the_classic_route():
  for tier in TIERS:
    assert K1.tier_plan(250, 256, 1, tier, H100_SMS, slots, stop=True,
                        world=2) == ("tier", 0, 0, 0)
  # the words of each route: two a CTA, or the classic route's
  assert K1.tier_stop_words("tier_cluster", 250, 4, 16) == 2 * 16 * 4
  assert K1.tier_stop_words("tier", 250, 0, 0) == K1.STOP_CTL_WORDS + 16


def test_forced_routes_are_for_a_tier_only():
  gram, corr = torch.eye(16), torch.zeros(2, 16)
  for route in K1.TIER_ROUTES:
    with pytest.raises(ValueError, match="at 'highest'"):
      K1._launch(gram, corr, None, torch.ones(1), 0.1, 1, 1, 0, route=route)
  with pytest.raises(ValueError, match="route must be 'auto'"):
    K4._launch(gram, corr, None, torch.ones(1), 0.1, 1, 2, 1, 0,
               route="wide", mxu="bf16")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the tier kernels have no CPU mode")
  return torch.device("cuda", 0)


def _problem(b, s, seed=0):
  rng = np.random.RandomState(seed)
  d = rng.randn(s, 64).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = rng.randn(b, 64).astype(np.float32)
  return x, d


@pytest.mark.cuda
def test_cuda_tier_routes_match_fista_tier_kernel_bitwise():
  """The resident routes against fista_tier_kernel forced, on the same
  inputs, every tier, K1 and K4, with and without the stop: the same bits
  and counts (chip_smoke.py phase 52 runs the callers' full set)."""
  dev = _card()
  for b, s, m in ((2048, 256, 1), (250, 256, 4), (125, 96, 2),
                  (1100, 256, 4)):
    x, d = (torch.from_numpy(a).to(dev) for a in _problem(b, s))
    gram, corr = (d @ d.T).contiguous(), (x @ d.T).contiguous()
    eta = torch.tensor([0.05], device=dev)
    for tier in TIERS:
      for eps in (None, 0.0):
        if m == 1:
          run = lambda route: K1._launch(gram, corr, None, eta, 0.02, 25,
                                         True, 0, route=route, eps=eps,
                                         mxu=tier)
          mod = K1
        else:
          run = lambda route: K4._launch(gram, corr, None, eta, 0.02, 25, m,
                                         True, False, route=route, eps=eps,
                                         mxu=tier)
          mod = K4
        got = run("auto")
        assert mod.last_route in ("tier_cluster", "tier_wide")
        assert torch.equal(got, run("tier"))


@pytest.mark.cuda
def test_cuda_trainers_launch_the_tier_routes():
  """A K2 and a K6 segment at b 250 put every step's solve on the tier
  cluster route (the library's route counts; phases 46, 47 and 52 count
  the trainers' 1,000 steps)."""
  dev = _card()
  from vtc_tpu_torch.ops import fused_group_train_step as K6
  from vtc_tpu_torch.ops import fused_train_step as K2
  x, d = (torch.from_numpy(a).to(dev) for a in _problem(250 * 3, 256))
  batches = x.reshape(3, 250, 64)
  h = torch.zeros(256, device=dev)
  v = torch.ones(64, device=dev)
  K1.reset_route_launches()
  K2.fused_train_segment(d, h, v, batches, 0.02, 25, 0.1, power_iters=2,
                         mxu="bf16x3")
  K6.fused_group_train_segment(
      d, h, v, batches, 0.02, 25, 0.05, power_iters=2, mxu="bf16x3",
      group_assignments=[list(range(i, i + 4)) for i in range(0, 256, 4)])
  torch.cuda.synchronize()
  assert K1.route_launches()["tier_cluster"] == 3
  assert K4.route_launches()["tier_cluster"] == 3
