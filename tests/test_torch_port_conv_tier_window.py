"""The conv tier GEMM's window route: conv_window_gemm's plan and layout
(vtc_tpu_torch/csrc/conv_gemm_tier.cuh, mirrored in
ops/fused_conv_direct.py).

At a tier other than 'highest' every tier product of K10, K12, K13 and
K17 (corr, the synthesis, the analysis) takes the route that
``conv_tier_plan`` gives: the window route (a persistent grid, the
weights' planes resident a launch, each tile's source window copied and
split once) where it takes the shape, else gather_gemm_tier.  Here, on
the CPU and in seconds (no solve runs):

* the Python constants are the header's;
* every shape the rule sends to the window route fits a CTA's shared
  memory at its CTAs an SM, and a tile of its rows fits the threads' n8
  tiles;
* the callers' route table: K10 at b 40 and b 5, K12 and K17 at
  measure_conv(40, 25), K13 on a shard of 20, bench.py's two other conv
  geometries, and the gate's edge (s or cpx 512) on gather_gemm_tier;
* the tile plan covers every output position once, and the stop's
  shares follow the route;
* a numpy model of the window layout (``window_layout`` and its index
  functions below): each tile's window, read through the layout's index
  function (and the kernel's address arithmetic) at (n, k), is the
  gathered stack of ``block_stack`` / ``code_stack``, zeros outside the
  source included.

The kernel runs only on a card: the test marked cuda skips here, and
chip_smoke.py phase 54 makes its check there.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from vtc_tpu_torch.ops import fused_conv_direct as K10

CSRC = pathlib.Path(__file__).resolve().parent.parent / "vtc_tpu_torch" / (
    "csrc")
H100_SMS = 132
TIERS = ("bf16", "bf16x3", "bf16x5")
FLAGSHIP = ((1, 272, 272), (64, 1, 16, 16), (8, 8))  # image, kernels, stride


def _geo(b, image=FLAGSHIP[0], kernels=FLAGSHIP[1], stride=FLAGSHIP[2]):
  return K10.geometry((b,) + image, kernels, stride)


def _plans(geo, b, mxu, sms=H100_SMS):
  return {name: K10.conv_tier_plan(*shape, mxu, sms)
          for name, shape in K10.solve_products(geo, b).items()}


# ---------------------------------------------------------------------------
# a numpy model of conv_window_gemm's layout (csrc/conv_gemm_tier.cuh):
# which tile a CTA takes, the window its memory warps copy, and the
# addresses its math warps read
# ---------------------------------------------------------------------------
def window_layout(plan, k, src_c, off_w, off_y0, off_x0, sign, out_h,
                  out_w):
  """conv_window_gemm's launch layout of a window plan (its WindowArgs in
  conv_gemm_tier.cuh's launch_conv_window):
  rows a tile, tiles an image, window rows wr and columns wc, the channel
  stride cp of the term planes, the source row and column (dymin, dxmin)
  of window (0, 0) relative to the tile's first output row, and the
  offsets' decode."""
  r = k // src_c
  off_h = (r - 1) // off_w + 1
  return dict(
      rows=plan["rows"], row_tiles=-(-out_h // plan["rows"]),
      mblocks=plan["mblocks"], tiles=plan["tiles"],
      wr=plan["rows"] + off_h - 1, wc=out_w + off_w - 1, cp=src_c + 8,
      dymin=off_y0 + (0 if sign > 0 else -(off_h - 1)),
      dxmin=off_x0 + (0 if sign > 0 else -(off_w - 1)), nks=k // 16,
      k=k, src_c=src_c, off_w=off_w, off_y0=off_y0, off_x0=off_x0,
      sign=sign, out_h=out_h, out_w=out_w)


def window_tile(layout, t):
  """Tile t's (m-block, image, first output row, output rows)."""
  rt = t // layout["mblocks"]
  b, y0 = divmod(rt, layout["row_tiles"])
  y0 *= layout["rows"]
  return (t % layout["mblocks"], b, y0,
          min(layout["rows"], layout["out_h"] - y0))


def window_copy(src, layout, t):
  """Tile t's window as the kernel's memory warps read it (numpy):
  (src_c, wr, wc), window row i, column j holding src (nb, src_c, src_h,
  src_w) at source row y0 + dymin + i, column dxmin + j, zero outside the
  source."""
  _, b, y0, _ = window_tile(layout, t)
  _, c, hh, ww = src.shape
  out = np.zeros((c, layout["wr"], layout["wc"]), dtype=src.dtype)
  for i in range(layout["wr"]):
    sy = y0 + layout["dymin"] + i
    for j in range(layout["wc"]):
      sx = layout["dxmin"] + j
      if 0 <= sy < hh and 0 <= sx < ww:
        out[:, i, j] = src[b, :, sy, sx]
  return out


def window_index(layout, pos, k):
  """(window row, window column, channel) that the tile's position pos
  (row-major over its rows and out_w columns) reads at depth k."""
  o, ch = divmod(k, layout["src_c"])
  dy = layout["sign"] * (o // layout["off_w"]) + layout["off_y0"]
  dx = layout["sign"] * (o % layout["off_w"]) + layout["off_x0"]
  y, x = divmod(pos, layout["out_w"])
  return y + dy - layout["dymin"], x + dx - layout["dxmin"], ch


def window_step_shift(layout, q):
  """The kernel's step table entry of 16-deep step q: its offset's window
  shift times the channel stride, plus the step's first channel."""
  o, c0 = divmod(16 * q, layout["src_c"])
  dy = layout["sign"] * (o // layout["off_w"]) + layout["off_y0"]
  dx = layout["sign"] * (o % layout["off_w"]) + layout["off_x0"]
  return (((dy - layout["dymin"]) * layout["wc"] + dx - layout["dxmin"])
          * layout["cp"] + c0)


def window_lane_offset(layout, pos, half):
  """The kernel's ldmatrix row offset of position pos at the step's
  channels 8 half on (half 0 or 1), in bf16 values of a term plane."""
  y, x = divmod(pos, layout["out_w"])
  return (y * layout["wc"] + x) * layout["cp"] + 8 * half


def test_constants_are_the_headers():
  tier = (CSRC / "conv_gemm_tier.cuh").read_text()
  gemm = (CSRC / "conv_gemm.cuh").read_text()
  ints = {name: int(value) for name, value in re.findall(
      r"constexpr int (k\w+) = (\d+);", tier + gemm)}
  assert (ints["kWinThreads"], ints["kWinMaxN"], ints["kWindowMinOutW"],
          ints["kBM"], ints["kTableMaxK"]) == (
              K10.WIN_THREADS, K10.WIN_MAX_N, K10.WIN_MIN_OUT_W, K10.BM,
              K10.TABLE_MAX_K)
  assert "kWinRoleThreads = kWinThreads / 2" in tier
  assert "kWinMinOutW = kWindowMinOutW" in tier
  smem = re.search(r"constexpr long long kWinSmem = (\d+) - (\d+);", tier)
  assert int(smem.group(1)) - int(smem.group(2)) == K10.WIN_SMEM
  assert re.search(r"kConvRouteAuto = 0, kConvRouteGather = 1,\s+"
                   r"kConvRouteWindow = 2", tier)
  assert K10.TIER_ROUTES == {"auto": 0, "gather": 1, "window": 2}


@pytest.mark.parametrize("mxu", TIERS)
def test_window_plans_fit_the_card(mxu):
  """Over a sweep of shapes, every window plan fits a CTA's shared memory,
  holds a tile in the math warps' 16 n8 tiles, and gives each CTA one
  m-block, at least one row tile and at most one CTA an SM."""
  windows = 0
  for m in (16, 64, 100, 128, 512):
    for src_c in (16, 48, 64, 128, 512):
      for r, off_w in ((1, 1), (4, 2), (9, 3), (6, 2)):
        for out_w in (8, 16, 33, 34, 64, 128, 130):
          for nb, out_h in ((1, 1), (5, 33), (40, 34)):
            plan = K10.conv_tier_plan(m, r * src_c, src_c, off_w, out_h,
                                      out_w, nb, mxu, H100_SMS)
            if plan["route"] == "gather":
              assert plan["smem"] == 0
              continue
            windows += 1
            assert plan["smem"] <= K10.WIN_SMEM
            assert plan["rows"] >= 1
            assert plan["rows"] * out_w <= K10.WIN_MAX_N
            assert K10.WIN_MIN_OUT_W <= out_w
            assert plan["mblocks"] == -(-m // 64)
            assert plan["tiles"] == plan["mblocks"] * nb * -(-out_h
                                                             // plan["rows"])
            assert 1 <= plan["grid"] <= H100_SMS
            assert plan["grid"] <= plan["tiles"]
            assert plan["grid"] % plan["mblocks"] == 0
  assert windows > 100


def test_callers_route_table():
  """The window route takes every product of the flagship (K10 at b 40
  and b 5, K12 / K17 at measure_conv(40, 25), K13's shard of 20) and of
  bench.py's non-multiple k12s8 geometry at every tier, and s128's but
  its synthesis at bf16x5 (192 KB of weight planes); the gate's edge, s
  or cpx 512, stays on gather_gemm_tier."""
  rows = {}
  for label, b, geo in (
      ("K10 b40 / K12 / K17", 40, _geo(40)),
      ("K10 b5", 5, _geo(5)),
      ("K13 shard", 20, _geo(20)),
      ("k12s8", 40, K10.geometry((40, 1, 268, 268), (64, 1, 12, 12),
                                 (8, 8))),
      ("s128", 40, _geo(40, kernels=(128, 1, 16, 16)))):
    for mxu in TIERS:
      for name, plan in _plans(geo, b, mxu).items():
        rows[label, mxu, name] = plan["route"]
  for (label, mxu, name), route in rows.items():
    want = ("gather" if (label, mxu, name) == ("s128", "bf16x5", "synthesis")
            else "window")
    assert route == want, (label, mxu, name)
  # the flagship's layouts on the H100's 132 SMs
  assert _plans(_geo(40), 40, "bf16")["analysis"] == dict(
      route="window", rows=3, mblocks=1, tiles=440, grid=132, smem=127296)
  assert _plans(_geo(40), 40, "bf16x5")["synthesis"] == dict(
      route="window", rows=2, mblocks=1, tiles=680, grid=132, smem=228000)
  assert _plans(_geo(5), 5, "bf16")["synthesis"]["rows"] == 2
  # the gate's edge: 512 kernels, or 8 channels at stride 8 (cpx 512)
  for image, kernels in (((1, 272, 272), (512, 1, 16, 16)),
                         ((8, 272, 272), (64, 8, 16, 16))):
    geo = K10.geometry((40,) + image, kernels, (8, 8))
    assert K10.supported((40,) + image, kernels, (8, 8))
    for mxu in TIERS:
      plans = _plans(geo, 40, mxu)
      assert "gather" in {p["route"] for p in plans.values()}
      for name, plan in plans.items():
        src_c = geo["s"] if name == "synthesis" else geo["cpx"]
        assert (plan["route"] == "gather") == (src_c == 512), (kernels, name)


@pytest.mark.parametrize("out_h,out_w,nb,m", [(34, 34, 40, 64), (33, 33, 5, 64),
                                              (17, 16, 3, 128), (7, 40, 2,
                                                                 200)])
def test_tiles_cover_every_position_once_and_the_stop_shares(out_h, out_w,
                                                             nb, m):
  for mxu in TIERS:
    plan = K10.conv_tier_plan(m, 256, 64, 2, out_h, out_w, nb, mxu, H100_SMS)
    assert plan["route"] == "window"
    lay = window_layout(plan, 256, 64, 2, 0, 0, 1, out_h, out_w)
    seen = np.zeros((plan["mblocks"], nb, out_h), dtype=np.int64)
    for t in range(plan["tiles"]):
      mb, b, y0, rows = window_tile(lay, t)
      assert 1 <= rows <= plan["rows"] and rows * out_w <= K10.WIN_MAX_N
      seen[mb, b, y0:y0 + rows] += 1
    assert (seen == 1).all()
    # CTA c keeps the m-block c % mblocks and takes the row tiles c //
    # mblocks + k (grid // mblocks): every row tile of every m-block once
    taken = np.zeros(plan["tiles"], dtype=np.int64)
    step = plan["grid"] // plan["mblocks"]
    for c in range(plan["grid"]):
      for rt in range(c // plan["mblocks"], plan["tiles"] // plan["mblocks"],
                      step):
        t = rt * plan["mblocks"] + c % plan["mblocks"]
        assert window_tile(lay, t)[0] == c % plan["mblocks"]
        taken[t] += 1
    assert (taken == 1).all()
    # a share a tile, the gather route's 64 x 64 tiles too
    words = K10.conv_stop_words(m, nb * out_h * out_w)
    shares = 2 * (words - 2)
    assert shares >= plan["tiles"]
    assert shares >= -(-(nb * out_h * out_w) // 64) * -(-m // 64)


def _stacks(rng, geo, b):
  """(code stack, z) and (block stack, img) of random codes and image
  blocks of a geometry, as numpy."""
  z = torch.tensor(rng.standard_normal(
      (b, geo["s"], geo["code_h"], geo["code_w"])).astype(np.float32))
  img = torch.tensor(rng.standard_normal(
      (b, geo["cpx"], geo["bh"], geo["bw"])).astype(np.float32))
  return ((K10.code_stack(z, geo).numpy(), z.numpy()),
          (K10.block_stack(img, geo).numpy(), img.numpy()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_layout_reads_the_gathered_stack(seed):
  """On random stride-exact geometries with 16-multiple channels, both
  products (the synthesis's sign -1, the analysis's +1), every offset and
  every tile: the staging window read at (n, k) through window_index is
  the stack's element, exactly, and the kernel's ldmatrix address (lane
  offset plus step shift) is that element's place in the term planes."""
  rng = np.random.default_rng(seed)
  c, stride, kern = ((1, 4, 8), (1, 4, 12), (2, 4, 8))[seed]
  s = (16, 32, 16)[seed]
  blocks = int(rng.integers(17, 21))
  geo = K10.geometry((2, c, stride * blocks, stride * blocks),
                     (s, c, kern, kern), (stride, stride))
  assert geo["code_w"] >= K10.WIN_MIN_OUT_W
  (cstack, z), (bstack, img) = _stacks(rng, geo, 2)
  r = geo["r"]
  for name, stack, src, sign in (("synthesis", cstack, z, -1),
                                 ("analysis", bstack, img, 1)):
    m, k, src_c, off_w, out_h, out_w, nb = K10.solve_products(geo, 2)[name]
    assert k == r * src_c and src_c % 16 == 0
    rows_seen = {1, K10.WIN_MAX_N // out_w}
    for mxu in TIERS:
      base = K10.conv_tier_plan(m, k, src_c, off_w, out_h, out_w, nb, mxu,
                                H100_SMS)
      assert base["route"] == "window"
      rows_seen.add(base["rows"])
    for rows in sorted(rows_seen):
      plan = K10._window_plan_at(m, k, src_c, off_w, out_h, out_w, nb, "bf16",
                                 H100_SMS, rows)
      lay = window_layout(plan, k, src_c, off_w, 0, 0, sign, out_h,
                              out_w)
      assert lay["wr"] == rows + geo["ay"] - 1
      ks = np.arange(k)[None, :]
      q, rem = np.divmod(ks, 16)
      shift = np.array([window_step_shift(lay, qq) for qq in range(k
                                                                        // 16)])
      for t in range(0, plan["tiles"], plan["mblocks"]):
        _, b, y0, nrows = window_tile(lay, t)
        win = window_copy(src, lay, t)
        assert win.shape == (src_c, lay["wr"], lay["wc"])
        pos = np.arange(nrows * out_w)[:, None]
        wy, wx, ch = window_index(lay, pos, ks)
        want = stack[b, :, y0:y0 + nrows, :].reshape(k, -1).T
        np.testing.assert_array_equal(win[ch, wy, wx], want)
        flat = (window_lane_offset(lay, pos, rem // 8) + shift[q]
                + rem % 8)
        np.testing.assert_array_equal(flat, (wy * lay["wc"] + wx) * lay["cp"]
                                      + ch)
      # the synthesis's stack has zeros outside the codes: the zero fill
      assert sign > 0 or (stack == 0).any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_window_route_matches_gather_bitwise():
  """The window route, forced, against gather_gemm_tier, forced, at each
  tier on the flagship's three products at b 5: every output bitwise
  (chip_smoke.py phase 54 covers every epilogue, geometry and the stop)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the window kernel has no CPU mode")
  dev = torch.device("cuda", 0)
  rng = np.random.default_rng(0)
  geo = _geo(5)
  (_, z), (_, img) = _stacks(rng, geo, 5)
  z, img = torch.tensor(z, device=dev), torch.tensor(img, device=dev)
  d = torch.tensor(rng.standard_normal((64, 1, 16, 16)).astype(np.float32),
                   device=dev)
  dstk, dall = K10.pack_weights(d, geo)
  for mxu in TIERS:
    for a, src, hw, sign in (
        (dall, img, (geo["code_h"], geo["code_w"]), 1),
        (dstk, z, (geo["bh"], geo["bw"]), -1)):
      outs = [K10.tier_product(a, src, hw, geo["ax"], sign, mxu, route=route)
              for route in ("gather", "window")]
      assert torch.equal(outs[0].view(torch.int32),
                         outs[1].view(torch.int32)), (mxu, sign)
