"""K11's class-tiled launch (csrc/conv_gram_tiles.cuh) on the CPU: the
plan of ``fused_conv_fista.class_plan`` and the order in which a tile's
passes combine.

The kernel itself needs the card (chip_smoke.py holds it to the plain
version there).  Here:

* the plan covers every code position once, every tile holds positions
  of one class, each slot's class is its row's and column's place in
  spec_py / spec_px, and the work items are each tile's passes once, in
  order, those of the tiles of several passes first, at the three timed
  geometries (the flagship, the serving geometry of 3x32x32 kernels at
  stride 16, 576 kernels), at a small geometry with 5x7 kernels at stride
  (2, 3) and asymmetric padding, and at geometries with no special rows or
  none at all;
* a torch emulation of the tiles' passes in the kernel's combination
  order (extra = -rows, then the columns, then + corners, then G_int)
  equals ``conv_gram.apply_gram`` in float64 within 1e-12, and a float32
  FISTA loop through it equals vtc_tpu's Pallas kernel in interpret mode
  within the port's parity tolerance (1e-4 relative to the largest code,
  tests/test_torch_port_conv.py);
* the header's class-word constants are the wrapper's.
"""
import pathlib
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from vtc_tpu.ops import lipschitz as jax_lipschitz
from vtc_tpu.ops import pallas_conv_fista
from vtc_tpu_torch.ops import conv_gram, conv_shapes, fused_conv_fista
from vtc_tpu_torch.ops import solver, thresholds

ATOL = 1e-4
ITERS = 8
CSRC = pathlib.Path(fused_conv_fista.__file__).resolve().parent.parent / (
    "csrc")

# name: (b, c, padded (H, W), s, (kh, kw), stride, padding); the special
# rows and columns depend on the geometry alone, so s is cut to 2 here
PLAN_GEOMETRIES = {
    "flagship": (40, 1, (272, 272), 2, (16, 16), (8, 8), ((8, 8), (8, 8))),
    "serving 3x32x32/16": (40, 3, (288, 288), 2, (32, 32), (16, 16),
                           ((16, 16), (16, 16))),
    "s576": (8, 1, (272, 272), 2, (16, 16), (8, 8), ((8, 8), (8, 8))),
    "5x7/(2,3) asymmetric": (3, 2, (17, 22), 2, (5, 7), (2, 3),
                             ((3, 2), (4, 4))),
    "columns only": (2, 1, (12, 16), 2, (4, 4), (2, 2), ((0, 0), (2, 2))),
    "no special lines": (2, 1, (12, 12), 2, (4, 4), (4, 4), None),
}


def _op(geometry, rng=None, s=None):
  b, c, hw, s0, (kh, kw), stride, padding = geometry
  s = s or s0
  rng = rng or np.random.RandomState(0)
  d = rng.randn(s, c, kh, kw)
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  code_hw = (conv_shapes.code_dim_from_padded_img_dim(hw[0], kh, stride[0]),
             conv_shapes.code_dim_from_padded_img_dim(hw[1], kw, stride[1]))
  op = conv_gram.build_gram_operator(
      torch.from_numpy(d), stride, conv_shapes.normalize_padding(padding),
      hw, code_hw)
  return op, d


def _slot_class(op, flat, code_hw):
  """The class word of each flat position (b * h + y) * w + x."""
  code_h, code_w = code_hw
  row_of = -np.ones(code_h, np.int64)
  col_of = -np.ones(code_w, np.int64)
  row_of[list(op["spec_py"])] = np.arange(len(op["spec_py"]))
  col_of[list(op["spec_px"])] = np.arange(len(op["spec_px"]))
  t = flat % (code_h * code_w)
  i, j = row_of[t // code_w], col_of[t % code_w]
  return ((i >= 0) * fused_conv_fista.CLASS_ROW
          + (j >= 0) * fused_conv_fista.CLASS_COL
          + np.where(i >= 0, i, 0) * 4
          + np.where(j >= 0, j, 0) * 2 ** (2 + fused_conv_fista.
                                          CLASS_INDEX_BITS))


@pytest.mark.parametrize("name", sorted(PLAN_GEOMETRIES))
def test_class_plan_covers_every_position_once(name):
  tile = fused_conv_fista.TILE_N
  geometry = PLAN_GEOMETRIES[name]
  b = geometry[0]
  op, _ = _op(geometry)
  code_h, code_w = op["code_hw"]
  slots, words, items, multi = fused_conv_fista.class_plan(
      op["spec_py"], op["spec_px"], b, code_h, code_w)
  assert slots.dtype == words.dtype == items.dtype == torch.int32
  assert slots.numel() == tile * words.numel()
  slots = slots.numpy().reshape(-1, tile)
  words, items = words.numpy(), items.numpy()
  valid = slots >= 0
  # every position exactly once, each tile's filled slots first
  assert np.array_equal(np.sort(slots[valid]), np.arange(b * code_h * code_w))
  assert np.all(valid.any(axis=1))
  assert np.all(np.diff(valid.astype(np.int8), axis=1) <= 0)
  # one class a tile, the class of every slot in it
  got = _slot_class(op, np.where(valid, slots, 0), (code_h, code_w))
  assert np.all(np.where(valid, got == words[:, None], True))
  # a class's tiles are contiguous, the corners first and the interior last
  runs = [w for k, w in enumerate(words) if k == 0 or words[k - 1] != w]
  assert len(runs) == len(set(runs))
  assert runs[-1] == 0 or not np.any(words == 0)
  passes = [1 + bool(w & 1) + bool(w & 2) + ((w & 3) == 3) for w in runs]
  assert passes == sorted(passes, reverse=True)
  # the work items: each tile's passes once, in order, several first
  bits = fused_conv_fista.PASS_BITS
  want = [(t, q) for t, w in enumerate(words)
          for q in range(fused_conv_fista.passes(w))]
  got = [(it >> bits, it & (2 ** bits - 1)) for it in items]
  assert sorted(got) == want
  npass = [fused_conv_fista.passes(words[t]) for t, _ in got]
  assert multi == sum(n > 1 for n in npass)
  assert all(n > 1 for n in npass[:multi])
  assert all(n == 1 for n in npass[multi:])
  assert all(got[k] == (got[k - 1][0], got[k - 1][1] + 1)
             for k in range(len(got)) if got[k][1] > 0)
  count = {"corners": int(np.sum((words & 3) == 3)),
           "rows": int(np.sum((words & 3) == 1)),
           "columns": int(np.sum((words & 3) == 2)),
           "interior": int(np.sum(words == 0))}
  print("%s, tiles of %d: spec_py %s, spec_px %s, %d tiles %s, %d items "
        "(%d of several passes)" % (name, tile, op["spec_py"], op["spec_px"],
                                    len(words), count, len(items), multi))
  if name == "no special lines":
    assert not op["spec_py"] and not op["spec_px"] and runs == [0]
  if name == "columns only":
    assert not op["spec_py"] and op["spec_px"]


def test_class_words_match_the_kernel():
  """The wrapper's class word layout is conv_gram_tiles.cuh's."""
  src = (CSRC / "conv_gram_tiles.cuh").read_text()
  const = {m.group(1): int(m.group(2)) for m in re.finditer(
      r"constexpr int (kGram\w+) = (\d+);", src)}
  assert const["kGramRow"] == fused_conv_fista.CLASS_ROW
  assert const["kGramCol"] == fused_conv_fista.CLASS_COL
  assert const["kGramIndexBits"] == fused_conv_fista.CLASS_INDEX_BITS
  assert const["kGramPassBits"] == fused_conv_fista.PASS_BITS
  assert const["kGramBN"] == fused_conv_fista.TILE_N
  assert fused_conv_fista.class_word(3, 5) == (
      1 | 2 | 3 << 2 | 5 << (2 + const["kGramIndexBits"]))
  assert "constexpr int kBM = %d;" % fused_conv_fista.TILE_M in (
      CSRC / "conv_gemm.cuh").read_text()


def emulate_class_tiles(z, op):
  """L(z) as the kernel sums it: the plan's classes, each pass the
  products of its weight matrix (A[m, o*s + j] = G[o][m][j]) with the
  gathered codes, combined in the kernel's order, in z's float type."""
  b, s, code_h, code_w = z.shape
  ry, rx = op["ry"], op["rx"]
  num_p, num_q = len(op["spec_py"]), len(op["spec_px"])
  zp = F.pad(z, (rx, rx, ry, ry))
  offs = [(dy, dx) for dy in range(-ry, ry + 1) for dx in range(-rx, rx + 1)]
  slots, words, _, _ = fused_conv_fista.class_plan(
      op["spec_py"], op["spec_px"], b, code_h, code_w)
  slots = slots.reshape(-1, fused_conv_fista.TILE_N)
  out = torch.full((b, s, code_h, code_w), float("nan"), dtype=z.dtype)
  stack = lambda g: g.permute(1, 0, 2).reshape(s, -1)  # (s, O*s)
  for word in torch.unique(words).tolist():
    pos = slots[words == word].flatten()
    pos = pos[pos >= 0].long()
    bi, t = pos // (code_h * code_w), pos % (code_h * code_w)
    y, x = t // code_w, t % code_w
    gathered = torch.cat([zp[bi, :, y + ry + dy, x + rx + dx]
                          for dy, dx in offs], dim=1)      # (n, O*s)
    i = (word >> 2) & (2 ** fused_conv_fista.CLASS_INDEX_BITS - 1)
    j = word >> (2 + fused_conv_fista.CLASS_INDEX_BITS)
    acc = lambda g: gathered @ stack(g).T                   # (n, s)
    extra = None
    if word & fused_conv_fista.CLASS_ROW:
      extra = -acc(op["g_rows"][i])
    if word & fused_conv_fista.CLASS_COL:
      cols = acc(op["g_cols"][j])
      extra = (extra - cols if extra is not None
               else (torch.zeros_like(cols) - cols if num_p else -cols))
    if (word & 3) == 3:
      extra = extra + acc(op["g_corners"][i, j])
    v = acc(op["g_int"])
    if num_p or num_q:
      v = v + (extra if extra is not None else torch.zeros_like(v))
    out[bi, :, y, x] = v
  return out


@pytest.mark.parametrize("name", ["5x7/(2,3) asymmetric", "columns only",
                                  "no special lines"])
def test_class_schedule_matches_apply_gram(name):
  rng = np.random.RandomState(3)
  geometry = PLAN_GEOMETRIES[name]
  op, _ = _op(geometry, rng, s=5)
  op = {k: (v.double() if torch.is_tensor(v) else v) for k, v in op.items()}
  code_h, code_w = op["code_hw"]
  z = torch.from_numpy(rng.randn(geometry[0], 5, code_h, code_w))
  got = emulate_class_tiles(z, op)
  want = conv_gram.apply_gram(z, op)
  err = float((got - want).abs().max())
  print("%s: max|d| %.3e" % (name, err))
  assert err <= 1e-12


def test_class_schedule_solve_matches_pallas_kernel():
  """A float32 FISTA loop whose gradient is the emulated class tiles
  against vtc_tpu's K11 in interpret mode, at the first geometry of
  tests/test_pallas_conv_fista.py (its interpret mode takes most of this
  file's time; the float64 test above covers the asymmetric ones)."""
  c, kdim, stride, img, padding = 1, 4, (2, 2), 8, ((2, 2), (2, 2))
  rng = np.random.RandomState(0)
  (lv, tv), (lh, th) = padding
  x = np.zeros((3, c, img + lv + tv, img + lh + th), np.float32)
  x[:, :, lv:lv + img, lh:lh + img] = rng.randn(3, c, img, img)
  d = rng.randn(6, c, kdim, kdim).astype(np.float32)
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  # half the flattened kernels' 1/L: random unwindowed kernels make FISTA
  # diverge at 1/L in both packages (the conv operator's L is larger)
  step = 0.5 * float(jax_lipschitz.fista_stepsize(
      jnp.asarray(d).reshape(6, -1), "eigvalsh"))
  want = np.asarray(pallas_conv_fista.conv_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(d), 0.03, ITERS, step,
      kernel_stride=stride, padding=padding, interpret=True))
  op, corr = fused_conv_fista.operator_and_corr(
      torch.from_numpy(x), torch.from_numpy(d), stride, padding)
  shrink = thresholds.select(False, False)
  got = solver.proximal_gradient_loop(
      lambda z: emulate_class_tiles(z, op) - corr,
      lambda v, ss: shrink(v, 0.03 * ss), torch.zeros_like(corr),
      torch.tensor(step, dtype=torch.float32), ITERS, variant="fista")
  err = float(np.abs(got.numpy() - want).max())
  atol = ATOL * max(1.0, float(np.abs(want).max()))
  print("class tiles c%d k%d %s: max|d| %.3e (atol %.1e)" % (
      c, kdim, stride, err, atol))
  assert err <= atol
