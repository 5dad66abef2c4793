"""The persistent solve under K19 at a code axis of 1 (vtc_tpu_torch/csrc/
code_shard_solve.cuh, mirrored in ops/fused_code_shard_train.py) and its
plain version against vtc_tpu.

At a mesh of one rank each train step's FISTA solve (and the update's
first residual) is one cooperative launch of ``code_shard_solve_kernel``:
a grid barrier between dependent phases, phase A (the reconstruction's
partials, a 256-atom chunk by a 32 x 64 (b, n) tile each), phase S (the
split sum), phase B (the gradient, the prox and the momentum, a 32 x 64
(b, s) tile each) and, with a member table, the group prox.  Here, on the
CPU:

* the Python constants and the barriers a step (as a function of the
  iterations, a member table and the update's residual) are the header's;
* the kernel's index arithmetic, repeated here, gives every output of
  phases A, B and S to exactly one thread of one CTA, for grids of 1, 7,
  128 and 132 CTAs and any b, s and n, and every element of a 32-deep
  copy slice to exactly one copying thread;
* the in-warp group norm's layout: a window of 1 to 32 columns of a
  warp's 32 gets the per-step kernel's butterfly (neighbouring columns
  first) from lanes, then a thread's own columns;
* the route 'auto' takes is pinned: the persistent solve at a mesh of one
  rank, the per-step route on any axis above 1; and the grid and the
  resident D slices of the persistent launch, the same at every tier;
* the tier build's layout: its shared memory at each tier (the float32
  staging and two D slices' bf16 planes, 32 KB a term a slice) fits the
  232,448 bytes an H100 CTA may opt into, once an SM; the planes' XOR
  swizzle gives a warp's B-fragment reads 32 banks; the mma fragments
  give every output of a 32 x 64 tile to exactly one (warp, lane, entry);
  and the tier tile's in-warp window sum covers exactly each group;
* the plain version, which stands for both routes here, holds vtc_tpu's
  Pallas kernel (interpret mode) at a ragged shape the Pallas gate
  accepts (b 13, s 200, n 40, fc and groups of 4), within
  tests/test_torch_port_code_shard.py's bounds: the dictionary, the
  Hessian EMA and the eigenvector 3e-5, the codes 1e-4.

The kernel itself runs only on a card: the test marked cuda skips here,
and chip_smoke.py phase 41 makes its checks there.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh, PartitionSpec

from vtc_tpu.ops import pallas_code_shard_train as jcs
from vtc_tpu_torch.ops import fused_code_shard_train as cs

HEADER = (pathlib.Path(__file__).resolve().parent.parent / "vtc_tpu_torch"
          / "csrc" / "code_shard_solve.cuh")
H100_SMS = 132
TOLS = {"dict": 3e-5, "hessian": 3e-5, "eigvec": 3e-5, "codes": 1e-4}


def _header_constants():
  return {name: int(value) for name, value in re.findall(
      r"constexpr int (k\w+) = (\d+);", HEADER.read_text())}


def test_constants_are_the_headers():
  found = _header_constants()
  assert (found["kCsTileM"], found["kCsTileN"], found["kCsDepth"],
          found["kCsSlice"], found["kCsThreads"], found["kSplitK"]) == (
              cs.SOLVE_TILE_M, cs.SOLVE_TILE_N, cs.SOLVE_DEPTH,
              cs.SOLVE_SLICE, cs.SOLVE_THREADS, cs.SPLIT_K)
  # a thread holds four rows by four columns; a phase-A tile is one chunk
  # deep; at most eight copy groups are in flight
  assert cs.SOLVE_THREADS * 16 == cs.SOLVE_TILE_M * cs.SOLVE_TILE_N
  assert cs.SOLVE_DEPTH == cs.SPLIT_K
  assert cs.SOLVE_DEPTH % cs.SOLVE_SLICE == 0
  assert cs.SOLVE_DEPTH // cs.SOLVE_SLICE <= 8


def _header_barriers(num_iters, members, resid):
  """cs_step_barriers's return expression, evaluated as C would."""
  body = re.search(r"cs_step_barriers\([^)]*\)\s*\{\s*return ([^;]+);",
                   HEADER.read_text(), re.S).group(1)
  expr = re.sub(r"\((\w+) \? (\d+) : (\d+)\)", r"(\2 if \1 else \3)", body)
  return eval(expr, {}, dict(num_iters=num_iters,  # noqa: S307
                             members=members, resid=resid))


@pytest.mark.parametrize("num_iters", [0, 1, 25])
@pytest.mark.parametrize("members", [False, True])
@pytest.mark.parametrize("resid", [False, True])
def test_barriers_a_step_are_the_headers(num_iters, members, resid):
  got = cs.solve_barriers(num_iters, members, resid)
  assert got == _header_barriers(num_iters, int(members), int(resid))
  # the prologue's; phases A, S and B an iteration (and the group prox
  # with a member table); one before the update residual's split sum
  assert got == (1 + num_iters * (4 if members else 3)
                 + (1 if resid else 0))


def test_the_flagship_step_has_77_barriers():
  assert cs.solve_barriers(25, False, True) == 77


def _row(tid, r):
  """cs_row: warp w covers tile rows 16 (w / 2) ..; lane l rows l / 8 +
  4 r."""
  return (tid >> 6) * 16 + ((tid & 31) >> 3) + 4 * r


def _col(tid, c):
  """cs_col: warp w covers tile columns 32 (w % 2) ..; lane l columns
  l % 8 + 8 c."""
  return ((tid >> 5) & 1) * 32 + (tid & 7) + 8 * c


TID = np.arange(cs.SOLVE_THREADS)


def _owned(grid, tiles, origin, shape, counts):
  """Add one to each output element a CTA's thread owns: CTA g takes tiles
  g, g + grid, ...; origin(t) is (first row, first column, plane) of tile
  t; shape the plane's (rows, columns)."""
  m, n = shape
  for cta in range(grid):
    for t in range(cta, tiles, grid):
      i0, j0, plane = origin(t)
      for r in range(4):
        for c in range(4):
          i, j = i0 + _row(TID, r), j0 + _col(TID, c)
          keep = (i < m) & (j < n)
          np.add.at(counts[plane], (i[keep], j[keep]), 1)


def _phase_counts(b, s, n, grid):
  """How many (CTA, thread) pairs own each output of phases A (one (b, n)
  plane a chunk), B ((b, s)) and S ((b, n), grid-stride over the entries
  or their float4s)."""
  tiles = cs.solve_tiles(b, s, n)
  ctn = -(-n // cs.SOLVE_TILE_N)
  rtb = -(-b // cs.SOLVE_TILE_M)
  splits = -(-s // cs.SPLIT_K)
  per = tiles["out"]
  count_a = np.zeros((splits, b, n), np.int64)
  _owned(grid, tiles["A"],
         lambda t: ((t % per) // ctn * cs.SOLVE_TILE_M,
                    (t % per) % ctn * cs.SOLVE_TILE_N, t // per),
         (b, n), count_a)
  count_b = np.zeros((1, b, s), np.int64)
  _owned(grid, tiles["B"],  # cs_row_block, cs_col_block
         lambda t: (t % rtb * cs.SOLVE_TILE_M, t // rtb * cs.SOLVE_TILE_N,
                    0), (b, s), count_b)
  threads = grid * cs.SOLVE_THREADS
  width = 4 if n % 4 == 0 else 1
  count_s = np.zeros(b * n, np.int64)
  for first in range(threads):
    for e in range(first, b * n // width, threads):
      count_s[width * e:width * e + width] += 1
  return count_a, count_b, count_s


@settings(max_examples=12, deadline=None)
@given(b=st.integers(1, 80), s=st.integers(1, 700), n=st.integers(1, 300),
       grid=st.sampled_from([1, 7, 128, 132]))
def test_every_output_is_owned_once(b, s, n, grid):
  for counts in _phase_counts(b, s, n, grid):
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("b,s,n", [(128, 2048, 256), (13, 96, 24),
                                   (77, 600, 200), (128, 512, 256)])
@pytest.mark.parametrize("grid", [1, 7, 128, 132])
def test_the_checked_shapes_are_owned_once(b, s, n, grid):
  for counts in _phase_counts(b, s, n, grid):
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("rows", [cs.SOLVE_TILE_M, cs.SOLVE_TILE_N])
def test_every_slice_element_is_copied_once(rows):
  """cs_load_rows: the threads copy each element of a 32-deep slice of A
  (32 rows) or of phase B's D rows (64) once, as floats or float4s along
  k (a warp's reads contiguous); cs_load_cols: each element of phase A's
  D operand (32 k by 64 columns) once, a warp reading along a row of D."""
  slice_ = cs.SOLVE_SLICE
  idx = np.arange(rows * slice_)
  row, kk = idx // slice_, idx % slice_
  assert len(set(zip(row.tolist(), kk.tolist()))) == idx.size
  for warp in range(idx.size // 32):
    assert np.all(np.diff(kk[32 * warp:32 * warp + 32]) == 1)
  vec = np.arange(rows * slice_ // 4)
  row4, k4 = vec // (slice_ // 4), 4 * (vec % (slice_ // 4))
  cells = {(r, k + e) for r, k in zip(row4.tolist(), k4.tolist())
           for e in range(4)}
  assert len(cells) == rows * slice_
  jdx = np.arange(cs.SOLVE_TILE_N * slice_)
  j, k = jdx % cs.SOLVE_TILE_N, jdx // cs.SOLVE_TILE_N
  assert len(set(zip(j.tolist(), k.tolist()))) == jdx.size
  for warp in range(jdx.size // 32):
    assert np.all(np.diff(j[32 * warp:32 * warp + 32]) == 1)


def _butterfly(values, window):
  """The per-step kernel's xor butterfly over one warp's 32 columns
  (column = lane there): level by level, each column's running value
  plus its partner's at distance off; returns the value of each column
  as nested ('+', a, b) terms, a and b in the order the lane adds them."""
  cur = list(values)
  off = 1
  while off < window:
    cur = [("+", cur[j], cur[j ^ off]) for j in range(32)]
    off <<= 1
  return cur


def _same(a, b):
  """Equal up to the order of a + b (IEEE addition commutes exactly)."""
  if not isinstance(a, tuple) or not isinstance(b, tuple):
    return a == b
  return ((_same(a[1], b[1]) and _same(a[2], b[2]))
          or (_same(a[1], b[2]) and _same(a[2], b[1])))


def _persistent_window(values, window):
  """The persistent kernel's order: thread (lane l % 8) holds columns
  l % 8 + 8 c; xor 1, 2, 4 over lanes up to the window (up to 8), then
  for 16 its columns c = 0, 1 and 2, 3 added, for 32 those two sums."""
  held = {(cg, c): values[cg + 8 * c] for cg in range(8) for c in range(4)}
  off = 1
  while off < window and off < 8:
    held = {(cg, c): ("+", held[(cg, c)], held[(cg ^ off, c)])
            for cg in range(8) for c in range(4)}
    off <<= 1
  if window >= 16:
    lo = {cg: ("+", held[(cg, 0)], held[(cg, 1)]) for cg in range(8)}
    hi = {cg: ("+", held[(cg, 2)], held[(cg, 3)]) for cg in range(8)}
    for cg in range(8):
      if window == 16:
        held[(cg, 0)] = held[(cg, 1)] = lo[cg]
        held[(cg, 2)] = held[(cg, 3)] = hi[cg]
      else:
        held.update({(cg, c): ("+", lo[cg], hi[cg]) for c in range(4)})
  return [held[(j % 8, j // 8)] for j in range(32)]


@pytest.mark.parametrize("window", [1, 2, 4, 8, 16, 32])
def test_the_group_norm_keeps_the_butterflys_order(window):
  values = ["u%d^2" % j for j in range(32)]
  want = _butterfly(values, window)
  got = _persistent_window(values, window)
  assert all(_same(g, w) for g, w in zip(got, want))
  # and each column's norm covers exactly its own group
  for j in range(32):
    leaves = re.findall(r"u(\d+)", str(got[j]))
    assert sorted(map(int, leaves)) == list(
        range(j // window * window, j // window * window + window))


@pytest.mark.parametrize("code,data,route", [
    (1, 1, "persistent"), (2, 1, "steps"), (1, 2, "steps"), (2, 2, "steps"),
    (4, 1, "steps")])
def test_the_auto_route_is_pinned(code, data, route):
  assert cs.auto_route(code, data) == route


TIERS = ("highest", "bf16x5", "bf16x3", "bf16")


@pytest.mark.parametrize("mxu", TIERS)
@pytest.mark.parametrize("b,s,n,blocks_per_sm,grid,tiles,resident", [
    (128, 2048, 256, 1, 128, (128, 128), (True, True)),
    (128, 512, 256, 1, 32, (32, 32), (True, True)),
    (13, 96, 24, 1, 2, (1, 2), (True, True)),
    (77, 600, 200, 1, 36, (36, 30), (True, True)),
    (128, 4096, 256, 1, 132, (256, 256), (False, False)),
    (128, 2048, 512, 1, 132, (256, 128), (False, False)),
    (250, 2048, 256, 1, 132, (256, 256), (False, False))])
def test_the_grid_is_pinned(b, s, n, blocks_per_sm, grid, tiles, resident,
                            mxu):
  plan = cs.solve_plan(b, s, n, H100_SMS, blocks_per_sm, mxu)
  assert plan["grid"] == grid
  assert (plan["tiles"]["A"], plan["tiles"]["B"]) == tiles
  assert (plan["resident"]["A"], plan["resident"]["B"]) == resident


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 4096), s=st.integers(2, 16384),
       n=st.integers(1, 2048), sms=st.integers(1, 264))
def test_the_grid_fits_the_card_and_the_larger_phase(b, s, n, sms):
  plan = cs.solve_plan(b, s, n, sms, 1)
  tiles = plan["tiles"]
  assert 1 <= plan["grid"] <= sms
  assert plan["grid"] == min(sms, max(tiles["A"], tiles["B"]))
  if plan["resident"]["B"]:
    assert n <= cs.SOLVE_DEPTH


H100_SM_SMEM = 233472  # the shared memory of an H100 SM, bytes
RESERVED = 1024  # a CTA's reserved shared memory


@pytest.mark.parametrize("mxu,smem", [
    ("highest", 166400), ("bf16", 99840), ("bf16x3", 164352),
    ("bf16x5", 229888)])
def test_the_shared_memory_fits_at_each_tier(mxu, smem):
  """The solve kernel's dynamic shared memory (the library's
  vtc_code_shard_smem, which chip_smoke.py phase 50 holds to this): it
  fits a CTA at every tier; 'highest''s fits one an SM and not two, and
  the grid takes the least count over the builds, so every tier runs the
  grid of one CTA an SM."""
  plan = cs.solve_plan(128, 2048, 256, H100_SMS, 1, mxu)
  assert plan["smem"] == smem == cs.SOLVE_SMEM[mxu]
  assert smem <= cs.H100_SMEM_OPTIN and smem + RESERVED <= H100_SM_SMEM
  highest = cs.SOLVE_SMEM["highest"] + RESERVED
  assert highest <= H100_SM_SMEM < 2 * highest
  assert plan["grid"] == 128 and plan["resident"] == {"A": True, "B": True}
  if mxu != "highest":
    terms = {"bf16": 1, "bf16x3": 2, "bf16x5": 3}[mxu]
    staging = 4 * cs.SOLVE_TILE_M * (cs.SOLVE_DEPTH + 4)
    planes = 2 * terms * (cs.SOLVE_TILE_N * cs.SOLVE_DEPTH // 2) * 4
    assert smem == staging + max(planes, 4 * cs.SOLVE_TILE_N
                                 * (cs.SOLVE_DEPTH + 4))
  with pytest.raises(ValueError, match="unknown MXU tier"):
    cs.solve_plan(128, 2048, 256, H100_SMS, 1, "default")


def _plane_word(j, kw):
  """cs_plane_word: row j's words XOR-swizzled by (j & 7) << 2."""
  return j * (cs.SOLVE_DEPTH // 2) + (kw ^ ((j & 7) << 2))


def test_the_planes_swizzle_is_conflict_free_and_a_bijection():
  text = HEADER.read_text()
  assert "constexpr int kCsRowWords = kCsDepth / 2;" in text
  assert "constexpr int kCsPlaneWords = kCsTileN * kCsRowWords;" in text
  assert "return j * kCsRowWords + (kw ^ ((j & 7) << 2));" in text
  words = {_plane_word(j, kw) for j in range(cs.SOLVE_TILE_N)
           for kw in range(cs.SOLVE_DEPTH // 2)}
  assert words == set(range(cs.SOLVE_TILE_N * cs.SOLVE_DEPTH // 2))
  lane = np.arange(32)
  g, t = lane >> 2, lane & 3
  for warp_col in (0, 32):
    for q in range(4):
      for k0 in range(0, cs.SOLVE_DEPTH, 16):
        for half in (0, 4):  # the fragment's two words
          banks = {_plane_word(warp_col + 8 * q + gg, k0 // 2 + tt + half)
                   % 32 for gg, tt in zip(g, t)}
          assert len(banks) == 32


def test_the_tier_fragments_own_every_output_once():
  """cs_tier_row / cs_tier_col: warp w rows 16 (w >> 1) + lane / 4 + 8
  (e >> 1), columns 32 (w & 1) + 8 q + 2 (lane & 3) + (e & 1)."""
  owned = np.zeros((cs.SOLVE_TILE_M, cs.SOLVE_TILE_N), int)
  for tid in range(cs.SOLVE_THREADS):
    for q in range(4):
      for e in range(4):
        row = 16 * (tid >> 6) + ((tid & 31) >> 2) + 8 * (e >> 1)
        col = 32 * ((tid >> 5) & 1) + 8 * q + 2 * (tid & 3) + (e & 1)
        owned[row, col] += 1
  assert (owned == 1).all()


def _tier_window(values, window):
  """cs_tier_b_tile's window sum over one warp row's 32 columns, column c
  at q = c // 8, lane t = (c % 8) // 2, entry e = c % 2; returns each
  column's sum as a tree."""
  held = {c: values[c] for c in range(32)}
  if window >= 2:
    for c in range(0, 32, 2):
      held[c] = held[c + 1] = ("+", held[c], held[c + 1])
  for off in (1, 2):
    if window >= 4 * off:
      held = {c: ("+", held[c], held[c ^ (2 * off)]) for c in range(32)}
  if window >= 16:
    for c in range(8):
      lo = ("+", held[c], held[c + 8])
      hi = ("+", held[c + 16], held[c + 24])
      if window == 16:
        held[c] = held[c + 8] = lo
        held[c + 16] = held[c + 24] = hi
      else:
        held[c] = held[c + 8] = held[c + 16] = held[c + 24] = ("+", lo, hi)
  return [held[c] for c in range(32)]


@pytest.mark.parametrize("window", [1, 2, 4, 8, 16, 32])
def test_the_tier_window_sum_covers_each_group(window):
  got = _tier_window(["u%d^2" % c for c in range(32)], window)
  for c in range(32):
    leaves = re.findall(r"u(\d+)", str(got[c]))
    assert sorted(map(int, leaves)) == list(
        range(c // window * window, c // window * window + window))


class _TwoCodeRanks:
  code_size, size = 2, 1


@pytest.mark.parametrize("route,mesh,match", [
    ("graph", None, "route must be one of"),
    ("persistent", _TwoCodeRanks(), "one rank only")])
def test_a_route_must_be_known_and_persistent_needs_one_rank(route, mesh,
                                                              match):
  """Both refused before anything is built or launched."""
  args = (torch.zeros(16, 4), torch.zeros(16), torch.ones(4),
          torch.zeros(1, 2, 4), None, None, None, mesh, 0.1, 2, 0.1)
  flags = dict(variant="fista", update_alg="sc_steepest_descent",
               upd_num_iters=1, nonneg=False, hard=False, renormalize=True,
               power_iters=2, lowest_code_val=0.001, alignment_penalty=0.0)
  before = cs.launches
  with pytest.raises(ValueError, match=match):
    cs._launch(*args, route=route, **flags)
  assert cs.launches == before


def _problem(seed, k=2, b=13, s=200, n=40):
  """Unit rows, a small Hessian EMA, the n x n Gram's top eigenvector and
  unit-scale batches: b 13, s 200 and n 40 are ragged against the solve's
  tiles (32 x 64), its 256-atom chunks and the TPU's sublanes and
  lanes."""
  rng = np.random.RandomState(seed)
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = rng.randn(k, b, n).astype(np.float32)
  h = np.abs(rng.randn(s)).astype(np.float32) * 0.01
  v = np.linalg.eigh(d.astype(np.float64).T @ d)[1][:, -1].astype(np.float32)
  return d, h, v, x


def _close(got, want, atol, what):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


@pytest.mark.parametrize("grouped", [False, True])
def test_plain_matches_pallas_at_a_ragged_shape(grouped):
  d, h, v, x = _problem(15)
  s = d.shape[0]
  assert jcs.code_shard_segment_supported(13, s, 40, 1)
  kw, pkw = {}, {}
  update_alg = "sc_cheap_quadratic_descent"
  if grouped:
    groups = [list(range(i, i + 4)) for i in range(0, s, 4)]
    expand = cs.code_shard_group_arrays(groups, s, 1)[0]
    kw["expand_local"] = expand[0]
    pkw = dict(expand_local=jnp.asarray(expand[0]),
               roll_window=jcs.roll_window_from_expand_arrays(expand))
    update_alg = "subspace_sc_cheap_quadratic_descent"
  mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "code"))

  def body(d_, h_, v_, x_):
    return jcs.fused_code_sharded_train_segment_pallas(
        d_, h_, v_, x_, jnp.float32(0.1), jnp.int32(8), jnp.float32(0.05),
        axis_name="code", axis_size=1, interpret=True, power_iters=2,
        update_alg=update_alg, **pkw)

  rep = PartitionSpec()
  want = jax.jit(jax.shard_map(
      body, mesh=mesh,
      in_specs=(PartitionSpec("code", None), PartitionSpec("code"), rep,
                rep),
      out_specs=(PartitionSpec("code", None), PartitionSpec("code"), rep,
                 PartitionSpec(None, "code")),
      check_vma=False))(*map(jnp.asarray, (d, h, v, x)))
  got = cs.fused_code_sharded_train_segment(
      *map(torch.from_numpy, (d, h, v, x)), 0.1, 8, 0.05, power_iters=2,
      update_alg=update_alg, **kw)
  for name, g, w in zip(("dict", "hessian", "eigvec", "codes"), got, want):
    assert g.shape == tuple(w.shape)
    _close(g.numpy(), np.asarray(w), TOLS[name],
           "%s b 13 s 200 n 40 %s" % ("4s" if grouped else "fc", name))


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the solve kernel has no CPU mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_code_shard_persistent_matches_steps_bitwise():
  """Both routes, forced, on the same inputs: the same bits of D, h, v,
  the codes and the stepsize (chip_smoke.py phase 41 runs the full set)."""
  dev = _cuda_device()
  for seed, (b, s, n), groups in ((1, (13, 200, 40), None),
                                  (4, (19, 250, 37), None),
                                  (2, (77, 600, 200), 4),
                                  (3, (128, 512, 256), 8)):
    d, h, v, x = (torch.from_numpy(a).to(dev)
                  for a in _problem(seed, 3, b, s, n))
    table = window = None
    if groups:
      table, window = cs.group_members(cs.code_shard_group_arrays(
          [list(range(i, i + groups)) for i in range(0, s, groups)], s,
          1)[0][0])
    flags = dict(variant="fista", update_alg="sc_cheap_quadratic_descent",
                 upd_num_iters=1, nonneg=False, hard=False,
                 renormalize=True, power_iters=2, lowest_code_val=0.001,
                 alignment_penalty=0.0)
    runs = [cs._launch(d.clone(), h.clone(), v.clone(), x, table, window,
                       None, None, 0.1, 25, 0.05, route=route, **flags)
            for route in ("steps", "persistent")]
    for a, c in zip(*runs):
      assert torch.equal(a.view(torch.int32), c.view(torch.int32))
