"""The persistent ICA segment kernel's layout (vtc_tpu_torch/csrc/
ica_segment.cuh, mirrored in ops/fused_ica_train.py) and its plain
versions against vtc_tpu.

K8 and K18 run a whole segment as one cooperative launch of
``ica_segment_kernel``: a grid barrier between dependent phases, each
phase's output cut into 32 x 16 tiles that the CTAs share.  Here, on the
CPU:

* the Python constants and the phase count a step (as a function of
  refine_iters, upd_num_iters and the boost) are the header's;
* the kernel's index arithmetic, repeated here, gives every output element
  of every phase to exactly one thread of one CTA, for grids of 1, 7, 128
  and 132 CTAs and any n and b, and every element of a k slice to exactly
  one copying thread;
* the route and grid that 'auto' takes are pinned: the persistent route at
  every shape, a grid of min(the card's slots, the largest phase's
  tiles), the residual and codes phase pairing a tile of D X with the
  same tile of batch X;
* the plain versions, which stand for both routes here, hold vtc_tpu's
  Pallas kernels (interpret mode) at a ragged batch, n 128 with b 77 (the
  Pallas gate wants n a multiple of 128), within tests/
  test_pallas_ica_train.py's bounds: D 2e-5, X 2e-4, the residual 1e-5.

The kernels themselves run only on a card: the two tests marked cuda skip
here, and chip_smoke.py phase 40 makes their checks there.
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

from vtc_tpu.ops import pallas_ica_train as jax_k8
from vtc_tpu_torch import parallel
from vtc_tpu_torch.ops import fused_ica_train as K8

HEADER = (pathlib.Path(__file__).resolve().parent.parent / "vtc_tpu_torch"
          / "csrc" / "ica_segment.cuh")
H100_SMS = 132
LIMITS = (2e-5, 2e-4, 1e-5)  # dictionary, inverse, residual (absolute)


def _header_constants():
  return {name: int(value) for name, value in re.findall(
      r"constexpr int (kSeg\w+) = (\d+);", HEADER.read_text())}


def test_constants_are_the_headers():
  found = _header_constants()
  assert (found["kSegTileM"], found["kSegTileN"], found["kSegSlice"],
          found["kSegThreads"]) == (K8.SEG_TILE_M, K8.SEG_TILE_N,
                                    K8.SEG_SLICE, K8.SEG_THREADS)
  # a thread holds two rows by two columns; a slice is whole float4s
  assert K8.SEG_THREADS == K8.SEG_TILE_M * K8.SEG_TILE_N // 4
  assert K8.SEG_SLICE % 4 == 0


def _header_phases(refine_iters, upd_num_iters, boosted):
  """seg_step_phases's return expression, evaluated as C would."""
  body = re.search(r"seg_step_phases\([^)]*\)\s*\{\s*return ([^;]+);",
                   HEADER.read_text(), re.S).group(1)
  expr = re.sub(r"\((\w+) \? (\d+) : (\d+)\)", r"(\2 if \1 else \3)", body)
  return eval(expr, {}, dict(refine_iters=refine_iters,  # noqa: S307
                             upd_num_iters=upd_num_iters, boosted=boosted))


@pytest.mark.parametrize("refine_iters", [0, 1, 3, 5])
@pytest.mark.parametrize("upd_num_iters", [0, 1, 3])
@pytest.mark.parametrize("boosted", [False, True])
def test_phases_a_step_are_the_headers(refine_iters, upd_num_iters,
                                       boosted):
  got = K8.segment_phases(refine_iters, upd_num_iters, boosted)
  assert got == _header_phases(refine_iters, upd_num_iters, int(boosted))
  # two a refresh, the residual with the codes, the statistic, one an
  # update; the boost's two refreshes and second residual add five
  assert got == (2 * refine_iters + 2 + upd_num_iters
                 + (2 * 2 + 1 if boosted else 0))


def test_the_flagship_step_has_nine_phases():
  assert K8.segment_phases(3, 1, False) == 9


def _phase_shapes(n, b):
  """The tiled outputs of each kind of phase, as the kernel runs them: an
  n x n product (a refresh's E or X', the statistic, an update) and the
  residual and codes phase, whose tile t pairs tile t of D X (n, n) with
  tile t of batch X (b, n) (the same rows and columns)."""
  return {"n x n": [(n, n)], "residual and codes": [(n, n), (b, n)]}


def _owners(shapes, grid):
  """For each output of a phase, how many (CTA, thread) pairs the
  kernel's index arithmetic gives each element: CTA c takes tiles c, c +
  grid, ... of the phase's tiles (seg_tiles of the largest output's rows
  by the columns); thread (ty, tx) = (tid // 8, tid % 8) of a tile at
  (i0, j0) owns rows i0 + ty and i0 + ty + 16 of every output and columns
  j0 + 2 tx and j0 + 2 tx + 1, within the output."""
  counts = [np.zeros(s, np.int64) for s in shapes]
  rows = max(m for m, _ in shapes)
  cols = shapes[0][1]
  tiles_n = -(-cols // K8.SEG_TILE_N)
  tid = np.arange(K8.SEG_THREADS)
  ty, tx = tid // 8, tid % 8
  for cta in range(grid):
    for t in range(cta, K8.segment_tiles(rows, cols), grid):
      i0 = (t // tiles_n) * K8.SEG_TILE_M
      j0 = (t % tiles_n) * K8.SEG_TILE_N
      for which, (m, nn) in enumerate(shapes):
        for r in (0, K8.SEG_TILE_M // 2):
          for c in range(2):
            i, j = i0 + ty + r, j0 + 2 * tx + c
            keep = (i < m) & (j < nn)
            np.add.at(counts[which], (i[keep], j[keep]), 1)
  return counts


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 300), b=st.integers(1, 300),
       grid=st.sampled_from([1, 7, 128, 132]))
def test_every_output_is_owned_once(n, b, grid):
  for phase, shapes in _phase_shapes(n, b).items():
    for counts in _owners(shapes, grid):
      assert counts.min() == 1 and counts.max() == 1, phase


@pytest.mark.parametrize("n,b", [(256, 250), (24, 13), (200, 77),
                                 (384, 250)])
@pytest.mark.parametrize("grid", [1, 7, 128, 132])
def test_the_checked_shapes_are_owned_once(n, b, grid):
  for phase, shapes in _phase_shapes(n, b).items():
    for counts in _owners(shapes, grid):
      assert counts.min() == 1 and counts.max() == 1, phase


@pytest.mark.parametrize("transposed", [False, True])
def test_every_slice_element_is_copied_once(transposed):
  """seg_a_slot and seg_b_slot: the threads copy each element of a
  32-deep slice of A (32 rows, or 64 for the paired residual and codes
  tile) and of B (16 columns) once, as single floats (a warp's global
  reads contiguous: along k for A as stored, along the rows for A stored
  transposed, along the columns for B) or as float4s along k and along
  the columns."""
  for rows in ((K8.SEG_TILE_M,) if transposed
               else (K8.SEG_TILE_M, 2 * K8.SEG_TILE_M)):
    idx = np.arange(rows * K8.SEG_SLICE)
    if transposed:
      row, kk = idx % K8.SEG_TILE_M, idx // K8.SEG_TILE_M
      contiguous = row
    else:
      row, kk = idx // K8.SEG_SLICE, idx % K8.SEG_SLICE
      contiguous = kk
    assert len(set(zip(row.tolist(), kk.tolist()))) == idx.size
    for warp in range(idx.size // 32):
      assert np.all(np.diff(contiguous[32 * warp:32 * warp + 32]) == 1)
    vec = np.arange(rows * K8.SEG_SLICE // 4)
    if transposed:  # float4s along the rows, landing k-major
      row4 = 4 * (vec % (K8.SEG_TILE_M // 4))
      k4 = vec // (K8.SEG_TILE_M // 4)
      cells = {(r + e, k) for r, k in zip(row4.tolist(), k4.tolist())
               for e in range(4)}
    else:
      row4, k4 = vec // (K8.SEG_SLICE // 4), 4 * (vec % (K8.SEG_SLICE // 4))
      cells = {(r, k + e) for r, k in zip(row4.tolist(), k4.tolist())
               for e in range(4)}
    assert len(cells) == rows * K8.SEG_SLICE
  jdx = np.arange(K8.SEG_SLICE * K8.SEG_TILE_N)
  kb, jb = jdx // K8.SEG_TILE_N, jdx % K8.SEG_TILE_N
  assert len(set(zip(kb.tolist(), jb.tolist()))) == jdx.size
  vec = np.arange(K8.SEG_SLICE * K8.SEG_TILE_N // 4)
  cells = {(k, 4 * j + e) for k, j in zip((vec // 4).tolist(),
                                          (vec % 4).tolist())
           for e in range(4)}
  assert len(cells) == K8.SEG_SLICE * K8.SEG_TILE_N


@pytest.mark.parametrize("n,b,blocks_per_sm,grid,tiles", [
    (256, 250, 1, 128, (128, 128)),
    (256, 250, 2, 128, (128, 128)),
    (256, 125, 2, 128, (128, 128)),
    (24, 13, 2, 2, (2, 2)),
    (200, 77, 2, 91, (91, 91)),
    (128, 250, 2, 64, (32, 64)),
    (384, 250, 1, 132, (288, 288)),
    (384, 250, 2, 264, (288, 288)),
    (1024, 250, 2, 264, (2048, 2048))])
def test_the_auto_route_is_pinned(n, b, blocks_per_sm, grid, tiles):
  plan = K8.segment_plan(n, b, H100_SMS, blocks_per_sm)
  assert plan["route"] == "persistent"
  assert plan["grid"] == grid
  assert (plan["tiles"]["n x n"],
          plan["tiles"]["residual and codes"]) == tiles


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 2048), b=st.integers(1, 4096),
       sms=st.integers(1, 264), blocks_per_sm=st.integers(1, 16))
def test_the_grid_fits_the_card_and_the_largest_phase(n, b, sms,
                                                      blocks_per_sm):
  plan = K8.segment_plan(n, b, sms, blocks_per_sm)
  assert 1 <= plan["grid"] <= sms * blocks_per_sm
  assert plan["tiles"]["n x n"] <= plan["tiles"]["residual and codes"]
  assert plan["grid"] == min(sms * blocks_per_sm,
                             plan["tiles"]["residual and codes"])


def test_a_route_must_be_known():
  with pytest.raises(ValueError, match="route"):
    K8._route("graph")
  assert [K8._route(r) for r in K8.ROUTES] == ["persistent", "steps",
                                               "persistent"]


def _ragged_problem(seed, n=128, b=77, k=3, stale=1.0):
  """An orthogonal mixing matrix plus noise as the dictionary, its inverse
  (times ``stale``) as the seed, and unit-scale batches: b 77 is ragged
  against every tile of the kernel and the TPU's sublanes."""
  rng = np.random.RandomState(seed)
  d = (np.linalg.qr(rng.randn(n, n))[0]
       + 0.05 * rng.randn(n, n)).astype(np.float32)
  xi = (stale * np.linalg.inv(d.astype(np.float64))).astype(np.float32)
  x = (0.5 * rng.randn(k, b, n)).astype(np.float32)
  return d, xi, x


def _close(got, want, atol, what):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.1e)" % (what, err, atol))
  assert err <= atol, "%s: %.3e > %.1e" % (what, err, atol)


@pytest.mark.parametrize("upd,stale,boost_tol", [
    (1, 1.0, 1e-6), (3, 1.0, None), (1, 1.35, 1e-6)])
def test_k8_plain_matches_pallas_at_a_ragged_batch(upd, stale, boost_tol):
  d, xi, x = _ragged_problem(3, stale=stale)
  kw = dict(refine_iters=3, upd_num_iters=upd, boost_tol=boost_tol)
  want = jax_k8.fused_ica_train_segment_pallas(d, xi, x, 0.02,
                                               interpret=True, **kw)
  got = K8.fused_ica_train_segment(torch.from_numpy(d), torch.from_numpy(xi),
                                   torch.from_numpy(x), 0.02, **kw)
  for what, g, w, atol in zip(("D", "X", "residual"), got, want, LIMITS):
    _close(g.numpy(), np.asarray(w), atol,
           "K8 n 128 b 77 upd %d stale %g %s" % (upd, stale, what))
  if stale > 1.0:  # the boost fired and restored the floor
    assert float(got[2]) < 1e-6


@pytest.mark.parametrize("upd,stale", [(1, 1.0), (2, 1.35)])
def test_k18_plain_matches_pallas_at_a_ragged_batch(upd, stale):
  d, xi, x = _ragged_problem(4, stale=stale)
  kw = dict(refine_iters=3, upd_num_iters=upd, boost_tol=1e-6)

  def body(dd, xx, xs):
    return jax_k8.fused_ica_dp_train_segment_pallas(
        dd, xx, xs, jnp.float32(0.02), axis_name="data", axis_size=1,
        interpret=True, **kw)

  rep = PartitionSpec()
  mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "code"))
  want = jax.jit(jax.shard_map(
      body, mesh=mesh, in_specs=(rep, rep, PartitionSpec(None, "data", None)),
      out_specs=(rep,) * 3, check_vma=False))(d, xi, x)
  got = K8.fused_ica_dp_train_segment(
      torch.from_numpy(d), torch.from_numpy(xi), torch.from_numpy(x), 0.02,
      mesh=parallel.make_mesh(), **kw)
  for what, g, w, atol in zip(("D", "X", "residual"), got, want, LIMITS):
    _close(g.numpy(), np.asarray(w), atol,
           "K18 n 128 b 77 upd %d stale %g %s" % (upd, stale, what))


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the segment kernel has no CPU mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_ica_persistent_matches_steps_bitwise():
  """Both routes, forced, on the same inputs: the same bits of D, X and
  r_max (chip_smoke.py phase 40 runs the full set)."""
  dev = _cuda_device()
  for n, b, stale, step in ((256, 250, 1.0, 0.02), (200, 77, 1.35, 0.02),
                            (128, 77, 1.0, 40.0)):
    d, xi, x = (torch.from_numpy(a).to(dev)
                for a in _ragged_problem(5, n, b, 4, stale))
    runs = [K8._launch(d.clone(), xi.clone(), x, step, 3, 1, 1e-6,
                       route=route) for route in ("steps", "persistent")]
    for a, c in zip(*runs):
      assert torch.equal(a.view(torch.int32), c.view(torch.int32))


@pytest.mark.cuda
def test_cuda_ica_trainers_launch_the_segment_kernel():
  """The scanned ICA trainer launches ica_segment_kernel once a segment
  and none of the per-step kernels (chip_smoke.py phase 40 profiles it and
  its data-parallel twin)."""
  dev = _cuda_device()
  from torch.profiler import ProfilerActivity, profile

  from vtc_tpu_torch.training import ica
  d, _, x = _ragged_problem(6, 64, 50, 5)
  params = {"num_epochs": 1,
            "dictionary_update_algorithm": "ica_natural_gradient",
            "dict_update_param_schedule": {0: {"stepsize": 0.001,
                                               "num_iters": 1}},
            "refine_iters": 3, "stdout_print_interval": 5}
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    ica.train_dictionary_scanned(torch.from_numpy(x).to(dev),
                                 torch.from_numpy(d).to(dev), params)
    torch.cuda.synchronize()
  names = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
  assert sum("ica_segment_kernel" in nm for nm in names) == 1
  for old in ("gemm_kernel", "sign_kernel", "residual_kernel",
              "axpy_kernel"):
    assert not any("(anonymous namespace)::" + old in nm for nm in names), old
