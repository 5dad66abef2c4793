"""Fused ICA train steps over a segment: the port of TPU kernel K8,
``fused_ica_train_segment_pallas`` (vtc_tpu/ops/pallas_ica_train.py:
280-339, kernel ``_make_ica_kernel`` :101).

``fused_ica_train_segment`` keeps that function's contract and return
value ``(dictionary, inverse, max_residual)``.  Per batch of the (k, b, n)
segment: ``refine_iters`` Newton-Schulz refreshes of the tracked inverse
X, the residual max|D X - I| (with ``boost_tol``, two more refreshes when
it exceeds the tolerance), codes = batch X and ``upd_num_iters``
natural-gradient ascent steps D <- D + eta (codes^T sign(codes) / b - I) D.
``max_residual`` is the largest post-refinement residual of the segment,
NaN when a step's refinement diverged: the trainer's divergence guard
reads it (training/ica.py).

* A CUDA tensor runs the hand-written kernels of
  ``vtc_tpu_torch/csrc/fused_ica_train_step.cu`` (built at first use by
  ``ops/_build.py``) on the current stream, or raises: the whole segment
  as one cooperative launch of the persistent segment kernel
  (``csrc/ica_segment.cuh``), which a card that cannot hold its grid at
  once refuses (the wrapper then raises; there is no fallback).
* A CPU tensor runs ``fused_ica_train_plain``, the composition the JAX
  tests use as K8's reference (tests/test_pallas_ica_train.py:27-40):
  ``newton_refine_inverse`` -> the residual -> codes ->
  ``ica_natural_gradient._update``.  ``chip_smoke.py`` holds the kernels
  against it on the card.

``fused_ica_segment_supported`` keeps vtc_tpu's "square" and drops its
TPU rules, the 128-lane alignment of n and the VMEM budget (:86-98): the
card's kernels take any n and batch.  Left out: the TPU's ``interpret``,
which has no counterpart.  ``launches`` counts the train steps the kernels
ran, ``tier_launches`` those at a tier.

The tiers.  ``mxu`` 'bf16x5', 'bf16x3' and 'bf16' ('default' is 'bf16')
are vtc_tpu's ``_make_ns_dot`` (:57-83): the Newton-Schulz refreshes (the
boost's too) and the codes product split both operands into bf16 terms
per product and sum single-pass bf16 products (``ops/precision.ns_dot``,
the plain versions' product); the guard residual max|D X - I|, the
statistic and the update stay float32.  A CUDA tensor runs them on the
card's bf16 tensor cores (``csrc/ica_segment.cuh``'s tier tile, on both
routes, or raises); a CPU tensor the plain version at the tier.

Two routes give the same bits: 'persistent', the segment kernel, and
'steps', the per-step kernels enqueued from one C loop (about 20 launches
a step), kept as its bitwise reference.  The private ``route=`` of
``_launch`` / ``_launch_dp`` forces one ('auto' is 'persistent'; no public
entry point takes a route) and ``last_route`` names the route of the last
launch.  ``segment_plan`` and ``segment_phases`` mirror the segment
kernel's grid, tiles and barriers, so the CPU tests can pin them.

Also here, the port of TPU kernel K9, ``ica_solve_stats_pallas``
(vtc_tpu/ops/pallas_ica_train.py:226-274, kernel ``_make_ica_stats_kernel``
:189): ``ica_solve_stats``, one shard's step of the data-parallel
composition -- a K8 step's refreshes, residual and boost, the shard's
codes and its unaveraged statistic codes^T sign(codes), and no update.  A
CUDA tensor runs ``vtc_ica_solve_stats`` of the same source or raises; a
CPU tensor runs ``ica_solve_stats_plain``.  ``stats_launches`` counts the
steps that kernel ran.

And the port of TPU kernel K18, ``fused_ica_dp_train_segment_pallas``
(vtc_tpu/ops/pallas_ica_train.py:355-410, kernel ``_make_ica_kernel`` with
num_devices > 1, :101): ``fused_ica_dp_train_segment``, a rank's whole
data-parallel ICA segment with K8's contract ``(dictionary, inverse,
max_residual)``.  Per batch of this rank's (k, b_shard, n) segment: K9's
refreshes, residual and boost, the shard's codes and statistic, the
statistic's sum over the ranks of the port's ``parallel.Mesh``, and the
replicated update D += eta (stat / global_b - I) D, ``upd_num_iters``
times.  A CUDA tensor runs ``vtc_ica_dp_train_segment`` of the same
source, or raises: at a world of one the segment kernel, one launch; at a
world above one two launches of it a step, the statistic summed by the host
hook (``ops/sum_hook``) between the front (to the statistic) and the back
(the update).  A CPU tensor runs ``fused_ica_dp_train_plain``.
The largest residual stays on the device, NaN kept, for the trainer's lazy
guard, as K8's does.  ``fused_ica_dp_segment_supported`` is K8's and K9's
gate: vtc_tpu's comm slots and VMEM budget (:343-352) have no counterpart.
``dp_launches`` counts the train steps that kernel ran.  K9 and K18 take
K8's tiers; ``stats_tier_launches`` and ``dp_tier_launches`` count their
steps at a tier.
"""
import ctypes
import functools

import torch

from vtc_tpu_torch.analysis_transforms.fully_connected import (
    invertible_linear)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    ica_natural_gradient)
from vtc_tpu_torch.ops.precision import (TIER_CODES, matmul_precision,
                                         ns_dot, resolve_tier)
from vtc_tpu_torch.ops.sum_hook import SumHook

launches = 0
stats_launches = 0
dp_launches = 0
tier_launches = 0  # the steps of ``launches`` at a tier other than 'highest'
stats_tier_launches = 0  # ... of ``stats_launches``
dp_tier_launches = 0  # ... of ``dp_launches``
last_route = None  # 'persistent' or 'steps': the route of the last launch

ROUTES = ("auto", "steps", "persistent")
# ica_segment.cuh's layout (kSegTileM, kSegTileN, kSegSlice, kSegThreads);
# chip_smoke.py checks them against the library's
SEG_TILE_M, SEG_TILE_N, SEG_SLICE, SEG_THREADS = 32, 16, 32, 128


def segment_tiles(m, n):
  """Output tiles of an (m, n) product on the segment kernel."""
  return -(-m // SEG_TILE_M) * -(-n // SEG_TILE_N)


def segment_phases(refine_iters, upd_num_iters, boosted):
  """Grid barriers in one step of the segment kernel (seg_step_phases):
  two a refresh, the residual and codes phase, the statistic, one an
  update, and five more when the boost fires."""
  return (2 * refine_iters + 2 + upd_num_iters + (5 if boosted else 0))


def segment_plan(n, b, sm_count, blocks_per_sm):
  """The launch 'auto' makes for an (n, n) dictionary and batches of b
  on a card of sm_count SMs that holds blocks_per_sm segment CTAs an SM:
  the route ('persistent' for every shape: the kernel masks any n and b
  and loops where a phase's tiles outnumber its CTAs), its grid (every
  CTA the card holds at once, but no more than the largest phase has
  tiles), and the tiles of an n x n phase and of the residual and codes
  phase, whose tile pairs rows of D X with the same rows of batch X over
  the same columns (seg_pair_tiles)."""
  tiles = {"n x n": segment_tiles(n, n),
           "residual and codes": segment_tiles(max(n, b), n)}
  grid = min(sm_count * blocks_per_sm, tiles["residual and codes"])
  return {"route": "persistent", "grid": grid, "tiles": tiles}


def fused_ica_segment_supported(n, batch_size, num_atoms=None):
  """True when the fused ICA kernels take this geometry: a square
  dictionary (``num_atoms`` rows, n when not given) and a batch."""
  return (int(n) >= 1 and int(batch_size) >= 1
          and (num_atoms is None or int(num_atoms) == int(n)))


def _refine_boosted(d, x, refine_iters, boost_tol, mxu, precision):
  """A step's refreshes at the tier, the residual and the boost (selected
  with ``torch.where``, so the host never waits): (X, residual)."""
  x = invertible_linear.newton_refine_tier(d, x, refine_iters, mxu,
                                           precision)
  res = invertible_linear.inverse_residual(d, x)
  if boost_tol is not None:
    x_b = invertible_linear.newton_refine_tier(d, x, 2, mxu, precision)
    res_b = invertible_linear.inverse_residual(d, x_b)
    boosted = res > boost_tol  # NaN > tol is False: no boost
    x = torch.where(boosted, x_b, x)
    res = torch.where(boosted, res_b, res)
  return x, res


def fused_ica_train_plain(dictionary, inverse_estimate, batches, stepsize, *,
                          refine_iters=5, upd_num_iters=1, boost_tol=None,
                          precision=None, mxu="highest"):
  """The plain PyTorch version of the fused ICA segment, on any device and
  in the inputs' own float type.  ``mxu`` is the tier of the refreshes and
  the codes product (``ns_dot``; float32 inputs); at 'highest' they run at
  the matmul ``precision`` (default 'highest'; 'tensorfloat32' shows what
  TF32 products would cost).  The residual, the statistic and the update
  stay at 'highest'."""
  d, x = dictionary, inverse_estimate
  r_max = torch.zeros((), dtype=d.dtype, device=d.device)
  for batch in batches:
    x, res = _refine_boosted(d, x, refine_iters, boost_tol, mxu, precision)
    r_max = torch.maximum(r_max, res)  # keeps NaN
    codes = ns_dot(batch, x, mxu, precision)
    d = ica_natural_gradient._update(d, codes, stepsize, upd_num_iters)
  return d, x, r_max


def _require(cond, message):
  if not cond:
    raise ValueError("fused_ica_train_segment: " + message)


def fused_ica_train_segment(dictionary, inverse_estimate, batches, stepsize,
                            *, refine_iters=5, upd_num_iters=1,
                            mxu="highest", boost_tol=None):
  """Run ``batches.shape[0]`` fused ICA train steps.

  Args:
    dictionary, inverse_estimate: (n, n) float32 tensors.
    batches: (k, b, n) float32, k >= 1.
    stepsize: the ascent stepsize, a Python float.
    refine_iters / upd_num_iters / boost_tol: as in vtc_tpu.
    mxu: the tier of the refreshes and the codes (module docstring).

  Returns:
    (dictionary, inverse, max_residual): new tensors, the inputs are not
    modified; max_residual is 0-d.
  """
  tier = resolve_tier(mxu)
  _require(batches.dim() == 3 and batches.shape[0] >= 1,
           "batches must be (k, b, n) with k >= 1, got %s"
           % (tuple(batches.shape),))
  k, b, n = batches.shape
  _require(fused_ica_segment_supported(n, b, dictionary.shape[0])
           and tuple(dictionary.shape) == (n, n),
           "dictionary must be square (%d, %d), got %s"
           % (n, n, tuple(dictionary.shape)))
  if batches.device.type == "cpu":
    return fused_ica_train_plain(
        dictionary, inverse_estimate, batches, float(stepsize),
        refine_iters=int(refine_iters), upd_num_iters=int(upd_num_iters),
        boost_tol=None if boost_tol is None else float(boost_tol), mxu=tier)
  _require(batches.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(batches.device))
  device = batches.device
  for name, t in (("dictionary", dictionary),
                  ("inverse_estimate", inverse_estimate)):
    _require(t.device == device and t.dtype == torch.float32
             and tuple(t.shape) == (n, n),
             "%s must be a float32 (%d, %d) tensor on %s"
             % (name, n, n, device))
  _require(batches.dtype == torch.float32, "batches must be float32")
  _require(int(refine_iters) >= 0 and int(upd_num_iters) >= 0,
           "iteration counts must be >= 0")
  return _launch(dictionary.contiguous().clone(),
                 inverse_estimate.contiguous().clone(), batches.contiguous(),
                 float(stepsize), int(refine_iters), int(upd_num_iters),
                 boost_tol, tier)


def _launch(d, x, batches, stepsize, refine_iters, upd_num_iters,
            boost_tol, tier="highest", route="auto", grid=0):
  """Allocate the scratch and enqueue the k steps on the current stream at
  the tier.  route 'steps' or 'persistent' forces a route and grid a
  persistent launch's CTA count (for checks and tools; 0: the shape's
  own)."""
  global launches, last_route, tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  device = batches.device
  route = _route(route)
  r_max = torch.zeros((), dtype=torch.float32, device=device)
  if route == "persistent":
    err = _persistent(lib, d, x, r_max, batches, stepsize, refine_iters,
                      upd_num_iters, boost_tol, float(b), None, None, grid,
                      tier)
  else:
    eye, eye2 = _identities(n, device)
    x_alt, e, stat, m, p = (_empty(device, n, n) for _ in range(5))
    codes, sgn = _empty(device, b, n), _empty(device, b, n)
    boost = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
      stream = torch.cuda.current_stream(device).cuda_stream
      err = lib.vtc_ica_train_segment(
          d.data_ptr(), x.data_ptr(), r_max.data_ptr(), batches.data_ptr(),
          eye.data_ptr(), eye2.data_ptr(), k, b, n, ctypes.c_float(stepsize),
          refine_iters, upd_num_iters, int(boost_tol is not None),
          ctypes.c_float(0.0 if boost_tol is None else boost_tol),
          x_alt.data_ptr(), e.data_ptr(), codes.data_ptr(), sgn.data_ptr(),
          stat.data_ptr(), m.data_ptr(), p.data_ptr(), boost.data_ptr(),
          TIER_CODES[tier], stream)
  if err != 0:
    raise RuntimeError(
        "fused ICA train step launch failed with CUDA error %d (k=%d, b=%d, "
        "n=%d, route %s, tier %s)" % (err, k, b, n, route, tier))
  launches += k
  if tier != "highest":
    tier_launches += k
  last_route = route
  return d, x, r_max


def _route(route):
  if route not in ROUTES:
    raise ValueError("route must be one of %s, got %r" % (ROUTES, route))
  return "persistent" if route == "auto" else route


def _empty(device, *shape):
  return torch.empty(shape, dtype=torch.float32, device=device)


def _persistent(lib, d, x, r_max, batches, stepsize, refine_iters,
                upd_num_iters, boost_tol, stat_div, stat, hook_pointer, grid,
                tier):
  """Enqueue a segment on the persistent route (vtc_ica_persistent_segment)
  on the current stream at the tier: d, x and r_max in place, stat (n, n)
  the raw statistic that a front launch leaves for the hook (K18's comm;
  None without a hook, where every launch also updates), grid CTAs (0: the
  shape's own); returns the C entry's error code."""
  k, b, n = batches.shape
  device = batches.device
  with torch.cuda.device(device):
    slots = grid or lib.vtc_ica_segment_grid(n, b)
    d_alt, x_alt, e = (_empty(device, n, n) for _ in range(3))
    codes, partials = _empty(device, b, n), _empty(device, max(slots, 1))
    barrier = torch.zeros(1, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    return lib.vtc_ica_persistent_segment(
        d.data_ptr(), x.data_ptr(), r_max.data_ptr(), batches.data_ptr(), k,
        b, n, ctypes.c_float(stepsize), refine_iters, upd_num_iters,
        int(boost_tol is not None),
        ctypes.c_float(0.0 if boost_tol is None else boost_tol),
        ctypes.c_float(stat_div), d_alt.data_ptr(), x_alt.data_ptr(),
        e.data_ptr(), codes.data_ptr(),
        None if stat is None else stat.data_ptr(), partials.data_ptr(),
        barrier.data_ptr(), grid, hook_pointer, TIER_CODES[tier], stream)


def ica_solve_stats_plain(dictionary, inverse_estimate, batch, *,
                          refine_iters=5, boost_tol=None, precision=None,
                          mxu="highest"):
  """The plain PyTorch version of ``ica_solve_stats``, on any device and in
  the inputs' own float type: the refreshes -> the residual (the boost
  selected with ``torch.where``) -> codes -> the statistic.  ``mxu`` and
  ``precision`` as ``fused_ica_train_plain``'s; the residual and the
  statistic stay at 'highest'."""
  d = dictionary
  x, res = _refine_boosted(d, inverse_estimate, refine_iters, boost_tol, mxu,
                           precision)
  codes = ns_dot(batch, x, mxu, precision)
  with matmul_precision():
    stat = codes.T @ torch.sign(codes)
  return x, stat, res


def ica_solve_stats(dictionary, inverse_estimate, batch, *, refine_iters=5,
                    mxu="highest", boost_tol=None):
  """One shard's ICA step: the refreshed inverse, the shard's unaveraged
  natural-gradient statistic and the post-refinement residual.

  Args:
    dictionary, inverse_estimate: (n, n) float32 tensors (replicated).
    batch: (b, n) float32, this shard of the batch.
    refine_iters / boost_tol: as in vtc_tpu.
    mxu: the tier of the refreshes and the codes, as K8's.

  Returns:
    (new_inverse (n, n), stat_sum (n, n), residual 0-d): new tensors.  The
    sum of stat_sum over the shards, over global_b, is the single-device
    batch-mean statistic; the inverse and the residual depend on the
    replicated dictionary alone and are the same on every shard.
  """
  tier = resolve_tier(mxu)

  def require(cond, message):
    if not cond:
      raise ValueError("ica_solve_stats: " + message)

  require(batch.dim() == 2, "batch must be (b, n), got %s"
          % (tuple(batch.shape),))
  b, n = batch.shape
  require(fused_ica_segment_supported(n, b, dictionary.shape[0])
          and tuple(dictionary.shape) == (n, n),
          "dictionary must be square (%d, %d), got %s"
          % (n, n, tuple(dictionary.shape)))
  boost_tol = None if boost_tol is None else float(boost_tol)
  if batch.device.type == "cpu":
    return ica_solve_stats_plain(dictionary, inverse_estimate, batch,
                                 refine_iters=int(refine_iters),
                                 boost_tol=boost_tol, mxu=tier)
  require(batch.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batch.device))
  device = batch.device
  for name, t in (("dictionary", dictionary),
                  ("inverse_estimate", inverse_estimate)):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == (n, n),
            "%s must be a float32 (%d, %d) tensor on %s"
            % (name, n, n, device))
  require(batch.dtype == torch.float32, "batch must be float32")
  require(int(refine_iters) >= 0, "refine_iters must be >= 0")
  return _launch_stats(dictionary.contiguous(),
                       inverse_estimate.contiguous().clone(),
                       batch.contiguous(), int(refine_iters), boost_tol, tier)


@functools.lru_cache(maxsize=4)
def _identities(n, device):
  """(I, 2I) on ``device``, once per size: a step allocates neither."""
  eye = torch.eye(n, dtype=torch.float32, device=device)
  return eye, 2.0 * eye


def _launch_stats(d, x, batch, refine_iters, boost_tol, tier):
  """Allocate the outputs and scratch, enqueue the step on the current
  stream at the tier."""
  global stats_launches, stats_tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  b, n = batch.shape
  device = batch.device
  eye, eye2 = _identities(n, device)
  res = torch.zeros((), dtype=torch.float32, device=device)
  x_alt, e, stat = (_empty(device, n, n) for _ in range(3))
  codes, sgn = _empty(device, b, n), _empty(device, b, n)
  boost = torch.zeros(1, dtype=torch.int32, device=device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_ica_solve_stats(
        d.data_ptr(), x.data_ptr(), res.data_ptr(), batch.data_ptr(),
        eye.data_ptr(), eye2.data_ptr(), b, n, refine_iters,
        int(boost_tol is not None),
        ctypes.c_float(0.0 if boost_tol is None else boost_tol),
        x_alt.data_ptr(), e.data_ptr(), codes.data_ptr(), sgn.data_ptr(),
        stat.data_ptr(), boost.data_ptr(), TIER_CODES[tier], stream)
  if err != 0:
    raise RuntimeError(
        "ICA solve+stats launch failed with CUDA error %d (b=%d, n=%d, tier "
        "%s)" % (err, b, n, tier))
  stats_launches += 1
  if tier != "highest":
    stats_tier_launches += 1
  return x, stat, res


def fused_ica_dp_segment_supported(n, batch_shard_size, num_atoms=None):
  """True when ``fused_ica_dp_train_segment`` takes this geometry: K8's and
  K9's gate, a square dictionary and a shard.  vtc_tpu's ``num_devices``
  (its comm-slot count) bounds nothing on the card."""
  return fused_ica_segment_supported(n, batch_shard_size, num_atoms)


def fused_ica_dp_train_plain(dictionary, inverse_estimate, batches,
                             stepsize, *, mesh, refine_iters=5,
                             upd_num_iters=1, boost_tol=None,
                             precision=None, mxu="highest"):
  """The plain PyTorch version of the data-parallel segment, on any device
  and in the inputs' own float type: per batch K9's plain version, the sum
  of the statistic over ``mesh`` and the replicated update; the running
  residual maximum keeps NaN.  ``mxu`` and ``precision`` as
  ``fused_ica_train_plain``'s."""
  d, x = dictionary, inverse_estimate
  r_max = torch.zeros((), dtype=d.dtype, device=d.device)
  for batch in batches:
    x, stat, res = ica_solve_stats_plain(
        d, x, batch, refine_iters=refine_iters, boost_tol=boost_tol,
        precision=precision, mxu=mxu)
    stat = mesh.sum(stat) / (batch.shape[0] * mesh.size)
    d = ica_natural_gradient._update_from_stat(d, stat, stepsize,
                                               upd_num_iters)
    r_max = torch.maximum(r_max, res)  # keeps NaN
  return d, x, r_max


def fused_ica_dp_train_segment(dictionary, inverse_estimate, batches,
                               stepsize, *, mesh, refine_iters=5,
                               upd_num_iters=1, mxu="highest",
                               boost_tol=None):
  """Run ``batches.shape[0]`` data-parallel ICA train steps on this rank.

  Every rank of ``mesh`` calls it in step, with the same replicated state
  and its own shard of every batch.

  Args:
    dictionary, inverse_estimate: (n, n) float32 tensors, replicated.
    batches: (k, b_shard, n) float32, this rank's shards, k >= 1.
    stepsize: the ascent stepsize, a Python float.
    mesh: the ``parallel.Mesh`` the ranks share.
    refine_iters / upd_num_iters / boost_tol: as in vtc_tpu.
    mxu: the tier of the refreshes and the codes, as K8's.

  Returns:
    (dictionary, inverse, max_residual): new tensors, replicated; the
    inputs are not modified; max_residual is 0-d, the same on every rank.
  """
  tier = resolve_tier(mxu)

  def require(cond, message):
    if not cond:
      raise ValueError("fused_ica_dp_train_segment: " + message)

  require(batches.dim() == 3 and batches.shape[0] >= 1,
          "batches must be (k, b_shard, n) with k >= 1, got %s"
          % (tuple(batches.shape),))
  k, b, n = batches.shape
  require(fused_ica_dp_segment_supported(n, b, dictionary.shape[0])
          and tuple(dictionary.shape) == (n, n),
          "dictionary must be square (%d, %d), got %s"
          % (n, n, tuple(dictionary.shape)))
  boost_tol = None if boost_tol is None else float(boost_tol)
  if batches.device.type == "cpu":
    return fused_ica_dp_train_plain(
        dictionary, inverse_estimate, batches, float(stepsize), mesh=mesh,
        refine_iters=int(refine_iters), upd_num_iters=int(upd_num_iters),
        boost_tol=boost_tol, mxu=tier)
  require(batches.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batches.device))
  device = batches.device
  for name, t in (("dictionary", dictionary),
                  ("inverse_estimate", inverse_estimate)):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == (n, n),
            "%s must be a float32 (%d, %d) tensor on %s"
            % (name, n, n, device))
  require(batches.dtype == torch.float32, "batches must be float32")
  require(int(refine_iters) >= 0 and int(upd_num_iters) >= 0,
          "iteration counts must be >= 0")
  return _launch_dp(dictionary.contiguous().clone(),
                    inverse_estimate.contiguous().clone(),
                    batches.contiguous(), mesh, float(stepsize),
                    int(refine_iters), int(upd_num_iters), boost_tol, tier)


def _launch_dp(d, x, batches, mesh, stepsize, refine_iters, upd_num_iters,
               boost_tol, tier="highest", route="auto", grid=0):
  """Allocate the scratch and the statistic's buffer, and enqueue the k
  steps on the current stream at the tier, the sum over the ranks between
  each step's statistic and its update.  route and grid as
  ``_launch``'s."""
  global dp_launches, last_route, dp_tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  device = batches.device
  route = _route(route)
  r_max = torch.zeros((), dtype=torch.float32, device=device)
  comm = _empty(device, n, n)
  hook = SumHook(mesh, comm.view(-1))
  if route == "persistent":
    err = _persistent(lib, d, x, r_max, batches, stepsize, refine_iters,
                      upd_num_iters, boost_tol, float(b * mesh.size), comm,
                      hook.pointer, grid, tier)
  else:
    eye, eye2 = _identities(n, device)
    x_alt, e, m, p = (_empty(device, n, n) for _ in range(4))
    codes, sgn = _empty(device, b, n), _empty(device, b, n)
    boost = torch.zeros(1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
      stream = torch.cuda.current_stream(device).cuda_stream
      err = lib.vtc_ica_dp_train_segment(
          d.data_ptr(), x.data_ptr(), r_max.data_ptr(), batches.data_ptr(),
          eye.data_ptr(), eye2.data_ptr(), k, b, n, ctypes.c_float(stepsize),
          refine_iters, upd_num_iters, int(boost_tol is not None),
          ctypes.c_float(0.0 if boost_tol is None else boost_tol),
          ctypes.c_float(b * mesh.size), x_alt.data_ptr(), e.data_ptr(),
          codes.data_ptr(), sgn.data_ptr(), m.data_ptr(), p.data_ptr(),
          boost.data_ptr(), comm.data_ptr(), hook.pointer, TIER_CODES[tier],
          stream)
  hook.check(err, "data-parallel ICA segment launch (k=%d, b=%d, n=%d, "
             "route %s, tier %s)" % (k, b, n, route, tier))
  dp_launches += k
  if tier != "highest":
    dp_tier_launches += k
  last_route = route
  return d, x, r_max
