"""Fused fc ISTA/FISTA solve: the port of TPU kernel K1,
``fista_solve_pallas`` (vtc_tpu/ops/pallas_fista.py:156-241).

``fused_fista_solve`` keeps that function's contract.  It computes
G = D D^T and c = X D^T with ``torch.matmul`` under the precision pins,
outside the kernel, exactly where the JAX package computes them outside
its kernel (pallas_fista.py:196-198).  Then:

* a CUDA tensor launches the hand-written kernel in
  ``vtc_tpu_torch/csrc/fused_fista.cu`` (built at first use by
  ``ops/_build.py``) on the current stream, or raises;
* a CPU tensor runs ``fused_fista_plain``, the plain PyTorch version of
  the same iteration, which the CPU tests use and which ``chip_smoke.py``
  holds the kernel against on the card.  It is also the 'gram'
  formulation of ``ista_fista.run``: one loop serves both.

The library has three solve kernels with the same bits (csrc/
fista_core.cuh): the classic layout, one block per 16 rows with G
streamed from L2; a thread-block-cluster layout for small batches, 8
CTAs per cluster with G resident in shared memory; and the wide cluster
layout for batches that fill the card, the fewest CTAs a cluster whose
G slices fit (2 at s 256) and 8 x 4 outputs a thread.
``solve_route`` is the C route's rule in Python, and ``cluster_rows``,
``cluster_layout``, ``wide_cluster``, ``wide_rows`` and ``wide_layout``
the layouts, so the CPU tests can pin them; ``last_route`` is the route
of the last launch.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test
(pallas_fista.py:107-130) inside the kernels, on every batch size: the
cluster or wide kernel's stop build where its grid is one resident wave,
else the classic kernel launched an iteration at a time, which decides
on the device (csrc/fista_core.cuh, "The early stop").  ``stop_route``
and ``stop_words`` mirror that route and the size of its device array;
``last_iters`` (a private test hook) is the device tensor of the
iterations the last stopped launch ran.

``mxu`` is vtc_tpu's tier of the iteration product ('highest', 'bf16x5',
'bf16x3', 'bf16' or its spelling 'default'; pallas_fista.py:44-56).
'highest' takes the three fp32 kernels above.  Every other tier takes one
of three bf16 tensor-core routes with the same bits (csrc/fista_tier.cuh):
'tier_cluster' and 'tier_wide', the resident layout (-eta G's bf16 planes
in shared memory, z's terms pushed over distributed shared memory, one
cluster barrier an iteration, the stop in the same launch) for small
batches and for batches that fill the card, where s is a multiple of 16
and the group size is 1, 2 or 4; else 'tier', ``fista_tier_kernel``
(one CTA per 16 rows, the planes streamed from L2, the stop on the
classic stop route, an iteration a launch), which is also the route of
a stop across ranks.  ``tier_route`` and ``tier_plan`` mirror the rule
and the layout (``tier_layout``, ``tier_max_rows``, ``tier_shape``).  On
the CPU ``fused_fista_plain`` computes the same passes
(``precision.tier_dot``); ``solve_scratch`` sizes the tier kernel's
scratch from the library's own rule.  ``launches`` counts kernel
launches; ``route_launches`` reads the library's count of the solves each
route took, the trainers' among them.
"""
import ctypes

import torch

from vtc_tpu_torch.ops import thresholds
from vtc_tpu_torch.ops.precision import (TIER_CODES, bf16_pass,
                                         matmul_precision, resolve_tier,
                                         tier_dot, tier_operand)
from vtc_tpu_torch.ops.solver import proximal_gradient_loop

launches = 0
tier_launches = 0  # the launches above at a tier other than 'highest'
last_route = None  # the last launch's route: a name of ROUTES
last_iters = None  # int32 device tensor: the last stopped launch's count

# shared memory a block may opt into on Hopper (sm_90): 227 KB
_SMEM_PER_BLOCK = 232448
# fista_core.cuh's layout constants (kRows, kChunk, kCluster,
# kClusterMaxRows, kClusterMaxThreads); chip_smoke.py checks them against
# the library's
ROWS, CHUNK, CLUSTER, CLUSTER_MAX_ROWS, CLUSTER_MAX_THREADS = (
    16, 32, 8, 32, 512)
# fista_core.cuh's wide layout constants (kWideRowsPerThread,
# kWideMaxThreads, kWideMinThreads, kWideMaxCluster)
(WIDE_ROWS_PER_THREAD, WIDE_MAX_THREADS, WIDE_MIN_THREADS,
 WIDE_MAX_CLUSTER) = (8, 256, 128, 8)
# fista_core.cuh's early-stop constants (kStopLaneWords, kStopCtlWords)
STOP_LANE_WORDS, STOP_CTL_WORDS = 8, 3
# the C entries' route argument at 'highest' and at the other tiers, and
# the route names of their taken value (fista_core.cuh's Route); a route
# other than 'auto' forces one, for checks and tools
ROUTES = {"auto": 0, "classic": 1, "cluster": 2, "wide": 3}
TIER_ROUTE_CODES = {"tier": 4, "tier_cluster": 5, "tier_wide": 6}
ROUTE_NAMES = {v: k for k, v in (ROUTES | TIER_ROUTE_CODES).items() if v}
TIER_ROUTES = tuple(TIER_ROUTE_CODES)
# fista_tier.cuh's resident layout constants (kTierUnit, kTierMaxWarps,
# kTierMaxCluster)
TIER_UNIT, TIER_MAX_WARPS, TIER_MAX_CLUSTER = 16, 16, 8
# the kernel's shrink modes, indexed by (nonneg, hard)
_MODES = {(False, False): 0, (True, False): 1, (False, True): 2,
          (True, True): 3}


def fused_fista_plain(images, dictionary, sparsity_weight, num_iters,
                      stepsize, *, initial_codes=None, variant="fista",
                      nonneg=False, hard=False, early_stopping_epsilon=None,
                      precision=None, psum_axes=None,
                      stop_count=None, mxu="highest", bf16_corr=False):
  """The plain PyTorch version of the fused solve, on any device and in
  the inputs' own float type (float64 inputs give the float64 oracle).

  The gram loop of ``ops/solver.proximal_gradient_loop`` with the
  stepsize folded in, the association of the kernel and
  pallas_fista.py:94-105:
  codes = shrink((z + z @ (-eta G)) + eta c, lam * eta).
  ``early_stopping_epsilon`` is the loop's batch-global stop test, over
  ``psum_axes``'s ranks and as ``stop_count``'s sum (ops/solver) where
  given.
  ``precision`` is the matmul precision of ``ops/precision`` (default
  'highest'); 'tensorfloat32' shows what TF32 products would cost.
  ``mxu`` is the iteration product's tier (``precision.tier_dot``: bf16
  passes summed in float32, as vtc_tpu's ``_make_iter_dot``), and
  ``bf16_corr`` computes c = X D^T as one bf16 pass, as the trainers do
  at 'bf16'; G, c otherwise, and the rest of the loop stay float32.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  mxu = resolve_tier(mxu)
  dtype, device = images.dtype, images.device
  shrink = thresholds.select(bool(nonneg), bool(hard))
  eta = torch.as_tensor(stepsize, dtype=dtype, device=device)
  if initial_codes is None:
    z = torch.zeros((images.shape[0], dictionary.shape[0]), dtype=dtype,
                    device=device)
  else:
    z = torch.as_tensor(initial_codes, dtype=dtype, device=device)
  with matmul_precision(precision):
    neg_eta_gram = -eta * (dictionary @ dictionary.T)
    corr = (bf16_pass(images, dictionary) if bf16_corr
            else images @ dictionary.T)
    corr_eta = eta * corr
    operand = tier_operand(neg_eta_gram, mxu)

    def prestep_fn(z):
      if mxu == "highest":
        return z + z @ neg_eta_gram + corr_eta
      return z + tier_dot(z, operand, mxu) + corr_eta

    def prox_fn(x, ss):
      return shrink(x, sparsity_weight * ss)

    return proximal_gradient_loop(
        None, prox_fn, z, eta, num_iters, variant=variant,
        early_stopping_epsilon=early_stopping_epsilon,
        prestep_fn=prestep_fn, psum_axes=psum_axes,
        stop_count=stop_count)


def _require(cond, message):
  if not cond:
    raise ValueError("fused_fista_solve: " + message)


def fused_fista_solve(images, dictionary, sparsity_weight, num_iters,
                      stepsize, *, initial_codes=None, variant="fista",
                      nonneg=False, hard=False, early_stopping_epsilon=None,
                      mxu="highest"):
  """Solve the LASSO codes of a batch with the fused kernel.

  Args:
    images: (b, n) float32 tensor.
    dictionary: (s, n) float32 tensor on the same device.
    sparsity_weight: lambda, a Python float.
    num_iters: iterations, a Python int (a runtime argument of the
      kernel: changing it rebuilds nothing).
    stepsize: 1/L, a float or a one-element tensor; a device tensor is
      read by the kernel itself, so the host never waits for it.
    initial_codes: optional (b, s) warm start (seeds z and old).
    variant / nonneg / hard: 'ista' | 'fista', threshold flags.
    early_stopping_epsilon: optional; stop after the first iteration k > 0
      whose mean |codes_k - codes_{k-1}| / stepsize is below it, and
      return codes_k (the batch-global test, decided on the device).
    mxu: the iteration product's tier, 'highest' (fp32), 'bf16x5',
      'bf16x3' or 'bf16' ('default' is 'bf16', as vtc_tpu's K1 reads it).

  Returns:
    (b, s) codes on the inputs' device.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  mxu = resolve_tier(mxu)
  if images.device.type == "cpu":
    return fused_fista_plain(
        images, dictionary, sparsity_weight, num_iters, stepsize,
        initial_codes=initial_codes, variant=variant, nonneg=nonneg,
        hard=hard, early_stopping_epsilon=early_stopping_epsilon, mxu=mxu)
  _require(images.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(images.device))
  device = images.device
  _require(dictionary.device == device, "dictionary on another device")
  _require(images.dtype == torch.float32
           and dictionary.dtype == torch.float32, "inputs must be float32")
  _require(images.dim() == 2 and dictionary.dim() == 2
           and images.shape[1] == dictionary.shape[1],
           "shapes must be (b, n) and (s, n), got %s and %s"
           % (tuple(images.shape), tuple(dictionary.shape)))
  b, s = images.shape[0], dictionary.shape[0]
  _require(s > 0, "dictionary has no rows")
  if initial_codes is not None:
    _require(initial_codes.device == device
             and initial_codes.dtype == torch.float32
             and tuple(initial_codes.shape) == (b, s)
             and initial_codes.is_contiguous(),
             "initial_codes must be a contiguous float32 (b, s) tensor on "
             "the inputs' device")
  num_iters = int(num_iters)
  _require(num_iters >= 0, "num_iters must be >= 0")
  eta = torch.as_tensor(stepsize, dtype=torch.float32, device=device)
  _require(eta.numel() == 1, "stepsize must be a scalar")
  eta = eta.reshape(1).contiguous()
  if b == 0:
    return torch.empty((0, s), dtype=torch.float32, device=device)

  with matmul_precision():
    gram = (dictionary @ dictionary.T).contiguous()
    corr = (images @ dictionary.T).contiguous()
  return _launch(gram, corr, initial_codes, eta, float(sparsity_weight),
                 num_iters, variant == "fista",
                 _MODES[(bool(nonneg), bool(hard))],
                 eps=early_stopping_epsilon, mxu=mxu)


def solve_layout(lib, s):
  """(sk, sc, state_in_smem) of the solve kernel for s codes: the padded
  depth and width of G, and whether a block's state (z twice, old and
  eta*c, kRows rows each) fits its shared memory beside the G ring."""
  chunk, col_block = lib.vtc_fista_chunk(), lib.vtc_fista_col_block()
  sk = -(-s // chunk) * chunk
  sc = -(-s // col_block) * col_block
  state_bytes = 4 * lib.vtc_fista_rows() * sk * 4
  return sk, sc, (lib.vtc_fista_slice_bytes() + state_bytes
                  <= _SMEM_PER_BLOCK)


# vtc_tpu's single-tile early-stop budget (pallas_fista.py:134-149): its
# lanes, sublanes and VMEM bytes
_TPU_LANES, _TPU_SUBLANES, _EARLY_STOP_VMEM_BUDGET = 128, 8, 12 * 1024 * 1024


def early_stop_tile_fits(batch_size, code_size):
  """vtc_tpu's ``early_stop_tile_fits`` (pallas_fista.py:139-149): whether
  its K1 takes the early stop in-kernel, the whole batch in one VMEM tile.
  The port's solvers read it for a tier with a stop: where it fails,
  vtc_tpu solves at full precision (fully_connected/ista_fista.py:121-139),
  and so does the port."""
  s_pad = -(-int(code_size) // _TPU_LANES) * _TPU_LANES
  b_pad = -(-int(batch_size) // _TPU_SUBLANES) * _TPU_SUBLANES
  return 4 * (s_pad * s_pad + 6 * b_pad * s_pad) <= _EARLY_STOP_VMEM_BUDGET


def solve_scratch(lib, b, s, mxu, classic, device):
  """(sk, sc, gn, state) of a solve of b rows of s codes at tier mxu: the
  padded depth and width, the scratch of -eta G (fp32 (sk, sc) at
  'highest', else the tier kernel's bf16 planes) and the blocks' state in
  global memory, or None where it fits shared memory and the route
  (``classic``: the classic stop route, which keeps it global) allows."""
  rows = lib.vtc_fista_rows()
  sk, sc, state_in_smem = solve_layout(lib, s)
  if mxu == "highest":
    gn = torch.empty((sk, sc), dtype=torch.float32, device=device)
  else:
    code = TIER_CODES[mxu]
    gn = torch.empty(int(lib.vtc_fista_tier_gn_floats(s, code)),
                     dtype=torch.float32, device=device)
    state_in_smem = bool(lib.vtc_fista_tier_state_in_smem(s, code))
  state = (None if state_in_smem and not classic else
           torch.empty((-(-b // rows), 4, rows, sk), dtype=torch.float32,
                       device=device))
  return sk, sc, gn, state


def cluster_layout(s, group_size, rows):
  """The cluster kernel's layout for s codes in groups of group_size (1:
  elementwise) at rows batch rows per cluster, as fista_core.cuh's
  cluster_layout: the padded depth sk, w columns per CTA, threads per
  CTA (one per row pair and four columns) and the dynamic shared memory
  in bytes."""
  sk = -(-s // CHUNK) * CHUNK
  w = sk // CLUSTER
  floats = sk * w + 2 * rows * (sk + 4)
  if 4 % group_size and w % group_size == 0:  # the shared-memory prox pass
    floats += rows * w + rows * (w // group_size)
  return dict(sk=sk, w=w, threads=rows // 2 * (w // 4), smem=4 * floats)


def cluster_max_rows(s, group_size):
  """The most rows (even, at most CLUSTER_MAX_ROWS) a cluster takes within
  a block's thread and shared-memory budgets, or 0 where a group would
  cross two CTAs' columns or not even two rows fit
  (fista_core.cuh's cluster_max_rows)."""
  sk = -(-s // CHUNK) * CHUNK
  if group_size < 1 or (sk // CLUSTER) % group_size:
    return 0
  for rows in range(CLUSTER_MAX_ROWS, 1, -2):
    lay = cluster_layout(s, group_size, rows)
    if (lay["threads"] <= CLUSTER_MAX_THREADS
        and lay["smem"] <= _SMEM_PER_BLOCK):
      return rows
  return 0


def cluster_rows(b, s, group_size, slots):
  """Rows per cluster for a batch of b on a card that holds slots
  clusters at one CTA per SM: the batch spread over the slots, even,
  within cluster_max_rows (fista_core.cuh's cluster_rows)."""
  per_slot = -(-b // max(slots, 1))
  rows = max(2, -(-per_slot // 2) * 2)
  return min(rows, cluster_max_rows(s, group_size))


def cluster_grid(b, rows):
  """CTAs of a cluster launch: CLUSTER per rows batch rows."""
  return -(-b // rows) * CLUSTER


def wide_layout(s, cluster, rows):
  """The wide kernel's layout for s codes in clusters of `cluster` CTAs at
  rows batch rows per cluster, as fista_core.cuh's wide_layout: the
  padded depth sk, w columns per CTA, threads per CTA (one per 8 rows and
  4 columns) and the dynamic shared memory in bytes (the G slice and two
  z buffers of rows x (sk + 4))."""
  sk = -(-s // CHUNK) * CHUNK
  w = sk // cluster
  return dict(sk=sk, w=w, threads=rows // WIDE_ROWS_PER_THREAD * (w // 4),
              smem=4 * (sk * w + 2 * rows * (sk + 4)))


def wide_max_rows(s, group_size, cluster):
  """The most rows (a multiple of 8) a wide cluster of `cluster` CTAs
  takes within a block's thread and shared-memory budgets, or 0 where a
  group is not whole in a thread's four columns, the slices are not whole
  float4s or no thread tile fits (fista_core.cuh's wide_max_rows)."""
  sk = -(-s // CHUNK) * CHUNK
  if group_size < 1 or 4 % group_size or cluster < 1 or sk % (4 * cluster):
    return 0
  per_row = sk // cluster // 4
  by_threads = WIDE_MAX_THREADS // per_row * WIDE_ROWS_PER_THREAD
  free = _SMEM_PER_BLOCK // 4 - sk * (sk // cluster)
  by_smem = (0 if free < 0 else free // (2 * (sk + 4))
             // WIDE_ROWS_PER_THREAD * WIDE_ROWS_PER_THREAD)
  return min(by_threads, by_smem)


def wide_cluster(s, group_size):
  """The wide kernel's CTAs a cluster: the fewest of 1, 2, 4, 8 whose
  slices leave shared memory for WIDE_MIN_THREADS threads' tiles of rows,
  or 0 (fista_core.cuh's wide_cluster)."""
  for cluster in (1, 2, 4, WIDE_MAX_CLUSTER):
    rows = wide_max_rows(s, group_size, cluster)
    if wide_layout(s, cluster, rows)["threads"] >= WIDE_MIN_THREADS:
      return cluster
  return 0


def wide_rows(b, s, group_size, slots):
  """Rows per wide cluster for a batch of b on a card that holds slots
  such clusters at one CTA per SM: the fewest waves the most rows allow,
  the batch spread evenly over them, in whole thread tiles; 0 where the
  layout does not fit (fista_core.cuh's wide_rows)."""
  cluster = wide_cluster(s, group_size)
  if not cluster:
    return 0
  most = wide_max_rows(s, group_size, cluster)
  spread = max(slots, 1)
  waves = -(-b // (spread * most))
  rows = -(-b // (spread * waves))
  return -(-rows // WIDE_ROWS_PER_THREAD) * WIDE_ROWS_PER_THREAD


def wide_grid(b, s, group_size, rows):
  """CTAs of a wide launch: wide_cluster's size per rows batch rows."""
  return -(-b // rows) * wide_cluster(s, group_size)


def solve_route(b, s, group_size, sm_count):
  """'cluster', 'wide' or 'classic': the kernel fista_core.cuh's
  solve_route picks for b rows of s codes in groups of group_size on a
  card of sm_count SMs.  The cluster kernel where its layout fits and the
  classic kernel's ceil(b / 16) blocks would fill at most half of the
  SMs; above that the wide kernel where its layout fits; the classic
  kernel otherwise."""
  if 2 * -(-b // ROWS) <= sm_count:
    return "cluster" if cluster_max_rows(s, group_size) >= 2 else "classic"
  return "wide" if wide_cluster(s, group_size) else "classic"


def stop_threads(threads):
  """Threads of a stop build with ``threads`` compute threads: whole
  compute warps, then the stop warp (fista_core.cuh's stop_threads)."""
  return -(-threads // 32) * 32 + 32


def stop_smem(threads):
  """Bytes of shared memory a stop build takes past its layout: each
  thread's sum by parity and the decision word (fista_core.cuh's
  stop_smem)."""
  return (2 * (-(-threads // 32) * 32) + 4) * 4


def cluster_stop_fits(b, s, group_size, slots):
  """Whether the cluster kernel's stop build takes the shape on a card of
  ``slots`` cluster slots: M in {1, 2, 4}, one resident wave of at most
  32 STOP_LANE_WORDS CTAs, room for the stop warp and its shared memory
  (fista_core.cuh's cluster_stop_fits)."""
  if group_size < 1 or 4 % group_size or slots < 1:
    return False
  rows = cluster_rows(b, s, group_size, slots)
  if rows < 2:
    return False
  clusters = -(-b // rows)
  lay = cluster_layout(s, group_size, rows)
  return (clusters <= slots and clusters * CLUSTER <= 32 * STOP_LANE_WORDS
          and stop_threads(lay["threads"]) <= CLUSTER_MAX_THREADS
          and lay["smem"] + stop_smem(lay["threads"]) <= _SMEM_PER_BLOCK)


def wide_stop_fits(b, s, group_size, slots):
  """The same for the wide kernel's stop build on a card of ``slots``
  clusters of wide_cluster's size (fista_core.cuh's wide_stop_fits)."""
  cluster = wide_cluster(s, group_size)
  if not cluster or slots < 1:
    return False
  rows = wide_rows(b, s, group_size, slots)
  clusters = -(-b // rows)
  lay = wide_layout(s, cluster, rows)
  return (clusters <= slots and clusters * cluster <= 32 * STOP_LANE_WORDS
          and stop_threads(lay["threads"]) <= WIDE_MAX_THREADS
          and lay["smem"] + stop_smem(lay["threads"]) <= _SMEM_PER_BLOCK)


def stop_route(b, s, group_size, sm_count, cluster_slots, wide_slots):
  """'cluster', 'wide' or 'classic': the route of a solve with the early
  stop (fista_core.cuh's stop_route).  solve_route's cluster or wide
  kernel where its stop build fits one resident wave (``cluster_slots``
  clusters of 8, ``wide_slots`` clusters of wide_cluster's size), else
  the classic kernel, an iteration a launch."""
  route = solve_route(b, s, group_size, sm_count)
  if route == "cluster" and cluster_stop_fits(b, s, group_size,
                                              cluster_slots):
    return "cluster"
  if route == "wide" and wide_stop_fits(b, s, group_size, wide_slots):
    return "wide"
  return "classic"


def stop_words(route, b, s, group_size, cluster_slots, wide_slots):
  """The 64-bit words of the stop's device array on ``route``: two tagged
  slots per CTA of a cluster or wide launch, or the classic route's
  STOP_CTL_WORDS control words and one share per block of ROWS rows
  (fista_core.cuh's stop_words)."""
  if route == "cluster":
    rows = cluster_rows(b, s, group_size, cluster_slots)
    return 2 * -(-b // rows) * CLUSTER if rows >= 2 else 0
  if route == "wide":
    rows = wide_rows(b, s, group_size, wide_slots)
    return 2 * -(-b // rows) * wide_cluster(s, group_size) if rows else 0
  return STOP_CTL_WORDS + -(-b // ROWS)


def tier_terms(mxu):
  """bf16 terms of an operand at a tier (bf16_terms.cuh's tier_terms)."""
  return {"bf16": 1, "bf16x3": 2, "bf16x5": 3}[mxu]


def tier_layout(mxu, s, cluster, rows, bufs=2):
  """The resident tier layout of clusters of ``cluster`` CTAs at rows
  batch rows for s codes with bufs buffers of z terms, as fista_tier.cuh's
  tier_layout: the padded depth sk, w columns a CTA, its compute warps and
  threads, and its dynamic shared memory in bytes (the tier's bf16 planes
  of the (sk, w) slice and the buffers of the rows' z terms)."""
  sk = -(-s // CHUNK) * CHUNK
  w = sk // cluster
  warps = rows // ROWS * (w // TIER_UNIT)
  return dict(sk=sk, w=w, warps=warps, threads=32 * warps,
              smem=2 * tier_terms(mxu) * (sk * w + bufs * rows * sk))


def tier_max_rows(mxu, s, group_size, cluster, bufs=2):
  """The most rows (a multiple of ROWS) a resident cluster takes within a
  block's warps and shared memory, or 0 where M is not 1, 2 or 4, the
  slices are not whole units of TIER_UNIT columns, or no m16 tile fits
  (fista_tier.cuh's tier_max_rows)."""
  sk = -(-s // CHUNK) * CHUNK
  if group_size < 1 or 4 % group_size or cluster < 1 or sk % (
      TIER_UNIT * cluster):
    return 0
  most, rows = 0, ROWS
  while True:
    lay = tier_layout(mxu, s, cluster, rows, bufs)
    if lay["warps"] > TIER_MAX_WARPS or lay["smem"] > _SMEM_PER_BLOCK:
      return most
    most, rows = rows, rows + ROWS


def tier_shape(b, s, group_size, mxu, slots):
  """(CTAs a cluster, rows a cluster, buffers of z terms, waves) of the
  resident layout for b rows, as fista_tier.cuh's tier_shape: over
  clusters of 1, 2, 4 and 8 CTAs (``slots(cluster)`` of them resident at
  one CTA an SM) and two or one z buffers, the fewest waves at each
  layout's most rows, then the least work a CTA (rows x w), then the fewer
  CTAs and two buffers; rows the batch spread evenly over the waves, in
  whole m16 tiles.  (0, 0, 0, 0) where no layout fits."""
  sk = -(-s // CHUNK) * CHUNK
  best, best_key = (0, 0, 0, 0), None
  for cluster in (1, 2, 4, TIER_MAX_CLUSTER):
    for bufs in (2, 1):
      most = tier_max_rows(mxu, s, group_size, cluster, bufs)
      if most < ROWS or slots(cluster) < 1:
        continue
      waves = -(-b // (slots(cluster) * most))
      rows = -(-(-(-b // (slots(cluster) * waves))) // ROWS) * ROWS
      key = (waves, rows * (sk // cluster))
      if best_key is None or key < best_key:
        best, best_key = (cluster, rows, bufs, waves), key
  return best


def tier_resident_fits(mxu, s, group_size):
  """Whether some resident layout holds one m16 tile: s a multiple of
  TIER_UNIT, M in {1, 2, 4}, and a cluster of at most TIER_MAX_CLUSTER
  CTAs with room for one buffer of 16 rows (fista_tier.cuh's
  tier_resident_fits)."""
  return s % TIER_UNIT == 0 and any(
      tier_max_rows(mxu, s, group_size, cluster, 1) >= ROWS
      for cluster in (1, 2, 4, TIER_MAX_CLUSTER))


def tier_route(b, s, group_size, mxu, sm_count):
  """'tier_cluster', 'tier_wide' or 'tier': the route fista_tier.cuh's
  tier_route picks at tier mxu for b rows of s codes in groups of
  group_size on a card of sm_count SMs.  Where a resident layout fits,
  the cluster route where the classic grid of ceil(b / 16) blocks would
  fill at most half of the SMs, the wide route above (both on
  tier_shape's layout); fista_tier_kernel otherwise."""
  if not tier_resident_fits(mxu, s, group_size):
    return "tier"
  return "tier_cluster" if 2 * -(-b // ROWS) <= sm_count else "tier_wide"


def tier_stop_fits(b, s, mxu, cluster, rows, bufs, slots):
  """Whether a resident launch of clusters of ``cluster`` CTAs at rows rows
  takes the stop warp: one resident wave of at most 32 STOP_LANE_WORDS
  CTAs, with room for the stop's shared memory (fista_tier.cuh's
  tier_stop_fits)."""
  if cluster < 1 or rows < ROWS or slots < 1:
    return False
  clusters = -(-b // rows)
  lay = tier_layout(mxu, s, cluster, rows, bufs)
  return (clusters <= slots and clusters * cluster <= 32 * STOP_LANE_WORDS
          and lay["smem"] + stop_smem(lay["threads"]) <= _SMEM_PER_BLOCK)


def tier_plan(b, s, group_size, mxu, sm_count, slots, stop=False,
              world=1):
  """(route, CTAs a cluster, rows a cluster, buffers of z terms) of a
  solve at tier mxu, as
  fista_tier.cuh's device_tier_plan picks them under route 'auto':
  ``slots(cluster)`` the card's clusters of that size at one CTA per SM.
  With ``stop`` a resident route whose launch is not one resident wave
  takes 'tier'; a stop across ranks (world above one) takes 'tier'."""
  if stop and world > 1:
    return "tier", 0, 0, 0
  route = tier_route(b, s, group_size, mxu, sm_count)
  if route == "tier":
    return route, 0, 0, 0
  cluster, rows, bufs, _ = tier_shape(b, s, group_size, mxu, slots)
  if stop and not tier_stop_fits(b, s, mxu, cluster, rows, bufs,
                                 slots(cluster)):
    return "tier", 0, 0, 0
  return route, cluster, rows, bufs


def tier_stop_words(route, b, cluster, rows):
  """The 64-bit words of a tier solve's stop array: two slots a CTA of a
  resident launch, or the classic route's (fista_tier.cuh's
  tier_stop_words)."""
  if route == "tier":
    return STOP_CTL_WORDS + -(-b // ROWS)
  return 2 * -(-b // rows) * cluster


def device_tier_plan(lib, b, s, group_size, mxu, route="auto", stop=False,
                     world=1):
  """The library's plan on the current device: (route name, CTAs a
  cluster, rows a cluster, buffers of z terms, the card's slots for
  clusters of that size); raises
  ValueError for a forced route that does not fit and RuntimeError on
  another CUDA error."""
  plan = (ctypes.c_int * 5)()
  err = lib.vtc_fista_tier_plan(b, s, group_size, TIER_CODES[mxu],
                                route_code(route), int(stop),
                                int(world > 1), plan)
  if err == 1:  # cudaErrorInvalidValue
    raise ValueError("the tier route %r does not take b=%d, s=%d, M=%d at "
                     "%s%s" % (route, b, s, group_size, mxu,
                               " with the stop" if stop else ""))
  if err:
    raise RuntimeError("reading the tier route's plan failed with CUDA "
                       "error %d" % err)
  return ROUTE_NAMES[plan[0]], plan[1], plan[2], plan[3], plan[4]


def route_launches():
  """{route name: solves launched} of the library's fc solve entry (K1's,
  which K2, K3 and K15 call for their solves) since the last
  ``reset_route_launches`` (fused_group_fista.route_launches: K4's)."""
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  return {name: int(lib.vtc_fista_route_launches(code))
          for code, name in ROUTE_NAMES.items()}


def reset_route_launches():
  """Set the route counts of both solve entries (``route_launches`` and
  fused_group_fista.route_launches) to 0."""
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  lib.vtc_fista_reset_route_launches()
  lib.vtc_group_fista_reset_route_launches()


def stop_scratch(lib, b, s, group_size, route, eps, device, steps=1,
                 mxu="highest"):
  """The C entries' early-stop arguments for ``steps`` solves in a row of
  b rows of s codes in groups of group_size: (eps, the words, the counts
  (steps,) int32, whether the stop takes a classic route, which keeps
  its state in global memory).  eps None is the build without the stop:
  (-1.0, None, None, False).  A negative or NaN eps never stops, as 0.0
  does.  The stop takes its own route (stop_route's, or at a tier other
  than 'highest' the tier plan's): ``route`` must be 'auto', or at a tier
  one of TIER_ROUTES (for checks and tools)."""
  if eps is None:
    return -1.0, None, None, False
  if route != "auto" and (mxu == "highest" or route not in TIER_ROUTES):
    raise ValueError("the early stop takes stop_route's route, not %r"
                     % (route,))
  eps = float(eps)
  if not eps >= 0.0:
    eps = 0.0
  if mxu != "highest":
    taken, cluster, rows, _, _ = device_tier_plan(lib, b, s, group_size,
                                                  mxu, route, stop=True)
    return (eps, torch.zeros(tier_stop_words(taken, b, cluster, rows),
                             dtype=torch.int64, device=device),
            torch.zeros(steps, dtype=torch.int32, device=device),
            taken == "tier")

  taken = lib.vtc_fista_stop_route(b, s, group_size)
  words = lib.vtc_fista_stop_words(b, s, group_size)
  if taken < 0 or words < 0:
    raise RuntimeError("reading the early stop's route failed with CUDA "
                       "error %d" % -min(taken, words))
  return (eps, torch.zeros(words, dtype=torch.int64, device=device),
          torch.zeros(steps, dtype=torch.int32, device=device),
          taken == ROUTES["classic"])


def segment_stop_scratch(lib, b, s, group_size, eps, device, steps, world,
                         mxu="highest"):
  """The early stop's arguments of a data-parallel segment's solves (K15,
  K16) at tier mxu: (eps, the words, the counts (steps,), the rank's
  one-float share or None, whether the route is the classic one).  At a
  world of one ``stop_scratch``'s (the shape's stop route, or at a tier
  the classic one; no share); above one the classic route's words and a
  share, which the C entry's stop hook sums over the ranks.  eps None:
  (-1.0, None, None, None, False)."""
  if world == 1 or eps is None:
    eps, words, iters, classic = stop_scratch(lib, b, s, group_size, "auto",
                                              eps, device, steps=steps,
                                              mxu=mxu)
    return eps, words, iters, None, classic
  eps = float(eps)
  if not eps >= 0.0:  # a negative or NaN eps never stops, as 0.0 does
    eps = 0.0
  words = stop_words("classic", b, s, group_size, 0, 0)
  return (eps, torch.zeros(words, dtype=torch.int64, device=device),
          torch.zeros(steps, dtype=torch.int32, device=device),
          torch.zeros(1, dtype=torch.float32, device=device), True)


def route_code(route):
  """The C entries' code of a route name (ROUTES, TIER_ROUTE_CODES)."""
  return (ROUTES | TIER_ROUTE_CODES)[route]


def check_route(route, mxu):
  """Raise ValueError unless ``route`` is 'auto' or a route of the tier
  mxu: 'classic', 'cluster' or 'wide' at 'highest', one of TIER_ROUTES at
  the others."""
  if route == "auto":
    return
  if mxu == "highest" and route not in ("classic", "cluster", "wide"):
    raise ValueError("route must be 'auto', 'classic', 'cluster' or 'wide' "
                     "at 'highest', not %r" % (route,))
  if mxu != "highest" and route not in TIER_ROUTES:
    raise ValueError("a tier other than 'highest' takes the tier routes: "
                     "route must be 'auto' (or one of %s), not %r"
                     % (", ".join(TIER_ROUTES), route))


def _launch(gram, corr, init, eta, lam, num_iters, fista, mode,
            route="auto", eps=None, mxu="highest"):
  """Allocate the kernel's scratch and launch it on the current stream.
  route 'classic', 'cluster' or 'wide' (at 'highest') or one of
  TIER_ROUTES (at another tier) forces a kernel, for checks and tools; eps
  the early stop's threshold (None: none); mxu the tier."""
  global launches, last_route, last_iters, tier_launches
  from vtc_tpu_torch.ops._build import load_library
  check_route(route, mxu)
  lib = load_library()
  b, s = corr.shape
  device = corr.device
  eps, words, iters, classic = stop_scratch(lib, b, s, 1, route, eps,
                                            device, mxu=mxu)
  sk, sc, gn, state = solve_scratch(lib, b, s, mxu, classic, device)
  out = torch.empty((b, s), dtype=torch.float32, device=device)
  taken = ctypes.c_int(0)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_fused_fista(
        gram.data_ptr(), corr.data_ptr(),
        None if init is None else init.data_ptr(), eta.data_ptr(),
        ctypes.c_float(lam), num_iters, b, s, sk, sc, int(fista), mode,
        gn.data_ptr(), None if state is None else state.data_ptr(),
        out.data_ptr(), route_code(route), ctypes.byref(taken),
        ctypes.c_float(eps), ctypes.c_float(1.0 / (b * s)),
        None if words is None else words.data_ptr(),
        None if iters is None else iters.data_ptr(), 1, None, None,
        TIER_CODES[mxu], stream)
  if err != 0:
    raise RuntimeError(
        "fused FISTA kernel launch failed with CUDA error %d "
        "(b=%d, s=%d, route %s, tier %s, state in %s%s)" % (
            err, b, s, route, mxu,
            "shared memory" if state is None else "global",
            "" if words is None else ", early stop"))
  launches += 1
  if mxu != "highest":
    tier_launches += 1
  last_route = ROUTE_NAMES[taken.value]
  if iters is not None:
    last_iters = iters
  return out
