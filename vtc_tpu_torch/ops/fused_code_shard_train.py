"""Residual-form train steps over a segment for big dictionaries: the port
of TPU kernel K19, ``fused_code_sharded_train_segment_pallas``
(vtc_tpu/ops/pallas_code_shard_train.py:484-629, kernel ``_make_cs_kernel``
:233-481), at a code axis of size 1 and across ranks.

It never builds the s x s Gram.  Per batch X (b, n) of the (k, b, n)
segment, with the dictionary D (s, n), the Hessian-diagonal EMA h (s,) and
the eigenvector v (n,) of the n x n Gram D^T D carried:

  v = v / |v|; power_iters times v = v D^T D / |v D^T D|
  eta = 1 / ((v D^T D) . v)
  z = old = 0; num_iters times:
    codes = prox(z - eta (z D - X) D^T, lambda eta)
    z = codes + beta (codes - old) (FISTA; ISTA: z = codes); old = codes
  h = 0.99 h + (sum_b codes^2 * (1/b)) / 100          (cheap quadratic)
  upd_num_iters times:
    grad = codes^T (codes D - X) * (1/b)
    [+ penalty (S D - rowsum(S o C) D), C = D D^T, S = comem o sign(C)]
    [/ (h + lowest)];  D = D - step * grad;  rows renormalized

The prox is the elementwise shrinkage (soft, hard, nonnegative), or with
``expand_local`` the group-norm shrinkage over a disjoint partition of
the rows (vtc_tpu's grouped variant; ``code_shard_group_arrays`` builds
the partition's arrays).  The eigenvector is the n x n Gram's, so the
global dictionary must have more rows than columns (s > n), the rule
vtc_tpu's caller applies (vtc_tpu/training/compiled_epoch.py:596).

Across ranks (``mesh``, a ``parallel.Mesh`` with a 'code' axis above 1
and optionally a 'data' axis): each rank passes its row shard D_l (s_l,
n) and h_l (s_l,) (``mesh.code_shard``), the replicated v and its batch
shard (k, b_l, n) (``mesh.shard``).  The sums vtc_tpu's kernel exchanges
by remote DMA are taken where it takes them: D^T D = sum over 'code' of
D_l^T D_l; z D = sum over 'code' of z_l D_l, before X is subtracted, each
iteration, and likewise the update's codes D; with a data axis, the
Hessian statistic sum_b codes^2 and the gradient codes_l^T resid summed
over 'data' and scaled by 1 / (b_l * data).  Group norms and the
regularizer stay inside a shard (``code_shard_group_arrays`` keeps every
group inside one).

* A CUDA tensor runs the hand-written kernels of
  ``vtc_tpu_torch/csrc/fused_code_shard_train_step.cu`` (built at first
  use by ``ops/_build.py``) on the current stream, the sums over ranks as
  calls of its host hook (``ops/sum_hook.AxisSumHook``); or raises.  At a
  mesh of one rank each step's solve is one cooperative launch of the
  persistent solve kernel (``csrc/code_shard_solve.cuh``), which a card
  that cannot hold its grid at once refuses (the wrapper then raises;
  there is no fallback).
* A CPU tensor runs ``fused_code_sharded_train_segment_plain``, the same
  steps in plain PyTorch with the same sums.  ``chip_smoke.py`` holds the
  kernels against it on the card; tests/test_torch_port_code_shard.py and
  test_torch_port_code_shard_parallel.py hold it against the Pallas
  kernel.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test
(:387-431): after iteration j > 0 a step's solve ends when the sum of
|codes - old| over every rank's rows and batch shard (summed over 'code',
then over 'data'), times 1 / stop_count (default b * data * s_l * code,
:557-566), over eta is below eps, on every rank at the same count.  On
the card: the persistent route's STOP build decides inside its launch
(each CTA's share posted before a grid barrier it already has), the
per-step route's last prox block (csrc/fused_code_shard_train_step.cu,
"The early stop"), across ranks after the hook's two sums and a
one-thread decision.  ``last_iters`` (a private test hook) is the int32
device tensor (k,) of the last stopped segment's counts, ``plain_iters``
the plain version's list of them and ``plain_avgs`` the means its last
step's solve tested (after iteration j at index j - 1).

``mxu`` is the tier of the solve's two products (vtc_tpu
``_make_tier_dots``, :88-117, used at :372-373): 'highest', or 'bf16x5',
'bf16x3' and 'bf16', where both operands of z D and r D^T are split into
bf16 terms and the tier's single-pass products summed
(``ops/precision.ns_dot``; z D a kSplitK chunk at a time, the chunks added
in order, ``precision.split_k_dot``, as the kernels' split sum adds
them).  The Gram, the power refresh, the update (its residual too), the
regularizer and the stop stay float32, as vtc_tpu keeps them at every
tier.  The group prox at a tier follows vtc_tpu's ``_make_group_prox``:
where ``roll_window`` names vtc_tpu's rotate window (contiguous groups of a
power-of-two M in column order, ``roll_window_from_expand_arrays``) its
sums stay float32; otherwise vtc_tpu's membership products round the
window sums and the scale at the tier (``precision.prox_sums``,
``prox_scale``), and so does the port (``prox_plan``).  An unknown tier
raises ValueError.  ``axis_size``, ``data_axis_size``, ``code_stride`` and
``data_stride`` must be the mesh's; ``interpret`` is a TPU knob, accepted
at False only.  ``launches`` counts the train steps the kernels ran,
``solve_launches`` the launches of the persistent solve kernel (one a step
on that route), ``tier_launches`` the steps run at a tier.

Two routes give the same bits: 'persistent', a step's solve and the
update's first residual as one launch of the solve kernel (one rank
only), and 'steps', about three launches a FISTA iteration from the C
loop, kept as its bitwise reference and as the route across ranks, where
the hook runs between launches.  The private ``route=`` of ``_launch``
forces one ('auto': ``auto_route``; no public entry point takes a route)
and ``last_route`` names the route of the last launch.  ``solve_plan``
and ``solve_barriers`` mirror the solve kernel's grid, tiles, shared
memory and barriers, so the CPU tests can pin them.
"""
import ctypes

import numpy as np
import torch

from vtc_tpu_torch.ops import fused_fista, fused_group_train_step, lipschitz
from vtc_tpu_torch.ops.precision import (TIER_CODES, TIERS, matmul_precision,
                                         ns_dot, prox_scale, prox_sums,
                                         split_k_dot)
from vtc_tpu_torch.ops.sum_hook import AxisSumHook

launches = 0
solve_launches = 0  # launches of the persistent solve kernel
tier_launches = 0  # steps run at a tier other than 'highest'
last_route = None  # 'persistent' or 'steps': the route of the last launch
last_iters = None  # int32 device tensor (k,): the last stopped segment's
plain_iters = None  # the plain version's counts of its last stopped segment
plain_avgs = None  # ... and the means its last step's solve tested

ROUTES = ("auto", "steps", "persistent")
# code_shard_solve.cuh's layout (kCsTileM, kCsTileN, kCsDepth, kCsSlice,
# kCsThreads, kSplitK); chip_smoke.py checks them against the library's
SOLVE_TILE_M, SOLVE_TILE_N, SOLVE_DEPTH, SOLVE_SLICE = 32, 64, 256, 32
SOLVE_THREADS, SPLIT_K = 128, 256
# the solve kernel's dynamic shared memory at each tier (cs_solve_smem):
# 'highest' the float32 staging and two float32 D slices; a tier the
# staging and two slices' bf16 planes, 32 KB a term a slice (the update
# residual's float32 slice reuses their space); and the most a CTA of an
# H100 may opt into
_STAGING = 4 * SOLVE_TILE_M * (SOLVE_DEPTH + 4)
_F32_SLICE = 4 * SOLVE_TILE_N * (SOLVE_DEPTH + 4)
_PLANE = 2 * SOLVE_TILE_N * SOLVE_DEPTH
SOLVE_SMEM = {"highest": _STAGING + 2 * _F32_SLICE}
SOLVE_SMEM.update({tier: _STAGING + max(2 * terms * _PLANE, _F32_SLICE)
                   for tier, terms in (("bf16", 1), ("bf16x3", 2),
                                       ("bf16x5", 3))})
H100_SMEM_OPTIN = 232448

UPDATE_ALGS = ("sc_steepest_descent", "sc_cheap_quadratic_descent",
               "subspace_sc_steepest_descent",
               "subspace_sc_cheap_quadratic_descent")
_MAX_WINDOW = 32  # the kernel's in-warp group prox takes windows up to this


def _cdiv(a, b):
  return -(-a // b)


def solve_tiles(b, s, n):
  """The persistent solve's tiles: phase A (the reconstruction's partials,
  a kSplitK chunk of the s atoms by a (b, n) output tile each), phase B
  (the (b, s) output tiles) and the (b, n) output tiles (cs_tiles_a,
  cs_tiles_b, cs_out_tiles)."""
  out = _cdiv(b, SOLVE_TILE_M) * _cdiv(n, SOLVE_TILE_N)
  return {"A": _cdiv(s, SPLIT_K) * out,
          "B": _cdiv(b, SOLVE_TILE_M) * _cdiv(s, SOLVE_TILE_N), "out": out}


def solve_barriers(num_iters, members, resid):
  """Grid barriers in one step of the solve kernel (cs_step_barriers): the
  prologue's, three an iteration (the partials, the split sum, the
  gradient), four with a member table, and one before the update
  residual's split sum."""
  return 1 + int(num_iters) * (4 if members else 3) + (1 if resid else 0)


def solve_plan(b, s, n, sm_count, blocks_per_sm, mxu="highest"):
  """The persistent launch at (b, s, n) and the tier ``mxu`` on a card
  of sm_count SMs that holds blocks_per_sm solve CTAs an SM (the least over
  the kernel's builds, so every tier takes the same grid): its grid (every
  CTA the card holds at once, but no more than the larger phase has
  tiles), the tiles, which D slices stay resident in shared memory for the
  whole solve (a phase whose tiles the grid covers; phase B also needs n
  <= the depth of one slice; a tier holds them as bf16 planes) and the
  CTA's dynamic shared memory at the tier."""
  tiles = solve_tiles(b, s, n)
  grid = min(sm_count * blocks_per_sm, max(tiles["A"], tiles["B"]))
  return {"grid": grid, "tiles": tiles,
          "resident": {"A": grid >= tiles["A"],
                       "B": grid >= tiles["B"] and n <= SOLVE_DEPTH},
          "smem": SOLVE_SMEM[_tier(mxu)]}


def _tier(mxu):
  """mxu, one of TIERS (vtc_tpu's K19 takes no 'default');
  ValueError otherwise."""
  if mxu not in TIERS:
    raise ValueError("fused_code_sharded_train_segment: unknown MXU tier %r;"
                     " expected one of %s" % (mxu, TIERS))
  return mxu


def auto_route(code_size, data_size):
  """The route 'auto' takes: the persistent solve at a mesh of one rank,
  the per-step route (the hook between launches) on any axis above 1."""
  return ("persistent" if int(code_size) == 1 and int(data_size) == 1
          else "steps")


def code_shard_segment_supported(batch_size, shard_code_size, input_size,
                                 num_devices, data_devices=1,
                                 local_group_max=0, use_reg=False):
  """True when ``fused_code_sharded_train_segment`` runs this per-shard
  geometry on the card (vtc_tpu pallas_code_shard_train.py:149-161):
  ``batch_size`` the per-data-shard batch, ``shard_code_size`` the rows of
  one of ``num_devices`` code shards.  The TPU gate's VMEM budget has no
  counterpart: the state lives in device memory and only the one-block
  power refresh on the n x n Gram bounds the shapes.  The port also
  refuses what vtc_tpu's gate leaves to its caller: a global dictionary
  with s <= n (the eigenvector is the n x n Gram's)."""
  del local_group_max, use_reg
  b, s, n = int(batch_size), int(shard_code_size), int(input_size)
  c, d = int(num_devices), int(data_devices)
  return (b > 0 and n > 0 and s > 0 and c >= 1 and d >= 1 and s * c > n
          and fused_group_train_step._power_smem_bytes(n)
          <= fused_fista._SMEM_PER_BLOCK)


def code_shard_group_arrays(group_assignments, code_size, num_devices):
  """Shard-local group matrices, or None when the layout is ineligible:
  vtc_tpu pallas_code_shard_train.py:164-204, in numpy.

  Eligible: the groups form a disjoint partition of range(code_size) and
  no group straddles a row-shard boundary.  Returns (expand, comem):
  expand (P, s_l, g_max) 0/1 membership of local rows in local groups,
  comem (P, s_l, s_l) within-group co-membership counts."""
  if code_size % num_devices != 0:
    return None
  s_l = code_size // num_devices
  members_all = sorted(m for g in group_assignments for m in g)
  if members_all != list(range(code_size)):
    return None  # not a disjoint partition
  per_shard = [[] for _ in range(num_devices)]
  for g in group_assignments:
    shards = {int(m) // s_l for m in g}
    if len(shards) != 1:
      return None  # group straddles a shard boundary
    shard = shards.pop()
    per_shard[shard].append([int(m) - shard * s_l for m in g])
  g_max = max(len(pg) for pg in per_shard)
  expand = np.zeros((num_devices, s_l, g_max), np.float32)
  comem = np.zeros((num_devices, s_l, s_l), np.float32)
  for shard, pgs in enumerate(per_shard):
    for g_idx, members in enumerate(pgs):
      for m in members:
        expand[shard, m, g_idx] = 1.0
      for a in members:
        for b in members:
          if a != b:
            comem[shard, a, b] += 1.0
  return expand, comem


def roll_window_from_expand_arrays(expand_all):
  """The window M when every shard's (s_l, g_max) membership block is the
  contiguous pattern expand[j, j // M] == 1 with M a power of two, else
  None: vtc_tpu pallas_code_shard_train.py:207-230, in numpy."""
  e = np.asarray(expand_all)
  if e.ndim != 3:
    return None
  _, sl, g = e.shape
  if g == 0 or sl % g:
    return None
  m = sl // g
  if m & (m - 1):
    return None
  want = np.zeros((sl, g), e.dtype)
  want[np.arange(sl), np.arange(sl) // m] = 1.0
  return m if all(np.array_equal(e[p], want) for p in range(e.shape[0])) \
      else None


def group_members(expand_local):
  """(table, window) for a 0/1 partition matrix expand (s, g).

  table (G, M) int64 lists each nonempty group's rows in ascending order,
  padded with -1; window is M when the groups are the contiguous blocks
  [i*M, (i+1)*M) with M a power of two up to 32 (in any column order),
  else None.  Raises ValueError unless every row is in exactly one
  group."""
  e = (expand_local.detach().cpu().numpy()
       if isinstance(expand_local, torch.Tensor)
       else np.asarray(expand_local))
  ones = e == 1
  if e.ndim != 2 or not (ones | (e == 0)).all() or \
      not (ones.sum(axis=1) == 1).all():
    raise ValueError(
        "fused_code_sharded_train_segment: expand_local must be an (s, g) "
        "0/1 matrix with every row in exactly one group (a disjoint "
        "partition, code_shard_group_arrays)")
  # each row's group, numbered over the nonempty columns in column order
  gid = np.unique(ones.argmax(axis=1), return_inverse=True)[1].reshape(-1)
  order = np.argsort(gid, kind="stable")  # by group, then by row
  counts = np.bincount(gid)
  width = int(counts.max())
  starts = np.cumsum(counts) - counts
  table = np.full((counts.size, width), -1, np.int64)
  table[gid[order], np.arange(order.size) - starts[gid[order]]] = order
  window = None
  if ((width & (width - 1)) == 0 and width <= _MAX_WINDOW
      and (counts == width).all() and (table[:, 0] % width == 0).all()
      and (table[:, -1] - table[:, 0] == width - 1).all()):
    window = width
  return table, window


def prox_plan(expand_local, mxu="highest", roll_window=None):
  """(table, window, rounds): how the group prox of the partition
  expand_local runs at the tier mxu.  table and window are
  ``group_members``'; rounds says that the member table's window sums and
  scale round at the tier.  At 'highest' every form sums in float32.  At a
  tier vtc_tpu's prox sums in float32 only on its rotate window, which its
  caller names in ``roll_window`` (contiguous groups of a power-of-two M in
  column order, ``roll_window_from_expand_arrays``; any M), and rounds on
  its membership products otherwise (``_make_group_prox``).  So at a tier
  without roll_window the port drops its own window (contiguous groups in
  another column order keep the membership products in vtc_tpu) and rounds
  the member table's sums; with it a window wider than the in-warp 32 sums
  its member table in float32."""
  table, window = group_members(expand_local)
  if _tier(mxu) == "highest" or roll_window is not None:
    return table, window, False
  return table, None, True


def _prox_fn(table, hard, nonneg, tier=None):
  """prox(u, t): the elementwise shrinkage, or the group-norm shrinkage of
  the member table (norm 0 guarded as in vtc_tpu's prox), its window sums
  and scale rounded at ``tier`` (precision.prox_sums, prox_scale) unless
  None."""
  if table is None:
    def prox(u, t):
      if hard:
        return torch.where((u if nonneg else u.abs()) < t, 0.0, u)
      if nonneg:
        return torch.clamp(u - t, min=0.0)
      return u - torch.clamp(u, -t, t)
    return prox
  valid = table >= 0
  gid = np.empty(int(valid.sum()), np.int64)  # each row's group
  gid[table[valid]] = np.nonzero(valid)[0]
  gid = torch.from_numpy(gid)
  index = torch.from_numpy(np.where(valid, table, gid.numel()))

  def prox(u, t):
    sq = torch.nn.functional.pad(u * u, (0, 1))  # column s: zero padding
    members = sq[:, index.to(u.device)]
    if tier is None:
      norms = torch.sqrt(members.sum(dim=-1))
    else:
      norms = torch.sqrt(prox_sums(members, tier)[..., 0])
    if hard:
      scale = torch.where(norms < t, 0.0, 1.0)
    else:
      safe = torch.where(norms == 0.0, 1.0, norms)
      scale = torch.clamp(1.0 - t / safe, min=0.0)
    if tier is not None:
      scale = prox_scale(scale, tier)
    return u * scale.to(u.dtype)[:, gid.to(u.device)]
  return prox


def _code_sum(mesh, t):
  """t summed over the 'code' axis (a new tensor; t itself at one rank)."""
  if mesh is None or mesh.code_size == 1:
    return t
  flat = t.reshape(-1).clone()
  return mesh.sum_code_(flat).reshape(t.shape)


def _data_sum(mesh, t):
  """t summed over the data axes (t itself at one rank)."""
  return t if mesh is None else mesh.sum(t)


def fused_code_sharded_train_segment_plain(
    dictionary, hessian, eigvec, batches, sparsity_weight, inf_num_iters,
    upd_stepsize, *, mesh=None, expand_local=None, comem_local=None,
    alignment_penalty=0.0, variant="fista",
    update_alg="sc_cheap_quadratic_descent", upd_num_iters=1, nonneg=False,
    hard=False, renormalize=True, power_iters=12, lowest_code_val=0.001,
    early_stopping_epsilon=None, stop_count=None, precision=None,
    mxu="highest", roll_window=None, return_stepsize=False):
  """The plain PyTorch version of the segment, on any device and in the
  inputs' own float type (float64 inputs give the oracle).

  With ``mesh`` the arguments are this rank's shards (rows over 'code',
  the batch over the data axes) and the sums over ranks are taken where
  the kernel takes them.  ``stop_count`` defaults to the global
  b * data * s_l * code (vtc_tpu :560-561); the stop test sums |codes -
  old| over 'code', then over 'data', then scales the sum by
  1 / stop_count and divides by eta, as the kernels do.

  ``precision`` is the matmul precision of the solve and the update
  (default 'highest'); 'tensorfloat32' shows what TF32 products would
  cost.  The power refresh always runs at 'highest', as in every tier of
  the TPU kernel.  ``mxu`` is the solve's tier and ``roll_window`` vtc_tpu's
  prox hint (``prox_plan``): at a tier z D is taken a kSplitK chunk at a
  time (``precision.split_k_dot``) and r D^T whole, both at the tier
  (``precision.ns_dot``), summed over ranks as at 'highest'.
  """
  d, h, v = dictionary, hessian, eigvec
  b = batches.shape[1]
  s, n = d.shape
  code, data = (1, 1) if mesh is None else (mesh.code_size, mesh.size)
  if s * code <= n:
    raise ValueError("the residual form's eigenvector is the n x n Gram's: "
                     "it needs s > n, got s=%d, n=%d" % (s * code, n))
  tier = _tier(mxu)
  table = rounds = None
  if expand_local is not None:
    table, _, rounds = prox_plan(expand_local, tier, roll_window)
  prox = _prox_fn(table, hard, nonneg, tier if rounds else None)
  use_fista = variant == "fista"
  cheap = update_alg.endswith("cheap_quadratic_descent")
  penalty = float(alignment_penalty)
  comem = (None if penalty == 0.0 else
           torch.as_tensor(comem_local).to(d.device, d.dtype))
  stop_elems = (int(stop_count) if stop_count is not None
                else b * data * s * code)
  inv_b = 1.0 / (b * data)
  codes = eta = None
  global plain_iters, plain_avgs
  counts, avgs = [], []
  for x in batches:
    with matmul_precision():
      gram = _code_sum(mesh, d.T @ d)
    eigval, v = lipschitz.power_iterate_gram(gram, v, int(power_iters))
    eta = 1.0 / eigval
    lam_eta = sparsity_weight * eta
    with matmul_precision(precision):
      z = old = codes = torch.zeros(b, s, dtype=d.dtype, device=d.device)
      t = np.float32(1.0)
      avgs = []
      for j in range(int(inf_num_iters)):
        if tier == "highest":
          recon = _code_sum(mesh, z @ d) - x
          codes = prox(z - eta * (recon @ d.T), lam_eta)
        else:
          recon = _code_sum(mesh, split_k_dot(z, d, tier, SPLIT_K)) - x
          codes = prox(z - eta * ns_dot(recon, d.T, tier), lam_eta)
        if use_fista:
          t_next = (np.float32(1.0) + np.sqrt(np.float32(1.0)
                                              + np.float32(4.0) * t * t)
                    ) / np.float32(2.0)
          z = codes + float((t - np.float32(1.0)) / t_next) * (codes - old)
          t = t_next
        else:
          z = codes
        # vtc_tpu's stop rule: mean |codes - old| / eta over the global
        # batch and rows, never at j = 0
        stop = False
        if early_stopping_epsilon is not None and j > 0:
          total = _data_sum(mesh, _code_sum(mesh, (codes - old).abs().sum()))
          avgs.append(float(total * (1.0 / stop_elems) / eta))
          stop = avgs[-1] < early_stopping_epsilon
        old = codes
        if stop:
          break
      counts.append(j + 1 if int(inf_num_iters) > 0 else 0)
      if cheap:
        stat = (codes * codes).sum(dim=0)
        if data > 1:  # train_core's hessian_from_stat, as K15-K17
          h = 0.99 * h + (_data_sum(mesh, stat) / (b * data)) / 100.0
        else:
          h = 0.99 * h + (stat * inv_b) / 100.0
        scale = (h + lowest_code_val)[:, None]
      for _ in range(int(upd_num_iters)):
        resid = _code_sum(mesh, codes @ d) - x
        grad = _data_sum(mesh, codes.T @ resid) * inv_b
        if comem is not None:
          cos = d @ d.T
          smat = comem * torch.sign(cos)
          grad = grad + penalty * (
              smat @ d - (smat * cos).sum(dim=1, keepdim=True) * d)
        if cheap:
          grad = grad / scale
        d = d - upd_stepsize * grad
        if renormalize:
          d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1,
                                                       keepdim=True),
                              min=1e-30)
  if early_stopping_epsilon is not None:
    plain_iters, plain_avgs = counts, avgs
  if return_stepsize:
    return d, h, v, codes, eta.reshape(1)
  return d, h, v, codes


def _require(cond, message):
  if not cond:
    raise ValueError("fused_code_sharded_train_segment: " + message)


def fused_code_sharded_train_segment(
    dict_shard, hessian_shard, eigvec, batches, sparsity_weight,
    inf_num_iters, upd_stepsize, *, axis_name=None, axis_size=1,
    data_axis_name=None, data_axis_size=1, code_stride=1, data_stride=0,
    expand_local=None, comem_local=None, alignment_penalty=0.0,
    variant="fista", update_alg="sc_cheap_quadratic_descent",
    upd_num_iters=1, nonneg=False, hard=False, renormalize=True,
    power_iters=12, lowest_code_val=0.001, interpret=False, mxu="highest",
    early_stopping_epsilon=None, stop_count=None, roll_window=None,
    mesh=None, return_stepsize=False):
  """Run ``batches.shape[0]`` residual-form train steps on this rank.

  Args:
    dict_shard: (s_l, n) float32 tensor, this rank's rows of a dictionary
      of s_l * axis_size > n rows (the whole dictionary at axis 1).
    hessian_shard: (s_l,) its rows of the Hessian-diagonal EMA (unchanged
      by steepest descent).
    eigvec: (n,) warm eigenvector of D^T D (normalized here), replicated.
    batches: (k, b_l, n) float32, this rank's batch shards, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars.
    axis_name, data_axis_name: ignored (the mesh names the axes);
      axis_size and data_axis_size must be the mesh's 'code' and data-axes
      sizes (1 and 1 without a mesh).
    code_stride, data_stride: the mesh's row-major strides (1 and
      axis_size; data_stride 0 is accepted at data_axis_size 1);
      interpret: False only (a TPU knob).
    expand_local: (s_l, g) 0/1 partition of this rank's rows into groups
      (``code_shard_group_arrays(groups, s, axis_size)[0][code position]``)
      for the grouped variant, else None; comem_local: (s_l, s_l)
      co-membership counts, needed when alignment_penalty is not 0 (which
      needs renormalize).
    variant: 'ista' | 'fista' (vtc_tpu's caller strips the subspace
      prefix, vtc_tpu/training/compiled_epoch.py:1126).
    update_alg: the two fc update rules or their subspace names.
    upd_num_iters / nonneg (fc only) / hard / renormalize / power_iters /
      lowest_code_val: as in vtc_tpu.
    mxu: the solve's tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16' (see
      the module's docstring); any other raises ValueError.
    early_stopping_epsilon, stop_count: the stop test, the mean over
      stop_count elements (default the global b * s), on every rank at
      the same count.
    roll_window: vtc_tpu's prox hint, None or vtc_tpu's rotate window of
      expand_local (``roll_window_from_expand_arrays``); at a tier it picks
      the prox's rounding (``prox_plan``).
    mesh: the ``parallel.Mesh`` the ranks share, without a 'dcn' axis;
      None is a mesh of one rank.  Every rank of it calls this together.
    return_stepsize: also return the final step's stepsize 1/eigval.

  Returns:
    (dict_shard, hessian_shard, eigvec, last_codes[, stepsize]): new
    tensors, this rank's rows, the replicated eigenvector and the (b_l,
    s_l) codes of the final step; the inputs are not modified.
  """
  code, data = (1, 1) if mesh is None else (mesh.code_size, mesh.size)
  if mesh is not None and "dcn" in mesh.axis_names:
    raise ValueError("fused_code_sharded_train_segment: a mesh with a "
                     "'dcn' axis is not a code-sharded mesh (vtc_tpu's "
                     "trainer takes it only without one)")
  _require(int(axis_size) == code and int(data_axis_size) == data,
           "axis_size=%d and data_axis_size=%d must be the mesh's 'code' "
           "and data-axes sizes, %d and %d"
           % (int(axis_size), int(data_axis_size), code, data))
  tier = _tier(mxu)
  _require(int(code_stride) == 1
           and int(data_stride) in ((0, code) if data == 1 else (code,))
           and not interpret,
           "code_stride and data_stride are the mesh's row-major strides "
           "(1 and %d) and interpret is a TPU knob (False)" % code)
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s" % (UPDATE_ALGS,))
  _require(batches.dim() == 3 and batches.shape[0] >= 1,
           "batches must be (k, b, n) with k >= 1, got %s"
           % (tuple(batches.shape),))
  k, b, n = batches.shape
  _require(dict_shard.dim() == 2 and dict_shard.shape[1] == n,
           "dictionary must be (s, %d), got %s" % (n, tuple(dict_shard.shape)))
  s = dict_shard.shape[0]
  _require(s * code > n, "the eigenvector is the n x n Gram's: s > n is "
           "needed for the global dictionary, got s=%d, n=%d" % (s * code, n))
  use_reg = float(alignment_penalty) != 0.0
  table = window = None
  rounds = False
  if expand_local is not None:
    _require(tuple(expand_local.shape)[0] == s,
             "expand_local must have %d rows" % s)
    table, window, rounds = prox_plan(expand_local, tier, roll_window)
    _require(not nonneg, "nonneg applies to the fc variant only")
    expand = (expand_local.detach().cpu().numpy()
              if isinstance(expand_local, torch.Tensor)
              else np.asarray(expand_local))
    _require(roll_window is None
             or roll_window == roll_window_from_expand_arrays(expand[None]),
             "roll_window=%r does not match expand_local's groups"
             % (roll_window,))
  _require(not use_reg or (table is not None and comem_local is not None),
           "alignment_penalty needs expand_local and comem_local")
  _require(not use_reg or renormalize,
           "the anti-alignment regularizer uses the unit-norm gradient "
           "form: alignment_penalty needs renormalize=True")
  flags = dict(variant=variant, update_alg=update_alg,
               upd_num_iters=int(upd_num_iters), nonneg=bool(nonneg),
               hard=bool(hard), renormalize=bool(renormalize),
               power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val),
               alignment_penalty=float(alignment_penalty))
  if batches.device.type == "cpu":
    return fused_code_sharded_train_segment_plain(
        dict_shard, hessian_shard, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize), mesh=mesh,
        expand_local=expand_local, comem_local=comem_local,
        early_stopping_epsilon=early_stopping_epsilon, stop_count=stop_count,
        mxu=tier, roll_window=roll_window, return_stepsize=return_stepsize,
        **flags)
  _require(batches.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(batches.device))
  device = batches.device
  for name, t, shape in (("dictionary", dict_shard, (s, n)),
                         ("hessian", hessian_shard, (s,)),
                         ("eigvec", eigvec, (n,)),
                         ("batches", batches, (k, b, n))):
    _require(t.device == device and t.dtype == torch.float32
             and tuple(t.shape) == shape,
             "%s must be a float32 %s tensor on %s" % (name, shape, device))
  _require(b > 0, "empty batch")
  _require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
           and int(power_iters) >= 0, "iteration counts must be >= 0")
  _require(code_shard_segment_supported(b, s, n, code, data),
           "n = %d is too large for the one-block power refresh" % n)
  if use_reg:
    _require(tuple(comem_local.shape) == (s, s),
             "comem_local must be (%d, %d)" % (s, s))
  stop_elems = (int(stop_count) if stop_count is not None
                else b * data * s * code)
  out = _launch(dict_shard, hessian_shard, eigvec, batches.contiguous(),
                table, window, comem_local if use_reg else None, mesh,
                float(sparsity_weight), int(inf_num_iters),
                float(upd_stepsize), eps=early_stopping_epsilon,
                stop_count=stop_elems, mxu=tier, prox_round=rounds, **flags)
  return out if return_stepsize else out[:4]


def _launch(dictionary, hessian, eigvec, batches, table, window, comem, mesh,
            lam, num_iters, upd_step, *, variant, update_alg, upd_num_iters,
            nonneg, hard, renormalize, power_iters, lowest_code_val,
            alignment_penalty, route="auto", grid=0, eps=None,
            stop_count=None, mxu="highest", prox_round=False):
  """Allocate state and scratch, copy the group table and co-membership
  counts to the device, and enqueue the k steps on the current stream,
  the sums over ranks as calls of the hook.  route 'steps' or
  'persistent' forces a route and grid a persistent launch's CTA count
  (for checks and tools; 0: the shape's own); eps the solves' early stop
  over stop_count elements (None: none); mxu the solve's tier and
  prox_round that the member table's prox rounds at it (``prox_plan``; the
  caller passes its window as None then)."""
  global launches, solve_launches, tier_launches, last_route, last_iters
  tier = _tier(mxu)
  _require(not prox_round or (tier != "highest" and table is not None
                              and window is None),
           "prox_round needs a tier and a member table")
  code, data = (1, 1) if mesh is None else (mesh.code_size, mesh.size)
  if route not in ROUTES:
    raise ValueError("route must be one of %s, got %r" % (ROUTES, route))
  if route == "auto":
    route = auto_route(code, data)
  _require(route == "steps" or (code == 1 and data == 1),
           "the persistent solve runs at a mesh of one rank only")
  persistent = route == "persistent"
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  s = dictionary.shape[0]
  device = batches.device
  splits = -(-s // lib.vtc_code_shard_split_k())

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  d = dictionary.contiguous().clone()
  h = hessian.contiguous().clone()
  v = eigvec.contiguous().clone()
  members = pre = None
  num_groups = width = 0
  if table is not None and window is None:  # the general group prox
    members = torch.from_numpy(table.astype(np.int32)).to(device)
    num_groups, width = table.shape
    pre = empty(b, s)
  cm = cmat = smat = sd = None
  if comem is not None:
    cm = torch.as_tensor(comem, dtype=torch.float32).to(device).contiguous()
    cmat, smat, sd = empty(s, s), empty(s, s), empty(s, n)
  pgram, eta = empty(n, n), empty(1)
  partial = empty(splits * max(b, n) * n)
  rbuf, z, old, grad = empty(b, n), empty(b, s), empty(b, s), empty(s, n)
  stat = empty(s) if data > 1 else None
  betas = barrier = None
  if persistent:
    betas = empty(max(num_iters, 1))
    barrier = torch.empty(2, dtype=torch.int32, device=device)
  # the early stop: a negative or NaN eps never stops, as 0.0 does
  words = iters = slots = local = None
  if eps is not None:
    eps = float(eps) if float(eps) >= 0.0 else 0.0
    iters = torch.zeros(k, dtype=torch.int32, device=device)
    if persistent:
      slots = empty(2 * (int(grid) or lib.vtc_code_shard_grid(b, s, n)))
    else:
      words = torch.zeros(lib.vtc_code_shard_stop_words(b, s, num_groups),
                          dtype=torch.int64, device=device)
      if code > 1 or data > 1:
        local = empty(1)
  sums = {}  # csrc enum SumWhich: what the hook sums, over which axis
  if code > 1:
    sums[0] = (mesh.sum_code_, pgram.view(-1))
    sums[1] = (mesh.sum_code_, rbuf.view(-1))
  if data > 1:
    sums[2] = (mesh.sum_, stat)
    sums[3] = (mesh.sum_, grad.view(-1))
  if local is not None:  # the stop's share: over 'code', then 'data'
    if code > 1:
      sums[4] = (mesh.sum_code_, local)
    if data > 1:
      sums[5] = (mesh.sum_, local)
  hook = AxisSumHook(sums)
  mode = (2 if hard else 0) if table is not None else \
      fused_fista._MODES[(nonneg, hard)]

  def ptr(t):
    return None if t is None else t.data_ptr()

  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_code_shard_train_segment(
        d.data_ptr(), h.data_ptr(), v.data_ptr(), batches.data_ptr(), k, b,
        s, n, window or 0, ptr(members), num_groups, width, ptr(cm),
        f32(alignment_penalty), f32(lam), num_iters, f32(upd_step),
        upd_num_iters, f32(lowest_code_val), int(variant == "fista"),
        mode, int(update_alg.endswith("cheap_quadratic_descent")),
        int(renormalize), power_iters, f32(1.0 / (b * data)),
        pgram.data_ptr(), partial.data_ptr(), rbuf.data_ptr(), z.data_ptr(),
        old.data_ptr(), ptr(pre), grad.data_ptr(), ptr(cmat), ptr(smat),
        ptr(sd), eta.data_ptr(), code, data, ptr(stat), hook.pointer,
        int(persistent), int(grid), ptr(betas), ptr(barrier),
        f32(-1.0 if eps is None else eps),
        f32(0.0 if eps is None else 1.0 / stop_count), ptr(words),
        ptr(iters), ptr(slots), ptr(local), TIER_CODES[tier],
        int(bool(prox_round)), stream)
  hook.check(err, "residual-form train step launch (k=%d, b=%d, s=%d, n=%d, "
             "code %d, data %d, route %s%s, tier %s)" % (
                 k, b, s, n, code, data, route,
                 "" if eps is None else ", early stop", tier))
  launches += k
  if persistent:
    solve_launches += k
  if tier != "highest":
    tier_launches += k
  if iters is not None:
    last_iters = iters
  last_route = route
  return d, h, v, old, eta
