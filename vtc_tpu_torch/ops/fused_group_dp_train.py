"""Whole data-parallel subspace (group-sparse) training segments: the port of
TPU kernel K16, ``fused_group_dp_train_segment_pallas``
(vtc_tpu/ops/pallas_group_dp_train.py:300-465, kernel
``_make_group_dp_kernel`` :94), with the group prox K5 inside.

``fused_group_dp_train_segment`` keeps that function's contract and return
value ``(dictionary, hessian, eigvec, last_codes_shard)``; the port's
``parallel.Mesh`` takes the place of the axis name and size, and the
eigenvector is the grouped Gram's, min(G*M, n) long.  Per batch of this
rank's (k, b_shard, n) segment: K7's grouped refresh, group solve,
duplicate-summed codes and unaveraged statistics C, B and stat over them,
their sum over the ranks, and the replicated subspace update from the
global statistics: the Hessian EMA, then ``upd_num_iters`` steps along
(C D' - B) / global_b plus the within-group anti-alignment regularizer,
which depends on the replicated dictionary alone (vtc_tpu :271-288).  The
semantics are vtc_tpu's: a scan of [K7 -> psum -> replicated update]
(``parallel.build_dp_group_fused_local_step``).

* A CUDA tensor runs ``vtc_group_dp_train_segment`` of
  ``vtc_tpu_torch/csrc/fused_group_train_step.cu``: the whole segment from
  one C loop on the current stream, K7's kernels and then K6's update
  kernels per step, the packed statistics summed over the ranks by the
  host hook (``ops/sum_hook``) between them at a world above one.  The
  group structure reaches it as K6's index lists (a row gather and a
  fixed-order unpack, skipped when the groups tile range(s) in order: the
  TPU kernel's ``gsel_identity``); K4's prox takes the window, so
  vtc_tpu's expand matrix and its roll prox have no counterpart.  Or it
  raises.
* A CPU tensor runs ``fused_group_dp_train_plain``: K7's plain version,
  ``Mesh.sum`` and ``parallel.data_parallel._replicated_update`` with the
  regularizer's gradient, per batch.  ``chip_smoke.py`` holds the kernel
  against it on the card.

``fused_group_dp_segment_supported`` is K7's gate
(``fused_group_train_step.fused_group_solve_stats_supported``) plus
vtc_tpu's term "penalty == 0 or renormalize" (:320-323): the in-kernel
regularizer is the unit-norm form.  vtc_tpu's VMEM and comm-slot budget
has no counterpart on the card.  The subspace solvers have no nonnegative
mode, so data-parallel subspace training with ``nonnegative_only`` takes
neither this kernel nor K7, as in vtc_tpu.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test over the
ranks on the grouped codes (:189-229): the sum of |codes - old| over every
rank's (b_shard, G*M) packed codes, times 1 / (global_b G M) (:360-366),
over eta; K15's construction (``ops/fused_dp_train``) on K6's stop route
at a world of one and the classic route with ``ops/sum_hook.StopHook``
above one, every rank at the same count; the plain version takes the
same test.  ``last_iters`` (a private test hook) is the int32 device
tensor (k,) of the last stopped segment's counts, ``plain_iters`` the
plain version's list of them.

``mxu`` is vtc_tpu's training tier (pallas_group_dp_train.py:94-231), K15's
rule with K6's group prox and unpack: at 'bf16' the unpack adds
bf16-rounded slots where the groups are not the identity layout, which
keeps its codes unrounded (vtc_tpu's ``gsel_identity`` shortcut, :230-231,
where K7 rounds them).  ``launches`` counts the train steps the kernel
ran, ``tier_launches`` those at a tier other than 'highest'.
"""
import ctypes

import torch

from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista as sub)
from vtc_tpu_torch.dict_update_rules.fully_connected._subspace_common import (
    alignment_regularization_gradients)
from vtc_tpu_torch.ops import (fused_fista, fused_group_train_step,
                               solver)
from vtc_tpu_torch.ops.precision import TIER_CODES, resolve_tier
from vtc_tpu_torch.ops.sum_hook import StopHook, SumHook
from vtc_tpu_torch.parallel import data_parallel

launches = 0
tier_launches = 0  # the steps above at a tier other than 'highest'
last_iters = None  # int32 device tensor (k,): the last stopped segment's
plain_iters = None  # the plain version's counts of its last stopped segment


def fused_group_dp_segment_supported(batch_shard_size, code_size, input_size,
                                     group_assignments, *,
                                     alignment_penalty=0.0,
                                     renormalize=True):
  """True when ``fused_group_dp_train_segment`` takes this configuration:
  K7's gate, and a regularizer only with renormalization.  vtc_tpu's
  ``num_devices`` (its comm-slot count) bounds nothing on the card."""
  return ((float(alignment_penalty) == 0.0 or bool(renormalize))
          and fused_group_train_step.fused_group_solve_stats_supported(
              batch_shard_size, code_size, input_size, group_assignments))


def fused_group_dp_train_plain(
    dictionary, hessian, eigvec, batches, sparsity_weight, inf_num_iters,
    upd_stepsize, *, group_assignments, mesh, variant="fista",
    update_alg="subspace_sc_cheap_quadratic_descent", upd_num_iters=1,
    hard=False, renormalize=True, power_iters=12, lowest_code_val=0.001,
    alignment_penalty=0.0, precision=None, early_stopping_epsilon=None,
    mxu="highest"):
  """The plain PyTorch version of the segment, on any device and in the
  inputs' own float type (float64 inputs give the oracle): per batch K7's
  plain version, the sum over ``mesh`` and the replicated update.
  ``precision`` is the matmul precision of the solve (default 'highest');
  ``early_stopping_epsilon`` the kernel's stop test on the grouped codes,
  each iteration's sum summed over ``mesh`` and scaled by
  1 / (global_b G M); ``mxu`` the group solve's tier, the identity
  layout's codes unrounded at 'bf16'.  The row renorm floors the norms at
  1e-30, as the kernel does (pallas_group_dp_train.py:288)."""
  global plain_iters
  d, h, v = dictionary, hessian, eigvec
  penalty = float(alignment_penalty)
  reg_fn = None
  if penalty != 0.0:
    gather, mask, _ = sub.group_layout(group_assignments, d.shape[0],
                                       d.device)
    reg_fn = lambda dd: penalty * alignment_regularization_gradients(
        dd, gather, mask, renormalize)
  codes = None
  counts = []
  gm = len(group_assignments) * max(len(g) for g in group_assignments)
  for batch in batches:
    codes, cmat, bmat, stat, v, _ = (
        fused_group_train_step.fused_group_solve_stats_plain(
            d, v, batch, sparsity_weight, inf_num_iters,
            group_assignments=group_assignments, variant=variant, hard=hard,
            power_iters=power_iters, precision=precision,
            early_stopping_epsilon=early_stopping_epsilon, psum_axes=mesh,
            stop_count=batch.shape[0] * mesh.size * gm, mxu=mxu,
            round_identity=False))
    counts.append(solver.last_iters)
    cmat, bmat, stat = mesh.sum(cmat, bmat, stat)
    d, h = data_parallel._replicated_update(
        d, h, stat, upd_stepsize, upd_num_iters, batch.shape[0] * mesh.size,
        update_alg == "subspace_sc_cheap_quadratic_descent", renormalize,
        lowest_code_val, lambda dd, cmat=cmat, bmat=bmat: cmat @ dd - bmat,
        reg_fn, norm_floor=True)
  if early_stopping_epsilon is not None:
    plain_iters = counts
  return d, h, v, codes


def fused_group_dp_train_segment(
    dictionary, hessian, eigvec, batches, sparsity_weight, inf_num_iters,
    upd_stepsize, *, group_assignments, mesh, variant="fista",
    update_alg="subspace_sc_cheap_quadratic_descent", upd_num_iters=1,
    hard=False, renormalize=True, power_iters=12, lowest_code_val=0.001,
    alignment_penalty=0.0, mxu="highest", early_stopping_epsilon=None):
  """Run ``batches.shape[0]`` data-parallel subspace train steps on this
  rank.

  Every rank of ``mesh`` calls it in step, with the same replicated state
  and its own shard of every batch.

  Args:
    dictionary: (s, n) float32, replicated.
    hessian: (s,) Hessian-diagonal EMA (unchanged by steepest descent),
      replicated.
    eigvec: (min(G*M, n),) warm eigenvector of the grouped Gram (normalized
      here), replicated.
    batches: (k, b_shard, n) float32, this rank's shards, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars.
    group_assignments: list of index lists (ragged, may overlap).
    mesh: the ``parallel.Mesh`` the ranks share.
    variant / update_alg / upd_num_iters / hard / renormalize /
      power_iters / lowest_code_val / alignment_penalty: as in vtc_tpu; a
      nonzero penalty needs renormalize (the unit-norm form).
    mxu: the training tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16'.
    early_stopping_epsilon: optional; each step's group solve stops after
      the first iteration j > 0 whose mean |codes_j - codes_{j-1}| / eta
      over the global batch's G*M packed codes is below it, on every rank
      at the same count.

  Returns:
    (dictionary, hessian, eigvec, last_codes): new tensors, replicated but
    for last_codes, the (b_shard, s) summed codes of this rank's final
    shard.  The inputs are not modified.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in fused_group_train_step.UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s"
                     % (fused_group_train_step.UPDATE_ALGS,))
  mxu = resolve_tier(mxu)

  def require(cond, message):
    if not cond:
      raise ValueError("fused_group_dp_train_segment: " + message)

  require(batches.dim() == 3 and batches.shape[0] >= 1,
          "batches must be (k, b_shard, n) with k >= 1, got %s"
          % (tuple(batches.shape),))
  k, b, n = batches.shape
  require(dictionary.dim() == 2 and dictionary.shape[1] == n,
          "dictionary must be (s, %d), got %s" % (n,
                                                  tuple(dictionary.shape)))
  s = dictionary.shape[0]
  groups = tuple(tuple(int(i) for i in g) for g in group_assignments)
  require(all(0 <= i < s for g in groups for i in g),
          "group members must index the %d dictionary rows" % s)
  require(fused_group_dp_segment_supported(
      b, s, n, groups, alignment_penalty=alignment_penalty,
      renormalize=renormalize),
          "configuration outside the gate "
          "(fused_group_dp_segment_supported())")
  flags = dict(variant=variant, update_alg=update_alg,
               upd_num_iters=int(upd_num_iters), hard=bool(hard),
               renormalize=bool(renormalize), power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val),
               alignment_penalty=float(alignment_penalty), mxu=mxu)
  if batches.device.type == "cpu":
    return fused_group_dp_train_plain(
        dictionary, hessian, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize), group_assignments=groups,
        mesh=mesh, early_stopping_epsilon=early_stopping_epsilon, **flags)
  require(batches.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batches.device))
  device = batches.device
  gm = len(groups) * max(len(g) for g in groups)
  for name, t, shape in (("dictionary", dictionary, (s, n)),
                         ("hessian", hessian, (s,)),
                         ("eigvec", eigvec, (min(gm, n),)),
                         ("batches", batches, (k, b, n))):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == shape,
            "%s must be a float32 %s tensor on %s" % (name, shape, device))
  require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
          and int(power_iters) >= 0, "iteration counts must be >= 0")
  return _launch(dictionary.contiguous().clone(),
                 hessian.contiguous().clone(), eigvec.contiguous().clone(),
                 batches.contiguous(), groups, mesh, float(sparsity_weight),
                 int(inf_num_iters), float(upd_stepsize),
                 eps=early_stopping_epsilon, **flags)


def _launch(d, h, v, batches, groups, mesh, lam, num_iters, upd_step, *,
            variant, update_alg, upd_num_iters, hard, renormalize,
            power_iters, lowest_code_val, alignment_penalty, mxu, eps=None):
  """Allocate the scratch and the packed statistics, and enqueue the k
  steps on the current stream, the sum over the ranks between each step's
  statistics and its update; eps the group solves' early stop (None:
  none), mxu their tier."""
  global launches, last_iters, tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  s = d.shape[0]
  device = batches.device
  m = max(len(g) for g in groups)
  gm = len(groups) * m
  sel, sum_idx = fused_group_train_step._device_group_index(groups, s,
                                                            device)
  eps, words, iters, local, classic = fused_fista.segment_stop_scratch(
      lib, b, gm, m, eps, device, k, mesh.size, mxu=mxu)

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  def ptr(t):
    return None if t is None else t.data_ptr()

  dg = codes = None
  if sel is not None:
    dg, codes = empty(gm, n), empty(b, s)
  comem = ddt = smat = sdm = None
  if alignment_penalty != 0.0:
    comem = torch.from_numpy(fused_group_train_step.comembership_counts(
        groups, s)).to(device)
    ddt, smat, sdm = empty(s, s), empty(s, s), empty(s, n)
  gram, corr, gcodes = empty(gm, gm), empty(b, gm), empty(b, gm)
  pgram = empty(n, n) if gm > n else None
  grad, eta = empty(s, n), empty(1)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, gm, mxu, classic,
                                                device)
  rounded = empty((b + gm) * n) if mxu == "bf16" else None
  comm = empty(s * s + s * n + s)  # [C | B | stat], summed by one all-reduce
  hook = SumHook(mesh, comm)
  stop_hook = StopHook(mesh, local) if local is not None else None
  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_group_dp_train_segment(
        d.data_ptr(), h.data_ptr(), v.data_ptr(), batches.data_ptr(), k, b,
        s, n, gm, m, ptr(sel), ptr(sum_idx),
        0 if sum_idx is None else sum_idx.shape[1], ptr(comem),
        f32(alignment_penalty), f32(lam), num_iters, f32(upd_step),
        upd_num_iters, f32(lowest_code_val), int(variant == "fista"),
        int(hard), int(update_alg == "subspace_sc_cheap_quadratic_descent"),
        int(renormalize), power_iters, f32(b * mesh.size), ptr(dg),
        gram.data_ptr(), ptr(pgram), corr.data_ptr(), gcodes.data_ptr(),
        ptr(codes), grad.data_ptr(), ptr(ddt), ptr(smat), ptr(sdm),
        eta.data_ptr(), sk, sc, gn.data_ptr(), ptr(state), comm.data_ptr(),
        hook.pointer, f32(eps), f32(1.0 / (b * mesh.size * gm)), ptr(words),
        ptr(iters), ptr(local),
        None if stop_hook is None else stop_hook.pointer, TIER_CODES[mxu],
        ptr(rounded), stream)
  what = ("data-parallel subspace segment launch (k=%d, b=%d, s=%d, n=%d, "
          "G*M=%d, tier %s%s)" % (k, b, s, n, gm, mxu,
                                  "" if words is None else ", early stop"))
  if stop_hook is not None:
    stop_hook.check(0, what)  # the stop hook's own error first
  hook.check(err, what)
  launches += k
  if mxu != "highest":
    tier_launches += k
  if iters is not None:
    last_iters = iters
  return d, h, v, gcodes if sel is None else codes
