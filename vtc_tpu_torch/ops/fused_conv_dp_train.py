"""Whole data-parallel conv training segments: the port of TPU kernel K17,
``fused_conv_dp_train_segment_pallas`` (vtc_tpu/ops/pallas_conv_dp_train.py:
300-463, kernel ``_make_conv_dp_kernel`` :125).

``fused_conv_dp_train_segment`` keeps that function's contract and return
value ``(kernels, hessian, eigvec, last_codes_shard)``; the port's
``parallel.Mesh`` takes the place of the axis name and size.  Per batch of
this rank's (k, b_shard, c, H, W) segment: K13's warm power refresh, conv
solve and unaveraged shard statistics (``fused_conv_train.
conv_solve_stats``), their sum over the ranks, and the replicated update
from the global statistics, with one update iteration the gradient form
(grad_sum, stat), with more the gram form (bx, cm, stat), from which every
iteration's gradient is (pack(D') cm - bx) / global_b.  The semantics are
vtc_tpu's: a scan of [K13 -> psum -> replicated update]
(``parallel.build_dp_conv_fused_local_step``).

* A CUDA tensor runs ``vtc_conv_dp_train_segment`` of
  ``vtc_tpu_torch/csrc/fused_conv_train_step.cu``: the whole segment from
  one C loop on the current stream, K13's kernels and then K12's update
  kernel per step.  Where the TPU kernel all-reduces the statistics over
  remote DMA inside the kernel, the C loop calls back into Python once per
  step on a mesh of more than one rank, and the callback
  (``ops/sum_hook``, shared with K15, K16 and K18) sums the packed
  statistics with one ``torch.distributed`` all-reduce (``Mesh.sum_``),
  stream-ordered; a mesh of one rank has no callback and no host work per
  step.  Or it raises.
* A CPU tensor runs ``fused_conv_dp_train_plain``: the same composition
  from K13's plain version, ``Mesh.sum`` and the replicated update in torch
  ops.  ``chip_smoke.py`` holds the kernel against it on the card.

The gate is K13's, ``fused_conv_train.conv_solve_stats_supported``: the
TPU kernel's further terms (the shard as one VMEM tile, the comm slots
beside the solve's working set, ``fused_conv_dp_segment_supported``
:86-122) are VMEM budgets with no counterpart on the card.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test over
the ranks (:143-213): each solve's iteration sums |codes - old| on the
device (csrc/conv_gemm.cuh, "The early stop"), over the global batch's
count; at a world above one the C loop calls ``ops/sum_hook.StopHook``
once per iteration, which sums the rank's one-float share with
``Mesh.sum_`` (the same bits on every rank), and a one-thread kernel
decides, so every rank stops at the same count, as vtc_tpu's one slot
all-reduce an iteration.  At a world of one there is no hook.
``last_iters`` (a private test hook) is the int32 device tensor of the
last stopped segment's counts, one a step.  ``mxu`` is the solves' tier
(vtc_tpu's, :129-134, the tile solver of K12 and K13): each step's corr,
synthesis and analysis at the tier on conv_gemm_tier.cuh's bf16
tensor-core GEMM, the weights split once a step; the statistics, their
sum over the ranks, the stop's share and the update stay fp32.
``launches`` counts the train steps the kernel ran, ``tier_launches``
those at a tier.
"""
import ctypes

import torch

from vtc_tpu_torch.ops import conv_shapes, fused_conv_direct, fused_conv_train
from vtc_tpu_torch.ops.precision import resolve_tier
from vtc_tpu_torch.ops.sum_hook import StopHook, SumHook
from vtc_tpu_torch.parallel import data_parallel

launches = 0
tier_launches = 0
last_iters = None  # int32 device tensor (k,): the last stopped segment's


def fused_conv_dp_train_plain(dictionary, hessian, eigvec, batches,
                              sparsity_weight, inf_num_iters, upd_stepsize, *,
                              mesh, kernel_stride, padding, variant="fista",
                              update_alg="sc_cheap_quadratic_descent",
                              upd_num_iters=1, nonneg=False, hard=False,
                              renormalize=True, power_iters=12,
                              lowest_code_val=0.001, precision=None,
                              early_stopping_epsilon=None, mxu="highest"):
  """The plain PyTorch version of the segment, on any device and in the
  inputs' own float type (float64 inputs give the oracle): per batch K13's
  plain version, the sum over ``mesh`` and the replicated update.
  ``precision`` is the matmul precision of the solve (default 'highest'),
  ``mxu`` its tier; ``early_stopping_epsilon`` the solve's stop test on the mean over the
  ranks (ops/solver.py with ``psum_axes=mesh``: with the equal shards
  every rank takes, the global batch's mean), so every rank stops at the
  same iteration."""
  gram = int(upd_num_iters) > 1
  d, h, v = dictionary, hessian, eigvec
  codes = None
  for batch in batches:
    out = fused_conv_train.conv_solve_stats_plain(
        d, v, batch, sparsity_weight, inf_num_iters,
        kernel_stride=kernel_stride, padding=padding, variant=variant,
        nonneg=nonneg, hard=hard, power_iters=power_iters, gram_stats=gram,
        precision=precision, early_stopping_epsilon=early_stopping_epsilon,
        psum_axes=mesh, mxu=mxu)
    codes, stats, v = out[0], out[1:-2], out[-2]
    d, h = data_parallel.conv_replicated_update(
        mesh, d, h, stats, batch.shape, upd_stepsize, upd_num_iters,
        kernel_stride=kernel_stride,
        uses_hessian=update_alg == "sc_cheap_quadratic_descent",
        renormalize=renormalize, lowest_code_val=lowest_code_val)
  return d, h, v, codes


def fused_conv_dp_train_segment(dictionary, hessian, eigvec, batches,
                                sparsity_weight, inf_num_iters, upd_stepsize,
                                *, mesh, kernel_stride, padding,
                                variant="fista",
                                update_alg="sc_cheap_quadratic_descent",
                                upd_num_iters=1, nonneg=False, hard=False,
                                renormalize=True, power_iters=12,
                                lowest_code_val=0.001, mxu="highest",
                                early_stopping_epsilon=None):
  """Run ``batches.shape[0]`` data-parallel conv train steps on this rank.

  Every rank of ``mesh`` calls it in step, with the same replicated state
  and its own shard of every batch.

  Args:
    dictionary: (s, c, kh, kw) float32 kernels, replicated.
    hessian: (s,) conv Hessian-diagonal EMA (unchanged by steepest
      descent), replicated.
    eigvec: (s,) warm eigenvector of the flat-kernel Gram (normalized
      here), replicated; seed it with ``lipschitz.top_gram_eigenpair`` of
      the flattened kernels.
    batches: (k, b_shard, c, H, W) float32 padded images, this rank's
      shards, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars.
    mesh: the ``parallel.Mesh`` the ranks share.
    kernel_stride / padding: the geometry; it must pass
      ``fused_conv_train.conv_solve_stats_supported`` at
      ``upd_num_iters`` (ValueError otherwise, on any device).
    variant / update_alg / upd_num_iters / nonneg / hard / renormalize /
      power_iters / lowest_code_val: as in vtc_tpu.
    mxu: the solves' tier, 'highest' (IEEE fp32), 'bf16x5', 'bf16x3' or
      'bf16' ('default').
    early_stopping_epsilon: optional; each step's solve stops after the
      first iteration k > 0 whose mean |codes_k - codes_{k-1}| / eta over
      the global batch is below it, on every rank at the same count.

  Returns:
    (kernels, hessian, eigvec, last_codes): new tensors, replicated but for
    last_codes, the (b_shard, s, code_h, code_w) codes of this rank's final
    shard.  The inputs are not modified.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in fused_conv_train.UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s"
                     % (fused_conv_train.UPDATE_ALGS,))
  mxu = resolve_tier(mxu)

  def require(cond, message):
    if not cond:
      raise ValueError("fused_conv_dp_train_segment: " + message)

  require(batches.dim() == 5 and batches.shape[0] >= 1
          and batches.shape[1] >= 1,
          "batches must be (k, b_shard, c, H, W) with k, b_shard >= 1, got %s"
          % (tuple(batches.shape),))
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  shard_shape = tuple(batches.shape[1:])
  require(fused_conv_train.conv_solve_stats_supported(
      shard_shape, tuple(dictionary.shape), kernel_stride, variant,
      update_alg, upd_num_iters=upd_num_iters, padding=padding),
          "configuration outside the gate "
          "(fused_conv_train.conv_solve_stats_supported())")
  flags = dict(kernel_stride=kernel_stride, padding=padding, variant=variant,
               update_alg=update_alg, upd_num_iters=int(upd_num_iters),
               nonneg=bool(nonneg), hard=bool(hard),
               renormalize=bool(renormalize), power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val))
  if batches.device.type == "cpu":
    return fused_conv_dp_train_plain(
        dictionary, hessian, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize), mesh=mesh,
        early_stopping_epsilon=early_stopping_epsilon, mxu=mxu, **flags)
  require(batches.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batches.device))
  device = batches.device
  s = dictionary.shape[0]
  for name, t, shape in (("dictionary", dictionary, tuple(dictionary.shape)),
                         ("hessian", hessian, (s,)),
                         ("eigvec", eigvec, (s,))):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == shape,
            "%s must be a float32 %s tensor on %s" % (name, shape, device))
  require(batches.dtype == torch.float32, "batches must be float32")
  require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
          and int(power_iters) >= 0, "iteration counts must be >= 0")
  k = batches.shape[0]
  geo = fused_conv_direct.geometry(shard_shape, dictionary.shape,
                                   kernel_stride)
  dstk, mblk, xblk, supp = fused_conv_train.segment_inputs(
      dictionary, batches, padding, geo)
  d, h, v, codes = _launch(
      dstk.clone(), hessian.contiguous().clone(), eigvec.contiguous().clone(),
      xblk, mblk, supp, geo, k, mesh, float(sparsity_weight),
      int(inf_num_iters), float(upd_stepsize), eps=early_stopping_epsilon,
      mxu=mxu, **{key: flags[key] for key in (
          "variant", "update_alg", "upd_num_iters", "nonneg", "hard",
          "renormalize", "power_iters", "lowest_code_val")})
  kernels = fused_conv_direct.unpack_dstk(d, geo, dictionary.shape)
  return kernels.contiguous(), h, v, codes


def _launch(dstk, h, v, xblk, mblk, supp, geo, k, mesh, lam, num_iters,
            upd_step, *, variant, update_alg, upd_num_iters, nonneg, hard,
            renormalize, power_iters, lowest_code_val, eps=None,
            mxu="highest"):
  """Allocate the scratch and the packed statistics, and enqueue the k
  steps on the current stream, the sum over the ranks between each step's
  statistics and its update; eps the early stop's threshold (None:
  none), its share summed over the ranks once per solver iteration; mxu
  the resolved tier."""
  global launches, tier_launches, last_iters
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  device = dstk.device
  tier, planes = fused_conv_direct.tier_scratch(
      lib, mxu, geo, device, "fused_conv_dp_train_segment")
  b = xblk.shape[0] // k
  s, cpx, r = geo["s"], geo["cpx"], geo["r"]
  rs = r * s
  bh, bw, ch, cw = geo["bh"], geo["bw"], geo["code_h"], geo["code_w"]
  splits = -(-(b * bh * bw) // lib.vtc_conv_train_chunk())
  gram = int(upd_num_iters) > 1

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  dall, gram_mat, eta = empty(s, r * cpx), empty(s, s), empty(1)
  img, corr = empty(b, cpx, bh, bw), empty(b, s, ch, cw)
  z, old = empty(b, s, ch, cw), empty(b, s, ch, cw)
  partial = empty(splits, max(cpx, rs) if gram else cpx, rs)
  grad = empty(cpx, rs)
  # [cm | bx | stat] or [grad_sum | stat], summed by one all-reduce
  comm = empty((rs * rs if gram else 0) + cpx * rs + s)
  hook = SumHook(mesh, comm)
  eps, words, iters = fused_conv_direct.stop_scratch(
      lib, s, b * ch * cw, eps, device, steps=k)
  local = None if words is None or mesh.size == 1 else empty(1)
  stop_hook = None if local is None else StopHook(mesh, local)
  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_conv_dp_train_segment(
        dstk.data_ptr(), h.data_ptr(), v.data_ptr(), xblk.data_ptr(),
        mblk.data_ptr(), None if supp is None else supp.data_ptr(), k, b, s,
        cpx, geo["ay"], geo["ax"], bh, bw, f32(lam), num_iters,
        f32(upd_step), upd_num_iters, f32(lowest_code_val),
        int(variant == "fista"), fused_conv_direct._MODES[(nonneg, hard)],
        int(update_alg == "sc_cheap_quadratic_descent"), int(renormalize),
        power_iters, int(gram), f32(b * mesh.size), dall.data_ptr(),
        gram_mat.data_ptr(), eta.data_ptr(), img.data_ptr(), corr.data_ptr(),
        z.data_ptr(), old.data_ptr(), partial.data_ptr(), grad.data_ptr(),
        comm.data_ptr(), hook.pointer, f32(eps),
        f32(1.0 / (b * mesh.size * s * ch * cw)),
        fused_conv_direct.ptr(words), fused_conv_direct.ptr(iters),
        fused_conv_direct.ptr(local),
        None if stop_hook is None else stop_hook.pointer, tier,
        fused_conv_direct.ptr(planes), stream)
  what = ("data-parallel conv segment launch (k=%d, b=%d, s=%d, cpx=%d, "
          "R=%d, gram form %s, mxu=%s%s)" % (
              k, b, s, cpx, r, gram, mxu,
              "" if words is None else ", early stop"))
  if stop_hook is not None:
    stop_hook.check(0, what)
  hook.check(err, what)
  launches += k
  if tier:
    tier_launches += k
  if iters is not None:
    last_iters = iters
  return dstk, h, v, old
