"""Fused conv train steps over a segment: the port of TPU kernel K12,
``fused_conv_train_segment_pallas`` (vtc_tpu/ops/pallas_conv_train.py:
547-755, kernel ``_make_segment_kernel`` :374).

``fused_conv_train_segment`` keeps that function's contract and return
value ``(kernels, hessian, eigvec, last_codes)``.  Per batch of the
(k, b, c, H, W) segment: the warm power refresh of the flat-kernel Gram's
eigenvector, K10's conv FISTA or ISTA solve at stepsize 1/eigval, the conv
Hessian-diagonal EMA (cheap quadratic only) and ``upd_num_iters``
stride-block updates at the current kernels, each projected onto the real
kernel support, Hessian-scaled, rescaled to the Frobenius norm, stepped
and renormalized per kernel.

* A CUDA tensor runs the hand-written kernels of
  ``vtc_tpu_torch/csrc/fused_conv_train_step.cu`` (built at first use by
  ``ops/_build.py``), whose solve is K10's, on the current stream; or
  raises.  The weights are packed, and the masked images cut into stride
  blocks, with torch ops outside the kernels, as vtc_tpu does with XLA
  outside the ``pallas_call`` (:643-671).
* A CPU tensor runs ``fused_conv_train_plain``, the composition the JAX
  tests use as K12's reference (tests/test_pallas_conv_train.py:18-35):
  ``lipschitz.power_iterate`` on the flat kernels ->
  ``fused_conv_direct_plain`` -> ``hessian_diagonal_ema`` -> the conv
  update rule's block ``_update``.  ``chip_smoke.py`` holds the kernels
  against it on the card.

The card has no batch tiles: every batch runs as one tile, the single-tile
semantics.  So the gate keeps vtc_tpu's math (K10's geometry, s <= R*cpx,
ista/fista, the two update rules, no groups) and drops the TPU's VMEM
tile fit (``_fits``, ``_pick_tile`` :115-139); the gram-form tile
accumulators (:501-516), which only tiled batches use, have no
counterpart.  ``early_stopping_epsilon`` runs each step's solve with
vtc_tpu's batch-global stop test (:320-344) on the card, decided on the
device (csrc/conv_gemm.cuh, "The early stop"); ``last_iters`` (a private
test hook) is the int32 device tensor of the last stopped segment's
counts, one a step.  ``mxu`` is vtc_tpu's tier of the tile solver's
products (``_make_deep_dot``, :240-300): at 'bf16x5', 'bf16x3' or 'bf16'
each step's corr, synthesis and analysis run at the tier (on the card
conv_gemm_tier.cuh's bf16 tensor-core GEMM, the weights split once a
step; in the plain version ``fused_conv_direct.conv_deep_dot``); the Gram,
the power refresh, the Hessian EMA and the update stay fp32.  Left out:
the TPU knobs ``batch_tile`` and ``interpret``.  ``launches`` counts the
train steps the kernels ran, ``tier_launches`` those at a tier.

Also here, the port of TPU kernel K13, ``conv_solve_stats_pallas``
(pallas_conv_train.py:840-971, kernel ``_make_stats_kernel`` :776): one
data-parallel shard's step, ``conv_solve_stats``.  It runs K12's warm
refresh and solve and, in place of the update, the shard's unaveraged
block-space statistics, which the caller sums over the ranks: the gradient
sum and the Hessian statistic, or with ``gram_stats`` the packed pair
(bx, cm) from which the gradient at any dictionary follows.  A CUDA tensor
runs ``vtc_conv_solve_stats`` of the same ``.cu`` file (whose first half
is K12's own) or raises; a CPU tensor runs ``conv_solve_stats_plain``.
K13's ``mxu`` is K12's: the solve at the tier, the statistics fp32
(vtc_tpu :829-833).  ``stats_launches`` counts the steps that kernel ran,
``stats_tier_launches`` those at a tier; ``conv_solve_stats_supported``
is the data-parallel trainer's gate, for K13's composition and K17
(ops/fused_conv_dp_train) alike.
"""
import ctypes

import torch

from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_cheap_quadratic_descent as conv_cqd)
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_steepest_descent as conv_sd)
from vtc_tpu_torch.ops import conv_shapes, fused_conv_direct, lipschitz
from vtc_tpu_torch.ops.precision import matmul_precision, resolve_tier

launches = 0
tier_launches = 0
stats_launches = 0
stats_tier_launches = 0
last_iters = None  # int32 device tensor (k,): the last stopped segment's

UPDATE_ALGS = ("sc_steepest_descent", "sc_cheap_quadratic_descent")


def gram_stats_supported(img_shape, dict_shape, kernel_stride, padding):
  """vtc_tpu's gate for exact gram-form update statistics
  (pallas_conv_train.py:155-165): each padding amount a multiple of its
  stride and the kernels stride multiples, so the block mask factors per
  stride block.  The port's segment runs single-tile and never needs
  them; ``conv_solve_stats(gram_stats=True)`` does."""
  del img_shape
  if padding is not None:
    (pv0, pv1), (ph0, ph1) = padding
    sv, sh_ = kernel_stride
    if pv0 % sv or pv1 % sv or ph0 % sh_ or ph1 % sh_:
      return False
  _, _, kh, kw = dict_shape
  return kh % kernel_stride[0] == 0 and kw % kernel_stride[1] == 0


def _geometry_supported(img_shape, dict_shape, kernel_stride):
  """K10's geometry with the (s, s) flat-kernel Gram: what the kernels of
  this file take, whatever the algorithms."""
  kernel_stride = tuple(int(x) for x in kernel_stride)
  if not fused_conv_direct.supported(img_shape, dict_shape, kernel_stride):
    return False
  geo = fused_conv_direct.geometry(img_shape, dict_shape, kernel_stride)
  return geo["s"] <= geo["r"] * geo["cpx"]


def fused_conv_segment_supported(img_shape, dict_shape, kernel_stride,
                                 inference_alg, update_alg, *,
                                 group_assignments=None, upd_num_iters=1,
                                 padding=None, early_stopping_epsilon=None):
  """True when ``fused_conv_train_segment`` covers this configuration
  (vtc_tpu pallas_conv_train.py:168-208 without the VMEM tile rule, so
  ``upd_num_iters``, ``padding`` and ``early_stopping_epsilon`` decide
  nothing here: the whole batch is one tile)."""
  del upd_num_iters, padding, early_stopping_epsilon
  if group_assignments is not None:
    return False
  if inference_alg not in ("ista", "fista") or update_alg not in UPDATE_ALGS:
    return False
  return _geometry_supported(img_shape, dict_shape, kernel_stride)


def conv_solve_stats_supported(img_shape, dict_shape, kernel_stride,
                               inference_alg, update_alg, *, upd_num_iters=1,
                               padding=None):
  """True when ``conv_solve_stats`` covers this shard configuration at
  ``upd_num_iters`` update iterations, and so K13's composition and K17
  (ops/fused_conv_dp_train) do (vtc_tpu pallas_conv_train.py:758-773
  without the VMEM tile fit): one update iteration always (the summed
  gradient is exact at the solve dictionary); more need the gram-form
  statistics, so a stride-block-uniform mask (``gram_stats_supported``).
  ``padding`` None is the all-ones mask, as the wrapper and vtc_tpu's
  trainer read it (vtc_tpu's gate refuses it at more than one iteration,
  where nothing of vtc_tpu asks it)."""
  if not fused_conv_segment_supported(img_shape, dict_shape, kernel_stride,
                                      inference_alg, update_alg):
    return False
  if int(upd_num_iters) <= 1:
    return True
  return gram_stats_supported(
      img_shape, dict_shape, tuple(int(x) for x in kernel_stride),
      conv_shapes.normalize_padding(padding))


def fused_conv_train_plain(dictionary, hessian, eigvec, batches,
                           sparsity_weight, inf_num_iters, upd_stepsize, *,
                           kernel_stride, padding, variant="fista",
                           update_alg="sc_cheap_quadratic_descent",
                           upd_num_iters=1, nonneg=False, hard=False,
                           renormalize=True, power_iters=12,
                           lowest_code_val=0.001,
                           early_stopping_epsilon=None, precision=None,
                           return_stepsize=False, mxu="highest"):
  """The plain PyTorch version of the fused conv segment, on any device
  and in the inputs' own float type (float64 inputs give the oracle).

  ``precision`` is the matmul precision of the solve and the update
  (default 'highest'); 'tensorfloat32' shows what TF32 products would
  cost.  ``mxu`` is the solve's tier (float32 inputs).  The power refresh
  always runs at 'highest', as in every tier of the TPU kernel.
  """
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  d, h, v = dictionary, hessian, eigvec
  s = d.shape[0]
  codes = eta = None
  for batch in batches:
    eigval, v = lipschitz.power_iterate(d.reshape(s, -1), v,
                                        int(power_iters))
    eta = 1.0 / eigval
    codes = fused_conv_direct.fused_conv_direct_plain(
        batch, d, sparsity_weight, inf_num_iters, eta,
        kernel_stride=kernel_stride, padding=padding, variant=variant,
        nonneg=nonneg, hard=hard,
        early_stopping_epsilon=early_stopping_epsilon, precision=precision,
        mxu=mxu)
    mask = conv_shapes.create_mask(batch.shape, padding, batch.dtype,
                                   batch.device)
    if update_alg == "sc_cheap_quadratic_descent":
      h = conv_cqd.hessian_diagonal_ema(h, codes)
      d = conv_cqd._update(batch, d, codes, h, mask, kernel_stride,
                           upd_stepsize, upd_num_iters, lowest_code_val,
                           renormalize, padding, "block", precision)
    else:
      d = conv_sd._update(batch, d, codes, mask, kernel_stride, upd_stepsize,
                          upd_num_iters, renormalize, padding, "block",
                          precision)
  if return_stepsize:
    return d, h, v, codes, eta.reshape(1)
  return d, h, v, codes


def _require(cond, message):
  if not cond:
    raise ValueError("fused_conv_train_segment: " + message)


def fused_conv_train_segment(dictionary, hessian, eigvec, batches,
                             sparsity_weight, inf_num_iters, upd_stepsize, *,
                             kernel_stride, padding, variant="fista",
                             update_alg="sc_cheap_quadratic_descent",
                             upd_num_iters=1, nonneg=False, hard=False,
                             renormalize=True, power_iters=12,
                             lowest_code_val=0.001, mxu="highest",
                             early_stopping_epsilon=None,
                             return_stepsize=False):
  """Run ``batches.shape[0]`` fused conv train steps.

  Args:
    dictionary: (s, c, kh, kw) float32 kernels.
    hessian: (s,) conv Hessian-diagonal EMA (unchanged by steepest
      descent).
    eigvec: (s,) warm eigenvector of the flat-kernel Gram (normalized
      here); seed it with ``lipschitz.top_gram_eigenpair`` of the
      flattened kernels.
    batches: (k, b, c, H, W) float32 padded images, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars.
    kernel_stride: (sv, sh); padding: ((lv, tv), (lh, th)) or None; the
      geometry must pass ``fused_conv_segment_supported``.
    variant / update_alg / upd_num_iters / nonneg / hard / renormalize /
      power_iters / lowest_code_val: as in vtc_tpu (power_iters 12 is the
      robust default; the trainer passes 2 from an exact seed).
    mxu: the solves' tier, 'highest' (IEEE fp32), 'bf16x5', 'bf16x3' or
      'bf16' ('default').
    early_stopping_epsilon: optional; each step's solve stops after the
      first iteration k > 0 whose mean |codes_k - codes_{k-1}| / eta is
      below it (the batch-global test, decided on the device).
    return_stepsize: also return the final step's stepsize 1/eigval, a
      one-element tensor.

  Returns:
    (kernels, hessian, eigvec, last_codes[, stepsize]): new tensors; the
    inputs are not modified.  last_codes is the (b, s, code_h, code_w)
    codes of the final step.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s" % (UPDATE_ALGS,))
  mxu = resolve_tier(mxu)
  _require(batches.dim() == 5 and batches.shape[0] >= 1,
           "batches must be (k, b, c, H, W) with k >= 1, got %s"
           % (tuple(batches.shape),))
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  flags = dict(kernel_stride=kernel_stride, padding=padding, variant=variant,
               update_alg=update_alg, upd_num_iters=int(upd_num_iters),
               nonneg=bool(nonneg), hard=bool(hard),
               renormalize=bool(renormalize), power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val))
  if batches.device.type == "cpu":
    return fused_conv_train_plain(
        dictionary, hessian, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize),
        early_stopping_epsilon=early_stopping_epsilon,
        return_stepsize=return_stepsize, mxu=mxu, **flags)
  _require(batches.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(batches.device))
  device = batches.device
  k = batches.shape[0]
  img_shape = tuple(batches.shape[1:])
  _require(dictionary.dim() == 4 and dictionary.shape[1] == img_shape[1],
           "dictionary must be (s, %d, kh, kw), got %s"
           % (img_shape[1], tuple(dictionary.shape)))
  s = dictionary.shape[0]
  for name, t, shape in (("dictionary", dictionary, tuple(dictionary.shape)),
                         ("hessian", hessian, (s,)),
                         ("eigvec", eigvec, (s,))):
    _require(t.device == device and t.dtype == torch.float32
             and tuple(t.shape) == shape,
             "%s must be a float32 %s tensor on %s" % (name, shape, device))
  _require(batches.dtype == torch.float32, "batches must be float32")
  _require(img_shape[0] > 0, "empty batch")
  _require(fused_conv_segment_supported(img_shape, dictionary.shape,
                                        kernel_stride, variant, update_alg),
           "geometry outside the kernels' gate "
           "(fused_conv_segment_supported())")
  _require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
           and int(power_iters) >= 0, "iteration counts must be >= 0")
  geo = fused_conv_direct.geometry(img_shape, dictionary.shape,
                                   kernel_stride)
  dstk, mblk, xblk, supp = segment_inputs(dictionary, batches, padding, geo)
  d, h, v, codes, eta = _launch(
      dstk.clone(), hessian.contiguous().clone(),
      eigvec.contiguous().clone(), xblk, mblk, supp, geo, k,
      float(sparsity_weight), int(inf_num_iters), float(upd_stepsize),
      eps=early_stopping_epsilon, mxu=mxu,
      **{key: flags[key] for key in (
          "variant", "update_alg", "upd_num_iters", "nonneg", "hard",
          "renormalize", "power_iters", "lowest_code_val")})
  kernels = fused_conv_direct.unpack_dstk(d, geo, dictionary.shape)
  out = (kernels.contiguous(), h, v, codes)
  return out + (eta,) if return_stepsize else out


def segment_inputs(dictionary, batches, padding, geo):
  """What the segment kernels take of a (k, b, c, H, W) segment, made with
  torch ops: the packed kernels dstk (cpx, R*s), the block mask mblk, the
  masked image blocks xblk (k*b, cpx, bh, bw) and, for zero-extended
  kernels, the real-support mask supp (cpx, R*s), else None."""
  img_shape = tuple(batches.shape[1:])
  with matmul_precision():
    dstk, _ = fused_conv_direct.pack_weights(dictionary, geo)
    mask_img, mblk = fused_conv_direct.block_mask(
        img_shape, padding, geo, torch.float32, batches.device)
    xblk = fused_conv_direct.blockify(
        mask_img * batches.reshape((-1,) + img_shape[1:]), geo).contiguous()
    supp = None
    if geo["ekh"] or geo["ekw"]:  # zero-extended: the real-support mask
      supp = fused_conv_direct.pack_weights(torch.ones_like(dictionary),
                                            geo)[0]
  return dstk, mblk, xblk, supp


def _launch(dstk, h, v, xblk, mblk, supp, geo, k, lam, num_iters, upd_step,
            *, variant, update_alg, upd_num_iters, nonneg, hard, renormalize,
            power_iters, lowest_code_val, eps=None, mxu="highest"):
  """Allocate the scratch and enqueue the k steps on the current stream;
  eps the early stop's threshold (None: none), mxu the resolved tier."""
  global launches, tier_launches, last_iters
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  device = dstk.device
  tier, planes = fused_conv_direct.tier_scratch(
      lib, mxu, geo, device, "fused_conv_train_segment")
  b = xblk.shape[0] // k
  s, cpx, r = geo["s"], geo["cpx"], geo["r"]
  bh, bw, ch, cw = geo["bh"], geo["bw"], geo["code_h"], geo["code_w"]
  splits = -(-(b * bh * bw) // lib.vtc_conv_train_chunk())

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  dall, gram, eta = empty(s, r * cpx), empty(s, s), empty(1)
  img, corr = empty(b, cpx, bh, bw), empty(b, s, ch, cw)
  z, old = empty(b, s, ch, cw), empty(b, s, ch, cw)
  partial, grad = empty(splits, cpx, r * s), empty(cpx, r * s)
  eps, words, iters = fused_conv_direct.stop_scratch(
      lib, s, b * ch * cw, eps, device, steps=k)
  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_conv_train_segment(
        dstk.data_ptr(), h.data_ptr(), v.data_ptr(), xblk.data_ptr(),
        mblk.data_ptr(), None if supp is None else supp.data_ptr(), k, b, s,
        cpx, geo["ay"], geo["ax"], bh, bw, f32(lam), num_iters,
        f32(upd_step), upd_num_iters, f32(lowest_code_val),
        int(variant == "fista"),
        fused_conv_direct._MODES[(nonneg, hard)],
        int(update_alg == "sc_cheap_quadratic_descent"), int(renormalize),
        power_iters, dall.data_ptr(), gram.data_ptr(), eta.data_ptr(),
        img.data_ptr(), corr.data_ptr(), z.data_ptr(), old.data_ptr(),
        partial.data_ptr(), grad.data_ptr(), f32(eps),
        f32(1.0 / (b * s * ch * cw)), fused_conv_direct.ptr(words),
        fused_conv_direct.ptr(iters), tier, fused_conv_direct.ptr(planes),
        stream)
  if err != 0:
    raise RuntimeError(
        "fused conv train step launch failed with CUDA error %d (k=%d, "
        "b=%d, s=%d, cpx=%d, R=%d, mxu=%s%s)" % (
            err, k, b, s, cpx, r, mxu,
            "" if words is None else ", early stop"))
  launches += k
  if tier:
    tier_launches += k
  if iters is not None:
    last_iters = iters
  return dstk, h, v, old, eta


def conv_solve_stats_plain(dictionary, eigvec, batch, sparsity_weight,
                           inf_num_iters, *, kernel_stride, padding,
                           variant="fista", nonneg=False, hard=False,
                           power_iters=12, gram_stats=False, precision=None,
                           early_stopping_epsilon=None, psum_axes=None,
                           mxu="highest"):
  """The plain PyTorch version of ``conv_solve_stats``, on any device and
  in the inputs' own float type: ``lipschitz.power_iterate`` on the flat
  kernels -> ``fused_conv_direct_plain`` -> the block statistics of
  ``fused_conv_direct.build_block_update_stats`` (the composition of
  vtc_tpu's tests/test_pallas_conv_train.py:180-215).  ``precision`` is
  the matmul precision of the solve ('tensorfloat32' shows what TF32
  products would cost), ``mxu`` its tier; the refresh and the statistics
  stay at 'highest', as in every tier of the TPU kernel (:829-833).
  ``early_stopping_epsilon`` and ``psum_axes`` are the solve's stop test
  over the ranks, which K17's plain version takes through this function
  (K13 itself has none)."""
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  s = dictionary.shape[0]
  eigval, v = lipschitz.power_iterate(dictionary.reshape(s, -1), eigvec,
                                      int(power_iters))
  eta = 1.0 / eigval
  codes = fused_conv_direct.fused_conv_direct_plain(
      batch, dictionary, sparsity_weight, inf_num_iters, eta,
      kernel_stride=kernel_stride, padding=padding, variant=variant,
      nonneg=nonneg, hard=hard, precision=precision,
      early_stopping_epsilon=early_stopping_epsilon, psum_axes=psum_axes,
      mxu=mxu)
  stats = fused_conv_direct.build_block_update_stats(
      batch, codes, dictionary.shape, kernel_stride, padding)
  stat = torch.sum(codes * codes, dim=(0, 2, 3))
  if not gram_stats:
    # the batch-averaged gradient with a batch of 1: the unaveraged sum
    grad_sum = fused_conv_direct.dictionary_gradient_from_block_stats(
        dict(stats, batch=1), dictionary)
    return codes, grad_sum, stat, v, eta
  zstack = stats["zstack"]
  b, rs = zstack.shape[:2]
  z = zstack.reshape(b, rs, -1)
  with matmul_precision():
    m_row = stats["mblk"][0].reshape(1, 1, -1)  # the block-uniform mask
    cm = torch.einsum("bkn,bln->kl", z * m_row, z)
    bx = torch.einsum("bpn,bkn->pk", stats["xblk"].reshape(b, -1, z.shape[2]),
                      z)
  return codes, bx, cm, stat, v, eta


def conv_solve_stats(dictionary, eigvec, batch, sparsity_weight,
                     inf_num_iters, *, kernel_stride, padding, variant="fista",
                     nonneg=False, hard=False, power_iters=12,
                     gram_stats=False, mxu="highest",
                     early_stopping_epsilon=None):
  """One data-parallel shard's conv solve+stats step.

  Args:
    dictionary: (s, c, kh, kw) float32 kernels, the replicated dictionary.
    eigvec: (s,) warm eigenvector of the flat-kernel Gram (normalized
      here).
    batch: (b, c, H, W) float32 padded images, this rank's shard.
    sparsity_weight, inf_num_iters: Python scalars.
    kernel_stride / padding: the geometry; it must pass
      ``conv_solve_stats_supported``, and with ``gram_stats`` also
      ``gram_stats_supported`` (ValueError otherwise, on any device).
    variant / nonneg / hard / power_iters: as in vtc_tpu.
    mxu: the solve's tier, 'highest' (IEEE fp32), 'bf16x5', 'bf16x3' or
      'bf16' ('default'); the statistics stay fp32.
    early_stopping_epsilon: None only (vtc_tpu's kernel has no stop test;
      vtc_tpu's data-parallel stop is K17's): NotImplementedError.

  Returns:
    gram_stats False: (codes (b, s, ch, cw), grad_sum (s, c, kh, kw), stat
    (s,), new_eigvec, eta), grad_sum the masked-residual kernel gradient
    summed over the shard: the full-batch gradient at the solve dictionary
    is the sum over the shards divided by the global batch.
    gram_stats True: (codes, bx (cpx, R*s), cm (R*s, R*s), stat,
    new_eigvec, eta) in packed block space: the gradient at any D' is
    (fused_conv_direct.pack_weights(D')[0] @ sum(cm) - sum(bx)) / global_b.
    New tensors; eta is 0-d.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  mxu = resolve_tier(mxu)
  if early_stopping_epsilon is not None:
    raise NotImplementedError(
        "conv_solve_stats has no early stop, as vtc_tpu's K13 has none; "
        "the data-parallel conv stop is K17's")
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)

  def require(cond, message):
    if not cond:
      raise ValueError("conv_solve_stats: " + message)

  require(batch.dim() == 4 and dictionary.dim() == 4
          and batch.shape[1] == dictionary.shape[1],
          "shapes must be (b, c, H, W) and (s, c, kh, kw), got %s and %s"
          % (tuple(batch.shape), tuple(dictionary.shape)))
  require(not gram_stats or gram_stats_supported(
      batch.shape, dictionary.shape, kernel_stride, padding),
          "gram_stats needs a stride-block-uniform mask and kernels that "
          "are stride multiples (gram_stats_supported())")
  if batch.device.type == "cpu":
    return conv_solve_stats_plain(
        dictionary, eigvec, batch, float(sparsity_weight), int(inf_num_iters),
        kernel_stride=kernel_stride, padding=padding, variant=variant,
        nonneg=bool(nonneg), hard=bool(hard), power_iters=int(power_iters),
        gram_stats=bool(gram_stats), mxu=mxu)
  require(batch.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batch.device))
  device = batch.device
  s = dictionary.shape[0]
  for name, t, shape in (("dictionary", dictionary, tuple(dictionary.shape)),
                         ("eigvec", eigvec, (s,)),
                         ("batch", batch, tuple(batch.shape))):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == shape,
            "%s must be a float32 %s tensor on %s" % (name, shape, device))
  require(batch.shape[0] > 0, "empty batch")
  require(_geometry_supported(batch.shape, dictionary.shape, kernel_stride),
          "geometry outside the kernels' gate (conv_solve_stats_supported())")
  require(int(inf_num_iters) >= 0 and int(power_iters) >= 0,
          "iteration counts must be >= 0")
  geo = fused_conv_direct.geometry(batch.shape, dictionary.shape,
                                   kernel_stride)
  with matmul_precision():
    dstk, _ = fused_conv_direct.pack_weights(dictionary, geo)
    mask_img, mblk = fused_conv_direct.block_mask(batch.shape, padding, geo,
                                                  torch.float32, device)
    xblk = fused_conv_direct.blockify(mask_img * batch, geo).contiguous()
  codes, out, cm, stat, v, eta = _launch_stats(
      dstk, eigvec.contiguous().clone(), xblk, mblk, geo,
      float(sparsity_weight), int(inf_num_iters), variant=variant,
      nonneg=bool(nonneg), hard=bool(hard), power_iters=int(power_iters),
      gram_stats=bool(gram_stats), mxu=mxu)
  if gram_stats:
    return codes, out, cm, stat, v, eta
  grad_sum = fused_conv_direct.unpack_dstk(out, geo, dictionary.shape)
  return codes, grad_sum.contiguous(), stat, v, eta


def _launch_stats(dstk, v, xblk, mblk, geo, lam, num_iters, *, variant,
                  nonneg, hard, power_iters, gram_stats, mxu="highest"):
  """Allocate the scratch and enqueue one shard's step on the current
  stream; mxu the resolved tier."""
  global stats_launches, stats_tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  device = dstk.device
  tier, planes = fused_conv_direct.tier_scratch(lib, mxu, geo, device,
                                                "conv_solve_stats")
  b = xblk.shape[0]
  s, cpx, r = geo["s"], geo["cpx"], geo["r"]
  bh, bw, ch, cw = geo["bh"], geo["bw"], geo["code_h"], geo["code_w"]
  splits = -(-(b * bh * bw) // lib.vtc_conv_train_chunk())

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  rows = max(cpx, r * s) if gram_stats else cpx
  dall, gram, eta = empty(s, r * cpx), empty(s, s), empty(1)
  img, corr = empty(b, cpx, bh, bw), empty(b, s, ch, cw)
  z, old = empty(b, s, ch, cw), empty(b, s, ch, cw)
  partial, out = empty(splits, rows, r * s), empty(cpx, r * s)
  cm = empty(r * s, r * s) if gram_stats else None
  stat = empty(s)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_conv_solve_stats(
        dstk.data_ptr(), v.data_ptr(), xblk.data_ptr(), mblk.data_ptr(), b,
        s, cpx, geo["ay"], geo["ax"], bh, bw, ctypes.c_float(lam), num_iters,
        int(variant == "fista"), fused_conv_direct._MODES[(nonneg, hard)],
        power_iters, int(gram_stats), dall.data_ptr(), gram.data_ptr(),
        eta.data_ptr(), img.data_ptr(), corr.data_ptr(), z.data_ptr(),
        old.data_ptr(), partial.data_ptr(), out.data_ptr(),
        None if cm is None else cm.data_ptr(), stat.data_ptr(), tier,
        fused_conv_direct.ptr(planes), stream)
  if err != 0:
    raise RuntimeError(
        "conv solve+stats launch failed with CUDA error %d (b=%d, s=%d, "
        "cpx=%d, R=%d, gram_stats=%s, mxu=%s)" % (err, b, s, cpx, r,
                                                 gram_stats, mxu))
  stats_launches += 1
  stats_tier_launches += tier != 0
  return old, out, cm, stat, v, eta.reshape(())
