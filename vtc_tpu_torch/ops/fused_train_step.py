"""Fused fc train steps over a segment: the port of TPU kernel K2,
``fused_train_segment_pallas`` (vtc_tpu/ops/pallas_train_step.py:1442-1595,
kernels ``_make_kernel`` :396 and ``_make_tiled_kernel`` :728).

``fused_train_segment`` keeps that function's contract and return value
``(dictionary, hessian, eigvec, last_codes)``.  Per batch of the (k, b, n)
segment: the warm power refresh of the Lipschitz eigenvector, the FISTA
or ISTA solve at stepsize 1/eigval, the Hessian-diagonal EMA (cheap
quadratic only) and ``upd_num_iters`` dictionary updates with the rows
renormalized.

* A CUDA tensor runs the hand-written kernels of
  ``vtc_tpu_torch/csrc/fused_train_step.cu`` (built at first use by
  ``ops/_build.py``), whose solve is K1's kernel
  (``csrc/fused_fista.cu``), on the current stream; or raises.
* A CPU tensor runs ``fused_train_segment_plain``, the composition the
  JAX tests use as K2's reference (tests/test_pallas_train_step.py:17-31):
  ``lipschitz.power_iterate`` -> ``fused_fista_plain`` ->
  ``hessian_diagonal_ema`` -> the update rule's ``_update``.
  ``chip_smoke.py`` holds the kernels against it on the card.

``early_stopping_epsilon`` stops every step's solve by vtc_tpu's
batch-global test (pallas_train_step.py:486-512) on the device, on K1's
stop routes (``fused_fista.stop_route``), and the Hessian EMA and the
update take the stopped codes; the segment stays one host call with no
host wait.  ``last_iters`` (a private test hook) is the int32 device
tensor (k,) of the iterations each step's solve ran.

``mxu`` is vtc_tpu's training tier (pallas_train_step.py:398-411): every
step's solve runs it (K1's tier routes, csrc/fista_tier.cuh: the tier
cluster route at b 250, its stop in the same launch), and at 'bf16' c = X D^T is one bf16 pass (both
operands rounded to bf16, then the fp32 product); the Gram, the power
refresh and the update stay fp32 in every tier.

Left out: the TPU knobs ``interpret`` and ``batch_tile`` have no
counterpart on the card (every batch size runs the single-tile
semantics, which the tiled kernel reproduces, and the stop test is
batch-global at every size).  ``launches`` counts the train steps the
kernels ran.

Also here, the port of TPU kernel K3, ``fused_solve_stats_pallas``
(vtc_tpu/ops/pallas_train_step.py:940-1007, kernel
``_make_solve_stats_kernel`` :854): ``fused_solve_stats``, one shard's
step of the data-parallel composition -- the warm refresh and the whole
solve of a K2 step on the shard, then the shard's unaveraged update
statistics C = codes^T codes, B = codes^T X and stat = sum_b codes^2
instead of the update.  A CUDA tensor runs ``vtc_solve_stats`` of the
same source (K2's refresh and solve, the fixed-order statistics) or
raises; a CPU tensor runs ``fused_solve_stats_plain``.  ``mxu`` is K3's
tier (pallas_train_step.py:854-925), K2's rule: the solve at the tier,
at 'bf16' c as one bf16 pass, the refresh and the statistics fp32.
``stats_launches`` counts the steps that kernel ran, ``stats_tier_launches``
those at a tier other than 'highest'.  ``fused_solve_stats_supported`` is
the gate of the scanned trainer.
"""
import ctypes

import torch

from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_cheap_quadratic_descent as cqd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_steepest_descent as sd)
from vtc_tpu_torch.ops import fused_fista, lipschitz
from vtc_tpu_torch.ops.precision import (TIER_CODES, matmul_precision,
                                         resolve_tier)

launches = 0
tier_launches = 0  # the launches above at a tier other than 'highest'
stats_launches = 0
stats_tier_launches = 0  # the stats launches at a tier other than 'highest'
last_iters = None

UPDATE_ALGS = ("sc_steepest_descent", "sc_cheap_quadratic_descent")


def fused_train_segment_plain(dictionary, hessian, eigvec, batches,
                              sparsity_weight, inf_num_iters, upd_stepsize,
                              *, variant="fista",
                              update_alg="sc_cheap_quadratic_descent",
                              upd_num_iters=1, nonneg=False, hard=False,
                              renormalize=True, power_iters=12,
                              lowest_code_val=0.001,
                              early_stopping_epsilon=None, precision=None,
                              return_stepsize=False, mxu="highest"):
  """The plain PyTorch version of the fused segment, on any device and
  in the inputs' own float type (float64 inputs give the oracle).

  ``precision`` is the matmul precision of the solve and the update
  (default 'highest'); 'tensorfloat32' shows what TF32 products would
  cost.  The power refresh always runs at 'highest', as in every tier of
  the TPU kernel.  ``mxu``: the solve's tier, and at 'bf16' c as one bf16
  pass (``fused_fista_plain``'s ``bf16_corr``).  The row renorm divides
  by max(|row|, 1e-30), as the kernel does (pallas_train_step.py:530), so
  a zero row stays zero.
  """
  mxu = resolve_tier(mxu)
  d, h, v = dictionary, hessian, eigvec
  codes = eta = None
  for batch in batches:
    eigval, v = lipschitz.power_iterate(d, v, int(power_iters))
    eta = 1.0 / eigval
    codes = fused_fista.fused_fista_plain(
        batch, d, sparsity_weight, inf_num_iters, eta,
        variant=variant, nonneg=nonneg, hard=hard,
        early_stopping_epsilon=early_stopping_epsilon, precision=precision,
        mxu=mxu, bf16_corr=mxu == "bf16")
    if update_alg == "sc_cheap_quadratic_descent":
      h = cqd.hessian_diagonal_ema(h, codes)
      d = cqd._update(batch, d, codes, h, upd_stepsize, upd_num_iters,
                      lowest_code_val, renormalize, precision=precision,
                      norm_floor=True)
    else:
      d = sd._update(batch, d, codes, upd_stepsize, upd_num_iters,
                     renormalize, precision=precision, norm_floor=True)
  if return_stepsize:
    return d, h, v, codes, eta.reshape(1)
  return d, h, v, codes


def _require(cond, message):
  if not cond:
    raise ValueError("fused_train_segment: " + message)


def fused_train_segment(dictionary, hessian, eigvec, batches,
                        sparsity_weight, inf_num_iters, upd_stepsize, *,
                        variant="fista",
                        update_alg="sc_cheap_quadratic_descent",
                        upd_num_iters=1, nonneg=False, hard=False,
                        renormalize=True, power_iters=12,
                        lowest_code_val=0.001, mxu="highest",
                        early_stopping_epsilon=None, return_stepsize=False):
  """Run ``batches.shape[0]`` fused train steps.

  Args:
    dictionary: (s, n) float32 tensor.
    hessian: (s,) Hessian-diagonal EMA (unchanged by steepest descent).
    eigvec: (min(s, n),) warm Lipschitz eigenvector (normalized here,
      as ``lipschitz.power_iterate`` does).
    batches: (k, b, n) float32, each row a training batch, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars
      (runtime arguments of the kernels: changing them rebuilds nothing).
    variant / update_alg / upd_num_iters / nonneg / hard / renormalize /
      power_iters / lowest_code_val: as in vtc_tpu.
    mxu: the training tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16'.
    early_stopping_epsilon: optional; each step's solve stops by the
      batch-global test (fused_fista_solve's), decided on the device.
    return_stepsize: also return the final step's stepsize 1/eigval, a
      one-element tensor (what the kernels keep on the device).

  Returns:
    (dictionary, hessian, eigvec, last_codes[, stepsize]): new tensors;
    the inputs are not modified.  last_codes is the (b, s) codes of the
    final step.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s" % (UPDATE_ALGS,))
  mxu = resolve_tier(mxu)
  _require(batches.dim() == 3 and batches.shape[0] >= 1,
           "batches must be (k, b, n) with k >= 1, got %s"
           % (tuple(batches.shape),))
  flags = dict(variant=variant, update_alg=update_alg,
               upd_num_iters=int(upd_num_iters), nonneg=bool(nonneg),
               hard=bool(hard), renormalize=bool(renormalize),
               power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val))
  if batches.device.type == "cpu":
    return fused_train_segment_plain(
        dictionary, hessian, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize),
        early_stopping_epsilon=early_stopping_epsilon,
        return_stepsize=return_stepsize, mxu=mxu, **flags)
  _require(batches.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(batches.device))
  device = batches.device
  k, b, n = batches.shape
  _require(dictionary.dim() == 2 and dictionary.shape[1] == n,
           "dictionary must be (s, %d), got %s" % (n, tuple(dictionary.shape)))
  s = dictionary.shape[0]
  dim = min(s, n)
  for name, t, shape in (("dictionary", dictionary, (s, n)),
                         ("hessian", hessian, (s,)),
                         ("eigvec", eigvec, (dim,)),
                         ("batches", batches, (k, b, n))):
    _require(t.device == device and t.dtype == torch.float32
             and tuple(t.shape) == shape,
             "%s must be a float32 %s tensor on %s" % (name, shape, device))
  _require(b > 0 and s > 0 and n > 0, "empty batch or dictionary")
  _require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
           and int(power_iters) >= 0, "iteration counts must be >= 0")
  out = _launch(dictionary, hessian, eigvec, batches.contiguous(),
                float(sparsity_weight), int(inf_num_iters),
                float(upd_stepsize), eps=early_stopping_epsilon, mxu=mxu,
                **flags)
  return out if return_stepsize else out[:4]


def _launch(dictionary, hessian, eigvec, batches, lam, num_iters, upd_step,
            *, variant, update_alg, upd_num_iters, nonneg, hard,
            renormalize, power_iters, lowest_code_val, eps=None,
            mxu="highest"):
  """Allocate state and scratch, enqueue the k steps on the current
  stream; eps the solves' early stop (None: none), mxu their tier."""
  global launches, last_iters, tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  s = dictionary.shape[0]
  device = batches.device
  eps, words, iters, classic = fused_fista.stop_scratch(
      lib, b, s, 1, "auto", eps, device, steps=k, mxu=mxu)
  _require(lib.vtc_power_smem_bytes(min(s, n)) <= fused_fista._SMEM_PER_BLOCK,
           "min(s, n) = %d is too large for the one-block power refresh"
           % min(s, n))

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  d = dictionary.contiguous().clone()
  h = hessian.contiguous().clone()
  v = eigvec.contiguous().clone()
  gram, corr, codes = empty(s, s), empty(b, s), empty(b, s)
  pgram = empty(n, n) if s > n else None
  resid, grad, eta = empty(b, n), empty(s, n), empty(1)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, s, mxu, classic,
                                                device)
  rounded = empty((b + s) * n) if mxu == "bf16" else None

  def ptr(t):
    return None if t is None else t.data_ptr()

  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_train_segment(
        d.data_ptr(), h.data_ptr(), v.data_ptr(), batches.data_ptr(), k, b,
        s, n, f32(lam), num_iters, f32(upd_step), upd_num_iters,
        f32(lowest_code_val), int(variant == "fista"),
        fused_fista._MODES[(nonneg, hard)],
        int(update_alg == "sc_cheap_quadratic_descent"), int(renormalize),
        power_iters, f32(1.0 / b), gram.data_ptr(), ptr(pgram),
        corr.data_ptr(), codes.data_ptr(), resid.data_ptr(),
        grad.data_ptr(), eta.data_ptr(), sk, sc, gn.data_ptr(),
        ptr(state), f32(eps), f32(1.0 / (b * s)), ptr(words), ptr(iters),
        TIER_CODES[mxu], ptr(rounded), stream)
  if err != 0:
    raise RuntimeError(
        "fused train step launch failed with CUDA error %d (k=%d, b=%d, "
        "s=%d, n=%d, tier %s%s)" % (err, k, b, s, n, mxu,
                                    "" if words is None else ", early stop"))
  launches += k
  if mxu != "highest":
    tier_launches += k
  if iters is not None:
    last_iters = iters
  return d, h, v, codes, eta


def fused_solve_stats_supported(batch_shard_size, code_size, input_size):
  """True when ``fused_solve_stats`` takes this shard geometry.  vtc_tpu's
  gate (pallas_train_step.py:927-933) is a VMEM budget, which has no
  counterpart: the kernels keep their state in device memory, and only
  the one-block power refresh bounds the shapes, to min(s, n) <= 29,039
  (two vectors of that length in a block's 227 KB of shared memory)."""
  dim = min(int(code_size), int(input_size))
  return (int(batch_shard_size) >= 1 and dim >= 1
          and (2 * dim + 33) * 4 <= fused_fista._SMEM_PER_BLOCK)


def fused_solve_stats_plain(dictionary, eigvec, batch, sparsity_weight,
                            inf_num_iters, *, variant="fista", nonneg=False,
                            hard=False, power_iters=12, precision=None,
                            early_stopping_epsilon=None, psum_axes=None,
                            stop_count=None, mxu="highest"):
  """The plain PyTorch version of ``fused_solve_stats``, on any device and
  in the inputs' own float type: ``lipschitz.power_iterate`` ->
  ``fused_fista_plain`` -> the three statistics.  ``precision`` is the
  matmul precision of the solve ('tensorfloat32' shows what TF32 products
  would cost); the refresh and the statistics stay at 'highest', as in
  every tier of the TPU kernel (pallas_train_step.py:862-865).  The solve's
  early stop over ``psum_axes`` and ``stop_count`` is K15's (the
  data-parallel segment's plain version passes them).  ``mxu``: the
  solve's tier, and at 'bf16' c as one bf16 pass."""
  mxu = resolve_tier(mxu)
  eigval, v = lipschitz.power_iterate(dictionary, eigvec, int(power_iters))
  eta = 1.0 / eigval
  codes = fused_fista.fused_fista_plain(
      batch, dictionary, sparsity_weight, inf_num_iters, eta,
      variant=variant, nonneg=nonneg, hard=hard, precision=precision,
      early_stopping_epsilon=early_stopping_epsilon, psum_axes=psum_axes,
      stop_count=stop_count, mxu=mxu, bf16_corr=mxu == "bf16")
  with matmul_precision():
    cmat = codes.T @ codes
    bmat = codes.T @ batch
  return codes, cmat, bmat, torch.sum(codes * codes, dim=0), v, eta


def fused_solve_stats(dictionary, eigvec, batch, sparsity_weight,
                      inf_num_iters, *, variant="fista", nonneg=False,
                      hard=False, power_iters=12, mxu="highest"):
  """One shard's solve+stats step.

  Args:
    dictionary: (s, n) float32 tensor, the replicated dictionary.
    eigvec: (min(s, n),) warm Lipschitz eigenvector (normalized here).
    batch: (b, n) float32, this shard of the batch.
    sparsity_weight, inf_num_iters: Python scalars.
    variant / nonneg / hard / power_iters: as in vtc_tpu.
    mxu: the solve's tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16'.

  Returns:
    (codes (b, s), cmat (s, s), bmat (s, n), stat (s,), new_eigvec, eta):
    new tensors; eta is 0-d.  The full-batch dictionary gradient at any D'
    is (sum over shards of cmat @ D' - sum of bmat) / global_b.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  flags = dict(variant=variant, nonneg=bool(nonneg), hard=bool(hard),
               power_iters=int(power_iters), mxu=resolve_tier(mxu))
  if batch.device.type == "cpu":
    return fused_solve_stats_plain(dictionary, eigvec, batch,
                                   float(sparsity_weight), int(inf_num_iters),
                                   **flags)

  def require(cond, message):
    if not cond:
      raise ValueError("fused_solve_stats: " + message)

  require(batch.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batch.device))
  require(batch.dim() == 2 and dictionary.dim() == 2
          and dictionary.shape[1] == batch.shape[1],
          "shapes must be (s, n) and (b, n), got %s and %s"
          % (tuple(dictionary.shape), tuple(batch.shape)))
  device = batch.device
  (b, n), s = batch.shape, dictionary.shape[0]
  for name, t, shape in (("dictionary", dictionary, (s, n)),
                         ("eigvec", eigvec, (min(s, n),)),
                         ("batch", batch, (b, n))):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == shape,
            "%s must be a float32 %s tensor on %s" % (name, shape, device))
  require(int(inf_num_iters) >= 0 and int(power_iters) >= 0,
          "iteration counts must be >= 0")
  require(fused_solve_stats_supported(b, s, n),
          "min(s, n) = %d is too large for the one-block power refresh, or "
          "the batch is empty" % min(s, n))
  return _launch_stats(dictionary.contiguous(), eigvec, batch.contiguous(),
                       float(sparsity_weight), int(inf_num_iters), **flags)


def _launch_stats(dictionary, eigvec, batch, lam, num_iters, *, variant,
                  nonneg, hard, power_iters, mxu):
  """Allocate the outputs and scratch, enqueue the step on the current
  stream."""
  global stats_launches, stats_tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  (b, n), s = batch.shape, dictionary.shape[0]
  device = batch.device

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  v = eigvec.contiguous().clone()
  gram, corr, codes = empty(s, s), empty(b, s), empty(b, s)
  pgram = empty(n, n) if s > n else None
  cmat, bmat, stat, eta = empty(s, s), empty(s, n), empty(s), empty(1)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, s, mxu, False,
                                                device)
  rounded = empty((b + s) * n) if mxu == "bf16" else None
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_solve_stats(
        dictionary.data_ptr(), v.data_ptr(), batch.data_ptr(), b, s, n,
        ctypes.c_float(lam), num_iters, int(variant == "fista"),
        fused_fista._MODES[(nonneg, hard)], power_iters, gram.data_ptr(),
        None if pgram is None else pgram.data_ptr(), corr.data_ptr(),
        codes.data_ptr(), cmat.data_ptr(), bmat.data_ptr(), stat.data_ptr(),
        eta.data_ptr(), sk, sc, gn.data_ptr(),
        None if state is None else state.data_ptr(), TIER_CODES[mxu],
        None if rounded is None else rounded.data_ptr(), stream)
  if err != 0:
    raise RuntimeError(
        "fused solve+stats launch failed with CUDA error %d (b=%d, s=%d, "
        "n=%d, tier %s)" % (err, b, s, n, mxu))
  stats_launches += 1
  if mxu != "highest":
    stats_tier_launches += 1
  return codes, cmat, bmat, stat, v, eta.reshape(())
