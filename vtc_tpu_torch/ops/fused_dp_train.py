"""Whole data-parallel fc training segments: the port of TPU kernel K15,
``fused_dp_train_segment_pallas`` (vtc_tpu/ops/pallas_dp_train.py:310-418,
kernel ``_make_dp_kernel`` :129).

``fused_dp_train_segment`` keeps that function's contract and return value
``(dictionary, hessian, eigvec, last_codes_shard)``; the port's
``parallel.Mesh`` takes the place of the axis name and size.  Per batch of
this rank's (k, b_shard, n) segment: K3's warm power refresh, solve and
unaveraged shard statistics C = codes^T codes, B = codes^T X and
stat = sum_b codes^2, their sum over the ranks, and the replicated update
from the global statistics: the Hessian EMA (cheap quadratic) and
``upd_num_iters`` steps along (C D' - B) / global_b with the rows
renormalized.  The semantics are vtc_tpu's: a scan of [K3 -> psum ->
replicated update] (``parallel.build_dp_fused_local_step``).

* A CUDA tensor runs ``vtc_dp_train_segment`` of
  ``vtc_tpu_torch/csrc/fused_train_step.cu``: the whole segment from one C
  loop on the current stream, K3's kernels and then K2's update kernels
  per step.  Where the TPU kernel all-reduces the packed statistics over
  remote DMA inside the kernel, the C loop calls back into Python once per
  step on a mesh of more than one rank (``ops/sum_hook``, K17's hook), and
  the callback sums them with one ``torch.distributed`` all-reduce; a mesh
  of one rank has no callback and no host work per step.  Or it raises.
* A CPU tensor runs ``fused_dp_train_plain``: K3's plain version,
  ``Mesh.sum`` and ``parallel.data_parallel._replicated_update`` per batch.
  ``chip_smoke.py`` holds the kernel against it on the card.

``fused_dp_segment_supported`` is K3's gate
(``fused_train_step.fused_solve_stats_supported``): vtc_tpu's further terms
(:117-126: the shard as one VMEM tile, and the comm slots of its butterfly
or all-to-all beside it, within a 24 MB budget) size TPU memory and have
no counterpart on the card, where the statistics live in device memory and
the all-reduce is a collective between launches.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test over the
ranks (:206-248): after iteration j > 0 a step's solve ends when the sum
of |codes - old| over every rank's shard, times 1 / (global_b s), over
eta is below eps, on every rank at the same count.  At a world of one the
solve is K2's stop route (the cluster kernel's stop warp at b 250); above
one the classic route, an iteration a launch, its last block leaving the
rank's share in a one-float buffer that ``ops/sum_hook.StopHook`` sums
over the ranks before a one-thread kernel decides
(csrc/fista_core.cuh, "The early stop").  The plain version takes the
same test: each rank's sum, ``Mesh.sum``, then the scale.  ``last_iters``
(a private test hook) is the int32 device tensor (k,) of the last stopped
segment's counts, ``plain_iters`` the plain version's list of them.

``mxu`` is vtc_tpu's training tier (pallas_dp_train.py:129-190): every
step's solve runs it (K1's tier routes, csrc/fista_tier.cuh, and at
'bf16' c as one bf16 pass), the Gram, the refresh, the statistics and the
update stay fp32.  At a tier the stop takes the tier plan's route at a
world of one (the resident layout in one launch at b 250), above one the
classic stop route, an iteration a launch, with the same hook.
``launches`` counts the train steps the kernel ran, ``tier_launches``
those at a tier other than 'highest'.
"""
import ctypes

import torch

from vtc_tpu_torch.ops import fused_fista, fused_train_step, solver
from vtc_tpu_torch.ops.precision import TIER_CODES, resolve_tier
from vtc_tpu_torch.ops.sum_hook import StopHook, SumHook
from vtc_tpu_torch.parallel import data_parallel

launches = 0
tier_launches = 0  # the steps above at a tier other than 'highest'
last_iters = None  # int32 device tensor (k,): the last stopped segment's
plain_iters = None  # the plain version's counts of its last stopped segment


def fused_dp_segment_supported(batch_shard_size, code_size, input_size):
  """True when ``fused_dp_train_segment`` takes this shard geometry: K3's
  gate.  vtc_tpu's ``num_devices`` (its comm-slot count) bounds nothing on
  the card."""
  return fused_train_step.fused_solve_stats_supported(
      batch_shard_size, code_size, input_size)


def fused_dp_train_plain(dictionary, hessian, eigvec, batches,
                         sparsity_weight, inf_num_iters, upd_stepsize, *,
                         mesh, variant="fista",
                         update_alg="sc_cheap_quadratic_descent",
                         upd_num_iters=1, nonneg=False, hard=False,
                         renormalize=True, power_iters=12,
                         lowest_code_val=0.001, precision=None,
                         early_stopping_epsilon=None, mxu="highest"):
  """The plain PyTorch version of the segment, on any device and in the
  inputs' own float type (float64 inputs give the oracle): per batch K3's
  plain version, the sum over ``mesh`` and the replicated update.
  ``precision`` is the matmul precision of the solve (default 'highest');
  ``early_stopping_epsilon`` the kernel's stop test, each iteration's sum
  of |codes - old| summed over ``mesh`` (``Mesh.sum``) and scaled by
  1 / (global_b s); ``mxu`` the solve's tier (K3's plain version's).  The
  row renorm floors the norms at 1e-30, as the kernel does
  (pallas_dp_train.py:301)."""
  global plain_iters
  d, h, v = dictionary, hessian, eigvec
  codes = None
  counts = []
  for batch in batches:
    codes, cmat, bmat, stat, v, _ = fused_train_step.fused_solve_stats_plain(
        d, v, batch, sparsity_weight, inf_num_iters, variant=variant,
        nonneg=nonneg, hard=hard, power_iters=power_iters,
        precision=precision, early_stopping_epsilon=early_stopping_epsilon,
        psum_axes=mesh, stop_count=batch.shape[0] * mesh.size * d.shape[0],
        mxu=mxu)
    counts.append(solver.last_iters)
    cmat, bmat, stat = mesh.sum(cmat, bmat, stat)
    d, h = data_parallel._replicated_update(
        d, h, stat, upd_stepsize, upd_num_iters, batch.shape[0] * mesh.size,
        update_alg == "sc_cheap_quadratic_descent", renormalize,
        lowest_code_val, lambda dd, cmat=cmat, bmat=bmat: cmat @ dd - bmat,
        norm_floor=True)
  if early_stopping_epsilon is not None:
    plain_iters = counts
  return d, h, v, codes


def fused_dp_train_segment(dictionary, hessian, eigvec, batches,
                           sparsity_weight, inf_num_iters, upd_stepsize, *,
                           mesh, variant="fista",
                           update_alg="sc_cheap_quadratic_descent",
                           upd_num_iters=1, nonneg=False, hard=False,
                           renormalize=True, power_iters=12,
                           lowest_code_val=0.001, mxu="highest",
                           early_stopping_epsilon=None):
  """Run ``batches.shape[0]`` data-parallel fc train steps on this rank.

  Every rank of ``mesh`` calls it in step, with the same replicated state
  and its own shard of every batch.

  Args:
    dictionary: (s, n) float32, replicated.
    hessian: (s,) Hessian-diagonal EMA (unchanged by steepest descent),
      replicated.
    eigvec: (min(s, n),) warm Lipschitz eigenvector (normalized here),
      replicated; seed it with ``lipschitz.top_gram_eigenpair``.
    batches: (k, b_shard, n) float32, this rank's shards, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars.
    mesh: the ``parallel.Mesh`` the ranks share.
    variant / update_alg / upd_num_iters / nonneg / hard / renormalize /
      power_iters / lowest_code_val: as in vtc_tpu.
    mxu: the training tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16'.
    early_stopping_epsilon: optional; each step's solve stops after the
      first iteration j > 0 whose mean |codes_j - codes_{j-1}| / eta over
      the global batch is below it, on every rank at the same count.

  Returns:
    (dictionary, hessian, eigvec, last_codes): new tensors, replicated but
    for last_codes, the (b_shard, s) codes of this rank's final shard.  The
    inputs are not modified.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in fused_train_step.UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s"
                     % (fused_train_step.UPDATE_ALGS,))
  mxu = resolve_tier(mxu)

  def require(cond, message):
    if not cond:
      raise ValueError("fused_dp_train_segment: " + message)

  require(batches.dim() == 3 and batches.shape[0] >= 1,
          "batches must be (k, b_shard, n) with k >= 1, got %s"
          % (tuple(batches.shape),))
  k, b, n = batches.shape
  require(dictionary.dim() == 2 and dictionary.shape[1] == n,
          "dictionary must be (s, %d), got %s" % (n,
                                                  tuple(dictionary.shape)))
  s = dictionary.shape[0]
  require(fused_dp_segment_supported(b, s, n),
          "configuration outside the gate (fused_dp_segment_supported())")
  flags = dict(variant=variant, update_alg=update_alg,
               upd_num_iters=int(upd_num_iters), nonneg=bool(nonneg),
               hard=bool(hard), renormalize=bool(renormalize),
               power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val), mxu=mxu)
  if batches.device.type == "cpu":
    return fused_dp_train_plain(
        dictionary, hessian, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize), mesh=mesh,
        early_stopping_epsilon=early_stopping_epsilon, **flags)
  require(batches.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batches.device))
  device = batches.device
  for name, t, shape in (("dictionary", dictionary, (s, n)),
                         ("hessian", hessian, (s,)),
                         ("eigvec", eigvec, (min(s, n),)),
                         ("batches", batches, (k, b, n))):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == shape,
            "%s must be a float32 %s tensor on %s" % (name, shape, device))
  require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
          and int(power_iters) >= 0, "iteration counts must be >= 0")
  return _launch(dictionary.contiguous().clone(),
                 hessian.contiguous().clone(), eigvec.contiguous().clone(),
                 batches.contiguous(), mesh, float(sparsity_weight),
                 int(inf_num_iters), float(upd_stepsize),
                 eps=early_stopping_epsilon, **flags)


def _launch(d, h, v, batches, mesh, lam, num_iters, upd_step, *, variant,
            update_alg, upd_num_iters, nonneg, hard, renormalize,
            power_iters, lowest_code_val, mxu, eps=None):
  """Allocate the scratch and the packed statistics, and enqueue the k
  steps on the current stream, the sum over the ranks between each step's
  statistics and its update; eps the solves' early stop (None: none), mxu
  their tier."""
  global launches, last_iters, tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  s = d.shape[0]
  device = batches.device
  eps, words, iters, local, classic = fused_fista.segment_stop_scratch(
      lib, b, s, 1, eps, device, k, mesh.size, mxu=mxu)

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  gram, corr, codes = empty(s, s), empty(b, s), empty(b, s)
  pgram = empty(n, n) if s > n else None
  grad, eta = empty(s, n), empty(1)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, s, mxu, classic,
                                                device)
  rounded = empty((b + s) * n) if mxu == "bf16" else None
  comm = empty(s * s + s * n + s)  # [C | B | stat], summed by one all-reduce
  hook = SumHook(mesh, comm)
  stop_hook = StopHook(mesh, local) if local is not None else None

  def ptr(t):
    return None if t is None else t.data_ptr()

  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_dp_train_segment(
        d.data_ptr(), h.data_ptr(), v.data_ptr(), batches.data_ptr(), k, b,
        s, n, f32(lam), num_iters, f32(upd_step), upd_num_iters,
        f32(lowest_code_val), int(variant == "fista"),
        fused_fista._MODES[(nonneg, hard)],
        int(update_alg == "sc_cheap_quadratic_descent"), int(renormalize),
        power_iters, f32(b * mesh.size), gram.data_ptr(),
        None if pgram is None else pgram.data_ptr(), corr.data_ptr(),
        codes.data_ptr(), grad.data_ptr(), eta.data_ptr(), sk, sc,
        gn.data_ptr(), ptr(state), comm.data_ptr(), hook.pointer, f32(eps),
        f32(1.0 / (b * mesh.size * s)), ptr(words), ptr(iters), ptr(local),
        None if stop_hook is None else stop_hook.pointer, TIER_CODES[mxu],
        ptr(rounded), stream)
  what = ("data-parallel fc segment launch (k=%d, b=%d, s=%d, n=%d, tier "
          "%s%s)" % (k, b, s, n, mxu, "" if words is None else ", early stop"))
  if stop_hook is not None:
    stop_hook.check(0, what)  # the stop hook's own error first
  hook.check(err, what)
  launches += k
  if mxu != "highest":
    tier_launches += k
  if iters is not None:
    last_iters = iters
  return d, h, v, codes
