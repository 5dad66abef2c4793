"""Fused subspace (group-sparse) train steps over a segment: the port of
TPU kernel K6, ``fused_group_train_segment_pallas``
(vtc_tpu/ops/pallas_train_step.py:1283-1433, kernel ``_make_group_kernel``
:539), with the group prox K5 inside.

``fused_group_train_segment`` keeps that function's contract and return
value ``(dictionary, hessian, eigvec, last_codes)``; the eigenvector has
min(G*M, n) entries, the grouped Gram's.  Per batch of the (k, b, n)
segment: the grouped dictionary, the warm power refresh on its Gram, the
group FISTA or ISTA solve at stepsize 1/eigval, the duplicate-summed
codes, the Hessian-diagonal EMA (cheap quadratic only) and
``upd_num_iters`` dictionary updates, with the within-group
anti-alignment regularizer when ``alignment_penalty`` is not 0.

* A CUDA tensor runs the hand-written kernels of
  ``vtc_tpu_torch/csrc/fused_group_train_step.cu`` (built at first use by
  ``ops/_build.py``), whose solve is K4's kernel, on the current stream;
  or raises.
* A CPU tensor runs ``fused_group_train_segment_plain``, the composition
  the JAX tests hold K6 against (tests/test_pallas_train_step.py:164-184):
  ``build_grouped_dictionary`` -> ``lipschitz.power_iterate`` -> the
  'gram' group solve -> ``unpack_codes_summed`` ->
  ``hessian_diagonal_ema`` -> the update rule.  ``chip_smoke.py`` holds
  the kernels against it on the card.

The group structure reaches the kernels as index lists built here on
the host (``group_selection_index`` and ``unpack_index``), the
counterparts of the TPU kernel's ``group_selection_matrix`` and its
summed unpack; its ``group_expand_matrix`` has none, because K4's prox
takes the window M.  ``fused_group_segment_supported`` is the gate of
the scanned trainer.

``early_stopping_epsilon`` stops every step's group solve by vtc_tpu's
batch-global test over the b*G*M packed entries
(pallas_train_step.py:665-690) on the device, on K1's stop routes, and
the Hessian EMA and the update take the stopped codes; ``last_iters`` (a
private test hook) is the int32 device tensor (k,) of each step's count.

``mxu`` is vtc_tpu's training tier (pallas_train_step.py:541-588): every
step's group solve runs it (K4's tier routes, csrc/fista_tier.cuh), and at
'bf16' c = X Dg^T is one bf16 pass and, where the groups are not the
identity layout, the summed unpack adds bf16-rounded slots (:691); the
grouped build, its Gram, the refresh, the update and the regularizer stay
fp32 in every tier.

Left out: the TPU knob ``interpret``.  ``launches`` counts the train steps
the kernels ran.

Also here, the port of TPU kernel K7, ``fused_group_solve_stats_pallas``
(vtc_tpu/ops/pallas_train_step.py:1112-1209, kernel
``_make_group_solve_stats_kernel`` :1010): ``fused_group_solve_stats``,
one shard's step of the subspace data-parallel composition -- a K6 step's
grouped refresh, group solve and duplicate-summed codes on the shard,
then the shard's unaveraged statistics C = codes^T codes, B = codes^T X
and stat = sum_b codes^2 over the summed (b, s) codes instead of the
update.  A CUDA tensor runs ``vtc_group_solve_stats`` of the same source
or raises; a CPU tensor runs ``fused_group_solve_stats_plain``.  ``mxu``
is K7's tier (pallas_train_step.py:1010-1080), K6's rule but for the
unpack: at 'bf16' K7 rounds every code slot to bf16 before C, B and
stat, the identity layout's too, since its unpack is a bf16 product with
no identity shortcut (:1074), where K6 and K16 keep that layout's codes
unrounded.  ``stats_launches`` counts the steps that kernel ran,
``stats_tier_launches`` those at a tier other than 'highest';
``fused_group_solve_stats_supported`` is the gate of the scanned trainer.
"""
import ctypes
import functools

import numpy as np
import torch

from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista as sub)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_cheap_quadratic_descent as cqd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_steepest_descent as sd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    subspace_sc_cheap_quadratic_descent as sub_cqd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    subspace_sc_steepest_descent as sub_sd)
from vtc_tpu_torch.ops import fused_fista, fused_group_fista, lipschitz
from vtc_tpu_torch.ops.precision import (TIER_CODES, matmul_precision,
                                         resolve_tier)

launches = 0
tier_launches = 0  # the launches above at a tier other than 'highest'
stats_launches = 0
stats_tier_launches = 0  # the stats launches at a tier other than 'highest'

INFERENCE_ALGS = ("subspace_ista", "subspace_fista")
UPDATE_ALGS = ("subspace_sc_steepest_descent",
               "subspace_sc_cheap_quadratic_descent")


def _power_smem_bytes(dim):
  """Shared memory of the one-block power refresh (train_core.cuh)."""
  return (2 * dim + 33) * 4


def fused_group_segment_supported(inference_alg, update_alg,
                                  group_assignments, *,
                                  alignment_penalty=0.0, batch_size=None,
                                  code_size=None, input_size=None,
                                  renormalize=True):
  """True when ``fused_group_train_segment`` covers this configuration
  (vtc_tpu pallas_train_step.py:1229-1254).  The TPU gate's VMEM budget
  has no counterpart: the kernels keep their state in device memory and
  only the one-block power refresh bounds the shapes."""
  if group_assignments is None:
    return False
  if inference_alg not in INFERENCE_ALGS or update_alg not in UPDATE_ALGS:
    return False
  if alignment_penalty != 0.0 and not renormalize:
    # the in-kernel regularizer uses the unit-norm gradient form
    return False
  if None in (batch_size, code_size, input_size):
    return True
  gm = len(group_assignments) * max(len(g) for g in group_assignments)
  return (_power_smem_bytes(min(gm, input_size))
          <= fused_fista._SMEM_PER_BLOCK)


def group_selection_index(group_assignments):
  """(G*M,) int32: slot g*M+m holds member m of group g, or -1 where the
  group is padded -- the rows of vtc_tpu's ``group_selection_matrix``
  (pallas_train_step.py:1257-1268) as indices."""
  max_gs = max(len(g) for g in group_assignments)
  sel = np.full((len(group_assignments), max_gs), -1, np.int32)
  for g_idx, members in enumerate(group_assignments):
    sel[g_idx, :len(members)] = list(members)
  return sel.reshape(-1)


def _is_identity(group_assignments, code_size):
  """Whether the groups tile range(code_size) in order: vtc_tpu's
  ``gsel_identity``, where K6 and K16 skip the unpack."""
  sel = group_selection_index(group_assignments)
  return sel.size == code_size and np.array_equal(sel, np.arange(code_size))


def comembership_counts(group_assignments, code_size):
  """(s, s) zero-diagonal co-membership counts: pairs that share several
  groups count once per group (pallas_train_step.py:1360-1367)."""
  comem = np.zeros((code_size, code_size), np.float32)
  for g in group_assignments:
    for i in g:
      for j in g:
        if i != j:
          comem[i, j] += 1.0
  return comem


def fused_group_train_segment_plain(
    dictionary, hessian, eigvec, batches, sparsity_weight, inf_num_iters,
    upd_stepsize, *, group_assignments, variant="fista",
    update_alg="subspace_sc_cheap_quadratic_descent", upd_num_iters=1,
    hard=False, renormalize=True, power_iters=12, lowest_code_val=0.001,
    alignment_penalty=0.0, early_stopping_epsilon=None, precision=None,
    return_stepsize=False, mxu="highest"):
  """The plain PyTorch version of the fused segment, on any device and in
  the inputs' own float type (float64 inputs give the oracle).

  ``precision`` is the matmul precision of the solve and the update
  (default 'highest'); 'tensorfloat32' shows what TF32 products would
  cost.  The power refresh always runs at 'highest', as in every tier of
  the TPU kernel.  ``mxu``: the group solve's tier; at 'bf16' c is one
  bf16 pass and the unpack adds bf16-rounded slots unless the groups are
  the identity layout.  The row renorm divides by max(|row|, 1e-30), as
  the kernel does (pallas_train_step.py:719, :845).
  """
  mxu = resolve_tier(mxu)
  d, h, v = dictionary, hessian, eigvec
  s = d.shape[0]
  gather, mask, index = sub.group_layout(group_assignments, s, d.device)
  m = gather.shape[1]
  round_unpack = mxu == "bf16" and not _is_identity(group_assignments, s)
  codes = eta = None
  for batch in batches:
    grouped = sub.build_grouped_dictionary(d, gather, mask)
    eigval, v = lipschitz.power_iterate(grouped, v, int(power_iters))
    eta = 1.0 / eigval
    flat = fused_group_fista.fused_group_fista_plain(
        batch, grouped, m, sparsity_weight, inf_num_iters, eta,
        variant=variant, hard=hard,
        early_stopping_epsilon=early_stopping_epsilon, precision=precision,
        mxu=mxu, bf16_corr=mxu == "bf16")
    if round_unpack:
      flat = flat.to(torch.bfloat16).to(flat.dtype)
    codes = sub.unpack_codes_summed(flat, gather, mask, s, index)
    cheap = update_alg == "subspace_sc_cheap_quadratic_descent"
    if cheap:
      h = cqd.hessian_diagonal_ema(h, codes)
    if alignment_penalty == 0:
      d = (cqd._update(batch, d, codes, h, upd_stepsize, upd_num_iters,
                       lowest_code_val, renormalize, precision=precision,
                       norm_floor=True)
           if cheap else
           sd._update(batch, d, codes, upd_stepsize, upd_num_iters,
                      renormalize, precision=precision, norm_floor=True))
    elif cheap:
      d = sub_cqd._update_with_reg(
          batch, d, codes, gather, mask, h, alignment_penalty, upd_stepsize,
          upd_num_iters, lowest_code_val, renormalize, precision=precision,
          norm_floor=True)
    else:
      d = sub_sd._update_with_reg(
          batch, d, codes, gather, mask, alignment_penalty, upd_stepsize,
          upd_num_iters, renormalize, precision=precision, norm_floor=True)
  if return_stepsize:
    return d, h, v, codes, eta.reshape(1)
  return d, h, v, codes


def _require(cond, message):
  if not cond:
    raise ValueError("fused_group_train_segment: " + message)


def fused_group_train_segment(
    dictionary, hessian, eigvec, batches, sparsity_weight, inf_num_iters,
    upd_stepsize, *, group_assignments, variant="fista",
    update_alg="subspace_sc_cheap_quadratic_descent", upd_num_iters=1,
    hard=False, renormalize=True, power_iters=12, lowest_code_val=0.001,
    alignment_penalty=0.0, mxu="highest", early_stopping_epsilon=None,
    return_stepsize=False):
  """Run ``batches.shape[0]`` fused subspace train steps.

  Args:
    dictionary: (s, n) float32 tensor.
    hessian: (s,) Hessian-diagonal EMA (unchanged by steepest descent).
    eigvec: (min(G*M, n),) warm Lipschitz eigenvector of the grouped
      Gram (normalized here, as ``lipschitz.power_iterate`` does).
    batches: (k, b, n) float32, each row a training batch, k >= 1.
    sparsity_weight, inf_num_iters, upd_stepsize: Python scalars.
    group_assignments: list of index lists (ragged, may overlap).
    variant / update_alg / upd_num_iters / hard / renormalize /
      power_iters / lowest_code_val / alignment_penalty: as in vtc_tpu;
      a nonzero penalty needs renormalize (the unit-norm form).
    mxu: the training tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16'.
    early_stopping_epsilon: optional; each step's group solve stops by the
      batch-global test over the b*G*M packed entries, on the device.
    return_stepsize: also return the final step's stepsize 1/eigval, a
      one-element tensor.

  Returns:
    (dictionary, hessian, eigvec, last_codes[, stepsize]): new tensors;
    the inputs are not modified.  last_codes is the (b, s) summed codes
    of the final step.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  if update_alg not in UPDATE_ALGS:
    raise ValueError("update_alg must be one of %s" % (UPDATE_ALGS,))
  mxu = resolve_tier(mxu)
  _require(float(alignment_penalty) == 0.0 or renormalize,
           "the anti-alignment regularizer uses the unit-norm gradient "
           "form: alignment_penalty needs renormalize=True")
  _require(batches.dim() == 3 and batches.shape[0] >= 1,
           "batches must be (k, b, n) with k >= 1, got %s"
           % (tuple(batches.shape),))
  groups = [[int(i) for i in g] for g in group_assignments]
  flags = dict(variant=variant, update_alg=update_alg,
               upd_num_iters=int(upd_num_iters), hard=bool(hard),
               renormalize=bool(renormalize), power_iters=int(power_iters),
               lowest_code_val=float(lowest_code_val),
               alignment_penalty=float(alignment_penalty))
  if batches.device.type == "cpu":
    return fused_group_train_segment_plain(
        dictionary, hessian, eigvec, batches, float(sparsity_weight),
        int(inf_num_iters), float(upd_stepsize), group_assignments=groups,
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
  gm = len(groups) * max(len(g) for g in groups)
  dim = min(gm, n)
  for name, t, shape in (("dictionary", dictionary, (s, n)),
                         ("hessian", hessian, (s,)),
                         ("eigvec", eigvec, (dim,)),
                         ("batches", batches, (k, b, n))):
    _require(t.device == device and t.dtype == torch.float32
             and tuple(t.shape) == shape,
             "%s must be a float32 %s tensor on %s" % (name, shape, device))
  _require(b > 0 and s > 0 and n > 0, "empty batch or dictionary")
  _require(all(0 <= i < s for g in groups for i in g),
           "group members must index the %d dictionary rows" % s)
  _require(int(inf_num_iters) >= 0 and int(upd_num_iters) >= 0
           and int(power_iters) >= 0, "iteration counts must be >= 0")
  _require(_power_smem_bytes(dim) <= fused_fista._SMEM_PER_BLOCK,
           "min(G*M, n) = %d is too large for the one-block power refresh"
           % dim)
  out = _launch(dictionary, hessian, eigvec, batches.contiguous(), groups,
                float(sparsity_weight), int(inf_num_iters),
                float(upd_stepsize), eps=early_stopping_epsilon, mxu=mxu,
                **flags)
  return out if return_stepsize else out[:4]


def _launch(dictionary, hessian, eigvec, batches, groups, lam, num_iters,
            upd_step, *, variant, update_alg, upd_num_iters, hard,
            renormalize, power_iters, lowest_code_val, alignment_penalty,
            eps=None, mxu="highest"):
  """Allocate state and scratch, copy the group index lists to the
  device, and enqueue the k steps on the current stream; eps the group
  solves' early stop (None: none), mxu their tier."""
  global launches, last_iters, tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  k, b, n = batches.shape
  s = dictionary.shape[0]
  device = batches.device
  m = max(len(g) for g in groups)
  sel_np = group_selection_index(groups)
  gm = sel_np.size
  identity = _is_identity(groups, s)
  eps, words, iters, classic = fused_fista.stop_scratch(
      lib, b, gm, m, "auto", eps, device, steps=k, mxu=mxu)
  use_reg = alignment_penalty != 0.0

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  def on_device(array):
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)

  d = dictionary.contiguous().clone()
  h = hessian.contiguous().clone()
  v = eigvec.contiguous().clone()
  sel = sum_idx = dg = codes = None
  sum_width = 0
  if not identity:
    gather, mask = sub.pack_group_indices(groups, s)
    index = sub.unpack_index(gather, mask, s).numpy().astype(np.int32)
    sel, sum_idx, sum_width = on_device(sel_np), on_device(index), \
        index.shape[1]
    dg, codes = empty(gm, n), empty(b, s)
  comem = cmat = smat = sdm = None
  if use_reg:
    comem = on_device(comembership_counts(groups, s))
    cmat, smat, sdm = empty(s, s), empty(s, s), empty(s, n)
  gram, corr, gcodes = empty(gm, gm), empty(b, gm), empty(b, gm)
  pgram = empty(n, n) if gm > n else None
  resid, grad, eta = empty(b, n), empty(s, n), empty(1)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, gm, mxu, classic,
                                                device)
  rounded = empty((b + gm) * n) if mxu == "bf16" else None

  def ptr(t):
    return None if t is None else t.data_ptr()

  f32 = ctypes.c_float
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_group_train_segment(
        d.data_ptr(), h.data_ptr(), v.data_ptr(), batches.data_ptr(), k, b,
        s, n, gm, m, ptr(sel), ptr(sum_idx), sum_width, ptr(comem),
        f32(alignment_penalty), f32(lam), num_iters, f32(upd_step),
        upd_num_iters, f32(lowest_code_val), int(variant == "fista"),
        int(hard), int(update_alg == "subspace_sc_cheap_quadratic_descent"),
        int(renormalize), power_iters, f32(1.0 / b), ptr(dg),
        gram.data_ptr(), ptr(pgram), corr.data_ptr(), gcodes.data_ptr(),
        ptr(codes), resid.data_ptr(), grad.data_ptr(), ptr(cmat), ptr(smat),
        ptr(sdm), eta.data_ptr(), sk, sc, gn.data_ptr(), ptr(state),
        f32(eps), f32(1.0 / (b * gm)), ptr(words), ptr(iters),
        TIER_CODES[mxu], ptr(rounded), stream)
  if err != 0:
    raise RuntimeError(
        "fused group train step launch failed with CUDA error %d (k=%d, "
        "b=%d, s=%d, n=%d, G*M=%d, tier %s%s)" % (
            err, k, b, s, n, gm, mxu, "" if words is None else ", early stop"))
  launches += k
  if mxu != "highest":
    tier_launches += k
  if iters is not None:
    last_iters = iters
  return d, h, v, gcodes if identity else codes, eta


def fused_group_solve_stats_supported(batch_shard_size, code_size,
                                      input_size, group_assignments):
  """True when ``fused_group_solve_stats`` takes this shard geometry.
  vtc_tpu's gate (pallas_train_step.py:1099-1109) is a VMEM budget, which
  has no counterpart; as for ``fused_group_segment_supported`` only the
  one-block power refresh bounds the shapes, to min(G*M, n) <= 29,039."""
  gm = len(group_assignments) * max(len(g) for g in group_assignments)
  dim = min(gm, int(input_size))
  return (int(batch_shard_size) >= 1 and int(code_size) >= 1 and dim >= 1
          and _power_smem_bytes(dim) <= fused_fista._SMEM_PER_BLOCK)


def fused_group_solve_stats_plain(dictionary, eigvec, batch, sparsity_weight,
                                  inf_num_iters, *, group_assignments,
                                  variant="fista", hard=False,
                                  power_iters=12, precision=None,
                                  early_stopping_epsilon=None,
                                  psum_axes=None, stop_count=None,
                                  mxu="highest", round_identity=True):
  """The plain PyTorch version of ``fused_group_solve_stats``, on any
  device and in the inputs' own float type: ``build_grouped_dictionary``
  -> ``lipschitz.power_iterate`` -> the 'gram' group solve ->
  ``unpack_codes_summed`` -> the three statistics.  ``precision`` is the
  matmul precision of the solve; the refresh and the statistics stay at
  'highest' (pallas_train_step.py:1021-1024).  The group solve's early
  stop over ``psum_axes`` and ``stop_count`` is K16's.  ``mxu``: the group
  solve's tier; at 'bf16' c is one bf16 pass and the unpack adds
  bf16-rounded slots, on the identity layout too unless
  ``round_identity`` is False (K16's shortcut, which its plain version
  takes)."""
  mxu = resolve_tier(mxu)
  s = dictionary.shape[0]
  gather, mask, index = sub.group_layout(group_assignments, s,
                                         dictionary.device)
  grouped = sub.build_grouped_dictionary(dictionary, gather, mask)
  eigval, v = lipschitz.power_iterate(grouped, eigvec, int(power_iters))
  eta = 1.0 / eigval
  flat = fused_group_fista.fused_group_fista_plain(
      batch, grouped, gather.shape[1], sparsity_weight, inf_num_iters, eta,
      variant=variant, hard=hard, precision=precision,
      early_stopping_epsilon=early_stopping_epsilon, psum_axes=psum_axes,
      stop_count=stop_count, mxu=mxu, bf16_corr=mxu == "bf16")
  if mxu == "bf16" and (round_identity
                        or not _is_identity(group_assignments, s)):
    flat = flat.to(torch.bfloat16).to(flat.dtype)
  codes = sub.unpack_codes_summed(flat, gather, mask, s, index)
  with matmul_precision():
    cmat = codes.T @ codes
    bmat = codes.T @ batch
  return codes, cmat, bmat, torch.sum(codes * codes, dim=0), v, eta


@functools.lru_cache(maxsize=16)
def _device_group_index(groups, code_size, device):
  """(sel, sum_idx) int32 tensors on ``device`` for a group structure, or
  (None, None) when the groups tile range(code_size) in order; built and
  copied once per structure, so a step copies nothing to the device."""
  if _is_identity(groups, code_size):
    return None, None
  sel_np = group_selection_index(groups)
  gather, mask = sub.pack_group_indices(groups, code_size)
  index = sub.unpack_index(gather, mask, code_size).numpy().astype(np.int32)
  return (torch.from_numpy(sel_np).to(device),
          torch.from_numpy(np.ascontiguousarray(index)).to(device))


def fused_group_solve_stats(dictionary, eigvec, batch, sparsity_weight,
                            inf_num_iters, *, group_assignments,
                            variant="fista", hard=False, power_iters=12,
                            mxu="highest"):
  """One shard's subspace solve+stats step.

  Args:
    dictionary: (s, n) float32 tensor, the replicated dictionary.
    eigvec: (min(G*M, n),) warm eigenvector of the grouped Gram.
    batch: (b, n) float32, this shard of the batch.
    sparsity_weight, inf_num_iters: Python scalars.
    group_assignments: list of index lists (ragged, may overlap).
    variant / hard / power_iters: as in vtc_tpu.
    mxu: the group solve's tier, 'highest', 'bf16x5', 'bf16x3' or 'bf16'
      (at 'bf16' every code slot is rounded, the identity layout's too).

  Returns:
    (codes (b, s) summed, cmat (s, s), bmat (s, n), stat (s,), new_eigvec,
    eta): new tensors; eta is 0-d.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  groups = tuple(tuple(int(i) for i in g) for g in group_assignments)
  flags = dict(variant=variant, hard=bool(hard), power_iters=int(power_iters),
               mxu=resolve_tier(mxu))
  if batch.device.type == "cpu":
    return fused_group_solve_stats_plain(
        dictionary, eigvec, batch, float(sparsity_weight), int(inf_num_iters),
        group_assignments=groups, **flags)

  def require(cond, message):
    if not cond:
      raise ValueError("fused_group_solve_stats: " + message)

  require(batch.device.type == "cuda",
          "tensors must be on the CPU or a CUDA device, got "
          + str(batch.device))
  require(batch.dim() == 2 and dictionary.dim() == 2
          and dictionary.shape[1] == batch.shape[1],
          "shapes must be (s, n) and (b, n), got %s and %s"
          % (tuple(dictionary.shape), tuple(batch.shape)))
  device = batch.device
  (b, n), s = batch.shape, dictionary.shape[0]
  gm = len(groups) * max(len(g) for g in groups)
  for name, t, shape in (("dictionary", dictionary, (s, n)),
                         ("eigvec", eigvec, (min(gm, n),)),
                         ("batch", batch, (b, n))):
    require(t.device == device and t.dtype == torch.float32
            and tuple(t.shape) == shape,
            "%s must be a float32 %s tensor on %s" % (name, shape, device))
  require(all(0 <= i < s for g in groups for i in g),
          "group members must index the %d dictionary rows" % s)
  require(int(inf_num_iters) >= 0 and int(power_iters) >= 0,
          "iteration counts must be >= 0")
  require(fused_group_solve_stats_supported(b, s, n, groups),
          "min(G*M, n) = %d is too large for the one-block power refresh, "
          "or the batch is empty" % min(gm, n))
  return _launch_stats(dictionary.contiguous(), eigvec, batch.contiguous(),
                       groups, float(sparsity_weight), int(inf_num_iters),
                       **flags)


def _launch_stats(dictionary, eigvec, batch, groups, lam, num_iters, *,
                  variant, hard, power_iters, mxu):
  """Allocate the outputs and scratch, enqueue the step on the current
  stream."""
  global stats_launches, stats_tier_launches
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  (b, n), s = batch.shape, dictionary.shape[0]
  device = batch.device
  m = max(len(g) for g in groups)
  gm = len(groups) * m
  sel, sum_idx = _device_group_index(groups, s, device)

  def empty(*shape):
    return torch.empty(shape, dtype=torch.float32, device=device)

  def ptr(t):
    return None if t is None else t.data_ptr()

  v = eigvec.contiguous().clone()
  dg = codes = None
  if sel is not None:
    dg = empty(gm, n)
  if sel is not None or mxu == "bf16":  # K7 rounds the identity's codes
    codes = empty(b, s)
  gram, corr, gcodes = empty(gm, gm), empty(b, gm), empty(b, gm)
  pgram = empty(n, n) if gm > n else None
  cmat, bmat, stat, eta = empty(s, s), empty(s, n), empty(s), empty(1)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, gm, mxu, False,
                                                device)
  rounded = empty((b + gm) * n) if mxu == "bf16" else None
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_group_solve_stats(
        dictionary.data_ptr(), v.data_ptr(), batch.data_ptr(), b, s, n, gm,
        m, ptr(sel), ptr(sum_idx),
        0 if sum_idx is None else sum_idx.shape[1], ctypes.c_float(lam),
        num_iters, int(variant == "fista"), int(hard), power_iters, ptr(dg),
        gram.data_ptr(), ptr(pgram), corr.data_ptr(), gcodes.data_ptr(),
        ptr(codes), cmat.data_ptr(), bmat.data_ptr(), stat.data_ptr(),
        eta.data_ptr(), sk, sc, gn.data_ptr(), ptr(state), TIER_CODES[mxu],
        ptr(rounded), stream)
  if err != 0:
    raise RuntimeError(
        "fused group solve+stats launch failed with CUDA error %d (b=%d, "
        "s=%d, n=%d, G*M=%d, tier %s)" % (err, b, s, n, gm, mxu))
  stats_launches += 1
  if mxu != "highest":
    stats_tier_launches += 1
  return (gcodes if codes is None else codes, cmat, bmat, stat, v,
          eta.reshape(()))
