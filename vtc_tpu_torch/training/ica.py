"""ICA dictionary learning: counterpart of vtc_tpu/training/ica.py:1-633.

Fully-connected only, a square (critically sampled) dictionary,
``ica_natural_gradient`` updates, an iteration-indexed update schedule
with a mandatory 0 entry, optional checkpoint and visualization schedules
with pSNR logging.  ``all_params`` is never mutated.

* ``train_dictionary`` (:38-106): per batch, the exact linear solve of the
  current dictionary and the natural-gradient update.
* ``train_dictionary_scanned`` (:336-600): whole segments between the
  scheduled events.  With ``warm_inverse`` (default) the inverse is seeded
  exactly once and tracked by ``refine_iters`` Newton-Schulz refreshes per
  step.  Where ``use_fused`` allows, each segment runs the fused ICA
  kernels (ops/fused_ica_train, the port of K8), whose per-step divergence
  guard is kept optimistically, as vtc_tpu keeps it: the segment's largest
  residual is checked at the host-sync points (checkpoints, visualization,
  the end), and a segment that failed it rolls back to its input state and
  reruns, with everything after it, on the per-step guarded path (LU
  fallback and all).  That rollback is vtc_tpu's numerical guard, not a
  way around the kernels; ``rollbacks`` counts them.  The port cuts no
  power-of-two chunks, so a rollback takes a whole segment; the result is
  the same.

With ``all_params['data_parallel']`` (True: the default process group's
world, or one rank without a group; or a ``parallel.Mesh``) the scanned
trainer shards each batch over the mesh (:428-437): every rank calls it
with the same global batches, keeps its shard of the batch axis on the
device and returns the same dictionary.  ``_segment_runner_dp`` (:250-333)
runs, per step, this rank's codes, one all-reduce of the statistic
codes^T sign(codes) and the replicated update.  With the fused path on
(``use_fused`` as above), on a mesh without a 'dcn' axis (``use_rdma_dp``,
:478-495), ``_dp_kernel_segment_runner`` (:218-247, vtc_tpu's
``_rdma_segment_runner_dp``) runs each rank's whole segment through K18
(``ops/fused_ica_train.fused_ica_dp_train_segment``: one C loop per
segment, the statistic summed over the ranks between each step's
statistic and its update); on a mesh with one, ``_segment_runner_dp(
fused=True)`` runs K9's composition, one solve+stats step per shard
(``ops/fused_ica_train.ica_solve_stats``), as vtc_tpu does.  Either way
the segment's largest residual feeds the same lazy guard, whose rollback
reruns on the plain data-parallel runner.  vtc_tpu's further terms for
K18 are its VMEM budget and its interpret-mode device count (the CPU
interpreter's remote-DMA simulation needs a spare host thread), which have
no counterpart here.  Rank 0 writes checkpoints and figures.

The tensors live on ``device``: the keyword argument, else that of the
first tensor among the data and the initial dictionary, else the CUDA
device (raising without one).  The per-batch trainer has no data-parallel
mode, in vtc_tpu or here.

``all_params['train_precision']`` ('highest' default, 'bf16x5', 'bf16x3',
'bf16') tiers the scanned trainer's Newton-Schulz refreshes and codes, as
vtc_tpu's does (:143-153, :414-426; it needs warm_inverse): the fused
kernels take the tier (``ops/fused_ica_train``, vtc_tpu's
``_make_ns_dot``), the guard and boost tolerances are the tier's
(``_TIERS``), and the per-step path of the fallback and of
``use_fused=False`` runs the tier's XLA precision with the TPU's meaning
(``invertible_linear``'s module docstring): bf16x3 and bf16 their passes,
bf16x5 'highest', since XLA has no 5-pass precision.  The statistic and
the update stay float32.  The per-batch ``train_dictionary`` reads no
'train_precision', as vtc_tpu's reads none: it runs the exact solve at
full precision whatever the key says.
"""
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from vtc_tpu_torch import parallel
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    invertible_linear)
from vtc_tpu_torch.device import resolve_device
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    ica_natural_gradient)
from vtc_tpu_torch.ops import fused_ica_train
from vtc_tpu_torch.ops.precision import matmul_precision, ns_dot, xla_tier
from vtc_tpu_torch.training import sparse_coding as sc
from vtc_tpu_torch.utils import checkpoint as ckpt_util

rollbacks = 0

# training tier -> (the XLA matmul precision of the per-step path's
# refreshes and codes, the guard's residual tolerance, the boost
# tolerance), vtc_tpu :143-153.  Each tier's guard sits above its residual
# floor, and its boost just above it; bf16x5's per-step path runs
# 'highest' (XLA has no 5-pass precision).
_TIERS = {
    "highest": ("highest", 1e-3, 1e-6),
    "bf16x5": ("highest", 3e-3, 1e-4),
    "bf16x3": ("tensorfloat32", 1e-2, 3e-3),
    "bf16": ("bfloat16", 0.3, 0.25),
}


def _check_common(init_dictionary, all_params):
  assert 0 in all_params["dict_update_param_schedule"]
  assert all_params["dictionary_update_algorithm"] == "ica_natural_gradient"
  assert np.shape(init_dictionary)[0] == np.shape(init_dictionary)[1], (
      "ICA requires a square (critically sampled) dictionary")


def _open_logging(all_params, dump_params):
  """Logging folder, training_params.yaml (per-batch trainer only) and
  TensorBoard, as vtc_tpu's ICA trainers open them."""
  logging_path = all_params.get("logging_folder_fullpath")
  ckpt_sched = all_params.get("checkpoint_schedule")
  vis_sched = all_params.get("training_visualization_schedule")
  tb_writer = None
  if ckpt_sched or vis_sched:
    assert logging_path is not None
    logging_path = Path(logging_path)
    logging_path.mkdir(parents=True, exist_ok=True)
    if dump_params:
      import yaml
      with open(logging_path / "training_params.yaml", "w") as f:
        yaml.dump({k: (sorted(v) if isinstance(v, set) else v)
                   for k, v in all_params.items()
                   if k not in ("checkpoint_schedule",
                                "training_visualization_schedule")}, f)
  if vis_sched:
    from torch.utils.tensorboard import SummaryWriter
    tb_writer = SummaryWriter(str(logging_path))
  return logging_path, tb_writer


def _fused_step(dictionary, batch, stepsize, num_iters):
  codes = invertible_linear._solve_nonortho(batch, dictionary)
  return ica_natural_gradient._update(dictionary, codes, stepsize, num_iters)


def train_dictionary(image_dataset, init_dictionary, all_params, *,
                     device=None):
  """Train an ICA dictionary one batch at a time; returns the final
  dictionary, a float32 tensor on the training device.

  all_params: 'num_epochs', 'dictionary_update_algorithm'
  ('ica_natural_gradient'), 'dict_update_param_schedule' (0 mandatory,
  values {'stepsize', 'num_iters'}), optional 'checkpoint_schedule',
  'training_visualization_schedule', 'logging_folder_fullpath',
  'stdout_print_interval', 'reshaped_kernel_size'.
  """
  _check_common(init_dictionary, all_params)
  if all_params.get("data_parallel"):
    raise ValueError(
        "the per-batch ICA trainer has no data-parallel mode (nor has "
        "vtc_tpu's); train_dictionary_scanned takes data_parallel")
  device = resolve_device(device, init_dictionary)
  dictionary = sc.as_tensor(init_dictionary, device)
  schedule = all_params["dict_update_param_schedule"]
  ckpt_sched = all_params.get("checkpoint_schedule")
  vis_sched = all_params.get("training_visualization_schedule")
  print_interval = all_params.get("stdout_print_interval", 1000)
  logging_path, tb_writer = _open_logging(all_params, dump_params=True)

  stepsize = num_iters = None
  start_time = time.time()
  total_iter = 0
  for epoch_idx in range(all_params["num_epochs"]):
    for batch in sc.iterate_batches(image_dataset, device):
      if total_iter % print_interval == 0:
        print("Iteration", total_iter, "complete")
        print("Time elapsed: {:.1f} seconds".format(time.time() - start_time))
        print("-----")
      if total_iter in schedule:
        stepsize = float(schedule[total_iter]["stepsize"])
        num_iters = int(schedule[total_iter]["num_iters"])
      if ckpt_sched is not None and total_iter in ckpt_sched:
        ckpt_util.save_dictionary_checkpoint(logging_path, total_iter,
                                             sc._numpy(dictionary))
      if vis_sched is not None and total_iter in vis_sched:
        _log_progress(tb_writer, batch,
                      invertible_linear.run(batch, dictionary), dictionary,
                      all_params.get("reshaped_kernel_size"), total_iter)
      dictionary = _fused_step(dictionary, batch, stepsize, num_iters)
      total_iter += 1
    print("Epoch", epoch_idx, "finished")
  if tb_writer is not None:
    tb_writer.flush()
  return dictionary


def _segment_runner(upd_num_iters):
  """The per-batch solve and update over a segment (warm_inverse off)."""

  def run(dictionary, batches, stepsize):
    for batch in batches:
      dictionary = _fused_step(dictionary, batch, stepsize, upd_num_iters)
    return dictionary

  return run


def _segment_runner_tracked(upd_num_iters, refine_iters=3, mxu="highest"):
  """Warm Newton-Schulz inverse tracking under the per-step guard
  (invertible_linear.refine_inverse_guarded: boost, then the LU fallback),
  then codes = batch X and the update (vtc_tpu :156-192)."""
  precision, guard_tol, boost_tol = _TIERS[mxu]

  def run(dictionary, dinv, batches, stepsize):
    d, x = dictionary, dinv
    for batch in batches:
      x = invertible_linear.refine_inverse_guarded(
          d, x, refine_iters, residual_tol=guard_tol, precision=precision,
          boost_tol=boost_tol)
      codes = ns_dot(batch, x, xla_tier(precision))
      d = ica_natural_gradient._update(d, codes, stepsize, upd_num_iters)
    return d, x

  return run


def _fused_segment_runner(upd_num_iters, refine_iters=3, mxu="highest"):
  """The whole segment through the fused ICA kernels (the plain version
  on CPU tensors); returns (dictionary, dinv, max_residual) for the
  caller's lazy guard (vtc_tpu :195-215)."""
  boost_tol = _TIERS[mxu][2]

  def run(dictionary, dinv, batches, stepsize):
    return fused_ica_train.fused_ica_train_segment(
        dictionary, dinv, batches, stepsize, refine_iters=refine_iters,
        upd_num_iters=upd_num_iters, mxu=mxu, boost_tol=boost_tol)

  return run


def _dp_kernel_segment_runner(upd_num_iters, mesh, refine_iters=3,
                              mxu="highest"):
  """This rank's shards of the whole segment through the data-parallel ICA
  segment kernels (K18), the statistic summed over ``mesh`` once per step;
  returns (dictionary, dinv, max_residual) for the caller's lazy guard, as
  ``_fused_segment_runner`` does (vtc_tpu :218-247)."""
  boost_tol = _TIERS[mxu][2]

  def run(dictionary, dinv, batches, stepsize):
    return fused_ica_train.fused_ica_dp_train_segment(
        dictionary, dinv, batches, stepsize, mesh=mesh,
        refine_iters=refine_iters, upd_num_iters=upd_num_iters, mxu=mxu,
        boost_tol=boost_tol)

  return run


def _segment_runner_dp(upd_num_iters, mesh, warm_inverse, refine_iters=3,
                       mxu="highest", fused=False):
  """The data-parallel segment over this rank's shards: per step the
  shard's codes, one sum of the statistic codes^T sign(codes) over the
  mesh, and the replicated update.  The statistic is a batch mean, so the
  sum of the shards' sums over global_b is the single-device value up to
  the order of the sum; the inverse tracking (or the LU solve) needs the
  replicated dictionary alone and runs replicated (vtc_tpu :250-333).

  ``fused=True``: the refreshes, codes and statistic are one solve+stats
  step per shard (K9), and the runner returns (dictionary, dinv,
  max_residual), the largest post-refinement residual of the segment (the
  same on every rank), kept on the device for the caller's lazy guard.
  Otherwise it returns (dictionary, dinv) from the per-step guarded
  tracking, or with ``warm_inverse`` off from the shard's LU solve."""
  precision, guard_tol, boost_tol = _TIERS[mxu]

  def update(d, stat_sum, shard_b, stepsize):
    stat = mesh.sum(stat_sum) / (shard_b * mesh.size)
    return ica_natural_gradient._update_from_stat(d, stat, stepsize,
                                                  upd_num_iters)

  if fused:

    def run(dictionary, dinv, batches, stepsize):
      d, x = dictionary, dinv
      r_max = torch.zeros((), dtype=d.dtype, device=d.device)
      for batch_shard in batches:
        x, stat_sum, res = fused_ica_train.ica_solve_stats(
            d, x, batch_shard, refine_iters=refine_iters, mxu=mxu,
            boost_tol=boost_tol)
        d = update(d, stat_sum, batch_shard.shape[0], stepsize)
        r_max = torch.maximum(r_max, res)  # keeps NaN
      return d, x, r_max

    return run

  def run(dictionary, dinv, batches, stepsize):
    d, x = dictionary, dinv
    for batch_shard in batches:
      if warm_inverse:
        x = invertible_linear.refine_inverse_guarded(
            d, x, refine_iters, residual_tol=guard_tol, precision=precision,
            boost_tol=boost_tol)
        codes = ns_dot(batch_shard, x, xla_tier(precision))
      else:
        codes = invertible_linear._solve_nonortho(batch_shard, d)
      with matmul_precision():
        stat_sum = codes.T @ torch.sign(codes)
      d = update(d, stat_sum, batch_shard.shape[0], stepsize)
    return d, x

  return run


def train_dictionary_scanned(training_batches, init_dictionary, all_params,
                             *, device=None):
  """Train with whole segments (see the module docstring); same
  ``all_params`` schema as ``train_dictionary``, plus 'warm_inverse'
  (default True), 'refine_iters' (Newton-Schulz refreshes per step,
  default 3) and 'use_fused': None (default) runs the fused kernels on a
  CUDA device, True runs the fused path on any device (the plain version
  on CPU tensors), False the per-step path; 'train_precision' (module
  docstring).  ``training_batches`` is a stacked (k, b, n) array or
  tensor.  Returns the final dictionary, a float32 tensor on the training
  device.  ValueError where vtc_tpu asserts (:420-426): an unknown
  'train_precision', or a tier with warm_inverse off."""
  _check_common(init_dictionary, all_params)
  warm_inverse = bool(all_params.get("warm_inverse", True))
  mxu = str(all_params.get("train_precision", "highest"))
  if mxu not in _TIERS:
    raise ValueError("train_precision must be 'highest', 'bf16x5', "
                     "'bf16x3', or 'bf16', got %r" % (mxu,))
  if mxu != "highest" and not warm_inverse:
    raise ValueError("train_precision tiers require warm_inverse=True (the "
                     "exact per-batch LU solve has no hot matmul to tier)")
  schedule = all_params["dict_update_param_schedule"]
  ckpt_sched = all_params.get("checkpoint_schedule") or set()
  vis_sched = all_params.get("training_visualization_schedule") or set()
  kernel_reshaping = all_params.get("reshaped_kernel_size")
  data_parallel = all_params.get("data_parallel", False)
  dp_mesh = parallel.resolve_mesh(data_parallel) if data_parallel else None
  writer = dp_mesh is None or dp_mesh.rank == 0
  logging_path, tb_writer = (_open_logging(all_params, dump_params=False)
                             if writer else (None, None))

  device = resolve_device(device, training_batches, init_dictionary)
  if dp_mesh is not None:
    # this rank's shard of the batch axis; the rest stays with the caller
    training_batches = dp_mesh.shard(training_batches, dim=1)
  training_batches = sc.as_tensor(training_batches, device)
  dictionary = sc.as_tensor(init_dictionary, device)
  k = training_batches.shape[0]
  total_iters = all_params["num_epochs"] * k
  boundaries = sorted({0, total_iters} | set(schedule) | set(ckpt_sched)
                      | set(vis_sched)
                      | {e * k for e in range(all_params["num_epochs"] + 1)})
  boundaries = [x for x in boundaries if 0 <= x <= total_iters]

  dinv = invertible_linear.exact_inverse(dictionary) if warm_inverse else None
  if dp_mesh is not None and dinv is None:
    # the data-parallel runner carries the inverse either way; unused with
    # warm_inverse off, where the codes come from the shard's LU solve
    dinv = torch.zeros_like(dictionary)
  guard_tol = _TIERS[mxu][1]
  refine = int(all_params.get("refine_iters", 3))
  use_fused = all_params.get("use_fused")
  geom_ok = fused_ica_train.fused_ica_segment_supported(
      dictionary.shape[1], training_batches.shape[1], dictionary.shape[0])
  if use_fused is True and not (warm_inverse and geom_ok):
    warnings.warn(
        "use_fused=True but the fused ICA kernels do not take this "
        "configuration (they need warm_inverse and a square dictionary) -- "
        "running the per-step path instead", stacklevel=2)
  fused_on = (warm_inverse and geom_ok
              and (use_fused is True
                   or (use_fused is None and device.type == "cuda")))
  # the whole-segment data-parallel kernel K18 where vtc_tpu takes it
  # (:486-488): a mesh without a 'dcn' axis whose only axis above 1, if
  # any, is 'data' (K18's gate is geom_ok's)
  use_dp_kernel = (fused_on and dp_mesh is not None
                   and "dcn" not in dp_mesh.axis_names
                   and dp_mesh.code_size == 1)
  pending = []  # fused segments awaiting their guard check

  def drain_guard():
    global rollbacks
    nonlocal dictionary, dinv
    bad = None
    for i, ent in enumerate(pending):
      if not bool(ent["res"] < guard_tol):  # NaN counts as diverged
        bad = i
        break
    if bad is not None:
      rollbacks += 1
      dictionary, dinv = pending[bad]["d_in"], pending[bad]["dinv_in"]
      for ent in pending[bad:]:  # everything after it is stale too
        fallback = (
            _segment_runner_dp(ent["upd_niters"], dp_mesh, warm_inverse,
                               refine_iters=refine, mxu=mxu)
            if dp_mesh is not None else
            _segment_runner_tracked(ent["upd_niters"], refine_iters=refine,
                                    mxu=mxu))
        dictionary, dinv = fallback(dictionary, dinv, ent["batches"],
                                    ent["stepsize"])
    pending.clear()

  rollbacks_before = rollbacks
  stepsize = upd_niters = None
  start = time.time()
  for seg_start, seg_end in zip(boundaries[:-1], boundaries[1:]):
    if seg_start in schedule:
      stepsize = float(schedule[seg_start]["stepsize"])
      upd_niters = int(schedule[seg_start]["num_iters"])
    if seg_start in ckpt_sched:
      drain_guard()
      if writer:
        ckpt_util.save_dictionary_checkpoint(logging_path, seg_start,
                                             sc._numpy(dictionary))
    if seg_start in vis_sched:
      drain_guard()
      if writer:
        batch = training_batches[seg_start - (seg_start // k) * k]
        _log_progress(tb_writer, batch,
                      invertible_linear.run(batch, dictionary), dictionary,
                      kernel_reshaping, seg_start)
    if seg_end == seg_start:
      continue
    epoch = seg_start // k
    lo, hi = seg_start - epoch * k, seg_end - epoch * k
    assert 0 <= lo < hi <= k
    batches = training_batches[lo:hi]
    if fused_on:
      ent = {"batches": batches, "d_in": dictionary, "dinv_in": dinv,
             "stepsize": stepsize, "upd_niters": upd_niters}
      if dp_mesh is None:
        runner = _fused_segment_runner(upd_niters, refine_iters=refine,
                                       mxu=mxu)
      elif use_dp_kernel:
        runner = _dp_kernel_segment_runner(upd_niters, dp_mesh,
                                           refine_iters=refine, mxu=mxu)
      else:
        runner = _segment_runner_dp(upd_niters, dp_mesh, warm_inverse,
                                    refine_iters=refine, mxu=mxu, fused=True)
      dictionary, dinv, ent["res"] = runner(dictionary, dinv, batches,
                                            stepsize)
      pending.append(ent)
    elif dp_mesh is not None:
      dictionary, dinv = _segment_runner_dp(
          upd_niters, dp_mesh, warm_inverse, refine_iters=refine, mxu=mxu)(
              dictionary, dinv, batches, stepsize)
    elif warm_inverse:
      dictionary, dinv = _segment_runner_tracked(
          upd_niters, refine_iters=refine, mxu=mxu)(
              dictionary, dinv, batches, stepsize)
    else:
      dictionary = _segment_runner(upd_niters)(dictionary, batches, stepsize)
  drain_guard()
  if writer and total_iters in ckpt_sched:
    ckpt_util.save_dictionary_checkpoint(logging_path, total_iters,
                                         sc._numpy(dictionary))
  if writer and total_iters in vis_sched:
    batch = training_batches[k - 1]
    _log_progress(tb_writer, batch, invertible_linear.run(batch, dictionary),
                  dictionary, kernel_reshaping, total_iters)
  if tb_writer is not None:
    tb_writer.flush()
  print("scanned ICA training done in {:.2f}s ({} iterations, {} guard "
        "rollbacks)".format(time.time() - start, total_iters,
                            rollbacks - rollbacks_before))
  return dictionary


def _log_progress(tb_writer, batch, codes, dictionary, reshaping, step):
  """pSNR scalar and dictionary tile images (vtc_tpu :603-633)."""
  import io

  from matplotlib import pyplot as plt
  from PIL import Image

  from vtc_tpu_torch.utils import plotting as plot_utils

  batch_np = sc._numpy(batch)
  dict_np = sc._numpy(dictionary)
  recons = sc._numpy(codes) @ dict_np
  sig_mag = np.max(batch_np) - np.min(batch_np)
  psnrs = [sc.compute_pSNR(batch_np[i], recons[i], manual_sig_mag=sig_mag)
           for i in range(recons.shape[0])]
  psnrs = [p for p in psnrs if p != np.inf]
  tb_writer.add_scalar("Average pSNR of reconstructions",
                       float(np.mean(psnrs)), step)
  for renorm, tag in ((True, "renormalized"), (False, "no renorm")):
    figs = plot_utils.display_dictionary(
        dict_np, renormalize=renorm, reshaping=reshaping,
        plot_title="Current dictionary ({}), iter {}".format(tag, step))
    for fig_idx, fig in enumerate(figs):
      buf = io.BytesIO()
      fig.savefig(buf, format="png")
      plt.close(fig)
      buf.seek(0)
      tb_writer.add_image(
          "Current dictionary ({}), fig {} of {}".format(
              tag, fig_idx + 1, len(figs)),
          np.array(Image.open(buf))[:, :, :3], global_step=step,
          dataformats="HWC")
