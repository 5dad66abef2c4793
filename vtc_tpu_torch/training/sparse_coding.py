"""Sparse-coding dictionary learning, fully-connected (with its subspace,
group-sparse, variants) and convolutional: counterpart of
vtc_tpu/training/sparse_coding.py:89-696.

``train_dictionary(training_image_dataset, validation_image_dataset,
init_dictionary, all_params)`` keeps vtc_tpu's ``all_params`` schema:
iteration-indexed schedules with a mandatory 0 entry, optional
checkpoint / visualization / reset-prune schedules, the YAML config dump,
TensorBoard logging, pickled NumPy dictionary checkpoints with the
train-state sidecar, and the extras 'stepsize_update_interval',
'lipschitz_method', 'fc_formulation', 'resume_state' and
'early_stopping_epsilon', and for mode='convolutional' 'strides',
'padding' and 'conv_formulation'.  Each batch runs ``build_raw_step_fn``'s
step eagerly: the stepsize, the solve, the Hessian-diagonal EMA and the
dictionary update.  With ``fc_formulation='pallas'`` a CUDA device runs
every fc solve through K1's kernel (ops/fused_fista); the subspace solve
runs the 'gram' loop there, as vtc_tpu's does (sparse_coding.py:173-186).
In conv mode ``conv_formulation='auto'`` runs the solve through K10's
kernel (ops/fused_conv_direct) on a CUDA device where its gate holds, as
vtc_tpu does on the TPU (:214-231), and the update through the
stride-block gradient.

The tensors live on ``device``: the keyword argument, else the initial
dictionary's device when it is a tensor, else the CUDA device (raising
without one; ``device="cpu"`` runs on the CPU).  Checkpoints, reset/prune
and the dictionary figures use the port's own copies of vtc_tpu's
numpy-only host modules (utils/checkpoint, training/reset_prune,
utils/debug, utils/plotting).

With ``all_params['data_parallel']`` (True, or a ``parallel.Mesh``), fc,
subspace and conv: every rank calls the trainer with the same global
batches, solves its own shard of each (``parallel.build_dp_local_step``,
the step of ``build_shard_map_train_step``: the gradient and the Hessian
statistic are summed over the ranks, the update runs replicated) and
returns the same dictionary (vtc_tpu :484-509).  True means the default
process group's world, or one rank without a group.  Rank 0 of the mesh
writes the checkpoints and the TensorBoard log, and its reset/prune draw
is broadcast, so the replicated dictionary stays the same on every rank.

Raise NotImplementedError, each naming its ROADMAP.md §1 item:
profile_dir (item 8), and an early stop where the conv CUDA kernel K10
would run the solve on the card (item 3a.1).  With
``fc_formulation='pallas'`` K1 stops on the device.
"""
import time
from pathlib import Path

import numpy as np
import torch

from vtc_tpu_torch.analysis_transforms.convolutional import (
    ista_fista as conv_ista_fista)
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista)
from vtc_tpu_torch import parallel
from vtc_tpu_torch.device import resolve_device
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_cheap_quadratic_descent as conv_cqd)
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_steepest_descent as conv_sd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_cheap_quadratic_descent as fc_cqd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_steepest_descent as fc_sd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    subspace_sc_cheap_quadratic_descent as fc_sub_cqd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    subspace_sc_steepest_descent as fc_sub_sd)
from vtc_tpu_torch.ops import conv_shapes, fused_conv_direct, fused_conv_fista
from vtc_tpu_torch.ops import fused_group_train_step, fused_train_step
from vtc_tpu_torch.ops import convolutions as conv_ops
from vtc_tpu_torch.ops import lipschitz as lipschitz_ops
from vtc_tpu_torch.training import reset_prune
from vtc_tpu_torch.utils import checkpoint as ckpt_util
from vtc_tpu_torch.utils.debug import assert_dictionary_healthy

INFERENCE_ALGS = ("ista", "fista") + fused_group_train_step.INFERENCE_ALGS
UPDATE_ALGS = fused_train_step.UPDATE_ALGS + fused_group_train_step.UPDATE_ALGS
CHEAP_QUAD_ALGS = ("sc_cheap_quadratic_descent",
                   "subspace_sc_cheap_quadratic_descent")


def check_supported(mode, inference_alg, update_alg, group_assignments=None):
  """Raise for algorithm combinations that do not exist."""
  if mode not in ("fully-connected", "convolutional"):
    raise ValueError("unknown mode %r" % (mode,))
  if mode == "convolutional" and (inference_alg.startswith("subspace")
                                  or update_alg.startswith("subspace")):
    raise NotImplementedError(
        "the subspace algorithms are fully-connected only (as in vtc_tpu, "
        "sparse_coding.py:294-296 and :480-482)")
  if inference_alg not in INFERENCE_ALGS:
    raise ValueError("unknown inference algorithm %r" % (inference_alg,))
  if update_alg not in UPDATE_ALGS:
    raise ValueError("unknown update algorithm %r" % (update_alg,))
  if group_assignments is None and (inference_alg.startswith("subspace")
                                    or update_alg.startswith("subspace")):
    raise ValueError("the subspace algorithms need group_assignments")


def normalize_groups(group_assignments):
  """Groups as lists of ints, each without repeated members (vtc_tpu
  sparse_coding.py:420-424), or None."""
  if group_assignments is None:
    return None
  if not all(len(set(g)) == len(g) for g in group_assignments):
    raise ValueError("a group repeats a member: %r" % (group_assignments,))
  return [[int(i) for i in g] for g in group_assignments]


def lipschitz_matrix(dictionary, inference_alg, group_assignments):
  """The matrix whose Gram sets the stepsize: the grouped dictionary for
  the subspace solves, the flattened (s, c*kh*kw) kernels of a conv
  dictionary, else the dictionary."""
  if dictionary.dim() == 4:
    return dictionary.reshape(dictionary.shape[0], -1)
  if not inference_alg.startswith("subspace"):
    return dictionary
  gather_inds, valid_mask, _ = subspace_ista_fista.group_layout(
      group_assignments, dictionary.shape[0], dictionary.device)
  return subspace_ista_fista.build_grouped_dictionary(dictionary,
                                                      gather_inds, valid_mask)


def as_tensor(x, device):
  """float32 tensor on ``device`` from a tensor or anything numpy reads."""
  if not isinstance(x, torch.Tensor):
    x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
  return x.to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# batch iteration over the accepted dataset containers
# ---------------------------------------------------------------------------
def iterate_batches(dataset, device, mesh=None):
  """Yield batches as float32 tensors on ``device`` from an ndarray or
  tensor of stacked batches (k, b, n), a list/tuple of batches, or any
  re-iterable yielding batches (vtc_tpu sparse_coding.py:89-98).  With a
  ``parallel.Mesh``, only this rank's shard of each batch is moved."""
  if isinstance(dataset, (np.ndarray, torch.Tensor)):
    batches = (dataset[i] for i in range(dataset.shape[0]))
  else:
    batches = dataset
  for batch in batches:
    yield as_tensor(batch if mesh is None else mesh.shard(batch), device)


# ---------------------------------------------------------------------------
# the fused train step
# ---------------------------------------------------------------------------
def build_raw_step_fn(mode, inference_alg, update_alg, *, nonneg=False,
                      hard_threshold=False, kernel_stride=None,
                      padding=None, group_assignments=None,
                      alignment_penalty=0.0, renormalize=True,
                      fc_formulation="gram", conv_formulation="auto",
                      lipschitz_method="eigvalsh",
                      compute_stepsize_in_step=True,
                      lowest_code_val=0.001,
                      early_stopping_epsilon=None):
  """Build the train step for a static algorithm config (vtc_tpu
  sparse_coding.py:122-311, fully-connected and subspace branches).

  Returns ``step(dictionary, hessian, batch, sparsity_weight,
  inf_num_iters, upd_stepsize, upd_num_iters, inf_stepsize) ->
  (new_dictionary, new_hessian, codes)``.  ``inf_stepsize`` is ignored
  when ``compute_stepsize_in_step`` (1/L comes from the current
  dictionary by ``lipschitz_method``).  ``fc_formulation``: 'gram' |
  'direct' | 'pallas' (K1's kernel on a CUDA device, with
  ``early_stopping_epsilon`` its stop test on the device; CPU tensors run
  the plain version, stop test included).  The subspace solve
  ('subspace_ista', 'subspace_fista') runs the 'gram' loop for 'pallas',
  as vtc_tpu's does, with hard thresholding off (vtc_tpu :173-186).
  ``alignment_penalty``: the subspace updates' anti-alignment weight (0
  takes the fc rule).  ``kernel_stride``, ``padding`` and
  ``conv_formulation`` belong to the conv branch (``_build_conv_step``).
  """
  check_supported(mode, inference_alg, update_alg, group_assignments)
  if mode == "convolutional":
    return _build_conv_step(
        inference_alg, update_alg, nonneg=nonneg,
        hard_threshold=hard_threshold, kernel_stride=kernel_stride,
        padding=padding, renormalize=renormalize,
        conv_formulation=conv_formulation,
        lipschitz_method=lipschitz_method,
        compute_stepsize_in_step=compute_stepsize_in_step,
        lowest_code_val=lowest_code_val,
        early_stopping_epsilon=early_stopping_epsilon)
  if fc_formulation not in ("gram", "direct", "pallas"):
    raise ValueError("fc_formulation must be 'gram', 'direct' or 'pallas'")
  is_subspace_inf = inference_alg.startswith("subspace")
  variant = inference_alg[9:] if is_subspace_inf else inference_alg
  uses_hessian = update_alg in CHEAP_QUAD_ALGS
  alignment_penalty = float(alignment_penalty)
  groups = normalize_groups(group_assignments)

  def layout(dictionary):
    return subspace_ista_fista.group_layout(groups, dictionary.shape[0],
                                            dictionary.device)

  def infer(dictionary, batch, sparsity_weight, num_iters, stepsize):
    if not is_subspace_inf:
      if compute_stepsize_in_step:
        stepsize = lipschitz_ops.fista_stepsize(dictionary,
                                                lipschitz_method)
      return ista_fista.run(
          batch, dictionary, sparsity_weight, num_iters, variant=variant,
          early_stopping_epsilon=early_stopping_epsilon,
          nonnegative_only=nonneg, hard_threshold=hard_threshold,
          stepsize=stepsize, formulation=fc_formulation)
    gather_inds, valid_mask, index = layout(dictionary)
    grouped = subspace_ista_fista.build_grouped_dictionary(
        dictionary, gather_inds, valid_mask)
    if compute_stepsize_in_step:
      stepsize = lipschitz_ops.fista_stepsize(grouped, lipschitz_method)
    init = torch.zeros((batch.shape[0],) + tuple(gather_inds.shape),
                       dtype=batch.dtype, device=batch.device)
    return subspace_ista_fista._solve(
        batch, grouped, gather_inds, valid_mask, sparsity_weight,
        num_iters, torch.as_tensor(stepsize, dtype=batch.dtype,
                                   device=batch.device),
        init, variant, False, early_stopping_epsilon,
        "direct" if fc_formulation == "direct" else "gram",
        dictionary.shape[0], True, index)

  def update(dictionary, hessian, batch, codes, upd_stepsize,
             upd_num_iters):
    if update_alg.startswith("subspace") and alignment_penalty != 0:
      gather_inds, valid_mask, _ = layout(dictionary)
      if uses_hessian:
        return fc_sub_cqd._update_with_reg(
            batch, dictionary, codes, gather_inds, valid_mask, hessian,
            alignment_penalty, upd_stepsize, upd_num_iters, lowest_code_val,
            renormalize)
      return fc_sub_sd._update_with_reg(
          batch, dictionary, codes, gather_inds, valid_mask,
          alignment_penalty, upd_stepsize, upd_num_iters, renormalize)
    if uses_hessian:
      return fc_cqd._update(batch, dictionary, codes, hessian, upd_stepsize,
                            upd_num_iters, lowest_code_val, renormalize)
    return fc_sd._update(batch, dictionary, codes, upd_stepsize,
                         upd_num_iters, renormalize)

  def step(dictionary, hessian, batch, sparsity_weight, inf_num_iters,
           upd_stepsize, upd_num_iters, inf_stepsize):
    codes = infer(dictionary, batch, float(sparsity_weight),
                  int(inf_num_iters), inf_stepsize)
    if uses_hessian:
      hessian = fc_cqd.hessian_diagonal_ema(hessian, codes)
    new_dict = update(dictionary, hessian, batch, codes,
                      float(upd_stepsize), int(upd_num_iters))
    return new_dict, hessian, codes

  return step


def _build_conv_step(inference_alg, update_alg, *, nonneg, hard_threshold,
                     kernel_stride, padding, renormalize, conv_formulation,
                     lipschitz_method, compute_stepsize_in_step,
                     lowest_code_val, early_stopping_epsilon):
  """The conv train step (vtc_tpu sparse_coding.py:208-240 and :269-296).

  The solve: ``conv_formulation`` 'auto' takes K10 (ops/fused_conv_direct)
  on a CUDA device where its gate holds, 'pallas' takes K10 (or its plain
  version on the CPU) where the gate holds, and everything else runs the
  'gram' loop.  The update: the stride-block gradient where K10's gate
  holds, else the code-space one, else the image-space one.
  """
  if kernel_stride is None:
    raise ValueError("mode='convolutional' needs kernel_stride")
  if conv_formulation not in ("auto", "pallas", "gram"):
    raise ValueError("conv_formulation must be 'auto', 'pallas' or 'gram'")
  stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  uses_hessian = update_alg in CHEAP_QUAD_ALGS
  flags = dict(kernel_stride=stride, padding=padding, variant=inference_alg,
               nonneg=nonneg, hard=hard_threshold)

  def infer(dictionary, batch, sparsity_weight, num_iters, stepsize):
    if compute_stepsize_in_step:
      stepsize = lipschitz_ops.fista_stepsize(
          dictionary.reshape(dictionary.shape[0], -1), lipschitz_method)
    on_card = batch.device.type == "cuda"
    if (conv_formulation != "gram"
        and (conv_formulation == "pallas" or on_card)
        and fused_conv_direct.supported(batch.shape, dictionary.shape,
                                        stride)):
      # K10, its stop test in the kernel on the card
      return fused_conv_direct.fused_conv_direct_solve(
          batch, dictionary, sparsity_weight, num_iters, stepsize,
          early_stopping_epsilon=early_stopping_epsilon, **flags)
    return fused_conv_fista.fused_conv_fista_plain(
        batch, dictionary, sparsity_weight, num_iters, stepsize,
        early_stopping_epsilon=early_stopping_epsilon, **flags)

  def update(dictionary, hessian, batch, codes, upd_stepsize,
             upd_num_iters):
    mask = conv_shapes.create_mask(batch.shape, padding, batch.dtype,
                                   batch.device)
    formulation = conv_sd.resolve_formulation(batch.shape, dictionary.shape,
                                              stride)
    if uses_hessian:
      return conv_cqd._update(batch, dictionary, codes, hessian, mask,
                              stride, upd_stepsize, upd_num_iters,
                              lowest_code_val, renormalize, padding,
                              formulation)
    return conv_sd._update(batch, dictionary, codes, mask, stride,
                           upd_stepsize, upd_num_iters, renormalize,
                           padding, formulation)

  def step(dictionary, hessian, batch, sparsity_weight, inf_num_iters,
           upd_stepsize, upd_num_iters, inf_stepsize):
    codes = infer(dictionary, batch, float(sparsity_weight),
                  int(inf_num_iters), inf_stepsize)
    if uses_hessian:
      hessian = conv_cqd.hessian_diagonal_ema(hessian, codes)
    new_dict = update(dictionary, hessian, batch, codes,
                      float(upd_stepsize), int(upd_num_iters))
    return new_dict, hessian, codes

  return step


# ---------------------------------------------------------------------------
# metrics (host dict)
# ---------------------------------------------------------------------------
def compute_pSNR(target, reconstruction, manual_sig_mag=None):
  """Peak signal-to-noise ratio, 10 log10(range^2 / MSE); np.inf for an
  exact reconstruction (vtc_tpu/utils/plotting.py:26-43, ported so the
  metrics never import matplotlib)."""
  target = np.asarray(target)
  reconstruction = np.asarray(reconstruction)
  if manual_sig_mag is None:
    signal_magnitude = np.max(target) - np.min(target)
  else:
    signal_magnitude = manual_sig_mag
  mse = np.mean(np.square(target - reconstruction))
  if mse == 0:
    return np.inf
  return 10.0 * np.log10(signal_magnitude**2 / mse)


def _numpy(x):
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def compute_metrics(batch, codes, dictionary, previous_dictionary, *,
                    mode, sparsity_weight, group_assignments=None,
                    kernel_stride=None, padding=None, is_subspace=False):
  """Validation metrics (vtc_tpu sparse_coding.py:328-384): LASSO l2
  term, sparsity term (l1, or with ``is_subspace`` the sum of the group
  norms over ``group_assignments``), their total, normalized L0, mean pSNR
  with the range taken from the batch (padding stripped in conv mode),
  and the mean absolute dictionary change."""
  images = _numpy(batch)
  codes_np = _numpy(codes)
  dict_np = _numpy(dictionary)
  prev_np = _numpy(previous_dictionary)
  if mode == "fully-connected":
    recons = codes_np @ dict_np
    sum_axes = 1
  else:
    recons = _numpy(conv_ops.synthesize(
        torch.from_numpy(codes_np), torch.from_numpy(dict_np),
        kernel_stride))
    if padding is not None:
      (lv, tv), (lh, th) = padding
      h, w = images.shape[2], images.shape[3]
      recons = recons[:, :, lv:h - tv, lh:w - th]
      images = images[:, :, lv:h - tv, lh:w - th]
    sum_axes = (1, 2, 3)
  metrics = {}
  metrics["Average LASSO L2 component"] = float(np.mean(
      0.5 * np.sum(np.square(recons - images), axis=sum_axes)))
  if is_subspace:
    group_norm_sum = np.zeros(codes_np.shape[0])
    for members in group_assignments:
      group_norm_sum += np.linalg.norm(
          codes_np[:, np.asarray(list(members), int)], axis=1)
    metrics["Average LASSO lagrange component"] = float(
        np.mean(sparsity_weight * group_norm_sum))
  else:
    metrics["Average LASSO lagrange component"] = float(np.mean(
        sparsity_weight * np.sum(np.abs(codes_np), axis=sum_axes)))
  metrics["Average LASSO Loss"] = (
      metrics["Average LASSO L2 component"] +
      metrics["Average LASSO lagrange component"])
  metrics["Average Normalized L0"] = float(
      np.mean(np.count_nonzero(codes_np.reshape(codes_np.shape[0], -1),
                               axis=1) / np.prod(codes_np.shape[1:])))
  sig_mag = np.max(images) - np.min(images)
  psnrs = [compute_pSNR(images[i], recons[i], manual_sig_mag=sig_mag)
           for i in range(recons.shape[0])]
  psnrs = [p for p in psnrs if p != np.inf]
  metrics["Average pSNR of reconstructions"] = float(np.mean(psnrs))
  metrics["Average change in dictionary kernels"] = float(np.mean(
      np.abs(dict_np - prev_np)))
  return metrics


# ---------------------------------------------------------------------------
# host-side events shared with the scanned trainer
# ---------------------------------------------------------------------------
def open_logging(all_params, group_assignments=None, writer=True):
  """Create the logging folder, dump training_params.yaml (and the
  calling script) and open TensorBoard, as vtc_tpu does
  (sparse_coding.py:436-463).  Returns (logging_path, tb_writer); both
  None when this rank is not the ``writer`` of a data-parallel run."""
  logging_path = all_params.get("logging_folder_fullpath")
  ckpt_sched = all_params.get("checkpoint_schedule")
  vis_sched = all_params.get("training_visualization_schedule")
  tb_writer = None
  if not writer:
    return None, None
  if ckpt_sched or vis_sched:
    assert logging_path is not None
    logging_path = Path(logging_path)
    logging_path.mkdir(parents=True, exist_ok=True)
    import yaml
    to_save = {k: v for k, v in all_params.items()
               if k not in ("checkpoint_schedule",
                            "training_visualization_schedule",
                            "group_assignments")}
    to_save["group_assignments"] = group_assignments
    with open(logging_path / "training_params.yaml", "w") as f:
      yaml.dump({k: (sorted(v) if isinstance(v, set) else v)
                 for k, v in to_save.items()
                 if k != "str_entire_calling_script"},
                f, default_flow_style=None)
    if "str_entire_calling_script" in all_params:
      with open(logging_path / "called_script.py", "w") as f:
        f.write(all_params["str_entire_calling_script"])
  if vis_sched:
    from torch.utils.tensorboard import SummaryWriter
    tb_writer = SummaryWriter(str(logging_path))
  return logging_path, tb_writer


def save_checkpoint(logging_path, iteration, dictionary, hessian):
  """Dictionary checkpoint plus the train-state sidecar, in vtc_tpu's
  on-disk format (utils/checkpoint, the port's copy)."""
  dict_np = _numpy(dictionary)
  assert_dictionary_healthy(dict_np, "iteration " + str(iteration))
  ckpt_util.save_dictionary_checkpoint(logging_path, iteration, dict_np)
  ckpt_util.save_trainstate_sidecar(
      logging_path, iteration, hessian_diagonal=_numpy(hessian),
      train_iteration=np.int64(iteration))


def reset_or_prune(event, dictionary, hessian, v_codes, group_assignments,
                   uses_hessian, mesh=None):
  """Apply one reset/prune event (training/reset_prune, the port's copy
  of vtc_tpu's numpy-only module).  Returns (dictionary, hessian, groups);
  after a prune that removed rows, ``groups`` is a new list of the groups
  remapped to the remaining rows (vtc_tpu sparse_coding.py:620-633), or
  None without groups; else it is ``group_assignments`` itself.  The
  event draws random numbers on the host: with a ``parallel.Mesh`` every
  rank takes rank 0's outcome."""
  f_params = dict(event["filter_params"])
  f_params["group_assignments"] = group_assignments
  outcome = reset_prune.reset_or_prune_dict_elements(
      _numpy(dictionary), v_codes, event["filter_type"], f_params,
      event["action"])
  if mesh is not None:
    outcome = mesh.broadcast_object(outcome)
  new_dict, affected, new_groups = outcome
  device = dictionary.device
  dictionary = as_tensor(new_dict, device)
  if not (event["action"] == "prune" and len(affected) > 0):
    return dictionary, hessian, group_assignments
  if uses_hessian:
    keep = np.ones(hessian.shape[0], bool)
    keep[np.asarray(affected, int)] = False
    hessian = hessian[torch.from_numpy(keep).to(device)]
  return dictionary, hessian, normalize_groups(new_groups)


def _dictionary_viz_to_tb(tb_writer, dictionary, reshaping, groupings,
                          step):
  """Render dictionary tile figures and push them to TensorBoard as
  images (vtc_tpu sparse_coding.py:699-723)."""
  import io

  from matplotlib import pyplot as plt
  from PIL import Image

  from vtc_tpu_torch.utils import plotting as plot_utils

  for renorm, tag in ((True, "renormalized"), (False, "no renorm")):
    figs = plot_utils.display_dictionary(
        dictionary, renormalize=renorm, reshaping=reshaping,
        groupings=groupings,
        plot_title="Current dictionary ({}), iter {}".format(tag, step))
    for fig_idx, fig in enumerate(figs):
      buf = io.BytesIO()
      fig.savefig(buf, format="png")
      plt.close(fig)
      buf.seek(0)
      img = np.array(Image.open(buf))[:, :, :3]
      tb_writer.add_image(
          "Current dictionary ({}), fig {} of {}".format(
              tag, fig_idx + 1, len(figs)),
          img, global_step=step, dataformats="HWC")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------
def train_dictionary(training_image_dataset, validation_image_dataset,
                     init_dictionary, all_params, *, device=None):
  """Train a sparse-coding dictionary (see the module docstring; the
  ``all_params`` schema is vtc_tpu's).  Returns the final dictionary, a
  float32 tensor on the training device."""
  assert 0 in all_params["inference_param_schedule"]
  assert 0 in all_params["dict_update_param_schedule"]
  mode = all_params["mode"]
  num_epochs = all_params["num_epochs"]
  inference_alg = all_params["code_inference_algorithm"]
  inf_schedule = all_params["inference_param_schedule"]
  update_alg = all_params["dictionary_update_algorithm"]
  upd_schedule = all_params["dict_update_param_schedule"]
  group_assignments = normalize_groups(all_params.get("group_assignments"))
  check_supported(mode, inference_alg, update_alg, group_assignments)
  if all_params.get("profile_dir") is not None:
    raise NotImplementedError(
        "profile_dir (a torch.profiler trace inside the trainer) waits, "
        "ROADMAP.md §1 item 8; tools/profile_train.py traces a segment")

  nonneg = bool(all_params.get("nonnegative_only", False))
  hard_threshold = bool(all_params.get("hard_threshold", False))
  alignment_penalty = float(
      all_params.get("subspace_alignment_penalty", 0.0))
  renormalize = bool(all_params.get("renormalize_dictionary", True))
  kernel_stride = padding = None
  if mode == "convolutional":
    kernel_stride = tuple(int(x) for x in all_params["strides"])
    padding = conv_shapes.normalize_padding(all_params["padding"])
  data_parallel = all_params.get("data_parallel", False)
  dp_mesh = parallel.resolve_mesh(data_parallel) if data_parallel else None
  writer = dp_mesh is None or dp_mesh.rank == 0
  device = resolve_device(device, init_dictionary)
  dictionary = as_tensor(init_dictionary, device)
  if renormalize:
    norms = torch.linalg.vector_norm(
        dictionary.reshape(dictionary.shape[0], -1), dim=1)
    assert np.allclose(_numpy(norms), 1.0, atol=1e-4), (
        "initial dictionary must be row/kernel normalized")

  ckpt_sched = all_params.get("checkpoint_schedule")
  vis_sched = all_params.get("training_visualization_schedule")
  rp_schedule = all_params.get("dict_element_rp_schedule")
  print_interval = all_params.get("stdout_print_interval", 1000)
  kernel_reshaping = all_params.get("reshaped_kernel_size")
  logging_path, tb_writer = open_logging(all_params, group_assignments,
                                         writer)

  fc_formulation = all_params.get("fc_formulation", "gram")
  lipschitz_method = all_params.get("lipschitz_method", "eigvalsh")
  stepsize_interval = int(all_params.get("stepsize_update_interval", 1))
  in_step_stepsize = stepsize_interval <= 1
  early_eps = all_params.get("early_stopping_epsilon")
  if early_eps is not None:
    early_eps = float(early_eps)
  uses_hessian = update_alg in CHEAP_QUAD_ALGS
  is_subspace = inference_alg.startswith("subspace")

  def make_step():
    if dp_mesh is None:
      return build_raw_step_fn(
          mode, inference_alg, update_alg, nonneg=nonneg,
          hard_threshold=hard_threshold, kernel_stride=kernel_stride,
          padding=padding, group_assignments=group_assignments,
          alignment_penalty=alignment_penalty, renormalize=renormalize,
          fc_formulation=fc_formulation,
          conv_formulation=all_params.get("conv_formulation", "auto"),
          lipschitz_method=lipschitz_method,
          compute_stepsize_in_step=in_step_stepsize,
          early_stopping_epsilon=early_eps)
    # the update iteration count is fixed when the step is built, so the
    # steps are kept per count (schedules rarely change it); the stepsize
    # is computed in the step (vtc_tpu :484-509)
    dp_steps = {}

    def step(dictionary, hessian, batch_shard, sw, n_it, upd_stp, n_upd,
             _unused_stepsize):
      if n_upd not in dp_steps:
        dp_steps[n_upd] = parallel.build_dp_local_step(
            dp_mesh, mode, inference_alg, update_alg, nonneg=nonneg,
            hard_threshold=hard_threshold, kernel_stride=kernel_stride,
            padding=padding, group_assignments=group_assignments,
            alignment_penalty=alignment_penalty, renormalize=renormalize,
            fc_formulation=fc_formulation, lipschitz_method=lipschitz_method,
            upd_num_iters=n_upd, early_stopping_epsilon=early_eps)
      return dp_steps[n_upd](dictionary, hessian, batch_shard, sw, n_it,
                             upd_stp)

    return step

  step_fn = make_step()

  def infer_only(d, batch, sw, n_it):
    """Inference for validation / reset-prune (the public run(); conv
    takes its default 'gram', as vtc_tpu does, :541-545)."""
    if mode == "convolutional":
      return conv_ista_fista.run(
          batch, d, kernel_stride, padding, sw, n_it,
          variant=inference_alg, nonnegative_only=nonneg,
          hard_threshold=hard_threshold, early_stopping_epsilon=early_eps,
          lipschitz_method=lipschitz_method)
    if is_subspace:
      return subspace_ista_fista.run(
          batch, d, group_assignments, sw, n_it,
          variant=inference_alg[9:], early_stopping_epsilon=early_eps,
          formulation=("gram" if fc_formulation == "pallas"
                       else fc_formulation),
          lipschitz_method=lipschitz_method)
    return ista_fista.run(
        batch, d, sw, n_it, variant=inference_alg,
        nonnegative_only=nonneg, hard_threshold=hard_threshold,
        early_stopping_epsilon=early_eps, formulation=fc_formulation,
        lipschitz_method=lipschitz_method)

  hessian = torch.zeros(dictionary.shape[0], dtype=torch.float32,
                        device=device)
  previous_dictionary = dictionary
  cached_inf_stepsize = None

  start_time = time.time()
  last_print_time = start_time
  patches_since_print = 0
  total_iter = 0
  sparsity_weight = inf_num_iters = None
  upd_stepsize = upd_num_iters = None

  # exact resume from the train-state sidecar (convert.load_train_state):
  # the Hessian EMA and the absolute iteration counter; num_epochs counts
  # ADDITIONAL epochs (vtc_tpu sparse_coding.py:559-582)
  resume_state = all_params.get("resume_state")
  if resume_state is not None:
    hessian = as_tensor(resume_state["hessian_diagonal"], device)
    total_iter = int(resume_state["train_iteration"])

    def _active_entry(sched):
      keys = [k for k in sched if k <= total_iter]
      return sched[max(keys)] if keys else None

    ent = _active_entry(inf_schedule)
    if ent is not None:
      sparsity_weight = float(ent["sparsity_weight"])
      inf_num_iters = int(ent["num_iters"])
    ent = _active_entry(upd_schedule)
    if ent is not None:
      upd_stepsize = float(ent["stepsize"])
      upd_num_iters = int(ent["num_iters"])

  for epoch_idx in range(num_epochs):
    for batch in iterate_batches(training_image_dataset, device, dp_mesh):
      if total_iter % print_interval == 0 and total_iter != 0:
        now = time.time()
        rate = patches_since_print / max(now - last_print_time, 1e-9)
        print(total_iter, "iterations complete")
        print("Time elapsed: {:.1f} seconds  ({:,.0f} patches/sec)"
              .format(now - start_time, rate))
        print("-----")
        last_print_time, patches_since_print = now, 0

      if total_iter in inf_schedule:
        sparsity_weight = float(inf_schedule[total_iter][
            "sparsity_weight"])
        inf_num_iters = int(inf_schedule[total_iter]["num_iters"])
      if total_iter in upd_schedule:
        upd_stepsize = float(upd_schedule[total_iter]["stepsize"])
        upd_num_iters = int(upd_schedule[total_iter]["num_iters"])

      # ---- reset / prune hook (host-side; may change shapes) ----
      if rp_schedule is not None and total_iter in rp_schedule:
        v_codes = np.concatenate([
            _numpy(infer_only(dictionary, vb, sparsity_weight,
                              inf_num_iters))
            for vb in iterate_batches(validation_image_dataset, device)],
                                 axis=0)
        dictionary, hessian, groups = reset_or_prune(
            rp_schedule[total_iter], dictionary, hessian, v_codes,
            group_assignments, uses_hessian, dp_mesh)
        if groups is not group_assignments:  # pruned: rows and groups moved
          group_assignments = groups
          step_fn = make_step()
        previous_dictionary = dictionary

      # ---- checkpointing ----
      if writer and ckpt_sched is not None and total_iter in ckpt_sched:
        save_checkpoint(logging_path, total_iter, dictionary, hessian)

      # ---- validation metrics + dictionary viz ----
      if writer and vis_sched is not None and total_iter in vis_sched:
        all_metrics = []
        for vb in iterate_batches(validation_image_dataset, device):
          v_codes = infer_only(dictionary, vb, sparsity_weight,
                               inf_num_iters)
          all_metrics.append(compute_metrics(
              vb, v_codes, dictionary, previous_dictionary, mode=mode,
              sparsity_weight=sparsity_weight,
              group_assignments=group_assignments,
              kernel_stride=kernel_stride, padding=padding,
              is_subspace=is_subspace))
        assert all_metrics, (
            "validation dataset yielded no batches (check batch size vs "
            "dataset size / drop_last)")
        averaged = {k: float(np.mean([m[k] for m in all_metrics]))
                    for k in all_metrics[0]}
        for name, value in averaged.items():
          tb_writer.add_scalar(name, value, total_iter)
        _dictionary_viz_to_tb(tb_writer, _numpy(dictionary),
                              kernel_reshaping, group_assignments,
                              total_iter)

      # ---- stepsize cache (when not computed in the step) ----
      if not in_step_stepsize and total_iter % stepsize_interval == 0:
        cached_inf_stepsize = lipschitz_ops.fista_stepsize(
            lipschitz_matrix(dictionary, inference_alg, group_assignments),
            lipschitz_method)

      previous_dictionary = dictionary
      dictionary, hessian, _ = step_fn(
          dictionary, hessian, batch, sparsity_weight, inf_num_iters,
          upd_stepsize, upd_num_iters, cached_inf_stepsize)
      patches_since_print += int(batch.shape[0]) * (
          1 if dp_mesh is None else dp_mesh.size)
      total_iter += 1
    print("Epoch", epoch_idx + 1, "finished")

  if tb_writer is not None:
    tb_writer.flush()
  return dictionary
