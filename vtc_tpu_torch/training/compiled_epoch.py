"""Whole training segments: counterpart of ``train_dictionary_scanned``
(vtc_tpu/training/compiled_epoch.py:427-1297), fully-connected (with the
subspace, group-sparse, variants) and convolutional, each also
data-parallel.

Same ``all_params`` schema and semantics as ``sparse_coding.
train_dictionary``: the epochs are split into segments at every
scheduled event (parameter change, checkpoint, visualization,
reset/prune) and at every epoch edge (:526-534), events run host-side at
the exact iteration they are scheduled for (``handle_events``
:955-1003), and each segment runs whole.  The JAX package cuts a segment
into power-of-two scans (:1092-1110) to bound its compile count; the port
compiles nothing, so it does not.

Runners, chosen per segment:

* ``_fused_segment_runner`` (:104-127): the fused train kernels
  (ops/fused_train_step, the port of K2) for the whole segment.  It runs
  on a CUDA device when the Lipschitz eigenvector is tracked warm
  ('power_warm', the default) with fc_formulation 'pallas' (the default
  on CUDA), as the JAX package runs K2 on a TPU.
* ``_fused_group_segment_runner`` (:155-173): the same for the subspace
  solvers with ``group_assignments``, through the fused group train
  kernels (ops/fused_group_train_step, the port of K6), where
  ``fused_group_segment_supported`` admits the configuration (:845-857).
* ``_segment_runner`` (:72-101): the per-step loop of the raw step, for
  CPU tensors and for the configurations the JAX package routes there;
  an explicit ``lipschitz_method`` computes the stepsize in the step, and
  on a CUDA device with 'pallas' its fc solves run K1's kernel.

The warm eigenvector, of the grouped dictionary's Gram for the subspace
solvers (``lip_matrix`` :920-930), is seeded with an exact eigenpair
(``seed_eigvec`` :932-937) and re-seeded after every dictionary jump
(:977): two power iterations per step track the stepsize only from such
a seed.  A prune remaps the groups and rebuilds the step (:978-985).
``shuffle_each_epoch`` permutes the samples on the training device with a
``torch.Generator`` seeded by 'shuffle_seed': the same property as the
JAX package's ``jax.random.permutation``, not the same order.

* ``_fused_conv_segment_runner`` (:130-152): for mode='convolutional',
  the whole segment through the fused conv train kernels
  (ops/fused_conv_train, the port of K12, with K10's solve) where
  'conv_formulation' is 'auto' or 'pallas' and
  ``fused_conv_segment_supported`` admits the geometry (:825-841).  The
  Lipschitz matrix is the flattened kernels (:922-923), and 'strides' and
  'padding' reach the raw step and the metrics (:488-490, :995-999).
* ``_code_shard_segment_runner`` (:319-392): the residual-form segment
  for dictionaries with s > n (ops/fused_code_shard_train, the port of
  K19), fc and grouped.  bench.py's big-dictionary rows call it directly
  at a code axis of 1 (bench.py:584-591), and so does chip_smoke.py; the
  trainer picks it, as vtc_tpu's does (:565-628), with a
  ``data_parallel`` mesh whose 'code' axis is above 1: the dictionary
  rows sharded over 'code', the batch over 'data', the global dictionary
  gathered on every rank after each segment.

With ``all_params['data_parallel']`` (True: the default process group's
world, or one rank without a group; or a ``parallel.Mesh``), fc, subspace
and conv (:557-814): every rank calls the trainer with the same global
batches, holds its own shard of the batch axis on the device for the whole
run (axis 1 of the (k, b, n) or (k, b, c, H, W) batches) and returns the
same dictionary.

* ``_dp_conv_segment_runner`` (:249-281): for mode='convolutional', where
  vtc_tpu picks its whole-segment conv DP kernel K17 (``dp_rdma_conv``,
  :707-720, :1160-1171): each rank runs its segment through
  ops/fused_conv_dp_train (the port of K17), one C loop per segment with
  one all-reduce of the step's statistics between its solve and its
  update.  Its gate is K13's, ``conv_solve_stats_supported`` at the
  segment's ``upd_num_iters`` (more than one update iteration takes the
  gram form, so a stride-block-uniform mask); vtc_tpu's further terms are
  VMEM budgets and its interpret-mode device count.  With
  'early_stopping_epsilon' its solves stop over the global batch, the
  share summed over the ranks once per iteration (vtc_tpu :721-746).
* ``_dp_fc_segment_runner`` (:214-246, vtc_tpu's
  ``_dp_rdma_segment_runner``) and ``_dp_group_segment_runner``
  (:284-318, ``_dp_rdma_group_segment_runner``): where vtc_tpu picks its
  whole-segment fc and subspace DP kernels K15 and K16 (``dp_rdma``,
  ``dp_rdma_group``, :645-690, :761-809), each rank runs its segment
  through ops/fused_dp_train or ops/fused_group_dp_train, one C loop per
  segment with one all-reduce of the step's packed statistics between its
  solve and its update, as K17.  Their gates are K3's and K7's (subspace:
  and a regularizer only with renormalization), on a mesh without a 'dcn'
  axis.  vtc_tpu's further terms are VMEM budgets, and its interpret-mode
  device count (the CPU interpreter's remote-DMA simulation needs a spare
  host thread), an artefact with no counterpart here.  With
  'early_stopping_epsilon' they take it too, on vtc_tpu's gates for its
  early-stopped K15 and K16 (:675-693, :786-809): every solve stops over
  the global batch, the share summed over the ranks once per iteration.
* On a mesh with a 'code' axis above 1 that the code-shard gate declines,
  the runners below run replicated over 'code' (their sums span the data
  group) and the whole-segment K15, K16 and K17 are not taken: vtc_tpu
  takes them only when every axis but 'data' has size 1 (:656-659).
* ``_dp_fused_segment_runner`` (:178-211): the fused-DP composition, per
  step one solve+stats kernel on the shard (K3, K7 with groups, K13 in
  conv mode), one all-reduce of its statistics and the replicated update,
  the warm eigenvector riding replicated: the same numbers as K15, K16
  and K17, one Python call per step.  Picked where vtc_tpu picks it (warm
  tracking, no early stop, 'pallas' (fc) or 'auto'/'pallas' (conv), the
  gates of ``fused_solve_stats_supported`` /
  ``fused_group_solve_stats_supported`` / ``conv_solve_stats_supported``)
  and the whole-segment kernels do not run: on a mesh with a 'dcn' axis,
  and for subspace a regularizer without renormalization.
* ``_dp_segment_runner`` (:395-424): the psum-per-op step
  (``parallel.build_dp_local_step``) for every other configuration, with
  the stepsize computed in the step: 'power_warm' is downgraded to 'power'
  (:810-813), and a warm run's eigenvector is re-seeded after a segment
  that took this runner (:1281-1285).  An early-stopped run that none of
  K15, K16 or K17 takes runs it too (a mesh with a 'dcn' axis, a subspace
  regularizer without renormalization), as in vtc_tpu.
* The shuffle permutes the global sample index with the seeded generator
  every rank has, before the shard is taken: a data-parallel run visits
  the samples of the single-device run.  Rank 0 writes checkpoints and
  metrics; reset/prune takes rank 0's draw on every rank.

'train_precision' ('highest', 'bf16x5', 'bf16x3', 'bf16') is the tier of
the fused runners (vtc_tpu :453-474): the single-device K2, K6 and K12,
and with 'data_parallel' the whole-segment K15 and K16 and the 'dcn'
mesh's composition of K3, K7 and K13.  Their solves run it, the Gram,
refresh, statistics and update stay fp32.  As in vtc_tpu, a configuration
that resolves to a per-step runner (the psum-per-op step among them)
keeps full precision, and so does the whole-segment conv K17, where
vtc_tpu's trainer replaces its K17 runner with the psum-per-op one
(:1160-1170, :1228-1232); on the CPU the fused runners' plain versions run a
tier where 'fc_formulation' is 'pallas' and the power is warm.  The
code-sharded runner hands it to K19, whose solve products run it as
vtc_tpu's K19 does (:1116-1133; its last branch, :1228, leaves the
code-sharded runner in place), on the card and in the plain version.

Raise NotImplementedError naming its ROADMAP.md §1 item: 'hbm_chunk_steps'
streaming (item 8).  Every segment kernel stops its solves on the
device with 'early_stopping_epsilon': the single-device K2, K6 and K12
(and K1 or K10 in the per-step route), the data-parallel K15, K16 and K17
and the code-sharded K19, the last four over the global batch.
"""
import time

import numpy as np
import torch

from vtc_tpu_torch import parallel
from vtc_tpu_torch.ops import conv_shapes, fused_code_shard_train
from vtc_tpu_torch.ops import fused_conv_dp_train, fused_conv_train
from vtc_tpu_torch.ops import fused_dp_train, fused_group_dp_train
from vtc_tpu_torch.ops import fused_group_train_step
from vtc_tpu_torch.ops import fused_train_step
from vtc_tpu_torch.ops import lipschitz as lip
from vtc_tpu_torch.ops.precision import TIERS
from vtc_tpu_torch.training import sparse_coding as sc


def _segment_runner(raw_step, upd_num_iters, warm_power, lip_matrix_fn):
  """The raw step over every batch of the segment; with ``warm_power``
  the eigenvector is refreshed by 2 power iterations per batch on the
  Gram of ``lip_matrix_fn(dictionary)`` and sets the stepsize."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    d, h, v = dictionary, hessian, eigvec
    for batch in batches:
      inf_step = None
      if warm_power:
        eigval, v = lip.power_iterate(lip_matrix_fn(d), v, num_iters=2)
        inf_step = 1.0 / eigval
      d, h, _ = raw_step(d, h, batch, sw, n_it, upd_step, upd_num_iters,
                         inf_step)
    return d, h, v

  return run


def _fused_segment_runner(variant, update_alg, upd_niters, nonneg, hard,
                          renormalize, early_eps=None, mxu="highest"):
  """The whole segment through the fused train kernels, warm tracking
  at power_iters=2 (safe: the trainer seeds the eigenvector exactly);
  ``early_eps`` stops each step's solve on the device; ``mxu`` is the
  training tier (vtc_tpu :1259-1262)."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    dictionary, hessian, eigvec, _ = fused_train_step.fused_train_segment(
        dictionary, hessian, eigvec, batches, sw, n_it, upd_step,
        variant=variant, update_alg=update_alg, upd_num_iters=upd_niters,
        nonneg=nonneg, hard=hard, renormalize=renormalize, power_iters=2,
        early_stopping_epsilon=early_eps, mxu=mxu)
    return dictionary, hessian, eigvec

  return run


def _fused_group_segment_runner(variant, update_alg, upd_niters, hard,
                                renormalize, group_assignments,
                                alignment_penalty, early_eps=None,
                                mxu="highest"):
  """The subspace counterpart of ``_fused_segment_runner``: the whole
  segment through the fused group train kernels (the anti-alignment
  regularizer runs in them too), warm tracking at power_iters=2, at the
  training tier ``mxu`` (vtc_tpu :1243-1252)."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    dictionary, hessian, eigvec, _ = (
        fused_group_train_step.fused_group_train_segment(
            dictionary, hessian, eigvec, batches, sw, n_it, upd_step,
            group_assignments=group_assignments, variant=variant,
            update_alg=update_alg, upd_num_iters=upd_niters, hard=hard,
            renormalize=renormalize, power_iters=2,
            alignment_penalty=alignment_penalty,
            early_stopping_epsilon=early_eps, mxu=mxu))
    return dictionary, hessian, eigvec

  return run


def _fused_conv_segment_runner(variant, update_alg, upd_niters, nonneg,
                               hard, renormalize, kernel_stride, padding,
                               early_eps=None, mxu="highest"):
  """The conv counterpart of ``_fused_segment_runner``: the whole segment
  through the fused conv train kernels in stride-block space, warm
  tracking at power_iters=2; ``early_eps`` each solve's batch-global stop
  test, in the kernels (vtc_tpu :835-841); ``mxu`` the solves' tier
  (vtc_tpu :1235-1243)."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    dictionary, hessian, eigvec, _ = fused_conv_train.fused_conv_train_segment(
        dictionary, hessian, eigvec, batches, sw, n_it, upd_step,
        kernel_stride=kernel_stride, padding=padding, variant=variant,
        update_alg=update_alg, upd_num_iters=upd_niters, nonneg=nonneg,
        hard=hard, renormalize=renormalize, power_iters=2,
        early_stopping_epsilon=early_eps, mxu=mxu)
    return dictionary, hessian, eigvec

  return run


def _code_shard_segment_runner(mesh, cs_size, data_size, variant,
                               update_alg, upd_niters, nonneg, hard,
                               renormalize, group_arrays=None,
                               alignment_penalty=0.0, mxu="highest",
                               early_eps=None, stop_count=None):
  """The residual-form segment for big dictionaries: the whole segment
  through the residual-form train kernels (ops/fused_code_shard_train,
  the port of K19), warm tracking of the n x n Gram's eigenvector at
  power_iters=2, dictionary rows sharded over the mesh's 'code' axis and
  the batch over its 'data' axis (vtc_tpu :319-392).

  ``mesh``: the ``parallel.Mesh`` (None: a mesh of one rank), whose
  'code' and data-axes sizes ``cs_size`` and ``data_size`` must be.  The
  runner takes the replicated dictionary, Hessian and eigenvector and this
  rank's batch shards (k, b_l, n), as the data-parallel runners do: it
  takes its rows on entry and all-gathers them over 'code' at the end, so
  every rank returns the same global state.  ``group_arrays`` (from
  code_shard_group_arrays with ``cs_size`` shards) selects the grouped
  variant; the rank takes the arrays of its code position (:361-370), and
  vtc_tpu's rotate window of all of them (roll_window_from_expand_arrays,
  :350-353), which picks the group prox's rounding at a tier.  ``mxu`` is
  K19's tier."""
  if mesh is None:
    mesh = parallel.Mesh(1)
  if (int(cs_size), int(data_size)) != (mesh.code_size, mesh.size):
    raise ValueError(
        "the code-sharded runner at cs_size=%d, data_size=%d needs a mesh of "
        "those sizes, got %r" % (cs_size, data_size, mesh))
  kw = {}
  if group_arrays is not None:
    kw["expand_local"] = group_arrays[0][mesh.code_index]
    kw["roll_window"] = fused_code_shard_train.roll_window_from_expand_arrays(
        group_arrays[0])
    if alignment_penalty != 0.0:
      kw["comem_local"] = group_arrays[1][mesh.code_index]
    kw["alignment_penalty"] = alignment_penalty

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    d_shard, h_shard, eigvec, _ = (
        fused_code_shard_train.fused_code_sharded_train_segment(
            mesh.code_shard(dictionary), mesh.code_shard(hessian), eigvec,
            batches, sw, n_it, upd_step, axis_size=cs_size,
            data_axis_size=data_size, data_stride=cs_size if data_size > 1
            else 0, mesh=mesh, variant=variant, update_alg=update_alg,
            upd_num_iters=upd_niters, nonneg=nonneg, hard=hard,
            renormalize=renormalize, power_iters=2, mxu=mxu,
            early_stopping_epsilon=early_eps, stop_count=stop_count, **kw))
    return (mesh.all_gather_code(d_shard), mesh.all_gather_code(h_shard),
            eigvec)

  return run


def _dp_conv_segment_runner(mesh, variant, update_alg, upd_niters, nonneg,
                            hard, renormalize, kernel_stride, padding,
                            early_eps=None, mxu="highest"):
  """vtc_tpu's ``_dp_rdma_conv_segment_runner``: this rank's shards of the
  whole segment through the data-parallel conv segment kernels (K17), the
  statistics summed over ``mesh`` once per step, warm tracking at
  power_iters=2; ``early_eps`` each solve's stop test over the global
  batch, its share summed over ``mesh`` once per iteration; ``mxu`` the
  solves' tier (vtc_tpu :1160-1162)."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    dictionary, hessian, eigvec, _ = (
        fused_conv_dp_train.fused_conv_dp_train_segment(
            dictionary, hessian, eigvec, batches, sw, n_it, upd_step,
            mesh=mesh, kernel_stride=kernel_stride, padding=padding,
            variant=variant, update_alg=update_alg, upd_num_iters=upd_niters,
            nonneg=nonneg, hard=hard, renormalize=renormalize,
            power_iters=2, early_stopping_epsilon=early_eps, mxu=mxu))
    return dictionary, hessian, eigvec

  return run


def _dp_fc_segment_runner(mesh, variant, update_alg, upd_niters, nonneg,
                          hard, renormalize, early_eps=None, mxu="highest"):
  """vtc_tpu's ``_dp_rdma_segment_runner``: this rank's shards of the whole
  segment through the data-parallel fc segment kernels (K15), the
  statistics summed over ``mesh`` once per step, warm tracking at
  power_iters=2; ``early_eps`` each solve's stop test over the global
  batch, its share summed over ``mesh`` once per iteration; ``mxu`` the
  solves' tier."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    dictionary, hessian, eigvec, _ = fused_dp_train.fused_dp_train_segment(
        dictionary, hessian, eigvec, batches, sw, n_it, upd_step, mesh=mesh,
        variant=variant, update_alg=update_alg, upd_num_iters=upd_niters,
        nonneg=nonneg, hard=hard, renormalize=renormalize, power_iters=2,
        mxu=mxu, early_stopping_epsilon=early_eps)
    return dictionary, hessian, eigvec

  return run


def _dp_group_segment_runner(mesh, variant, update_alg, upd_niters, hard,
                             renormalize, group_assignments,
                             alignment_penalty, early_eps=None,
                             mxu="highest"):
  """vtc_tpu's ``_dp_rdma_group_segment_runner``: the subspace counterpart
  of ``_dp_fc_segment_runner`` (K16), the anti-alignment regularizer on the
  replicated dictionary inside; ``early_eps`` each group solve's stop test
  over the global batch; ``mxu`` the group solves' tier."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    dictionary, hessian, eigvec, _ = (
        fused_group_dp_train.fused_group_dp_train_segment(
            dictionary, hessian, eigvec, batches, sw, n_it, upd_step,
            group_assignments=group_assignments, mesh=mesh, variant=variant,
            update_alg=update_alg, upd_num_iters=upd_niters, hard=hard,
            renormalize=renormalize, power_iters=2,
            alignment_penalty=alignment_penalty, mxu=mxu,
            early_stopping_epsilon=early_eps))
    return dictionary, hessian, eigvec

  return run


def _dp_fused_segment_runner(local_step):
  """The fused-DP composition over this rank's shards of a segment:
  ``local_step`` (``parallel.build_dp_fused_local_step`` or its group
  counterpart) per batch, the warm eigenvector riding from step to step."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    d, h, v = dictionary, hessian, eigvec
    for batch_shard in batches:
      d, h, v, _ = local_step(d, h, v, batch_shard, sw, n_it, upd_step)
    return d, h, v

  return run


def _dp_segment_runner(local_step):
  """The psum-per-op data-parallel step (``parallel.build_dp_local_step``)
  over this rank's shards of a segment; the eigenvector passes through
  untouched, for one signature with the other runners.  It runs full
  precision whatever ``train_precision`` says, as vtc_tpu's XLA step does
  (vtc_tpu/training/compiled_epoch.py:466-468)."""

  def run(dictionary, hessian, eigvec, batches, sw, n_it, upd_step):
    d, h = dictionary, hessian
    for batch_shard in batches:
      d, h, _ = local_step(d, h, batch_shard, sw, n_it, upd_step)
    return d, h, eigvec

  return run


def train_dictionary_scanned(training_batches, validation_batches,
                             init_dictionary, all_params, *, device=None):
  """Train with whole segments.  ``training_batches``: a (k, b, n) array
  or tensor; each epoch runs over axis 0.  The training device is
  ``device``, else that of ``training_batches`` or ``init_dictionary``
  when it is a tensor, else the CUDA device (raising without one); the
  batches are moved there once.
  Returns the final dictionary, a float32 tensor on that device.

  'fc_formulation' defaults to 'pallas' on a CUDA device and 'gram' on
  the CPU, as the JAX package defaults by backend (:554-556).
  """
  assert 0 in all_params["inference_param_schedule"]
  assert 0 in all_params["dict_update_param_schedule"]
  mode = all_params["mode"]
  num_epochs = all_params["num_epochs"]
  inference_alg = all_params["code_inference_algorithm"]
  update_alg = all_params["dictionary_update_algorithm"]
  inf_sched = all_params["inference_param_schedule"]
  upd_sched = all_params["dict_update_param_schedule"]
  kernel_stride = padding = None
  if mode == "convolutional":
    kernel_stride = tuple(int(x) for x in all_params["strides"])
    padding = conv_shapes.normalize_padding(all_params.get("padding"))
  conv_formulation = all_params.get("conv_formulation", "auto")
  group_assignments = sc.normalize_groups(
      all_params.get("group_assignments"))
  sc.check_supported(mode, inference_alg, update_alg, group_assignments)
  train_precision = all_params.get("train_precision", "highest")
  if train_precision not in TIERS:
    raise ValueError("train_precision must be one of %s, got %r"
                     % (TIERS, train_precision))
  if all_params.get("hbm_chunk_steps") is not None:
    raise NotImplementedError(
        "hbm_chunk_steps (streaming an epoch larger than device memory) "
        "waits, ROADMAP.md §1 item 8")
  ckpt_sched = all_params.get("checkpoint_schedule") or set()
  vis_sched = all_params.get("training_visualization_schedule") or set()
  rp_sched = all_params.get("dict_element_rp_schedule") or {}
  nonneg = bool(all_params.get("nonnegative_only", False))
  hard = bool(all_params.get("hard_threshold", False))
  renormalize = bool(all_params.get("renormalize_dictionary", True))
  alignment_penalty = float(
      all_params.get("subspace_alignment_penalty", 0.0))
  is_subspace = inference_alg.startswith("subspace")
  data_parallel = all_params.get("data_parallel", False)
  dp_mesh = parallel.resolve_mesh(data_parallel) if data_parallel else None
  writer = dp_mesh is None or dp_mesh.rank == 0
  logging_path, tb_writer = sc.open_logging(all_params, group_assignments,
                                            writer)

  device = sc.resolve_device(device, training_batches, init_dictionary)
  k, b_per = training_batches.shape[0], training_batches.shape[1]
  global_batches = None
  if dp_mesh is not None and dp_mesh.size > 1:
    # the global batches stay where the caller has them; this rank's shard
    # of the batch axis goes to the device
    global_batches = training_batches
    shard_lo, shard_hi = dp_mesh.shard_bounds(b_per)
    training_batches = training_batches[:, shard_lo:shard_hi]
  training_batches = sc.as_tensor(training_batches, device)
  total_iters = num_epochs * k
  shuffle_each_epoch = bool(all_params.get("shuffle_each_epoch", False))
  shuffle_gen = torch.Generator().manual_seed(
      int(all_params.get("shuffle_seed", 0)))

  # iteration indices at which Python acts, and the epoch edges
  boundaries = sorted(
      {0, total_iters}
      | set(inf_sched) | set(upd_sched) | set(ckpt_sched)
      | set(vis_sched) | set(rp_sched)
      | {e * k for e in range(num_epochs + 1)})
  boundaries = [x for x in boundaries if 0 <= x <= total_iters]

  # 'power_warm' (default): the eigenvector rides from step to step; any
  # explicit lipschitz_method computes the stepsize in every step
  lipschitz_method = all_params.get("lipschitz_method", "power_warm")
  warm_power = lipschitz_method == "power_warm"
  early_eps = all_params.get("early_stopping_epsilon")
  if early_eps is not None:
    early_eps = float(early_eps)
  resolved_formulation = all_params.get(
      "fc_formulation", "pallas" if device.type == "cuda" else "gram")
  kernels_route = (conv_formulation in ("auto", "pallas")
                   if mode == "convolutional"
                   else resolved_formulation == "pallas")
  # the tier runs in the fused segment runners (K2, K6, K12), as vtc_tpu's
  # runs in its fused kernels only; on the CPU their plain versions take
  # a tier where a card would run the kernels
  use_fused = ((device.type == "cuda" or train_precision != "highest")
               and warm_power and kernels_route)
  def code_shard_plan(s_now):
    """(whether the code-sharded runner takes the configuration at s_now
    rows, its group arrays) -- vtc_tpu :588-628."""
    cs = dp_mesh.code_size
    arrays = None
    if group_assignments is None:
      ok = (inference_alg in ("ista", "fista")
            and update_alg in fused_train_step.UPDATE_ALGS)
    else:
      ok = (inference_alg in fused_group_train_step.INFERENCE_ALGS
            and update_alg in fused_group_train_step.UPDATE_ALGS
            and not nonneg and (alignment_penalty == 0.0 or renormalize))
      if ok:
        arrays = fused_code_shard_train.code_shard_group_arrays(
            group_assignments, s_now, cs)
        ok = arrays is not None
    return ok and fused_code_shard_train.code_shard_segment_supported(
        b_per // dp_mesh.size, s_now // cs, training_batches.shape[-1], cs,
        dp_mesh.size), arrays

  # the code-sharded route on a mesh with a 'code' axis above 1: vtc_tpu's
  # cs_common (:565-628) without its TPU-only interpret term (:600-602)
  code_sharded = (
      dp_mesh is not None and dp_mesh.code_size > 1
      and mode == "fully-connected" and "dcn" not in dp_mesh.axis_names
      and warm_power and resolved_formulation == "pallas"
      and init_dictionary.shape[0] % dp_mesh.code_size == 0
      and init_dictionary.shape[0] > training_batches.shape[-1]
      and b_per % dp_mesh.size == 0
      and code_shard_plan(init_dictionary.shape[0])[0])
  # data parallel: the fused-DP composition where a solve+stats kernel
  # takes the configuration (vtc_tpu :629-809 without its TPU-only terms),
  # else the psum-per-op step with the stepsize computed in the step; with
  # an early stop only the whole-segment K15, K16 and K17, whose solves
  # stop over the global batch (vtc_tpu :675-693, :721-746, :786-809:
  # every axis other than 'data' of size 1, and for subspace a regularizer
  # only with renormalization)
  dp_fused = False
  if dp_mesh is not None:
    whole_mesh = all(dp_mesh.shape[a] == 1 for a in dp_mesh.axis_names
                     if a != "data")
    dp_fused = warm_power and kernels_route and (
        early_eps is None or (whole_mesh and (
            group_assignments is None or alignment_penalty == 0.0
            or renormalize)))
    if not dp_fused and not code_sharded and warm_power:
      lipschitz_method, warm_power = "power", False

  def dp_fused_now():
    """Whether this segment's configuration runs a solve+stats kernel."""
    if not dp_fused:
      return False
    shard_b, s_now = training_batches.shape[1], dictionary.shape[0]
    n_in = training_batches.shape[-1]
    if mode == "convolutional":
      # vtc_tpu's terms (:695-702, :1172-1179): the gram form at more than
      # one update iteration
      return fused_conv_train.conv_solve_stats_supported(
          tuple(training_batches.shape[1:]), dictionary.shape, kernel_stride,
          inference_alg, update_alg, upd_num_iters=upd_niters,
          padding=padding)
    if group_assignments is None:
      return (inference_alg in ("ista", "fista")
              and update_alg in fused_train_step.UPDATE_ALGS
              and fused_train_step.fused_solve_stats_supported(
                  shard_b, s_now, n_in))
    return (inference_alg in fused_group_train_step.INFERENCE_ALGS
            and update_alg in fused_group_train_step.UPDATE_ALGS
            and not nonneg
            and fused_group_train_step.fused_group_solve_stats_supported(
                shard_b, s_now, n_in, group_assignments))

  def make_dp_runner():
    """(runner, whether it tracks the warm eigenvector)."""
    if code_sharded:
      ok, arrays = code_shard_plan(dictionary.shape[0])
      if not ok:
        raise ValueError("the dictionary or its groups left the code-sharded "
                         "runner's gate during training (a reset/prune)")
      # vtc_tpu's stop count (:1116-1123): the global batch times the
      # grouped codes' G * M, or the rows
      stop_count = b_per * (dictionary.shape[0] if group_assignments is None
                            else len(group_assignments)
                            * max(len(g) for g in group_assignments))
      return _code_shard_segment_runner(
          dp_mesh, dp_mesh.code_size, dp_mesh.size,
          (inference_alg[9:] if group_assignments is not None
           else inference_alg), update_alg, upd_niters, nonneg, hard,
          renormalize, group_arrays=arrays,
          alignment_penalty=alignment_penalty, mxu=train_precision,
          early_eps=early_eps, stop_count=stop_count), True
    if dp_fused_now():
      # the whole-segment kernels where vtc_tpu takes them (:656-659): every
      # axis other than 'data' of size 1 (no 'dcn' axis, 'code' 1)
      if whole_mesh and mode == "convolutional":
        # K17 at full precision whatever the tier, as vtc_tpu's trainer
        # runs: it builds its K17 runner at the tier and then replaces it
        # with the psum-per-op runner, whose step keeps full precision
        # (vtc_tpu/training/compiled_epoch.py:1160-1170, :1228-1232)
        return _dp_conv_segment_runner(
            dp_mesh, inference_alg, update_alg, upd_niters, nonneg, hard,
            renormalize, kernel_stride, padding, early_eps,
            mxu="highest"), True
      if whole_mesh and group_assignments is None:
        return _dp_fc_segment_runner(
            dp_mesh, inference_alg, update_alg, upd_niters, nonneg, hard,
            renormalize, early_eps, mxu=train_precision), True
      if whole_mesh and fused_group_dp_train.fused_group_dp_segment_supported(
          training_batches.shape[1], dictionary.shape[0],
          training_batches.shape[-1], group_assignments,
          alignment_penalty=alignment_penalty, renormalize=renormalize):
        return _dp_group_segment_runner(
            dp_mesh, inference_alg[9:], update_alg, upd_niters, hard,
            renormalize, group_assignments, alignment_penalty,
            early_eps, mxu=train_precision), True
      common = dict(hard_threshold=hard, renormalize=renormalize,
                    upd_num_iters=upd_niters, power_iters=2,
                    mxu=train_precision)
      if mode == "convolutional":
        local = parallel.build_dp_conv_fused_local_step(
            dp_mesh, inference_alg, update_alg, kernel_stride=kernel_stride,
            padding=padding, nonneg=nonneg, **common)
      elif group_assignments is None:
        local = parallel.build_dp_fused_local_step(
            dp_mesh, inference_alg, update_alg, nonneg=nonneg, **common)
      else:
        local = parallel.build_dp_group_fused_local_step(
            dp_mesh, inference_alg, update_alg,
            group_assignments=group_assignments,
            alignment_penalty=alignment_penalty, **common)
      return _dp_fused_segment_runner(local), True
    local = parallel.build_dp_local_step(
        dp_mesh, mode, inference_alg, update_alg, nonneg=nonneg,
        hard_threshold=hard, kernel_stride=kernel_stride, padding=padding,
        group_assignments=group_assignments,
        alignment_penalty=alignment_penalty, renormalize=renormalize,
        fc_formulation=all_params.get("fc_formulation", "gram"),
        early_stopping_epsilon=early_eps,
        lipschitz_method=("power" if lipschitz_method == "power_warm"
                          else lipschitz_method),
        upd_num_iters=upd_niters)
    return _dp_segment_runner(local), False

  def make_step():
    return sc.build_raw_step_fn(
        mode, inference_alg, update_alg, nonneg=nonneg,
        hard_threshold=hard, kernel_stride=kernel_stride, padding=padding,
        group_assignments=group_assignments,
        alignment_penalty=alignment_penalty, renormalize=renormalize,
        fc_formulation=resolved_formulation,
        conv_formulation=conv_formulation,
        lipschitz_method="power" if warm_power else lipschitz_method,
        compute_stepsize_in_step=not warm_power,
        early_stopping_epsilon=early_eps)

  def lip_matrix(d):
    return sc.lipschitz_matrix(d, inference_alg, group_assignments)

  def make_runner():
    if mode == "convolutional":
      if use_fused and fused_conv_train.fused_conv_segment_supported(
          training_batches.shape[1:], dictionary.shape, kernel_stride,
          inference_alg, update_alg, group_assignments=group_assignments,
          upd_num_iters=upd_niters, padding=padding):
        return _fused_conv_segment_runner(inference_alg, update_alg,
                                          upd_niters, nonneg, hard,
                                          renormalize, kernel_stride,
                                          padding, early_eps,
                                          mxu=train_precision)
      return _segment_runner(raw_step, upd_niters, warm_power, lip_matrix)
    if use_fused and group_assignments is None:
      return _fused_segment_runner(inference_alg, update_alg, upd_niters,
                                   nonneg, hard, renormalize, early_eps,
                                   mxu=train_precision)
    if use_fused and fused_group_train_step.fused_group_segment_supported(
        inference_alg, update_alg, group_assignments,
        alignment_penalty=alignment_penalty,
        batch_size=training_batches.shape[1],
        code_size=dictionary.shape[0],
        input_size=training_batches.shape[-1], renormalize=renormalize):
      return _fused_group_segment_runner(
          inference_alg[9:], update_alg, upd_niters, hard, renormalize,
          group_assignments, alignment_penalty, early_eps,
          mxu=train_precision)
    return _segment_runner(raw_step, upd_niters, warm_power, lip_matrix)

  raw_step = make_step()

  dictionary = sc.as_tensor(init_dictionary, device)
  hessian = torch.zeros(dictionary.shape[0], dtype=torch.float32,
                        device=device)
  previous_dictionary = dictionary
  sw = n_it = upd_step = upd_niters = None
  eigvec = None  # warm Lipschitz eigenvector (seeded lazily)
  start = time.time()

  def seed_eigvec(d):
    # exact eigenpair seed: no cold-start transient
    return lip.top_gram_eigenpair(lip_matrix(d))[1].contiguous()

  def _infer(batch):
    # host-boundary inference (validation / reset-prune): cold stepsize
    inf_step = (lip.fista_stepsize(lip_matrix(dictionary), "power")
                if warm_power else None)
    _, _, codes = raw_step(dictionary, hessian, sc.as_tensor(batch, device),
                           sw, n_it, 0.0, 1, inf_step)
    return codes

  def handle_events(it):
    nonlocal dictionary, hessian, previous_dictionary, eigvec
    nonlocal sw, n_it, upd_step, upd_niters, group_assignments, raw_step
    if it in inf_sched:
      sw = float(inf_sched[it]["sparsity_weight"])
      n_it = int(inf_sched[it]["num_iters"])
    if it in upd_sched:
      upd_step = float(upd_sched[it]["stepsize"])
      upd_niters = int(upd_sched[it]["num_iters"])
    if it in rp_sched:
      v_codes = np.concatenate([
          sc._numpy(_infer(vb)) for vb in validation_batches], axis=0)
      dictionary, hessian, groups = sc.reset_or_prune(
          rp_sched[it], dictionary, hessian, v_codes, group_assignments,
          True, dp_mesh)
      eigvec = None  # the dictionary jumped: re-seed the eigenvector
      if groups is not group_assignments:  # pruned: rows and groups moved
        group_assignments = groups
        raw_step = make_step()
      previous_dictionary = dictionary
    if writer and it in ckpt_sched:
      sc.save_checkpoint(logging_path, it, dictionary, hessian)
    if writer and it in vis_sched:
      metrics = [sc.compute_metrics(
          vb, _infer(vb), dictionary, previous_dictionary, mode=mode,
          sparsity_weight=sw, group_assignments=group_assignments,
          kernel_stride=kernel_stride, padding=padding,
          is_subspace=is_subspace) for vb in validation_batches]
      for name in metrics[0]:
        tb_writer.add_scalar(
            name, float(np.mean([m[name] for m in metrics])), it)

  order = None  # the global sample order of a sharded, shuffled run
  for seg_start, seg_end in zip(boundaries[:-1], boundaries[1:]):
    handle_events(seg_start)
    if shuffle_each_epoch and seg_start % k == 0 and seg_start < total_iters:
      perm = torch.randperm(k * b_per, generator=shuffle_gen)
      if global_batches is None:
        flat = training_batches.reshape((k * b_per,)
                                        + training_batches.shape[2:])
        training_batches = flat[perm.to(device)].reshape(
            training_batches.shape)
      else:
        # permute the global sample index as the single-device run permutes
        # its samples (each epoch's permutation composed with the last),
        # then take this rank's shard of every batch
        order = perm if order is None else order[perm]
        mine = order.reshape(k, b_per)[:, shard_lo:shard_hi].reshape(-1)
        flat = global_batches.reshape((k * b_per,) + global_batches.shape[2:])
        if isinstance(flat, torch.Tensor):
          mine = mine.to(flat.device)
        else:
          mine = mine.numpy()
        training_batches = sc.as_tensor(flat[mine], device).reshape(
            training_batches.shape)
    if seg_end == seg_start:
      continue
    epoch = seg_start // k
    lo, hi = seg_start - epoch * k, seg_end - epoch * k
    assert 0 <= lo < hi <= k, "segments never straddle epochs"
    previous_dictionary = dictionary
    if eigvec is None:
      eigvec = (seed_eigvec(dictionary) if warm_power
                else torch.zeros(1, device=device))
    runner, tracks_eigvec = (make_dp_runner() if dp_mesh is not None
                             else (make_runner(), True))
    dictionary, hessian, eigvec = runner(
        dictionary, hessian, eigvec, training_batches[lo:hi], sw, n_it,
        upd_step)
    if warm_power and not tracks_eigvec:
      # this segment trained the dictionary without refreshing the warm
      # eigenvector: re-seed it exactly before the next fused segment,
      # whose two power iterations assume an exact seed
      eigvec = None
  handle_events(total_iters)  # trailing checkpoint / vis events
  if tb_writer is not None:
    tb_writer.flush()
  print("scanned training done in {:.2f}s ({} iterations)".format(
      time.time() - start, total_iters))
  return dictionary
