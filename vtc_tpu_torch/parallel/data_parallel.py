"""Data-parallel train steps on ``torch.distributed``: counterpart of
vtc_tpu/parallel/data_parallel.py, fully-connected, subspace and
convolutional.

The batch is sharded over the mesh's data axes, the dictionary, the
Hessian EMA and the warm eigenvector are replicated, and what a step
needs of the other shards is summed over the ranks between launches, where
vtc_tpu ``psum``s inside a ``shard_map``.  Each ``build_*`` function takes
the port's ``parallel.Mesh`` where vtc_tpu's takes the data-axis size and
the axis names: the mesh is where the size and the collectives come from.
On a mesh of one rank no collective is issued.

* ``build_dp_local_step`` (:82-224): the psum-per-op step.  The solve runs
  vtc_tpu's ``_solve`` on the shard (fc: 'gram', else the two-product
  iteration; conv: the 'gram' loop of
  ``convolutional/ista_fista._solve``), with ``early_stopping_epsilon``
  the batch-global stop test (one scalar all-reduce per iteration: all
  ranks leave at the same iteration).  fc sums the gradient codes^T
  (codes D - X) per update iteration and the Hessian statistic once;
  conv sums the shard's kernel gradient times its batch per update
  iteration (code-space autocorrelation statistics where
  ``conv_dict_gram.supported``, else the image-space gradient) and applies
  the single-device epilogue to the global gradient: the Hessian scaling,
  the Frobenius rescale (no floor, as vtc_tpu) and the per-kernel renorm.
  vtc_tpu runs this through XLA outside any Pallas kernel, so it is plain
  torch ops here.
* ``build_dp_fused_local_step`` (:227-283): the fused-DP composition.  One
  solve+stats kernel per shard per step (K3,
  ``ops/fused_train_step.fused_solve_stats``), one all-reduce of (C, B,
  stat), and the replicated update from the global statistics:
  grad at D' = (sum C @ D' - sum B) / global_b, the single-device update
  for any number of update iterations.
* ``build_dp_group_fused_local_step`` (:286-355): the same for the
  subspace family (K7, ``ops/fused_group_train_step.
  fused_group_solve_stats``); the anti-alignment regularizer depends on
  the replicated dictionary alone and runs after the reduction.
* ``build_dp_conv_fused_local_step`` (:358-452): the conv family (K13,
  ``ops/fused_conv_train.conv_solve_stats``), one all-reduce of
  (grad_sum, stat) per step, or with ``upd_num_iters`` > 1 of the gram-form
  (bx, cm, stat), from which every update iteration's gradient is
  unpack((pack(D') @ cm - bx) / global_b).  Its epilogue floors the
  gradient norm at 1e-30, as vtc_tpu's does.  The scanned trainer runs
  it on a mesh with a 'dcn' axis; elsewhere it takes the whole-segment
  kernel K17 (``ops/fused_conv_dp_train``), whose plain version is this
  step's composition (``conv_replicated_update``).
* ``build_shard_map_train_step`` (:455-486; the name stays so a reader
  finds it): the global-batch step of the per-batch trainer.  It takes
  this rank's shard of the batch (2-D patches or 4-D images), runs
  ``build_dp_local_step``'s step and gathers the codes, so every rank
  returns what vtc_tpu's caller sees.

The replicated updates are XLA outside any Pallas kernel in vtc_tpu
(:266-280, :334-352, :425-449) and plain torch ops under the precision pins
here.

On a mesh with a 'code' axis above 1 every step here runs as it does
without one: the batch is sharded over the data axes and the ranks along
'code' compute the same thing (vtc_tpu's ``shard_map`` with the
dictionary replicated over 'code', ``dp_axes``).

* ``build_pjit_train_step`` (:44-79): vtc_tpu's GSPMD step, in which XLA
  places the collectives and whose results do not depend on
  ``shard_code_axis``.  GSPMD has no torch counterpart, and the contract
  here is global arrays in and replicated results out, so rows kept
  sharded inside the step would save no memory on any rank: it is
  ``build_shard_map_train_step``, replicated over 'code', for every
  ``shard_code_axis``.
"""
import torch

from vtc_tpu_torch.analysis_transforms.convolutional import (
    ista_fista as conv_ista_fista)
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista)
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_steepest_descent as conv_sd)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_steepest_descent as fc_sd)
from vtc_tpu_torch.dict_update_rules.fully_connected._subspace_common import (
    alignment_regularization_gradients)
from vtc_tpu_torch.ops import conv_dict_gram, conv_shapes, fused_conv_direct
from vtc_tpu_torch.ops import fused_conv_train, fused_group_train_step
from vtc_tpu_torch.ops import fused_train_step
from vtc_tpu_torch.ops import convolutions as conv_ops
from vtc_tpu_torch.ops import lipschitz as lipschitz_ops
from vtc_tpu_torch.ops.precision import matmul_precision

CHEAP_QUAD_ALGS = ("sc_cheap_quadratic_descent",
                   "subspace_sc_cheap_quadratic_descent")


def build_pjit_train_step(mesh, mode, inference_alg, update_alg, *,
                          upd_num_iters=1, shard_code_axis=False, **config):
  """vtc_tpu's GSPMD-sharded step: the batch over the data axes, the
  dictionary rows over 'code' with ``shard_code_axis``.  Signature:
    step(dictionary, hessian, batch, sparsity_weight, inf_num_iters,
         upd_stepsize) -> (new_dictionary, new_hessian, codes)
  on the global arrays, the same on every rank; the results are
  replicated (the codes gathered, (b, s)) and are the single-device raw
  step's.  ``shard_code_axis`` is taken for vtc_tpu's signature and has no
  effect on the results: the step is ``build_shard_map_train_step``,
  replicated over 'code'."""
  del shard_code_axis
  return build_shard_map_train_step(
      mesh, mode, inference_alg, update_alg, upd_num_iters=upd_num_iters,
      **config)


def _replicated_update(dictionary, hessian, stat, upd_stepsize,
                       upd_num_iters, global_b, uses_hessian, renormalize,
                       lowest_code_val, grad_fn, reg_fn=None,
                       norm_floor=False):
  """The Hessian EMA from the reduced statistic and ``upd_num_iters``
  update iterations on the replicated dictionary; ``grad_fn(d)`` is the
  reduced gradient sum at d, ``reg_fn(d)`` the regularizer's gradient.
  ``norm_floor`` floors the row norms at 1e-30, as the whole-segment
  kernels do (pallas_dp_train.py:301); vtc_tpu's per-op steps do not."""
  with matmul_precision():
    if uses_hessian:
      hessian = 0.99 * hessian + (stat / global_b) / 100.0
      scale = (hessian + lowest_code_val)[:, None]
    d = dictionary
    for _ in range(int(upd_num_iters)):
      grad = grad_fn(d) / global_b
      if reg_fn is not None:
        grad = grad + reg_fn(d)
      if uses_hessian:
        grad = grad / scale
      d = d - upd_stepsize * grad
      if renormalize:
        d = fc_sd.renormalize_rows(d, norm_floor)
  return d, hessian


def _replicated_conv_update(dictionary, hessian, stat, upd_stepsize,
                            upd_num_iters, global_b, uses_hessian,
                            renormalize, lowest_code_val, grad_fn,
                            norm_floor):
  """The conv counterpart of ``_replicated_update``, in vtc_tpu's order
  (dict_update_rules/convolutional/*._update): the Hessian scaling, then
  the rescale of the gradient to the dictionary's Frobenius norm (its norm
  floored at 1e-30 with ``norm_floor``, the fused form's), the step and the
  per-kernel renorm (each kernel's squared norm floored at 1e-30 with
  ``norm_floor``, as K17 does at pallas_conv_dp_train.py:291).  ``grad_fn(d)`` is the reduced, batch-averaged kernel
  gradient at d."""
  with matmul_precision():
    if uses_hessian:
      hessian = 0.99 * hessian + (stat / global_b) / 100.0
      scale = (hessian + lowest_code_val)[:, None, None, None]
    d = dictionary
    for _ in range(int(upd_num_iters)):
      grad = grad_fn(d)
      if uses_hessian:
        grad = grad / scale
      grad = conv_sd.rescale_gradient(grad, d, norm_floor)
      d = d - upd_stepsize * grad
      if renormalize:
        d = conv_sd.renormalize_kernels(d, norm_floor)
  return d, hessian


def build_dp_local_step(mesh, mode, inference_alg, update_alg, *,
                        nonneg=False, hard_threshold=False,
                        kernel_stride=None, padding=None,
                        group_assignments=None, alignment_penalty=0.0,
                        renormalize=True, fc_formulation="gram",
                        lipschitz_method="eigvalsh", upd_num_iters=1,
                        lowest_code_val=0.001, early_stopping_epsilon=None):
  """This rank's body of the psum-per-op data-parallel step.

  Signature: local_step(dictionary, hessian, batch_shard, sw,
  inf_num_iters, upd_stepsize) -> (new_dictionary, new_hessian, codes),
  codes being the shard's.  Every rank of ``mesh`` must call it in step:
  it sums the dictionary gradient per update iteration, the Hessian
  statistic once and, with ``early_stopping_epsilon``, the stop test's
  scalar per solver iteration over the mesh.  Conv mode needs
  ``kernel_stride`` and takes ``padding``.
  """
  if mode == "convolutional":
    return _build_dp_conv_local_step(
        mesh, inference_alg, update_alg, nonneg=nonneg,
        hard_threshold=hard_threshold, kernel_stride=kernel_stride,
        padding=padding, renormalize=renormalize,
        lipschitz_method=lipschitz_method, upd_num_iters=upd_num_iters,
        lowest_code_val=lowest_code_val,
        early_stopping_epsilon=early_stopping_epsilon)
  if mode != "fully-connected":
    raise ValueError("unknown mode %r" % (mode,))
  is_subspace_inf = inference_alg.startswith("subspace")
  is_subspace_upd = update_alg.startswith("subspace")
  variant = inference_alg[9:] if is_subspace_inf else inference_alg
  uses_hessian = update_alg in CHEAP_QUAD_ALGS
  stop_axes = mesh if early_stopping_epsilon is not None else None
  early_eps = (None if early_stopping_epsilon is None
               else float(early_stopping_epsilon))
  alignment_penalty = float(alignment_penalty)
  groups = None
  if group_assignments is not None:
    groups = [[int(m) for m in g] for g in group_assignments]

  def layout(dictionary):
    return subspace_ista_fista.group_layout(groups, dictionary.shape[0],
                                            dictionary.device)

  def infer(dictionary, batch_shard, sw, n_it):
    b = batch_shard.shape[0]
    if is_subspace_inf:
      gather_inds, valid_mask, index = layout(dictionary)
      grouped = subspace_ista_fista.build_grouped_dictionary(
          dictionary, gather_inds, valid_mask)
      stepsize = lipschitz_ops.fista_stepsize(grouped, lipschitz_method)
      init = torch.zeros((b,) + tuple(gather_inds.shape),
                         dtype=batch_shard.dtype, device=batch_shard.device)
      return subspace_ista_fista._solve(
          batch_shard, grouped, gather_inds, valid_mask, sw, n_it, stepsize,
          init, variant, False, early_eps, fc_formulation,
          dictionary.shape[0], True, index, psum_axes=stop_axes)
    stepsize = lipschitz_ops.fista_stepsize(dictionary, lipschitz_method)
    init = torch.zeros((b, dictionary.shape[0]), dtype=batch_shard.dtype,
                       device=batch_shard.device)
    return ista_fista._solve(
        batch_shard, dictionary, sw, n_it, stepsize, init, variant, nonneg,
        hard_threshold, early_eps, fc_formulation, psum_axes=stop_axes)

  def local_step(dictionary, hessian, batch_shard, sw, n_it, upd_step):
    codes = infer(dictionary, batch_shard, float(sw), int(n_it))
    global_b = batch_shard.shape[0] * mesh.size
    stat = None
    if uses_hessian:
      stat = mesh.sum(torch.sum(codes ** 2, dim=0))
    reg_fn = None
    if is_subspace_upd and alignment_penalty != 0:
      gather_inds, valid_mask, _ = layout(dictionary)
      reg_fn = lambda d: alignment_penalty * (
          alignment_regularization_gradients(d, gather_inds, valid_mask,
                                             renormalize))
    new_dict, hessian = _replicated_update(
        dictionary, hessian, stat, float(upd_step), upd_num_iters,
        global_b, uses_hessian, renormalize, lowest_code_val,
        lambda d: mesh.sum(codes.T @ (codes @ d - batch_shard)), reg_fn)
    return new_dict, hessian, codes

  return local_step


def _build_dp_conv_local_step(mesh, inference_alg, update_alg, *, nonneg,
                              hard_threshold, kernel_stride, padding,
                              renormalize, lipschitz_method, upd_num_iters,
                              lowest_code_val, early_stopping_epsilon):
  """The conv branch of ``build_dp_local_step`` (vtc_tpu :143-158,
  :165-219)."""
  if kernel_stride is None:
    raise ValueError("mode='convolutional' needs kernel_stride")
  stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  uses_hessian = update_alg in CHEAP_QUAD_ALGS
  stop_axes = mesh if early_stopping_epsilon is not None else None
  early_eps = (None if early_stopping_epsilon is None
               else float(early_stopping_epsilon))

  def local_step(dictionary, hessian, batch_shard, sw, n_it, upd_step):
    local_b = batch_shard.shape[0]
    global_b = local_b * mesh.size
    mask = conv_shapes.create_mask(batch_shard.shape, padding,
                                   batch_shard.dtype, batch_shard.device)
    stepsize = lipschitz_ops.fista_stepsize(
        dictionary.reshape(dictionary.shape[0], -1), lipschitz_method)
    init = torch.zeros(
        (local_b, dictionary.shape[0]) + conv_ista_fista.code_spatial_dims(
            batch_shard.shape, dictionary.shape, stride),
        dtype=batch_shard.dtype, device=batch_shard.device)
    codes = conv_ista_fista._solve(
        batch_shard, dictionary, mask, float(sw), int(n_it), stepsize, init,
        stride, inference_alg, nonneg, hard_threshold, early_eps,
        formulation="gram", padding=padding, psum_axes=stop_axes)
    stat = None
    if uses_hessian:
      stat = mesh.sum(torch.sum(codes ** 2, dim=(0, 2, 3)))
    if conv_dict_gram.supported(dictionary.shape, stride):
      # the code-space gradient: its dictionary-independent statistics
      # once per step, outside the update loop
      stats = conv_dict_gram.build_dict_gradient_stats(
          batch_shard, codes, dictionary.shape, stride, padding)
      conv_grad = lambda d: conv_dict_gram.dictionary_gradient_from_stats(
          stats, d, stride)
    else:
      conv_grad = lambda d: conv_ops.dictionary_gradient(
          batch_shard, codes, d, stride, mask)
    new_dict, hessian = _replicated_conv_update(
        dictionary, hessian, stat, float(upd_step), upd_num_iters, global_b,
        uses_hessian, renormalize, lowest_code_val,
        lambda d: mesh.sum(conv_grad(d) * local_b) / global_b,
        norm_floor=False)
    return new_dict, hessian, codes

  return local_step


def build_dp_fused_local_step(mesh, inference_alg, update_alg, *,
                              nonneg=False, hard_threshold=False,
                              renormalize=True, upd_num_iters=1,
                              lowest_code_val=0.001, power_iters=12,
                              mxu="highest"):
  """This rank's body of the fused-DP composition, fc.

  Signature: local_step(dictionary, hessian, eigvec, batch_shard, sw,
  inf_num_iters, upd_stepsize) -> (dict, hessian, eigvec, codes).  The
  eigenvector rides the caller's loop, replicated: the power refresh runs
  on the replicated dictionary, so every rank computes the same stepsize.
  """
  uses_hessian = update_alg == "sc_cheap_quadratic_descent"

  def local_step(dictionary, hessian, eigvec, batch_shard, sw, n_it,
                 upd_step):
    codes, cmat, bmat, stat, eigvec, _ = fused_train_step.fused_solve_stats(
        dictionary, eigvec, batch_shard, sw, n_it, variant=inference_alg,
        nonneg=nonneg, hard=hard_threshold, power_iters=power_iters, mxu=mxu)
    global_b = batch_shard.shape[0] * mesh.size
    cmat, bmat, stat = mesh.sum(cmat, bmat, stat)
    new_dict, hessian = _replicated_update(
        dictionary, hessian, stat, float(upd_step), upd_num_iters,
        global_b, uses_hessian, renormalize, lowest_code_val,
        lambda d: cmat @ d - bmat)
    return new_dict, hessian, eigvec, codes

  return local_step


def build_dp_group_fused_local_step(mesh, inference_alg, update_alg, *,
                                    group_assignments, alignment_penalty=0.0,
                                    hard_threshold=False, renormalize=True,
                                    upd_num_iters=1, lowest_code_val=0.001,
                                    power_iters=12, mxu="highest"):
  """The subspace counterpart of ``build_dp_fused_local_step``.

  ``eigvec`` is the grouped Gram's warm eigenvector, (min(G*M, n),): seed
  it with ``top_gram_eigenpair`` of the grouped dictionary.
  """
  variant = inference_alg[9:]  # subspace_ista / subspace_fista
  uses_hessian = update_alg == "subspace_sc_cheap_quadratic_descent"
  alignment_penalty = float(alignment_penalty)
  groups = tuple(tuple(int(m) for m in g) for g in group_assignments)

  def local_step(dictionary, hessian, eigvec, batch_shard, sw, n_it,
                 upd_step):
    codes, cmat, bmat, stat, eigvec, _ = (
        fused_group_train_step.fused_group_solve_stats(
            dictionary, eigvec, batch_shard, sw, n_it,
            group_assignments=groups, variant=variant, hard=hard_threshold,
            power_iters=power_iters, mxu=mxu))
    global_b = batch_shard.shape[0] * mesh.size
    cmat, bmat, stat = mesh.sum(cmat, bmat, stat)
    reg_fn = None
    if alignment_penalty != 0:
      gather_inds, valid_mask, _ = subspace_ista_fista.group_layout(
          groups, dictionary.shape[0], dictionary.device)
      reg_fn = lambda d: alignment_penalty * (
          alignment_regularization_gradients(d, gather_inds, valid_mask,
                                             renormalize))
    new_dict, hessian = _replicated_update(
        dictionary, hessian, stat, float(upd_step), upd_num_iters,
        global_b, uses_hessian, renormalize, lowest_code_val,
        lambda d: cmat @ d - bmat, reg_fn)
    return new_dict, hessian, eigvec, codes

  return local_step


def build_dp_conv_fused_local_step(mesh, inference_alg, update_alg, *,
                                   kernel_stride, padding, nonneg=False,
                                   hard_threshold=False, renormalize=True,
                                   upd_num_iters=1, lowest_code_val=0.001,
                                   power_iters=12, mxu="highest"):
  """The conv counterpart of ``build_dp_fused_local_step``.

  Signature: local_step(dictionary, hessian, eigvec, batch_shard, sw,
  inf_num_iters, upd_stepsize) -> (dict, hessian, eigvec, codes), eigvec
  the flat-kernel Gram's, (s,).  With ``upd_num_iters`` == 1 the reduced
  quantity is the gradient at the solve dictionary (any mask); with more,
  the gram-form statistics, which need a stride-block-uniform mask
  (``fused_conv_train.gram_stats_supported``; the wrapper raises
  otherwise).
  """
  uses_hessian = update_alg == "sc_cheap_quadratic_descent"
  gram_stats = int(upd_num_iters) > 1
  stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  flags = dict(kernel_stride=stride, padding=padding, variant=inference_alg,
               nonneg=nonneg, hard=hard_threshold, power_iters=power_iters,
               gram_stats=gram_stats, mxu=mxu)

  def local_step(dictionary, hessian, eigvec, batch_shard, sw, n_it,
                 upd_step):
    out = fused_conv_train.conv_solve_stats(dictionary, eigvec, batch_shard,
                                            sw, n_it, **flags)
    codes, stats, eigvec = out[0], out[1:-2], out[-2]
    new_dict, hessian = conv_replicated_update(
        mesh, dictionary, hessian, stats, batch_shard.shape, float(upd_step),
        upd_num_iters, kernel_stride=stride, uses_hessian=uses_hessian,
        renormalize=renormalize, lowest_code_val=lowest_code_val)
    return new_dict, hessian, eigvec, codes

  return local_step


def conv_replicated_update(mesh, dictionary, hessian, stats, shard_shape,
                           upd_stepsize, upd_num_iters, *, kernel_stride,
                           uses_hessian, renormalize, lowest_code_val):
  """The fused conv step after K13 (vtc_tpu :418-449): one sum over
  ``mesh`` of this rank's ``stats`` -- (grad_sum, stat), or the gram form's
  (bx, cm, stat) -- and the replicated update from the global statistics,
  its gradient norm floored at 1e-30.  Also the plain version of K17's
  update (ops/fused_conv_dp_train).  Returns (dictionary, hessian)."""
  global_b = shard_shape[0] * mesh.size
  if len(stats) == 3:  # the gram form
    bx, cm, stat = mesh.sum(*stats)
    geo = fused_conv_direct.geometry(shard_shape, dictionary.shape,
                                     kernel_stride)
    grad_fn = lambda d: fused_conv_direct.unpack_dstk(
        (fused_conv_direct.pack_weights(d, geo)[0] @ cm - bx) / global_b,
        geo, dictionary.shape)
  else:
    grad_sum, stat = mesh.sum(*stats)
    grad0 = grad_sum / global_b
    grad_fn = lambda d: grad0
  return _replicated_conv_update(
      dictionary, hessian, stat, upd_stepsize, upd_num_iters, global_b,
      uses_hessian, renormalize, lowest_code_val, grad_fn, norm_floor=True)


def build_shard_map_train_step(mesh, mode, inference_alg, update_alg,
                               **config):
  """The data-parallel step on the GLOBAL batch.

  Signature of the returned callable:
    step(dictionary, hessian, batch, sparsity_weight, inf_num_iters,
         upd_stepsize) -> (new_dictionary, new_hessian, codes)
  ``batch`` is the global batch, the same on every rank (a tensor or an
  array; its leading dimension must divide by the mesh's size); each rank
  moves its own shard to the dictionary's device and solves it.  The
  dictionary and the Hessian come back replicated, the codes gathered in
  batch order.
  """
  local_step = build_dp_local_step(mesh, mode, inference_alg, update_alg,
                                   **config)

  def step(dictionary, hessian, batch, sparsity_weight, inf_num_iters,
           upd_stepsize):
    shard = torch.as_tensor(mesh.shard(batch), dtype=torch.float32,
                            device=dictionary.device)
    new_dict, hessian, codes = local_step(
        dictionary, hessian, shard, sparsity_weight, inf_num_iters,
        upd_stepsize)
    return new_dict, hessian, mesh.all_gather(codes)

  return step
