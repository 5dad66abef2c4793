"""Rank worker of the port's data-parallel CPU tests.

``run_ranks(world, cases)`` spawns ``world`` CPU processes that join one
``gloo`` group over a ``file://`` store in a temporary directory (no
network), run every case of ``cases`` in turn through the port's entry
points, exactly as a user's ranks would (the same global arrays on every
rank), and hand back what each rank returned.  The cases take and return
numpy arrays.

This module imports torch and the port only: the spawned children import
neither jax nor tests/conftest.py, so a rank starts in about a second.  The
test files import it, make the inputs from a numpy seed, run vtc_tpu's side
themselves and compare.
"""
import datetime
import multiprocessing
import os
import queue as queue_module
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from vtc_tpu_torch import parallel
from vtc_tpu_torch.analysis_transforms.convolutional import (
    ista_fista as conv_ista_fista)
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.ops import conv_shapes
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.training import compiled_epoch, ica, pca
from vtc_tpu_torch.training import sparse_coding as sc

TIMEOUT_S = 240


def _t(x):
  return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _np(tensors):
  return tuple(t.detach().cpu().numpy() for t in tensors)


# ---------------------------------------------------------------------------
# the cases: each runs on every rank with the same arguments
# ---------------------------------------------------------------------------
def case_mesh(dcn=1):
  mesh = parallel.make_mesh(dcn=dcn)
  x = np.arange(8 * mesh.size * 3, dtype=np.float32).reshape(8 * mesh.size, 3)
  total = mesh.sum(_t(x[:2]) * (mesh.index + 1))
  return {"axis_names": mesh.axis_names, "shape": dict(mesh.shape),
          "size": mesh.size, "index": mesh.index,
          "position": dict(mesh.position),
          "dp_axes": parallel.dp_axes(mesh),
          "shard": np.asarray(mesh.shard(x)),
          "sum": total.numpy(), "mean": mesh.mean(_t(x[:2])).numpy(),
          "gathered": mesh.all_gather(_t(mesh.shard(x))).numpy(),
          "object": mesh.broadcast_object({"rank": mesh.index})}


def case_mesh_nd(images, batches, stats):
  """``shard``, ``all_gather``, ``sum`` and ``sum_`` on the arrays of conv
  data parallelism: (b, c, H, W) images, (k, b, c, H, W) batches and the
  gram-form statistics (bx, cm, stat), scaled by rank + 1 (``sum_``: packed
  into one buffer, as K17 sums them)."""
  mesh = parallel.make_mesh()
  shard4, shard5 = mesh.shard(images), mesh.shard(batches, dim=1)
  summed = mesh.sum(*[_t(a) * (mesh.index + 1) for a in stats])
  flat = torch.cat([_t(a).reshape(-1) for a in stats]) * (mesh.index + 1)
  in_place = mesh.sum_(flat)
  return {"bounds": mesh.shard_bounds(images.shape[0]),
          "sum_": flat.numpy(), "sum_ returns it": in_place is flat,
          "shard4": np.asarray(shard4), "shard5": np.asarray(shard5),
          "gather4": mesh.all_gather(_t(shard4)).numpy(),
          "gather5": mesh.all_gather(_t(shard5), dim=1).numpy(),
          "sum": [t.numpy() for t in summed]}


def case_shard_map_step(d, h, batch, sw, n_it, upd_step, mode, inference_alg,
                        update_alg, config, dcn=1):
  """``build_shard_map_train_step`` on the global batch."""
  mesh = parallel.make_mesh(dcn=dcn)
  step = parallel.build_shard_map_train_step(mesh, mode, inference_alg,
                                             update_alg, **config)
  return _np(step(_t(d), _t(h), batch, sw, n_it, upd_step))


def case_fused_runner(d, h, v, batches, sw, n_it, upd_step, inference_alg,
                      update_alg, config):
  """``_dp_fused_segment_runner`` over this rank's shards, fc or (with
  group_assignments in ``config``) subspace; ``steps`` of the state."""
  mesh = parallel.make_mesh()
  build = (parallel.build_dp_group_fused_local_step
           if "group_assignments" in config
           else parallel.build_dp_fused_local_step)
  runner = compiled_epoch._dp_fused_segment_runner(
      build(mesh, inference_alg, update_alg, **config))
  shards = _t(mesh.shard(batches, dim=1))
  return _np(runner(_t(d), _t(h), _t(v), shards, sw, n_it, upd_step))


def case_conv_fused_runner(d, h, v, batches, sw, n_it, upd_step,
                           inference_alg, update_alg, config):
  """``_dp_fused_segment_runner`` of ``build_dp_conv_fused_local_step``
  (K13's composition) over this rank's shards of (k, b, c, H, W)."""
  mesh = parallel.make_mesh()
  runner = compiled_epoch._dp_fused_segment_runner(
      parallel.build_dp_conv_fused_local_step(mesh, inference_alg,
                                              update_alg, **config))
  shards = _t(mesh.shard(batches, dim=1))
  return _np(runner(_t(d), _t(h), _t(v), shards, sw, n_it, upd_step))


def case_conv_dp_runner(d, h, v, batches, sw, n_it, upd_step, inference_alg,
                        update_alg, config):
  """``_dp_conv_segment_runner`` (K17, its plain version on CPU tensors)
  over this rank's shards of (k, b, c, H, W); config's optional
  'early_eps' is its stop test, its optional 'mxu' the solves' tier."""
  mesh = parallel.make_mesh()
  runner = compiled_epoch._dp_conv_segment_runner(
      mesh, inference_alg, update_alg, config["upd_num_iters"], False, False,
      True, config["kernel_stride"], config["padding"],
      config.get("early_eps"), mxu=config.get("mxu", "highest"))
  shards = _t(mesh.shard(batches, dim=1))
  return _np(runner(_t(d), _t(h), _t(v), shards, sw, n_it, upd_step))


def case_dp_segment(family, d, batches, config, h=None, v=None):
  """A whole-segment data-parallel runner over this rank's shards of the
  (k, b, n) ``batches``: K15 ('fc', ``_dp_fc_segment_runner``), K16
  ('group', ``_dp_group_segment_runner``) or K18 ('ica',
  ``ica._dp_kernel_segment_runner``; ``v`` is the inverse), their plain
  versions on CPU tensors; config's optional 'mxu' is the runners' tier.
  Returns the replicated state."""
  mesh = parallel.make_mesh()
  shards = _t(mesh.shard(batches, dim=1))
  if family == "ica":
    runner = ica._dp_kernel_segment_runner(
        config["upd_num_iters"], mesh, refine_iters=config["refine_iters"],
        mxu=config.get("mxu", "highest"))
    return _np(runner(_t(d), _t(v), shards, config["stepsize"]))
  if family == "fc":
    runner = compiled_epoch._dp_fc_segment_runner(
        mesh, config["variant"], config["update_alg"],
        config["upd_num_iters"], config["nonneg"], config["hard"], True,
        mxu=config.get("mxu", "highest"))
  else:
    runner = compiled_epoch._dp_group_segment_runner(
        mesh, config["variant"], config["update_alg"],
        config["upd_num_iters"], False, True, config["group_assignments"],
        config["alignment_penalty"], mxu=config.get("mxu", "highest"))
  return _np(runner(_t(d), _t(h), _t(v), shards, config["sw"],
                    config["n_it"], config["upd_step"]))


def case_dp_stop(family, d, h, v, batches, config):
  """K15 ('fc') or K16 ('group') with the early stop through its runner
  (``_dp_fc_segment_runner`` / ``_dp_group_segment_runner`` with
  ``early_eps``) over this rank's shards of the (k, b, n) ``batches``,
  at config's optional tier 'mxu': the replicated state and the plain
  version's count of every step."""
  from vtc_tpu_torch.ops import fused_dp_train, fused_group_dp_train
  mesh = parallel.make_mesh()
  shards = _t(mesh.shard(batches, dim=1))
  if family == "fc":
    mod = fused_dp_train
    runner = compiled_epoch._dp_fc_segment_runner(
        mesh, "fista", config["update_alg"], 1, False, False, True,
        config["early_eps"], mxu=config.get("mxu", "highest"))
  else:
    mod = fused_group_dp_train
    runner = compiled_epoch._dp_group_segment_runner(
        mesh, "fista", config["update_alg"], 1, False, True,
        config["group_assignments"], config["alignment_penalty"],
        config["early_eps"], mxu=config.get("mxu", "highest"))
  state = _np(runner(_t(d), _t(h), _t(v), shards, config["sw"],
                     config["n_it"], config["upd_step"]))
  return {"state": state, "counts": list(mod.plain_iters)}


def case_routes(family, batches, d0, params, dcn=1):
  """Which data-parallel wrappers a scanned trainer (fc and subspace:
  compiled_epoch; 'ica': ica) calls with data_parallel=True, or with
  ``dcn`` > 1 a mesh of that many slices: the calls of each of K15, K16,
  K18 (whole segments) and K3, K7, K9 (one shard's step), and the result.
  Also runs in the test process, at a world of 1."""
  from vtc_tpu_torch.ops import (fused_dp_train, fused_group_dp_train,
                                 fused_group_train_step, fused_ica_train,
                                 fused_train_step)
  watched = {"K15": (fused_dp_train, "fused_dp_train_segment"),
             "K16": (fused_group_dp_train, "fused_group_dp_train_segment"),
             "K18": (fused_ica_train, "fused_ica_dp_train_segment"),
             "K3": (fused_train_step, "fused_solve_stats"),
             "K7": (fused_group_train_step, "fused_group_solve_stats"),
             "K9": (fused_ica_train, "ica_solve_stats")}
  calls = dict.fromkeys(watched, 0)
  originals = {key: getattr(module, name)
               for key, (module, name) in watched.items()}

  def counted(key):
    def call(*args, **kwargs):
      calls[key] += 1
      return originals[key](*args, **kwargs)
    return call

  for key, (module, name) in watched.items():
    setattr(module, name, counted(key))
  try:
    params = dict(params, data_parallel=True if dcn == 1
                  else parallel.make_mesh(dcn=dcn))
    if family == "ica":
      out = ica.train_dictionary_scanned(batches, d0, params, device="cpu")
    else:
      out = compiled_epoch.train_dictionary_scanned(
          batches, batches[:1], d0, params, device="cpu")
  finally:
    for key, (module, name) in watched.items():
      setattr(module, name, originals[key])
  return {"dictionary": out.numpy(), "calls": calls}


def case_cold_runner(d, h, batches, sw, n_it, upd_step, inference_alg,
                     update_alg, config):
  """``_dp_segment_runner`` (the psum-per-op step) over this rank's
  shards."""
  mesh = parallel.make_mesh()
  runner = compiled_epoch._dp_segment_runner(parallel.build_dp_local_step(
      mesh, "fully-connected", inference_alg, update_alg, **config))
  shards = _t(mesh.shard(batches, dim=1))
  d1, h1, _ = runner(_t(d), _t(h), torch.zeros(1), shards, sw, n_it,
                     upd_step)
  return _np((d1, h1))


def case_early_stop(d, batch, sw, n_it, eps, formulation):
  """The batch-global stop test: this rank's codes and how many times it
  reduced the stop scalar (once per iteration after the first)."""
  mesh = parallel.make_mesh()
  reductions = []
  original = mesh.mean

  def counted(tensor):
    reductions.append(1)
    return original(tensor)

  mesh.mean = counted
  d = _t(d)
  shard = _t(mesh.shard(batch))
  eta = 1.0 / torch.linalg.eigvalsh(d @ d.T)[-1]
  init = torch.zeros((shard.shape[0], d.shape[0]))
  codes = ista_fista._solve(shard, d, sw, n_it, eta, init, "fista", False,
                            False, eps, formulation, psum_axes=mesh)
  return {"codes": mesh.all_gather(codes).numpy(),
          "reductions": len(reductions)}


def case_conv_early_stop(d, batch, sw, n_it, eps, kernel_stride, padding):
  """The conv batch-global stop test (the 'gram' loop of the psum-per-op
  step): this rank's codes and how many times it reduced the stop
  scalar."""
  mesh = parallel.make_mesh()
  reductions = []
  original = mesh.mean

  def counted(tensor):
    reductions.append(1)
    return original(tensor)

  mesh.mean = counted
  d = _t(d)
  shard = _t(mesh.shard(batch))
  eta = 1.0 / torch.linalg.eigvalsh(d.reshape(d.shape[0], -1)
                                    @ d.reshape(d.shape[0], -1).T)[-1]
  mask = conv_shapes.create_mask(shard.shape, padding)
  init = torch.zeros((shard.shape[0], d.shape[0])
                     + conv_ista_fista.code_spatial_dims(shard.shape, d.shape,
                                                         kernel_stride))
  codes = conv_ista_fista._solve(
      shard, d, mask, sw, n_it, eta, init, kernel_stride, "fista", False,
      False, eps, formulation="gram", padding=padding, psum_axes=mesh)
  return {"codes": mesh.all_gather(codes).numpy(),
          "reductions": len(reductions)}


def case_train(trainer, batches, val, d0, params, dcn=1):
  """A sparse-coding trainer with params['data_parallel'] = True, or with
  ``dcn`` > 1 a mesh of that many slices."""
  fn = {"per_batch": sc.train_dictionary,
        "scanned": compiled_epoch.train_dictionary_scanned}[trainer]
  params = dict(params, data_parallel=True if dcn == 1
                else parallel.make_mesh(dcn=dcn))
  return fn(batches, val, d0, params, device="cpu").numpy()


def case_visited(batches, d0, params):
  """The batches this rank's scanned trainer visits, in order: a runner
  that records its shards in place of the data-parallel one."""
  seen = []

  def recording_runner(local_step):
    def run(dictionary, hessian, eigvec, shards, sw, n_it, upd_step):
      seen.append(shards.numpy().copy())
      return dictionary, hessian, eigvec
    return run

  original = compiled_epoch._dp_segment_runner
  compiled_epoch._dp_segment_runner = recording_runner
  try:
    compiled_epoch.train_dictionary_scanned(
        batches, batches[:1], d0, dict(params, data_parallel=True),
        device="cpu")
  finally:
    compiled_epoch._dp_segment_runner = original
  mesh = parallel.make_mesh()
  return mesh.all_gather(_t(np.concatenate(seen)), dim=1).numpy()


def case_ica(batches, d0, params):
  before = ica.rollbacks
  out = ica.train_dictionary_scanned(batches, d0,
                                     dict(params, data_parallel=True),
                                     device="cpu")
  return {"dictionary": out.numpy(), "rollbacks": ica.rollbacks - before}


def case_pca(data):
  return pca.train_dictionary(data, data_parallel=True, device="cpu").numpy()


def case_encode(data, d, sw, n_it, kw):
  return encode_dataset(data, d, sw, n_it, device="cpu",
                        data_parallel=parallel.make_mesh(), **kw)


# ---------------------------------------------------------------------------
# the 'code' axis: dictionary rows sharded over ranks
# ---------------------------------------------------------------------------
def case_code_mesh(mesh_spec):
  """A mesh with a 'code' axis: its layout, the row and batch shards of a
  global array, and the sums and gathers over the code and data groups,
  each rank contributing (mesh rank + 1) times the array."""
  mesh = parallel.make_mesh(**mesh_spec)
  rows = 4 * mesh.code_size * mesh.size
  x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
  scale = mesh.rank + 1
  flat = _t(x[:2]).reshape(-1) * scale
  code_sum = mesh.sum_code_(flat)
  return {"axis_names": mesh.axis_names, "shape": dict(mesh.shape),
          "position": dict(mesh.position), "size": mesh.size,
          "index": mesh.index, "code_size": mesh.code_size,
          "code_index": mesh.code_index, "rank": mesh.rank,
          "dp_axes": parallel.dp_axes(mesh),
          "row_bounds": mesh.code_shard_bounds(rows),
          "rows": np.asarray(mesh.code_shard(x)),
          "batch": np.asarray(mesh.shard(x)),
          "sum": mesh.sum(_t(x[:2]) * scale).numpy(),
          "sum_code_": code_sum.numpy(), "in place": code_sum is flat,
          "gather": mesh.all_gather(_t(mesh.shard(x))).numpy(),
          "gather_code": mesh.all_gather_code(
              _t(mesh.code_shard(x)).T, dim=1).numpy(),
          "object": mesh.broadcast_object({"rank": mesh.rank})}


def case_cs_segment(mesh_spec, d, h, v, batches, sw, n_it, upd_step, kw,
                    groups=None):
  """K19 across ranks (its plain version on CPU tensors): this rank's rows
  of ``d`` and ``h``, the replicated ``v`` and its batch shard; with
  ``groups`` the rank's slice of code_shard_group_arrays.  Returns the
  rows, codes and eigenvector gathered into the global arrays, the
  stepsize, the rank's own eigenvector and, with the stop, its counts."""
  from vtc_tpu_torch import convert
  from vtc_tpu_torch.ops import fused_code_shard_train as cs
  mesh = parallel.make_mesh(**mesh_spec)
  state = convert.code_shard_state_from_numpy(d, h, v, mesh, "cpu",
                                              group_assignments=groups)
  if groups is None or kw.get("alignment_penalty", 0.0) == 0.0:
    state.pop("comem_local", None)
  code, data = mesh.code_size, mesh.size
  d1, h1, v1, codes, eta = cs.fused_code_sharded_train_segment(
      *(state.pop(key) for key in ("dict_shard", "hessian_shard", "eigvec")),
      _t(mesh.shard(batches, dim=1)), sw, n_it, upd_step, axis_size=code,
      data_axis_size=data, data_stride=code if data > 1 else 0, mesh=mesh,
      power_iters=2, return_stepsize=True, **state, **kw)
  dg, hg, vg = convert.code_shard_state_to_numpy(mesh, d1, h1, v1)
  codes = mesh.all_gather(mesh.all_gather_code(codes, dim=1))
  return {"state": (dg, hg, vg, codes.numpy()), "eta": eta.numpy(),
          "eigvec": v1.numpy(),
          "iters": (list(cs.plain_iters) if kw.get("early_stopping_epsilon")
                    is not None else None)}


def case_cs_cuda(mesh_spec, d, h, v, batches, sw, n_it, upd_step):
  """K19 across ranks on the card (CUDA tensors: the kernels) and its
  float64 plain version, both gathered into the global arrays."""
  from vtc_tpu_torch import convert
  from vtc_tpu_torch.ops import fused_code_shard_train as cs
  mesh = parallel.make_mesh(**mesh_spec)
  dev = torch.device("cuda", 0)
  state = convert.code_shard_state_from_numpy(d, h, v, mesh, dev)
  args = (state["dict_shard"], state["hessian_shard"], state["eigvec"],
          torch.tensor(mesh.shard(batches, dim=1), device=dev))
  code, data = mesh.code_size, mesh.size
  got = cs.fused_code_sharded_train_segment(
      *args, sw, n_it, upd_step, axis_size=code, data_axis_size=data,
      data_stride=code if data > 1 else 0, mesh=mesh, power_iters=2)
  want = cs.fused_code_sharded_train_segment_plain(
      *(t.double() for t in args), sw, n_it, upd_step, mesh=mesh,
      power_iters=2)
  return [convert.code_shard_state_to_numpy(mesh, *out[:3])
          for out in (got, want)]


def case_cs_train(mesh_spec, batches, d0, params):
  """The scanned trainer on a mesh with a 'code' axis: the dictionary and
  the calls of each route (K19's wrapper, K3 and K7's compositions, the
  whole-segment K15 and K16, and the psum-per-op step)."""
  from vtc_tpu_torch.ops import (fused_code_shard_train, fused_dp_train,
                                 fused_group_dp_train,
                                 fused_group_train_step, fused_train_step)
  watched = {"K19": (fused_code_shard_train,
                     "fused_code_sharded_train_segment"),
             "K15": (fused_dp_train, "fused_dp_train_segment"),
             "K16": (fused_group_dp_train, "fused_group_dp_train_segment"),
             "K3": (fused_train_step, "fused_solve_stats"),
             "K7": (fused_group_train_step, "fused_group_solve_stats"),
             "psum-per-op": (parallel, "build_dp_local_step")}
  calls = dict.fromkeys(watched, 0)
  originals = {key: getattr(module, name)
               for key, (module, name) in watched.items()}

  def counted(key):
    def call(*args, **kwargs):
      calls[key] += 1
      return originals[key](*args, **kwargs)
    return call

  for key, (module, name) in watched.items():
    setattr(module, name, counted(key))
  try:
    out = compiled_epoch.train_dictionary_scanned(
        batches, batches[:1], d0,
        dict(params, data_parallel=parallel.make_mesh(**mesh_spec)),
        device="cpu")
  finally:
    for key, (module, name) in watched.items():
      setattr(module, name, originals[key])
  return {"dictionary": out.numpy(), "calls": calls}


def case_pjit(mesh_spec, d, h, batch, sw, n_it, upd_step, shard_code):
  """``build_pjit_train_step`` on the global arrays."""
  mesh = parallel.make_mesh(**mesh_spec)
  step = parallel.build_pjit_train_step(
      mesh, "fully-connected", "fista", "sc_cheap_quadratic_descent",
      shard_code_axis=shard_code)
  return _np(step(_t(d), _t(h), batch, sw, n_it, upd_step))


def case_cs_encode(mesh_spec, data, d, sw, n_it, kw):
  return encode_dataset(data, d, sw, n_it, device="cpu",
                        data_parallel=parallel.make_mesh(**mesh_spec), **kw)


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------
def _rank_main(rank, world, store, cases, out_queue):
  torch.set_num_threads(1)
  result, error = {}, None
  try:
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S // 2))
    try:
      for key, name, kwargs in cases:
        result[key] = CASES[name](**kwargs)
    finally:
      dist.destroy_process_group()
  except Exception:  # reported to the parent, which fails the test
    error = traceback.format_exc()
  out_queue.put((rank, result, error))


def run_ranks(world, cases):
  """Run ``cases`` -- (key, case name, keyword arguments) triples -- on
  ``world`` spawned ranks; returns [per-rank {key: result}] in rank order.
  A rank that raises, or does not answer in time, fails the caller."""
  ctx = multiprocessing.get_context("spawn")
  out_queue = ctx.Queue()
  with tempfile.TemporaryDirectory() as tmp:
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, world, store, cases, out_queue))
             for rank in range(world)]
    for proc in procs:
      proc.start()
    results, errors = {}, []
    deadline = time.monotonic() + TIMEOUT_S
    try:
      while len(results) < world and not errors:  # drain before joining
        try:
          rank, result, error = out_queue.get(timeout=1)
        except queue_module.Empty:
          died = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
          if died:
            errors.append("a rank died with exit code %s" % died[0])
          elif time.monotonic() > deadline:
            errors.append("a rank did not answer within %d s" % TIMEOUT_S)
          continue
        results[rank] = result
        if error is not None:
          errors.append("rank %d:\n%s" % (rank, error))
    finally:
      for proc in procs:
        proc.join(timeout=10 if not errors else 1)
        if proc.is_alive():
          proc.kill()
          proc.join(timeout=10)
          errors.append("a rank had to be killed")
  assert not errors, "\n".join(errors)
  return [results[rank] for rank in range(world)]
