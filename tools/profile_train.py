"""Where the time of the port's scanned trainer goes, on one CUDA device.

  python3 tools/profile_train.py [--subspace | --conv | --ica | --bigdict |
                                  --bigdict-groups] [--dp] [--out FILE]

The workload is chip_smoke.py's fc trainer: 250,000 synthetic 16x16
patches in 1,000 batches of 250, a random unit-norm 256-atom dictionary,
25 FISTA iterations at lambda 0.008, the cheap-quadratic update at
stepsize 0.1, two warm power iterations per step.  With --subspace it is
chip_smoke.py's subspace trainer instead: group-sparse patches, 64
contiguous groups of 4, the subspace cheap-quadratic update at stepsize
0.05, through the fused group train step (ops/fused_group_train_step,
kernel K6).  With --conv it is chip_smoke.py's scanned conv trainer
(phase 19: one 200-step segment of 40 images of 272x272, 64 windowed
16x16 kernels at stride 8, FISTA 25, lambda 0.05, cheap-quadratic update
at stepsize 0.05) through the fused conv train step (ops/fused_conv_train,
kernel K12); with --ica chip_smoke.py's scanned ICA trainer (phase 21:
2,000 batches of 250 Laplace mixtures, n = 256, stepsize 0.001, three
Newton-Schulz refreshes) through the fused ICA step (ops/fused_ica_train,
kernel K8).  With --bigdict it is chip_smoke.py phase 25's timed run,
bench.py's measure_bigdict row (its seeded randn patches and dictionary:
s = 2048, n = 256, 200 steps of 128, FISTA 25, cheap-quadratic update at
stepsize 0.1) through training/compiled_epoch._code_shard_segment_runner
and the residual-form step (ops/fused_code_shard_train, kernel K19);
--bigdict-groups the same with 512 contiguous groups of 4.  With --dp (fc,
--subspace or --ica) the same workload runs data-parallel on a mesh of one
rank, all_params['data_parallel'] = True with no process group: the
trainer runs the whole data-parallel segment, kernel K15, K16 or K18
(ops/fused_dp_train, ops/fused_group_dp_train, ops/fused_ica_train.
fused_ica_dp_train_segment: K3's, K7's or K9's refresh, solve and
statistics, then the update, from one C loop, with no host hook at a world
of one); the "fused" and "plain" lines are that kernel's and its plain
version's.  With --dp --conv the trainer runs
the whole data-parallel conv segment, kernel K17 (ops/fused_conv_dp_train:
K13's refresh, solve and statistics, then the update, from one C loop);
the "fused" and "plain" lines are K17's and its plain version's, and the
step split gives K13's share of the busy time beside the update's.  It
reports

* with CUDA events after a warm-up call: the fused train step (fc:
  ops/fused_train_step, kernel K2) per step over a short segment and the
  whole one, and the plain PyTorch step over a short segment;
* the host time per step: how long the fused segment takes to enqueue
  a 20-step segment (under the launch queue's depth, so the host's own
  cost) and the whole one (which may fill the queue, so the host waits
  on the device), and the wall time until the device is done;
* a torch.profiler trace of one whole segment through
  train_dictionary_scanned (for the big dictionaries: the runner): wall
  time, the union of the device's busy intervals, its idle share, and
  device time by kernel, grouped into
  the products (gemm_kernel), the power refresh (power_kernel), the
  FISTA solve (fista_cluster_kernel, and fista_kernel with
  fold_gram_kernel at large batches), the epilogue
  (hessian_ema_kernel, update_rows_kernel), the group passes
  (gather_rows_kernel, sum_slots_kernel, sign_mask_kernel), the conv
  GEMMs (gather_gemm_tiled, gather_gemm), the conv gradient
  (block_grad_partial_kernel, grad_reduce_kernel), the conv update
  (conv_update_kernel, conv_hessian_ema_kernel, dall_from_dstk_kernel),
  K13's statistics (conv_code_stat_kernel, block_cm_partial_kernel), the
  ICA segment kernel (ica_segment_kernel: every phase of every step of an
  ICA segment, one launch a segment), K19's solve at a mesh of one rank
  (code_shard_solve_kernel: every FISTA iteration of a step and the
  update's first residual, one launch a step), its later update residuals
  (resid_partial_kernel, resid_sum_kernel), and everything else; for K19
  also the step's split between the solve, the power refresh (with the
  n x n Gram's pgram_partial_kernel and pgram_sum_kernel) and the
  update.

Every line of the report is printed, and written to --out when given.
Needs a CUDA device; imports nothing of the JAX package.
"""
import argparse
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tools"))

import chip_smoke  # noqa: E402  (the workload and the card's line)
from profile_encode import busy_ms, time_ms  # noqa: E402

CS_SOLVE = ("K19 solve: every FISTA iteration and the update's first "
            "residual (code_shard_solve_kernel)")
POWER = "power refresh (power_kernel; K19: pgram_partial, pgram_sum)"
RESID = "K19 update residual codes D - X (resid_partial, resid_sum)"
PRODUCTS = "products (gemm_kernel)"
EPILOGUE = ("epilogue (hessian_ema_kernel, update_rows_kernel, "
            "column_sumsq_kernel)")
GROUP_PASSES = "group passes (gather_rows, sum_slots, sign_mask)"
CONV_UPDATE = "conv update (conv_update, conv_hessian_ema, dall_from_dstk)"
CONV_GEMMS = ("conv GEMMs: corr, synthesis, analysis, residual "
              "(gather_gemm_tiled, gather_gemm)")
CONV_GRAD = "conv gradient (block_grad_partial, grad_reduce)"
K13_STATS = "K13 statistics (conv_code_stat, block_cm_partial)"
DP_UPDATE = "DP update inputs (divide, hessian_from_stat: K15-K17)"
ICA_SEGMENT = "ICA segment, the whole step (ica_segment_kernel: K8, K18)"
GROUPS = ((CS_SOLVE, ("code_shard_solve_kernel",)),
          (RESID, ("resid_partial_kernel", "resid_sum_kernel")),
          (PRODUCTS, ("gemm_kernel",)),
          (POWER, ("power_kernel", "pgram_partial_kernel",
                   "pgram_sum_kernel")),
          ("FISTA (fista_cluster_kernel, fista_kernel, fold_gram_kernel)",
           ("fista_cluster_kernel", "fista_kernel", "fold_gram_kernel")),
          # before the epilogue: conv_hessian_ema_kernel contains its name
          (CONV_UPDATE, ("conv_update_kernel", "conv_hessian_ema_kernel",
                         "dall_from_dstk_kernel")),
          (K13_STATS, ("conv_code_stat_kernel", "block_cm_partial_kernel")),
          (DP_UPDATE, ("divide_kernel", "hessian_from_stat_kernel")),
          (EPILOGUE, ("hessian_ema_kernel", "update_rows_kernel",
                      "column_sumsq_kernel")),
          (GROUP_PASSES,
           ("gather_rows_kernel", "sum_slots_kernel", "sign_mask_kernel")),
          (CONV_GEMMS, ("gather_gemm",)),
          (CONV_GRAD, ("block_grad_partial_kernel", "grad_reduce_kernel")),
          (ICA_SEGMENT, ("ica_segment_kernel",)))


def group_of(name):
  for group, kernels in GROUPS:
    if any(k in name for k in kernels):
      return group
  return "other"


def workload(args, torch, dev):
  """The segment, its runners and its trainer for the chosen family."""
  from vtc_tpu_torch.ops import (fused_code_shard_train, fused_conv_dp_train,
                                 fused_conv_train, fused_dp_train,
                                 fused_group_dp_train, fused_group_train_step,
                                 fused_ica_train, fused_train_step, lipschitz)
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.training import compiled_epoch, ica
  cs = chip_smoke
  if args.bigdict or args.bigdict_groups:
    k19 = fused_code_shard_train
    steps, batch, s = cs.BIG_STEPS, cs.BIG_B, cs.BIG_S
    rng = np.random.RandomState(0)  # bench.py:570-576: d0, then the data
    d0 = torch.tensor(cs.unit_rows(rng, s, 256), device=dev)
    batches = torch.tensor(rng.randn(steps, batch, 256).astype(np.float32),
                           device=dev)
    h0 = torch.zeros(s, device=dev)
    v0 = lipschitz.top_gram_eigenpair(d0)[1].contiguous()
    arrays, kw = None, {}
    alg = "sc_cheap_quadratic_descent"
    if args.bigdict_groups:
      arrays = k19.code_shard_group_arrays(cs.contiguous_groups(s, 4), s, 1)
      alg = "subspace_sc_cheap_quadratic_descent"
      kw = dict(expand_local=arrays[0][0], update_alg=alg)
    runner = compiled_epoch._code_shard_segment_runner(
        None, 1, 1, "fista", alg, 1, False, False, True, group_arrays=arrays)
    scalars = (cs.LAM, cs.TRAIN_ITERS, cs.BIG_STEP)
    return dict(
        name="big-dictionary %s" % ("grouped 512x4" if arrays else "fc"),
        units="patches", steps=steps, batch=batch, short=20, plain_steps=20,
        kernels=k19, entry="_code_shard_segment_runner",
        fused=lambda k: lambda: k19.fused_code_sharded_train_segment(
            d0, h0, v0, batches[:k], *scalars, power_iters=2, **kw),
        plain=lambda k: lambda: k19.fused_code_sharded_train_segment_plain(
            d0, h0, v0, batches[:k], *scalars, power_iters=2, **kw),
        trainer=lambda: runner(d0, h0, v0, batches, *scalars),
        split=(("solve (FISTA and the first residual)", (CS_SOLVE,)),
               ("power refresh (D^T D and the power kernel)", (POWER,)),
               ("update (Hessian EMA, residual, codes^T resid, rows)",
                (RESID, PRODUCTS, EPILOGUE, GROUP_PASSES))))
  if args.conv:
    from vtc_tpu_torch.ops import convolutions as conv_ops
    steps, batch = cs.SEG_STEPS, cs.SEG_BATCH
    gen = cs.windowed_kernels(np.random.RandomState(0), cs.CONV_S, 1,
                              cs.CONV_K)
    batches = cs.conv_segment_images(torch, conv_ops, dev, steps, gen,
                                     seed=19)
    d0 = torch.tensor(cs.windowed_kernels(np.random.RandomState(2),
                                          cs.CONV_S, 1, cs.CONV_K),
                      device=dev)
    h0 = torch.zeros(cs.CONV_S, device=dev)
    v0 = lipschitz.top_gram_eigenpair(
        d0.reshape(cs.CONV_S, -1))[1].contiguous()
    params = cs.conv_segment_params(steps, cs.SEG_STEP)
    kw = dict(kernel_stride=(cs.CONV_STRIDE, cs.CONV_STRIDE),
              padding=params["padding"], power_iters=2)
    scalars = (cs.CONV_LAM, cs.SEG_ITERS, cs.SEG_STEP)
    if args.dp:
      k17 = fused_conv_dp_train
      dp_kw = dict(kw, mesh=parallel.make_mesh())
      return dict(
          name="data-parallel conv (a mesh of one rank)", units="images",
          steps=steps, batch=batch, short=20, plain_steps=5, kernels=k17,
          fused=lambda k: lambda: k17.fused_conv_dp_train_segment(
              d0, h0, v0, batches[:k], *scalars, **dp_kw),
          plain=lambda k: lambda: k17.fused_conv_dp_train_plain(
              d0, h0, v0, batches[:k], *scalars, **dp_kw),
          trainer=lambda: compiled_epoch.train_dictionary_scanned(
              batches, batches[:1], d0, dict(params, data_parallel=True)),
          split=(("K13's part: refresh, solve and statistics",
                  (POWER, PRODUCTS, CONV_GEMMS, CONV_GRAD, K13_STATS)),
                 ("the update (divide, hessian_from_stat, conv_update) and "
                  "the rest", (CONV_UPDATE, DP_UPDATE, "other"))))
    return dict(
        name="conv", units="images", steps=steps, batch=batch, short=20,
        plain_steps=5, kernels=fused_conv_train,
        fused=lambda k: lambda: fused_conv_train.fused_conv_train_segment(
            d0, h0, v0, batches[:k], *scalars, **kw),
        plain=lambda k: lambda: fused_conv_train.fused_conv_train_plain(
            d0, h0, v0, batches[:k], *scalars, **kw),
        trainer=lambda: compiled_epoch.train_dictionary_scanned(
            batches, batches[:1], d0, params))
  if args.ica:
    from vtc_tpu_torch.analysis_transforms.fully_connected import (
        invertible_linear)
    steps, batch, n = cs.ICA_STEPS, cs.ICA_BATCH, cs.ICA_N
    g = torch.Generator(device=dev).manual_seed(20)
    mixing = torch.tensor(cs.random_mixing(n, 21), device=dev)
    batches = cs.laplace_mixtures(torch, dev, steps * batch, mixing,
                                  g).reshape(steps, batch, n)
    d0 = torch.tensor(cs.random_orthogonal(n, 12), device=dev)
    x0 = invertible_linear.exact_inverse(d0)
    params = cs.ica_params(steps, cs.ICA_STEP)
    kw = dict(refine_iters=cs.ICA_REFINE, boost_tol=cs.ICA_BOOST_TOL)
    if args.dp:
      dp_kw = dict(kw, mesh=parallel.make_mesh())
      return dict(
          name="data-parallel ICA (a mesh of one rank)", units="patches",
          steps=steps, batch=batch, short=100, plain_steps=100,
          kernels=fused_ica_train, count="dp_launches",
          fused=lambda k: lambda: fused_ica_train.fused_ica_dp_train_segment(
              d0, x0, batches[:k], cs.ICA_STEP, **dp_kw),
          plain=lambda k: lambda: fused_ica_train.fused_ica_dp_train_plain(
              d0, x0, batches[:k], cs.ICA_STEP, **dp_kw),
          trainer=lambda: ica.train_dictionary_scanned(
              batches, d0, dict(params, data_parallel=True)))
    return dict(
        name="ICA", units="patches", steps=steps, batch=batch, short=100,
        plain_steps=100, kernels=fused_ica_train,
        fused=lambda k: lambda: fused_ica_train.fused_ica_train_segment(
            d0, x0, batches[:k], cs.ICA_STEP, **kw),
        plain=lambda k: lambda: fused_ica_train.fused_ica_train_plain(
            d0, x0, batches[:k], cs.ICA_STEP, **kw),
        trainer=lambda: ica.train_dictionary_scanned(batches, d0, params))
  steps, batch = cs.TRAIN_STEPS, cs.TRAIN_BATCH
  if args.subspace:
    patches = cs.group_patches(steps * batch, seed=1)
    params = cs.subspace_train_params(steps, cs.SUB_STEP)
    step = cs.SUB_STEP
    # contiguous groups of 4: the grouped dictionary is the dictionary
    kernels = fused_group_train_step
    fused_segment = fused_group_train_step.fused_group_train_segment
    plain_segment = fused_group_train_step.fused_group_train_segment_plain
    extra = dict(group_assignments=params["group_assignments"])
  else:
    patches = cs.synthetic_patches(steps * batch, seed=1)
    params = cs.train_params(steps)
    step = cs.TRAIN_STEP
    kernels = fused_train_step
    fused_segment = fused_train_step.fused_train_segment
    plain_segment = fused_train_step.fused_train_segment_plain
    extra = {}
  batches = torch.tensor(patches.reshape(steps, batch, 256), device=dev)
  d0 = torch.tensor(cs.unit_rows(np.random.RandomState(2), 256, 256),
                    device=dev)
  h0 = torch.zeros(256, device=dev)
  v0 = lipschitz.top_gram_eigenpair(d0)[1].contiguous()
  scalars = (cs.LAM, cs.TRAIN_ITERS, step)
  if args.dp:
    kernels = fused_group_dp_train if args.subspace else fused_dp_train
    segment = (fused_group_dp_train.fused_group_dp_train_segment
               if args.subspace else fused_dp_train.fused_dp_train_segment)
    plain = (fused_group_dp_train.fused_group_dp_train_plain
             if args.subspace else fused_dp_train.fused_dp_train_plain)
    dp_kw = dict(extra, mesh=parallel.make_mesh(), power_iters=2)
    return dict(
        name="data-parallel %s (a mesh of one rank)" % (
            "subspace" if args.subspace else "fc"), units="patches",
        steps=steps, batch=batch, short=100, plain_steps=100, kernels=kernels,
        fused=lambda k: lambda: segment(d0, h0, v0, batches[:k], *scalars,
                                        **dp_kw),
        plain=lambda k: lambda: plain(d0, h0, v0, batches[:k], *scalars,
                                      **dp_kw),
        trainer=lambda: compiled_epoch.train_dictionary_scanned(
            batches, batches[:1], d0, dict(params, data_parallel=True)))
  return dict(
      name="subspace" if args.subspace else "fc", units="patches",
      steps=steps, batch=batch, short=100, plain_steps=100, kernels=kernels,
      fused=lambda k: lambda: fused_segment(d0, h0, v0, batches[:k],
                                            *scalars, power_iters=2,
                                            **extra),
      plain=lambda k: lambda: plain_segment(d0, h0, v0, batches[:k],
                                            *scalars, power_iters=2,
                                            **extra),
      trainer=lambda: compiled_epoch.train_dictionary_scanned(
          batches, batches[:1], d0, params))


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  family = parser.add_mutually_exclusive_group()
  family.add_argument("--subspace", action="store_true",
                      help="profile the subspace trainer (kernel K6)")
  family.add_argument("--conv", action="store_true",
                      help="profile the scanned conv trainer (kernel K12)")
  family.add_argument("--ica", action="store_true",
                      help="profile the scanned ICA trainer (kernel K8)")
  family.add_argument("--bigdict", action="store_true",
                      help="profile bench.py's big-dictionary fc row "
                      "(kernel K19)")
  family.add_argument("--bigdict-groups", action="store_true",
                      help="profile bench.py's big-dictionary grouped row "
                      "(kernel K19)")
  parser.add_argument("--dp", action="store_true",
                      help="run the fc, --subspace, --ica or --conv workload "
                      "data-parallel on a mesh of one rank (kernels K15, "
                      "K16, K18, K17)")
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  if args.dp and (args.bigdict or args.bigdict_groups):
    parser.error("--dp goes with the fc, --subspace, --ica or --conv "
                 "workload")
  import torch
  if not torch.cuda.is_available():
    print("profile_train: no CUDA device", file=sys.stderr)
    return 1
  from torch.profiler import ProfilerActivity, profile

  dev = torch.device("cuda", 0)
  card = chip_smoke.card_line()
  lines = []

  def report(line):
    print(line, flush=True)
    lines.append(line)

  report("card: %s | torch %s cuda %s" % (card, torch.__version__,
                                          torch.version.cuda))
  w = workload(args, torch, dev)
  steps, batch = w["steps"], w["batch"]
  report("workload: %s trainer, %d steps of %d" % (w["name"], steps, batch))
  for k in (w["short"], steps):
    ms = time_ms(torch, w["fused"](k), 3)
    report("fused train step, %4d-step segment: %.4f ms per step" % (
        k, ms / k))
  k = w["plain_steps"]
  report("plain train step, %d-step segment: %.4f ms per step" % (
      k, time_ms(torch, w["plain"](k), 1) / k))

  # a short segment enqueues without filling the launch queue (about a
  # thousand launches), so its enqueue time is the host's own cost
  for k in (w.get("enqueue_steps", 20), steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w["fused"](k)()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    report("host, %4d-step segment: enqueue %.2f us per step, wall to "
           "device done %.2f us per step" % (
               k, (t1 - t0) / k * 1e6, (t2 - t0) / k * 1e6))

  def segment():
    torch.cuda.synchronize()
    start = time.perf_counter()
    w["trainer"]()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3

  segment()  # warm-up
  count = w.get("count", "launches")
  setattr(w["kernels"], count, 0)
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    wall = segment()
  device_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
  intervals = [(e.time_range.start, e.time_range.end)
               for e in device_events]
  busy = busy_ms(intervals)
  report("traced %s, %d steps of %d (%d fused "
         "steps): wall %.2f ms (%.1f %s/s), device busy %.2f ms (idle "
         "%.1f%% of wall), %.4f ms busy and %.4f ms wall per step" % (
             w.get("entry", "train_dictionary_scanned"), steps, batch,
             getattr(w["kernels"], count), wall,
             steps * batch / wall * 1e3, w["units"], busy,
             100 * (1 - busy / wall), busy / steps, wall / steps))
  per_group, per_name = {}, {}
  for e in device_events:
    t = (e.time_range.end - e.time_range.start) / 1e3
    n, total = per_name.get(e.name, (0, 0.0))
    per_name[e.name] = (n + 1, total + t)
    per_group[group_of(e.name)] = per_group.get(group_of(e.name), 0.0) + t
  for group, t in sorted(per_group.items(), key=lambda kv: -kv[1]):
    report("  %-60s %9.3f ms %5.1f%% of busy, %.4f ms per step" % (
        group, t, 100 * t / busy, t / steps))
  for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
    report("    device %9.3f ms %5.1f%%  %5d x  %s" % (
        t, 100 * t / busy, n, name[:80]))
  for label, groups in w.get("split", ()):
    t = sum(per_group.get(g, 0.0) for g in groups)
    report("  step split: %-55s %9.3f ms %5.1f%% of busy, %.4f ms per step"
           % (label, t, 100 * t / busy, t / steps))
  report(card)

  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
