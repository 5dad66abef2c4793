"""Where the time of the port's scanned trainer goes, on one CUDA device.

  python3 tools/profile_train.py [--subspace] [--out report.txt]

The workload is chip_smoke.py's fc trainer: 250,000 synthetic 16x16
patches in 1,000 batches of 250, a random unit-norm 256-atom dictionary,
25 FISTA iterations at lambda 0.008, the cheap-quadratic update at
stepsize 0.1, two warm power iterations per step.  With --subspace it is
chip_smoke.py's subspace trainer instead: group-sparse patches, 64
contiguous groups of 4, the subspace cheap-quadratic update at stepsize
0.05, through the fused group train step (ops/fused_group_train_step,
kernel K6).  It reports

* with CUDA events after a warm-up call: the fused train step
  (ops/fused_train_step, kernel K2) per step over 100- and 1,000-step
  segments, and the plain PyTorch step over 100 steps;
* the host time per step: how long fused_train_segment takes to enqueue
  a 20-step segment (under the launch queue's depth, so the host's own
  cost) and a 1,000-step one (which fills the queue, so the host waits
  on the device), and the wall time until the device is done;
* a torch.profiler trace of one 1,000-step segment through
  train_dictionary_scanned: wall time, the union of the device's busy
  intervals, its idle share, and device time by kernel, grouped into
  the products (gemm_kernel), the power refresh (power_kernel), the
  FISTA solve (fista_kernel, fold_gram_kernel), the epilogue
  (hessian_ema_kernel, update_rows_kernel), the group passes
  (gather_rows_kernel, sum_slots_kernel, sign_mask_kernel) and
  everything else.

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

GROUPS = (("products (gemm_kernel)", ("gemm_kernel",)),
          ("power refresh (power_kernel)", ("power_kernel",)),
          ("FISTA (fista_kernel, fold_gram_kernel)",
           ("fista_kernel", "fold_gram_kernel")),
          ("epilogue (hessian_ema_kernel, update_rows_kernel)",
           ("hessian_ema_kernel", "update_rows_kernel")),
          ("group passes (gather_rows, sum_slots, sign_mask)",
           ("gather_rows_kernel", "sum_slots_kernel", "sign_mask_kernel")))


def group_of(name):
  for group, kernels in GROUPS:
    if any(k in name for k in kernels):
      return group
  return "other"


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--subspace", action="store_true",
                      help="profile the subspace trainer (kernel K6)")
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("profile_train: no CUDA device", file=sys.stderr)
    return 1
  from torch.profiler import ProfilerActivity, profile

  from vtc_tpu_torch.ops import (fused_group_train_step, fused_train_step,
                                 lipschitz)
  from vtc_tpu_torch.training import compiled_epoch

  dev = torch.device("cuda", 0)
  card = chip_smoke.card_line()
  lines = []

  def report(line):
    print(line, flush=True)
    lines.append(line)

  report("card: %s | torch %s cuda %s" % (card, torch.__version__,
                                          torch.version.cuda))
  steps, batch = chip_smoke.TRAIN_STEPS, chip_smoke.TRAIN_BATCH
  if args.subspace:
    patches = chip_smoke.group_patches(steps * batch, seed=1)
    params = chip_smoke.subspace_train_params(steps, chip_smoke.SUB_STEP)
    step = chip_smoke.SUB_STEP
    # contiguous groups of 4: the grouped dictionary is the dictionary
    kernels = fused_group_train_step
    fused_segment = fused_group_train_step.fused_group_train_segment
    plain_segment = fused_group_train_step.fused_group_train_segment_plain
    extra = dict(group_assignments=params["group_assignments"])
  else:
    patches = chip_smoke.synthetic_patches(steps * batch, seed=1)
    params = chip_smoke.train_params(steps)
    step = chip_smoke.TRAIN_STEP
    kernels = fused_train_step
    fused_segment = fused_train_step.fused_train_segment
    plain_segment = fused_train_step.fused_train_segment_plain
    extra = {}
  report("workload: %s trainer" % ("subspace" if args.subspace else "fc"))
  batches = torch.tensor(patches.reshape(steps, batch, 256), device=dev)
  d0 = torch.tensor(chip_smoke.unit_rows(np.random.RandomState(2), 256, 256),
                    device=dev)
  h0 = torch.zeros(256, device=dev)
  v0 = lipschitz.top_gram_eigenpair(d0)[1].contiguous()
  scalars = (chip_smoke.LAM, chip_smoke.TRAIN_ITERS, step)

  def fused(k):
    return lambda: fused_segment(d0, h0, v0, batches[:k], *scalars,
                                 power_iters=2, **extra)

  for k in (100, steps):
    ms = time_ms(torch, fused(k), 3)
    report("fused train step, %4d-step segment: %.4f ms per step" % (
        k, ms / k))
  plain = lambda: plain_segment(d0, h0, v0, batches[:100], *scalars,
                                power_iters=2, **extra)
  report("plain train step, 100-step segment: %.4f ms per step" % (
      time_ms(torch, plain, 1) / 100))

  # a short segment enqueues without filling the launch queue (about a
  # thousand launches), so its enqueue time is the host's own cost
  for k in (20, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused(k)()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    report("host, %4d-step segment: enqueue %.2f us per step, wall to "
           "device done %.2f us per step" % (
               k, (t1 - t0) / k * 1e6, (t2 - t0) / k * 1e6))

  def segment():
    torch.cuda.synchronize()
    start = time.perf_counter()
    compiled_epoch.train_dictionary_scanned(batches, batches[:1], d0,
                                            params)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3

  segment()  # warm-up
  kernels.launches = 0
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    wall = segment()
  device_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
  intervals = [(e.time_range.start, e.time_range.end)
               for e in device_events]
  busy = busy_ms(intervals)
  report("traced train_dictionary_scanned, %d steps of %d (%d fused "
         "steps): wall %.2f ms (%.1f patches/s), device busy %.2f ms (idle "
         "%.1f%% of wall), %.4f ms busy per step" % (
             steps, batch, kernels.launches, wall,
             steps * batch / wall * 1e3, busy, 100 * (1 - busy / wall),
             busy / steps))
  per_group, per_name = {}, {}
  for e in device_events:
    t = (e.time_range.end - e.time_range.start) / 1e3
    n, total = per_name.get(e.name, (0, 0.0))
    per_name[e.name] = (n + 1, total + t)
    per_group[group_of(e.name)] = per_group.get(group_of(e.name), 0.0) + t
  for group, t in sorted(per_group.items(), key=lambda kv: -kv[1]):
    report("  %-52s %9.3f ms %5.1f%% of busy, %.4f ms per step" % (
        group, t, 100 * t / busy, t / steps))
  for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
    report("    device %9.3f ms %5.1f%%  %5d x  %s" % (
        t, 100 * t / busy, n, name[:80]))
  report(card)

  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
