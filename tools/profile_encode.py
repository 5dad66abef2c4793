"""Where the time of the port's encode goes, on one CUDA device.

  python3 tools/profile_encode.py [--subspace] [--out report.txt]

The workload is chip_smoke.py's fc encode: 32,768 synthetic 16x16
patches, a unit-norm 256-atom dictionary, batch 2048, 100 FISTA
iterations, lambda 0.008.  With --subspace it is chip_smoke.py's
subspace encode: group-sparse patches and 64 contiguous groups of 4,
through the fused group FISTA kernel (K4).  With CUDA events after a
warm-up call it times

* the fused kernel alone (G and c precomputed) at 0, 1, 25 and 100
  iterations, at batch 2048 and at the trainer's batch 250;
* the G = D D^T and c = X D^T products of one flagship batch;
* the stepsize (eigvalsh of the Gram), once per dictionary;

then encode_dataset's wall time, three calls each at chunk_batches 4
and 16, and a torch.profiler trace of one encode: wall time, the union
of the device's busy intervals, its idle share, and device time per
kernel name.  Every line of the report is printed, and written to
--out when given.  Needs a CUDA device; imports nothing of the JAX
package.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the workload and the card's line)


def time_ms(torch, fn, reps):
  """Mean device ms per call of ``fn`` over ``reps`` calls, after one
  warm-up call."""
  fn()
  start, stop = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  stop.synchronize()
  return start.elapsed_time(stop) / reps


def busy_ms(intervals):
  """Length of the union of (start, end) intervals, in ms (from us)."""
  total, end = 0.0, None
  for a, b in sorted(intervals):
    if end is None or a > end:
      total += b - a
      end = b
    elif b > end:
      total += b - end
      end = b
  return total / 1e3


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--subspace", action="store_true",
                      help="profile the subspace encode (kernel K4)")
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  import torch
  if not torch.cuda.is_available():
    print("profile_encode: no CUDA device", file=sys.stderr)
    return 1
  from torch.profiler import ProfilerActivity, profile

  from vtc_tpu_torch.encode import encode_dataset
  from vtc_tpu_torch.ops import fused_fista, fused_group_fista, lipschitz
  from vtc_tpu_torch.ops.precision import matmul_precision

  dev = torch.device("cuda", 0)
  card = chip_smoke.card_line()
  lines = []

  def report(line):
    print(line, flush=True)
    lines.append(line)

  report("card: %s | torch %s cuda %s" % (card, torch.__version__,
                                          torch.version.cuda))
  lam, iters, batch = chip_smoke.LAM, chip_smoke.ITERS, chip_smoke.BATCH
  d = torch.tensor(chip_smoke.unit_rows(np.random.RandomState(0), 256, 256),
                   device=dev)
  if args.subspace:
    # contiguous groups of 4: the grouped dictionary is the dictionary
    patches = chip_smoke.group_patches(batch * chip_smoke.NUM_BATCHES)
    groups = chip_smoke.contiguous_groups(256, chip_smoke.GROUP_SIZE)
    m = chip_smoke.GROUP_SIZE
    launch = lambda gram, corr, eta1, k: fused_group_fista._launch(
        gram, corr, None, eta1, lam, k, m, True, False)
    solve = lambda x: fused_group_fista.fused_group_fista_solve(
        x, d, m, lam, iters, eta)
  else:
    patches = chip_smoke.synthetic_patches(batch * chip_smoke.NUM_BATCHES)
    groups = None
    launch = lambda gram, corr, eta1, k: fused_fista._launch(
        gram, corr, None, eta1, lam, k, True, 0)
    solve = lambda x: fused_fista.fused_fista_solve(x, d, lam, iters, eta)
  report("workload: %s encode" % ("subspace" if groups else "fc"))
  eta = lipschitz.fista_stepsize(d)

  for b in (batch, 250):
    x = torch.tensor(patches[:b], device=dev)
    with matmul_precision():
      gram = (d @ d.T).contiguous()
      corr = (x @ d.T).contiguous()
    eta1 = eta.reshape(1).contiguous()
    for k in (0, 1, 25, 100):
      ms = time_ms(torch, lambda: launch(gram, corr, eta1, k), 20)
      report("kernel alone b=%d s=n=256 %3d it: %.4f ms" % (b, k, ms))
    ms = time_ms(torch, lambda: solve(x), 20)
    report("wrapper (G, c + kernel) b=%d 100 it: %.4f ms" % (b, ms))

  x = torch.tensor(patches[:batch], device=dev)

  def products():
    with matmul_precision():
      return d @ d.T, x @ d.T

  report("G and c products b=%d: %.4f ms" % (batch,
                                              time_ms(torch, products, 20)))
  report("stepsize (eigvalsh 256x256): %.4f ms"
         % time_ms(torch, lambda: lipschitz.fista_stepsize(d), 5))

  def encode(chunk_batches):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode_dataset(patches, d, lam, iters, batch_size=batch,
                   chunk_batches=chunk_batches, group_assignments=groups)
    return (time.perf_counter() - t0) * 1e3

  encode(4)  # warm-up
  for chunk_batches in (4, 16):
    walls = [encode(chunk_batches) for _ in range(3)]
    report("encode %d patches chunk_batches %d: wall %s ms" % (
        len(patches), chunk_batches, ", ".join("%.2f" % w for w in walls)))

  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    wall = encode(4)
  device_events = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
  intervals = [(e.time_range.start, e.time_range.end)
               for e in device_events]
  busy = busy_ms(intervals)
  span = (max(b for _, b in intervals) - min(a for a, _ in intervals)) / 1e3
  report("traced encode chunk_batches 4: wall %.2f ms, device busy %.2f ms "
         "(idle %.1f%% of wall), first-to-last device span %.2f ms" % (
             wall, busy, 100 * (1 - busy / wall), span))
  per_name = {}
  for e in device_events:
    n, t = per_name.get(e.name, (0, 0.0))
    per_name[e.name] = (n + 1, t + (e.time_range.end - e.time_range.start))
  for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
    report("  device %8.3f ms %5.1f%% of busy  %4d x  %s" % (
        t / 1e3, 100 * t / 1e3 / busy, n, name[:90]))
  report(card)

  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
