"""Run the conv kernels K10, K11, K12, K13 and K17 of a checkout on fixed
inputs, or compare two such runs bit for bit, or time them.

  python3 tools/compare_conv_kernels.py run OUT.pt    (from a checkout's root)
  python3 tools/compare_conv_kernels.py diff A.pt B.pt
  python3 tools/compare_conv_kernels.py time          (from a checkout's root)
  python3 tools/compare_conv_kernels.py split         (from this checkout's root)

``run`` imports vtc_tpu_torch from the current directory, so one copy of
this script runs the kernels of any checkout: ``cd other && python3
../tools/compare_conv_kernels.py run other.pt``.  Its inputs are made on
the CPU from fixed seeds, the same in every run: conv-sparse code maps
of 64 windowed 16x16 kernels at stride 8 (2% of positions active),
synthesized in float64 into 272x272 images with an 8-pixel zero border
and 0.01 noise; the same of 64 windowed 3x32x32 kernels at stride 16
into 3x288x288 images with a 16-pixel border (K11's serving geometry);
576 windowed 16x16 kernels (s > 512); a ragged problem (s 40, c 3, 6x6
kernels at stride 2); small K11 problems (5x7 kernels at stride (2, 3)
with asymmetric padding, special columns only); 480 windowed 12x12
kernels at stride 4 (K10's synthesis at K = 4,320, on gather_gemm).  It
saves every output tensor of K10 (flagship b 40 FISTA 100, b 5 ISTA 25,
ragged), K11 (flagship, with the stop at a fixed eps and its count, the
serving geometry at b 4, s 576 at b 2 FISTA 25, the small problems in
ISTA with hard and nonnegative thresholds), a 3-step K12 segment, K13
(gradient and gram form), K17 (3 steps at 1 and 3 update iterations, 6
steps of 5) and K10 at K 4,320 (b 2, FISTA 10; and with the stop at an
eps that stops it about half way).  ``diff`` prints max |a - b| of each
and whether they are bitwise equal, and exits 1 if any differs.
``time`` prints K10's ms per flagship solve (b 40, FISTA 100), K12's per
step (b 40, FISTA 25, a 3-step segment's mean), K11's per solve at the
flagship (b 40, FISTA 100; and with the stop), the serving geometry (b
40, FISTA 100) and s 576 (b 8, FISTA 25) (CUDA events, after a warm-up),
and the card's name and power limit: run it in two checkouts in turns to
compare their routes on one card.  ``split`` splits K11's solve at the
same geometries: the host's build of the operator and corr alone
(``operator_and_corr``, wall clock between synchronizations), the kernel
loop alone on a prebuilt operator (the wrapper's ``_launch``, CUDA
events; again after 20 loops back to back, after a second of idle, and
at lambda 0, where the codes stay dense), the whole solve (CUDA events),
and each ``gram_class_gemm`` launch's device time under torch.profiler
(count, sum, least, median, most); with the SM clock, its maximum and
the power that nvidia-smi reads before and after each geometry.  Needs a
CUDA device.
"""
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

LAM, ITERS, SEG_ITERS, STEP = 0.05, 100, 25, 0.05
K11_STOP_EPS = 2e-3  # stops K11's flagship solve part way


def windowed(rng, s, c, k, sigma):
  yy = np.arange(k) - (k - 1) / 2.0
  d = rng.randn(s, c, k, k) * np.exp(
      -(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * sigma ** 2))
  return d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))


def images(rng, gen, num, stride=8, codes=33):
  """(num, c, 272, 272) float32 conv-sparse images of ``gen`` (s, c, k,
  k) at ``stride`` (codes x codes code maps), a border of stride pixels
  zeroed."""
  shape = (num, gen.shape[0], codes, codes)
  z = rng.randn(*shape) * (rng.rand(*shape) < 0.02)
  x = F.conv_transpose2d(torch.from_numpy(z), torch.from_numpy(gen),
                         stride=stride).numpy()
  x = x + 0.01 * rng.randn(*x.shape)
  x[:, :, :stride] = x[:, :, -stride:] = 0.0
  x[:, :, :, :stride] = x[:, :, :, -stride:] = 0.0
  return torch.from_numpy(x.astype(np.float32))


def gram_problems(dev, serving_b):
  """K11's geometries past the flagship: (name, x, d, iters, eta scale,
  kw) for the serving geometry (serving_b images of 3x288x288, 64
  windowed 3x32x32 kernels at stride 16) and s > 512 (576 windowed 16x16
  kernels at stride 8 on 272x272 images); both halve the stepsize of the
  flattened kernels at s 576, whose conv operator's L is the larger."""
  rng = np.random.RandomState(25)
  gen3 = windowed(rng, 64, 3, 32, 6.0)
  x3 = images(rng, gen3, serving_b, stride=16, codes=17)
  gen576 = windowed(rng, 576, 1, 16, 3.0)
  x576 = images(rng, windowed(rng, 64, 1, 16, 3.0), 8)
  pad16 = dict(kernel_stride=(16, 16), padding=((16, 16), (16, 16)))
  pad8 = dict(kernel_stride=(8, 8), padding=((8, 8), (8, 8)))
  f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
  return [("serving", x3.to(dev), f32(gen3), ITERS, 1.0, pad16),
          ("s576", x576.to(dev), f32(gen576), SEG_ITERS, 0.5, pad8)]


def collect(value, out, key):
  if torch.is_tensor(value):
    out[key] = value.detach().cpu()
  elif isinstance(value, (tuple, list)):
    for i, v in enumerate(value):
      collect(v, out, "%s.%d" % (key, i))


def run(path):
  sys.path.insert(0, os.getcwd())
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.ops import fused_conv_direct as K10
  from vtc_tpu_torch.ops import fused_conv_dp_train as K17
  from vtc_tpu_torch.ops import fused_conv_fista as K11
  from vtc_tpu_torch.ops import fused_conv_train as K12
  from vtc_tpu_torch.ops import lipschitz
  dev = torch.device("cuda", 0)
  rng = np.random.RandomState(0)
  gen = windowed(rng, 64, 1, 16, 3.0)
  x = images(rng, gen, 40).to(dev)
  seg = images(rng, gen, 120).reshape(3, 40, 1, 272, 272).to(dev)
  d = torch.tensor(gen, dtype=torch.float32, device=dev)
  d5 = torch.tensor(windowed(rng, 64, 1, 16, 1e9), dtype=torch.float32,
                    device=dev)
  sd0 = torch.tensor(windowed(rng, 64, 1, 16, 3.0), dtype=torch.float32,
                     device=dev)
  xr = torch.tensor(np.pad(0.3 * rng.randn(3, 3, 50, 38),
                           ((0, 0), (0, 0), (4, 4), (4, 4))),
                    dtype=torch.float32, device=dev)
  dr = torch.tensor(windowed(rng, 40, 3, 6, 1.5), dtype=torch.float32,
                    device=dev)
  kw = dict(kernel_stride=(8, 8), padding=((8, 8), (8, 8)))
  step = lambda dd: lipschitz.fista_stepsize(dd.reshape(dd.shape[0], -1))
  out = {}
  with torch.no_grad():
    collect(K10.fused_conv_direct_solve(x, d, LAM, ITERS, step(d), **kw),
            out, "K10 flagship")
    collect(K10.fused_conv_direct_solve(x[:5], d5, LAM, SEG_ITERS, step(d5),
                                        variant="ista", **kw),
            out, "K10 b5 ista")
    collect(K10.fused_conv_direct_solve(
        xr, dr, LAM, 20, 0.5 * step(dr), kernel_stride=(2, 2),
        padding=((4, 4), (4, 4))), out, "K10 ragged")
    collect(K11.fused_conv_fista_solve(x, d, LAM, ITERS, step(d), **kw), out,
            "K11 flagship")
    collect((K11.fused_conv_fista_solve(x, d, LAM, ITERS, step(d),
                                        early_stopping_epsilon=K11_STOP_EPS,
                                        **kw), K11.last_iters),
            out, "K11 flagship stop")
    for name, xg, dg, iters, scale, gkw in gram_problems(dev, 4):
      collect(K11.fused_conv_fista_solve(xg[:4 if name == "serving" else 2],
                                         dg, LAM, iters, scale * step(dg),
                                         **gkw), out, "K11 " + name)
    for name, xs, ds, skw in (
        ("5x7/(2,3)", 0.3 * rng.randn(3, 2, 17, 22), windowed(
            rng, 6, 2, 7, 2.0)[:, :, 1:6],
         dict(kernel_stride=(2, 3), padding=((3, 2), (4, 4)))),
        ("columns", 0.3 * rng.randn(2, 1, 12, 20), windowed(rng, 6, 1, 4,
                                                             1.5),
         dict(kernel_stride=(2, 2), padding=((0, 0), (2, 2))))):
      xs = torch.tensor(xs, dtype=torch.float32, device=dev)
      ds = torch.tensor(ds / np.sqrt((ds ** 2).sum(axis=(1, 2, 3),
                                                   keepdims=True)),
                        dtype=torch.float32, device=dev)
      for nonneg, hard in ((False, True), (True, False)):
        collect(K11.fused_conv_fista_solve(
            xs, ds, 0.03, 15, 0.5 * step(ds), variant="ista", nonneg=nonneg,
            hard=hard, **skw), out, "K11 %s nonneg=%s hard=%s" % (
                name, nonneg, hard))
    h0 = torch.zeros(64, device=dev)
    v0 = lipschitz.top_gram_eigenpair(sd0.reshape(64, -1))[1].contiguous()
    skw = dict(kw, power_iters=2)
    collect(K12.fused_conv_train_segment(sd0, h0, v0, seg, LAM, SEG_ITERS,
                                         STEP, **skw), out, "K12 3 steps")
    for gram in (False, True):
      collect(K12.conv_solve_stats(sd0, v0, seg[0], LAM, SEG_ITERS,
                                   gram_stats=gram, **skw),
              out, "K13 gram=%s" % gram)
    mesh = parallel.make_mesh()
    for upd in (1, 3):
      collect(K17.fused_conv_dp_train_segment(
          sd0, h0, v0, seg, LAM, SEG_ITERS, STEP, upd_num_iters=upd,
          mesh=mesh, **skw), out, "K17 upd %d" % upd)
    collect(K17.fused_conv_dp_train_segment(
        sd0, h0, v0, seg.reshape(24, 5, 1, 272, 272)[:6], LAM, SEG_ITERS,
        STEP, mesh=mesh, **skw), out, "K17 b5")
    rng = np.random.RandomState(26)
    gen12 = windowed(rng, 480, 1, 12, 3.0)
    x12 = images(rng, gen12, 2, stride=4, codes=66).to(dev)
    d12 = torch.tensor(gen12, dtype=torch.float32, device=dev)
    kw12 = dict(kernel_stride=(4, 4), padding=((4, 4), (4, 4)))
    collect(K10.fused_conv_direct_solve(x12, d12, 0.5, 10, 0.25 * step(d12),
                                        **kw12), out, "K10 12x12/4 s480")
    collect((K10.fused_conv_direct_solve(
        x12, d12, 0.5, 10, 0.25 * step(d12), early_stopping_epsilon=0.075,
        **kw12), K10.last_iters), out, "K10 12x12/4 s480 stop")
  torch.save(out, path)
  print("saved %d outputs to %s" % (len(out), path))
  return 0


def k11_cases(dev):
  """K11's timed solves: (name, x, d, iters, eta scale, kw, eps) at the
  flagship (b 40, FISTA 100; and with the stop), the serving geometry (b
  40, FISTA 100) and s 576 (b 8, FISTA 25)."""
  rng = np.random.RandomState(0)
  gen = windowed(rng, 64, 1, 16, 3.0)
  x = images(rng, gen, 40).to(dev)
  d = torch.tensor(gen, dtype=torch.float32, device=dev)
  kw = dict(kernel_stride=(8, 8), padding=((8, 8), (8, 8)))
  cases = [("flagship b40 fista100", x, d, ITERS, 1.0, kw, None),
           ("flagship b40 fista100 stop", x, d, ITERS, 1.0, kw,
            K11_STOP_EPS)]
  for name, xg, dg, iters, scale, gkw in gram_problems(dev, 40):
    xg = xg if name == "serving" else xg[:8]
    label = ("serving 3x32x32/16 b40 fista100" if name == "serving"
             else "s576 b8 fista25")
    cases.append((label, xg, dg, iters, scale, gkw, None))
  return cases


def time_kernels():
  sys.path.insert(0, os.getcwd())
  import chip_smoke
  from vtc_tpu_torch.ops import fused_conv_direct as K10
  from vtc_tpu_torch.ops import fused_conv_fista as K11
  from vtc_tpu_torch.ops import fused_conv_train as K12
  from vtc_tpu_torch.ops import lipschitz
  dev = torch.device("cuda", 0)
  step = lambda dd: lipschitz.fista_stepsize(dd.reshape(dd.shape[0], -1))
  start, stop = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
  with torch.no_grad():
    # K10 at the flagship and a K12 step (a 3-step segment's mean)
    rng = np.random.RandomState(0)
    gen = windowed(rng, 64, 1, 16, 3.0)
    x = images(rng, gen, 40).to(dev)
    seg = images(rng, gen, 120).reshape(3, 40, 1, 272, 272).to(dev)
    d = torch.tensor(gen, dtype=torch.float32, device=dev)
    kw = dict(kernel_stride=(8, 8), padding=((8, 8), (8, 8)))
    h0 = torch.zeros(64, device=dev)
    v0 = lipschitz.top_gram_eigenpair(d.reshape(64, -1))[1].contiguous()
    for name, fn, reps, per in (
        ("K10 flagship b40 fista100", lambda: K10.fused_conv_direct_solve(
            x, d, LAM, ITERS, step(d), **kw), 3, 1),
        ("K12 step b40 fista25", lambda: K12.fused_conv_train_segment(
            d, h0, v0, seg, LAM, SEG_ITERS, STEP, power_iters=2, **kw), 3,
         3)):
      fn()
      start.record()
      for _ in range(reps):
        fn()
      stop.record()
      stop.synchronize()
      print("%s: %.4f ms" % (name, start.elapsed_time(stop) / reps / per))
    for name, xg, dg, iters, scale, gkw, eps in k11_cases(dev):
      eta = scale * step(dg)
      fn = lambda: K11.fused_conv_fista_solve(
          xg, dg, LAM, iters, eta, early_stopping_epsilon=eps, **gkw)
      fn()
      reps = 2 if name.startswith("s576") else 3
      start.record()
      for _ in range(reps):
        fn()
      stop.record()
      stop.synchronize()
      count = "" if eps is None else " at %d iterations" % int(
          K11.last_iters.item())
      print("K11 %s: %.4f ms%s" % (name, start.elapsed_time(stop) / reps,
                                   count))
  print(chip_smoke.card_line())
  return 0


def clocks():
  """The SM clock, its maximum and the power draw, as nvidia-smi reads
  them."""
  return subprocess.run(
      ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
       "--format=csv,noheader"], capture_output=True, text=True,
      check=False, timeout=60).stdout.strip()


def event_ms(fn, reps=1):
  """Device ms of reps calls of fn from a synchronized start, a call."""
  start, stop = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  stop.synchronize()
  return start.elapsed_time(stop) / reps


def split_k11():
  sys.path.insert(0, os.getcwd())
  import chip_smoke
  from vtc_tpu_torch.ops import fused_conv_fista as K11
  from vtc_tpu_torch.ops import lipschitz
  dev = torch.device("cuda", 0)
  step = lambda dd: lipschitz.fista_stepsize(dd.reshape(dd.shape[0], -1))
  fmt = lambda v: ", ".join("%.4f" % t for t in v)
  with torch.no_grad():
    for name, xg, dg, iters, scale, gkw, eps in k11_cases(dev):
      if eps is not None:
        continue
      eta = (scale * step(dg)).reshape(1).contiguous()
      solve = lambda: K11.fused_conv_fista_solve(xg, dg, LAM, iters, eta,
                                                 **gkw)
      op, corr = K11.operator_and_corr(xg, dg, gkw["kernel_stride"],
                                       gkw["padding"])
      corr = corr.contiguous()
      loop = lambda lam=LAM: K11._launch(op, corr, eta, lam, iters, True, 0,
                                         torch.zeros_like(corr))
      solve()
      loop()
      before = clocks()
      build = []
      for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        K11.operator_and_corr(xg, dg, gkw["kernel_stride"], gkw["padding"])
        torch.cuda.synchronize()
        build.append(1e3 * (time.perf_counter() - t0))
      loops = [event_ms(loop) for _ in range(5)]
      solves = [event_ms(solve) for _ in range(5)]
      launches = sorted(
          (e.time_range.end - e.time_range.start) / 1e3
          for e in chip_smoke.device_events(torch, loop)
          if "gram_class_gemm" in e.name)
      for _ in range(20):
        loop()
      warm = event_ms(loop, 5)
      time.sleep(1.0)
      idle = event_ms(loop)
      dense = event_ms(lambda: loop(0.0), 3)
      after = clocks()
      print("K11 %s: operator build %s ms (host, synchronized); loop "
            "alone %s ms; whole solve %s ms; loop after 20 loops %.4f, "
            "after 1 s idle %.4f, at lambda 0 (dense codes) %.4f" % (
                name, fmt(build), fmt(loops), fmt(solves), warm, idle,
                dense))
      print("K11 %s: profiled %d gram_class_gemm launches, %.4f ms in all, "
            "least %.4f, median %.4f, most %.4f ms; SM clock, its maximum, "
            "power: before %s, after %s" % (
                name, len(launches), sum(launches), launches[0],
                statistics.median(launches), launches[-1], before, after))
  print(chip_smoke.card_line())
  return 0


def diff(path_a, path_b):
  a, b = torch.load(path_a), torch.load(path_b)
  if sorted(a) != sorted(b):
    print("the runs saved different outputs")
    return 1
  differ = 0
  for key in a:
    equal = torch.equal(a[key], b[key])
    differ += not equal
    err = float((a[key].double() - b[key].double()).abs().max()
                ) if a[key].numel() else 0.0
    print("%-22s %-18s max|d| %.3e %s" % (
        key, tuple(a[key].shape), err, "bitwise equal" if equal else
        "DIFFERS"))
  print("%d of %d outputs differ" % (differ, len(a)))
  return 1 if differ else 0


if __name__ == "__main__":
  if len(sys.argv) == 3 and sys.argv[1] == "run":
    sys.exit(run(sys.argv[2]))
  if len(sys.argv) == 4 and sys.argv[1] == "diff":
    sys.exit(diff(sys.argv[2], sys.argv[3]))
  if len(sys.argv) == 2 and sys.argv[1] == "time":
    sys.exit(time_kernels())
  if len(sys.argv) == 2 and sys.argv[1] == "split":
    sys.exit(split_k11())
  sys.exit(__doc__)
