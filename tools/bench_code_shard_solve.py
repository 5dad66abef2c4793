"""Time K19's residual-form solve on its two routes alone, on one CUDA
device.

  python3 tools/bench_code_shard_solve.py [--out report.txt]

Compiles tools/bench_code_shard_solve.cu against vtc_tpu_torch/csrc/
fused_code_shard_train_step.cu (which includes code_shard_solve.cuh) with
nvcc (for sm_90a, with ptxas's register report) into
vtc_tpu_torch/_build/, runs it, and prints the registers and spills of the
persistent solve kernel, the per-step route's product kernels and the
phase kernels; then, at bench.py's big-dictionary shape (s 2048, n 256,
b 128, FISTA 25, fc and 512 x 4 groups): us a step of each route in
turns, whether their outputs are bitwise equal, us an iteration, phase A,
its product and its split sum, phase B and the grid barrier alone.  Then,
as the library yardstick of the solve's two products, torch.matmul in
fp32 (TF32 off) on the same shapes: z (128, 2048) @ D (2048, 256) and
r (128, 256) @ D^T; and the card's name and power limit.  Every line is
printed, and written to --out when given.  Exits non-zero when the two
routes differ.  Needs nvcc and a CUDA device.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the card's line)
from vtc_tpu_torch.ops import _build  # noqa: E402

KERNELS = ("code_shard_solve_kernel", "grad_prox_kernel",
           "recon_partial_kernel", "phase_kernel")


def matmul_yardstick():
  """us of torch.matmul in fp32 (TF32 off) on the solve's two products at
  b 128, s 2048, n 256, the best of 3 timings of 200 calls each."""
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  g = torch.Generator(device="cuda").manual_seed(15)
  z = torch.randn(128, 2048, device="cuda", generator=g)
  d = torch.randn(2048, 256, device="cuda", generator=g)
  r = torch.randn(128, 256, device="cuda", generator=g)
  lines = []
  for label, fn in (("z (128, 2048) @ D (2048, 256)", lambda: z @ d),
                    ("r (128, 256) @ D^T (256, 2048)", lambda: r @ d.T)):
    for _ in range(20):
      fn()
    best = float("inf")
    for _ in range(3):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      for _ in range(200):
        fn()
      end.record()
      torch.cuda.synchronize()
      best = min(best, start.elapsed_time(end) * 1e3 / 200)
    lines.append("torch.matmul fp32 (TF32 off) %s: %.3f us a call, %.2f "
                 "TFLOP/s" % (label, best, 2 * 128 * 2048 * 256 / best / 1e6))
  return lines


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  nvcc = _build.find_nvcc()
  if nvcc is None:
    print("bench_code_shard_solve: nvcc not found", file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  binary = str(_build.BUILD_DIR / "bench_code_shard_solve")
  built = subprocess.run(
      [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
       "-o", binary, os.path.join(here, "bench_code_shard_solve.cu")],
      capture_output=True, text=True, check=False)
  if built.returncode != 0:
    print(built.stdout + built.stderr, file=sys.stderr)
    return 1
  lines, kernel = [], None
  for line in (built.stdout + built.stderr).splitlines():
    if "Compiling entry function" in line:
      name = line.split("'")[1]
      kernel = name if any(k in name for k in KERNELS) else None
    elif kernel and ("registers" in line or "spill" in line):
      lines.append("%s: %s" % (kernel, line.split(":", 1)[-1].strip()))
  run = subprocess.run([binary], capture_output=True, text=True,
                       check=False, timeout=600)
  lines += run.stdout.splitlines() + matmul_yardstick()
  lines.append(chip_smoke.card_line())
  print("\n".join(lines))
  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  if run.returncode != 0:
    print(run.stderr, file=sys.stderr)
  return run.returncode


if __name__ == "__main__":
  sys.exit(main())
