"""Time the fc/subspace solve kernels alone, on one CUDA device.

  python3 tools/bench_fista_solve.py [--out report.txt] [--tier]

Compiles tools/bench_fista_solve.cu against vtc_tpu_torch/csrc/
fista_core.cuh with nvcc (for sm_90a, with ptxas's register report) into
vtc_tpu_torch/_build/, runs it, and prints the registers, spills and
shared memory of the solve kernels; then, at s 256 and FISTA, for b 125
and 250 (the cluster route) and 1100, 2048 and 4096 (the wide route),
elementwise and with groups of 4: ms per solve at 25 and 125 iterations
and µs per iteration of fista_kernel and of the batch's route's kernel,
and whether their codes are bitwise equal; then that kernel's layout
and what its iteration costs in parts (the barrier alone, the exchange
with the barrier, the product alone); then the iteration's product as
one torch.matmul (cuBLAS, fp32 with TF32 off) at b 1100, 2048 and 4096;
and the card's name and power limit.  Then the early stop at each batch: µs
per iteration on the route the stop takes with eps 0 (it never stops, so
every iteration does the stop's work) beside the same route without it,
their codes bitwise equal, and the stop's exchange alone on the cluster
and wide grids.  Every line is printed, and written to --out when given.
Exits non-zero when two kernels' codes differ.  With --tier it times the
tier layouts instead (fista_tier_kernel against each candidate layout of
fista_tier_cluster_kernel, bitwise; the header of bench_fista_solve.cu
says which).
Needs nvcc and a CUDA device.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the card's line)
from vtc_tpu_torch.ops import _build  # noqa: E402

KERNELS = ("fista_cluster_kernel", "fista_wide_kernel", "fista_kernel",
           "exchange_kernel", "product_kernel", "fista_tier_kernel",
           "fista_tier_cluster_kernel")  # and the stop builds


def library_lines():
  """µs of one torch.matmul (cuBLAS) of an iteration's (b, 256) @
  (256, 256) product in fp32, TF32 off, at each wide-route batch."""
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  gen = torch.Generator().manual_seed(0)
  g = torch.randn(256, 256, generator=gen).cuda()
  lines = []
  for b in (1100, 2048, 4096):
    z = torch.randn(b, 256, generator=gen).cuda()
    torch.matmul(z, g)
    start, stop = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
    start.record()
    for _ in range(100):
      torch.matmul(z, g)
    stop.record()
    stop.synchronize()
    lines.append("b %4d torch.matmul (%d x 256) @ (256 x 256), fp32, TF32 "
                 "off: %.3f us a product" % (b, b, start.elapsed_time(stop)
                                             * 10.0))
  return lines


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", help="also write the report here")
  parser.add_argument("--tier", action="store_true",
                      help="time the tier layouts (fista_tier.cuh)")
  args = parser.parse_args()
  nvcc = _build.find_nvcc()
  if nvcc is None:
    print("bench_fista_solve: nvcc not found", file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  binary = str(_build.BUILD_DIR / "bench_fista_solve")
  built = subprocess.run(
      [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
       "-o", binary, os.path.join(here, "bench_fista_solve.cu")],
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
  run = subprocess.run([binary] + (["tier"] if args.tier else []),
                       capture_output=True, text=True, check=False,
                       timeout=600)
  lines += run.stdout.splitlines() + ([] if args.tier else library_lines())
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
