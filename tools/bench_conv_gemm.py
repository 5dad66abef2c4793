"""Time the conv family's gathered GEMM kernels alone, on one CUDA device.

  python3 tools/bench_conv_gemm.py [--out report.txt]

Compiles tools/bench_conv_gemm.cu against vtc_tpu_torch/csrc/
conv_gemm.cuh with nvcc (for sm_90a, with ptxas's register report) into
vtc_tpu_torch/_build/, runs it, and prints the registers and spills of
the GEMM kernels, then ms per launch and TFLOP/s of the tiled and the
line kernel for K10's flagship synthesis and analysis at batches 40 and
5, and the card's name and power limit.  Every line is printed, and
written to --out when given.  Needs nvcc and a CUDA device.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the card's line)
from vtc_tpu_torch.ops import _build  # noqa: E402


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  nvcc = _build.find_nvcc()
  if nvcc is None:
    print("bench_conv_gemm: nvcc not found", file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  binary = str(_build.BUILD_DIR / "bench_conv_gemm")
  built = subprocess.run(
      [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
       "-o", binary, os.path.join(here, "bench_conv_gemm.cu")],
      capture_output=True, text=True, check=False)
  if built.returncode != 0:
    print(built.stdout + built.stderr, file=sys.stderr)
    return 1
  lines, kernel = [], None
  for line in (built.stdout + built.stderr).splitlines():
    if "Compiling entry function" in line:
      kernel = line.split("'")[1] if "gather_gemm" in line else None
    elif kernel and ("registers" in line or "spill" in line):
      lines.append("%s: %s" % (kernel, line.split(":", 1)[-1].strip()))
  run = subprocess.run([binary], capture_output=True, text=True,
                       check=False, timeout=300)
  lines += run.stdout.splitlines() + [chip_smoke.card_line()]
  print("\n".join(lines))
  if run.returncode != 0:
    print(run.stderr, file=sys.stderr)
    return run.returncode
  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
