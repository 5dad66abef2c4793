"""Time the ICA train step's two routes alone, on one CUDA device.

  python3 tools/bench_ica_step.py [--out report.txt]

Compiles tools/bench_ica_step.cu against vtc_tpu_torch/csrc/
fused_ica_train_step.cu (which includes ica_segment.cuh) with nvcc (for
sm_90a, with ptxas's register report) into vtc_tpu_torch/_build/, runs it,
and prints the registers and spills of the persistent segment kernel, the
per-step product kernels and the barrier kernel; then, at n 256, b 250,
refine 3, upd 1 with the boost armed: µs a step of the per-step route and
of the persistent route (in turns steps, persistent, persistent, steps),
whether their D, X and r_max are bitwise equal, µs a refresh phase, µs a
grid barrier alone; and the card's name and power limit.  Every line is
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

KERNELS = ("ica_segment_kernel", "gemm_kernel", "barrier_kernel",
           "part_kernel", "other_tile_kernel")


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  nvcc = _build.find_nvcc()
  if nvcc is None:
    print("bench_ica_step: nvcc not found", file=sys.stderr)
    return 1
  here = os.path.dirname(os.path.abspath(__file__))
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  binary = str(_build.BUILD_DIR / "bench_ica_step")
  built = subprocess.run(
      [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC),
       "-o", binary, os.path.join(here, "bench_ica_step.cu")],
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
  lines += run.stdout.splitlines() + [chip_smoke.card_line()]
  print("\n".join(lines))
  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  if run.returncode != 0:
    print(run.stderr, file=sys.stderr)
  return run.returncode


if __name__ == "__main__":
  sys.exit(main())
