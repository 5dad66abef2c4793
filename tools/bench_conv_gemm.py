"""Time the conv family's gathered GEMM kernels alone, on one CUDA device.

  python3 tools/bench_conv_gemm.py [--tier] [--out report.txt]

Compiles tools/bench_conv_gemm.cu against vtc_tpu_torch/csrc/
conv_gemm.cuh and conv_gram_tiles.cuh with nvcc (for sm_90a, with ptxas's
register report) into vtc_tpu_torch/_build/, runs it, and prints the
registers and spills of the GEMM kernels, then ms per launch and TFLOP/s
of the tiled kernel and gather_gemm for K10's flagship synthesis and
analysis at batches 40 and 5, of K11's gram_class_gemm for one iteration
at the flagship, at the serving geometry (3x32x32 kernels at stride 16)
and at 576 kernels, in the plans of ops/fused_conv_fista.class_plan, and
the card's name and power limit.  Every line is printed, and
written to --out when given.  Needs nvcc and a CUDA device.

With --tier it builds the binary five times, once per
VTC_CONV_TIER_PARTS (1: the operands' copies only, 2: and the split into
bf16 terms, 3: and the mma passes, 4: and the epilogue, the library's
build; 5: the window route's math warps alone), all five compiles started
together, and times each of the tier
GEMM's routes (gather_gemm_tier and the window route of
csrc/conv_gemm_tier.cuh, each forced) at the flagship's corr, synthesis
and analysis, b 40, b 20 (K13's shard) and b 5 (the full build: b 5 to
40 in steps of 5, where the routes cross), at bf16, bf16x3 and bf16x5;
ptxas's registers and spills of the full build and each kernel's CTAs an
SM come first.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the card's line)
from vtc_tpu_torch.ops import _build, fused_conv_fista  # noqa: E402

# K11 at the flagship, the serving geometry and s 576: (b, s, n), n x n
# codes whose first and last rows and columns are special
GRAM_GEOMETRIES = ((40, 64, 33), (40, 64, 17), (8, 576, 33))


def write_plans(path):
  """K11's plans at GRAM_GEOMETRIES as the int32 values that
  bench_conv_gemm.cu reads: per geometry b, s, n, tiles, work items and
  those of tiles of several passes, then the slots, class words and work
  items."""
  import torch
  values = []
  for b, s, n in GRAM_GEOMETRIES:
    slots, words, items, multi = fused_conv_fista.class_plan(
        (0, n - 1), (0, n - 1), b, n, n)
    values += [torch.tensor([b, s, n, words.numel(), items.numel(), multi],
                            dtype=torch.int32), slots, words, items]
  torch.cat(values).numpy().tofile(path)


def compile_binaries(nvcc, parts):
  """Build bench_conv_gemm.cu once per VTC_CONV_TIER_PARTS value in
  ``parts`` (None: the library's build), all started together; returns
  ([binary], ptxas's register and spill lines of the last build) or raises
  with the compiler's output."""
  here = os.path.dirname(os.path.abspath(__file__))
  _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
  binaries, procs = [], []
  for part in parts:
    binary = str(_build.BUILD_DIR / ("bench_conv_gemm" if part is None
                                     else "bench_conv_gemm_parts%d" % part))
    flags = [] if part is None else ["-DVTC_CONV_TIER_PARTS=%d" % part]
    binaries.append(binary)
    procs.append(subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-o", binary,
         os.path.join(here, "bench_conv_gemm.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  outputs = [proc.communicate()[0] for proc in procs]
  for proc, out in zip(procs, outputs):
    if proc.returncode != 0:
      raise RuntimeError("nvcc failed:\n" + out)
  lines, kernel = [], None
  for line in outputs[-1].splitlines():
    if "Compiling entry function" in line:
      kernel = line.split("'")[1] if ("gather_gemm" in line
                                      or "gram_class_gemm" in line
                                      or "window" in line) else None
    elif kernel and ("registers" in line or "spill" in line):
      lines.append("%s: %s" % (kernel, line.split(":", 1)[-1].strip()))
  return binaries, lines


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--tier", action="store_true",
                      help="time the tier GEMM's routes and their parts")
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  nvcc = _build.find_nvcc()
  if nvcc is None:
    print("bench_conv_gemm: nvcc not found", file=sys.stderr)
    return 1
  binaries, lines = compile_binaries(
      nvcc, (1, 2, 3, 5, 4) if args.tier else (None,))
  if args.tier:
    runs = [[binary, "--tier"] for binary in binaries]
  else:
    plans = str(_build.BUILD_DIR / "bench_conv_gemm_plans.bin")
    write_plans(plans)
    runs = [[binaries[0], plans]]
  for cmd in runs:
    run = subprocess.run(cmd, capture_output=True, text=True, check=False,
                         timeout=300)
    lines += run.stdout.splitlines()
    if run.returncode != 0:
      print("\n".join(lines))
      print(run.stderr, file=sys.stderr)
      return run.returncode
  lines.append(chip_smoke.card_line())
  print("\n".join(lines))
  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
