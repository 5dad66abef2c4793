"""Compare the tier kernel (csrc/fista_tier.cuh) of this checkout with that
of another kernel source directory, in one process on one card.

  python3 tools/compare_tier_builds.py OTHER_CSRC [OTHER_BUILD_DIR]

From a checkout's root.  It builds this checkout's kernels with ptxas's
report (-Xptxas -v) and prints each fista_tier_kernel build's registers
and spills and the build's seconds, then builds OTHER_CSRC's (a copy of
another checkout's vtc_tpu_torch/csrc, whose C entries take the same
arguments) into OTHER_BUILD_DIR (default: a directory beside it).  For
K1 (FISTA soft, ISTA hard) and K4 (groups of 4) at b 2048, s 256, FISTA
100, and K2 and K6 over a 20-step segment at b 250, FISTA 25, each tier:
whether the two builds give the same bits, and their times in turns
(other, this, this, other; 10 calls each).  Inputs are made from fixed
seeds: sparse mixtures of a random unit-norm dictionary plus noise.
Needs a CUDA device and nvcc.
"""
import contextlib
import io
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path.cwd()))

from vtc_tpu_torch.ops import _build  # noqa: E402
from vtc_tpu_torch.ops import fused_fista as K1  # noqa: E402
from vtc_tpu_torch.ops import fused_group_fista as K4  # noqa: E402
from vtc_tpu_torch.ops import fused_group_train_step as K6  # noqa: E402
from vtc_tpu_torch.ops import fused_train_step as K2  # noqa: E402
from vtc_tpu_torch.ops import lipschitz  # noqa: E402
from vtc_tpu_torch.ops.precision import matmul_precision  # noqa: E402

TIERS = ("bf16", "bf16x3", "bf16x5")
LAM, ITERS, SEG_ITERS, STEP = 0.008, 100, 25, 0.05


def tier_registers(ptxas):
  """{'fista_tier_kernel<...>': (registers, 'spill stores/loads')} from
  ptxas's report."""
  fn, out = None, {}
  for line in ptxas.splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
      fn = m.group(1)
      continue
    if fn is None or "fista_tier_kernel" not in fn:
      continue
    name = re.search(r"fista_tier_kernel<[^>]*>", subprocess.run(
        ["c++filt", fn], capture_output=True, text=True).stdout).group(0)
    regs, spill = out.get(name, (0, ""))
    m = re.search(r"Used (\d+) registers", line)
    if m:
      regs = int(m.group(1))
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
    if m:
      spill = "%s/%s" % m.groups()
    out[name] = (regs, spill)
  return out


def time_ms(fn, reps=10):
  start, stop = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  stop.synchronize()
  return start.elapsed_time(stop) / reps


def main(argv):
  if len(argv) not in (2, 3) or not torch.cuda.is_available():
    sys.exit(__doc__)
  other_csrc = Path(argv[1]).resolve()
  other_build = Path(argv[2] if len(argv) == 3
                     else str(other_csrc) + "_build").resolve()
  print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
  t0 = time.perf_counter()
  report = io.StringIO()
  with contextlib.redirect_stdout(report):
    _build.build(verbose=True)
  print("this build: %.1f s" % (time.perf_counter() - t0))
  for name, (regs, spill) in sorted(tier_registers(report.getvalue()).items()):
    print("  %s: %d registers, spill stores/loads %s" % (name, regs, spill))
  this = _build.load_library()
  csrc, build_dir = _build.CSRC, _build.BUILD_DIR
  _build.CSRC, _build.BUILD_DIR = other_csrc, other_build
  t0 = time.perf_counter()
  other = _build.load_library.__wrapped__()
  print("other build: %.1f s" % (time.perf_counter() - t0))
  _build.CSRC, _build.BUILD_DIR = csrc, build_dir
  load = _build.load_library

  dev = torch.device("cuda", 0)
  rng = np.random.RandomState(20)
  gen = rng.randn(256, 256)
  gen /= np.linalg.norm(gen, axis=1, keepdims=True)
  mix = rng.randn(2048 + 20 * 250, 256) * (rng.rand(2048 + 20 * 250, 256)
                                           < 0.05)
  patches = (mix @ gen + 0.01 * rng.randn(*mix.shape)).astype(np.float32)
  d = rng.randn(256, 256)
  d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True),
                   dtype=torch.float32, device=dev)
  x = torch.tensor(patches[:2048], device=dev)
  tx = torch.tensor(patches[2048:], device=dev).reshape(20, 250, 256)
  eta = lipschitz.fista_stepsize(d).reshape(1).float().contiguous()
  with matmul_precision():
    gram, corr = (d @ d.T).contiguous(), (x @ d.T).contiguous()
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  groups = [list(range(i, i + 4)) for i in range(0, 256, 4)]
  cases = {
      "K1 fista soft": lambda mxu: K1._launch(gram, corr, None, eta, LAM,
                                              ITERS, True, 0, mxu=mxu),
      "K1 ista hard": lambda mxu: K1._launch(gram, corr, None, eta, LAM,
                                             ITERS, False, 2, mxu=mxu),
      "K4 groups of 4": lambda mxu: K4._launch(gram, corr, None, eta, LAM,
                                               ITERS, 4, True, False,
                                               mxu=mxu),
      "K2 20 steps": lambda mxu: K2.fused_train_segment(
          d, h, v, tx, LAM, SEG_ITERS, STEP, power_iters=2, mxu=mxu),
      "K6 20 steps": lambda mxu: K6.fused_group_train_segment(
          d, h, v, tx, LAM, SEG_ITERS, STEP, group_assignments=groups,
          power_iters=2, mxu=mxu),
  }

  def flat(out):
    return out if torch.is_tensor(out) else torch.cat(
        [o.reshape(-1) for o in out])

  try:
    with torch.no_grad():
      for name, fn in cases.items():
        for tier in TIERS:
          outs = []
          for lib in (other, this):
            _build.load_library = lambda lib=lib: lib
            outs.append(flat(fn(tier)))
          turns = []
          for lib in (other, this, this, other):
            _build.load_library = lambda lib=lib: lib
            turns.append(time_ms(lambda: fn(tier)))
          print("%s %s: this %.4f ms, other %.4f (turns %s); bitwise %s" % (
              name, tier, (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2,
              " ".join("%.4f" % t for t in turns),
              torch.equal(outs[0], outs[1])))
  finally:
    _build.load_library = load


if __name__ == "__main__":
  main(sys.argv)
