"""Smoke run of the PyTorch/CUDA port (vtc_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Drives the port's serving path -- fully-connected sparse encoding at the
flagship width (16x16 patches, n = 256, 256 atoms, batch 2048,
100 FISTA iterations, lambda 0.008; examples/encode_dataset.py:27-32) --
through its public entry points, in four phases.  Any failure ends the
run with a non-zero exit; nothing is caught.

1. Device and build: requires CUDA (there is no CPU path), prints the
   card's name and power limit, builds the kernels from
   vtc_tpu_torch/csrc/ and prints the build time.
2. Kernel against plain: the fused FISTA kernel against its plain
   PyTorch version in float32 and in float64, on the card, at the
   flagship batch, the trainer's batch of 250, a ragged 13 x 37 x 24
   problem and an overcomplete s = 1024 one (state in global memory);
   FISTA and ISTA, soft, hard and nonnegative, cold and warm starts.
   Tolerance: 1e-5 of the largest code, and never above 1e-4 absolute,
   the repo's parity contract.  Codes at the flagship are at most about
   0.25, so 1e-4 alone would pass a kernel with TF32 products; a
   control runs the plain version with TF32 products at the flagship
   and requires that it fail the limit.  Hard thresholds run at the
   ragged size only: they are discontinuous, and at batch 250 and up
   some pre-threshold value lands within rounding of lambda*eta, flips
   between float types and moves its code by the threshold itself, so
   a tight comparison is not well posed there.
3. The slice: encode_dataset over 16 batches of 2048 synthetic
   patches, then SparseCoder(formulation='pallas').encode; the kernel's
   launch count must equal the number of batch solves, the codes must
   be finite and one batch must match the plain version to the limit.
4. Timing with CUDA events after warm-up: kernel and plain time per
   flagship batch, encode patches/s.

The data are made here from a seed: sparse mixtures of a random
unit-norm generating dictionary plus noise, at the pixel scale of
whitened 16x16 image patches; the generating dictionary (seed 0)
stands in for a trained one.  The script imports nothing of the JAX
package, vtc_tpu, directly or through the port.

The line before the last is the card's name and power limit as
nvidia-smi reports them; the last line is the JSON result.
"""
import json
import subprocess
import sys
import time

import numpy as np

LAM = 0.008
ITERS = 100
BATCH = 2048
NUM_BATCHES = 16
TOL = 1e-4  # max |codes - plain|: the repo's parity contract (CLAUDE.md)
REL_TOL = 1e-5  # ... and at most this share of the largest code


def limit(codes):
  """The kernel-vs-plain tolerance for codes of this size."""
  return min(TOL, REL_TOL * float(abs(codes).max()))


def check(cond, message):
  if not cond:
    raise RuntimeError("chip_smoke: " + message)


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def unit_rows(rng, s, n):
  d = rng.randn(s, n).astype(np.float32)
  return d / np.linalg.norm(d, axis=1, keepdims=True)


def synthetic_patches(num, n=256, atoms=256, seed=0):
  """(num, n) sparse mixtures: 5% of the atoms of a random unit-norm
  dictionary active per patch with N(0, 0.05^2) amplitudes, plus
  N(0, 0.003^2) pixel noise -- a per-pixel spread near 0.012, that of
  whitened natural-image patches."""
  rng = np.random.RandomState(seed)
  gen = unit_rows(rng, atoms, n)
  amps = rng.randn(num, atoms) * 0.05 * (rng.rand(num, atoms) < 0.05)
  return (amps @ gen + 0.003 * rng.randn(num, n)).astype(np.float32)


def kernel_cases(torch, fused_fista, lipschitz, patches, dev):
  """Phase 2: kernel against the fp32 and fp64 plain versions."""
  rng = np.random.RandomState(1)
  flag_d = unit_rows(np.random.RandomState(0), 256, 256)
  over_d = unit_rows(rng, 1024, 256)
  rag_d = unit_rows(rng, 37, 24)
  rag_x = rng.randn(13, 24).astype(np.float32)
  # (name, images, dictionary, lambda, iters, variant, nonneg, hard, warm)
  cases = [
      ("flagship fista soft", patches[:BATCH], flag_d, LAM, ITERS,
       "fista", False, False, False),
      ("flagship ista soft", patches[:BATCH], flag_d, LAM, ITERS,
       "ista", False, False, False),
      ("b250 fista nonneg", patches[:250], flag_d, LAM, 25,
       "fista", True, False, False),
      ("b250 ista soft warm", patches[:250], flag_d, LAM, 25,
       "ista", False, False, True),
      ("b250 fista soft warm", patches[:250], flag_d, LAM, 25,
       "fista", False, False, True),
      ("ragged 13x37x24 fista soft warm", rag_x, rag_d, 0.08, 20,
       "fista", False, False, True),
      ("ragged 13x37x24 fista hard", rag_x, rag_d, 0.08, 20,
       "fista", False, True, False),
      ("ragged 13x37x24 ista hard", rag_x, rag_d, 0.08, 20,
       "ista", False, True, False),
      ("ragged 13x37x24 fista nonneg-hard warm", rag_x, rag_d, 0.08, 20,
       "fista", True, True, True),
      ("overcomplete b64 s1024 fista soft", patches[:64], over_d, LAM, 25,
       "fista", False, False, False),
  ]
  worst = 0.0
  for name, x, d, lam, iters, variant, nonneg, hard, warm in cases:
    x = torch.tensor(x, device=dev)
    d = torch.tensor(d, device=dev)
    eta = lipschitz.fista_stepsize(d)
    flags = dict(variant=variant, nonneg=nonneg, hard=hard)
    init = None
    if warm:
      init = fused_fista.fused_fista_plain(x, d, lam, 10, eta,
                                           **flags).contiguous()
    got = fused_fista.fused_fista_solve(x, d, lam, iters, eta,
                                        initial_codes=init, **flags)
    want32 = fused_fista.fused_fista_plain(x, d, lam, iters, eta,
                                           initial_codes=init, **flags)
    want64 = fused_fista.fused_fista_plain(
        x.double(), d.double(), lam, iters, eta.double(),
        initial_codes=None if init is None else init.double(), **flags)
    torch.cuda.synchronize()
    err32 = float((got - want32).abs().max())
    err64 = float((got.double() - want64).abs().max())
    lim = limit(want64)
    print("kernel vs plain  %-36s max|d| fp32 %.3e  fp64 %.3e  "
          "limit %.3e (max|code| %.3f)" % (name, err32, err64, lim,
                                            float(want64.abs().max())))
    check(bool(torch.isfinite(got).all()), name + ": non-finite codes")
    check(err32 <= lim and err64 <= lim,
          "%s: kernel differs from plain by %.3e / %.3e, limit %.3e" % (
              name, err32, err64, lim))
    worst = max(worst, err32)

  # control: TF32 products at the flagship must fail the limit
  x = torch.tensor(patches[:BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  eta = lipschitz.fista_stepsize(d)
  want64 = fused_fista.fused_fista_plain(x.double(), d.double(), LAM, ITERS,
                                         eta.double())
  tf32 = fused_fista.fused_fista_plain(x, d, LAM, ITERS, eta,
                                       precision="tensorfloat32")
  err = float((tf32.double() - want64).abs().max())
  lim = limit(want64)
  print("control: plain with TF32 products, flagship fista soft: max|d| "
        "fp64 %.3e, limit %.3e (must fail it)" % (err, lim))
  check(err > lim, "the limit does not tell TF32 products from fp32")
  return worst


def time_ms(torch, fn, reps):
  start, stop = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  stop.synchronize()
  return start.elapsed_time(stop) / reps


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's smoke run needs an "
          "NVIDIA GPU and has no CPU path", file=sys.stderr)
    return 1
  from vtc_tpu_torch import convert
  from vtc_tpu_torch.api import SparseCoder
  from vtc_tpu_torch.encode import encode_dataset
  from vtc_tpu_torch.ops import _build, fused_fista, lipschitz

  # phase 1: device and build
  dev = torch.device("cuda", 0)
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  print("device:", kind, "| nvidia-smi:", card, "| torch", torch.__version__,
        "cuda", torch.version.cuda)
  t0 = time.perf_counter()
  _build.build(verbose=True)
  _build.load_library()
  print("build: %.1f s (%s)" % (time.perf_counter() - t0,
                                _build.library_path().name))

  t0 = time.perf_counter()
  patches = synthetic_patches(BATCH * NUM_BATCHES)
  print("data: %d synthetic 16x16 patches (pixel std %.4f) in %.1f s" % (
      patches.shape[0], float(patches.std()), time.perf_counter() - t0))

  # phase 2: kernel against plain on the card
  max_err = kernel_cases(torch, fused_fista, lipschitz, patches, dev)

  # phase 3: the slice, through the public entry points
  d_np = unit_rows(np.random.RandomState(0), 256, 256)  # the generator
  dictionary = convert.dictionary_from_numpy(d_np, dev)
  coder = SparseCoder(256, sparsity_weight=LAM, inference_iters=ITERS,
                      formulation="pallas", device=dev)
  coder.dictionary = dictionary
  fused_fista.launches = 0
  codes = encode_dataset(patches, dictionary, LAM, ITERS,
                         batch_size=BATCH, chunk_batches=4)
  codes_api = coder.encode(patches, batch_size=BATCH)
  launches = fused_fista.launches
  print("slice: %d kernel launches for 2 x %d batches" % (
      launches, NUM_BATCHES))
  check(launches == 2 * NUM_BATCHES,
        "expected %d kernel launches, counted %d" % (
            2 * NUM_BATCHES, launches))
  check(codes.shape == (patches.shape[0], 256), "codes shape " +
        str(codes.shape))
  check(bool(np.isfinite(codes).all()), "non-finite codes")
  check(float(np.abs(codes - codes_api).max()) <= limit(codes),
        "SparseCoder.encode differs from encode_dataset")
  k = 5
  eta = lipschitz.fista_stepsize(dictionary)
  x5 = torch.tensor(patches[k * BATCH:(k + 1) * BATCH], device=dev)
  plain5 = fused_fista.fused_fista_plain(x5, dictionary, LAM, ITERS, eta)
  err5 = float(np.abs(codes[k * BATCH:(k + 1) * BATCH]
                      - plain5.cpu().numpy()).max())
  lim = limit(plain5)
  print("slice: batch %d vs plain max|d| %.3e, limit %.3e" % (k, err5, lim))
  check(err5 <= lim, "encoded batch differs from plain by %.3e" % err5)
  recon = coder.decode(codes).cpu().numpy()
  density = float((codes != 0).mean())
  mse = float(np.mean((recon - patches) ** 2))
  energy = float(np.mean(patches ** 2))
  print("slice: code density %.4f, recon MSE %.6f (patch energy %.6f)" % (
      density, mse, energy))
  check(0.0 < density < 1.0 and mse < energy,
        "codes do not explain the patches")

  # phase 4: timing (warm: every shape above has run)
  x0 = torch.tensor(patches[:BATCH], device=dev)
  solve = lambda: fused_fista.fused_fista_solve(x0, dictionary, LAM, ITERS,
                                                eta)
  plain = lambda: fused_fista.fused_fista_plain(x0, dictionary, LAM, ITERS,
                                                eta)
  with torch.no_grad():
    plain_ms = [time_ms(torch, plain, 5)]
    kernel_ms = [time_ms(torch, solve, 20), time_ms(torch, solve, 20)]
    plain_ms.append(time_ms(torch, plain, 5))
  ms = sum(kernel_ms) / 2
  p_ms = sum(plain_ms) / 2
  print("kernel ms per flagship batch (b=2048 s=256 n=256, 100 it): "
        "%.4f (runs %.4f, %.4f) [%s]" % (ms, *kernel_ms, card))
  print("plain ms per flagship batch (b=2048 s=256 n=256, 100 it): "
        "%.4f (runs %.4f, %.4f) [%s]" % (p_ms, *plain_ms, card))
  for formulation in ("pallas", "gram"):
    t0 = time.perf_counter()
    encode_dataset(patches, dictionary, LAM, ITERS, batch_size=BATCH,
                   chunk_batches=4, formulation=formulation)
    dt = time.perf_counter() - t0
    print("encode %-6s %d patches in %.4f s: %.1f patches/s [%s]" % (
        formulation, patches.shape[0], dt, patches.shape[0] / dt, card))

  print(json.dumps({"kernels": [{
      "name": "fused_fista",
      "route": "cuda",
      "source": "vtc_tpu_torch/csrc/fused_fista.cu",
      "replaces": "vtc_tpu/ops/pallas_fista.py:44",
      "launches": launches,
      "max_abs_err": max_err,
      "ms": ms,
      "plain_ms": p_ms,
  }]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
