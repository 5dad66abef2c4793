"""Run the conv kernels K10, K11, K12, K13 and K17 of a checkout on fixed
inputs, or compare two such runs bit for bit.

  python3 tools/compare_conv_kernels.py run OUT.pt    (from a checkout's root)
  python3 tools/compare_conv_kernels.py diff A.pt B.pt

``run`` imports vtc_tpu_torch from the current directory, so one copy of
this script runs the kernels of any checkout: ``cd other && python3
../tools/compare_conv_kernels.py run other.pt``.  Its inputs are made on
the CPU from fixed seeds, the same in every run: conv-sparse code maps of
64 windowed 16x16 kernels at stride 8 (2% of positions active),
synthesized in float64 into 272x272 images with an 8-pixel zero border
and 0.01 noise; a ragged problem (s 40, c 3, 6x6 kernels at stride 2).
It saves every output tensor of K10 (flagship b 40 FISTA 100, b 5 ISTA
25, ragged), K11 (flagship), a 3-step K12 segment, K13 (gradient and
gram form) and K17 (3 steps at 1 and 3 update iterations, 6 steps of 5).
``diff`` prints max |a - b| of each and whether they are bitwise equal,
and exits 1 if any differs.  Needs a CUDA device.
"""
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

LAM, ITERS, SEG_ITERS, STEP = 0.05, 100, 25, 0.05


def windowed(rng, s, c, k, sigma):
  yy = np.arange(k) - (k - 1) / 2.0
  d = rng.randn(s, c, k, k) * np.exp(
      -(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * sigma ** 2))
  return d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))


def images(rng, gen, num):
  """(num, 1, 272, 272) float32 conv-sparse images of ``gen``."""
  z = rng.randn(num, 64, 33, 33) * (rng.rand(num, 64, 33, 33) < 0.02)
  x = F.conv_transpose2d(torch.from_numpy(z), torch.from_numpy(gen),
                         stride=8).numpy()
  x = x + 0.01 * rng.randn(*x.shape)
  x[:, :, :8] = x[:, :, -8:] = x[:, :, :, :8] = x[:, :, :, -8:] = 0.0
  return torch.from_numpy(x.astype(np.float32))


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
  torch.save(out, path)
  print("saved %d outputs to %s" % (len(out), path))
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
  sys.exit(__doc__)
