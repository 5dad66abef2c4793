"""Run the ICA kernels K8, K9 and K18 of a checkout at 'highest' on fixed
inputs, or compare two such runs bit for bit.

  python3 tools/compare_ica_kernels.py run OUT.pt    (from a checkout's root)
  python3 tools/compare_ica_kernels.py diff A.pt B.pt

``run`` imports vtc_tpu_torch from the current directory, so one copy of
this script runs the kernels of any checkout: ``cd other && python3
../tools/compare_ica_kernels.py run other.pt``.  Its inputs are made on
the CPU from fixed seeds, the same in every run: an orthogonal n 256
dictionary, its inverse as the seed (and 1.35 times it, which fires the
boost), 5 batches of 250 mixtures of sources at least 0.05 from zero.  It
saves D, X and the residual of K8 on each route (upd 1 and 3, the stale
seed), K9 on a shard of 125 and K18 at a world of 1 on each route, each
at 'highest' with the boost armed at 1e-6.  ``diff`` prints max |a - b| of
each and whether they are bitwise equal, and exits 1 if any differs.
Needs a CUDA device.
"""
import os
import sys

import numpy as np
import torch

STEP, REFINE, BOOST = 0.001, 3, 1e-6


def run(path):
  sys.path.insert(0, os.getcwd())
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.ops import fused_ica_train as K8
  rng = np.random.RandomState(49)
  n, b, k = 256, 250, 5
  d = np.linalg.qr(rng.randn(n, n))[0]
  src = np.sign(rng.randn(k * b, n)) * (0.05 + rng.exponential(size=(k * b,
                                                                     n)))
  dev = torch.device("cuda", 0)
  x = torch.tensor((src @ d).reshape(k, b, n), dtype=torch.float32,
                   device=dev)
  xi = torch.tensor(np.linalg.inv(d), dtype=torch.float32, device=dev)
  d = torch.tensor(d, dtype=torch.float32, device=dev)
  mesh = parallel.make_mesh()
  out = {}
  for route in ("steps", "persistent"):
    for label, seed, upd in (("upd 1", xi, 1), ("upd 3", xi, 3),
                             ("stale seed", 1.35 * xi, 1)):
      got = K8._launch(d.clone(), seed.clone(), x, STEP, REFINE, upd, BOOST,
                       route=route)
      for what, t in zip(("D", "X", "residual"), got):
        out["K8 %s %s %s" % (route, label, what)] = t.cpu()
    got = K8._launch_dp(d.clone(), xi.clone(), x, mesh, STEP, REFINE, 1,
                        BOOST, route=route)
    for what, t in zip(("D", "X", "residual"), got):
      out["K18 %s %s" % (route, what)] = t.cpu()
  got = K8.ica_solve_stats(d, xi, x[0, :125].contiguous(),
                           refine_iters=REFINE, boost_tol=BOOST)
  for what, t in zip(("X", "stat", "residual"), got):
    out["K9 " + what] = t.cpu()
  torch.cuda.synchronize()
  torch.save(out, path)
  print("saved %d outputs to %s" % (len(out), path))
  return 0


def diff(path_a, path_b):
  a, b = torch.load(path_a), torch.load(path_b)
  if sorted(a) != sorted(b):
    print("the runs saved different outputs")
    return 1
  differ = 0
  for key in sorted(a):
    equal = torch.equal(a[key].view(torch.int32), b[key].view(torch.int32))
    differ += not equal
    err = float((a[key].double() - b[key].double()).abs().max())
    print("%-34s %-12s max|d| %.3e %s" % (
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
