"""Run K19 (the residual-form segment and its persistent solve) of a
checkout at 'highest' on fixed inputs, or compare two such runs bit for
bit.

  python3 tools/compare_code_shard_kernels.py run OUT.pt  (from a checkout's root)
  python3 tools/compare_code_shard_kernels.py diff A.pt B.pt

``run`` imports vtc_tpu_torch from the current directory, so one copy of
this script runs the kernels of any checkout: ``cd other && python3
../tools/compare_code_shard_kernels.py run other.pt``.  Its inputs are
made on the CPU from fixed seeds, the same in every run: unit rows of an
s 2048 (or 512) by n 256 dictionary, its n x n Gram's top eigenvector, a
zero Hessian EMA and 3 batches of 128 sparse mixtures of the rows.  It
saves D, h, v, the last codes and the stepsize of each case on both routes
(forced through the wrapper's private ``_launch``, whose arguments every
checkout since the stop takes): fc cheap-quad, 512 contiguous groups of 4,
a ragged member table at s 512, steepest descent with 2 update iterations,
the regularizer at penalty 0.15, and the early stop at a fixed eps.
``diff`` prints max |a - b| of each and whether they are bitwise equal,
and exits 1 if any differs.  Needs a CUDA device.
"""
import os
import sys

import numpy as np
import torch

LAM, ITERS, STEP = 0.008, 25, 0.1


def _problem(s, n, b, k, seed, dev):
  rng = np.random.RandomState(seed)
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  v = np.linalg.eigh(d.T @ d)[1][:, -1]
  amps = (rng.rand(k * b, s) < 12.8 / s) * rng.randn(k * b, s) * 0.05
  x = (amps @ d + 0.003 * rng.randn(k * b, n)).reshape(k, b, n)
  return [torch.tensor(a.astype(np.float32), device=dev)
          for a in (d, np.zeros(s), v, x)]


def _ragged(s, seed):
  rng = np.random.RandomState(seed)
  perm, groups, at = rng.permutation(s), [], 0
  while at < s:
    size = int(rng.randint(1, 7))
    groups.append(sorted(int(i) for i in perm[at:at + size]))
    at += size
  return groups


def run(path):
  sys.path.insert(0, os.getcwd())
  from vtc_tpu_torch.ops import fused_code_shard_train as K19
  dev = torch.device("cuda", 0)
  sub_cq = "subspace_sc_cheap_quadratic_descent"
  cases = [
      ("fc", 2048, None, 0.0, {}, None),
      ("512x4", 2048, [list(range(i, i + 4)) for i in range(0, 2048, 4)],
       0.0, dict(update_alg=sub_cq), None),
      ("ragged s512", 512, _ragged(512, 3), 0.0, dict(update_alg=sub_cq),
       None),
      ("steepest upd 2", 2048, None, 0.0,
       dict(update_alg="sc_steepest_descent", upd_num_iters=2), None),
      ("penalty 0.15 s512", 512, [list(range(i, i + 4))
                                  for i in range(0, 512, 4)], 0.15,
       dict(update_alg="subspace_sc_steepest_descent"), None),
      ("stop", 2048, None, 0.0, {}, 2e-4),
  ]
  out = {}
  for seed, (label, s, groups, penalty, flags, eps) in enumerate(cases):
    d, h, v, x = _problem(s, 256, 128, 3, 50 + seed, dev)
    table = window = comem = None
    if groups is not None:
      arrays = K19.code_shard_group_arrays(groups, s, 1)
      table, window = K19.group_members(arrays[0][0])
      if penalty:
        comem = arrays[1][0]
    kw = dict(variant="fista", update_alg="sc_cheap_quadratic_descent",
              upd_num_iters=1, nonneg=False, hard=False, renormalize=True,
              power_iters=2, lowest_code_val=0.001,
              alignment_penalty=penalty)
    kw.update(flags)
    for route in ("steps", "persistent"):
      got = K19._launch(d, h, v, x, table, window, comem, None, LAM, ITERS,
                        STEP, route=route, eps=eps,
                        stop_count=None if eps is None else 128 * s, **kw)
      for what, t in zip(("D", "h", "v", "codes", "eta"), got):
        out["%s %s %s" % (label, route, what)] = t.cpu()
      if eps is not None:
        out["%s %s iters" % (label, route)] = K19.last_iters.cpu().float()
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
