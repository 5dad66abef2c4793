"""Generic ISTA / FISTA proximal-gradient loop: counterpart of
``proximal_gradient_loop`` (vtc_tpu/ops/solver.py:42-124).

The same state and the same ``prestep_fn`` fold, as a Python loop:

  while k < num_iters and not stop:
      codes = prox(prestep(z))  or  prox(z - stepsize * grad(z))
      if fista:  t_{k+1} = (1+sqrt(1+4 t_k^2))/2 ; beta = (t_k-1)/t_{k+1}
                 z = codes + beta * (codes - old_codes)
      else:      z = codes
      if eps:    stop = mean(|codes - old_codes|) / stepsize < eps and k > 0
      old_codes = codes

The momentum scalars are computed on the host in the codes' own float
type (numpy scalars), so float32 runs round exactly as the JAX loop's
float32 scalars do.  Early stop reads the batch-global mean back to the
host once per iteration.  With ``psum_axes`` (the data-parallel stop
test, vtc_tpu :105-110) that mean is first averaged over the mesh's
ranks, one scalar all-reduce per iteration: every rank reads the same
value and leaves the loop at the same iteration, and with equal shards
the codes equal the single-device solve on the concatenated batch.  With
``stop_count`` the test is the whole-segment kernels' instead (vtc_tpu's
pallas_dp_train.py:239-241): the sums of |codes - old| added over the
mesh's ranks, times 1 / stop_count, over the stepsize -- a sum of shares,
then the scale, not a mean of per-rank means.
"""
from typing import Callable, Optional

import numpy as np
import torch

# test hooks: the iterations the last loop ran, and with a stop test the
# batch-global means it read (the mean after iteration k at index k - 1)
last_iters = None
last_avgs = None


def numpy_dtype(dtype: torch.dtype):
  """The numpy scalar type of a torch floating dtype."""
  return torch.empty((), dtype=dtype).numpy().dtype.type


def fista_momentum(t_k):
  """(t_{k+1}, beta) from t_k, in t_k's own numpy float type."""
  dt = type(t_k)
  t_next = (dt(1) + np.sqrt(dt(1) + dt(4) * t_k * t_k)) / dt(2)
  return t_next, (t_k - dt(1)) / t_next


def proximal_gradient_loop(
    grad_fn: Callable,
    prox_fn: Callable,
    init_codes: torch.Tensor,
    stepsize,
    num_iters,
    *,
    variant: str = "fista",
    early_stopping_epsilon: Optional[float] = None,
    prestep_fn: Optional[Callable] = None,
    psum_axes=None,
    stop_count: Optional[int] = None,
) -> torch.Tensor:
  """Run the ISTA/FISTA loop; returns the final codes.

  Args mirror vtc_tpu/ops/solver.py:55-81: ``grad_fn`` and ``prox_fn``
  are callables on tensors, ``stepsize`` a float or 0-d tensor,
  ``prestep_fn`` the fused replacement for the gradient step.
  ``psum_axes`` is the ``parallel.Mesh`` whose data axes the stop test
  averages over (where vtc_tpu names the axes of the enclosing shard_map),
  or None.  ``stop_count``: the global element count of the kernels' stop
  test (the ranks' sums added, then scaled), or None for the mean.
  """
  global last_iters, last_avgs
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  use_fista = variant == "fista"
  t_k = numpy_dtype(init_codes.dtype)(1)
  z = old_codes = codes = init_codes
  last_iters, last_avgs = 0, []
  for k in range(int(num_iters)):
    last_iters = k + 1
    if prestep_fn is not None:
      codes = prox_fn(prestep_fn(z), stepsize)
    else:
      codes = prox_fn(z - stepsize * grad_fn(z), stepsize)
    delta = codes - old_codes
    if use_fista:
      t_k, beta = fista_momentum(t_k)
      z = codes + beta * delta
    else:
      z = codes
    old_codes = codes
    if early_stopping_epsilon is not None and k > 0:
      if stop_count is not None:
        total = torch.sum(torch.abs(delta))
        if psum_axes is not None:
          total = psum_axes.sum(total)
        avg_delta = total * (1.0 / stop_count)
      else:
        avg_delta = torch.mean(torch.abs(delta))
        if psum_axes is not None:
          avg_delta = psum_axes.mean(avg_delta)
      avg_delta = float(avg_delta / stepsize)
      last_avgs.append(avg_delta)
      if avg_delta < early_stopping_epsilon:
        break
  return codes
