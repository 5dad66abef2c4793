"""The plain train segments floor the norms that the kernels floor.

vtc_tpu's fused train kernels divide by max(|row|, 1e-30) in the fc row
renorm (K2 and K6, pallas_train_step.py:530, :719, :845; K15,
pallas_dp_train.py:301; K16, pallas_group_dp_train.py:288), and K12
floors |grad| and each kernel's squared norm at 1e-30
(pallas_conv_train.py:490, :495).  The port's plain versions, which CPU
tensors run, do the same, so a blank batch (every code 0, a zero kernel
gradient) or a zero dictionary row gives finite outputs, where a plain
division gives NaN.  Each case runs vtc_tpu's Pallas kernel in interpret
mode and the port's plain version on the same numpy inputs:

  (a) K12 on two blank batches, both update rules;
  (b) K12 steepest descent with one kernel zero;
  (c) K2 (both rules), K6 (groups of 4) and K15 at a world of one, n 16,
      s 24, b 12, two batches, row 5 of D zero: the row stays zero;
  (d) K12 with 6 x 6 kernels at stride (1, 2) and lambda 0.1 on small
      images where every code is 0.

Every output is finite and within the 1e-4 contract of vtc_tpu's (relative
to the output's largest value where that is above 1).  (b) runs one step:
the codes of a FISTA step from a moved dictionary flip thresholds past the
contract in both directions, as tests/test_torch_port_conv_scanned.py
allows for (its CHAOS tolerances).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from vtc_tpu.ops import conv_shapes as jax_conv_shapes
from vtc_tpu.ops import pallas_conv_train as jax_k12
from vtc_tpu.ops import pallas_dp_train as jax_k15
from vtc_tpu.ops.pallas_train_step import (fused_group_train_segment_pallas,
                                           fused_train_segment_pallas)
from vtc_tpu_torch import parallel
from vtc_tpu_torch.ops import (fused_conv_train, fused_dp_train,
                               fused_group_train_step, fused_train_step)

CONTRACT = 1e-4
NAMES = ("dict", "hessian", "eigvec", "codes")
CQ, SD = "sc_cheap_quadratic_descent", "sc_steepest_descent"
SUB_CQ = "subspace_" + CQ
SW, N_IT, STEP = 0.05, 12, 0.1
ZERO_ROW = 5


def _held(got, want, label):
  """Every output finite, of vtc_tpu's shape and within CONTRACT of it."""
  for g, w, name in zip(got, want, NAMES):
    g = np.asarray(g, np.float64)
    w = np.asarray(w, np.float64)
    assert g.shape == w.shape, (label, name)
    assert np.all(np.isfinite(g)), "%s %s: not finite" % (label, name)
    assert np.all(np.isfinite(w)), "%s %s: vtc_tpu not finite" % (label, name)
    err = float(np.max(np.abs(g - w)))
    lim = CONTRACT * max(1.0, float(np.max(np.abs(w))))
    print("%s %s: max|d| = %.3e (limit %.3e)" % (label, name, err, lim))
    assert err <= lim, "%s %s: max|d| %.3e > %.3e" % (label, name, err, lim)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K12: (a), (b), (d)
# ---------------------------------------------------------------------------
def _conv_problem(rng, k=2, b=3, s=8, c=1, kdim=4, stride=2, img=12):
  """tests/test_torch_port_conv_scanned.py's _problem."""
  pad = jax_conv_shapes.get_padding_amt(img, kdim, stride)
  padding = (pad, pad)
  height = img + pad[0] + pad[1]
  d = rng.randn(s, c, kdim, kdim).astype(np.float32)
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  x = np.zeros((k, b, c, height, height), np.float32)
  x[:, :, :, pad[0]:height - pad[1], pad[0]:height - pad[1]] = (
      0.3 * rng.randn(k, b, c, img, img))
  h = np.abs(rng.rand(s)).astype(np.float32) * 0.01
  v = rng.randn(min(s, c * kdim * kdim)).astype(np.float32)
  return d, h, v, x, (stride, stride), padding


def _k12(d, h, v, x, strides, padding, sw=SW, **kw):
  want = jax_k12.fused_conv_train_segment_pallas(
      d, h, v, x, sw, N_IT, STEP, kernel_stride=strides, padding=padding,
      power_iters=2, interpret=True, **kw)
  got = fused_conv_train.fused_conv_train_segment(
      _t(d), _t(h), _t(v), _t(x), sw, N_IT, STEP, kernel_stride=strides,
      padding=padding, power_iters=2, **kw)
  return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("update_alg", [CQ, SD])
def test_k12_blank_batches(update_alg):
  """(a): every code 0, so the kernel gradient is 0 and |grad| is floored;
  the dictionary moves by nothing."""
  d, h, v, x, strides, padding = _conv_problem(np.random.RandomState(0))
  got, want = _k12(d, h, v, np.zeros_like(x), strides, padding,
                   update_alg=update_alg)
  _held(got, want, "K12 blank %s" % update_alg)
  assert not np.any(got[3].numpy())


def test_k12_zero_kernel():
  """(b): a zero kernel's squared norm is floored, so it stays zero."""
  d, h, v, x, strides, padding = _conv_problem(np.random.RandomState(1))
  d[3] = 0.0
  got, want = _k12(d, h, v, x[:1], strides, padding, update_alg=SD)
  _held(got, want, "K12 zero kernel")
  assert not np.any(got[0][3].numpy())


def test_k12_all_codes_zero_geometry():
  """(d): 6 x 6 kernels at stride (1, 2), padding ((5, 1), (1, 2)), on
  8 x 7 images small enough that lambda 0.1 zeroes every code."""
  rng = np.random.RandomState(2)
  s, c, kh, kw = 3, 1, 6, 6
  padding = ((5, 1), (1, 2))
  height, width = 8 + 6, 7 + 3
  d = rng.randn(s, c, kh, kw).astype(np.float32)
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  x = np.zeros((2, 2, c, height, width), np.float32)
  x[:, :, :, 5:height - 1, 1:width - 2] = 1e-3 * rng.randn(2, 2, c, 8, 7)
  h = np.abs(rng.rand(s)).astype(np.float32) * 0.01
  v = rng.randn(min(s, c * kh * kw)).astype(np.float32)
  for update_alg in (CQ, SD):
    got, want = _k12(d, h, v, x, (1, 2), padding, sw=0.1,
                     update_alg=update_alg)
    assert not np.any(got[3].numpy()), "a code is not 0"
    _held(got, want, "K12 codes all 0 %s" % update_alg)


# ---------------------------------------------------------------------------
# K2, K6, K15: (c)
# ---------------------------------------------------------------------------
def _fc_problem(seed, s=24, n=16, b=12, k=2):
  rng = np.random.RandomState(seed)
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  d[ZERO_ROW] = 0.0
  x = rng.randn(k, b, n).astype(np.float32)
  h = np.abs(rng.rand(s)).astype(np.float32) * 0.01
  v = rng.randn(min(s, n)).astype(np.float32)
  return d, h, v, x


def _zero_row_stays(got, label):
  assert not np.any(np.asarray(got[0])[ZERO_ROW]), (
      "%s: the zero row moved" % label)


@pytest.mark.parametrize("update_alg", [CQ, SD])
def test_k2_zero_row(update_alg):
  d, h, v, x = _fc_problem(3)
  flags = dict(update_alg=update_alg, power_iters=2)
  want = [np.asarray(w) for w in fused_train_segment_pallas(
      d, h, v, x, SW, N_IT, STEP, interpret=True, **flags)]
  got = [t.numpy() for t in fused_train_step.fused_train_segment(
      _t(d), _t(h), _t(v), _t(x), SW, N_IT, STEP, **flags)]
  _held(got, want, "K2 zero row %s" % update_alg)
  _zero_row_stays(got, "K2 %s" % update_alg)


def test_k6_zero_row():
  d, h, v, x = _fc_problem(4)
  groups = [list(range(i, i + 4)) for i in range(0, 24, 4)]
  flags = dict(update_alg=SUB_CQ, power_iters=2)
  want = [np.asarray(w) for w in fused_group_train_segment_pallas(
      d, h, v, x, SW, N_IT, STEP, group_assignments=groups, interpret=True,
      **flags)]
  got = [t.numpy() for t in fused_group_train_step.fused_group_train_segment(
      _t(d), _t(h), _t(v), _t(x), SW, N_IT, STEP, group_assignments=groups,
      **flags)]
  _held(got, want, "K6 zero row")
  _zero_row_stays(got, "K6")


def test_k15_zero_row_world_of_one():
  d, h, v, x = _fc_problem(5)
  flags = dict(update_alg=CQ, power_iters=2)

  def body(d, h, v, xs):
    return jax_k15.fused_dp_train_segment_pallas(
        d, h, v, xs, jnp.float32(SW), jnp.int32(N_IT), jnp.float32(STEP),
        axis_name="data", axis_size=1, interpret=True, **flags)

  mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "code"))
  rep = PartitionSpec()
  fn = jax.jit(jax.shard_map(
      body, mesh=mesh, in_specs=(rep,) * 3 + (PartitionSpec(None, "data",
                                                             None),),
      out_specs=(rep,) * 4, check_vma=False))
  want = [np.asarray(w) for w in fn(d, h, v, x)]
  got = [t.numpy() for t in fused_dp_train.fused_dp_train_segment(
      _t(d), _t(h), _t(v), _t(x), SW, N_IT, STEP, mesh=parallel.make_mesh(),
      **flags)]
  _held(got, want, "K15 zero row")
  _zero_row_stays(got, "K15")
