"""K10's library yardstick against the plain version and vtc_tpu's kernel.

``fused_conv_direct_library`` runs K10's solve with each block-space
product as one library convolution (analysis ``conv2d``, synthesis
``conv_transpose2d``); chip_smoke.py times it beside the kernel as
K10's ``library_ms``.  Here, in float64 on the CPU, it must equal the
plain version within 1e-10 (the same arithmetic, summed in another
order), and vtc_tpu's Pallas kernel in interpret mode within the repo's
1e-4 contract, relative to the largest code once codes grow past 1.
Geometries: the flagship (64 kernels of 16x16 at stride 8) cut to b 2
and 64x64 images, 12x12 kernels zero-extended at stride 8, c 3 with 4x4
kernels at stride 2 (FISTA, ISTA, nonneg), and a ragged one (s 40, c 3,
6x6 at stride 2: M of 12 and 40, K of 108 and 360, block counts that
are no multiple of 64).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtc_tpu.ops import pallas_conv_direct
from vtc_tpu_torch.ops import fused_conv_direct

LIBRARY_ATOL = 1e-10
ATOL = 1e-4
ITERS = 10
LAM = 0.02

# (label, b, s, c, kernel, stride, image hw, padding, step scale, window,
# options)
CASES = [
    ("flagship b2 64x64", 2, 64, 1, 16, 8, (64, 64), ((8, 8), (8, 8)), 1.0,
     3.0, {}),
    ("12x12/8 zero-extended", 2, 8, 1, 12, 8, (28, 28), ((4, 4), (4, 4)),
     1.0, None, {}),
    ("c3 4x4/2 fista", 3, 6, 3, 4, 2, (16, 16), ((2, 2), (2, 2)), 0.5, None,
     {}),
    ("c3 4x4/2 ista", 3, 6, 3, 4, 2, (16, 16), ((2, 2), (2, 2)), 0.5, None,
     dict(variant="ista")),
    ("c3 4x4/2 nonneg", 3, 6, 3, 4, 2, (16, 16), ((2, 2), (2, 2)), 0.5, None,
     dict(nonneg=True)),
    ("ragged s40 c3 6x6/2", 2, 40, 3, 6, 2, (50, 38), ((4, 4), (4, 4)), 0.5,
     1.5, {}),
]


def problem(seed, b, s, c, k, img_hw, padding, scale, window):
  """float64 (images, kernels, stepsize): zero-bordered random images and
  unit-norm kernels (under a Gaussian window when ``window`` is given)."""
  rng = np.random.RandomState(seed)
  (lv, tv), (lh, th) = padding
  x = np.zeros((b, c, img_hw[0] + lv + tv, img_hw[1] + lh + th))
  x[:, :, lv:lv + img_hw[0], lh:lh + img_hw[1]] = 0.3 * rng.randn(
      b, c, *img_hw)
  d = rng.randn(s, c, k, k)
  if window is not None:
    yy = np.arange(k) - (k - 1) / 2.0
    d *= np.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * window ** 2))
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  flat = d.reshape(s, -1)
  step = scale / np.linalg.eigvalsh(flat @ flat.T)[-1]
  return x, d, float(step)


def max_diff(got, want):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  return float(np.abs(np.asarray(got, np.float64)
                      - np.asarray(want, np.float64)).max())


@pytest.mark.parametrize(
    "label,b,s,c,k,stride,img_hw,padding,scale,window,options", CASES,
    ids=[case[0] for case in CASES])
def test_library_matches_plain(label, b, s, c, k, stride, img_hw, padding,
                               scale, window, options):
  x, d, step = problem(0, b, s, c, k, img_hw, padding, scale, window)
  assert fused_conv_direct.supported(x.shape, d.shape, (stride, stride))
  kw = dict(kernel_stride=(stride, stride), padding=padding, **options)
  args = (torch.from_numpy(x), torch.from_numpy(d), LAM, ITERS, step)
  got = fused_conv_direct.fused_conv_direct_library(*args, **kw)
  want = fused_conv_direct.fused_conv_direct_plain(*args, **kw)
  assert got.dtype == torch.float64 and got.shape == want.shape
  err = max_diff(got, want)
  print("%s: library vs plain max|d| = %.3e (max|code| %.3f)" % (
      label, err, float(want.abs().max())))
  assert float((want != 0).double().mean()) > 0  # not all zero
  assert err <= LIBRARY_ATOL


@pytest.mark.parametrize(
    "label,b,s,c,k,stride,img_hw,padding,scale,window,options", CASES,
    ids=[case[0] for case in CASES])
def test_library_matches_pallas_kernel(label, b, s, c, k, stride, img_hw,
                                       padding, scale, window, options):
  x, d, step = problem(1, b, s, c, k, img_hw, padding, scale, window)
  kw = dict(kernel_stride=(stride, stride), padding=padding, **options)
  want = np.asarray(pallas_conv_direct.conv_direct_solve_pallas(
      jnp.asarray(x, jnp.float32), jnp.asarray(d, jnp.float32), LAM, ITERS,
      step, interpret=True, **kw))
  got = fused_conv_direct.fused_conv_direct_library(
      torch.from_numpy(x), torch.from_numpy(d), LAM, ITERS, step, **kw)
  atol = ATOL * max(1.0, float(np.abs(want).max()))
  err = max_diff(got, want)
  print("%s: library vs vtc_tpu's kernel max|d| = %.3e (atol %.1e)" % (
      label, err, atol))
  assert err <= atol
