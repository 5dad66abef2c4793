"""The port's conv serving slice against vtc_tpu on the CPU: the shape
helpers, the conv operators, the code-space Gram operator, the conv
``run`` in every formulation, the plain versions of K10 and K11 against
vtc_tpu's Pallas kernels in interpret mode, the block-space kernel
gradient, ``encode_dataset(mode='convolutional')`` and ``convert``.

The same numpy inputs (from a seed) go through both packages, at small
sizes (b <= 5, s <= 8, images <= 24) plus vtc_tpu's own (5, 64, 1, 16, 8,
48) shape family.  Tolerance: atol 1e-4 on codes, the repo's parity
contract, relative to the largest code where codes grow past 1 (the
operators are compared at 2e-5, the JAX tests' own bound); each test
prints the observed max |d|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtc_tpu.analysis_transforms.convolutional import (
    ista_fista as jax_conv_ista_fista)
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.ops import conv_gram as jax_conv_gram
from vtc_tpu.ops import conv_shapes as jax_conv_shapes
from vtc_tpu.ops import convolutions as jax_conv_ops
from vtc_tpu.ops import lipschitz as jax_lipschitz
from vtc_tpu.ops import pallas_conv_direct, pallas_conv_fista
from vtc_tpu_torch import convert
from vtc_tpu_torch.analysis_transforms.convolutional import ista_fista
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import (conv_gram, conv_shapes, fused_conv_direct,
                               fused_conv_fista, lipschitz, solver)
from vtc_tpu_torch.ops import convolutions as conv_ops

ATOL = 1e-4
OP_ATOL = 2e-5


def assert_close(got, want, what, atol=ATOL):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
  err = float(diff.max()) if diff.size else 0.0
  print("%s: max|d| = %.3e (atol %.1e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.1e" % (what, err, atol)


def code_atol(want):
  """1e-4, relative to the largest code once codes grow past 1."""
  return ATOL * max(1.0, float(np.abs(np.asarray(want)).max()))


def op_atol(want):
  """2e-5, relative to the largest value once values grow past 1 (sums
  over a batch of random images reach ~100 at stride 1)."""
  want = np.asarray(want)
  return OP_ATOL * max(1.0, float(np.abs(want).max()) if want.size else 1.0)


def kernels(rng, s, c, kh, kw=None):
  d = rng.randn(s, c, kh, kw or kh).astype(np.float32)
  return d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))


def padded_images(rng, b, c, img_hw, padding, scale=1.0):
  """Random images with a zero border of ``padding`` (or none)."""
  (lv, tv), (lh, th) = padding or ((0, 0), (0, 0))
  x = np.zeros((b, c, img_hw[0] + lv + tv, img_hw[1] + lh + th), np.float32)
  x[:, :, lv:lv + img_hw[0], lh:lh + img_hw[1]] = scale * rng.randn(
      b, c, *img_hw)
  return x


def jax_step(d):
  return float(jax_lipschitz.fista_stepsize(
      jnp.asarray(d).reshape(d.shape[0], -1), "eigvalsh"))


# (stride, kh, kw, padding, image hw, c): stride-exact geometries of
# tests/test_conv_gram.py, kernel % stride != 0 among them, asymmetric
# paddings, no padding, and c > 1
GEOMETRIES = [
    ((2, 2), 4, 4, ((2, 2), (2, 2)), (12, 14), 2),
    ((2, 2), 4, 4, None, (12, 14), 1),
    ((2, 3), 5, 7, ((3, 2), (4, 4)), (12, 14), 2),
    ((1, 1), 3, 3, ((2, 2), (2, 2)), (12, 14), 1),
    ((4, 4), 4, 4, ((4, 4), (4, 6)), (12, 14), 2),
    ((3, 3), 6, 6, ((3, 3), (3, 3)), (12, 12), 3),
]


def test_shape_helpers_match_jax():
  for img, k, st in ((256, 16, 8), (256, 12, 8), (17, 5, 2), (20, 4, 4)):
    assert (conv_shapes.get_padding_amt(img, k, st)
            == jax_conv_shapes.get_padding_amt(img, k, st))
    for padded in (img, img + 3):
      assert (conv_shapes.code_dim_from_padded_img_dim(padded, k, st)
              == jax_conv_shapes.code_dim_from_padded_img_dim(padded, k, st))
  for padding in (None, ((0, 0), (0, 0)), ((2, 0), (0, 3)), ((1, 2), (3, 4))):
    got = conv_shapes.create_mask((2, 3, 9, 11), padding)
    want = np.asarray(jax_conv_shapes.create_mask((2, 3, 9, 11), padding))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
  # zero trailing pads keep the trailing rows (the reference's slicing bug)
  mask = conv_shapes.create_mask((1, 1, 6, 6), ((2, 0), (0, 0)))[0, 0]
  assert mask[:2].sum() == 0 and mask[2:].sum() == 4 * 6


@pytest.mark.parametrize("stride,kh,kw,padding,img,c", GEOMETRIES)
def test_operators_match_jax(rng, stride, kh, kw, padding, img, c):
  x = padded_images(rng, 3, c, img, padding)
  d = kernels(rng, 6, c, kh, kw)
  sh, sw = ista_fista.code_spatial_dims(x.shape, d.shape, stride)
  z = rng.randn(3, 6, sh, sw).astype(np.float32)
  xt, dt, zt = torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(z)
  xj, dj, zj = jnp.asarray(x), jnp.asarray(d), jnp.asarray(z)
  mask = conv_shapes.create_mask(x.shape, padding)
  jmask = jax_conv_shapes.create_mask(x.shape, padding)
  for name, got, want in (
      ("analyze", conv_ops.analyze(xt, dt, stride),
       jax_conv_ops.analyze(xj, dj, stride)),
      ("synthesize", conv_ops.synthesize(zt, dt, stride),
       jax_conv_ops.synthesize(zj, dj, stride)),
      ("inference_gradient",
       conv_ops.inference_gradient(xt, zt, dt, stride, mask),
       jax_conv_ops.inference_gradient(xj, zj, dj, stride, jmask)),
      ("dictionary_gradient",
       conv_ops.dictionary_gradient(xt, zt, dt, stride, mask),
       jax_conv_ops.dictionary_gradient(xj, zj, dj, stride, jmask))):
    assert_close(got, want, name, op_atol(want))
  op = conv_gram.build_gram_operator(dt, stride, padding, x.shape[2:],
                                     (sh, sw))
  jop = jax_conv_gram.build_gram_operator(dj, stride, padding, x.shape[2:],
                                          (sh, sw))
  for key in ("g_int", "g_rows", "g_cols", "g_corners"):
    assert op[key].shape == jop[key].shape, key
    assert_close(op[key], jop[key], key, op_atol(jop[key]))
  assert (op["spec_py"], op["spec_px"]) == (jop["spec_py"], jop["spec_px"])
  want = jax_conv_gram.apply_gram(zj, jop)
  assert_close(conv_gram.apply_gram(zt, op), want, "apply_gram",
               op_atol(want))
  # the Gram form is the image-space gradient
  want = conv_ops.inference_gradient(xt, zt, dt, stride, mask)
  assert_close(conv_gram.inference_gradient_gram(xt, zt, dt, stride, mask,
                                                 op=op),
               want, "gram == image space", op_atol(want))


def test_non_stride_exact_geometry_refused_by_both(rng):
  """(H - kh) % stride != 0: vtc_tpu fails in every formulation (ceil
  code dims meet a floor-sized VALID convolution); the port says so."""
  x = rng.randn(2, 1, 12, 12).astype(np.float32)
  d = kernels(rng, 4, 1, 5)
  for formulation in ("gram", "direct", "pallas"):
    with pytest.raises(Exception):
      jax_conv_ista_fista.run(x, d, (2, 2), ((2, 2), (2, 2)), 0.05, 3,
                              formulation=formulation)
    with pytest.raises(ValueError, match="stride-exact"):
      ista_fista.run(x, torch.from_numpy(d), (2, 2), ((2, 2), (2, 2)), 0.05,
                     3, formulation=formulation)
  assert not fused_conv_direct.supported(x.shape, d.shape, (2, 2))


@pytest.mark.parametrize("formulation", ["gram", "direct", "pallas"])
@pytest.mark.parametrize("variant,nonneg,hard,warm", [
    ("fista", False, False, False), ("ista", False, False, False),
    ("fista", True, False, True), ("ista", False, True, False),
    ("fista", True, True, True)])
def test_run_matches_jax(rng, formulation, variant, nonneg, hard, warm):
  padding = ((2, 2), (2, 2))
  x = padded_images(rng, 3, 1, (8, 8), padding)
  d = kernels(rng, 6, 1, 4)
  step = jax_step(d)
  kw = dict(variant=variant, nonnegative_only=nonneg, hard_threshold=hard,
            stepsize=step)
  init = None
  if warm:
    init = np.asarray(jax_conv_ista_fista.run(x, d, (2, 2), padding, 0.03,
                                              4, stepsize=step))
  want = np.asarray(jax_conv_ista_fista.run(
      x, d, (2, 2), padding, 0.03, 12, initial_codes=init,
      formulation=formulation, **kw))
  got = ista_fista.run(x, torch.from_numpy(d), (2, 2), padding, 0.03, 12,
                       initial_codes=init, formulation=formulation, **kw)
  assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
  assert_close(got, want, "conv run %s %s nonneg=%s hard=%s warm=%s" % (
      formulation, variant, nonneg, hard, warm), code_atol(want))


@pytest.mark.parametrize("formulation", ["gram", "pallas"])
def test_run_early_stop_matches_jax(rng, formulation):
  padding = ((2, 2), (2, 2))
  x = padded_images(rng, 2, 1, (8, 8), padding)
  d = kernels(rng, 6, 1, 4)
  kw = dict(variant="ista", early_stopping_epsilon=1e-2,
            formulation=formulation)
  want = np.asarray(jax_conv_ista_fista.run(x, d, (2, 2), padding, 0.03, 40,
                                            **kw))
  got = ista_fista.run(x, torch.from_numpy(d), (2, 2), padding, 0.03, 40,
                       **kw)
  full = ista_fista.run(x, torch.from_numpy(d), (2, 2), padding, 0.03, 40,
                        variant="ista")
  assert float((got - full).abs().max()) > 0  # it stopped early
  assert_close(got, want, "conv early stop %s" % formulation)


# tests/test_pallas_conv_direct.py:30-35
DIRECT_GEOMETRIES = [
    (3, 6, 1, 4, 2, 12),
    (2, 8, 2, 6, 3, 12),
    (2, 6, 1, 4, 4, 12),
    (5, 64, 1, 16, 8, 48),
]


@pytest.mark.parametrize("b,s,c,kdim,stride,img", DIRECT_GEOMETRIES)
@pytest.mark.parametrize("variant", ["ista", "fista"])
def test_k10_plain_matches_pallas_kernel(rng, b, s, c, kdim, stride, img,
                                         variant):
  pad = conv_shapes.get_padding_amt(img, kdim, stride)
  padding = (pad, pad)
  x = padded_images(rng, b, c, (img, img), padding, 0.3)
  d = kernels(rng, s, c, kdim)
  step = jax_step(d)
  kw = dict(kernel_stride=(stride, stride), padding=padding,
            variant=variant)
  assert fused_conv_direct.supported(x.shape, d.shape, (stride, stride))
  want = np.asarray(pallas_conv_direct.conv_direct_solve_pallas(
      jnp.asarray(x), jnp.asarray(d), 0.02, 10, step, interpret=True, **kw))
  got = fused_conv_direct.fused_conv_direct_solve(
      torch.from_numpy(x), torch.from_numpy(d), 0.02, 10, step, **kw)
  assert_close(got, want, "K10 plain b%d s%d c%d k%d/%d %s" % (
      b, s, c, kdim, stride, variant), code_atol(want))
  assert fused_conv_direct.launches == 0  # CPU: the plain version


def test_k10_plain_zero_extension_and_flags(rng):
  """12x12 kernels at stride 8 (zero-extended to 16), a warm start, and
  the nonneg and hard thresholds, against vtc_tpu's kernel."""
  padding = ((4, 4), (4, 4))          # (36 - 12) % 8 == 0
  x = padded_images(rng, 2, 1, (28, 28), padding, 0.3)
  d = kernels(rng, 8, 1, 12)
  step = jax_step(d)
  geo = fused_conv_direct.geometry(x.shape, d.shape, (8, 8))
  assert (geo["khp"], geo["ekh"], geo["code_h"]) == (16, 4, 4)
  init = rng.randn(2, 8, 4, 4).astype(np.float32) * 0.1
  for kw in (dict(initial_codes=init), dict(nonneg=True),
             dict(hard=True, variant="ista")):
    want = np.asarray(pallas_conv_direct.conv_direct_solve_pallas(
        jnp.asarray(x), jnp.asarray(d), 0.02, 8, step, kernel_stride=(8, 8),
        padding=padding, interpret=True, **kw))
    got = fused_conv_direct.fused_conv_direct_solve(
        torch.from_numpy(x), torch.from_numpy(d), 0.02, 8, step,
        kernel_stride=(8, 8), padding=padding,
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    assert_close(got, want, "K10 plain 12x12/8 %s" % sorted(kw),
                 code_atol(want))


def test_k10_gate_matches_jax():
  for shapes in (((2, 1, 12, 12), (6, 1, 5, 5), (2, 2)),
                 ((2, 1, 272, 272), (64, 1, 16, 16), (8, 8)),
                 ((2, 1, 268, 268), (64, 1, 12, 12), (8, 8)),
                 ((2, 3, 288, 288), (64, 3, 32, 32), (16, 16)),
                 ((2, 1, 20, 20), (600, 1, 4, 4), (2, 2))):
    assert (fused_conv_direct.supported(*shapes)
            == pallas_conv_direct.supported(*shapes)), shapes


# tests/test_pallas_conv_fista.py:28-34
FISTA_CASES = [
    (1, 4, (2, 2), 8, ((2, 2), (2, 2))),
    (1, 4, (2, 2), 8, None),
    (2, 4, (2, 2), 8, ((2, 2), (2, 2))),
    (1, 6, (2, 3), 9, ((4, 3), (3, 3))),
    (1, 5, (2, 2), 10, ((3, 2), (3, 2))),
]


@pytest.mark.parametrize("c,kdim,stride,img,padding", FISTA_CASES)
def test_k11_plain_matches_pallas_kernel(c, kdim, stride, img, padding):
  rng = np.random.RandomState(0)
  x = padded_images(rng, 3, c, (img, img), padding)
  d = kernels(rng, 6, c, kdim)
  step = jax_step(d)
  want = np.asarray(pallas_conv_fista.conv_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(d), 0.03, 15, step, kernel_stride=stride,
      padding=padding, interpret=True))
  got = fused_conv_fista.fused_conv_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), 0.03, 15, step,
      kernel_stride=stride, padding=padding)
  assert_close(got, want, "K11 plain c%d k%d %s" % (c, kdim, stride),
               code_atol(want))
  assert fused_conv_fista.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("variant,nonneg,hard", [
    ("ista", False, False), ("fista", True, False), ("fista", False, True)])
def test_k11_plain_variants_match_pallas_kernel(variant, nonneg, hard):
  rng = np.random.RandomState(1)
  padding = ((2, 2), (2, 2))
  x = padded_images(rng, 2, 1, (8, 8), padding)
  d = kernels(rng, 6, 1, 4)
  step = jax_step(d)
  init = rng.randn(2, 6, 5, 5).astype(np.float32) * 0.1
  kw = dict(kernel_stride=(2, 2), padding=padding, variant=variant,
            nonneg=nonneg, hard=hard)
  want = np.asarray(pallas_conv_fista.conv_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(d), 0.03, 10, step, interpret=True,
      initial_codes=jnp.asarray(init), **kw))
  got = fused_conv_fista.fused_conv_fista_solve(
      torch.from_numpy(x), torch.from_numpy(d), 0.03, 10, step,
      initial_codes=torch.from_numpy(init), **kw)
  assert_close(got, want, "K11 plain %s nonneg=%s hard=%s" % (
      variant, nonneg, hard), code_atol(want))


def test_run_pallas_dispatches_like_jax(rng):
  """'pallas' takes K10 where its gate holds, else K11 (c*sv*sh > 512
  here); both against vtc_tpu's 'pallas' on the same geometry."""
  for c, k, stride, img, s in ((1, 4, 2, 8, 6), (3, 16, 16, 32, 4)):
    pad = conv_shapes.get_padding_amt(img, k, stride)
    padding = (pad, pad)
    x = padded_images(rng, 2, c, (img, img), padding)
    d = kernels(rng, s, c, k)
    gate = fused_conv_direct.supported(x.shape, d.shape, (stride, stride))
    assert gate == (c * stride * stride <= 512)
    want = np.asarray(jax_conv_ista_fista.run(
        x, d, (stride, stride), padding, 0.03, 10, formulation="pallas"))
    got = ista_fista.run(x, torch.from_numpy(d), (stride, stride), padding,
                         0.03, 10, formulation="pallas")
    assert_close(got, want, "run pallas gate=%s" % gate, code_atol(want))


@pytest.mark.parametrize("stride,kh,kw,padding,img,c", GEOMETRIES)
def test_block_update_stats_match_autodiff(rng, stride, kh, kw, padding, img,
                                           c):
  """The stride-block kernel gradient against the image-space gradient
  (the port's and vtc_tpu's autodiff) and against vtc_tpu's block
  stats."""
  x = padded_images(rng, 3, c, img, padding)
  d = kernels(rng, 6, c, kh, kw)
  assert fused_conv_direct.supported(x.shape, d.shape, stride)
  sh, sw = ista_fista.code_spatial_dims(x.shape, d.shape, stride)
  z = rng.randn(3, 6, sh, sw).astype(np.float32)
  stats = fused_conv_direct.build_block_update_stats(
      torch.from_numpy(x), torch.from_numpy(z), d.shape, stride, padding)
  got = fused_conv_direct.dictionary_gradient_from_block_stats(
      stats, torch.from_numpy(d))
  mask = jax_conv_shapes.create_mask(x.shape, padding)
  want = jax_conv_ops.dictionary_gradient(jnp.asarray(x), jnp.asarray(z),
                                          jnp.asarray(d), stride, mask)
  assert_close(got, want, "block gradient vs vtc_tpu autodiff",
               op_atol(want))
  jstats = pallas_conv_direct.build_block_update_stats(
      jnp.asarray(x), jnp.asarray(z), d.shape, stride, padding)
  want = pallas_conv_direct.dictionary_gradient_from_block_stats(
      jstats, jnp.asarray(d))
  assert_close(got, want, "block gradient vs vtc_tpu block", op_atol(want))


@pytest.mark.parametrize("formulation", [None, "pallas", "gram"])
def test_encode_dataset_conv_matches_jax(rng, formulation):
  """11 images in batches of 4 (a ragged tail), chunks of 2 batches."""
  padding = ((4, 4), (4, 4))
  x = padded_images(rng, 11, 1, (16, 16), padding, 0.3)
  d = kernels(rng, 8, 1, 8)
  kw = dict(mode="convolutional", kernel_stride=(4, 4), padding=padding,
            batch_size=4, chunk_batches=2, formulation=formulation)
  want = jax_encode_dataset(x, d, 0.05, 20, **kw)
  got = encode_dataset(x, d, 0.05, 20, device="cpu", **kw)
  assert isinstance(got, np.ndarray) and got.shape == want.shape
  assert got.shape == (11, 8, 5, 5)
  assert_close(got, want, "conv encode_dataset formulation=%s"
               % formulation, code_atol(want))


def test_encode_dataset_conv_options(rng):
  padding = ((4, 4), (4, 4))
  x = padded_images(rng, 6, 2, (16, 16), padding, 0.3)
  d = kernels(rng, 6, 2, 8)
  kw = dict(mode="convolutional", kernel_stride=(4, 4), padding=padding,
            batch_size=3, variant="ista", nonnegative_only=True)
  want = jax_encode_dataset(x, d, 0.05, 15, **kw)
  got = encode_dataset(x, torch.from_numpy(d), 0.05, 15, **kw)
  assert_close(got, want, "conv encode ista nonneg c2", code_atol(want))
  with pytest.raises(ValueError, match="kernel_stride"):
    encode_dataset(x, d, 0.05, 5, mode="convolutional", device="cpu")


def test_dictionary_from_numpy_takes_kernels(rng):
  d = kernels(rng, 6, 2, 4)
  t = convert.dictionary_from_numpy(d, "cpu")
  assert t.shape == (6, 2, 4, 4) and t.dtype == torch.float32
  assert np.array_equal(t.numpy(), d)
  for bad in (np.zeros(5), np.zeros((2, 3, 4))):
    with pytest.raises(ValueError, match="kernels"):
      convert.dictionary_from_numpy(bad, "cpu")


def test_wrappers_refuse_what_they_do_not_run(rng):
  padding = ((2, 2), (2, 2))
  x = torch.from_numpy(padded_images(rng, 2, 1, (8, 8), padding))
  d = torch.from_numpy(kernels(rng, 6, 1, 4))
  kw = dict(kernel_stride=(2, 2), padding=padding)
  for solve, plain in (
      (fused_conv_direct.fused_conv_direct_solve,
       fused_conv_direct.fused_conv_direct_plain),
      (fused_conv_fista.fused_conv_fista_solve,
       fused_conv_fista.fused_conv_fista_plain)):
    # the early stop runs (since the kernels took it): a CPU tensor takes
    # the plain version with the stop test
    got = solve(x, d, 0.1, 5, 0.1, early_stopping_epsilon=1e-3, **kw)
    want = plain(x, d, 0.1, 5, 0.1, early_stopping_epsilon=1e-3, **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
      solve(x, d, 0.1, 5, 0.1, variant="adam", **kw)
    # neither CPU nor CUDA: no silent plain path
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
      solve(x.to("meta"), d.to("meta"), 0.1, 5, 0.1, **kw)
  # the tiers run (K10's, since its tier kernel: tests/test_torch_port_
  # conv_tiers.py holds them to vtc_tpu): on a CPU tensor the plain version
  # at the tier, near the fp32 codes and not on them; 'gram' refuses a tier
  full = ista_fista.run(x, d, (2, 2), padding, 0.1, 5, formulation="pallas")
  tier = ista_fista.run(x, d, (2, 2), padding, 0.1, 5, formulation="pallas",
                        mxu_precision="bf16x3")
  assert torch.equal(tier, fused_conv_direct.fused_conv_direct_plain(
      x, d, 0.1, 5, lipschitz.fista_stepsize(d.reshape(6, -1)), mxu="bf16x3",
      **kw))
  assert 0.0 < float((tier - full).abs().max()) < 1e-3
  with pytest.raises(ValueError, match="'pallas' formulation only"):
    ista_fista.run(x, d, (2, 2), padding, 0.1, 5, mxu_precision="bf16x3")
  # 'pallas' on a tensor that is neither on the CPU nor on the card
  # reaches a kernel wrapper, which refuses it: never the plain route
  for c, k, stride in ((1, 4, 2), (3, 16, 16)):     # K10, then K11
    xm = torch.zeros((1, c, 16, 16), device="meta")
    dm = torch.zeros((2, c, k, k), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
      ista_fista.run(xm, dm, (stride, stride), None, 0.1, 5,
                     formulation="pallas", stepsize=0.1)
  # 'pallas' with an early stop on a tensor that is not on the CPU reaches
  # the kernel wrapper, which refuses it: never the plain route
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    ista_fista.run(x.to("meta"), d.to("meta"), (2, 2), padding, 0.1, 5,
                   formulation="pallas", early_stopping_epsilon=1e-3,
                   stepsize=0.1)
  assert fused_conv_direct.launches == fused_conv_fista.launches == 0


@pytest.mark.cuda
def test_cuda_wrappers_raise_and_match_plain(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the conv kernels have no CPU mode")
  dev = torch.device("cuda", 0)
  padding = ((4, 4), (4, 4))
  x = torch.from_numpy(padded_images(rng, 3, 2, (16, 16), padding, 0.3))
  d = torch.from_numpy(kernels(rng, 8, 2, 8))
  kw = dict(kernel_stride=(4, 4), padding=padding)
  for solve, plain, counter in (
      (fused_conv_direct.fused_conv_direct_solve,
       fused_conv_direct.fused_conv_direct_plain, fused_conv_direct),
      (fused_conv_fista.fused_conv_fista_solve,
       fused_conv_fista.fused_conv_fista_plain, fused_conv_fista)):
    # the early stop runs in the kernel and ends where the plain loop does
    before = counter.launches
    got = solve(x.to(dev), d.to(dev), 0.05, 20, 0.1,
                early_stopping_epsilon=1e-3, **kw)
    assert counter.launches == before + 1
    want = plain(x.to(dev), d.to(dev), 0.05, 20, 0.1,
                 early_stopping_epsilon=1e-3, **kw)
    assert int(counter.last_iters.item()) == solver.last_iters
    assert_close(got, want.cpu().numpy(), solve.__name__ + " early stop")
    before = counter.launches
    got = solve(x.to(dev), d.to(dev), 0.05, 20, 0.1, **kw)
    assert counter.launches == before + 1
    want = plain(x.to(dev), d.to(dev), 0.05, 20, 0.1, **kw)
    assert_close(got, want.cpu().numpy(), solve.__name__)
  # a tier runs K10's tier kernel (chip_smoke.py phase 48 holds it to its
  # plain version at the flagship)
  before = fused_conv_direct.tier_launches
  ista_fista.run(x.to(dev), d.to(dev), (4, 4), padding, 0.05, 5,
                 formulation="pallas", mxu_precision="bf16")
  assert fused_conv_direct.tier_launches == before + 1
