"""The port's per-batch conv trainer against vtc_tpu on the CPU: the
code-space kernel gradient (conv_dict_gram), both conv update rules in
every formulation, the conv Hessian EMA, the conv raw step, the conv
metrics, and a few steps of ``train_dictionary(mode='convolutional')``
with conv_formulation 'pallas' (vtc_tpu's K10 in interpret mode, the
port's plain version) and 'gram'.  The scanned conv trainer (K12) has its
own file, tests/test_torch_port_conv_scanned.py.

The same numpy inputs (from a seed) go through both packages at small
sizes.  Tolerances: 2e-5 relative to the largest value for one update or
one step, the JAX conv tests' bound; multi-step cheap-quadratic runs
amplify rounding, so they are held to max(2e-5, twice how far vtc_tpu
itself moves for a one-ulp change of the initial kernels), as
tests/test_torch_port_trainer.py does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtc_tpu.dict_update_rules.convolutional import (
    sc_cheap_quadratic_descent as jax_conv_cqd)
from vtc_tpu.dict_update_rules.convolutional import (
    sc_steepest_descent as jax_conv_sd)
from vtc_tpu.ops import conv_dict_gram as jax_conv_dict_gram
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_cheap_quadratic_descent as conv_cqd)
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_steepest_descent as conv_sd)
from vtc_tpu_torch.ops import conv_dict_gram, conv_shapes, fused_conv_direct
from vtc_tpu_torch.ops import convolutions as conv_ops
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import sparse_coding as sc

ATOL = 2e-5
PADDING = ((2, 2), (2, 2))
STRIDE = (2, 2)


def assert_close(got, want, what, atol):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.1e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.1e" % (what, err, atol)


def rel(want, atol=ATOL):
  return atol * max(1.0, float(np.abs(np.asarray(want)).max()))


def kernels(rng, s, c, kh, kw=None):
  d = rng.randn(s, c, kh, kw or kh).astype(np.float32)
  return d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))


def conv_data(rng, k=3, b=2, s=6, c=1, kdim=4, img=8, padding=PADDING):
  """(k, b, c, H, W) images with a zero border, and unit-norm kernels:
  conv-sparse maps of a generating dictionary plus noise."""
  (lv, tv), (lh, th) = padding
  gen = kernels(rng, s, c, kdim)
  hh, ww = img + lv + tv, img + lh + th
  ch = 1 + (hh - kdim) // STRIDE[0]
  cw = 1 + (ww - kdim) // STRIDE[1]
  z = rng.randn(k * b, s, ch, cw) * (rng.rand(k * b, s, ch, cw) < 0.1)
  x = conv_ops.synthesize(torch.from_numpy(z.astype(np.float32)),
                          torch.from_numpy(gen), STRIDE).numpy()
  x = x + 0.05 * rng.randn(*x.shape)
  x = x * conv_shapes.create_mask(x.shape, padding).numpy()
  return (x.reshape((k, b) + x.shape[1:]).astype(np.float32),
          kernels(rng, s, c, kdim))


# (stride, kh, kw, padding, image hw, c), stride-exact, with
# kernel % stride != 0, asymmetric paddings, no padding and c > 1
GEOMETRIES = [
    ((2, 2), 4, 4, ((2, 2), (2, 2)), (12, 14), 2),
    ((2, 3), 5, 7, ((3, 2), (4, 4)), (12, 14), 1),
    ((2, 2), 4, 4, None, (12, 12), 1),
    ((4, 4), 4, 4, ((4, 4), (4, 6)), (12, 14), 2),
]


def _geometry_inputs(rng, stride, kh, kw, padding, img, c):
  (lv, tv), (lh, th) = padding or ((0, 0), (0, 0))
  x = rng.randn(3, c, img[0] + lv + tv, img[1] + lh + th).astype(np.float32)
  d = kernels(rng, 6, c, kh, kw)
  sh = 1 + (x.shape[2] - kh) // stride[0]
  sw = 1 + (x.shape[3] - kw) // stride[1]
  z = (rng.randn(3, 6, sh, sw) * (rng.rand(3, 6, sh, sw) < 0.3)).astype(
      np.float32)
  return x, d, z


@pytest.mark.parametrize("stride,kh,kw,padding,img,c", GEOMETRIES)
def test_conv_dict_gram_matches_jax_and_image_space(rng, stride, kh, kw,
                                                    padding, img, c):
  x, d, z = _geometry_inputs(rng, stride, kh, kw, padding, img, c)
  assert (conv_dict_gram.supported(d.shape, stride)
          == jax_conv_dict_gram.supported(d.shape, stride))
  xt, zt, dt = torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(d)
  stats = conv_dict_gram.build_dict_gradient_stats(xt, zt, d.shape, stride,
                                                   padding)
  got = conv_dict_gram.dictionary_gradient_from_stats(stats, dt, stride)
  want = jax_conv_dict_gram.dictionary_gradient_gram(
      jnp.asarray(x), jnp.asarray(z), jnp.asarray(d), d.shape, stride,
      padding)
  assert_close(got, want, "conv_dict_gram vs vtc_tpu", rel(want))
  mask = conv_shapes.create_mask(x.shape, padding)
  image_space = conv_ops.dictionary_gradient(xt, zt, dt, stride, mask)
  assert_close(got, image_space, "conv_dict_gram vs image space",
               rel(image_space))
  patches = conv_dict_gram.unfold(xt, (kh, kw), stride, z.shape[2:])
  jpatches = jax_conv_dict_gram.unfold(jnp.asarray(x), (kh, kw), stride,
                                       z.shape[2:])
  assert np.array_equal(patches.numpy(), np.asarray(jpatches))


@pytest.mark.parametrize("formulation", ["block", "gram", "direct", "auto"])
@pytest.mark.parametrize("rule", ["steepest", "cheap_quadratic"])
def test_update_rules_match_jax(rng, formulation, rule):
  stride, kh, kw, padding, img, c = GEOMETRIES[1]   # kernel % stride != 0
  x, d, z = _geometry_inputs(rng, stride, kh, kw, padding, img, c)
  h = (rng.rand(6) * 0.1).astype(np.float32)
  if rule == "steepest":
    args = (x, d, z, stride, padding)
    jax_run, run = jax_conv_sd.run, conv_sd.run
  else:
    args = (x, d, z, h, stride, padding)
    jax_run, run = jax_conv_cqd.run, conv_cqd.run
  kw_ = dict(stepsize=0.01, num_iters=3, formulation=formulation)
  want = np.asarray(jax_run(*args, **kw_))
  got = run(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
              for a in args], **kw_)
  assert got.dtype == torch.float32 and got.shape == d.shape
  assert_close(got, want, "conv %s update %s" % (rule, formulation),
               rel(want))
  np.testing.assert_allclose(
      np.sqrt((got.numpy() ** 2).sum(axis=(1, 2, 3))), 1.0, atol=1e-5)


def test_update_formulations_agree(rng):
  """'block' (stride-block space), 'gram' (code space) and 'direct'
  (image space) are one gradient."""
  x, d, z = _geometry_inputs(rng, *GEOMETRIES[0])
  stride, padding = GEOMETRIES[0][0], GEOMETRIES[0][3]
  assert conv_sd.resolve_formulation(x.shape, d.shape, stride) == "block"
  outs = {f: conv_sd.run(x, torch.from_numpy(d), z, stride, padding,
                         stepsize=0.01, num_iters=2, formulation=f)
          for f in ("block", "gram", "direct")}
  assert_close(outs["block"], outs["direct"], "block vs direct", ATOL)
  assert_close(outs["gram"], outs["direct"], "gram vs direct", ATOL)
  with pytest.raises(ValueError, match="formulation"):
    conv_sd.run(x, d, z, stride, padding, formulation="xla")


def test_hessian_diagonal_ema_matches_jax(rng):
  h = (rng.rand(6) * 0.1).astype(np.float32)
  codes = rng.randn(4, 6, 5, 7).astype(np.float32)
  want = np.asarray(jax_conv_cqd.hessian_diagonal_ema(jnp.asarray(h),
                                                      jnp.asarray(codes)))
  got = conv_cqd.hessian_diagonal_ema(torch.from_numpy(h),
                                      torch.from_numpy(codes))
  assert_close(got, want, "conv hessian EMA (spatial sum)", 1e-6)


@pytest.mark.parametrize("conv_formulation", ["pallas", "gram", "auto"])
@pytest.mark.parametrize("update_alg", ["sc_cheap_quadratic_descent",
                                        "sc_steepest_descent"])
@pytest.mark.parametrize("in_step", [True, False])
def test_conv_raw_step_matches_jax(rng, conv_formulation, update_alg,
                                   in_step):
  data, d0 = conv_data(rng, k=1)
  h0 = (rng.rand(6) * 0.01).astype(np.float32)
  flags = dict(kernel_stride=STRIDE, padding=PADDING,
               conv_formulation=conv_formulation,
               compute_stepsize_in_step=in_step)
  jstep = jax_sc.build_raw_step_fn("convolutional", "fista", update_alg,
                                   **flags)
  step = sc.build_raw_step_fn("convolutional", "fista", update_alg, **flags)
  eta = np.float32(0.2)
  want = jstep(jnp.asarray(d0), jnp.asarray(h0), jnp.asarray(data[0]),
               jnp.float32(0.05), jnp.int32(15), jnp.float32(0.01), 2,
               jnp.float32(eta))
  got = step(torch.from_numpy(d0), torch.from_numpy(h0),
             torch.from_numpy(data[0]), 0.05, 15, 0.01, 2, torch.tensor(eta))
  for w, g, name in zip(want, got, ("dict", "hessian", "codes")):
    w = np.asarray(w)
    assert g.shape == w.shape, name
    assert_close(g, w, "conv step %s %s in_step=%s %s" % (
        conv_formulation, update_alg, in_step, name), rel(w, 1e-4))
  assert fused_conv_direct.launches == 0  # CPU: K10's plain version


def test_conv_compute_metrics_matches_jax(rng):
  data, d0 = conv_data(rng, k=1)
  codes = (rng.randn(2, 6, 5, 5) * (rng.rand(2, 6, 5, 5) < 0.3)).astype(
      np.float32)
  kw = dict(mode="convolutional", sparsity_weight=0.05,
            kernel_stride=STRIDE, padding=PADDING)
  want = jax_sc.compute_metrics(data[0], codes, d0, d0 + 0.01, **kw)
  got = sc.compute_metrics(torch.from_numpy(data[0]), torch.from_numpy(codes),
                           torch.from_numpy(d0), d0 + 0.01, **kw)
  assert sorted(got) == sorted(want)
  for key in want:
    assert_close(got[key], want[key], key, 1e-5 * max(1, abs(want[key])))


def _params(**extra):
  params = {
      "mode": "convolutional",
      "num_epochs": 2,
      "code_inference_algorithm": "ista",
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 10},
          3: {"sparsity_weight": 0.04, "num_iters": 15}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": 0.01, "num_iters": 1},
          4: {"stepsize": 0.005, "num_iters": 2}},
      "strides": STRIDE,
      "padding": PADDING,
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


@pytest.mark.parametrize("extra", [
    {"conv_formulation": "pallas"},
    {"conv_formulation": "gram"},
    {"dictionary_update_algorithm": "sc_steepest_descent",
     "code_inference_algorithm": "fista", "conv_formulation": "pallas",
     "nonnegative_only": True},
])
def test_train_dictionary_conv_matches_jax(rng, extra):
  data, d0 = conv_data(rng)
  params = _params(**extra)
  want = np.asarray(jax_sc.train_dictionary(data, data[:1], d0, params))
  nudged = np.nextafter(d0, np.float32(2)).astype(np.float32)
  moved = np.asarray(jax_sc.train_dictionary(data, data[:1], nudged, params))
  bound = max(ATOL, 2.0 * float(np.abs(moved - want).max()))
  got = sc.train_dictionary(data, data[:1], d0, params, device="cpu")
  assert got.dtype == torch.float32 and got.shape == d0.shape
  assert_close(got, want, "conv train_dictionary %s" % extra, bound)
  np.testing.assert_allclose(
      np.sqrt((got.numpy() ** 2).sum(axis=(1, 2, 3))), 1.0, atol=1e-4)


def test_train_dictionary_conv_validation_and_checkpoint(rng, tmp_path):
  """Validation metrics and a checkpoint in conv mode (the conv 'gram'
  solve, padding stripped), as vtc_tpu writes them."""
  data, d0 = conv_data(rng)
  params = _params(num_epochs=1, training_visualization_schedule={1},
                   checkpoint_schedule={2},
                   logging_folder_fullpath=str(tmp_path))
  got = sc.train_dictionary(data, data[:1], d0, params, device="cpu")
  assert got.shape == d0.shape and bool(torch.isfinite(got).all())
  assert list(tmp_path.glob("events.out.tfevents.*"))
  from vtc_tpu.utils import checkpoint as ckpt_util
  saved = ckpt_util.load_dictionary_checkpoint(
      tmp_path / "checkpoint_dictionary_iter_2")
  assert saved.shape == d0.shape


def test_scanned_trainer_refuses_conv_naming_k12(rng):
  """The scanned trainer refused conv until K12 was ported; it now runs
  conv, on the CPU through the per-step path (and since K12 took the
  early stop, that too on the card)."""
  data, d0 = conv_data(rng)
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, _params(),
                                                device="cpu")
  assert got.shape == d0.shape and bool(torch.isfinite(got).all())
  np.testing.assert_allclose(
      np.sqrt((got.numpy() ** 2).sum(axis=(1, 2, 3))), 1.0, atol=1e-4)


def test_conv_trainer_refuses_subspace(rng):
  data, d0 = conv_data(rng)
  with pytest.raises(NotImplementedError, match="fully-connected only"):
    sc.train_dictionary(data, data[:1], d0, _params(
        dictionary_update_algorithm="subspace_sc_steepest_descent",
        group_assignments=[[0, 1], [2, 3], [4, 5]]), device="cpu")


@pytest.mark.cuda
def test_cuda_conv_trainer_runs_k10(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K10 has no CPU mode")
  data, d0 = conv_data(rng)
  params = _params()
  before = fused_conv_direct.launches
  got = sc.train_dictionary(data, data[:1], d0, params, device="cuda")
  assert fused_conv_direct.launches == before + 6
  want = sc.train_dictionary(data, data[:1], d0, params, device="cpu")
  assert_close(got.cpu(), want, "cuda conv trainer vs cpu", 1e-3)
  # the early stop runs in K10 on the card (one launch a step)
  before = fused_conv_direct.launches
  got = sc.train_dictionary(data, data[:1], d0,
                            _params(early_stopping_epsilon=1e-3),
                            device="cuda")
  assert fused_conv_direct.launches == before + 6
  want = sc.train_dictionary(data, data[:1], d0,
                             _params(early_stopping_epsilon=1e-3),
                             device="cpu")
  assert_close(got.cpu(), want, "cuda conv trainer early stop vs cpu", 1e-3)
