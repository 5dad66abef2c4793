"""The port's scanned conv trainer and K12 against vtc_tpu on the CPU.

K12's plain version (``fused_conv_train_plain``, what a CPU tensor runs)
is held to vtc_tpu's Pallas kernel ``fused_conv_train_segment_pallas`` in
interpret mode at the geometry and bounds of
tests/test_pallas_conv_train.py:50-61: 2e-5 relative to the largest value
for one step, the JAX test's chaos bounds for cheap-quadratic
trajectories (dictionary 1e-4, Hessian 1e-3, codes 5e-3, eigenvector
2e-5), 2e-5 for steepest descent, 1e-4 with three update iterations.
The port's gate is held to vtc_tpu's; they may differ only where vtc_tpu's
VMEM tile rule decides.  ``train_dictionary_scanned(mode=
'convolutional')`` runs the per-step path on the CPU and is held to
vtc_tpu's at the trajectory bound of tests/test_torch_port_trainer.py:
max(2e-5, twice how far vtc_tpu moves for a one-ulp change of the
initial kernels).
"""
import numpy as np
import pytest
import torch

from vtc_tpu.ops import conv_shapes as jax_conv_shapes
from vtc_tpu.ops import pallas_conv_train as jax_k12
from vtc_tpu.training import compiled_epoch as jax_compiled_epoch
from vtc_tpu_torch.ops import conv_shapes, fused_conv_direct, fused_conv_train
from vtc_tpu_torch.ops import lipschitz
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import sparse_coding as sc

NAMES = ("dict", "hessian", "eigvec", "codes")
CHAOS = {"dict": 1e-4, "hessian": 1e-3, "eigvec": 2e-5, "codes": 5e-3}


def assert_close(got, want, tol, what):
  """Scale-aware, as the JAX conv tests: within tol * max(1, max|want|)."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want, np.float64)
  err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
  bound = tol * max(1.0, float(np.abs(want).max()))
  print("%s: max|d| = %.3e (bound %.1e)" % (what, err, bound))
  assert err <= bound, "%s: max|d| %.3e > %.1e" % (what, err, bound)


def _problem(rng, k=3, b=3, s=8, c=1, kdim=4, stride=2, img=12):
  """tests/test_pallas_conv_train.py:50-61."""
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


def _problem_nonmultiple(rng, k=2, b=3, s=6, c=1, kdim=5, stride=2, img=12):
  """tests/test_pallas_conv_train.py:306-324: 5x5 kernels at stride 2
  run zero-extended to 6x6."""
  lead = trail = kdim - stride
  trail += (-(img + lead + trail - kdim)) % stride
  padding = ((lead, trail), (lead, trail))
  height = img + lead + trail
  d = rng.randn(s, c, kdim, kdim).astype(np.float32)
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  x = np.zeros((k, b, c, height, height), np.float32)
  x[:, :, :, lead:height - trail, lead:height - trail] = (
      0.3 * rng.randn(k, b, c, img, img))
  h = np.abs(rng.rand(s)).astype(np.float32) * 0.01
  v = rng.randn(min(s, c * kdim * kdim)).astype(np.float32)
  return d, h, v, x, (stride, stride), padding


def _both(d, h, v, x, strides, padding, sw, n_it, step, **kw):
  """(vtc_tpu's Pallas kernel in interpret mode, the port's CPU path)."""
  want = jax_k12.fused_conv_train_segment_pallas(
      d, h, v, x, sw, n_it, step, kernel_stride=strides, padding=padding,
      power_iters=2, interpret=True, **kw)
  kw.pop("batch_tile", None)
  got = fused_conv_train.fused_conv_train_segment(
      torch.from_numpy(d), torch.from_numpy(h), torch.from_numpy(v),
      torch.from_numpy(x), sw, n_it, step, kernel_stride=strides,
      padding=padding, power_iters=2, **kw)
  return [np.asarray(w) for w in want], got


PAIRS = [("fista", "sc_cheap_quadratic_descent"),
         ("fista", "sc_steepest_descent"),
         ("ista", "sc_cheap_quadratic_descent"),
         ("ista", "sc_steepest_descent")]


@pytest.mark.parametrize("variant,update_alg", PAIRS)
def test_one_step_matches_pallas(rng, variant, update_alg):
  d, h, v, x, strides, padding = _problem(rng)
  want, got = _both(d, h, v, x[:1], strides, padding, 0.05, 12, 0.1,
                    variant=variant, update_alg=update_alg)
  for w, g, name in zip(want, got, NAMES):
    assert g.shape == w.shape and g.dtype == torch.float32, name
    assert_close(g, w, 2e-5, "one step %s %s %s" % (variant, update_alg,
                                                    name))
  assert fused_conv_train.launches == 0  # CPU: the plain version


@pytest.mark.parametrize("variant,update_alg", PAIRS[:3])
def test_trajectory_matches_pallas(rng, variant, update_alg):
  d, h, v, x, strides, padding = _problem(rng)
  want, got = _both(d, h, v, x, strides, padding, 0.05, 12, 0.1,
                    variant=variant, update_alg=update_alg)
  chaotic = update_alg == "sc_cheap_quadratic_descent"
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, CHAOS[name] if chaotic else 2e-5,
                 "3 steps %s %s %s" % (variant, update_alg, name))


def test_stride_equal_to_kernel_strict(rng):
  """R = 1: the flat-kernel Lipschitz constant is exact and the solve
  converges, so parity holds per element at 2e-5."""
  d, h, v, x, strides, padding = _problem(rng, kdim=4, stride=4)
  want, got = _both(d, h, v, x, strides, padding, 0.05, 12, 0.1)
  for w, g, name in zip(want, got, NAMES):
    err = float(np.abs(g.numpy() - w).max())
    assert err <= 2e-5, (name, err)


def test_multi_update_iters(rng):
  """upd_num_iters 3: the gradient is recomputed at the current kernels
  every iteration."""
  d, h, v, x, strides, padding = _problem(rng, k=2)
  want, got = _both(d, h, v, x, strides, padding, 0.03, 8, 0.05,
                    upd_num_iters=3)
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, 1e-4, "upd_num_iters 3 " + name)


@pytest.mark.parametrize("update_alg,upd_iters", [
    ("sc_cheap_quadratic_descent", 1), ("sc_steepest_descent", 1),
    ("sc_steepest_descent", 3)])
def test_zero_extended_kernels(rng, update_alg, upd_iters):
  """5x5 kernels at stride 2: the support projection keeps the
  zero-extension taps at zero; the trained kernels keep their shape and
  unit norms."""
  d, h, v, x, strides, padding = _problem_nonmultiple(rng)
  geo = fused_conv_direct.geometry(x.shape[1:], d.shape, strides)
  assert geo["ekh"] == 1 and geo["ekw"] == 1
  want, got = _both(d, h, v, x, strides, padding, 0.05, 8, 0.1,
                    update_alg=update_alg, upd_num_iters=upd_iters)
  chaotic = update_alg == "sc_cheap_quadratic_descent"
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, CHAOS[name] if chaotic else 2e-5,
                 "zero-extended %s x%d %s" % (update_alg, upd_iters, name))
  assert got[0].shape == d.shape
  np.testing.assert_allclose(
      torch.linalg.vector_norm(got[0].reshape(6, -1), dim=1).numpy(), 1.0,
      atol=1e-5)


def test_tiled_pallas_matches_single_tile_plain(rng):
  """vtc_tpu's batch-tiled kernel (tile 2 at b = 5, a padded last tile)
  against the port, which runs every batch as one tile."""
  d, h, v, x, strides, padding = _problem(rng, k=2, b=5)
  want, got = _both(d, h, v, x, strides, padding, 0.05, 10, 0.1,
                    batch_tile=2)
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, 1e-4, "tiled vs single tile " + name)


@pytest.mark.parametrize("extra", [{"nonneg": True}, {"renormalize": False},
                                   {"hard": True, "variant": "ista"}])
def test_thresholds_and_renormalize(rng, extra):
  d, h, v, x, strides, padding = _problem(rng, k=2)
  want, got = _both(d, h, v, x, strides, padding, 0.05, 10, 0.1,
                    update_alg="sc_steepest_descent", **extra)
  for w, g, name in zip(want, got, NAMES):
    assert_close(g, w, 2e-5, "%s %s" % (extra, name))


def test_return_stepsize_is_the_last_refresh(rng):
  d, h, v, x, strides, padding = _problem(rng, k=2)
  out = fused_conv_train.fused_conv_train_segment(
      torch.from_numpy(d), torch.from_numpy(h), torch.from_numpy(v),
      torch.from_numpy(x), 0.05, 8, 0.1, kernel_stride=strides,
      padding=padding, power_iters=2, return_stepsize=True)
  assert len(out) == 5 and out[4].shape == (1,)
  d1 = fused_conv_train.fused_conv_train_segment(
      torch.from_numpy(d), torch.from_numpy(h), torch.from_numpy(v),
      torch.from_numpy(x[:1]), 0.05, 8, 0.1, kernel_stride=strides,
      padding=padding, power_iters=2)[0]
  eig, _ = lipschitz.power_iterate(d1.reshape(8, -1), out[2], 0)
  assert abs(float(out[4]) * float(eig) - 1.0) < 1e-5
  # the tiers run (tests/test_torch_port_conv_tiers.py holds them to
  # vtc_tpu): a CPU tensor takes the plain version at the tier
  args = [torch.from_numpy(a) for a in (d, h, v, x)]
  kw = dict(kernel_stride=strides, padding=padding, mxu="bf16x3")
  for got, want in zip(
      fused_conv_train.fused_conv_train_segment(*args, 0.05, 8, 0.1, **kw),
      fused_conv_train.fused_conv_train_plain(*args, 0.05, 8, 0.1, **kw)):
    assert torch.equal(got, want)


# (img_shape, dict_shape, stride, inference, update, upd_iters, padding)
GATE_GRID = [
    ((5, 1, 272, 272), (64, 1, 16, 16), (8, 8)),
    ((40, 1, 272, 272), (64, 1, 16, 16), (8, 8)),
    ((5, 1, 268, 268), (64, 1, 12, 12), (8, 8)),
    ((5, 1, 272, 272), (64, 1, 15, 15), (8, 8)),
    ((5, 3, 288, 288), (64, 3, 32, 32), (16, 16)),
    ((3, 1, 16, 16), (8, 1, 4, 4), (2, 2)),
    ((3, 1, 16, 16), (20, 1, 4, 4), (2, 2)),
    ((3, 1, 16, 16), (16, 1, 4, 4), (2, 2)),
    ((3, 2, 17, 22), (6, 2, 5, 7), (2, 3)),
    ((2, 1, 12, 12), (4, 1, 4, 4), (4, 4)),
    ((200, 1, 272, 272), (64, 1, 16, 16), (8, 8)),
]


@pytest.mark.parametrize("img_shape,dict_shape,stride", GATE_GRID)
@pytest.mark.parametrize("algs", [("fista", "sc_cheap_quadratic_descent"),
                                  ("ista", "sc_steepest_descent"),
                                  ("subspace_fista",
                                   "sc_cheap_quadratic_descent"),
                                  ("fista", "ica_natural_gradient")])
@pytest.mark.parametrize("upd_iters", [1, 3])
def test_gate_matches_vtc_tpu(img_shape, dict_shape, stride, algs,
                              upd_iters):
  """The two gates agree wherever vtc_tpu's batch fits one VMEM tile;
  where it does not, vtc_tpu's answer is its tile rule's and the port
  (no tiles) answers from the math alone."""
  pad = ((8, 8), (8, 8))
  args = (img_shape, dict_shape, stride) + algs
  port = fused_conv_train.fused_conv_segment_supported(
      *args, upd_num_iters=upd_iters, padding=pad)
  jax_gate = jax_k12.fused_conv_segment_supported(
      *args, upd_num_iters=upd_iters, padding=pad)
  geo_ok = jax_k12._geo_supported(img_shape, dict_shape, stride)
  one_tile = geo_ok and jax_k12._pick_tile(
      img_shape[0], jax_k12._geometry(img_shape, dict_shape, stride))[1] == 1
  if one_tile or not geo_ok:
    assert port == jax_gate
  else:
    assert port == (algs[0] in ("ista", "fista")
                    and algs[1] in fused_conv_train.UPDATE_ALGS
                    and dict_shape[0] <= dict_shape[1] * (
                        -(-dict_shape[2] // stride[0]) * stride[0]) * (
                            -(-dict_shape[3] // stride[1]) * stride[1]))
  assert not fused_conv_train.fused_conv_segment_supported(
      *args, group_assignments=[[0, 1]])
  norm_pad = conv_shapes.normalize_padding(pad)
  assert (fused_conv_train.gram_stats_supported(img_shape, dict_shape,
                                                stride, norm_pad)
          == jax_k12.gram_stats_supported(img_shape, dict_shape, stride,
                                          norm_pad))


def _scanned_data(rng, k=6, b=2, s=6, kdim=4, img=8):
  """Conv-sparse maps of a random generating dictionary plus noise, with
  the padded border zeroed, and unit-norm initial kernels."""
  from vtc_tpu_torch.ops import convolutions as conv_ops
  padding = ((2, 2), (2, 2))
  gen = rng.randn(s, 1, kdim, kdim)
  gen /= np.sqrt((gen ** 2).sum(axis=(1, 2, 3), keepdims=True))
  hh = img + 4
  ch = 1 + (hh - kdim) // 2
  z = rng.randn(k * b, s, ch, ch) * (rng.rand(k * b, s, ch, ch) < 0.1)
  x = conv_ops.synthesize(torch.from_numpy(z.astype(np.float32)),
                          torch.from_numpy(gen.astype(np.float32)),
                          (2, 2)).numpy()
  x = (x + 0.05 * rng.randn(*x.shape)) * conv_shapes.create_mask(
      x.shape, padding).numpy()
  d0 = rng.randn(s, 1, kdim, kdim)
  d0 /= np.sqrt((d0 ** 2).sum(axis=(1, 2, 3), keepdims=True))
  return (x.reshape((k, b) + x.shape[1:]).astype(np.float32),
          d0.astype(np.float32), padding)


def _scanned_params(padding, **extra):
  params = {
      "mode": "convolutional",
      "num_epochs": 1,
      "code_inference_algorithm": "ista",
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 10},
          2: {"sparsity_weight": 0.04, "num_iters": 12}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": 0.01, "num_iters": 1},
          4: {"stepsize": 0.005, "num_iters": 2}},
      "strides": (2, 2),
      "padding": padding,
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


@pytest.mark.parametrize("extra", [
    {},
    {"dictionary_update_algorithm": "sc_steepest_descent",
     "code_inference_algorithm": "fista", "nonnegative_only": True},
])
def test_scanned_conv_trainer_matches_jax(rng, extra):
  data, d0, padding = _scanned_data(rng)
  params = _scanned_params(padding, **extra)
  want = np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, params))
  nudged = np.nextafter(d0, np.float32(2)).astype(np.float32)
  moved = np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      data, data[:1], nudged, params))
  bound = max(2e-5, 2.0 * float(np.abs(moved - want).max()))
  got = compiled_epoch.train_dictionary_scanned(data, data[:1], d0, params,
                                                device="cpu")
  assert got.dtype == torch.float32 and got.shape == d0.shape
  assert_close(got, want, 1.0 * bound, "scanned conv %s" % extra)
  np.testing.assert_allclose(
      torch.linalg.vector_norm(got.reshape(6, -1), dim=1).numpy(), 1.0,
      atol=1e-4)
  assert fused_conv_train.launches == 0 and fused_conv_direct.launches == 0


def test_scanned_conv_trainer_events_match_jax(rng, tmp_path):
  """Checkpoints, validation metrics and a
  prune (the 'random' filter, which reads no codes) in conv mode."""
  data, d0, padding = _scanned_data(rng)
  events = dict(checkpoint_schedule={2, 6},
                training_visualization_schedule={4},
                dict_element_rp_schedule={4: {
                    "filter_type": "random",
                    "filter_params": {"num_to_modify": 2},
                    "action": "prune"}})
  jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
  want = np.asarray(jax_compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, _scanned_params(
          padding, logging_folder_fullpath=str(jax_dir), **events)))
  got = compiled_epoch.train_dictionary_scanned(
      data, data[:1], d0, _scanned_params(
          padding, logging_folder_fullpath=str(port_dir), **events),
      device="cpu")
  assert got.shape == want.shape == (4, 1, 4, 4)
  from vtc_tpu.utils import checkpoint as jax_ckpt
  for it in (2, 6):
    name = "checkpoint_dictionary_iter_%d" % it
    jd = jax_ckpt.load_dictionary_checkpoint(jax_dir / name)
    pd = jax_ckpt.load_dictionary_checkpoint(port_dir / name)
    assert pd.shape == jd.shape
  assert list(port_dir.glob("events.out.tfevents.*"))
  assert bool(torch.isfinite(got).all())
  np.testing.assert_allclose(
      torch.linalg.vector_norm(got.reshape(4, -1), dim=1).numpy(), 1.0,
      atol=1e-4)


@pytest.mark.parametrize("update_alg", ["sc_cheap_quadratic_descent",
                                        "sc_steepest_descent"])
def test_fused_runner_equals_per_step_runner(rng, update_alg):
  """The trainer's two conv runners, on CPU tensors: the fused one (K12's
  plain version) and the per-step raw step with two warm power
  iterations."""
  data, d0, padding = _scanned_data(rng, k=3)
  d0t = torch.from_numpy(d0)
  h0 = torch.zeros(6)
  v0 = lipschitz.top_gram_eigenpair(d0t.reshape(6, -1))[1].contiguous()
  batches = torch.from_numpy(data)
  fused = compiled_epoch._fused_conv_segment_runner(
      "fista", update_alg, 2, False, False, True, (2, 2), padding)
  raw = sc.build_raw_step_fn(
      "convolutional", "fista", update_alg, kernel_stride=(2, 2),
      padding=padding, conv_formulation="pallas", lipschitz_method="power",
      compute_stepsize_in_step=False)
  per_step = compiled_epoch._segment_runner(
      raw, 2, True, lambda d: d.reshape(d.shape[0], -1))
  got = fused(d0t, h0, v0, batches, 0.05, 10, 0.01)
  want = per_step(d0t, h0, v0, batches, 0.05, 10, 0.01)
  for g, w, name in zip(got, want, ("dict", "hessian", "eigvec")):
    assert_close(g, w.numpy(), 1e-5, "fused vs per-step runner " + name)


@pytest.mark.cuda
def test_cuda_k12_matches_plain(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K12 has no CPU mode")
  d, h, v, x, strides, padding = _problem(rng)
  args = [torch.from_numpy(a).cuda() for a in (d, h, v, x)]
  before = fused_conv_train.launches
  got = fused_conv_train.fused_conv_train_segment(
      *args, 0.05, 12, 0.1, kernel_stride=strides, padding=padding,
      power_iters=2, update_alg="sc_steepest_descent")
  assert fused_conv_train.launches == before + 3
  want = fused_conv_train.fused_conv_train_plain(
      *[a.double() for a in args], 0.05, 12, 0.1, kernel_stride=strides,
      padding=padding, power_iters=2, update_alg="sc_steepest_descent")
  for g, w, name in zip(got, want, NAMES):
    assert_close(g.cpu(), w.cpu().numpy(), 1e-5, "K12 vs fp64 plain " + name)
