"""The port's ICA and PCA family against vtc_tpu on the CPU.

invertible_linear and the natural-gradient update are held to vtc_tpu at
1e-5.  K8's plain version (``fused_ica_train_plain``, what a CPU tensor
runs) is held to vtc_tpu's Pallas kernel ``fused_ica_train_segment_pallas``
in interpret mode at the shapes and bounds of
tests/test_pallas_ica_train.py:20-63 (D 2e-5, X 2e-4, residual 1e-5), with
one and three update iterations and with the residual-adaptive boost.
The trainers are held to vtc_tpu's at 2e-5, the JAX ICA trainer tests'
bound; PCA up to the sign of each row at 1e-4.  At stepsize 40 the fused
trainer's guard must roll back and land on its own per-step guarded path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vtc_tpu import api as jax_api
from vtc_tpu.analysis_transforms.fully_connected import (
    invertible_linear as jax_il)
from vtc_tpu.dict_update_rules.fully_connected import (
    ica_natural_gradient as jax_ing)
from vtc_tpu.ops import pallas_ica_train as jax_k8
from vtc_tpu.training import ica as jax_ica
from vtc_tpu.training import pca as jax_pca
from vtc_tpu_torch import api, convert
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    invertible_linear)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    ica_natural_gradient)
from vtc_tpu_torch.ops import fused_ica_train
from vtc_tpu_torch.training import ica, pca


def assert_close(got, want, atol, what):
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.1e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.1e" % (what, err, atol)


def _problem(rng, k=3, b=16, n=128, stepsize=0.02):
  """tests/test_pallas_ica_train.py:20-24."""
  d = np.linalg.qr(rng.randn(n, n))[0].astype(np.float32)
  d += 0.05 * rng.randn(n, n).astype(np.float32)
  batches = (0.5 * rng.randn(k, b, n)).astype(np.float32)
  return d, batches, stepsize


def _t(x):
  return torch.from_numpy(np.array(x, np.float32))


def test_invertible_linear_matches_jax(rng):
  d, batches, _ = _problem(rng, k=1, n=64)
  x = batches[0]
  q = np.linalg.qr(rng.randn(64, 64))[0].astype(np.float32)
  assert_close(invertible_linear._solve_nonortho(_t(x), _t(d)),
               jax_il._solve_nonortho(jnp.asarray(x), jnp.asarray(d)), 1e-5,
               "_solve_nonortho")
  assert_close(invertible_linear.run(x, _t(d)), jax_il.run(x, d), 1e-5,
               "run")
  assert_close(invertible_linear.run(x, _t(q), orthonormal=True),
               jax_il.run(x, q, orthonormal=True), 1e-5, "run orthonormal")
  inv = invertible_linear.exact_inverse(_t(d))
  assert_close(inv, jax_il.exact_inverse(jnp.asarray(d)), 1e-5,
               "exact_inverse")
  stale = (1.2 * inv.numpy()).astype(np.float32)
  for iters in (1, 3, 5):
    assert_close(invertible_linear.newton_refine_inverse(_t(d), _t(stale),
                                                         iters),
                 jax_il.newton_refine_inverse(jnp.asarray(d),
                                              jnp.asarray(stale), iters),
                 1e-5, "newton_refine_inverse x%d" % iters)


@pytest.mark.parametrize("case", ["healthy", "boost", "fallback", "nan"])
def test_refine_inverse_guarded_matches_jax(rng, case):
  """The guard's three outcomes: the refined inverse, the boosted one
  (two more refinements above boost_tol), and the LU fallback, which a
  NaN residual takes too."""
  d, _, _ = _problem(rng, k=1, n=64)
  inv = np.asarray(jax_il.exact_inverse(jnp.asarray(d)))
  seed = {"healthy": 1.05 * inv, "boost": 1.35 * inv,
          "fallback": 3.5 * inv, "nan": np.full_like(inv, np.nan)}[case]
  seed = seed.astype(np.float32)
  kw = dict(residual_tol=1e-3, boost_tol=1e-6 if case == "boost" else None)
  iters = 3 if case == "boost" else 2
  want = jax_il.refine_inverse_guarded(jnp.asarray(d), jnp.asarray(seed),
                                       iters, **kw)
  got = invertible_linear.refine_inverse_guarded(_t(d), _t(seed), iters,
                                                 **kw)
  assert bool(torch.isfinite(got).all())
  assert_close(got, want, 1e-5, "refine_inverse_guarded " + case)
  if case in ("fallback", "nan"):
    assert_close(got, invertible_linear.exact_inverse(_t(d)), 0.0,
                 "LU fallback")


@pytest.mark.parametrize("num_iters", [1, 3])
def test_natural_gradient_matches_jax(rng, num_iters):
  d, batches, _ = _problem(rng, k=1, n=64)
  codes = batches[0] @ np.linalg.inv(d).astype(np.float32)
  codes[0, :5] = 0.0  # sign(0) is 0 in both
  want = jax_ing.run(d, codes, stepsize=0.01, num_iters=num_iters)
  assert_close(ica_natural_gradient.run(_t(d), codes, stepsize=0.01,
                                        num_iters=num_iters), want, 1e-5,
               "ica_natural_gradient.run x%d" % num_iters)
  stat = (codes.T @ np.sign(codes) / codes.shape[0]).astype(np.float32)
  assert_close(ica_natural_gradient._update_from_stat(_t(d), _t(stat), 0.01,
                                                      num_iters),
               jax_ing._update_from_stat(jnp.asarray(d), jnp.asarray(stat),
                                         0.01, num_iters), 1e-5,
               "_update_from_stat")


def _k8_both(d0, xi0, batches, stepsize, **kw):
  want = jax_k8.fused_ica_train_segment_pallas(d0, xi0, batches, stepsize,
                                               interpret=True, **kw)
  got = fused_ica_train.fused_ica_train_segment(_t(d0), _t(xi0), _t(batches),
                                                stepsize, **kw)
  return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("upd_num_iters", [1, 3])
def test_k8_plain_matches_pallas(rng, upd_num_iters):
  d0, batches, stepsize = _problem(rng, k=3 if upd_num_iters == 1 else 2)
  xi0 = np.asarray(jax_il.exact_inverse(jnp.asarray(d0)))
  want, got = _k8_both(d0, xi0, batches, stepsize,
                       upd_num_iters=upd_num_iters)
  assert_close(got[0], want[0], 2e-5, "K8 D x%d" % upd_num_iters)
  assert_close(got[1], want[1], 2e-4, "K8 X x%d" % upd_num_iters)
  assert_close(got[2], want[2], 1e-5, "K8 residual x%d" % upd_num_iters)
  assert got[2].shape == () and float(got[2]) < 1e-3
  assert fused_ica_train.launches == 0  # CPU: the plain version


def test_k8_boost_matches_pallas(rng):
  """tests/test_pallas_ica_train.py:132-164: a stale seed (residual 0.35)
  leaves depth-3 refinement above the boost tolerance; the boost restores
  the fp floor."""
  n = 128
  d0 = (np.linalg.qr(rng.randn(n, n))[0]
        + 0.05 * rng.randn(n, n)).astype(np.float32)
  batches = (0.5 * rng.randn(3, 32, n)).astype(np.float32)
  xi0 = np.asarray(jax_il.exact_inverse(jnp.asarray(d0)))
  xi_stale = (1.35 * xi0).astype(np.float32)
  for boost_tol in (None, 1e-6):
    want, got = _k8_both(d0, xi_stale, batches, 0.01, refine_iters=3,
                         boost_tol=boost_tol)
    assert_close(got[0], want[0], 2e-5, "boost %s D" % boost_tol)
    assert_close(got[1], want[1], 2e-4, "boost %s X" % boost_tol)
    assert_close(got[2], want[2], 1e-5, "boost %s residual" % boost_tol)
    if boost_tol is None:
      assert float(got[2]) > 1e-5
    else:
      assert float(got[2]) < 1e-6


def test_k8_divergence_shows_in_the_residual(rng):
  d0, batches, _ = _problem(rng)
  xi0 = np.asarray(jax_il.exact_inverse(jnp.asarray(d0)))
  want, got = _k8_both(d0, xi0, batches, 40.0, refine_iters=3,
                       boost_tol=1e-6)
  for res in (float(want[2]), float(got[2])):
    assert not res < 1e-3  # NaN or above the guard tolerance


def _params(stepsize, **extra):
  params = {
      "num_epochs": 1,
      "dictionary_update_algorithm": "ica_natural_gradient",
      "dict_update_param_schedule": {0: {"stepsize": stepsize,
                                         "num_iters": 1}},
      "stdout_print_interval": 10**9,
  }
  params.update(extra)
  return params


@pytest.mark.parametrize("extra", [
    {"use_fused": False}, {"use_fused": True},
    {"use_fused": True, "refine_iters": 2},
    {"warm_inverse": False},
    {"use_fused": True, "num_epochs": 2,
     "dict_update_param_schedule": {0: {"stepsize": 0.02, "num_iters": 1},
                                    2: {"stepsize": 0.01,
                                        "num_iters": 2}}}])
def test_scanned_trainer_matches_jax(rng, extra):
  """The scanned trainer on CPU tensors (use_fused=True: K8's plain
  version) against vtc_tpu's per-step path at the same settings."""
  d0, batches, stepsize = _problem(rng, k=3)
  jax_extra = dict(extra, use_fused=False)
  want = np.asarray(jax_ica.train_dictionary_scanned(
      batches, d0.copy(), _params(stepsize, **jax_extra)))
  got = ica.train_dictionary_scanned(batches, d0, _params(stepsize, **extra),
                                     device="cpu")
  assert got.dtype == torch.float32 and got.shape == d0.shape
  assert_close(got, want, 2e-5, "scanned ICA %s" % extra)


@pytest.mark.parametrize("refine", [1, 4])
def test_refine_iters_reach_both_paths(rng, refine):
  d0, batches, stepsize = _problem(rng, k=3)
  want = np.asarray(jax_ica.train_dictionary_scanned(
      batches, d0.copy(), _params(stepsize, use_fused=False,
                                  refine_iters=refine)))
  for fused in (True, False):
    got = ica.train_dictionary_scanned(
        batches, d0, _params(stepsize, use_fused=fused, refine_iters=refine),
        device="cpu")
    assert_close(got, want, 2e-5, "use_fused=%s refine_iters %d" % (
        fused, refine))


def test_guard_rolls_back_on_divergence(rng):
  """tests/test_pallas_ica_train.py:95-105: stepsize 40 wrecks the
  dictionary faster than the refinements track it; the fused trainer's
  guard rolls back and reruns on the per-step guarded path, landing on
  the result of use_fused=False."""
  d0, batches, _ = _problem(rng, k=3)
  before = ica.rollbacks
  fused = ica.train_dictionary_scanned(batches, d0,
                                       _params(40.0, use_fused=True),
                                       device="cpu")
  assert ica.rollbacks >= before + 1
  stepped = ica.rollbacks
  tracked = ica.train_dictionary_scanned(batches, d0,
                                         _params(40.0, use_fused=False),
                                         device="cpu")
  assert ica.rollbacks == stepped  # the per-step path has no rollback
  assert bool(torch.isfinite(tracked).all())
  np.testing.assert_allclose(fused.numpy(), tracked.numpy(), rtol=1e-5,
                             atol=1e-5)
  # a healthy run takes none
  ica.train_dictionary_scanned(batches, d0, _params(0.02, use_fused=True),
                               device="cpu")
  assert ica.rollbacks == stepped


def test_per_batch_trainer_matches_jax(rng, tmp_path):
  d0, batches, stepsize = _problem(rng, k=4, n=64)
  params = _params(stepsize, num_epochs=2, checkpoint_schedule={3},
                   training_visualization_schedule={2},
                   logging_folder_fullpath=str(tmp_path / "port"))
  jax_params = dict(params, logging_folder_fullpath=str(tmp_path / "jax"))
  want = np.asarray(jax_ica.train_dictionary(batches, d0.copy(), jax_params))
  got = ica.train_dictionary(batches, d0, params, device="cpu")
  assert_close(got, want, 2e-5, "per-batch ICA")
  from vtc_tpu.utils import checkpoint as jax_ckpt
  name = "checkpoint_dictionary_iter_3"
  assert_close(jax_ckpt.load_dictionary_checkpoint(tmp_path / "port" / name),
               jax_ckpt.load_dictionary_checkpoint(tmp_path / "jax" / name),
               2e-5, "checkpoint")
  assert list((tmp_path / "port").glob("events.out.tfevents.*"))


def test_trainers_refuse_what_waits(rng):
  """Nothing waits any more: the tiers run since item 3a.2.3
  (tests/test_torch_port_ica_tiers.py holds them to vtc_tpu): the
  per-batch trainer reads no 'train_precision' (bitwise its own run
  without it), the scanned one trains at it; data_parallel runs; what
  stays refused is what vtc_tpu refuses."""
  d0, batches, stepsize = _problem(rng, k=2, n=16)
  plain = ica.train_dictionary(batches, d0, _params(stepsize), device="cpu")
  assert torch.equal(ica.train_dictionary(
      batches, d0, _params(stepsize, train_precision="bf16x3"),
      device="cpu"), plain)
  tiered = ica.train_dictionary_scanned(
      batches, d0, _params(stepsize, train_precision="bf16x3"), device="cpu")
  assert bool(torch.isfinite(tiered).all())
  assert float((tiered - _t(d0)).abs().max()) > 1e-4  # it trained
  # data_parallel no longer waits (item 9's layer): the scanned trainer and
  # PCA run it, True without a process group being a mesh of one rank
  # (tests/test_torch_port_parallel_train.py holds worlds of 2 and 4)
  for extra in ({}, {"use_fused": True}, {"warm_inverse": False}):
    want = ica.train_dictionary_scanned(batches, d0,
                                        _params(stepsize, **extra),
                                        device="cpu")
    got = ica.train_dictionary_scanned(
        batches, d0, _params(stepsize, data_parallel=True, **extra),
        device="cpu")
    assert_close(got, want.numpy(), 1e-6, "ICA data_parallel=True %s" % extra)
  x = batches[0] - batches[0].mean(0)
  assert np.array_equal(
      pca.train_dictionary(x, data_parallel=True, device="cpu").numpy(),
      pca.train_dictionary(x, device="cpu").numpy())
  # the per-batch trainer has no data-parallel mode, here or in vtc_tpu
  with pytest.raises(ValueError, match="no data-parallel mode"):
    ica.train_dictionary(batches, d0, _params(stepsize, data_parallel=True),
                         device="cpu")
  with pytest.raises(ValueError, match="unknown MXU tier"):
    fused_ica_train.fused_ica_train_segment(_t(d0), _t(d0), _t(batches), 0.1,
                                            mxu="bf32")


def test_gate_keeps_square_drops_tpu_rules():
  for n in (16, 100, 128, 256, 2048):
    assert fused_ica_train.fused_ica_segment_supported(n, 250)
  assert not jax_k8.fused_ica_segment_supported(100, 250)  # lanes, TPU only
  assert not jax_k8.fused_ica_segment_supported(2048, 250)  # VMEM, TPU only
  assert fused_ica_train.fused_ica_segment_supported(128, 250) == (
      jax_k8.fused_ica_segment_supported(128, 250))
  assert not fused_ica_train.fused_ica_segment_supported(128, 250, 64)
  assert not fused_ica_train.fused_ica_segment_supported(128, 0)


@pytest.mark.parametrize("shape", [(400, 32), (20, 48)])
def test_pca_matches_jax_up_to_sign(rng, shape):
  """Both branches: the covariance SVD (n <= D) and the data-matrix SVD
  (n > D)."""
  x = rng.randn(*shape).astype(np.float32) * np.linspace(
      3.0, 0.1, shape[1]).astype(np.float32)
  x -= x.mean(axis=0)
  want = np.asarray(jax_pca.train_dictionary(x))
  got = pca.train_dictionary(x, device="cpu").numpy()
  assert got.shape == want.shape
  signs = np.sign(np.sum(got * want, axis=1, keepdims=True))
  keep = min(shape) - 1  # centred: beyond the rank they are arbitrary
  assert_close((got * signs)[:keep], want[:keep], 1e-4, "PCA %s" % (shape,))
  np.testing.assert_allclose(got @ got.T, np.eye(got.shape[0]), atol=1e-4)


def test_coders_match_jax(rng):
  n = 16
  patches = (rng.laplace(size=(600, n)) @ rng.randn(n, n) / 4.0).astype(
      np.float32)
  jcoder = jax_api.ICACoder(stepsize=0.01, seed=3).fit(patches, num_epochs=1,
                                                       batch_size=100)
  coder = api.ICACoder(stepsize=0.01, seed=3, device="cpu").fit(
      patches, num_epochs=1, batch_size=100)
  assert_close(coder.dictionary, np.asarray(jcoder.dictionary), 2e-5,
               "ICACoder.fit")
  codes = coder.encode(patches[:50])
  assert_close(codes, np.asarray(jcoder.encode(patches[:50])), 1e-4,
               "ICACoder.encode")
  assert_close(coder.decode(codes), patches[:50], 1e-4, "ICACoder.decode")

  jpca = jax_api.PCACoder(num_components=6).fit(patches)
  pcoder = api.PCACoder(num_components=6, device="cpu").fit(patches)
  signs = np.sign(np.sum(pcoder.dictionary.numpy()
                         * np.asarray(jpca.dictionary), axis=1))
  assert pcoder.dictionary.shape == (6, n)
  assert_close(pcoder.dictionary.numpy() * signs[:, None],
               np.asarray(jpca.dictionary), 1e-4, "PCACoder.fit")
  assert_close(pcoder.component_means, jpca.component_means, 1e-6,
               "PCACoder means")
  pcodes = pcoder.encode(patches[:50])
  assert_close(pcodes.numpy() * signs, jpca.encode(patches[:50]), 1e-4,
               "PCACoder.encode")
  assert_close(pcoder.decode(pcodes), jpca.decode(np.asarray(
      jpca.encode(patches[:50]))), 1e-4, "PCACoder.decode")


def test_convert_takes_vtc_tpu_state(rng):
  d0, _, _ = _problem(rng, k=1, n=32)
  d, x = convert.ica_state_from_numpy(d0, None, "cpu")
  assert_close(x, np.asarray(jax_il.exact_inverse(jnp.asarray(d0))), 1e-5,
               "seeded inverse")
  d, x2 = convert.ica_state_from_numpy(d0, x.numpy(), "cpu")
  assert np.array_equal(x2.numpy(), x.numpy())
  with pytest.raises(ValueError, match="inverse"):
    convert.ica_state_from_numpy(d0, x.numpy()[:4], "cpu")
  jpca = jax_api.PCACoder(num_components=4).fit(rng.randn(80, 32))
  coder = api.PCACoder(device="cpu")
  coder.dictionary, coder.component_means = convert.pca_from_numpy(
      np.asarray(jpca.dictionary), jpca.component_means, "cpu")
  probe = rng.randn(5, 32)
  assert_close(coder.encode(probe), jpca.encode(probe), 1e-5,
               "PCACoder from vtc_tpu's state")


@pytest.mark.cuda
def test_cuda_k8_matches_plain(rng):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K8 has no CPU mode")
  d0, batches, stepsize = _problem(rng)
  xi0 = np.linalg.inv(d0).astype(np.float32)
  args = [_t(a).cuda() for a in (d0, xi0, batches)]
  before = fused_ica_train.launches
  got = fused_ica_train.fused_ica_train_segment(*args, stepsize,
                                                boost_tol=1e-6)
  assert fused_ica_train.launches == before + 3
  want = fused_ica_train.fused_ica_train_plain(
      *[a.double() for a in args], stepsize, boost_tol=1e-6)
  for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-5)):
    assert_close(g.cpu(), w.cpu().numpy(), tol, "K8 vs fp64 plain")
