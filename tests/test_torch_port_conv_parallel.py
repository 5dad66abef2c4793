"""Conv data parallelism of the port against vtc_tpu on the CPU: the plain
versions of K13 (one shard's solve+stats step) and K17 (a rank's whole
data-parallel segment), the conv data-parallel steps and runners, both conv
trainers and the conv encode with ``data_parallel``.

The same seeded numpy inputs go through both packages, at the geometry of
tests/test_parallel.py:347-440 (b 8, s 8, c 1, 4x4 kernels at stride 2, 12x12
images padded by 2) and a zero-extended one (3x3 at stride 2).  The kernels
are windowed (a Gaussian of 0.8 pixels), as trained kernels are localized:
with unwindowed random kernels the flat-kernel stepsize makes FISTA diverge
in both packages (ROADMAP.md §3), and a diverging run compares nothing.

* K13's plain version (what a CPU tensor runs) against vtc_tpu's
  ``conv_solve_stats_pallas(interpret=True)``, both forms; the gram form
  recombined, unpack(pack(D') @ cm - bx), against the gradient at D'.
* K17's plain version at a world of 1 against vtc_tpu's
  ``fused_conv_dp_train_segment_pallas(interpret=True)`` on a one-device
  axis, both forms; that reference also holds the runners of every world.
* Worlds of 2 and 4 are spawned CPU processes in one gloo group
  (tests/torch_port_dp_worker.py), one spawn per world size for the file.
  Each result is held to vtc_tpu's and to the port's single-device one:
  rtol and atol 2e-5 x max(1, |max|), vtc_tpu's own bound for its conv DP
  runners (tests/test_parallel.py:397-400, :437-440), the trainers
  included (six steps are too few for the cheap-quadratic rule to amplify
  rounding past it, ROADMAP.md §3); 3e-5 for the eigvalsh trainer
  (tests/test_compiled_epoch.py:346).  vtc_tpu's references are computed
  once and shared by both world sizes: the world changes only the order of
  the sums.  Replicated state must be bitwise equal on every rank.
* vtc_tpu's trainers run on its 8-device mesh, where its scanned trainer
  takes the per-step K13 composition; the port's takes K17 on a mesh
  without a 'dcn' axis (vtc_tpu's choice on the card's count of devices)
  and K13's composition on a mesh with one, which a ``dcn=2`` case drives.
* The psum-per-op step of a geometry without the code-space gradient (9x2
  kernels at stride 1: 51 overlap offsets) is held to the port's single
  device only: vtc_tpu's compile of its 51-offset Gram operator takes 20 s
  here, and the image-space gradient it takes is held to vtc_tpu's in
  tests/test_torch_port_conv.py and tests/test_torch_port_conv_train.py.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

import torch_port_dp_worker as worker
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.ops import lipschitz as jax_lip
from vtc_tpu.ops import pallas_conv_dp_train as jax_conv_dp
from vtc_tpu.ops import pallas_conv_train as jax_k13
from vtc_tpu.parallel import data_parallel as jax_dp
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu.training import sparse_coding as jax_sc
from vtc_tpu_torch import parallel
from vtc_tpu_torch.analysis_transforms.convolutional import (
    ista_fista as conv_ista_fista)
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import conv_shapes, fused_conv_direct
from vtc_tpu_torch.ops import fused_conv_dp_train, fused_conv_train
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import sparse_coding as sc

WORLDS = (2, 4)
SW, N_IT, UPD_STEP = 0.05, 10, 0.1
CQ, SD = "sc_cheap_quadratic_descent", "sc_steepest_descent"


def assert_close(got, want, what, rel=2e-5):
  """|got - want| <= rel * max(1, |want|max) everywhere."""
  got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
  want = np.asarray(want, np.float64)
  err = float(np.max(np.abs(np.asarray(got, np.float64) - want)))
  bound = rel * max(1.0, float(np.abs(want).max()))
  print("%s: max|d| = %.3e (bound %.1e)" % (what, err, bound))
  assert err <= bound, "%s: max|d| %.3e > %.1e" % (what, err, bound)


def _t(x):
  return torch.from_numpy(np.array(x, dtype=np.float32))


def _windowed(rng, s, c, k, sigma=0.8):
  yy = np.arange(k) - (k - 1) / 2.0
  window = np.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * sigma ** 2))
  d = rng.randn(s, c, k, k) * window
  return (d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))).astype(
      np.float32)


def _problem(seed, kdim=4, stride=2, img=12, k=2, b=8, s=8, padding=None,
             kw=None):
  """Windowed kernels (kdim x kw), a small Hessian, the exact eigenvector
  seed and (k, b, 1, H, W) images with a zero border."""
  rng = np.random.RandomState(seed)
  kw = kdim if kw is None else kw
  if padding is None:
    padding = (conv_shapes.get_padding_amt(img, kdim, stride),
               conv_shapes.get_padding_amt(img, kw, stride))
  (lv, tv), (lh, th) = padding
  height, width = img + lv + tv, img + lh + th
  d = _windowed(rng, s, 1, kdim)[..., :kw]
  d /= np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))
  x = np.zeros((k, b, 1, height, width), np.float32)
  x[..., lv:height - tv, lh:width - th] = 0.3 * rng.randn(k, b, 1, img, img)
  h = (np.abs(rng.rand(s)) * 0.01).astype(np.float32)
  v = np.asarray(jax_lip.top_gram_eigenpair(jnp.asarray(d).reshape(s, -1))[1])
  return dict(d=d, h=h, v=v, x=x, stride=(stride, stride), padding=padding)


GEO = {"4x4/2": _problem(0),
       # kernels not a stride multiple: zero-extended to 4x4, stride-exact
       # padding by hand ((padded - kernel) % stride == 0)
       "3x3/2 zero-extended": _problem(1, kdim=3, padding=((1, 2), (1, 2))),
       # (2 * 8 + 1) x 3 = 51 > 49 overlap offsets: no code-space
       # dictionary gradient (the fewest that turn it away, and so the
       # cheapest code-space Gram operator for vtc_tpu to compile)
       "9x2/1": _problem(2, kdim=9, kw=2, stride=1, img=4, s=4)}


# ---------------------------------------------------------------------------
# K13's plain version against the Pallas kernel
# ---------------------------------------------------------------------------
K13_CASES = {  # name: (geometry, gram_stats, flags)
    "4x4/2 fista": ("4x4/2", False, {}),
    "4x4/2 fista gram form": ("4x4/2", True, {}),
    "4x4/2 ista hard nonneg": ("4x4/2", False, {
        "variant": "ista", "hard": True, "nonneg": True}),
    "3x3/2 zero-extended": ("3x3/2 zero-extended", False, {}),
}


@pytest.mark.parametrize("name", sorted(K13_CASES))
def test_k13_plain_matches_the_pallas_kernel(name):
  geo_name, gram, flags = K13_CASES[name]
  p = GEO[geo_name]
  kw = dict(kernel_stride=p["stride"], padding=p["padding"], power_iters=2,
            gram_stats=gram, **flags)
  want = jax_k13.conv_solve_stats_pallas(p["d"], p["v"], p["x"][0], SW, N_IT,
                                         interpret=True, **kw)
  got = fused_conv_train.conv_solve_stats(_t(p["d"]), _t(p["v"]),
                                          _t(p["x"][0]), SW, N_IT, **kw)
  names = (("codes", "bx", "cm", "stat", "eigvec", "eta") if gram
           else ("codes", "grad_sum", "stat", "eigvec", "eta"))
  assert len(got) == len(want) == len(names)
  for what, g, w in zip(names, got, want):
    assert tuple(g.shape) == tuple(np.shape(w)), what
    assert_close(g, w, "%s %s" % (name, what))
  codes = got[0]
  assert 0.0 < float((codes != 0).float().mean()) < 1.0  # sparse, not dead


@pytest.mark.parametrize("at", ["D", "D'"])
def test_gram_form_recombines_to_the_gradient(at):
  """unpack(pack(D') @ cm - bx) is the shard's gradient sum at D' for any
  D': at the solve dictionary it is the gradient form's grad_sum."""
  p = GEO["4x4/2"]
  kw = dict(kernel_stride=p["stride"], padding=p["padding"], power_iters=2)
  d, x = _t(p["d"]), _t(p["x"][0])
  codes, grad_sum, _, _, _ = fused_conv_train.conv_solve_stats(
      d, _t(p["v"]), x, SW, N_IT, **kw)
  _, bx, cm, _, _, _ = fused_conv_train.conv_solve_stats(
      d, _t(p["v"]), x, SW, N_IT, gram_stats=True, **kw)
  geo = fused_conv_direct.geometry(x.shape, d.shape, p["stride"])
  d_at = d
  if at == "D'":
    d_at = d + 0.1 * _t(np.random.RandomState(5).randn(*d.shape))
    stats = fused_conv_direct.build_block_update_stats(
        x, codes, d.shape, p["stride"], p["padding"])
    grad_sum = fused_conv_direct.dictionary_gradient_from_block_stats(
        stats, d_at) * x.shape[0]
  rec = fused_conv_direct.unpack_dstk(
      fused_conv_direct.pack_weights(d_at, geo)[0] @ cm - bx, geo, d.shape)
  assert_close(rec, grad_sum.numpy(), "recombined gradient at " + at)


def test_the_gates_match_vtc_tpu_and_refuse_the_gram_form_off_them():
  for img_shape, dict_shape, stride, padding in (
      ((8, 1, 16, 16), (8, 1, 4, 4), (2, 2), ((2, 2), (2, 2))),
      ((8, 1, 14, 14), (8, 1, 4, 4), (2, 2), ((1, 1), (1, 1))),
      ((8, 1, 15, 15), (8, 1, 3, 3), (2, 2), ((1, 2), (1, 2))),
      ((4, 3, 12, 12), (6, 3, 4, 4), (4, 4), ((0, 0), (0, 0))),
      ((4, 1, 272, 272), (64, 1, 16, 16), (8, 8), ((8, 8), (8, 8)))):
    for upd in (1, 3):
      for alg in ("fista", "subspace_fista"):
        args = (img_shape, dict_shape, stride, alg, CQ)
        assert fused_conv_train.conv_solve_stats_supported(
            *args, upd_num_iters=upd, padding=padding) == (
                jax_k13.conv_solve_stats_supported(
                    *args, upd_num_iters=upd, padding=padding)), (args, upd)
    assert fused_conv_train.gram_stats_supported(
        img_shape, dict_shape, stride, padding) == (
            jax_k13.gram_stats_supported(img_shape, dict_shape, stride,
                                         padding))
  # odd padding: the mask is not stride-block uniform, the gram form is
  # refused before anything runs
  rng = np.random.RandomState(3)
  x = _t(np.pad(rng.randn(2, 1, 12, 12), ((0, 0), (0, 0), (1, 1), (1, 1))))
  d = _t(_windowed(rng, 8, 1, 4))
  v = torch.ones(8)
  assert not fused_conv_train.conv_solve_stats_supported(
      x.shape, d.shape, (2, 2), "fista", CQ, upd_num_iters=3,
      padding=((1, 1), (1, 1)))
  with pytest.raises(ValueError, match="gram_stats"):
    fused_conv_train.conv_solve_stats(d, v, x, SW, 5, kernel_stride=(2, 2),
                                      padding=((1, 1), (1, 1)),
                                      gram_stats=True)
  # vtc_tpu's K13 has no stop test, and the refusal names the kernel that
  # has the data-parallel conv stop
  with pytest.raises(NotImplementedError, match="conv stop is K17's"):
    fused_conv_train.conv_solve_stats(d, v, x, SW, 5, kernel_stride=(2, 2),
                                      padding=((1, 1), (1, 1)),
                                      early_stopping_epsilon=1e-3)
  # the tiers run (tests/test_torch_port_conv_tiers.py holds them to
  # vtc_tpu): a CPU tensor takes the plain version at the tier
  kw = dict(kernel_stride=(2, 2), padding=((1, 1), (1, 1)), mxu="bf16x3")
  for got, want in zip(
      fused_conv_train.conv_solve_stats(d, v, x, SW, 5, **kw),
      fused_conv_train.conv_solve_stats_plain(d, v, x, SW, 5, **kw)):
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the multi-rank cases: one spawn per world size
# ---------------------------------------------------------------------------
RUNNERS = {"K17 segment": "conv_dp_runner",
           "K13 composition": "conv_fused_runner"}
RUNNER_CASES = {  # name: (geometry, update rule, upd_num_iters)
    "cheap-quad upd 1": ("4x4/2", CQ, 1),
    "cheap-quad upd 3 (gram form)": ("4x4/2", CQ, 3),
    "steepest 3x3/2 zero-extended": ("3x3/2 zero-extended", SD, 1),
}
# the step cases held to the port's single device only (the docstring says
# why)
SINGLE_DEVICE_ONLY = {"9x2/1 cheap-quad (image-space gradient)"}
STEP_CASES = {  # name: (geometry, update rule, extra config)
    "4x4/2 steepest (code-space gradient)": ("4x4/2", SD, {}),
    "9x2/1 cheap-quad (image-space gradient)": ("9x2/1", CQ,
                                                {"upd_num_iters": 2}),
    "4x4/2 cheap-quad early stop": ("4x4/2", CQ,
                                    {"early_stopping_epsilon": 1e-2}),
}
EARLY = dict(n_it=60, eps=1e-2)


def _step_config(name):
  geo_name, _, extra = STEP_CASES[name]
  p = GEO[geo_name]
  return dict(extra, kernel_stride=p["stride"], padding=p["padding"],
              lipschitz_method="eigvalsh")


def _scanned_params(**extra):
  p = GEO["4x4/2"]
  params = {
      "mode": "convolutional", "num_epochs": 2, "strides": p["stride"],
      "padding": p["padding"], "code_inference_algorithm": "fista",
      "inference_param_schedule": {0: {"sparsity_weight": SW,
                                       "num_iters": N_IT}},
      "dictionary_update_algorithm": CQ,
      "dict_update_param_schedule": {0: {"stepsize": 0.05, "num_iters": 1},
                                     3: {"stepsize": 0.05, "num_iters": 3}},
      "stdout_print_interval": 10 ** 9}
  params.update(extra)
  return params


def _eigvalsh_case():
  """tests/test_compiled_epoch.py:323's configuration: the psum-per-op
  step (an explicit lipschitz_method computes the stepsize in the step)."""
  rng = np.random.RandomState(0)
  data = rng.randn(3, 8, 1, 12, 12).astype(np.float32)
  d0 = rng.randn(6, 1, 4, 4).astype(np.float32)
  d0 /= np.linalg.norm(d0.reshape(6, -1), axis=1)[:, None, None, None]
  params = {
      "mode": "convolutional", "num_epochs": 2, "strides": (2, 2),
      "padding": ((1, 1), (1, 1)), "code_inference_algorithm": "fista",
      "inference_param_schedule": {0: {"sparsity_weight": 0.02,
                                       "num_iters": 6}},
      "dictionary_update_algorithm": SD,
      "dict_update_param_schedule": {0: {"stepsize": 0.05, "num_iters": 1}},
      "lipschitz_method": "eigvalsh", "stdout_print_interval": 10 ** 9}
  return data, d0, params


TRAIN_X = _problem(4, k=3)["x"]
TRAIN_D0 = GEO["4x4/2"]["d"]
POWER_WARM = "scanned power_warm cheap-quad (K17, gram form from step 3)"
TRAIN_CASES = {  # name: (trainer, batches, d0, params, relative bound, dcn)
    "scanned eigvalsh steepest (psum-per-op)": ("scanned",) + _eigvalsh_case()
    + (3e-5, 1),
    POWER_WARM: ("scanned", TRAIN_X, TRAIN_D0, _scanned_params(), 2e-5, 1),
    # the same run on a mesh of two slices: K13's composition
    "scanned power_warm cheap-quad, dcn=2 (K13)": (
        "scanned", TRAIN_X, TRAIN_D0, _scanned_params(), 2e-5, 2),
    "per-batch ista steepest": (
        "per_batch", TRAIN_X, TRAIN_D0, _scanned_params(
            code_inference_algorithm="ista",
            dictionary_update_algorithm=SD), 2e-5, 1),
}
ENC_X = GEO["4x4/2"]["x"][:2].reshape(16, 1, 16, 16)[:10]
ENC_KW = dict(mode="convolutional", kernel_stride=(2, 2),
              padding=((2, 2), (2, 2)), batch_size=8, chunk_batches=1)
MESH_IMAGES = np.arange(8 * 1 * 5 * 5, dtype=np.float32).reshape(8, 1, 5, 5)
MESH_BATCHES = np.arange(3 * 8 * 2 * 3 * 3, dtype=np.float32).reshape(
    3, 8, 2, 3, 3)
# the gram-form statistics at the flagship: bx (64, 256), cm (256, 256)
MESH_STATS = tuple(np.random.RandomState(9).randn(*shape).astype(np.float32)
                   for shape in ((64, 256), (256, 256), (64,)))


@functools.lru_cache(maxsize=None)
def rank_results(world):
  cases = [("mesh nd", "mesh_nd", dict(images=MESH_IMAGES,
                                       batches=MESH_BATCHES,
                                       stats=MESH_STATS))]
  for name, (geo_name, alg, upd) in RUNNER_CASES.items():
    p = GEO[geo_name]
    for runner, case in RUNNERS.items():
      config = dict(kernel_stride=p["stride"], padding=p["padding"],
                    upd_num_iters=upd)
      if case == "conv_fused_runner":
        config["power_iters"] = 2
      cases.append(("%s %s" % (runner, name), case, dict(
          d=p["d"], h=p["h"], v=p["v"], batches=p["x"], sw=SW, n_it=N_IT,
          upd_step=UPD_STEP, inference_alg="fista", update_alg=alg,
          config=config)))
  for name, (geo_name, alg, _) in STEP_CASES.items():
    p = GEO[geo_name]
    n_it = EARLY["n_it"] if "early" in name else N_IT
    cases.append(("step " + name, "shard_map_step", dict(
        d=p["d"], h=p["h"], batch=p["x"][0], sw=SW, n_it=n_it,
        upd_step=UPD_STEP, mode="convolutional", inference_alg="fista",
        update_alg=alg, config=_step_config(name))))
  p = GEO["4x4/2"]
  cases.append(("early stop", "conv_early_stop", dict(
      d=p["d"], batch=p["x"][0], sw=SW, n_it=EARLY["n_it"], eps=EARLY["eps"],
      kernel_stride=p["stride"], padding=p["padding"])))
  for name, (trainer, batches, d0, params, _, dcn) in TRAIN_CASES.items():
    cases.append(("train " + name, "train", dict(
        trainer=trainer, batches=batches, val=batches[:1], d0=d0,
        params=params, dcn=dcn)))
  cases.append(("encode", "encode", dict(data=ENC_X, d=TRAIN_D0, sw=SW,
                                         n_it=N_IT, kw=ENC_KW)))
  return worker.run_ranks(world, cases)


def _replicated(world, key):
  results = rank_results(world)
  first = results[0][key]
  for other in results[1:]:
    for a, b in zip(first, other[key]):
      assert np.array_equal(a, b), "%s differs across ranks" % key
  return first


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_shards_gathers_and_sums_conv_arrays(world):
  results = rank_results(world)
  per = 8 // world
  for rank, out in enumerate(results):
    out = out["mesh nd"]
    assert tuple(out["bounds"]) == (rank * per, (rank + 1) * per)
    assert np.array_equal(out["shard4"], MESH_IMAGES[rank * per:
                                                     (rank + 1) * per])
    assert np.array_equal(out["shard5"],
                          MESH_BATCHES[:, rank * per:(rank + 1) * per])
    assert np.array_equal(out["gather4"], MESH_IMAGES)
    assert np.array_equal(out["gather5"], MESH_BATCHES)
    scale = world * (world + 1) / 2
    for i, (got, a) in enumerate(zip(out["sum"], MESH_STATS)):
      assert got.shape == a.shape
      np.testing.assert_allclose(got, scale * a, rtol=1e-6, atol=1e-6)
      assert np.array_equal(got, results[0]["mesh nd"]["sum"][i])
    # the in-place sum of the packed buffer gives the same bytes
    assert out["sum_ returns it"]
    assert np.array_equal(out["sum_"], np.concatenate(
        [t.reshape(-1) for t in out["sum"]]))


@functools.lru_cache(maxsize=None)
def jax_k17(name):
  """vtc_tpu's K17 in interpret mode on a one-device 'data' axis over the
  global batches of RUNNER_CASES[name]: (kernels, hessian, eigvec, last
  codes)."""
  geo_name, alg, upd = RUNNER_CASES[name]
  p = GEO[geo_name]

  def body(d, h, v, x):
    return jax_conv_dp.fused_conv_dp_train_segment_pallas(
        d, h, v, x, SW, N_IT, UPD_STEP, kernel_stride=p["stride"],
        padding=p["padding"], axis_name="data", axis_size=1, update_alg=alg,
        upd_num_iters=upd, power_iters=2, interpret=True)

  rep = PartitionSpec()
  fn = jax.jit(jax.shard_map(body, mesh=jax_parallel.make_mesh(data=1),
                             in_specs=(rep,) * 4, out_specs=(rep,) * 4,
                             check_vma=False))
  return tuple(np.asarray(a) for a in fn(p["d"], p["h"], p["v"], p["x"]))


@pytest.mark.parametrize("name", sorted(RUNNER_CASES))
def test_k17_plain_matches_the_pallas_kernel(name):
  """What a CPU tensor runs at a world of 1: K13's plain step, the sum over
  a mesh of one and the replicated update, per batch."""
  geo_name, alg, upd = RUNNER_CASES[name]
  p = GEO[geo_name]
  calls = fused_conv_dp_train.launches
  got = fused_conv_dp_train.fused_conv_dp_train_segment(
      _t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), SW, N_IT, UPD_STEP,
      mesh=parallel.make_mesh(), kernel_stride=p["stride"],
      padding=p["padding"], update_alg=alg, upd_num_iters=upd, power_iters=2)
  assert fused_conv_dp_train.launches == calls  # no kernel on the CPU
  assert float(np.abs(got[0].numpy() - p["d"]).max()) > 1e-3  # it trained
  for what, g, w in zip(("kernels", "hessian", "eigvec", "last codes"), got,
                        jax_k17(name)):
    assert tuple(g.shape) == w.shape, what
    assert_close(g, w, "K17 %s %s" % (name, what))


def test_k17_refuses_what_waits():
  p = GEO["4x4/2"]
  args = (_t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), SW, N_IT, UPD_STEP)
  kw = dict(mesh=parallel.make_mesh(), kernel_stride=p["stride"],
            padding=p["padding"])
  # the tiers run (tests/test_torch_port_conv_tiers.py holds them to
  # vtc_tpu): a CPU tensor takes the plain version at the tier
  for got, want in zip(
      fused_conv_dp_train.fused_conv_dp_train_segment(*args, **kw,
                                                      mxu="bf16x3"),
      fused_conv_dp_train.fused_conv_dp_train_plain(*args, **kw,
                                                    mxu="bf16x3")):
    assert torch.equal(got, want)
  # the early stop runs (since K17 took it): a CPU tensor takes the plain
  # version with the stop test over the mesh
  calls = fused_conv_dp_train.launches
  got = fused_conv_dp_train.fused_conv_dp_train_segment(
      *args, **kw, early_stopping_epsilon=1e-3)
  want = fused_conv_dp_train.fused_conv_dp_train_plain(
      *args, **kw, early_stopping_epsilon=1e-3)
  assert fused_conv_dp_train.launches == calls
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  # the gram form off its gate: padding 1 at stride 2
  x = _t(p["x"][:, :, :, 1:-1, 1:-1])
  with pytest.raises(ValueError, match="conv_solve_stats_supported"):
    fused_conv_dp_train.fused_conv_dp_train_segment(
        *args[:3], x, *args[4:], mesh=kw["mesh"], kernel_stride=(2, 2),
        padding=((1, 1), (1, 1)), upd_num_iters=3)


@functools.lru_cache(maxsize=None)
def single_device_k12(name):
  geo_name, alg, upd = RUNNER_CASES[name]
  p = GEO[geo_name]
  return fused_conv_train.fused_conv_train_plain(
      _t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), SW, N_IT, UPD_STEP,
      kernel_stride=p["stride"], padding=p["padding"], update_alg=alg,
      upd_num_iters=upd, power_iters=2)


@pytest.mark.parametrize("runner", sorted(RUNNERS))
@pytest.mark.parametrize("name", sorted(RUNNER_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_conv_dp_runners_match_vtc_tpu_k17_and_k12(world, name, runner):
  got = _replicated(world, "%s %s" % (runner, name))
  p = GEO[RUNNER_CASES[name][0]]
  assert float(np.abs(got[0] - p["d"]).max()) > 1e-3  # it trained
  for what, g, want, one in zip(("dictionary", "hessian", "eigvec"), got,
                                jax_k17(name), single_device_k12(name)):
    assert_close(g, want, "%s vs vtc_tpu's K17" % what)
    assert_close(g, one, "%s vs the port's single-device K12 plain" % what)


@functools.lru_cache(maxsize=None)
def jax_step(name):
  """vtc_tpu's step on its 8-device mesh (one compile per case)."""
  geo_name, alg, _ = STEP_CASES[name]
  p = GEO[geo_name]
  step = jax_dp.build_shard_map_train_step(
      jax_parallel.make_mesh(data=8), "convolutional", "fista", alg,
      **_step_config(name))
  n_it = EARLY["n_it"] if "early" in name else N_IT
  return tuple(np.asarray(a) for a in step(
      jnp.asarray(p["d"]), jnp.asarray(p["h"]), jnp.asarray(p["x"][0]),
      jnp.float32(SW), jnp.int32(n_it), jnp.float32(UPD_STEP)))


@pytest.mark.parametrize("name", sorted(STEP_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_shard_map_step_matches_vtc_tpu_and_single_device(world, name):
  got = _replicated(world, "step " + name)
  geo_name, alg, extra = STEP_CASES[name]
  p = GEO[geo_name]
  config = _step_config(name)
  upd_iters = config.pop("upd_num_iters", 1)
  raw = sc.build_raw_step_fn("convolutional", "fista", alg,
                             conv_formulation="gram", **config)
  n_it = EARLY["n_it"] if "early" in name else N_IT
  single = raw(_t(p["d"]), _t(p["h"]), _t(p["x"][0]), SW, n_it, UPD_STEP,
               upd_iters, None)
  for what, g, one in zip(("dictionary", "hessian", "codes"), got, single):
    assert_close(g, one, "%s vs the port's single device" % what)
  if name not in SINGLE_DEVICE_ONLY:
    for what, g, want in zip(("dictionary", "hessian", "codes"), got,
                             jax_step(name)):
      assert_close(g, want, "%s vs vtc_tpu's 8-device mesh" % what)


@pytest.mark.parametrize("world", WORLDS)
def test_early_stop_leaves_at_the_single_device_iteration(world):
  ranks = rank_results(world)
  counts = {out["early stop"]["reductions"] for out in ranks}
  assert len(counts) == 1  # every rank left at the same iteration
  p = GEO["4x4/2"]
  d, batch = _t(p["d"]), _t(p["x"][0])
  one = parallel.make_mesh()  # a mesh of one: the single-device stop test
  tests = []
  original = one.mean
  one.mean = lambda t: (tests.append(1), original(t))[1]
  flat = d.reshape(d.shape[0], -1)
  eta = 1.0 / torch.linalg.eigvalsh(flat @ flat.T)[-1]
  init = torch.zeros((8, 8) + conv_ista_fista.code_spatial_dims(
      batch.shape, d.shape, p["stride"]))
  single = conv_ista_fista._solve(
      batch, d, conv_shapes.create_mask(batch.shape, p["padding"]), SW,
      EARLY["n_it"], eta, init, p["stride"], "fista", False, False,
      EARLY["eps"], formulation="gram", padding=p["padding"], psum_axes=one)
  assert counts == {len(tests)}, (counts, len(tests))
  assert 2 < len(tests) + 1 < EARLY["n_it"]  # it stopped early
  for out in ranks:
    assert np.array_equal(out["early stop"]["codes"],
                          ranks[0]["early stop"]["codes"])
  assert_close(ranks[0]["early stop"]["codes"], single.numpy(),
               "codes vs the single-device early-stopped solve")


@functools.lru_cache(maxsize=None)
def jax_trained(name):
  """vtc_tpu's result on its 8-device mesh (the dcn case shares the
  power_warm case's)."""
  if "dcn" in name:
    return jax_trained(POWER_WARM)
  trainer, batches, d0, params, _, _ = TRAIN_CASES[name]
  fn = (jax_ce.train_dictionary_scanned if trainer == "scanned"
        else jax_sc.train_dictionary)
  params = dict(params, data_parallel=jax_parallel.make_mesh(data=8))
  return np.asarray(fn(batches, batches[:1], d0.copy(), params))


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_conv_trainer_matches_vtc_tpu_and_single_device(world, name):
  got = rank_results(world)[0]["train " + name]
  for out in rank_results(world)[1:]:
    assert np.array_equal(out["train " + name], got)
  trainer, batches, d0, params, rel, dcn = TRAIN_CASES[name]
  assert got.shape == d0.shape and np.isfinite(got).all()
  assert float(np.abs(got - d0).max()) > 1e-3  # it trained
  assert_close(got, jax_trained(name), "vs vtc_tpu on its 8-device mesh",
               rel)
  fn = (compiled_epoch.train_dictionary_scanned if trainer == "scanned"
        else sc.train_dictionary)
  single = fn(batches, batches[:1], d0, params, device="cpu")
  assert_close(got, single, "vs the port's single device", rel)
  if dcn > 1:  # K13's composition gives K17's numbers
    assert_close(got, rank_results(world)[0]["train " + POWER_WARM],
                 "K13's composition vs K17", rel)


@pytest.mark.parametrize("world", WORLDS)
def test_conv_encode_matches_vtc_tpu_and_single_device(world):
  got = rank_results(world)[0]["encode"]
  for out in rank_results(world)[1:]:
    assert np.array_equal(out["encode"], got)
  assert got.shape == (10, 8, 7, 7)
  want = np.asarray(jax_encode_dataset(
      ENC_X, TRAIN_D0, SW, N_IT, data_parallel=jax_parallel.make_mesh(data=8),
      **ENC_KW))
  assert_close(got, want, "vs vtc_tpu on its mesh", 1e-5)
  single = encode_dataset(ENC_X, TRAIN_D0, SW, N_IT, device="cpu", **ENC_KW)
  assert_close(got, single, "vs the port's single device", 1e-5)
  with pytest.raises(ValueError, match="divide by the DP size"):
    encode_dataset(ENC_X, TRAIN_D0, SW, N_IT, device="cpu",
                   data_parallel=parallel.Mesh(3, group=object(), index=0),
                   **ENC_KW)


# ---------------------------------------------------------------------------
# a world of 1, with no process group
# ---------------------------------------------------------------------------
def test_world_of_one_runs_k17_and_no_k12_step(monkeypatch):
  """The scanned conv trainer with data_parallel goes through K17's wrapper
  (its plain version on CPU tensors), one call per segment of one update
  count, in both forms, and never through K13's or K12's wrapper."""
  assert not torch.distributed.is_initialized()
  calls = []
  original = fused_conv_dp_train.fused_conv_dp_train_segment

  def counted(*args, **kwargs):
    calls.append((args[3].shape[0], kwargs["upd_num_iters"]))
    return original(*args, **kwargs)

  def forbidden(what):
    def fail(*args, **kwargs):
      raise AssertionError(what + " ran under data_parallel")
    return fail

  monkeypatch.setattr(fused_conv_dp_train, "fused_conv_dp_train_segment",
                      counted)
  monkeypatch.setattr(fused_conv_train, "fused_conv_train_segment",
                      forbidden("K12's segment"))
  monkeypatch.setattr(fused_conv_train, "conv_solve_stats",
                      forbidden("K13's step"))
  _, batches, d0, params, _, _ = TRAIN_CASES[POWER_WARM]
  got = compiled_epoch.train_dictionary_scanned(
      batches, batches[:1], d0, dict(params, data_parallel=True),
      device="cpu")
  # 2 epochs of 3 steps: one update iteration for steps 0-2 (the gradient
  # form), three after (the gram form)
  assert calls == [(3, 1), (3, 3)], calls
  single = compiled_epoch.train_dictionary_scanned(batches, batches[:1], d0,
                                                   params, device="cpu")
  assert_close(got, single, "a mesh of one vs the single device")


@pytest.mark.cuda
def test_cuda_conv_dp_runs_k13_and_k17():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: K13 and K17 have no CPU mode")
  p = GEO["4x4/2"]
  kw = dict(kernel_stride=p["stride"], padding=p["padding"], power_iters=2)
  for gram in (False, True):
    got = fused_conv_train.conv_solve_stats(
        _t(p["d"]).cuda(), _t(p["v"]).cuda(), _t(p["x"][0]).cuda(), SW,
        N_IT, gram_stats=gram, **kw)
    want = fused_conv_train.conv_solve_stats_plain(
        _t(p["d"]), _t(p["v"]), _t(p["x"][0]), SW, N_IT, gram_stats=gram,
        **kw)
    for g, w in zip(got, want):
      assert_close(g.cpu(), w.numpy(), "K13 cuda vs plain")
  mesh = parallel.make_mesh()
  for upd in (1, 3):
    args = (_t(p["d"]), _t(p["h"]), _t(p["v"]), _t(p["x"]), SW, N_IT,
            UPD_STEP)
    got = fused_conv_dp_train.fused_conv_dp_train_segment(
        *[a.cuda() if isinstance(a, torch.Tensor) else a for a in args],
        mesh=mesh, upd_num_iters=upd, **kw)
    want = fused_conv_dp_train.fused_conv_dp_train_segment(
        *args, mesh=mesh, upd_num_iters=upd, **kw)
    for g, w in zip(got, want):
      assert_close(g.cpu(), w.numpy(), "K17 cuda vs plain")
  _, batches, d0, params, _, _ = TRAIN_CASES[POWER_WARM]
  fused_conv_dp_train.launches = 0
  fused_conv_train.stats_launches = fused_conv_train.launches = 0
  got = compiled_epoch.train_dictionary_scanned(
      batches, batches[:1], d0, dict(params, data_parallel=True),
      device="cuda")
  assert (fused_conv_dp_train.launches, fused_conv_train.stats_launches,
          fused_conv_train.launches) == (2 * batches.shape[0], 0, 0)
  single = compiled_epoch.train_dictionary_scanned(batches, batches[:1], d0,
                                                   params, device="cpu")
  assert_close(got.cpu(), single.numpy(), "cuda vs cpu", 1e-3)
