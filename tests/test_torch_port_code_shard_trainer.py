"""The code-sharded path through the port's entry points on the CPU:
``train_dictionary_scanned`` on a mesh with a 'code' axis (its code-shard
route, and vtc_tpu's composition where the gate declines),
``build_pjit_train_step`` and ``encode_dataset``, against vtc_tpu and the
single-device step.

Spawned CPU ranks in one gloo group per world size for the file
(tests/torch_port_dp_worker.py): a world of 2 holds ``make_mesh(data=1,
code=2)``, a world of 4 ``make_mesh(data=2, code=2)``.  vtc_tpu's trainers
run in this process on its 8-device CPU mesh, its kernels in interpret
mode, as tests/test_pallas_code_shard_train.py:124-151 and
tests/test_pallas_code_shard_group.py:179-240, :277-306 run them.

* The trainer, fc at (1, 2) and (2, 2) and grouped at (2, 2), takes the
  code-shard route (K19's wrapper, no K3, K7, K15 or K16), every rank
  returns bitwise the same dictionary, and it matches vtc_tpu's trainer on
  the same mesh shape.
* A code mesh whose gate declines (s <= n): vtc_tpu's K3 composition,
  replicated over 'code', never the whole-segment K15, which would sum
  over the wrong ranks; it matches vtc_tpu.
* ``build_pjit_train_step`` at (2, 2), rows sharded and not, against
  vtc_tpu's ``build_pjit_train_step`` on its (2, 2) mesh and the
  single-device raw step, at tests/test_parallel.py:258-283's tolerances
  (codes and dictionary 1e-4, Hessian 1e-5).
* ``encode_dataset`` on a (2, 2) mesh against vtc_tpu's on its (2, 2) mesh
  at 1e-5 (the data-parallel encode's bound,
  tests/test_torch_port_parallel_train.py), and equal to the port's
  single-device encode.

Inputs come from numpy seeds at s 64, n 16, a global batch of 16.
Tolerances: vtc_tpu's own trainer-versus-trainer limits, 3e-5 for fc and
5e-5 grouped (test_pallas_code_shard_group.py:240, :306), which eight
cheap-quadratic steps keep inside ROADMAP.md §3's rounding floor (2.2e-4);
the declined case at 2e-5 of max(1, |largest value|), the bound of the
data-parallel tests (tests/test_torch_port_dp_segments.py).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_port_dp_worker as worker
from vtc_tpu import parallel as jax_parallel
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.training import compiled_epoch as jax_ce
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.training import sparse_coding as sc

SPECS = {2: dict(data=1, code=2), 4: dict(data=2, code=2)}


def _params(groups=None, **extra):
  params = {
      "mode": "fully-connected",
      "num_epochs": 2,
      "code_inference_algorithm": "fista",
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "inference_param_schedule": {
          0: {"sparsity_weight": 0.05, "num_iters": 8}},
      "dict_update_param_schedule": {
          0: {"stepsize": 0.05, "num_iters": 1}},
      "fc_formulation": "pallas",
  }
  if groups is not None:
    params.update(code_inference_algorithm="subspace_fista",
                  dictionary_update_algorithm=(
                      "subspace_sc_cheap_quadratic_descent"),
                  group_assignments=groups,
                  subspace_alignment_penalty=0.1)
  params.update(extra)
  return params


def _data(seed, k=2, b=16, s=64, n=16):
  rng = np.random.RandomState(seed)
  d0 = rng.randn(s, n).astype(np.float32)
  d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
  return d0, (rng.randn(k, b, n) * 0.5).astype(np.float32)


GROUPS = [list(range(i, i + 4)) for i in range(0, 64, 4)]
# name -> (world, seed, problem sizes, params, tolerance)
TRAIN = {
    "fc (1, 2)": (2, 1, {}, _params(), 3e-5),
    "fc (2, 2)": (4, 2, dict(k=3), _params(), 3e-5),
    "grouped (2, 2)": (4, 3, {}, _params(GROUPS, num_epochs=1), 5e-5),
    "declined s <= n (2, 2)": (4, 4, dict(s=16, n=24), _params(), 2e-5),
}
PJIT = dict(seed=5, sw=0.05, n_it=10, upd=0.1)
ENCODE = dict(seed=6, sw=0.05, n_it=12)


def _pjit_inputs():
  rng = np.random.RandomState(PJIT["seed"])
  d = rng.randn(32, 16).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return d, np.zeros(32, np.float32), rng.randn(16, 16).astype(np.float32)


def _encode_inputs():
  rng = np.random.RandomState(ENCODE["seed"])
  d = rng.randn(64, 16).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return rng.randn(64, 16).astype(np.float32), d


@functools.lru_cache(maxsize=None)
def rank_results(world):
  spec = SPECS[world]
  cases = []
  for name, (w, seed, sizes, params, _) in TRAIN.items():
    if w == world:
      d0, batches = _data(seed, **sizes)
      cases.append((name, "cs_train", dict(mesh_spec=spec, batches=batches,
                                           d0=d0, params=params)))
  if world == 4:
    d, h, batch = _pjit_inputs()
    for shard in (False, True):
      cases.append(("pjit %s" % shard, "pjit", dict(
          mesh_spec=spec, d=d, h=h, batch=batch, sw=PJIT["sw"],
          n_it=PJIT["n_it"], upd_step=PJIT["upd"], shard_code=shard)))
    x, d = _encode_inputs()
    cases.append(("encode", "cs_encode", dict(
        mesh_spec=spec, data=x, d=d, sw=ENCODE["sw"], n_it=ENCODE["n_it"],
        kw=dict(batch_size=16))))
  return worker.run_ranks(world, cases)


@functools.lru_cache(maxsize=None)
def jax_trainer(name):
  world, seed, sizes, params, _ = TRAIN[name]
  d0, batches = _data(seed, **sizes)
  return np.asarray(jax_ce.train_dictionary_scanned(
      batches, batches[:1], d0.copy(),
      dict(params, data_parallel=jax_parallel.make_mesh(**SPECS[world]))))


@functools.lru_cache(maxsize=None)
def jax_pjit(shard_code):
  d, h, batch = map(jnp.asarray, _pjit_inputs())
  step = jax_parallel.build_pjit_train_step(
      jax_parallel.make_mesh(**SPECS[4]), "fully-connected", "fista",
      "sc_cheap_quadratic_descent", shard_code_axis=shard_code)
  return tuple(np.asarray(a) for a in step(
      d, h, batch, jnp.float32(PJIT["sw"]), jnp.int32(PJIT["n_it"]),
      jnp.float32(PJIT["upd"])))


def _same_on_every_rank(ranks, key):
  for other in ranks[1:]:
    assert np.array_equal(ranks[0][key]["dictionary"],
                          other[key]["dictionary"]), key + " differs"
    assert ranks[0][key]["calls"] == other[key]["calls"]
  return ranks[0][key]


@pytest.mark.parametrize("name", list(TRAIN))
def test_trainer_on_a_code_mesh_matches_vtc_tpu(name):
  world, _, _, _, tol = TRAIN[name]
  out = _same_on_every_rank(rank_results(world), name)
  calls = out["calls"]
  if name.startswith("declined"):
    # vtc_tpu's composition replicated over 'code' (:656-659): K3 per
    # step, never K19 or the whole-segment K15
    assert calls["K19"] == 0 and calls["K15"] == 0 and calls["K3"] > 0
  else:
    assert calls["K19"] > 0, "the code-shard route was not taken"
    assert calls["K3"] + calls["K7"] + calls["K15"] + calls["K16"] == 0
    assert calls["psum-per-op"] == 0
  want = jax_trainer(name)
  got = out["dictionary"]
  err = float(np.max(np.abs(got - want)))
  bound = tol * max(1.0, float(np.abs(want).max()))
  print("%s: max|d| %.3e (bound %.1e), calls %s" % (name, err, bound, calls))
  assert err <= bound


@pytest.mark.parametrize("shard_code", [False, True])
def test_pjit_step_matches_the_single_device_step(shard_code):
  out = rank_results(4)
  key = "pjit %s" % shard_code
  for other in out[1:]:
    for a, b in zip(out[0][key], other[key]):
      assert np.array_equal(a, b), key + " differs across ranks"
  d, h, batch = map(torch.from_numpy, _pjit_inputs())
  step = sc.build_raw_step_fn("fully-connected", "fista",
                              "sc_cheap_quadratic_descent")
  d1, h1, c1 = step(d, h, batch, PJIT["sw"], PJIT["n_it"], PJIT["upd"], 1,
                    None)
  d2, h2, c2 = out[0][key]
  dj, hj, cj = jax_pjit(shard_code)
  for want in ((d1.numpy(), h1.numpy(), c1.numpy()), (dj, hj, cj)):
    np.testing.assert_allclose(c2, want[2], atol=1e-4)
    np.testing.assert_allclose(d2, want[0], atol=1e-4)
    np.testing.assert_allclose(h2, want[1], atol=1e-5)


def test_encode_on_a_code_mesh_equals_one_device():
  out = rank_results(4)
  x, d = _encode_inputs()
  one = encode_dataset(x, d, ENCODE["sw"], ENCODE["n_it"], device="cpu",
                       batch_size=16)
  want = np.asarray(jax_encode_dataset(
      x, d, ENCODE["sw"], ENCODE["n_it"], batch_size=16,
      data_parallel=jax_parallel.make_mesh(**SPECS[4])))
  for rank in out:
    np.testing.assert_allclose(rank["encode"], one, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rank["encode"], want, rtol=0, atol=1e-5)
