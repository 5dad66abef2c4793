"""The K19 port at a code axis of size 1 (vtc_tpu_torch/ops/
fused_code_shard_train.py and training/compiled_epoch.
_code_shard_segment_runner) against the TPU kernel on the CPU.

``fused_code_sharded_train_segment`` on CPU tensors runs its plain
version, which is held against vtc_tpu's
``fused_code_sharded_train_segment_pallas`` in interpret mode under
``shard_map`` on a 1 x 1 (data, code) mesh, as
tests/test_pallas_code_shard_train.py and test_pallas_code_shard_group.py
run it; the runner is held against vtc_tpu's runner on
``make_mesh(data=1, code=1)``.  Inputs come from a seed with numpy, at
k <= 3, b <= 16, s <= 256, n <= 64 with s > n.  Tolerances: the
dictionary and the Hessian EMA within 3e-5 and the eigenvector within
3e-5 (vtc_tpu's own cross-kernel limits,
tests/test_pallas_code_shard_train.py:67-75), the codes within the repo's
1e-4 contract.  The CUDA kernels run only on a card: their test skips
here, and chip_smoke.py phase 23 makes its check.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vtc_tpu.ops import pallas_code_shard_train as jcs
from vtc_tpu_torch.ops import _build
from vtc_tpu_torch.ops import fused_code_shard_train as cs
from vtc_tpu_torch.training import compiled_epoch

NAMES = ("dict", "hessian", "eigvec", "codes")
TOLS = {"dict": 3e-5, "hessian": 3e-5, "eigvec": 3e-5, "codes": 1e-4}


def assert_close(got, want, what, atol):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _problem(rng, k=2, b=8, s=128, n=32):
  d = rng.randn(s, n).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = rng.randn(k, b, n).astype(np.float32)
  h = np.abs(rng.randn(s)).astype(np.float32) * 0.01
  # the kernel's eigenvector is the n x n Gram's (s > n)
  v = np.linalg.eigh(d.astype(np.float64).T @ d)[1][:, -1].astype(np.float32)
  return d, h, v, x


def _contiguous(s, m):
  return [list(range(i, i + m)) for i in range(0, s, m)]


def _ragged(rng, s):
  """A disjoint partition of range(s) into shuffled groups of 1 to 6."""
  perm, groups, at = rng.permutation(s), [], 0
  while at < s:
    size = int(rng.randint(1, 7))
    groups.append(sorted(int(i) for i in perm[at:at + size]))
    at += size
  return groups


def _pallas(d, h, v, x, sw, n_it, upd, group_arrays=None, penalty=0.0,
            **kw):
  """vtc_tpu's K19 at axis 1, in interpret mode on a 1 x 1 mesh."""
  mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "code"))
  gkw = {}
  if group_arrays is not None:
    gkw["expand_local"] = jnp.asarray(group_arrays[0][0])
    gkw["roll_window"] = jcs.roll_window_from_expand_arrays(group_arrays[0])
    if penalty != 0.0:
      gkw["comem_local"] = jnp.asarray(group_arrays[1][0])
    gkw["alignment_penalty"] = penalty

  def body(d_, h_, v_, x_):
    return jcs.fused_code_sharded_train_segment_pallas(
        d_, h_, v_, x_, jnp.float32(sw), jnp.int32(n_it), jnp.float32(upd),
        axis_name="code", axis_size=1, interpret=True, power_iters=2,
        **gkw, **kw)

  rep = P()
  fn = jax.jit(jax.shard_map(
      body, mesh=mesh, in_specs=(P("code", None), P("code"), rep, rep),
      out_specs=(P("code", None), P("code"), rep, P(None, "code")),
      check_vma=False))
  return [np.asarray(t) for t in fn(*map(jnp.asarray, (d, h, v, x)))]


def _port(d, h, v, x, sw, n_it, upd, group_arrays=None, penalty=0.0, **kw):
  if group_arrays is not None:
    kw["expand_local"] = group_arrays[0][0]
    if penalty != 0.0:
      kw["comem_local"] = group_arrays[1][0]
    kw["alignment_penalty"] = penalty
  out = cs.fused_code_sharded_train_segment(
      *map(torch.from_numpy, (d, h, v, x)), sw, n_it, upd, power_iters=2,
      **kw)
  return [t.numpy() for t in out]


def _compare(got, want, label):
  for g, w, name in zip(got, want, NAMES):
    assert g.shape == w.shape and g.dtype == np.float32, (name, g.shape,
                                                          w.shape)
    assert_close(g, w, "%s %s" % (label, name), TOLS[name])


FC_CASES = {
    "fista cheap-quad": dict(update_alg="sc_cheap_quadratic_descent"),
    "fista steepest upd 2": dict(update_alg="sc_steepest_descent",
                                 upd_num_iters=2),
    "ista nonneg": dict(variant="ista", nonneg=True,
                        update_alg="sc_steepest_descent"),
    "fista hard": dict(hard=True, update_alg="sc_steepest_descent"),
    "fista early stop": dict(update_alg="sc_steepest_descent",
                             early_stopping_epsilon=5e-2),
}


@pytest.mark.parametrize("case", sorted(FC_CASES))
def test_fc_plain_matches_pallas(rng, case):
  d, h, v, x = _problem(rng)
  args = (0.1, 8, 0.05)
  want = _pallas(d, h, v, x, *args, **FC_CASES[case])
  got = _port(d, h, v, x, *args, **FC_CASES[case])
  _compare(got, want, case)


GROUP_CASES = {
    "4s cheap-quad": ("contiguous", 0.0,
                      "subspace_sc_cheap_quadratic_descent"),
    "4s steepest": ("contiguous", 0.0, "subspace_sc_steepest_descent"),
    "4s cheap-quad penalty 0.15": ("contiguous", 0.15,
                                   "subspace_sc_cheap_quadratic_descent"),
    "4s steepest penalty 0.15": ("contiguous", 0.15,
                                 "subspace_sc_steepest_descent"),
    "ragged cheap-quad": ("ragged", 0.0,
                          "subspace_sc_cheap_quadratic_descent"),
    "ragged steepest penalty 0.15": ("ragged", 0.15,
                                     "subspace_sc_steepest_descent"),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_grouped_plain_matches_pallas(rng, case):
  layout, penalty, update_alg = GROUP_CASES[case]
  d, h, v, x = _problem(rng)
  s = d.shape[0]
  groups = _contiguous(s, 4) if layout == "contiguous" else _ragged(rng, s)
  arrays = cs.code_shard_group_arrays(groups, s, 1)
  window = cs.roll_window_from_expand_arrays(arrays[0])
  assert window == (4 if layout == "contiguous" else None)
  assert cs.group_members(arrays[0][0])[1] == window
  kw = dict(group_arrays=arrays, penalty=penalty, variant="fista",
            update_alg=update_alg)
  want = _pallas(d, h, v, x, 0.1, 8, 0.05, **kw)
  got = _port(d, h, v, x, 0.1, 8, 0.05, **kw)
  _compare(got, want, case)


# every layout of tests/test_pallas_code_shard_group.py:72-96, and more
LAYOUTS = [
    (_contiguous(16, 4), 16, 2),
    ([[0, 1, 2], [3], [4, 5], [6, 7]], 8, 2),
    (_contiguous(16, 4), 16, 3),
    ([[2 * i, 2 * i + 1] for i in range(8)], 16, 2),
    ([[0, 1], [2, 3], [4, 5], [6, 7, 8], [9], [10, 11], [12, 13],
      [14, 15]], 16, 2),
    ([[0, 1], [1, 2], [3]], 4, 2),
    ([[0, 1], [3]], 4, 2),
    (_contiguous(64, 8), 64, 1),
    (_contiguous(64, 8)[::-1], 64, 1),
    ([[0, 1, 2], [3, 4, 5]], 6, 1),
    ([[0], [1], [2], [3]], 4, 1),
]


@pytest.mark.parametrize("index", range(len(LAYOUTS)))
def test_group_arrays_match_vtc_tpu(index):
  groups, s, p = LAYOUTS[index]
  want = jcs.code_shard_group_arrays(groups, s, p)
  got = cs.code_shard_group_arrays(groups, s, p)
  assert (got is None) == (want is None)
  if want is None:
    return
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and np.array_equal(g, w)
  assert (cs.roll_window_from_expand_arrays(got[0])
          == jcs.roll_window_from_expand_arrays(want[0]))
  if p == 1:  # the port's own member table agrees on the window where
    # vtc_tpu's column order is the block order
    window = cs.group_members(got[0][0])[1]
    vtc_window = jcs.roll_window_from_expand_arrays(want[0])
    assert window == vtc_window or (vtc_window is None and index == 8)


def test_group_members_refuses_non_partitions():
  with pytest.raises(ValueError, match="disjoint partition"):
    cs.group_members(np.array([[1, 0], [1, 1], [0, 1]], np.float32))
  with pytest.raises(ValueError, match="disjoint partition"):
    cs.group_members(np.array([[1, 0], [0, 0]], np.float32))
  table, window = cs.group_members(np.eye(4, 2, dtype=np.float32)[[0, 1, 0,
                                                                   1]])
  assert window is None and table.tolist() == [[0, 2], [1, 3]]


def test_supported_agrees_with_vtc_tpu():
  """Wherever vtc_tpu's VMEM budget holds, the gates agree at axis 1; the
  port refuses a global s <= n, and takes every axis above 1 with a global
  s > n (a shard may have s_l <= n)."""
  agreed = 0
  for b in (8, 128, 256):
    for s in (32, 64, 256, 2048):
      for n in (32, 64, 256):
        port = cs.code_shard_segment_supported(b, s, n, 1)
        assert port == (s > n)
        if jcs.code_shard_segment_supported(b, s, n, 1) and s > n:
          assert port
          agreed += 1
        assert cs.code_shard_segment_supported(b, s, n, 2) == (2 * s > n)
        assert cs.code_shard_segment_supported(b, s, n, 1, 2) == (s > n)
  assert agreed >= 10
  assert cs.code_shard_segment_supported(128, 2048, 256, 1)  # bench's row
  # past the TPU's VMEM budget, the card still runs it
  assert not jcs.code_shard_segment_supported(256, 8192, 256, 1)
  assert cs.code_shard_segment_supported(256, 8192, 256, 1)


@pytest.mark.parametrize("grouped", [False, True])
def test_runner_matches_vtc_tpu(rng, grouped):
  """The slice: the port's runner at cs 1 against vtc_tpu's on a 1 x 1
  mesh over a 3-step segment."""
  from vtc_tpu.parallel import make_mesh
  from vtc_tpu.training import compiled_epoch as jce
  d, h, v, x = _problem(rng, k=3, b=16, s=256, n=64)
  x = x * 0.5  # at unit scale the codes grow: the EMA reaches 21 in 2 steps
  if grouped:
    arrays = cs.code_shard_group_arrays(_contiguous(256, 4), 256, 1)
    flags = ("fista", "subspace_sc_cheap_quadratic_descent", 1, False,
             False, True)
    kw = dict(group_arrays=arrays)
  else:
    flags = ("fista", "sc_cheap_quadratic_descent", 1, False, False, True)
    kw = {}
  args = (0.1, 8, 0.05)
  want = jce._code_shard_segment_runner(make_mesh(data=1, code=1), 1, 1,
                                        *flags, **kw)(
      *map(jnp.asarray, (d, h, v, x)), jnp.float32(args[0]),
      jnp.int32(args[1]), jnp.float32(args[2]))
  before = cs.launches
  got = compiled_epoch._code_shard_segment_runner(None, 1, 1, *flags, **kw)(
      *map(torch.from_numpy, (d, h, v, x)), *args)
  assert cs.launches == before  # CPU tensors take the plain version
  for g, w, name in zip(got, want, NAMES):
    assert_close(g.numpy(), np.asarray(w), "runner %s" % name, TOLS[name])


def test_refusals(rng):
  d, h, v, x = map(torch.from_numpy, _problem(rng, k=1))
  args = (d, h, v, x, 0.1, 5, 0.05)
  # axes above 1 run on a mesh that has them (test_torch_port_code_shard_
  # parallel.py); without one, the sizes must be the one-rank mesh's
  for kw in (dict(axis_size=2), dict(data_axis_size=2)):
    with pytest.raises(ValueError, match="must be the mesh's"):
      cs.fused_code_sharded_train_segment(*args, **kw)
  for sizes in ((2, 1), (1, 2)):
    with pytest.raises(ValueError, match="needs a mesh of those sizes"):
      compiled_epoch._code_shard_segment_runner(
          None, *sizes, "fista", "sc_steepest_descent", 1, False, False,
          True)
  # the tiers run (since item 3a.2.4), the wrapper and the runner alike,
  # within the tier's floor of vtc_tpu's K19 at the tier
  # (tests/test_torch_port_code_shard_tiers.py holds every case, with
  # vtc_tpu's spread); an unknown tier raises
  want = _pallas(*(a.numpy() for a in args[:4]), *args[4:], mxu="bf16x3",
                 update_alg="sc_steepest_descent")
  runner = compiled_epoch._code_shard_segment_runner(
      None, 1, 1, "fista", "sc_steepest_descent", 1, False, False, True,
      mxu="bf16x3")
  for label, got in (
      ("wrapper", cs.fused_code_sharded_train_segment(
          *args, mxu="bf16x3", update_alg="sc_steepest_descent",
          power_iters=2)),
      ("runner", runner(d, h, v, x, 0.1, 5, 0.05))):
    for g, w, name in zip(got, want, NAMES):
      assert_close(g.numpy(), w, "%s at bf16x3 %s" % (label, name),
                   2e-5 * max(1.0, float(np.abs(w).max())))
  for mxu in ("default", "tf32"):
    with pytest.raises(ValueError, match="unknown MXU tier"):
      cs.fused_code_sharded_train_segment(*args, mxu=mxu)
    with pytest.raises(ValueError, match="unknown MXU tier"):
      compiled_epoch._code_shard_segment_runner(
          None, 1, 1, "fista", "sc_steepest_descent", 1, False, False, True,
          mxu=mxu)(d, h, v, x, 0.1, 5, 0.05)
  for kw in (dict(interpret=True), dict(code_stride=2),
             dict(data_stride=3)):
    with pytest.raises(ValueError, match="row-major strides"):
      cs.fused_code_sharded_train_segment(*args, **kw)
  with pytest.raises(ValueError, match="s > n"):
    cs.fused_code_sharded_train_segment(d[:16], h[:16], v, x, 0.1, 5, 0.05)
  arrays = cs.code_shard_group_arrays(_contiguous(128, 4), 128, 1)
  with pytest.raises(ValueError, match="fc variant only"):
    cs.fused_code_sharded_train_segment(*args, expand_local=arrays[0][0],
                                        nonneg=True)
  with pytest.raises(ValueError, match="roll_window"):
    cs.fused_code_sharded_train_segment(*args, expand_local=arrays[0][0],
                                        roll_window=8)
  with pytest.raises(ValueError, match="comem_local"):
    cs.fused_code_sharded_train_segment(*args, expand_local=arrays[0][0],
                                        alignment_penalty=0.1)
  with pytest.raises(ValueError, match="renormalize"):
    cs.fused_code_sharded_train_segment(
        *args, expand_local=arrays[0][0], comem_local=arrays[1][0],
        alignment_penalty=0.1, renormalize=False)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    cs.fused_code_sharded_train_segment(*(t.to("meta") for t in args[:4]),
                                        *args[4:])


class _OnCuda(torch.Tensor):
  """A CPU tensor that reports a CUDA device: what the wrapper sees of a
  card's tensor, on a machine without one."""

  @property
  def device(self):
    return torch.device("cuda", 0)


def test_cuda_tensor_without_a_card_raises(rng, tmp_path, monkeypatch):
  """A CUDA tensor takes the kernel route or raises: with and without
  the early stop a missing nvcc raises, and the plain version never
  runs."""
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
  monkeypatch.setattr(_build, "find_nvcc", lambda: None)
  _build.load_library.cache_clear()

  def no_plain(*a, **k):
    raise AssertionError("a CUDA tensor took the plain version")

  monkeypatch.setattr(cs, "fused_code_sharded_train_segment_plain", no_plain)
  d, h, v, x = (torch.Tensor._make_subclass(_OnCuda, torch.from_numpy(a))
                for a in _problem(rng, k=1))
  assert x.device.type == "cuda"
  before = cs.launches
  with pytest.raises(_build.BuildError, match="nvcc not found"):
    cs.fused_code_sharded_train_segment(d, h, v, x, 0.1, 5, 0.05,
                                        early_stopping_epsilon=1e-3)
  with pytest.raises(_build.BuildError, match="nvcc not found"):
    cs.fused_code_sharded_train_segment(d, h, v, x, 0.1, 5, 0.05)
  assert cs.launches == before
  _build.load_library.cache_clear()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(rng):
  """The kernels against their plain version on the card, fc, grouped
  (window and ragged) and regularized (chip_smoke.py phase 23 runs
  bench's width)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the residual-form kernels have no "
                "CPU mode")
  d, h, v, x = (torch.from_numpy(a).cuda() for a in _problem(rng, k=2))
  s = d.shape[0]
  contiguous = cs.code_shard_group_arrays(_contiguous(s, 4), s, 1)
  ragged = cs.code_shard_group_arrays(_ragged(rng, s), s, 1)
  cases = [dict(), dict(variant="ista", nonneg=True, hard=True),
           dict(expand_local=contiguous[0][0]),
           dict(expand_local=ragged[0][0], comem_local=ragged[1][0],
                alignment_penalty=0.15)]
  for kw in cases:
    before = cs.launches
    got = cs.fused_code_sharded_train_segment(d, h, v, x, 0.1, 8, 0.05,
                                              power_iters=2, **kw)
    assert cs.launches == before + 2
    want = cs.fused_code_sharded_train_segment_plain(
        d.double(), h.double(), v.double(), x.double(), 0.1, 8, 0.05,
        power_iters=2, **kw)
    for g, w, name in zip(got, want, NAMES):
      assert_close(g.cpu(), w.cpu(), "cuda %s %s" % (sorted(kw), name), 1e-5)
