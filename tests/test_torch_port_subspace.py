"""The port's subspace (group-sparse) solve and encode against vtc_tpu on
the CPU: ``thresholds.group_shrink``, the packing helpers of
``subspace_ista_fista``, its ``run`` ('gram', 'direct', 'pallas'), the K4
wrapper's plain version ``fused_group_fista_plain`` against the Pallas
kernel ``group_fista_solve_pallas`` in interpret mode, and
``encode_dataset(group_assignments=...)``.

The same numpy inputs (from a seed) go through both packages, at the JAX
tests' sizes (b 12, s 32, n 24; tests/test_pallas_group_fista.py).
Tolerances: 1e-4 against vtc_tpu and the float64 oracle, the repo's
parity contract (CLAUDE.md); 1e-5 between the plain version and the
Pallas kernel, the JAX tests' own bound between two float32 solves.
The CUDA kernel runs only on a card: its tests skip here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import numpy_oracle as oracle
from vtc_tpu.analysis_transforms.fully_connected import (
    subspace_ista_fista as jax_sub)
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.ops import thresholds as jax_thresholds
from vtc_tpu.ops.pallas_group_fista import (group_fista_solve_pallas,
                                            membership_matrix)
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista as sub)
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import fused_group_fista, thresholds

ATOL = 1e-4
KERNEL_ATOL = 1e-5
CONTIGUOUS = [list(range(i, i + 4)) for i in range(0, 32, 4)]
RAGGED = [[0, 2, 5], [1], [2, 3, 4, 5], list(range(6, 32))]
SINGLETONS = [[i] for i in range(32)]
GROUPS = {"contiguous": CONTIGUOUS, "ragged": RAGGED,
          "singletons": SINGLETONS}


def assert_close(got, want, what, atol=ATOL):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


def _problem(rng, b=12, s=32, n=24):
  d = rng.randn(s, n)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  return rng.randn(b, n).astype(np.float32), d.astype(np.float32)


def test_group_shrink_matches_jax(rng):
  x = rng.randn(5, 6, 3).astype(np.float32)
  x[1, 2] = 0.0  # a zero group: the norm == 0 -> 1 guard
  norms = np.linalg.norm(x, axis=2, keepdims=True)
  for t in (0.0, 0.7, 5.0):
    want = np.asarray(jax_thresholds.group_shrink(jnp.asarray(x),
                                                  jnp.asarray(norms), t))
    got = thresholds.group_shrink(torch.from_numpy(x),
                                  torch.from_numpy(norms), t)
    assert np.isfinite(got.numpy()).all()
    assert_close(got, want, "group_shrink t=%g" % t, 1e-7)


@pytest.mark.parametrize("kind", sorted(GROUPS))
def test_packing_matches_jax(rng, kind):
  groups = GROUPS[kind]
  x, d = _problem(rng)
  jg, jm = jax_sub.pack_group_indices(groups, 32)
  gather, mask = sub.pack_group_indices(groups, 32)
  assert np.array_equal(gather.numpy(), np.asarray(jg))
  assert np.array_equal(mask.numpy(), np.asarray(jm))
  assert_close(sub.build_grouped_dictionary(torch.from_numpy(d), gather,
                                            mask),
               jax_sub.build_grouped_dictionary(jnp.asarray(d), jg, jm),
               "grouped dictionary " + kind, 0.0)
  codes = rng.randn(12, 32).astype(np.float32)
  packed = sub.pack_codes(torch.from_numpy(codes), gather, mask)
  assert_close(packed, jax_sub.pack_codes(jnp.asarray(codes), jg, jm),
               "pack " + kind, 0.0)
  grouped = rng.randn(*packed.shape).astype(np.float32)
  want = np.asarray(jax_sub.unpack_codes_summed(jnp.asarray(grouped), jg, jm,
                                                32))
  got = sub.unpack_codes_summed(torch.from_numpy(grouped), gather, mask, 32)
  assert_close(got, want, "unpack " + kind, 1e-6)
  # flat (b, G*M) input and a prebuilt index give the same sums
  index = sub.unpack_index(gather, mask, 32)
  again = sub.unpack_codes_summed(torch.from_numpy(grouped).reshape(12, -1),
                                  gather, mask, 32, index)
  assert torch.equal(got, again)


def test_unpack_index_orders_duplicates():
  """A code in several groups sums its slots in ascending slot order,
  padded with the index of the appended zero slot."""
  gather, mask = sub.pack_group_indices([[0, 2], [2], [1, 2]], 4)
  index = sub.unpack_index(gather, mask, 4).numpy()
  pad = 6  # G * M
  assert index.tolist() == [[0, pad, pad], [4, pad, pad], [1, 2, 5],
                            [pad, pad, pad]]


@pytest.mark.parametrize("formulation", ["gram", "direct", "pallas"])
@pytest.mark.parametrize("variant", ["ista", "fista"])
@pytest.mark.parametrize("kind", sorted(GROUPS))
def test_run_matches_jax_and_oracle(rng, formulation, variant, kind):
  groups = GROUPS[kind]
  x, d = _problem(rng)
  want = np.asarray(jax_sub.run(x, d, groups, 0.08, 15, variant=variant,
                                formulation=formulation))
  got = sub.run(torch.from_numpy(x), torch.from_numpy(d), groups, 0.08, 15,
                variant=variant, formulation=formulation)
  assert got.shape == (12, 32) and got.dtype == torch.float32
  assert_close(got, want, "run %s %s %s" % (formulation, variant, kind))
  assert_close(got, oracle.fc_subspace_ista_fista(
      x.astype(np.float64), d.astype(np.float64), groups, 0.08, 15, variant),
               "run vs oracle %s %s %s" % (formulation, variant, kind))


def test_singleton_groups_reduce_to_fc(rng):
  """One atom per group: the group prox is the soft threshold."""
  x, d = _problem(rng)
  got = sub.run(x, d, SINGLETONS, 0.08, 30)
  want = ista_fista.run(x, d, 0.08, 30)
  assert_close(got, want, "singleton groups vs fc", 1e-5)


@pytest.mark.parametrize("formulation", ["gram", "pallas"])
def test_run_options_match_jax(rng, formulation):
  """Warm start, hard thresholding, early stop and the raw grouped
  output, against vtc_tpu's own run with the same options."""
  x, d = _problem(rng)
  init = np.array(jax_sub.run(x, d, RAGGED, 0.1, 10))
  for kw in (dict(initial_codes=init), dict(hard_threshold=True),
             dict(early_stopping_epsilon=5e-2), dict(variant="ista",
                                                     initial_codes=init)):
    want = np.asarray(jax_sub.run(x, d, RAGGED, 0.1, 40,
                                  formulation=formulation, **kw))
    got = sub.run(x, d, RAGGED, 0.1, 40, formulation=formulation, **kw)
    assert_close(got, want, "run %s %s" % (formulation, sorted(kw)))
  flat_j, gdict_j = jax_sub.run(x, d, RAGGED, 0.08, 15,
                                ret_summed_gduplicates=False,
                                formulation=formulation)
  flat, gdict = sub.run(x, d, RAGGED, 0.08, 15, ret_summed_gduplicates=False,
                        formulation=formulation)
  assert flat.shape == (12, 4 * 26) and gdict.shape == (4 * 26, 24)
  assert_close(flat, flat_j, "raw grouped codes " + formulation)
  assert_close(gdict, gdict_j, "grouped dictionary " + formulation, 0.0)


def test_warm_start_and_stop_change_the_answer(rng):
  x, d = _problem(rng)
  init = sub.run(x, d, CONTIGUOUS, 0.1, 20)
  warm = sub.run(x, d, CONTIGUOUS, 0.1, 5, initial_codes=init)
  cold = sub.run(x, d, CONTIGUOUS, 0.1, 5)
  assert float((warm - cold).abs().max()) > 1e-5
  stopped = sub.run(x, d, RAGGED, 0.1, 60, early_stopping_epsilon=5e-2)
  full = sub.run(x, d, RAGGED, 0.1, 60)
  assert float((stopped - full).abs().max()) > 1e-7


@pytest.mark.parametrize("roll", [False, True])
@pytest.mark.parametrize("variant,hard,warm", [
    ("fista", False, False), ("ista", False, True), ("fista", True, True)])
def test_plain_version_matches_pallas_kernel(rng, roll, variant, hard, warm):
  """fused_group_fista_plain against group_fista_solve_pallas in
  interpret mode, with its membership-matmul prox (roll_window=None) and
  its lane-rotate prox (roll_window=M): one prox here stands for both."""
  x, d = _problem(rng)
  gather, mask = sub.pack_group_indices(CONTIGUOUS, 32)
  gd = sub.build_grouped_dictionary(torch.from_numpy(d), gather, mask)
  init = None
  if warm:
    init = fused_group_fista.fused_group_fista_plain(
        torch.from_numpy(x), gd, 4, 0.1, 5, 0.05, variant=variant, hard=hard)
  want = np.asarray(group_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(gd.numpy()),
      membership_matrix(8, 4, np.ones((8, 4), np.float32)),
      jnp.float32(0.1), jnp.int32(15), jnp.float32(0.05),
      initial_grouped=None if init is None else jnp.asarray(init.numpy()),
      variant=variant, hard=hard, interpret=True,
      roll_window=4 if roll else None))
  got = fused_group_fista.fused_group_fista_plain(
      torch.from_numpy(x), gd, 4, 0.1, 15, 0.05, initial_grouped=init,
      variant=variant, hard=hard)
  assert got.shape == (12, 32)
  assert np.abs(want).max() > 0  # a non-degenerate solve
  assert_close(got, want, "plain vs pallas roll=%s %s hard=%s warm=%s" % (
      roll, variant, hard, warm), KERNEL_ATOL)


def test_plain_version_ragged_matches_pallas_kernel(rng):
  """Ragged groups (M = 26): padded slots stay zero and the membership
  operand's zero rows have no counterpart."""
  x, d = _problem(rng)
  gather, mask = sub.pack_group_indices(RAGGED, 32)
  gd = sub.build_grouped_dictionary(torch.from_numpy(d), gather, mask)
  want = np.asarray(group_fista_solve_pallas(
      jnp.asarray(x), jnp.asarray(gd.numpy()),
      membership_matrix(4, 26, mask.numpy()), jnp.float32(0.08),
      jnp.int32(15), jnp.float32(0.05), interpret=True))
  got = fused_group_fista.fused_group_fista_plain(
      torch.from_numpy(x), gd, 26, 0.08, 15, 0.05)
  assert_close(got, want, "plain vs pallas ragged", KERNEL_ATOL)
  padded = (mask.numpy().reshape(-1) == 0)
  assert float(got[:, torch.from_numpy(padded)].abs().max()) == 0.0


def test_plain_version_keeps_float64(rng):
  x, d = _problem(rng)
  gd = torch.from_numpy(d).double()
  out = fused_group_fista.fused_group_fista_plain(
      torch.from_numpy(x).double(), gd, 4, 0.1, 10, 0.05)
  assert out.dtype == torch.float64
  f32 = fused_group_fista.fused_group_fista_plain(
      torch.from_numpy(x), gd.float(), 4, 0.1, 10, 0.05)
  assert_close(out, f32, "fp64 vs fp32 plain", 1e-5)


@pytest.mark.parametrize("formulation", [None, "pallas", "gram"])
def test_encode_dataset_groups_matches_jax(rng, formulation):
  d = rng.randn(48, 32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  groups = [list(range(i, i + 4)) for i in range(0, 48, 4)]
  codes = rng.randn(300, 48) * np.repeat(rng.rand(300, 12) < 0.2, 4, axis=1)
  x = (codes @ d + 0.05 * rng.randn(300, 32)).astype(np.float32)
  kw = dict(batch_size=64, chunk_batches=2, group_assignments=groups)
  want = jax_encode_dataset(x, d.astype(np.float32), 0.05, 30, **kw)
  got = encode_dataset(x, d, 0.05, 30, formulation=formulation,
                       device="cpu", **kw)
  assert isinstance(got, np.ndarray) and got.shape == (300, 48)
  assert_close(got, want, "encode_dataset groups formulation=%s"
               % formulation)
  overlapping = [[0, 1, 2], [2, 3], list(range(3, 48))]
  kw = dict(batch_size=100, chunk_batches=2, variant="ista",
            group_assignments=overlapping, hard_threshold=True)
  want = jax_encode_dataset(x[:32], d.astype(np.float32), 0.05, 10, **kw)
  got = encode_dataset(x[:32], torch.from_numpy(d.astype(np.float32)),
                       0.05, 10, **kw)
  assert_close(got, want, "encode_dataset overlapping ista hard")


def test_encode_dataset_refuses_nonneg_groups(rng):
  x, d = _problem(rng)
  with pytest.raises(ValueError, match="nonnegative_only"):
    encode_dataset(x, d, 0.05, 5, group_assignments=CONTIGUOUS,
                   nonnegative_only=True)


def test_wrappers_refuse_what_they_do_not_run(rng):
  x, d = _problem(rng)
  # the tiers run (tests/test_torch_port_tiers.py); an unknown
  # tier is refused
  full = sub.run(x, d, CONTIGUOUS, 0.1, 5, formulation="pallas")
  tier = sub.run(x, d, CONTIGUOUS, 0.1, 5, formulation="pallas",
                 mxu_precision="bf16x3")
  assert 0.0 < float((tier - full).abs().max()) < 1e-3
  with pytest.raises(ValueError, match="tier"):
    sub.run(x, d, CONTIGUOUS, 0.1, 5, formulation="pallas",
            mxu_precision="tf32x3")
  with pytest.raises(ValueError):
    sub.run(x, d, CONTIGUOUS, 0.1, 5, formulation="xla")
  xt, dt = torch.from_numpy(x).to("meta"), torch.from_numpy(d).to("meta")
  # an early stop off the CPU and off CUDA: no silent plain path
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    sub.run(xt, dt, CONTIGUOUS, 0.1, 5, formulation="pallas",
            early_stopping_epsilon=1e-2, stepsize=0.05)
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    fused_group_fista.fused_group_fista_solve(xt, dt, 4, 0.1, 5, 0.05)
  with pytest.raises(ValueError, match="whole groups"):
    fused_group_fista.fused_group_fista_solve(torch.from_numpy(x),
                                              torch.from_numpy(d), 5, 0.1, 5,
                                              0.05)
  before = fused_group_fista.launches
  sub.run(x, d, CONTIGUOUS, 0.1, 5, formulation="pallas")
  assert fused_group_fista.launches == before  # CPU: the plain version


def _cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the fused group kernel has no CPU "
                "mode")
  return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_early_stop_raises_and_launches_nothing(rng):
  # the stop now runs on the card: one K4 launch each, the plain codes
  dev = _cuda_device()
  x, d = _problem(rng)
  before = fused_group_fista.launches
  got = sub.run(torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev),
                RAGGED, 0.1, 20, formulation="pallas",
                early_stopping_epsilon=1e-2)
  want = sub.run(x, d, RAGGED, 0.1, 20, formulation="pallas",
                 early_stopping_epsilon=1e-2)
  assert_close(got.cpu(), want, "run pallas early stop on cuda")
  xt, dt = torch.from_numpy(x), torch.from_numpy(d)
  got = fused_group_fista.fused_group_fista_solve(
      xt.to(dev), dt.to(dev), 4, 0.1, 20, 0.05, early_stopping_epsilon=1e-3)
  want = fused_group_fista.fused_group_fista_plain(
      xt, dt, 4, 0.1, 20, 0.05, early_stopping_epsilon=1e-3)
  assert_close(got.cpu(), want, "K4 early stop on cuda")
  assert fused_group_fista.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["contiguous", "ragged"])
def test_cuda_kernel_matches_plain(rng, kind):
  """The kernel against its plain version on the card (chip_smoke.py runs
  the full set at the flagship width)."""
  dev = _cuda_device()
  x, d = _problem(rng)
  groups = GROUPS[kind]
  before = fused_group_fista.launches
  got = sub.run(torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev),
                groups, 0.08, 20, formulation="pallas")
  assert fused_group_fista.launches == before + 1
  want = sub.run(x, d, groups, 0.08, 20, formulation="gram")
  assert_close(got.cpu(), want, "cuda kernel vs plain " + kind, KERNEL_ATOL)
