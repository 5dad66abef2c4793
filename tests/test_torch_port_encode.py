"""The port's encode slice as a whole against vtc_tpu on the CPU:
``ista_fista.run``, ``encode_dataset``, ``SparseCoder.encode`` /
``decode`` and ``convert``, at n=64, s=96, D=1000 (a ragged tail),
batch 256, ``chunk_batches=2``, 50 iterations.

The same numpy inputs (from a seed) go through both packages.
Tolerance: atol 1e-4, the repo's parity contract (CLAUDE.md); each test
prints the observed max |d|.
"""
import numpy as np
import pytest
import torch

from vtc_tpu import api as jax_api
from vtc_tpu.analysis_transforms.fully_connected import (
    ista_fista as jax_ista_fista)
from vtc_tpu.encode import encode_dataset as jax_encode_dataset
from vtc_tpu.utils.checkpoint import save_dictionary_checkpoint
from vtc_tpu_torch import convert
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.api import SparseCoder
from vtc_tpu_torch.encode import encode_dataset
from vtc_tpu_torch.ops import fused_fista

ATOL = 1e-4
N, S, D, BATCH, CHUNK, ITERS, LAM = 64, 96, 1000, 256, 2, 50, 0.05


def assert_close(got, want, what, atol=ATOL):
  err = float(np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(want, np.float64))))
  print("%s: max|d| = %.3e (atol %.0e)" % (what, err, atol))
  assert err <= atol, "%s: max|d| %.3e > %.0e" % (what, err, atol)


@pytest.fixture
def problem():
  rng = np.random.RandomState(0)
  d = rng.randn(S, N).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  # sparse mixtures of the atoms plus noise: patch-like code magnitudes
  codes = rng.randn(D, S) * (rng.rand(D, S) < 0.05)
  x = (codes @ d + 0.05 * rng.randn(D, N)).astype(np.float32)
  return x, d


@pytest.mark.parametrize("formulation", ["gram", "direct", "pallas"])
@pytest.mark.parametrize("variant", ["ista", "fista"])
def test_run_matches_jax(problem, formulation, variant):
  x, d = problem
  x = x[:BATCH]
  want = np.asarray(jax_ista_fista.run(x, d, LAM, ITERS, variant=variant,
                                       formulation=formulation))
  got = ista_fista.run(torch.from_numpy(x), torch.from_numpy(d), LAM,
                       ITERS, variant=variant, formulation=formulation)
  assert got.shape == (BATCH, S) and got.dtype == torch.float32
  assert_close(got, want, "run %s %s" % (formulation, variant))


@pytest.mark.parametrize("formulation", ["gram", "pallas"])
def test_run_flags_match_jax(problem, formulation):
  """Warm start, thresholds and early stop.  Hard thresholds run on 16
  rows: they are discontinuous, and over a full batch some value lands
  within rounding of the threshold and moves its code by the threshold
  itself between any two float32 implementations."""
  x, d = problem
  x = x[:BATCH]
  init = np.array(jax_ista_fista.run(x, d, LAM, 10))
  for rows, kw in ((BATCH, dict(initial_codes=init)),
                   (BATCH, dict(nonnegative_only=True)),
                   (BATCH, dict(early_stopping_epsilon=1e-2)),
                   (16, dict(hard_threshold=True)),
                   (16, dict(hard_threshold=True, nonnegative_only=True))):
    if "initial_codes" in kw:
      kw["initial_codes"] = kw["initial_codes"][:rows]
    want = np.asarray(jax_ista_fista.run(x[:rows], d, LAM, ITERS,
                                         formulation=formulation, **kw))
    got = ista_fista.run(x[:rows], d, LAM, ITERS, formulation=formulation,
                         **kw)
    assert_close(got, want, "run %s %s" % (formulation, sorted(kw)))


def test_run_pallas_early_stop_refused_off_cpu(problem):
  """Off the CPU and off CUDA, 'pallas' with an early stop raises instead
  of running the plain loop."""
  x, d = problem
  xt, dt = torch.from_numpy(x[:8]).to("meta"), torch.from_numpy(d).to("meta")
  with pytest.raises(ValueError, match="CPU or a CUDA device"):
    ista_fista.run(xt, dt, LAM, 5, formulation="pallas",
                   early_stopping_epsilon=1e-2, stepsize=0.05)


def test_run_pallas_early_stop_refused_on_cuda(problem):
  """On the card 'pallas' with an early stop runs K1's stop test (one
  launch) and 'gram' the plain loop; both stop as JAX does."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernel has no CPU mode")
  x, d = problem
  x = x[:BATCH]
  dev = torch.device("cuda", 0)
  xt, dt = torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)
  before = fused_fista.launches
  want = np.asarray(jax_ista_fista.run(x, d, LAM, ITERS, formulation="gram",
                                       early_stopping_epsilon=1e-2))
  got = ista_fista.run(xt, dt, LAM, ITERS, formulation="pallas",
                       early_stopping_epsilon=1e-2)
  assert fused_fista.launches == before + 1
  assert_close(got.cpu(), want, "run pallas early stop on cuda")
  got = ista_fista.run(xt, dt, LAM, ITERS, formulation="gram",
                       early_stopping_epsilon=1e-2)
  assert_close(got.cpu(), want, "run gram early stop on cuda")


def test_run_rejects_unported_options(problem):
  x, d = problem
  # the tiers run (tests/test_torch_port_tiers.py holds them
  # to vtc_tpu): bf16x3 lies near the fp32 codes, not on them; an unknown
  # tier is refused
  full = ista_fista.run(x[:8], d, LAM, 5, formulation="pallas")
  tier = ista_fista.run(x[:8], d, LAM, 5, formulation="pallas",
                        mxu_precision="bf16x3")
  assert 0.0 < float((tier - full).abs().max()) < 1e-3
  with pytest.raises(ValueError, match="tier"):
    ista_fista.run(x[:8], d, LAM, 5, formulation="pallas",
                   mxu_precision="bf16x4")
  with pytest.raises(ValueError):
    ista_fista.run(x[:8], d, LAM, 5, formulation="xla")


@pytest.mark.parametrize("formulation", [None, "pallas", "gram"])
def test_encode_dataset_matches_jax(problem, formulation):
  x, d = problem
  want = jax_encode_dataset(x, d, LAM, ITERS, batch_size=BATCH,
                            chunk_batches=CHUNK)
  got = encode_dataset(x, d, LAM, ITERS, batch_size=BATCH,
                       chunk_batches=CHUNK, formulation=formulation,
                       device="cpu")
  assert isinstance(got, np.ndarray) and got.shape == (D, S)
  assert_close(got, want, "encode_dataset formulation=%s" % formulation)


def test_encode_dataset_options_match_jax(problem):
  x, d = problem
  kw = dict(batch_size=300, chunk_batches=3, variant="ista",
            nonnegative_only=True)
  want = jax_encode_dataset(x, d, LAM, 20, **kw)
  got = encode_dataset(x, torch.from_numpy(d), LAM, 20, **kw)
  assert_close(got, want, "encode_dataset ista nonneg, 4 batches of 300")


def test_encode_dataset_rejects_unported_options(problem):
  x, d = problem
  # mode='convolutional' is ported (tests/test_torch_port_conv.py), and so
  # is data_parallel in every mode (tests/test_torch_port_parallel_train.py,
  # tests/test_torch_port_conv_parallel.py): conv with one rank is the
  # plain call
  images = np.random.RandomState(1).randn(4, 1, 12, 12).astype(np.float32)
  kernels = np.ones((3, 1, 4, 4), np.float32) / 4.0
  conv = dict(mode="convolutional", kernel_stride=(2, 2), batch_size=2)
  assert np.array_equal(
      encode_dataset(images, kernels, LAM, 5, device="cpu", data_parallel=True,
                     **conv),
      encode_dataset(images, kernels, LAM, 5, device="cpu", **conv))
  # a tier in conv mode still waits; in fc mode the CPU's default 'gram'
  # formulation keeps full precision, as vtc_tpu's does
  with pytest.raises(NotImplementedError, match="ROADMAP"):
    encode_dataset(images, kernels, LAM, 5, device="cpu",
                   mxu_precision="bf16", **conv)
  assert np.array_equal(
      encode_dataset(x, d, LAM, 5, device="cpu", mxu_precision="bf16"),
      encode_dataset(x, d, LAM, 5, device="cpu"))
  with pytest.raises(TypeError, match="data_parallel"):
    encode_dataset(x, d, LAM, 5, device="cpu", data_parallel=object())
  got = encode_dataset(x[:BATCH], d, LAM, 5, batch_size=BATCH, device="cpu",
                       data_parallel=True)  # no process group: one rank
  assert np.array_equal(got, encode_dataset(x[:BATCH], d, LAM, 5,
                                            batch_size=BATCH, device="cpu"))


def test_sparse_coder_matches_jax(problem, tmp_path):
  x, d = problem
  want_coder = jax_api.SparseCoder(S, sparsity_weight=LAM,
                                   inference_iters=ITERS)
  want_coder.dictionary = d
  coder = SparseCoder(S, sparsity_weight=LAM, inference_iters=ITERS,
                      device="cpu")
  with pytest.raises(ValueError):
    coder.encode(x)
  coder.dictionary = convert.load_dictionary(
      save_dictionary_checkpoint(tmp_path, 7, d), "cpu")
  want = np.asarray(want_coder.encode(x[:BATCH]))
  got = coder.encode(x[:BATCH])
  assert isinstance(got, torch.Tensor)
  assert_close(got, want, "SparseCoder.encode")
  want_b = want_coder.encode(x, batch_size=BATCH, chunk_batches=CHUNK)
  got_b = coder.encode(x, batch_size=BATCH, chunk_batches=CHUNK)
  assert_close(got_b, want_b, "SparseCoder.encode(batch_size)")
  assert_close(coder.decode(got_b), np.asarray(want_coder.decode(want_b)),
               "SparseCoder.decode")
  # fit trains from the dictionary it holds (tests/test_torch_port_trainer
  # holds fit itself against vtc_tpu)
  before = coder.dictionary.clone()
  coder.fit(x[:2 * BATCH], num_epochs=1, batch_size=BATCH)
  assert coder.dictionary.shape == (S, N)
  assert bool(torch.isfinite(coder.dictionary).all())
  assert float((coder.dictionary - before).abs().max()) > 0


def test_convert_round_trip(tmp_path):
  rng = np.random.RandomState(3)
  d64 = rng.randn(S, N)
  t = convert.dictionary_from_numpy(np.asfortranarray(d64), "cpu")
  assert t.dtype == torch.float32 and t.is_contiguous()
  assert np.array_equal(t.numpy(), d64.astype(np.float32))
  path = save_dictionary_checkpoint(tmp_path, 3, d64.astype(np.float32))
  loaded = convert.load_dictionary(path, torch.device("cpu"))
  assert np.array_equal(loaded.numpy(), d64.astype(np.float32))
  with pytest.raises(ValueError):
    convert.dictionary_from_numpy(np.zeros(3), "cpu")
