"""vtc_tpu_torch never imports jax nor the JAX package vtc_tpu -- it
encodes and trains (fc, subspace, conv with both conv trainers, ICA and
PCA, the big-dictionary residual form, and the data-parallel layer on a
mesh of one rank), with checkpoints and a reset/prune schedule, with both
blocked -- and chip_smoke.py has no CPU path.

The blocker implements ``find_spec``: Python 3.12 ignores a meta-path
finder that only has ``find_module``, so such a finder blocks nothing.
"""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = """
import sys

class JaxBlocker:
  def find_spec(self, name, path=None, target=None):
    if (name in ("jax", "vtc_tpu")
        or name.startswith(("jax.", "jaxlib", "vtc_tpu."))):
      raise ImportError("blocked: " + name)
    return None

sys.meta_path.insert(0, JaxBlocker())
for blocked in ("jax", "vtc_tpu", "vtc_tpu.utils.checkpoint"):
  try:
    __import__(blocked)
  except ImportError:
    pass
  else:
    raise SystemExit("the blocker let %s through" % blocked)

import numpy as np
import vtc_tpu_torch
from vtc_tpu_torch import api, convert, encode
from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
from vtc_tpu_torch.ops import (_build, fused_fista, lipschitz, precision,
                               solver, thresholds)
rng = np.random.RandomState(0)
d = rng.randn(16, 12).astype(np.float32)
d /= np.linalg.norm(d, axis=1, keepdims=True)
codes = encode.encode_dataset(rng.randn(40, 12), d, 0.01, 5, batch_size=16,
                              chunk_batches=2, formulation="pallas",
                              device="cpu")
assert codes.shape == (40, 16)

# the trainer slice: both trainers and SparseCoder.fit, a few steps each
from vtc_tpu_torch.api import SparseCoder
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    sc_cheap_quadratic_descent, sc_steepest_descent)
from vtc_tpu_torch.ops import fused_train_step
from vtc_tpu_torch.training import compiled_epoch, sparse_coding
batches = rng.randn(3, 8, 12).astype(np.float32)
params = {
    "mode": "fully-connected", "num_epochs": 2,
    "code_inference_algorithm": "fista",
    "inference_param_schedule": {0: {"sparsity_weight": 0.05,
                                     "num_iters": 5}},
    "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
    "dict_update_param_schedule": {0: {"stepsize": 0.01, "num_iters": 1},
                                   4: {"stepsize": 0.005, "num_iters": 2}},
    "stdout_print_interval": 10**9,
}
for trainer in (sparse_coding.train_dictionary,
                compiled_epoch.train_dictionary_scanned):
  trained = trainer(batches, batches[:1], d, params, device="cpu")
  assert trained.shape == (16, 12) and bool(trained.isfinite().all())
  assert float((trained - vtc_tpu_torch.convert.dictionary_from_numpy(
      d, "cpu")).abs().max()) > 0
# checkpoints and a reset/prune schedule: the port's own host modules
import pathlib, tempfile
logdir = pathlib.Path(tempfile.mkdtemp())
events = dict(params, checkpoint_schedule={2, 4}, logging_folder_fullpath=(
    str(logdir)), dict_element_rp_schedule={3: {
        "filter_type": "random", "filter_params": {"num_to_modify": 2},
        "action": "prune"}})
trained = sparse_coding.train_dictionary(batches, batches[:1], d, events,
                                         device="cpu")
assert trained.shape == (14, 12)
resumed, state, it = convert.load_train_state(logdir, "cpu")
assert it == 4 and state["train_iteration"] == 4 and resumed.shape == (14, 12)
coder = SparseCoder(16, sparsity_weight=0.05, inference_iters=5,
                    formulation="pallas", device="cpu").fit(
                        rng.randn(64, 12), 2, 16)
assert coder.dictionary.shape == (16, 12)

# the subspace slice: group encoding, the K4 and K6 wrappers' plain
# versions, and both trainers with groups and the alignment penalty
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    subspace_ista_fista)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    _subspace_common, subspace_sc_cheap_quadratic_descent,
    subspace_sc_steepest_descent)
from vtc_tpu_torch.ops import fused_group_fista, fused_group_train_step
groups = [[0, 1, 2, 3], [4, 5], [5, 6, 7], list(range(8, 16))]
codes = encode.encode_dataset(rng.randn(40, 12), d, 0.01, 5, batch_size=16,
                              chunk_batches=2, formulation="pallas",
                              group_assignments=groups, device="cpu")
assert codes.shape == (40, 16)
sub_params = dict(params, code_inference_algorithm="subspace_fista",
                  dictionary_update_algorithm=(
                      "subspace_sc_cheap_quadratic_descent"),
                  group_assignments=groups, subspace_alignment_penalty=0.2)
for trainer in (sparse_coding.train_dictionary,
                compiled_epoch.train_dictionary_scanned):
  trained = trainer(batches, batches[:1], d, sub_params, device="cpu")
  assert trained.shape == (16, 12) and bool(trained.isfinite().all())

# the conv slice: one conv encode (K10's plain version) and two steps of
# the per-batch conv trainer
from vtc_tpu_torch.analysis_transforms.convolutional import (
    ista_fista as conv_ista_fista)
from vtc_tpu_torch.dict_update_rules.convolutional import (
    sc_cheap_quadratic_descent as conv_cqd, sc_steepest_descent as conv_sd)
from vtc_tpu_torch.ops import (conv_dict_gram, conv_gram, conv_shapes,
                               convolutions, fused_conv_direct,
                               fused_conv_fista)
kernels = rng.randn(6, 1, 4, 4).astype(np.float32)
kernels /= np.sqrt((kernels ** 2).sum(axis=(1, 2, 3), keepdims=True))
images = np.pad(rng.randn(2, 5, 1, 8, 8),
                ((0, 0), (0, 0), (0, 0), (2, 2), (2, 2))).astype(np.float32)
conv = dict(kernel_stride=(2, 2), padding=((2, 2), (2, 2)))
codes = encode.encode_dataset(images[0], kernels, 0.05, 5, batch_size=3,
                              mode="convolutional", formulation="pallas",
                              device="cpu", **conv)
assert codes.shape == (5, 6, 5, 5) and np.isfinite(codes).all()
conv_params = dict(params, mode="convolutional", num_epochs=1,
                   strides=(2, 2), padding=((2, 2), (2, 2)),
                   conv_formulation="pallas")
trained = sparse_coding.train_dictionary(images, images[:1], kernels,
                                         conv_params, device="cpu")
assert trained.shape == (6, 1, 4, 4) and bool(trained.isfinite().all())
# the scanned conv trainer: the per-step path and K12's plain version
from vtc_tpu_torch.ops import fused_conv_train
trained = compiled_epoch.train_dictionary_scanned(
    images, images[:1], kernels, conv_params, device="cpu")
assert trained.shape == (6, 1, 4, 4) and bool(trained.isfinite().all())
import torch
h0 = torch.zeros(6)
v0 = lipschitz.top_gram_eigenpair(torch.from_numpy(kernels).reshape(6, -1))[1]
out = fused_conv_train.fused_conv_train_segment(
    torch.from_numpy(kernels), h0, v0.contiguous(), torch.from_numpy(images),
    0.05, 5, 0.01, power_iters=2, **conv)
assert out[0].shape == (6, 1, 4, 4) and out[3].shape == (5, 6, 5, 5)

# the ICA and PCA family: both ICA trainers (the fused path's plain
# version), PCA and the coders
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    invertible_linear)
from vtc_tpu_torch.dict_update_rules.fully_connected import (
    ica_natural_gradient)
from vtc_tpu_torch.ops import fused_ica_train
from vtc_tpu_torch.training import ica, pca
square = np.linalg.qr(rng.randn(12, 12))[0].astype(np.float32)
ica_params = {"num_epochs": 1,
              "dictionary_update_algorithm": "ica_natural_gradient",
              "dict_update_param_schedule": {0: {"stepsize": 0.01,
                                                 "num_iters": 1}},
              "use_fused": True, "stdout_print_interval": 10**9}
for trainer in (ica.train_dictionary, ica.train_dictionary_scanned):
  trained = trainer(batches, square, ica_params, device="cpu")
  assert trained.shape == (12, 12) and bool(trained.isfinite().all())
mixed = rng.laplace(size=(200, 12)).astype(np.float32)
assert pca.train_dictionary(mixed - mixed.mean(0), device="cpu").shape == (
    12, 12)
assert api.ICACoder(device="cpu").fit(mixed, 1, 50).encode(mixed).shape == (
    200, 12)
assert api.PCACoder(4, device="cpu").fit(mixed).encode(mixed).shape == (
    200, 4)

# the big-dictionary slice: the residual-form runner (K19's plain
# version), fc and with groups
from vtc_tpu_torch.ops import fused_code_shard_train
big = torch.from_numpy(rng.randn(40, 12).astype(np.float32))
big = big / big.norm(dim=1, keepdim=True)
arrays = fused_code_shard_train.code_shard_group_arrays(
    [list(range(i, i + 4)) for i in range(0, 40, 4)], 40, 1)
v12 = lipschitz.top_gram_eigenpair(big)[1].contiguous()
for alg, group_arrays in (("sc_cheap_quadratic_descent", None),
                          ("subspace_sc_cheap_quadratic_descent", arrays)):
  out = compiled_epoch._code_shard_segment_runner(
      None, 1, 1, "fista", alg, 1, False, False, True,
      group_arrays=group_arrays)(
          big, torch.zeros(40), v12, torch.from_numpy(batches), 0.05, 5,
          0.01)
  assert out[0].shape == (40, 12) and bool(out[0].isfinite().all())

# the data-parallel layer: the mesh, the steps, K3, K7 and K9's plain
# versions, and every entry point with data_parallel on a mesh of one rank,
# where the scanned trainers run K15, K16 and K18's plain versions
from vtc_tpu_torch import parallel
from vtc_tpu_torch.ops import fused_dp_train, fused_group_dp_train, sum_hook
from vtc_tpu_torch.parallel import data_parallel, mesh as mesh_module
mesh = parallel.make_mesh()
assert sum_hook.SumHook(mesh, torch.zeros(3)).pointer is None
assert mesh.size == 1 and parallel.dp_axes(mesh) == ("data",)
for dp_params in (dict(params, fc_formulation="pallas"),
                  dict(sub_params, fc_formulation="pallas"), params):
  for trainer in (sparse_coding.train_dictionary,
                  compiled_epoch.train_dictionary_scanned):
    trained = trainer(batches, batches[:1], d,
                      dict(dp_params, data_parallel=True), device="cpu")
    assert trained.shape == (16, 12) and bool(trained.isfinite().all())
trained = ica.train_dictionary_scanned(
    batches, square, dict(ica_params, data_parallel=mesh), device="cpu")
assert trained.shape == (12, 12) and bool(trained.isfinite().all())
assert pca.train_dictionary(mixed - mixed.mean(0), data_parallel=mesh,
                            device="cpu").shape == (12, 12)
codes = encode.encode_dataset(rng.randn(40, 12), d, 0.01, 5, batch_size=16,
                              device="cpu", data_parallel=True)
assert codes.shape == (40, 16)
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
# nor anything of the JAX package itself (the smoke run on the card
# imports the port alone)
assert not [m for m in sys.modules
            if m == "vtc_tpu" or m.startswith("vtc_tpu.")]
print("JAX_FREE_OK")
"""


def test_port_imports_and_encodes_without_jax():
  out = subprocess.run(
      [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
      timeout=300, cwd=str(REPO))
  assert out.returncode == 0, out.stdout + out.stderr
  assert "JAX_FREE_OK" in out.stdout, out.stdout + out.stderr


def test_chip_smoke_refuses_without_cuda():
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present: chip_smoke.py would run")
  out = subprocess.run(
      [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
      timeout=300, cwd=str(REPO))
  assert out.returncode != 0
  assert "no CUDA device" in out.stderr, out.stdout + out.stderr
  for line in out.stdout.splitlines():
    try:
      result = json.loads(line)
    except ValueError:
      continue
    assert result.get("ok") is not True, line
