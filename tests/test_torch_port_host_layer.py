"""The port's host layer: it imports nothing of vtc_tpu (a static check of
every module and of chip_smoke.py), its own copies of vtc_tpu's host
modules behave as the originals (checkpoints round-trip in both
directions, byte for byte; reset/prune and the dictionary figures match),
and its entry points (the conv and ICA trainers, PCA and the ICA and PCA
coders included, with or without data_parallel) run on the CUDA device
unless the caller asks for the CPU: without a card the default raises
instead of running here.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from vtc_tpu.training import reset_prune as jax_reset_prune
from vtc_tpu.utils import checkpoint as jax_ckpt
from vtc_tpu.utils import debug as jax_debug
from vtc_tpu_torch import api, convert, device, encode
from vtc_tpu_torch.ops import fused_conv_direct, fused_fista
from vtc_tpu_torch.training import compiled_epoch
from vtc_tpu_torch.training import reset_prune
from vtc_tpu_torch.training import sparse_coding as sc
from vtc_tpu_torch.utils import checkpoint as ckpt
from vtc_tpu_torch.utils import debug, plotting

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "vtc_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports_of_vtc_tpu(path):
  """(line, statement) of every import of vtc_tpu, lazy ones included."""
  found = []
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      names = [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom):
      names = [node.module or ""] if node.level == 0 else []
    else:
      continue
    for name in names:
      if name == "vtc_tpu" or name.startswith("vtc_tpu."):
        found.append((node.lineno, name))
  return found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_never_imports_vtc_tpu(path):
  assert not _imports_of_vtc_tpu(path), _imports_of_vtc_tpu(path)


def test_the_static_check_sees_lazy_imports(tmp_path):
  probe = tmp_path / "probe.py"
  probe.write_text("import vtc_tpu_torch\n\ndef f():\n"
                   "  from vtc_tpu.utils import checkpoint\n"
                   "  import vtc_tpu.ops.lipschitz as lip\n")
  assert [name for _, name in _imports_of_vtc_tpu(probe)] == [
      "vtc_tpu.utils", "vtc_tpu.ops.lipschitz"]


def test_checkpoints_round_trip_both_ways(rng, tmp_path):
  """Each package resumes from the other's checkpoint and sidecar; the
  files are the same bytes."""
  d = rng.randn(12, 1, 4, 4).astype(np.float32)
  h = rng.rand(12).astype(np.float32)
  port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
  port_dir.mkdir()
  jax_dir.mkdir()
  sc.save_checkpoint(port_dir, 7, torch.from_numpy(d), torch.from_numpy(h))
  jax_ckpt.save_dictionary_checkpoint(jax_dir, 7, d)
  jax_ckpt.save_trainstate_sidecar(jax_dir, 7, hessian_diagonal=h,
                                   train_iteration=np.int64(7))
  for name in ("checkpoint_dictionary_iter_7",
               "checkpoint_trainstate_iter_7.npz"):
    assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()
  # vtc_tpu reads what the port wrote
  jd, jstate, it = jax_ckpt.resume_training_state(port_dir)
  assert it == 7 and np.array_equal(jd, d)
  assert np.array_equal(jstate["hessian_diagonal"], h)
  assert int(jstate["train_iteration"]) == 7
  assert np.array_equal(jax_ckpt.load_dictionary_checkpoint(
      port_dir / "checkpoint_dictionary_iter_7"), d)
  # ... and the port reads what vtc_tpu wrote
  pd, state, it = convert.load_train_state(jax_dir, "cpu")
  assert it == 7 and np.array_equal(pd.numpy(), d)
  assert np.array_equal(state["hessian_diagonal"].numpy(), h)
  assert state["train_iteration"] == 7
  assert np.array_equal(convert.load_dictionary(
      jax_dir / "checkpoint_dictionary_iter_7", "cpu").numpy(), d)
  assert ckpt.load_trainstate_sidecar(jax_dir, 8) is None


def test_host_copies_match_vtc_tpu(rng):
  d = rng.randn(16, 12).astype(np.float32)
  codes = rng.randn(30, 16).astype(np.float32)
  for action, filter_type, params in (
      ("reset", "random", {"num_to_modify": 3}),
      ("prune", "cosine_sim_threshold", {"threshold": 0.3}),
      ("prune", "random", {"num_to_modify": 2,
                           "group_assignments": [[0, 1], [2, 3, 4],
                                                 list(range(5, 16))]})):
    want = jax_reset_prune.reset_or_prune_dict_elements(
        d, codes, filter_type, dict(params), action,
        rng=np.random.default_rng(3))
    got = reset_prune.reset_or_prune_dict_elements(
        d, codes, filter_type, dict(params), action,
        rng=np.random.default_rng(3))
    assert np.array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1]) and got[2] == want[2]
  bad = d.copy()
  bad[3, 2] = np.inf
  with pytest.raises(FloatingPointError) as port_err:
    debug.assert_dictionary_healthy(bad, "here")
  with pytest.raises(FloatingPointError) as jax_err:
    jax_debug.assert_dictionary_healthy(bad, "here")
  assert str(port_err.value) == str(jax_err.value)


def test_display_dictionary_renders_both_layouts(rng):
  from matplotlib import pyplot as plt
  for dictionary, groups in ((rng.randn(16, 64), None),
                             (rng.randn(8, 1, 6, 6), None),
                             (rng.randn(16, 64), [[0, 1, 2], [3, 4]])):
    figs = plotting.display_dictionary(dictionary, renormalize=True,
                                       groupings=groups, plot_title="t")
    assert figs
    for fig in figs:
      plt.close(fig)


def test_entry_points_default_to_the_card(rng, monkeypatch):
  """Numpy inputs and no device: each entry point raises without a CUDA
  device and runs nothing on the CPU."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

  def no_cpu_solve(*args, **kwargs):
    raise AssertionError("an entry point ran a solve on the CPU")

  monkeypatch.setattr(fused_fista, "fused_fista_plain", no_cpu_solve)
  monkeypatch.setattr(fused_conv_direct, "fused_conv_direct_plain",
                      no_cpu_solve)
  d = rng.randn(16, 12).astype(np.float32)
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  x = rng.randn(3, 8, 12).astype(np.float32)
  params = {
      "mode": "fully-connected", "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {0: {"sparsity_weight": 0.05,
                                       "num_iters": 5}},
      "dictionary_update_algorithm": "sc_steepest_descent",
      "dict_update_param_schedule": {0: {"stepsize": 0.01, "num_iters": 1}},
  }
  kernels = rng.randn(4, 1, 4, 4).astype(np.float32)
  images = rng.randn(2, 1, 12, 12).astype(np.float32)
  from vtc_tpu_torch.training import ica, pca
  ica_params = {"num_epochs": 1,
                "dictionary_update_algorithm": "ica_natural_gradient",
                "dict_update_param_schedule": {0: {"stepsize": 0.01,
                                                   "num_iters": 1}}}
  square = np.linalg.qr(rng.randn(12, 12))[0].astype(np.float32)
  conv_params = dict(params, mode="convolutional", strides=(2, 2),
                     padding=((2, 2), (2, 2)))
  calls = [
      lambda: encode.encode_dataset(x[0], d, 0.05, 5),
      lambda: encode.encode_dataset(images, kernels, 0.05, 5,
                                    mode="convolutional",
                                    kernel_stride=(2, 2)),
      lambda: sc.train_dictionary(x, x[:1], d, params),
      lambda: compiled_epoch.train_dictionary_scanned(x, x[:1], d, params),
      lambda: api.SparseCoder(16),
      lambda: compiled_epoch.train_dictionary_scanned(
          images[None], images[None], kernels, conv_params),
      lambda: ica.train_dictionary(x, square, ica_params),
      lambda: ica.train_dictionary_scanned(x, square, ica_params),
      lambda: pca.train_dictionary(x[0] - x[0].mean(axis=0)),
      lambda: api.ICACoder(),
      lambda: api.PCACoder(),
      # data_parallel changes nothing about where an entry point runs
      lambda: encode.encode_dataset(x[0], d, 0.05, 5, data_parallel=True),
      lambda: sc.train_dictionary(x, x[:1], d,
                                  dict(params, data_parallel=True)),
      lambda: compiled_epoch.train_dictionary_scanned(
          x, x[:1], d, dict(params, data_parallel=True)),
      lambda: ica.train_dictionary_scanned(
          x, square, dict(ica_params, data_parallel=True)),
      lambda: pca.train_dictionary(x[0] - x[0].mean(axis=0),
                                   data_parallel=True),
  ]
  for call in calls:
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
      call()
  assert fused_fista.launches == 0
  # naming the CPU, or handing over CPU tensors, runs there
  assert device.resolve_device("cpu").type == "cpu"
  assert device.resolve_device(None, torch.zeros(1)).type == "cpu"
  assert api.SparseCoder(16, device="cpu").device.type == "cpu"
  assert api.ICACoder(device="cpu").device.type == "cpu"
  assert api.PCACoder(device="cpu").device.type == "cpu"
