"""vtc_tpu_torch never imports jax, and chip_smoke.py has no CPU path.

The jax blocker implements ``find_spec``: Python 3.12 ignores a meta-path
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
    if name == "jax" or name.startswith(("jax.", "jaxlib")):
      raise ImportError("jax blocked: " + name)
    return None

sys.meta_path.insert(0, JaxBlocker())
try:
  import jax
except ImportError:
  pass
else:
  raise SystemExit("the blocker let jax through")

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
                              chunk_batches=2, formulation="pallas")
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
