"""vtc_tpu imports and solves without torch, under a blocker that blocks.

tests/test_torch_free.py runs this check with a meta-path finder that has
only ``find_module``, which Python 3.12 ignores: under it ``import torch``
succeeds, so that test cannot fail for the reason it names.  This file
runs the same script (taken from that file) under a finder with
``find_spec``, and inside the same subprocess, before any vtc_tpu import,
requires ``import torch`` to raise ImportError.
"""
import importlib.util
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_FIND_MODULE_BLOCKER = '''class TorchBlocker:
  def find_module(self, name, path=None):
    if name == "torch" or name.startswith("torch."):
      return self
  def load_module(self, name):
    raise ImportError("torch blocked: " + name)
'''
_FIND_SPEC_BLOCKER = '''class TorchBlocker:
  def find_spec(self, name, path=None, target=None):
    if name == "torch" or name.startswith("torch."):
      raise ImportError("torch blocked: " + name)
    return None
'''
_INSTALL = "sys.meta_path.insert(0, TorchBlocker())\n"
_PROBE = _INSTALL + '''try:
  import torch
except ImportError:
  print("TORCH_BLOCKED")
else:
  raise SystemExit("the blocker let torch through")
'''


def _torch_free_script():
  spec = importlib.util.spec_from_file_location(
      "_test_torch_free", REPO / "tests" / "test_torch_free.py")
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  script = module._SCRIPT
  assert script.count(_FIND_MODULE_BLOCKER) == 1, "the blocker changed"
  assert script.count(_INSTALL) == 1
  return script


def _run(script):
  return subprocess.run([sys.executable, "-c", script], capture_output=True,
                        text=True, timeout=600, cwd=str(REPO))


def test_package_runs_without_torch_under_find_spec():
  script = _torch_free_script().replace(
      _FIND_MODULE_BLOCKER, _FIND_SPEC_BLOCKER).replace(_INSTALL, _PROBE)
  out = _run(script)
  assert out.returncode == 0, out.stdout + out.stderr
  assert "TORCH_BLOCKED" in out.stdout, out.stdout + out.stderr
  assert "TORCH_FREE_OK" in out.stdout, out.stdout + out.stderr


def test_find_module_blocker_blocks_nothing():
  """The fault this file works around: under test_torch_free.py's own
  blocker, torch imports."""
  out = _run(_FIND_MODULE_BLOCKER + "import sys\n" + _INSTALL
             + "import torch\nprint('TORCH_IMPORTED')\n")
  assert out.returncode == 0 and "TORCH_IMPORTED" in out.stdout, (
      out.stdout + out.stderr)
