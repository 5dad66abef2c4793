"""Every test marked ``cuda`` has its check in chip_smoke.py.

The machine with the card has no jax, and the port's test files import
vtc_tpu, so a test marked ``cuda`` cannot even be collected there; here it
skips.  chip_smoke.py's ``CUDA_TESTS`` maps each such test
(``file::name``) to the phases that make its check on the card.  This
file finds every ``@pytest.mark.cuda`` test under tests/ with ``ast`` and
fails when one is missing from that table, when the table names a test
that does not exist, or when it names a phase that chip_smoke.py does not
have (read from its ``# phase N:`` comments).  The last test runs the same
check on altered copies, to show that it can fail.
"""
import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _is_cuda_mark(decorator):
  """@pytest.mark.cuda, with or without a call."""
  if isinstance(decorator, ast.Call):
    decorator = decorator.func
  return (isinstance(decorator, ast.Attribute) and decorator.attr == "cuda"
          and isinstance(decorator.value, ast.Attribute)
          and decorator.value.attr == "mark")


def cuda_tests(tests_dir):
  """{'file.py::test_name'} of every test marked cuda in tests_dir."""
  found = set()
  for path in sorted(pathlib.Path(tests_dir).glob("test_*.py")):
    for node in ast.walk(ast.parse(path.read_text())):
      if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
          and node.name.startswith("test")
          and any(_is_cuda_mark(d) for d in node.decorator_list)):
        found.add("%s::%s" % (path.name, node.name))
  return found


def smoke_table(source):
  """chip_smoke.py's CUDA_TESTS, read without running the script."""
  for node in ast.parse(source).body:
    if isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Name) and t.id == "CUDA_TESTS"
        for t in node.targets):
      return ast.literal_eval(node.value)
  raise AssertionError("chip_smoke.py has no CUDA_TESTS table")


def smoke_phases(source):
  return {int(m) for m in re.findall(r"^\s*# phase (\d+):", source, re.M)}


def problems(tests_dir, source):
  """What is wrong with the table, as a sorted list of messages."""
  table, phases = smoke_table(source), smoke_phases(source)
  marked = cuda_tests(tests_dir)
  out = ["%s is marked cuda but has no phase in CUDA_TESTS" % t
         for t in marked - set(table)]
  out += ["CUDA_TESTS names %s, which is not a cuda test" % t
          for t in set(table) - marked]
  out += ["CUDA_TESTS maps %s to phase %d, which chip_smoke.py lacks" % (t, p)
          for t, ps in table.items() for p in ps if p not in phases]
  out += ["CUDA_TESTS maps %s to no phase" % t
          for t, ps in table.items() if not ps]
  return sorted(out)


def test_every_cuda_test_has_a_phase():
  source = (REPO / "chip_smoke.py").read_text()
  assert problems(REPO / "tests", source) == []
  marked = cuda_tests(REPO / "tests")
  assert "test_torch_port_code_shard.py::test_cuda_kernel_matches_plain" in (
      marked)
  assert len(marked) >= 16
  assert set(range(1, 30)) <= smoke_phases(source)


@pytest.mark.parametrize("fault", ["missing test", "unknown phase",
                                   "stale entry"])
def test_the_check_fails_on_a_fault(tmp_path, fault):
  source = (REPO / "chip_smoke.py").read_text()
  for path in (REPO / "tests").glob("test_torch_port_*.py"):
    (tmp_path / path.name).write_text(path.read_text())
  assert problems(tmp_path, source) == []  # the copies start clean
  if fault == "missing test":
    (tmp_path / "test_torch_port_new.py").write_text(
        "import pytest\n\n\n@pytest.mark.cuda\ndef test_new():\n  pass\n")
  elif fault == "unknown phase":
    source = source.replace('"test_torch_port_ica.py::'
                            'test_cuda_k8_matches_plain": (20,)',
                            '"test_torch_port_ica.py::'
                            'test_cuda_k8_matches_plain": (99,)')
  else:
    (tmp_path / "test_torch_port_ica.py").unlink()
  found = problems(tmp_path, source)
  print(found)
  assert len(found) == 1, found
  assert {"missing test": "test_new", "unknown phase": "phase 99",
          "stale entry": "not a cuda test"}[fault] in found[0]
