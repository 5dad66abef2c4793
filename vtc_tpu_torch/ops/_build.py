"""Build and load the port's CUDA kernels (vtc_tpu_torch/csrc/*.cu).

At first use ``nvcc`` compiles every source in ``csrc/`` for ``sm_90a``,
one process per source, all started together, and links the objects
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The library lands in ``vtc_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  A missing ``nvcc``
or a failed compile raises with the compiler's output: there is no
fallback.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")


class BuildError(RuntimeError):
  """The CUDA kernels could not be compiled."""


def find_nvcc():
  """Path of nvcc under $CUDA_HOME (default /usr/local/cuda) or on PATH,
  or None."""
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  search = os.pathsep.join(
      [os.path.join(cuda_home, "bin"), os.environ.get("PATH", "")])
  return shutil.which("nvcc", path=search)


def _sources():
  return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path(build_dir=None):
  """Where the library for the current sources and flags lives."""
  digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in _sources():
    digest.update(src.name.encode())
    digest.update(src.read_bytes())
  return Path(build_dir or BUILD_DIR) / (
      "libvtc_kernels_%s.so" % digest.hexdigest()[:16])


def build(build_dir=None, verbose=False):
  """Compile csrc/*.cu unless the library for these sources exists.

  Returns the library's path.  Raises BuildError when nvcc is missing or
  the compile fails, with the compiler's output in the message.
  """
  lib = library_path(build_dir)
  if lib.exists():
    return lib
  nvcc = find_nvcc()
  if nvcc is None:
    raise BuildError(
        "nvcc not found under $CUDA_HOME/bin or on PATH; the CUDA kernels "
        "of vtc_tpu_torch are compiled at first use and have no fallback")
  lib.parent.mkdir(parents=True, exist_ok=True)
  cu_files = [p for p in _sources() if p.suffix == ".cu"]
  work = tempfile.mkdtemp(dir=lib.parent)
  try:
    objects = [os.path.join(work, p.stem + ".o") for p in cu_files]
    compiles = [
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
         "-o", obj, str(src)] for src, obj in zip(cu_files, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outputs = [proc.communicate()[0] for proc in procs]
    tmp = os.path.join(work, lib.name)
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objects]
    steps = list(zip(compiles, [p.returncode for p in procs], outputs))
    if all(rc == 0 for _, rc, _ in steps):
      proc = subprocess.run(link, capture_output=True, text=True,
                            check=False)
      steps.append((link, proc.returncode, proc.stdout + proc.stderr))
    for cmd, rc, out in steps:
      if rc != 0:
        raise BuildError("nvcc failed (exit %d): %s\n%s" % (
            rc, " ".join(cmd), out))
      if verbose:
        print(out)
    os.replace(tmp, lib)
  finally:
    shutil.rmtree(work, ignore_errors=True)
  return lib


@functools.cache
def load_library():
  """Build if needed, load, and declare the C entry points."""
  lib = ctypes.CDLL(str(build()))
  ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
  i32p = ctypes.POINTER(i32)
  for name in ("vtc_fista_rows", "vtc_fista_chunk", "vtc_fista_col_block",
               "vtc_fista_slice_bytes", "vtc_fista_cluster",
               "vtc_fista_cluster_max_rows", "vtc_fista_sm_count",
               "vtc_fista_cluster_slots"):
    getattr(lib, name).argtypes = []
    getattr(lib, name).restype = i32
  for name in ("vtc_fista_route", "vtc_fista_cluster_rows",
               "vtc_fista_wide_rows"):
    getattr(lib, name).argtypes = [i32, i32, i32]
    getattr(lib, name).restype = i32
  lib.vtc_fista_wide_cluster.argtypes = [i32, i32]
  lib.vtc_fista_wide_cluster.restype = i32
  lib.vtc_fista_wide_slots.argtypes = [i32]
  lib.vtc_fista_wide_slots.restype = i32
  lib.vtc_fista_cluster_occupancy.argtypes = [i32, i32]
  lib.vtc_fista_cluster_occupancy.restype = i32
  lib.vtc_fista_stop_route.argtypes = [i32, i32, i32]
  lib.vtc_fista_stop_route.restype = i32
  lib.vtc_fista_stop_words.argtypes = [i32, i32, i32]
  lib.vtc_fista_stop_words.restype = ctypes.c_int64
  # the solve's early stop: eps, inv_count, the words, the count, the tag
  # (vtc_fused_fista and vtc_fused_group_fista then take the share and the
  # stop hook across ranks, which only the C segments pass)
  stop = [f32, f32, ptr, ptr, ctypes.c_uint]
  # ... and the tier (0 'highest', 1 bf16, 2 bf16x3, 3 bf16x5)
  lib.vtc_fused_fista.argtypes = [
      ptr, ptr, ptr, ptr, f32, i32, i32, i32, i32, i32, i32, i32,
      ptr, ptr, ptr, i32, i32p] + stop + [ptr, ptr, i32, ptr]
  lib.vtc_fused_fista.restype = i32
  lib.vtc_fista_tier_gn_floats.argtypes = [i32, i32]
  lib.vtc_fista_tier_gn_floats.restype = ctypes.c_int64
  lib.vtc_fista_tier_state_in_smem.argtypes = [i32, i32]
  lib.vtc_fista_tier_state_in_smem.restype = i32
  lib.vtc_power_smem_bytes.argtypes = [i32]
  lib.vtc_power_smem_bytes.restype = i32
  lib.vtc_train_segment.argtypes = [
      ptr, ptr, ptr, ptr, i32, i32, i32, i32, f32, i32, f32, i32, f32,
      i32, i32, i32, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
      i32, i32, ptr, ptr] + stop[:4] + [i32, ptr, ptr]
  lib.vtc_train_segment.restype = i32
  lib.vtc_solve_stats.argtypes = (
      [ptr] * 3 + [i32] * 3 + [f32] + [i32] * 4 + [ptr] * 8 + [i32, i32]
      + [ptr] * 2 + [i32, ptr, ptr])
  lib.vtc_solve_stats.restype = i32
  # the stop across ranks: the rank's one-float share and its stop hook
  rank_stop = stop[:4] + [ptr, ptr]
  lib.vtc_dp_train_segment.argtypes = (
      [ptr] * 4 + [i32] * 4 + [f32, i32, f32, i32, f32] + [i32] * 5 + [f32]
      + [ptr] * 6 + [i32, i32] + [ptr] * 3 + [ptr] + rank_stop
      + [i32, ptr, ptr])
  lib.vtc_dp_train_segment.restype = i32
  lib.vtc_fused_group_fista.argtypes = [
      ptr, ptr, ptr, ptr, f32, i32, i32, i32, i32, i32, i32, i32, i32,
      ptr, ptr, ptr, i32, i32p] + stop + [ptr, ptr, i32, ptr]
  lib.vtc_fused_group_fista.restype = i32
  lib.vtc_group_train_segment.argtypes = [
      ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, i32, ptr,
      f32, f32, i32, f32, i32, f32, i32, i32, i32, i32, i32, f32,
      ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
      i32, i32, ptr, ptr] + stop[:4] + [i32, ptr, ptr]
  lib.vtc_group_train_segment.restype = i32
  lib.vtc_group_solve_stats.argtypes = (
      [ptr] * 3 + [i32] * 5 + [ptr, ptr, i32, f32] + [i32] * 4 + [ptr] * 10
      + [i32, i32] + [ptr] * 2 + [i32, ptr, ptr])
  lib.vtc_group_solve_stats.restype = i32
  lib.vtc_group_dp_train_segment.argtypes = (
      [ptr] * 4 + [i32] * 6 + [ptr, ptr, i32, ptr, f32, f32, i32, f32, i32,
                                f32] + [i32] * 5 + [f32] + [ptr] * 11
      + [i32, i32] + [ptr] * 3 + [ptr] + rank_stop + [i32, ptr, ptr])
  lib.vtc_group_dp_train_segment.restype = i32
  # the conv solves' early stop: eps, inv_count, the words, the counts
  conv_stop = [f32, f32, ptr, ptr]
  # ... and the conv solves' tier and the words of its split weights
  conv_tier = [i32, ptr]
  lib.vtc_conv_direct.argtypes = [
      ptr, ptr, ptr, ptr, ptr, f32, i32, i32, i32, i32, i32, i32, i32, i32,
      i32, i32, ptr, ptr, ptr, ptr] + conv_stop + conv_tier + [ptr]
  lib.vtc_conv_direct.restype = i32
  lib.vtc_conv_stop_words.argtypes = [i32, ctypes.c_int64]
  lib.vtc_conv_stop_words.restype = ctypes.c_int64
  lib.vtc_conv_tier_words.argtypes = [i32, i32, i32, i32]
  lib.vtc_conv_tier_words.restype = ctypes.c_int64
  lib.vtc_conv_tier_max_k.argtypes = []
  lib.vtc_conv_tier_max_k.restype = i32
  lib.vtc_conv_fista.argtypes = [
      ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, f32, i32, i32,
      i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr] + conv_stop + [
          ptr]
  lib.vtc_conv_fista.restype = i32
  lib.vtc_conv_train_chunk.argtypes = []
  lib.vtc_conv_train_chunk.restype = i32
  lib.vtc_conv_train_segment.argtypes = (
      [ptr] * 6 + [i32] * 8 + [f32, i32, f32, i32, f32] + [i32] * 5
      + [ptr] * 9 + conv_stop + conv_tier + [ptr])
  lib.vtc_conv_train_segment.restype = i32
  lib.vtc_conv_solve_stats.argtypes = (
      [ptr] * 4 + [i32] * 7 + [f32] + [i32] * 5 + [ptr] * 11 + conv_tier
      + [ptr])
  lib.vtc_conv_solve_stats.restype = i32
  lib.vtc_conv_dp_train_segment.argtypes = (
      [ptr] * 6 + [i32] * 8 + [f32, i32, f32, i32, f32] + [i32] * 6 + [f32]
      + [ptr] * 10 + [ptr] + conv_stop + [ptr, ptr] + conv_tier + [ptr])
  lib.vtc_conv_dp_train_segment.restype = i32
  lib.vtc_ica_train_segment.argtypes = (
      [ptr] * 6 + [i32, i32, i32, f32, i32, i32, i32, f32] + [ptr] * 8
      + [ptr])
  lib.vtc_ica_train_segment.restype = i32
  lib.vtc_ica_solve_stats.argtypes = (
      [ptr] * 6 + [i32, i32, i32, i32, f32] + [ptr] * 6 + [ptr])
  lib.vtc_ica_solve_stats.restype = i32
  lib.vtc_ica_dp_train_segment.argtypes = (
      [ptr] * 6 + [i32] * 3 + [f32] + [i32] * 3 + [f32, f32] + [ptr] * 8
      + [ptr, ptr])
  lib.vtc_ica_dp_train_segment.restype = i32
  lib.vtc_ica_segment_layout.argtypes = [i32p]
  lib.vtc_ica_segment_layout.restype = None
  for name in ("vtc_ica_segment_sm_count", "vtc_ica_segment_blocks_per_sm"):
    getattr(lib, name).argtypes = []
    getattr(lib, name).restype = i32
  lib.vtc_ica_segment_grid.argtypes = [i32, i32]
  lib.vtc_ica_segment_grid.restype = i32
  lib.vtc_ica_persistent_segment.argtypes = (
      [ptr] * 4 + [i32] * 3 + [f32] + [i32] * 3 + [f32, f32] + [ptr] * 7
      + [i32, ptr, ptr])
  lib.vtc_ica_persistent_segment.restype = i32
  lib.vtc_code_shard_split_k.argtypes = []
  lib.vtc_code_shard_split_k.restype = i32
  lib.vtc_code_shard_train_segment.argtypes = (
      [ptr] * 4 + [i32] * 5 + [ptr, i32, i32, ptr, f32, f32, i32, f32, i32,
                                f32] + [i32] * 5 + [f32] + [ptr] * 11
      + [i32, i32, ptr, ptr] + [i32, i32, ptr, ptr] + stop[:4]
      + [ptr, ptr] + [ptr])
  lib.vtc_code_shard_train_segment.restype = i32
  lib.vtc_code_shard_layout.argtypes = [i32p]
  lib.vtc_code_shard_layout.restype = None
  for name in ("vtc_code_shard_sm_count", "vtc_code_shard_blocks_per_sm"):
    getattr(lib, name).argtypes = []
    getattr(lib, name).restype = i32
  lib.vtc_code_shard_grid.argtypes = [i32, i32, i32]
  lib.vtc_code_shard_grid.restype = i32
  lib.vtc_code_shard_barriers.argtypes = [i32, i32, i32]
  lib.vtc_code_shard_barriers.restype = i32
  lib.vtc_code_shard_stop_words.argtypes = [i32, i32, i32]
  lib.vtc_code_shard_stop_words.restype = ctypes.c_int64
  return lib
