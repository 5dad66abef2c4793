"""vtc_tpu_torch: the PyTorch/CUDA port of vtc_tpu for NVIDIA Hopper.

The JAX package ``vtc_tpu`` is the reference; every module here names
its counterpart by ``file:line`` and is held against it by the
``tests/test_torch_port_*.py`` suite.  This package imports ``torch``
and never ``jax``.  Host-side modules that import neither framework
(``vtc_tpu.utils.checkpoint``, ``vtc_tpu.training.reset_prune``) are
shared, not copied, and imported only where they are used.

Layout (mirrors vtc_tpu):
  ops/                 precision pins, thresholds, solver loop,
                       Lipschitz stepsize, the wrappers of the fused
                       FISTA, fused train step, fused group FISTA and
                       fused group train step CUDA kernels
  csrc/                hand-written CUDA C++ kernels (built at first use)
  analysis_transforms/ code inference (fully-connected and subspace
                       ISTA/FISTA)
  dict_update_rules/   fully-connected and subspace dictionary updates
  training/            the per-batch and the scanned fc and subspace
                       trainers
  data/                BatchIterator for SparseCoder.fit
  encode.py            chunked, stream-overlapped dataset encoding
  api.py               SparseCoder.fit / encode / decode
  convert.py           vtc_tpu parameters, checkpoints and train state
                       -> tensors

Importing the package pins IEEE float32 matmuls (``ops/precision.py``).
"""
from vtc_tpu_torch.ops import precision as _precision  # noqa: F401

__version__ = "0.1.0"
