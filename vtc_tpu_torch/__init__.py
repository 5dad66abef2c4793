"""vtc_tpu_torch: the PyTorch/CUDA port of vtc_tpu for NVIDIA Hopper.

The JAX package ``vtc_tpu`` is the reference; every module here names
its counterpart by ``file:line`` and is held against it by the
``tests/test_torch_port_*.py`` suite.  This package imports ``torch``
and never ``jax``.  Host-side modules that import neither framework
(``vtc_tpu.data.dataset_generation``, ``vtc_tpu.utils.checkpoint``) are
shared, not copied.

Layout (mirrors vtc_tpu):
  ops/                 precision pins, thresholds, solver loop,
                       Lipschitz stepsize, the fused FISTA CUDA kernel
  csrc/                hand-written CUDA C++ kernels (built at first use)
  analysis_transforms/ code inference (fully-connected ISTA/FISTA)
  encode.py            chunked, stream-overlapped dataset encoding
  api.py               SparseCoder.encode / decode
  convert.py           vtc_tpu parameters and checkpoints -> tensors

Importing the package pins IEEE float32 matmuls (``ops/precision.py``).
"""
from vtc_tpu_torch.ops import precision as _precision  # noqa: F401

__version__ = "0.1.0"
