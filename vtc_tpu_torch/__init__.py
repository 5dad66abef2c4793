"""vtc_tpu_torch: the PyTorch/CUDA port of vtc_tpu for NVIDIA Hopper.

The JAX package ``vtc_tpu`` is the reference; every module here names
its counterpart by ``file:line`` and is held against it by the
``tests/test_torch_port_*.py`` suite.  This package imports ``torch``
and never ``jax``, nor anything of ``vtc_tpu``: the host-side modules it
needs (checkpoints, reset/prune, the health check, the dictionary
figures) are its own copies under ``utils/`` and ``training/``, and a
static test (tests/test_torch_port_host_layer.py) holds every module to
that.  Its entry points run on the CUDA device unless the caller names
another device (``device="cpu"``) or passes tensors that live elsewhere.

Layout (mirrors vtc_tpu):
  ops/                 precision pins, thresholds, solver loop,
                       Lipschitz stepsize, conv shapes, operators and
                       Gram forms, and the wrappers of the CUDA kernels:
                       fused FISTA (K1), fused train step (K2), fused
                       group FISTA (K4), fused group train step (K6), the
                       fused ICA train step (K8), the two conv solves
                       (K10, K11) and the fused conv train step (K12)
  csrc/                hand-written CUDA C++ kernels (built at first use)
  analysis_transforms/ code inference (fully-connected, subspace and
                       convolutional ISTA/FISTA; the exact inverse of a
                       square dictionary, invertible_linear)
  dict_update_rules/   fully-connected, subspace, ICA natural-gradient and
                       conv updates
  training/            the per-batch trainer (fc, subspace, conv), the
                       scanned trainer (fc, subspace, conv), the ICA
                       trainers (per batch and scanned), PCA, reset/prune
  utils/               checkpoints, the health check, dictionary figures
  data/                BatchIterator for the coders' fit
  encode.py            chunked, stream-overlapped dataset encoding
  device.py            the entry points' default device (the card)
  api.py               SparseCoder, ICACoder and PCACoder: fit / encode /
                       decode
  convert.py           vtc_tpu parameters, checkpoints and train state
                       (sparse-coding, ICA, PCA) -> tensors

Importing the package pins IEEE float32 matmuls (``ops/precision.py``).
"""
from vtc_tpu_torch.ops import precision as _precision  # noqa: F401

__version__ = "0.1.0"
