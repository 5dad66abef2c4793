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
                       Gram forms, the wrappers of the fused FISTA, fused
                       train step, fused group FISTA, fused group train
                       step and the two conv solve CUDA kernels
  csrc/                hand-written CUDA C++ kernels (built at first use)
  analysis_transforms/ code inference (fully-connected, subspace and
                       convolutional ISTA/FISTA)
  dict_update_rules/   fully-connected, subspace and conv updates
  training/            the per-batch trainer (fc, subspace, conv), the
                       scanned fc and subspace trainer, reset/prune
  utils/               checkpoints, the health check, dictionary figures
  data/                BatchIterator for SparseCoder.fit
  encode.py            chunked, stream-overlapped dataset encoding
  device.py            the entry points' default device (the card)
  api.py               SparseCoder.fit / encode / decode
  convert.py           vtc_tpu parameters, checkpoints and train state
                       -> tensors

Importing the package pins IEEE float32 matmuls (``ops/precision.py``).
"""
from vtc_tpu_torch.ops import precision as _precision  # noqa: F401

__version__ = "0.1.0"
