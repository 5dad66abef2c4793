"""Estimator-style convenience API: counterpart of ``SparseCoder``
(vtc_tpu/api.py:21-100), its ``encode`` and ``decode``.

``fit`` waits for the trainer slice.  Until then the dictionary is set
from a vtc_tpu checkpoint or array through ``convert``:

  coder = SparseCoder(num_atoms=256, sparsity_weight=0.008,
                      formulation="pallas", device="cuda")
  coder.dictionary = convert.load_dictionary(path, "cuda")
  codes = coder.encode(patches, batch_size=2048)   # numpy (D, s)
  recon = coder.decode(codes)                      # tensor (D, n)
"""
import numpy as np
import torch

from vtc_tpu_torch.ops.precision import matmul_precision


class SparseCoder:
  """Fully-connected sparse coding inference with a given dictionary."""

  def __init__(self, num_atoms, sparsity_weight=0.01,
               inference_algorithm="fista", inference_iters=50,
               update_algorithm="sc_cheap_quadratic_descent",
               update_stepsize=0.1, formulation="gram", seed=0,
               device="cpu"):
    self.num_atoms = int(num_atoms)
    self.sparsity_weight = float(sparsity_weight)
    self.inference_algorithm = inference_algorithm
    self.inference_iters = int(inference_iters)
    self.update_algorithm = update_algorithm
    self.update_stepsize = float(update_stepsize)
    self.formulation = formulation
    self.seed = seed
    self.device = torch.device(device)
    self.dictionary = None

  def fit(self, patches, num_epochs=5, batch_size=250, **extra_params):
    raise NotImplementedError(
        "SparseCoder.fit waits for the trainer slice, ROADMAP.md §1 item 2;"
        " set .dictionary with vtc_tpu_torch.convert instead")

  def _require_dictionary(self):
    if self.dictionary is None:
      raise ValueError("no dictionary: set .dictionary first")

  def encode(self, patches, num_iters=None, batch_size=None, **kwargs):
    """(D, n) patches -> (D, s) sparse codes.

    With ``batch_size`` set, encoding runs through the batched and
    streamed serving path (vtc_tpu_torch.encode.encode_dataset) and
    returns numpy; otherwise one ``ista_fista.run`` call returns a tensor
    on the coder's device."""
    from vtc_tpu_torch.analysis_transforms.fully_connected import (
        ista_fista)
    self._require_dictionary()
    variant = ("fista" if self.inference_algorithm == "fista"
               else "ista")
    iters = self.inference_iters if num_iters is None else num_iters
    dictionary = torch.as_tensor(self.dictionary, dtype=torch.float32,
                                 device=self.device)
    if batch_size is not None:
      from vtc_tpu_torch.encode import encode_dataset
      return encode_dataset(
          np.asarray(patches, np.float32), dictionary,
          self.sparsity_weight, iters, batch_size=int(batch_size),
          variant=variant, formulation=self.formulation,
          device=self.device, **kwargs)
    return ista_fista.run(
        torch.as_tensor(np.asarray(patches, np.float32),
                        device=self.device),
        dictionary, self.sparsity_weight, iters, variant=variant,
        formulation=self.formulation, **kwargs)

  def decode(self, codes):
    """(D, s) codes -> (D, n) reconstructions, a tensor on the device."""
    self._require_dictionary()
    dictionary = torch.as_tensor(self.dictionary, dtype=torch.float32,
                                 device=self.device)
    codes = torch.as_tensor(codes, dtype=torch.float32, device=self.device)
    with matmul_precision():
      return codes @ dictionary
