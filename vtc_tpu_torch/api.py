"""Estimator-style convenience API: counterpart of ``SparseCoder``,
``ICACoder`` and ``PCACoder`` (vtc_tpu/api.py:21-167): ``fit``, ``encode``
and ``decode``.

  coder = SparseCoder(num_atoms=256, sparsity_weight=0.008,
                      formulation="pallas")             # on the card
  coder.fit(patches, num_epochs=5)                 # or set .dictionary,
  codes = coder.encode(patches, batch_size=2048)   # e.g. from convert
  recon = coder.decode(codes)                      # tensor (D, n)

``fit`` trains through the port's ``training.sparse_coding.
train_dictionary``, one step per batch of a shuffling ``BatchIterator``;
with formulation='pallas' on a CUDA device every solve runs K1's kernel.
``ICACoder.fit`` runs the per-batch ICA trainer (training/ica) and
encodes with the exact linear solve; ``PCACoder.fit`` centres the patches
and takes the principal directions of training/pca.  Each coder runs on
``device``, by default the CUDA device (raising without one);
``device="cpu"`` runs it on the CPU.
"""
import numpy as np
import torch

from vtc_tpu_torch.device import resolve_device
from vtc_tpu_torch.ops.precision import matmul_precision


class SparseCoder:
  """Fully-connected sparse coding inference with a given dictionary."""

  def __init__(self, num_atoms, sparsity_weight=0.01,
               inference_algorithm="fista", inference_iters=50,
               update_algorithm="sc_cheap_quadratic_descent",
               update_stepsize=0.1, formulation="gram", seed=0,
               device=None):
    self.num_atoms = int(num_atoms)
    self.sparsity_weight = float(sparsity_weight)
    self.inference_algorithm = inference_algorithm
    self.inference_iters = int(inference_iters)
    self.update_algorithm = update_algorithm
    self.update_stepsize = float(update_stepsize)
    self.formulation = formulation
    self.seed = seed
    self.device = resolve_device(device)
    self.dictionary = None

  def fit(self, patches, num_epochs=5, batch_size=250, **extra_params):
    """Learn the dictionary from (D, n) flattened patches.  The initial
    dictionary is vtc_tpu's: unit-norm rows of RandomState(seed).randn."""
    from vtc_tpu_torch.data.dataset_generation import BatchIterator
    from vtc_tpu_torch.training.sparse_coding import train_dictionary

    patches = np.asarray(patches, np.float32)
    rng = np.random.RandomState(self.seed)
    if self.dictionary is None:
      d0 = rng.randn(self.num_atoms, patches.shape[1]).astype(np.float32)
      d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    else:
      d0 = self.dictionary
    params = {
        "mode": "fully-connected",
        "num_epochs": int(num_epochs),
        "code_inference_algorithm": self.inference_algorithm,
        "inference_param_schedule": {
            0: {"sparsity_weight": self.sparsity_weight,
                "num_iters": self.inference_iters}},
        "dictionary_update_algorithm": self.update_algorithm,
        "dict_update_param_schedule": {
            0: {"stepsize": self.update_stepsize, "num_iters": 1}},
        "fc_formulation": self.formulation,
        "stdout_print_interval": 10**9,
    }
    params.update(extra_params)
    val = patches[:min(len(patches), 4 * batch_size)]
    self.dictionary = train_dictionary(
        BatchIterator(patches, batch_size, seed=self.seed),
        BatchIterator(val, min(len(val), 4 * batch_size),
                      shuffle=False, drop_last=False),
        d0, params, device=self.device)
    return self

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


class ICACoder:
  """Square ICA dictionary: fit by natural gradient, exact codes."""

  def __init__(self, stepsize=0.01, seed=0, device=None):
    self.stepsize = float(stepsize)
    self.seed = seed
    self.device = resolve_device(device)
    self.dictionary = None

  def fit(self, patches, num_epochs=5, batch_size=250, **extra_params):
    """Learn the (n, n) dictionary from (D, n) patches, starting from
    vtc_tpu's initial dictionary: the Q of RandomState(seed)'s Gaussian
    (n, n) matrix."""
    from vtc_tpu_torch.data.dataset_generation import BatchIterator
    from vtc_tpu_torch.training.ica import train_dictionary

    patches = np.asarray(patches, np.float32)
    n = patches.shape[1]
    if self.dictionary is None:
      rng = np.random.RandomState(self.seed)
      d0 = np.linalg.qr(rng.standard_normal((n, n)))[0].astype(np.float32)
    else:
      d0 = self.dictionary
    params = {
        "num_epochs": int(num_epochs),
        "dictionary_update_algorithm": "ica_natural_gradient",
        "dict_update_param_schedule": {
            0: {"stepsize": self.stepsize, "num_iters": 1}},
        "stdout_print_interval": 10**9,
    }
    params.update(extra_params)
    self.dictionary = train_dictionary(
        BatchIterator(patches, batch_size, seed=self.seed), d0, params,
        device=self.device)
    return self

  def encode(self, patches):
    """(D, n) patches -> (D, n) codes, a tensor on the device."""
    from vtc_tpu_torch.analysis_transforms.fully_connected import (
        invertible_linear)
    return invertible_linear.run(
        torch.as_tensor(np.asarray(patches, np.float32), device=self.device),
        torch.as_tensor(self.dictionary, dtype=torch.float32,
                        device=self.device))

  def decode(self, codes):
    """(D, n) codes -> (D, n) reconstructions, a tensor on the device."""
    dictionary = torch.as_tensor(self.dictionary, dtype=torch.float32,
                                 device=self.device)
    codes = torch.as_tensor(codes, dtype=torch.float32, device=self.device)
    with matmul_precision():
      return codes @ dictionary


class PCACoder:
  """PCA dictionary with optional dimensionality truncation."""

  def __init__(self, num_components=None, device=None):
    self.num_components = num_components
    self.device = resolve_device(device)
    self.dictionary = None
    self.component_means = None

  def fit(self, patches):
    """Centre (D, n) patches and keep the first ``num_components``
    principal directions (all n by default) as the rows of
    ``dictionary``; ``component_means`` is an (n,) tensor."""
    from vtc_tpu_torch.training.pca import train_dictionary

    patches = torch.as_tensor(np.asarray(patches, np.float32),
                              device=self.device)
    self.component_means = patches.mean(dim=0)
    full = train_dictionary(patches - self.component_means,
                            device=self.device)
    self.dictionary = full[:self.num_components or full.shape[0]]
    return self

  def encode(self, patches):
    """(D, n) patches -> (D, k) coefficients, a tensor on the device."""
    centered = torch.as_tensor(np.asarray(patches, np.float32),
                               device=self.device) - self.component_means
    with matmul_precision():
      return centered @ self.dictionary.T

  def decode(self, codes):
    """(D, k) coefficients -> (D, n) reconstructions, on the device."""
    codes = torch.as_tensor(codes, dtype=torch.float32, device=self.device)
    with matmul_precision():
      return codes @ self.dictionary + self.component_means
