"""PCA dictionary computed in one shot, single-device: counterpart of
vtc_tpu/training/pca.py:1-76.

The principal directions come from ``torch.linalg.svd``: of the data
matrix itself when the dimensionality exceeds the sample count, otherwise
of the (smaller) covariance matrix.  Each ROW of the result is a principal
direction; as in vtc_tpu they are unique only up to the sign of each row.
"""
import numpy as np
import torch

from vtc_tpu_torch.device import resolve_device
from vtc_tpu_torch.ops.precision import matmul_precision
from vtc_tpu_torch.training import sparse_coding as sc


def train_dictionary(image_dataset, data_parallel=None, *, device=None):
  """Compute the PCA dictionary.

  Args:
    image_dataset: (D, n) float32 array or tensor, each column about mean
      zero.
    data_parallel: must be None (the sharded covariance waits for the
      multi-device slice, ROADMAP.md §1 item 9).
    device: where to compute; default the dataset's device when it is a
      tensor, else the CUDA device (raising without one).

  Returns:
    (n, n) float32 tensor whose rows are the principal directions.
  """
  if data_parallel is not None:
    raise NotImplementedError(
        "data_parallel waits for the multi-device slice, ROADMAP.md §1 "
        "item 9")
  device = resolve_device(device, image_dataset)
  data = sc.as_tensor(image_dataset, device)
  assert np.all(np.abs(sc._numpy(data.mean(dim=0))) < 1e-4), (
      "components must be (approximately) mean-zero")
  with matmul_precision():
    if data.shape[1] > data.shape[0]:
      u, _, _ = torch.linalg.svd(data.T, full_matrices=False)
    else:
      u, _, _ = torch.linalg.svd(data.T @ data / data.shape[0])
  return u.T.contiguous()
