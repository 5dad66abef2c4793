"""PCA dictionary computed in one shot: counterpart of
vtc_tpu/training/pca.py:1-76.

The principal directions come from ``torch.linalg.svd``: of the data
matrix itself when the dimensionality exceeds the sample count, otherwise
of the (smaller) covariance matrix.  Each ROW of the result is a principal
direction; as in vtc_tpu they are unique only up to the sign of each row.
With ``data_parallel`` the covariance is the sum over the ranks of each
shard's X^T X (one all-reduce) and the SVD runs replicated.
"""
import numpy as np
import torch

from vtc_tpu_torch import parallel
from vtc_tpu_torch.device import resolve_device
from vtc_tpu_torch.ops.precision import matmul_precision
from vtc_tpu_torch.training import sparse_coding as sc


def train_dictionary(image_dataset, data_parallel=None, *, device=None):
  """Compute the PCA dictionary.

  Args:
    image_dataset: (D, n) float32 array or tensor, each column about mean
      zero; with ``data_parallel`` the same global dataset on every rank.
    data_parallel: optional ``parallel.Mesh`` (or True for the default
      process group's world): the sample axis is sharded over the mesh, the
      (n, n) covariance is one sum of the shards' X^T X, and the SVD runs
      replicated.  D must divide by the mesh's size.  The n > D branch
      stays single-device, as in vtc_tpu (:63): its SVD of the data matrix
      has no batch-sharded form.
    device: where to compute; default the dataset's device when it is a
      tensor, else the CUDA device (raising without one).

  Returns:
    (n, n) float32 tensor whose rows are the principal directions.
  """
  device = resolve_device(device, image_dataset)
  num, n = np.shape(image_dataset)
  if data_parallel is not None and n <= num:
    mesh = parallel.resolve_mesh(data_parallel)
    mean = (image_dataset.mean(dim=0) if isinstance(image_dataset,
                                                    torch.Tensor)
            else np.asarray(image_dataset, np.float32).mean(axis=0))
    assert np.all(np.abs(sc._numpy(mean)) < 1e-4), (
        "components must be (approximately) mean-zero")
    shard = sc.as_tensor(mesh.shard(image_dataset), device)
    with matmul_precision():
      covar = mesh.sum(shard.T @ shard) / num
      u, _, _ = torch.linalg.svd(covar)
    return u.T.contiguous()
  data = sc.as_tensor(image_dataset, device)
  assert np.all(np.abs(sc._numpy(data.mean(dim=0))) < 1e-4), (
      "components must be (approximately) mean-zero")
  with matmul_precision():
    if data.shape[1] > data.shape[0]:
      u, _, _ = torch.linalg.svd(data.T, full_matrices=False)
    else:
      u, _, _ = torch.linalg.svd(data.T @ data / data.shape[0])
  return u.T.contiguous()
