"""High-throughput dataset encoding (the serving path): counterpart of
``encode_dataset`` (vtc_tpu/encode.py:96-249), fully-connected, subspace
and convolutional.

* The stepsize (top Gram eigenvalue; of the grouped dictionary's Gram
  with ``group_assignments``) is computed once per dictionary on the
  device and handed to every batch solve as a device tensor.
* The dataset is cut into ``batch_size`` batches, the tail padded with
  zero rows (zero codes, dropped at the end; vtc_tpu/encode.py:216-224),
  and walked in chunks of ``chunk_batches`` batches.
* On a CUDA device each batch solve is the fused FISTA kernel K1, with
  ``group_assignments`` the fused group FISTA kernel K4, and with
  ``mode='convolutional'`` the conv kernel K10 (``formulation=None``
  resolves to 'pallas' there and to 'gram' on the CPU, as JAX resolves it
  to 'pallas' on the TPU, encode.py:143-145; in conv mode only where
  K10's gate holds, else to 'gram', as JAX's geometry-aware default does,
  :146-159).
  The next chunk's host->device copy runs on a side stream from pinned
  memory while the current chunk computes, with an event before each
  use; results are drained one chunk behind (encode.py:226-246), their
  device->host copy overlapping the next chunk's compute.

  codes = encode_dataset(patches, dictionary, 0.008, 100)
  codes = encode_dataset(images, kernels, 0.05, 100, batch_size=40,
                         mode="convolutional", kernel_stride=(8, 8),
                         padding=((8, 8), (8, 8)))

The solves run on ``device``, by default the dictionary's device when it
is a tensor, else the CUDA device (``device="cpu"`` runs on the CPU).

With ``data_parallel`` (a ``parallel.Mesh``, or True for the default
process group's world), in every mode (vtc_tpu/encode.py:84-93,
:166-182): every rank calls with the same dataset, each batch is sharded
over the mesh (``batch_size`` must divide by its size), every rank solves
its shards through the same pipeline (K1, K4 or the conv route, K10 where
its gate holds, per shard on a CUDA device), and the codes are gathered,
so every rank returns all of them.

``mxu_precision`` runs vtc_tpu's tiers (bf16x5, bf16x3, 'default' or
'bf16') in fully-connected and subspace mode: the 'pallas' formulation
(K1, K4 on the card, their tier kernel) takes them, 'gram' and 'direct'
keep full precision, and with ``data_parallel`` every rank's shard
solves at the tier (vtc_tpu/encode.py:54-75).  Conv mode refuses a tier.
"""
import numpy as np
import torch

from vtc_tpu_torch.analysis_transforms.convolutional import (
    ista_fista as conv_ista_fista)
from vtc_tpu_torch.analysis_transforms.fully_connected import (
    ista_fista, subspace_ista_fista)
from vtc_tpu_torch import parallel
from vtc_tpu_torch.device import resolve_device
from vtc_tpu_torch.ops import conv_shapes, fused_conv_direct
from vtc_tpu_torch.ops import lipschitz as lipschitz_ops
from vtc_tpu_torch.ops.precision import resolve_tier


class _HostChunks:
  """CPU tensors: a chunk is a view of the host array, nothing overlaps."""

  def stage(self, slot, chunk):
    return torch.from_numpy(chunk)

  def compute(self, slot, staged, solve):
    return [solve(batch) for batch in staged]

  def drain(self, slot, codes, dest):
    for j, c in enumerate(codes):
      dest[j] = c.numpy()


class _CudaChunks:
  """Two slots of pinned host and device buffers.  Copies run on side
  streams and are ordered against the compute stream by events:

    copied[slot]   H2D into dev_in[slot] done  (compute waits; the host
                   waits before refilling pinned_in[slot])
    computed[slot] the solves that read dev_in[slot] done  (the next H2D
                   into that slot and the D2H of its codes wait)
  """

  def __init__(self, device, chunk_shape, code_shape):
    self.compute_stream = torch.cuda.current_stream(device)
    self.h2d_stream = torch.cuda.Stream(device)
    self.d2h_stream = torch.cuda.Stream(device)
    self.pinned_in = [torch.empty(chunk_shape, pin_memory=True)
                      for _ in range(2)]
    self.dev_in = [torch.empty(chunk_shape, device=device)
                   for _ in range(2)]
    self.pinned_out = [torch.empty(code_shape, pin_memory=True)
                       for _ in range(2)]
    self.copied = [torch.cuda.Event() for _ in range(2)]
    self.computed = [torch.cuda.Event() for _ in range(2)]
    self.drained = torch.cuda.Event()

  def stage(self, slot, chunk):
    k = len(chunk)
    self.copied[slot].synchronize()  # never refill a buffer mid-copy
    self.pinned_in[slot][:k].numpy()[...] = chunk
    self.h2d_stream.wait_event(self.computed[slot])
    with torch.cuda.stream(self.h2d_stream):
      self.dev_in[slot][:k].copy_(self.pinned_in[slot][:k],
                                  non_blocking=True)
    self.copied[slot].record(self.h2d_stream)
    return self.dev_in[slot][:k]

  def compute(self, slot, staged, solve):
    self.compute_stream.wait_event(self.copied[slot])
    codes = [solve(batch) for batch in staged]
    self.computed[slot].record(self.compute_stream)
    return codes

  def drain(self, slot, codes, dest):
    self.d2h_stream.wait_event(self.computed[slot])
    with torch.cuda.stream(self.d2h_stream):
      for j, c in enumerate(codes):
        self.pinned_out[slot][j].copy_(c, non_blocking=True)
    self.drained.record(self.d2h_stream)
    self.drained.synchronize()
    dest[...] = self.pinned_out[slot][:len(codes)].numpy()


def _check_scope(mode, mxu_precision):
  """The tier the solves run ('bf16' is 'default', vtc_tpu's encode.py
  :160-161), in every mode, with data parallelism or not."""
  if mode not in ("fully-connected", "convolutional"):
    raise ValueError("mode must be 'fully-connected' or 'convolutional'")
  return resolve_tier(mxu_precision)


def encode_dataset(data, dictionary, sparsity_weight, num_iters, *,
                   mode="fully-connected", batch_size=1024,
                   chunk_batches=8, variant="fista",
                   group_assignments=None, kernel_stride=None,
                   padding=None, nonnegative_only=False,
                   hard_threshold=False, formulation=None,
                   lipschitz_method="eigvalsh", data_parallel=None,
                   mxu_precision="highest", device=None):
  """Encode a full dataset into codes, batched and streamed.

  Args:
    data: host array, (D, n) flattened patches, or (D, c, H, W) padded
      images in convolutional mode.
    dictionary: (s, n) trained dictionary or (s, c, kh, kw) kernels
      (tensor or array).
    sparsity_weight, num_iters, variant: solver parameters.
    mode: 'fully-connected' or 'convolutional'.
    batch_size: rows (images) per solver call.
    chunk_batches: batches per host->device transfer unit; the device
      holds two input chunks (double buffering).
    group_assignments: list of index lists -> group-sparse inference
      (``subspace_ista_fista.run``; K4 on a CUDA device).
    kernel_stride, padding: conv-mode geometry, as the conv trainer's.
    data_parallel: optional ``parallel.Mesh`` (or True); each batch is
      sharded over its data axes and the codes are gathered (batch_size
      must divide by the mesh's size).
    nonnegative_only, hard_threshold: threshold variants
      (nonnegative_only is not defined for group-sparse inference).
    formulation: None -> 'pallas' (the CUDA kernel) on a CUDA device
      (conv: where K10's gate holds), 'gram' elsewhere; or force 'gram' /
      'direct' / 'pallas'.
    lipschitz_method: 'eigvalsh' (exact, default) or 'power'.
    mxu_precision: the solves' tier, 'highest', 'bf16x5', 'bf16x3' or
      'default'/'bf16', applied by the 'pallas' formulation (K1, K4, K10)
      as in vtc_tpu, on each rank's shards with data_parallel; the conv
      tiers need K10's geometry, and a conv formulation that resolves to
      'gram' (the CPU's default, or outside K10's gate) refuses a tier
      with ValueError, where vtc_tpu asserts.
    device: where to solve; defaults to the dictionary's device when it
      is a tensor, else the CUDA device (raising without one).

  Returns:
    (D, s) float32 numpy codes, or (D, s, sh, sw) in conv mode.
  """
  mxu_precision = _check_scope(mode, mxu_precision)
  if nonnegative_only and group_assignments is not None:
    raise ValueError(
        "nonnegative_only is not defined for group-sparse inference "
        "(the group prox shrinks norms, not signs)")
  device = resolve_device(device, dictionary)
  data = np.ascontiguousarray(data, dtype=np.float32)
  total = data.shape[0]
  if total == 0:
    raise ValueError("encode_dataset: empty dataset")
  batch_size, chunk_batches = int(batch_size), int(chunk_batches)
  mesh = None
  if data_parallel is not None:
    mesh = parallel.resolve_mesh(data_parallel)
    if batch_size % mesh.size != 0:
      raise ValueError("batch_size %d must divide by the DP size %d"
                       % (batch_size, mesh.size))
  dictionary = torch.as_tensor(dictionary, dtype=torch.float32,
                               device=device).contiguous()
  default_formulation = formulation is None
  if default_formulation:
    formulation = "pallas" if device.type == "cuda" else "gram"
  if mode == "convolutional":
    if kernel_stride is None:
      raise ValueError("mode='convolutional' needs kernel_stride")
    kernel_stride = tuple(int(x) for x in kernel_stride)
    padding = conv_shapes.normalize_padding(padding)
    if default_formulation and not fused_conv_direct.supported(
        (batch_size,) + data.shape[1:], dictionary.shape, kernel_stride):
      # geometry-aware default: outside K10's gate, 'gram'
      formulation = "gram"
    eta = lipschitz_ops.fista_stepsize(
        dictionary.reshape(dictionary.shape[0], -1), lipschitz_method)
    code_hw = conv_ista_fista.code_spatial_dims(
        data.shape, dictionary.shape, kernel_stride)

    def solve(batch):
      return conv_ista_fista.run(
          batch, dictionary, kernel_stride, padding, sparsity_weight,
          num_iters, variant=variant, nonnegative_only=nonnegative_only,
          hard_threshold=hard_threshold, stepsize=eta,
          formulation=formulation, mxu_precision=mxu_precision)
  elif group_assignments is None:
    code_hw = ()
    eta = lipschitz_ops.fista_stepsize(dictionary, lipschitz_method)

    def solve(batch):
      return ista_fista.run(
          batch, dictionary, sparsity_weight, num_iters, variant=variant,
          nonnegative_only=nonnegative_only, hard_threshold=hard_threshold,
          stepsize=eta, formulation=formulation,
          mxu_precision=mxu_precision)
  else:
    code_hw = ()
    groups = [[int(m) for m in g] for g in group_assignments]
    gather, mask, _ = subspace_ista_fista.group_layout(
        groups, dictionary.shape[0], device)
    eta = lipschitz_ops.fista_stepsize(
        subspace_ista_fista.build_grouped_dictionary(dictionary, gather,
                                                     mask),
        lipschitz_method)

    def solve(batch):
      return subspace_ista_fista.run(
          batch, dictionary, groups, sparsity_weight, num_iters,
          variant=variant, hard_threshold=hard_threshold, stepsize=eta,
          formulation=formulation, mxu_precision=mxu_precision)

  num_batches = -(-total // batch_size)
  padded = num_batches * batch_size
  if padded != total:
    data = np.concatenate(
        [data, np.zeros((padded - total,) + data.shape[1:], np.float32)])
  batches = data.reshape((num_batches, batch_size) + data.shape[1:])
  if mesh is not None:
    # this rank's shard of every batch goes through the pipeline below
    batches = np.ascontiguousarray(mesh.shard(batches, dim=1))
    batch_size = batches.shape[1]
  codes = np.empty((num_batches, batch_size, dictionary.shape[0]) + code_hw,
                   np.float32)
  if device.type == "cuda":
    chunks = _CudaChunks(device, (chunk_batches,) + batches.shape[1:],
                         (chunk_batches,) + codes.shape[1:])
  else:
    chunks = _HostChunks()

  staged = chunks.stage(0, batches[:chunk_batches])
  pending = None  # (slot, device codes, destination) of the last chunk
  for p, pos in enumerate(range(0, num_batches, chunk_batches)):
    slot = p % 2
    nxt = pos + chunk_batches
    out = chunks.compute(slot, staged, solve)
    if nxt < num_batches:
      # the next chunk's host->device copy overlaps this chunk's compute
      staged = chunks.stage(1 - slot, batches[nxt:nxt + chunk_batches])
    if pending is not None:
      # drain the previous chunk while this one computes
      chunks.drain(*pending)
    pending = (slot, out, codes[pos:nxt])
  chunks.drain(*pending)
  if mesh is not None:
    # every rank returns all the codes, the shards back in batch order
    codes = mesh.all_gather(torch.from_numpy(codes), dim=1).numpy()
  return codes.reshape((padded,) + codes.shape[2:])[:total]
