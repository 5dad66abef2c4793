"""The data-parallel mesh on ``torch.distributed``: counterpart of
vtc_tpu/parallel/mesh.py (``make_mesh`` :19, ``dp_axes`` :50).

vtc_tpu is single-controller: one process hands the global batch to a
``shard_map`` over a ``jax.sharding.Mesh``.  ``torch.distributed`` runs one
process per rank, so the port's ``Mesh`` is one rank's view of the same
thing: the axis names and sizes, this rank's position on the data axes, the
process group that spans them, and the collectives over it.  The contract a
caller sees is vtc_tpu's: every rank calls the same entry point with the
same global arrays and parameters, takes its own shard of the batch axis
(``Mesh.shard``: equal, contiguous shards in rank order, as
``PartitionSpec(axes)`` cuts them) and returns the replicated result.

* A mesh of one rank issues no collective and needs no process group:
  ``make_mesh()`` without an initialised default group, vtc_tpu's
  ``make_mesh()`` on one device.
* The sum is one ``all_reduce`` of the tensors packed into one buffer.
  Replicated state must stay bitwise equal across ranks
  (vtc_tpu/ops/pallas_collective.py:3-8); gloo's and NCCL's all-reduce
  hand every rank the same bytes, which tests/test_torch_port_parallel.py
  checks after several steps, so no fixed-order gather-sum is needed.
* With a ``gloo`` group CUDA tensors are staged through pinned host buffers
  explicitly (gloo's own CUDA support is not relied on); with ``nccl`` the
  device tensors are reduced, and CPU tensors are staged through the
  device.
* ``code > 1`` (dictionary rows over a 'code' axis, K19 across devices)
  raises NotImplementedError, ROADMAP.md §1 item 9.
"""
import torch
import torch.distributed as dist


def dp_axes(mesh) -> tuple:
  """The mesh axes data parallelism spans: ('data',) on a single slice,
  ('dcn', 'data') on a multi-slice mesh."""
  return ("dcn", "data") if "dcn" in mesh.axis_names else ("data",)


class Mesh:
  """One rank's view of a (data, code) or (dcn, data, code) mesh.

  Attributes:
    axis_names: ('data', 'code') or ('dcn', 'data', 'code').
    shape: {axis name: size}.
    size: ranks the data axes span (dcn * data).
    index: this rank's row-major position on the data axes, which is also
      the index of its batch shard.
    position: {axis name: this rank's coordinate}.
    group: the process group that spans the data axes (None on a mesh of
      one rank).
  """

  def __init__(self, data, dcn=1, code=1, group=None, index=0):
    if int(code) != 1:
      raise NotImplementedError(
          "a 'code' axis of size %d (dictionary rows sharded across "
          "devices, K19 across devices) waits, ROADMAP.md §1 item 9"
          % (code,))
    data, dcn = int(data), int(dcn)
    if data < 1 or dcn < 1:
      raise ValueError("mesh axes must be >= 1, got dcn=%d data=%d"
                       % (dcn, data))
    self.size = dcn * data
    if not 0 <= int(index) < self.size:
      raise ValueError("rank %d is outside a mesh of %d" % (index, self.size))
    if self.size > 1 and group is None:
      raise ValueError("a mesh of %d ranks needs a process group" % self.size)
    self.index = int(index)
    self.group = group if self.size > 1 else None
    if dcn == 1:
      self.axis_names = ("data", "code")
      self.shape = {"data": data, "code": 1}
      self.position = {"data": self.index, "code": 0}
    else:
      self.axis_names = ("dcn", "data", "code")
      self.shape = {"dcn": dcn, "data": data, "code": 1}
      self.position = {"dcn": self.index // data, "data": self.index % data,
                       "code": 0}
    self._pinned = {}

  def __repr__(self):
    return "Mesh(%s, rank %d of %d)" % (
        ", ".join("%s=%d" % (a, self.shape[a]) for a in self.axis_names),
        self.index, self.size)

  # -- the shard of a global array ----------------------------------------
  def shard_bounds(self, global_size):
    """[lo, hi) of this rank's shard of an axis of ``global_size``."""
    if global_size % self.size != 0:
      raise ValueError(
          "the sharded axis (%d) must divide by the data-parallel size %d"
          % (global_size, self.size))
    per = global_size // self.size
    return self.index * per, (self.index + 1) * per

  def shard(self, array, dim=0):
    """This rank's shard of ``array`` (a tensor or numpy array) along
    ``dim``: a view, the whole array on a mesh of one rank."""
    if self.size == 1:
      return array
    lo, hi = self.shard_bounds(array.shape[dim])
    return array[(slice(None),) * dim + (slice(lo, hi),)]

  # -- collectives over the data axes -------------------------------------
  def _backend(self):
    return dist.get_backend(self.group)

  def _pinned_buffer(self, numel, dtype):
    """A pinned host buffer of ``numel`` entries, kept per size and type."""
    buf = self._pinned.get((numel, dtype))
    if buf is None:
      buf = self._pinned[numel, dtype] = torch.empty(numel, dtype=dtype,
                                                     pin_memory=True)
    return buf

  def _all_reduce_flat(self, flat):
    """Sum the contiguous 1-d ``flat`` over the ranks, in place."""
    backend = self._backend()
    if backend == "nccl" and flat.device.type == "cpu":
      staged = flat.cuda()
      dist.all_reduce(staged, group=self.group)
      flat.copy_(staged)
    elif backend != "nccl" and flat.device.type == "cuda":
      host = self._pinned_buffer(flat.numel(), flat.dtype)
      host.copy_(flat, non_blocking=True)
      torch.cuda.current_stream(flat.device).synchronize()
      dist.all_reduce(host, group=self.group)
      flat.copy_(host, non_blocking=True)
    else:
      dist.all_reduce(flat, group=self.group)
    return flat

  def sum(self, *tensors):
    """The sum over the ranks of each tensor (of one type and device), as
    new tensors: one all-reduce of them packed into one buffer.  Every
    rank receives the same bytes.  A mesh of one rank returns its
    arguments."""
    if self.size == 1:
      return tensors if len(tensors) != 1 else tensors[0]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    self._all_reduce_flat(flat)
    out, at = [], 0
    for t in tensors:
      out.append(flat[at:at + t.numel()].reshape(t.shape))
      at += t.numel()
    return tuple(out) if len(out) != 1 else out[0]

  def sum_(self, flat):
    """Sum the contiguous 1-d tensor ``flat`` over the ranks in place, in
    its device's stream order, and return it: the one all-reduce of
    ``sum`` without the packing.  A mesh of one rank leaves it as it is."""
    if self.size > 1:
      self._all_reduce_flat(flat)
    return flat

  def mean(self, tensor):
    """The mean over the ranks of a tensor (one all-reduce)."""
    if self.size == 1:
      return tensor
    return self.sum(tensor) / self.size

  def all_gather(self, tensor, dim=0):
    """The ranks' equal-shaped tensors concatenated along ``dim`` in rank
    order, on ``tensor``'s device; every rank receives all of them."""
    if self.size == 1:
      return tensor
    backend = self._backend()
    local = tensor.contiguous()
    if backend == "nccl" and local.device.type == "cpu":
      local = local.cuda()
    elif backend != "nccl" and local.device.type == "cuda":
      local = local.cpu()
    parts = [torch.empty_like(local) for _ in range(self.size)]
    dist.all_gather(parts, local, group=self.group)
    return torch.cat(parts, dim=dim).to(tensor.device)

  def broadcast_object(self, obj):
    """Rank 0's ``obj`` (anything picklable) on every rank: for host-side
    decisions that draw random numbers, which must not differ by rank."""
    if self.size == 1:
      return obj
    box = [obj]
    src = dist.get_global_rank(self.group, 0)
    if self._backend() == "nccl":
      dist.broadcast_object_list(box, src=src, group=self.group,
                                 device=torch.device("cuda"))
    else:
      dist.broadcast_object_list(box, src=src, group=self.group)
    return box[0]


def make_mesh(data: int = None, code: int = 1, dcn: int = 1,
              group=None) -> Mesh:
  """Build this rank's (data, code) or (dcn, data, code) mesh.

  Args:
    data: size of the batch-sharding axis; defaults to the process group's
      world size over ``code * dcn`` (1 without an initialised group).
    code: size of the dictionary-row-sharding axis; only 1 runs (a larger
      one raises NotImplementedError, ROADMAP.md §1 item 9).
    dcn: number of slices of a multi-slice deployment (1: the mesh has no
      'dcn' axis).  Ranks are taken slice by slice: rank r sits at
      (r // data, r % data).
    group: the process group the data axes span; default the default
      group.  vtc_tpu's ``devices`` argument has no counterpart: a process
      group fixes its ranks.

  Returns:
    The ``Mesh``.  ``dcn * data`` must be the group's world size, or 1 (a
    mesh of one rank, which issues no collective and needs no group).
  """
  if int(code) != 1:
    return Mesh(data or 1, dcn, code)  # raises, naming item 9
  initialised = dist.is_available() and dist.is_initialized()
  world = dist.get_world_size(group) if initialised else 1
  if data is None:
    if world % int(dcn) != 0:
      raise ValueError("a world of %d does not divide by dcn=%d"
                       % (world, dcn))
    data = world // int(dcn)
  size = int(dcn) * int(data)
  if size == 1:
    return Mesh(1, 1)
  if size != world:
    raise ValueError(
        "mesh %dx%d needs a process group of %d ranks, the group has %d"
        % (dcn, data, size, world))
  if group is None:
    group = dist.group.WORLD
  return Mesh(data, dcn, group=group, index=dist.get_rank(group))


def resolve_mesh(data_parallel):
  """The ``Mesh`` of an entry point's ``data_parallel`` argument: a
  ``Mesh`` itself, or ``make_mesh()`` for True (the default group's world,
  or one rank without a group), as vtc_tpu takes a Mesh or True."""
  if isinstance(data_parallel, Mesh):
    return data_parallel
  if data_parallel is True:
    return make_mesh()
  raise TypeError("data_parallel must be True or a vtc_tpu_torch.parallel."
                  "Mesh, got %r" % (data_parallel,))
