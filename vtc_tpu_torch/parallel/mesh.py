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
* A 'code' axis above 1 shards dictionary rows (K19 across devices, the
  code-sharded trainer): rank r sits at code position r % code and
  data-axes position r // code, vtc_tpu's row-major device grid.  The
  mesh then holds two subgroups: the data group (the ranks at this rank's
  code position: ``sum``, ``sum_``, ``mean``, ``all_gather``) and the code
  group (the ranks at this rank's data-axes position: ``sum_code_``,
  ``all_gather_code``).  ``shard`` cuts the batch over the data axes,
  ``code_shard`` the rows over 'code'.
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
    code_size, code_index: the 'code' axis's size and this rank's position
      on it, which is the index of its shard of the dictionary rows.
    rank: this rank's row-major position on the whole mesh,
      index * code_size + code_index (rank 0 writes checkpoints).
    position: {axis name: this rank's coordinate}.
    group: the process group of the data axes, the ranks at this rank's
      code position (None when the data axes have one rank).
    code_group: the process group of the 'code' axis, the ranks at this
      rank's data-axes position (None when it has one rank).
    world_group: the group of the whole mesh (None on a mesh of one rank).
  """

  def __init__(self, data, dcn=1, code=1, group=None, index=0, *,
               code_group=None, code_index=0, world_group=None):
    data, dcn, code = int(data), int(dcn), int(code)
    if data < 1 or dcn < 1 or code < 1:
      raise ValueError("mesh axes must be >= 1, got dcn=%d data=%d code=%d"
                       % (dcn, data, code))
    self.size = dcn * data
    if not 0 <= int(index) < self.size:
      raise ValueError("rank %d is outside a mesh of %d" % (index, self.size))
    if not 0 <= int(code_index) < code:
      raise ValueError("code position %d is outside a 'code' axis of %d"
                       % (code_index, code))
    if self.size > 1 and group is None:
      raise ValueError("a mesh of %d ranks needs a process group" % self.size)
    if code > 1 and code_group is None:
      raise ValueError("a 'code' axis of %d ranks needs a process group"
                       % code)
    if self.size > 1 and code > 1 and world_group is None:
      raise ValueError("a mesh with both the data axes (%d) and 'code' (%d) "
                       "above 1 needs the process group of the whole mesh"
                       % (self.size, code))
    self.index = int(index)
    self.code_size = code
    self.code_index = int(code_index)
    self.rank = self.index * code + self.code_index
    self.group = group if self.size > 1 else None
    self.code_group = code_group if code > 1 else None
    if self.size * code == 1:
      self.world_group = None
    elif world_group is not None:
      self.world_group = world_group
    else:  # one axis above 1: its group spans the mesh
      self.world_group = self.group if code == 1 else self.code_group
    if dcn == 1:
      self.axis_names = ("data", "code")
      self.shape = {"data": data, "code": code}
      self.position = {"data": self.index, "code": self.code_index}
    else:
      self.axis_names = ("dcn", "data", "code")
      self.shape = {"dcn": dcn, "data": data, "code": code}
      self.position = {"dcn": self.index // data, "data": self.index % data,
                       "code": self.code_index}
    self._pinned = {}

  def __repr__(self):
    return "Mesh(%s, rank %d of %d)" % (
        ", ".join("%s=%d" % (a, self.shape[a]) for a in self.axis_names),
        self.rank, self.size * self.code_size)

  # -- the shard of a global array ----------------------------------------
  @staticmethod
  def _bounds(global_size, parts, at, what):
    if global_size % parts != 0:
      raise ValueError("the sharded axis (%d) must divide by the %s size %d"
                       % (global_size, what, parts))
    per = global_size // parts
    return at * per, (at + 1) * per

  def shard_bounds(self, global_size):
    """[lo, hi) of this rank's shard of an axis of ``global_size``."""
    return self._bounds(global_size, self.size, self.index, "data-parallel")

  def shard(self, array, dim=0):
    """This rank's shard of ``array`` (a tensor or numpy array) along
    ``dim`` over the data axes: a view, the whole array when they have one
    rank."""
    if self.size == 1:
      return array
    lo, hi = self.shard_bounds(array.shape[dim])
    return array[(slice(None),) * dim + (slice(lo, hi),)]

  def code_shard_bounds(self, global_size):
    """[lo, hi) of this rank's shard of an axis sharded over 'code'."""
    return self._bounds(global_size, self.code_size, self.code_index, "'code'")

  def code_shard(self, array, dim=0):
    """This rank's shard of ``array`` along ``dim`` over the 'code' axis
    (dictionary rows, the Hessian EMA): a view, the whole array when the
    axis has one rank."""
    if self.code_size == 1:
      return array
    lo, hi = self.code_shard_bounds(array.shape[dim])
    return array[(slice(None),) * dim + (slice(lo, hi),)]

  # -- collectives ---------------------------------------------------------
  def _pinned_buffer(self, numel, dtype):
    """A pinned host buffer of ``numel`` entries, kept per size and type."""
    buf = self._pinned.get((numel, dtype))
    if buf is None:
      buf = self._pinned[numel, dtype] = torch.empty(numel, dtype=dtype,
                                                     pin_memory=True)
    return buf

  def _all_reduce_flat(self, flat, group):
    """Sum the contiguous 1-d ``flat`` over ``group``, in place."""
    backend = dist.get_backend(group)
    if backend == "nccl" and flat.device.type == "cpu":
      staged = flat.cuda()
      dist.all_reduce(staged, group=group)
      flat.copy_(staged)
    elif backend != "nccl" and flat.device.type == "cuda":
      host = self._pinned_buffer(flat.numel(), flat.dtype)
      host.copy_(flat, non_blocking=True)
      torch.cuda.current_stream(flat.device).synchronize()
      dist.all_reduce(host, group=group)
      flat.copy_(host, non_blocking=True)
    else:
      dist.all_reduce(flat, group=group)
    return flat

  def _all_gather(self, tensor, dim, group, parts):
    """The equal-shaped tensors of ``group``'s ``parts`` ranks concatenated
    along ``dim`` in their order, on ``tensor``'s device."""
    backend = dist.get_backend(group)
    local = tensor.contiguous()
    if backend == "nccl" and local.device.type == "cpu":
      local = local.cuda()
    elif backend != "nccl" and local.device.type == "cuda":
      local = local.cpu()
    gathered = [torch.empty_like(local) for _ in range(parts)]
    dist.all_gather(gathered, local, group=group)
    return torch.cat(gathered, dim=dim).to(tensor.device)

  def sum(self, *tensors):
    """The sum over the data axes of each tensor (of one type and device),
    as new tensors: one all-reduce of them packed into one buffer.  Every
    rank receives the same bytes.  With one rank on the data axes it
    returns its arguments."""
    if self.size == 1:
      return tensors if len(tensors) != 1 else tensors[0]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    self._all_reduce_flat(flat, self.group)
    out, at = [], 0
    for t in tensors:
      out.append(flat[at:at + t.numel()].reshape(t.shape))
      at += t.numel()
    return tuple(out) if len(out) != 1 else out[0]

  def sum_(self, flat):
    """Sum the contiguous 1-d tensor ``flat`` over the data axes in place,
    in its device's stream order, and return it: the one all-reduce of
    ``sum`` without the packing.  With one rank there it is left as it
    is."""
    if self.size > 1:
      self._all_reduce_flat(flat, self.group)
    return flat

  def sum_code_(self, flat):
    """``sum_`` over the 'code' axis: the partial products of the row
    shards (a reconstruction, the n x n Gram) summed in place."""
    if self.code_size > 1:
      self._all_reduce_flat(flat, self.code_group)
    return flat

  def mean(self, tensor):
    """The mean over the data axes of a tensor (one all-reduce)."""
    if self.size == 1:
      return tensor
    return self.sum(tensor) / self.size

  def all_gather(self, tensor, dim=0):
    """The equal-shaped tensors of the ranks on the data axes concatenated
    along ``dim`` in rank order, on ``tensor``'s device; every rank
    receives all of them."""
    if self.size == 1:
      return tensor
    return self._all_gather(tensor, dim, self.group, self.size)

  def all_gather_code(self, tensor, dim=0):
    """``all_gather`` over the 'code' axis: the row shards assembled in
    code order."""
    if self.code_size == 1:
      return tensor
    return self._all_gather(tensor, dim, self.code_group, self.code_size)

  def broadcast_object(self, obj):
    """Mesh rank 0's ``obj`` (anything picklable) on every rank of the
    mesh: for host-side decisions that draw random numbers, which must not
    differ by rank."""
    if self.world_group is None:
      return obj
    box = [obj]
    src = dist.get_global_rank(self.world_group, 0)
    if dist.get_backend(self.world_group) == "nccl":
      dist.broadcast_object_list(box, src=src, group=self.world_group,
                                 device=torch.device("cuda"))
    else:
      dist.broadcast_object_list(box, src=src, group=self.world_group)
    return box[0]


def make_mesh(data: int = None, code: int = 1, dcn: int = 1,
              group=None) -> Mesh:
  """Build this rank's (data, code) or (dcn, data, code) mesh.

  Every rank of the group must call it, together and with the same
  arguments.  With the data axes and a 'code' axis both above 1 it creates
  the data and code subgroups, and ``torch.distributed.new_group`` must be
  called by every process of the default group, in the same order: such a
  mesh spans the default group.

  Args:
    data: size of the batch-sharding axis; defaults to the process group's
      world size over ``code * dcn`` (1 without an initialised group).
    code: size of the dictionary-row-sharding axis.
    dcn: number of slices of a multi-slice deployment (1: the mesh has no
      'dcn' axis).
    group: the process group the mesh spans; default the default group,
      which is the only group a mesh with both axes above 1 may span.
      vtc_tpu's ``devices`` argument has no counterpart: a process group
      fixes its ranks.

  Ranks are laid out row-major, as vtc_tpu reshapes its devices to
  (data, code) or (dcn, data, code): rank r of the group sits at code
  position r % code and data-axes position r // code (slice
  r // (code * data)).

  Returns:
    The ``Mesh``.  ``dcn * data * code`` must be the group's world size, or
    1 (a mesh of one rank, which issues no collective and needs no group).
  """
  code, dcn = int(code), int(dcn)
  initialised = dist.is_available() and dist.is_initialized()
  world = dist.get_world_size(group) if initialised else 1
  if data is None:
    if world % (dcn * code) != 0:
      raise ValueError("a mesh with dcn=%d x code=%d needs a process group "
                       "whose world divides by it, the world is %d"
                       % (dcn, code, world))
    data = world // (dcn * code)
  data = int(data)
  total = dcn * data * code
  if total == 1:
    return Mesh(1, 1)
  if total != world:
    raise ValueError(
        "mesh %dx%dx%d needs a process group of %d ranks, the group has %d"
        % (dcn, data, code, total, world))
  if group is None:
    group = dist.group.WORLD
  rank = dist.get_rank(group)
  index, code_index = rank // code, rank % code
  if code == 1:
    return Mesh(data, dcn, group=group, index=index)
  size = dcn * data
  if size == 1:
    return Mesh(data, dcn, code, code_group=group, code_index=code_index,
                world_group=group)
  if world != dist.get_world_size():
    raise ValueError(
        "a mesh with data %d x code %d creates subgroups, which every "
        "process of the default group must enter: it must span the default "
        "group, not a subgroup of it" % (size, code))
  # every rank creates every subgroup, in one order: first the data groups
  # (one per code position), then the code groups (one per data position)
  members = lambda ranks: [dist.get_global_rank(group, r) for r in ranks]
  data_groups = [dist.new_group(members(range(c, total, code)))
                 for c in range(code)]
  code_groups = [dist.new_group(members(range(i * code, (i + 1) * code)))
                 for i in range(size)]
  return Mesh(data, dcn, code, group=data_groups[code_index], index=index,
              code_group=code_groups[index], code_index=code_index,
              world_group=group)


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
