"""The host hooks of the whole-segment multi-rank kernels K15, K16, K17,
K18 and K19 across devices: the port's stand-in for vtc_tpu's in-kernel
remote-DMA all-reduce K14 (vtc_tpu/ops/pallas_collective.py:31-185).

Each of those kernels is one C loop per segment that calls back into
Python once per step, between the step's statistics and its update
(csrc/train_core.cuh, ``SumHook``).  ``SumHook(mesh, packed)`` is that
callback: on a mesh of more than one rank it sums the packed device buffer
over the ranks in place with ``parallel.Mesh.sum_`` (one all-reduce, in
the stream's order); on a mesh of one rank ``pointer`` is None and the C
loop runs with no host work per step.  An error raised in the callback
cannot cross the C frame, so the callback keeps it and returns 1, the loop
returns ``FAILED``, and ``check`` raises the kept error: nothing is caught
and carried on.

``StopHook(mesh, local)`` is the early stop's hook of K17 at a world
above one (and of K15 and K16 when they take the stop): the C loop calls
it once per solver iteration, after the analysis launch has left the
rank's sum of |codes - old| in the one-float device buffer ``local``, and
it sums that buffer over the ranks with ``Mesh.sum_`` (the same bits on
every rank, so every rank takes the same decision), vtc_tpu's one slot
all-reduce an iteration (pallas_conv_dp_train.py:190-213).

``AxisSumHook(sums)`` is the hook of K19 across devices, which sums
several buffers, each over its own axis, in one step:
``int hook(int step, int which)`` (csrc/train_core.cuh,
``AxisSumHook``) calls ``sums[which] = (sum_, buffer)`` as
``sum_(buffer)``, for example ``mesh.sum_code_`` of the reconstruction or
``mesh.sum_`` of the gradient.
"""
import ctypes

FAILED = -1  # kSumHookFailed of csrc/train_core.cuh
_HOOK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int)  # int hook(int step)
# int hook(int step, int which)
_AXIS_HOOK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_int)


class SumHook:
  """The per-step sum of ``packed`` over ``mesh``, as a C function pointer.

  Attributes:
    pointer: what the C entry takes as its hook; None on a mesh of one.
  """

  def __init__(self, mesh, packed):
    self._set(_HOOK, (lambda step: mesh.sum_(packed)) if mesh.size > 1
              else None)

  def _set(self, prototype, fn):
    """Wrap ``fn`` (None: no hook) as a C function of ``prototype`` that
    keeps any error for ``check`` and returns 1 for it, else 0."""
    self._failures = []
    self._callback = None
    if fn is not None:

      def guarded(*args):
        try:
          fn(*args)
        except BaseException as err:  # raised again by check()
          self._failures.append(err)
          return 1
        return 0

      self._callback = prototype(guarded)  # kept alive with the hook
    self.pointer = (None if self._callback is None
                    else ctypes.cast(self._callback, ctypes.c_void_p))

  def check(self, err, what):
    """After the launch: raise the callback's error, or RuntimeError for a
    nonzero return code ``err`` of the C entry (``what`` names the call)."""
    if self._failures:
      raise self._failures[0]
    if err != 0:
      raise RuntimeError("%s failed with %s" % (
          what, "a failed sum hook" if err == FAILED
          else "CUDA error %d" % err))


class StopHook(SumHook):
  """The per-iteration sum of the one-float ``local`` over ``mesh``, as a
  C function pointer ``int hook(int iteration)``; None on a mesh of one,
  where the kernel decides on its own sum."""

  def __init__(self, mesh, local):
    if local.numel() != 1:
      raise ValueError("the stop hook sums one float, got %d"
                       % local.numel())
    super().__init__(mesh, local)


class AxisSumHook(SumHook):
  """hook(step, which): ``sums[which]`` = (sum_, buffer) runs as
  ``sum_(buffer)``; ``sums`` maps each ``which`` the C loop calls to its
  in-place sum and buffer.  Empty ``sums``: pointer None, no hook."""

  def __init__(self, sums):
    self._set(_AXIS_HOOK, (lambda step, which: sums[which][0](sums[which][1]))
              if sums else None)
