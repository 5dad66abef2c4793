"""The host hook of the whole-segment data-parallel kernels K15, K16, K17
and K18: the port's stand-in for vtc_tpu's in-kernel remote-DMA
all-reduce K14 (vtc_tpu/ops/pallas_collective.py:31-185).

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
"""
import ctypes

FAILED = -1  # kSumHookFailed of csrc/train_core.cuh
_HOOK = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int)  # int hook(int step)


class SumHook:
  """The per-step sum of ``packed`` over ``mesh``, as a C function pointer.

  Attributes:
    pointer: what the C entry takes as its hook; None on a mesh of one.
  """

  def __init__(self, mesh, packed):
    self._failures = []
    self._callback = None
    if mesh.size > 1:

      def sum_packed(step):
        try:
          mesh.sum_(packed)
        except BaseException as err:  # raised again by check()
          self._failures.append(err)
          return 1
        return 0

      self._callback = _HOOK(sum_packed)  # kept alive with the hook
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
