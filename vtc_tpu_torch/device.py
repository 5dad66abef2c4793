"""Where the port's entry points run.

``encode_dataset``, ``train_dictionary``, ``train_dictionary_scanned`` and
``SparseCoder`` run on the CUDA device unless the caller names another
device or passes tensors that live elsewhere.  Without a CUDA device that
default raises: it never falls back to the CPU quietly.
"""
import torch


def resolve_device(device=None, *candidates):
  """``device`` if given, else the device of the first tensor among
  ``candidates``, else the current CUDA device.

  Raises RuntimeError when the default would be the CUDA device and there
  is none."""
  if device is not None:
    return torch.device(device)
  for x in candidates:
    if isinstance(x, torch.Tensor):
      return x.device
  if not torch.cuda.is_available():
    raise RuntimeError(
        "no CUDA device: vtc_tpu_torch runs on the card unless the caller "
        "asks for the CPU; pass device='cpu' (or CPU tensors) to run there")
  return torch.device("cuda", torch.cuda.current_device())
