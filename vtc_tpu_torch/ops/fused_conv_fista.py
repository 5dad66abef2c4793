"""Gram-form convolutional ISTA/FISTA solve: the port of TPU kernel K11,
``conv_fista_solve_pallas`` (vtc_tpu/ops/pallas_conv_fista.py:229-363).

The iteration runs in code space: grad(z) = L(z) - corr with L the
code-space Gram operator of ops/conv_gram.py (9 offset matrices at the
reference geometry, plus the row, column and corner corrections of the
masked border) and corr = A(mask * X).  Both are built outside the kernel
with torch ops, where the JAX function builds them with XLA (:271-278).
Then:

* a CUDA tensor launches the hand-written kernel in
  ``vtc_tpu_torch/csrc/fused_conv_fista.cu`` (built at first use by
  ``ops/_build.py``) on the current stream, or raises;
* a CPU tensor runs ``fused_conv_fista_plain``, the plain PyTorch
  version of the same operator and update, which the CPU tests hold to
  vtc_tpu's kernel and ``chip_smoke.py`` holds the kernel against.  It is
  also the 'gram' formulation of ``convolutional/ista_fista.run``: one
  loop serves both, as in vtc_tpu (its kernel is tested against 'gram').

``run(formulation='pallas')`` takes this kernel for the geometries K10's
gate turns away.  ``early_stopping_epsilon`` runs the batch-global stop
test on the card as K10 does (csrc/conv_gemm.cuh, "The early stop"): the
interior launch decides on the device and every launch after a stop
returns at entry; ``last_iters`` (a private test hook) is the int32 device
tensor of the last stopped launch's count.  Scope: only the 'highest'
tier (ROADMAP.md §1 item 3a.2.2).  ``launches`` counts solves launched on
the card.
"""
import ctypes

import torch

from vtc_tpu_torch.ops import conv_gram, conv_shapes, thresholds
from vtc_tpu_torch.ops import convolutions as conv_ops
from vtc_tpu_torch.ops.fused_conv_direct import ptr, stop_scratch
from vtc_tpu_torch.ops.solver import proximal_gradient_loop

launches = 0
last_iters = None  # int32 device tensor: the last stopped launch's count

_MODES = {(False, False): 0, (True, False): 1, (False, True): 2,
          (True, True): 3}


def code_dims(images_shape, dict_shape, kernel_stride):
  """(code_h, code_w) of padded images, after checking that they are
  stride-exact (ops/conv_shapes.require_stride_exact)."""
  kh, kw = dict_shape[2], dict_shape[3]
  conv_shapes.require_stride_exact(images_shape[2:], (kh, kw), kernel_stride)
  return (conv_shapes.code_dim_from_padded_img_dim(images_shape[2], kh,
                                                   kernel_stride[0]),
          conv_shapes.code_dim_from_padded_img_dim(images_shape[3], kw,
                                                   kernel_stride[1]))


def operator_and_corr(images, dictionary, kernel_stride, padding,
                      precision=None):
  """(op, corr): the Gram operator (conv_gram.build_gram_operator) and
  corr = A(mask * X) (b, s, code_h, code_w)."""
  code_hw = code_dims(images.shape, dictionary.shape, kernel_stride)
  op = conv_gram.build_gram_operator(dictionary, kernel_stride, padding,
                                     tuple(images.shape[2:]), code_hw,
                                     precision)
  mask = conv_shapes.create_mask(images.shape, padding, images.dtype,
                                 images.device)
  corr = conv_ops.analyze(mask * images, dictionary, kernel_stride,
                          precision)
  return op, corr


def fused_conv_fista_plain(images, dictionary, sparsity_weight, num_iters,
                           stepsize, *, kernel_stride, padding,
                           initial_codes=None, variant="fista", nonneg=False,
                           hard=False, early_stopping_epsilon=None,
                           precision=None):
  """The plain PyTorch version of K11 and the 'gram' formulation, on any
  device and in the inputs' own float type: codes = shrink(z - eta *
  (L(z) - corr), lam * eta) with FISTA or ISTA momentum.
  ``early_stopping_epsilon`` is the loop's batch-global stop test;
  ``precision`` as in ``fused_conv_direct_plain``."""
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  dtype, device = images.dtype, images.device
  shrink = thresholds.select(bool(nonneg), bool(hard))
  eta = torch.as_tensor(stepsize, dtype=dtype, device=device)
  op, corr = operator_and_corr(images, dictionary, kernel_stride, padding,
                               precision)
  if initial_codes is None:
    z = torch.zeros_like(corr)
  else:
    z = torch.as_tensor(initial_codes, dtype=dtype, device=device)

  def grad_fn(z):
    return conv_gram.apply_gram(z, op, precision) - corr

  def prox_fn(x, ss):
    return shrink(x, sparsity_weight * ss)

  return proximal_gradient_loop(
      grad_fn, prox_fn, z, eta, num_iters, variant=variant,
      early_stopping_epsilon=early_stopping_epsilon)


def _require(cond, message):
  if not cond:
    raise ValueError("fused_conv_fista_solve: " + message)


def fused_conv_fista_solve(images, dictionary, sparsity_weight, num_iters,
                           stepsize, *, kernel_stride, padding,
                           initial_codes=None, variant="fista", nonneg=False,
                           hard=False, early_stopping_epsilon=None):
  """Conv LASSO codes through the K11 kernel; the arguments and result
  are those of ``fused_conv_direct.fused_conv_direct_solve``, for any
  stride-exact geometry."""
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  if images.device.type == "cpu":
    return fused_conv_fista_plain(
        images, dictionary, sparsity_weight, num_iters, stepsize,
        kernel_stride=kernel_stride, padding=padding,
        initial_codes=initial_codes, variant=variant, nonneg=nonneg,
        hard=hard, early_stopping_epsilon=early_stopping_epsilon)
  _require(images.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(images.device))
  device = images.device
  _require(dictionary.device == device, "dictionary on another device")
  _require(images.dtype == torch.float32
           and dictionary.dtype == torch.float32, "inputs must be float32")
  _require(images.dim() == 4 and dictionary.dim() == 4
           and images.shape[1] == dictionary.shape[1],
           "shapes must be (b, c, H, W) and (s, c, kh, kw), got %s and %s"
           % (tuple(images.shape), tuple(dictionary.shape)))
  num_iters = int(num_iters)
  _require(num_iters >= 0, "num_iters must be >= 0")
  eta = torch.as_tensor(stepsize, dtype=torch.float32, device=device)
  _require(eta.numel() == 1, "stepsize must be a scalar")
  eta = eta.reshape(1).contiguous()
  op, corr = operator_and_corr(images, dictionary, kernel_stride, padding)
  corr = corr.contiguous()
  if initial_codes is None:
    z = torch.zeros_like(corr)
  else:
    _require(initial_codes.device == device
             and initial_codes.dtype == torch.float32
             and initial_codes.shape == corr.shape,
             "initial_codes must be a float32 %s tensor on the inputs' "
             "device" % (tuple(corr.shape),))
    z = initial_codes.clone(memory_format=torch.contiguous_format)
  if images.shape[0] == 0:
    return z
  return _launch(op, corr, eta, float(sparsity_weight), num_iters,
                 variant == "fista", _MODES[(bool(nonneg), bool(hard))], z,
                 eps=early_stopping_epsilon)


def _stacked(g, lines):
  """(lines, O, s, s) offset matrices -> (lines, s, O*s) with
  A[i, o*s + j] = G[o][i][j], the kernel's weight layout."""
  n_off, s = g.shape[1], g.shape[2]
  return g.permute(0, 2, 1, 3).reshape(lines, s, n_off * s).contiguous()


def _launch(op, corr, eta, lam, num_iters, fista, mode, z, eps=None):
  """Pack the operator, allocate the scratch and enqueue the solve on
  the current stream; eps the early stop's threshold (None: none)."""
  global launches, last_iters
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  device = z.device
  b, s, code_h, code_w = z.shape
  spec_py, spec_px = list(op["spec_py"]), list(op["spec_px"])
  num_p, num_q = len(spec_py), len(spec_px)
  n_off = op["g_int"].shape[0]
  gint = _stacked(op["g_int"][None], 1)
  grows = _stacked(op["g_rows"], num_p) if num_p else None
  gcols = _stacked(op["g_cols"], num_q) if num_q else None
  gcorn = (_stacked(op["g_corners"].reshape(num_p * num_q, n_off, s, s),
                    num_p * num_q) if num_p and num_q else None)
  py = torch.tensor(spec_py or [0], dtype=torch.int32, device=device)
  px = torch.tensor(spec_px or [0], dtype=torch.int32, device=device)
  row_flag = torch.zeros(code_h, dtype=torch.int32, device=device)
  row_flag[spec_py] = 1
  corrbuf = torch.zeros_like(z)
  z2 = torch.empty_like(z)
  old = z.clone()
  eps, words, iters = stop_scratch(lib, s, b * code_h * code_w, eps, device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_conv_fista(
        gint.data_ptr(), ptr(grows), ptr(gcols), ptr(gcorn), py.data_ptr(),
        px.data_ptr(), row_flag.data_ptr(), num_p, num_q, corr.data_ptr(),
        eta.data_ptr(), ctypes.c_float(lam), num_iters, b, s, code_h, code_w,
        op["ry"], op["rx"], int(fista), mode, corrbuf.data_ptr(),
        z.data_ptr(), z2.data_ptr(), old.data_ptr(), ctypes.c_float(eps),
        ctypes.c_float(1.0 / z.numel()), ptr(words), ptr(iters), stream)
  if err != 0:
    raise RuntimeError(
        "conv gram kernel launch failed with CUDA error %d (b=%d, s=%d, "
        "%d offsets, %d special rows, %d special columns%s)" % (
            err, b, s, n_off, num_p, num_q,
            "" if words is None else ", early stop"))
  launches += 1
  if iters is not None:
    last_iters = iters
  return old
