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
  ``ops/_build.py``) on the current stream, or raises: one launch of
  ``gram_class_gemm`` (csrc/conv_gram_tiles.cuh) an iteration, over the
  code positions grouped by border class in the plan of ``class_plan``,
  made once a geometry;
* a CPU tensor runs ``fused_conv_fista_plain``, the plain PyTorch
  version of the same operator and update, which the CPU tests hold to
  vtc_tpu's kernel and ``chip_smoke.py`` holds the kernel against.  It is
  also the 'gram' formulation of ``convolutional/ista_fista.run``: one
  loop serves both, as in vtc_tpu (its kernel is tested against 'gram').

``run(formulation='pallas')`` takes this kernel for the geometries K10's
gate turns away.  ``early_stopping_epsilon`` runs the batch-global stop
test on the card as K10 does (csrc/conv_gemm.cuh, "The early stop"): an
iteration's launch decides on the device and every launch after a stop
returns at entry; ``last_iters`` (a private test hook) is the int32 device
tensor of the last stopped launch's count.  K11 has no precision tier, as
vtc_tpu's has none: ``mxu`` other than 'highest' raises ValueError (the
tiers run on K10's geometry, ops/fused_conv_direct).  ``launches`` counts
solves launched on the card.
"""
import ctypes
import functools

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
                           hard=False, early_stopping_epsilon=None,
                           mxu="highest"):
  """Conv LASSO codes through the K11 kernel; the arguments and result
  are those of ``fused_conv_direct.fused_conv_direct_solve``, for any
  stride-exact geometry, at 'highest' only (``mxu``: K11 has no tier, as
  vtc_tpu's has none; ValueError otherwise)."""
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  _require(mxu == "highest",
           "mxu=%r: K11, the gram-form conv kernel, has no precision tier, "
           "as vtc_tpu's has none; the tiers run on K10's geometry" % (mxu,))
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


# A tile's class word (csrc/conv_gram_tiles.cuh): bit 0 special row, bit 1
# special column, the row's index in spec_py at bits 2-15, the column's
# index in spec_px at bits 16-29; 0 is the interior.  A work item is tile
# << PASS_BITS | pass.
CLASS_ROW, CLASS_COL, CLASS_INDEX_BITS, PASS_BITS = 1, 2, 14, 2
TILE_M, TILE_N = 64, 64  # the kernel's tiles: codes x positions


def class_word(row=None, col=None):
  """The class word of special row index ``row`` and/or special column
  index ``col`` (None: not special that way)."""
  word = 0
  if row is not None:
    word |= CLASS_ROW | row << 2
  if col is not None:
    word |= CLASS_COL | col << (2 + CLASS_INDEX_BITS)
  return word


def passes(word):
  """The K passes of a tile of class ``word``: G_int, after G_rows[i] for
  a special row, G_cols[j] for a special column and G_corn[i, j] for a
  corner."""
  row, col = bool(word & CLASS_ROW), bool(word & CLASS_COL)
  return 1 + row + col + (row and col)


def class_plan(spec_py, spec_px, b, code_h, code_w):
  """The plan of K11's class-tiled launch, int32 CPU tensors (slots,
  tile_class, items) and multi_items.

  Every code position (b, y, x) of b samples of code_h x code_w codes
  appears once in slots, as (b * code_h + y) * code_w + x, grouped by its
  class (``class_word``: interior, special row i of spec_py, special
  column j of spec_px, corner (i, j)), each class padded with -1 to whole
  tiles of TILE_N slots, the classes with the most passes first (the
  corners, the rows, the columns, the interior), each b-major.
  tile_class holds each tile's class word.  items lists the kernel's work
  items, one a pass of each tile (tile << PASS_BITS | pass), a tile's
  passes in order and the tiles of several passes first; multi_items
  counts those."""
  py, px = list(spec_py), list(spec_px)
  keep_y = torch.ones(code_h, dtype=torch.bool)
  keep_x = torch.ones(code_w, dtype=torch.bool)
  keep_y[py] = False
  keep_x[px] = False
  ys, xs = torch.nonzero(keep_y).flatten(), torch.nonzero(keep_x).flatten()
  bb = torch.arange(b) * (code_h * code_w)

  def positions(rows, cols):
    rows, cols = torch.as_tensor(rows), torch.as_tensor(cols)
    return (bb[:, None, None] + rows[None, :, None] * code_w
            + cols[None, None, :]).reshape(-1)

  classes = [(class_word(i, j), positions([y], [x]))
             for i, y in enumerate(py) for j, x in enumerate(px)]
  classes += [(class_word(row=i), positions([y], xs))
              for i, y in enumerate(py)]
  classes += [(class_word(col=j), positions(ys, [x]))
              for j, x in enumerate(px)]
  classes.append((0, positions(ys, xs)))
  slots, words = [], []
  for word, pos in classes:
    tiles = -(-pos.numel() // TILE_N)
    padded = torch.full((tiles * TILE_N,), -1, dtype=torch.int32)
    padded[:pos.numel()] = pos
    slots.append(padded)
    words += [word] * tiles
  multi = [t << PASS_BITS | q for t, w in enumerate(words) if passes(w) > 1
           for q in range(passes(w))]
  single = [t << PASS_BITS for t, w in enumerate(words) if passes(w) == 1]
  return (torch.cat(slots), torch.tensor(words, dtype=torch.int32),
          torch.tensor(multi + single, dtype=torch.int32), len(multi))


@functools.lru_cache(maxsize=16)
def _device_plan(spec_py, spec_px, b, code_h, code_w, device):
  """class_plan's tensors on ``device``, made once per geometry."""
  slots, words, items, multi = class_plan(spec_py, spec_px, b, code_h,
                                          code_w)
  return (slots.to(device), words.to(device), items.to(device), multi)


def _launch(op, corr, eta, lam, num_iters, fista, mode, z, eps=None):
  """Pack the operator, plan the tiles and enqueue the solve on the
  current stream; eps the early stop's threshold (None: none)."""
  global launches, last_iters
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  device = z.device
  b, s, code_h, code_w = z.shape
  spec_py, spec_px = list(op["spec_py"]), list(op["spec_px"])
  num_p, num_q = len(spec_py), len(spec_px)
  n_off = op["g_int"].shape[0]
  _require(b * code_h * code_w < 2 ** 31 and s * code_h * code_w < 2 ** 31,
           "the codes (%d, %d, %d, %d) are too large for int32 offsets"
           % (b, s, code_h, code_w))
  _require(max(num_p, num_q) < 2 ** CLASS_INDEX_BITS,
           "too many special rows or columns")
  gint = _stacked(op["g_int"][None], 1)
  grows = _stacked(op["g_rows"], num_p) if num_p else None
  gcols = _stacked(op["g_cols"], num_q) if num_q else None
  gcorn = (_stacked(op["g_corners"].reshape(num_p * num_q, n_off, s, s),
                    num_p * num_q) if num_p and num_q else None)
  slots, tile_class, items, multi_items = _device_plan(
      tuple(spec_py), tuple(spec_px), b, code_h, code_w, device)
  tiles, m_tiles = tile_class.numel(), -(-s // TILE_M)
  scratch = torch.empty(max(1, m_tiles * multi_items * TILE_M * TILE_N),
                        dtype=torch.float32, device=device)
  tickets = torch.zeros(m_tiles * tiles, dtype=torch.int32, device=device)
  z2 = torch.empty_like(z)
  old = z.clone()
  eps, words, iters = stop_scratch(
      lib, s, None, eps, device,
      words=lib.vtc_conv_gram_stop_words(s, items.numel()))
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_conv_fista(
        gint.data_ptr(), ptr(grows), ptr(gcols), ptr(gcorn),
        slots.data_ptr(), tile_class.data_ptr(), items.data_ptr(),
        scratch.data_ptr(), tickets.data_ptr(), tiles, items.numel(),
        multi_items, num_p, num_q,
        corr.data_ptr(), eta.data_ptr(), ctypes.c_float(lam), num_iters, b,
        s, code_h, code_w, op["ry"], op["rx"], int(fista), mode,
        z.data_ptr(), z2.data_ptr(), old.data_ptr(), ctypes.c_float(eps),
        ctypes.c_float(1.0 / z.numel()), ptr(words), ptr(iters), stream)
  if err != 0:
    raise RuntimeError(
        "conv gram kernel launch failed with CUDA error %d (b=%d, s=%d, "
        "%d offsets, %d special rows, %d special columns, %d tiles, %d "
        "items%s)" % (err, b, s, n_off, num_p, num_q, tiles, items.numel(),
                      "" if words is None else ", early stop"))
  launches += 1
  if iters is not None:
    last_iters = iters
  return old
