"""Direct-formulation convolutional ISTA/FISTA solve: the port of TPU
kernel K10, ``conv_direct_solve_pallas`` (vtc_tpu/ops/pallas_conv_direct.py:
355-446), and the stride-block helpers of that file.

In stride-block space the padded image splits into non-overlapping
sv x sh blocks and a kernel whose dims are multiples of the stride covers
R = (kh/sv)*(kw/sh) whole blocks, so

  S(z)[block B] = sum_a Dpart[a]^T z[B - a]
  A(y)[code c]  = sum_a Dpart[a]   y[c + a]

with Dpart[a] the (s, c*sv*sh) kernel part a: one deep product each, and
the padding mask applied elementwise to the image blocks.  Kernels that
are not stride multiples are zero-extended, with matching trailing zero
image rows and columns (``geometry``), which leaves the codes exact.

``fused_conv_direct_solve`` keeps the JAX function's contract.  It packs
the weights, blockifies mask * X and builds the block mask with torch ops,
outside the kernel, as the JAX function does with XLA (:383-391).  Then:

* a CUDA tensor launches the hand-written kernel in
  ``vtc_tpu_torch/csrc/fused_conv_direct.cu`` (built at first use by
  ``ops/_build.py``) on the current stream, or raises;
* a CPU tensor runs ``fused_conv_direct_plain``, the plain PyTorch
  version of the same block iteration, which the CPU tests hold to
  vtc_tpu's kernel and ``chip_smoke.py`` holds the kernel against.

``fused_conv_direct_library`` is the same iteration with each product
as one library convolution (cuDNN on the card, TF32 off), or at a tier
each pass as one library product of bf16 operands on the materialized
stack: the yardstick ``chip_smoke.py`` times beside the kernel.  The main
path never calls it.

``supported`` is the JAX gate (:98-112).  ``build_block_update_stats``
and ``dictionary_gradient_from_block_stats`` (:212-252) are the conv
trainer's 'block' dictionary gradient, as torch ops.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test
(:307-334) on the card: the kernel's launches are the gathered GEMM's
STOP builds, the analysis launch of each iteration decides on the device
and the launches after a stop return at entry (csrc/conv_gemm.cuh, "The
early stop"); the host never reads the mean.  ``last_iters`` (a private
test hook) is the int32 device tensor of the last stopped launch's
count; ``stop_scratch`` sizes the stop's device words.

``mxu`` is vtc_tpu's ``mxu_precision`` (:263-269, ``_make_deep_dot``,
pallas_conv_train.py:240-267): at 'bf16x5', 'bf16x3' or 'bf16' ('default')
the three products of the solve (corr = A(mask * X), the synthesis, the
analysis) sum single-pass bf16 products in float32, the weights split once
per solve and the stacked source per use, the weights on the left: on the
card conv_gemm_tier.cuh's bf16 tensor-core GEMM, in the plain version
``conv_deep_dot``.  The mask, the prox, the momentum and the stop test stay
float32.  The tier kernel takes K = R*s and R*cpx up to its offset table's
``vtc_conv_tier_max_k`` (4,096) and refuses more by name (``tier_scratch``);
vtc_tpu's K10 takes the stop on one batch tile only
(``early_stop_supported``), and at a tier so does the port.
``launches`` counts solves launched on the card, ``tier_launches`` those
at a tier.

A tier product takes one of two routes of conv_gemm_tier.cuh, bitwise
alike: ``gather_gemm_tier`` or the window route (``conv_window_gemm``: a
persistent grid, the weights' planes resident a launch, each tile's
source window copied once and split once).  ``conv_tier_plan`` mirrors
the library's rule and layout, ``conv_stop_words`` the stop's sizing;
a solve's ``route`` (checks and tools only) forces its tier products
onto one route, ``tier_route_launches`` reads the library's count of
tier products by route, ``tier_product`` runs one product on a route.
"""
import ctypes

import torch
import torch.nn.functional as F

from vtc_tpu_torch.ops import conv_shapes, thresholds
from vtc_tpu_torch.ops.precision import (TIER_CODES, TIER_PAIRS, _bf16,
                                         matmul_precision, mma_pass,
                                         resolve_tier, split3, split_hi_lo,
                                         tier_operand, tier_pass_sum)
from vtc_tpu_torch.ops.solver import proximal_gradient_loop

launches = 0
tier_launches = 0
last_iters = None  # int32 device tensor: the last stopped launch's count

# the kernel's shrink modes, indexed by (nonneg, hard)
_MODES = {(False, False): 0, (True, False): 1, (False, True): 2,
          (True, True): 3}


def geometry(img_shape, dict_shape, kernel_stride):
  """Stride-block geometry (vtc_tpu pallas_conv_direct.py:67-95, without
  the TPU canvas): kernels zero-extended to (khp, kwp), the padded image
  to (H + ekh, W + ekw), bh x bw blocks, ay x ax kernel parts and
  code_h x code_w codes."""
  _, c, hh, ww = img_shape
  s, _, kh, kw = dict_shape
  sv, sh_ = kernel_stride
  khp = -(-kh // sv) * sv
  kwp = -(-kw // sh_) * sh_
  ay, ax = khp // sv, kwp // sh_
  bh, bw = (hh + khp - kh) // sv, (ww + kwp - kw) // sh_
  return dict(s=s, c=c, cpx=c * sv * sh_, r=ay * ax, ay=ay, ax=ax, sv=sv,
              sh=sh_, bh=bh, bw=bw, code_h=bh - (ay - 1),
              code_w=bw - (ax - 1), kh=kh, kw=kw, khp=khp, kwp=kwp,
              ekh=khp - kh, ekw=kwp - kw)


def supported(img_shape, dict_shape, kernel_stride):
  """The JAX gate: stride-exact padded dims and per-part weights of at
  most 512 x 512 (vtc_tpu pallas_conv_direct.py:98-112)."""
  _, c, hh, ww = img_shape
  s, _, kh, kw = dict_shape
  sv, sh_ = kernel_stride
  if (hh - kh) % sv or (ww - kw) % sh_:
    return False
  if c * sv * sh_ > 512 or s > 512:
    return False
  geo = geometry(img_shape, dict_shape, kernel_stride)
  return geo["code_h"] >= 1 and geo["code_w"] >= 1


# vtc_tpu's K10 batch tile (pallas_conv_direct.py:64, :115-124 and
# pallas_common.py:33-46): its VMEM limit, lanes and largest tile
_TPU_VMEM_LIMIT, _TPU_LANES, _TPU_MAX_TILE = 100 * 1024 * 1024, 128, 32


def _tpu_batch_tile(b, geo):
  """vtc_tpu's ``_pick_batch_tile``: the largest batch tile whose VMEM
  working set on its lane canvas fits, preferring divisors of b unless the
  best divisor is under half the best tile; None when one image does not
  fit."""
  s, cpx, r = geo["s"], geo["cpx"], geo["r"]
  rows = 5 * s + 2 * cpx + r * max(s, cpx)
  ell = (geo["bh"] + geo["ay"] - 1) * (geo["bw"] + geo["ax"] - 1)
  ells = -(-ell // _TPU_LANES) * _TPU_LANES
  best_div = best_any = None
  for t in range(1, min(b, _TPU_MAX_TILE) + 1):
    if 4 * rows * t * ells <= int(_TPU_VMEM_LIMIT * 0.6):
      best_any = t
      if b % t == 0:
        best_div = t
  if best_div is not None and best_div >= max(1, (best_any or 1) // 2):
    return best_div
  return best_any


def early_stop_supported(img_shape, dict_shape, kernel_stride):
  """vtc_tpu's ``early_stop_supported`` (pallas_conv_direct.py:339-347):
  whether its K10 takes the early stop, the whole batch in one VMEM tile.
  The port's K10 stops on any batch at 'highest'; with a tier the port
  refuses a stop where this fails, as vtc_tpu does."""
  kernel_stride = tuple(int(x) for x in kernel_stride)
  if not supported(img_shape, dict_shape, kernel_stride):
    return False
  tile = _tpu_batch_tile(img_shape[0],
                         geometry(img_shape, dict_shape, kernel_stride))
  return tile is not None and tile >= img_shape[0]


def tier_scratch(lib, mxu, geo, device, what):
  """The C entries' tier arguments for the resolved tier ``mxu``: (its
  code, the int32 words of the split weights, or None at 'highest').
  ValueError, naming ``what``, where the tier kernel's offset table cannot
  take the products' depths R*s and R*cpx (``vtc_conv_tier_max_k``)."""
  code = TIER_CODES[mxu]
  if code == 0:
    return 0, None
  if geo["r"] * max(geo["s"], geo["cpx"]) > lib.vtc_conv_tier_max_k():
    raise ValueError(
        "%s: mxu=%r needs the tier kernel, whose offset table takes K up to "
        "%d, and this geometry's depth R*max(s, cpx) is %d" % (
            what, mxu, lib.vtc_conv_tier_max_k(),
            geo["r"] * max(geo["s"], geo["cpx"])))
  words = lib.vtc_conv_tier_words(code, geo["s"], geo["cpx"], geo["r"])
  return code, torch.empty(int(words), dtype=torch.int32, device=device)


# The tier GEMM's window route (csrc/conv_gemm_tier.cuh): threads a CTA (8
# math warps, 8 memory warps), positions a tile at most, the narrowest
# output row it takes, a CTA's dynamic shared memory; conv_gemm.cuh's
# 64-row blocks and K cap.
WIN_THREADS = 512
WIN_MAX_N = 128
WIN_MIN_OUT_W = 16
WIN_SMEM = 232448 - 1024
BM = 64
TABLE_MAX_K = 4096
TIER_ROUTES = {"auto": 0, "gather": 1, "window": 2}
_ROUTE_NAMES = {1: "gather", 2: "window"}
_TERMS = {"bf16": 1, "bf16x3": 2, "bf16x5": 3}


def window_smem_bytes(terms, k, src_c, off_w, off_h, out_w, rows):
  """A window CTA's dynamic shared memory: the m-block's A planes, two
  windows' term planes, two tiles of C, the step table (conv_gemm_tier.cuh's
  window_smem_bytes)."""
  nks = k // 16
  wr, wc = rows + off_h - 1, out_w + off_w - 1
  a = terms * (BM // 16) * nks * 512
  planes = 2 * terms * wr * wc * (src_c + 8)
  ctile = 4 * BM * (8 * -(-(rows * out_w) // 8) + 4)
  return a + 2 * planes + 2 * ctile + 4 * nks


def _window_plan_at(m, k, src_c, off_w, out_h, out_w, nb, mxu, sm_count,
                    rows):
  mblocks = -(-m // BM)
  row_tiles = nb * -(-out_h // rows)
  grid = min(row_tiles, sm_count // mblocks) * mblocks
  return dict(route="window", rows=rows, mblocks=mblocks,
              tiles=mblocks * row_tiles, grid=grid,
              smem=window_smem_bytes(
                  _TERMS[mxu], k, src_c, off_w, (k // src_c - 1) // off_w + 1,
                  out_w, rows))


def conv_tier_plan(m, k, src_c, off_w, out_h, out_w, nb, mxu, sm_count):
  """The library's ``conv_tier_plan``: the route and layout of a tier
  product of m rows and depth k over src_c channels (off_w offsets a
  row), nb images of out_h x out_w positions, at tier mxu on sm_count SMs.
  A dict of route ('window' or 'gather'), rows a tile, mblocks, tiles, grid
  and smem (bytes a CTA); the gather route's other values are 0.  Of the
  rows a tile that fit, the one whose CTA does the least work: its rounds
  of tiles and one (the pipeline's fill) times a tile's window rows, the
  most rows of equals."""
  gather = dict(route="gather", rows=0, mblocks=0, tiles=0, grid=0, smem=0)
  terms = _TERMS.get(resolve_tier(mxu), 0)
  mblocks = -(-m // BM)
  if (terms == 0 or m < 1 or k < 16 or src_c < 16 or src_c % 16
      or k % src_c or k > TABLE_MAX_K or off_w < 1
      or not WIN_MIN_OUT_W <= out_w <= WIN_MAX_N or out_h < 1 or nb < 1
      or sm_count < mblocks):
    return gather
  off_h = (k // src_c - 1) // off_w + 1
  fit = WIN_MAX_N // out_w
  while fit > 0 and window_smem_bytes(terms, k, src_c, off_w, off_h, out_w,
                                      fit) > WIN_SMEM:
    fit -= 1
  if fit == 0:
    return gather
  slots = sm_count // mblocks

  def work(rows):
    return (-(-(nb * -(-out_h // rows)) // slots) + 1) * (rows + off_h - 1)
  rows = fit
  for r in range(fit - 1, 0, -1):
    if work(r) < work(rows):
      rows = r
  return _window_plan_at(m, k, src_c, off_w, out_h, out_w, nb,
                         resolve_tier(mxu), sm_count, rows)


def conv_tier_route(m, k, src_c, off_w, out_h, out_w, nb, mxu, sm_count):
  """'window' or 'gather': the route ``conv_tier_plan`` gives."""
  return conv_tier_plan(m, k, src_c, off_w, out_h, out_w, nb, mxu,
                        sm_count)["route"]


def solve_products(geo, b):
  """{name: (m, k, src_c, off_w, out_h, out_w, nb)} of a conv solve's
  tier products on b images: corr and the analysis (the same shape) and
  the synthesis."""
  anal = (geo["s"], geo["r"] * geo["cpx"], geo["cpx"], geo["ax"],
          geo["code_h"], geo["code_w"], b)
  synth = (geo["cpx"], geo["r"] * geo["s"], geo["s"], geo["ax"], geo["bh"],
           geo["bw"], b)
  return {"corr": anal, "synthesis": synth, "analysis": anal}


def conv_stop_words(m, positions):
  """conv_gemm.cuh's conv_stop_words: the 64-bit words of a stop's
  device array for a kProx product of m rows over ``positions``
  positions, a share for each of its smallest tiles (one output row of
  at least WIN_MIN_OUT_W positions) after the two control words."""
  tiles = -(-positions // WIN_MIN_OUT_W) * -(-m // BM)
  return 2 + (tiles + 1) // 2


def kernel_parts(dictionary, geo):
  """(R, s, cpx) parts[a, i, (ch, py, px)] = D[i, ch, a_y*sv + py,
  a_x*sh + px] of the zero-extended kernels."""
  s, c = geo["s"], geo["c"]
  d = F.pad(dictionary, (0, geo["ekw"], 0, geo["ekh"]))
  parts = d.reshape(s, c, geo["ay"], geo["sv"], geo["ax"], geo["sh"])
  return parts.permute(2, 4, 0, 1, 3, 5).reshape(geo["r"], s, geo["cpx"])


def pack_weights(dictionary, geo):
  """(dstk, dall): synthesis (cpx, R*s) and analysis (s, R*cpx) from
  ``kernel_parts``."""
  s = geo["s"]
  parts = kernel_parts(dictionary, geo)
  dstk = parts.permute(2, 0, 1).reshape(geo["cpx"], geo["r"] * s)
  dall = parts.permute(1, 0, 2).reshape(s, geo["r"] * geo["cpx"])
  return dstk.contiguous(), dall.contiguous()


def unpack_dstk(grad_dstk, geo, kernel_shape):
  """(cpx, R*s) dstk-layout gradient -> (s, c, kh, kw), the extension
  rows and columns sliced away."""
  s, c, kh, kw = kernel_shape
  parts = grad_dstk.reshape(geo["cpx"], geo["r"], s).permute(1, 2, 0)
  full = parts.reshape(geo["ay"], geo["ax"], s, c, geo["sv"],
                       geo["sh"]).permute(2, 3, 0, 4, 1, 5).reshape(
                           s, c, geo["khp"], geo["kwp"])
  return full[:, :, :kh, :kw]


def blockify(img, geo):
  """(b, c, H, W) -> (b, cpx, bh, bw) stride blocks, pixel (c, py, px) in
  the channel dim, after the kernel-extension zero rows and columns."""
  b = img.shape[0]
  img = F.pad(img, (0, geo["ekw"], 0, geo["ekh"]))
  x = img.reshape(b, geo["c"], geo["bh"], geo["sv"], geo["bw"], geo["sh"])
  return x.permute(0, 1, 3, 5, 2, 4).reshape(b, geo["cpx"], geo["bh"],
                                             geo["bw"])


def block_mask(images_shape, padding, geo, dtype, device):
  """(mask_img (1, 1, H, W), mblk (cpx, bh, bw)): the padding mask in
  image and in block space."""
  mask_img = conv_shapes.create_mask(images_shape, padding, dtype, device)
  full = mask_img.expand((1, geo["c"]) + tuple(images_shape[2:]))
  return mask_img, blockify(full, geo)[0].contiguous()


def code_stack(z, geo):
  """(b, R*s, bh, bw): z[b, j, B - a] stacked over the parts a (zero
  outside the codes), the synthesis product's right operand."""
  ay, ax, bh, bw = geo["ay"], geo["ax"], geo["bh"], geo["bw"]
  zp = F.pad(z, (ax - 1, ax - 1, ay - 1, ay - 1))
  return torch.cat([
      zp[:, :, ay - 1 - a_y:ay - 1 - a_y + bh, ax - 1 - a_x:ax - 1 - a_x + bw]
      for a_y in range(ay) for a_x in range(ax)], dim=1)


def block_stack(img, geo):
  """(b, R*cpx, code_h, code_w): y[b, p, c + a] stacked over the parts
  a, the analysis product's right operand."""
  ch, cw = geo["code_h"], geo["code_w"]
  return torch.cat([img[:, :, a_y:a_y + ch, a_x:a_x + cw]
                    for a_y in range(geo["ay"]) for a_x in range(geo["ax"])],
                   dim=1)


def _product(weights, stack):
  """(m, K) x (b, K, h, w) -> (b, m, h, w)."""
  b, k, h, w = stack.shape
  return (weights @ stack.reshape(b, k, h * w)).reshape(b, -1, h, w)


def conv_deep_dot(weights, stack, mxu):
  """vtc_tpu's ``deep_dot`` of ``_make_deep_dot(mxu)``: the (m, K) weights,
  as ``tier_operand`` splits them once per solve, times the (b, K, h, w)
  stack, split here per use, the weights always on the left: bf16, w b;
  bf16x3, w_hi b_hi + w_lo b_hi + w_hi b_lo; bf16x5, w_hi b_hi + w_mid
  b_hi + w_hi b_mid + w_lo b_hi + w_hi b_lo.  The products of bf16 values
  are exact; the sums are the card's tier kernel's (vtc_tpu's matrix unit
  sums in its own order): the hi x hi pass by ``precision.mma_pass``, the
  smaller passes together in float64, rounded once and added to it
  (``precision.tier_pass_sum``; tools/conv_tier_rounding.py counts the
  kernel's bits that agree).  At
  the flagship K10 at bf16x5 the kernel sat 8.3e-5 (Frobenius) from a
  plain version of float32 chains in vtc_tpu's order, where phase 46's
  control asks within 7.0e-5, a fifth of the tier's effect; summed as the
  kernel sums, 2.3e-5 (chip_smoke.py phase 48).  (Not
  ``precision.tier_dot``, whose second pass is the per-use operand's lo
  times the constant's hi.)"""
  tier = resolve_tier(mxu)
  with matmul_precision("highest"):
    if tier == "highest":
      return _product(weights[0], stack)
    b, k, h, w = stack.shape
    flat = stack.reshape(b, k, h * w)
    if tier == "bf16":
      out = mma_pass(weights[0], _bf16(flat))
    else:
      terms = split_hi_lo(flat) if tier == "bf16x3" else split3(flat)
      out = tier_pass_sum(weights, terms, TIER_PAIRS[tier], stack.dtype)
    return out.reshape(b, -1, h, w)


def _block_solve(products, images, dictionary, sparsity_weight, num_iters,
                 stepsize, kernel_stride, padding, initial_codes, variant,
                 nonneg, hard, early_stopping_epsilon, precision,
                 psum_axes=None):
  """K10's iteration in the inputs' own float type, with the block-space
  products that ``products(dictionary, geo)`` returns as (synthesize,
  analyze): img = mblk * synthesize(z), grad = analyze(img) - corr (corr =
  analyze(mask * X))."""
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  dtype, device = images.dtype, images.device
  geo = geometry(images.shape, dictionary.shape, tuple(kernel_stride))
  shrink = thresholds.select(bool(nonneg), bool(hard))
  eta = torch.as_tensor(stepsize, dtype=dtype, device=device)
  if initial_codes is None:
    z = torch.zeros((images.shape[0], geo["s"], geo["code_h"],
                     geo["code_w"]), dtype=dtype, device=device)
  else:
    z = torch.as_tensor(initial_codes, dtype=dtype, device=device)
  with matmul_precision(precision):
    synthesize, analyze = products(dictionary, geo)
    mask_img, mblk = block_mask(images.shape, padding, geo, dtype, device)
    corr = analyze(blockify(mask_img * images, geo))

    def grad_fn(z):
      return analyze(synthesize(z) * mblk) - corr

    def prox_fn(x, ss):
      return shrink(x, sparsity_weight * ss)

    return proximal_gradient_loop(
        grad_fn, prox_fn, z, eta, num_iters, variant=variant,
        early_stopping_epsilon=early_stopping_epsilon, psum_axes=psum_axes)


def _stack_products(dictionary, geo, mxu="highest"):
  """The kernel's products: the packed weights times the shifted stacks,
  at the tier ``mxu`` (``conv_deep_dot``; the weights split once)."""
  dstk, dall = pack_weights(dictionary, geo)
  if resolve_tier(mxu) == "highest":
    return (lambda z: _product(dstk, code_stack(z, geo)),
            lambda img: _product(dall, block_stack(img, geo)))
  stk, all_ = tier_operand(dstk, mxu), tier_operand(dall, mxu)
  return (lambda z: conv_deep_dot(stk, code_stack(z, geo), mxu),
          lambda img: conv_deep_dot(all_, block_stack(img, geo), mxu))


def _library_tier_products(dictionary, geo, mxu, mm):
  """The products at a tier with each pass one library product ``mm(a,
  b)`` of bf16 operands with a float32 result (cuBLAS on the card), on
  the stack materialized as a (K, b*h*w) matrix, the passes added in
  vtc_tpu's order."""
  dstk, dall = pack_weights(dictionary, geo)
  tier = resolve_tier(mxu)
  pairs = {"bf16": ((0, 0),), "bf16x3": ((0, 0), (1, 0), (0, 1)),
           "bf16x5": ((0, 0), (1, 0), (0, 1), (2, 0), (0, 2))}[tier]
  split = {"bf16": lambda x: (_bf16(x),), "bf16x3": split_hi_lo,
           "bf16x5": split3}[tier]

  def product(terms, stack):
    b, k, h, w = stack.shape
    cols = split(stack.transpose(0, 1).reshape(k, b * h * w))
    cols = [c.to(torch.bfloat16) for c in cols]
    out = None
    for i, j in pairs:
      term = mm(terms[i], cols[j])
      out = term if out is None else out + term
    return out.reshape(-1, b, h, w).transpose(0, 1)

  stk = [t.to(torch.bfloat16) for t in tier_operand(dstk, mxu)]
  all_ = [t.to(torch.bfloat16) for t in tier_operand(dall, mxu)]
  return (lambda z: product(stk, code_stack(z, geo)),
          lambda img: product(all_, block_stack(img, geo)))


def _library_products(dictionary, geo):
  """The same products as one library convolution each: with
  W[i, p, a_y, a_x] = Dpart[a][i, p] of shape (s, cpx, ay, ax), the
  analysis is conv2d(img, W) and the synthesis conv_transpose2d(z, W)."""
  w = kernel_parts(dictionary, geo).reshape(
      geo["ay"], geo["ax"], geo["s"], geo["cpx"]).permute(2, 3, 0, 1)
  w = w.contiguous()
  return (lambda z: F.conv_transpose2d(z, w), lambda img: F.conv2d(img, w))


def fused_conv_direct_plain(images, dictionary, sparsity_weight, num_iters,
                            stepsize, *, kernel_stride, padding,
                            initial_codes=None, variant="fista",
                            nonneg=False, hard=False,
                            early_stopping_epsilon=None, precision=None,
                            psum_axes=None, mxu="highest"):
  """The plain PyTorch version of K10, on any device and in the inputs'
  own float type (float64 inputs give the float64 oracle): the same
  block-space products, mask and update as the kernel.
  ``early_stopping_epsilon`` is the loop's batch-global stop test, over
  the ranks of the ``parallel.Mesh`` ``psum_axes`` where one is given
  (ops/solver.py); ``precision`` the matmul precision of
  ``ops/precision`` (default 'highest'), 'tensorfloat32' showing what
  TF32 products would cost; ``mxu`` the products' tier
  (``conv_deep_dot``; float32 inputs)."""
  return _block_solve(
      lambda d, geo: _stack_products(d, geo, mxu), images, dictionary,
      sparsity_weight, num_iters, stepsize, kernel_stride, padding,
      initial_codes, variant, nonneg, hard, early_stopping_epsilon,
      precision, psum_axes)


def fused_conv_direct_library(images, dictionary, sparsity_weight, num_iters,
                              stepsize, *, kernel_stride, padding,
                              variant="fista", nonneg=False, hard=False,
                              mxu="highest", mm=None):
  """K10's solve with each product as one library call (cuDNN on the
  card) under ``ops/precision``'s IEEE fp32 pins, or at a tier each pass
  one call ``mm(a, b)`` of bf16 operands with a float32 result (chip_smoke
  passes ``torch.mm(..., out_dtype=torch.float32)``) on the materialized
  stack: the yardstick that chip_smoke.py times beside the kernel.
  Nothing on the main path calls it."""
  if resolve_tier(mxu) == "highest":
    products = _library_products
  else:
    products = lambda d, geo: _library_tier_products(d, geo, mxu, mm)
  return _block_solve(products, images, dictionary, sparsity_weight,
                      num_iters, stepsize, kernel_stride, padding, None,
                      variant, nonneg, hard, None, None)


def build_block_update_stats(images_padded, codes, dict_shape,
                             kernel_stride, padding):
  """The dictionary-independent part of the block-space kernel gradient
  (vtc_tpu pallas_conv_direct.py:212-237): the masked image blocks, the
  code stack and the block mask.  Requires ``supported()``."""
  geo = geometry(images_padded.shape, dict_shape, tuple(kernel_stride))
  dtype, device = images_padded.dtype, images_padded.device
  with matmul_precision():
    mask_img, mblk = block_mask(images_padded.shape, padding, geo, dtype,
                                device)
    xblk = blockify(mask_img * images_padded, geo)
    zstack = code_stack(codes, geo)
  return dict(geo=geo, batch=images_padded.shape[0], xblk=xblk,
              zstack=zstack, mblk=mblk, kernel_shape=tuple(dict_shape))


def dictionary_gradient_from_block_stats(stats, dictionary, precision=None):
  """(s, c, kh, kw) batch-averaged masked-residual kernel gradient,
  equal to ops/convolutions.dictionary_gradient, as two block products
  (vtc_tpu pallas_conv_direct.py:240-252), at ``precision`` (default
  'highest')."""
  geo = stats["geo"]
  zstack = stats["zstack"]
  b, k = zstack.shape[:2]
  with matmul_precision(precision):
    dstk, _ = pack_weights(dictionary, geo)
    resid = _product(dstk, zstack) * stats["mblk"] - stats["xblk"]
    grad = torch.einsum("bpn,bkn->pk", resid.reshape(b, geo["cpx"], -1),
                        zstack.reshape(b, k, -1)) / stats["batch"]
  return unpack_dstk(grad, geo, stats["kernel_shape"])


def _require(cond, message):
  if not cond:
    raise ValueError("fused_conv_direct_solve: " + message)


def fused_conv_direct_solve(images, dictionary, sparsity_weight, num_iters,
                            stepsize, *, kernel_stride, padding,
                            initial_codes=None, variant="fista",
                            nonneg=False, hard=False,
                            early_stopping_epsilon=None, mxu="highest",
                            route="auto"):
  """Conv LASSO codes through the K10 kernel.

  Args:
    images: (b, c, H, W) float32 padded images.
    dictionary: (s, c, kh, kw) float32 kernels on the same device.
    sparsity_weight: lambda, a Python float.
    num_iters: iterations, a Python int.
    stepsize: 1/L, a float or a one-element tensor (a device tensor is
      read by the kernel, so the host never waits for it).
    kernel_stride: (sv, sh); padding: ((lv, tv), (lh, th)) or None.
    initial_codes: optional (b, s, code_h, code_w) warm start.
    variant / nonneg / hard: 'ista' | 'fista', threshold flags.
    early_stopping_epsilon: optional; stop after the first iteration k > 0
      whose mean |codes_k - codes_{k-1}| / stepsize is below it, and
      return codes_k (the batch-global test, decided on the device).  At
      a tier only where ``early_stop_supported`` holds, as in vtc_tpu
      (ValueError otherwise).
    mxu: 'highest' (IEEE fp32), 'bf16x5', 'bf16x3' or 'bf16' ('default'):
      the tier of the solve's products.
    route: the route of the tier products on the card (``route_code``):
      'auto', or one forced for checks and tools; unused on the CPU and
      at 'highest'.

  Returns:
    (b, s, code_h, code_w) codes on the inputs' device.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  mxu = resolve_tier(mxu)
  route = route_code(route)
  kernel_stride = tuple(int(x) for x in kernel_stride)
  padding = conv_shapes.normalize_padding(padding)
  _require(mxu == "highest" or early_stopping_epsilon is None
           or early_stop_supported(images.shape, dictionary.shape,
                                   kernel_stride),
           "mxu=%r with early_stopping_epsilon needs the batch in vtc_tpu's "
           "one tile (early_stop_supported()), as vtc_tpu's K10 does" % mxu)
  if images.device.type == "cpu":
    return fused_conv_direct_plain(
        images, dictionary, sparsity_weight, num_iters, stepsize,
        kernel_stride=kernel_stride, padding=padding,
        initial_codes=initial_codes, variant=variant, nonneg=nonneg,
        hard=hard, early_stopping_epsilon=early_stopping_epsilon, mxu=mxu)
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
  _require(supported(images.shape, dictionary.shape, kernel_stride),
           "geometry outside the kernel's gate (supported())")
  geo = geometry(images.shape, dictionary.shape, kernel_stride)
  b, s = images.shape[0], geo["s"]
  code_shape = (b, s, geo["code_h"], geo["code_w"])
  if initial_codes is None:
    z = torch.zeros(code_shape, dtype=torch.float32, device=device)
  else:
    _require(initial_codes.device == device
             and initial_codes.dtype == torch.float32
             and tuple(initial_codes.shape) == code_shape,
             "initial_codes must be a float32 %s tensor on the inputs' "
             "device" % (code_shape,))
    z = initial_codes.clone(memory_format=torch.contiguous_format)
  num_iters = int(num_iters)
  _require(num_iters >= 0, "num_iters must be >= 0")
  eta = torch.as_tensor(stepsize, dtype=torch.float32, device=device)
  _require(eta.numel() == 1, "stepsize must be a scalar")
  eta = eta.reshape(1).contiguous()
  if b == 0:
    return z
  with matmul_precision():
    dstk, dall = pack_weights(dictionary, geo)
    mask_img, mblk = block_mask(images.shape, padding, geo, torch.float32,
                                device)
    xblk = blockify(mask_img * images, geo).contiguous()
  return _launch(dstk, dall, mblk, xblk, eta, float(sparsity_weight),
                 num_iters, variant == "fista",
                 _MODES[(bool(nonneg), bool(hard))], geo, z,
                 eps=early_stopping_epsilon, mxu=mxu, route=route)


def stop_scratch(lib, s, positions, eps, device, steps=1, words=None):
  """The conv C entries' early-stop arguments for ``steps`` solves in a
  row of s codes at ``positions`` code positions (b * code_h * code_w):
  (eps, the zeroed words of ``vtc_conv_stop_words``, or ``words`` of
  them where given, the counts (steps,) int32).  eps None is the build
  without the stop: (-1.0, None, None).  A negative or NaN eps never
  stops, as in the plain loop."""
  if eps is None:
    return -1.0, None, None
  if words is None:
    words = lib.vtc_conv_stop_words(s, positions)
  return (float(eps), torch.zeros(words, dtype=torch.int64, device=device),
          torch.zeros(steps, dtype=torch.int32, device=device))


def ptr(t):
  """A tensor's device pointer, or None for None."""
  return None if t is None else t.data_ptr()


def route_code(route):
  """The C entries' code of a tier products' route: 'auto' (the plan's),
  or 'gather' / 'window' forced, for checks and tools (a product the
  forced route cannot take fails with its CUDA error: no route gives way
  to another).  ValueError for another name."""
  if route not in TIER_ROUTES:
    raise ValueError("route must be one of %s, got %r" % (
        tuple(TIER_ROUTES), route))
  return TIER_ROUTES[route]


def tier_route_launches():
  """{'gather': n, 'window': n}: the tier products every conv entry of the
  library launched on each route since ``reset_tier_route_launches``."""
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  return {name: int(lib.vtc_conv_tier_route_launches(code))
          for code, name in _ROUTE_NAMES.items()}


def reset_tier_route_launches():
  from vtc_tpu_torch.ops._build import load_library
  load_library().vtc_conv_tier_reset_route_launches()


def card_tier_plan(m, k, src_c, off_w, out_h, out_w, nb, mxu, sm_count=0):
  """The library's ``conv_tier_plan`` (sm_count 0: this card's), as
  ``conv_tier_plan`` gives it."""
  from vtc_tpu_torch.ops._build import load_library
  out = (ctypes.c_int64 * 6)()
  load_library().vtc_conv_tier_plan(m, k, src_c, off_w, out_h, out_w, nb,
                                    TIER_CODES[resolve_tier(mxu)], sm_count,
                                    out)
  keys = ("route", "rows", "mblocks", "tiles", "grid", "smem")
  plan = dict(zip(keys, (int(v) for v in out)))
  plan["route"] = _ROUTE_NAMES[plan["route"]]
  return plan


_EPILOGUES = {"store": 0, "mask_store": 1, "prox": 5, "mask_resid": 6}


def tier_product(a, src, out_hw, off_w, sign, mxu, route="auto",
                 epilogue="store", off=(0, 0), mask=None, z=None, corr=None,
                 extra=None, old=None, eta=None, lam=0.0, beta=0.0,
                 fista=False, shrink=0, stop=None):
  """One tier GEMM on the card, for checks and tools: C[b, m, y, x] =
  sum_k a[m, k] src[b, k % c, sign (o // off_w) + off[0] + y, sign (o %
  off_w) + off[1] + x] (o = k // c, zeros outside src) at tier mxu on
  ``route``, with the epilogue ('store', 'mask_store', 'prox',
  'mask_resid') of conv_gemm.cuh and its inputs: mask (m, out_h, out_w),
  z (the codes read; 'prox' writes the next ones into the returned
  tensor), corr, extra, old (read and written in place), eta (1,) on the
  device, lam, beta, fista, shrink.  stop: (words, iters, eps, inv_count,
  it) for the STOP build of a 'prox' product.  Returns the output (nb, m,
  out_h, out_w); raises on the launch's CUDA error."""
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  _require(a.is_cuda and src.is_cuda, "tier_product runs on the card")
  m, k = a.shape
  nb, c, hh, ww = src.shape
  out_h, out_w = out_hw
  tier = TIER_CODES[resolve_tier(mxu)]
  planes = torch.empty(int(lib.vtc_conv_tier_product_words(tier, m, k)),
                       dtype=torch.int32, device=a.device)
  out = torch.empty((nb, m, out_h, out_w), dtype=torch.float32,
                    device=a.device)
  words, iters, eps, inv_count, it = stop or (None, None, -1.0, 0.0, 0)
  with torch.cuda.device(a.device):
    err = lib.vtc_conv_tier_product(
        route_code(route), tier, a.data_ptr(), m, k, src.data_ptr(), c, hh,
        ww, off_w, sign, off[0], off[1], nb, out_h, out_w,
        _EPILOGUES[epilogue], out.data_ptr(), ptr(mask), ptr(z), ptr(corr),
        ptr(extra), ptr(old), ptr(eta), ctypes.c_float(lam),
        ctypes.c_float(beta), int(fista), int(shrink), planes.data_ptr(),
        ptr(words), ptr(iters), ctypes.c_float(eps),
        ctypes.c_float(inv_count), int(it),
        torch.cuda.current_stream(a.device).cuda_stream)
  if err != 0:
    raise RuntimeError("tier product on route %r failed with CUDA error %d "
                       "(m=%d, k=%d, c=%d, %dx%d, mxu=%s)" % (
                           route, err, m, k, c, out_h, out_w, mxu))
  return out


def _launch(dstk, dall, mblk, xblk, eta, lam, num_iters, fista, mode, geo,
            z, eps=None, mxu="highest", route=0):
  """Allocate the kernel's scratch and enqueue the solve on the current
  stream; eps the early stop's threshold (None: none), mxu the resolved
  tier, route its products' ``route_code``."""
  global launches, tier_launches, last_iters
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  device = z.device
  b = z.shape[0]
  tier, planes = tier_scratch(lib, mxu, geo, device,
                              "fused_conv_direct_solve")
  positions = b * geo["code_h"] * geo["code_w"]
  eps, words, iters = stop_scratch(lib, geo["s"], positions, eps, device)
  img = torch.empty_like(xblk)
  corr = torch.empty_like(z)
  old = z.clone()
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_conv_direct(
        dstk.data_ptr(), dall.data_ptr(), mblk.data_ptr(), xblk.data_ptr(),
        eta.data_ptr(), ctypes.c_float(lam), num_iters, b, geo["s"],
        geo["cpx"], geo["ay"], geo["ax"], geo["bh"], geo["bw"], int(fista),
        mode, img.data_ptr(), corr.data_ptr(), z.data_ptr(), old.data_ptr(),
        ctypes.c_float(eps), ctypes.c_float(1.0 / (positions * geo["s"])),
        ptr(words), ptr(iters), tier, ptr(planes), route, stream)
  if err != 0:
    raise RuntimeError(
        "conv direct kernel launch failed with CUDA error %d (b=%d, s=%d, "
        "cpx=%d, R=%d, mxu=%s%s)" % (err, b, geo["s"], geo["cpx"], geo["r"],
                                     mxu, "" if words is None
                                     else ", early stop"))
  launches += 1
  tier_launches += tier != 0
  if iters is not None:
    last_iters = iters
  return old
