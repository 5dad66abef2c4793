"""Matmul-precision policy: counterpart of vtc_tpu/ops/precision.py:1-35.

The repo's parity contract (codes within 1e-4 of the float64 oracle)
needs IEEE float32 products.  On Hopper three switches can quietly drop
float32 matmuls or convolutions to TF32; this module pins all three and
sets them when it is imported:

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")

``VTC_MATMUL_PRECISION`` overrides the default with the JAX package's
spellings ('highest' | 'float32' | 'tensorfloat32' | 'bfloat16'); anything
but the first two gives up parity grade.
"""
import contextlib
import os

import torch
import torch.nn.functional as F

# JAX precision spelling -> torch.set_float32_matmul_precision value
_SPELLINGS = {
    "highest": "highest",
    "float32": "highest",
    "tensorfloat32": "high",
    "bfloat16": "medium",
}


def _resolve(precision):
  if precision not in _SPELLINGS:
    raise ValueError(
        "unknown matmul precision %r; expected one of %s"
        % (precision, sorted(_SPELLINGS)))
  return _SPELLINGS[precision]


_DEFAULT = os.environ.get("VTC_MATMUL_PRECISION", "highest")
_resolve(_DEFAULT)


def _apply(torch_precision):
  ieee = torch_precision == "highest"
  torch.backends.cuda.matmul.allow_tf32 = not ieee
  torch.backends.cudnn.allow_tf32 = not ieee
  torch.set_float32_matmul_precision(torch_precision)


@contextlib.contextmanager
def matmul_precision(precision=None):
  """Pin the three float32 switches for the body, then restore them."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
  _apply(_resolve(_DEFAULT if precision is None else precision))
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


_apply(_resolve(_DEFAULT))


# The MXU tiers of the fc/subspace solve (vtc_tpu/ops/pallas_train_step.py
# :103-199): the spelling each entry accepts, resolved to the kernel's own.
# 'default' is the solvers' and the encode's name for 'bf16'
# (vtc_tpu/analysis_transforms/fully_connected/ista_fista.py:116-117).
TIERS = ("highest", "bf16x5", "bf16x3", "bf16")
# the C entries' tier argument (csrc/fista_tier.cuh's Tier)
TIER_CODES = {"highest": 0, "bf16": 1, "bf16x3": 2, "bf16x5": 3}


def resolve_tier(mxu):
  """The tier named by ``mxu`` ('default' is 'bf16'); ValueError on an
  unknown name."""
  tier = "bf16" if mxu == "default" else mxu
  if tier not in TIERS:
    raise ValueError("unknown MXU tier %r; expected one of %s or 'default'"
                     % (mxu, TIERS))
  return tier


def _bf16(x):
  """x rounded to bfloat16 (to nearest even), as values of x's type."""
  return x.to(torch.bfloat16).to(x.dtype)


def split_hi_lo(x):
  """bf16 hi + lo of x (vtc_tpu ``_split_hi_lo``, pallas_train_step.py
  :103-108): hi + lo carries about 16 significand bits of x.  The terms
  are returned as values of x's type."""
  hi = _bf16(x)
  return hi, _bf16(x - hi)


def split3(x):
  """The exact three-term bf16 split of float32 x (vtc_tpu ``_split3``,
  :111-126): hi + mid + lo == x, each residual taken in float32."""
  hi = _bf16(x)
  r = x - hi
  mid = _bf16(r)
  return hi, mid, _bf16(r - mid)


# vtc_tpu's XLA spellings of a matmul precision and the tier of bf16 passes
# the TPU computes for each (vtc_tpu/training/ica.py:126-128: the scanned
# ICA trainer's per-step path tiers its refreshes and codes this way):
# 'tensorfloat32' is the 3-pass bf16x3 product and 'bfloat16' the single
# pass.  XLA has no 5-pass precision.  Not torch's meaning of the same
# names above: TF32 is a product that vtc_tpu never computes.
XLA_TIERS = {"highest": "highest", "float32": "highest",
             "tensorfloat32": "bf16x3", "bfloat16": "bf16"}


def xla_tier(precision):
  """The tier of passes that the TPU runs for vtc_tpu's XLA ``precision``
  (None: 'highest')."""
  precision = "highest" if precision is None else precision
  if precision not in XLA_TIERS:
    raise ValueError("unknown matmul precision %r; expected one of %s"
                     % (precision, sorted(XLA_TIERS)))
  return XLA_TIERS[precision]


# the depth of one tensor-core product (mma.sync m16n8k16)
_MMA_DEPTH = 16


def mma_pass(a, b):
  """a @ b (a (..., M, K), b (..., K, N), batch dims broadcast) of bf16
  values as the card's tensor cores sum one pass: in 16-deep chunks from k
  = 0, each chunk's exact sum rounded toward zero to a's float type (the
  rounding of one m16n8k16 product, tools/conv_tier_rounding.py), the
  chunks added in that type in order, rounding to nearest."""
  batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
  a = a.expand(*batch, *a.shape[-2:])
  b = b.expand(*batch, *b.shape[-2:])
  k = a.shape[-1]
  q = -(-k // _MMA_DEPTH)
  pad = q * _MMA_DEPTH - k
  aq = F.pad(a.double(), (0, pad)).unflatten(-1, (q, _MMA_DEPTH)).movedim(
      -2, 0)
  bq = F.pad(b.double(), (0, 0, 0, pad)).unflatten(
      -2, (q, _MMA_DEPTH)).movedim(-3, 0)
  exact = aq @ bq
  parts = exact.to(a.dtype)
  parts = torch.where(parts.double().abs() > exact.abs(),
                      torch.nextafter(parts, torch.zeros_like(parts)), parts)
  acc = parts[0]
  for part in parts[1:]:
    acc = acc + part
  return acc


def tier_pass_sum(a_terms, b_terms, pairs, dtype):
  """The passes of a tier product: the hi x hi pass by ``mma_pass`` plus
  the smaller passes ``pairs`` ((i, j): a_terms[i] b_terms[j]) summed
  together in float64 and rounded once to ``dtype``.  The card's tier
  kernels keep the hi x hi pass in one accumulator and the smaller passes
  in a second, added at the end; summed so, the plain version agrees with
  them where float32 chains in vtc_tpu's order did not (PERF.md §6, PR
  22)."""
  lo = sum(a_terms[i].double() @ b_terms[j].double() for i, j in pairs)
  return mma_pass(a_terms[0], b_terms[0]) + lo.to(dtype)


# the smaller passes (i, j) of a tier, after hi x hi, in vtc_tpu's order
TIER_PAIRS = {"bf16x3": ((1, 0), (0, 1)),
              "bf16x5": ((1, 0), (0, 1), (2, 0), (0, 2))}


def ns_dot(a, b, mxu, precision=None):
  """a @ b at the tier ``mxu``, both operands split per product (vtc_tpu
  ``_make_ns_dot``, pallas_ica_train.py:57-83): bf16, bf16(a) bf16(b);
  bf16x3, a_hi b_hi + a_lo b_hi + a_hi b_lo; bf16x5, a1 b1 + a2 b1 + a1 b2
  + a3 b1 + a1 b3 (the exact split).  The sums are the card's
  (``tier_pass_sum``).  At 'highest' one float32 product at the matmul
  ``precision`` (default 'highest'; 'tensorfloat32' shows what TF32
  products would cost)."""
  tier = resolve_tier(mxu)
  if tier == "highest":
    with matmul_precision(precision):
      return a @ b
  with matmul_precision("highest"):
    if tier == "bf16":
      return mma_pass(_bf16(a), _bf16(b))
    split = split_hi_lo if tier == "bf16x3" else split3
    return tier_pass_sum(split(a), split(b), TIER_PAIRS[tier], a.dtype)


def split_k_dot(a, b, mxu, chunk):
  """a @ b at the tier ``mxu`` taken ``chunk`` values of k at a time, each
  chunk's product ``ns_dot``'s from zero, the chunks' products added in
  order: K19's split-K reconstruction z D on the card (a kSplitK chunk a
  partial, csrc/code_shard_solve.cuh's phase A, the partials added in
  chunk order by its phase S)."""
  out = None
  for k0 in range(0, a.shape[-1], int(chunk)):
    part = ns_dot(a[..., k0:k0 + chunk], b[..., k0:k0 + chunk, :], mxu)
    out = part if out is None else out + part
  return out


def tier_operand(g, mxu):
  """The iteration operand of ``tier_dot`` for the (s, s) -eta G, formed
  once per solve (vtc_tpu ``prep_gram`` of ``_make_iter_dot``, :129-169):
  a tuple of its bf16 terms at the tier, (g,) at 'highest'."""
  tier = resolve_tier(mxu)
  if tier == "highest":
    return (g,)
  if tier == "bf16":
    return (_bf16(g),)
  return split_hi_lo(g) if tier == "bf16x3" else split3(g)


def tier_dot(z, operand, mxu):
  """z @ (-eta G) at the tier (vtc_tpu ``iter_dot``): single-pass bf16
  products summed in float32, in vtc_tpu's order.  Each pass is a float32
  product of bf16 values, which is exact in float32 per term; TF32 is
  off, so only the sums' order differs from the TPU's passes."""
  tier = resolve_tier(mxu)
  with matmul_precision("highest"):
    if tier == "highest":
      return z @ operand[0]
    if tier == "bf16":
      return _bf16(z) @ operand[0]
    if tier == "bf16x3":
      g_hi, g_lo = operand
      z_hi, z_lo = split_hi_lo(z)
      return z_hi @ g_hi + z_lo @ g_hi + z_hi @ g_lo
    g_hi, g_mid, g_lo = operand
    z_hi, z_mid, z_lo = split3(z)
    return (z_hi @ g_hi + z_mid @ g_hi + z_hi @ g_mid + z_lo @ g_hi
            + z_hi @ g_lo)


def bf16_pass(a, b_t):
  """a @ b_t.T as one bf16 pass (vtc_tpu ``_dot_t_b``): both operands
  rounded to bf16, the product in float32 with TF32 off.  The trainers'
  c = X D^T at 'bf16' (pallas_train_step.py:411, :588)."""
  with matmul_precision("highest"):
    return _bf16(a) @ _bf16(b_t).T


def prox_window_exact(group_size, mxu):
  """Whether the group prox sums its windows as one float32 sum at this
  tier: at 'highest' (the port's own prox), and at every tier for a
  power-of-two window M, where vtc_tpu's rotate-and-add prox sums in
  float32 (``roll_prox_window``, :218-245).  Otherwise the tiers take
  ``_make_prox_dots``' passes (:172-199): ``prox_sums`` and
  ``prox_scale``."""
  m = int(group_size)
  return m & (m - 1) == 0 or resolve_tier(mxu) == "highest"


def prox_sums(sq, mxu):
  """The window sums of squares sq (..., M) at a tier (vtc_tpu ``pdot``
  against the 0/1 membership operand): each bf16 term of sq summed over
  the window, the terms' sums added in order (bf16x5 takes the exact
  three-term split, bf16x3 hi and lo, bf16 one term)."""
  tier = resolve_tier(mxu)
  terms = ((_bf16(sq),) if tier == "bf16" else
           split_hi_lo(sq) if tier == "bf16x3" else split3(sq))
  total = torch.sum(terms[0], dim=-1, keepdim=True)
  for term in terms[1:]:
    total = total + torch.sum(term, dim=-1, keepdim=True)
  return total


def prox_scale(scale, mxu):
  """A group's scale as its slots receive it at a tier (vtc_tpu
  ``pdot_t``, the broadcast against the 0/1 operand): bf16(scale), hi +
  lo, or at bf16x5 the exact split's sum, the scale itself."""
  tier = resolve_tier(mxu)
  if tier == "bf16":
    return _bf16(scale)
  if tier == "bf16x3":
    hi, lo = split_hi_lo(scale)
    return hi + lo
  return scale
