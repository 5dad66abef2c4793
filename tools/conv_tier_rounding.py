"""How the conv tier kernel's sums round, on one CUDA device.

  python3 tools/conv_tier_rounding.py [--seeds 8] [--out report.txt]

Prints, with the card's name and power limit:

* the fraction of 16-deep products of bf16 operands that torch.mm (the
  tensor cores, a float32 result) returns rounded to nearest and rounded
  toward zero from the exact sum;
* K10's corr (one iteration from zero codes, lambda 0, stepsize 1: the
  codes are A(mask * X)) at each tier on chip_smoke.py's flagship images:
  the fraction of values bitwise equal to the plain version's
  (ops/fused_conv_direct.conv_deep_dot) and to a plain version of float32
  chains in vtc_tpu's order;
* for ``--seeds`` image seeds, K10 at b 40 FISTA 100 at bf16: the kernel's
  max |d| from the plain version and the plain version's own under five
  one-ulp nudges of the input, and of the input and the dictionary, each
  over the largest code (chip_smoke.py's CONV_TIER_FLOOR reads them).

Every line is printed, and written to --out when given.  Needs a CUDA
device (and nvcc, to build the kernels at first use).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from vtc_tpu_torch import convert  # noqa: E402
from vtc_tpu_torch.ops import convolutions as conv_ops  # noqa: E402
from vtc_tpu_torch.ops import fused_conv_direct as K10  # noqa: E402
from vtc_tpu_torch.ops import lipschitz, precision  # noqa: E402


def chain_products(terms, stack, tier):
  """The passes as float32 chains added in vtc_tpu's order."""
  split = {"bf16": lambda x: (precision._bf16(x),),
           "bf16x3": precision.split_hi_lo, "bf16x5": precision.split3}[tier]
  pairs = {"bf16": ((0, 0),), "bf16x3": ((0, 0), (1, 0), (0, 1)),
           "bf16x5": ((0, 0), (1, 0), (0, 1), (2, 0), (0, 2))}[tier]
  cols = split(stack)
  out = None
  for i, j in pairs:
    term = K10._product(terms[i], cols[j])
    out = term if out is None else out + term
  return out


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--seeds", type=int, default=8)
  parser.add_argument("--out", help="also write the report here")
  args = parser.parse_args()
  if not torch.cuda.is_available():
    print("conv_tier_rounding: no CUDA device", file=sys.stderr)
    return 1
  lines = []

  def say(text):
    print(text, flush=True)
    lines.append(text)

  dev = torch.device("cuda", 0)
  torch.backends.cuda.matmul.allow_tf32 = False
  g = torch.Generator(device=dev).manual_seed(0)
  a = torch.randn(256, 16, device=dev, generator=g).to(torch.bfloat16)
  b = torch.randn(16, 4096, device=dev, generator=g).to(torch.bfloat16)
  exact = a.double() @ b.double()
  nearest = exact.float()
  toward0 = torch.where(nearest.double().abs() > exact.abs(),
                        torch.nextafter(nearest, torch.zeros_like(nearest)),
                        nearest)
  got = torch.mm(a, b, out_dtype=torch.float32)
  say("torch.mm bf16 K 16: rounded to nearest %.4f, toward zero %.4f" % (
      float((got == nearest).float().mean()),
      float((got == toward0).float().mean())))
  gen = C.windowed_kernels(np.random.RandomState(0), C.CONV_S, 1, C.CONV_K)
  d = convert.dictionary_from_numpy(gen, dev)
  eta = lipschitz.fista_stepsize(d.reshape(C.CONV_S, -1))
  kw = dict(kernel_stride=(C.CONV_STRIDE, C.CONV_STRIDE),
            padding=((8, 8), (8, 8)))
  images, _ = C.conv_images(torch, conv_ops, dev, C.CONV_BATCH, gen,
                            C.CONV_STRIDE, C.CONV_IMG, seed=0)
  x = torch.tensor(images, device=dev)
  geo = K10.geometry(x.shape, d.shape, kw["kernel_stride"])
  _, dall = K10.pack_weights(d, geo)
  mask_img, _ = K10.block_mask(x.shape, kw["padding"], geo, torch.float32,
                               dev)
  stack = K10.block_stack(K10.blockify(mask_img * x, geo), geo)
  for tier in C.TIER_NAMES:
    corr = K10.fused_conv_direct_solve(x, d, 0.0, 1, 1.0, mxu=tier, **kw)
    terms = precision.tier_operand(dall, tier)
    with precision.matmul_precision("highest"):
      plain = K10.conv_deep_dot(terms, stack, tier)
      chain = chain_products(terms, stack, tier)
    say("K10 corr at %s: bitwise equal to the plain version %.4f, to float32"
        " chains in vtc_tpu's order %.4f" % (
            tier, float((corr == plain).float().mean()),
            float((corr == chain).float().mean())))
  for seed in range(args.seeds):
    images, _ = C.conv_images(torch, conv_ops, dev, C.CONV_BATCH, gen,
                              C.CONV_STRIDE, C.CONV_IMG, seed=seed)
    x = torch.tensor(images, device=dev)

    def plain(xx, dd):
      return K10.fused_conv_direct_plain(xx, dd, C.CONV_LAM, C.CONV_ITERS, eta,
                                         mxu="bf16", **kw)

    want = plain(x, d)
    top = float(want.abs().max())
    kern = float((K10.fused_conv_direct_solve(
        x, d, C.CONV_LAM, C.CONV_ITERS, eta, mxu="bf16", **kw)
                  - want).abs().max())
    inputs = max(float((plain(C.one_ulp_nudge(x, s), d) - want).abs().max())
                 for s in range(5))
    both = max(float((plain(C.one_ulp_nudge(x, s),
                            C.one_ulp_nudge(d, s + 5)) - want).abs().max())
               for s in range(5))
    say("K10 b40 fista100 bf16 seed %d: max|d| over the largest code %.3e "
        "(kernel), %.3e (nudged input), %.3e (nudged input and dictionary)"
        % (seed, kern / top, inputs / top, both / top))
  say(C.card_line())
  if args.out:
    with open(args.out, "w") as f:
      f.write("\n".join(lines) + "\n")
  return 0


if __name__ == "__main__":
  sys.exit(main())
