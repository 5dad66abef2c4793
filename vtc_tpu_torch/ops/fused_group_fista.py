"""Fused subspace (group) ISTA/FISTA solve: the port of TPU kernel K4,
``group_fista_solve_pallas`` (vtc_tpu/ops/pallas_group_fista.py:168-259),
with its group prox K5 (``_make_group_prox``,
vtc_tpu/ops/pallas_train_step.py:248-322) inside.

The codes are the packed (b, G*M) grouped tensor of
``subspace_ista_fista``: group g holds slots [g*M, (g+1)*M) against the
rows of the grouped dictionary Dg (G*M, n), and the slots a short group
pads hold exact zeros (zero rows of Dg give zero rows of G = Dg Dg^T and
zero columns of c = X Dg^T).  So the group prox needs only M: the
window of M slots is the group, and the JAX kernel's membership operand
(``membership_matrix``) has no counterpart here.

``fused_group_fista_solve`` computes G and c with ``torch.matmul`` under
the precision pins, outside the kernel, as pallas_group_fista.py:214-216
does.  Then:

* a CUDA tensor launches the hand-written kernel in
  ``vtc_tpu_torch/csrc/fused_group_fista.cu`` (K1's iteration with the
  group prox as its epilogue; built at first use by ``ops/_build.py``)
  on the current stream, or raises.  Like K1 it takes the classic, the
  cluster or the wide kernel by ``fused_fista.solve_route``;
  ``last_route`` is the route of the last launch;
* a CPU tensor runs ``fused_group_fista_plain``, which is also the 'gram'
  formulation of ``subspace_ista_fista`` and what ``chip_smoke.py`` holds
  the kernel against on the card.

``early_stopping_epsilon`` runs vtc_tpu's batch-global stop test
(pallas_group_fista.py:105-130, the mean over the b*G*M packed entries)
inside the kernels, on K1's stop routes (``fused_fista.stop_route``);
``last_iters`` (a private test hook) is the device tensor of the
iterations the last stopped launch ran.

``mxu`` is vtc_tpu's tier (pallas_group_fista.py:54-66), as in
``fused_fista``: a tier other than 'highest' takes ``fused_fista``'s tier
routes (csrc/fista_tier.cuh): the resident 'tier_cluster' or 'tier_wide'
layout at M in {1, 2, 4} (the group prox in registers), else
``fista_tier_kernel`` ('tier').  Its group prox sums the windows in
float32 where M is a power of two (vtc_tpu's rotate-and-add prox) or the
tier is 'bf16x5'; at other M, 'bf16x3' and 'bf16' round the window sums
and the scale as vtc_tpu's ``_make_prox_dots`` (``precision.prox_sums``,
``prox_scale``).  ``launches`` counts kernel launches.
"""
import ctypes

import torch

from vtc_tpu_torch.ops import fused_fista, thresholds
from vtc_tpu_torch.ops.precision import (TIER_CODES, bf16_pass,
                                         matmul_precision, prox_scale,
                                         prox_sums, prox_window_exact,
                                         resolve_tier, tier_dot,
                                         tier_operand)
from vtc_tpu_torch.ops.solver import proximal_gradient_loop

launches = 0
tier_launches = 0  # the launches above at a tier other than 'highest'
last_route = None
last_iters = None


def group_prox(x, group_size, t, hard, mxu="highest"):
  """The group prox on packed (b, G*M) codes at threshold ``t``: soft
  is ``thresholds.group_shrink`` over each window of ``group_size``
  slots; hard zeroes the groups whose norm is below ``t``.  At 'bf16x3'
  and 'bf16' with M not a power of two, the window sums of the squares and
  the scale the slots receive take vtc_tpu's ``_make_prox_dots`` rounding
  (pallas_train_step.py:172-199, :305-320)."""
  grouped = x.reshape(x.shape[0], -1, group_size)
  if prox_window_exact(group_size, mxu):
    norms = torch.linalg.vector_norm(grouped, dim=2, keepdim=True)
    if hard:
      out = torch.where(norms < t, 0.0, grouped)
    else:
      out = thresholds.group_shrink(grouped, norms, t)
    return out.reshape(x.shape)
  norms = torch.sqrt(prox_sums(grouped * grouped, mxu))
  if hard:
    scale = torch.where(norms < t, 0.0, 1.0).to(x.dtype)
  else:
    safe = torch.where(norms == 0.0, 1.0, norms)
    scale = torch.clamp(1.0 - t / safe, min=0.0)
  return (grouped * prox_scale(scale, mxu)).reshape(x.shape)


def group_early_stop_tile_fits(batch_size, gm, g):
  """vtc_tpu's ``group_early_stop_tile_fits`` (pallas_group_fista.py
  :148-158) for b rows of gm = G*M packed slots in g groups: whether its K4
  takes a stop in-kernel; the port's subspace solver reads it for a tier
  with a stop, as ``fused_fista.early_stop_tile_fits``."""
  lanes, sublanes = fused_fista._TPU_LANES, fused_fista._TPU_SUBLANES
  gm_pad = -(-int(gm) // lanes) * lanes
  g_pad = -(-int(g) // lanes) * lanes
  b_pad = -(-int(batch_size) // sublanes) * sublanes
  return 4 * (gm_pad * gm_pad + gm_pad * g_pad + 6 * b_pad * gm_pad) <= (
      fused_fista._EARLY_STOP_VMEM_BUDGET)


def fused_group_fista_plain(images, grouped_dictionary, group_size,
                            sparsity_weight, num_iters, stepsize, *,
                            initial_grouped=None, variant="fista",
                            hard=False, early_stopping_epsilon=None,
                            precision=None, psum_axes=None,
                            stop_count=None, mxu="highest",
                            bf16_corr=False):
  """The plain PyTorch version of the fused group solve, on any device
  and in the inputs' own float type (float64 inputs give the oracle).

  The gram loop of ``ops/solver.proximal_gradient_loop`` with the
  stepsize folded in, as vtc_tpu subspace_ista_fista.py:95-119 and the
  kernel associate it: codes = prox((z + z @ (-eta G)) + eta c,
  lam * eta), the prox on the (b, G, M) view.  ``early_stopping_epsilon``
  is the loop's batch-global stop test, its mean over the b*G*M entries
  (over ``psum_axes``'s ranks and as ``stop_count``'s sum, ops/solver,
  where given).
  ``precision``: the matmul precision of ``ops/precision`` (default
  'highest'); 'tensorfloat32' shows what TF32 products would cost.
  ``mxu``: the tier of the iteration product and the group prox, and
  ``bf16_corr`` c as one bf16 pass, as ``fused_fista_plain``'s.

  Returns:
    (b, G*M) packed grouped codes.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  mxu = resolve_tier(mxu)
  dtype, device = images.dtype, images.device
  eta = torch.as_tensor(stepsize, dtype=dtype, device=device)
  if initial_grouped is None:
    z = torch.zeros((images.shape[0], grouped_dictionary.shape[0]),
                    dtype=dtype, device=device)
  else:
    z = torch.as_tensor(initial_grouped, dtype=dtype, device=device)
  with matmul_precision(precision):
    neg_eta_gram = -eta * (grouped_dictionary @ grouped_dictionary.T)
    corr = (bf16_pass(images, grouped_dictionary) if bf16_corr
            else images @ grouped_dictionary.T)
    corr_eta = eta * corr
    operand = tier_operand(neg_eta_gram, mxu)

    def prestep_fn(z):
      if mxu == "highest":
        return z + z @ neg_eta_gram + corr_eta
      return z + tier_dot(z, operand, mxu) + corr_eta

    def prox_fn(x, ss):
      return group_prox(x, group_size, sparsity_weight * ss, hard, mxu)

    return proximal_gradient_loop(
        None, prox_fn, z, eta, num_iters, variant=variant,
        early_stopping_epsilon=early_stopping_epsilon,
        prestep_fn=prestep_fn, psum_axes=psum_axes,
        stop_count=stop_count)


def _require(cond, message):
  if not cond:
    raise ValueError("fused_group_fista_solve: " + message)


def fused_group_fista_solve(images, grouped_dictionary, group_size,
                            sparsity_weight, num_iters, stepsize, *,
                            initial_grouped=None, variant="fista",
                            hard=False, early_stopping_epsilon=None,
                            mxu="highest"):
  """Solve the packed group-LASSO codes with the fused kernel.

  Args:
    images: (b, n) float32 tensor.
    grouped_dictionary: (G*M, n) float32 grouped dictionary on the same
      device (``subspace_ista_fista.build_grouped_dictionary``).
    group_size: M, the packed window of one group.
    sparsity_weight: lambda, a Python float.
    num_iters: iterations, a Python int (a runtime argument of the
      kernel).
    stepsize: 1/L, a float or a one-element tensor; a device tensor is
      read by the kernel itself.
    initial_grouped: optional (b, G*M) packed warm start (seeds z and
      old), zero in the padded slots.
    variant / hard: 'ista' | 'fista', hard group thresholding.
    early_stopping_epsilon: optional; the batch-global stop test over the
      b*G*M packed entries, decided on the device (as fused_fista_solve's).
    mxu: the tier, as fused_fista_solve's ('default' is 'bf16').

  Returns:
    (b, G*M) packed grouped codes on the inputs' device.
  """
  if variant not in ("ista", "fista"):
    raise ValueError("variant must be 'ista' or 'fista'")
  mxu = resolve_tier(mxu)
  group_size = int(group_size)
  _require(group_size >= 1 and grouped_dictionary.dim() == 2
           and grouped_dictionary.shape[0] % group_size == 0,
           "the grouped dictionary's rows must be whole groups of %d"
           % group_size)
  if images.device.type == "cpu":
    return fused_group_fista_plain(
        images, grouped_dictionary, group_size, sparsity_weight, num_iters,
        stepsize, initial_grouped=initial_grouped, variant=variant,
        hard=hard, early_stopping_epsilon=early_stopping_epsilon, mxu=mxu)
  _require(images.device.type == "cuda",
           "tensors must be on the CPU or a CUDA device, got "
           + str(images.device))
  device = images.device
  _require(grouped_dictionary.device == device,
           "grouped dictionary on another device")
  _require(images.dtype == torch.float32
           and grouped_dictionary.dtype == torch.float32,
           "inputs must be float32")
  _require(images.dim() == 2 and images.shape[1] == grouped_dictionary.shape[1],
           "shapes must be (b, n) and (G*M, n), got %s and %s"
           % (tuple(images.shape), tuple(grouped_dictionary.shape)))
  b, gm = images.shape[0], grouped_dictionary.shape[0]
  _require(gm > 0, "grouped dictionary has no rows")
  if initial_grouped is not None:
    _require(initial_grouped.device == device
             and initial_grouped.dtype == torch.float32
             and tuple(initial_grouped.shape) == (b, gm)
             and initial_grouped.is_contiguous(),
             "initial_grouped must be a contiguous float32 (b, G*M) tensor "
             "on the inputs' device")
  num_iters = int(num_iters)
  _require(num_iters >= 0, "num_iters must be >= 0")
  eta = torch.as_tensor(stepsize, dtype=torch.float32, device=device)
  _require(eta.numel() == 1, "stepsize must be a scalar")
  eta = eta.reshape(1).contiguous()
  if b == 0:
    return torch.empty((0, gm), dtype=torch.float32, device=device)

  with matmul_precision():
    gram = (grouped_dictionary @ grouped_dictionary.T).contiguous()
    corr = (images @ grouped_dictionary.T).contiguous()
  return _launch(gram, corr, initial_grouped, eta, float(sparsity_weight),
                 num_iters, group_size, variant == "fista", bool(hard),
                 eps=early_stopping_epsilon, mxu=mxu)


def route_launches():
  """{route name: solves launched} of the library's group solve entry
  (K4's, which K6, K7 and K16 call for their solves) since the last
  fused_fista.reset_route_launches."""
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  return {name: int(lib.vtc_group_fista_route_launches(code))
          for code, name in fused_fista.ROUTE_NAMES.items()}


def _launch(gram, corr, init, eta, lam, num_iters, group_size, fista, hard,
            route="auto", eps=None, mxu="highest"):
  """Allocate the kernel's scratch and launch it on the current stream.
  route 'classic', 'cluster' or 'wide' (at 'highest') or one of
  fused_fista.TIER_ROUTES (at another tier) forces a kernel, for checks
  and tools (fused_fista.solve_route and tier_route are the rules 'auto'
  follows); eps the stop's threshold (None: none); mxu the tier."""
  global launches, last_route, last_iters, tier_launches
  fused_fista.check_route(route, mxu)
  from vtc_tpu_torch.ops._build import load_library
  lib = load_library()
  b, gm = corr.shape
  device = corr.device
  eps, words, iters, classic = fused_fista.stop_scratch(
      lib, b, gm, group_size, route, eps, device, mxu=mxu)
  sk, sc, gn, state = fused_fista.solve_scratch(lib, b, gm, mxu, classic,
                                                device)
  out = torch.empty((b, gm), dtype=torch.float32, device=device)
  taken = ctypes.c_int(0)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.vtc_fused_group_fista(
        gram.data_ptr(), corr.data_ptr(),
        None if init is None else init.data_ptr(), eta.data_ptr(),
        ctypes.c_float(lam), num_iters, b, gm, group_size, sk, sc,
        int(fista), int(hard), gn.data_ptr(),
        None if state is None else state.data_ptr(), out.data_ptr(),
        fused_fista.route_code(route), ctypes.byref(taken), ctypes.c_float(eps),
        ctypes.c_float(1.0 / (b * gm)),
        None if words is None else words.data_ptr(),
        None if iters is None else iters.data_ptr(), 1, None, None,
        TIER_CODES[mxu], stream)
  if err != 0:
    raise RuntimeError(
        "fused group FISTA kernel launch failed with CUDA error %d "
        "(b=%d, G*M=%d, M=%d, route %s, tier %s, state in %s%s)" % (
            err, b, gm, group_size, route, mxu,
            "shared memory" if state is None else "global",
            "" if words is None else ", early stop"))
  launches += 1
  if mxu != "highest":
    tier_launches += 1
  last_route = fused_fista.ROUTE_NAMES[taken.value]
  if iters is not None:
    last_iters = iters
  return out
