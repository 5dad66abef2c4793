"""Smoke run of the PyTorch/CUDA port (vtc_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Drives the port's paths through their public entry points, in the
phases below.  Any failure ends the run with a non-zero exit; nothing is
caught.

* Serving: fully-connected sparse encoding at the flagship width (16x16
  patches, n = 256, 256 atoms, batch 2048, 100 FISTA iterations,
  lambda 0.008; examples/encode_dataset.py:27-32); kernel K1.
* Training: the scanned fc dictionary trainer at the flagship width
  (batch 250, 25 FISTA iterations, lambda 0.008, cheap-quadratic update
  at stepsize 0.1, warm power refresh of 2 iterations per step, one
  1,000-step segment; bench.py:10-23, examples/train_sparse_coding.py:
  53-61), then SparseCoder.fit; kernels K2 (fused train step) and K1.
* Subspace serving: group-sparse encoding at the flagship width with 64
  contiguous groups of 4 (batch 2048, 100 FISTA iterations, lambda
  0.008); kernel K4 (fused group FISTA).
* Subspace training: the scanned trainer with the same groups at
  bench.py's subspace configuration (bench.py:478-538: batch 250,
  FISTA-25, lambda 0.008, cheap-quadratic update at stepsize 0.05, warm
  power refresh of 2 iterations, one 1,000-step segment); kernel K6
  (fused group train step, K4's kernel as its solve).
* Conv serving: encode_dataset(mode='convolutional') at the reference
  conv width (examples/train_convolutional_sparse_coding.py:26-33: 64
  kernels of 16x16 at stride 8 on 256x256 images padded by 8 to 272x272;
  batch 40 as bench.py's measure_conv, FISTA 100, lambda 0.05); kernel
  K10 (direct conv FISTA), and K11 (gram-form conv FISTA) for a geometry
  K10's gate turns away.
* Conv training: the per-batch train_dictionary at the example's
  parameters (:57-69: batch 5, ISTA 25, lambda 0.05, cheap-quadratic
  update at stepsize 0.001), 200 steps; kernel K10 as its solve.
* Scanned conv training: train_dictionary_scanned(mode='convolutional')
  at bench.py's measure_conv(40, 25) (bench.py:627-705: batch 40, FISTA
  25, lambda 0.05, cheap-quadratic update at stepsize 0.05, two warm power
  iterations per step from an exact seed), one 200-step segment; kernel
  K12 (fused conv train step, K10's solve inside).
* ICA and PCA: the scanned ICA trainer at bench.py's measure_ica(250,
  2000) (bench.py:206-258: n = 256, batch 250, 2,000 steps, stepsize
  0.001, three Newton-Schulz refreshes per step from an exact-inverse
  seed), then the per-batch trainer, ICACoder and PCACoder; kernel K8
  (fused ICA train step).
* Big-dictionary training: the residual-form segment at bench.py's
  measure_bigdict rows (bench.py:541-624, :831-846: s = 2048 atoms, n =
  256, batch 128, FISTA 25, lambda 0.008, cheap-quadratic update at
  stepsize 0.1, two warm power iterations per step on the n x n Gram, one
  200-step segment; fc, and 512 contiguous groups of 4) through
  training/compiled_epoch._code_shard_segment_runner; kernel K19
  (residual-form train step).
* Data-parallel training: the fc, subspace and ICA scanned trainers above
  with all_params['data_parallel'] at their full widths, on a mesh of one
  rank (no process group: the one card) for 1,000, 1,000 and 2,000 steps,
  and at a world of 2 with two processes of this script sharing the card
  over a gloo group (shards of 125); encode_dataset and PCA on a mesh of
  one.  Kernels K15, K16 and K18 (bench.py's fc_, subspace_ and
  ica_dp_rdma_batch250 rows, bench.py:796-827), each rank's whole segment
  from one C loop with the statistics summed over the ranks by a host hook
  between each step's solve and its update; and, on a mesh of two slices
  ('dcn'), K3, K7 and K9, the per-shard solve+stats steps, with one
  all-reduce of their statistics per step and the replicated update.
* Conv data-parallel training: the scanned conv trainer above with
  all_params['data_parallel'] on a mesh of one rank (one 200-step segment
  of 40, bench.py's conv_dp_rdma_batch5 row at b 5 for 100 steps, and 20
  steps at three update iterations), the per-batch conv trainer at the
  example's parameters (50 steps of 5) and the conv encode on a mesh of
  one; the world of 2 runs conv on shards of 20.  Kernel K13, the conv
  solve+stats step of one shard, in its gradient and gram forms.
* Big-dictionary training across devices: the scanned trainer at
  bench.py's measure_bigdict width with dictionary rows sharded over a
  'code' axis (train_dictionary_scanned(data_parallel=make_mesh(data=1,
  code=2)), fc and 512 groups of 4, and make_mesh(data=2, code=2)), two and
  four processes of this script sharing the card over gloo; kernel K19
  across devices, each rank's segment from one C loop with the sums over
  the ranks as calls of its host hook.

The phases that check a refusal (a tier the kernels do not have yet, or
K13's early stop, which vtc_tpu's K13 lacks too) require
NotImplementedError and no launch of the kernel; phases 26 and 33 hold
the tiers K3, K7, K15 and K16 refused before phase 47 to their plain
versions instead.  CUDA_TESTS below maps
each test marked cuda to the phases that make its check here.

1. Device and build: requires CUDA (there is no CPU path), prints the
   card's name and power limit, builds the kernels from
   vtc_tpu_torch/csrc/ and prints the build time.
2. Kernel against plain: the fused FISTA kernel against its plain
   PyTorch version in float32 and in float64, on the card, at the
   flagship batch, the trainer's batch of 250, a ragged 13 x 37 x 24
   problem and an overcomplete s = 1024 one (state in global memory);
   FISTA and ISTA, soft, hard and nonnegative, cold and warm starts.
   Tolerance: 1e-5 of the largest code, and never above 1e-4 absolute,
   the repo's parity contract.  Codes at the flagship are at most about
   0.25, so 1e-4 alone would pass a kernel with TF32 products; a
   control runs the plain version with TF32 products at the flagship
   and requires that it fail the limit.  Hard thresholds run at the
   ragged size only: they are discontinuous, and at batch 250 and up
   some pre-threshold value lands within rounding of lambda*eta, flips
   between float types and moves its code by the threshold itself, so
   a tight comparison is not well posed there.
3. The slice: encode_dataset over 16 batches of 2048 synthetic
   patches, then SparseCoder(formulation='pallas').encode; the kernel's
   launch count must equal the number of batch solves, the codes must
   be finite and one batch must match the plain version to the limit.
4. Timing with CUDA events after warm-up: kernel and plain time per
   flagship batch, encode patches/s.
5. Train kernels against plain: one fused train step (K2) against its
   plain PyTorch version in float32 and float64, on the card: at the
   flagship (eigenvector seeded by top_gram_eigenpair), a ragged
   13 x 37 x 24 problem, an overcomplete s = 64 > n = 24 one with three
   update iterations, and steepest descent with ISTA and nonneg; then a
   50-step steepest-descent segment.  Dictionary, Hessian EMA, stepsize
   and codes are each held to the same limit (1e-5 of the largest value,
   never above 1e-4).  Cheap-quadratic segments longer than a step turn
   rounding into threshold flips (tests/test_pallas_train_step.py), so
   they are judged by the trainer's quality checks below instead.  A
   control runs the plain step with TF32 products and requires that it
   fail the one-step limit.
6. The trainer: train_dictionary_scanned over 250,000 synthetic patches
   (1,000 batches of 250, 256 MB on the device) from a random unit-norm
   dictionary, one segment; the fused step must count 1,000 launches,
   the rows stay unit norm within 1e-4, everything finite, and the LASSO
   loss of a held-out batch (compute_metrics) must fall.  Then
   SparseCoder(formulation='pallas').fit, 8 steps: K1 must count 8.
7. Timing: fused step and plain step ms at the flagship, and trainer
   patches/s through train_dictionary_scanned.
8. K4 against plain, in float32 and float64, at the limit of phase 2:
   the flagship (64 x 4 groups, cold and warm), batch 250 at 25
   iterations (FISTA and ISTA), ragged overlapping groups with M = 26
   (s = 32, n = 24; soft and hard, which runs at this size only), and
   128 overlapping groups of 8 (G*M = 1024, the state in global
   memory).  A TF32 control of the plain version must fail the limit.
9. The subspace slice: encode_dataset with the 64 x 4 groups over 16
   batches of 2048 group-sparse patches; K4 must count 16 launches, the
   codes must be finite and one batch must match the plain version.
10. K6 against plain, one step: the flagship (the identity selection),
   ragged overlapping groups, G*M = 64 > n = 24 (the n-side power Gram),
   the anti-alignment penalty 0.4 with both update rules, steepest
   descent with ISTA at the flagship; then a 50-step steepest segment.
   Dictionary, Hessian EMA, eigenvector, codes and stepsize are held to
   the limit, and a TF32 control must fail it.
11. The subspace trainer: train_dictionary_scanned over 250,000
   group-sparse patches, one 1,000-step segment; K6 must count 1,000
   launches, the rows stay unit norm within 1e-4, everything finite, and
   the held-out group-LASSO loss (compute_metrics, is_subspace) must
   fall.
12. Timing: K4 and plain ms per flagship batch, subspace encode
   patches/s, K6 and plain step ms, subspace trainer patches/s.
13. K10 against plain, in float32 and float64, at the limit of phase 2:
   the flagship (b 40, FISTA 100, cold and warm), the trainer's batch of
   5 with ISTA 25 and its random initial kernels, 12x12 kernels at
   stride 8 (zero-extended to 16; padded 268x268) at full width, c = 3
   with hard and nonnegative thresholds at a small size, and a ragged
   geometry for the tiled GEMM (s 40, c 3, 6x6 at stride 2: M of 12 and
   40, K of 108 and 360, 2,001 blocks and 1,701 code positions, FISTA
   and ISTA).  TF32 controls of the plain version at the flagship and
   the ragged geometry must fail the limit.
14. K11 against plain and against K10 at the flagship geometry (the
   wrapper called directly), at a small geometry with kernel % stride
   != 0 and asymmetric padding, and, as a serving path, encode_dataset
   (formulation='pallas') over 3x256x256 images padded to 288x288 with 64
   kernels of 3x32x32 at stride 16: c*sv*sh = 768 > 512, so K10's gate
   sends 'pallas' to K11 (2 launches, none of K10).  A TF32 control must
   fail the limit.
15. The conv serving slice: encode_dataset(mode='convolutional') over
   320 images in batches of 40; K10 must count 8 launches, the codes
   must be finite and one batch must match the plain version.
16. The conv trainer: train_dictionary(mode='convolutional') for 200
   steps of 5 images from random unit-norm kernels; K10 must count 200
   launches, the kernels stay unit norm within 1e-4, everything finite,
   and the held-out batch's conv LASSO loss (compute_metrics) must fall.
17. Timing: K10, K11 and plain ms per flagship batch (K10 with its
   TFLOP/s and share of the fp32 peak), the same loop with cuDNN's
   products (K10's library time), K10 at the trainer's batch, conv
   encode images/s, conv trainer images/s and the stepsize's eigvalsh
   ms.  A profile of one K10 and one K11 flagship solve counts the
   gathered GEMM's launches: every K10 product and K11's interior go to
   the tiled kernel, only K11's rows, columns and corners to the line
   kernel.
18. K12 against plain, in float32 and float64: one step at the flagship
   (b 40, FISTA 25, windowed kernels, exact eigenvector seed), b 5 with
   ISTA 25, 12x12 kernels at stride 8 (zero-extended, 268x268), steepest
   descent with three update iterations, c = 3 hard and nonnegative at a
   small size, then a 20-step steepest segment; the dictionary, Hessian,
   eigenvector, codes and stepsize are held to phase 2's limit, and a
   TF32 control of the plain step must fail it.
19. The scanned conv trainer: one 200-step segment of 40 images (8,000
   images, 2.4 GB, made on the card) from windowed random kernels; K12
   must count 200 steps and K10 no solve of its own, the kernels stay
   unit norm within 1e-4, everything finite, and the held-out conv LASSO
   loss (compute_metrics) must fall at bench.py's stepsize 0.05.
20. K8 against plain, in float32 and float64, at n 256 and b 250: one
   step and a 50-step segment with one and three update iterations, a
   stale-seed (1.35 X) boost case; D and X at the limit, the residual at
   1e-5 (it compares entries of D X with those of I).  The codes must
   stay clear of sign()'s discontinuity at 0 for a segment to be
   comparable, so these cases start from their (orthogonal) mixing matrix
   with sources at least 0.05 from zero.  At stepsize 40 the residual of
   both must be NaN or above the guard tolerance; a TF32 control must
   fail the limit.
21. The ICA trainers: train_dictionary_scanned over 2,000 batches of 250
   Laplace mixtures (n 256, 512 MB, made on the card, a seeded random
   mixing matrix of condition at most e^2) from a random orthogonal
   dictionary; K8 must count 2,000 steps with no guard rollback, D stay
   finite and the held-out Laplace negative log-likelihood (mean sum |c|
   + log |det D|, c = x D^-1) fall.  Then stepsize 40 through the trainer,
   which must roll back; ICACoder.fit for 4 steps (encode/decode inverts);
   PCACoder.fit on 20,000 patches, rows orthonormal within 1e-4.
22. Timing: K12 and plain ms per full-width step with the bound, the
   gathered GEMM's ms per step (profiled) and cuDNN's FISTA-25 solve of
   the same batch (the library time of the step's solve), conv
   scanned trainer images/s, K8 and plain ms per step with the bound, ICA
   scanned trainer patches/s, per-batch ICA trainer patches/s.
   Phases 5, 6, 8, 10, 11, 13, 14 and 16 also check the refusals of
   their kernels and entry points on the card (early stop, tiers).
23. K19 against plain, in float32 and float64, one step: fc at bench's
   width (s 2048, b 128, FISTA 25, cheap-quad 0.1), 512 contiguous groups
   of 4 at bench's width (the in-warp group prox), contiguous groups of 4
   with the anti-alignment penalty 0.15 and a ragged partition (groups of
   1 to 6, the member-table prox) at s = 512 (the regularizer's s x s
   matrices), and ISTA hard nonnegative at a small size.  Dictionary,
   Hessian EMA, eigenvector, codes and stepsize are held to phase 2's
   limit, a TF32 control of the plain step must fail it, and the early
   stop and the bf16x3 tier must be refused.
24. The big-dictionary slice: _code_shard_segment_runner over one 200-step
   segment of 128 sparse mixtures of a 2048-atom generator (26 MB, made
   on the card), fc and with 512 groups of 4; K19 must count 200 steps
   each, the state stay finite, the rows unit norm within 1e-4, and the
   held-out LASSO (group-LASSO) loss fall at bench's stepsize 0.1.
25. Timing at bench.py's exact configuration (its seeded randn patches and
   dictionary; whether that run stays finite is printed, not required):
   K19 ms per step over the 200-step segment, fc and grouped, two runs
   each; the plain version's, K2's and K6's ms per step at the same shape
   (the gram-form A/B); the plain gram-form _segment_runner (bench's xla
   row: 200 fc steps, 50 grouped); patches/s for each, and the bound.
26. K3, K7 and K9 against plain, in float32 and float64, every output at
   phase 2's limit: K3 at b 250 and at a shard of 125, ragged shapes with
   s > n and s < n, ISTA hard nonnegative at a small size; K7 at 64 x 4
   (b 250 and 125), ragged overlapping groups, G*M > n and the hard group
   threshold; K9 (gapped sources, as phase 20) from an exact seed, at a
   shard of 125, from a stale seed that fires the boost and one that does
   not.  K9's statistic, a sum of 250 products of order 1, is held to 1e-5
   of its largest entry without the 1e-4 cap.  A TF32 control of each
   plain version must fail the limit.  One identity each: the replicated
   update from K3's own statistics, (C D - B) / b, is K2's one-step
   output; K7's is K6's (also with the anti-alignment penalty 0.4); K9's
   is K8's.  The tiers and the data-parallel early stop on the kernel
   route must be refused.
27. A world of 1 through the normal entry points.  First a probe: whether
   torch.distributed has NCCL and a one-rank NCCL group initialises and
   reduces a device tensor (printed; with one, data_parallel=True inside
   it must give bitwise the run without a group).  The scanned ICA trainer
   with data_parallel at stepsize 40 must roll back through the
   data-parallel fallback.  encode_dataset (fc and subspace, 16 K1 / K4
   launches) and PCA with a mesh of one must equal their single-device
   results bitwise.  (The 1,000- and 2,000-step world-of-1 trainers run
   in phase 34, through K15, K16 and K18.)
28. A world of 2 on the one card: two processes of this script (the hidden
   sub-command --dp-rank) share the GPU, join a gloo group over a file://
   store in a temporary directory, stage the statistics through pinned host
   buffers, and run 50 steepest and 50 cheap-quadratic steps fc and
   subspace and 50 ICA steps on shards of 125, and 50 steepest, 50
   cheap-quadratic and 20 gram-form (three update iterations) conv steps
   on shards of 20 (images each rank makes on the card from one seed)
   through K15, K16, K18 and K17, the sum of each step's statistics
   called back from the kernel's C loop (K18: between the front and the
   back launch of its persistent segment kernel, the route each rank
   must report), and 50 cheap-quadratic fc,
   subspace and conv steps and 50 ICA steps on a mesh of two slices
   (dcn=2), where the trainers take K3, K7, K9 and K13's composition as
   vtc_tpu does, all through the trainers; then 10 cheap-quadratic conv
   steps with a mid-run early stop (K17, the rank's share of the stop's
   sum added over the ranks once an iteration).  Each rank must count 50
   K3, 50 K7, 50 K9, 50 K13, 130 K17, 100 K15, 100 K16 and 50 K18
   launches and none of K2, K6, K8 or K12; both ranks must return bitwise
   the same state (with the stop, the same count every step, some short
   of 25); and it must match the single-process trainers (K2, K6, K8,
   K12) on the global batch, the steepest and ICA runs within phase 2's
   limit, the cheap-quadratic ones within the rounding floor.  A rank's
   failure fails the run.
29. Timing: K3, K7 and K9 ms per step at b 250 and at a shard of 125
   against their plain versions and against K2, K6 and K8's whole steps;
   the host's enqueue time per step of their composition.
30. K13 against plain, in float32 and float64: the flagship (b 40, FISTA
   25, windowed kernels, exact seed) and a shard of 20 in both forms; b 5
   with ISTA 25 and random kernels, 12x12 kernels at stride 8
   (zero-extended), c = 3 hard and nonnegative at a small size, in the
   gradient form.  Codes, eigenvector and stepsize at phase 2's limit; the
   sums over the shard (grad_sum, bx, cm, stat) at 1e-5 of their largest
   entry, without the codes' 1e-4 cap (phase 26's rule for K9's
   statistic).  The replicated update from K13's gradient-form statistics
   is K12's one-step output, and from its gram form at three update
   iterations K12's at three.  A TF32 control must fail the limits; the
   bf16x3 tier and the early stop must be refused, and so must the gram
   form where the padding (2 at stride 4) is no stride multiple, by the
   gate and the wrapper, with no launch.  Then K17, a whole data-parallel
   segment at a world of 1, against its fp32 and fp64 plain versions over
   two steps: the flagship in both forms (one and three update
   iterations), b 5 with ISTA 25, 12x12 kernels zero-extended; the
   kernels, Hessian and eigenvector at phase 2's limit, the last codes
   too.  K17's segment must equal K13's composition on the same steps
   within the limit; a TF32 control must fail; the bf16x3 tier, the early
   stop and the gram form off its gate must be refused with no launch.
31. A world of 1 through the entry points: train_dictionary_scanned(
   data_parallel=True) on phase 19's segment (200 K17 steps, no K13 or
   K12 step or K10 solve; unit norm, finite, the held-out loss falls, the
   final
   kernels within the rounding floor of phase 19's); bench.py's
   conv_dp_rdma_batch5 row (b 5, 100 steps, on phase 19's images); 20
   steps at three update iterations, which must take the gram form and
   land within the floor of K12's run; the per-batch train_dictionary(
   data_parallel=True) at the example's parameters, 50 steps (the
   psum-per-op step, held to the trainer checks); encode_dataset over
   phase 15's images on a mesh of one, bitwise phase 15's codes with 8
   K10 launches.
32. Timing: K13 ms per step at b 40 and at a shard of 20 in both forms,
   against its plain version and K12's whole step (phase 22), each with
   its bound, and at b 10, 20, 30 and 40; K17 ms per step in both forms
   against its plain version and K13's composition, with its bound and
   phase 22's library solve beside both, and
   at bench.py's b-5 row; the host's enqueue time per conv data-parallel
   step, K13's composition and K17's segment; the world-of-1 conv
   trainer's images/s beside phase 19's, the b-5 row's and the per-batch
   trainer's.
33. K15, K16 and K18 against their fp32 and fp64 plain versions, each a
   whole data-parallel segment of 10 steps at a world of 1: K15 at the
   flagship (b 250, s = n = 256, FISTA 25, cheap-quad 0.1), at a shard of
   125, with steepest descent at three update iterations, at a ragged
   13 x 37 x 24 shape with s > n (the n x n power Gram; cheap-quad at three
   update iterations and stepsize 0.003) and ISTA hard nonnegative there;
   K16 at 64 x 4 groups at b 250 and 125, and with the anti-alignment
   penalty 0.4 on ragged overlapping groups (steepest descent: with the
   cheap-quadratic rule sign(D D^T) flips between fp32 and fp64 over ten
   steps); K18 at n 256, b 250 (gapped sources, as phase 20), a shard of
   125 at three update iterations, and a stale 1.35 X seed that fires the
   boost.  Every output at phase 2's limit, K18's residual at 1e-5; each
   wrapper must count one launch per step.  A TF32 control of each plain
   version must fail the limit; the tiers and the early stop must be
   refused with no launch.
34. A world of 1 through the entry points: train_dictionary_scanned(
   data_parallel=True), fc and subspace, 1,000 steps each: 1,000 K15 / K16
   launches and no K3 / K7 or K2 / K6 launch, unit rows, the held-out loss
   falls, and the final dictionary within the rounding floor of ROADMAP.md
   §3 (twice 2.2e-4) of the single-device trainer's from phases 6 and 11.
   The scanned ICA trainer for 2,000 steps: 2,000 K18 launches, no K9 or
   K8, no rollback, the held-out NLL falls, within the floor of phase 21's.
35. Timing: K15, K16 and K18 ms per step over a segment of 100 (K18: 200)
   steps at b 250, beside their plain versions, K3, K7 and K9's
   composition and K2, K6 and K8's whole steps; the host's enqueue time
   per step over 5 and 50 steps, of each kernel's segment and of the
   composition; and bench.py's fc_, subspace_ and ica_dp_rdma_batch250
   rows at a world of 1 (patches/s per chip through the trainers) beside
   the single-device fused trainers, in turns.
36. K19 across devices: processes of this script (the hidden sub-command
   --cs-rank) share the card in a gloo group over a file:// store, two on
   a (data 1, code 2) mesh, then four on a (data 2, code 2) mesh; the
   sums of the n x n Gram, the reconstruction, the Hessian statistic and
   the gradient over the ranks are calls of K19's host hook.  One step at
   bench's width (s 2048: s_l 1024; b 128, at data 2 b_l 64), fc and 512
   contiguous groups of 4, and at s 512 groups of 4 with the penalty 0.4
   and a ragged partition inside each shard (two update iterations),
   against the fp32 and fp64 plain versions across the same ranks, every
   gathered output at phase 2's limit; the ranks must hold bitwise the
   same eigenvector, stepsize and gathered state; the difference of the
   stacked shards from K19 at a code axis of 1 on the whole dictionary in
   one process is printed.  The early stop and the bf16x3 tier must be
   refused at a code axis of 2.
37. The scanned trainer through its entry point,
   train_dictionary_scanned(data_parallel=make_mesh(data=1, code=2)), 50
   steps at bench's width fc and grouped, and make_mesh(data=2, code=2),
   20 fc steps: each rank must count one K19 launch per step and none of
   K2, K6, K15 or K16; the ranks must return bitwise the same dictionary,
   unit rows, within the rounding floor of the single-process
   _code_shard_segment_runner at code 1 on the global batch.
38. Timing per rank: K19 across devices ms per step over a 20-step
   segment at code 2 and at 2 x 2, the hook sums per step and the host's
   time in them, the plain version's ms, the per-rank bound, and K19 at a
   code axis of 1 (phase 25) beside them.  The ranks share one card over
   gloo, each sum staged through pinned host memory: host-bound numbers,
   not a multi-GPU measurement (NCCL across GPUs cannot run on one card).
39. The fc/subspace solve's small-batch kernel (csrc/fista_core.cuh).  (a)
   fista_cluster_kernel and fista_kernel, both forced through the
   wrappers' internal route argument, on the same CPU-made G, c and warm
   starts (FISTA 25), must give torch.equal codes: FISTA and ISTA with the
   soft, nonnegative, hard and nonnegative-hard shrinks, cold and warm, at
   b 250, 125 and 37 and s 256 and 40; groups of 1, 2 and 4, soft and
   hard, there; groups of 8 and 16 (s 256) and 3 and 6 (s 96), which take
   the shared-memory prox pass; s 512 (64 columns a CTA); and b 2048, a
   shape the route sends to fista_wide_kernel (phase 42).  (b) The auto route at b 250 and
   125, fc and 64 x 4 groups, against the fp32 and fp64 plain versions at
   phase 2's limit, each with a TF32 control that must fail it.  (c) The
   library's layout constants equal ops/fused_fista's; for 17 shapes the
   route launch_solve took, ops/fused_fista.solve_route's choice and the
   library's vtc_fista_route agree, and so do the rows a cluster takes;
   the cluster slots and cudaOccupancyMaxActiveClusters are printed; a
   forced cluster launch that does not fit (s 1024; groups of 26) raises
   and counts nothing.  (d) A torch.profiler count over 20-step segments
   of the b-250 trainers of phases 6, 11 and 34
   (train_dictionary_scanned fc and subspace, and with
   data_parallel=True): one fista_cluster_kernel launch a step and no
   fista_kernel or fold_gram_kernel launch.
40. The ICA step's two routes (csrc/ica_segment.cuh, csrc/
   fused_ica_train_step.cu; phases 20, 21, 28, 33 and 34 run the default,
   the persistent segment kernel, and phases 20 and 33 check that they
   did).  (a) The persistent route and the per-step route, both forced
   through the wrappers' internal route argument, on the same CPU-made
   inputs (orthogonal dictionaries, their inverses, mixtures of sources
   clear of zero) must give bitwise-equal D, X and r_max, for K8, for K18
   at a world of 1, and K18's persistent route against K8's: n 256, b 250
   over 1 and 50 steps at one and three update iterations, a stale 1.35 X
   seed whose boost fires (r_max must come back under the boost
   tolerance), stepsize 40 (r_max NaN or above the guard in both), and
   the ragged n 24 / b 13, n 200 / b 77 and n 384 / b 250, each also on a
   forced grid of 1, 7 or 132 CTAs, where the tiles outnumber the CTAs.
   (b) The library's layout constants and grids equal ops/fused_ica_
   train's segment_plan; a forced grid one CTA above what the card holds
   at once is refused, raises and counts nothing.  (c) A torch.profiler
   count over phase 21's 2,000-step trainer and phase 34's data-parallel
   twin: one ica_segment_kernel launch in the segment and none of the
   per-step route's kernels.  (d) Timing, in turns (per-step route,
   persistent, persistent, per-step route): K8 and K18 (world of 1) ms
   per step over a 100-step segment at n 256, b 250, refine 3, upd 1,
   the boost armed.  Phase 28's world of 2 runs K18 as front and back
   launches of the segment kernel around the hook and checks the route.
41. K19's solve as one launch a step (csrc/code_shard_solve.cuh, csrc/
   fused_code_shard_train_step.cu; phases 23-25 run the default at a mesh
   of one rank, the persistent solve kernel, and phases 23 and 24 check
   that they did; phases 36-38 check that the ranks took the per-step
   route).  (a) The persistent route and the per-step route, both forced
   through the wrapper's internal route argument, on the same CPU-made
   inputs (unit rows, the Gram's eigenvector, sparse mixtures) must give
   bitwise-equal D, h, v, codes and stepsize: bench's fc over 1 and 20
   steps, its 512 contiguous groups of 4, windows 8, 16 and 32 (hard) at
   s 512, phase 23's ragged member-table partition (steepest, upd 2) and
   penalty-0.15 case at s 512, ISTA hard nonnegative at s 96 / n 24 / b
   13, b 77 / s 600 / n 200, b 19 / s 250 / n 37 (rows that are not
   whole float4s), upd 2, and forced grids of 1, 7 and 132 CTAs.
   (b) The library's layout constants, grids and barriers a step equal
   ops/fused_code_shard_train's solve_plan and solve_barriers; a forced
   grid one CTA above what the card holds at once is refused, raises and
   counts no solve launch.  (c) A torch.profiler count over phase 24's
   two 200-step trainers (a second, uncounted run of each segment): one
   code_shard_solve_kernel launch a step and none of recon_partial_kernel,
   recon_sum_kernel or grad_prox_kernel; the solve kernel's device time a
   launch.  (d) Phase 23's fp32 and fp64 limits and TF32 control run the
   auto route.  (e) In phase 25, K19 ms per step on both routes in turns
   (per-step route, persistent, persistent, per-step route) over bench's
   200-step segment, fc and 512 x 4.
42. The fc/subspace solve's large-batch kernel (csrc/fista_core.cuh,
   fista_wide_kernel; phases 3, 4, 9 and 12 run it through the auto
   route).  (a) fista_wide_kernel and fista_kernel, both forced through
   the wrappers' internal route argument, on the same CPU-made G, c and
   warm starts (100 iterations), must give torch.equal codes: at b 2048
   FISTA and ISTA with the four shrinks, cold and warm; groups of 1, 2
   and 4, soft and hard; the ragged b 1,100 and 2,047; b 4,096 (two
   waves); s 40 and 96 (clusters of one CTA).  (b) The auto route at b
   2048 and 1,100, fc and 64 x 4 groups, against the fp32 and fp64 plain
   versions at phase 2's limit, each with a TF32 control that must fail
   it.  (c) For 14 shapes the route launch_solve took, ops/fused_fista.
   solve_route's choice and the library's vtc_fista_route agree, and so
   do the wide cluster size and rows; the flagship takes one wave; a
   forced wide launch that does not fit (s 1024; groups of 3) raises and
   counts nothing.  (d) A torch.profiler count over the flagship fc and
   subspace encode_dataset of phases 3 and 9: one fista_wide_kernel
   launch a batch (16 for 32,768 patches) and no fista_kernel,
   fista_cluster_kernel or fold_gram_kernel.  (e) The library time of K1
   and K4: 100 torch.matmul (2048 x 256) @ (256 x 256) in fp32, TF32 off.
44. The conv family's early stop (csrc/conv_gemm.cuh, "The early stop";
   phases 13, 14, 16 and 30 run each conv route with an eps once).  (a)
   K10 at the flagship (b 40 FISTA 100), the trainer's b 5 ISTA 25, the
   12x12/8 zero-extended geometry and c = 3 nonneg FISTA / hard ISTA, and
   K11 at the flagship, each with an eps that stops at k = 1, one picked
   from the plain version's means to stop mid-run, and 0 (never): the
   stopped codes bitwise those of the same kernel without the stop run to
   the count it reports, the count the fp32 plain version's (a case whose
   plain mean lies within 1e-5 relative of eps is reported apart), the
   codes within phase 2's limit of plain.  (b) The same for one flagship
   K12 step and one K17 step at a world of 1, every output.  (c) The
   200-step scanned conv trainer of phase 19 with a mid-run eps: 200 K12
   steps and no other solve, most solves short of 25 iterations, the
   kernels finite and unit norm, the held-out loss falling.  (d) The main
   path with the stop, every count zeroed before and read after:
   run('pallas') with K10's gate (1 K10) and off it (phase 14's serving
   geometry: 1 K11), the per-batch trainer (20 K10), the scanned trainer
   (20 K12) and with data_parallel=True at a world of 1 (20 K17).  (e)
   The stop's µs an iteration at eps 0 against the build without it, K10
   at b 40 FISTA and b 5 ISTA, in turns; the stopped K10 against
   formulation='gram' with the same eps; 20 steps of the scanned trainer
   with the stop against conv_formulation='gram'; the stop rows' times at
   this run's counts, their plain versions and (K10, K11) the same loop
   with cuDNN's products at the count.
45. The early stop of the data-parallel fc and subspace segments and of
   the big-dictionary segment (csrc/fista_core.cuh's classic route across
   ranks, csrc/code_shard_solve.cuh's STOP build, csrc/
   fused_code_shard_train_step.cu's per-step stop).  (a) K15 and K16 at
   the flagship data-parallel rows (b 250, s = n = 256, FISTA 25,
   cheap-quad, 64 groups of 4) at a world of 1, one step on two batches
   at an eps that stops at k = 1, one from the plain version's means that
   stops mid-run, and 0 (never): every output bitwise the same kernel
   without the stop run to the count it reports, the count the fp32 plain
   version's, within phase 2's limit of it; a 10-step segment at the mid
   eps, every step's count the plain version's.  (b) K15 and K16 at a
   world of 2 through the scanned trainers (two processes of this script
   sharing the card over gloo, spawned as phase 37's): both ranks bitwise
   equal with the same counts every step, the world of 1's, within the
   rounding floor of it.  (c) K19 at one rank, bench's fc and 512 x 4 and a ragged
   s 512 partition (the member table), at the three eps: the persistent
   and per-step routes bitwise equal at the same count, the persistent
   route bitwise its build without the stop at the count, the plain
   version's count, within the limit; a 3-step segment at the mid eps;
   then at (data 1, code 2) and (2, 2) meshes (2 and 4 processes): every
   rank bitwise the same state and counts, the counts those of the fp32
   plain version with the stop on the same mesh and of K19 at one rank,
   the state within the limit of both.  (d) The main path with the
   stop, every count zeroed before and read after: the data-parallel fc
   and subspace trainers at a world of 1 (20 K15, 20 K16 steps) and
   _code_shard_segment_runner fc and 512 x 4 (40 K19 steps, each one
   persistent solve).  (e) In turns: the stop's µs an iteration on K19's
   persistent route at eps 0 against the build without it (8 paired
   readings, their median and range); the stopped K19 segment against K19
   without the stop at 25 iterations; the data-parallel fc trainer with
   the mid eps against fc_formulation='gram' (100 steps, 4 calls of each,
   the ratio of the medians and turn by turn); the stop rows' times at
   this run's counts beside their plain versions.
46. The precision tiers bf16, bf16x3 and bf16x5 of K1, K4, K2 and K6
   (csrc/fista_tier.cuh's fista_tier_kernel, bf16 tensor-core passes;
   ops/precision.py the plain versions' passes, fp32 products of the bf16
   values, TF32 off).  (a) One iteration from random codes: K1 at the
   flagship (soft) and the ragged 13 x 37 x 24 problem (hard, ISTA
   nonneg-hard), K4 at 64 x 4 and at phase 8's ragged M 26 (soft, hard),
   one K2 and one K6 step at FISTA 1, each tier against the plain version
   at the tier at phase 2's limit.  (b) The flagship solves (K1, K4 at b
   2048, FISTA 100) and steps (K2, K6 at b 250, FISTA 25) at each tier
   (tier_verdict's three rules): within the larger of a floor and the
   plain version's spread under five one-ulp nudges of its input; five
   times closer to the plain version at the tier than that is to
   'highest' (where the noise, the larger of that spread and the kernel's
   distance from plain at 'highest', exceeds a tenth of it: within three
   times the noise, the kernel's tier moving it within 2x of plain's); no
   plain tier nearer the kernel than its own.  The kernel's result at
   each other tier and at 'highest', planted in each tier's place, must
   fail.  The STOP build at each tier: K1 (FISTA soft, ISTA nonneg) and K4
   (64 x 4) at b 250 and one K2 and one K6 step, FISTA 25, eps at k = 1,
   mid-run and never: the plain version's count, bitwise the tier kernel
   without the stop at that count, the same count and bits again, and
   the three rules at that count.  (c) The 'highest' routes are phases
   39, 42 and 43's, whose bitwise comparisons run unchanged; a 'highest'
   flagship solve takes the wide route.  (d) The main path at each tier,
   its tier counts zeroed before and read after: the fc and subspace
   encode_dataset of phases 3 and 9 (16 K1 and 16 K4 tier launches) and
   one 1,000-step segment of phases 6 and 11's trainers (1,000 K2 and
   1,000 K6 tier steps), each dictionary finite and unit norm within
   1e-4, its held-out loss falling, and at bf16x3 within 10% of the
   'highest' run's.  With the stop at bf16x3 and a mid-run eps, counts
   zeroed before and read after: ista_fista.run and
   subspace_ista_fista.run at b 250 (one K1 and one K4 tier launch) and
   20 steps of each trainer (20 K2 and 20 K6 tier steps), some solves
   ending early.  (e) In turns, each tier kernel's ms against the
   'highest' route on the same inputs, the plain version's, the bound at
   the bf16 tensor-core rate (989 TFLOP/s) and the library time (the same
   passes as products of bf16 operands, with a float32 result where the
   installed torch offers one; the median of 7 turns, and their range);
   the STOP build at bf16x3 alike at its count; the encodes' patches/s at
   each tier against 'highest'.
47. The precision tiers of the data-parallel fc and subspace kernels K3,
   K7, K15 and K16 (the tier kernel of phase 46 inside K2's and K6's first
   halves; at 'bf16' c as one bf16 pass and, in K7, every code slot
   rounded, the identity layout's too).  Flagship rows (bench.py:796-827:
   b 250, s = n = 256, FISTA 25, cheap-quadratic, 64 contiguous groups of
   4).  (a) One step at each tier: K3 and K7 on a shard of 125, K15 and
   K16 at a world of 1, against the plain version at the tier under
   tier_verdict's three rules (the spread under five one-ulp nudges of the
   input); the kernel's result at each other tier and at 'highest',
   planted in each tier's place, must fail; at 'bf16' on the identity
   layout K7's codes are bf16-rounded and K16's are not.  (b) K15 and K16
   with the stop at each tier at a world of 1, eps at k = 1, mid-run and
   never: the plain version's count, bitwise the tier kernel without the
   stop at that count.  (c) A world of 2, two processes of this script
   sharing the card over gloo: the scanned fc and subspace trainers with
   data_parallel=True at bf16x3 and bf16 for 10 steps without and with a
   mid-run stop (K15, K16; the stop's share summed over the ranks an
   iteration), and on make_mesh(dcn=2) at bf16x3 (K3, K7): both ranks
   bitwise equal with the same counts, 10 tier steps a rank, the counts of
   the world of 1, within the larger of DP_FLOOR, the tier's floor and the
   world of 1's spread.  (d) The main path at each tier, its tier counts
   zeroed before and read after: the data-parallel fc and subspace
   trainers at a world of 1 for one 1,000-step segment each (1,000 K15 and
   1,000 K16 tier steps), the 'dcn' composition for 50 steps of each (50
   K3 and 50 K7), the fc and subspace encode_dataset(data_parallel=True)
   of phases 3 and 9 (16 K1 and 16 K4); every dictionary finite and unit
   norm within 1e-4, its held-out loss falling, the trainers' at bf16x3
   within 10% of phases 6 and 11's 'highest'.  (e) In turns, each tier
   step's ms against the 'highest' route on the same inputs, the plain
   version's, the bound (the solve's passes at 989 TFLOP/s beside the fp32
   products at 67) and the library time (the step's solve passes as
   products of bf16 operands, the median of 7 turns).
48. The precision tiers of the conv family K10, K12, K13 and K17
   (csrc/conv_gemm_tier.cuh: the gathered GEMM on the bf16 tensor cores
   for corr, the synthesis and the analysis, the weights split once a
   solve or step; the mask, prox, momentum, stop, Gram, refresh,
   statistics and update fp32).  (a) Each kernel at each tier against its
   plain version at the tier under phase 46's three rules (the spread
   under five one-ulp nudges of the input; at bf16 the bound's floor is
   2^-7 of the largest code, CONV_TIER_FLOOR says why): K10 at b 40 FISTA 100
   (windowed kernels) and b 5 ISTA 25 (random kernels), one K12 and one
   K17 step at measure_conv(40, 25) from phase 19's start, K13 on a shard
   of 20 in the gradient and the gram form; each call one tier launch, a
   'highest' call none.  (b) The kernel's result at each other tier and at
   'highest', planted in each tier's place, must fail.  (c) The stop at
   each tier, K10 at b 5, a K12 and a K17 step, a mid-run eps: the plain
   version's count, bitwise the tier kernel without the stop at that
   count; K10 at b 40 (beyond vtc_tpu's one tile) refuses a tier with the
   stop.  (d) A world of 2, two processes of this script sharing the card
   over gloo: the scanned conv trainer with data_parallel=True at bf16x3
   and bf16 for 10 steps (K17 on shards of 20) without and with a mid-run
   stop, and on make_mesh(dcn=2) at bf16x3 (K13's composition): both ranks
   bitwise equal with the same counts, 10 tier steps a rank, the counts of
   the world of 1, within the larger of DP_FLOOR, the tier's floor and the
   world of 1's spread.  (e) The main path at each tier and at 'highest',
   its tier counts zeroed before and read after: the conv encode_dataset
   of phase 15 (8 K10 tier launches), one 200-step segment of phase 19's
   scanned trainer (200 K12 tier steps) and with data_parallel=True (200
   K17), the 'dcn' composition for 20 steps (20 K13); the kernels finite
   and unit norm within 1e-4, the held-out conv LASSO falling, printed
   beside 'highest''s; the images/s of each.  (f) In turns, each row's ms
   against 'highest' on the same inputs, the plain version's, the bound
   (the solve's passes at 989 TFLOP/s beside the fp32 work at 67, the
   inputs read and outputs written once at 3.35 TB/s) and the library time
   (the same solve with each pass one product of bf16 operands on the
   materialized stack; at 'highest' each product one cuDNN call; the
   median of 7 turns).

The data are made here from a seed: sparse mixtures of a random
unit-norm generating dictionary plus noise, at the pixel scale of
whitened 16x16 image patches (for the subspace phases, mixtures of
whole groups of its atoms); the generating dictionary (seed 0) stands
in for a trained one.  The conv images are conv-sparse maps (2% of code
positions active) of random unit-norm kernels under a Gaussian window
(sigma 3 pixels), localized as trained image kernels are, plus noise,
with the padded border zeroed.  The window matters: the conv stepsize is
1/L of the flattened kernels' Gram (vtc_tpu and the reference), which
for unwindowed random 16x16 kernels at stride 8 is about twice the conv
operator's 1/L, and FISTA then diverges in both packages.  The script
imports nothing of the JAX package, vtc_tpu, directly or through the
port.

The line before the last is the card's name and power limit as
nvidia-smi reports them; the last line is the JSON result.
"""
import json
import subprocess
import sys
import time

import numpy as np

LAM = 0.008
ITERS = 100
BATCH = 2048
NUM_BATCHES = 16
TRAIN_BATCH = 250
TRAIN_ITERS = 25
TRAIN_STEP = 0.1
TRAIN_STEPS = 1000
FIT_STEPS = 8
TOL = 1e-4  # max |codes - plain|: the repo's parity contract (CLAUDE.md)
REL_TOL = 1e-5  # ... and at most this share of the largest code

# The tests marked ``cuda`` in tests/test_torch_port_*.py, and the phases
# below that make their checks on the card.  The card's machine has no jax
# and those files import vtc_tpu, so they cannot run there; this run is
# where their checks happen.  tests/test_torch_port_cuda_coverage.py fails
# when a cuda test is missing here or a phase named here does not exist.
CUDA_TESTS = {
    "test_torch_port_code_shard.py::test_cuda_kernel_matches_plain": (23,),
    "test_torch_port_code_shard_parallel.py::"
    "test_cuda_kernel_across_ranks_matches_plain": (36,),
    "test_torch_port_code_shard_persistent.py::"
    "test_cuda_code_shard_persistent_matches_steps_bitwise": (41,),
    "test_torch_port_conv.py::test_cuda_wrappers_raise_and_match_plain": (
        13, 14, 44, 48),
    "test_torch_port_conv_early_stop.py::test_cuda_conv_stop_matches_plain": (
        44,),
    "test_torch_port_conv_parallel.py::test_cuda_conv_dp_runs_k13_and_k17": (
        30, 31),
    "test_torch_port_conv_scanned.py::test_cuda_k12_matches_plain": (18,),
    "test_torch_port_conv_train.py::test_cuda_conv_trainer_runs_k10": (
        16, 44),
    "test_torch_port_ica.py::test_cuda_k8_matches_plain": (20,),
    "test_torch_port_parallel.py::"
    "test_cuda_solve_stats_kernels_match_plain": (26,),
    "test_torch_port_parallel_train.py::"
    "test_cuda_dp_trainers_run_the_stats_kernels": (34,),
    "test_torch_port_dp_early_stop.py::test_cuda_dp_stop_matches_plain": (
        45,),
    "test_torch_port_dp_segments.py::test_cuda_k15_matches_plain": (33,),
    "test_torch_port_dp_segments.py::test_cuda_k16_matches_plain": (33,),
    "test_torch_port_dp_segments.py::test_cuda_k18_matches_plain": (33,),
    "test_torch_port_fista_cluster.py::"
    "test_cuda_cluster_kernel_matches_classic_bitwise": (39,),
    "test_torch_port_fista_cluster.py::"
    "test_cuda_trainers_launch_the_cluster_kernel": (39,),
    "test_torch_port_fista_wide.py::"
    "test_cuda_wide_kernel_matches_classic_bitwise": (42,),
    "test_torch_port_fista_wide.py::"
    "test_cuda_encode_launches_the_wide_kernel": (42,),
    "test_torch_port_ica_persistent.py::"
    "test_cuda_ica_persistent_matches_steps_bitwise": (40,),
    "test_torch_port_ica_persistent.py::"
    "test_cuda_ica_trainers_launch_the_segment_kernel": (40,),
    "test_torch_port_subspace.py::"
    "test_cuda_early_stop_raises_and_launches_nothing": (8, 43),
    "test_torch_port_subspace.py::test_cuda_kernel_matches_plain": (8, 9),
    "test_torch_port_subspace_train.py::test_cuda_early_stop_raises": (
        10, 11, 43, 45),
    "test_torch_port_subspace_train.py::test_cuda_kernels_match_plain": (
        10,),
    "test_torch_port_subspace_train.py::"
    "test_cuda_scanned_runs_the_fused_group_kernels": (11,),
    "test_torch_port_train_step.py::test_cuda_early_stop_raises": (5, 43),
    "test_torch_port_train_step.py::test_cuda_kernels_match_plain": (5,),
    "test_torch_port_trainer.py::test_cuda_scanned_early_stop_raises": (
        6, 43, 45),
    "test_torch_port_trainer.py::test_cuda_scanned_runs_the_fused_kernels": (
        6,),
    "test_torch_port_tiers.py::test_cuda_tier_kernel_matches_plain": (46,),
    "test_torch_port_tiers.py::test_cuda_tier_stop_matches_plain": (46,),
    "test_torch_port_dp_tiers.py::test_cuda_solve_stats_tiers_match_plain": (
        26, 47),
    "test_torch_port_dp_tiers.py::test_cuda_dp_segment_tiers_match_plain": (
        33, 47),
    "test_torch_port_conv_tiers.py::test_cuda_conv_tiers_match_plain": (48,),
}


def limit(codes):
  """The kernel-vs-plain tolerance for codes of this size."""
  return min(TOL, REL_TOL * float(abs(codes).max()))


def check(cond, message):
  if not cond:
    raise RuntimeError("chip_smoke: " + message)


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60)
  return out.stdout.strip().splitlines()[0]


def unit_rows(rng, s, n):
  d = rng.randn(s, n).astype(np.float32)
  return d / np.linalg.norm(d, axis=1, keepdims=True)


def synthetic_patches(num, n=256, atoms=256, seed=0):
  """(num, n) sparse mixtures: 5% of the atoms of a random unit-norm
  dictionary active per patch with N(0, 0.05^2) amplitudes, plus
  N(0, 0.003^2) pixel noise -- a per-pixel spread near 0.012, that of
  whitened natural-image patches."""
  rng = np.random.RandomState(seed)
  gen = unit_rows(rng, atoms, n)
  amps = rng.randn(num, atoms) * 0.05 * (rng.rand(num, atoms) < 0.05)
  return (amps @ gen + 0.003 * rng.randn(num, n)).astype(np.float32)


def kernel_cases(torch, fused_fista, lipschitz, patches, dev):
  """Phase 2: kernel against the fp32 and fp64 plain versions."""
  rng = np.random.RandomState(1)
  flag_d = unit_rows(np.random.RandomState(0), 256, 256)
  over_d = unit_rows(rng, 1024, 256)
  rag_d = unit_rows(rng, 37, 24)
  rag_x = rng.randn(13, 24).astype(np.float32)
  # (name, images, dictionary, lambda, iters, variant, nonneg, hard, warm)
  cases = [
      ("flagship fista soft", patches[:BATCH], flag_d, LAM, ITERS,
       "fista", False, False, False),
      ("flagship ista soft", patches[:BATCH], flag_d, LAM, ITERS,
       "ista", False, False, False),
      ("b250 fista nonneg", patches[:250], flag_d, LAM, 25,
       "fista", True, False, False),
      ("b250 ista soft warm", patches[:250], flag_d, LAM, 25,
       "ista", False, False, True),
      ("b250 fista soft warm", patches[:250], flag_d, LAM, 25,
       "fista", False, False, True),
      ("ragged 13x37x24 fista soft warm", rag_x, rag_d, 0.08, 20,
       "fista", False, False, True),
      ("ragged 13x37x24 fista hard", rag_x, rag_d, 0.08, 20,
       "fista", False, True, False),
      ("ragged 13x37x24 ista hard", rag_x, rag_d, 0.08, 20,
       "ista", False, True, False),
      ("ragged 13x37x24 fista nonneg-hard warm", rag_x, rag_d, 0.08, 20,
       "fista", True, True, True),
      ("overcomplete b64 s1024 fista soft", patches[:64], over_d, LAM, 25,
       "fista", False, False, False),
  ]
  worst = 0.0
  for name, x, d, lam, iters, variant, nonneg, hard, warm in cases:
    x = torch.tensor(x, device=dev)
    d = torch.tensor(d, device=dev)
    eta = lipschitz.fista_stepsize(d)
    flags = dict(variant=variant, nonneg=nonneg, hard=hard)
    init = None
    if warm:
      init = fused_fista.fused_fista_plain(x, d, lam, 10, eta,
                                           **flags).contiguous()
    got = fused_fista.fused_fista_solve(x, d, lam, iters, eta,
                                        initial_codes=init, **flags)
    want32 = fused_fista.fused_fista_plain(x, d, lam, iters, eta,
                                           initial_codes=init, **flags)
    want64 = fused_fista.fused_fista_plain(
        x.double(), d.double(), lam, iters, eta.double(),
        initial_codes=None if init is None else init.double(), **flags)
    torch.cuda.synchronize()
    err32 = float((got - want32).abs().max())
    err64 = float((got.double() - want64).abs().max())
    lim = limit(want64)
    print("kernel vs plain  %-36s max|d| fp32 %.3e  fp64 %.3e  "
          "limit %.3e (max|code| %.3f)" % (name, err32, err64, lim,
                                            float(want64.abs().max())))
    check(bool(torch.isfinite(got).all()), name + ": non-finite codes")
    check(err32 <= lim and err64 <= lim,
          "%s: kernel differs from plain by %.3e / %.3e, limit %.3e" % (
              name, err32, err64, lim))
    worst = max(worst, err32)

  # control: TF32 products at the flagship must fail the limit
  x = torch.tensor(patches[:BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  eta = lipschitz.fista_stepsize(d)
  want64 = fused_fista.fused_fista_plain(x.double(), d.double(), LAM, ITERS,
                                         eta.double())
  tf32 = fused_fista.fused_fista_plain(x, d, LAM, ITERS, eta,
                                       precision="tensorfloat32")
  err = float((tf32.double() - want64).abs().max())
  lim = limit(want64)
  print("control: plain with TF32 products, flagship fista soft: max|d| "
        "fp64 %.3e, limit %.3e (must fail it)" % (err, lim))
  check(err > lim, "the limit does not tell TF32 products from fp32")
  return worst


def train_kernel_cases(torch, fused_train_step, lipschitz, train_patches,
                       dev):
  """Phase 5: one fused train step against the fp32 and fp64 plain
  versions; returns the largest fp32 difference over all quantities."""
  rng = np.random.RandomState(3)
  flag_d = unit_rows(np.random.RandomState(2), 256, 256)
  flag_x = train_patches[:TRAIN_BATCH][None]
  rag_d, rag_x = unit_rows(rng, 37, 24), rng.randn(1, 13, 24)
  over_d, over_x = unit_rows(rng, 64, 24), rng.randn(1, 20, 24)
  # (name, batches, dictionary, lambda, iters, upd step, flags)
  cases = [
      ("flagship fista cheap-quad", flag_x, flag_d, LAM, TRAIN_ITERS,
       TRAIN_STEP, {}),
      ("ragged 13x37x24", rag_x, rag_d, 0.08, 20, 0.05, {}),
      ("overcomplete s64 n24 upd 3", over_x, over_d, 0.05, 20, 0.05,
       {"upd_num_iters": 3}),
      ("flagship steepest ista nonneg", flag_x, flag_d, LAM, TRAIN_ITERS,
       TRAIN_STEP, {"update_alg": "sc_steepest_descent", "variant": "ista",
                    "nonneg": True}),
      ("flagship steepest, 50 steps",
       train_patches[:50 * TRAIN_BATCH].reshape(50, TRAIN_BATCH, 256),
       flag_d, LAM, TRAIN_ITERS, TRAIN_STEP,
       {"update_alg": "sc_steepest_descent"}),
  ]
  names = ("dictionary", "hessian", "eigvec", "codes", "stepsize")
  worst = 0.0
  for name, x, d, lam, iters, step, flags in cases:
    x = torch.tensor(np.asarray(x, np.float32), device=dev)
    d = torch.tensor(d, device=dev)
    h = torch.zeros(d.shape[0], device=dev)
    v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
    args = (lam, iters, step)
    flags = dict(flags, power_iters=2, return_stepsize=True)
    got = fused_train_step.fused_train_segment(d, h, v, x, *args, **flags)
    want32 = fused_train_step.fused_train_segment_plain(d, h, v, x, *args,
                                                        **flags)
    want64 = fused_train_step.fused_train_segment_plain(
        d.double(), h.double(), v.double(), x.double(), *args, **flags)
    torch.cuda.synchronize()
    for what, g, w32, w64 in zip(names, got, want32, want64):
      err32 = float((g - w32).abs().max())
      err64 = float((g.double() - w64).abs().max())
      lim = limit(w64) if float(w64.abs().max()) > 0 else TOL
      print("train kernel vs plain  %-30s %-10s max|d| fp32 %.3e  fp64 "
            "%.3e  limit %.3e" % (name, what, err32, err64, lim))
      check(bool(torch.isfinite(g).all()), "%s: non-finite %s" % (name,
                                                                  what))
      check(err32 <= lim and err64 <= lim,
            "%s: %s differs from plain by %.3e / %.3e, limit %.3e" % (
                name, what, err32, err64, lim))
      worst = max(worst, err32)

  # control: TF32 products in the plain step must fail the one-step limit
  x = torch.tensor(flag_x, device=dev)
  d = torch.tensor(flag_d, device=dev)
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  args = (LAM, TRAIN_ITERS, TRAIN_STEP)
  want64 = fused_train_step.fused_train_segment_plain(
      d.double(), h.double(), v.double(), x.double(), *args, power_iters=2)
  tf32 = fused_train_step.fused_train_segment_plain(
      d, h, v, x, *args, power_iters=2, precision="tensorfloat32")
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    if float(w.abs().max()) > 0:
      err = float((t.double() - w).abs().max())
      ratios.append(err / limit(w))
      print("control: plain step with TF32 products, %-10s max|d| fp64 "
            "%.3e, limit %.3e" % (what, err, limit(w)))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  return worst


def held_out_loss(torch, ista_fista, sparse_coding, x, dictionary):
  """Average LASSO loss of the held-out batch under ``dictionary``."""
  codes = ista_fista.run(x, dictionary, LAM, TRAIN_ITERS,
                         formulation="pallas")
  return sparse_coding.compute_metrics(
      x, codes, dictionary, dictionary, mode="fully-connected",
      sparsity_weight=LAM)["Average LASSO Loss"]


def train_params(steps):
  return {
      "mode": "fully-connected",
      "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {
          0: {"sparsity_weight": LAM, "num_iters": TRAIN_ITERS}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": TRAIN_STEP, "num_iters": 1}},
      "stdout_print_interval": steps,
  }


# ---------------------------------------------------------------------------
# the subspace (group-sparse) path
# ---------------------------------------------------------------------------
GROUP_SIZE = 4
SUB_STEP = 0.05  # bench.py's update stepsize for the subspace row


def contiguous_groups(s, m):
  """s atoms in s / m contiguous groups of m: the flagship's 64 x 4."""
  return [list(range(i, i + m)) for i in range(0, s, m)]


def group_patches(num, n=256, atoms=256, group=GROUP_SIZE, seed=0):
  """(num, n) group-sparse mixtures: 5% of the contiguous groups of a
  random unit-norm dictionary active per patch (as many atoms, 5%, as
  synthetic_patches), N(0, 0.05^2) amplitudes, N(0, 0.003^2) noise."""
  rng = np.random.RandomState(seed)
  gen = unit_rows(rng, atoms, n)
  active = np.repeat(rng.rand(num, atoms // group) < 0.05, group, axis=1)
  amps = rng.randn(num, atoms) * 0.05 * active
  return (amps @ gen + 0.003 * rng.randn(num, n)).astype(np.float32)


def group_kernel_cases(torch, fused_group_fista, sub, lipschitz, patches,
                       dev):
  """K4 against its fp32 and fp64 plain versions, packed codes."""
  rng = np.random.RandomState(4)
  flag_d = unit_rows(np.random.RandomState(0), 256, 256)
  flag_g = contiguous_groups(256, GROUP_SIZE)
  rag_d = unit_rows(rng, 32, 24)
  rag_x = rng.randn(13, 24).astype(np.float32)
  rag_g = [[0, 2, 5], [1], [2, 3, 4, 5], list(range(6, 32))]
  # 128 overlapping groups of 8: G*M = 1024, state in global memory
  big_g = [[(i + m) % 256 for m in range(8)] for i in range(0, 256, 2)]
  # (name, images, dictionary, groups, lambda, iters, variant, hard, warm)
  cases = [
      ("flagship 64x4 fista soft", patches[:BATCH], flag_d, flag_g, LAM,
       ITERS, "fista", False, False),
      ("flagship 64x4 fista soft warm", patches[:BATCH], flag_d, flag_g,
       LAM, ITERS, "fista", False, True),
      ("b250 64x4 fista soft", patches[:250], flag_d, flag_g, LAM, 25,
       "fista", False, False),
      ("b250 64x4 ista soft", patches[:250], flag_d, flag_g, LAM, 25,
       "ista", False, False),
      ("b250 64x4 ista soft warm", patches[:250], flag_d, flag_g, LAM, 25,
       "ista", False, True),
      ("ragged M26 fista soft warm", rag_x, rag_d, rag_g, 0.08, 20,
       "fista", False, True),
      ("ragged M26 fista hard", rag_x, rag_d, rag_g, 0.08, 20, "fista",
       True, False),
      ("ragged M26 ista hard warm", rag_x, rag_d, rag_g, 0.08, 20, "ista",
       True, True),
      ("overlap 128x8 GM1024 fista soft", patches[:64], flag_d, big_g, LAM,
       25, "fista", False, False),
      ("overlap 128x8 GM1024 ista soft warm", patches[:64], flag_d, big_g,
       LAM, 25, "ista", False, True),
  ]
  worst = 0.0
  for name, x, d, groups, lam, iters, variant, hard, warm in cases:
    x = torch.tensor(x, device=dev)
    d = torch.tensor(d, device=dev)
    gather, mask, _ = sub.group_layout(groups, d.shape[0], dev)
    gd = sub.build_grouped_dictionary(d, gather, mask)
    m = gather.shape[1]
    eta = lipschitz.fista_stepsize(gd)
    flags = dict(variant=variant, hard=hard)
    init = None
    if warm:
      init = fused_group_fista.fused_group_fista_plain(
          x, gd, m, lam, 10, eta, **flags).contiguous()
    got = fused_group_fista.fused_group_fista_solve(
        x, gd, m, lam, iters, eta, initial_grouped=init, **flags)
    want32 = fused_group_fista.fused_group_fista_plain(
        x, gd, m, lam, iters, eta, initial_grouped=init, **flags)
    want64 = fused_group_fista.fused_group_fista_plain(
        x.double(), gd.double(), m, lam, iters, eta.double(),
        initial_grouped=None if init is None else init.double(), **flags)
    torch.cuda.synchronize()
    err32 = float((got - want32).abs().max())
    err64 = float((got.double() - want64).abs().max())
    lim = limit(want64)
    print("K4 vs plain  %-38s max|d| fp32 %.3e  fp64 %.3e  limit %.3e "
          "(max|code| %.3f)" % (name, err32, err64, lim,
                                float(want64.abs().max())))
    check(bool(torch.isfinite(got).all()), name + ": non-finite codes")
    check(err32 <= lim and err64 <= lim,
          "%s: K4 differs from plain by %.3e / %.3e, limit %.3e" % (
              name, err32, err64, lim))
    worst = max(worst, err32)

  # control: TF32 products at the flagship must fail the limit
  x = torch.tensor(patches[:BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  gather, mask, _ = sub.group_layout(flag_g, 256, dev)
  gd = sub.build_grouped_dictionary(d, gather, mask)
  eta = lipschitz.fista_stepsize(gd)
  want64 = fused_group_fista.fused_group_fista_plain(
      x.double(), gd.double(), GROUP_SIZE, LAM, ITERS, eta.double())
  tf32 = fused_group_fista.fused_group_fista_plain(
      x, gd, GROUP_SIZE, LAM, ITERS, eta, precision="tensorfloat32")
  err = float((tf32.double() - want64).abs().max())
  lim = limit(want64)
  print("control: group plain with TF32 products, flagship: max|d| fp64 "
        "%.3e, limit %.3e (must fail it)" % (err, lim))
  check(err > lim, "the limit does not tell TF32 products from fp32")
  return worst


def group_train_kernel_cases(torch, fused_group_train_step, sub, lipschitz,
                             train_patches, dev):
  """K6: one fused subspace step against its fp32 and fp64 plain versions,
  then a 50-step steepest segment; returns the largest fp32 difference."""
  rng = np.random.RandomState(5)
  flag_d = unit_rows(np.random.RandomState(2), 256, 256)
  flag_g = contiguous_groups(256, GROUP_SIZE)
  flag_x = train_patches[:TRAIN_BATCH][None]
  rag_g = [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0]]
  rag_d, rag_x = unit_rows(rng, 14, 24), rng.randn(1, 10, 24)
  wide_g = [[(i + m) % 32 for m in range(8)] for i in range(0, 32, 4)]
  wide_d, wide_x = unit_rows(rng, 32, 24), rng.randn(1, 20, 24)  # GM 64 > n
  pen_g = rag_g + [[0, 1]]
  pen_d, pen_x = unit_rows(rng, 14, 16), rng.randn(1, 10, 16)
  # (name, batches, dictionary, groups, lambda, iters, upd step, flags)
  cases = [
      ("flagship 64x4 cheap-quad", flag_x, flag_d, flag_g, LAM, TRAIN_ITERS,
       SUB_STEP, {}),
      ("ragged overlapping s14 n24", rag_x, rag_d, rag_g, 0.05, 10, 0.1, {}),
      ("overlap 8x8 GM64 > n24", wide_x, wide_d, wide_g, 0.05, 10, 0.1, {}),
      ("penalty 0.4 cheap-quad s14 n16", pen_x, pen_d, pen_g, 0.05, 10, 0.1,
       {"alignment_penalty": 0.4}),
      ("penalty 0.4 steepest s14 n16", pen_x, pen_d, pen_g, 0.05, 10, 0.1,
       {"alignment_penalty": 0.4,
        "update_alg": "subspace_sc_steepest_descent"}),
      ("flagship steepest ista", flag_x, flag_d, flag_g, LAM, TRAIN_ITERS,
       0.1, {"update_alg": "subspace_sc_steepest_descent",
             "variant": "ista"}),
      ("flagship steepest, 50 steps",
       train_patches[:50 * TRAIN_BATCH].reshape(50, TRAIN_BATCH, 256),
       flag_d, flag_g, LAM, TRAIN_ITERS, 0.1,
       {"update_alg": "subspace_sc_steepest_descent"}),
  ]
  names = ("dictionary", "hessian", "eigvec", "codes", "stepsize")
  worst = 0.0
  for name, x, d, groups, lam, iters, step, flags in cases:
    x = torch.tensor(np.asarray(x, np.float32), device=dev)
    d = torch.tensor(d, device=dev)
    h = torch.zeros(d.shape[0], device=dev)
    gather, mask, _ = sub.group_layout(groups, d.shape[0], dev)
    v = lipschitz.top_gram_eigenpair(
        sub.build_grouped_dictionary(d, gather, mask))[1].contiguous()
    args = (lam, iters, step)
    flags = dict(flags, group_assignments=groups, power_iters=2,
                 return_stepsize=True)
    got = fused_group_train_step.fused_group_train_segment(d, h, v, x, *args,
                                                           **flags)
    want32 = fused_group_train_step.fused_group_train_segment_plain(
        d, h, v, x, *args, **flags)
    want64 = fused_group_train_step.fused_group_train_segment_plain(
        d.double(), h.double(), v.double(), x.double(), *args, **flags)
    torch.cuda.synchronize()
    for what, g, w32, w64 in zip(names, got, want32, want64):
      err32 = float((g - w32).abs().max())
      err64 = float((g.double() - w64).abs().max())
      lim = limit(w64) if float(w64.abs().max()) > 0 else TOL
      print("K6 vs plain  %-32s %-10s max|d| fp32 %.3e  fp64 %.3e  "
            "limit %.3e" % (name, what, err32, err64, lim))
      check(bool(torch.isfinite(g).all()), "%s: non-finite %s" % (name,
                                                                  what))
      check(err32 <= lim and err64 <= lim,
            "%s: %s differs from plain by %.3e / %.3e, limit %.3e" % (
                name, what, err32, err64, lim))
      worst = max(worst, err32)

  # control: TF32 products in the plain step must fail the one-step limit
  x = torch.tensor(flag_x, device=dev)
  d = torch.tensor(flag_d, device=dev)
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()  # 64 x 4: Dg is D
  args = (LAM, TRAIN_ITERS, SUB_STEP)
  kw = dict(group_assignments=flag_g, power_iters=2)
  want64 = fused_group_train_step.fused_group_train_segment_plain(
      d.double(), h.double(), v.double(), x.double(), *args, **kw)
  tf32 = fused_group_train_step.fused_group_train_segment_plain(
      d, h, v, x, *args, precision="tensorfloat32", **kw)
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    if float(w.abs().max()) > 0:
      err = float((t.double() - w).abs().max())
      ratios.append(err / limit(w))
      print("control: group plain step with TF32 products, %-10s max|d| "
            "fp64 %.3e, limit %.3e" % (what, err, limit(w)))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  return worst


def held_out_group_loss(torch, sub, sparse_coding, x, dictionary, groups):
  """Average group-LASSO loss of the held-out batch under ``dictionary``."""
  codes = sub.run(x, dictionary, groups, LAM, TRAIN_ITERS,
                  formulation="pallas")
  return sparse_coding.compute_metrics(
      x, codes, dictionary, dictionary, mode="fully-connected",
      sparsity_weight=LAM, group_assignments=groups,
      is_subspace=True)["Average LASSO Loss"]


def subspace_train_params(steps, stepsize):
  return {
      "mode": "fully-connected",
      "num_epochs": 1,
      "code_inference_algorithm": "subspace_fista",
      "group_assignments": contiguous_groups(256, GROUP_SIZE),
      "inference_param_schedule": {
          0: {"sparsity_weight": LAM, "num_iters": TRAIN_ITERS}},
      "dictionary_update_algorithm": "subspace_sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": stepsize, "num_iters": 1}},
      "stdout_print_interval": steps,
  }


# ---------------------------------------------------------------------------
# the convolutional path
# ---------------------------------------------------------------------------
CONV_LAM = 0.05          # the example's sparsity weight
CONV_ITERS = 100
CONV_BATCH = 40          # bench.py's measure_conv batch
CONV_IMAGES = 320        # 8 serving batches
CONV_S, CONV_K, CONV_STRIDE, CONV_IMG = 64, 16, 8, 256
CONV_TRAIN_BATCH = 5     # the example's per-batch trainer
CONV_TRAIN_ITERS = 25
CONV_TRAIN_STEP = 0.001
CONV_TRAIN_STEPS = 200
FP32_PEAK = 67e12        # H100 SXM fp32 (SIMT), FLOP/s, at 700 W
HBM_RATE = 3.35e12       # H100 SXM HBM3, bytes/s


def bound(flops, nbytes):
  """(bound_ms, bound_by): the least time for the work on the card."""
  t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def solve_bound(b, s, n, iters):
  """K1 / K4: iters x (b, s) @ (s, s), reading G and c, writing codes."""
  return bound(2.0 * b * s * s * iters, 4.0 * (s * s + 2 * b * s))


def train_step_bound(b, s, n, iters, power_iters=2):
  """K2 / K6, one step: G = D D^T, c = X D^T, the solve, the update's
  two products and the power refresh; reading X and D, writing D."""
  flops = (2.0 * s * s * n + 2.0 * b * s * n + 2.0 * b * s * s * iters
           + 4.0 * b * s * n + 2.0 * power_iters * s * s)
  return bound(flops, 4.0 * (b * n + 2 * s * n))


def conv_direct_bound(geo, b, iters):
  """K10: per iteration the synthesis over the image blocks and the
  analysis over the code positions, 2 * s * R * cpx each, plus corr once;
  reading the images and kernels, writing the codes."""
  depth = 2.0 * geo["s"] * geo["r"] * geo["cpx"]
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  flops = b * (iters * depth * (blocks + codes) + depth * codes)
  nbytes = 4.0 * (b * geo["cpx"] * blocks + geo["s"] * geo["r"] * geo["cpx"]
                  + b * geo["s"] * codes)
  return bound(flops, nbytes)


def conv_gram_bound(op, b, iters):
  """K11: per iteration the interior operator over every code position
  and the corrections over the special rows, columns and corners, 2 * O
  * s^2 each; reading corr and G, writing the codes."""
  n_off, s = op["g_int"].shape[0], op["g_int"].shape[1]
  code_h, code_w = op["code_hw"]
  p, q = len(op["spec_py"]), len(op["spec_px"])
  positions = code_h * code_w + p * code_w + q * code_h + p * q
  flops = 2.0 * n_off * s * s * positions * b * iters
  nbytes = 4.0 * (2 * b * s * code_h * code_w
                  + (1 + p + q + p * q) * n_off * s * s)
  return bound(flops, nbytes)


def windowed_kernels(rng, s, c, k, sigma=3.0):
  """Random unit-norm kernels under a Gaussian window: localized, as
  kernels trained on images are (see the module docstring)."""
  yy = np.arange(k) - (k - 1) / 2.0
  window = np.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / (2 * sigma ** 2))
  d = rng.randn(s, c, k, k) * window
  return (d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))).astype(
      np.float32)


def unit_kernels(rng, s, c, k):
  d = rng.randn(s, c, k, k)
  return (d / np.sqrt((d ** 2).sum(axis=(1, 2, 3), keepdims=True))).astype(
      np.float32)


def conv_padding(img, k, stride):
  """get_padding_amt, plus the trailing rows that make the padded size
  stride-exact for kernels that are not stride multiples (bench.py's
  measure_conv)."""
  from vtc_tpu_torch.ops.conv_shapes import get_padding_amt
  lead, trail = get_padding_amt(img, k, stride)
  trail += (-(img + lead + trail - k)) % stride
  return ((lead, trail), (lead, trail))


def conv_images(torch, conv_ops, dev, num, gen, stride, img, seed):
  """(num, c, H, W) float32 numpy images: conv-sparse maps of ``gen``
  (2% of code positions active, N(0, 1) amplitudes) plus N(0, 0.01^2)
  noise, the padded border zeroed -- a pixel spread near 0.14, that of
  whitened images.  Synthesized on the card, 40 at a time."""
  rng = np.random.RandomState(seed)
  s, c, k, _ = gen.shape
  padding = conv_padding(img, k, stride)
  hh = img + sum(padding[0])
  ch = 1 + (hh - k) // stride
  lead, trail = padding[0]
  mask = np.zeros((hh, hh), np.float32)
  mask[lead:hh - trail, lead:hh - trail] = 1.0
  gen_t = torch.tensor(gen, device=dev)
  out = np.empty((num, c, hh, hh), np.float32)
  for i in range(0, num, 40):
    m = min(40, num - i)
    z = (rng.randn(m, s, ch, ch) * (rng.rand(m, s, ch, ch) < 0.02)).astype(
        np.float32)
    x = conv_ops.synthesize(torch.tensor(z, device=dev), gen_t,
                            (stride, stride)).cpu().numpy()
    out[i:i + m] = (x + 0.01 * rng.randn(*x.shape)) * mask
  return out, padding


def conv_compare(torch, name, solve, plain, x, d, lam, iters, eta, **kw):
  """One kernel call against its fp32 and fp64 plain versions; returns
  (codes, fp32 error)."""
  got = solve(x, d, lam, iters, eta, **kw)
  want32 = plain(x, d, lam, iters, eta, **kw)
  kw64 = {k: (v.double() if torch.is_tensor(v) else v)
          for k, v in kw.items()}
  want64 = plain(x.double(), d.double(), lam, iters,
                 torch.as_tensor(eta).double(), **kw64)
  torch.cuda.synchronize()
  err32 = float((got - want32).abs().max())
  err64 = float((got.double() - want64).abs().max())
  lim = limit(want64)
  print("%-44s max|d| fp32 %.3e  fp64 %.3e  limit %.3e (max|code| %.3f, "
        "density %.4f)" % (name, err32, err64, lim,
                           float(want64.abs().max()),
                           float((got != 0).float().mean())))
  check(bool(torch.isfinite(got).all()), name + ": non-finite codes")
  check(err32 <= lim and err64 <= lim,
        "%s: kernel differs from plain by %.3e / %.3e, limit %.3e" % (
            name, err32, err64, lim))
  return got, err32


def conv_kernel_cases(torch, K10, conv_ops, lipschitz, x_flag, flag_d,
                      padding, dev):
  """Phase 13: K10 against its plain versions."""
  stride = (CONV_STRIDE, CONV_STRIDE)
  x = torch.tensor(x_flag[:CONV_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  eta = lipschitz.fista_stepsize(d.reshape(CONV_S, -1))
  kw = dict(kernel_stride=stride, padding=padding)
  worst = 0.0
  cold, err = conv_compare(torch, "K10 flagship b40 fista100",
                           K10.fused_conv_direct_solve,
                           K10.fused_conv_direct_plain, x, d, CONV_LAM,
                           CONV_ITERS, eta, **kw)
  worst = max(worst, err)
  init = K10.fused_conv_direct_plain(x, d, CONV_LAM, 10, eta, **kw)
  _, err = conv_compare(torch, "K10 flagship b40 fista100 warm",
                        K10.fused_conv_direct_solve,
                        K10.fused_conv_direct_plain, x, d, CONV_LAM,
                        CONV_ITERS, eta, initial_codes=init.contiguous(), **kw)
  worst = max(worst, err)
  d_init = torch.tensor(unit_kernels(np.random.RandomState(2), CONV_S, 1,
                                     CONV_K), device=dev)
  eta_init = lipschitz.fista_stepsize(d_init.reshape(CONV_S, -1))
  _, err = conv_compare(torch, "K10 trainer b5 ista25 random kernels",
                        K10.fused_conv_direct_solve,
                        K10.fused_conv_direct_plain, x[:CONV_TRAIN_BATCH],
                        d_init, CONV_LAM, CONV_TRAIN_ITERS, eta_init,
                        variant="ista", **kw)
  worst = max(worst, err)
  # 12x12 kernels at stride 8: zero-extended to 16, padded 268x268
  gen12 = windowed_kernels(np.random.RandomState(0), CONV_S, 1, 12)
  x12, pad12 = conv_images(torch, conv_ops, dev, CONV_BATCH, gen12,
                           CONV_STRIDE, CONV_IMG, seed=3)
  geo = K10.geometry(x12.shape, gen12.shape, stride)
  check(x12.shape[2] == 268 and geo["ekh"] == 4 and geo["code_h"] == 33,
        "zero-extension geometry %s" % (x12.shape,))
  d12 = torch.tensor(gen12, device=dev)
  _, err = conv_compare(torch, "K10 12x12/8 zero-extended b40 fista100",
                        K10.fused_conv_direct_solve,
                        K10.fused_conv_direct_plain,
                        torch.tensor(x12, device=dev), d12, CONV_LAM,
                        CONV_ITERS, lipschitz.fista_stepsize(
                            d12.reshape(CONV_S, -1)),
                        kernel_stride=stride, padding=pad12)
  worst = max(worst, err)
  # c = 3, small, hard and nonnegative (thresholds are discontinuous:
  # small sizes only); half the flat stepsize keeps these random 4x4
  # kernels' FISTA stable
  rng = np.random.RandomState(5)
  x3 = torch.tensor(np.pad(rng.randn(3, 3, 16, 16),
                           ((0, 0), (0, 0), (2, 2), (2, 2))).astype(
                               np.float32), device=dev)
  d3 = torch.tensor(unit_kernels(rng, 6, 3, 4), device=dev)
  eta3 = 0.5 * lipschitz.fista_stepsize(d3.reshape(6, -1))
  for variant, nonneg, hard in (("fista", True, False), ("ista", False, True),
                                ("fista", True, True)):
    _, err = conv_compare(
        torch, "K10 c3 4x4/2 %s nonneg=%s hard=%s" % (variant, nonneg, hard),
        K10.fused_conv_direct_solve, K10.fused_conv_direct_plain, x3, d3,
        0.05, 20, eta3, kernel_stride=(2, 2), padding=((2, 2), (2, 2)),
        variant=variant, nonneg=nonneg, hard=hard)
    worst = max(worst, err)
  # ragged for the tiled GEMM: s 40, c 3, 6x6 kernels at stride 2 give M
  # of 12 and 40 (no multiple of 64), K of 360 and 108 (no multiple of 16)
  # and 2,001 image blocks and 1,701 code positions (no multiple of 64 or
  # 128), so every tile has a partial edge
  rng = np.random.RandomState(11)
  xr = torch.tensor(np.pad(0.3 * rng.randn(3, 3, 50, 38),
                           ((0, 0), (0, 0), (4, 4), (4, 4))).astype(
                               np.float32), device=dev)
  dr = torch.tensor(windowed_kernels(rng, 40, 3, 6, sigma=1.5), device=dev)
  etar = 0.5 * lipschitz.fista_stepsize(dr.reshape(40, -1))
  rkw = dict(kernel_stride=(2, 2), padding=((4, 4), (4, 4)))
  geo = K10.geometry(xr.shape, dr.shape, (2, 2))
  check((geo["cpx"], geo["r"] * geo["cpx"], geo["r"] * 40,
         3 * geo["bh"] * geo["bw"], 3 * geo["code_h"] * geo["code_w"])
        == (12, 108, 360, 2001, 1701), "ragged geometry %s" % (geo,))
  for variant in ("fista", "ista"):
    _, err = conv_compare(torch, "K10 ragged s40 c3 6x6/2 %s" % variant,
                          K10.fused_conv_direct_solve,
                          K10.fused_conv_direct_plain, xr, dr, 0.05, 20,
                          etar, variant=variant, **rkw)
    worst = max(worst, err)
  want64 = K10.fused_conv_direct_plain(xr.double(), dr.double(), 0.05, 20,
                                       etar.double(), **rkw)
  tf32 = K10.fused_conv_direct_plain(xr, dr, 0.05, 20, etar,
                                     precision="tensorfloat32", **rkw)
  err = float((tf32.double() - want64).abs().max())
  print("control: K10 plain with TF32 products, ragged: max|d| fp64 %.3e, "
        "limit %.3e (must fail it)" % (err, limit(want64)))
  check(err > limit(want64), "the limit does not tell TF32 products from fp32")
  # control: TF32 products at the flagship must fail the limit
  want64 = K10.fused_conv_direct_plain(x.double(), d.double(), CONV_LAM,
                                       CONV_ITERS, eta.double(), **kw)
  tf32 = K10.fused_conv_direct_plain(x, d, CONV_LAM, CONV_ITERS, eta,
                                     precision="tensorfloat32", **kw)
  err = float((tf32.double() - want64).abs().max())
  print("control: K10 plain with TF32 products, flagship: max|d| fp64 %.3e, "
        "limit %.3e (must fail it)" % (err, limit(want64)))
  check(err > limit(want64), "the limit does not tell TF32 products from fp32")
  return worst, cold


def conv_gram_cases(torch, K11, lipschitz, x_flag, flag_d, padding,
                    k10_codes, dev):
  """Phase 14 (kernel checks): K11 against its plain versions and K10."""
  stride = (CONV_STRIDE, CONV_STRIDE)
  x = torch.tensor(x_flag[:CONV_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  eta = lipschitz.fista_stepsize(d.reshape(CONV_S, -1))
  kw = dict(kernel_stride=stride, padding=padding)
  got, worst = conv_compare(torch, "K11 flagship b40 fista100",
                            K11.fused_conv_fista_solve,
                            K11.fused_conv_fista_plain, x, d, CONV_LAM,
                            CONV_ITERS, eta, **kw)
  err = float((got - k10_codes).abs().max())
  print("K11 vs K10 at the flagship: max|d| %.3e, limit %.3e" % (
      err, limit(k10_codes)))
  check(err <= limit(k10_codes), "K11 and K10 disagree by %.3e" % err)
  rng = np.random.RandomState(9)
  x5 = torch.tensor(rng.randn(3, 2, 17, 22).astype(np.float32), device=dev)
  d5 = rng.randn(6, 2, 5, 7)
  d5 = torch.tensor((d5 / np.sqrt((d5 ** 2).sum(axis=(1, 2, 3),
                                                keepdims=True))).astype(
                                                    np.float32), device=dev)
  eta5 = 0.5 * lipschitz.fista_stepsize(d5.reshape(6, -1))
  for variant, hard in (("fista", False), ("ista", True)):
    _, err = conv_compare(
        torch, "K11 5x7/(2,3) asymmetric pad %s hard=%s" % (variant, hard),
        K11.fused_conv_fista_solve, K11.fused_conv_fista_plain, x5, d5, 0.03,
        15, eta5, kernel_stride=(2, 3), padding=((3, 2), (4, 4)),
        variant=variant, hard=hard)
    worst = max(worst, err)
  want64 = K11.fused_conv_fista_plain(x.double(), d.double(), CONV_LAM,
                                      CONV_ITERS, eta.double(), **kw)
  tf32 = K11.fused_conv_fista_plain(x, d, CONV_LAM, CONV_ITERS, eta,
                                    precision="tensorfloat32", **kw)
  err = float((tf32.double() - want64).abs().max())
  print("control: K11 plain with TF32 products, flagship: max|d| fp64 %.3e, "
        "limit %.3e (must fail it)" % (err, limit(want64)))
  check(err > limit(want64), "the limit does not tell TF32 products from fp32")
  return worst


def conv_train_params(steps):
  return {
      "mode": "convolutional",
      "num_epochs": 1,
      "code_inference_algorithm": "ista",
      "inference_param_schedule": {
          0: {"sparsity_weight": CONV_LAM, "num_iters": CONV_TRAIN_ITERS}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": CONV_TRAIN_STEP, "num_iters": 1}},
      "strides": (CONV_STRIDE, CONV_STRIDE),
      "padding": ((8, 8), (8, 8)),
      "stdout_print_interval": steps,
  }


def held_out_conv_loss(conv_ista_fista, sparse_coding, x, kernels):
  """Average conv LASSO loss of the held-out batch under ``kernels``."""
  stride, padding = (CONV_STRIDE, CONV_STRIDE), ((8, 8), (8, 8))
  codes = conv_ista_fista.run(x, kernels, stride, padding, CONV_LAM,
                              CONV_TRAIN_ITERS, variant="ista",
                              formulation="pallas")
  return sparse_coding.compute_metrics(
      x, codes, kernels, kernels, mode="convolutional",
      sparsity_weight=CONV_LAM, kernel_stride=stride,
      padding=padding)["Average LASSO Loss"]


# ---------------------------------------------------------------------------
# the scanned conv trainer (K12) and the ICA / PCA family (K8)
# ---------------------------------------------------------------------------
SEG_BATCH = 40           # bench.py's measure_conv(40, 25)
SEG_ITERS = 25
SEG_STEP = 0.05          # bench.py's conv update stepsize
SEG_STEPS = 200
ICA_N, ICA_BATCH, ICA_STEPS = 256, 250, 2000   # bench.py's measure_ica
ICA_STEP = 0.001
ICA_REFINE = 3
ICA_GUARD_TOL = 1e-3     # training/ica.py's guard at the 'highest' tier
ICA_BOOST_TOL = 1e-6
ICA_LIMIT = REL_TOL      # the residual compares entries of D X with I (1)


def conv_train_bound(geo, b, iters, upd_iters=1, power_iters=2):
  """K12, one step: the flat-kernel Gram and its power refresh, corr,
  iters x (synthesis + analysis), and per update iteration the residual's
  synthesis and the gradient product, each 2 * s * R * cpx per position;
  reading the images and the kernels, writing the kernels and codes."""
  depth = 2.0 * geo["s"] * geo["r"] * geo["cpx"]
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  flops = (depth * geo["s"] + 2.0 * power_iters * geo["s"] ** 2
           + b * depth * (codes + iters * (blocks + codes)
                          + 2 * upd_iters * blocks))
  kernel = geo["c"] * geo["kh"] * geo["kw"]
  nbytes = 4.0 * (b * geo["c"] * geo["sv"] * geo["sh"] * blocks
                  + 2 * geo["s"] * kernel + b * geo["s"] * codes)
  return bound(flops, nbytes)


def ica_step_bound(n, b, refine=ICA_REFINE, upd_iters=1):
  """K8, one step: refine x 2 n^3 products, the residual, upd_iters
  updates, codes and the statistic (bench.py:196-203); reading the batch,
  D and X, writing D and X."""
  flops = (4.0 * refine + 2 + 2 * upd_iters) * n ** 3 + 4.0 * b * n * n
  return bound(flops, 4.0 * (b * n + 4 * n * n))


def compare_outputs(torch, label, names, got, want32, want64, limits=None):
  """Each output against the fp32 and fp64 plain versions at its limit
  (1e-5 of its largest value, never above 1e-4; ``limits`` overrides by
  name); returns the largest fp32 difference."""
  worst = 0.0
  for what, g, w32, w64 in zip(names, got, want32, want64):
    err32 = float((g - w32).abs().max())
    err64 = float((g.double() - w64).abs().max())
    largest = float(w64.abs().max())
    lim = (limits or {}).get(what, limit(w64) if largest > 0 else TOL)
    print("%-40s %-10s max|d| fp32 %.3e  fp64 %.3e  limit %.3e" % (
        label, what, err32, err64, lim))
    check(bool(torch.isfinite(g).all()), "%s: non-finite %s" % (label, what))
    check(err32 <= lim and err64 <= lim,
          "%s: %s differs from plain by %.3e / %.3e, limit %.3e" % (
              label, what, err32, err64, lim))
    worst = max(worst, err32)
  return worst


def conv_train_kernel_cases(torch, K12, conv_ops, lipschitz, x_flag, flag_d,
                            padding, dev):
  """Phase 18: one K12 step against its fp32 and fp64 plain versions, then
  a 20-step steepest segment; a TF32 control of the plain step."""
  stride = (CONV_STRIDE, CONV_STRIDE)
  x = torch.tensor(x_flag[:SEG_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  gen12 = windowed_kernels(np.random.RandomState(0), CONV_S, 1, 12)
  x12, pad12 = conv_images(torch, conv_ops, dev, SEG_BATCH, gen12,
                           CONV_STRIDE, CONV_IMG, seed=3)
  # c = 3, small, hard and nonnegative (discontinuous thresholds: small
  # sizes only), stride 4 = kernel: the flat-kernel stepsize is exact
  rng = np.random.RandomState(6)
  x3 = np.pad(rng.randn(1, 3, 3, 16, 16),
              ((0, 0), (0, 0), (0, 0), (2, 2), (2, 2))).astype(np.float32)
  d3 = unit_kernels(rng, 6, 3, 4)
  pad3 = ((2, 2), (2, 2))
  cq, sd = "sc_cheap_quadratic_descent", "sc_steepest_descent"
  # (name, batches, kernels, stride, padding, lambda, iters, upd step, flags)
  cases = [
      ("flagship b40 fista25 cheap-quad", x[None], d, stride, padding,
       CONV_LAM, SEG_ITERS, SEG_STEP, {}),
      ("b5 ista25 cheap-quad", x[None, :CONV_TRAIN_BATCH], d, stride,
       padding, CONV_LAM, CONV_TRAIN_ITERS, SEG_STEP, {"variant": "ista"}),
      ("12x12/8 zero-extended 268 b40", torch.tensor(x12, device=dev)[None],
       torch.tensor(gen12, device=dev), stride, pad12, CONV_LAM, SEG_ITERS,
       SEG_STEP, {}),
      ("flagship steepest upd 3", x[None], d, stride, padding, CONV_LAM,
       SEG_ITERS, SEG_STEP, {"update_alg": sd, "upd_num_iters": 3}),
      ("c3 4x4/4 ista hard", torch.tensor(x3, device=dev),
       torch.tensor(d3, device=dev), (4, 4), pad3, 0.05, 20, 0.05,
       {"variant": "ista", "hard": True}),
      ("c3 4x4/4 fista nonneg steepest", torch.tensor(x3, device=dev),
       torch.tensor(d3, device=dev), (4, 4), pad3, 0.05, 20, 0.05,
       {"nonneg": True, "update_alg": sd}),
      ("steepest, 20 steps of 16",
       torch.tensor(x_flag[:320], device=dev).reshape(
           (20, 16) + x_flag.shape[1:]), d, stride, padding, CONV_LAM,
       SEG_ITERS, SEG_STEP, {"update_alg": sd}),
  ]
  names = ("dictionary", "hessian", "eigvec", "codes", "stepsize")
  worst = 0.0
  for name, xb, dk, strd, pad, lam, iters, step, flags in cases:
    s = dk.shape[0]
    h = torch.zeros(s, device=dev)
    v = lipschitz.top_gram_eigenpair(dk.reshape(s, -1))[1].contiguous()
    kw = dict(flags, kernel_stride=strd, padding=pad, power_iters=2,
              return_stepsize=True)
    args = (lam, iters, step)
    got = K12.fused_conv_train_segment(dk, h, v, xb, *args, **kw)
    want32 = K12.fused_conv_train_plain(dk, h, v, xb, *args, **kw)
    want64 = K12.fused_conv_train_plain(dk.double(), h.double(), v.double(),
                                        xb.double(), *args, **kw)
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(torch, "K12 " + name, names, got,
                                       want32, want64))
  # control: TF32 products in the plain step must fail the one-step limit
  h = torch.zeros(CONV_S, device=dev)
  v = lipschitz.top_gram_eigenpair(d.reshape(CONV_S, -1))[1].contiguous()
  kw = dict(kernel_stride=stride, padding=padding, power_iters=2)
  args = (CONV_LAM, SEG_ITERS, SEG_STEP)
  want64 = K12.fused_conv_train_plain(d.double(), h.double(), v.double(),
                                      x[None].double(), *args, **kw)
  tf32 = K12.fused_conv_train_plain(d, h, v, x[None], *args,
                                    precision="tensorfloat32", **kw)
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    if float(w.abs().max()) > 0:
      err = float((t.double() - w).abs().max())
      ratios.append(err / limit(w))
      print("control: K12 plain step with TF32 products, %-10s max|d| fp64 "
            "%.3e, limit %.3e" % (what, err, limit(w)))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  return worst


def conv_segment_images(torch, conv_ops, dev, steps, gen, seed):
  """(steps, SEG_BATCH, 1, 272, 272) images made on the card from a
  torch.Generator: conv_images' distribution (2% of code positions
  active, N(0, 1) amplitudes, N(0, 0.01^2) noise, border zeroed)."""
  g = torch.Generator(device=dev).manual_seed(seed)
  padding = conv_padding(CONV_IMG, CONV_K, CONV_STRIDE)
  hh = CONV_IMG + sum(padding[0])
  ch = 1 + (hh - CONV_K) // CONV_STRIDE
  lead, trail = padding[0]
  mask = torch.zeros((hh, hh), device=dev)
  mask[lead:hh - trail, lead:hh - trail] = 1.0
  gen_t = torch.tensor(gen, device=dev)
  out = torch.empty((steps, SEG_BATCH, 1, hh, hh), device=dev)
  for i in range(steps):
    shape = (SEG_BATCH, CONV_S, ch, ch)
    z = torch.randn(shape, generator=g, device=dev) * (
        torch.rand(shape, generator=g, device=dev) < 0.02)
    x = conv_ops.synthesize(z, gen_t, (CONV_STRIDE, CONV_STRIDE))
    out[i] = (x + 0.01 * torch.randn(x.shape, generator=g, device=dev)) * mask
  return out


def conv_segment_params(steps, stepsize):
  return {
      "mode": "convolutional",
      "num_epochs": 1,
      "code_inference_algorithm": "fista",
      "inference_param_schedule": {
          0: {"sparsity_weight": CONV_LAM, "num_iters": SEG_ITERS}},
      "dictionary_update_algorithm": "sc_cheap_quadratic_descent",
      "dict_update_param_schedule": {
          0: {"stepsize": stepsize, "num_iters": 1}},
      "strides": (CONV_STRIDE, CONV_STRIDE),
      "padding": ((8, 8), (8, 8)),
      "stdout_print_interval": steps,
  }


def held_out_fista_conv_loss(conv_ista_fista, sparse_coding, x, kernels):
  """Average conv LASSO loss of the held-out batch under ``kernels``,
  FISTA 25 as the segment trains."""
  stride, padding = (CONV_STRIDE, CONV_STRIDE), ((8, 8), (8, 8))
  codes = conv_ista_fista.run(x, kernels, stride, padding, CONV_LAM,
                              SEG_ITERS, formulation="pallas")
  return sparse_coding.compute_metrics(
      x, codes, kernels, kernels, mode="convolutional",
      sparsity_weight=CONV_LAM, kernel_stride=stride,
      padding=padding)["Average LASSO Loss"]


def laplace_mixtures(torch, dev, num, mixing, g):
  """(num, n) Laplace(0, 1) sources mixed by ``mixing``: x = s A."""
  u = torch.rand((2, num, mixing.shape[0]), generator=g, device=dev,
                 dtype=torch.float64)
  src = torch.log1p(-u[0]) - torch.log1p(-u[1])  # difference of exponentials
  return (src @ mixing.double()).float()


def ica_nll(torch, x, dictionary):
  """Held-out Laplace negative log-likelihood of x = c D, per sample:
  mean sum |c| + log |det D|, with c = x D^-1 (in float64)."""
  d = dictionary.double()
  codes = torch.linalg.solve(d.T, x.double().T).T
  return float(codes.abs().sum(dim=1).mean() + torch.linalg.slogdet(d)[1])


def random_orthogonal(n, seed):
  return np.linalg.qr(np.random.RandomState(seed).randn(n, n))[0].astype(
      np.float32)


def random_mixing(n, seed):
  """A seeded random mixing matrix Q1 diag(e^u) Q2, u uniform in [-1, 1]:
  condition number at most e^2."""
  rng = np.random.RandomState(seed)
  q1, q2 = (np.linalg.qr(rng.randn(n, n))[0] for _ in range(2))
  return ((q1 * np.exp(rng.uniform(-1, 1, n))) @ q2).astype(np.float32)


def gapped_mixtures(torch, dev, num, mixing, g, gap=0.05):
  """(num, n) sources of magnitude gap + Exp(1) and random sign, mixed by
  ``mixing``: with D = mixing their codes keep clear of zero."""
  shape = (num, mixing.shape[0])
  mag = gap - torch.log1p(-torch.rand(shape, generator=g, device=dev,
                                      dtype=torch.float64))
  sign = torch.where(torch.rand(shape, generator=g, device=dev) < 0.5,
                     -1.0, 1.0).double()
  return ((sign * mag) @ mixing.double()).float()


def ica_kernel_cases(torch, K8, invertible_linear, dev):
  """Phase 20: K8 against its fp32 and fp64 plain versions over one step
  and a 50-step segment with one and three update iterations, a stale-seed
  boost case, the stepsize-40 divergence and a TF32 control.

  sign() is discontinuous at 0: a code that rounding moves across zero
  changes a column of the statistic by 2 |c| / b and D by about 1e-5 per
  step, above the limit (measured: 4.9e-5 after 50 steps with three
  update iterations on Laplace mixtures from a random start).  So the
  kernel cases start from the mixing matrix itself, with sources at least
  0.05 from zero: the codes stay clear of 0 for the whole segment, and
  the comparison is well posed.  Phase 21 judges the trainer on Laplace
  mixtures from a random start by its quality checks instead.  The
  mixing matrix is a random orthogonal one: a badly conditioned D would
  put the fp32 inverse itself, not the kernel, outside the limit."""
  mixing = torch.tensor(random_orthogonal(ICA_N, 11), device=dev)
  g = torch.Generator(device=dev).manual_seed(200)
  seg = gapped_mixtures(torch, dev, 50 * ICA_BATCH, mixing, g).reshape(
      50, ICA_BATCH, ICA_N)
  d0 = mixing.contiguous()
  x0 = invertible_linear.exact_inverse(d0)
  names = ("dictionary", "inverse", "residual")
  limits = {"residual": ICA_LIMIT}
  worst = 0.0
  cases = [
      ("one step upd 1", seg[:1], x0, 1),
      ("one step upd 3", seg[:1], x0, 3),
      ("50 steps upd 1", seg, x0, 1),
      ("50 steps upd 3", seg, x0, 3),
      ("stale seed (1.35 X) boost", seg[:3], 1.35 * x0, 1),
  ]
  for name, xb, xi, upd in cases:
    kw = dict(refine_iters=ICA_REFINE, upd_num_iters=upd,
              boost_tol=ICA_BOOST_TOL)
    got = K8.fused_ica_train_segment(d0, xi.contiguous(), xb, ICA_STEP, **kw)
    check(K8.last_route == "persistent", "K8 took the %s route"
          % K8.last_route)
    want32 = K8.fused_ica_train_plain(d0, xi, xb, ICA_STEP, **kw)
    want64 = K8.fused_ica_train_plain(d0.double(), xi.double(), xb.double(),
                                      ICA_STEP, **kw)
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(torch, "K8 " + name, names, got,
                                       want32, want64, limits))
  # stepsize 40: the residual must show the divergence in both
  kw = dict(refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL)
  got = K8.fused_ica_train_segment(d0, x0, seg[:3], 40.0, **kw)
  want = K8.fused_ica_train_plain(d0, x0, seg[:3], 40.0, **kw)
  res_k, res_p = float(got[2]), float(want[2])
  print("K8 stepsize 40: segment residual kernel %r, plain %r (guard %g)" % (
      res_k, res_p, ICA_GUARD_TOL))
  check(not res_k < ICA_GUARD_TOL and not res_p < ICA_GUARD_TOL,
        "stepsize 40 did not show in the residual: %r / %r" % (res_k, res_p))
  # control: TF32 refreshes and codes in the plain step must fail
  kw = dict(refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL)
  want64 = K8.fused_ica_train_plain(d0.double(), x0.double(),
                                    seg[:1].double(), ICA_STEP, **kw)
  tf32 = K8.fused_ica_train_plain(d0, x0, seg[:1], ICA_STEP,
                                  precision="tensorfloat32", **kw)
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    lim = limits.get(what, limit(w))
    err = float((t.double() - w).abs().max())
    ratios.append(err / lim)
    print("control: K8 plain step with TF32 products, %-10s max|d| fp64 "
          "%.3e, limit %.3e" % (what, err, lim))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  return worst


def ica_params(steps, stepsize):
  return {
      "num_epochs": 1,
      "dictionary_update_algorithm": "ica_natural_gradient",
      "dict_update_param_schedule": {0: {"stepsize": stepsize,
                                         "num_iters": 1}},
      "refine_iters": ICA_REFINE,
      "stdout_print_interval": steps,
  }


# ---------------------------------------------------------------------------
# the big-dictionary residual form (K19 at a code axis of size 1)
# ---------------------------------------------------------------------------
BIG_S, BIG_B = 2048, 128  # bench.py's measure_bigdict rows (:541-591, :831-846)
BIG_STEP = 0.1            # bench's cheap-quadratic stepsize
BIG_STEPS = 200           # bench's one segment (25,600 patches)
BIG_HELD = 512            # held-out patches for the quality check
BIG_SMALL_S = 512         # the regularizer's s x s cases


def code_shard_step_bound(b, s, n, iters, power_iters=2, upd_iters=1):
  """K19, one step in residual form: per FISTA iteration z D and
  (z D - X) D^T, 2 b s n FLOPs each; (power_iters + 1) applications of
  D^T D as two matvecs through D; per update iteration codes D and
  codes^T resid; reading X and D, writing D."""
  flops = (4.0 * b * s * n * (iters + upd_iters)
           + 4.0 * (power_iters + 1) * s * n)
  return bound(flops, 4.0 * (b * n + 2 * s * n))


def bigdict_mixtures(torch, dev, num, gen, group, seed):
  """(num, n) mixtures of the generating dictionary gen (s, n), made on
  the card: 12.8 of the s atoms active per patch on average (5% of 256,
  as synthetic_patches), whole contiguous groups of ``group`` atoms
  active together, N(0, 0.05^2) amplitudes, N(0, 0.003^2) noise."""
  g = torch.Generator(device=dev).manual_seed(seed)
  s, n = gen.shape
  active = torch.rand(num, s // group, generator=g, device=dev) < 12.8 / s
  amps = torch.randn(num, s, generator=g, device=dev) * 0.05 * \
      active.repeat_interleave(group, dim=1)
  return amps @ gen + 0.003 * torch.randn(num, n, generator=g, device=dev)


def ragged_partition(s, seed):
  """A seeded disjoint partition of range(s) into shuffled groups of 1 to
  6 rows: a layout that takes the member-table prox."""
  rng = np.random.RandomState(seed)
  perm, groups, at = rng.permutation(s), [], 0
  while at < s:
    size = int(rng.randint(1, 7))
    groups.append(sorted(int(i) for i in perm[at:at + size]))
    at += size
  return groups


def refusal_problem(torch, dev):
  """A tiny fc problem on the card for the refusal checks: D (24, 16),
  h, v (16,) and two batches of 10."""
  rng = np.random.RandomState(9)
  d = torch.tensor(unit_rows(rng, 24, 16), device=dev)
  v = torch.tensor(rng.randn(16).astype(np.float32), device=dev)
  x = torch.tensor(rng.randn(2, 10, 16).astype(np.float32), device=dev)
  return d, torch.zeros(24, device=dev), v, x


def check_refuses(label, fn, item, counter=None):
  """fn must raise NotImplementedError naming ROADMAP.md §1 item ``item``
  and launch no kernel of ``counter``'s module."""
  before = None if counter is None else counter.launches
  try:
    fn()
  except NotImplementedError as err:
    check("item %s" % item in str(err),
          "%s: the refusal names no item %s: %s" % (label, item, err))
  else:
    raise RuntimeError("chip_smoke: %s was not refused" % label)
  check(counter is None or counter.launches == before,
        "%s launched a kernel before refusing" % label)
  print("refused on the card: %s (ROADMAP.md §1 item %s)" % (label, item))


def check_runs(label, fn, counter):
  """fn, which raised before the early stop reached the fc/subspace
  kernels (phase 43), the conv kernels (phase 44) or the data-parallel and
  big-dictionary segments (phase 45), runs and launches counter's
  kernel."""
  before = counter.launches
  fn()
  check(counter.launches > before, "%s launched no kernel" % label)
  print("runs on the card: %s (%d launches)" % (
      label, counter.launches - before))


def code_shard_kernel_cases(torch, cs, lipschitz, gen, dev):
  """Phase 23: one K19 step against its fp32 and fp64 plain versions at
  bench's width and at s = 512; a TF32 control; the refusals."""
  names = ("dictionary", "hessian", "eigvec", "codes", "stepsize")
  sub_cq = "subspace_sc_cheap_quadratic_descent"
  d = torch.tensor(unit_rows(np.random.RandomState(2), BIG_S, 256),
                   device=dev)
  small_d = d[:BIG_SMALL_S].contiguous()
  small_gen = gen[:BIG_SMALL_S].contiguous()
  x_fc = bigdict_mixtures(torch, dev, BIG_B, gen, 1, seed=230)[None]
  x_g = bigdict_mixtures(torch, dev, BIG_B, gen, 4, seed=231)[None]
  x_small = bigdict_mixtures(torch, dev, BIG_B, small_gen, 4, seed=232)[None]
  bench_g = cs.code_shard_group_arrays(contiguous_groups(BIG_S, 4), BIG_S, 1)
  pen_g = cs.code_shard_group_arrays(contiguous_groups(BIG_SMALL_S, 4),
                                     BIG_SMALL_S, 1)
  rag_g = cs.code_shard_group_arrays(ragged_partition(BIG_SMALL_S, 23),
                                     BIG_SMALL_S, 1)
  # hard thresholds are discontinuous: a small size only (phase 2)
  rng = np.random.RandomState(23)
  tiny_d = torch.tensor(unit_rows(rng, 96, 24), device=dev)
  tiny_x = torch.tensor(rng.randn(1, 13, 24).astype(np.float32) * 0.05,
                        device=dev)
  # (name, batches, dictionary, flags)
  cases = [
      ("bench fc fista cheap-quad", x_fc, d, {}),
      ("bench 512x4 groups cheap-quad", x_g, d,
       {"expand_local": bench_g[0][0], "update_alg": sub_cq}),
      ("s512 4s penalty 0.15 cheap-quad", x_small, small_d,
       {"expand_local": pen_g[0][0], "comem_local": pen_g[1][0],
        "alignment_penalty": 0.15, "update_alg": sub_cq}),
      ("s512 ragged 1-6 steepest upd 2", x_small, small_d,
       {"expand_local": rag_g[0][0], "upd_num_iters": 2,
        "update_alg": "subspace_sc_steepest_descent"}),
      ("s96 n24 ista hard nonneg upd 2", tiny_x, tiny_d,
       {"variant": "ista", "hard": True, "nonneg": True,
        "upd_num_iters": 2, "update_alg": "sc_steepest_descent"}),
  ]
  worst = 0.0
  for name, x, dk, flags in cases:
    h = torch.zeros(dk.shape[0], device=dev)
    v = lipschitz.top_gram_eigenpair(dk)[1].contiguous()
    kw = dict(flags, power_iters=2, return_stepsize=True)
    args = (LAM, TRAIN_ITERS, BIG_STEP)
    before = cs.launches
    got = cs.fused_code_sharded_train_segment(dk, h, v, x, *args, **kw)
    check(cs.launches == before + 1, name + ": K19 did not count its step")
    check(cs.last_route == "persistent", name + ": K19 took the %s route"
          % cs.last_route)
    want32 = cs.fused_code_sharded_train_segment_plain(dk, h, v, x, *args,
                                                       **kw)
    want64 = cs.fused_code_sharded_train_segment_plain(
        dk.double(), h.double(), v.double(), x.double(), *args, **kw)
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(torch, "K19 " + name, names, got,
                                       want32, want64))
  # control: TF32 products in the plain step must fail the one-step limit
  h = torch.zeros(BIG_S, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  args = (LAM, TRAIN_ITERS, BIG_STEP)
  want64 = cs.fused_code_sharded_train_segment_plain(
      d.double(), h.double(), v.double(), x_fc.double(), *args,
      power_iters=2)
  tf32 = cs.fused_code_sharded_train_segment_plain(
      d, h, v, x_fc, *args, power_iters=2, precision="tensorfloat32")
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    if float(w.abs().max()) > 0:
      err = float((t.double() - w).abs().max())
      ratios.append(err / limit(w))
      print("control: K19 plain step with TF32 products, %-10s max|d| fp64 "
            "%.3e, limit %.3e" % (what, err, limit(w)))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  # the early stop runs (phase 45 holds it to plain); the tiers are refused
  step = (d, h, v, x_fc) + args
  check_runs("K19 early_stopping_epsilon", lambda: (
      cs.fused_code_sharded_train_segment(*step,
                                          early_stopping_epsilon=1e-3)), cs)
  check_refuses("K19 mxu='bf16x3'", lambda: (
      cs.fused_code_sharded_train_segment(*step, mxu="bf16x3")), "3a", cs)
  return worst



# ---------------------------------------------------------------------------
# the data-parallel layer (K3, K7 and K9: the per-shard solve+stats steps)
# ---------------------------------------------------------------------------
DP_STEPS2 = 50            # steps of each world-of-2 run
DP_GRAM_STEPS2 = 20       # steps of the conv gram-form world-of-2 run
DP_CHILD_TIMEOUT = 600    # seconds a world-of-2 rank may take
# how far a 1,000-step cheap-quadratic run may sit from the single-device
# trainer's: FISTA with the cheap-quadratic update amplifies rounding
# (ROADMAP.md §3 measures 8e-5 to 2.2e-4 on 12 CPU steps for a one-ulp
# change); the data-parallel step forms the same gradient as C D - B
DP_FLOOR = 2 * 2.2e-4


def solve_stats_bound(b, s, n, iters, power_iters=2):
  """K3 / K7, one shard's step: G = D D^T, c = X D^T, the solve, the
  power refresh, C = codes^T codes and B = codes^T X; reading X, D and v,
  writing the codes, C, B, stat and v."""
  flops = (2.0 * s * s * n + 2.0 * b * s * n + 2.0 * b * s * s * iters
           + 2.0 * power_iters * s * s + 2.0 * b * s * s + 2.0 * b * s * n)
  return bound(flops, 4.0 * (b * n + s * n + b * s + s * s + s * n + 3 * s))


def ica_stats_bound(n, b, refine=ICA_REFINE):
  """K9, one shard's step: refine x 2 n^3 products, the residual, codes and
  the statistic; reading the batch, D and X, writing X and the statistic."""
  flops = (4.0 * refine + 2) * n ** 3 + 4.0 * b * n * n
  return bound(flops, 4.0 * (b * n + 4 * n * n))


def tf32_control(torch, label, names, tf32, want64):
  """A plain version run with TF32 products must fail the limit on some
  output."""
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    if float(w.abs().max()) > 0:
      err = float((t.double() - w).abs().max())
      ratios.append(err / limit(w))
      print("control: %s with TF32 products, %-10s max|d| fp64 %.3e, limit "
            "%.3e" % (label, what, err, limit(w)))
  check(max(ratios) > 1.0, label + ": the limit does not tell TF32 products "
        "from fp32")


def dp_kernel_cases(torch, parallel, K2, K6, K8, ica, sub, lipschitz,
                    invertible_linear, train_patches, gtrain, dev):
  """Phase 26: K3, K7 and K9 against their fp32 and fp64 plain versions,
  TF32 controls, and each kernel's replicated update held to the
  single-device kernel's step.  Returns the largest fp32 difference of
  each kernel."""
  mesh1 = parallel.make_mesh()
  names = ("codes", "cmat", "bmat", "stat", "eigvec", "stepsize")
  step_names = ("dictionary", "hessian", "eigvec", "codes")
  rng = np.random.RandomState(26)
  flag_d = unit_rows(np.random.RandomState(2), 256, 256)
  rag_d, rag_x = unit_rows(rng, 37, 24), rng.randn(13, 24)   # s > n, ragged
  wide_d, wide_x = unit_rows(rng, 24, 37), rng.randn(13, 37)  # s < n
  # (name, shard, dictionary, lambda, iters, flags)
  cases = [
      ("flagship b250 fista", train_patches[:TRAIN_BATCH], flag_d, LAM,
       TRAIN_ITERS, {}),
      ("flagship shard b125 fista", train_patches[:TRAIN_BATCH // 2], flag_d,
       LAM, TRAIN_ITERS, {}),
      ("ragged 13x37x24 (s > n)", rag_x, rag_d, 0.08, 20, {}),
      ("ragged 13x24x37 (s < n) ista", wide_x, wide_d, 0.08, 20,
       {"variant": "ista"}),
      ("13x37x24 ista hard nonneg", rag_x, rag_d, 0.08, 20,
       {"variant": "ista", "hard": True, "nonneg": True}),
  ]
  k3_err = 0.0
  for name, x, d, lam, iters, flags in cases:
    x = torch.tensor(np.asarray(x, np.float32), device=dev)
    d = torch.tensor(d, device=dev)
    v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
    flags = dict(flags, power_iters=2)
    before = K2.stats_launches
    got = K2.fused_solve_stats(d, v, x, lam, iters, **flags)
    check(K2.stats_launches == before + 1, name + ": K3 did not count")
    want32 = K2.fused_solve_stats_plain(d, v, x, lam, iters, **flags)
    want64 = K2.fused_solve_stats_plain(d.double(), v.double(), x.double(),
                                        lam, iters, **flags)
    torch.cuda.synchronize()
    k3_err = max(k3_err, compare_outputs(torch, "K3 " + name, names, got,
                                         want32, want64))
  x = torch.tensor(train_patches[:TRAIN_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  want64 = K2.fused_solve_stats_plain(d.double(), v.double(), x.double(), LAM,
                                      TRAIN_ITERS, power_iters=2)
  tf32_control(torch, "K3 plain", names, K2.fused_solve_stats_plain(
      d, v, x, LAM, TRAIN_ITERS, power_iters=2, precision="tensorfloat32"),
               want64)
  # the replicated update from K3's own statistics is K2's step
  for alg, upd in (("sc_cheap_quadratic_descent", 1),
                   ("sc_steepest_descent", 2)):
    k2 = K2.fused_train_segment(d, h, v, x[None], LAM, TRAIN_ITERS,
                                TRAIN_STEP, update_alg=alg, upd_num_iters=upd,
                                power_iters=2)
    dp = parallel.build_dp_fused_local_step(
        mesh1, "fista", alg, upd_num_iters=upd, power_iters=2)(
            d, h, v, x, LAM, TRAIN_ITERS, TRAIN_STEP)
    torch.cuda.synchronize()
    k3_err = max(k3_err, compare_outputs(
        torch, "K3 update == K2 step, %s upd %d" % (alg[3:], upd),
        step_names, dp, k2, [t.double() for t in k2]))

  # K7: the subspace counterpart
  flag_g = contiguous_groups(256, GROUP_SIZE)
  rag_g = [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0]]
  rag_gd, rag_gx = unit_rows(rng, 14, 24), rng.randn(10, 24)
  wide_g = [[(i + m) % 32 for m in range(8)] for i in range(0, 32, 4)]
  wide_gd, wide_gx = unit_rows(rng, 32, 24), rng.randn(20, 24)  # GM 64 > n
  gcases = [
      ("flagship 64x4 b250", gtrain[:TRAIN_BATCH], flag_d, flag_g, LAM,
       TRAIN_ITERS, {}),
      ("flagship 64x4 shard b125", gtrain[:TRAIN_BATCH // 2], flag_d, flag_g,
       LAM, TRAIN_ITERS, {}),
      ("ragged overlapping s14 n24", rag_gx, rag_gd, rag_g, 0.05, 10, {}),
      ("overlap 8x8 GM64 > n24 ista", wide_gx, wide_gd, wide_g, 0.05, 10,
       {"variant": "ista"}),
      ("ragged s14 n24 hard", rag_gx, rag_gd, rag_g, 0.05, 10,
       {"hard": True}),
  ]
  k7_err = 0.0
  for name, x, d, groups, lam, iters, flags in gcases:
    x = torch.tensor(np.asarray(x, np.float32), device=dev)
    d = torch.tensor(d, device=dev)
    gather, mask, _ = sub.group_layout(groups, d.shape[0], dev)
    v = lipschitz.top_gram_eigenpair(
        sub.build_grouped_dictionary(d, gather, mask))[1].contiguous()
    flags = dict(flags, group_assignments=groups, power_iters=2)
    before = K6.stats_launches
    got = K6.fused_group_solve_stats(d, v, x, lam, iters, **flags)
    check(K6.stats_launches == before + 1, name + ": K7 did not count")
    want32 = K6.fused_group_solve_stats_plain(d, v, x, lam, iters, **flags)
    want64 = K6.fused_group_solve_stats_plain(
        d.double(), v.double(), x.double(), lam, iters, **flags)
    torch.cuda.synchronize()
    k7_err = max(k7_err, compare_outputs(torch, "K7 " + name, names, got,
                                         want32, want64))
  x = torch.tensor(gtrain[:TRAIN_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()  # 64 x 4: Dg is D
  gkw = dict(group_assignments=flag_g, power_iters=2)
  want64 = K6.fused_group_solve_stats_plain(
      d.double(), v.double(), x.double(), LAM, TRAIN_ITERS, **gkw)
  tf32_control(torch, "K7 plain", names, K6.fused_group_solve_stats_plain(
      d, v, x, LAM, TRAIN_ITERS, precision="tensorfloat32", **gkw), want64)
  # the replicated update from K7's statistics is K6's step: the flagship,
  # and the ragged groups with the anti-alignment penalty
  pen_g = rag_g + [[0, 1]]
  pen_d = torch.tensor(unit_rows(rng, 14, 16), device=dev)
  pen_x = torch.tensor(rng.randn(10, 16).astype(np.float32), device=dev)
  for label, dd, xx, groups, lam, iters, step, penalty in (
      ("flagship 64x4", d, x, flag_g, LAM, TRAIN_ITERS, SUB_STEP, 0.0),
      ("penalty 0.4 s14 n16", pen_d, pen_x, pen_g, 0.05, 10, 0.1, 0.4)):
    hh = torch.zeros(dd.shape[0], device=dev)
    gather, mask, _ = sub.group_layout(groups, dd.shape[0], dev)
    vv = lipschitz.top_gram_eigenpair(
        sub.build_grouped_dictionary(dd, gather, mask))[1].contiguous()
    k6 = K6.fused_group_train_segment(
        dd, hh, vv, xx[None], lam, iters, step, group_assignments=groups,
        power_iters=2, alignment_penalty=penalty)
    dp = parallel.build_dp_group_fused_local_step(
        mesh1, "subspace_fista", "subspace_sc_cheap_quadratic_descent",
        group_assignments=groups, alignment_penalty=penalty, power_iters=2)(
            dd, hh, vv, xx, lam, iters, step)
    torch.cuda.synchronize()
    k7_err = max(k7_err, compare_outputs(
        torch, "K7 update == K6 step, " + label, step_names, dp, k6,
        [t.double() for t in k6]))

  # K9: gapped sources from their orthogonal mixing matrix (phase 20: the
  # codes must stay clear of sign()'s discontinuity at 0)
  mixing = torch.tensor(random_orthogonal(ICA_N, 11), device=dev)
  g = torch.Generator(device=dev).manual_seed(260)
  xb = gapped_mixtures(torch, dev, ICA_BATCH, mixing, g)
  d0 = mixing.contiguous()
  x0 = invertible_linear.exact_inverse(d0)
  inames = ("inverse", "statistic", "residual")
  ilimits = {"residual": ICA_LIMIT}
  # the statistic sums 250 products of order 1: it is held to 1e-5 of its
  # largest entry without the 1e-4 cap, which is the codes' contract
  stat_limit = lambda want: dict(
      ilimits, statistic=REL_TOL * float(want[1].abs().max()))
  k9_err = 0.0
  # (name, shard, seed, boost tolerance): 1.35 X leaves 0.35^8 = 2e-4 after
  # three refreshes, above 1e-6, so the boost fires; 1.02 X leaves 0.02^8,
  # below 1e-3, so it does not
  for name, shard, xi, tol in (
      ("exact seed b250", xb, x0, ICA_BOOST_TOL),
      ("shard b125, no boost asked", xb[:ICA_BATCH // 2], x0, None),
      ("stale 1.35 X, boost fires", xb, 1.35 * x0, ICA_BOOST_TOL),
      ("stale 1.02 X, tol 1e-3: no boost", xb, 1.02 * x0, 1e-3)):
    kw = dict(refine_iters=ICA_REFINE, boost_tol=tol)
    before = K8.stats_launches
    got = K8.ica_solve_stats(d0, xi.contiguous(), shard, **kw)
    check(K8.stats_launches == before + 1, name + ": K9 did not count")
    want32 = K8.ica_solve_stats_plain(d0, xi, shard, **kw)
    want64 = K8.ica_solve_stats_plain(d0.double(), xi.double(),
                                      shard.double(), **kw)
    torch.cuda.synchronize()
    k9_err = max(k9_err, compare_outputs(torch, "K9 " + name, inames, got,
                                         want32, want64, stat_limit(want64)))
  kw = dict(refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL)
  want64 = K8.ica_solve_stats_plain(d0.double(), x0.double(), xb.double(),
                                    **kw)
  tf32_control(torch, "K9 plain", inames[:2], K8.ica_solve_stats_plain(
      d0, x0, xb, precision="tensorfloat32", **kw)[:2], want64[:2])
  for upd in (1, 3):
    k8 = K8.fused_ica_train_segment(d0, x0, xb[None], ICA_STEP,
                                    upd_num_iters=upd, **kw)
    dp = ica._segment_runner_dp(upd, mesh1, True, refine_iters=ICA_REFINE,
                                fused=True)(d0, x0, xb[None], ICA_STEP)
    torch.cuda.synchronize()
    k9_err = max(k9_err, compare_outputs(
        torch, "K9 update == K8 step, upd %d" % upd,
        ("dictionary", "inverse", "residual"), dp, k8,
        [t.double() for t in k8], ilimits))
  # the tiers on a CUDA tensor: K3 and K7 run them (phase 47 holds them
  # to their plain versions at the flagship); K9's still wait
  xt = torch.tensor(train_patches[:TRAIN_BATCH // 2], device=dev)
  dt = torch.tensor(flag_d, device=dev)
  vt = lipschitz.top_gram_eigenpair(dt)[1].contiguous()
  check_tier_runs(torch, "K3 mxu='bf16x3'", lambda xx, mxu: (
      K2.fused_solve_stats(dt, vt, xx, LAM, 5, mxu=mxu)),
                  lambda xx, mxu: K2.fused_solve_stats_plain(
                      dt, vt, xx, LAM, 5, mxu=mxu), xt, K2,
                  "stats_tier_launches", "bf16x3")
  check_tier_runs(torch, "K7 mxu='bf16'", lambda xx, mxu: (
      K6.fused_group_solve_stats(dt, vt, xx, LAM, 5,
                                 group_assignments=flag_g, mxu=mxu)),
                  lambda xx, mxu: K6.fused_group_solve_stats_plain(
                      dt, vt, xx, LAM, 5, group_assignments=flag_g,
                      mxu=mxu), xt, K6, "stats_tier_launches", "bf16")
  check_refuses("K9 mxu='bf16x3'", lambda: K8.ica_solve_stats(
      d0, x0, xb, mxu="bf16x3"), "3a")
  return k3_err, k7_err, k9_err


def nccl_probe(torch, dist, store):
  """Whether NCCL is built in and a one-rank group initialises and reduces
  a device tensor: (available, works, note).  A probe: its failure is an
  answer, printed, not an error."""
  if not dist.is_nccl_available():
    return False, False, "torch.distributed has no NCCL backend"
  try:
    dist.init_process_group("nccl", init_method="file://" + store, rank=0,
                            world_size=1)
    t = torch.arange(4.0, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    same = bool((t == torch.arange(4.0, device="cuda")).all())
    return True, same, ("one-rank all_reduce of a device tensor "
                        + ("returned it unchanged" if same else "CHANGED it"))
  except (RuntimeError, ValueError) as err:
    return True, False, "%s: %s" % (type(err).__name__, err)
  finally:
    if dist.is_initialized():
      dist.destroy_process_group()


# the world-of-2 runs: (key, the family, the update rule or None for the
# family's cheap-quadratic default, update iterations, steps, slices of the
# mesh: 1 is data_parallel=True, 2 a mesh with a 'dcn' axis of 2)
DP2_RUNS = (("fc steepest", "fc", "sc_steepest_descent", 1, DP_STEPS2, 1),
            ("fc cheap-quad", "fc", None, 1, DP_STEPS2, 1),
            ("subspace steepest", "subspace", "subspace_sc_steepest_descent",
             1, DP_STEPS2, 1),
            ("subspace cheap-quad", "subspace", None, 1, DP_STEPS2, 1),
            ("ica", "ica", None, 1, DP_STEPS2, 1),
            ("conv steepest", "conv", "sc_steepest_descent", 1, DP_STEPS2, 1),
            ("conv cheap-quad", "conv", None, 1, DP_STEPS2, 1),
            ("conv cheap-quad upd 3 (gram form)", "conv", None, 3,
             DP_GRAM_STEPS2, 1),
            ("conv cheap-quad dcn=2 (K13)", "conv", None, 1, DP_STEPS2, 2),
            ("fc cheap-quad dcn=2 (K3)", "fc", None, 1, DP_STEPS2, 2),
            ("subspace cheap-quad dcn=2 (K7)", "subspace", None, 1,
             DP_STEPS2, 2),
            ("ica dcn=2 (K9)", "ica", None, 1, DP_STEPS2, 2))
DP2_ROUTE_STEPS = 5       # K18's two routes at a world of 2
# what each rank counts, in dp_rank_main's order
DP2_COUNTS = ("K3", "K7", "K9", "K13", "K17", "K15", "K16", "K18", "K2",
              "K6", "K8", "K12")


def dp2_conv_images(torch):
  """The conv runs' (DP_STEPS2, 40, 1, 272, 272) images, made on the card
  from a seed: each rank and the parent make the same ones."""
  from vtc_tpu_torch.ops import convolutions as conv_ops
  gen = windowed_kernels(np.random.RandomState(0), CONV_S, 1, CONV_K)
  return conv_segment_images(torch, conv_ops, torch.device("cuda", 0),
                             DP_STEPS2, gen, seed=28)


def dp2_run(torch, family, alg, upd, steps, data, data_parallel, dcn=1,
            eps=None):
  """One world-of-2 run, or its single-process twin on the global batch:
  ``steps`` steps through the trainers' entry points; ``eps`` the solves'
  early stop (conv)."""
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.training import compiled_epoch, ica
  dev = torch.device("cuda", 0)
  extra = {}
  if data_parallel:
    extra["data_parallel"] = (True if dcn == 1
                              else parallel.make_mesh(dcn=dcn))
  if family == "ica":
    return ica.train_dictionary_scanned(
        data["ica_x"], data["ica_d0"],
        dict(ica_params(steps, ICA_STEP), **extra), device=dev)
  if family == "conv":
    params = conv_segment_params(steps, SEG_STEP)
    params["dict_update_param_schedule"] = {
        0: {"stepsize": SEG_STEP, "num_iters": upd}}
  else:
    params = (train_params(steps) if family == "fc"
              else subspace_train_params(steps, SUB_STEP))
  if alg is not None:
    params["dictionary_update_algorithm"] = alg
  if eps is not None:
    params["early_stopping_epsilon"] = eps
  x = data[family + "_x"][:steps]
  return compiled_epoch.train_dictionary_scanned(
      x, x[:1], data[family + "_d0" if family == "conv" else "d0"],
      dict(params, **extra), device=dev)


def dp_rank_main(rank, world, workdir):
  """The hidden sub-command: one rank of the world-of-2 phase.  Joins the
  gloo group over the file store in ``workdir``, runs every DP2_RUNS entry
  with data_parallel=True on the shared card, and saves its results and
  launch counts to ``workdir``."""
  import os
  import torch
  import torch.distributed as dist
  from vtc_tpu_torch.ops import fused_conv_dp_train as K17
  from vtc_tpu_torch.ops import fused_conv_train as K12
  from vtc_tpu_torch.ops import fused_dp_train as K15
  from vtc_tpu_torch.ops import fused_group_dp_train as K16
  from vtc_tpu_torch.ops import fused_group_train_step as K6
  from vtc_tpu_torch.ops import fused_ica_train as K8
  from vtc_tpu_torch.ops import fused_train_step as K2
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  data = dict(np.load(os.path.join(workdir, "inputs.npz")))
  data["conv_x"] = dp2_conv_images(torch)
  dist.init_process_group("gloo", init_method="file://" + os.path.join(
      workdir, "store"), rank=rank, world_size=world)
  try:
    out = {}
    for key, family, alg, upd, steps, dcn in DP2_RUNS:
      out[key] = dp2_run(torch, family, alg, upd, steps, data, True,
                         dcn).cpu().numpy()
      if key == "ica":  # K18's route: two launches a step around the hook
        out["ica route"] = np.array(K8.last_route)
    # K17 with the stop: one share sum over the ranks an iteration (phase
    # 44)
    out["conv stop"] = dp2_run(
        torch, "conv", None, 1, DP2_STOP_STEPS, data, True,
        eps=float(data["conv_stop_eps"])).cpu().numpy()
    out["conv stop counts"] = K17.last_iters.cpu().numpy()
    torch.cuda.synchronize()
    out["launches"] = np.array([
        K2.stats_launches, K6.stats_launches, K8.stats_launches,
        K12.stats_launches, K17.launches, K15.launches, K16.launches,
        K8.dp_launches, K2.launches, K6.launches, K8.launches,
        K12.launches])
    # K18 at this world on both routes, forced (phase 40's comparison at a
    # world of 2: the persistent route's front and back launches around
    # the hook against the per-step route's C loop)
    from vtc_tpu_torch import parallel
    from vtc_tpu_torch.analysis_transforms.fully_connected import (
        invertible_linear)
    mesh = parallel.make_mesh()
    dev = torch.device("cuda", 0)
    d = torch.tensor(data["ica_d0"], device=dev)
    shard = mesh.shard(torch.tensor(data["ica_x"][:DP2_ROUTE_STEPS],
                                    device=dev), dim=1).contiguous()
    for route in ("steps", "persistent"):
      got = K8._launch_dp(d.clone(), 1.35 * invertible_linear.exact_inverse(d),
                          shard, mesh, ICA_STEP, ICA_REFINE, 2, ICA_BOOST_TOL,
                          route=route)
      for name, t in zip(("dictionary", "inverse", "residual"), got):
        out["k18 %s %s" % (route, name)] = t.cpu().numpy()
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **out)
  finally:
    dist.destroy_process_group()
  return 0


def dp_world_of_two(torch, fc_x, sub_x, d0, conv_d0, dev):
  """Phase 28: two processes of this script share the card, join a gloo
  group over a file store and run DP_STEPS2 fc, subspace and ICA steps on
  shards of 125 and the conv runs on shards of 20.  Both ranks must return
  bitwise the same state, which must match the single-process trainers on
  the global batch.  Returns rank 0's launch counts, {DP2_COUNTS name:
  count}."""
  import os
  import tempfile
  world = 2
  mixing = torch.tensor(random_orthogonal(ICA_N, 11), device=dev)
  g = torch.Generator(device=dev).manual_seed(280)
  ica_x = gapped_mixtures(torch, dev, DP_STEPS2 * ICA_BATCH, mixing,
                          g).reshape(DP_STEPS2, ICA_BATCH, ICA_N)
  # the stop run's eps: a mid-run stop of the conv runs' first solve
  from vtc_tpu_torch.ops import fused_conv_train, lipschitz, solver
  conv_x = dp2_conv_images(torch)
  fused_conv_train.fused_conv_train_plain(
      conv_d0, torch.zeros(CONV_S, device=dev),
      lipschitz.top_gram_eigenpair(conv_d0.reshape(CONV_S, -1))[1],
      conv_x[:1], CONV_LAM, SEG_ITERS, SEG_STEP,
      kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=((8, 8), (8, 8)),
      power_iters=2, early_stopping_epsilon=0.0)
  stop_eps_dp = stop_eps(solver.last_avgs, "mid")
  data = {"fc_x": fc_x[:DP_STEPS2].cpu().numpy(),
          "subspace_x": sub_x[:DP_STEPS2].cpu().numpy(),
          "d0": d0.cpu().numpy(), "ica_x": ica_x.cpu().numpy(),
          "ica_d0": mixing.cpu().numpy(), "conv_d0": conv_d0.cpu().numpy(),
          "conv_stop_eps": np.array(stop_eps_dp)}
  with tempfile.TemporaryDirectory() as workdir:
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(rank),
         str(world), workdir]) for rank in range(world)]
    try:
      codes = [proc.wait(timeout=DP_CHILD_TIMEOUT) for proc in procs]
    finally:
      for proc in procs:
        if proc.poll() is None:
          proc.kill()
          proc.wait()
    dt = time.perf_counter() - t0
    check(codes == [0] * world, "a world-of-2 rank failed: exit codes %s"
          % codes)
    ranks = [dict(np.load(os.path.join(workdir, "rank%d.npz" % rank)))
             for rank in range(world)]
  # the 'dcn' runs take K3, K7, K9 and K13's composition, every other run
  # K15, K16, K18 or K17, the sum called back from the kernel's C loop
  want = dict(K3=DP_STEPS2, K7=DP_STEPS2, K9=DP_STEPS2, K13=DP_STEPS2,
              K17=2 * DP_STEPS2 + DP_GRAM_STEPS2 + DP2_STOP_STEPS,
              K15=2 * DP_STEPS2,
              K16=2 * DP_STEPS2, K18=DP_STEPS2, K2=0, K6=0, K8=0, K12=0)
  want_launches = [want[name] for name in DP2_COUNTS]
  for rank, out in enumerate(ranks):
    check(list(out["launches"]) == want_launches,
          "rank %d launched %s, expected %s (%s)" % (
              rank, list(out["launches"]), want_launches,
              ", ".join(DP2_COUNTS)))
    check(str(out["ica route"]) == "persistent",
          "rank %d ran K18 on the %s route" % (rank, out["ica route"]))
    for name in ("dictionary", "inverse", "residual"):
      persistent, steps = (out["k18 %s %s" % (route, name)].tobytes()
                           for route in ("persistent", "steps"))
      check(persistent == steps
            and persistent == ranks[0]["k18 persistent " + name].tobytes(),
            "rank %d: K18's %s at a world of 2 differs between the routes "
            "or from rank 0's" % (rank, name))
  print("world of 2: K18's persistent route (front and back launches of "
        "ica_segment_kernel around the hook), %d steps from a stale 1.35 X "
        "seed at two update iterations, bitwise equal to the per-step route "
        "on both ranks" % DP2_ROUTE_STEPS)
  print("world of 2 on the one card (gloo, file store, statistics staged "
        "through pinned host buffers): both ranks done in %.1f s, each %s "
        "launches and no K2, K6, K8 or K12; K18 on the persistent route "
        "(front and back launches of ica_segment_kernel around the hook)"
        % (dt, ", ".join("%d %s" % (want[name], name)
                         for name in DP2_COUNTS[:8])))
  data["conv_x"] = conv_x
  counts = [out["conv stop counts"].tolist() for out in ranks]
  check(np.array_equal(ranks[0]["conv stop"], ranks[1]["conv stop"])
        and counts[0] == counts[1] and len(counts[0]) == DP2_STOP_STEPS,
        "K17 with the stop at a world of 2: the ranks differ (counts %s)"
        % counts)
  single = dp2_run(torch, "conv", None, 1, DP2_STOP_STEPS, data, False,
                   eps=stop_eps_dp)
  err = float(np.abs(ranks[0]["conv stop"] - single.cpu().numpy()).max())
  print("world of 2  conv cheap-quad with the stop (eps %.4g, K17, one "
        "share sum an iteration): ranks bitwise equal, the same counts "
        "every step %s; vs the single-process trainer (K12 with the stop) "
        "max|d| %.3e, rounding floor %.3e" % (stop_eps_dp, counts[0], err,
                                              DP_FLOOR))
  check(np.isfinite(ranks[0]["conv stop"]).all() and err <= DP_FLOOR,
        "K17 with the stop at a world of 2 differs from the single-process "
        "run by %.3e" % err)
  check(min(counts[0]) < SEG_ITERS, "no solve stopped early at a world of "
        "2: %s" % counts[0])
  for key, family, alg, upd, steps, _ in DP2_RUNS:
    check(np.array_equal(ranks[0][key], ranks[1][key]),
          key + ": the two ranks' replicated state is not bitwise equal")
    single = dp2_run(torch, family, alg, upd, steps, data, False)
    err = float(np.abs(ranks[0][key] - single.cpu().numpy()).max())
    strict = "cheap-quad" not in key
    lim = limit(single) if strict else DP_FLOOR
    print("world of 2  %-20s ranks bitwise equal; vs the single-process "
          "trainer on the global batch max|d| %.3e, %s %.3e" % (
              key, err, "limit" if strict else "rounding floor", lim))
    check(np.isfinite(ranks[0][key]).all() and err <= lim,
          "%s: world of 2 differs from the single-process run by %.3e, "
          "bound %.3e" % (key, err, lim))
  return dict(zip(DP2_COUNTS, (int(n) for n in ranks[0]["launches"])))


# ---------------------------------------------------------------------------
# conv data parallelism (K13: the conv solve+stats step of one shard)
# ---------------------------------------------------------------------------
K13_SUMS = ("grad_sum", "bx", "cm", "stat")  # sums over the shard


def conv_stats_flops(geo, b, iters, gram, power_iters=2):
  """K13's operations for one shard's step: K12's refresh, corr and solve,
  then the gradient form's residual synthesis and gradient product, or the
  gram form's bx product and the C_m product.  C_m is symmetric, so it
  needs (R*s)(R*s + 1) operations per block position, one triangle and
  the diagonal (the kernel computes both triangles)."""
  depth = 2.0 * geo["s"] * geo["r"] * geo["cpx"]
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  rs = geo["r"] * geo["s"]
  stats = (depth + rs * (rs + 1.0)) * blocks if gram else 2 * depth * blocks
  return (depth * geo["s"] + 2.0 * power_iters * geo["s"] ** 2
          + b * (depth * (codes + iters * (blocks + codes)) + stats))


def conv_stats_bound(geo, b, iters, gram, power_iters=2):
  """K13, one shard's step: ``conv_stats_flops``; reading the images and
  the kernels, writing the codes and statistics."""
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  rs = geo["r"] * geo["s"]
  kernel = geo["c"] * geo["kh"] * geo["kw"]
  out = geo["cpx"] * rs + (rs * rs if gram else 0) + geo["s"]
  nbytes = 4.0 * (b * geo["c"] * geo["sv"] * geo["sh"] * blocks
                  + kernel * geo["s"] + b * geo["s"] * codes + out)
  return bound(conv_stats_flops(geo, b, iters, gram, power_iters), nbytes)


def conv_dp_bound(geo, b, iters, upd_iters, steps, power_iters=2):
  """K17, one step of a segment of ``steps`` at a world of 1: K13's work
  on the shard (the gram form at more than one update iteration) and the
  update, whose gram form adds the product pack(D') C_m, 2 cpx (R*s)^2
  per update iteration; reading each step's images, and per segment the
  kernels once, writing the kernels and the last codes once."""
  gram = upd_iters > 1
  rs = geo["r"] * geo["s"]
  flops = (conv_stats_flops(geo, b, iters, gram, power_iters)
           + (upd_iters * 2.0 * geo["cpx"] * rs * rs if gram else 0.0))
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  kernel = geo["c"] * geo["kh"] * geo["kw"]
  nbytes = 4.0 * (b * geo["c"] * geo["sv"] * geo["sh"] * blocks
                  + (2 * kernel * geo["s"] + b * geo["s"] * codes) / steps)
  return bound(flops, nbytes)


def k13_names(gram):
  return (("codes", "bx", "cm", "stat", "eigvec", "stepsize") if gram
          else ("codes", "grad_sum", "stat", "eigvec", "stepsize"))


def k13_limits(names, want64):
  """The sums over the shard are held to 1e-5 of their largest entry
  without the codes' 1e-4 cap (a sum of 43,560 products: K9's rule)."""
  return {what: REL_TOL * float(w.abs().max())
          for what, w in zip(names, want64) if what in K13_SUMS}


def conv_stats_kernel_cases(torch, K12, parallel, conv_ops, lipschitz,
                            x_flag, flag_d, padding, dev):
  """Phase 30: K13 against its fp32 and fp64 plain versions in both forms,
  its replicated update held to K12's step, a TF32 control and the
  refusals.  Returns the largest fp32 difference."""
  stride = (CONV_STRIDE, CONV_STRIDE)
  x = torch.tensor(x_flag[:SEG_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  d_init = torch.tensor(unit_kernels(np.random.RandomState(2), CONV_S, 1,
                                     CONV_K), device=dev)
  gen12 = windowed_kernels(np.random.RandomState(0), CONV_S, 1, 12)
  x12, pad12 = conv_images(torch, conv_ops, dev, SEG_BATCH, gen12,
                           CONV_STRIDE, CONV_IMG, seed=3)
  # c = 3, small, hard and nonnegative (discontinuous thresholds: small
  # sizes only), stride 4 = kernel; padding 2 is no stride multiple, so the
  # gram form is refused there
  rng = np.random.RandomState(6)
  x3 = torch.tensor(np.pad(rng.randn(3, 3, 16, 16),
                           ((0, 0), (0, 0), (2, 2), (2, 2))).astype(
                               np.float32), device=dev)
  d3 = torch.tensor(unit_kernels(rng, 6, 3, 4), device=dev)
  pad3 = ((2, 2), (2, 2))
  # (name, images, kernels, stride, padding, lambda, iters, forms, flags)
  cases = [
      ("flagship b40 fista25", x, d, stride, padding, CONV_LAM, SEG_ITERS,
       (False, True), {}),
      ("shard b20 fista25", x[:SEG_BATCH // 2], d, stride, padding, CONV_LAM,
       SEG_ITERS, (False, True), {}),
      ("b5 ista25 random kernels", x[:CONV_TRAIN_BATCH], d_init, stride,
       padding, CONV_LAM, CONV_TRAIN_ITERS, (False,), {"variant": "ista"}),
      ("12x12/8 zero-extended 268 b40", torch.tensor(x12, device=dev),
       torch.tensor(gen12, device=dev), stride, pad12, CONV_LAM, SEG_ITERS,
       (False,), {}),
      ("c3 4x4/4 ista hard", x3, d3, (4, 4), pad3, 0.05, 20, (False,),
       {"variant": "ista", "hard": True}),
      ("c3 4x4/4 fista nonneg", x3, d3, (4, 4), pad3, 0.05, 20, (False,),
       {"nonneg": True}),
  ]
  worst = 0.0
  for name, xb, dk, strd, pad, lam, iters, forms, flags in cases:
    s = dk.shape[0]
    v = lipschitz.top_gram_eigenpair(dk.reshape(s, -1))[1].contiguous()
    for gram in forms:
      kw = dict(flags, kernel_stride=strd, padding=pad, power_iters=2,
                gram_stats=gram)
      before = K12.stats_launches
      got = K12.conv_solve_stats(dk, v, xb, lam, iters, **kw)
      check(K12.stats_launches == before + 1, name + ": K13 did not count")
      want32 = K12.conv_solve_stats_plain(dk, v, xb, lam, iters, **kw)
      want64 = K12.conv_solve_stats_plain(dk.double(), v.double(),
                                          xb.double(), lam, iters, **kw)
      torch.cuda.synchronize()
      names = k13_names(gram)
      worst = max(worst, compare_outputs(
          torch, "K13 %s %s" % (name, "gram" if gram else "grad"), names,
          got, want32, want64, k13_limits(names, want64)))
  # the replicated update from K13's statistics is K12's step: the
  # gradient form at one update iteration, the gram form at three
  mesh1 = parallel.make_mesh()
  h = torch.zeros(CONV_S, device=dev)
  v = lipschitz.top_gram_eigenpair(d.reshape(CONV_S, -1))[1].contiguous()
  step_names = ("dictionary", "hessian", "eigvec", "codes")
  for upd in (1, 3):
    k12 = K12.fused_conv_train_segment(
        d, h, v, x[None], CONV_LAM, SEG_ITERS, SEG_STEP, kernel_stride=stride,
        padding=padding, upd_num_iters=upd, power_iters=2)
    dp = parallel.build_dp_conv_fused_local_step(
        mesh1, "fista", "sc_cheap_quadratic_descent", kernel_stride=stride,
        padding=padding, upd_num_iters=upd, power_iters=2)(
            d, h, v, x, CONV_LAM, SEG_ITERS, SEG_STEP)
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(
        torch, "K13 update == K12 step, %s form upd %d" % (
            "gram" if upd > 1 else "gradient", upd), step_names, dp, k12,
        [t.double() for t in k12]))
    print("K13 update vs K12 step upd %d: Hessian bitwise equal %s" % (
        upd, bool((dp[1] == k12[1]).all())))
  # control: TF32 products in the plain version must fail the limits
  names = k13_names(False)
  kw = dict(kernel_stride=stride, padding=padding, power_iters=2)
  want64 = K12.conv_solve_stats_plain(d.double(), v.double(), x.double(),
                                      CONV_LAM, SEG_ITERS, **kw)
  tf32 = K12.conv_solve_stats_plain(d, v, x, CONV_LAM, SEG_ITERS,
                                    precision="tensorfloat32", **kw)
  limits = k13_limits(names, want64)
  ratios = []
  for what, t, w in zip(names, tf32, want64):
    err = float((t.double() - w).abs().max())
    lim = limits.get(what, limit(w))
    ratios.append(err / lim)
    print("control: K13 plain with TF32 products, %-10s max|d| fp64 %.3e, "
          "limit %.3e" % (what, err, lim))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  # the tiers run (phase 48 holds them to the rules)
  check_tier_runs(torch, "K13 mxu='bf16x3'", lambda xx, mxu: (
      K12.conv_solve_stats(d, v, xx, CONV_LAM, 5, mxu=mxu, **kw)),
                  lambda xx, mxu: K12.conv_solve_stats_plain(
                      d, v, xx, CONV_LAM, 5, mxu=mxu, **kw), x[:2].contiguous(),
                  K12, "stats_tier_launches", "bf16x3")
  # the refusals: no launch
  for label, call, kind, item in (
      ("K13 early_stopping_epsilon (none in vtc_tpu's K13 either)",
       lambda: K12.conv_solve_stats(
           d, v, x[:2], CONV_LAM, 5, early_stopping_epsilon=1e-3, **kw),
       NotImplementedError, "conv stop is K17's"),
      ("K13 gram form at padding 2, stride 4", lambda: K12.conv_solve_stats(
          d3, torch.ones(6, device=dev), x3, 0.05, 5, kernel_stride=(4, 4),
          padding=pad3, gram_stats=True), ValueError, "gram_stats")):
    before = K12.stats_launches
    try:
      call()
    except kind as err:
      check(item in str(err), "%s: the refusal names no %s: %s" % (
          label, item, err))
    else:
      raise RuntimeError("chip_smoke: %s was not refused" % label)
    check(K12.stats_launches == before, label + " launched K13")
    print("refused on the card: %s (%s)" % (label, item))
  check(not K12.conv_solve_stats_supported(
      x3.shape, d3.shape, (4, 4), "fista", "sc_cheap_quadratic_descent",
      upd_num_iters=3, padding=pad3), "the gate admits the gram form at "
        "padding 2, stride 4")
  return worst


K17_NAMES = ("kernels", "hessian", "eigvec", "codes")


def conv_dp_kernel_cases(torch, K17, K12, parallel, compiled_epoch, conv_ops,
                         lipschitz, x_flag, flag_d, padding, dev):
  """Phase 30, second half: K17, a whole data-parallel segment at a world
  of 1, against its fp32 and fp64 plain versions, against K13's
  composition, a TF32 control and the refusals.  Returns the largest fp32
  difference."""
  stride = (CONV_STRIDE, CONV_STRIDE)
  mesh1 = parallel.make_mesh()
  x2 = torch.tensor(x_flag[:2 * SEG_BATCH], device=dev).reshape(
      (2, SEG_BATCH) + x_flag.shape[1:])
  d = torch.tensor(flag_d, device=dev)
  gen12 = windowed_kernels(np.random.RandomState(0), CONV_S, 1, 12)
  x12, pad12 = conv_images(torch, conv_ops, dev, SEG_BATCH, gen12,
                           CONV_STRIDE, CONV_IMG, seed=3)
  cq, sd = "sc_cheap_quadratic_descent", "sc_steepest_descent"
  # (name, batches, kernels, stride, padding, lambda, iters, flags)
  cases = [
      ("flagship 2 x b40 fista25 cheap-quad", x2, d, stride, padding,
       CONV_LAM, SEG_ITERS, {}),
      ("flagship 2 x b40 upd 3 (gram form)", x2, d, stride, padding,
       CONV_LAM, SEG_ITERS, {"upd_num_iters": 3}),
      ("2 x b5 ista25 cheap-quad", x2[:, :CONV_TRAIN_BATCH].contiguous(), d,
       stride, padding, CONV_LAM, CONV_TRAIN_ITERS, {"variant": "ista"}),
      ("12x12/8 zero-extended 268 b40 steepest",
       torch.tensor(x12, device=dev)[None], torch.tensor(gen12, device=dev),
       stride, pad12, CONV_LAM, SEG_ITERS, {"update_alg": sd}),
  ]
  worst, outputs = 0.0, {}
  for name, xb, dk, strd, pad, lam, iters, flags in cases:
    s = dk.shape[0]
    h = torch.full((s,), 0.01, device=dev)
    v = lipschitz.top_gram_eigenpair(dk.reshape(s, -1))[1].contiguous()
    kw = dict(flags, mesh=mesh1, kernel_stride=strd, padding=pad,
              power_iters=2)
    args = (lam, iters, SEG_STEP)
    before = K17.launches
    got = K17.fused_conv_dp_train_segment(dk, h, v, xb, *args, **kw)
    check(K17.launches == before + xb.shape[0], name + ": K17 did not count")
    want32 = K17.fused_conv_dp_train_plain(dk, h, v, xb, *args, **kw)
    want64 = K17.fused_conv_dp_train_plain(dk.double(), h.double(),
                                           v.double(), xb.double(), *args,
                                           **kw)
    torch.cuda.synchronize()
    outputs[name] = (got, want64)
    worst = max(worst, compare_outputs(torch, "K17 " + name, K17_NAMES, got,
                                       want32, want64))
  # K17's segment is K13's composition on the same steps
  h = torch.full((CONV_S,), 0.01, device=dev)
  v = lipschitz.top_gram_eigenpair(d.reshape(CONV_S, -1))[1].contiguous()
  for name, upd in (("flagship 2 x b40 fista25 cheap-quad", 1),
                    ("flagship 2 x b40 upd 3 (gram form)", 3)):
    runner = compiled_epoch._dp_fused_segment_runner(
        parallel.build_dp_conv_fused_local_step(
            mesh1, "fista", cq, kernel_stride=stride, padding=padding,
            upd_num_iters=upd, power_iters=2))
    comp = runner(d, h, v, x2, CONV_LAM, SEG_ITERS, SEG_STEP)
    got, want64 = outputs[name]
    torch.cuda.synchronize()
    worst = max(worst, compare_outputs(
        torch, "K17 == K13's composition, upd %d" % upd, K17_NAMES[:3],
        got[:3], comp, want64[:3]))
  # control: TF32 products in the plain version must fail the limits
  kw = dict(mesh=mesh1, kernel_stride=stride, padding=padding, power_iters=2)
  tf32 = K17.fused_conv_dp_train_plain(d, h, v, x2, CONV_LAM, SEG_ITERS,
                                       SEG_STEP, precision="tensorfloat32",
                                       **kw)
  want64 = outputs["flagship 2 x b40 fista25 cheap-quad"][1]
  ratios = []
  for what, t, w in zip(K17_NAMES, tf32, want64):
    err = float((t.double() - w).abs().max())
    ratios.append(err / limit(w))
    print("control: K17 plain with TF32 products, %-10s max|d| fp64 %.3e, "
          "limit %.3e" % (what, err, limit(w)))
  check(max(ratios) > 1.0, "the limit does not tell TF32 products from fp32")
  # the refusals: no launch
  rng = np.random.RandomState(6)
  x3 = torch.tensor(np.pad(rng.randn(1, 3, 3, 16, 16),
                           ((0, 0), (0, 0), (0, 0), (2, 2), (2, 2))).astype(
                               np.float32), device=dev)
  d3 = torch.tensor(unit_kernels(rng, 6, 3, 4), device=dev)
  six = torch.ones(6, device=dev)
  check_runs("K17 early_stopping_epsilon", lambda: (
      K17.fused_conv_dp_train_segment(d, h, v, x2[:, :2], CONV_LAM, 5,
                                      SEG_STEP, early_stopping_epsilon=1e-3,
                                      **kw)), K17)
  # the tiers run (phase 48 holds them to the rules)
  check_tier_runs(torch, "K17 mxu='bf16x3'", lambda xx, mxu: (
      K17.fused_conv_dp_train_segment(d, h, v, xx, CONV_LAM, 5, SEG_STEP,
                                      mxu=mxu, **kw)),
                  lambda xx, mxu: K17.fused_conv_dp_train_plain(
                      d, h, v, xx, CONV_LAM, 5, SEG_STEP, mxu=mxu, **kw),
                  x2[:, :2].contiguous(), K17, "tier_launches", "bf16x3",
                  steps=2)
  # the refusal: no launch
  label, item = "K17 gram form at padding 2, stride 4", (
      "conv_solve_stats_supported")
  before = K17.launches
  try:
    K17.fused_conv_dp_train_segment(
        d3, six, six, x3, 0.05, 5, 0.05, mesh=mesh1, kernel_stride=(4, 4),
        padding=((2, 2), (2, 2)), upd_num_iters=3)
  except ValueError as err:
    check(item in str(err), "%s: the refusal names no %s: %s" % (
        label, item, err))
  else:
    raise RuntimeError("chip_smoke: %s was not refused" % label)
  check(K17.launches == before, label + " launched K17")
  print("refused on the card: %s (%s)" % (label, item))
  return worst


# ---------------------------------------------------------------------------
# the whole-segment data-parallel kernels K15 (fc), K16 (subspace), K18 (ICA)
# ---------------------------------------------------------------------------
DP_SEG_STEPS = 10         # steps of each phase-33 segment
SEG_NAMES = ("dictionary", "hessian", "eigvec", "last codes")


def dp_segment_kernel_cases(torch, parallel, K15, K16, K8, sub, lipschitz,
                            invertible_linear, train_patches, gtrain, dev):
  """Phase 33: K15, K16 and K18, each a whole data-parallel segment of
  DP_SEG_STEPS steps at a world of 1, against their fp32 and fp64 plain
  versions, TF32 controls, and the refusals.  Returns the largest fp32
  difference of each kernel."""
  mesh1 = parallel.make_mesh()
  k = DP_SEG_STEPS
  rng = np.random.RandomState(33)
  flag_d = torch.tensor(unit_rows(np.random.RandomState(2), 256, 256),
                        device=dev)
  x = torch.tensor(train_patches[:k * TRAIN_BATCH], device=dev).reshape(
      k, TRAIN_BATCH, 256)
  gx = torch.tensor(gtrain[:k * TRAIN_BATCH], device=dev).reshape(
      k, TRAIN_BATCH, 256)
  rag_d = torch.tensor(unit_rows(rng, 37, 24), device=dev)  # s > n
  rag_x = torch.tensor(rng.randn(k, 13, 24).astype(np.float32), device=dev)
  sd, cq = "sc_steepest_descent", "sc_cheap_quadratic_descent"

  def run(label, kernel, plain, counter, names, args, kw, limits=None):
    before = counter()
    got = kernel(*args, **kw)
    check(counter() == before + k, label + ": did not count one launch per "
          "step")
    want32 = plain(*args, **kw)
    want64 = plain(*[a.double() if isinstance(a, torch.Tensor) else a
                     for a in args], **kw)
    torch.cuda.synchronize()
    return compare_outputs(torch, label, names, got, want32, want64,
                           limits), want64

  # K15: the flagship (b 250, s = n = 256, FISTA 25), a shard of 125,
  # steepest descent at three update iterations, and a ragged s > n shape
  # (the n x n power Gram); cheap-quadratic segments of ten steps are well
  # posed at these widths, and at the ragged one with a small stepsize
  # (rounding is amplified by threshold flips otherwise, phase 5)
  k15_err = 0.0
  for label, xb, d, lam, iters, step, flags in (
      ("flagship 10 x b250 fista25 cheap-quad", x, flag_d, LAM, TRAIN_ITERS,
       TRAIN_STEP, {}),
      ("flagship shard 10 x b125 cheap-quad", x[:, :TRAIN_BATCH // 2],
       flag_d, LAM, TRAIN_ITERS, TRAIN_STEP, {}),
      ("flagship 10 x b250 steepest upd 3", x, flag_d, LAM, TRAIN_ITERS,
       TRAIN_STEP, {"update_alg": sd, "upd_num_iters": 3}),
      ("ragged 10 x 13x37x24 (s > n) cheap-quad upd 3", rag_x, rag_d, 0.08,
       20, 0.003, {"upd_num_iters": 3}),
      ("13x37x24 ista hard nonneg steepest", rag_x, rag_d, 0.08, 20, 0.05,
       {"update_alg": sd, "variant": "ista", "hard": True, "nonneg": True})):
    s = d.shape[0]
    h = torch.zeros(s, device=dev)
    v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
    err, want64 = run(
        "K15 " + label, K15.fused_dp_train_segment, K15.fused_dp_train_plain,
        lambda: K15.launches, SEG_NAMES,
        (d, h, v, xb.contiguous(), lam, iters, step),
        dict(flags, mesh=mesh1, power_iters=2))
    k15_err = max(k15_err, err)
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(flag_d)[1].contiguous()
  kw = dict(mesh=mesh1, power_iters=2)
  want64 = K15.fused_dp_train_plain(flag_d.double(), h.double(), v.double(),
                                    x.double(), LAM, TRAIN_ITERS, TRAIN_STEP,
                                    **kw)
  tf32_control(torch, "K15 plain", SEG_NAMES, K15.fused_dp_train_plain(
      flag_d, h, v, x, LAM, TRAIN_ITERS, TRAIN_STEP,
      precision="tensorfloat32", **kw), want64)
  check_tier_runs(torch, "K15 mxu='bf16x3'", lambda xx, mxu: (
      K15.fused_dp_train_segment(flag_d, h, v, xx, LAM, 5, TRAIN_STEP,
                                 mxu=mxu, **kw)),
                  lambda xx, mxu: K15.fused_dp_train_plain(
                      flag_d, h, v, xx, LAM, 5, TRAIN_STEP, mxu=mxu, **kw),
                  x[:2].contiguous(), K15, "tier_launches", "bf16x3", 2)
  check_runs("K15 early_stopping_epsilon", lambda: K15.fused_dp_train_segment(
      flag_d, h, v, x[:2], LAM, 5, TRAIN_STEP, early_stopping_epsilon=1e-3,
      **kw), K15)

  # K16: 64 contiguous groups of 4 (the identity selection) at b 250 and a
  # shard of 125; the anti-alignment regularizer (penalty 0.4) on ragged
  # overlapping groups (the row gather and the fixed-order unpack), with
  # steepest descent: with the cheap-quadratic rule, sign(D D^T) of
  # near-orthogonal atoms flips between fp32 and fp64 over ten steps
  flag_g = contiguous_groups(256, GROUP_SIZE)
  pen_g = [[0, 1, 2, 3], [4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 0], [0, 1]]
  pen_d = torch.tensor(unit_rows(rng, 14, 16), device=dev)
  pen_x = torch.tensor(rng.randn(k, 10, 16).astype(np.float32), device=dev)
  k16_err = 0.0
  for label, xb, d, groups, lam, iters, step, flags in (
      ("flagship 64x4 10 x b250 cheap-quad", gx, flag_d, flag_g, LAM,
       TRAIN_ITERS, SUB_STEP, {}),
      ("flagship 64x4 shard 10 x b125 cheap-quad", gx[:, :TRAIN_BATCH // 2],
       flag_d, flag_g, LAM, TRAIN_ITERS, SUB_STEP, {}),
      ("ragged overlapping s14 n16 penalty 0.4 steepest", pen_x, pen_d,
       pen_g, 0.05, 10, 0.1, {
           "alignment_penalty": 0.4,
           "update_alg": "subspace_sc_steepest_descent"})):
    s = d.shape[0]
    h = torch.zeros(s, device=dev)
    gather, mask, _ = sub.group_layout(groups, s, dev)
    v = lipschitz.top_gram_eigenpair(
        sub.build_grouped_dictionary(d, gather, mask))[1].contiguous()
    err, _ = run(
        "K16 " + label, K16.fused_group_dp_train_segment,
        K16.fused_group_dp_train_plain, lambda: K16.launches, SEG_NAMES,
        (d, h, v, xb.contiguous(), lam, iters, step),
        dict(flags, group_assignments=groups, mesh=mesh1, power_iters=2))
    k16_err = max(k16_err, err)
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(flag_d)[1].contiguous()  # 64 x 4: Dg = D
  gkw = dict(group_assignments=flag_g, mesh=mesh1, power_iters=2)
  want64 = K16.fused_group_dp_train_plain(
      flag_d.double(), h.double(), v.double(), gx.double(), LAM, TRAIN_ITERS,
      SUB_STEP, **gkw)
  tf32_control(torch, "K16 plain", SEG_NAMES, K16.fused_group_dp_train_plain(
      flag_d, h, v, gx, LAM, TRAIN_ITERS, SUB_STEP,
      precision="tensorfloat32", **gkw), want64)
  check_tier_runs(torch, "K16 mxu='bf16'", lambda xx, mxu: (
      K16.fused_group_dp_train_segment(flag_d, h, v, xx, LAM, 5, SUB_STEP,
                                       mxu=mxu, **gkw)),
                  lambda xx, mxu: K16.fused_group_dp_train_plain(
                      flag_d, h, v, xx, LAM, 5, SUB_STEP, mxu=mxu, **gkw),
                  gx[:2].contiguous(), K16, "tier_launches", "bf16", 2)
  check_runs("K16 early_stopping_epsilon", lambda: (
      K16.fused_group_dp_train_segment(flag_d, h, v, gx[:2], LAM, 5,
                                       SUB_STEP, early_stopping_epsilon=1e-3,
                                       **gkw)), K16)

  # K18: gapped sources from their orthogonal mixing matrix (phase 20: the
  # codes stay clear of sign()'s discontinuity), n 256 at b 250 from an
  # exact seed, a shard of 125 at three update iterations, and a stale
  # 1.35 X seed that fires the boost; the residual at 1e-5
  mixing = torch.tensor(random_orthogonal(ICA_N, 11), device=dev)
  g = torch.Generator(device=dev).manual_seed(330)
  xi_ = gapped_mixtures(torch, dev, k * ICA_BATCH, mixing, g).reshape(
      k, ICA_BATCH, ICA_N)
  x0 = invertible_linear.exact_inverse(mixing)
  inames = ("dictionary", "inverse", "residual")
  k18_err = 0.0
  for label, xb, xi, upd in (
      ("10 x b250 exact seed", xi_, x0, 1),
      ("shard 10 x b125 upd 3", xi_[:, :ICA_BATCH // 2], x0, 3),
      ("10 x b250 stale 1.35 X, boost fires", xi_, 1.35 * x0, 1)):
    err, _ = run(
        "K18 " + label, K8.fused_ica_dp_train_segment,
        K8.fused_ica_dp_train_plain, lambda: K8.dp_launches, inames,
        (mixing, xi.contiguous(), xb.contiguous(), ICA_STEP),
        dict(mesh=mesh1, refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL,
             upd_num_iters=upd), {"residual": ICA_LIMIT})
    k18_err = max(k18_err, err)
    check(K8.last_route == "persistent", "K18 took the %s route"
          % K8.last_route)
  ikw = dict(mesh=mesh1, refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL)
  want64 = K8.fused_ica_dp_train_plain(mixing.double(), x0.double(),
                                       xi_.double(), ICA_STEP, **ikw)
  tf32_control(torch, "K18 plain", inames[:2], K8.fused_ica_dp_train_plain(
      mixing, x0, xi_, ICA_STEP, precision="tensorfloat32", **ikw)[:2],
               want64[:2])
  before = K8.dp_launches
  check_refuses("K18 mxu='bf16x3'", lambda: K8.fused_ica_dp_train_segment(
      mixing, x0, xi_[:2], ICA_STEP, mxu="bf16x3", **ikw), "3a")
  check(K8.dp_launches == before, "K18 mxu='bf16x3' launched K18")
  return k15_err, k16_err, k18_err


def k17_calls(K17):
  """Record the (steps, upd_num_iters) of each K17 segment call, and a
  function that puts the wrapper back."""
  calls = []
  original = K17.fused_conv_dp_train_segment

  def counted(*args, **kwargs):
    calls.append((int(args[3].shape[0]), int(kwargs["upd_num_iters"])))
    return original(*args, **kwargs)

  K17.fused_conv_dp_train_segment = counted
  return calls, lambda: setattr(K17, "fused_conv_dp_train_segment", original)


# ---------------------------------------------------------------------------
# K19 across devices: dictionary rows over a 'code' axis (phases 36-38)
# ---------------------------------------------------------------------------
CS_MESHES = {2: dict(data=1, code=2), 4: dict(data=2, code=2)}
# phase 37's trainer runs: (label, world, grouped, steps)
CS_TRAIN = (("fc", 2, False, 50), ("grouped 512x4", 2, True, 50),
            ("fc", 4, False, 20))
CS_TIME_STEPS = 20        # phase 38's timed segment
CS_CHILD_TIMEOUT = 600    # seconds a rank of phases 36-38 may take
CS_NAMES = ("dictionary", "hessian", "eigvec", "codes", "stepsize")
# what each rank counts in phase 37's runs, in cs_rank_main's order
CS_COUNTS = ("K19", "K2", "K6", "K15", "K16")


def ragged_in_shards(s, shards, seed):
  """A seeded disjoint partition of range(s) into shuffled groups of 1 to
  6 rows, none across a boundary of ``shards`` equal row shards: a layout
  K19 across devices takes with the member-table prox."""
  rng, groups, per = np.random.RandomState(seed), [], s // shards
  for lo in range(0, s, per):
    perm, at = lo + rng.permutation(per), 0
    while at < per:
      size = int(rng.randint(1, 7))
      groups.append(sorted(int(i) for i in perm[at:at + size]))
      at += size
  return groups


def cs_variants():
  """Phase 36's one-step cases: (name, dictionary, batch, groups, flags),
  the dictionary and batch naming arrays of cs_rank_main's inputs."""
  sub_cq = "subspace_sc_cheap_quadratic_descent"
  return (
      ("bench fc fista cheap-quad", "d", "x_fc", None, {}),
      ("bench 512x4 groups cheap-quad", "d", "x_g",
       contiguous_groups(BIG_S, 4), {"update_alg": sub_cq}),
      ("s512 4s penalty 0.4 cheap-quad", "d_small", "x_small",
       contiguous_groups(BIG_SMALL_S, 4),
       {"update_alg": sub_cq, "alignment_penalty": 0.4}),
      ("s512 ragged 1-6 cheap-quad upd 2", "d_small", "x_small",
       ragged_in_shards(BIG_SMALL_S, 2, 36),
       {"update_alg": sub_cq, "upd_num_iters": 2}))


def bigdict_params(steps, grouped):
  """The scanned trainer at bench.py's measure_bigdict rows (fc, or 512
  contiguous groups of 4)."""
  params = dict(train_params(steps), inference_param_schedule={
      0: {"sparsity_weight": LAM, "num_iters": TRAIN_ITERS}},
                dict_update_param_schedule={
                    0: {"stepsize": BIG_STEP, "num_iters": 1}})
  if grouped:
    params.update(code_inference_algorithm="subspace_fista",
                  dictionary_update_algorithm=(
                      "subspace_sc_cheap_quadratic_descent"),
                  group_assignments=contiguous_groups(BIG_S, 4))
  return params


def cs_gathered(mesh, out):
  """(dictionary, hessian, eigvec, codes, stepsize) of one rank's K19
  output, the shards gathered into the global arrays, as numpy."""
  d, h, v, codes, eta = out
  codes = mesh.all_gather(mesh.all_gather_code(codes, dim=1))
  return [t.detach().cpu().numpy() for t in (
      mesh.all_gather_code(d), mesh.all_gather_code(h), v, codes, eta)]


def cs_rank_main(rank, world, workdir):
  """The hidden sub-command: one rank of phases 36-38 at a world of 2
  (code 2) or 4 (data 2 x code 2).  Joins the gloo group over the file
  store in ``workdir``, runs K19 across devices against its plain
  versions (36), the scanned trainer (37) and the timing (38) on the
  shared card, and saves its results to ``workdir``."""
  import os
  import torch
  import torch.distributed as dist
  from vtc_tpu_torch import convert, parallel
  from vtc_tpu_torch.ops import fused_code_shard_train as K19
  from vtc_tpu_torch.ops import fused_dp_train as K15
  from vtc_tpu_torch.ops import fused_group_dp_train as K16
  from vtc_tpu_torch.ops import fused_group_train_step as K6
  from vtc_tpu_torch.ops import fused_train_step as K2
  from vtc_tpu_torch.training import compiled_epoch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  dev = torch.device("cuda", 0)
  data = dict(np.load(os.path.join(workdir, "inputs.npz")))
  dist.init_process_group("gloo", init_method="file://" + os.path.join(
      workdir, "store"), rank=rank, world_size=world)
  try:
    mesh = parallel.make_mesh(**CS_MESHES[world])
    code, size = mesh.code_size, mesh.size
    axes = dict(axis_size=code, data_axis_size=size,
                data_stride=code if size > 1 else 0)
    out = {}
    # phase 36: one step of each variant against its fp32 and fp64 plain
    # versions, every rank on its shards
    for name, dkey, xkey, groups, flags in cs_variants():
      d, x, v = data[dkey], data[xkey], data["v_" + dkey]
      state = convert.code_shard_state_from_numpy(
          d, np.zeros(d.shape[0], np.float32), v, mesh, dev,
          group_assignments=groups)
      if flags.get("alignment_penalty", 0.0) == 0.0:
        state.pop("comem_local", None)
      args = (state.pop("dict_shard"), state.pop("hessian_shard"),
              state.pop("eigvec"),
              torch.tensor(mesh.shard(x, dim=1), device=dev))
      kw = dict(flags, power_iters=2, return_stepsize=True, **state)
      scalars = (LAM, TRAIN_ITERS, BIG_STEP)
      before = K19.launches
      got = K19.fused_code_sharded_train_segment(*args, *scalars, mesh=mesh,
                                                 **axes, **kw)
      torch.cuda.synchronize()
      check(K19.launches == before + 1, name + ": K19 did not count its "
            "step")
      check(K19.last_route == "steps", name + ": K19 across devices took "
            "the %s route" % K19.last_route)
      want32 = K19.fused_code_sharded_train_segment_plain(
          *args, *scalars, mesh=mesh, **kw)
      kw64 = {k: (t.double() if isinstance(t, torch.Tensor) else t)
              for k, t in kw.items()}
      want64 = K19.fused_code_sharded_train_segment_plain(
          *(t.double() for t in args), *scalars, mesh=mesh, **kw64)
      for tag, result in (("kernel", got), ("fp32", want32),
                          ("fp64", want64)):
        for what, a in zip(CS_NAMES, cs_gathered(mesh, result)):
          out["36|%s|%s|%s" % (name, tag, what)] = a
    # the refusals on a CUDA tensor, at a code axis of 2
    d = convert.code_shard_state_from_numpy(
        data["d"], np.zeros(BIG_S, np.float32), data["v_d"], mesh, dev)
    step = (d["dict_shard"], d["hessian_shard"], d["eigvec"],
            torch.tensor(mesh.shard(data["x_fc"], dim=1), device=dev), LAM,
            TRAIN_ITERS, BIG_STEP)
    check_runs("K19 across devices early_stopping_epsilon", lambda: (
        K19.fused_code_sharded_train_segment(
            *step, mesh=mesh, early_stopping_epsilon=1e-3, **axes)), K19)
    check_refuses("K19 across devices mxu='bf16x3'", lambda: (
        K19.fused_code_sharded_train_segment(*step, mesh=mesh,
                                             mxu="bf16x3", **axes)), "3a",
                  K19)
    # phase 37: the scanned trainer on the mesh, counts set to 0 just
    # before each run and read just after
    for label, w, grouped, steps in CS_TRAIN:
      if w != world:
        continue
      x = data["train_g" if grouped else "train_fc"][:steps]
      K19.launches = K2.launches = K6.launches = 0
      K15.launches = K16.launches = 0
      trained = compiled_epoch.train_dictionary_scanned(
          x, x[:1], data["d"], dict(bigdict_params(steps, grouped),
                                    data_parallel=mesh), device=dev)
      torch.cuda.synchronize()
      out["37|%s|launches" % label] = np.array([
          K19.launches, K2.launches, K6.launches, K15.launches,
          K16.launches])
      out["37|%s|dictionary" % label] = trained.cpu().numpy()
    # phase 38: K19 across devices per step on this rank, the host's time
    # in the hook's sums, and the plain version's
    x = torch.tensor(mesh.shard(data["train_fc"][:CS_TIME_STEPS], dim=1),
                     device=dev)
    seg = (d["dict_shard"], d["hessian_shard"], d["eigvec"], x, LAM,
           TRAIN_ITERS, BIG_STEP)
    K19.fused_code_sharded_train_segment(*seg[:3], x[:2], *seg[4:],
                                         mesh=mesh, power_iters=2, **axes)
    sums = {"calls": 0, "s": 0.0}

    def timed(fn):
      def call(flat):
        t0 = time.perf_counter()
        out = fn(flat)
        sums["s"] += time.perf_counter() - t0
        sums["calls"] += 1
        return out
      return call

    runs = []
    for _ in range(2):
      mesh.sum_code_, mesh.sum_ = timed(mesh.sum_code_), timed(mesh.sum_)
      sums.update(calls=0, s=0.0)
      torch.cuda.synchronize()
      dist.barrier()
      t0 = time.perf_counter()
      K19.fused_code_sharded_train_segment(*seg, mesh=mesh, power_iters=2,
                                           **axes)
      torch.cuda.synchronize()
      runs.append((1e3 * (time.perf_counter() - t0) / CS_TIME_STEPS,
                   sums["calls"] / CS_TIME_STEPS,
                   1e3 * sums["s"] / CS_TIME_STEPS))
      del mesh.sum_code_, mesh.sum_  # the class's methods again
    dist.barrier()
    t0 = time.perf_counter()
    K19.fused_code_sharded_train_segment_plain(*seg[:3], x[:5], *seg[4:],
                                               mesh=mesh, power_iters=2)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / 5
    # one hook sum taken apart: gloo's all-reduce of the (b_l, n)
    # reconstruction in host memory alone, then staged from the card
    # (pinned copy, stream sync, copy back), 50 sums each
    probe = []
    for where in ("cpu", dev):
      buf = torch.zeros(x.shape[1] * 256, device=where)
      mesh.sum_code_(buf)
      dist.barrier()
      t0 = time.perf_counter()
      for _ in range(50):
        mesh.sum_code_(buf)
      torch.cuda.synchronize()
      probe.append(1e3 * (time.perf_counter() - t0) / 50)
    out["38|timing"] = np.array([runs[0][0], runs[1][0], runs[0][1],
                                 runs[0][2], runs[1][2], plain_ms] + probe)
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **out)
  finally:
    dist.destroy_process_group()
  return 0


def spawn_ranks(flag, world, workdir, timeout):
  """Start ``world`` processes of this script with the hidden sub-command
  ``flag``, wait for them, and stop any that outlives ``timeout``;
  returns (exit codes, seconds)."""
  import os
  t0 = time.perf_counter()
  procs = [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), flag, str(rank),
       str(world), workdir]) for rank in range(world)]
  try:
    codes = [proc.wait(timeout=timeout) for proc in procs]
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  return codes, time.perf_counter() - t0


def code_shard_across_devices(torch, K19, lipschitz, compiled_epoch, gen,
                              dev, card, k19_ms):
  """Phases 36-38: K19 across devices at a world of 2 (code 2) and of 4
  (data 2 x code 2), the ranks being processes of this script sharing the
  card over gloo.  Returns (launches per rank on phase 37's main path,
  the largest kernel-vs-fp32 difference, ms per step at code 2, the
  plain version's, the per-rank bound at code 2)."""
  import os
  import tempfile
  d = unit_rows(np.random.RandomState(2), BIG_S, 256)
  small = gen[:BIG_SMALL_S].contiguous()
  data = {"d": d, "d_small": d[:BIG_SMALL_S].copy()}
  for key, seed, g, group in (("x_fc", 360, gen, 1), ("x_g", 361, gen, 4),
                              ("x_small", 362, small, 4)):
    data[key] = bigdict_mixtures(torch, dev, BIG_B, g, group,
                                 seed=seed)[None].cpu().numpy()
  for key, grouped in (("train_fc", False), ("train_g", True)):
    data[key] = bigdict_mixtures(
        torch, dev, 50 * BIG_B, gen, 4 if grouped else 1,
        seed=370 + grouped).reshape(50, BIG_B, 256).cpu().numpy()
  for key in ("d", "d_small"):
    data["v_" + key] = lipschitz.top_gram_eigenpair(
        torch.tensor(data[key], device=dev))[1].cpu().numpy()
  results = {}
  with tempfile.TemporaryDirectory() as workdir:
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    for world in (2, 4):
      sub = os.path.join(workdir, "world%d" % world)
      os.mkdir(sub)
      os.link(os.path.join(workdir, "inputs.npz"),
              os.path.join(sub, "inputs.npz"))
      codes, dt = spawn_ranks("--cs-rank", world, sub, CS_CHILD_TIMEOUT)
      check(codes == [0] * world, "a rank of the world of %d failed: exit "
            "codes %s" % (world, codes))
      results[world] = [dict(np.load(os.path.join(sub, "rank%d.npz" % r)))
                        for r in range(world)]
      print("K19 across devices: %d processes sharing one card over gloo "
            "(%s) done in %.1f s" % (world, CS_MESHES[world], dt))

  # phase 36: the ranks agree bitwise, the kernel holds to its plain
  # versions, and the stacked shards sit beside K19 at a code axis of 1
  worst = 0.0
  for world, ranks in results.items():
    for name, dkey, xkey, groups, flags in cs_variants():
      def outputs(rank, tag):
        return [ranks[rank]["36|%s|%s|%s" % (name, tag, what)]
                for what in CS_NAMES]
      for rank in range(1, world):
        for what, a, b in zip(CS_NAMES, outputs(0, "kernel"),
                              outputs(rank, "kernel")):
          if what != "codes":
            check(np.array_equal(a, b), "world %d %s: the %s differs "
                  "between ranks 0 and %d" % (world, name, what, rank))
      label = "K19 x%d %s" % (world, name)
      worst = max(worst, compare_outputs(
          torch, label, CS_NAMES,
          *[[torch.from_numpy(a) for a in outputs(0, tag)]
            for tag in ("kernel", "fp32", "fp64")]))
      one_kw = dict(flags, power_iters=2, return_stepsize=True)
      if groups is not None:
        one_kw["expand_local"] = K19.code_shard_group_arrays(
            groups, data[dkey].shape[0], 1)[0][0]
        if flags.get("alignment_penalty", 0.0) != 0.0:
          one_kw["comem_local"] = K19.code_shard_group_arrays(
              groups, data[dkey].shape[0], 1)[1][0]
      one = K19.fused_code_sharded_train_segment(
          torch.tensor(data[dkey], device=dev),
          torch.zeros(data[dkey].shape[0], device=dev),
          torch.tensor(data["v_" + dkey], device=dev),
          torch.tensor(data[xkey], device=dev), LAM, TRAIN_ITERS, BIG_STEP,
          **one_kw)
      print("%-48s ranks bitwise equal; stacked shards vs K19 at code axis "
            "1: %s" % (label, ", ".join(
                "%s %.3e" % (what, float(np.abs(a - b.cpu().numpy()).max()))
                for what, a, b in zip(CS_NAMES, outputs(0, "kernel"),
                                      one))))

  # phase 37: the trainer through K19 only, the ranks bitwise equal, and
  # the single-process runner at code 1 on the global batch
  launches = 0
  for label, world, grouped, steps in CS_TRAIN:
    ranks = results[world]
    counts = dict(zip(CS_COUNTS, (int(c) for c in ranks[0][
        "37|%s|launches" % label])))
    for rank, out in enumerate(ranks):
      check(list(out["37|%s|launches" % label]) == [steps, 0, 0, 0, 0],
            "world %d %s: rank %d launched %s, expected %d K19 steps and "
            "no K2, K6, K15 or K16" % (world, label, rank, dict(zip(
                CS_COUNTS, out["37|%s|launches" % label])), steps))
      check(np.array_equal(out["37|%s|dictionary" % label],
                           ranks[0]["37|%s|dictionary" % label]),
            "world %d %s: rank %d's dictionary differs from rank 0's" % (
                world, label, rank))
    launches += counts["K19"]
    d0 = torch.tensor(data["d"], device=dev)
    runner = compiled_epoch._code_shard_segment_runner(
        None, 1, 1, "fista",
        ("subspace_sc_cheap_quadratic_descent" if grouped
         else "sc_cheap_quadratic_descent"), 1, False, False, True,
        group_arrays=(K19.code_shard_group_arrays(
            contiguous_groups(BIG_S, 4), BIG_S, 1) if grouped else None))
    single = runner(d0, torch.zeros(BIG_S, device=dev),
                    lipschitz.top_gram_eigenpair(d0)[1].contiguous(),
                    torch.tensor(data["train_g" if grouped else
                                      "train_fc"][:steps], device=dev),
                    LAM, TRAIN_ITERS, BIG_STEP)[0].cpu().numpy()
    got = ranks[0]["37|%s|dictionary" % label]
    err = float(np.abs(got - single).max())
    unit = float(np.abs(np.linalg.norm(got, axis=1) - 1).max())
    print("K19 x%d train_dictionary_scanned(data_parallel=make_mesh(%s)) %s, "
          "%d steps: each rank %s; ranks bitwise equal; rows unit within "
          "%.2e; vs the single-process runner at code 1 on the global batch "
          "max|d| %.3e (rounding floor %.1e)" % (
              world, ", ".join("%s=%d" % kv for kv in
                               CS_MESHES[world].items()), label, steps,
              ", ".join("%d %s" % (counts[c], c) for c in CS_COUNTS), unit,
              err, DP_FLOOR))
    check(np.isfinite(got).all() and unit <= 1e-4 and err <= DP_FLOOR,
          "world %d %s: %.3e from the single-process runner" % (world, label,
                                                                err))

  # phase 38: timing per rank
  timing = {}
  for world, ranks in results.items():
    t = np.array([out["38|timing"] for out in ranks])
    ms = float(t[:, :2].mean())
    b_l, s_l = BIG_B // CS_MESHES[world]["data"], BIG_S // CS_MESHES[world][
        "code"]
    bnd = code_shard_step_bound(b_l, s_l, 256, TRAIN_ITERS)
    timing[world] = (ms, float(t[:, 5].mean()), bnd)
    print("K19 across devices, %d processes sharing one card over gloo "
          "(%s; b_l %d, s_l %d, n 256, fista 25, cheap-quad, a %d-step "
          "segment): %.4f ms per step per rank (ranks x runs %s); %d hook "
          "sums per step, host %.4f ms per step in them; plain version %.4f "
          "ms per step; per-rank bound %.4f ms (%s); K19 at code axis 1 "
          "(phase 25) %.4f ms; one sum over 'code' of the (b_l, n) "
          "reconstruction: gloo's all-reduce of host memory %.4f ms, staged "
          "from the card %.4f ms.  NCCL across GPUs cannot run on one card: "
          "these times are host-bound, not a multi-GPU number [%s]" % (
              world, CS_MESHES[world], b_l, s_l, CS_TIME_STEPS, ms,
              np.round(t[:, :2], 4).tolist(), int(t[0, 2]),
              float(t[:, 3:5].mean()), timing[world][1], bnd[0], bnd[1],
              k19_ms, float(t[:, 6].mean()), float(t[:, 7].mean()), card))
  return (launches, worst) + timing[2]


CLUSTER_ITERS = 25        # phase 39: the trainers' solve depth
DISPATCH_STEPS = 20       # phase 39: steps of each profiled trainer


def solve_inputs(torch, x, d, dev):
  """(gram, corr, eta) of a solve, made on the CPU in float64 from the
  float32 images and dictionary, then float32 on dev: G = D D^T,
  c = X D^T, eta = 1 / the top eigenvalue of G."""
  x64, d64 = x.astype(np.float64), d.astype(np.float64)
  gram = d64 @ d64.T
  eta = 1.0 / np.linalg.eigvalsh(gram)[-1]
  as_dev = lambda a: torch.tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
  return as_dev(gram), as_dev(x64 @ d64.T), as_dev([eta])


def cluster_bitwise_cases(torch, K1, K4, patches, gpatches, dev):
  """Phase 39 (a): fista_cluster_kernel and fista_kernel, both forced, on
  the same CPU-made inputs; the codes must be torch.equal.  Returns the
  number of cases."""
  rng = np.random.RandomState(39)
  flag_d = unit_rows(np.random.RandomState(0), 256, 256)
  dicts = {256: flag_d, 40: unit_rows(rng, 40, 256),
           96: unit_rows(rng, 96, 256), 512: unit_rows(rng, 512, 256)}
  inputs = {}

  def problem(s, b, grouped):
    key = (s, grouped)
    if key not in inputs:
      x = (gpatches if grouped else patches)[:2048]
      inputs[key] = solve_inputs(torch, x, dicts[s], dev)
    gram, corr, eta = inputs[key]
    return gram, corr[:b].contiguous(), eta

  def warm(b, s):
    w = 0.05 * rng.randn(b, s) * (rng.rand(b, s) < 0.1)
    return torch.tensor(w.astype(np.float32), device=dev)

  # (label, s, b, M or None, fista, mode or hard, warm)
  cases = []
  for s in (256, 40):
    for b in (250, 125, 37):
      for fista in (True, False):
        for mode in range(4):
          for w in (False, True):
            cases.append(("fc", s, b, None, fista, mode, w))
      for m in (1, 2, 4):
        for hard in (False, True):
          cases.append(("group", s, b, m, True, hard, False))
      cases.append(("group", s, b, 4, False, False, True))
  # M dividing a CTA's columns but not 4: the shared-memory pass
  for m in (8, 16):
    for hard in (False, True):
      cases.append(("group shared pass", 256, 250, m, True, hard, False))
  for m in (3, 6):
    cases.append(("group shared pass", 96, 125, m, True, False, True))
  # 64 columns a CTA (256 threads); a shape the route sends to
  # fista_wide_kernel (phase 42)
  cases += [("fc s512", 512, 250, None, True, 0, False),
            ("fc s512", 512, 250, None, True, 2, True),
            ("fc b2048 (the wide route's)", 256, 2048, None, True, 0,
             False),
            ("group b2048 (the wide route's)", 256, 2048, 4, True, False,
             False)]
  by_label = {}
  for label, s, b, m, fista, mode, w in cases:
    gram, corr, eta = problem(s, b, m is not None)
    init = warm(b, s) if w else None
    if m is None:
      run = lambda route: K1._launch(gram, corr, init, eta, LAM,
                                     CLUSTER_ITERS, fista, mode, route=route)
    else:
      run = lambda route: K4._launch(gram, corr, init, eta, LAM,
                                     CLUSTER_ITERS, m, fista, bool(mode),
                                     route=route)
    classic, cluster = run("classic"), run("cluster")
    torch.cuda.synchronize()
    same = torch.equal(classic, cluster)
    differ = int((classic != cluster).sum())
    stats = by_label.setdefault(label, [0, 0, 0.0, 0])
    stats[0] += 1
    stats[1] += int(same)
    stats[2] = max(stats[2], float(classic.abs().max()))
    stats[3] += int((classic != 0).sum())
    check(same, "%s s %d b %d M %s %s mode %s warm %s: the cluster kernel's "
          "codes differ from fista_kernel's at %d of %d entries" % (
              label, s, b, m, "fista" if fista else "ista", mode, w, differ,
              classic.numel()))
  for label, (n, same, top, nonzero) in by_label.items():
    print("cluster vs classic, %-28s %3d cases, %3d bitwise equal (max|code| "
          "%.4f, %d nonzero codes)" % (label, n, same, top, nonzero))
  return len(cases)


def solve_plain_cases(torch, K1, K4, lipschitz, patches, gpatches, dev,
                      batches, iters, route_name):
  """Phases 39 (b) and 42 (b): the auto route at each batch (the
  route_name kernel) against the fp32 and fp64 plain versions at phase
  2's limit, fc and 64 x 4 groups, with a TF32 control.  Returns the
  largest fp32 error."""
  d = torch.tensor(unit_rows(np.random.RandomState(0), 256, 256), device=dev)
  eta = lipschitz.fista_stepsize(d)
  worst = 0.0
  for b in batches:
    for grouped in (False, True):
      x = torch.tensor((gpatches if grouped else patches)[:b], device=dev)
      if grouped:
        got = K4.fused_group_fista_solve(x, d, GROUP_SIZE, LAM, iters, eta)
        route = K4.last_route
        plain = lambda xx, dd, ee, **kw: K4.fused_group_fista_plain(
            xx, dd, GROUP_SIZE, LAM, iters, ee, **kw)
      else:
        got = K1.fused_fista_solve(x, d, LAM, iters, eta)
        route = K1.last_route
        plain = lambda xx, dd, ee, **kw: K1.fused_fista_plain(
            xx, dd, LAM, iters, ee, **kw)
      want32 = plain(x, d, eta)
      want64 = plain(x.double(), d.double(), eta.double())
      tf32 = plain(x, d, eta, precision="tensorfloat32")
      torch.cuda.synchronize()
      err32 = float((got - want32).abs().max())
      err64 = float((got.double() - want64).abs().max())
      err_tf32 = float((tf32.double() - want64).abs().max())
      lim = limit(want64)
      name = "b %d %s" % (b, "64x4 groups" if grouped else "fc")
      print("auto route (%s) vs plain, %-16s %d it, max|d| fp32 %.3e fp64 "
            "%.3e, limit %.3e; TF32 control %.3e (must fail it)" % (
                route, name, iters, err32, err64, lim, err_tf32))
      check(route == route_name, name + ": the auto route is " + route)
      check(err32 <= lim and err64 <= lim, "%s: the %s kernel differs "
            "from plain by %.3e / %.3e, limit %.3e" % (name, route, err32,
                                                       err64, lim))
      check(err_tf32 > lim, name + ": the limit does not tell TF32 "
            "products from fp32")
      worst = max(worst, err32)
  return worst


def zero_solve_route(torch, K1, K4, dev, b, s, m, route="auto"):
  """Launch one iteration on zero inputs of b rows of s codes in groups of
  m (1: K1, elementwise; else K4) on the route given, and return the
  route the wrapper reports it took."""
  zeros = torch.zeros((b, s), device=dev)
  gram = torch.zeros((s, s), device=dev)
  eta = torch.ones(1, device=dev)
  if m == 1:
    K1._launch(gram, zeros, None, eta, LAM, 1, True, 0, route=route)
    return K1.last_route
  K4._launch(gram, zeros, None, eta, LAM, 1, m, True, False, route=route)
  return K4.last_route


def check_forced_refusals(torch, K1, K4, dev, route, b, shapes):
  """A launch of b rows forced onto route at each (s, M) of shapes, which
  its layout cannot hold, raises with the CUDA error and counts
  nothing."""
  for s, m in shapes:
    before = (K1.launches, K4.launches)
    try:
      zero_solve_route(torch, K1, K4, dev, b, s, m, route)
      refused = False
    except RuntimeError as e:
      refused = "CUDA error" in str(e)
    print("forced %s launch at s %d M %d: %s" % (
        route, s, m, "refused" if refused else "LAUNCHED"))
    check(refused and (K1.launches, K4.launches) == before,
          "a forced %s launch that does not fit must raise, uncounted"
          % route)


def cluster_route_cases(torch, K1, K4, lib, dev):
  """Phase 39 (c): the route launch_solve took for each shape equals
  solve_route's; the layout constants match the library's; a forced
  cluster launch that does not fit raises and counts nothing."""
  sm, slots = lib.vtc_fista_sm_count(), lib.vtc_fista_cluster_slots()
  check(sm == torch.cuda.get_device_properties(dev).multi_processor_count,
        "the library reads %d SMs" % sm)
  check(slots >= 1, "reading the cluster slots failed: CUDA error %d" % -slots)
  check((lib.vtc_fista_rows(), lib.vtc_fista_chunk(), lib.vtc_fista_cluster(),
         lib.vtc_fista_cluster_max_rows())
        == (K1.ROWS, K1.CHUNK, K1.CLUSTER, K1.CLUSTER_MAX_ROWS),
        "fused_fista's layout constants differ from the library's")
  rows250 = K1.cluster_rows(TRAIN_BATCH, 256, 1, slots)
  print("cluster kernel: %d SMs, %d cluster slots (clusters of %d resident "
        "at one CTA per SM); at b 250, s 256: %d rows a cluster, %d "
        "clusters, %d resident at once" % (
            sm, slots, K1.CLUSTER, rows250, -(-TRAIN_BATCH // rows250),
            lib.vtc_fista_cluster_occupancy(256, rows250)))
  shapes = [(250, 256, 1), (125, 256, 1), (37, 256, 1), (1024, 256, 1),
            (2048, 256, 1), (250, 40, 1), (13, 37, 1), (250, 512, 1),
            (64, 1024, 1), (250, 256, 4), (125, 256, 4), (2048, 256, 4),
            (250, 256, 2), (250, 256, 8), (125, 96, 3), (13, 104, 26),
            (250, 1024, 8)]
  for b, s, m in shapes:
    took = zero_solve_route(torch, K1, K4, dev, b, s, m)
    want = K1.solve_route(b, s, m, sm)
    rows = K1.cluster_rows(b, s, m, slots)
    lay = K1.cluster_layout(s, m, max(rows, 2))
    print("route: b %4d s %4d M %2d -> %-7s (solve_route %s; cluster layout "
          "%s)" % (b, s, m, took, want,
                   "%d rows, %d CTAs of %d threads, %d bytes" % (
                       rows, K1.cluster_grid(b, rows), lay["threads"],
                       lay["smem"]) if rows else "does not fit"))
    check(took == want == K1.ROUTE_NAMES[lib.vtc_fista_route(b, s, m)],
          "b %d s %d M %d: launch_solve took %s, solve_route says %s" % (
              b, s, m, took, want))
    check(rows == max(lib.vtc_fista_cluster_rows(b, s, m), 0),
          "b %d s %d M %d: the library takes %d rows a cluster, "
          "cluster_rows %d" % (b, s, m, lib.vtc_fista_cluster_rows(b, s, m),
                               rows))
  check_forced_refusals(torch, K1, K4, dev, "cluster", 16,
                        ((1024, 1), (104, 26)))


PROFILE_PAD_S = 0.25  # idle host time on each side of a profiled call


def device_events(torch, fn):
  """The device events of one call of fn, from torch.profiler. The
  profiler drops a device event that its clock places outside the window
  between its start and its stop; a window that closed just after the
  card finished lost the last launches of a call now and then (19 of 20,
  196 of 200), so the window opens and closes PROFILE_PAD_S away from
  the call's work."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    time.sleep(PROFILE_PAD_S)
    fn()
    torch.cuda.synchronize()
    time.sleep(PROFILE_PAD_S)
  return [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]


def solve_dispatch(torch, fn):
  """{'cluster': n, 'wide': n, 'classic': n, 'fold': n}: launches of
  fista_core.cuh's kernels (fista_cluster_kernel, fista_wide_kernel,
  fista_kernel, fold_gram_kernel) in one call of fn, from
  torch.profiler's device events."""
  out = {"cluster": 0, "wide": 0, "classic": 0, "fold": 0}
  for e in device_events(torch, fn):
    for key, name in (("cluster", "fista_cluster_kernel"),
                      ("wide", "fista_wide_kernel"),
                      ("classic", "fista_kernel"),
                      ("fold", "fold_gram_kernel")):
      if name in e.name:
        out[key] += 1
        break
  return out


def time_ms(torch, fn, reps):
  start, stop = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  stop.synchronize()
  return start.elapsed_time(stop) / reps


def gemm_profile(torch, fn):
  """{'tiled': [launches, device ms], 'line': [...]}: the gathered GEMM's
  two kernels (csrc/conv_gemm.cuh) in one call of fn, from
  torch.profiler's device events."""
  out = {"tiled": [0, 0.0], "line": [0, 0.0]}
  for e in device_events(torch, fn):
    if "gather_gemm" in e.name:
      slot = out["tiled" if "gather_gemm_tiled" in e.name else "line"]
      slot[0] += 1
      slot[1] += (e.time_range.end - e.time_range.start) / 1e3
  return out


# ---------------------------------------------------------------------------
# phase 42: the large-batch solve (fista_wide_kernel, csrc/fista_core.cuh)
# ---------------------------------------------------------------------------
WIDE_SHAPES = [  # (b, s, M): the wide route's and its edges
    (2048, 256, 1), (2048, 256, 2), (2048, 256, 4), (1100, 256, 1),
    (2047, 256, 4), (4096, 256, 1), (1057, 256, 2), (1056, 256, 1),
    (2048, 40, 1), (2048, 96, 4), (2048, 288, 1), (2048, 256, 8),
    (2048, 320, 1), (2048, 96, 3)]


def wide_bitwise_cases(torch, K1, K4, patches, gpatches, dev):
  """Phase 42 (a): fista_wide_kernel and fista_kernel, both forced, on the
  same CPU-made inputs (100 iterations); the codes must be torch.equal.
  Returns the number of cases."""
  rng = np.random.RandomState(42)
  dicts = {256: unit_rows(np.random.RandomState(0), 256, 256),
           40: unit_rows(rng, 40, 256), 96: unit_rows(rng, 96, 256)}
  inputs = {}

  def problem(s, b, grouped):
    key = (s, grouped)
    if key not in inputs:
      x = (gpatches if grouped else patches)[:4096]
      inputs[key] = solve_inputs(torch, x, dicts[s], dev)
    gram, corr, eta = inputs[key]
    return gram, corr[:b].contiguous(), eta

  def warm(b, s):
    w = 0.05 * rng.randn(b, s) * (rng.rand(b, s) < 0.1)
    return torch.tensor(w.astype(np.float32), device=dev)

  # (label, s, b, M or None, fista, mode or hard, warm)
  cases = [("fc b2048", 256, 2048, None, fista, mode, w)
           for fista in (True, False) for mode in range(4)
           for w in (False, True)]
  cases += [("group b2048", 256, 2048, m, True, hard, False)
            for m in (1, 2, 4) for hard in (False, True)]
  cases.append(("group b2048", 256, 2048, 4, False, False, True))
  for b in (1100, 2047):
    cases += [("ragged b%d" % b, 256, b, None, True, 0, True),
              ("ragged b%d" % b, 256, b, None, False, 2, False),
              ("ragged b%d" % b, 256, b, 4, True, False, False),
              ("ragged b%d" % b, 256, b, 2, True, True, True)]
  cases += [("b4096", 256, 4096, None, True, 0, False),
            ("b4096", 256, 4096, 4, True, True, False)]
  for s in (40, 96):
    cases += [("s%d b2048" % s, s, 2048, None, True, 0, False),
              ("s%d b2048" % s, s, 2048, None, False, 3, True),
              ("s%d b2048" % s, s, 2048, 4, True, False, False),
              ("s%d b2048" % s, s, 2048, 2, True, True, True)]
  sm = torch.cuda.get_device_properties(dev).multi_processor_count
  by_label = {}
  for label, s, b, m, fista, mode, w in cases:
    check(K1.solve_route(b, s, m or 1, sm) == "wide",
          "%s: s %d b %d M %s is not a wide-route shape" % (label, s, b, m))
    gram, corr, eta = problem(s, b, m is not None)
    init = warm(b, s) if w else None
    if m is None:
      run = lambda route: K1._launch(gram, corr, init, eta, LAM, ITERS,
                                     fista, mode, route=route)
    else:
      run = lambda route: K4._launch(gram, corr, init, eta, LAM, ITERS, m,
                                     fista, bool(mode), route=route)
    classic, wide = run("classic"), run("wide")
    torch.cuda.synchronize()
    same = torch.equal(classic, wide)
    differ = int((classic != wide).sum())
    stats = by_label.setdefault(label, [0, 0, 0.0, 0])
    stats[0] += 1
    stats[1] += int(same)
    stats[2] = max(stats[2], float(classic.abs().max()))
    stats[3] += int((classic != 0).sum())
    check(same, "%s s %d b %d M %s %s mode %s warm %s: the wide kernel's "
          "codes differ from fista_kernel's at %d of %d entries" % (
              label, s, b, m, "fista" if fista else "ista", mode, w, differ,
              classic.numel()))
  for label, (n, same, top, nonzero) in by_label.items():
    print("wide vs classic, %-12s %3d cases, %3d bitwise equal (max|code| "
          "%.4f, %d nonzero codes)" % (label, n, same, top, nonzero))
  return len(cases)


def wide_route_cases(torch, K1, K4, lib, dev):
  """Phase 42 (c): for each of WIDE_SHAPES the route launch_solve took,
  ops/fused_fista.solve_route's choice and the library's agree, and on
  the wide route so do the cluster size and the rows a cluster; the
  flagship fills the card in one wave; a forced wide launch the layout
  cannot hold raises and counts nothing."""
  sm = lib.vtc_fista_sm_count()
  for b, s, m in WIDE_SHAPES:
    took = zero_solve_route(torch, K1, K4, dev, b, s, m)
    want = K1.solve_route(b, s, m, sm)
    check(took == want == K1.ROUTE_NAMES[lib.vtc_fista_route(b, s, m)],
          "b %d s %d M %d: launch_solve took %s, solve_route says %s" % (
              b, s, m, took, want))
    cluster = K1.wide_cluster(s, m)
    check(cluster == lib.vtc_fista_wide_cluster(s, m),
          "s %d M %d: the library's wide clusters have %d CTAs, "
          "wide_cluster %d" % (s, m, lib.vtc_fista_wide_cluster(s, m),
                               cluster))
    layout = "does not fit"
    if cluster:
      slots = lib.vtc_fista_wide_slots(cluster)
      check(slots >= 1, "reading the wide slots failed: CUDA error %d"
            % -slots)
      rows = K1.wide_rows(b, s, m, slots)
      check(rows == lib.vtc_fista_wide_rows(b, s, m),
            "b %d s %d M %d: the library takes %d rows a wide cluster, "
            "wide_rows %d" % (b, s, m, lib.vtc_fista_wide_rows(b, s, m),
                              rows))
      lay = K1.wide_layout(s, cluster, rows)
      layout = ("clusters of %d (%d resident), %d rows, %d CTAs of %d "
                "threads, %d bytes" % (cluster, slots, rows,
                                       K1.wide_grid(b, s, m, rows),
                                       lay["threads"], lay["smem"]))
      if (b, s) == (BATCH, 256):
        check(-(-b // rows) <= slots, "the flagship takes more than one "
              "wave: %d clusters for %d slots" % (-(-b // rows), slots))
    print("route: b %4d s %4d M %d -> %-7s (solve_route %s; wide layout %s)"
          % (b, s, m, took, want, layout))
  check_forced_refusals(torch, K1, K4, dev, "wide", BATCH,
                        ((1024, 1), (96, 3)))


def solve_library_ms(torch, dev):
  """The library time of K1's and K4's timed solve: 100 (2048 x 256) @
  (256 x 256) products, each one torch.matmul (cuBLAS) in fp32 with TF32
  off, the iterations' products without their prox."""
  from vtc_tpu_torch.ops.precision import matmul_precision
  gen = torch.Generator(device=dev).manual_seed(42)
  z = torch.randn((BATCH, 256), generator=gen, device=dev)
  g = torch.randn((256, 256), generator=gen, device=dev)
  with matmul_precision():
    torch.matmul(z, g)
    return ITERS * time_ms(torch, lambda: torch.matmul(z, g), 200)


# ---------------------------------------------------------------------------
# phase 43: the in-kernel early stop (csrc/fista_core.cuh, "The early stop")
# ---------------------------------------------------------------------------
STOP_ITERS = 100          # phase 43's solve depth
STOP_SHAPES = [  # (b, s, M or None for fc, the route the stop takes)
    (TRAIN_BATCH, 256, None, "cluster"), (TRAIN_BATCH, 256, 4, "cluster"),
    (BATCH, 256, None, "wide"), (BATCH, 256, 4, "wide"),
    (4096, 256, None, "classic"), (4096, 256, 4, "classic"),  # 2 waves
    (BATCH, 320, None, "classic"), (TRAIN_BATCH, 96, 3, "classic"),
    # small batches, where hard thresholds compare with plain (below)
    (37, 40, None, "cluster"), (37, 40, 4, "cluster"),
    (37, 48, 3, "classic")]
# Hard thresholds are discontinuous: from b 250 up, a code that crosses
# the threshold one iteration apart in two float32 solves moves the rest
# of the trajectory by more than the limit (as phases 5 and 39 find), so
# hard cases are held to plain at the small shapes and reported there.
STOP_HARD_PLAIN_BATCH = 250


def stop_eps(avgs, which):
  """An eps for the stop test from a plain run's means (avgs[k - 1] after
  iteration k): 'early' stops at k = 1, 'mid' at the first new low past the
  first quarter 5% under every earlier mean (eps between the two), 'never'
  is 0."""
  if which == "never":
    return 0.0
  if which == "early":
    return 1.5 * avgs[0]
  for k in range(max(2, len(avgs) // 4), len(avgs)):
    low = min(avgs[:k])
    if avgs[k] < 0.95 * low:
      return float(np.sqrt(avgs[k] * low))
  return float(avgs[len(avgs) // 2])  # no clear low: a mean of the run


def stop_solve_cases(torch, K1, K4, lipschitz, solver, lib, patches,
                     gpatches, dev):
  """Phase 43 (a): K1 and K4 with the stop on each route (STOP_SHAPES), fc
  soft / nonneg / hard and groups soft / hard, FISTA and ISTA, three eps:
  the route is the expected one and stop_route's; the codes are bitwise
  those of the same route run without the stop for the count it reports;
  a second call gives the same count and bits; the count is the plain
  fp32 version's and the codes within phase 2's limit of it (a case whose
  plain mean lies within 1e-5 relative of eps is reported apart, and so is
  a hard case from STOP_HARD_PLAIN_BATCH up that passes its other checks).
  Returns (cases, the largest error against plain, near cases, hard
  cases reported)."""
  from vtc_tpu_torch.ops.precision import matmul_precision
  rng = np.random.RandomState(43)
  dicts = {256: unit_rows(np.random.RandomState(0), 256, 256),
           320: unit_rows(rng, 320, 256), 96: unit_rows(rng, 96, 256),
           40: unit_rows(rng, 40, 256), 48: unit_rows(rng, 48, 256)}
  sm, cslots = lib.vtc_fista_sm_count(), lib.vtc_fista_cluster_slots()
  cases, worst, near, hard_split = 0, 0.0, [], []
  for b, s, m, want_route in STOP_SHAPES:
    x = torch.tensor((gpatches if m else patches)[:b], device=dev)
    d = torch.tensor(dicts[s], device=dev)
    eta = lipschitz.fista_stepsize(d).reshape(1).float().contiguous()
    with matmul_precision():
      gram, corr = (d @ d.T).contiguous(), (x @ d.T).contiguous()
    gm = m or 1
    wcl = K1.wide_cluster(s, gm)
    wslots = lib.vtc_fista_wide_slots(wcl) if wcl else 1
    mirror = K1.stop_route(b, s, gm, sm, cslots, wslots)
    words = lib.vtc_fista_stop_words(b, s, gm)
    check(mirror == want_route == K1.ROUTE_NAMES[
        lib.vtc_fista_stop_route(b, s, gm)],
          "b %d s %d M %d: the stop route is %s, stop_route says %s, the "
          "library %d" % (b, s, gm, want_route, mirror,
                          lib.vtc_fista_stop_route(b, s, gm)))
    check(words == K1.stop_words(mirror, b, s, gm, cslots, wslots),
          "b %d s %d M %d: the library's stop words %d differ from "
          "stop_words" % (b, s, gm, words))
    modes = [(f, mode) for f in (True, False)
             for mode in ((0, 1, 2) if m is None else (0, 1))]
    tally = [0, 0, 0, 0, 0.0, []]  # cases, bitwise, det, counts, err, its
    for fista, mode in modes:
      variant = "fista" if fista else "ista"

      def plain(eps):
        if m is None:
          out = K1.fused_fista_plain(
              x, d, LAM, STOP_ITERS, eta, variant=variant, nonneg=mode == 1,
              hard=mode == 2, early_stopping_epsilon=eps)
        else:
          out = K4.fused_group_fista_plain(
              x, d, m, LAM, STOP_ITERS, eta, variant=variant,
              hard=bool(mode), early_stopping_epsilon=eps)
        return out, solver.last_iters, list(solver.last_avgs)

      def kernel(iters, eps=None, route="auto"):
        mod = K1 if m is None else K4
        if m is None:
          out = K1._launch(gram, corr, None, eta, LAM, iters, fista, mode,
                           route=route, eps=eps)
        else:
          out = K4._launch(gram, corr, None, eta, LAM, iters, m, fista,
                           bool(mode), route=route, eps=eps)
        return out, mod.last_route, mod.last_iters

      avgs = plain(0.0)[2]
      for which in ("early", "mid", "never"):
        eps = stop_eps(avgs, which)
        got, route, its = kernel(STOP_ITERS, eps)
        it = int(its.item())
        again, _, its2 = kernel(STOP_ITERS, eps)
        ref = kernel(it, None, route)[0]
        want, plain_it, plain_avgs = plain(eps)
        torch.cuda.synchronize()
        label = "b %d s %d M %s %s mode %s eps %s (%.4g)" % (
            b, s, m, variant, mode, which, eps)
        check(route == want_route, "%s: took %s" % (label, route))
        same, det = torch.equal(got, ref), (
            torch.equal(got, again) and int(its2.item()) == it)
        check(same, "%s: the stopped codes (%d it) differ from the %s "
              "route's without the stop at %d of %d entries" % (
                  label, it, route, int((got != ref).sum()), got.numel()))
        check(det, "%s: a second call differs (%d vs %d it)" % (
            label, it, int(its2.item())))
        close = eps > 0 and any(abs(a - eps) <= 1e-5 * eps
                                for a in plain_avgs)
        if close:
          near.append("%s: kernel %d it, plain %d" % (label, it, plain_it))
        else:
          check(it == plain_it, "%s: the kernel ran %d iterations, the "
                "plain version %d" % (label, it, plain_it))
        if it == plain_it:
          err = float((got - want).abs().max())
          lim = limit(want)
          hard = mode == 2 if m is None else mode == 1
          if hard and b >= STOP_HARD_PLAIN_BATCH and err > lim:
            hard_split.append("%s: max|d| %.3e against plain, limit %.3e, "
                              "%d of %d entries past it" % (
                                  label, err, lim,
                                  int(((got - want).abs() > lim).sum()),
                                  got.numel()))
          else:
            check(err <= lim, "%s: max|d| %.3e against plain, limit %.3e"
                  % (label, err, lim))
            tally[4] = max(tally[4], err)
        tally[0] += 1
        tally[1] += int(same)
        tally[2] += int(det)
        tally[3] += int(it == plain_it)
        tally[5].append(it)
        cases += 1
    worst = max(worst, tally[4])
    print("stop, b %4d s %3d %-8s route %-7s (%d words): %2d cases, %2d "
          "bitwise the route's at the count, %2d deterministic, %2d counts "
          "equal plain's, max|d| %.3e; counts %s" % (
              b, s, "fc" if m is None else "M %d" % m, want_route, words,
              tally[0], tally[1], tally[2], tally[3], tally[4],
              " ".join(map(str, tally[5]))))
  return cases, worst, near, hard_split


def stop_trainer_runs(torch, compiled_epoch, K1, K2, K6, batches, held,
                      gbatches, gheld, d0, steps, eps):
  """Phase 43 (b): the flagship scanned fc and subspace trainers with a
  stop at eps: each step's solve is one fista_cluster_kernel launch (and
  no other solve kernel), and some solves end before TRAIN_ITERS.
  Returns {label: per-step counts}."""
  counts = {}
  for label, x, h, params_, mod in (
      ("fc (K2)", batches, held, train_params(steps), K2),
      ("subspace (K6)", gbatches, gheld,
       subspace_train_params(steps, SUB_STEP), K6)):
    params_ = dict(params_, early_stopping_epsilon=eps)
    seen = solve_dispatch(
        torch, lambda: compiled_epoch.train_dictionary_scanned(
            x[:steps], h[None], d0, params_))
    its = mod.last_iters.tolist()
    counts[label] = its
    print("dispatch (profiled), train_dictionary_scanned %s with "
          "early_stopping_epsilon %.4g, %d steps of b 250: "
          "fista_cluster_kernel %d, fista_wide_kernel %d, fista_kernel %d, "
          "fold_gram_kernel %d; solve iterations %s" % (
              label, eps, steps, seen["cluster"], seen["wide"],
              seen["classic"], seen["fold"], its))
    check(seen == {"cluster": steps, "wide": 0, "classic": 0, "fold": 0},
          "%s: expected one fista_cluster_kernel launch a step with the "
          "stop, saw %s" % (label, seen))
    check(len(its) == steps and min(its) < TRAIN_ITERS,
          "%s: no solve stopped early (%s)" % (label, its))
  return counts


def stop_train_eps(torch, K1, solver, lipschitz, train_patches, dev):
  """The trainers' eps in phase 43: a mid-run stop (stop_eps) of the
  flagship's first solve (b 250, FISTA 25, phase 5's dictionary)."""
  d = torch.tensor(unit_rows(np.random.RandomState(2), 256, 256), device=dev)
  x = torch.tensor(train_patches[:TRAIN_BATCH], device=dev)
  K1.fused_fista_plain(x, d, LAM, TRAIN_ITERS, lipschitz.fista_stepsize(d),
                       early_stopping_epsilon=0.0)
  return stop_eps(solver.last_avgs, "mid")


def stop_train_step_cases(torch, K2, K6, solver, lipschitz, train_patches,
                          gtrain, dev, eps):
  """Phase 43 (b): one flagship K2 and K6 step with the stop at eps against
  the fp32 plain version: the same solve count and every output within
  phase 5's limit.  Returns the largest difference."""
  d = torch.tensor(unit_rows(np.random.RandomState(2), 256, 256), device=dev)
  h = torch.zeros(256, device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  names = ("dictionary", "hessian", "eigvec", "codes", "stepsize")
  worst = 0.0
  for label, mod, data, kw in (
      ("K2", K2, train_patches, {}),
      ("K6", K6, gtrain,
       {"group_assignments": contiguous_groups(256, GROUP_SIZE)})):
    x = torch.tensor(data[:TRAIN_BATCH][None], device=dev)
    flags = dict(kw, power_iters=2, return_stepsize=True,
                 early_stopping_epsilon=eps)
    args = (d, h, v, x, LAM, TRAIN_ITERS, TRAIN_STEP)
    plain = (K2.fused_train_segment_plain if mod is K2
             else K6.fused_group_train_segment_plain)
    got = (K2.fused_train_segment if mod is K2
           else K6.fused_group_train_segment)(*args, **flags)
    its = int(mod.last_iters[0].item())
    want = plain(*args, **flags)
    plain_it = solver.last_iters
    torch.cuda.synchronize()
    check(its == plain_it, "%s with the stop: %d solve iterations, the plain "
          "version %d" % (label, its, plain_it))
    for what, g, w in zip(names, got, want):
      err = float((g - w).abs().max())
      lim = limit(w) if float(w.abs().max()) > 0 else TOL
      print("stop, %s one flagship step (eps %.4g, %d of %d iterations) vs "
            "plain: %-10s max|d| %.3e limit %.3e" % (
                label, eps, its, TRAIN_ITERS, what, err, lim))
      check(err <= lim, "%s with the stop: %s differs from plain by %.3e, "
            "limit %.3e" % (label, what, err, lim))
      worst = max(worst, err)
  return worst


# ---------------------------------------------------------------------------
# phase 44: the conv family's early stop (csrc/conv_gemm.cuh, "The early
# stop"): K10, K11, K12 and K17
# ---------------------------------------------------------------------------
CONV_STOP_STEPS = 200     # the scanned trainer with the stop (phase 19's)
CONV_STOP_GRAM_STEPS = 20  # its 'gram' formulation, timed beside it
DP2_STOP_STEPS = 10       # phase 28's world-of-2 run with the stop


def conv_stop_case(torch, label, mod, run, plain, which, eps, names,
                   near):
  """One stopped case: ``run(eps, iters)`` the kernel's call (eps None:
  without the stop), ``plain(eps)`` its fp32 plain version; mod.last_iters
  the kernel's counts.  The stopped outputs must be bitwise those of the
  kernel without the stop run to the count it reports, the count the
  plain version's (a case whose plain mean lies within 1e-5 relative of
  eps goes to ``near`` instead), and every output within phase 2's limit
  of plain.  Returns (count, the largest difference against plain)."""
  got = run(eps, None)
  it = int(mod.last_iters[-1].item())
  ref = run(None, it)
  want = plain(eps)
  plain_it, plain_avgs = solver_state()
  torch.cuda.synchronize()
  got, ref, want = (t if isinstance(t, tuple) else (t,)
                    for t in (got, ref, want))
  for what, g, r in zip(names, got, ref):
    check(torch.equal(g, r), "%s eps %s: the stopped %s (%d it) differs "
          "from the kernel's without the stop at %d of %d entries" % (
              label, which, what, it, int((g != r).sum()), g.numel()))
  if eps > 0 and any(abs(a - eps) <= 1e-5 * eps for a in plain_avgs):
    near.append("%s eps %s: kernel %d it, plain %d" % (label, which, it,
                                                        plain_it))
    return it, 0.0
  check(it == plain_it, "%s eps %s (%.4g): the kernel ran %d iterations, "
        "the plain version %d" % (label, which, eps, it, plain_it))
  worst = 0.0
  for what, g, w in zip(names, got, want):
    err = float((g - w).abs().max())
    lim = limit(w) if float(w.abs().max()) > 0 else TOL
    check(bool(torch.isfinite(g).all()) and err <= lim,
          "%s eps %s: %s differs from plain by %.3e, limit %.3e" % (
              label, which, what, err, lim))
    worst = max(worst, err)
  return it, worst


def solver_state():
  """(iterations, means) of the plain loop's last run."""
  from vtc_tpu_torch.ops import solver
  return solver.last_iters, list(solver.last_avgs)


def conv_stop_solve_cases(torch, K10, K11, conv_ops, lipschitz, x_flag,
                          flag_d, padding, dev):
  """Phase 44 (a): K10 at the flagship (b 40 FISTA 100), the trainer's b 5
  ISTA 25, the 12x12/8 zero-extended geometry and c = 3 nonneg / hard;
  K11 at phase 14's flagship; each with an eps stopping at k 1, one
  stopping mid-run and 0 (never).  Returns (cases, {label: counts},
  {module: the largest difference against plain}, the near cases,
  {label: the mid eps})."""
  stride = (CONV_STRIDE, CONV_STRIDE)
  x = torch.tensor(x_flag[:CONV_BATCH], device=dev)
  d = torch.tensor(flag_d, device=dev)
  eta = lipschitz.fista_stepsize(d.reshape(CONV_S, -1))
  kw = dict(kernel_stride=stride, padding=padding)
  d_init = torch.tensor(unit_kernels(np.random.RandomState(2), CONV_S, 1,
                                     CONV_K), device=dev)
  gen12 = windowed_kernels(np.random.RandomState(0), CONV_S, 1, 12)
  x12, pad12 = conv_images(torch, conv_ops, dev, CONV_BATCH, gen12,
                           CONV_STRIDE, CONV_IMG, seed=3)
  d12 = torch.tensor(gen12, device=dev)
  rng = np.random.RandomState(5)
  x3 = torch.tensor(np.pad(rng.randn(3, 3, 16, 16),
                           ((0, 0), (0, 0), (2, 2), (2, 2))).astype(
                               np.float32), device=dev)
  d3 = torch.tensor(unit_kernels(rng, 6, 3, 4), device=dev)
  kw3 = dict(kernel_stride=(2, 2), padding=((2, 2), (2, 2)))
  # (label, module, x, d, lambda, iters, eta, flags)
  cases = [
      ("K10 flagship b40 fista100", K10, x, d, CONV_LAM, CONV_ITERS, eta,
       kw),
      ("K10 trainer b5 ista25", K10, x[:CONV_TRAIN_BATCH], d_init, CONV_LAM,
       CONV_TRAIN_ITERS, lipschitz.fista_stepsize(
           d_init.reshape(CONV_S, -1)), dict(kw, variant="ista")),
      ("K10 12x12/8 zero-extended b40 fista100", K10,
       torch.tensor(x12, device=dev), d12, CONV_LAM, CONV_ITERS,
       lipschitz.fista_stepsize(d12.reshape(CONV_S, -1)),
       dict(kernel_stride=stride, padding=pad12)),
      ("K10 c3 4x4/2 fista nonneg", K10, x3, d3, 0.05, 20,
       0.5 * lipschitz.fista_stepsize(d3.reshape(6, -1)),
       dict(kw3, nonneg=True)),
      ("K10 c3 4x4/2 ista hard", K10, x3, d3, 0.05, 20,
       0.5 * lipschitz.fista_stepsize(d3.reshape(6, -1)),
       dict(kw3, variant="ista", hard=True)),
      ("K11 flagship b40 fista100", K11, x, d, CONV_LAM, CONV_ITERS, eta,
       kw),
  ]
  n, counts, worst, near, mids = 0, {}, {K10: 0.0, K11: 0.0}, [], {}
  for label, mod, xc, dc, lam, iters, step, flags in cases:
    direct = mod is K10
    solve = K10.fused_conv_direct_solve if direct else \
        K11.fused_conv_fista_solve
    plain_fn = K10.fused_conv_direct_plain if direct else \
        K11.fused_conv_fista_plain

    def run(eps, count):
      return solve(xc, dc, lam, iters if count is None else count, step,
                   early_stopping_epsilon=eps, **flags)

    def plain(eps):
      return plain_fn(xc, dc, lam, iters, step, early_stopping_epsilon=eps,
                      **flags)

    plain(0.0)
    avgs = solver_state()[1]
    its = []
    for which in ("early", "mid", "never"):
      eps = stop_eps(avgs, which)
      it, err = conv_stop_case(torch, label, mod, run, plain, which, eps,
                               ("codes",), near)
      its.append(it)
      worst[mod] = max(worst[mod], err)
      n += 1
    counts[label], mids[label] = its, stop_eps(avgs, "mid")
    print("stop, %-40s counts (k 1, mid, never) %s of %d; bitwise the "
          "kernel without the stop at the count" % (label, its, iters))
  return n, counts, worst, near, mids


def conv_stop_step_cases(torch, K12, K17, parallel, lipschitz, x_flag,
                         flag_d, padding, dev):
  """Phase 44 (b): one flagship K12 step (b 40 FISTA 25) and one K17 step
  at a world of 1 with eps stopping at k 1, mid-run and never, against
  the same kernel without the stop at the count and the plain versions.
  Returns (cases, {module: the largest difference}, the near cases, the
  mid eps)."""
  x = torch.tensor(x_flag[:SEG_BATCH], device=dev)[None]
  d = torch.tensor(flag_d, device=dev)
  h = torch.full((CONV_S,), 0.01, device=dev)
  v = lipschitz.top_gram_eigenpair(d.reshape(CONV_S, -1))[1].contiguous()
  kw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=padding,
            power_iters=2)
  mesh1 = parallel.make_mesh()
  K12.fused_conv_train_plain(d, h, v, x, CONV_LAM, SEG_ITERS, SEG_STEP,
                             early_stopping_epsilon=0.0, **kw)
  avgs = solver_state()[1]
  n, worst, near, mid = 0, {K12: 0.0, K17: 0.0}, [], stop_eps(avgs, "mid")
  for label, mod, seg, plain_seg, extra in (
      ("K12 flagship step", K12, K12.fused_conv_train_segment,
       K12.fused_conv_train_plain, {}),
      ("K17 flagship step, world of 1", K17,
       K17.fused_conv_dp_train_segment, K17.fused_conv_dp_train_plain,
       {"mesh": mesh1})):

    def run(eps, count):
      return seg(d, h, v, x, CONV_LAM, SEG_ITERS if count is None else count,
                 SEG_STEP, early_stopping_epsilon=eps, **kw, **extra)

    def plain(eps):
      return plain_seg(d, h, v, x, CONV_LAM, SEG_ITERS, SEG_STEP,
                       early_stopping_epsilon=eps, **kw, **extra)

    its = []
    for which in ("early", "mid", "never"):
      eps = stop_eps(avgs, which)
      it, err = conv_stop_case(torch, label, mod, run, plain, which, eps,
                               K17_NAMES, near)
      its.append(it)
      worst[mod] = max(worst[mod], err)
      n += 1
    print("stop, %-40s counts (k 1, mid, never) %s of %d; every output "
          "bitwise the kernel without the stop at the count, max|d| from "
          "plain %.3e" % (label, its, SEG_ITERS, worst[mod]))
  return n, worst, near, mid


def conv_stop_trainer(torch, compiled_epoch, K10, K11, K12, sparse_coding,
                      conv_ista_fista, batches, held, d0, eps):
  """Phase 44 (c): the scanned conv trainer at measure_conv(40, 25) with a
  mid-run eps, CONV_STOP_STEPS steps: every step on K12 (no K10 or K11
  launch), most solves ending before SEG_ITERS, the kernels finite and
  unit norm, the held-out loss falling.  Returns (seconds, counts)."""
  K12.launches = K10.launches = K11.launches = 0
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  trained = compiled_epoch.train_dictionary_scanned(
      batches[:CONV_STOP_STEPS], held[None], d0,
      dict(conv_segment_params(CONV_STOP_STEPS, SEG_STEP),
           early_stopping_epsilon=eps))
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  counts = K12.last_iters.tolist()
  launches = (K12.launches, K10.launches + K11.launches)
  norm_err = float((torch.linalg.vector_norm(
      trained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
  loss0 = held_out_fista_conv_loss(conv_ista_fista, sparse_coding, held, d0)
  loss1 = held_out_fista_conv_loss(conv_ista_fista, sparse_coding, held,
                                   trained)
  below = sum(c < SEG_ITERS for c in counts)
  print("conv scanned trainer with the stop (eps %.4g): %d K12 steps, %d "
        "K10/K11 solves; %d of %d solves ended before %d iterations (mean "
        "%.2f, min %d, max %d); kernels unit norm within %.2e; held-out "
        "loss %.6f -> %.6f" % (
            eps, *launches, below, len(counts), SEG_ITERS,
            float(np.mean(counts)), min(counts), max(counts), norm_err,
            loss0, loss1))
  check(launches == (CONV_STOP_STEPS, 0) and len(counts) == CONV_STOP_STEPS,
        "expected %d K12 steps and no other solve, counted %s (%d counts)" % (
            CONV_STOP_STEPS, launches, len(counts)))
  check(2 * below > len(counts), "most solves should stop early: %d of %d"
        % (below, len(counts)))
  check(bool(torch.isfinite(trained).all()) and norm_err <= 1e-4,
        "the kernels are not finite and unit norm (%.3e)" % norm_err)
  check(np.isfinite(loss1) and loss1 < loss0,
        "held-out conv LASSO loss did not fall: %.6f -> %.6f" % (loss0,
                                                                 loss1))
  return seconds, counts


# ---------------------------------------------------------------------------
# phase 40: the persistent ICA segment kernel (csrc/ica_segment.cuh)
# ---------------------------------------------------------------------------
ICA_STEP_KERNELS = ("gemm_kernel", "sign_kernel", "residual_kernel",
                    "natural_gradient_kernel", "axpy_kernel")
ICA_ROUTE_STEPS = 100     # phase 40's timed segments


def bits_equal(torch, a, b):
  """The same float32 bits (NaN payloads included)."""
  return (a.shape == b.shape and a.dtype == b.dtype
          and torch.equal(a.contiguous().view(torch.int32),
                          b.contiguous().view(torch.int32)))


def ica_cpu_problem(torch, n, b, k, seed, stale, dev):
  """Made on the CPU with numpy: a random orthogonal dictionary, its
  inverse (times ``stale``) as the seed and k batches of b mixtures of
  sources at least 0.05 from zero, moved to the card."""
  rng = np.random.RandomState(seed)
  d = np.linalg.qr(rng.randn(n, n))[0]
  src = np.sign(rng.randn(k * b, n)) * (0.05 + rng.laplace(size=(k * b, n)))
  x = (src @ d).reshape(k, b, n)
  xi = stale * np.linalg.inv(d)
  return [torch.tensor(a.astype(np.float32), device=dev) for a in (d, xi, x)]


def ica_routes(torch, K8, d, xi, x, step, upd, mesh=None, grid=0):
  """{route: (D, X, r_max)}: both routes, forced, on the same inputs (K18's
  wrapper when mesh is given); grid sets the persistent launch's CTAs."""
  out = {}
  for route in ("steps", "persistent"):
    args = (d.clone(), xi.clone(), x)
    tail = (ICA_REFINE, upd, ICA_BOOST_TOL)
    g = grid if route == "persistent" else 0
    if mesh is None:
      out[route] = K8._launch(*args, step, *tail, route=route, grid=g)
    else:
      out[route] = K8._launch_dp(*args, mesh, step, *tail, route=route,
                                 grid=g)
    torch.cuda.synchronize()
    check(K8.last_route == route, "asked for the %s route, took %s" % (
        route, K8.last_route))
  return out


def ica_persistent_bitwise_cases(torch, K8, parallel, lib, dev):
  """Phase 40 (a): the persistent and the per-step routes of K8 and K18
  (world of 1) give bitwise the same D, X and r_max; (c) the library's
  layout and grid are ops/fused_ica_train's; a grid the card cannot hold
  at once is refused.  Returns the number of equal cases."""
  sm, bps = lib.vtc_ica_segment_sm_count(), lib.vtc_ica_segment_blocks_per_sm()
  check(sm == torch.cuda.get_device_properties(dev).multi_processor_count,
        "the library reads %d SMs" % sm)
  layout = (ctypes_ints(4))
  lib.vtc_ica_segment_layout(layout)
  check(tuple(layout) == (K8.SEG_TILE_M, K8.SEG_TILE_N, K8.SEG_SLICE,
                          K8.SEG_THREADS),
        "fused_ica_train's layout constants differ from the library's: %s"
        % (tuple(layout),))
  for n, b in ((256, 250), (256, 125), (24, 13), (200, 77), (384, 250),
               (1024, 250)):
    plan = K8.segment_plan(n, b, sm, bps)
    got = lib.vtc_ica_segment_grid(n, b)
    print("segment kernel at n %4d b %3d: grid %4d CTAs (%d SMs x %d CTAs "
          "an SM; tiles of an n x n phase %d, of the residual and codes "
          "phase %d)" % (n, b, got, sm, bps, plan["tiles"]["n x n"],
                         plan["tiles"]["residual and codes"]))
    check(got == plan["grid"], "the library's grid %d, segment_plan's %d" % (
        got, plan["grid"]))
  mesh1 = parallel.make_mesh()
  equal = 0
  cases = [
      # label, n, b, steps, upd, stale, stepsize, grid (0: the shape's own)
      ("n 256 b 250, 1 step, upd 1", 256, 250, 1, 1, 1.0, ICA_STEP, 0),
      ("n 256 b 250, 1 step, upd 3", 256, 250, 1, 3, 1.0, ICA_STEP, 0),
      ("n 256 b 250, 50 steps, upd 1", 256, 250, 50, 1, 1.0, ICA_STEP, 0),
      ("n 256 b 250, 50 steps, upd 3", 256, 250, 50, 3, 1.0, ICA_STEP, 0),
      ("n 256 b 250, stale 1.35 X seed", 256, 250, 3, 1, 1.35, ICA_STEP, 0),
      ("n 256 b 250, stepsize 40", 256, 250, 3, 1, 1.0, 40.0, 0),
      ("n 24 b 13", 24, 13, 5, 1, 1.0, ICA_STEP, 0),
      ("n 24 b 13 on 1 CTA", 24, 13, 5, 2, 1.0, ICA_STEP, 1),
      ("n 200 b 77", 200, 77, 5, 1, 1.0, ICA_STEP, 0),
      ("n 200 b 77 on 7 CTAs", 200, 77, 5, 1, 1.35, ICA_STEP, 7),
      ("n 384 b 250", 384, 250, 5, 1, 1.0, ICA_STEP, 0),
      ("n 384 b 250 on 132 CTAs", 384, 250, 5, 3, 1.0, ICA_STEP, 132),
  ]
  for label, n, b, k, upd, stale, step, grid in cases:
    d, xi, x = ica_cpu_problem(torch, n, b, k, 400 + n + b, stale, dev)
    k8 = ica_routes(torch, K8, d, xi, x, step, upd, grid=grid)
    k18 = ica_routes(torch, K8, d, xi, x, step, upd, mesh=mesh1, grid=grid)
    pairs = (("K8 persistent vs steps", k8["persistent"], k8["steps"]),
             ("K18 persistent vs steps", k18["persistent"], k18["steps"]),
             ("K18 vs K8, persistent", k18["persistent"], k8["persistent"]))
    for what, got, want in pairs:
      same = [bits_equal(torch, g, w) for g, w in zip(got, want)]
      check(all(same), "%s, %s: D, X, r_max bitwise equal %s; max|dD| %.3e"
            % (label, what, same, float((got[0] - want[0]).abs().max())))
      equal += 1
    res = float(k8["persistent"][2])
    print("phase 40 (a) %-32s K8 and K18 (world of 1), both routes: D, X "
          "and r_max bitwise equal; r_max %r" % (label, res))
    if step == 40.0:
      check(not res < ICA_GUARD_TOL,
            "stepsize 40 did not show in the residual: %r" % res)
    if stale > 1.0:
      check(res < ICA_BOOST_TOL, "the stale seed's boost did not restore "
            "the floor: %r" % res)
  # a grid the card cannot hold at once: the launch is refused and raises
  d, xi, x = ica_cpu_problem(torch, 256, 250, 1, 7, 1.0, dev)
  before = K8.launches
  try:
    K8._launch(d.clone(), xi.clone(), x, ICA_STEP, ICA_REFINE, 1,
               ICA_BOOST_TOL, route="persistent", grid=sm * bps + 1)
    refused = False
  except RuntimeError as e:
    refused = "CUDA error" in str(e)
  print("forced persistent launch of %d CTAs (%d fit at once): %s" % (
      sm * bps + 1, sm * bps, "refused" if refused else "LAUNCHED"))
  check(refused and K8.launches == before,
        "a cooperative launch the card cannot hold must raise, uncounted")
  return equal


# ---------------------------------------------------------------------------
# phase 41: the persistent solve under K19 (csrc/code_shard_solve.cuh)
# ---------------------------------------------------------------------------
CS_STEP_KERNELS = ("recon_partial_kernel", "recon_sum_kernel",
                   "grad_prox_kernel")


def cs_cpu_problem(torch, s, n, b, k, seed, dev):
  """Made on the CPU with numpy: unit rows, a zero Hessian EMA, the n x n
  Gram's top eigenvector and k batches of b mixtures of the rows (12.8
  active a patch on average, N(0, 0.05^2) amplitudes, N(0, 0.003^2)
  noise, as bigdict_mixtures), moved to the card."""
  rng = np.random.RandomState(seed)
  d = unit_rows(rng, s, n)
  v = np.linalg.eigh(d.astype(np.float64).T @ d)[1][:, -1]
  amps = (rng.rand(k * b, s) < 12.8 / s) * rng.randn(k * b, s) * 0.05
  x = (amps @ d + 0.003 * rng.randn(k * b, n)).reshape(k, b, n)
  return [torch.tensor(a.astype(np.float32), device=dev)
          for a in (d, np.zeros(s), v, x)]


def cs_launch_args(K19, s, groups=None, penalty=0.0, **flags):
  """(table, window, comem, flags) of K19's _launch for a partition of
  range(s) into groups (None: fc) and the flags over its defaults."""
  table = window = comem = None
  if groups is not None:
    arrays = K19.code_shard_group_arrays(groups, s, 1)
    table, window = K19.group_members(arrays[0][0])
    if penalty:
      comem = arrays[1][0]
  kw = dict(variant="fista", update_alg="sc_cheap_quadratic_descent",
            upd_num_iters=1, nonneg=False, hard=False, renormalize=True,
            power_iters=2, lowest_code_val=0.001, alignment_penalty=penalty)
  kw.update(flags)
  return table, window, comem, kw


def cs_routes(torch, K19, d, h, v, x, grid=0, **case):
  """{route: (D, h, v, codes, eta)}: both routes, forced, on the same
  inputs; grid sets the persistent launch's CTAs."""
  table, window, comem, kw = cs_launch_args(K19, d.shape[0], **case)
  out = {}
  for route in ("steps", "persistent"):
    out[route] = K19._launch(d, h, v, x, table, window, comem, None, LAM,
                             TRAIN_ITERS, BIG_STEP, route=route,
                             grid=grid if route == "persistent" else 0, **kw)
    torch.cuda.synchronize()
    check(K19.last_route == route, "asked for the %s route, took %s" % (
        route, K19.last_route))
  return out


def cs_persistent_bitwise_cases(torch, K19, lib, dev):
  """Phase 41 (a): the persistent and the per-step routes of K19 give
  bitwise the same D, h, v, codes and stepsize; (b) the library's layout
  and grid are ops/fused_code_shard_train's, and a grid the card cannot
  hold at once is refused.  Returns the number of equal cases."""
  sm, bps = lib.vtc_code_shard_sm_count(), lib.vtc_code_shard_blocks_per_sm()
  check(sm == torch.cuda.get_device_properties(dev).multi_processor_count,
        "the library reads %d SMs" % sm)
  layout = ctypes_ints(6)
  lib.vtc_code_shard_layout(layout)
  check(tuple(layout) == (K19.SOLVE_TILE_M, K19.SOLVE_TILE_N,
                          K19.SOLVE_DEPTH, K19.SOLVE_SLICE,
                          K19.SOLVE_THREADS, K19.SPLIT_K),
        "fused_code_shard_train's layout constants differ from the "
        "library's: %s" % (tuple(layout),))
  for b, s, n in ((128, 2048, 256), (128, 512, 256), (13, 96, 24),
                  (77, 600, 200), (250, 2048, 256), (128, 2048, 512)):
    plan = K19.solve_plan(b, s, n, sm, bps)
    got = lib.vtc_code_shard_grid(b, s, n)
    print("solve kernel at b %3d s %4d n %3d: grid %3d CTAs (%d SMs x %d "
          "CTAs an SM; tiles of phase A %d, of phase B %d; D slices "
          "resident: A %s, B %s)" % (b, s, n, got, sm, bps,
                                     plan["tiles"]["A"], plan["tiles"]["B"],
                                     plan["resident"]["A"],
                                     plan["resident"]["B"]))
    check(got == plan["grid"], "the library's grid %d, solve_plan's %d" % (
        got, plan["grid"]))
    for members in (0, 1):
      check(lib.vtc_code_shard_barriers(TRAIN_ITERS, members, 1)
            == K19.solve_barriers(TRAIN_ITERS, members, True),
            "the library's barriers a step differ from solve_barriers")
  sub_cq = "subspace_sc_cheap_quadratic_descent"
  steep = "subspace_sc_steepest_descent"
  small = BIG_SMALL_S
  cases = [
      # label, (s, n, b, steps), case, grid (0: the shape's own)
      ("bench fc, 1 step", (BIG_S, 256, BIG_B, 1), {}, 0),
      ("bench fc, 20 steps", (BIG_S, 256, BIG_B, 20), {}, 0),
      ("bench 512x4 groups", (BIG_S, 256, BIG_B, 2),
       dict(groups=contiguous_groups(BIG_S, 4), update_alg=sub_cq), 0),
      ("s512 window 8", (small, 256, BIG_B, 2),
       dict(groups=contiguous_groups(small, 8), update_alg=sub_cq), 0),
      ("s512 window 16", (small, 256, BIG_B, 2),
       dict(groups=contiguous_groups(small, 16), update_alg=sub_cq), 0),
      ("s512 window 32 hard", (small, 256, BIG_B, 2),
       dict(groups=contiguous_groups(small, 32), hard=True,
            update_alg=steep), 0),
      ("s512 ragged 1-6 steepest upd 2", (small, 256, BIG_B, 2),
       dict(groups=ragged_partition(small, 23), upd_num_iters=2,
            update_alg=steep), 0),
      ("s512 4s penalty 0.15", (small, 256, BIG_B, 2),
       dict(groups=contiguous_groups(small, 4), penalty=0.15,
            update_alg=sub_cq), 0),
      ("s96 n24 b13 ista hard nonneg upd 2", (96, 24, 13, 2),
       dict(variant="ista", hard=True, nonneg=True, upd_num_iters=2,
            update_alg="sc_steepest_descent"), 0),
      ("b77 s600 n200", (600, 200, 77, 2), {}, 0),
      ("b19 s250 n37 (single-float copies)", (250, 37, 19, 2), {}, 0),
      ("bench fc upd 2", (BIG_S, 256, BIG_B, 2), dict(upd_num_iters=2), 0),
      ("b77 s600 n200 on 1 CTA", (600, 200, 77, 2), {}, 1),
      ("bench fc on 7 CTAs", (BIG_S, 256, BIG_B, 2), {}, 7),
      ("bench 512x4 on 132 CTAs", (BIG_S, 256, BIG_B, 2),
       dict(groups=contiguous_groups(BIG_S, 4), update_alg=sub_cq), 132),
  ]
  equal = 0
  for seed, (label, (s, n, b, k), case, grid) in enumerate(cases):
    d, h, v, x = cs_cpu_problem(torch, s, n, b, k, 410 + seed, dev)
    out = cs_routes(torch, K19, d, h, v, x, grid=grid, **case)
    got, want = out["persistent"], out["steps"]
    same = [bits_equal(torch, g, w) for g, w in zip(got, want)]
    check(all(same), "%s: D, h, v, codes, eta bitwise equal %s; max|dD| "
          "%.3e" % (label, same, float((got[0] - want[0]).abs().max())))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          label + ": non-finite state")
    equal += 1
    print("phase 41 (a) %-36s both routes: D, h, v, codes and eta bitwise "
          "equal; codes max %.4g" % (label, float(got[3].abs().max())))
  # a grid the card cannot hold at once: the launch is refused and raises
  d, h, v, x = cs_cpu_problem(torch, BIG_S, 256, BIG_B, 1, 7, dev)
  before, solves = K19.launches, K19.solve_launches
  try:
    cs_routes(torch, K19, d, h, v, x, grid=sm * bps + 1)
    refused = False
  except RuntimeError as e:
    refused = "CUDA error" in str(e)
  torch.cuda.synchronize()
  print("forced persistent launch of %d CTAs (%d fit at once): %s" % (
      sm * bps + 1, sm * bps, "refused" if refused else "LAUNCHED"))
  check(refused and K19.solve_launches == solves
        and K19.launches == before + 1,
        "a cooperative launch the card cannot hold must raise, uncounted")
  return equal


def cs_dispatch(torch, fn):
  """{'solve': n, 'steps': n, 'solve_ms': ms}: launches of
  code_shard_solve_kernel and of the per-step route's solve kernels in
  one call of fn, and the solve kernel's device time per launch, from
  torch.profiler's device events."""
  out = {"solve": 0, "steps": 0}
  us = 0.0
  for e in device_events(torch, fn):
    if "code_shard_solve_kernel" in e.name:
      out["solve"] += 1
      us += e.time_range.elapsed_us()
    elif any("(anonymous namespace)::" + k in e.name
             for k in CS_STEP_KERNELS):
      out["steps"] += 1
  out["solve_ms"] = us / 1e3 / max(out["solve"], 1)
  return out


def cs_solve_bound(b, s, n, iters, upd_iters=1):
  """The solve kernel, one launch: per FISTA iteration z D and (z D - X)
  D^T, 2 b s n FLOPs each, and the update's first residual codes D;
  reading D and X, writing the codes and the residual."""
  flops = 4.0 * b * s * n * iters + (2.0 * b * s * n if upd_iters else 0.0)
  return bound(flops, 4.0 * (s * n + 2 * b * n + b * s))


def ctypes_ints(count):
  import ctypes
  return (ctypes.c_int * count)()


def ica_dispatch(torch, fn):
  """{'segment': n, 'steps': n}: launches of ica_segment_kernel and of the
  per-step route's kernels in one call of fn, from torch.profiler's device
  events."""
  out = {"segment": 0, "steps": 0}
  for e in device_events(torch, fn):
    if "ica_segment_kernel" in e.name:
      out["segment"] += 1
    elif any("(anonymous namespace)::" + k in e.name
             for k in ICA_STEP_KERNELS):
      out["steps"] += 1
  return out


# ---------------------------------------------------------------------------
# phase 45: the early stop of the data-parallel fc and subspace segments
# (K15, K16) and of the big-dictionary segment (K19), one rank and across
# ranks
# ---------------------------------------------------------------------------
STOP_DP_STEPS = 10        # the world-of-2 runs and the timed segments
STOP_MAIN_STEPS = 20      # each main-path run with the stop
STOP_CS_STEPS = 3         # K19's stopped segments (both routes, the ranks)
STOP_CS_TIME_STEPS = 20   # K19's timed segments
STOP_COST_ROUNDS = 4      # rounds of six K19 readings (off, 0, mid, mid, 0, off)
STOP_TRAIN_REPEAT = 5     # the timed DP trainer runs STOP_MAIN_STEPS x this
STOP_CHILD_TIMEOUT = 600  # seconds a rank of phase 45 may take
# the worlds of phase 45: 2 processes (K15 and K16 on a 'data' axis of 2,
# K19 on a 'code' axis of 2) and 4 (K19 on data 2 x code 2)
STOP_MESHES = {2: dict(data=1, code=2), 4: dict(data=2, code=2)}


def dp_stop_inputs(torch, lipschitz, dev):
  """Phase 45's flagship data-parallel rows (bench.py:796-827: b 250,
  s = n = 256, FISTA 25, cheap-quadratic, 64 groups of 4): phase 5's
  dictionary, a zero Hessian EMA, its exact eigenvector seed (Dg = D for
  the contiguous groups) and STOP_MAIN_STEPS batches of fc and of
  group-sparse patches, on the card."""
  d = torch.tensor(unit_rows(np.random.RandomState(2), 256, 256), device=dev)
  num, shape = STOP_MAIN_STEPS * TRAIN_BATCH, (STOP_MAIN_STEPS, TRAIN_BATCH,
                                              256)
  fc = torch.tensor(synthetic_patches(num, seed=45).reshape(shape),
                    device=dev)
  gx = torch.tensor(group_patches(num, seed=46).reshape(shape), device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  return d, torch.zeros(256, device=dev), v, fc, gx


def dp_stop_families(K15, K16, mesh):
  """(label, module, segment, plain, batches' index, stepsize, flags) of K15
  and K16 at the flagship rows on ``mesh``."""
  kw = dict(mesh=mesh, power_iters=2)
  return (("K15", K15, K15.fused_dp_train_segment, K15.fused_dp_train_plain,
           0, TRAIN_STEP, kw),
          ("K16", K16, K16.fused_group_dp_train_segment,
           K16.fused_group_dp_train_plain, 1, SUB_STEP,
           dict(kw, group_assignments=contiguous_groups(256, GROUP_SIZE))))


def dp_stop_cases(torch, K15, K16, mesh1, inputs):
  """Phase 45 (a): one flagship K15 and K16 step at a world of 1 for each
  of two batches with an eps that stops at k = 1, one picked from the
  plain version's means to stop mid-run, and 0 (never): every output
  bitwise the same kernel's without the stop run to the count it reports,
  the count the fp32 plain version's and every output within phase 2's
  limit of it (conv_stop_case); then a STOP_DP_STEPS-step segment at the
  mid eps, its count every step the plain version's and every output
  within the limit.  Returns ({label: mid eps}, {label: largest error},
  near cases, stopped steps checked)."""
  d, h, v = inputs[:3]
  eps_mid, errs, near, cases = {}, {}, [], 0
  for label, mod, seg, plain, which_x, step, kw in dp_stop_families(
      K15, K16, mesh1):
    x = inputs[3 + which_x]
    plain(d, h, v, x[:1], LAM, TRAIN_ITERS, step, early_stopping_epsilon=0.0,
          **kw)
    avgs = solver_state()[1]
    eps_mid[label] = stop_eps(avgs, "mid")
    worst, counts = 0.0, []
    for i in range(2):
      xi = x[i:i + 1].contiguous()
      for which in ("early", "mid", "never"):
        it, err = conv_stop_case(
            torch, "%s flagship step, batch %d" % (label, i), mod,
            lambda eps, iters, xi=xi: seg(
                d, h, v, xi, LAM, TRAIN_ITERS if iters is None else iters,
                step, early_stopping_epsilon=eps, **kw),
            lambda eps, xi=xi: plain(d, h, v, xi, LAM, TRAIN_ITERS, step,
                                     early_stopping_epsilon=eps, **kw),
            which, stop_eps(avgs, which), SEG_NAMES, near)
        worst = max(worst, err)
        counts.append(it)
        cases += 1
    xs = x[:STOP_DP_STEPS].contiguous()
    got = seg(d, h, v, xs, LAM, TRAIN_ITERS, step,
              early_stopping_epsilon=eps_mid[label], **kw)
    its = mod.last_iters.tolist()
    want = plain(d, h, v, xs, LAM, TRAIN_ITERS, step,
                 early_stopping_epsilon=eps_mid[label], **kw)
    check(its == mod.plain_iters, "%s, a %d-step segment at eps %.4g: the "
          "kernel's counts %s, the plain version's %s" % (
              label, STOP_DP_STEPS, eps_mid[label], its, mod.plain_iters))
    for what, g, w in zip(SEG_NAMES, got, want):
      err = float((g - w).abs().max())
      lim = limit(w) if float(w.abs().max()) > 0 else TOL
      check(bool(torch.isfinite(g).all()) and err <= lim,
            "%s, the %d-step segment: %s differs from plain by %.3e, limit "
            "%.3e" % (label, STOP_DP_STEPS, what, err, lim))
      worst = max(worst, err)
    errs[label] = worst
    print("stop, %s one flagship step at a world of 1, two batches, counts "
          "(k 1, mid, never) %s of %d, every output bitwise the kernel "
          "without the stop at the count; a %d-step segment at eps %.4g: "
          "counts %s, the plain version's; max|d| from plain %.3e" % (
              label, counts, TRAIN_ITERS, STOP_DP_STEPS, eps_mid[label], its,
              worst))
  return eps_mid, errs, near, cases


def cs_stop_variants():
  """Phase 45's K19 cases: (name, s, groups), bench's fc and 512 x 4 (the
  in-warp window prox) and a ragged partition of s 512 into groups of 1 to
  6 rows none across a half (the member table; two row shards)."""
  return (("bench fc", BIG_S, None),
          ("bench 512x4", BIG_S, contiguous_groups(BIG_S, 4)),
          ("s512 ragged 1-6", BIG_SMALL_S,
           ragged_in_shards(BIG_SMALL_S, 2, 45)))


def cs_stop_count(b, s, groups):
  """vtc_tpu's stop count (compiled_epoch.py:1116-1123): the batch times the
  grouped codes' G * M, or the rows."""
  return b * (s if groups is None else len(groups) * max(map(len, groups)))


def cs_stop_flags(s, groups):
  """The update rule of a K19 case: cheap-quadratic, the subspace name for
  groups."""
  return dict(update_alg="subspace_sc_cheap_quadratic_descent"
              if groups is not None else "sc_cheap_quadratic_descent")


def cs_stop_cases(torch, K19, dev):
  """Phase 45 (c): K19 at one rank with the stop, each case of
  cs_stop_variants, one step at three eps (k = 1, mid-run from the plain
  version's means, 0): the persistent and the per-step route (forced)
  bitwise equal at the same count; the persistent route bitwise its build
  without the stop run to the count; the count the fp32 plain version's
  and every output within phase 2's limit of it (near cases apart).  Then
  a STOP_CS_STEPS-step segment at the mid eps: both routes bitwise equal
  with the same counts every step, the plain version's.  Returns
  ({name: mid eps}, the largest error, near cases, cases)."""
  eps_mid, worst, near, cases = {}, 0.0, [], 0
  for seed, (name, s, groups) in enumerate(cs_stop_variants()):
    d, h, v, x = cs_cpu_problem(torch, s, 256, BIG_B, STOP_CS_STEPS,
                                450 + seed, dev)
    count = cs_stop_count(BIG_B, s, groups)
    table, window, comem, kw = cs_launch_args(K19, s, groups,
                                              **cs_stop_flags(s, groups))
    expand = (None if groups is None
              else K19.code_shard_group_arrays(groups, s, 1)[0][0])

    def launch(xb, iters, eps, route):
      out = K19._launch(d, h, v, xb, table, window, comem, None, LAM, iters,
                        BIG_STEP, route=route, eps=eps, stop_count=count,
                        **kw)
      its = None if eps is None else K19.last_iters.tolist()
      return out, its

    def plain(xb, eps):
      return K19.fused_code_sharded_train_segment_plain(
          d, h, v, xb, LAM, TRAIN_ITERS, BIG_STEP, expand_local=expand,
          early_stopping_epsilon=eps, stop_count=count, return_stepsize=True,
          **cs_stop_flags(s, groups), power_iters=2)

    plain(x[:1], 0.0)
    avgs = list(K19.plain_avgs)
    eps_mid[name] = stop_eps(avgs, "mid")
    counts = []
    for which in ("early", "mid", "never"):
      eps = stop_eps(avgs, which)
      label = "K19 %s, one step, eps %s (%.4g)" % (name, which, eps)
      got, its = launch(x[:1], TRAIN_ITERS, eps, "persistent")
      steps, steps_its = launch(x[:1], TRAIN_ITERS, eps, "steps")
      it = its[0]
      ref, _ = launch(x[:1], it, None, "persistent")
      want = plain(x[:1], eps)
      torch.cuda.synchronize()
      check(steps_its == its, "%s: the per-step route ran %s iterations, "
            "the persistent route %s" % (label, steps_its, its))
      for what, g, a, r in zip(CS_NAMES, got, steps, ref):
        check(bits_equal(torch, g, a), "%s: the routes' %s differ" % (
            label, what))
        check(bits_equal(torch, g, r), "%s: the stopped %s differs from the "
              "kernel's without the stop at %d iterations" % (
                  label, what, it))
      counts.append(it)
      cases += 1
      if eps > 0 and any(abs(a - eps) <= 1e-5 * eps for a in K19.plain_avgs):
        near.append("%s: kernel %d it, plain %d" % (label, it,
                                                     K19.plain_iters[0]))
        continue
      check(it == K19.plain_iters[0], "%s: the kernel ran %d iterations, the "
            "plain version %d" % (label, it, K19.plain_iters[0]))
      for what, g, w in zip(CS_NAMES, got, want):
        err = float((g - w).abs().max())
        lim = limit(w) if float(w.abs().max()) > 0 else TOL
        check(bool(torch.isfinite(g).all()) and err <= lim,
              "%s: %s differs from plain by %.3e, limit %.3e" % (
                  label, what, err, lim))
        worst = max(worst, err)
    got, its = launch(x, TRAIN_ITERS, eps_mid[name], "persistent")
    steps, steps_its = launch(x, TRAIN_ITERS, eps_mid[name], "steps")
    plain(x, eps_mid[name])
    torch.cuda.synchronize()
    check(its == steps_its == K19.plain_iters and all(
        bits_equal(torch, g, a) for g, a in zip(got, steps)),
          "K19 %s, a %d-step segment at eps %.4g: the routes' counts %s and "
          "%s (plain %s) or state differ" % (
              name, STOP_CS_STEPS, eps_mid[name], its, steps_its,
              K19.plain_iters))
    print("stop, K19 %-16s one step, counts (k 1, mid, never) %s of %d: "
          "both routes bitwise equal, bitwise the kernel without the stop at "
          "the count; a %d-step segment at eps %.4g: counts %s on both "
          "routes and in plain, the routes bitwise equal" % (
              name, counts, TRAIN_ITERS, STOP_CS_STEPS, eps_mid[name], its))
  return eps_mid, worst, near, cases


def stop_rank_main(rank, world, workdir):
  """The hidden sub-command: one rank of phase 45 at a world of 2 or 4.
  Joins the gloo group over the file store in ``workdir``; at a world of 2
  runs the scanned fc and subspace trainers with data_parallel=True (a
  'data' axis of 2: K15 and K16 on shards of 125) with the stop for
  STOP_DP_STEPS steps; at both worlds runs K19 with the stop on
  STOP_MESHES[world] for each case of cs_stop_variants, STOP_CS_STEPS
  steps, and its fp32 plain version with the same stop on the same mesh;
  and saves the replicated or gathered state, the counts and the launches
  to ``workdir``."""
  import os
  import torch
  import torch.distributed as dist
  from vtc_tpu_torch import convert, parallel
  from vtc_tpu_torch.ops import fused_code_shard_train as K19
  from vtc_tpu_torch.ops import fused_dp_train as K15
  from vtc_tpu_torch.ops import fused_group_dp_train as K16
  from vtc_tpu_torch.training import compiled_epoch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  dev = torch.device("cuda", 0)
  data = dict(np.load(os.path.join(workdir, "inputs.npz")))
  dist.init_process_group("gloo", init_method="file://" + os.path.join(
      workdir, "store"), rank=rank, world_size=world)
  try:
    out = {}
    if world == 2:
      for label, mod, params, key in (
          ("K15", K15, train_params(STOP_DP_STEPS), "fc"),
          ("K16", K16, subspace_train_params(STOP_DP_STEPS, SUB_STEP), "g")):
        x = data[key][:STOP_DP_STEPS]
        mod.launches = 0
        got = compiled_epoch.train_dictionary_scanned(
            x, x[:1], data["d"], dict(
                params, data_parallel=True,
                early_stopping_epsilon=float(data["eps " + label])),
            device=dev)
        torch.cuda.synchronize()
        out[label + " dictionary"] = got.cpu().numpy()
        out[label + " counts"] = mod.last_iters.cpu().numpy()
        out[label + " launches"] = np.array(mod.launches)
    mesh = parallel.make_mesh(**STOP_MESHES[world])
    code, size = mesh.code_size, mesh.size
    for name, s, groups in cs_stop_variants():
      d, x, v = (data["cs %s %s" % (name, key)] for key in ("d", "x", "v"))
      state = convert.code_shard_state_from_numpy(
          d, np.zeros(s, np.float32), v, mesh, dev, group_assignments=groups)
      state.pop("comem_local", None)
      args = (state.pop("dict_shard"), state.pop("hessian_shard"),
              state.pop("eigvec"),
              torch.tensor(mesh.shard(x, dim=1), device=dev), LAM,
              TRAIN_ITERS, BIG_STEP)
      kw = dict(mesh=mesh, power_iters=2, return_stepsize=True,
                early_stopping_epsilon=float(data["cs %s eps" % name]),
                stop_count=cs_stop_count(BIG_B, s, groups),
                **cs_stop_flags(s, groups), **state)
      K19.launches = 0
      got = K19.fused_code_sharded_train_segment(
          *args, axis_size=code, data_axis_size=size,
          data_stride=code if size > 1 else 0, **kw)
      torch.cuda.synchronize()
      check(K19.launches == STOP_CS_STEPS and K19.last_route == "steps",
            "%s: K19 with the stop across ranks counted %d steps on the %s "
            "route" % (name, K19.launches, K19.last_route))
      for what, a in zip(CS_NAMES, cs_gathered(mesh, got)):
        out["cs %s %s" % (name, what)] = a
      out["cs %s counts" % name] = K19.last_iters.cpu().numpy()
      want = K19.fused_code_sharded_train_segment_plain(*args, **kw)
      for what, a in zip(CS_NAMES, cs_gathered(mesh, want)):
        out["cs %s plain %s" % (name, what)] = a
      out["cs %s plain counts" % name] = np.array(K19.plain_iters)
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **out)
  finally:
    dist.destroy_process_group()
  return 0


def stop_across_ranks(torch, K19, inputs, eps_dp, eps_cs, dev, mesh1, K15,
                      K16):
  """Phase 45 (b) and (c) across ranks: processes of this script sharing
  the card over gloo (spawn_ranks, phase 37's launcher), 2 then 4.  K15
  and K16 at a world of 2 through the scanned trainers with the stop: both
  ranks bitwise the same dictionary with the same counts every step, each
  a K15 or K16 step, within the rounding floor of the world-of-1 segment
  with its counts every step.  K19 with the stop at (data 1, code 2) and
  (2, 2) for each case of cs_stop_variants: every rank bitwise the same
  replicated state and counts; the counts every step those of the fp32
  plain version with the same stop on the same mesh and of K19 at one
  rank, and every gathered output within phase 2's limit of that plain
  version's and of K19's at one rank.  Returns the seconds it took."""
  import os
  import tempfile
  d, h, v, fc, gx = inputs
  data = {"d": d.cpu().numpy(), "fc": fc.cpu().numpy(),
          "g": gx.cpu().numpy(), "eps K15": np.array(eps_dp["K15"]),
          "eps K16": np.array(eps_dp["K16"])}
  one = {}
  for seed, (name, s, groups) in enumerate(cs_stop_variants()):
    cd, ch, cv, cx = cs_cpu_problem(torch, s, 256, BIG_B, STOP_CS_STEPS,
                                    460 + seed, dev)
    for key, t in (("d", cd), ("x", cx), ("v", cv)):
      data["cs %s %s" % (name, key)] = t.cpu().numpy()
    data["cs %s eps" % name] = np.array(eps_cs[name])
    kw = dict(cs_stop_flags(s, groups), power_iters=2, return_stepsize=True)
    if groups is not None:
      kw["expand_local"] = K19.code_shard_group_arrays(groups, s, 1)[0][0]
    got = K19.fused_code_sharded_train_segment(
        cd, ch, cv, cx, LAM, TRAIN_ITERS, BIG_STEP,
        early_stopping_epsilon=eps_cs[name],
        stop_count=cs_stop_count(BIG_B, s, groups), **kw)
    one[name] = ([t.cpu().numpy() for t in got], K19.last_iters.tolist())
  t0 = time.perf_counter()
  results = {}
  with tempfile.TemporaryDirectory() as workdir:
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    for world in (2, 4):
      sub = os.path.join(workdir, "world%d" % world)
      os.mkdir(sub)
      os.link(os.path.join(workdir, "inputs.npz"),
              os.path.join(sub, "inputs.npz"))
      codes, dt = spawn_ranks("--stop-rank", world, sub, STOP_CHILD_TIMEOUT)
      check(codes == [0] * world, "a rank of phase 45's world of %d failed: "
            "exit codes %s" % (world, codes))
      results[world] = [dict(np.load(os.path.join(sub, "rank%d.npz" % r)))
                        for r in range(world)]
      print("phase 45: %d processes sharing one card over gloo done in "
            "%.1f s" % (world, dt))
  ranks = results[2]
  for label, mod, seg, _, which_x, step, kw in dp_stop_families(K15, K16,
                                                                mesh1):
    counts = [out[label + " counts"].tolist() for out in ranks]
    check(all(np.array_equal(out[label + " dictionary"],
                             ranks[0][label + " dictionary"])
              for out in ranks) and counts[0] == counts[1]
          and len(counts[0]) == STOP_DP_STEPS,
          "%s with the stop at a world of 2: the ranks differ (counts %s)" % (
              label, counts))
    check(all(int(out[label + " launches"]) == STOP_DP_STEPS
              for out in ranks), "%s at a world of 2 launched %s steps" % (
                  label, [int(out[label + " launches"]) for out in ranks]))
    single = seg(d, h, v, inputs[3 + which_x][:STOP_DP_STEPS].contiguous(),
                 LAM, TRAIN_ITERS, step, early_stopping_epsilon=eps_dp[label],
                 **kw)[0]
    single_its = mod.last_iters.tolist()
    err = float(np.abs(ranks[0][label + " dictionary"]
                       - single.cpu().numpy()).max())
    print("world of 2  %s with the stop (eps %.4g, the classic route, one "
          "share sum over the ranks an iteration): ranks bitwise equal, the "
          "same counts every step %s; the world-of-1 segment's counts %s, "
          "max|d| %.3e from it (rounding floor %.3e)" % (
              label, eps_dp[label], counts[0], single_its, err, DP_FLOOR))
    check(counts[0] == single_its, "%s at a world of 2 ran %s iterations, "
          "the world-of-1 segment %s" % (label, counts[0], single_its))
    check(np.isfinite(ranks[0][label + " dictionary"]).all()
          and err <= DP_FLOOR, "%s at a world of 2 differs from a world of "
          "1 by %.3e" % (label, err))
    check(min(counts[0]) < TRAIN_ITERS, "%s: no solve stopped early at a "
          "world of 2: %s" % (label, counts[0]))
  for world, ranks in results.items():
    for name, s, groups in cs_stop_variants():
      counts = [out["cs %s counts" % name].tolist() for out in ranks]
      for what in CS_NAMES:
        check(all(np.array_equal(out["cs %s %s" % (name, what)],
                                 ranks[0]["cs %s %s" % (name, what)])
                  for out in ranks), "K19 %s at %s with the stop: the %s "
              "differs between the ranks" % (name, STOP_MESHES[world], what))
      check(all(c == counts[0] for c in counts), "K19 %s at %s: the ranks' "
            "counts %s" % (name, STOP_MESHES[world], counts))
      label = "K19 %s at %s with the stop" % (name, STOP_MESHES[world])
      one_out, one_its = one[name]
      plain_its = ranks[0]["cs %s plain counts" % name].tolist()
      check(counts[0] == plain_its == one_its, "%s: the ranks ran %s "
            "iterations, the plain version on the mesh %s, K19 at one rank "
            "%s" % (label, counts[0], plain_its, one_its))
      errs = {}
      for what, w_one in zip(CS_NAMES, one_out):
        g = ranks[0]["cs %s %s" % (name, what)]
        w = ranks[0]["cs %s plain %s" % (name, what)]
        lim = limit(w) if float(np.abs(w).max()) > 0 else TOL
        errs[what] = (float(np.abs(g - w).max()),
                      float(np.abs(g - w_one).max()), lim)
        check(np.isfinite(g).all() and max(errs[what][:2]) <= lim,
              "%s: %s differs from the plain version on the mesh by %.3e "
              "and from K19 at one rank by %.3e, limit %.3e" % (
                  label, what, *errs[what]))
      print("%s (eps %.4g): ranks bitwise equal, the same counts every step "
            "%s, the plain version's on the mesh and K19's at one rank; "
            "max|d| from plain / from one rank (limit): %s" % (
                label, eps_cs[name], counts[0], ", ".join(
                    "%s %.3e / %.3e (%.3e)" % (what, *e)
                    for what, e in errs.items())))
  return time.perf_counter() - t0



def stop_segments_phase(torch, dev, card, K15, K16, K19, mesh1,
                        compiled_epoch, lipschitz):
  """Phase 45, whole (see the module docstring).  Returns what the kernels
  line takes: ({module: launches on the main path}, {'K15', 'K16': the
  largest error against plain}, K19's, {'K15', 'K16', 'K19': (ms a step,
  the plain version's, iterations a step)})."""
  # the early stop of K15, K16 and K19 (csrc/fista_core.cuh's
  # classic route across ranks, csrc/code_shard_solve.cuh's STOP build and
  # csrc/fused_code_shard_train_step.cu's per-step stop): K15 and K16 at a
  # world of 1 against the same kernel without the stop and against plain;
  # K19's two routes; the worlds of 2 and 4; the main path with the stop
  # (counted); the stop's cost an iteration on K19's persistent route; the
  # stopped K19 against K19 without it; the data-parallel fc trainer with
  # the stop against fc_formulation='gram'
  t45 = time.perf_counter()
  stop_in = dp_stop_inputs(torch, lipschitz, dev)
  sd, sh, sv, sfc, sgx = stop_in
  eps_dp, dpstop_err, dpstop_near, n_dpstop = dp_stop_cases(
      torch, K15, K16, mesh1, stop_in)
  eps_cs, csstop_err, csstop_near, n_csstop = cs_stop_cases(torch, K19, dev)
  near45 = dpstop_near + csstop_near
  print("phase 45: %d stopped K15/K16 steps and %d stopped K19 steps bitwise "
        "the kernel without the stop at the count, at the plain version's "
        "count; within %.3e of plain; %d with a plain mean within 1e-5 "
        "relative of eps%s" % (
            n_dpstop, n_csstop, max(max(dpstop_err.values()), csstop_err),
            len(near45), "".join("\n  near eps: " + c for c in near45)))
  ranks45_s = stop_across_ranks(torch, K19, stop_in, eps_dp, eps_cs, dev,
                                mesh1, K15, K16)
  # the main path with the stop, every count zeroed just before and read
  # just after: the scanned fc and subspace trainers with data_parallel=True
  # at a world of 1 (K15, K16) and _code_shard_segment_runner at a code
  # axis of 1, fc and 512 x 4 (K19, persistent route)
  cs_x = {}
  for name, s, groups in cs_stop_variants()[:2]:
    cs_x[name] = cs_cpu_problem(torch, s, 256, BIG_B, STOP_CS_TIME_STEPS,
                                470 + len(cs_x), dev)
  for mod in (K15, K16, K19):
    mod.launches = 0
  K19.solve_launches = 0
  compiled_epoch.train_dictionary_scanned(
      sfc, sfc[:1], sd, dict(train_params(STOP_MAIN_STEPS),
                             data_parallel=True,
                             early_stopping_epsilon=eps_dp["K15"]))
  compiled_epoch.train_dictionary_scanned(
      sgx, sgx[:1], sd, dict(subspace_train_params(STOP_MAIN_STEPS,
                                                   SUB_STEP),
                             data_parallel=True,
                             early_stopping_epsilon=eps_dp["K16"]))
  for name, s, groups in cs_stop_variants()[:2]:
    cd, ch, cv, cx = cs_x[name]
    compiled_epoch._code_shard_segment_runner(
        None, 1, 1, "fista", cs_stop_flags(s, groups)["update_alg"], 1,
        False, False, True, group_arrays=(
            None if groups is None
            else K19.code_shard_group_arrays(groups, s, 1)),
        early_eps=eps_cs[name], stop_count=cs_stop_count(BIG_B, s, groups))(
            cd, ch, cv, cx, LAM, TRAIN_ITERS, BIG_STEP)
  torch.cuda.synchronize()
  dpstop_launches = {mod: mod.launches for mod in (K15, K16, K19)}
  print("phase 45 main path with the stop: K15 %d, K16 %d, K19 %d launches "
        "(%d of the persistent solve)" % (
            *dpstop_launches.values(), K19.solve_launches))
  check(tuple(dpstop_launches.values()) == (
      STOP_MAIN_STEPS, STOP_MAIN_STEPS, 2 * STOP_CS_TIME_STEPS)
        and K19.solve_launches == 2 * STOP_CS_TIME_STEPS,
        "the main path with the stop launched %s" % (
            tuple(dpstop_launches.values()),))
  # µs an iteration of the stop on K19's persistent route: a segment at eps
  # 0 (never stops, so every iteration from 1 to the last but one does the
  # stop's work) against the build without it, STOP_COST_ROUNDS rounds of
  # (off, 0, mid, mid, 0, off), the i-th reading at eps 0 paired with the
  # i-th without the stop; then the stopped segment (mid eps) against the
  # build without the stop at 25 iterations
  cd, ch, cv, cx = cs_x["bench fc"]

  def k19_seg(eps):
    return K19.fused_code_sharded_train_segment(
        cd, ch, cv, cx, LAM, TRAIN_ITERS, BIG_STEP, power_iters=2,
        early_stopping_epsilon=eps)

  k19_times = {None: [], 0.0: [], eps_cs["bench fc"]: []}
  for eps in (None, 0.0, eps_cs["bench fc"]):
    k19_seg(eps)
  for eps in (None, 0.0, eps_cs["bench fc"], eps_cs["bench fc"], 0.0,
              None) * STOP_COST_ROUNDS:
    k19_times[eps].append(time_ms(torch, lambda: k19_seg(eps), 5)
                          / STOP_CS_TIME_STEPS)
  k19_seg(eps_cs["bench fc"])
  k19_mid_its = K19.last_iters.float().mean().item()
  off, on = np.median(k19_times[None]), np.median(k19_times[0.0])
  turns = TRAIN_ITERS - 2  # the iterations that test: 1 to 23 of 25
  pair_us = [1e3 * (a - b) / turns
             for a, b in zip(k19_times[0.0], k19_times[None])]
  k19_stop_us = float(np.median(pair_us))
  upper = float(np.percentile(pair_us, 75))
  verdict = ("met" if upper <= 1.0 else "missed" if k19_stop_us > 1.0
             else "not resolved (median within, upper quartile %.3f above)"
             % upper)
  print("K19 stop cost, persistent route, bench fc (b %d s %d n 256, FISTA "
        "%d), %d paired readings: median %.4f ms a step without the stop "
        "(runs %s), %.4f with it at eps 0 (never stops; runs %s); us an "
        "iteration that tests (%d of %d a step), each pair: %s; median %.3f, "
        "range %.3f to %.3f (target 1: %s) [%s]" % (
            BIG_B, BIG_S, TRAIN_ITERS, len(pair_us), off, ", ".join(
                "%.4f" % t for t in k19_times[None]), on, ", ".join(
                    "%.4f" % t for t in k19_times[0.0]), turns, TRAIN_ITERS,
            ", ".join("%.3f" % u for u in pair_us), k19_stop_us,
            min(pair_us), max(pair_us), verdict, card))
  k19_mid = float(np.median(k19_times[eps_cs["bench fc"]]))
  print("stopped K19 segment, bench fc, eps %.4g (%.1f of %d iterations a "
        "step): median %.4f ms a step (runs %s) against %.4f without the "
        "stop at %d iterations: %.2fx [%s]" % (
            eps_cs["bench fc"], k19_mid_its, TRAIN_ITERS, k19_mid, ", ".join(
                "%.4f" % t for t in k19_times[eps_cs["bench fc"]]), off,
            TRAIN_ITERS, off / k19_mid, card))
  # the data-parallel fc trainer with the mid eps (K15 with the stop)
  # against fc_formulation='gram' (the psum-per-op step, what a
  # data-parallel early-stopped run took before), whole calls of
  # STOP_MAIN_STEPS * STOP_TRAIN_REPEAT steps after one untimed call of
  # each, in turns (pallas, gram, gram, pallas) twice
  long_fc = sfc.repeat(STOP_TRAIN_REPEAT, 1, 1)
  train_steps = long_fc.shape[0]
  dp_gram_s = {"pallas": [], "gram": []}
  for form in ("pallas", "gram") + ("pallas", "gram", "gram", "pallas") * 2:
    params_ = dict(train_params(train_steps), data_parallel=True,
                   fc_formulation=form, early_stopping_epsilon=eps_dp["K15"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled_epoch.train_dictionary_scanned(long_fc, long_fc[:1], sd,
                                            params_)
    torch.cuda.synchronize()
    dp_gram_s[form].append(time.perf_counter() - t0)
  dp_gram_s = {f: t[1:] for f, t in dp_gram_s.items()}  # the warm calls
  dp_rate = {f: train_steps * TRAIN_BATCH / np.median(t)
             for f, t in dp_gram_s.items()}
  ratios = [g / p for p, g in zip(dp_gram_s["pallas"], dp_gram_s["gram"])]
  print("data-parallel fc trainer (a world of 1), %d steps of b %d, FISTA "
        "%d, eps %.4g: fc_formulation='pallas' (K15 with the stop) %.0f "
        "patches/s (median; runs %s s), 'gram' (the psum-per-op step) %.0f "
        "patches/s (runs %s s): %.2fx by the medians, turn by turn %s [%s]"
        % (train_steps, TRAIN_BATCH, TRAIN_ITERS, eps_dp["K15"],
           dp_rate["pallas"], ", ".join(
               "%.4f" % s for s in dp_gram_s["pallas"]), dp_rate["gram"],
           ", ".join("%.4f" % s for s in dp_gram_s["gram"]),
           dp_rate["pallas"] / dp_rate["gram"], ", ".join(
               "%.2fx" % r for r in ratios), card))
  # the stop rows of the kernels line: ms a step at this run's counts and
  # the plain version's with the same eps
  dpstop_times = {}
  for label, mod, seg, plain, which_x, step, kw in dp_stop_families(
      K15, K16, mesh1):
    xs = stop_in[3 + which_x][:STOP_DP_STEPS].contiguous()
    fn = lambda: seg(sd, sh, sv, xs, LAM, TRAIN_ITERS, step,
                     early_stopping_epsilon=eps_dp[label], **kw)
    plain_fn = lambda: plain(sd, sh, sv, xs[:2], LAM, TRAIN_ITERS, step,
                             early_stopping_epsilon=eps_dp[label], **kw)
    fn()
    its = mod.last_iters.float().mean().item()
    plain_fn()
    dpstop_times[label] = (time_ms(torch, fn, 3) / STOP_DP_STEPS,
                           time_ms(torch, plain_fn, 1) / 2, its)
  plain_k19 = lambda: K19.fused_code_sharded_train_segment_plain(
      cd, ch, cv, cx[:2], LAM, TRAIN_ITERS, BIG_STEP, power_iters=2,
      early_stopping_epsilon=eps_cs["bench fc"])
  plain_k19()
  dpstop_times["K19"] = (k19_mid, time_ms(torch, plain_k19, 1) / 2,
                         k19_mid_its)
  print("stop builds: K15 %.4f ms a step (plain %.4f) at %.1f of %d "
        "iterations a step, K16 %.4f (plain %.4f) at %.1f; K19 %.4f (plain "
        "%.4f) at %.1f [%s]" % (
            *dpstop_times["K15"], TRAIN_ITERS, *dpstop_times["K16"],
            *dpstop_times["K19"], card))
  del stop_in, sfc, sgx, cs_x, long_fc
  print("phase 45 took %.1f s (its ranks %.1f s)" % (
      time.perf_counter() - t45, ranks45_s))
  return dpstop_launches, dpstop_err, csstop_err, dpstop_times


# ---------------------------------------------------------------------------
# phase 46: the precision tiers of K1, K4, K2 and K6 (csrc/fista_tier.cuh)
# ---------------------------------------------------------------------------
TIER_NAMES = ("bf16", "bf16x3", "bf16x5")
TIER_PASSES = {"bf16": 1, "bf16x3": 3, "bf16x5": 5}  # bf16 products a term
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core rate, FLOP/s
# a full solve's bound: the larger of this floor (times the largest value)
# and the plain version's own spread under five one-ulp nudges of its
# input (tests/test_torch_port_tiers.py's rule)
TIER_FLOOR = {"bf16": 2e-3, "bf16x3": 2e-5, "bf16x5": 1e-5}
TIER_CONTROL = 5.0
TIER_TRAIN_TOL = 0.10     # bf16x3's held-out loss within 10% of 'highest'
TIER_TIME_STEPS = 20      # the steps of each timed K2 / K6 segment
TIER_REPS = 10            # calls of each timed turn
TIER_LIB_TURNS = 7        # turns of each library time (median and range)


def tier_solve_bound(b, s, iters, tier):
  """K1 / K4 at a tier: the passes' products at the bf16 tensor-core rate,
  reading G and c and writing the codes."""
  flops = 2.0 * b * s * s * iters * TIER_PASSES[tier]
  t_ops, t_bytes = flops / BF16_PEAK, 4.0 * (s * s + 2 * b * s) / HBM_RATE
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def tier_step_bound(b, s, n, iters, tier, power_iters=2):
  """K2 / K6, one step at a tier: the solve's passes at the bf16 rate
  beside the fp32 products (G, c, the update, the refresh) at the fp32
  rate, the two units' least times overlapped; reading X and D, writing
  D."""
  solve = 2.0 * b * s * s * iters * TIER_PASSES[tier] / BF16_PEAK
  rest = (2.0 * s * s * n + 2.0 * b * s * n + 4.0 * b * s * n
          + 2.0 * power_iters * s * s) / FP32_PEAK
  t_ops, t_bytes = max(solve, rest), 4.0 * (b * n + 2 * s * n) / HBM_RATE
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def one_ulp_nudge(x, seed):
  """x with every entry moved one ulp up or down at random (on its
  device)."""
  import torch
  up = torch.from_numpy(np.random.RandomState(seed).rand(*x.shape) < 0.5)
  up = up.to(x.device)
  return torch.where(up, torch.nextafter(x, torch.full_like(x, np.inf)),
                     torch.nextafter(x, torch.full_like(x, -np.inf)))


def tier_verdict(torch, got, got_full, plains, nudged, tier, floor=None):
  """How a solve or step at a tier (got) stands against the plain version:
  plains {tier: plain's result} at every tier and 'highest', nudged plain
  at the tier on five nudged inputs, got_full the kernel at 'highest'.
  Returns a dict of the readings and of the rules passed:
  'bound', max|d| within the larger of the floor and plain's spread;
  'control', the kernel five times closer to plain at the tier than that
  is to 'highest' where that distance is at least ten times the noise (the
  larger of plain's own Frobenius spread and the kernel's distance from
  plain at 'highest'), else within three times the noise with its own tier
  moving it within 2x of plain's (the tier's split turns the kernel's and
  plain's last-bit differences into up to 2^-17 of a value, so bf16x3
  steps sit 1-2 noises apart); 'identity', no plain tier nearer the
  kernel (Frobenius) than plain at its own tier.  ``floor`` replaces
  TIER_FLOOR[tier] (phase 48's CONV_TIER_FLOOR)."""
  def f64(t):
    return t.double().reshape(-1)
  got, got_full = f64(got), f64(got_full)
  plains = {k: f64(v) for k, v in plains.items()}
  want, full = plains[tier], plains["highest"]
  moved = [f64(t) - want for t in nudged]
  spread = max(float(m.abs().max()) for m in moved)
  noise = max(max(float(torch.linalg.vector_norm(m)) for m in moved),
              float(torch.linalg.vector_norm(got_full - full)))
  if floor is None:
    floor = TIER_FLOOR[tier]
  v = dict(bound=max(floor * max(1.0, float(want.abs().max())), spread),
           err=float((got - want).abs().max()),
           dist=float(torch.linalg.vector_norm(got - want)),
           control=float(torch.linalg.vector_norm(want - full)),
           own=float(torch.linalg.vector_norm(got - got_full)), noise=noise,
           near={k: float(torch.linalg.vector_norm(got - p))
                 for k, p in plains.items()})
  v["rule"] = ("5x" if 2.0 * TIER_CONTROL * noise <= v["control"]
               else "3 noise")
  v["ok"] = dict(
      bound=v["err"] <= v["bound"],
      control=(TIER_CONTROL * v["dist"] <= v["control"] if v["rule"] == "5x"
               else v["dist"] <= 3.0 * noise
               and 0.5 * v["control"] <= v["own"] <= 2.0 * v["control"]),
      identity=all(v["near"][tier] <= d for d in v["near"].values()))
  return v


def tier_check(torch, label, got, got_full, plains, nudged, tier,
               floor=None):
  """tier_verdict's three rules must hold.  Returns the verdict."""
  v = tier_verdict(torch, got, got_full, plains, nudged, tier, floor)
  print("tier %s %s: max|d| %.3e (bound %.3e); %.3e from plain at the tier, "
        "which is %.3e from 'highest' (noise %.3e, rule %s; the kernel's "
        "tier moves it %.3e); nearest plain tier %s" % (
            label, tier, v["err"], v["bound"], v["dist"], v["control"],
            v["noise"], v["rule"], v["own"],
            min(v["near"], key=v["near"].get)))
  for rule, ok in v["ok"].items():
    check(ok, "tier %s %s: the %s rule fails: %s" % (
        label, tier, rule, {k: v[k] for k in ("err", "bound", "dist",
                                               "control", "noise", "own",
                                               "near")}))
  return v


def tier_one_iteration(torch, K1, K4, K2, K6, sub, lipschitz, patches,
                       train_patches, dev):
  """(a) One iteration of each tier kernel from random codes against its
  plain version at the tier, phase 2's limit.  Hard thresholds and the
  ragged group prox run at the small ragged sizes (a one-ulp difference of
  a pre-threshold value, or of a square near a bf16 rounding edge, moves a
  code by more than the limit; phase 2's rule)."""
  rng = np.random.RandomState(46)
  d = torch.tensor(unit_rows(rng, 256, 256), device=dev)
  x = torch.tensor(patches[:BATCH], device=dev)
  eta = lipschitz.fista_stepsize(d)
  z0 = torch.tensor((rng.randn(BATCH, 256) * 0.05).astype(np.float32),
                    device=dev)
  rag_d = torch.tensor(unit_rows(rng, 37, 24), device=dev)
  rag_x = torch.tensor(rng.randn(13, 24).astype(np.float32), device=dev)
  rag_z = torch.tensor(rng.randn(13, 37).astype(np.float32), device=dev)
  rag_eta = lipschitz.fista_stepsize(rag_d)
  rag_g = [[0, 2, 5], [1], [2, 3, 4, 5], list(range(6, 32))]  # M = 26
  gather, mask, _ = sub.group_layout(rag_g, 32, dev)
  rag_dg = sub.build_grouped_dictionary(rag_d[:32], gather, mask)
  rag_gz = torch.tensor(rng.randn(13, rag_dg.shape[0]).astype(np.float32),
                        device=dev) * mask.reshape(1, -1)
  rag_geta = lipschitz.fista_stepsize(rag_dg)
  tx = torch.tensor(train_patches[:TRAIN_BATCH], device=dev)[None]
  th = torch.zeros(256, device=dev)
  tv = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  worst = 0.0

  def held(label, got, want):
    nonlocal worst
    got, want = [t if isinstance(t, (list, tuple)) else [t]
                 for t in (got, want)]
    for g, w in zip(got, want):
      err, lim = float((g - w).abs().max()), limit(w)
      worst = max(worst, err)
      check(err <= lim, "tier one iteration %s: max|d| %.3e > %.3e" % (
          label, err, lim))
    print("tier one iteration %s: within phase 2's limit" % label)

  for tier in TIER_NAMES:
    for kw, xx, dd, ee, zz, name in (
        (dict(), x, d, eta, z0, "K1 flagship soft"),
        (dict(hard=True), rag_x, rag_d, rag_eta, rag_z, "K1 13x37 hard"),
        (dict(variant="ista", nonneg=True, hard=True), rag_x, rag_d,
         rag_eta, rag_z, "K1 13x37 ista nonneg-hard")):
      got = K1.fused_fista_solve(xx, dd, LAM, 1, ee, initial_codes=zz,
                                 mxu=tier, **kw)
      check(K1.last_route == "tier", "K1 at %s took route %s" % (
          tier, K1.last_route))
      held("%s %s" % (name, tier), got, K1.fused_fista_plain(
          xx, dd, LAM, 1, ee, initial_codes=zz, mxu=tier, **kw))
    for xx, dg, m, ee, zz, hard, name in (
        (x, d, GROUP_SIZE, eta, z0, False, "K4 flagship 64x4"),
        (rag_x, rag_dg, 26, rag_geta, rag_gz, False, "K4 ragged M26 soft"),
        (rag_x, rag_dg, 26, rag_geta, rag_gz, True, "K4 ragged M26 hard")):
      got = K4.fused_group_fista_solve(xx, dg, m, LAM, 1, ee,
                                       initial_grouped=zz.contiguous(),
                                       hard=hard, mxu=tier)
      check(K4.last_route == "tier", "K4 at %s took route %s" % (
          tier, K4.last_route))
      held("%s %s" % (name, tier), got, K4.fused_group_fista_plain(
          xx, dg, m, LAM, 1, ee, initial_grouped=zz.contiguous(), hard=hard,
          mxu=tier))
    flags = dict(power_iters=2, mxu=tier)
    held("K2 step (FISTA 1) %s" % tier,
         K2.fused_train_segment(d, th, tv, tx, LAM, 1, TRAIN_STEP, **flags),
         K2.fused_train_segment_plain(d, th, tv, tx, LAM, 1, TRAIN_STEP,
                                      **flags))
    groups = contiguous_groups(256, GROUP_SIZE)
    held("K6 step (FISTA 1) %s" % tier,
         K6.fused_group_train_segment(d, th, tv, tx, LAM, 1, SUB_STEP,
                                      group_assignments=groups, **flags),
         K6.fused_group_train_segment_plain(
             d, th, tv, tx, LAM, 1, SUB_STEP, group_assignments=groups,
             **flags))
  return worst


def tier_full_cases(torch, K1, K4, K2, K6, lipschitz, patches, train_patches,
                    dev):
  """(b) The flagship solves (K1, K4 at b 2048, FISTA 100) and steps (K2,
  K6 at b 250, FISTA 25) at each tier against the plain version at the
  tier, with tier_check's rules; then each tier's checks on the kernel's
  result at every other tier (a planted wrong-tier call), which must fail.
  Returns ({(K, tier): err}, [(K, tier, planted tier, rules failed)])."""
  rng = np.random.RandomState(47)
  d = torch.tensor(unit_rows(rng, 256, 256), device=dev)
  x = torch.tensor(patches[:BATCH], device=dev)
  eta = lipschitz.fista_stepsize(d)
  tx = torch.tensor(train_patches[:TRAIN_BATCH], device=dev)[None]
  th = torch.zeros(256, device=dev)
  tv = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  groups = contiguous_groups(256, GROUP_SIZE)
  nudged_x = [one_ulp_nudge(x, seed) for seed in range(5)]
  nudged_tx = [one_ulp_nudge(tx, seed) for seed in range(5)]

  def step(out):
    return torch.cat([out[0].reshape(-1), out[3].reshape(-1)])

  cases = {
      "K1": (lambda xx, mxu: K1.fused_fista_solve(xx, d, LAM, ITERS, eta,
                                                  mxu=mxu),
             lambda xx, mxu: K1.fused_fista_plain(xx, d, LAM, ITERS, eta,
                                                  mxu=mxu), x, nudged_x),
      "K4": (lambda xx, mxu: K4.fused_group_fista_solve(
          xx, d, GROUP_SIZE, LAM, ITERS, eta, mxu=mxu),
             lambda xx, mxu: K4.fused_group_fista_plain(
                 xx, d, GROUP_SIZE, LAM, ITERS, eta, mxu=mxu), x, nudged_x),
      "K2": (lambda xx, mxu: step(K2.fused_train_segment(
          d, th, tv, xx, LAM, TRAIN_ITERS, TRAIN_STEP, power_iters=2,
          mxu=mxu)),
             lambda xx, mxu: step(K2.fused_train_segment_plain(
                 d, th, tv, xx, LAM, TRAIN_ITERS, TRAIN_STEP, power_iters=2,
                 mxu=mxu)), tx, nudged_tx),
      "K6": (lambda xx, mxu: step(K6.fused_group_train_segment(
          d, th, tv, xx, LAM, TRAIN_ITERS, SUB_STEP, group_assignments=groups,
          power_iters=2, mxu=mxu)),
             lambda xx, mxu: step(K6.fused_group_train_segment_plain(
                 d, th, tv, xx, LAM, TRAIN_ITERS, SUB_STEP,
                 group_assignments=groups, power_iters=2, mxu=mxu)), tx,
             nudged_tx),
  }
  errs, planted = {}, []
  for name, (kernel, plain, xx, nudged) in cases.items():
    outs = {mxu: kernel(xx, mxu) for mxu in ("highest",) + TIER_NAMES}
    plains = {mxu: plain(xx, mxu) for mxu in ("highest",) + TIER_NAMES}
    for tier in TIER_NAMES:
      spread_in = [plain(nx, tier) for nx in nudged]
      errs[name, tier] = tier_check(torch, name, outs[tier], outs["highest"],
                                    plains, spread_in, tier)["err"]
      # planted: the kernel's result at each other tier in its place must
      # fail at least one rule
      for wrong in ("highest",) + TIER_NAMES:
        if wrong == tier:
          continue
        v = tier_verdict(torch, outs[wrong], outs["highest"], plains,
                         spread_in, tier)
        failed = [rule for rule, ok in v["ok"].items() if not ok]
        planted.append((name, tier, wrong, failed))
        print("tier planted %s: %s in place of %s fails %s (%.3e from plain "
              "at %s, rule %s)" % (name, wrong, tier,
                                   ", ".join(failed) or "NOTHING",
                                   v["dist"], tier, v["rule"]))
        check(failed, "tier %s: the kernel at %s passes every rule held "
              "for %s" % (name, wrong, tier))
  return errs, planted


def tier_stop_cases(torch, K1, K4, K2, K6, solver, lipschitz, patches,
                    gpatches, train_patches, dev):
  """(b') The tier kernel's STOP build (the classic stop route, an
  iteration a launch) inside vtc_tpu's one-tile gate: K1 (FISTA soft, ISTA
  nonneg) and K4 (M 4, FISTA soft) at b 250, one K2 and one K6 step at b
  250, FISTA 25, each tier, eps at k = 1, mid-run and never (stop_eps from
  the plain version's means at the tier).  The count is the plain version
  at the tier's with the same stop (a case whose plain mean lies within
  1e-3 relative of eps is reported apart); the stopped result is bitwise
  the tier kernel's without the stop run to that count, and a second call
  gives the same count and bits; the result passes tier_check at that
  count.  Returns (cases, {(K, tier): (counts, worst max|d|)}, near)."""
  rng = np.random.RandomState(49)
  d = torch.tensor(unit_rows(rng, 256, 256), device=dev)
  eta = lipschitz.fista_stepsize(d)
  xs = {False: torch.tensor(patches[:TRAIN_BATCH], device=dev),
        True: torch.tensor(gpatches[:TRAIN_BATCH], device=dev)}
  tx = torch.tensor(train_patches[:TRAIN_BATCH], device=dev)[None]
  th = torch.zeros(256, device=dev)
  tv = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  groups = contiguous_groups(256, GROUP_SIZE)
  nudged = {k: [one_ulp_nudge(v, seed) for seed in range(5)]
            for k, v in xs.items()}
  nudged_tx = [one_ulp_nudge(tx, seed) for seed in range(5)]

  def step(out):
    return torch.cat([out[0].reshape(-1), out[3].reshape(-1)])

  def solve_case(mod, grouped, kw):
    if grouped:
      run = lambda x, it, mxu, eps=None: K4.fused_group_fista_solve(
          x, d, GROUP_SIZE, LAM, it, eta, mxu=mxu,
          early_stopping_epsilon=eps, **kw)
      plain = lambda x, it, mxu, eps=None: K4.fused_group_fista_plain(
          x, d, GROUP_SIZE, LAM, it, eta, mxu=mxu,
          early_stopping_epsilon=eps, **kw)
    else:
      run = lambda x, it, mxu, eps=None: K1.fused_fista_solve(
          x, d, LAM, it, eta, mxu=mxu, early_stopping_epsilon=eps, **kw)
      plain = lambda x, it, mxu, eps=None: K1.fused_fista_plain(
          x, d, LAM, it, eta, mxu=mxu, early_stopping_epsilon=eps, **kw)
    return (mod, lambda it, mxu, eps=None: run(xs[grouped], it, mxu, eps),
            lambda x, it, mxu, eps=None: plain(x, it, mxu, eps),
            xs[grouped], nudged[grouped],
            lambda: int(mod.last_iters.item()))

  def segment_case(mod):
    if mod is K2:
      run = lambda x, it, mxu, eps=None: K2.fused_train_segment(
          d, th, tv, x, LAM, it, TRAIN_STEP, power_iters=2, mxu=mxu,
          early_stopping_epsilon=eps)
      plain = lambda x, it, mxu, eps=None: K2.fused_train_segment_plain(
          d, th, tv, x, LAM, it, TRAIN_STEP, power_iters=2, mxu=mxu,
          early_stopping_epsilon=eps)
    else:
      run = lambda x, it, mxu, eps=None: K6.fused_group_train_segment(
          d, th, tv, x, LAM, it, SUB_STEP, group_assignments=groups,
          power_iters=2, mxu=mxu, early_stopping_epsilon=eps)
      plain = lambda x, it, mxu, eps=None: (
          K6.fused_group_train_segment_plain(
              d, th, tv, x, LAM, it, SUB_STEP, group_assignments=groups,
              power_iters=2, mxu=mxu, early_stopping_epsilon=eps))
    return (mod, lambda it, mxu, eps=None: step(run(tx, it, mxu, eps)),
            lambda x, it, mxu, eps=None: step(plain(x, it, mxu, eps)), tx,
            nudged_tx, lambda: int(mod.last_iters[0].item()))

  families = {"K1 fista": solve_case(K1, False, {}),
              "K1 ista nonneg": solve_case(K1, False,
                                           dict(variant="ista", nonneg=True)),
              "K4 M4": solve_case(K4, True, {}),
              "K2 step": segment_case(K2), "K6 step": segment_case(K6)}
  cases, out, near = 0, {}, []
  for label, (mod, run, plain, x, nx, count) in families.items():
    for tier in TIER_NAMES:
      plain(x, TRAIN_ITERS, tier, 0.0)
      avgs = list(solver.last_avgs)
      counts, worst = [], 0.0
      for which in ("early", "mid", "never"):
        eps = stop_eps(avgs, which)
        got = run(TRAIN_ITERS, tier, eps)
        it = count()
        route = getattr(mod, "last_route", "tier")
        check(route == "tier", "%s %s with the stop took %s" % (
            label, tier, route))
        again = run(TRAIN_ITERS, tier, eps)
        it2 = count()
        ref = run(it, tier)
        want = plain(x, TRAIN_ITERS, tier, eps)
        plain_it, plain_avgs = solver.last_iters, list(solver.last_avgs)
        torch.cuda.synchronize()
        name = "%s %s eps %s (%.4g)" % (label, tier, which, eps)
        check(torch.equal(got, ref), "%s: the stopped result (%d it) differs "
              "from the tier kernel's without the stop at %d of %d entries"
              % (name, it, int((got != ref).sum()), got.numel()))
        check(it2 == it and torch.equal(got, again), "%s: a second call "
              "differs (%d vs %d it)" % (name, it, it2))
        if eps > 0 and any(abs(a - eps) <= 1e-3 * eps for a in plain_avgs):
          near.append("%s: kernel %d it, plain %d" % (name, it, plain_it))
        else:
          check(it == plain_it, "%s: the kernel ran %d iterations, the "
                "plain version %d" % (name, it, plain_it))
        plains = {mxu: plain(x, it, mxu) for mxu in ("highest",) + TIER_NAMES}
        check(torch.equal(plains[tier], want), "%s: plain with the stop "
              "differs from plain run to its count" % name)
        v = tier_check(torch, "stop " + name + " at %d it" % it, got,
                       run(it, "highest"), plains,
                       [plain(n, it, tier) for n in nx], tier)
        worst = max(worst, v["err"])
        counts.append(it)
        cases += 1
      out[label, tier] = (counts, worst)
      print("tier stop %s %s: counts %s (early, mid, never) equal plain's; "
            "bitwise the kernel without the stop at the count; max|d| %.3e"
            % (label, tier, counts, worst))
  return cases, out, near


def tier_stop_main_path(torch, K1, K4, K2, K6, compiled_epoch, ista_fista, sub,
                        solver, lipschitz, data):
  """(d') The main path with the stop at bf16x3, the tier counts zeroed
  before and read after: ista_fista.run and subspace_ista_fista.run
  ('pallas', b 250, inside vtc_tpu's one-tile gate) and the fc and
  subspace scanned trainers for STOP_MAIN_STEPS steps, each with a mid-run
  eps.  Returns ({module: tier launches}, {module: solve counts})."""
  d = data["dictionary"]
  x = torch.tensor(data["patches"][:TRAIN_BATCH], device=d.device)
  check(K1.early_stop_tile_fits(TRAIN_BATCH, d.shape[0]),
        "b %d is outside vtc_tpu's one-tile gate" % TRAIN_BATCH)
  K1.fused_fista_plain(x, d, LAM, TRAIN_ITERS, lipschitz.fista_stepsize(d),
                       early_stopping_epsilon=0.0, mxu="bf16x3")
  eps = stop_eps(solver.last_avgs, "mid")
  mods = (K1, K4, K2, K6)
  for mod in mods:
    mod.tier_launches = 0
  ista_fista.run(x, d, LAM, TRAIN_ITERS, formulation="pallas",
                 early_stopping_epsilon=eps, mxu_precision="bf16x3")
  its = {K1: int(K1.last_iters.item())}
  sub.run(x, d, data["groups"], LAM, TRAIN_ITERS, formulation="pallas",
          early_stopping_epsilon=eps, mxu_precision="bf16x3")
  its[K4] = int(K4.last_iters.item())
  for mod, batches, held, params in (
      (K2, data["batches"], data["held_out"], data["params"]),
      (K6, data["gbatches"], data["gheld"], data["gparams"])):
    compiled_epoch.train_dictionary_scanned(
        batches[:STOP_MAIN_STEPS], held[None], data["d0"],
        dict(params, train_precision="bf16x3", early_stopping_epsilon=eps))
    its[mod] = mod.last_iters.tolist()
  torch.cuda.synchronize()
  counts = {mod: mod.tier_launches for mod in mods}
  print("tier main path with the stop (bf16x3, eps %.4g): tier launches K1 "
        "%d, K4 %d, K2 %d, K6 %d; solve iterations K1 %s, K4 %s, K2 %s, K6 "
        "%s" % (eps, *(counts[m] for m in mods), *(its[m] for m in mods)))
  check(counts[K1] == counts[K4] == 1, "expected one K1 and one K4 tier "
        "launch with the stop, counted %d and %d" % (counts[K1], counts[K4]))
  check(counts[K2] == counts[K6] == STOP_MAIN_STEPS,
        "expected %d K2 and K6 tier steps with the stop, counted %d and %d"
        % (STOP_MAIN_STEPS, counts[K2], counts[K6]))
  check(its[K1] < TRAIN_ITERS and min(its[K2]) < TRAIN_ITERS
        and min(its[K6]) < TRAIN_ITERS, "no stopped solve ended early: %s"
        % {m.__name__: its[m] for m in mods})
  return counts, its


def tier_main_path(torch, K1, K4, K2, K6, compiled_epoch, encode_dataset,
                   ista_fista, sub, sparse_coding, data):
  """(d) The trainers at each tier (one 1,000-step segment of phases 6 and
  11's data and start) and the fc and subspace encodes of phases 3 and 9
  at each tier, every tier count zeroed before each tier's runs and read
  after; the trainers' quality, bf16x3's held-out loss against phases 6
  and 11's 'highest' runs.  Returns ({(module, tier): tier launches},
  {('fc' or 'subspace', tier): patches/s})."""
  mods = (K1, K4, K2, K6)
  rates, trained, counts = {}, {}, {}
  for tier in TIER_NAMES:
    for mod in mods:
      mod.tier_launches = 0
    for kind, groups in (("fc", None), ("subspace", data["groups"])):
      t0 = time.perf_counter()
      codes = encode_dataset(data["patches"], data["dictionary"], LAM, ITERS,
                             batch_size=BATCH, chunk_batches=4,
                             group_assignments=groups, mxu_precision=tier)
      rates[kind, tier] = codes.shape[0] / (time.perf_counter() - t0)
      check(bool(np.isfinite(codes).all()), "%s encode at %s: non-finite "
            "codes" % (kind, tier))
    trained["fc", tier] = compiled_epoch.train_dictionary_scanned(
        data["batches"], data["held_out"][None], data["d0"],
        dict(data["params"], train_precision=tier))
    trained["subspace", tier] = compiled_epoch.train_dictionary_scanned(
        data["gbatches"], data["gheld"][None], data["d0"],
        dict(data["gparams"], train_precision=tier))
    torch.cuda.synchronize()
    for mod in mods:
      counts[mod, tier] = mod.tier_launches
    print("tier main path %s: tier launches K1 %d, K4 %d, K2 %d, K6 %d" % (
        tier, *(counts[m, tier] for m in mods)))
    check(counts[K1, tier] == counts[K4, tier] == NUM_BATCHES,
          "expected %d %s launches of K1 and K4, counted %d and %d" % (
              NUM_BATCHES, tier, counts[K1, tier], counts[K4, tier]))
    check(counts[K2, tier] == counts[K6, tier] == TRAIN_STEPS,
          "expected %d %s steps of K2 and K6, counted %d and %d" % (
              TRAIN_STEPS, tier, counts[K2, tier], counts[K6, tier]))
  for (kind, tier), dd in trained.items():
    if kind == "fc":
      loss = held_out_loss(torch, ista_fista, sparse_coding,
                           data["held_out"], dd)
      ref, start = data["loss1"], data["loss0"]
    else:
      loss = held_out_group_loss(torch, sub, sparse_coding, data["gheld"],
                                 dd, data["groups"])
      ref, start = data["gloss1"], data["gloss0"]
    norm_err = float((torch.linalg.vector_norm(dd, dim=1) - 1).abs().max())
    moved = float((dd - data["trained" if kind == "fc" else "gtrained"])
                  .abs().max())
    print("tier trainer %s %s: rows unit norm within %.2e; held-out loss "
          "%.8f -> %.8f ('highest' %.8f, %+.4f%%); max |D - D_highest| "
          "%.3e" % (kind, tier, norm_err, start, loss, ref,
                    100.0 * (loss - ref) / ref, moved))
    check(bool(torch.isfinite(dd).all()), "tier trainer %s %s: non-finite "
          "dictionary" % (kind, tier))
    check(norm_err <= 1e-4, "tier trainer %s %s: rows not unit norm: %.3e"
          % (kind, tier, norm_err))
    check(np.isfinite(loss) and loss < start, "tier trainer %s %s: the "
          "held-out loss did not fall: %.6f -> %.6f" % (kind, tier, start,
                                                        loss))
    if tier == "bf16x3":
      check(abs(loss - ref) <= TIER_TRAIN_TOL * ref,
            "tier trainer %s bf16x3: held-out loss %.6f, 'highest' %.6f" % (
                kind, loss, ref))
  return counts, rates


def mm_f32_out(torch):
  """(how, f(a, b)): one PyTorch product of bf16 operands with a float32
  result where the installed torch offers it (torch.mm's out_dtype on
  CUDA), else torch.matmul's bf16 result."""
  a = torch.ones((16, 16), dtype=torch.bfloat16, device="cuda")
  try:
    out = torch.mm(a, a, out_dtype=torch.float32)
    if out.dtype == torch.float32:
      return ("torch.mm(bf16, bf16, out_dtype=torch.float32)",
              lambda x, y: torch.mm(x, y, out_dtype=torch.float32))
  except (TypeError, RuntimeError, NotImplementedError):
    pass
  return ("torch.matmul(bf16, bf16) (bf16 result: this torch has no float32 "
          "output for bf16 operands)", torch.matmul)


def library_turns(torch, fn):
  """The library time of fn: one warm call, then TIER_LIB_TURNS turns of
  TIER_REPS calls; (median, least, most) ms a call.  A single reading
  swung 7x between runs (8.94 to 61.1 ms for K1's bf16x3 passes)."""
  fn()
  readings = sorted(time_ms(torch, fn, TIER_REPS)
                    for _ in range(TIER_LIB_TURNS))
  return readings[len(readings) // 2], readings[0], readings[-1]


def tier_timing(torch, K1, K4, K2, K6, solver, lipschitz, patches,
                train_patches, dev, card):
  """(e) In turns ('highest', tier, tier, 'highest'): K1 and K4 at the
  flagship solve, K2 and K6 per step of a TIER_TIME_STEPS segment; the
  plain versions at the tier; the library time, the same passes as
  products of bf16 operands (library_turns).  Then the STOP build at
  bf16x3 with a mid-run eps: K1 and K4 at b 250, K2 and K6 a step of a
  TIER_TIME_STEPS segment, beside their plain versions with the stop, the
  bound and the library time at the count taken.  Returns ({(K, tier):
  (ms, plain_ms, bound, library_ms)}, {K: 'highest' ms}, {K: (ms,
  plain_ms, bound, library_ms, mean count)})."""
  rng = np.random.RandomState(48)
  d = torch.tensor(unit_rows(rng, 256, 256), device=dev)
  x = torch.tensor(patches[:BATCH], device=dev)
  eta = lipschitz.fista_stepsize(d)
  gram, corr = (d @ d.T).contiguous(), (x @ d.T).contiguous()
  tx = torch.tensor(train_patches[:TIER_TIME_STEPS * TRAIN_BATCH],
                    device=dev).reshape(TIER_TIME_STEPS, TRAIN_BATCH, 256)
  th = torch.zeros(256, device=dev)
  tv = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  groups = contiguous_groups(256, GROUP_SIZE)
  how, mm = mm_f32_out(torch)
  print("tier library time: %s" % how)
  za = x.to(torch.bfloat16)
  gb = (-eta * gram).to(torch.bfloat16)
  zt = za[:TRAIN_BATCH].contiguous()
  kernels = {
      "K1": (lambda mxu: K1._launch(gram, corr, None, eta, LAM, ITERS, True,
                                    0, mxu=mxu),
             lambda mxu: K1.fused_fista_plain(x, d, LAM, ITERS, eta,
                                              mxu=mxu), 1),
      "K4": (lambda mxu: K4._launch(gram, corr, None, eta, LAM, ITERS,
                                    GROUP_SIZE, True, False, mxu=mxu),
             lambda mxu: K4.fused_group_fista_plain(
                 x, d, GROUP_SIZE, LAM, ITERS, eta, mxu=mxu), 1),
      "K2": (lambda mxu: K2.fused_train_segment(
          d, th, tv, tx, LAM, TRAIN_ITERS, TRAIN_STEP, power_iters=2,
          mxu=mxu),
             lambda mxu: K2.fused_train_segment_plain(
                 d, th, tv, tx[:1], LAM, TRAIN_ITERS, TRAIN_STEP,
                 power_iters=2, mxu=mxu), TIER_TIME_STEPS),
      "K6": (lambda mxu: K6.fused_group_train_segment(
          d, th, tv, tx, LAM, TRAIN_ITERS, SUB_STEP, group_assignments=groups,
          power_iters=2, mxu=mxu),
             lambda mxu: K6.fused_group_train_segment_plain(
                 d, th, tv, tx[:1], LAM, TRAIN_ITERS, SUB_STEP,
                 group_assignments=groups, power_iters=2, mxu=mxu),
             TIER_TIME_STEPS),
  }
  out, highest = {}, {}
  with torch.no_grad():
    for name, (kernel, plain, per) in kernels.items():
      solve = name in ("K1", "K4")
      for tier in TIER_NAMES:
        kernel(tier)  # warm
        turns = [time_ms(torch, lambda: kernel("highest"), TIER_REPS),
                 time_ms(torch, lambda: kernel(tier), TIER_REPS),
                 time_ms(torch, lambda: kernel(tier), TIER_REPS),
                 time_ms(torch, lambda: kernel("highest"), TIER_REPS)]
        ms = (turns[1] + turns[2]) / 2 / per
        hi_ms = (turns[0] + turns[3]) / 2 / per
        highest.setdefault(name, []).append(hi_ms)
        p_ms = time_ms(torch, lambda: plain(tier), 2)
        zz = za if solve else zt
        passes = TIER_PASSES[tier] * (ITERS if solve else TRAIN_ITERS)
        lib = library_turns(
            torch, lambda: [mm(zz, gb) for _ in range(passes)])
        bnd = (tier_solve_bound(BATCH, 256, ITERS, tier) if solve else
               tier_step_bound(TRAIN_BATCH, 256, 256, TRAIN_ITERS, tier))
        out[name, tier] = (ms, p_ms, bnd, lib[0])
        print("tier %s %s: %.4f ms%s against 'highest' %.4f in turns "
              "(%.4f, %.4f, %.4f, %.4f); plain %.4f; bound %.4f (%s); "
              "library median %.4f (%d turns %.4f-%.4f) [%s]" % (
                  name, tier, ms, "" if solve else " a step", hi_ms, *turns,
                  p_ms, bnd[0], bnd[1], lib[0], TIER_LIB_TURNS, lib[1],
                  lib[2], card))
    stop = tier_stop_timing(torch, K1, K4, K2, K6, solver, d, x, eta, tx,
                            th, tv, groups, mm, card)
  return out, {k: sum(v) / len(v) for k, v in highest.items()}, stop


def tier_stop_timing(torch, K1, K4, K2, K6, solver, d, x, eta, tx, th, tv,
                     groups, mm, card):
  """tier_timing's STOP rows at bf16x3 (see there)."""
  xs = x[:TRAIN_BATCH].contiguous()
  K1.fused_fista_plain(xs, d, LAM, TRAIN_ITERS, eta,
                       early_stopping_epsilon=0.0, mxu="bf16x3")
  eps = stop_eps(solver.last_avgs, "mid")
  K2.fused_train_segment_plain(d, th, tv, tx[:1], LAM, TRAIN_ITERS,
                               TRAIN_STEP, power_iters=2, mxu="bf16x3",
                               early_stopping_epsilon=0.0)
  seg_eps = stop_eps(solver.last_avgs, "mid")
  flags = dict(mxu="bf16x3", early_stopping_epsilon=eps)
  seg = dict(power_iters=2, mxu="bf16x3", early_stopping_epsilon=seg_eps)
  kernels = {
      "K1": (lambda: K1.fused_fista_solve(xs, d, LAM, TRAIN_ITERS, eta,
                                          **flags),
             lambda: K1.fused_fista_plain(xs, d, LAM, TRAIN_ITERS, eta,
                                          **flags), 1, K1),
      "K4": (lambda: K4.fused_group_fista_solve(xs, d, GROUP_SIZE, LAM,
                                                TRAIN_ITERS, eta, **flags),
             lambda: K4.fused_group_fista_plain(xs, d, GROUP_SIZE, LAM,
                                                TRAIN_ITERS, eta, **flags),
             1, K4),
      "K2": (lambda: K2.fused_train_segment(d, th, tv, tx, LAM, TRAIN_ITERS,
                                            TRAIN_STEP, **seg),
             lambda: K2.fused_train_segment_plain(
                 d, th, tv, tx[:1], LAM, TRAIN_ITERS, TRAIN_STEP, **seg),
             TIER_TIME_STEPS, K2),
      "K6": (lambda: K6.fused_group_train_segment(
          d, th, tv, tx, LAM, TRAIN_ITERS, SUB_STEP,
          group_assignments=groups, **seg),
             lambda: K6.fused_group_train_segment_plain(
                 d, th, tv, tx[:1], LAM, TRAIN_ITERS, SUB_STEP,
                 group_assignments=groups, **seg), TIER_TIME_STEPS, K6)}
  za = xs.to(torch.bfloat16)
  gb = (-eta * (d @ d.T)).to(torch.bfloat16)
  out = {}
  for name, (kernel, plain, per, mod) in kernels.items():
    kernel()  # warm
    its = mod.last_iters.float().mean().item()
    ms = time_ms(torch, kernel, TIER_REPS) / per
    p_ms = time_ms(torch, plain, 2)
    passes = max(1, round(TIER_PASSES["bf16x3"] * its))
    lib = library_turns(torch, lambda: [mm(za, gb) for _ in range(passes)])
    bnd = (tier_solve_bound(TRAIN_BATCH, 256, its, "bf16x3") if per == 1
           else tier_step_bound(TRAIN_BATCH, 256, 256, its, "bf16x3"))
    out[name] = (ms, p_ms, bnd, lib[0], its)
    print("tier stop %s bf16x3 (eps %.4g, %.1f of %d iterations): %.4f "
          "ms%s; plain %.4f; bound %.4f (%s); library median %.4f (%d turns "
          "%.4f-%.4f) [%s]" % (name, eps if per == 1 else seg_eps, its,
                               TRAIN_ITERS, ms,
                               "" if per == 1 else " a step", p_ms, bnd[0],
                               bnd[1], lib[0], TIER_LIB_TURNS, lib[1], lib[2],
                               card))
  return out


def tier_phase(torch, dev, card, patches, train_patches, data):
  """Phase 46: (a)-(e) above; (c), that the 'highest' routes are bitwise
  their parent's, is phases 39, 42 and 43's comparisons, which run the
  same routes; here a 'highest' solve must not take the tier kernel."""
  from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
  from vtc_tpu_torch.analysis_transforms.fully_connected import (
      subspace_ista_fista as sub)
  from vtc_tpu_torch.encode import encode_dataset
  from vtc_tpu_torch.ops import fused_fista as K1
  from vtc_tpu_torch.ops import fused_group_fista as K4
  from vtc_tpu_torch.ops import fused_group_train_step as K6
  from vtc_tpu_torch.ops import fused_train_step as K2
  from vtc_tpu_torch.ops import lipschitz, solver
  from vtc_tpu_torch.training import compiled_epoch, sparse_coding
  t0 = time.perf_counter()
  one_err = tier_one_iteration(torch, K1, K4, K2, K6, sub, lipschitz,
                               patches, train_patches, dev)
  full_errs, planted = tier_full_cases(torch, K1, K4, K2, K6, lipschitz,
                                       patches, train_patches, dev)
  stop_cases, stops, near = tier_stop_cases(
      torch, K1, K4, K2, K6, solver, lipschitz, patches, data["gpatches"],
      train_patches, dev)
  print("tier stop: %d cases, counts equal plain's, bitwise the kernel "
        "without the stop at the count; near eps (reported apart): %s" % (
            stop_cases, near or "none"))
  x0 = torch.tensor(patches[:BATCH], device=dev)
  K1.fused_fista_solve(x0, data["dictionary"], LAM, ITERS,
                       lipschitz.fista_stepsize(data["dictionary"]))
  check(K1.last_route == "wide", "a 'highest' flagship solve took the %s "
        "route" % K1.last_route)
  counts, rates = tier_main_path(torch, K1, K4, K2, K6, compiled_epoch,
                                 encode_dataset, ista_fista, sub,
                                 sparse_coding, data)
  stop_counts, stop_its = tier_stop_main_path(
      torch, K1, K4, K2, K6, compiled_epoch, ista_fista, sub, solver,
      lipschitz, data)
  for kind in ("fc", "subspace"):
    t1 = time.perf_counter()
    encode_dataset(data["patches"], data["dictionary"], LAM, ITERS,
                   batch_size=BATCH, chunk_batches=4,
                   group_assignments=(data["groups"] if kind == "subspace"
                                      else None))
    hi_rate = data["patches"].shape[0] / (time.perf_counter() - t1)
    print("tier encode %s: %s patches/s; 'highest' %.1f [%s]" % (
        kind, ", ".join("%s %.1f" % (t, rates[kind, t])
                        for t in TIER_NAMES), hi_rate, card))
  times, highest, stop_times = tier_timing(
      torch, K1, K4, K2, K6, solver, lipschitz, patches, train_patches, dev,
      card)
  print("phase 46: %.1f s" % (time.perf_counter() - t0))
  return dict(one_err=one_err, full_errs=full_errs, counts=counts,
              times=times, highest=highest, mods=(K1, K4, K2, K6),
              planted=planted, stops=stops, stop_counts=stop_counts,
              stop_its=stop_its, stop_times=stop_times)


# ---------------------------------------------------------------------------
# phase 47: the precision tiers of the data-parallel fc and subspace kernels
# (K3, K7, K15, K16), the data-parallel trainers and the data-parallel encode
# ---------------------------------------------------------------------------
DP_TIER_STEPS = 10        # the world-of-2 runs, with and without the stop
DP_TIER_DCN_STEPS = 50    # each tier's 'dcn' composition on the main path
DP_TIER_TIME_STEPS = 20   # the steps of each timed K15 / K16 segment
DP_TIER_WORLD = ("bf16x3", "bf16")  # the tiers of the world of 2
DP_TIER_CHILD_TIMEOUT = 600  # seconds a rank of phase 47 may take


def dp_tier_bound(b, s, n, iters, tier, upd_iters=0, power_iters=2):
  """K3 / K7 (upd_iters 0) or a K15 / K16 step at a tier: the solve's
  passes at the bf16 tensor-core rate beside the fp32 products (G, c, the
  refresh, C = codes^T codes, B = codes^T X and each update's C D) at the
  fp32 rate, the two units' least times overlapped; reading X and D and
  writing C, B and stat (a segment step: D)."""
  solve = 2.0 * b * s * s * iters * TIER_PASSES[tier] / BF16_PEAK
  rest = (2.0 * s * s * n + 2.0 * b * s * n + 2.0 * power_iters * s * s
          + 2.0 * b * s * s + 2.0 * b * s * n
          + 2.0 * upd_iters * s * s * n) / FP32_PEAK
  written = s * n if upd_iters else s * s + s * n + s
  t_ops, t_bytes = (max(solve, rest),
                    4.0 * (b * n + s * n + written) / HBM_RATE)
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def flat_cat(torch, out):
  """The outputs of a call, each flattened, as one float64 vector."""
  out = out if isinstance(out, (tuple, list)) else (out,)
  return torch.cat([t.double().reshape(-1) for t in out])


def check_tier_runs(torch, label, run, plain, x, mod, counter, tier,
                    steps=1):
  """A tier one of K3, K7, K15 and K16 refused before phase 47 (phases 26
  and 33), or one of K10, K13 and K17 before phase 48 (phases 13 and 30):
  run(x, mxu) launches its kernel at the tier, ``steps`` more on
  mod.<counter>, and stands within tier_verdict's bound of plain(x, mxu),
  the larger of the tier's floor and the plain version's spread under five
  one-ulp nudges of x."""
  before = getattr(mod, counter)
  got = flat_cat(torch, run(x, tier))
  check(getattr(mod, counter) == before + steps, "%s launched %d tier steps,"
        " expected %d" % (label, getattr(mod, counter) - before, steps))
  plains = {m: flat_cat(torch, plain(x, m)) for m in ("highest", tier)}
  v = tier_verdict(torch, got, flat_cat(torch, run(x, "highest")), plains,
                   [flat_cat(torch, plain(one_ulp_nudge(x, seed), tier))
                    for seed in range(5)], tier)
  check(v["ok"]["bound"], "%s: max|d| %.3e from plain at the tier, bound "
        "%.3e" % (label, v["err"], v["bound"]))
  print("runs on the card at its tier: %s, max|d| %.3e from plain (bound "
        "%.3e)" % (label, v["err"], v["bound"]))


def dp_tier_inputs(torch, lipschitz, train_patches, gtrain, dev):
  """Phase 47's flagship data-parallel rows (bench.py:796-827: b 250,
  s = n = 256, FISTA 25, cheap-quadratic, 64 contiguous groups of 4): a
  dictionary, a zero Hessian EMA, its exact eigenvector seed (Dg = D for
  the contiguous groups) and DP_TIER_TIME_STEPS batches of fc and of
  group-sparse training patches, on the card."""
  d = torch.tensor(unit_rows(np.random.RandomState(47), 256, 256),
                   device=dev)
  shape = (DP_TIER_TIME_STEPS, TRAIN_BATCH, 256)
  num = DP_TIER_TIME_STEPS * TRAIN_BATCH
  fc = torch.tensor(train_patches[:num].reshape(shape), device=dev)
  gx = torch.tensor(gtrain[:num].reshape(shape), device=dev)
  v = lipschitz.top_gram_eigenpair(d)[1].contiguous()
  return d, torch.zeros(256, device=dev), v, fc, gx


def dp_tier_families(K3, K7, K15, K16, mesh1, inputs):
  """{label: (module, kernel(x, mxu, eps=None, iters=None), plain(x, mxu,
  eps=None), input)} of the four kernels at the flagship rows: K3 and K7
  on a shard of 125, K15 and K16 one step of 250 on a mesh of one."""
  d, h, v, fc, gx = inputs
  groups = contiguous_groups(256, GROUP_SIZE)
  seg = dict(mesh=mesh1, power_iters=2)

  def k3(x, mxu, eps=None, iters=None):
    return K3.fused_solve_stats(d, v, x, LAM, TRAIN_ITERS, power_iters=2,
                                mxu=mxu)

  def k7(x, mxu, eps=None, iters=None):
    return K7.fused_group_solve_stats(d, v, x, LAM, TRAIN_ITERS,
                                      group_assignments=groups,
                                      power_iters=2, mxu=mxu)

  def k15(x, mxu, eps=None, iters=None):
    return K15.fused_dp_train_segment(
        d, h, v, x, LAM, TRAIN_ITERS if iters is None else iters, TRAIN_STEP,
        mxu=mxu, early_stopping_epsilon=eps, **seg)

  def k16(x, mxu, eps=None, iters=None):
    return K16.fused_group_dp_train_segment(
        d, h, v, x, LAM, TRAIN_ITERS if iters is None else iters, SUB_STEP,
        group_assignments=groups, mxu=mxu, early_stopping_epsilon=eps,
        **seg)

  return {
      "K3": (K3, k3,
             lambda x, mxu, eps=None: K3.fused_solve_stats_plain(
                 d, v, x, LAM, TRAIN_ITERS, power_iters=2, mxu=mxu),
             fc[0, :TRAIN_BATCH // 2].contiguous()),
      "K7": (K7, k7,
             lambda x, mxu, eps=None: K7.fused_group_solve_stats_plain(
                 d, v, x, LAM, TRAIN_ITERS, group_assignments=groups,
                 power_iters=2, mxu=mxu),
             gx[0, :TRAIN_BATCH // 2].contiguous()),
      "K15": (K15, k15,
              lambda x, mxu, eps=None: K15.fused_dp_train_plain(
                  d, h, v, x, LAM, TRAIN_ITERS, TRAIN_STEP, mxu=mxu,
                  early_stopping_epsilon=eps, **seg), fc[:1]),
      "K16": (K16, k16,
              lambda x, mxu, eps=None: K16.fused_group_dp_train_plain(
                  d, h, v, x, LAM, TRAIN_ITERS, SUB_STEP,
                  group_assignments=groups, mxu=mxu,
                  early_stopping_epsilon=eps, **seg), gx[:1])}


def dp_tier_one_step(torch, families):
  """(a) One step of each kernel at each tier against its plain version at
  the tier under tier_verdict's three rules, the spread under five
  one-ulp nudges of the input; then the kernel's result at each other
  tier and at 'highest' planted in each tier's place, which must fail.
  At 'bf16' K7 on the identity layout returns bf16-rounded codes and K16
  does not (vtc_tpu's K7 unpack has no identity shortcut, its K16 does).
  Returns ({(K, tier): err}, [(K, tier, planted tier, rules failed)])."""
  errs, planted = {}, []
  for name, (mod, run, plain, x) in families.items():
    outs = {mxu: flat_cat(torch, run(x, mxu))
            for mxu in ("highest",) + TIER_NAMES}
    plains = {mxu: flat_cat(torch, plain(x, mxu))
              for mxu in ("highest",) + TIER_NAMES}
    for tier in TIER_NAMES:
      nudged = [flat_cat(torch, plain(one_ulp_nudge(x, seed), tier))
                for seed in range(5)]
      errs[name, tier] = tier_check(torch, name + " one step", outs[tier],
                                    outs["highest"], plains, nudged,
                                    tier)["err"]
      for wrong in ("highest",) + TIER_NAMES:
        if wrong == tier:
          continue
        v = tier_verdict(torch, outs[wrong], outs["highest"], plains, nudged,
                         tier)
        failed = [rule for rule, ok in v["ok"].items() if not ok]
        planted.append((name, tier, wrong, failed))
        print("tier planted %s: %s in place of %s fails %s" % (
            name, wrong, tier, ", ".join(failed) or "NOTHING"))
        check(failed, "tier %s: the kernel at %s passes every rule held for "
              "%s" % (name, wrong, tier))
  rounded = {}
  for name, index in (("K7", 0), ("K16", 3)):
    run, x = families[name][1], families[name][3]
    codes = run(x, "bf16")[index]
    rounded[name] = bool(torch.equal(codes,
                                     codes.to(torch.bfloat16).float()))
  print("tier K7 and K16 at bf16 on the identity layout: codes bf16-exact "
        "%s" % rounded)
  check(rounded == {"K7": True, "K16": False}, "at bf16 on the identity "
        "layout K7 must round its codes and K16 must not: %s" % rounded)
  return errs, planted


def dp_tier_stop_cases(torch, families):
  """(b) K15 and K16 at a world of 1 with the stop at each tier, eps at
  k = 1, mid-run and never (stop_eps from the plain version's means at
  the tier): the count the plain version's (a case whose plain mean lies
  within 1e-3 relative of eps is reported apart), the result bitwise the
  tier kernel's without the stop at that count.  Returns (cases, {(K,
  tier): counts}, near)."""
  cases, out, near = 0, {}, []
  for name in ("K15", "K16"):
    mod, run, plain, x = families[name]
    for tier in TIER_NAMES:
      plain(x, tier, 0.0)
      avgs = solver_state()[1]
      counts = []
      for which in ("early", "mid", "never"):
        eps = stop_eps(avgs, which)
        got = flat_cat(torch, run(x, tier, eps))
        it = int(mod.last_iters[0].item())
        ref = flat_cat(torch, run(x, tier, iters=it))
        plain(x, tier, eps)
        plain_it, plain_avgs = solver_state()
        label = "%s %s eps %s (%.4g)" % (name, tier, which, eps)
        check(torch.equal(got, ref), "%s: the stopped step (%d it) differs "
              "from the tier kernel's without the stop at that count" % (
                  label, it))
        if eps > 0 and any(abs(a - eps) <= 1e-3 * eps for a in plain_avgs):
          near.append("%s: kernel %d it, plain %d" % (label, it, plain_it))
        else:
          check(it == plain_it, "%s: the kernel ran %d iterations, the plain"
                " version %d" % (label, it, plain_it))
        counts.append(it)
        cases += 1
      out[name, tier] = counts
      print("tier stop %s %s at a world of 1: counts %s (early, mid, never)"
            ", the plain version's; bitwise the kernel without the stop at "
            "the count" % (name, tier, counts))
  return cases, out, near


def dp_tier_rank_main(rank, world, workdir):
  """The hidden sub-command: one rank of phase 47's world of 2.  Joins the
  gloo group over the file store in ``workdir`` and runs the scanned fc
  and subspace trainers with data_parallel=True (K15 and K16 on shards of
  125) for DP_TIER_STEPS steps at each tier of DP_TIER_WORLD, without and
  with the stop at the eps of inputs.npz, then on a mesh of two slices
  (make_mesh(dcn=2): K3's and K7's composition) at bf16x3; saves each
  dictionary, the counts and the tier launches to ``workdir``."""
  import os
  import torch
  import torch.distributed as dist
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.ops import fused_dp_train as K15
  from vtc_tpu_torch.ops import fused_group_dp_train as K16
  from vtc_tpu_torch.ops import fused_group_train_step as K7
  from vtc_tpu_torch.ops import fused_train_step as K3
  from vtc_tpu_torch.training import compiled_epoch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  dev = torch.device("cuda", 0)
  data = dict(np.load(os.path.join(workdir, "inputs.npz")))
  dist.init_process_group("gloo", init_method="file://" + os.path.join(
      workdir, "store"), rank=rank, world_size=world)
  try:
    out = {}
    runs = dp_tier_world_runs()
    for key, family, tier, stop, dcn in runs:
      mod = ((K3 if family == "fc" else K7) if dcn > 1 else
             (K15 if family == "fc" else K16))
      counter = "stats_tier_launches" if dcn > 1 else "tier_launches"
      x = data[family]
      params = dict(dp_tier_params(family), train_precision=tier,
                    data_parallel=(True if dcn == 1
                                   else parallel.make_mesh(dcn=dcn)))
      if stop:
        params["early_stopping_epsilon"] = float(data["eps %s %s" % (
            family, tier)])
      setattr(mod, counter, 0)
      got = compiled_epoch.train_dictionary_scanned(x, x[:1], data["d"],
                                                    params, device=dev)
      torch.cuda.synchronize()
      out[key + " dictionary"] = got.cpu().numpy()
      out[key + " launches"] = np.array(getattr(mod, counter))
      if stop:
        out[key + " counts"] = mod.last_iters.cpu().numpy()
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **out)
  finally:
    dist.destroy_process_group()
  return 0


def dp_tier_params(family):
  """The scanned trainer's parameters of phase 47's world-of-2 runs."""
  if family == "fc":
    return train_params(DP_TIER_STEPS)
  return subspace_train_params(DP_TIER_STEPS, SUB_STEP)


def dp_tier_world_runs():
  """(key, family, tier, with the stop, dcn) of the world of 2's runs."""
  runs = [("%s %s%s" % (family, tier, " stop" if stop else ""), family, tier,
           stop, 1) for tier in DP_TIER_WORLD
          for family in ("fc", "subspace") for stop in (False, True)]
  runs += [("%s bf16x3 dcn=2" % family, family, "bf16x3", False, 2)
           for family in ("fc", "subspace")]
  return runs


def dp_tier_world_of_two(torch, compiled_epoch, parallel, mesh1, families,
                         inputs):
  """(c) The world of 2 (dp_tier_rank_main in two processes of this script
  sharing the card over gloo, phase 45's launcher) against the same
  trainer at a world of 1 on the whole batches: both ranks bitwise equal
  with the same counts; DP_TIER_STEPS tier steps on each rank; the counts
  of the world of 1 (a near eps reported apart); every dictionary within
  the larger of DP_FLOOR, the tier's floor and the world of 1's spread
  under five one-ulp nudges of its batches and start.  Returns ({key:
  (max|d| from the world of 1, bound)}, seconds)."""
  import os
  import tempfile
  d, h, v, fc, gx = inputs
  xs = {"fc": fc[:DP_TIER_STEPS].contiguous(),
        "subspace": gx[:DP_TIER_STEPS].contiguous()}
  data = {"d": d.cpu().numpy(), "fc": xs["fc"].cpu().numpy(),
          "subspace": xs["subspace"].cpu().numpy()}
  for family, name in (("fc", "K15"), ("subspace", "K16")):
    plain, x = families[name][2], families[name][3]
    for tier in DP_TIER_WORLD:
      plain(x, tier, 0.0)
      data["eps %s %s" % (family, tier)] = np.array(
          stop_eps(solver_state()[1], "mid"))
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as workdir:
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    codes, dt = spawn_ranks("--tier-rank", 2, workdir, DP_TIER_CHILD_TIMEOUT)
    check(codes == [0, 0], "a rank of phase 47's world of 2 failed: exit "
          "codes %s" % codes)
    ranks = [dict(np.load(os.path.join(workdir, "rank%d.npz" % r)))
             for r in range(2)]
  print("phase 47: 2 processes sharing one card over gloo done in %.1f s"
        % dt)
  results = {}
  for key, family, tier, stop, dcn in dp_tier_world_runs():
    for what in ("dictionary", "counts"):
      if key + " " + what in ranks[0]:
        check(np.array_equal(ranks[0][key + " " + what],
                             ranks[1][key + " " + what]),
              "phase 47 world of 2 %s: the ranks' %s differ" % (key, what))
    launches = [int(r[key + " launches"]) for r in ranks]
    check(launches == [DP_TIER_STEPS] * 2, "phase 47 world of 2 %s: tier "
          "launches %s, expected %d a rank" % (key, launches, DP_TIER_STEPS))
    params = dict(dp_tier_params(family), train_precision=tier)
    if stop:
      params["early_stopping_epsilon"] = float(data["eps %s %s" % (family,
                                                                   tier)])
    if dcn > 1:
      # the composition a 'dcn' mesh takes, on a mesh of one
      runner = dp_tier_dcn_runner(parallel, compiled_epoch, mesh1, family,
                                  tier)

      def one(x, dd):
        return runner(dd, torch.zeros(256, device=dd.device),
                      dp_tier_seed(dd), x, LAM,
                      TRAIN_ITERS, TRAIN_STEP if family == "fc"
                      else SUB_STEP)[0]
    else:

      def one(x, dd):
        return compiled_epoch.train_dictionary_scanned(
            x, x[:1], dd, dict(params, data_parallel=True))
    want = one(xs[family], d)
    single_counts = None
    if stop:
      mod = families["K15" if family == "fc" else "K16"][0]
      single_counts = mod.last_iters.tolist()
    moved = max(float((one(one_ulp_nudge(xs[family], seed),
                           one_ulp_nudge(d, seed + 5)) - want).abs().max())
                for seed in range(5))
    bound = max(DP_FLOOR, TIER_FLOOR[tier] * max(
        1.0, float(want.abs().max())), moved)
    err = float(np.abs(ranks[0][key + " dictionary"]
                       - want.cpu().numpy()).max())
    results[key] = (err, bound)
    note = ""
    if stop:
      counts = ranks[0][key + " counts"].tolist()
      note = "; counts %s (world of 1: %s)" % (counts, single_counts)
      check(counts == single_counts, "phase 47 world of 2 %s: counts %s, "
            "the world of 1's %s" % (key, counts, single_counts))
      check(min(counts) < TRAIN_ITERS, "phase 47 world of 2 %s: no solve "
            "stopped early" % key)
    print("world of 2 %s: ranks bitwise equal, %d tier steps a rank%s; "
          "max|d| %.3e from the world of 1 (bound %.3e)" % (
              key, DP_TIER_STEPS, note, err, bound))
    check(np.isfinite(ranks[0][key + " dictionary"]).all() and err <= bound,
          "phase 47 world of 2 %s differs from the world of 1 by %.3e > %.3e"
          % (key, err, bound))
  return results, time.perf_counter() - t0


def dp_tier_seed(d):
  """The trainers' exact eigenvector seed, fc and subspace alike (Dg = D
  for the contiguous groups)."""
  from vtc_tpu_torch.ops import lipschitz
  return lipschitz.top_gram_eigenpair(d)[1].contiguous()


def dp_tier_dcn_runner(parallel, compiled_epoch, mesh, family, tier):
  """The composition the scanned trainer runs on a mesh with a 'dcn' axis
  (compiled_epoch._dp_fused_segment_runner of build_dp_fused_local_step or
  its group twin, K3 or K7 a step) on ``mesh``, at the tier."""
  common = dict(power_iters=2, mxu=tier)
  if family == "fc":
    local = parallel.build_dp_fused_local_step(
        mesh, "fista", "sc_cheap_quadratic_descent", **common)
  else:
    local = parallel.build_dp_group_fused_local_step(
        mesh, "subspace_fista", "subspace_sc_cheap_quadratic_descent",
        group_assignments=contiguous_groups(256, GROUP_SIZE), **common)
  return compiled_epoch._dp_fused_segment_runner(local)


def dp_tier_main_path(torch, mods, compiled_epoch, parallel, encode_dataset,
                      ista_fista, sub, sparse_coding, mesh1, data):
  """(d) The main path at each tier, every tier count zeroed before and
  read after: the data-parallel fc and subspace trainers at a world of 1,
  one 1,000-step segment each of phases 6 and 11's data and start
  (1,000 K15 and 1,000 K16 tier steps); the 'dcn' composition for
  DP_TIER_DCN_STEPS steps of each (K3, K7); the fc and subspace
  encode_dataset(data_parallel=True) of phases 3 and 9 (16 K1 and 16 K4
  tier launches).  Every dictionary finite and unit norm within 1e-4, its
  held-out loss falling, and at bf16x3 within 10% of phases 6 and 11's
  'highest' runs.  Returns {(module, tier): tier launches}."""
  K1, K4, K3, K7, K15, K16 = mods
  counters = ((K1, "tier_launches"), (K4, "tier_launches"),
              (K3, "stats_tier_launches"), (K7, "stats_tier_launches"),
              (K15, "tier_launches"), (K16, "tier_launches"))
  counts, trained = {}, {}
  want = {K1: NUM_BATCHES, K4: NUM_BATCHES, K3: DP_TIER_DCN_STEPS,
          K7: DP_TIER_DCN_STEPS, K15: TRAIN_STEPS, K16: TRAIN_STEPS}
  for tier in TIER_NAMES:
    for mod, counter in counters:
      setattr(mod, counter, 0)
    for groups in (None, data["groups"]):
      codes = encode_dataset(data["patches"], data["dictionary"], LAM, ITERS,
                             batch_size=BATCH, chunk_batches=4,
                             group_assignments=groups, mxu_precision=tier,
                             data_parallel=True)
      check(codes.shape == (data["patches"].shape[0], 256)
            and bool(np.isfinite(codes).all()), "data-parallel encode at %s:"
            " codes of shape %s, finite %s" % (tier, codes.shape,
                                               np.isfinite(codes).all()))
    for family, batches, params in (
        ("fc", data["batches"], data["params"]),
        ("subspace", data["gbatches"], data["gparams"])):
      trained[family, tier] = compiled_epoch.train_dictionary_scanned(
          batches, data["held_out" if family == "fc" else "gheld"][None],
          data["d0"], dict(params, train_precision=tier, data_parallel=True))
      runner = dp_tier_dcn_runner(parallel, compiled_epoch, mesh1, family,
                                  tier)
      trained[family + " dcn", tier] = runner(
          data["d0"], torch.zeros(256, device=data["d0"].device),
          dp_tier_seed(data["d0"]),
          batches[:DP_TIER_DCN_STEPS].contiguous(), LAM, TRAIN_ITERS,
          TRAIN_STEP if family == "fc" else SUB_STEP)[0]
    torch.cuda.synchronize()
    for mod, counter in counters:
      counts[mod, tier] = getattr(mod, counter)
    print("tier data-parallel main path %s: tier launches K1 %d, K4 %d, K3 "
          "%d, K7 %d, K15 %d, K16 %d" % (
              tier, *(counts[m, tier] for m, _ in counters)))
    for mod, _ in counters:
      check(counts[mod, tier] == want[mod], "expected %d %s launches of %s,"
            " counted %d" % (want[mod], tier, mod.__name__,
                             counts[mod, tier]))
  for (kind, tier), dd in trained.items():
    if kind.startswith("fc"):
      loss = held_out_loss(torch, ista_fista, sparse_coding,
                           data["held_out"], dd)
      ref, start = data["loss1"], data["loss0"]
    else:
      loss = held_out_group_loss(torch, sub, sparse_coding, data["gheld"],
                                 dd, data["groups"])
      ref, start = data["gloss1"], data["gloss0"]
    norm_err = float((torch.linalg.vector_norm(dd, dim=1) - 1).abs().max())
    print("tier data-parallel trainer %s %s: rows unit norm within %.2e; "
          "held-out loss %.8f -> %.8f ('highest' 1,000 steps on one device "
          "%.8f, %+.4f%%)" % (kind, tier, norm_err, start, loss, ref,
                              100.0 * (loss - ref) / ref))
    check(bool(torch.isfinite(dd).all()) and norm_err <= 1e-4,
          "tier data-parallel trainer %s %s: non-finite or rows not unit "
          "norm (%.3e)" % (kind, tier, norm_err))
    check(np.isfinite(loss) and loss < start, "tier data-parallel trainer "
          "%s %s: the held-out loss did not fall: %.6f -> %.6f" % (
              kind, tier, start, loss))
    if tier == "bf16x3" and "dcn" not in kind:
      check(abs(loss - ref) <= TIER_TRAIN_TOL * ref,
            "tier data-parallel trainer %s bf16x3: held-out loss %.6f, "
            "'highest' %.6f" % (kind, loss, ref))
  return counts


def dp_tier_timing(torch, families, inputs, card):
  """(e) In turns ('highest', tier, tier, 'highest'): K3 and K7 one step on
  the shard of 125, K15 and K16 per step of a DP_TIER_TIME_STEPS segment
  at b 250; the plain version at the tier (one step); the bound
  (dp_tier_bound); the library time, the step's solve passes as products
  of bf16 operands (library_turns).  Returns {(K, tier): (ms, plain_ms,
  bound, library_ms)}."""
  d, h, v, fc, gx = inputs
  how, mm = mm_f32_out(torch)
  print("tier data-parallel library time: %s" % how)
  eta = 1.0 / float(torch.dot(v, (d @ d.T) @ v))
  gb = (-eta * (d @ d.T)).to(torch.bfloat16)
  whole = {"K15": fc, "K16": gx}
  out = {}
  with torch.no_grad():
    for name, (mod, run, plain, x) in families.items():
      per = DP_TIER_TIME_STEPS if name in whole else 1
      xt = whole.get(name, x)
      zb = x.reshape(-1, 256).to(torch.bfloat16)
      for tier in TIER_NAMES:
        run(xt, tier)  # warm
        turns = [time_ms(torch, lambda: run(xt, "highest"), TIER_REPS),
                 time_ms(torch, lambda: run(xt, tier), TIER_REPS),
                 time_ms(torch, lambda: run(xt, tier), TIER_REPS),
                 time_ms(torch, lambda: run(xt, "highest"), TIER_REPS)]
        ms = (turns[1] + turns[2]) / 2 / per
        hi_ms = (turns[0] + turns[3]) / 2 / per
        p_ms = time_ms(torch, lambda: plain(x, tier), 2)
        passes = TIER_PASSES[tier] * TRAIN_ITERS
        lib = library_turns(torch,
                            lambda: [mm(zb, gb) for _ in range(passes)])
        b = x.shape[-2]
        bnd = dp_tier_bound(b, 256, 256, TRAIN_ITERS, tier,
                            upd_iters=1 if name in whole else 0)
        out[name, tier] = (ms, p_ms, bnd, lib[0])
        print("tier %s %s: %.4f ms a step against 'highest' %.4f in turns "
              "(%.4f, %.4f, %.4f, %.4f); plain %.4f; bound %.4f (%s); "
              "library median %.4f (%d turns %.4f-%.4f) [%s]" % (
                  name, tier, ms, hi_ms, *turns, p_ms, bnd[0], bnd[1],
                  lib[0], TIER_LIB_TURNS, lib[1], lib[2], card))
  return out


def dp_tier_phase(torch, dev, card, train_patches, gtrain, data):
  """Phase 47: (a)-(e) above."""
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
  from vtc_tpu_torch.analysis_transforms.fully_connected import (
      subspace_ista_fista as sub)
  from vtc_tpu_torch.encode import encode_dataset
  from vtc_tpu_torch.ops import fused_dp_train as K15
  from vtc_tpu_torch.ops import fused_fista as K1
  from vtc_tpu_torch.ops import fused_group_dp_train as K16
  from vtc_tpu_torch.ops import fused_group_fista as K4
  from vtc_tpu_torch.ops import fused_group_train_step as K7
  from vtc_tpu_torch.ops import fused_train_step as K3
  from vtc_tpu_torch.ops import lipschitz
  from vtc_tpu_torch.training import compiled_epoch, sparse_coding
  t0 = time.perf_counter()
  mesh1 = parallel.make_mesh()
  inputs = dp_tier_inputs(torch, lipschitz, train_patches, gtrain, dev)
  families = dp_tier_families(K3, K7, K15, K16, mesh1, inputs)
  errs, planted = dp_tier_one_step(torch, families)
  stop_cases, stops, near = dp_tier_stop_cases(torch, families)
  print("tier data-parallel stop: %d cases at the plain version's counts, "
        "bitwise the kernel without the stop at the count; near eps "
        "(reported apart): %s" % (stop_cases, near or "none"))
  world2, world2_s = dp_tier_world_of_two(torch, compiled_epoch, parallel,
                                          mesh1, families, inputs)
  counts = dp_tier_main_path(torch, (K1, K4, K3, K7, K15, K16),
                             compiled_epoch, parallel, encode_dataset,
                             ista_fista, sub, sparse_coding, mesh1, data)
  times = dp_tier_timing(torch, families, inputs, card)
  print("phase 47: %.1f s (its ranks %.1f s)" % (time.perf_counter() - t0,
                                                 world2_s))
  return dict(errs=errs, planted=planted, stops=stops, counts=counts,
              times=times, world2=world2,
              mods=dict(K3=K3, K7=K7, K15=K15, K16=K16))


# ---------------------------------------------------------------------------
# phase 48: the precision tiers of the conv family (K10, K12, K13, K17;
# csrc/conv_gemm_tier.cuh)
# ---------------------------------------------------------------------------
CONV_TIER_SHARD = 20        # K13's shard, and each rank's at a world of 2
CONV_TIER_DP_STEPS = 10     # the world-of-2 runs, with and without the stop
CONV_TIER_DCN_STEPS = 20    # the 'dcn' composition on the main path (K13)
CONV_TIER_TIME_STEPS = 10   # the steps of each timed K12 / K17 segment
CONV_TIER_WORLD = ("bf16x3", "bf16")  # the tiers of the world of 2
CONV_TIER_CHILD_TIMEOUT = 600  # seconds a rank of phase 48 may take
# phase 48's floors of tier_verdict's bound.  At bf16 a conv solve's codes
# differ from any other rounding of its arithmetic by flips of bf16
# values, whatever the perturbation: over FISTA 100 at the flagship the
# plain version against itself under five one-ulp nudges of its input
# reached 2.6-3.4e-3 of the largest code, of its input and dictionary
# 2.6-3.7e-3, the card's kernel 2.1-3.6e-3 (8 image seeds,
# tools/conv_tier_rounding.py), past phase 46's 2e-3 (about 2^-9) in all
# three, so the kernel against five nudges was a draw; the bound at bf16
# is two bf16 unit roundoffs of the largest code, 2^-7.  The other tiers
# keep phase 46's floors.
CONV_TIER_FLOOR = dict(TIER_FLOOR, bf16=2.0 ** -7)


def conv_tier_bound(geo, b, iters, tier, fp32_flops, nbytes):
  """A conv solve at a tier: corr and iters x (synthesis + analysis), each
  2 * s * R * cpx per position, the tier's passes at the bf16 tensor-core
  rate, beside ``fp32_flops`` (the Gram, the refresh, the update, the
  statistics) at the fp32 rate, the two units' least times overlapped;
  against ``nbytes`` at the HBM rate."""
  depth = 2.0 * geo["s"] * geo["r"] * geo["cpx"]
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  solve = (b * depth * (codes + iters * (blocks + codes))
           * TIER_PASSES[tier] / BF16_PEAK)
  t_ops, t_bytes = max(solve, fp32_flops / FP32_PEAK), nbytes / HBM_RATE
  return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def conv_tier_bounds(geo, tier):
  """{row: (bound_ms, bound_by)} of phase 48's timed rows at a tier: K10 b
  40 FISTA 100 and b 5 ISTA 25 (the images read, the codes written), a
  K12 and a K17 step at b 40 (the refresh and the update fp32; a
  segment's kernels read and written once, conv_dp_bound's bytes), K13 on
  the shard (its statistics fp32, conv_stats_bound's bytes)."""
  depth = 2.0 * geo["s"] * geo["r"] * geo["cpx"]
  blocks, codes = geo["bh"] * geo["bw"], geo["code_h"] * geo["code_w"]
  refresh = depth * geo["s"] + 4.0 * geo["s"] ** 2

  def k10(b, iters):
    return conv_tier_bound(geo, b, iters, tier, 0.0, 4.0 * (
        b * geo["cpx"] * blocks + geo["s"] * geo["r"] * geo["cpx"]
        + b * geo["s"] * codes))

  def stats_fp32(b):
    return refresh + b * 2 * depth * blocks

  kernel = geo["c"] * geo["kh"] * geo["kw"]
  images = geo["c"] * geo["sv"] * geo["sh"] * blocks
  # conv_dp_bound's and conv_stats_bound's bytes
  step_bytes = 4.0 * (SEG_BATCH * images + (
      2 * kernel * geo["s"] + SEG_BATCH * geo["s"] * codes)
                      / CONV_TIER_TIME_STEPS)
  shard_bytes = 4.0 * (CONV_TIER_SHARD * images + kernel * geo["s"]
                       + CONV_TIER_SHARD * geo["s"] * codes
                       + geo["cpx"] * geo["r"] * geo["s"] + geo["s"])
  return {
      "K10 b40": k10(CONV_BATCH, CONV_ITERS),
      "K10 b5": k10(CONV_TRAIN_BATCH, CONV_TRAIN_ITERS),
      "K12 step": conv_tier_bound(geo, SEG_BATCH, SEG_ITERS, tier,
                                  stats_fp32(SEG_BATCH), step_bytes),
      "K13 shard": conv_tier_bound(geo, CONV_TIER_SHARD, SEG_ITERS, tier,
                                   stats_fp32(CONV_TIER_SHARD),
                                   shard_bytes),
      "K17 step": conv_tier_bound(geo, SEG_BATCH, SEG_ITERS, tier,
                                  stats_fp32(SEG_BATCH), step_bytes)}


def conv_tier_families(torch, mods, parallel, lipschitz, inputs):
  """{label: (module, tier counter, steps a call, run(x, mxu, eps=None,
  iters=None), plain(x, mxu, eps=None), input x)} of phase 48's kernel
  cases: K10 at the flagship (b 40 FISTA 100, windowed kernels) and the
  trainer's b 5 ISTA 25 (random kernels), one K12 step and one K17 step at
  measure_conv(40, 25) from the trainer's exact seed, K13 on a shard of
  20 in the gradient and the gram form."""
  K10, K12, K17 = mods
  x40, d40, eta40, x5, d5, eta5, seg, sd0 = inputs
  mesh1 = parallel.make_mesh()
  kw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=((8, 8),
                                                               (8, 8)))
  h0 = torch.zeros(CONV_S, device=x40.device)
  v0 = lipschitz.top_gram_eigenpair(sd0.reshape(CONV_S, -1))[1].contiguous()
  step = dict(kw, power_iters=2)

  def k10(x, d, eta, iters, variant):
    def run(xx, mxu, eps=None, n=None):
      return K10.fused_conv_direct_solve(
          xx, d, CONV_LAM, iters if n is None else n, eta, variant=variant,
          mxu=mxu, early_stopping_epsilon=eps, **kw)

    def plain(xx, mxu, eps=None):
      return K10.fused_conv_direct_plain(
          xx, d, CONV_LAM, iters, eta, variant=variant, mxu=mxu,
          early_stopping_epsilon=eps, **kw)
    return run, plain

  def k12(xx, mxu, eps=None, n=None):
    return K12.fused_conv_train_segment(
        sd0, h0, v0, xx, CONV_LAM, SEG_ITERS if n is None else n, SEG_STEP,
        mxu=mxu, early_stopping_epsilon=eps, **step)

  def k17(xx, mxu, eps=None, n=None):
    return K17.fused_conv_dp_train_segment(
        sd0, h0, v0, xx, CONV_LAM, SEG_ITERS if n is None else n, SEG_STEP,
        mesh=mesh1, mxu=mxu, early_stopping_epsilon=eps, **step)

  def k13(gram):
    def run(xx, mxu, eps=None, n=None):
      return K12.conv_solve_stats(sd0, v0, xx, CONV_LAM, SEG_ITERS,
                                  gram_stats=gram, mxu=mxu, **step)

    def plain(xx, mxu, eps=None):
      return K12.conv_solve_stats_plain(sd0, v0, xx, CONV_LAM, SEG_ITERS,
                                        gram_stats=gram, mxu=mxu, **step)
    return run, plain

  r40, p40 = k10(x40, d40, eta40, CONV_ITERS, "fista")
  r5, p5 = k10(x5, d5, eta5, CONV_TRAIN_ITERS, "ista")
  shard = seg[0, :CONV_TIER_SHARD].contiguous()
  fam = {
      "K10 b40 fista100": (K10, "tier_launches", 1, r40, p40, x40),
      "K10 b5 ista25": (K10, "tier_launches", 1, r5, p5, x5),
      "K12 step": (K12, "tier_launches", 1, k12,
                   lambda xx, mxu, eps=None: K12.fused_conv_train_plain(
                       sd0, h0, v0, xx, CONV_LAM, SEG_ITERS, SEG_STEP,
                       mxu=mxu, early_stopping_epsilon=eps, **step),
                   seg[:1]),
      "K17 step": (K17, "tier_launches", 1, k17,
                   lambda xx, mxu, eps=None: K17.fused_conv_dp_train_plain(
                       sd0, h0, v0, xx, CONV_LAM, SEG_ITERS, SEG_STEP,
                       mesh=mesh1, mxu=mxu, early_stopping_epsilon=eps,
                       **step), seg[:1])}
  for gram in (False, True):
    run, plain = k13(gram)
    fam["K13 shard b20 %s" % ("gram" if gram else "gradient")] = (
        K12, "stats_tier_launches", 1, run, plain, shard)
  return fam


def conv_tier_one_step(torch, families):
  """(a) Each case at each tier against its plain version at the tier
  under tier_verdict's three rules (the spread under five one-ulp nudges
  of the input; the floor CONV_TIER_FLOOR), each call one tier launch, a
  'highest' call none; then
  (b) the kernel's result at each other tier and at 'highest' planted in
  each tier's place, which must fail.  Returns ({(case, tier): err},
  [(case, tier, planted tier, rules failed)])."""
  errs, planted = {}, []
  for name, (mod, counter, steps, run, plain, x) in families.items():
    outs = {}
    for mxu in ("highest",) + TIER_NAMES:
      before = getattr(mod, counter)
      outs[mxu] = flat_cat(torch, run(x, mxu))
      want = 0 if mxu == "highest" else steps
      check(getattr(mod, counter) == before + want, "%s at %s: %d tier "
            "launches, expected %d" % (name, mxu, getattr(mod, counter)
                                       - before, want))
    plains = {mxu: flat_cat(torch, plain(x, mxu))
              for mxu in ("highest",) + TIER_NAMES}
    for tier in TIER_NAMES:
      nudged = [flat_cat(torch, plain(one_ulp_nudge(x, seed), tier))
                for seed in range(5)]
      errs[name, tier] = tier_check(torch, name, outs[tier], outs["highest"],
                                    plains, nudged, tier,
                                    CONV_TIER_FLOOR[tier])["err"]
      for wrong in ("highest",) + TIER_NAMES:
        if wrong == tier:
          continue
        v = tier_verdict(torch, outs[wrong], outs["highest"], plains, nudged,
                         tier, CONV_TIER_FLOOR[tier])
        failed = [rule for rule, ok in v["ok"].items() if not ok]
        planted.append((name, tier, wrong, failed))
        print("tier planted %s: %s in place of %s fails %s" % (
            name, wrong, tier, ", ".join(failed) or "NOTHING"))
        check(failed, "tier %s: the kernel at %s passes every rule held for "
              "%s" % (name, wrong, tier))
  return errs, planted


def conv_tier_stop_cases(torch, families):
  """(c) The stop at each tier: K10 at b 5 (ISTA 25, inside vtc_tpu's one
  tile), one K12 step and one K17 step at b 40, a mid-run eps from the
  plain version's means at the tier: the plain version's count (a case
  whose plain mean lies within 1e-3 relative of eps reported apart),
  bitwise the tier kernel without the stop at that count; K10 at b 40, a
  batch beyond vtc_tpu's tile, refuses a tier with the stop, launching
  nothing.  Returns ({(case, tier): (count, max|d| from plain)}, near)."""
  out, near = {}, []
  for name in ("K10 b5 ista25", "K12 step", "K17 step"):
    mod, _, _, run, plain, x = families[name]
    for tier in TIER_NAMES:
      plain(x, tier, 0.0)
      eps = stop_eps(solver_state()[1], "mid")
      got = run(x, tier, eps)
      it = int(mod.last_iters.reshape(-1)[0].item())
      ref = run(x, tier, None, it)
      want = plain(x, tier, eps)
      plain_it, plain_avgs = solver_state()
      label = "%s %s eps %.4g" % (name, tier, eps)
      check(torch.equal(flat_cat(torch, got), flat_cat(torch, ref)),
            "%s: the stopped run (%d it) differs from the tier kernel's "
            "without the stop at that count" % (label, it))
      if any(abs(a - eps) <= 1e-3 * eps for a in plain_avgs):
        near.append("%s: kernel %d it, plain %d" % (label, it, plain_it))
      else:
        check(it == plain_it, "%s: the kernel ran %d iterations, the plain "
              "version %d" % (label, it, plain_it))
      err = float((flat_cat(torch, got) - flat_cat(torch, want)).abs().max())
      out[name, tier] = (it, err)
      print("tier stop %s: %d of %d it, the plain version's; bitwise the "
            "tier kernel without the stop at the count; max|d| %.3e from "
            "plain" % (label, it, CONV_ITERS if name.startswith("K10 b40")
                       else CONV_TRAIN_ITERS if name.startswith("K10")
                       else SEG_ITERS, err))
  mod, counter, _, run, _, x = families["K10 b40 fista100"]
  before = getattr(mod, counter)
  try:
    run(x, "bf16x3", 1e-3)
  except ValueError as err:
    check("early_stop_supported" in str(err), "K10 b 40 with a tier and "
          "the stop: the refusal names no early_stop_supported: %s" % err)
  else:
    raise RuntimeError("chip_smoke: K10 at b 40 took a tier with the stop, "
                       "beyond vtc_tpu's one tile")
  check(getattr(mod, counter) == before, "the refused K10 launched")
  print("refused on the card: K10 b 40 at bf16x3 with the stop (beyond "
        "vtc_tpu's one K10 tile, early_stop_supported)")
  return out, near


def conv_tier_dcn_runner(parallel, compiled_epoch, mesh, tier):
  """The composition the scanned conv trainer runs on a mesh with a 'dcn'
  axis (compiled_epoch._dp_fused_segment_runner of
  build_dp_conv_fused_local_step: K13 a step) on ``mesh``, at the tier."""
  return compiled_epoch._dp_fused_segment_runner(
      parallel.build_dp_conv_fused_local_step(
          mesh, "fista", "sc_cheap_quadratic_descent",
          kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=((8, 8), (8, 8)),
          power_iters=2, mxu=tier))


def conv_tier_world_runs():
  """(key, tier, with the stop, dcn) of the world of 2's runs."""
  runs = [("%s%s" % (tier, " stop" if stop else ""), tier, stop, 1)
          for tier in CONV_TIER_WORLD for stop in (False, True)]
  return runs + [("bf16x3 dcn=2", "bf16x3", False, 2)]


def conv_tier_rank_main(rank, world, workdir):
  """The hidden sub-command: one rank of phase 48's world of 2.  Joins the
  gloo group over the file store in ``workdir`` and runs the scanned conv
  trainer with data_parallel=True (K17 on shards of 20) for
  CONV_TIER_DP_STEPS steps at each tier of CONV_TIER_WORLD, without and
  with the stop at the eps of inputs.npz, then on a mesh of two slices
  (make_mesh(dcn=2): K13's composition) at bf16x3; saves each
  dictionary, the counts and the tier launches to ``workdir``."""
  import os
  import torch
  import torch.distributed as dist
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.ops import fused_conv_dp_train as K17
  from vtc_tpu_torch.ops import fused_conv_train as K12
  from vtc_tpu_torch.training import compiled_epoch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    return 1
  dev = torch.device("cuda", 0)
  data = dict(np.load(os.path.join(workdir, "inputs.npz")))
  x = torch.tensor(data["x"], device=dev)
  dist.init_process_group("gloo", init_method="file://" + os.path.join(
      workdir, "store"), rank=rank, world_size=world)
  try:
    out = {}
    for key, tier, stop, dcn in conv_tier_world_runs():
      mod, counter = ((K12, "stats_tier_launches") if dcn > 1
                      else (K17, "tier_launches"))
      params = dict(conv_segment_params(CONV_TIER_DP_STEPS, SEG_STEP),
                    train_precision=tier,
                    data_parallel=(True if dcn == 1
                                   else parallel.make_mesh(dcn=dcn)))
      if stop:
        params["early_stopping_epsilon"] = float(data["eps " + tier])
      setattr(mod, counter, 0)
      got = compiled_epoch.train_dictionary_scanned(x, x[:1], data["d"],
                                                    params, device=dev)
      torch.cuda.synchronize()
      out[key + " dictionary"] = got.cpu().numpy()
      out[key + " launches"] = np.array(getattr(mod, counter))
      if stop:
        out[key + " counts"] = K17.last_iters.cpu().numpy()
    np.savez(os.path.join(workdir, "rank%d.npz" % rank), **out)
  finally:
    dist.destroy_process_group()
  return 0


def conv_tier_world_of_two(torch, compiled_epoch, parallel, lipschitz, K17,
                           seg, sd0):
  """(d) The world of 2 (conv_tier_rank_main in two processes of this
  script sharing the card over gloo, phase 45's launcher) against the
  same trainer at a world of 1 on the whole batches: both ranks bitwise
  equal with the same counts; CONV_TIER_DP_STEPS tier steps a rank; the
  counts of the world of 1 (a near eps reported apart); every dictionary
  within the larger of DP_FLOOR, the tier's floor and the world of 1's
  spread under five one-ulp nudges of its batches and start; the 'dcn'
  run against K13's composition on a mesh of one.  Returns ({key: (max|d|
  from the world of 1, bound)}, seconds)."""
  import os
  import tempfile
  mesh1 = parallel.make_mesh()
  xs = seg[:CONV_TIER_DP_STEPS].contiguous()
  data = {"d": sd0.cpu().numpy(), "x": xs.cpu().numpy()}
  h0 = torch.zeros(CONV_S, device=sd0.device)
  v0 = lipschitz.top_gram_eigenpair(sd0.reshape(CONV_S, -1))[1].contiguous()
  kw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=((8, 8), (8, 8)),
            power_iters=2, mesh=mesh1)
  for tier in CONV_TIER_WORLD:
    K17.fused_conv_dp_train_plain(sd0, h0, v0, xs[:1], CONV_LAM, SEG_ITERS,
                                  SEG_STEP, mxu=tier,
                                  early_stopping_epsilon=0.0, **kw)
    data["eps " + tier] = np.array(stop_eps(solver_state()[1], "mid"))
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as workdir:
    np.savez(os.path.join(workdir, "inputs.npz"), **data)
    codes, dt = spawn_ranks("--conv-tier-rank", 2, workdir,
                            CONV_TIER_CHILD_TIMEOUT)
    check(codes == [0, 0], "a rank of phase 48's world of 2 failed: exit "
          "codes %s" % codes)
    ranks = [dict(np.load(os.path.join(workdir, "rank%d.npz" % r)))
             for r in range(2)]
  print("phase 48: 2 processes sharing one card over gloo done in %.1f s"
        % dt)
  results = {}
  for key, tier, stop, dcn in conv_tier_world_runs():
    for what in ("dictionary", "counts"):
      if key + " " + what in ranks[0]:
        check(np.array_equal(ranks[0][key + " " + what],
                             ranks[1][key + " " + what]),
              "phase 48 world of 2 %s: the ranks' %s differ" % (key, what))
    launches = [int(r[key + " launches"]) for r in ranks]
    check(launches == [CONV_TIER_DP_STEPS] * 2, "phase 48 world of 2 %s: "
          "tier launches %s, expected %d a rank" % (key, launches,
                                                    CONV_TIER_DP_STEPS))
    params = dict(conv_segment_params(CONV_TIER_DP_STEPS, SEG_STEP),
                  train_precision=tier, data_parallel=True)
    if stop:
      params["early_stopping_epsilon"] = float(data["eps " + tier])
    if dcn > 1:
      runner = conv_tier_dcn_runner(parallel, compiled_epoch, mesh1, tier)

      def one(x, dd):
        return runner(dd, torch.zeros(CONV_S, device=dd.device),
                      lipschitz.top_gram_eigenpair(
                          dd.reshape(CONV_S, -1))[1].contiguous(),
                      x, CONV_LAM, SEG_ITERS, SEG_STEP)[0]
    else:

      def one(x, dd):
        return compiled_epoch.train_dictionary_scanned(x, x[:1], dd, params)
    want = one(xs, sd0)
    single_counts = K17.last_iters.tolist() if stop else None
    moved = max(float((one(one_ulp_nudge(xs, seed),
                           one_ulp_nudge(sd0, seed + 5)) - want).abs().max())
                for seed in range(5))
    bound = max(DP_FLOOR, TIER_FLOOR[tier] * max(
        1.0, float(want.abs().max())), moved)
    err = float(np.abs(ranks[0][key + " dictionary"]
                       - want.cpu().numpy()).max())
    results[key] = (err, bound)
    note = ""
    if stop:
      counts = ranks[0][key + " counts"].tolist()
      note = "; counts %s (world of 1: %s)" % (counts, single_counts)
      check(counts == single_counts, "phase 48 world of 2 %s: counts %s, "
            "the world of 1's %s" % (key, counts, single_counts))
      check(min(counts) < SEG_ITERS, "phase 48 world of 2 %s: no solve "
            "stopped early" % key)
    print("conv world of 2 %s: ranks bitwise equal, %d tier steps a rank%s;"
          " max|d| %.3e from the world of 1 (bound %.3e)" % (
              key, CONV_TIER_DP_STEPS, note, err, bound))
    check(np.isfinite(ranks[0][key + " dictionary"]).all() and err <= bound,
          "phase 48 world of 2 %s differs from the world of 1 by %.3e > %.3e"
          % (key, err, bound))
  return results, time.perf_counter() - t0


def conv_tier_main_path(torch, mods, compiled_epoch, parallel,
                        encode_dataset, conv_ista_fista, sparse_coding,
                        cimages, conv_d, cpad, seg, held, sd0, card):
  """(e) The main path at each tier and at 'highest', the tier counts
  zeroed just before and read just after: the conv encode_dataset of
  phase 15 (320 images in batches of 40, FISTA 100: 8 K10 tier launches);
  the scanned conv trainer at measure_conv(40, 25), one SEG_STEPS-step
  segment from phase 19's start (SEG_STEPS K12 tier steps), and with
  data_parallel=True at a world of 1 (SEG_STEPS K17 tier steps); the
  'dcn' composition for CONV_TIER_DCN_STEPS steps (K13).  Every
  dictionary finite, its kernels unit norm within 1e-4, its held-out conv
  LASSO falling; printed beside 'highest''s.  Returns ({(module name,
  tier): tier launches}, {(entry, tier): images/s})."""
  K10, K12, K17 = mods
  counters = (("K10", K10, "tier_launches"), ("K12", K12, "tier_launches"),
              ("K13", K12, "stats_tier_launches"),
              ("K17", K17, "tier_launches"))
  want = {"K10": CONV_IMAGES // CONV_BATCH, "K12": SEG_STEPS,
          "K13": CONV_TIER_DCN_STEPS, "K17": SEG_STEPS}
  mesh1 = parallel.make_mesh()
  conv_kw = dict(mode="convolutional", kernel_stride=(CONV_STRIDE,
                                                      CONV_STRIDE),
                 padding=cpad, batch_size=CONV_BATCH, chunk_batches=4)
  loss0 = held_out_fista_conv_loss(conv_ista_fista, sparse_coding, held, sd0)
  # one untimed encode first: the first call's set-up is no tier's cost
  encode_dataset(cimages[:CONV_BATCH], conv_d, CONV_LAM, CONV_ITERS,
                 **conv_kw)
  counts, rates, losses = {}, {}, {}
  for tier in ("highest",) + TIER_NAMES:
    for _, mod, counter in counters:
      setattr(mod, counter, 0)
    t0 = time.perf_counter()
    codes = encode_dataset(cimages, conv_d, CONV_LAM, CONV_ITERS,
                           mxu_precision=tier, **conv_kw)
    rates["encode", tier] = cimages.shape[0] / (time.perf_counter() - t0)
    check(codes.shape == (CONV_IMAGES, CONV_S, 33, 33)
          and bool(np.isfinite(codes).all()), "conv encode at %s: codes of "
          "shape %s, finite %s" % (tier, codes.shape,
                                   np.isfinite(codes).all()))
    for dp in (False, True):
      params = dict(conv_segment_params(SEG_STEPS, SEG_STEP),
                    train_precision=tier)
      if dp:
        params["data_parallel"] = True
      t0 = time.perf_counter()
      trained = compiled_epoch.train_dictionary_scanned(seg, held[None], sd0,
                                                        params)
      torch.cuda.synchronize()
      kind = "data-parallel trainer" if dp else "trainer"
      rates[kind, tier] = SEG_STEPS * SEG_BATCH / (time.perf_counter() - t0)
      norm_err = float((torch.linalg.vector_norm(
          trained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
      loss = held_out_fista_conv_loss(conv_ista_fista, sparse_coding, held,
                                      trained)
      losses[kind, tier] = (loss, norm_err)
      check(bool(torch.isfinite(trained).all()) and norm_err <= 1e-4,
            "conv %s at %s: non-finite or kernels not unit norm (%.3e)" % (
                kind, tier, norm_err))
      check(np.isfinite(loss) and loss < loss0, "conv %s at %s: the "
            "held-out conv LASSO did not fall: %.6f -> %.6f" % (
                kind, tier, loss0, loss))
    runner = conv_tier_dcn_runner(parallel, compiled_epoch, mesh1, tier)
    runner(sd0, torch.zeros(CONV_S, device=sd0.device),
           dp_tier_seed(sd0.reshape(CONV_S, -1)),
           seg[:CONV_TIER_DCN_STEPS].contiguous(), CONV_LAM, SEG_ITERS,
           SEG_STEP)
    torch.cuda.synchronize()
    for name, mod, counter in counters:
      counts[name, tier] = getattr(mod, counter)
    print("conv tier main path %s: tier launches K10 %d, K12 %d, K13 %d, "
          "K17 %d" % (tier, *(counts[n, tier] for n, _, _ in counters)))
    for name, _, _ in counters:
      expected = 0 if tier == "highest" else want[name]
      check(counts[name, tier] == expected, "conv main path at %s: %d tier "
            "launches of %s, expected %d" % (tier, counts[name, tier], name,
                                             expected))
  for tier in TIER_NAMES:
    for kind in ("trainer", "data-parallel trainer"):
      loss, norm_err = losses[kind, tier]
      ref = losses[kind, "highest"][0]
      print("conv tier %s %s: kernels unit norm within %.2e; held-out conv "
            "LASSO %.6f -> %.6f ('highest' %.6f, %+.4f%%)" % (
                kind, tier, norm_err, loss0, loss, ref,
                100.0 * (loss - ref) / ref))
  for kind in ("encode", "trainer", "data-parallel trainer"):
    print("conv tier %s: images/s %s; 'highest' %.2f [%s]" % (
        kind, ", ".join("%s %.2f" % (t, rates[kind, t]) for t in TIER_NAMES),
        rates[kind, "highest"], card))
  return counts, rates


def conv_library_ms(torch, fn):
  """The library time of fn, one call a turn: one warm call, then
  TIER_LIB_TURNS turns; (median, least, most) ms."""
  fn()
  readings = sorted(time_ms(torch, fn, 1) for _ in range(TIER_LIB_TURNS))
  return readings[len(readings) // 2], readings[0], readings[-1]


def conv_tier_timing(torch, K10, families, inputs, geo, card):
  """(f) In turns ('highest', tier, tier, 'highest'): K10 at b 40 FISTA 100
  and b 5 ISTA 25, K13 on the shard (gradient form), and a K12 and a K17
  step of a CONV_TIER_TIME_STEPS-step segment at b 40; the plain version
  at the tier (K12 and K17: one step); the bound (conv_tier_bounds); the
  library time: the same solve with each pass one product of bf16
  operands with a float32 result on the materialized stack
  (fused_conv_direct_library(mxu=)), for K12, K13 and K17 their step's
  solve, and at 'highest' each product one cuDNN call, the median of 7
  turns.  Returns {(row, tier): (ms, plain_ms, bound, library_ms)} with
  'highest' rows too."""
  x40, d40, eta40, x5, d5, eta5, seg, sd0 = inputs
  how, mm = mm_f32_out(torch)
  print("conv tier library time: %s" % how)
  kw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=((8, 8),
                                                               (8, 8)))
  eta_seg = 1.0 / float(torch.linalg.eigvalsh(
      (sd0.reshape(CONV_S, -1) @ sd0.reshape(CONV_S, -1).T).double()).max())
  segx = seg[:CONV_TIER_TIME_STEPS].contiguous()
  shard = seg[0, :CONV_TIER_SHARD].contiguous()
  rows = {
      "K10 b40": ("K10 b40 fista100", x40, 1,
                  lambda m: K10.fused_conv_direct_library(
                      x40, d40, CONV_LAM, CONV_ITERS, eta40, mxu=m, mm=mm,
                      **kw)),
      "K10 b5": ("K10 b5 ista25", x5, 1,
                 lambda m: K10.fused_conv_direct_library(
                     x5, d5, CONV_LAM, CONV_TRAIN_ITERS, eta5,
                     variant="ista", mxu=m, mm=mm, **kw)),
      "K13 shard": ("K13 shard b20 gradient", shard, 1,
                    lambda m: K10.fused_conv_direct_library(
                        shard, sd0, CONV_LAM, SEG_ITERS, eta_seg, mxu=m,
                        mm=mm, **kw)),
      "K12 step": ("K12 step", segx, CONV_TIER_TIME_STEPS,
                   lambda m: K10.fused_conv_direct_library(
                       segx[0], sd0, CONV_LAM, SEG_ITERS, eta_seg, mxu=m,
                       mm=mm, **kw)),
      "K17 step": ("K17 step", segx, CONV_TIER_TIME_STEPS,
                   lambda m: K10.fused_conv_direct_library(
                       segx[0], sd0, CONV_LAM, SEG_ITERS, eta_seg, mxu=m,
                       mm=mm, **kw))}
  out = {}
  with torch.no_grad():
    for row, (family, xt, per, library) in rows.items():
      _, _, _, run, plain, x = families[family]
      reps = 3 if per == 1 else 1
      hi_lib = conv_library_ms(torch, lambda: library("highest"))
      for tier in TIER_NAMES:
        run(xt, tier)  # warm
        turns = [time_ms(torch, lambda: run(xt, "highest"), reps),
                 time_ms(torch, lambda: run(xt, tier), reps),
                 time_ms(torch, lambda: run(xt, tier), reps),
                 time_ms(torch, lambda: run(xt, "highest"), reps)]
        ms = (turns[1] + turns[2]) / 2 / per
        hi_ms = (turns[0] + turns[3]) / 2 / per
        p_ms = time_ms(torch, lambda: plain(x, tier), 1)
        lib = conv_library_ms(torch, lambda: library(tier))
        bnd = conv_tier_bounds(geo, tier)[row]
        out[row, tier] = (ms, p_ms, bnd, lib[0])
        out[row, "highest"] = (hi_ms, None, None, hi_lib[0])
        print("conv tier %s %s: %.4f ms against 'highest' %.4f in turns "
              "(%.4f, %.4f, %.4f, %.4f); plain %.4f; bound %.4f (%s); "
              "library median %.4f (%d turns %.4f-%.4f; 'highest', cuDNN's "
              "products: %.4f) [%s]" % (
                  row, tier, ms, hi_ms, *turns, p_ms, bnd[0], bnd[1], lib[0],
                  TIER_LIB_TURNS, lib[1], lib[2], hi_lib[0], card))
  return out


def conv_tier_phase(torch, dev, card, mods, cimages, conv_d, cpad, x5, d5,
                    eta5, sd0, conv_gen):
  """Phase 48: (a)-(f) above; 'highest' is bitwise what it was: its
  kernels are conv_gemm.cuh's, unchanged, which phases 13-19, 30-32 and
  44 hold to their plain versions, and a 'highest' call launches no tier
  kernel ((a), (e))."""
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.analysis_transforms.convolutional import (
      ista_fista as conv_ista_fista)
  from vtc_tpu_torch.encode import encode_dataset
  from vtc_tpu_torch.ops import convolutions as conv_ops
  from vtc_tpu_torch.ops import lipschitz
  from vtc_tpu_torch.training import compiled_epoch, sparse_coding
  K10, K12, K17 = mods
  t0 = time.perf_counter()
  images = conv_segment_images(torch, conv_ops, dev, SEG_STEPS + 1, conv_gen,
                               seed=19)  # phase 19's
  seg, held = images[:SEG_STEPS], images[SEG_STEPS]
  x40 = torch.tensor(cimages[:CONV_BATCH], device=dev)
  eta40 = lipschitz.fista_stepsize(conv_d.reshape(CONV_S, -1))
  inputs = (x40, conv_d, eta40, x5, d5, eta5, seg, sd0)
  families = conv_tier_families(torch, mods, parallel, lipschitz, inputs)
  errs, planted = conv_tier_one_step(torch, families)
  stops, near = conv_tier_stop_cases(torch, families)
  print("conv tier stop: %d cases at the plain version's counts, bitwise "
        "the kernel without the stop at the count; near eps (reported "
        "apart): %s" % (len(stops), near or "none"))
  world2, world2_s = conv_tier_world_of_two(torch, compiled_epoch, parallel,
                                            lipschitz, K17, seg, sd0)
  counts, rates = conv_tier_main_path(
      torch, mods, compiled_epoch, parallel, encode_dataset, conv_ista_fista,
      sparse_coding, cimages, conv_d, cpad, seg, held, sd0, card)
  geo = K10.geometry(x40.shape, conv_d.shape, (CONV_STRIDE, CONV_STRIDE))
  times = conv_tier_timing(torch, K10, families, inputs, geo, card)
  del images, seg, held
  print("phase 48: %.1f s (its ranks %.1f s); %d planted wrong-tier results "
        "failed" % (time.perf_counter() - t0, world2_s, len(planted)))
  return dict(errs=errs, planted=planted, stops=stops, counts=counts,
              times=times, world2=world2, rates=rates)


def main():
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; the port's smoke run needs an "
          "NVIDIA GPU and has no CPU path", file=sys.stderr)
    return 1
  from vtc_tpu_torch import convert
  from vtc_tpu_torch.api import SparseCoder
  from vtc_tpu_torch.encode import encode_dataset
  from vtc_tpu_torch.ops import _build, fused_fista, lipschitz

  # phase 1: device and build
  dev = torch.device("cuda", 0)
  card = card_line()
  kind = torch.cuda.get_device_name(0)
  print("device:", kind, "| nvidia-smi:", card, "| torch", torch.__version__,
        "cuda", torch.version.cuda)
  t0 = time.perf_counter()
  _build.build(verbose=True)
  _build.load_library()
  print("build: %.1f s (%s)" % (time.perf_counter() - t0,
                                _build.library_path().name))

  t0 = time.perf_counter()
  patches = synthetic_patches(BATCH * NUM_BATCHES)
  print("data: %d synthetic 16x16 patches (pixel std %.4f) in %.1f s" % (
      patches.shape[0], float(patches.std()), time.perf_counter() - t0))

  # phase 2: kernel against plain on the card
  max_err = kernel_cases(torch, fused_fista, lipschitz, patches, dev)

  # phase 3: the slice, through the public entry points
  d_np = unit_rows(np.random.RandomState(0), 256, 256)  # the generator
  dictionary = convert.dictionary_from_numpy(d_np, dev)
  coder = SparseCoder(256, sparsity_weight=LAM, inference_iters=ITERS,
                      formulation="pallas", device=dev)
  coder.dictionary = dictionary
  fused_fista.launches = 0
  codes = encode_dataset(patches, dictionary, LAM, ITERS,
                         batch_size=BATCH, chunk_batches=4)
  codes_api = coder.encode(patches, batch_size=BATCH)
  launches = fused_fista.launches
  print("slice: %d kernel launches for 2 x %d batches" % (
      launches, NUM_BATCHES))
  check(launches == 2 * NUM_BATCHES,
        "expected %d kernel launches, counted %d" % (
            2 * NUM_BATCHES, launches))
  check(codes.shape == (patches.shape[0], 256), "codes shape " +
        str(codes.shape))
  check(bool(np.isfinite(codes).all()), "non-finite codes")
  check(float(np.abs(codes - codes_api).max()) <= limit(codes),
        "SparseCoder.encode differs from encode_dataset")
  k = 5
  eta = lipschitz.fista_stepsize(dictionary)
  x5 = torch.tensor(patches[k * BATCH:(k + 1) * BATCH], device=dev)
  plain5 = fused_fista.fused_fista_plain(x5, dictionary, LAM, ITERS, eta)
  err5 = float(np.abs(codes[k * BATCH:(k + 1) * BATCH]
                      - plain5.cpu().numpy()).max())
  lim = limit(plain5)
  print("slice: batch %d vs plain max|d| %.3e, limit %.3e" % (k, err5, lim))
  check(err5 <= lim, "encoded batch differs from plain by %.3e" % err5)
  recon = coder.decode(codes).cpu().numpy()
  density = float((codes != 0).mean())
  mse = float(np.mean((recon - patches) ** 2))
  energy = float(np.mean(patches ** 2))
  print("slice: code density %.4f, recon MSE %.6f (patch energy %.6f)" % (
      density, mse, energy))
  check(0.0 < density < 1.0 and mse < energy,
        "codes do not explain the patches")

  # phase 4: timing (warm: every shape above has run)
  x0 = torch.tensor(patches[:BATCH], device=dev)
  solve = lambda: fused_fista.fused_fista_solve(x0, dictionary, LAM, ITERS,
                                                eta)
  plain = lambda: fused_fista.fused_fista_plain(x0, dictionary, LAM, ITERS,
                                                eta)
  with torch.no_grad():
    plain_ms = [time_ms(torch, plain, 5)]
    kernel_ms = [time_ms(torch, solve, 20), time_ms(torch, solve, 20)]
    plain_ms.append(time_ms(torch, plain, 5))
  ms = sum(kernel_ms) / 2
  p_ms = sum(plain_ms) / 2
  print("kernel ms per flagship batch (b=2048 s=256 n=256, 100 it): "
        "%.4f (runs %.4f, %.4f) [%s]" % (ms, *kernel_ms, card))
  print("plain ms per flagship batch (b=2048 s=256 n=256, 100 it): "
        "%.4f (runs %.4f, %.4f) [%s]" % (p_ms, *plain_ms, card))
  for formulation in ("pallas", "gram"):
    t0 = time.perf_counter()
    encode_dataset(patches, dictionary, LAM, ITERS, batch_size=BATCH,
                   chunk_batches=4, formulation=formulation)
    dt = time.perf_counter() - t0
    print("encode %-6s %d patches in %.4f s: %.1f patches/s [%s]" % (
        formulation, patches.shape[0], dt, patches.shape[0] / dt, card))

  # phase 5: the fused train step against plain on the card
  from vtc_tpu_torch.analysis_transforms.fully_connected import ista_fista
  from vtc_tpu_torch.ops import fused_train_step
  from vtc_tpu_torch.training import compiled_epoch, sparse_coding
  t0 = time.perf_counter()
  train_patches = synthetic_patches(TRAIN_STEPS * TRAIN_BATCH + TRAIN_BATCH,
                                    seed=1)
  held_out = torch.tensor(train_patches[-TRAIN_BATCH:], device=dev)
  train_patches = train_patches[:-TRAIN_BATCH]
  print("train data: %d synthetic patches in %.1f s" % (
      train_patches.shape[0], time.perf_counter() - t0))
  train_err = train_kernel_cases(torch, fused_train_step, lipschitz,
                                 train_patches, dev)
  rd, rh, rv, rx = refusal_problem(torch, dev)
  check_runs("K2 early_stopping_epsilon", lambda: (
      fused_train_step.fused_train_segment(rd, rh, rv, rx, 0.05, 5, 0.1,
                                           early_stopping_epsilon=1e-3)),
             fused_train_step)

  # phase 6: the trainer through its public entry points
  batches = torch.tensor(train_patches.reshape(TRAIN_STEPS, TRAIN_BATCH,
                                               256), device=dev)
  d0 = convert.dictionary_from_numpy(
      unit_rows(np.random.RandomState(2), 256, 256), dev)
  params = train_params(TRAIN_STEPS)
  fused_train_step.launches = 0
  fused_fista.launches = 0
  trained = compiled_epoch.train_dictionary_scanned(
      batches, held_out[None], d0, params)
  torch.cuda.synchronize()
  train_launches = fused_train_step.launches
  k1_in_segment = fused_fista.launches
  print("trainer: %d fused train steps, %d separate K1 launches" % (
      train_launches, k1_in_segment))
  check(train_launches == TRAIN_STEPS, "expected %d fused train steps, "
        "counted %d" % (TRAIN_STEPS, train_launches))
  check(bool(torch.isfinite(trained).all()), "non-finite dictionary")
  norm_err = float((torch.linalg.vector_norm(trained, dim=1) - 1).abs().max())
  loss0 = held_out_loss(torch, ista_fista, sparse_coding, held_out, d0)
  loss1 = held_out_loss(torch, ista_fista, sparse_coding, held_out, trained)
  print("trainer: rows unit norm within %.2e; held-out LASSO loss %.6f -> "
        "%.6f" % (norm_err, loss0, loss1))
  check(norm_err <= 1e-4, "rows not unit norm: %.3e" % norm_err)
  check(np.isfinite(loss1) and loss1 < loss0,
        "held-out LASSO loss did not fall: %.6f -> %.6f" % (loss0, loss1))
  check_runs("train_dictionary_scanned early_stopping_epsilon", lambda: (
      compiled_epoch.train_dictionary_scanned(
          rx, rx[:1], rd, dict(train_params(2), early_stopping_epsilon=1e-3))),
             fused_train_step)
  check_runs("the raw step's K1 solve with early_stopping_epsilon",
             lambda: sparse_coding.build_raw_step_fn(
                 "fully-connected", "fista", "sc_steepest_descent",
                 fc_formulation="pallas", early_stopping_epsilon=1e-3)(
                     rd, rh, rx[0], 0.05, 10, 0.05, 1, None),
             fused_fista)

  fit_patches = train_patches[:FIT_STEPS * TRAIN_BATCH]
  fitter = SparseCoder(256, sparsity_weight=LAM, inference_iters=TRAIN_ITERS,
                       update_stepsize=TRAIN_STEP, formulation="pallas",
                       device=dev)
  fused_fista.launches = 0
  fitter.fit(fit_patches, num_epochs=1, batch_size=TRAIN_BATCH)
  torch.cuda.synchronize()
  fit_launches = fused_fista.launches
  print("fit: %d K1 launches for %d steps" % (fit_launches, FIT_STEPS))
  check(fit_launches == FIT_STEPS, "expected %d K1 launches in fit, "
        "counted %d" % (FIT_STEPS, fit_launches))
  check(bool(torch.isfinite(fitter.dictionary).all()),
        "fit: non-finite dictionary")

  # phase 7: timing (warm)
  h0 = torch.zeros(256, device=dev)
  v0 = lipschitz.top_gram_eigenpair(d0)[1].contiguous()
  seg = batches[:100]
  step_args = (d0, h0, v0, seg, LAM, TRAIN_ITERS, TRAIN_STEP)
  fused = lambda: fused_train_step.fused_train_segment(*step_args,
                                                       power_iters=2)
  plain = lambda: fused_train_step.fused_train_segment_plain(*step_args,
                                                             power_iters=2)
  with torch.no_grad():
    fused()
    plain_step = [time_ms(torch, plain, 1) / 100]
    fused_step = [time_ms(torch, fused, 3) / 100, time_ms(torch, fused, 3)
                  / 100]
    plain_step.append(time_ms(torch, plain, 1) / 100)
  step_ms = sum(fused_step) / 2
  plain_step_ms = sum(plain_step) / 2
  print("fused train step ms (b=250 s=n=256, 25 it, cheap-quad): %.4f "
        "(runs %.4f, %.4f) [%s]" % (step_ms, *fused_step, card))
  print("plain train step ms (b=250 s=n=256, 25 it, cheap-quad): %.4f "
        "(runs %.4f, %.4f) [%s]" % (plain_step_ms, *plain_step, card))
  t0 = time.perf_counter()
  compiled_epoch.train_dictionary_scanned(batches, held_out[None], d0,
                                          params)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  print("train_dictionary_scanned %d steps of %d in %.4f s: %.1f "
        "patches/s [%s]" % (TRAIN_STEPS, TRAIN_BATCH, dt,
                            TRAIN_STEPS * TRAIN_BATCH / dt, card))

  # phase 8: K4 against plain on the card
  from vtc_tpu_torch.analysis_transforms.fully_connected import (
      subspace_ista_fista as sub)
  from vtc_tpu_torch.ops import fused_group_fista, fused_group_train_step
  t0 = time.perf_counter()
  gpatches = group_patches(BATCH * NUM_BATCHES)
  print("group data: %d group-sparse patches in %.1f s" % (
      gpatches.shape[0], time.perf_counter() - t0))
  group_err = group_kernel_cases(torch, fused_group_fista, sub, lipschitz,
                                 gpatches, dev)
  check_runs("K4 early_stopping_epsilon", lambda: (
      fused_group_fista.fused_group_fista_solve(
          rx[0], rd, GROUP_SIZE, 0.1, 20, 0.05, early_stopping_epsilon=1e-3)),
             fused_group_fista)
  check_runs("subspace run('pallas') early_stopping_epsilon", lambda: (
      sub.run(rx[0], rd, contiguous_groups(24, GROUP_SIZE), 0.1, 20,
              formulation="pallas", early_stopping_epsilon=1e-2)),
             fused_group_fista)

  # phase 9: the subspace encode slice through encode_dataset
  groups = contiguous_groups(256, GROUP_SIZE)
  fused_group_fista.launches = 0
  gcodes = encode_dataset(gpatches, dictionary, LAM, ITERS,
                          batch_size=BATCH, chunk_batches=4,
                          group_assignments=groups)
  group_launches = fused_group_fista.launches
  print("subspace slice: %d K4 launches for %d batches" % (group_launches,
                                                           NUM_BATCHES))
  check(group_launches == NUM_BATCHES, "expected %d K4 launches, counted "
        "%d" % (NUM_BATCHES, group_launches))
  check(gcodes.shape == (gpatches.shape[0], 256), "group codes shape "
        + str(gcodes.shape))
  check(bool(np.isfinite(gcodes).all()), "non-finite group codes")
  gather, mask, _ = sub.group_layout(groups, 256, dev)
  gdict = sub.build_grouped_dictionary(dictionary, gather, mask)
  geta = lipschitz.fista_stepsize(gdict)
  x5 = torch.tensor(gpatches[k * BATCH:(k + 1) * BATCH], device=dev)
  plain5 = fused_group_fista.fused_group_fista_plain(
      x5, gdict, GROUP_SIZE, LAM, ITERS, geta)  # contiguous: packed == s
  err5 = float(np.abs(gcodes[k * BATCH:(k + 1) * BATCH]
                      - plain5.cpu().numpy()).max())
  lim = limit(plain5)
  gdensity = float((gcodes != 0).mean())
  print("subspace slice: batch %d vs plain max|d| %.3e, limit %.3e; code "
        "density %.4f" % (k, err5, lim, gdensity))
  check(err5 <= lim, "group-encoded batch differs from plain by %.3e"
        % err5)
  check(0.0 < gdensity < 1.0, "group codes all zero or all dense")

  # phase 10: K6 against plain on the card
  t0 = time.perf_counter()
  gtrain = group_patches(TRAIN_STEPS * TRAIN_BATCH + TRAIN_BATCH, seed=1)
  gheld = torch.tensor(gtrain[-TRAIN_BATCH:], device=dev)
  gtrain = gtrain[:-TRAIN_BATCH]
  print("group train data: %d patches in %.1f s" % (
      gtrain.shape[0], time.perf_counter() - t0))
  group_train_err = group_train_kernel_cases(
      torch, fused_group_train_step, sub, lipschitz, gtrain, dev)
  check_runs("K6 early_stopping_epsilon", lambda: (
      fused_group_train_step.fused_group_train_segment(
          rd, rh, rv, rx, 0.05, 5, 0.1,
          group_assignments=contiguous_groups(24, GROUP_SIZE),
          early_stopping_epsilon=1e-3)), fused_group_train_step)

  # phase 11: the subspace trainer through train_dictionary_scanned
  gbatches = torch.tensor(gtrain.reshape(TRAIN_STEPS, TRAIN_BATCH, 256),
                          device=dev)
  gparams = subspace_train_params(TRAIN_STEPS, SUB_STEP)
  fused_group_train_step.launches = 0
  gtrained = compiled_epoch.train_dictionary_scanned(
      gbatches, gheld[None], d0, gparams)
  torch.cuda.synchronize()
  group_train_launches = fused_group_train_step.launches
  print("subspace trainer: %d fused group train steps" %
        group_train_launches)
  check(group_train_launches == TRAIN_STEPS, "expected %d fused group "
        "train steps, counted %d" % (TRAIN_STEPS, group_train_launches))
  check(bool(torch.isfinite(gtrained).all()), "non-finite dictionary")
  norm_err = float((torch.linalg.vector_norm(gtrained, dim=1)
                    - 1).abs().max())
  gloss0 = held_out_group_loss(torch, sub, sparse_coding, gheld, d0, groups)
  gloss1 = held_out_group_loss(torch, sub, sparse_coding, gheld, gtrained,
                               groups)
  print("subspace trainer: rows unit norm within %.2e; held-out group-LASSO "
        "loss %.6f -> %.6f (stepsize %g)" % (norm_err, gloss0, gloss1,
                                             SUB_STEP))
  check(norm_err <= 1e-4, "rows not unit norm: %.3e" % norm_err)
  check(np.isfinite(gloss1) and gloss1 < gloss0,
        "held-out group-LASSO loss did not fall: %.6f -> %.6f" % (
            gloss0, gloss1))
  check_runs("subspace train_dictionary_scanned early_stopping_epsilon",
             lambda: compiled_epoch.train_dictionary_scanned(
                 rx, rx[:1], rd, dict(
                     subspace_train_params(2, SUB_STEP),
                     group_assignments=contiguous_groups(24, GROUP_SIZE),
                     early_stopping_epsilon=1e-3)),
             fused_group_train_step)

  # phase 46's data: phases 3, 6, 9 and 11's, before later phases reuse
  # their names
  tier_data = dict(patches=patches, gpatches=gpatches,
                   dictionary=dictionary, groups=groups,
                   batches=batches, held_out=held_out, d0=d0, params=params,
                   loss0=loss0, loss1=loss1, trained=trained,
                   gbatches=gbatches, gheld=gheld, gparams=gparams,
                   gloss0=gloss0, gloss1=gloss1, gtrained=gtrained)

  # phase 12: subspace timing (warm)
  xg = torch.tensor(gpatches[:BATCH], device=dev)
  gsolve = lambda: fused_group_fista.fused_group_fista_solve(
      xg, gdict, GROUP_SIZE, LAM, ITERS, geta)
  gplain = lambda: fused_group_fista.fused_group_fista_plain(
      xg, gdict, GROUP_SIZE, LAM, ITERS, geta)
  with torch.no_grad():
    gplain_ms = [time_ms(torch, gplain, 5)]
    gkernel_ms = [time_ms(torch, gsolve, 20), time_ms(torch, gsolve, 20)]
    gplain_ms.append(time_ms(torch, gplain, 5))
  g_ms, gp_ms = sum(gkernel_ms) / 2, sum(gplain_ms) / 2
  print("K4 ms per flagship batch (b=2048 64x4 groups, n=256, 100 it): "
        "%.4f (runs %.4f, %.4f) [%s]" % (g_ms, *gkernel_ms, card))
  print("group plain ms per flagship batch (b=2048 64x4 groups, n=256, "
        "100 it): %.4f (runs %.4f, %.4f) [%s]" % (gp_ms, *gplain_ms, card))
  for formulation in ("pallas", "gram"):
    t0 = time.perf_counter()
    encode_dataset(gpatches, dictionary, LAM, ITERS, batch_size=BATCH,
                   chunk_batches=4, formulation=formulation,
                   group_assignments=groups)
    dt = time.perf_counter() - t0
    print("subspace encode %-6s %d patches in %.4f s: %.1f patches/s [%s]"
          % (formulation, gpatches.shape[0], dt, gpatches.shape[0] / dt,
             card))
  gv0 = lipschitz.top_gram_eigenpair(d0)[1].contiguous()  # 64 x 4: Dg = D
  gseg = gbatches[:100]
  gstep_args = (d0, h0, gv0, gseg, LAM, TRAIN_ITERS, SUB_STEP)
  gfused = lambda: fused_group_train_step.fused_group_train_segment(
      *gstep_args, group_assignments=groups, power_iters=2)
  gplain_step = lambda: (
      fused_group_train_step.fused_group_train_segment_plain(
          *gstep_args, group_assignments=groups, power_iters=2))
  with torch.no_grad():
    gfused()
    gp_step = [time_ms(torch, gplain_step, 1) / 100]
    gf_step = [time_ms(torch, gfused, 3) / 100,
               time_ms(torch, gfused, 3) / 100]
    gp_step.append(time_ms(torch, gplain_step, 1) / 100)
  gstep_ms, gplain_step_ms = sum(gf_step) / 2, sum(gp_step) / 2
  print("K6 fused group train step ms (b=250 64x4 groups, n=256, 25 it, "
        "cheap-quad): %.4f (runs %.4f, %.4f) [%s]" % (gstep_ms, *gf_step,
                                                       card))
  print("plain group train step ms (b=250 64x4 groups, n=256, 25 it, "
        "cheap-quad): %.4f (runs %.4f, %.4f) [%s]" % (gplain_step_ms,
                                                       *gp_step, card))
  t0 = time.perf_counter()
  compiled_epoch.train_dictionary_scanned(gbatches, gheld[None], d0, gparams)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  print("subspace train_dictionary_scanned %d steps of %d in %.4f s: %.1f "
        "patches/s [%s]" % (TRAIN_STEPS, TRAIN_BATCH, dt,
                            TRAIN_STEPS * TRAIN_BATCH / dt, card))


  # phase 13: K10 against plain on the card
  from vtc_tpu_torch.analysis_transforms.convolutional import (
      ista_fista as conv_ista_fista)
  from vtc_tpu_torch.ops import fused_conv_direct as K10
  from vtc_tpu_torch.ops import fused_conv_fista as K11
  from vtc_tpu_torch.ops import convolutions as conv_ops
  t0 = time.perf_counter()
  conv_gen = windowed_kernels(np.random.RandomState(0), CONV_S, 1, CONV_K)
  cimages, cpad = conv_images(torch, conv_ops, dev, CONV_IMAGES, conv_gen,
                              CONV_STRIDE, CONV_IMG, seed=0)
  print("conv data: %d synthetic %s images (pixel std %.4f) in %.1f s" % (
      cimages.shape[0], "x".join(map(str, cimages.shape[1:])),
      float(cimages.std()), time.perf_counter() - t0))
  check(cimages.shape[1:] == (1, 272, 272) and cpad == ((8, 8), (8, 8)),
        "conv geometry %s %s" % (cimages.shape, cpad))
  conv_err, k10_codes = conv_kernel_cases(torch, K10, conv_ops, lipschitz,
                                          cimages, conv_gen, cpad, dev)
  rcx = torch.tensor(cimages[:2], device=dev)
  rck = torch.tensor(conv_gen, device=dev)
  rckw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=cpad)
  check_runs("K10 early_stopping_epsilon", lambda: (
      K10.fused_conv_direct_solve(rcx, rck, CONV_LAM, 5, 0.1,
                                  early_stopping_epsilon=1e-3, **rckw)), K10)
  rceta = lipschitz.fista_stepsize(rck.reshape(CONV_S, -1))
  check_tier_runs(torch, "conv run('pallas') mxu_precision='default'",
                  lambda xx, mxu: conv_ista_fista.run(
                      xx, rck, (CONV_STRIDE, CONV_STRIDE), cpad, CONV_LAM, 5,
                      formulation="pallas", stepsize=rceta,
                      mxu_precision="default" if mxu == "bf16" else mxu),
                  lambda xx, mxu: K10.fused_conv_direct_plain(
                      xx, rck, CONV_LAM, 5, rceta, mxu=mxu, **rckw),
                  rcx, K10, "tier_launches", "bf16")

  # phase 14: K11 against plain and K10, and the serving path K10's gate
  # turns away
  conv_err_gram = conv_gram_cases(torch, K11, lipschitz, cimages, conv_gen,
                                  cpad, k10_codes, dev)
  check_runs("K11 early_stopping_epsilon", lambda: (
      K11.fused_conv_fista_solve(rcx, rck, CONV_LAM, 5, 0.1,
                                 early_stopping_epsilon=1e-3, **rckw)), K11)
  gen3 = windowed_kernels(np.random.RandomState(7), CONV_S, 3, 32)
  x3, pad3 = conv_images(torch, conv_ops, dev, 16, gen3, 16, CONV_IMG,
                         seed=7)
  check(x3.shape[1:] == (3, 288, 288), "K11 serving geometry %s" % (
      x3.shape,))
  check(not K10.supported(x3[:8].shape, gen3.shape, (16, 16)),
        "K10's gate should turn 3x32x32 / 16 away")
  d3 = convert.dictionary_from_numpy(gen3, dev)
  K10.launches = K11.launches = 0
  codes3 = encode_dataset(x3, d3, CONV_LAM, CONV_ITERS, mode="convolutional",
                          kernel_stride=(16, 16), padding=pad3, batch_size=8,
                          formulation="pallas")
  k11_launches = K11.launches
  print("K11 serving path: %d K11 and %d K10 launches for 2 batches of 8 "
        "3x288x288 images" % (k11_launches, K10.launches))
  check(k11_launches == 2 and K10.launches == 0,
        "expected 2 K11 launches and no K10, counted %d and %d" % (
            k11_launches, K10.launches))
  eta3 = lipschitz.fista_stepsize(d3.reshape(CONV_S, -1))
  plain3 = K11.fused_conv_fista_plain(
      torch.tensor(x3[8:], device=dev), d3, CONV_LAM, CONV_ITERS, eta3,
      kernel_stride=(16, 16), padding=pad3)
  err3 = float(np.abs(codes3[8:] - plain3.cpu().numpy()).max())
  print("K11 serving path: batch 1 vs plain max|d| %.3e, limit %.3e; code "
        "density %.4f" % (err3, limit(plain3), float((codes3 != 0).mean())))
  check(bool(np.isfinite(codes3).all()) and err3 <= limit(plain3),
        "K11-encoded batch differs from plain by %.3e" % err3)
  conv_err_gram = max(conv_err_gram, err3)

  # phase 15: the conv serving slice through encode_dataset
  conv_d = convert.dictionary_from_numpy(conv_gen, dev)
  conv_kw = dict(mode="convolutional", kernel_stride=(CONV_STRIDE,
                                                      CONV_STRIDE),
                 padding=cpad, batch_size=CONV_BATCH, chunk_batches=4)
  K10.launches = K11.launches = 0
  ccodes = encode_dataset(cimages, conv_d, CONV_LAM, CONV_ITERS, **conv_kw)
  conv_launches = K10.launches
  n_conv_batches = CONV_IMAGES // CONV_BATCH
  print("conv slice: %d K10 launches (%d K11) for %d batches" % (
      conv_launches, K11.launches, n_conv_batches))
  check(conv_launches == n_conv_batches and K11.launches == 0,
        "expected %d K10 launches, counted %d" % (n_conv_batches,
                                                 conv_launches))
  check(ccodes.shape == (CONV_IMAGES, CONV_S, 33, 33),
        "conv codes shape " + str(ccodes.shape))
  check(bool(np.isfinite(ccodes).all()), "non-finite conv codes")
  ceta = lipschitz.fista_stepsize(conv_d.reshape(CONV_S, -1))
  xk = torch.tensor(cimages[k * CONV_BATCH:(k + 1) * CONV_BATCH], device=dev)
  cplain = K10.fused_conv_direct_plain(
      xk, conv_d, CONV_LAM, CONV_ITERS, ceta,
      kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=cpad)
  cerr = float(np.abs(ccodes[k * CONV_BATCH:(k + 1) * CONV_BATCH]
                      - cplain.cpu().numpy()).max())
  cdensity = float((ccodes != 0).mean())
  print("conv slice: batch %d vs plain max|d| %.3e, limit %.3e; code "
        "density %.4f" % (k, cerr, limit(cplain), cdensity))
  check(cerr <= limit(cplain), "conv-encoded batch differs from plain by "
        "%.3e" % cerr)
  check(0.0 < cdensity < 1.0, "conv codes all zero or all dense")

  # phase 16: the per-batch conv trainer through train_dictionary
  t0 = time.perf_counter()
  ctrain, _ = conv_images(torch, conv_ops, dev,
                          CONV_TRAIN_STEPS * CONV_TRAIN_BATCH
                          + CONV_TRAIN_BATCH, conv_gen, CONV_STRIDE,
                          CONV_IMG, seed=1)
  cheld = torch.tensor(ctrain[-CONV_TRAIN_BATCH:], device=dev)
  cbatches = torch.tensor(ctrain[:-CONV_TRAIN_BATCH].reshape(
      (CONV_TRAIN_STEPS, CONV_TRAIN_BATCH) + ctrain.shape[1:]), device=dev)
  print("conv train data: %d images in %.1f s" % (
      CONV_TRAIN_STEPS * CONV_TRAIN_BATCH, time.perf_counter() - t0))
  cd0 = convert.dictionary_from_numpy(
      unit_kernels(np.random.RandomState(2), CONV_S, 1, CONV_K), dev)
  cparams = conv_train_params(CONV_TRAIN_STEPS)
  K10.launches = K11.launches = 0
  t0 = time.perf_counter()
  ctrained = sparse_coding.train_dictionary(cbatches, cheld[None], cd0,
                                            cparams)
  torch.cuda.synchronize()
  ctrain_s = time.perf_counter() - t0
  conv_train_launches = K10.launches
  print("conv trainer: %d K10 launches (%d K11) for %d steps" % (
      conv_train_launches, K11.launches, CONV_TRAIN_STEPS))
  check(conv_train_launches == CONV_TRAIN_STEPS and K11.launches == 0,
        "expected %d K10 launches in the conv trainer, counted %d" % (
            CONV_TRAIN_STEPS, conv_train_launches))
  check(bool(torch.isfinite(ctrained).all()), "non-finite conv kernels")
  cnorm_err = float((torch.linalg.vector_norm(
      ctrained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
  closs0 = held_out_conv_loss(conv_ista_fista, sparse_coding, cheld, cd0)
  closs1 = held_out_conv_loss(conv_ista_fista, sparse_coding, cheld,
                              ctrained)
  print("conv trainer: kernels unit norm within %.2e; held-out conv LASSO "
        "loss %.6f -> %.6f (stepsize %g, %d steps)" % (
            cnorm_err, closs0, closs1, CONV_TRAIN_STEP, CONV_TRAIN_STEPS))
  check(cnorm_err <= 1e-4, "kernels not unit norm: %.3e" % cnorm_err)
  check(np.isfinite(closs1) and closs1 < closs0,
        "held-out conv LASSO loss did not fall: %.6f -> %.6f" % (
            closs0, closs1))
  check_runs("conv train_dictionary early_stopping_epsilon", lambda: (
      sparse_coding.train_dictionary(
          cbatches[:2], cheld[None], cd0,
          dict(conv_train_params(2), early_stopping_epsilon=1e-3))), K10)

  # phase 17: conv timing (warm)
  xc = torch.tensor(cimages[:CONV_BATCH], device=dev)
  ckw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=cpad)
  k10_run = lambda: K10.fused_conv_direct_solve(xc, conv_d, CONV_LAM,
                                                CONV_ITERS, ceta, **ckw)
  k10_plain = lambda: K10.fused_conv_direct_plain(xc, conv_d, CONV_LAM,
                                                  CONV_ITERS, ceta, **ckw)
  # K10's library time: the same loop with each product one cuDNN call
  # (conv2d, conv_transpose2d; TF32 off), not a kernel of the port
  k10_library = lambda: K10.fused_conv_direct_library(
      xc, conv_d, CONV_LAM, CONV_ITERS, ceta, **ckw)
  k11_run = lambda: K11.fused_conv_fista_solve(xc, conv_d, CONV_LAM,
                                               CONV_ITERS, ceta, **ckw)
  k11_plain = lambda: K11.fused_conv_fista_plain(xc, conv_d, CONV_LAM,
                                                 CONV_ITERS, ceta, **ckw)
  xt5 = cbatches[0]
  eta5 = lipschitz.fista_stepsize(cd0.reshape(CONV_S, -1))
  k10_b5 = lambda: K10.fused_conv_direct_solve(
      xt5, cd0, CONV_LAM, CONV_TRAIN_ITERS, eta5, variant="ista", **ckw)
  k10_b5_plain = lambda: K10.fused_conv_direct_plain(
      xt5, cd0, CONV_LAM, CONV_TRAIN_ITERS, eta5, variant="ista", **ckw)
  with torch.no_grad():
    for fn in (k10_run, k11_run, k10_b5):
      fn()
    k10_plain_ms = [time_ms(torch, k10_plain, 2)]
    k10_ms_runs = [time_ms(torch, k10_run, 3), time_ms(torch, k10_run, 3)]
    k10_plain_ms.append(time_ms(torch, k10_plain, 2))
    k10_library()
    k10_lib_ms = [time_ms(torch, k10_library, 2),
                  time_ms(torch, k10_library, 2)]
    k11_plain_ms = [time_ms(torch, k11_plain, 2)]
    k11_ms_runs = [time_ms(torch, k11_run, 3), time_ms(torch, k11_run, 3)]
    k11_plain_ms.append(time_ms(torch, k11_plain, 2))
    b5_plain_ms = [time_ms(torch, k10_b5_plain, 5)]
    b5_ms_runs = [time_ms(torch, k10_b5, 10), time_ms(torch, k10_b5, 10)]
    b5_plain_ms.append(time_ms(torch, k10_b5_plain, 5))
    eig_ms = time_ms(torch, lambda: lipschitz.fista_stepsize(
        conv_d.reshape(CONV_S, -1)), 20)
  k10_ms, k10_p_ms = sum(k10_ms_runs) / 2, sum(k10_plain_ms) / 2
  k11_ms, k11_p_ms = sum(k11_ms_runs) / 2, sum(k11_plain_ms) / 2
  b5_ms, b5_p_ms = sum(b5_ms_runs) / 2, sum(b5_plain_ms) / 2
  geo = K10.geometry(xc.shape, conv_d.shape, (CONV_STRIDE, CONV_STRIDE))
  k10_bound, k10_by = conv_direct_bound(geo, CONV_BATCH, CONV_ITERS)
  b5_bound, _ = conv_direct_bound(geo, CONV_TRAIN_BATCH, CONV_TRAIN_ITERS)
  op, _ = K11.operator_and_corr(xc, conv_d, (CONV_STRIDE, CONV_STRIDE), cpad)
  k11_bound, k11_by = conv_gram_bound(op, CONV_BATCH, CONV_ITERS)
  k10_flops = k10_bound * 1e-3 * FP32_PEAK  # operations bound it
  print("K10 ms per flagship batch (b=40 1x272x272, 64 16x16/8, fista 100): "
        "%.4f (runs %.4f, %.4f), %.2f TFLOP/s, %.1f%% of the fp32 peak; "
        "plain %.4f (runs %.4f, %.4f); bound %.4f (%s) [%s]" % (
            k10_ms, *k10_ms_runs, k10_flops / k10_ms / 1e9,
            100 * k10_bound / k10_ms, k10_p_ms, *k10_plain_ms, k10_bound,
            k10_by, card))
  k10_lib = sum(k10_lib_ms) / 2
  lib_codes, run_codes = k10_library(), k10_run()
  print("K10's loop with cuDNN's products (conv2d, conv_transpose2d, TF32 "
        "off) ms per flagship batch: %.4f (runs %.4f, %.4f), %.2f TFLOP/s; "
        "max|d| from K10 %.3e (limit %.3e) [%s]" % (
            k10_lib, *k10_lib_ms, k10_flops / k10_lib / 1e9,
            float((lib_codes - run_codes).abs().max()), limit(run_codes),
            card))
  # which kernel served each gathered GEMM (not main-path counts)
  k10_gemm = gemm_profile(torch, k10_run)
  k11_gemm = gemm_profile(torch, k11_run)
  print("gathered GEMM launches (profiled): K10 flagship solve %d tiled "
        "(%.4f ms), %d line; K11 flagship solve %d tiled (its interior, "
        "%.4f ms), %d line (rows, columns, corners, %.4f ms) [%s]" % (
            k10_gemm["tiled"][0], k10_gemm["tiled"][1], k10_gemm["line"][0],
            k11_gemm["tiled"][0], k11_gemm["tiled"][1], k11_gemm["line"][0],
            k11_gemm["line"][1], card))
  check(k10_gemm["tiled"][0] == 2 * CONV_ITERS + 1
        and k10_gemm["line"][0] == 0,
        "K10's products did not all take the tiled GEMM: %s" % (k10_gemm,))
  check(k11_gemm["tiled"][0] == CONV_ITERS and k11_gemm["line"][0] > 0,
        "K11's interior should take the tiled GEMM, its lines the line "
        "kernel: %s" % (k11_gemm,))
  print("K11 ms per flagship batch (b=40 1x272x272, 64 16x16/8, fista 100): "
        "%.4f (runs %.4f, %.4f); plain %.4f (runs %.4f, %.4f); bound %.4f "
        "(%s) [%s]" % (k11_ms, *k11_ms_runs, k11_p_ms, *k11_plain_ms,
                       k11_bound, k11_by, card))
  print("K10 ms per trainer batch (b=5, ista 25): %.4f (runs %.4f, %.4f); "
        "plain %.4f (runs %.4f, %.4f); bound %.4f [%s]" % (
            b5_ms, *b5_ms_runs, b5_p_ms, *b5_plain_ms, b5_bound, card))
  print("stepsize eigvalsh ms (64 x 256 flattened kernels): %.4f [%s]" % (
      eig_ms, card))
  for formulation in ("pallas", "gram"):
    t0 = time.perf_counter()
    encode_dataset(cimages, conv_d, CONV_LAM, CONV_ITERS,
                   formulation=formulation, **conv_kw)
    dt = time.perf_counter() - t0
    print("conv encode %-6s %d images in %.4f s: %.2f images/s [%s]" % (
        formulation, CONV_IMAGES, dt, CONV_IMAGES / dt, card))
  print("conv train_dictionary %d steps of %d in %.4f s: %.2f images/s "
        "(first run, build excluded) [%s]" % (
            CONV_TRAIN_STEPS, CONV_TRAIN_BATCH, ctrain_s,
            CONV_TRAIN_STEPS * CONV_TRAIN_BATCH / ctrain_s, card))

  # phase 18: K12 against plain on the card
  from vtc_tpu_torch.analysis_transforms.fully_connected import (
      invertible_linear)
  from vtc_tpu_torch.api import ICACoder, PCACoder
  from vtc_tpu_torch.ops import fused_conv_train as K12
  from vtc_tpu_torch.ops import fused_ica_train as K8
  from vtc_tpu_torch.training import ica
  k12_err = conv_train_kernel_cases(torch, K12, conv_ops, lipschitz, cimages,
                                    conv_gen, cpad, dev)

  # phase 19: the scanned conv trainer, one 200-step segment of 40 images
  t0 = time.perf_counter()
  seg_images = conv_segment_images(torch, conv_ops, dev, SEG_STEPS + 1,
                                   conv_gen, seed=19)
  seg_held = seg_images[SEG_STEPS]
  seg_batches = seg_images[:SEG_STEPS]
  torch.cuda.synchronize()
  print("conv segment data: %d images (%.2f GB) made on the card in %.1f s"
        % (SEG_STEPS * SEG_BATCH, seg_batches.numel() * 4 / 1e9,
           time.perf_counter() - t0))
  sd0 = convert.dictionary_from_numpy(
      windowed_kernels(np.random.RandomState(2), CONV_S, 1, CONV_K), dev)
  K12.launches = K10.launches = K11.launches = 0
  t0 = time.perf_counter()
  strained = compiled_epoch.train_dictionary_scanned(
      seg_batches, seg_held[None], sd0,
      conv_segment_params(SEG_STEPS, SEG_STEP))
  torch.cuda.synchronize()
  seg_s = time.perf_counter() - t0
  k12_launches, k10_in_segment = K12.launches, K10.launches + K11.launches
  print("conv scanned trainer: %d K12 steps, %d separate K10/K11 solves" % (
      k12_launches, k10_in_segment))
  check(k12_launches == SEG_STEPS and k10_in_segment == 0,
        "expected %d K12 steps and no K10 solve, counted %d and %d" % (
            SEG_STEPS, k12_launches, k10_in_segment))
  check(bool(torch.isfinite(strained).all()), "non-finite conv kernels")
  snorm_err = float((torch.linalg.vector_norm(
      strained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
  sloss0 = held_out_fista_conv_loss(conv_ista_fista, sparse_coding,
                                    seg_held, sd0)
  sloss1 = held_out_fista_conv_loss(conv_ista_fista, sparse_coding,
                                    seg_held, strained)
  print("conv scanned trainer: kernels unit norm within %.2e; held-out conv "
        "LASSO loss %.6f -> %.6f (stepsize %g, %d steps)" % (
            snorm_err, sloss0, sloss1, SEG_STEP, SEG_STEPS))
  check(snorm_err <= 1e-4, "kernels not unit norm: %.3e" % snorm_err)
  check(np.isfinite(sloss1) and sloss1 < sloss0,
        "held-out conv LASSO loss did not fall: %.6f -> %.6f" % (sloss0,
                                                                 sloss1))

  # phase 20: K8 against plain on the card
  g = torch.Generator(device=dev).manual_seed(20)
  mixing = torch.tensor(random_mixing(ICA_N, 21), device=dev)
  t0 = time.perf_counter()
  ica_x = laplace_mixtures(torch, dev, (ICA_STEPS + 4) * ICA_BATCH, mixing, g)
  torch.cuda.synchronize()
  print("ICA data: %d Laplace mixtures (n %d, %.0f MB) made on the card in "
        "%.1f s" % (ica_x.shape[0], ICA_N, ica_x.numel() * 4 / 2**20,
                    time.perf_counter() - t0))
  k8_err = ica_kernel_cases(torch, K8, invertible_linear, dev)

  # phase 21: the ICA trainers, PCA and the coders
  ica_held = ica_x[ICA_STEPS * ICA_BATCH:]
  ica_batches = ica_x[:ICA_STEPS * ICA_BATCH].reshape(ICA_STEPS, ICA_BATCH,
                                                      ICA_N)
  id0 = convert.dictionary_from_numpy(random_orthogonal(ICA_N, 12), dev)
  K8.launches = 0
  rollbacks0 = ica.rollbacks
  t0 = time.perf_counter()
  itrained = ica.train_dictionary_scanned(ica_batches, id0,
                                          ica_params(ICA_STEPS, ICA_STEP))
  torch.cuda.synchronize()
  ica_s = time.perf_counter() - t0
  k8_launches, ica_rollbacks = K8.launches, ica.rollbacks - rollbacks0
  nll0, nll1 = ica_nll(torch, ica_held, id0), ica_nll(torch, ica_held,
                                                      itrained)
  print("ICA scanned trainer: %d K8 steps, %d guard rollbacks; held-out "
        "Laplace NLL %.4f -> %.4f (stepsize %g)" % (
            k8_launches, ica_rollbacks, nll0, nll1, ICA_STEP))
  check(k8_launches == ICA_STEPS and ica_rollbacks == 0,
        "expected %d K8 steps and no rollback, counted %d and %d" % (
            ICA_STEPS, k8_launches, ica_rollbacks))
  check(bool(torch.isfinite(itrained).all()), "non-finite ICA dictionary")
  check(np.isfinite(nll1) and nll1 < nll0,
        "held-out Laplace NLL did not fall: %.4f -> %.4f" % (nll0, nll1))
  rollbacks0 = ica.rollbacks
  wrecked = ica.train_dictionary_scanned(ica_batches[:3], id0,
                                         ica_params(3, 40.0))
  print("ICA scanned trainer at stepsize 40: %d guard rollbacks, dictionary "
        "finite: %s" % (ica.rollbacks - rollbacks0,
                        bool(torch.isfinite(wrecked).all())))
  check(ica.rollbacks - rollbacks0 >= 1, "stepsize 40 took no rollback")
  ica_fit_patches = ica_x[:4 * ICA_BATCH].cpu().numpy()
  icoder = ICACoder(stepsize=ICA_STEP, device=dev).fit(
      ica_fit_patches, num_epochs=1, batch_size=ICA_BATCH)
  icodes = icoder.encode(ica_fit_patches[:ICA_BATCH])
  irecon = float((icoder.decode(icodes) - torch.tensor(
      ica_fit_patches[:ICA_BATCH], device=dev)).abs().max())
  print("ICACoder.fit: 4 steps; encode/decode max|x - x'| %.3e" % irecon)
  check(bool(torch.isfinite(icoder.dictionary).all()) and irecon < 1e-3,
        "ICACoder did not fit or invert")
  pcoder = PCACoder(device=dev).fit(ica_x[:20000].cpu().numpy())
  rows = pcoder.dictionary
  orth = float((rows @ rows.T - torch.eye(ICA_N, device=dev)).abs().max())
  print("PCACoder.fit: %d x %d rows orthonormal within %.2e" % (
      rows.shape[0], rows.shape[1], orth))
  check(orth <= 1e-4, "PCA rows not orthonormal: %.3e" % orth)

  # phase 22: timing (warm)
  seg10 = conv_segment_images(torch, conv_ops, dev, 10, conv_gen, seed=22)
  sh0 = torch.zeros(CONV_S, device=dev)
  sv0 = lipschitz.top_gram_eigenpair(sd0.reshape(CONV_S, -1))[1].contiguous()
  k12_args = (sd0, sh0, sv0, seg10, CONV_LAM, SEG_ITERS, SEG_STEP)
  k12_kw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=cpad,
                power_iters=2)
  k12_run = lambda: K12.fused_conv_train_segment(*k12_args, **k12_kw)
  k12_plain = lambda: K12.fused_conv_train_plain(*k12_args, **k12_kw)
  ih0 = ica_batches[:100]
  ix0 = invertible_linear.exact_inverse(id0)
  k8_kw = dict(refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL)
  k8_run = lambda: K8.fused_ica_train_segment(id0, ix0, ih0, ICA_STEP,
                                              **k8_kw)
  k8_plain = lambda: K8.fused_ica_train_plain(id0, ix0, ih0, ICA_STEP,
                                              **k8_kw)
  with torch.no_grad():
    k12_run()
    k8_run()
    k12_plain_ms = [time_ms(torch, k12_plain, 1) / 10]
    k12_ms_runs = [time_ms(torch, k12_run, 1) / 10,
                   time_ms(torch, k12_run, 1) / 10]
    k12_plain_ms.append(time_ms(torch, k12_plain, 1) / 10)
    k8_plain_ms = [time_ms(torch, k8_plain, 1) / 100]
    k8_ms_runs = [time_ms(torch, k8_run, 3) / 100,
                  time_ms(torch, k8_run, 3) / 100]
    k8_plain_ms.append(time_ms(torch, k8_plain, 1) / 100)
  k12_ms, k12_p_ms = sum(k12_ms_runs) / 2, sum(k12_plain_ms) / 2
  k8_ms, k8_p_ms = sum(k8_ms_runs) / 2, sum(k8_plain_ms) / 2
  seg_geo = K10.geometry(seg10.shape[1:], sd0.shape,
                         (CONV_STRIDE, CONV_STRIDE))
  k12_bound = conv_train_bound(seg_geo, SEG_BATCH, SEG_ITERS)
  k8_bound = ica_step_bound(ICA_N, ICA_BATCH)
  k12_gemm = gemm_profile(torch, k12_run)
  # the library time of a step's solve: K10's loop with cuDNN's products
  # on the step's batch, FISTA 25 (K12, K13 and K17 solve this)
  seta = lipschitz.fista_stepsize(sd0.reshape(CONV_S, -1))
  solve_lib = lambda: K10.fused_conv_direct_library(
      seg10[0], sd0, CONV_LAM, SEG_ITERS, seta,
      kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=cpad)
  with torch.no_grad():
    solve_lib()
    solve_lib_ms = (time_ms(torch, solve_lib, 5) + time_ms(torch, solve_lib,
                                                           5)) / 2
  print("K12 ms per step (b=40 1x272x272, 64 16x16/8, fista 25, cheap-quad): "
        "%.4f (runs %.4f, %.4f); plain %.4f (runs %.4f, %.4f); bound %.4f "
        "(%s); the gathered GEMM %.4f ms per step (%d tiled, %d line "
        "launches, profiled); the solve with cuDNN's products (FISTA 25, "
        "b 40) %.4f [%s]" % (
            k12_ms, *k12_ms_runs, k12_p_ms, *k12_plain_ms, k12_bound[0],
            k12_bound[1], (k12_gemm["tiled"][1] + k12_gemm["line"][1]) / 10,
            k12_gemm["tiled"][0], k12_gemm["line"][0], solve_lib_ms, card))
  print("conv train_dictionary_scanned %d steps of %d in %.4f s: %.2f "
        "images/s (phase 19's run) [%s]" % (
            SEG_STEPS, SEG_BATCH, seg_s, SEG_STEPS * SEG_BATCH / seg_s, card))
  print("K8 ms per step (n=256, b=250, refine 3, boost): %.4f (runs %.4f, "
        "%.4f); plain %.4f (runs %.4f, %.4f); bound %.4f (%s) [%s]" % (
            k8_ms, *k8_ms_runs, k8_p_ms, *k8_plain_ms, k8_bound[0],
            k8_bound[1], card))
  print("ICA train_dictionary_scanned %d steps of %d in %.4f s: %.1f "
        "patches/s (phase 21's run) [%s]" % (
            ICA_STEPS, ICA_BATCH, ica_s, ICA_STEPS * ICA_BATCH / ica_s, card))
  per_batch = ica_batches[:200]
  t0 = time.perf_counter()
  ica.train_dictionary(per_batch, id0, ica_params(200, ICA_STEP))
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  print("ICA train_dictionary (per batch, LU solve) 200 steps of %d in %.4f "
        "s: %.1f patches/s [%s]" % (ICA_BATCH, dt, 200 * ICA_BATCH / dt,
                                    card))

  # phase 23: K19 against its plain version on the card
  from vtc_tpu_torch.analysis_transforms.fully_connected import (
      ista_fista as fc_solve)
  from vtc_tpu_torch.ops import fused_code_shard_train as K19
  big_gen = torch.tensor(unit_rows(np.random.RandomState(0), BIG_S, 256),
                         device=dev)
  k19_err = code_shard_kernel_cases(torch, K19, lipschitz, big_gen, dev)

  # phase 24: the slice through _code_shard_segment_runner, fc and grouped
  big_groups = contiguous_groups(BIG_S, 4)
  big_arrays = K19.code_shard_group_arrays(big_groups, BIG_S, 1)
  bd0 = convert.dictionary_from_numpy(
      unit_rows(np.random.RandomState(2), BIG_S, 256), dev)
  bv0 = lipschitz.top_gram_eigenpair(bd0)[1].contiguous()
  k19_launches = k19_solves = 0
  k19_dispatch = {}
  for grouped in (False, True):
    label = "grouped 512x4" if grouped else "fc"
    t0 = time.perf_counter()
    bx = bigdict_mixtures(torch, dev, BIG_STEPS * BIG_B + BIG_HELD, big_gen,
                          4 if grouped else 1, seed=24 + grouped)
    bheld, bbatches = bx[-BIG_HELD:], bx[:-BIG_HELD].reshape(BIG_STEPS,
                                                             BIG_B, 256)
    torch.cuda.synchronize()
    print("big-dictionary %s data: %d patches (%.1f MB) made on the card in "
          "%.1f s" % (label, bx.shape[0], bbatches.numel() * 4 / 1e6,
                      time.perf_counter() - t0))
    runner = compiled_epoch._code_shard_segment_runner(
        None, 1, 1, "fista",
        ("subspace_sc_cheap_quadratic_descent" if grouped
         else "sc_cheap_quadratic_descent"), 1, False, False,
        True, group_arrays=big_arrays if grouped else None)
    K19.launches = K19.solve_launches = 0
    btrained, bh, bv = runner(bd0, torch.zeros(BIG_S, device=dev), bv0,
                              bbatches, LAM, TRAIN_ITERS, BIG_STEP)
    torch.cuda.synchronize()
    seg_launches = K19.launches
    k19_launches += seg_launches
    k19_solves += K19.solve_launches
    check(K19.solve_launches == BIG_STEPS and K19.last_route == "persistent",
          "%s: expected %d launches of the persistent solve, counted %d "
          "(route %s)" % (label, BIG_STEPS, K19.solve_launches,
                          K19.last_route))
    # phase 41 (c), on the same segment: which kernels the trainer
    # launches (the profiled run is not counted)
    k19_dispatch[label] = cs_dispatch(torch, lambda: runner(
        bd0, torch.zeros(BIG_S, device=dev), bv0, bbatches, LAM,
        TRAIN_ITERS, BIG_STEP))
    check(seg_launches == BIG_STEPS, "%s: expected %d K19 steps, counted "
          "%d" % (label, BIG_STEPS, seg_launches))
    check(all(bool(torch.isfinite(t).all()) for t in (btrained, bh, bv)),
          label + ": non-finite state")
    bnorm = float((torch.linalg.vector_norm(btrained, dim=1) - 1).abs().max())
    groups_kw = dict(group_assignments=big_groups if grouped else None,
                     is_subspace=grouped)

    def big_loss(d):
      if grouped:
        codes = sub.run(bheld, d, big_groups, LAM, TRAIN_ITERS,
                        formulation="gram")
      else:
        codes = fc_solve.run(bheld, d, LAM, TRAIN_ITERS, formulation="gram")
      return sparse_coding.compute_metrics(
          bheld, codes, d, d, mode="fully-connected", sparsity_weight=LAM,
          **groups_kw)["Average LASSO Loss"]

    bloss0, bloss1 = big_loss(bd0), big_loss(btrained)
    print("big-dictionary %s segment: %d K19 steps; rows unit norm within "
          "%.2e; held-out %sLASSO loss %.6f -> %.6f (stepsize %g)" % (
              label, seg_launches, bnorm, "group-" if grouped else "",
              bloss0, bloss1, BIG_STEP))
    check(bnorm <= 1e-4, "%s: rows not unit norm: %.3e" % (label, bnorm))
    check(np.isfinite(bloss1) and bloss1 < bloss0,
          "%s: held-out loss did not fall: %.6f -> %.6f" % (label, bloss0,
                                                            bloss1))
    del bx, bheld, bbatches

  # phase 25: timing at bench's exact configuration (warm)
  brng = np.random.RandomState(0)  # bench.py:570-576: d0, then the data
  bench_d = unit_rows(brng, BIG_S, 256)
  bench_x = torch.tensor(brng.randn(BIG_STEPS, BIG_B, 256).astype(
      np.float32), device=dev)
  bench_d = convert.dictionary_from_numpy(bench_d, dev)
  bench_h = torch.zeros(BIG_S, device=dev)
  bench_v = lipschitz.top_gram_eigenpair(bench_d)[1].contiguous()
  bench_args = (bench_d, bench_h, bench_v)
  seg_args = (LAM, TRAIN_ITERS, BIG_STEP)
  rates = {}
  for grouped in (False, True):
    label = "grouped 512x4" if grouped else "fc"
    runner = compiled_epoch._code_shard_segment_runner(
        None, 1, 1, "fista",
        ("subspace_sc_cheap_quadratic_descent" if grouped
         else "sc_cheap_quadratic_descent"), 1, False, False,
        True, group_arrays=big_arrays if grouped else None)
    out = runner(*bench_args, bench_x, *seg_args)  # warm-up, and the check
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in out)
    bnorm = float((torch.linalg.vector_norm(out[0], dim=1) - 1).abs().max())
    print("bench.py's %s configuration (randn patches, cheap-quad %g, %d "
          "steps): state finite %s, rows unit norm within %.2e, Hessian EMA "
          "max %.4g" % (label, BIG_STEP, BIG_STEPS, finite, bnorm,
                        float(out[1].max())))
    with torch.no_grad():
      runs = [time_ms(torch, lambda: runner(*bench_args, bench_x, *seg_args),
                      1) / BIG_STEPS for _ in range(2)]
    rates[label] = runs
    print("K19 %s ms per step (b=%d s=%d n=256, fista 25, cheap-quad, %d-"
          "step segment through _code_shard_segment_runner): %.4f (runs "
          "%.4f, %.4f); %.1f patches/s [%s]" % (
              label, BIG_B, BIG_S, BIG_STEPS, sum(runs) / 2, *runs,
              BIG_B / (sum(runs) / 2) * 1e3, card))
  k19_ms = sum(rates["fc"]) / 2
  k19_g_ms = sum(rates["grouped 512x4"]) / 2
  # phase 41 (e): both routes forced, in turns (per-step route, persistent,
  # persistent, per-step route), on the same 200-step segment
  k19_route_ms = {}
  with torch.no_grad():
    for grouped in (False, True):
      label = "grouped 512x4" if grouped else "fc"
      table, window, comem, kw = cs_launch_args(
          K19, BIG_S, groups=big_groups if grouped else None,
          update_alg=("subspace_sc_cheap_quadratic_descent" if grouped
                      else "sc_cheap_quadratic_descent"))
      runs = {"steps": [], "persistent": []}
      for route in ("steps", "persistent", "persistent", "steps"):
        fn = lambda: K19._launch(bench_d, bench_h, bench_v, bench_x, table,
                                 window, comem, None, LAM, TRAIN_ITERS,
                                 BIG_STEP, route=route, **kw)
        fn()
        runs[route].append(time_ms(torch, fn, 1) / BIG_STEPS)
      k19_route_ms[label] = {r: sum(v_) / 2 for r, v_ in runs.items()}
      print("phase 41 (e) K19 %s ms per step, both routes in turns (a %d-"
            "step segment at bench's configuration): persistent %.4f (runs "
            "%.4f, %.4f), per-step route %.4f (runs %.4f, %.4f), %.2fx "
            "[%s]" % (label, BIG_STEPS, k19_route_ms[label]["persistent"],
                      *runs["persistent"], k19_route_ms[label]["steps"],
                      *runs["steps"], k19_route_ms[label]["steps"]
                      / k19_route_ms[label]["persistent"], card))
  short = bench_x[:20]
  plain_fc = lambda: K19.fused_code_sharded_train_segment_plain(
      *bench_args, short, *seg_args, power_iters=2)
  plain_g = lambda: K19.fused_code_sharded_train_segment_plain(
      *bench_args, short, *seg_args, power_iters=2,
      expand_local=big_arrays[0][0],
      update_alg="subspace_sc_cheap_quadratic_descent")
  ab = bench_x[:10]
  k2_big = lambda: fused_train_step.fused_train_segment(
      *bench_args, ab, *seg_args, power_iters=2)
  k6_big = lambda: fused_group_train_step.fused_group_train_segment(
      *bench_args, ab, *seg_args, group_assignments=big_groups,
      power_iters=2)
  with torch.no_grad():
    plain_fc(), plain_g(), k2_big(), k6_big()
    k19_p = [time_ms(torch, plain_fc, 1) / 20 for _ in range(2)]
    k19_gp = [time_ms(torch, plain_g, 1) / 20 for _ in range(2)]
    k2_runs = [time_ms(torch, k2_big, 1) / 10 for _ in range(2)]
    k6_runs = [time_ms(torch, k6_big, 1) / 10 for _ in range(2)]
  k19_p_ms = sum(k19_p) / 2
  k19_bound = code_shard_step_bound(BIG_B, BIG_S, 256, TRAIN_ITERS)
  for label, runs in (("K19 plain fc", k19_p),
                      ("K19 plain grouped 512x4", k19_gp),
                      ("K2 (gram form, s x s Gram) fc", k2_runs),
                      ("K6 (gram form) grouped 512x4", k6_runs)):
    print("%s ms per step (b=%d s=%d n=256, fista 25, cheap-quad): %.4f "
          "(runs %.4f, %.4f); %.1f patches/s [%s]" % (
              label, BIG_B, BIG_S, sum(runs) / 2, *runs,
              BIG_B / (sum(runs) / 2) * 1e3, card))
  print("K19 bound per step (b=%d s=%d n=256, fista 25): %.4f ms (%s); fc "
        "%.1fx and grouped %.1fx the bound [%s]" % (
            BIG_B, BIG_S, k19_bound[0], k19_bound[1], k19_ms / k19_bound[0],
            k19_g_ms / k19_bound[0], card))
  # bench.py's 'xla' fallback rows: the plain gram-form scan (200 fc steps,
  # 50 grouped, as bench runs them)
  for grouped, steps in ((False, BIG_STEPS), (True, 50)):
    raw = sparse_coding.build_raw_step_fn(
        "fully-connected", "subspace_fista" if grouped else "fista",
        ("subspace_sc_cheap_quadratic_descent" if grouped
         else "sc_cheap_quadratic_descent"),
        group_assignments=big_groups if grouped else None,
        fc_formulation="gram", compute_stepsize_in_step=False)
    if grouped:
      gather, mask, _ = sub.group_layout(big_groups, BIG_S, dev)
      lip_matrix = lambda dd: sub.build_grouped_dictionary(dd, gather, mask)
    else:
      lip_matrix = lambda dd: dd
    scan = compiled_epoch._segment_runner(raw, 1, True, lip_matrix)
    with torch.no_grad():
      scan(*bench_args, bench_x[:2], *seg_args)
      runs = [time_ms(torch, lambda: scan(*bench_args, bench_x[:steps],
                                          *seg_args), 1) / steps
              for _ in range(2)]
    print("plain gram-form _segment_runner %s (bench's xla row, %d steps) ms "
          "per step: %.4f (runs %.4f, %.4f); %.1f patches/s; K19 %.2fx its "
          "rate [%s]" % (
              "grouped 512x4" if grouped else "fc", steps, sum(runs) / 2,
              *runs, BIG_B / (sum(runs) / 2) * 1e3,
              (sum(runs) / 2) / (k19_g_ms if grouped else k19_ms), card))
  del bench_x


  # phase 26: K3, K7 and K9 against their plain versions on the card
  import os
  import tempfile
  import torch.distributed as dist
  from vtc_tpu_torch import parallel
  from vtc_tpu_torch.training import pca
  K2, K6 = fused_train_step, fused_group_train_step
  k3_err, k7_err, k9_err = dp_kernel_cases(
      torch, parallel, K2, K6, K8, ica, sub, lipschitz, invertible_linear,
      train_patches, gtrain, dev)
  from vtc_tpu_torch.ops import fused_dp_train
  check_runs("data-parallel train_dictionary_scanned early_stopping_epsilon",
             lambda: compiled_epoch.train_dictionary_scanned(
                 rx, rx[:1], rd, dict(train_params(2), data_parallel=True,
                                      early_stopping_epsilon=1e-3)),
             fused_dp_train)

  # phase 27: a world of 1 through the normal entry points.  First the
  # collective backends the card has
  check(dist.is_available() and dist.is_gloo_available(),
        "torch.distributed has no gloo backend: the world-of-2 phase needs "
        "it")
  with tempfile.TemporaryDirectory() as tmp:
    nccl_built, nccl_works, nccl_note = nccl_probe(
        torch, dist, os.path.join(tmp, "store"))
  print("NCCL probe: built in %s; a one-rank group initialises and reduces "
        "%s (%s)" % (nccl_built, nccl_works, nccl_note))
  if nccl_works:
    # the default group's world is what data_parallel=True takes: with a
    # one-rank NCCL group initialised the trainer must run as without one
    with tempfile.TemporaryDirectory() as tmp:
      dist.init_process_group("nccl", init_method="file://" + os.path.join(
          tmp, "store"), rank=0, world_size=1)
      try:
        in_group = compiled_epoch.train_dictionary_scanned(
            batches[:10], held_out[None], d0,
            dict(train_params(10), data_parallel=True))
      finally:
        dist.destroy_process_group()
    no_group = compiled_epoch.train_dictionary_scanned(
        batches[:10], held_out[None], d0,
        dict(train_params(10), data_parallel=True))
    check(bool((in_group == no_group).all()),
          "data_parallel=True differs inside a one-rank NCCL group")
    print("data_parallel=True inside a one-rank NCCL group: 10 steps, "
          "bitwise the run without a group")
  rollbacks0 = ica.rollbacks
  dp_wrecked = ica.train_dictionary_scanned(
      ica_batches[:3], id0, dict(ica_params(3, 40.0), data_parallel=True))
  print("data-parallel ICA at stepsize 40 (K18): %d guard rollbacks "
        "through the data-parallel fallback, dictionary finite: %s" % (
            ica.rollbacks - rollbacks0,
            bool(torch.isfinite(dp_wrecked).all())))
  check(ica.rollbacks - rollbacks0 >= 1,
        "data-parallel ICA at stepsize 40 took no rollback")
  mesh1 = parallel.make_mesh()
  fused_fista.launches = fused_group_fista.launches = 0
  dp_codes = encode_dataset(patches, dictionary, LAM, ITERS,
                            batch_size=BATCH, chunk_batches=4,
                            data_parallel=mesh1)
  dp_gcodes = encode_dataset(gpatches, dictionary, LAM, ITERS,
                             batch_size=BATCH, chunk_batches=4,
                             group_assignments=groups, data_parallel=mesh1)
  check(fused_fista.launches == NUM_BATCHES
        and fused_group_fista.launches == NUM_BATCHES,
        "data-parallel encode: expected %d K1 and %d K4 launches, counted "
        "%d and %d" % (NUM_BATCHES, NUM_BATCHES, fused_fista.launches,
                       fused_group_fista.launches))
  check(np.array_equal(dp_codes, codes) and np.array_equal(dp_gcodes, gcodes),
        "encode_dataset with a mesh of one differs from the plain call")
  pca_x = ica_x[:20000] - ica_x[:20000].mean(dim=0)
  pca_dp = pca.train_dictionary(pca_x, data_parallel=mesh1)
  pca_one = pca.train_dictionary(pca_x)
  check(bool((pca_dp == pca_one).all()),
        "PCA with a mesh of one differs from the single-device result")
  print("world of 1: encode_dataset (fc %d K1, subspace %d K4 launches) and "
        "PCA with a mesh of one equal their single-device results bitwise"
        % (NUM_BATCHES, NUM_BATCHES))

  # phase 28: a world of 2 on the one card
  dp2_launches = dp_world_of_two(torch, batches, gbatches, d0, sd0, dev)

  # phase 29: data-parallel timing (warm)
  xs250 = batches[0]
  gxs250 = gbatches[0]
  ib250 = ica_batches[0]
  stats_kw = dict(power_iters=2)
  k3_run = lambda xx: (lambda: K2.fused_solve_stats(
      d0, v0, xx, LAM, TRAIN_ITERS, **stats_kw))
  k3_plain = lambda: K2.fused_solve_stats_plain(d0, v0, xs250, LAM,
                                                TRAIN_ITERS, **stats_kw)
  k7_run = lambda xx: (lambda: K6.fused_group_solve_stats(
      d0, gv0, xx, LAM, TRAIN_ITERS, group_assignments=groups, **stats_kw))
  k7_plain = lambda: K6.fused_group_solve_stats_plain(
      d0, gv0, gxs250, LAM, TRAIN_ITERS, group_assignments=groups,
      **stats_kw)
  k9_kw = dict(refine_iters=ICA_REFINE, boost_tol=ICA_BOOST_TOL)
  k9_run = lambda xx: (lambda: K8.ica_solve_stats(id0, ix0, xx, **k9_kw))
  k9_plain = lambda: K8.ica_solve_stats_plain(id0, ix0, ib250, **k9_kw)
  dp_times = {}
  with torch.no_grad():
    for name, run, plain_fn, full, reps in (
        ("K3", k3_run, k3_plain, xs250, 100),
        ("K7", k7_run, k7_plain, gxs250, 100),
        ("K9", k9_run, k9_plain, ib250, 200)):
      half = full[:TRAIN_BATCH // 2].contiguous()
      run(full)(), run(half)(), plain_fn()
      plain_runs = [time_ms(torch, plain_fn, 10)]
      runs = [time_ms(torch, run(full), reps), time_ms(torch, run(full), reps)]
      half_ms = time_ms(torch, run(half), reps)
      plain_runs.append(time_ms(torch, plain_fn, 10))
      dp_times[name] = (sum(runs) / 2, sum(plain_runs) / 2, half_ms)
      print("%s ms per step (b=250, a shard of 125: %.4f): %.4f (runs %.4f, "
            "%.4f); plain %.4f (runs %.4f, %.4f) [%s]" % (
                name, half_ms, dp_times[name][0], *runs, dp_times[name][1],
                *plain_runs, card))
  k3_bound = solve_stats_bound(TRAIN_BATCH, 256, 256, TRAIN_ITERS)
  k9_bound = ica_stats_bound(ICA_N, ICA_BATCH)
  print("K3 %.4f ms against K2's whole step %.4f ms; K7 %.4f against K6's "
        "%.4f; K9 %.4f against K8's %.4f (b=250; K2, K6 and K8 include the "
        "update, from C loops of 100 steps); bounds K3/K7 %.4f ms (%s), K9 "
        "%.4f ms (%s) [%s]" % (
            dp_times["K3"][0], step_ms, dp_times["K7"][0], gstep_ms,
            dp_times["K9"][0], k8_ms, k3_bound[0], k3_bound[1], k9_bound[0],
            k9_bound[1], card))
  # the host's share: a data-parallel step is one Python call per step,
  # where K2 enqueues a whole segment from one C loop
  for label, runner, state, seg, args in (
      ("fc", compiled_epoch._dp_fused_segment_runner(
          parallel.build_dp_fused_local_step(
              mesh1, "fista", "sc_cheap_quadratic_descent", power_iters=2)),
       (d0, h0, v0), batches[:200], (LAM, TRAIN_ITERS, TRAIN_STEP)),
      ("subspace", compiled_epoch._dp_fused_segment_runner(
          parallel.build_dp_group_fused_local_step(
              mesh1, "subspace_fista", "subspace_sc_cheap_quadratic_descent",
              group_assignments=groups, power_iters=2)),
       (d0, h0, gv0), gbatches[:200], (LAM, TRAIN_ITERS, SUB_STEP)),
      ("ica", ica._segment_runner_dp(1, mesh1, True, refine_iters=ICA_REFINE,
                                     fused=True),
       (id0, ix0), ica_batches[:200], (ICA_STEP,))):
    with torch.no_grad():
      runner(*state, seg[:5], *args)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      runner(*state, seg, *args)
      host = time.perf_counter() - t0
      torch.cuda.synchronize()
      total = time.perf_counter() - t0
    print("data-parallel %s step at a world of 1 (200 steps): host enqueue "
          "%.4f ms per step, device and host together %.4f ms per step "
          "[%s]" % (label, 1e3 * host / 200, 1e3 * total / 200, card))

  # phase 30: K13 and K17 against their plain versions on the card
  from vtc_tpu_torch.ops import fused_conv_dp_train as K17
  stride = (CONV_STRIDE, CONV_STRIDE)
  k13_err = conv_stats_kernel_cases(torch, K12, parallel, conv_ops, lipschitz,
                                    cimages, conv_gen, cpad, dev)
  k17_err = conv_dp_kernel_cases(torch, K17, K12, parallel, compiled_epoch,
                                 conv_ops, lipschitz, cimages, conv_gen, cpad,
                                 dev)

  # phase 31: a world of 1 through the entry points.  The scanned conv
  # trainer on phase 19's segment: K17 every step, no K13 or K12 step
  K17.launches = K12.stats_launches = K12.launches = 0
  K10.launches = K11.launches = 0
  t0 = time.perf_counter()
  dp_strained = compiled_epoch.train_dictionary_scanned(
      seg_batches, seg_held[None], sd0,
      dict(conv_segment_params(SEG_STEPS, SEG_STEP), data_parallel=True))
  torch.cuda.synchronize()
  dp_seg_s = time.perf_counter() - t0
  k17_launches, k13_in_dp = K17.launches, K12.stats_launches
  k12_in_dp, k10_in_dp = K12.launches, K10.launches + K11.launches
  print("world of 1, conv train_dictionary_scanned(data_parallel=True): %d "
        "K17 steps, %d K13 steps, %d K12 steps, %d K10/K11 solves" % (
            k17_launches, k13_in_dp, k12_in_dp, k10_in_dp))
  check(k17_launches == SEG_STEPS and k13_in_dp == 0 and k12_in_dp == 0
        and k10_in_dp == 0, "expected %d K17 steps and no K13 or K12 step "
        "or K10 solve" % SEG_STEPS)
  check(bool(torch.isfinite(dp_strained).all()), "non-finite conv kernels")
  dp_norm_err = float((torch.linalg.vector_norm(
      dp_strained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
  dp_sloss = held_out_fista_conv_loss(conv_ista_fista, sparse_coding,
                                      seg_held, dp_strained)
  apart = float((dp_strained - strained).abs().max())
  print("world of 1, conv scanned: kernels unit norm within %.2e; held-out "
        "conv LASSO loss %.6f -> %.6f (single device %.6f); final kernels "
        "max|d| %.3e from phase 19's (rounding floor %.1e)" % (
            dp_norm_err, sloss0, dp_sloss, sloss1, apart, DP_FLOOR))
  check(dp_norm_err <= 1e-4, "kernels not unit norm: %.3e" % dp_norm_err)
  check(np.isfinite(dp_sloss) and dp_sloss < sloss0,
        "held-out conv LASSO loss did not fall: %.6f -> %.6f" % (sloss0,
                                                                 dp_sloss))
  check(apart <= DP_FLOOR, "the conv data-parallel trainer's kernels are "
        "%.3e from the single-device trainer's, floor %.1e" % (apart,
                                                               DP_FLOOR))
  # bench.py's conv_dp_rdma_batch5 row (:806-815, the row K17 runs on the
  # TPU): b 5, 100 steps, on phase 19's images
  b5_batches = seg_batches.reshape((-1, CONV_TRAIN_BATCH)
                                   + seg_batches.shape[2:])[:100]
  K17.launches = 0
  t0 = time.perf_counter()
  b5_trained = compiled_epoch.train_dictionary_scanned(
      b5_batches, seg_held[None], sd0,
      dict(conv_segment_params(100, SEG_STEP), data_parallel=True))
  torch.cuda.synchronize()
  b5_s = time.perf_counter() - t0
  b5_norm = float((torch.linalg.vector_norm(
      b5_trained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
  print("world of 1, conv scanned b5 (bench's conv_dp_rdma_batch5): %d K17 "
        "steps; kernels finite %s, unit norm within %.2e" % (
            K17.launches, bool(torch.isfinite(b5_trained).all()), b5_norm))
  check(K17.launches == 100 and bool(torch.isfinite(b5_trained).all())
        and b5_norm <= 1e-4, "the b-5 conv DP row did not run 100 K17 steps "
        "to finite unit-norm kernels")
  # 20 steps at three update iterations: the gram form
  gparams = conv_segment_params(20, SEG_STEP)
  gparams["dict_update_param_schedule"] = {
      0: {"stepsize": SEG_STEP, "num_iters": 3}}
  calls, restore = k17_calls(K17)
  try:
    K17.launches = K12.stats_launches = K12.launches = 0
    gdp = compiled_epoch.train_dictionary_scanned(
        seg_batches[:20], seg_held[None], sd0,
        dict(gparams, data_parallel=True))
    torch.cuda.synchronize()
    gform = list(calls), K17.launches, K12.stats_launches, K12.launches
  finally:
    restore()
  gone = compiled_epoch.train_dictionary_scanned(
      seg_batches[:20], seg_held[None], sd0, gparams)
  gapart = float((gdp - gone).abs().max())
  print("world of 1, conv scanned upd 3: K17 calls (steps, update "
        "iterations) %s, %d K17, %d K13 and %d K12 steps; max|d| %.3e from "
        "the single-device K12 run (rounding floor %.1e)" % (
            *gform, gapart, DP_FLOOR))
  check(gform == ([(20, 3)], 20, 0, 0),
        "the upd-3 segment did not take K17's gram form: %s" % (gform,))
  check(bool(torch.isfinite(gdp).all()) and gapart <= DP_FLOOR,
        "the gram-form segment is %.3e from K12's" % gapart)
  # the per-batch trainer at the example's parameters: the psum-per-op step
  t0 = time.perf_counter()
  pb_trained = sparse_coding.train_dictionary(
      cbatches[:50], cheld[None], cd0,
      dict(conv_train_params(50), data_parallel=True))
  torch.cuda.synchronize()
  pb_s = time.perf_counter() - t0
  pb_norm = float((torch.linalg.vector_norm(
      pb_trained.reshape(CONV_S, -1), dim=1) - 1).abs().max())
  pb_loss = held_out_conv_loss(conv_ista_fista, sparse_coding, cheld,
                               pb_trained)
  print("world of 1, conv train_dictionary(data_parallel=True) 50 steps of "
        "%d: kernels unit norm within %.2e; held-out conv LASSO loss %.6f -> "
        "%.6f" % (CONV_TRAIN_BATCH, pb_norm, closs0, pb_loss))
  check(bool(torch.isfinite(pb_trained).all()) and pb_norm <= 1e-4,
        "per-batch conv DP: kernels not finite or not unit norm")
  check(np.isfinite(pb_loss) and pb_loss < closs0,
        "per-batch conv DP: held-out loss did not fall: %.6f -> %.6f" % (
            closs0, pb_loss))
  # the conv encode with a mesh of one: phase 15's codes, bitwise
  K10.launches = K11.launches = 0
  dp_ccodes = encode_dataset(cimages, conv_d, CONV_LAM, CONV_ITERS,
                             data_parallel=mesh1, **conv_kw)
  check(K10.launches == n_conv_batches and K11.launches == 0,
        "conv encode with a mesh of one: %d K10 launches, expected %d" % (
            K10.launches, n_conv_batches))
  check(np.array_equal(dp_ccodes, ccodes),
        "conv encode with a mesh of one differs from phase 15's codes")
  print("world of 1: conv encode_dataset (%d K10 launches) with a mesh of one "
        "equals phase 15's codes bitwise" % n_conv_batches)

  # phase 32: conv data-parallel timing (warm)
  xs40 = seg_batches[0]
  xs20 = xs40[:SEG_BATCH // 2].contiguous()
  k13_kw = dict(kernel_stride=stride, padding=cpad, power_iters=2)
  k13_run = lambda xx, gram: (lambda: K12.conv_solve_stats(
      sd0, sv0, xx, CONV_LAM, SEG_ITERS, gram_stats=gram, **k13_kw))
  k13_plain = lambda gram: (lambda: K12.conv_solve_stats_plain(
      sd0, sv0, xs40, CONV_LAM, SEG_ITERS, gram_stats=gram, **k13_kw))
  k13_times = {}
  with torch.no_grad():
    for gram in (False, True):
      k13_run(xs40, gram)(), k13_run(xs20, gram)(), k13_plain(gram)()
      plain_runs = [time_ms(torch, k13_plain(gram), 10)]
      runs = [time_ms(torch, k13_run(xs40, gram), 10),
              time_ms(torch, k13_run(xs40, gram), 10)]
      half_ms = time_ms(torch, k13_run(xs20, gram), 10)
      plain_runs.append(time_ms(torch, k13_plain(gram), 10))
      k13_times[gram] = (sum(runs) / 2, sum(plain_runs) / 2, half_ms)
      full_b = conv_stats_bound(seg_geo, SEG_BATCH, SEG_ITERS, gram)
      half_b = conv_stats_bound(seg_geo, SEG_BATCH // 2, SEG_ITERS, gram)
      print("K13 %s form ms per step (b=40 1x272x272, 64 16x16/8, fista 25): "
            "%.4f (runs %.4f, %.4f); plain %.4f (runs %.4f, %.4f); bound "
            "%.4f (%s); a shard of 20: %.4f, bound %.4f; K12's whole step "
            "%.4f, the solve with cuDNN's products %.4f (phase 22) [%s]" % (
                "gram" if gram else "gradient", k13_times[gram][0], *runs,
                k13_times[gram][1], *plain_runs, full_b[0], full_b[1],
                half_ms, half_b[0], k12_ms, solve_lib_ms, card))
  k13_ms, k13_p_ms = k13_times[False][:2]
  k13_bound = conv_stats_bound(seg_geo, SEG_BATCH, SEG_ITERS, False)
  # K13 over the batch: per image, does the time step where the working
  # set (image blocks, codes, momentum and correlations) leaves the 50 MB L2?
  sweep = []
  with torch.no_grad():
    for b in (10, 20, 30, 40):
      xb = xs40[:b].contiguous()
      k13_run(xb, False)()
      sweep.append((b, time_ms(torch, k13_run(xb, False), 10)))
  print("K13 gradient form over the batch: %s ms per step, %s ms per image "
        "[%s]" % (", ".join("b %d %.4f" % bt for bt in sweep),
                  ", ".join("%.4f" % (t / b) for b, t in sweep), card))
  # K17: the whole data-parallel segment at a world of 1, 10 steps of 40,
  # against its plain version (2 steps) and K13's composition
  seg_k = seg_batches[:10]
  k17_kw = dict(mesh=mesh1, kernel_stride=stride, padding=cpad,
                power_iters=2)
  k17_run = lambda xx, upd: (lambda: K17.fused_conv_dp_train_segment(
      sd0, sh0, sv0, xx, CONV_LAM, SEG_ITERS, SEG_STEP, upd_num_iters=upd,
      **k17_kw))
  k17_plain = lambda upd: (lambda: K17.fused_conv_dp_train_plain(
      sd0, sh0, sv0, seg_k[:2], CONV_LAM, SEG_ITERS, SEG_STEP,
      upd_num_iters=upd, **k17_kw))
  k17_times = {}
  with torch.no_grad():
    for upd in (1, 3):
      k17_run(seg_k[:2], upd)(), k17_plain(upd)()
      plain_runs = [time_ms(torch, k17_plain(upd), 5) / 2]
      runs = [time_ms(torch, k17_run(seg_k, upd), 3) / 10,
              time_ms(torch, k17_run(seg_k, upd), 3) / 10]
      plain_runs.append(time_ms(torch, k17_plain(upd), 5) / 2)
      k17_times[upd] = (sum(runs) / 2, sum(plain_runs) / 2)
      k17_b = conv_dp_bound(seg_geo, SEG_BATCH, SEG_ITERS, upd, 10)
      print("K17 %s form ms per step (a segment of 10 steps of b=40, upd %d): "
            "%.4f (runs %.4f, %.4f); plain %.4f (runs %.4f, %.4f); bound "
            "%.4f (%s); K13 alone %.4f; the solve with cuDNN's products "
            "%.4f (phase 22) [%s]" % (
                "gram" if upd > 1 else "gradient", upd, k17_times[upd][0],
                *runs, k17_times[upd][1], *plain_runs, k17_b[0], k17_b[1],
                k13_times[upd > 1][0], solve_lib_ms, card))
    b5_seg = seg_batches.reshape((-1, CONV_TRAIN_BATCH)
                                 + seg_batches.shape[2:])[:100]
    k17_run(b5_seg[:2], 1)()
    b5_k17_ms = time_ms(torch, k17_run(b5_seg, 1), 3) / 100
  k17_ms, k17_p_ms = k17_times[1]
  k17_bound = conv_dp_bound(seg_geo, SEG_BATCH, SEG_ITERS, 1, 10)
  b5_bound = conv_dp_bound(seg_geo, CONV_TRAIN_BATCH, SEG_ITERS, 1, 100)
  print("K17 at bench.py's b-5 row (100 steps of 5, one segment): %.4f ms "
        "per step, bound %.4f ms (%s) [%s]" % (b5_k17_ms, b5_bound[0],
                                               b5_bound[1], card))
  # the host's share: K13's composition is one Python call per step, K17
  # one C loop per segment.  A step is about 80 launches, so 5 steps
  # enqueue inside the launch queue (about a thousand) and time the host
  # alone; 50 steps fill it, and the host then waits on the device.
  composition = compiled_epoch._dp_fused_segment_runner(
      parallel.build_dp_conv_fused_local_step(
          mesh1, "fista", "sc_cheap_quadratic_descent", kernel_stride=stride,
          padding=cpad, power_iters=2))
  k17_runner = compiled_epoch._dp_conv_segment_runner(
      mesh1, "fista", "sc_cheap_quadratic_descent", 1, False, False, True,
      stride, cpad)
  with torch.no_grad():
    for label, runner in (("K13's composition", composition),
                          ("K17's segment", k17_runner)):
      runner(sd0, sh0, sv0, seg_batches[:3], CONV_LAM, SEG_ITERS, SEG_STEP)
      for k in (5, 50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(sd0, sh0, sv0, seg_batches[:k], CONV_LAM, SEG_ITERS, SEG_STEP)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        print("data-parallel conv step at a world of 1, %s (%d steps of "
              "40): host enqueue %.4f ms per step, device and host together "
              "%.4f ms per step [%s]" % (label, k, 1e3 * host / k,
                                         1e3 * total / k, card))
  print("conv train_dictionary_scanned(data_parallel=True) at a world of 1, "
        "%d steps of %d: %.2f images/s (phase 31's run); single device %.2f "
        "images/s (phase 19's run); the b-5 row %.2f images/s; per-batch "
        "train_dictionary(data_parallel=True) %.2f images/s [%s]" % (
            SEG_STEPS, SEG_BATCH, SEG_STEPS * SEG_BATCH / dp_seg_s,
            SEG_STEPS * SEG_BATCH / seg_s, 100 * CONV_TRAIN_BATCH / b5_s,
            50 * CONV_TRAIN_BATCH / pb_s, card))
  print("the b-5 row through the trainer: %.4f ms per step (host clock), "
        "bound %.4f ms (%s) [%s]" % (1e3 * b5_s / 100, b5_bound[0],
                                      b5_bound[1], card))
  del seg_images, seg_batches

  # phase 33: K15, K16 and K18 against their plain versions on the card
  from vtc_tpu_torch.ops import fused_dp_train as K15
  from vtc_tpu_torch.ops import fused_group_dp_train as K16
  k15_err, k16_err, k18_err = dp_segment_kernel_cases(
      torch, parallel, K15, K16, K8, sub, lipschitz, invertible_linear,
      train_patches, gtrain, dev)

  # phase 34: a world of 1 through the entry points: the scanned fc,
  # subspace and ICA trainers with data_parallel=True take K15, K16 and K18
  # every step, and not K3, K7 or K9's composition (a 'dcn' mesh's: phase
  # 28) nor the single-device K2, K6 or K8
  sub_params = subspace_train_params(TRAIN_STEPS, SUB_STEP)
  dp_runs = {}
  for label, x, held, params_, seg, kmod, twin, want in (
      ("fc", batches, held_out, params, K15, K2, trained,
       lambda dd: held_out_loss(torch, ista_fista, sparse_coding, held_out,
                                dd)),
      ("subspace", gbatches, gheld, sub_params, K16, K6, gtrained,
       lambda dd: held_out_group_loss(torch, sub, sparse_coding, gheld, dd,
                                      groups))):
    seg.launches = kmod.stats_launches = kmod.launches = 0
    t0 = time.perf_counter()
    dp_trained = compiled_epoch.train_dictionary_scanned(
        x, held[None], d0, dict(params_, data_parallel=True))
    torch.cuda.synchronize()
    dp_runs[label] = time.perf_counter() - t0
    counts = seg.launches, kmod.stats_launches, kmod.launches
    dp_runs[label + " launches"] = counts[0]
    check(counts == (TRAIN_STEPS, 0, 0),
          "%s data-parallel trainer: expected %d whole-segment steps and no "
          "solve+stats or single-device step, counted %s" % (
              label, TRAIN_STEPS, counts))
    check(bool(torch.isfinite(dp_trained).all()),
          label + ": non-finite dictionary")
    norm_err = float((torch.linalg.vector_norm(dp_trained, dim=1)
                      - 1).abs().max())
    l0, l1 = want(d0), want(dp_trained)
    apart = float((dp_trained - twin).abs().max())
    print("world of 1, %s train_dictionary_scanned(data_parallel=True): %d "
          "%s steps, %d solve+stats, %d single-device; rows unit norm within "
          "%.2e; held-out loss %.6f -> %.6f; final dictionary max|d| %.3e "
          "from the single-device trainer's (rounding floor %.1e)" % (
              label, counts[0], "K15" if seg is K15 else "K16", counts[1],
              counts[2], norm_err, l0, l1, apart, DP_FLOOR))
    check(norm_err <= 1e-4, "%s: rows not unit norm: %.3e" % (label,
                                                               norm_err))
    check(np.isfinite(l1) and l1 < l0,
          "%s: held-out loss did not fall: %.6f -> %.6f" % (label, l0, l1))
    check(apart <= DP_FLOOR, "%s: the data-parallel trainer's dictionary "
          "is %.3e from the single-device trainer's, floor %.1e" % (
              label, apart, DP_FLOOR))
  K8.dp_launches = K8.stats_launches = K8.launches = 0
  rollbacks0 = ica.rollbacks
  t0 = time.perf_counter()
  dp_itrained = ica.train_dictionary_scanned(
      ica_batches, id0, dict(ica_params(ICA_STEPS, ICA_STEP),
                             data_parallel=True))
  torch.cuda.synchronize()
  dp_runs["ica"] = time.perf_counter() - t0
  icounts = K8.dp_launches, K8.stats_launches, K8.launches
  dp_runs["ica launches"] = icounts[0]
  dp_nll = ica_nll(torch, ica_held, dp_itrained)
  iapart = float((dp_itrained - itrained).abs().max())
  print("world of 1, ICA train_dictionary_scanned(data_parallel=True): %d "
        "K18 steps, %d K9, %d K8, %d guard rollbacks; held-out Laplace NLL "
        "%.4f -> %.4f; max|d| %.3e from the single-device trainer's "
        "(rounding floor %.1e)" % (*icounts, ica.rollbacks - rollbacks0,
                                   nll0, dp_nll, iapart, DP_FLOOR))
  check(icounts == (ICA_STEPS, 0, 0) and ica.rollbacks == rollbacks0,
        "expected %d K18 steps, no K9 or K8 step and no rollback" % ICA_STEPS)
  check(bool(torch.isfinite(dp_itrained).all()) and dp_nll < nll0,
        "data-parallel ICA: held-out NLL did not fall: %.4f -> %.4f" % (
            nll0, dp_nll))
  check(iapart <= DP_FLOOR, "data-parallel ICA: %.3e from the single-device "
        "trainer's, floor %.1e" % (iapart, DP_FLOOR))

  # phase 35: timing (warm): K15, K16 and K18 per step beside their plain
  # versions, K3, K7 and K9's composition and K2, K6 and K8, the host's
  # enqueue, and the world-of-1 trainers against the single-device ones
  seg_kw = dict(mesh=mesh1, power_iters=2)
  whole = {
      "K15": (lambda k: lambda: K15.fused_dp_train_segment(
          d0, h0, v0, batches[:k], LAM, TRAIN_ITERS, TRAIN_STEP, **seg_kw),
              lambda k: lambda: K15.fused_dp_train_plain(
                  d0, h0, v0, batches[:k], LAM, TRAIN_ITERS, TRAIN_STEP,
                  **seg_kw),
              compiled_epoch._dp_fused_segment_runner(
                  parallel.build_dp_fused_local_step(
                      mesh1, "fista", "sc_cheap_quadratic_descent",
                      power_iters=2)),
              (d0, h0, v0), batches, (LAM, TRAIN_ITERS, TRAIN_STEP),
              lambda k: lambda: K2.fused_train_segment(
                  d0, h0, v0, batches[:k], LAM, TRAIN_ITERS, TRAIN_STEP,
                  power_iters=2)),
      "K16": (lambda k: lambda: K16.fused_group_dp_train_segment(
          d0, h0, gv0, gbatches[:k], LAM, TRAIN_ITERS, SUB_STEP,
          group_assignments=groups, **seg_kw),
              lambda k: lambda: K16.fused_group_dp_train_plain(
                  d0, h0, gv0, gbatches[:k], LAM, TRAIN_ITERS, SUB_STEP,
                  group_assignments=groups, **seg_kw),
              compiled_epoch._dp_fused_segment_runner(
                  parallel.build_dp_group_fused_local_step(
                      mesh1, "subspace_fista",
                      "subspace_sc_cheap_quadratic_descent",
                      group_assignments=groups, power_iters=2)),
              (d0, h0, gv0), gbatches, (LAM, TRAIN_ITERS, SUB_STEP),
              lambda k: lambda: K6.fused_group_train_segment(
                  d0, h0, gv0, gbatches[:k], LAM, TRAIN_ITERS, SUB_STEP,
                  group_assignments=groups, power_iters=2)),
      "K18": (lambda k: lambda: K8.fused_ica_dp_train_segment(
          id0, ix0, ica_batches[:k], ICA_STEP, mesh=mesh1, **k9_kw),
              lambda k: lambda: K8.fused_ica_dp_train_plain(
                  id0, ix0, ica_batches[:k], ICA_STEP, mesh=mesh1, **k9_kw),
              ica._segment_runner_dp(1, mesh1, True, refine_iters=ICA_REFINE,
                                     fused=True),
              (id0, ix0), ica_batches, (ICA_STEP,),
              lambda k: lambda: K8.fused_ica_train_segment(
                  id0, ix0, ica_batches[:k], ICA_STEP, **k9_kw)),
  }
  seg_times = {}
  with torch.no_grad():
    for name, (kernel, plain, composition, state, data, args,
               single) in whole.items():
      reps = 200 if name == "K18" else 100
      comp = lambda: composition(*state, data[:reps], *args)
      kernel(2)(), plain(2)(), comp(), single(2)()
      plain_runs = [time_ms(torch, plain(10), 1) / 10]
      runs = [time_ms(torch, kernel(reps), 3) / reps,
              time_ms(torch, kernel(reps), 3) / reps]
      comp_ms = time_ms(torch, comp, 1) / reps
      single_ms = time_ms(torch, single(reps), 3) / reps
      plain_runs.append(time_ms(torch, plain(10), 1) / 10)
      seg_times[name] = (sum(runs) / 2, sum(plain_runs) / 2)
      print("%s ms per step (a segment of %d steps of b=250 at a world of 1): "
            "%.4f (runs %.4f, %.4f); plain %.4f (runs %.4f, %.4f); %s's "
            "composition %.4f; %s's whole step %.4f [%s]" % (
                name, reps, seg_times[name][0], *runs, seg_times[name][1],
                *plain_runs, {"K15": "K3", "K16": "K7", "K18": "K9"}[name],
                comp_ms, {"K15": "K2", "K16": "K6", "K18": "K8"}[name],
                single_ms, card))
      # the host's share: 5 steps enqueue inside the launch queue, so the
      # host's own time; 50 steps may fill it, and the host then waits
      for label, run in (("the segment kernel", kernel),
                         ("the composition", lambda k: lambda: composition(
                             *state, data[:k], *args))):
        for k in (5, 50):
          torch.cuda.synchronize()
          t0 = time.perf_counter()
          run(k)()
          host = time.perf_counter() - t0
          torch.cuda.synchronize()
          total = time.perf_counter() - t0
          print("data-parallel %s at a world of 1, %s (%d steps): host "
                "enqueue %.4f ms per step, device and host together %.4f ms "
                "per step [%s]" % (name, label, k, 1e3 * host / k,
                                   1e3 * total / k, card))
  # bench.py's *_dp_rdma_batch250 rows at a world of 1 (per chip), beside
  # the single-device fused trainer, in turns: single, data-parallel,
  # data-parallel, single
  for label, x, held, params_, rows, steps, run_ica in (
      ("fc", batches, held_out, params, "fc_dp_rdma_batch250", TRAIN_STEPS,
       False),
      ("subspace", gbatches, gheld, sub_params, "subspace_dp_rdma_batch250",
       TRAIN_STEPS, False),
      ("ica", ica_batches, None, ica_params(ICA_STEPS, ICA_STEP),
       "ica_dp_rdma_batch250", ICA_STEPS, True)):
    rates = {False: [], True: []}
    for dp in (False, True, True, False):
      p_ = dict(params_, data_parallel=True) if dp else params_
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      if run_ica:
        ica.train_dictionary_scanned(x, id0, p_)
      else:
        compiled_epoch.train_dictionary_scanned(x, held[None], d0, p_)
      torch.cuda.synchronize()
      rates[dp].append(steps * TRAIN_BATCH / (time.perf_counter() - t0))
    dp_rate, one_rate = sum(rates[True]) / 2, sum(rates[False]) / 2
    print("%s (bench.py's %s) at a world of 1: train_dictionary_scanned("
          "data_parallel=True) %.1f patches/s per chip (runs %.1f, %.1f), "
          "%.1f%% of the single-device fused trainer's %.1f (runs %.1f, "
          "%.1f); phase 34's first run %.1f patches/s [%s]" % (
              label, rows, dp_rate, *rates[True], 100 * dp_rate / one_rate,
              one_rate, *rates[False],
              steps * TRAIN_BATCH / dp_runs[label], card))

  # phases 36-38: K19 across devices, ranks of this script on the card
  cs_launches, cs_err, cs_ms, cs_p_ms, cs_bound = code_shard_across_devices(
      torch, K19, lipschitz, compiled_epoch, big_gen, dev, card, k19_ms)

  # phase 39: the solve's two kernels (csrc/fista_core.cuh): the cluster
  # kernel against fista_kernel bitwise, the auto route against plain, the
  # route of every shape, and which kernel the b-250 trainers launch
  lib = _build.load_library()
  cluster_route_cases(torch, fused_fista, fused_group_fista, lib, dev)
  n_bitwise = cluster_bitwise_cases(torch, fused_fista, fused_group_fista,
                                    patches, gtrain, dev)
  cluster_err = solve_plain_cases(torch, fused_fista, fused_group_fista,
                                  lipschitz, patches, gtrain, dev,
                                  (TRAIN_BATCH, 125), CLUSTER_ITERS,
                                  "cluster")
  print("phase 39: %d bitwise cases equal; auto route within %.3e of plain"
        % (n_bitwise, cluster_err))
  dispatch_params = train_params(DISPATCH_STEPS)
  dispatch_sub = subspace_train_params(DISPATCH_STEPS, SUB_STEP)
  for label, x, held, params_ in (
      ("fc (K2, phase 6)", batches, held_out, dispatch_params),
      ("subspace (K6, phase 11)", gbatches, gheld, dispatch_sub),
      ("fc data_parallel (K15, phase 34)", batches, held_out,
       dict(dispatch_params, data_parallel=True)),
      ("subspace data_parallel (K16, phase 34)", gbatches, gheld,
       dict(dispatch_sub, data_parallel=True))):
    run = lambda: compiled_epoch.train_dictionary_scanned(
        x[:DISPATCH_STEPS], held[None], d0, params_)
    seen = solve_dispatch(torch, run)
    print("dispatch (profiled), train_dictionary_scanned %s, %d steps of "
          "b 250: fista_cluster_kernel %d, fista_wide_kernel %d, "
          "fista_kernel %d, fold_gram_kernel %d" % (
              label, DISPATCH_STEPS, seen["cluster"], seen["wide"],
              seen["classic"], seen["fold"]))
    check(seen == {"cluster": DISPATCH_STEPS, "wide": 0, "classic": 0,
                   "fold": 0},
          "%s: expected one fista_cluster_kernel launch a step and no "
          "fista_kernel, saw %s" % (label, seen))

  # phase 40: the persistent ICA segment kernel (csrc/ica_segment.cuh):
  # both routes bitwise equal, the library's layout and grid, a refused
  # launch, which kernels the ICA trainers launch, and the routes' times
  n_ica_equal = ica_persistent_bitwise_cases(torch, K8, parallel, lib, dev)
  print("phase 40: %d route comparisons bitwise equal" % n_ica_equal)
  for label, params_ in (
      ("phase 21's trainer (K8)", ica_params(ICA_STEPS, ICA_STEP)),
      ("phase 34's data_parallel trainer (K18)",
       dict(ica_params(ICA_STEPS, ICA_STEP), data_parallel=True))):
    seen = ica_dispatch(torch, lambda: ica.train_dictionary_scanned(
        ica_batches, id0, params_))
    print("dispatch (profiled), ICA train_dictionary_scanned, %s, one "
          "segment of %d steps: ica_segment_kernel %d, the per-step "
          "route's kernels %d" % (label, ICA_STEPS, seen["segment"],
                                  seen["steps"]))
    check(seen == {"segment": 1, "steps": 0},
          "%s: expected one ica_segment_kernel launch a segment and none "
          "of %s, saw %s" % (label, ", ".join(ICA_STEP_KERNELS), seen))
  ica_route_ms = {}
  with torch.no_grad():
    for name in ("K8", "K18"):
      runs = {"steps": [], "persistent": []}
      for route in ("steps", "persistent", "persistent", "steps"):
        seg = ica_batches[:ICA_ROUTE_STEPS]
        if name == "K8":
          fn = lambda: K8._launch(id0.clone(), ix0.clone(), seg, ICA_STEP,
                                  ICA_REFINE, 1, ICA_BOOST_TOL, route=route)
        else:
          fn = lambda: K8._launch_dp(id0.clone(), ix0.clone(), seg, mesh1,
                                     ICA_STEP, ICA_REFINE, 1, ICA_BOOST_TOL,
                                     route=route)
        fn()
        runs[route].append(time_ms(torch, fn, 3) / ICA_ROUTE_STEPS)
      ica_route_ms[name] = {r: sum(v) / 2 for r, v in runs.items()}
      print("%s ms per step (n 256, b 250, refine 3, upd 1, boost armed; a "
            "%d-step segment): persistent %.4f (runs %.4f, %.4f), per-step "
            "route %.4f (runs %.4f, %.4f), %.2fx; bound %.4f (%s) [%s]" % (
                name, ICA_ROUTE_STEPS, ica_route_ms[name]["persistent"],
                *runs["persistent"], ica_route_ms[name]["steps"],
                *runs["steps"], ica_route_ms[name]["steps"]
                / ica_route_ms[name]["persistent"], k8_bound[0],
                k8_bound[1], card))

  # phase 41: the persistent solve under K19 (csrc/code_shard_solve.cuh):
  # both routes bitwise equal, the library's layout and grid, a refused
  # launch, which kernels phase 24's trainers launched (profiled there)
  # and phase 25's routes in turns (timed there)
  n_cs_equal = cs_persistent_bitwise_cases(torch, K19, lib, dev)
  print("phase 41: %d route comparisons bitwise equal" % n_cs_equal)
  for label, seen in k19_dispatch.items():
    print("phase 41 (c) dispatch (profiled), _code_shard_segment_runner %s, "
          "%d steps: code_shard_solve_kernel %d (%.4f ms a launch), the "
          "per-step route's %s %d" % (label, BIG_STEPS, seen["solve"],
                                      seen["solve_ms"],
                                      ", ".join(CS_STEP_KERNELS),
                                      seen["steps"]))
    check(seen["solve"] == BIG_STEPS and seen["steps"] == 0,
          "%s: expected one code_shard_solve_kernel launch a step and none "
          "of %s, saw %s" % (label, ", ".join(CS_STEP_KERNELS), seen))
  cs_solve_ms = k19_dispatch["fc"]["solve_ms"]

  # phase 42: the large-batch solve (fista_wide_kernel, csrc/
  # fista_core.cuh): against fista_kernel bitwise, the auto route against
  # plain, the route of each shape, which kernels the flagship encodes
  # launch, and the library's product time
  n_wide = wide_bitwise_cases(torch, fused_fista, fused_group_fista,
                              patches, gpatches, dev)
  wide_err = solve_plain_cases(torch, fused_fista, fused_group_fista,
                               lipschitz, patches, gpatches, dev,
                               (BATCH, 1100), ITERS, "wide")
  wide_route_cases(torch, fused_fista, fused_group_fista, lib, dev)
  print("phase 42: %d bitwise cases equal; auto route within %.3e of plain"
        % (n_wide, wide_err))
  for label, fn in (
      ("fc (phase 3)", lambda: encode_dataset(
          patches, dictionary, LAM, ITERS, batch_size=BATCH,
          chunk_batches=4)),
      ("subspace (phase 9)", lambda: encode_dataset(
          gpatches, dictionary, LAM, ITERS, batch_size=BATCH,
          chunk_batches=4, group_assignments=groups))):
    seen = solve_dispatch(torch, fn)
    print("dispatch (profiled), encode_dataset %s, %d patches in batches "
          "of %d: fista_wide_kernel %d, fista_cluster_kernel %d, "
          "fista_kernel %d, fold_gram_kernel %d" % (
              label, patches.shape[0], BATCH, seen["wide"], seen["cluster"],
              seen["classic"], seen["fold"]))
    check(seen == {"wide": NUM_BATCHES, "cluster": 0, "classic": 0,
                   "fold": 0},
          "%s: expected one fista_wide_kernel launch a batch and no other "
          "solve kernel, saw %s" % (label, seen))
  solve_lib_ms = solve_library_ms(torch, dev)
  print("library: %d torch.matmul (%d x 256) @ (256 x 256), fp32, TF32 "
        "off: %.4f ms (K1 %.4f, K4 %.4f ms per flagship solve) [%s]" % (
            ITERS, BATCH, solve_lib_ms, ms, g_ms, card))

  # phase 43: the in-kernel early stop (csrc/fista_core.cuh, "The early
  # stop"): K1 and K4 with the stop on every route against the route
  # without it (bitwise at the reported count), deterministic, at the plain
  # version's count; one flagship K2 and K6 step with it against plain; the
  # flagship trainers with it launch only fista_cluster_kernel; the main
  # path with the stop (counted); the stop's cost an iteration; the stopped
  # solve and trainer against formulation='gram' with the same eps
  from vtc_tpu_torch.ops import solver
  n_stop, stop_err, stop_near, stop_hard = stop_solve_cases(
      torch, fused_fista, fused_group_fista, lipschitz, solver, lib, patches,
      gpatches, dev)
  print("phase 43: %d stopped solves bitwise their route's at the count, "
        "deterministic, at the plain version's count, within %.3e of plain; "
        "%d with a plain mean within 1e-5 relative of eps%s; %d hard cases "
        "from b %d up past the limit (threshold crossings)%s" % (
            n_stop, stop_err, len(stop_near),
            "".join("\n  near eps: " + c for c in stop_near),
            len(stop_hard), STOP_HARD_PLAIN_BATCH,
            "".join("\n  hard: " + c for c in stop_hard)))
  train_eps = stop_train_eps(torch, fused_fista, solver, lipschitz,
                             train_patches, dev)
  stop_step_err = stop_train_step_cases(
      torch, fused_train_step, fused_group_train_step, solver, lipschitz,
      train_patches, gtrain, dev, train_eps)
  stop_counts = stop_trainer_runs(
      torch, compiled_epoch, fused_fista, fused_train_step,
      fused_group_train_step, batches, held_out, gbatches, gheld, d0,
      DISPATCH_STEPS, train_eps)
  # the solve's inputs at b 2048 and the eps of a mid-run stop there
  flag_d = torch.tensor(unit_rows(np.random.RandomState(0), 256, 256),
                        device=dev)
  flag_eta = lipschitz.fista_stepsize(flag_d).reshape(1).float().contiguous()
  sx = torch.tensor(patches[:BATCH], device=dev)
  gsx = torch.tensor(gpatches[:BATCH], device=dev)
  fused_fista.fused_fista_plain(sx, flag_d, LAM, ITERS, flag_eta,
                                early_stopping_epsilon=0.0)
  solve_eps = stop_eps(solver.last_avgs, "mid")
  fused_group_fista.fused_group_fista_plain(
      gsx, flag_d, GROUP_SIZE, LAM, ITERS, flag_eta,
      early_stopping_epsilon=0.0)
  gsolve_eps = stop_eps(solver.last_avgs, "mid")
  stop_groups = contiguous_groups(256, GROUP_SIZE)
  # the main path with the stop: the flagship trainers and the solvers,
  # every count zeroed just before and read just after
  for mod in (fused_fista, fused_group_fista, fused_train_step,
              fused_group_train_step):
    mod.launches = 0
  stop_params = dict(train_params(DISPATCH_STEPS),
                     early_stopping_epsilon=train_eps)
  stop_gparams = dict(subspace_train_params(DISPATCH_STEPS, SUB_STEP),
                      early_stopping_epsilon=train_eps)
  compiled_epoch.train_dictionary_scanned(
      batches[:DISPATCH_STEPS], held_out[None], d0, stop_params)
  compiled_epoch.train_dictionary_scanned(
      gbatches[:DISPATCH_STEPS], gheld[None], d0, stop_gparams)
  ista_fista.run(sx, flag_d, LAM, ITERS, formulation="pallas",
                 early_stopping_epsilon=solve_eps, stepsize=flag_eta)
  sub.run(gsx, flag_d, stop_groups, LAM, ITERS, formulation="pallas",
          early_stopping_epsilon=gsolve_eps, stepsize=flag_eta)
  torch.cuda.synchronize()
  stop_launches = {mod: mod.launches for mod in (
      fused_fista, fused_group_fista, fused_train_step,
      fused_group_train_step)}
  print("phase 43 main path with the stop: K1 %d, K4 %d, K2 %d, K6 %d "
        "launches" % tuple(stop_launches.values()))
  check(tuple(stop_launches.values()) == (1, 1, DISPATCH_STEPS,
                                          DISPATCH_STEPS),
        "the main path with the stop launched %s" % (
            tuple(stop_launches.values()),))
  # µs an iteration without and with the stop (eps 0: never stops, so every
  # iteration does the stop's work), FISTA, fc and 64 x 4 groups
  stop_cost = {}
  for b in (TRAIN_BATCH, BATCH):
    for grouped in (False, True):
      x = (gsx if grouped else sx)[:b]
      with torch.no_grad():
        gram = (flag_d @ flag_d.T).contiguous()
        corr = (x @ flag_d.T).contiguous()
      per = {}
      for eps in (None, 0.0):
        t = {}
        for iters in (25, 125):
          if grouped:
            fn = lambda: fused_group_fista._launch(
                gram, corr, None, flag_eta, LAM, iters, GROUP_SIZE, True,
                False, eps=eps)
          else:
            fn = lambda: fused_fista._launch(gram, corr, None, flag_eta, LAM,
                                             iters, True, 0, eps=eps)
          fn()
          t[iters] = time_ms(torch, fn, 20)
        per[eps is not None] = (t[125] - t[25]) * 10.0
      route = (fused_group_fista if grouped else fused_fista).last_route
      stop_cost[(b, grouped)] = (per[False], per[True])
      print("stop cost, b %d %s (%s route), FISTA: %.3f us an iteration "
            "without the stop, %.3f with it (eps 0, never stops): %.3f us "
            "(design target 0.5: %s) [%s]" % (
                b, "64x4 groups" if grouped else "fc", route, per[False],
                per[True], per[True] - per[False],
                "met" if per[True] - per[False] <= 0.5 else "missed", card))
  # the stopped solve at b 2048 against formulation='gram' (the plain loop,
  # the card's only route before the stop) with the same eps, whole calls
  # (G and c included), and the plain fp32 kernels' stand-ins
  solve_ms = {}
  for label, fn in (
      ("K1 pallas", lambda: ista_fista.run(
          sx, flag_d, LAM, ITERS, formulation="pallas",
          early_stopping_epsilon=solve_eps, stepsize=flag_eta)),
      ("K1 gram", lambda: ista_fista.run(
          sx, flag_d, LAM, ITERS, formulation="gram",
          early_stopping_epsilon=solve_eps, stepsize=flag_eta)),
      ("K4 pallas", lambda: sub.run(
          gsx, flag_d, stop_groups, LAM, ITERS, formulation="pallas",
          early_stopping_epsilon=gsolve_eps, stepsize=flag_eta)),
      ("K4 gram", lambda: sub.run(
          gsx, flag_d, stop_groups, LAM, ITERS, formulation="gram",
          early_stopping_epsilon=gsolve_eps, stepsize=flag_eta))):
    fn()
    solve_ms[label] = time_ms(torch, fn, 10)
  k1_stop_it = int(fused_fista.last_iters.item())
  k4_stop_it = int(fused_group_fista.last_iters.item())
  print("stopped solve, b %d, %d iterations at most: K1 (eps %.4g, %d "
        "iterations) %.4f ms against formulation='gram' %.4f ms (%.2fx); K4 "
        "(eps %.4g, %d iterations) %.4f ms against 'gram' %.4f ms (%.2fx) "
        "[%s]" % (BATCH, ITERS, solve_eps, k1_stop_it, solve_ms["K1 pallas"],
                  solve_ms["K1 gram"], solve_ms["K1 gram"]
                  / solve_ms["K1 pallas"], gsolve_eps, k4_stop_it,
                  solve_ms["K4 pallas"], solve_ms["K4 gram"],
                  solve_ms["K4 gram"] / solve_ms["K4 pallas"], card))
  # the scanned fc trainer at the flagship with the stop, against
  # fc_formulation='gram' with the same eps, in turns
  stop_steps = 200
  trainer_s = {"pallas": [], "gram": []}
  for form in ("pallas", "gram", "gram", "pallas"):
    params_ = dict(train_params(stop_steps), fc_formulation=form,
                   early_stopping_epsilon=train_eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled_epoch.train_dictionary_scanned(
        batches[:stop_steps], held_out[None], d0, params_)
    torch.cuda.synchronize()
    trainer_s[form].append(time.perf_counter() - t0)
  rate = {f: stop_steps * TRAIN_BATCH / (sum(v) / 2)
          for f, v in trainer_s.items()}
  print("scanned fc trainer, %d steps of b %d, FISTA %d, eps %.4g: "
        "fc_formulation='pallas' (K2 with the stop) %.0f patches/s (runs "
        "%.4f, %.4f s), 'gram' %.0f patches/s (runs %.4f, %.4f s): %.2fx "
        "[%s]" % (stop_steps, TRAIN_BATCH, TRAIN_ITERS, train_eps,
                  rate["pallas"], *trainer_s["pallas"], rate["gram"],
                  *trainer_s["gram"], rate["pallas"] / rate["gram"], card))
  # the stop entries of the kernels line: each stopped kernel's time at
  # this run's count against its plain version with the same eps
  stop_times = {}
  for name, fn, plain_fn in (
      ("K1", lambda: fused_fista.fused_fista_solve(
          sx, flag_d, LAM, ITERS, flag_eta, early_stopping_epsilon=solve_eps),
       lambda: fused_fista.fused_fista_plain(
           sx, flag_d, LAM, ITERS, flag_eta,
           early_stopping_epsilon=solve_eps)),
      ("K4", lambda: fused_group_fista.fused_group_fista_solve(
          gsx, flag_d, GROUP_SIZE, LAM, ITERS, flag_eta,
          early_stopping_epsilon=gsolve_eps),
       lambda: fused_group_fista.fused_group_fista_plain(
           gsx, flag_d, GROUP_SIZE, LAM, ITERS, flag_eta,
           early_stopping_epsilon=gsolve_eps))):
    fn()
    plain_fn()
    stop_times[name] = (time_ms(torch, fn, 10), time_ms(torch, plain_fn, 3))
  tx = batches[:DISPATCH_STEPS]
  tgx = gbatches[:DISPATCH_STEPS]
  tv = lipschitz.top_gram_eigenpair(d0)[1].contiguous()
  th = torch.zeros(256, device=dev)
  targs = (LAM, TRAIN_ITERS, TRAIN_STEP)
  tkw = dict(power_iters=2, early_stopping_epsilon=train_eps)
  gkw = dict(tkw, group_assignments=stop_groups)
  for name, fn, plain_fn in (
      ("K2", lambda: fused_train_step.fused_train_segment(
          d0, th, tv, tx, *targs, **tkw),
       lambda: fused_train_step.fused_train_segment_plain(
           d0, th, tv, tx, *targs, **tkw)),
      ("K6", lambda: fused_group_train_step.fused_group_train_segment(
          d0, th, tv, tgx, *targs, **gkw),
       lambda: fused_group_train_step.fused_group_train_segment_plain(
           d0, th, tv, tgx, *targs, **gkw))):
    fn()
    plain_fn()
    stop_times[name] = (time_ms(torch, fn, 3) / DISPATCH_STEPS,
                        time_ms(torch, plain_fn, 1) / DISPATCH_STEPS)
  k2_stop_it = float(fused_train_step.last_iters.float().mean())
  k6_stop_it = float(fused_group_train_step.last_iters.float().mean())
  print("stop builds: K1 %.4f ms (plain %.4f), K4 %.4f ms (plain %.4f) per "
        "b %d solve; K2 %.4f ms (plain %.4f), K6 %.4f ms (plain %.4f) per "
        "flagship step (%.1f and %.1f solve iterations a step) [%s]" % (
            *stop_times["K1"], *stop_times["K4"], BATCH, *stop_times["K2"],
            *stop_times["K6"], k2_stop_it, k6_stop_it, card))


  # phase 44: the conv family's early stop (csrc/conv_gemm.cuh, "The early
  # stop"): K10 and K11 with the stop against the same kernel without it at
  # the count it reports, at the plain version's count and within phase
  # 2's limit of it; one flagship K12 and K17 step likewise; the scanned
  # conv trainer with a mid-run eps; the main path with the stop
  # (counted); the stop's cost an iteration; the stopped K10 and the
  # trainer against formulation 'gram' with the same eps
  t44 = time.perf_counter()
  n_cstop, cstop_counts, cstop_err, cstop_near, cstop_mid = (
      conv_stop_solve_cases(torch, K10, K11, conv_ops, lipschitz, cimages,
                            conv_gen, cpad, dev))
  n_sstop, sstop_err, sstop_near, _ = conv_stop_step_cases(
      torch, K12, K17, parallel, lipschitz, cimages, conv_gen, cpad, dev)
  cnear = cstop_near + sstop_near
  print("phase 44: %d stopped K10/K11 solves and %d stopped K12/K17 steps "
        "bitwise the kernel without the stop at the count, at the plain "
        "version's count, within %.3e of plain; %d with a plain mean within "
        "1e-5 relative of eps%s" % (
            n_cstop, n_sstop, max(list(cstop_err.values())
                                  + list(sstop_err.values())), len(cnear),
            "".join("\n  near eps: " + c for c in cnear)))
  # phase 19's segment again (its images were freed after phase 32)
  stop_images = conv_segment_images(torch, conv_ops, dev, CONV_STOP_STEPS + 1,
                                    conv_gen, seed=19)
  stop_batches, stop_held = (stop_images[:CONV_STOP_STEPS],
                             stop_images[CONV_STOP_STEPS])
  # the trainers' eps: a mid-run stop of the first step's solve
  ctrain_h = torch.zeros(CONV_S, device=dev)
  ctrain_v = lipschitz.top_gram_eigenpair(
      sd0.reshape(CONV_S, -1))[1].contiguous()
  seg_kw = dict(kernel_stride=(CONV_STRIDE, CONV_STRIDE), padding=cpad,
                power_iters=2)
  K12.fused_conv_train_plain(sd0, ctrain_h, ctrain_v, stop_batches[:1],
                             CONV_LAM, SEG_ITERS, SEG_STEP,
                             early_stopping_epsilon=0.0, **seg_kw)
  seg_eps = stop_eps(solver.last_avgs, "mid")
  ctrain_stop_s, ctrain_counts = conv_stop_trainer(
      torch, compiled_epoch, K10, K11, K12, sparse_coding, conv_ista_fista,
      stop_batches, stop_held, sd0, seg_eps)
  # the per-batch trainer's and the serving path's eps
  K10.fused_conv_direct_plain(xt5, cd0, CONV_LAM, CONV_TRAIN_ITERS, eta5,
                              variant="ista", early_stopping_epsilon=0.0,
                              **ckw)
  b5_eps = stop_eps(solver.last_avgs, "mid")
  x3_44 = torch.tensor(x3[:8], device=dev)
  K11.fused_conv_fista_plain(x3_44, d3, CONV_LAM, CONV_ITERS, eta3,
                             kernel_stride=(16, 16), padding=pad3,
                             early_stopping_epsilon=0.0)
  k11_eps = stop_eps(solver.last_avgs, "mid")
  flag_eps = cstop_mid["K10 flagship b40 fista100"]
  # the main path with the stop: every count zeroed just before, read just
  # after: run('pallas') with K10's gate and without it (K11), the
  # per-batch trainer (K10), the scanned trainer (K12) and with
  # data_parallel=True at a world of 1 (K17)
  main_steps = 20
  for mod in (K10, K11, K12, K17):
    mod.launches = 0
  conv_ista_fista.run(xc, conv_d, (CONV_STRIDE, CONV_STRIDE), cpad, CONV_LAM,
                      CONV_ITERS, formulation="pallas",
                      early_stopping_epsilon=flag_eps, stepsize=ceta)
  conv_ista_fista.run(x3_44, d3, (16, 16), pad3, CONV_LAM, CONV_ITERS,
                      formulation="pallas", early_stopping_epsilon=k11_eps,
                      stepsize=eta3)
  sparse_coding.train_dictionary(
      cbatches[:main_steps], cheld[None], cd0,
      dict(conv_train_params(main_steps), early_stopping_epsilon=b5_eps))
  seg_params = dict(conv_segment_params(main_steps, SEG_STEP),
                    early_stopping_epsilon=seg_eps)
  compiled_epoch.train_dictionary_scanned(stop_batches[:main_steps],
                                          stop_held[None], sd0, seg_params)
  compiled_epoch.train_dictionary_scanned(
      stop_batches[:main_steps], stop_held[None], sd0,
      dict(seg_params, data_parallel=True))
  torch.cuda.synchronize()
  cstop_launches = {mod: mod.launches for mod in (K10, K11, K12, K17)}
  print("phase 44 main path with the stop: K10 %d, K11 %d, K12 %d, K17 %d "
        "launches" % tuple(cstop_launches.values()))
  check(tuple(cstop_launches.values()) == (1 + main_steps, 1, main_steps,
                                           main_steps),
        "the conv main path with the stop launched %s" % (
            tuple(cstop_launches.values()),))
  # µs an iteration without and with the stop (eps 0: never stops, so every
  # iteration does the stop's work), in turns: b 40 FISTA and b 5 ISTA
  cstop_cost = {}
  for label, fn in (
      ("b 40 FISTA", lambda iters, eps: K10.fused_conv_direct_solve(
          xc, conv_d, CONV_LAM, iters, ceta, early_stopping_epsilon=eps,
          **ckw)),
      ("b 5 ISTA", lambda iters, eps: K10.fused_conv_direct_solve(
          xt5, cd0, CONV_LAM, iters, eta5, variant="ista",
          early_stopping_epsilon=eps, **ckw))):
    per = {False: [], True: []}
    with torch.no_grad():
      for eps in (None, 0.0, 0.0, None):
        t = {}
        for iters in (25, 125):
          fn(iters, eps)
          t[iters] = time_ms(torch, lambda: fn(iters, eps), 3)
        per[eps is not None].append((t[125] - t[25]) * 10.0)
    off, on = np.mean(per[False]), np.mean(per[True])
    cstop_cost[label] = (off, on)
    print("conv stop cost, K10 %s: %.3f us an iteration without the stop "
          "(runs %s), %.3f with it (eps 0, never stops; runs %s): %.3f us "
          "(design target 3: %s) [%s]" % (
              label, off, ", ".join("%.3f" % v for v in per[False]), on,
              ", ".join("%.3f" % v for v in per[True]), on - off,
              "met" if on - off <= 3.0 else "missed", card))
  # the stopped K10 at the flagship against formulation='gram' (the plain
  # loop, the card's only route before the stop) with the same eps, whole
  # calls, in turns
  cgram_ms = {"pallas": [], "gram": []}
  with torch.no_grad():
    for form in ("pallas", "gram", "gram", "pallas"):
      fn = lambda: conv_ista_fista.run(
          xc, conv_d, (CONV_STRIDE, CONV_STRIDE), cpad, CONV_LAM, CONV_ITERS,
          formulation=form, early_stopping_epsilon=flag_eps, stepsize=ceta)
      fn()
      cgram_ms[form].append(time_ms(torch, fn, 2))
  k10_flag_it = cstop_counts["K10 flagship b40 fista100"][1]
  print("stopped conv solve, b %d, %d iterations at most: K10 (eps %.4g, %d "
        "iterations) %.4f ms (runs %.4f, %.4f) against formulation='gram' "
        "%.4f ms (runs %.4f, %.4f): %.2fx [%s]" % (
            CONV_BATCH, CONV_ITERS, flag_eps, k10_flag_it,
            np.mean(cgram_ms["pallas"]), *cgram_ms["pallas"],
            np.mean(cgram_ms["gram"]), *cgram_ms["gram"],
            np.mean(cgram_ms["gram"]) / np.mean(cgram_ms["pallas"]), card))
  # the scanned conv trainer with the stop against conv_formulation='gram'
  # with the same eps, CONV_STOP_GRAM_STEPS steps, in turns
  ctrainer_s = {"pallas": [], "gram": []}
  for form in ("pallas", "gram", "gram", "pallas"):
    params_ = dict(conv_segment_params(CONV_STOP_GRAM_STEPS, SEG_STEP),
                   conv_formulation=form, early_stopping_epsilon=seg_eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled_epoch.train_dictionary_scanned(
        stop_batches[:CONV_STOP_GRAM_STEPS], stop_held[None], sd0, params_)
    torch.cuda.synchronize()
    ctrainer_s[form].append(time.perf_counter() - t0)
  crate = {f: CONV_STOP_GRAM_STEPS * SEG_BATCH / np.mean(v)
           for f, v in ctrainer_s.items()}
  print("scanned conv trainer, %d steps of b %d, FISTA %d, eps %.4g: "
        "conv_formulation='pallas' (K12 with the stop) %.2f images/s (runs "
        "%.4f, %.4f s), 'gram' %.2f images/s (runs %.4f, %.4f s): %.2fx; the "
        "%d-step run with the stop %.4f s (%.2f images/s) [%s]" % (
            CONV_STOP_GRAM_STEPS, SEG_BATCH, SEG_ITERS, seg_eps,
            crate["pallas"], *ctrainer_s["pallas"], crate["gram"],
            *ctrainer_s["gram"], crate["pallas"] / crate["gram"],
            CONV_STOP_STEPS, ctrain_stop_s,
            CONV_STOP_STEPS * SEG_BATCH / ctrain_stop_s, card))
  # the stop rows of the kernels line: each stopped kernel's time at this
  # run's count against its plain version with the same eps, and the same
  # loop with cuDNN's products at that count (K10, K11)
  cstop_times = {}
  with torch.no_grad():
    for name, mod, fn, plain_fn in (
        ("K10", K10, lambda: K10.fused_conv_direct_solve(
            xc, conv_d, CONV_LAM, CONV_ITERS, ceta,
            early_stopping_epsilon=flag_eps, **ckw),
         lambda: K10.fused_conv_direct_plain(
             xc, conv_d, CONV_LAM, CONV_ITERS, ceta,
             early_stopping_epsilon=flag_eps, **ckw)),
        ("K11", K11, lambda: K11.fused_conv_fista_solve(
            xc, conv_d, CONV_LAM, CONV_ITERS, ceta,
            early_stopping_epsilon=flag_eps, **ckw),
         lambda: K11.fused_conv_fista_plain(
             xc, conv_d, CONV_LAM, CONV_ITERS, ceta,
             early_stopping_epsilon=flag_eps, **ckw))):
      fn()
      it = int(mod.last_iters.item())
      plain_fn()
      lib_fn = lambda: K10.fused_conv_direct_library(
          xc, conv_d, CONV_LAM, it, ceta, **ckw)
      lib_fn()
      cstop_times[name] = (time_ms(torch, fn, 3), time_ms(torch, plain_fn, 2),
                           time_ms(torch, lib_fn, 2), it)
    stop10 = stop_batches[:10]
    for name, mod, fn, plain_fn in (
        ("K12", K12, lambda: K12.fused_conv_train_segment(
            sd0, ctrain_h, ctrain_v, stop10, CONV_LAM, SEG_ITERS, SEG_STEP,
            early_stopping_epsilon=seg_eps, **seg_kw),
         lambda: K12.fused_conv_train_plain(
             sd0, ctrain_h, ctrain_v, stop10[:2], CONV_LAM, SEG_ITERS,
             SEG_STEP, early_stopping_epsilon=seg_eps, **seg_kw)),
        ("K17", K17, lambda: K17.fused_conv_dp_train_segment(
            sd0, ctrain_h, ctrain_v, stop10, CONV_LAM, SEG_ITERS, SEG_STEP,
            mesh=mesh1, early_stopping_epsilon=seg_eps, **seg_kw),
         lambda: K17.fused_conv_dp_train_plain(
             sd0, ctrain_h, ctrain_v, stop10[:2], CONV_LAM, SEG_ITERS,
             SEG_STEP, mesh=mesh1, early_stopping_epsilon=seg_eps,
             **seg_kw))):
      fn()
      its = mod.last_iters.float().mean().item()
      plain_fn()
      cstop_times[name] = (time_ms(torch, fn, 2) / 10,
                           time_ms(torch, plain_fn, 1) / 2, None, its)
  print("conv stop builds: K10 %.4f ms (plain %.4f, cuDNN's products %.4f) "
        "at %d of %d iterations; K11 %.4f ms (plain %.4f, cuDNN's products "
        "%.4f) at %d; K12 %.4f ms a step (plain %.4f) at %.1f of %d "
        "iterations a step; K17 %.4f (plain %.4f) at %.1f [%s]" % (
            *cstop_times["K10"], CONV_ITERS, *cstop_times["K11"],
            cstop_times["K12"][0], cstop_times["K12"][1],
            cstop_times["K12"][3], SEG_ITERS, cstop_times["K17"][0],
            cstop_times["K17"][1], cstop_times["K17"][3], card))
  del stop_images, stop_batches
  print("phase 44 took %.1f s" % (time.perf_counter() - t44))


  # phase 45: the early stop of K15, K16 and K19 (stop_segments_phase)
  dpstop_launches, dpstop_err, csstop_err, dpstop_times = (
      stop_segments_phase(torch, dev, card, K15, K16, K19, mesh1,
                          compiled_epoch, lipschitz))

  # phase 46: the precision tiers of K1, K4, K2 and K6 (tier_phase)
  tiers = tier_phase(torch, dev, card, patches, train_patches, tier_data)

  # phase 47: the tiers of K3, K7, K15 and K16 (dp_tier_phase)
  dp_tiers = dp_tier_phase(torch, dev, card, train_patches, gtrain,
                           tier_data)

  # phase 48: the tiers of K10, K12, K13 and K17 (conv_tier_phase)
  conv_tiers = conv_tier_phase(torch, dev, card, (K10, K12, K17), cimages,
                               conv_d, cpad, xt5, cd0, eta5, sd0, conv_gen)

  check(not [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "vtc_tpu")],
        "the smoke run imported JAX or the JAX package")
  # bounds at each kernel's timed shape (fp32 SIMT peak, HBM rate)
  k1_bound = solve_bound(BATCH, 256, 256, ITERS)
  stop_geo = K10.geometry(xc.shape, conv_d.shape, (CONV_STRIDE, CONV_STRIDE))
  stop_op, _ = K11.operator_and_corr(xc, conv_d, (CONV_STRIDE, CONV_STRIDE),
                                     cpad)
  k2_bound = train_step_bound(TRAIN_BATCH, 256, 256, TRAIN_ITERS)
  kernels = [
      ("fused_fista", "fused_fista.cu", "vtc_tpu/ops/pallas_fista.py:220",
       launches + fit_launches, max_err, ms, p_ms, k1_bound),
      ("fused_train_step", "fused_train_step.cu",
       "vtc_tpu/ops/pallas_train_step.py:1589", train_launches, train_err,
       step_ms, plain_step_ms, k2_bound),
      ("fused_group_fista", "fused_group_fista.cu",
       "vtc_tpu/ops/pallas_group_fista.py:238", group_launches, group_err,
       g_ms, gp_ms, k1_bound),
      ("fused_group_train_step", "fused_group_train_step.cu",
       "vtc_tpu/ops/pallas_train_step.py:1402", group_train_launches,
       group_train_err, gstep_ms, gplain_step_ms, k2_bound),
      ("fused_conv_direct", "fused_conv_direct.cu",
       "vtc_tpu/ops/pallas_conv_direct.py:416",
       conv_launches + conv_train_launches, conv_err, k10_ms, k10_p_ms,
       (k10_bound, k10_by)),
      ("fused_conv_fista", "fused_conv_fista.cu",
       "vtc_tpu/ops/pallas_conv_fista.py:329", k11_launches, conv_err_gram,
       k11_ms, k11_p_ms, (k11_bound, k11_by)),
      ("fused_conv_train", "fused_conv_train_step.cu",
       "vtc_tpu/ops/pallas_conv_train.py:692", k12_launches, k12_err,
       k12_ms, k12_p_ms, k12_bound),
      ("fused_ica_train", "fused_ica_train_step.cu",
       "vtc_tpu/ops/pallas_ica_train.py:311", k8_launches, k8_err, k8_ms,
       k8_p_ms, k8_bound),
      ("fused_code_shard_train", "fused_code_shard_train_step.cu",
       "vtc_tpu/ops/pallas_code_shard_train.py:616", k19_launches, k19_err,
       k19_ms, k19_p_ms, k19_bound),
      ("code_shard_solve (K19's solve, one launch a step)",
       "code_shard_solve.cuh",
       "vtc_tpu/ops/pallas_code_shard_train.py:370 (fista_body of :233)",
       k19_solves, k19_err, cs_solve_ms, k19_p_ms,
       cs_solve_bound(BIG_B, BIG_S, 256, TRAIN_ITERS)),
      ("fused_code_shard_train across devices",
       "fused_code_shard_train_step.cu",
       "vtc_tpu/ops/pallas_code_shard_train.py:616 (code axis > 1)",
       cs_launches, cs_err, cs_ms, cs_p_ms, cs_bound),
      ("fused_solve_stats", "fused_train_step.cu",
       "vtc_tpu/ops/pallas_train_step.py:975", dp2_launches["K3"], k3_err,
       dp_times["K3"][0], dp_times["K3"][1], k3_bound),
      ("fused_group_solve_stats", "fused_group_train_step.cu",
       "vtc_tpu/ops/pallas_train_step.py:1175", dp2_launches["K7"], k7_err,
       dp_times["K7"][0], dp_times["K7"][1], k3_bound),
      ("ica_solve_stats", "fused_ica_train_step.cu",
       "vtc_tpu/ops/pallas_ica_train.py:250", dp2_launches["K9"], k9_err,
       dp_times["K9"][0], dp_times["K9"][1], k9_bound),
      ("conv_solve_stats", "fused_conv_train_step.cu",
       "vtc_tpu/ops/pallas_conv_train.py:922", dp2_launches["K13"], k13_err,
       k13_ms, k13_p_ms, k13_bound),
      ("fused_conv_dp_train", "fused_conv_train_step.cu",
       "vtc_tpu/ops/pallas_conv_dp_train.py:399", k17_launches, k17_err,
       k17_ms, k17_p_ms, k17_bound),
      ("fused_dp_train", "fused_train_step.cu",
       "vtc_tpu/ops/pallas_dp_train.py:404", dp_runs["fc launches"], k15_err,
       seg_times["K15"][0], seg_times["K15"][1], k2_bound),
      ("fused_group_dp_train", "fused_group_train_step.cu",
       "vtc_tpu/ops/pallas_group_dp_train.py:443",
       dp_runs["subspace launches"], k16_err, seg_times["K16"][0],
       seg_times["K16"][1], k2_bound),
      ("fused_ica_dp_train", "fused_ica_train_step.cu",
       "vtc_tpu/ops/pallas_ica_train.py:394", dp_runs["ica launches"],
       k18_err, seg_times["K18"][0], seg_times["K18"][1], k8_bound),
      # the stop builds (phase 43): launches on its main path, the error of
      # its stopped solves (a) or flagship steps (b), the times and bounds
      # at the iterations this run's data took
      ("fused_fista (early stop)", "fused_fista.cu",
       "vtc_tpu/ops/pallas_fista.py:107-130 (the stop test of :220)",
       stop_launches[fused_fista], stop_err, *stop_times["K1"],
       solve_bound(BATCH, 256, 256, k1_stop_it)),
      ("fused_group_fista (early stop)", "fused_group_fista.cu",
       "vtc_tpu/ops/pallas_group_fista.py:105-130 (the stop test of :238)",
       stop_launches[fused_group_fista], stop_err, *stop_times["K4"],
       solve_bound(BATCH, 256, 256, k4_stop_it)),
      ("fused_train_step (early stop)", "fused_train_step.cu",
       "vtc_tpu/ops/pallas_train_step.py:486-512 (the stop test of :1589)",
       stop_launches[fused_train_step], stop_step_err, *stop_times["K2"],
       train_step_bound(TRAIN_BATCH, 256, 256, k2_stop_it)),
      ("fused_group_train_step (early stop)", "fused_group_train_step.cu",
       "vtc_tpu/ops/pallas_train_step.py:665-690 (the stop test of :1402)",
       stop_launches[fused_group_train_step], stop_step_err,
       *stop_times["K6"], train_step_bound(TRAIN_BATCH, 256, 256,
                                           k6_stop_it)),
      # the conv stop builds (phase 44): launches on its main path, the
      # error of its stopped solves (a) or flagship steps (b), the times and
      # bounds at the iterations this run's data took
      ("fused_conv_direct (early stop)", "fused_conv_direct.cu",
       "vtc_tpu/ops/pallas_conv_direct.py:307-334 (the stop test of :416)",
       cstop_launches[K10], cstop_err[K10], *cstop_times["K10"][:2],
       conv_direct_bound(stop_geo, CONV_BATCH, cstop_times["K10"][3])),
      ("fused_conv_fista (early stop)", "fused_conv_fista.cu",
       "vtc_tpu/ops/pallas_conv_fista.py:329 (with the stop of vtc_tpu/"
       "analysis_transforms/convolutional/ista_fista.py:163-176)",
       cstop_launches[K11], cstop_err[K11], *cstop_times["K11"][:2],
       conv_gram_bound(stop_op, CONV_BATCH, cstop_times["K11"][3])),
      ("fused_conv_train (early stop)", "fused_conv_train_step.cu",
       "vtc_tpu/ops/pallas_conv_train.py:320-344 (the stop test of :692)",
       cstop_launches[K12], sstop_err[K12], *cstop_times["K12"][:2],
       conv_train_bound(seg_geo, SEG_BATCH, cstop_times["K12"][3])),
      ("fused_conv_dp_train (early stop)", "fused_conv_train_step.cu",
       "vtc_tpu/ops/pallas_conv_dp_train.py:143-213 (the stop test of :399)",
       cstop_launches[K17], sstop_err[K17], *cstop_times["K17"][:2],
       conv_dp_bound(seg_geo, SEG_BATCH, cstop_times["K17"][3], 1, 10)),
      # the stop builds of phase 45: launches on its main path, the error of
      # its stopped steps (a, c), the times and bounds at this run's counts
      ("fused_dp_train (early stop)", "fused_train_step.cu",
       "vtc_tpu/ops/pallas_dp_train.py:206-248 (the stop test of :404)",
       dpstop_launches[K15], dpstop_err["K15"], *dpstop_times["K15"][:2],
       train_step_bound(TRAIN_BATCH, 256, 256, dpstop_times["K15"][2])),
      ("fused_group_dp_train (early stop)", "fused_group_train_step.cu",
       "vtc_tpu/ops/pallas_group_dp_train.py:189-229 (the stop test of "
       ":443)", dpstop_launches[K16], dpstop_err["K16"],
       *dpstop_times["K16"][:2],
       train_step_bound(TRAIN_BATCH, 256, 256, dpstop_times["K16"][2])),
      ("fused_code_shard_train (early stop)",
       "fused_code_shard_train_step.cu",
       "vtc_tpu/ops/pallas_code_shard_train.py:387-431 (the stop test of "
       ":616)", dpstop_launches[K19], csstop_err, *dpstop_times["K19"][:2],
       code_shard_step_bound(BIG_B, BIG_S, 256, dpstop_times["K19"][2])),
  ]
  # the tier kernel (phase 46): launches on its main path, the error of the
  # flagship solve or step at the tier, its time beside the plain version
  # at the tier and its bound at the bf16 tensor-core rate
  tier_rows = {"K1": ("fused_fista.cu", "vtc_tpu/ops/pallas_fista.py:44-56 "
                      "(_make_iter_dot's tier in the kernel of :220)"),
               "K4": ("fused_group_fista.cu",
                      "vtc_tpu/ops/pallas_group_fista.py:54-66 (the tier "
                      "of :238, _make_group_prox's rounding)"),
               "K2": ("fused_train_step.cu",
                      "vtc_tpu/ops/pallas_train_step.py:398-411 (the tier "
                      "of :1589)"),
               "K6": ("fused_group_train_step.cu",
                      "vtc_tpu/ops/pallas_train_step.py:541-588, :691 (the "
                      "tier of :1402)")}
  tier_mods = dict(zip(("K1", "K4", "K2", "K6"), tiers["mods"]))
  tier_library = {}
  for key, (source, replaces) in tier_rows.items():
    for tier in TIER_NAMES:
      ms_t, p_t, bnd_t, lib_t = tiers["times"][key, tier]
      name = "fista_tier_kernel (%s at %s, via %s)" % (key, tier, source)
      kernels.append((name, "fista_tier.cuh", replaces,
                      tiers["counts"][tier_mods[key], tier],
                      tiers["full_errs"][key, tier], ms_t, p_t, bnd_t))
      tier_library[name] = lib_t
    # the STOP build at bf16x3: launches on the main path with the stop,
    # the worst error of its stop cases, its time at a mid-run eps
    ms_s, p_s, bnd_s, lib_s, _ = tiers["stop_times"][key]
    name = "fista_tier_kernel (%s at bf16x3, early stop, via %s)" % (
        key, source)
    family = {"K1": "K1 fista", "K4": "K4 M4", "K2": "K2 step",
              "K6": "K6 step"}[key]
    kernels.append((name, "fista_tier.cuh", replaces,
                    tiers["stop_counts"][tier_mods[key]],
                    tiers["stops"][family, "bf16x3"][1], ms_s, p_s, bnd_s))
    tier_library[name] = lib_s
  # the tier kernel inside the data-parallel kernels (phase 47): launches on
  # its main path, the error of the flagship step at the tier, its time a
  # step beside the plain version at the tier, its bound and the library
  # time of the step's solve passes as products of bf16 operands
  dp_tier_rows = {
      "K3": ("fused_solve_stats", "fused_train_step.cu",
             "vtc_tpu/ops/pallas_train_step.py:854-925 (the tier of :975)"),
      "K7": ("fused_group_solve_stats", "fused_group_train_step.cu",
             "vtc_tpu/ops/pallas_train_step.py:1010-1080, :1074 (the tier "
             "of :1175)"),
      "K15": ("fused_dp_train", "fused_train_step.cu",
              "vtc_tpu/ops/pallas_dp_train.py:129-190 (the tier of :404)"),
      "K16": ("fused_group_dp_train", "fused_group_train_step.cu",
              "vtc_tpu/ops/pallas_group_dp_train.py:94-231 (the tier of "
              ":443)")}
  for key, (wrapper, source, replaces) in dp_tier_rows.items():
    for tier in TIER_NAMES:
      ms_t, p_t, bnd_t, lib_t = dp_tiers["times"][key, tier]
      name = "fista_tier_kernel (%s, %s at %s, via %s)" % (key, wrapper,
                                                          tier, source)
      kernels.append((name, "fista_tier.cuh", replaces,
                      dp_tiers["counts"][dp_tiers["mods"][key], tier],
                      dp_tiers["errs"][key, tier], ms_t, p_t, bnd_t))
      tier_library[name] = lib_t
  # the conv tier kernel (phase 48): launches on its main path, the error of
  # the flagship solve or step at the tier, its time (a step) beside the
  # plain version at the tier, its bound and the library time of the same
  # solve with each pass one product of bf16 operands
  conv_tier_rows = {
      "K10 b40": ("K10", "fused_conv_direct.cu",
                  "vtc_tpu/ops/pallas_conv_train.py:240-267 (_make_deep_dot's "
                  "tier in the kernel of vtc_tpu/ops/pallas_conv_direct.py:"
                  "416)", "K10 b40 fista100"),
      "K12 step": ("K12", "fused_conv_train_step.cu",
                   "vtc_tpu/ops/pallas_conv_train.py:240-300 (the tile "
                   "solver's tier in the kernel of :692)", "K12 step"),
      "K13 shard": ("K13", "fused_conv_train_step.cu",
                    "vtc_tpu/ops/pallas_conv_train.py:240-300 (the tile "
                    "solver's tier in the kernel of :922)",
                    "K13 shard b20 gradient"),
      "K17 step": ("K17", "fused_conv_train_step.cu",
                   "vtc_tpu/ops/pallas_conv_dp_train.py:129-134 (the tile "
                   "solver's tier in the kernel of :399)", "K17 step")}
  for row, (key, source, replaces, case) in conv_tier_rows.items():
    for tier in TIER_NAMES:
      ms_t, p_t, bnd_t, lib_t = conv_tiers["times"][row, tier]
      name = "gather_gemm_tier (%s at %s, via %s)" % (key, tier, source)
      kernels.append((name, "conv_gemm_tier.cuh", replaces,
                      conv_tiers["counts"][key, tier],
                      conv_tiers["errs"][case, tier], ms_t, p_t, bnd_t))
      tier_library[name] = lib_t
  # K10's library time is its own loop with each product one cuDNN call
  # (phase 17), K11's the same loop on K11's timed inputs (the same
  # function), and with the stop that loop at the iterations the stopped
  # solve took (phase 44); K1's and K4's the 100 iteration products of
  # their timed solve, each one torch.matmul in fp32 without the prox
  # (phase 42), and with the stop those of the iterations the stopped solve
  # took; no PyTorch call computes any other kernel's solve or step, so
  # theirs are null
  library_ms = {"fused_conv_direct": k10_lib, "fused_conv_fista": k10_lib,
                "fused_conv_direct (early stop)": cstop_times["K10"][2],
                "fused_conv_fista (early stop)": cstop_times["K11"][2],
                "fused_fista": solve_lib_ms,
                "fused_group_fista": solve_lib_ms,
                "fused_fista (early stop)":
                    solve_lib_ms / ITERS * k1_stop_it,
                "fused_group_fista (early stop)":
                    solve_lib_ms / ITERS * k4_stop_it, **tier_library}
  print(json.dumps({"kernels": [{
      "name": name,
      "route": "cuda",
      "source": "vtc_tpu_torch/csrc/" + source,
      "replaces": replaces,
      "launches": n,
      "max_abs_err": err,
      "ms": t,
      "plain_ms": t_plain,
      "bound_ms": bnd[0],
      "bound_by": bnd[1],
      "library_ms": library_ms.get(name),
  } for name, source, replaces, n, err, t, t_plain, bnd in kernels]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": kind,
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  if len(sys.argv) == 5 and sys.argv[1] == "--dp-rank":
    # one rank of phase 28's world of 2, started by main()
    sys.exit(dp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
  if len(sys.argv) == 5 and sys.argv[1] == "--cs-rank":
    # one rank of phases 36-38, started by main()
    sys.exit(cs_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
  if len(sys.argv) == 5 and sys.argv[1] == "--stop-rank":
    # one rank of phase 45's worlds of 2 and 4, started by main()
    sys.exit(stop_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                            sys.argv[4]))
  if len(sys.argv) == 5 and sys.argv[1] == "--tier-rank":
    # one rank of phase 47's world of 2, started by main()
    sys.exit(dp_tier_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4]))
  if len(sys.argv) == 5 and sys.argv[1] == "--conv-tier-rank":
    # one rank of phase 48's world of 2, started by main()
    sys.exit(conv_tier_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
  sys.exit(main())
