#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``shotvae_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code not 0, no result line) on failure:

1. Print the card's name and power limit (nvidia-smi), then build every
   CUDA source of ``shotvae_torch/csrc`` with nvcc into ``build/kernels/``,
   and require warpgroup products (HGMMA) and TMA copies (UTMALDG or
   UBLKCP) in the SASS of the bf16 fused conv, and asynchronous copies
   (LDGSTS, or UTMALDG / UBLKCP) in that of the f32 fused conv, whose
   registers and spills per kernel (``-Xptxas -v``) are printed.
2. Each kernel against its plain PyTorch version on the card, at every
   distinct shape the serving forward gives it at batch 768, with its
   tolerance; each timed with CUDA events (kernel, plain version, and a
   one-call library yardstick where there is one); the fused conv also
   held at ``CONV_CHECK_SHAPES`` in f32 and bf16. The sampler
   (``csrc/fused_sample.cu``) is held to its plain version exactly where
   the draw cannot matter (a vanishing sigma, a decisive logit), by
   moments, in standard errors, against an independent draw, and draw for
   draw against its plain version on the host fed the same Philox
   uniforms (``TOL_DRAW``) at the serving shape, Dd = 100 and ragged
   shapes; the floor of one launch (an empty kernel) and the wrapper's
   host us per call are printed beside its time.
3. End to end: a full-width WRN-28-2 SHOT-VAE (32x32x3, Dc 128, K 10) with
   seeded random weights and running statistics behind ``ShotVaeInference``
   on ``cuda``: ``classify``, ``encode``, ``reconstruct`` and ``generate`` on
   768 seeded uint8 images, with the kernel launch counts of each endpoint
   checked, and ``classify`` / ``encode`` / ``decode`` / ``reconstruct``
   on 16 images held against the same model on the CPU (plain path). The
   endpoints run under PyTorch's default float32 settings (cuDNN may use
   TF32): they pin exact float32 themselves (``device.exact_f32``), and
   the comparison with the CPU shows it. Endpoint latencies are printed,
   and one ``reconstruct`` is profiled.
4. The ``bn_leaky_train`` kernels (statistics, apply, backward reduce,
   backward apply) against their plain versions at every (M, C, slope) of a
   WRN-28-2 train step at batch 768, timed beside their bytes bound; the
   two reductions bit-identical over two calls and over two streams at
   once, and one CUDA kernel per call (torch.profiler); the train-mode fused conv site's forward and
   backward at the four encoder shapes against plain autograd.
5. Training: the SHOT-VAE train step (``shotvae_torch.train.steps``) of the
   headline configuration (CIFAR-10 shape, WRN-28-2, BCE reconstruction,
   optimal-match mixup) at 768 labeled + 768 unlabeled, seeded random
   weights and data: a few steps with every kernel's launch count checked
   and the loss finite; step ms in exact float32 (as the entry points run
   it) and, a study of the bare step function, with cuDNN's TF32 on,
   unlabeled images/s and one profiled step; the eval step's latency at
   768; one step on the card against the same step on the CPU at 16 + 16
   with every draw injected, the crops and flips replayed: metrics, each
   parameter's gradient (to within what one ulp of the weights moves the
   CPU's), the parameters and running statistics after it.
6. The bf16 trunk (``VariationalAutoEncoder(dtype=torch.bfloat16)``, the
   JAX package's default): the bf16 variants of the ``bn_leaky`` and
   ``bn_act`` kernels and the bf16 fused conv (``csrc/fused_conv_bf16.cu``,
   persistent, TMA and warp-specialised ``wgmma``) against their plain
   versions at every main-path shape, timed beside their bounds, the conv
   also at the JAX test shapes and ragged ones (``CONV_CHECK_SHAPES``);
   the train-mode fused site's bf16 backward;
   three bf16 train steps at 768 + 768 with the bf16 launch counts checked,
   step times, one profiled step and the bf16 eval step; one bf16 step on
   the card against the same bf16 step on the CPU at 16 + 16, each metric,
   gradient, update and running statistic within max(a floor, 3x the CPU's
   own distance between its bf16 and f32 steps on the same inputs).
7. The training loop (``shotvae_torch.train.loop.run_shot_vae``), the
   path a user of ``python -m shotvae_torch.cli.main_shot_vae`` takes: one
   bf16 epoch of the headline configuration at 768 + 768 on 50,000
   synthetic CIFAR-10 images resident on the card (58 train steps, then 25
   eval forwards: 7 valid batches, 17 test batches and the reconstruction
   grid), with every kernel's launches over the epoch checked, a finite
   loss, accuracies in [0, 1] and the checkpoint pointer leading to a
   file; the epoch's seconds, its train part's unlabeled images/s beside
   phase 6's bf16 step median, and its eval seconds. The checkpoint
   restored into a fresh bf16 model and optimizer equals the loop's final
   state bit for bit, and ``ShotVaeInference.from_checkpoint`` serves it
   (``classify`` on 16 images equal to an f32 model loaded from the final
   state). Resume at the JAX tests' tiny size (WRN-10-1, batch 64, 512
   images, bf16) with cuDNN deterministic: one epoch, a resume, one more
   equals two straight epochs bit for bit (parameters, buffers, momentum,
   step, history), the ``ewm`` bump before the resume point; the straight
   run writes its second epoch's profile trace (``--profile-dir``).
8. The M2 baseline (``make_m2_train_step``, the path of ``python -m
   shotvae_torch.cli.main_m2_vae``) with the bf16 trunk at full width: a
   few train steps at 768 + 768 with every kernel's launches checked
   (``EXPECTED_M2_TRAIN_LAUNCHES``) and the loss finite; the median and
   range of 10 steps, unlabeled images/s, one profiled step and the eval
   step at 768; one step on the card against the same step on the CPU at
   16 + 16 with every draw injected and the crops and flips replayed, in
   f32 (the tolerances of phase 5) and in bf16 (those of phase 6); then one
   bf16 epoch of ``run_shot_vae(m2=True)`` on the 50,000 synthetic images
   (58 steps, 25 eval forwards) with its launches exactly the step's and
   the eval step's multiples, and nothing written outside
   ``Cifar10-M2-VAE``.
9. The supervised classifier (``make_classifier_train_step``, the path of
   ``python -m shotvae_torch.cli.main_classifier``), the same at 768
   labeled: step times and labeled images/s, the eval step, the card
   against the CPU at 16 in f32 and bf16, and one epoch of
   ``run_classifier`` (4,000 labeled images: 6 steps, then 7 valid and 17
   test forwards) with its launches checked, nothing written outside
   ``Cifar10-SSL-Classifier``.
11. The PreActResNet and DenseNet encoders (run after phase 9, before
   the lines of phase 10), in bf16 on CIFAR-100's shape (K 100):
   preactresnet18 and densenet121, their BN sites found by running each
   encoder once (13 fused, 7 standalone of which 3 identity; 58 fused, 62
   standalone). Every kernel against its plain version at every distinct
   shape they give it at batch 768, with ReLU (slope 0) and the identity
   site (slope 1): the four ``bn_leaky`` kernels, ``bn_act`` in bf16 and
   f32, the fused conv in bf16 and f32 (timed beside its bound and
   ``F.conv2d``; 4x4 maps and Cin 512 included) and the train-mode fused
   site's backward; the fused conv also held at DenseNet-BC's and
   densenet161's narrow Cout (12 to 48), and in f32 at
   ``CONV_CHECK_SHAPES`` with ReLU and the identity. The bf16 SHOT-VAE
   step at 768 + 768 of preactresnet18, densenet121 and densenet121 with
   --efficient
   (``EXPECTED_ENCODER_LAUNCHES``, the recompute's launches included),
   their times, a profiled step, peak memory and the eval step; each
   family's step on the card against the CPU at 16 + 16 in f32 and bf16;
   the efficient step against the plain one on the same draws (cuDNN
   deterministic): metrics and running statistics equal, gradients within
   one bf16 ulp. The M2 step over preactresnet18 and one bf16 epoch of
   ``run_shot_vae(m2=True)`` on 50,000 synthetic CIFAR-100 images; f32
   ``ShotVaeInference.from_checkpoint`` of both models at 768
   (``classify``, ``reconstruct``) with launches, times and 16 images
   against the CPU.
12. The one-stage smooth-ELBO trainers (run after phase 11, before the
   lines of phase 10), the paths of ``python -m
   shotvae_torch.cli.main_smooth_elbo_mnist`` and ``..._svhn`` at their
   CLI defaults, in f32 under PyTorch's default settings (the entry point
   pins exact float32): two MNIST epochs of ``run_smooth_elbo`` on seeded
   idx files of 60,000 / 10,000 28x28 images written under ``build/``
   (468 steps of 128 + 4 an epoch after the resize on the card, 10 eval
   batches of 1,000) and two SVHN epochs through the synthetic fallback
   (2,048 / 512 images, 8 steps of 256 + 512 an epoch, the plateau
   scheduler on), each with finite losses, accuracies in [0, 1], the
   epoch-1 average loss inside the band of the CPU's runs at seeds 1 to 5
   widened by its width (``SMOOTH_BANDS``), the JAX loop's log text and
   the checkpoint strict-loading into a fresh ``SmoothVAE`` equal to the
   final weights bit for bit; per configuration the step's median and
   range of
   10 and unlabeled images/s, the idle share of one profiled step, the
   eval step at its test batch and the epoch's train and eval seconds; one
   step on the card against the CPU at the configuration's batches with
   every draw injected (metrics, gradients, parameters and Adam moments;
   Adam's tiny-gradient elements counted). Every hand kernel's launch
   counter reads 0 over the phase: the smooth VAE has no BatchNorm, its
   train draw needs a gradient and its eval forward draws nothing.
13. Data parallelism (``shotvae_torch.parallel``; run after phase 12).
   The group path at world size 1 over NCCL in this process: the bf16
   sync-BN SHOT-VAE step at 768 + 768 with every collective issued
   (between the ``bn_leaky`` and fused conv kernels, the mixup gathers,
   the gradient and metric means), its launches counted, against today's
   step (no group) on the same inputs and draws, at the calibrated bf16
   bound of the two f32 steps. Then two ranks on the one card over gloo
   (``spawn_ranks``; the card has one GPU and NCCL takes one rank per
   GPU), a global 768 + 768 (384 + 384 a rank): the sync-BN step in f32
   (metrics and state at TOL_STEP, gradients as phase 5 holds them) and
   in bf16, and the per-replica bf16 step (rank 0's running statistics)
   against one process's steps on the same draws, at the calibrated bf16
   bound, every kernel's launches counted on each rank; each rank's bf16
   step time, two processes sharing one card with host-staged
   collectives (not a multi-GPU speed); one epoch of ``run_shot_vae`` on
   12,000 synthetic images on both ranks (9 steps, 12 eval forwards on
   rank 0 and 11 on rank 1), the same history on both, rank
   0's checkpoint restored on each equal to its final state bit for bit,
   and files written by rank 0 only. A rank that fails or outlasts
   DP_TIMEOUT_S fails the phase.
14. The fused two-stream SHOT-VAE step (``fused_streams``; run after phase
   13): the headline configuration at 768 + 768 in f32 and in bf16, two
   forwards of 1,536 rows a step, every kernel's launches over 3 steps
   (``EXPECTED_FUSED_TRAIN_LAUNCHES``: 66 / 66 / 61 / 61 ``bn_leaky``
   and 44 fused conv a step) and the model's forwards counted; its
   median and range of 10 steps and the four-forward step's, in turns in
   this process, the idle share of one profiled step of each and their
   peak memory; one fused step on the card against the CPU at 16 + 16
   with every draw injected, in f32 (phase 5's tolerances) and in bf16
   (phase 6's, calibrated on the fused step over BF16_CALIBRATION_DRAWS
   inputs). The bf16 fused step through an NCCL group of one rank
   against the bare fused step (phase 13's check). A WRN-28-2 checkpoint
   in the reference's layout, ``.module`` at each ``nn.DataParallel``
   position (``REFERENCE_WRAPPED_AT``), saved as ``{"epoch", "args",
   "state_dict"}`` and served by ``from_checkpoint``: ``classify`` and
   ``encode`` at 768 equal the plain-key checkpoint's bit for bit; a
   wrapped MLP classifier and smooth VAE state_dict strict-loaded
   (``io.reference.load_reference_state_dict``).
15. ``--steps-per-call`` (``train.chunk``; run after phase 14): the bf16
   SHOT-VAE step at 768 + 768 as one CUDA graph of CHUNK_STEPS (8) steps,
   then the f32 one, then the bf16 M2 and classifier steps: an eager
   chunk and CHUNK_REPLAYS replays (3; 1 in f32) against the same steps
   dispatched one by one on a copy of the model, with the same host
   generators and index rows, under cuDNN's deterministic flag: the
   metrics, then every parameter, BN statistic and momentum buffer, bit
   for bit; the replays' launch counters equal to the path's per-step
   launches times the steps (132 / 132 / 122 / 122 ``bn_leaky`` and 88
   fused conv launches a SHOT step) and to the eager steps'; each
   captured graph's kernel nodes, read through libcuda, equal to the
   launches its capture counted (a replay adds those counts: a wrapper
   counts in Python); under the default flags a second capture: its
   seconds, the per-step medians of the replays and of eager steps in
   turns (CHUNK_ROUNDS rounds), one profiled replay (device busy time,
   idle share, its kernels by name, at most the counters), the peak
   memory beside an eager step's. Then the encoders in graphs of 2 steps
   at 768 + 768: preactresnet18 and densenet121 --efficient with dropout
   0.2 the same way (one replay), and densenet121 alone at its peak
   memory with an eval step while the graph's pool is held. Then one bf16 ``run_shot_vae`` epoch at
   ``steps_per_call`` 8 on phase 7's 50,000 images (58 steps = 7 x 8 + 2)
   with phase 7's launches exactly, its graphs' kernel nodes measured,
   and its history within CHUNK_LOOP_LOSS_REL / CHUNK_LOOP_TOP1_ABS, and
   two tiny epochs across the LR warm-up's end and the ewm bump at N = 4
   against N = 1, bit for bit; under ``build/chunk_*``, removed after.
   Each line carries the card's name and power limit.
16. ``--steps-per-call`` over a process group (run after phase 15):
   through an NCCL group of one rank in this process (phase 13's set-up),
   the bf16 sync-BN SHOT-VAE step, the per-replica one with global mixup
   (rank 0's running statistics) and the sync-BN classifier step, each as
   one graph of CHUNK_STEPS steps held as phase 15 holds its paths (3
   replays against 32 eager group steps bit for bit, launches and kernel
   nodes), the collectives of the replays and of each capture equal to
   the eager steps', each graph's nodes by type (NCCL's kernels apart),
   and under the default flags the replays, eager group steps and
   replays with no group timed in turns. Then one torchrun launch of the
   SHOT-VAE CLI at ``--steps-per-call`` 4 for two epochs of 9 steps on
   12,000 synthetic images, its second epoch resumed from its first
   epoch's checkpoint by the same CLI in this process, bit for bit; under
   ``build/group_*``, removed after. Each line carries the card's name
   and power limit.
10. Print the ``kernels`` JSON line (each kernel's launches on every path,
   the M2, classifier, encoder, data-parallel, fused and chunked paths,
   in one process and over a group, included),
   then the result line ``{"ok": true, "device": {...}}`` as the last
   line.

Exits with an error, printing no result, where torch sees no card or where
the script stands without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import glob
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 768          # ShotVaeConfig.batch_size, the headline batch
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12          # H100 SXM f32 without tensor cores
TOL_BN = 1e-5      # abs + rel: same arithmetic, at most an FMA contraction
#                    apart; norm-wise for sums over the rows
TOL_CONV = 2e-4    # abs + rel: f32 sums of 9*Cin terms in other orders
TOL_SAMPLE = 1e-6  # abs + rel: sampler outputs that no draw can change
MOMENT_SE = 6.0    # sampler moments may differ by at most 6 standard errors
SAMPLE_SEEDS = 32  # draws per sampler for the moments
# abs + rel: the sampler's draw against its plain version on the host, fed
# the same Philox uniforms: the same f32 arithmetic, with the card's logf,
# cosf and expf (within 2 ulp) in place of the CPU's and the softmax summed
# in another order, leaves a few ulp of |mean| + |sigma * eps| (up to about
# 20); a word from another counter moves an element by order 1
TOL_DRAW = 1e-5
# (B, Dc, Dd) of the exact-draw check: the serving shape, CIFAR-100's Dd,
# then ragged ones: odd Dc (an unpaired last column), an odd row width with
# an even Dc (no float2 access), one element, and a Dd above 128 (lanes
# take several Gumbel groups)
DRAW_SHAPES = lambda b: [(b, 128, 10), (b, 128, 100), (5, 127, 3),  # noqa: E731
                         (7, 64, 9), (1, 1, 1), (3, 5, 257)]
TOL_E2E = 1e-3     # abs + rel: 28 f32 layers, other summation orders, TF32 off
TOL_GRAD = 1e-3    # norm-wise: conv and BN gradients, sums of B*H*W terms
TOL_STEP = 1e-3    # abs + rel: one train step, card against CPU, TF32 off
# Its gradients, norm-wise rel per parameter: f32 rounding alone moves them
# by up to a few 1e-2 (a one-ulp change of the weights moves the CPU's own
# by as much: LeakyReLU masks flip at pre-activations within rounding of 0,
# and BN backwards cancel), while a zeroed, swapped or cut gradient is off
# by about 1
TOL_GRAD_STEP = 0.1
ULP_FACTOR = 3.0   # ... or 3x the CPU's own one-ulp spread, where larger
BF16_FLOPS = 989e12        # H100 SXM dense bf16 on the tensor cores
ULP_BF16 = 2.0 ** -7  # one bf16 ulp, relative, at most: a bf16 output of the
#                    kernel and of its plain version round f32 values that
#                    may differ in their last bits, so they may land on
#                    neighbouring bf16 values; the f32 tolerance above is
#                    added as slack
# The bf16 card-against-CPU step: each metric, gradient, update and running
# statistic within max(BF16_FLOOR norm-wise, BF16_FACTOR x the CPU's own
# distance between its bf16 and its f32 step on the same inputs)
BF16_FACTOR = 3.0
BF16_FLOOR = 1e-3
# ... the CPU's distance taken as its largest over the step's inputs and
# two more, for the M2 and classifier steps and phase 11's encoder steps
# (the headline SHOT-VAE check takes one): a scalar's bf16 rounding lands
# far under its usual size on some inputs (a discrete KL of about 0.03)
BF16_CALIBRATION_DRAWS = 3
TRAIN_STEPS = 3    # counted train steps at full batch
COMPARE_BATCH = 16  # per stream, for the card-against-CPU step
# (M, C, slope, BN sites per forward, backward launches per train step) of
# a WRN-28-2 SHOT-VAE train step; the M are for a batch of b. Encoder sites
# (22 fused before a stride-1 3x3 conv, 6 standalone: 2 before a stride-2
# conv, 3 shortcut norms, the transition) run in all 4 forwards and get a
# gradient in all 4; the decoder's 5 (ReLU, slope 0) run in all 4 forwards
# and get a gradient in forwards 1 and 3 only, whose reconstructions enter
# the loss.
BN_TRAIN_SITES = lambda b: [  # noqa: E731
    (b * 1024, 16, 0.01, 2, 8),   # g1u1 norm1 (fused) + shortcut norm
    (b * 1024, 32, 0.01, 9, 36),  # 7 fused; g2u1 norm1 + shortcut norm
    (b * 256, 64, 0.01, 9, 36),   # 7 fused; g3u1 norm1 + shortcut norm
    (b * 64, 128, 0.01, 8, 32),   # 7 fused; the transition
    (b, 1024, 0.0, 1, 2), (b * 4, 512, 0.0, 1, 2), (b * 16, 256, 0.0, 1, 2),
    (b * 64, 128, 0.0, 1, 2), (b * 256, 64, 0.0, 1, 2)]  # decoder norm0-4
# (B, Cin, H, W, Cout) at which the bf16 fused conv is held to the f32 conv
# of its rounded operands but not timed: the JAX package's test shapes
# (tests/test_pallas.py:135-136), then ragged ones: H and W not multiples
# of the kernel's 8x8 tile, B = 1, Cin a multiple of 8 but not of 16 (the
# wrapper pads the weight's input channels), a last N slice of 8 channels;
# then Cin past the 320 whose weight slice stays in shared memory, so the
# weights stream through the stages: WRN-28-10's third group (640 -> 640
# at 8x8) and a ragged one; then maps smaller than one tile (4x4, as in
# PreActResNet's group 4, streamed at Cin 512, and DenseNet's block 4;
# 2x2) and DenseNet-BC's narrow Cout (12, not a multiple of 8, stored
# without the TMA; 24, 40, 48)
CONV_CHECK_SHAPES = [(8, 128, 8, 8, 128), (4, 64, 16, 16, 64),
                     (2, 32, 32, 32, 32), (6, 128, 8, 8, 64),
                     (1, 24, 13, 11, 32), (1, 8, 9, 17, 16),
                     (3, 40, 7, 5, 72), (2, 640, 8, 8, 640),
                     (1, 360, 5, 9, 40), (1, 128, 4, 4, 32),
                     (1, 512, 4, 4, 512), (1, 64, 2, 2, 64),
                     (2, 48, 8, 8, 12), (2, 96, 16, 8, 24),
                     (1, 160, 4, 4, 40), (1, 192, 2, 2, 48),
                     (1, 48, 5, 3, 12)]
# kernel launches per train step at WRN-28-2, from the sites above: the
# fused conv kernel at the 22 fused sites of each of 4 forwards (its
# backward is cuDNN plus the bn_leaky kernels); statistics and apply at all
# 33 sites of each forward (apply standalone in the forward, as the
# recompute of the fused sites in the backward); the two backward kernels
# 28 * 4 + 5 * 2 = 122 times; no eval kernel
EXPECTED_TRAIN_LAUNCHES = {"fused_bn_act_conv": 88, "bn_act_inference": 0,
                           "fused_joint_sample": 0, "bn_stats": 132,
                           "bn_apply": 132, "bn_bwd_reduce": 122,
                           "bn_bwd_apply": 122}
# the eval step at WRN-28-2: one serving forward with the kernel's draw
EXPECTED_EVAL_LAUNCHES = {"fused_bn_act_conv": 22, "bn_act_inference": 11,
                          "fused_joint_sample": 1, "bn_stats": 0,
                          "bn_apply": 0, "bn_bwd_reduce": 0,
                          "bn_bwd_apply": 0}
# kernel launches per fused two-stream train step (``fused_streams``) at
# WRN-28-2: two forwards of 2B rows; the fused conv at the 22 fused sites of
# each, statistics and apply at all 33 sites of each; the two backward
# kernels 28 * 2 + 5 = 61 times (forward B's reconstruction enters no
# loss, so the decoder's 5 sites get a gradient in forward A only)
EXPECTED_FUSED_TRAIN_LAUNCHES = {"fused_bn_act_conv": 44,
                                 "bn_act_inference": 0,
                                 "fused_joint_sample": 0, "bn_stats": 66,
                                 "bn_apply": 66, "bn_bwd_reduce": 61,
                                 "bn_bwd_apply": 61}
# kernel launches per M2 train step at WRN-28-2: two forwards (the labeled
# one with its labels' one-hots, the unlabeled one with the draw), both
# reconstructions in the loss, so all 33 BN sites of each get a gradient
EXPECTED_M2_TRAIN_LAUNCHES = {"fused_bn_act_conv": 44, "bn_act_inference": 0,
                              "fused_joint_sample": 0, "bn_stats": 66,
                              "bn_apply": 66, "bn_bwd_reduce": 66,
                              "bn_bwd_apply": 66}
# per classifier train step: one encoder forward and backward (22 fused
# sites, 28 BN sites, each with a gradient); per eval step: the encoder in
# eval mode, as ``classify``
EXPECTED_CLS_TRAIN_LAUNCHES = {"fused_bn_act_conv": 22,
                               "bn_act_inference": 0,
                               "fused_joint_sample": 0, "bn_stats": 28,
                               "bn_apply": 28, "bn_bwd_reduce": 28,
                               "bn_bwd_apply": 28}
EXPECTED_CLS_EVAL_LAUNCHES = {"fused_bn_act_conv": 22, "bn_act_inference": 6,
                              "fused_joint_sample": 0, "bn_stats": 0,
                              "bn_apply": 0, "bn_bwd_reduce": 0,
                              "bn_bwd_apply": 0}
# the loop's epoch at the headline configuration on 50,000 synthetic
# CIFAR-10 images: 500 valid and 400 labeled images per class, 45,000
# unlabeled, so 45,000 // 768 = 58 train steps; then eval forwards over
# ceil(5,000 / 768) = 7 valid and ceil(12,500 / 768) = 17 test batches and
# the 4-image reconstruction grid
LOOP_CONFIG = dict(dataset="Cifar10", net_name="wideresnet-28-2",
                   batch_size=BATCH, br=True, om=True, synthetic_data=True,
                   synthetic_size=50_000, reconstruct_freq=1, ckpt_every=1,
                   yes=True)
LOOP_STEPS = 58
LOOP_EVAL_FORWARDS = 25
# the classifier's epoch on the same data: its 4,000 labeled images at
# batch 768, ceil(4,000 / 768) = 6 steps, then 7 valid and 17 test batches
CLS_LOOP_STEPS = 6
CLS_LOOP_EVAL_FORWARDS = 24
# per path: the launches of one train step and of one eval forward
PATHS = {"shot": (EXPECTED_TRAIN_LAUNCHES, EXPECTED_EVAL_LAUNCHES),
         "fused": (EXPECTED_FUSED_TRAIN_LAUNCHES, EXPECTED_EVAL_LAUNCHES),
         "m2": (EXPECTED_M2_TRAIN_LAUNCHES, EXPECTED_EVAL_LAUNCHES),
         "classifier": (EXPECTED_CLS_TRAIN_LAUNCHES,
                        EXPECTED_CLS_EVAL_LAUNCHES)}
# the resume check's size: the JAX tests' _tiny_cfg
# (tests/test_loops_e2e.py:25-33) in bf16, the ewm bump at epoch 0
RESUME_CONFIG = dict(dataset="Cifar10", batch_size=64,
                     net_name="wideresnet-10-1", ldc=8, synthetic_data=True,
                     synthetic_size=512, valid_per_class=10,
                     annotated_per_class=10, yes=True, reconstruct_freq=1,
                     print_freq=100, adjust_lr=[0, 1, 2])
# an encoder path: the net, the dataset whose shape and classes it trains
# on, and DenseNet's block recomputation; the headline one
WRN = dict(net="wideresnet-28-2", dataset="Cifar10", efficient=False)
CLASSES = {"Cifar10": 10, "Cifar100": 100}
# kernel launches per endpoint at WRN-28-2: (fused conv, bn_act, sample)
EXPECTED_LAUNCHES = {"classify": (22, 6, 0), "encode": (22, 6, 0),
                     "reconstruct": (22, 11, 1), "generate": (0, 5, 0)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph after warm-up, replayed ``reps`` times between CUDA events, so
    the host's launch overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the warmed-up stream
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _sms(dev) -> int:
    """The card's SMs, which size the kernels' launch plans (132 where
    the plain versions run on the CPU)."""
    from shotvae_torch.ops.kernels import sm_count

    return sm_count(dev.index or 0) if dev.type == "cuda" else 132


def host_ms(dev, fn, reps: int = 5) -> float:
    """Mean wall time of ``fn()`` after one warm-up, ending in a device
    synchronise."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def device_breakdown(fn, top: int = 8) -> dict:
    """One ``fn()`` under torch.profiler: wall time, device busy time and
    the kernels that took the most device time. User annotations on the
    device's timeline (``Optimizer.step#Adam.step``, ``#SGD.step``) span
    kernels that are counted themselves, so they are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def max_err(got, want, tol: float, *, normwise: bool = False,
            ulp: float = 0.0, what: str = "") -> float:
    """max |got - want|; raises where it exceeds ulp * |want| + tol * (1 +
    |want|), or, ``normwise``, the same of max |want|: the measure for sums
    over many rows, whose rounding scales with the tensor and not with each
    entry. ``ulp`` is ULP_BF16 for a bf16 output."""
    import torch

    got, want = got.detach().double(), want.detach().double()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"non-finite output {what}")
    scale = want.abs().max() if normwise else want.abs()
    bad = diff > ulp * scale + tol * (1.0 + scale)
    check(not bool(bad.any()), f"kernel disagrees with its plain version "
          f"{what}: max abs err {float(diff.max()):.3e} beyond tol {tol}"
          f"{f' + {ulp:.3e} relative' if ulp else ''}"
          f"{' norm-wise' if normwise else ''}")
    return float(diff.max())


def ulp_of(t) -> float:
    """The relative ulp that ``max_err`` allows a tensor of t's dtype."""
    import torch

    return ULP_BF16 if t.dtype == torch.bfloat16 else 0.0


# ----------------------------------------------------------------- phase 2


def bn_act_phase(dev, batch: int, dtype=None, cases=None):
    """bn_act_inference at each (M, C, slope) of the serving forward (the
    eval step's in bf16), x and y in ``dtype`` (None: float32); ``cases``
    (M, C, slope, launches per forward) in place of the WRN-28-2's."""
    import torch

    from shotvae_torch.ops.kernels.bn_act import bn_act_inference, bn_act_plain

    dtype = dtype or torch.float32
    size = torch.finfo(dtype).bits // 8
    b = batch
    # (M, C, slope, launches per reconstruct)
    cases = cases or [(b * 32 * 32, 16, 0.01, 1),   # group-1 shortcut norm
             (b * 32 * 32, 32, 0.01, 2),   # group-2 unit-1 norm1 + shortcut
             (b * 16 * 16, 64, 0.01, 2),   # group-3 unit-1 norm1 + shortcut
             (b * 8 * 8, 128, 0.01, 1),    # transition
             (b, 1024, 0.0, 1), (b * 4, 512, 0.0, 1), (b * 16, 256, 0.0, 1),
             (b * 64, 128, 0.0, 1), (b * 256, 64, 0.0, 1)]  # decoder norm0-4
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, err = [], 0.0
    for m, c, slope, n in cases:
        x = (torch.randn((m, c), generator=gen, device=dev) * 2
             + 0.5).to(dtype)
        w = torch.rand((c,), generator=gen, device=dev) + 0.5
        bias = torch.randn((c,), generator=gen, device=dev) * 0.5
        rm = torch.randn((c,), generator=gen, device=dev) * 0.5
        rv = torch.rand((c,), generator=gen, device=dev) * 1.5 + 0.5
        kernel = lambda: bn_act_inference(x, w, bias, rm, rv, 1e-5, slope)  # noqa: E731
        plain = lambda: bn_act_plain(x, w, bias, rm, rv, 1e-5, slope)  # noqa: E731
        got = kernel()
        check(got.dtype == dtype, f"bn_act gave {got.dtype} for {dtype}")
        e = max_err(got, plain(), TOL_BN, ulp=ulp_of(got),
                    what=f"bn_act at {(m, c, slope)} {dtype}")
        err = max(err, e)
        nbytes = 2 * size * m * c + 16 * c
        rows.append(dict(shape=[m, c], slope=slope, launches=n, max_abs_err=e,
                         ms=time_ms(kernel), plain_ms=time_ms(plain),
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         library_ms=None))
    return rows, err


def conv_phase(dev, batch: int, dtype=None, cases=None, slope: float = 0.01,
               check_shapes=None):
    """fused_bn_act_conv at each (B, Cin, H, W, Cout) of the encoder, x, the
    weight and y in ``dtype`` (None: float32), the activation
    LeakyReLU(``slope``). In bf16 the kernel is held against the f32 conv
    (TF32 off) of the bf16-rounded activation and weight, within one bf16
    ulp plus TOL_CONV; the plain version and the library call then
    convolve in bf16. Both dtypes are also held at CONV_CHECK_SHAPES (not
    timed). ``cases`` (B, Cin, H, W, Cout, launches per forward) replace
    WRN-28-2's, and ``check_shapes`` the shapes held but not timed. An
    f32 row carries the kernel's launch plan (``bn``, ``runs``, ``grid``)."""
    import torch
    import torch.nn.functional as F

    from shotvae_torch.ops.kernels.fused_conv import (conv_f32_plan,
                                                      fused_bn_act_conv,
                                                      fused_bn_act_conv_plain)

    dtype = dtype or torch.float32
    size, peak = ((2, BF16_FLOPS) if dtype == torch.bfloat16
                  else (4, F32_FLOPS))
    b = batch
    # (B, Cin, H, W, Cout, launches per encoder forward)
    cases = cases or [(b, 16, 32, 32, 32, 1), (b, 32, 32, 32, 32, 7),
                      (b, 64, 16, 16, 64, 7), (b, 128, 8, 8, 128, 7)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cl = dict(memory_format=torch.channels_last)

    def held(bb, cin, h, w, cout):
        """Seeded inputs at one shape, the kernel's output held to the f32
        conv of the rounded operands; returns the error and the inputs."""
        x = torch.randn((bb, cin, h, w), generator=gen,
                        device=dev).to(dtype).contiguous(**cl)
        scale = torch.rand((cin,), generator=gen, device=dev) + 0.5
        shift = torch.randn((cin,), generator=gen, device=dev) * 0.5  # != 0
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).to(dtype).contiguous(**cl)
        got = fused_bn_act_conv(x, scale, shift, wt, slope=slope)
        check(got.dtype == dtype, f"fused conv gave {got.dtype} for {dtype}")
        pre = x.float() * scale[:, None, None] + shift[:, None, None]
        act = torch.where(pre > 0, pre, slope * pre).to(dtype)
        e = max_err(got, F.conv2d(act.float(), wt.float(), padding=1),
                    TOL_CONV, ulp=ulp_of(got),
                    what=f"fused conv at {(bb, cin, h, w, cout)} slope "
                    f"{slope} {dtype}")
        return e, (x, scale, shift, wt, act)

    rows, err = [], 0.0
    for bb, cin, h, w, cout, n in cases:
        e, (x, scale, shift, wt, act) = held(bb, cin, h, w, cout)
        err = max(err, e)
        kernel = lambda: fused_bn_act_conv(  # noqa: E731
            x, scale, shift, wt, slope=slope)
        plain = lambda: fused_bn_act_conv_plain(  # noqa: E731
            x, scale, shift, wt, slope=slope)
        library = lambda: F.conv2d(act, wt, padding=1)  # noqa: E731
        flops = 2 * bb * h * w * 9 * cin * cout
        nbytes = (size * (bb * h * w * (cin + cout) + 9 * cin * cout)
                  + 8 * cin)
        plan = {}
        if dtype == torch.float32:
            p = conv_f32_plan(bb, h, w, cout, _sms(dev))
            plan = dict(plan=dict(bn=p["bn"], runs=p["runs"],
                                  grid=[p["grid_m"], p["grid_n"]]))
        rows.append(dict(shape=[bb, cin, h, w, cout], launches=n, **plan,
                         max_abs_err=e, ms=time_ms(kernel),
                         plain_ms=time_ms(plain),
                         bound_ms=max(flops / peak,
                                      nbytes / HBM_BYTES_PER_S) * 1e3,
                         bound_by=("operations" if flops / peak
                                   > nbytes / HBM_BYTES_PER_S else "bytes"),
                         library_ms=time_ms(library)))
    for shape in CONV_CHECK_SHAPES if check_shapes is None else check_shapes:
        err = max(err, held(*shape)[0])
    return rows, err


def moments_gap(a, b) -> float:
    """Largest gap between the column means of two sample matrices (rows
    are draws), in standard errors of the difference."""
    a, b = a.double(), b.double()
    se = (a.var(0) / a.shape[0] + b.var(0) / b.shape[0]).sqrt()
    return float(((a.mean(0) - b.mean(0)).abs() / se.clamp_min(1e-12)).max())


def independent_draw(mean, log_sigma, log_alpha, generator):
    """[z ; y] from ``torch.rand`` uniforms of ``generator``: the sampler's
    law from another generator, for the moment checks, which need samples
    independent of the kernel's."""
    import torch

    from shotvae_torch.ops.kernels.fused_sample import (
        joint_sample_from_uniforms)

    u = [torch.rand(t.shape, generator=generator, device=t.device)
         for t in (mean, mean, log_alpha)]
    return joint_sample_from_uniforms(mean, log_sigma, log_alpha, *u)


def sample_phase(dev, batch: int):
    """fused_joint_sample at the serving shape (batch, 128, 10): exactly
    against the plain version where no draw can change the output, one
    seed one bitstream, by moments against an independent draw and the
    target law, then the draw itself against the plain version on the host
    fed the same Philox uniforms at DRAW_SHAPES. On the card also the floor
    of one launch (an empty kernel) and the wrapper's host us per call."""
    import torch
    import torch.nn.functional as F

    from shotvae_torch.ops.kernels.fused_sample import (
        empty_launch, fused_joint_sample, fused_joint_sample_plain)
    from shotvae_torch.ops.sampling import draw_seed

    b, dc, dd, groups = batch, 128, 10, min(4, batch)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    mean = torch.randn((b, dc), generator=g, device=dev)
    host = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    on_dev = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731

    # exp(-80) * eps is far below an ulp of mean, and a logit 100 above the
    # rest outweighs any Gumbel draw (range about 31): z must equal mean and
    # y the one-hot of each row's leading class, element by element
    lead = (torch.arange(b, device=dev) * 7 + 3) % dd
    onehot = F.one_hot(lead, dd).float()
    vanish = torch.full((b, dc), -80.0, device=dev)
    sharp = torch.log_softmax(100.0 * onehot, 1)
    out = fused_joint_sample(mean, vanish, sharp, generator=host(7))
    ref = fused_joint_sample_plain(mean, vanish, sharp,
                                   seed=draw_seed(host(7)))
    err = max(max_err(out, ref, TOL_SAMPLE),
              max_err(out, torch.cat([mean, onehot], 1), TOL_SAMPLE))

    # the random part: per-element sigmas and, cycling over the rows, a few
    # distinct logit vectors; SAMPLE_SEEDS draws from each sampler
    def latent_inputs(b, dc, dd, groups):
        log_sigma = torch.empty((b, dc), device=dev).uniform_(
            math.log(0.5), math.log(2.0), generator=g)
        vecs = torch.log_softmax(1.5 * torch.randn((groups, dd), generator=g,
                                                   device=dev), 1)
        grp = torch.arange(b, device=dev) % groups
        return log_sigma, vecs[grp].contiguous(), grp

    log_sigma, log_alpha, grp = latent_inputs(b, dc, dd, groups)
    out = fused_joint_sample(mean, log_sigma, log_alpha, generator=host(7))
    check(torch.equal(out, fused_joint_sample(mean, log_sigma, log_alpha,
                                              generator=host(7))),
          "the same seed gave different bits")
    check(not torch.equal(out, fused_joint_sample(mean, log_sigma, log_alpha,
                                                  generator=host(8))),
          "a different seed gave the same bits")

    def samples(draw):
        """Sample matrices (rows: draws x batch rows): the standardised z
        and its square per column; y and y^2 per class, for each logit
        vector."""
        d = torch.stack([draw(100 + s) for s in range(SAMPLE_SEEDS)])
        check(bool(torch.isfinite(d).all()), "non-finite sample")
        y = d[..., dc:]
        check(bool((y >= 0).all()), "negative Gumbel-softmax probability")
        simplex = float((y.sum(-1) - 1).abs().max())
        check(simplex < 1e-5, f"Gumbel-softmax rows sum to 1 +- {simplex:.2e}")
        z = (d[..., :dc] - mean) * torch.exp(-log_sigma)
        return [torch.cat([z, z * z], -1).reshape(-1, 2 * dc)] + [
            torch.cat([y[:, grp == k], y[:, grp == k] ** 2], -1).reshape(
                -1, 2 * dd) for k in range(groups)]

    kernel_s = samples(lambda s: fused_joint_sample(
        mean, log_sigma, log_alpha, generator=host(s)))
    plain_s = samples(lambda s: independent_draw(
        mean, log_sigma, log_alpha, on_dev(s)))
    gap = max(moments_gap(k, p) for k, p in zip(kernel_s, plain_s))
    check(gap < MOMENT_SE, f"kernel and plain sampler moments differ by "
          f"{gap:.2f} standard errors")
    target = torch.cat([torch.zeros(dc, device=dev),
                        torch.ones(dc, device=dev)])
    zs = kernel_s[0].double()
    drift = float(((zs.mean(0) - target).abs()
                   / (zs.var(0) / zs.shape[0]).sqrt()).max())
    check(drift < MOMENT_SE, f"standardised z moments {drift:.2f} standard "
          f"errors off N(0, 1)")

    # the draw itself: the kernel against the plain version on the host, fed
    # the uniforms of the same seed's Philox counters
    draw_err, same, total = 0.0, 0, 0
    inputs = {}
    for i, (bb, c, d) in enumerate(DRAW_SHAPES(b)):
        m = torch.randn((bb, c), generator=g, device=dev)
        ls, la, _ = latent_inputs(bb, c, d, min(4, bb))
        inputs[(bb, c, d)] = (m, ls, la)
        got = fused_joint_sample(m, ls, la, generator=host(SEED + 20 + i))
        want = fused_joint_sample_plain(
            m.cpu(), ls.cpu(), la.cpu(), seed=draw_seed(host(SEED + 20 + i)))
        check(got.shape == (bb, c + d), f"sampler gave {tuple(got.shape)} "
              f"at {(bb, c, d)}")
        draw_err = max(draw_err, max_err(
            got.cpu(), want, TOL_DRAW, what=f"at {(bb, c, d)}, fed the same "
            f"Philox uniforms"))
        same += int((got.cpu() == want).sum())
        total += want.numel()
    err = max(err, draw_err)

    cuda = dev.type == "cuda"
    rows = []
    for bb, c, d in DRAW_SHAPES(b)[:2]:
        m, ls, la = inputs[(bb, c, d)]
        seeds = host(SEED)
        kernel = lambda: fused_joint_sample(m, ls, la,  # noqa: E731
                                            generator=seeds)
        plain = lambda: fused_joint_sample_plain(m, ls, la,  # noqa: E731
                                                 seed=SEED)
        nbytes = 4 * (2 * bb * c + bb * d + bb * (c + d))
        rows.append(dict(
            shape=[bb, c, d], launches=int(d == dd), max_abs_err=err,
            ms=time_ms(kernel), plain_ms=time_ms(plain),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, library_ms=None,
            # 1000 eager calls: the host sets the pace of so short a kernel
            host_us_per_call=host_ms(dev, kernel, 1000) * 1e3 if cuda
            else None))
    # the floor of one launch: an empty kernel of one block and of the
    # sampler's grid (8 Gumbel rows, or 256 Gaussian pairs, a block)
    grid = -(-b // 8) + -(-b * -(-dc // 2) // 256)
    rows[0].update(
        moments_vs_plain_se=gap, moments_vs_target_se=drift,
        draw_max_abs_err=draw_err, draw_bit_identical_share=same / total,
        floor_ms=time_ms(lambda: empty_launch(dev)) if cuda else None,
        floor_grid_ms=(time_ms(lambda: empty_launch(dev, grid)) if cuda
                       else None), grid=grid)
    return rows, err


# ----------------------------------------------------------------- phase 3


def _randomize_bn(model):
    """Seeded random BN affines and running statistics, in place."""
    import torch

    from shotvae_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(SEED + 3)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.num_features
                m.weight.copy_(torch.rand(c, generator=g) * 0.4 + 0.8)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return model


def random_model(device: str, dtype=None, net: dict = WRN):
    """A full-width SHOT-VAE of the encoder path ``net`` (default the
    headline WRN-28-2 on CIFAR-10) with seeded random weights and BN
    statistics (the same for every ``dtype``, the trunk's compute dtype,
    and either ``efficient``)."""
    import torch

    from shotvae_torch.models.vae import VariationalAutoEncoder

    torch.manual_seed(SEED)
    return _randomize_bn(VariationalAutoEncoder(
        net["net"], continuous_latent_dim=128,
        disc_latent_dim=CLASSES[net["dataset"]], device=device, dtype=dtype,
        efficient=net["efficient"], drop_rate=net.get("drop_rate", 0.0)))


def random_classifier(device: str, dtype=None):
    """A full-width WRN-28-2 classifier (K 10) with the trainer's explicit
    init from seeds and seeded random BN statistics (the same for every
    ``dtype``)."""
    import torch

    from shotvae_torch.models.classifier import (WideResNetClassifier,
                                                 apply_classifier_init)

    torch.manual_seed(SEED)
    model = WideResNetClassifier(28, 2, 10, device=device, dtype=dtype)
    apply_classifier_init(model, torch.Generator().manual_seed(SEED + 7))
    return _randomize_bn(model)


def end_to_end(batch: int, kernels):
    """The main path: the four serving endpoints on the card, with launch
    counts; then the CPU comparison on 16 images."""
    import torch

    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.device import exact_f32
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    cpu_model = random_model("cpu")
    gpu = ShotVaeInference(copy.deepcopy(cpu_model), device="cuda")
    cpu = ShotVaeInference(cpu_model, device="cpu")
    g = torch.Generator().manual_seed(SEED + 4)
    images = torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.arange(batch) % 10
    endpoints = {
        "classify": lambda: gpu.classify(images),
        "encode": lambda: gpu.encode(images),
        "reconstruct": lambda: gpu.reconstruct(
            images, generator=torch.Generator().manual_seed(SEED + 5)),
        "generate": lambda: gpu.generate(
            labels, generator=torch.Generator().manual_seed(SEED + 6)),
    }
    counts = lambda: tuple(k.launches for k in kernels)  # noqa: E731
    for k in kernels:
        k.launches = 0
    outs = {}
    for name, fn in endpoints.items():
        before = counts()
        outs[name] = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(counts(), before))
        check(delta == EXPECTED_LAUNCHES[name], f"{name} launched (conv, "
              f"bn_act, sample) = {delta}, expected {EXPECTED_LAUNCHES[name]}")
    launches = counts()

    probs = outs["classify"]
    mean, log_sigma, log_alpha = outs["encode"]
    recon, gen_img = outs["reconstruct"], outs["generate"]
    check(probs.shape == (batch, 10) and mean.shape == (batch, 128)
          and log_sigma.shape == (batch, 128) and log_alpha.shape == (batch, 10)
          and recon.shape == (batch, 32, 32, 3)
          and gen_img.shape == (batch, 32, 32, 3), "unexpected output shapes")
    for name, t in [("classify", probs), ("mean", mean),
                    ("log_sigma", log_sigma), ("log_alpha", log_alpha),
                    ("reconstruct", recon), ("generate", gen_img)]:
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    check(float((probs.sum(1) - 1).abs().max()) < 1e-5,
          "class probabilities do not sum to 1")
    for name, t in [("reconstruct", recon), ("generate", gen_img)]:
        check(float(t.min()) >= 0 and float(t.max()) <= 1,
              f"{name} leaves [0, 1]")

    # the same model on the CPU's plain path, first 16 images
    n = 16
    e2e_err = {}
    e2e_err["classify"] = max_err(probs[:n].cpu(), cpu.classify(images[:n]),
                                  TOL_E2E)
    for name, got, want in zip(("mean", "log_sigma", "log_alpha"),
                               (mean, log_sigma, log_alpha),
                               cpu.encode(images[:n])):
        e2e_err[name] = max_err(got[:n].cpu(), want, TOL_E2E)
    latent = torch.cat([torch.randn((n, 128), generator=g),
                        torch.eye(10)[torch.arange(n) % 10]], dim=1)
    with torch.inference_mode(), exact_f32():  # the bare model: no entry
        e2e_err["decode"] = max_err(gpu.model.decode(latent.to(gpu.device)).cpu(),
                                    cpu.model.decode(latent), TOL_E2E)
        # reconstruct = sigmoid(decode(sample(encode(x)))): the kernel's draw
        # for the same seed and encoder outputs, decoded on the CPU
        draw = fused_joint_sample(mean, log_sigma, log_alpha,
                                  gpu.model.sample_temperature,
                                  generator=torch.Generator().manual_seed(
                                      SEED + 5))
        want = torch.sigmoid(cpu.model.decode(draw[:n].cpu()))
        e2e_err["reconstruct"] = max_err(recon[:n].cpu(),
                                         want.permute(0, 2, 3, 1), TOL_E2E)

    dev = gpu.device
    timing = {name: host_ms(dev, fn) for name, fn in endpoints.items()}
    breakdown = device_breakdown(endpoints["reconstruct"])
    return launches, e2e_err, timing, breakdown


# ----------------------------------------------------------------- phase 4


def events_ms(fn, iters: int = 10) -> float:
    """Device time of one ``fn()`` between CUDA events, after warm-up, for
    work (autograd) that is not captured in a CUDA graph; host launch time
    is included where the card waits for it."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# the two bn_leaky reductions, each one kernel per call: wrapper -> kernel
REDUCTIONS = {"bn_stats": "_stats_kernel", "bn_bwd_reduce": "_bwd_reduce_kernel"}


def bn_leaky_phase(dev, batch: int, dtype=None, sites=None,
                   deep: bool = True):
    """The four bn_leaky_train kernels at each (M, C, slope) of a train
    step: each against its plain version on the same inputs, timed. x, y,
    g and dx are in ``dtype`` (None: float32); xhat, the statistics and
    the sums are always f32. Each reduction gives one bitstream for one
    input (two calls compared bit for bit) and, with ``deep`` on the card,
    runs one CUDA kernel per call (torch.profiler over one call at every
    site) and gives the same bits on two streams at once. ``sites`` (M, C,
    slope, BN sites per forward, backward launches per train step) replace
    the WRN-28-2 step's; without ``deep`` the plain versions are held but
    not timed."""
    import torch

    from shotvae_torch.ops.kernels import bn_leaky as bl

    dtype = dtype or torch.float32
    e_ = torch.finfo(dtype).bits // 8  # bytes of an x, y, g or dx element
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = {k: [] for k in ("bn_stats", "bn_apply", "bn_bwd_reduce",
                            "bn_bwd_apply")}
    err = {k: 0.0 for k in rows}
    reductions = []
    for m, c, slope, n_fwd, n_bwd in sites or BN_TRAIN_SITES(batch):
        x = (torch.randn((m, c), generator=gen, device=dev) * 2
             + 0.5).to(dtype)
        gamma = torch.rand((c,), generator=gen, device=dev) + 0.5
        beta = torch.randn((c,), generator=gen, device=dev) * 0.5
        g = torch.randn((m, c), generator=gen, device=dev).to(dtype)
        stats = bl.bn_stats_plain(x)
        y, xhat = bl.bn_apply_plain(x, stats, gamma, beta, slope)
        sums = bl.bn_bwd_reduce_plain(g, xhat, gamma, beta, slope)
        calls = {
            "bn_stats": (lambda: bl.bn_stats(x),
                         lambda: bl.bn_stats_plain(x),
                         lambda: torch.var_mean(x, 0, correction=0),
                         e_ * m * c + 12 * c, 4 * n_fwd),
            "bn_apply": (lambda: bl.bn_apply(x, stats, gamma, beta, slope),
                         lambda: bl.bn_apply_plain(x, stats, gamma, beta,
                                                   slope),
                         None, (2 * e_ + 4) * m * c + 20 * c, 4 * n_fwd),
            "bn_bwd_reduce": (lambda: bl.bn_bwd_reduce(g, xhat, gamma, beta,
                                                       slope),
                              lambda: bl.bn_bwd_reduce_plain(
                                  g, xhat, gamma, beta, slope),
                              None, (e_ + 4) * m * c + 16 * c, n_bwd),
            "bn_bwd_apply": (lambda: bl.bn_bwd_apply(g, xhat, gamma, beta,
                                                     stats, sums, slope),
                             lambda: bl.bn_bwd_apply_plain(
                                 g, xhat, gamma, beta, stats, sums, slope),
                             None, (2 * e_ + 4) * m * c + 28 * c, n_bwd),
        }
        for name, fn in (("bn_stats", functools.partial(bl.bn_stats, x)),
                         ("bn_bwd_reduce", functools.partial(
                             bl.bn_bwd_reduce, g, xhat, gamma, beta, slope))):
            check(torch.equal(fn(), fn()), f"{name} gave two bitstreams for "
                  f"one input at {(m, c, slope)} {dtype}")
            reductions.append((name, fn))
        for name, (kernel, plain, library, nbytes, launches) in calls.items():
            got, want = kernel(), plain()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            check([a.dtype for a in got] == [b.dtype for b in want],
                  f"{name} gave {[a.dtype for a in got]} for {dtype}")
            e = max(max_err(a, b, TOL_BN, normwise=name == "bn_bwd_reduce",
                            ulp=ulp_of(a),
                            what=f"{name} at {(m, c, slope)} {dtype}")
                    for a, b in zip(got, want))
            err[name] = max(err[name], e)
            rows[name].append(dict(
                shape=[m, c], slope=slope, launches=launches, max_abs_err=e,
                ms=time_ms(kernel),
                plain_ms=time_ms(plain) if deep else None,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                library_ms=None if library is None else time_ms(library)))
    for name, fn in reductions if dev.type == "cuda" and deep else ():
        where = f"{name} at {tuple(fn.args[0].shape)} {dtype}"
        counter = ("launches_bf16" if dtype == torch.bfloat16
                   else "launches")
        launches, counted, kernels = cuda_launches(
            fn, lambda: getattr(fn.func, counter))
        # the window's one launch is the one the wrapper counts where it
        # launches its kernel; the device trace names it where it caught it
        check(launches == 1 and counted == 1
              and all(REDUCTIONS[name] in k for k in kernels),
              f"one {where} call made {launches} kernel launches, "
              f"{counted} counted by the wrapper ({kernels}), not one "
              f"{REDUCTIONS[name]}")
        # two streams at once, each with its own ticket counters
        want, side = fn(), [torch.cuda.Stream() for _ in range(2)]
        for s in side:
            s.wait_stream(torch.cuda.current_stream())
        got = []
        for s in side:
            with torch.cuda.stream(s):
                got.append(fn())
        for s in side:
            torch.cuda.current_stream().wait_stream(s)
        check(all(torch.equal(a, want) for a in got),
              f"{where} on two streams at once disagrees with one stream")
    return rows, err


def cuda_launches(fn, count):
    """The kernel launches one ``fn()`` makes, from torch.profiler, after
    one warm-up call: the host's launch calls (``cudaLaunchKernel``,
    ``cuLaunchKernel*``), which the profiler records as they are made; how
    much ``count()`` (a wrapper's launch counter) rose over the same call;
    and the kernels the device trace shows, which can drop records. A fill
    kernel before and after ``fn()`` bounds the window and is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sentinel = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sentinel.fill_(0.0)
        torch.cuda.synchronize()
        before = count()
        fn()
        counted = count() - before
        torch.cuda.synchronize()
        sentinel.fill_(1.0)
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                   for e in events) - 2
    kernels = [e.name for e in events if e.device_type == DeviceType.CUDA
               and "Fill" not in e.name]
    return launches, counted, kernels


def conv_bwd_phase(dev, batch: int, dtype=None, cases=None,
                   slope: float = 0.01):
    """The train-mode fused conv site, forward and backward, at each
    encoder shape against the same function as plain autograd ops, x, y and
    dx in ``dtype`` (None: float32), the f32 weight cast to it by the site.
    In bf16, y and the gradients are held norm-wise to one bf16 ulp plus
    the f32 tolerance: the kernel folds BN into x * scale + shift where the
    plain version normalises, so an activation may round to the
    neighbouring bf16 value, which moves a conv output by an ulp of its
    largest terms; the sums over the rows of bf16 gradients carry the same.
    ``cases`` (B, Cin, H, W, Cout, fused sites per forward) replace
    WRN-28-2's; ``slope`` is the activation's."""
    import torch

    from shotvae_torch.ops.kernels.fused_conv import (
        fused_bn_act_conv_train, fused_bn_act_conv_train_plain)

    dtype = dtype or torch.float32
    ulp = ULP_BF16 if dtype == torch.bfloat16 else 0.0
    b = batch
    # (B, Cin, H, W, Cout, fused sites per forward)
    cases = cases or [(b, 16, 32, 32, 32, 1), (b, 32, 32, 32, 32, 7),
                      (b, 64, 16, 16, 64, 7), (b, 128, 8, 8, 128, 7)]
    site = functools.partial(fused_bn_act_conv_train, slope=slope)
    site_plain = functools.partial(fused_bn_act_conv_train_plain, slope=slope)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    rows, err = [], 0.0
    for bb, cin, h, w, cout, n in cases:
        cl = dict(memory_format=torch.channels_last)
        x = (torch.randn((bb, cin, h, w), generator=gen, device=dev) * 1.5
             + 0.3).to(dtype).contiguous(**cl)
        gamma = torch.rand((cin,), generator=gen, device=dev) + 0.5
        beta = torch.randn((cin,), generator=gen, device=dev) * 0.5
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).contiguous(**cl)
        gy = torch.randn((bb, cout, h, w), generator=gen,
                         device=dev).to(dtype).contiguous(**cl)

        def run(fn):
            ins = [t.detach().requires_grad_() for t in (x, gamma, beta, wt)]
            y, mean, var = fn(*ins)
            y.backward(gy)
            return [y.detach(), mean.detach(), var.detach()] + [
                t.grad for t in ins]

        got = run(site)
        want = run(site_plain)
        check([a.dtype for a in got] == [dtype] + [torch.float32] * 2
              + [dtype] + [torch.float32] * 3,
              f"fused site gave {[a.dtype for a in got]} for {dtype}")
        tols = [TOL_CONV, TOL_BN, TOL_BN] + [TOL_GRAD] * 4
        names = ("y", "mean", "var", "dx", "dgamma", "dbeta", "dw")
        e = max(max_err(a, c, t, normwise=n not in ("mean", "var")
                        and (n != "y" or bool(ulp)),
                        ulp=0.0 if n in ("mean", "var") else ulp,
                        what=f"{n} at {(bb, cin, h, w, cout)} {dtype}")
                for a, c, t, n in zip(got, want, tols, names))
        err = max(err, e)
        rows.append(dict(shape=[bb, cin, h, w, cout], launches=4 * n,
                         max_abs_err=e,
                         fwd_bwd_ms=events_ms(lambda: run(site)),
                         plain_fwd_bwd_ms=events_ms(lambda: run(site_plain))))
    return rows, err


# ----------------------------------------------------------------- phase 5


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by the name its entry carries."""
    from shotvae_torch.ops.kernels import bn_leaky as bl
    from shotvae_torch.ops.kernels.bn_act import bn_act_inference
    from shotvae_torch.ops.kernels.fused_conv import fused_bn_act_conv
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    return {"fused_bn_act_conv": fused_bn_act_conv,
            "bn_act_inference": bn_act_inference,
            "fused_joint_sample": fused_joint_sample,
            "bn_stats": bl.bn_stats, "bn_apply": bl.bn_apply,
            "bn_bwd_reduce": bl.bn_bwd_reduce,
            "bn_bwd_apply": bl.bn_bwd_apply}


def _sgd_state(model, cfg, steps_per_epoch: int):
    """SGD over ``model`` with ``cfg``'s LR, weight decay and milestones."""
    from shotvae_torch.ops.schedules import multistep_lr
    from shotvae_torch.train.state import TrainState, sgd_torch

    opt = sgd_torch(model, lr=cfg.lr, weight_decay=cfg.wd)
    return TrainState(model, opt, multistep_lr(cfg.lr, cfg.adjust_lr,
                                               steps_per_epoch))


def trainer(model, m2: bool = False, **step_kw):
    """The headline configuration's train step over ``model`` (CIFAR-10,
    or CIFAR-100 for a model of 100 classes, ``--br --om``, SGD with the
    multistep LR at 45,000 train images per epoch, the epoch-0 loss
    weights); with ``m2`` the M2 baseline's step (no mixup, M2's cmi);
    ``step_kw``: the step's data-parallel arguments (``dp``,
    ``bn_per_replica``, ``bn_stats``) and, for the SHOT-VAE step,
    ``fused_streams``."""
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.ops.schedules import shot_vae_epoch_schedules
    from shotvae_torch.train.steps import (make_m2_train_step,
                                           make_shot_vae_train_step)

    dataset = {k: d for d, k in CLASSES.items()}[model.disc_latent_dim]
    cfg = ShotVaeConfig(br=True, om=not m2, dataset=dataset)
    spec = cfg.apply_dataset_overrides(m2=m2)
    state = _sgd_state(model, cfg, (50000 - spec.valid_per_class
                                    * spec.num_classes) // cfg.batch_size)
    kw = dict(num_classes=spec.num_classes, bce=cfg.br, x_sigma=cfg.x_sigma,
              **step_kw)
    step = (make_m2_train_step(model, state.optimizer, **kw) if m2 else
            make_shot_vae_train_step(model, state.optimizer,
                                     epsilon=cfg.epsilon,
                                     optimal_match=cfg.om, **kw))
    return state, step, shot_vae_epoch_schedules(0, cfg)


def m2_trainer(model):
    """The M2 baseline's train step over ``model`` (``trainer``'s)."""
    return trainer(model, m2=True)


def fused_trainer(model):
    """The fused two-stream SHOT-VAE step over ``model`` (``trainer``'s
    with ``fused_streams``)."""
    return trainer(model, fused_streams=True)


def classifier_trainer(model, **step_kw):
    """The classifier's train step over ``model`` (SGD with its multistep
    LR at CIFAR-10's 4,000 labeled images, 6 steps an epoch); no loss
    schedule (None). ``step_kw``: the step's data-parallel arguments
    (``dp``, ``bn_per_replica``, ``bn_stats``)."""
    from shotvae_torch.config import ClassifierConfig
    from shotvae_torch.train.steps import make_classifier_train_step

    state = _sgd_state(model, ClassifierConfig(), CLS_LOOP_STEPS)
    return state, make_classifier_train_step(model, state.optimizer,
                                             **step_kw), None


def _trainer(kind: str):
    """The step factory of a path, looked up when called."""
    return {"shot": trainer, "fused": fused_trainer, "m2": m2_trainer,
            "classifier": classifier_trainer}[kind]


def _model(kind: str, net: dict = WRN):
    """The seeded full-width model of a path and encoder path."""
    return random_classifier if kind == "classifier" else functools.partial(
        random_model, net=net)


def _state_errors(got, want, tol: float) -> float:
    return max(max_err(got[k].cpu().float(), want[k].float(), tol,
                       what=f"after a train step: {k}")
               for k in want if not k.endswith("num_batches_tracked"))


def normwise_rel_err(got, want) -> float:
    """max |got - want| / max |want|: for gradients, whose size says
    nothing of the parameters'."""
    got, want = got.detach().double(), want.detach().double()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    return diff / scale if scale else (0.0 if diff == 0 else math.inf)


def one_ulp_apart(model):
    """A copy of ``model`` with every parameter moved one ulp up or down,
    at random (seeded)."""
    import torch

    other = copy.deepcopy(model)
    g = torch.Generator().manual_seed(SEED + 11)
    with torch.no_grad():
        for p in other.parameters():
            up = torch.rand(p.shape, generator=g) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf)))
    return other


def step_inputs(batch: int, kind: str = "shot", draw: int = 0,
                classes: int = 10):
    """Seeded uint8 images and labels of both streams (the classifier: the
    labeled one), and every draw of one train step of the path ``kind`` at
    ``batch`` (+ ``batch``) (the ``inject`` dict) over ``classes``
    classes; ``draw`` above 0 seeds other ones. The fused step takes the
    SHOT-VAE step's draws."""
    import numpy as np
    import torch

    rng = np.random.default_rng([SEED + 10, draw] if draw else SEED + 10)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    if kind in ("shot", "fused"):
        inject = {f"eps_{i}": t(rng.standard_normal((batch, 128), np.float32))
                  for i in range(1, 5)}
        inject.update({f"unif_{i}": t(rng.random((batch, classes),
                                                 np.float32))
                       for i in (3, 4)})
        inject.update(lam_sm=float(rng.beta(0.1, 0.1)),
                      perm_sm=t(rng.permutation(batch)),
                      lam_mx=float(rng.beta(2.0, 2.0)),
                      perm_mx=t(rng.permutation(batch)))
    elif kind == "m2":
        inject = {f"eps_{i}": t(rng.standard_normal((batch, 128), np.float32))
                  for i in (1, 2)}
        inject["unif_2"] = t(rng.random((batch, classes), np.float32))
    else:
        inject = {}
    streams = ("",) if kind == "classifier" else ("_l", "_u")
    for s in streams:
        inject[f"aug{s}"] = (t(rng.integers(0, 9, batch)),
                             t(rng.integers(0, 9, batch)),
                             t(rng.random(batch) < 0.5))
    images = [t(rng.integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8))
              for _ in streams]
    labels = [t(rng.integers(0, classes, batch)) for _ in streams]
    return (*[x for pair in zip(images, labels) for x in pair], inject)


def train_once(model, inputs, kind: str = "shot"):
    """One train step of ``model`` on ``step_inputs``: its metrics, each
    parameter's gradient on the CPU, and the state after it."""
    import torch

    state, step, sched = _trainer(kind)(model)
    *data, inject = inputs
    args = data if sched is None else [*data, sched]
    metrics = step(state, *args, torch.Generator().manual_seed(SEED), inject)
    params = dict(model.named_parameters())
    check(all(p.grad is not None for p in params.values()),
          "a parameter got no gradient")
    return (metrics, {n: p.grad.cpu() for n, p in params.items()},
            model.state_dict())


def compare_train_step(dev, batch: int, kind: str = "shot", net: dict = WRN):
    """One train step of the path ``kind`` (``"shot"``, ``"m2"`` or
    ``"classifier"``; a VAE of the encoder path ``net``) of the same model
    on ``dev`` and on the CPU at
    ``batch`` (+ ``batch``), every draw injected and the crops and flips
    replayed. Holds the metrics, each parameter's gradient (the step moves
    a parameter by a few hundredths of its size, so the parameters after it
    would hide a wrong gradient), then the parameters and running
    statistics after it. A gradient may differ norm-wise by TOL_GRAD_STEP,
    or by ULP_FACTOR times as much as the CPU's own moves when the weights
    move by one ulp (a third step, on the CPU), where that is larger; so a
    gradient that is rounding alone, such as that of a conv bias before a
    BatchNorm, is not held. Returns the errors, the largest share of its
    tolerance that a gradient used and the largest one-ulp spread."""
    import torch

    cpu_model = _model(kind, net)("cpu")
    dev_model = copy.deepcopy(cpu_model).to(dev)
    ulp_model = one_ulp_apart(cpu_model)
    inputs = step_inputs(batch, kind, classes=CLASSES[net["dataset"]])
    (m_dev, g_dev, sd_dev), (m_cpu, g_cpu, sd_cpu), (_, g_ulp, _) = [
        train_once(model, inputs, kind)
        for model in (dev_model, cpu_model, ulp_model)]
    metric_err = max(max_err(m_dev[k].cpu(), m_cpu[k], TOL_STEP,
                             what=f"train step metric {k}") for k in m_cpu)
    return (metric_err, *check_gradients(g_dev, g_cpu, g_ulp),
            _state_errors(sd_dev, sd_cpu, TOL_STEP))


def check_gradients(g_dev, g_cpu, g_ulp, what: str = "card and CPU"
                    ) -> tuple:
    """Each gradient of the card (``g_dev``) against the CPU's, norm-wise
    within max(TOL_GRAD_STEP, ULP_FACTOR x the CPU's one-ulp spread, the
    distance of ``g_ulp`` from it). Returns the largest and the median
    error, the largest share of its tolerance an error used, and the
    largest and the median spread."""
    import torch

    errs, spreads, share = [], [], 0.0
    for n, want in g_cpu.items():
        spread = normwise_rel_err(g_ulp[n], want)
        tol = max(TOL_GRAD_STEP, ULP_FACTOR * spread)
        e = normwise_rel_err(g_dev[n], want)
        check(bool(torch.isfinite(g_dev[n]).all()) and e <= tol,
              f"{what} disagree on the gradient of {n}: {e:.3e} "
              f"norm-wise, beyond tol {tol:.3e} (one-ulp spread "
              f"{spread:.3e})")
        errs.append(e)
        spreads.append(spread)
        share = max(share, e / tol)
    return (max(errs), statistics.median(errs), share, max(spreads),
            statistics.median(spreads))


VS_CPU_KEYS = ("metrics_max_abs_err", "grad_max_rel_err",
               "grad_median_rel_err", "grad_max_share_of_tol",
               "grad_one_ulp_spread_max", "grad_one_ulp_spread_median",
               "state_max_abs_err")


def step_times(dev, run, batch: int, suffix: str,
               images: str = "unlabeled") -> dict:
    """Wall time of 10 single steps after 2 more, each ending in a device
    synchronise: the median and the range, and ``images`` (``unlabeled``
    or, for the classifier, ``labeled``) images/s at the median."""
    reps = 10
    for _ in range(2):
        run()
    _sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    median = (times[(reps - 1) // 2] + times[reps // 2]) / 2
    return {f"step_ms{suffix}": median,
            f"step_ms_range{suffix}": [times[0], times[-1]],
            f"{images}_images_per_s{suffix}": batch / median * 1e3}


def zero_counts(counters) -> None:
    for k in counters.values():
        k.launches = k.launches_bf16 = 0


def read_counts(counters, dtype) -> dict:
    """Each kernel's launches of its ``dtype`` variant."""
    import torch

    attr = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    return {name: getattr(k, attr) for name, k in counters.items()}


def check_counts(counters, dtype, expected: dict, what: str) -> dict:
    """The launches of the ``dtype`` variants must be ``expected`` and those
    of the other variants 0, except the f32 sampler's under a bf16 trunk
    (the heads and the sampler stay f32); returns the ``dtype`` counts."""
    import torch

    bf16 = dtype == torch.bfloat16
    want = {n: 0 if bf16 and n == "fused_joint_sample" else c
            for n, c in expected.items()}
    want_other = {n: c if bf16 and n == "fused_joint_sample" else 0
                  for n, c in expected.items()}
    got = read_counts(counters, dtype)
    other = read_counts(counters, torch.float32 if bf16 else torch.bfloat16)
    check(got == want and other == want_other,
          f"{what} launched {got} ({dtype}) and {other} (other dtype), "
          f"expected {want} and {want_other}")
    return got


def train_phase(dev, batch: int, steps: int = TRAIN_STEPS, dtype=None,
                kind: str = "shot", net: dict = WRN, expected=None,
                vs_cpu: bool = True):
    """A training main path on ``dev`` with the trunk in ``dtype`` (None:
    float32): ``kind`` ``"shot"`` (the SHOT-VAE), ``"m2"`` or
    ``"classifier"``, a VAE of the encoder path ``net``. ``steps`` train
    steps at ``batch`` (+ ``batch`` unlabeled, but for the classifier)
    with every kernel's launches counted (``expected``: the (train, eval)
    launches; default the path's ``PATHS`` entry), then step times, one
    profiled step, the peak device memory of a step, the eval step, and,
    with ``vs_cpu``, one step held against the CPU: the headline SHOT-VAE's
    in the trunk's dtype, the others' in f32 (``vs_cpu``) and in bf16
    (``vs_cpu_bf16``). On the CPU no wrapper launches a kernel: every
    count must be 0."""
    import torch

    from shotvae_torch.train.steps import (make_classifier_eval_step,
                                           make_vae_eval_step)

    expected_train, expected_eval = expected or PATHS[kind]
    counters = kernel_counters()
    cuda = dev.type == "cuda"
    bf16 = dtype == torch.bfloat16
    classes = CLASSES[net["dataset"]]
    model = _model(kind, net)(dev.type, dtype)
    state, step, sched = _trainer(kind)(model)
    g = torch.Generator().manual_seed(SEED + 9)
    weight = torch.ones(batch, device=dev)
    data = [torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                          dtype=torch.uint8).to(dev),
            (torch.arange(batch) % classes).to(dev)]
    if kind == "classifier":
        run = lambda: step(state, *data, g)  # noqa: E731
        evaluate = make_classifier_eval_step(model, num_classes=classes)
        eval_run = lambda: (evaluate(data[0], data[1], weight),  # noqa: E731
                            None)
    else:
        data += [torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                               dtype=torch.uint8).to(dev),
                 torch.randint(0, classes, (batch,), generator=g).to(dev)]
        run = lambda: step(state, *data, sched, g)  # noqa: E731
        evaluate = make_vae_eval_step(model, num_classes=classes, bce=True,
                                      x_sigma=1.0)
        eval_run = lambda: evaluate(data[2], data[3], weight,  # noqa: E731
                                    generator=g)
    run()  # compiles every kernel variant the step needs
    _sync(dev)

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(counters)
    metrics = [run() for _ in range(steps)]
    _sync(dev)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    launches = check_counts(
        counters, dtype, {name: n * steps if cuda else 0
                          for name, n in expected_train.items()},
        f"{kind} train steps")
    for m in metrics:
        check(all(bool(torch.isfinite(v)) for v in m.values()),
              f"non-finite {kind} train metrics {m}")
    last = {k: float(v) for k, v in metrics[-1].items()}

    timing = step_times(dev, run, batch, "", "labeled" if kind == "classifier"
                        else "unlabeled")
    profile = device_breakdown(run, top=12) if cuda else None
    profile_tf32 = None
    if cuda and not bf16:
        # a study of the bare step function, which no entry point runs: the
        # entry points pin exact float32. With cuDNN's TF32 on, the library
        # convs (dgrad, wgrad, the decoder) run on the tensor cores; the
        # profile names the cuDNN kernels it chose
        torch.backends.cudnn.allow_tf32 = True
        timing.update(step_times(dev, run, batch, "_bare_step_cudnn_tf32"))
        profile_tf32 = device_breakdown(run, top=12)
        torch.backends.cudnn.allow_tf32 = False

    zero_counts(counters)
    eval_metrics, recon = eval_run()
    _sync(dev)
    eval_launches = check_counts(
        counters, dtype, {name: n if cuda else 0
                          for name, n in expected_eval.items()},
        f"{kind} eval step")
    if bf16:  # the f32 sampler's launch under the bf16 trunk
        eval_launches["fused_joint_sample"] = read_counts(
            counters, torch.float32)["fused_joint_sample"]
    check((recon is None or recon.shape == (batch, 32, 32, 3))
          and float(eval_metrics["count"]) == batch
          and all(bool(torch.isfinite(v)) for v in eval_metrics.values()),
          f"{kind} eval step gave a wrong shape, count or a non-finite "
          f"metric")
    timing["eval_step_ms"] = host_ms(dev, eval_run)

    n = min(COMPARE_BATCH, batch)
    timing["peak_memory_gb"] = peak_gb
    out = dict(launches=launches, eval_launches=eval_launches,
               last_metrics=last, timing=timing, profile=profile,
               profile_bare_step_cudnn_tf32=profile_tf32)
    if not vs_cpu:
        return out
    if kind == "shot" and net is WRN:
        out["vs_cpu"] = (compare_train_step_bf16(dev, n) if bf16 else dict(
            zip(VS_CPU_KEYS, compare_train_step(dev, n))))
    else:
        out["vs_cpu"] = dict(zip(VS_CPU_KEYS,
                                 compare_train_step(dev, n, kind, net)))
        out["vs_cpu_bf16"] = compare_train_step_bf16(
            dev, n, kind, BF16_CALIBRATION_DRAWS, net)
    return out


def _dist(a, b) -> float:
    return float((a.detach().cpu().double()
                  - b.detach().cpu().double()).abs().max())


def compare_train_step_bf16(dev, batch: int, kind: str = "shot",
                            draws: int = 1, net: dict = WRN) -> dict:
    """One bf16 train step of the path ``kind`` of the same model on
    ``dev`` and on the CPU at ``batch`` (+ ``batch``), every draw injected
    and the crops and flips replayed, calibrated in the same run: the CPU
    also takes the f32 step on the same inputs, and each metric, gradient,
    parameter update and running statistic of the card's bf16 step must
    lie within max(BF16_FLOOR x its largest value, BF16_FACTOR x the CPU's
    own distance between its bf16 and its f32 step), max abs. The step at
    random weights is chaotic: one bf16 rounding that flips between the
    card and the CPU moves it about as far as bf16 moves it from f32, hence
    the factor; a zeroed, swapped or cut gradient is off by the gradient
    itself. With ``draws`` above 1 the CPU's distance is its largest over
    the step's inputs and ``draws - 1`` more (other seeded images, labels
    and draws): the distance of a scalar such as a discrete KL near 0 is
    one sample of its bf16 rounding, and lands far under its size on some
    inputs by chance. Returns the worst share of its tolerance that a
    tensor used, which tensor, and the two distances relative to each
    tensor's largest value."""
    import torch

    classes = CLASSES[net["dataset"]]
    cpu16 = _model(kind, net)("cpu", torch.bfloat16)
    dev16 = copy.deepcopy(cpu16).to(dev)
    cpu32 = _model(kind, net)("cpu")
    before = {n: p.detach().clone() for n, p in cpu16.named_parameters()}
    inputs = step_inputs(batch, kind, classes=classes)
    flat = functools.partial(flat_step, before=before)
    got, want, f32 = [flat(train_once(m, inputs, kind))
                      for m in (dev16, cpu16, cpu32)]
    spread = {k: _dist(w, f32[k]) for k, w in want.items()}
    for d in range(1, draws):
        more = step_inputs(batch, kind, draw=d, classes=classes)
        a, b = [flat(train_once(_model(kind, net)("cpu", dtype), more, kind))
                for dtype in (torch.bfloat16, None)]
        spread = {k: max(v, _dist(a[k], b[k])) for k, v in spread.items()}
    return dict(calibration_draws=draws,
                **hold_bf16(got, want, spread, "bf16 card and CPU", "CPU"))


def flat_step(run, before: dict) -> dict:
    """{name: tensor} of one step's (metrics, gradients, state dict): each
    metric, gradient, parameter update from ``before`` and running
    statistic."""
    metrics, grads, sd = run
    out = {f"metric {k}": v for k, v in metrics.items()}
    out.update({f"grad {k}": v for k, v in grads.items()})
    out.update({f"update {k}": sd[k].cpu() - v.cpu()
                for k, v in before.items()})
    out.update({f"state {k}": v for k, v in sd.items()
                if k not in before and not k.endswith("num_batches_tracked")})
    return out


def hold_bf16(got: dict, want: dict, spread: dict, what: str,
              reference: str) -> dict:
    """Each tensor of a bf16 step ``got`` against ``want`` within
    max(BF16_FLOOR x its largest value, BF16_FACTOR x ``spread``, the
    reference's own distance between its bf16 and its f32 step), max abs.
    Returns the worst share of its tolerance that a tensor used, which
    tensor, and the two distances relative to each tensor's largest
    value."""
    import torch

    worst, worst_key, errs, own = 0.0, "", [], []
    for k, w in want.items():
        e, d = _dist(got[k], w), spread[k]
        tol = max(BF16_FLOOR * float(w.detach().abs().max()), BF16_FACTOR * d)
        check(bool(torch.isfinite(got[k]).all()) and e <= tol,
              f"{what} disagree on {k}: {e:.3e} max abs, beyond tol "
              f"{tol:.3e} (the {reference}'s bf16-vs-f32 distance {d:.3e})")
        share = e / tol if tol else 0.0
        if share >= worst:
            worst, worst_key = share, k
        errs.append(e / max(float(w.detach().abs().max()), 1e-30))
        own.append(d / max(float(w.detach().abs().max()), 1e-30))
    return {"tensors": len(want), "worst_share_of_tol": worst,
            "worst_tensor": worst_key, "rel_err_max": max(errs),
            "rel_err_median": statistics.median(errs),
            f"{reference.lower()}_bf16_vs_f32_rel_max": max(own),
            f"{reference.lower()}_bf16_vs_f32_rel_median":
            statistics.median(own)}


# ----------------------------------------------------------------- phase 7


def _momentum(state) -> dict:
    return {i: s["momentum_buffer"]
            for i, s in state.optimizer.state_dict()["state"].items()}


def state_mismatches(a, b) -> list:
    """The tensors (parameters, buffers, momentum) and the step in which
    two train states differ by any bit, each with its largest difference."""
    import torch

    out = [] if a.step == b.step else [("step", a.step, b.step)]
    for what, da, db in (("state", a.model.state_dict(),
                          b.model.state_dict()),
                         ("momentum", _momentum(a), _momentum(b))):
        check(list(da) == list(db), f"{what} keys differ")
        out += [(f"{what} {k}", _dist(da[k], db[k]))
                for k in da if not torch.equal(da[k], db[k])]
    return out


def _no_seconds(history) -> list:
    return [{k: v for k, v in h.items() if k != "seconds"} for h in history]


def loop_phase(dev, base: str, config: dict, steps: int, eval_forwards: int,
               resume_config: dict) -> dict:
    """The training loop on ``dev`` under ``base``: one epoch of ``config``
    (``steps`` train steps and ``eval_forwards`` eval forwards, whose
    launches are checked), the checkpoint round trip and serving, then
    resume against a straight run at ``resume_config``."""
    import torch

    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.io.checkpoint import CheckpointManager
    from shotvae_torch.io.tb import TBWriter
    from shotvae_torch.models.vae import VariationalAutoEncoder
    from shotvae_torch.train.loop import build_model, build_state, run_shot_vae

    log = lambda *a: print("  loop:", *a)  # noqa: E731
    counters = kernel_counters()
    cuda = dev.type == "cuda"
    cfg = ShotVaeConfig(base_path=os.path.join(base, "epoch"), **config)
    dtype = cfg.compute_dtype()
    zero_counts(counters)
    out = run_shot_vae(cfg, max_epochs=1, log_fn=log, device=dev)
    _sync(dev)
    launches = check_counts(
        counters, dtype,
        {name: (steps * n + eval_forwards * EXPECTED_EVAL_LAUNCHES[name]
                if cuda else 0)
         for name, n in EXPECTED_TRAIN_LAUNCHES.items()},
        f"the loop's epoch ({steps} steps, {eval_forwards} eval forwards)")
    if dtype == torch.bfloat16:  # the f32 sampler under the bf16 trunk
        launches["fused_joint_sample"] = read_counts(
            counters, torch.float32)["fused_joint_sample"]
    (h,) = out["history"]
    check(math.isfinite(h["train_loss"])
          and 0.0 <= h["valid_top1"] <= 1.0 and 0.0 <= h["test_top1"] <= 1.0,
          f"the loop's epoch gave {h}")
    spec = cfg.apply_dataset_overrides()
    ckpt = CheckpointManager(cfg.base_path, spec.name, cfg.train_time)
    check(os.path.isfile(ckpt.latest_path()),
          "the checkpoint pointer leads to no file")
    probe = TBWriter(os.path.join(base, "tb_probe"))
    live = probe.live
    probe.close()
    events = glob.glob(os.path.join(cfg.base_path, f"{spec.name}-SHOT-VAE",
                                    "runs", "*", "events.out.tfevents.*"))
    check(bool(events) == live, f"TensorBoard live {live}, event files "
          f"{events}")
    times = out["epoch_times"][0]
    epoch = dict(launches=launches, epoch_s=h["seconds"],
                 train_s=times["train_s"], eval_s=times["eval_s"],
                 train_steps=steps, eval_forwards=eval_forwards,
                 unlabeled_images_per_s=steps * cfg.batch_size
                 / times["train_s"],
                 train_loss=h["train_loss"], valid_top1=h["valid_top1"],
                 test_top1=h["test_top1"], tensorboard_live=live)

    # the checkpoint into a fresh model and optimizer, then served
    final = out["state"]
    fresh = build_state(build_model(cfg, spec, dev), cfg, steps)
    _, saved_epoch, _ = ckpt.restore(fresh)
    diff = state_mismatches(fresh, final)
    check(saved_epoch == 1 and not diff, f"the restored checkpoint (epoch "
          f"{saved_epoch}) differs from the loop's final state: {diff[:5]}")
    serving = ShotVaeInference.from_checkpoint(ckpt.folder, device=dev)
    ref = VariationalAutoEncoder(
        cfg.net_name, continuous_latent_dim=cfg.ldc,
        disc_latent_dim=spec.num_classes, device=dev)
    ref.load_state_dict(final.model.state_dict(), strict=True)
    g = torch.Generator().manual_seed(SEED + 20)
    images = torch.randint(0, 256, (16, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    got = serving.classify(images)
    want = ShotVaeInference(ref, device=dev).classify(images)
    check(torch.equal(got, want), "from_checkpoint's classify differs from "
          f"the final state's by {_dist(got, want):.3e}")
    round_trip = dict(tensors=len(final.model.state_dict())
                      + len(_momentum(final)), bit_identical=True,
                      served_classify_equal=True)

    # resume, with cuDNN deterministic for this check only
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        straight_base = os.path.join(base, "straight")
        resumed_base = os.path.join(base, "resumed")
        profile_dir = os.path.join(base, "profile")  # --profile-dir
        a = run_shot_vae(ShotVaeConfig(base_path=straight_base,
                                       profile_dir=profile_dir,
                                       **resume_config),
                         max_epochs=2, log_fn=log, device=dev)
        run_shot_vae(ShotVaeConfig(base_path=resumed_base, **resume_config),
                     max_epochs=1, log_fn=log, device=dev)
        resumed_cfg = ShotVaeConfig(base_path=resumed_base, resume=os.path.join(
            CheckpointManager(resumed_base, "Cifar10", 1).folder,
            "checkpoint"), **resume_config)
        b = run_shot_vae(resumed_cfg, max_epochs=2, log_fn=log, device=dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = state_mismatches(a["state"], b["state"])
    check(not diff, f"resume differs from the straight run in {len(diff)} "
          f"tensors: {diff[:5]}")
    check(_no_seconds(a["history"][1:]) == _no_seconds(b["history"]),
          f"resume's history {b['history']} differs from the straight "
          f"run's {a['history'][1:]}")
    check(resumed_cfg.ewm == 5 * ShotVaeConfig().ewm,
          f"the resumed run's ewm is {resumed_cfg.ewm}")
    check(os.listdir(profile_dir) == ["epoch1.pt.trace.json"],
          f"--profile-dir wrote {os.listdir(profile_dir)}")
    resume = dict(epochs=2, resumed_at=1, tensors=len(
        a["state"].model.state_dict()) + len(_momentum(a["state"])),
        bit_identical=True, ewm=resumed_cfg.ewm)
    return dict(epoch=epoch, round_trip=round_trip, resume=resume)


# ------------------------------------------------------------ phases 8, 9


def baseline_loop_phase(dev, base: str, kind: str, config: dict, steps: int,
                        eval_forwards: int, expected=None) -> dict:
    """One epoch of ``run_shot_vae(m2=True)`` or ``run_classifier`` of
    ``config`` on ``dev`` under ``base``: ``steps`` train steps and
    ``eval_forwards`` eval forwards, whose launches are checked (against
    ``expected``'s (train step, eval forward) launches; default the path's
    ``PATHS`` entry); its run folder is the path's own and no other
    trainer's."""
    import torch

    from shotvae_torch.config import ClassifierConfig, ShotVaeConfig
    from shotvae_torch.train.loop import run_classifier, run_shot_vae

    log = lambda *a: print(f"  {kind} loop:", *a)  # noqa: E731
    expected_train, expected_eval = expected or PATHS[kind]
    counters = kernel_counters()
    cuda = dev.type == "cuda"
    if kind == "classifier":
        cfg = ClassifierConfig(base_path=base, **config)
        train = lambda: run_classifier(cfg, max_epochs=1,  # noqa: E731
                                       log_fn=log, device=dev)
        folder = f"{cfg.dataset}-SSL-Classifier"
    else:
        cfg = ShotVaeConfig(base_path=base, **config)
        train = lambda: run_shot_vae(cfg, m2=True, max_epochs=1,  # noqa: E731
                                     log_fn=log, device=dev)
        folder = f"{cfg.dataset}-M2-VAE"
    dtype = cfg.compute_dtype()
    zero_counts(counters)
    out = train()
    _sync(dev)
    launches = check_counts(
        counters, dtype,
        {name: (steps * n + eval_forwards * expected_eval[name] if cuda
                else 0) for name, n in expected_train.items()},
        f"the {kind} loop's epoch ({steps} steps, {eval_forwards} eval "
        f"forwards)")
    if dtype == torch.bfloat16:  # the f32 sampler under the bf16 trunk
        launches["fused_joint_sample"] = read_counts(
            counters, torch.float32)["fused_joint_sample"]
    (h,) = out["history"]
    check(math.isfinite(h["train_loss"])
          and 0.0 <= h["valid_top1"] <= 1.0 and 0.0 <= h["test_top1"] <= 1.0,
          f"the {kind} loop's epoch gave {h}")
    check(os.listdir(base) == [folder], f"the {kind} loop wrote "
          f"{os.listdir(base)}, not only {folder}")
    times = out["epoch_times"][0]
    images, batch = "unlabeled", cfg.batch_size
    if kind == "classifier":
        spec = cfg.apply_dataset_overrides()
        images, batch = "labeled", min(
            batch, spec.annotated_per_class * spec.num_classes)
    return {"launches": launches,
            "epoch_s": times["train_s"] + times["eval_s"],
            "train_s": times["train_s"], "eval_s": times["eval_s"],
            "train_steps": steps, "eval_forwards": eval_forwards,
            f"{images}_images_per_s": steps * batch / times["train_s"],
            "train_loss": h["train_loss"], "valid_top1": h["valid_top1"],
            "test_top1": h["test_top1"]}


# ---------------------------------------------------------------- phase 11

# the encoder paths of phase 11, in bf16 on CIFAR-100's shape (32x32x3,
# K 100): PreActResNet-18 and DenseNet-121, plain and with --efficient
PREACT = dict(net="preactresnet18", dataset="Cifar100", efficient=False)
DENSE = dict(net="densenet121", dataset="Cifar100", efficient=False)
DENSE_EFF = dict(DENSE, efficient=True)
ENCODER_PATHS = {"preactresnet18": PREACT, "densenet121": DENSE,
                 "densenet121_efficient": DENSE_EFF}


def _launches(fused, bn_act, sample, stats, apply, bwd):
    return {"fused_bn_act_conv": fused, "bn_act_inference": bn_act,
            "fused_joint_sample": sample, "bn_stats": stats,
            "bn_apply": apply, "bn_bwd_reduce": bwd, "bn_bwd_apply": bwd}


# kernel launches per SHOT-VAE train step (4 forwards; the encoder's sites
# get a gradient in all 4, the decoder's 5 in 2, as at WRN-28-2) and per
# eval forward. preactresnet18: 13 fused sites, 4 standalone BN+ReLU sites
# (norm1 of unit 1 of groups 2 to 4, before its stride-2 conv, and the
# transition) and 3 identity BN sites (the projection shortcuts) a
# forward: fused 13 * 4;
# statistics and apply (13 + 7 + 5) * 4; backward 20 * 4 + 5 * 2. Eval:
# 13 fused, 7 + 5 bn_act, one draw. densenet121: 58 fused sites (norm2 of
# each dense layer) and 62 standalone (58 norm1, 3 transitions, the final
# norm): fused 58 * 4; statistics and apply (58 + 62 + 5) * 4; backward
# 120 * 4 + 5 * 2; eval 58 fused, 62 + 5 bn_act. With --efficient the
# backward recomputes each dense block once per forward: 58 more fused
# convs, 116 more statistics (norm1 and norm2) and 58 more applies (norm1)
# per forward, times 4.
EXPECTED_ENCODER_LAUNCHES = {
    "preactresnet18": (_launches(52, 0, 0, 100, 100, 90),
                       _launches(13, 12, 1, 0, 0, 0)),
    "densenet121": (_launches(232, 0, 0, 500, 500, 490),
                    _launches(58, 67, 1, 0, 0, 0)),
    "densenet121_efficient": (_launches(464, 0, 0, 964, 732, 490),
                              _launches(58, 67, 1, 0, 0, 0)),
}
# the M2 step with preactresnet18: two forwards, both with gradients
EXPECTED_PREACT_M2_LAUNCHES = (_launches(26, 0, 0, 50, 50, 50),
                               _launches(13, 12, 1, 0, 0, 0))
# serving: (fused conv, bn_act, sample) per endpoint
EXPECTED_ENCODER_SERVE = {
    "preactresnet18": {"classify": (13, 7, 0), "reconstruct": (13, 12, 1)},
    "densenet121": {"classify": (58, 62, 0), "reconstruct": (58, 67, 1)},
}
# the M2 epoch on 50,000 synthetic CIFAR-100 images: 50 valid and 40
# labeled images per class, 45,000 unlabeled: 58 steps; 7 valid and 17
# test batches and the grid
ENCODER_LOOP_CONFIG = dict(LOOP_CONFIG, dataset="Cifar100",
                           net_name="preactresnet18")
# the fused sites of the other DenseNets (Cin = 4 x growth -> growth):
# densenetbc100 48 -> 12, densenetbc250 96 -> 24, densenetbc190 160 -> 40,
# densenet161 192 -> 48, at each block's map; held in f32 and bf16 with
# ReLU, not timed
DENSE_BC_CONV_SHAPES = [(16, 48, 32, 32, 12), (16, 48, 8, 8, 12),
                        (16, 96, 32, 32, 24), (16, 96, 16, 16, 24),
                        (16, 160, 16, 16, 40), (16, 160, 8, 8, 40),
                        (16, 192, 8, 8, 48), (16, 192, 4, 4, 48),
                        (16, 128, 2, 2, 32)]
GRAD_EQ_ULPS = 1.0  # efficient against plain: gradients within one bf16 ulp
#                     of each gradient's largest value


def encoder_sites(net: dict) -> dict:
    """The BN sites of one forward of ``net``'s encoder (batch 1, eval
    mode, on the CPU), in order and with repeats: 'fused' (Cin, H, W, Cout,
    in a dense block) and 'alone' (C, H, W, slope, in a dense block)."""
    import torch

    from shotvae_torch.models.layers import BatchNorm
    from shotvae_torch.models.vae import build_encoder

    encoder = build_encoder(net["net"]).eval()
    names = {id(m): n for n, m in encoder.named_modules()}
    sites = {"fused": [], "alone": []}
    forward, act_conv = BatchNorm.forward, BatchNorm.act_conv

    def alone(self, x):
        sites["alone"].append((x.shape[1], x.shape[2], x.shape[3],
                               self.slope, "denseblock" in names[id(self)]))
        return forward(self, x)

    def fused(self, x, conv):
        sites["fused"].append((x.shape[1], x.shape[2], x.shape[3],
                               conv.weight.shape[0],
                               "denseblock" in names[id(self)]))
        return act_conv(self, x, conv)

    BatchNorm.forward, BatchNorm.act_conv = alone, fused
    try:
        with torch.no_grad():
            encoder(torch.zeros(1, 3, 32, 32).contiguous(
                memory_format=torch.channels_last))
    finally:
        BatchNorm.forward, BatchNorm.act_conv = forward, act_conv
    return sites


def _tally(items) -> dict:
    out = {}
    for item in items:
        out[item] = out.get(item, 0) + 1
    return out


def encoder_kernel_phase(dev, batch: int) -> dict:
    """Every kernel against its plain version at every distinct shape the
    two encoders give it at ``batch`` (the ReLU and identity sites):
    the bf16 bn_leaky kernels (train), bn_act in bf16 (eval step) and f32
    (serving), the fused conv forward in bf16 and f32 with ReLU, timed
    beside its bound and F.conv2d, and held at DENSE_BC_CONV_SHAPES, and
    the bf16 train-mode fused site forward and backward. Rows carry their
    launches per forward (bn_act, conv) or per SHOT train step
    (bn_leaky, the fused site)."""
    import torch

    bf16 = torch.bfloat16
    sites = {name: encoder_sites(net) for name, net in
             (("preactresnet18", PREACT), ("densenet121", DENSE))}
    out = {}
    for name, st in sites.items():
        bn = _tally((c, h * w, slope) for c, h, w, slope, _ in st["alone"])
        for c, h, w, _, _ in st["fused"]:
            bn[(c, h * w, 0.0)] = bn.get((c, h * w, 0.0), 0) + 1
        conv = _tally((c, h, w, o) for c, h, w, o, _ in st["fused"])
        alone = _tally((c, h * w, slope) for c, h, w, slope, _ in st["alone"])
        bn_sites = [(batch * hw, c, slope, n, 4 * n)
                    for (c, hw, slope), n in sorted(bn.items())]
        act_cases = [(batch * hw, c, slope, n)
                     for (c, hw, slope), n in sorted(alone.items())]
        conv_cases = [(batch, c, h, w, o, n)
                      for (c, h, w, o), n in sorted(conv.items())]
        res = {"sites": {"fused": len(st["fused"]),
                         "alone": len(st["alone"]),
                         "identity": sum(x[3] == 1.0 for x in st["alone"]),
                         "dense_block_fused": sum(x[4] for x in st["fused"]),
                         "dense_block_alone": sum(x[4]
                                                  for x in st["alone"])}}
        res["bn_leaky_train"] = bn_leaky_phase(dev, batch, bf16, bn_sites,
                                               deep=False)
        res["bn_act_inference"] = bn_act_phase(dev, batch, bf16, act_cases)
        res["bn_act_inference_f32"] = bn_act_phase(dev, batch, None,
                                                   act_cases)
        res["fused_bn_act_conv"] = conv_phase(dev, batch, bf16, conv_cases,
                                              0.0, [])
        res["fused_bn_act_conv_f32"] = conv_phase(dev, batch, None,
                                                  conv_cases, 0.0, [])
        res["fused_bn_act_conv_train"] = conv_bwd_phase(dev, batch, bf16,
                                                        conv_cases, 0.0)
        out[name] = res
    out["dense_bc_conv"] = [conv_phase(dev, 1, dtype, [(1, 48, 8, 8, 12, 0)],
                                       0.0, DENSE_BC_CONV_SHAPES)[1]
                            for dtype in (bf16, None)]
    # the f32 conv with ReLU and the identity at the ragged shapes
    out["f32_conv_check"] = [conv_phase(dev, 1, None, [(1, 48, 8, 8, 12, 0)],
                                        slope, CONV_CHECK_SHAPES)[1]
                             for slope in (0.0, 1.0)]
    return out


def weighted_rows(res: dict) -> dict:
    """Each part's rows of ``encoder_kernel_phase`` summed, weighted by
    their launches: per SHOT-VAE train step (bn_leaky, the train-mode
    fused site) or per forward (bn_act, the fused conv)."""
    out = {}
    for part, result in res.items():
        if part == "sites":
            continue
        rows = result[0]
        for kernel, kernel_rows in (rows.items() if isinstance(rows, dict)
                                    else ((part, rows),)):
            out[kernel] = {"launches": sum(r["launches"]
                                           for r in kernel_rows)}
            for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                        "fwd_bwd_ms", "plain_fwd_bwd_ms"):
                if all(r.get(key) is not None for r in kernel_rows):
                    out[kernel][key] = sum(r[key] * r["launches"]
                                           for r in kernel_rows)
    return out


def efficient_vs_plain(dev, batch: int) -> dict:
    """densenet121 with --efficient against plain densenet121: one bf16
    SHOT-VAE step each, of the same weights, on the same images and
    injected draws, cuDNN deterministic. The metrics and the running
    statistics (and their counts: tracked once per forward) must be equal,
    each gradient within GRAD_EQ_ULPS bf16 ulps of its largest value."""
    import torch

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    inputs = step_inputs(batch, "shot", classes=CLASSES[DENSE["dataset"]])
    runs = []
    try:
        for net in (DENSE, DENSE_EFF):
            model = random_model("cpu", torch.bfloat16, net).to(dev)
            metrics, grads, sd = train_once(model, inputs)
            runs.append((metrics, grads, {k: v.cpu() for k, v in sd.items()
                                          if "running" in k
                                          or "num_batches" in k}))
            del model, sd
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (m_p, g_p, s_p), (m_e, g_e, s_e) = runs
    check(all(torch.equal(m_e[k], m_p[k]) for k in m_p),
          f"efficient and plain densenet121 disagree on the metrics: "
          f"{ {k: (float(m_e[k]), float(m_p[k])) for k in m_p} }")
    check(s_e.keys() == s_p.keys()
          and all(torch.equal(s_e[k], s_p[k]) for k in s_p),
          "efficient and plain densenet121 disagree on the running "
          "statistics")
    worst, worst_key, err_max = 0.0, "", 0.0
    for k, want in g_p.items():
        e = float((g_e[k].double() - want.double()).abs().max())
        tol = GRAD_EQ_ULPS * ULP_BF16 * float(want.abs().max())
        check(e <= tol, f"efficient and plain densenet121 disagree on the "
              f"gradient of {k}: {e:.3e} beyond {tol:.3e}")
        err_max = max(err_max, e)
        if tol and e / tol >= worst:
            worst, worst_key = e / tol, k
    tracked = {int(v) for k, v in s_p.items() if "num_batches" in k}
    return dict(metrics_equal=True, running_stats_equal=True,
                num_batches_tracked=sorted(tracked), gradients=len(g_p),
                grad_max_abs_err=err_max, grad_worst_share_of_tol=worst,
                grad_worst=worst_key, loss=float(m_p["loss"]))


def encoder_train_phase(dev, batch: int, steps: int = TRAIN_STEPS) -> dict:
    """The bf16 SHOT-VAE train and eval steps of preactresnet18,
    densenet121 and densenet121 --efficient at ``batch`` + ``batch``
    (``train_phase``: launches, step times, profile, peak memory, eval
    step; the card against the CPU for the two families, f32 and bf16),
    then the efficient step against the plain one."""
    import torch

    out = {}
    for name, net in ENCODER_PATHS.items():
        t0 = time.perf_counter()
        res = out[name] = train_phase(dev, batch, steps, torch.bfloat16,
                                      "shot", net,
                                      EXPECTED_ENCODER_LAUNCHES[name],
                                      vs_cpu=not net["efficient"])
        for key in ("launches", "eval_launches", "last_metrics", "timing",
                    "profile", "vs_cpu", "vs_cpu_bf16"):
            if key in res:
                print(f"{name}_shot_bf16_{key}_at_batch_{batch} "
                      + json.dumps(res[key]))
        print(f"{name} train phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["efficient_vs_plain"] = efficient_vs_plain(dev, batch)
    print("densenet121_efficient_vs_plain "
          + json.dumps(out["efficient_vs_plain"]))
    print(f"efficient against plain {time.perf_counter() - t0:.1f} s")
    return out


def encoder_m2_phase(dev, batch: int, base: str, config: dict, steps: int,
                     eval_forwards: int, train_steps: int = TRAIN_STEPS
                     ) -> dict:
    """The M2 baseline over preactresnet18 (BASELINE config 5): the bf16
    step at ``batch`` + ``batch`` with launches, times and the eval step,
    then one bf16 epoch of ``run_shot_vae(m2=True)`` of ``config`` under
    ``base`` with launches equal to the step's and the eval step's
    multiples."""
    import torch

    out = train_phase(dev, batch, train_steps, torch.bfloat16, "m2", PREACT,
                      EXPECTED_PREACT_M2_LAUNCHES, vs_cpu=False)
    out["loop"] = baseline_loop_phase(dev, base, "m2", config, steps,
                                      eval_forwards,
                                      EXPECTED_PREACT_M2_LAUNCHES)
    return out


def encoder_serve_phase(dev, batch: int, name: str) -> dict:
    """f32 ``ShotVaeInference.from_checkpoint`` of a seeded ``name`` model
    saved as the trainer saves one (its ``net_name`` in ``args``), under a
    folder of ``build/`` removed after: ``classify`` and ``reconstruct`` at
    ``batch`` with their launches checked and timed, and 16 images of each
    against the same model on the CPU."""
    import torch

    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.ops.kernels.fused_sample import fused_joint_sample

    net = ENCODER_PATHS[name]
    classes = CLASSES[net["dataset"]]
    cpu_model = random_model("cpu", None, net)
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    folder = tempfile.mkdtemp(prefix=f"serve_{name}_", dir=root)
    try:
        path = os.path.join(folder, "checkpoint.pth.tar")
        torch.save({"args": {"net_name": net["net"]},
                    "state_dict": cpu_model.state_dict()}, path)
        gpu = ShotVaeInference.from_checkpoint(path, device=dev)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    cpu = ShotVaeInference(cpu_model, device="cpu")
    g = torch.Generator().manual_seed(SEED + 4)
    images = torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    endpoints = {"classify": lambda: gpu.classify(images),
                 "reconstruct": lambda: gpu.reconstruct(
                     images, generator=torch.Generator().manual_seed(
                         SEED + 5))}
    counters = kernel_counters()
    serving = ("fused_bn_act_conv", "bn_act_inference", "fused_joint_sample")
    outs, launches = {}, dict.fromkeys(serving, 0)
    for endpoint, fn in endpoints.items():
        zero_counts(counters)
        outs[endpoint] = fn()
        _sync(dev)
        got = tuple(read_counts(counters, torch.float32)[k] for k in serving)
        want = tuple(n if dev.type == "cuda" else 0
                     for n in EXPECTED_ENCODER_SERVE[name][endpoint])
        check(got == want and set(read_counts(
            counters, torch.bfloat16).values()) == {0},
            f"{name} {endpoint} launched (conv, bn_act, sample) = {got}, "
            f"expected {want}")
        for k, n in zip(serving, got):
            launches[k] += n
    probs, recon = outs["classify"], outs["reconstruct"]
    check(probs.shape == (batch, classes)
          and recon.shape == (batch, 32, 32, 3)
          and bool(torch.isfinite(probs).all())
          and bool(torch.isfinite(recon).all())
          and float((probs.sum(1) - 1).abs().max()) < 1e-5,
          f"{name} serving gave a wrong shape or value")
    n = min(16, batch)
    err = {"classify": max_err(probs[:n].cpu(), cpu.classify(images[:n]),
                               TOL_E2E, what=f"{name} classify")}
    with torch.inference_mode():
        mean, log_sigma, log_alpha = gpu.encode(images)
        draw = fused_joint_sample(mean, log_sigma, log_alpha,
                                  gpu.model.sample_temperature,
                                  generator=torch.Generator().manual_seed(
                                      SEED + 5))
        want = torch.sigmoid(cpu.model.decode(draw[:n].cpu()))
    err["reconstruct"] = max_err(recon[:n].cpu(), want.permute(0, 2, 3, 1),
                                 TOL_E2E, what=f"{name} reconstruct")
    return {"launches": launches, "vs_cpu_max_abs_err": err,
            "ms": {k: host_ms(dev, fn) for k, fn in endpoints.items()}}


def encoder_paths(encoders: dict) -> dict:
    """{path: the bf16 launches of each kernel} of phase 11's train, eval
    and epoch paths."""
    out = {}
    for name in ENCODER_PATHS:
        res = encoders["train"][name]
        out[f"{name}_shot_train_bf16"] = res["launches"]
        out[f"{name}_shot_eval_bf16"] = res["eval_launches"]
    m2 = encoders["m2"]
    out["preactresnet18_m2_train_bf16"] = m2["launches"]
    out["preactresnet18_m2_eval_bf16"] = m2["eval_launches"]
    out["preactresnet18_m2_loop_bf16"] = m2["loop"]["launches"]
    return out


def check_encoder_rows(kernels: dict, train: dict, steps: int) -> None:
    """Phase 11's timed rows weigh what the main path launched: per
    forward, the fused conv rows 1/4 of the train step's fused convs; per
    step, the bn_leaky rows plus the decoder's 5 sites (statistics and
    apply in 4 forwards, backward in 2) the step's launches."""
    for name in ("preactresnet18", "densenet121"):
        got = train[name]["launches"]
        rows = kernels[name]
        conv = sum(r["launches"] for r in rows["fused_bn_act_conv"][0])
        check(4 * conv * steps == got["fused_bn_act_conv"],
              f"{name}'s fused conv rows weigh {conv} launches per forward; "
              f"{steps} steps launched {got['fused_bn_act_conv']}")
        for kernel, decoder in (("bn_stats", 20), ("bn_apply", 20),
                                ("bn_bwd_reduce", 10), ("bn_bwd_apply", 10)):
            weight = sum(r["launches"]
                         for r in rows["bn_leaky_train"][0][kernel])
            check((weight + decoder) * steps == got[kernel],
                  f"{name}'s {kernel} rows weigh {weight} + {decoder} "
                  f"launches per step; {steps} steps launched {got[kernel]}")


# ---------------------------------------------------------------- phase 12

# the one-stage smooth-ELBO trainers at their CLI defaults: MNIST on
# written idx files of MNIST's sizes (60,000 / 10,000 28x28 images: 468
# steps of 128 + 4, 10 eval batches of 1,000), SVHN through the synthetic
# fallback (2,048 / 512 images: 8 steps of 256 + 512, 4 eval batches of
# 128) with the plateau scheduler on
SMOOTH_MNIST_SIZES = (60000, 10000)
SMOOTH_EPOCHS = 2
# phase 12's epoch-1 average loss at each configuration (seed 1): the band
# of the CPU's runs of the same configuration at seeds 1 to 5
# (``python3 scripts/torch_smooth_epochs.py band``), widened by its own
# width on each side (one run on the card is one more draw of a chaotic
# spread); a run that leaves it, as a divergence by a factor does, fails
SMOOTH_BANDS = {"mnist": (124.66153363284901, 126.62589687771268),
                "svhn": (2002.8082427978516, 2014.1643829345703)}
# shotvae_tpu/train/loop.py:790-800: three lines and a blank one an epoch
SMOOTH_LOG_LINES = [
    r"Epoch: \d+ Average loss: -?[\d.]+ Test Accuracy: [\d.]+",
    r"u_recon_loss: -?[\d.]+, u_cont: -?[\d.]+, u_disc: -?[\d.]+",
    r"l_recon_loss: -?[\d.]+, l_cont: -?[\d.]+, l_disc: -?[\d.]+, "
    r"class: -?[\d.]+", ""]


def write_mnist_idx(root: str, sizes, seed: int = SEED) -> None:
    """Seeded class-structured 28x28 MNIST idx files (train and t10k) of
    ``sizes`` images under ``root``, cut from one synthetic set, so both
    splits share each class's mean image and the test accuracy means
    something."""
    import struct

    from shotvae_torch.data.datasets import synthetic_dataset

    os.makedirs(root, exist_ok=True)
    ds = synthetic_dataset(sum(sizes), (28, 28, 1), 10, seed=seed)
    start = 0
    for prefix, n in zip(("train", "t10k"), sizes):
        part = slice(start, start + n)
        start += n
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28)
                    + ds.images[part].tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(struct.pack(">II", 2049, n)
                    + ds.labels[part].astype("uint8").tobytes())


def smooth_config(base: str, dataset: str, argv=()):
    """The config of ``python -m shotvae_torch.cli.main_smooth_elbo_<dataset>
    -bp <base> <argv>``."""
    from shotvae_torch.cli.main_smooth_elbo_mnist import (build_parser,
                                                          config_from_args)

    svhn = dataset == "svhn"
    return config_from_args(build_parser(svhn).parse_args(
        ["-bp", base, *argv]), svhn)


def smooth_trainer(model, cfg):
    """Adam at ``cfg``'s rate over ``model`` and the smooth-ELBO step of
    ``cfg``."""
    from shotvae_torch.train.state import TrainState, adam_torch
    from shotvae_torch.train.steps import make_smooth_elbo_train_step

    state = TrainState(model, adam_torch(model, cfg.learning_rate))
    return state, make_smooth_elbo_train_step(
        model, state.optimizer, alpha=cfg.alpha,
        cont_capacity=tuple(cfg.cont_capacity),
        disc_capacity=tuple(cfg.disc_capacity),
        disc_dims=tuple(cfg.latent_spec_disc))


def smooth_step_inputs(model, batch_u: int, batch_l: int):
    """Seeded uint8 images of both streams, labels and every draw of one
    smooth-ELBO step (the step's ``inject`` layout), on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 30)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    c = model.img_channels
    inject = {s: {"eps": t(rng.standard_normal(
        (n, model.latent_cont_dim), np.float32)),
        "unif": [t(rng.uniform(1e-4, 1 - 1e-4, (n, k)).astype(np.float32))
                 for k in model.disc_dims]}
        for s, n in (("u", batch_u), ("l", batch_l))}
    return (t(rng.integers(0, 256, (batch_u, 32, 32, c), dtype=np.uint8)),
            t(rng.integers(0, 256, (batch_l, 32, 32, c), dtype=np.uint8)),
            t(rng.integers(0, model.disc_dims[0], batch_l)), inject)


def smooth_train_once(model, cfg, inputs):
    """One smooth-ELBO step of ``model`` on ``inputs``: its metrics, and,
    on the CPU, each parameter's gradient, the parameters and both Adam
    moments after it."""
    import torch

    state, step = smooth_trainer(model, cfg)
    metrics = step(state, *inputs[:3], torch.Generator().manual_seed(SEED),
                   inputs[3])
    params = dict(model.named_parameters())
    check(all(p.grad is not None for p in params.values()),
          "a parameter got no gradient")
    adam = {n: state.optimizer.state[p] for n, p in params.items()}
    return ({k: v.cpu() for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in params.items()},
            {n: p.detach().cpu() for n, p in params.items()},
            {n: (s["exp_avg"].cpu(), s["exp_avg_sq"].cpu())
             for n, s in adam.items()})


def compare_smooth_step(dev, cfg, dataset: str, batch_u: int,
                        batch_l: int) -> dict:
    """One smooth-ELBO step of the same seeded model on ``dev`` and on the
    CPU at ``batch_u`` + ``batch_l``, every draw injected: each metric
    within TOL_STEP (abs + rel); each gradient norm-wise within
    max(TOL_GRAD_STEP, ULP_FACTOR x the CPU's own one-ulp spread); the
    parameters and both Adam moments after the update within TOL_STEP,
    except Adam's tiny-gradient elements: after a step from zero moments
    an element moves by lr * g / (|g| + eps), about +-lr whatever |g|, so
    an element whose gradient is within rounding of 0, and whose sign the
    card and the CPU round apart, lands 2 lr apart. Such elements (the
    two gradients of other signs, or one within Adam's eps of 0) are held
    by their gradient, which the norm-wise check covers, and counted."""
    import torch

    from shotvae_torch.train.loop import build_smooth_model

    cpu_model = build_smooth_model(cfg, dataset, "cpu")
    dev_model = copy.deepcopy(cpu_model).to(dev)
    ulp_model = one_ulp_apart(cpu_model)
    inputs = smooth_step_inputs(cpu_model, batch_u, batch_l)
    (m_dev, g_dev, p_dev, a_dev), (m_cpu, g_cpu, p_cpu, a_cpu), \
        (_, g_ulp, _, _) = [smooth_train_once(model, cfg, inputs)
                            for model in (dev_model, cpu_model, ulp_model)]
    check(set(m_dev) == set(m_cpu), "card and CPU metrics differ in keys")
    metric_err = max(max_err(m_dev[k], m_cpu[k], TOL_STEP,
                             what=f"smooth {dataset} step metric {k}")
                     for k in m_cpu)
    grads = check_gradients(g_dev, g_cpu, g_ulp)
    eps = 1e-8  # adam_torch's
    tiny, state_err, total = 0, 0.0, 0
    for n, want in p_cpu.items():
        diff = (p_dev[n] - want).abs()
        bad = diff > TOL_STEP * (1.0 + want.abs())
        flipped = (torch.sign(g_dev[n]) != torch.sign(g_cpu[n])) | (
            torch.minimum(g_dev[n].abs(), g_cpu[n].abs()) <= eps)
        left = bad & ~flipped
        if bool(left.any()):
            raise RuntimeError(
                f"card and CPU disagree on {n} after the update: "
                f"{int(left.sum())} elements beyond {TOL_STEP}, max "
                f"{float(diff[left].max()):.3e}")
        tiny += int((bad & flipped).sum())
        total += want.numel()
        state_err = max(state_err, float(diff[~bad].max()) if bool(
            (~bad).any()) else 0.0)
        for i, what in enumerate(("exp_avg", "exp_avg_sq")):
            state_err = max(state_err, max_err(
                a_dev[n][i], a_cpu[n][i], TOL_STEP,
                what=f"smooth {dataset} Adam {what} of {n}"))
    return {**dict(zip(VS_CPU_KEYS, (metric_err, *grads, state_err))),
            "adam_tiny_gradient_elements": tiny, "parameters": total}


def smooth_phase(dev, base: str, dataset: str, argv=(),
                 mnist_sizes=SMOOTH_MNIST_SIZES, epochs: int = SMOOTH_EPOCHS,
                 band=None) -> dict:
    """Phase 12 for ``dataset`` under ``base``: ``epochs`` epochs of
    ``run_smooth_elbo`` at the CLI's defaults (and ``argv``), MNIST on
    written idx files of ``mnist_sizes`` images, SVHN through the synthetic
    fallback, under PyTorch's default float32 settings (the entry point
    pins exact float32); its losses, accuracies, log text and checkpoint
    checked, and with ``band`` (lo, hi) the epoch-1 average loss within
    [lo - (hi - lo), hi + (hi - lo)]; step, eval and epoch times and the
    idle share of one profiled step; one step on the card against the CPU
    at the configuration's batches. Every hand kernel's launch counter must
    read 0 over the phase: the smooth VAE has no BatchNorm and its train
    draw needs a gradient."""
    import torch

    from shotvae_torch.device import exact_f32
    from shotvae_torch.io.checkpoint import CheckpointManager
    from shotvae_torch.train.loop import build_smooth_model, run_smooth_elbo
    from shotvae_torch.train.steps import make_smooth_elbo_eval_step

    log = lambda *a: print(f"  smooth {dataset}:", *a)  # noqa: E731
    counters = kernel_counters()
    zero_counts(counters)
    cuda = dev.type == "cuda"
    if dataset == "mnist":
        cfg = smooth_config(base, dataset, argv)
        write_mnist_idx(cfg.path_to_data, mnist_sizes)
    else:
        cfg = smooth_config(base, dataset, ("--synthetic-data", *argv))
    out = run_smooth_elbo(cfg, dataset, max_epochs=epochs, log_fn=log,
                          device=dev)
    _sync(dev)
    history = out["history"]
    check(len(history) == epochs and all(
        math.isfinite(h["mean_loss"]) and 0.0 <= h["test_acc"] <= 1.0
        for h in history), f"the smooth {dataset} epochs gave {history}")
    h = history[-1]
    if band is not None:
        lo, hi = band
        loss = history[1]["mean_loss"]
        check(lo - (hi - lo) <= loss <= hi + (hi - lo),
              f"the smooth {dataset} epoch 1's average loss {loss} lies "
              f"outside the CPU seeds' band [{lo}, {hi}] widened by its "
              f"width {hi - lo}")
    lines = open(out["log_path"]).read().split("\n")
    patterns = SMOOTH_LOG_LINES * epochs
    check(len(lines) == len(patterns) + 1 and all(
        re.fullmatch(p, line) for p, line in zip(patterns, lines)),
        f"the smooth {dataset} log is not the JAX loop's text: {lines}")
    final = out["state"]
    ckpt = CheckpointManager(cfg.base_path, dataset.upper(), cfg.train_time,
                             tag="One-Stage-VAE")
    payload = torch.load(ckpt.latest_path(), map_location="cpu",
                         weights_only=True)
    fresh = build_smooth_model(cfg, dataset, dev)
    fresh.load_state_dict(payload["state_dict"], strict=True)
    want = final.model.state_dict()
    check(payload["step"] == final.step and all(
        torch.equal(v, want[k]) for k, v in fresh.state_dict().items()),
        f"the smooth {dataset} checkpoint differs from the final weights")
    times = out["epoch_times"][-1]  # the last epoch's: the first compiles
    epoch = dict(epoch_s=times["train_s"] + times["eval_s"],
                 train_s=times["train_s"], eval_s=times["eval_s"],
                 epochs=epochs, train_steps=final.step,
                 unlabeled_images_per_s=final.step // epochs
                 * cfg.unlabeled_batch_size / times["train_s"],
                 mean_loss=h["mean_loss"],
                 mean_loss_by_epoch=[e["mean_loss"] for e in history],
                 test_acc=h["test_acc"], lr_scale=h["lr_scale"],
                 band=band, checkpoint_bit_identical=True,
                 log_lines=len(lines) - 1)

    # the bare step alone at the configuration's batches, on seeded data,
    # in exact float32 as the entry point runs it
    with exact_f32():
        model = build_smooth_model(cfg, dataset, dev)
        state, step = smooth_trainer(model, cfg)
        img_u, img_l, lab_l, _ = smooth_step_inputs(
            model, cfg.unlabeled_batch_size, cfg.labeled_batch_size)
        img_u, img_l, lab_l = img_u.to(dev), img_l.to(dev), lab_l.to(dev)
        g = torch.Generator().manual_seed(SEED + 31)
        run = lambda: step(state, img_u, img_l, lab_l, g)  # noqa: E731
        timing = step_times(dev, run, cfg.unlabeled_batch_size, "")
        profile = device_breakdown(run, top=8) if cuda else None
        evaluate = make_smooth_elbo_eval_step(model)
        n = cfg.test_batch_size
        test_img = torch.randint(0, 256, (n, 32, 32, model.img_channels),
                                 generator=g, dtype=torch.uint8).to(dev)
        test_lab = torch.randint(0, 10, (n,), generator=g).to(dev)
        weight = torch.ones(n, device=dev)
        timing["eval_step_ms"] = host_ms(
            dev, lambda: evaluate(test_img, test_lab, weight))
        vs_cpu = compare_smooth_step(dev, cfg, dataset,
                                     cfg.unlabeled_batch_size,
                                     cfg.labeled_batch_size)
    launches = read_counts(counters, torch.float32)
    launches.update({f"{k}_bf16": v for k, v in read_counts(
        counters, torch.bfloat16).items()})
    check(set(launches.values()) == {0}, f"the smooth {dataset} path "
          f"launched hand kernels: {launches}")
    return dict(epoch=epoch, timing=timing, profile=profile, vs_cpu=vs_cpu,
                hand_kernel_launches=launches)


def smooth_phases(dev) -> dict:
    """Phase 12: ``smooth_phase`` for MNIST and SVHN under a folder of
    ``build/`` removed after; each part's lines printed as it ends."""
    out = {}
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    for dataset in ("mnist", "svhn"):
        t0 = time.perf_counter()
        base = tempfile.mkdtemp(prefix=f"smooth_{dataset}_", dir=root)
        try:
            res = out[dataset] = smooth_phase(dev, base, dataset,
                                              band=SMOOTH_BANDS[dataset])
        finally:
            shutil.rmtree(base, ignore_errors=True)
        cfg = smooth_config(".", dataset)
        batch = f"{cfg.unlabeled_batch_size}+{cfg.labeled_batch_size}"
        print(f"smooth_{dataset}_epoch_at_batch_{batch} "
              + json.dumps(res["epoch"]))
        print(f"smooth_{dataset}_step_at_batch_{batch} "
              + json.dumps(res["timing"]))
        print(f"smooth_{dataset}_step_profile_at_batch_{batch} "
              + json.dumps(res["profile"]))
        print(f"smooth_{dataset}_step_vs_cpu_at_batch_{batch} "
              + json.dumps(res["vs_cpu"]))
        print(f"smooth_{dataset}_hand_kernel_launches "
              + json.dumps(res["hand_kernel_launches"]))
        print(f"smooth {dataset} phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase 13

DP_WORLD = 2
DP_TIMEOUT_S = 900  # the two ranks' part (they build nothing)
# the two ranks' epoch: the loop's configuration on 12,000 synthetic images
# (cut from 50,000 to keep the phase near a minute): 7,000 unlabeled, so 9
# steps of 768 + 768; 7 valid and ceil(3,000 / 768) = 4 test batches, and
# rank 0's grid
DP_LOOP_CONFIG = dict(LOOP_CONFIG, synthetic_size=12_000)
DP_LOOP_STEPS = 9
DP_LOOP_EVAL_FORWARDS = 12
# the per-replica step's running statistics policy (the CLI's)
DP_BN_STATS = "replica0"


def dp_train_once(model, inputs, dp=None, **ranks):
    """One headline SHOT-VAE step of ``model`` on ``step_inputs``, each
    rank of ``dp`` on its rows (None: one process on all of them), with
    the step's ``ranks`` arguments (``trainer``'s); the mixup draws every
    rank shares come from one seed. Returns the metrics, each parameter's
    gradient (after the mean over the ranks) and the state after it, on
    the host."""
    import torch

    state, step, sched = trainer(model, dp=dp, **ranks)
    *data, inject = inputs
    if dp is not None:
        data = [dp.shard(t) for t in data]
    metrics = step(state, *data, sched, torch.Generator().manual_seed(
        SEED + (dp.rank if dp else 0)), inject,
        shared_generator=torch.Generator().manual_seed(SEED + 1))
    params = dict(model.named_parameters())
    check(all(p.grad is not None for p in params.values()),
          "a parameter got no gradient")
    return ({k: v.cpu() for k, v in metrics.items()},
            {n: p.grad.cpu() for n, p in params.items()},
            {k: v.cpu() for k, v in model.state_dict().items()})


def per_replica_inputs(inputs, world: int):
    """``step_inputs`` for the per-replica step over ``world`` ranks: the
    same rows and per-row draws, and each rank's own mixup (its partners
    among its rows in its rows of ``perm_*``, its own weight in
    ``lam_*``)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 40)
    *data, inject = inputs
    n = len(data[0]) // world
    inj = dict(inject)
    for k in ("perm_sm", "perm_mx"):
        inj[k] = torch.from_numpy(np.concatenate(
            [rng.permutation(n) for _ in range(world)]))
    inj["lam_sm"] = np.array([inject["lam_sm"], *rng.beta(
        0.1, 0.1, world - 1)], np.float32)
    inj["lam_mx"] = np.array([inject["lam_mx"], *rng.beta(
        2.0, 2.0, world - 1)], np.float32)
    return (*data, inj)


def rank_rows(inputs, rank: int, world: int):
    """Rank ``rank``'s part of ``per_replica_inputs``, as one process
    takes it: its rows, its per-row draws, its partners and weight."""
    *data, inject = inputs
    n = len(data[0]) // world
    rows = slice(rank * n, (rank + 1) * n)
    inj = {k: (v[rank] if k.startswith("lam") else
               tuple(a[rows] for a in v) if isinstance(v, tuple) else v[rows])
           for k, v in inject.items()}
    return (*[t[rows] for t in data], inj)


def per_replica_reference(dev, dtype, inputs, world: int):
    """What the per-replica step must give, from one process: a step on
    each rank's rows with its own draws, then the mean of their
    gradients applied as one SGD update, rank 0's running statistics
    (``replica0``) and the mean of the metrics."""
    import torch

    local = [dp_train_once(random_model(dev.type, dtype),
                           rank_rows(inputs, r, world))
             for r in range(world)]
    model = random_model(dev.type, dtype)
    state, _, _ = trainer(model)
    grads = {n: sum(lr[1][n] for lr in local) / world for n in local[0][1]}
    for n, p in model.named_parameters():
        p.grad = grads[n].to(dev)
    state.apply_gradients()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    sd.update({k: v for k, v in local[0][2].items() if "running" in k})
    metrics = {k: sum(lr[0][k] for lr in local) / world for k in local[0][0]}
    return metrics, grads, sd


def dp_loop_counts(steps: int, eval_forwards: int, rank: int) -> dict:
    """The launches of a rank's loop epoch: every rank runs every train
    step and its rows of every eval batch; the reconstruction grid is rank
    0's alone."""
    forwards = eval_forwards - (rank != 0)
    return {name: steps * n + forwards * EXPECTED_EVAL_LAUNCHES[name]
            for name, n in EXPECTED_TRAIN_LAUNCHES.items()}


def dp_rank(rank: int, world: int, folder: str) -> None:
    """One rank of phase 13's two (``parallel.spawn_ranks``), on the card
    every rank shares (or the CPU, as ``<folder>/job.pt`` says): the
    sync-BN step in f32 and bf16 and the per-replica bf16 step, each on
    its rows of the global batch with its launches counted; the bf16
    step's time on this rank; then one epoch of ``run_shot_vae`` under
    its own base path and rank 0's checkpoint restored. Writes
    ``<folder>/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.device import exact_f32
    from shotvae_torch.io.checkpoint import CheckpointManager
    from shotvae_torch.parallel import DataParallel
    from shotvae_torch.train.loop import build_model, build_state, run_shot_vae

    job = torch.load(os.path.join(folder, "job.pt"), weights_only=False)
    dev = torch.device(job["device"])
    cuda = dev.type == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    dp = DataParallel(dist.group.WORLD)
    counters = kernel_counters()
    inputs = step_inputs(job["batch"])
    out = {}
    with exact_f32():  # the bare step, held as the entry points run it
        for name, dtype, ranks in (
                ("sync_f32", None, {}),
                ("sync_bf16", torch.bfloat16, {}),
                ("per_replica_bf16", torch.bfloat16,
                 {"bn_per_replica": True, "bn_stats": DP_BN_STATS})):
            run_inputs = (per_replica_inputs(inputs, world) if ranks
                          else inputs)
            zero_counts(counters)
            res = dp_train_once(random_model(dev.type, dtype), run_inputs,
                                dp, **ranks)
            _sync(dev)
            launches = check_counts(
                counters, dtype, {k: n if cuda else 0 for k, n in
                                  EXPECTED_TRAIN_LAUNCHES.items()},
                f"rank {rank}'s {name} step")
            out[name] = dict(zip(("metrics", "grads", "state"), res),
                             launches=launches)
        if cuda:  # this rank's step time, the two sharing the card
            model = random_model(dev.type, torch.bfloat16)
            state, step, sched = trainer(model, dp=dp)
            data = [dp.shard(t).to(dev) for t in inputs[:-1]]
            g = torch.Generator().manual_seed(SEED + 9 + rank)
            shared = torch.Generator().manual_seed(SEED + 9)
            out["timing"] = step_times(
                dev, lambda: step(state, *data, sched, g,
                                  shared_generator=shared),
                len(data[2]), "")
    if job["loop_config"] is None:
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
        return
    base = os.path.join(folder, f"rank{rank}_base")
    os.makedirs(base)
    cfg = ShotVaeConfig(base_path=base, **job["loop_config"])
    zero_counts(counters)
    loop = run_shot_vae(cfg, max_epochs=1, log_fn=lambda *a: None,
                        device=dev)
    _sync(dev)
    launches = check_counts(
        counters, torch.bfloat16, {k: n if cuda else 0 for k, n in
                                   dp_loop_counts(*job["loop_size"],
                                                  rank).items()},
        f"rank {rank}'s loop epoch")
    launches["fused_joint_sample"] = read_counts(  # f32 under a bf16 trunk
        counters, torch.float32)["fused_joint_sample"]
    spec = cfg.apply_dataset_overrides()
    ckpt = CheckpointManager(os.path.join(folder, "rank0_base"), spec.name,
                             cfg.train_time)
    fresh = build_state(build_model(cfg, spec, dev), cfg, job["loop_size"][0])
    _, epoch, _ = ckpt.restore(fresh)
    diff = state_mismatches(fresh, loop["state"])
    check(epoch == 1 and not diff, f"rank {rank}: rank 0's checkpoint "
          f"differs from this rank's final state: {diff[:5]}")
    out["loop"] = dict(history=_no_seconds(loop["history"]),
                       launches=launches, restored_bit_identical=True,
                       epoch_times=loop["epoch_times"],
                       files=sorted(os.path.relpath(os.path.join(d, f), base)
                                    for d, _, fs in os.walk(base)
                                    for f in fs))
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))


def dp_world1_phase(dev, batch: int, fused_streams: bool = False) -> dict:
    """The group path at world size 1 in this process (NCCL on the card,
    gloo on the CPU): the bf16 sync-BN step with every collective issued,
    its launches counted, against today's step (no group) on the same
    inputs and draws, at the calibrated bf16 bound of the two steps'
    f32 counterparts; on the card each step's median of 10 twice, in
    turns. With ``fused_streams`` the fused two-stream step, held against
    the bare fused step, untimed (phase 14)."""
    import datetime

    import torch
    import torch.distributed as dist

    from shotvae_torch.device import exact_f32
    from shotvae_torch.parallel import DataParallel
    from shotvae_torch.parallel.mesh import COLLECTIVE_TIMEOUT_S, free_port

    cuda = dev.type == "cuda"
    backend = "nccl" if cuda else "gloo"
    counters = kernel_counters()
    inputs = step_inputs(batch)
    step_kw = {"fused_streams": True} if fused_streams else {}
    expected = (EXPECTED_FUSED_TRAIN_LAUNCHES if fused_streams
                else EXPECTED_TRAIN_LAUNCHES)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        with exact_f32():
            zero_counts(counters)
            model = random_model(dev.type, torch.bfloat16)
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
            got = dp_train_once(model, inputs, DataParallel(dist.group.WORLD),
                                **step_kw)
            _sync(dev)
            launches = check_counts(
                counters, torch.bfloat16, {k: n if cuda else 0 for k, n in
                                           expected.items()},
                f"the world-1 {backend} step")
            want, f32 = [dp_train_once(random_model(dev.type, dtype), inputs,
                                       **step_kw)
                         for dtype in (torch.bfloat16, None)]
            timing = {}
            if cuda and not fused_streams:  # with the group and without
                runs = {}
                for name, dp in (("group", DataParallel(dist.group.WORLD)),
                                 ("no_group", None)):
                    state, step, sched = trainer(
                        random_model(dev.type, torch.bfloat16), dp=dp)
                    data = [t.to(dev) for t in inputs[:-1]]
                    g = torch.Generator().manual_seed(SEED + 9)
                    runs[name] = functools.partial(
                        step, state, *data, sched, g,
                        shared_generator=torch.Generator().manual_seed(
                            SEED + 9))
                for name in ("group", "no_group", "group", "no_group"):
                    timing.setdefault(name, []).append(
                        step_times(dev, runs[name], batch, "")["step_ms"])
    finally:
        dist.destroy_process_group()
    flat = functools.partial(flat_step, before=before)
    got, want, f32 = flat(got), flat(want), flat(f32)
    held = hold_bf16(got, want, {k: _dist(w, f32[k]) for k, w in
                                 want.items()},
                     f"the world-1 {backend} step and today's step",
                     "step")
    return dict(backend=backend, launches=launches, vs_today=held,
                bit_identical_tensors=sum(
                    bool(torch.equal(got[k], w)) for k, w in want.items()),
                step_ms_medians=timing)


def dp_two_rank_phase(dev, batch: int, folder: str, loop_config: dict,
                      loop_size: tuple, rank_fn=None) -> dict:
    """Two ranks over gloo on this one card (or the CPU) through
    ``spawn_ranks`` (``rank_fn``, default ``dp_rank``), held against one
    process here on the same global batch and draws: the sync-BN step in
    f32 (metrics and state at TOL_STEP, gradients as phase 5 holds them)
    and in bf16, and the per-replica bf16 step against two one-process
    steps on each rank's rows, at the calibrated bf16 bound; the loop's
    epoch of ``loop_config`` (None: none) on both ranks with the same
    history, rank 0's checkpoint restored bit for bit on each, and only
    rank 0 writing files."""
    import torch

    from shotvae_torch.device import exact_f32
    from shotvae_torch.parallel import spawn_ranks

    cuda = dev.type == "cuda"
    torch.save({"device": dev.type, "batch": batch,
                "loop_config": loop_config, "loop_size": loop_size},
               os.path.join(folder, "job.pt"))
    t0 = time.perf_counter()
    spawn_ranks(rank_fn or dp_rank, DP_WORLD, folder, backend="gloo",
                timeout_s=DP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(folder, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    inputs = step_inputs(batch)
    out = {"ranks_s": ranks_s}
    with exact_f32():
        model32 = random_model(dev.type)
        before = {n: p.detach().cpu().clone()
                  for n, p in model32.named_parameters()}
        ref32 = dp_train_once(model32, inputs)
        ulp = dp_train_once(one_ulp_apart(random_model("cpu")).to(dev),
                            inputs)
        ref16 = dp_train_once(random_model(dev.type, torch.bfloat16), inputs)
        pr_inputs = per_replica_inputs(inputs, DP_WORLD)
        pr16, pr32 = [per_replica_reference(dev, dtype, pr_inputs, DP_WORLD)
                      for dtype in (torch.bfloat16, None)]
    flat = functools.partial(flat_step, before=before)
    for r, res in enumerate(ranks):
        what = f"rank {r} of {DP_WORLD}"
        f32 = res["sync_f32"]
        metric_err = max(max_err(f32["metrics"][k], ref32[0][k], TOL_STEP,
                                 what=f"{what}: sync f32 metric {k}")
                         for k in ref32[0])
        grads = check_gradients(f32["grads"], ref32[1], ulp[1],
                                f"{what}'s sync f32 step and one process")
        out[f"rank{r}_sync_f32_vs_one_process"] = dict(zip(
            VS_CPU_KEYS, (metric_err, *grads,
                          _state_errors(f32["state"], ref32[2], TOL_STEP))))
        for name, want, want32 in (("sync_bf16", ref16, ref32),
                                   ("per_replica_bf16", pr16, pr32)):
            got = res[name]
            w = flat(want)
            out[f"rank{r}_{name}_vs_one_process"] = hold_bf16(
                flat((got["metrics"], got["grads"], got["state"])), w,
                {k: _dist(v, flat(want32)[k]) for k, v in w.items()},
                f"{what}'s {name} step and one process's", "one process")
        out[f"rank{r}_launches"] = {name: res[name]["launches"] for name in
                                    ("sync_f32", "sync_bf16",
                                     "per_replica_bf16")}
        if cuda:
            out[f"rank{r}_bf16_step"] = res["timing"]
        if loop_config is not None:
            out[f"rank{r}_loop_launches"] = res["loop"]["launches"]
            out[f"rank{r}_loop_epoch_times"] = res["loop"]["epoch_times"]
    if loop_config is None:
        return out
    check(ranks[0]["loop"]["history"] == ranks[1]["loop"]["history"],
          "the two ranks' loop histories differ")
    (h,) = ranks[0]["loop"]["history"]
    check(math.isfinite(h["train_loss"]) and 0 <= h["valid_top1"] <= 1,
          f"the two-rank loop's epoch gave {h}")
    check(any(f.endswith("checkpoint.current")
              for f in ranks[0]["loop"]["files"])
          and ranks[1]["loop"]["files"] == [],
          f"rank 0 wrote {ranks[0]['loop']['files'][:4]}..., rank 1 "
          f"{ranks[1]['loop']['files'][:4]}: only rank 0 writes")
    out["loop"] = dict(history=h, restored_bit_identical=True,
                       rank0_files=len(ranks[0]["loop"]["files"]),
                       rank1_files=0)
    return out


def dp_phases(dev) -> dict:
    """Phase 13: the group path at world 1, then two ranks on the one
    card over gloo, under a folder of ``build/`` removed after."""
    t0 = time.perf_counter()
    out = {"world1": dp_world1_phase(dev, BATCH)}
    print(f"dp_world1_{out['world1']['backend']}_bf16_step_at_batch_{BATCH}+"
          f"{BATCH} " + json.dumps(out["world1"]))
    print("dp_two_ranks_backend gloo: two processes share the one card, "
          "their collectives staged through the host; not a multi-GPU speed")
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    folder = tempfile.mkdtemp(prefix="dp_", dir=root)
    try:
        out["two"] = dp_two_rank_phase(dev, BATCH, folder, DP_LOOP_CONFIG,
                                       (DP_LOOP_STEPS,
                                        DP_LOOP_EVAL_FORWARDS))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    for key, value in out["two"].items():
        print(f"dp_two_ranks_{key}_at_batch_{BATCH}+{BATCH} "
              + json.dumps(value))
    print(f"dp phase {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------- phase 14

FUSED_ROUNDS = 1  # rounds of the fused and the four-forward step, in turns
# the reference's nn.DataParallel positions (SURVEY.md section 2.6: each
# submodule; the MLP's encoder and classifier always): a .module after
# each match; the smooth VAE's, which the reference does not wrap, per
# top-level child
REFERENCE_WRAPPED_AT = {
    "vae": r"^(feature_extractor\.encoder\.[^.]+|continuous_inference\.[^.]+"
           r"|disc_latent_inference|feature_reconstructor)\.",
    "mlp": r"^(encoder|classifier)\.",
    "smooth": r"^([^.]+)\.",
}


def reference_wrapped_keys(keys, kind: str) -> list:
    """The key set of the reference's DataParallel model of ``kind``
    (``"vae"``, ``"mlp"`` or ``"smooth"``) from its plain ``keys``."""
    return [re.sub(REFERENCE_WRAPPED_AT[kind], r"\1.module.", k, count=1)
            for k in keys]


def fused_step_phase(dev, batch: int, dtype=None,
                     steps: int = TRAIN_STEPS) -> dict:
    """The fused two-stream SHOT-VAE step (``fused_streams``) of the
    headline configuration at ``batch`` + ``batch`` with the trunk in
    ``dtype``: ``steps`` steps with every kernel's launches and the
    model's forwards (two of 2 x ``batch`` rows a step) counted and the
    metrics finite; on the card, the fused and the four-forward step's
    median and range of 10 after 2, in turns (fused, four, then four,
    fused: FUSED_ROUNDS rounds) in this process, one profiled step of each
    and the peak memory of one step of each; then one fused step against
    the CPU at 16 + 16 with every draw injected: in f32 (metrics and state
    at TOL_STEP, gradients by phase 5's rule), in bf16 at the calibrated
    bound of the CPU's own fused bf16-vs-f32 distance."""
    import torch

    counters = kernel_counters()
    cuda = dev.type == "cuda"
    g = torch.Generator().manual_seed(SEED + 9)
    data = [torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                          dtype=torch.uint8).to(dev),
            (torch.arange(batch) % 10).to(dev),
            torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                          dtype=torch.uint8).to(dev),
            torch.randint(0, 10, (batch,), generator=g).to(dev)]
    runs, forwards = {}, []
    for kind in ("fused", "shot"):
        model = random_model(dev.type, dtype)
        state, step, sched = _trainer(kind)(model)
        if kind == "fused":
            hook = model.register_forward_pre_hook(
                lambda module, args: forwards.append(int(args[0].shape[0])))
        runs[kind] = functools.partial(step, state, *data, sched, g)
        runs[kind]()  # compiles every kernel variant the step needs
    _sync(dev)
    forwards.clear()
    zero_counts(counters)
    metrics = [runs["fused"]() for _ in range(steps)]
    _sync(dev)
    hook.remove()
    launches = check_counts(
        counters, dtype, {name: n * steps if cuda else 0 for name, n in
                          EXPECTED_FUSED_TRAIN_LAUNCHES.items()},
        "fused train steps")
    check(forwards == [2 * batch] * (2 * steps),
          f"{steps} fused steps ran forwards of {forwards} rows; expected "
          f"two of {2 * batch} a step")
    for m in metrics:
        check(all(bool(torch.isfinite(v)) for v in m.values()),
              f"non-finite fused train metrics {m}")
    out = dict(launches=launches, forward_rows=forwards[:2],
               last_metrics={k: float(v) for k, v in metrics[-1].items()})
    if cuda:
        peak = {}
        for kind in ("fused", "shot"):
            torch.cuda.reset_peak_memory_stats(dev)
            runs[kind]()
            _sync(dev)
            peak[kind] = torch.cuda.max_memory_allocated(dev) / 1e9
        timing = {"fused": [], "shot": []}
        for r in range(FUSED_ROUNDS):
            for kind in ("fused", "shot")[::1 if r % 2 == 0 else -1]:
                timing[kind].append(step_times(dev, runs[kind], batch, ""))
        out.update(peak_memory_gb=peak, timing=timing,
                   profile={kind: device_breakdown(runs[kind], top=12)
                            for kind in ("fused", "shot")})
    n = min(COMPARE_BATCH, batch)
    if dtype is None:
        out["vs_cpu"] = dict(zip(VS_CPU_KEYS,
                                 compare_train_step(dev, n, "fused")))
    else:
        out["vs_cpu_bf16"] = compare_train_step_bf16(
            dev, n, "fused", BF16_CALIBRATION_DRAWS)
    return out


def reference_ckpt_phase(dev, batch: int, folder: str) -> dict:
    """A reference-layout checkpoint: the headline WRN-28-2 SHOT-VAE's
    state_dict with the reference's DataParallel wrappers, saved as the
    reference's ``{"epoch", "args", "state_dict"}`` payload under
    ``folder``, served on ``dev`` through ``from_checkpoint`` (under
    PyTorch's default float32 settings: the endpoints pin exact float32):
    ``classify`` and ``encode`` on ``batch`` images equal the plain-key
    payload's bit for bit, with their launches checked; then a wrapped MLP
    classifier and a wrapped smooth VAE (MNIST) state_dict strict-loaded
    on ``dev`` by ``load_reference_state_dict``, equal to their source's
    weights and forwards bit for bit."""
    import torch

    from shotvae_torch.api import ShotVaeInference
    from shotvae_torch.io.reference import (load_reference_state_dict,
                                            reference_state_dict)
    from shotvae_torch.models.classifier import MLPClassifier
    from shotvae_torch.models.smooth_vae import SmoothVAE, mnist_vae_config

    cuda = dev.type == "cuda"
    counters = kernel_counters()
    model = random_model("cpu")
    plain = reference_state_dict(model)
    wrapped = reference_state_dict(model,
                                   reference_wrapped_keys(plain, "vae"))
    served = {}
    for name, sd in (("plain", plain), ("wrapped", wrapped)):
        path = os.path.join(folder, f"{name}.pth.tar")
        torch.save({"epoch": 1, "args": {"net_name": WRN["net"]},
                    "state_dict": sd}, path)
        served[name] = ShotVaeInference.from_checkpoint(path, device=dev)
    g = torch.Generator().manual_seed(SEED + 4)
    images = torch.randint(0, 256, (batch, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    out = {"wrapped_keys": sum(".module." in k for k in wrapped),
           "keys": len(wrapped), "launches": {}}
    for endpoint in ("classify", "encode"):
        fused, bn_act, sample = EXPECTED_LAUNCHES[endpoint]
        expected = dict.fromkeys(EXPECTED_TRAIN_LAUNCHES, 0)
        expected.update(fused_bn_act_conv=fused, bn_act_inference=bn_act,
                        fused_joint_sample=sample)
        res = {}
        for name, server in served.items():
            zero_counts(counters)
            res[name] = getattr(server, endpoint)(images)
            _sync(dev)
            launches = check_counts(
                counters, torch.float32, {k: n if cuda else 0 for k, n in
                                          expected.items()},
                f"{endpoint} of the {name} checkpoint")
            for k, n in launches.items():
                out["launches"][k] = out["launches"].get(k, 0) + n
        a, b = (r if isinstance(r, tuple) else (r,) for r in res.values())
        check(all(torch.equal(x, y) for x, y in zip(a, b, strict=True)),
              f"{endpoint} of the wrapped checkpoint differs from the "
              f"plain one's")
    for kind, make, shape in (
            ("mlp", lambda: MLPClassifier(device=dev), (4, 3, 32, 32)),
            ("smooth", lambda: SmoothVAE(**mnist_vae_config(), device=dev),
             (4, 1, 32, 32))):
        torch.manual_seed(SEED)
        source = make().eval()
        sd = source.state_dict()
        model = load_reference_state_dict(
            make().eval(), reference_state_dict(
                source, reference_wrapped_keys(sd, kind)))
        check(all(torch.equal(v, model.state_dict()[k])
                  for k, v in sd.items()),
              f"the wrapped {kind} state_dict loaded other weights")
        # cuDNN deterministic: a ConvTranspose may take an algorithm that
        # sums with atomics, which no two calls need agree on bit for bit
        x = torch.rand(shape, generator=g).to(dev)
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with torch.no_grad():
                want, got = source(x), model(x)
        finally:
            torch.backends.cudnn.deterministic = saved
        want, got = (o if isinstance(o, tuple) else (o,)
                     for o in (want, got))
        check(torch.equal(got[0], want[0]),
              f"the wrapped {kind} model's forward differs from its "
              f"source's")
        out[f"{kind}_keys"] = len(sd)
    return out


def fused_phases(dev, batch: int, folder: str) -> dict:
    """Phase 14: the fused two-stream step at ``batch`` + ``batch`` in f32
    and bf16 (``fused_step_phase``), through an NCCL group of one rank
    (``dp_world1_phase``), and a reference-layout checkpoint served and
    loaded (``reference_ckpt_phase``, its files under ``folder``); each
    part's lines printed as it ends."""
    import torch

    from shotvae_torch.device import exact_f32

    out = {}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        t0 = time.perf_counter()
        with exact_f32():  # the bare steps, held as the entry points
            out[tag] = fused_step_phase(dev, batch, dtype)
        for key, value in out[tag].items():
            n = (min(COMPARE_BATCH, batch) if key.startswith("vs_cpu")
                 else batch)
            print(f"fused_train_{tag}_{key}_at_batch_{n}+{n} "
                  + json.dumps(value))
        print(f"fused {tag} phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["world1"] = dp_world1_phase(dev, batch, fused_streams=True)
    print(f"fused_dp_world1_{out['world1']['backend']}_bf16_step_at_batch_"
          f"{batch}+{batch} " + json.dumps(out["world1"]))
    out["reference"] = reference_ckpt_phase(dev, batch, folder)
    print(f"reference_ckpt_serve_at_batch_{batch} "
          + json.dumps(out["reference"]))
    print(f"fused world-1 and reference phase "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def fused_paths(fused: dict) -> dict:
    """{path: the bf16 launches of each kernel}: phase 14's fused steps,
    bare and through the group of one rank."""
    return {"fused_train_bf16": fused["bf16"]["launches"],
            "fused_dp_world1_bf16": fused["world1"]["launches"]}


# ---------------------------------------------------------------- phase 15

CHUNK_STEPS = 8     # the train steps of one replayed graph (--steps-per-call)
CHUNK_ROUNDS = 2    # rounds of the replays and the eager steps, in turns
# replays held against eager steps with their launches counted, and
# replays (and as many eager steps) timed per round, by the trunk's dtype:
# the f32 step is device bound (2 to 6 % idle) and 2.5x the eager bf16
# step's time, so its path is cut to keep the phase near 2 minutes
CHUNK_REPLAYS = {"bf16": 3, "f32": 1}
CHUNK_TIMED = {"bf16": 10, "f32": 1}
CHUNK_PATHS = (("shot_bf16", "shot", "bf16"), ("shot_f32", "shot", "f32"),
               ("m2_bf16", "m2", "bf16"),
               ("classifier_bf16", "classifier", "bf16"))
# the loop phase's epoch in chunks: 58 steps = 7 x 8 + 2
CHUNK_LOOP_CONFIG = dict(LOOP_CONFIG, steps_per_call=CHUNK_STEPS)
# its history against the loop phase's epoch, which ran without cuDNN's
# deterministic flag: the train loss relative, the accuracies absolute
CHUNK_LOOP_LOSS_REL = 1e-2
CHUNK_LOOP_TOP1_ABS = 0.02
# two tiny epochs across the LR warm-up's end, the first milestone and the
# Cifar10 ewm bump (all at the end of epoch 0: adjust_lr [0, 1, 2]), in
# chunks of 4 against per-step dispatch, bit for bit
CHUNK_BOUNDARY_CONFIG = dict(RESUME_CONFIG, ckpt_every=0)
CHUNK_BOUNDARY_STEPS = 4
# the encoders in a graph of CHUNK_ENCODER_STEPS steps at 768 + 768 in
# bf16: preactresnet18 and densenet121 --efficient with dropout 0.2 (its
# recompute restores the dropout generator's state inside the graph)
# against eager steps on a copy, bit for bit, timed: (tag, net, its key
# in EXPECTED_ENCODER_LAUNCHES); densenet121, which peaks near 75 GB of
# the card's 80 eagerly, alone (no eager copy beside it), then an eval
# step at 768 with the graph's memory pool held, then a replay again
CHUNK_ENCODER_STEPS = 2
CHUNK_ENCODER_PATHS = (
    ("preactresnet18", PREACT, "preactresnet18"),
    ("densenet121_efficient_dropout", dict(DENSE_EFF, drop_rate=0.2),
     "densenet121_efficient"))
# the device kernels of each wrapper in a profiler trace and in a
# captured graph (the Triton kernels by their names, the fused convs by a
# stem their names hold)
TRACE_KERNELS = {"bn_stats": "_stats_kernel", "bn_apply": "_apply_kernel",
                 "bn_bwd_reduce": "_bwd_reduce_kernel",
                 "bn_bwd_apply": "_bwd_apply_kernel",
                 "fused_bn_act_conv": "fused_bn_act_conv3x3"}


def cudnn_deterministic():
    """cuDNN's deterministic flag on inside, as it was after."""
    import torch

    @contextlib.contextmanager
    def flag():
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = saved
    return flag()


def _chunk_pool(dev, batch: int, kind: str):
    """A seeded resident dataset of one step's images (labeled, then
    unlabeled; the classifier: labeled) and each step's index row: a
    seeded permutation of each stream's rows."""
    import numpy as np

    from shotvae_torch.data.datasets import ArrayDataset
    from shotvae_torch.data.pipeline import DeviceDataset

    streams = 1 if kind == "classifier" else 2
    rng = np.random.default_rng(SEED + 30)
    ds = DeviceDataset(ArrayDataset(
        rng.integers(0, 256, (streams * batch, 32, 32, 3), dtype=np.uint8),
        np.arange(streams * batch) % 10), device=dev)

    def row(i: int):
        g = np.random.default_rng([SEED + 31, i])
        return np.concatenate([s * batch + g.permutation(batch)
                               for s in range(streams)])
    return ds, row


def _chunk_stepper(kind: str, step, pool, batch: int):
    """``step_by_index`` of a path over ``pool``."""
    def step_by_index(state, idx, sched, draws, inject=None, shared=None):
        img, lab = pool.gather(idx)
        if kind == "classifier":
            return step(state, img, lab, draws, inject)
        return step(state, img[:batch], lab[:batch], img[batch:],
                    lab[batch:], sched, draws, inject=inject,
                    shared_generator=shared)
    return step_by_index


def replay_profile(fn, counters, dtype, top: int = 10) -> dict:
    """One ``fn()`` (a replay of a graph already captured and replayed)
    under torch.profiler, as ``device_breakdown`` reads it (wall time,
    device busy time, idle share, the kernels that took the most device
    time), with each wrapper's device kernels in the trace and its
    counter's launches over the same call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    zero_counts(counters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]],
            "trace_kernels": {
                w: sum(n == k or (w == "fused_bn_act_conv" and k in n)
                       for n in names)
                for w, k in TRACE_KERNELS.items()},
            "counted": {w: c for w, c in read_counts(counters, dtype).items()
                        if w in TRACE_KERNELS}}


def _kernel_of(name: str):
    """The wrapper (a TRACE_KERNELS key) whose device kernel ``name`` is,
    or None."""
    for w, k in TRACE_KERNELS.items():
        if name == k or (w == "fused_bn_act_conv" and k in name):
            return w
    return None


# cudaGraphNodeType: the kinds phase 16 counts apart (the rest: "other")
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset",
                    6: "event_wait", 7: "event_record"}


def graph_nodes(graph) -> list:
    """[(node type, function name of a kernel node, else None)] of a
    captured CUDA graph that kept its cudaGraph_t (``keep_graph=True``),
    read through libcuda: cuGraphGetNodes, cuGraphNodeGetType,
    cuGraphKernelNodeGetParams and cuFuncGetName (cuKernelGetName for a
    node that holds a library kernel)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        check(rc == 0, f"{fn} returned CUresult {rc}")

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", vp), ("grid", ctypes.c_uint * 3),
                    ("block", ctypes.c_uint * 3),
                    ("shared_bytes", ctypes.c_uint), ("params", vp),
                    ("extra", vp), ("kern", vp), ("ctx", vp)]

    handle = vp(int(graph.raw_cuda_graph()))
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(count))
    nodes = (vp * count.value)()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(count))
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            out.append((kind.value, None))
            continue
        params = Params()
        call("cuGraphKernelNodeGetParams_v2", vp(node),
             ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), vp(params.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), vp(params.kern))
        out.append((0, name.value.decode()))
    return out


def graph_kernels(graph) -> dict:
    """{function name: kernel nodes} of a captured CUDA graph
    (``graph_nodes``)."""
    import collections

    return dict(collections.Counter(name for kind, name in
                                    graph_nodes(graph) if kind == 0))


def graph_node_types(graph) -> dict:
    """A captured graph's nodes by type (GRAPH_NODE_TYPES, the rest
    ``other``), its NCCL kernels (``nccl*`` functions) counted apart from
    the other kernels, and those NCCL kernels by name."""
    import collections

    types = collections.Counter()
    nccl = collections.Counter()
    for kind, name in graph_nodes(graph):
        if kind == 0 and name.lower().startswith("nccl"):
            types["nccl_kernel"] += 1
            nccl[name[:60]] += 1
        else:
            types[GRAPH_NODE_TYPES.get(kind, "other")] += 1
    return {**{k: types.get(k, 0) for k in (
        "kernel", "nccl_kernel", "memcpy", "memset", "event_record",
        "event_wait", "other")}, "nccl_kernels_by_name": dict(nccl)}


def measured_runner():
    """``train.chunk.ChunkRunner`` whose graphs keep their cudaGraph_t
    (``keep_graph=True``; instantiated at the first replay), so that
    ``graph_launches`` can read their kernel nodes."""
    import torch

    from shotvae_torch.train.chunk import ChunkRunner

    class MeasuredRunner(ChunkRunner):
        def _new_graph(self):
            return torch.cuda.CUDAGraph(keep_graph=True)
    return MeasuredRunner


def graph_launches(runner, counters, what: str) -> dict:
    """{chunk length: {wrapper: kernel nodes}}: each captured graph's hand
    kernels, counted in the graph itself (``graph_kernels``), which must
    equal the launches its capture counted (and ``add_counts`` adds at
    each replay), every wrapper of TRACE_KERNELS by name; with every
    node's function name."""
    out = {}
    for n, graph in sorted(runner.graphs.items()):
        names = graph_kernels(graph.graph)
        nodes = {w: 0 for w in TRACE_KERNELS}
        for name, c in names.items():
            w = _kernel_of(name)
            if w is not None:
                nodes[w] += c
        held = {w: sum(graph.launches[counters[w]]) for w in TRACE_KERNELS}
        check(nodes == held, f"{what}: the graph of {n} steps holds "
              f"{nodes} hand kernel nodes; its capture counted {held}")
        out[n] = dict(nodes, kernel_nodes=sum(names.values()),
                      other_kernels=len([k for k in names
                                         if _kernel_of(k) is None]))
    return out


def chunk_path_phase(dev, batch: int, n: int, kind: str, dtype,
                     replays: int, timed: int, net: dict = WRN,
                     expected=None, step_kw=None) -> dict:
    """A training path (``kind`` ``"shot"``, ``"m2"`` or ``"classifier"``
    in ``dtype``, over the encoder of ``net``) through
    ``train.chunk.ChunkRunner`` in chunks of ``n`` steps: an eager chunk,
    then ``replays`` replays of the captured graph, against the same steps
    dispatched one by one on a copy of the model, with the same host
    generators and index rows, under cuDNN's deterministic flag: every
    chunk's metrics, then every parameter, BN statistic and momentum
    buffer, bit for bit. The
    replays move the launch counters by the path's per-step launches
    (``expected``, default the WRN-28-2 path's) times the steps, as the
    eager steps do; a wrapper counts in Python, so a replay adds what its
    capture counted, and on the card the graph's own kernel nodes are
    held against those counts (``graph_launches``). On the card, under
    the default flags, a second runner on the model: the
    capture's seconds, the per-step medians of ``timed`` replays and of
    ``timed`` eager steps in turns (CHUNK_ROUNDS rounds), one profiled
    replay (its idle share, and its kernels by name against the launches
    of n steps where the trace caught them) and the peak memory of the
    capture and its replays beside an eager step's.

    ``step_kw``: the step's data-parallel arguments (``dp``, a group's
    ``DataParallel``, and ``bn_per_replica``, ``bn_stats``,
    ``global_mixup``; phase 16). Each step then also draws from a
    generator every rank shares, and the collectives that the replays
    and each capture issued (``DataParallel.collectives``) must equal the
    eager steps'; on the card each graph's nodes are counted by type, and
    the timing adds, in turns, the replays of a runner with no group on a
    model of its own (phase 15's)."""
    import numpy as np
    import torch

    from shotvae_torch.parallel import DataParallel
    from shotvae_torch.train.chunk import ChunkRunner

    step_kw = step_kw or {}
    dp = step_kw.get("dp")
    counters = kernel_counters()
    cuda = dev.type == "cuda"
    pool, row = _chunk_pool(dev, batch, kind)

    def gen(i: int, group: bool = dp is not None):
        """Step i's (rank's, shared) host generators."""
        shared = torch.Generator().manual_seed(SEED + 4000 + i)
        return (torch.Generator().manual_seed(SEED + 40 + i),
                shared if group else None)

    def make(**kw):
        return _trainer(kind)(_model(kind, net)(dev.type, dtype), **kw)
    (state_a, step_a, sched), (state_b, step_b, _) = (make(**step_kw),
                                                      make(**step_kw))
    run_a = _chunk_stepper(kind, step_a, pool, batch)
    run_b = _chunk_stepper(kind, step_b, pool, batch)

    def chunk(runner, state, c0: int, steps: int = n):
        return runner.run(state, np.stack([row(i) for i in
                                           range(c0, c0 + steps)]),
                          [gen(i, runner.dp is not None)
                           for i in range(c0, c0 + steps)])

    def eager(i: int):
        g, shared = gen(i)
        m = run_b(state_b, torch.from_numpy(row(i)).to(dev), sched, g,
                  shared=shared)
        return torch.stack([m[k].to(torch.float32) for k in runner.keys])

    runner = measured_runner()(run_a, dev, steps=n, width=len(row(0)),
                               dp=dp)
    runner.set_sched(sched)
    expected = expected or PATHS[kind][0]
    with cudnn_deterministic():
        got = [chunk(runner, state_a, 0)]
        want = [eager(i) for i in range(n)]
        _sync(dev)
        zero_counts(counters)
        issued = DataParallel.collectives
        got += [chunk(runner, state_a, c * n)
                for c in range(1, replays + 1)]
        _sync(dev)
        replayed_collectives = DataParallel.collectives - issued
        replayed = {d: read_counts(counters, d)
                    for d in (torch.float32, torch.bfloat16)}
        launches = check_counts(
            counters, dtype, {k: replays * n * c if cuda else 0
                              for k, c in expected.items()},
            f"{replays} replays of the {n}-step {kind} graph")
        zero_counts(counters)
        issued = DataParallel.collectives
        want += [eager(i) for i in range(n, (replays + 1) * n)]
        _sync(dev)
        stepped_collectives = DataParallel.collectives - issued
        stepped = {d: read_counts(counters, d)
                   for d in (torch.float32, torch.bfloat16)}
    check(replayed == stepped, f"the {replays} replays of the {n}-"
          f"step graph moved the launch counters by {replayed}; the same "
          f"{replays * n} eager steps by {stepped}")
    captured = runner.graphs[n].collectives
    check(replayed_collectives == stepped_collectives
          == replays * captured and (dp is None) == (captured == 0),
          f"the {kind} graph of {n} steps captured {captured} collectives, "
          f"its {replays} replays issued {replayed_collectives}; the same "
          f"{replays * n} eager steps {stepped_collectives}")
    got, want = torch.cat(got), torch.stack(want)
    check(torch.equal(got, want), f"the chunked {kind} steps' metrics "
          f"differ from the eager steps' by {_dist(got, want):.3e}")
    diff = state_mismatches(state_a, state_b)
    check(not diff, f"after {(replays + 1) * n} {kind} steps the "
          f"chunked state differs from the eager one in {len(diff)} "
          f"tensors: {diff[:5]}")
    check(bool(torch.isfinite(got).all()), f"non-finite {kind} metrics")
    out = dict(steps_per_call=n, launches=launches,
               eager_vs_replay_bit_identical=dict(
                   steps=(replays + 1) * n,
                   tensors=len(state_a.model.state_dict())
                   + len(_momentum(state_a))),
               capture_s_deterministic=runner.capture_s.get(n),
               last_metrics=dict(zip(runner.keys, got[-1].tolist())))
    if dp is not None:
        out["collectives"] = dict(
            captured_per_graph=captured, replays=replayed_collectives,
            eager_steps=stepped_collectives, per_step=captured / n,
            backend=dp.backend, world_size=dp.world_size)
    if not cuda:
        return out
    out["graph_kernel_nodes"] = graph_launches(runner, counters,
                                               f"the {kind} path")
    if dp is not None:
        out["graph_node_types"] = graph_node_types(runner.graphs[n].graph)

    # the default flags: a runner of its own (an eager chunk, then the
    # capture) on the same model, timed against eager steps in turns;
    # over a group also against a runner with no group
    timer = ChunkRunner(run_a, dev, steps=n, width=len(row(0)), dp=dp)
    timer.set_sched(sched)
    c0 = (replays + 1) * n
    chunk(timer, state_a, c0)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    chunk(timer, state_a, c0 + n)  # the capture and one replay
    _sync(dev)
    peak_graph = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    eager(c0)
    _sync(dev)
    peak_eager = torch.cuda.max_memory_allocated(dev) / 1e9
    c0 += 2 * n
    runs = {"replay": lambda c: chunk(timer, state_a, c),
            "eager": eager}
    per = {"replay": n, "eager": 1}
    if dp is not None:
        state_c, step_c, _ = make()
        lone = ChunkRunner(_chunk_stepper(kind, step_c, pool, batch), dev,
                           steps=n, width=len(row(0)))
        lone.set_sched(sched)
        for c in (0, n):  # its eager chunk, then its capture
            chunk(lone, state_c, c)
        runs["replay_no_group"] = lambda c: chunk(lone, state_c, c)
        per["replay_no_group"] = n
    times = {how: [] for how in runs}
    for r in range(CHUNK_ROUNDS):
        for how in list(runs)[::1 if r % 2 == 0 else -1]:
            for _ in range(timed):
                t0 = time.perf_counter()
                runs[how](c0)
                _sync(dev)
                times[how].append((time.perf_counter() - t0) * 1e3
                                  / per[how])
            c0 += n
    timing = {}
    for how, ts in times.items():
        ts = sorted(ts)
        timing[f"{how}_step_ms"] = statistics.median(ts)
        timing[f"{how}_step_ms_range"] = [ts[0], ts[-1]]
    timing["replay_over_eager"] = (timing["replay_step_ms"]
                                   / timing["eager_step_ms"])
    profile = replay_profile(lambda: chunk(timer, state_a, c0), counters,
                             dtype)
    # the trace may drop records (phase 4), never add any
    caught = {w: c for w, c in profile["trace_kernels"].items() if c}
    check(all(c <= profile["counted"][w] for w, c in caught.items()),
          f"one profiled replay's trace shows {caught} kernels, more than "
          f"its counters {profile['counted']}")
    out.update(timing=timing, capture_s=timer.capture_s[n],
               profile=profile, trace_kernels_checked=sorted(caught),
               peak_memory_gb={"graph": peak_graph, "eager": peak_eager,
                               "ratio": peak_graph / peak_eager})
    return out


def _history_close(got: dict, want: dict) -> dict:
    """An epoch's history (``got``, in chunks) against the loop phase's
    epoch: the train loss relative, the accuracies absolute."""
    loss = abs(got["train_loss"] - want["train_loss"]) / abs(
        want["train_loss"])
    top1 = max(abs(got[k] - want[k]) for k in ("valid_top1", "test_top1"))
    check(loss <= CHUNK_LOOP_LOSS_REL and top1 <= CHUNK_LOOP_TOP1_ABS,
          f"the chunked epoch's history {got} is off the per-step epoch's "
          f"{want}: train loss {loss:.3e} relative, top1 {top1:.3e}")
    return {"train_loss_rel": loss, "top1_abs": top1}


def chunk_loop_phase(dev, base: str, want: dict) -> dict:
    """One bf16 epoch of ``run_shot_vae`` at ``--steps-per-call``
    CHUNK_STEPS (CHUNK_LOOP_CONFIG: LOOP_STEPS train steps in chunks of 8
    and a tail of 2, LOOP_EVAL_FORWARDS eval forwards) under ``base``: its
    launches exactly the loop phase's, its history within the bands of
    the loop phase's epoch ``want``, its train seconds beside it; the
    loop's runner measured (``measured_runner``): each captured graph's
    hand kernel nodes equal to the launches its capture counted."""
    import torch

    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.train.loop import run_shot_vae

    from shotvae_torch.train import loop

    counters = kernel_counters()
    cfg = ShotVaeConfig(base_path=base, **CHUNK_LOOP_CONFIG)
    runners = []

    class Recorded(measured_runner()):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runners.append(self)

    zero_counts(counters)
    plain, loop.ChunkRunner = loop.ChunkRunner, Recorded
    try:
        out = run_shot_vae(cfg, max_epochs=1, log_fn=lambda *a: print(
            "  chunk loop:", *a), device=dev)
    finally:
        loop.ChunkRunner = plain
    _sync(dev)
    check(len(runners) == 1, f"the epoch made {len(runners)} chunk runners")
    nodes = graph_launches(runners[0], counters, "the chunked epoch")
    check(sorted(nodes) == [LOOP_STEPS % CHUNK_STEPS, CHUNK_STEPS],
          f"the chunked epoch captured graphs of {sorted(nodes)} steps")
    launches = check_counts(
        counters, cfg.compute_dtype(),
        {name: (LOOP_STEPS * c + LOOP_EVAL_FORWARDS
                * EXPECTED_EVAL_LAUNCHES[name])
         for name, c in EXPECTED_TRAIN_LAUNCHES.items()},
        f"the chunked epoch ({LOOP_STEPS} steps, {LOOP_EVAL_FORWARDS} eval "
        f"forwards)")
    launches["fused_joint_sample"] = read_counts(
        counters, torch.float32)["fused_joint_sample"]
    check(launches == want["launches"], f"the chunked epoch launched "
          f"{launches}; the per-step epoch {want['launches']}")
    (h,) = out["history"]
    times = out["epoch_times"][0]
    return dict(launches=launches, steps_per_call=CHUNK_STEPS,
                graph_kernel_nodes=nodes,
                train_s=times["train_s"], eval_s=times["eval_s"],
                per_step_epoch_train_s=want["train_s"],
                train_s_ratio=times["train_s"] / want["train_s"],
                unlabeled_images_per_s=LOOP_STEPS * cfg.batch_size
                / times["train_s"],
                train_loss=h["train_loss"], valid_top1=h["valid_top1"],
                test_top1=h["test_top1"],
                vs_per_step_epoch=_history_close(h, want))


def chunk_boundary_phase(dev, base: str, config: dict, n: int) -> dict:
    """Two epochs of ``config`` (the LR warm-up's end, the first
    milestone and the ewm bump between them) at ``--steps-per-call n``
    against per-step dispatch, under cuDNN's deterministic flag: every
    tensor of the final state and the histories bit for bit, so a rate,
    loss weight or mixup weight frozen into a graph shows."""
    from shotvae_torch.config import ShotVaeConfig
    from shotvae_torch.train.loop import run_shot_vae

    runs = {}
    with cudnn_deterministic():
        for spc in (1, n):
            cfg = ShotVaeConfig(base_path=os.path.join(base, f"spc{spc}"),
                                steps_per_call=spc, **config)
            runs[spc] = (run_shot_vae(cfg, max_epochs=2,
                                      log_fn=lambda *a: None, device=dev),
                         cfg)
    (a, cfg_a), (b, cfg_b) = runs[1], runs[n]
    diff = state_mismatches(b["state"], a["state"])
    check(not diff, f"two epochs in chunks of {n} differ from per-step "
          f"dispatch in {len(diff)} tensors: {diff[:5]}")
    check(_no_seconds(a["history"]) == _no_seconds(b["history"]),
          f"the chunked history {b['history']} differs from "
          f"{a['history']}")
    check(cfg_a.ewm == cfg_b.ewm == 5 * ShotVaeConfig().ewm,
          f"ewm {cfg_a.ewm} / {cfg_b.ewm}: the bump did not happen")
    return dict(epochs=2, steps=b["state"].step, steps_per_call=n,
                bit_identical=True, tensors=len(
                    b["state"].model.state_dict()) + len(
                    _momentum(b["state"])), ewm=cfg_b.ewm)


def chunk_memory_phase(dev, batch: int, n: int, net: dict,
                       expected: dict) -> dict:
    """The bf16 SHOT-VAE step over ``net`` (densenet121, whose eager step
    peaks near 75 GB) at ``batch`` + ``batch`` in a graph of ``n`` steps,
    with no eager copy beside it: the peak memory of an eager chunk and of
    the capture and its replay; one replay's launches (``expected`` a
    step) and the graph's kernel nodes (``graph_launches``); an eval step
    at ``batch`` with the graph's memory pool held, its peak; a replay
    after it; finite metrics throughout."""
    import numpy as np
    import torch

    from shotvae_torch.train.steps import make_vae_eval_step

    counters = kernel_counters()
    pool, row = _chunk_pool(dev, batch, "shot")
    gen = lambda i: torch.Generator().manual_seed(SEED + 40 + i)  # noqa
    state, step, sched = trainer(random_model(dev.type, torch.bfloat16,
                                              net=net))
    runner = measured_runner()(_chunk_stepper("shot", step, pool, batch),
                               dev, steps=n, width=2 * batch)
    runner.set_sched(sched)

    def chunk(c0: int):
        return runner.run(state, np.stack([row(i) for i in
                                           range(c0, c0 + n)]),
                          [(gen(i), None) for i in range(c0, c0 + n)])

    def peak() -> float:
        _sync(dev)
        return torch.cuda.max_memory_allocated(dev) / 1e9

    peaks = {}
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = [chunk(0)]
    peaks["eager_chunk"] = peak()
    torch.cuda.reset_peak_memory_stats(dev)
    metrics.append(chunk(n))  # the capture and one replay
    peaks["capture_and_replay"] = peak()
    zero_counts(counters)
    metrics.append(chunk(2 * n))
    _sync(dev)
    launches = check_counts(counters, torch.bfloat16,
                            {k: n * c for k, c in expected.items()},
                            f"a replay of the {n}-step {net['net']} graph")
    nodes = graph_launches(runner, counters, net["net"])
    evaluate = make_vae_eval_step(state.model,
                                  num_classes=CLASSES[net["dataset"]],
                                  bce=True, x_sigma=1.0)
    img, lab = pool.gather(torch.from_numpy(row(0)[:batch]).to(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    sums, _ = evaluate(img, lab, torch.ones(batch, device=dev),
                       generator=torch.Generator().manual_seed(SEED))
    peaks["eval_with_graph_held"] = peak()
    metrics.append(chunk(3 * n))  # a replay after the eval step
    _sync(dev)
    metrics = torch.cat(metrics)
    check(bool(torch.isfinite(metrics).all()) and all(
        bool(torch.isfinite(v).all()) for v in sums.values()),
        f"non-finite {net['net']} metrics in or after a graph")
    return dict(steps_per_call=n, launches=launches, graph_kernel_nodes=nodes,
                capture_s=runner.capture_s[n], peak_memory_gb=peaks,
                reserved_gb=torch.cuda.memory_reserved(dev) / 1e9,
                steps=4 * n, last_metrics=dict(zip(runner.keys,
                                                   metrics[-1].tolist())))


def chunk_encoder_phases(dev, batch: int, n: int, card: str) -> dict:
    """The encoders in a graph of ``n`` bf16 SHOT-VAE steps at ``batch``
    + ``batch``: CHUNK_ENCODER_PATHS against eager steps bit for bit and
    timed (``chunk_path_phase``), densenet121 at its peak memory
    (``chunk_memory_phase``)."""
    import gc

    import torch

    from shotvae_torch.device import exact_f32

    out = {}

    def show(tag: str, t0: float) -> None:
        for key, value in out[tag].items():
            print(f"chunk_{tag}_{key}_at_batch_{batch} "
                  + json.dumps({"value": value, "card": card}))
        print(f"chunk {tag} phase {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

    for tag, net, name in CHUNK_ENCODER_PATHS:
        t0 = time.perf_counter()
        with exact_f32():
            out[tag] = chunk_path_phase(
                dev, batch, n, "shot", torch.bfloat16, 1, 1, net=net,
                expected=EXPECTED_ENCODER_LAUNCHES[name][0])
        show(tag, t0)
    t0 = time.perf_counter()
    with exact_f32():
        out["densenet121"] = chunk_memory_phase(
            dev, batch, n, DENSE, EXPECTED_ENCODER_LAUNCHES["densenet121"][0])
    show("densenet121", t0)
    return out


def chunk_phases(dev, batch: int, n: int, base: str, card: str,
                 loop_epoch=None, boundary=CHUNK_BOUNDARY_CONFIG,
                 boundary_steps: int = CHUNK_BOUNDARY_STEPS) -> dict:
    """Phase 15: ``--steps-per-call`` as one CUDA graph of ``n`` train
    steps (``chunk_path_phase``) for the bf16 SHOT-VAE step, the f32 one,
    the bf16 M2 and classifier steps at ``batch`` (+ ``batch``); on the
    card the encoders (``chunk_encoder_phases``); then, given the loop
    phase's epoch ``loop_epoch``, the chunked epoch
    (``chunk_loop_phase``), and two tiny epochs of ``boundary``
    (``chunk_boundary_phase``, chunks of ``boundary_steps``) under a
    folder of ``base``; each part's lines printed beside ``card``."""
    import torch

    from shotvae_torch.device import exact_f32

    out = {}
    for tag, kind, dt in CHUNK_PATHS:
        t0 = time.perf_counter()
        dtype = torch.bfloat16 if dt == "bf16" else None
        with exact_f32():  # the bare steps, held as the entry points
            out[tag] = chunk_path_phase(dev, batch, n, kind, dtype,
                                        CHUNK_REPLAYS[dt], CHUNK_TIMED[dt])
        for key, value in out[tag].items():
            print(f"chunk_{tag}_{key}_at_batch_{batch} "
                  + json.dumps({"value": value, "card": card}))
        print(f"chunk {tag} phase {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        out["encoders"] = chunk_encoder_phases(dev, batch,
                                               CHUNK_ENCODER_STEPS, card)
    if loop_epoch is not None:
        t0 = time.perf_counter()
        out["loop"] = chunk_loop_phase(dev, os.path.join(base, "loop"),
                                       loop_epoch)
        print(f"chunk_loop_epoch_at_batch_{BATCH}+{BATCH} "
              + json.dumps({"value": out["loop"], "card": card}))
        print(f"chunk loop phase {time.perf_counter() - t0:.1f} s")
    if boundary is not None:
        t0 = time.perf_counter()
        out["boundary"] = chunk_boundary_phase(
            dev, os.path.join(base, "boundary"), boundary, boundary_steps)
        print("chunk_boundary_two_epochs " + json.dumps(out["boundary"]))
        print(f"chunk boundary phase {time.perf_counter() - t0:.1f} s")
    return out


def chunk_paths(chunk: dict) -> dict:
    """{path: the bf16 launches of each kernel}: phase 15's replays and its
    chunked epoch."""
    out = {f"chunk_{tag}": chunk[tag]["launches"]
           for tag, _, dt in CHUNK_PATHS if dt == "bf16"}
    for name, res in chunk.get("encoders", {}).items():
        out[f"chunk_{name}_bf16"] = res["launches"]
    if "loop" in chunk:
        out["chunk_loop_bf16"] = chunk["loop"]["launches"]
    return out


# ---------------------------------------------------------------- phase 16

# --steps-per-call over a process group: each path as one CUDA graph of
# CHUNK_STEPS steps through an NCCL group of one rank (gloo on the CPU),
# held as phase 15 holds its paths, bf16 at 768 (+ 768)
GROUP_CHUNK_PATHS = (
    ("shot_sync_bf16", "shot", {}),
    ("shot_replica_global_mixup_bf16", "shot",
     {"bn_per_replica": True, "bn_stats": DP_BN_STATS,
      "global_mixup": True}),
    ("classifier_sync_bf16", "classifier", {}))
GROUP_CHUNK_REPLAYS = 3
# replays (and as many eager group steps) timed per round: an eager SHOT
# step through the group takes 0.3 to 0.8 s
GROUP_CHUNK_TIMED = 2
# the launcher run: torchrun with one process on phase 13's 12,000
# synthetic images, 9 steps of 768 + 768 an epoch in chunks of 4, 4 and 1
# (the first eager, then a graph of 4 and one of 1, captured and replayed),
# two epochs straight, then the second again from the first's checkpoint
GROUP_CLI_N = 4
GROUP_CLI_STEPS = 9
GROUP_CLI_TIMEOUT_S = 300
GROUP_CLI_ARGV = ["--num-devices", "1", "--steps-per-call", str(GROUP_CLI_N),
                  "--synthetic-data", "--yes", "--dataset", "Cifar10",
                  "--net-name", "wideresnet-28-2", "-b", str(BATCH), "--br",
                  "--om", "--synthetic-size", "12000", "-rf", "1", "-p",
                  "1", "--ckpt-every", "1", "--max-epochs", "2"]


def run_command(argv, env: dict, timeout_s: float) -> list:
    """``argv`` from the repository's root in a session of its own, its
    output unbuffered: [(seconds since the start, line)] of its stdout
    and stderr. Raises where it fails or outlasts ``timeout_s``; every
    process of its session is stopped."""
    import signal
    import threading

    def stop():
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT,
                            env=dict(env, PYTHONUNBUFFERED="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    timer = threading.Timer(timeout_s, stop)
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip()))
        proc.wait()
    finally:
        timer.cancel()
        stop()
    late = time.perf_counter() - t0 > timeout_s
    check(proc.returncode == 0 and not late,
          f"{' '.join(argv[:10])}... exited {proc.returncode} after "
          f"{time.perf_counter() - t0:.0f} s (limit {timeout_s:.0f}):\n"
          + "\n".join(line for _, line in lines[-40:]))
    return lines


def group_cli_phase(base: str) -> dict:
    """The launcher run on the card: ``python3 -m torch.distributed.run
    --nproc-per-node 1 -m shotvae_torch.cli.main_shot_vae`` with
    GROUP_CLI_ARGV (two epochs at ``--steps-per-call`` GROUP_CLI_N,
    checkpoints after each), under cuDNN's deterministic flag, which a
    ``sitecustomize`` module written under ``base`` and put first on
    PYTHONPATH sets at its start (the CLI has no flag for it, as the JAX
    package's has none); then the same command's ``main`` in this process
    under the same flag with ``--resume`` of a copy of the first epoch's
    checkpoint (a second launch would cost about 30 s of process start).
    The resumed second epoch must equal the straight run's: its log line,
    and its final state against the straight run's last checkpoint (every
    tensor of the model and the optimizer, the step) bit for bit. One
    process: ``parallel.setup`` joins torchrun's group only above one
    rank, so the run takes the path with no group."""
    import torch

    from shotvae_torch.parallel.mesh import free_port

    site = os.path.join(base, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write("import torch\ntorch.backends.cudnn.deterministic = True\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [site, ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    run_base = os.path.join(base, "run")
    folder = os.path.join(run_base, "Cifar10-SHOT-VAE", "parameter",
                          "train_time_1")

    def launch(*extra) -> tuple:
        """(the run's log text, {milestone: seconds since the launch})."""
        argv = [sys.executable, "-m", "torch.distributed.run",
                "--nproc-per-node", "1", "--master-addr", "127.0.0.1",
                "--master-port", str(free_port()), "-m",
                "shotvae_torch.cli.main_shot_vae", *GROUP_CLI_ARGV, "-bp",
                run_base, *extra]
        t0 = time.perf_counter()
        lines = run_command(argv, env, GROUP_CLI_TIMEOUT_S)
        marks = {"exit": time.perf_counter() - t0}
        for t, line in lines:
            for mark in ("Begin the", "Epoch: [0]", "Epoch: [1]",
                         "Epoch 0:", "Epoch 1:"):
                if line.strip().startswith(mark):
                    marks.setdefault(mark, t)
        return "\n".join(line for _, line in lines), marks

    def epoch_line(text: str, epoch: int) -> str:
        lines = [ln.strip() for ln in text.splitlines()
                 if ln.strip().startswith(f"Epoch {epoch}: valid top1")]
        check(len(lines) == 1, f"the launcher run logged {lines} for epoch "
              f"{epoch}")
        return lines[0]

    def payload(path: str) -> dict:
        return torch.load(path, map_location="cpu", weights_only=True)

    straight, straight_s = launch()  # the run, its milestones' seconds
    check(f"Epoch: [0][{GROUP_CLI_N}/{GROUP_CLI_STEPS}]" in straight,
          f"the launcher run's first chunk is not {GROUP_CLI_N} of "
          f"{GROUP_CLI_STEPS} steps")
    first = os.path.join(base, "epoch1.pth.tar")
    shutil.copyfile(os.path.join(folder, "checkpoint.slot0.pth.tar"), first)
    want = payload(os.path.join(folder, "checkpoint.slot1.pth.tar"))
    check(payload(first)["epoch"] == 1 and want["epoch"] == 2,
          "the launcher run's checkpoints are not those of epochs 1 and 2")
    from shotvae_torch.cli import main_shot_vae

    log = io.StringIO()
    with cudnn_deterministic(), contextlib.redirect_stdout(log):
        run = main_shot_vae.main([*GROUP_CLI_ARGV, "-bp", run_base,
                                  "--resume", first])
    state = run["state"]
    momentum = _momentum(state)
    diff = [k for k, v in state.model.state_dict().items()
            if not torch.equal(v.cpu(), want["state_dict"][k])]
    diff += [f"momentum {k}" for k, st in want["optimizer"]["state"].items()
             if not torch.equal(momentum[k].cpu(), st["momentum_buffer"])]
    check(not diff and state.step == want["step"] == 2 * GROUP_CLI_STEPS
          and [h["epoch"] for h in run["history"]] == [1],
          f"the resumed second epoch differs from the straight run's last "
          f"checkpoint in {diff[:5]} (step {state.step} / {want['step']})")
    line = epoch_line(log.getvalue(), 1)
    check(line == epoch_line(straight, 1), f"the resumed second epoch "
          f"logged {line!r}; the straight run {epoch_line(straight, 1)!r}")
    return dict(steps_per_call=GROUP_CLI_N, steps_per_epoch=GROUP_CLI_STEPS,
                epochs=2, epoch1_line=line, resumed_bit_identical=dict(
                    tensors=len(want["state_dict"]) + len(momentum),
                    step=state.step),
                straight_timeline_s=straight_s,
                resumed_epoch_s=run["history"][0]["seconds"],
                chunk_lines=[ln for ln in straight.splitlines()
                             if ln.strip().startswith("Epoch: [")],
                group="none: one process")


def group_chunk_phases(dev, batch: int, n: int, base: str, card: str,
                       cli: bool = True) -> dict:
    """Phase 16: ``--steps-per-call`` over a process group of one rank in
    this process (NCCL on the card, gloo on the CPU), each path of
    GROUP_CHUNK_PATHS as one graph of ``n`` steps at ``batch`` (+
    ``batch``) through ``chunk_path_phase`` with the group's step
    arguments; then, with ``cli``, the launcher run (``group_cli_phase``)
    under a folder of ``base``; each part's lines printed beside
    ``card``."""
    import datetime

    import torch
    import torch.distributed as dist

    from shotvae_torch.device import exact_f32
    from shotvae_torch.parallel import DataParallel
    from shotvae_torch.parallel.mesh import COLLECTIVE_TIMEOUT_S, free_port

    backend = "nccl" if dev.type == "cuda" else "gloo"
    out = {}
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        dp = DataParallel(dist.group.WORLD)
        for tag, kind, kw in GROUP_CHUNK_PATHS:
            t0 = time.perf_counter()
            with exact_f32():  # the bare steps, held as the entry points
                out[tag] = chunk_path_phase(
                    dev, batch, n, kind, torch.bfloat16, GROUP_CHUNK_REPLAYS,
                    GROUP_CHUNK_TIMED, step_kw=dict(dp=dp, **kw))
            for key, value in out[tag].items():
                print(f"group_chunk_{tag}_{key}_at_batch_{batch} "
                      + json.dumps({"value": value, "card": card}))
            print(f"group chunk {tag} phase {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    if cli:
        t0 = time.perf_counter()
        out["cli"] = group_cli_phase(base)
        print("group_chunk_launcher_run "
              + json.dumps({"value": out["cli"], "card": card}))
        print(f"group chunk launcher phase {time.perf_counter() - t0:.1f} s")
    return out


def group_chunk_paths(group: dict) -> dict:
    """{path: the bf16 launches of each kernel}: phase 16's replays."""
    return {f"group_chunk_{tag}": group[tag]["launches"]
            for tag, _, _ in GROUP_CHUNK_PATHS}


# -------------------------------------------------------------------- main


def bf16_phases(dev, batch: int, steps: int = TRAIN_STEPS) -> dict:
    """The bf16 trunk's phases: the bf16 kernels against their plain
    versions at every main-path shape, the train-mode fused site's bf16
    backward, then the bf16 train and eval steps (``train_phase``)."""
    from shotvae_torch.config import ShotVaeConfig

    dtype = ShotVaeConfig(br=True, om=True).compute_dtype()  # bf16 default
    out = {}
    for name, fn in (("bn_leaky_train", bn_leaky_phase),
                     ("bn_act_inference", bn_act_phase),
                     ("fused_bn_act_conv", conv_phase),
                     ("fused_bn_act_conv_train", conv_bwd_phase)):
        t0 = time.perf_counter()
        out[name] = fn(dev, batch, dtype)
        rows = out[name][0]
        for part, part_rows in (rows.items() if isinstance(rows, dict)
                                else ((name, rows),)):
            for row in part_rows:
                print(f"{part} bf16 {json.dumps(row)}")
        print(f"{name} bf16 phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["train"] = train_phase(dev, batch, steps, dtype)
    print(f"train bf16 phase {time.perf_counter() - t0:.1f} s")
    conv_train = sum(r["launches"] for r in out["fused_bn_act_conv_train"][0])
    launched = out["train"]["launches"]["fused_bn_act_conv"]
    check(dev.type != "cuda" or conv_train * steps == launched,
          f"the bf16 fused conv backward rows weigh {conv_train} launches "
          f"per train step; {steps} steps launched {launched}")
    return out


def sass_count(name: str, op: str) -> int:
    """Lines of ``op`` in the SASS of ``csrc/<name>.cu``'s built library."""
    from shotvae_torch.ops.kernels import _build

    out = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                          str(_build.library_path(name))],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    return sum(op in line for line in out.splitlines())


def ptxas_summary(log: str) -> list:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its registers and spill
    bytes (stores, loads)."""
    out, name = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            name = found.group(1)
            out.append(dict(kernel=name, registers=None, spill_stores=None,
                            spill_loads=None))
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if found and out:
            out[-1].update(spill_stores=int(found.group(1)),
                           spill_loads=int(found.group(2)))
        found = re.search(r"Used (\d+) registers", line)
        if found and out:
            out[-1]["registers"] = int(found.group(1))
    return out


def summarize(name, route, source, replaces, bound_by, rows, err, launches,
              per: str = f"reconstruct at batch {BATCH}"):
    """One kernel's entry: per-shape times weighted by the launches per
    ``per`` (a ``reconstruct``, an eval step or a train step at batch 768),
    which are ``launches_per_unit``; ``launches`` counts the whole main
    path. A ``bound_by`` of None is taken from the rows: what bounds the
    rows that carry most of the summed bound."""
    total = lambda key: sum(r[key] * r["launches"] for r in rows)  # noqa: E731
    if bound_by is None:
        by = {}
        for r in rows:
            by[r["bound_by"]] = (by.get(r["bound_by"], 0.0)
                                 + r["bound_ms"] * r["launches"])
        bound_by = max(by, key=by.get)
    return dict(name=name, route=route, source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=total("ms"),
                plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                bound_by=bound_by,
                library_ms=(None if rows[0]["library_ms"] is None
                            else total("library_ms")), per=per,
                launches_per_unit=sum(r["launches"] for r in rows))


def encoder_phases(dev, batch: int, steps: int = TRAIN_STEPS,
                   loop: tuple = (ENCODER_LOOP_CONFIG, LOOP_STEPS,
                                  LOOP_EVAL_FORWARDS)) -> dict:
    """Phase 11: the encoders' kernel shapes, their bf16 SHOT-VAE train and
    eval steps (``steps`` counted), the M2 step and epoch of ``loop``
    (config, steps, eval forwards) under a folder of ``build/`` removed
    after, and f32 serving; each part's lines printed as it ends."""
    from shotvae_torch.device import exact_f32

    out = {}
    t0 = time.perf_counter()
    with exact_f32():  # the kernels and bare steps; serving pins its own
        out["kernels"] = encoder_kernel_phase(dev, batch)
    for name in ("preactresnet18", "densenet121"):
        res = out["kernels"][name]
        print(f"{name}_sites " + json.dumps(res["sites"]))
        for part in ("bn_leaky_train", "bn_act_inference",
                     "bn_act_inference_f32", "fused_bn_act_conv",
                     "fused_bn_act_conv_f32", "fused_bn_act_conv_train"):
            rows, err = res[part]
            for kernel, kernel_rows in (rows.items() if isinstance(rows, dict)
                                        else ((part, rows),)):
                for row in kernel_rows:
                    print(f"{name} {kernel} {json.dumps(row)}")
    for name in ("preactresnet18", "densenet121"):
        print(f"{name}_kernel_ms_weighted "
              + json.dumps(weighted_rows(out["kernels"][name])))
    print("dense_bc_conv_max_abs_err_bf16_f32 "
          + json.dumps(out["kernels"]["dense_bc_conv"]))
    print("conv_check_shapes_f32_max_abs_err_relu_identity "
          + json.dumps(out["kernels"]["f32_conv_check"]))
    print(f"encoder kernel phase {time.perf_counter() - t0:.1f} s")
    with exact_f32():
        out["train"] = encoder_train_phase(dev, batch, steps)
    check_encoder_rows(out["kernels"], out["train"], steps)
    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="encoder_m2_", dir=root)
    try:
        with exact_f32():
            out["m2"] = encoder_m2_phase(dev, batch, base, *loop, steps)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    for key in ("launches", "eval_launches", "last_metrics", "timing",
                "profile", "loop"):
        print(f"preactresnet18_m2_bf16_{key}_at_batch_{batch} "
              + json.dumps(out["m2"][key]))
    print(f"preactresnet18 m2 phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["serve"] = {name: encoder_serve_phase(dev, batch, name)
                    for name in EXPECTED_ENCODER_SERVE}
    for name, res in out["serve"].items():
        print(f"{name}_serve_f32_at_batch_{batch} " + json.dumps(res))
    print(f"encoder serve phase {time.perf_counter() - t0:.1f} s")
    return out


# the kernels of the f32 entries of the kernels line, in their order
F32_ENTRY_KERNELS = ("bn_act_inference", "fused_bn_act_conv",
                     "fused_joint_sample", "bn_stats", "bn_apply",
                     "bn_bwd_reduce", "bn_bwd_apply")


def dp_paths(dp: dict) -> dict:
    """{path: the bf16 launches of each kernel}: phase 13's world-1 step
    and rank 0's steps and loop epoch."""
    two = dp["two"]
    return {"dp_world1_bf16": dp["world1"]["launches"],
            "dp_rank0_sync_bf16": two["rank0_launches"]["sync_bf16"],
            "dp_rank0_per_replica_bf16":
                two["rank0_launches"]["per_replica_bf16"],
            "dp_rank0_loop_bf16": two["rank0_loop_launches"]}


def baseline_paths(baselines: dict) -> dict:
    """{path: the bf16 launches of each kernel}: the M2 and classifier
    train steps, eval steps and epochs."""
    out = {}
    for kind, res in baselines.items():
        out[f"{kind}_train_bf16"] = res["launches"]
        out[f"{kind}_eval_bf16"] = res["eval_launches"]
        out[f"{kind}_loop_bf16"] = res["loop"]["launches"]
    return out


def bf16_entries(bf16: dict, loop_launches: dict, paths: dict) -> list:
    """The bf16 kernels' entries: the bn_leaky kernels per train step, the
    eval kernel and the fused conv per eval step (one encoder forward),
    each with its launches on the bf16 train and eval paths, in the
    loop's epoch (``loop_launches``) and on the M2 and classifier
    ``paths``, and its weights checked against the train and eval
    paths."""
    train = bf16["train"]
    bn_rows, bn_err = bf16["bn_leaky_train"]
    step = f"train step at {BATCH} + {BATCH}"
    evals = f"eval step at {BATCH}"
    entries = [
        (summarize("bn_act_inference bf16", "triton",
                   "shotvae_torch/ops/kernels/bn_act.py",
                   "shotvae_tpu/ops/pallas/fused_bn_act.py:261", "bytes",
                   *bf16["bn_act_inference"], 0, per=evals),
         "bn_act_inference", "eval"),
        (summarize("fused_bn_act_conv bf16", "cuda",
                   "shotvae_torch/csrc/fused_conv_bf16.cu",
                   "shotvae_tpu/ops/pallas/fused_conv.py:170", None,
                   *bf16["fused_bn_act_conv"], 0, per=evals),
         "fused_bn_act_conv", "eval"),
    ] + [
        (summarize(f"bn_leaky_train {part} bf16", "triton",
                   "shotvae_torch/ops/kernels/bn_leaky.py",
                   f"shotvae_tpu/ops/pallas/fused_bn_act.py:{line}", "bytes",
                   bn_rows[name], bn_err[name], 0, per=step),
         name, "train")
        for part, name, line in (("stats", "bn_stats", 140),
                                 ("apply", "bn_apply", 176),
                                 ("backward reduce", "bn_bwd_reduce", 206),
                                 ("backward apply", "bn_bwd_apply", 217))]
    for entry, name, unit_path in entries:
        by_path = {"train_bf16": train["launches"][name],
                   "eval_bf16": train["eval_launches"][name],
                   "loop_bf16": loop_launches[name]}
        by_path.update({path: c[name] for path, c in paths.items()})
        check(sum(by_path.values()) > 0, f"{name} bf16 never launched on "
              f"the main path")
        entry.update(launches=sum(by_path.values()),
                     launches_by_path=by_path)
        unit = by_path["train_bf16"] / TRAIN_STEPS \
            if unit_path == "train" else by_path["eval_bf16"]
        check(entry["launches_per_unit"] == unit, f"{name} bf16's timed rows "
              f"weigh {entry['launches_per_unit']} launches per "
              f"{entry['per']}; the main path launched {unit}")
    return [entry for entry, _, _ in entries]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "shotvae_torch", "csrc")):
        print("chip_smoke.py: the shotvae_torch package is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch sees no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    from shotvae_torch.device import exact_f32
    from shotvae_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma",
                                       "setmaxnreg", "arning")):
                print(f"  {name}: {line.strip()}")
    # the bf16 conv's warpgroup products (HGMMA) and TMA copies (UTMALDG;
    # UBLKCP for a plain bulk copy)
    sass = {op: sass_count("fused_conv_bf16", op)
            for op in ("HGMMA", "UTMALDG", "UBLKCP", "HMMA")}
    print("sass_fused_conv_bf16_lines " + json.dumps(sass))
    check(sass["HGMMA"] > 0, "the bf16 fused conv's SASS has no HGMMA "
          "(wgmma) instruction")
    check(sass["UTMALDG"] + sass["UBLKCP"] > 0, "the bf16 fused conv's SASS "
          "has no TMA copy (UTMALDG or UBLKCP)")
    # the f32 conv's asynchronous copies (cp.async: LDGSTS), and its
    # registers and spills
    sass = {op: sass_count("fused_conv", op)
            for op in ("LDGSTS", "UTMALDG", "UBLKCP", "FFMA")}
    print("sass_fused_conv_f32_lines " + json.dumps(sass))
    check(sass["LDGSTS"] + sass["UTMALDG"] + sass["UBLKCP"] > 0,
          "the f32 fused conv's SASS has no asynchronous copy (LDGSTS, "
          "UTMALDG or UBLKCP)")
    print("ptxas_fused_conv_f32 "
          + json.dumps(ptxas_summary(logs["fused_conv"])))

    dev = torch.device("cuda")
    phases = {}
    for name, fn in (("bn_act_inference", bn_act_phase),
                     ("fused_bn_act_conv", conv_phase),
                     ("fused_joint_sample", sample_phase)):
        t0 = time.perf_counter()
        with exact_f32():  # the kernels and their library yardsticks
            phases[name] = fn(dev, BATCH)
        for row in phases[name][0]:
            print(f"{name} {json.dumps(row)}")
        print(f"{name} phase {time.perf_counter() - t0:.1f} s")

    serving = ("fused_bn_act_conv", "bn_act_inference", "fused_joint_sample")
    counters = tuple(kernel_counters()[name] for name in serving)
    # the endpoints under PyTorch's default flags: they pin exact float32
    launches, e2e_err, timing, breakdown = end_to_end(BATCH, counters)
    print("e2e_vs_cpu_max_abs_err " + json.dumps(e2e_err))
    print(f"e2e_ms_at_batch_{BATCH} " + json.dumps(timing))
    print(f"reconstruct_profile_at_batch_{BATCH} " + json.dumps(breakdown))
    serve = dict(zip(serving, launches))

    t0 = time.perf_counter()
    with exact_f32():
        bn_rows, bn_err = bn_leaky_phase(dev, BATCH)
    for name, rows in bn_rows.items():
        for row in rows:
            print(f"{name} {json.dumps(row)}")
    print(f"bn_leaky_train phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with exact_f32():
        conv_bwd_rows, conv_bwd_err = conv_bwd_phase(dev, BATCH)
    for row in conv_bwd_rows:
        print(f"fused_bn_act_conv_train {json.dumps(row)}")
    print(f"fused conv backward phase {time.perf_counter() - t0:.1f} s, "
          f"max abs err {conv_bwd_err:.3e}")
    t0 = time.perf_counter()
    with exact_f32():  # the bare step functions, held as the entry points
        train = train_phase(dev, BATCH)
    for key in ("launches", "eval_launches", "last_metrics", "timing",
                "profile", "profile_bare_step_cudnn_tf32"):
        print(f"train_{key}_at_batch_{BATCH}+{BATCH} "
              + json.dumps(train[key]))
    print(f"train_step_vs_cpu_at_{COMPARE_BATCH}+{COMPARE_BATCH} "
          + json.dumps(train["vs_cpu"]))
    print(f"train phase {time.perf_counter() - t0:.1f} s")
    with exact_f32():
        bf16 = bf16_phases(dev, BATCH)
    for key in ("launches", "eval_launches", "last_metrics", "timing",
                "profile"):
        print(f"train_bf16_{key}_at_batch_{BATCH}+{BATCH} "
              + json.dumps(bf16["train"][key]))
    print(f"train_bf16_step_vs_cpu_at_{COMPARE_BATCH}+{COMPARE_BATCH} "
          + json.dumps(bf16["train"]["vs_cpu"]))
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    base = tempfile.mkdtemp(prefix="loop_", dir=os.path.join(ROOT, "build"))
    try:
        loop = loop_phase(dev, base, LOOP_CONFIG, LOOP_STEPS,
                          LOOP_EVAL_FORWARDS, RESUME_CONFIG)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    step_ms = bf16["train"]["timing"]["step_ms"]
    loop["epoch"]["bf16_step_median_images_per_s"] = BATCH / step_ms * 1e3
    print(f"loop_epoch_at_batch_{BATCH}+{BATCH} " + json.dumps(loop["epoch"]))
    print("loop_checkpoint_round_trip " + json.dumps(loop["round_trip"]))
    print("loop_resume_vs_straight " + json.dumps(loop["resume"]))
    print(f"loop phase {time.perf_counter() - t0:.1f} s")
    baselines = {}
    for kind, steps, forwards in (("m2", LOOP_STEPS, LOOP_EVAL_FORWARDS),
                                  ("classifier", CLS_LOOP_STEPS,
                                   CLS_LOOP_EVAL_FORWARDS)):
        t0 = time.perf_counter()
        with exact_f32():
            out = baselines[kind] = train_phase(dev, BATCH,
                                                dtype=torch.bfloat16,
                                                kind=kind)
        for key in ("launches", "eval_launches", "last_metrics", "timing",
                    "profile"):
            print(f"{kind}_train_bf16_{key}_at_batch_{BATCH} "
                  + json.dumps(out[key]))
        print(f"{kind}_train_step_vs_cpu_at_{COMPARE_BATCH} "
              + json.dumps(out["vs_cpu"]))
        print(f"{kind}_train_bf16_step_vs_cpu_at_{COMPARE_BATCH} "
              + json.dumps(out["vs_cpu_bf16"]))
        base = tempfile.mkdtemp(prefix=f"{kind}_",
                                dir=os.path.join(ROOT, "build"))
        try:
            out["loop"] = baseline_loop_phase(dev, base, kind, LOOP_CONFIG,
                                              steps, forwards)
        finally:
            shutil.rmtree(base, ignore_errors=True)
        print(f"{kind}_loop_epoch_at_batch_{BATCH} "
              + json.dumps(out["loop"]))
        print(f"{kind} phase {time.perf_counter() - t0:.1f} s")
    encoders = encoder_phases(dev, BATCH)
    smooth_phases(dev)  # phase 12: no hand kernel on this path
    dp = dp_phases(dev)  # phase 13
    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="fused_", dir=os.path.join(ROOT,
                                                                "build"))
    try:
        fused = fused_phases(dev, BATCH, folder)  # phase 14
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"fused phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="chunk_", dir=os.path.join(ROOT,
                                                                "build"))
    try:  # phase 15
        chunk = chunk_phases(dev, BATCH, CHUNK_STEPS, folder, smi,
                             loop_epoch=loop["epoch"])
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"chunk phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="group_", dir=os.path.join(ROOT,
                                                                "build"))
    try:  # phase 16
        group = group_chunk_phases(dev, BATCH, CHUNK_STEPS, folder, smi)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"group chunk phase {time.perf_counter() - t0:.1f} s")
    conv_train = sum(r["launches"] for r in conv_bwd_rows)
    check(conv_train * TRAIN_STEPS == train["launches"]["fused_bn_act_conv"],
          f"the fused conv backward rows weigh {conv_train} launches per "
          f"train step; {TRAIN_STEPS} steps launched "
          f"{train['launches']['fused_bn_act_conv']}")

    entries = [
        summarize("bn_act_inference", "triton",
                  "shotvae_torch/ops/kernels/bn_act.py",
                  "shotvae_tpu/ops/pallas/fused_bn_act.py:261", "bytes",
                  *phases["bn_act_inference"], serve["bn_act_inference"]),
        summarize("fused_bn_act_conv", "cuda", "shotvae_torch/csrc/fused_conv.cu",
                  "shotvae_tpu/ops/pallas/fused_conv.py:170", None,
                  *phases["fused_bn_act_conv"], serve["fused_bn_act_conv"]),
        summarize("fused_joint_sample", "cuda",
                  "shotvae_torch/csrc/fused_sample.cu",
                  "shotvae_tpu/ops/pallas/fused_sample.py:62", "bytes",
                  *phases["fused_joint_sample"], serve["fused_joint_sample"]),
    ] + [
        summarize(f"bn_leaky_train {part}", "triton",
                  "shotvae_torch/ops/kernels/bn_leaky.py",
                  f"shotvae_tpu/ops/pallas/fused_bn_act.py:{line}", "bytes",
                  bn_rows[name], bn_err[name], 0,
                  per=f"train step at {BATCH} + {BATCH}")
        for part, name, line in (("stats", "bn_stats", 140),
                                 ("apply", "bn_apply", 176),
                                 ("backward reduce", "bn_bwd_reduce", 206),
                                 ("backward apply", "bn_bwd_apply", 217))]
    # launches: every main-path run (serving, TRAIN_STEPS train steps, one
    # eval step), each counted from 0
    for entry, name in zip(entries, F32_ENTRY_KERNELS):
        by_path = {"serve": serve.get(name, 0),
                   "train": train["launches"][name],
                   "eval": train["eval_launches"][name]}
        check(sum(by_path.values()) > 0, f"{name} never launched on the "
              f"main path")
        entry.update(launches=sum(by_path.values()),
                     launches_by_path=by_path)
        # the launch weights of the entry's times against the counts: per
        # reconstruct (as end_to_end asserted) or per train step
        unit = (EXPECTED_LAUNCHES["reconstruct"][serving.index(name)]
                if name in serving else by_path["train"] / TRAIN_STEPS)
        check(entry["launches_per_unit"] == unit, f"{name}'s timed rows "
              f"weigh {entry['launches_per_unit']} launches per "
              f"{entry['per']}; the main path launched {unit}")
    # the sampler also ran once in the bf16 eval step (the heads stay f32)
    sampler = entries[2]
    sampler["launches_by_path"]["eval_bf16_trunk"] = \
        bf16["train"]["eval_launches"]["fused_joint_sample"]
    # and 25 times in the loop's bf16 epoch; so in each eval step and
    # epoch of the M2 and encoder paths
    sampler["launches_by_path"]["loop_bf16_trunk"] = \
        loop["epoch"]["launches"]["fused_joint_sample"]
    paths = baseline_paths(baselines)
    paths.update(encoder_paths(encoders))
    paths.update(dp_paths(dp))
    paths.update(fused_paths(fused))
    paths.update(chunk_paths(chunk))
    paths.update(group_chunk_paths(group))
    for path, counts in paths.items():
        if counts["fused_joint_sample"]:
            sampler["launches_by_path"][path] = counts["fused_joint_sample"]
    # and in phase 11's f32 serving
    for entry in entries[:3]:
        for net, res in encoders["serve"].items():
            entry["launches_by_path"][f"{net}_serve"] = \
                res["launches"][entry["name"]]
    # and in phase 13's f32 sync-BN step on rank 0, in phase 14's f32
    # fused steps and its reference-layout checkpoint's serving, and in
    # phase 15's f32 replays
    for entry, name in zip(entries, F32_ENTRY_KERNELS):
        by_path = entry["launches_by_path"]
        by_path["chunk_shot_f32"] = chunk["shot_f32"]["launches"][name]
        by_path["dp_rank0_sync_f32"] = \
            dp["two"]["rank0_launches"]["sync_f32"][name]
        by_path["fused_train"] = fused["f32"]["launches"][name]
        by_path["reference_ckpt_serve"] = \
            fused["reference"]["launches"][name]
        entry["launches"] = sum(by_path.values())
    entries += bf16_entries(bf16, loop["epoch"]["launches"], paths)
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
