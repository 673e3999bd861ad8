"""On-card smoke run of nefes_tpu_torch on one NVIDIA GPU (written for the
H100: the kernels build for sm_90a).

    python3 chip_smoke.py [--phases build,check,mode3,mode2,apr,paths,serve,golden,train,traincli,zoo,accuracy,time,micro,probe,inscan_ab,profile,multichip,legacy]
        [--parent DIR]

Phases:
  build  compile the CUDA kernels from csrc/ (nvcc, one process per
         source, in parallel) into nefes_tpu_torch/_build/; with --parent
         also DIR's fused_render.cu, fused_field.cu and micro.cu, in
         parallel; each kernel's ptxas registers and stack frame; the
         micro chain kernels' shared memory a CTA and CTAs per SM, K11's
         CTAs per SM and piece; the render kernels'
         shared memory a block, blocks per SM and the backward's global
         scratch a ray; K1/K5's shared memory a block and blocks per SM in
         sigma and full mode (coarse tower) and transient mode (fine
         tower); K2/K6's likewise (the warp path in every mode); then the
         native image decoder (nefes_tpu_torch/native, g++ with libpng
         and libjpeg): whether it built, why not, and which route the
         7-Scenes loaders take (the decoder, or Pillow + OpenCV)
  check  K1-K8 against their plain PyTorch versions on the card, at the
         shapes of the refinement's main path, in bf16 and f32 (K1/K5 in
         sigma mode, without dirs, and in full mode, also at a sample
         count that is not a multiple of 128; K3/K4/K7/K8
         also at 64 rays of a depth-4, 16-feature field, and at full width
         at 256, 384 and 1024 samples a ray); and the
         training variants at the training shapes: K1/K5 in transient
         mode (also at the fine pass's samples less RAGGED; every head,
         the five transient ones each; two calls and the persistent grid
         against one block per block tile bit for bit the same), K2/K6
         with weight gradients in sigma, full and transient
         mode (every dW and bias gradient checked) and frozen in
         transient mode, two calls of each
         bit for bit the same, and the dW kernel (field_dw) alone on the
         operands of the first chunk of the fine and the coarse training
         pass against field_dw_plain; K2/K6 (the warp path) in sigma and
         full mode at the coarse training shape and in transient mode at
         the fine one, frozen and with dW: two calls, and the persistent
         grid against one block per block tile, bit for bit the same, and
         with dW over chunks that end in the middle of a block tile
         against the plain version
  mode3  mode-3 refinement at full width (NeFeS D8/W128/F128 in bf16,
         60x80 rays, 64+64 samples) through the pre-embedded kernels
         (fused=fused_pre=fused_render=True, frozen field: K1, K3, K4):
         time per frame, losses, launch counts, peak memory; then the
         captured serving loop (refine/graph.py: one iteration captured
         as a CUDA graph, replayed 50 times) beside the eager one, in
         turns (eager, captured, captured, eager): s/frame of each, the
         launches of a captured frame, losses within PATHS_RTOL of the
         first loss and poses within CAPTURED_POSE_TOL of the eager ones
  mode2  mode-2 refinement at full width (DFNet in f32 on a 240x320
         query, the same NeFeS field and render) through the raw-input
         kernels (fused=fused_render=True, fused_pre=False: K5, K7, K8):
         one warm-up frame, one timed frame with losses, PSNR/SSIM, the
         verification's decision, launch counts and peak memory; then
         one timed frame through the pre-embedded kernels (K1, K3, K4);
         the captured loop on the raw kernels in turns with the eager one,
         as mode 3's, and the verification's choice the same; then the
         same turns with DFNet in bf16 (the CLI's --apr_compute_dtype
         bfloat16; without svd_reg, cuDNN's deterministic algorithms),
         bit for bit the same, s/frame beside the f32 DFNet's
  apr    mode 2 with each APR of the zoo (PoseNet, PoseNetV2,
         EfficientNetB3, MapNet, MsTransformer; f32, seeded random weights
         aimed as DFNet is, no svd_reg, PoseNetV2 on batch BN
         statistics) after a 2-iteration warm-up, on the 240x320
         query, the same field and render, through the raw kernels (K5, K7,
         K8): the eager and the captured loop in turns as mode 2's (losses
         within PATHS_RTOL of the first loss, refined poses within
         APR_POSE_TOL, the verification's choice the same; eager against
         eager and captured against captured printed; cuDNN's
         deterministic algorithms), s/frame, peak
         memory, a captured frame's launches (50 of each); the APR's own
         forward + backward in an iteration, eager and captured as a CUDA
         graph (CUDA events); mode 3's
         apr_poses_batched on 8 queries against one at a time (1e-5)
  paths  a few iterations of each mode through the other paths: mode 3
         with fused_render=False (K1 + K2), unfused (plain PyTorch) and
         the raw paths (K5 + K7/K8, K5 + K6); mode 2 through the raw
         paths, the pre-embedded render and unfused. Their losses must
         agree with the mode's first path's
  serve  the refinement CLI (nefes_tpu_torch.cli.refine) on an 8-frame
         7-Scenes fixture written under tmp/ at the real layout (480x640
         PNGs, splits, pose txts, COLMAP tables, world setup) in mode 3
         and mode 2 at the defaults (df 2, tinyscale 4: 60x80 rays, 64+64
         samples, NeFeS D8/W128/F128 bf16, DFNet f32, 50 iterations, seeded
         random weights), mode 2 with --apr_compute_dtype bfloat16, then
         with --PoseEstimatorType MsTransformer in mode 2 and PoseNet in
         mode 3, every frame through the captured loop: s/frame,
         summary, peak memory, the kernels it ran and how often; the pose
         txt 8 x 12 finite and the evaluate CLI's medians the CLI's own
  golden the probe's golden command (nefes_tpu_torch/runtime/probe.py)
         on a reference-layout NeFeS .tar at full width (D8/W128/F128,
         numpy draws, seed 0) and a reference-layout DFNet .pt (the port's
         DFNet, seed 1, under the reference's keys), both written here, an
         8-frame 480x640 7-Scenes fixture and a paper_result tree (the
         "paper" poses the fixture's ground truth, the APR's 5 cm off):
         mode 2 at its defaults (df 2, 50 iterations, the bf16 DFNet,
         svd_reg, frozen BN), every frame through the captured loop (K5,
         K7, K8). Loose tolerances must pass, tolerances of -1 must exit
         non-zero; s/frame, the verdict, the launches
  train  field training at full width (NeFeS D8/W128/F128 in bf16, stage
         1, 4 images x 1536 random rays of a 60x80 render, 64+64 samples,
         perturbed, NeRF-W transient heads): 2 warm-up and 20 timed steps
         through the raw-input kernels with weight gradients (fused=True,
         fused_pre=False, fused_need_dw=True: K5, K6 +dW once a chunk of
         rows, each chunk followed by the dW kernel), s/step, rays/s,
         losses, peak memory, launch counts; 3 steps of each path (train_raw,
         train_pre through K1/K2, unfused) from one initial state, in bf16
         and f32, whose losses and parameters must agree; 3 stage-2 patch
         steps through the kernels (finite loss, BN running stats move)
  traincli the training CLI (nefes_tpu_torch.cli.train) end to end at
         full width (NeFeS D8/W128/F128 in f32, the defaults: 4 images x
         1536 rays of 60x80 renders, 64+64 samples, seeded random weights
         and DFNet) on 4 training frames added to the serve phase's
         fixture, seven runs: stage 1 for 3 epochs (its first epoch traced
         with --profile_dir), resumed for 2 more, stage 2 from its
         checkpoint (--ft_path: epoch and optimizer reset; 200 epochs of
         stage 1, then patch steps through FusionNet, the validation
         render at epoch 200), --reduce_embedding 2 for 2 epochs, the aux
         terms for 1, --render_test and --render_pose_only (8 views). Each:
         s/step and rays/s (the epochs' wall time less renders and
         checkpoints, the first epoch excluded), each validation render's
         time, main()'s wall time with set-up, peak memory, the launches
         of each step (K5, K6 +dW and the dW kernel; K1, K2 +dW and dW
         windowed) and render (K5 or K1 alone) against the expected;
         args.txt, metrics.jsonl (the JAX CLI's keys), the checkpoints,
         the evaluate_* PNGs and the spiral mp4 (8 frames) read back;
         finite losses, stage 0's falling
  zoo    the field zoo through the training CLI at its full defaults
         (D8/W128, 16 hash levels of 2^19 rows, bound 25, N_vocab 1000,
         f32, 4 images x 1536 rays of 60x80 renders, 64+64 samples, stage
         1, seeded random weights) on the traincli fixture: --tcnn with
         --l1normloss, --sh_nff, --ffmlp, --nerfh_nff False and --NeRFW
         False for ZOO_EPOCHS epochs each, the hash run resumed from its
         checkpoint, --render_test on the NeRF-W run; s/step, rays/s, peak
         memory, the loss falling, no kernel launched (the zoo runs plain
         PyTorch, as the JAX package runs it outside Pallas); then each
         kind's first step on the card against the CPU's from the same
         weights (the loss, every gradient, the parameters after Adam)
  accuracy the probe's accuracy command (nefes_tpu_torch/runtime/probe.py)
         at full width (192x256 images, NeFeS D8/W128/F128 trained in bf16,
         64+64 samples, 50 refinement iterations in f32) and reduced depth
         (ACCURACY_ARGS: 8 training views, 4 test frames, 2 epochs a stage,
         20 DFNet finetuning steps, 50 APR steps, one mode-2 lr per BN mode
         and the raw ablation, one mode-3 lr): each stage's launches and
         seconds (training K5 / K6 +dW / dW, the frozen renders K5, mode 2
         K5 / K7 / K8, mode 3 K1 / K3 / K4, no launch outside them), the
         result's keys against ACCURACY_r05.json's (the JAX command's
         record), every number finite, the stage-0 loss falling; the
         medians before and after and the wall time
  time   each kernel's time (CUDA events, median) beside its bound, its
         plain version's time and a bf16 torch.matmul chain over the same
         tower as a yardstick; the training variants at the fine training
         shape, and the coarse pass's training launches. K1 and K5, in
         sigma mode (main path) and transient mode (training's fine
         pass), in turns with themselves on one block per block tile
         instead of the persistent grid; with --parent DIR (an earlier
         tree, unpacked with git archive into a git-ignored directory)
         also DIR's, and the
         render kernels K3, K4, K7 and K8, the training backwards K2
         and K6 in transient mode (fine pass), with dW and frozen, and K2
         and K6 in full mode, frozen at the refinement's fine pass and K6
         with dW at the coarse training pass (this tree's backwards also
         on one block per block tile), of DIR and of this tree in turns
         on the same inputs, each of DIR's checked against its plain
         version first; the dW kernel alone on the fine pass's first
         chunk
  micro  the probe's kernelmicro (nefes_tpu_torch/runtime/probe.py) at the
         fine-pass shape, N = 614,400 rows: K9 (bare bf16 8-layer chain)
         at tiles 64 (micro.cu's m-tile), 512, 2048, 8192, K10 (2 and
         4 m-tiles in flight against each weight slice),
         K11 (the sin/cos embedding alone) at each tile, K12 (square
         chains of width 128 and 256), then K5, K1 and K1 + K2, each
         timed beside its bound, its plain version and a bf16
         torch.matmul chain; then K9-K12 against their plain versions at
         every tile and width (relative L2; K11 bit for bit; K10 at every
         nb the kernel takes equal to K9 and to K12 at w128 and w256);
         with --parent DIR also DIR's K9 at each tile, K10 x2 / x4, K11
         at each tile and K12 at both widths, each checked against its
         plain version first, and this tree's in turns (parent, this,
         this, parent; the median of 10 each)
  probe  the probe's kernel (K5/K6 against the plain field in f32 and
         bf16, K7/K8 against the plain fine pass and compositor), perf
         (the pieces of a mode-3 iteration through K1, K3, K4; one timed
         50-iteration refine) and mode2 (DFNet in f32 against bf16 in
         turns through K5, K7, K8: s/frame, final loss) commands once
  inscan_ab the probe's inscan_ab command: s/frame of the 50-iteration
         refinement in mode 3 and mode 2 (bf16 DFNet) for each variant
         (render_pre captured; unfused, fused_raw and fused_pre eager:
         the plain compositor's backward cannot be captured), each
         variant's launches exactly the kernels its flags name
  profile torch.profiler over 3 train_raw steps and 5 iterations of mode 3
         and mode 2, eager and captured: the device's busy share of the
         wall time, device time per kernel; then the probe's profile
         command (--mode both): each leg's device time by framework phase
         (runtime/xprof.py), host gap, bytes against the memory rate and
         top 12 kernels, the phases summing to the busy time
  multichip parallel/ on an NCCL group of one rank at full width: the
         sharded train step (MULTI_WARM warm-up steps, then MULTI_STEPS
         timed, of train_raw in bf16, the train phase's batch and seeds:
         K5, K6 +dW, dW), mode 3 on 2
         frames (K1, K3, K4), mode 2 on 1 frame (the bf16 DFNet, no
         svd_reg, cuDNN's deterministic algorithms: K5, K7, K8) and one
         60x80 image's render (K5 + K7), each bit for bit its unsharded
         function; s/step or s/frame, peak memory, launches; then 2 gloo
         ranks spawned on cuda:0, the f32 train step with 2 images a
         rank, against one rank's at JAX's tolerances (loss 2e-5
         relative, parameters 1e-5 absolute)
  legacy the legacy DFM toolbox: render_nerfw_imgs of 4 poses at 60x80
         through K5 + K7 against the plain path (relative L2 within
         PATHS_RTOL), the triplet family and masked_mse_loss with their
         gradients on the card against the CPU, create_warped_img of a
         batch of 8 480x640 images on the card against the CPU; the time
         of each

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed phase exits with 1 and prints
no result; so does a machine without a card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

H, W, FOCAL = 60, 80, 525.505 / 8
NEAR, FAR = 0.0, 4.0
N_C, N_F = 64, 64
ITERS = 50
# Kernel vs plain: relative L2 error ||kernel - plain|| / ||plain|| per
# output. In bf16 the two sum in another order (tensor cores vs cuBLAS),
# so a hidden unit whose pre-activation lies within one rounding of 0 can
# fall on the other side of the ReLU; a backward then passes or drops
# that unit's whole cotangent, which moves single entries by up to ~10 %
# while the tensor as a whole agrees. Max-abs errors are printed beside.
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# The paths phase: largest |loss difference| between a mode's paths over
# their iterations, relative to the first path's first loss.
PATHS_RTOL = 2e-3
# The captured serving loop (refine/graph.py) against the eager one:
# losses within PATHS_RTOL of the first loss, refined poses within this
# (max abs). Its Adam (GraphAdam) is the eager one bit for bit, but mode
# 2's svd_reg runs the polar iteration instead of the SVD. With torch's
# capturable Adam mode 3's poses parted by 3.7e-2 (PERF.md, PR 13).
CAPTURED_POSE_TOL = 1e-4
# The apr phase: the APR zoo in mode 2 (features/apr_loader.py kinds), and
# its captured loop's refined pose against the eager one's (max abs),
# written before the first run on the card: cuDNN's convolution backward
# may sum in another order from run to run, and Adam's normalised steps
# carry such differences to the weights.
ZOO = ("PoseNet", "PoseNetV2", "EfficientNetB3", "MapNet", "MsTransformer")
APR_POSE_TOL = 1e-3
# the mode-2 DFNet computing in bf16 (--apr_compute_dtype bfloat16), an
# APR "kind" of the mode2 phase's bf16 turns
BF16_DFNET = "DFNet-bf16"
# The train phase: B images x N_rand rays per step (bench.py's
# train_throughput leg), timed steps, and the parameters of the three
# paths after PATH_STEPS steps from one state, relative L2 ||p_path -
# p_train_raw|| / ||p_train_raw||. On an H100 the f32 paths agreed to
# 4.2e-7 (sums in another order only), bf16 to 1.3e-4: bf16 also rounds
# in other places (heads in bf16 on K1/K2, f32 on K5/K6), and Adam's
# first steps move every weight by about lr whatever its gradient's size,
# so a gradient near 0 whose sign differs moves a weight by up to 2 lr
# the other way. The limits are about 10x those.
TRAIN_B, N_RAND, TRAIN_STEPS, PATH_STEPS, TRAIN_LR = 4, 1536, 20, 3, 5e-4
PARAM_TOL = {"float32": 5e-6, "bfloat16": 1e-3}
# The serve phase: test frames of its 7-Scenes fixture (480x640 PNGs)
SERVE_FRAMES = 8
# The traincli phase: training frames added to that fixture (1 step an
# epoch at the CLI's batch of 4: stage 2 runs 200 epochs of ray steps
# before its patch steps, so this sets most of the phase's time), and the
# metrics.jsonl keys the JAX CLI writes at each stage
# (nefes_tpu/cli/train.py:327-333: epoch, stage, loss, wall_s and the
# step's metrics)
TRAINCLI_FRAMES = 4
CLI_METRIC_KEYS = {0: {"epoch", "stage", "loss", "wall_s", "loss_rgb",
                       "psnr"}}
CLI_METRIC_KEYS[1] = CLI_METRIC_KEYS[0] | {"loss_feat"}
CLI_METRIC_KEYS[2] = CLI_METRIC_KEYS[1] | {"loss_fusion"}
# The zoo phase: training frames of its fixture (2 steps an epoch),
# epochs of each run, rays an image of the card-against-CPU first step (a
# third of the CLI's 1536: the CPU's step takes seconds a kind), and its
# tolerance (zoo_step_compare): within ZOO_JITTER_X times how far the
# CPU's own step moves when the poses move by one rounding, or the floor:
# ZOO_STEP_TOL for the loss and the parameters after the step,
# ZOO_GRAD_TOL for each gradient (the hash tables' rows each sum up to
# ~1e5 contributions in the card's unordered scatter: 2.3e-4 to 2.2e-3
# relative L2 on an H100 80GB HBM3 at 700 W; PERF.md)
ZOO_FRAMES, ZOO_EPOCHS, ZOO_CHECK_RAYS, ZOO_JITTER_X = 8, 3, 512, 10.0
ZOO_STEP_TOL, ZOO_GRAD_TOL = 1e-5, 1e-2
# The accuracy phase: the probe's accuracy command at full width (192x256
# images, NeFeS D8/W128/F128, 64+64 samples, 50 iterations) and reduced
# depth, and the kernels each of its stages must launch: training through
# K5 / K6 +dW / dW (bf16, the fine pass in transient mode), the frozen
# renders through K5, mode 2 through K5 / K7 / K8 and mode 3 through K1 /
# K3 / K4 (f32)
ACCURACY_ARGS = ["accuracy", "--device", "cuda", "--n_train", "8",
                 "--n_test", "4", "--epochs_color", "2", "--epochs_feat", "2",
                 "--epochs_fusion", "2", "--feat_steps", "20",
                 "--apr_steps", "50", "--refine_lrs", "4e-6",
                 "--mode3_lr_r", "0.002", "--out", "tmp/accuracy_smoke.json"]
ACCURACY_KERNELS = {
    "train": ("K5 field_fwd", "K6 field_bwd", "K5 field_fwd transient",
              "K6 field_bwd +dW", "K2/K6 field_dw"),
    "render": ("K5 field_fwd",),
    "mode2": ("K5 field_fwd", "K7 render_fwd", "K8 render_bwd"),
    "mode3": ("K1 field_fwd_pre", "K3 render_fwd_pre", "K4 render_bwd_pre"),
}
# Mode 2: the query at 7-Scenes H/2, rendered at a quarter of that
IMG_H, IMG_W, FOCAL_FULL = 4 * H, 4 * W, 4 * FOCAL
# The probe phase: K5's bf16 max-abs error from the plain f32 field within
# PROBE_BAND times the plain bf16 field's, and the fused render's rgb
# within PROBE_RGB_TOL (max-abs) of the unfused fine pass + compositor. On
# an H100 the ratios read 0.06-0.79 and the rgb 2.6e-4 (PERF.md).
PROBE_BAND, PROBE_RGB_TOL = 4.0, 3e-3
# The first version of K1/K5, K2/K6 (frozen, full mode; in transient mode
# at the fine training pass with dW and frozen) and K3/K4/K7/K8 (f32
# tiles, weights through L1; the render kernels' composite in one thread,
# K4/K8 two tower forwards per sample), at the time phase's shape:
# PERF.md's times, an H100 80GB HBM3 at 700 W; the time phase prints them
# beside the new ones.
EARLIER_MS = {"K1 field_fwd_pre": 3.589, "K5 field_fwd": 3.739,
              "K2 field_bwd_pre": 28.915, "K6 field_bwd": 29.821,
              "K3 render_fwd_pre": 16.172, "K4 render_bwd_pre": 42.796,
              "K7 render_fwd": 14.576, "K8 render_bwd": 43.761,
              "K1 field_fwd_pre transient": 20.005,
              "K5 field_fwd transient": 20.756,
              "K2 field_bwd_pre +dW": 50.784, "K6 field_bwd +dW": 51.629,
              "K2 field_bwd_pre transient": 42.3,
              "K6 field_bwd transient": 43.3}
# The check phase's render kernels at full width: samples a ray (the
# backward's per-sample state past a block's shared memory from 205 in
# f32 and 270 in bf16) and rays
WIDE_S, WIDE_R = (256, 384, 1024), 64
# The check phase's K1/K5 also at the main path's sample counts less this,
# which is not a multiple of the 128-sample block tile
RAGGED = 37
# the multichip phase: warm-up and timed sharded train steps, the one
# deadline of both gloo ranks' joins (they take 12-18 s on an H100),
# JAX's multi-device tolerances (tests/test_sharding.py)
MULTI_WARM, MULTI_STEPS, GLOO_JOIN_S = 2, 2, 60
GLOO_LOSS_RTOL, GLOO_PARAM_ATOL = 2e-5, 1e-5
# the legacy phase: the features the losses take (L, B, H, W, C), the
# warp's batch, card-against-CPU tolerances (f32, summation order)
LEGACY_FEAT, WARP_B = (2, 4, 60, 80, 64), 8
LEGACY_TOL, LEGACY_WARP_ATOL = 1e-5, 1e-5
# the libraries of an earlier tree (--parent) that the time phase times
PARENT_LIBS = ("fused_render", "fused_field", "micro")
# the micro phase: the probe's rows (H x W x 128), its tiles and 64 rows
# (micro.cu's m-tile), the chain kernels the probe runs (nb, E, W), and
# the first design's times (PERF.md, an H100 80GB HBM3 at 700 W), printed
# beside the parent turns
MICRO_N, MICRO_TILES = 614400, (64, 512, 2048, 8192)
MICRO_CHAINS = ((1, 64, 128), (2, 64, 128), (4, 64, 128), (1, 128, 128),
                (1, 256, 256))
MICRO_EARLIER_MS = {"K9 tile 64": 5.808, "K9 tile 512": 6.584,
                    "K9 tile 2048": 8.020, "K9 tile 8192": 15.062,
                    "K10 x2": 7.899, "K10 x4": 9.272, "K11 tile 64": 0.179,
                    "K11 tile 512": 0.235, "K11 tile 2048": 0.307,
                    "K11 tile 8192": 1.056, "K12 w128": 8.615,
                    "K12 w256": 15.404}
# the field kernels' modes by number (csrc/tower.cuh Mode)
MODES = ("sigma", "full", "transient")
# kernel -> (the TPU kernel it replaces, its CUDA source)
_FF, _FR, _MC = ("nefes_tpu_torch/csrc/fused_field.cu",
                 "nefes_tpu_torch/csrc/fused_render.cu",
                 "nefes_tpu_torch/csrc/micro.cu")
KERNELS = {
    "K1 field_fwd_pre": ("nefes_tpu/kernels/fused_field.py:686", _FF),
    "K2 field_bwd_pre": ("nefes_tpu/kernels/fused_field.py:712", _FF),
    "K3 render_fwd_pre": ("nefes_tpu/kernels/fused_render.py:363", _FR),
    "K4 render_bwd_pre": ("nefes_tpu/kernels/fused_render.py:380", _FR),
    "K5 field_fwd": ("nefes_tpu/kernels/fused_field.py:597", _FF),
    "K6 field_bwd": ("nefes_tpu/kernels/fused_field.py:622", _FF),
    "K7 render_fwd": ("nefes_tpu/kernels/fused_render.py:208", _FR),
    "K8 render_bwd": ("nefes_tpu/kernels/fused_render.py:225", _FR),
    # the training variants of K1/K5 (transient mode) and K2/K6 (need_dw)
    "K1 field_fwd_pre transient": ("nefes_tpu/kernels/fused_field.py:686",
                                   _FF),
    "K2 field_bwd_pre +dW": ("nefes_tpu/kernels/fused_field.py:712", _FF),
    "K5 field_fwd transient": ("nefes_tpu/kernels/fused_field.py:597", _FF),
    "K6 field_bwd +dW": ("nefes_tpu/kernels/fused_field.py:622", _FF),
    # the weight gradients of K2/K6 +dW (_mlp_backward's dmat, need_dw)
    "K2/K6 field_dw": ("nefes_tpu/kernels/fused_field.py:477",
                       "nefes_tpu_torch/csrc/field_dw.cuh"),
    # the probe's micro-benchmarks (cmd_kernelmicro's pl.pallas_call sites)
    "K9 chain": ("runtime/probe.py:1264", _MC),
    "K10 chain_interleaved": ("runtime/probe.py:1298", _MC),
    "K11 embed_micro": ("runtime/probe.py:1340", _MC),
    "K12 chain_sq": ("runtime/probe.py:1374", _MC),
}


def dfnet_dtype(kind: str) -> str:
    """The compute dtype of the mode-2 DFNet of an APR kind of the smoke
    run: BF16_DFNET is the bf16 one."""
    return "bfloat16" if kind == BF16_DFNET else "float32"


def log(*a):
    print(*a, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="build,check,mode3,mode2,apr,paths,serve,"
                    "golden,train,traincli,zoo,accuracy,time,micro,probe,"
                    "inscan_ab,profile,multichip,legacy")
    ap.add_argument("--parent", default=None,
                    help="an earlier tree whose K1, K5 and render kernels "
                    "the time phase times beside this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2

    from nefes_tpu_torch.kernels import build
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import fused_render as kr
    from nefes_tpu_torch.kernels import micro as km
    from nefes_tpu_torch.runtime import probe

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = args.phases.split(",")
    failed: list[str] = []
    state: dict = {}
    kernels = {name: {"name": name, "route": "cuda", "replaces": tpu,
                      "source": src} for name, (tpu, src) in KERNELS.items()}

    def phase(name, fn):
        if name not in phases:
            return
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        except Exception:
            traceback.print_exc()
            log(f"== {name} FAILED")
            failed.append(name)
        log(f"== {name} done in {time.perf_counter() - t0:.1f} s")

    parent = ({} if args.parent is None else
              dict(build_dir=build.BUILD_DIR / "parent",
                   csrc=Path(args.parent) / "nefes_tpu_torch" / "csrc"))

    def do_build():
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            jobs = [ex.submit(build.build_all)]
            if parent:
                jobs.append(ex.submit(build.build_all, names=PARENT_LIBS,
                                      **parent))
            times = [j.result() for j in jobs]
        log(f"built in {time.perf_counter() - t0:.1f} s: {times}")
        logs = [(name, {}) for name in build.SOURCES]
        if parent:
            logs += [(name, parent) for name in PARENT_LIBS]
        for name, where in logs:
            entry = ""
            for line in build.build_log(name, **where).splitlines():
                if "Compiling entry function" in line:
                    entry = kernel_label(line)
                elif "registers" in line or "spill" in line:
                    log(f"  ptxas {'parent ' if where else ''}{name} "
                        f"{entry}: {line.strip()}")
        # the micro kernels at the probe's N: the chain's dynamic shared
        # memory a CTA and CTAs an SM (its ptxas registers are the launch
        # bound's 168; setmaxnreg gives the consumers 232, the producer
        # 40), K11's CTAs an SM and the rows of its piece by tile
        mlib = build.library("micro")
        sms = mlib.nefes_micro_sms()
        for nb, E, W_ in MICRO_CHAINS:
            grid = mlib.nefes_micro_chain_grid(1, MICRO_N, 64, nb, E, W_)
            log(f"micro chain E={E} W={W_} nb={nb}: "
                f"{mlib.nefes_micro_chain_smem(nb, E, W_)} B of shared "
                f"memory a CTA, {grid / sms:g} CTAs per SM ({sms} SMs)")
        for tile in MICRO_TILES:
            grid, rows = km.embed_grid(MICRO_N, tile)
            log(f"micro embed tile {tile}: {grid} CTAs ({grid / sms:g} "
                f"per SM), pieces of {rows} rows")
        # the render kernels at full width (D8/W128/F128), at the main
        # path's 128 samples and the check phase's: dynamic shared memory
        # of a block, blocks per SM, the backward's global scratch a ray
        from nefes_tpu_torch.train.model import ModelConfig
        lib = build.library("fused_render")
        dims = kf.dims(kf.FieldSpec.from_model(ModelConfig(), "fine"))
        for dt, code in (("bf16", 1), ("f32", 0)):
            for S in (N_C + N_F, *WIDE_S):
                for pair, bwd in (("K3/K7 render_fwd", 0),
                                  ("K4/K8 render_bwd", 1)):
                    blocks = [lib.nefes_render_blocks_per_sm(
                        code, bwd, raw, S, *dims) for raw in (0, 1)]
                    scratch = lib.nefes_render_bwd_scratch_bytes(code, S,
                                                                 *dims)
                    scratch = f", scratch {scratch} B a ray" if bwd else ""
                    log(f"{pair} {dt} at {S} samples: "
                        f"{lib.nefes_render_smem_bytes(code, bwd, S, *dims)}"
                        f" B of shared memory a block, blocks per SM "
                        f"{blocks[0]} / {blocks[1]} (pre / raw){scratch}")
        # the field forward K1/K5 by mode: sigma and full mode on the
        # coarse tower, transient mode on the fine one
        flib = build.library("fused_field")
        for dt, code in (("bf16", 1), ("f32", 0)):
            for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT):
                fdims = kf.dims(kf.FieldSpec.from_model(
                    ModelConfig(), "fine" if mode == kf.TRANSIENT
                    else "coarse"))
                blocks = [flib.nefes_field_blocks_per_sm(code, mode, raw,
                                                         *fdims)
                          for raw in (0, 1)]
                log(f"K1/K5 field_fwd {MODES[mode]} {dt}: "
                    f"{flib.nefes_field_smem_bytes(code, mode, *fdims)} B "
                    f"of shared memory a block, blocks per SM {blocks[0]} "
                    f"/ {blocks[1]} (pre / raw)")
            # the backward K2/K6's warp path: sigma and full mode on the
            # coarse tower, transient mode on the fine one
            for mode in (kf.SIGMA, kf.FULL, kf.TRANSIENT):
                bdims = kf.dims(kf.FieldSpec.from_model(
                    ModelConfig(), "fine" if mode == kf.TRANSIENT
                    else "coarse"))
                blocks = [flib.nefes_field_bwd_blocks_per_sm(code, mode, raw,
                                                             *bdims)
                          for raw in (0, 1)]
                log(f"K2/K6 field_bwd {MODES[mode]} {dt}: "
                    f"{flib.nefes_field_bwd_smem_bytes(code, mode, *bdims)} "
                    f"B of shared memory a block, blocks per SM {blocks[0]} "
                    f"/ {blocks[1]} (pre / raw)")
        # the host image decoder: built with g++ here, or the fallback
        from nefes_tpu_torch import native
        t0 = time.perf_counter()
        built = native.available()
        route = (os.environ.get("NEFES_NATIVE_LOADER", "1") != "0" and built)
        log(f"native image decoder: "
            f"{'built' if built else 'not built'} in "
            f"{time.perf_counter() - t0:.1f} s"
            f"{'' if built else f' ({native.unavailable_reason()})'}; the "
            f"7-Scenes loaders read through "
            f"{'it' if route else 'Pillow + OpenCV'}, Cambridge through "
            f"Pillow + OpenCV")

    phase("build", do_build)
    if "build" in failed:
        return finish(failed, kernels, smi)

    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    models = {}
    for dt in ("bfloat16", "float32"):
        cfg = ModelConfig(dtype=kf._DTYPES[dt])
        models[dt] = NeFeSModel(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0))
    model = models["bfloat16"]
    for m in models.values():
        m.requires_grad_(False)
    gt = torch.from_numpy(look_at()).to(dev)

    def compare(name, mode, dt, got, want, names=None):
        """Kernel outputs against the plain version's: relative L2 per
        output (None pairs skipped), max-abs beside; raises past TOL."""
        worst_abs, worst_l2, parts = 0.0, 0.0, []
        pairs = [(i, a, b) for i, (a, b) in enumerate(zip(got, want))
                 if b is not None]
        for i, a, b in pairs:
            a, b = a.float(), b.float()
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name} {dt}: non-finite")
            err = (a - b).abs().max().item()
            l2 = ((a - b).norm() / max(b.norm().item(), 1e-30)).item()
            worst_abs, worst_l2 = max(worst_abs, err), max(worst_l2, l2)
            if names:
                parts.append(f"{names[i]} {l2:.3e}/{err:.3e}")
        ok = worst_l2 <= TOL[dt]
        log(f"{name} {mode} {dt}: shapes "
            f"{[tuple(a.shape) for _, a, _ in pairs]} rel_l2 {worst_l2:.3e} "
            f"(tolerance {TOL[dt]:.0e}) max_abs {worst_abs:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if parts:
            log(f"  per output rel_l2/max_abs: {', '.join(parts)}")
        if not ok:
            raise AssertionError(f"{name} {dt} disagrees with plain")
        if dt == "bfloat16":
            kernels[name]["max_abs_err"] = max(
                worst_abs, kernels[name].get("max_abs_err", 0.0))

    def do_check():
        for dt, m in models.items():
            ins = main_path_inputs(m, gt, dev)
            state.setdefault("inputs", {})[dt] = ins
            gen = torch.Generator(device=dev).manual_seed(1)
            cd = kf._DTYPES[dt]
            pc, pf = ins["packed"]
            n_c, n_f = ins["emb_c"].shape[0], ins["emb"].shape[0]
            heads = ((n_f,), (n_f, 3), (n_f, pf.spec.feature_dim))
            g_field = [torch.randn(s, device=dev, generator=gen).to(cd)
                       for s in heads]
            g_raw = [torch.randn(s, device=dev, generator=gen)
                     for s in heads]
            g_sig_c = torch.randn(n_c, device=dev, generator=gen)
            g_ray = torch.randn((ins["z"].shape[0], pf.spec.rgbfeat + 2),
                                device=dev, generator=gen) * 1e-3
            ins.update(g_field=g_field, g_raw=g_raw, g_ray=g_ray)
            pts_c, pts, dirs, z = (ins["pts_c"], ins["pts"], ins["dirs"],
                                   ins["z"])
            # sample counts that are not a multiple of a block tile
            rc, rf = n_c - RAGGED, n_f - RAGGED
            # (kernel, mode, wrapper, plain version, call)
            cases = [
                ("K1 field_fwd_pre", "sigma", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pc, False, ins["emb_c"], None)[:1]),
                ("K1 field_fwd_pre", "full", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pf, True, ins["emb"], ins["embd"])),
                ("K1 field_fwd_pre", f"sigma N={rc}", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pc, False, ins["emb_c"][:rc], None)[:1]),
                ("K1 field_fwd_pre", f"full N={rf}", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain,
                 lambda f: f(pf, True, ins["emb"][:rf], ins["embd"][:rf])),
                ("K5 field_fwd", f"sigma N={rc}", kf.field_fwd,
                 kf.field_fwd_plain,
                 lambda f: f(pc, False, pts_c[:rc], None)[:1]),
                ("K5 field_fwd", f"full N={rf}", kf.field_fwd,
                 kf.field_fwd_plain,
                 lambda f: f(pf, True, pts[:rf], dirs[:rf])),
                ("K2 field_bwd_pre", "full", kf.field_bwd_pre,
                 kf.field_bwd_pre_plain,
                 lambda f: f(pf, True, ins["emb"], ins["embd"], *g_field)),
                ("K3 render_fwd_pre", "", kr.render_fwd_pre,
                 kr.render_fwd_pre_plain,
                 lambda f: (f(pf, ins["emb"], ins["embd"], z),)),
                ("K4 render_bwd_pre", "", kr.render_bwd_pre,
                 kr.render_bwd_pre_plain,
                 lambda f: f(pf, ins["emb"], ins["embd"], z, g_ray)),
                ("K5 field_fwd", "sigma", kf.field_fwd, kf.field_fwd_plain,
                 lambda f: f(pc, False, pts_c, None)[:1]),
                ("K5 field_fwd", "full", kf.field_fwd, kf.field_fwd_plain,
                 lambda f: f(pf, True, pts, dirs)),
                ("K6 field_bwd", "sigma", kf.field_bwd, kf.field_bwd_plain,
                 lambda f: f(pc, False, pts_c, None, g_sig_c, None,
                             None)[:1]),
                ("K6 field_bwd", "full", kf.field_bwd, kf.field_bwd_plain,
                 lambda f: f(pf, True, pts, dirs, *g_raw)),
                ("K7 render_fwd", "", kr.render_fwd, kr.render_fwd_plain,
                 lambda f: (f(pf, pts, dirs, z),)),
                ("K8 render_bwd", "", kr.render_bwd, kr.render_bwd_plain,
                 lambda f: f(pf, pts, dirs, z, g_ray)),
            ]
            for name, mode, kern, plain, case in cases:
                got = case(kern)
                torch.cuda.synchronize()
                compare(name, mode, dt, got, case(plain))
                del got
            check_training(dt, m)
            check_render_small(dt)
            check_render_wide(dt)
        # the time phase reads the bf16 inputs only
        del state["inputs"]["float32"], state["train_inputs"]["float32"]
        torch.cuda.empty_cache()

    def render_cases(mode, dt, pf, R, S, gen):
        """K3/K4/K7/K8 against their plain versions on R rays of S random
        samples (pre-embedded rows, points at the scale of a scene)."""
        sp, cd = pf.spec, kf._DTYPES[dt]
        emb = torch.randn((R * S, sp.emb_xyz), device=dev, generator=gen)
        embd = torch.randn((R * S, sp.emb_dir), device=dev, generator=gen)
        z = torch.sort(torch.rand((R, S), device=dev, generator=gen) * 4,
                       1).values
        pts = torch.randn((R * S, 3), device=dev, generator=gen) * 1.5
        dirs = torch.nn.functional.normalize(
            torch.randn((R * S, 3), device=dev, generator=gen), dim=-1)
        g = torch.randn((R, sp.rgbfeat + 2), device=dev, generator=gen)
        for (kfwd, kbwd), x, xd, fns in (
                (("K3 render_fwd_pre", "K4 render_bwd_pre"), emb.to(cd),
                 embd.to(cd), (kr.render_fwd_pre, kr.render_fwd_pre_plain,
                               kr.render_bwd_pre, kr.render_bwd_pre_plain)),
                (("K7 render_fwd", "K8 render_bwd"), pts, dirs,
                 (kr.render_fwd, kr.render_fwd_plain, kr.render_bwd,
                  kr.render_bwd_plain))):
            fwd, fwd_plain, bwd, bwd_plain = fns
            compare(kfwd, mode, dt, (fwd(pf, x, xd, z),),
                    (fwd_plain(pf, x, xd, z),))
            compare(kbwd, mode, dt, bwd(pf, x, xd, z, g),
                    bwd_plain(pf, x, xd, z, g))

    def check_render_small(dt):
        """K3/K4/K7/K8 at other dims (depth 4, skip at 2, 16 features; the
        card test's model) on 64 rays x 128 samples of random inputs."""
        cfg = ModelConfig(depth=4, width=128, feature_dim=16, skips=(2,),
                          dtype=kf._DTYPES[dt])
        small = NeFeSModel(cfg, device=dev,
                           generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            pf = small.pack_fused()[1]
        render_cases("D4/F16 R=64", dt, pf, 64, N_C + N_F,
                     torch.Generator(device=dev).manual_seed(5))

    def check_render_wide(dt):
        """K3/K4/K7/K8 at full width on WIDE_R rays of each WIDE_S samples
        a ray: the forward's transmittance carried over block tiles, the
        backward's per-sample state in its global scratch."""
        pf = state["inputs"][dt]["packed"][1]
        gen = torch.Generator(device=dev).manual_seed(6)
        for S in WIDE_S:
            render_cases(f"S={S} R={WIDE_R}", dt, pf, WIDE_R, S, gen)
            torch.cuda.empty_cache()

    def check_training(dt, m):
        """The training variants at the training shapes: K1/K5 transient
        forward (fine pass), K2/K6 with dW in sigma and full mode (coarse
        pass) and transient mode (fine pass), and frozen in transient
        mode."""
        with torch.no_grad():
            tr = train_path_inputs(m, dev)
        state.setdefault("train_inputs", {})[dt] = tr
        gen = torch.Generator(device=dev).manual_seed(2)
        cd = kf._DTYPES[dt]
        pc, pf = tr["packed"]
        F = pf.spec.feature_dim
        n_c, n_f = tr["pts_c"].shape[0], tr["pts"].shape[0]
        log(f"training shapes: coarse {n_c} samples, fine {n_f}")

        def cots(n, hd):
            return [torch.randn(s, device=dev, generator=gen).to(hd)
                    for s in ((n,), (n, 3), (n, F), (n, 5))]
        g_c_pre, g_f_pre = cots(n_c, cd), cots(n_f, cd)
        g_c_raw, g_f_raw = cots(n_c, torch.float32), cots(n_f, torch.float32)
        tr.update(g_f_pre=g_f_pre, g_f_raw=g_f_raw, g_c_raw=g_c_raw)
        S, Fm, T = kf.SIGMA, kf.FULL, kf.TRANSIENT
        # the forward's heads, the transient ones each on its own
        fwd_names = ["sigma", "rgb", "feat", "transient_sigma",
                     "transient_rgb", "transient_beta"]
        bwd_names = ["d_x", "d_dirs", "dW", "db"]

        def with_dw(p, out):
            """(d_x, d_dirs, dW matrices, db biases): the gradient blob
            split into the matrices' and the biases' parts."""
            d_x, d_dirs, dw = out
            nw = p.w.numel()
            return d_x, d_dirs, dw[:nw], dw[nw:]

        def split(out):
            s_, r_, f_, t_ = out
            return s_, r_, f_, t_[:, 0], t_[:, 1:4], t_[:, 4]

        rt = n_f - RAGGED   # not a multiple of the 128-sample block tile
        cases = []
        for name, kern, plain, xs in (
                ("K1 field_fwd_pre transient", kf.field_fwd_pre,
                 kf.field_fwd_pre_plain, (tr["emb"], tr["embd"])),
                ("K5 field_fwd transient", kf.field_fwd, kf.field_fwd_plain,
                 (tr["pts"], tr["dirs"]))):
            for mode, n in (("transient", n_f), (f"transient N={rt}", rt)):
                cases.append((
                    name, mode, kern, plain, fwd_names,
                    lambda f, x=xs[0][:n], d=xs[1][:n]: split(f(pf, T, x,
                                                                d))))
        for name, kern, plain, xs, gs in (
                ("K2 field_bwd_pre +dW", kf.field_bwd_pre,
                 kf.field_bwd_pre_plain, ("emb_c", "embd_c", "emb", "embd"),
                 (g_c_pre, g_f_pre)),
                ("K6 field_bwd +dW", kf.field_bwd, kf.field_bwd_plain,
                 ("pts_c", "dirs_c", "pts", "dirs"), (g_c_raw, g_f_raw))):
            for mode, p, x, d, g in (
                    (S, pc, tr[xs[0]], None, gs[0][:1] + [None] * 3),
                    (Fm, pc, tr[xs[0]], tr[xs[1]], gs[0][:3] + [None]),
                    (T, pf, tr[xs[2]], tr[xs[3]], gs[1])):
                cases.append((
                    name, ("sigma", "full", "transient")[mode], kern, plain,
                    bwd_names,
                    lambda f, p=p, mode=mode, x=x, d=d, g=g: with_dw(
                        p, f(p, mode, x, d, *g, need_dw=True))))
            # the frozen backward in transient mode, its own kernel
            cases.append((
                name.replace(" +dW", ""), "transient", kern, plain,
                bwd_names[:2],
                lambda f, x=tr[xs[2]], d=tr[xs[3]], g=gs[1]: f(pf, T, x, d,
                                                              *g)[:2]))
        with torch.no_grad():
            for name, mode, kern, plain, names, case in cases:
                got = case(kern)
                torch.cuda.synchronize()
                want = case(plain)
                compare(name, mode, dt, got, want, names)
                del got, want
            # the forward: two calls, and the persistent grid against one
            # block per block tile, give the same bits
            this = build.library("fused_field")
            for name, kern, x, d in (
                    ("K1 field_fwd_pre transient", kf.field_fwd_pre,
                     tr["emb"], tr["embd"]),
                    ("K5 field_fwd transient", kf.field_fwd, tr["pts"],
                     tr["dirs"])):
                a, b = kern(pf, T, x, d), kern(pf, T, x, d)
                if not all(torch.equal(u, v) for u, v in zip(a, b)):
                    raise AssertionError(f"{name} {dt}: two calls differ")
                tile = field_call(this, name, tr, dev, 0)
                if not all(torch.equal(u, v) for u, v in zip(a, tile)):
                    raise AssertionError(f"{name} {dt}: one block per block "
                                         f"tile differs from the grid")
                grid = kf.fwd_blocks(this, pf, T, kern is kf.field_fwd, n_f,
                                     dev)
                log(f"{name} {dt}: two calls, and the grid of {grid} blocks "
                    f"against one block per block tile, bit for bit the "
                    f"same")
                del a, b, tile
            # the warp path of K2/K6, sigma and full mode at the coarse
            # training shape and transient mode at the fine one: two
            # calls (fixed summation orders), and the persistent grid
            # against one block per block tile, bit for bit; with dW also
            # over chunks of 64 x 1,001 rows, which end mid block tile,
            # against the plain version
            for name, raw, xs, gs in (("K2 field_bwd_pre", False,
                                       ("emb_c", "embd_c", "emb", "embd"),
                                       (g_c_pre, g_f_pre)),
                                      ("K6 field_bwd", True,
                                       ("pts_c", "dirs_c", "pts", "dirs"),
                                       (g_c_raw, g_f_raw))):
                kern = kf.field_bwd if raw else kf.field_bwd_pre
                for mode in (S, Fm, T):
                    p = pf if mode == T else pc
                    x = tr[xs[2 if mode == T else 0]]
                    d = (None if mode == S
                         else tr[xs[3 if mode == T else 1]])
                    g = (gs[1] if mode == T else gs[0][:1] + [None] * 3
                         if mode == S else gs[0][:3] + [None])
                    for need_dw in (False, True):
                        a = kern(p, mode, x, d, *g, need_dw=need_dw)
                        b = kern(p, mode, x, d, *g, need_dw=need_dw)
                        tile = field_bwd_call(this, raw, mode, p, x, d, g,
                                              need_dw, dev, blocks=0)
                        what = f"{name}{' +dW' if need_dw else ''}"
                        for u, v, w_ in zip(a, b, tile):
                            if u is None:
                                continue
                            if not torch.equal(u, v):
                                raise AssertionError(f"{what} {MODES[mode]} "
                                                     f"{dt}: two calls "
                                                     f"differ")
                            if not torch.equal(u, w_):
                                raise AssertionError(
                                    f"{what} {MODES[mode]} {dt}: one block "
                                    f"per block tile differs from the grid")
                        log(f"{what} {MODES[mode]} {dt}: two calls, and the "
                            f"grid against one block per block tile, bit "
                            f"for bit the same")
                        del a, b, tile
                    chunk = kf.TILE_ROWS * 1001
                    got = field_bwd_call(this, raw, mode, p, x, d, g, True,
                                         dev, chunk=chunk)
                    plain = kf.field_bwd_plain if raw else \
                        kf.field_bwd_pre_plain
                    want = plain(p, mode, x, d, *(g if mode == T else g[:3]),
                                 need_dw=True)
                    compare(f"{name} +dW", f"{MODES[mode]} in chunks of "
                            f"{chunk} rows", dt, with_dw(p, got),
                            with_dw(p, want), bwd_names)
                    del got, want
            # the dW kernel alone on the first chunk of each training pass
            for label, p, mode, x, d, g in (
                    ("fine transient", pf, T, tr["pts"], tr["dirs"], g_f_raw),
                    ("coarse full", pc, Fm, tr["pts_c"], tr["dirs_c"],
                     g_c_raw[:3] + [None])):
                ops, tile_b, rows, slices = first_chunk(p, mode, x, d, g)
                nw = p.w.numel()
                part = kf.field_dw(p, mode, ops, tile_b, rows, torch.zeros(
                    (slices, nw + p.b.numel()), device=dev))
                got = kf._dw_reduce(build.library("fused_field"), part)
                want = kf.field_dw_plain(p, mode, ops, tile_b, rows)
                compare("K2/K6 field_dw", f"{label}, {rows} rows, {slices} "
                        f"slices", dt, (got[:nw], got[nw:]),
                        (want[:nw], want[nw:]), ["dW", "db"])
                del ops, tile_b, part, got, want
        torch.cuda.empty_cache()

    def first_chunk(p, mode, x, d, g):
        """The dW operands of the first chunk of K6 +dW on raw inputs x, d
        with f32 cotangents g, as the wrapper's plan makes it: (ops,
        tile_b, rows, slices)."""
        lib = build.library("fused_field")
        n, sp = x.shape[0], p.spec
        chunk, slices = kf.dw_plan(
            lib, p, mode, n,
            torch.cuda.get_device_properties(dev).multi_processor_count)
        rows = min(chunk, n)
        ops = torch.empty(chunk * lib.nefes_field_dw_row_elems(
            mode, *kf.dims(sp)), dtype=sp.torch_dtype, device=dev)
        tile_b = torch.zeros((chunk // kf.TILE_ROWS, p.b.numel()),
                             device=dev)
        dx, dd = (torch.empty((n, 3), device=dev) for _ in range(2))
        err = lib.nefes_field_bwd_raw(
            kf._DTYPE_CODE[sp.torch_dtype], mode, n, x.data_ptr(), kf._ptr(d),
            p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(), *kf.dims(sp),
            *[kf._ptr(v) for v in g], dx.data_ptr(), dd.data_ptr(), 0, rows,
            p.b.numel(), ops.data_ptr(), tile_b.data_ptr(), kf._stream())
        kf.raise_on(err, "K6 field_bwd")
        return ops, tile_b, rows, slices

    phase("check", do_check)

    from nefes_tpu_torch.features import DFNet, extract_target_features
    from nefes_tpu_torch.geometry.se3 import learn_pose
    from nefes_tpu_torch.refine import (
        RefineConfig, apply_verification, graph, refine_apr_captured,
        refine_apr_single, refine_pose_captured, refine_pose_single,
        render_feature_image,
    )
    rcfg = RefineConfig(opt_iter=ITERS, lr_r=0.0087, lr_t=0.01)
    rcfg2 = RefineConfig(opt_iter=ITERS, learning_rate=1e-5)
    base = model.cfg.render_config(n_samples=N_C, n_importance=N_F,
                                   output_transient=False, test_time=True,
                                   perturb=False, remat=False)
    kernel_path = dict(fused=True, fused_need_dw=False)
    cfgs = {
        "render_pre": replace_cfg(base, fused_pre=True, fused_render=True,
                                  **kernel_path),
        "field_pre": replace_cfg(base, fused_pre=True, fused_render=False,
                                 **kernel_path),
        "render_raw": replace_cfg(base, fused_pre=False, fused_render=True,
                                  **kernel_path),
        "fused_raw": replace_cfg(base, fused_pre=False, fused_render=False,
                                 **kernel_path),
        "unfused": base,
    }
    # the kernels each path must launch (and no other)
    path_kernels = {
        "render_pre": ("K1 field_fwd_pre", "K3 render_fwd_pre",
                       "K4 render_bwd_pre"),
        "field_pre": ("K1 field_fwd_pre", "K2 field_bwd_pre"),
        "render_raw": ("K5 field_fwd", "K7 render_fwd", "K8 render_bwd"),
        "fused_raw": ("K5 field_fwd", "K6 field_bwd"),
        "unfused": (),
    }
    hist = torch.zeros(10, device=dev)
    ws_vec = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], device=dev)
    init = learn_pose(torch.tensor([0.02, -0.03, 0.01], device=dev),
                      torch.tensor([0.05, -0.04, 0.03], device=dev),
                      gt)[:3, :4]
    with torch.no_grad():
        _, target = render_feature_image(model, gt, hist, (H, W, FOCAL),
                                         NEAR, FAR, base)
    # each kernel's wrapper by its name in KERNELS (the variants below are
    # counted on the wrappers of K1, K2, K5 and K6)
    wrappers = {
        "K1 field_fwd_pre": kf.field_fwd_pre,
        "K2 field_bwd_pre": kf.field_bwd_pre,
        "K3 render_fwd_pre": kr.render_fwd_pre,
        "K4 render_bwd_pre": kr.render_bwd_pre,
        "K5 field_fwd": kf.field_fwd, "K6 field_bwd": kf.field_bwd,
        "K7 render_fwd": kr.render_fwd, "K8 render_bwd": kr.render_bwd,
        "K9 chain": km.chain, "K10 chain_interleaved": km.chain_interleaved,
        "K11 embed_micro": km.embed_micro, "K12 chain_sq": km.chain_sq,
        "K2/K6 field_dw": kf.field_dw,
    }
    all_kernels = tuple(wrappers.values())
    # graph.launch_counts()'s wrapper names -> the kernels' names
    kernel_name_of = {k.__name__: n for n, k in wrappers.items()}
    # the training variants' own counters (also counted in `launches`)
    variants = {
        "K1 field_fwd_pre transient": (kf.field_fwd_pre,
                                       "transient_launches"),
        "K2 field_bwd_pre +dW": (kf.field_bwd_pre, "dw_launches"),
        "K5 field_fwd transient": (kf.field_fwd, "transient_launches"),
        "K6 field_bwd +dW": (kf.field_bwd, "dw_launches"),
    }
    # the kernels (and variants) each training path must launch
    path_kernels.update({
        "train_raw": ("K5 field_fwd", "K6 field_bwd",
                      "K5 field_fwd transient", "K6 field_bwd +dW",
                      "K2/K6 field_dw"),
        "train_pre": ("K1 field_fwd_pre", "K2 field_bwd_pre",
                      "K1 field_fwd_pre transient", "K2 field_bwd_pre +dW",
                      "K2/K6 field_dw"),
        "train_unfused": (),
        # the probe's commands: kernelmicro; kernel and perf
        "micro": ("K9 chain", "K10 chain_interleaved", "K11 embed_micro",
                  "K12 chain_sq", "K5 field_fwd", "K1 field_fwd_pre",
                  "K2 field_bwd_pre"),
        "probe": ("K5 field_fwd", "K6 field_bwd", "K7 render_fwd",
                  "K8 render_bwd", "K1 field_fwd_pre", "K3 render_fwd_pre",
                  "K4 render_bwd_pre"),
    })

    def snapshot_counts():
        return ([k.launches for k in all_kernels],
                {n: getattr(k, a) for n, (k, a) in variants.items()})

    def restore_counts(saved):
        for k, c in zip(all_kernels, saved[0]):
            k.launches = c
        for n, (k, a) in variants.items():
            setattr(k, a, saved[1][n])

    def reset_counts():
        for k in all_kernels:
            k.launches = 0
        for k, attr in variants.values():
            setattr(k, attr, 0)

    def counted(cfg_name, fn):
        """Run fn with every launch count set to 0 just before it; returns
        (its result, seconds, the counts), and fails if the path did not
        launch exactly its own kernels and variants."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {n: k.launches for n, k in wrappers.items()}
        counts.update({n: getattr(k, attr)
                       for n, (k, attr) in variants.items()})
        ran = {n for n, c in counts.items() if c}
        if ran != set(path_kernels[cfg_name]):
            raise AssertionError(f"{cfg_name} launched {sorted(ran)}, "
                                 f"expected {path_kernels[cfg_name]}")
        return out, dt, {n: c for n, c in counts.items() if c}

    def peak_mib(held: int, what: str = "the frame") -> str:
        peak = torch.cuda.max_memory_allocated()
        return (f"{peak / 2**20:.1f} MiB, {(peak - held) / 2**20:.1f} MiB "
                f"above the {held / 2**20:.1f} MiB held before {what}")

    def refine3(cfg_name, iters):
        (refined, losses), dt, counts = counted(cfg_name, lambda: (
            refine_pose_single(model, init, target, hist, ws_vec,
                               (H, W, FOCAL), NEAR, FAR, cfgs[cfg_name],
                               replace_cfg(rcfg, opt_iter=iters))))
        return refined, losses.cpu(), dt, counts

    def mode2_inputs(dtype="float32"):
        """The DFNet (seed 1) computing in dtype (f32, or bf16: the CLI's
        --apr_compute_dtype bfloat16), aimed at the scene: fc_pose's
        weight scaled down and its bias the perturbed start pose of mode
        3, so the first render sees what mode 3's does; the query, 240x320
        noise (seed 3); its level-0 target features at full size."""
        key = f"mode2_inputs_{dtype}"
        if key not in state:
            dfnet = DFNet(output_dim=model.cfg.feature_dim,
                          dtype=kf._DTYPES[dtype], device=dev,
                          generator=torch.Generator().manual_seed(1))
            dfnet.requires_grad_(False)
            with torch.no_grad():
                dfnet.fc_pose.weight.mul_(1e-2)
                dfnet.fc_pose.bias.copy_(init.reshape(12))
                image = torch.rand((IMG_H, IMG_W, 3),
                                   generator=torch.Generator().manual_seed(3)
                                   ).to(dev)
                target2 = extract_target_features(dfnet, image[None], IMG_H,
                                                  IMG_W)[0]
            state[key] = (dfnet, image, target2)
        return state[key]

    def apr_of(kind):
        """The APR of a kind and its refinement options: DFNet (the
        feature extractor's own), or the zoo's with seeded random weights
        (seed 4) aimed as DFNet is (aim_apr), without svd_reg (the CLI's
        default), PoseNetV2 on batch BN statistics (the CLI's default),
        the rest on running ones. Without svd_reg the eager and the
        captured loop do the same arithmetic (with it the captured loop
        runs the polar iteration, the eager one the SVD): a random tower
        refined at lr 1e-5 moves the pose by ~1 in 50 iterations and
        carries a 1e-7 difference as far (PoseNet, H100: 1.19 apart)."""
        dfnet = mode2_inputs()[0]
        if kind == "DFNet":
            return dfnet, {}
        if kind == BF16_DFNET:
            # without svd_reg the eager and the captured loop do the same
            # arithmetic (with it the captured loop runs the polar
            # iteration, the eager one the SVD)
            return mode2_inputs("bfloat16")[0], dict(svd_reg=False)
        if kind not in state.setdefault("aprs", {}):
            from nefes_tpu_torch.features import load_apr
            apr, _ = load_apr(kind, None, (IMG_H, IMG_W),
                              torch.Generator().manual_seed(4), device=dev)
            aim_apr(kind, apr.requires_grad_(False), init)
            state["aprs"][kind] = apr
        return state["aprs"][kind], dict(apr_kind=kind, svd_reg=False,
                                         freeze_bn=kind != "PoseNetV2")

    def refine2(cfg_name, iters, kind="DFNet"):
        _, image, target2 = mode2_inputs(dfnet_dtype(kind))
        apr, kw = apr_of(kind)
        out, dt, counts = counted(cfg_name, lambda: refine_apr_single(
            model, apr, image, target2, hist, ws_vec, (H, W, FOCAL),
            (IMG_H, IMG_W, FOCAL_FULL), NEAR, FAR, cfgs[cfg_name],
            replace_cfg(rcfg2, opt_iter=iters), **kw))
        return out, out["losses"].cpu(), dt, counts

    def captured3(cfg_name, iters):
        """refine3 through the captured loop: (refined, losses, s)."""
        t0 = time.perf_counter()
        refined, losses = refine_pose_captured(
            model, init, target, hist, ws_vec, (H, W, FOCAL), NEAR, FAR,
            cfgs[cfg_name], replace_cfg(rcfg, opt_iter=iters))
        torch.cuda.synchronize()
        return refined, losses.cpu(), time.perf_counter() - t0

    def captured2(cfg_name, iters, kind="DFNet"):
        """refine2 through the captured loop: (out, losses, s)."""
        _, image, target2 = mode2_inputs(dfnet_dtype(kind))
        apr, kw = apr_of(kind)
        t0 = time.perf_counter()
        out = refine_apr_captured(
            model, apr, image, target2, hist, ws_vec, (H, W, FOCAL),
            (IMG_H, IMG_W, FOCAL_FULL), NEAR, FAR, cfgs[cfg_name],
            replace_cfg(rcfg2, opt_iter=iters), **kw)
        torch.cuda.synchronize()
        return out, out["losses"].cpu(), time.perf_counter() - t0

    def loop_of(name, cfg_name, iters, kind="DFNet"):
        """The cached captured loop of a mode, path, iteration count and
        (mode 2) APR kind."""
        want = replace_cfg(rcfg if name == "mode3" else rcfg2,
                           opt_iter=iters)
        apr = apr_of(kind)[0] if name == "mode2" else None
        hits = [lp for lp in graph.loops() if lp.name == name
                and lp.cfg == cfgs[cfg_name] and lp.rcfg == want
                and getattr(lp, "apr_kind", "DFNet") == (
                    "DFNet" if kind == BF16_DFNET else kind)
                and (apr is None or lp.dfnet is apr)]
        return hits[0]

    def captured_turns(name, cfg_name, eager, captured, pose_key=None,
                       apr_kind="DFNet", pose_tol=CAPTURED_POSE_TOL):
        """The eager and the captured loop at ITERS iterations, in turns
        (eager, captured, captured, eager) after a first captured frame
        that captures. Checks the captured losses against the eager ones
        (PATHS_RTOL of the first loss) and the poses (pose_tol max abs),
        that the captured frames called no kernel wrapper, and that one
        captured iteration launches the path's kernels once each; prints
        how far the two eager runs and the two captured runs are apart.
        Returns (eager runs, captured runs)."""
        captured(cfg_name, ITERS)                   # warm-up + capture
        runs = {"eager": [], "captured": []}
        peaks = {}
        for kind in ("eager", "captured", "captured", "eager"):
            torch.cuda.reset_peak_memory_stats()
            if kind == "eager":
                out, losses, dt, _ = eager(cfg_name, ITERS)
            else:
                reset_counts()
                out, losses, dt = captured(cfg_name, ITERS)
                called = {n: k.launches for n, k in wrappers.items()
                          if k.launches}
                if called:
                    raise AssertionError(f"captured {name} frame called "
                                         f"the wrappers: {called}")
            runs[kind].append((out, losses, dt))
            peaks[kind] = torch.cuda.max_memory_allocated() / 2**20
        loop = loop_of(name, cfg_name, ITERS, apr_kind)
        per_iter = {kernel_name_of[k]: c
                    for k, c in loop.graph.launches.items()}
        if per_iter != {k: 1 for k in path_kernels[cfg_name]}:
            raise AssertionError(f"captured {name} iteration launches "
                                 f"{per_iter}")
        (oe, le, _), (oc, lc, _) = runs["eager"][0], runs["captured"][0]
        pe = oe if pose_key is None else oe[pose_key]
        pc = oc if pose_key is None else oc[pose_key]
        tol = PATHS_RTOL * float(le[0])
        dl = (lc - le).abs().max().item()
        dp = (pc - pe).abs().max().item()
        for kind in ("eager", "captured"):
            (o1, l1, _), (o2, l2, _) = runs[kind]
            p1 = o1 if pose_key is None else o1[pose_key]
            p2 = o2 if pose_key is None else o2[pose_key]
            log(f"  {kind} against {kind}: max |loss diff| "
                f"{(l1 - l2).abs().max().item():.3e}, max |pose diff| "
                f"{(p1 - p2).abs().max().item():.3e}")
        te = [r[2] for r in runs["eager"]]
        tc = [r[2] for r in runs["captured"]]
        log(f"{name} {cfg_name} in turns (eager, captured, captured, "
            f"eager): eager {te[0]:.4f} / {te[1]:.4f} s/frame, captured "
            f"{tc[0]:.4f} / {tc[1]:.4f} s/frame; captured / eager = "
            f"{sum(tc) / sum(te):.4f}")
        log(f"  peak memory of a frame: eager {peaks['eager']:.1f} MiB, "
            f"captured {peaks['captured']:.1f} MiB (the graphs' pools and "
            f"everything held included)")
        log(f"  a captured frame launches {ITERS} x {per_iter} "
            f"(CapturedIteration.launches, the wrappers' counts while "
            f"capturing, times {ITERS} replays; the wrappers' counters read "
            f"0 over the captured frames)")
        if pose_key == "refined_pose":
            log(f"  the APR moved the pose by "
                f"{(oe['refined_pose'] - oe['initial_pose']).abs().max():.3e}"
                f" (max abs, eager), the loss from {le[0]:.6f} to "
                f"{le[-1]:.6f}")
        log(f"  captured vs eager: max |loss diff| {dl:.3e} (tolerance "
            f"{tol:.3e} = {PATHS_RTOL:g} x first loss), max |pose diff| "
            f"{dp:.3e} (tolerance {pose_tol:g})"
            + ("; bit for bit the same" if dl == 0 and dp == 0 else ""))
        if not (dl <= tol and dp <= pose_tol):
            raise AssertionError(f"captured {name} disagrees with eager")
        return runs["eager"], runs["captured"]

    def do_mode3():
        refine3("render_pre", 2)                    # warm: build, caches
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        refined, losses, dt, counts = refine3("render_pre", ITERS)
        peak = peak_mib(held)
        log(f"mode3 render_pre: {dt:.3f} s/frame ({ITERS} iters, "
            f"{H}x{W} rays, {N_C}+{N_F} samples, bf16)")
        log(f"  loss first {losses[0]:.6f} last {losses[-1]:.6f}")
        log(f"  launches {counts}")
        log(f"  peak memory {peak}")
        log(f"  refined pose {refined.cpu().numpy().round(5).tolist()}")
        if not (torch.isfinite(losses).all() and refined.shape == (3, 4)
                and torch.isfinite(refined).all()):
            raise AssertionError("non-finite mode-3 result")
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not fall")
        for name in path_kernels["render_pre"]:
            kernels[name]["launches"] = counts[name]
            kernels[name]["path"] = "mode3 render_pre"
        captured_turns("mode3", "render_pre",
                       lambda c, i: refine3(c, i), captured3)

    phase("mode3", do_mode3)

    def do_mode2():
        refine2("render_raw", ITERS)                # warm-up frame
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out, losses, dt, counts = refine2("render_raw", ITERS)
        peak = peak_mib(held)
        final = apply_verification(out, "psnr_ssim")
        retreat = bool(out["end_psnr"] < out["init_psnr"]
                       or out["end_ssim"] < out["init_ssim"])
        moved = (out["refined_pose"] - out["initial_pose"]).abs().max()
        log(f"mode2 render_raw: {dt:.3f} s/frame ({ITERS} iters, DFNet f32 "
            f"on {IMG_H}x{IMG_W}, {H}x{W} rays, {N_C}+{N_F} samples, "
            f"NeFeS bf16)")
        log(f"  loss first {losses[0]:.6f} last {losses[-1]:.6f}")
        log(f"  psnr init {out['init_psnr']:.4f} end {out['end_psnr']:.4f}; "
            f"ssim init {out['init_ssim']:.6f} end {out['end_ssim']:.6f}")
        log(f"  verification psnr_ssim: "
            f"{'retreat to the initial pose' if retreat else 'keep the refined pose'}"
            f"; the APR moved the pose by {moved:.3e} (max abs)")
        log(f"  launches {counts}")
        log(f"  peak memory {peak}")
        if not (torch.isfinite(losses).all()
                and torch.isfinite(out["refined_pose"]).all()
                and torch.isfinite(final).all()):
            raise AssertionError("non-finite mode-2 result")
        if not torch.equal(final, out["initial_pose"] if retreat
                           else out["refined_pose"]):
            raise AssertionError("apply_verification chose the wrong pose")
        for name in path_kernels["render_raw"]:
            if counts[name] != ITERS:
                raise AssertionError(f"{name}: {counts[name]} launches in "
                                     f"{ITERS} iterations")
            kernels[name]["launches"] = counts[name]
            kernels[name]["path"] = "mode2 render_raw"
        _, losses_p, dt_p, counts_p = refine2("render_pre", ITERS)
        log(f"mode2 render_pre: {dt_p:.3f} s/frame, launches {counts_p}; "
            f"render_raw / render_pre = {dt / dt_p:.3f}")
        runs32 = captured_turns("mode2", "render_raw", refine2, captured2,
                                "refined_pose")
        same_verification(*runs32)
        bf16_dfnet_turns(runs32)

    def bf16_dfnet_turns(runs32):
        """Mode 2 with the bf16 DFNet (APR and feature extractor, the
        CLI's --apr_compute_dtype bfloat16), without svd_reg, on cuDNN's
        deterministic algorithms: the eager and the captured loop in
        turns, bit for bit the same; s/frame beside the f32 DFNet's."""
        torch.backends.cudnn.deterministic = True
        try:
            refine2("render_raw", 2, BF16_DFNET)     # warm: cuDNN's set-up
            eager, captured = captured_turns(
                "mode2", "render_raw", lambda c, i: refine2(c, i, BF16_DFNET),
                lambda c, i: captured2(c, i, BF16_DFNET), "refined_pose",
                BF16_DFNET)
        finally:
            torch.backends.cudnn.deterministic = False
        for (oe, le, _), (oc, lc, _) in zip(eager, captured):
            if not (torch.isfinite(le).all() and torch.equal(le, lc)
                    and torch.equal(oe["refined_pose"], oc["refined_pose"])):
                raise AssertionError("bf16 DFNet: the captured loop is not "
                                     "the eager one bit for bit")
        same_verification(eager, captured)
        mean = statistics.mean
        t = {f"{dt} {kind}": mean(r[2] for r in runs[kind])
             for dt, runs in (("f32", dict(zip(("eager", "captured"),
                                               runs32))),
                              ("bf16", dict(eager=eager, captured=captured)))
             for kind in ("eager", "captured")}
        log(f"mode2 DFNet bf16 against f32 (svd_reg off in bf16, on in "
            f"f32): " + ", ".join(f"{k} {v:.4f} s/frame" for k, v in
                                  t.items())
            + f"; bf16 / f32 captured = "
            f"{t['bf16 captured'] / t['f32 captured']:.4f}; final loss "
            f"bf16 {eager[0][1][-1]:.6f}, f32 {runs32[0][0][1][-1]:.6f}")

    def same_verification(eager, captured):
        """The verification (psnr_ssim) makes the same choice in every
        eager and captured turn, and apply_verification takes it."""
        for (oe, _, _), (oc, _, _) in zip(eager, captured):
            choice = [bool(o["end_psnr"] < o["init_psnr"]
                           or o["end_ssim"] < o["init_ssim"])
                      for o in (oe, oc)]
            if choice[0] != choice[1]:
                raise AssertionError(f"verification: eager retreats "
                                     f"{choice[0]}, captured {choice[1]}")
            if not torch.equal(apply_verification(oc), oc["initial_pose"]
                               if choice[1] else oc["refined_pose"]):
                raise AssertionError("captured verification chose wrong")
        log(f"  verification psnr_ssim: the same choice in every turn "
            f"({'retreat' if choice[0] else 'keep the refined pose'})")

    phase("mode2", do_mode2)

    def apr_family(kind, image, queries):
        """One APR of the zoo: the eager and the captured loop in turns,
        the APR's forward and backward alone (eager and captured), mode
        3's batched initial poses against one image at a time."""
        from nefes_tpu_torch.refine import apr_pose_any, apr_poses_batched
        apr, kw = apr_of(kind)
        log(f"apr {kind}: {sum(p.numel() for p in apr.parameters()):,} "
            f"weights, BN on "
            f"{'running' if kw['freeze_bn'] else 'batch'} statistics")
        graph.clear()
        torch.cuda.empty_cache()
        refine2("render_raw", 2, kind)          # warm: cuDNN's set-up
        eager, captured = captured_turns(
            "mode2", "render_raw", lambda c, i: refine2(c, i, kind),
            lambda c, i: captured2(c, i, kind), "refined_pose", kind,
            APR_POSE_TOL)
        for out, losses, _ in eager + captured:
            if not (torch.isfinite(losses).all()
                    and torch.isfinite(out["refined_pose"]).all()):
                raise AssertionError(f"{kind}: non-finite result")
        same_verification(eager, captured)
        # the APR's own forward and backward in an iteration
        apr_copy = copy.deepcopy(apr).requires_grad_(True)
        params = list(apr_copy.parameters())
        cot = torch.randn((3, 4), generator=torch.Generator().manual_seed(
            6)).to(dev)

        def fwd_bwd():
            pose = apr_pose_any(kind, apr_copy, image, False,
                                kw["freeze_bn"])
            torch.autograd.grad((pose * cot).sum(), params,
                                allow_unused=True)
        ms = time_ms(fwd_bwd)
        # the same captured as a CUDA graph: the device's share alone
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fwd_bwd()
        torch.cuda.current_stream().wait_stream(side)
        fb_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(fb_graph):
            fwd_bwd()
        ms_graph = time_ms(fb_graph.replay)
        log(f"  the APR's forward + backward ({IMG_H}x{IMG_W} query, CUDA "
            f"events, median of 5): eager {ms:.3f} ms, captured "
            f"{ms_graph:.3f} ms an iteration; x {ITERS} = "
            f"{ms * ITERS / 1e3:.3f} / {ms_graph * ITERS / 1e3:.3f} s a "
            f"frame")
        del apr_copy, params, fb_graph
        # mode 3's initial poses: a batch of 8 against one at a time
        with torch.no_grad():
            batched = apr_poses_batched(kind, apr, queries)
            single = torch.cat([apr_poses_batched(kind, apr, q[None])
                                for q in queries])
        diff = (batched - single).abs().max().item()
        log(f"  apr_poses_batched on 8 queries against one at a time: max "
            f"|diff| {diff:.3e} (tolerance 1e-5)")
        if not (torch.isfinite(batched).all() and diff <= 1e-5):
            raise AssertionError(f"{kind}: batched initial poses")

    def do_apr():
        """Mode 2 with each APR of the zoo at full width through the raw
        kernels (K5, K7, K8), on cuDNN's deterministic algorithms: with
        its default ones two eager PoseNet frames ended 1.02 apart (H100),
        and the turns would test cuDNN's summation order, not the
        captured loop."""
        _, image, _ = mode2_inputs()
        queries = torch.rand((8, IMG_H, IMG_W, 3),
                             generator=torch.Generator().manual_seed(5)
                             ).to(dev)
        torch.backends.cudnn.deterministic = True
        try:
            for kind in ZOO:
                apr_family(kind, image, queries)
        finally:
            torch.backends.cudnn.deterministic = False
            graph.clear()
            state.pop("aprs", None)
            torch.cuda.empty_cache()

    phase("apr", do_apr)

    def do_paths():
        n_it = 5
        modes = (("mode3", ("render_pre", "field_pre", "unfused",
                            "render_raw", "fused_raw"), refine3),
                 ("mode2", ("render_raw", "fused_raw", "render_pre",
                            "unfused"), refine2))
        for mode, names, run in modes:
            runs = {}
            for name in names:
                _, losses, dt, counts = run(name, n_it)
                runs[name] = losses
                per_frame = {k: c * ITERS // n_it for k, c in counts.items()}
                log(f"{mode} {name}: {n_it} iters in {dt:.3f} s, losses "
                    f"{[round(float(x), 6) for x in losses]}, launches "
                    f"{counts} ({per_frame} per {ITERS}-iteration frame)")
                for k in ("K2 field_bwd_pre", "K6 field_bwd"):
                    if k in counts and "launches" not in kernels[k]:
                        kernels[k]["launches"] = counts[k]
                        kernels[k]["path"] = f"{mode} {name}"
            # Mode 3's paths agreed to 3.5e-6 on an H100 with losses from
            # 5.5e-3 (PERF.md); the limit is 2e-3 of the first loss, ~3x
            # that.
            tol = PATHS_RTOL * float(runs[names[0]][0])
            for name in names[1:]:
                diff = (runs[name] - runs[names[0]]).abs().max().item()
                log(f"{mode}: max |loss({name}) - loss({names[0]})| = "
                    f"{diff:.3e} (tolerance {tol:.3e} = {PATHS_RTOL:g} x "
                    f"first loss)")
                if not diff <= tol:
                    raise AssertionError(f"{mode} {name} losses disagree")

    phase("paths", do_paths)

    def do_serve():
        """The refinement CLI on an 8-frame 7-Scenes fixture at its real
        layout and size, in mode 3 and mode 2 at the defaults, each frame
        served by the captured loop; then the evaluate CLI on its pose
        txt."""
        import importlib.util
        from nefes_tpu_torch.cli import evaluate as ev
        from nefes_tpu_torch.cli import refine as cli
        from nefes_tpu_torch.data import load_7scenes_colmap
        from nefes_tpu_torch.evaluation import save_pose_txt
        log("image readers on this machine: "
            + ", ".join(f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
                        for m in ("PIL", "cv2")))
        root = Path("tmp") / "serve_fixture"
        paths = write_7scenes_fixture(root, SERVE_FRAMES)
        test = load_7scenes_colmap("chess", str(root / "deepslam"),
                                   str(root / "data"), train=False)
        gt_txt = root / "gt.txt"
        save_pose_txt(gt_txt, test.poses)
        # what DFNet's batches of 8 (the CLI's chunks) take on their own
        with torch.no_grad():
            dfnet = DFNet(output_dim=model.cfg.feature_dim, device=dev,
                          generator=torch.Generator().manual_seed(1))
            imgs = torch.from_numpy(test.images[:8]).to(dev)
            for what, fn in (
                    ("target features at 240x320", lambda: (
                        extract_target_features(dfnet, imgs, test.H,
                                                test.W))),
                    ("poses", lambda: dfnet(imgs, return_feature=False))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                fn()
                peak = peak_mib(held, "the batch")
                log(f"  DFNet's {what} of 8 frames: peak {peak}")
            del dfnet, imgs
        torch.cuda.empty_cache()
        bf16 = ["--apr_compute_dtype", "bfloat16"]
        for mode, path_name, kind, extra in (
                (3, "render_pre", "DFNet", []),
                (2, "render_raw", "DFNet", []),
                (2, "render_raw", "DFNet", bf16),
                (2, "render_raw", "MsTransformer", []),
                (3, "render_pre", "PoseNet", [])):
            tag = f"{kind}{'_bf16' if extra else ''}"
            out_dir = root / f"out_mode{mode}_{tag}"
            argv = ["--datadir", paths["datadir"],
                    "--data_root", paths["data_root"],
                    "--pose_only", str(mode), "--save_dir", str(out_dir),
                    "--PoseEstimatorType", kind] + extra
            graph.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            called = {n: k.launches for n, k in wrappers.items()
                      if k.launches}
            (loop,) = graph.loops()
            per_iter = {kernel_name_of[k]: c
                        for k, c in loop.graph.launches.items()}
            replayed = {k: c * loop.graph.replays
                        for k, c in per_iter.items()}
            log(f"serve mode {mode} {tag}: {wall:.3f} s for {SERVE_FRAMES} "
                f"frames "
                f"of main() ({wall / SERVE_FRAMES:.4f} s/frame, set-up and "
                f"the first frame's capture included; the CLI's own "
                f"s/frame line above counts from the models being ready)")
            log(f"  summary {json.dumps(summary)}")
            log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
                f" MiB (the graph's pool included)")
            log(f"  kernels: wrapper calls (the warm-up and the capture) "
                f"{called}; captured launches {per_iter} an iteration x "
                f"{loop.graph.replays} replays = {replayed}")
            if per_iter != {k: 1 for k in path_kernels[path_name]}:
                raise AssertionError(f"serve mode {mode} {kind} launched "
                                     f"{per_iter}")
            if loop.graph.replays != SERVE_FRAMES * ITERS:
                raise AssertionError(f"{loop.graph.replays} replays")
            txt = out_dir / (f"{kind}_chess_NeFeS{ITERS}_APR_pose_results"
                             ".txt")
            poses = np.loadtxt(txt)
            if not (poses.shape == (SERVE_FRAMES, 12)
                    and np.isfinite(poses).all()):
                raise AssertionError(f"pose txt {poses.shape}, finite "
                                     f"{np.isfinite(poses).all()}")
            scored = ev.main(["--pred", str(txt), "--gt", str(gt_txt)])
            for key in ("median_t_m", "median_r_deg"):
                if scored[key] != summary[key]:
                    raise AssertionError(f"evaluate's {key} {scored[key]} "
                                         f"!= the CLI's {summary[key]}")
            log(f"  {txt}: {SERVE_FRAMES} x 12 finite; evaluate reads the "
                f"same medians")
        graph.clear()
        torch.cuda.empty_cache()

    phase("serve", do_serve)

    def do_golden():
        """The probe's golden command on a reference-layout .tar and .pt
        written here and an 8-frame 7-Scenes fixture: PASS at loose
        tolerances, a non-zero exit at -1."""
        from nefes_tpu_torch.data import load_7scenes_colmap
        from nefes_tpu_torch.evaluation import save_pose_txt
        root = Path("tmp") / "golden_fixture"
        paths = write_7scenes_fixture(root, SERVE_FRAMES)
        tar, apr = root / "nefes_600.tar", root / "dfnet_chess.pt"
        write_reference_tar(tar, np.random.default_rng(0))
        write_reference_dfnet(apr, model.cfg.feature_dim)
        # the paper_result tree: the "paper" refined poses are the ground
        # truth (medians 0), the APR's 5 cm off in each axis
        test = load_7scenes_colmap("chess", str(root / "deepslam"),
                                   str(root / "data"), train=False)
        scene = root / "ref" / "paper_result" / \
            "DFNet_NeFeS50_7Scenes_colmap" / "chess"
        scene.mkdir(parents=True, exist_ok=True)
        save_pose_txt(scene / "chess_test_gt.txt", test.poses)
        save_pose_txt(scene / "DFNet_chess_NeFeS50_APR_pose_results.txt",
                      test.poses)
        off = np.array(test.poses, copy=True)
        off[:, :3, 3] += 0.05
        save_pose_txt(scene / "DFNet_chess_results.txt", off)
        out = root / "GOLDEN_torch.json"
        argv = ["golden", "--device", "cuda", "--tar", str(tar), "--apr",
                str(apr), "--scene", "chess", "--datadir", paths["datadir"],
                "--data_root", paths["data_root"], "--ref",
                str(root / "ref"), "--out", str(out)]
        for tol, want in (("1e9", True), ("-1", False)):
            graph.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            code = 0
            try:
                probe.main(argv + ["--tol_t", tol, "--tol_r", tol])
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            verdict = json.loads(out.read_text())
            (loop,) = graph.loops()
            per_iter = {kernel_name_of[k]: c
                        for k, c in loop.graph.launches.items()}
            called = {n: k.launches for n, k in wrappers.items()
                      if k.launches}
            log(f"golden at tolerance {tol}: exit {code!r}, pass "
                f"{verdict['pass']}, {wall:.3f} s for {SERVE_FRAMES} frames "
                f"({wall / SERVE_FRAMES:.4f} s/frame with the conversion, "
                f"the scene's loading and the first frame's capture); "
                f"verdict {json.dumps(verdict)}")
            log(f"  kernels: wrapper calls (the warm-up and the capture) "
                f"{called}; captured launches {per_iter} an iteration x "
                f"{loop.graph.replays} replays")
            if verdict["pass"] is not want or (code not in (0, None)) is want:
                raise AssertionError(f"golden at tolerance {tol}: exit "
                                     f"{code!r}, pass {verdict['pass']}")
            if per_iter != {k: 1 for k in path_kernels["render_raw"]} or \
                    loop.graph.replays != SERVE_FRAMES * ITERS:
                raise AssertionError(f"golden launched {per_iter} x "
                                     f"{loop.graph.replays}")
            if not all(np.isfinite(v) for v in verdict.values()
                       if isinstance(v, float)):
                raise AssertionError(f"golden: non-finite {verdict}")
        graph.clear()
        torch.cuda.empty_cache()

    phase("golden", do_golden)


    def train_run(path, st, batch, steps, gen, stage=1, lr=TRAIN_LR,
                  scene=None):
        """`steps` steps of `path` on the train state st; (losses, seconds,
        launch counts). stage 2 runs the patch step."""
        from nefes_tpu_torch.train import train_step_patch, train_step_rays
        cfg = train_render_cfg(st.model, path)
        hwf, near, far = scene or ((H, W, FOCAL), NEAR, FAR)

        def steps_():
            losses = []
            for i in range(steps):
                lr_i = lr(i) if callable(lr) else lr
                if stage == 2:
                    _, loss, _ = train_step_patch(st, cfg, batch, gen, lr_i,
                                                  hwf, near, far)
                else:
                    _, loss, _ = train_step_rays(st, cfg, batch, gen, lr_i,
                                                 hwf, near, far,
                                                 n_rand=N_RAND, stage=stage)
                losses.append(loss)
            return torch.stack(losses).float().cpu()
        return counted(path, steps_)

    def flat_params(model):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in model.parameters()])

    def do_train():
        from nefes_tpu_torch.train import create_train_state, lr_for_epoch
        F = ModelConfig().feature_dim
        batch = make_train_batch(F, dev)
        rays = TRAIN_B * N_RAND
        # the main path: K5 and K6 with dW, bf16
        st = create_train_state(make_train_model("bfloat16", dev))
        gen = torch.Generator(device=dev).manual_seed(7)
        train_run("train_raw", st, batch, 2, gen)          # warm-up
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        losses, secs, counts = train_run("train_raw", st, batch, TRAIN_STEPS,
                                         gen)
        peak = peak_mib(held, "the steps")
        step_s = secs / TRAIN_STEPS
        log(f"train train_raw: {step_s:.4f} s/step, {rays / step_s:.1f} "
            f"rays/s ({TRAIN_STEPS} steps of {TRAIN_B}x{N_RAND} rays, "
            f"{N_C}+{N_F} samples, stage 1, transient heads, NeFeS bf16)")
        log(f"  losses {[round(float(x), 6) for x in losses]}")
        log(f"  launches {counts}")
        log(f"  peak memory {peak}")
        if not torch.isfinite(losses).all():
            raise AssertionError("non-finite training loss")
        # the backward with dW launches once a chunk of rows, each chunk
        # followed by the dW kernel: the coarse pass (full mode) and the
        # fine pass (transient mode) by dw_plan's chunks
        with torch.no_grad():
            pc, pf = st.model.pack_fused()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lib = build.library("fused_field")
        chunks = 0
        for p, mode, n in ((pc, kf.FULL, rays * N_C),
                           (pf, kf.TRANSIENT, rays * (N_C + N_F))):
            chunk, slices = kf.dw_plan(lib, p, mode, n, sms)
            chunks += -(-n // chunk)
            log(f"  dW plan {('sigma', 'full', 'transient')[mode]} mode, {n} "
                f"rows: chunks of {chunk} rows, {slices} row slices")
        want = {"K5 field_fwd": 2, "K6 field_bwd": chunks,
                "K5 field_fwd transient": 1, "K6 field_bwd +dW": chunks,
                "K2/K6 field_dw": chunks}
        for name, per_step in want.items():
            if counts.get(name) != per_step * TRAIN_STEPS:
                raise AssertionError(f"{name}: {counts.get(name)} launches "
                                     f"in {TRAIN_STEPS} steps, expected "
                                     f"{per_step} per step")
        for name in ("K5 field_fwd transient", "K6 field_bwd +dW",
                     "K2/K6 field_dw"):
            kernels[name]["launches"] = counts[name]
            kernels[name]["path"] = "train train_raw"

        # 3 stage-2 patch steps through the kernels, continuing
        bn = st.model.fusion.bn
        before = (bn.running_mean.clone(), bn.running_var.clone())
        losses, secs, counts = train_run("train_raw", st, batch, 3, gen,
                                         stage=2)
        moved = max((bn.running_mean - before[0]).abs().max().item(),
                    (bn.running_var - before[1]).abs().max().item())
        log(f"train stage 2 (patch) train_raw: losses "
            f"{[round(float(x), 6) for x in losses]}, {secs / 3:.4f} s/step,"
            f" BN running stats moved by {moved:.3e} (max abs), launches "
            f"{counts}")
        if not (torch.isfinite(losses).all() and moved > 0):
            raise AssertionError("stage-2 step: non-finite loss or BN "
                                 "running stats unchanged")

        # the paths from one initial state and generator seed, bf16 and f32
        for dt in ("bfloat16", "float32"):
            runs = {}
            for path in ("train_raw", "train_pre", "train_unfused"):
                m = make_train_model(dt, dev)
                p0 = flat_params(m)
                st_p = create_train_state(m)
                gen_p = torch.Generator(device=dev).manual_seed(8)
                losses, secs, counts = train_run(path, st_p, batch,
                                                 PATH_STEPS, gen_p)
                runs[path] = (losses, flat_params(m))
                log(f"train {dt} {path}: {PATH_STEPS} steps in "
                    f"{secs:.3f} s, losses "
                    f"{[round(float(x), 6) for x in losses]}, launches "
                    f"{counts}")
                if dt == "bfloat16" and path == "train_pre":
                    for name in ("K1 field_fwd_pre transient",
                                 "K2 field_bwd_pre +dW"):
                        kernels[name]["launches"] = counts[name]
                        kernels[name]["path"] = "train train_pre"
                del st_p, m
            ref_l, ref_p = runs["train_raw"]
            tol = PATHS_RTOL * float(ref_l[0])
            for path in ("train_pre", "train_unfused"):
                l, prm = runs[path]
                diff = (l - ref_l).abs().max().item()
                rel = ((prm - ref_p).norm() / ref_p.norm()).item()
                rel_step = ((prm - ref_p).norm()
                            / (ref_p - p0).norm()).item()
                log(f"train {dt}: max |loss({path}) - loss(train_raw)| = "
                    f"{diff:.3e} (tolerance {tol:.3e}); parameters after "
                    f"{PATH_STEPS} steps: rel L2 {rel:.3e} (tolerance "
                    f"{PARAM_TOL[dt]:.0e}), {rel_step:.3e} of what the "
                    f"steps moved them")
                if not diff <= tol:
                    raise AssertionError(f"train {dt} {path}: losses "
                                         f"disagree")
                if not rel <= PARAM_TOL[dt]:
                    raise AssertionError(f"train {dt} {path}: parameters "
                                         f"disagree")
            torch.cuda.empty_cache()

        # the loss falls on the synthetic blob scene (stage 0, the JAX
        # package's tests/test_training_e2e.py recipe at full width)
        from nefes_tpu_torch.data.synthetic import make_synthetic_scene
        scene = make_synthetic_scene(n_views=8, H=H, W=W, focal=FOCAL,
                                     device=dev)
        sb = {"rgb": torch.from_numpy(scene.images[:TRAIN_B]).to(dev),
              "poses": torch.from_numpy(scene.poses[:TRAIN_B]).to(dev),
              "hists": torch.from_numpy(scene.hists[:TRAIN_B]).to(dev)}
        st_s = create_train_state(make_train_model("bfloat16", dev))
        losses, secs, _ = train_run(
            "train_raw", st_s, sb, 30, torch.Generator(device=dev)
            .manual_seed(9), stage=0, lr=lambda i: lr_for_epoch(i, 5e-3),
            scene=(scene.hwf, scene.near, scene.far))
        first, last = losses[:5].mean().item(), losses[-5:].mean().item()
        log(f"train synthetic scene, stage 0, train_raw: mean loss of the "
            f"first 5 steps {first:.6f}, of the last 5 {last:.6f}")
        if not last < 0.8 * first:
            raise AssertionError("the training loss did not fall")

    phase("train", do_train)

    def launch_counts() -> dict:
        """Every kernel's and variant's launch count now."""
        counts = {n: k.launches for n, k in wrappers.items()}
        counts.update({n: getattr(k, a) for n, (k, a) in variants.items()})
        return counts

    def cli_step_launches(pre: bool, rays: int) -> dict:
        """The launches of one f32 training step of the CLI over `rays`
        rays: the coarse (full mode) and fine (transient) forward, and
        the backward with dW once a chunk of rows (kf.dw_plan), each chunk
        followed by the dW kernel."""
        fwd, bwd = (("K1 field_fwd_pre", "K2 field_bwd_pre") if pre
                    else ("K5 field_fwd", "K6 field_bwd"))
        with torch.no_grad():
            pc, pf = NeFeSModel(ModelConfig(dtype=torch.float32), device=dev,
                                generator=torch.Generator().manual_seed(0)
                                ).pack_fused()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lib = build.library("fused_field")
        chunks = 0
        for p, mode, n in ((pc, kf.FULL, rays * N_C),
                           (pf, kf.TRANSIENT, rays * (N_C + N_F))):
            chunks += -(-n // kf.dw_plan(lib, p, mode, n, sms)[0])
        return {fwd: 2, f"{fwd} transient": 1, bwd: chunks,
                f"{bwd} +dW": chunks, "K2/K6 field_dw": chunks}

    def do_traincli():
        """The training CLI (nefes_tpu_torch.cli.train) end to end at full
        width and its defaults (NeFeS D8/W128/F128 in f32, 4 images x 1536
        rays of 60x80 renders, 64+64 samples, seeded random weights and
        DFNet) on TRAINCLI_FRAMES training frames added to the serve
        phase's fixture: seven runs, each timed (its steps, validation
        renders and wall time), its launches counted per step and its
        artefacts read back."""
        import shutil
        from dataclasses import fields
        from PIL import Image
        from nefes_tpu_torch.cli import train as tcli
        from nefes_tpu_torch.cli.options import Options
        from nefes_tpu_torch.render import validation as tval
        from nefes_tpu_torch.train.trainer import CROP_SIZE, NUM_CROPS
        from nefes_tpu_torch.utils.video import read_mp4
        root = Path("tmp") / "serve_fixture"
        paths = write_7scenes_fixture(root, SERVE_FRAMES,
                                      n_train=TRAINCLI_FRAMES)
        logs = root / "traincli"
        shutil.rmtree(logs, ignore_errors=True)
        per_epoch = TRAINCLI_FRAMES // TRAIN_B
        ray_rays, patch_rays = TRAIN_B * N_RAND, \
            TRAIN_B * NUM_CROPS * CROP_SIZE ** 2
        want_step = {(pre, kind): cli_step_launches(pre, rays)
                     for pre in (False, True)
                     for kind, rays in (("rays", ray_rays),
                                        ("patch", patch_rays))}
        records: list = []

        def instrumented(name, fn):
            """fn, recording its launches and, at each epoch's first step
            and around the other calls, the device-synchronised time."""
            step = name.startswith("train_step")

            def run(*a, **k):
                c0 = launch_counts()
                n_steps = sum(r["step"] for r in records)
                sync = not step or n_steps % per_epoch == 0
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                if not step:
                    torch.cuda.synchronize()
                c1 = launch_counts()
                records.append(dict(
                    name=name, step=step, t0=t0, t1=time.perf_counter(),
                    loss=out[1] if step else None,
                    counts={n: c1[n] - c0[n] for n in c1 if c1[n] != c0[n]}))
                return out
            return run

        names = ("train_step_rays", "train_step_patch", "render_test",
                 "render_spiral_video", "save_checkpoint")
        originals = {n: getattr(tcli, n) for n in names}
        # the renders' pieces, each timed between synchronisations
        pieces: dict = {}
        piece_names = ("extract_target_features", "_render_one",
                       "_render_one_full", "save_png",
                       "save_feature_saliency")
        piece_fns = {n: getattr(tval, n) for n in piece_names}

        def piece(name, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                secs, calls = pieces.get(name, (0.0, 0))
                pieces[name] = (secs + time.perf_counter() - t0, calls + 1)
                return out
            return run
        base = ["--datadir", paths["datadir"], "--data_root",
                paths["data_root"], "--basedir", str(logs), "--i_print", "1"]

        def ckpt_of(exp, epoch):
            return str((logs / exp / "ckpts" / f"epoch_{epoch:06d}.pt")
                       .absolute())

        runs = (
            ("stage 1, 3 epochs", "s1", ["--new_schedule", "1", "--epochs",
                                         "2", "--i_weights", "1",
                                         "--profile_dir",
                                         str(logs / "profile")]),
            ("stage 1 resumed", "s1", ["--new_schedule", "1", "--epochs",
                                       "4", "--i_weights", "1"]),
            ("stage 2 from --ft_path", "s2", [
                "--new_schedule", "2", "--ft_path", ckpt_of("s1", 4),
                "--epochs", "201", "--i_testset", "200", "--i_weights",
                "200"]),
            ("windowed (reduce_embedding 2)", "win", [
                "--new_schedule", "1", "--reduce_embedding", "2",
                "--epochs", "1"]),
            ("aux (TV, both sparsities)", "aux", [
                "--new_schedule", "1", "--tvloss", "true",
                "--sigma_sparsity_loss", "true", "--sigma_sparsity_loss2",
                "true", "--epochs", "0"]),
            ("render_test", "rt", ["--new_schedule", "2", "--render_test",
                                   "true", "--ft_path", ckpt_of("s2", 200)]),
            ("render_pose_only", "spiral", [
                "--render_pose_only", "true", "--spiral_views", "8",
                "--ft_path", ckpt_of("s2", 200)]),
        )
        stage0_first = None
        try:
            for n in names:
                setattr(tcli, n, instrumented(n, originals[n]))
            for n in piece_names:
                setattr(tval, n, piece(n, piece_fns[n]))
            for what, exp, flags in runs:
                records.clear()
                pieces.clear()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = tcli.main(base + ["--expname", exp] + flags)
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                log(f"traincli {what}: {t_end - t0:.3f} s of main() with "
                    f"set-up, peak memory "
                    f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
                    f"epoch {st.epoch} after")
                losses = traincli_report(what, records, t_end, per_epoch,
                                         ray_rays, patch_rays, want_step,
                                         "--reduce_embedding" in flags)
                if pieces:
                    views = sum(pieces.get(n, (0, 0))[1] for n in
                                ("_render_one", "_render_one_full"))
                    total = sum(r["t1"] - r["t0"] for r in records
                                if r["name"].startswith("render_"))
                    log(f"  the renders: {views} views, {total / views:.3f} "
                        f"s a view; their pieces (s, calls; synchronised): "
                        + ", ".join(f"{n} {v[0]:.3f} x{v[1]}"
                                    for n, v in pieces.items()))
                exp_dir = logs / exp
                check_cli_args(exp_dir, {f.name for f in fields(Options)})
                if what.startswith("stage 1, 3"):
                    stage0_first = losses[:per_epoch].mean().item()
                    if not (logs / "profile" / "trace.json").is_file():
                        raise AssertionError("--profile_dir wrote no trace")
                if what == "stage 1 resumed":
                    last = losses[-per_epoch:].mean().item()
                    log(f"  stage 0: the first epoch's mean loss "
                        f"{stage0_first:.6f}, the last's {last:.6f}")
                    if not last < stage0_first:
                        raise AssertionError("stage 0's loss did not fall")
                    check_cli_run(exp_dir, range(0, 5), [1, 2, 3, 4])
                if exp == "s2":
                    check_cli_run(exp_dir, range(0, 202), [200])
                    check_evaluate(exp_dir, 200, Image)
                if exp in ("win", "aux"):
                    check_cli_run(exp_dir, range(2 if exp == "win" else 1),
                                  [])
                if exp == "rt":
                    check_evaluate(exp_dir, 201, Image)
                if exp == "spiral":
                    frames = read_mp4(str(exp_dir / "spiral_spiral.mp4"))
                    log(f"  spiral video: {frames.shape} frames read back")
                    if frames.shape != (8, 4 * H, 4 * W, 3):
                        raise AssertionError(f"spiral {frames.shape}")
        finally:
            for n in names:
                setattr(tcli, n, originals[n])
            for n in piece_names:
                setattr(tval, n, piece_fns[n])
        torch.cuda.empty_cache()

    phase("traincli", do_traincli)

    def do_zoo():
        """The field zoo through the training CLI at its full defaults
        (D8/W128, 16 hash levels of 2^19 rows, bound 25, N_vocab 1000, f32,
        4 images x 1536 rays of 60x80 renders, 64+64 samples, stage 1) on
        the traincli phase's fixture: a run of each flag for ZOO_EPOCHS
        epochs, the hash run resumed from its checkpoint, --render_test on
        the NeRF-W run. Each: s/step and rays/s (synchronised steps, the
        first epoch excluded), peak memory, the loss falling (the first
        epoch's mean against the last's), no kernel launched (no kernel
        serves the zoo, as no Pallas kernel does in the JAX package). Then
        each kind's first step on the card against the CPU's."""
        import shutil
        from nefes_tpu_torch.cli import train as tcli
        root = Path("tmp") / "serve_fixture"
        paths = write_7scenes_fixture(root, SERVE_FRAMES,
                                      n_train=ZOO_FRAMES)
        logs = root / "zoo"
        shutil.rmtree(logs, ignore_errors=True)
        per_epoch = ZOO_FRAMES // TRAIN_B
        steps: list = []
        orig = tcli.train_step_rays

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0, float(out[1])))
            return out
        base = ["--datadir", paths["datadir"], "--data_root",
                paths["data_root"], "--basedir", str(logs), "--i_print", "1",
                "--new_schedule", "1"]
        # epochs 0 .. ZOO_EPOCHS - 1; the hash and the NeRF-W run keep
        # their last epoch's checkpoint
        last = ["--epochs", str(ZOO_EPOCHS - 1)]
        ckpt = ["--i_weights", str(ZOO_EPOCHS - 1)]
        tcnn = ["--tcnn", "true", "--l1normloss", "true"]
        runs = (("--tcnn --l1normloss", "tcnn", tcnn + last + ckpt),
                ("--sh_nff", "sh_nff", ["--sh_nff", "true"] + last),
                ("--ffmlp", "ffmlp", ["--ffmlp", "true"] + last),
                ("--nerfh_nff False", "nerfw", ["--nerfh_nff", "false"]
                 + last + ckpt),
                ("--NeRFW False", "nerf", ["--NeRFW", "false"] + last),
                ("--tcnn resumed", "tcnn", tcnn + [
                    "--epochs", str(ZOO_EPOCHS), "--i_weights", "1"]),
                ("--render_test on the NeRF-W run", "nerfw", [
                    "--nerfh_nff", "false", "--render_test", "true"]))
        try:
            tcli.train_step_rays = timed
            for what, exp, flags in runs:
                steps.clear()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = tcli.main(base + ["--expname", exp] + flags)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                called = {n: k.launches for n, k in wrappers.items()
                          if k.launches}
                if called:
                    raise AssertionError(f"zoo {what} launched {called}")
                kind = st.model.cfg.kind
                line = (f"zoo {what} ({kind}): {wall:.3f} s of main() with "
                        f"set-up, peak memory "
                        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} "
                        f"MiB, epoch {st.epoch} after")
                if steps:
                    secs = [t for t, _ in steps[per_epoch:]] or \
                        [t for t, _ in steps]
                    s_step = statistics.median(secs)
                    losses = [v for _, v in steps]
                    first = statistics.mean(losses[:per_epoch])
                    end = statistics.mean(losses[-per_epoch:])
                    line += (f"; {len(steps)} steps, {s_step:.4f} s/step "
                             f"(median of {len(secs)}), "
                             f"{TRAIN_B * N_RAND / s_step:.1f} rays/s; "
                             f"loss: first epoch {first:.5f}, last "
                             f"{end:.5f}")
                    if not np.isfinite(losses).all():
                        raise AssertionError(f"zoo {what}: non-finite loss")
                    if "resumed" not in what and not end < first:
                        raise AssertionError(f"zoo {what}: the loss did not "
                                             f"fall")
                log(line)
                if "resumed" in what:
                    want = logs / exp / "ckpts" / f"epoch_{ZOO_EPOCHS:06d}.pt"
                    if not (st.epoch == ZOO_EPOCHS + 1 and want.is_file()
                            and len(steps) == per_epoch):
                        raise AssertionError(f"zoo resume: epoch {st.epoch}, "
                                             f"{len(steps)} steps")
                if "render_test" in what:
                    pngs = sorted((logs / exp).glob(
                        f"evaluate_*_{ZOO_EPOCHS:06d}/*.png"))
                    log(f"  render_test from the epoch-{ZOO_EPOCHS - 1} "
                        f"checkpoint wrote {len(pngs)} PNGs")
                    if not (pngs and st.epoch == ZOO_EPOCHS):
                        raise AssertionError("zoo render_test")
        finally:
            tcli.train_step_rays = orig
        torch.cuda.empty_cache()
        zoo_first_steps()

    def zoo_first_steps():
        """Each zoo kind's first random-ray step at the CLI's widths on
        the card and on the CPU from the same weights (the CLI's seed;
        the hash field's with a visible density), pixels and targets,
        perturb off (zoo_step_compare)."""
        from nefes_tpu_torch.train.field_zoo import ZooConfig, ZooFieldModel
        for kind in ("hash", "nerfw", "nerf"):
            cfg = ZooConfig(kind=kind)
            cpu_model = ZooFieldModel(
                cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            if kind == "hash":
                visible_density(cpu_model)
            card_model = copy.deepcopy(cpu_model).to(dev)
            rcfg = cfg.render_config(n_samples=N_C, n_importance=N_F,
                                     perturb=False, remat=False)
            t0 = time.perf_counter()
            res = zoo_step_compare(card_model, cpu_model, rcfg, dev)
            log(f"zoo first step {kind}, card against CPU "
                f"({TRAIN_B} x {ZOO_CHECK_RAYS} rays, "
                f"{time.perf_counter() - t0:.1f} s): {json.dumps(res)}")
            del cpu_model, card_model

    phase("zoo", do_zoo)

    def do_accuracy():
        """The probe's accuracy command at full width and reduced depth
        (ACCURACY_ARGS): each stage's launches and seconds (the wrapped
        steps, renders and refinements of runtime/accuracy.py), the result's
        keys against the JAX command's record, every number finite, the
        stage-0 loss falling; the medians and wall time logged."""
        from nefes_tpu_torch.runtime import accuracy as acc
        stages: dict = {}
        losses: dict = {}

        def counted_stage(stage, fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                c0, t0 = launch_counts(), time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                c1, secs = launch_counts(), time.perf_counter() - t0
                rec = stages.setdefault(stage, {"calls": 0, "s": 0.0,
                                                "counts": {}})
                rec["calls"] += 1
                rec["s"] += secs
                for n in c1:
                    if c1[n] != c0[n]:
                        rec["counts"][n] = (rec["counts"].get(n, 0)
                                            + c1[n] - c0[n])
                if stage == "train":
                    st = 2 if fn is originals["train_step_patch"] \
                        else k.get("stage", 0)
                    losses.setdefault(st, []).append(float(out[1]))
                return out
            return run
        wrapped = {"train_step_rays": "train", "train_step_patch": "train",
                   "render_feature_image": "render",
                   "refine_apr_batch": "mode2", "refine_poses_batch": "mode3"}
        originals = {n: getattr(acc, n) for n in wrapped}
        for n, stage in wrapped.items():
            setattr(acc, n, counted_stage(stage, originals[n]))
        args = probe.parser().parse_args(ACCURACY_ARGS)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = probe.cmd_accuracy(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = {n: c for n, c in launch_counts().items() if c}
        finally:
            for n, fn in originals.items():
                setattr(acc, n, fn)
        for stage, rec in stages.items():
            log(f"accuracy {stage}: {rec['calls']} calls, {rec['s']:.1f} s, "
                f"launches {rec['counts']}")
        log(f"accuracy: {wall:.1f} s of command (wall_s {res['wall_s']}), "
            f"launches {total}")
        summed: dict = {}
        for rec in stages.values():
            for n, c in rec["counts"].items():
                summed[n] = summed.get(n, 0) + c
        if summed != total:
            raise AssertionError(f"accuracy: launches outside the stages: "
                                 f"{total} against {summed}")
        for stage, want in ACCURACY_KERNELS.items():
            got = set(stages.get(stage, {}).get("counts", {}))
            if got != set(want):
                raise AssertionError(f"accuracy {stage} launched "
                                     f"{sorted(got)}, expected {want}")
        with open(Path(__file__).resolve().parent / "ACCURACY_r05.json") as f:
            record = json.load(f)
        if key_tree(res) != key_tree(record):
            raise AssertionError(f"accuracy keys {key_tree(res)} differ "
                                 f"from the JAX command's {key_tree(record)}")
        bad = nonfinite(res)
        if bad:
            raise AssertionError(f"accuracy: non-finite {bad}")
        per_ep = len(acc.split_views(args.n_train, args.n_test)[0]) \
            // acc.BATCH
        s0 = losses[0]
        first, last = np.mean(s0[:per_ep]), np.mean(s0[-per_ep:])
        log(f"accuracy stage-0 losses {s0}: first epoch {first:.5f}, last "
            f"{last:.5f}")
        if not last < first:
            raise AssertionError("accuracy: the stage-0 loss did not fall")
        log("accuracy result: " + json.dumps({k: res[k] for k in (
            "median_t_before_m", "median_t_after_m", "median_r_before_deg",
            "median_r_after_deg", "improved_frames_frac", "retreat_frames",
            "t_improvement_x", "r_improvement_x", "mode3_median_t_before_m",
            "mode3_median_t_after_m", "mode3_median_r_before_deg",
            "mode3_median_r_after_deg", "headline_fusion_bn", "refine_lr",
            "train_psnr_db", "fusion_liveness", "wall_s")}))
        torch.cuda.empty_cache()

    phase("accuracy", do_accuracy)

    @torch.no_grad()
    def do_time():
        if "inputs" not in state:
            raise RuntimeError("the time phase needs the check phase")
        ins = state["inputs"]["bfloat16"]
        pc, pf = ins["packed"]
        emb_c, emb, embd, z = ins["emb_c"], ins["emb"], ins["embd"], ins["z"]
        pts_c, pts, dirs = ins["pts_c"], ins["pts"], ins["dirs"]
        g_field, g_raw, g_ray = ins["g_field"], ins["g_raw"], ins["g_ray"]
        n_c, n_f, R = emb_c.shape[0], emb.shape[0], z.shape[0]
        sp = pf.spec
        fl = probe.tower_flops(sp, samples=z.shape[1])
        el = probe.embed_ops(sp.n_freqs_xyz, sp.n_freqs_dir)
        b2, b4 = 2, 4   # bytes of a bf16 and of an f32 value
        # each launch's bytes, the tower's weights included
        kb = probe.refinement_kernel_bytes(ins["packed"], R,
                                           n_c // R, n_f // R)
        # name: (call, wrapper, plain version, yardstick, bf16 matmul
        # FLOPs, f32 elementwise operations, bytes: K1-K8 with the
        # weights, the training variants besides them)
        rows = {
            "K1 field_fwd_pre": (
                lambda f: f(pc, False, emb_c, None), kf.field_fwd_pre,
                kf.field_fwd_pre_plain,
                lambda: chain(pc, False, emb_c, None, False),
                n_c * fl["K1"], 0, kb["field_fwd_pre"]),
            "K2 field_bwd_pre": (
                lambda f: f(pf, True, emb, embd, *g_field),
                kf.field_bwd_pre, kf.field_bwd_pre_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K2"], 0, kb["field_bwd_pre"]),
            "K3 render_fwd_pre": (
                lambda f: f(pf, emb, embd, z), kr.render_fwd_pre,
                kr.render_fwd_pre_plain,
                lambda: chain(pf, True, emb, embd, False),
                n_f * fl["K3"], 0, kb["render_fwd_pre"]),
            "K4 render_bwd_pre": (
                lambda f: f(pf, emb, embd, z, g_ray), kr.render_bwd_pre,
                kr.render_bwd_pre_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K4"], 0, kb["render_bwd_pre"]),
            "K5 field_fwd": (
                lambda f: f(pc, False, pts_c, None), kf.field_fwd,
                kf.field_fwd_plain,
                lambda: chain(pc, False, emb_c, None, False),
                n_c * fl["K1"], n_c * el["xyz_fwd"], kb["field_fwd"]),
            "K6 field_bwd": (
                lambda f: f(pf, True, pts, dirs, *g_raw), kf.field_bwd,
                kf.field_bwd_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K2"], n_f * (el["fwd"] + el["bwd"]),
                kb["field_bwd"]),
            "K7 render_fwd": (
                lambda f: f(pf, pts, dirs, z), kr.render_fwd,
                kr.render_fwd_plain,
                lambda: chain(pf, True, emb, embd, False),
                n_f * fl["K3"], n_f * el["fwd"], kb["render_fwd"]),
            "K8 render_bwd": (
                lambda f: f(pf, pts, dirs, z, g_ray), kr.render_bwd,
                kr.render_bwd_plain,
                lambda: chain(pf, True, emb, embd, True),
                n_f * fl["K4"], n_f * (el["fwd"] + el["bwd"]),
                kb["render_bwd"]),
        }
        # the training variants at the fine training shape (transient
        # mode), their gradients f32
        tr = state["train_inputs"]["bfloat16"]
        _, tpf = tr["packed"]
        temb, tembd, tpts, tdirs = tr["emb"], tr["embd"], tr["pts"], tr["dirs"]
        g_pre, g_rw = tr["g_f_pre"], tr["g_f_raw"]
        n_t, T = temb.shape[0], kf.TRANSIENT
        heads_t = 1 + 3 + sp.feature_dim + 5
        dw_bytes = (tpf.w.numel() + tpf.b.numel()) * b4
        rows.update({
            "K1 field_fwd_pre transient": (
                lambda f: f(tpf, T, temb, tembd), kf.field_fwd_pre,
                kf.field_fwd_pre_plain,
                lambda: chain(tpf, T, temb, tembd, False),
                n_t * fl["fwd_t"], 0,
                n_t * (sp.emb_xyz + sp.emb_dir + heads_t) * b2),
            "K2 field_bwd_pre +dW": (
                lambda f: f(tpf, T, temb, tembd, *g_pre, need_dw=True),
                kf.field_bwd_pre, kf.field_bwd_pre_plain,
                lambda: chain(tpf, T, temb, tembd, True, dw=True),
                n_t * fl["bwd_dw_t"], 0,
                n_t * (2 * (sp.emb_xyz + sp.emb_dir) + heads_t) * b2
                + dw_bytes),
            "K5 field_fwd transient": (
                lambda f: f(tpf, T, tpts, tdirs), kf.field_fwd,
                kf.field_fwd_plain,
                lambda: chain(tpf, T, temb, tembd, False),
                n_t * fl["fwd_t"], n_t * el["fwd"],
                n_t * (2 * 3 + heads_t) * b4),
            "K6 field_bwd +dW": (
                lambda f: f(tpf, T, tpts, tdirs, *g_rw, need_dw=True),
                kf.field_bwd, kf.field_bwd_plain,
                lambda: chain(tpf, T, temb, tembd, True, dw=True),
                n_t * fl["bwd_dw_t"], n_t * (el["fwd"] + el["bwd"]),
                n_t * (4 * 3 + heads_t) * b4 + dw_bytes),
        })
        # the dW kernel alone on the fine pass's first chunk: 2 K N FLOPs a
        # row a product (a bias: K = 1); its operands and the head biases'
        # tile sums read once, the slices' partials read and written
        dops, dtb, drows, dslices = first_chunk(tpf, T, tpts, tdirs, g_rw)
        dpart = torch.zeros((dslices, tpf.w.numel() + tpf.b.numel()),
                            device=dev)
        views = kf.dw_operands(tpf.spec, T, dops, drows)
        prods = kf.dw_products(tpf.spec, T)
        from_g, heads = kf.dw_biases(tpf.spec, T)
        kn = sum(tpf.weights[nm].numel()
                 for nm in [p_[2] for p_ in prods] + [b_[1] for b_ in from_g])
        head_b = sum(tpf.weights[nm].numel() for nm in heads)
        row_elems = build.library("fused_field").nefes_field_dw_row_elems(
            T, *kf.dims(tpf.spec))
        rows["K2/K6 field_dw"] = (
            lambda f: (f(tpf, T, dops, dtb, drows) if f is kf.field_dw_plain
                       else f(tpf, T, dops, dtb, drows, dpart)),
            kf.field_dw, kf.field_dw_plain,
            lambda: ([views[a].t() @ views[g] for a, g, _ in prods]
                     + [views[g].sum(0, dtype=torch.float32)
                        for g, _ in from_g]),
            2 * drows * kn, 0,
            drows * row_elems * b2 + -(-drows // kf.TILE_ROWS) * head_b * b4
            + 2 * dpart.numel() * b4)
        # the weights the training variants read, the transient heads'
        train_bytes = tpf.w.numel() * b2 + tpf.b.numel() * b4
        for name, (case, kern, plain, lib_fn, flops, ew, nbytes) in \
                rows.items():
            saved = snapshot_counts()
            ms = time_ms(lambda: case(kern))
            restore_counts(saved)      # timing launches are not the path's
            plain_ms = time_ms(lambda: case(plain), reps=3)
            lib_ms = time_ms(lib_fn, reps=3)
            if name in variants:
                nbytes += train_bytes
            bound_ms, bound_by = probe.bound(flops, ew, nbytes)
            kernels[name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                flops=flops + ew, bytes=nbytes)
            earlier = (f" (first version {EARLIER_MS[name]:.3f} ms, "
                       f"PERF.md)" if name in EARLIER_MS else "")
            log(f"{name}: {ms:.3f} ms{earlier} (bound {bound_ms:.4f} ms "
                f"by {kernels[name]['bound_by']}: {flops / 1e9:.1f} GFLOP "
                f"bf16 + {ew / 1e9:.3f} G f32 ops, {nbytes / 1e6:.1f} MB; "
                f"{flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms, "
                f"bf16 matmul chain {lib_ms:.3f} ms")
        time_turns(rows)

    def time_turns(rows):
        """Kernels in turns on the time phase's inputs, each variant
        called the same way (field_call, render_call, bwd_call), so the
        host's share is the same: K1 and K5, in sigma mode (the main
        path's coarse pass) and in transient mode (training's fine pass),
        on their persistent grid and on one block per block tile (whose
        outputs must be equal); with --parent also
        the parent tree's K1 and K5 and, of both trees, K3, K4, K7 and K8,
        K2 and K6 in transient mode with dW and frozen (the fine training
        pass), and K2 and K6 in full mode (frozen on the refinement's fine
        pass; K6 +dW on the coarse training pass), the backwards of this
        tree also on one block per block tile, each of the parent's
        checked against its plain version first
        (relative L2). 5 rounds of the variants in
        order and then in reverse (this, tile, tile, this or parent, this,
        this, parent, ...), the median of each one's 10 times."""
        names = list(_FIELD_ENTRY)
        if parent:
            names += list(_RENDER_ENTRY) + list(_BWD_ENTRY)
        for name in names:
            field = name in _FIELD_ENTRY
            src, call = (("fused_field", field_call) if field
                         else ("fused_field", bwd_call)
                         if name in _BWD_ENTRY
                         else ("fused_render", render_call))
            # this tree also on one block per block tile: the field
            # forward and backward
            tile = field or name in _BWD_ENTRY
            train = (name.endswith("transient")
                     or name in _BWD_ENTRY and _BWD_ENTRY[name][2])
            ins = state["train_inputs" if train else "inputs"]["bfloat16"]
            this = build.library(src)
            fns = {}
            if parent:
                lib = build.library(src, **parent)
                got = call(lib, name, ins, dev)
                want = (bwd_plain(name, ins) if name in _BWD_ENTRY
                        else rows[name][0](rows[name][2]))
                if torch.is_tensor(want):       # a forward's one output
                    want = (want,)
                l2 = max(float((a.float() - b.float()).norm()
                               / b.float().norm())
                         for a, b in zip(got, want))
                if not l2 <= TOL["bfloat16"]:
                    raise AssertionError(f"parent {name}: rel_l2 {l2:.3e}")
                log(f"parent {name}: rel_l2 {l2:.3e} against plain")
                del got, want
                fns["parent"] = lambda lib=lib: call(lib, name, ins, dev)
            fns["this"] = lambda: call(this, name, ins, dev)
            if tile:
                fns["tile"] = lambda: call(this, name, ins, dev, 0)
                if not all(torch.equal(a, b) for a, b in
                           zip(fns["tile"](), fns["this"]())):
                    raise AssertionError(f"{name}: one block per block "
                                         f"tile differs from the grid")
            keys = list(fns)
            times = {k: [] for k in keys}
            for f in (*fns.values(), *fns.values()):     # warm
                f()
            for _ in range(5):
                for k in keys + keys[::-1]:
                    times[k].append(event_ms(fns[k]))
            ms = {k: statistics.median(v) for k, v in times.items()}
            label = {"this": "this tree", "parent": "parent",
                     "tile": "this tree on one block per block tile"}
            earlier = (f" (first design {EARLIER_MS[name]:.3f} ms, PERF.md)"
                       if name in EARLIER_MS else "")
            log(f"{name} in turns{earlier}: " + ", ".join(
                f"{label[k]} {ms[k]:.3f} ms ({ms[k] / ms['this']:.3f}x)"
                for k in keys) + "; times " + "; ".join(
                f"{k} {[round(t, 3) for t in times[k]]}" for k in keys))
            torch.cuda.empty_cache()

    @torch.no_grad()
    def time_coarse_training():
        """The coarse pass of a training step (full mode, half the fine
        samples): K5 forward (and K1 on the embeddings) and K6 with dW,
        their ms."""
        tr = state["train_inputs"]["bfloat16"]
        pc = tr["packed"][0]
        n_c = tr["pts_c"].shape[0]
        gen = torch.Generator(device=dev).manual_seed(3)
        g = [torch.randn(s_, device=dev, generator=gen)
             for s_ in ((n_c,), (n_c, 3), (n_c, pc.spec.feature_dim))]
        saved = snapshot_counts()
        fwd = time_ms(lambda: kf.field_fwd(pc, kf.FULL, tr["pts_c"],
                                           tr["dirs_c"]))
        fwd_pre = time_ms(lambda: kf.field_fwd_pre(pc, kf.FULL, tr["emb_c"],
                                                   tr["embd_c"]))
        bwd = time_ms(lambda: kf.field_bwd(pc, kf.FULL, tr["pts_c"],
                                           tr["dirs_c"], *g, need_dw=True))
        # the fine pass's K6 +dW by part: the frozen backward over every
        # row, one chunk's backward writing its dW operands, the dW kernel
        # on one chunk
        _, pf = tr["packed"]
        T, x, d, g_f = kf.TRANSIENT, tr["pts"], tr["dirs"], tr["g_f_raw"]
        n_f = x.shape[0]
        frozen = time_ms(lambda: kf.field_bwd(pf, T, x, d, *g_f))
        frozen_pre = time_ms(lambda: kf.field_bwd_pre(pf, T, tr["emb"],
                                                      tr["embd"], *tr["g_f_pre"]))
        ops, tile_b, rows, slices = first_chunk(pf, T, x, d, g_f)
        chunk_ms = time_ms(lambda: first_chunk(pf, T, x, d, g_f))
        part = torch.zeros((slices, pf.w.numel() + pf.b.numel()), device=dev)
        dw_ms = time_ms(lambda: kf.field_dw(pf, T, ops, tile_b, rows, part))
        restore_counts(saved)
        chunks = -(-n_f // rows)
        log(f"coarse training pass ({n_c} samples, full mode): K5 field_fwd "
            f"{fwd:.3f} ms (K1 field_fwd_pre {fwd_pre:.3f} ms), K6 "
            f"field_bwd +dW {bwd:.3f} ms")
        log(f"fine training pass ({n_f} samples, transient mode): K6 "
            f"field_bwd without dW {frozen:.3f} ms (K2 {frozen_pre:.3f} ms; "
            f"first design {EARLIER_MS['K6 field_bwd transient']} / "
            f"{EARLIER_MS['K2 field_bwd_pre transient']} ms, PERF.md); "
            f"with dW in {chunks} chunks of {rows} rows: the backward "
            f"{chunk_ms:.3f} ms a chunk, the dW kernel {dw_ms:.3f} ms a chunk "
            f"({slices} slices); {chunks} x both = "
            f"{chunks * (chunk_ms + dw_ms):.3f} ms")

    def do_time_all():
        do_time()
        time_coarse_training()

    phase("time", do_time_all)

    # the row of each micro-benchmark kernel in the kernels line: K9 at
    # tile 2048 (K10's tile), K10 with 4 sub-tiles, K11 at tile 2048, K12
    # at width 128 (N rows); kernelmicro prints every tile and width
    micro_rows = {"K9 chain": "chain8_tile2048_ms",
                  "K10 chain_interleaved": "chain8_interleave4_ms",
                  "K11 embed_micro": "embed_tile2048_ms",
                  "K12 chain_sq": "sq_chain8_w128_ms"}

    def do_micro():
        from types import SimpleNamespace
        tiles = list(MICRO_TILES)
        out, secs, counts = counted("micro", lambda: probe.cmd_kernelmicro(
            SimpleNamespace(device="cuda", tiles=tiles, out="")))
        log(f"micro: kernelmicro in {secs:.1f} s, launches {counts}")
        for name, key in micro_rows.items():
            row = out["kernels"][key]
            kernels[name].update(
                {k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")},
                launches=counts[name], path=f"probe kernelmicro ({key})")
        # each kernel against its plain version, at every tile and width
        # of the run (these launches are not the path's)
        ins = probe.micro_inputs(dev, MICRO_N)
        cw, x, pts = ins["chain"], ins["x"], ins["pts"]
        bf = "bfloat16"
        with torch.no_grad():
            want = km.chain_plain(cw, x)
            for tile in tiles:
                compare("K9 chain", f"tile {tile}", bf,
                        (km.chain(cw, x, tile),), (want,))
            k9 = km.chain(cw, x, 2048)
            for nb in (2, 4):
                got = km.chain_interleaved(cw, x, 2048, nb)
                compare("K10 chain_interleaved", f"x{nb} tile 2048", bf,
                        (got,), (want,))
                if not torch.equal(got, k9):
                    raise AssertionError(f"K10 x{nb} differs from K9 at "
                                         f"tile 2048")
            del want, k9, got
            want = km.embed_micro_plain(pts)
            for tile in tiles:
                got = km.embed_micro(pts, tile)
                compare("K11 embed_micro", f"tile {tile}", bf, (got,),
                        (want,))
                if not torch.equal(got, want):
                    raise AssertionError(f"K11 tile {tile}: not bit for bit")
            del want, got
            for w_, tile in ((128, 2048), (256, 512)):
                scw, sx = ins["sq"][w_]
                sq = km.chain_sq(scw, sx, tile)
                compare("K12 chain_sq", f"w{w_} tile {tile}", bf, (sq,),
                        (km.chain_plain(scw, sx),))
                # K10 on the square chain at every nb the kernel takes
                for nb in ((2, 4) if w_ <= 128 else (2,)):
                    if not torch.equal(km.chain_interleaved(scw, sx, tile,
                                                            nb), sq):
                        raise AssertionError(f"K10 x{nb} differs from K12 "
                                             f"at w{w_}")
            log("K10 equals K9 at tile 2048 (x2, x4) and K12 at w128 (x2, "
                "x4) and w256 (x2); K11 equals its plain version bit for "
                "bit at every tile")
            if parent:
                micro_turns(ins)
        torch.cuda.empty_cache()

    @torch.no_grad()
    def micro_turns(ins):
        """The parent tree's micro kernels against this tree's, in turns:
        K9 at each tile, K10 x2 / x4 at tile 2048, K11 at each tile, K12
        at w128 (tile 2048) and w256 (tile 512). The parent's chain reads
        the weights as its own pack_chain laid them out (the matrices
        row-major, one after another); each of its kernels is checked
        against the plain version first (relative L2; K11 bit for bit).
        5 rounds of parent, this, this, parent, each time over
        probe.MICRO_CALLS launches: the median of 10 each."""
        plib = build.library("micro", **parent)
        cw, x, pts = ins["chain"], ins["x"], ins["pts"]
        stream = kf._stream
        bf = torch.bfloat16

        def parent_chain(c, xx, tile, nb):
            flat = torch.cat([w.reshape(-1) for w in c.ws])
            o = torch.empty((xx.shape[0], c.W), dtype=bf, device=dev)

            def run():
                kf.raise_on(plib.nefes_micro_chain(
                    1, xx.shape[0], tile, nb, c.E, c.W, c.D, xx.data_ptr(),
                    flat.data_ptr(), o.data_ptr(), stream()), "parent chain")
                return o
            return run

        def parent_embed(tile):
            o = torch.empty((pts.shape[0], km.EMBED_COLS), dtype=bf,
                            device=dev)

            def run():
                kf.raise_on(plib.nefes_micro_embed(
                    1, pts.shape[0], tile, pts.data_ptr(), o.data_ptr(),
                    stream()), "parent embed")
                return o
            return run

        cases = {}
        for tile in MICRO_TILES:
            cases[f"K9 tile {tile}"] = (
                parent_chain(cw, x, tile, 1),
                lambda tile=tile: km.chain(cw, x, tile),
                lambda: km.chain_plain(cw, x), False)
        for nb in (2, 4):
            cases[f"K10 x{nb}"] = (
                parent_chain(cw, x, 2048, nb),
                lambda nb=nb: km.chain_interleaved(cw, x, 2048, nb),
                lambda: km.chain_plain(cw, x), False)
        for tile in MICRO_TILES:
            cases[f"K11 tile {tile}"] = (
                parent_embed(tile),
                lambda tile=tile: km.embed_micro(pts, tile),
                lambda: km.embed_micro_plain(pts), True)
        for w_, tile in ((128, 2048), (256, 512)):
            scw, sx = ins["sq"][w_]
            cases[f"K12 w{w_}"] = (
                parent_chain(scw, sx, tile, 1),
                lambda scw=scw, sx=sx, tile=tile: km.chain_sq(scw, sx, tile),
                lambda scw=scw, sx=sx: km.chain_plain(scw, sx), False)
        saved = snapshot_counts()
        for label, (par, this, plain, exact) in cases.items():
            want = plain()
            got = par()
            l2 = float((got.float() - want.float()).norm()
                       / want.float().norm())
            if not l2 <= TOL["bfloat16"] or exact and not torch.equal(got,
                                                                      want):
                raise AssertionError(f"parent {label}: rel_l2 {l2:.3e}")
            del got, want
            fns = {"parent": par, "this": this}
            times = {k: [] for k in fns}
            for f in (par, this, this, par):     # warm
                f()
            calls = probe.MICRO_CALLS
            for _ in range(5):
                for k in ("parent", "this", "this", "parent"):
                    times[k].append(event_ms(
                        lambda f=fns[k]: [f() for _ in range(calls)]) / calls)
            ms = {k: statistics.median(v) for k, v in times.items()}
            log(f"micro {label} in turns (first design "
                f"{MICRO_EARLIER_MS[label]} ms, PERF.md): parent {ms['parent']:.4f} ms (rel_l2 "
                f"{l2:.2e} against plain), this tree {ms['this']:.4f} ms "
                f"({ms['parent'] / ms['this']:.2f}x faster); times "
                + "; ".join(f"{k} {[round(t, 4) for t in v]}"
                            for k, v in times.items()))
        restore_counts(saved)     # timing launches are not the path's

    phase("micro", do_micro)

    def do_probe():
        from types import SimpleNamespace
        (res_k, res_p, res_m), secs, counts = counted("probe", lambda: (
            probe.cmd_kernel(SimpleNamespace(device="cuda", sweep=True)),
            probe.cmd_perf(SimpleNamespace(device="cuda", refine_n=1)),
            probe.cmd_mode2(SimpleNamespace(device="cuda", iters=ITERS))))
        log(f"probe: kernel, perf and mode2 in {secs:.1f} s, launches "
            f"{counts}")
        log(f"probe mode2 (f32 against bf16 DFNet in turns, {ITERS} "
            f"iterations): {json.dumps(res_m)}")
        bad = [k for k, v in {**res_k, **res_p, **res_m}.items()
               if not (np.isfinite(v) and v >= 0)]
        if bad:
            raise AssertionError(f"probe: non-finite or negative {bad}")
        # K5 bf16 must sit within the plain bf16 field's band around the
        # plain f32 field (the JAX probe's criterion), here 4x its max-abs
        for key in ("static_sigma", "static_rgb", "static_feat"):
            e_k = res_k[f"{key}_maxerr_kern16"]
            e_p = res_k[f"{key}_maxerr_plain16"]
            if not e_k <= PROBE_BAND * e_p:
                raise AssertionError(f"probe kernel: K5 {key} max-abs "
                                     f"{e_k:.3e} from f32, plain bf16 "
                                     f"{e_p:.3e}")
        if not res_k["fused_render_rgb_maxerr"] <= PROBE_RGB_TOL:
            raise AssertionError("probe kernel: fused render rgb differs "
                                 "from the unfused fine pass")
        torch.cuda.empty_cache()

    phase("probe", do_probe)

    def do_inscan_ab():
        """The probe's inscan_ab command at its defaults; each variant's
        timing launches the kernels its flags name and no other."""
        expect = {"unfused": "unfused", "fused_raw": "fused_raw",
                  "fused_pre": "field_pre", "render_pre": "render_pre"}
        timeit, seen = probe.timeit, {}

        def counted_timeit(name, fn, **kw):
            reset_counts()
            dt = timeit(name, fn, **kw)
            seen[name] = {n: k.launches for n, k in wrappers.items()
                          if k.launches}
            return dt
        probe.timeit = counted_timeit
        Path("tmp").mkdir(exist_ok=True)
        try:
            t0 = time.perf_counter()
            res = probe.main(["inscan_ab", "--device", "cuda", "--out",
                              str(Path("tmp") / "INSCAN_torch.json")])
            secs = time.perf_counter() - t0
        finally:
            probe.timeit = timeit
        if res != 0:
            raise AssertionError(f"inscan_ab returned {res}")
        table = json.loads((Path("tmp") / "INSCAN_torch.json").read_text())
        log(f"inscan_ab in {secs:.1f} s: "
            f"{json.dumps(table['in_scan_ab_s_per_frame'])}")
        for name, counts in seen.items():
            variant = name.split("[")[1].split(",")[0]
            want = set(path_kernels[expect[variant]])
            log(f"  {name}: launches outside the replays {counts}")
            if set(counts) != want:
                raise AssertionError(f"inscan_ab {name} launched "
                                     f"{sorted(counts)}, expected "
                                     f"{sorted(want)}")
        rows = table["in_scan_ab_s_per_frame"]
        if set(rows) != {"mode3", "mode2_bf16"} or not all(
                set(r) == set(expect) and all(
                    np.isfinite(v) and v > 0 for v in r.values())
                for r in rows.values()):
            raise AssertionError(f"inscan_ab table {rows}")
        torch.cuda.empty_cache()

    phase("inscan_ab", do_inscan_ab)

    def profiled(what, fn):
        """Run fn under torch.profiler; log the wall time, the device's
        busy share (the union of the kernels' spans) and the device time
        of the top kernels."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6          # us
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kern:
            log(f"profile {what}: the trace holds no device time")
            return
        busy, end = 0.0, -1.0
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in kern):
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name: dict = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
        log(f"profile {what}: {wall / 1e3:.1f} ms wall, device busy "
            f"{busy / 1e3:.1f} ms ({100 * busy / wall:.1f} %), idle "
            f"{100 - 100 * busy / wall:.1f} %")
        for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
            log(f"  {us / 1e3:9.3f} ms  {name[:90]}")

    def do_profile():
        """The device's busy share and time per kernel on each main path:
        3 train_raw steps, 5 iterations of mode 3 (render_pre) and of mode
        2 (render_raw), eager and through the captured loop."""
        from nefes_tpu_torch.train import create_train_state
        batch = make_train_batch(ModelConfig().feature_dim, dev)
        st = create_train_state(make_train_model("bfloat16", dev))
        gen = torch.Generator(device=dev).manual_seed(7)
        train_run("train_raw", st, batch, 2, gen)          # warm-up
        profiled("train train_raw, 3 steps",
                 lambda: train_run("train_raw", st, batch, 3, gen))
        profiled("mode3 render_pre, 5 iterations",
                 lambda: refine3("render_pre", 5))
        profiled("mode2 render_raw, 5 iterations",
                 lambda: refine2("render_raw", 5))
        # the captured loops: captured first, then 5 replays profiled
        captured3("render_pre", 5)
        captured2("render_raw", 5)
        profiled("mode3 render_pre captured, 5 iterations",
                 lambda: captured3("render_pre", 5))
        profiled("mode2 render_raw captured, 5 iterations",
                 lambda: captured2("render_raw", 5))
        # the probe's profile command: device time by framework phase
        reset_counts()
        prof_out = Path("tmp") / "PROFILE_torch.json"
        prof_out.parent.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        if probe.main(["profile", "--device", "cuda", "--mode", "both",
                       "--out", str(prof_out)]) != 0:
            raise AssertionError("profile command failed")
        launched = {n for n, k in wrappers.items() if k.launches}
        report = json.loads(prof_out.read_text())
        log(f"profile command in {time.perf_counter() - t0:.1f} s, "
            f"launches (warm-up, capture, the eager reference step) "
            f"{sorted(launched)}")
        if launched != set(path_kernels["render_pre"]) | set(
                path_kernels["render_raw"]):
            raise AssertionError(f"profile launched {sorted(launched)}")
        for leg in ("mode3", "mode2_bf16"):
            r = report[leg]
            phases = r["phases_ms_per_frame"]
            log(f"profile {leg}: wall {r['wall_s_per_frame']} s/frame, busy "
                f"{r['device_busy_ms_per_frame']} ms, span "
                f"{r['device_span_ms_per_frame']} ms, host gap "
                f"{r['host_gap_ms_per_frame']} ms; attributed by "
                f"{r['ops_attributed_by']}")
            log(f"  phases (ms a frame): {json.dumps(phases)}")
            log(f"  bandwidth floors: "
                f"{json.dumps(r['phase_bandwidth_floors'])}; bytes not "
                f"reckoned (ms a frame): "
                f"{json.dumps(r['bytes_not_reckoned_ms_per_frame'])}")
            for t in r["top_ops"][:12]:
                log(f"  {t['ms_per_frame']:8.3f} ms x{t['count']:>4} "
                    f"[{t['phase']}] {t['op'][:60]} | {t['opcode'][:100]}")
            total = sum(phases.values())
            if not abs(total - r["device_busy_ms_per_frame"]) <= 0.05 + \
                    1e-3 * total:
                raise AssertionError(f"profile {leg}: phases sum to "
                                     f"{total}, busy "
                                     f"{r['device_busy_ms_per_frame']}")
            ours = {t["phase"] for t in r["top_ops"] if "nefes::" in t["op"]}
            if phases.get("cuda_kernel", 0.0) <= 0 or ours != {"cuda_kernel"}:
                raise AssertionError(f"profile {leg}: the port's kernels in "
                                     f"{ours}")
            # the replayed kernels lined up with the eager step's launches
            by = r["ops_attributed_by"]
            replayed = sum(by.get(k, 0) for k in ("order", "name", "none"))
            if not by.get("order", 0) >= 0.95 * replayed:
                raise AssertionError(f"profile {leg}: replays matched {by}")
            if nonfinite(r):
                raise AssertionError(f"profile {leg}: {nonfinite(r)}")
        torch.cuda.empty_cache()

    phase("profile", do_profile)

    def by_path(counts: dict, path: str) -> None:
        """Keep a path's launch counts beside each kernel's main-path
        launches."""
        for name, c in counts.items():
            kernels[name].setdefault("launches_by_path", {})[path] = c

    path_kernels["render_fwd_raw"] = ("K5 field_fwd", "K7 render_fwd")

    def do_multichip():
        """parallel/ on the card: the sharded train step, mode 3, mode 2
        and render on an NCCL group of one rank, each bit for bit its
        unsharded path; then 2 gloo ranks on cuda:0 against one rank."""
        import multiprocessing
        import torch.distributed as dist
        from nefes_tpu_torch.geometry.rays import get_rays
        from nefes_tpu_torch.geometry.transforms import WorldSetup
        from nefes_tpu_torch.parallel import (
            init_distributed, make_mesh, make_sharded_train_step,
            refine_apr_sharded, refine_poses_sharded, render_rays_sharded,
            shard_batch,
        )
        from nefes_tpu_torch.refine import (
            refine_apr_batch, refine_poses_batch,
        )
        from nefes_tpu_torch.render.renderer import render_rays
        from nefes_tpu_torch.train import create_train_state, train_step_rays
        batch = make_train_batch(ModelConfig().feature_dim, dev)
        hwf = (H, W, FOCAL)

        def train_steps(step, st, b, n=MULTI_STEPS, gen=None):
            gen = gen or torch.Generator(device=dev).manual_seed(7)
            return torch.stack([step(st, b, gen)[1] for _ in
                                range(n)]).float().cpu()

        def plain_step(st, b, gen):
            return train_step_rays(st, train_render_cfg(st.model,
                                                        "train_raw"),
                                   b, gen, TRAIN_LR, hwf, NEAR, FAR,
                                   n_rand=N_RAND, stage=1)

        def same(a, b):
            return torch.equal(a.cpu(), b.cpu())

        init_distributed(0, 1, f"tcp://localhost:{free_port()}", device=dev,
                         timeout_s=60.0)
        try:
            mesh = make_mesh()
            # the train step (train_raw, bf16, stage 1, transient heads):
            # MULTI_WARM steps (the NCCL group's first all-reduces among
            # them), then MULTI_STEPS timed, as the train phase times
            st_ref = create_train_state(make_train_model("bfloat16", dev))
            ref_losses = train_steps(plain_step, st_ref, batch,
                                     MULTI_WARM + MULTI_STEPS)
            st = create_train_state(make_train_model("bfloat16", dev))
            sharded = make_sharded_train_step(
                train_render_cfg(st.model, "train_raw"), mesh, hwf, NEAR, FAR,
                n_rand=N_RAND, stage=1)
            local = shard_batch(mesh, batch)
            gen = torch.Generator(device=dev).manual_seed(7)
            one = lambda s_, b_, g_: sharded(s_, b_, g_, TRAIN_LR)
            warm = train_steps(one, st, local, MULTI_WARM, gen)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            timed, secs, counts = counted("train_raw", lambda: train_steps(
                one, st, local, MULTI_STEPS, gen))
            losses = torch.cat([warm, timed])
            equal = same(losses, ref_losses) and all(
                torch.equal(a, b) for a, b in zip(st.model.parameters(),
                                                  st_ref.model.parameters()))
            log(f"multichip train (NCCL, 1 rank, train_raw bf16, "
                f"{TRAIN_B}x{N_RAND} rays, stage 1): {secs / MULTI_STEPS:.4f}"
                f" s/step over {MULTI_STEPS} steps after {MULTI_WARM} "
                f"warm-up steps, losses "
                f"{losses.tolist()}, loss and every parameter "
                f"{'bit for bit' if equal else 'NOT'} train_step_rays'")
            log(f"  peak memory {peak_mib(held, 'the steps')}; launches "
                f"{counts}")
            if not equal:
                raise AssertionError("sharded train step != train_step_rays")
            by_path(counts, "multichip train")
            del st, st_ref

            # mode 3 of 2 frames (K1, K3, K4)
            init2 = torch.stack([init, learn_pose(
                torch.tensor([-0.01, 0.02, 0.0], device=dev),
                torch.tensor([0.0, 0.03, -0.02], device=dev), gt)[:3, :4]])
            feats = target[None].expand(2, *target.shape).contiguous()
            hists2 = torch.zeros((2, 10), device=dev)
            ws = WorldSetup(NEAR, FAR, 1.0, 1.0, (0.0, 0.0, 0.0))
            want3 = refine_poses_batch(model, init2, feats, hists2, ws, hwf,
                                       cfgs["render_pre"], rcfg)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            got3, secs, counts = counted("render_pre", lambda:
                                         refine_poses_sharded(
                model, init2, feats, hists2, ws, hwf, cfgs["render_pre"],
                rcfg, mesh))
            equal = all(same(a, b) for a, b in zip(got3, want3))
            log(f"multichip mode 3 (NCCL, 1 rank, render_pre, 2 frames x "
                f"{ITERS} iterations): {secs / 2:.4f} s/frame, refined poses"
                f" and losses {'bit for bit' if equal else 'NOT'} "
                f"refine_poses_batch'; peak memory "
                f"{peak_mib(held, 'the frames')}; launches {counts}")
            if not equal:
                raise AssertionError("refine_poses_sharded != "
                                     "refine_poses_batch")
            by_path(counts, "multichip mode 3")

            # mode 2 of 1 frame, the bf16 DFNet (K5, K7, K8)
            dfnet, kw = apr_of(BF16_DFNET)
            _, image, target2 = mode2_inputs("bfloat16")
            args2 = (image[None], target2[None], hist[None], ws_vec, hwf,
                     (IMG_H, IMG_W, FOCAL_FULL), NEAR, FAR,
                     cfgs["render_raw"], rcfg2)
            torch.backends.cudnn.deterministic = True
            try:
                want2 = refine_apr_batch(model, dfnet, *args2, **kw)
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                got2, secs, counts = counted("render_raw", lambda:
                                             refine_apr_sharded(
                    model, dfnet, *args2, mesh, **kw))
            finally:
                torch.backends.cudnn.deterministic = False
            equal = all(same(got2[k], want2[k]) for k in want2)
            log(f"multichip mode 2 (NCCL, 1 rank, render_raw, bf16 DFNet, "
                f"1 frame x {ITERS} iterations): {secs:.4f} s/frame, every "
                f"output {'bit for bit' if equal else 'NOT'} "
                f"refine_apr_batch's; peak memory "
                f"{peak_mib(held, 'the frame')}; launches {counts}")
            if not equal:
                raise AssertionError("refine_apr_sharded != "
                                     "refine_apr_batch")
            by_path(counts, "multichip mode 2")

            # one 60x80 image's rays (K5 + K7)
            ro, rd = (x.reshape(-1, 3) for x in get_rays(H, W, FOCAL, gt))
            cfg_r = cfgs["render_raw"]
            with torch.no_grad():
                want_rgb = render_rays(*model.field_fns(cfg_r), ro, rd, NEAR,
                                       FAR, None, cfg_r)["rgb"]
            rgb, secs, counts = counted("render_fwd_raw", lambda:
                                        render_rays_sharded(
                model, ro, rd, NEAR, FAR, cfg_r, mesh))
            equal = same(rgb, want_rgb)
            log(f"multichip render (NCCL, 1 rank, {H}x{W} rays, K5 + K7): "
                f"{secs * 1e3:.2f} ms, rgb {'bit for bit' if equal else 'NOT'}"
                f" render_rays'; launches {counts}")
            if not equal:
                raise AssertionError("render_rays_sharded != render_rays")
            by_path(counts, "multichip render")
        finally:
            dist.destroy_process_group()

        # 2 gloo ranks on cuda:0, f32, images over "data", against one
        # rank: JAX's tolerances (tests/test_sharding.py)
        out = Path("tmp") / "multichip_gloo.pt"
        out.parent.mkdir(exist_ok=True)
        out.unlink(missing_ok=True)
        address = f"tcp://localhost:{free_port()}"
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=gloo_rank, args=(r, address, str(out)))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:                      # one deadline for both
                p.join(max(0.0, t0 + GLOO_JOIN_S - time.perf_counter()))
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
        secs = time.perf_counter() - t0
        if hung or any(p.exitcode for p in procs):
            raise AssertionError(f"gloo ranks: exit codes "
                                 f"{[p.exitcode for p in procs]}")
        res = torch.load(out)
        st1 = create_train_state(make_train_model("float32", dev))
        ref = train_steps(plain_step, st1, batch)
        p1 = flat_params(st1.model).cpu()
        loss_rel = ((res["losses"] - ref).abs() / ref.abs()).max().item()
        param_abs = (res["params"] - p1).abs().max().item()
        log(f"multichip 2 gloo ranks on cuda:0 (f32 train_raw, {MULTI_STEPS}"
            f" steps, 2 images a rank): {secs:.1f} s for both processes "
            f"from their start; against one rank: loss rel "
            f"{loss_rel:.3e} (tolerance {GLOO_LOSS_RTOL:g}), parameters max "
            f"abs {param_abs:.3e} (tolerance {GLOO_PARAM_ATOL:g})")
        if not (loss_rel <= GLOO_LOSS_RTOL and param_abs <= GLOO_PARAM_ATOL):
            raise AssertionError("2 gloo ranks disagree with one rank")

    phase("multichip", do_multichip)

    def do_legacy():
        """refine/legacy_train.py and utils/homography.py on the card."""
        from nefes_tpu_torch.refine import legacy_train as lt
        from nefes_tpu_torch.utils.homography import create_warped_img
        poses = train_poses(dev).cpu().numpy()
        hists4 = np.zeros((len(poses), 10), np.float32)
        got, secs, counts = counted("render_fwd_raw", lambda:
                                    lt.render_nerfw_imgs(
            model, poses, hists4, (H, W, FOCAL), NEAR, FAR,
            cfgs["render_raw"]))
        want, secs_plain, _ = counted("unfused", lambda: lt.render_nerfw_imgs(
            model, poses, hists4, (H, W, FOCAL), NEAR, FAR,
            cfgs["unfused"]))
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        log(f"legacy render_nerfw_imgs ({len(poses)} poses at {H}x{W}, "
            f"K5 + K7): {secs / len(poses) * 1e3:.2f} ms a pose, plain "
            f"{secs_plain / len(poses) * 1e3:.2f} ms; rel L2 against plain "
            f"{rel:.3e} (tolerance {PATHS_RTOL:g}), max abs "
            f"{np.abs(got - want).max():.3e}; launches {counts}")
        if not (np.isfinite(got).all() and rel <= PATHS_RTOL):
            raise AssertionError("render_nerfw_imgs disagrees with plain")
        by_path(counts, "legacy render_nerfw_imgs")

        # the losses and their gradients, card against CPU
        rng = np.random.default_rng(0)
        f1, f2 = (rng.normal(size=LEGACY_FEAT).astype(np.float32)
                  for _ in range(2))
        mask = torch.from_numpy(
            (rng.uniform(size=LEGACY_FEAT[1:4]) > 0.3).astype(np.float32))
        losses = {
            "triplet_loss": lt.triplet_loss,
            "hard_negative_mining": lt.triplet_loss_hard_negative_mining,
            "hard_negative_mining_plus":
                lt.triplet_loss_hard_negative_mining_plus,
            "hard_negative_mining_plus (B, ...)": lambda a, b:
                lt.triplet_loss_hard_negative_mining_plus(a[0], b[0]),
            "masked_mse_loss": lambda a, b: lt.masked_mse_loss(
                a[0], b[0], mask.to(a.device)),
        }
        for name, fn in losses.items():
            res = {}
            for d in ("cpu", dev):
                a = torch.from_numpy(f1).to(d).requires_grad_(True)
                b = torch.from_numpy(f2).to(d).requires_grad_(True)
                ms = time_ms(lambda: fn(a, b).backward(), reps=3) \
                    if d == dev else 0.0
                a.grad = b.grad = None
                v = fn(a, b)
                v.backward()
                res[str(d)] = (float(v.detach()), a.grad.cpu(), b.grad.cpu(),
                               ms)
            (vc, ac, bc, _), (vg, ag, bg, ms) = res["cpu"], res[str(dev)]
            rel = abs(vg - vc) / abs(vc)
            grel = max(float((x - y).norm() / y.norm())
                       for x, y in ((ag, ac), (bg, bc)))
            log(f"legacy {name} {tuple(f1.shape)}: {ms:.3f} ms forward + "
                f"backward on the card; card against CPU: value rel "
                f"{rel:.3e}, gradients rel L2 {grel:.3e} (tolerance "
                f"{LEGACY_TOL:g})")
            if not (rel <= LEGACY_TOL and grel <= LEGACY_TOL):
                raise AssertionError(f"legacy {name}: card != CPU")

        # the homography warp of a batch, card against CPU
        imgs = torch.rand((WARP_B, IMG_H * 2, IMG_W * 2, 3),
                          generator=torch.Generator().manual_seed(11))
        imgs_d = imgs.to(dev)
        ms = time_ms(lambda: create_warped_img(imgs_d, WARP_B,
                                               np.random.default_rng(3)))
        got, gh = create_warped_img(imgs_d, WARP_B, np.random.default_rng(3))
        t0 = time.perf_counter()
        want, wh = create_warped_img(imgs, WARP_B, np.random.default_rng(3))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err = (got.cpu() - want).abs().max().item()
        log(f"legacy create_warped_img {tuple(imgs.shape)}: {ms:.3f} ms on "
            f"the card, {cpu_ms:.1f} ms on the host's CPU; homographies "
            f"{'equal' if torch.equal(gh.cpu(), wh) else 'DIFFERENT'}, "
            f"images max abs {err:.3e} (tolerance {LEGACY_WARP_ATOL:g})")
        if not (torch.equal(gh.cpu(), wh) and err <= LEGACY_WARP_ATOL):
            raise AssertionError("create_warped_img: card != CPU")

    phase("legacy", do_legacy)
    return finish(failed, kernels, smi)


@torch.no_grad()
def visible_density(model) -> None:
    """Set a hash field's sigma_out bias to 5 in both towers, a visible
    density as a few hundred steps would give (tests/test_field_zoo.py
    does the same). Its tables start near 0, and so does its ReLU
    density; 1 - exp(-delta sigma) at sigma ~ 1e-5 then keeps few of its
    bits, and the card's exp and the CPU's round them differently."""
    for tower in (model.coarse, model.fine):
        tower.sigma_out.bias[0] = 5.0


def zoo_step(model, rcfg, batch, idx, lr):
    """One random-ray step of a zoo model at flat pixel indices idx (B,
    N) of 60x80 renders: (loss, {name: gradient}, {name: parameter after
    the step})."""
    from nefes_tpu_torch.train import create_train_state, rays_loss
    from nefes_tpu_torch.train.trainer import apply_gradients
    state = create_train_state(model)
    gen = torch.Generator(device=batch["poses"].device).manual_seed(0)
    loss, _ = rays_loss(model, rcfg, batch, idx, gen, (H, W, FOCAL), NEAR,
                        FAR)
    apply_gradients(state, loss, lr)
    return (loss.detach(),
            {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()},
            {k: p.detach() for k, p in model.named_parameters()})


def zoo_step_compare(card_model, cpu_model, rcfg, dev) -> dict:
    """The first step of card_model on the card and of cpu_model (the same
    weights) on the CPU, on TRAIN_B random 60x80 targets (seed 8) at
    ZOO_CHECK_RAYS distinct pixels each, held against how far the CPU's
    own step moves when the poses move by one rounding (times 1 + 2^-23
    x a normal draw, seed 9): the card reaches the CPU's last bits in
    another order (other sums, other roundings in the ray points), and
    the frequency embedding multiplies a point's last bit by up to 2^9
    before its sin / cos, which parts the first layers' gradients by up
    to ~1e-2 (the hash field's grid by its resolution). The loss and all
    parameters after one Adam step (relative L2) must sit within
    ZOO_JITTER_X times the CPU's own move or ZOO_STEP_TOL; each gradient
    (relative L2) within ZOO_JITTER_X times or ZOO_GRAD_TOL, the card's
    scatter-add into the hash tables being unordered. Returns the
    numbers; raises past a tolerance."""
    from nefes_tpu_torch.data.synthetic import look_at_pose
    rng = np.random.default_rng(8)
    eyes = [(2.4 * np.sin(a), 0.3, 2.4 * np.cos(a))
            for a in np.linspace(0.0, 1.2, TRAIN_B)]
    batch = {"rgb": rng.uniform(0, 1, (TRAIN_B, H, W, 3)),
             "poses": np.stack([look_at_pose(np.array(e, np.float32))
                                for e in eyes]),
             "hists": rng.integers(0, 100, (TRAIN_B, 10))}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in batch.items()}
    jittered = dict(batch, poses=batch["poses"] * (1.0 + 2.0 ** -23 * (
        torch.randn(batch["poses"].shape,
                    generator=torch.Generator().manual_seed(9)))))
    idx = torch.from_numpy(np.stack([
        rng.choice(H * W, ZOO_CHECK_RAYS, replace=False)
        for _ in range(TRAIN_B)]))
    jitter_model = copy.deepcopy(cpu_model)
    steps = [zoo_step(model, rcfg, {k: v.to(d) for k, v in b.items()},
                      idx.to(d), TRAIN_LR)
             for model, b, d in ((card_model, batch, dev),
                                 (cpu_model, batch, "cpu"),
                                 (jitter_model, jittered, "cpu"))]
    _, (lh, gh, ph), _ = steps

    def rl2(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).norm() / b.norm()) if b.norm() > 0 else 0.0

    def apart(step) -> dict:
        l, g, p = step
        num = sum(float((p[k].cpu().double() - ph[k].double()).pow(2).sum())
                  for k in ph)
        den = sum(float(ph[k].double().pow(2).sum()) for k in ph)
        return {"loss": abs(float(l) - float(lh)) / abs(float(lh)),
                "grads": {k: rl2(g[k], gh[k]) for k in gh},
                "params": (num / den) ** 0.5,
                "parted": sum(int(((p[k].cpu() - ph[k]).abs()
                                   > 1e-3 * TRAIN_LR).sum()) for k in ph)}
    card, jit = apart(steps[0]), apart(steps[2])

    def tol(x, floor=ZOO_STEP_TOL):
        return max(floor, ZOO_JITTER_X * x)
    worst = max(card["grads"], key=lambda k: card["grads"][k]
                / tol(jit["grads"][k], ZOO_GRAD_TOL))
    res = {"loss": float(lh), "loss_rel": card["loss"],
           "loss_rel_jitter": jit["loss"], "grad_worst": worst,
           "grad_rl2_max": max(card["grads"].values()),
           "grad_rl2": card["grads"][worst],
           "grad_rl2_jitter": jit["grads"][worst],
           "param_rl2": card["params"], "param_rl2_jitter": jit["params"],
           "parted": card["parted"], "parted_jitter": jit["parted"],
           "entries": sum(p.numel() for p in ph.values())}
    if not (card["loss"] <= tol(jit["loss"])
            and card["grads"][worst] <= tol(jit["grads"][worst],
                                            ZOO_GRAD_TOL)
            and card["params"] <= tol(jit["params"])):
        raise AssertionError(f"zoo first step, card against CPU: {res}")
    return res


def finish(failed, kernels, smi) -> int:
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(f"card: {smi}")       # again, beside the results
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [{k: v.get(k) for k in keys}
            | {"path": v.get("path"),
               "launches_by_path": v.get("launches_by_path", {})}
            for v in kernels.values()]
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def key_tree(x):
    """The keys of a JSON value, nested: a dict's as {key: subtree}, a
    list's as its first element's."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list) and x:
        return [key_tree(x[0])]
    return None


def nonfinite(x, path="") -> list:
    """The paths of a JSON value's numbers that are not finite."""
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in nonfinite(v, f"{path}.{k}")]
    if isinstance(x, list):
        return [p for i, v in enumerate(x) for p in nonfinite(v,
                                                              f"{path}[{i}]")]
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return [] if np.isfinite(x) else [path]
    return []


def kernel_label(line: str) -> str:
    """A short name for ptxas's 'Compiling entry function' line: the
    mangled name's kernel, and for the warp-path kernels their dtype, input
    kind and the field forward's mode or, for a render backward, where it
    keeps its per-sample state."""
    import re
    name = line.split("'")[1] if "'" in line else line.strip()
    dt = "bf16" if "nv_bfloat16" in name else "f32"
    if "field_warp_kernel" in name:
        flags = re.findall(r"Lb([01])", name)   # RAW (an earlier tree: HEADS)
        mode = re.findall(r"Li([0-2])E", name)  # MODE
        mode = (MODES[int(mode[0])] if mode else
                "full" if flags[1:2] == ["1"] else "sigma")
        return (f"field_warp_kernel<{dt},"
                f"{'raw' if flags[:1] == ['1'] else 'pre'},{mode}>")
    if "field_bwd_warp_kernel" in name:
        flags = re.findall(r"Lb([01])", name)   # RAW, DW
        mode = re.findall(r"Li([0-2])E", name)  # MODE
        return (f"field_bwd_warp_kernel<{dt},"
                f"{'raw' if flags[:1] == ['1'] else 'pre'},"
                f"{MODES[int(mode[0])] if mode else '?'},"
                f"{'dW' if flags[1:2] == ['1'] else 'frozen'}>")
    if "chain_kernel" in name:
        shape = re.findall(r"Li(\d+)E", name)   # E, W, MT (an earlier tree:
        return (f"chain_kernel<E={shape[0]},W={shape[1]},MT={shape[2]}>"
                if len(shape) == 3 else f"chain_kernel<{dt}>")   # none)
    if "embed_kernel" in name:
        return f"embed_kernel<{dt}>"
    for kern in ("render_bwd_kernel", "render_fwd_kernel"):
        if kern in name:
            flags = re.findall(r"Lb([01])", name)   # RAW, then GLOBAL
            where = (",global" if flags[1:] == ["1"] else ",smem"
                     if flags[1:] else "")
            return (f"{kern}<{dt},"
                    f"{'raw' if flags[:1] == ['1'] else 'pre'}{where}>")
    return name


# each render kernel's entry point: (name, raw, backward)
_RENDER_ENTRY = {"K3 render_fwd_pre": ("nefes_render_fwd_pre", False, False),
            "K4 render_bwd_pre": ("nefes_render_bwd_pre", False, True),
            "K7 render_fwd": ("nefes_render_fwd_raw", True, False),
            "K8 render_bwd": ("nefes_render_bwd_raw", True, True)}


def render_call(lib, name, ins, dev):
    """One launch of render kernel `name` from the fused_render library
    `lib` (this tree's or another's) on the main path's bf16 inputs `ins`
    (the backward with their g_ray), with the arguments the wrappers pass
    but none of their checks or launch counts; its outputs. A backward
    from before the global scratch (no nefes_render_bwd_scratch_bytes)
    takes no scratch argument."""
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.kernels import fused_render as kr
    fn, raw, backward = _RENDER_ENTRY[name]
    pf = ins["packed"][1]
    sp, z, f32 = pf.spec, ins["z"], torch.float32
    R, S = z.shape
    x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"], ins["embd"])
    if backward:
        width, dt = ((3, 3), f32) if raw else ((sp.emb_xyz, sp.emb_dir),
                                               sp.torch_dtype)
        outs = [torch.empty((R * S, n), dtype=dt, device=dev) for n in width]
        outs.append(torch.empty((R, S), dtype=f32, device=dev))
        args = (pf.w, pf.wt, pf.b, *kf.dims(sp), ins["g_ray"])
    else:
        outs = [torch.empty((R, sp.rgbfeat + 2), dtype=f32, device=dev)]
        args = (pf.w, pf.b, *kf.dims(sp))
    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    ptrs = [o.data_ptr() for o in outs]
    if backward and hasattr(lib, "nefes_render_bwd_scratch_bytes"):
        scratch = kr.bwd_scratch(lib, pf, R, S, dev)
        ptrs.append(kf._ptr(scratch))
    err = getattr(lib, fn)(kf._DTYPE_CODE[sp.torch_dtype], R, S,
                           x.data_ptr(), xd.data_ptr(), z.data_ptr(), *args,
                           *ptrs, kf._stream())
    kf.raise_on(err, fn)
    return outs


def field_bwd_call(lib, raw, mode, p, x, xd, g, need_dw, dev, blocks=None,
                   chunk=None):
    """One K2 or (raw) K6 in `mode` from the fused_field library `lib`
    (this tree's or an earlier one's, from the dW kernel on) with the
    wrapper's arguments but none of its checks or launch counts: (d_x,
    d_dirs or None, with need_dw the f32 weight gradients, else None). g:
    the four head cotangents (None where the mode has none). blocks: this
    tree's grid of the warp path through the _grid entry point (0: one
    block per block tile; None: the entry point's own). chunk: the rows of
    a chunk with dW (None: dw_plan's)."""
    from nefes_tpu_torch.kernels import fused_field as kf
    sp, n, nb = p.spec, x.shape[0], p.b.numel()
    widths, hd = (((3, 3), torch.float32) if raw
                  else ((sp.emb_xyz, sp.emb_dir), sp.torch_dtype))
    dx = torch.empty((n, widths[0]), dtype=hd, device=dev)
    dd = (torch.empty((n, widths[1]), dtype=hd, device=dev)
          if mode != kf.SIGMA else None)
    grid = () if blocks is None else (blocks,)
    fn = getattr(lib, f"nefes_field_bwd_{'raw' if raw else 'pre'}"
                 + ("_grid" if grid else ""))
    head = (kf._DTYPE_CODE[sp.torch_dtype], mode, n, x.data_ptr(),
            kf._ptr(xd), p.w.data_ptr(), p.wt.data_ptr(), p.b.data_ptr(),
            *kf.dims(sp), *[kf._ptr(v) for v in g], dx.data_ptr(),
            kf._ptr(dd))

    def bwd(row0, rows, ops, tile_b):
        kf.raise_on(fn(*head, row0, rows, nb, kf._ptr(ops), kf._ptr(tile_b),
                       *grid, kf._stream()), "field_bwd")

    if not need_dw:
        bwd(0, n, None, None)
        return dx, dd, None

    def dw(ops, tile_b, rows, part):
        kf.raise_on(kf.dw_launch(lib, p, mode, ops, tile_b, rows, part,
                                 kf._stream()), "field_dw")
    plan, slices = kf.dw_plan(
        lib, p, mode, n,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = kf.bwd_dw(lib, bwd, dw, p, mode, n, chunk or plan, slices, dev)
    return dx, dd, kf._dw_reduce(lib, part)


# the K2/K6 backwards that the time phase runs in turns with --parent:
# (raw, mode, need_dw); in transient mode on the fine training pass with
# dW and frozen, frozen in full mode on the refinement's fine pass, with
# dW in full mode on the coarse training pass
_BWD_ENTRY = {"K2 field_bwd_pre +dW": (False, "transient", True),
              "K6 field_bwd +dW": (True, "transient", True),
              "K2 field_bwd_pre transient": (False, "transient", False),
              "K6 field_bwd transient": (True, "transient", False),
              "K2 field_bwd_pre": (False, "full", False),
              "K6 field_bwd": (True, "full", False),
              "K6 field_bwd +dW coarse": (True, "full", True)}


def bwd_args(name, ins):
    """(packed, x, dirs, the four head cotangents) of a _BWD_ENTRY on its
    inputs: with dW the training inputs' fine pass (g_f_raw / g_f_pre) or
    coarse pass (g_c_raw), else the main path's (g_field / g_raw)."""
    raw, mode, need_dw = _BWD_ENTRY[name]
    if mode == "transient":
        x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"],
                                                       ins["embd"])
        return ins["packed"][1], x, xd, ins["g_f_raw" if raw else "g_f_pre"]
    if need_dw:
        return (ins["packed"][0], ins["pts_c"], ins["dirs_c"],
                ins["g_c_raw"][:3] + [None])
    x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"], ins["embd"])
    return (ins["packed"][1], x, xd,
            list(ins["g_raw" if raw else "g_field"]) + [None])


def bwd_call(lib, name, ins, dev, blocks=None):
    """One launch (with dW: one per chunk, each with the dW kernel) of the
    _BWD_ENTRY `name` from `lib`: its outputs, those present."""
    raw, mode, need_dw = _BWD_ENTRY[name]
    p, x, xd, g = bwd_args(name, ins)
    out = field_bwd_call(lib, raw, MODES.index(mode), p, x, xd, g, need_dw,
                         dev, blocks)
    return [o for o in out if o is not None]


def bwd_plain(name, ins):
    """The plain version of the _BWD_ENTRY `name` on the same inputs."""
    from nefes_tpu_torch.kernels import fused_field as kf
    raw, mode, need_dw = _BWD_ENTRY[name]
    p, x, xd, g = bwd_args(name, ins)
    plain = kf.field_bwd_plain if raw else kf.field_bwd_pre_plain
    g = g if mode == "transient" else g[:3]
    out = plain(p, MODES.index(mode), x, xd, *g, need_dw=need_dw)
    return [o for o in out if o is not None]


# each field forward that the time phase runs in turns: (entry point,
# raw, mode); sigma mode as the main path's coarse pass runs it, transient
# mode as training's fine pass does
_FIELD_ENTRY = {"K1 field_fwd_pre": ("nefes_field_fwd_pre", False, 0),
                "K5 field_fwd": ("nefes_field_fwd_raw", True, 0),
                "K1 field_fwd_pre transient": ("nefes_field_fwd_pre", False,
                                               2),
                "K5 field_fwd transient": ("nefes_field_fwd_raw", True, 2)}


def field_call(lib, name, ins, dev, blocks=None):
    """One launch of K1 or K5 from the fused_field library `lib` (this
    tree's, or an earlier one's, whose forward takes no wt and no blocks)
    with none of the wrapper's checks or launch counts: in sigma mode on
    the main path's coarse pass (`ins` its inputs), in transient mode on
    training's fine pass (`ins` the training inputs). blocks: this tree's
    grid (None: the wrapper's persistent grid, 0: one block per block
    tile). Returns the mode's heads, [sigma] or [sigma, rgb, feat,
    transient]."""
    from nefes_tpu_torch.kernels import fused_field as kf
    fn, raw, mode = _FIELD_ENTRY[name]
    p = ins["packed"][int(mode == kf.TRANSIENT)]
    sp = p.spec
    if mode == kf.SIGMA:
        x, xd = ins["pts_c"] if raw else ins["emb_c"], None
    else:
        x, xd = (ins["pts"], ins["dirs"]) if raw else (ins["emb"],
                                                       ins["embd"])
    n = x.shape[0]
    outs = kf._fwd_outputs(sp, mode, n, torch.float32 if raw
                           else sp.torch_dtype, dev)
    if hasattr(lib, "nefes_field_smem_bytes"):
        if blocks is None:
            blocks = kf.fwd_blocks(lib, p, mode, raw, n, dev)
        weights, tail = (p.w, p.wt, p.b), (blocks,)
    else:
        weights, tail = (p.w, p.b), ()
    err = getattr(lib, fn)(kf._DTYPE_CODE[sp.torch_dtype], mode, n,
                           x.data_ptr(), kf._ptr(xd),
                           *[t.data_ptr() for t in weights], *kf.dims(sp),
                           *[kf._ptr(o) for o in outs], *tail, kf._stream())
    kf.raise_on(err, fn)
    return [o for o in outs if o is not None]


def traincli_report(what, records, t_end, per_epoch, ray_rays, patch_rays,
                    want_step, pre) -> torch.Tensor:
    """Check and print one CLI run's records (instrumented calls, in
    order): each step's launches against want_step, the validation
    renders' (the forward alone, K1 or K5: sigma and transient mode
    alike); s/step and rays/s of each kind of step from its epochs' wall
    time less the validation renders and checkpoints in them, the first
    epoch excluded; the time of each render call. Returns the steps'
    losses."""
    steps = [r for r in records if r["step"]]
    fwd = "K1 field_fwd_pre" if pre else "K5 field_fwd"
    for r in steps:
        kind = "patch" if r["name"] == "train_step_patch" else "rays"
        if r["counts"] != want_step[(pre, kind)]:
            raise AssertionError(f"{what}: a {kind} step launched "
                                 f"{r['counts']}, expected "
                                 f"{want_step[(pre, kind)]}")
    walls, kinds = [], []
    epochs = [steps[i:i + per_epoch] for i in range(0, len(steps), per_epoch)]
    for k, ep in enumerate(epochs):
        start = ep[0]["t0"]
        end = epochs[k + 1][0]["t0"] if k + 1 < len(epochs) else t_end
        inside = sum(r["t1"] - r["t0"] for r in records
                     if not r["step"] and start <= r["t0"] < end)
        walls.append(end - start - inside)
        kinds.append(ep[0]["name"])
    for name, rays in (("train_step_rays", ray_rays),
                       ("train_step_patch", patch_rays)):
        idx = [k for k, kd in enumerate(kinds) if kd == name]
        if not idx:
            continue
        first_run_epoch = idx[0] == 0
        timed = [k for k in idx if k != 0] or idx
        n_steps = sum(len(epochs[k]) for k in timed)
        sps = sum(walls[k] for k in timed) / n_steps
        note = (f"epochs {idx[0]}-{idx[-1]} of the run" if not
                first_run_epoch else "the first epoch excluded"
                if timed != idx else "the run's only epoch, first-call "
                "costs included")
        log(f"  {name}: {sum(len(epochs[k]) for k in idx)} steps, "
            f"{sps:.4f} s/step, {rays / sps:.1f} rays/s ({n_steps} steps, "
            f"{note}; {rays} rays a step); "
            + (f"first epoch {walls[0]:.3f} s; " if first_run_epoch else "")
            + f"launches a step {steps[[r['name'] for r in steps].index(name)]['counts']}")
    for r in records:
        if r["step"]:
            continue
        c = r["counts"]
        if r["name"] == "save_checkpoint":
            if c:
                raise AssertionError(f"a checkpoint launched {c}")
            continue
        trans = c.get(f"{fwd} transient", 0)
        if set(c) - {fwd, f"{fwd} transient"} or not (
                trans > 0 and c.get(fwd) == 2 * trans):
            raise AssertionError(f"{what}: {r['name']} launched {c}")
        log(f"  {r['name']}: {r['t1'] - r['t0']:.3f} s, launches {c}")
    losses = torch.stack([r["loss"] for r in steps]).float().cpu() \
        if steps else torch.zeros(0)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{what}: non-finite loss")
    if len(losses):
        log(f"  losses: first {[round(float(x), 5) for x in losses[:4]]}, "
            f"last {[round(float(x), 5) for x in losses[-4:]]}")
    return losses


def check_cli_args(exp_dir: Path, keys: set) -> None:
    """args.txt holds one `key = value` line for each option: the JAX
    CLI's and the port's `device` (tests/test_torch_train_cli.py holds the
    set to the JAX CLI's on the CPU)."""
    got = {line.split(" = ")[0]
           for line in (exp_dir / "args.txt").read_text().splitlines()}
    if got != keys:
        raise AssertionError(f"args.txt keys {sorted(got ^ keys)} differ")


def check_cli_run(exp_dir: Path, epochs, ckpt_epochs) -> None:
    """metrics.jsonl holds a line for each epoch with the JAX CLI's keys at
    its stage and a finite loss; ckpts/ the checkpoints of ckpt_epochs,
    the last loadable with its train state."""
    lines = [json.loads(x) for x in
             (exp_dir / "metrics.jsonl").read_text().splitlines()]
    if [r["epoch"] for r in lines] != list(epochs):
        raise AssertionError(f"metrics.jsonl epochs "
                             f"{[r['epoch'] for r in lines]}")
    for r in lines:
        if set(r) != CLI_METRIC_KEYS[r["stage"]] or not np.isfinite(
                r["loss"]):
            raise AssertionError(f"metrics.jsonl line {r}")
    names = sorted(p.name for p in (exp_dir / "ckpts").glob("*")) \
        if (exp_dir / "ckpts").is_dir() else []
    if names != [f"epoch_{e:06d}.pt" for e in ckpt_epochs]:
        raise AssertionError(f"checkpoints {names}")
    if names:
        ck = torch.load(exp_dir / "ckpts" / names[-1], map_location="cpu",
                        weights_only=True)
        if set(ck) != {"model", "optimizer", "epoch"} or \
                ck["epoch"] != ckpt_epochs[-1] + 1:
            raise AssertionError(f"checkpoint {names[-1]}: {sorted(ck)}")
    log(f"  {exp_dir.name}: args.txt, metrics.jsonl ({len(lines)} lines, "
        f"stages {sorted({r['stage'] for r in lines})}), checkpoints "
        f"{names} well formed")


def check_evaluate(exp_dir: Path, step: int, Image) -> None:
    """The validation renders' PNGs of each split: render and ground truth
    at the full image size, disparity at the render size, the feature
    saliency grids; every file readable."""
    for split, views in (("train", 1), ("val", SERVE_FRAMES)):
        d = exp_dir / f"evaluate_{split}_{step:06d}"
        want = {f"{i:03d}{suf}.png" for i in range(views)
                for suf in ("", "_GT", "_disp", "_feature", "_feature_gt")}
        got = {p.name for p in d.iterdir()} if d.is_dir() else set()
        if got != want:
            raise AssertionError(f"{d}: {sorted(got ^ want)}")
        for name in want:
            with Image.open(d / name) as im:
                im.load()
                size = im.size
            full = len(name) == 7 or name.endswith("_GT.png")
            if (full and size != (4 * W, 4 * H)
                    or name.endswith("_disp.png") and size != (W, H)):
                raise AssertionError(f"{d / name}: {size}")
    log(f"  {exp_dir.name}: evaluate_{{train,val}}_{step:06d}: 1 + "
        f"{SERVE_FRAMES} views of PNGs well formed")


def write_7scenes_fixture(root: Path, n_test: int, n_train: int = 2,
                          hw=(480, 640), focal: float = 585.0) -> dict:
    """A 7-Scenes scene "chess" at the real layout and image size, as
    tests/fixture_datasets.py writes it: seq-01 (train) and seq-02 (test)
    of smooth random colour PNGs and c2w pose txts, the split files, the
    COLMAP tables, world_setup.json and the centring stats (frames an
    earlier call left in the sequences are removed). Returns the CLI's
    datadir and data_root."""
    from PIL import Image
    rng = np.random.default_rng(0)
    base = root / "deepslam" / "chess"
    data = root / "data" / "7Scenes" / "chess"
    data.mkdir(parents=True, exist_ok=True)
    base.mkdir(parents=True, exist_ok=True)
    (base / "TrainSplit.txt").write_text("sequence1\n")
    (base / "TestSplit.txt").write_text("sequence2\n")
    for seq, split, count in ((1, "train", n_train), (2, "test", n_test)):
        seq_dir = base / f"seq-{seq:02d}"
        seq_dir.mkdir(exist_ok=True)
        for old in seq_dir.glob("frame-*"):     # an earlier call's count
            old.unlink()
        rows = []
        for i in range(count):
            small = rng.uniform(0, 255, (6, 8, 3))
            img = np.kron(small, np.ones((hw[0] // 6, hw[1] // 8, 1)))
            Image.fromarray(img.astype(np.uint8)).save(
                seq_dir / f"frame-{i:06d}.color.png")
            a = 0.05 * i + 0.3 * seq
            c2w = np.eye(4)
            c2w[:3, :3] = [[np.cos(a), -np.sin(a), 0],
                           [np.sin(a), np.cos(a), 0], [0, 0, 1]]
            c2w[:3, 3] = [0.1 * i, 0.05 * seq, 1.0 + 0.02 * i]
            np.savetxt(seq_dir / f"frame-{i:06d}.pose.txt", c2w)
            R = c2w[:3, :3].T
            w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
            q = [w, (R[2, 1] - R[1, 2]) / (4 * w),
                 (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)]
            rows.append(f"seq-{seq:02d}/frame-{i:06d}.color.png " + " ".join(
                f"{v:.9f}" for v in [*q, *(-R @ c2w[:3, 3]), focal]))
        (base / f"chess_{split}.txt").write_text("\n".join(rows) + "\n")
    (data / "world_setup.json").write_text(json.dumps(
        {"near": 0.3, "far": 4.0, "pose_scale": 1.0, "pose_scale2": 1.0,
         "move_all_cam_vec": [0.0, 0.0, 0.0]}))
    for name in ("pose_avg_stats.txt", "pose_avg_stats_colmap.txt"):
        np.savetxt(data / name, np.eye(4)[:3])
    return {"datadir": str(base), "data_root": str(root / "data")}


def write_reference_tar(path: Path, rng, depth: int = 8, width: int = 128,
                        fdim: int = 128) -> None:
    """torch.save a NeFeS checkpoint at the reference's layout
    (run_nefes.py:375-385: the towers' Sequential keys, fusion_net.net.
    {0,2,4,6,7}, the tcnn exposure MLP's packed buffer), every weight and
    bias N(0, 0.1) from rng (the convs N(0, 0.05), the BN's running
    statistics drawn), as tests/test_nefes_tar.py writes it."""
    def lin(n_in, n_out):
        return (torch.tensor(rng.normal(0, 0.1, (n_out, n_in)),
                             dtype=torch.float32),
                torch.tensor(rng.normal(0, 0.1, n_out), dtype=torch.float32))

    def tower(transient):
        layers = [(f"xyz_encoding_{i}.0", 63 if i == 1 else
                   width + 63 if i == 5 else width, width)
                  for i in range(1, depth + 1)]
        layers += [("xyz_encoding_final", width, width),
                   ("dir_encoding.0", width + 27, width // 2),
                   ("static_sigma.0", width, 1),
                   ("static_rgb.0", width // 2, 3 + fdim)]
        if transient:
            layers += [(f"transient_encoding.{t}",
                        width + 27 if t == 0 else width // 2, width // 2)
                       for t in (0, 2, 4)]
            layers += [(f"transient_{n}.0", width // 2, k)
                       for n, k in (("sigma", 1), ("rgb", 3), ("beta", 1))]
        sd = {}
        for name, n_in, n_out in layers:
            sd[f"{name}.weight"], sd[f"{name}.bias"] = lin(n_in, n_out)
        return sd

    coarse = tower(False)
    chans = [(3 + fdim, 64, 3), (64, 64, 3), (64, 64, 3), (64, fdim, 5)]
    for idx, (ci, co, k) in zip((0, 2, 4, 6), chans):
        coarse[f"fusion_net.net.{idx}.weight"] = torch.tensor(
            rng.normal(0, 0.05, (co, ci, k, k)), dtype=torch.float32)
        coarse[f"fusion_net.net.{idx}.bias"] = torch.zeros(co)
    coarse["fusion_net.net.7.weight"] = torch.ones(fdim)
    coarse["fusion_net.net.7.bias"] = torch.zeros(fdim)
    coarse["fusion_net.net.7.running_mean"] = torch.tensor(
        rng.normal(0, 0.1, fdim), dtype=torch.float32)
    coarse["fusion_net.net.7.running_var"] = torch.tensor(
        rng.uniform(0.5, 1.5, fdim), dtype=torch.float32)
    # tcnn's exposure MLP: 10 -> 32 x 3 -> 12, widths padded to 16
    coarse["exposure_embedding.params"] = torch.tensor(
        rng.normal(0, 0.1, 32 * 16 + 32 * 32 * 2 + 16 * 32),
        dtype=torch.float32)
    torch.save({"global_step": 600, "network_fn_state_dict": coarse,
                "network_fine_state_dict": tower(True),
                "optimizer_state_dict": {}}, path)


def write_reference_dfnet(path: Path, feature_dim: int) -> None:
    """torch.save the port's DFNet (seed 1) under the reference DFNet's
    state-dict keys (feature/dfnet.py: VGG16 at encoder.{idx}, the adapt
    layers at adaptation_layers.adapt_layer_{l}.{0,2,3}, fc_pose):
    features/convert.py's convert_dfnet read backwards."""
    from nefes_tpu_torch.features.convert import VGG16_TORCH_IDX
    from nefes_tpu_torch.features.dfnet import DFNet
    port = DFNet(output_dim=feature_dim, device="cpu",
                 generator=torch.Generator().manual_seed(1)).state_dict()
    names = {name: f"encoder.{idx}" for idx, name in VGG16_TORCH_IDX.items()}
    for lv in range(3):
        base = f"adaptation_layers.adapt_layer_{lv}"
        names.update({f"adapt_{lv}.conv1": f"{base}.0",
                      f"adapt_{lv}.conv2": f"{base}.2",
                      f"adapt_{lv}.bn": f"{base}.3"})
    names["fc_pose"] = "fc_pose"
    sd = {}
    for key, v in port.items():
        mod, leaf = key.rsplit(".", 1)
        sd[f"{names[mod]}.{leaf}"] = v.detach().cpu().clone()
    torch.save(sd, path)


def replace_cfg(cfg, **kw):
    from dataclasses import replace
    return replace(cfg, **kw)


@torch.no_grad()
def aim_apr(kind: str, apr, pose: torch.Tensor) -> None:
    """Aim a zoo APR (seeded random weights) at pose (3, 4), as
    mode2_inputs aims DFNet: its last layer's weights scaled by 1e-2
    and its biases set to what gives pose (MapNet: t and the log quaternion;
    MsTransformer: t and the quaternion in every scene's head, and scene
    0 chosen)."""
    from nefes_tpu_torch.geometry.se3 import rotmat_to_quat
    q = rotmat_to_quat(pose[:, :3])
    if kind == "MapNet":
        v = q[1:]
        logq = v / v.norm().clamp(min=1e-12) * torch.acos(q[0].clamp(max=1))
        outs = ((apr.mapnet.fc_xyz, pose[:, 3]), (apr.mapnet.fc_wpqr, logq))
        for fc, bias in outs:
            fc.weight.mul_(1e-2)
            fc.bias.copy_(bias)
    elif kind == "MsTransformer":
        # scene 0 for every query (equal logits, the argmax's first): a
        # random tower's scene logits lie within 1e-3 of each other, and a
        # change of scene would part the eager and the captured loop
        apr.scene_embed.weight.zero_()
        for head, bias in ((apr.regressor_head_t, pose[:, 3]),
                           (apr.regressor_head_rot, q)):
            head.fc_o_kernel.mul_(1e-2)
            head.fc_o_bias.copy_(bias.expand_as(head.fc_o_bias))
    else:
        apr.fc_pose.weight.mul_(1e-2)
        apr.fc_pose.bias.copy_(pose.reshape(12))


def look_at() -> np.ndarray:
    from nefes_tpu_torch.data.synthetic import look_at_pose
    return look_at_pose(np.array([0.0, 0.3, 2.4], np.float32))


def main_path_inputs(model, pose, dev) -> dict:
    """The kernels' inputs on the refinement's main path, at the true
    pose: every pixel of the H x W render, deterministic samples
    (path_inputs)."""
    from nefes_tpu_torch.geometry.rays import get_rays
    ro, rd = get_rays(H, W, FOCAL, pose[:3, :4])
    return path_inputs(model, ro.reshape(-1, 3), rd.reshape(-1, 3), dev)


def train_poses(dev) -> torch.Tensor:
    """TRAIN_B cameras around the scene, (B, 3, 4)."""
    from nefes_tpu_torch.data.synthetic import look_at_pose
    eyes = [(2.4 * np.sin(a), 0.3, 2.4 * np.cos(a))
            for a in np.linspace(0.0, 1.2, TRAIN_B)]
    return torch.from_numpy(np.stack([look_at_pose(np.array(e, np.float32))
                                      for e in eyes])).to(dev)


def make_train_batch(F: int, dev) -> dict:
    """rgb targets uniform (seed 5), feature targets normal (seed 6), the
    TRAIN_B poses, the rgb targets' luminance histograms."""
    from nefes_tpu_torch.data.scene import compute_histograms
    rgb = torch.rand((TRAIN_B, H, W, 3),
                     generator=torch.Generator().manual_seed(5))
    feat = torch.randn((TRAIN_B, H, W, F),
                       generator=torch.Generator().manual_seed(6))
    hists = torch.from_numpy(compute_histograms(rgb.numpy()))
    return {"rgb": rgb.to(dev), "feat": feat.to(dev),
            "poses": train_poses(dev), "hists": hists.to(dev)}


def make_train_model(dt: str, dev):
    """The training phases' field at full width in dt, seeded weights."""
    from nefes_tpu_torch.kernels import fused_field as kf
    from nefes_tpu_torch.train.model import ModelConfig, NeFeSModel
    return NeFeSModel(ModelConfig(dtype=kf._DTYPES[dt]), device=dev,
                      generator=torch.Generator().manual_seed(0))


def train_render_cfg(model, path: str):
    """The training render config of a path (train_raw: K5 / K6 +dW;
    train_pre: K1 / K2 +dW; train_unfused)."""
    cfg = model.cfg.render_config(n_samples=N_C, n_importance=N_F,
                                  perturb=True, output_transient=True,
                                  remat=False)
    flags = {"train_raw": dict(fused=True, fused_pre=False),
             "train_pre": dict(fused=True, fused_pre=True),
             "train_unfused": {}}[path]
    return replace_cfg(cfg, fused_need_dw=True, **flags)


def gloo_rank(rank: int, address: str, out: str) -> None:
    """One of the multichip phase's 2 gloo ranks on cuda:0: MULTI_STEPS
    sharded f32 train steps (train_raw, images over "data") from the
    train phase's weights, batch and generator seed; rank 0 saves the
    losses and the parameters to out."""
    import torch.distributed as dist
    from nefes_tpu_torch.parallel import (
        init_distributed, make_mesh, make_sharded_train_step, shard_batch,
    )
    from nefes_tpu_torch.train import create_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(rank, 2, address, device="cuda:0",
                           backend="gloo", timeout_s=60.0)
    state = create_train_state(make_train_model("float32", dev))
    mesh = make_mesh()
    step = make_sharded_train_step(
        train_render_cfg(state.model, "train_raw"), mesh, (H, W, FOCAL),
        NEAR, FAR, n_rand=N_RAND, stage=1)
    batch = shard_batch(mesh, make_train_batch(
        state.model.cfg.feature_dim, dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    losses = [step(state, batch, gen, TRAIN_LR)[1]
              for _ in range(MULTI_STEPS)]
    if rank == 0:
        torch.save({"losses": torch.stack(losses).cpu(),
                    "params": torch.cat([p.detach().reshape(-1) for p in
                                         state.model.parameters()]).cpu()},
                   out)
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def train_path_inputs(model, dev) -> dict:
    """The field kernels' inputs on the training path: TRAIN_B images x
    N_RAND random pixels of the H x W render (seed 4), perturbed
    samples."""
    from nefes_tpu_torch.geometry.rays import get_ray_at
    gen = torch.Generator(device=dev).manual_seed(4)
    idx = torch.stack([torch.randperm(H * W, generator=gen, device=dev)
                       [:N_RAND] for _ in range(TRAIN_B)])
    ro, rd = get_ray_at((idx % W).float(), (idx // W).float(), FOCAL, H, W,
                        train_poses(dev))
    return path_inputs(model, ro.reshape(-1, 3), rd.reshape(-1, 3), dev,
                       gen)


def path_inputs(model, ro, rd, dev, gen=None) -> dict:
    """The field kernels' inputs for rays ro, rd (R, 3), made as the
    renderer makes them: coarse points and per-sample directions
    (R·64, 3) with their embeddings (63 and 27), fine points and
    directions (R·128, 3) with theirs, and fine z (R, 128); points and
    directions in f32, embeddings in the model's pack dtype. With `gen`,
    perturbed samples (training), else the deterministic ones."""
    from nefes_tpu_torch.fields.embedder import embed
    from nefes_tpu_torch.kernels.fused_field import field_fwd_pre_plain
    from nefes_tpu_torch.render.compositor import composite
    from nefes_tpu_torch.render.sampling import (
        hierarchical_samples, stratified_samples,
    )
    cfg = model.cfg
    cd = cfg.dtype
    with torch.no_grad():
        packed = model.pack_fused()
        R = ro.shape[0]
        vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
        z = stratified_samples(gen, R, N_C, NEAR, FAR,
                               perturb=gen is not None, device=dev)
        pts = ro[:, None] + rd[:, None] * z[..., None]
        emb_c = embed(pts, cfg.xyz_embed).to(cd).reshape(R * N_C, -1)
        sigma = field_fwd_pre_plain(packed[0], False, emb_c, None)[0]
        w = composite({"static_sigma": sigma.reshape(R, N_C)}, z,
                      sigma_only=True, test_time=True)["weights"]
        zf = hierarchical_samples(gen, z, w, N_F, det=gen is None)
        S = zf.shape[1]
        pf = ro[:, None] + rd[:, None] * zf[..., None]
        emb = embed(pf, cfg.xyz_embed).to(cd).reshape(R * S, -1)
        out = dict(packed=packed, emb_c=emb_c.contiguous(),
                   emb=emb.contiguous(), z=zf.contiguous(),
                   pts_c=pts.reshape(-1, 3).contiguous(),
                   pts=pf.reshape(-1, 3).contiguous())
        for key, n_s in (("", S), ("_c", N_C)):
            d = vd[:, None].expand(R, n_s, 3)
            out["embd" + key] = embed(d, cfg.dir_embed).to(cd).reshape(
                R * n_s, -1).contiguous()
            out["dirs" + key] = d.reshape(R * n_s, 3).contiguous()
    return out


def chain(p, mode, emb, embd, backward, dw=False):
    """Yardstick: the tower's matmuls as a plain bf16 torch.matmul chain
    (cuBLAS), forward and, for a backward, the input-gradient products
    and, with dw, one product per weight for its gradient. mode: 0 sigma,
    1 (or True) full, 2 transient."""
    w, spec = p.weights, p.spec
    h, hs = emb, []
    for i in range(spec.depth):
        z = h @ w[f"l{i}_wh" if i else "l0_we"]
        if i and i in spec.skips:
            z = z + emb @ w[f"l{i}_we"]
        h = torch.relu(z)
        hs.append(h)
    out = [h @ w["sig_w"]]
    if mode:
        fin = h @ w["fin_w"]
        de = torch.relu(fin @ w["dir_wh"] + embd @ w["dir_wd"])
        out.append(de @ w["rgb_w"])
    if mode == 2:
        ts = [torch.relu(fin @ w["t1_wh"] + embd @ w["t1_wd"])]
        for n in ("t2", "t3"):
            ts.append(torch.relu(ts[-1] @ w[f"{n}_w"]))
        heads = [ts[-1] @ w[f"{n}_w"] for n in ("ts", "tr", "tb")]
        out += heads
    if not backward:
        return out
    dws = []

    def grad(act, g):
        if dw:
            dws.append(act.t() @ g)

    g = out[1]
    grad(de, g)
    g = g @ w["rgb_w"].t()
    grad(fin, g)
    grad(embd, g)
    g_fin = g @ w["dir_wh"].t()
    g_embd = g @ w["dir_wd"].t()
    if mode == 2:
        gt = sum(hd @ w[f"{n}_w"].t() for hd, n in zip(heads, ("ts", "tr",
                                                             "tb")))
        for hd in heads:
            grad(ts[2], hd)
        for n, act in (("t3", ts[1]), ("t2", ts[0])):
            grad(act, gt)
            gt = gt @ w[f"{n}_w"].t()
        grad(fin, gt)
        grad(embd, gt)
        g_fin = g_fin + gt @ w["t1_wh"].t()
        g_embd = g_embd + gt @ w["t1_wd"].t()
    grad(h, g_fin)
    grad(h, out[0])
    dh = g_fin @ w["fin_w"].t() + out[0] @ w["sig_w"].t()
    d_emb = 0
    for i in range(spec.depth - 1, -1, -1):
        dz = dh * (hs[i] > 0)
        grad(hs[i - 1] if i else emb, dz)
        if i == 0:
            d_emb = d_emb + dz @ w["l0_we"].t()
        else:
            dh = dz @ w[f"l{i}_wh"].t()
            if i in spec.skips:
                grad(emb, dz)
                d_emb = d_emb + dz @ w[f"l{i}_we"].t()
    return d_emb, g_embd, dws


def event_ms(fn) -> float:
    """One call of fn, timed with CUDA events (ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` timed calls (CUDA events) after two warm calls."""
    for _ in range(2):
        fn()
    return statistics.median(event_ms(fn) for _ in range(reps))


if __name__ == "__main__":
    sys.exit(main())
