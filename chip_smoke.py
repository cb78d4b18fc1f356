#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (imageclassification_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its lines; any failure ends the script with a non-zero
exit before the last line:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build every kernel of the port from csrc/ (nvcc, sm_90a), timed;
3. each kernel against its plain PyTorch version on the same seeded inputs,
   in the layout the main path gives it (q, k, v strided out of one fused
   qkv tensor), at the main path's shape and larger ones, with the kernel's,
   the plain version's and one PyTorch library call's times (CUDA events,
   median, host cost of each call included) beside the least time the card
   could take (the bound), and the factor kernel ms / library ms, for the
   bf16 kernels and again for the fp32 ones (tolerances 2^-14 and 2^-12 of
   max|ref| against the plain version with TF32 off, SDPA in fp32): 3a the
   forward, 3b the backward (the dQ kernel, which also writes di, then the
   dK/dV kernel; and the forward's lse): one launch of each and no other
   kernel in its trace, two runs bitwise equal, its device time against
   SDPA's backward (forward + backward less forward) and the factor; the
   fp32 rows' bounds at three TF32 passes on the tensor cores, the FFMA
   bound beside them, and SDPA's fp32 backward kernels and its error against
   the same plain reference logged (not held);
   each kernel's device time from a trace;
   3c the LayerNorm kernels (forward, backward) at ConvNeXt-T's four stage
   shapes, the head's and a ragged ViT row count, and on constant rows, the
   backward run twice and held bitwise equal, with F.layer_norm's kernel
   and device ms and the factors on both, each wrapper's host cost a call,
   and the forward wrapper's host steps timed one by one; 3d
   the depthwise-conv kernels (forward, dx, dw) at ConvNeXt-T's four stage
   shapes, dw also run twice and held bitwise equal, each with its device
   ms and cuDNN's (F.conv2d(groups=C) and its two backward convolutions)
   and the factors; 3e the fused 1x1 conv + BN statistics kernel at
   ResNet-50's 1x1 shapes (both variants, and the ragged M = 3136 that the
   Pallas kernel refuses), run twice and held bitwise equal, with cuBLAS
   `x @ w` and the unfused chain as yardsticks, in kernel and device ms;
4. the serving path: a seeded JAX-format ViT-B/16 checkpoint trained with
   --flash_attn (random weights) and a seeded 5-class image folder go through
   `val_precision` and `val_move` on cuda at batch 64 (predict captured as a
   CUDA graph at its first batch); the probabilities are held against the
   same model on the plain attention path and against the eager predict; a
   torch.profiler trace shows 12 forward launches in each replayed batch,
   and traces of the forward (captured and eager, flash and plain) give
   device time by kernel and the idle share;
5. the training path: `imageclassification_tpu_torch.train.main` trains
   ViT-B/16 --flash_attn at 224x224, batch 64, with the default training
   flags, for 2 epochs of 10 steps on a seeded 5-class folder of 750 images
   (two eager steps, then the step captured and replayed); every step's
   loss must be finite, the run's own captured step is replayed three more
   times under a trace, which must show each replay launch the forward 12
   times (with lse), the dQ and dK/dV kernels 12 times each and the forward
   12 times (without lse, the exact-mode accuracy forward) in that order
   (the wrappers' counters, which a replay does not advance, count only the
   eager steps and the captures), and checkpoint-1.pth must be in the JAX
   layout and load in the port's val.py;
   5b. on the trained weights: ms per train step and img/s (CUDA events over
   one fixed batch) and a torch.profiler trace, captured and eager, with
   flash on and off (with the backward kernels' device ms a step), and the
   flash path's gradients of one step held against the plain attention path
   and fp32 on the same weights, batch and draws;
   5c. six ViT-B/16 --flash_attn steps at full width (drop path 0.1, the
   default flags, the EMA with warmup) eager twice and captured once, each
   from one seeded state and seeded generators: the captured run must equal
   the eager one bitwise where the two eager runs are equal (else differ by
   no more than they do); then a step with the head bias set to inf inside
   the captured run's replays must leave parameters, EMA, moments and count
   bitwise as they were, and the next step apply;
   5d. the fp32 path of --flash_attn: `train.main` with --half_precision
   false on the same folder (1 epoch of 10 steps), captured; a trace of its
   step must show 12 + 12 forwards, 12 dQ and 12 dK/dV, every one the fp32
   kernel (the forward of csrc/flash_attention_f32.cu, dQ and dK/dV of
   csrc/flash_attention_f32_bwd.cu), and the bf16 kernels' counts stay 0;
   its step timed captured and eager, with fp32 K1's device ms a step from
   the trace; the checkpoint served by
   val_precision (bf16 compute, as the JAX val.py), and an fp32 served
   batch (`val.initialize_model(half_precision=False)`, captured): 12 fp32
   forwards a replay, probabilities against the fp32 plain attention path;
6. the ConvNeXt-T training path: `train.main --model convnext_tiny` at
   224x224, batch 64, the default training flags, 2 epochs of 10 steps on the
   folder of phase 5; losses finite, no kernel launched (the model runs
   F.conv2d and its fp32 LayerNorm, as the JAX model runs lax.conv and
   nn.LayerNorm), checkpoint-1.pth in the JAX layout, reloaded exactly and
   served by val_precision; ms per step, img/s and a trace of train steps,
   captured and eager;
   6b. one train step on the trained weights with every LayerNorm (23) and
   depthwise conv (18) captured, and each captured tensor run through the
   kernels (the launches of the new kernels' rows), held against the
   model's own outputs and gradients and against the plain versions;
7. the ResNet-50 training path: `train.main --model resnet50` at 224x224,
   batch 64, the default training flags, 2 epochs of 10 steps on the folder
   of phase 5; losses finite, no kernel launched (the model runs F.conv2d
   and its BatchNorm, as the JAX model runs lax.conv and nn.BatchNorm),
   checkpoint-1.pth in the JAX layout with batch_stats, reloaded exactly
   (weights and statistics) and served by val_precision; ms per step, img/s
   and a trace of train steps, captured and eager;
   7b. one train step on the trained weights with every conv captured, and
   its 36 1x1 convs run through the fused kernel (20 plain: conv1 and the
   downsamples; 16 with the prologue: conv3 on relu(bn2(conv2 out))), held
   against the model's own conv outputs and BatchNorm batch statistics and
   against the plain version;
   7c. the port bench (`imageclassification_tpu_torch.bench`) at batch 128:
   its JSON line (the captured step), and ms per step and a trace of its
   step, captured and eager;
8. the fine-tuning path: a seeded port vit_base_patch16_224 of 1000
   classes saved with torch.save (timm names, zip) stands in for a hub file,
   and `train.main --model vit_base_patch16_224 --flash_attn true
   --input_size 384 --pretrained_path <file>` trains from it with the
   default flags, batch 64, 1 epoch of 10 steps (cut from 2 for the command's
   time) on the folder of phase 5: the load prints the pos_embed resample 14x14 -> 24x24
   and `Skipping
   mismatched key:` for the head alone, every other parameter equals the
   file's and pos_embed a plain fp32 antialiased bicubic resample of the
   file's; losses finite; three replays of the run's captured step launch
   the flash kernels at N = 577 as in phase 5 (24 forwards, 12 dQ, 12
   dK/dV); checkpoint-0.pth holds input_shape 384 and val_precision serves
   it at 384 (predict captured: 12 forward launches a replayed batch);
   ms per batch, ms per step and img/s, captured and eager, with traces;
   the flash kernels against their plain versions and SDPA at the path's
   shape, 64 x 577 x 12 x 64, as in 3a and 3b (right after 3b, before the
   training phases);
9. the CLI's default model: `train.main` with no --model (EfficientViT-M0,
   its head's dropout from --drop_path) at 224x224, batch 64, the default
   flags, 1 epoch of 10 steps (cut from 2 for the command's time) on the folder of phase 5;
   losses finite, no kernel launched (the model runs F.conv2d, its
   BatchNorm and plain attention, as the JAX model runs lax.conv,
   nn.BatchNorm and einsums), checkpoint-0.pth in the JAX layout with
   batch_stats, reloaded exactly and
   served by val_precision; ms per step, img/s and a trace, captured and
   eager;
10. the high-resolution path: the same hub file through `train.main
   --flash_attn true --input_size 1024 --layer_decay 0.65 --remat true` (the
   default adamw) at batch 16, or 8 where an eager step without --remat at
   16 runs out of memory, 1 epoch of 10 steps (cut from 2 for the command's time) on a seeded
   5-class folder of
   1280 x 960 JPEGs fed by the port's native decoder (phases 10 and 11 run
   in a child process, whose profiler is fresh; it first finds the batch
   and holds the flash kernels against their plain versions and SDPA at the
   path's shape, 16 x 4097 x 12 x 64, the fp32 plain versions a few batch
   elements at a time, on the empty card); the load resamples
   pos_embed 14x14 -> 64x64 and skips the head alone; three replays of the
   run's captured step launch the flash kernels at N = 4097 24 times
   forward with lse (the forward and its recompute), 12 x (dQ, dK/dV) and
   12 forwards without lse, in that order; val_precision serves the
   checkpoint at 1024; the captured step with and without --remat, each its
   ms a step, peak memory (torch.cuda.max_memory_allocated) and a trace;
   the flash kernels' device ms a launch inside the --remat step (held
   against its CUDA events, and each to half its CUDA events alone at that
   shape) beside their bounds; the peak memory of one eager ViT-B/16 step
   at 224x224 with dropout and drop path 0.1, which may be no more than 1 %
   higher with --remat than without; four captured steps with --remat and
   --layer_decay held against eager ones bitwise, and a non-finite step
   inside the replays, as in 5c;
11. the feed: `BatchLoader` img/s at batch 64, 224x224, on the train path
   over 500 x 375 JPEGs with the native decoder and with PIL at 8 and 32
   threads, one pass each, and the host's os.cpu_count() (`feed_epochs`,
   train.main's epochs on those JPEGs split into steps, loader waits, eval
   and checkpoint writes, no longer runs here, for the command's time);
12. the training recipes, in a child process (`--recipes`, a fresh
   profiler as for phases 10-11), on phase 5's checkpoint-1.pth and folder:
   12a. `train.main` of ViT-B/16 --flash_attn with --aa
   rand-m9-mstd0.5-inc1 and distillation from that checkpoint
   (--teacher_path, --distillation_alpha 0.5, --distillation_tau 2.0) at
   224x224, batch 64, 1 epoch of 10 steps (cut from 2 for the command's
   time): losses finite, three replays of the run's captured step launch
   per replay 12 forwards with lse (the student), 12 without (the
   teacher), 12 x (dQ, dK/dV), 12 without lse (the accuracy forward), in
   that order, and checkpoint-0.pth loads in the port's val.py; captured
   and eager ms a step of the recipe's step, and the device ms (traces) of
   the augmentation with the policy and with ColorJitter and of the
   teacher's forward, each alone;
   12b. each policy alone (rand-m9-mstd0.5-inc1, rand-m9-n3-mstd0.5,
   original, v0, abel-n2) at batch 64 x 224x224, against the port on the
   CPU with the same draws copied over (every value to 1e-3 but at most
   1e-3 of them), a captured run equal to the eager
   one bitwise, and ms a batch eager and captured beside ColorJitter's;
   12c. phase 5's checkpoint with the 50 % smallest |w| of each eligible
   weight zeroed (numpy here, written by the port's checkpoint/io.py), then
   `train.main --pretrained_path <it> --prune_mask true --flash_attn true
   --model_ema true` for 1 epoch of 10 steps: printed sparsity 0.50 +-
   0.01, every pruned entry of the model and the EMA in checkpoint-0.pth
   exactly 0, some other entry moved; captured and eager ms a step;
13. the rest of the model registry and of the optimizer table, in a child
   process (`--registry`, a fresh profiler as for phases 10-12), on phase
   5's folder at its cell's shape (224x224, batch 64, default flags), one
   epoch of 10 steps each, every run through `train.main`, captured:
   13a. ViT-B/16 --flash_attn with --opt nvnovograd and with --opt
   adafactor: three replays of each run's captured step launch 24 forwards
   (12 with lse), 12 dQ and 12 dK/dV each, read from traces; the
   checkpoint's optimizer state in the optax layout (nvnovograd's nu a
   scalar a JAX tensor, adafactor's factored v_row / v_col); with each,
   4 captured steps (cut from 6 for the command's time) held against 4
   eager ones with a non-finite step inside the replays, as 5c (for the
   command's time, the steps are no longer timed here);
   13b. ConvNeXt-T with --opt adahessian (the Hutchinson diagonal from a
   second backward at every step): the same checks but the launches (no
   kernel), with 3 captured steps against 3 eager ones; ViT-B/16
   --flash_attn true --opt adahessian refused before its first step (its
   ~1 s step is no longer timed here, for the command's time);
   13c. Swin-T (starting from a seeded timm-layout state_dict through
   --pretrained_path), MobileNetV3-Large, EfficientNet-B0 and DenseNet-121
   at full width: no kernel launched, the checkpoint in the JAX layout that
   the torch converter gives, reloaded exactly and served by val_precision
   (captured); ms a served batch (the steps no longer timed here, for the
   command's time);
14. int8 serving and the checkpoint tools, in a child process
   (`--lifecycle`, a fresh profiler as for phases 10-13), on a seeded
   ViT-B/16 --flash_attn checkpoint of 1000 classes with an EMA and a seeded
   ConvNeXt-T, phase 5's folder: 14a. the port's `modelchange --mode
   quantize --dtype int8`, then `val_precision` on it (the raw int8 weights):
   the int8 kernels kept (JAX's rule), one torch._int_mm a layer (no float
   fallback), 12 flash forwards in each replayed batch (trace), the
   probabilities and argmax agreement against the bf16 model of the source
   checkpoint, ms a captured batch of 64 int8 and bf16; each int8 product at
   ViT-B/16's four Linear shapes (and the head's at batch 8, padded) equal to
   the CPU's int32 matmul, with its device ms beside the bf16 product's and
   their bounds, and whether cuBLASLt takes a row-major second operand;
   14b. `ema2model` (the model equals the source's EMA), `prune` (sparsity
   0.50) and `aot` export of the source: the program reloaded equals the
   live model on zeros and launches the flash forward 12 times a call; 14c.
   Grad-CAM (the JAX layer pick; fp32, as visualize.py loads every model:
   12 fp32 forwards, 1 dQ and 1 dK/dV a batch of 8 on the ViT) and summary
   through the visualize CLI on both models;
15. UPerNet segmentation in one process, in a child process
   (`--segmentation <dir> <out.json>`, the way to run it alone): the port's
   `seg_train.main` on the tiny ADE20K recipe at full width (ConvNeXt-T,
   channels 512, crop 512, batch 16, 150 classes), 10 iterations with whole
   eval every 5 (cut from 20 and 10 for the command's time), on a seeded
   synthetic folder in the mmseg layout; losses finite, checkpoint-iter10.pth
   in the JAX layout and reloaded exactly;
   slide eval and ms eval (6 scales x flip, on 1 image) of the trained
   model with their mIoU; ms an eager iteration, peak memory and a trace;
   one iteration's backbone LayerNorms and depthwise convs replayed through
   K3, K4 and K5 and held against the model's results, and those kernels
   timed at the backbone's four stage shapes beside F.layer_norm and cuDNN;
16. data-parallel training (ROADMAP A9), in a child process
   (`--distributed <dir> <out.json>`, the way to run it alone): 16a.
   `train.main` on ViT-B/16 --flash_attn (1 epoch of 4 steps at batch 64)
   under torchrun's environment for a world of one prints "Not using
   distributed mode", runs captured and equals a plain launch bitwise
   (every loss, every parameter); 16b. two processes share the card, each a
   rank of a gloo group (NCCL refuses two ranks on one device; gloo reduces
   CUDA tensors through the host; `--dp-worker`), and run the port's
   data-parallel step on ViT-B/16 --flash_attn at full width, bf16, local
   batch 32, mixup and cutmix on, drop path 0, --update_freq 2, SGD, 3
   optimizer steps (cut from 4 for the command's time): the ranks bitwise equal, held against one process on
   the global batch of 64 (losses 2^-7 relative, the updates 2^-5 in
   relative L2 and of the largest update), the wrappers' K1 launches a step
   on each rank (counted from 0 over the steps) and from a trace, each
   rank's ms a step labelled as not a multi-GPU number; 16c. the same on
   ResNet-50 at local batch 16, 2 steps, its BatchNorm statistics over the
   global batch held too. One pair of ranks runs 16b then 16c; it starts and
   joins its group while 16a runs, and steps after it. No multi-GPU or NCCL
   number exists here;
17. one JSON line with every kernel's numbers (at ConvNeXt-T's stage-0
   shape for the LayerNorm and depthwise-conv kernels and ResNet-50's
   stage-1 conv3 shape for the fused 1x1 conv; the other shapes are in the
   lines of phases 3c, 3d and 3e; the flash kernels' numbers on the
   fine-tuning path under "at_577", on the high-resolution path under
   "at_4097" and their launches on phase 12's paths under "recipe" and
   "prune" and on phase 13a's under "nvnovograd" and "adafactor"), phase
   12's summary under "recipes", phase 13's under "registry" and phase 14's
   under "lifecycle", the flash kernels' launches on phase 14's paths under
   "int8_serving", "gradcam" (on the fp32 kernels' entries) and "export";
   the fp32 kernels' entries (3a, 3b at 64 x 197; their launches over phase
   5d's run; their other shapes under "shapes"; "bound_ffma_ms" beside
   "bound_ms"; the forward, dQ and dK/dV marked "redesigned" with their
   "design", and the backward's SDPA error as "library_max_abs_err"); K3-K5
   on phase 15's replay under "upernet"; phase 15's summary under
   "segmentation"; the bf16 K1 kernels' launches on phase 16b's ranks under
   "data_parallel", phase 16's summary under "data_parallel"), then the
   result line {"ok": true, "device": {...}}.

`python3 chip_smoke.py --compare-f32-forward <checkout>` runs nothing of the
above: it holds the fp32 forward kernel of another checkout (built from its
csrc/) and this checkout's against the plain version at phase 3a's shapes
and times them in one process, in turns (`compare_f32_forward`).

Phase 2 also builds the port's native JPEG decoder and says whether it
built; the training phases say which decoder fed them. A device ms read
from traces, of a kernel or of a library call, is held against the CUDA
events time of the same call (`_device_ms`, `_library_device_ms`).

It exits non-zero without the result line when no CUDA device is visible.
The JAX package is not imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace
from unittest import mock

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core flop/s and fp32 flop/s on the CUDA cores (FMA counted as two),
# the denominators of `bound_ms`
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 66.9e12
# fp32-grade products on the tensor cores: each as three TF32 products (the
# operands' tf32 heads and tails, hi*hi + hi*lo + lo*hi, as
# csrc/flash_attention_f32_bwd.cu runs them) at the published 495 TFLOP/s of
# TF32: the least time the card could take for fp32 K1's products
TF32_3PASS_FLOPS_PER_S = 495e12 / 3

ATTN_SHAPES = [(64, 197, 12, 64), (16, 577, 12, 64), (2, 4097, 12, 64)]
MAIN_SHAPE = ATTN_SHAPES[0]  # ViT-B/16 at 224x224, batch 64
# bf16 output against the fp32 plain version: a tolerance of ATTN_RTOL times
# max|reference| at each shape. bf16 keeps 8 significant bits, so rounding the
# output costs up to 2^-8 of the largest value and rounding P before P.V about
# as much again; 2^-7 covers both.
ATTN_RTOL = 2.0 ** -7
# backward kernels (bf16 dq, dk, dv) against the fp32 plain version: a
# tolerance of ATTN_BWD_RTOL times max|reference| per gradient. On top of the
# output's rounding (2^-8 of the largest value), P and dS are rounded to bf16
# before their products, and dS = P (dP - di) takes a difference whose terms
# each carry the inputs' rounding; 2^-6 covers those, and each check proves
# the tolerance lies below what dropping the last key changes.
ATTN_BWD_RTOL = 2.0 ** -6
# fp32 kernels (csrc/flash_attention_f32.cu, csrc/flash_attention_f32_bwd.cu)
# against the fp32 plain version with TF32 off: 2^-14 of max|reference| for
# the output and 2^-12 for each gradient, 128x and 64x below the bf16
# tolerances. Every product of both is three TF32 passes (~21 bits); one
# TF32 pass (unit roundoff 2^-11) cannot meet them
ATTN_F32_RTOL = 2.0 ** -14
ATTN_F32_BWD_RTOL = 2.0 ** -12
# the K1 kernels by part; a dtype's kernels and launch counts carry the
# suffix that ops/flash_attention.py gives it (`k1_dtype`)
K1_PARTS = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
            "dkv": "flash_attention_bwd_dkv"}
# the forward's lse (fp32 sums of exp2) against logsumexp of the fp32 scores
LSE_ATOL = 1e-3
# bf16 model (flash path) against the same weights in fp32 on the plain
# attention path: bf16 rounding over 12 blocks of activations, 5-class
# probabilities
PROBS_ATOL = 5e-2
# an fp32 served batch, the fp32 flash path against the same fp32 weights on
# the plain attention path: both fp32 throughout, only the order of sums
# differs; 5-class probabilities
FP32_PROBS_ATOL = 1e-4
# one train step's gradients, bf16 flash path against the same weights, batch
# and draws in fp32 (plain attention) and in bf16 on the plain attention path:
# relative global L2 error ||g - ref|| / ||ref||. bf16 keeps 8 bits (2^-8 ~
# 4e-3 per rounding), and the roundings of activations over 12 blocks forward
# and back partly cancel in the global norm: 1.8e-3 flash vs fp32 and 3.2e-4
# flash vs plain on the H100 after 20 steps; 1e-2 leaves a margin of 5x
GRAD_RTOL = 1e-2

# LayerNorm and depthwise-conv kernels (bf16 outputs) against their plain
# versions (fp32 math on the same bf16 inputs): the kernel rounds its fp32
# result to bf16 once (2^-8 of the largest value) and sums in another order;
# 2^-7 of max|reference|
OP_RTOL = 2.0 ** -7
# fp32 sums over every row (LayerNorm dgamma, dbeta) against the plain
# version's: only the order of up to 200,704 terms differs; 1e-4 of
# max|reference|
SUM_RTOL = 1e-4
# the kernels against the ConvNeXt-T train step's own results on the same
# tensors (F.layer_norm in fp32 rounded to bf16; cuDNN's bf16 depthwise conv
# and its gradients): each side rounds an fp32 result to bf16 once (2^-8 of
# the largest value each) and the model's conv output also its bf16 bias add;
# 2^-6 covers three roundings. dgamma and dbeta are fp32 on both sides, but
# F.layer_norm takes its statistics by another algorithm than E[x^2] - E[x]^2
# and sums in another order: 1e-3 of max|reference|
MODEL_RTOL = 2.0 ** -6
MODEL_SUM_RTOL = 1e-3
# the replays' column sums (dgamma, dbeta over every row of a train step,
# phases 6b and 15) are held per column to the rtol above plus this many fp32
# units (2^-24) of the column's sum of |terms|: the rounding of two orders of
# summation and of two ways to the statistics (a few units of xhat) scale with
# the terms, not with the sum, and where the terms cancel (the bias gradients
# of the UPerNet backbone's stage-0 and stage-1 out norms, ~1e-10) the sum is
# all rounding. 64 units of a column of N = 262,144 random-signed terms are
# about one term's mean |term|; a row tile left out moves it by about
# sqrt(rows of the tile) terms
SUM_ROUNDING_UNITS = 64
# ConvNeXt-T at batch 64, 224x224: (rows, C) of the LayerNorms at the four
# stages and the head, and ViT-B/16's token LayerNorm at batch 64 (64 * 197
# rows: no Pallas row block divides it)
LN_SHAPES = [(200704, 96), (50176, 192), (12544, 384), (3136, 768), (64, 768), (64 * 197, 768)]
DW_SHAPES = [(64, 56, 56, 96), (64, 28, 28, 192), (64, 14, 14, 384), (64, 7, 7, 768)]

# the training path: ViT-B/16, 224x224, batch 64, 2 epochs of 10 steps on a
# 5-class folder of 150 images per class (the default 0.9 split keeps 135 per
# class for training: 675 // 64 = 10 steps)
TRAIN = dict(img=224, batch=64, epochs=2, num_classes=5, per_class=150)

VIT_B16 = dict(name="vit_base_patch16", dim=768, depth=12, heads=12, patch=16)
# timm convnext_tiny: dims 96/192/384/768, depths 3/3/9/3
CONVNEXT_T = dict(name="convnext_tiny", depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
# torchvision resnet50: Bottleneck blocks 3/4/6/3, width 64
RESNET50 = dict(name="resnet50", stage_sizes=(3, 4, 6, 3), block="Bottleneck", width=64)
# MSRA efficientvit_m0, the CLI's default model
EFFICIENTVIT_M0 = dict(name="efficientvit_m0", embed_dims=(64, 128, 192), depths=(1, 2, 3),
                       num_heads=(4, 4, 4))
# fine-tuning: timm vit_base_patch16_224 saved at 224x224 and trained at
# 384x384, batch 64: 24 x 24 patches and the cls token, N = 577 in every
# flash launch
FINETUNE = dict(name="vit_base_patch16_224", src_img=224, img=384, batch=64)
# pos_embed after the load against a plain fp32 antialiased bicubic resample
# of the file's on the card (the load resamples on the CPU): the same
# function in another order, on values of magnitude ~0.04; fp32 rounding
POS_EMBED_ATOL = 1e-6

# ResNet-50 at batch 64, 224x224: (M, K, N, prologue) of the fused 1x1 conv +
# BN statistics kernel at each stage, conv3 (its input relu(bn2(conv2 out)):
# the prologue variant) and conv1 (plain), and the last stage's strided
# downsample; M = 3136 is not a multiple of 128, which the Pallas kernel
# refuses
K2_SHAPES = [(200704, 64, 256, True), (200704, 256, 64, False), (50176, 128, 512, True),
             (50176, 512, 128, False), (12544, 256, 1024, True), (12544, 1024, 256, False),
             (3136, 512, 2048, True), (3136, 2048, 512, False), (3136, 1024, 2048, False)]


_T0 = time.perf_counter()  # this process's start, for `stamp`


def log(msg: str) -> None:
    print(msg, flush=True)


def stamp(label: str) -> None:
    """A line with the seconds since this process started, at a phase's start."""
    log(f"[{time.perf_counter() - _T0:.1f} s] {label}")


def jax_vit_params(rng: np.random.Generator, dim: int, depth: int, heads: int,
                   patch: int, img: int, num_classes: int, head_std: float = 0.1):
    """Flat parameters in the JAX package's ViT checkpoint layout
    ("block{i}/MultiHeadDotProductAttention_0/query/kernel" [E, H, hd], ...),
    drawn from `rng`: kernels N(0, 0.02), biases N(0, 0.01), LayerNorm
    scales 1 + N(0, 0.01), a head of std `head_std`."""
    hd = dim // heads
    tokens = (img // patch) ** 2 + 1
    shapes = {
        "cls_token": (1, 1, dim),
        "pos_embed": (1, tokens, dim),
        "patch_embed/kernel": (patch, patch, 3, dim),
        "patch_embed/bias": (dim,),
        "norm/scale": (dim,), "norm/bias": (dim,),
        "head/kernel": (dim, num_classes), "head/bias": (num_classes,),
    }
    for i in range(depth):
        b = f"block{i}"
        a = f"{b}/MultiHeadDotProductAttention_0"
        for p in ("query", "key", "value"):
            shapes[f"{a}/{p}/kernel"] = (dim, heads, hd)
            shapes[f"{a}/{p}/bias"] = (heads, hd)
        shapes[f"{a}/out/kernel"] = (heads, hd, dim)
        shapes[f"{a}/out/bias"] = (dim,)
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            shapes[f"{b}/{ln}/scale"] = (dim,)
            shapes[f"{b}/{ln}/bias"] = (dim,)
        shapes[f"{b}/Mlp_0/Dense_0/kernel"] = (dim, 4 * dim)
        shapes[f"{b}/Mlp_0/Dense_0/bias"] = (4 * dim,)
        shapes[f"{b}/Mlp_0/Dense_1/kernel"] = (4 * dim, dim)
        shapes[f"{b}/Mlp_0/Dense_1/bias"] = (dim,)
    flat = {}
    for k, shape in shapes.items():
        std = head_std if k == "head/kernel" else (0.01 if k.endswith("bias") else 0.02)
        flat[k] = (std * rng.standard_normal(shape)).astype(np.float32)
        if k.endswith("scale"):
            flat[k] += 1.0
    return flat


def write_checkpoint(out_dir: str, rng, model: dict, img: int, num_classes: int) -> str:
    """A checkpoint as the JAX train.py writes it for --flash_attn, plus the
    class_indices.json it writes beside it."""
    os.makedirs(out_dir, exist_ok=True)
    ck = {
        "format_version": 1,
        "model_spec": {"name": model["name"],
                       "kwargs": {"num_classes": num_classes, "flash_attn": True}},
        "step": 0, "epoch": 0, "input_shape": [1, img, img, 3],
        "num_classes": num_classes, "args": {},
        "model": jax_vit_params(rng, model["dim"], model["depth"], model["heads"],
                                model["patch"], img, num_classes),
    }
    path = os.path.join(out_dir, "checkpoint-0.pth")
    with open(path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(out_dir, "class_indices.json"), "w") as f:
        json.dump({str(i): f"class_{i}" for i in range(num_classes)}, f)
    return path


def write_image_folder(root: str, rng, num_classes: int, per_class: int) -> int:
    """root/class_{c}/img_{i}.{jpg,png}: a per-class tint plus noise, sizes
    160-320 px, alternating JPEG and PNG."""
    from PIL import Image

    for c in range(num_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        tint = rng.integers(0, 256, 3)
        for i in range(per_class):
            h, w = rng.integers(160, 321, 2)
            arr = np.clip(tint + rng.normal(0, 60, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img_{i}.{'jpg' if i % 2 else 'png'}"))
    return num_classes * per_class


def time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _rate(dtype: str, ffma: bool = False) -> tuple:
    """(bytes an element, flop/s) of K1 in `dtype`: bf16 on the tensor cores;
    fp32 as three TF32 passes on the tensor cores, or with `ffma` on the CUDA
    cores (fp32 K1's yardstick until its kernels ran on the tensor cores,
    kept beside the other)."""
    if dtype == "bf16":
        return 2, BF16_FLOPS_PER_S
    return 4, FP32_FLOPS_PER_S if ffma else TF32_3PASS_FLOPS_PER_S


def attention_bound(B, N, H, D, dtype: str = "bf16", ffma: bool = False):
    """(bound_ms, bound_by): q, k, v read once and o written once in `dtype`,
    against 4*B*H*N^2*D flops (two products) at `dtype`'s rate (`_rate`)."""
    itemsize, rate = _rate(dtype, ffma)
    t_bytes = 4 * B * N * H * D * itemsize / HBM_BYTES_PER_S
    t_flops = 4 * B * H * N * N * D / rate
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


# the most fp32 scores [b, H, N, N] a plain attention call may hold at once
PLAIN_SCORE_BYTES = 4 << 30


def by_batch(fn, *tensors):
    """fn(*tensors) over slices of the batch (dim 0) whose plain fp32 scores
    stay under PLAIN_SCORE_BYTES, the results concatenated: the same function
    in pieces, every row independent of the others (at 16 x 4097 x 12 heads
    the scores alone take 13 GB). `tensors[0]` is q, [B, N, H, D]."""
    import torch

    B, N, H = tensors[0].shape[:3]
    chunk = max(1, PLAIN_SCORE_BYTES // (H * N * N * 4))
    if chunk >= B:
        return fn(*tensors)
    parts = [fn(*(t[i:i + chunk] for t in tensors)) for i in range(0, B, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def compare_attention(out, q, k, v, rtol: float = ATTN_RTOL):
    """Hold `out` against the fp32 plain version on the same inputs, with a
    tolerance of rtol * max|reference| (ATTN_RTOL for bf16). Also checks that the tolerance
    lies below what leaving out the last key changes in the reference: a
    ragged tail of one key is the tail a kernel masks wrongly most easily, and
    a tolerance above that change could not see the fault. Returns
    (max_abs_err, tol, tail_change); raises when either check fails."""
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention_ref

    qf, kf, vf = (t.float() for t in (q, k, v))
    ref = by_batch(flash_attention_ref, qf, kf, vf)
    tail = (by_batch(flash_attention_ref, qf, kf[:, :-1], vf[:, :-1]) - ref).abs().max().item()
    tol = rtol * ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not tail > tol:
        raise AssertionError(f"attention shape {tuple(q.shape)}: tolerance {tol} does not "
                             f"see a dropped last key (changes the output by {tail})")
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"attention shape {tuple(q.shape)}: max|d|={err} > {tol}")
    return err, tol, tail


def _check_fp32_reference(dtype: str) -> None:
    """The fp32 plain version is the yardstick of the fp32 kernels only with
    TF32 off for its matmuls (full fp32, cuBLAS's "highest")."""
    import torch

    if dtype == "fp32" and (torch.backends.cuda.matmul.allow_tf32
                            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("the fp32 plain version needs TF32 off for its matmuls")


def check_attention(shape, device, dtype: str = "bf16"):
    """Kernel vs plain version (and the SDPA yardstick) at one shape, on q, k, v
    of `dtype` ("bf16" or "fp32": the kernels of that dtype) read strided out
    of one [B, N, 3, H, D] tensor as ViT's fused qkv gives them."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import flash_attention as fa

    _check_fp32_reference(dtype)
    B, N, H, D = shape
    g = torch.Generator(device=device).manual_seed(N)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=device)
    q, k, v = qkv.to(k1_dtype(dtype)[0]).unbind(2)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    rtol = ATTN_RTOL if dtype == "bf16" else ATTN_F32_RTOL
    err, tol, tail = compare_attention(out, q, k, v, rtol)
    iters = max(5, min(200, int(2e9 // (B * H * N * N * D))))
    ms = time_ms(lambda: fa.flash_attention(q, k, v), iters)
    plain_ms = time_ms(lambda: by_batch(fa.flash_attention_ref, q, k, v), max(3, iters // 10))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)

    library_ms = time_ms(sdpa, iters)
    bound_ms, bound_by = attention_bound(B, N, H, D, dtype)
    device_ms = _device_ms(lambda: fa.flash_attention(q, k, v), {k1_kernels(dtype)["fwd"]: 1},
                           events_ms=ms)
    library_device_ms = _library_device_ms(sdpa, events_ms=library_ms)
    row = dict(shape=list(shape), max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               device_ms=device_ms, library_device_ms=library_device_ms,
               host_ms=host_ms(lambda: fa.flash_attention(q, k, v)))
    ffma = ""
    if dtype == "fp32":
        row["bound_ffma_ms"] = attention_bound(B, N, H, D, dtype, ffma=True)[0]
        ffma = f" (three TF32 passes; at the FFMA rate {row['bound_ffma_ms']:.4f} ms)"
    log(f"{K1_PARTS['fwd']}{k1_dtype(dtype)[1]} {dtype} B,N,H,D={shape} "
        f"(strided qkv): max|d| vs fp32 plain {err:.3e} (tol {tol:.3e} = "
        f"2^{round(math.log2(rtol))} of max|ref|; dropping the last key moves "
        f"the reference by {tail:.3e}), kernel {ms:.4f} ms (device {device_ms:.4f}), plain "
        f"{plain_ms:.4f} ms, sdpa {dtype} {library_ms:.4f} ms (device {library_device_ms:.4f}), "
        f"kernel/sdpa {ms / library_ms:.3f} (device {device_ms / library_device_ms:.3f}), "
        f"bound {bound_ms:.4f} ms ({bound_by}){ffma}, bound/device {bound_ms / device_ms:.3f}")
    return row


def backward_bound(B, N, H, D, part="all", dtype: str = "bf16", ffma: bool = False):
    """(bound_ms, bound_by) of the attention backward. 'all': the function,
    q, k, v, o, dO and lse read and dq, dk, dv written (bf16; lse fp32), and
    its five products S, dP, dV, dK, dQ (10*B*H*N^2*D flops); 'two_kernel':
    the same bytes and the seven products of the two-kernel design (S and dP
    in both kernels); 'dq': q, k, v, o, dO and lse in, dq and di (fp32) out,
    products S, dP, dQ; 'dkv': q, k, v, dO, lse and di in, dk and dv out,
    products S, dP, dV, dK. The tensors in `dtype` at its rate (`_rate`)."""
    tensors, stats, products = {"all": (8, 1, 5), "two_kernel": (8, 1, 7), "dq": (6, 2, 3),
                                "dkv": (6, 2, 4)}[part]
    itemsize, rate = _rate(dtype, ffma)
    t_bytes = (tensors * B * N * H * D * itemsize + stats * B * H * N * 4) / HBM_BYTES_PER_S
    t_flops = products * 2 * B * H * N * N * D / rate
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def compare_backward(grads, q, k, v, do, rtol: float = ATTN_BWD_RTOL, others=None):
    """Hold the kernels' (dq, dk, dv) against the fp32 plain backward on the
    same inputs, each with a tolerance of rtol * max|reference| (ATTN_BWD_RTOL
    for bf16), and
    check that each tolerance lies below what leaving out the last key
    changes in that reference gradient: every row of dq moves through the
    softmax, and dk and dv lose the last key's row (counted as zeros, as a
    kernel that drops the key leaves it; their other rows barely move at
    large N). Returns {name: (max_abs_err, tol, tail_change)}; raises when a
    check fails. With `others` ({label: (dq, dk, dv)}), returns also
    {label: {name: max_abs_err}} against the same reference, held to
    nothing."""
    import torch

    from imageclassification_tpu_torch.ops import flash_attention as fa

    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))

    def plain_one(qq, kk, vv, dd):
        return fa.flash_attention_bwd_ref(qq, kk, vv, fa.flash_attention_ref(qq, kk, vv),
                                          fa.flash_attention_lse_ref(qq, kk), dd)

    def plain(kk, vv):
        return by_batch(plain_one, qf, kk, vv, dof)

    ref, tail = plain(kf, vf), plain(kf[:, :-1], vf[:, :-1])
    out = {}
    for name, g, r, t in zip(("dq", "dk", "dv"), grads, ref, tail):
        dropped = torch.zeros_like(r)
        dropped[:, : t.shape[1]] = t
        tail_change = (dropped - r).abs().max().item()
        tol = rtol * r.abs().max().item()
        err = (g.float() - r).abs().max().item()
        if not tail_change > tol:
            raise AssertionError(f"attention backward {tuple(q.shape)} {name}: tolerance {tol} "
                                 f"does not see a dropped last key (changes it by {tail_change})")
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"attention backward {tuple(q.shape)} {name}: "
                                 f"max|d|={err} > {tol}")
        out[name] = (err, tol, tail_change)
    if others is None:
        return out
    return out, {label: {name: (g.float() - r).abs().max().item()
                         for name, g, r in zip(("dq", "dk", "dv"), grads_other, ref)}
                 for label, grads_other in others.items()}


def k1_dtype(dtype: str) -> tuple:
    """(torch dtype, the suffix of its K1 kernels' names and launch counts)
    of `dtype`, "bf16" or "fp32"."""
    import torch

    from imageclassification_tpu_torch.ops.flash_attention import _COUNT_SUFFIX

    torch_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    return torch_dtype, _COUNT_SUFFIX[torch_dtype]


def k1_kernels(dtype: str) -> dict:
    """The K1 kernels of `dtype` by part, as their launches are named in a
    trace."""
    sfx = k1_dtype(dtype)[1]
    return {part: f"{base}{sfx}_kernel" for part, base in K1_PARTS.items()}


def check_backward(shape, device, dtype: str = "bf16"):
    """The backward kernels of `dtype` (and the forward's lse) against their
    plain versions at one shape, on q, k, v read strided out of one fused qkv
    tensor: one backward is one launch of each kernel by the counts and the
    only kernels in its trace (di included), and two runs give the same
    bits. Kernel ms (both, and each alone; CUDA events), device ms (both and
    each, from traces), plain ms, the SDPA backward's ms and device ms
    (forward + backward less forward) and the bounds."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import flash_attention as fa

    _check_fp32_reference(dtype)
    names = k1_kernels(dtype)
    torch_dtype, suffix = k1_dtype(dtype)
    B, N, H, D = shape
    g = torch.Generator(device=device).manual_seed(N + 1)
    qkv = torch.randn((B, N, 3, H, D), generator=g, device=device).to(torch_dtype)
    q, k, v = qkv.unbind(2)
    do = torch.randn((B, N, H, D), generator=g, device=device).to(torch_dtype)
    o, lse = fa._launch(q, k, v, with_lse=True)
    lse_err = (lse - by_batch(fa.flash_attention_lse_ref, q, k)).abs().max().item()
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"forward lse {shape}: max|d| {lse_err} > {LSE_ATOL}")
    fa.reset_launches()
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    counts = (getattr(fa.flash_attention, f"launches_dq{suffix}"),
              getattr(fa.flash_attention, f"launches_dkv{suffix}"))
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    if counts != (1, 1):
        raise AssertionError(f"attention backward {shape}: launches (dq, dkv) {counts}, "
                             "expected one of each")
    for name, a, b in zip(("dq", "dk", "dv"), grads, again):
        if not torch.equal(a, b):
            raise AssertionError(f"attention backward {shape}: {name} differs between two runs")
    rtol = ATTN_BWD_RTOL if dtype == "bf16" else ATTN_F32_BWD_RTOL
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt), (qt, kt, vt), dot)

    sdpa = {}
    if dtype == "fp32":
        # SDPA's own fp32 backward against the same plain reference, and the
        # kernels it runs, logged beside the kernels (SDPA is held to nothing)
        sdpa_grads = tuple(t.transpose(1, 2) for t in sdpa_fwd_bwd())
        errs, other_errs = compare_backward(grads, q, k, v, do, rtol, {"sdpa": sdpa_grads})
        sdpa = {"errs": other_errs["sdpa"],
                "kernels": sorted(trace(sdpa_fwd_bwd, steps=3)[2])}
        del sdpa_grads
    else:
        errs = compare_backward(grads, q, k, v, do, rtol)
    bwd_kernels = (names["dq"], names["dkv"])

    def bwd():
        return fa.flash_attention_bwd(q, k, v, o, lse, do)

    others = [name for name in trace(bwd, steps=3)[2]
              if not any(kernel in name for kernel in bwd_kernels)]
    if others:
        raise AssertionError(f"attention backward {shape}: kernels besides the two in its "
                             f"trace: {others}")
    iters = max(5, min(200, int(1e9 // (B * H * N * N * D))))
    ms = time_ms(bwd, iters)
    strides = fa._bwd_inputs(q, k, v, o, lse, do)[1]
    _, di = fa._launch_dq(q, k, v, o, do, lse, strides)
    alone = {"dq": lambda: fa._launch_dq(q, k, v, o, do, lse, strides),
             "dkv": lambda: fa._launch_dkv(q, k, v, do, lse, di, strides)}
    ms_dq, ms_dkv = time_ms(alone["dq"], iters), time_ms(alone["dkv"], iters)
    # each kernel alone's host ms and events ms on the same calls: its floor
    # in the backward's trace (`alone_floor`, held to the lesser events ms)
    pairs = {part: host_and_events_ms(fn) for part, fn in alone.items()}
    host_each = {part: host for part, (host, _) in pairs.items()}
    plain_ms = time_ms(lambda: by_batch(fa.flash_attention_bwd_ref, q, k, v, o, lse, do),
                       max(3, iters // 10))
    device_ms = _device_ms(bwd, {name: 1 for name in bwd_kernels}, events_ms=ms)
    device_each = {part: _device_ms(bwd, {names[part]: 1}, floor_ms=alone_floor(
                       min(events, pairs[part][1]), host_each[part]))
                   for part, events in (("dq", ms_dq), ("dkv", ms_dkv))}
    sdpa_ms = time_ms(sdpa_fwd, iters)
    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd, iters)
    sdpa_device = _library_device_ms(sdpa_fwd, events_ms=sdpa_ms)
    sdpa_fwd_bwd_device = _library_device_ms(sdpa_fwd_bwd, events_ms=sdpa_fwd_bwd_ms)
    row = dict(shape=list(shape), lse_err=lse_err, errs=errs, ms=ms, ms_dkv=ms_dkv,
               ms_dq=ms_dq, host_ms_dq=host_each["dq"], host_ms_dkv=host_each["dkv"],
               plain_ms=plain_ms, library_ms=sdpa_fwd_bwd_ms - sdpa_ms,
               device_ms=device_ms, device_ms_dq=device_each["dq"],
               device_ms_dkv=device_each["dkv"],
               library_device_ms=sdpa_fwd_bwd_device - sdpa_device,
               bounds={part: backward_bound(B, N, H, D, part, dtype)
                       for part in ("all", "two_kernel", "dq", "dkv")})
    ffma = ""
    if dtype == "fp32":
        row["bounds_ffma"] = {part: backward_bound(B, N, H, D, part, dtype, ffma=True)
                              for part in ("all", "two_kernel", "dq", "dkv")}
        row["library_errs"] = sdpa["errs"]
        ffma = (" (three TF32 passes; at the FFMA rate " + ", ".join(
            f"{p} {b:.4f} ms" for p, (b, _) in row["bounds_ffma"].items()) + ")")
        log(f"sdpa fp32 backward B,N,H,D={shape}: kernels {sdpa['kernels']}; max|d| vs the "
            f"same fp32 plain reference " + ", ".join(
                f"{n} {e:.3e} (the kernels' tol {errs[n][1]:.3e})"
                for n, e in sdpa["errs"].items()) + " (logged, not held)")
    log(f"flash_attention_bwd{suffix} {dtype} B,N,H,D={shape} (strided qkv): forward lse "
        f"max|d| {lse_err:.3e} (tol {LSE_ATOL}); " + "; ".join(
            f"{n} max|d| {e:.3e} (tol {t:.3e} = 2^{round(math.log2(rtol))} of max|ref|; "
            f"dropping the last key moves it by {c:.3e})" for n, (e, t, c) in errs.items())
        + "; one launch each of dQ and dK/dV, no other kernel in the trace; two runs "
          "bitwise equal")
    log(f"flash_attention_bwd{suffix} {dtype} B,N,H,D={shape}: kernels {ms:.4f} ms (dQ "
        f"{ms_dq:.4f}, dK/dV "
        f"{ms_dkv:.4f}; di included, wrapper checks in the first), device {device_ms:.4f} ms "
        f"(dQ {device_each['dq']:.4f}, dK/dV {device_each['dkv']:.4f}), plain {plain_ms:.4f} "
        f"ms, sdpa backward {row['library_ms']:.4f} ms (fwd+bwd {sdpa_fwd_bwd_ms:.4f} - fwd "
        f"{sdpa_ms:.4f}), device {row['library_device_ms']:.4f} ms (fwd+bwd "
        f"{sdpa_fwd_bwd_device:.4f} - fwd {sdpa_device:.4f}); kernels/sdpa "
        f"{ms / row['library_ms']:.3f}, device {device_ms / row['library_device_ms']:.3f}; "
        "bound " + ", ".join(f"{p} {b:.4f} ms ({by})" for p, (b, by) in row["bounds"].items())
        + ffma + f"; bound/device {row['bounds']['all'][0] / device_ms:.3f} (five products), "
        f"{row['bounds']['two_kernel'][0] / device_ms:.3f} (seven)")
    return row


def trace(fn, steps: int = 10):
    """Trace `steps` calls of fn() with torch.profiler, after one untraced
    call. Returns (wall ms per call from CUDA events, device ms per call
    summed over kernels, {kernel name: (ms per call, launches per call)},
    busy ms per call: the union of the kernels' intervals, which is less than
    their sum where kernels overlap, as some of a CUDA graph's do)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
    kernels, spans = {}, []
    for e in prof.events():
        # device-side ranges of user annotations (Optimizer.step#AdamW.step)
        # span kernels that are counted on their own
        if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False):
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
            spans.append((e.time_range.start, e.time_range.end))
    per_call = {name: (us / 1e3 / steps, n / steps) for name, (us, n) in kernels.items()}
    return (start.elapsed_time(end) / steps, sum(ms for ms, _ in per_call.values()),
            per_call, busy_us(spans) / 1e3 / steps)


def busy_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def run_main_path(work: str, device: str, model: dict, img: int, num_classes: int,
                  per_class: int, batch: int, seed: int = 0):
    """The serving path through the port's val.py on `device`. Returns a dict
    of launch counts per run, timings and the probability check."""
    import torch

    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention, reset_launches

    rng = np.random.default_rng(seed)
    ckpt = write_checkpoint(os.path.join(work, "ckpt"), rng, model, img, num_classes)
    images = os.path.join(work, "images")
    n_images = write_image_folder(images, rng, num_classes, per_class)
    n_batches = math.ceil(n_images / batch)
    res = {"n_images": n_images, "n_batches": n_batches}

    reset_launches()
    t0 = time.perf_counter()
    tp, fp, fn = val.val_precision(images, ckpt, img, model_ema=True, batch_size=batch,
                                   device=device)
    res["val_precision_s"] = time.perf_counter() - t0
    res["launches_val_precision"] = flash_attention.launches
    if not (tp.sum() + fp.sum() == n_images and tp.sum() + fn.sum() == n_images):
        raise AssertionError(f"val_precision counts do not cover {n_images} images: "
                             f"tp={tp} fp={fp} fn={fn}")

    move_src = os.path.join(work, "triage", "incoming")
    os.makedirs(move_src)
    for d in sorted(os.listdir(images)):
        for f in sorted(os.listdir(os.path.join(images, d))):
            shutil.copy(os.path.join(images, d, f), os.path.join(move_src, f"{d}_{f}"))
    reset_launches()
    t0 = time.perf_counter()
    val.val_move(move_src, ckpt, img, model_ema=True, batch_size=batch, device=device)
    res["val_move_s"] = time.perf_counter() - t0
    res["launches_val_move"] = flash_attention.launches
    moved = sum(len(os.listdir(os.path.join(work, "triage", d))) for d in ("Empty", "NonEmpty"))
    if os.listdir(move_src) or moved != n_images:
        raise AssertionError(f"val_move moved {moved} of {n_images} images")

    # steady-state forward of one full batch; the flash path held against the
    # plain attention path of the same weights, in bf16 and in fp32; on a card
    # the predict functions are captured, and the flash path's eager predict
    # runs beside its captured one
    m_flash, _ = val.initialize_model(ckpt, True, device=device)
    predict = {"flash": val._predict_fn(m_flash)}
    for name, half in (("plain", True), ("fp32", False)):
        m = create_model(model["name"], num_classes=num_classes, half_precision=half,
                         img_size=img).to(device).eval()
        m.load_state_dict(m_flash.state_dict())
        predict[name] = val._predict_fn(m)
    eager = getattr(predict["flash"], "eager", predict["flash"])
    paths = [os.path.join(images, d, f) for d in sorted(os.listdir(images))
             for f in sorted(os.listdir(os.path.join(images, d)))][:batch]
    _, imgs = next(val._batched(paths, img, batch, torch.device(device)))
    p = {name: fn(imgs) for name, fn in predict.items()}
    if p["flash"].shape != (batch, num_classes) or not torch.isfinite(p["flash"]).all():
        raise AssertionError(f"bad probabilities: shape {tuple(p['flash'].shape)}")
    res["probs_flash_vs_plain"] = (p["flash"] - p["plain"]).abs().max().item()
    res["probs_flash_vs_fp32"] = (p["flash"] - p["fp32"]).abs().max().item()
    res["probs_plain_vs_fp32"] = (p["plain"] - p["fp32"]).abs().max().item()
    res["probs_captured_vs_eager"] = (p["flash"] - eager(imgs)).abs().max().item()
    res["argmax_agree_fp32"] = (p["flash"].argmax(-1) == p["fp32"].argmax(-1)).float().mean().item()
    if res["probs_flash_vs_fp32"] > PROBS_ATOL:
        raise AssertionError(f"flash-path probabilities differ from fp32 by "
                             f"{res['probs_flash_vs_fp32']} > {PROBS_ATOL}")
    if device == "cuda":
        timed = {"flash captured": predict["flash"], "flash eager": eager,
                 "plain captured": predict["plain"]}
        res["ms_per_batch_captured"] = time_ms(lambda: timed["flash captured"](imgs), iters=10)
        res["ms_per_batch_eager"] = time_ms(lambda: timed["flash eager"](imgs), iters=10)
        res["trace"] = {name: trace(lambda: fn(imgs)) for name, fn in timed.items()}
        res["per_replay"] = replay_launches(lambda: predict["flash"](imgs),
                                            ["fwd"] * model["depth"])
    return res


def log_trace(label: str, tr, per: str) -> None:
    wall_ms, device_ms, kernels, busy_ms = tr
    log(f"trace, {label}: wall {wall_ms:.3f} ms/{per} (profiler on), device {device_ms:.3f} "
        f"ms/{per} (summed over kernels), busy {busy_ms:.3f} ms/{per} (their union), idle "
        f"share {1 - busy_ms / wall_ms:.3f}; device time by kernel per {per}:")
    for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {ms:8.4f} ms {ms / device_ms:6.1%} {n:5.1f} launches  {k[:100]}")


def _launch_counts(dtype: str = "bf16"):
    """The wrappers' launch counts of the K1 kernels of `dtype`."""
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention as f

    sfx = k1_dtype(dtype)[1]
    return {"fwd": getattr(f, f"launches{sfx}"), "fwd_lse": getattr(f, f"launches_lse{sfx}"),
            "bwd_dkv": getattr(f, f"launches_dkv{sfx}"), "bwd_dq": getattr(f, f"launches_dq{sfx}")}


def flash_kernel_names(fn) -> set:
    """The names of the K1 kernels in a trace of three calls of fn()."""
    return {name for name in trace(fn, steps=3)[2]
            if any(k in name for k in FLASH_KINDS)}


def check_flash_dtype(fn, dtype: str, what: str) -> set:
    """Raise unless every K1 kernel in a trace of fn() is one of `dtype`'s
    (and there is one); returns their names."""
    names = flash_kernel_names(fn)
    want = k1_kernels(dtype).values()
    if not names or not all(any(w in name for w in want) for name in names):
        raise AssertionError(f"{what}: K1 kernels in the trace {sorted(names)}, expected only "
                             f"the {dtype} ones {list(want)}")
    return names


def _train_main(work: str, images: str, flags: list):
    """train.main on the folder `images` with `flags`, every step's metrics
    recorded by wrapping the step that the epoch loop is given (the captured
    step on a card) and read after main returns. Returns (state, args,
    records, wall seconds, the step)."""
    from imageclassification_tpu_torch import train as port_train

    args = port_train.parse_args([
        "--data_path", images, "--pretrained", "false", *flags,
        "--output_dir", os.path.join(work, "train_cls", "output"),
        "--log_dir", os.path.join(work, "train_cls", "log_dir"), "--num_workers", "8",
    ])
    metrics, steps = [], []
    loop = port_train.train_one_epoch

    def recording_loop(train_step, *a, **kw):
        steps.append(train_step)

        def recorded(state, batch):
            m = train_step(state, batch)
            metrics.append(m)
            return m

        return loop(recorded, *a, **kw)

    port_train.train_one_epoch = recording_loop
    try:
        t0 = time.perf_counter()
        state = port_train.main(args)
        wall_s = time.perf_counter() - t0
    finally:
        port_train.train_one_epoch = loop
    records = [{"loss": float(m["loss"]), "skipped": float(m["skipped"])} for m in metrics]
    losses = [r["loss"] for r in records]
    if not (losses and all(math.isfinite(x) for x in losses)
            and not any(r["skipped"] for r in records)):
        raise AssertionError(f"training losses not all finite: {losses}")
    return state, args, records, wall_s, steps[-1]


# the flash kernels of one ViT train step in the order the device runs them:
# the forward with lse (12 blocks), the backward (per block the dQ kernel,
# which writes di, then dK/dV), the exact-mode accuracy forward without lse
FLASH_KINDS = {base: part for part, base in K1_PARTS.items()}


def flash_step_pattern(depth: int, remat: bool = False, teacher: bool = False) -> list:
    """With --remat the backward first runs the whole forward again (with
    lse), so the forward is launched 2 * depth times before the first dQ;
    with a --flash_attn teacher (distillation), its eval forward (without
    lse) runs after the student's forward: depth more forwards before the
    first dQ."""
    before = depth * ((2 if remat else 1) + (1 if teacher else 0))
    return ["fwd"] * before + ["dq", "dkv"] * depth + ["fwd"] * depth


def flash_kernel_sequence(fn, calls: int):
    """The flash kernels of `calls` calls of fn() as a torch.profiler trace
    holds them, in device order (one untraced call first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    seq = []
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        kind = next((v for k, v in FLASH_KINDS.items() if k in e.name), None)
        if kind is not None:
            seq.append((e.time_range.start, kind))
    return [kind for _, kind in sorted(seq)]


def replay_launches(fn, pattern: list, calls: int = 3, traces: int = 5) -> list:
    """The flash kernels each call of fn() launches, read from traces of
    `calls` calls (not from the wrappers' counters, which a replay of a CUDA
    graph does not advance): the first trace holding `pattern` once a call.
    A trace may drop launches (`_device_ms`), so up to `traces` are taken;
    raises when none holds the pattern, with what each held."""
    seen = []
    for _ in range(traces):
        seq = flash_kernel_sequence(fn, calls)
        if seq == pattern * calls:
            return [Counter(seq[i * len(pattern):(i + 1) * len(pattern)]) for i in range(calls)]
        seen.append(Counter(seq))
    raise AssertionError(f"no trace of {calls} calls held {Counter(pattern)} a call: {seen}")


def _train_images(work: str, num_classes: int, per_class: int, seed: int) -> str:
    images = os.path.join(work, "train_images")
    if not os.path.isdir(images):
        write_image_folder(images, np.random.default_rng(seed), num_classes, per_class)
    return images


def run_training(work: str, device: str, model: dict, img: int, num_classes: int,
                 per_class: int, batch: int, epochs: int, seed: int = 0,
                 images: str = None, pretrained_path: str = None, flags: tuple = (),
                 dtype: str = "bf16"):
    """The training path through the port's train.main on `device`, on a
    seeded image folder (`images`, written when not given), with the default
    training flags and --flash_attn. Every step's metrics are recorded, the
    wrappers' launch counts read around the run (on a card: the eager
    warm-up steps' and the captures'; a replay does not advance them), and
    on a card the flash kernels of three more calls of the run's own step
    read from a trace: every call must launch the forward 12 times with lse,
    the backward's dQ and dK/dV kernels 12 times each and the forward 12
    times without lse, in that order (with --remat among `flags`, the
    extra flags, the forward 24 times with lse first; with a teacher, its
    12 forwards without lse before the first dQ). With
    `pretrained_path` the run starts from that file (--pretrained_path).
    With `dtype` "fp32" the run passes --half_precision false: its counts
    are the fp32 kernels', the bf16 kernels' stay 0, and on a card every
    K1 kernel of the replayed steps' trace must be an fp32 one.
    Returns a dict: the trained state,
    the args, the per-step records, the launch totals of the run, the
    launches a replay made, the checkpoint checks and timings."""
    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    images = images or _train_images(work, num_classes, per_class, seed)
    extra, flags = flags, ["--model", model["name"], "--flash_attn", "true", "--input_size", str(img),
             "--batch_size", str(batch), "--epochs", str(epochs), "--warmup_epochs", "1",
             "--device", device]
    if pretrained_path:
        flags += ["--pretrained", "true", "--pretrained_path", pretrained_path]
    if dtype == "fp32":
        flags += ["--half_precision", "false"]
    flags += list(extra)
    reset_launches()
    state, args, records, wall_s, step = _train_main(work, images, flags)
    totals = _launch_counts(dtype)
    other = _launch_counts("fp32" if dtype == "bf16" else "bf16")
    out = args.output_dir
    if not (all(totals.values()) if device == "cuda" else not any(totals.values())) \
            or any(other.values()):
        # on the CPU the plain versions run, no kernel
        raise AssertionError(f"{device} {dtype} training run, flash launches {totals}, of the "
                             f"other dtype's kernels {other}")

    # the last epoch's checkpoint: the JAX layout, and the port's val.py reads
    # it back to the very weights the run ended with
    path = os.path.join(out, f"checkpoint-{epochs - 1}.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    want = jax_vit_params(np.random.default_rng(0), model["dim"], model["depth"],
                          model["heads"], model["patch"], img, num_classes)
    got = {k: v.shape for k, v in ck["model"].items()}
    if got != {k: v.shape for k, v in want.items()}:
        raise AssertionError(f"{path}: parameters not in the JAX layout")
    check_optimizer_state(path, ck["optimizer"], got, args.opt, len(records))
    loaded, _ = val.initialize_model(path, model_ema=False, device=device)
    carried = max((loaded.state_dict()[k] - v).abs().max().item()
                  for k, v in state.model.state_dict().items())
    if carried != 0.0:
        raise AssertionError(f"{path}: reloaded weights differ from the run's by {carried}")
    per_replay = None
    if device == "cuda":  # three more steps of the run's own (captured) step
        fixed = _fixed_batch({"args": args, "images": images}, device)
        distill = bool(args.teacher_path) and args.distillation_alpha > 0
        per_replay = replay_launches(lambda: step(state, fixed),
                                     flash_step_pattern(model["depth"], args.remat, distill))
        check_flash_dtype(lambda: step(state, fixed), dtype, "the run's captured step")
    return {"state": state, "args": args, "records": records, "totals": totals,
            "per_replay": per_replay, "wall_s": wall_s, "checkpoint": path, "images": images,
            "steps_per_epoch": len(records) // epochs, "num_classes": num_classes,
            "input_shape": ck["input_shape"]}


def _factored(shape) -> tuple:
    """optax adafactor's choice for a JAX tensor (written out here): the
    axes of its second largest and largest dims when the second is at least
    128, else None."""
    order = np.argsort(shape)
    return (int(order[-2]), int(order[-1])) if len(shape) > 1 and \
        shape[order[-2]] >= 128 else None


def check_optimizer_state(path: str, opt_state: dict, params: dict, opt: str, count: int):
    """A checkpoint's optimizer state in the JAX optax layout of --opt `opt`
    (adamw, nvnovograd, adahessian: mu (and adamw's and adahessian's nu)
    shaped like each JAX parameter, nvnovograd's nu a scalar each;
    adafactor: its chain's v_row, v_col and v as optax shapes them), and
    `count` updates taken."""
    state = {k: v.shape for k, v in opt_state.items()}

    def field(prefix):
        return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}

    if opt == "adafactor":
        want = {}
        for k, shape in params.items():
            dims = _factored(shape)
            want[k] = ((tuple(np.delete(shape, dims[1])), tuple(np.delete(shape, dims[0])), (1,))
                       if dims else ((1,), (1,), shape))
        got = {k: tuple(field(f"inner_state/0/0/{f}/").get(k) for f in ("v_row", "v_col", "v"))
               for k in params}
        ok = got == want and field("inner_state/0/0/count") == {"": ()}
    else:
        nu = {k: () for k in params} if opt == "nvnovograd" else params
        ok = field("inner_state/0/mu/") == params and (
            opt == "lion" or field("inner_state/0/nu/") == nu)
    if not ok or int(opt_state["count"]) != count:
        raise AssertionError(f"{path}: optimizer state not in the JAX {opt} layout")


def _rel_l2(grads, ref):
    import torch

    num = sum(torch.sum((g.float() - r.float()) ** 2) for g, r in zip(grads, ref))
    den = sum(torch.sum(r.float() ** 2) for r in ref)
    return math.sqrt(num.item() / den.item())


def train_step_checks(run: dict, model: dict, device: str, timed: bool = True):
    """On the trained weights of `run`: one step's gradients through the bf16
    flash path against the plain attention path (bf16) and fp32, on the same
    batch and draws; then (when `timed`) ms per step with flash on and off
    over one fixed batch, and a torch.profiler trace of each."""
    import torch

    from imageclassification_tpu_torch.data.folder import scan_folder
    from imageclassification_tpu_torch.data.loader import BatchLoader
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.optim.factory import create_optimizer

    args, state = run["args"], run["state"]
    num_classes = state.model.head.out_features
    dataset = scan_folder(run["images"])
    idx = np.arange(args.batch_size)[None]
    batch = next(iter(BatchLoader(dataset, idx, args.input_size, train=True, device=device,
                                  seed=args.seed, num_workers=8)))
    mixup_cfg = build_mixup(args, num_classes)

    def make(flash: bool, half: bool):
        m = create_model(model["name"], num_classes=num_classes, half_precision=half,
                         img_size=args.input_size, flash_attn=flash).to(device)
        m.load_state_dict(state.model.state_dict())
        opt = create_optimizer(args.opt, m.parameters(), lr=args.lr,
                               weight_decay=args.weight_decay)
        step = build_train_step(m, args, num_classes, mixup_cfg, [args.lr], [args.weight_decay],
                                seed=args.seed)
        return create_train_state(m, opt), step

    flash, step = make(True, True)
    plain, plain_step = make(False, True)
    fp32, _ = make(False, False)
    draws = step.sample_draws(*batch["image"].shape[:3])
    grads = {name: step.loss_and_grads(st.model, batch, draws)
             for name, st in (("flash", flash), ("plain", plain), ("fp32", fp32))}
    res = {"loss": {n: g[0].item() for n, g in grads.items()},
           "grad_flash_vs_fp32": _rel_l2(grads["flash"][3], grads["fp32"][3]),
           "grad_flash_vs_plain": _rel_l2(grads["flash"][3], grads["plain"][3]),
           "grad_plain_vs_fp32": _rel_l2(grads["plain"][3], grads["fp32"][3])}
    log(f"train step gradients on the trained {model['name']}, relative global L2: bf16 flash vs "
        f"fp32 {res['grad_flash_vs_fp32']:.4e}, bf16 flash vs bf16 plain "
        f"{res['grad_flash_vs_plain']:.4e}, bf16 plain vs fp32 {res['grad_plain_vs_fp32']:.4e} "
        f"(tol {GRAD_RTOL}); losses {res['loss']}")
    for key in ("grad_flash_vs_fp32", "grad_flash_vs_plain"):
        if not res[key] <= GRAD_RTOL:
            raise AssertionError(f"{key} = {res[key]} > {GRAD_RTOL}")
    del grads, fp32
    if timed:
        for name, st, fn in (("flash", flash, step), ("plain", plain, plain_step)):
            res[name] = time_captured_and_eager(st, fn, batch)
    return res


def fp32_path(work: str, device: str, model: dict, cfg: dict, images: str) -> dict:
    """5d: the fp32 path of --flash_attn (C1): train.main with
    --half_precision false on `model` at phase 5's cell (1 epoch of 10
    steps), captured, every K1 kernel of a replayed step the fp32 one (12 +
    12 forwards, 12 dQ, 12 dK/dV); the captured and eager step timed beside
    phase 5's bf16 one; its checkpoint served by val.py (which serves in
    bf16, as the JAX val.py); and an fp32 served batch of the same weights
    (`val.initialize_model(half_precision=False)`, captured predict), whose
    replays launch the fp32 forward 12 times, held against the fp32 model
    on the plain attention path."""
    import torch

    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    run = run_training(work, device, model, cfg["img"], cfg["num_classes"], cfg["per_class"],
                       cfg["batch"], 1, images=images, dtype="fp32")
    if run["state"].model.dtype != torch.float32:
        raise AssertionError(f"--half_precision false trained {run['state'].model.dtype}")
    out = {"records": run["records"], "totals": run["totals"], "per_replay": run["per_replay"],
           "wall_s": run["wall_s"], "steps": len(run["records"])}
    if device == "cuda":
        out["timing"] = step_timing(run, device)
    ck = run["checkpoint"]
    n_images = cfg["num_classes"] * cfg["per_class"]
    reset_launches()
    tp, fp, fn = val.val_precision(images, ck, cfg["img"], model_ema=False,
                                   batch_size=cfg["batch"], device=device)
    if not (tp.sum() + fp.sum() == n_images and tp.sum() + fn.sum() == n_images):
        raise AssertionError(f"val_precision counts do not cover {n_images} images")
    out["val_top1"] = float(tp.sum() / n_images)
    out["val_launches"] = _launch_counts()
    del run
    m32, _ = val.initialize_model(ck, False, half_precision=False, device=device)
    plain = create_model(model["name"], num_classes=cfg["num_classes"], half_precision=False,
                         img_size=cfg["img"]).to(device).eval()
    plain.load_state_dict(m32.state_dict())
    predict, predict_plain = val._predict_fn(m32), val._predict_fn(plain)
    imgs = _images_batch(images, cfg["img"], cfg["batch"], device)
    reset_launches()
    p32 = predict(imgs)
    out["serve_launches"] = _launch_counts("fp32")
    out["probs_flash_vs_plain"] = (p32 - predict_plain(imgs)).abs().max().item()
    if not torch.isfinite(p32).all() or out["probs_flash_vs_plain"] > FP32_PROBS_ATOL:
        raise AssertionError(f"fp32 served batch: flash vs plain attention probabilities "
                             f"max|d| {out['probs_flash_vs_plain']} > {FP32_PROBS_ATOL}")
    if device == "cuda":
        out["serve_per_replay"] = replay_launches(lambda: predict(imgs), ["fwd"] * model["depth"])
        check_flash_dtype(lambda: predict(imgs), "fp32", "the fp32 served batch")
        out["serve_ms"] = time_ms(lambda: predict(imgs), iters=10)
        out["serve_trace"] = trace(lambda: predict(imgs))
    return out


def head_bias(model):
    """The bias of a model's classifier (ViT, Swin: head; ConvNeXt:
    head.fc)."""
    head = model.head
    return head.fc.bias if hasattr(head, "fc") else head.bias


def captured_vs_eager(model: dict, img: int, batch: int, num_classes: int, steps: int = 6,
                      flags: tuple = ()):
    """`steps` train steps of `model` at full width (a ViT with --flash_attn;
    drop path 0.1, the default training flags, the EMA with warmup), eager twice
    and captured once, each from the same seeded state and seeded generators
    on seeded batches: the largest difference over parameters, EMA, moments
    and count between the eager runs and between the captured run and the
    first eager one. The captured run must match the eager one bitwise where
    the eager runs match each other, else differ by no more than they do.
    Then, inside the captured run's replays, a step with the head bias set to
    inf must leave that state unchanged bitwise, and the next step apply.
    `flags`: more train.py flags (--remat, --layer_decay, --opt)."""
    import torch

    from imageclassification_tpu_torch.config import parse_args
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.compiled import CapturedTrainStep
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.optim.factory import create_optimizer

    dev = torch.device("cuda")
    from imageclassification_tpu_torch.train import optimizer_layout

    vit = model["name"].startswith("vit")
    args = parse_args(["--model", model["name"], "--flash_attn", str(vit).lower(), "--model_ema",
                       "true", "--model_ema_warmup", "true", "--drop_path", "0.1", *flags])
    rng = np.random.default_rng(11)
    batches = [{"image": torch.from_numpy(rng.integers(0, 256, (batch, img, img, 3),
                                                       dtype=np.uint8)).to(dev),
                "label": torch.from_numpy(rng.integers(0, num_classes, batch)).to(dev)}
               for _ in range(steps)]

    def build():
        m = create_model(model["name"], num_classes=num_classes, half_precision=True,
                         img_size=img, flash_attn=vit, drop_path_rate=args.drop_path,
                         generator=torch.Generator().manual_seed(0)).to(dev)
        opt = create_optimizer(args.opt, m.parameters(), lr=args.lr,
                               weight_decay=args.weight_decay, **optimizer_layout(args, m))
        step = build_train_step(m, args, num_classes, build_mixup(args, num_classes),
                                np.linspace(args.lr, args.lr / 10, steps + 2),
                                np.linspace(args.weight_decay, args.weight_decay / 10, steps + 2),
                                ema_decay=args.model_ema_decay, seed=1)
        return create_train_state(m, opt, use_ema=True), step

    def snapshot(state):
        opt = state.optimizer
        return {**{f"p.{k}": v.detach().clone() for k, v in state.model.state_dict().items()},
                **{f"ema.{k}": v.clone() for k, v in state.ema.items()},
                **{f"{k}.{i}": t.clone() for k, ts in opt.moments.items()
                   for i, t in enumerate(ts)}, "count": opt.count.clone()}

    def gap(a, b):
        return max((x.double() - b[k].double()).abs().max().item() for k, x in a.items())

    runs, losses = [], []
    for captured in (False, False, True):
        state, step = build()
        if captured:
            step = CapturedTrainStep(step, dev)
        metrics = [step(state, b) for b in batches]
        losses.append([round(float(m["loss"]), 6) for m in metrics])
        runs.append(snapshot(state))
        if not captured:
            del state, step
    res = {"steps": steps, "losses": losses, "eager_gap": gap(runs[0], runs[1]),
           "captured_gap": gap(runs[0], runs[2])}
    if res["eager_gap"] == 0.0 and (res["captured_gap"] != 0.0 or losses[2] != losses[0]):
        raise AssertionError(f"captured steps differ from bitwise-repeatable eager steps by "
                             f"{res['captured_gap']}")
    if res["captured_gap"] > res["eager_gap"] > 0.0:
        raise AssertionError(f"captured steps differ from eager steps by {res['captured_gap']}, "
                             f"more than two eager runs ({res['eager_gap']})")
    bias = head_bias(state.model).detach()
    keep = bias[0].item()
    bias[0] = float("inf")  # in place: the graph reads the parameter's memory
    before = snapshot(state)
    res["skipped"] = float(step(state, batches[0])["skipped"])
    after = snapshot(state)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if res["skipped"] != 1.0 or changed:
        raise AssertionError(f"a non-finite replayed step: skipped {res['skipped']}, "
                             f"changed {changed[:5]}")
    bias[0] = keep
    if float(step(state, batches[1])["skipped"]) != 0.0 or \
            state.optimizer.num_updates != int(before["count"]) + 1:
        raise AssertionError("the step after a skipped one did not apply")
    return res


def _op_launch_counts():
    from imageclassification_tpu_torch.ops.dwconv import depthwise_conv7x7 as d
    from imageclassification_tpu_torch.ops.layernorm import fused_layer_norm as f

    return {"ln_fwd": f.launches, "ln_bwd": f.launches_bwd, "dw_fwd": d.launches,
            "dw_dx": d.launches_dx, "dw_dw": d.launches_dw}


def _reset_op_launches() -> None:
    from imageclassification_tpu_torch.ops import dwconv, layernorm

    layernorm.reset_launches()
    dwconv.reset_launches()


def layernorm_bound(rows: int, C: int, part: str = "fwd", itemsize: int = 2):
    """(bound_ms, bound_by) of the LayerNorm over [rows, C]. 'fwd': x read
    and y written (gamma, beta fp32 read), 8 flops per element; 'bwd': x and
    dy read, dx written (gamma read, dgamma, dbeta written, fp32), 16 flops per
    element (the Pallas kernels' CostEstimate), on the fp32 CUDA cores."""
    tensors, params, flops = {"fwd": (2, 2, 8), "bwd": (3, 3, 16)}[part]
    t_bytes = (tensors * rows * C * itemsize + params * C * 4) / HBM_BYTES_PER_S
    t_flops = flops * rows * C / FP32_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def dwconv_bound(B: int, H: int, W: int, C: int, itemsize: int = 2):
    """(bound_ms, bound_by) of the 7x7 depthwise conv over [B, H, W, C], the
    forward, dx or dw alike: two tensors of that shape read or written and
    the 7x7xC weights (or dw), 2 * 49 flops per element at the card's rate
    for the inputs' type. bf16: the tensor-core rate, since each has a
    tensor-core form (per channel the forward and dx are banded Toeplitz
    products of input rows with kernel rows, dw a 7 x 7 product of depth
    B*H*W; csrc/dwconv7x7.cu), whatever the kernel runs them on. fp32
    (itemsize 4): the fp32 CUDA cores. The bytes bind in both."""
    n = B * H * W * C
    t_bytes = (2 * n + 49 * C) * itemsize / HBM_BYTES_PER_S
    t_flops = 2 * 49 * n / (BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S)
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def _hold(name: str, got, want, rtol: float, terms=None) -> tuple:
    """(max_abs_err, tol) of `got` against `want` with a tolerance of rtol *
    max|want|; raises when it is not within it. For column sums, `terms`
    holds each column's sum of |terms| and column c is held to rtol *
    max|want| + SUM_ROUNDING_UNITS * 2^-24 * terms[c] (SUM_ROUNDING_UNITS);
    tol is then the tolerance of the column nearest its limit."""
    err_c = (got.float() - want.float()).abs()
    tol = rtol * want.float().abs().max().item()
    if terms is not None:
        tol_c = tol + SUM_ROUNDING_UNITS * 2.0 ** -24 * terms
        worst = int((err_c / tol_c).argmax())
        err_c, tol = err_c[worst:worst + 1], tol_c[worst].item()
    err = err_c.max().item()
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{name}: max|d| {err} > {tol}")
    return err, tol


def host_ms(fn, calls: int = 5) -> float:
    """Host ms a call of fn(): perf_counter around `calls` back-to-back calls
    after a synchronize, the device not waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def host_and_events_ms(fn, calls: int = 20, reps: int = 3) -> tuple[float, float]:
    """Host ms and CUDA events ms a call of fn(), both read on the same
    `calls` back-to-back calls after a synchronize (perf_counter until the
    last call returns, events until the device has run it), over `reps` runs:
    the pair of the run whose host / events ratio is the median. A host-bound
    call reads about as long on both however slow the shared host is at that
    moment; host ms and events ms read on different calls do not (F.layer_norm
    forward and backward once read 0.078 device ms against 0.3926 ms of
    events, about twice the events of its host-bound call at 12544 x 384,
    beside a host ms of another moment, and was refused as a misreading)."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host = (time.perf_counter() - t0) / calls * 1e3
        end.record()
        torch.cuda.synchronize()
        pairs.append((host, start.elapsed_time(end) / calls))
    return sorted(pairs, key=lambda p: p[0] / p[1])[reps // 2]


def _device_bound(fn, events_ms: float = None) -> tuple[bool, float]:
    """Whether fn() is device-bound (host ms a call under half its events ms,
    both from `host_and_events_ms`), and the events ms a reading of it is held
    to: the lesser of that run's and `events_ms` (the caller's timing of the
    same call, where given), since no events time of a call is shorter than
    its device time. The caller's events ms sizes the run (2 to 20 calls)."""
    calls = 20 if events_ms is None else int(min(20, max(2, 10 / events_ms)))
    host, events = host_and_events_ms(fn, calls)
    return host < 0.5 * events, events if events_ms is None else min(events_ms, events)


def alone_floor(events_ms: float, host: float) -> float:
    """The least device ms a reading of a kernel may give, from a call of it
    alone: half that call's CUDA events ms where it is device-bound (host ms
    a call under half its events ms), else 0 (no floor)."""
    return 0.5 * events_ms if host < 0.5 * events_ms else 0.0


def _device_ms(fn, launches: dict, traces: int = 3, steps: int = 10,
               events_ms: float = None, floor_ms: float = 0.0) -> float:
    """Device ms a call of fn() of the kernels whose names hold a key of
    `launches` (each key's launches a call), read as `_library_device_ms`
    reads a library call: over `traces` traces that hold every one of them
    (a trace that keeps none of a kernel's launches is taken again, up to
    five times `traces`), each kernel at its mean time per traced launch,
    times its whole launches a call (the larger of `launches` and the most
    one trace kept, rounded up). Every reading is held against the CUDA
    events ms of the same call (`_device_bound`, with `events_ms` where the
    caller timed it): where the call is device-bound, the reading plus the
    call's other kernels must reach half the events ms. Where the
    kernels are a small part of the call (one kernel inside a train step),
    `floor_ms` holds the reading itself: the least it may be, from CUDA
    events of those launches alone (`alone_floor`). A reading below either
    is traced again once, and then raises: it is never returned. (One trace
    of a flash forward at 64 x 577 x 12 x 64 read 0.1106 ms a launch where
    CUDA events give 0.249; PERF.md section 6.)"""
    device_bound, events_ms = _device_bound(fn, events_ms)
    readings = []
    for _ in range(2):
        seen, others = {}, []
        for _ in range(5 * traces):
            kernels = trace(fn, steps)[2]
            got = {name: [(ms, n) for k, (ms, n) in kernels.items() if name in k]
                   for name in launches}
            if not all(sum(n for _, n in g) for g in got.values()):
                continue
            for name, g in got.items():
                total, n, most = seen.get(name, (0.0, 0.0, 0.0))
                kept = sum(c for _, c in g)
                seen[name] = (total + sum(ms for ms, _ in g), n + kept, max(most, kept))
            others.append(sum(ms for k, (ms, _) in kernels.items()
                              if not any(name in k for name in launches)))
            if len(others) == traces:
                break
        if not others:
            raise AssertionError(f"{5 * traces} traces held no launch of one of {list(launches)}")
        reading = sum(total / n * max(launches[name], math.ceil(most - 1e-9))
                      for name, (total, n, most) in seen.items())
        readings.append(reading)
        whole = not device_bound or reading + statistics.median(others) >= 0.5 * events_ms
        if whole and reading >= floor_ms:
            return reading
    raise AssertionError(f"device ms a call of {list(launches)} read {readings} against "
                         f"{events_ms:.4f} ms of CUDA events of the call (device-bound: "
                         f"{device_bound}) and a floor of {floor_ms:.4f} ms from the kernels "
                         f"alone: a misreading")


def _library_device_ms(fn, traces: int = 3, events_ms: float = None) -> float:
    """Device ms per call of a library call fn(), whose kernels are not known
    by name: every kernel of `traces` traces at its mean time per launch,
    times the most launches per call one trace kept, rounded up to a whole
    launch (a call launches each of its kernels a whole number of times), as
    `_device_ms` reads a kernel that a trace may have dropped launches of. A
    trace that kept no kernel at all (seen at 64 x 577 x 12 x 64 after the
    training phases) is taken again, up to five times `traces`. The reading
    is held against the CUDA events ms of the same call (`_device_bound`) as
    `_device_ms` holds one: where the call is device-bound, a reading under
    half its events ms is traced again once, and then raises."""
    device_bound, events_ms = _device_bound(fn, events_ms)
    readings = []
    for _ in range(2):
        seen, kept = {}, 0
        for _ in range(5 * traces):
            kernels = trace(fn)[2]
            if not kernels:
                continue
            for name, (ms, n) in kernels.items():
                total, launches, most = seen.get(name, (0.0, 0.0, 0.0))
                seen[name] = (total + ms, launches + n, max(most, n))
            kept += 1
            if kept == traces:
                break
        if not seen:
            raise AssertionError(f"{5 * traces} traces held no kernel of the library call")
        reading = sum(total / launches * math.ceil(most - 1e-9)
                      for total, launches, most in seen.values())
        readings.append(reading)
        if not device_bound or reading >= 0.5 * events_ms:
            return reading
    raise AssertionError(f"device ms a library call read {readings} against {events_ms:.4f} "
                         f"ms of CUDA events of the device-bound call: a misreading")


def check_layernorm(rows: int, C: int, device, constant: bool = False, timed: bool = True):
    """The LayerNorm kernels (forward, and backward with its partial-sum
    pass) against their plain versions on seeded bf16 x and dy, fp32 gamma
    and beta, at [rows, C], the backward run twice and held bitwise equal;
    with `constant`, every other row holds one value (var = 0: those rows
    must give beta). When `timed`: kernel, plain and library (F.layer_norm in
    bf16 without autograd, as the kernel is called; its backward as forward +
    backward less forward, with autograd) ms by CUDA events, device ms per
    call of both from traces, the factors kernel / library on each, each
    wrapper's host cost (kernel ms - device ms), and the bounds."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=device).manual_seed(rows + C)
    x = torch.randn((rows, C), generator=g, device=device) * 2 + 0.5
    if constant:
        x[::2] = 0.75
    x = x.bfloat16()
    gamma = 1 + 0.2 * torch.randn(C, generator=g, device=device)
    beta = 0.2 * torch.randn(C, generator=g, device=device)
    dy = torch.randn((rows, C), generator=g, device=device).bfloat16()
    y = ln.fused_layer_norm(x, gamma, beta)
    dx, dg, db = ln.layer_norm_bwd(x, gamma, dy)
    again = ln.layer_norm_bwd(x, gamma, dy)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((dx, dg, db), again)):
        raise AssertionError(f"layer_norm_bwd {rows}x{C}: two runs differ")
    want_dx, want_dg, want_db = ln.layer_norm_bwd_ref(x.float(), gamma, dy.float())
    errs = {"y": _hold(f"layer_norm_fwd {rows}x{C}", y, ln.layer_norm_ref(x.float(), gamma, beta),
                       OP_RTOL),
            "dx": _hold(f"layer_norm_bwd dx {rows}x{C}", dx, want_dx, OP_RTOL),
            "dgamma": _hold(f"layer_norm_bwd dgamma {rows}x{C}", dg, want_dg, SUM_RTOL),
            "dbeta": _hold(f"layer_norm_bwd dbeta {rows}x{C}", db, want_db, SUM_RTOL)}
    if constant and not torch.equal(y[::2], beta.bfloat16().expand(y[::2].shape)):
        raise AssertionError("layer_norm_fwd: constant rows do not give beta")
    row = dict(shape=[rows, C], errs=errs, constant=constant)
    if timed:
        iters = max(10, min(200, int(2e9 // (rows * C))))
        slow = max(3, iters // 10)
        fwd = lambda: ln.fused_layer_norm(x, gamma, beta)  # noqa: E731
        bwd = lambda: ln.layer_norm_bwd(x, gamma, dy)  # noqa: E731
        row["ms_fwd"], row["ms_bwd"] = time_ms(fwd, iters), time_ms(bwd, iters)
        row["plain_ms_fwd"] = time_ms(lambda: ln.layer_norm_ref(x, gamma, beta), slow)
        row["plain_ms_bwd"] = time_ms(lambda: ln.layer_norm_bwd_ref(x, gamma, dy), slow)
        g16, b16 = gamma.bfloat16(), beta.bfloat16()
        xl = x.detach().requires_grad_()
        gl, bl = (t.detach().requires_grad_() for t in (g16, b16))
        lib_fwd = lambda: F.layer_norm(x, (C,), g16, b16, 1e-6)  # noqa: E731
        lib_fwd_grad = lambda: F.layer_norm(xl, (C,), gl, bl, 1e-6)  # noqa: E731
        lib_all = lambda: torch.autograd.grad(lib_fwd_grad(), (xl, gl, bl), dy)  # noqa: E731
        row["library_ms_fwd"] = time_ms(lib_fwd, iters)
        row["library_ms_bwd"] = time_ms(lib_all, iters) - time_ms(lib_fwd_grad, iters)
        row["device_ms_fwd"] = _device_ms(fwd, {"layer_norm_fwd_kernel": 1})
        row["device_ms_bwd"] = _device_ms(bwd, {"layer_norm_bwd_kernel": 1, "sum_partials": 1})
        row["library_device_ms_fwd"] = _library_device_ms(lib_fwd)
        row["library_device_ms_bwd"] = _library_device_ms(lib_all) - _library_device_ms(
            lib_fwd_grad)
        for part in ("fwd", "bwd"):
            row[f"bound_{part}"] = layernorm_bound(rows, C, part)
            row[f"host_ms_{part}"] = row[f"ms_{part}"] - row[f"device_ms_{part}"]
            row[f"factor_{part}"] = row[f"ms_{part}"] / row[f"library_ms_{part}"]
            row[f"device_factor_{part}"] = (row[f"device_ms_{part}"]
                                            / row[f"library_device_ms_{part}"])
        log(f"layer_norm {rows}x{C} bf16: " + "; ".join(
            f"{part} kernel {row[f'ms_{part}']:.4f} ms (device {row[f'device_ms_{part}']:.4f}, "
            f"host {row[f'host_ms_{part}']:.4f}), plain {row[f'plain_ms_{part}']:.4f}, "
            f"F.layer_norm {'backward ' if part == 'bwd' else ''}"
            f"{row[f'library_ms_{part}']:.4f} (device {row[f'library_device_ms_{part}']:.4f}), "
            f"kernel/library {row[f'factor_{part}']:.3f} (device "
            f"{row[f'device_factor_{part}']:.3f}), bound {row[f'bound_{part}'][0]:.4f} "
            f"({row[f'bound_{part}'][1]}), bound/device "
            f"{row[f'bound_{part}'][0] / row[f'device_ms_{part}']:.3f}"
            for part in ("fwd", "bwd")) + "; bwd bitwise equal over two runs")
    log(f"layer_norm {rows}x{C}{' (constant rows)' if constant else ''}: max|d| vs plain "
        + ", ".join(f"{k} {e:.3e} (tol {t:.3e})" for k, (e, t) in errs.items()))
    return row


def host_us(fn, calls: int = 2000, reps: int = 5) -> float:
    """Median over `reps` of the host microseconds per call of fn() (no
    device work waited for: perf_counter around `calls` calls)."""
    for _ in range(100):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


def layernorm_host_steps(device) -> dict:
    """Host microseconds per call of the steps of the LayerNorm forward
    wrapper's host path, on the card's host: the input checks, gamma's
    fp32/alignment step, the output's allocation, the plan and its `Launch`
    (a cache lookup), the raw stream handle, the ctypes call of the entry
    point (given a plan it refuses before launching, so no launch is timed:
    the device guard and the plan check included); and, at 64x768 bf16 (the
    head), the forward with and without its autograd node (kernel launched,
    CUDA events)."""
    import torch

    from imageclassification_tpu_torch.ops import _build
    from imageclassification_tpu_torch.ops import layernorm as ln

    x = torch.randn((64, 768), device=device).bfloat16()
    gamma, beta = torch.ones(768, device=device), torch.zeros(768, device=device)
    y, dev = torch.empty_like(x), x.get_device()
    refused = ln._Launch(64, 768, 1, 0, dev, 1e-6)  # an all-zero plan
    steps = {
        "check_kernel_inputs": host_us(lambda: ln.check_kernel_inputs(x, gamma, beta)),
        "gamma fp32 and aligned (_build.aligned)": host_us(
            lambda: _build.aligned(gamma, torch.float32)),
        "output (torch.empty_like)": host_us(lambda: torch.empty_like(x)),
        "plan and its Launch (_launch_args, cached)": host_us(
            lambda: ln._launch_args(64, 768, x.dtype, gamma.dtype, 1e-6, dev, False)),
        "raw stream handle (_build.stream)": host_us(lambda: _build.stream(x)),
        "entry point through ctypes, refused before its launch": host_us(
            lambda: ln._kernels()[0](x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                     y.data_ptr(), refused, _build.stream(x))),
    }
    xg = x.detach().requires_grad_()
    steps["forward 64x768, no autograd node (us, CUDA events)"] = 1e3 * time_ms(
        lambda: ln.fused_layer_norm(x, gamma, beta), 200)
    steps["forward 64x768, through the autograd node (us, CUDA events)"] = 1e3 * time_ms(
        lambda: ln.fused_layer_norm(xg, gamma, beta), 200)
    log("layer_norm host path, us per call on this host: "
        + "; ".join(f"{k} {v:.2f}" for k, v in steps.items()))
    return steps


def check_dwconv(shape, device, timed: bool = True):
    """The depthwise-conv kernels (forward, dx = the forward kernel on dy
    with the flipped weights, dw with its partial-sum pass) against their
    plain versions on seeded bf16 x, w and dy of `shape`; when `timed`,
    kernel, plain and library (cuDNN F.conv2d(groups=C) in channels_last bf16,
    and aten.convolution_backward for dx and for dw) ms by CUDA events, the
    device ms per call of each kernel and each library call from traces, the
    factors kernel / library on both, and the bounds."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import dwconv as dw

    B, H, W, C = shape
    g = torch.Generator(device=device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=device).bfloat16()
    w = (0.2 * torch.randn((7, 7, C), generator=g, device=device)).bfloat16()
    dy = torch.randn(shape, generator=g, device=device).bfloat16()
    y = dw.depthwise_conv7x7(x, w)
    dx, dwg = dw.dwconv7x7_bwd(x, w, dy)
    again = dw._launch_dw(x, dy, w.dtype)
    torch.cuda.synchronize()
    if not torch.equal(dwg, again):  # no atomics: the same bits on every run
        raise AssertionError(f"dwconv7x7_dw {shape}: two runs differ")
    errs = {"y": _hold(f"dwconv7x7_fwd {shape}", y, dw.dwconv7x7_ref(x.float(), w.float()),
                       OP_RTOL),
            "dx": _hold(f"dwconv7x7 dx {shape}", dx,
                        dw.dwconv7x7_ref(dy.float(), w.float(), flip=True), OP_RTOL),
            "dw": _hold(f"dwconv7x7_dw {shape}", dwg,
                        dw.dwconv7x7_dw_ref(x, dy, torch.float32), OP_RTOL)}
    row = dict(shape=list(shape), errs=errs)
    if timed:
        iters = max(10, min(200, int(2e9 // (B * H * W * C))))
        slow = 3
        row["ms"] = {"fwd": time_ms(lambda: dw.depthwise_conv7x7(x, w), iters),
                     "dx": time_ms(lambda: dw._launch_fwd(dy, w, flip=True), iters),
                     "dw": time_ms(lambda: dw._launch_dw(x, dy, w.dtype), iters)}
        row["plain_ms"] = {"fwd": time_ms(lambda: dw.dwconv7x7_ref(x, w), slow, reps=3),
                           "dw": time_ms(lambda: dw.dwconv7x7_dw_ref(x, dy, w.dtype), slow,
                                         reps=3)}
        row["plain_ms"]["dx"] = row["plain_ms"]["fwd"]  # the same function on dy
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last views
        wc = w.permute(2, 0, 1).unsqueeze(1).contiguous()
        conv_bwd = torch.ops.aten.convolution_backward
        lib = {"fwd": lambda: F.conv2d(xc, wc, padding=3, groups=C),
               "dx": lambda: conv_bwd(dyc, xc, wc, None, [1, 1], [3, 3], [1, 1], False,
                                      [0, 0], C, [True, False, False]),
               "dw": lambda: conv_bwd(dyc, xc, wc, None, [1, 1], [3, 3], [1, 1], False,
                                      [0, 0], C, [False, True, False])}
        row["library_ms"] = {k: time_ms(fn, iters) for k, fn in lib.items()}
        row["device_ms"] = {
            "fwd": _device_ms(lambda: dw.depthwise_conv7x7(x, w), {"dwconv7x7_fwd_kernel": 1}),
            "dx": _device_ms(lambda: dw._launch_fwd(dy, w, flip=True),
                             {"dwconv7x7_fwd_kernel": 1}),
            "dw": _device_ms(lambda: dw._launch_dw(x, dy, w.dtype),
                             {"dwconv7x7_dw_kernel": 1, "sum_partials": 1})}
        row["library_device_ms"] = {k: _library_device_ms(fn) for k, fn in lib.items()}
        row["bound"] = dict.fromkeys(("fwd", "dx", "dw"), dwconv_bound(B, H, W, C))
        factor = {k: row["ms"][k] / row["library_ms"][k] for k in row["ms"]}
        dev_factor = {k: row["device_ms"][k] / row["library_device_ms"][k] for k in row["ms"]}
        log(f"dwconv7x7 {shape} bf16: " + "; ".join(
            f"{k} kernel {row['ms'][k]:.4f} ms (device {row['device_ms'][k]:.4f}), plain "
            f"{row['plain_ms'][k]:.4f}, cuDNN {row['library_ms'][k]:.4f} (device "
            f"{row['library_device_ms'][k]:.4f}), kernel/cuDNN {factor[k]:.3f} (device "
            f"{dev_factor[k]:.3f}), bound {row['bound'][k][0]:.4f} ({row['bound'][k][1]}"
            f", bf16 tensor cores), bound/device "
            f"{row['bound'][k][0] / row['device_ms'][k]:.3f}" for k in ("fwd", "dx", "dw"))
            + "; dw bitwise equal over two runs")
    log(f"dwconv7x7 {shape}: max|d| vs plain "
        + ", ".join(f"{k} {e:.3e} (tol {t:.3e})" for k, (e, t) in errs.items()))
    return row


def jax_convnext_shapes(depths, dims, num_classes: int) -> dict:
    """The JAX ConvNeXt's flat parameter names and shapes (flax tree paths
    joined by "/", `imageclassification_tpu/models/convnext.py`), written out
    here: the layout a checkpoint of the port must have."""
    shapes = {"stem_conv/kernel": (4, 4, 3, dims[0]), "stem_conv/bias": (dims[0],),
              "head_norm/scale": (dims[-1],), "head_norm/bias": (dims[-1],),
              "head/kernel": (dims[-1], num_classes), "head/bias": (num_classes,)}
    for leaf in ("scale", "bias"):
        shapes[f"stem_norm/{leaf}"] = (dims[0],)
    for i, (depth, d) in enumerate(zip(depths, dims)):
        if i:
            shapes[f"downsample_norm{i}/scale"] = shapes[f"downsample_norm{i}/bias"] = (dims[i - 1],)
            shapes[f"downsample_conv{i}/kernel"] = (2, 2, dims[i - 1], d)
            shapes[f"downsample_conv{i}/bias"] = (d,)
        for j in range(depth):
            b = f"stage{i}_block{j}"
            shapes.update({f"{b}/Conv_0/kernel": (7, 7, 1, d), f"{b}/Conv_0/bias": (d,),
                           f"{b}/LayerNorm_0/scale": (d,), f"{b}/LayerNorm_0/bias": (d,),
                           f"{b}/Dense_0/kernel": (d, 4 * d), f"{b}/Dense_0/bias": (4 * d,),
                           f"{b}/Dense_1/kernel": (4 * d, d), f"{b}/Dense_1/bias": (d,),
                           f"{b}/gamma": (d,)})
    return shapes


def run_convnext_training(work: str, device: str, model: dict, img: int, num_classes: int,
                          per_class: int, batch: int, epochs: int, seed: int = 0,
                          images: str = None, flags: tuple = ()):
    """The ConvNeXt training path through the port's train.main on `device`
    with the default training flags (drop_path, AdamW, mixup, exact-mode
    accuracy) and `flags`, on a seeded image folder. The model runs F.conv2d and its
    fp32 LayerNorm helper, no kernel of the port: every launch count must
    stay 0. Checks the checkpoint's JAX layout, its exact reload by the
    port's val.initialize_model, and val_precision on it."""
    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    images = images or _train_images(work, num_classes, per_class, seed)
    reset_launches()
    _reset_op_launches()

    def counts():
        return {**_launch_counts(), **_op_launch_counts()}

    state, args, records, wall_s, _ = _train_main(
        work, images, ["--model", model["name"], "--input_size", str(img), "--batch_size",
                       str(batch), "--epochs", str(epochs), "--warmup_epochs", "1",
                       "--device", device, *flags])
    if any(counts().values()):
        raise AssertionError(f"the ConvNeXt training path launched a kernel: {counts()}")
    path = os.path.join(args.output_dir, f"checkpoint-{epochs - 1}.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    want = jax_convnext_shapes(model["depths"], model["dims"], num_classes)
    if {k: v.shape for k, v in ck["model"].items()} != want:
        raise AssertionError(f"{path}: parameters not in the JAX layout")
    check_optimizer_state(path, ck["optimizer"], want, args.opt, len(records))
    loaded, _ = val.initialize_model(path, model_ema=False, device=device)
    carried = max((loaded.state_dict()[k] - v).abs().max().item()
                  for k, v in state.model.state_dict().items())
    if carried != 0.0:
        raise AssertionError(f"{path}: reloaded weights differ from the run's by {carried}")
    n_images = num_classes * per_class
    tp, fp, fn = val.val_precision(images, path, img, model_ema=True, batch_size=batch,
                                   device=device)
    if not (tp.sum() + fp.sum() == n_images and tp.sum() + fn.sum() == n_images):
        raise AssertionError(f"val_precision counts do not cover {n_images} images")
    return {"state": state, "args": args, "records": records, "wall_s": wall_s,
            "checkpoint": path, "images": images, "steps_per_epoch": len(records) // epochs,
            "val_top1": float(tp.sum() / n_images), "num_classes": num_classes}


def _fixed_batch(run: dict, device: str):
    from imageclassification_tpu_torch.data.folder import scan_folder
    from imageclassification_tpu_torch.data.loader import BatchLoader

    args = run["args"]
    idx = np.arange(args.batch_size)[None]
    return next(iter(BatchLoader(scan_folder(run["images"]), idx, args.input_size, train=True,
                                 device=device, seed=args.seed, num_workers=8)))


def time_captured_and_eager(state, step, batch, iters: int = 5, reps: int = 2,
                            trace_steps: int = 3) -> dict:
    """ms per train step (CUDA events, the median of `reps` runs of `iters`
    back-to-back steps on one fixed batch; cut from 10 x 3 for the command's
    time) and a torch.profiler trace of `trace_steps` train
    steps, for the step captured as train.main runs it (`CapturedTrainStep`)
    and for the eager `step`, on `state` (the steps go on updating it):
    {"captured": (ms, trace), "eager": (ms, trace)}."""
    import torch

    from imageclassification_tpu_torch.engine.compiled import CapturedTrainStep

    captured = CapturedTrainStep(step, torch.device("cuda"))
    return {name: (time_ms(lambda: fn(state, batch), iters=iters, reps=reps),
                   trace(lambda: fn(state, batch), steps=trace_steps))
            for name, fn in (("captured", captured), ("eager", step))}


def log_step_timing(label: str, batch: int, timing: dict) -> None:
    for name in ("captured", "eager"):
        ms, tr = timing[name]
        log(f"train step {label} batch {batch}, {name} step: {ms:.3f} ms/step, "
            f"{batch / (ms / 1e3):.1f} img/s (CUDA events, one fixed batch, exact-mode accuracy "
            f"forward included)")
        log_trace(f"{label} batch {batch} train step, {name}", tr, "step")


def step_timing(run: dict, device: str):
    """`time_captured_and_eager` on the trained state of `run`."""
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.step import build_train_step

    args, state = run["args"], run["state"]
    num_classes = run["num_classes"]
    step = build_train_step(state.model, args, num_classes, build_mixup(args, num_classes),
                            [args.lr], [args.weight_decay], seed=args.seed)
    return time_captured_and_eager(state, step, _fixed_batch(run, device))


def _capture_convnext_ops(model):
    """Wrap the ConvNeXt module's LayerNorm and conv helpers so that a
    forward and backward records, for every LayerNorm (stem, downsamples,
    blocks, head) and every depthwise conv: its input, parameters (as the
    model uses them), output, the gradient of its output and the model's own
    gradient of its input. Returns (records, undo)."""
    from imageclassification_tpu_torch.models import convnext as port_convnext

    records = {"ln": [], "dw": []}
    orig_ln, orig_conv = port_convnext.layer_norm, port_convnext.conv2d_nhwc

    def keep(rec, y, xin):
        rec["y"] = y.detach()
        y.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
        xin.register_hook(lambda g: rec.__setitem__("dx", g.detach()))

    def layer_norm(x, ln, dtype):
        xin = x.view_as(x)  # its own autograd node: the gradient of this use only
        y = orig_ln(xin, ln, dtype)
        rec = {"x": x.detach(), "module": ln}
        records["ln"].append(rec)
        keep(rec, y, xin)
        return y

    def conv2d_nhwc(x, conv, dtype):
        if not isinstance(conv, port_convnext.DepthwiseConv7x7):
            return orig_conv(x, conv, dtype)
        xin = x.to(dtype).view_as(x)
        y = orig_conv(xin, conv, dtype)
        rec = {"x": xin.detach(), "module": conv, "dtype": dtype}
        records["dw"].append(rec)
        keep(rec, y, xin)
        return y

    port_convnext.layer_norm, port_convnext.conv2d_nhwc = layer_norm, conv2d_nhwc

    def undo():
        port_convnext.layer_norm, port_convnext.conv2d_nhwc = orig_ln, orig_conv

    return records, undo


def replay_convnext_ops(run: dict, device: str):
    """On the trained weights of `run`: one train step's forward and backward
    (the step's own `loss_and_grads`, draws included) with every LayerNorm's
    and depthwise conv's tensors captured; then each captured tensor through
    the kernels (fused_layer_norm and layer_norm_bwd; depthwise_conv7x7 and
    dwconv7x7_bwd), with the launch counts set to 0 just before. The results
    are held against the model's own outputs and gradients (MODEL_RTOL,
    MODEL_SUM_RTOL) and against the plain versions (OP_RTOL, SUM_RTOL).
    Returns the counts, the largest errors and the numbers of captured ops."""
    import torch

    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.step import build_train_step

    args, model = run["args"], run["state"].model
    num_classes = model.head.fc.out_features
    batch = _fixed_batch(run, device)
    step = build_train_step(model, args, num_classes, build_mixup(args, num_classes),
                            [args.lr], [args.weight_decay], seed=args.seed)
    model.train()
    records, undo = _capture_convnext_ops(model)
    try:
        _, _, _, grads = step.loss_and_grads(model, batch,
                                             step.sample_draws(*batch["image"].shape[:3]))
    finally:
        undo()
    grad_of = {p: g for p, g in zip(model.parameters(), grads)}
    _reset_op_launches()
    with torch.no_grad():
        errs, nearest = _replay(records, grad_of)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"launches": _op_launch_counts(), "errs": errs, "nearest": nearest,
            "n_ln": len(records["ln"]), "n_dw": len(records["dw"]),
            "ln_shapes": sorted({(r["x"].numel() // r["x"].shape[-1], r["x"].shape[-1])
                                 for r in records["ln"]}),
            "dw_shapes": sorted({tuple(r["x"].shape) for r in records["dw"]}),
            "dw_counts": Counter(tuple(r["x"].shape) for r in records["dw"])}


def _replay(records, grad_of) -> tuple:
    """The kernels on the captured tensors of `replay_convnext_ops`, each
    result held by `_hold`; returns ({key: the largest max_abs_err},
    {key: (max_abs_err, tol) of the op nearest its tolerance})."""
    import torch

    from imageclassification_tpu_torch.ops import dwconv as dw
    from imageclassification_tpu_torch.ops import layernorm as ln

    errs, nearest = {}, {}

    def share(err, tol):  # of its tolerance (0 where both are 0)
        return err / tol if tol else 0.0

    def hold(key, got, want, rtol, terms=None):
        err, tol = _hold(key, got, want, rtol, terms)
        errs[key] = max(errs.get(key, 0.0), err)
        if key not in nearest or share(err, tol) > share(*nearest[key]):
            nearest[key] = (err, tol)

    for rec in records["ln"]:
        m, x, dy = rec["module"], rec["x"], rec["dy"]
        y = ln.fused_layer_norm(x, m.weight, m.bias, m.eps)
        dx, dg, db = ln.layer_norm_bwd(x, m.weight, dy, m.eps)
        # dgamma and dbeta are column sums over every row of dy * xhat and
        # dy: each column's sum of |terms| scales its rounding
        C = x.shape[-1]
        dyf = dy.float().reshape(-1, C)
        xhat = torch.nn.functional.layer_norm(x.float(), (C,), eps=m.eps).reshape(-1, C)
        terms = {"dgamma": (dyf * xhat).abs().sum(0), "dbeta": dyf.abs().sum(0)}
        del dyf, xhat
        hold("layer_norm_fwd vs model", y, rec["y"], MODEL_RTOL)
        hold("layer_norm_bwd dx vs model", dx, rec["dx"], MODEL_RTOL)
        hold("layer_norm_bwd dgamma vs model", dg, grad_of[m.weight], MODEL_SUM_RTOL,
             terms["dgamma"])
        hold("layer_norm_bwd dbeta vs model", db, grad_of[m.bias], MODEL_SUM_RTOL, terms["dbeta"])
        want_dx, want_dg, want_db = ln.layer_norm_bwd_ref(x.float(), m.weight, dy.float(), m.eps)
        hold("layer_norm_fwd vs plain", y, ln.layer_norm_ref(x.float(), m.weight, m.bias, m.eps),
             OP_RTOL)
        hold("layer_norm_bwd dx vs plain", dx, want_dx, OP_RTOL)
        hold("layer_norm_bwd dgamma vs plain", dg, want_dg, SUM_RTOL, terms["dgamma"])
        hold("layer_norm_bwd dbeta vs plain", db, want_db, SUM_RTOL, terms["dbeta"])
    for rec in records["dw"]:
        m, x, dy = rec["module"], rec["x"], rec["dy"]
        # the model's weights as it uses them: [C, 1, 7, 7] fp32 cast to the
        # compute dtype, in the kernel's [7, 7, C] layout
        w = m.weight.to(rec["dtype"])[:, 0].permute(1, 2, 0)
        y = dw.depthwise_conv7x7(x, w)
        dx, dwg = dw.dwconv7x7_bwd(x, w, dy)
        hold("dwconv7x7_fwd vs model", y + m.bias.to(y.dtype), rec["y"], MODEL_RTOL)
        hold("dwconv7x7 dx vs model", dx, rec["dx"], MODEL_RTOL)
        hold("dwconv7x7_dw vs model", dwg, grad_of[m.weight][:, 0].permute(1, 2, 0), MODEL_RTOL)
        hold("dwconv7x7_fwd vs plain", y, dw.dwconv7x7_ref(x.float(), w.float()), OP_RTOL)
        hold("dwconv7x7 dx vs plain", dx, dw.dwconv7x7_ref(dy.float(), w.float(), flip=True),
             OP_RTOL)
        hold("dwconv7x7_dw vs plain", dwg, dw.dwconv7x7_dw_ref(x, dy, torch.float32), OP_RTOL)
    return errs, nearest


def replay_note(nearest: dict) -> str:
    """A log note of `_replay`'s errors, each beside its tolerance."""
    return ("max|d| (tolerance) of the op nearest its tolerance: "
            + ", ".join(f"{k} {e:.3e} ({t:.3e})" for k, (e, t) in nearest.items())
            + f" (vs model {MODEL_RTOL:g} of max|ref|, vs plain {OP_RTOL:g}; dgamma and dbeta "
            f"per column {MODEL_SUM_RTOL:g} and {SUM_RTOL:g} of max|ref| + "
            f"{SUM_ROUNDING_UNITS} x 2^-24 of the column's sum of |terms|)")


def conv1x1_bound(M: int, K: int, N: int, bn_in: bool, itemsize: int = 2):
    """(bound_ms, bound_by) of the fused 1x1 conv + BN statistics: x [M, K]
    and w [K, N] read, y [M, N] written in bf16, the fp32 statistics [2, N]
    written (and the fp32 scale and shift [K] read with the prologue), against
    2MKN flops on the bf16 tensor cores."""
    t_bytes = ((M * K + K * N + M * N) * itemsize + 2 * N * 4
               + (2 * K * 4 if bn_in else 0)) / HBM_BYTES_PER_S
    t_flops = 2 * M * K * N / BF16_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def hold_stats(name: str, stats, ref_y, ref_stats, rtol: float) -> tuple:
    """(max_abs_err of the column sums, of the sums of squares) of `stats`
    against `ref_stats`, each column's sum within rtol of its sum of |y|
    (ref_y's) and its sum of squares within rtol of itself; raises otherwise."""
    import torch

    tol = (rtol * ref_y.float().abs().sum(0), rtol * ref_stats[1])
    errs = []
    for r, what in ((0, "sum"), (1, "sum of squares")):
        d = (stats[r] - ref_stats[r]).abs()
        if not bool(torch.isfinite(d).all()) or bool((d > tol[r]).any()):
            worst = int((d - tol[r]).argmax())
            raise AssertionError(f"{name} column {what}: |d| {d[worst].item()} > "
                                 f"{tol[r][worst].item()} at column {worst}")
        errs.append(d.max().item())
    return tuple(errs)


def _k2_inputs(M: int, K: int, N: int, bn_in: bool, device):
    """Seeded bf16 x [M, K] (post-ReLU values without the prologue, a conv
    output with it), w [K, N] of std sqrt(2 / K), and with the prologue an
    fp32 scale and shift [K]."""
    import torch

    g = torch.Generator(device=device).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=device)
    x = (x if bn_in else torch.relu(x)).bfloat16()
    w = (torch.randn((K, N), generator=g, device=device) * (2.0 / K) ** 0.5).bfloat16()
    if not bn_in:
        return x, w, None, None
    scale = 0.5 + torch.rand(K, generator=g, device=device)
    shift = 0.3 * torch.randn(K, generator=g, device=device)
    return x, w, scale, shift


def check_conv1x1(shape, device, timed: bool = True):
    """The fused 1x1 conv + BN statistics kernel against its plain version
    (fp32 product of the same bf16 inputs) at (M, K, N, prologue): y within
    OP_RTOL of max|ref|, the statistics by `hold_stats`, and two runs bitwise
    equal. When `timed`: kernel, plain, cuBLAS `x @ w` alone (the library
    yardstick) and the unfused chain (prologue, `x @ w`, the two column
    reductions in torch) ms by CUDA events, the device ms per call of the
    kernel, of `x @ w` and of the chain from traces, and the bound."""
    import torch

    from imageclassification_tpu_torch.ops import conv1x1_bn as k2

    M, K, N, bn_in = shape
    x, w, scale, shift = _k2_inputs(M, K, N, bn_in, device)
    y, stats = k2.conv1x1_bn_stats(x, w, scale, shift)
    again = k2.conv1x1_bn_stats(x, w, scale, shift)
    torch.cuda.synchronize()
    if not (torch.equal(y, again[0]) and torch.equal(stats, again[1])):
        raise AssertionError(f"conv1x1_bn {shape}: two runs differ")  # no atomics
    ref_y, ref_stats = k2.conv1x1_bn_ref(x, w, scale, shift)
    y_err, _ = _hold(f"conv1x1_bn y {shape}", y, ref_y.float(), OP_RTOL)
    xf = x.float() if not bn_in else torch.relu(x.float() * scale + shift).bfloat16().float()
    ref_full = xf @ w.float()  # the fp32 product, before y is rounded
    s_err, q_err = hold_stats(f"conv1x1_bn stats {shape}", stats, ref_full, ref_stats, SUM_RTOL)
    row = dict(shape=[M, K, N], bn_in=bn_in, errs={"y": y_err, "sum": s_err, "sumsq": q_err})
    if timed:
        iters = max(10, min(200, int(4e9 // (M * (K + N)))))

        def chain():
            xa = torch.relu(x.float() * scale + shift).bfloat16() if bn_in else x
            ya = (xa @ w).float()
            return ya.sum(0), (ya * ya).sum(0)

        row["ms"] = time_ms(lambda: k2.conv1x1_bn_stats(x, w, scale, shift), iters)
        row["plain_ms"] = time_ms(lambda: k2.conv1x1_bn_ref(x, w, scale, shift),
                                  max(3, iters // 10))
        row["library_ms"] = time_ms(lambda: x @ w, iters)
        row["chain_ms"] = time_ms(chain, iters)
        row["device_ms"] = _device_ms(lambda: k2.conv1x1_bn_stats(x, w, scale, shift),
                                      {"conv1x1_bn_kernel": 1, "sum_partials": 1})
        row["library_device_ms"] = _library_device_ms(lambda: x @ w)
        row["chain_device_ms"] = _library_device_ms(chain)
        row["bound"] = conv1x1_bound(M, K, N, bn_in)
        log(f"conv1x1_bn {'bn_in ' if bn_in else ''}M,K,N={M},{K},{N} bf16: kernel "
            f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), plain {row['plain_ms']:.4f}, "
            f"cuBLAS x@w {row['library_ms']:.4f} (device {row['library_device_ms']:.4f}), "
            f"unfused chain {row['chain_ms']:.4f} (device {row['chain_device_ms']:.4f}), "
            f"kernel/cuBLAS device {row['device_ms'] / row['library_device_ms']:.3f}, bound "
            f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), bound/device "
            f"{row['bound'][0] / row['device_ms']:.3f}; bitwise equal over two runs")
    log(f"conv1x1_bn {shape}: max|d| vs plain y {y_err:.3e} (tol 2^-7 of max|ref|), column sum "
        f"{s_err:.3e}, sum of squares {q_err:.3e} (tol {SUM_RTOL} of each column's sum of |y|, "
        f"sum of squares)")
    return row


def jax_resnet_shapes(stage_sizes, block: str, width: int, num_classes: int):
    """The JAX ResNet's flat parameter and batch-statistics names and shapes
    (`imageclassification_tpu/models/resnet.py`, plain Bottleneck or
    BasicBlock), written out here: the layout a checkpoint of the port must
    have. Returns (params, batch_stats)."""
    params = {"conv_stem/kernel": (7, 7, 3, width), "bn_stem/scale": (width,),
              "bn_stem/bias": (width,)}
    stats = {"bn_stem/mean": (width,), "bn_stem/var": (width,)}

    def bn(name, c):
        params.update({f"{name}/scale": (c,), f"{name}/bias": (c,)})
        stats.update({f"{name}/mean": (c,), f"{name}/var": (c,)})

    cin, k = width, 0
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2 ** i
        for j in range(n_blocks):
            b = f"{block}_{k}"
            if block == "Bottleneck":
                convs = [(1, cin, f), (3, f, f), (1, f, 4 * f)]
                out = 4 * f
            else:
                convs = [(3, cin, f), (3, f, f)]
                out = f
            if cin != out or (i > 0 and j == 0):
                convs.append((1, cin, out))
            for c, (ks, a, o) in enumerate(convs):
                params[f"{b}/Conv_{c}/kernel"] = (ks, ks, a, o)
                bn(f"{b}/BatchNorm_{c}", o)
            cin, k = out, k + 1
    params.update({"head/kernel": (cin, num_classes), "head/bias": (num_classes,)})
    return params, stats


def _k2_launch_counts():
    from imageclassification_tpu_torch.ops.conv1x1_bn import conv1x1_bn_stats as k

    return {"k2": k.launches, "k2_bn_in": k.launches_bn_in}


def _all_launch_counts():
    return {**_launch_counts(), **_op_launch_counts(), **_k2_launch_counts()}


def _reset_all_launches() -> None:
    from imageclassification_tpu_torch.ops import conv1x1_bn, flash_attention

    flash_attention.reset_launches()
    _reset_op_launches()
    conv1x1_bn.reset_launches()


def _bn_training(work: str, device: str, flags: list, shapes: tuple, what: str, img: int,
                 num_classes: int, per_class: int, batch: int, epochs: int, seed: int = 0,
                 images: str = None):
    """The training path of a BatchNorm model (or, with no statistics in
    `shapes`, a model without BatchNorm) through the port's train.main on
    `device` with the default training flags (AdamW, mixup, exact-mode
    accuracy) and `flags`, on a seeded image folder. The model runs F.conv2d
    and its BatchNorm, no kernel of the port: every launch count must stay
    0. Checks the checkpoint's JAX layout (parameters and batch statistics
    as `shapes` gives them, optimizer), its exact reload (weights and
    statistics) by the port's val.initialize_model, and val_precision on
    it."""
    from imageclassification_tpu_torch import val

    images = images or _train_images(work, num_classes, per_class, seed)
    _reset_all_launches()
    state, args, records, wall_s, _ = _train_main(
        work, images, flags + ["--input_size", str(img), "--batch_size", str(batch), "--epochs",
                               str(epochs), "--warmup_epochs", "1", "--device", device])
    if any(_all_launch_counts().values()):
        raise AssertionError(f"the {what} training path launched a kernel: {_all_launch_counts()}")
    path = os.path.join(args.output_dir, f"checkpoint-{epochs - 1}.pth")
    with open(path, "rb") as f:
        ck = pickle.load(f)
    want, want_stats = shapes
    if {k: v.shape for k, v in ck["model"].items()} != want:
        raise AssertionError(f"{path}: parameters not in the JAX layout")
    if {k: v.shape for k, v in ck.get("batch_stats", {}).items()} != want_stats:
        raise AssertionError(f"{path}: batch statistics not in the JAX layout")
    check_optimizer_state(path, ck["optimizer"], want, args.opt, len(records))
    loaded, _ = val.initialize_model(path, model_ema=False, device=device)
    carried = max((loaded.state_dict()[k] - v).abs().max().item()
                  for k, v in state.model.state_dict().items())
    if carried != 0.0:
        raise AssertionError(f"{path}: reloaded weights or statistics differ from the run's by "
                             f"{carried}")
    moved = max([(v - (1.0 if k.endswith("running_var") else 0.0)).abs().max().item()
                 for k, v in state.model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))], default=None)
    if want_stats and not moved > 0:
        raise AssertionError("the running statistics never moved from their initial values")
    n_images = num_classes * per_class
    tp, fp, fn = val.val_precision(images, path, img, model_ema=True, batch_size=batch,
                                   device=device)
    if not (tp.sum() + fp.sum() == n_images and tp.sum() + fn.sum() == n_images):
        raise AssertionError(f"val_precision counts do not cover {n_images} images")
    return {"state": state, "args": args, "records": records, "wall_s": wall_s,
            "checkpoint": path, "images": images, "steps_per_epoch": len(records) // epochs,
            "val_top1": float(tp.sum() / n_images), "num_classes": num_classes}


def run_resnet_training(work: str, device: str, model: dict, img: int, num_classes: int,
                        per_class: int, batch: int, epochs: int, seed: int = 0,
                        images: str = None):
    """`_bn_training` of `--model {model name}`, a ResNet."""
    shapes = jax_resnet_shapes(model["stage_sizes"], model["block"], model["width"], num_classes)
    return _bn_training(work, device, ["--model", model["name"]], shapes, "ResNet", img,
                        num_classes, per_class, batch, epochs, seed, images)


def jax_efficientvit_shapes(model: dict, img: int, num_classes: int):
    """The JAX EfficientViT's flat parameter and batch-statistics names and
    shapes at `img` x `img` (`imageclassification_tpu/models/efficientvit.py`:
    key_dim 16, kernels 5, windows 7), written out here: the layout a
    checkpoint of the port must have. Returns (params, batch_stats)."""
    params, stats = {}, {}

    def cbn(name, cin, cout, k=1, groups=1):
        params[f"{name}/Conv_0/kernel"] = (k, k, cin // groups, cout)
        for leaf in ("scale", "bias"):
            params[f"{name}/BatchNorm_0/{leaf}"] = (cout,)
        for leaf in ("mean", "var"):
            stats[f"{name}/BatchNorm_0/{leaf}"] = (cout,)

    def ffn(name, d):
        cbn(f"{name}/ConvBN_0", d, 2 * d)
        cbn(f"{name}/ConvBN_1", 2 * d, d)

    dims, key_dim = model["embed_dims"], 16
    cin, res = 3, img
    for i, f in enumerate((dims[0] // 8, dims[0] // 4, dims[0] // 2, dims[0])):
        cbn(f"patch_embed{i}", cin, f, 3)
        cin, res = f, (res - 1) // 2 + 1
    for s, (dim, depth, heads) in enumerate(zip(dims, model["depths"], model["num_heads"])):
        if s:
            prev, merge = dims[s - 1], f"sub{s}_merge"
            hid = 4 * prev
            cbn(f"sub{s}_dw0", prev, prev, 3, prev)
            ffn(f"sub{s}_ffn0", prev)
            cbn(f"{merge}/ConvBN_0", prev, hid)
            cbn(f"{merge}/ConvBN_1", hid, hid, 3, hid)
            for j, (a, b) in enumerate(((hid, hid // 4), (hid // 4, hid))):
                params[f"{merge}/SqueezeExcite_0/Conv_{j}/kernel"] = (1, 1, a, b)
                params[f"{merge}/SqueezeExcite_0/Conv_{j}/bias"] = (b,)
            cbn(f"{merge}/ConvBN_2", hid, dim)
            cbn(f"sub{s}_dw1", dim, dim, 3, dim)
            ffn(f"sub{s}_ffn1", dim)
            res = (res - 1) // 2 + 1
        window = min(7, res)
        for b in range(depth):
            blk = f"stage{s}_block{b}"
            attn = f"{blk}/mixer/attn"
            cbn(f"{blk}/dw0", dim, dim, 3, dim)
            ffn(f"{blk}/ffn0", dim)
            params[f"{attn}/attention_biases"] = (heads, window * window)  # |dx|, |dy| offsets
            for i in range(heads):
                cbn(f"{attn}/qkv{i}", dim // heads, 2 * key_dim + dim // heads)
                cbn(f"{attn}/dw_q{i}", key_dim, key_dim, 5, key_dim)
            cbn(f"{attn}/proj", dim, dim)
            cbn(f"{blk}/dw1", dim, dim, 3, dim)
            ffn(f"{blk}/ffn1", dim)
    params.update({"head_bn/scale": (dims[-1],), "head_bn/bias": (dims[-1],),
                   "head/kernel": (dims[-1], num_classes), "head/bias": (num_classes,)})
    stats.update({"head_bn/mean": (dims[-1],), "head_bn/var": (dims[-1],)})
    return params, stats


def run_default_model_training(work: str, device: str, img: int, num_classes: int,
                               per_class: int, batch: int, epochs: int, seed: int = 0,
                               images: str = None):
    """`_bn_training` with no --model: the CLI's default, EfficientViT-M0
    (its head's dropout from the default --drop_path)."""
    shapes = jax_efficientvit_shapes(EFFICIENTVIT_M0, img, num_classes)
    run = _bn_training(work, device, [], shapes, "EfficientViT-M0", img, num_classes,
                       per_class, batch, epochs, seed, images)
    if run["args"].model != EFFICIENTVIT_M0["name"]:
        raise AssertionError(f"the CLI's default model is {run['args'].model}")
    return run


class _Tee:
    """A text stream that writes to `stream` and keeps a copy (`text()`)."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return self.stream.write(s)

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def text(self) -> str:
        return "".join(self.parts)


def run_finetune(work: str, device: str, model: dict, cfg: dict, num_classes: int,
                 per_class: int, epochs: int, images: str = None):
    """Fine-tuning from a torch/timm state_dict at another input size: a
    seeded port `cfg["name"]` of 1000 classes at cfg["src_img"] saved with
    torch.save (timm names, zip) stands in for a hub file, and `run_training`
    starts from it at cfg["img"] with --flash_attn and the default flags.
    The load must print the pos_embed resample and `Skipping mismatched
    key:` for the head alone, leave every other parameter equal to the
    file's and pos_embed within POS_EMBED_ATOL of a plain fp32 antialiased
    bicubic resample of the file's; the checkpoint must hold input_shape
    cfg["img"], and val_precision serves it at that size (on a card with
    predict captured: the flash forward launched once a block in each
    replayed batch, read from a trace). cfg["flags"]: more train.py flags."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch import train as port_train
    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.ops.flash_attention import flash_attention, reset_launches

    os.makedirs(work, exist_ok=True)
    src_path = os.path.join(work, f"{cfg['name']}.pth")
    src = create_model(cfg["name"], num_classes=1000, img_size=cfg["src_img"],
                       generator=torch.Generator().manual_seed(10))
    torch.save(src.state_dict(), src_path)
    del src
    file_sd = torch.load(src_path, map_location=device, weights_only=True)
    loaded = {}
    load = port_train._load_pretrained

    def load_and_keep(args, state):
        load(args, state)
        loaded.update({k: v.detach().clone() for k, v in state.model.state_dict().items()})

    tee = _Tee(sys.stdout)
    port_train._load_pretrained = load_and_keep
    try:
        with contextlib.redirect_stdout(tee):
            run = run_training(work, device, model, cfg["img"], num_classes, per_class,
                               cfg["batch"], epochs, images=images, pretrained_path=src_path,
                               flags=cfg.get("flags", ()))
    finally:
        port_train._load_pretrained = load
    printed = tee.text()
    g_src, g = cfg["src_img"] // model["patch"], cfg["img"] // model["patch"]
    resized = f"Resized pos_embed grid {g_src}x{g_src} -> {g}x{g}"
    if resized not in printed:
        raise AssertionError(f"the load did not print {resized!r}")
    skipped = sorted(line.split(":", 1)[1].strip() for line in printed.splitlines()
                     if line.startswith("Skipping mismatched key:"))
    if skipped != ["head/bias", "head/kernel"]:
        raise AssertionError(f"the load skipped {skipped}, expected the head alone")
    changed = [k for k, v in file_sd.items()
               if k not in ("head.weight", "head.bias", "pos_embed") and not torch.equal(loaded[k], v)]
    if changed or set(loaded) != set(file_sd):
        raise AssertionError(f"parameters after the load differ from the file's: {changed[:5]}")
    pos = file_sd["pos_embed"].float()
    grid = pos[:, 1:].reshape(1, g_src, g_src, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(g, g), mode="bicubic", align_corners=False, antialias=True)
    want = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, g * g, -1)], dim=1)
    pos_err = (loaded["pos_embed"] - want).abs().max().item()
    if not pos_err <= POS_EMBED_ATOL:
        raise AssertionError(f"pos_embed after the load differs from the resample of the file's "
                             f"by {pos_err} > {POS_EMBED_ATOL}")
    if run["input_shape"] != [1, cfg["img"], cfg["img"], 3]:
        raise AssertionError(f"{run['checkpoint']}: input_shape {run['input_shape']}")
    del file_sd, loaded

    n_images, batch = num_classes * per_class, cfg["batch"]
    reset_launches()
    tp, fp, fn = val.val_precision(run["images"], run["checkpoint"], cfg["img"], model_ema=True,
                                   batch_size=batch, device=device)
    res = {**run, "pos_err": pos_err, "skipped": skipped, "resized": resized,
           "serve_launches": flash_attention.launches, "val_top1": float(tp.sum() / n_images)}
    if not (tp.sum() + fp.sum() == n_images and tp.sum() + fn.sum() == n_images):
        raise AssertionError(f"val_precision at {cfg['img']} does not cover {n_images} images")
    if device == "cuda":
        m, _ = val.initialize_model(run["checkpoint"], True, device=device)
        predict = val._predict_fn(m)
        paths = [os.path.join(run["images"], d, f) for d in sorted(os.listdir(run["images"]))
                 for f in sorted(os.listdir(os.path.join(run["images"], d)))][:batch]
        _, imgs = next(val._batched(paths, cfg["img"], batch, torch.device(device)))
        res["serve_per_replay"] = replay_launches(lambda: predict(imgs), ["fwd"] * model["depth"])
        res["serve_ms_captured"] = time_ms(lambda: predict(imgs), iters=10)
        res["serve_ms_eager"] = time_ms(lambda: predict.eager(imgs), iters=10)
        res["serve_trace"] = trace(lambda: predict(imgs))
    return res


def _capture_resnet_convs(model):
    """Wrap the ResNet module's conv helper so that a forward records, for
    every conv module, its input (in the compute dtype) and its output.
    Returns (records keyed by the conv module, undo)."""
    from imageclassification_tpu_torch.models import resnet as port_resnet

    records = {}
    orig = port_resnet.conv2d_nhwc

    def conv2d_nhwc(x, conv, dtype):
        y = orig(x, conv, dtype)
        records[conv] = {"x": x.to(dtype).detach(), "y": y.detach()}
        return y

    port_resnet.conv2d_nhwc = conv2d_nhwc

    def undo():
        port_resnet.conv2d_nhwc = orig

    return records, undo


def resnet_conv_jobs(model, records):
    """The 1x1 convs of a train-mode forward of ResNet `model` as kernel
    jobs: (label, x [M, K], w [K, N] as the model uses it, (scale, shift) of
    the prologue or None, the model's conv output [M, N], the BatchNorm that
    follows it). conv1 and the downsample (on the strided input) are plain;
    conv3 takes conv2's output with bn2's batch statistics folded into the
    prologue, relu(bn2(.)) being its input."""
    import torch

    jobs = []

    def job(label, x, conv, prologue, bn, y):
        w = conv.weight.to(x.dtype)[:, :, 0, 0].t()
        jobs.append((label, x.reshape(-1, x.shape[-1]), w, prologue, y.reshape(-1, y.shape[-1]),
                     bn))

    for stage in model.stages():
        for blk in stage:
            if hasattr(blk, "conv3"):
                job("conv1", records[blk.conv1]["x"], blk.conv1, None, blk.bn1,
                    records[blk.conv1]["y"])
                mean, var = blk.bn2.batch_stats
                scale = blk.bn2.weight * torch.rsqrt(var + blk.bn2.eps)
                job("conv3", records[blk.conv2]["y"], blk.conv3,
                    (scale, blk.bn2.bias - mean * scale), blk.bn3, records[blk.conv3]["y"])
            if blk.downsample is not None:
                ds = blk.downsample[0]
                s = ds.stride[0]
                job("downsample", records[ds]["x"][:, ::s, ::s], ds, None, blk.downsample[1],
                    records[ds]["y"])
    return jobs


def replay_resnet_convs(model, args, batch, num_classes: int):
    """One train step's forward and backward on ResNet `model` (the step's
    own `loss_and_grads`, draws included) with every conv's tensors captured;
    then each 1x1 conv through the fused kernel (`resnet_conv_jobs`), with
    the launch counts set to 0 just before. The results are held against the
    model's own conv outputs (MODEL_RTOL of max|ref|) and the batch mean and
    variance of the BatchNorm that follows (MODEL_RTOL of the largest column
    mean of |y|, of the largest variance), and against the plain version
    (OP_RTOL; statistics by `hold_stats`). Returns the counts, the largest
    errors and the shapes replayed."""
    import torch

    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.ops import conv1x1_bn as k2

    step = build_train_step(model, args, num_classes, build_mixup(args, num_classes),
                            [args.lr], [args.weight_decay], seed=args.seed)
    model.train()
    records, undo = _capture_resnet_convs(model)
    try:
        step.loss_and_grads(model, batch, step.sample_draws(*batch["image"].shape[:3]))
    finally:
        undo()
    errs = {}

    def hold(key, err):
        errs[key] = max(errs.get(key, 0.0), err)

    k2.reset_launches()
    with torch.no_grad():
        jobs = resnet_conv_jobs(model, records)
        for label, x, w, pro, y_model, bn in jobs:
            scale, shift = pro or (None, None)
            y, stats = k2.conv1x1_bn_stats(x, w, scale, shift)
            M = x.shape[0]
            mean = stats[0] / M
            var = stats[1] / M - mean * mean
            hold("y vs model", _hold(f"{label} y vs model", y, y_model, MODEL_RTOL)[0])
            bn_mean, bn_var = bn.batch_stats
            tol_mean = MODEL_RTOL * y_model.float().abs().mean(0).max().item()
            d_mean = (mean - bn_mean).abs().max().item()
            if not d_mean <= tol_mean:
                raise AssertionError(f"{label} batch mean vs model: {d_mean} > {tol_mean}")
            hold("batch mean vs model", d_mean)
            hold("batch var vs model", _hold(f"{label} batch var vs model", var, bn_var,
                                             MODEL_RTOL)[0])
            ref_y, ref_stats = k2.conv1x1_bn_ref(x, w, scale, shift)
            hold("y vs plain", _hold(f"{label} y vs plain", y, ref_y, OP_RTOL)[0])
            xf = x.float()
            if pro is not None:
                xf = torch.relu(xf * scale + shift).to(x.dtype).float()
            s_err, q_err = hold_stats(f"{label} stats vs plain", stats, xf @ w.float(), ref_stats,
                                      SUM_RTOL)
            hold("sum vs plain", s_err)
            hold("sum of squares vs plain", q_err)
    if batch["image"].is_cuda:
        torch.cuda.synchronize()
    return {"launches": _k2_launch_counts(), "errs": errs,
            "n": {lab: sum(1 for j in jobs if j[0] == lab) for lab in ("conv1", "conv3",
                                                                      "downsample")},
            "shapes": sorted({(j[1].shape[0], j[1].shape[1], j[2].shape[1], j[3] is not None)
                              for j in jobs}),
            "counts": Counter((j[1].shape[0], j[1].shape[1], j[2].shape[1], j[3] is not None)
                              for j in jobs)}


def write_jpeg_folder(root: str, rng, num_classes: int, per_class: int, size: tuple) -> str:
    """root/class_{c}/img_{i}.jpg: JPEGs of `size` (width, height), quality
    90 with 4:2:0 chroma (PIL's default), a per-class tint over smooth ramps
    and noise."""
    from PIL import Image

    w, h = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ramps = np.stack([xx * 127 / w, yy * 127 / h, (xx + yy) * 63 / (w + h)], -1)
    for c in range(num_classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d)
        tint = rng.integers(0, 128, 3)
        for i in range(per_class):
            noise = rng.normal(0, 12, (-(-h // 8), -(-w // 8), 3)).repeat(8, 0).repeat(8, 1)
            noise = noise[:h, :w]
            arr = np.clip(tint + ramps + noise, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img_{i}.jpg"), quality=90)
    return root


def feed_note(images: str) -> str:
    """Which decoder fed a folder: the port's native decoder for its JPEGs
    where it built, PIL for everything else."""
    from imageclassification_tpu_torch.data import native_decode

    files = [f for _, _, fs in os.walk(images) for f in fs]
    jpegs = sum(f.lower().endswith((".jpg", ".jpeg")) for f in files)
    native = native_decode.get_lib() is not None
    return (f"{jpegs} JPEGs through the {'native decoder' if native else 'PIL decoder (native did not build)'}"
            f", {len(files) - jpegs} other files through PIL")


# the feed: BatchLoader on the train path at batch 64 and 224x224 over JPEGs
# of 500 x 375 (a common photo size), 10 batches a pass, with the thread
# counts of chip_smoke.py's training runs (8) and of the CLI's default (32)
FEED = dict(size=(500, 375), batch=64, img=224, steps=10, num_classes=5, workers=(8, 32),
            reps=1)  # one pass a setting (3 before, cut for the command's time)


def measure_feed(work: str, device: str, cfg: dict = FEED) -> dict:
    """`BatchLoader` img/s (batches on `device`, one pass of cfg["steps"]
    batches timed on the host clock, median of cfg["reps"]) over a seeded
    folder of cfg["size"] JPEGs, with the native decoder and with PIL, at
    each thread count of cfg["workers"]; and the host's cpu count."""
    import torch

    from imageclassification_tpu_torch.data import native_decode
    from imageclassification_tpu_torch.data.folder import scan_folder
    from imageclassification_tpu_torch.data.loader import BatchLoader

    n = cfg["steps"] * cfg["batch"]
    per_class = -(-n // cfg["num_classes"])
    images = write_jpeg_folder(os.path.join(work, "feed_jpegs"), np.random.default_rng(7),
                               cfg["num_classes"], per_class, cfg["size"])
    dataset = scan_folder(images)
    idx = np.arange(n).reshape(cfg["steps"], cfg["batch"])
    res = {"cpu_count": os.cpu_count(), "images": images,
           "native_built": native_decode.get_lib() is not None}

    def one_pass(workers: int) -> float:
        loader = BatchLoader(dataset, idx, cfg["img"], train=True, device=device, seed=0,
                             num_workers=workers)
        t0 = time.perf_counter()
        seen = sum(b["image"].shape[0] for b in loader)
        if device == "cuda":
            torch.cuda.synchronize()
        return seen / (time.perf_counter() - t0)

    for decoder in ("native", "pil"):
        if decoder == "native" and not res["native_built"]:
            continue
        for w in cfg["workers"]:
            if decoder == "pil":
                # the loader decodes through PIL where the library is missing
                with mock.patch.object(native_decode, "get_lib", lambda: None):
                    rates = [one_pass(w) for _ in range(cfg["reps"])]
            else:
                rates = [one_pass(w) for _ in range(cfg["reps"])]
            res[f"{decoder}_{w}"] = statistics.median(rates)
    return res


def feed_epochs(work: str, images: str, device: str, model: dict, img: int, batch: int,
                epochs: int = 2) -> list:
    """`train.main` of `model` with --flash_attn on the folder `images`, its
    wall time split by epoch into the steps (`train_one_epoch`), the time
    the steps waited for the loader's next batch inside them, the eval and
    the checkpoint writes. The first epoch holds the eager warm-up steps and
    the captures, so the last one is the steady state."""
    from imageclassification_tpu_torch import train as port_train

    timed = {"steps": [], "loader_wait": [], "eval": [], "checkpoint": []}
    saves = []
    orig = {"train_one_epoch": port_train.train_one_epoch, "evaluate": port_train.evaluate,
            "save_model": port_train.ckpt_io.save_model, "BatchLoader": port_train.BatchLoader}

    def clocked(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                (saves if name == "checkpoint" else timed[name]).append(time.perf_counter() - t0)
        return run

    class WaitedLoader(orig["BatchLoader"]):
        def __iter__(self):
            it, waited = super().__iter__(), 0.0
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    break
                waited += time.perf_counter() - t0
                yield b
            if self.train:
                timed["loader_wait"].append(waited)

    def epoch_loop(*a, **kw):
        saves.clear()
        out = clocked("steps", orig["train_one_epoch"])(*a, **kw)
        return out

    port_train.train_one_epoch = epoch_loop
    port_train.evaluate = clocked("eval", orig["evaluate"])
    port_train.ckpt_io.save_model = clocked("checkpoint", orig["save_model"])
    port_train.BatchLoader = WaitedLoader
    per_epoch = []
    try:
        flags = ["--model", model["name"], "--flash_attn", "true", "--input_size", str(img),
                 "--batch_size", str(batch), "--epochs", str(epochs), "--warmup_epochs", "1",
                 "--device", device]
        state, args, records, wall_s, _ = _train_main(work, images, flags)
    finally:
        port_train.train_one_epoch = orig["train_one_epoch"]
        port_train.evaluate = orig["evaluate"]
        port_train.ckpt_io.save_model = orig["save_model"]
        port_train.BatchLoader = orig["BatchLoader"]
    steps = len(records) // epochs
    for e in range(epochs):
        per_epoch.append({"steps_s": timed["steps"][e], "steps": steps,
                          "loader_wait_s": timed["loader_wait"][e], "eval_s": timed["eval"][e]})
    per_epoch[-1]["checkpoint_s"] = sum(saves)
    return per_epoch


# fine-tuning at 1024x1024, the recipe the JAX package gives --flash_attn for
# (imageclassification_tpu/models/vit.py:25-40): timm vit_base_patch16_224
# saved at 224 and trained at 1024, 64 x 64 patches and the cls token (N =
# 4097 in every flash launch), --layer_decay 0.65 and --remat, the default
# adamw; batch 16 when the step without remat fits on the card, else 8; fed
# from 5 classes of 1280 x 960 JPEGs, 2 epochs of 10 steps (cut in scale only)
HIRES = dict(name="vit_base_patch16_224", src_img=224, img=1024, batches=(16, 8),
             jpeg=(1280, 960), flags=("--layer_decay", "0.65", "--remat", "true"))


def fits_without_remat(model: dict, img: int, batch: int, num_classes: int) -> bool:
    """Whether one eager train step of `model` --flash_attn at `img` and
    `batch` without --remat (the default flags otherwise) runs without
    running out of the card's memory."""
    import gc

    import torch

    from imageclassification_tpu_torch.config import parse_args
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.optim.factory import create_optimizer

    args = parse_args(["--model", model["name"], "--flash_attn", "true"])
    dev = torch.device("cuda")
    fits = True
    try:
        m = create_model(model["name"], num_classes=num_classes, half_precision=True,
                         img_size=img, flash_attn=True).to(dev)
        state = create_train_state(m, create_optimizer(args.opt, m.parameters(), lr=args.lr,
                                                       weight_decay=args.weight_decay))
        step = build_train_step(m, args, num_classes, build_mixup(args, num_classes), [args.lr],
                                [args.weight_decay])
        batch = {"image": torch.randint(0, 256, (batch, img, img, 3), dtype=torch.uint8,
                                        device=dev),
                 "label": torch.randint(0, num_classes, (batch,), device=dev)}
        step(state, batch)["loss"]
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        fits = False
    finally:
        m = state = step = batch = None
        gc.collect()
        torch.cuda.empty_cache()
    return fits


def remat_timing(run: dict, depth: int, floors: dict) -> dict:
    """On the trained state of `run`: the captured step (as train.main runs
    it) with --remat and without, each its ms a step (CUDA events, one fixed
    batch), `torch.cuda.max_memory_allocated` over its capture and steps,
    and a trace; with --remat also the flash kernels' device ms a launch
    inside the step (`_device_ms` of the step, checked against its events
    ms and against `floors`: each kernel's least device ms a launch, from
    CUDA events of it alone at the step's shape)."""
    import gc

    import torch

    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.compiled import CapturedTrainStep
    from imageclassification_tpu_torch.engine.step import build_train_step

    state, nc = run["state"], run["num_classes"]
    batch = _fixed_batch(run, "cuda")
    out = {}
    for remat in (True, False):
        args = run["args"].replace(remat=remat)
        step = build_train_step(state.model, args, nc, build_mixup(args, nc), [args.lr],
                                [args.weight_decay], seed=args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        captured = CapturedTrainStep(step, torch.device("cuda"))

        def fn():
            return captured(state, batch)

        ms = time_ms(fn, iters=3, reps=2)
        res = {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated(), "trace": trace(fn, 3)}
        if remat:
            launches = {"flash_attention_fwd": 3 * depth, "flash_attention_bwd_dq": depth,
                        "flash_attention_bwd_dkv": depth}
            res["device_ms_per_launch"] = {
                name: _device_ms(fn, {name: n}, steps=3, events_ms=ms,
                                 floor_ms=floors[name] * n) / n
                for name, n in launches.items()}
        out["remat" if remat else "plain"] = res
        captured = step = fn = None
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dropout_remat_peak(model: dict, img: int, batch: int, num_classes: int) -> dict:
    """`torch.cuda.max_memory_allocated` over one eager train step of `model`
    --flash_attn with dropout 0.1 and drop path 0.1 (full-shape masks; the
    attention takes its plain path), with --remat and without. Whole-loss
    remat materialises every activation again before the backward, so it
    peaks where the step without it does; its recompute draws the masks
    again from a generator of its own and keeps none, so it may peak higher
    by no more than 1 % (allocator rounding moved the two peaks about 1 MB
    apart on the card). A remat that kept the forward's fp32 draws would
    hold 4 bytes an element of every mask on top: 2.4 GB here, a quarter of
    the peak."""
    import gc

    import torch

    from imageclassification_tpu_torch.config import parse_args
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import create_model
    from imageclassification_tpu_torch.optim.factory import create_optimizer

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    batch_t = {"image": torch.from_numpy(rng.integers(0, 256, (batch, img, img, 3),
                                                      dtype=np.uint8)).to(dev),
               "label": torch.from_numpy(rng.integers(0, num_classes, batch)).to(dev)}
    out = {}
    for remat in (False, True):
        args = parse_args(["--model", model["name"], "--flash_attn", "true",
                           "--remat", str(remat).lower()])
        m = create_model(model["name"], num_classes=num_classes, half_precision=True,
                         img_size=img, flash_attn=True, drop_rate=0.1, drop_path_rate=0.1,
                         generator=torch.Generator().manual_seed(0)).to(dev)
        state = create_train_state(m, create_optimizer(args.opt, m.parameters(), lr=args.lr,
                                                       weight_decay=args.weight_decay))
        step = build_train_step(m, args, num_classes, build_mixup(args, num_classes), [args.lr],
                                [args.weight_decay])
        step(state, batch_t)["loss"]  # the first step allocates the moments' workspaces
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = float(step(state, batch_t)["loss"])
        torch.cuda.synchronize()
        out["remat" if remat else "plain"] = (torch.cuda.max_memory_allocated(), loss)
        m = state = step = None
        gc.collect()
        torch.cuda.empty_cache()
    if not out["remat"][0] <= 1.01 * out["plain"][0]:
        raise AssertionError(f"--remat with dropout peaks at {out['remat'][0]} bytes, more than "
                             f"1 % above the step without it ({out['plain'][0]})")
    return out


def hires_checks(num_classes: int) -> dict:
    """Phase 10's batch (the first of HIRES["batches"] whose eager step
    without --remat fits on the card) and the flash kernels against their
    plain versions (fp32, a few batch elements at a time) and SDPA at the
    shape the path gives them, as in 3a and 3b, first in the child process
    of `late_phases`, on the empty card and a fresh profiler. Their CUDA
    events alone floor the readings inside the step."""
    import gc

    import torch

    hb = next((b for b in HIRES["batches"]
               if fits_without_remat(VIT_B16, HIRES["img"], b, num_classes)),
              HIRES["batches"][-1])
    log(f"high-resolution path: batch {hb} (the first of {HIRES['batches']} whose eager "
        f"step without --remat fits on the card)")
    n_hr = (HIRES["img"] // VIT_B16["patch"]) ** 2 + 1
    shape = (hb, n_hr, VIT_B16["heads"], VIT_B16["dim"] // VIT_B16["heads"])
    fwd, bwd = check_attention(shape, "cuda"), check_backward(shape, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    floors = {"flash_attention_fwd": alone_floor(fwd["ms"], fwd["host_ms"]),
              "flash_attention_bwd_dq": alone_floor(bwd["ms_dq"], bwd["host_ms_dq"]),
              "flash_attention_bwd_dkv": alone_floor(bwd["ms_dkv"], bwd["host_ms_dkv"])}
    return {"batch": hb, "shape": shape, "fwd": fwd, "bwd": bwd, "floors": floors}


def hires_phase(work: str, num_classes: int, epochs: int, checks: dict) -> dict:
    """Phase 10 (module docstring) on the batch and kernel rows of
    `hires_checks`: logs its lines and returns what the kernels line takes
    from it (the batch, the shape, the launches over the run, the flash
    kernels against their plain versions at the path's shape and their
    numbers inside the step)."""
    hb, hr_shape, floors = checks["batch"], checks["shape"], checks["floors"]
    fwd, bwd = checks["fwd"], checks["bwd"]
    n_hr = hr_shape[1]
    # 10 steps of hb an epoch after the default 0.9 split, which keeps
    # int(0.9 n) of a class's n images for training
    hr_per_class = hb * 9 // 4
    hr_images = write_jpeg_folder(os.path.join(work, "hires_jpegs"), np.random.default_rng(3),
                                  num_classes, hr_per_class, HIRES["jpeg"])
    hr_cfg = {**HIRES, "batch": hb}
    hr = run_finetune(os.path.join(work, "hires"), "cuda", VIT_B16, hr_cfg,
                      num_classes, hr_per_class, epochs, images=hr_images)
    losses = [r["loss"] for r in hr["records"]]
    log(f"high-resolution path: {HIRES['name']} state_dict (1000 classes, "
        f"{HIRES['src_img']}x{HIRES['src_img']}) through --pretrained_path at "
        f"{HIRES['img']}x{HIRES['img']} with --flash_attn {' '.join(HIRES['flags'])}, batch "
        f"{hb}: the load printed {hr['resized']!r} and skipped {hr['skipped']}; pos_embed "
        f"max|d| {hr['pos_err']:.3e} (tol {POS_EMBED_ATOL}); fed {feed_note(hr_images)} "
        f"({HIRES['jpeg'][0]} x {HIRES['jpeg'][1]}); {len(losses)} steps ({epochs} "
        f"epochs x {hr['steps_per_epoch']}), {hr['wall_s']:.1f} s for train.main; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}")
    log(f"high-resolution path launches per step of the run's captured step at N = {n_hr} "
        f"(trace, in device order: {2 * VIT_B16['depth']} forwards with lse, the forward "
        f"and its --remat recompute, then dQ and dK/dV, then {VIT_B16['depth']} forwards "
        f"without lse): {[dict(c) for c in hr['per_replay']]}; counted by the wrappers "
        f"over the run {hr['totals']}; {hr['checkpoint'].split('/')[-1]} input_shape "
        f"{hr['input_shape']}, reloaded to the run's exact weights")
    log(f"high-resolution checkpoint served by val_precision at {HIRES['img']}x"
        f"{HIRES['img']}: top-1 {hr['val_top1']:.3f}; per replayed batch (trace) "
        f"{dict(hr['serve_per_replay'][0])}; captured predict {hr['serve_ms_captured']:.3f} "
        f"ms/batch of {hb}, eager {hr['serve_ms_eager']:.3f}")
    rt = remat_timing(hr, VIT_B16["depth"], floors)
    for name in ("remat", "plain"):
        r = rt[name]
        log(f"train step ViT-B/16 {HIRES['img']}x{HIRES['img']} bf16 --layer_decay 0.65, "
            f"{'--remat' if name == 'remat' else 'no --remat'}, captured, batch {hb}: "
            f"{r['ms']:.3f} ms/step, {hb / (r['ms'] / 1e3):.2f} img/s (CUDA events); "
            f"torch.cuda.max_memory_allocated {r['peak_bytes'] / 2 ** 30:.2f} GiB")
        log_trace(f"ViT-B/16 {HIRES['img']}x{HIRES['img']} batch {hb} train step, captured, "
                  f"{name}", r["trace"], "step")
    hr_replay, hr_totals = hr["per_replay"][0], hr["totals"]
    hr_k1 = {}
    for kind, kernel, row, errs in (
            ("fwd", "flash_attention_fwd", fwd, None),
            ("dq", "flash_attention_bwd_dq", bwd, ("dq",)),
            ("dkv", "flash_attention_bwd_dkv", bwd, ("dk", "dv"))):
        dev = rt["remat"]["device_ms_per_launch"][kernel]
        bound = (fwd["bound_ms"], fwd["bound_by"]) if kind == "fwd" else bwd["bounds"][kind]
        checked = ({"max_abs_err": fwd["max_abs_err"],
                    "errs": {"o": [fwd["max_abs_err"], fwd["tol"]]}, "ms": fwd["ms"],
                    "plain_ms": fwd["plain_ms"], "library_ms": fwd["library_ms"],
                    "device_ms_alone": fwd["device_ms"],
                    "library_device_ms": fwd["library_device_ms"]} if kind == "fwd" else
                   {"max_abs_err": max(bwd["errs"][e][0] for e in errs),
                    "errs": {e: list(bwd["errs"][e][:2]) for e in errs},
                    "ms": bwd[f"ms_{kind}"],
                    "plain_ms": bwd["plain_ms"], "library_ms": bwd["library_ms"],
                    "device_ms_alone": bwd[f"device_ms_{kind}"],
                    "library_device_ms": bwd["library_device_ms"]})
        hr_k1[kind] = {**checked, "launches_per_replay": hr_replay[kind], "device_ms": dev,
                       "floor_ms": floors[kernel], "bound_ms": bound[0], "bound_by": bound[1],
                       "gap_ms": hr_replay[kind] * (dev - bound[0])}
    log(f"flash kernels inside the captured --remat step at B,N,H,D={hr_shape}, device ms a "
        f"launch (repaired reader, held against the step's CUDA events and floored at half "
        f"the kernel's CUDA events alone): " + "; ".join(
            f"{k} {v['device_ms']:.4f} x {v['launches_per_replay']} launches (alone: events "
            f"{v['ms']:.4f}, device {v['device_ms_alone']:.4f}), bound {v['bound_ms']:.4f} "
            f"({v['bound_by']}), launches x (device - bound) {v['gap_ms']:.3f} ms"
            for k, v in hr_k1.items())
        + f"; SDPA at that shape (checked against its CUDA events): forward events "
          f"{fwd['library_ms']:.4f}, device {fwd['library_device_ms']:.4f}; backward events "
          f"{bwd['library_ms']:.4f}, device {bwd['library_device_ms']:.4f}")
    del hr, rt
    drop = dropout_remat_peak(VIT_B16, 224, 64, num_classes)
    log(f"ViT-B/16 224x224 batch 64, dropout 0.1 and drop path 0.1 (plain attention), one "
        f"eager step: torch.cuda.max_memory_allocated {drop['remat'][0]} bytes with --remat, "
        f"{drop['plain'][0]} without, which it may exceed by 1 % at most (losses "
        f"{drop['remat'][1]:.6f}, {drop['plain'][1]:.6f})")
    eq_hr = captured_vs_eager(VIT_B16, HIRES["img"], hb, num_classes, steps=4,
                              flags=HIRES["flags"])
    log(f"captured vs eager ViT-B/16 {HIRES['img']}x{HIRES['img']} --flash_attn "
        f"{' '.join(HIRES['flags'])} (drop_path 0.1, EMA with warmup), {eq_hr['steps']} steps "
        f"at batch {hb} from one seeded state and seeded generators: max|d| eager vs eager "
        f"{eq_hr['eager_gap']:.3e}, captured vs eager {eq_hr['captured_gap']:.3e}; losses "
        f"eager {eq_hr['losses'][0]}, captured {eq_hr['losses'][2]}; a non-finite step in "
        f"the replays: skipped {eq_hr['skipped']}, state unchanged bitwise")

    return {"batch": hb, "shape": hr_shape, "totals": hr_totals, "k1": hr_k1}


def feed_phase(work: str) -> None:
    """Phase 11 (module docstring): logs its lines."""
    feed = measure_feed(work, "cuda")
    log(f"feed: BatchLoader, batch {FEED['batch']}, {FEED['img']}x{FEED['img']} train path, "
        f"{FEED['size'][0]} x {FEED['size'][1]} JPEGs, {FEED['steps']} batches a pass, median "
        f"of {FEED['reps']}, host os.cpu_count() {feed['cpu_count']}: " + ", ".join(
            f"{k.replace('_', ' ')} threads {v:.1f} img/s" for k, v in feed.items()
            if k.startswith(("native_", "pil_")) and k != "native_built"))
    # (train.main's epochs on these JPEGs, split into steps, loader waits,
    # eval and checkpoint writes by `feed_epochs`, are no longer run here,
    # for the command's time; PERF.md keeps the earlier readings)


def launch_gap(rows, counts, key, gap) -> tuple:
    """(sum of launches x (device ms - bound ms), launches counted, launches
    left out) over one replayed train step: `counts` the replay's launches by
    shape, `rows` the timed rows of phase 3d or 3e, `key(row)` a row's shape
    as `counts` keys it and `gap(row)` its device ms less its bound for one
    launch of each kernel it stands for. Launches on shapes without a timed
    row are left out."""
    timed = {key(r): r for r in rows}
    total = sum(n * gap(timed[k]) for k, n in counts.items() if k in timed)
    counted = sum(n for k, n in counts.items() if k in timed)
    return total, counted, sum(counts.values()) - counted


# phase 12, the training recipes: the DeiT-style recipe (RandAugment and
# distillation from phase 5's checkpoint) at full width, each --aa policy
# alone at batch 64 x 224x224, and --prune_mask fine-tuning from phase 5's
# checkpoint with half of each eligible weight zeroed
RECIPE_FLAGS = ("--aa", "rand-m9-mstd0.5-inc1", "--distillation_alpha", "0.5",
                "--distillation_tau", "2.0")
POLICIES = ("rand-m9-mstd0.5-inc1", "rand-m9-n3-mstd0.5", "original", "v0", "abel-n2")
# a policy on the card against the port on the CPU with the same draws, at the
# CPU tests' tolerance (tests/test_torch_augment_policies.py): every value to
# 1e-3 but a share of at most 1e-3 of them, where a 1-ulp difference (the
# card's sin and cos, another libm) moves a value across a rounding or
# truncation level after a geometric op
POLICY_ATOL, POLICY_SHARE = 1e-3, 1e-3
# the printed sparsity of --prune_mask on weights with half of each eligible
# tensor zeroed (odd sizes and ties at zero move it by a few elements)
PRUNE_SPARSITY, PRUNE_TOL = 0.5, 0.01


def _prune_eligible(key: str, arr) -> bool:
    """The JAX package's rule (checkpoint/io.py derive_prune_masks)."""
    return (key.endswith("kernel") and arr.ndim >= 2 and arr.size > 4096
            and not key.endswith("head/kernel"))


def prune_checkpoint(src: str, dst: str, fraction: float = 0.5) -> int:
    """The weights of the checkpoint `src` with the `fraction` smallest |w|
    of each eligible JAX weight set to zero, written to `dst` through the
    port's checkpoint/io.py (weights only: a --pretrained_path file).
    Returns the number of weights pruned."""
    from imageclassification_tpu_torch.checkpoint import io as ckpt_io

    ck = ckpt_io.load_checkpoint(src)
    model, n = {}, 0
    for k, v in ck["model"].items():
        v = np.array(v, np.float32)
        if _prune_eligible(k, v):
            v.reshape(-1)[np.argsort(np.abs(v), axis=None)[: int(v.size * fraction)]] = 0.0
            n += 1
        model[k] = v
    ckpt_io.write_checkpoint(dst, {k: ck[k] for k in ("format_version", "model_spec",
                                                      "input_shape", "num_classes")}
                             | {"model": model})
    return n


def _printed_by(fn):
    """(fn(), what it printed), the output still shown."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn()
    return out, tee.text()


def _events_and_device_ms(fn) -> tuple:
    """(CUDA events ms a call, device ms a call from traces) of fn()."""
    ms = time_ms(fn, iters=10, reps=3)
    return ms, _library_device_ms(fn, events_ms=ms)


def run_recipe(work: str, device: str, model: dict, cfg: dict, teacher: str, images: str):
    """12a: `run_training` with --aa rand-m9-mstd0.5-inc1 and distillation
    from `teacher` (alpha 0.5, tau 2): the three replays launch the
    teacher's forwards too. On a card, the recipe's step captured and eager
    on the trained weights, and the device ms of the augmentation (with the
    policy, and with ColorJitter) and of the teacher's forward, each
    alone."""
    import torch

    from imageclassification_tpu_torch import val
    from imageclassification_tpu_torch.data.augment import AugmentPipeline, eval_preprocess
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.step import build_train_step

    run, printed = _printed_by(lambda: run_training(
        work, device, model, cfg["img"], cfg["num_classes"], cfg["per_class"], cfg["batch"],
        cfg["epochs"], images=images, flags=("--teacher_path", teacher, *RECIPE_FLAGS)))
    if f"Distillation: teacher={teacher} alpha=0.5 tau=2.0" not in printed:
        raise AssertionError("train.main did not print its teacher")
    if device != "cuda":
        return run
    args, state, nc = run["args"], run["state"], run["num_classes"]
    t_model, _ = val.initialize_model(teacher, False, half_precision=True, dequantize=True,
                                      device=device)
    batch = _fixed_batch(run, device)
    plain = args.replace(aa="", teacher_path="", distillation_alpha=0.0)
    # the recipe's step timed (the default step beside it no longer, for the
    # command's time: phase 5b times that cell)
    step = build_train_step(state.model, args, nc, build_mixup(args, nc), [args.lr],
                            [args.weight_decay], seed=args.seed, teacher=t_model)
    run["timing"] = time_captured_and_eager(state, step, batch)
    B, H, W = batch["image"].shape[:3]
    gen = torch.Generator(device=device).manual_seed(1)
    for key, a in (("augment", args), ("augment_jitter", plain)):
        pipe = AugmentPipeline(a)
        run[key] = _events_and_device_ms(lambda: pipe(batch["image"], pipe.sample(B, H, W, gen)))
    x = eval_preprocess(batch["image"])
    with torch.no_grad():
        run["teacher_forward"] = _events_and_device_ms(lambda: t_model(x))
    return run


def policy_checks(device: str, batch: int, img: int, seed: int = 5) -> list:
    """12b: each --aa policy alone on seeded uint8-valued images [batch,
    img, img, 3]: the card's output against the port on the CPU with the
    same draws (POLICY_ATOL but POLICY_SHARE); on a card, a captured run
    (one CUDA graph of draws and policy, its generator registered) equal to
    the eager run bitwise, and ms a batch by CUDA events, eager and
    captured, beside ColorJitter's (its three factors drawn alike)."""
    import torch

    from imageclassification_tpu_torch.config import parse_args
    from imageclassification_tpu_torch.data.augment import (AugmentPipeline, _uniform,
                                                            color_jitter_batch)
    from imageclassification_tpu_torch.engine.compiled import Graphed

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (batch, img, img, 3)).astype(np.float32))
    xd = x.to(device)
    jitter = parse_args([]).color_jitter
    jitter_draws = (lambda b, g: [_uniform(b, max(0.0, 1 - jitter), 1 + jitter, g)
                                  for _ in range(3)])
    rows = []
    for aa in POLICIES + ("color_jitter",):
        if aa == "color_jitter":
            sample, apply = jitter_draws, lambda im, d: color_jitter_batch(im, *d)
        else:
            policy = AugmentPipeline(parse_args(["--aa", aa])).aa
            sample, apply = policy.sample, policy
        row = {"policy": aa}
        gen = torch.Generator(device=device).manual_seed(seed)
        draws = sample(batch, gen)
        out = apply(xd, draws)
        if aa != "color_jitter":
            to_cpu = (lambda d: {k: v.cpu() for k, v in d.items()})
            cpu = apply(x, to_cpu(draws))
            err = (out.cpu() - cpu).abs()
            row.update(max_abs_err=err.max().item(), share_off=(err > POLICY_ATOL).float().mean().item(),
                       changed=((out.cpu() - x).abs() > 1).float().mean().item())
            if not row["share_off"] <= POLICY_SHARE:
                raise AssertionError(f"--aa {aa} on {device}: {row['share_off']:.2e} of the values "
                                     f"beyond {POLICY_ATOL} of the CPU's (max {row['max_abs_err']})")
        if device == "cuda":
            eager_gen = torch.Generator(device=device).manual_seed(seed + 1)
            graph_gen = torch.Generator(device=device).manual_seed(seed + 1)
            want = apply(xd, sample(batch, eager_gen)).clone()
            graphed = Graphed(lambda im: apply(im, sample(batch, graph_gen)), torch.device(device),
                              [graph_gen], rehearse=False)
            row["captured_equal"] = torch.equal(graphed(xd), want)
            if not row["captured_equal"]:
                raise AssertionError(f"--aa {aa}: the captured run differs from the eager one")
            row["ms_eager"] = time_ms(lambda: apply(xd, sample(batch, eager_gen)), iters=10, reps=3)
            row["ms_captured"] = time_ms(lambda: graphed(xd), iters=10, reps=3)
        rows.append(row)
    return rows


def run_prune(work: str, device: str, model: dict, cfg: dict, src: str, images: str):
    """12c: phase 5's checkpoint `src` with half of each eligible weight
    zeroed (`prune_checkpoint`), then `run_training` from it with
    --prune_mask true --model_ema true for one epoch: the printed sparsity
    within PRUNE_TOL of PRUNE_SPARSITY, every pruned entry of the model and
    of the EMA in checkpoint-0.pth exactly 0, and some other entry moved. On
    a card, the masked step captured and eager on the trained weights."""
    from imageclassification_tpu_torch.checkpoint import io as ckpt_io
    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.step import build_train_step

    os.makedirs(work, exist_ok=True)
    pruned = os.path.join(work, "pruned.pth")
    n_pruned = prune_checkpoint(src, pruned)
    run, printed = _printed_by(lambda: run_training(
        work, device, model, cfg["img"], cfg["num_classes"], cfg["per_class"], cfg["batch"], 1,
        images=images, pretrained_path=pruned, flags=("--prune_mask", "true",
                                                      "--model_ema", "true")))
    line = next((l for l in printed.splitlines() if l.startswith("Prune-mask fine-tune:")), "")
    if not line:
        raise AssertionError("train.main did not print the prune-mask sparsity")
    run["sparsity"] = float(line.split("enforcing")[1].split()[0])
    if abs(run["sparsity"] - PRUNE_SPARSITY) > PRUNE_TOL:
        raise AssertionError(f"printed sparsity {run['sparsity']}, expected {PRUNE_SPARSITY}")
    before = ckpt_io.load_checkpoint(pruned)["model"]
    after = ckpt_io.load_checkpoint(run["checkpoint"])
    moved, held = 0, 0
    for k, v in before.items():
        if not _prune_eligible(k, v):
            continue
        zero = v == 0
        for part in ("model", "model_ema"):
            if np.count_nonzero(after[part][k][zero]):
                raise AssertionError(f"{part} {k}: a pruned entry is not 0 after training")
        held += int(zero.sum())
        moved += int(np.count_nonzero(after["model"][k][~zero] != v[~zero]))
    if not moved:
        raise AssertionError("no unpruned entry moved")
    run.update(n_pruned=n_pruned, held=held, moved=moved)
    if device == "cuda":
        args, state, nc = run["args"], run["state"], run["num_classes"]
        masks, _ = ckpt_io.derive_prune_masks(state.model)
        step = build_train_step(state.model, args, nc, build_mixup(args, nc), [args.lr],
                                [args.weight_decay], seed=args.seed, prune_masks=masks)
        run["timing"] = time_captured_and_eager(state, step, _fixed_batch(run, device))
    return run


def _timing_summary(timing: dict) -> dict:
    return {name: {"ms": ms, "wall_ms": tr[0], "device_ms": tr[1], "busy_ms": tr[3],
                   "idle_share": 1 - tr[3] / tr[0]} for name, (ms, tr) in timing.items()}


def recipes_phase(work: str, device: str, model: dict, cfg: dict, teacher: str,
                  images: str) -> dict:
    """Phase 12 (module docstring) on `model` at `cfg`'s sizes, with phase
    5's checkpoint `teacher` and folder `images`: logs its lines and
    returns what the kernels line takes from it."""
    b, img, depth = cfg["batch"], cfg["img"], model["depth"]
    rec = run_recipe(os.path.join(work, "recipe"), device, model, cfg, teacher, images)
    losses = [r["loss"] for r in rec["records"]]
    log(f"recipe path (12a): train.main --model {model['name']} --flash_attn true "
        f"{' '.join(RECIPE_FLAGS)} --teacher_path <phase 5's checkpoint-1.pth>, {img}x{img} "
        f"batch {b}, {len(losses)} steps ({cfg['epochs']} epochs x {rec['steps_per_epoch']}), "
        f"{rec['wall_s']:.1f} s for train.main; losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"{rec['checkpoint'].split('/')[-1]} in the JAX layout, reloaded to the run's exact "
        f"weights")
    out = {"recipe": {"totals": rec["totals"], "losses": losses}}
    if device == "cuda":
        log(f"recipe path launches per step of the run's captured step (trace, in device order: "
            f"{depth} student forwards with lse, {depth} teacher forwards without lse, the "
            f"backward's dQ and dK/dV kernels, {depth} accuracy forwards without lse): "
            f"{[dict(c) for c in rec['per_replay']]}; counted by the wrappers over the run "
            f"{rec['totals']}")
        log_step_timing(f"ViT-B/16 {img}x{img} bf16, DeiT-style recipe (--aa rand, distillation)",
                        b, rec["timing"])
        for key, what in (("augment", "the augmentation with --aa rand-m9-mstd0.5-inc1 (flips, "
                                      "policy, normalize, erasing; draws included)"),
                          ("augment_jitter", "the augmentation with ColorJitter (default flags)"),
                          ("teacher_forward", "the teacher's eval forward (bf16, flash)")):
            log(f"recipe path, {what}, alone: {rec[key][0]:.3f} ms a batch of {b} (CUDA events), "
                f"device {rec[key][1]:.3f} ms (trace)")
        out["recipe"].update(per_replay=dict(rec["per_replay"][0]),
                             timing=_timing_summary(rec["timing"]),
                             **{k: {"ms": rec[k][0], "device_ms": rec[k][1]}
                                for k in ("augment", "augment_jitter", "teacher_forward")})
    del rec

    rows = policy_checks(device, b, img)
    for r in rows:
        parts = [f"--aa {r['policy']}" if r["policy"] != "color_jitter" else "ColorJitter"]
        if "share_off" in r:
            parts.append(f"vs the CPU on the same draws: max|d| {r['max_abs_err']:.3e}, share "
                         f"beyond {POLICY_ATOL} {r['share_off']:.2e} (tol {POLICY_SHARE}); "
                         f"{r['changed']:.3f} of the values changed by more than 1")
        if "ms_eager" in r:
            parts.append(f"captured = eager bitwise; {r['ms_eager']:.3f} ms eager, "
                         f"{r['ms_captured']:.3f} ms captured a batch of {b} x {img}x{img} "
                         f"(CUDA events, draws included)")
        log("policy alone (12b): " + "; ".join(parts))
    out["policies"] = rows

    pr = run_prune(os.path.join(work, "prune"), device, model, cfg, teacher, images)
    losses = [r["loss"] for r in pr["records"]]
    log(f"prune path (12c): phase 5's checkpoint with the 50% smallest |w| of each of "
        f"{pr['n_pruned']} eligible weights zeroed (its own numpy code, written by "
        f"checkpoint/io.py), then train.main --pretrained_path <it> --prune_mask true "
        f"--flash_attn true --model_ema true, 1 epoch of {len(losses)} steps: printed sparsity "
        f"{pr['sparsity']:.3f} (want {PRUNE_SPARSITY} +- {PRUNE_TOL}); {pr['held']} pruned entries "
        f"exactly 0 in the model and the EMA of {pr['checkpoint'].split('/')[-1]}, {pr['moved']} "
        f"other entries moved; losses {', '.join(f'{x:.4f}' for x in losses)}; flash launches "
        f"counted by the wrappers over the run {pr['totals']}")
    out["prune"] = {"totals": pr["totals"], "sparsity": pr["sparsity"], "held": pr["held"],
                    "moved": pr["moved"], "losses": losses}
    if device == "cuda":
        log_step_timing(f"ViT-B/16 {img}x{img} bf16, --prune_mask", b, pr["timing"])
        out["prune"].update(per_replay=dict(pr["per_replay"][0]),
                            timing=_timing_summary(pr["timing"]))
    return out


def recipe_phases(keep: str) -> dict:
    """Phase 12 in a child process of this script (`--recipes`), with a
    fresh profiler as phases 10-11 (`late_phases`), on phase 5's checkpoint
    and folder linked into `keep`; returns its summary through a file."""
    out = os.path.join(keep, "phase12.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--recipes", keep, out],
                        timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 12 (a child process) exited with {rc}")
    with open(out) as f:
        return json.load(f)


def recipes_main(keep: str, out: str) -> int:
    """The child of `recipe_phases`: phase 12 on the card."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        # 12a at 1 epoch of 10 steps (cut from 2 for the command's time)
        res = recipes_phase(work, "cuda", VIT_B16, dict(TRAIN, epochs=1),
                            os.path.join(keep, "teacher.pth"),
                            os.path.join(keep, "images"))
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


# phase 13, the rest of the model registry and of the optimizer table, on
# phase 5's folder at its cell's shape (224x224, batch 64, default flags),
# one epoch of 10 steps each: nvnovograd and adafactor on ViT-B/16
# --flash_attn (13a), adahessian on ConvNeXt-T (13b), and Swin-T (from a
# seeded timm-layout state_dict), MobileNetV3-Large, EfficientNet-B0 and
# DenseNet-121 at full width (13c)
REGISTRY_CFG = dict(TRAIN, epochs=1)
NEW_OPTS = ("nvnovograd", "adafactor")
NEW_FAMILIES = ("swin_tiny", "mobilenetv3_large_100", "efficientnet_b0", "densenet121")


def optimizer_rest_runs(work: str, device: str, model: dict, cfg: dict, images: str) -> dict:
    """13a: `run_training` of `model` (ViT, --flash_attn) with --opt
    nvnovograd and with --opt adafactor: the launches of three replays of
    each run's captured step read from traces (24 forwards, 12 dQ, 12 dK/dV
    a step), the checkpoint's optimizer state in the optax layout; on a
    card, `captured_vs_eager` with the optimizer (6 steps, a non-finite one
    inside the replays). (Their steps are no longer timed here, for the
    command's time; PERF.md §5 keeps the earlier readings.)"""
    out = {}
    for opt in NEW_OPTS:
        run = run_training(os.path.join(work, opt), device, model, cfg["img"], cfg["num_classes"],
                           cfg["per_class"], cfg["batch"], cfg["epochs"], images=images,
                           flags=("--opt", opt))
        row = {"totals": run["totals"], "losses": [r["loss"] for r in run["records"]],
               "wall_s": run["wall_s"]}
        if device == "cuda":
            row["per_replay"] = dict(run["per_replay"][0])
            del run
            # 4 steps (cut from 6 for the command's time)
            row["captured_vs_eager"] = captured_vs_eager(model, cfg["img"], cfg["batch"],
                                                         cfg["num_classes"], steps=4,
                                                         flags=("--opt", opt))
        out[opt] = row
    return out


def adahessian_run(work: str, device: str, model: dict, cfg: dict, images: str) -> dict:
    """13b: `run_convnext_training` of `model` with --opt adahessian (the
    Hutchinson diagonal from a second backward at every step), captured on a
    card, its checkpoint in the optax layout and reloaded exactly; on a
    card, `captured_vs_eager` with adahessian (3 steps of ~1 s); and
    train.main of ViT-B/16 with --flash_attn true --opt adahessian, which
    must raise before anything is written."""
    run = run_convnext_training(os.path.join(work, "adahessian"), device, model, cfg["img"],
                                cfg["num_classes"], cfg["per_class"], cfg["batch"],
                                cfg["epochs"], images=images, flags=("--opt", "adahessian"))
    out = {"losses": [r["loss"] for r in run["records"]], "wall_s": run["wall_s"]}
    refused = os.path.join(work, "refused")
    try:
        _train_main(refused, images, ["--model", "vit_base_patch16", "--flash_attn", "true",
                                      "--opt", "adahessian", "--device", device])
    except ValueError as e:
        if "flash attention twice" not in str(e) or os.path.exists(refused):
            raise AssertionError(f"--flash_attn true --opt adahessian: {e}") from e
        out["refused"] = str(e)
    else:
        raise AssertionError("--flash_attn true --opt adahessian trained")
    if device == "cuda":
        # its step is no longer timed here, for the command's time (PERF.md
        # §5 keeps the earlier readings)
        del run
        out["captured_vs_eager"] = captured_vs_eager(model, cfg["img"], cfg["batch"],
                                                     cfg["num_classes"], steps=3,
                                                     flags=("--opt", "adahessian"))
    return out


def hub_layout_shapes(name: str, num_classes: int) -> tuple:
    """(parameters, batch statistics) names and shapes of the JAX layout of
    `name`, from the torch converter (the JAX package's, copied into the
    port) applied to the port model's state_dict, which is the timm /
    torchvision hub file's layout."""
    from imageclassification_tpu_torch.checkpoint.torch_convert import convert_state_dict
    from imageclassification_tpu_torch.models import create_model

    params, stats = convert_state_dict(create_model(name, num_classes=num_classes).state_dict(),
                                       name)
    return ({k: v.shape for k, v in params.items()}, {k: v.shape for k, v in stats.items()})


def write_timm_state_dict(path: str, name: str, seed: int) -> str:
    """A seeded 1000-class port model of `name` saved with torch.save in its
    hub layout (timm's names; for Swin with its relative_position_index
    buffers), standing in for a downloaded hub file."""
    import torch

    from imageclassification_tpu_torch.models import create_model

    m = create_model(name, num_classes=1000, generator=torch.Generator().manual_seed(seed))
    sd = dict(m.state_dict())
    for k, mod in m.named_modules():
        if hasattr(mod, "relative_position_onehot"):
            sd[f"{k}.relative_position_index"] = mod.relative_position_onehot.argmax(-1).reshape(
                mod.window ** 2, mod.window ** 2)
    torch.save(sd, path)
    return path


def family_runs(work: str, device: str, cfg: dict, images: str, names=NEW_FAMILIES) -> dict:
    """13c: `_bn_training` of each model of `names` at full width (the
    checkpoint in the JAX layout the torch converter gives, reloaded
    exactly, served by val_precision); a Swin starts from a seeded
    timm-layout state_dict through --pretrained_path (the 1000-class head
    skipped). On a card: ms a served batch (val.py's captured predict)."""
    import torch

    from imageclassification_tpu_torch import val

    out = {}
    for name in names:
        w = os.path.join(work, name)
        os.makedirs(w, exist_ok=True)
        flags = ["--model", name]
        if name.startswith("swin"):
            src = write_timm_state_dict(os.path.join(w, f"{name}.pth"), name, seed=13)
            flags += ["--pretrained", "true", "--pretrained_path", src]
        shapes = hub_layout_shapes(name, cfg["num_classes"])
        run, printed = _printed_by(lambda: _bn_training(
            w, device, flags, shapes, name, cfg["img"], cfg["num_classes"], cfg["per_class"],
            cfg["batch"], cfg["epochs"], images=images))
        if name.startswith("swin") and not ("Converted torch state_dict" in printed
                                            and "Loaded pretrained weights" in printed):
            raise AssertionError(f"{name}: the timm state_dict was not loaded")
        row = {"losses": [r["loss"] for r in run["records"]], "wall_s": run["wall_s"],
               "val_top1": run["val_top1"],
               "params": sum(p.numel() for p in run["state"].model.parameters())}
        if device == "cuda":
            # (its step is no longer timed here, for the command's time; PERF.md
            # §5 keeps the earlier readings)
            m, _ = val.initialize_model(run["checkpoint"], False, device=device)
            predict = val._predict_fn(m)
            imgs = _fixed_batch(run, device)["image"]
            probs = predict(imgs)
            if probs.shape != (cfg["batch"], cfg["num_classes"]) or \
                    not torch.isfinite(probs).all():
                raise AssertionError(f"{name}: bad served probabilities")
            row["ms_served"] = time_ms(lambda: predict(imgs), iters=10, reps=3)
            del m, predict
        del run
        out[name] = row
    return out


def registry_phase(work: str, device: str, cfg: dict, vit: dict, convnext: dict, images: str,
                   names=NEW_FAMILIES) -> dict:
    """Phase 13 (module docstring) at `cfg`'s sizes on the folder `images`:
    logs its lines and returns its summary (JSON-ready)."""
    b, img = cfg["batch"], cfg["img"]
    out = {"optimizers": {}, "families": {}, "seconds": {}}
    t0 = time.perf_counter()
    for opt, row in optimizer_rest_runs(os.path.join(work, "opt"), device, vit, cfg,
                                        images).items():
        log(f"optimizer path (13a): train.main --model {vit['name']} --flash_attn true --opt "
            f"{opt}, {img}x{img} batch {b}, {len(row['losses'])} steps, {row['wall_s']:.1f} s "
            f"for train.main; losses {', '.join(f'{x:.4f}' for x in row['losses'])}; the "
            f"checkpoint's optimizer state in the optax {opt} layout, reloaded to the run's "
            f"exact weights; flash launches counted by the wrappers over the run "
            f"{row['totals']}")
        summary = {"totals": row["totals"], "losses": row["losses"]}
        if device == "cuda":
            ce = row["captured_vs_eager"]
            log(f"optimizer path (13a), --opt {opt}: launches per step of the run's captured "
                f"step (trace) {row['per_replay']}; {ce['steps']} captured steps against eager "
                f"ones: eager vs eager {ce['eager_gap']:.3e}, captured vs eager "
                f"{ce['captured_gap']:.3e}, a non-finite replayed step skipped and inert")
            summary.update(per_replay=row["per_replay"], captured_vs_eager=ce)
        out["optimizers"][opt] = summary
    out["seconds"]["13a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ah = adahessian_run(os.path.join(work, "adahessian"), device, convnext, cfg, images)
    log(f"adahessian path (13b): train.main --model {convnext['name']} --opt adahessian, "
        f"{img}x{img} batch {b}, {len(ah['losses'])} steps, {ah['wall_s']:.1f} s for train.main; "
        f"losses {', '.join(f'{x:.4f}' for x in ah['losses'])}; checkpoint in the optax "
        f"layout, reloaded exactly; --flash_attn true --opt adahessian on ViT-B/16 refused before "
        f"its first step: {ah['refused'][:90]}...")
    out["adahessian"] = {"losses": ah["losses"]}
    if device == "cuda":
        ce = ah["captured_vs_eager"]
        log(f"adahessian path (13b): {ce['steps']} captured ConvNeXt-T steps against eager ones: "
            f"eager vs eager {ce['eager_gap']:.3e}, captured vs eager {ce['captured_gap']:.3e}, "
            f"a non-finite replayed step skipped and inert")
        out["adahessian"].update(captured_vs_eager=ce)
    out["seconds"]["13b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, row in family_runs(os.path.join(work, "families"), device, cfg, images,
                                 names).items():
        log(f"family path (13c): train.main --model {name}"
            f"{' --pretrained_path <seeded timm state_dict>' if name.startswith('swin') else ''}"
            f", {row['params']} parameters, {img}x{img} batch {b}, {len(row['losses'])} steps, "
            f"{row['wall_s']:.1f} s for train.main; losses "
            f"{', '.join(f'{x:.4f}' for x in row['losses'])}; no kernel launched; the checkpoint "
            f"in the JAX layout, reloaded exactly, served by val_precision (top-1 "
            f"{row['val_top1']:.3f})")
        summary = {k: row[k] for k in ("losses", "val_top1", "params")}
        if device == "cuda":
            log(f"family path (13c), {name}: served batch of {b} (val.py's captured predict) "
                f"{row['ms_served']:.3f} ms (CUDA events)")
            summary.update(ms_served=row["ms_served"])
        out["families"][name] = summary
    out["seconds"]["13c"] = time.perf_counter() - t0
    log(f"phase 13 wall seconds: {out['seconds']}")
    return out


def registry_phases(keep: str) -> dict:
    """Phase 13 in a child process of this script (`--registry`), with a
    fresh profiler as phases 10-12, on phase 5's folder linked into `keep`;
    returns its summary through a file."""
    out = os.path.join(keep, "phase13.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--registry", keep, out],
                        timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 13 (a child process) exited with {rc}")
    with open(out) as f:
        return json.load(f)


def registry_main(keep: str, out: str) -> int:
    """The child of `registry_phases`: phase 13 on the card."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        res = registry_phase(work, "cuda", REGISTRY_CFG, VIT_B16, CONVNEXT_T,
                             os.path.join(keep, "images"))
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


# phase 14: int8 serving and the checkpoint tools on a ViT-B/16 --flash_attn
# checkpoint of 1000 classes with an EMA (and Grad-CAM and the summary on
# ConvNeXt-T): a batch of 64 at 224x224 served, 8 images explained
# ViT-B/16's four Linear shapes at batch 64 (M = 64 x 197 tokens): (M, K, N)
# of qkv, the attention's out-projection, fc1 and fc2; and the head's at
# batch 8 (M <= 16 and N = 1000: the padded call)
VIT_LINEARS = {"qkv": (12608, 768, 2304), "proj": (12608, 768, 768),
               "fc1": (12608, 768, 3072), "fc2": (12608, 3072, 768), "head_b8": (8, 768, 1000)}
LIFECYCLE = dict(img=224, batch=64, num_classes=1000, cam_batch=8, seed=14, gemm=VIT_LINEARS)
# H100 SXM published dense int8 tensor-core rate (NVIDIA data sheet), the
# denominator of the int8 products' bound
INT8_OPS_PER_S = 1979e12
# rows of each int8 product held against the CPU's int32 matmul (the plain
# version, exact): the first rows only, to keep the CPU's integer matmul short
INT8_CHECK_ROWS = 256


def write_convnext_checkpoint(out_dir: str, rng, model: dict, img: int, num_classes: int) -> str:
    """A seeded checkpoint of `model` (a CONVNEXT_T-like dict) in the JAX
    layout: kernels N(0, 0.02), biases N(0, 0.01), LayerNorm scales 1 + N(0,
    0.01), layer scales gamma N(0.1, 0.01)."""
    os.makedirs(out_dir, exist_ok=True)
    flat = {}
    for k, shape in jax_convnext_shapes(model["depths"], model["dims"], num_classes).items():
        std = 0.01 if k.endswith("bias") else 0.02
        flat[k] = (std * rng.standard_normal(shape)).astype(np.float32)
        if k.endswith("scale"):
            flat[k] += 1.0
        if k.endswith("gamma"):
            flat[k] = (0.1 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    ck = {"format_version": 1, "model_spec": {"name": model["name"], "kwargs": {}},
          "step": 0, "epoch": 0, "input_shape": [1, img, img, 3], "num_classes": num_classes,
          "args": {}, "model": flat}
    path = os.path.join(out_dir, "checkpoint-0.pth")
    with open(path, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def int8_gemm_checks(device: str, shapes: dict) -> dict:
    """At each (M, K, N): the int8 product as the int8 layers run it
    (`ops/int8.py::padded_int_mm`, torch._int_mm on the card) held exactly
    against the CPU's int32 matmul on its first INT8_CHECK_ROWS rows; on the
    card its device ms beside the bf16 product of the same shape (F.linear,
    cuBLAS) and the whole int8 layer (quantize, product, rescale, bias) by
    CUDA events, and the bounds of the two products."""
    import torch
    import torch.nn.functional as F

    from imageclassification_tpu_torch.ops import int8

    gen = torch.Generator().manual_seed(3)
    rows = {}
    for name, (m, k, n) in shapes.items():
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=gen)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=gen)
        wp = int8.pad_weight(w).to(device)
        got = int8.padded_int_mm(a.to(device), wp, n)
        r = min(m, INT8_CHECK_ROWS)
        want = a[:r].to(torch.int32) @ w.t().to(torch.int32)
        if got.shape != (m, n) or not torch.equal(got[:r].cpu(), want):
            raise AssertionError(f"int8 product {name} {(m, k, n)} differs from the int32 matmul")
        row = {"shape": [m, k, n], "padded": list(wp.shape) != [n, k] or m < int8.MIN_ROWS,
               "exact": True}
        if device == "cuda":
            ad = a.to(device)
            x = (torch.randn(m, k, generator=gen) * 0.5).to(device, torch.bfloat16)
            wb = (w.float() * 0.01).to(device, torch.bfloat16)
            scale, bias = torch.full((n,), 0.01, device=device), torch.zeros(n, device=device)
            mm = lambda: int8.padded_int_mm(ad, wp, n)  # noqa: E731
            bf = lambda: F.linear(x, wb)  # noqa: E731
            layer = lambda: int8.int8_matmul(x, wp, scale, bias, torch.bfloat16)  # noqa: E731
            ev = {"int8": time_ms(mm, iters=20), "bf16": time_ms(bf, iters=20),
                  "layer": time_ms(layer, iters=20)}
            ops = 2 * m * k * n
            # cuBLASLt's layout rule for the second operand: the layers pass the
            # [N, K] weight transposed (column-major); row-major [K, N] here
            try:
                same = torch.equal(torch._int_mm(ad, w.t().contiguous().to(device))[:r].cpu(),
                                   want)
                row["row_major_b"] = "taken, " + ("equal" if same else "NOT equal")
            except RuntimeError as e:
                row["row_major_b"] = "refused: " + str(e).strip().splitlines()[0][:120]
            row.update(ms_int8=ev["int8"], ms_bf16=ev["bf16"], ms_int8_layer=ev["layer"],
                       device_ms_int8=_library_device_ms(mm, events_ms=ev["int8"]),
                       device_ms_bf16=_library_device_ms(bf, events_ms=ev["bf16"]),
                       bound_ms_int8=max(ops / INT8_OPS_PER_S,
                                         (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S) * 1e3,
                       bound_ms_bf16=max(ops / BF16_FLOPS_PER_S,
                                         2 * (m * k + n * k + m * n) / HBM_BYTES_PER_S) * 1e3)
        rows[name] = row
    return rows


def _images_batch(folder: str, img: int, batch: int, device: str):
    import torch

    from imageclassification_tpu_torch import val

    paths = sorted(os.path.join(folder, d, f) for d in os.listdir(folder)
                   for f in os.listdir(os.path.join(folder, d)))[:batch]
    return next(val._batched(paths, img, batch, torch.device(device)))[1]


def int8_serving(work: str, device: str, ck: str, images: str, cfg: dict, depth: int) -> dict:
    """14a: the checkpoint through the port's `modelchange --mode quantize
    --dtype int8`, then the port's val.py on it (the raw int8 weights,
    --model_ema false); the int8 predict against the bf16 model of the
    source checkpoint on one batch."""
    import torch

    from imageclassification_tpu_torch import modelchange, val
    from imageclassification_tpu_torch.ops import int8
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    img, b = cfg["img"], cfg["batch"]
    os.makedirs(work, exist_ok=True)
    q = modelchange.main(["--ckpt", ck, "--mode", "quantize", "--dtype", "int8",
                          "--out", os.path.join(work, "int8.pth")])
    reset_launches()
    t0 = time.perf_counter()
    # its per-class lines (1000 classes) are counted, not shown
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        tp, fp, fn = val.val_precision(images, q, img, model_ema=False, batch_size=b,
                                       device=device)
    res = {"val_s": time.perf_counter() - t0, "totals": _launch_counts(),
           "val_images": int(tp.sum() + fp.sum()),
           "val_lines": len(printed.getvalue().splitlines())}
    if "Dense kernels stay int8" not in printed.getvalue():
        raise AssertionError("val_precision did not run the int8 checkpoint int8")
    m8, ck8 = val.initialize_model(q, False, return_checkpoint=True, device=device)
    mbf, _ = val.initialize_model(ck, False, device=device)
    res["kept"] = len(ck8["quant_exec_scales"])
    layers = [m for m in m8.modules() if isinstance(m, int8.Int8Linear)]
    res["int8_layers"] = len(layers)
    imgs = _images_batch(images, img, b, device)
    p8, pbf = val._predict_fn(m8), val._predict_fn(mbf)
    int8.int_mm.calls = 0
    eager8 = getattr(p8, "eager", p8)(imgs)
    res["int_mm_calls_a_forward"] = int8.int_mm.calls
    if device == "cuda" and int8.int_mm.calls != len(layers):
        raise AssertionError(f"{int8.int_mm.calls} torch._int_mm calls in a forward of "
                             f"{len(layers)} int8 layers: a float fallback")
    a, ref = p8(imgs), pbf(imgs)
    if a.shape != (b, cfg["num_classes"]) or not torch.isfinite(a).all():
        raise AssertionError(f"bad int8 probabilities: shape {tuple(a.shape)}")
    res["probs_vs_bf16"] = (a - ref).abs().max().item()
    res["argmax_agree_bf16"] = (a.argmax(-1) == ref.argmax(-1)).float().mean().item()
    res["captured_vs_eager"] = (a - eager8).abs().max().item()
    if device == "cuda":
        res["per_replay"] = replay_launches(lambda: p8(imgs), ["fwd"] * depth)
        res["ms_int8"] = time_ms(lambda: p8(imgs), iters=10)
        res["ms_bf16"] = time_ms(lambda: pbf(imgs), iters=10)
        res["trace_int8"] = trace(lambda: p8(imgs))
    res["gemm"] = int8_gemm_checks(device, cfg["gemm"])
    return res


def export_checks(work: str, device: str, ck: str, depth: int) -> dict:
    """14b: `ema2model`, `prune` and `aot` of the checkpoint through the
    port's modelchange; the program reloaded, run on zeros against the live
    model, its flash launches counted (the int8 checkpoint's program: the
    card test of tests/test_torch_modelchange.py)."""
    import torch

    from imageclassification_tpu_torch import modelchange, val
    from imageclassification_tpu_torch.checkpoint.io import load_checkpoint
    from imageclassification_tpu_torch.ops import int8
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    res = {}
    ema = modelchange.main(["--ckpt", ck, "--mode", "ema2model",
                            "--out", os.path.join(work, "ema.pth")])
    src, got = load_checkpoint(ck), load_checkpoint(ema)
    if set(got["model"]) != set(src["model_ema"]) or any(
            not np.array_equal(got["model"][k], v) for k, v in src["model_ema"].items()):
        raise AssertionError("ema2model: the model is not the source's EMA")
    pruned = load_checkpoint(modelchange.main(["--ckpt", ck, "--mode", "prune", "--sparsity",
                                               "0.5", "--out", os.path.join(work, "pruned.pth")]))
    res["prune_sparsity"] = pruned["prune_sparsity"]
    if abs(pruned["prune_sparsity"] - 0.5) > 0.01:
        raise AssertionError(f"prune: sparsity {pruned['prune_sparsity']}")
    for name, path in (("bf16", ck),):
        t0 = time.perf_counter()
        out = modelchange.main(["--ckpt", path, "--mode", "aot", "--device", device,
                                "--out", os.path.join(work, f"{name}.aot.pt2")])
        seconds = time.perf_counter() - t0
        program = modelchange.load_exported(out).module()
        live, lck = val.initialize_model(path, False, return_checkpoint=True, device=device)
        x = torch.zeros(lck["input_shape"], device=device)
        reset_launches()
        int8.int_mm.calls = 0
        with torch.no_grad():
            y = program(x)
        row = {"seconds": seconds, "launches": _launch_counts(), "int_mm_calls": int8.int_mm.calls,
               "bytes": os.path.getsize(out)}
        with torch.no_grad():
            row["max_abs_vs_live"] = (y.float() - live(x).float()).abs().max().item()
        if device == "cuda":
            if row["launches"]["fwd"] != depth:
                raise AssertionError(f"the reloaded {name} program launched the flash forward "
                                     f"{row['launches']['fwd']} times, not {depth}")
            with torch.no_grad():
                row["ms_program"] = time_ms(lambda: program(x), iters=10)
                row["ms_live"] = time_ms(lambda: live(x), iters=10)
        res[name] = row
    return res


def gradcam_checks(work: str, device: str, ck: str, images: str, cfg: dict) -> dict:
    """14c for one checkpoint: Grad-CAM of one batch through the port's
    visualize functions (the flash launches counted from 0 over it), the
    visualize CLI's gradcam and summary, and its features."""
    import torch

    from imageclassification_tpu_torch import visualize
    from imageclassification_tpu_torch.checkpoint.io import load_checkpoint
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches

    img, b = cfg["img"], cfg["cam_batch"]
    spec = load_checkpoint(ck, dequantize=False)["model_spec"]
    model, _ = visualize._load(SimpleNamespace(model_weight_path=ck, model_ema=False,
                                               device=device), dequantize=True)
    layer, module, shape = visualize.resolve_layer(model, img)
    fn = visualize.make_gradcam_fn(model, module, img)
    imgs = _images_batch(images, img, b, device)
    reset_launches()
    probs, cams = fn(imgs, -1)
    # visualize loads every model in fp32, as the JAX CLI: a --flash_attn
    # ViT runs the fp32 kernels, no bf16 one
    res = {"layer": layer, "shape": list(shape), "launches": _launch_counts("fp32"),
           "launches_bf16": _launch_counts(), "dtype": str(model.dtype).split(".")[-1]}
    if any(res["launches_bf16"].values()) or model.dtype != torch.float32:
        raise AssertionError(f"Grad-CAM of {spec['name']} ran {res['dtype']}, bf16 kernel "
                             f"launches {res['launches_bf16']}")
    if cams.shape != (b, img, img) or not torch.isfinite(cams).all() or cams.min() < 0 \
            or cams.max() > 1 + 1e-6 or not torch.isfinite(probs).all():
        raise AssertionError(f"bad Grad-CAM maps on {spec['name']}")
    cam_dir = os.path.join(work, f"cam_{spec['name']}")
    os.makedirs(cam_dir, exist_ok=True)
    from PIL import Image

    for i, arr in enumerate(imgs.cpu().numpy()):
        Image.fromarray(arr).save(os.path.join(cam_dir, f"x{i}.png"))
    out_dir = os.path.join(work, f"viz_{spec['name']}")
    common = ["--model_weight_path", ck, "--img_path", cam_dir, "--img_size", str(img),
              "--device", device, "--out_dir", out_dir]
    visualize.main(["--mode", "gradcam", "--batch_size", str(b)] + common)
    res["pngs"] = len(os.listdir(out_dir))
    if res["pngs"] != b:
        raise AssertionError(f"visualize gradcam wrote {res['pngs']} of {b} overlays")
    summary = visualize.main(["--mode", "summary"] + common)
    res.update(params=summary["params"], gflops=summary["flops"] / 1e9,
               peak_bytes=summary["peak_bytes"])
    n_ck = sum(int(np.size(v)) for v in load_checkpoint(ck)["model"].values())
    if summary["params"] != n_ck:
        raise AssertionError(f"summary counts {summary['params']} parameters, the checkpoint "
                             f"holds {n_ck}")
    if device == "cuda":
        res["ms_batch"] = time_ms(lambda: fn(imgs, -1), iters=5, reps=3)
    return res


def lifecycle_phase(work: str, device: str, cfg: dict, vit: dict, convnext: dict,
                    images: str) -> dict:
    """Phase 14 (module docstring) at `cfg`'s sizes on the folder `images`
    (written here when missing): logs its lines and returns its summary
    (JSON-ready)."""
    rng = np.random.default_rng(cfg["seed"])
    if not os.path.isdir(images):
        write_image_folder(images, rng, 2, cfg["batch"] // 2)
    ck = write_checkpoint(os.path.join(work, "vit"), rng, vit, cfg["img"], cfg["num_classes"])
    with open(ck, "rb") as f:
        src = pickle.load(f)
    src["model_ema"] = {k: (v + 0.002 * rng.standard_normal(v.shape)).astype(np.float32)
                        for k, v in src["model"].items()}
    with open(ck, "wb") as f:
        pickle.dump(src, f, protocol=pickle.HIGHEST_PROTOCOL)
    cnx = write_convnext_checkpoint(os.path.join(work, "convnext"), rng, convnext, cfg["img"],
                                    cfg["num_classes"])
    out, t0 = {"seconds": {}}, time.perf_counter()
    a = int8_serving(os.path.join(work, "int8"), device, ck, images, cfg, vit["depth"])
    out["seconds"]["14a"] = time.perf_counter() - t0
    log(f"int8 serving (14a): modelchange --mode quantize --dtype int8 of {vit['name']} "
        f"--flash_attn ({cfg['num_classes']} classes, with an EMA), then val_precision with "
        f"--model_ema false on {a['val_images']} images at batch {cfg['batch']} ({a['val_lines']} "
        f"lines of per-class precision/recall printed, not shown): {a['kept']} "
        f"Dense kernels kept int8 (JAX's rule), {a['int8_layers']} Int8Linear layers, "
        f"{a['int_mm_calls_a_forward']} int8 products a forward; flash launches counted by the "
        f"wrappers over val.py {a['totals']}; probabilities against the bf16 model of the source "
        f"checkpoint max|d| {a['probs_vs_bf16']:.3e}, argmax agreement "
        f"{a['argmax_agree_bf16']:.3f}; captured vs eager {a['captured_vs_eager']:.3e}")
    summary = {k: a[k] for k in ("kept", "int8_layers", "int_mm_calls_a_forward", "totals",
                                 "probs_vs_bf16", "argmax_agree_bf16", "gemm")}
    if device == "cuda":
        log(f"int8 serving (14a): launches per replayed batch (trace) {dict(a['per_replay'][0])}; "
            f"captured predict, batch {cfg['batch']} {cfg['img']}x{cfg['img']}: int8 "
            f"{a['ms_int8']:.3f} ms, bf16 on the same weights {a['ms_bf16']:.3f} ms (CUDA events)")
        log_trace(f"{vit['name']} int8 batch {cfg['batch']} forward, captured", a["trace_int8"],
                  "batch")
        summary.update(per_replay=dict(a["per_replay"][0]), ms_int8=a["ms_int8"],
                       ms_bf16=a["ms_bf16"])
    for name, row in a["gemm"].items():
        line = (f"int8 product (14a) {name} M,K,N {tuple(row['shape'])}"
                f"{' (padded)' if row['padded'] else ''}: equal to the CPU's int32 matmul")
        if device == "cuda":
            line += (f"; torch._int_mm {row['ms_int8']:.4f} ms (dev {row['device_ms_int8']:.4f}, "
                     f"bound {row['bound_ms_int8']:.4f}), bf16 F.linear {row['ms_bf16']:.4f} ms "
                     f"(dev {row['device_ms_bf16']:.4f}, bound {row['bound_ms_bf16']:.4f}), the "
                     f"whole int8 layer {row['ms_int8_layer']:.4f} ms; torch._int_mm with B "
                     f"row-major: {row['row_major_b']}")
        log(line)
    out["int8"] = summary
    t0 = time.perf_counter()
    b = export_checks(os.path.join(work, "int8"), device, ck, vit["depth"])
    out["seconds"]["14b"] = time.perf_counter() - t0
    for name, row in (("bf16", b["bf16"]),):
        log(f"export (14b): modelchange --mode aot of the {name} checkpoint on {device}: "
            f"{row['bytes']} bytes in {row['seconds']:.1f} s; the reloaded program against the "
            f"live model on zeros max|d| {row['max_abs_vs_live']:.3e}; flash launches in one "
            f"call {row['launches']}, int8 products {row['int_mm_calls']}"
            + (f"; {row['ms_program']:.3f} ms a call, live eager {row['ms_live']:.3f} ms"
               if device == "cuda" else ""))
    log(f"ema2model (14b): the model equals the source's EMA key for key; prune --sparsity 0.5: "
        f"achieved {b['prune_sparsity']:.4f}")
    out["export"] = b
    t0 = time.perf_counter()
    out["gradcam"] = {}
    for name, path in ((vit["name"], ck), (convnext["name"], cnx)):
        c = gradcam_checks(work, device, path, images, cfg)
        log(f"Grad-CAM (14c) {name}: layer {c['layer']} {tuple(c['shape'])} (the JAX pick), "
            f"{c['dtype']}; fp32 flash launches of one batch of {cfg['cam_batch']} "
            f"{c['launches']}; {c['pngs']} overlays written by the CLI; "
            f"summary: {c['params']} parameters (the checkpoint's), "
            f"{c['gflops']:.3f} GFLOPs a batch-1 forward"
            + (f", peak {c['peak_bytes'] / 1e6:.1f} MB; {c['ms_batch']:.3f} ms a Grad-CAM batch "
               f"(CUDA events)" if device == "cuda" else ""))
        out["gradcam"][name] = c
    out["seconds"]["14c"] = time.perf_counter() - t0
    if device == "cuda":
        want = {"fwd": vit["depth"], "fwd_lse": 1, "bwd_dkv": 1, "bwd_dq": 1}
        if out["gradcam"][vit["name"]]["launches"] != want:
            raise AssertionError(f"ViT Grad-CAM launches {out['gradcam'][vit['name']]['launches']},"
                                 f" expected {want}")
    log(f"phase 14 wall seconds: {out['seconds']}")
    return out


def lifecycle_phases(keep: str) -> dict:
    """Phase 14 in a child process of this script (`--lifecycle`), with a
    fresh profiler as phases 10-13, on phase 5's folder linked into `keep`;
    returns its summary through a file."""
    out = os.path.join(keep, "phase14.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--lifecycle", keep, out],
                        timeout=600).returncode
    if rc != 0:
        raise AssertionError(f"phase 14 (a child process) exited with {rc}")
    with open(out) as f:
        return json.load(f)


def lifecycle_main(keep: str, out: str) -> int:
    """The child of `lifecycle_phases`: phase 14 on the card (`keep`'s
    images/ folder, written there when missing)."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        res = lifecycle_phase(work, "cuda", LIFECYCLE, VIT_B16, CONVNEXT_T,
                              os.path.join(keep, "images"))
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


# phase 15: UPerNet segmentation in one process (A19) at full width: the
# tiny ADE20K recipe (ConvNeXt-T, channels 512, crop 512, batch 16, 150
# classes), cut in iterations only (20, eval every 10), on a seeded
# synthetic folder in the mmseg layout (ADE20K is not in the repository):
# ADE-sized 683 x 512 JPEGs of 150-class blocky label maps
# 10 iterations with whole eval every 5 and 3 timed steps (cut from 20, 10
# and 5 for the command's time)
SEG = dict(config="upernet_convnext_tiny_512_160k", num_classes=150, iters=10, eval_interval=5,
           n_train=48, n_val=8, n_ms=1, size=(683, 512), timed_steps=3)
# UPerNet's ConvNeXt-T at crop 512, batch 16: (rows, C) of the stage
# LayerNorms and (B, H, W, C) of the stage depthwise convs
SEG_LN_SHAPES = [(262144, 96), (65536, 192), (16384, 384), (4096, 768)]
SEG_DW_SHAPES = [(16, 128, 128, 96), (16, 64, 64, 192), (16, 32, 32, 384), (16, 16, 16, 768)]


def write_seg_folder(root: str, rng, num_classes: int, n_train: int, n_val: int,
                     size=(683, 512)) -> str:
    """A seeded folder in the mmseg ADE layout (images/{training,validation}
    JPEGs, annotations/ PNG masks): each label map a nearest-seed partition
    of 24 seeds on an 8x coarser grid, enlarged by repetition, each seed a
    class of `num_classes`, a 255 border; each image a colour a class plus
    noise."""
    from PIL import Image

    W, H = size
    palette = rng.integers(0, 256, (num_classes, 3))
    yy, xx = np.mgrid[0:H:8, 0:W:8]
    for split, n in (("training", n_train), ("validation", n_val)):
        os.makedirs(os.path.join(root, "images", split), exist_ok=True)
        os.makedirs(os.path.join(root, "annotations", split), exist_ok=True)
        for i in range(n):
            seeds = rng.integers(0, (H, W), (24, 2))
            cls = rng.integers(0, num_classes, 24)
            d = (yy[..., None] - seeds[:, 0]) ** 2 + (xx[..., None] - seeds[:, 1]) ** 2
            coarse = cls[d.argmin(-1)].astype(np.uint8)
            mask = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:H, :W]
            img = np.clip(palette[mask] + rng.normal(0, 20, (H, W, 3)), 0, 255).astype(np.uint8)
            mask[:4] = 255
            Image.fromarray(img).save(os.path.join(root, "images", split, f"s{i:03d}.jpg"),
                                      quality=90)
            Image.fromarray(mask).save(os.path.join(root, "annotations", split, f"s{i:03d}.png"))
    return root


def seg_phase(work: str, device: str, cfg: dict = SEG) -> dict:
    """Phase 15 (module docstring): seg_train.main at the recipe's full width
    for cfg["iters"] iterations (losses finite, whole eval every
    eval_interval and at the end), its checkpoint reloaded exactly into a
    fresh UPerNet and in the JAX layout; slide and ms eval of the trained
    model (ms on cfg["n_ms"] images); ms an eager iteration, its peak memory
    and a trace; and one step's LayerNorms and depthwise convs (the
    backbone's) replayed through K3, K4 and K5, with those kernels timed at
    the four stage shapes beside F.layer_norm and cuDNN."""
    import torch

    from imageclassification_tpu_torch import seg_train
    from imageclassification_tpu_torch.checkpoint.io import load_checkpoint, load_params_with_pruning
    from imageclassification_tpu_torch.checkpoint.to_jax import carry_for
    from imageclassification_tpu_torch.downstream import seg_engine
    from imageclassification_tpu_torch.downstream.seg_data import scan_pairs
    from imageclassification_tpu_torch.downstream.upernet import build_upernet
    from imageclassification_tpu_torch.models.layers import clear_batch_stats

    out = {"seconds": {}}
    t0 = time.perf_counter()
    data = write_seg_folder(os.path.join(work, "seg_data"), np.random.default_rng(15),
                            cfg["num_classes"], cfg["n_train"], cfg["n_val"], cfg["size"])
    out["seconds"]["data"] = time.perf_counter() - t0
    out_dir = os.path.join(work, "train_seg", "output")
    # the recipe's crop and batch unless cfg cuts them (a CPU rehearsal)
    sizes = [f for key, flag in (("crop", "--crop_size"), ("batch", "--batch_size"))
             if key in cfg for f in (flag, str(cfg[key]))]
    args = seg_train.get_args_parser().parse_args([
        "--data_path", data, "--config", cfg["config"], "--num_classes", str(cfg["num_classes"]),
        "--total_iters", str(cfg["iters"]), "--eval_interval", str(cfg["eval_interval"]),
        "--save_ckpt_interval", str(cfg["eval_interval"]), "--log_interval", "5",
        "--output_dir", out_dir, "--device", device, *sizes])
    seen, losses = {}, []
    build = seg_train.build_seg_train_step

    def recording(model, *a, **kw):
        step = build(model, *a, **kw)
        seen["model"], seen["step"] = model, step

        def recorded(state, x, y, g):
            loss = step(state, x, y, g)
            seen["state"] = state
            losses.append(loss)
            return loss

        return recorded

    t0 = time.perf_counter()
    with mock.patch.object(seg_train, "build_seg_train_step", recording):
        row = seg_train.main(args)
    out["seconds"]["seg_train"] = time.perf_counter() - t0
    out["losses"] = [float(x) for x in losses]
    if len(losses) != cfg["iters"] or not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"seg_train losses {out['losses']}")
    model, state = seen["model"], seen["state"]
    crop = args.crop_size or 512
    batch = args.batch_size or 16
    out.update(miou_whole=row["miou"], aacc_whole=row["aacc"], crop=crop, batch=batch,
               params=sum(p.numel() for p in model.parameters()),
               checkpoints=sorted(os.listdir(out_dir)))

    # the checkpoint: the JAX layout by the carry, reloaded exactly
    ck = load_checkpoint(os.path.join(out_dir, f"checkpoint-iter{cfg['iters']}.pth"))
    fresh, _ = build_upernet(cfg["config"], cfg["num_classes"], half_precision=True)
    fresh = fresh.to(device)
    carry = carry_for(fresh)
    want = {k: v.shape for k, v in carry.to_jax(dict(fresh.named_parameters())).items()}
    if {k: np.shape(v) for k, v in ck["model"].items()} != want or ck["step"] != cfg["iters"]:
        raise AssertionError("the segmentation checkpoint is not in the JAX layout")
    skipped = (load_params_with_pruning(fresh, ck["model"], verbose=False)
               + load_params_with_pruning(fresh, ck["batch_stats"], verbose=False))
    diff = max((fresh.state_dict()[k] - v).abs().max().item()
               for k, v in model.state_dict().items())
    if skipped or diff != 0.0:
        raise AssertionError(f"the checkpoint reloads with {skipped} keys skipped, max|d| {diff}")
    out["reload_max_abs"] = diff
    del fresh

    # slide and ms eval of the trained model
    sc = seg_train.SEGMENTATION_CONFIGS[cfg["config"]]
    stride = max(1, round(sc.eval_stride * crop / sc.crop_size))
    out["stride"] = stride
    val_pairs = scan_pairs(data, "validation")
    for mode, pairs in (("slide", val_pairs), ("ms", val_pairs[:cfg["n_ms"]])):
        t0 = time.perf_counter()
        miou, _, acc = seg_train.evaluate_slide(model, pairs, crop, stride, cfg["num_classes"],
                                                torch.device(device), ms=mode == "ms")
        out["seconds"][f"eval_{mode}"] = time.perf_counter() - t0
        out[f"miou_{mode}"], out[f"aacc_{mode}"] = miou, acc
    out["n_ms"] = len(val_pairs[:cfg["n_ms"]])

    # one fixed batch: the eager step timed, its peak memory, a trace
    from imageclassification_tpu_torch.downstream.seg_data import train_batches

    _, xs, ys = next(train_batches(scan_pairs(data, "training"), crop, batch, 1, seed=1))
    x, y = torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
    g = seg_train.step_generator(1, 0, torch.device(device))

    def one_step():
        return seen["step"](state, x, y, g)

    if device == "cuda":
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["ms_step"] = time_ms(one_step, iters=cfg["timed_steps"], reps=2)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["trace"] = trace(one_step, steps=3)
        out["seconds"]["step_timing"] = time.perf_counter() - t0

    # one step's backbone LayerNorms and depthwise convs through K3-K5
    t0 = time.perf_counter()
    records, undo = _capture_convnext_ops(model.backbone)
    model.train()
    try:
        main, aux = model(seg_engine._normalize(x), g)
        loss = seg_engine.seg_loss(main, aux, y)
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params)
    finally:
        undo()
        clear_batch_stats(model)
    grad_of = dict(zip(params, grads))
    del main, aux, loss, grads
    _reset_op_launches()
    with torch.no_grad():
        errs, nearest = _replay(records, grad_of)
    if device == "cuda":
        torch.cuda.synchronize()
    out["replay"] = {"launches": _op_launch_counts(), "errs": errs, "nearest": nearest,
                     "n_ln": len(records["ln"]),
                     "n_dw": len(records["dw"]),
                     "ln_shapes": sorted({(r["x"].numel() // r["x"].shape[-1], r["x"].shape[-1])
                                          for r in records["ln"]}),
                     "dw_shapes": sorted({tuple(r["x"].shape) for r in records["dw"]})}
    del records, grad_of
    out["seconds"]["replay"] = time.perf_counter() - t0
    if device == "cuda":
        t0 = time.perf_counter()
        out["ln_rows"] = [check_layernorm(r, c, device) for r, c in SEG_LN_SHAPES]
        out["dw_rows"] = [check_dwconv(sh, device) for sh in SEG_DW_SHAPES]
        out["seconds"]["kernel_checks"] = time.perf_counter() - t0
    return out


def seg_phases(keep: str) -> dict:
    """Phase 15 in a child process of this script (`--segmentation`), with a
    fresh profiler as phases 10-14; returns its summary through a file."""
    out = os.path.join(keep, "phase15.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--segmentation", keep, out],
                        timeout=600).returncode
    if rc != 0:
        raise AssertionError(f"phase 15 (a child process) exited with {rc}")
    with open(out) as f:
        return json.load(f)


def seg_main(keep: str, out: str) -> int:
    """The child of `seg_phases`: phase 15 on the card."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        res = seg_phase(work, "cuda")
    res["seconds"]["phase"] = time.perf_counter() - t0
    log_seg(res)
    res.pop("trace", None)
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def log_seg(res: dict) -> None:
    cfg = SEG
    log(f"segmentation (15): seg_train.main --config {cfg['config']} at full width (ConvNeXt-T, "
        f"channels 512, {res['params']} parameters), crop {res['crop']}, batch {res['batch']}, "
        f"{cfg['num_classes']} classes, {cfg['iters']} iterations (eval every "
        f"{cfg['eval_interval']}), on {cfg['n_train']} + {cfg['n_val']} seeded {cfg['size'][0]} x "
        f"{cfg['size'][1]} JPEGs; losses {', '.join(f'{x:.4f}' for x in res['losses'])}; "
        f"{res['seconds']['seg_train']:.1f} s for seg_train.main (data, evals and checkpoints "
        f"included); checkpoints {res['checkpoints']}, checkpoint-iter{cfg['iters']}.pth in the "
        f"JAX layout, reloaded exactly (max|d| {res['reload_max_abs']})")
    log(f"segmentation (15) mIoU / aAcc: whole {res['miou_whole']:.4f} / {res['aacc_whole']:.4f}, "
        f"slide {res['miou_slide']:.4f} / {res['aacc_slide']:.4f} "
        f"({res['seconds']['eval_slide']:.1f} s, {cfg['n_val']} images), ms (6 scales x flip) "
        f"{res['miou_ms']:.4f} / {res['aacc_ms']:.4f} ({res['seconds']['eval_ms']:.1f} s, "
        f"{res['n_ms']} images)")
    if "ms_step" in res:
        log(f"segmentation (15) eager train iteration, batch {res['batch']} x {res['crop']}^2 bf16: "
            f"{res['ms_step']:.3f} ms/iter (CUDA events, one fixed batch), "
            f"{res['batch'] / (res['ms_step'] / 1e3):.1f} img/s, peak "
            f"{res['peak_gib']:.2f} GiB (max_memory_allocated)")
        log_trace("UPerNet ConvNeXt-T 512^2 batch 16 eager train iteration", res["trace"], "iter")
    rp = res["replay"]
    log(f"replay of one UPerNet train iteration's backbone (15): {rp['n_ln']} LayerNorms (rows x "
        f"C {rp['ln_shapes']}) and {rp['n_dw']} depthwise convs ({rp['dw_shapes']}) through the "
        f"kernels, launches {rp['launches']}; " + replay_note(rp["nearest"]))
    log(f"phase 15 wall seconds: {res['seconds']}")


# phase 16: data-parallel training (ROADMAP A9) on the one card. 16a: a world
# of one process through the launcher's environment (torchrun's RANK=0
# WORLD_SIZE=1) runs train.main as a plain launch does, captured, bitwise.
# 16b: two processes share the card, each in a gloo group (NCCL refuses two
# ranks on one device; gloo reduces CUDA tensors through the host), and run
# the port's data-parallel step on ViT-B/16 --flash_attn at full width, bf16,
# local batch 32, mixup and cutmix on, drop path 0, --update_freq 2, 3
# optimizer steps (cut from 4 for the command's time); one process runs the
# same step on the global batch of 64 after them. 16c: the same on ResNet-50
# at local batch 16, 2 steps (its BatchNorm over the global batch). One pair
# of rank processes runs 16b, then 16c; they start, reach the card and join
# their group while 16a runs, and take their first step after it. No number
# of this phase is a multi-GPU or NCCL figure: none exists.
DP_LABEL = "2 processes sharing one H100, gloo through the host: not a multi-GPU number"
DP_VIT = dict(model="vit_base_patch16", flash=True, local_batch=32, update_freq=2, opt_steps=3,
              img=224, num_classes=5, lr=0.01, device="cuda")
DP_RESNET = dict(model="resnet50", flash=False, local_batch=16, update_freq=1, opt_steps=2,
                 img=224, num_classes=5, lr=0.01, device="cuda")
# bf16 training, two ranks against one process on the global batch: each
# rank rounds its half of a weight gradient to bf16 (the weights are cast to
# bf16 at use, so their gradients are bf16) before the fp32 sum over the
# ranks, where one process rounds the whole once: 2^-8 of each half an
# element, which is more of the sum where the halves cancel. The updates
# (SGD, linear in the gradients) are held to 2^-5 of them, in relative L2
# (||d - d1|| / ||d1||) and elementwise (of the largest update): halves that
# cancel to an eighth of their size; the losses, which see those updates'
# differences only after the first, to 2^-7; the BatchNorm running
# statistics (fp32 sums of bf16 activations) to 2^-7 of the largest
DP_LOSS_RTOL = 2.0 ** -7
DP_UPDATE_RTOL = 2.0 ** -5
DP_STATS_RTOL = 2.0 ** -7
# 16a: a world of one through the launcher, 1 epoch of 4 steps at batch 64
DP_LAUNCH = dict(model="vit_base_patch16", img=224, batch=64, num_classes=5, per_class=60,
                 device="cuda")


def dp_config(cfg: dict):
    """The train config of a phase-16 run: the default flags but SGD at
    cfg's lr, mixup 0.8 and cutmix 1.0 (both on), drop path 0."""
    from imageclassification_tpu_torch.config import TrainConfig

    return TrainConfig(model=cfg["model"], flash_attn=cfg["flash"], input_size=cfg["img"],
                       batch_size=cfg["local_batch"], update_freq=cfg["update_freq"], opt="sgd",
                       lr=cfg["lr"], mixup=0.8, cutmix=1.0, drop_path=0.0, pretrained=False,
                       device=cfg["device"])


def dp_step_run(cfg: dict, world: int, rank: int, trace_steps: int = 0) -> dict:
    """The port's train step (eager) on `rank`'s rows of seeded global
    batches of 2 * local_batch (all of them at a world of one), cfg's
    update_freq * opt_steps
    micro-steps, in this process's group (a world of one without one).
    Returns the losses, the parameters before and after (CPU fp32), the
    BatchNorm statistics, the wrappers' K1 launch counts over the steps (set
    to 0 just before them), ms a micro-step after the first window, and
    with `trace_steps` the K1 kernels of that many more steps from a trace."""
    import torch

    from imageclassification_tpu_torch.data.mixup import build_mixup
    from imageclassification_tpu_torch.engine.state import create_train_state
    from imageclassification_tpu_torch.engine.step import build_train_step
    from imageclassification_tpu_torch.models import create_model, model_kwargs_for
    from imageclassification_tpu_torch.models.layers import batch_norm_stats
    from imageclassification_tpu_torch.ops.flash_attention import reset_launches
    from imageclassification_tpu_torch.optim.factory import create_optimizer
    from imageclassification_tpu_torch.parallel.mesh import rows_of

    args = dp_config(cfg)
    nc, img, device = cfg["num_classes"], cfg["img"], torch.device(cfg["device"])
    cuda = device.type == "cuda"
    model = create_model(args.model, half_precision=True, generator=torch.Generator().manual_seed(0),
                         **{"img_size": img, **model_kwargs_for(args, nc)}).to(device)
    opt = create_optimizer("sgd", model.parameters(), lr=args.lr, weight_decay=args.weight_decay)
    state = create_train_state(model, opt, update_freq=args.update_freq)
    steps = cfg["update_freq"] * cfg["opt_steps"]
    step = build_train_step(model, args, nc, build_mixup(args, nc), np.full(steps, args.lr),
                            np.full(steps, args.weight_decay), seed=args.seed)
    G = cfg["local_batch"] * 2
    rng = np.random.default_rng(16)
    images = rng.integers(0, 256, (steps, G, img, img, 3), dtype=np.uint8)
    labels = rng.integers(0, nc, (steps, G))
    mine = rows_of(G, rank, world)
    batches = [{"image": torch.from_numpy(images[s, mine]).to(device),
                "label": torch.from_numpy(labels[s, mine]).to(device)} for s in range(steps)]
    before = {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}
    reset_launches()
    losses, t0 = [], None
    for s, batch in enumerate(batches):
        if s == cfg["update_freq"]:  # the first window done: time the rest
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(state, batch))
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - cfg["update_freq"])
    out = {"losses": [float(m["loss"]) for m in losses], "ms_per_step": ms,
           "skipped": [float(m["skipped"]) for m in losses],
           "launches": _launch_counts("bf16"), "before": before,
           "after": {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()},
           "stats": {k: v.float().cpu().clone() for k, v in batch_norm_stats(model).items()}}
    if trace_steps and cuda:
        # the ranks trace in turn (one profiler on the card at a time), every
        # rank making the same calls (each runs collectives): one untraced
        # call, then `trace_steps` traced ones, or as many untraced
        it = iter(batches * world * 2)

        def call():
            step(state, next(it))

        for r in range(world):
            if r == rank:
                seq = flash_kernel_sequence(call, trace_steps)
            else:
                for _ in range(trace_steps + 1):
                    call()
        out["traced"] = {"calls": trace_steps, "kinds": dict(Counter(seq))}
    return out


def dp_worker(job: str, out: str) -> int:
    """A rank of 16b and 16c (`--dp-worker <job.json> <out.pt>`): joins the
    gloo group of RANK / WORLD_SIZE at MASTER_ADDR:MASTER_PORT on card 0,
    adopts it through `parallel.init_distributed_mode` as train.main would,
    waits for the job's go file, runs `dp_step_run` on each of the job's
    configs in turn and writes their results, by name."""
    import torch
    import torch.distributed as dist

    from imageclassification_tpu_torch.parallel import init_distributed_mode

    with open(job) as f:
        job = json.load(f)
    cfgs = job["cfgs"]
    cuda = any(cfg["device"] == "cuda" for cfg in cfgs.values())
    if cuda:
        if not torch.cuda.is_available():
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                                                 f"{os.environ['MASTER_PORT']}"),
                            world_size=world, rank=rank)
    try:
        res = {}
        for name, cfg in cfgs.items():
            args = dp_config(cfg)
            init_distributed_mode(args)
            if not (args.distributed and (args.rank, args.world_size) == (rank, world)):
                raise AssertionError(f"the group was not adopted: {args}")
            deadline = time.monotonic() + 600
            while not os.path.exists(job["go"]):
                if time.monotonic() > deadline:
                    raise AssertionError(f"no go file {job['go']} after 600 s")
                time.sleep(0.2)
            res[name] = dp_step_run(cfg, world, rank, trace_steps=cfg["update_freq"])
            if cuda:
                torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_spawn(work: str, cfgs: dict):
    """Two `dp_worker` ranks on the card, for `cfgs` ({name: cfg}, run in
    turn); they wait for the go file. Returns (the go file's path, the
    processes, their output paths)."""
    job, go = os.path.join(work, "dp_job.json"), os.path.join(work, "dp_go")
    with open(job, "w") as f:
        json.dump({"cfgs": cfgs, "go": go}, f)
    port = str(_free_port())
    procs, outs = [], []
    for rank in range(2):
        outs.append(os.path.join(work, f"dp_rank{rank}.pt"))
        # the host's cores split between the ranks (threads that spin while
        # the other rank holds the cores stall both at every collective)
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS")
                   or str(max(1, (os.cpu_count() or 2) // 2)))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker",
                                       job, outs[-1]], env=env))
    return go, procs, outs


def dp_collect(procs: list, outs: list) -> list:
    """The ranks' results ({name: result} each) once both have exited."""
    rcs = [p.wait(timeout=420) for p in procs]
    if any(rcs):
        raise AssertionError(f"phase 16: the ranks exited with {rcs}")
    import torch

    return [torch.load(o, weights_only=False) for o in outs]


def dp_compare(name: str, ranks: list, one: dict, cfg: dict) -> dict:
    """Holds the two ranks to each other (bitwise) and to one process on the
    global batch (DP_* tolerances); returns the agreement."""
    import torch

    r0, r1 = ranks
    for part in ("after", "stats"):
        for k, v in r0[part].items():
            if not torch.equal(v, r1[part][k]):
                raise AssertionError(f"16 {name}: the ranks' {part} {k} differ")
    if r0["losses"] != r1["losses"]:
        raise AssertionError(f"16 {name}: the ranks' losses differ: {r0['losses']} {r1['losses']}")
    losses = np.asarray(r0["losses"])
    want = np.asarray(one["losses"])
    if not (np.isfinite(losses).all() and not any(r0["skipped"])):
        raise AssertionError(f"16 {name}: losses {losses}, skipped {r0['skipped']}")
    loss_err = float(np.max(np.abs(losses - want) / np.abs(want)))
    if loss_err > DP_LOSS_RTOL:
        raise AssertionError(f"16 {name}: losses {losses} against one process's {want}: "
                             f"relative {loss_err} > {DP_LOSS_RTOL}")
    d2 = torch.cat([(r0["after"][k] - r0["before"][k]).flatten() for k in r0["after"]])
    d1 = torch.cat([(one["after"][k] - one["before"][k]).flatten() for k in one["after"]])
    update_rel_l2 = ((d2 - d1).norm() / d1.norm()).item()
    update_max = (d2 - d1).abs().max().item()
    scale = d1.abs().max().item()
    if not (update_rel_l2 <= DP_UPDATE_RTOL and update_max <= DP_UPDATE_RTOL * scale):
        raise AssertionError(f"16 {name}: updates against one process's: relative L2 "
                             f"{update_rel_l2} (tol {DP_UPDATE_RTOL}), max|d| {update_max} (tol "
                             f"{DP_UPDATE_RTOL * scale})")
    res = {"losses": r0["losses"], "losses_one_process": one["losses"],
           "loss_max_rel_err": loss_err, "update_rel_l2": update_rel_l2,
           "update_max_abs_err": update_max, "update_max_abs": scale,
           "ms_per_step": [r["ms_per_step"] for r in ranks],
           "ms_per_step_one_process": one["ms_per_step"],
           "launches": r0["launches"], "launches_rank1": r1["launches"]}
    if r0["stats"]:
        stats_err = max((r0["stats"][k] - v).abs().max().item() for k, v in one["stats"].items())
        stats_scale = max(v.abs().max().item() for v in one["stats"].values())
        if stats_err > DP_STATS_RTOL * stats_scale:
            raise AssertionError(f"16 {name}: BatchNorm statistics max|d| {stats_err} > "
                                 f"{DP_STATS_RTOL * stats_scale}")
        res.update(stats_max_abs_err=stats_err, stats_max_abs=stats_scale)
    return res


def dp_launch_world_of_one(work: str) -> dict:
    """16a: train.main on ViT-B/16 --flash_attn for 1 epoch of 4 steps at
    batch 64 under torchrun's environment for a world of one, then as a
    plain launch: "Not using distributed mode", the captured step, and the
    two runs bitwise equal (every step's loss, every parameter)."""
    import torch

    from imageclassification_tpu_torch.engine.compiled import CapturedTrainStep

    cfg = DP_LAUNCH
    images = _train_images(work, cfg["num_classes"], cfg["per_class"], seed=16)
    flags = ["--model", cfg["model"], "--flash_attn", "true", "--input_size",
             str(cfg["img"]), "--batch_size", str(cfg["batch"]), "--epochs", "1",
             "--warmup_epochs", "1", "--device", cfg["device"], "--save_ckpt", "false"]
    runs = {}
    for name, env in (("launcher", {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}),
                      ("plain", {})):
        saved = {k: os.environ.pop(k, None) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
        os.environ.update(env)
        try:
            (state, args, records, wall_s, step), text = _printed_by(
                lambda: _train_main(os.path.join(work, name), images, flags))
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        if "Not using distributed mode" not in text or args.distributed:
            raise AssertionError(f"16a {name}: not a world of one")
        if isinstance(step, CapturedTrainStep) != (cfg["device"] == "cuda"):
            raise AssertionError(f"16a {name}: the train step ran as {type(step).__name__}")
        runs[name] = {"losses": [r["loss"] for r in records], "wall_s": wall_s,
                      "params": {k: v.detach().cpu() for k, v in state.model.named_parameters()}}
        del state, step
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    a, b = runs["launcher"], runs["plain"]
    same = a["losses"] == b["losses"] and all(torch.equal(v, b["params"][k])
                                              for k, v in a["params"].items())
    fingerprint = {n: float(sum(v.double().sum().item() for v in r["params"].values()))
                   for n, r in runs.items()}
    if not same:
        raise AssertionError(f"16a: the launcher's world of one differs from a plain launch: "
                             f"losses {a['losses']} / {b['losses']}, fingerprints {fingerprint}")
    return {"losses": a["losses"], "steps": len(a["losses"]), "fingerprint": fingerprint,
            "wall_s": {n: r["wall_s"] for n, r in runs.items()}}


def dp_phase(work: str) -> dict:
    """Phase 16 (see the constants above); returns its summary."""
    import torch

    out, seconds = {}, {}
    cfgs = {"16b": DP_VIT, "16c": DP_RESNET}
    t0 = time.perf_counter()
    go, procs, outs = dp_spawn(work, cfgs)
    try:
        out["16a"] = dp_launch_world_of_one(work)
        seconds["16a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        open(go, "w").close()
        results = dp_collect(procs, outs)
        seconds["16b+16c ranks"] = time.perf_counter() - t0
    finally:
        for p in procs:
            p.kill()
    a = out["16a"]
    log(f"data-parallel (16a): train.main, {DP_LAUNCH['model']} --flash_attn, batch "
        f"{DP_LAUNCH['batch']}, "
        f"{a['steps']} steps, under RANK=0 WORLD_SIZE=1: 'Not using distributed mode', the "
        f"step captured, losses {', '.join(f'{x:.4f}' for x in a['losses'])} and every "
        f"parameter bitwise those of a plain launch (fingerprint {a['fingerprint']['plain']!r}); "
        f"{a['wall_s']['launcher']:.1f} / {a['wall_s']['plain']:.1f} s")
    for name, cfg in cfgs.items():
        t0 = time.perf_counter()
        ranks = [r[name] for r in results]
        one = dp_step_run(cfg, 1, 0)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        res = dp_compare(name, ranks, one, cfg)
        steps = cfg["update_freq"] * cfg["opt_steps"]
        if cfg["flash"] and cfg["device"] == "cuda":
            per_step = {k: v / steps for k, v in res["launches"].items()}
            want = {"fwd": 24, "fwd_lse": 12, "bwd_dkv": 12, "bwd_dq": 12}
            for r in ranks:
                got = {k: v / steps for k, v in r["launches"].items()}
                if got != want:
                    raise AssertionError(f"16b: K1 launches a step on a rank {got}, want {want}")
                traced = {k: v / r["traced"]["calls"] for k, v in r["traced"]["kinds"].items()}
                if traced != {"fwd": 24, "dq": 12, "dkv": 12}:
                    raise AssertionError(f"16b: K1 kernels a step in a rank's trace {traced}")
            res["launches_per_step"] = per_step
            res["traced_per_step"] = [{k: v / r["traced"]["calls"]
                                       for k, v in r["traced"]["kinds"].items()} for r in ranks]
        seconds[f"{name} one process"] = time.perf_counter() - t0
        out[name] = res
        what = (f"{cfg['model']}{' --flash_attn' if cfg['flash'] else ''}, bf16, local batch "
                f"{cfg['local_batch']}, mixup + cutmix, --update_freq {cfg['update_freq']}, "
                f"{cfg['opt_steps']} optimizer steps")
        log(f"data-parallel ({name}): {what}, SGD lr {cfg['lr']}: the two ranks bitwise equal; "
            f"against one process on the global batch of {2 * cfg['local_batch']}: losses "
            f"max rel {res['loss_max_rel_err']:.2e} (tol {DP_LOSS_RTOL:.2e}), updates rel L2 "
            f"{res['update_rel_l2']:.2e} (tol {DP_UPDATE_RTOL:.2e}), max|d| "
            f"{res['update_max_abs_err']:.3e} of max|update| {res['update_max_abs']:.3e} (tol "
            f"{DP_UPDATE_RTOL:.3g} of it)"
            + (f", BatchNorm statistics max|d| {res['stats_max_abs_err']:.3e} of "
               f"{res['stats_max_abs']:.3e}" if "stats_max_abs_err" in res else "")
            + (f"; K1 launches a step on each rank {res['launches_per_step']} (counts), "
               f"{res['traced_per_step'][0]} (trace)" if "launches_per_step" in res else ""))
        log(f"data-parallel ({name}) ms a step, {DP_LABEL}: rank 0 "
            f"{res['ms_per_step'][0]:.1f}, rank 1 {res['ms_per_step'][1]:.1f}; one process on "
            f"the global batch, eager, alone on the card: {res['ms_per_step_one_process']:.1f}")
    out["seconds"] = seconds
    log(f"phase 16 wall seconds: {seconds}")
    return out


def dp_phases(keep: str) -> dict:
    """Phase 16 in a child process of this script (`--distributed`), with a
    fresh profiler as phases 10-15; returns its summary through a file."""
    out = os.path.join(keep, "phase16.json")
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--distributed", keep, out],
                        timeout=900).returncode
    if rc != 0:
        raise AssertionError(f"phase 16 (a child process) exited with {rc}")
    with open(out) as f:
        return json.load(f)


def dp_main(keep: str, out: str) -> int:
    """The child of `dp_phases`: phase 16 on the card."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        res = dp_phase(work)
    res["seconds"]["phase"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
              file=sys.stderr)
        return 1

    from imageclassification_tpu_torch.engine.compiled import TRAIN_WARMUP_STEPS as TRAIN_WARMUP
    from imageclassification_tpu_torch.ops import _build
    from imageclassification_tpu_torch.ops import conv1x1_bn as k2
    from imageclassification_tpu_torch.ops import dwconv as dw
    from imageclassification_tpu_torch.ops import flash_attention as fa
    from imageclassification_tpu_torch.ops import layernorm as ln

    sources = (fa.KERNEL, fa.KERNEL_BWD, fa.KERNEL_F32, fa.KERNEL_F32_BWD, ln.KERNEL, dw.KERNEL,
               k2.KERNEL)
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        nvcc_logs = dict(zip(sources, pool.map(_build.build, sources)))
    log(f"build: {', '.join(f'imageclassification_tpu_torch/csrc/{n}.cu' for n in sources)} "
        f"({' '.join(_build.NVCC_FLAGS[:2])}) in {time.perf_counter() - t0:.1f} s")
    for name, nvcc_log in nvcc_logs.items():
        for line in nvcc_log.splitlines():
            if any(w in line for w in ("registers", "spill", "Function properties", "wgmma",
                                       "warning")):
                log(f"ptxas {name}: {line.strip()[:160]}")
    from imageclassification_tpu_torch.data import native_decode

    t0 = time.perf_counter()
    built = native_decode.get_lib() is not None
    log(f"native JPEG decoder (imageclassification_tpu_torch/native/decode.cpp, g++ "
        f"{' '.join(native_decode.CXX_FLAGS + native_decode.LIBS)}): "
        + (f"built in {time.perf_counter() - t0:.1f} s on this host ({os.cpu_count()} CPUs); "
           "JPEGs decode through it, every other file through PIL" if built else
           f"did not build ({native_decode.build_error()}); every file decodes through PIL"))

    stamp('3a/3b bf16')
    # 3a. the forward kernel against its plain version
    rows = [check_attention(s, "cuda") for s in ATTN_SHAPES]
    main_row = rows[ATTN_SHAPES.index(MAIN_SHAPE)]
    # 3b. the backward kernels (and the forward's lse) against theirs
    bwd_rows = [check_backward(s, "cuda") for s in ATTN_SHAPES]
    bwd_main = bwd_rows[ATTN_SHAPES.index(MAIN_SHAPE)]
    stamp('3a/3b fp32')
    # 3a, 3b in fp32: the fp32 kernels (C1) against the fp32 plain version
    # (TF32 off) and fp32 SDPA, at the same shapes
    rows32 = [check_attention(s, "cuda", "fp32") for s in ATTN_SHAPES]
    bwd32 = [check_backward(s, "cuda", "fp32") for s in ATTN_SHAPES]
    main32, bwd32_main = (r[ATTN_SHAPES.index(MAIN_SHAPE)] for r in (rows32, bwd32))
    # 3a, 3b at the shape of phase 8, before the training phases, after
    # which a trace can come back without a kernel (`late_phases`)
    ft_shape = (FINETUNE["batch"], (FINETUNE["img"] // VIT_B16["patch"]) ** 2 + 1,
                VIT_B16["heads"], VIT_B16["dim"] // VIT_B16["heads"])
    ft_fwd, ft_bwd = check_attention(ft_shape, "cuda"), check_backward(ft_shape, "cuda")
    stamp('3c-3e')
    # 3c. the LayerNorm kernels against theirs (and one input with constant rows)
    ln_rows = [check_layernorm(r, c, "cuda") for r, c in LN_SHAPES]
    check_layernorm(4096, 96, "cuda", constant=True, timed=False)
    layernorm_host_steps("cuda")
    # 3d. the depthwise-conv kernels against theirs
    dw_rows = [check_dwconv(s, "cuda") for s in DW_SHAPES]
    # 3e. the fused 1x1 conv + BN statistics kernel against its plain version
    k2_rows = [check_conv1x1(s, "cuda") for s in K2_SHAPES]

    stamp('phase 4')
    # 4. the serving path
    with tempfile.TemporaryDirectory() as work:
        res = run_main_path(work, "cuda", VIT_B16, img=224, num_classes=5,
                            per_class=26, batch=64)
    for run in ("val_precision", "val_move"):
        got = res[f"launches_{run}"]
        log(f"serving path {run}: flash_attention_fwd launches counted by the wrapper {got} "
            f"(the first batch's eager run and its capture; {res['n_batches']} batches), "
            f"{res[f'{run}_s']:.2f} s for {res['n_images']} images incl. model load")
        if got <= 0:
            raise AssertionError(f"{run}: the flash kernel was never launched")
    log(f"serving path, launches per replayed batch (trace): {dict(res['per_replay'][0])} "
        f"in each of {len(res['per_replay'])} traced batches")
    for name in ("captured", "eager"):
        ms = res[f"ms_per_batch_{name}"]
        log(f"serving path ViT-B/16 224x224 bf16 batch 64, {name} predict: {ms:.3f} ms/batch, "
            f"{64 / (ms / 1e3):.1f} img/s (forward + softmax, CUDA events)")
    log(f"serving path probabilities, max|d|: bf16 flash vs bf16 plain attention "
        f"{res['probs_flash_vs_plain']:.3e}; bf16 flash vs fp32 plain "
        f"{res['probs_flash_vs_fp32']:.3e} (tol {PROBS_ATOL}); bf16 plain vs fp32 "
        f"{res['probs_plain_vs_fp32']:.3e}; argmax agreement flash vs fp32 "
        f"{res['argmax_agree_fp32']:.3f}; captured vs eager predict {res['probs_captured_vs_eager']:.3e}")
    for name, tr in res["trace"].items():
        log_trace(f"ViT-B/16 batch 64 bf16 forward, {name}", tr, "batch")
    fa_ms, fa_n = next(v for k, v in res["trace"]["flash captured"][2].items()
                       if "flash_attention_fwd" in k)
    log(f"flash_attention_fwd device time from the trace: {fa_ms / fa_n:.4f} ms per launch "
        f"at {MAIN_SHAPE}, bound/kernel {main_row['bound_ms'] / (fa_ms / fa_n):.3f}")

    stamp('phase 5')
    # 5. the training path; its checkpoint and folder are linked into `keep`
    # for phase 12
    cfg = TRAIN
    keep = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as work:
        images = _train_images(work, cfg["num_classes"], cfg["per_class"], seed=0)
        run = run_training(os.path.join(work, "vit"), "cuda", VIT_B16, cfg["img"],
                           cfg["num_classes"], cfg["per_class"], cfg["batch"], cfg["epochs"],
                           images=images)
        os.link(run["checkpoint"], os.path.join(keep.name, "teacher.pth"))
        shutil.copytree(images, os.path.join(keep.name, "images"), copy_function=os.link)
        losses = [r["loss"] for r in run["records"]]
        log(f"training path: {len(losses)} steps ({cfg['epochs']} epochs x "
            f"{run['steps_per_epoch']}) of ViT-B/16 --flash_attn 224x224 batch "
            f"{cfg['batch']}, captured after {TRAIN_WARMUP} eager steps, {run['wall_s']:.1f} s "
            f"for train.main (decode, evals and checkpoints included), fed {feed_note(images)}; "
            f"losses {', '.join(f'{x:.4f}' for x in losses)}")
        log(f"training path launches per step of the run's captured step (trace, in device "
            f"order: {VIT_B16['depth']} forwards with lse, the backward's dQ and dK/dV kernels, "
            f"{VIT_B16['depth']} forwards without lse): "
            f"{[dict(c) for c in run['per_replay']]}; counted by the wrappers over the run "
            f"(the eager steps, the captures and the evals' first batches) {run['totals']}; "
            f"{run['checkpoint'].split('/')[-1]} in the JAX layout, reloaded by "
            f"val.initialize_model to the run's exact weights")
        stamp('phase 5b')
        # 5b. steady state, traces and gradient agreement on the trained weights
        chk = train_step_checks(run, VIT_B16, "cuda")
        for name in ("flash", "plain"):
            log_step_timing(f"ViT-B/16 224x224 bf16, {name} attention", cfg["batch"], chk[name])
        step_kernels = chk["flash"]["captured"][1][2]
        log("flash backward in the captured ViT-B/16 train step (trace): " + ", ".join(
            f"{kernel} {sum(ms for k, (ms, _) in step_kernels.items() if kernel in k):.4f} ms in "
            f"{sum(n for k, (_, n) in step_kernels.items() if kernel in k):.1f} launches a step"
            for kernel in (k1_kernels("bf16")[p] for p in ("dq", "dkv"))))
        totals, per_replay = run["totals"], run["per_replay"][0]
        del run, chk
        stamp('phase 5c')
        # 5c. captured steps against eager steps at full width, and a
        # non-finite step inside the replays
        eq = captured_vs_eager(VIT_B16, cfg["img"], cfg["batch"], cfg["num_classes"])
        log(f"captured vs eager ViT-B/16 --flash_attn (drop_path 0.1, default flags, EMA with "
            f"warmup), {eq['steps']} steps from one seeded state and seeded generators: max|d| "
            f"over parameters, EMA, moments and count eager vs eager {eq['eager_gap']:.3e}, "
            f"captured vs eager {eq['captured_gap']:.3e}; losses eager {eq['losses'][0]}, "
            f"captured {eq['losses'][2]}; a non-finite step in the replays (head bias inf): "
            f"skipped {eq['skipped']}, state unchanged bitwise; the next step applies")

        stamp('phase 5d')
        # 5d. the fp32 path of --flash_attn: train.main with --half_precision
        # false (1 epoch of 10 steps), its checkpoint served, an fp32 batch
        f32 = fp32_path(os.path.join(work, "vit_fp32"), "cuda", VIT_B16, cfg, images)
        losses = [r["loss"] for r in f32["records"]]
        log(f"fp32 training path (5d): {f32['steps']} steps of ViT-B/16 --flash_attn "
            f"--half_precision false 224x224 batch {cfg['batch']}, captured, {f32['wall_s']:.1f} "
            f"s for train.main; losses {', '.join(f'{x:.4f}' for x in losses)}; fp32 kernel "
            f"launches counted by the wrappers over the run {f32['totals']}, none of the bf16 "
            f"ones; per replayed step (trace, in device order, every K1 kernel the fp32 one) "
            f"{[dict(c) for c in f32['per_replay']]}")
        log_step_timing("ViT-B/16 224x224 fp32 (--half_precision false), flash attention",
                        cfg["batch"], f32["timing"])
        # fp32 K1's share of the captured step: the forward
        # (csrc/flash_attention_f32.cu), dQ and dK/dV (csrc/flash_attention_f32_bwd.cu)
        step32 = f32["timing"]["captured"][1][2]
        f32_step_k1 = {part: [sum(x[i] for k, x in step32.items() if kernel in k) for i in (0, 1)]
                       for part, kernel in k1_kernels("fp32").items()}
        log("fp32 K1 in the captured fp32 ViT-B/16 train step (trace): " + ", ".join(
            f"{k1_kernels('fp32')[part]} {ms:.4f} ms in {n:.1f} launches a step"
            for part, (ms, n) in f32_step_k1.items())
            + f"; the backward (dQ + dK/dV, csrc/{fa.KERNEL_F32_BWD}.cu) "
              f"{f32_step_k1['dq'][0] + f32_step_k1['dkv'][0]:.4f} ms of the step's "
              f"{f32['timing']['captured'][0]:.3f} ms")
        log(f"fp32-trained checkpoint served by val_precision (bf16 compute, as the JAX val.py): "
            f"top-1 {f32['val_top1']:.3f}, bf16 launches {f32['val_launches']}; an fp32 served "
            f"batch of {cfg['batch']} (val.initialize_model(half_precision=False), captured "
            f"predict): fp32 launches at its first call {f32['serve_launches']}, per replayed "
            f"batch (trace) {dict(f32['serve_per_replay'][0])}, {f32['serve_ms']:.3f} ms/batch; "
            f"probabilities max|d| against the fp32 plain attention path "
            f"{f32['probs_flash_vs_plain']:.3e} (tol {FP32_PROBS_ATOL})")
        log_trace(f"ViT-B/16 batch {cfg['batch']} fp32 forward, flash captured", f32["serve_trace"],
                  "batch")
        f32_totals, f32_replay = f32["totals"], f32["per_replay"][0]
        f32_serve = {"launches": f32["serve_launches"]["fwd"],
                     "launches_per_replay": f32["serve_per_replay"][0]["fwd"],
                     "ms_per_batch": f32["serve_ms"]}
        f32_step_ms = {k: f32["timing"][k][0] for k in ("captured", "eager")}
        f32_step_ms["k1_ms_a_step"] = {part: ms for part, (ms, _) in f32_step_k1.items()}
        del f32

        stamp('phase 6')
        # 6. the ConvNeXt-T training path on the same folder
        cnx = run_convnext_training(os.path.join(work, "convnext"), "cuda", CONVNEXT_T,
                                    cfg["img"], cfg["num_classes"], cfg["per_class"],
                                    cfg["batch"], cfg["epochs"], images=images)
        losses = [r["loss"] for r in cnx["records"]]
        log(f"training path: {len(losses)} steps ({cfg['epochs']} epochs x "
            f"{cnx['steps_per_epoch']}) of ConvNeXt-T 224x224 batch {cfg['batch']} (drop_path "
            f"{cnx['args'].drop_path}), captured, {cnx['wall_s']:.1f} s for train.main; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; no kernel launched (the model runs "
            f"F.conv2d and its fp32 LayerNorm, as the JAX model runs lax.conv and "
            f"nn.LayerNorm); {cnx['checkpoint'].split('/')[-1]} in the JAX layout, reloaded "
            f"by val.initialize_model to the run's exact weights; val_precision top-1 "
            f"{cnx['val_top1']:.3f} on the training folder")
        log_step_timing("ConvNeXt-T 224x224 bf16", cfg["batch"], step_timing(cnx, "cuda"))
        # 6b. the LayerNorm and depthwise-conv kernels on the step's own tensors
        replay = replay_convnext_ops(cnx, "cuda")
        del cnx
        n_ln = 1 + 3 + sum(CONVNEXT_T["depths"]) + 1  # stem, downsamples, blocks, head
        n_dw = sum(CONVNEXT_T["depths"])
        want = {"ln_fwd": n_ln, "ln_bwd": n_ln, "dw_fwd": n_dw, "dw_dx": n_dw, "dw_dw": n_dw}
        if replay["launches"] != want:
            raise AssertionError(f"replay launches {replay['launches']}, expected {want}")
        log(f"replay of one ConvNeXt-T train step: {replay['n_ln']} LayerNorms (rows x C "
            f"{replay['ln_shapes']}) and {replay['n_dw']} depthwise convs ({replay['dw_shapes']}) "
            f"through the kernels, launches {replay['launches']}; " + replay_note(replay["nearest"]))
        dw_gap = launch_gap(dw_rows, replay["dw_counts"], lambda r: tuple(r["shape"]),
                            lambda r: sum(r["device_ms"][k] - r["bound"][k][0]
                                          for k in ("fwd", "dx")))
        log(f"launches x (device - bound) over one ConvNeXt-T train step: dwconv7x7_fwd "
            f"(forward + dx) {dw_gap[0]:.4f} ms over {dw_gap[1]} convs on the shapes of 3d "
            f"({dw_gap[2]} on others, left out)")

        stamp('phase 7')
        # 7. the ResNet-50 training path on the same folder
        rn = run_resnet_training(os.path.join(work, "resnet"), "cuda", RESNET50, cfg["img"],
                                 cfg["num_classes"], cfg["per_class"], cfg["batch"],
                                 cfg["epochs"], images=images)
        losses = [r["loss"] for r in rn["records"]]
        log(f"training path: {len(losses)} steps ({cfg['epochs']} epochs x "
            f"{rn['steps_per_epoch']}) of ResNet-50 224x224 batch {cfg['batch']}, captured, "
            f"{rn['wall_s']:.1f} s for train.main; losses {', '.join(f'{x:.4f}' for x in losses)}; "
            f"no kernel launched (the model runs F.conv2d and its BatchNorm, as the JAX model "
            f"runs lax.conv and nn.BatchNorm); {rn['checkpoint'].split('/')[-1]} in the JAX "
            f"layout with batch_stats, reloaded by val.initialize_model to the run's exact "
            f"weights and statistics; val_precision top-1 {rn['val_top1']:.3f} on the training "
            f"folder")
        log_step_timing("ResNet-50 224x224 bf16", cfg["batch"], step_timing(rn, "cuda"))
        # 7b. the fused 1x1 conv + BN statistics kernel on the step's own tensors
        k2_replay = replay_resnet_convs(rn["state"].model, rn["args"], _fixed_batch(rn, "cuda"),
                                        rn["num_classes"])
        del rn
        n_blocks = sum(RESNET50["stage_sizes"])
        want = {"k2": n_blocks + len(RESNET50["stage_sizes"]), "k2_bn_in": n_blocks}
        if k2_replay["launches"] != want:
            raise AssertionError(f"ResNet-50 replay launches {k2_replay['launches']}, expected {want}")
        log(f"replay of one ResNet-50 train step: {k2_replay['n']} 1x1 convs (M, K, N, prologue "
            f"{k2_replay['shapes']}) through the fused kernel, launches {k2_replay['launches']}; "
            f"largest max|d| " + ", ".join(f"{k} {e:.3e}" for k, e in k2_replay["errs"].items())
            + f" (tolerances: vs model 2^-6 of max|ref| (batch mean: of the largest column mean of "
            f"|y|); vs plain 2^-7, column sums {SUM_RTOL})")
        k2_gap = launch_gap(k2_rows, k2_replay["counts"], lambda r: (*r["shape"], r["bn_in"]),
                            lambda r: r["device_ms"] - r["bound"][0])
        log(f"launches x (device - bound) over one ResNet-50 train step: conv1x1_bn_stats "
            f"{k2_gap[0]:.4f} ms over {k2_gap[1]} launches on the shapes of 3e ({k2_gap[2]} on "
            f"others, left out)")

        stamp('phase 7c')
        # 7c. the port bench at batch 128 (its captured step), and the times and
        # traces of its captured and eager steps
        from imageclassification_tpu_torch import bench

        bench_line = bench.run(batch=128)
        log(f"port bench (python -m imageclassification_tpu_torch.bench): {json.dumps(bench_line)}")
        step, state, data = bench.build(128, 224, torch.device("cuda"))
        log_step_timing("port bench: ResNet-50 224x224 bf16", 128,
                        time_captured_and_eager(state, step.step, data))
        del step, state, data

        stamp('phase 8')
        # 8. fine-tuning ViT-B/16 --flash_attn at 384x384 from a 224x224
        # state_dict, on the same folder; the launches counted from 0 over
        # its run
        # 1 epoch of 10 steps (cut from 2 for the command's time)
        ft = run_finetune(os.path.join(work, "finetune"), "cuda", VIT_B16, FINETUNE,
                          cfg["num_classes"], cfg["per_class"], 1, images=images)
        ft_b, ft_img = FINETUNE["batch"], FINETUNE["img"]
        losses = [r["loss"] for r in ft["records"]]
        log(f"fine-tuning path: {FINETUNE['name']} state_dict (1000 classes, {FINETUNE['src_img']}"
            f"x{FINETUNE['src_img']}, torch zip) through --pretrained_path at {ft_img}x{ft_img}, "
            f"--flash_attn, batch {ft_b}: the load printed {ft['resized']!r} and skipped "
            f"{ft['skipped']}; every other parameter equals the file's; pos_embed max|d| vs a "
            f"plain fp32 antialiased bicubic resample {ft['pos_err']:.3e} (tol {POS_EMBED_ATOL}); "
            f"{len(losses)} steps (1 epoch x {ft['steps_per_epoch']}), "
            f"{ft['wall_s']:.1f} s for train.main; losses {', '.join(f'{x:.4f}' for x in losses)}")
        log(f"fine-tuning path launches per step of the run's captured step at N = "
            f"{(ft_img // 16) ** 2 + 1} (trace, in device order): "
            f"{[dict(c) for c in ft['per_replay']]}; counted by the wrappers over the run "
            f"{ft['totals']}; {ft['checkpoint'].split('/')[-1]} in the JAX layout, input_shape "
            f"{ft['input_shape']}, reloaded to the run's exact weights")
        log(f"fine-tuned checkpoint served by val_precision at {ft_img}x{ft_img}: top-1 "
            f"{ft['val_top1']:.3f}, flash_attention_fwd launches counted by the wrapper "
            f"{ft['serve_launches']} (the first batch's eager run and its capture); per replayed "
            f"batch (trace) {dict(ft['serve_per_replay'][0])} in each of "
            f"{len(ft['serve_per_replay'])} traced batches")
        for name in ("captured", "eager"):
            ms = ft[f"serve_ms_{name}"]
            log(f"serving ViT-B/16 {ft_img}x{ft_img} bf16 batch {ft_b}, {name} predict: {ms:.3f} "
                f"ms/batch, {ft_b / (ms / 1e3):.1f} img/s (forward + softmax, CUDA events)")
        log_trace(f"ViT-B/16 {ft_img}x{ft_img} batch {ft_b} bf16 forward, flash captured",
                  ft["serve_trace"], "batch")
        log_step_timing(f"ViT-B/16 {ft_img}x{ft_img} bf16 fine-tune, flash attention", ft_b,
                        step_timing(ft, "cuda"))
        ft_totals, ft_replay = ft["totals"], ft["per_replay"][0]
        ft_serve_replay = ft["serve_per_replay"][0]
        del ft

        stamp('phase 9')
        # 9. the CLI's default model: train.main with no --model
        # 1 epoch of 10 steps (cut from 2 for the command's time)
        dm = run_default_model_training(os.path.join(work, "default"), "cuda", cfg["img"],
                                        cfg["num_classes"], cfg["per_class"], cfg["batch"],
                                        1, images=images)
        losses = [r["loss"] for r in dm["records"]]
        log(f"default-model path: train.main with no --model ({dm['args'].model}, drop_rate "
            f"{dm['args'].drop_path} from --drop_path) {cfg['img']}x{cfg['img']} batch "
            f"{cfg['batch']}, {len(losses)} steps (1 epoch x "
            f"{dm['steps_per_epoch']}), captured, {dm['wall_s']:.1f} s for train.main; losses "
            f"{', '.join(f'{x:.4f}' for x in losses)}; no kernel launched (the model runs "
            f"F.conv2d, its BatchNorm and plain attention, as the JAX model runs lax.conv, "
            f"nn.BatchNorm and einsums); {dm['checkpoint'].split('/')[-1]} in the JAX layout "
            f"with batch_stats, reloaded to the run's exact weights and statistics; "
            f"val_precision top-1 {dm['val_top1']:.3f} on the training folder")
        log_step_timing(f"EfficientViT-M0 {cfg['img']}x{cfg['img']} bf16 (default flags)",
                        cfg["batch"], step_timing(dm, "cuda"))
        del dm

    stamp('phases 10-11')
    # 10. fine-tuning ViT-B/16 --flash_attn at 1024x1024 from a 224x224
    # state_dict with --layer_decay 0.65 and --remat, fed 1280 x 960 JPEGs,
    # the launches counted from 0 over its run; 11. the feed: BatchLoader's
    # img/s over JPEGs, native and PIL, and train.main's epochs split into
    # steps, loader waits, eval and checkpoint writes
    # (1 epoch of 10 steps at 1024x1024, cut from 2 for the command's time)
    hr = late_phases(cfg["num_classes"], 1)

    stamp('phase 12')
    # 12. the training recipes: 12a the DeiT-style recipe (--aa RandAugment,
    # distillation from phase 5's checkpoint), 12b each policy alone, 12c
    # --prune_mask; the launches counted from 0 over each run
    recipes = recipe_phases(keep.name)

    stamp('phase 13')
    # 13. the rest of the registry and of the optimizer table: 13a nvnovograd
    # and adafactor on ViT-B/16 --flash_attn, 13b adahessian on ConvNeXt-T,
    # 13c Swin-T, MobileNetV3-Large, EfficientNet-B0, DenseNet-121; the
    # launches counted from 0 over each run
    registry = registry_phases(keep.name)

    stamp('phase 14')
    # 14. int8 serving, the checkpoint tools and visualization on ViT-B/16
    # --flash_attn and ConvNeXt-T; the launches counted from 0 over each path
    lifecycle = lifecycle_phases(keep.name)
    stamp('phase 15')
    # 15. UPerNet segmentation at full width in one process (seg_train),
    # whole / slide / ms eval, K3-K5 at its backbone's shapes
    seg = seg_phases(keep.name)
    stamp('phase 16')
    # 16. data-parallel training: 16a a world of one through the launcher,
    # 16b two processes on the card against one (ViT-B/16 --flash_attn),
    # 16c the same on ResNet-50; the launches counted from 0 over each rank's
    # steps
    dp = dp_phases(keep.name)
    keep.cleanup()

    stamp('the kernels line')
    # results
    replaces_bwd = ("jax/experimental/pallas/ops/tpu/flash_attention.py:{} (the backward of "
                    "imageclassification_tpu/models/vit.py:25)")
    kernels = [{
        "name": fa.KERNEL, "route": "cuda",
        "source": f"imageclassification_tpu_torch/csrc/{fa.KERNEL}.cu",
        "replaces": "imageclassification_tpu/models/vit.py:25",
        "launches": totals["fwd"],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": main_row["library_ms"],
        "device_ms": main_row["device_ms"], "library_device_ms": main_row["library_device_ms"],
        "launches_lse": totals["fwd_lse"], "launches_per_replay": per_replay["fwd"],
    }]
    for part, line, errs in (("dkv", 1121, ("dk", "dv")), ("dq", 1456, ("dq",))):
        kernels.append({
            "name": f"flash_attention_bwd_{part}", "route": "cuda",
            "source": f"imageclassification_tpu_torch/csrc/{fa.KERNEL_BWD}.cu",
            "replaces": replaces_bwd.format(line),
            "launches": totals[f"bwd_{part}"],
            "max_abs_err": max(bwd_main["errs"][e][0] for e in errs),
            "ms": bwd_main[f"ms_{part}"], "plain_ms": bwd_main["plain_ms"],
            "bound_ms": bwd_main["bounds"][part][0], "bound_by": bwd_main["bounds"][part][1],
            "library_ms": bwd_main["library_ms"], "device_ms": bwd_main[f"device_ms_{part}"],
            "library_device_ms": bwd_main["library_device_ms"],
            "launches_per_replay": per_replay[part],
        })
    # the flash kernels on the fine-tuning path (phase 8): launches counted
    # from 0 over its run, per replayed step and per served batch, and the
    # kernels at its shape against their plain versions and SDPA
    ft_path = {"shape": list(ft_shape),
               "path": "fine-tuning ViT-B/16 at 384x384 from a state_dict (chip_smoke.py phase 8)"}
    kernels[0]["at_577"] = {
        **ft_path, "launches": ft_totals["fwd"], "launches_lse": ft_totals["fwd_lse"],
        "launches_per_replay": ft_replay["fwd"], "launches_per_served_batch": ft_serve_replay["fwd"],
        **{k: ft_fwd[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "device_ms", "library_device_ms")}}
    for entry, (part, errs) in zip(kernels[1:3], (("dkv", ("dk", "dv")), ("dq", ("dq",)))):
        entry["at_577"] = {
            **ft_path, "launches": ft_totals[f"bwd_{part}"], "launches_per_replay": ft_replay[part],
            "max_abs_err": max(ft_bwd["errs"][e][0] for e in errs), "ms": ft_bwd[f"ms_{part}"],
            "plain_ms": ft_bwd["plain_ms"], "bound_ms": ft_bwd["bounds"][part][0],
            "bound_by": ft_bwd["bounds"][part][1], "library_ms": ft_bwd["library_ms"],
            "device_ms": ft_bwd[f"device_ms_{part}"],
            "library_device_ms": ft_bwd["library_device_ms"]}
    # the flash kernels on the high-resolution path (phase 10): launches
    # counted from 0 over its run and per replayed step, the kernels at its
    # shape against their plain versions and SDPA, and their device ms
    # inside the captured --remat step beside the bound
    hr_path = {"shape": list(hr["shape"]),
               "path": (f"fine-tuning ViT-B/16 at 1024x1024 with --layer_decay 0.65 --remat, "
                        f"batch {hr['batch']} (chip_smoke.py phase 10)")}
    for entry, kind, total in zip(kernels[:3], ("fwd", "dkv", "dq"),
                                  ("fwd", "bwd_dkv", "bwd_dq")):
        entry["at_4097"] = {**hr_path, "launches": hr["totals"][total], **hr["k1"][kind]}
    kernels[0]["at_4097"]["launches_lse"] = hr["totals"]["fwd_lse"]
    # the LayerNorm and depthwise-conv rows: the stage-0 shape (the largest),
    # launches counted over the replay of phase 6b
    ln0, dw0 = ln_rows[0], dw_rows[0]
    replay_path = ("replay of one ConvNeXt-T train step's {} (chip_smoke.py phase 6b): the "
                   "JAX model and the port's run nn.LayerNorm / lax.conv, not these kernels")
    replaces_ln = "imageclassification_tpu/ops/pallas_layernorm.py:{} (fused_layer_norm)"
    for part, line in (("fwd", 85), ("bwd", 108)):
        errs = ("y",) if part == "fwd" else ("dx", "dgamma", "dbeta")
        kernels.append({
            "name": f"layer_norm_{part}", "route": "cuda",
            "source": f"imageclassification_tpu_torch/csrc/{ln.KERNEL}.cu",
            "replaces": replaces_ln.format(line),
            "launches": replay["launches"][f"ln_{part}"],
            "max_abs_err": max(ln0["errs"][e][0] for e in errs),
            "ms": ln0[f"ms_{part}"], "plain_ms": ln0[f"plain_ms_{part}"],
            "bound_ms": ln0[f"bound_{part}"][0], "bound_by": ln0[f"bound_{part}"][1],
            "library_ms": ln0[f"library_ms_{part}"], "shape": ln0["shape"],
            "device_ms": ln0[f"device_ms_{part}"],
            "library_device_ms": ln0[f"library_device_ms_{part}"],
            "path": replay_path.format(f"{n_ln} LayerNorms"),
        })
    replaces_dw = "imageclassification_tpu/ops/pallas_dwconv.py:{} (depthwise_conv7x7)"
    for name, line, part in (("dwconv7x7_fwd", 58, "fwd"), ("dwconv7x7_dw", 111, "dw")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"imageclassification_tpu_torch/csrc/{dw.KERNEL}.cu",
            "replaces": replaces_dw.format(line),
            "launches": (replay["launches"]["dw_fwd"] + replay["launches"]["dw_dx"]
                         if part == "fwd" else replay["launches"]["dw_dw"]),
            "max_abs_err": max(dw0["errs"][e][0] for e in (("y", "dx") if part == "fwd"
                                                            else ("dw",))),
            "ms": dw0["ms"][part], "plain_ms": dw0["plain_ms"][part],
            "bound_ms": dw0["bound"][part][0], "bound_by": dw0["bound"][part][1],
            "library_ms": dw0["library_ms"][part], "shape": dw0["shape"],
            "path": replay_path.format(f"{n_dw} depthwise convs"),
        })
    kernels[-2].update(launch_gap_ms=dw_gap[0], launches_fwd=replay["launches"]["dw_fwd"],
                       launches_dx=replay["launches"]["dw_dx"], ms_dx=dw0["ms"]["dx"],
                       library_ms_dx=dw0["library_ms"]["dx"], device_ms=dw0["device_ms"]["fwd"],
                       device_ms_dx=dw0["device_ms"]["dx"],
                       library_device_ms=dw0["library_device_ms"]["fwd"],
                       library_device_ms_dx=dw0["library_device_ms"]["dx"])
    kernels[-1].update(device_ms=dw0["device_ms"]["dw"],
                       library_device_ms=dw0["library_device_ms"]["dw"])
    # the fused 1x1 conv row: ResNet-50's stage-1 conv3 shape (the largest),
    # launches counted over the replay of phase 7b
    k2_0 = k2_rows[0]
    kernels.append({
        "name": "conv1x1_bn_stats", "route": "cuda",
        "source": f"imageclassification_tpu_torch/csrc/{k2.KERNEL}.cu",
        "replaces": "imageclassification_tpu/ops/pallas_conv1x1_bn.py:132 (conv1x1_bn_stats; "
                    "kernels :85, :95)",
        "launches": k2_replay["launches"]["k2"] + k2_replay["launches"]["k2_bn_in"],
        "max_abs_err": k2_0["errs"]["y"], "ms": k2_0["ms"], "plain_ms": k2_0["plain_ms"],
        "bound_ms": k2_0["bound"][0], "bound_by": k2_0["bound"][1],
        "library_ms": k2_0["library_ms"], "shape": k2_0["shape"], "bn_in": k2_0["bn_in"],
        "device_ms": k2_0["device_ms"], "library_device_ms": k2_0["library_device_ms"],
        "chain_ms": k2_0["chain_ms"], "chain_device_ms": k2_0["chain_device_ms"],
        "launch_gap_ms": k2_gap[0], "launches_plain": k2_replay["launches"]["k2"],
        "launches_bn_in": k2_replay["launches"]["k2_bn_in"],
        "path": ("replay of one ResNet-50 train step's 36 1x1 convs (chip_smoke.py phase 7b): "
                 "the JAX model and the port's run lax.conv / F.conv2d, not this kernel"),
    })
    # the flash kernels on the recipe paths (phase 12): launches counted from
    # 0 over each run, and a replayed step's
    for entry, kind, total in zip(kernels[:3], ("fwd", "dkv", "dq"),
                                  ("fwd", "bwd_dkv", "bwd_dq")):
        for path, what in (("recipe", "the DeiT-style recipe, --aa rand-m9-mstd0.5-inc1 and "
                                      "distillation (chip_smoke.py phase 12a)"),
                           ("prune", "--prune_mask fine-tuning (chip_smoke.py phase 12c)")):
            entry[path] = {"path": what, "launches": recipes[path]["totals"][total],
                           "launches_per_replay": recipes[path]["per_replay"][kind]}
        # the flash kernels on the optimizer paths (phase 13a)
        for opt, row in registry["optimizers"].items():
            entry[opt] = {"path": f"--opt {opt}, ViT-B/16 --flash_attn (chip_smoke.py phase 13a)",
                          "launches": row["totals"][total],
                          "launches_per_replay": row["per_replay"][kind]}
    # the flash kernels on phase 14's paths: int8 serving (the wrappers over
    # val.py, the eager first batch and its capture; a replayed batch from a
    # trace), Grad-CAM of one batch, and one call of each reloaded program
    # the fp32 kernels (C1): 3a/3b at the main shape, launches over phase
    # 5d's run and per replayed step, the fp32 served batch
    replaces = {"fwd": "jax/experimental/pallas/ops/tpu/flash_attention.py:758 (imageclassification_"
                       "tpu/models/vit.py:25 in an fp32 model)",
                "dkv": replaces_bwd.format(1121) + " in an fp32 model",
                "dq": replaces_bwd.format(1456) + " in an fp32 model"}
    # (all three redesigned: three TF32 passes on wgmma fed by TMA); bounds at
    # the three-pass TF32 rate, the FFMA rate's beside them
    for part, total, errs in (("fwd", "fwd", None), ("dkv", "bwd_dkv", ("dk", "dv")),
                              ("dq", "bwd_dq", ("dq",))):
        row = main32 if part == "fwd" else bwd32_main
        entry = {"name": K1_PARTS[part] + k1_dtype("fp32")[1], "route": "cuda",
                 "source": "imageclassification_tpu_torch/csrc/"
                           f"{fa.KERNEL_F32 if part == 'fwd' else fa.KERNEL_F32_BWD}.cu",
                 "replaces": replaces[part], "launches": f32_totals[total],
                 "launches_per_replay": f32_replay[part], "plain_ms": row["plain_ms"],
                 "library_ms": row["library_ms"], "library_device_ms": row["library_device_ms"],
                 "step_ms_fp32": f32_step_ms, "redesigned": True}
        if part == "fwd":
            entry.update(design="three TF32 passes on wgmma, fed by TMA; Vᵀ written by the "
                                "converters, its keys permuted so that P is the A operand "
                                "in registers (a redesign of the FFMA kernel)",
                         max_abs_err=row["max_abs_err"], ms=row["ms"], bound_ms=row["bound_ms"],
                         bound_by=row["bound_by"], bound_ffma_ms=row["bound_ffma_ms"],
                         device_ms=row["device_ms"], launches_lse=f32_totals["fwd_lse"],
                         served_fp32=f32_serve)
        else:
            entry.update(design="three TF32 passes on wgmma, fed by TMA (a redesign of the FFMA "
                                "kernels)",
                         max_abs_err=max(row["errs"][e][0] for e in errs),
                         ms=row[f"ms_{part}"], bound_ms=row["bounds"][part][0],
                         bound_by=row["bounds"][part][1],
                         bound_ffma_ms=row["bounds_ffma"][part][0],
                         device_ms=row[f"device_ms_{part}"],
                         library_max_abs_err=max(row["library_errs"][e] for e in errs))
        entry["shapes"] = {
            str(tuple(r["shape"])): {
                k: r[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                  "library_device_ms")}
            | ({"bound_ms": r["bound_ms"], "bound_ffma_ms": r["bound_ffma_ms"]}
               if part == "fwd" else
               {"ms": r[f"ms_{part}"], "device_ms": r[f"device_ms_{part}"],
                "bound_ms": r["bounds"][part][0], "bound_ffma_ms": r["bounds_ffma"][part][0],
                "whole_ms": r["ms"], "whole_device_ms": r["device_ms"]})
            for r in (rows32 if part == "fwd" else bwd32)}
        kernels.append(entry)
    f32_entries = {k["name"]: k for k in kernels[-3:]}
    cam = lifecycle["gradcam"][VIT_B16["name"]]["launches"]
    kernels[0]["int8_serving"] = {
        "path": "int8 ViT-B/16 served by val.py (chip_smoke.py phase 14a)",
        "launches": lifecycle["int8"]["totals"]["fwd"],
        "launches_per_replay": lifecycle["int8"]["per_replay"]["fwd"]}
    kernels[0]["export"] = {
        "path": "the reloaded torch.export program of ViT-B/16 (chip_smoke.py phase 14b)",
        "launches": lifecycle["export"]["bf16"]["launches"]["fwd"]}
    for part, total in (("fwd", "fwd"), ("dkv", "bwd_dkv"), ("dq", "bwd_dq")):
        f32_entries[K1_PARTS[part] + k1_dtype("fp32")[1]]["gradcam"] = {
            "path": "Grad-CAM of ViT-B/16 in fp32, one batch (chip_smoke.py phase 14c)",
            "launches": cam[total]}
    # K3-K5 on the segmentation path (phase 15): launches in the replay of
    # one UPerNet iteration's backbone, and the kernels at its stage-0 shape
    seg_ln0, seg_dw0 = seg["ln_rows"][0], seg["dw_rows"][0]
    for k in kernels:
        if k["name"].startswith("layer_norm_"):
            part = k["name"].split("_")[-1]
            k["upernet"] = {"path": "replay of one UPerNet ConvNeXt-T 512^2 batch-16 iteration "
                                    "(chip_smoke.py phase 15)",
                            "launches": seg["replay"]["launches"][f"ln_{part}"],
                            "shape": seg_ln0["shape"], "ms": seg_ln0[f"ms_{part}"],
                            "device_ms": seg_ln0[f"device_ms_{part}"],
                            "library_ms": seg_ln0[f"library_ms_{part}"],
                            "bound_ms": seg_ln0[f"bound_{part}"][0]}
        elif k["name"].startswith("dwconv7x7_"):
            part = "fwd" if k["name"].endswith("fwd") else "dw"
            k["upernet"] = {"path": "replay of one UPerNet ConvNeXt-T 512^2 batch-16 iteration "
                                    "(chip_smoke.py phase 15)",
                            "launches": (seg["replay"]["launches"]["dw_fwd"]
                                         + seg["replay"]["launches"]["dw_dx"] if part == "fwd"
                                         else seg["replay"]["launches"]["dw_dw"]),
                            "shape": seg_dw0["shape"], "ms": seg_dw0["ms"][part],
                            "device_ms": seg_dw0["device_ms"][part],
                            "library_ms": seg_dw0["library_ms"][part],
                            "bound_ms": seg_dw0["bound"][part][0]}
    if any(k.get("upernet", {"launches": 1})["launches"] <= 0 for k in kernels):
        raise AssertionError("a K3-K5 kernel was not launched in the UPerNet replay")
    # the bf16 K1 kernels on the data-parallel path (16b): each rank's
    # launches over its 8 micro-steps, counted from 0
    dp_parts = {fa.KERNEL: "fwd", f"{fa.KERNEL_BWD}_dq": "bwd_dq",
                f"{fa.KERNEL_BWD}_dkv": "bwd_dkv"}
    for k in kernels:
        part = dp_parts.get(k["name"])
        if part is not None:
            k["data_parallel"] = {
                "path": ("two processes on one card, each a gloo rank training ViT-B/16 "
                         "--flash_attn at local batch 32 (chip_smoke.py phase 16b)"),
                "launches": dp["16b"]["launches"][part],
                "launches_rank1": dp["16b"]["launches_rank1"][part],
                "launches_per_step_per_rank": dp["16b"]["launches_per_step"][part]}
            if min(k["data_parallel"]["launches"], k["data_parallel"]["launches_rank1"]) <= 0:
                raise AssertionError(f"{k['name']} was not launched on the data-parallel path")
    for k in kernels:
        for path in ("int8_serving", "export", "gradcam"):
            if path in k and k[path]["launches"] <= 0:
                raise AssertionError(f"{k['name']} was not launched on the {path} path")
        for path in ("recipe", "prune", *NEW_OPTS):
            if path in k and k[path]["launches"] <= 0:
                raise AssertionError(f"{k['name']} was not launched on the {path} path")
        if k["launches"] <= 0:
            where = "in the replay" if "path" in k else "on the training path"
            raise AssertionError(f"{k['name']} was not launched {where}")
        if "at_577" in k and k["at_577"]["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the fine-tuning path")
        if "at_4097" in k and k["at_4097"]["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the high-resolution path")
    seg_summary = {k: seg[k] for k in ("losses", "miou_whole", "miou_slide", "miou_ms",
                                       "aacc_whole", "ms_step", "peak_gib", "seconds")}
    seg_summary["replay_nearest"] = seg["replay"]["nearest"]
    dp_summary = {"16a": dp["16a"], "seconds": dp["seconds"], "label": DP_LABEL,
                  **{n: {k: v for k, v in dp[n].items() if not k.startswith("launches")}
                     for n in ("16b", "16c")}}
    log(json.dumps({"kernels": kernels, "recipes": recipes, "registry": registry,
                    "lifecycle": lifecycle, "segmentation": seg_summary,
                    "data_parallel": dp_summary}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def compare_f32_forward(other: str) -> int:
    """The fp32 forward kernel of another checkout `other` (its
    csrc/flash_attention_f32.cu, built with this checkout's nvcc flags into
    its own build/kernels/ and bound through ctypes) against this checkout's,
    in this one process on one card: at each of ATTN_SHAPES both are held to
    the fp32 plain version (ATTN_F32_RTOL) on q, k, v strided out of one fused
    tensor, then timed in turns (other, this, this, other), CUDA events ms
    and device ms from traces each."""
    import ctypes

    import torch

    from imageclassification_tpu_torch.ops import _build
    from imageclassification_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    src = os.path.join(other, "imageclassification_tpu_torch", "csrc", f"{fa.KERNEL_F32}.cu")
    lib_path = os.path.join(other, "build", "kernels", f"lib{fa.KERNEL_F32}-other.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True, timeout=600)
    other_fwd = ctypes.CDLL(lib_path).flash_attention_fwd_f32
    this_fwd = fa._kernels(torch.float32)[0]
    other_fwd.argtypes, other_fwd.restype = this_fwd.argtypes, this_fwd.restype
    kernels = {"other": other_fwd, "this": this_fwd}
    for shape in ATTN_SHAPES:
        B, N, H, D = shape
        g = torch.Generator(device="cuda").manual_seed(N)
        q, k, v = torch.randn((B, N, 3, H, D), generator=g, device="cuda").unbind(2)
        args = fa._launch_args(B, N, H, D, q.get_device(), fa.check_kernel_inputs(q, k, v)[1])

        def call(fn):
            out = torch.empty((B, N, H, D), device="cuda")
            _build.raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                               args, _build.stream(q)), fa.KERNEL_F32)
            return out

        errs = {name: compare_attention(call(fn), q, k, v, ATTN_F32_RTOL)[0]
                for name, fn in kernels.items()}
        iters = max(5, min(200, int(2e9 // (B * H * N * N * D))))
        turns = []
        for name in ("other", "this", "this", "other"):
            ms = time_ms(lambda: call(kernels[name]), iters)
            dev = _device_ms(lambda: call(kernels[name]), {K1_PARTS["fwd"] + "_f32": 1},
                             events_ms=ms)
            turns.append((name, ms, dev))
        log(f"fp32 forward B,N,H,D={shape}, other checkout vs this one, in turns: " + ", ".join(
            f"{name} {ms:.4f} ms (device {dev:.4f})" for name, ms, dev in turns)
            + f"; max|d| vs fp32 plain other {errs['other']:.3e}, this {errs['this']:.3e}")
    return 0


def late_phases(num_classes: int, epochs: int) -> dict:
    """Phases 10 and 11 in a child process of this script (`--late-phases`),
    which starts with a fresh profiler: in a process that has run the
    training phases and their traces, every torch.profiler trace can come
    back without a kernel from some point on (two of six whole runs on the
    card, one at the start of phase 10, one at the end). The child writes to
    this process's output and returns phase 10's result (what the kernels
    line takes) through a file; a child that fails raises here."""
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "phase10.json")
        sys.stdout.flush()
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--late-phases",
                             str(num_classes), str(epochs), out], timeout=900).returncode
        if rc != 0:
            raise AssertionError(f"phases 10-11 (a child process) exited with {rc}")
        with open(out) as f:
            return json.load(f)


def late_main(num_classes: int, epochs: int, out: str) -> int:
    """The child of `late_phases`: phase 10 (with its kernel checks first)
    and phase 11, phase 10's result written to `out` as JSON."""
    import torch

    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        hr = hires_phase(work, num_classes, epochs, hires_checks(num_classes))
        feed_phase(work)
    with open(out, "w") as f:
        json.dump(hr, f)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--late-phases"]:
        sys.exit(late_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--recipes"]:
        sys.exit(recipes_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--registry"]:
        sys.exit(registry_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--lifecycle"]:
        sys.exit(lifecycle_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--compare-f32-forward"]:
        sys.exit(compare_f32_forward(sys.argv[2]))
    if sys.argv[1:2] == ["--segmentation"]:
        sys.exit(seg_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--distributed"]:
        sys.exit(dp_main(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
