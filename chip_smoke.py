#!/usr/bin/env python3
"""Drives the PyTorch port (``deepfakedetection_tpu_torch``) on one CUDA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

0. the card's name and power limit; build the CUDA kernels from
   ``deepfakedetection_tpu_torch/ops/csrc`` with nvcc (timed);
1. each kernel against its plain PyTorch version on the card, in bf16, at
   every EfficientNet-B3 @ 224 dispatch shape (batch 8) plus odd and ragged
   sizes, with the JAX package's test tolerances, bit-identical over two
   runs; kernel and plain times at batch 128 (CUDA events, median of 25 runs
   after warm-up); for K1 and K2 also the launch plan against the built
   library's, for K1 its device time and its SiLU's guard over every f32 it
   may keep (``k1_silu_check``), each shape's bound, what bounds it and GB/s;
   K4 (one launch a rotation) bit-identical to its plain version at every
   ``K4_CASES`` case, its plan the built library's, event and device time;
2. the full-width B3 forward with seeded weights and a head fitted to spread
   the probabilities: bf16 on the card through the kernels against bf16
   (plain versions) and float32 (unfused chain) on the CPU, logits relative
   to their scale (``check_logits``); launches per forward; forward img/s at
   batch 128 and 256, with the kernels and with the plain versions in their
   place;
3. the main path: ``orchestrate(mode="inference")`` on a YAML config over a
   seeded JPEG tree (val and test splits of a few hundred images, batch 128),
   with launch counts, the job's summary, ``metrics.jsonl`` and 16 test
   images' outputs against the CPU references checked;
4. the training path: ``orchestrate(mode="training")`` with the shipped B3
   recipe at full width (224 px, canvas 257: warmup at batch 64, fine-tune at
   32 x 4 = 128, rotation, flip, jitter, resized crop and erasing on) over a
   seeded JPEG tree, validation after each epoch, then a resume from
   ``latest.ckpt`` and ``orchestrate(mode="inference", weights: auto)``: K4
   launches once per train step, K1 and K2 in validation, finite losses,
   the checkpoints; one train step on the card against the CPU from the same
   weights and augmentation draws (f32 with TF32 off, and bf16); the train
   step's time at batch 64 and 128 (CUDA events) and the phase's img/s;
5. the FasterViT-2 eval path: ``orchestrate(mode="inference")`` on a YAML
   config over phase 3's JPEG tree at batch 256, from a seeded full-width
   ``.pth`` in the fastervit wheel's key names (so the job builds the official
   head configuration): K5 launches 13 times per forward batch, the job's
   outputs for 16 test images against the CPU; the card's bf16 logits against
   CPU bf16 and f32 runs of the same weights in both head configurations;
   forward img/s at batch 128 and 256 with K5 and with its plain version;
6. the FasterViT-2 training path: ``orchestrate(mode="training")`` with the
   shipped FasterViT recipe and transforms over phase 4's tree (tpu
   configuration: warmup at batch 64, fine-tune at 32 x 4 = 128, rotation and
   erasing off, validation after each): K5 forward and backward launches per
   step (13/0 in the warmup, 13/13 in the fine-tune), no K4, finite losses,
   the checkpoints, then ``orchestrate(mode="inference", weights: auto)``,
   which must build the tpu configuration again; one full-width step's loss
   and gradients on the card against the CPU in both head configurations
   (bf16 and f32, ``FV_STEP_BOUNDS``); the fine-tune step's time at batch 64
   and 128 with K5's backward and with its plain version in its place;
7. the EfficientFormerV2-S1 eval path: ``orchestrate(mode="inference")`` on a
   YAML config over phase 3's JPEG tree at batch 256, from a seeded
   full-width ``.pth`` in timm's key names (calibrated BatchNorms, a fitted
   head): K7 launches 4 times per forward batch, the job's outputs for 16
   test images against the CPU; the card's bf16 logits against CPU bf16 and
   f32 runs (``EFV2_GATE``); forward times at batch 128 and 256 with K7 and
   with its plain version in its place;
8. FasterViT-2 with ``DFD_FUSED_ATTN`` set (inside the phase only), every
   attention through K6: ``orchestrate(mode="inference")`` at batch 256 over
   phase 3's tree from phase 5's ``.pth`` (K6 21 launches a batch, nothing
   else), 16 test images against the CPU, the card's bf16 logits against the
   CPU's in both head configurations (``FV_GATE``), forward times at batch
   128 and 256 with K6 and with the unfused path; ``orchestrate(mode=
   "training")`` with the shipped recipe from that ``.pth`` (official) over a
   small seeded tree: K6 forward/backward 21/0 a warmup step and 21/21 a
   fine-tune step, no K5, finite losses, the checkpoints; one full-width bf16
   step on the card against the CPU in both head configurations
   (``FV_STEP_BOUNDS``); the fine-tune step's time at batch 64 and 128 with
   K6 and with the unfused path;
9. B3 with ``DFD_FUSED_MBCONV`` set (inside the phase only), its 18 residual
   blocks with an expansion through K3: the full-width forward from phase
   2's weights (K1 2, K2 2, K3 18 launches), its bf16 logits against the
   CPU's bf16 run with the switch and its f32 run (``check_logits``), forward
   img/s at batch 128 and 256 with K3 and without the switch;
   ``orchestrate(mode="inference")`` over phase 3's tree and ``.pth`` (K3 18
   launches a batch), 16 test images against the CPU, the test pass's img/s;
10. the EfficientFormerV2-S1 training path: ``orchestrate(mode="training")``
   with the shipped recipe, transforms and batch (224 px, batch 128: a
   head-only warmup, then the fine-tune over the recipe's 116 tensors) over a
   small seeded tree, validation after each: K7 0 launches in every train
   step (it has no backward; the train forward attends in plain ops) and 4 a
   val batch, finite losses, the checkpoints, then ``orchestrate(mode=
   "inference", weights: auto)``; one full-width step's loss and gradients
   on the card against the CPU (f32 with TF32 off, and bf16;
   ``EFV2_STEP_BOUNDS``); the step's time at batch 128 (CUDA events) over the
   recipe's tensors and over every tensor;
11. ``python -m deepfakedetection_tpu_torch.predict`` (its ``main``) with
   ``--json`` and with ``--json --cam`` for ``config/inference.yaml``'s three
   models from the seeded ``.pth`` files of phases 3, 5 and 7, over 8 images
   of phase 3's tree: K1 2, K2 20, K5 13 and K7 4 launches a forward (twice
   that with ``--cam``: the prediction's and the map's), the card's
   probabilities against the CPU's bf16 and f32 runs of the same CLI
   (``check_logits`` with each model's gate), the triptych PNGs at
   ``EXPORT_SCALE``, each model's Grad-CAM on the card against the CPU's
   (``CAM_GATE``) and its milliseconds an image to predict and for the map;
12. ``python -m deepfakedetection_tpu_torch.serve``'s server for the same
   three models with a top-level ensemble weighing B3 twice (``--max-batch
   32 --max-wait-ms 5 --warmup all``), in this process on a loopback port:
   ``/healthz``, 16 of phase 3's test images one at a time (12 raw JPEG
   bodies, 4 as ``image_b64``) against the CPU's bf16 and f32 runs of the
   same weights (``check_logits``, each model's gate), the ensemble entry
   the members' weighted mean; N copies of one image at once for N in 1-32,
   each row within its model's gate of bucket 1's; the launches of one
   bucket-32 step per model (K1 2 and K2 20, K5 13, K7 4; no plain version
   on the card but FasterViT's 16-token carrier-token attentions); 64 client
   threads x 16 requests, half with ``?model=`` (every one 200, ``/stats``
   counting exactly what was sent, a mean batch above 1, ``/metrics``
   agreeing; requests a second, p50/p99 latency and mean batch printed
   beside the card's name and power limit); a token-gated ``/reload`` under
   load (200, every request 200 or 503); then the CLI in a subprocess
   (``/healthz``, one ``/predict``, exit 0 on SIGTERM);
13. int8 eval: (a) the int8 depthwise kernel (``ops/int8_dw.py``, no Pallas
   source) at every shape of B3's int8 forward (batch 128) and
   EfficientFormerV2-S1's (batch 256), taken from the models: its int32
   accumulator bit-exact against the plain version, its activated bf16
   output within one bf16 step (``INT8_DW_STEP``), its time beside the plain
   version's, cuDNN's bf16 depthwise conv of the same shape and the bound;
   (b) ``orchestrate(mode="inference")`` with ``inference.precision: int8``
   on phase 3's B3 ``.pth`` and tree (calibration on 2 val batches; 26
   int8 kernel launches a batch, K1 and K2 none; ``metrics.jsonl`` says
   int8), the stem's int8 input and int32 accumulator equal to the CPU's,
   the job's probabilities against the CPU port's int8 logits with the job's
   scales (``check_logits``), and, ungated, int8 against bf16; (c) int8
   forwards of EfficientFormerV2-S1 and FasterViT-2 official (scales
   calibrated on the card; K7 4, K5 13 launches) against the CPU's int8
   under each model's gate; (d) the bench's ``main`` (``python -m
   deepfakedetection_tpu_torch.bench``) in this process for B3 eval, B3
   ``--int8`` and FasterViT-2's train step with ``--official --conv-remat
   save-conv --pad-conv-stages``, each JSON line printed and its metric's
   name checked;
14. export: ``deepfakedetection_tpu_torch.export.export_model`` for
   ``config/inference.yaml``'s three models from the seeded ``.pth`` files
   of phases 3, 5 and 7 at batch 64 on the card (each export timed); each
   ``torch.export`` program loaded by ``load_exported`` in a fresh process
   that imports no model module, run on one seeded NHWC bf16 batch: its
   probabilities bit-identical to the eager eval step's in this process, K1
   2 and K2 20, K5 13, K7 4 launches a forward and as many ``torch.ops.dfd``
   nodes, no plain version called; the loaded and the eager forward's
   CUDA-event ms at batch 64; the µs a call of the operator route against
   the direct ctypes launch and a toy operation's through both registration
   routes (``profile_dispatch``);
15. tar shards and the last training options: (a) phase 3's and phase 8's
   JPEG trees packed into tar shards by ``python -m
   deepfakedetection_tpu_torch.data.shards`` in a subprocess (each split
   scanning to the folder's samples); ``orchestrate(mode="inference")`` for
   B3 over phase 3's shards from its ``.pth``: K1 2 and K2 20 launches a
   batch, the test probabilities bit-identical to phase 3's over the folder
   tree, the job's img/s beside phase 3's and the loader alone over both
   layouts in turns; (b) ``orchestrate(mode="training")`` for FasterViT-2
   over phase 8's shards from phase 5's ``.pth`` (official) with
   ``training.remat`` and ``training.async_checkpoint``: K5 forward/backward
   26/0 a warmup step (the recompute reruns the forward for the head's saved
   input) and 26/13 a fine-tune step, finite losses, ``latest.ckpt``,
   ``best.ckpt`` and the ``.pth``, ``latest.ckpt``'s model equal to the live
   model at the run's end; its resume for epoch 2 with ``profile_dir`` as
   well (the profile of a short run: the trace grows with every step), whose
   TensorBoard trace parses as JSON and names K5's forward and backward
   kernels; ``orchestrate(mode="inference", weights: auto)`` over the
   shards; (c) one fine-tune step at batch 128 from the same weights, batch
   and generator seed for FasterViT-2 official plain, with ``remat`` and
   with ``conv_remat`` "full" and "save-conv", and for B3 plain and with
   ``remat`` after its recipe's augmentation (K4 once a step): the loss, the
   running statistics and every gradient bit-identical to the plain step's
   (a recompute that draws other masks or feeds the backward another
   forward's tensors moves the gradients);
   (d) each FasterViT-2 variant's step time (CUDA events) and peak memory,
   printed beside the card's name and power limit;
16. data parallel on a world of one over NCCL (``init_process_group`` on a
   free local port; NCCL refuses two ranks on one card): one full-width B3
   step with mixup and class weights through the ranked path against the
   same step without a process group on the same batch and weights (f32 with
   TF32 off and bf16, ``STEP_BOUNDS``; the ranked steps must make their
   all-reduces and all-gathers), then ``orchestrate(mode="training")`` with
   ``training.async_checkpoint`` and mixup over a small seeded tree (K4 once
   a step, K1 and K2 in validation), its resume for epoch 2 (a complete
   ``latest.ckpt``, no ``.tmp`` left) and ``orchestrate(mode="inference")``,
   whose rows through ``allgather_examples`` equal those of a run after the
   group is gone; the bf16 step's CUDA-event time at batch 128 plain,
   ranked and plain again, the NCCL all-reduce of B3's gradient buffer and
   one step's random draws for one card's rows and for an 8-card rank's,
   beside the card's name and power limit. ``destroy_process_group`` runs in
   a ``finally``.

Phase 1 also holds K5 (window attention) against its plain version at the
four shapes of the FasterViT-2 path at batch 256, and K5's backward at the
four fine-tune shapes at batch 128 (each plus odd sizes with many windows a
block, an unaligned view and a repeat that must be bit-identical; each
launch plan the built kernel's), with their times, the plain versions' and
``torch.nn.functional.scaled_dot_product_attention``'s on the same q, k, v
and bias (forward, or its backward alone after one forward, ``grad_ms``),
each with the device time of the kernels a call launches beside the event
time (SDPA is a yardstick the port never calls), and K7 (talking-head
attention) at EfficientFormerV2-S1's shape at batch 256 and at ragged sizes
(every kind of launch plan, each the built kernel's), bit-identical run to
run, with its event and device time (no PyTorch call computes it: its
library time is none), and K6 (the fused attention
sub-block) at the six FasterViT-2 attentions of both head configurations,
forward at batch 256 and backward at 128 (plus odd sizes and each
direction's tails: partial window and head groups, empty cluster blocks; the
backward's six gradients bit-identical over two runs; each direction's launch
plan the built kernel's; the backward's per-kernel device split logged),
with its times, its plain version's,
the port's unfused path's (Linear, K5, Linear) and
``torch.nn.functional.multi_head_attention_forward``'s in bf16 (a yardstick
the port never calls), and K3 (the whole MBConv+SE block) at B3's six K3
shapes (batch 8) and odd sizes (every projection plan), within two bf16
steps of the output's scale, bit-identical run to run and through an MBConv
block built with the switch (a warm forward launches no packing kernel), the
plan the built kernel's, with its event and device time, its plain version's
and the unfused route's (K2, SE, project ConvBN, residual add) at batch 128
(no PyTorch call computes the block: its library time is none). Each kernel's bound is the larger of its bytes over the
HBM rate and its operations over the card's peak rate for their type
(``bound``).

The second-to-last lines are a JSON object with the kernels' numbers and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/chip_smoke.json``.
Without a CUDA card, or outside the repository, it exits non-zero at once.
Device times come from ``torch.profiler`` (``kernel_split``), which profiles
a call once more when it records no device time or lacks a kernel the port's
wrapper launches, and raises if the second take does too.
Run with no arguments it does all of the above; ``--parent DIR`` only adds
phase 1's comparison with another checkout's K1 at B3's two stage-0 shapes
(``k1_parent``: in turns, by events and device time; y bit-identical there and
at every ``K1_ODD`` size), its K4 at the B3 fine-tune canvas (``k4_parent``:
in turns; outputs bit-identical at every ``K4_CASES`` case), its K5 forward
and backward, in turns at the four eval and the four fine-tune shapes
(``k5_parent``), its K7 at EfficientFormerV2-S1's shape (``k7_parent``: in
turns, by events and device time; outputs bit-identical there and at every
``K7_ODD`` size), and its K3 at B3's six K3 shapes (``k3_parent``); and phase
14 runs that checkout's eager eval steps of the three models on the same
batch in a process of its own (its kernel library this tree's when the
sources are the same), between two timings of this tree's: the
probabilities must be bit-identical.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# B3 @ 224 dispatch shapes (H, W, C[, Ce], k) and how many blocks use each
K1_SHAPES = [((112, 112, 40, 3), 1), ((112, 112, 24, 3), 1)]
K2_SHAPES = [
    ((56, 56, 32, 192, 3), 2),
    ((28, 28, 48, 288, 5), 2),
    ((14, 14, 96, 576, 3), 4),
    ((14, 14, 96, 576, 5), 1),
    ((14, 14, 136, 816, 5), 4),
    ((7, 7, 232, 1392, 5), 5),
    ((7, 7, 232, 1392, 3), 1),
    ((7, 7, 384, 2304, 3), 1),
]
# odd sizes: one tile smaller than the halo, ragged tiles and channel blocks, and
# channel counts off the kernels' vector widths (their one-channel load paths)
K1_ODD = [(9, 11, 128, 5), (37, 45, 72, 3), (13, 10, 20, 5)]
K2_ODD = [(9, 11, 32, 192, 5), (30, 33, 24, 144, 5), (1, 1, 8, 48, 5), (13, 10, 20, 42, 3)]
K1_TOL = {"y": (3e-2, 3e-2), "pool": (2e-3, 2e-3)}  # (atol, rtol)
SPLITS = {"val": 256, "test": 1280}  # phase 3 images per split
EVAL_BATCH = 128
EVAL_TF = {"ensure_rgb": True, "val_resize": True, "val_center_crop": True}
K2_TOL = {"y": (5e-2, 5e-2), "pool": (2e-2, 5e-2)}
# K4 cases (B, H, W, max_theta, largest |angle|): the B3 fine-tune canvas at the
# recipe's 10 degrees (timed), the 13.7-degree shear limit, the kernel's 0.45 rad
# limit, odd sizes and a zero angle; one bf16 step per pass on [0, 1] images
K4_CASES = [(128, 257, 257, 0.17453, 0.17453), (16, 257, 257, 0.23911, 0.23911),
            (16, 96, 96, 0.45, 0.45), (8, 37, 45, 0.2, 0.2), (8, 45, 37, 0.45, 0.45),
            (8, 33, 31, 0.2, 0.0)]
K4_TOL = 3 * 2.0**-8
TRAIN_SPLITS = {"train": 1024, "val": 128, "test": 128}  # phase 4 images per split
TRAIN_TF = {"ensure_rgb": True, "train_random_resized_crop": True,
            "train_random_horizontal_flip": True, "train_random_rotation": True,
            "train_color_jitter": True, "train_random_erasing": True}
# K5 at the FasterViT-2 eval shapes, batch 256: (config, windows, N, C, heads,
# launches per forward): stage 3's 4 windows of 4 + 49 tokens, stage 4's one
# window of 49, in each head configuration
K5_SHAPES = [("official", 1024, 53, 384, 8, 8), ("official", 256, 49, 768, 16, 5),
             ("tpu", 1024, 53, 384, 3, 8), ("tpu", 256, 49, 768, 6, 5)]
# odd sizes (windows, N, heads, d): the carrier-token attention's 16 tokens, one
# token, ragged tiles past 64 tokens, head_dims off the 16-byte copies; then
# many windows a block in every pipeline the plan picks: warps without a query
# tile (N <= 48), two tiles a warp (N > 64), element-by-element copies (d 100,
# d 4), two and four warp groups, rings of 4, 3, 2 and 1 slots a group
K5_ODD = [(8, 16, 8, 48), (8, 1, 2, 16), (8, 100, 2, 64), (8, 128, 1, 128), (8, 53, 8, 8),
          (8, 37, 3, 100), (8, 20, 2, 4), (512, 37, 3, 100), (512, 16, 8, 48),
          (1024, 33, 4, 64), (2048, 20, 2, 4), (512, 80, 2, 16), (512, 100, 4, 64),
          (1024, 128, 2, 32), (192, 128, 8, 128)]
# K5's backward at the FasterViT-2 fine-tune shapes, batch 128: (config,
# windows, N, C, heads, launches per step)
K5_BWD_SHAPES = [("official", 512, 53, 384, 8, 8), ("official", 128, 49, 768, 16, 5),
                 ("tpu", 512, 53, 384, 3, 8), ("tpu", 128, 49, 768, 6, 5)]
# odd sizes (windows, N, heads, d): the carrier-token attention's 16 tokens, one
# token, ragged tiles past 64 tokens, head_dims off the 16-byte loads; then
# many windows a block in every pipeline the plan picks: row warps without a
# tile (N <= 48), the shared dbias sum past 64 tokens, the 2-slot / 1-buffer
# and 1-slot / 1-buffer plans and the element-by-element copies
K5_BWD_ODD = [(8, 16, 8, 48), (8, 1, 2, 16), (8, 100, 2, 64), (8, 128, 1, 64), (8, 53, 8, 8),
              (8, 37, 3, 100), (8, 20, 2, 4), (512, 37, 3, 100), (512, 16, 8, 48),
              (512, 33, 4, 64), (512, 20, 2, 4), (256, 100, 2, 64), (256, 128, 1, 80),
              (512, 128, 2, 32)]
# dbias against the plain version, max|d| over its scale: both sum ds over the
# windows in f32, in different orders (dbias summed over no window: ~1)
K5_BWD_DBIAS_TOL = 1e-3
FV = "faster_vit_2_224"
FV_BATCH = 256
# K7 at EfficientFormerV2-S1's eval shape, batch 256: (B, N, heads, d, dv,
# launches per forward): the 7x7 tokens of the last two blocks of stages 3
# and 4; then ragged and small sizes (the narrow test model's 16 tokens, one
# token, N past 64, value widths off the 16-byte loads) that reach every kind
# of plan (ops/attn4d.plan): a whole image a row group, several groups (one
# tile each at N 128), rings deeper and shallower than the heads, and
# batches past the SMs whose last block takes fewer images
K7_SHAPES = [(256, 49, 8, 32, 128, 4)]
K7_ODD = [(8, 25, 4, 16, 64), (8, 16, 8, 32, 128), (8, 1, 2, 16, 8), (8, 100, 3, 32, 40),
          (8, 128, 8, 16, 16), (8, 64, 8, 32, 128), (133, 49, 8, 32, 128), (8, 17, 5, 16, 24),
          (8, 48, 6, 32, 64), (8, 65, 8, 32, 128), (8, 128, 8, 32, 128), (20, 49, 1, 16, 8),
          (200, 128, 7, 32, 72)]
EF = "efficientformerv2_s1"
EF_BATCH = 256
# K6 (the fused attention sub-block, DFD_FUSED_ATTN) at the FasterViT-2 eval
# shapes, batch 256: (config, windows, N, C, heads, launches per forward):
# stage 3's windows of 4 + 49 tokens, its carrier tokens (16 an image), stage
# 4's one window of 49, in each head configuration; its backward at the
# fine-tune batch 128
K6_SHAPES = [("official", 1024, 53, 384, 8, 8), ("official", 256, 16, 384, 8, 8),
             ("official", 256, 49, 768, 16, 5), ("tpu", 1024, 53, 384, 3, 8),
             ("tpu", 256, 16, 384, 3, 8), ("tpu", 256, 49, 768, 6, 5)]
K6_BWD_SHAPES = [(config, B // 2, N, C, h, n) for config, B, N, C, h, n in K6_SHAPES]
# odd sizes (windows, N, heads, d): one token, N past 64 and at 128, a head_dim
# and C off the 16-byte loads (C 60), C off the 4-byte pairs (d 63, C 126) and
# odd (C 123)
K6_ODD = [(8, 1, 2, 16), (8, 100, 2, 64), (8, 128, 2, 64), (8, 53, 3, 20), (8, 20, 2, 63),
          (8, 33, 3, 41)]
# the forward's last, partial window group and the cluster's empty block
# (windows, N, heads, d): one window, three, 1,023 (two a block at N 53), and
# 250 carrier-token windows (four a block at N 16)
K6_TAILS = [(1, 53, 8, 48), (3, 53, 8, 48), (1023, 53, 8, 48), (250, 16, 8, 48)]
# the backward's tails (windows, N, heads, d): a cluster's empty block (1, 3,
# 511 and 127 windows), the last window group partial (250 carrier-token
# windows, four a block), and a partial last head group (3 heads in groups of
# 2, the tpu configuration's stage 3)
K6_BWD_TAILS = [(1, 53, 8, 48), (3, 53, 8, 48), (511, 53, 8, 48), (127, 49, 16, 48),
                (250, 16, 8, 48), (65, 53, 3, 128)]
BWD_ROUNDS = 3  # rounds of each backward yardstick, all logged
K6_GRADS = ("dx", "dwqkv", "dbqkv", "dbias", "dwproj", "dbproj")
# K6's f32 gradients against the plain backward, max|d| over each one's scale:
# both sum over every row of every window in f32, in different orders, from
# bf16 dqkv and ctx that may each sit a rounding step apart
K6_BWD_TOL = 1e-2
K6_LAUNCHES = 21  # per FasterViT-2 forward with DFD_FUSED_ATTN: 8 + 8 + 5
# device kernels every K6 backward call launches, by the names the profiler records
K6_BWD_KERNELS = ("window_bwd_kernel", "sum_partials_kernel")
FV_FUSED_SPLITS = {"train": 256, "val": 64, "test": 64}  # phase 8's training tree
# K3 (the whole MBConv+SE block, DFD_FUSED_MBCONV) at B3 @ 224's residual
# blocks with an expansion: (H, W, C, k, blocks), Cmid 6C, Cse C // 4 (their
# projection plans: wgmma BN 32, 48, 128, 144, 128 x 2 and 192 x 2); then odd
# sizes (H, W, C, k) at batch 8 that with them cover every projection plan
# (BN 64 at C 64, 192 x 1 at C 192, 128 x 2 at C 200, the mma.sync kernel
# where Cmid % 8 != 0: C 22 and 13): H off the tiles, fewer rows than a tile
# (a 1 x 1 map), Cmid under one 64-channel stage (C 4), Cse 1, and C 4, 13,
# 20 and 22 off the 16-byte loads and 4-byte pairs (the kernels'
# one-element paths)
K3_SHAPES = [(56, 56, 32, 3, 2), (28, 28, 48, 5, 2), (14, 14, 96, 3, 4), (14, 14, 136, 5, 4),
             (7, 7, 232, 5, 5), (7, 7, 384, 3, 1)]
K3_ODD = [(10, 12, 24, 5), (1, 1, 16, 5), (6, 6, 4, 3), (9, 11, 22, 3), (5, 7, 13, 5),
          (13, 16, 64, 3), (9, 10, 192, 3), (7, 9, 200, 5), (30, 30, 20, 5)]
K3_LAUNCHES = {"k1": 2, "k2": 2, "k3": 18}  # per B3 forward with DFD_FUSED_MBCONV
# the H100 SXM's published rates (NVIDIA's data sheet): HBM bytes/s, dense
# tensor-core bf16 and non-tensor f32 operations/s
HBM_RATE, BF16_RATE, F32_RATE = 3.35e12, 989e12, 67e12


JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax")


def reference_imports(source: str) -> list[str]:
    """The modules of JAX or of the JAX package (``deepfakedetection_tpu``)
    that the Python ``source`` imports by name. Neither this script nor any
    module of the port may import one."""
    import ast

    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.append(node.module)
    banned = JAX_MODULES + ("deepfakedetection_tpu",)
    return sorted(n for n in names if n.split(".")[0] in banned)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Prints a line; a phase's first line with the seconds since the start."""
    if msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _T0:.0f} s in]"
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_times(fn, runs: int, warmup: int = 3) -> list[float]:
    """Per-call device times in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def spread(ts: list[float]) -> dict[str, float]:
    q = statistics.quantiles(ts, n=4)
    return {"median": statistics.median(ts), "q1": q[0], "q3": q[2], "min": min(ts),
            "max": max(ts), "n": len(ts)}


def bound(nbytes: float, ops: dict[str, float]) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over their peak rates, ``ops`` given
    as {"bf16": tensor-core operations, "f32": CUDA-core operations}."""
    t_bytes = nbytes / HBM_RATE
    t_ops = ops.get("bf16", 0.0) / BF16_RATE + ops.get("f32", 0.0) / F32_RATE
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def add_bounds(rows) -> tuple[float, str]:
    """The sum of (count, (ms, by)) rows' bounds, bound by the larger part."""
    total = sum(n * ms for n, (ms, _) in rows)
    by_bytes = sum(n * ms for n, (ms, by) in rows if by == "bytes")
    return total, "bytes" if 2 * by_bytes >= total else "operations"


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")
    return err


def k1_inputs(B, H, W, C, k, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g).to(torch.bfloat16)
    w = torch.randn(k, k, C, generator=g) * (1.0 / k)
    b = torch.randn(C, generator=g) * 0.1
    return [t.to(device) for t in (x, w, b)]


def k2_inputs(B, H, W, Cin, Ce, k, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, Cin, generator=g).to(torch.bfloat16)
    wexp = torch.randn(Cin, Ce, generator=g) * Cin ** -0.5
    bexp = torch.randn(Ce, generator=g) * 0.1
    wdw = torch.randn(k, k, Ce, generator=g) * (1.0 / k)
    bdw = torch.randn(Ce, generator=g) * 0.1
    return [t.to(device) for t in (x, wexp, bexp, wdw, bdw)]


def phase1(device, report, parent: str | None = None):
    """Kernels against their plain versions on the card. With ``parent``
    (another checkout's directory), K5's forward and backward are also timed
    against that checkout's in turns at the eval and fine-tune shapes
    (``k5_parent``)."""
    import torch

    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.ops import expand_dw as k2

    kernels = {}
    for name, mod, shapes, odd, tol, inputs, kw in (
        ("depthwise_silu_pool", k1, K1_SHAPES, K1_ODD, K1_TOL, k1_inputs, "k"),
        ("expand_dw_silu_pool", k2, K2_SHAPES, K2_ODD, K2_TOL, k2_inputs, "kernel"),
    ):
        fused, plain = getattr(mod, name), getattr(mod, name + "_plain")
        rows, worst, ms, plain_ms, bounds, device_ms = [], 0.0, 0.0, 0.0, [], 0.0
        cases = [(s, n) for s, n in shapes] + [(s, 0) for s in odd]
        for i, (shape, count) in enumerate(cases):
            k = shape[-1]
            args = inputs(8, *shape, seed=100 + i, device=device)
            y, pool = fused(*args, **{kw: k})
            again = fused(*args, **{kw: k})
            if not (torch.equal(again[0], y) and torch.equal(again[1], pool)):
                raise AssertionError(f"{name}{shape}: two runs differ")
            ry, rpool = plain(*args, **{kw: k})
            ey = check_close(f"{name}{shape} y", y, ry, *tol["y"])
            ep = check_close(f"{name}{shape} pool", pool, rpool, *tol["pool"])
            worst = max(worst, ey)
            row = {"shape": shape, "blocks_in_b3": count, "max_abs_err_y": ey,
                   "max_abs_err_pool": ep}
            sms = k2.sm_count(device)
            if mod is k2:  # the launch plan is the one the built kernel computes
                for B in (8, 128):
                    want = k2.plan(*shape, B, sms)
                    if want != k2.kernel_plan(B, *shape, sms):
                        raise AssertionError(f"{name}{shape}: plan {want} is not the kernel's")
                row["plan"] = vars(k2.plan(*shape, 128, sms))
            else:
                for B in (8, 128):
                    want = k1.plan(B, *shape, sms)
                    if want != k1.kernel_plan(B, *shape, sms):
                        raise AssertionError(f"{name}{shape}: plan {want} is not the kernel's")
                row["plan"] = vars(k1.plan(128, *shape, sms))
            if count:  # time at the eval batch (128) for the B3 shapes
                big = inputs(128, *shape, seed=200 + i, device=device)
                b_ms, b_by = kernel_bound(name, 128, shape)
                bounds.append((count, (b_ms, b_by)))
                t_k = spread(cuda_times(lambda: fused(*big, **{kw: k}), runs=25))
                t_p = spread(cuda_times(lambda: plain(*big, **{kw: k}), runs=25))
                row.update(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by)
                if mod is k1:  # device time: the one kernel a call launches
                    row["device_ms"] = launch_ms(lambda: fused(*big, **{kw: k}),
                                                 ("depthwise_silu_pool_kernel",), calls=10)
                    device_ms += count * row["device_ms"]
                if mod is k2:
                    row["gb_per_s"] = k2_bytes(128, shape) / t_k["median"] / 1e6
                ms += count * t_k["median"]
                plain_ms += count * t_p["median"]
            rows.append(row)
            log(f"  {name} {shape}: max|dy|={ey:.3e} max|dpool|={ep:.3e}, bit-identical over two "
                "runs" + (f"; kernel {row['ms']['median']:.4f} ms"
                          + (f" (device {row['device_ms']:.4f})" if "device_ms" in row else "")
                          + " plain "
                          f"{row['plain_ms']['median']:.4f} ms (batch 128), bound "
                          f"{row['bound_ms']:.4f} ms ({row['bound_by']})" if count else "")
                + (f", {row['gb_per_s']:.0f} GB/s, plan {row['plan']}" if "gb_per_s" in row
                   else ""))
        bound_ms, bound_by = add_bounds(bounds)
        kernels[name] = {"rows": rows, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        if mod is k1:
            kernels[name]["device_ms"] = device_ms
            kernels[name]["silu_check"] = k1_silu_check(device)
        log(f"  {name}: per B3 forward at batch 128 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" bound {bound_ms:.4f} ms ({bound_by})")
    kernels["depthwise_silu_pool"]["parent"] = k1_parent(parent)
    kernels["rotate_batch"] = phase1_k4(device)
    kernels["rotate_batch"]["parent"] = k4_parent(parent)
    kernels["window_attention"] = phase1_k5(device)
    kernels["window_attention"]["parent"] = k5_parent(parent, fwd=True)
    kernels["window_attention_bwd"] = phase1_k5_bwd(device)
    kernels["window_attention_bwd"]["parent"] = k5_parent(parent, fwd=False)
    kernels["attn4d"] = phase1_k7(device)
    kernels["attn4d"]["parent"] = k7_parent(parent)
    kernels["attn_subblock"], kernels["attn_subblock_bwd"] = phase1_k6(device)
    kernels["fused_mbconv_se"] = phase1_k3(device)
    kernels["fused_mbconv_se"]["parent"] = k3_parent(parent)
    report["phase1"] = kernels
    return kernels


def k1_silu_check(device) -> dict:
    """K1's SiLU keeps the fast quotient only where it rounds to the precise
    one's bf16: the kernel's own check over every f32 its fast path may keep
    (``dfd_silu_check``) must count no mismatch."""
    import torch

    from deepfakedetection_tpu_torch.ops import build

    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        build.check(build.library().dfd_silu_check(
            counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream), "silu_check")
    bad, slow = (int(v) for v in counts.cpu())
    log(f"  depthwise_silu_pool SiLU over every f32 >= -16: {bad} fast quotients "
        f"round to another bf16 than the precise one's; {slow} inputs take the precise one")
    if bad:
        raise AssertionError(f"depthwise_silu_pool: the SiLU's guard lets {bad} values through")
    return {"mismatches": bad, "precise": slow}


def k1_parent(parent: str | None) -> dict | None:
    """K1 of the checkout in ``parent`` against this one
    (``profile_k1.compare``): at ``K1_SHAPES`` both times in turns, event
    and device, and their sums per B3 forward; at every shape and ``K1_ODD``
    y must be bit-identical and the pools within 1e-5 of the pool's scale
    (raises otherwise). None without ``parent``."""
    if parent is None:
        log("  depthwise_silu_pool: the parent's kernel not measured (no --parent)")
        return None
    from deepfakedetection_tpu_torch import profile_k1

    rows = profile_k1.compare(parent)
    differ = [r["shape"] for r in rows if not r["y_bit_identical"] or r["pool_rel_diff"] > 1e-5]
    if differ:
        raise AssertionError(f"depthwise_silu_pool: not the parent's y and pool at {differ}")
    sums = {key: 0.0 for key in ("this_ms", "other_ms", "this_device_ms", "other_device_ms")}
    for r, (_, count) in zip(rows, K1_SHAPES):
        for key in sums:
            sums[key] += count * r[key]
    log(f"  depthwise_silu_pool per B3 forward at batch 128 (2 launches), in turns with "
        f"{parent}'s: this {sums['this_ms']:.4f} ms (device {sums['this_device_ms']:.4f}), the "
        f"parent's {sums['other_ms']:.4f} ms (device {sums['other_device_ms']:.4f}); device ratio "
        f"{sums['this_device_ms'] / sums['other_device_ms']:.3f}; y bit-identical at every shape")
    return {"tree": parent, "rows": rows, "per_forward": sums}


def k5_parent(parent: str | None, fwd: bool) -> dict | None:
    """K5's forward (``fwd``) or backward of the checkout in ``parent``
    against this one, in turns (``profile_k5.compare_fwd`` at the four eval
    shapes, ``profile_k5.compare`` at the four fine-tune shapes): per shape
    both times, event and device, and whether the outputs are bit-identical,
    and the sums per forward or fine-tune step of each head configuration.
    None without ``parent``."""
    name = "window_attention" if fwd else "window_attention_bwd"
    if parent is None:
        log(f"  {name}: the parent's kernel not measured (no --parent)")
        return None
    from deepfakedetection_tpu_torch import profile_k5

    rows = profile_k5.compare_fwd(parent) if fwd else profile_k5.compare(parent)
    shapes, unit = ((K5_SHAPES, f"forward at batch {FV_BATCH}") if fwd
                    else (K5_BWD_SHAPES, "fine-tune step at batch 128"))
    sums = {}
    for r, shape in zip(rows, shapes):
        config, count = shape[0], shape[5]
        agg = sums.setdefault(config, {key: 0.0 for key in ("this_ms", "other_ms",
                                                            "this_device_ms",
                                                            "other_device_ms")})
        for key in agg:
            agg[key] += count * r[key]
        if r["this_device_ms"] >= r["other_device_ms"] or r["this_ms"] >= r["other_ms"]:
            log(f"  {name} {shape[:5]}: NOT faster than the parent's ({r['this_ms']:.4f} against "
                f"{r['other_ms']:.4f} ms, device {r['this_device_ms']:.4f} against "
                f"{r['other_device_ms']:.4f})")
    for config, agg in sums.items():
        log(f"  {name} per FasterViT-2 {config} {unit}, in turns with {parent}'s: this "
            f"{agg['this_ms']:.4f} ms (device {agg['this_device_ms']:.4f}), the parent's "
            f"{agg['other_ms']:.4f} ms (device {agg['other_device_ms']:.4f})")
    return {"tree": parent, "rows": rows, "per_pass": sums}


def kernel_bound(name: str, B: int, shape) -> tuple[float, str]:
    """K1's or K2's bound at batch B: x read, weights read, y and the pool
    written; the taps on the CUDA cores in f32, K2's expand on the tensor
    cores."""
    if name == "depthwise_silu_pool":
        H, W, C, k = shape
        px = B * H * W
        return bound(px * C * 2 * 2 + (k * k + 1) * C * 4 + B * C * 4,
                     {"f32": 2 * k * k * px * C})
    H, W, Cin, Ce, k = shape
    px = B * H * W
    return bound(k2_bytes(B, shape), {"bf16": 2 * px * Cin * Ce, "f32": 2 * k * k * px * Ce})


def k2_bytes(B: int, shape) -> int:
    """The bytes K2 must move at batch B: x read, its f32 weights read, y
    and the pool written."""
    H, W, Cin, Ce, k = shape
    return B * H * W * (Cin + Ce) * 2 + (Cin * Ce + (k * k + 2) * Ce) * 4 + B * Ce * 4


def k5_bound(B: int, N: int, C: int, h: int) -> tuple[float, str]:
    """qkv and the bias read, the output written; q k^T and p v on the tensor
    cores."""
    return bound(k5_bytes(B, N, C, h), {"bf16": 4 * B * N * N * C})


def sdpa_ms(qkv, bias, h: int, scale: float) -> tuple[float | None, float | None]:
    """``scaled_dot_product_attention`` on the same q, k, v (strided views of
    qkv) and bias (in bf16, as it takes a mask of the inputs' type): the
    library yardstick, (CUDA-event ms a call, median of 25; the device time of
    the kernels a call launches, ``kernel_split`` over 25 calls). (None, None),
    with the reason logged, when it refuses them."""
    import torch
    import torch.nn.functional as F

    B, N, C3 = qkv.shape
    q, k, v = qkv.view(B, N, 3, h, C3 // 3 // h).permute(2, 0, 3, 1, 4)
    mask = bias.to(torch.bfloat16)[None]

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

    try:
        return (statistics.median(cuda_times(call, runs=25)),
                sum(kernel_split(call, calls=25)[0].values()))
    except RuntimeError as exc:
        log(f"  scaled_dot_product_attention refused {tuple(qkv.shape)}: {exc}")
        return None, None


def k5_inputs(shape, seed: int, device):
    """(qkv, bias, heads, scale) at a ``K5_SHAPES`` row, as phase 1 makes them."""
    import torch

    _, B, N, C, h, _ = shape
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * C, generator=g).to(torch.bfloat16).to(device)
    bias = torch.randn(h, N, N, generator=g).to(device)
    return qkv, bias, h, (C // h) ** -0.5


def k5_bytes(B: int, N: int, C: int, h: int) -> int:
    """The bytes K5's forward must move: qkv and the bias read, the output
    written."""
    return B * N * 4 * C * 2 + h * N * N * 4


def phase1_k5(device) -> dict:
    """K5 against its plain version at the four FasterViT-2 shapes (batch
    256) and ``K5_ODD``, within two bf16 steps of the output's scale (both
    round the probabilities and the output once, from f32 sums in different
    orders), bit-identical over two runs, its launch plan the built kernel's;
    an unaligned view of qkv (the element-by-element copies). Kernel, plain
    and library times (CUDA events, and the device time of the kernels a call
    launches), summed per forward of each head configuration."""
    import torch

    from deepfakedetection_tpu_torch.ops import window_attn as k5

    sms = k5.sm_count(device)

    def check(label, qkv, bias, h, scale):
        B, N, C3 = qkv.shape
        d = C3 // 3 // h
        plan = k5.fwd_plan(B, N, h, d, sms)
        if plan != k5.kernel_fwd_plan(B, N, h, d, sms):
            raise AssertionError(f"window_attention {label}: plan {plan} is not the kernel's "
                                 f"{k5.kernel_fwd_plan(B, N, h, d, sms)}")
        before = k5.window_attention.launches
        out = k5.window_attention(qkv, bias, num_heads=h, scale=scale)
        torch.cuda.synchronize()
        if k5.window_attention.launches != before + 1:
            raise AssertionError("window_attention did not launch its kernel")
        again = k5.window_attention(qkv, bias, num_heads=h, scale=scale)
        torch.cuda.synchronize()
        if not torch.equal(again, out):
            raise AssertionError(f"window_attention {label}: two runs differ")
        ref = k5.window_attention_plain(qkv, bias, num_heads=h, scale=scale)
        tol = two_steps(ref)
        return check_close(f"window_attention {label}", out, ref, tol, 0.0), tol, plan

    rows, worst, per = [], 0.0, {}
    for i, shape in enumerate(K5_SHAPES):
        config, B, N, C, h, count = shape
        qkv, bias, h, scale = k5_inputs(shape, 400 + i, device)
        err, tol, plan = check(f"{config} {(B, N, C, h)}", qkv, bias, h, scale)
        worst = max(worst, err)

        def call():
            return k5.window_attention(qkv, bias, num_heads=h, scale=scale)

        t_k = spread(cuda_times(call, runs=25))
        dev = sum(kernel_split(call, calls=25, expect=k5.FWD_KERNELS)[0].values())
        t_p = spread(cuda_times(
            lambda: k5.window_attention_plain(qkv, bias, num_heads=h, scale=scale), runs=10))
        lib, lib_dev = sdpa_ms(qkv, bias, h, scale)
        b_ms, b_by = k5_bound(B, N, C, h)
        rows.append({"config": config, "shape": (B, N, C, h), "launches_per_forward": count,
                     "max_abs_err": err, "tolerance": tol, "ms": t_k, "device_ms": dev,
                     "plain_ms": t_p, "library_ms": lib, "library_device_ms": lib_dev,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "gb_per_s": k5_bytes(B, N, C, h) / dev / 1e6, "plan": plan._asdict()})
        agg = per.setdefault(config, {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                                      "library_ms": 0.0, "library_device_ms": 0.0, "bounds": []})
        agg["ms"] += count * t_k["median"]
        agg["device_ms"] += count * dev
        agg["plain_ms"] += count * t_p["median"]
        for key, v in (("library_ms", lib), ("library_device_ms", lib_dev)):
            agg[key] = None if v is None or agg[key] is None else agg[key] + count * v
        agg["bounds"].append((count, (b_ms, b_by)))
        log(f"  window_attention {config} windows {B} N {N} C {C} heads {h}: max|d|={err:.3e} "
            f"(tol {tol:.3e}), bit-identical over two runs; kernel {t_k['median']:.4f} ms "
            f"(device {dev:.4f}), plain {t_p['median']:.4f} ms, sdpa "
            f"{lib if lib is None else round(lib, 4)} ms (device "
            f"{lib_dev if lib_dev is None else round(lib_dev, 4)}), bound {b_ms:.4f} ms "
            f"({b_by}), {rows[-1]['gb_per_s']:.0f} GB/s by device time, plan {rows[-1]['plan']}")
    for B, N, h, d in K5_ODD:
        g = torch.Generator().manual_seed(700 + N * d + h)
        qkv = torch.randn(B, N, 3 * h * d, generator=g).to(torch.bfloat16).to(device)
        bias = torch.randn(h, N, N, generator=g).to(device)
        err, tol, plan = check(f"{(B, N, h, d)}", qkv, bias, h, d**-0.5)
        rows.append({"shape": (B, N, h * d, h), "max_abs_err": err, "tolerance": tol,
                     "plan": plan._asdict()})
        log(f"  window_attention odd {(B, N, h, d)}: max|d|={err:.3e} (tol {tol:.3e}), "
            f"bit-identical over two runs, plan {plan._asdict()}")
    # an unaligned strided view of qkv, many windows a block: the element copies
    g = torch.Generator().manual_seed(8)
    qkv = torch.randn(512, 53, 3 * 384, generator=g).to(torch.bfloat16).to(device)
    wide = torch.zeros(512, 53, 3 * 384 + 2, dtype=torch.bfloat16, device=device)
    wide[..., 1:-1] = qkv
    bias = torch.randn(8, 53, 53, generator=g).to(device)
    err, tol, _ = check("unaligned view", wide[..., 1:-1], bias, 8, 48**-0.5)
    log(f"  window_attention unaligned view (512, 53, 8, 48): max|d|={err:.3e} (tol {tol:.3e}), "
        "bit-identical over two runs")
    for config, agg in per.items():
        agg["bound_ms"], agg["bound_by"] = add_bounds(agg.pop("bounds"))
        log(f"  window_attention per FasterViT-2 {config} forward at batch {FV_BATCH} (13 "
            f"launches): kernel {agg['ms']:.4f} ms (device {agg['device_ms']:.4f}), plain "
            f"{agg['plain_ms']:.4f} ms, sdpa {agg['library_ms']} ms (device "
            f"{agg['library_device_ms']}), bound {agg['bound_ms']:.4f} ms")
        if agg["library_device_ms"] is not None and agg["device_ms"] >= agg["library_device_ms"]:
            log(f"  window_attention per FasterViT-2 {config} forward: NOT below SDPA's device "
                "time")
    return {"rows": rows, "max_abs_err": worst, "per_forward": per, **per["official"]}


def k5_bwd_bytes(B: int, N: int, C: int, h: int) -> int:
    """The bytes K5's backward must move: qkv, dout and the bias read, dqkv
    and dbias written."""
    return B * N * 7 * C * 2 + 2 * h * N * N * 4


def k5_bwd_bound(B: int, N: int, C: int, h: int) -> tuple[float, str]:
    """``k5_bwd_bytes``; the five products (q k^T, do v^T, p^T do, ds k,
    ds^T q) on the tensor cores."""
    return bound(k5_bwd_bytes(B, N, C, h), {"bf16": 10 * B * N * N * C})


def two_steps(ref) -> float:
    """Two bf16 steps of ``ref``'s scale: 2 * 2**(floor(log2 max|ref|) - 7);
    0 for an all-zero ``ref`` (dq and dk over one token)."""
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def grad_ms(out, inputs, dout, runs: int = 25, rounds: int = BWD_ROUNDS) -> dict:
    """The backward alone of a forward already run (``out``, recorded by
    autograd): ``torch.autograd.grad(out, inputs, dout, retain_graph=True)``
    timed with CUDA events around each call, in ``rounds`` separate rounds of
    ``runs`` calls, and the device time of the kernels a call launches
    (``kernel_split`` over ``runs`` calls), which leaves out the host's gaps
    between them. {"median": the median of the rounds' medians, "rounds":
    each round's median, quartiles and extremes, "device_ms": device ms a
    call, "device_split": by kernel}."""
    import torch

    def call():
        return torch.autograd.grad(out, inputs, dout, retain_graph=True)

    rs = [spread(cuda_times(call, runs=runs)) for _ in range(rounds)]
    split, _ = kernel_split(call, calls=runs)
    return {"median": statistics.median(r["median"] for r in rs), "rounds": rs,
            "device_ms": sum(split.values()), "device_split": split}


def rounds_text(t: dict) -> str:
    return "; ".join(f"{r['median']:.4f} (q1 {r['q1']:.4f}, q3 {r['q3']:.4f})"
                     for r in t["rounds"])


def sdpa_bwd_ms(qkv, bias, dout, h: int, scale: float) -> tuple[dict | None, str]:
    """The yardstick for K5's backward: ``scaled_dot_product_attention`` with
    the bias as a bf16 ``attn_mask`` through autograd on the same q, k, v,
    its backward alone (``grad_ms``: the forward runs once outside the timed
    calls), and the backend that served it. Each backend is tried on its own
    (cuDNN, flash, memory-efficient, math), first with the mask requiring
    grad; where none returns the mask's gradient, the mask does not require
    grad, and the backend's name says so."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, N, C3 = qkv.shape
    d = C3 // 3 // h
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.view(B, N, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
    g = dout.view(B, N, h, d).transpose(1, 2).contiguous()
    order = [SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
             SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]
    for mask_grad in (True, False):
        mask = bias.to(torch.bfloat16)[None].requires_grad_(mask_grad)
        inputs = [q, k, v] + ([mask] if mask_grad else [])
        for backend in order:
            try:
                with sdpa_kernel([backend]):
                    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
                    times = grad_ms(out, inputs, g)
            except RuntimeError:
                continue
            name = backend.name.lower() + ("" if mask_grad else ", mask without grad")
            return times, name
    log(f"  scaled_dot_product_attention took no backward at {tuple(qkv.shape)}")
    return None, "none"


def phase1_k5_bwd(device) -> dict:
    """K5's backward against its plain version at the four FasterViT-2
    fine-tune shapes (batch 128) and odd sizes: dq, dk and dv each within two
    bf16 steps of its own scale (both round bf16(p), bf16(ds) and each output
    once, from f32 sums in different orders), dbias within
    ``K5_BWD_DBIAS_TOL`` of its scale; two kernel runs give bit-identical
    dbias and dqkv. Kernel, plain and library times, summed per fine-tune
    step of each head configuration."""
    import torch

    from deepfakedetection_tpu_torch.ops import window_attn as k5

    sms = k5.sm_count(device)

    def check(label, qkv, bias, dout, h, scale):
        B, N, C3 = qkv.shape
        plan = k5.bwd_plan(B, N, h, C3 // 3 // h, sms)
        if plan != k5.kernel_bwd_plan(B, N, h, C3 // 3 // h, sms):
            raise AssertionError(f"window_attention_bwd {label}: plan {plan} is not the kernel's "
                                 f"{k5.kernel_bwd_plan(B, N, h, C3 // 3 // h, sms)}")
        before = k5.window_attention_bwd.launches
        dqkv, dbias = k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=scale)
        torch.cuda.synchronize()
        if k5.window_attention_bwd.launches != before + 1:
            raise AssertionError("window_attention_bwd did not launch its kernel")
        again = k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=scale)
        torch.cuda.synchronize()
        if not (torch.equal(again[1], dbias) and torch.equal(again[0], dqkv)):
            raise AssertionError(f"window_attention_bwd {label}: two runs differ")
        ref_qkv, ref_bias = k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=h,
                                                          scale=scale)
        C = qkv.shape[-1] // 3
        errs, tols = {}, {}
        for i, part in enumerate(("dq", "dk", "dv")):
            ref = ref_qkv[..., i * C:(i + 1) * C]
            tols[part] = two_steps(ref)
            errs[part] = check_close(f"window_attention_bwd {label} {part}",
                                     dqkv[..., i * C:(i + 1) * C], ref, tols[part], 0.0)
        scale_b = float(ref_bias.abs().max())
        errs["dbias"] = check_close(f"window_attention_bwd {label} dbias", dbias, ref_bias,
                                    K5_BWD_DBIAS_TOL * scale_b, 0.0)
        tols["dbias"] = K5_BWD_DBIAS_TOL * scale_b
        return errs, tols

    rows, worst, per = [], 0.0, {}
    for i, (config, B, N, C, h, count) in enumerate(K5_BWD_SHAPES):
        g = torch.Generator().manual_seed(500 + i)
        qkv = torch.randn(B, N, 3 * C, generator=g).to(torch.bfloat16).to(device)
        bias = torch.randn(h, N, N, generator=g).to(device)
        dout = torch.randn(B, N, C, generator=g).to(torch.bfloat16).to(device)
        scale = (C // h) ** -0.5
        errs, tols = check(f"{config} {(B, N, C, h)}", qkv, bias, dout, h, scale)
        worst = max(worst, errs["dq"], errs["dk"], errs["dv"])
        t_k = spread(cuda_times(
            lambda: k5.window_attention_bwd(qkv, bias, dout, num_heads=h, scale=scale), runs=25))
        t_p = spread(cuda_times(lambda: k5.window_attention_bwd_plain(
            qkv, bias, dout, num_heads=h, scale=scale), runs=10))
        dev = sum(kernel_split(lambda: k5.window_attention_bwd(qkv, bias, dout, num_heads=h,
                                                               scale=scale),
                               calls=25, expect=k5.BWD_KERNELS)[0].values())
        lib_t, backend = sdpa_bwd_ms(qkv, bias, dout, h, scale)
        lib = None if lib_t is None else lib_t["median"]
        lib_dev = None if lib_t is None else lib_t["device_ms"]
        b_ms, b_by = k5_bwd_bound(B, N, C, h)
        rows.append({"config": config, "shape": (B, N, C, h), "launches_per_step": count,
                     "max_abs_err": errs, "tolerance": tols, "ms": t_k, "plain_ms": t_p,
                     "device_ms": dev, "library_ms": lib, "library_device_ms": lib_dev,
                     "library_rounds": lib_t and lib_t["rounds"],
                     "library_device_split": lib_t and lib_t["device_split"],
                     "library_backend": backend, "bound_ms": b_ms, "bound_by": b_by,
                     "gb_per_s": k5_bwd_bytes(B, N, C, h) / dev / 1e6,
                     "plan": k5.bwd_plan(B, N, h, C // h, sms)._asdict()})
        agg = per.setdefault(config, {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                                      "library_ms": 0.0, "library_device_ms": 0.0, "bounds": []})
        agg["ms"] += count * t_k["median"]
        agg["plain_ms"] += count * t_p["median"]
        agg["device_ms"] += count * dev
        for key, v in (("library_ms", lib), ("library_device_ms", lib_dev)):
            agg[key] = None if v is None or agg[key] is None else agg[key] + count * v
        agg["bounds"].append((count, (b_ms, b_by)))
        log(f"  window_attention_bwd {config} windows {B} N {N} C {C} heads {h}: max|d| "
            + ", ".join(f"{k} {errs[k]:.3e} (tol {tols[k]:.3e})" for k in errs)
            + f"; dbias bit-identical over two runs; kernel {t_k['median']:.4f} ms (device "
            f"{dev:.4f}), plain {t_p['median']:.4f} ms, sdpa backward "
            f"{lib if lib is None else round(lib, 4)} ms (device "
            f"{lib_dev if lib_dev is None else round(lib_dev, 4)}; {backend}; rounds "
            f"{lib_t and rounds_text(lib_t)}), bound {b_ms:.4f} ms ({b_by}), "
            f"{rows[-1]['gb_per_s']:.0f} GB/s by device time, plan {rows[-1]['plan']}")
    for B, N, h, d in K5_BWD_ODD:
        g = torch.Generator().manual_seed(600 + N * d + h)
        C = h * d
        qkv = torch.randn(B, N, 3 * C, generator=g).to(torch.bfloat16).to(device)
        bias = torch.randn(h, N, N, generator=g).to(device)
        dout = torch.randn(B, N, C, generator=g).to(torch.bfloat16).to(device)
        errs, _ = check(f"{(B, N, h, d)}", qkv, bias, dout, h, d**-0.5)
        rows.append({"shape": (B, N, C, h), "max_abs_err": errs})
        log(f"  window_attention_bwd odd {(B, N, h, d)}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    # an unaligned strided view of qkv: the kernel's one-element path
    g = torch.Generator().manual_seed(7)
    qkv = torch.randn(16, 53, 3 * 384, generator=g).to(torch.bfloat16).to(device)
    wide = torch.zeros(16, 53, 3 * 384 + 2, dtype=torch.bfloat16, device=device)
    wide[..., 1:-1] = qkv
    bias = torch.randn(8, 53, 53, generator=g).to(device)
    dout = torch.randn(16, 53, 384, generator=g).to(torch.bfloat16).to(device)
    check("unaligned view", wide[..., 1:-1], bias, dout, 8, 48**-0.5)
    for config, agg in per.items():
        agg["bound_ms"], agg["bound_by"] = add_bounds(agg.pop("bounds"))
        log(f"  window_attention_bwd per FasterViT-2 {config} fine-tune step at batch 128 (13 "
            f"launches): kernel {agg['ms']:.4f} ms (device {agg['device_ms']:.4f}), plain "
            f"{agg['plain_ms']:.4f} ms, sdpa backward {agg['library_ms']} ms (device "
            f"{agg['library_device_ms']}), bound {agg['bound_ms']:.4f} ms")
    return {"rows": rows, "max_abs_err": worst, "per_step": per, **per["official"]}


def k7_inputs(B, N, h, d, dv, seed, device):
    """q, k, v bf16; the bias table, the talking heads and their biases f32."""
    import torch

    g = torch.Generator().manual_seed(seed)
    qkv = [torch.randn(B, N, h * c, generator=g).to(torch.bfloat16) for c in (d, d, dv)]
    tables = [torch.randn(h, N, N, generator=g) * 0.5, torch.randn(h, h, generator=g) * 0.5,
              torch.randn(h, generator=g) * 0.1, torch.randn(h, h, generator=g) * 0.5,
              torch.randn(h, generator=g) * 0.1]
    return [t.to(device) for t in qkv + tables]


def k7_bound(B: int, N: int, h: int, d: int, dv: int) -> tuple[float, str]:
    """q, k, v and the tables read, the output written; q k^T and p2 v on the
    tensor cores, the two head mixes on the CUDA cores in f32."""
    nbytes = B * N * (2 * h * d + 2 * h * dv) * 2 + (h * N * N + 2 * h * h + 2 * h) * 4
    return bound(nbytes, {"bf16": 2 * B * h * N * N * (d + dv), "f32": 2 * 2 * B * N * N * h * h})


def phase1_k7(device) -> dict:
    """K7 against its plain version at EfficientFormerV2-S1's shape (batch
    256) and ragged sizes, within two bf16 steps of the output's scale (both
    round p2 and the output once, from f32 sums in different orders),
    bit-identical over two runs, the plan the built kernel's; kernel and
    plain times per S1 forward, the kernel's by CUDA events and by its device
    time (``kernel_split``). No single PyTorch call computes talking-head
    attention (library: none)."""
    import torch

    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.profile_k7 import KERNELS

    sms = k7.sm_count(device)

    def check(label, args, h, d):
        B, N = args[0].shape[:2]
        dv = args[2].shape[2] // h
        if k7.plan(B, N, h, d, dv, sms) != k7.kernel_plan(B, N, h, d, dv, sms):
            raise AssertionError(f"attn4d {label}: plan {k7.plan(B, N, h, d, dv, sms)} is not "
                                 "the kernel's")
        before = k7.attn4d.launches
        out = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
        again = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
        torch.cuda.synchronize()
        if k7.attn4d.launches != before + 2:
            raise AssertionError("attn4d did not launch its kernel")
        if not torch.equal(out, again):
            raise AssertionError(f"attn4d {label}: two runs differ")
        ref = k7.attn4d_plain(*args, num_heads=h, scale=d**-0.5)
        tol = two_steps(ref)
        return check_close(f"attn4d {label}", out, ref, tol, 0.0), tol

    rows, worst = [], 0.0
    agg = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bounds": []}
    for i, (B, N, h, d, dv, count) in enumerate(K7_SHAPES):
        args = k7_inputs(B, N, h, d, dv, seed=700 + i, device=device)
        err, tol = check(f"{(B, N, h, d, dv)}", args, h, d)
        worst = max(worst, err)
        t_k = spread(cuda_times(lambda: k7.attn4d(*args, num_heads=h, scale=d**-0.5), runs=25))
        dev_k = sum(kernel_split(lambda: k7.attn4d(*args, num_heads=h, scale=d**-0.5), calls=25,
                                 expect=KERNELS)[0].values())
        t_p = spread(cuda_times(lambda: k7.attn4d_plain(*args, num_heads=h, scale=d**-0.5),
                                runs=10))
        b_ms, b_by = k7_bound(B, N, h, d, dv)
        plan = k7.plan(B, N, h, d, dv, sms)
        rows.append({"shape": (B, N, h, d, dv), "launches_per_forward": count, "max_abs_err": err,
                     "tolerance": tol, "plan": plan._asdict(), "ms": t_k, "device_ms": dev_k,
                     "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by, "x_off": dev_k / b_ms})
        agg["ms"] += count * t_k["median"]
        agg["device_ms"] += count * dev_k
        agg["plain_ms"] += count * t_p["median"]
        agg["bounds"].append((count, (b_ms, b_by)))
        log(f"  attn4d {(B, N, h, d, dv)} [{plan}]: max|d|={err:.3e} (tol {tol:.3e}), "
            f"bit-identical over two runs; kernel {t_k['median']:.4f} ms (q1 {t_k['q1']:.4f}, q3 "
            f"{t_k['q3']:.4f}), device {dev_k:.4f} ms, plain {t_p['median']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {dev_k / b_ms:.1f}x off")
    for i, (B, N, h, d, dv) in enumerate(K7_ODD):
        err, tol = check(f"{(B, N, h, d, dv)}", k7_inputs(B, N, h, d, dv, 710 + i, device), h, d)
        plan = k7.plan(B, N, h, d, dv, sms)
        rows.append({"shape": (B, N, h, d, dv), "max_abs_err": err, "tolerance": tol,
                     "plan": plan._asdict()})
        log(f"  attn4d odd {(B, N, h, d, dv)} [{plan}]: max|d|={err:.3e} (tol {tol:.3e})")
    # q and k as unaligned views of one wider tensor: the kernel's one-element path
    args = k7_inputs(16, 49, 8, 32, 128, seed=720, device=device)
    wide = torch.zeros(16, 49, 2 * 256 + 2, dtype=torch.bfloat16, device=device)
    wide[..., 1:257], wide[..., 257:513] = args[0], args[1]
    check("unaligned views", [wide[..., 1:257], wide[..., 257:513]] + args[2:], 8, 32)
    bound_ms, bound_by = add_bounds(agg.pop("bounds"))
    log(f"  attn4d per EfficientFormerV2-S1 forward at batch {EF_BATCH} (4 launches): kernel "
        f"{agg['ms']:.4f} ms (device {agg['device_ms']:.4f}), plain {agg['plain_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms, {agg['device_ms'] / bound_ms:.1f}x off")
    return {"rows": rows, "max_abs_err": worst, **agg, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def k7_parent(parent: str | None) -> dict | None:
    """K7 of the checkout in ``parent`` against this one
    (``profile_k7.compare``): at ``K7_SHAPES`` both times in turns, event
    and device, and their sums per S1 forward; at every shape and ``K7_ODD``
    the outputs must be bit-identical (raises otherwise). None without
    ``parent``."""
    if parent is None:
        log("  attn4d: the parent's kernel not measured (no --parent)")
        return None
    from deepfakedetection_tpu_torch import profile_k7

    rows = profile_k7.compare(parent)
    differ = [r["shape"] for r in rows if not r["bit_identical"]]
    if differ:
        raise AssertionError(f"attn4d: outputs not bit-identical to {parent}'s at {differ}")
    sums = {key: 0.0 for key in ("this_ms", "other_ms", "this_device_ms", "other_device_ms")}
    for r, shape in zip(rows, K7_SHAPES):
        for key in sums:
            sums[key] += shape[5] * r[key]
    log(f"  attn4d per EfficientFormerV2-S1 forward at batch {EF_BATCH} (4 launches), in turns "
        f"with {parent}'s: this {sums['this_ms']:.4f} ms (device {sums['this_device_ms']:.4f}), "
        f"the parent's {sums['other_ms']:.4f} ms (device {sums['other_device_ms']:.4f}); device "
        f"ratio {sums['this_device_ms'] / sums['other_device_ms']:.3f}; bit-identical at every "
        "shape")
    return {"tree": parent, "rows": rows, "per_forward": sums}


def k3_inputs(B, H, W, C, k, seed, device):
    """x bf16 and the ten f32 operands in the JAX layout, each product's
    weights at unit gain (Cmid 6C, Cse C // 4 or 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    Cmid, Cse = 6 * C, max(C // 4, 1)
    x = torch.randn(B, H, W, C, generator=g).to(torch.bfloat16)
    ws = [torch.randn(C, Cmid, generator=g) * C ** -0.5, torch.randn(Cmid, generator=g) * 0.1,
          torch.randn(k, k, Cmid, generator=g) / k, torch.randn(Cmid, generator=g) * 0.1,
          torch.randn(Cmid, Cse, generator=g) * Cmid ** -0.5, torch.randn(Cse, generator=g) * 0.1,
          torch.randn(Cse, Cmid, generator=g) * Cse ** -0.5, torch.randn(Cmid, generator=g) * 0.1,
          torch.randn(Cmid, C, generator=g) * Cmid ** -0.5, torch.randn(C, generator=g) * 0.1]
    return [t.to(device) for t in [x] + ws]


def k3_bound(B: int, H: int, W: int, C: int, k: int) -> tuple[float, str]:
    """x read, the operands read, out written; the expand and the project on
    the tensor cores, the taps and the two SE products on the CUDA cores in
    f32."""
    px, Cmid, Cse = B * H * W, 6 * C, max(C // 4, 1)
    weights = 2 * C * Cmid + (k * k + 3) * Cmid + 2 * Cmid * Cse + Cse + C
    return bound(px * C * 2 * 2 + weights * 4,
                 {"bf16": 4 * px * C * Cmid, "f32": 2 * k * k * px * Cmid + 4 * B * Cmid * Cse})


@contextlib.contextmanager
def env_switch(name: str, on: bool):
    """The environment switch ``name`` set (or unset) for the models built
    inside, then restored."""
    old = os.environ.pop(name, None)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def k3_block(args, k: int, on: bool, device):
    """A bf16 eval MBConv block (in == out, expand 6, stride 1) whose folded
    weights are K3's operands ``args`` (BatchNorms at unit scale, zero mean,
    variance 1 - eps: the fold multiplies by exactly 1), built with
    ``DFD_FUSED_MBCONV`` (K3) or without it (the unfused route: K2, the bf16
    SE, the project ConvBN, the residual add)."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import BlockArgs, MBConv

    w_exp, b_exp, w_dw, b_dw, w_r, b_r, w_e, b_e, w_p, b_p = (t.cpu() for t in args)
    C, Cmid = w_exp.shape
    r = k // 2
    with env_switch("DFD_FUSED_MBCONV", on):
        blk = MBConv(BlockArgs(C, C, 6, k, 1, 0.25, 0.0, ((r, r), (r, r))))
    with torch.no_grad():
        for conv, bn, w, b in ((blk._expand_conv, blk._bn0, w_exp.t(), b_exp),
                               (blk._depthwise_conv, blk._bn1, w_dw.permute(2, 0, 1), b_dw),
                               (blk._project_conv, blk._bn2, w_p.t(), b_p)):
            conv.weight.copy_(w.reshape(conv.weight.shape))
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0 - bn.eps)
            bn.bias.copy_(b)
        blk._se_reduce.weight.copy_(w_r.t().reshape(blk._se_reduce.weight.shape))
        blk._se_reduce.bias.copy_(b_r)
        blk._se_expand.weight.copy_(w_e.t().reshape(blk._se_expand.weight.shape))
        blk._se_expand.bias.copy_(b_e)
    return blk.to(device).eval()


def phase1_k3(device) -> dict:
    """K3 against its plain version at B3's six K3 shapes and ``K3_ODD``
    (batch 8), within two bf16 steps of the output's scale, bit-identical
    over two runs and through an MBConv block built with the switch (whose
    cached weights are packed once: a warm forward launches no packing
    kernel), the projection's plan equal to the built kernel's. At batch
    128, on weights packed once (as MBConv runs it): CUDA-event and device times (the
    kernels ``plan.kernels()`` names, ``kernel_split``), the packing kernel's
    device time a call, the plain version's and the unfused route's times
    (the route the block takes without the switch, on the same weights), the
    bound and x off (device time over the bound). No single PyTorch call
    computes the block (library: none)."""
    import torch

    from deepfakedetection_tpu_torch.ops import fused_mbconv as k3

    def check(label, args, k):
        B, H, W, C = args[0].shape
        Cmid = args[1].shape[1]
        want = k3.choose_plan(C, Cmid)
        if want != k3.kernel_plan(C, Cmid):
            raise AssertionError(f"fused_mbconv_se {label}: plan {want} is not the kernel's")
        before = k3.fused_mbconv_se.launches
        out = k3.fused_mbconv_se(*args, kernel=k)
        again = k3.fused_mbconv_se(*args, kernel=k)
        torch.cuda.synchronize()
        if k3.fused_mbconv_se.launches != before + 2:
            raise AssertionError("fused_mbconv_se did not launch its kernels")
        if not torch.equal(out, again):
            raise AssertionError(f"fused_mbconv_se {label}: two runs differ")
        ref = k3.fused_mbconv_se_plain(*args, kernel=k)
        tol = two_steps(ref)
        err = check_close(f"fused_mbconv_se {label}", out, ref, tol, 0.0)
        block = k3_block(args[1:], k, True, device)
        with torch.no_grad():
            by_block = block(args[0].permute(0, 3, 1, 2))
        if not torch.equal(by_block.permute(0, 2, 3, 1), out):
            raise AssertionError(f"MBConv with DFD_FUSED_MBCONV {label}: not the wrapper's output")
        plan = k3.plan(B, H, W, C, Cmid, k, k3.k2.sm_count(device))
        return err, tol, plan, block

    rows, worst = [], 0.0
    agg = {"ms": 0.0, "device_ms": 0.0, "pack_device_ms": 0.0, "plain_ms": 0.0,
           "unfused_ms": 0.0, "unfused_device_ms": 0.0, "bounds": []}
    for i, (H, W, C, k, count) in enumerate(K3_SHAPES):
        args = k3_inputs(8, H, W, C, k, seed=300 + i, device=device)
        err, tol, plan, block = check(f"{(H, W, C, k)}", args, k)
        worst = max(worst, err)
        x_nchw = args[0].permute(0, 3, 1, 2)
        with torch.no_grad():
            warm, _ = kernel_split(lambda: block(x_nchw), calls=5, expect=plan.kernels())
        if any("pack" in name for name in warm):
            raise AssertionError(f"MBConv with DFD_FUSED_MBCONV {(H, W, C, k)}: a warm forward "
                                 f"launched a packing kernel ({sorted(warm)})")
        big = k3_inputs(128, H, W, C, k, seed=310 + i, device=device)
        packed = k3.pack(big[1], big[7], big[9])
        unfused, x_nchw = k3_block(big[1:], k, False, device), big[0].permute(0, 3, 1, 2)
        with torch.no_grad():
            t_k = spread(cuda_times(lambda: k3.fused_mbconv_se(*big, kernel=k, packed=packed),
                                    runs=25))
            dev_k = launch_ms(lambda: k3.fused_mbconv_se(*big, kernel=k, packed=packed),
                              plan.kernels(), calls=25)
            dev_pack = launch_ms(lambda: k3.pack(big[1], big[7], big[9]), ("pack_kernel",))
            t_p = spread(cuda_times(lambda: k3.fused_mbconv_se_plain(*big, kernel=k), runs=10))
            t_u = spread(cuda_times(lambda: unfused(x_nchw), runs=25))
            dev_u = sum(kernel_split(lambda: unfused(x_nchw), calls=25)[0].values())
        b_ms, b_by = k3_bound(128, H, W, C, k)
        rows.append({"shape": (H, W, C, k), "blocks_in_b3": count, "plan": plan.describe(),
                     "max_abs_err": err, "tolerance": tol, "ms": t_k, "device_ms": dev_k,
                     "pack_device_ms": dev_pack, "plain_ms": t_p, "unfused_ms": t_u,
                     "unfused_device_ms": dev_u, "bound_ms": b_ms, "bound_by": b_by,
                     "x_off": dev_k / b_ms})
        agg["ms"] += count * t_k["median"]
        agg["device_ms"] += count * dev_k
        agg["pack_device_ms"] += count * dev_pack
        agg["plain_ms"] += count * t_p["median"]
        agg["unfused_ms"] += count * t_u["median"]
        agg["unfused_device_ms"] += count * dev_u
        agg["bounds"].append((count, (b_ms, b_by)))
        log(f"  fused_mbconv_se {(H, W, C, k)} [{plan.describe()}]: max|d|={err:.3e} (tol "
            f"{tol:.3e}), bit-identical over two runs and through the MBConv block (no packing "
            f"kernel in its forward); batch 128: kernel {t_k['median']:.4f} ms (q1 "
            f"{t_k['q1']:.4f}, q3 {t_k['q3']:.4f}), device {dev_k:.4f} ms (packing once "
            f"{dev_pack:.4f}), plain {t_p['median']:.4f} ms, unfused route {t_u['median']:.4f} ms "
            f"(device {dev_u:.4f}), bound {b_ms:.4f} ms ({b_by}), {dev_k / b_ms:.1f}x off")
        if dev_k >= dev_u:
            log(f"  fused_mbconv_se {(H, W, C, k)}: NOT faster than the unfused route by device "
                "time")
    for i, (H, W, C, k) in enumerate(K3_ODD):
        err, tol, plan, _ = check(f"{(H, W, C, k)}", k3_inputs(8, H, W, C, k, 320 + i, device), k)
        rows.append({"shape": (H, W, C, k), "plan": plan.describe(), "max_abs_err": err,
                     "tolerance": tol})
        log(f"  fused_mbconv_se odd {(H, W, C, k)} [{plan.describe()}]: max|d|={err:.3e} (tol "
            f"{tol:.3e}), bit-identical over two runs and through the MBConv block")
    bound_ms, bound_by = add_bounds(agg.pop("bounds"))
    log(f"  fused_mbconv_se per B3 forward at batch 128 (18 launches): kernel {agg['ms']:.4f} ms "
        f"(device {agg['device_ms']:.4f}; packing every call would add {agg['pack_device_ms']:.4f}"
        f"), plain {agg['plain_ms']:.4f} ms, unfused route {agg['unfused_ms']:.4f} ms (device "
        f"{agg['unfused_device_ms']:.4f}), bound {bound_ms:.4f} ms ({bound_by}), "
        f"{agg['device_ms'] / bound_ms:.1f}x off")
    return {"rows": rows, "max_abs_err": worst, **agg, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def k3_parent(parent: str | None) -> dict | None:
    """K3 of the checkout in ``parent`` against this one
    (``profile_k3.compare``): at the six B3 shapes both times in turns,
    event and device, with each kernel's share, and the sums per B3 forward
    (18 launches at batch 128); at every shape and ``K3_ODD`` whether the
    outputs are bit-identical. None without ``parent``."""
    if parent is None:
        log("  fused_mbconv_se: the parent's kernel not measured (no --parent)")
        return None
    from deepfakedetection_tpu_torch import profile_k3

    rows = profile_k3.compare(parent)
    sums = {key: 0.0 for key in ("this_ms", "other_ms", "this_device_ms", "other_device_ms")}
    for r, shape in zip(rows, K3_SHAPES):
        for key in sums:
            sums[key] += shape[4] * r[key]
        if r["this_device_ms"] >= r["other_device_ms"]:
            log(f"  fused_mbconv_se {shape[:4]}: NOT faster than the parent's by device time "
                f"({r['this_device_ms']:.4f} against {r['other_device_ms']:.4f} ms)")
    log(f"  fused_mbconv_se per B3 forward at batch 128 (18 launches), in turns with {parent}'s: "
        f"this {sums['this_ms']:.4f} ms (device {sums['this_device_ms']:.4f}), the parent's "
        f"{sums['other_ms']:.4f} ms (device {sums['other_device_ms']:.4f}); device ratio "
        f"{sums['this_device_ms'] / sums['other_device_ms']:.3f}")
    return {"tree": parent, "rows": rows, "per_forward": sums}


def k6_inputs(B, N, C, h, seed, device):
    """x and dout bf16; the Linears' f32 weights (unit gain) and biases; the
    f32 bias table."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, N, C, generator=g).to(torch.bfloat16)
    wqkv = torch.randn(3 * C, C, generator=g) * C**-0.5
    bqkv = torch.randn(3 * C, generator=g) * 0.1
    bias = torch.randn(h, N, N, generator=g)
    wproj = torch.randn(C, C, generator=g) * C**-0.5
    bproj = torch.randn(C, generator=g) * 0.1
    dout = torch.randn(B, N, C, generator=g).to(torch.bfloat16)
    return [t.to(device) for t in (x, wqkv, bqkv, bias, wproj, bproj, dout)]


def k6_bound(B: int, N: int, C: int, h: int) -> tuple[float, str]:
    """x read and the output written (bf16), the f32 weights, biases and bias
    table read once; x Wqkv^T, q k^T, p v and ctx Wproj^T on the tensor
    cores."""
    return bound(2 * B * N * C * 2 + (4 * C * C + 4 * C + h * N * N) * 4,
                 {"bf16": 2 * B * N * C * (4 * C + 2 * N)})


def k6_bwd_bound(B: int, N: int, C: int, h: int) -> tuple[float, str]:
    """x and dout read, dx written (bf16); the f32 weights, qkv bias and bias
    table read, the six gradients written; on the tensor cores the qkv
    recompute (6 B N C^2), dctx (2), dx (6), dWqkv (6) and dWproj (2), and
    the attention's six N x N products (q k^T, p v, do v^T, ds k, p^T do,
    ds^T q: 12 B N^2 C)."""
    nbytes = 3 * B * N * C * 2 + (4 * C * C + 3 * C + h * N * N) * 4 \
        + (4 * C * C + 4 * C + h * N * N) * 4
    return bound(nbytes, {"bf16": B * N * C * (22 * C + 12 * N)})


def unfused_subblock(x, wqkv, bqkv, bias, wproj, bproj, h: int, scale: float):
    """The port's path without ``DFD_FUSED_ATTN``: the qkv Linear (bf16
    weights and bias, cuBLAS), K5 for N >= 32 (plain ops below), the proj
    Linear."""
    import torch
    import torch.nn.functional as F

    from deepfakedetection_tpu_torch.ops import window_attn as k5

    bf16 = torch.bfloat16
    attend = k5.window_attention if x.shape[1] >= 32 else k5.window_attention_plain
    qkv = F.linear(x, wqkv.to(bf16), bqkv.to(bf16))
    return F.linear(attend(qkv, bias, num_heads=h, scale=scale), wproj.to(bf16), bproj.to(bf16))


def mha_forward(x, wqkv, bqkv, bias, wproj, bproj, h: int):
    """``torch.nn.functional.multi_head_attention_forward`` on the same
    function in bf16, the bias expanded to a [B h, N, N] float mask: the
    library yardstick, which the port never calls."""
    import torch
    import torch.nn.functional as F

    B, N, C = x.shape
    mask = bias.to(torch.bfloat16)[None].expand(B, h, N, N).reshape(B * h, N, N)
    q = x.transpose(0, 1)
    return F.multi_head_attention_forward(
        q, q, q, C, h, wqkv, bqkv, None, None, False, 0.0, wproj, bproj, training=False,
        need_weights=False, attn_mask=mask)[0].transpose(0, 1)


def phase1_k6(device) -> tuple[dict, dict]:
    """K6 against its plain version: the forward at the six FasterViT-2 eval
    shapes (batch 256), odd sizes and ``K6_TAILS``, within two bf16 steps of
    each output's scale (both round qkv, the probabilities, ctx and the output
    once, from f32 sums in different orders), bit-identical over two runs, its
    launch plan (``fwd_plan``) the one the built kernel computes; the backward
    at the six fine-tune shapes (batch 128), odd sizes and ``K6_BWD_TAILS``,
    dx within two bf16 steps of its scale, the f32 gradients within
    ``K6_BWD_TOL`` of theirs, all six bit-identical over two runs, its plan
    (``bwd_plan``) the built kernel's, and at the fine-tune shapes each of
    its device kernels' time a call (``kernel_split``). Times (CUDA events, medians) of
    K6, its plain version, the port's unfused path (Linear, K5, Linear) and
    ``multi_head_attention_forward`` in bf16, forward and backward (the
    backward alone after one forward, ``grad_ms``, in ``BWD_ROUNDS``
    rounds), summed per forward and per fine-tune step of each head
    configuration."""
    import torch

    from deepfakedetection_tpu_torch.ops import attn_block as k6

    def fwd_check(label, args, h, scale):
        B, N, C = args[0].shape
        plan, built = k6.fwd_plan(B, N, C, h), k6.kernel_plan(B, N, C, h)
        if plan != built:
            raise AssertionError(f"attn_subblock {label}: fwd_plan {plan} is not the kernel's "
                                 f"{built}")
        before = k6.attn_subblock.launches
        out = k6.attn_subblock(*args, num_heads=h, scale=scale)
        again = k6.attn_subblock(*args, num_heads=h, scale=scale)
        torch.cuda.synchronize()
        if k6.attn_subblock.launches != before + 2:
            raise AssertionError("attn_subblock did not launch its kernel")
        if not torch.equal(out, again):
            raise AssertionError(f"attn_subblock {label}: two runs differ")
        ref = k6.attn_subblock_plain(*args, num_heads=h, scale=scale)
        tol = two_steps(ref)
        return check_close(f"attn_subblock {label}", out, ref, tol, 0.0), tol

    def bwd_check(label, args, dout, h, scale):
        B, N, C = args[0].shape
        plan, built = k6.bwd_plan(B, N, C, h), k6.kernel_bwd_plan(B, N, C, h)
        if plan != built:
            raise AssertionError(f"attn_subblock_bwd {label}: bwd_plan {plan} is not the "
                                 f"kernel's {built}")
        before = k6.attn_subblock_bwd.launches
        grads = k6.attn_subblock_bwd(*args[:5], dout, num_heads=h, scale=scale)
        again = k6.attn_subblock_bwd(*args[:5], dout, num_heads=h, scale=scale)
        torch.cuda.synchronize()
        if k6.attn_subblock_bwd.launches != before + 2:
            raise AssertionError("attn_subblock_bwd did not launch its kernels")
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"attn_subblock_bwd {label}: two runs differ")
        refs = k6.attn_subblock_bwd_plain(*args[:5], dout, num_heads=h, scale=scale)
        errs, tols = {}, {}
        for name, got, ref in zip(K6_GRADS, grads, refs):
            tols[name] = two_steps(ref) if name == "dx" else \
                K6_BWD_TOL * float(ref.abs().max())
            errs[name] = check_close(f"attn_subblock_bwd {label} {name}", got, ref, tols[name],
                                     0.0)
        return errs, tols

    def add(per, config, count, t_k, t_p, unfused, lib, b):
        agg = per.setdefault(config, {"ms": 0.0, "plain_ms": 0.0, "unfused_ms": 0.0,
                                      "library_ms": 0.0, "bounds": []})
        agg["ms"] += count * t_k["median"]
        agg["plain_ms"] += count * t_p["median"]
        agg["unfused_ms"] += count * unfused
        agg["library_ms"] = None if lib is None or agg["library_ms"] is None \
            else agg["library_ms"] + count * lib
        agg["bounds"].append((count, b))

    def finish(per, what):
        for config, agg in per.items():
            agg["bound_ms"], agg["bound_by"] = add_bounds(agg.pop("bounds"))
            log(f"  {what} per FasterViT-2 {config} (21 launches): kernel {agg['ms']:.4f} ms, "
                f"plain {agg['plain_ms']:.4f} ms, unfused path {agg['unfused_ms']:.4f} ms, "
                f"multi_head_attention_forward {agg['library_ms']} ms, bound "
                f"{agg['bound_ms']:.4f} ms ({agg['bound_by']})")

    rows, worst, per = [], 0.0, {}
    for i, (config, B, N, C, h, count) in enumerate(K6_SHAPES):
        x, wq, bq, bias, wp, bp, _ = args = k6_inputs(B, N, C, h, 800 + i, device)
        args, scale = args[:6], (C // h) ** -0.5
        err, tol = fwd_check(f"{config} {(B, N, C, h)}", args, h, scale)
        worst = max(worst, err)
        t_k = spread(cuda_times(lambda: k6.attn_subblock(*args, num_heads=h, scale=scale),
                                runs=25))
        t_p = spread(cuda_times(lambda: k6.attn_subblock_plain(*args, num_heads=h, scale=scale),
                                runs=10))
        unfused = statistics.median(cuda_times(lambda: unfused_subblock(*args, h, scale),
                                               runs=25))
        w16 = [t.to(torch.bfloat16) for t in (wq, bq, wp, bp)]
        try:
            lib = statistics.median(cuda_times(
                lambda: mha_forward(x, w16[0], w16[1], bias, w16[2], w16[3], h), runs=25))
        except RuntimeError as exc:
            log(f"  multi_head_attention_forward refused {(B, N, C, h)}: {exc}")
            lib = None
        b = k6_bound(B, N, C, h)
        plan = k6.fwd_plan(B, N, C, h)
        rows.append({"config": config, "shape": (B, N, C, h), "launches_per_forward": count,
                     "max_abs_err": err, "tolerance": tol, "ms": t_k, "plain_ms": t_p,
                     "unfused_ms": unfused, "library_ms": lib, "bound_ms": b[0],
                     "bound_by": b[1], "plan": plan._asdict(),
                     "rows_per_weight_read": plan.rows_per_weight_read(N)})
        add(per, config, count, t_k, t_p, unfused, lib, b)
        log(f"  attn_subblock {config} windows {B} N {N} C {C} heads {h} ({plan}, "
            f"{plan.rows_per_weight_read(N)} rows a weight read): max|d|={err:.3e} "
            f"(tol {tol:.3e}), bit-identical over two runs; kernel {t_k['median']:.4f} ms (q1 "
            f"{t_k['q1']:.4f}, q3 "
            f"{t_k['q3']:.4f}), plain {t_p['median']:.4f} ms, unfused path {unfused:.4f} ms, "
            f"multi_head_attention_forward {lib if lib is None else round(lib, 4)} ms, bound "
            f"{b[0]:.4f} ms ({b[1]})")
    finish(per, "attn_subblock")
    fwd = {"rows": rows, "max_abs_err": worst, "per_forward": per, **per["official"]}

    rows, worst, per = [], 0.0, {}
    for i, (config, B, N, C, h, count) in enumerate(K6_BWD_SHAPES):
        x, wq, bq, bias, wp, bp, dout = k6_inputs(B, N, C, h, 900 + i, device)
        args, scale = [x, wq, bq, bias, wp, bp], (C // h) ** -0.5
        errs, tols = bwd_check(f"{config} {(B, N, C, h)}", args, dout, h, scale)
        worst = max(worst, errs["dx"])
        t_k = spread(cuda_times(lambda: k6.attn_subblock_bwd(*args[:5], dout, num_heads=h,
                                                             scale=scale), runs=25))
        t_p = spread(cuda_times(lambda: k6.attn_subblock_bwd_plain(*args[:5], dout, num_heads=h,
                                                                   scale=scale), runs=10))
        leaves = [t.detach().clone().requires_grad_() for t in args]
        unfused_t = grad_ms(unfused_subblock(*leaves, h, scale), leaves, dout)
        unfused = unfused_t["median"]
        w16 = [t.to(torch.bfloat16).requires_grad_() for t in (x, wq, bq, wp, bp)]
        try:
            lib_t = grad_ms(mha_forward(w16[0], w16[1], w16[2], bias, w16[3], w16[4], h), w16,
                            dout)
            lib, lib_dev = lib_t["median"], lib_t["device_ms"]
        except RuntimeError as exc:
            log(f"  multi_head_attention_forward took no backward at {(B, N, C, h)}: {exc}")
            lib_t = lib = lib_dev = None
        b = k6_bwd_bound(B, N, C, h)
        plan = k6.bwd_plan(B, N, C, h)
        split, kernels = kernel_split(lambda: k6.attn_subblock_bwd(*args[:5], dout, num_heads=h,
                                                                   scale=scale),
                                      expect=K6_BWD_KERNELS)
        rows.append({"config": config, "shape": (B, N, C, h), "launches_per_step": count,
                     "max_abs_err": errs, "tolerance": tols, "ms": t_k, "plain_ms": t_p,
                     "device_ms": sum(split.values()), "unfused_ms": unfused,
                     "unfused_device_ms": unfused_t["device_ms"],
                     "unfused_rounds": unfused_t["rounds"], "library_ms": lib,
                     "library_device_ms": lib_dev, "library_rounds": lib_t and lib_t["rounds"],
                     "bound_ms": b[0], "bound_by": b[1], "plan": plan._asdict(),
                     "rows_per_weight_read": plan.rows_per_weight_read(N),
                     "device_ms_per_kernel": split, "device_kernels_per_call": kernels})
        add(per, config, count, t_k, t_p, unfused, lib, b)
        for key, v in (("device_ms", sum(split.values())),
                       ("unfused_device_ms", unfused_t["device_ms"]),
                       ("library_device_ms", lib_dev)):
            prev = per[config].get(key, 0.0)
            per[config][key] = None if v is None or prev is None else prev + count * v
        log(f"  attn_subblock_bwd {config} windows {B} N {N} C {C} heads {h}: {plan}, "
            f"{kernels:g} device kernels a call, device ms a call: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f"; device ms a call of the unfused path's backward {unfused_t['device_ms']:.4f}, "
            f"of multi_head_attention_forward's "
            f"{lib_dev if lib_dev is None else round(lib_dev, 4)}")
        log(f"  attn_subblock_bwd {config} windows {B} N {N} C {C} heads {h}: max|d| "
            + ", ".join(f"{k} {errs[k]:.3e} (tol {tols[k]:.3e})" for k in errs)
            + f"; bit-identical over two runs; kernel {t_k['median']:.4f} ms (q1 "
            f"{t_k['q1']:.4f}, q3 {t_k['q3']:.4f}), plain {t_p['median']:.4f} ms, unfused path "
            f"backward {unfused:.4f} ms (rounds {rounds_text(unfused_t)}), "
            f"multi_head_attention_forward backward {lib if lib is None else round(lib, 4)} ms "
            f"(rounds {lib_t and rounds_text(lib_t)}), bound {b[0]:.4f} ms ({b[1]})")
    finish(per, "attn_subblock_bwd")
    for config, agg in per.items():
        log(f"  attn_subblock_bwd per FasterViT-2 {config} step, device time: kernel "
            f"{agg['device_ms']:.4f} ms, unfused path {agg['unfused_device_ms']:.4f} ms, "
            f"multi_head_attention_forward {agg['library_device_ms']} ms")
    bwd = {"rows": rows, "max_abs_err": worst, "per_step": per, **per["official"]}

    for i, (B, N, h, d) in enumerate(K6_ODD):
        x, wq, bq, bias, wp, bp, dout = k6_inputs(B, N, h * d, h, 950 + i, device)
        args, label = [x, wq, bq, bias, wp, bp], f"odd {(B, N, h, d)}"
        err, tol = fwd_check(label, args, h, d**-0.5)
        errs, _ = bwd_check(label, args, dout, h, d**-0.5)
        fwd["rows"].append({"shape": (B, N, h * d, h), "max_abs_err": err, "tolerance": tol})
        bwd["rows"].append({"shape": (B, N, h * d, h), "max_abs_err": errs})
        log(f"  attn_subblock {label}: forward max|d|={err:.3e} (tol {tol:.3e}); backward "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for i, (B, N, h, d) in enumerate(K6_TAILS):
        args = k6_inputs(B, N, h * d, h, 970 + i, device)[:6]
        label = f"tail {(B, N, h, d)} ({k6.fwd_plan(B, N, h * d, h)})"
        err, tol = fwd_check(label, args, h, d**-0.5)
        fwd["rows"].append({"shape": (B, N, h * d, h), "max_abs_err": err, "tolerance": tol})
        log(f"  attn_subblock {label}: forward max|d|={err:.3e} (tol {tol:.3e}), bit-identical "
            f"over two runs")
    for i, (B, N, h, d) in enumerate(K6_BWD_TAILS):
        x, wq, bq, bias, wp, bp, dout = k6_inputs(B, N, h * d, h, 990 + i, device)
        label = f"tail {(B, N, h, d)} ({k6.bwd_plan(B, N, h * d, h)})"
        errs, _ = bwd_check(label, [x, wq, bq, bias, wp, bp], dout, h, d**-0.5)
        bwd["rows"].append({"shape": (B, N, h * d, h), "max_abs_err": errs})
        log(f"  attn_subblock_bwd {label}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + ", bit-identical over two runs")
    return fwd, bwd


class DeviceTimeMissing(RuntimeError):
    """A profiled call that recorded no device kernel, no device time, or not
    every kernel it was expected to launch."""


def split_records(records, calls: int, expect=()) -> tuple[dict[str, float], float]:
    """({device kernel: ms a call}, device kernels a call) from the profiler's
    ``(key, count, device_time_total in us)`` records of ``calls`` calls.
    Raises ``DeviceTimeMissing`` when no record has device time, or when a
    kernel named in ``expect`` is absent or has none."""
    split, launched = {}, 0
    for key, count, device_us in records:
        if device_us > 0:
            name = (re.findall(r"\w+_kernel", key) or [key])[0]
            if name == "gemm_kernel":  # K6's GEMM, by its epilogue
                name += "<" + ((re.findall(r"::(\w+Epi)>", key) or ["?"])[0]) + ">"
            split[name] = split.get(name, 0.0) + device_us / 1e3 / calls
            launched += count
    if not split:
        raise DeviceTimeMissing(f"no device time in {len(records)} profiler records "
                                f"{[key[:40] for key, _, _ in records[:6]]}")
    missing = [name for name in expect if not split.get(name, 0.0) > 0]
    if missing:
        raise DeviceTimeMissing(f"expected kernels {missing} absent from {sorted(split)}")
    return split, launched / calls


def profile_records(fn, calls: int, settle: float = 0.05) -> list[tuple[str, int, float]]:
    """``torch.profiler``'s (key, count, device_time_total) records of
    ``calls`` calls of ``fn``, the card synchronised inside the window and
    the window held open ``settle`` seconds more, so that the kernels'
    activity records reach the profiler before it stops (short takes of the
    port's kernels on the card sometimes came back without them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(settle)
    return [(e.key, e.count, e.device_time_total) for e in prof.key_averages()]


def kernel_split(fn, calls: int = 10, expect=(), take=profile_records, pause: float = 1.0
                 ) -> tuple[dict[str, float], float]:
    """``split_records`` of ``calls`` calls of ``fn`` (``take``: the
    profiler), taken once more when the first take has no device time or lacks
    an expected kernel; a second such take raises. The retake comes after the
    card has idled ``pause`` seconds and spans three times the calls: the
    takes that came back empty on the card were short (ten calls of ~0.05 ms
    kernels), followed another profiled call, and once came back empty twice
    in a row."""
    try:
        return split_records(take(fn, calls), calls, expect)
    except DeviceTimeMissing as exc:
        log(f"  kernel_split: {exc}; profiling once more")
    if pause:
        import torch

        torch.cuda.synchronize()
        time.sleep(pause)
    return split_records(take(fn, 3 * calls), 3 * calls, expect)


def launch_ms(fn, kernels, calls: int = 10) -> float:
    """Device ms a call of ``fn``, which launches each of ``kernels`` (names as
    ``split_records`` keys them) once: the sum of each kernel's mean duration
    a record. A take that lost some kernels' records (short takes on the card
    sometimes do) leaves the means unbiased where ``kernel_split``'s per-call
    sums fall short; a take without one of them is taken once more, then
    raises."""
    for attempt in range(2):
        records = profile_records(fn, calls if attempt == 0 else 3 * calls)
        total, count = {}, {}
        for key, n, device_us in records:
            if device_us > 0:
                name = (re.findall(r"\w+_kernel", key) or [key])[0]
                total[name] = total.get(name, 0.0) + device_us / 1e3
                count[name] = count.get(name, 0) + n
        if all(count.get(name) for name in kernels):
            return sum(total[name] / count[name] for name in kernels)
        log(f"  launch_ms: {sorted(set(kernels) - set(count))} absent from {sorted(count)}; "
            "profiling once more")
        import torch

        torch.cuda.synchronize()
        time.sleep(1.0)
    raise DeviceTimeMissing(f"expected kernels {list(kernels)} absent")


def k4_inputs(B, H, W, largest, seed, device):
    """Images in [0, 1) and angles within +-largest (both ends included when
    nonzero)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.rand(B, H, W, 3, generator=g).to(torch.bfloat16).to(device)
    thetas = ((torch.rand(B, generator=g) * 2 - 1) * largest).to(device)
    if largest:
        thetas[0], thetas[-1] = largest, -largest
    return x, thetas


def phase1_k4(device) -> dict:
    """K4 (one launch per rotation) against its plain version: bit-identical
    at every case, the plan the built kernel's; kernel (events and device
    time) and plain times at the B3 fine-tune canvas."""
    import torch

    from deepfakedetection_tpu_torch.ops import shear_rotate as k4
    from deepfakedetection_tpu_torch.profile_k4 import KERNELS

    rows, worst, timed = [], 0.0, {}
    for i, (B, H, W, max_theta, largest) in enumerate(K4_CASES):
        x, thetas = k4_inputs(B, H, W, largest, seed=300 + i, device=device)
        if k4.plan(H, W, 3, max_theta) != k4.kernel_plan(H, W, 3, max_theta):
            raise AssertionError(f"rotate_batch{(B, H, W)}: plan {k4.plan(H, W, 3, max_theta)} "
                                 "is not the kernel's")
        before = k4.rotate_batch.launches
        y = k4.rotate_batch(x, thetas, max_theta=max_theta)
        torch.cuda.synchronize()
        if k4.rotate_batch.launches != before + 1:
            raise AssertionError("rotate_batch did not launch its kernel")
        ref = k4.rotate_batch_plain(x, thetas, max_theta=max_theta)
        err = check_close(f"rotate_batch{(B, H, W)} theta<={largest}", y, ref, K4_TOL, 0.0)
        if not torch.equal(y, ref) or (not largest and not torch.equal(y, x)):
            raise AssertionError(f"rotate_batch{(B, H, W)}: not the plain version's output, "
                                 f"{float((y != ref).float().mean()):.2e} of the elements differ")
        worst = max(worst, err)
        row = {"shape": (B, H, W, 3), "max_theta": max_theta, "largest_angle": largest,
               "max_abs_err": err, "plan": vars(k4.plan(H, W, 3, max_theta))}
        if i == 0:  # the B3 fine-tune canvas
            call = lambda: k4.rotate_batch(x, thetas, max_theta=max_theta)  # noqa: E731
            row["ms"] = timed["ms"] = spread(cuda_times(call, runs=25))
            row["device_ms"] = timed["device_ms"] = launch_ms(call, KERNELS, calls=25)
            row["plain_ms"] = timed["plain_ms"] = spread(cuda_times(
                lambda: k4.rotate_batch_plain(x, thetas, max_theta=max_theta), runs=25))
        rows.append(row)
        log(f"  rotate_batch {(B, H, W, 3)} max_theta {max_theta}: bit-identical to the plain "
            f"version, plan {row['plan']}"
            + (f"; kernel {row['ms']['median']:.4f} ms (device {row['device_ms']:.4f}), plain "
               f"{row['plain_ms']['median']:.4f} ms" if "ms" in row else ""))
    B, H, W, _, _ = K4_CASES[0]
    n = B * H * W * 3
    bound_ms, bound_by = bound(2 * n * 2 + B * 4, {"f32": 3 * 2 * 2 * n})
    log(f"  rotate_batch bound at {(B, H, W, 3)}: {bound_ms:.4f} ms ({bound_by}), device time "
        f"{timed['device_ms'] / bound_ms:.1f}x off")
    return {"rows": rows, "max_abs_err": worst, "ms": timed["ms"]["median"],
            "device_ms": timed["device_ms"], "plain_ms": timed["plain_ms"]["median"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def k4_parent(parent: str | None) -> dict | None:
    """K4 of the checkout in ``parent`` against this one
    (``profile_k4.compare``): at ``K4_CASES[0]`` both times in turns, event
    and device; at every case the outputs must be bit-identical (raises
    otherwise). None without ``parent``."""
    if parent is None:
        log("  rotate_batch: the parent's kernel not measured (no --parent)")
        return None
    from deepfakedetection_tpu_torch import profile_k4

    rows = profile_k4.compare(parent)
    differ = [r["shape"] for r in rows if not r["bit_identical"]]
    if differ:
        raise AssertionError(f"rotate_batch: outputs not bit-identical to {parent}'s at {differ}")
    r = rows[0]
    log(f"  rotate_batch at {r['shape']}, in turns with {parent}'s: this {r['this_ms']:.4f} ms "
        f"(device {r['this_device_ms']:.4f}), the parent's {r['other_ms']:.4f} ms (device "
        f"{r['other_device_ms']:.4f}); device ratio "
        f"{r['this_device_ms'] / r['other_device_ms']:.3f}; bit-identical at every case")
    return {"tree": parent, "rows": rows}


def calibrate_bn(model, x) -> None:
    """Seeded weights with realistic BatchNorm statistics: each BN's running
    mean and variance become those of its conv's output over ``x`` (f32, one
    pass, each layer seeing the layers before it already calibrated)."""
    import torch
    import torch.nn.functional as F

    def conv_bn(cb, h):
        z = F.conv2d(F.pad(h, cb._fpad), cb.conv.weight, None, cb.conv.stride, cb._conv_pad,
                     1, cb.conv.groups)
        cb.bn.running_mean.copy_(z.mean(dim=(0, 2, 3)))
        cb.bn.running_var.copy_(z.var(dim=(0, 2, 3), unbiased=False))
        return cb(h)

    with torch.no_grad():
        h = conv_bn(model.stem, x.contiguous(memory_format=torch.channels_last))
        for blk in model._blocks:
            r = conv_bn(blk.expand, h) if blk.has_expand else h
            r = blk.se(conv_bn(blk.depthwise, r))
            r = conv_bn(blk.project, r)
            h = r + h if blk.residual else r
        conv_bn(model.head, h)


def seeded_images(n: int, g):
    """Normalized [n, 3, 224, 224] images whose brightness varies per image,
    as the phase-3 classes' do."""
    import torch

    offset = torch.rand(n, 1, 1, 1, generator=g) * 3.0 - 1.5
    return offset + 0.5 * torch.randn(n, 3, 224, 224, generator=g)


def fit_head(model, x, head=None) -> None:
    """A classifier (``head``, B3's ``_fc`` by default) along the first
    principal direction of the model's f32 features over ``x``, scaled so the
    logit difference has a standard deviation of 2 there: probabilities
    spread to a real operating point (a random head leaves them almost
    tied)."""
    import torch

    head = model._fc if head is None else head
    feats = []
    hook = head.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        model(x)
    hook.remove()
    f = feats[0].double()
    direction = torch.linalg.svd(f - f.mean(0), full_matrices=False).Vh[0]
    z = (f - f.mean(0)) @ direction
    scale = 2.0 / float(z.std())
    with torch.no_grad():
        head.weight.zero_()
        head.weight[1].copy_(scale * direction)
        head.bias.copy_(torch.tensor([0.0, -scale * float(f.mean(0) @ direction)]))


def seeded_b3_state(seed: int = 0):
    """Full-width B3 state dict: generator-seeded weights, BN statistics
    calibrated on a seeded batch, BN gamma and beta drawn near 1 and 0, and a
    head fitted to spread that batch's probabilities."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet

    g = torch.Generator().manual_seed(seed)
    model = create_efficientnet("b3", num_classes=2, dtype=torch.float32, generator=g).eval()
    x = seeded_images(8, g)
    calibrate_bn(model, x)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.2 * (torch.rand(n, generator=g) - 0.5))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
        # residual branches enter the stream at a fifth of its scale, as in
        # trained EfficientNets (a random net at unit branch scale amplifies
        # any rounding difference through the depth)
        for blk in model._blocks:
            if blk.residual:
                blk._bn2.weight.mul_(0.2)
                blk._bn2.bias.mul_(0.2)
    fit_head(model, x)
    return model.state_dict()


def check_logits(name: str, logits, bf16_ref, f32_ref, gate: float = 5e-2) -> dict[str, float]:
    """The card's bf16 logits against two CPU runs of the same weights on the
    same inputs: the bf16 model through the plain versions, which rounds
    where the kernels and the JAX package round, and the f32 model (the
    unfused chain). Each max|d| over the f32 logits' scale must stay under
    ``gate`` (5e-2 for B3; FasterViT's per configuration in ``FV_GATE``).
    For B3, bf16 rounding alone opens up to 3.3e-2 at full width (an H100
    against the CPU, phase 3's images): the random net carries a flipped
    bf16 rounding of an SE input or gate, which moves a whole channel,
    through the depth. Wrong wiring moves the phase-2 logits
    further: 6.6e-2 with one block's SE gate dropped, 0.13 with K2's halo
    expanded from zero-padded x, 0.75 with one residual dropped. The kernels'
    rounding points are phase 1's to hold. The probabilities must spread,
    with the f32 argmax on every row whose f32 probability margin is over
    5e-2 (at least half of them)."""
    import torch

    logits, bf16_ref, f32_ref = logits.double(), bf16_ref.double(), f32_ref.double()
    if not torch.isfinite(logits).all() or logits.shape != f32_ref.shape:
        raise AssertionError(f"{name}: bad output {logits}")
    scale = f32_ref.abs().max()
    rel16 = float((logits - bf16_ref).abs().max() / scale)
    rel32 = float((logits - f32_ref).abs().max() / scale)
    p_ref = torch.softmax(f32_ref, dim=-1)
    decided = (p_ref[:, 1] - p_ref[:, 0]).abs() > 5e-2
    same = bool((logits.argmax(-1) == f32_ref.argmax(-1))[decided].all())
    spread = float(p_ref[:, 1].max() - p_ref[:, 1].min())
    log(f"  {name}: max|dlogit|/scale {rel16:.3e} against bf16 CPU, {rel32:.3e} against "
        f"f32 CPU; p1 spread {spread:.3f}; {int(decided.sum())}/{len(f32_ref)} rows decided, "
        f"argmax equal there: {same}")
    if max(rel16, rel32) > gate or spread < 0.3 or 2 * int(decided.sum()) < len(f32_ref) \
            or not same:
        raise AssertionError(f"{name} disagrees with the CPU references: {logits} vs "
                             f"{bf16_ref} (bf16) and {f32_ref} (f32)")
    return {"max_rel_dlogit_bf16": rel16, "max_rel_dlogit_f32": rel32, "p1_spread": spread,
            "decided": int(decided.sum())}


def cpu_logits(state, x):
    """CPU logits of the B3 weights: bf16 through the plain versions, then
    f32 through the unfused chain."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet

    out = []
    for dtype in (torch.bfloat16, torch.float32):
        model = create_efficientnet("b3", num_classes=2, dtype=dtype).eval()
        model.load_state_dict(state)
        with torch.no_grad():
            out.append(model(x).float())
    return out


def phase2(device, report, state):
    """Full-width B3: bf16 on the card through the kernels against bf16 and
    f32 on the CPU; forward times with the kernels and the plain versions."""
    import torch

    from deepfakedetection_tpu_torch.models import common, efficientnet
    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.ops import expand_dw as k2

    model = efficientnet.create_efficientnet("b3", num_classes=2, dtype=torch.bfloat16)
    model.load_state_dict(state)
    model = model.to(device).eval()
    expect = model.kernel_launches_per_forward()

    g = torch.Generator().manual_seed(1)
    x = seeded_images(8, g)
    with torch.no_grad():
        logits, n = counted(lambda: model(x.to(device).to(torch.bfloat16)))
        launches = {k: n[k] for k in ("k1", "k2", "k3")}
    agree = check_logits("B3 forward (card, bf16)", logits.float().cpu(), *cpu_logits(state, x))
    log(f"  launches per forward: K1={launches['k1']} K2={launches['k2']} (expected {expect})")
    if launches != expect or expect != {"k1": 2, "k2": 20, "k3": 0}:
        raise AssertionError(f"launches per forward {launches}, expected {expect}")

    timings = {}
    plain_k1, plain_k2 = k1.depthwise_silu_pool_plain, k2.expand_dw_silu_pool_plain
    for batch in (128, 256):
        xb = torch.randn(batch, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            t_k = spread(cuda_times(lambda: model(xb), runs=12))
            common.depthwise_silu_pool, efficientnet.expand_dw_silu_pool = plain_k1, plain_k2
            try:
                t_p = spread(cuda_times(lambda: model(xb), runs=12))
            finally:
                common.depthwise_silu_pool = k1.depthwise_silu_pool
                efficientnet.expand_dw_silu_pool = k2.expand_dw_silu_pool
        timings[batch] = {
            "kernels_ms": t_k, "plain_ms": t_p,
            "img_per_s": batch / (t_k["median"] / 1e3),
            "plain_img_per_s": batch / (t_p["median"] / 1e3),
        }
        log(f"  B3 forward batch {batch}: {t_k['median']:.3f} ms "
            f"(q1 {t_k['q1']:.3f}, q3 {t_k['q3']:.3f}) = {timings[batch]['img_per_s']:.1f} img/s;"
            f" plain versions in place: {t_p['median']:.3f} ms = "
            f"{timings[batch]['plain_img_per_s']:.1f} img/s")
    report["phase2"] = {**agree, "launches_per_forward": launches, "timings": timings}


def write_jpeg_tree(root: Path, counts: dict[str, int], seed: int) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        for ci, cls in enumerate(("fake", "real")):
            d = root / split / cls
            d.mkdir(parents=True, exist_ok=True)
            for i in range(n // 2):
                h, w = int(rng.integers(200, 320)), int(rng.integers(200, 320))
                base = 80 if ci == 0 else 170
                arr = rng.normal(base, 50, (h, w, 3)).clip(0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"i{i:04d}.jpg", quality=90)


def eval_config(work: Path, name: str, model: str, out: str, weights: Path, batch: int,
                device, data: Path | None = None) -> Path:
    """Writes ``work / name``: a YAML config that evaluates ``model`` from
    ``weights`` over the JPEG tree ``work / "data"`` (or ``data``) at ``batch``,
    224 px, with runs under ``work / out``."""
    import yaml

    cfg = {
        "seed": 1,
        "device": str(device),
        "data": {"root": str(data or work / "data"), "test_split": "test", "val_split": "val",
                 "num_classes": 2, "img_size": 224},
        "models": {model: {
            "output_dir": str(work / out),
            "transforms": {"eval": EVAL_TF},
            "inference": {"weights": str(weights), "split": "test", "batch_size": batch,
                          "num_workers": 8, "img_size": 224},
        }},
        "selection": [model],
    }
    path = work / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase3(device, report, state):
    """The main path: orchestrate(mode="inference") from a YAML config."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.ops import expand_dw as k2
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    counts = SPLITS
    write_jpeg_tree(data, counts, seed=3)
    weights = work / "efficientnet_b3_seeded.pth"
    torch.save(state, weights)
    cfg_path = eval_config(work, "inference.yaml", "efficientnet_b3", "runs", weights,
                           EVAL_BATCH, device)

    k1.depthwise_silu_pool.launches = k2.expand_dw_silu_pool.launches = 0
    t0 = time.perf_counter()
    results = orchestrate(cfg_path, mode="inference")
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1": k1.depthwise_silu_pool.launches, "k2": k2.expand_dw_silu_pool.launches}

    res = results["efficientnet_b3"]
    batches = sum(-(-n // EVAL_BATCH) for n in counts.values())
    if launches != {"k1": 2 * batches, "k2": 20 * batches}:
        raise AssertionError(f"main path launches {launches}, expected 2 and 20 x {batches}")
    if res.probs.shape != (counts["test"], 2) or not np.isfinite(res.probs).all():
        raise AssertionError(f"bad test probabilities {res.probs.shape}")
    if not np.allclose(res.probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError("probabilities do not sum to 1")
    runs = sorted((work / "runs").iterdir())
    lines = (runs[-1] / "logs" / "metrics.jsonl").read_text().splitlines()
    record = json.loads(lines[-1])
    want = {"model", "split", "accuracy", "timestamp", "roc_auc", "threshold",
            "confusion_matrix"}
    if set(record) != want:
        raise AssertionError(f"metrics.jsonl fields {sorted(record)} != {sorted(want)}")
    np.save(work / "test_probs.npy", res.probs)  # phase 15's job over shards must equal them
    agree = reference_check(res, data, lambda x: cpu_logits(state, x))
    summary = {"model": "efficientnet_b3", "split": "test", "accuracy": res.metrics["accuracy"]}
    decode = decode_rate(data)
    # device time of the test pass, from phase 2's forward, over its wall time
    busy = (report["phase2"]["timings"][EVAL_BATCH]["kernels_ms"]["median"] / 1e3
            * -(-counts["test"] // EVAL_BATCH) * res.images_per_s / counts["test"])
    log(f"  summary {json.dumps(summary)}; threshold {res.metrics['threshold']}; "
        f"test pass {res.images_per_s:.1f} img/s (decode included); the loader alone "
        f"{decode:.1f} img/s; device busy share of the test pass ~{busy:.3f} (phase 2's "
        f"forward time x batches / pass time); wall {wall:.1f} s")
    log(f"  launches in the main path: K1={launches['k1']} K2={launches['k2']} over "
        f"{batches} batches")
    report["phase3"] = {"launches": launches, "batches": batches, "metrics": record,
                        "test_img_per_s": res.images_per_s, "loader_img_per_s": decode,
                        "device_busy_share_est": busy, "wall_s": wall, "reference": agree}
    return launches


def decode_rate(data: Path) -> float:
    """Images per second of the eval loader alone over the test split: PIL
    decode, resize and crop in 8 host threads, as the job runs it."""
    from deepfakedetection_tpu_torch.data.pipeline import (
        build_eval_plan,
        make_eval_loader,
        scan_image_folder,
    )

    loader = make_eval_loader(scan_image_folder(data / "test"), build_eval_plan(224, EVAL_TF),
                              batch_size=EVAL_BATCH, num_workers=8)
    t0 = time.perf_counter()
    n = sum(int(batch.mask.sum()) for batch in loader)
    return n / (time.perf_counter() - t0)


def test_picks(data: Path) -> list[int]:
    """The 16 test images ``reference_check`` reads: the first and last 8."""
    from deepfakedetection_tpu_torch.data.pipeline import scan_image_folder

    n = len(scan_image_folder(data / "test"))
    return list(range(8)) + list(range(n - 8, n))


def test_images(data: Path):
    """``test_picks``' images decoded and normalized as the eval job does (NCHW f32)."""
    import torch

    from deepfakedetection_tpu_torch.data.augment import normalize_batch
    from deepfakedetection_tpu_torch.data.pipeline import (
        build_eval_plan,
        make_eval_loader,
        scan_image_folder,
    )

    plan = build_eval_plan(224, EVAL_TF)
    ds = scan_image_folder(data / "test")
    picked = test_picks(data)
    ds = dataclasses.replace(ds, samples=[ds.samples[i] for i in picked])
    batch = next(iter(make_eval_loader(ds, plan, batch_size=len(picked))))
    return normalize_batch(torch.from_numpy(batch.images), plan)


def reference_check(res, data: Path, refs_of, gate: float = 5e-2) -> dict[str, float]:
    """The job's outputs for 16 test images, the first and last 8 (both
    classes), against ``refs_of(x)``, the CPU's (bf16, f32) logits over the
    same decoded pixels, as logit differences log(p1 / p0): what the job's
    probabilities keep of the logits."""
    import torch

    refs = refs_of(test_images(data))
    p = torch.from_numpy(res.probs[test_picks(data)]).double()
    got = torch.stack([torch.zeros(len(p), dtype=p.dtype), p[:, 1].log() - p[:, 0].log()], -1)
    return check_logits("main path (card), 16 test images", got,
                        *(r.double() - r[:, :1].double() for r in refs), gate=gate)


def train_config(work: Path, data: Path, device, epochs: int, **training) -> Path:
    import yaml

    cfg = {
        "seed": 1,
        "device": str(device),
        "data": {"root": str(data), "train_split": "train", "val_split": "val",
                 "test_split": "test", "num_classes": 2, "img_size": 224},
        "models": {"efficientnet_b3": {
            "output_dir": str(work / "runs"),
            "transforms": {"train": TRAIN_TF, "eval": EVAL_TF},
            "training": {"epochs": epochs, "batch_size": 64, "num_workers": 8,
                         "resume": "continue", **training},
            "inference": {"weights": "auto", "split": "test", "batch_size": 64,
                          "num_workers": 8, "img_size": 224},
        }},
        "selection": ["efficientnet_b3"],
    }
    path = work / f"train_{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def counted(fn):
    """Runs ``fn`` with every kernel's launch count at 0 before it and reads
    them after it: (fn's result, {"k1", "k2", "k3", "k4", "k5", "k5_bwd",
    "k6", "k6_bwd", "k7"})."""
    import torch

    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.ops import attn_block as k6
    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.ops import expand_dw as k2
    from deepfakedetection_tpu_torch.ops import fused_mbconv as k3
    from deepfakedetection_tpu_torch.ops import shear_rotate as k4
    from deepfakedetection_tpu_torch.ops import window_attn as k5

    k1.depthwise_silu_pool.launches = k2.expand_dw_silu_pool.launches = 0
    k3.fused_mbconv_se.launches = k4.rotate_batch.launches = k5.window_attention.launches = 0
    k5.window_attention_bwd.launches = k7.attn4d.launches = 0
    k6.attn_subblock.launches = k6.attn_subblock_bwd.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"k1": k1.depthwise_silu_pool.launches, "k2": k2.expand_dw_silu_pool.launches,
                 "k3": k3.fused_mbconv_se.launches,
                 "k4": k4.rotate_batch.launches, "k5": k5.window_attention.launches,
                 "k5_bwd": k5.window_attention_bwd.launches, "k6": k6.attn_subblock.launches,
                 "k6_bwd": k6.attn_subblock_bwd.launches, "k7": k7.attn4d.launches}


def logged_speeds(log_text: str) -> dict[str, float]:
    """img/s of each warmup and fine-tune epoch from ``train.log``."""
    return {m.group(1): float(m.group(2)) for m in
            re.finditer(r"^\s+((?:warmup|epoch) \d+/\d+): loss=\S+ \| ([\d.]+) img/s", log_text,
                        re.MULTILINE)}


def phase4(device, report):
    """The training path: orchestrate(mode="training") at full width, then a
    resume and the inference handoff; the card's step against the CPU's."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    write_jpeg_tree(data, TRAIN_SPLITS, seed=5)
    n_train, n_val = TRAIN_SPLITS["train"], TRAIN_SPLITS["val"]
    warmup_steps, ft_steps = n_train // 64, n_train // 128
    val_batches = -(-n_val // 64)

    t0 = time.perf_counter()
    res, launches = counted(lambda: orchestrate(train_config(work, data, device, 1),
                                                mode="training")["efficientnet_b3"])
    wall = time.perf_counter() - t0
    steps = warmup_steps + ft_steps
    per_forward = create_efficientnet("b3").eval().kernel_launches_per_forward()
    want = {"k1": per_forward["k1"] * 2 * val_batches, "k2": per_forward["k2"] * 2 * val_batches,
            "k3": 0, "k4": steps, "k5": 0, "k5_bwd": 0, "k6": 0, "k6_bwd": 0, "k7": 0}
    log(f"  training (1 epoch): {steps} train steps, {2 * val_batches} val batches; launches "
        f"K4={launches['k4']} K1={launches['k1']} K2={launches['k2']}; wall {wall:.1f} s")
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected {want}")
    (run,) = sorted((work / "runs").iterdir())
    ckpts = run / "checkpoints"
    for name in ("latest.ckpt", "best.ckpt", "efficientnet_b3.pth"):
        if not (ckpts / name).is_file():
            raise AssertionError(f"training wrote no {name}")
    log_text = (run / "logs" / "train.log").read_text()
    speeds = logged_speeds(log_text)
    records = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [float(x) for x in re.findall(r": loss=(\S+) \|", log_text)]
    if len(losses) != 2 or not all(np.isfinite(losses)) or res.interrupted:
        raise AssertionError(f"bad training run: losses {losses}, {res}")

    res2, launches2 = counted(lambda: orchestrate(train_config(work, data, device, 2),
                                                  mode="training")["efficientnet_b3"])
    state = torch.load(ckpts / "latest.ckpt", weights_only=True)
    log_text2 = (run / "logs" / "train.log").read_text()
    records = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    if ("atepoch1(best=" not in "".join(log_text2.split())  # the console wraps lines
            or res2.epochs_run != 1 or state["counters"]["epoch"] != 1
            or [r["epoch"] for r in records] != [1, 2]
            or launches2["k4"] != ft_steps
            or not all(np.isfinite(r["train_loss"]) for r in records)):
        raise AssertionError(f"resume: {res2}, counters {state['counters']}, records {records}, "
                             f"launches {launches2}")
    speeds.update(logged_speeds(log_text2))
    log(f"  resume from latest.ckpt ran epoch 2 only ({ft_steps} steps, K4={launches2['k4']}); "
        f"losses {[round(x, 4) for x in losses]} then {records[-1]['train_loss']}; "
        f"img/s (host clock, device synced at each epoch's end) {speeds}")

    ires, ilaunch = counted(lambda: orchestrate(train_config(work, data, device, 2),
                                                mode="inference")["efficientnet_b3"])
    if ires.probs.shape != (TRAIN_SPLITS["test"], 2) or not np.isfinite(ires.probs).all() \
            or ilaunch["k2"] != per_forward["k2"] * (-(-TRAIN_SPLITS["test"] // 64) + val_batches):
        raise AssertionError(f"inference on the trained weights: {ires.probs.shape} {ilaunch}")
    log(f"  inference with weights: auto ({ckpts / 'efficientnet_b3.pth'}): accuracy "
        f"{ires.metrics['accuracy']:.4f}, K1={ilaunch['k1']} K2={ilaunch['k2']}")

    agree = step_against_cpu(device)
    timing = step_times(device)
    report["phase4"] = {"launches": launches, "resume_launches": launches2,
                        "train_steps": steps, "losses": losses, "records": records,
                        "logged_img_per_s": speeds, "wall_s": wall, "cpu_check": agree,
                        "step_times": timing}
    return launches


def seeded_train_inputs(n: int):
    """A seeded B3 model's state, n uint8 canvases of 257 px and one set of
    augmentation draws for them, on the CPU."""
    import torch

    from deepfakedetection_tpu_torch.data import augment
    from deepfakedetection_tpu_torch.data.pipeline import build_train_plan
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.registry import get_model_spec

    recipe = get_model_spec("efficientnet_b3").recipe
    plan = build_train_plan(224, TRAIN_TF, recipe_defaults=recipe.default_train_toggles,
                            jitter_params=recipe.color_jitter)
    g = torch.Generator().manual_seed(9)
    state = create_efficientnet("b3", num_classes=2, dtype=torch.float32,
                                generator=g).state_dict()
    S = plan.host_canvas_size
    images = torch.randint(0, 256, (n, S, S, 3), generator=g, dtype=torch.uint8)
    params = augment.sample_params(g, plan, n, S, S)
    return state, images, params, plan


def one_step(state, images, params, plan, device, dtype, mix=None, class_weights=None):
    """One fine-tune step from ``state`` on ``device`` (dropout and
    drop-path off; ``mix`` a mixup draw, ``class_weights`` the CE's): the
    augmented batch, the loss and the updated state, returned on the CPU."""
    import dataclasses

    import torch

    from deepfakedetection_tpu_torch.data import augment
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    model = create_efficientnet("b3", num_classes=2, dtype=dtype, dropout_rate=0.0,
                                drop_connect_rate=0.0)
    model.load_state_dict(state)
    model = model.to(device)
    p = augment.AugParams(**{f.name: getattr(params, f.name).to(device)
                             for f in dataclasses.fields(params)})
    x = augment.apply_augment(images.to(device), p, plan, out_dtype=dtype)
    opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    labels = torch.arange(len(images), device=device) % 2
    if class_weights is not None:
        class_weights = torch.tensor(class_weights, device=device)
    out = train_step(model, opt, x, labels, torch.ones_like(labels, dtype=torch.bool), None,
                     mix=mix, class_weights=class_weights)
    return (x.float().cpu(), float(out["loss"]),
            {k: v.float().cpu() for k, v in model.state_dict().items()})


BN_DECAY = 0.99  # the B3 BatchNorms' running-statistics decay (JAX convention)


def batch_stats(after: dict, before: dict) -> dict:
    """Each BatchNorm's batch statistics of one train step, recovered from
    its running statistics: (after - decay * before) / (1 - decay), in f64."""
    return {k: (after[k].double() - BN_DECAY * before[k].double()) / (1.0 - BN_DECAY)
            for k in before if k.endswith(("running_mean", "running_var"))}


def stats_gaps(card: dict, cpu: dict) -> tuple[float, float]:
    """The worst BatchNorm's batch-mean difference over the largest batch
    standard deviation of its channels, and batch-variance difference over
    the largest batch variance of its channels (the CPU's as the scale)."""
    dmean = dvar = 0.0
    for k, var in cpu.items():
        if k.endswith("running_var"):
            mk = k[: -len("var")] + "mean"
            dmean = max(dmean, float((card[mk] - cpu[mk]).abs().max() / var.max().sqrt()))
            dvar = max(dvar, float((card[k] - var).abs().max() / var.max()))
    return dmean, dvar


def step_readings(state, images, params, plan, device, dtype) -> dict:
    """One step on the card and on the CPU from the same inputs (TF32 off on
    the card in f32): the losses, the augmented batches, the updated
    weights in units of lr, the batch statistics."""
    import torch

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x_card, loss_card, sd_card = one_step(state, images, params, plan, device, dtype)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    t0 = time.perf_counter()
    x_cpu, loss_cpu, sd_cpu = one_step(state, images, params, plan, torch.device("cpu"), dtype)
    cpu_s = time.perf_counter() - t0
    units = torch.cat([((sd_card[k] - sd_cpu[k]).abs() / 1e-4).flatten()
                       for k in sd_cpu if "running" not in k and "num_batches" not in k])
    dmean, dvar = stats_gaps(batch_stats(sd_card, state), batch_stats(sd_cpu, state))
    return {"loss_card": loss_card, "loss_cpu": loss_cpu,
            "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
            "max_abs_dx": float((x_card - x_cpu).abs().max()),
            "max_dw_over_lr": float(units.max()),
            "share_dw_over_0.1lr": float((units > 0.1).float().mean()),
            "share_dw_over_0.5lr": float((units > 0.5).float().mean()),
            "batch_mean_gap": dmean, "batch_var_gap": dvar, "cpu_step_s": cpu_s}


# the bounds of step_against_cpu, each set between the sound reading and a
# wrong variant's (H100 80GB HBM3 against its host's CPU, batch 8):
#   f32 loss 1.0e-5 sound, 5.1e-5 with the card keeping the unbiased variance;
#   f32 batch means 1.5e-4 of the std sound, 1.0e-3 unbiased;
#   f32 batch variances 8.1e-4 of their scale sound (the one-pass variance
#   cancels where a channel's mean dwarfs its spread), 2.1e-3 unbiased;
#   bf16 weights beyond 0.5 lr 23.5% sound, 27.0% with the card's normalise
#   y*a+b in f32 (a dropped bf16 rounding); no bf16 reading tells the unbiased
#   variance apart, so the bf16 loss and statistics bounds catch gross faults
#   only (sound 3.6e-3, 2.5e-2 and 0.15). 2.01 lr: Adam's first step moves a
#   weight by about lr, so a gradient whose sign differs moves it by 2 lr.
STEP_BOUNDS = {
    "f32": {"loss_rel": 2.5e-5, "max_dw_over_lr": 2.01, "share_dw_over_0.1lr": 1e-2,
            "batch_mean_gap": 4e-4, "batch_var_gap": 1.3e-3},
    "bf16": {"loss_rel": 1e-2, "max_dw_over_lr": 2.01, "share_dw_over_0.5lr": 0.25,
             "batch_mean_gap": 5e-2, "batch_var_gap": 0.3},
}


def step_against_cpu(device) -> dict:
    """One train step of the full-width B3 on the card and on the CPU from
    the same weights, canvases and augmentation draws (K4 on the card, its
    plain version on the CPU), batch 8, held to ``STEP_BOUNDS``. Weights are
    compared in units of lr, and the share of weights that moved apart
    counts the gradients whose signs differ. The batch statistics are
    recovered from the running ones (``batch_stats``), which move by only a
    hundredth of them in one step."""
    import torch

    state, images, params, plan = seeded_train_inputs(8)
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        row = out[name] = step_readings(state, images, params, plan, device, dtype)
        log(f"  one step, card against CPU ({name}, batch 8): loss {row['loss_card']:.6f} / "
            f"{row['loss_cpu']:.6f} (rel {row['loss_rel']:.2e}); augmented batch max|d| "
            f"{row['max_abs_dx']:.2e}; weights max|d|/lr {row['max_dw_over_lr']:.3f}, "
            f"{row['share_dw_over_0.1lr']:.2e} beyond 0.1 lr, {row['share_dw_over_0.5lr']:.2e} "
            f"beyond 0.5 lr; batch means {row['batch_mean_gap']:.2e} of the std, batch "
            f"variances {row['batch_var_gap']:.2e} of their scale; CPU step "
            f"{row['cpu_step_s']:.1f} s")
        over = {k: (row[k], bound) for k, bound in STEP_BOUNDS[name].items() if not row[k] <= bound}
        if over or not math.isfinite(row["loss_card"]):
            raise AssertionError(f"the card's {name} train step disagrees with the CPU's: "
                                 f"{over} (reading, bound); {row}")
    return out


def step_times(device) -> dict:
    """The bf16 B3 train step (forward, backward, AdamW over every tensor) on
    the card at batch 64 and 128: CUDA events, median and quartiles."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    g = torch.Generator().manual_seed(4)
    model = create_efficientnet("b3", num_classes=2, generator=g).to(device)
    opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    root = root_generator(4)
    out = {}
    for batch in (64, 128):
        x = torch.randn(batch, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        labels = (torch.arange(batch) % 2).to(device)
        mask = torch.ones(batch, dtype=torch.bool, device=device)
        torch.cuda.reset_peak_memory_stats(device)
        t = spread(cuda_times(lambda: train_step(
            model, opt, x, labels, mask, fold_in(root, opt.count, device=device)), runs=10))
        out[batch] = {"step_ms": t, "img_per_s": batch / (t["median"] / 1e3),
                      "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        log(f"  train step batch {batch}: {t['median']:.3f} ms (q1 {t['q1']:.3f}, q3 "
            f"{t['q3']:.3f}) = {out[batch]['img_per_s']:.1f} img/s; peak "
            f"{out[batch]['peak_gib']:.1f} GiB")
    return out


# max|dlogit| / scale of FasterViT-2's bf16 logits on the card against the
# CPU's bf16 and f32 runs (the weights of seeded_fastervit_state, 8 seeded
# images), per head configuration. Sound: 1.7e-3 official and 5.7e-4 tpu,
# CPU bf16 against CPU f32. Wrong variants of the attention, on the CPU in
# bf16 against the sound f32 logits (tests/test_torch_fastervit.py holds
# both sides of each gate): the scale times 1.5 3.0e-2 official and 5.8e-3
# tpu, doubled 6.7e-2 and 1.2e-2, the bias dropped 8.0e-2 official, one
# head's values for every head 0.83 and 0.17. Each gate sits near the
# geometric middle of its sound reading and its mildest caught fault.
# Weaker faults (the tpu bias dropped 8.8e-4, the heads' biases reversed or
# transposed, the carrier tokens in the wrong order) stay within a few
# times the sound spread: K5's own check is phase 1's, and the CPU tests
# hold the model to the JAX package in f32.
FV_GATE = {"official": 1e-2, "tpu": 3e-3}


def seeded_fastervit_state(config: str, seed: int):
    """Full-width FasterViT-2 state dict of ``config`` (the official one in
    the wheel's key names): generator-seeded weights, the transformer blocks'
    dense layers at unit gain (N(0, 1/fan_in): the 0.02 init leaves the
    attention branches too small to move the logits); the conv stages'
    BatchNorm statistics calibrated on a seeded batch (batch statistics of
    each ConvBN in turn, at decay 0) and their residual branches entering at
    a fifth of the stream's scale; the final BatchNorm's statistics those of
    the last block's tokens; the tpu configuration's layer scales at 0.2 (its
    init, 1e-5, would leave the blocks silent) and its bias tables drawn; a
    head fitted to spread the batch's probabilities."""
    import torch
    from torch import nn

    from deepfakedetection_tpu_torch.models.common import Linear, bn_momentum_override
    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit

    g = torch.Generator().manual_seed(seed)
    model = create_faster_vit("2", head_config=config, dtype=torch.float32, generator=g).eval()
    x = seeded_images(8, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / m.in_features**0.5)
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith(("gamma", "hat_gamma")):
                p.fill_(0.2)
            elif name.endswith("rel_bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d) and m is not model.norm]
        for m in bns:
            m.train()
        tokens = []
        hook = model.levels[3].blocks[-1].register_forward_hook(
            lambda _m, _i, out: tokens.append(out))
        with bn_momentum_override(0.0):
            model(x)
        hook.remove()
        for m in bns:
            m.eval()
        y = tokens[0].double()
        model.norm.running_mean.copy_(y.mean(dim=(0, 1)))
        model.norm.running_var.copy_(y.var(dim=(0, 1), unbiased=False))
        for level in model.levels[:2]:
            for blk in level.blocks:
                blk.norm2.weight.mul_(0.2)
                blk.norm2.bias.mul_(0.2)
    fit_head(model, x, model.head)
    return model.state_dict()


def fastervit_logits(state, config: str, x, device, dtype):
    """FasterViT-2 logits of ``state`` on ``device`` in ``dtype``, f32 on the
    CPU."""
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit

    model = create_faster_vit("2", head_config=config, dtype=dtype)
    model.load_state_dict(state)
    model = model.to(device).eval()
    with torch.no_grad():
        return model(x.to(device)).float().cpu()


def fastervit_against_cpu(device, config: str, state, x) -> dict:
    """The card's bf16 logits of ``state`` against the CPU's bf16 (the
    kernels' plain versions) and f32 runs on ``x``; K5 launches once per
    attention over 32 or more tokens (13), or with ``DFD_FUSED_ATTN`` K6 once
    per attention (21)."""
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit

    want = create_faster_vit("2", head_config=config).kernel_launches_per_forward()
    card, n = counted(lambda: fastervit_logits(state, config, x, device, torch.bfloat16))
    if want not in ({"k5": 13, "k6": 0}, {"k5": 0, "k6": K6_LAUNCHES}) \
            or {k: n[k] for k in want} != want:
        raise AssertionError(f"{config} forward: launches {n}, expected {want}")
    cpu = [fastervit_logits(state, config, x, torch.device("cpu"), dt)
           for dt in (torch.bfloat16, torch.float32)]
    return check_logits(f"FasterViT-2 {config} forward (card, bf16)", card, *cpu,
                        gate=FV_GATE[config])


def forward_times(label: str, kernel: str, model, module, attr: str, plain, g, device) -> dict:
    """The bf16 eval forward of ``model`` at batch 128 and 256 on random
    images (CUDA events, median and quartiles of 10), with the kernel wrapper
    ``module.attr`` and with its plain version ``plain`` in its place."""
    import torch

    wrapper = getattr(module, attr)
    timings = {}
    for batch in (128, 256):
        xb = torch.randn(batch, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            t_k = spread(cuda_times(lambda: model(xb), runs=10))
            setattr(module, attr, plain)
            try:
                t_p = spread(cuda_times(lambda: model(xb), runs=10))
            finally:
                setattr(module, attr, wrapper)
        timings[batch] = {"kernel_ms": t_k, "plain_ms": t_p,
                          "img_per_s": batch / (t_k["median"] / 1e3),
                          "plain_img_per_s": batch / (t_p["median"] / 1e3)}
        log(f"  {label} forward batch {batch}: {t_k['median']:.3f} ms (q1 {t_k['q1']:.3f}, q3 "
            f"{t_k['q3']:.3f}) = {timings[batch]['img_per_s']:.1f} img/s; {kernel}'s plain "
            f"version in place: {t_p['median']:.3f} ms (q1 {t_p['q1']:.3f}, q3 {t_p['q3']:.3f}) "
            f"= {timings[batch]['plain_img_per_s']:.1f} img/s")
    return timings


def phase5(device, report):
    """The FasterViT-2 eval path: orchestrate(mode="inference") from a YAML
    config on a wheel-named seeded .pth (official config), at batch 256."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models import fastervit
    from deepfakedetection_tpu_torch.ops import window_attn as k5
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke"
    data = work / "data"  # phase 3's tree
    state = seeded_fastervit_state("official", seed=11)
    weights = work / "faster_vit_2_224_seeded.pth"
    torch.save(state, weights)
    cfg_path = eval_config(work, "inference_fastervit.yaml", FV, "runs_fv", weights, FV_BATCH,
                           device)
    t0 = time.perf_counter()
    res, launches = counted(lambda: orchestrate(cfg_path, mode="inference")[FV])
    wall = time.perf_counter() - t0
    batches = sum(-(-n // FV_BATCH) for n in SPLITS.values())
    want = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 13 * batches, "k5_bwd": 0, "k6": 0,
            "k6_bwd": 0, "k7": 0}
    log(f"  main path: {batches} forward batches, launches {launches}; test pass "
        f"{res.images_per_s:.1f} img/s (decode included); wall {wall:.1f} s")
    if launches != want:
        raise AssertionError(f"FasterViT main path launches {launches}, expected {want}")
    if res.probs.shape != (SPLITS["test"], 2) or not np.isfinite(res.probs).all() \
            or not np.allclose(res.probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad test probabilities {res.probs.shape}")
    (run,) = sorted((work / "runs_fv").iterdir())
    record = json.loads((run / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
    if record["model"] != FV or "roc_auc" not in record:
        raise AssertionError(f"metrics.jsonl: {record}")
    agree = reference_check(res, data, lambda x: [
        fastervit_logits(state, "official", x, torch.device("cpu"), dt)
        for dt in (torch.bfloat16, torch.float32)], gate=FV_GATE["official"])

    g = torch.Generator().manual_seed(12)
    x = seeded_images(8, g)
    against = {"official": fastervit_against_cpu(device, "official", state, x),
               "tpu": fastervit_against_cpu(device, "tpu", seeded_fastervit_state("tpu", 13), x)}

    model = fastervit.create_faster_vit("2", head_config="official")
    model.load_state_dict(state)
    timings = forward_times("FasterViT-2 official", "K5", model.to(device).eval(), fastervit,
                            "window_attention", k5.window_attention_plain, g, device)
    report["phase5"] = {"launches": launches, "batches": batches, "metrics": record,
                        "test_img_per_s": res.images_per_s, "wall_s": wall,
                        "reference": agree, "against_cpu": against, "timings": timings}
    return launches


FV_TRAIN_TF = {"ensure_rgb": True, "train_random_resized_crop": True,
               "train_random_horizontal_flip": True, "train_color_jitter": True}  # the shipped
FV_STEP_BATCH = 4  # images of the card-against-CPU step (full width, 224 px)


def fv_train_config(work: Path, data: Path, device, runs: str = "runs_fv",
                    init_weights: Path | None = None, epochs: int = 1,
                    training: dict | None = None, profile_dir: Path | None = None) -> Path:
    """The shipped FasterViT-2 block of ``config/train.yaml`` (its transforms,
    batch 64, the recipe's warmup and fine-tune) for ``epochs`` over ``data``,
    into ``work / runs``, from ``init_weights`` when given, with more
    ``training`` keys and a ``profile_dir`` when given."""
    import yaml

    cfg = {
        "seed": 1,
        "device": str(device),
        "data": {"root": str(data), "train_split": "train", "val_split": "val",
                 "test_split": "test", "num_classes": 2, "img_size": 224},
        "models": {FV: {
            "output_dir": str(work / runs),
            "transforms": {"train": FV_TRAIN_TF, "eval": EVAL_TF},
            "training": {"epochs": epochs, "batch_size": 64, "num_workers": 8,
                         "resume": "auto",
                         **({"init_weights": str(init_weights)} if init_weights else {}),
                         **(training or {})},
            "inference": {"weights": "auto", "split": "test", "batch_size": 64,
                          "num_workers": 8, "img_size": 224},
        }},
        "selection": [FV],
        **({"profile_dir": str(profile_dir)} if profile_dir else {}),
    }
    path = work / f"train_{runs}_{epochs}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase6(device, report):
    """The FasterViT-2 training path: orchestrate(mode="training") with the
    shipped recipe over phase 4's tree (tpu configuration, as the shipped
    config builds it), the inference handoff, the card's step against the
    CPU's in both head configurations, and the step's time."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.ops import window_attn as k5
    from deepfakedetection_tpu_torch.orchestrator import orchestrate
    from deepfakedetection_tpu_torch.runtime.convert import fastervit_head_config
    from deepfakedetection_tpu_torch.train import loop

    work = REPO / "build" / "chip_smoke_train"
    data = work / "data"  # phase 4's tree
    shutil.rmtree(work / "runs_fv", ignore_errors=True)
    n_train, n_val = TRAIN_SPLITS["train"], TRAIN_SPLITS["val"]
    warmup_steps, ft_steps, val_batches = n_train // 64, n_train // 128, -(-n_val // 64)

    per_step = []
    real_step = loop.train_step

    def step_spy(model, opt, *args, **kw):
        before = (k5.window_attention.launches, k5.window_attention_bwd.launches)
        out = real_step(model, opt, *args, **kw)
        per_step.append((opt.n_train == opt.n_total, k5.window_attention.launches - before[0],
                         k5.window_attention_bwd.launches - before[1]))
        return out

    loop.train_step = step_spy
    try:
        t0 = time.perf_counter()
        res, launches = counted(lambda: orchestrate(fv_train_config(work, data, device),
                                                    mode="training")[FV])
        wall = time.perf_counter() - t0
    finally:
        loop.train_step = real_step
    model = create_faster_vit("2", head_config="tpu")
    warm, ft = ((lambda n: (n["k5"], n["k5_bwd"]))(model.kernel_launches_per_step(head_only))
                for head_only in (True, False))
    if (warm, ft) != ((13, 0), (13, 13)):
        raise AssertionError(f"K5 launches per warmup and fine-tune step: {warm}, {ft}")
    want_steps = [(False, *warm)] * warmup_steps + [(True, *ft)] * ft_steps
    want = {"k1": 0, "k2": 0, "k3": 0, "k4": 0,
            "k5": 13 * (warmup_steps + ft_steps + 2 * val_batches), "k5_bwd": 13 * ft_steps,
            "k6": 0, "k6_bwd": 0, "k7": 0}
    log(f"  training (1 epoch, tpu configuration): {warmup_steps} warmup steps at batch 64, "
        f"{ft_steps} fine-tune steps at 32 x 4, {2 * val_batches} val batches; launches "
        f"{launches}; K5 forward/backward per warmup step {per_step[0][1:]}, per fine-tune step "
        f"{per_step[-1][1:]}; wall {wall:.1f} s")
    if launches != want or per_step != want_steps:
        raise AssertionError(f"FasterViT training launches {launches} (expected {want}), per "
                             f"step {per_step}")
    (run,) = sorted((work / "runs_fv").iterdir())
    ckpts = run / "checkpoints"
    for name in ("latest.ckpt", "best.ckpt", f"{FV}.pth"):
        if not (ckpts / name).is_file():
            raise AssertionError(f"FasterViT training wrote no {name}")
    log_text = (run / "logs" / "train.log").read_text()
    speeds = logged_speeds(log_text)
    losses = [float(x) for x in re.findall(r": loss=(\S+) \|", log_text)]
    if len(losses) != 2 or not all(np.isfinite(losses)) or res.interrupted:
        raise AssertionError(f"bad FasterViT training run: losses {losses}, {res}")
    exported = torch.load(ckpts / f"{FV}.pth", weights_only=True)
    log(f"  losses {[round(x, 4) for x in losses]}; img/s (host clock, device synced at each "
        f"epoch's end) {speeds}")

    ires, ilaunch = counted(lambda: orchestrate(fv_train_config(work, data, device),
                                                mode="inference")[FV])
    (irun,) = [r for r in sorted((work / "runs_fv").iterdir()) if r != run]
    ilog = "".join((irun / "logs" / "inference.log").read_text().split())
    if (fastervit_head_config(exported) != "tpu" or "head_config='tpu'" not in ilog
            or ires.probs.shape != (TRAIN_SPLITS["test"], 2) or not np.isfinite(ires.probs).all()
            or ilaunch["k5"] != 13 * (-(-TRAIN_SPLITS["test"] // 64) + val_batches)
            or ilaunch["k5_bwd"]):
        raise AssertionError(f"inference on the trained FasterViT: {ires.probs.shape} {ilaunch}")
    log(f"  inference with weights: auto ({ckpts / f'{FV}.pth'}) built head_config 'tpu': "
        f"accuracy {ires.metrics['accuracy']:.4f}, K5 {ilaunch['k5']}")

    agree = {config: fv_step_against_cpu(device, config) for config in ("official", "tpu")}
    timing = fv_step_times(device)
    report["phase6"] = {"launches": launches, "per_step": per_step, "losses": losses,
                        "logged_img_per_s": speeds, "wall_s": wall, "inference_launches": ilaunch,
                        "cpu_check": agree, "step_times": timing}
    return launches


# parameter groups of the FasterViT step comparison, by the port's names
FV_GROUPS = {
    "attention": lambda n: ".attn.qkv." in n or ".attn.proj." in n,
    "bias tensors": lambda n: "rel_bias" in n or "pos_emb_funct" in n,
    "conv stages": lambda n: n.startswith(("patch_embed.", "levels.0.", "levels.1.")),
    "head": lambda n: n.startswith("head."),
}


def fv_gradients(state, config: str, x, labels, device, dtype):
    """One FasterViT-2 fine-tune step's loss and gradients (drop-path at 0)
    of ``state`` on ``device`` in ``dtype``, on the CPU in f32, and the K5
    launches it made."""
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy

    model = create_faster_vit("2", head_config=config, dtype=dtype, drop_path_rate=0.0)
    model.load_state_dict(state)
    model = model.to(device).train()
    labels = labels.to(device)
    (loss, grads), launches = counted(lambda: _loss_and_grads(model, x.to(device), labels,
                                                              smoothed_cross_entropy))
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}, launches


def _loss_and_grads(model, x, labels, ce):
    import torch

    named = list(model.named_parameters())
    loss = ce(model(x), labels, torch.ones_like(labels, dtype=torch.bool))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.detach(), dict(zip((n for n, _ in named), grads))


def fv_step_readings(card, cpu, groups=None) -> dict:
    """The loss's relative gap and, per parameter group (``FV_GROUPS`` by
    default), max|dg| over the group's largest |g| (the CPU's as the
    scale)."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    out = {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": abs(l_card - l_cpu) / abs(l_cpu)}
    for group, member in (groups or FV_GROUPS).items():
        names = [n for n in g_cpu if member(n)]
        top = max(float(g_cpu[n].abs().max()) for n in names)
        out[group] = max(float((g_card[n] - g_cpu[n]).abs().max()) for n in names) / top
    return out


# the bounds of fv_step_against_cpu, each near the geometric middle of the
# sound reading and the mildest wrong variant's that moves it (H100 80GB HBM3
# against its host's CPU, batch 4, official / tpu; the card patched at run
# time by a scratch script under build/):
#   f32 loss 2.8e-7 / 3.7e-7 sound, 2.3e-4 / 1.4e-3 with the final norm's
#   variance unbiased; attention 3.2e-6 / 3.1e-6 sound, 8.8e-5 / 1.0e-4 with
#   the erf GELU in place of the tanh one; bias tensors 6.2e-6 / 6.7e-6 sound,
#   2.7e-4 / 3.1e-4 erf GELU; head 9.3e-6 / 4.6e-6 sound, 4.1e-4 / 9.8e-5 erf
#   GELU; conv stages 3.1e-4 / 9.0e-6 sound (official: a stem ReLU kink, see
#   tests/test_torch_fastervit_train.py), 2.4e-3 / 3.1e-3 unbiased norm.
#   bf16 (K5 forward and backward on the card): attention 6.4e-3 / 5.3e-3
#   sound, 0.67 / 2.0 with dk not scaled; bias tensors 1.3e-2 / 1.4e-2 sound,
#   0.94 / 0.94 with dbias the windows' mean rather than their sum, 1.5 / 0.63
#   dk not scaled; conv stages 4.7e-3 / 4.2e-3 sound, 0.71 / 0.33 dk not
#   scaled. No backward variant moves the loss or the head (sound 1.4e-5 /
#   6.5e-5 and 1.0e-2 / 4.0e-3), so those bf16 bounds catch gross faults
#   only. The row term taken from the bf16 output (FlashAttention's
#   rowsum(do * o)) moves no reading beyond the sound spread (bias tensors
#   1.25e-2 / 1.23e-2): phase 1 and the CPU tests hold the kernel's row term.
FV_STEP_BOUNDS = {
    "f32": {"loss_rel": 1e-5, "attention": 2e-5, "bias tensors": 4e-5, "conv stages": 1e-3,
            "head": 3e-5},
    "bf16": {"loss_rel": 1e-3, "attention": 6e-2, "bias tensors": 0.1, "conv stages": 4e-2,
             "head": 0.1},
}


def fv_step_against_cpu(device, config: str, dtypes=("f32", "bf16")) -> dict:
    """One full-width FasterViT-2 fine-tune step (forward, loss, gradients;
    drop-path 0) on the card and on the CPU from the same seeded weights and
    images, in bf16 (the card through K5 forward and backward, or K6's with
    ``DFD_FUSED_ATTN``, the CPU through their plain versions) and in f32 (TF32
    off; attention in plain ops on both), held to ``FV_STEP_BOUNDS``."""
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit

    state = seeded_fastervit_state(config, seed=21 if config == "official" else 23)
    g = torch.Generator().manual_seed(24)
    x = seeded_images(FV_STEP_BATCH, g)
    labels = torch.arange(FV_STEP_BATCH) % 2
    out = {}
    per_step = create_faster_vit("2", head_config=config).kernel_launches_per_step()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if name not in dtypes:
            continue
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            l_card, g_card, launches = fv_gradients(state, config, x, labels, device, dtype)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        t0 = time.perf_counter()
        l_cpu, g_cpu, _ = fv_gradients(state, config, x, labels, torch.device("cpu"), dtype)
        row = out[name] = {**fv_step_readings((l_card, g_card), (l_cpu, g_cpu)),
                           "launches": launches, "cpu_s": time.perf_counter() - t0}
        want = {k: v if name == "bf16" else 0 for k, v in per_step.items()}
        log(f"  FasterViT-2 {config} step, card against CPU ({name}, batch {FV_STEP_BATCH}): "
            f"loss {l_card:.6f} / {l_cpu:.6f} (rel {row['loss_rel']:.2e}); max|dg|/scale "
            + ", ".join(f"{k} {row[k]:.2e}" for k in FV_GROUPS)
            + f"; K5 forward/backward launches {launches['k5']}/{launches['k5_bwd']}, K6 "
            f"{launches['k6']}/{launches['k6_bwd']}; CPU {row['cpu_s']:.1f} s")
        over = {k: (row[k], b) for k, b in FV_STEP_BOUNDS[name].items() if not row[k] <= b}
        if over or {k: launches[k] for k in want} != want:
            raise AssertionError(f"the card's {name} FasterViT {config} step disagrees with the "
                                 f"CPU's: {over} (reading, bound); {row}")
    return out


def fv_step_times(device) -> dict:
    """The bf16 FasterViT-2 (tpu configuration) fine-tune step (forward,
    backward, AdamW over every tensor, drop-path on) at batch 64 and 128:
    CUDA events, median and quartiles, with K5's backward and with its plain
    version in its place."""
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.ops import window_attn as k5
    from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    g = torch.Generator().manual_seed(25)
    model = create_faster_vit("2", head_config="tpu", generator=g).to(device)
    opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    root = root_generator(4)
    kernel_bwd = k5.window_attention_bwd

    def plain_bwd(qkv, bias, dout, *, num_heads, scale):
        return k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=num_heads, scale=scale)

    out = {}
    for batch in (64, 128):
        x = torch.randn(batch, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        labels = (torch.arange(batch) % 2).to(device)
        mask = torch.ones(batch, dtype=torch.bool, device=device)

        def step():
            train_step(model, opt, x, labels, mask, fold_in(root, opt.count, device=device))

        torch.cuda.reset_peak_memory_stats(device)
        t_k = spread(cuda_times(step, runs=10))
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        k5.window_attention_bwd = plain_bwd
        try:
            t_p = spread(cuda_times(step, runs=10))
        finally:
            k5.window_attention_bwd = kernel_bwd
        out[batch] = {"step_ms": t_k, "plain_bwd_step_ms": t_p, "peak_gib": peak,
                      "img_per_s": batch / (t_k["median"] / 1e3)}
        log(f"  FasterViT-2 tpu train step batch {batch}: {t_k['median']:.3f} ms (q1 "
            f"{t_k['q1']:.3f}, q3 {t_k['q3']:.3f}) = {out[batch]['img_per_s']:.1f} img/s, peak "
            f"{peak:.1f} GiB; K5 backward's plain version in place: {t_p['median']:.3f} ms (q1 "
            f"{t_p['q1']:.3f}, q3 {t_p['q3']:.3f})")
    return out


# max|dlogit| / scale of EfficientFormerV2-S1's bf16 logits on the card against
# the CPU's bf16 and f32 runs (the weights of seeded_efficientformer_state, 8
# seeded images). Sound: 1.4e-3, CPU bf16 against CPU f32. Wrong variants of
# K7, on the CPU in bf16 against the sound f32 logits
# (tests/test_torch_efficientformer_v2.py holds both sides of the gate): th1
# transposed 1.07e-2, th2 transposed 0.12, th2's bias dropped 0.26. The gate
# sits near the geometric middle of the sound reading and the mildest caught
# fault. The bias table dropped (3.3e-3) stays inside: phase 1 and the CPU
# tests hold K7's own arithmetic.
EFV2_GATE = 4e-3


def seeded_efficientformer_state(seed: int):
    """Full-width EfficientFormerV2-S1 state dict in timm's key names:
    generator-seeded weights (talking heads N(0, 0.25) from the conv init,
    their biases N(0, 0.01), bias tables N(0, 0.25)), layer scales at 0.2 (their init, 1e-5,
    would leave every block silent), each ConvNorm's BatchNorm statistics
    calibrated on a seeded batch (its batch statistics in turn, at decay 0),
    the final norm's those of the last block's map, and both heads fitted
    along the features' first principal direction."""
    import torch
    from torch import nn

    from deepfakedetection_tpu_torch.models.common import bn_momentum_override
    from deepfakedetection_tpu_torch.models.efficientformer_v2 import (
        LayerScale2d,
        create_efficientformer_v2,
    )

    g = torch.Generator().manual_seed(seed)
    model = create_efficientformer_v2("s1", dtype=torch.float32, generator=g).eval()
    x = seeded_images(8, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("attention_biases"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
            elif ".talking_head" in name and name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in model.modules():
            if isinstance(m, LayerScale2d):
                m.gamma.fill_(0.2)
        bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d) and m is not model.norm]
        for m in bns:
            m.train()
        maps = []
        hook = model.stages[-1].blocks[-1].register_forward_hook(
            lambda _m, _i, out: maps.append(out))
        with bn_momentum_override(0.0):
            model(x)
        hook.remove()
        for m in bns:
            m.eval()
        y = maps[0].double()
        model.norm.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        model.norm.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))
    fit_head(model, x, model.head)
    with torch.no_grad():
        model.head_dist.load_state_dict(model.head.state_dict())
    return model.state_dict()


def efficientformer_logits(state, x, device, dtype):
    """EfficientFormerV2-S1 logits of ``state`` on ``device`` in ``dtype``, f32
    on the CPU."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2

    model = create_efficientformer_v2("s1", dtype=dtype)
    model.load_state_dict(state)
    model = model.to(device).eval()
    with torch.no_grad():
        return model(x.to(device)).float().cpu()


def phase7(device, report):
    """The EfficientFormerV2-S1 eval path: orchestrate(mode="inference") from
    a YAML config on a seeded timm-named .pth, at batch 256; the card's
    logits against the CPU's; forward times with K7 and its plain version."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models import efficientformer_v2 as efv2
    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke"
    data = work / "data"  # phase 3's tree
    state = seeded_efficientformer_state(seed=31)
    weights = work / f"{EF}_seeded.pth"
    torch.save(state, weights)
    cfg_path = eval_config(work, "inference_efficientformer.yaml", EF, "runs_ef", weights,
                           EF_BATCH, device)
    t0 = time.perf_counter()
    res, launches = counted(lambda: orchestrate(cfg_path, mode="inference")[EF])
    wall = time.perf_counter() - t0
    batches = sum(-(-n // EF_BATCH) for n in SPLITS.values())
    want = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k5_bwd": 0, "k6": 0, "k6_bwd": 0,
            "k7": 4 * batches}
    log(f"  main path: {batches} forward batches, launches {launches}; test pass "
        f"{res.images_per_s:.1f} img/s (decode included); wall {wall:.1f} s")
    if launches != want:
        raise AssertionError(f"EfficientFormerV2 main path launches {launches}, expected {want}")
    if res.probs.shape != (SPLITS["test"], 2) or not np.isfinite(res.probs).all() \
            or not np.allclose(res.probs.sum(-1), 1.0, atol=1e-5):
        raise AssertionError(f"bad test probabilities {res.probs.shape}")
    (run,) = sorted((work / "runs_ef").iterdir())
    record = json.loads((run / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
    if record["model"] != EF or "roc_auc" not in record:
        raise AssertionError(f"metrics.jsonl: {record}")
    cpu = torch.device("cpu")
    agree = reference_check(res, data, lambda x: [
        efficientformer_logits(state, x, cpu, dt) for dt in (torch.bfloat16, torch.float32)],
        gate=EFV2_GATE)

    g = torch.Generator().manual_seed(32)
    x = seeded_images(8, g)
    card, n = counted(lambda: efficientformer_logits(state, x, device, torch.bfloat16))
    if n["k7"] != 4:
        raise AssertionError(f"EfficientFormerV2-S1 forward: {n['k7']} K7 launches")
    against = check_logits("EfficientFormerV2-S1 forward (card, bf16)", card, *[
        efficientformer_logits(state, x, cpu, dt) for dt in (torch.bfloat16, torch.float32)],
        gate=EFV2_GATE)

    model = efv2.create_efficientformer_v2("s1")
    model.load_state_dict(state)
    timings = forward_times("EfficientFormerV2-S1", "K7", model.to(device).eval(), efv2,
                            "attn4d", k7.attn4d_plain, g, device)
    report["phase7"] = {"launches": launches, "batches": batches, "metrics": record,
                        "test_img_per_s": res.images_per_s, "wall_s": wall,
                        "reference": agree, "against_cpu": against, "timings": timings}
    return launches


def fused_attn(on: bool):
    """``DFD_FUSED_ATTN`` set (or unset) for the models built inside, then
    restored."""
    return env_switch("DFD_FUSED_ATTN", on)


def switched_forward_times(label: str, kernel: str, switch: str, build, state, g, device,
                           runs: int) -> dict:
    """The bf16 eval forward of ``build()`` with ``state`` at batch 128 and
    256 on random images (CUDA events, median and quartiles of ``runs``),
    built with the environment switch ``switch`` set (``kernel``) and
    without it (the unfused path), in turns."""
    import torch

    models = {}
    for on in (True, False):
        with env_switch(switch, on):
            models[on] = build()
        models[on].load_state_dict(state)
        models[on] = models[on].to(device).eval()
    timings = {}
    for batch in (128, 256):
        xb = torch.randn(batch, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
        xb = xb.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            t_k, t_u = (spread(cuda_times(lambda m=models[on]: m(xb), runs=runs))
                        for on in (True, False))
        timings[batch] = {f"{kernel.lower()}_ms": t_k, "unfused_ms": t_u,
                          "img_per_s": batch / (t_k["median"] / 1e3),
                          "unfused_img_per_s": batch / (t_u["median"] / 1e3)}
        log(f"  {label} forward batch {batch}: {kernel} {t_k['median']:.3f} ms (q1 "
            f"{t_k['q1']:.3f}, q3 {t_k['q3']:.3f}) = {timings[batch]['img_per_s']:.1f} img/s; "
            f"unfused path {t_u['median']:.3f} ms (q1 {t_u['q1']:.3f}, q3 {t_u['q3']:.3f}) = "
            f"{timings[batch]['unfused_img_per_s']:.1f} img/s")
    return timings


def fused_step_times(device) -> dict:
    """The bf16 FasterViT-2 official fine-tune step (forward, backward, AdamW
    over every tensor, drop-path on) at batch 64 and 128, CUDA events, median
    and quartiles of 10, built with ``DFD_FUSED_ATTN`` (K6 forward and
    backward) and without it (the unfused path), from the same seeded weights,
    in turns."""
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    steps = {}
    for on in (True, False):
        with fused_attn(on):
            model = create_faster_vit("2", head_config="official",
                                      generator=torch.Generator().manual_seed(26)).to(device)
        steps[on] = (model, PhaseOptimizer(list(model.named_parameters()), lr=1e-4,
                                           weight_decay=5e-2,
                                           trainable=unfreeze_predicate("all")))
    root = root_generator(4)
    g = torch.Generator().manual_seed(27)
    out = {}
    for batch in (64, 128):
        x = torch.randn(batch, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        labels = (torch.arange(batch) % 2).to(device)
        mask = torch.ones(batch, dtype=torch.bool, device=device)
        times = {}
        for on in (True, False):
            model, opt = steps[on]
            torch.cuda.reset_peak_memory_stats(device)
            times[on] = spread(cuda_times(lambda: train_step(
                model, opt, x, labels, mask, fold_in(root, opt.count, device=device)), runs=10))
            times[on, "peak"] = torch.cuda.max_memory_allocated(device) / 2**30
        out[batch] = {"k6_step_ms": times[True], "unfused_step_ms": times[False],
                      "k6_peak_gib": times[True, "peak"], "unfused_peak_gib": times[False, "peak"],
                      "img_per_s": batch / (times[True]["median"] / 1e3)}
        log(f"  FasterViT-2 official train step batch {batch}: K6 {times[True]['median']:.3f} ms "
            f"(q1 {times[True]['q1']:.3f}, q3 {times[True]['q3']:.3f}) = "
            f"{out[batch]['img_per_s']:.1f} img/s, peak {times[True, 'peak']:.1f} GiB; unfused "
            f"path {times[False]['median']:.3f} ms (q1 {times[False]['q1']:.3f}, q3 "
            f"{times[False]['q3']:.3f}), peak {times[False, 'peak']:.1f} GiB")
    return out


def phase8(device, report):
    """The FasterViT-2 path with ``DFD_FUSED_ATTN`` set (inside this phase
    only): ``orchestrate(mode="inference")`` at batch 256 over phase 3's tree
    from phase 5's seeded wheel-named .pth (official), the card's logits
    against the CPU's in both head configurations, forward times with K6 and
    with the unfused path; ``orchestrate(mode="training")`` with the shipped
    FasterViT recipe from that .pth over a small tree (warmup at batch 64,
    fine-tune at 32 x 4 = 128), one full-width bf16 step against the CPU's in
    both head configurations, and the fine-tune step's times."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.ops import attn_block as k6
    from deepfakedetection_tpu_torch.orchestrator import orchestrate
    from deepfakedetection_tpu_torch.train import loop

    work = REPO / "build" / "chip_smoke"
    data = work / "data"  # phase 3's tree
    weights = work / "faster_vit_2_224_seeded.pth"  # phase 5's
    state = torch.load(weights, weights_only=True)
    cpu = torch.device("cpu")
    zero = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k5_bwd": 0, "k6": 0, "k6_bwd": 0,
            "k7": 0}
    with fused_attn(True):
        cfg_path = eval_config(work, "inference_fastervit_fused.yaml", FV, "runs_fv_fused",
                               weights, FV_BATCH, device)
        t0 = time.perf_counter()
        res, launches = counted(lambda: orchestrate(cfg_path, mode="inference")[FV])
        wall = time.perf_counter() - t0
        batches = sum(-(-n // FV_BATCH) for n in SPLITS.values())
        log(f"  eval main path: {batches} forward batches, launches {launches}; test pass "
            f"{res.images_per_s:.1f} img/s (decode included); wall {wall:.1f} s")
        if launches != {**zero, "k6": K6_LAUNCHES * batches}:
            raise AssertionError(f"fused FasterViT eval launches {launches}, expected "
                                 f"{K6_LAUNCHES} K6 a batch and nothing else")
        if res.probs.shape != (SPLITS["test"], 2) or not np.isfinite(res.probs).all() \
                or not np.allclose(res.probs.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"bad test probabilities {res.probs.shape}")
        agree = reference_check(res, data, lambda x: [
            fastervit_logits(state, "official", x, cpu, dt)
            for dt in (torch.bfloat16, torch.float32)], gate=FV_GATE["official"])
        g = torch.Generator().manual_seed(12)
        x = seeded_images(8, g)
        against = {"official": fastervit_against_cpu(device, "official", state, x),
                   "tpu": fastervit_against_cpu(device, "tpu", seeded_fastervit_state("tpu", 13),
                                                x)}
    timings = switched_forward_times(
        "FasterViT-2 official", "K6", "DFD_FUSED_ATTN",
        lambda: create_faster_vit("2", head_config="official"), state, g, device, runs=10)
    eval_launches = launches

    train_work = REPO / "build" / "chip_smoke_fused"
    shutil.rmtree(train_work, ignore_errors=True)
    tree = train_work / "data"
    write_jpeg_tree(tree, FV_FUSED_SPLITS, seed=8)
    n_train, n_val = FV_FUSED_SPLITS["train"], FV_FUSED_SPLITS["val"]
    warmup_steps, ft_steps, val_batches = n_train // 64, n_train // 128, -(-n_val // 64)
    per_step = []
    real_step = loop.train_step

    def step_spy(model, opt, *args, **kw):
        before = (k6.attn_subblock.launches, k6.attn_subblock_bwd.launches)
        out = real_step(model, opt, *args, **kw)
        per_step.append((opt.n_train == opt.n_total, k6.attn_subblock.launches - before[0],
                         k6.attn_subblock_bwd.launches - before[1]))
        return out

    with fused_attn(True):
        loop.train_step = step_spy
        try:
            t0 = time.perf_counter()
            tres, launches = counted(lambda: orchestrate(fv_train_config(
                train_work, tree, device, "runs_fv", init_weights=weights), mode="training")[FV])
            train_wall = time.perf_counter() - t0
        finally:
            loop.train_step = real_step
        want_steps = ([(False, K6_LAUNCHES, 0)] * warmup_steps
                      + [(True, K6_LAUNCHES, K6_LAUNCHES)] * ft_steps)
        want = {**zero, "k6": K6_LAUNCHES * (warmup_steps + ft_steps + 2 * val_batches),
                "k6_bwd": K6_LAUNCHES * ft_steps}
        log(f"  training (1 epoch, official from the seeded .pth): {warmup_steps} warmup steps "
            f"at batch 64, {ft_steps} fine-tune steps at 32 x 4, {2 * val_batches} val batches; "
            f"launches {launches}; K6 forward/backward per warmup step {per_step[0][1:]}, per "
            f"fine-tune step {per_step[-1][1:]}; wall {train_wall:.1f} s")
        if launches != want or per_step != want_steps:
            raise AssertionError(f"fused FasterViT training launches {launches} (expected "
                                 f"{want}), per step {per_step}")
        (run,) = sorted((train_work / "runs_fv").iterdir())
        for name in ("latest.ckpt", "best.ckpt", f"{FV}.pth"):
            if not (run / "checkpoints" / name).is_file():
                raise AssertionError(f"fused FasterViT training wrote no {name}")
        log_text = (run / "logs" / "train.log").read_text()
        losses = [float(v) for v in re.findall(r": loss=(\S+) \|", log_text)]
        if "head_config='official'" not in "".join(log_text.split()) or len(losses) != 2 \
                or not all(np.isfinite(losses)) or tres.interrupted:
            raise AssertionError(f"bad fused FasterViT training run: losses {losses}, {tres}")
        log(f"  losses {[round(v, 4) for v in losses]}; img/s {logged_speeds(log_text)}")
        step_agree = {config: fv_step_against_cpu(device, config, dtypes=("bf16",))
                      for config in ("official", "tpu")}
    step_timing = fused_step_times(device)
    report["phase8"] = {"eval_launches": eval_launches, "batches": batches,
                        "test_img_per_s": res.images_per_s, "wall_s": wall, "reference": agree,
                        "against_cpu": against, "timings": timings, "train_launches": launches,
                        "per_step": per_step, "losses": losses,
                        "logged_img_per_s": logged_speeds(log_text), "train_wall_s": train_wall,
                        "cpu_check": step_agree, "step_times": step_timing}
    return eval_launches, launches


def phase9(device, report, state):
    """B3 with ``DFD_FUSED_MBCONV`` set (inside this phase only): the
    full-width forward from phase 2's seeded state (K1 2, K2 2, K3 18
    launches), its bf16 logits against the CPU's bf16 run with the switch
    (plain versions) and its f32 run; forward times with K3 and without the
    switch; ``orchestrate(mode="inference")`` over phase 3's JPEG tree and
    weights, with K3's launches a batch and 16 test images against the
    CPU."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke"
    data, weights = work / "data", work / "efficientnet_b3_seeded.pth"  # phase 3's
    zero = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k5_bwd": 0, "k6": 0, "k6_bwd": 0,
            "k7": 0}
    g = torch.Generator().manual_seed(91)
    x = seeded_images(8, g)
    with env_switch("DFD_FUSED_MBCONV", True):
        model = create_efficientnet("b3", num_classes=2, dtype=torch.bfloat16)
        model.load_state_dict(state)
        model = model.to(device).eval()
        with torch.no_grad():
            logits, per_forward = counted(lambda: model(x.to(device).to(torch.bfloat16)))
        log(f"  launches per forward: {per_forward}")
        if model.kernel_launches_per_forward() != K3_LAUNCHES \
                or per_forward != {**zero, **K3_LAUNCHES}:
            raise AssertionError(f"B3 with DFD_FUSED_MBCONV: launches per forward "
                                 f"{per_forward}, expected {K3_LAUNCHES}")
        agree = check_logits("B3 forward with K3 (card, bf16)", logits.float().cpu(),
                             *cpu_logits(state, x))

        cfg_path = eval_config(work, "inference_fused_mbconv.yaml", "efficientnet_b3",
                               "runs_fused_mbconv", weights, EVAL_BATCH, device)
        t0 = time.perf_counter()
        res, launches = counted(lambda: orchestrate(cfg_path, mode="inference")[
            "efficientnet_b3"])
        wall = time.perf_counter() - t0
        batches = sum(-(-n // EVAL_BATCH) for n in SPLITS.values())
        want = {**zero, **{k: v * batches for k, v in K3_LAUNCHES.items()}}
        log(f"  eval main path: {batches} forward batches, launches {launches}; test pass "
            f"{res.images_per_s:.1f} img/s (decode included; phase 3 without the switch "
            f"{report['phase3']['test_img_per_s']:.1f}); wall {wall:.1f} s")
        if launches != want:
            raise AssertionError(f"B3 eval with DFD_FUSED_MBCONV: launches {launches}, "
                                 f"expected {want}")
        if res.probs.shape != (SPLITS["test"], 2) or not np.isfinite(res.probs).all() \
                or not np.allclose(res.probs.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"bad test probabilities {res.probs.shape}")
        job = reference_check(res, data, lambda x: cpu_logits(state, x))
    timings = switched_forward_times(
        "B3", "K3", "DFD_FUSED_MBCONV",
        lambda: create_efficientnet("b3", num_classes=2, dtype=torch.bfloat16), state, g, device,
        runs=12)
    report["phase9"] = {"launches_per_forward": per_forward, "against_cpu": agree,
                        "eval_launches": launches, "batches": batches,
                        "test_img_per_s": res.images_per_s, "wall_s": wall, "reference": job,
                        "timings": timings}
    return launches


EF_TRAIN_SPLITS = FV_FUSED_SPLITS  # phase 10's training tree
EF_TRAIN_BATCH = 128  # config/train.yaml's EfficientFormerV2 batch (a CPU test holds them equal)
EFV2_STEP_BATCH = 4  # images of the card-against-CPU step (full width, 224 px)
ZERO_LAUNCHES = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, "k5_bwd": 0, "k6": 0,
                 "k6_bwd": 0, "k7": 0}


def ef_train_config(work: Path, data: Path, device) -> Path:
    """The shipped EfficientFormerV2-S1 block of ``config/train.yaml`` (its
    transforms, batch 128, the recipe's warmup and fine-tune) for one epoch
    over ``data``, into ``work / "runs"``."""
    import yaml

    shipped = yaml.safe_load((REPO / "config" / "train.yaml").read_text())["models"][EF]
    cfg = {
        "seed": 1,
        "device": str(device),
        "data": {"root": str(data), "train_split": "train", "val_split": "val",
                 "test_split": "test", "num_classes": 2, "img_size": 224},
        "models": {EF: {
            "output_dir": str(work / "runs"),
            "transforms": shipped["transforms"],
            "training": {**shipped["training"], "epochs": 1, "batch_size": EF_TRAIN_BATCH},
            "inference": {"weights": "auto", "split": "test", "batch_size": EF_TRAIN_BATCH,
                          "num_workers": 8, "img_size": 224},
        }},
        "selection": [EF],
    }
    path = work / "train_ef.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def phase10(device, report):
    """The EfficientFormerV2-S1 training path: orchestrate(mode="training")
    with the shipped recipe, transforms and batch from the seeded init over a
    small seeded tree (warmup and fine-tune at batch 128, validation
    after each), the inference handoff, one full-width step on the card
    against the CPU's, and the step's time."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.orchestrator import orchestrate
    from deepfakedetection_tpu_torch.train import loop

    work = REPO / "build" / "chip_smoke_ef_train"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    write_jpeg_tree(data, EF_TRAIN_SPLITS, seed=10)
    n_train, n_val, n_test = (EF_TRAIN_SPLITS[k] for k in ("train", "val", "test"))
    warmup_steps = ft_steps = n_train // EF_TRAIN_BATCH
    val_batches = -(-n_val // EF_TRAIN_BATCH)
    per_step = []
    real_step = loop.train_step

    def step_spy(model, opt, *args, **kw):
        before = k7.attn4d.launches
        out = real_step(model, opt, *args, **kw)
        per_step.append(k7.attn4d.launches - before)
        return out

    loop.train_step = step_spy
    try:
        t0 = time.perf_counter()
        res, launches = counted(lambda: orchestrate(ef_train_config(work, data, device),
                                                    mode="training")[EF])
        wall = time.perf_counter() - t0
    finally:
        loop.train_step = real_step
    want = {**ZERO_LAUNCHES, "k7": 4 * 2 * val_batches}
    log(f"  training (1 epoch from the seeded init): {warmup_steps} warmup and {ft_steps} "
        f"fine-tune steps at batch {EF_TRAIN_BATCH}, {2 * val_batches} val batches; launches "
        f"{launches}; K7 per train step {per_step}; wall {wall:.1f} s")
    if launches != want or per_step != [0] * (warmup_steps + ft_steps):
        raise AssertionError(f"EfficientFormerV2 training launches {launches} (expected {want}), "
                             f"K7 per train step {per_step}")
    (run,) = sorted((work / "runs").iterdir())
    ckpts = run / "checkpoints"
    for name in ("latest.ckpt", "best.ckpt", f"{EF}.pth"):
        if not (ckpts / name).is_file():
            raise AssertionError(f"EfficientFormerV2 training wrote no {name}")
    log_text = (run / "logs" / "train.log").read_text()
    flat = "".join(log_text.split())
    speeds = logged_speeds(log_text)
    losses = [float(x) for x in re.findall(r": loss=(\S+) \|", log_text)]
    if (len(losses) != 2 or not all(np.isfinite(losses)) or res.interrupted
            or "head-only(20/357paramtensors)" not in flat or "trainable=116/357" not in flat):
        raise AssertionError(f"bad EfficientFormerV2 training run: losses {losses}, {res}")
    log(f"  losses {[round(x, 4) for x in losses]}; val acc {res.best_val_acc:.4f}; img/s "
        f"(host clock, device synced at each epoch's end) {speeds}")

    ires, ilaunch = counted(lambda: orchestrate(ef_train_config(work, data, device),
                                                mode="inference")[EF])
    batches = -(-n_test // EF_TRAIN_BATCH) + val_batches
    if ires.probs.shape != (n_test, 2) or not np.isfinite(ires.probs).all() \
            or ilaunch != {**ZERO_LAUNCHES, "k7": 4 * batches}:
        raise AssertionError(f"inference on the trained EfficientFormerV2: {ires.probs.shape} "
                             f"{ilaunch}")
    log(f"  inference with weights: auto ({ckpts / f'{EF}.pth'}): accuracy "
        f"{ires.metrics['accuracy']:.4f}, K7 {ilaunch['k7']}")

    agree = ef_step_against_cpu(device)
    timing = ef_step_times(device)
    report["phase10"] = {"launches": launches, "per_step": per_step, "losses": losses,
                         "val_acc": res.best_val_acc, "logged_img_per_s": speeds, "wall_s": wall,
                         "inference_launches": ilaunch, "cpu_check": agree,
                         "step_times": timing}
    return launches


# parameter groups of the EfficientFormerV2 step comparison, by the port's names
EFV2_GROUPS = {
    "attention": lambda n: (".token_mixer." in n or ".downsample.attn." in n)
    and "talking_head" not in n and "attention_biases" not in n,
    "talking heads and tables": lambda n: "talking_head" in n or "attention_biases" in n,
    "conv stages": lambda n: n.startswith(("stem.", "stages.0.", "stages.1.")),
    "head": lambda n: n.startswith(("head.", "head_dist.", "norm.")),
}


def ef_gradients(state, x, labels, device, dtype):
    """One EfficientFormerV2-S1 fine-tune step's loss and gradients (every
    tensor) of ``state`` on ``device`` in ``dtype``, on the CPU in f32, and
    the kernel launches it made."""
    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2
    from deepfakedetection_tpu_torch.train.objectives import smoothed_cross_entropy

    model = create_efficientformer_v2("s1", dtype=dtype)
    model.load_state_dict(state)
    model = model.to(device).train()
    labels = labels.to(device)
    (loss, grads), launches = counted(lambda: _loss_and_grads(model, x.to(device), labels,
                                                              smoothed_cross_entropy))
    return float(loss), {n: g.float().cpu() for n, g in grads.items()}, launches


# the bounds of ef_step_against_cpu, each near the geometric middle of the
# sound reading (H100 80GB HBM3 against its host's CPU, batch 4) and the
# mildest wrong variant's that moves it (the CPU patched against the sound
# CPU, same weights and images):
#   f32 loss 8.9e-8 sound, 8.4e-5 with the erf GELU in place of the tanh one;
#   attention 4.3e-6 sound, 5.5e-4 erf GELU; talking heads and tables 7.1e-6,
#   6.8e-4; conv stages 8.3e-6, 1.0e-3; head 4.3e-6, 6.3e-4.
#   bf16 loss 6.4e-5 sound, 1.45e-3 with the final norm's variance unbiased
#   (4.9e-4 erf GELU); attention 2.1e-2 sound, 0.15 with talking_head1
#   transposed; talking heads and tables 1.3e-2, 0.15; conv stages 3.2e-2,
#   0.31; head 1.0e-2, 0.14. In bf16 the erf GELU (1.1-1.7e-2), the
#   unbiased norm (3.2e-3-9.1e-3) and the attention's output rounded to bf16
#   before the local-v sum (the kernel branch's rounding, 4.3e-3-1.3e-2) stay
#   inside the sound spread of the groups: the f32 bounds and the CPU tests
#   hold those.
EFV2_STEP_BOUNDS = {
    "f32": {"loss_rel": 3e-6, "attention": 5e-5, "talking heads and tables": 7e-5,
            "conv stages": 1e-4, "head": 5e-5},
    "bf16": {"loss_rel": 3e-4, "attention": 6e-2, "talking heads and tables": 5e-2,
             "conv stages": 0.1, "head": 4e-2},
}


def ef_step_against_cpu(device) -> dict:
    """One full-width EfficientFormerV2-S1 step (forward, loss, gradients of
    every tensor) on the card and on the CPU from the same seeded weights
    (phase 7's kind) and images, in f32 (TF32 off) and in bf16, both through
    the plain attention (no K7: it has no backward), held to
    ``EFV2_STEP_BOUNDS``."""
    import torch

    state = seeded_efficientformer_state(seed=41)
    g = torch.Generator().manual_seed(42)
    x = seeded_images(EFV2_STEP_BATCH, g)
    labels = torch.arange(EFV2_STEP_BATCH) % 2
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            l_card, g_card, launches = ef_gradients(state, x, labels, device, dtype)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        t0 = time.perf_counter()
        l_cpu, g_cpu, _ = ef_gradients(state, x, labels, torch.device("cpu"), dtype)
        row = out[name] = {**fv_step_readings((l_card, g_card), (l_cpu, g_cpu), EFV2_GROUPS),
                           "launches": launches, "cpu_s": time.perf_counter() - t0}
        log(f"  EfficientFormerV2-S1 step, card against CPU ({name}, batch {EFV2_STEP_BATCH}): "
            f"loss {l_card:.6f} / {l_cpu:.6f} (rel {row['loss_rel']:.2e}); max|dg|/scale "
            + ", ".join(f"{k} {row[k]:.2e}" for k in EFV2_GROUPS)
            + f"; K7 launches {launches['k7']}; CPU {row['cpu_s']:.1f} s")
        over = {k: (row[k], b) for k, b in EFV2_STEP_BOUNDS[name].items() if not row[k] <= b}
        if over or launches != ZERO_LAUNCHES or not math.isfinite(l_card):
            raise AssertionError(f"the card's {name} EfficientFormerV2 step disagrees with the "
                                 f"CPU's: {over} (reading, bound); {row}")
    return out


def ef_step_times(device) -> dict:
    """The bf16 EfficientFormerV2-S1 train step (forward, backward, AdamW) at
    batch 128: CUDA events, median and quartiles of 10, over the recipe's
    116-tensor fine-tune set and over every tensor."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2
    from deepfakedetection_tpu_torch.registry import get_model_spec
    from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    g = torch.Generator().manual_seed(43)
    model = create_efficientformer_v2("s1", generator=g).to(device)
    root = root_generator(4)
    x = torch.randn(EF_TRAIN_BATCH, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    labels = (torch.arange(EF_TRAIN_BATCH) % 2).to(device)
    mask = torch.ones(EF_TRAIN_BATCH, dtype=torch.bool, device=device)
    out = {}
    for sets, policy in (("recipe", get_model_spec(EF).recipe.unfreeze), ("all", "all")):
        opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                             trainable=unfreeze_predicate(policy))
        torch.cuda.reset_peak_memory_stats(device)
        t = spread(cuda_times(lambda: train_step(
            model, opt, x, labels, mask, fold_in(root, opt.count, device=device)), runs=10))
        out[sets] = {"step_ms": t, "img_per_s": EF_TRAIN_BATCH / (t["median"] / 1e3),
                     "trainable": opt.n_train,
                     "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        log(f"  EfficientFormerV2-S1 train step batch {EF_TRAIN_BATCH} ({opt.n_train} tensors): "
            f"{t['median']:.3f} ms (q1 {t['q1']:.3f}, q3 {t['q3']:.3f}) = "
            f"{out[sets]['img_per_s']:.1f} img/s; peak {out[sets]['peak_gib']:.1f} GiB")
    return out


PREDICT_IMAGES = 8  # phase 11's images, the first and last 4 of phase 3's test split
PREDICT_LAUNCHES = {"efficientnet_b3": {"k1": 2, "k2": 20}, FV: {"k5": 13}, EF: {"k7": 4}}
# max|d| of the card's Grad-CAM (bf16, kernels) against the CPU's (bf16, plain
# versions) on the [0, 1] map, each model on phase 11's 8 images. Sound (H100
# 80GB HBM3): B3 1.55e-2, FasterViT-2 1.46e-2, EfficientFormerV2-S1 9.7e-3;
# the CPU's own bf16 maps sit 1.4e-2, 1.4e-2 and 8.3e-3 from its f32 ones.
CAM_GATE = 5e-2


MODEL_GATES = {"efficientnet_b3": 5e-2, FV: FV_GATE["official"], EF: EFV2_GATE}


def logit_diff_rows(probs):
    """[N, 2] float64 rows (0, log p1 - log p0) of [N, 2] probabilities:
    the logits up to a per-row shift, as ``check_logits`` reads them."""
    import torch

    p = torch.as_tensor(probs, dtype=torch.float64)
    return torch.stack([torch.zeros(len(p), dtype=p.dtype), p[:, 1].log() - p[:, 0].log()], -1)


def predict_config(work: Path, device, precision: str) -> Path:
    """``config/inference.yaml``'s selection with the seeded ``.pth`` files of
    phases 3, 5 and 7, on ``device`` in ``precision``."""
    import yaml

    shipped = yaml.safe_load((REPO / "config" / "inference.yaml").read_text())
    models = {name: {
        "output_dir": str(work / "runs" / name),
        "transforms": shipped["models"][name]["transforms"],
        "inference": {"weights": str(REPO / "build" / "chip_smoke" / f"{name}_seeded.pth"),
                      "img_size": 224},
    } for name in shipped["selection"]}
    cfg = {"seed": 1, "device": str(device), "precision": precision,
           "data": {"root": str(work), "num_classes": 2, "img_size": 224},
           "models": models, "selection": shipped["selection"]}
    path = work / f"predict_{device.type}_{precision}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_predict(argv: list[str]) -> list[dict]:
    """``python -m deepfakedetection_tpu_torch.predict ARGV`` in this process:
    its JSON records."""
    import contextlib
    import io

    from deepfakedetection_tpu_torch import predict

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        predict.main(argv)
    return [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


def phase11(device, report):
    """``predict --json`` and ``predict --json --cam`` for the three models of
    ``config/inference.yaml``'s selection from the seeded ``.pth`` files of
    phases 3, 5 and 7, over 8 images of phase 3's tree: launches a forward,
    the card's probabilities against the CPU's, the triptych PNGs, the card's
    Grad-CAM maps against the CPU's and the milliseconds an image."""
    import numpy as np
    import torch
    from PIL import Image

    from deepfakedetection_tpu_torch import web_ui
    from deepfakedetection_tpu_torch.cam import compute_cam
    from deepfakedetection_tpu_torch.data.pipeline import scan_image_folder

    work = REPO / "build" / "chip_smoke_predict"
    shutil.rmtree(work, ignore_errors=True)
    ds = scan_image_folder(REPO / "build" / "chip_smoke" / "data" / "test")  # phase 3's
    picked = ds.samples[: PREDICT_IMAGES // 2] + ds.samples[-PREDICT_IMAGES // 2:]
    for path, label in picked:
        dest = work / "images" / ds.classes[label] / path.name
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, dest)
    images = work / "images"
    configs = {name: predict_config(work, dev, precision) for name, dev, precision in (
        ("card", device, "bfloat16"), ("cpu16", torch.device("cpu"), "bfloat16"),
        ("cpu32", torch.device("cpu"), "float32"))}
    export_dir = web_ui.EXPORT_DIR
    web_ui.EXPORT_DIR = work / "cam_exports"
    try:
        t0 = time.perf_counter()
        card, launches = counted(lambda: run_predict(
            ["--config", str(configs["card"]), "--input", str(images), "--json"]))
        predict_s = time.perf_counter() - t0
        cpu = {name: run_predict(["--config", str(configs[name]), "--input", str(images),
                                  "--json"]) for name in ("cpu16", "cpu32")}
        t0 = time.perf_counter()
        summaries, cam_launches = counted(lambda: run_predict(
            ["--config", str(configs["card"]), "--input", str(images), "--json", "--cam"]))
        cam_s = time.perf_counter() - t0
    finally:
        web_ui.EXPORT_DIR = export_dir
    per_image = {k: sum(v.get(k, 0) for v in PREDICT_LAUNCHES.values()) for k in ZERO_LAUNCHES}
    want = {k: PREDICT_IMAGES * v for k, v in per_image.items()}
    log(f"  predict --json over {PREDICT_IMAGES} images: launches {launches}; --cam {cam_launches} "
        f"(a forward for the prediction and one for the map); wall {predict_s:.1f} s and "
        f"{cam_s:.1f} s")
    if launches != want or cam_launches != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"predict launches {launches} / {cam_launches}, expected {want} and "
                             "twice that with --cam")
    if len(card) != PREDICT_IMAGES \
            or [r["image"] for r in card] != [r["image"] for r in cpu["cpu16"]]:
        raise AssertionError(f"predict --json records: {card}")
    gates = MODEL_GATES

    def logit_diffs(records, name):
        return logit_diff_rows([r["predictions"][name]["probs"] for r in records])

    agree = {name: check_logits(f"predict --json {name} (card against CPU)",
                                logit_diffs(card, name), logit_diffs(cpu["cpu16"], name),
                                logit_diffs(cpu["cpu32"], name), gate=gate)
             for name, gate in gates.items()}

    pngs = sorted((work / "cam_exports").glob("*.png"))
    scale = web_ui.EXPORT_SCALE
    sizes = set()
    for png in pngs:
        with Image.open(png) as img:
            sizes.add(img.size)
    if len(summaries) != PREDICT_IMAGES or not pngs \
            or sizes != {(len(gates) * 224 * scale, 224 * scale)} \
            or any(len(s["summary"]) != len(gates) + 1 for s in summaries):
        raise AssertionError(f"predict --cam: {len(summaries)} records, PNG sizes {sizes}")

    bundles = {}
    for name in ("card", "cpu16"):
        web_ui.initialize_from_config(configs[name])
        bundles[name] = list(web_ui.MODEL_CACHE)
    cams, times = {}, {}
    for b_card, b_cpu in zip(bundles["card"], bundles["cpu16"]):
        worst, t_pred, t_cam = 0.0, [], []
        for i, (path, _) in enumerate([(p, 0) for p, _ in picked] * 2):
            with Image.open(path) as img:
                t0 = time.perf_counter()
                x = b_card.prepare(img)
                cls_idx = int(b_card.probs(x).argmax())
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                cam = compute_cam(b_card.model, x, cls_idx)[0].cpu()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if i >= PREDICT_IMAGES:  # the second pass, warm
                    t_pred.append(1e3 * (t1 - t0))
                    t_cam.append(1e3 * (t2 - t1))
                    ref = compute_cam(b_cpu.model, b_cpu.prepare(img), cls_idx)[0]
                    worst = max(worst, float((cam - ref).abs().max()))
        cams[b_card.name] = worst
        times[b_card.name] = {"predict_ms": statistics.median(t_pred),
                              "cam_ms": statistics.median(t_cam)}
        log(f"  {b_card.name}: Grad-CAM max|d| card against CPU {worst:.3e} (gate {CAM_GATE}); "
            f"per image {times[b_card.name]['predict_ms']:.2f} ms to predict and "
            f"{times[b_card.name]['cam_ms']:.2f} ms for the map (host clock, device synced, "
            f"median of {PREDICT_IMAGES}; {smi()})")
    if any(v > CAM_GATE for v in cams.values()):
        raise AssertionError(f"Grad-CAM maps, card against CPU: {cams}")
    report["phase11"] = {"launches": launches, "cam_launches": cam_launches,
                         "against_cpu": agree, "cam_max_abs_diff": cams, "ms_per_image": times,
                         "pngs": len(pngs), "wall_s": {"predict": predict_s, "cam": cam_s}}
    return launches


SERVE_IMAGES = 16  # phase 12's single requests: the first and last 8 of phase 3's test split
SERVE_B64 = 4  # of them sent as {"image_b64"}, the rest as raw JPEG bodies
SERVE_WEIGHTS = {"efficientnet_b3": 2.0}  # phase 12's top-level ensemble
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
SERVE_CLIENTS, SERVE_PER_CLIENT = 64, 16  # the load: client threads x requests each
SERVE_RELOAD_CLIENTS = 16  # the load during the reload, each until the swap is behind it
SERVE_TOKEN = "phase-12-reload-token"


def serve_config(work: Path, device, precision: str) -> Path:
    """``predict_config``'s three models with ``SERVE_WEIGHTS``' top-level
    ensemble."""
    import yaml

    cfg = yaml.safe_load(predict_config(work, device, precision).read_text())
    cfg["ensemble"] = {"weights": SERVE_WEIGHTS}
    path = work / f"serve_{device.type}_{precision}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@functools.cache
def no_proxy_opener():
    """One urllib opener for every request of phase 12 (building one loads
    the CA store, tens of ms of the interpreter's time)."""
    import urllib.request

    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http(base: str, path: str, data: bytes | None = None, headers: dict | None = None,
         timeout: float = 120.0) -> tuple[int, dict, bytes]:
    """(status, headers, body) of one request to the phase's loopback
    server, errors included; no proxy."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with no_proxy_opener().open(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def prometheus_values(text: str) -> dict[tuple[str, str], float]:
    """{(metric[_quantile], model): value} of the server's ``/metrics`` text;
    raises on a line it cannot read."""
    out = {}
    for line in text.splitlines():
        m = re.fullmatch(r'(\w+)\{model="(\w+)"(?:,quantile="([\d.]+)")?\} ([\d.]+)', line)
        if m:
            out[(m.group(1) + (f"_{m.group(3)}" if m.group(3) else ""), m.group(2))] = \
                float(m.group(4))
        elif line and not line.startswith("# "):
            raise AssertionError(f"/metrics line not understood: {line!r}")
    return out


@contextlib.contextmanager
def plain_calls():
    """Counts the kernels' plain versions called on CUDA tensors while the
    block runs: [(name, tokens or None)]. FasterViT's 16-token carrier-token
    attentions run in plain ops by design (K5 takes 32 tokens or more)."""
    from deepfakedetection_tpu_torch.models import efficientformer_v2, fastervit
    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.ops import expand_dw as k2
    from deepfakedetection_tpu_torch.ops import window_attn as k5

    seen: list[tuple[str, int | None]] = []
    targets = [(k1, "depthwise_silu_pool_plain"), (k2, "expand_dw_silu_pool_plain"),
               (k5, "window_attention_plain"), (fastervit, "window_attention_plain"),
               (k7, "attn4d_plain"), (efficientformer_v2, "attn4d_plain")]
    originals = [getattr(module, name) for module, name in targets]

    def counting(name, fn):
        def wrapper(x, *args, **kwargs):
            if x.is_cuda:
                seen.append((name, x.shape[1] if name == "window_attention_plain" else None))
            return fn(x, *args, **kwargs)
        return wrapper

    for (module, name), fn in zip(targets, originals):
        setattr(module, name, counting(name, fn))
    try:
        yield seen
    finally:
        for (module, name), fn in zip(targets, originals):
            setattr(module, name, fn)


def serve_load(base: str, names: list[str], bodies: list[bytes], clients: int, per_client: int,
               until=None, deadline_s: float = 300.0):
    """``clients`` threads each sending ``per_client`` requests (or, with
    ``until``, until ``until()`` holds and it has sent 4 more); request k of
    client i is number j = i + k * clients, its body ``bodies[j % len]``,
    every second one with ``?model=`` (the models in turn). Returns
    ([(status, only, seconds)], wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    t_end = time.perf_counter() + deadline_s

    def client(i):
        out, k, after = [], 0, 0
        while k < per_client if until is None else after < 4:
            if time.perf_counter() > t_end:
                raise AssertionError("the load outlasted its deadline")
            done = until is not None and until()
            j = i + k * clients
            only = names[(j // 2) % len(names)] if j % 2 else None
            t0 = time.perf_counter()
            code, _, _ = http(base, f"/predict?model={only}" if only else "/predict",
                              bodies[j % len(bodies)])
            out.append((code, only, time.perf_counter() - t0))
            k, after = k + 1, after + done
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as ex:
        rows = [r for rs in ex.map(client, range(clients)) for r in rs]
    return rows, time.perf_counter() - t0


def phase12(device, report):
    """``serve`` for config/inference.yaml's three models with an ensemble,
    from the seeded ``.pth`` files of phases 3, 5 and 7: the in-process server
    (``build_server`` on a thread, ``--max-batch 32 --max-wait-ms 5 --warmup
    all``) against the CPU's runs of the same weights, every bucket against
    bucket 1, the launches of a bucket-32 step, concurrent clients, a reload
    under load; then the CLI in a subprocess until SIGTERM."""
    import base64
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from deepfakedetection_tpu_torch import serve
    from deepfakedetection_tpu_torch.data.decode import decode_pil_eval
    from deepfakedetection_tpu_torch.data.pipeline import scan_image_folder
    from deepfakedetection_tpu_torch.evaluate.ensemble import weighted_mean

    def decoded(path, plan):
        with Image.open(path) as img:
            return decode_pil_eval(img, plan)

    t_phase = time.perf_counter()
    work = REPO / "build" / "chip_smoke_serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ds = scan_image_folder(REPO / "build" / "chip_smoke" / "data" / "test")  # phase 3's
    picked = [path for path, _ in
              ds.samples[: SERVE_IMAGES // 2] + ds.samples[-SERVE_IMAGES // 2:]]
    bodies = [path.read_bytes() for path in picked]
    card_cfg = serve_config(work, device, "bfloat16")
    t0 = time.perf_counter()
    state = serve.build_state(card_cfg, max_batch=32, max_wait_ms=5.0)
    state.warmup("all")
    startup_s = time.perf_counter() - t0
    names = [m.name for m in state.models]
    server = serve.build_server(card_cfg, port=0, max_batch=32, max_wait_ms=5.0, state=state,
                                reload_token=SERVE_TOKEN)
    handler = server.RequestHandlerClass
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    out: dict = {"startup_s": startup_s}
    try:
        code, _, body = http(base, "/healthz")
        if code != 200 or json.loads(body)["models"] != names or sorted(names) != sorted(
                PREDICT_LAUNCHES):
            raise AssertionError(f"/healthz: {code} {body!r}")

        # 16 single requests: 12 raw JPEG bodies, 4 as {"image_b64"}
        served = []
        for i, raw in enumerate(bodies):
            if i % (SERVE_IMAGES // SERVE_B64) == SERVE_IMAGES // SERVE_B64 - 1:
                code, _, body = http(base, "/predict", json.dumps(
                    {"image_b64": base64.b64encode(raw).decode()}).encode(),
                    {"Content-Type": "application/json"})
            else:
                code, _, body = http(base, "/predict", raw)
            if code != 200:
                raise AssertionError(f"/predict {picked[i]}: {code} {body!r}")
            served.append({r["model"]: r for r in json.loads(body)["results"]})
        if any(list(r) != names + ["ensemble"] for r in served):
            raise AssertionError(f"/predict results name {[list(r) for r in served]}")
        ens_err = max(float(np.abs(np.asarray(r["ensemble"]["probs"]) - weighted_mean(
            [(n, np.asarray(r[n]["probs"])) for n in names], SERVE_WEIGHTS)).max())
            for r in served)
        if ens_err > 1e-12:
            raise AssertionError(f"the ensemble entry is off the members' weighted mean by "
                                 f"{ens_err}")
        refs = {}
        for precision in ("bfloat16", "float32"):
            cpu = serve.build_state(serve_config(work, torch.device("cpu"), precision),
                                    max_batch=SERVE_IMAGES)
            try:
                for m in cpu.models:
                    batch = np.stack([decoded(p, m.plan) for p in picked])
                    refs[m.name, precision] = m.batcher.call(
                        lambda r=m.batcher.runner, b=batch: r(b)).result()
            finally:
                cpu.close()
        agree = {name: check_logits(
            f"serve {name} (card against CPU)",
            logit_diff_rows([r[name]["probs"] for r in served]),
            logit_diff_rows(refs[name, "bfloat16"]), logit_diff_rows(refs[name, "float32"]),
            gate=MODEL_GATES[name]) for name in names}
        log(f"  16 requests (12 raw, 4 base64): the ensemble entry within {ens_err:.1e} of the "
            f"members' weighted mean")

        # every bucket: N copies of one image at once, each row against bucket 1's
        buckets = {}
        for m in state.models:
            arr = decoded(picked[0], m.plan)
            scale = float(logit_diff_rows(refs[m.name, "float32"]).abs().max())
            rows_1, buckets[m.name] = None, {}
            for n in SERVE_BUCKETS:
                b0 = m.batcher.n_batches
                futs = [m.batcher.submit(arr) for _ in range(n)]
                rows = logit_diff_rows(np.stack([f.result(timeout=120) for f in futs]))[:, 1]
                sizes = list(m.batcher.batch_sizes)[-(m.batcher.n_batches - b0):]
                rows_1 = rows[0] if rows_1 is None else rows_1
                worst = float((rows - rows_1).abs().max()) / scale
                buckets[m.name][n] = {"max_rel_dlogit": worst, "batches": sizes}
                if worst > MODEL_GATES[m.name]:
                    raise AssertionError(f"{m.name} bucket {n}: rows {worst:.3e} of the logit "
                                         f"scale from bucket 1's (gate {MODEL_GATES[m.name]})")
            log(f"  {m.name}: each bucket's rows against bucket 1's, max|dlogit|/scale "
                + ", ".join(f"{n}: {v['max_rel_dlogit']:.2e} (coalesced {v['batches']})"
                            for n, v in buckets[m.name].items()))

        # the launches of one bucket-32 device step per model, and no plain version
        launches, plains = {}, {}
        for m in state.models:
            batch = np.stack([decoded(picked[0], m.plan)] * 32)
            with plain_calls() as plain:
                _, launches[m.name] = counted(lambda: m.batcher.call(
                    lambda r=m.batcher.runner: r(batch)).result())
            want = {k: PREDICT_LAUNCHES[m.name].get(k, 0) for k in ZERO_LAUNCHES}
            if launches[m.name] != want or any(n is None or n >= 32 for _, n in plain):
                raise AssertionError(f"{m.name} bucket-32 step: launches {launches[m.name]} "
                                     f"(expected {want}), plain versions on the card {plain}")
            ran = {k: v for k, v in launches[m.name].items() if v}
            note = (f"{len(plain)} plain attentions, all carrier tokens of {plain[0][1]} (K5 "
                    "takes 32 or more)" if plain else "no plain version ran")
            log(f"  {m.name} bucket-32 step: launches {ran}; {note}")
            plains[m.name] = len(plain)

        # the load: 64 clients x 16 requests, every second one with ?model=
        before = {m.name: m.batcher.stats() for m in state.models}
        rows, wall = serve_load(base, names, bodies, SERVE_CLIENTS, SERVE_PER_CLIENT)
        codes = sorted({c for c, _, _ in rows})
        if codes != [200] or len(rows) != SERVE_CLIENTS * SERVE_PER_CLIENT:
            raise AssertionError(f"load: {len(rows)} responses, statuses {codes}")
        _, _, body = http(base, "/stats")
        stats = json.loads(body)
        _, _, text = http(base, "/metrics")
        metrics = prometheus_values(text.decode())
        load: dict = {"requests": len(rows), "wall_s": wall, "requests_per_s": len(rows) / wall}
        lat = sorted(t for _, _, t in rows)
        load["client_latency_ms"] = {"p50": 1e3 * lat[len(lat) // 2],
                                     "p99": 1e3 * lat[min(len(lat) - 1, int(len(lat) * 0.99))]}
        for name in names:
            sent = sum(1 for _, only, _ in rows if only in (None, name))
            s, b = stats[name], before[name]
            if s["requests"] != b["requests"] + sent:
                raise AssertionError(f"/stats counts {s['requests']} requests for {name}, "
                                     f"{b['requests']} + {sent} were sent")
            mean_batch = (s["requests"] - b["requests"]) / (s["batches"] - b["batches"])
            if mean_batch <= 1:
                raise AssertionError(f"{name}: no batch coalesced under load ({mean_batch})")
            for key, metric in (("requests", "dfd_requests_total"),
                                ("batches", "dfd_batches_total"),
                                ("mean_batch", "dfd_mean_batch_size"),
                                ("latency_ms_p50", "dfd_request_latency_ms_0.5"),
                                ("latency_ms_p99", "dfd_request_latency_ms_0.99")):
                if abs(metrics[metric, name] - s[key]) > 1e-4:
                    raise AssertionError(f"/metrics {metric} {metrics[metric, name]} against "
                                         f"/stats {key} {s[key]} for {name}")
            load[name] = {"sent": sent, "mean_batch": mean_batch,
                          "server_p50_ms": s["latency_ms_p50"],
                          "server_p99_ms": s["latency_ms_p99"]}
        log(f"  load, {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} requests (half with ?model=): "
            f"{load['requests_per_s']:.1f} requests/s over {wall:.2f} s, client latency p50 "
            f"{load['client_latency_ms']['p50']:.1f} ms p99 {load['client_latency_ms']['p99']:.1f}"
            " ms; " + "; ".join(
                f"{n} {load[n]['sent']} images, mean batch {load[n]['mean_batch']:.2f}, server "
                f"p50 {load[n]['server_p50_ms']:.1f} / p99 {load[n]['server_p99_ms']:.1f} ms"
                for n in names) + f"; /stats and /metrics agree ({smi()})")

        # a reload under load: 403 without the token, 200 with it, nothing 500
        if http(base, "/reload", b"")[0] != 403:
            raise AssertionError("/reload without the token was not refused")
        swapped = threading.Event()
        reload_out: dict = {}

        def reload():
            time.sleep(0.5)  # the load is running
            t = time.perf_counter()
            reload_out["code"], _, body = http(base, "/reload", b"",
                                               {"X-Reload-Token": SERVE_TOKEN})
            reload_out["s"], reload_out["body"] = time.perf_counter() - t, body
            swapped.set()

        old = handler.state
        reloader = threading.Thread(target=reload)
        reloader.start()
        rows, wall = serve_load(base, names, bodies, SERVE_RELOAD_CLIENTS, 0, until=swapped.is_set)
        reloader.join(timeout=300)
        codes = {c: sum(1 for x, _, _ in rows if x == c) for c in {x for x, _, _ in rows}}
        if reload_out.get("code") != 200 or handler.state is old or set(codes) - {200, 503}:
            raise AssertionError(f"reload under load: /reload {reload_out}, statuses {codes}")
        log(f"  reload under load: /reload 200 in {reload_out['s']:.1f} s; {len(rows)} requests "
            f"meanwhile, statuses {codes}")
        out.update({"against_cpu": agree, "ensemble_max_abs_diff": ens_err, "buckets": buckets,
                    "bucket32_launches": launches, "bucket32_plain_calls": plains, "load": load,
                    "reload": {"s": reload_out["s"], "statuses": codes, "requests": len(rows)}})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        if handler.state is not None:
            handler.state.close()
    out["cli"] = serve_cli(card_cfg, bodies[0], names)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 took {out['wall_s']:.1f} s")
    report["phase12"] = out


def serve_cli(config: Path, body: bytes, names: list[str]) -> dict:
    """``python -m deepfakedetection_tpu_torch.serve`` on a free loopback
    port: /healthz, one /predict, then SIGTERM and exit code 0."""
    import queue
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepfakedetection_tpu_torch.serve", "--config", str(config),
         "--host", "127.0.0.1", "--port", "0", "--max-batch", "32", "--max-wait-ms", "5",
         "--warmup", "first"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    lines: queue.Queue = queue.Queue()
    output: list[str] = []

    def read():
        for line in proc.stdout:
            output.append(line)
            lines.put(line)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        base = None
        while base is None:
            try:
                line = lines.get(timeout=max(1.0, 240 - (time.perf_counter() - t0)))
            except queue.Empty:
                raise AssertionError("the serve CLI did not start listening: "
                                     + "".join(output[-20:])) from None
            m = re.search(r"listening on (http://127\.0\.0\.1:\d+)", line)
            base = m.group(1) if m else None
        up_s = time.perf_counter() - t0
        code, _, health = http(base, "/healthz")
        code2, _, body = http(base, "/predict", body)
        results = json.loads(body)["results"] if code2 == 200 else []
        if code != 200 or json.loads(health)["models"] != names \
                or [r["model"] for r in results] != names + ["ensemble"]:
            raise AssertionError(f"serve CLI: /healthz {code} {health!r}, /predict {code2} "
                                 f"{body!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
    if rc != 0 or "drained and stopped" not in "".join(output):
        raise AssertionError(f"serve CLI exited {rc}: " + "".join(output[-20:]))
    log(f"  serve CLI: listening after {up_s:.1f} s, /healthz and /predict 200, exit 0 on "
        f"SIGTERM")
    return {"listening_after_s": up_s, "exit_code": rc}


# int8 eval (phase 13): the depthwise kernel's shapes come from the models
# themselves; its bf16 output must sit within one bf16 step of the f32
# reference (the kernel and the plain version round the same f32 value apart
# only where their exp/tanh/erf differ in the last bits)
INT8_DW_STEP = 2.0 ** -7
# at most this share of a layer's int8 inputs may sit off the card's level on
# the CPU, each by at most one level plus two bf16 steps of the value (the
# values between two quantizers differ by bf16 roundings: an SE gate near 1
# one step apart moves a whole channel by 2^-7; see ``on_card_levels``).
# Measured on an H100: at most 2.9e-3 (B3's job at batch 128; 1.5e-4 at
# batch 16), 1.7e-5 (S1), 8.3e-4 (FasterViT-2) of a layer, 2 levels;
# ``planted_fault``'s faults read 2.0e-2 (one B3 scale x 1023/1024) to 6.1e-1
# (PERF.md §6).
INT8_FLIP_FRAC = 5e-3
INT8_FLIP_LEVELS = 2.0 ** -6
# phase 13 (d)'s bench runs and the metric each must name, in this process:
# FasterViT-2's and S1's eval runs were cut when phase 15 came (phases 5 and 7
# time those forwards at batch 128), and the train run is FasterViT-2's with
# both of its benchmark variants
I8_BENCH = {
    "eval_throughput_224px_efficientnet_b3": ["--model", "efficientnet_b3"],
    "eval_throughput_224px_efficientnet_b3_int8": ["--model", "efficientnet_b3", "--int8"],
    "train_throughput_224px_faster_vit_2_224_official_convrematsc_padconv": [
        "--model", "faster_vit_2_224", "--mode", "train", "--official", "--conv-remat",
        "save-conv", "--pad-conv-stages"],
}


def int8_dw_calls(model, size: int = 224) -> list[tuple]:
    """The int8 depthwise calls of one int8 forward of ``model`` (a bf16
    model on the CPU, batch 1, a uniform scale): (H, W, C, k, stride, pads,
    act) each, in call order."""
    import torch

    from deepfakedetection_tpu_torch.ops import quant

    calls, kernel = [], quant.int8_depthwise

    def record(xq, wq, scale, bias, *, stride, pads, act, out_dtype):
        calls.append((*xq.shape[1:], wq.shape[0], stride, tuple(map(tuple, pads)), act))
        return kernel(xq, wq, scale, bias, stride=stride, pads=pads, act=act, out_dtype=out_dtype)

    quant.int8_depthwise = record
    try:
        with quant.quantized_eval(quant.QuantCtx(default_scale=0.05)), torch.no_grad():
            model(torch.zeros(1, 3, size, size))
    finally:
        quant.int8_depthwise = kernel
    return calls


def int8_dw_inputs(B, H, W, C, k, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (B, H, W, C), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, k, C), generator=g, dtype=torch.int8)
    scale = torch.rand(C, generator=g) * 2e-4 + 1e-5
    bias = torch.randn(C, generator=g) * 0.5
    return [t.to(device) for t in (xq, wq, scale, bias)]


def int8_dw_bound(B, H, W, C, k, stride, pads) -> tuple[float, str]:
    """int8 x read once, bf16 y written once, the taps, scale and bias read;
    2 k^2 integer operations an output element on the CUDA cores, counted at
    the f32 rate."""
    from deepfakedetection_tpu_torch.ops.int8_dw import out_size

    Ho, Wo = out_size(H, k, stride, pads[0]), out_size(W, k, stride, pads[1])
    out = B * Ho * Wo * C
    return bound(B * H * W * C + 2 * out + k * k * C + 8 * C, {"f32": 2 * k * k * out})


def cudnn_dw_ms(x, k: int, stride: int, pads) -> float:
    """cuDNN's bf16 depthwise conv of the same shape (context: a conv the
    int8 path does not call)."""
    import torch
    import torch.nn.functional as F

    C = x.shape[-1]
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels_last
    w = torch.randn(C, 1, k, k, device=x.device).to(torch.bfloat16)
    (pt, pb), (pl, pr) = pads
    if (pt, pl) == (pb, pr):
        return statistics.median(cuda_times(
            lambda: F.conv2d(xb, w, None, stride, (pt, pl), 1, C), runs=15))
    return statistics.median(cuda_times(
        lambda: F.conv2d(F.pad(xb, (pl, pr, pt, pb)), w, None, stride, 0, 1, C), runs=15))


def phase13_kernel(device) -> dict:
    """The int8 depthwise kernel against its plain version at every shape of
    B3's int8 forward (batch 128) and EfficientFormerV2-S1's (batch 256):
    the int32 accumulator bit-exact (no activation, scale 1, bias 0, f32
    out), the activated bf16 output within one bf16 step of the f32 plain
    version; kernel, plain and cuDNN's bf16 depthwise times (CUDA events,
    median of 15 and 3) beside the bound, summed over a forward."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.ops import int8_dw

    models = {"B3": (create_efficientnet("b3").eval(), EVAL_BATCH),
              "EFv2-S1": (create_efficientformer_v2("s1").eval(), EF_BATCH)}
    rows, err = {}, 0.0
    for label, (model, B) in models.items():
        calls = int8_dw_calls(model)
        total = {"ms": 0.0, "plain_ms": 0.0, "cudnn_bf16_ms": 0.0, "bound_ms": 0.0}
        by = {}
        for shape in sorted(set(calls), key=str):
            H, W, C, k, s, pads, act = shape
            n = calls.count(shape)
            xq, wq, scale, bias = int8_dw_inputs(B, H, W, C, k, len(by), device)
            ones, zeros = torch.ones_like(scale), torch.zeros_like(scale)
            acc = int8_dw.int8_depthwise(xq, wq, ones, zeros, stride=s, pads=pads,
                                         out_dtype=torch.float32)
            want = int8_dw.int8_depthwise_acc_plain(xq, wq, stride=s, pads=pads)
            if not torch.equal(acc.to(torch.int32), want):
                raise AssertionError(f"int8 depthwise {label} {shape}: accumulator differs")
            y = int8_dw.int8_depthwise(xq, wq, scale, bias, stride=s, pads=pads, act=act)
            ref = int8_dw.int8_depthwise_plain(xq, wq, scale, bias, stride=s, pads=pads, act=act,
                                               out_dtype=torch.float32)
            d = (y.float() - ref).abs()
            if not bool((d <= INT8_DW_STEP * ref.abs() + 1e-6 * ref.abs().max()).all()):
                raise AssertionError(f"int8 depthwise {label} {shape}: {float(d.max()):.3e} "
                                     "past one bf16 step")
            err = max(err, float(d.max()))
            ms = statistics.median(cuda_times(lambda: int8_dw.int8_depthwise(
                xq, wq, scale, bias, stride=s, pads=pads, act=act), runs=15))
            plain = statistics.median(cuda_times(lambda: int8_dw.int8_depthwise_plain(
                xq, wq, scale, bias, stride=s, pads=pads, act=act), runs=3, warmup=1))
            cudnn = cudnn_dw_ms(xq, k, s, pads)
            b_ms, b_by = int8_dw_bound(B, H, W, C, k, s, pads)
            by[str(shape)] = {"calls": n, "ms": ms, "plain_ms": plain, "cudnn_bf16_ms": cudnn,
                              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": float(d.max())}
            for key, v in (("ms", ms), ("plain_ms", plain), ("cudnn_bf16_ms", cudnn),
                           ("bound_ms", b_ms)):
                total[key] += n * v
            log(f"  {label} [{B}, {H}, {W}, {C}] k{k} s{s} {pads} {act} x{n}: {ms:.4f} ms "
                f"(plain {plain:.3f}, cuDNN bf16 {cudnn:.4f}, bound {b_ms:.4f} by {b_by}); "
                f"max|d| {float(d.max()):.2e}")
        log(f"  {label} int8 forward at batch {B}: {len(calls)} launches, {total['ms']:.3f} ms "
            f"(plain {total['plain_ms']:.2f}, cuDNN bf16 {total['cudnn_bf16_ms']:.3f}, "
            f"bound {total['bound_ms']:.3f})")
        rows[label] = {"batch": B, "launches": len(calls), **total, "shapes": by}
    b3 = rows["B3"]
    return {"max_abs_err": err, "ms": b3["ms"], "plain_ms": b3["plain_ms"],
            "bound_ms": b3["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "by_model": rows}


def int8_logits(state, build, x, device, dtype, scales):
    """Logits of ``build(dtype)`` with ``state`` under int8 ``scales``, f32 on
    the CPU."""
    import torch

    from deepfakedetection_tpu_torch.ops import quant

    model = build(dtype)
    model.load_state_dict(state)
    model = model.to(device).eval()
    with quant.quantized_eval(quant.QuantCtx(scales=scales)), torch.no_grad():
        return model(x.to(device)).float().cpu()


@contextlib.contextmanager
def quantizer_tape():
    """``quant._quantize`` replaced, while the block runs, by one that keeps
    each call's (input, inverse scale, int8 levels) on the host whenever
    ``tape.rows`` is set, those rows of the batch only: ``tape.calls`` in
    call order."""
    import types

    from deepfakedetection_tpu_torch.ops import quant

    quantize, tape = quant._quantize, types.SimpleNamespace(rows=None, calls=[])

    def taped(v, inv):
        q = quantize(v, inv)
        if tape.rows is not None:
            tape.calls.append((v[tape.rows].cpu(), inv if isinstance(inv, float) else inv.cpu(),
                               q[tape.rows].cpu()))
        return q

    quant._quantize = taped
    try:
        yield tape
    finally:
        quant._quantize = quantize


def card_int8(state, build, x, scales, device):
    """The card's bf16 int8 logits of ``state`` on ``x`` and the tape of all
    its quantizer calls."""
    import torch

    with quantizer_tape() as tape:
        tape.rows = slice(None)
        logits = int8_logits(state, build, x, device, torch.bfloat16, scales)
    return logits, tape.calls


def on_card_levels(label: str, state, build, x, scales, calls):
    """The CPU's bf16 int8 logits of ``state`` on ``x`` taken on the card's
    int8 levels ``calls`` (a ``quantizer_tape``'s), and how far the CPU's own
    levels sit from them. Quantization is discontinuous: a value one ulp from
    an int8 rounding midpoint on one device lands a level away on the other,
    and the seeded random nets carry such flips through their depth (on an
    H100 against the CPU, B3's free-running int8 logits sat 1.3e-1 of the
    scale apart where its bf16 ones sit 2-3e-2; in f32, 4.6e-2 against 3.5e-4
    without int8). So each of the card's quantizer calls must give the
    card's levels on the CPU bit for bit; the CPU's forward then quantizes
    its own inputs, records how far its levels sit from the card's (the
    largest difference, the largest share of a layer that differs, the
    elements past one level plus ``INT8_FLIP_LEVELS`` of it) and takes the
    card's, so that everything else of the forward (products, epilogues,
    activations, SE, residuals, head) can be held end to end."""
    import torch

    from deepfakedetection_tpu_torch.ops import quant

    quantize = quant._quantize
    for i, (v, inv, q) in enumerate(calls):
        if not torch.equal(quantize(v, inv), q):
            raise AssertionError(f"{label}: quantizer call {i} differs between card and CPU")
    taped, flips = iter(calls), []

    def on_cpu(v, inv):
        q_card = next(taped)[2]
        d = (quantize(v, inv).int() - q_card.int()).abs()
        past = int((d > 1 + INT8_FLIP_LEVELS * q_card.int().abs()).sum())
        flips.append((int(d.max()), float((d > 0).double().mean()), past, d.numel()))
        return q_card

    quant._quantize = on_cpu
    try:
        synced = int8_logits(state, build, x, torch.device("cpu"), torch.bfloat16, scales)
    finally:
        quant._quantize = quantize
    if len(flips) != len(calls):
        raise AssertionError(f"{label}: {len(flips)} quantizer calls on the CPU, {len(calls)} "
                             "on the card")
    worst = max(range(len(flips)), key=lambda k: flips[k][1])
    return synced, {"quantizer_calls": len(calls), "max_level_diff": max(f[0] for f in flips),
                    "max_flip_frac": flips[worst][1], "past_bound": sum(f[2] for f in flips),
                    "worst_call": worst, "worst_call_elements": flips[worst][3]}


def flips_refused(readings: dict) -> bool:
    return readings["past_bound"] > 0 or readings["max_flip_frac"] > INT8_FLIP_FRAC


def hold_to_card_levels(label: str, logits, synced, readings: dict, gate: float) -> dict:
    """The card's ``logits`` against the CPU's ``synced`` ones (computed on
    the card's levels): the CPU's own levels off the card's on at most
    ``INT8_FLIP_FRAC`` of a layer and none past the bound, then
    ``check_logits`` under ``gate``."""
    r = readings
    log(f"  {label}: {r['quantizer_calls']} quantizer calls equal to the CPU's bit for bit; the "
        f"CPU's own levels at most {r['max_level_diff']} apart, on at most "
        f"{r['max_flip_frac']:.2e} of a layer (call {r['worst_call']}, "
        f"{r['worst_call_elements']} elements), {r['past_bound']} past the bound")
    if flips_refused(r):
        raise AssertionError(f"{label}: the CPU's int8 levels differ from the card's by up to "
                             f"{r['max_level_diff']} on {r['max_flip_frac']:.2e} of a layer "
                             f"({r['past_bound']} past the bound)")
    agree = check_logits(f"{label} (card) against the CPU on the card's levels", logits, synced,
                         synced, gate=gate)
    return {**agree, **r}


def rel_dlogit(logits, ref) -> float:
    return float((logits.double() - ref.double()).abs().max() / ref.double().abs().max())


def synced_int8(label: str, state, build, x, scales, device, gate: float) -> dict:
    """The card's bf16 int8 logits of ``state`` on ``x`` against the CPU's on
    the card's int8 levels (``on_card_levels``, ``hold_to_card_levels``); the
    free-running CPU's distance is logged, no gate."""
    import torch

    card, calls = card_int8(state, build, x, scales, device)
    synced, readings = on_card_levels(label, state, build, x, scales, calls)
    agree = hold_to_card_levels(label, card, synced, readings, gate)
    free = int8_logits(state, build, x, torch.device("cpu"), torch.bfloat16, scales)
    dist = rel_dlogit(card, free)
    log(f"  {label}: free-running CPU max|dlogit|/scale {dist:.3e} (no gate)")
    return {**agree, "free_running_max_rel_dlogit": dist}


@contextlib.contextmanager
def silu_for_gelu():
    """A planted fault: the int8 depthwise kernel's GELU epilogue run as
    SiLU."""
    from deepfakedetection_tpu_torch.ops import quant

    kernel = quant.int8_depthwise

    def swapped(*args, act="none", **kwargs):
        return kernel(*args, act="silu" if act.startswith("gelu") else act, **kwargs)

    quant.int8_depthwise = swapped
    try:
        yield
    finally:
        quant.int8_depthwise = kernel


def planted_fault(label: str, state, build, x, scales, device, gate: float, *,
                  card_scales=None, patch=contextlib.nullcontext) -> dict:
    """``synced_int8``'s readings of a card run with a planted fault (other
    activation scales on the card than on the CPU, or ``patch`` around the
    card's forward): the checks must refuse it."""
    with patch():
        card, calls = card_int8(state, build, x, card_scales or scales, device)
    synced, r = on_card_levels(label, state, build, x, scales, calls)
    r["max_rel_dlogit"] = rel_dlogit(card, synced)
    log(f"  planted fault, {label}: the CPU's own levels at most {r['max_level_diff']} apart, on "
        f"at most {r['max_flip_frac']:.2e} of a layer, {r['past_bound']} past the bound; "
        f"max|dlogit|/scale {r['max_rel_dlogit']:.3e} on the card's levels (gate {gate})")
    if not (flips_refused(r) or r["max_rel_dlogit"] > gate):
        raise AssertionError(f"planted fault, {label}: passed the int8 checks {r}")
    return r


def stem_check(state, x, scales, device) -> dict:
    """B3's stem under int8 on the card and on the CPU: its int8 input and
    its int32 accumulator, from each device's own folded weights, bit for
    bit (and the card's product of the CPU's int8 weights)."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.ops import quant

    out = {}
    for dev in (torch.device("cpu"), device):
        model = create_efficientnet("b3")
        model.load_state_dict(state)
        stem = model.to(dev).eval().stem
        sx = scales[stem.name]
        xq = quant.quantize_act(x.to(dev).to(torch.bfloat16).permute(0, 2, 3, 1), sx)
        qw = stem._int8.get(stem._params(), quant.as_scale(sx))
        out[dev.type] = (xq, qw, quant.accumulate(xq, qw, stem.conv.stride, stem.pads).cpu())
    (xq_c, qw_c, acc_c), (xq_g, qw_g, acc_g) = out["cpu"], out[device.type]
    wq_diff = int((qw_c.wq != qw_g.wq.cpu()).sum())
    qw_moved = dataclasses.replace(qw_c, wq=qw_c.wq.to(device))
    acc_moved = quant.accumulate(xq_g, qw_moved, stem.conv.stride, stem.pads).cpu()
    xq_g = xq_g.cpu()
    res = {"xq_equal": torch.equal(xq_c, xq_g), "acc_equal": torch.equal(acc_c, acc_g),
           "acc_equal_cpu_weights": torch.equal(acc_c, acc_moved), "wq_differ": wq_diff,
           "acc_shape": list(acc_c.shape)}
    log(f"  stem under int8, card against CPU: int8 input equal {res['xq_equal']}, int32 "
        f"accumulator {list(acc_c.shape)} equal {res['acc_equal']} (with the CPU's int8 "
        f"weights {res['acc_equal_cpu_weights']}; int8 weights differing {wq_diff})")
    if not (res["xq_equal"] and res["acc_equal_cpu_weights"]) \
            or (wq_diff == 0 and not res["acc_equal"]):
        raise AssertionError(f"B3 stem under int8: the card differs from the CPU {res}")
    return res


def phase13_job(device, report) -> int:
    """``orchestrate(mode="inference")`` with ``inference.precision: int8``
    on B3 from phase 3's ``.pth`` over phase 3's tree: the int8 kernel's
    launches (K1 and K2 none), ``metrics.jsonl``'s precision, and the job's
    own output on ``test_picks``' 16 images. The job's quantizer calls are
    taped (``quantizer_tape``) on those rows of the two test batches that
    hold them; on those images the stem's int8 input and int32 accumulator
    must equal the CPU's, and the job's probabilities must match the CPU
    port's int8 logits on the job's levels (``on_card_levels``,
    ``check_logits``' 5e-2 gate); one layer's scale planted off by 127/128,
    and by 1023/1024, on the card must be refused. The same images at batch
    16 on the card against the CPU on their own levels, under the same
    gate; ungated, their levels and logits against the job's at its batch,
    the free-running CPU, and int8 against bf16."""
    import itertools

    import numpy as np
    import torch
    import yaml

    from deepfakedetection_tpu_torch.evaluate import job as eval_job
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.ops import int8_dw
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke"
    data, weights = work / "data", work / "efficientnet_b3_seeded.pth"  # phase 3's
    state = torch.load(weights, weights_only=True)
    cfg_path = eval_config(work, "inference_int8.yaml", "efficientnet_b3", "runs_int8", weights,
                           EVAL_BATCH, device)
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["models"]["efficientnet_b3"]["inference"]["precision"] = "int8"
    cfg_path.write_text(yaml.safe_dump(cfg))
    # the job's eval step runs val's batches, then test's: the calls that see the picks
    picks, first = test_picks(data), -(-SPLITS["val"] // EVAL_BATCH)
    rows: dict[int, list[int]] = {}
    for i in picks:
        rows.setdefault(first + i // EVAL_BATCH, []).append(i % EVAL_BATCH)
    if any(r != list(range(r[0], r[-1] + 1)) for r in rows.values()):
        raise AssertionError(f"the picks' rows are not contiguous in their batches: {rows}")
    rows_of = {c: slice(r[0], r[-1] + 1) for c, r in rows.items()}
    make, taped = eval_job.make_eval_step, {}

    def taped_make(model, tta=None):
        step, calls = make(model, tta), itertools.count()

        def taped_step(x):
            i = next(calls)
            tape.rows, start = rows_of.get(i), len(tape.calls)
            try:
                p = step(x)
            finally:
                tape.rows = None
            if i in rows_of:
                taped[i] = (x[rows_of[i]].cpu(), p[rows_of[i]].cpu(), tape.calls[start:])
            return p

        return taped_step

    int8_dw.int8_depthwise.launches = 0
    t0 = time.perf_counter()
    with quantizer_tape() as tape:
        eval_job.make_eval_step = taped_make
        try:
            res, others = counted(
                lambda: orchestrate(cfg_path, mode="inference")["efficientnet_b3"])
        finally:
            eval_job.make_eval_step = make
    wall = time.perf_counter() - t0
    launches = int8_dw.int8_depthwise.launches
    batches = sum(-(-n // EVAL_BATCH) for n in SPLITS.values())
    log(f"  int8 main path: {batches} forward batches (and 2 calibration batches), int8 "
        f"depthwise launches {launches}, others {others}; test pass {res.images_per_s:.1f} "
        f"img/s (decode included, and the tape of {len(rows)} batches' rows; phase 3 in bf16 "
        f"{report['phase3']['test_img_per_s']:.1f}); wall {wall:.1f} s")
    if launches != 26 * batches or any(others.values()):
        raise AssertionError(f"int8 main path launches {launches} and {others}, expected "
                             f"26 x {batches} and none")
    if res.probs.shape != (SPLITS["test"], 2) or not np.isfinite(res.probs).all():
        raise AssertionError(f"bad int8 test probabilities {res.probs.shape}")
    run = sorted((work / "runs_int8").iterdir())[-1]
    record = json.loads((run / "logs" / "metrics.jsonl").read_text().splitlines()[-1])
    scales = res.int8_scales
    if record.get("precision") != "int8" or len(scales) != 78:
        raise AssertionError(f"int8 metrics.jsonl {record}, {len(scales)} scales")

    order = sorted(taped)
    tapes = [taped[c][2] for c in order]
    if order != sorted(rows_of) or len({len(t) for t in tapes}) != 1:
        raise AssertionError(f"the job's taped batches {order}: {[len(t) for t in tapes]} calls")
    x = torch.cat([taped[c][0] for c in order])
    if not np.array_equal(torch.cat([taped[c][1] for c in order]).numpy(), res.probs[picks]):
        raise AssertionError("the taped eval steps' probabilities are not the job's")
    calls = []
    for k, first_tape in enumerate(tapes[0]):
        if any(not torch.equal(torch.as_tensor(t[k][1]), torch.as_tensor(first_tape[1]))
               for t in tapes):
            raise AssertionError(f"quantizer call {k}: scales differ between the job's batches")
        calls.append((torch.cat([t[k][0] for t in tapes]), first_tape[1],
                      torch.cat([t[k][2] for t in tapes])))

    def build(dt):
        return create_efficientnet("b3", dtype=dt)

    def diff_rows(logits):
        return logits.double() - logits[:, :1].double()

    stem = stem_check(state, x, scales, device)
    label = f"B3 int8 job, its own probabilities on 16 test images at batch {EVAL_BATCH}"
    synced, readings = on_card_levels(label, state, build, x, scales, calls)
    job = logit_diff_rows(res.probs[picks])
    agree = hold_to_card_levels(label, job, diff_rows(synced), readings, gate=5e-2)
    free = rel_dlogit(job, diff_rows(
        int8_logits(state, build, x, torch.device("cpu"), torch.bfloat16, scales)))
    card16, calls16 = card_int8(state, build, x, scales, device)
    label16 = "B3 int8, the same 16 images at batch 16 on the card"
    synced16, readings16 = on_card_levels(label16, state, build, x, scales, calls16)
    agree16 = hold_to_card_levels(label16, card16, synced16, readings16, gate=5e-2)
    moved = [(a[2].int() - b[2].int()).abs() for a, b in zip(calls16, calls)]
    batch16 = {"calls_moved": sum(bool(d.any()) for d in moved),
               "first_moved": next((k for k, d in enumerate(moved) if d.any()), None),
               "max_level_diff": max(int(d.max()) for d in moved),
               "max_moved_frac": max(float((d > 0).double().mean()) for d in moved),
               "max_rel_dlogit": rel_dlogit(job, diff_rows(card16))}
    log(f"  batch 16 against the job's batch {EVAL_BATCH}, both on the card: levels apart"
        f" in {batch16['calls_moved']} of {len(moved)} quantizer calls (first "
        f"{batch16['first_moved']}), by up to {batch16['max_level_diff']}, on at most "
        f"{batch16['max_moved_frac']:.2e} of a layer; max|dlogit|/scale "
        f"{batch16['max_rel_dlogit']:.3e}; the free-running CPU against the job's {free:.3e} "
        "(no gate)")
    name = list(scales)[len(scales) // 2]
    faults = {f"x {k - 1}/{k}": planted_fault(
        f"B3, {name}'s scale x {k - 1}/{k} on the card", state, build, x, scales, device, 5e-2,
        card_scales={**scales, name: scales[name] * (k - 1) / k}) for k in (128, 1024)}
    model = build(torch.bfloat16)
    model.load_state_dict(state)
    with torch.no_grad():
        card_bf16 = diff_rows(model.to(device).eval()(x.to(device)).float().cpu())
    dist = rel_dlogit(job, card_bf16)
    same = float((job.argmax(-1) == card_bf16.argmax(-1)).double().mean())
    log(f"  the job's int8 against bf16 on the card, 16 test images: max|dlogit|/scale "
        f"{dist:.3e}, argmax agreement {same:.3f} (no gate)")
    report["phase13_job"] = {"launches": launches, "others": others, "batches": batches,
                             "metrics": record, "test_img_per_s": res.images_per_s,
                             "wall_s": wall, "reference": agree, "stem": stem,
                             "free_running_max_rel_dlogit": free,
                             "batch16": {**batch16, "reference": agree16},
                             "planted_faults": {"layer": name, **faults},
                             "int8_vs_bf16": {"max_rel_dlogit": dist, "argmax_agree": same}}
    return launches


def phase13_models(device, report) -> dict:
    """An int8 forward of EfficientFormerV2-S1 (phase 7's ``.pth``) and of
    FasterViT-2 official (phase 5's) on 8 seeded images, scales calibrated
    on the card, against the CPU's int8 logits on the card's int8 levels
    (``synced_int8``) under each model's gate; S1's int8 depthwise GELU
    planted as SiLU on the card must be refused."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2
    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.ops import int8_dw, quant

    work = REPO / "build" / "chip_smoke"
    # (weights, gate, builder, launches a forward: K7 and K5 stay on under int8, a planted fault)
    cases = {"EfficientFormerV2-S1": (f"{EF}_seeded.pth", EFV2_GATE,
                                      lambda dt: create_efficientformer_v2("s1", dtype=dt),
                                      {"k7": 4, "int8_dw": 29}, silu_for_gelu),
             "FasterViT-2 official": (f"{FV}_seeded.pth", FV_GATE["official"],
                                      lambda dt: create_faster_vit("2", head_config="official",
                                                                   dtype=dt),
                                      {"k5": 13}, None)}
    out = {}
    for i, (label, (name, gate, build, want, fault)) in enumerate(cases.items()):
        state = torch.load(work / name, weights_only=True)
        x = seeded_images(8, torch.Generator().manual_seed(130 + i))
        model = build(torch.bfloat16)
        model.load_state_dict(state)
        scales = quant.calibrate_act_scales(model.to(device).eval(),
                                            [x.to(device).to(torch.bfloat16)])
        int8_dw.int8_depthwise.launches = 0
        _, launches = counted(lambda: int8_logits(state, build, x, device, torch.bfloat16,
                                                  scales))
        launches["int8_dw"] = int8_dw.int8_depthwise.launches
        log(f"  {label}: {len(scales)} calibrated convs; launches {launches}")
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"{label} int8 forward: launches {launches}, expected {want}")
        out[label] = {"scales": len(scales), "launches": launches,
                      **synced_int8(f"{label} int8 forward", state, build, x, scales, device,
                                    gate)}
        if fault is not None:
            out[label]["planted_fault"] = planted_fault(
                f"{label}, the int8 depthwise GELU run as SiLU on the card", state, build, x,
                scales, device, gate, patch=fault)
    report["phase13_models"] = out
    return out


def phase13_bench(report) -> list[dict]:
    """The bench's ``main`` (what ``python -m deepfakedetection_tpu_torch.bench``
    runs) for each of ``I8_BENCH`` in this process: each run's one JSON line,
    naming its metric."""
    import io

    from deepfakedetection_tpu_torch import bench

    lines = []
    for metric, argv in I8_BENCH.items():
        out, t0 = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main(argv)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"  bench {' '.join(argv)}: {json.dumps(line)} ({time.perf_counter() - t0:.1f} s)")
        if set(line) != {"metric", "value", "unit", "vs_baseline"} or line["metric"] != metric \
                or not line["value"] > 0 or line["vs_baseline"] is not None:
            raise AssertionError(f"bench {argv}: {line}")
        lines.append(line)
    report["phase13_bench"] = lines
    return lines


def phase13(device, report) -> tuple[dict, int]:
    """int8 eval: the kernel (a), the job (b), two more models (c), the bench (d)."""
    row = phase13_kernel(device)
    report["phase13_kernel"] = row
    launches = phase13_job(device, report)
    phase13_models(device, report)
    phase13_bench(report)
    return row, launches


EXPORT_BATCH = 64  # phase 14's static batch (the JAX export's default)
EXPORT_RUNS = 20  # CUDA-event timings of each forward


def export_counts(module) -> dict[str, int]:
    """The ``torch.ops.dfd`` nodes of a loaded program's graphs, by operator."""
    import torch

    counts: dict[str, int] = {}
    for gm in module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                if node.op == "call_function" and str(node.target).startswith("dfd."):
                    name = str(node.target).split(".")[1]
                    counts[name] = counts.get(name, 0) + 1
    return counts


def eager_eval_step(name: str, weights: Path, device):
    """The eval job's eager step for ``name`` from ``weights``
    (``load_model_for_eval`` at 224 px, ``make_eval_step``), on NCHW input."""
    from deepfakedetection_tpu_torch.evaluate.job import (
        EvalJob,
        load_model_for_eval,
        make_eval_step,
    )
    from deepfakedetection_tpu_torch.registry import get_model_spec
    from deepfakedetection_tpu_torch.runtime.paths import RunPaths

    job = EvalJob(model_name=name, spec=get_model_spec(name),
                  run_paths=RunPaths(*(weights.parent,) * 4), data_root=weights.parent,
                  device=device, img_size=224, batch_size=EXPORT_BATCH, weights=weights)
    return make_eval_step(load_model_for_eval(job))


def phase14_load(spec_path: str) -> int:
    """Phase 14's fresh process: loads each exported program with
    ``load_exported`` (which imports no model module), runs it on the seeded
    batch and writes, per program, its probabilities, the launches of one
    forward, its ``torch.ops.dfd`` nodes, plain-version calls and its
    CUDA-event ms; and the port's model modules this process imported."""
    import torch

    from deepfakedetection_tpu_torch.export import load_exported
    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.ops import attn_block as k6
    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.ops import expand_dw as k2
    from deepfakedetection_tpu_torch.ops import fused_mbconv as k3
    from deepfakedetection_tpu_torch.ops import window_attn as k5

    spec = json.loads(Path(spec_path).read_text())
    x = torch.load(spec["batch"], weights_only=True).to(spec["device"])
    plain: list[str] = []
    for module, name in ((k1, "depthwise_silu_pool_plain"), (k2, "expand_dw_silu_pool_plain"),
                         (k3, "fused_mbconv_se_plain"), (k5, "window_attention_plain"),
                         (k5, "window_attention_heads_plain"), (k6, "attn_subblock_plain"),
                         (k7, "attn4d_plain")):
        fn = getattr(module, name)
        setattr(module, name, lambda *a, _n=name, _f=fn, **kw: (plain.append(_n), _f(*a, **kw))[1])
    out = {}
    for name, path in spec["programs"].items():
        t0 = time.perf_counter()
        program = load_exported(path)
        load_s = time.perf_counter() - t0
        probs, launches = counted(lambda: program(x))
        torch.save(probs.cpu(), Path(spec["out"]) / f"{name}_probs.pt")
        out[name] = {"load_s": load_s, "launches": {k: v for k, v in launches.items() if v},
                     "nodes": export_counts(program), "plain_calls": list(plain),
                     "ms": spread(cuda_times(lambda: program(x), EXPORT_RUNS))}
        plain.clear()
    out["model_modules"] = sorted(m for m in sys.modules
                                  if m.startswith("deepfakedetection_tpu_torch.models"))
    (Path(spec["out"]) / "loaded.json").write_text(json.dumps(out))
    return 0


def phase14_parent_forward(spec_path: str) -> int:
    """``--parent``'s process for phase 14, run with that checkout first on
    ``sys.path``: its eager eval steps of the three models on the seeded
    batch (probabilities and CUDA-event ms). Its kernel library is this
    tree's when both are built from the same sources (same file name)."""
    import torch

    spec = json.loads(Path(spec_path).read_text())
    from deepfakedetection_tpu_torch.ops import build

    if not Path(build.__file__).resolve().is_relative_to(Path(spec["parent"]).resolve()):
        raise AssertionError(f"the parent's process imported {build.__file__}")
    ours = Path(spec["library"])
    if not build.library_path().exists() and build.library_path().name == ours.name:
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        shutil.copy2(ours, build.library_path())
    device = torch.device(spec["device"])
    x = torch.load(spec["batch"], weights_only=True).to(device).permute(0, 3, 1, 2)
    out = {}
    for name, weights in spec["weights"].items():
        step = eager_eval_step(name, Path(weights), device)
        with torch.no_grad():
            torch.save(step(x).cpu(), Path(spec["out"]) / f"{name}_parent_probs.pt")
        out[name] = spread(cuda_times(lambda: step(x), EXPORT_RUNS))
    (Path(spec["out"]) / "parent.json").write_text(json.dumps(out))
    return 0


def phase14_child(func: str, spec: Path, parent: str | None = None) -> None:
    """Runs ``chip_smoke.<func>(spec)`` in a fresh interpreter (with
    ``parent`` ahead of this tree on its path when given); raises on failure."""
    head = f"sys.path[:0] = [{parent!r}]; " if parent else ""
    # this file by its path: a parent checkout has a chip_smoke.py of its own
    code = (f"import importlib.util, sys; {head}sys.path.append({str(REPO)!r}); "
            f"s = importlib.util.spec_from_file_location('phase14', {str(Path(__file__))!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            f"sys.exit(m.{func}({str(spec)!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=parent or REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 14 {func} failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")


def phase14(device, report, parent: str | None = None) -> dict:
    """Export: config/inference.yaml's three models from the seeded ``.pth``
    files of phases 3, 5 and 7 through ``export_model`` at batch 64 on the
    card (timed), each program loaded in a fresh process that imports no
    model module, its probabilities on one seeded NHWC bf16 batch
    bit-identical to the eager eval step's in this process, its launches a
    forward those of ``PREDICT_LAUNCHES`` with no plain version, its and the
    eager forward's CUDA-event ms; the operator route's cost a call
    (``profile_dispatch``); with ``parent``, that checkout's eager steps on
    the same batch, bit-identical to this tree's."""
    import torch

    from deepfakedetection_tpu_torch import profile_dispatch
    from deepfakedetection_tpu_torch.export import export_model
    from deepfakedetection_tpu_torch.ops import build

    seeded = REPO / "build" / "chip_smoke"
    work = REPO / "build" / "chip_smoke_export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    x = seeded_images(EXPORT_BATCH, torch.Generator().manual_seed(14))
    x = x.permute(0, 2, 3, 1).contiguous().to(torch.bfloat16)  # the artifact's NHWC input
    torch.save(x, work / "batch.pt")
    xd = x.to(device).permute(0, 3, 1, 2)  # the eager step's channels_last NCHW view
    weights = {name: str(seeded / f"{name}_seeded.pth") for name in PREDICT_LAUNCHES}
    rows, steps, probs = {}, {}, {}
    for name in PREDICT_LAUNCHES:
        t0 = time.perf_counter()
        export_model(name, Path(weights[name]), work / f"{name}.pt2", batch=EXPORT_BATCH,
                     device=str(device))
        export_s = time.perf_counter() - t0
        steps[name] = eager_eval_step(name, Path(weights[name]), device)
        with torch.no_grad():
            probs[name] = steps[name](xd).cpu()
        rows[name] = {"export_s": export_s,
                      "bytes": (work / f"{name}.pt2").stat().st_size,
                      "eager_ms": spread(cuda_times(lambda: steps[name](xd), EXPORT_RUNS))}
        log(f"  {name}: exported in {export_s:.1f} s ({rows[name]['bytes'] / 2**20:.1f} MiB); "
            f"eager step {rows[name]['eager_ms']['median']:.3f} ms at batch {EXPORT_BATCH}")
    spec = work / "load.json"
    spec.write_text(json.dumps({"batch": str(work / "batch.pt"), "out": str(work),
                                "device": str(device),
                                "programs": {n: str(work / f"{n}.pt2") for n in weights}}))
    phase14_child("phase14_load", spec)
    loaded = json.loads((work / "loaded.json").read_text())
    if loaded.pop("model_modules"):
        raise AssertionError("load_exported imported the port's model modules")
    for name, want in PREDICT_LAUNCHES.items():
        row = {**rows[name], **loaded[name]}
        got = torch.load(work / f"{name}_probs.pt", weights_only=True)
        if got.shape != (EXPORT_BATCH, 2) or got.dtype != torch.float32:
            raise AssertionError(f"{name}: the program gave {tuple(got.shape)} {got.dtype}")
        if not torch.equal(got, probs[name]):
            raise AssertionError(f"{name}: the loaded program's probabilities are not the eager "
                                 f"step's (max|d| {float((got - probs[name]).abs().max()):.3e})")
        names = {"k1": "depthwise_silu_pool", "k2": "expand_dw_silu_pool", "k5":
                 "window_attention", "k7": "attn4d"}
        if row["launches"] != want or row["nodes"] != {names[k]: v for k, v in want.items()} \
                or row["plain_calls"]:
            raise AssertionError(f"{name}: loaded program launched {row['launches']} with "
                                 f"nodes {row['nodes']} and plain calls {row['plain_calls']}, "
                                 f"expected {want}")
        log(f"  {name}: loaded in a fresh process in {row['load_s']:.1f} s, bit-identical, "
            f"launches {row['launches']}; loaded {row['ms']['median']:.3f} ms against eager "
            f"{row['eager_ms']['median']:.3f} ms at batch {EXPORT_BATCH}")
        rows[name] = row
    if parent:
        spec = work / "parent.json.in"
        spec.write_text(json.dumps({"batch": str(work / "batch.pt"), "out": str(work),
                                    "device": str(device), "weights": weights,
                                    "parent": str(Path(parent).resolve()),
                                    "library": str(build.library_path())}))
        phase14_child("phase14_parent_forward", spec, str(Path(parent).resolve()))
        theirs = json.loads((work / "parent.json").read_text())
        for name in PREDICT_LAUNCHES:
            got = torch.load(work / f"{name}_parent_probs.pt", weights_only=True)
            if not torch.equal(got, probs[name]):
                raise AssertionError(f"{name}: the parent's eager step differs "
                                     f"(max|d| {float((got - probs[name]).abs().max()):.3e})")
            rows[name]["parent_ms"] = theirs[name]
            rows[name]["eager_ms_after"] = spread(cuda_times(lambda: steps[name](xd),
                                                             EXPORT_RUNS))
            log(f"  {name}: the parent's eager step bit-identical; in turns this "
                f"{rows[name]['eager_ms']['median']:.3f}, parent "
                f"{theirs[name]['median']:.3f}, this {rows[name]['eager_ms_after']['median']:.3f}"
                " ms")
    dispatch = profile_dispatch.measure(device)
    log("  µs a call: " + ", ".join(f"{k} {v:.2f}" for k, v in dispatch.items()) + f" ({smi()})")
    report["phase14"] = {"models": rows, "dispatch_us": dispatch, "card": smi()}
    return rows


SHARD_IMAGES = 256  # images a tar shard in phase 15
REMAT_SEED = 31  # the generator of phase 15's remat steps (dropout and drop-path masks)
REMAT_BATCH = 128  # phase 15's remat steps: the recipes' fine-tune batch
REMAT_VARIANTS = {"plain": {}, "remat": {"remat": True}, "conv full": {"conv_remat": "full"},
                  "conv save-conv": {"conv_remat": "save-conv"}}


def pack_shards(data: Path, out: Path) -> dict:
    """``python -m deepfakedetection_tpu_torch.data.shards`` over the JPEG
    tree ``data`` into ``out`` in a subprocess; each split's shards must scan
    to the folder's samples and bytes."""
    from deepfakedetection_tpu_torch.data.pipeline import scan_image_folder

    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepfakedetection_tpu_torch.data.shards",
                           "--root", str(data), "--out", str(out), "--images-per-shard",
                           str(SHARD_IMAGES)], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"packing {data} failed: {proc.stderr[-2000:]}")
    counts = {}
    for split in sorted(d.name for d in data.iterdir()):
        folder, shards = scan_image_folder(data / split), scan_image_folder(out / split)
        if (not hasattr(shards, "read_bytes") or shards.classes != folder.classes
                or [label for _, label in shards.samples] != [label for _, label in folder.samples]
                or shards.read_bytes(len(shards) - 1) != folder.samples[-1][0].read_bytes()):
            raise AssertionError(f"the {split} shards of {data} do not scan to the folder's")
        counts[split] = (len(shards), len(shards.shards))
    log(f"  packed {data} into {out} in {seconds:.1f} s (a subprocess): {counts} "
        f"(images, shards); {proc.stdout.strip().splitlines()[-1]}")
    return {"seconds": seconds, "splits": counts}


def phase15_eval(device, report) -> dict:
    """(a) B3's eval job over phase 3's tree packed into tar shards: the
    launches, the test probabilities bit-identical to phase 3's run over the
    folder tree, the job's and the loader's img/s beside the folder's."""
    import numpy as np

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.orchestrator import orchestrate

    work = REPO / "build" / "chip_smoke"
    shards = work / "shards"
    packed = pack_shards(work / "data", shards)
    per_forward = create_efficientnet("b3").eval().kernel_launches_per_forward()
    cfg = eval_config(work, "inference_shards.yaml", "efficientnet_b3", "runs_shards",
                      work / "efficientnet_b3_seeded.pth", EVAL_BATCH, device, data=shards)
    res, launches = counted(lambda: orchestrate(cfg, mode="inference")["efficientnet_b3"])
    batches = sum(-(-n // EVAL_BATCH) for n in SPLITS.values())
    want = {**ZERO_LAUNCHES, "k1": per_forward["k1"] * batches,
            "k2": per_forward["k2"] * batches}
    folder_probs = np.load(work / "test_probs.npy")
    same = res.probs.shape == folder_probs.shape and np.array_equal(res.probs, folder_probs)
    rates = {name: decode_rate(root) for name, root in
             (("folder", work / "data"), ("shards", shards), ("shards again", shards),
              ("folder again", work / "data"))}
    log(f"  B3 eval job over shards: launches {launches} over {batches} batches; test "
        f"probabilities bit-identical to phase 3's over the folder tree: {same}; test pass "
        f"{res.images_per_s:.1f} img/s (phase 3 over the folder "
        f"{report['phase3']['test_img_per_s']:.1f}, decode included); the loader alone, in turns, "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + " img/s")
    if launches != want or not same:
        raise AssertionError(f"the eval job over shards: launches {launches} (expected {want}), "
                             f"probabilities bit-identical {same}")
    return {"packed": packed, "launches": launches, "batches": batches,
            "test_img_per_s": res.images_per_s,
            "folder_test_img_per_s": report["phase3"]["test_img_per_s"],
            "loader_img_per_s": rates}


def phase15_train(device, report) -> dict:
    """(b) The full-width FasterViT-2 training run over phase 8's tree packed
    into tar shards, from phase 5's seeded official ``.pth``, with
    ``training.remat`` and ``training.async_checkpoint``: the K5 launches a
    step, finite losses, the checkpoints (``latest.ckpt`` equal to the live
    model), a resume with ``profile_dir`` too and its trace, the inference
    handoff over the shards."""
    import numpy as np
    import torch

    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.ops import window_attn as k5
    from deepfakedetection_tpu_torch.orchestrator import orchestrate
    from deepfakedetection_tpu_torch.train import loop

    # K5 a forward (13); under remat a step runs each forward twice
    k = create_faster_vit("2", head_config="official").kernel_launches_per_forward()["k5"]
    # phase 8's tree (FV_FUSED_SPLITS), a quarter of phase 4's: a quarter of
    # the steps, and of the resume's trace
    work = REPO / "build" / "chip_smoke_fused"
    shards = work / "shards"
    packed = pack_shards(work / "data", shards)
    traces = work / "traces_remat"
    for d in (work / "runs_remat", traces):
        shutil.rmtree(d, ignore_errors=True)
    options = {"remat": True, "async_checkpoint": True, "resume": "continue"}
    pth = REPO / "build" / "chip_smoke" / "faster_vit_2_224_seeded.pth"
    n_train, n_val, n_test = (FV_FUSED_SPLITS[k] for k in ("train", "val", "test"))
    warmup_steps, ft_steps, val_batches = n_train // 64, n_train // 128, -(-n_val // 64)

    per_step, live = [], []
    real_step = loop.train_step

    def step_spy(model, opt, *args, **kw):
        before = (k5.window_attention.launches, k5.window_attention_bwd.launches)
        out = real_step(model, opt, *args, **kw)
        per_step.append((opt.n_train == opt.n_total, kw.get("remat"),
                         k5.window_attention.launches - before[0],
                         k5.window_attention_bwd.launches - before[1]))
        live[:] = [model]
        return out

    def train(epochs: int, **kw):
        cfg = fv_train_config(work, shards, device, runs="runs_remat", init_weights=pth,
                              epochs=epochs, training=options, **kw)
        return counted(lambda: orchestrate(cfg, mode="training")[FV])

    loop.train_step = step_spy
    try:
        t0 = time.perf_counter()
        res, launches = train(1)
        wall = time.perf_counter() - t0
        (run,) = sorted((work / "runs_remat").iterdir())
        latest = torch.load(run / "checkpoints" / "latest.ckpt", weights_only=True)
        live_state = {k: v.cpu() for k, v in live[0].state_dict().items()}
        first = list(per_step)
        t0 = time.perf_counter()
        res2, launches2 = train(2, profile_dir=traces)
        wall2 = time.perf_counter() - t0
    finally:
        loop.train_step = real_step
    want_steps = ([(False, True, 2 * k, 0)] * warmup_steps
                  + [(True, True, 2 * k, k)] * ft_steps)
    want = {**ZERO_LAUNCHES, "k5": 2 * k * (warmup_steps + ft_steps) + k * 2 * val_batches,
            "k5_bwd": k * ft_steps}
    log(f"  FasterViT-2 training over shards with remat and async checkpoints (official "
        f"from phase 5's .pth): {warmup_steps} warmup and {ft_steps} fine-tune steps, "
        f"{2 * val_batches} val batches; launches {launches}; K5 forward/backward a warmup step "
        f"{first[0][2:]}, a fine-tune step {first[-1][2:]}; wall {wall:.1f} s")
    if launches != want or first != want_steps:
        raise AssertionError(f"remat training launches {launches} (expected {want}), per step "
                             f"{first}")
    ckpts = run / "checkpoints"
    for name in ("latest.ckpt", "best.ckpt", f"{FV}.pth"):
        if not (ckpts / name).is_file():
            raise AssertionError(f"the remat run wrote no {name}")
    diff = [k for k, v in live_state.items() if not torch.equal(latest["model"][k], v)]
    if diff or latest["model"].keys() != live_state.keys():
        raise AssertionError(f"latest.ckpt differs from the live model at the run's end: "
                             f"{diff[:5]}")
    log_text = (run / "logs" / "train.log").read_text()
    losses = [float(x) for x in re.findall(r": loss=(\S+) \|", log_text)]
    if (len(losses) != 3 or not all(np.isfinite(losses)) or res.interrupted
            or "async checkpointing" not in log_text):
        raise AssertionError(f"bad remat training run: losses {losses}, {res}")
    state2 = torch.load(ckpts / "latest.ckpt", weights_only=True)
    if (res2.epochs_run != 1 or state2["counters"]["epoch"] != 1
            or per_step[len(first):] != [(True, True, 2 * k, k)] * ft_steps
            or launches2["k5_bwd"] != k * ft_steps):
        raise AssertionError(f"resume: {res2}, counters {state2['counters']}, launches {launches2}")
    log(f"  losses {[round(x, 4) for x in losses]}; latest.ckpt equal to the live model; the "
        f"resume ran epoch 2 only ({ft_steps} steps, K5 {launches2['k5']}/{launches2['k5_bwd']}) "
        f"in {wall2:.1f} s with profile_dir")

    ires, ilaunch = counted(lambda: orchestrate(
        fv_train_config(work, shards, device, runs="runs_remat", epochs=2, training=options),
        mode="inference")[FV])
    if (ires.probs.shape != (n_test, 2) or not np.isfinite(ires.probs).all()
            or ilaunch["k5"] != k * (-(-n_test // 64) + val_batches)
            or ilaunch["k5_bwd"]):
        raise AssertionError(f"inference over shards on the trained FasterViT: "
                             f"{ires.probs.shape} {ilaunch}")

    (trace,) = traces.glob("*.pt.trace.json")
    t0 = time.perf_counter()
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    found = {kernel: sum(kernel in n for n in names) > 0
             for kernel in (*k5.FWD_KERNELS, *k5.BWD_KERNELS)}
    log(f"  inference with weights: auto over shards: accuracy {ires.metrics['accuracy']:.4f}, "
        f"K5 {ilaunch['k5']}; trace {trace.name}: {trace.stat().st_size / 2**20:.1f} MiB, "
        f"{len(events)} events, parsed in {time.perf_counter() - t0:.1f} s; K5 kernels named "
        f"{found}")
    if not all(found.values()):
        raise AssertionError(f"the trace names no {[k for k, v in found.items() if not v]}")
    return {"packed": packed, "launches": launches, "per_step": first, "losses": losses,
            "wall_s": wall, "resume_launches": launches2, "resume_wall_s": wall2,
            "inference_launches": ilaunch, "trace_mib": trace.stat().st_size / 2**20}


def recording_optimizer(named):
    """A ``PhaseOptimizer`` over every tensor that keeps its last step's
    gradients on the CPU (``.grads``)."""
    import torch

    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate

    class Recording(PhaseOptimizer):
        def step(self, grads):
            self.grads = [g.to("cpu", torch.float32, copy=True) for g in grads]
            super().step(grads)

    return Recording(named, lr=1e-4, weight_decay=5e-2, trainable=unfreeze_predicate("all"))


def remat_step(build, x_of, labels, device, remat: bool) -> dict:
    """One train step of the model ``build()`` on the batch ``x_of()`` (drawn
    under ``counted``) with the generator seeded ``REMAT_SEED``: the loss,
    the gradients, the running statistics after it and the launches."""
    import torch

    from deepfakedetection_tpu_torch.train.steps import train_step

    model = build().to(device)
    opt = recording_optimizer(list(model.named_parameters()))
    mask = torch.ones(len(labels), dtype=torch.bool, device=device)

    def step():
        g = torch.Generator(device=device).manual_seed(REMAT_SEED)
        return train_step(model, opt, x_of(), labels, mask, g, remat=remat)

    out, launches = counted(step)
    names = [n for n, _ in model.named_parameters()]
    stats = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()
             if "running" in k or k.endswith("num_batches_tracked")}
    return {"loss": out["loss"].cpu(), "grads": dict(zip(names, opt.grads)), "stats": stats,
            "launches": launches, "model": model, "opt": opt}


def remat_against_plain(label: str, rows: dict) -> dict:
    """Each variant's loss, running statistics and gradients bit-identical to
    the plain step's."""
    import torch

    base = rows["plain"]
    out = {}
    for name, row in rows.items():
        if name == "plain":
            continue
        same = {"loss": bool(torch.equal(row["loss"], base["loss"])),
                "stats": all(torch.equal(row["stats"][k], v) for k, v in base["stats"].items()),
                "grads": all(torch.equal(row["grads"][k], v) for k, v in base["grads"].items())}
        out[name] = same
        log(f"  {label} {name}: loss {float(row['loss']):.6f}; bit-identical to the plain "
            f"step's: " + ", ".join(f"{k} {v}" for k, v in same.items()))
        if not all(same.values()):
            raise AssertionError(f"{label} {name} against the plain step: bit-identical {same}")
    return out


def phase15_steps(device, report) -> dict:
    """(c) One full-width fine-tune step at batch 128 from the same weights,
    batch and generator seed with and without remat: FasterViT-2 official
    from phase 5's ``.pth`` (``training.remat``, ``conv_remat`` "full" and
    "save-conv"; K5 26/13 launches under remat, 13/13 otherwise) and B3 with
    its recipe's augmentation (K4 once a step); (d) each FasterViT-2
    variant's step time (CUDA events) and peak memory."""
    import torch

    from deepfakedetection_tpu_torch.data.augment import augment_batch
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    state = torch.load(REPO / "build" / "chip_smoke" / "faster_vit_2_224_seeded.pth",
                       weights_only=True)
    g = torch.Generator().manual_seed(32)
    x = seeded_images(REMAT_BATCH, g).to(device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    labels = (torch.arange(REMAT_BATCH) % 2).to(device)
    rows, timings = {}, {}
    k = create_faster_vit("2", head_config="official").kernel_launches_per_forward()["k5"]
    for name in REMAT_VARIANTS:
        variant = REMAT_VARIANTS.get(name, {})

        def build(variant=variant):
            model = create_faster_vit("2", head_config="official",
                                      conv_remat=variant.get("conv_remat", False))
            model.load_state_dict(state)
            return model

        row = rows[name] = remat_step(build, lambda: x, labels, device,
                                      variant.get("remat", False))
        want = (2 * k if variant.get("remat") else k, k)
        if (row["launches"]["k5"], row["launches"]["k5_bwd"]) != want:
            raise AssertionError(f"FasterViT-2 {name} step: launches {row['launches']}, K5 {want}")
        model = row.pop("model")
        row.pop("opt")
        opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                             trainable=unfreeze_predicate("all"))
        mask = torch.ones(REMAT_BATCH, dtype=torch.bool, device=device)
        gen = torch.Generator(device=device).manual_seed(REMAT_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t = spread(cuda_times(lambda: train_step(
            model, opt, x, labels, mask, gen, remat=variant.get("remat", False)),
            runs=6, warmup=2))
        timings[name] = {"step_ms": t,
                         "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        del model
        torch.cuda.empty_cache()
    fv = remat_against_plain(f"FasterViT-2 official step, batch {REMAT_BATCH},", rows)
    card = report["card"]
    for name, t in timings.items():
        log(f"  FasterViT-2 official fine-tune step, batch {REMAT_BATCH}, {name}: "
            f"{t['step_ms']['median']:.3f} ms (q1 {t['step_ms']['q1']:.3f}, q3 "
            f"{t['step_ms']['q3']:.3f}), peak {t['peak_gib']:.2f} GiB ({card})")

    b3_state, canvases, _, plan = seeded_train_inputs(REMAT_BATCH)
    canvases = canvases.to(device)

    def b3_x():
        return augment_batch(canvases, torch.Generator(device=device).manual_seed(33), plan,
                             out_dtype=torch.bfloat16)

    b3 = {}
    for name, remat in (("plain", False), ("remat", True)):
        def build():
            model = create_efficientnet("b3", num_classes=2)
            model.load_state_dict(b3_state)
            return model

        row = b3[name] = remat_step(build, b3_x, labels, device, remat)
        del row["model"], row["opt"]
        if row["launches"]["k4"] != 1:
            raise AssertionError(f"B3 {name} step: launches {row['launches']}, K4 once")
    b3_rows = remat_against_plain(f"B3 recipe step, batch {REMAT_BATCH},", b3)
    return {"fastervit": fv, "timings": timings, "b3": b3_rows,
            "launches": {k: v["launches"] for k, v in rows.items()}}


def phase15(device, report) -> dict:
    """Tar shards, the remat training path and the remat steps."""
    out = {"eval": phase15_eval(device, report), "train": phase15_train(device, report),
           "steps": phase15_steps(device, report)}
    report["phase15"] = out
    return out


DP_SPLITS = {"train": 128, "val": 64, "test": 64}  # phase 16's training tree
DP_STEP_BATCH = 16  # images of the ranked step against the plain one (full width, 224 px)
DP_MIX = (False, 0.7)  # its mixup draw (mixup, lambda)
DP_CLASS_WEIGHTS = (0.8, 1.3)
DP_TIMED_BATCH = 128  # the ranked and plain steps' timing
DP_WIDE = 8  # the mask draw of a rank of an 8-card run, against one card's


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def collectives_counted(fn):
    """(fn's result, the torch.distributed all_reduce and all_gather calls
    it made): a world of one must run the collectives, not skip them."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_gather": 0}
    real = {name: getattr(dist, name) for name in counts}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return real[name](*args, **kwargs)

        return call

    try:
        for name in counts:
            setattr(dist, name, counting(name))
        out = fn()
    finally:
        for name, f in real.items():
            setattr(dist, name, f)
    return out, counts


def dp_steps(device, inputs) -> dict:
    """One full-width B3 step from ``inputs`` (``seeded_train_inputs``) with
    mixup and class weights, in f32 with TF32 off and in bf16."""
    import torch

    from deepfakedetection_tpu_torch.train.mixup import MixDraw

    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out[name] = one_step(*inputs, device, dtype, mix=MixDraw(*DP_MIX),
                                 class_weights=DP_CLASS_WEIGHTS)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def dp_readings(ranked, plain, state) -> dict:
    """The ranked step against the plain one: the loss, the updated weights
    in units of lr, the batch statistics (``batch_stats``), and whether every
    tensor came out bit-identical."""
    import torch

    (_, loss_r, sd_r), (_, loss_p, sd_p) = ranked, plain
    units = torch.cat([((sd_r[k] - sd_p[k]).abs() / 1e-4).flatten()
                       for k in sd_p if "running" not in k and "num_batches" not in k])
    dmean, dvar = stats_gaps(batch_stats(sd_r, state), batch_stats(sd_p, state))
    return {"loss_ranked": loss_r, "loss_plain": loss_p,
            "loss_rel": abs(loss_r - loss_p) / abs(loss_p),
            "max_dw_over_lr": float(units.max()),
            "share_dw_over_0.1lr": float((units > 0.1).float().mean()),
            "share_dw_over_0.5lr": float((units > 0.5).float().mean()),
            "batch_mean_gap": dmean, "batch_var_gap": dvar,
            "bit_identical": loss_r == loss_p and all(torch.equal(sd_r[k], sd_p[k])
                                                      for k in sd_p)}


def dp_step_ms(device) -> dict:
    """The bf16 B3 train step with mixup at ``DP_TIMED_BATCH``: CUDA events,
    median and quartiles of 10 after 3 warm-up steps."""
    import torch

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
    from deepfakedetection_tpu_torch.train.mixup import MixDraw
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    g = torch.Generator().manual_seed(4)
    model = create_efficientnet("b3", num_classes=2, generator=g).to(device)
    opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    root = root_generator(4)
    x = torch.randn(DP_TIMED_BATCH, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    labels = (torch.arange(DP_TIMED_BATCH) % 2).to(device)
    mask = torch.ones(DP_TIMED_BATCH, dtype=torch.bool, device=device)
    return spread(cuda_times(lambda: train_step(
        model, opt, x, labels, mask, fold_in(root, opt.count, device=device),
        mix=MixDraw(*DP_MIX)), runs=10))


def mask_draws_ms(device, plan) -> dict:
    """The random draws of one B3 train step at ``DP_TIMED_BATCH`` (the
    augmentation's parameters and every dropout and drop-path mask), drawn
    for one card's rows and for the ``DP_WIDE`` times wider draw of a rank of
    an 8-card run: CUDA events, median of 25."""
    import torch

    from deepfakedetection_tpu_torch.data.augment import sample_params
    from deepfakedetection_tpu_torch.models import common
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet

    shapes = []
    real = common.keep_mask

    def noting(x, keep, shape, generator):
        shapes.append(tuple(shape))
        return real(x, keep, shape, generator)

    model = create_efficientnet("b3", num_classes=2).to(device).train()
    common.keep_mask = noting
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, 224, 224, dtype=torch.bfloat16, device=device),
                  torch.Generator(device=device).manual_seed(0))
    finally:
        common.keep_mask = real
    S = plan.host_canvas_size

    def draws(wide: int) -> None:
        g = torch.Generator(device=device).manual_seed(1)
        rows = DP_TIMED_BATCH * wide
        sample_params(g, plan, rows, S, S)
        for shape in shapes:
            torch.rand((rows,) + shape[1:], generator=g, device=device)

    return {"masks": len(shapes), "one_card": spread(cuda_times(lambda: draws(1), runs=25)),
            f"wide_{DP_WIDE}": spread(cuda_times(lambda: draws(DP_WIDE), runs=25))}


def phase16(device, report) -> dict:
    """Data parallel on a world of one over NCCL: the ranked step against
    the plain one, then training, a resume and inference through the ranked
    path; the step times, the gradient all-reduce and the mask draws."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.orchestrator import orchestrate
    from deepfakedetection_tpu_torch.parallel.multihost import allgather_examples
    from deepfakedetection_tpu_torch.runtime import checkpoint as ckpt

    t0 = time.perf_counter()
    seconds = {}

    def lap(name: str) -> None:
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    inputs = seeded_train_inputs(DP_STEP_BATCH)
    plain = dp_steps(device, inputs)
    plain_ms = [dp_step_ms(device)]
    masks = mask_draws_ms(device, inputs[3])
    lap("plain steps, timing, draws")
    work = REPO / "build" / "chip_smoke_dp"
    shutil.rmtree(work, ignore_errors=True)
    data = work / "data"
    write_jpeg_tree(data, DP_SPLITS, seed=16)
    per_forward = create_efficientnet("b3").eval().kernel_launches_per_forward()
    warmup_steps, ft_steps = DP_SPLITS["train"] // 64, DP_SPLITS["train"] // 128
    val_batches, test_batches = -(-DP_SPLITS["val"] // 64), -(-DP_SPLITS["test"] // 64)
    extra = {"async_checkpoint": True, "mixup_alpha": 0.2}
    out: dict = {"card": smi()}

    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        ranked, calls = collectives_counted(lambda: dp_steps(device, inputs))
        if calls["all_reduce"] < 100 or calls["all_gather"] < 2:
            raise AssertionError(f"the ranked steps made too few collectives: {calls}")
        out["collectives_in_two_steps"] = calls
        for name in ("f32", "bf16"):
            row = out[f"step_{name}"] = dp_readings(ranked[name], plain[name], inputs[0])
            log(f"  ranked step against the plain one ({name}, batch {DP_STEP_BATCH}, mixup, "
                f"class weights): loss {row['loss_ranked']:.6f} / {row['loss_plain']:.6f}; "
                f"weights max|d|/lr {row['max_dw_over_lr']:.3f}; batch means "
                f"{row['batch_mean_gap']:.2e}, variances {row['batch_var_gap']:.2e}; "
                f"bit-identical {row['bit_identical']}")
            bad = {k: (row[k], b) for k, b in STEP_BOUNDS[name].items() if not row[k] <= b}
            if bad or not math.isfinite(row["loss_ranked"]):
                raise AssertionError(f"the ranked {name} step disagrees with the plain one: "
                                     f"{bad} (reading, bound); {row}")
        ranked_ms = dp_step_ms(device)
        n_params = sum(p.numel() for p in create_efficientnet("b3").parameters())
        flat = torch.zeros(n_params, device=device)
        allreduce = spread(cuda_times(lambda: dist.all_reduce(flat), runs=25))
        lap("ranked steps, timing, all-reduce")

        res, launches = counted(lambda: orchestrate(
            train_config(work, data, device, 1, **extra), mode="training")["efficientnet_b3"])
        want = {"k1": per_forward["k1"] * 2 * val_batches,
                "k2": per_forward["k2"] * 2 * val_batches,
                "k3": 0, "k4": warmup_steps + ft_steps, "k5": 0, "k5_bwd": 0, "k6": 0,
                "k6_bwd": 0, "k7": 0}
        if launches != want or res.interrupted or not math.isfinite(res.final_train_loss):
            raise AssertionError(f"ranked training: launches {launches} (expected {want}), {res}")
        res2, launches2 = counted(lambda: orchestrate(
            train_config(work, data, device, 2, **extra), mode="training")["efficientnet_b3"])
        if (res2.epochs_run != 1 or launches2["k4"] != ft_steps
                or launches2["k2"] != per_forward["k2"] * val_batches):
            raise AssertionError(f"ranked resume: {res2}, launches {launches2}")
        (run,) = sorted((work / "runs").iterdir())
        state = ckpt.load(run / "checkpoints" / "latest.ckpt")
        names = sorted(q.name for q in (run / "checkpoints").iterdir())
        if state["counters"]["epoch"] != 1 or any(".tmp" in n for n in names):
            raise AssertionError(f"ranked checkpoints: counters {state['counters']}, {names}")
        ires, ilaunch = counted(lambda: orchestrate(
            train_config(work, data, device, 2), mode="inference")["efficientnet_b3"])
        if (ires.probs.shape != (DP_SPLITS["test"], 2) or not np.isfinite(ires.probs).all()
                or ilaunch["k2"] != per_forward["k2"] * (test_batches + val_batches)):
            raise AssertionError(f"ranked inference: {ires.probs.shape} {ilaunch}")
        gathered = allgather_examples(ires.probs)
        if not np.array_equal(gathered, ires.probs):
            raise AssertionError("allgather_examples changed a world of one's rows")
        lap("tree, training, resume, inference")
    finally:
        dist.destroy_process_group()
    plain_ms.append(dp_step_ms(device))
    pres = orchestrate(train_config(work, data, device, 2), mode="inference")["efficientnet_b3"]
    lap("plain timing, inference")
    if not (np.array_equal(pres.probs, ires.probs) and np.array_equal(pres.targets, ires.targets)):
        raise AssertionError("the gathered eval rows differ from the ungathered ones: max|d| "
                             f"{np.abs(pres.probs - ires.probs).max()}")
    out.update({
        "launches": launches, "resume_launches": launches2, "inference_launches": ilaunch,
        "checkpoints": names, "losses": [res.final_train_loss, res2.final_train_loss],
        "step_ms": {"plain": plain_ms[0], "ranked": ranked_ms, "plain_again": plain_ms[1]},
        "allreduce_ms": allreduce, "allreduce_mib": n_params * 4 / 2**20, "mask_draws": masks,
        "seconds": seconds})
    log(f"  ranked training: K4 {launches['k4']}, K1 {launches['k1']}, K2 {launches['k2']}; "
        f"resume K4 {launches2['k4']}; checkpoints {names}; inference K2 {ilaunch['k2']}, its "
        f"gathered rows equal to a run without a group")
    log(f"  bf16 B3 step at batch {DP_TIMED_BATCH} with mixup (CUDA events, median [q1, q3] ms): "
        f"plain {plain_ms[0]['median']:.3f} [{plain_ms[0]['q1']:.3f}, {plain_ms[0]['q3']:.3f}], "
        f"ranked {ranked_ms['median']:.3f} [{ranked_ms['q1']:.3f}, {ranked_ms['q3']:.3f}], "
        f"plain again {plain_ms[1]['median']:.3f}; NCCL all-reduce of the gradient buffer "
        f"({n_params} f32, {n_params * 4 / 2**20:.1f} MiB) {allreduce['median']:.3f} ms; "
        f"the step's {masks['masks']} masks and the augmentation's draws "
        f"{masks['one_card']['median']:.3f} ms for one card's rows, "
        f"{masks[f'wide_{DP_WIDE}']['median']:.3f} ms for a rank of {DP_WIDE} cards; "
        f"{out['card']}; seconds {({k: round(v, 1) for k, v in seconds.items()})}")
    report["phase16"] = out
    return out


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Drives the PyTorch port on one CUDA card.")
    parser.add_argument("--parent", help="another checkout (say the parent commit, unpacked with "
                        "git archive) whose K1, K4, K5 forward and backward, K7 and K3 phase 1 "
                        "times against this one's, and whose eager eval steps phase 14 holds "
                        "bit-identical to this one's")
    args = parser.parse_args()
    if not (REPO / "deepfakedetection_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    device = torch.device("cuda", 0)
    card = smi()
    report: dict = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                    "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}

    from deepfakedetection_tpu_torch.ops import build

    log(f"phase 0: card {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"cuDNN TF32 {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    build.library()
    report["build_s"] = time.perf_counter() - t0
    log(f"  kernels built by nvcc in {report['build_s']:.1f} s -> {build.library_path().name}")

    log("phase 1: kernels against their plain versions (bf16)")
    kernels = phase1(device, report, args.parent)
    state = seeded_b3_state()
    log("phase 2: full-width B3 forward")
    phase2(device, report, state)
    log("phase 3: main path, orchestrate(mode='inference')")
    launches = phase3(device, report, state)
    log("phase 4: training path, orchestrate(mode='training')")
    launches["k4"] = phase4(device, report)["k4"]
    log("phase 5: FasterViT-2 eval path, orchestrate(mode='inference')")
    launches["k5"] = phase5(device, report)["k5"]
    log("phase 6: FasterViT-2 training path, orchestrate(mode='training')")
    launches["k5_bwd"] = phase6(device, report)["k5_bwd"]
    log("phase 7: EfficientFormerV2-S1 eval path, orchestrate(mode='inference')")
    launches["k7"] = phase7(device, report)["k7"]
    log("phase 8: FasterViT-2 with DFD_FUSED_ATTN (K6), orchestrate(mode='inference') and "
        "orchestrate(mode='training')")
    fused_eval, fused_train = phase8(device, report)
    launches["k6"], launches["k6_bwd"] = fused_eval["k6"], fused_train["k6_bwd"]
    log("phase 9: B3 with DFD_FUSED_MBCONV (K3), orchestrate(mode='inference')")
    launches["k3"] = phase9(device, report, state)["k3"]
    log("phase 10: EfficientFormerV2-S1 training path, orchestrate(mode='training')")
    phase10(device, report)
    log("phase 11: predict --json and --cam for config/inference.yaml's selection")
    phase11(device, report)
    log("phase 12: serve config/inference.yaml's selection over HTTP, with an ensemble")
    phase12(device, report)
    log("phase 13: int8 eval: the int8 depthwise kernel, orchestrate(mode='inference') with "
        "precision int8, S1 and FasterViT-2 int8 forwards, the bench (B3 eval and int8, "
        "FasterViT-2 train)")
    kernels["int8_depthwise"], launches["int8_dw"] = phase13(device, report)
    log("phase 14: export config/inference.yaml's selection (torch.export), each program "
        "loaded in a fresh process")
    phase14(device, report, args.parent)
    log("phase 15: tar shards (python -m deepfakedetection_tpu_torch.data.shards), B3's eval "
        "job over them, FasterViT-2 training over them with remat, async checkpoints and "
        "profile_dir, and remat steps against plain ones")
    phase15(device, report)
    log("phase 16: data parallel on a world of one over NCCL: the ranked step against the "
        "plain one, orchestrate(mode='training') with async checkpoints and mixup, a resume "
        "and orchestrate(mode='inference') through the ranked path")
    phase16(device, report)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)
    own = reference_imports(Path(__file__).read_text())
    if leaked or own:
        raise AssertionError(f"JAX was imported: {leaked[:5]}; this script imports {own}")
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    sources = {"depthwise_silu_pool": ("k1", "depthwise_se.cu",
                                       "deepfakedetection_tpu/ops/pallas/depthwise_se.py:73"),
               "expand_dw_silu_pool": ("k2", "expand_dw.cu",
                                       "deepfakedetection_tpu/ops/pallas/expand_dw.py:88"),
               "fused_mbconv_se": ("k3", "fused_mbconv.cu",
                                   "deepfakedetection_tpu/ops/pallas/fused_mbconv.py:109"),
               "rotate_batch": ("k4", "shear_rotate.cu",
                                "deepfakedetection_tpu/ops/pallas/shear_rotate.py:92"),
               "window_attention": ("k5", "window_attn.cu",
                                    "deepfakedetection_tpu/ops/pallas/window_attn.py:799"),
               "window_attention_bwd": ("k5_bwd", "window_attn_bwd.cu",
                                        "deepfakedetection_tpu/ops/pallas/window_attn.py:587"),
               "attn4d": ("k7", "attn4d.cu", "deepfakedetection_tpu/ops/pallas/attn4d.py:92"),
               "attn_subblock": ("k6", "attn_block.cu",
                                 "deepfakedetection_tpu/ops/pallas/attn_block.py:167"),
               "attn_subblock_bwd": ("k6_bwd", "attn_block_bwd.cu",
                                     "deepfakedetection_tpu/ops/pallas/attn_block.py:202"),
               "int8_depthwise": ("int8_dw", "int8_dw.cu", "deepfakedetection_tpu/ops/quant.py:110")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"deepfakedetection_tpu_torch/ops/csrc/{src}", "replaces": where,
         "launches": launches[key],
         **{k: kernels[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")}}
        for name, (key, src, where) in sources.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
