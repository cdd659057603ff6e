#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (cartseg_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card's name and power limit (nvidia-smi); require_cuda();
  2. build the CUDA kernels from ops/cuda/csrc (nvcc), print the time
     and each kernel's registers and spills (-Xptxas -v), and for the
     fp32 backward kernels and cc_tiles their dynamic shared memory and
     blocks an SM;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs: CC at 8- and 4-connectivity on [64,512,512] masks
     (blobs, uniform noise p=0.45, all-background, all-foreground, a
     one-arm 512^2 spiral, cut rings); CC at both and reach (1 % seeds)
     on cart-like blob masks [64,512,512], blobs and noise at CC_SHAPES
     (strip-ragged H, W of 77, 513 and 3000, one column) and a one-arm
     [1,2048,2048] spiral; reach on the weak/strong maps of
     Canny runs on the synthetic frames; the median on |p-0.5|*2 rows of
     [64,262144], rows with many duplicates and all-zero rows (the
     cluster route, 8 CTAs of 32768) and on [4,327681] rows (past what a
     cluster holds: the stream route); CC, reach and the median each
     twice; the EDT
     on [6,512,512] GT boundaries of blob masks plus a no-seed, a
     single-seed and an all-seed sample, and at EDT_SHAPES ([2,400,512],
     [3,37,53], [2,1,77], [1,1,1], [1,2048,2048]), each twice - all bit
     for bit (torch.equal after synchronize); the LSR CE forward and
     backward on
     [6,512,512,8] logits with labels 0..7 and every 7th row ignored,
     loss atol 1e-5 and gradient atol 2e-6 at unit g, and the forward
     and backward on both their routes (float4 rows; the logits 4 bytes
     past a 16-byte boundary, one thread a row) with int64 and int32
     labels, loss atol 1e-5, gradient atol 2e-6 at unit g and 1e-5 at a
     random g; the decomposed
     rel-pos flash attention at the ViT-B global block [12,4096,64]
     (max abs err within 1e-5 of max |plain| in fp32, as split-TF32
     products on the tensor cores, 1e-2 in bf16 on the tensor cores, the
     same bits twice), at the tests' [2,256,32] fp32 and at a ragged
     [1,529,32] in bf16 and in fp32; its training
     forward's lse (fp32 1e-5 of max |plain|, bf16 1e-5 absolute; out
     bit-equal to the inference call's) and the two backward kernels'
     five gradients at
     the same shapes (1e-5 of max |plain| in fp32, as split-TF32 products
     on the tensor cores, 1e-2 in bf16 on the tensor cores; the same bits
     twice); channel_sums at resnet34-UNet's BN
     inputs at 512^2 bs6 (the stem [6,64,256,256], a layer3 BN
     [6,256,32,32], the decoder's 16-channel top [6,16,512,512]),
     channels_last and contiguous, fp32 and bf16, (x, x) and (dy, x),
     within 1e-5 of the per-channel sum of |.| and the same bits on a
     second call; the loss zoo's kernels at the path shapes: focal (loss
     and gradient) at [6,512,512,1] and [20,224,224,1] with gamma 2 and,
     at the first, gamma 1 and 1.5 (the other exponent routes) and the
     scalar route (4 bytes past a 16-byte boundary), mish / swish
     forward and g * f' backward at [6,512,512,16] and [12288,2048]
     within 2e-6 of max |plain|, hswish there bit for bit, soft-Dice's
     sums at [6,512,512,1] for p = 1, 2 and 1.5 and, at p = 2, on the
     scalar route ([6,262143] 4 bytes past a boundary) within 1e-6
     relative and the same bits twice, the smoothed one-hot at
     [6,262144] C = 8 (ignore 255, int64 and int32 labels) bit for bit;
  4. the workloads through their CLI entry points, each with the launch
     counts set to 0 just before it and read just after:
     a. pseudo-labels (workloads/create_pseudo_labels.main) on a
        synthetic PNG tree of 2 sessions x 64 frames of 400x512
        (letterboxed to exactly 512^2, so no resize and no OpenCV),
        three efficientnet-b0 members from seeded random init saved as
        .pth with a threshold sidecar, at --batch_size 64 --img_size 512
        --device cuda; every frame's mask, prob file and CSV row must
        exist, and cc, reach and median must have been launched; then
        the card's program in fp32 against the CPU's on a small input;
     b. training (workloads/train_bce_dice_abl.main) on a synthetic PNG
        image+mask tree of 5 sessions x 12 frames of 400x512, at the
        workload's CONFIG (efficientnet-b0 UNet, bs6, 512^2, bf16
        autocast, train_512) for --epochs 2 --device cuda; the CSV,
        history, .pth, sidecar and .last.pth must exist with finite
        losses, edt, lsr_fwd and lsr_bwd must have been launched, and
        the .pth must load into the pseudo-labeller; then one fp32
        train step on the card against the CPU's on a small input;
     c. the SAM ViT-B predictor (tools/annotate.load_sam, fp32, TF32
        off) from a seeded random init saved as an official-named .pth:
        set_image on three 1024^2 frames and one 512^2 frame (resized),
        7 predict requests each (points, a negative click, box, box +
        point, multimask on and off, logits); masks at frame size,
        flash_fwd launched 4 times per set_image, `.features` injection;
        then the ViT-B embedding with the flash lane against the plain
        lane on the card (rel max err <= 1e-4), and a small SAM on the
        card against the CPU;
     d. the SAM ViT-B encoder fine-tune step (benchmarks/
        sam_train_bench.py's step): `Sam(SamConfig(global_attn_flash=
        True), dtype=torch.bfloat16)` loaded by name from a seeded
        official-named .pth, preprocess + encode_image on one 1024^2
        uint8 frame, loss mean(feats^2), loss.backward(), 3 steps;
        flash_fwd_tc, flash_bwd_dq and flash_bwd_dkv launched 4 times each
        per step, finite loss, a finite non-zero gradient on every encoder
        parameter and none on the prompt encoder or decoder; then the
        flash lane against the plain lane (global_attn_flash=False) on the
        same weights: fp32 with TF32 off, per-parameter gradient relative
        L2 <= 1e-4 and loss <= 1e-5 relative, the fp32 flash lane's step
        launching flash_fwd, flash_bwd_dq and flash_bwd_dkv 4 times each;
        bf16, loss <= 1e-3 relative and sum |grad| within 5 %;
     e. BCE+Dice training (workloads/train_bce_dice.main) on 4b's tree at
        the workload's CONFIG (resnet34-UNet, bs6, 512^2, bf16 autocast,
        train_512, BCE+Dice w 0.5, session_sorted, basic CSV) for
        --epochs 2 --device cuda, once per BN lane: the kernel lane by
        CARTSEG_PALLAS_BN=force, read by the entry point, with 46
        ChannelSumsBatchNorm2d and channel_sums launched 92 times a step
        (46 forward, 46 backward), and the torch lane with 46 BatchNorm2d
        and no launch; no other kernel in either; the CSV, .pth, sidecar
        and .last.pth, the .pth loading into the pseudo-labeller; then one
        fp32 step (TF32 off) of the same config in both lanes from the
        same weights and batch: loss 1e-5 relative, running stats 1e-5,
        and the kernel lane's gradient no farther from the torch lane's
        float64 gradient, or from the torch lane's fp32 one, than twice
        the torch lane's own fp32 distance from float64 (relative L2);
     f. the loss zoo through cartseg_tpu_torch.losses: every name it
        gained (focal_loss_kernel, soft_dice_loss, smooth_one_hot, mish,
        swish, hswish, lsr_cross_entropy_fused, the Taylor, OHEM,
        Lovasz, large-margin, LayerNorm and SDF boundary losses) at the
        path shapes, with a backward where it has a gradient; all nine
        zoo counters, edt, lsr_fwd and lsr_bwd > 0; then the same calls
        on the card against the CPU at [2,32,32] (rtol 1e-4, atol 1e-5;
        integer outputs equal);
     g. SDF boundary-loss training (workloads/train_with_boundary_loss.
        main) on 4b's tree at the workload's CONFIG (effnet-b0 UNet, bs6,
        512^2, bf16, ImageNet norm, train_512, BCE+Dice + 0.3 boundary,
        encoder frozen, prf1 CSV) for --epochs 2 --device cuda: the CSV,
        history, .pth, sidecar and .last.pth, the .pth loading into the
        pseudo-labeller; edt launched at least 4 times a step, no other
        kernel;
     h. camera JPEGs with cv2 and PIL made unimportable for the phase's
        length (`refuse_modules`): nvJPEG's decode (utils/jpeg.py) of
        every fixture of cartseg_tpu_torch/tools/jpeg_fixtures/ (1280x720
        4:2:0 at quality 90, 4:4:4, progressive, EXIF Orientation 6,
        grayscale; the luma of one) against cv2's stored decode, max and
        mean |d| printed, the shapes equal (the rotated one 720 wide),
        failing above a mean of 1.0 LSB; then on a 5 x 12 JPEG tree cycled
        from the fixtures, with their letterboxed masks,
        workloads/train_with_pretrained at its CONFIG (efficientnet-b0,
        512^2, bs6, bf16, train_512, session_sorted, prf1, encoder frozen
        8 epochs) for --epochs 2 from a seeded timm-named encoder .pth
        that carries the classifier keys: the artifacts, and every
        encoder parameter in model.pth equal to the file's bit for bit;
        train_with_focal_dice, train_with_focal_dice_unfrozen (lr_encoder
        and lr_head 0.1x and 3x lr_decoder), train_pseudo (two image
        roots) and train_bce_dice_abl_unlettered (unlettered masks; edt,
        lsr_fwd and lsr_bwd launched) at their CONFIG for --epochs 1,
        each CSV in its schema; create_pseudo_labels on 64 1280x720
        JPEGs at --batch_size 64 --img_size 512 with that model.pth as
        the three members: every mask, prob file and CSV row, cc, reach
        and median launched;
     i. mixed-source fine-tuning with cv2 and PIL refused: three mirrored
        sources (hard, clean, pseudo) of 2 x 12 JPEGs cycled from the
        fixtures; finetune_for_224 at its CONFIG (effnet-b0, 224^2, bs20,
        curriculum, encoder frozen 2 epochs) for 3 epochs of its 20
        (--stop_after_epoch 3; each epoch's pseudo sample weight 0.45 /
        0.50 / 0.55 and the frozen encoder read from the entry point's
        own steps), then --resume --epochs 3 for its 19-point sweep;
        finetune_pseudo for 1 epoch with --trace_dir (the Chrome trace
        parses, its CUDA kernel events printed); finetune_pseudo_hard_
        clean for 1 epoch from that run's model.pth (the state before
        the first step equals the file's; hard's share of the sampler
        2/3 and of the epoch orders printed); finetune_bce_dice_abl for
        1 epoch (edt, lsr_fwd, lsr_bwd launched); each run's CSV,
        history, .pth, sidecar and .last.pth; train_bce_dice --decoder
        unetpp_ds on 4b's tree for 1 epoch in each BN lane (58 BNs,
        channel_sums 116 launches a step in the kernel lane, 0 in the
        torch lane, no other kernel), then its fp32 step in both lanes
        as 4e; the remat check: 4e's fp32 resnet34-UNet step with
        remat in each lane against the plain step at 4e's tolerances
        (138 channel_sums launches: the forward, its recompute, the
        backward), the step's ms and peak memory with and without remat
        in fp32 and bf16, the peak predicted at bs128 and, where it fits,
        the bs128 step run; the classic UNet at [1,3,512,512] fp32, card
        against CPU (atol 1e-5);
     j. the cleaning, mining, ranking and evaluation toolchain with cv2,
        PIL and pandas refused, on 4h's trees and model: clean_masks
        --mode complete on the JPEG tree's 1536^2 letterboxed masks with
        --images_root (zero outside each frame's content box),
        holes_largest and largest_only on 4h's pseudo-label masks, every
        output equal to the same cleaner on the CPU bit for bit (once per
        distinct input) and cc launched at connectivity 4 and 8;
        remove_padding_from_masks --overlays on every pseudo-label mask
        (each at its frame's size, 720 wide for EXIF orientations 5-8);
        get_images copy-images and copy-masks (copies equal to their
        sources); get_best_pseudo_masks (ranking.csv equal to a numpy
        ranking computed here); mine_hard_cases at its defaults (512^2,
        bs16, model.pth as 3 members) on the 64 JPEGs (the CSV's columns
        and order, cc at 4 and 8 on [16,512,512]), then the metric body
        on the card against the CPU on the same probs (components equal,
        the rest within 1e-6); evaluate --sweep on the JPEG tree; the
        pseudo-label program with edge_method='sobel' on 4a's frames
        (cc and median launched, reach not); the phase's wall;
     k. serving with cv2 and PIL refused: 4e's resnet34-UNet model.pth
        and its sidecar exported by serve/export.py at the JAX defaults
        (512^2, batch 16, bf16; torch.export), loaded on the card, its
        probabilities on a device batch against the eager forward (bit
        for bit, or within SERVE_EXPORT_TOL, and which); ms a device batch
        and img/s; 64 POST /segment requests of the 1280x720 JPEG
        fixtures from 8 client threads to serve/server.py's HTTP server
        on 127.0.0.1 at a free port (nvJPEG decodes, the port's PNG
        encoder answers), each mask equal to ServedSegmenter.segment on
        the same frame; request latency p50 / p99 at max_latency_ms 20
        and requests a device call;
     l. data parallelism: (a) two ranks on the one card over gloo, under
        torchrun (this file as the rank, --ddp-worker), through
        train_bce_dice's entry point at its CONFIG (global bs6, 3 a rank)
        on 4b's tree for one epoch in each BN lane: the ranks' parameters
        and BN buffers equal bit for bit, channel_sums launched 2 x 46
        times a step in each rank of the kernel lane and never in the
        torch lane's, and the first fp32 step (TF32 off, 4e's weights and
        batch) equal across the ranks and within 4e's limit of the
        one-process step; (b) one rank with NCCL through the same entry
        point; (c) the pseudo-label program through
        shard_inference_program over [cuda:0, cuda:0] on 4a's bs64 batch:
        each 32-row shard equal bit for bit to the unsharded program on
        its rows, the whole batch within SHARD_TOL of the unsharded one,
        cc, reach and the median launched;
     m. SAM-assisted annotation with cv2 and PIL refused: a Proposer
        (4a's first member, effnet-b0 bf16, at create_testset's 512^2)
        and the SAM ViT-B predictor from 4c's checkpoint, through
        tools/annotate.py; a PrefetchWorker at create_testset's 1024^2
        display over four 1280x720 JPEG fixtures (nvJPEG, the native
        letterbox, the proposal, SamPredictor.embed on its thread) and a
        scripted session on each item once two items wait in the queue
        (r, clicks, a negative click, a box, brush strokes with a hole,
        f, m, a click, a save at 720x1280 and at 512^2): every prompt's
        mask equal to set_image + predict on its image alone, the PNGs
        decoding to the session's mask, flash_fwd launched 4 times an
        item and cc once a hole fill (and the kernels in CUDA graphs of
        one call), fill_holes, smooth_mask and gaussian_blur_u8 on the
        card equal to their CPU lanes bit for bit at 1024^2, and the
        arrival-counter rows in use unchanged; each item's read,
        letterbox, proposer and embed times, the consumer's wait, a
        prompt's decode, postprocess and predict, smooth_mask and
        fill_holes at 1024^2; then augment_batch's pipeline with
        per_sample_warp at bs6 512^2 on the card against the CPU on the
        same draws (99.9 % of values within 1e-2/255, masks equal on
        99.9 %), the rows' angles distinct;
  5. timing with CUDA events: the pseudo-label program per bs64 batch;
     CC on the path's masks, cart-like blobs and the mixed masks, and
     reach on the path's Canny maps, beside their bounds, with the CUDA
     kernels one call of each runs (1 to 3, and no memset; here and below
     read from a CUDA graph of the call, which holds every operation it
     enqueues, where the profiler can lose events) and the CC
     cleanup layer split into the labelling kernel, the bincount area
     count and the rest; the median at [64,262144] in device time
     (profiler, L2 flushed) beside its CUDA-events time, its plain
     version, torch.quantile(midpoint) and its bound, one CUDA kernel a
     call (median_cluster) and no memset, and against torch.quantile in
     ACT_PAIRS alternating cold-L2 pairs;
     the train step at bs6@512^2 (device-resident batch, loader
     excluded) and the ABL loss's share of it, SAM's set_image and
     predict and the global blocks' share of set_image, set_image's device
     time by kernel (which must name the split-TF32 forward
     flash_fwd_tf32x3; each such profile that loses a kernel's events in
     every window must find it in a CUDA graph of the call), the fp32 forward at set_image's inputs against its
     plain version, SDPA and its bound (split TF32 at the TF32 peak, the
     CUDA-core bound beside), the SAM fine-tune
     step for both lanes with the global blocks' share and the device's
     busy share, its device time by kernel (which must name the bf16
     tensor-core kernels flash_fwd_tc, flash_bwd_dq_tc and
     flash_bwd_dkv_tc), the same step in fp32 (TF32 off) for both lanes
     in alternating pairs with its busy share and device time by kernel
     (which must name the split-TF32 kernels flash_fwd_tf32x3,
     flash_bwd_dq_tf32x3 and flash_bwd_dkv_tf32x3) and, at the step's
     inputs, the bf16 training
     forward against its plain version and SDPA, the backward kernels in
     bf16 and fp32 against their plain versions, SDPA autograd and their
     bounds (fp32: split TF32 at the TF32 peak, the CUDA-core bound
     beside), and each backward gradient's distance to a float64
     reference for the kernels, the plain version and SDPA autograd, in
     bf16 and fp32; the EDT at the ABL step's GT
     boundaries and the boundary step's masks, with its bytes and
     operations bounds and the CUDA kernels one call runs (which must be
     at most 3); the BCE+Dice step
     in both BN lanes at 512^2 bs6 and at bench.py's train half (224^2
     bs128) with the BN layers' share and the busy share; the LSR
     forward and backward at [1572864,8] in device time (L2 flushed) with
     int64 and int32 labels, one CUDA kernel a call (lsr_fwd_vec,
     lsr_bwd_vec) and their bounds, beside their CUDA-events times and
     F.cross_entropy with the smoothed one-hot as probability targets,
     forward and autograd backward; and each
     kernel against its plain version and,
     where one PyTorch call computes the same function, that call, at
     the path's shapes, beside its bound (channel_sums: per launch at
     the stem, a layer3 BN and the decoder top with the L2 flushed and
     one CUDA kernel a call (sums_nhwc), and over one step's 92 calls
     back to back, 92 kernels and no memset in a CUDA graph of them,
     against torch.batch_norm_stats and
     torch.batch_norm_backward_reduce); the loss zoo's kernels at the
     path shapes in device time (profiler, the L2 flushed before each
     call) against their plain versions (focal and soft-Dice one CUDA
     kernel a call, focal_fwd_bwd and dice_sums, and no memset),
     F.mish / F.silu / F.hardswish and ATen's mish/silu/hardswish
     backward, and their bounds, then each activation forward and
     backward against its PyTorch call in ACT_PAIRS alternating cold-L2
     pairs (medians and spread; the mish forward's line names the form
     the kernel computes, MISH_FWD_FORM); the boundary workload's train step
     against the same step with BCE+Dice alone, its busy share and its
     4 edt launches; with cv2 and PIL refused, the nvJPEG decode rate of
     a 1280x720 frame on one thread and on the loader's 4, the training
     loader's wall for an epoch of train_with_pretrained's CONFIG on the
     JPEG tree against its train steps' time, one item's read,
     letterbox, mask read and mask resize on one thread, and the
     pseudo-label batch of 64 JPEGs against the read and letterbox of
     its frames; each phase-4i run's train step on a device-resident
     batch against its loader alone over an epoch (loader- or
     step-bound); with cv2, PIL and pandas refused, the mining program's
     ms a batch and img/s at bs16 and bs64 (CUDA events, a
     device-resident batch of 4h's JPEG frames), and post_clean on one
     1536^2 mask: its wall, and its device time split into the CC
     kernel, the component statistics and the morphology.
Near the end, one line each repeats 4k's, 4l's and 4m's numbers and one
gives every phase's wall. The line before the last holds the kernels' JSON
record, the one before it the card's name and power limit, and the last
line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B, S, SESSIONS = 64, 512, 2
FRAME_HW = (512, 400)            # (h, w): side pad 40 -> 480, square 512
TRAIN_SESSIONS, TRAIN_PER_SESSION, TRAIN_BS = 5, 12, 6
SEED = 0
KERNELS = {
    "cc": ("cartseg_tpu_torch/ops/cuda/csrc/cc.cu",
           "cartseg_tpu/ops/pallas/cc.py:170"),
    "reach": ("cartseg_tpu_torch/ops/cuda/csrc/cc.cu",
              "cartseg_tpu/ops/pallas/cc.py:181"),
    "median": ("cartseg_tpu_torch/ops/cuda/csrc/median.cu",
               "cartseg_tpu/ops/pallas/median.py:38"),
    "edt": ("cartseg_tpu_torch/ops/cuda/csrc/edt.cu",
            "cartseg_tpu/ops/pallas/edt.py:82"),
    "lsr_fwd": ("cartseg_tpu_torch/ops/cuda/csrc/lsr.cu",
                "cartseg_tpu/ops/pallas/lsr.py:38"),
    "lsr_bwd": ("cartseg_tpu_torch/ops/cuda/csrc/lsr.cu",
                "cartseg_tpu/ops/pallas/lsr.py:61"),
    "flash_fwd": ("cartseg_tpu_torch/ops/cuda/csrc/flash_relpos.cu",
                  "cartseg_tpu/ops/pallas/flash_attention.py:88"),
    "flash_fwd_tc": ("cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_fwd_tc.cu",
                     "cartseg_tpu/ops/pallas/flash_attention.py:88"),
    "flash_bwd_dq": ("cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd_tc.cu",
                     "cartseg_tpu/ops/pallas/flash_attention.py:179"),
    "flash_bwd_dkv": (
        "cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd_tc.cu",
        "cartseg_tpu/ops/pallas/flash_attention.py:232"),
    # the fp32 route of the same two launches: split-TF32 kernels
    "flash_bwd_dq_f32": ("cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd.cu",
                         "cartseg_tpu/ops/pallas/flash_attention.py:179"),
    "flash_bwd_dkv_f32": (
        "cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd.cu",
        "cartseg_tpu/ops/pallas/flash_attention.py:232"),
    "channel_sums": ("cartseg_tpu_torch/ops/cuda/csrc/channel_sums.cu",
                     "cartseg_tpu/ops/pallas/channel_sums.py:39"),
    "focal": ("cartseg_tpu_torch/ops/cuda/csrc/focal.cu",
              "cartseg_tpu/ops/pallas/focal.py:40"),
    "soft_dice": ("cartseg_tpu_torch/ops/cuda/csrc/soft_dice.cu",
                  "cartseg_tpu/ops/pallas/soft_dice.py:27"),
    "one_hot": ("cartseg_tpu_torch/ops/cuda/csrc/one_hot.cu",
                "cartseg_tpu/ops/pallas/one_hot.py:21"),
    **{f"{kind}_{d}": ("cartseg_tpu_torch/ops/cuda/csrc/activations.cu",
                       f"cartseg_tpu/ops/pallas/activations.py:{line}")
       for kind, lines in (("mish", (77, 82)), ("swish", (90, 95)),
                           ("hswish", (101, 106)))
       for d, line in zip(("fwd", "bwd"), lines)},
    # no TPU kernel: the JAX package's cv2.bilateralFilter on the host
    "bilateral": ("cartseg_tpu_torch/ops/cuda/csrc/bilateral.cu",
                  "cartseg_tpu/tools/annotate.py:49"),
}
PSEUDO_KERNELS = ("cc", "reach", "median")
TRAIN_KERNELS = ("edt", "lsr_fwd", "lsr_bwd")
SAM_KERNELS = ("flash_fwd",)
SAM_TRAIN_KERNELS = ("flash_fwd_tc", "flash_bwd_dq", "flash_bwd_dkv")
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
# the fp32 fine-tune step's kernels (phase 4d's fp32 flash lane)
F32_STEP_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the bf16 forward's and backward's tensor-core kernels, as the profiler
# names them
TC_SYMBOLS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
# the fp32 route's split-TF32 tensor-core kernels, as the profiler names
# them: the forward (csrc/flash_relpos.cu) and the backward
# (csrc/flash_relpos_bwd.cu)
F32_FWD_SYMBOL = "flash_fwd_tf32x3"
F32_SYMBOLS = (F32_FWD_SYMBOL, "flash_bwd_dq_tf32x3", "flash_bwd_dkv_tf32x3")
# TF32 products a fp32 product takes on the fp32 route: hi lo + lo hi +
# hi hi
TF32_TERMS = 3
SAM_TRAIN_STEPS = 3
# resnet34-UNet: 36 BatchNorms in the encoder, 10 in the decoder; the
# kernel lane calls channel_sums once forward and once backward in each
BCE_BN_LAYERS = 46
BN_LANES = ("torch", "channel_sums")
# BN inputs of resnet34-UNet at 512^2 bs6: the stem, a layer3 BN and the
# decoder's 16-channel top
SUMS_SHAPES = {"stem": (6, 64, 256, 256), "layer3": (6, 256, 32, 32),
               "decoder top": (6, 16, 512, 512)}
SUMS_TOL = 1e-5           # of sum |a| and of sum |a*b| per channel
BENCH_TRAIN = (224, 128)  # bench.py's train half: 224^2, bs128
LSR_TOL = {"lsr_fwd": 1e-5, "lsr_bwd": 2e-6}
# the LSR backward against its plain version at a random upstream g
LSR_BWD_TOL_G = 1e-5
# flash kernel vs plain: max abs error over the plain output's max |value|.
# fp32: both sides keep every value in fp32. bf16: the tensor-core kernel
# rounds P to bf16 once, as the A operand of P V (as FlashAttention-2/3
# and SDPA do), and the output once; the plain version rounds only the
# output. An emulation of these rounding points on the CPU (tests/
# test_torch_flash_fwd_rounding.py) lands within 7.7e-3 of max |plain| at
# [2,256,64], [1,529,32] and [2,4096,64]. The training forward's bf16 lse
# within FLASH_LSE_TOL absolute of the plain logsumexp (the backward
# recomputes P from it).
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLASH_LSE_TOL = 1e-5
# backward kernels vs plain, the same measure. In fp32 the kernels run
# each product as three TF32 products on the tensor cores (hi lo + lo hi +
# hi hi, hi + lo holding an operand to ~2^-22) and keep P, dS and every sum
# fp32; an emulation on the CPU (tests/test_torch_flash_bwd_tf32x3.py)
# lands within 1.9e-6 of max |plain| at [2,256,64], [1,529,32] and
# [2,4096,64], and the card, whose tensor cores truncate their fp32 sums,
# within 5.2e-6 at [12,4096,64]. In bf16 the tensor-core kernels round P
# and dS to bf16 once each, as the A operands of dS K, P^T dO and dS^T Q (as
# FlashAttention-2/3 and SDPA's bf16 backward do), and round each output
# once; the plain version rounds only the outputs. One bf16 rounding is up
# to 2^-9 of a value, and an emulation of these rounding points on the
# CPU (tests/test_torch_flash_bwd_rounding.py) lands within 6.2e-3 of max
# |plain| at [2,256,64], [1,529,32] and [2,4096,64]
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (bnh, g, head_dim, type) of the flash kernels' checks against their
# plain versions: the ViT-B global block in fp32 and bf16, the tests'
# size, and a ragged grid in both types (S = 529, not a multiple of the
# 64-row tiles; the keys past S masked, the staged drel sums)
FLASH_CASES = ((12, 64, 64, torch.float32), (12, 64, 64, torch.bfloat16),
               (2, 16, 32, torch.float32), (1, 23, 32, torch.bfloat16),
               (1, 23, 32, torch.float32))
# EDT shapes beside the path's [6,512,512]: frames before the letterbox,
# classes that are ragged mod the split, one-block images, the largest side
EDT_SHAPES = ((2, 400, 512), (3, 37, 53), (2, 1, 77), (1, 1, 1),
              (1, 2048, 2048))
# operations of one candidate of one pixel that 1+JFA needs, for the
# operations bound: the candidate's offset to its seed (the neighbour's
# offset plus (dy, dx), one paired add), its d^2 (a multiply and an FMA),
# the compare and the select. csrc/edt.cu spends EDT_KERNEL_OPS beside its
# shared load and store: on the int32 pipe the neighbour's row (1), its
# bounds with the column's (2), the address (1) and the offset's select
# (1); on the FP pipes the half2 add (1), the two conversions to fp32 (2),
# the multiply and the FMA of d^2 (2), the compare (1) and d^2's select
# (1); that mix is printed beside the bound, not used as one. The rate: an
# SM issues 4 warp instructions a clock, 128 lanes
EDT_OPS = 5
EDT_KERNEL_OPS = 12
OPS_PER_SM_CLOCK = 128
# CUDA kernels one call of the EDT, CC or reach may run
MAX_KERNELS_A_CALL = 3
# CC and reach beside the path's [64,512,512]: H not a multiple of the
# 32-row strip, W of 77 and 513 (no 16-byte loads), tiles side by side
# (W above 1024), a one-column image; blobs, and noise at p = 0.45
CC_SHAPES = ((4, 500, 512), (2, 300, 77), (2, 300, 513), (1, 40, 3000),
             (2, 2000, 1))
# cc_tiles: threads a block, and the threads an SM holds
CC_THREADS, SM_THREADS = 512, 2048
# alternating cold-L2 pairs of each activation forward against its
# PyTorch call
ACT_PAIRS = 7
# the form csrc/activations.cu's mish forward computes, printed with its
# pairs against F.mish
MISH_FWD_FORM = ("x n / (n + 2), n = e (e + 2), e = expf(x), __fdividef, x "
                 "above 20; 4 elements a thread, 256 threads a block")
SAM_FRAMES = ((1024, 1024),) * 3 + ((512, 512),)   # create_testset, hard
SAM_GLOBAL_BLOCKS = 4
# the loss zoo's kernels (cartseg_tpu_torch.losses) and their path shapes:
# the trainers' logits and the focal-Dice trainer's (tools/
# run_chip_parity.py:136-143), the smoothed one-hot's labels (:166-168),
# the activations' NHWC feature map and flat matrix (:157-164)
ACT_KINDS = ("mish", "swish", "hswish")
ZOO_KERNELS = ("focal", "soft_dice", "one_hot") + tuple(
    f"{k}_{d}" for k in ACT_KINDS for d in ("fwd", "bwd"))
FOCAL_SHAPES = ((6, 512, 512, 1), (20, 224, 224, 1))
DICE_SHAPE = (6, 512, 512, 1)
ONE_HOT_SHAPE, ONE_HOT_C, ONE_HOT_IGNORE = (6, 262144), 8, 255
ACT_SHAPES = ((6, 512, 512, 16), (12288, 2048))
# kernel vs plain: focal, mish and swish within 2e-6 of the plain output's
# max |value| (about 4 float32 ulps of it: nvcc's FMA contraction against
# eager PyTorch's two roundings); soft-Dice's sums within 1e-6 relative
# (non-negative fp32 terms summed in another order, about twenty adds
# deep); one_hot and hswish bit for bit
ELEM_TOL, DICE_TOL = 2e-6, 1e-6
# floating-point operations an element, for the operations bound: the
# transcendental functions (exp, log1p, tanh, pow) counted as one each
ZOO_FLOPS = {"focal": 40, "soft_dice": 8, "one_hot": 0, "mish_fwd": 6,
             "mish_bwd": 14, "swish_fwd": 4, "swish_bwd": 9,
             "hswish_fwd": 5, "hswish_bwd": 5}
# the public loss zoo on the card against the same calls on the CPU, at a
# small size: values and gradients (rtol, atol); sums and sorts run in
# another order
ZOO_REF_TOL = (1e-4, 1e-5)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense FLOP/s
# of fp32 outside the tensor cores and of bf16 and TF32 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}
# windows of the profiler taken for one reading before it counts as lost,
# and the pause before the second (the i-th waits i times as long)
PROFILE_TRIES, PROFILE_PAUSE_S = 6, 0.5
# the seconds of those pauses left to the run
PROFILE_PAUSES_S = [60.0]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x:.2f}" for x in xs) + "]"


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of fn() over `reps` calls, CUDA events, after
    one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_trace(fn, calls: int = 1, keep=bool) -> dict:
    """device_kernels of `calls` calls of fn, retaken while `keep(trace)`
    is false, at most PROFILE_TRIES times, with a pause that grows between
    tries; returns the last trace. The profiler on the H100 machines can
    drop a window's events, a kernel's or all of them (a run read an empty
    trace three windows in a row, each right after the last). The pauses
    of a whole run draw on PROFILE_PAUSES_S, so a profiler that stays
    broken costs the run a minute at most."""
    from cartseg_tpu_torch.utils.profiling import device_kernels

    for i in range(PROFILE_TRIES):
        pause = min(PROFILE_PAUSE_S * i, PROFILE_PAUSES_S[0])
        PROFILE_PAUSES_S[0] -= pause
        time.sleep(pause)
        trace = device_kernels(fn, calls)
        if keep(trace):
            break
    return trace


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bytes_bound(n: int) -> tuple:
    """(bound_ms, "bytes"): n bytes, each input read once and each output
    written once, at the card's HBM rate."""
    return n / HBM_BYTES_PER_S * 1e3, "bytes"


def flash_bound(q: torch.Tensor, rel_h: torch.Tensor) -> tuple:
    """The larger of the two products' FLOPs (4*bnh*S^2*hd) on the route's
    units and q, k, v, rel_h, rel_w, out once at the HBM rate. bf16 runs
    its products on the tensor cores at the bf16 peak; fp32 runs each as
    TF32_TERMS TF32 products at the TF32 peak (the split-TF32 route;
    `fwd_cuda_core_ms` gives its fp32 CUDA-core time, printed beside)."""
    bnh, S, hd = q.shape
    flops = 4.0 * bnh * S * S * hd
    t_ops = (flops / PEAK_FLOPS[q.dtype] * 1e3 if q.dtype == torch.bfloat16
             else TF32_TERMS * flops / PEAK_FLOPS["tf32"] * 1e3)
    t_bytes, _ = bytes_bound(4 * q.numel() * q.element_size()
                             + 2 * nbytes(rel_h))
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fwd_cuda_core_ms(q: torch.Tensor) -> float:
    """The forward's two fp32 products at the CUDA cores' fp32 peak, one
    FMA a multiply-add: the bound of the route before split TF32."""
    bnh, S, hd = q.shape
    return 4.0 * bnh * S * S * hd / PEAK_FLOPS[torch.float32] * 1e3


def bwd_flops(q: torch.Tensor, kernel: str) -> float:
    """The products' FLOPs of a backward kernel: 2*bnh*S^2*hd each, 3 for
    dq (q k^T, dO v^T, dS K), 4 for dkv (q k^T, dO v^T, P^T dO, dS^T Q)."""
    bnh, S, hd = q.shape
    return (3 if kernel == "flash_bwd_dq" else 4) * 2.0 * bnh * S * S * hd


def bwd_bound(q: torch.Tensor, rel_h: torch.Tensor, kernel: str) -> tuple:
    """The larger of the products' FLOPs on the route's units and the
    kernel's bytes at the HBM rate: q, k, v, dO, rel_h, rel_w and the fp32
    lse and D read once; dq, drel_h, drel_w or dk, dv written once. bf16
    runs its products on the tensor cores at the bf16 peak; fp32 runs each
    as TF32_TERMS TF32 products at the TF32 peak (the split-TF32 route;
    `bwd_cuda_core_ms` gives its fp32 CUDA-core time, printed beside)."""
    bnh, S, hd = q.shape
    dq = kernel == "flash_bwd_dq"
    t_ops = (bwd_flops(q, kernel) / PEAK_FLOPS[q.dtype] * 1e3
             if q.dtype == torch.bfloat16 else
             TF32_TERMS * bwd_flops(q, kernel) / PEAK_FLOPS["tf32"] * 1e3)
    qb, rb = nbytes(q), nbytes(rel_h)
    written = qb + 2 * rb if dq else 2 * qb
    t_bytes, _ = bytes_bound(4 * qb + 2 * rb + 2 * bnh * S * 4 + written)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_cuda_core_ms(q: torch.Tensor, kernel: str) -> float:
    """A backward kernel's fp32 products at the CUDA cores' fp32 peak, one
    FMA a multiply-add: the bound of the route before split TF32."""
    return bwd_flops(q, kernel) / PEAK_FLOPS[torch.float32] * 1e3


# an H100 SM: shared memory for resident blocks (1 KB of it reserved a
# block), 32-bit registers, threads a block of the fp32 kernels
SM_SMEM_BYTES, SMEM_RESERVED, SM_REGS, F32_THREADS = 233472, 1024, \
    65536, 128


def f32_smem(kernel: str, hd: int, g: int) -> int:
    """Dynamic shared memory of the fp32 split-TF32 kernels, as
    csrc/flash_relpos.cu's smem_bytes and csrc/flash_relpos_bwd.cu's
    dq_smem_bytes / dkv_smem_bytes size it: [64][hd + 8] fp32 tiles (the
    forward: 2 stages of K and V; dq: Q, dO, 2 stages of K and V, and for
    g != 64 the [64, g] drel sums and the staged [64][68] dS; dkv: K, V
    and 2 stages of Q, dO and three rows of 64)."""
    tile = 64 * (hd + 8)
    if "fwd" in kernel:
        return 4 * 4 * tile
    if "dkv" in kernel:
        return 4 * (2 * tile + 2 * (2 * tile + 3 * 64))
    floats = 6 * tile
    if g != 64:
        floats += 2 * 64 * (g + (12 - g % 8) % 8) + 64 * 68
    return 4 * floats


def blocks_an_sm(regs: int, smem: int) -> int:
    """Blocks of F32_THREADS threads an SM holds by registers (allocated 8
    a thread at a time) and by shared memory."""
    per_block = -(-regs // 8) * 8 * F32_THREADS
    return min(SM_REGS // per_block, SM_SMEM_BYTES // (smem + SMEM_RESERVED))


def sums_bound(a: torch.Tensor, b: torch.Tensor, same: bool) -> tuple:
    """channel_sums(a, b): a (and b unless it is a) read once, the two
    fp32 [C] sums written once, at the HBM rate; an add and an FMA (3
    FLOP) an element at the fp32 CUDA-core peak."""
    n = nbytes(a) + (0 if same else nbytes(b)) + 2 * a.shape[1] * 4
    t_bytes, _ = bytes_bound(n)
    t_ops = 3.0 * a.numel() / PEAK_FLOPS[torch.float32] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def sums_plan(a: torch.Tensor, b: torch.Tensor):
    """The launch plan channel_sums takes for (a, b) on this card
    (ops/cuda/channel_sums.py `plan`)."""
    from cartseg_tpu_torch.ops.cuda.channel_sums import memory_order, plan

    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    return plan(a.shape, memory_order(a) == "nhwc", (a.dtype, b.dtype),
                (a.data_ptr(), b.data_ptr()), sms)


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()
    return float(out[0]) * 1e6


def edt_bound(seeds: torch.Tensor, ops_a_candidate: int = EDT_OPS) -> tuple:
    """The larger of the bytes (the seeds read once, the float distances
    written once) at the HBM rate and the flood's operations,
    `ops_a_candidate` a candidate, 8 candidates a step and pixel, at
    OPS_PER_SM_CLOCK on every SM at the maximum SM clock."""
    from cartseg_tpu_torch.ops.cuda.edt import jfa_steps

    n, (_, H, W) = seeds.numel(), seeds.shape
    t_bytes, _ = bytes_bound(5 * n)
    ops = ops_a_candidate * 8 * len(jfa_steps(H, W)) * n
    rate = (OPS_PER_SM_CLOCK * sm_clock_hz()
            * torch.cuda.get_device_properties(0).multi_processor_count)
    t_ops = ops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_nodes(fn) -> list:
    """(kind, name) of each operation one call of fn puts on the card, from
    a CUDA graph of the call (utils/profiling.py `graph_nodes`, which the
    profiler's lost events cannot touch): a kernel's name demangled."""
    from cartseg_tpu_torch.utils.profiling import graph_nodes as nodes

    return [(kind, demangle(sym) if kind == "KERNEL" else sym)
            for kind, sym in nodes(fn)]


def kernels_a_call(fn, what: str, calls: int = 10) -> tuple:
    """The device kernels and copies one call of fn runs, from a CUDA
    graph of the call (graph_nodes), as a list of names, which must hold
    1 to MAX_KERNELS_A_CALL kernels and copies and no memset; and, from
    the profiler's trace of `calls` calls, each one's mean device ms a
    launch (None where the profiler's windows lost its events: the
    profiler on the H100 machines can drop some or all of a window's
    events, so it checks nothing here)."""
    fn()
    nodes = graph_nodes(fn)
    names = [n for kind, n in nodes if kind in ("KERNEL", "MEMCPY",
                                                "MEMSET")]
    if not 1 <= len(names) <= MAX_KERNELS_A_CALL or any(
            kind == "MEMSET" or "memset" in n.lower() for kind, n in nodes):
        raise AssertionError(f"a {what} call ran {nodes}; want 1.."
                             f"{MAX_KERNELS_A_CALL} CUDA kernels a call and "
                             "no memset")

    def launches(trace):
        got = {}
        for n, (c, us) in trace.items():
            c0, us0 = got.get(demangle(n), (0, 0.0))
            got[demangle(n)] = (c0 + c, us0 + us)
        return got

    kernels = [n for kind, n in nodes if kind == "KERNEL"]
    want = {n: kernels.count(n) * calls for n in kernels}
    trace = launches(kernel_trace(fn, calls, keep=lambda t: all(
        launches(t).get(n, (0, 0))[0] == c for n, c in want.items())))
    ms = {n: (trace[n][1] / trace[n][0] / 1e3 if n in trace else None)
          for n in dict.fromkeys(names)}
    return names, ms


def ms_text(ms: dict) -> str:
    """kernels_a_call's device ms a launch, for a log line."""
    return ", ".join(f"{n} {t:.4f}" if t is not None else
                     f"{n} not measured (the profiler lost its events)"
                     for n, t in ms.items())


def cc_occupancy(report: list) -> None:
    """cc_tiles' registers (-Xptxas -v), dynamic shared memory at the
    path's 512^2 (ops/cuda/cc.py `plan`) and blocks an SM by registers,
    shared memory and threads."""
    from cartseg_tpu_torch.ops.cuda.cc import plan

    for name, used, _ in report:
        if "cc_tiles" not in name:
            continue
        reach = "true>" in name.replace(" ", "") or "ILb1ELb1E" in name
        p = plan(S, S, reach)
        regs = int(used.split("Used ")[1].split()[0])
        by_regs = SM_REGS // (-(-regs // 8) * 8 * CC_THREADS)
        blocks = min(by_regs, SM_SMEM_BYTES // (p.smem + SMEM_RESERVED),
                     SM_THREADS // CC_THREADS)
        log(f"  {name}: {regs} registers, {p.smem} bytes of dynamic shared "
            f"memory at {S}^2 ({p.rows} x {p.cols} tiles): {blocks} blocks "
            f"an SM")


def demangle(name: str) -> str:
    """A kernel's C++ name and template arguments, without its parameter
    list, where c++filt is at hand; else the symbol as it is."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name
    name = out.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ")


def ptxas_report(text: str) -> list:
    """(kernel, 'Used ...' line, spill line) per entry function of the
    compiler's -Xptxas -v output."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = demangle(line.split("'")[1]), ""
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and name:
            rows.append((name, line.split(":", 1)[-1].strip(), spill))
    return rows


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = float((got.double() - want.double()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
    log(f"  {name}: kernel == plain, bit for bit {tuple(got.shape)}")
    return err


def cc_masks(rng: np.random.Generator) -> np.ndarray:
    """Phase 3's mixed [64,512,512] masks (tools/cc_timing.py's): blobs,
    noise, all background, all foreground, a spiral and cut rings."""
    from cartseg_tpu_torch.tools.cc_timing import mixed_masks

    return mixed_masks(rng, B, S)


def check_cc_twice(name: str, m: torch.Tensor, seeds: torch.Tensor) -> float:
    """CC at both connectivities and reach (weak m, strong seeds) against
    their plain versions bit for bit, and the same bits on a second
    call."""
    from cartseg_tpu_torch.ops.cuda.cc import (cc_batch, cc_batch_plain,
                                               reach_batch,
                                               reach_batch_plain)

    e = []
    for conn in (8, 4):
        got = cc_batch(m, conn)
        e.append(check_equal(f"cc conn{conn} {name}", got,
                             cc_batch_plain(m, conn)))
        check_equal(f"cc conn{conn} {name} second call", cc_batch(m, conn),
                    got)
    got = reach_batch(m, seeds)
    check_equal(f"reach {name}", got, reach_batch_plain(m, seeds))
    check_equal(f"reach {name} second call", reach_batch(m, seeds), got)
    return max(e)


def edt_plan_text(shape) -> str:
    from cartseg_tpu_torch.ops.cuda.edt import plan

    p = plan(*shape[1:])
    if not p.steps_b:
        return f"split {p.split}, one launch"
    return (f"split {p.split}, tiles {p.tile} halo {p.halo}, steps "
            f"{list(p.steps_a)} | {list(p.steps_b)}")


def lsr_inputs(dev):
    """[6*512*512, 8] logits, labels in 0..7 with every 7th row at the
    ignore index 255, and an upstream gradient."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    n = TRAIN_BS * S * S
    x = (torch.randn((n, 8), generator=g) * 3).to(dev)
    lab = torch.randint(0, 8, (n,), generator=g)
    lab[::7] = 255
    return x, lab.to(dev), torch.randn((n,), generator=g).to(dev)


def load_frames(root: Path) -> np.ndarray:
    """The first B frames of the tree, letterboxed as the host loop does."""
    from cartseg_tpu_torch import geometry as G
    from cartseg_tpu_torch.utils import image_io

    paths = sorted(root.rglob("*.png"))[:B]
    return np.stack([G.letterbox_resize(image_io.read_rgb(p), S)
                     for p in paths])


def make_members(ckpt_dir: Path):
    from cartseg_tpu_torch.models import build_model

    paths = []
    for i in range(3):
        torch.manual_seed(SEED + i)
        model = build_model("efficientnet-b0")
        p = ckpt_dir / f"member{i}.pth"
        torch.save({"model_state_dict": model.state_dict()}, p)
        p.with_suffix(".threshold.json").write_text('{"threshold": 0.5}')
        paths.append(p)
    return paths


def phase_compare(frames: np.ndarray, dev) -> dict:
    from cartseg_tpu_torch.ops.cuda.cc import (cc_batch, cc_batch_plain,
                                               reach_batch,
                                               reach_batch_plain)
    from cartseg_tpu_torch.ops.cuda.median import (MAX_CLUSTER, MAX_SLICE,
                                                   median_rows,
                                                   median_rows_plain, plan)
    from cartseg_tpu_torch.ops.edges import canny_weak_strong, rgb_to_gray

    from cartseg_tpu_torch.utils.synthetic import blob_masks, spiral_mask

    rng = np.random.default_rng(SEED)
    err = {}
    masks = torch.from_numpy(cc_masks(rng)).to(dev)
    e = []
    for conn in (8, 4):
        got = cc_batch(masks, conn)
        e.append(check_equal(f"cc conn{conn} [blobs|noise|bg|fg|spiral|"
                             "rings]", got, cc_batch_plain(masks, conn)))
        check_equal(f"cc conn{conn} mixed second call", cc_batch(masks, conn),
                    got)
    # cart-like blobs at the path's shape, the ragged shapes and one
    # 2048^2 spiral arm (16 x 1024 tiles, two across), seeds at 1 %
    cases = [("blobs [64,512,512]", blob_masks(rng, (B, S, S), n=8))]
    for shape in CC_SHAPES:
        cases += [(f"blobs {list(shape)}", blob_masks(rng, shape)),
                  (f"noise {list(shape)}", rng.random(shape) < 0.45)]
    cases.append(("spiral [1,2048,2048]", spiral_mask(2048)[None]))
    for name, m in cases:
        seeds = m & (rng.random(m.shape) < 0.01)
        if name.startswith("spiral"):
            seeds[0, 0, 0] = True          # the arm's outer end
        e.append(check_cc_twice(name, torch.from_numpy(m).to(dev),
                                torch.from_numpy(seeds).to(dev)))
    err["cc"] = max(e)

    gray = rgb_to_gray(torch.from_numpy(frames).to(dev))
    weak, strong = canny_weak_strong(gray, 50.0, 150.0)
    log(f"  canny maps: weak {float(weak.float().mean()):.4f}, strong "
        f"{float(strong.float().mean()):.4f} of pixels")
    got = reach_batch(weak, strong)
    err["reach"] = check_equal("reach [canny weak/strong]", got,
                               reach_batch_plain(weak, strong))
    check_equal("reach [canny weak/strong] second call",
                reach_batch(weak, strong), got)

    g = torch.Generator(device="cpu").manual_seed(SEED)
    p = torch.sigmoid(3 * torch.randn((B, S * S), generator=g))
    x = (p - 0.5).abs() * 2.0
    x[40:56] = torch.round(x[40:56] * 16) / 16      # many duplicates
    x[56:60] = torch.where(x[56:60] > 0.5, 1.0, 0.0)
    x[60:] = 0.0                                   # all-zero rows
    x = x.to(dev)
    got = median_rows(x)
    err["median"] = check_equal(f"median [64,262144] ({plan(S * S)})", got,
                                median_rows_plain(x))
    check_equal("median [64,262144] second call", median_rows(x), got)
    # rows past what a cluster holds: the stream route, by plan(N)
    n_long = MAX_CLUSTER * MAX_SLICE + 1
    xl = (torch.sigmoid(3 * torch.randn((4, n_long), generator=g)) - 0.5
          ).abs() * 2.0
    xl[1] = 0.0
    xl[2] = torch.round(xl[2] * 16) / 16
    xl = xl.to(dev)
    got = median_rows(xl)
    check_equal(f"median [4,{n_long}] ({plan(n_long)})", got,
                median_rows_plain(xl))
    check_equal(f"median [4,{n_long}] second call", median_rows(xl), got)

    from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, edt_batch_plain
    from cartseg_tpu_torch.ops.cuda.lsr import (lsr_bwd, lsr_bwd_plain,
                                                lsr_fwd, lsr_fwd_plain)
    from cartseg_tpu_torch.utils.synthetic import edt_seeds

    seeds = torch.from_numpy(edt_seeds(rng, (TRAIN_BS, S, S))).to(dev)
    got = edt_batch_jfa(seeds)
    err["edt"] = check_equal("edt [6,512,512] (GT boundaries|none|single|"
                             "all)", got, edt_batch_plain(seeds))
    check_equal("edt [6,512,512] second call", edt_batch_jfa(seeds), got)
    for shape in EDT_SHAPES:
        s = torch.from_numpy(edt_seeds(rng, shape)).to(dev)
        got = edt_batch_jfa(s)
        check_equal(f"edt {list(shape)} (plan {edt_plan_text(shape)})", got,
                    edt_batch_plain(s))
        check_equal(f"edt {list(shape)} second call", edt_batch_jfa(s), got)
    x, lab, up = lsr_inputs(dev)
    ones = torch.ones(x.shape[0], device=dev)
    for name, got, want in (
            ("lsr_fwd", lsr_fwd(x, lab, 0.2, 255),
             lsr_fwd_plain(x, lab, 0.2, 255)),
            ("lsr_bwd", lsr_bwd(x, lab, ones, 0.2, 255),
             lsr_bwd_plain(x, lab, ones, 0.2, 255))):
        torch.cuda.synchronize()
        err[name] = float((got - want).abs().max())
        if not err[name] <= LSR_TOL[name]:
            raise AssertionError(f"{name}: max abs err {err[name]} above "
                                 f"{LSR_TOL[name]}")
        log(f"  {name} [6,512,512,8]: max abs err {err[name]:.3e} "
            f"(tolerance {LSR_TOL[name]})")
    # lsr_fwd and lsr_bwd on both routes (the logits as they are: float4
    # rows; a copy 4 bytes past a 16-byte boundary: one thread a row) and
    # both label types, the backward at unit and random g
    from cartseg_tpu_torch.ops.cuda.lsr import route

    flat = torch.empty(x.numel() + 1, device=dev)
    flat[1:] = x.reshape(-1)
    for xs in (x, flat[1:].view(x.shape)):
        for lb in (lab, lab.to(torch.int32)):
            got = lsr_fwd(xs, lb, 0.2, 255)
            torch.cuda.synchronize()
            e = float((got - lsr_fwd_plain(xs, lb, 0.2, 255)).abs().max())
            if not e <= LSR_TOL["lsr_fwd"]:
                raise AssertionError(
                    f"lsr_fwd {route(xs)} route, {lb.dtype}: max abs err "
                    f"{e} above {LSR_TOL['lsr_fwd']}")
            log(f"  lsr_fwd [6,512,512,8] {route(xs)} route, {lb.dtype} "
                f"labels: max abs err {e:.3e} (tolerance "
                f"{LSR_TOL['lsr_fwd']})")
            for gname, gu, tol in (("unit g", ones, LSR_TOL["lsr_bwd"]),
                                   ("random g", up, LSR_BWD_TOL_G)):
                got = lsr_bwd(xs, lb, gu, 0.2, 255)
                torch.cuda.synchronize()
                e = float((got - lsr_bwd_plain(xs, lb, gu, 0.2, 255))
                          .abs().max())
                if not e <= tol:
                    raise AssertionError(
                        f"lsr_bwd {route(xs)} route, {lb.dtype}, "
                        f"{gname}: max abs err {e} above {tol}")
                log(f"  lsr_bwd [6,512,512,8] {route(xs)} route, "
                    f"{lb.dtype} labels, {gname}: max abs err {e:.3e} "
                    f"(tolerance {tol})")
    return err


def phase_workload(tmp: Path, dev) -> tuple:
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.workloads import create_pseudo_labels as cli

    images = tmp / "images"
    out_dir = tmp / "pseudo"
    ckpts = make_members(tmp)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main([
        "--images_root", str(images), "--out_dir", str(out_dir),
        "--checkpoints", ",".join(map(str, ckpts)),
        "--batch_size", str(B), "--img_size", str(S),
        "--max_per_bucket", "1000", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"  workload: {result['accepted']} accepted, {wall:.1f} s wall "
        f"(host decode + PNG/npz encode included), launches {launches}")
    for k in PSEUDO_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "workload")

    check_pseudo_outputs(images, out_dir, sorted(images.rglob("*.png")))
    return launches, ckpts


def check_pseudo_outputs(images: Path, out_dir: Path, frames: list) -> None:
    """Every frame's mask, prob file and CSV row, well formed."""
    from cartseg_tpu_torch.infer.pseudo_labels import QC_HEADER
    from cartseg_tpu_torch.utils import image_io

    with open(out_dir / "qc_scores.csv") as f:
        rows = list(csv.reader(f))
    if rows[0] != QC_HEADER or len(rows) != len(frames) + 1:
        raise AssertionError(f"qc_scores.csv: header {rows[0]}, "
                             f"{len(rows) - 1} rows for {len(frames)} frames")
    for p in frames:
        rel = p.relative_to(images)
        hits = [d / rel.parent for d in (out_dir, out_dir / "uncertain")
                if (d / rel.parent / f"{p.stem}.png").exists()]
        if len(hits) != 1:
            raise AssertionError(f"no single mask for {rel}")
        mask = image_io.decode_png((hits[0] / f"{p.stem}.png").read_bytes())
        prob = np.load(hits[0] / f"{p.stem}_prob.npz")["prob"]
        if mask.shape != (S, S) or not set(np.unique(mask)) <= {0, 255}:
            raise AssertionError(f"bad mask for {rel}")
        if prob.shape != (S, S) or not np.isfinite(prob).all() or \
                prob.min() < 0 or prob.max() > 1:
            raise AssertionError(f"bad probs for {rel}")
    log(f"  workload outputs: {len(frames)} masks, prob files and CSV "
        "rows present and well formed")


def phase_reference(ckpts, frames: np.ndarray, dev) -> None:
    """The card's program in fp32 against the CPU's (plain versions) on
    a small input: probs atol 1e-4, pred equal away from the threshold,
    stats atol 1e-3 (as tests/test_torch_infer.py holds CPU vs JAX)."""
    from cartseg_tpu_torch.infer.engine import (load_member,
                                                pseudo_label_program)
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD)

    x = torch.from_numpy(np.ascontiguousarray(frames[:2, ::8, ::8]))
    outs = {}
    for d in ("cpu", dev):
        members = [load_member(p, device=d, dtype=torch.float32)
                   for p in ckpts]
        prog = pseudo_label_program(members, IMAGENET_MEAN, IMAGENET_STD,
                                    min_area=4)
        pred, probs, stats = prog(x.to(d), 0.5)
        outs[str(d)] = (pred.cpu(), probs.cpu(),
                        {k: v.cpu() for k, v in stats.items()})
    (pc, qc_, sc), (pg, qg, sg) = outs["cpu"], outs[str(dev)]
    perr = float((qc_ - qg).abs().max())
    far = (qc_ - 0.5).abs() > 1e-4
    serr = max(float((sc[k] - sg[k]).abs().max()) for k in sc)
    if perr > 1e-4 or not torch.equal(pc[far], pg[far]) or serr > 1e-3:
        raise AssertionError(f"card vs CPU fp32: probs err {perr}, stats "
                             f"err {serr}")
    log(f"  card fp32 program == CPU reference on [2,64,64,3]: probs max "
        f"err {perr:.2e}, stats max err {serr:.2e}")


def phase_timing(ckpts, frames: np.ndarray, dev, card: str) -> dict:
    from cartseg_tpu_torch.infer.engine import (load_member,
                                                pseudo_label_program)
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD)
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.cc import (cc_batch, cc_batch_plain,
                                               reach_batch,
                                               reach_batch_plain)
    from cartseg_tpu_torch.ops.cuda.median import (median_rows,
                                                   median_rows_plain)
    from cartseg_tpu_torch.ops.edges import canny_weak_strong, rgb_to_gray

    members = [load_member(p, device=dev) for p in ckpts]
    prog = pseudo_label_program(members, IMAGENET_MEAN, IMAGENET_STD,
                                min_area=int(S * S * 0.001))
    x = torch.from_numpy(frames).to(dev)
    prog(x, 0.5)
    ms = cuda_ms(lambda: prog(x, 0.5), reps=10)
    log(f"  pseudo_label_program bs{B}@{S}^2 (3x effnet-b0 bf16, flip TTA, "
        f"CC, QC): {ms:.3f} ms/batch, {B * 1000.0 / ms:.2f} img/s "
        f"[{card}]")

    # the kernels' inputs as the path makes them
    _, probs, _ = prog(x, 0.5)
    pred_in = (probs >= 0.5).contiguous()
    weak, strong = canny_weak_strong(rgb_to_gray(x))
    conf = ((probs - 0.5).abs() * 2.0).reshape(B, -1).contiguous()
    log(f"  kernel inputs from the path: fg share of probs >= 0.5 "
        f"{float(pred_in.float().mean()):.4f}, weak {float(weak.float().mean()):.4f}, "
        f"strong {float(strong.float().mean()):.4f}")
    cases = {
        "cc": (lambda: cc_batch(pred_in), lambda: cc_batch_plain(pred_in)),
        "reach": (lambda: reach_batch(weak, strong),
                  lambda: reach_batch_plain(weak, strong)),
        "median": (lambda: median_rows(conf),
                   lambda: median_rows_plain(conf)),
    }
    times = {}
    for name, (kern, plain) in cases.items():
        # plain, kernel, kernel, plain: drift shows as a gap between pairs
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
            f"{p2:.4f} ms at the path's shapes [{card}]")
    # bounds: the kernels move bytes (a few integer operations a pixel)
    outs = {name: kern() for name, (kern, _) in cases.items()}
    bounds = {"cc": bytes_bound(nbytes(pred_in, outs["cc"])),
              "reach": bytes_bound(nbytes(weak, strong, outs["reach"])),
              "median": bytes_bound(nbytes(conf, outs["median"]))}
    # library yardsticks: no PyTorch call labels components or runs the
    # hysteresis; the median is torch.quantile's midpoint
    med = torch.quantile(conf, 0.5, dim=1, interpolation="midpoint")
    lib_ms = cuda_ms(lambda: torch.quantile(conf, 0.5, dim=1,
                                            interpolation="midpoint"), 5)
    library = {"cc": None, "reach": None, "median": lib_ms}
    log(f"  library: torch.quantile(midpoint) {lib_ms:.4f} ms (max abs "
        f"diff to the kernel {float((med - outs['median']).abs().max()):.2e})"
        f"; cc, reach: no single PyTorch call [{card}]")
    for name, (b, by) in bounds.items():
        log(f"  {name}: bound {b:.5f} ms ({by}, {HBM_BYTES_PER_S:.3g} B/s)")
    # the median by device time (profiler; the L2 flushed before each call,
    # as the path's conf arrives from device memory) beside the CUDA-events
    # reading above: one call's host cost can exceed the kernel. The kernel
    # and the plain version against torch.quantile, and in ACT_PAIRS
    # alternating cold-L2 pairs against it
    from cartseg_tpu_torch.ops.cuda.median import plan as median_plan

    def quantile():
        return torch.quantile(conf, 0.5, dim=1, interpolation="midpoint")

    k1 = device_ms(lambda: median_rows(conf), 20, "median", cold=True)
    p1 = device_ms(lambda: median_rows_plain(conf), 3, cold=True)
    k2 = device_ms(lambda: median_rows(conf), 20, "median", cold=True)
    l1 = device_ms(quantile, 5, cold=True)
    names, _ = kernels_a_call(lambda: median_rows(conf), "median")
    if len(names) != 1 or "median_cluster" not in names[0]:
        raise AssertionError(f"median [64,262144]: ran {names}; want the "
                             "one median_cluster kernel")
    med_ms = (k1 + k2) / 2
    log(f"  median [64,262144] ({median_plan(S * S)}): device time "
        f"(profiler, L2 "
        f"flushed) kernel {k1:.5f}/{k2:.5f} ms, plain {p1:.5f} ms, "
        f"torch.quantile(midpoint) {l1:.5f} ms; CUDA events kernel "
        f"{times['median'][0]:.4f} ms; {len(names)} CUDA kernel a call, no "
        f"memset ({names[0]}; the first version ran 13 and 4 memsets); "
        f"bound {bounds['median'][0]:.5f} ms (bytes), kernel at "
        f"{bounds['median'][0] / med_ms:.3f} of it [{card}]")
    k_ms, l_ms, spread = cold_pairs(lambda: median_rows(conf), quantile,
                                    "median")
    log(f"  median vs torch.quantile(midpoint), {ACT_PAIRS} alternating "
        f"cold-L2 pairs: median kernel {k_ms:.5f} ms, library {l_ms:.5f} "
        f"ms, the kernel {(k_ms - l_ms) / l_ms:+.4f} relative; spread "
        f"{spread:.4f} [{card}]")
    times["median"], library["median"] = (med_ms, p1), l1
    # the path's masks depend on the weights (random init: near all-fg);
    # cart-like blobs and phase 3's mixed masks beside them
    from cartseg_tpu_torch.utils.synthetic import blob_masks

    rng = np.random.default_rng(SEED)
    mixed = torch.from_numpy(cc_masks(rng)).to(dev)
    blobs = torch.from_numpy(blob_masks(rng, (B, S, S), n=8)).to(dev)
    for what, m in (("cart-like blob masks", blobs),
                    ("phase 3's mixed masks", mixed)):
        k1 = cuda_ms(lambda: cc_batch(m), 20)
        k2 = cuda_ms(lambda: cc_batch(m), 20)
        log(f"  cc on {what} [64,512,512]: kernel {k1:.4f}/{k2:.4f} ms, "
            f"plain {cuda_ms(lambda: cc_batch_plain(m), 1):.4f} ms; bound "
            f"{bounds['cc'][0]:.5f} ms, kernel at "
            f"{2 * bounds['cc'][0] / (k1 + k2):.3f} of it [{card}]")
    from cartseg_tpu_torch.ops.cuda.cc import plan

    for name, fn in (("cc", lambda: cc_batch(pred_in)),
                     ("cc conn4", lambda: cc_batch(pred_in, 4)),
                     ("reach", lambda: reach_batch(weak, strong))):
        names, ms = kernels_a_call(fn, name)
        p = plan(S, S, name == "reach")
        log(f"  {name} [64,512,512] ({p.rows} x {p.cols} tiles): "
            f"{len(names)} CUDA kernels a call, no memset ({', '.join(names)}"
            f"; the first version ran 3 for CC, 5 and a memset for reach); "
            f"device ms a launch (profiler): {ms_text(ms)} [{card}]")
    cc_cleanup_split(pred_in, int(S * S * 0.001), card)
    build.reset_launch_counts()
    return {"program_ms": ms, "kernels": times, "bounds": bounds,
            "library": library}


def cc_cleanup_split(pred: torch.Tensor, min_area: int, card: str) -> None:
    """The program's CC-cleanup layer (`remove_small_components`) on the
    path's masks, CUDA events: the whole layer, its labelling kernel
    (`cc_batch`), the area count's `torch.bincount` alone, and the rest
    (the int64 keys, the gather of the areas, the compares)."""
    from cartseg_tpu_torch.ops.connected_components import (
        remove_small_components)
    from cartseg_tpu_torch.ops.cuda.cc import cc_batch

    n = S * S
    lab = cc_batch(pred)
    key = (lab.reshape(B, n).to(torch.int64) + (n + 1) * torch.arange(
        B, device=pred.device).unsqueeze(1)).reshape(-1)
    layer = cuda_ms(lambda: remove_small_components(pred, min_area), 20)
    label = cuda_ms(lambda: cc_batch(pred), 20)
    count = cuda_ms(lambda: torch.bincount(key, minlength=B * (n + 1)), 20)
    log(f"  CC cleanup layer (remove_small_components, min_area {min_area})"
        f" on the path's masks: {layer:.4f} ms = labelling kernel "
        f"{label:.4f} + bincount area count {count:.4f} + the rest "
        f"{layer - label - count:.4f} (keys, gather, compares) [{card}]")


def make_train_tree(tmp: Path) -> tuple:
    """The synthetic image+mask tree both training workloads run on."""
    from cartseg_tpu_torch.utils.synthetic import make_png_pair_tree

    t0 = time.perf_counter()
    ir, mr = make_png_pair_tree(tmp / "train", TRAIN_SESSIONS,
                                TRAIN_PER_SESSION, FRAME_HW, seed=SEED)
    log(f"  training tree: {TRAIN_SESSIONS}x{TRAIN_PER_SESSION} PNG "
        f"frames+masks {FRAME_HW[1]}x{FRAME_HW[0]} in "
        f"{time.perf_counter() - t0:.1f} s")
    return ir, mr


def check_train_outputs(out: Path, schema: list) -> list:
    """The CSV (header, two finite rows) and the .pth, sidecar and
    .last.pth of a 2-epoch run; returns the CSV rows."""
    with open(out / "training_metrics.csv") as f:
        rows = list(csv.reader(f))
    if rows[0] != schema or len(rows) != 3:
        raise AssertionError(f"training_metrics.csv: header {rows[0]}, "
                             f"{len(rows) - 1} rows")
    if not all(np.isfinite(float(v)) for r in rows[1:] for v in r):
        raise AssertionError(f"non-finite values in the CSV: {rows[1:]}")
    for f in ("model.pth", "model.threshold.json", "model.last.pth"):
        if not (out / f).exists():
            raise AssertionError(f"{f} was not written")
    return rows


def phase_train_workload(tmp: Path, dev, ir: Path, mr: Path) -> tuple:
    """The ABL training workload through its CLI at its CONFIG."""
    from cartseg_tpu_torch.infer.engine import load_member
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train.engine import SCHEMAS
    from cartseg_tpu_torch.workloads import train_bce_dice_abl as cli

    out = tmp / "run_abl"
    build.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(["--images_root", str(ir), "--masks_root", str(mr),
                       "--out_dir", str(out), "--epochs", "2",
                       "--device", "cuda"], log=lambda m: log(f"    {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    log(f"  train workload: 2 epochs in {wall:.1f} s wall (model init, "
        f"PNG decode, val and the sweep included), launches {launches}")
    for k in TRAIN_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "training workload")

    rows = check_train_outputs(out, SCHEMAS["abl"])
    hist = json.loads((out / "history.json").read_text())
    pth = out / "model.pth"
    member = load_member(pth, device=dev)
    side = json.loads((out / "model.threshold.json").read_text())
    if abs(member.threshold - result["threshold"]) > 1e-9 or \
            abs(side["threshold"] - result["threshold"]) > 1e-9:
        raise AssertionError("the .pth did not load with the sweep's "
                             "threshold")
    log(f"  train outputs: CSV {rows[1:]}, .pth + sidecar (threshold "
        f"{member.threshold:.2f}) + .last.pth; the .pth loads into the "
        "pseudo-labeller")
    return launches, hist


def _small_step_setup(device: str):
    from cartseg_tpu_torch.train import LossSpec, TrainConfig, Trainer

    cfg = TrainConfig(encoder="efficientnet-b0", img_size=(64, 64),
                      batch_size=2, compute_dtype="float32", augment="none",
                      imagenet_norm=True, seed=SEED, device=device,
                      loss=LossSpec("bce_dice_abl", {"bce_weight": 0.5,
                                                     "abl_weight": 0.1}))
    tr = Trainer(cfg)
    return tr, tr.init_state()


def phase_train_reference(dev) -> None:
    """One fp32 train step on the card against the CPU's (the plain
    versions) from the same state on [2,64,64]: loss and components rel
    1e-4, the whole gradient (read from the first moment) relative L2
    1e-2. That gradient is sensitive to summation order: on the CPU alone
    it moves by 1e-3 (64^2 bs2) to 4e-3 (128^2 bs4) in relative L2 when
    only the thread count changes, and cuDNN sums in yet other orders."""
    from cartseg_tpu_torch.device import set_fp32_policy

    set_fp32_policy()
    r = np.random.default_rng(SEED)
    imgs = r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:64, :64]
    m = np.zeros((2, 64, 64, 1), np.float32)
    m[0, ..., 0] = (yy - 30) ** 2 + (xx - 26) ** 2 <= 15 ** 2
    m[1, 10:40, 20:50, 0] = 1.0
    imgs[m[..., 0] > 0] //= 3
    outs = {}
    sd = None
    for d in ("cpu", str(dev)):
        tr, st = _small_step_setup(d)
        if sd is None:
            sd = {k: v.clone() for k, v in st.model.state_dict().items()}
        st.model.load_state_dict(sd)
        loss, ok, comps = tr.train_step(
            st, torch.from_numpy(imgs).to(d), torch.from_numpy(m).to(d),
            torch.ones(2, device=d), [1e-4] * 3, [1.0] * 3, tr.group_ids(st))
        outs[d] = (float(loss), {k: float(v) for k, v in comps.items()},
                   torch.cat([v.reshape(-1).cpu()
                              for v in st.opt.mu.values()]))
    (lc, cc, gc), (lg, cg, gg) = outs["cpu"], outs[str(dev)]
    gerr = float((gg - gc).norm() / gc.norm())
    cerr = max(abs(cg[k] - cc[k]) / max(abs(cc[k]), 1e-7) for k in cc)
    if abs(lg - lc) > 1e-4 * abs(lc) or cerr > 1e-4 or gerr > 1e-2:
        raise AssertionError(f"card vs CPU train step: loss {lg} vs {lc}, "
                             f"components rel err {cerr}, gradient rel "
                             f"err {gerr}")
    log(f"  card fp32 train step == CPU on [2,64,64]: loss {lg:.6f} vs "
        f"{lc:.6f}, components rel err {cerr:.2e}, gradient rel L2 "
        f"{gerr:.2e} (boundary_used {cg['boundary_used']})")


def _busy_share(fn, n: int) -> float:
    """Device busy share over n calls of fn: the summed durations of the
    kernels in the profiler's trace over the host wall time of the
    window (one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return busy / wall_us


def device_ms(fn, n: int, match: str = "", cold: bool = False) -> float:
    """Device time per call of fn: the summed durations of the kernels and
    copies the profiler records over n calls (those whose name contains
    `match`), over n, after one call unrecorded. Unlike CUDA events
    around a loop, it leaves out the gaps in which the card waits for
    the host. cold: flush the 50 MB L2 cache before every call (a 256 MB
    buffer zeroed; its fill kernel is left out of the sum), as a caller
    whose inputs come from device memory finds it; back to back, a
    25.2M-element activation reads part of its 201 MB from the L2 the
    previous call left and runs faster than the HBM bound. The profiler
    can drop events from its window (runs on an H100 read 0 and a fifth
    of an activation's time): a window with no kernel of fn is taken
    again (kernel_trace), and each kernel's launches count whole. Where
    every window came back without one, the time is CUDA events around
    each call instead (after its flush), which holds the host's gaps
    inside a call, and the log says so."""
    call = fn
    flush = None
    if cold:
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

        def call():
            flush.zero_()
            fn()

    def hits(trace):
        return [(c, us) for name, (c, us) in trace.items()
                if match in name and not (cold and "FillFunctor" in name)]

    call()
    trace = kernel_trace(call, n, keep=hits)
    if hits(trace):
        # each kernel runs a fixed count a call: its time is its mean over
        # the launches the trace holds times that count, ceil(launches / n)
        return sum(us / c * -(-c // n) for c, us in hits(trace)) / 1e3
    ms = events_ms(fn, n, flush)
    log(f"  (the profiler's {PROFILE_TRIES} windows of {n} calls held no "
        f"kernel{f' named {match!r}' if match else ''} of the call, the "
        f"last {trace}: timed by CUDA events around each call instead, "
        f"{ms:.5f} ms)")
    return ms


def events_ms(fn, n: int, flush=None) -> float:
    """Mean ms of n calls of fn, CUDA events around each call; `flush`, a
    buffer zeroed before each call outside its events."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize()
    for start, end in pairs:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / n


def cold_pairs(kern, lib, match: str, calls: int = 10) -> tuple:
    """kern's and lib's device time (device_ms, the L2 flushed before each
    call) in ACT_PAIRS alternating pairs, the kernel first in the even
    pairs and the library in the odd: (median kernel ms, median library
    ms, spread), the spread the larger series' (max - min) / median."""
    series = {"kernel": [], "library": []}
    for i in range(ACT_PAIRS):
        for who in (("kernel", "library") if i % 2 == 0 else
                    ("library", "kernel")):
            series[who].append(device_ms(kern, calls, match, cold=True)
                               if who == "kernel" else
                               device_ms(lib, calls, cold=True))
    med = {w: float(np.median(v)) for w, v in series.items()}
    spread = max((max(v) - min(v)) / med[w] for w, v in series.items())
    return med["kernel"], med["library"], spread


def phase_train_timing(dev, card: str, hist) -> dict:
    """The train step at bs6@512^2 on a device-resident batch, the ABL's
    share of it, and the EDT and LSR kernels against their plain
    versions at the path's shapes."""
    from cartseg_tpu_torch.losses.abl import active_boundary_loss
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, edt_batch_plain
    from cartseg_tpu_torch.ops.cuda.lsr import (lsr_bwd, lsr_bwd_plain,
                                                lsr_fwd, lsr_fwd_plain)
    from cartseg_tpu_torch.train import LossSpec, Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.workloads.train_bce_dice_abl import CONFIG

    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame

    r = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([frame(r, (S, S))
                                      for _ in range(TRAIN_BS)])).to(dev)
    masks = torch.from_numpy(blob_masks(r, (TRAIN_BS, S, S), n=3)[..., None]
                             .astype(np.float32)).to(dev)
    sw = torch.ones(TRAIN_BS, device=dev)
    cfg = apply_cli_overrides(CONFIG, ["--device", "cuda"])
    steps = {}
    for name, loss in (("bce_dice_abl", CONFIG.loss),
                       ("bce_dice", LossSpec("bce_dice",
                                             {"bce_weight": 0.5}))):
        tr = Trainer(cfg.with_overrides(loss=loss))
        st = tr.init_state()
        gids = tr.group_ids(st)
        steps[name] = (tr, st, gids)

    def step(name):
        tr, st, gids = steps[name]
        return lambda: tr.train_step(st, imgs, masks, sw, [1e-4] * 3,
                                     [1.0] * 3, gids)

    for name in steps:
        cuda_ms(step(name), 3)                    # warm-up, cuDNN autotune
    a1 = cuda_ms(step("bce_dice_abl"), 20)
    b1 = cuda_ms(step("bce_dice"), 20)
    b2 = cuda_ms(step("bce_dice"), 20)
    a2 = cuda_ms(step("bce_dice_abl"), 20)
    step_ms, bce_ms = (a1 + a2) / 2, (b1 + b2) / 2
    busy = _busy_share(step("bce_dice_abl"), 5)
    log(f"  train step bs{TRAIN_BS}@{S}^2 (effnet-b0 UNet, bf16 autocast, "
        f"train_512 augment, BCE+Dice+ABL, AdamW): {a1:.3f}/{a2:.3f} ms, "
        f"{TRAIN_BS * 1000.0 / step_ms:.2f} img/s; the same step with "
        f"BCE+Dice only {b1:.3f}/{b2:.3f} ms; ABL share "
        f"{(step_ms - bce_ms) / step_ms:.4f}; device busy share "
        f"{busy:.4f} [{card}]")

    # the ABL alone, forward + backward, on logits of the step's shape
    logits = (torch.randn((TRAIN_BS, S, S, 1), device=dev) * 2).requires_grad_()
    tgt = masks[..., 0].to(torch.int32)

    def abl_fwd_bwd():
        loss, _ = active_boundary_loss(logits, tgt)
        loss.backward()

    abl_ms = cuda_ms(abl_fwd_bwd, 10)
    log(f"  active_boundary_loss fwd+bwd alone [6,512,512,1]: "
        f"{abl_ms:.3f} ms ({abl_ms / step_ms:.4f} of the step) [{card}]")

    # the kernels at the path's shapes: GT boundaries of the step's masks
    # and the [6,512,512,8] direction stack
    from cartseg_tpu_torch.losses.abl import gt2boundary
    seeds = gt2boundary(tgt).contiguous()
    x, lab, g = lsr_inputs(dev)
    cases = {
        "edt": (lambda: edt_batch_jfa(seeds),
                lambda: edt_batch_plain(seeds)),
        "lsr_fwd": (lambda: lsr_fwd(x, lab, 0.2, 255),
                    lambda: lsr_fwd_plain(x, lab, 0.2, 255)),
        "lsr_bwd": (lambda: lsr_bwd(x, lab, g, 0.2, 255),
                    lambda: lsr_bwd_plain(x, lab, g, 0.2, 255)),
    }
    times = {}
    for name, (kern, plain) in cases.items():
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"  {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
            f"{p2:.4f} ms at the path's shapes [{card}]")
    log(f"  epoch images_per_sec from the run's history (train + val + "
        f"host sync, 48 train / 12 val images): "
        f"{[h['images_per_sec'] for h in hist]} [{card}]")
    outs = {name: kern() for name, (kern, _) in cases.items()}
    from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa

    names, stage_ms = kernels_a_call(lambda: edt_batch_jfa(seeds), "edt")
    log(f"  edt [6,512,512] (the step's GT boundaries; plan "
        f"{edt_plan_text(seeds.shape)}): {len(names)} CUDA kernels a call "
        f"({', '.join(names)}; the old schedule ran 82); device ms a launch "
        f"(profiler): {ms_text(stage_ms)} [{card}]")
    bounds = {"edt": edt_bound(seeds),
              "lsr_fwd": bytes_bound(nbytes(x, lab, outs["lsr_fwd"])),
              "lsr_bwd": bytes_bound(nbytes(x, lab, g, outs["lsr_bwd"]))}
    # the library: cross-entropy against the smoothed one-hot as
    # probability targets q (all zero on ignored rows; built untimed): its
    # forward is the LSR loss and its autograd backward, g (softmax sum q -
    # q) with sum q = (C - 1) lb_neg + lb_pos, the LSR gradient
    C = x.shape[1]
    tgt = torch.full_like(x, 0.2 / C)
    keep = lab != 255
    tgt[keep, lab[keep]] = 0.8
    tgt[~keep] = 0.0
    ce = torch.nn.functional.cross_entropy(x, tgt, reduction="none")
    xr = x.detach().clone().requires_grad_(True)
    ce_r = torch.nn.functional.cross_entropy(xr, tgt, reduction="none")

    def lib_bwd():
        return torch.autograd.grad(ce_r, xr, g, retain_graph=True)[0]

    lib_fwd_ms = device_ms(lambda: torch.nn.functional.cross_entropy(
        x, tgt, reduction="none"), 20, cold=True)
    lib_bwd_ms = device_ms(lib_bwd, 20, cold=True)
    library = {"edt": None, "lsr_fwd": lib_fwd_ms, "lsr_bwd": lib_bwd_ms}
    log(f"  library, device time (L2 flushed): F.cross_entropy(probability "
        f"targets) {lib_fwd_ms:.5f} ms (max abs diff to the kernel "
        f"{float((ce - outs['lsr_fwd']).abs().max()):.2e}); its autograd "
        f"backward {lib_bwd_ms:.5f} ms (max abs diff to lsr_bwd "
        f"{float((lib_bwd() - outs['lsr_bwd']).abs().max()):.2e}); edt: no "
        f"PyTorch call [{card}]")
    mix_ms = edt_bound(seeds, EDT_KERNEL_OPS)[0]
    log(f"  edt: bytes bound {bytes_bound(nbytes(seeds, outs['edt']))[0]:.5f}"
        f" ms; operations bound ({EDT_OPS} operations a candidate, "
        f"{OPS_PER_SM_CLOCK} an SM a clock at "
        f"{sm_clock_hz() / 1e6:.0f} MHz) {bounds['edt'][0]:.5f} ms; the "
        f"kernel's own instruction mix ({EDT_KERNEL_OPS} a candidate) at "
        f"that rate {mix_ms:.5f} ms, kernel at {mix_ms / times['edt'][0]:.3f}"
        f" of it [{card}]")
    for name, (b, by) in bounds.items():
        log(f"  {name}: bound {b:.5f} ms ({by}), kernel at "
            f"{b / times[name][0]:.3f} of it")
    # lsr_fwd and lsr_bwd by device time (profiler, L2 flushed) beside the
    # CUDA-events readings above, with the path's int64 labels and with
    # int32 ones; one kernel a call, the vector route, no label conversion
    from cartseg_tpu_torch.ops.cuda.lsr import route

    calls = {"lsr_fwd": lambda lb: lsr_fwd(x, lb, 0.2, 255),
             "lsr_bwd": lambda lb: lsr_bwd(x, lb, g, 0.2, 255)}
    plains = {"lsr_fwd": lambda: lsr_fwd_plain(x, lab, 0.2, 255),
              "lsr_bwd": lambda: lsr_bwd_plain(x, lab, g, 0.2, 255)}
    for name, fn in calls.items():
        dev_ms = {}
        for lb in (lab, lab.to(torch.int32)):
            def call(lb=lb, fn=fn):
                return fn(lb)

            k1 = device_ms(call, 20, name, cold=True)
            k2 = device_ms(call, 20, name, cold=True)
            names, _ = kernels_a_call(call, name)
            if len(names) != 1 or f"{name}_vec" not in names[0]:
                raise AssertionError(f"{name} {lb.dtype}: ran {names}; want "
                                     f"the one {name}_vec kernel")
            ins = (x, lb) if name == "lsr_fwd" else (x, lb, g)
            b, _ = bytes_bound(nbytes(*ins, outs[name]))
            dev_ms[lb.dtype] = (k1 + k2) / 2
            log(f"  {name} [{x.shape[0]},{x.shape[1]}] {lb.dtype} labels "
                f"({route(x)} route): device time (profiler, L2 flushed) "
                f"{k1:.5f}/{k2:.5f} ms; 1 CUDA kernel a call ({names[0]}); "
                f"bound {b:.5f} ms (bytes), kernel at {2 * b / (k1 + k2):.3f}"
                f" of it [{card}]")
        p1 = device_ms(plains[name], 5, cold=True)
        log(f"  {name} plain version, device time (L2 flushed) {p1:.5f} "
            f"ms; CUDA events kernel {times[name][0]:.4f} ms; library "
            f"{library[name]:.5f} ms [{card}]")
        times[name] = (dev_ms[torch.int64], p1)
    build.reset_launch_counts()
    return {"step_ms": step_ms, "kernels": times, "bounds": bounds,
            "library": library}


def phase_bce_workload(tmp: Path, dev, ir: Path, mr: Path,
                       decoder: str = "unet", epochs: int = 2,
                       n_bn: int = BCE_BN_LAYERS) -> dict:
    """workloads/train_bce_dice through its CLI at its CONFIG (resnet34-
    UNet, bs6, 512^2, bf16, train_512; phase 4i: --decoder unetpp_ds),
    `epochs` epochs, once per BN lane: the kernel lane by
    CARTSEG_PALLAS_BN=force, read by the entry point. Launches:
    channel_sums twice per BN layer (n_bn of them) and step in the kernel
    lane, never in the torch lane, and no other kernel in either."""
    from cartseg_tpu_torch.infer.engine import load_member
    from cartseg_tpu_torch.models.norm import (BatchNorm2d,
                                               ChannelSumsBatchNorm2d)
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train.engine import SCHEMAS
    from cartseg_tpu_torch.workloads import train_bce_dice as cli

    runs = {}
    for lane, switch in (("channel_sums", "force"), ("torch", None)):
        out = tmp / f"run_bce_{decoder}_{lane}"
        prev = os.environ.pop("CARTSEG_PALLAS_BN", None)
        if switch is not None:
            os.environ["CARTSEG_PALLAS_BN"] = switch
        try:
            build.reset_launch_counts()
            t0 = time.perf_counter()
            result = cli.main(["--images_root", str(ir), "--masks_root",
                               str(mr), "--out_dir", str(out), "--epochs",
                               str(epochs), "--device", "cuda", "--decoder",
                               decoder], log=lambda m: log(f"    {m}"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
        finally:
            os.environ.pop("CARTSEG_PALLAS_BN", None)
            if prev is not None:
                os.environ["CARTSEG_PALLAS_BN"] = prev
        steps = result["state"].step
        bns = [m for m in result["state"].model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
        cls = ChannelSumsBatchNorm2d if switch else BatchNorm2d
        want = 2 * n_bn * steps if switch else 0
        others = {k: v for k, v in launches.items()
                  if k != "channel_sums" and v}
        log(f"  {lane} lane (CARTSEG_PALLAS_BN={switch}): {steps} steps in "
            f"{wall:.1f} s wall (init, PNG decode, val and the sweep "
            f"included); {len(bns)} BNs, all {cls.__name__}; launches "
            f"{launches}")
        if len(bns) != n_bn or any(type(m) is not cls for m in bns):
            raise AssertionError(f"{lane} lane: BN modules "
                                 f"{sorted({type(m).__name__ for m in bns})}")
        if launches["channel_sums"] != want or others or steps <= 0:
            raise AssertionError(f"{lane} lane: channel_sums launched "
                                 f"{launches['channel_sums']} times in "
                                 f"{steps} steps, want {want}; others "
                                 f"{others}")
        rows = check_train_run(out, SCHEMAS["basic"], epochs)
        hist = json.loads((out / "history.json").read_text())
        if decoder != "unet":
            log(f"  {lane} lane outputs: CSV {rows[1:]}, history, .pth + "
                f"sidecar + .last.pth; channel_sums "
                f"{launches['channel_sums'] / steps:g} launches a step")
            runs[lane] = {"launches": launches, "steps": steps, "out": out,
                          "roots": (str(ir), str(mr))}
            continue
        member = load_member(out / "model.pth", encoder="resnet34",
                             device=dev)
        if abs(member.threshold - result["threshold"]) > 1e-9:
            raise AssertionError("the .pth did not load with the sweep's "
                                 "threshold")
        log(f"  {lane} lane outputs: CSV {rows[1:]}, .pth + sidecar "
            f"(threshold {member.threshold:.2f}) + .last.pth; the .pth "
            "loads into the pseudo-labeller as resnet34")
        runs[lane] = {"launches": launches, "steps": steps, "hist": hist}
    return runs


def bce_batch(hw: int, bs: int, dev) -> tuple:
    """uint8 frames and blob masks at (hw, bs), on the card."""
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame

    r = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([frame(r, (hw, hw))
                                      for _ in range(bs)])).to(dev)
    masks = torch.from_numpy(blob_masks(r, (bs, hw, hw), n=3)[..., None]
                             .astype(np.float32)).to(dev)
    return imgs, masks


def _rel_l2(a: dict, b: dict) -> float:
    """Relative L2 distance of two gradients keyed alike, b the yardstick."""
    return float(torch.cat([(a[k] - b[k]).reshape(-1) for k in b]).norm()
                 / torch.cat([b[k].reshape(-1) for k in b]).norm())


def phase_bce_reference(dev, argv=(), n_bn: int = BCE_BN_LAYERS) -> dict:
    """One fp32 step (TF32 off) of the workload's CONFIG (with `argv`'s
    overrides, e.g. phase 4i's --decoder unetpp_ds) at 512^2 bs6 in
    both lanes from the same weights, generator and batch: loss within
    1e-5 relative and running statistics within 1e-5. The gradients
    (read from the first moment) are held to the torch lane's gradient
    in float64 on the same augmented batch: the kernel lane's fp32
    gradient no farther from it, and no farther from the torch lane's
    fp32 gradient, than twice the torch lane's own fp32 distance from
    it. This model's fp32 gradient is ill conditioned (train-mode BN at
    every layer): either lane's distance from float64, printed below, is
    far above what a fixed tolerance between two BN implementations could
    ask, and a wrong gradient would be O(1) away. Returns what the remat
    check (phase 4i) holds its steps against: the config, weights, batch,
    each lane's (loss, gradient, running stats, launches) and the torch
    lane's distance from float64."""
    from cartseg_tpu_torch.data.augment import augment_batch
    from cartseg_tpu_torch.device import set_fp32_policy
    from cartseg_tpu_torch.models import build_model
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.workloads.train_bce_dice import CONFIG

    set_fp32_policy()
    cfg = apply_cli_overrides(CONFIG, ["--device", "cuda", "--compute_dtype",
                                       "float32", *argv])
    imgs, masks = bce_batch(S, TRAIN_BS, dev)
    sw = torch.ones(TRAIN_BS, device=dev)
    sd, outs = None, {}
    for lane in BN_LANES:
        tr = Trainer(cfg, bn_lane=lane)
        st = tr.init_state()
        if sd is None:
            sd = {k: v.clone() for k, v in st.model.state_dict().items()}
        st.model.load_state_dict(sd)
        build.reset_launch_counts()
        loss, ok, _ = tr.train_step(st, imgs, masks, sw, [1e-4] * 3,
                                    [1.0] * 3, tr.group_ids(st))
        torch.cuda.synchronize()
        outs[lane] = (float(loss), {k: v.double() / 0.1
                                    for k, v in st.opt.mu.items()},
                      {k: v.clone() for k, v in st.model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))},
                      build.LAUNCHES["channel_sums"])
    # the float64 yardstick: the torch lane on the step's augmented batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    x, m = augment_batch(gen, imgs, masks, tr.aug_cfg)
    ref = build_model(cfg.encoder, cfg.classes, "torch", cfg.decoder)
    ref.load_state_dict(sd)
    ref = ref.to(dev).double().to(memory_format=torch.channels_last).train()
    logits = ref(x.double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    l64, _ = tr.loss_fn(logits, m, sw)
    g64 = dict(zip([k for k, _ in ref.named_parameters()],
                   torch.autograd.grad(l64, list(ref.parameters()))))
    (lt, gt, rt, nt), (lk, gk, rk, nk) = outs["torch"], outs["channel_sums"]
    e_t, e_k, gap = _rel_l2(gt, g64), _rel_l2(gk, g64), _rel_l2(gk, gt)
    per = {k: float((gk[k] - g64[k]).norm() / g64[k].norm()) for k in g64}
    worst = max(per, key=per.get)
    serr = max(float(((rk[k] - rt[k]).abs()
                      / (1.0 + rt[k].abs())).max()) for k in rt)
    lrel = abs(lk - lt) / abs(lt)
    log(f"  {cfg.encoder} {cfg.decoder} fp32 step [{TRAIN_BS},{S},{S}] "
        f"(TF32 off), channel_sums lane vs "
        f"torch lane: loss {lk:.8f} vs {lt:.8f} (rel {lrel:.2e}, limit "
        f"1e-5); gradient rel L2 to the float64 torch lane: torch lane "
        f"{e_t:.3e}, channel_sums lane {e_k:.3e} (limit 2x the torch "
        f"lane's), between the lanes {gap:.3e} (limit the same), worst "
        f"parameter of the channel_sums lane {per[worst]:.3e} ({worst}); "
        f"loss float64 {float(l64.detach()):.8f}; running stats max err "
        f"{serr:.2e} "
        f"(limit 1e-5); channel_sums launches {nk} / {nt}")
    build.reset_launch_counts()
    if not (lrel <= 1e-5 and e_k <= 2 * e_t and gap <= 2 * e_t
            and serr <= 1e-5 and nk == 2 * n_bn and nt == 0):
        raise AssertionError("fp32 step: the two BN lanes disagree")
    return {"cfg": cfg, "sd": sd, "imgs": imgs, "masks": masks,
            "outs": outs, "e_t": e_t}


def _bn_inputs(st, step) -> list:
    """(BN module, its input) for every BatchNorm in one call of step."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0].detach().clone())))
        for m in st.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    return seen


def phase_bce_timing(dev, card: str) -> tuple:
    """The BCE+Dice train step in both BN lanes at the workload's 512^2
    bs6 and at bench.py's train half (224^2 bs128): ms and img/s in
    alternating pairs, the device busy share, the BN layers' share
    (their forward + backward alone on the inputs the step gives them);
    and channel_sums against its plain version, the ATen BN reductions
    and its bound, per launch at the stem, a layer3 BN and the decoder
    top (device time with the L2 flushed before each call) and summed
    over one 512^2 step's 92 calls (back to back, as the step's BN
    inputs follow each other), in device time (the profiler's kernel
    durations) and in wall time (CUDA events); one CUDA kernel a call and
    no memset, from CUDA graphs of one call and of the 92. Returns the
    decoder top's (dy, x) row: (ms, plain ms, library ms, bound ms,
    bound_by)."""
    from cartseg_tpu_torch.ops.channel_sums import (channel_sums,
                                                    channel_sums_plain)
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.workloads.train_bce_dice import CONFIG

    bn_inputs = None
    for hw, bs in ((S, TRAIN_BS), BENCH_TRAIN):
        cfg = apply_cli_overrides(CONFIG, ["--device", "cuda", "--img_size",
                                           str(hw), "--batch_size", str(bs)])
        if hw == S:
            imgs, masks = bce_batch(hw, bs, dev)
        else:                                     # bench.py:81-85
            r = np.random.default_rng(0)
            imgs = torch.from_numpy(r.integers(0, 255, (bs, hw, hw, 3),
                                               np.uint8)).to(dev)
            masks = torch.from_numpy((r.random((bs, hw, hw, 1)) > 0.7)
                                     .astype(np.float32)).to(dev)
        sw = torch.ones(bs, device=dev)
        steps = {}
        for lane in BN_LANES:
            tr = Trainer(cfg, bn_lane=lane)
            st = tr.init_state()
            gids = tr.group_ids(st)
            steps[lane] = (tr, st, (lambda tr=tr, st=st, gids=gids:
                                    tr.train_step(st, imgs, masks, sw,
                                                  [1e-4] * 3, [1.0] * 3,
                                                  gids)))
        reps = 20 if hw == S else 8
        for lane in BN_LANES:
            cuda_ms(steps[lane][2], 3)            # warm-up, cuDNN autotune
        t1 = cuda_ms(steps["torch"][2], reps)
        k1 = cuda_ms(steps["channel_sums"][2], reps)
        k2 = cuda_ms(steps["channel_sums"][2], reps)
        t2 = cuda_ms(steps["torch"][2], reps)
        for lane, (a, b) in (("torch", (t1, t2)),
                             ("channel_sums", (k1, k2))):
            tr, st, step = steps[lane]
            busy = _busy_share(step, 3)
            seen = _bn_inputs(st, step)
            gen = torch.Generator(device="cpu").manual_seed(SEED)
            cots = [torch.randn(x.shape, generator=gen).to(x.dtype).to(dev)
                    .contiguous(memory_format=torch.channels_last)
                    for _, x in seen]

            def bns(seen=seen, cots=cots):
                for (m, x), g in zip(seen, cots):
                    xi = x.requires_grad_(True)
                    y = m(xi)
                    torch.autograd.grad(y, (xi, m.weight, m.bias), g)

            step_dev, bn_dev = device_ms(step, 2), device_ms(bns, 2)
            ms = (a + b) / 2
            log(f"  train step resnet34-UNet bs{bs}@{hw}^2 (bf16 autocast, "
                f"train_512, BCE+Dice, AdamW), {lane} lane: {a:.3f}/{b:.3f} "
                f"ms, {bs * 1000.0 / ms:.2f} img/s; device time of a step "
                f"{step_dev:.3f} ms, of its {len(seen)} BN layers' forward "
                f"+ backward (run alone on the step's inputs) {bn_dev:.3f} "
                f"ms, share {bn_dev / step_dev:.4f}; device busy share "
                f"{busy:.4f} [{card}]")
            if hw == S and lane == "channel_sums":
                bn_inputs = (seen, cots)
        del steps
    build.reset_launch_counts()

    # channel_sums at the path's inputs: every BN of one 512^2 bs6 step
    seen, cots = bn_inputs
    if len(seen) != BCE_BN_LAYERS:
        raise AssertionError(f"{len(seen)} BN inputs captured")
    calls = []
    for (m, x), g in zip(seen, cots):
        x = x.detach()
        mean, invstd = torch.batch_norm_stats(x, m.eps)
        w = m.weight.detach()
        calls.append(((x, x, True),
                      lambda x=x, m=m: torch.batch_norm_stats(x, m.eps)))
        calls.append(((g, x, False),
                      lambda g=g, x=x, mean=mean, invstd=invstd, w=w:
                      torch.batch_norm_backward_reduce(
                          g, x, mean, invstd, w, True, True, True)))
    top = seen[-1][1]
    cl = top.is_contiguous(memory_format=torch.channels_last)
    log(f"  channel_sums inputs from one step: {len(calls)} calls, "
        f"{top.dtype}, channels_last {cl}; the decoder top "
        f"{tuple(top.shape)}")

    def each(fn_of):
        return lambda: [fn_of(c) for c in calls]

    kern = each(lambda c: channel_sums(c[0][0], c[0][1]))
    plain = each(lambda c: channel_sums_plain(c[0][0], c[0][1]))
    lib = each(lambda c: c[1]())
    p1, k1, l1, k2, p2 = (cuda_ms(plain, 3), cuda_ms(kern, 10),
                          cuda_ms(lib, 10), cuda_ms(kern, 10),
                          cuda_ms(plain, 3))
    kd, pd, ld = (device_ms(kern, 3, "sums_"), device_ms(plain, 3),
                  device_ms(lib, 3))
    bound = sum(sums_bound(*c[0])[0] for c in calls)
    # one CUDA kernel a call and no memset: a CUDA graph of the 92 calls
    nodes = graph_nodes(kern)
    kinds = {k: sum(1 for kind, _ in nodes if kind == k)
             for k in {kind for kind, _ in nodes}}
    if kinds != {"KERNEL": len(calls)} or not all(
            "sums_nhwc" in n for _, n in nodes):
        raise AssertionError(f"channel_sums, {len(calls)} calls: the graph "
                             f"holds {kinds}; want {len(calls)} sums_nhwc "
                             f"kernels and nothing else")
    log(f"  channel_sums, the {len(calls)} calls of one step, wall (CUDA "
        f"events, the host's enqueueing included): kernel {k1:.4f}/{k2:.4f} "
        f"ms, plain {p1:.4f}/{p2:.4f} ms, batch_norm_stats + "
        f"batch_norm_backward_reduce {l1:.4f} ms; device time (profiler): "
        f"kernel {kd:.4f} ms, plain {pd:.4f} ms, ATen {ld:.4f} ms; bound "
        f"{bound:.5f} ms (bytes), kernel's device time at "
        f"{bound / kd:.3f} of it; {len(calls)} CUDA kernels in a graph of "
        f"the {len(calls)} calls, no memset [{card}]")

    # per launch at three of the path's inputs: the stem, a layer3 BN and
    # the decoder top, forward (x, x) and backward (dy, x)
    picks = {"stem": 0, "layer3": next(
        i for i, (_, x) in enumerate(seen) if x.shape[1] == 256),
        "decoder top": len(seen) - 1}
    per = {}
    for name, i in picks.items():
        for what, c in (("(x, x)", calls[2 * i]), ("(dy, x)",
                                                   calls[2 * i + 1])):
            a, b, same = c[0]

            def kern1(a=a, b=b):
                return channel_sums(a, b)

            def plain1(a=a, b=b):
                return channel_sums_plain(a, b)

            ka, la, kb = cuda_ms(kern1, 50), cuda_ms(c[1], 50), cuda_ms(
                kern1, 50)
            kd1, kd2 = (device_ms(kern1, 20, "sums_", cold=True),
                        device_ms(kern1, 20, "sums_", cold=True))
            kw = device_ms(kern1, 20, "sums_")
            pd1, ld1 = (device_ms(plain1, 5, cold=True),
                        device_ms(c[1], 20, cold=True))
            names, _ = kernels_a_call(kern1, "channel_sums")
            if len(names) != 1 or "sums_nhwc" not in names[0]:
                raise AssertionError(f"channel_sums {name} {what}: ran "
                                     f"{names}; want the one sums_nhwc "
                                     "kernel")
            bnd, by = sums_bound(a, b, same)
            per[(name, what)] = ((kd1 + kd2) / 2, pd1, ld1, bnd, by)
            libname = ("batch_norm_stats" if same
                       else "batch_norm_backward_reduce")
            log(f"  channel_sums {name} {tuple(a.shape)} {what} (plan "
                f"{tuple(sums_plan(a, b))}, 1 CUDA kernel a call): device "
                f"time (profiler, L2 flushed) kernel {kd1:.5f}/{kd2:.5f} ms "
                f"(back to back {kw:.5f} ms), plain "
                f"{pd1:.5f} ms, {libname} {ld1:.5f} ms; wall per call (CUDA "
                f"events, the host's enqueueing included) kernel "
                f"{ka:.5f}/{kb:.5f} ms, {libname} {la:.5f} ms; bound "
                f"{bnd:.5f} ms ({by}), kernel's device time at "
                f"{bnd / ((kd1 + kd2) / 2):.3f} of it [{card}]")
    build.reset_launch_counts()
    return per[("decoder top", "(dy, x)")]


def flash_inputs(bnh: int, g: int, hd: int, dtype, dev) -> list:
    """q, k, v ~ N(0,1) [bnh,g*g,hd] and the rel factors 0.5*N(0,1)
    [bnh,g*g,g] (tests/test_flash_attention.py's recipe), seeded."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    S = g * g
    ts = [torch.randn((bnh, S, hd), generator=gen) for _ in range(3)]
    ts += [0.5 * torch.randn((bnh, S, g), generator=gen) for _ in range(2)]
    return [t.to(dtype).to(dev) for t in ts]


def phase_compare_flash(dev) -> dict:
    """The forward against its plain version at FLASH_CASES: the ViT-B
    global block [12,4096,64] in fp32 (flash_fwd_tf32x3, split TF32 on the
    tensor cores) and bf16 (flash_fwd_tc, tensor cores), the tests'
    [2,256,32] fp32 and a ragged [1,529,32] in bf16 and fp32; the same
    bits on a second call. Returns the max abs error per case."""
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_relpos_fwd, flash_relpos_fwd_plain)

    errs = {}
    for bnh, g, hd, dt in FLASH_CASES:
        ts = flash_inputs(bnh, g, hd, dt, dev)
        got = flash_relpos_fwd(*ts, hd ** -0.5, g)
        same = torch.equal(got, flash_relpos_fwd(*ts, hd ** -0.5, g))
        torch.cuda.synchronize()
        want = flash_relpos_fwd_plain(*ts, hd ** -0.5, g)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        if got.dtype != dt or not rel <= FLASH_TOL[dt] or not same:
            raise AssertionError(f"flash forward [{bnh},{g * g},{hd}] {dt}: "
                                 f"max abs err {err} = {rel} of max |plain|"
                                 f" (tolerance {FLASH_TOL[dt]}); the same "
                                 f"bits twice: {same}")
        log(f"  flash forward [{bnh},{g * g},{hd}] {dt}: max abs err "
            f"{err:.3e} = {rel:.3e} of max |plain| (tolerance "
            f"{FLASH_TOL[dt]}); the same bits twice")
        errs[(bnh, g, hd, dt)] = err
    return errs


def phase_compare_flash_bwd(dev) -> dict:
    """The training forward's lse against the plain logsumexp (its out
    bit-equal to the inference call's), then flash_bwd_dq and
    flash_bwd_dkv against flash_relpos_bwd_plain on the same inputs (the
    forward kernel's out and lse, a seeded dO): the ViT-B global block
    [12,4096,64] in fp32 and bf16 and the tests' [2,256,32] fp32, each of
    the five gradients as max abs error over the plain one's max |value|.
    Returns each kernel's max abs error per shape."""
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_bwd_dkv, flash_bwd_dq, flash_relpos_bwd_plain,
        flash_relpos_fwd, flash_relpos_fwd_lse_plain, row_delta)

    errs = {}
    for bnh, g, hd, dt in FLASH_CASES:
        ts = flash_inputs(bnh, g, hd, dt, dev)
        scale = hd ** -0.5
        gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
        do = torch.randn((bnh, g * g, hd), generator=gen).to(dt).to(dev)
        out, lse = flash_relpos_fwd(*ts, scale, g, with_lse=True)
        same = torch.equal(out, flash_relpos_fwd(*ts, scale, g))
        _, lse_plain = flash_relpos_fwd_lse_plain(*ts, scale, g)
        labs = float((lse - lse_plain).abs().max())
        lrel = labs / float(lse_plain.abs().max())
        # the tensor-core forward's lse: absolute, the backward's input
        tc = dt == torch.bfloat16
        lok = labs <= FLASH_LSE_TOL if tc else lrel <= 1e-5
        ltol = f"abs {FLASH_LSE_TOL}" if tc else "rel 1e-5"
        if not same or not lok:
            raise AssertionError(f"training forward [{bnh},{g * g},{hd}] {dt}"
                                 f": out equal to inference {same}, lse abs "
                                 f"err {labs}, rel {lrel}")
        delta = row_delta(out, do)
        dq, drh, drw = flash_bwd_dq(*ts, do, lse, delta, scale, g)
        dk, dv = flash_bwd_dkv(*ts, do, lse, delta, scale, g)
        again = (*flash_bwd_dq(*ts, do, lse, delta, scale, g),
                 *flash_bwd_dkv(*ts, do, lse, delta, scale, g))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b)
                   for a, b in zip((dq, drh, drw, dk, dv), again)):
            raise AssertionError(f"flash backward [{bnh},{g * g},{hd}] {dt}: "
                                 f"a second run gave other bits")
        want = flash_relpos_bwd_plain(*ts, out, lse, do, scale, g)
        names = ("dq", "dk", "dv", "drel_h", "drel_w")
        per = {}
        for name, a, b in zip(names, (dq, dk, dv, drh, drw), want):
            err = float((a.float() - b.float()).abs().max())
            rel = err / float(b.float().abs().max())
            if a.dtype != dt or not rel <= FLASH_BWD_TOL[dt]:
                raise AssertionError(
                    f"flash backward {name} [{bnh},{g * g},{hd}] {dt}: max "
                    f"abs err {err} = {rel} of max |plain| (tolerance "
                    f"{FLASH_BWD_TOL[dt]})")
            per[name] = err
            log(f"  flash backward {name} [{bnh},{g * g},{hd}] {dt}: max abs "
                f"err {err:.3e} = {rel:.3e} of max |plain| (tolerance "
                f"{FLASH_BWD_TOL[dt]})")
        log(f"  training forward [{bnh},{g * g},{hd}] {dt}: lse abs err "
            f"{labs:.3e}, rel {lrel:.3e} (tolerance {ltol}), out == the "
            f"inference call's, bit for bit; the backward's five gradients "
            f"the same bits twice")
        errs[(bnh, g, hd, dt)] = {
            "flash_bwd_dq": max(per["dq"], per["drel_h"], per["drel_w"]),
            "flash_bwd_dkv": max(per["dk"], per["dv"])}
    return errs


def phase_compare_channel_sums(dev) -> float:
    """channel_sums against channel_sums_plain at resnet34-UNet's BN
    inputs at 512^2 bs6 (SUMS_SHAPES), channels_last and contiguous,
    fp32 and bf16, (x, x) and (dy, x): each sum within SUMS_TOL of the
    per-channel sum |a| and sum |a*b|, and the same bits on a second
    call. Returns the largest absolute error."""
    from cartseg_tpu_torch.ops.channel_sums import (channel_sums,
                                                    channel_sums_plain)

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    worst = 0.0
    for name, shape in SUMS_SHAPES.items():
        x32 = (torch.randn(shape, generator=gen) * 2 + 0.5).to(dev)
        dy32 = torch.randn(shape, generator=gen).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            for fmt in (torch.channels_last, torch.contiguous_format):
                x = x32.to(dt).contiguous(memory_format=fmt)
                dy = dy32.to(dt).contiguous(memory_format=fmt)
                for what, a, b in (("(x, x)", x, x), ("(dy, x)", dy, x)):
                    got = channel_sums(a, b)
                    again = channel_sums(a, b)
                    want = channel_sums_plain(a, b)
                    af, bf = a.float(), b.float()
                    tol = (SUMS_TOL * af.abs().sum((0, 2, 3)),
                           SUMS_TOL * (af * bf).abs().sum((0, 2, 3)))
                    rel = 0.0
                    for g, w, t, h in zip(got, want, tol, again):
                        err = (g - w).abs()
                        rel = max(rel, float((err / t).max()) * SUMS_TOL)
                        worst = max(worst, float(err.max()))
                        if not bool((err <= t).all()) or \
                                not torch.equal(g, h):
                            raise AssertionError(
                                f"channel_sums {name} {tuple(shape)} {dt} "
                                f"{fmt} {what}: max abs err "
                                f"{float(err.max())}, {rel:.3e} of the sum "
                                f"of |.|, same bits twice "
                                f"{torch.equal(g, h)}")
                    log(f"  channel_sums {name} {tuple(shape)} {dt} "
                        f"{'NHWC' if fmt == torch.channels_last else 'NCHW'}"
                        f" {what}: max err {rel:.3e} of the per-channel "
                        f"sum of |.| (tolerance {SUMS_TOL}); the same bits "
                        f"on a second call")
        del x32, dy32, x, dy
    return worst


def sam_checkpoint(path: Path, cfg, norm_noise: bool = False) -> None:
    """A seeded random init of `cfg` in the official naming (torch's
    default init, rel-pos tables 0.3*N(0,1), pos_embed 0.1*N(0,1)) with
    the mask-prompt path's keys added, saved as a .pth. `norm_noise`
    also draws the LayerNorms' weights as 1 + 0.1*N(0,1) and biases as
    0.02*N(0,1): after the neck's last LayerNorm at weight 1 and bias 0,
    mean(feats^2) is var/(var+eps), about 1 whatever the input, and its
    gradient is rounding noise."""
    from cartseg_tpu_torch.models.sam import (MASK_DOWNSCALING_PREFIX,
                                              LayerNorm2d, Sam)

    torch.manual_seed(SEED)
    model = Sam(cfg)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                prm.normal_(0.0, 0.3)
            elif name.endswith("pos_embed"):
                prm.normal_(0.0, 0.1)
        for m in model.modules():
            if norm_noise and isinstance(m, (torch.nn.LayerNorm,
                                              LayerNorm2d)):
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0.0, 0.02)
    sd = model.state_dict()
    mic, pd = cfg.mask_in_chans, cfg.prompt_dim
    for i, shape in ((0, (mic // 4, 1, 2, 2)), (1, (mic // 4,)),
                     (3, (mic, mic // 4, 2, 2)), (4, (mic,)),
                     (6, (pd, mic, 1, 1))):
        sd[f"{MASK_DOWNSCALING_PREFIX}{i}.weight"] = 0.02 * torch.randn(shape)
        sd[f"{MASK_DOWNSCALING_PREFIX}{i}.bias"] = torch.zeros(shape[0])
    torch.save(sd, path)


def sam_requests(h: int, w: int) -> list:
    """The annotation tool's prompt kinds on an h x w frame: a click,
    clicks with a negative one, a box, a box with a click, multimask on
    and off; the last one asks for logits."""
    def xy(*pts):
        return np.array([[fx * w, fy * h] for fx, fy in pts], np.float32)

    box = np.array([0.2 * w, 0.25 * h, 0.75 * w, 0.8 * h], np.float32)
    return [
        dict(point_coords=xy((0.5, 0.5)), point_labels=np.array([1]),
             multimask_output=True),
        dict(point_coords=xy((0.45, 0.5), (0.55, 0.45), (0.1, 0.9)),
             point_labels=np.array([1, 1, 0]), multimask_output=True),
        dict(point_coords=xy((0.5, 0.5), (0.9, 0.1)),
             point_labels=np.array([1, 0]), multimask_output=False),
        dict(box=box, multimask_output=False),
        dict(box=box, multimask_output=True),
        dict(point_coords=xy((0.5, 0.5)), point_labels=np.array([1]),
             box=box, multimask_output=False),
        dict(point_coords=xy((0.5, 0.5), (0.3, 0.7)),
             point_labels=np.array([1, 0]), box=box, multimask_output=True,
             return_logits=True),
    ]


def phase_sam(tmp: Path, dev) -> tuple:
    """The SAM ViT-B predictor through tools/annotate.load_sam: a seeded
    official-named checkpoint, three 1024^2 frames (create_testset's
    display size, no resize) and one 512^2 frame (create_hard_masks',
    resized to 1024^2), set_image and 7 predict requests on each."""
    from cartseg_tpu_torch.device import set_fp32_policy
    from cartseg_tpu_torch.models.sam import SamConfig
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.tools.annotate import load_sam
    from cartseg_tpu_torch.utils.synthetic import frame

    set_fp32_policy()
    ckpt = tmp / "sam_vit_b_seed0.pth"
    t0 = time.perf_counter()
    sam_checkpoint(ckpt, SamConfig())
    log(f"  seeded ViT-B checkpoint, official names + mask_downscaling: "
        f"{ckpt.stat().st_size / 1e6:.1f} MB in "
        f"{time.perf_counter() - t0:.1f} s")
    r = np.random.default_rng(SEED)
    frames = [frame(r, hw) for hw in SAM_FRAMES]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    pred = load_sam(ckpt, device="cuda")
    n_req, fg = 0, []
    for img in frames:
        pred.set_image(img)
        h, w = img.shape[:2]
        for req in sam_requests(h, w):
            masks, iou, _ = pred.predict(**req)
            n = 3 if req["multimask_output"] else 1
            logits = req.get("return_logits", False)
            if (masks.shape != (n, h, w) or iou.shape != (n,)
                    or masks.dtype != (np.float32 if logits else bool)
                    or not np.isfinite(iou).all()
                    or (logits and not np.isfinite(masks).all())):
                raise AssertionError(f"predict {req} on {h}x{w}: masks "
                                     f"{masks.shape} {masks.dtype}, iou "
                                     f"{iou}")
            if not logits:
                fg.append(float(masks.mean()))
            n_req += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want = SAM_GLOBAL_BLOCKS * len(frames)
    log(f"  predictor: {len(frames)} set_image ({SAM_FRAMES}) and {n_req} "
        f"predict requests in {wall:.1f} s wall (load and first-call "
        f"warm-up included); masks at frame size, bool, IoU finite; mask "
        f"fg share {min(fg):.3f}..{max(fg):.3f}; launches {launches}")
    if launches["flash_fwd"] != want:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']} "
                             f"times for {len(frames)} set_image, want "
                             f"{want}")

    # .features injection, as the prefetch thread hands the embedding over
    img = frames[0]
    req = sam_requests(*img.shape[:2])[-1]
    pred.set_image(img)
    feats, hw = pred.features, (pred._orig_hw, pred._input_hw)
    want_m, want_i, _ = pred.predict(**req)
    pred.set_image(frames[-1])
    pred.features = feats
    pred._orig_hw, pred._input_hw = hw
    got_m, got_i, _ = pred.predict(**req)
    err = max(float(np.abs(got_m - want_m).max()),
              float(np.abs(got_i - want_i).max()))
    if err > 1e-5:
        raise AssertionError(f"injected features: predict differs by {err}")
    log(f"  .features injection: the same predict (max abs diff {err:.1e})")
    return launches, pred, frames


def phase_sam_reference(tmp: Path, pred, frames, dev) -> None:
    """ViT-B embedding on the card, flash lane against the plain lane,
    fp32 with TF32 off; then a small config (img 256, one global block
    on the kernel) on the card against the CPU's plain lanes."""
    from cartseg_tpu_torch.models.sam import SamConfig, ViTAttention
    from cartseg_tpu_torch.tools.annotate import load_sam
    from cartseg_tpu_torch.utils.synthetic import frame

    img = frames[0]
    f_flash = pred.set_image(img).clone()
    attns = [m for m in pred.model.modules()
             if isinstance(m, ViTAttention) and m.use_flash]
    for m in attns:
        m.use_flash = False
    try:
        f_plain = pred.set_image(img).clone()
    finally:
        for m in attns:
            m.use_flash = True
    rel = float((f_flash - f_plain).abs().max() / f_plain.abs().max())
    if len(attns) != SAM_GLOBAL_BLOCKS or not rel <= 1e-4:
        raise AssertionError(f"ViT-B embedding, flash vs plain lane: rel "
                             f"max err {rel} over {len(attns)} blocks")
    log(f"  ViT-B embedding [1,64,64,256], flash lane vs plain lane on the "
        f"card (fp32, TF32 off): rel max err {rel:.3e} (limit 1e-4)")

    cfg = SamConfig(img_size=256, encoder_dim=64, encoder_depth=2,
                    encoder_heads=2, global_attn_indexes=(1,), window_size=6,
                    prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64,
                    global_attn_flash=True)
    ckpt = tmp / "sam_small.pth"
    sam_checkpoint(ckpt, cfg)
    small = frame(np.random.default_rng(SEED + 1), (192, 256))
    req = sam_requests(192, 256)[-1]
    outs = {}
    for d in ("cpu", dev):
        p = load_sam(ckpt, device=d, cfg=cfg)
        f = p.set_image(small).float().cpu()
        m, iou, _ = p.predict(**req)
        outs[str(d)] = (f, m, iou)
    (fc, mc, ic), (fg, mg, ig) = outs["cpu"], outs[str(dev)]
    ferr = float((fg - fc).abs().max())
    merr, ierr = float(np.abs(mg - mc).max()), float(np.abs(ig - ic).max())
    if ferr > 1e-4 or merr > 1e-3 or ierr > 1e-4:
        raise AssertionError(f"small SAM card vs CPU: features {ferr}, "
                             f"logits {merr}, iou {ierr}")
    log(f"  small SAM (img 256) card vs CPU: features max err {ferr:.2e}, "
        f"logits {merr:.2e}, iou {ierr:.2e}")


def sam_train_model(ckpt: Path, flash: bool, dtype, dev):
    """ViT-B `Sam(cfg, dtype)` with the official-named checkpoint loaded
    by name (strict), on `dev`."""
    from cartseg_tpu_torch.models.sam import (Sam, SamConfig,
                                              strip_mask_downscaling)

    sd = torch.load(ckpt, map_location="cpu", weights_only=True)
    model = Sam(SamConfig(global_attn_flash=flash), dtype=dtype)
    model.load_state_dict(strip_mask_downscaling(sd))
    return model.to(dev)


def sam_step(model, x: torch.Tensor) -> torch.Tensor:
    """One fine-tune step (benchmarks/sam_train_bench.py:46-63): the loss
    mean(feats^2) of encode_image(preprocess(x)) and its backward into
    every encoder parameter's .grad."""
    model.zero_grad(set_to_none=True)
    feats = model.encode_image(model.preprocess(x))
    loss = (feats.float() ** 2).mean()
    loss.backward()
    return loss.detach()


def encoder_grads(model) -> dict:
    return {k: p.grad for k, p in model.named_parameters()
            if k.startswith("image_encoder.")}


def phase_sam_train(tmp: Path, dev) -> dict:
    """The ViT-B encoder fine-tune step, bf16 compute, flash lane, 3 steps
    on one 1024^2 frame; then the flash lane against the plain lane on
    the same weights in fp32 (TF32 off) and in bf16."""
    from cartseg_tpu_torch.device import set_fp32_policy
    from cartseg_tpu_torch.models.sam import SamConfig
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.utils.synthetic import frame

    set_fp32_policy()
    cfg = SamConfig()
    ckpt = tmp / "sam_vit_b_train_seed0.pth"
    sam_checkpoint(ckpt, cfg, norm_noise=True)
    img = frame(np.random.default_rng(SEED + 2), (cfg.img_size,) * 2)
    x = torch.from_numpy(img[None]).to(dev)
    t0 = time.perf_counter()
    model = sam_train_model(ckpt, True, torch.bfloat16, dev)
    build.reset_launch_counts()
    losses, per_step = [], []
    for _ in range(SAM_TRAIN_STEPS):
        before = dict(build.LAUNCHES)
        losses.append(float(sam_step(model, x)))
        per_step.append({k: build.LAUNCHES[k] - before[k]
                         for k in SAM_TRAIN_KERNELS})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    want = {k: SAM_GLOBAL_BLOCKS for k in SAM_TRAIN_KERNELS}
    if any(p != want for p in per_step):
        raise AssertionError(f"launches per step {per_step}, want {want}")
    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    grads = encoder_grads(model)
    bad = [k for k, g in grads.items() if g is None
           or not bool(torch.isfinite(g).all()) or not bool(g.any())]
    others = [k for k, p in model.named_parameters()
              if not k.startswith("image_encoder.") and p.grad is not None]
    if bad or others:
        raise AssertionError(f"encoder grads missing, non-finite or zero: "
                             f"{bad}; grads outside the encoder: {others}")
    log(f"  fine-tune step (ViT-B 1024^2, bf16 compute, fp32 params, flash "
        f"lane): {SAM_TRAIN_STEPS} steps in {wall:.1f} s wall (load and "
        f"first-call warm-up included); losses {losses}; launches per step "
        f"{per_step[0]} (total {launches}); all {len(grads)} encoder "
        f"parameters have finite non-zero gradients, the prompt encoder "
        f"and decoder none")

    # the same weights through the plain lane (global_attn_flash=False);
    # the fp32 flash lane's step counts its launches: the split-TF32
    # backward kernels and the fp32 forward, 4 each
    lanes = {}
    for dt in (torch.float32, torch.bfloat16):
        for flash in (True, False):
            m = model if (flash and dt == torch.bfloat16) else \
                sam_train_model(ckpt, flash, dt, dev)
            build.reset_launch_counts()
            loss = float(sam_step(m, x))
            torch.cuda.synchronize()
            if flash and dt == torch.float32:
                f32_launches = dict(build.LAUNCHES)
            lanes[(dt, flash)] = (loss, {k: g.float().clone() for k, g in
                                         encoder_grads(m).items()})
    want = {k: SAM_GLOBAL_BLOCKS for k in F32_STEP_KERNELS}
    got = {k: f32_launches[k] for k in F32_STEP_KERNELS}
    if got != want:
        raise AssertionError(f"fp32 flash-lane step launches {got}, want "
                             f"{want}")
    log(f"  fp32 flash-lane step: launches {got} (fp32 forward, split-TF32 "
        f"backward kernels)")
    (lf, gf), (lp, gp) = lanes[(torch.float32, True)], lanes[
        (torch.float32, False)]
    rel = {k: float((gf[k] - gp[k]).norm() / gp[k].norm()) for k in gp}
    worst = max(rel, key=rel.get)
    lrel = abs(lf - lp) / abs(lp)
    if not rel[worst] <= 1e-4 or not lrel <= 1e-5:
        raise AssertionError(f"fp32 flash vs plain lane: loss {lf} vs {lp}, "
                             f"worst gradient rel L2 {rel[worst]} ({worst})")
    log(f"  fp32 (TF32 off) flash lane vs plain lane: loss {lf:.7f} vs "
        f"{lp:.7f} (rel {lrel:.2e}, limit 1e-5); worst per-parameter "
        f"gradient rel L2 {rel[worst]:.3e} ({worst}; limit 1e-4), median "
        f"{float(np.median(list(rel.values()))):.3e}")
    (bf, gbf), (bp, gbp) = lanes[(torch.bfloat16, True)], lanes[
        (torch.bfloat16, False)]
    sf = sum(float(g.abs().sum()) for g in gbf.values())
    sp = sum(float(g.abs().sum()) for g in gbp.values())
    brel = abs(bf - bp) / abs(bp)
    if not brel <= 1e-3 or not abs(sf - sp) <= 0.05 * sp:
        raise AssertionError(f"bf16 flash vs plain lane: loss {bf} vs {bp}, "
                             f"sum |grad| {sf} vs {sp}")
    log(f"  bf16 flash lane vs plain lane: loss {bf:.7f} vs {bp:.7f} (rel "
        f"{brel:.2e}, limit 1e-3); sum |grad| {sf:.6f} vs {sp:.6f} "
        f"({abs(sf - sp) / sp:.4f} apart, limit 0.05)")
    return {"launches": launches, "f32_launches": f32_launches,
            "model": model, "x": x, "ckpt": ckpt}


def profile_naming(fn, symbols, what: str) -> dict:
    """The device kernels and copies of one call of fn by name, ms summed
    over their launches (profiler), which must name a kernel holding each
    of `symbols`; logs its top kernels and those kernels. The profiler
    can drop a kernel's events, so a profile that misses one is taken
    again (kernel_trace, at most PROFILE_TRIES windows)."""
    def found_in(trace):
        return {sym: sorted((us / 1e3, n) for n, (_, us) in trace.items()
                            if sym in n) for sym in symbols}

    trace = kernel_trace(fn, keep=lambda t: t and all(found_in(t).values()))
    ops = {name: us / 1e3 for name, (_, us) in trace.items()}
    found = found_in(trace)
    if not all(found.values()):
        # the profiler lost them: the kernels of a CUDA graph of the call
        # (graph_nodes), where fn can be captured, must name them instead
        lost = [k for k, v in found.items() if not v]
        try:
            kernels = [n for kind, n in graph_nodes(fn) if kind == "KERNEL"]
        except Exception as e:   # capture refused: nothing to read
            kernels = [f"no CUDA graph ({type(e).__name__}: {e})"]
        missing = [k for k in lost if not any(k in n for n in kernels)]
        if missing:
            raise AssertionError(f"{what}'s profile names no {lost} kernel "
                                 f"in {PROFILE_TRIES} windows, the last "
                                 f"holding {sorted(ops)[:20]}; a CUDA graph "
                                 f"of the call names no {missing} in "
                                 f"{kernels[:40]}")
        log(f"  {what}: the profiler lost {lost} in {PROFILE_TRIES} "
            f"windows; a CUDA graph of the call names "
            + "; ".join(n for n in kernels if any(k in n for k in lost)))
    rows = sorted(ops.items(), key=lambda r: -r[1])[:8]
    total = sum(ops.values())
    log(f"  {what} device time by kernel (profiler, one call, {total:.3f} "
        f"ms of kernels and copies): " + "; ".join(
            f"{name[:70]} {ms:.3f}" for name, ms in rows))
    if symbols:
        log(f"  {', '.join(symbols)} in {what}'s profile: " + "; ".join(
            f"{n[:60]} {ms:.3f} ms" for hits in found.values()
            for ms, n in hits))
    return ops


def bwd_f64_distances(ts, do, scale: float, g: int, lanes: dict,
                      heads: int) -> dict:
    """Each backward gradient's (dq, dk, dv, drel_h, drel_w) max abs
    distance over the float64 gradient's max |value|, on the first
    `heads` heads: the exact backward of softmax(scale q k^T + bias) v in
    float64 from the same inputs and dO."""
    d = torch.float64
    q, k, v, rh, rw = (t[:heads].to(d) for t in ts)
    do = do[:heads].to(d)
    bnh, S, _ = q.shape
    bias = (rh[:, :, :, None] + rw[:, :, None, :]).reshape(bnh, S, S)
    p = torch.softmax(q @ k.transpose(1, 2) * scale + bias, dim=-1)
    ds = p * (do @ v.transpose(1, 2)
              - (do * (p @ v)).sum(-1, keepdim=True))
    ds4 = ds.reshape(bnh, S, g, g)
    ref = (ds @ k * scale, ds.transpose(1, 2) @ q * scale,
           p.transpose(1, 2) @ do, ds4.sum(-1), ds4.sum(-2))
    return {lane: [float((a[:heads].double() - r).abs().max()
                         / r.abs().max()) for a, r in zip(grads, ref)]
            for lane, grads in lanes.items()}


def phase_sam_timing(pred, frames, dev, card: str) -> dict:
    """set_image and predict on the card, the global blocks' share of
    set_image, set_image's profile (which must name the split-TF32
    forward, flash_fwd_tf32x3), and flash_fwd against its plain version
    and F.scaled_dot_product_attention at the inputs the path gives it."""
    from cartseg_tpu_torch.ops import flash_attention as fa
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_relpos_fwd, flash_relpos_fwd_plain)

    policy = (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    img = frames[0]
    set_ms = [cuda_ms(lambda: pred.set_image(img), 10) for _ in range(2)]
    busy = _busy_share(lambda: pred.set_image(img), 3)
    reqs = sam_requests(*img.shape[:2])
    pred.set_image(img)
    for req in reqs:
        pred.predict(**req)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        for req in reqs:
            pred.predict(**req)
    pred_ms = (time.perf_counter() - t0) * 1e3 / (3 * len(reqs))
    profile_naming(lambda: pred.set_image(img), (F32_FWD_SYMBOL,),
                   "set_image")
    profile_naming(lambda: pred.predict(**reqs[-1]), (), "predict")

    # the global blocks on the inputs set_image gives them, and the
    # kernel's arguments from the first of them
    blocks = pred.model.image_encoder.blocks
    inputs, flash_args = {}, []
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args, i=i: inputs.__setitem__(i, args[0].clone()))
        for i, blk in enumerate(blocks) if blk.window_size == 0]
    real = fa.flash_attention_relpos

    def capture(*a, **kw):
        flash_args.append((a, kw))
        return real(*a, **kw)

    fa.flash_attention_relpos = capture
    try:
        pred.set_image(img)
    finally:
        fa.flash_attention_relpos = real
        for h in hooks:
            h.remove()
    with torch.inference_mode():
        glob_ms = sum(cuda_ms(lambda: blocks[i](x), 10)
                      for i, x in inputs.items())
    set_mean = sum(set_ms) / 2
    log(f"  set_image 1024^2 fp32 ViT-B ({policy}): {set_ms[0]:.3f}/"
        f"{set_ms[1]:.3f} ms, {1000.0 / set_mean:.2f} img/s; the "
        f"{len(inputs)} global blocks {glob_ms:.3f} ms, share "
        f"{glob_ms / set_mean:.4f}; device busy share {busy:.4f}; predict "
        f"{pred_ms:.3f} ms per request (host clock, 7 kinds, masks back "
        f"on the host) [{card}]")

    (q, k, v, rh, rw), kw = flash_args[0]
    scale, g = kw["scale"], kw["grid_size"]
    bnh, S, _ = q.shape
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        ts = [t.to(dt).contiguous() for t in (q, k, v, rh, rw)]
        bias = (ts[3][:, :, :, None] + ts[4][:, :, None, :]).reshape(
            bnh, S, S)

        def kern():
            return flash_relpos_fwd(*ts, scale, g)

        def plain():
            return flash_relpos_fwd_plain(*ts, scale, g)

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                ts[0], ts[1], ts[2], attn_mask=bias, scale=scale)

        lerr = float((lib().float() - plain().float()).abs().max())
        p1 = cuda_ms(plain, 5)
        k1 = cuda_ms(kern, 20)
        l1 = cuda_ms(lib, 20)
        k2 = cuda_ms(kern, 20)
        p2 = cuda_ms(plain, 5)
        b, by = flash_bound(ts[0], ts[3])
        out[dt] = ((k1 + k2) / 2, (p1 + p2) / 2, l1, b, by)
        core = ("" if dt == torch.bfloat16 else
                f" (split TF32, {TF32_TERMS} TF32 products a product; fp32 "
                f"on the CUDA cores {fwd_cuda_core_ms(ts[0]):.5f} ms)")
        log(f"  flash_fwd [{bnh},{S},{q.shape[2]}] {dt} (the path's "
            f"inputs): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
            f"{p2:.4f} ms, F.scaled_dot_product_attention with the bias "
            f"built beforehand {l1:.4f} ms (max abs diff to plain "
            f"{lerr:.2e}); bound {b:.5f} ms ({by}){core}, kernel at "
            f"{b / ((k1 + k2) / 2):.3f} of it [{card}]")
    build.reset_launch_counts()
    return {"set_image_ms": set_mean, "predict_ms": pred_ms,
            "flash": out}


def phase_sam_train_timing(train: dict, dev, card: str) -> dict:
    """The fine-tune step for the flash and the plain lane in bf16, the
    global blocks' share of it, the device's busy share, its profile
    (which must name the three tensor-core kernels); the same step in
    fp32 for both lanes, its busy share and its profile (which must name
    the split-TF32 backward kernels); the bf16 training forward
    (flash_fwd_tc) and flash_bwd_dq / flash_bwd_dkv against their plain
    versions and the library calls at the inputs the step gives them, the
    backward in bf16 and fp32, each with its distance to a float64
    gradient."""
    import torch.nn.functional as F

    from cartseg_tpu_torch.ops import flash_attention as fa
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
        flash_relpos_bwd_plain, flash_relpos_fwd, flash_relpos_fwd_lse_plain,
        row_delta)

    model, x = train["model"], train["x"]
    plain = sam_train_model(train["ckpt"], False, torch.bfloat16, dev)
    for m in (model, plain):
        cuda_ms(lambda: sam_step(m, x), 2)        # warm-up
    f1 = cuda_ms(lambda: sam_step(model, x), 5)
    p1 = cuda_ms(lambda: sam_step(plain, x), 5)
    p2 = cuda_ms(lambda: sam_step(plain, x), 5)
    f2 = cuda_ms(lambda: sam_step(model, x), 5)
    step_ms, plain_ms = (f1 + f2) / 2, (p1 + p2) / 2
    busy = _busy_share(lambda: sam_step(model, x), 3)
    profile_naming(lambda: sam_step(model, x), TC_SYMBOLS,
                   "the bf16 fine-tune step")

    # the fp32 step (the model's default compute type, TF32 off): flash
    # lane against plain lane in alternating pairs, the busy share, and a
    # profile that must name the split-TF32 forward and backward kernels
    f32 = {flash: sam_train_model(train["ckpt"], flash, torch.float32, dev)
           for flash in (True, False)}
    for m in f32.values():
        cuda_ms(lambda: sam_step(m, x), 2)        # warm-up
    g1 = cuda_ms(lambda: sam_step(f32[True], x), 3)
    q1 = cuda_ms(lambda: sam_step(f32[False], x), 3)
    q2 = cuda_ms(lambda: sam_step(f32[False], x), 3)
    g2 = cuda_ms(lambda: sam_step(f32[True], x), 3)
    busy32 = _busy_share(lambda: sam_step(f32[True], x), 3)
    profile_naming(lambda: sam_step(f32[True], x), F32_SYMBOLS,
                   "the fp32 fine-tune step")
    f32_ms, f32_plain_ms = (g1 + g2) / 2, (q1 + q2) / 2
    log(f"  fine-tune step ViT-B 1024^2 fp32 (TF32 off) batch 1: flash lane "
        f"{g1:.3f}/{g2:.3f} ms, plain lane {q1:.3f}/{q2:.3f} ms; device "
        f"busy share {busy32:.4f} (flash lane) [{card}]")
    del f32

    # the global blocks' inputs, and the flash call's arguments and output
    # gradient in the first of them
    blocks = model.image_encoder.blocks
    inputs, caught = {}, {}
    hooks = [blk.register_forward_pre_hook(
        lambda mod, args, i=i: inputs.__setitem__(i, args[0].detach()))
        for i, blk in enumerate(blocks) if blk.window_size == 0]
    real = fa.flash_attention_relpos

    def capture(*a, **kw):
        out = real(*a, **kw)
        if "args" not in caught:
            caught["args"] = ([t.detach() for t in a], kw)
            out.register_hook(lambda gr: caught.setdefault("do", gr))
        return out

    fa.flash_attention_relpos = capture
    try:
        sam_step(model, x)
    finally:
        fa.flash_attention_relpos = real
        for h in hooks:
            h.remove()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    cots = {i: (1e-3 * torch.randn(t.shape, generator=gen)).to(t.dtype).to(
        dev) for i, t in inputs.items()}

    def global_blocks():
        for i, t in inputs.items():
            blocks[i](t.requires_grad_(True)).backward(cots[i])

    glob_ms = cuda_ms(global_blocks, 5)
    log(f"  fine-tune step ViT-B 1024^2 bf16 batch 1: flash lane "
        f"{f1:.3f}/{f2:.3f} ms, plain lane (global_attn_flash=False) "
        f"{p1:.3f}/{p2:.3f} ms; the {len(inputs)} global blocks' forward + "
        f"backward {glob_ms:.3f} ms, share {glob_ms / step_ms:.4f}; device "
        f"busy share {busy:.4f} [{card}]")

    (q, k, v, rh, rw), kw = caught["args"]
    scale, g = kw["scale"], kw["grid_size"]
    bnh, S, hd = q.shape
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        ts = [t.to(dt).contiguous() for t in (q, k, v, rh, rw)]
        do = caught["do"].to(dt).contiguous()
        o, lse = flash_relpos_fwd(*ts, scale, g, with_lse=True)
        delta = row_delta(o, do)
        args = (*ts, do, lse, delta, scale, g)
        # library: autograd of SDPA with the (bnh,S,S) bias materialised
        # and requiring grad, then dbias summed into drel_h and drel_w
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in ts[:3])
        bias = (ts[3][:, :, :, None] + ts[4][:, :, None, :]).reshape(
            bnh, S, S).requires_grad_(True)
        lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=bias,
                                            scale=scale)

        def lib():
            gq, gk, gv, gb = torch.autograd.grad(lo, (lq, lk, lv, bias), do,
                                                 retain_graph=True)
            gb = gb.reshape(bnh, S, g, g)
            return gq, gk, gv, gb.sum(-1), gb.sum(-2)

        ref = flash_relpos_bwd_plain(*ts, o, lse, do, scale, g)
        lerr = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(lib(), ref))
        if dt == torch.bfloat16:
            # the training forward, with lse, as the step calls it
            fbias = bias.detach()

            def fwd():
                return flash_relpos_fwd(*ts, scale, g, with_lse=True)

            def fwd_plain():
                return flash_relpos_fwd_lse_plain(*ts, scale, g)

            def fwd_lib():
                return F.scaled_dot_product_attention(
                    ts[0], ts[1], ts[2], attn_mask=fbias, scale=scale)

            pa = cuda_ms(fwd_plain, 3)
            ka = cuda_ms(fwd, 20)
            la = cuda_ms(fwd_lib, 20)
            kb = cuda_ms(fwd, 20)
            pb = cuda_ms(fwd_plain, 3)
            b, by = flash_bound(ts[0], ts[3])
            fwd_row = ((ka + kb) / 2, (pa + pb) / 2, la, b, by)
            log(f"  flash_fwd_tc [{bnh},{S},{hd}] bf16 (the step's inputs, "
                f"with lse): kernel {ka:.4f}/{kb:.4f} ms, plain {pa:.4f}/"
                f"{pb:.4f} ms, F.scaled_dot_product_attention with the bias "
                f"built beforehand {la:.4f} ms; bound {b:.5f} ms ({by}), "
                f"kernel at {b / fwd_row[0]:.3f} of it [{card}]")
        (dq, drh, drw), (dk, dv) = (flash_bwd_dq(*args),
                                    flash_bwd_dkv(*args))
        dist = bwd_f64_distances(ts, do, scale, g, {
            "kernels": (dq, dk, dv, drh, drw), "plain": ref,
            "SDPA autograd": lib()}, heads=4)
        log(f"  {dt} backward at the step's inputs, heads 0-3: max abs "
            f"distance to the float64 gradient over its max |value| "
            f"(dq, dk, dv, drel_h, drel_w): " + "; ".join(
                f"{lane} " + ", ".join(f"{e:.2e}" for e in errs)
                for lane, errs in dist.items()))
        cases = {"flash_bwd_dq": (lambda: flash_bwd_dq(*args),
                                  lambda: flash_bwd_dq_plain(*args)),
                 "flash_bwd_dkv": (lambda: flash_bwd_dkv(*args),
                                   lambda: flash_bwd_dkv_plain(*args))}
        l1 = cuda_ms(lib, 10)
        res = {}
        for name, (kern, pln) in cases.items():
            pa = cuda_ms(pln, 3)
            ka = cuda_ms(kern, 10)
            kb = cuda_ms(kern, 10)
            pb = cuda_ms(pln, 3)
            b, by = bwd_bound(ts[0], ts[3], name)
            res[name] = ((ka + kb) / 2, (pa + pb) / 2, l1, b, by)
            core = ("" if dt == torch.bfloat16 else
                    f" (split TF32, {TF32_TERMS} TF32 products a product; "
                    f"fp32 on the CUDA cores "
                    f"{bwd_cuda_core_ms(ts[0], name):.5f} ms)")
            log(f"  {name} [{bnh},{S},{hd}] {dt} (the step's inputs): kernel "
                f"{ka:.4f}/{kb:.4f} ms, plain {pa:.4f}/{pb:.4f} ms; bound "
                f"{b:.5f} ms ({by}){core}, kernel at "
                f"{b / ((ka + kb) / 2):.3f} of it [{card}]")
        log(f"  library for both: autograd of F.scaled_dot_product_attention"
            f" with the (bnh,S,S) bias materialised and requiring grad, plus "
            f"the two sums of dbias into drel_h and drel_w: {l1:.4f} ms "
            f"(max abs diff to plain {lerr:.2e}); kernels dq + dkv "
            f"{res['flash_bwd_dq'][0] + res['flash_bwd_dkv'][0]:.4f} ms "
            f"[{card}]")
        out[dt] = res
    build.reset_launch_counts()
    return {"step_ms": step_ms, "plain_ms": plain_ms, "kernels": out,
            "fwd": fwd_row, "f32_step_ms": f32_ms,
            "f32_plain_ms": f32_plain_ms, "f32_busy": busy32}


# ------------------------------------------------------------ the loss zoo

def zoo_bound(name: str, n_bytes: int, n_elems: int) -> tuple:
    """The larger of the bytes (each input read once, each output
    written once) at the HBM rate and ZOO_FLOPS[name] float32 operations
    an element at the CUDA-core peak."""
    t_bytes, _ = bytes_bound(n_bytes)
    t_ops = ZOO_FLOPS[name] * n_elems / PEAK_FLOPS[torch.float32] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def elem_inputs(shape, dev, seed: int) -> tuple:
    """Logits ~ 3 N(0,1) and {0,1} targets of `shape`, seeded."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 3
    y = (torch.rand(shape, generator=gen) > 0.5).float()
    return x.to(dev), y.to(dev)


def act_inputs(shape, dev, seed: int) -> tuple:
    """An activation input ~ 3 N(0,1) and its upstream gradient ~ N(0,1)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return ((torch.randn(shape, generator=gen) * 3).to(dev),
            torch.randn(shape, generator=gen).to(dev))


def dice_inputs(dev) -> tuple:
    """[6, 512*512] logits and blob-mask labels (the trainers' logits
    flattened per sample); the last sample has no foreground."""
    from cartseg_tpu_torch.utils.synthetic import blob_masks

    B = DICE_SHAPE[0]
    m = blob_masks(np.random.default_rng(SEED), DICE_SHAPE[:3], n=3)
    m = torch.from_numpy(m.reshape(B, -1).astype(np.float32))
    m[-1] = 0.0
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    x = torch.randn(m.shape, generator=gen) * 2 + (2 * m - 1) * 1.5
    return x.to(dev), m.to(dev)


def one_hot_labels(dev, dtype=torch.int64) -> torch.Tensor:
    """[6,262144] labels in 0..7, every 7th the ignore index 255."""
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    lab = torch.randint(0, ONE_HOT_C, ONE_HOT_SHAPE, generator=gen)
    lab.view(-1)[::7] = ONE_HOT_IGNORE
    return lab.to(dtype).to(dev)


def check_rel(name: str, got: torch.Tensor, want: torch.Tensor,
              tol: float) -> float:
    """Max abs error within tol of the plain output's max |value|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not rel <= tol:
        raise AssertionError(f"{name}: max abs err {err} = {rel} of max "
                             f"|plain| (tolerance {tol})")
    log(f"  {name}: max abs err {err:.3e} = {rel:.3e} of max |plain| "
        f"(tolerance {tol})")
    return err


def phase_compare_zoo(dev) -> dict:
    """The loss zoo's kernels against their plain versions at the path
    shapes: focal (loss and gradient) at [6,512,512,1] and [20,224,224,1];
    soft-Dice's sums at [6,512,512,1] for p = 1 and 2, twice for the same
    bits; the smoothed one-hot at [6,262144] C = 8, ignore 255, int64 and
    int32 labels, bit for bit; each activation forward and g * f'
    backward at [6,512,512,16] and [12288,2048] (hswish bit for bit).
    Returns each kernel's largest absolute error."""
    from cartseg_tpu_torch.ops.cuda.activations import (act_bwd,
                                                        act_bwd_plain,
                                                        act_fwd,
                                                        act_fwd_plain)
    from cartseg_tpu_torch.ops.cuda.focal import focal_fwd, focal_plain
    from cartseg_tpu_torch.ops.cuda.one_hot import one_hot, one_hot_plain
    from cartseg_tpu_torch.ops.cuda.soft_dice import (soft_dice_sums,
                                                      soft_dice_sums_plain)

    errs, e = {}, []
    for i, shape in enumerate(FOCAL_SHAPES):
        x, y = elem_inputs(shape, dev, SEED + i)
        # gamma 2 at both shapes; at the first, the other exponent routes
        # (gamma 1; 1.5 by powf) and the scalar route (4 bytes past a
        # 16-byte boundary)
        cases = [(2.0, x, y, "")]
        if i == 0:
            cases += [(1.0, x, y, ""), (1.5, x, y, ""),
                      (2.0, x.view(-1)[1:], y.view(-1)[1:], " unaligned")]
        for gamma, xs, ys, tag in cases:
            got = focal_fwd(xs, ys, gamma, 0.25)
            want = focal_plain(xs, ys, gamma, 0.25)
            for what, a, b in zip(("loss", "grad"), got, want):
                e.append(check_rel(f"focal {what} {list(shape)} gamma "
                                   f"{gamma}{tag}", a, b, ELEM_TOL))
    errs["focal"] = max(e)

    x, y = dice_inputs(dev)
    B, M = x.shape
    # the path's [6, 262144] at p = 1, 2 and 1.5 (powf); at p = 2 the
    # scalar route, [6, 262143] 4 bytes past a 16-byte boundary
    ragged = (x.view(-1)[1:1 + B * (M - 1)].view(B, M - 1),
              y.view(-1)[1:1 + B * (M - 1)].view(B, M - 1))
    e = []
    for pexp, (xs, ys) in ((1.0, (x, y)), (2.0, (x, y)), (1.5, (x, y)),
                           (2.0, ragged)):
        got, again = soft_dice_sums(xs, ys, pexp), soft_dice_sums(xs, ys,
                                                                  pexp)
        want = soft_dice_sums_plain(xs, ys, pexp)
        torch.cuda.synchronize()
        for what, a, b, h in zip(("numer", "denor"), got, want, again):
            err = (a - b).abs()
            rel = float((err / b.abs().clamp(min=1e-30)).max())
            if not bool((err <= DICE_TOL * b.abs()).all()) or \
                    not torch.equal(a, h):
                raise AssertionError(
                    f"soft_dice p={pexp} {what} {list(xs.shape)}: max rel "
                    f"err {rel} (tolerance {DICE_TOL}), same bits twice "
                    f"{torch.equal(a, h)}")
            e.append(float(err.max()))
            log(f"  soft_dice p={pexp} {what} {list(xs.shape)}: max rel "
                f"err {rel:.3e} (tolerance {DICE_TOL}); the same bits on a "
                f"second call")
    errs["soft_dice"] = max(e)

    for dt in (torch.int64, torch.int32):
        lab = one_hot_labels(dev, dt)
        check_equal(f"one_hot {list(ONE_HOT_SHAPE)} C={ONE_HOT_C} {dt}",
                    one_hot(lab, ONE_HOT_C, 0.1, ONE_HOT_IGNORE),
                    one_hot_plain(lab, ONE_HOT_C, 0.1, ONE_HOT_IGNORE))
    errs["one_hot"] = 0.0

    for kind in ACT_KINDS:
        ef, eb = [], []
        for i, shape in enumerate(ACT_SHAPES):
            x, g = act_inputs(shape, dev, SEED + i)
            cases = ((ef, f"{kind} forward {list(shape)}", act_fwd(x, kind),
                      act_fwd_plain(x, kind)),
                     (eb, f"{kind} backward {list(shape)}",
                      act_bwd(x, g, kind), act_bwd_plain(x, g, kind)))
            for acc, name, got, want in cases:
                acc.append(check_equal(name, got, want) if kind == "hswish"
                           else check_rel(name, got, want, ELEM_TOL))
            del x, g, cases
        errs[f"{kind}_fwd"], errs[f"{kind}_bwd"] = max(ef), max(eb)
    return errs


def zoo_tensors(bhw, focal2, act2, dev, seed: int) -> dict:
    """The loss zoo's inputs: logits x [B,H,W,1] and blob-mask targets y,
    class logits z [B,H,W,8] and labels lab (every 7th ignored), an
    activation input a [B,H,W,16] with LayerNorm's weight w and bias b,
    and the second focal (x2, y2) and activation (a2) shapes."""
    from cartseg_tpu_torch.utils.synthetic import blob_masks

    B, H, W = bhw
    m = blob_masks(np.random.default_rng(seed), bhw, n=3)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.from_numpy(m[..., None].astype(np.float32))
    t = {"y": y,
         "x": torch.randn(y.shape, generator=gen) * 2 + (2 * y - 1) * 1.5,
         "z": torch.randn((B, H, W, ONE_HOT_C), generator=gen) * 2,
         "lab": torch.randint(0, ONE_HOT_C, (B, H, W), generator=gen),
         "a": torch.randn((B, H, W, 16), generator=gen) * 3,
         "w": 1 + 0.1 * torch.randn(16, generator=gen),
         "b": 0.1 * torch.randn(16, generator=gen),
         "x2": torch.randn(focal2, generator=gen) * 3,
         "y2": (torch.rand(focal2, generator=gen) > 0.5).float(),
         "a2": torch.randn(act2, generator=gen) * 3}
    t["lab"].view(-1)[::7] = ONE_HOT_IGNORE
    return {k: v.to(dev) for k, v in t.items()}


def zoo_calls() -> tuple:
    """(name, the input whose gradient is taken or None, fn(tensors)) for
    every name cartseg_tpu_torch.losses gained with the loss zoo."""
    import cartseg_tpu_torch.losses as TL

    C, ign = ONE_HOT_C, ONE_HOT_IGNORE
    acts = tuple((f"{k} {w}", key, lambda t, k=k, key=key:
                  getattr(TL, k)(t[key]))
                 for k in ACT_KINDS for w, key in (("nhwc", "a"),
                                                   ("flat", "a2")))
    return (
        ("focal_loss_kernel", "x", lambda t: TL.focal_loss_kernel(
            t["x"], t["y"])),
        ("focal_loss_kernel focal-Dice", "x2", lambda t:
         TL.focal_loss_kernel(t["x2"], t["y2"])),
        ("soft_dice_loss p=1", "x", lambda t: TL.soft_dice_loss(
            t["x"], t["y"], 1.0)),
        ("soft_dice_loss p=2", "x", lambda t: TL.soft_dice_loss(
            t["x"], t["y"], 2.0)),
        ("smooth_one_hot", None, lambda t: TL.smooth_one_hot(
            t["lab"].reshape(t["lab"].shape[0], -1), C, 0.1, ign)),
    ) + acts + (
        ("lsr_cross_entropy_fused", "z", lambda t:
         TL.lsr_cross_entropy_fused(t["z"], t["lab"], 0.1, ign)),
        ("taylor_softmax", "z", lambda t: TL.taylor_softmax(t["z"], 2)),
        ("log_taylor_softmax", "z", lambda t: TL.log_taylor_softmax(
            t["z"], 2)),
        ("taylor_cross_entropy", "z", lambda t: TL.taylor_cross_entropy(
            t["z"], t["lab"], 2, 0.1, ign)),
        ("ohem_labels", None, lambda t: TL.ohem_labels(
            t["z"], t["lab"], 0.7, 16, ign)),
        ("lovasz_softmax", "z", lambda t: TL.lovasz_softmax(
            t["z"], t["lab"], ignore_index=ign)),
        ("lovasz_hinge", "x", lambda t: TL.lovasz_hinge(
            t["x"][..., 0], t["y"][..., 0])),
        ("large_margin_softmax", "z", lambda t: TL.large_margin_softmax(
            t["z"], t["lab"], 0.3, ign)),
        ("layer_norm", "a", lambda t: TL.layer_norm(t["a"], t["w"],
                                                    t["b"])),
        ("signed_distance_map", None, lambda t: TL.signed_distance_map(
            t["y"][0, ..., 0])),
        ("symmetric_boundary_loss", "x", lambda t:
         TL.symmetric_boundary_loss(t["x"], t["y"])),
        ("composite_seg_loss", "x", lambda t: TL.composite_seg_loss(
            t["x"], t["y"])),
    )


def run_zoo(t: dict, calls) -> dict:
    """name -> (output, gradient of sum(output^2) w.r.t. its input, or
    None) for each call on the tensors t."""
    res = {}
    for name, key, fn in calls:
        ts = dict(t)
        if key is not None:
            ts[key] = t[key].detach().clone().requires_grad_(True)
        out = fn(ts)
        grad = None
        if key is not None:
            (out.float() ** 2).sum().backward()
            grad = ts[key].grad
        res[name] = (out.detach(), grad)
    return res


def phase_loss_zoo(dev) -> dict:
    """The loss zoo through cartseg_tpu_torch.losses on the card: every
    name the zoo gained, at the path shapes, with a backward where it has
    a gradient; the launch counts set to 0 just before and read just
    after, and every zoo kernel (and the EDT and LSR kernels its boundary
    and LSR losses reach) launched. Then the same calls on the card
    against the CPU (the plain versions) at a small size."""
    from cartseg_tpu_torch.ops.cuda import build

    calls = zoo_calls()
    t = zoo_tensors((TRAIN_BS, S, S), FOCAL_SHAPES[1], ACT_SHAPES[1], dev,
                    SEED)
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_zoo(t, calls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for name, (out, grad) in res.items():
        bad = [u for u in (out, grad) if u is not None and
               u.is_floating_point() and not bool(torch.isfinite(u).all())]
        if bad:
            raise AssertionError(f"{name}: non-finite output or gradient")
    log(f"  {len(res)} calls at the path shapes in {wall:.2f} s wall: "
        + "; ".join(f"{n} {list(o.shape)}{' + grad' if g is not None else ''}"
                    for n, (o, g) in res.items()))
    log(f"  launches {launches}")
    missing = [k for k in ZOO_KERNELS + ("edt", "lsr_fwd", "lsr_bwd")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"not launched by the loss zoo: {missing}")
    del t, res

    small = zoo_tensors((2, 32, 32), (4, 32, 32, 1), (64, 128), "cpu",
                        SEED + 7)
    want = run_zoo(small, calls)
    got = run_zoo({k: v.to(dev) for k, v in small.items()}, calls)
    rtol, atol = ZOO_REF_TOL
    worst = 0.0
    for name, (o, g) in got.items():
        for a, b in ((o, want[name][0]), (g, want[name][1])):
            if a is None:
                continue
            a = a.cpu()
            if not a.is_floating_point():
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: card != CPU")
                continue
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                       msg=lambda m, n=name: f"{n}: {m}")
            worst = max(worst, float(((a - b).abs() / (atol + rtol * b.abs())
                                      ).max()))
    log(f"  the zoo on the card against the CPU at [2,32,32]: {len(got)} "
        f"calls, values and gradients within rtol {rtol}, atol {atol} "
        f"(worst {worst:.3f} of the bound), integer outputs equal")
    build.reset_launch_counts()
    return launches


def phase_boundary_workload(tmp: Path, dev, ir: Path, mr: Path) -> dict:
    """workloads/train_with_boundary_loss through its CLI at its CONFIG
    (effnet-b0 UNet, bs6, 512^2, bf16, ImageNet norm, train_512, BCE+Dice
    + 0.3 SDF boundary loss, encoder frozen), 2 epochs on 4b's tree: the
    `prf1` CSV, history, .pth, sidecar and .last.pth, the .pth loading
    into the pseudo-labeller; edt launched at least 4 times a step (the
    GT's and the prediction's SDF, inside and outside) and no other
    kernel."""
    from cartseg_tpu_torch.infer.engine import load_member
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train.engine import SCHEMAS
    from cartseg_tpu_torch.workloads import train_with_boundary_loss as cli

    out = tmp / "run_boundary"
    build.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(["--images_root", str(ir), "--masks_root", str(mr),
                       "--out_dir", str(out), "--epochs", "2",
                       "--device", "cuda"], log=lambda m: log(f"    {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    steps = result["state"].step
    others = {k: v for k, v in launches.items() if k != "edt" and v}
    log(f"  boundary workload: {steps} steps, 2 epochs in {wall:.1f} s wall "
        f"(init, PNG decode, val and the sweep included); edt launches "
        f"{launches['edt']} ({launches['edt'] / max(steps, 1):.2f} a train "
        f"step, validation included); launches {launches}")
    if steps <= 0 or launches["edt"] < 4 * steps or others:
        raise AssertionError(f"boundary workload: {steps} steps, edt "
                             f"{launches['edt']}, others {others}")
    rows = check_train_outputs(out, SCHEMAS["prf1"])
    if any(float(r[1]) != 0.0 for r in rows[1:]):
        raise AssertionError(f"the encoder was not frozen: {rows[1:]}")
    hist = json.loads((out / "history.json").read_text())
    member = load_member(out / "model.pth", device=dev)
    if abs(member.threshold - result["threshold"]) > 1e-9:
        raise AssertionError("the .pth did not load with the sweep's "
                             "threshold")
    log(f"  boundary outputs: prf1 CSV {rows[1:]}, history "
        f"({len(hist)} epochs), .pth + sidecar (threshold "
        f"{member.threshold:.2f}) + .last.pth; the .pth loads into the "
        "pseudo-labeller")
    build.reset_launch_counts()
    return {"launches": launches, "steps": steps}


def phase_zoo_timing(dev, card: str) -> dict:
    """Each zoo kernel at the path shapes: device time (the profiler's
    kernel durations, these calls being short) with the L2 flushed before
    each call, against its plain version and, where one PyTorch call
    computes the same function, that call; the kernel's device time back
    to back (warm L2) and its wall time per call (CUDA events); its
    bound. Returns name -> (ms, plain ms, library ms or None, bound ms,
    bound_by), cold, at the first path shape."""
    import torch.nn.functional as F

    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.activations import (act_bwd,
                                                        act_bwd_plain,
                                                        act_fwd,
                                                        act_fwd_plain)
    from cartseg_tpu_torch.ops.cuda.focal import focal_fwd, focal_plain
    from cartseg_tpu_torch.ops.cuda.one_hot import one_hot, one_hot_plain
    from cartseg_tpu_torch.ops.cuda.soft_dice import (soft_dice_sums,
                                                      soft_dice_sums_plain)

    rows = {}

    def measure(name, label, kern, plain, match, bound, lib=None,
                lib_name=""):
        k1 = device_ms(kern, 20, match, cold=True)
        p1 = device_ms(plain, 5, cold=True)
        k2 = device_ms(kern, 20, match, cold=True)
        ld = device_ms(lib, 20, cold=True) if lib is not None else None
        kw = device_ms(kern, 20, match)
        wk, wp = cuda_ms(kern, 20), cuda_ms(plain, 5)
        ms = (k1 + k2) / 2
        lib_txt = (f", {lib_name} {ld:.5f} ms" if lib is not None
                   else ", no single PyTorch call")
        log(f"  {name} {label}: device time (profiler, L2 flushed) kernel "
            f"{k1:.5f}/{k2:.5f} ms, plain {p1:.5f} ms{lib_txt}; kernel back "
            f"to back {kw:.5f} ms; wall per call (CUDA events) kernel "
            f"{wk:.5f} ms, plain {wp:.5f} ms; bound {bound[0]:.5f} ms "
            f"({bound[1]}), kernel at {bound[0] / ms:.3f} of it [{card}]")
        rows.setdefault(name, (ms, p1, ld, bound[0], bound[1]))

    def one_kernel(name, label, call, symbol):
        """One CUDA kernel a call, `symbol`, and no memset (a CUDA graph
        of the call)."""
        names, _ = kernels_a_call(call, name)
        if len(names) != 1 or symbol not in names[0]:
            raise AssertionError(f"a {name} call {label} ran {names}; want "
                                 f"one {symbol} kernel")
        log(f"  {name} {label}: one CUDA kernel a call ({names[0]}), no "
            f"memset")

    for i, shape in enumerate(FOCAL_SHAPES):
        x, y = elem_inputs(shape, dev, SEED + i)
        measure("focal", str(list(shape)),
                lambda: focal_fwd(x, y, 2.0, 0.25),
                lambda: focal_plain(x, y, 2.0, 0.25), "focal",
                zoo_bound("focal", 4 * nbytes(x), x.numel()))
        one_kernel("focal", str(list(shape)),
                   lambda: focal_fwd(x, y, 2.0, 0.25), "focal_fwd_bwd")
    x, y = dice_inputs(dev)
    for pexp in (1.0, 2.0):
        measure("soft_dice", f"{list(DICE_SHAPE)} p={pexp}",
                lambda: soft_dice_sums(x, y, pexp),
                lambda: soft_dice_sums_plain(x, y, pexp), "dice_",
                zoo_bound("soft_dice", nbytes(x, y) + 2 * x.shape[0] * 4,
                          x.numel()))
        one_kernel("soft_dice", f"{list(DICE_SHAPE)} p={pexp}",
                   lambda: soft_dice_sums(x, y, pexp), "dice_sums")
    lab = one_hot_labels(dev)
    out = one_hot(lab, ONE_HOT_C, 0.1, ONE_HOT_IGNORE)
    measure("one_hot", f"{list(ONE_HOT_SHAPE)} C={ONE_HOT_C} int64",
            lambda: one_hot(lab, ONE_HOT_C, 0.1, ONE_HOT_IGNORE),
            lambda: one_hot_plain(lab, ONE_HOT_C, 0.1, ONE_HOT_IGNORE),
            "one_hot", zoo_bound("one_hot", nbytes(lab, out), lab.numel()))
    del x, y, lab, out
    libs = {"mish": (F.mish, torch.ops.aten.mish_backward, "mish"),
            "swish": (F.silu, torch.ops.aten.silu_backward, "silu"),
            "hswish": (F.hardswish, torch.ops.aten.hardswish_backward,
                       "hardswish")}
    for kind in ACT_KINDS:
        fwd_lib, bwd_lib, aten = libs[kind]
        for i, shape in enumerate(ACT_SHAPES):
            x, g = act_inputs(shape, dev, SEED + i)
            n = x.numel()
            measure(f"{kind}_fwd", str(list(shape)),
                    lambda: act_fwd(x, kind), lambda: act_fwd_plain(x, kind),
                    "act_fwd", zoo_bound(f"{kind}_fwd", 2 * nbytes(x), n),
                    lambda: fwd_lib(x), f"F.{aten}")
            measure(f"{kind}_bwd", str(list(shape)),
                    lambda: act_bwd(x, g, kind),
                    lambda: act_bwd_plain(x, g, kind), "act_bwd",
                    zoo_bound(f"{kind}_bwd", 3 * nbytes(x), n),
                    lambda: bwd_lib(g, x), f"aten.{aten}_backward")
            xr = x.detach().requires_grad_(True)

            def lib_both():
                fwd_lib(xr).backward(g)

            log(f"  {kind} {list(shape)}: F.{aten} forward + "
                f"backward under autograd, device time (L2 flushed) "
                f"{device_ms(lib_both, 10, cold=True):.5f} ms [{card}]")
            del x, g, xr
    # each forward and backward against its PyTorch call in ACT_PAIRS
    # alternating pairs (kernel first in the even pairs, the library in the
    # odd), L2 flushed before each call: medians, and the spread of each
    # series as (max - min) / median
    x, gr = act_inputs(ACT_SHAPES[0], dev, SEED)
    for kind in ACT_KINDS:
        fwd_lib, bwd_lib, aten = libs[kind]
        for d, kern, lib, lib_name in (
                ("fwd", lambda: act_fwd(x, kind), lambda: fwd_lib(x),
                 f"F.{aten}"),
                ("bwd", lambda: act_bwd(x, gr, kind),
                 lambda: bwd_lib(gr, x), f"aten.{aten}_backward")):
            k_ms, l_ms, spread = cold_pairs(kern, lib, f"act_{d}")
            gap = (k_ms - l_ms) / l_ms
            form = (f" (the kernel computes {MISH_FWD_FORM})"
                    if f"{kind}_{d}" == "mish_fwd" else "")
            log(f"  {kind}_{d}{form} {list(ACT_SHAPES[0])} vs {lib_name}, "
                f"{ACT_PAIRS} alternating cold-L2 pairs: median kernel "
                f"{k_ms:.5f} ms, library {l_ms:.5f} ms, the kernel "
                f"{gap:+.4f} relative; spread {spread:.4f}; loses by more "
                f"than the spread: {gap > spread} [{card}]")
    del x, gr
    build.reset_launch_counts()
    return rows


def phase_boundary_timing(dev, card: str) -> dict:
    """The boundary workload's train step at its CONFIG (bs6@512^2,
    device-resident batch, the freeze phase's learning rates) against the
    same step with BCE+Dice alone, in alternating pairs; its device busy
    share and its edt launches."""
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train import LossSpec, Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame
    from cartseg_tpu_torch.workloads.train_with_boundary_loss import CONFIG

    r = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([frame(r, (S, S))
                                      for _ in range(TRAIN_BS)])).to(dev)
    masks = torch.from_numpy(blob_masks(r, (TRAIN_BS, S, S), n=3)[..., None]
                             .astype(np.float32)).to(dev)
    sw = torch.ones(TRAIN_BS, device=dev)
    cfg = apply_cli_overrides(CONFIG, ["--device", "cuda"])
    steps = {}
    for name, loss in (("boundary", CONFIG.loss),
                       ("bce_dice", LossSpec("bce_dice",
                                             {"bce_weight": 0.5}))):
        tr = Trainer(cfg.with_overrides(loss=loss))
        st = tr.init_state()
        gids = tr.group_ids(st)
        steps[name] = (lambda tr=tr, st=st, gids=gids: tr.train_step(
            st, imgs, masks, sw, [0.0, 1e-4, 1e-4], [0.0, 1.0, 1.0], gids))
    for fn in steps.values():
        cuda_ms(fn, 3)                            # warm-up, cuDNN autotune
    a1 = cuda_ms(steps["boundary"], 20)
    b1 = cuda_ms(steps["bce_dice"], 20)
    b2 = cuda_ms(steps["bce_dice"], 20)
    a2 = cuda_ms(steps["boundary"], 20)
    busy = _busy_share(steps["boundary"], 5)
    build.reset_launch_counts()
    steps["boundary"]()
    torch.cuda.synchronize()
    edt_per_step = build.LAUNCHES["edt"]
    step_ms, bce_ms = (a1 + a2) / 2, (b1 + b2) / 2
    log(f"  boundary train step bs{TRAIN_BS}@{S}^2 (effnet-b0 UNet, bf16 "
        f"autocast, train_512, BCE+Dice + 0.3 SDF boundary, encoder frozen, "
        f"AdamW): {a1:.3f}/{a2:.3f} ms, {TRAIN_BS * 1000.0 / step_ms:.2f} "
        f"img/s; the same step with BCE+Dice alone {b1:.3f}/{b2:.3f} ms; "
        f"boundary share {(step_ms - bce_ms) / step_ms:.4f}; device busy "
        f"share {busy:.4f}; edt launches a step {edt_per_step} [{card}]")
    if edt_per_step != 4:
        raise AssertionError(f"{edt_per_step} edt launches in a boundary "
                             "step, want 4")
    # the EDT on the SDF's inputs: the step's masks and their complement
    from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, edt_batch_plain

    edt_ms = 0.0
    for what, m in (("mask", masks[..., 0] > 0.5),
                    ("complement", masks[..., 0] <= 0.5)):
        m = m.contiguous()
        check_equal(f"edt on the SDF's {what} [6,512,512]", edt_batch_jfa(m),
                    edt_batch_plain(m))
        p1 = cuda_ms(lambda: edt_batch_plain(m), 5)
        k1 = cuda_ms(lambda: edt_batch_jfa(m), 20)
        k2 = cuda_ms(lambda: edt_batch_jfa(m), 20)
        p2 = cuda_ms(lambda: edt_batch_plain(m), 5)
        b, by = edt_bound(m)
        names, _ = kernels_a_call(lambda: edt_batch_jfa(m), "edt")
        edt_ms += (k1 + k2) / 2
        log(f"  edt on the SDF's {what}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms, {len(names)} CUDA kernels a call; bound "
            f"{b:.5f} ms ({by}), kernel at {2 * b / (k1 + k2):.3f} of it "
            f"[{card}]")
    log(f"  the step's 4 EDTs ~{2 * edt_ms:.4f} ms, {2 * edt_ms / step_ms:.4f}"
        f" of the step [{card}]")
    build.reset_launch_counts()
    return {"step_ms": step_ms, "bce_ms": bce_ms, "busy": busy}


# ------------------------------------------- camera JPEGs without OpenCV

FIXTURES = Path(__file__).resolve().parent / "cartseg_tpu_torch" / \
    "tools" / "jpeg_fixtures"
# nvJPEG against cv2's stored decode: the mean |d| of a fixture, in LSB
JPEG_MEAN_TOL = 1.0
# the fixtures a training tree cycles through: those whose letterboxed
# mask fits them (not the EXIF-rotated frame)
TRAIN_JPEGS = tuple(f"frame_{k}" for k in range(8)) + (
    "frame_0_444", "frame_1_progressive", "frame_3_gray")
# the four workloads phase 4h runs at their CONFIG for one epoch, with
# their CSV schemas
CONFIG_WORKLOADS = (("train_with_focal_dice", "prf1"),
                    ("train_with_focal_dice_unfrozen", "prf1"),
                    ("train_pseudo", "basic"),
                    ("train_bce_dice_abl_unlettered", "abl"))
# decodes a rate is taken over, and the loader's threads
JPEG_RATE_N, LOADER_THREADS = 200, 4


class refuse_modules:
    """A context in which `import cv2` (and PIL) fails and
    importlib.util.find_spec finds nothing, as on a machine without
    them: each name maps to None in sys.modules for the context's
    length."""

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.saved = {k: v for k, v in sys.modules.items()
                      if k.split(".")[0] in self.names}
        for k in self.saved:
            del sys.modules[k]
        for n in self.names:
            sys.modules[n] = None
        import importlib.util

        for n in self.names:
            if importlib.util.find_spec(n) is not None:
                raise AssertionError(f"{n} is still importable")
        return self

    def __exit__(self, *exc):
        for n in self.names:
            sys.modules.pop(n, None)
        sys.modules.update(self.saved)
        return False


def jpeg_against_cv2(dev) -> dict:
    """nvJPEG's decode of every fixture against cv2's stored decode: the
    shape (the EXIF-rotated frame's too), max and mean |d|; fails above a
    mean of JPEG_MEAN_TOL."""
    from cartseg_tpu_torch.utils import image_io

    worst = 0.0
    names = sorted(p.name for p in FIXTURES.glob("*.jpeg"))
    pairs = [(n, False, n.replace(".jpeg", ".cv2.png")) for n in names]
    pairs.append(("frame_0.jpeg", True, "frame_0.cv2gray.png"))
    for name, gray, stored in pairs:
        read = image_io.read_gray if gray else image_io.read_rgb
        got = read(FIXTURES / name, dev)
        want = image_io.decode_png((FIXTURES / stored).read_bytes())
        if got.shape != want.shape:
            raise AssertionError(f"{name}: nvJPEG shape {got.shape}, cv2 "
                                 f"{want.shape}")
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        log(f"  nvJPEG {name}{' (luma)' if gray else ''} {got.shape}: max "
            f"|d| {d.max()}, mean |d| {d.mean():.4f} LSB against cv2")
        if d.mean() > JPEG_MEAN_TOL:
            raise AssertionError(f"{name}: mean |d| {d.mean():.4f} > "
                                 f"{JPEG_MEAN_TOL}")
        worst = max(worst, float(d.mean()))
    return {"worst_mean": worst, "files": len(pairs)}


def make_jpeg_tree(tmp: Path) -> tuple:
    """TRAIN_SESSIONS x TRAIN_PER_SESSION camera JPEGs cycled from the
    fixtures, with their letterboxed masks (side padding 0.1), and the
    same masks unlettered (no side padding) for the unlettered ABL run."""
    from cartseg_tpu_torch import geometry as G
    from cartseg_tpu_torch.utils import image_io

    root = tmp / "jpeg_train"
    masks = {}
    for stem in TRAIN_JPEGS:
        k = stem.split("_")[1]
        lettered = image_io.decode_png(
            (FIXTURES / f"frame_{k}.mask.png").read_bytes())
        x0, y0, x1, y1 = G.LetterboxSpec(1280, 720).content_box()
        plain = G.letterbox_side_pad(lettered[y0:y1, x0:x1],
                                     side_padding_ratio=0.0)
        masks[stem] = (image_io.encode_png(lettered),
                       image_io.encode_png(plain))
    i = 0
    for s in range(TRAIN_SESSIONS):
        sess = f"session_{s:03d}"
        for sub in ("images", "masks", "masks_unlettered"):
            (root / sub / sess).mkdir(parents=True, exist_ok=True)
        for _ in range(TRAIN_PER_SESSION):
            stem = TRAIN_JPEGS[i % len(TRAIN_JPEGS)]
            name = f"img_{i:03d}"
            (root / "images" / sess / f"{name}.jpeg").write_bytes(
                (FIXTURES / f"{stem}.jpeg").read_bytes())
            (root / "masks" / sess / f"{name}.png").write_bytes(
                masks[stem][0])
            (root / "masks_unlettered" / sess / f"{name}.png").write_bytes(
                masks[stem][1])
            i += 1
    log(f"  JPEG training tree: {TRAIN_SESSIONS}x{TRAIN_PER_SESSION} "
        f"1280x720 JPEGs ({len(TRAIN_JPEGS)} fixtures cycled) with masks")
    return root / "images", root / "masks", root / "masks_unlettered"


def imagenet_encoder_file(path: Path) -> dict:
    """A seeded timm-named efficientnet_b0 state dict as an ImageNet
    checkpoint holds it: the encoder (BN statistics drawn away from 0/1),
    the BN counters and the classifier (conv_head, bn2, classifier)."""
    from cartseg_tpu_torch.models import build_model

    torch.manual_seed(SEED + 16)
    enc = build_model("efficientnet-b0").encoder
    g = torch.Generator().manual_seed(SEED + 17)
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith("running_mean"):
            v = 0.1 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            v = 0.75 + 0.5 * torch.rand(v.shape, generator=g)
        sd[k] = v.clone()
    for k, shape in (("conv_head.weight", (1280, 320, 1, 1)),
                     ("bn2.weight", (1280,)), ("bn2.bias", (1280,)),
                     ("bn2.running_mean", (1280,)),
                     ("bn2.running_var", (1280,)),
                     ("classifier.weight", (1000, 1280)),
                     ("classifier.bias", (1000,))):
        sd[k] = torch.randn(shape, generator=g)
    sd["bn2.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, path)
    return sd


def check_train_run(out: Path, schema: list, epochs: int) -> list:
    """The CSV (header, one finite row an epoch), history, .pth, sidecar
    and .last.pth of a run; returns the CSV rows."""
    with open(out / "training_metrics.csv") as f:
        rows = list(csv.reader(f))
    if rows[0] != schema or len(rows) != epochs + 1:
        raise AssertionError(f"{out.name}: training_metrics.csv header "
                             f"{rows[0]}, {len(rows) - 1} rows")
    if not all(np.isfinite(float(v)) for r in rows[1:] for v in r):
        raise AssertionError(f"non-finite values in the CSV: {rows[1:]}")
    for f in ("history.json", "model.pth", "model.threshold.json",
              "model.last.pth"):
        if not (out / f).exists():
            raise AssertionError(f"{out.name}: {f} was not written")
    return rows


def phase_pretrained_workload(tmp: Path, ir: Path, mr: Path) -> dict:
    """workloads/train_with_pretrained through its CLI at its CONFIG
    (efficientnet-b0, 512^2, bs6, bf16, train_512, session_sorted, prf1,
    encoder frozen 8 epochs) for 2 epochs on the JPEG tree, from a seeded
    timm-named encoder file with its classifier keys: the artifacts, and
    every encoder parameter in model.pth equal to the file's."""
    from cartseg_tpu_torch.models import build_model
    from cartseg_tpu_torch.train.engine import SCHEMAS
    from cartseg_tpu_torch.workloads import train_with_pretrained as cli

    enc_file = tmp / "efficientnet_b0_imagenet.pth"
    sd = imagenet_encoder_file(enc_file)
    out = tmp / "run_pretrained"
    t0 = time.perf_counter()
    result = cli.main(["--images_root", str(ir), "--masks_root", str(mr),
                       "--out_dir", str(out), "--epochs", "2",
                       "--device", "cuda", "--pretrained_encoder",
                       str(enc_file)], log=lambda m: log(f"    {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = check_train_run(out, SCHEMAS["prf1"], 2)
    if any(float(r[1]) != 0.0 for r in rows[1:]):
        raise AssertionError(f"the encoder was not frozen: {rows[1:]}")
    got = torch.load(out / "model.pth", map_location="cpu",
                     weights_only=True)["model_state_dict"]
    params = [n for n, _ in build_model("efficientnet-b0").named_parameters()
              if n.startswith("encoder.")]
    convs = [n for n in params if got[n].ndim == 4]
    for n in params:
        if not torch.equal(got[n], sd[n[len("encoder."):]]):
            raise AssertionError(f"{n} in model.pth differs from the "
                                 "encoder file")
    log(f"  train_with_pretrained: {result['state'].step} steps, 2 epochs "
        f"in {wall:.1f} s wall (init, nvJPEG decode, val and the sweep "
        f"included); prf1 CSV {rows[1:]}; all {len(params)} encoder "
        f"parameters ({len(convs)} conv weights) in model.pth equal the "
        "file's bit for bit (frozen)")
    return {"pth": out / "model.pth", "steps": result["state"].step}


def phase_config_workloads(tmp: Path, ir: Path, mr: Path,
                           mr_unlettered: Path) -> dict:
    """The four workloads that need only their CONFIG, through their CLI
    for 1 epoch on the JPEG tree: each CSV in its schema; the unfrozen
    run's lr_encoder / lr_head at 0.1x / 3x lr_decoder; train_pseudo on
    two image roots; the unlettered ABL run on the unlettered masks,
    launching edt, lsr_fwd and lsr_bwd (counts set to 0 just before)."""
    import importlib
    import shutil

    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train.engine import SCHEMAS

    roots = [tmp / "jpeg_root_a", tmp / "jpeg_root_b"]
    for i, sess in enumerate(sorted(ir.iterdir())):
        shutil.copytree(sess, roots[i % 2] / sess.name)
    runs = {}
    for name, schema in CONFIG_WORKLOADS:
        cli = importlib.import_module(f"cartseg_tpu_torch.workloads.{name}")
        data = (["--image_roots", ",".join(map(str, roots)),
                 "--masks_root", str(mr)] if name == "train_pseudo" else
                ["--images_root", str(ir), "--masks_root",
                 str(mr_unlettered if name.endswith("unlettered") else mr)])
        out = tmp / f"run_{name}"
        build.reset_launch_counts()
        t0 = time.perf_counter()
        result = cli.main(data + ["--out_dir", str(out), "--epochs", "1",
                                  "--device", "cuda"],
                          log=lambda m: log(f"    {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        rows = check_train_run(out, SCHEMAS[schema], 1)
        row = dict(zip(rows[0], map(float, rows[1])))
        if name == "train_with_focal_dice_unfrozen" and (
                row["phase"] != 1
                or abs(row["lr_encoder"] - 0.1 * row["lr_decoder"]) > 1e-12
                or abs(row["lr_head"] - 3.0 * row["lr_decoder"]) > 1e-12):
            raise AssertionError(f"{name}: LR tiers {row}")
        if name.endswith("unlettered") and \
                not all(launches.get(k, 0) > 0 for k in TRAIN_KERNELS):
            raise AssertionError(f"{name}: launches {launches}")
        log(f"  {name}: {result['state'].step} steps, 1 epoch in "
            f"{wall:.1f} s wall; {schema} CSV {rows[1]}; launches "
            f"{launches}")
        runs[name] = {"launches": launches, "row": row}
    build.reset_launch_counts()
    return runs


def phase_pseudo_jpeg(tmp: Path, pth: Path) -> dict:
    """workloads/create_pseudo_labels on B camera-size JPEGs (the
    fixtures cycled over 2 sessions) at --batch_size B --img_size S,
    with the pretrained run's model.pth as the three members and
    --overlay_dir: every mask, prob file and CSV row; cc, reach and
    median launched; one overlay a frame (check_overlays)."""
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.workloads import create_pseudo_labels as cli

    images = tmp / "jpeg_frames"
    names = sorted(p.name for p in FIXTURES.glob("*.jpeg"))
    for i in range(B):
        d = images / f"session_{i % 2:03d}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"cam_{i:03d}.jpeg").write_bytes(
            (FIXTURES / names[i % len(names)]).read_bytes())
    members = ",".join([str(pth)] * 3)
    out_dir = tmp / "pseudo_jpeg"
    overlays = tmp / "pseudo_jpeg_overlays"
    build.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(["--images_root", str(images), "--out_dir",
                       str(out_dir), "--checkpoints", members,
                       "--batch_size", str(B), "--img_size", str(S),
                       "--max_per_bucket", "1000", "--overlay_dir",
                       str(overlays), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    for k in PSEUDO_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the JPEG "
                                 "frames")
    log(f"  pseudo-labels on {B} 1280x720 JPEGs: {result['accepted']} "
        f"accepted, {wall:.1f} s wall (members' load included); the loop "
        f"{result['wall_s']:.3f} s, of it reading (nvJPEG) and letterboxing "
        f"{result['read_s']:.3f} s; launches {launches}")
    check_pseudo_outputs(images, out_dir, sorted(images.rglob("*.jpeg")))
    check_overlays(images, out_dir, overlays)
    build.reset_launch_counts()
    return {"images": images, "out_dir": out_dir,
            "read_s": result["read_s"], "wall_s": result["wall_s"]}


def check_overlays(images: Path, out_dir: Path, overlays: Path) -> None:
    """One <stem>_overlay_512.png a frame (accepted or uncertain), each
    the letterboxed frame with the outer contours of the frame's written
    mask drawn in red at thickness 2 (postprocess/overlay.py, cv2's
    drawing bit for bit on the CPU tests), red wherever the mask has
    foreground and nowhere else."""
    from cartseg_tpu_torch.infer.pseudo_labels import load_frame
    from cartseg_tpu_torch.postprocess.overlay import draw_external_contours
    from cartseg_tpu_torch.utils import image_io

    frames = sorted(images.rglob("*.jpeg"))
    names = sorted(p.name for p in overlays.iterdir())
    if names != sorted(f"{p.stem}_overlay_512.png" for p in frames):
        raise AssertionError(f"overlays: {len(names)} files for "
                             f"{len(frames)} frames")
    red = 0
    for p in frames:
        rel = p.relative_to(images)
        mask = next(image_io.decode_png((d / f"{p.stem}.png").read_bytes())
                    for d in (out_dir / rel.parent,
                              out_dir / "uncertain" / rel.parent)
                    if (d / f"{p.stem}.png").exists())
        got = image_io.decode_png(
            (overlays / f"{p.stem}_overlay_512.png").read_bytes())
        frame = load_frame(p, S, 0.1, "cuda")
        drawn = (got != frame).any(-1)
        if not np.array_equal(got, draw_external_contours(
                frame, mask // 255, (255, 0, 0), 2)) or \
                drawn.any() != bool(mask.any()) or \
                not (got[drawn] == (255, 0, 0)).all():
            raise AssertionError(f"overlay of {rel} is off")
        red += int(drawn.sum())
    log(f"  overlays: one a frame ({len(frames)}), each the frame with its "
        f"mask's outer contours in red ({red} pixels drawn in all), cv2 "
        f"refused")


def phase_jpeg_timing(dev, ir: Path, mr: Path, pth: Path,
                      pseudo: dict, card: str) -> None:
    """The data layer's times: the nvJPEG decode rate of a 1280x720 frame
    (one thread, and LOADER_THREADS threads as the loader runs them),
    the training loader's wall for one epoch against the train steps'
    device time, and the pseudo-label batch against its frames' read and
    letterbox."""
    from concurrent.futures import ThreadPoolExecutor

    from cartseg_tpu_torch.data.pipeline import Loader
    from cartseg_tpu_torch.infer.engine import (load_member,
                                                pseudo_label_program)
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       load_frame)
    from cartseg_tpu_torch.train.engine import Trainer, epoch_order
    from cartseg_tpu_torch.utils import image_io
    from cartseg_tpu_torch.workloads import train_with_pretrained as tw

    frame = FIXTURES / "frame_0.jpeg"
    for _ in range(5):
        image_io.read_rgb(frame, dev)
    t0 = time.perf_counter()
    for _ in range(JPEG_RATE_N):
        image_io.read_rgb(frame, dev)
    one = JPEG_RATE_N / (time.perf_counter() - t0)
    with ThreadPoolExecutor(LOADER_THREADS) as pool:
        list(pool.map(lambda _: image_io.read_rgb(frame, dev),
                      range(4 * LOADER_THREADS)))
        t0 = time.perf_counter()
        list(pool.map(lambda _: image_io.read_rgb(frame, dev),
                      range(JPEG_RATE_N)))
        many = JPEG_RATE_N / (time.perf_counter() - t0)
    log(f"  nvJPEG decode of a 1280x720 4:2:0 frame to the host, EXIF "
        f"read: {one:.1f} frames/s on one thread, {many:.1f} frames/s on "
        f"{LOADER_THREADS} threads ({card})")

    cfg = tw.CONFIG.with_overrides(images_root=str(ir), masks_root=str(mr),
                                   device="cuda", out_dir=str(ir.parent))
    tr = Trainer(cfg)
    train_ds = tr.build_datasets()[0]
    loader = Loader(train_ds, cfg.batch_size, device=dev,
                    num_threads=cfg.num_threads)
    order = epoch_order(cfg.seed, 0, len(train_ds))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = list(loader(order))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    st = tr.init_state()
    gids = tr.group_ids(st)
    imgs, masks = batches[0]
    ones = torch.ones((imgs.shape[0],), device=dev)

    def step():
        tr.train_step(st, imgs, masks, ones, [1e-4] * 3, [0.0, 1.0, 1.0],
                      gids)

    step_ms = cuda_ms(step, 10)
    n = len(batches)
    # one item's parts on one thread: the frame's read (nvJPEG), its
    # native letterbox + resize, the mask's read (PNG codec) + resize
    from cartseg_tpu_torch import native
    from cartseg_tpu_torch.data.dataset import resize_nearest

    parts = np.zeros(4)
    items = train_ds.pairs[:2 * cfg.batch_size]
    for rec in items:
        t = [time.perf_counter()]
        img = image_io.read_rgb(rec.image, dev)
        t.append(time.perf_counter())
        native.letterbox_resize(img, cfg.img_size, cfg.side_padding_ratio)
        t.append(time.perf_counter())
        m = image_io.read_gray(rec.mask, dev)
        t.append(time.perf_counter())
        resize_nearest(m, cfg.img_size)
        t.append(time.perf_counter())
        parts += np.diff(t)
    parts *= 1e3 / len(items)
    log(f"  a training item on one thread: frame read {parts[0]:.2f} ms, "
        f"letterbox + resize {parts[1]:.2f} ms, mask read (PNG "
        f"{m.shape[1]}x{m.shape[0]}) {parts[2]:.2f} ms, mask resize "
        f"{parts[3]:.2f} ms: {parts.sum():.2f} ms, "
        f"{parts.sum() * cfg.batch_size:.1f} ms a batch ({card})")
    log(f"  training loader (train_with_pretrained's CONFIG, {n} batches "
        f"of {cfg.batch_size} 1280x720 JPEGs, {cfg.num_threads} threads: "
        f"nvJPEG, native letterbox + resize to 512^2, masks, H2D) "
        f"{walls[0]:.3f} / {walls[1]:.3f} s an epoch, "
        f"{walls[1] / n * 1e3:.2f} ms a batch; the frozen-encoder train "
        f"step {step_ms:.3f} ms (CUDA events, device-resident batch), "
        f"{step_ms * n / 1e3:.3f} s an epoch ({card})")

    member = load_member(pth, device=dev)
    program = pseudo_label_program([member] * 3, IMAGENET_MEAN, IMAGENET_STD,
                                   int(S * S * 0.001))
    paths = sorted(pseudo["images"].rglob("*.jpeg"))[:B]
    t0 = time.perf_counter()
    batch = np.stack([load_frame(p, S, 0.1, dev) for p in paths])
    read_ms = (time.perf_counter() - t0) * 1e3
    x = torch.from_numpy(batch).to(dev)
    prog_ms = cuda_ms(lambda: program(x, 0.5), 3)
    log(f"  pseudo-label batch of {B} 1280x720 JPEGs: reading (nvJPEG) and "
        f"letterboxing {read_ms:.1f} ms on one thread, the program "
        f"{prog_ms:.3f} ms (CUDA events): the read is "
        f"{read_ms / (read_ms + prog_ms):.3f} of the two; in the workload's "
        f"loop {pseudo['read_s']:.3f} of {pseudo['wall_s']:.3f} s "
        f"({card})")


# ------------------------------- mixed sources, remat, traces, UNet++

# phase 4i's three mirrored sources, each MIXED_SESSIONS x
# MIXED_PER_SESSION camera JPEGs cycled from the fixtures
MIXED_SOURCES, MIXED_SESSIONS, MIXED_PER_SESSION = (
    ("hard", "clean", "pseudo"), 2, 12)
# resnet34 UNet++: the encoder's 36 BatchNorms and two in each of the
# decoder's 11 blocks (10 nodes x_{i}_{j} and final)
UNETPP_BN_LAYERS = 36 + 22
# finetune_for_224's pseudo loss weight in its first three epochs,
# curriculum_weight(e, 0.4, 0.6, 4), and the epochs its encoder is frozen
PSEUDO_W, FROZEN_EPOCHS = (0.45, 0.5, 0.55), 2
# steps timed for the remat step's ms and peak memory; the batch of the
# headline step the bs6 peaks are scaled to (ROADMAP Queue 1 item 12)
REMAT_REPS, HEADLINE_BS = 5, 128


def make_mixed_sources(tmp: Path) -> dict:
    """name -> (images_root, masks_root): mirrored trees (the same
    relative path under both roots) of MIXED_SESSIONS x MIXED_PER_SESSION
    1280x720 JPEGs cycled from the fixtures, each source from its own
    start, with the fixtures' letterboxed mask PNGs."""
    out = {}
    for si, name in enumerate(MIXED_SOURCES):
        root = tmp / "mixed" / name
        i = 3 * si
        for s in range(MIXED_SESSIONS):
            sess = f"session_{s:03d}"
            for sub in ("images", "masks"):
                (root / sub / sess).mkdir(parents=True, exist_ok=True)
            for _ in range(MIXED_PER_SESSION):
                stem = TRAIN_JPEGS[i % len(TRAIN_JPEGS)]
                mask = FIXTURES / f"frame_{stem.split('_')[1]}.mask.png"
                (root / "images" / sess / f"{name}_{i:03d}.jpeg").write_bytes(
                    (FIXTURES / f"{stem}.jpeg").read_bytes())
                (root / "masks" / sess / f"{name}_{i:03d}.png").write_bytes(
                    mask.read_bytes())
                i += 1
        out[name] = (root / "images", root / "masks")
    log(f"  mixed sources {', '.join(MIXED_SOURCES)}: {MIXED_SESSIONS}x"
        f"{MIXED_PER_SESSION} 1280x720 JPEGs each, with their masks")
    return out


def sources_json(path: Path, cli, roots: dict) -> Path:
    """A --sources_json file: the workload's CONFIG.sources (names, ratios,
    loss weights, oversampling) on phase 4i's trees."""
    import dataclasses

    path.write_text(json.dumps([
        dict(dataclasses.asdict(s), images_root=str(roots[s.name][0]),
             masks_root=str(roots[s.name][1]))
        for s in cli.CONFIG.sources]))
    return path


class spy_trainer:
    """While active, records what the entry point's own Trainer calls
    see: the model state `init_state` returns (on the host) and each
    train step's sample weights and active groups."""

    def __enter__(self):
        from cartseg_tpu_torch.train.engine import Trainer

        self.cls = Trainer
        self.init0, self.step0 = Trainer.init_state, Trainer.train_step
        self.first, self.steps = None, []
        spy = self

        def init_state(tr):
            st = spy.init0(tr)
            spy.first = {k: v.detach().cpu().clone()
                         for k, v in st.model.state_dict().items()}
            return st

        def train_step(tr, state, imgs, masks, sample_w, lrs, active, gids):
            spy.steps.append((sample_w.cpu(), list(active)))
            return spy.step0(tr, state, imgs, masks, sample_w, lrs, active,
                             gids)

        Trainer.init_state, Trainer.train_step = init_state, train_step
        return self

    def __exit__(self, *exc):
        self.cls.init_state, self.cls.train_step = self.init0, self.step0
        return False


def run_finetune(name: str, tmp: Path, roots: dict, *extra) -> dict:
    """workloads/<name>.main at its CONFIG on the mixed sources (launch
    counts set to 0 just before and read just after, the Trainer spied)."""
    import importlib

    from cartseg_tpu_torch.ops.cuda import build

    cli = importlib.import_module(f"cartseg_tpu_torch.workloads.{name}")
    out = tmp / f"run_{name}"
    js = sources_json(tmp / f"{name}.sources.json", cli, roots)
    argv = ["--sources_json", str(js), "--out_dir", str(out), "--device",
            "cuda", *extra]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with spy_trainer() as spy:
        result = cli.main(argv, log=lambda m: log(f"    {m}"))
    torch.cuda.synchronize()
    return {"cli": cli, "argv": argv, "out": out, "result": result,
            "spy": spy, "wall": time.perf_counter() - t0,
            "launches": {k: v for k, v in build.LAUNCHES.items() if v}}


def phase_finetune_workloads(tmp: Path, roots: dict) -> dict:
    """The four finetune workloads through their CLIs at their CONFIG
    (encoder, size, batch, loss, LR tiers and the sources' ratios, loss
    weights and oversampling unchanged): finetune_for_224 for 3 epochs of
    its 20-epoch schedule (--stop_after_epoch 3, then --resume --epochs 3
    runs its 19-point sweep on the best checkpoint), the pseudo weight of
    each epoch 0.45 / 0.50 / 0.55 in the steps' sample weights and the
    encoder frozen in the first two; finetune_pseudo for 1 epoch with
    --trace_dir (the trace parses; its kernel events counted);
    finetune_pseudo_hard_clean for 1 epoch from finetune_pseudo's
    model.pth (the state before the first step equals the file's; the
    hard share of its epoch order); finetune_bce_dice_abl for 1 epoch
    (edt, lsr_fwd and lsr_bwd launched). Each run's CSV, history, .pth,
    sidecar and .last.pth."""
    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.train.engine import SCHEMAS
    from cartseg_tpu_torch.utils.profiling import TRACE_NAME

    runs = {}
    # finetune_for_224: 3 epochs, then the sweep
    r = run_finetune("finetune_for_224", tmp, roots, "--stop_after_epoch",
                     "3")
    steps = r["spy"].steps
    n = len(steps) // 3
    if not r["result"].get("interrupted") or n <= 0 or len(steps) != 3 * n:
        raise AssertionError(f"finetune_for_224: {len(steps)} steps, "
                             f"result {r['result'].get('interrupted')}")
    for e in range(3):
        ws = set(torch.cat([w for w, _ in steps[e * n:(e + 1) * n]]).tolist())
        frozen = {a[0] for _, a in steps[e * n:(e + 1) * n]}
        want = float(np.float32(PSEUDO_W[e]))
        log(f"  finetune_for_224 epoch {e + 1}: sample weights {sorted(ws)} "
            f"(pseudo {PSEUDO_W[e]}), encoder "
            f"{'frozen' if frozen == {0.0} else 'trained'}")
        if ws != {1.0, want} or frozen != {0.0 if e < FROZEN_EPOCHS else 1.0}:
            raise AssertionError(f"finetune_for_224 epoch {e + 1}: weights "
                                 f"{ws}, active {frozen}")
    cli = r["cli"]
    res = cli.main(r["argv"] + ["--resume", "--epochs", "3"],
                   log=lambda m: log(f"    {m}"))
    rows = check_train_run(r["out"], SCHEMAS["basic"], 3)
    grid = np.linspace(*cli.CONFIG.threshold_sweep[:2],
                       int(cli.CONFIG.threshold_sweep[2]))
    side = json.loads((r["out"] / "model.threshold.json").read_text())
    if len(grid) != 19 or np.abs(grid - side["threshold"]).min() > 1e-9 \
            or abs(side["threshold"] - res["threshold"]) > 1e-9:
        raise AssertionError(f"finetune_for_224's sweep: {side}")
    log(f"  finetune_for_224: {len(steps)} steps, 3 epochs in "
        f"{r['wall']:.1f} s wall; CSV {rows[1:]}; the 19-point sweep's "
        f"threshold {side['threshold']:.2f} (Dice {side['dice']:.4f})")
    runs["finetune_for_224"] = r

    # finetune_pseudo, epoch 0 traced
    trace_dir = tmp / "trace_finetune_pseudo"
    r = run_finetune("finetune_pseudo", tmp, roots, "--epochs", "1",
                     "--trace_dir", str(trace_dir))
    rows = check_train_run(r["out"], SCHEMAS["basic"], 1)
    trace = trace_dir / TRACE_NAME
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = sum(e.get("cat") == "kernel" for e in events)
    log(f"  finetune_pseudo: {len(r['spy'].steps)} steps, 1 epoch in "
        f"{r['wall']:.1f} s wall (the trace included); CSV {rows[1]}; "
        f"{trace.name} {trace.stat().st_size / 1e6:.1f} MB, {len(events)} "
        f"events, {kernels} CUDA kernel events (torch.profiler may drop "
        f"some on these machines: printed, not gated)")
    runs["finetune_pseudo"] = r

    # finetune_pseudo_hard_clean from finetune_pseudo's model.pth
    pth = r["out"] / "model.pth"
    r = run_finetune("finetune_pseudo_hard_clean", tmp, roots, "--epochs",
                     "1", "--init_torch_checkpoint", str(pth))
    rows = check_train_run(r["out"], SCHEMAS["basic"], 1)
    want = torch.load(pth, map_location="cpu",
                      weights_only=True)["model_state_dict"]
    first = r["spy"].first
    if first.keys() != want.keys() or not all(
            torch.equal(first[k], v) for k, v in want.items()):
        raise AssertionError("finetune_pseudo_hard_clean: the state before "
                             "the first step is not the file's")
    cfg = apply_cli_overrides(r["cli"].CONFIG, r["argv"])
    _, _, sampler, src = Trainer(cfg).build_datasets()
    order = sampler.epoch(0)
    hard = float((src[order] == 0).mean())
    p_hard = float(sampler.p[src == 0].sum())
    epochs = r["cli"].CONFIG.epochs
    every = float(np.mean([(src[sampler.epoch(e)] == 0).mean()
                           for e in range(epochs)]))
    log(f"  finetune_pseudo_hard_clean: started from {pth.parent.name}/"
        f"{pth.name} ({len(want)} tensors equal before the first step); "
        f"hard share of its epoch order {hard:.3f} of {len(order)} draws "
        f"(hard x2 against clean, ratio / length: the sampler gives hard "
        f"{p_hard:.4f}, 2/3 expected; over the CONFIG's {epochs} epochs' "
        f"orders {every:.3f}); {len(r['spy'].steps)} steps in "
        f"{r['wall']:.1f} s wall; CSV {rows[1]}")
    if abs(p_hard - 2 / 3) > 1e-9:
        raise AssertionError(f"finetune_pseudo_hard_clean: hard's share "
                             f"of the sampler {p_hard}")
    runs["finetune_pseudo_hard_clean"] = dict(r, hard_share=hard)

    # finetune_bce_dice_abl: the ABL loss's kernels
    r = run_finetune("finetune_bce_dice_abl", tmp, roots, "--epochs", "1")
    rows = check_train_run(r["out"], SCHEMAS["abl"], 1)
    if not all(r["launches"].get(k, 0) > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"finetune_bce_dice_abl: launches "
                             f"{r['launches']}")
    log(f"  finetune_bce_dice_abl: {len(r['spy'].steps)} steps, 1 epoch in "
        f"{r['wall']:.1f} s wall; abl CSV {rows[1]}; launches "
        f"{r['launches']}")
    runs["finetune_bce_dice_abl"] = r
    return runs


def _lane_step(tr, ref: dict) -> tuple:
    """One train step of `tr` from ref's weights and batch: (loss,
    gradient from the first moment, running stats, channel_sums
    launches), as phase_bce_reference records its lanes."""
    from cartseg_tpu_torch.ops.cuda import build

    st = tr.init_state()
    st.model.load_state_dict(ref["sd"])
    build.reset_launch_counts()
    loss, _, _ = tr.train_step(st, ref["imgs"], ref["masks"],
                               torch.ones(TRAIN_BS, device=ref["imgs"].device),
                               [1e-4] * 3, [1.0] * 3, tr.group_ids(st))
    torch.cuda.synchronize()
    return (float(loss), {k: v.double() / 0.1 for k, v in st.opt.mu.items()},
            {k: v.clone() for k, v in st.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))},
            build.LAUNCHES["channel_sums"])


def phase_remat(dev, ref: dict, card: str) -> dict:
    """The remat check: phase 4e's fp32 resnet34-UNet step (512^2 bs6,
    TF32 off) with remat on, in each BN lane, from the same weights and
    batch, against that lane's plain step within phase 4e's tolerances
    (loss 1e-5 relative, running stats 1e-5, the gradient within twice
    the torch lane's own fp32 distance from float64); the kernel lane
    launches channel_sums 3 times a BN layer (the forward, its recompute,
    the backward). Then the step's ms (CUDA events) and peak
    max_memory_allocated with and without remat, in fp32 and in the
    CONFIG's bf16, and the bf16 peaks scaled to HEADLINE_BS; where that
    prediction fits in 0.9 of the card, the headline step itself (512^2
    bs128 bf16, random batch) with and without remat: ms and peak."""
    import dataclasses

    from cartseg_tpu_torch.train import Trainer

    cfg = ref["cfg"]
    for lane in BN_LANES:
        tr = Trainer(dataclasses.replace(cfg, remat=True), bn_lane=lane)
        lr, gr, sr, nr = _lane_step(tr, ref)
        lp, gp, sp, n_plain = ref["outs"][lane]
        gap = _rel_l2(gr, gp)
        lrel = abs(lr - lp) / abs(lp)
        serr = max(float(((sr[k] - sp[k]).abs() / (1.0 + sp[k].abs())).max())
                   for k in sp)
        want_n = 3 * BCE_BN_LAYERS if lane == "channel_sums" else 0
        log(f"  remat {lane} lane, fp32 step [{TRAIN_BS},{S},{S}]: loss "
            f"{lr:.8f} vs plain {lp:.8f} (rel {lrel:.2e}, limit 1e-5); "
            f"gradient rel L2 to the plain step {gap:.3e} (limit 2x the "
            f"torch lane's float64 distance, {2 * ref['e_t']:.3e}); running "
            f"stats max err {serr:.2e} (limit 1e-5); channel_sums launches "
            f"{nr} (plain {n_plain})")
        if not (lrel <= 1e-5 and gap <= 2 * ref["e_t"] and serr <= 1e-5
                and nr == want_n):
            raise AssertionError(f"remat {lane} lane: the step differs "
                                 "from the plain step")
        del tr
    out = {}
    for dtype in ("float32", "bfloat16"):
        for remat in (False, True):
            tr = Trainer(dataclasses.replace(cfg, remat=remat,
                                             compute_dtype=dtype))
            st = tr.init_state()
            st.model.load_state_dict(ref["sd"])
            gids = tr.group_ids(st)
            sw = torch.ones(TRAIN_BS, device=dev)

            def step():
                tr.train_step(st, ref["imgs"], ref["masks"], sw, [1e-4] * 3,
                              [1.0] * 3, gids)

            step()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, REMAT_REPS)
            peak = torch.cuda.max_memory_allocated()
            out[(dtype, remat)] = (ms, peak, base)
            del st, tr
            torch.cuda.empty_cache()
    for dtype in ("float32", "bfloat16"):
        (ms0, p0, b0), (ms1, p1, b1) = out[(dtype, False)], out[(dtype, True)]
        log(f"  resnet34-UNet step [{TRAIN_BS},{S},{S}] {dtype}: plain "
            f"{ms0:.3f} ms, peak {p0 / 2**30:.3f} GiB; remat {ms1:.3f} ms "
            f"({ms1 / ms0 - 1:+.1%}), peak {p1 / 2**30:.3f} GiB "
            f"({p1 / p0 - 1:+.1%}); resident between steps "
            f"{b0 / 2**30:.3f} GiB [{card}]")
    total = torch.cuda.get_device_properties(0).total_memory
    fits = []
    for remat in (False, True):
        ms, peak, base = out[("bfloat16", remat)]
        pred = base + (peak - base) * HEADLINE_BS / TRAIN_BS
        log(f"  predicted peak of the bf16 step at bs{HEADLINE_BS} "
            f"{'with' if remat else 'without'} remat: {pred / 2**30:.1f} GiB "
            f"(resident + (peak - resident) x {HEADLINE_BS}/{TRAIN_BS}); "
            f"the card holds {total / 2**30:.1f} GiB")
        if pred < 0.9 * total:
            fits.append(remat)
    if fits:
        # the headline step (512^2 bs128, bf16), where predicted to fit
        imgs, masks = bce_batch(S, HEADLINE_BS, dev)
        sw = torch.ones(HEADLINE_BS, device=dev)
        for remat in fits:
            tr = Trainer(dataclasses.replace(
                cfg, remat=remat, compute_dtype="bfloat16",
                batch_size=HEADLINE_BS))
            st = tr.init_state()
            st.model.load_state_dict(ref["sd"])
            gids = tr.group_ids(st)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: tr.train_step(st, imgs, masks, sw,
                                               [1e-4] * 3, [1.0] * 3, gids),
                         REMAT_REPS)
            peak = torch.cuda.max_memory_allocated()
            out[("headline", remat)] = (ms, peak)
            log(f"  resnet34-UNet bf16 step [{HEADLINE_BS},{S},{S}] "
                f"{'with' if remat else 'without'} remat: {ms:.3f} ms, "
                f"{HEADLINE_BS / ms * 1e3:.1f} img/s, peak "
                f"{peak / 2**30:.3f} GiB [{card}]")
            del st, tr
            torch.cuda.empty_cache()
    return out


def phase_classic(dev) -> None:
    """The classic UNet (build_model("classic"), seeded init) on one
    letterboxed 512^2 fixture frame, batch 1 (the annotation tool's
    proposal size, cartseg_tpu/tools/annotate.py:97): probabilities on
    the card against the CPU's in fp32 (TF32 off), atol 1e-5."""
    from cartseg_tpu_torch import native
    from cartseg_tpu_torch.device import set_fp32_policy
    from cartseg_tpu_torch.models import build_model
    from cartseg_tpu_torch.utils import image_io

    set_fp32_policy()
    torch.manual_seed(SEED)
    model = build_model("classic").eval()
    rgb = image_io.read_rgb(FIXTURES / "frame_0.jpeg", dev)
    x = torch.from_numpy(native.letterbox_resize(rgb, (S, S), 0.1)).permute(
        2, 0, 1)[None].float() / 255.0
    with torch.no_grad():
        want = model(x)
        m = model.to(dev)
        xd = x.to(dev)
        got = m(xd)
        ms = cuda_ms(lambda: m(xd), 3)
    err = float((got.cpu() - want).abs().max())
    log(f"  classic UNet [1,3,{S},{S}] fp32: card against CPU max |d| "
        f"{err:.2e} (limit 1e-5); probabilities in [{float(got.min()):.4f}, "
        f"{float(got.max()):.4f}]; forward {ms:.3f} ms on the card")
    if got.shape != (1, 1, S, S) or err > 1e-5 or float(got.min()) < 0 \
            or float(got.max()) > 1:
        raise AssertionError("classic UNet: card and CPU disagree")


def phase_finetune_timing(dev, runs: dict, unetpp: dict, card: str) -> None:
    """Each phase-4i run's train step at its CONFIG on a device-resident
    batch (CUDA events, REMAT_REPS steps after a warm-up) against the
    loader alone over the run's epoch-0 order (its threads' reads,
    decodes, letterboxing and the copy to the card; wall per batch): the
    run is loader-bound where a batch takes longer to load than to
    train. Beside them the run's last epoch in history.json."""
    from cartseg_tpu_torch.data.pipeline import Loader
    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.train.engine import epoch_order
    from cartseg_tpu_torch.workloads.train_bce_dice import CONFIG

    cases = [(name, apply_cli_overrides(r["cli"].CONFIG, r["argv"]), "torch",
              r["out"]) for name, r in runs.items()]
    cases += [(f"train_bce_dice --decoder unetpp_ds ({lane} lane)",
               apply_cli_overrides(CONFIG, [
                  "--device", "cuda", "--decoder", "unetpp_ds",
                  "--images_root", u["roots"][0], "--masks_root",
                  u["roots"][1]]), lane, u["out"])
              for lane, u in unetpp.items()]
    loads = {}
    for name, cfg, lane, out in cases:
        tr = Trainer(cfg, bn_lane=lane)
        key = (cfg.sources_json, cfg.images_root, cfg.img_size,
               cfg.batch_size)
        if key not in loads:   # the UNet++ lanes read one data set
            train_ds, _, sampler, _ = tr.build_datasets()
            order = (sampler.epoch(0) if sampler is not None
                     else epoch_order(cfg.seed, 0, len(train_ds)))
            loader = Loader(train_ds, cfg.batch_size, device=dev,
                            num_threads=cfg.num_threads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = len(list(loader(order)))
            torch.cuda.synchronize()
            loads[key] = ((time.perf_counter() - t0) * 1e3 / max(n, 1), n)
        load_ms, n_batches = loads[key]
        st = tr.init_state()
        hw, bs = cfg.img_size[0], cfg.batch_size
        imgs, masks = bce_batch(hw, bs, dev)
        sw = torch.ones(bs, device=dev)
        gids = tr.group_ids(st)
        ms = cuda_ms(lambda: tr.train_step(st, imgs, masks, sw, [1e-4] * 3,
                                           [1.0] * 3, gids), REMAT_REPS)
        epoch = json.loads((out / "history.json").read_text())[-1]
        step_rate, run_rate = bs / ms * 1e3, epoch["images_per_sec"]
        log(f"  {name} ({cfg.encoder}, {hw}^2 bs{bs}, {cfg.compute_dtype}): "
            f"step {ms:.3f} ms, {step_rate:.1f} img/s on a device-resident "
            f"batch; the loader alone {load_ms:.1f} ms a batch over an "
            f"epoch's {n_batches} ({cfg.num_threads} threads): "
            f"{'loader' if load_ms > ms else 'step'}-bound, "
            f"{max(load_ms, ms) / min(load_ms, ms):.1f}x; its run's epoch "
            f"{epoch['epoch']} {run_rate:.2f} img/s (loader, val and "
            f"checkpoints included) [{card}]")
        del st, tr
        torch.cuda.empty_cache()


# ------------------- cleaning, mining, ranking and evaluation (phase 4j)

# the mining program's batches timed in phase 5 (the workload's default
# 16, and 64)
MINING_BS = (16, 64)
# the metric body on the card against the CPU on the same probs, as the
# tests hold the body against JAX (tests/test_torch_mining.py)
MINING_BODY_TOL = 1e-6
MINING_REPS = 10
POST_CLEAN_REPS = 20


class cc_spy:
    """Record the connectivity and shape of every `cc_batch` call that
    ops/connected_components.py makes for the context's length; the
    launch count stays where the wrapper launches the kernel."""

    def __enter__(self):
        from cartseg_tpu_torch.ops import connected_components as CC

        self.module, self.orig, self.calls = CC, CC.cc_batch, []

        def spy(mask, connectivity=8):
            self.calls.append((connectivity, tuple(mask.shape)))
            return self.orig(mask, connectivity)

        CC.cc_batch = spy
        return self

    def __exit__(self, *exc):
        self.module.cc_batch = self.orig
        return False

    def seen(self) -> dict:
        """{connectivity: the shapes it labelled}"""
        out: dict = {}
        for conn, shape in self.calls:
            out.setdefault(conn, set()).add(shape)
        return {k: sorted(v) for k, v in sorted(out.items())}


def phase_clean_workloads(tmp: Path, jir: Path, jmr: Path, pseudo: Path,
                          dev) -> dict:
    """workloads/clean_masks in its three modes: `complete` on the JPEG
    tree's 1536^2 letterboxed masks with --images_root (the content box
    from each frame's size, read by nvJPEG), holes_largest and
    largest_only on the pseudo-label masks (512^2). Every output equals
    the same cleaner run on the CPU (once per distinct input) bit for
    bit, `complete`'s is zero outside the content box, cc launched at
    connectivity 4 and 8."""
    from cartseg_tpu_torch import geometry as G
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.postprocess import clean as C
    from cartseg_tpu_torch.utils import image_io
    from cartseg_tpu_torch.workloads import clean_masks as cli

    cleaners = {"complete": C.post_clean, "holes_largest": C.clean_mask,
                "largest_only": C.clean_mask_largest_component}
    conns, out = set(), {}
    for mode, root in (("complete", jmr), ("holes_largest", pseudo),
                       ("largest_only", pseudo)):
        dst = tmp / f"clean_{mode}"
        extra = ["--images_root", str(jir)] if mode == "complete" else []
        build.reset_launch_counts()
        with cc_spy() as spy:
            t0 = time.perf_counter()
            n = cli.main(["--masks_root", str(root), "--out_root", str(dst),
                          "--mode", mode] + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = build.LAUNCHES["cc"]
        masks = sorted(root.rglob("*.png"))
        if n != len(masks) or launches < 1:
            raise AssertionError(f"clean_masks {mode}: {n} of {len(masks)} "
                                 f"masks, {launches} cc launches")
        groups: dict = {}
        for mp in masks:
            rel = mp.relative_to(root)
            size = None
            if mode == "complete":
                size = image_io.read_rgb(C.find_image(jir, rel),
                                         dev).shape[:2]
            groups.setdefault((mp.read_bytes(), size), []).append(rel)
        t0 = time.perf_counter()
        for (raw, size), rels in groups.items():
            m255 = (image_io.decode_png(raw) > 127).astype(np.uint8) * 255
            if size is not None:
                m255 = G.cut_mask_padding(m255, size[1], size[0])
                x0, y0, x1, y1 = G.calculate_content_boundaries(
                    size[1], size[0], m255.shape[1], m255.shape[0])
            want = cleaners[mode](torch.from_numpy(m255 > 127)).numpy()
            for rel in rels:
                got = image_io.decode_png((dst / rel).read_bytes()) > 127
                if not np.array_equal(got, want):
                    raise AssertionError(f"clean_masks {mode}: {rel} on the "
                                         "card differs from the CPU")
                if size is not None and (got[:y0].any() or got[y1:].any()
                                         or got[:, :x0].any()
                                         or got[:, x1:].any()):
                    raise AssertionError(f"{rel}: foreground outside the "
                                         "content box")
        cpu_s = time.perf_counter() - t0
        seen = spy.seen()
        conns |= set(seen)
        hw = image_io.decode_png(masks[0].read_bytes()).shape
        log(f"  clean_masks --mode {mode}: {n} masks of {hw[1]}x{hw[0]} "
            f"in {wall:.2f} s wall, {launches} cc launches (connectivity: "
            f"shapes {seen}); equal to the CPU's cleaner bit for bit on all "
            f"{len(groups)} distinct inputs ({cpu_s:.1f} s on the CPU)")
        out[mode] = {"dst": dst, "n": n, "launches": launches}
    if conns != {4, 8}:
        raise AssertionError(f"cc connectivities {conns}, want 4 and 8")
    return out


def phase_unpad_and_copy(tmp: Path, images: Path, pseudo: Path, jir: Path,
                         cleaned: Path) -> None:
    """workloads/remove_padding_from_masks on every pseudo-label mask
    (accepted and uncertain) with --overlays: each mask and overlay at
    its frame's size (1280x720, 720 wide for EXIF orientations 5-8);
    get_images copy-images (the cleaned JPEG-tree masks' frames) and
    copy-masks (the pseudo-label tree), each copy equal to its source."""
    from cartseg_tpu_torch.utils import image_io
    from cartseg_tpu_torch.utils.jpeg import exif_orientation
    from cartseg_tpu_torch.workloads import get_images
    from cartseg_tpu_torch.workloads import remove_padding_from_masks as cli

    out, ov = tmp / "unpadded", tmp / "unpad_overlays"
    t0 = time.perf_counter()
    n = sum(cli.main(["--masks_root", str(root), "--images_root",
                      str(images), "--out_root", str(out), "--overlays",
                      str(ov)]) for root in (pseudo, pseudo / "uncertain"))
    wall = time.perf_counter() - t0
    frames = sorted(images.rglob("*.jpeg"))
    if n != len(frames):
        raise AssertionError(f"unpadded {n} masks for {len(frames)} frames")
    rotated = 0
    for p in frames:
        rel = p.relative_to(images).with_suffix(".png")
        turned = exif_orientation(p.read_bytes()) >= 5
        rotated += turned
        hw = (1280, 720) if turned else (720, 1280)
        m = image_io.decode_png((out / rel).read_bytes())
        o = image_io.decode_png((ov / rel).read_bytes())
        if m.shape != hw or o.shape != hw + (3,) or \
                not set(np.unique(m)) <= {0, 255}:
            raise AssertionError(f"{rel}: mask {m.shape}, overlay {o.shape}")
    log(f"  remove_padding_from_masks --overlays: {n} masks and overlays at "
        f"their frame's size ({rotated} of them 720x1280 by EXIF "
        f"orientation), {wall:.2f} s wall")

    n_img = get_images.main(["copy-images", "--masks_root", str(cleaned),
                             "--images_root", str(jir), "--out_root",
                             str(tmp / "copied_images")])
    n_msk = get_images.main(["copy-masks", "--src_root", str(pseudo),
                             "--dst_root", str(tmp / "copied_masks")])
    pairs = [(tmp / "copied_images" / p.relative_to(jir), p)
             for p in jir.rglob("*.jpeg")]
    pairs += [(tmp / "copied_masks" / p.relative_to(pseudo), p)
              for p in pseudo.rglob("*.png")]
    if n_img + n_msk != len(pairs) or \
            any(a.read_bytes() != b.read_bytes() for a, b in pairs):
        raise AssertionError(f"get_images copied {n_img} + {n_msk} files "
                             f"for {len(pairs)}")
    log(f"  get_images copy-images {n_img} frames, copy-masks {n_msk} "
        "masks, each equal to its source")


def phase_rank(tmp: Path, pseudo: Path) -> None:
    """workloads/get_best_pseudo_masks on the pseudo-label tree: its
    ranking.csv rows equal the ranking computed here in numpy
    (get_best_pseudo_masks.py:30-38), scores exactly."""
    from cartseg_tpu_torch.workloads import get_best_pseudo_masks as cli

    dst = tmp / "best_pseudo"
    cli.main(["--src_root", str(pseudo), "--dst_root", str(dst),
              "--top_k", "10"])
    want = []
    for path in sorted(pseudo.rglob("*_prob.npz")):
        p = np.load(path)["prob"].astype(np.float32)
        fg = float((p >= 0.5).mean())
        conf = float(np.median(np.abs(p - 0.5) * 2.0))
        q = np.clip(p.astype(np.float64), 1e-6, 1.0 - 1e-6)
        ent = float((-(q * np.log(q) + (1.0 - q) * np.log(1.0 - q))).mean())
        pen = (-min(1.0, (0.005 - fg) / 0.005) if fg < 0.005 else
               -min(1.0, (fg - 0.6) / 0.4) if fg > 0.6 else 0.0)
        want.append((str(path), fg, conf, ent,
                     float(0.7 * conf - 0.5 * ent + 0.3 * pen)))
    want.sort(key=lambda r: -r[4])
    with open(dst / "ranking.csv") as f:
        got = [(r["prob"], *(float(r[k]) for k in (
            "fg_area", "fg_conf", "mean_entropy", "score")))
               for r in csv.DictReader(f)]
    if got != want:
        raise AssertionError("ranking.csv differs from the numpy ranking")
    copied = len(list(dst.rglob("*_prob.npz")))
    log(f"  get_best_pseudo_masks: {len(got)} rows equal to the numpy "
        f"ranking; top {copied} copied (scores {got[0][4]:.4f} .. "
        f"{got[-1][4]:.4f})")


# preview panels phase 4j writes, of the top-ranked rows
MINING_PREVIEWS = 4


def phase_mining(tmp: Path, pth: Path, images: Path, dev) -> None:
    """workloads/mine_hard_cases at its defaults (512^2, bs16) with
    model.pth as three members on the JPEG frames: the CSV's columns,
    one row a frame in descending composite, cc at 4 and 8 on
    [16,512,512]; then the metric body on the card against the CPU on
    the same probs (components equal, the rest within
    MINING_BODY_TOL); then MINING_PREVIEWS preview panels, each the
    frame, its JET heat map and its contours."""
    from cartseg_tpu_torch.infer.engine import ensemble_probs_fn, load_member
    from cartseg_tpu_torch.infer.mining import metrics_body
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       load_frame)
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.workloads import mine_hard_cases as cli

    keys = ["components", "composite", "entropy_mean", "frac_near_0p5",
            "hole_fraction", "perimeter_over_area", "tta_var_mean"]
    build.reset_launch_counts()
    with cc_spy() as spy:
        t0 = time.perf_counter()
        cli.main(["--images_root", str(images), "--out_dir",
                  str(tmp / "mining"), "--checkpoints",
                  ",".join([str(pth)] * 3)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    with open(tmp / "mining" / "hard_candidates.csv") as f:
        rows = list(csv.reader(f))
    frames = sorted(images.rglob("*.jpeg"))
    comp = [float(r[2]) for r in rows[1:]]
    if rows[0] != ["path"] + keys or len(rows) != len(frames) + 1 or \
            comp != sorted(comp, reverse=True) or \
            not all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:]):
        raise AssertionError(f"hard_candidates.csv: {rows[0]}, "
                             f"{len(rows) - 1} rows")
    seen = spy.seen()
    if set(seen) != {4, 8} or launches.get("cc", 0) < 1:
        raise AssertionError(f"mining: cc calls {seen}, launches {launches}")
    log(f"  mine_hard_cases (512^2, bs16, 3 members): {len(rows) - 1} rows "
        f"in descending composite ({comp[0]:.4f} .. {comp[-1]:.4f}), "
        f"{wall:.2f} s wall (members' load included); launches {launches},"
        f" cc connectivity: shapes {seen}")

    members = [load_member(pth, device=dev)] * 3
    fwd = ensemble_probs_fn(members, IMAGENET_MEAN, IMAGENET_STD,
                            tta_flip=True)
    x = np.stack([load_frame(p, S, 0.1, dev) for p in frames[:16]])
    probs = fwd(torch.from_numpy(x).to(dev))
    body = metrics_body(0.5, 0.05)
    card = {k: v.cpu() for k, v in body(*probs).items()}
    cpu = body(*(p.cpu() for p in probs))
    if not torch.equal(card["components"], cpu["components"]):
        raise AssertionError(f"components: card {card['components']}, CPU "
                             f"{cpu['components']}")
    err = {k: float((card[k] - cpu[k]).abs().max()) for k in keys}
    if max(err.values()) > MINING_BODY_TOL:
        raise AssertionError(f"metric body, card against CPU: {err}")
    log(f"  mining metric body on [16,512,512] probs, card against CPU: "
        f"components equal ({card['components'].tolist()}), max |d| "
        f"{max(err.values()):.3g} (tolerance {MINING_BODY_TOL})")

    # the preview panels of the top rows (MiningConfig.save_previews):
    # frame | JET heat | contours, drawn without cv2
    from cartseg_tpu_torch.infer.mining import MiningConfig, _save_previews
    from cartseg_tpu_torch.postprocess.overlay import (apply_colormap_jet,
                                                       draw_external_contours)
    from cartseg_tpu_torch.utils import image_io

    top = [{"path": r[0]} for r in rows[1:1 + MINING_PREVIEWS]]
    seen = []

    def recording_fwd(x):
        pa, pb = fwd(x)
        seen.append(((pa + pb) / 2.0)[0].cpu().numpy())
        return pa, pb

    t0 = time.perf_counter()
    _save_previews(top, recording_fwd, MiningConfig(), tmp / "mining", dev,
                   lambda m: None)
    wall = time.perf_counter() - t0
    for rank, (row, p) in enumerate(zip(top, seen)):
        img = load_frame(row["path"], S, 0.1, dev)
        want = np.concatenate([img, apply_colormap_jet(
            (p * 255).astype(np.uint8)), draw_external_contours(
            img, p > 0.5, (255, 0, 0), 2)], axis=1)
        got = image_io.decode_png((tmp / "mining" / "previews" /
                                   f"{rank:04d}_{Path(row['path']).stem}.png")
                                  .read_bytes())
        if not np.array_equal(got, want):
            raise AssertionError(f"mining preview {rank} is off")
    log(f"  mining previews: {len(top)} panels ({S}x{3 * S}) of the top "
        f"rows, each frame | JET | contours, cv2 refused, {wall:.2f} s")


def phase_evaluate(pth: Path, jir: Path, jmr: Path, tmp: Path) -> None:
    """workloads/evaluate --sweep with model.pth on the JPEG tree at its
    defaults (512^2, bs16): the JSON's keys, finite values, every pair
    counted, the best threshold on the sweep."""
    from cartseg_tpu_torch.workloads import evaluate as cli

    t0 = time.perf_counter()
    out = cli.main(["--images_root", str(jir), "--masks_root", str(jmr),
                    "--checkpoint", str(pth), "--sweep", "--out_json",
                    str(tmp / "evaluate.json")])
    wall = time.perf_counter() - t0
    n = len(list(jir.rglob("*.jpeg")))
    keys = ["dice", "dice_bin", "f1", "iou", "iou_bin", "precision",
            "recall", "threshold", "n_images", "best_threshold",
            "best_threshold_dice"]
    if list(out) != keys or out["n_images"] != n or \
            not all(np.isfinite(v) for v in out.values()) or \
            not np.isclose(cli.SWEEP, out["best_threshold"]).any():
        raise AssertionError(f"evaluate: {out}")
    log(f"  evaluate --sweep on {n} JPEG pairs: dice {out['dice']:.4f}, iou "
        f"{out['iou']:.4f}, f1 {out['f1']:.4f} at {out['threshold']:.2f}; "
        f"best {out['best_threshold']:.2f} ({out['best_threshold_dice']:.4f})"
        f"; {wall:.2f} s wall")


def phase_sobel(ckpts, frames: np.ndarray, dev) -> None:
    """The pseudo-label program with the Sobel QC gate on 4a's frames and
    members: cc and median launched, reach not."""
    from cartseg_tpu_torch.infer.engine import (load_member,
                                                pseudo_label_program)
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD)
    from cartseg_tpu_torch.ops.cuda import build

    members = [load_member(p, device=dev) for p in ckpts]
    prog = pseudo_label_program(members, IMAGENET_MEAN, IMAGENET_STD,
                                int(S * S * 0.001), edge_method="sobel")
    x = torch.from_numpy(frames[:B]).to(dev)
    build.reset_launch_counts()
    _, _, stats = prog(x, 0.5)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    if launches.get("reach", 0) or not launches.get("cc") or \
            not launches.get("median"):
        raise AssertionError(f"Sobel program launches {launches}")
    hit = stats["edge_hit"]
    if hit.shape != (B,) or not torch.isfinite(hit).all():
        raise AssertionError(f"Sobel edge_hit {hit}")
    log(f"  pseudo-label program, edge_method='sobel' (threshold 120) on "
        f"4a's {B} frames: launches {launches} (no reach); edge_hit mean "
        f"{float(hit.mean()):.4f}")


def phase_toolchain_timing(dev, pth: Path, images: Path, jmr: Path,
                           card: str) -> None:
    """The mining program's ms a batch and img/s at MINING_BS on a
    device-resident batch of the JPEG frames (CUDA events), and
    post_clean on one 1536^2 mask: its wall a call (CUDA events) and its
    device time (profiler) split into the CC kernel calls, the component
    statistics (bincount, scatter_reduce) and the morphology, each
    timed alone on the same inputs."""
    from cartseg_tpu_torch import geometry as G
    from cartseg_tpu_torch.infer.engine import load_member
    from cartseg_tpu_torch.infer.mining import mining_program
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       load_frame)
    from cartseg_tpu_torch.ops import connected_components as CC
    from cartseg_tpu_torch.ops import morphology as M
    from cartseg_tpu_torch.postprocess.clean import post_clean
    from cartseg_tpu_torch.utils import image_io

    members = [load_member(pth, device=dev)] * 3
    program = mining_program(members, IMAGENET_MEAN, IMAGENET_STD, 0.5,
                             0.05)
    paths = sorted(images.rglob("*.jpeg"))
    x = torch.from_numpy(np.stack([load_frame(p, S, 0.1, dev)
                                   for p in paths[:max(MINING_BS)]])).to(dev)
    for bs in MINING_BS:
        ms = cuda_ms(lambda: program(x[:bs]), MINING_REPS)
        log(f"  mining program (3x effnet-b0, flip TTA, metrics) at "
            f"bs{bs}@{S}^2: {ms:.3f} ms a batch, {bs / ms * 1e3:.1f} img/s "
            f"(CUDA events, device-resident batch) [{card}]")
    del program, members
    torch.cuda.empty_cache()

    raw = image_io.decode_png(next(iter(sorted(jmr.rglob("*.png"))))
                              .read_bytes())
    m = torch.from_numpy(G.cut_mask_padding(raw, 1280, 720) > 127).to(dev)
    opened = M.morph_open(m, 3)
    largest = CC.keep_largest_component(opened)
    closed = M.morph_close(largest, 7)
    lab1 = CC.connected_components(opened)
    lab2 = CC.connected_components(~closed)
    border = (~closed) & M._border(*m.shape, dev)
    wall = cuda_ms(lambda: post_clean(m), POST_CLEAN_REPS)
    total = device_ms(lambda: post_clean(m), POST_CLEAN_REPS)
    label = device_ms(lambda: (CC.connected_components(opened),
                               CC.connected_components(~closed)),
                      POST_CLEAN_REPS)
    stats = device_ms(lambda: (CC._areas(lab1),
                               CC.per_pixel_component_area(lab2),
                               CC.per_pixel_component_any(lab2, border)),
                      POST_CLEAN_REPS)
    morph = device_ms(lambda: (M.morph_open(m, 3),
                               M.morph_close(largest, 7)), POST_CLEAN_REPS)
    log(f"  post_clean on one {m.shape[0]}x{m.shape[1]} mask: {wall:.4f} "
        f"ms a call (CUDA events), {total:.4f} ms of it on the device "
        f"(profiler) = CC kernel (2 labellings, 8-connectivity) "
        f"{label:.4f} + component statistics (bincount areas x2, "
        f"scatter_reduce any) {stats:.4f} + morphology (open 3, close 7, "
        f"elliptical) {morph:.4f} + the rest "
        f"{total - label - stats - morph:.4f} (selects, compares) [{card}]")


# -------------------------------------- serving and data parallelism (4k, 4l)

# the serving artifact at the JAX export defaults (serve/export.py:94-106)
SERVE_IMG, SERVE_BS, SERVE_DTYPE = 512, 16, "bfloat16"
# requests, client threads and the micro-batcher's flush timer
SERVE_REQUESTS, SERVE_CLIENTS, SERVE_LATENCY_MS = 64, 8, 20.0
# the artifact's probabilities against the eager forward, where
# torch.export would run other kernels: one bf16 ulp at 1 (2^-8); the
# check prints which held, bit for bit or this bound
SERVE_EXPORT_TOL = 2.0 ** -8
# data-parallel ranks on the one card (gloo), and the global batch
DDP_RANKS = 2
# the sharded pseudo-label program against the unsharded one on the whole
# bs64 batch: the halves run at batch 32, where cuDNN may pick other
# convolution algorithms than at 64 (bf16): probabilities and QC
# statistics within SHARD_TOL, masks equal where |p - thr| > SHARD_TOL
SHARD_TOL = 1e-2
SHARD_DEVICES = 2


def serve_frames() -> list:
    """(name, JPEG bytes) of 4h's 1280x720 fixtures."""
    return [(s, (FIXTURES / f"{s}.jpeg").read_bytes()) for s in TRAIN_JPEGS]


def phase_serve(tmp: Path, pth: Path, frames: np.ndarray, dev,
                card: str) -> dict:
    """Phase 4k: 4e's resnet34-UNet model.pth and its sidecar exported at
    512^2, batch 16, bf16 (serve/export.py), loaded on the card; its
    probabilities on a device batch against the eager forward; then 64
    POST /segment requests of the 1280x720 JPEG fixtures from 8 client
    threads to the HTTP server on 127.0.0.1 at a free port (cv2 and PIL
    refused by the caller), each returned mask equal to
    ServedSegmenter.segment on the same frame. Prints ms a device batch
    (CUDA events) and img/s, request latency p50 / p99 and requests a
    device call."""
    import threading
    import urllib.request

    from cartseg_tpu_torch.infer.engine import read_threshold_sidecar
    from cartseg_tpu_torch.serve import (SegmentationService,
                                         export_segmenter, load_segmenter)
    from cartseg_tpu_torch.serve.export import inference_module
    from cartseg_tpu_torch.serve.server import make_http_server
    from cartseg_tpu_torch.utils import image_io

    t0 = time.perf_counter()
    art = export_segmenter(tmp / "artifact", checkpoint=pth,
                           encoder="resnet34",
                           img_hw=(SERVE_IMG, SERVE_IMG),
                           batch_size=SERVE_BS, compute_dtype=SERVE_DTYPE,
                           device="cuda")
    export_s = time.perf_counter() - t0
    served = load_segmenter(art)
    m = served.manifest
    if (m["threshold"] != read_threshold_sidecar(pth)
            or m["platforms"] != ["cuda"] or served.device.type != "cuda"):
        raise AssertionError(f"4k: the artifact's manifest {m}")
    sd = torch.load(pth, map_location="cpu",
                    weights_only=True)["model_state_dict"]
    eager = inference_module(sd, "resnet34", dev, SERVE_DTYPE, False)
    x = torch.from_numpy(frames[:SERVE_BS]).to(dev)
    with torch.inference_mode():
        got, want = served._program(x), eager(x)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: served._program(x), 20)
        eager_ms = cuda_ms(lambda: eager(x), 20)
    log(f"  artifact {art.name}: exported in {export_s:.1f} s "
        f"(torch.export, resnet34 {SERVE_IMG}^2 batch {SERVE_BS} "
        f"{SERVE_DTYPE}, threshold {m['threshold']:.2f} from the sidecar); "
        f"its probabilities against the eager prepare_model forward on a "
        f"device batch of {SERVE_BS}: "
        + ("equal bit for bit" if same else
           f"max |d| {err:.3e} (limit {SERVE_EXPORT_TOL:.3e})"))
    if not same and not err <= SERVE_EXPORT_TOL:
        raise AssertionError("4k: the artifact disagrees with the eager "
                             "forward")
    log(f"  artifact: {ms:.3f} ms a device batch of {SERVE_BS} (CUDA "
        f"events), {SERVE_BS * 1e3 / ms:.1f} img/s; eager module "
        f"{eager_ms:.3f} ms [{card}]")

    jpegs = serve_frames()
    svc = SegmentationService(art, max_latency_ms=SERVE_LATENCY_MS)
    srv = make_http_server(svc, 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    lat, bodies, errs = [], {}, []
    lock = threading.Lock()

    def client(c: int) -> None:
        for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
            name, body = jpegs[i % len(jpegs)]
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/segment", data=body,
                method="POST")
            try:
                t = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = r.read()
                with lock:
                    lat.append(time.perf_counter() - t)
                    bodies[i] = (name, out)
            except Exception as e:  # noqa: BLE001 - reported below
                errs.append(f"request {i}: {e!r}")

    try:
        svc.device_calls = svc.requests = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        calls, reqs = svc.device_calls, svc.requests
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
    if errs or len(bodies) != SERVE_REQUESTS:
        raise AssertionError(f"4k: {len(bodies)} of {SERVE_REQUESTS} "
                             f"answered; {errs[:3]}")
    refs = {}
    for name, body in jpegs:
        refs[name] = served.segment(image_io.decode_rgb(body, dev))
    bad = [i for i, (name, out) in bodies.items()
           if not np.array_equal(image_io.decode_png(out), refs[name])]
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
    log(f"  HTTP: {SERVE_REQUESTS} POST /segment of {len(jpegs)} 1280x720 "
        f"JPEG fixtures from {SERVE_CLIENTS} client threads, 127.0.0.1:"
        f"{port}, max_latency_ms {SERVE_LATENCY_MS:g}: {wall:.2f} s wall, "
        f"{SERVE_REQUESTS / wall:.1f} requests/s; latency p50 {p50:.1f} ms, "
        f"p99 {p99:.1f} ms; {reqs} requests in {calls} device calls "
        f"({reqs / max(calls, 1):.2f} a call); masks equal to "
        f"ServedSegmenter.segment: {SERVE_REQUESTS - len(bad)}/"
        f"{SERVE_REQUESTS} [{card}]")
    if bad:
        raise AssertionError(f"4k: requests {bad[:8]} answered other masks "
                             "than segment()")
    return {"batch_ms": ms, "img_s": SERVE_BS * 1e3 / ms, "p50": p50,
            "p99": p99, "per_call": reqs / max(calls, 1)}


def ddp_worker(out: Path, train_args: list) -> None:
    """One rank under torchrun (`python3 chip_smoke.py --ddp-worker OUT --
    ARGS`, phase 4l): the group from torchrun's environment; where
    OUT/grad_in.pt exists, the first step of train_bce_dice's CONFIG in
    fp32 (TF32 off) from its weights on this rank's rows of its batch;
    then train_bce_dice's entry point with ARGS. Writes OUT/rank<r>.pt:
    the backend, the step's gradient (first moment / 0.1) and launches,
    the run's steps and launches, the final state and the channel_sums
    arrival-counter rows in use."""
    import torch.distributed as dist

    from cartseg_tpu_torch.device import fp32_policy
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda import channel_sums as cs
    from cartseg_tpu_torch.parallel import mesh
    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.workloads import train_bce_dice as cli
    from cartseg_tpu_torch.workloads._runner import bn_lane_from_env

    mesh.maybe_initialize_distributed("cuda")
    rank = mesh.process_index()
    res = {"backend": dist.get_backend(), "world": mesh.process_count(),
           "device": torch.cuda.current_device()}
    grad_in = out / "grad_in.pt"
    if grad_in.exists():
        g = torch.load(grad_in, weights_only=True)
        cfg = apply_cli_overrides(cli.CONFIG, ["--device", "cuda",
                                               "--compute_dtype", "float32"])
        tr = Trainer(cfg, bn_lane_from_env())
        st = tr.init_state()
        st.model.load_state_dict(g["sd"])
        rows = mesh.host_batch_slice(g["imgs"].shape[0])
        build.reset_launch_counts()
        with fp32_policy():
            tr.train_step(st, g["imgs"][rows].cuda(),
                          g["masks"][rows].cuda(),
                          torch.ones(rows.stop - rows.start, device="cuda"),
                          [1e-4] * 3, [1.0] * 3, tr.group_ids(st))
        torch.cuda.synchronize()
        res["grad"] = {k: (v / 0.1).cpu() for k, v in st.opt.mu.items()}
        res["grad_launches"] = build.LAUNCHES["channel_sums"]
        del tr, st
    build.reset_launch_counts()
    t0 = time.perf_counter()
    result = cli.main(train_args, log=lambda m: None)
    torch.cuda.synchronize()
    res["wall"] = time.perf_counter() - t0
    res["launches"] = dict(build.LAUNCHES)
    res["steps"] = result["state"].step
    res["state"] = {k: v.cpu() for k, v in
                    result["state"].model.state_dict().items()}
    res["counter_rows"] = len(cs._ARRIVALS.rows)
    torch.save(res, out / f"rank{rank}.pt")
    mesh.barrier("written")
    dist.destroy_process_group()


def torchrun(out: Path, nproc: int, train_args: list, env: dict) -> list:
    """nproc ranks of ddp_worker under torchrun (a free rendezvous port on
    localhost); their results, in rank order."""
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(Path(__file__).resolve()),
           "--ddp-worker", str(out), "--", *train_args]
    proc = subprocess.run(cmd, env={**os.environ, **env}, cwd=str(
        Path(__file__).resolve().parent), capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        tail = (proc.stdout[-3000:] + "\n" + proc.stderr[-6000:])
        hint = ("; gloo could not carry CUDA tensors on this machine"
                if "gloo" in tail.lower() and "cuda" in tail.lower() else "")
        raise AssertionError(f"4l: torchrun of {nproc} rank(s) failed "
                             f"(exit {proc.returncode}){hint}:\n{tail}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nproc)]


def phase_ddp_train(tmp: Path, ir: Path, mr: Path, ref: dict,
                    card: str) -> dict:
    """Phase 4l (a) and (b). (a) DDP_RANKS ranks on the one card over gloo
    through torchrun and train_bce_dice's entry point at its CONFIG
    (resnet34-UNet, 512^2, global bs6, 3 a rank, bf16, BCE+Dice) on 4b's
    tree for one epoch, in each BN lane: the ranks' parameters and BN
    buffers equal bit for bit, channel_sums launched in each rank of the
    kernel lane (2 per BN and step) and in none of the torch lane's; the
    first fp32 step's gradient (TF32 off, 4e's weights and batch, draws at
    the global batch) equal across the ranks and no farther from the one-
    process fp32 step of its lane (4e) than 4e's limit between the lanes,
    twice the torch lane's fp32 distance from float64. (b) One rank with
    NCCL through the same entry point for one epoch."""
    common = ["--images_root", str(ir), "--masks_root", str(mr), "--epochs",
              "1", "--device", "cuda"]
    torch.save({"sd": ref["sd"], "imgs": ref["imgs"].cpu(),
                "masks": ref["masks"].cpu()}, tmp / "ddp_grad_in.pt")
    runs = {}
    for lane, switch in (("channel_sums", "force"), ("torch", "0")):
        out = tmp / f"ddp_{lane}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "grad_in.pt").symlink_to(tmp / "ddp_grad_in.pt")
        t0 = time.perf_counter()
        ranks = torchrun(out, DDP_RANKS, common + ["--out_dir",
                                                   str(out / "run")],
                         {"CARTSEG_PALLAS_BN": switch})
        wall = time.perf_counter() - t0
        r0, r1 = ranks
        diff = [k for k, v in r0["state"].items()
                if not torch.equal(v, r1["state"][k])]
        gdiff = [k for k, v in r0["grad"].items()
                 if not torch.equal(v, r1["grad"][k])]
        want = ref["grads"][lane]
        dist_one = _rel_l2({k: v.double() for k, v in r0["grad"].items()},
                           want)
        limit = 2 * ref["e_t"]
        steps = [r["steps"] for r in ranks]
        per_rank = [r["launches"]["channel_sums"] for r in ranks]
        expect = [2 * BCE_BN_LAYERS * s if switch == "force" else 0
                  for s in steps]
        others = {k: v for r in ranks for k, v in r["launches"].items()
                  if k != "channel_sums" and v}
        log(f"  (a) {lane} lane: {DDP_RANKS} ranks on cuda:"
            f"{r0['device']}/{r1['device']} over {r0['backend']}, "
            f"{steps[0]} steps of 3 rows each in {wall:.1f} s wall "
            f"(torchrun, init, val, sweep; the ranks' fits "
            f"{r0['wall']:.1f} / {r1['wall']:.1f} s); parameters and "
            f"buffers equal across the ranks: {len(diff) == 0} "
            f"({len(r0['state'])} tensors); channel_sums launches per rank "
            f"{per_rank} (want {expect}), in the fp32 step "
            f"{[r['grad_launches'] for r in ranks]}; arrival-counter rows "
            f"per rank {[r['counter_rows'] for r in ranks]}; first fp32 "
            f"step's gradient equal across the ranks: {len(gdiff) == 0}, "
            f"rel L2 to the one-process step {dist_one:.3e} (limit "
            f"{limit:.3e}, 2x the torch lane's fp32 distance from float64, "
            f"4e) [{card}]")
        if (diff or gdiff or per_rank != expect or others
                or not dist_one <= limit or r0["backend"] != "gloo"):
            raise AssertionError(f"4l (a) {lane} lane: state diff "
                                 f"{diff[:3]}, grad diff {gdiff[:3]}, "
                                 f"launches {per_rank} want {expect}, "
                                 f"others {others}, backend "
                                 f"{r0['backend']}")
        runs[lane] = {"launches": per_rank, "steps": steps[0],
                      "dist": dist_one, "wall": wall}
    out = tmp / "ddp_nccl"
    t0 = time.perf_counter()
    (r0,) = torchrun(out, 1, common + ["--out_dir", str(out / "run")],
                     {"CARTSEG_PALLAS_BN": "0"})
    wall = time.perf_counter() - t0
    log(f"  (b) one rank over {r0['backend']} through the entry point: "
        f"{r0['steps']} steps in {wall:.1f} s wall (DDP, BN sums "
        f"all-reduced by NCCL) [{card}]")
    if r0["backend"] != "nccl" or r0["steps"] <= 0:
        raise AssertionError(f"4l (b): backend {r0['backend']}, "
                             f"{r0['steps']} steps")
    runs["nccl"] = {"steps": r0["steps"], "wall": wall}
    return runs


def phase_shard(ckpts, frames: np.ndarray, dev, card: str) -> dict:
    """Phase 4l (c): pseudo_label_program through shard_inference_program
    over [cuda:0, cuda:0] on 4a's bs64 batch: each 32-row shard equal bit
    for bit to the unsharded program on the same rows, the whole batch
    within SHARD_TOL of the unsharded batch, cc, reach and the median
    launched by the sharded call."""
    from cartseg_tpu_torch.infer.engine import (load_member,
                                                pseudo_label_program)
    from cartseg_tpu_torch.infer.pseudo_labels import (IMAGENET_MEAN,
                                                       IMAGENET_STD)
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.parallel import shard_inference_program

    members = [load_member(p, device=dev) for p in ckpts]
    prog = pseudo_label_program(members, IMAGENET_MEAN, IMAGENET_STD,
                                min_area=int(S * S * 0.001))
    devs = [torch.device("cuda", torch.cuda.current_device())] * \
        SHARD_DEVICES
    sharded = shard_inference_program(prog, B, devs,
                                      log=lambda m: log(f"  {m}"))
    x = torch.from_numpy(frames).to(dev)
    build.reset_launch_counts()
    pred, probs, stats = sharded(x, 0.5)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in PSEUDO_KERNELS}
    k = B // SHARD_DEVICES
    bit = []
    for i in range(SHARD_DEVICES):
        rows = slice(i * k, (i + 1) * k)
        p1, q1, s1 = prog(x[rows], 0.5)
        bit.append(torch.equal(p1, pred[rows]) and torch.equal(q1, probs[rows])
                   and all(torch.equal(s1[n], stats[n][rows]) for n in s1))
    p0, q0, s0 = prog(x, 0.5)
    perr = float((q0 - probs).abs().max())
    far = (q0 - 0.5).abs() > SHARD_TOL
    serr = max(float((s0[n] - stats[n]).abs().max()) for n in s0)
    flips = int((p0 != pred).sum())
    log(f"  (c) pseudo_label_program over {SHARD_DEVICES} x cuda:"
        f"{devs[0].index} on 4a's [{B},{S},{S},3] batch: each {k}-row shard "
        f"equal bit for bit to the unsharded program on its rows: {bit}; "
        f"whole batch against the unsharded batch: probs max |d| "
        f"{perr:.3e}, QC stats max |d| {serr:.3e} (limit {SHARD_TOL:g}), "
        f"{flips} mask pixels differ ({int((p0 != pred)[far].sum())} of them "
        f"farther than {SHARD_TOL:g} from the threshold); launches "
        f"{launches} [{card}]")
    if (not all(bit) or perr > SHARD_TOL or serr > SHARD_TOL
            or not torch.equal(p0[far], pred[far])
            or min(launches.values()) <= 0):
        raise AssertionError("4l (c): the sharded program disagrees")
    return {"launches": launches, "perr": perr, "serr": serr}



# ------------------------------------------ seg_friendly without OpenCV

# fp32 operations of one bilateral tap, for the operations bound: three
# channels' multiply-add (an FMA counted as two) and the weight's
# multiply and add
BILATERAL_OPS_A_TAP = 3 * 2 + 2
# noise beside frame 0: the frame's size, ragged tiles both ways, and
# images narrower than the 7-pixel halo (reflected more than once)
BILATERAL_SHAPES = ((720, 1280), (37, 53), (5, 3), (1, 11))


def bilateral_bound(img: torch.Tensor) -> tuple:
    """The larger of the taps' fp32 operations at the fp32 peak and the
    image read and written once at the HBM rate."""
    from cartseg_tpu_torch.ops.filters import bilateral_tables

    h, w = img.shape[:2]
    taps = len(bilateral_tables(15, 100.0, 15.0)[2])
    t_ops = (h * w * taps * BILATERAL_OPS_A_TAP
             / PEAK_FLOPS[torch.float32] * 1e3)
    t_bytes, _ = bytes_bound(2 * nbytes(img))
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_bilateral(dev, card: str) -> dict:
    """Phase 3 (b): ops/filters.py bilateral_u8's CUDA kernel against its
    plain lane on the card, bit for bit, one launch a call: frame 0's
    stored cv2 decode (1280x720, BGR) and uint8 noise at
    BILATERAL_SHAPES. Then the kernel's device time on the frame beside
    its bound, and the plain lane's (CUDA events). No PyTorch call
    computes a bilateral filter."""
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.filters import bilateral_u8, bilateral_u8_plain
    from cartseg_tpu_torch.utils import image_io

    rgb = image_io.decode_png((FIXTURES / "frame_0.cv2.png").read_bytes())
    frame = torch.from_numpy(np.ascontiguousarray(rgb[..., ::-1])).to(dev)
    r = np.random.default_rng(SEED)
    inputs = [("bilateral frame_0", frame)] + [
        (f"bilateral noise {h}x{w}",
         torch.from_numpy(r.integers(0, 256, (h, w, 3), np.uint8)).to(dev))
        for h, w in BILATERAL_SHAPES]
    err = 0.0
    for name, x in inputs:
        build.reset_launch_counts()
        got = bilateral_u8(x)
        if build.LAUNCHES["bilateral"] != 1:
            raise AssertionError(f"{name}: {build.LAUNCHES['bilateral']} "
                                 "launches")
        err = max(err, check_equal(name, got, bilateral_u8_plain(x)))
    ms = device_ms(lambda: bilateral_u8(frame), 20, match="bilateral")
    plain = cuda_ms(lambda: bilateral_u8_plain(frame), 3)
    bound, by = bilateral_bound(frame)
    build.reset_launch_counts()
    log(f"  bilateral_u8 at 720x1280x3 (d 15, 149 taps): kernel "
        f"{ms:.4f} ms device time, 1 launch a call; bound {bound:.4f} ms "
        f"({by}), {bound / ms:.3f} of it; plain lane {plain:.2f} ms "
        f"(CUDA events) [{card}]")
    return {"err": err, "ms": ms, "plain_ms": plain, "bound": (bound, by)}



# phase 4m: the annotation path and the per-sample warp
ANNOTATE_JPEGS = ("frame_0", "frame_1", "frame_2", "frame_4")  # 1280x720
ANNOTATE_DISPLAY = 1024      # create_testset's --img_size
ANNOTATE_PROPOSER = 512      # its proposer's (create_testset.py:35-41)
ANNOTATE_SAVE = 512          # create_hard_masks' --save_size
ANNOTATE_WAIT_S = 30.0       # the longest a session waits for the worker
ANNOTATE_REPS = 20
BLUR_SIGMA = 2.5             # smooth_mask's sigma at k = 5
# the per-sample warp, card against CPU on the same draws: |d| of the
# normalised image (x / 255 at train_512 without ImageNet norm) within
# 1e-2 / 255 on WARP_SHARE of the values, masks equal on WARP_SHARE (a
# coordinate on a pixel edge may round across it on one device)
WARP_TOL, WARP_SHARE = 1e-2 / 255, 0.999


class RecordingSam:
    """The port's predictor as a session drives it, recording each
    prompt, the item it was made for, its mask and predict's host ms."""

    def __init__(self, pred):
        self.pred, self.item, self.calls = pred, None, []

    def embed(self, img):
        return self.pred.embed(img)

    def set_embedding(self, e):
        self.pred.set_embedding(e)

    def predict(self, **kw):
        t0 = time.perf_counter()
        out = self.pred.predict(**kw)
        self.calls.append((self.item, kw, out[0].copy(),
                           (time.perf_counter() - t0) * 1e3))
        return out


def annotate_session(A, item, sam, out: Path) -> tuple:
    """create_testset's edits on one item: r (the random-weight
    proposal covers the frame), clicks, a negative click, a box, brush
    strokes with a hole between them, f, m, a click with smoothing off,
    then a save at the original size and at ANNOTATE_SAVE^2. Returns the
    session and the host ms of its first prompt (decode, postprocess,
    smooth)."""
    n = ANNOTATE_DISPLAY
    s = A.AnnotationSession(item.image_rgb, item.proposal, sam,
                            embedding=item.sam_features, device="cuda")
    if item.proposal.shape != (ANNOTATE_PROPOSER,) * 2 or \
            item.proposal.dtype != np.uint8:
        raise AssertionError(f"4m: proposal {item.proposal.shape} "
                             f"{item.proposal.dtype}")
    s.reset()
    t0 = time.perf_counter()
    s.apply_points([(n // 2, n // 2), (n // 2 + 28, n // 2 - 12)], [1, 1])
    first_ms = (time.perf_counter() - t0) * 1e3
    s.apply_points([(n // 5, 4 * n // 5)], [0])
    s.apply_box((3 * n // 10, n // 3, 7 * n // 10, 3 * n // 4))
    ring = [(int(n // 8 + 40 * np.cos(a)), int(n // 8 + 40 * np.sin(a)))
            for a in np.linspace(0, 2 * np.pi, 90)]
    s.brush(ring, 1, 6)
    s.brush([(n - 3, n // 2), (n - 1, n // 2 + 5)], 1, 6)
    s.fill_holes()
    s.toggle_smoothing()
    s.apply_points([(3 * n // 5, 3 * n // 5)], [1])
    stem = item.path.stem
    s.save(out / "orig" / f"{stem}.png", orig_hw=item.orig_hw)
    s.save(out / "fixed" / f"{stem}.png", size=ANNOTATE_SAVE)
    return s, first_ms


def phase_annotate(tmp: Path, member_pth: Path, sam_pth: Path,
                   card: str) -> dict:
    """Phase 4m (a): the annotation path on the card, cv2 and PIL refused
    by the caller: a Proposer (effnet-b0, bf16) and the SAM ViT-B
    predictor, a PrefetchWorker over 1280x720 JPEG fixtures at
    create_testset's display size with its default seg_friendly
    preprocessing (make_easy, on the card), and a scripted session on
    each item (annotate_session). Each session starts once the worker has
    two items queued (a user edits for seconds), so the predictor's thread
    has embedded later images before every prompt. Fails unless each
    prompt's mask equals set_image + predict on its image alone, the saved
    PNGs decode to the session's mask, SAM's flash kernel ran 4 times an
    item, the bilateral kernel once an item and CC once a hole fill
    (counts, and the kernels in CUDA graphs of one call), the card's
    seg_friendly of frame 0's stored cv2 decode equals cv2's stored
    seg_friendly of it bit for bit, fill_holes, smooth_mask and
    gaussian_blur_u8 on the card equal their CPU lanes bit for bit, and
    the arrival-counter rows in use are the same after the phase as
    before it."""
    from cartseg_tpu_torch import geometry as G
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda import channel_sums as cs
    from cartseg_tpu_torch.ops.cuda import soft_dice as sdice
    from cartseg_tpu_torch.ops.filters import gaussian_blur_u8
    from cartseg_tpu_torch.tools import annotate as A
    from cartseg_tpu_torch.utils import image_io

    rows_before = (len(cs._ARRIVALS.rows), len(sdice._ARRIVALS.rows))
    paths = [FIXTURES / f"{n}.jpeg" for n in ANNOTATE_JPEGS]
    out = tmp / "annotate"
    t0 = time.perf_counter()
    proposer = A.Proposer(member_pth, img_size=ANNOTATE_PROPOSER,
                          device="cuda")
    sam = RecordingSam(A.load_sam(sam_pth, device="cuda"))
    load_s = time.perf_counter() - t0
    build.reset_launch_counts()
    worker = A.PrefetchWorker(paths, proposer, sam,
                              img_size=ANNOTATE_DISPLAY, make_easy=True,
                              device="cuda").start()
    items, waits, sessions, first_ms = [], [], [], []
    feed = iter(worker)
    while True:
        t0 = time.perf_counter()
        item = next(feed, None)
        if item is None:
            break
        waits.append((time.perf_counter() - t0) * 1e3)
        deadline = time.perf_counter() + ANNOTATE_WAIT_S
        while (not worker.queue.full() and worker._thread.is_alive()
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        sam.item = len(items)
        s, ms = annotate_session(A, item, sam, out)
        items.append(item)
        sessions.append(s)
        first_ms.append(ms)
    worker.join()
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in ("flash_fwd", "cc",
                                                "bilateral")}
    want = {"flash_fwd": SAM_GLOBAL_BLOCKS * len(paths), "cc": len(paths),
            "bilateral": len(paths)}
    log(f"  {len(items)} items through the PrefetchWorker (display "
        f"{ANNOTATE_DISPLAY}^2, proposer {ANNOTATE_PROPOSER}^2, models "
        f"loaded in {load_s:.1f} s), {len(sam.calls)} prompts; launches "
        f"{launches} (want {want})")
    if len(items) != len(paths) or launches != want:
        raise AssertionError("4m: the annotation path's items or launches "
                             "are off")

    # each prompt against its image alone: set_image, then predict
    pred, worst = sam.pred, 0.0
    for k, item in enumerate(items):
        pred.set_image(item.image_rgb)
        worst = max(worst, float((pred.features - item.sam_features.features)
                                 .abs().max()))
        for kk, kw, mask, _ in sam.calls:
            if kk == k and not np.array_equal(pred.predict(**kw)[0], mask):
                raise AssertionError(f"4m: a prompt on item {k} decoded "
                                     "against another embedding")
    apart = float((items[0].sam_features.features
                   - items[1].sam_features.features).abs().max())
    log(f"  every prompt's mask equals set_image + predict on its own "
        f"image; the worker's embedding against set_image's max |d| "
        f"{worst:.3e}; two images' embeddings {apart:.3e} apart")
    if apart == 0.0:
        raise AssertionError("4m: the images' embeddings are equal")

    # the saved PNGs decode to the session's mask
    for item, s in zip(items, sessions):
        oh, ow = item.orig_hw
        got_o = image_io.read_gray(out / "orig" / f"{item.path.stem}.png")
        got_f = image_io.read_gray(out / "fixed" / f"{item.path.stem}.png")
        if not (np.array_equal(got_o, G.remove_letterbox(s.state.mask, ow,
                                                          oh))
                and np.array_equal(got_f, G.resize_nearest(
                    s.state.mask, (ANNOTATE_SAVE, ANNOTATE_SAVE)))):
            raise AssertionError(f"4m: {item.path.stem}'s saved masks "
                                 "differ from the session's")
    fg = [float((s.state.mask > 127).mean()) for s in sessions]
    log(f"  saved masks ({oh}x{ow} and {ANNOTATE_SAVE}^2, the port's PNG "
        f"codec) decode to the sessions' masks; fg share "
        f"{min(fg):.3f}..{max(fg):.3f}")

    # the card's seg_friendly against cv2's (make_jpeg_fixtures.py's
    # frame_0.seg_friendly.cv2.png): bit-equal on this frame, where the
    # port's CPU lanes (which the card's equal) are too
    # (tools/seg_friendly_against_cv2.py); on other frames IPP's
    # bilateral quotient rounds a few values the other way
    decoded = image_io.decode_png((FIXTURES / "frame_0.cv2.png").read_bytes())
    want_sf = image_io.decode_png(
        (FIXTURES / "frame_0.seg_friendly.cv2.png").read_bytes())
    got_sf = A.seg_friendly(np.ascontiguousarray(decoded[..., ::-1]),
                            "cuda")[..., ::-1]
    sf_ms = cuda_ms(lambda: A.seg_friendly(decoded, "cuda"), 5)
    log(f"  seg_friendly of frame_0's cv2 decode on the card: "
        f"{int((got_sf != want_sf).sum())} values differ from cv2's stored "
        f"seg_friendly; {sf_ms:.2f} ms a 1280x720 frame with its copies "
        f"(CUDA events) [{card}]")
    if not np.array_equal(got_sf, want_sf):
        raise AssertionError("4m: seg_friendly on the card differs from "
                             "cv2's")

    # the card's image ops against their CPU lanes, bit for bit: the
    # sessions' masks, blob masks with holes, a noise mask
    from cartseg_tpu_torch.utils.synthetic import blob_masks

    r = np.random.default_rng(SEED)
    shape = (2, ANNOTATE_DISPLAY, ANNOTATE_DISPLAY)
    holes = blob_masks(r, shape, 12) & ~blob_masks(r, shape, 30)
    masks = [s.state.mask for s in sessions] + [
        (h * 255).astype(np.uint8) for h in holes] + [
        ((r.random((ANNOTATE_DISPLAY,) * 2) < 0.5) * 255).astype(np.uint8)]
    noise = r.integers(0, 256, (ANNOTATE_DISPLAY,) * 2).astype(np.uint8)
    checks = 0
    for m in masks:
        cpu = torch.from_numpy(m)
        gpu = cpu.cuda()
        for name, fn in (("fill_holes", A.fill_holes),
                         ("smooth_mask k5", A.smooth_mask),
                         ("smooth_mask k9 x2",
                          lambda t: A.smooth_mask(t, 9, 2)),
                         ("gaussian_blur_u8",
                          lambda t: gaussian_blur_u8(t, BLUR_SIGMA))):
            if not torch.equal(fn(gpu).cpu(), fn(cpu)):
                raise AssertionError(f"4m: {name} on the card differs from "
                                     "the CPU lane")
            checks += 1
    cpu = torch.from_numpy(noise)
    if not torch.equal(gaussian_blur_u8(cpu.cuda(), BLUR_SIGMA).cpu(),
                       gaussian_blur_u8(cpu, BLUR_SIGMA)):
        raise AssertionError("4m: gaussian_blur_u8 on uint8 noise differs")
    log(f"  {checks + 1} card-against-CPU checks bit-equal at "
        f"{ANNOTATE_DISPLAY}^2: fill_holes, smooth_mask (k 5; k 9, 2 "
        f"iterations) and gaussian_blur_u8 (sigma {BLUR_SIGMA}) on the "
        f"sessions' masks, 2 blob masks with holes and a noise mask, the "
        f"blur on uint8 noise")

    # the kernels in CUDA graphs of one call
    m_dev = torch.from_numpy(masks[len(sessions)]).cuda()
    cc_nodes = [n for kind, n in graph_nodes(lambda: A.fill_holes(m_dev))
                if kind == "KERNEL" and "cc_" in n]
    model = pred.model
    with torch.inference_mode():
        x_dev = model.preprocess(
            torch.from_numpy(items[0].image_rgb).cuda()[None])

    @torch.inference_mode()
    def encode():
        model.encode_image(x_dev)

    encode()
    fa_nodes = [n for kind, n in graph_nodes(encode)
                if kind == "KERNEL" and F32_FWD_SYMBOL in n]
    log(f"  CUDA graph of one fill_holes at {ANNOTATE_DISPLAY}^2: CC "
        f"kernels {cc_nodes}; of one embedding: {len(fa_nodes)} x "
        f"{F32_FWD_SYMBOL}")
    if not any("cc_tiles" in n for n in cc_nodes) or \
            len(fa_nodes) != SAM_GLOBAL_BLOCKS:
        raise AssertionError("4m: the graphs miss the CC or flash kernels")

    rows_after = (len(cs._ARRIVALS.rows), len(sdice._ARRIVALS.rows))
    log(f"  arrival-counter rows in use (channel_sums, soft_dice): before "
        f"{rows_before}, after {rows_after}")
    if rows_after != rows_before:
        raise AssertionError("4m: the prefetch thread took a counter row")

    # timings
    for k, item in enumerate(items):
        t = item.timings
        log(f"  item {k} ({item.path.name}) prepared in "
            f"{sum(t.values()) * 1e3:.2f} ms: read (nvJPEG) "
            f"{t['read'] * 1e3:.2f}, seg_friendly "
            f"{t['seg_friendly'] * 1e3:.2f}, letterbox "
            f"{t['letterbox'] * 1e3:.2f}, "
            f"proposer {t['propose'] * 1e3:.2f}, SAM embed "
            f"{t['embed'] * 1e3:.2f}; the consumer waited {waits[k]:.2f} ms "
            f"for it; its first prompt {first_ms[k]:.2f} ms [{card}]")
    kw = sam.calls[0][1]
    pred.set_embedding(items[0].sam_features)
    coords, labels = pred._prompt_tokens(kw.get("point_coords"),
                                         kw.get("point_labels"),
                                         kw.get("box"))
    c_dev = torch.from_numpy(coords)[None].cuda()
    l_dev = torch.from_numpy(labels)[None].cuda()
    with torch.inference_mode():
        low = model.decode(pred.features, c_dev, l_dev)[0]
        dec = cuda_ms(lambda: model.decode(pred.features, c_dev, l_dev),
                      ANNOTATE_REPS)
        post = cuda_ms(lambda: pred._postprocess(low), ANNOTATE_REPS)
    predict_ms = float(np.median([c[3] for c in sam.calls]))
    smooth = cuda_ms(lambda: A.smooth_mask(m_dev), ANNOTATE_REPS)
    fill = cuda_ms(lambda: A.fill_holes(m_dev), ANNOTATE_REPS)
    log(f"  a prompt: decode {dec:.3f} ms, postprocess {post:.3f} ms (CUDA "
        f"events), predict {predict_ms:.2f} ms (host, median of "
        f"{len(sam.calls)}); smooth_mask {smooth:.3f} ms, fill_holes "
        f"{fill:.3f} ms at {ANNOTATE_DISPLAY}^2 (CUDA events) [{card}]")
    prep = [float(np.median([i.timings[k] * 1e3 for i in items]))
            for k in ("read", "seg_friendly", "letterbox", "propose",
                      "embed")]
    return {"launches": launches, "waits": waits, "first_ms": first_ms,
            "predict_ms": predict_ms, "smooth_ms": smooth, "fill_ms": fill,
            "prep": prep, "decode_ms": dec, "post_ms": post,
            "seg_friendly_ms": sf_ms}


def phase_per_sample_warp(dev, card: str) -> dict:
    """Phase 4m (b): augment_batch's pipeline with per_sample_warp at
    train_512 (bs6, 512^2) on the card against the CPU lane on the same
    draws. chip_smoke holds no warp to the CPU otherwise; this one's
    gather differs from the shared warp's (one index per pixel of the
    flattened batch instead of one per pixel of the plane), and a fault
    in its index arithmetic or its gather on the card would show only
    there. Its rows' parameters must differ."""
    import dataclasses

    from cartseg_tpu_torch.data import augment as AUG

    cfg = dataclasses.replace(AUG.AugmentConfig.train_512(),
                              per_sample_warp=True)
    imgs, masks = bce_batch(S, TRAIN_BS, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    U, u, noise = AUG.draw_augment(gen, TRAIN_BS, S, S, cfg, dev)
    angle = AUG.draw_warp_params(u, cfg, S, S)[0]
    gi, gm = AUG.apply_augment(imgs, masks, cfg, U, u, noise)
    ci, cm = AUG.apply_augment(imgs.cpu(), masks.cpu(), cfg, U.cpu(),
                               u.cpu(), noise.cpu())
    d = (gi.cpu() - ci).abs()
    share = float((d <= WARP_TOL).float().mean())
    mshare = float((gm.cpu() == cm).float().mean())
    ms = cuda_ms(lambda: AUG.augment_batch(gen, imgs, masks, cfg),
                 ANNOTATE_REPS)
    log(f"  per-sample warp, train_512 bs{TRAIN_BS} {S}^2: row angles "
        f"{[round(float(a), 2) for a in angle.cpu()]}; card against CPU "
        f"on the same draws: max |d| {float(d.max()):.3e}, {share:.6f} of "
        f"the values within {WARP_TOL:.2e} (limit share {WARP_SHARE}), "
        f"masks equal on {mshare:.6f}; augment_batch {ms:.3f} ms (CUDA "
        f"events) [{card}]")
    if (len(set(angle.cpu().tolist())) < 2 or share < WARP_SHARE
            or mshare < WARP_SHARE):
        raise AssertionError("4m: the per-sample warp is off")
    return {"max": float(d.max()), "ms": ms}

def main() -> int:
    from cartseg_tpu_torch.device import require_cuda

    dev = require_cuda()
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}); torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}")

    from cartseg_tpu_torch.ops.cuda import build

    walls, mark = {}, [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        walls[name] = now - mark[0]
        mark[0] = now

    log("phase 2: build")
    t0 = time.perf_counter()
    build.load_library()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")
    from cartseg_tpu_torch.ops.cuda.flash_attention import MAX_GRID

    report = ptxas_report(build.BUILD_LOG["text"])
    for name, used, spill in report:
        log(f"  ptxas: {name[:90]}: {used}; {spill or 'no spill report'}")
    cc_occupancy(report)
    for name, used, _ in report:
        if any(sym in name for sym in F32_SYMBOLS):
            # template arguments <HD, G64>, demangled or not
            targs = (name.split("<", 1)[1] if "<" in name
                     else name.split("ILi", 1)[-1])
            hd = 64 if targs.startswith("64") else 32
            g64 = "true" in targs or "Lb1E" in targs
            regs = int(used.split("Used ")[1].split()[0])
            # the general-g kernels at the largest grid the wrappers take
            g = 64 if g64 else MAX_GRID
            smem = f32_smem(name, hd, g)
            log(f"  {name}: {regs} registers, {smem} bytes of dynamic "
                f"shared memory at g = {g}: {blocks_an_sm(regs, smem)} "
                f"blocks an SM")

    from cartseg_tpu_torch.utils.synthetic import make_png_tree

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        t0 = time.perf_counter()
        images = make_png_tree(tmp, SESSIONS, B, FRAME_HW, seed=SEED)
        frames = load_frames(images)
        log(f"  synthetic tree: {SESSIONS}x{B} PNG frames "
            f"{FRAME_HW[1]}x{FRAME_HW[0]} in {time.perf_counter() - t0:.1f} s")

        phase_done("1-2")
        log("phase 3: kernels against their plain versions")
        errs = phase_compare(frames, dev)
        fwd_errs = phase_compare_flash(dev)
        errs["flash_fwd"] = fwd_errs[FLASH_CASES[0]]
        errs["flash_fwd_tc"] = fwd_errs[FLASH_CASES[1]]
        bwd_errs = phase_compare_flash_bwd(dev)
        errs.update(bwd_errs[FLASH_CASES[1]])
        errs.update({f"{k}_f32": e
                     for k, e in bwd_errs[FLASH_CASES[0]].items()})
        errs["channel_sums"] = phase_compare_channel_sums(dev)
        errs.update(phase_compare_zoo(dev))
        bilateral = phase_bilateral(dev, card)
        errs["bilateral"] = bilateral["err"]

        phase_done("3")
        log("phase 4a: pseudo-label workload")
        launches, ckpts = phase_workload(tmp, dev)
        phase_reference(ckpts, frames, dev)

        phase_done("4a")
        log("phase 4b: training workload (train_bce_dice_abl)")
        ir, mr = make_train_tree(tmp)
        train_launches, hist = phase_train_workload(tmp, dev, ir, mr)
        phase_train_reference(dev)

        phase_done("4b")
        log("phase 4c: SAM ViT-B predictor (tools/annotate.load_sam)")
        sam_launches, pred, sam_frames = phase_sam(tmp, dev)
        phase_sam_reference(tmp, pred, sam_frames, dev)

        phase_done("4c")
        log("phase 4d: SAM ViT-B encoder fine-tune step")
        sam_train = phase_sam_train(tmp, dev)

        phase_done("4d")
        log("phase 4e: BCE+Dice training workload (train_bce_dice), both "
            "BN lanes")
        bce_runs = phase_bce_workload(tmp, dev, ir, mr)
        bce_ref = phase_bce_reference(dev)
        # what phase 4l holds its data-parallel step against
        ddp_ref = {"sd": {k: v.cpu() for k, v in bce_ref["sd"].items()},
                   "imgs": bce_ref["imgs"].cpu(),
                   "masks": bce_ref["masks"].cpu(), "e_t": bce_ref["e_t"],
                   "grads": {lane: {k: v.cpu() for k, v in
                                    bce_ref["outs"][lane][1].items()}
                             for lane in BN_LANES}}

        phase_done("4e")
        log("phase 4f: the loss zoo through cartseg_tpu_torch.losses")
        zoo_launches = phase_loss_zoo(dev)

        phase_done("4f")
        log("phase 4g: SDF boundary-loss training workload "
            "(train_with_boundary_loss)")
        phase_boundary_workload(tmp, dev, ir, mr)

        phase_done("4g")
        log("phase 4h: camera JPEGs with cv2 and PIL refused: nvJPEG, the "
            "native loader, the pretrained-encoder and CONFIG workloads, "
            "pseudo-labels")
        with refuse_modules("cv2", "PIL"):
            jpeg_against_cv2(dev)
            jir, jmr, jmr_plain = make_jpeg_tree(tmp)
            pretrained = phase_pretrained_workload(tmp, jir, jmr)
            phase_config_workloads(tmp, jir, jmr, jmr_plain)
            pseudo_jpeg = phase_pseudo_jpeg(tmp, pretrained["pth"])

        phase_done("4h")
        log("phase 4i: mixed-source fine-tuning, UNet++, remat, traces and "
            "the classic UNet, cv2 and PIL refused")
        with refuse_modules("cv2", "PIL"):
            roots = make_mixed_sources(tmp)
            finetunes = phase_finetune_workloads(tmp, roots)
            unetpp = phase_bce_workload(tmp, dev, ir, mr, "unetpp_ds", 1,
                                        UNETPP_BN_LAYERS)
            phase_bce_reference(dev, ["--decoder", "unetpp_ds"],
                                UNETPP_BN_LAYERS)
            phase_remat(dev, bce_ref, card)
            del bce_ref
            phase_classic(dev)

        phase_done("4i")
        log("phase 4j: the cleaning, mining, ranking and evaluation "
            "toolchain, cv2, PIL and pandas refused")
        t0 = time.perf_counter()
        with refuse_modules("cv2", "PIL", "pandas"):
            pseudo_out = pseudo_jpeg["out_dir"]
            cleaned = phase_clean_workloads(tmp, jir, jmr, pseudo_out, dev)
            phase_unpad_and_copy(tmp, pseudo_jpeg["images"], pseudo_out, jir,
                                 cleaned["complete"]["dst"])
            phase_rank(tmp, pseudo_out)
            phase_mining(tmp, pretrained["pth"], pseudo_jpeg["images"], dev)
            phase_evaluate(pretrained["pth"], jir, jmr, tmp)
            phase_sobel(ckpts, frames, dev)
        log(f"  phase 4j wall: {time.perf_counter() - t0:.1f} s")
        phase_done("4j")

        log("phase 4k: serving: the torch.export artifact and the "
            "micro-batching HTTP server, cv2 and PIL refused")
        with refuse_modules("cv2", "PIL"):
            serve = phase_serve(tmp, tmp / "run_bce_unet_torch" /
                                "model.pth", frames, dev, card)
        phase_done("4k")
        log("phase 4l: data parallelism: DDP over gloo on one card, one "
            "NCCL rank, the sharded inference program")
        ddp = phase_ddp_train(tmp, ir, mr, ddp_ref, card)
        del ddp_ref
        shard = phase_shard(ckpts, frames, dev, card)
        phase_done("4l")
        log("phase 4m: SAM-assisted annotation on the card with its "
            "seg_friendly preprocessing, cv2 and PIL refused; the "
            "per-sample warp")
        with refuse_modules("cv2", "PIL"):
            annotate = phase_annotate(tmp, ckpts[0],
                                      tmp / "sam_vit_b_seed0.pth", card)
            warp = phase_per_sample_warp(dev, card)
        phase_done("4m")

        log("phase 5: timing")
        timing = phase_timing(ckpts, frames, dev, card)
        train_timing = phase_train_timing(dev, card, hist)
        sam_timing = phase_sam_timing(pred, sam_frames, dev, card)
        sam_train_timing = phase_sam_train_timing(sam_train, dev, card)
        bce_timing = phase_bce_timing(dev, card)
        zoo_timing = phase_zoo_timing(dev, card)
        phase_boundary_timing(dev, card)
        with refuse_modules("cv2", "PIL"):
            phase_jpeg_timing(dev, jir, jmr, pretrained["pth"], pseudo_jpeg,
                              card)
            phase_finetune_timing(dev, finetunes, unetpp, card)
        with refuse_modules("cv2", "PIL", "pandas"):
            phase_toolchain_timing(dev, pretrained["pth"],
                                   pseudo_jpeg["images"], jmr, card)
        phase_done("5")

    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})
    launches.update({k: sam_launches[k] for k in SAM_KERNELS})
    times = {**timing["kernels"], **train_timing["kernels"]}
    bounds = {**timing["bounds"], **train_timing["bounds"]}
    library = {**timing["library"], **train_timing["library"]}
    f_ms, f_plain, f_lib, f_b, f_by = sam_timing["flash"][torch.float32]
    times["flash_fwd"] = (f_ms, f_plain)
    bounds["flash_fwd"] = (f_b, f_by)
    library["flash_fwd"] = f_lib
    # the bf16 forward's and the backward kernels' rows: the fine-tune
    # step's bf16 inputs
    launches["flash_fwd_tc"] = sam_train["launches"]["flash_fwd_tc"]
    ms, plain, lib, b, by = sam_train_timing["fwd"]
    times["flash_fwd_tc"] = (ms, plain)
    bounds["flash_fwd_tc"], library["flash_fwd_tc"] = (b, by), lib
    for k in BWD_KERNELS:
        launches[k] = sam_train["launches"][k]
        ms, plain, lib, b, by = sam_train_timing["kernels"][torch.bfloat16][k]
        times[k], bounds[k], library[k] = (ms, plain), (b, by), lib
        # the fp32 route: phase 4d's fp32 flash-lane step, and the kernels
        # at its inputs in fp32
        f = f"{k}_f32"
        launches[f] = sam_train["f32_launches"][k]
        ms, plain, lib, b, by = sam_train_timing["kernels"][torch.float32][k]
        times[f], bounds[f], library[f] = (ms, plain), (b, by), lib
    # channel_sums: the kernel-lane workload run's count; device times
    # (profiler) at the decoder top's backward sums, the path's largest
    # launch, whose wall time the host's enqueueing sets
    launches["channel_sums"] = bce_runs["channel_sums"]["launches"][
        "channel_sums"]
    ms, plain, lib, b, by = bce_timing
    times["channel_sums"] = (ms, plain)
    bounds["channel_sums"], library["channel_sums"] = (b, by), lib
    # the loss zoo's kernels: phase 4f's counts; device times (profiler) at
    # the first path shape of each
    for k in ZOO_KERNELS:
        launches[k] = zoo_launches[k]
        ms, plain, lib, b, by = zoo_timing[k]
        times[k], bounds[k], library[k] = (ms, plain), (b, by), lib
    # the bilateral filter: phase 4m's count (one a seg_friendly), phase
    # 3's times at 1280x720; no PyTorch call computes it
    launches["bilateral"] = annotate["launches"]["bilateral"]
    times["bilateral"] = (bilateral["ms"], bilateral["plain_ms"])
    bounds["bilateral"], library["bilateral"] = bilateral["bound"], None
    # the tail of the output keeps these, whatever phase 5 printed
    log(f"4k serving: {serve['batch_ms']:.3f} ms a device batch of "
        f"{SERVE_BS}, {serve['img_s']:.1f} img/s; request latency p50 "
        f"{serve['p50']:.1f} ms, p99 {serve['p99']:.1f} ms at "
        f"max_latency_ms {SERVE_LATENCY_MS:g}; {serve['per_call']:.2f} "
        f"requests a device call [{card}]")
    log("4l data parallel: " + "; ".join(
        f"{lane} lane channel_sums a rank {ddp[lane]['launches']} in "
        f"{ddp[lane]['steps']} steps, first-step gradient rel L2 "
        f"{ddp[lane]['dist']:.3e}, {ddp[lane]['wall']:.1f} s"
        for lane in BN_LANES) + f"; NCCL rank {ddp['nccl']['steps']} "
        f"steps; sharded program launches {shard['launches']}, probs "
        f"{shard['perr']:.3e}, stats {shard['serr']:.3e} [{card}]")
    log(f"4m annotation: consumer waits {fmt_list(annotate['waits'])} ms, "
        f"first prompts {fmt_list(annotate['first_ms'])} ms, predict "
        f"{annotate['predict_ms']:.2f} ms, smooth_mask "
        f"{annotate['smooth_ms']:.3f} ms, fill_holes "
        f"{annotate['fill_ms']:.3f} ms at {ANNOTATE_DISPLAY}^2; launches "
        f"{annotate['launches']}; an item's read / seg_friendly / "
        f"letterbox / proposer / embed ms (median) "
        f"{fmt_list(annotate['prep'])}; decode "
        f"{annotate['decode_ms']:.3f}, postprocess "
        f"{annotate['post_ms']:.3f} ms; seg_friendly "
        f"{annotate['seg_friendly_ms']:.2f} ms a frame; per-sample warp "
        f"max |d| {warp['max']:.3e} [{card}]")
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in walls.items())
        + f"; total {sum(walls.values()):.1f}")
    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[k], "max_abs_err": errs[k],
         "ms": times[k][0], "plain_ms": times[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": library[k]}
        for k, (src, rep) in KERNELS.items()]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        # one rank of phase 4l under torchrun: --ddp-worker OUT -- ARGS
        ddp_worker(Path(sys.argv[2]), sys.argv[4:])
        sys.exit(0)
    sys.exit(main())
