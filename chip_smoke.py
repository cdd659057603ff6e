#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (cartseg_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card's name and power limit (nvidia-smi); require_cuda();
  2. build the CUDA kernels from ops/cuda/csrc (nvcc), print the time
     and each kernel's registers and spills (-Xptxas -v);
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs: CC at 8- and 4-connectivity on [64,512,512] masks
     (blobs, uniform noise p=0.45, all-background, all-foreground, a
     one-arm 512^2 spiral, cut rings); reach on the weak/strong maps of
     Canny runs on the synthetic frames; the median on |p-0.5|*2 rows of
     [64,262144], rows with many duplicates and all-zero rows; the EDT
     on [6,512,512] GT boundaries of blob masks plus a no-seed, a
     single-seed and an all-seed sample - all bit for bit (torch.equal
     after synchronize); the LSR CE forward and backward on
     [6,512,512,8] logits with labels 0..7 and every 7th row ignored,
     loss atol 1e-5 and gradient atol 2e-6 at unit g; the decomposed
     rel-pos flash attention at the ViT-B global block [12,4096,64]
     (max abs err within 1e-5 of max |plain| in fp32, 3e-2 in bf16) and
     at the tests' [2,256,32] fp32; its training forward's lse (1e-5 of
     max |plain|, out bit-equal to the inference call's) and the two
     backward kernels' five gradients at the same shapes (1e-5 of max
     |plain| in fp32, 1e-2 in bf16); channel_sums at resnet34-UNet's BN
     inputs at 512^2 bs6 (the stem [6,64,256,256], a layer3 BN
     [6,256,32,32], the decoder's 16-channel top [6,16,512,512]),
     channels_last and contiguous, fp32 and bf16, (x, x) and (dy, x),
     within 1e-5 of the per-channel sum of |.| and the same bits on a
     second call;
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
        flash_fwd, flash_bwd_dq and flash_bwd_dkv launched 4 times each
        per step, finite loss, a finite non-zero gradient on every encoder
        parameter and none on the prompt encoder or decoder; then the
        flash lane against the plain lane (global_attn_flash=False) on the
        same weights: fp32 with TF32 off, per-parameter gradient relative
        L2 <= 1e-4 and loss <= 1e-5 relative; bf16, loss <= 1e-3 relative
        and sum |grad| within 5 %;
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
  5. timing with CUDA events: the pseudo-label program per bs64 batch,
     the train step at bs6@512^2 (device-resident batch, loader
     excluded) and the ABL loss's share of it, SAM's set_image and
     predict and the global blocks' share of set_image, the SAM fine-tune
     step for both lanes with the global blocks' share and the device's
     busy share, the BCE+Dice step in both BN lanes at 512^2 bs6 and at
     bench.py's train half (224^2 bs128) with the BN layers' share and
     the busy share, and each kernel against its plain version and,
     where one PyTorch call computes the same function, that call, at
     the path's shapes, beside its bound (channel_sums: per launch at
     the stem, a layer3 BN and the decoder top, and over one step's 92
     calls, against torch.batch_norm_stats and
     torch.batch_norm_backward_reduce).
The line before the last holds the kernels' JSON record, the one before
it the card's name and power limit, and the last line
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
    "flash_bwd_dq": ("cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd.cu",
                     "cartseg_tpu/ops/pallas/flash_attention.py:179"),
    "flash_bwd_dkv": ("cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd.cu",
                      "cartseg_tpu/ops/pallas/flash_attention.py:232"),
    "channel_sums": ("cartseg_tpu_torch/ops/cuda/csrc/channel_sums.cu",
                     "cartseg_tpu/ops/pallas/channel_sums.py:39"),
}
PSEUDO_KERNELS = ("cc", "reach", "median")
TRAIN_KERNELS = ("edt", "lsr_fwd", "lsr_bwd")
SAM_KERNELS = ("flash_fwd",)
SAM_TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
BWD_KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
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
# flash kernel vs plain: max abs error over the plain output's max |value|
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
# backward kernels vs plain, the same measure: in bf16 both sides sum in
# fp32 from the same inputs and round once to bf16, so they differ by at
# most one bf16 step (2^-7 = 7.8e-3 of a value)
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (bnh, g, head_dim, type) of the flash kernels' checks against their
# plain versions: the ViT-B global block in fp32 and bf16, the tests' size
FLASH_CASES = ((12, 64, 64, torch.float32), (12, 64, 64, torch.bfloat16),
               (2, 16, 32, torch.float32))
SAM_FRAMES = ((1024, 1024),) * 3 + ((512, 512),)   # create_testset, hard
SAM_GLOBAL_BLOCKS = 4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense FLOP/s
# of fp32 outside the tensor cores and of bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


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


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bytes_bound(n: int) -> tuple:
    """(bound_ms, "bytes"): n bytes, each input read once and each output
    written once, at the card's HBM rate."""
    return n / HBM_BYTES_PER_S * 1e3, "bytes"


def flash_bound(q: torch.Tensor, rel_h: torch.Tensor) -> tuple:
    """The larger of the two products' FLOPs (4*bnh*S^2*hd) at the peak
    for q's type and q, k, v, rel_h, rel_w, out once at the HBM rate."""
    bnh, S, hd = q.shape
    t_ops = 4.0 * bnh * S * S * hd / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes, _ = bytes_bound(4 * q.numel() * q.element_size()
                             + 2 * nbytes(rel_h))
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bwd_bound(q: torch.Tensor, rel_h: torch.Tensor, kernel: str) -> tuple:
    """The larger of the products' FLOPs (2*bnh*S^2*hd each: 3 for dq,
    q k^T, dO v^T, dS K; 4 for dkv, q k^T, dO v^T, P^T dO, dS^T Q) at the
    peak for q's type and the kernel's bytes at the HBM rate: q, k, v, dO,
    rel_h, rel_w and the fp32 lse and D read once; dq, drel_h, drel_w or
    dk, dv written once."""
    bnh, S, hd = q.shape
    dq = kernel == "flash_bwd_dq"
    t_ops = ((3 if dq else 4) * 2.0 * bnh * S * S * hd
             / PEAK_FLOPS[q.dtype] * 1e3)
    qb, rb = nbytes(q), nbytes(rel_h)
    written = qb + 2 * rb if dq else 2 * qb
    t_bytes, _ = bytes_bound(4 * qb + 2 * rb + 2 * bnh * S * 4 + written)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sums_bound(a: torch.Tensor, b: torch.Tensor, same: bool) -> tuple:
    """channel_sums(a, b): a (and b unless it is a) read once, the two
    fp32 [C] sums written once, at the HBM rate; an add and an FMA (3
    FLOP) an element at the fp32 CUDA-core peak."""
    n = nbytes(a) + (0 if same else nbytes(b)) + 2 * a.shape[1] * 4
    t_bytes, _ = bytes_bound(n)
    t_ops = 3.0 * a.numel() / PEAK_FLOPS[torch.float32] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def ptxas_report(text: str) -> list:
    """(kernel, 'Used ...' line, spill line) per entry function of the
    compiler's -Xptxas -v output."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
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
    from cartseg_tpu_torch.utils.synthetic import (blob_masks,
                                                   ring_cuts_mask,
                                                   spiral_mask)

    m = np.zeros((B, S, S), bool)
    m[:30] = blob_masks(rng, (30, S, S), n=8)
    m[30:60] = rng.random((30, S, S)) < 0.45
    # 60: all background; 61: all foreground
    m[61] = True
    m[62] = spiral_mask(S)
    m[63] = ring_cuts_mask(S)
    return m


def edt_seeds(rng: np.random.Generator) -> np.ndarray:
    """[6,512,512] bool: the GT boundaries of blob masks (as
    losses/abl.py gt2boundary makes them), then a sample with no seed,
    one with a single seed and one with every pixel a seed."""
    from cartseg_tpu_torch.utils.synthetic import blob_masks

    m = blob_masks(rng, (TRAIN_BS, S, S), n=6)
    seeds = np.zeros_like(m)
    seeds[:, :-1] |= m[:, :-1] != m[:, 1:]
    seeds[:, :, :-1] |= m[:, :, :-1] != m[:, :, 1:]
    seeds[3] = False
    seeds[4] = False
    seeds[4, 137, 401] = True
    seeds[5] = True
    return seeds


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
    return np.stack([G.resize_square(G.letterbox_side_pad(
        image_io.read_rgb(p)), S) for p in paths])


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
    from cartseg_tpu_torch.ops.cuda.median import (median_rows,
                                                   median_rows_plain)
    from cartseg_tpu_torch.ops.edges import canny_weak_strong, rgb_to_gray

    rng = np.random.default_rng(SEED)
    err = {}
    masks = torch.from_numpy(cc_masks(rng)).to(dev)
    e = []
    for conn in (8, 4):
        e.append(check_equal(f"cc conn{conn} [blobs|noise|bg|fg|spiral|"
                             "rings]", cc_batch(masks, conn),
                             cc_batch_plain(masks, conn)))
    err["cc"] = max(e)

    gray = rgb_to_gray(torch.from_numpy(frames).to(dev))
    weak, strong = canny_weak_strong(gray, 50.0, 150.0)
    log(f"  canny maps: weak {float(weak.float().mean()):.4f}, strong "
        f"{float(strong.float().mean()):.4f} of pixels")
    err["reach"] = check_equal("reach [canny weak/strong]",
                               reach_batch(weak, strong),
                               reach_batch_plain(weak, strong))

    g = torch.Generator(device="cpu").manual_seed(SEED)
    p = torch.sigmoid(3 * torch.randn((B, S * S), generator=g))
    x = (p - 0.5).abs() * 2.0
    x[40:56] = torch.round(x[40:56] * 16) / 16      # many duplicates
    x[56:60] = torch.where(x[56:60] > 0.5, 1.0, 0.0)
    x[60:] = 0.0                                   # all-zero rows
    x = x.to(dev)
    err["median"] = check_equal("median [64,262144]", median_rows(x),
                                median_rows_plain(x))

    from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, edt_batch_plain
    from cartseg_tpu_torch.ops.cuda.lsr import (lsr_bwd, lsr_bwd_plain,
                                                lsr_fwd, lsr_fwd_plain)

    seeds = torch.from_numpy(edt_seeds(rng)).to(dev)
    err["edt"] = check_equal("edt [6,512,512] (GT boundaries|none|single|"
                             "all)", edt_batch_jfa(seeds),
                             edt_batch_plain(seeds))
    x, lab, _ = lsr_inputs(dev)
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
    return err


def phase_workload(tmp: Path, dev) -> tuple:
    from cartseg_tpu_torch.infer.pseudo_labels import QC_HEADER
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.utils import image_io
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

    frames = sorted(images.rglob("*.png"))
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
    return launches, ckpts


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
    # the path's masks depend on the weights (random init: near all-fg);
    # phase 3's mixed masks are a harder input for both versions
    mixed = torch.from_numpy(cc_masks(np.random.default_rng(SEED))).to(dev)
    log(f"  cc on phase 3's mixed masks: kernel "
        f"{cuda_ms(lambda: cc_batch(mixed), 20):.4f} ms, plain "
        f"{cuda_ms(lambda: cc_batch_plain(mixed), 1):.4f} ms [{card}]")
    build.reset_launch_counts()
    return {"program_ms": ms, "kernels": times, "bounds": bounds,
            "library": library}


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


def device_ms(fn, n: int, match: str = "") -> float:
    """Device time per call of fn: the summed durations of the kernels and
    copies the profiler records over n calls (those whose name contains
    `match`), over n, after one call unrecorded. Unlike CUDA events
    around a loop, it leaves out the gaps in which the card waits for
    the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and match in e.name)
    return total / n / 1e3


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
    bounds = {"edt": bytes_bound(nbytes(seeds, outs["edt"])),
              "lsr_fwd": bytes_bound(nbytes(x, lab, outs["lsr_fwd"])),
              "lsr_bwd": bytes_bound(nbytes(x, lab, g, outs["lsr_bwd"]))}
    # LSR forward == cross-entropy against the smoothed one-hot as
    # probability targets (all zero on ignored rows); built untimed
    C = x.shape[1]
    tgt = torch.full_like(x, 0.2 / C)
    keep = lab != 255
    tgt[keep, lab[keep]] = 0.8
    tgt[~keep] = 0.0
    ce = torch.nn.functional.cross_entropy(x, tgt, reduction="none")
    lib_ms = cuda_ms(lambda: torch.nn.functional.cross_entropy(
        x, tgt, reduction="none"), 20)
    library = {"edt": None, "lsr_fwd": lib_ms, "lsr_bwd": None}
    log(f"  library: F.cross_entropy(probability targets) {lib_ms:.4f} ms "
        f"(max abs diff to the kernel "
        f"{float((ce - outs['lsr_fwd']).abs().max()):.2e}); edt, lsr_bwd: "
        f"no single PyTorch call [{card}]")
    for name, (b, by) in bounds.items():
        log(f"  {name}: bound {b:.5f} ms ({by}, {HBM_BYTES_PER_S:.3g} B/s)")
    build.reset_launch_counts()
    return {"step_ms": step_ms, "kernels": times, "bounds": bounds,
            "library": library}


def phase_bce_workload(tmp: Path, dev, ir: Path, mr: Path) -> dict:
    """workloads/train_bce_dice through its CLI at its CONFIG (resnet34-
    UNet, bs6, 512^2, bf16, train_512), 2 epochs, once per BN lane: the
    kernel lane by CARTSEG_PALLAS_BN=force, read by the entry point.
    Launches: channel_sums twice per BN layer and step in the kernel
    lane, never in the torch lane, and no other kernel in either."""
    from cartseg_tpu_torch.infer.engine import load_member
    from cartseg_tpu_torch.models.norm import (BatchNorm2d,
                                               ChannelSumsBatchNorm2d)
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train.engine import SCHEMAS
    from cartseg_tpu_torch.workloads import train_bce_dice as cli

    runs = {}
    for lane, switch in (("channel_sums", "force"), ("torch", None)):
        out = tmp / f"run_bce_{lane}"
        prev = os.environ.pop("CARTSEG_PALLAS_BN", None)
        if switch is not None:
            os.environ["CARTSEG_PALLAS_BN"] = switch
        try:
            build.reset_launch_counts()
            t0 = time.perf_counter()
            result = cli.main(["--images_root", str(ir), "--masks_root",
                               str(mr), "--out_dir", str(out), "--epochs",
                               "2", "--device", "cuda"],
                              log=lambda m: log(f"    {m}"))
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
        want = 2 * BCE_BN_LAYERS * steps if switch else 0
        others = {k: v for k, v in launches.items()
                  if k != "channel_sums" and v}
        log(f"  {lane} lane (CARTSEG_PALLAS_BN={switch}): {steps} steps in "
            f"{wall:.1f} s wall (init, PNG decode, val and the sweep "
            f"included); {len(bns)} BNs, all {cls.__name__}; launches "
            f"{launches}")
        if len(bns) != BCE_BN_LAYERS or any(type(m) is not cls
                                            for m in bns):
            raise AssertionError(f"{lane} lane: BN modules "
                                 f"{sorted({type(m).__name__ for m in bns})}")
        if launches["channel_sums"] != want or others or steps <= 0:
            raise AssertionError(f"{lane} lane: channel_sums launched "
                                 f"{launches['channel_sums']} times in "
                                 f"{steps} steps, want {want}; others "
                                 f"{others}")
        rows = check_train_outputs(out, SCHEMAS["basic"])
        member = load_member(out / "model.pth", encoder="resnet34",
                             device=dev)
        if abs(member.threshold - result["threshold"]) > 1e-9:
            raise AssertionError("the .pth did not load with the sweep's "
                                 "threshold")
        hist = json.loads((out / "history.json").read_text())
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


def phase_bce_reference(dev) -> None:
    """One fp32 step (TF32 off) of the workload's CONFIG at 512^2 bs6 in
    both lanes from the same weights, generator and batch: loss within
    1e-5 relative and running statistics within 1e-5. The gradients
    (read from the first moment) are held to the torch lane's gradient
    in float64 on the same augmented batch: the kernel lane's fp32
    gradient no farther from it, and no farther from the torch lane's
    fp32 gradient, than twice the torch lane's own fp32 distance from
    it. This model's fp32 gradient is ill conditioned (train-mode BN at
    every layer): either lane's distance from float64, printed below, is
    far above what a fixed tolerance between two BN implementations could
    ask, and a wrong gradient would be O(1) away."""
    from cartseg_tpu_torch.data.augment import augment_batch
    from cartseg_tpu_torch.device import set_fp32_policy
    from cartseg_tpu_torch.models import build_model
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.train import Trainer
    from cartseg_tpu_torch.train.config import apply_cli_overrides
    from cartseg_tpu_torch.workloads.train_bce_dice import CONFIG

    set_fp32_policy()
    cfg = apply_cli_overrides(CONFIG, ["--device", "cuda", "--compute_dtype",
                                       "float32"])
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
    ref = build_model(cfg.encoder, cfg.classes, "torch")
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
    log(f"  fp32 step [{TRAIN_BS},{S},{S}] (TF32 off), channel_sums lane vs "
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
            and serr <= 1e-5 and nk == 2 * BCE_BN_LAYERS and nt == 0):
        raise AssertionError("fp32 step: the two BN lanes disagree")


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
    top and summed over one 512^2 step's 92 calls, in device time (the
    profiler's kernel durations) and in wall time (CUDA events). Returns
    the decoder top's (dy, x) row: (ms, plain ms, library ms, bound ms,
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
    log(f"  channel_sums, the {len(calls)} calls of one step, wall (CUDA "
        f"events, the host's enqueueing included): kernel {k1:.4f}/{k2:.4f} "
        f"ms, plain {p1:.4f}/{p2:.4f} ms, batch_norm_stats + "
        f"batch_norm_backward_reduce {l1:.4f} ms; device time (profiler): "
        f"kernel {kd:.4f} ms, plain {pd:.4f} ms, ATen {ld:.4f} ms; bound "
        f"{bound:.5f} ms (bytes), kernel's device time at "
        f"{bound / kd:.3f} of it [{card}]")

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
            kd1, kd2 = device_ms(kern1, 20, "sums_"), device_ms(
                kern1, 20, "sums_")
            pd1, ld1 = device_ms(plain1, 5), device_ms(c[1], 20)
            bnd, by = sums_bound(a, b, same)
            per[(name, what)] = ((kd1 + kd2) / 2, pd1, ld1, bnd, by)
            libname = ("batch_norm_stats" if same
                       else "batch_norm_backward_reduce")
            log(f"  channel_sums {name} {tuple(a.shape)} {what}: device time "
                f"(profiler) kernel {kd1:.5f}/{kd2:.5f} ms, plain "
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


def phase_compare_flash(dev) -> float:
    """flash_fwd against its plain version: the ViT-B global block
    [12,4096,64] in fp32 and bf16, and the tests' [2,256,32] fp32."""
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_relpos_fwd, flash_relpos_fwd_plain)

    errs = {}
    for bnh, g, hd, dt in FLASH_CASES:
        ts = flash_inputs(bnh, g, hd, dt, dev)
        got = flash_relpos_fwd(*ts, hd ** -0.5, g)
        torch.cuda.synchronize()
        want = flash_relpos_fwd_plain(*ts, hd ** -0.5, g)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        if got.dtype != dt or not rel <= FLASH_TOL[dt]:
            raise AssertionError(f"flash_fwd [{bnh},{g * g},{hd}] {dt}: "
                                 f"max abs err {err} = {rel} of max |plain|"
                                 f" (tolerance {FLASH_TOL[dt]})")
        log(f"  flash_fwd [{bnh},{g * g},{hd}] {dt}: max abs err {err:.3e}"
            f" = {rel:.3e} of max |plain| (tolerance {FLASH_TOL[dt]})")
        errs[(bnh, g, hd, dt)] = err
    return errs[FLASH_CASES[0]]


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
        lrel = float((lse - lse_plain).abs().max() / lse_plain.abs().max())
        if not same or not lrel <= 1e-5:
            raise AssertionError(f"training forward [{bnh},{g * g},{hd}] {dt}"
                                 f": out equal to inference {same}, lse rel "
                                 f"err {lrel}")
        delta = row_delta(out, do)
        dq, drh, drw = flash_bwd_dq(*ts, do, lse, delta, scale, g)
        dk, dv = flash_bwd_dkv(*ts, do, lse, delta, scale, g)
        torch.cuda.synchronize()
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
        log(f"  training forward [{bnh},{g * g},{hd}] {dt}: lse rel err "
            f"{lrel:.3e}, out == the inference call's, bit for bit")
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

    # the same weights through the plain lane (global_attn_flash=False)
    lanes = {}
    for dt in (torch.float32, torch.bfloat16):
        for flash in (True, False):
            m = model if (flash and dt == torch.bfloat16) else \
                sam_train_model(ckpt, flash, dt, dev)
            loss = float(sam_step(m, x))
            lanes[(dt, flash)] = (loss, {k: g.float().clone() for k, g in
                                         encoder_grads(m).items()})
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
    return {"launches": launches, "model": model, "x": x, "ckpt": ckpt}


def top_device_ops(fn, n_top: int = 8) -> tuple:
    """The device kernels and copies that take most time in one call of
    fn, as (name, ms summed over their launches), and their total ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    rows = sorted(ms.items(), key=lambda r: -r[1])
    return rows[:n_top], sum(ms.values())


def phase_sam_timing(pred, frames, dev, card: str) -> dict:
    """set_image and predict on the card, the global blocks' share of
    set_image, and flash_fwd against its plain version and
    F.scaled_dot_product_attention at the inputs the path gives it."""
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
    for what, fn in (("set_image", lambda: pred.set_image(img)),
                     ("predict", lambda: pred.predict(**reqs[-1]))):
        rows, total = top_device_ops(fn)
        log(f"  {what} device time by kernel (profiler, one call, "
            f"{total:.3f} ms of kernels and copies): " + "; ".join(
                f"{name[:70]} {ms:.3f}" for name, ms in rows))

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
        log(f"  flash_fwd [{bnh},{S},{q.shape[2]}] {dt} (the path's "
            f"inputs): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/"
            f"{p2:.4f} ms, F.scaled_dot_product_attention with the bias "
            f"built beforehand {l1:.4f} ms (max abs diff to plain "
            f"{lerr:.2e}); bound {b:.5f} ms ({by}), kernel at "
            f"{b / ((k1 + k2) / 2):.3f} of it [{card}]")
    build.reset_launch_counts()
    return {"set_image_ms": set_mean, "predict_ms": pred_ms,
            "flash": out}


def phase_sam_train_timing(train: dict, dev, card: str) -> dict:
    """The fine-tune step for the flash and the plain lane (bf16), the
    global blocks' share of it, the device's busy share, and
    flash_bwd_dq / flash_bwd_dkv against their plain versions and the
    library composite at the inputs the step gives them, bf16 and fp32."""
    import torch.nn.functional as F

    from cartseg_tpu_torch.ops import flash_attention as fa
    from cartseg_tpu_torch.ops.cuda import build
    from cartseg_tpu_torch.ops.cuda.flash_attention import (
        flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
        flash_relpos_bwd_plain, flash_relpos_fwd, row_delta)

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
    rows, total = top_device_ops(lambda: sam_step(model, x))
    log(f"  fine-tune step device time by kernel (profiler, one step, "
        f"{total:.3f} ms of kernels and copies): " + "; ".join(
            f"{name[:70]} {ms:.3f}" for name, ms in rows))

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
            log(f"  {name} [{bnh},{S},{hd}] {dt} (the step's inputs): kernel "
                f"{ka:.4f}/{kb:.4f} ms, plain {pa:.4f}/{pb:.4f} ms; bound "
                f"{b:.5f} ms ({by}), kernel at {b / ((ka + kb) / 2):.3f} of "
                f"it [{card}]")
        log(f"  library for both: autograd of F.scaled_dot_product_attention"
            f" with the (bnh,S,S) bias materialised and requiring grad, plus "
            f"the two sums of dbias into drel_h and drel_w: {l1:.4f} ms "
            f"(max abs diff to plain {lerr:.2e}); kernels dq + dkv "
            f"{res['flash_bwd_dq'][0] + res['flash_bwd_dkv'][0]:.4f} ms "
            f"[{card}]")
        out[dt] = res
    build.reset_launch_counts()
    return {"step_ms": step_ms, "plain_ms": plain_ms, "kernels": out}


def main() -> int:
    from cartseg_tpu_torch.device import require_cuda

    dev = require_cuda()
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}); torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}")

    from cartseg_tpu_torch.ops.cuda import build

    log("phase 2: build")
    t0 = time.perf_counter()
    build.load_library()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({build.library_path().name})")
    for name, used, spill in ptxas_report(build.BUILD_LOG["text"]):
        log(f"  ptxas: {name[:90]}: {used}; {spill or 'no spill report'}")

    from cartseg_tpu_torch.utils.synthetic import make_png_tree

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        t0 = time.perf_counter()
        images = make_png_tree(tmp, SESSIONS, B, FRAME_HW, seed=SEED)
        frames = load_frames(images)
        log(f"  synthetic tree: {SESSIONS}x{B} PNG frames "
            f"{FRAME_HW[1]}x{FRAME_HW[0]} in {time.perf_counter() - t0:.1f} s")

        log("phase 3: kernels against their plain versions")
        errs = phase_compare(frames, dev)
        errs["flash_fwd"] = phase_compare_flash(dev)
        bwd_errs = phase_compare_flash_bwd(dev)
        errs.update(bwd_errs[FLASH_CASES[1]])
        errs["channel_sums"] = phase_compare_channel_sums(dev)

        log("phase 4a: pseudo-label workload")
        launches, ckpts = phase_workload(tmp, dev)
        phase_reference(ckpts, frames, dev)

        log("phase 4b: training workload (train_bce_dice_abl)")
        ir, mr = make_train_tree(tmp)
        train_launches, hist = phase_train_workload(tmp, dev, ir, mr)
        phase_train_reference(dev)

        log("phase 4c: SAM ViT-B predictor (tools/annotate.load_sam)")
        sam_launches, pred, sam_frames = phase_sam(tmp, dev)
        phase_sam_reference(tmp, pred, sam_frames, dev)

        log("phase 4d: SAM ViT-B encoder fine-tune step")
        sam_train = phase_sam_train(tmp, dev)

        log("phase 4e: BCE+Dice training workload (train_bce_dice), both "
            "BN lanes")
        bce_runs = phase_bce_workload(tmp, dev, ir, mr)
        phase_bce_reference(dev)

        log("phase 5: timing")
        timing = phase_timing(ckpts, frames, dev, card)
        train_timing = phase_train_timing(dev, card, hist)
        sam_timing = phase_sam_timing(pred, sam_frames, dev, card)
        sam_train_timing = phase_sam_train_timing(sam_train, dev, card)
        bce_timing = phase_bce_timing(dev, card)

    launches.update({k: train_launches[k] for k in TRAIN_KERNELS})
    launches.update({k: sam_launches[k] for k in SAM_KERNELS})
    times = {**timing["kernels"], **train_timing["kernels"]}
    bounds = {**timing["bounds"], **train_timing["bounds"]}
    library = {**timing["library"], **train_timing["library"]}
    f_ms, f_plain, f_lib, f_b, f_by = sam_timing["flash"][torch.float32]
    times["flash_fwd"] = (f_ms, f_plain)
    bounds["flash_fwd"] = (f_b, f_by)
    library["flash_fwd"] = f_lib
    # the backward kernels' rows: the fine-tune step's bf16 inputs
    for k in BWD_KERNELS:
        launches[k] = sam_train["launches"][k]
        ms, plain, lib, b, by = sam_train_timing["kernels"][torch.bfloat16][k]
        times[k], bounds[k], library[k] = (ms, plain), (b, by), lib
    # channel_sums: the kernel-lane workload run's count; device times
    # (profiler) at the decoder top's backward sums, the path's largest
    # launch, whose wall time the host's enqueueing sets
    launches["channel_sums"] = bce_runs["channel_sums"]["launches"][
        "channel_sums"]
    ms, plain, lib, b, by = bce_timing
    times["channel_sums"] = (ms, plain)
    bounds["channel_sums"], library["channel_sums"] = (b, by), lib
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
    sys.exit(main())
