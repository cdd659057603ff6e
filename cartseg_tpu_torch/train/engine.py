"""The training engine (counterpart of cartseg_tpu/train/engine.py).

One train step: on-device augmentation, the model forward under
autocast (bf16 compute, fp32 parameters), the loss in fp32 (for
bce_dice_abl the EDT and LSR CUDA kernels on the card, for boundary the
EDT kernel), backward,
per-group AdamW and the BN running-stat update (BN in the lane the
Trainer is built with: torch's fused kernel, or the channel-sums CUDA
kernel, models/norm.py). Losses stay on the
device and are fetched once per epoch; a non-finite loss gates the
update on the device. Validation takes exact weighted means; the run
ends with a threshold sweep on the best checkpoint and writes the
`.threshold.json` sidecar beside the reference-format `.pth`.

Mixed sources (`sources` / `sources_json`): each source's mirrored pairs,
the val source split off, one epoch order drawn by `WeightedSampler`
(ratio / length times oversample), and each sample's loss weight from
its source, the last of three or more on the curriculum ramp. `remat`
recomputes the forward in the backward (torch.utils.checkpoint; the BN
layers update their running statistics once, models/norm.py).
`trace_dir` writes a torch.profiler trace of epoch 0's train loop.
An Orbax `init_checkpoint` raises (train/config.py `check_supported`).
`use_mesh` is accepted and means nothing on one card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from cartseg_tpu_torch import metrics as M
from cartseg_tpu_torch.data.augment import (AugmentConfig, augment_batch,
                                            normalize_batch)
from cartseg_tpu_torch.data.dataset import SegmentationDataset
from cartseg_tpu_torch.data.pairing import (gather_pairs,
                                            gather_pairs_mirror,
                                            gather_pairs_multiroot,
                                            random_split, session_split,
                                            session_split_seeded)
from cartseg_tpu_torch.data.pipeline import Loader
from cartseg_tpu_torch.data.sampling import (MixedSource, WeightedSampler,
                                             curriculum_weight,
                                             mixed_index_table,
                                             mixed_sample_weights)
from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.losses.abl import bce_dice_abl
from cartseg_tpu_torch.losses.boundary import composite_seg_loss
from cartseg_tpu_torch.losses.region import (bce_dice_loss,
                                             bce_dice_per_sample,
                                             focal_dice_loss)
from cartseg_tpu_torch.models.factory import build_model, param_groups
from cartseg_tpu_torch.models.norm import remat_contexts
from cartseg_tpu_torch.models.pretrained import (load_encoder_state_dict,
                                                 load_pretrained_encoder)
from cartseg_tpu_torch.train import checkpoint as ckpt_lib
from cartseg_tpu_torch.train.config import (SourceSpec, TrainConfig,
                                            check_supported)
from cartseg_tpu_torch.train.optim import (AdamWState, adamw_update,
                                           group_ids, init_adamw)
from cartseg_tpu_torch.train.schedules import FreezePhase, cosine_epoch_lr
from cartseg_tpu_torch.utils.io import CSVLogger, JSONHistory
from cartseg_tpu_torch.utils.profiling import StepTimer, maybe_trace

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
SCHEMAS = {
    "basic": ["epoch", "train_loss", "val_loss", "val_dice", "val_iou"],
    "prf1": ["epoch", "phase", "train_loss", "val_loss", "val_dice",
             "val_iou", "val_precision", "val_recall", "val_f1",
             "lr_encoder", "lr_decoder", "lr_head"],
    "abl": ["epoch", "train_loss", "region_loss", "boundary_loss",
            "boundary_skip_rate", "val_loss", "val_dice", "val_iou"],
}


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN buffers), the optimizer state, the
    augmentation generator and the step count."""
    model: torch.nn.Module
    opt: AdamWState
    gen: torch.Generator
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def resolve_loss(spec) -> Callable:
    """LossSpec -> fn(logits, masks, sample_w) -> (loss, components)."""
    name, kw = spec.name, dict(spec.kwargs)

    if name == "bce_dice":
        def f(logits, masks, w):
            return bce_dice_loss(logits, masks, **kw), {}
    elif name == "bce_dice_per_sample":
        def f(logits, masks, w):
            return (bce_dice_per_sample(logits, masks, **kw) * w).mean(), {}
    elif name == "focal_dice":
        def f(logits, masks, w):
            return focal_dice_loss(logits, masks, **kw), {}
    elif name == "boundary":
        def f(logits, masks, w):
            return composite_seg_loss(logits, masks, **kw), {}
    elif name == "bce_dice_abl":
        def f(logits, masks, w):
            return bce_dice_abl(logits, masks, **kw)
    else:
        raise ValueError(f"unknown loss {name!r}")
    return f


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    """The epoch plan: the JAX engine's seeded permutation
    (engine.py:501-503), so both frameworks visit samples in one order."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, 7, epoch])).permutation(n)


def synthetic_frame_hw(img_size) -> tuple:
    """Frame (h, w) whose letterbox is exactly img_size (square): w is
    400/512 of h, as the 512x400 frames of the cart camera, so the
    synthetic tree trains with no resize and no OpenCV."""
    h = int(img_size[0])
    return h, int(h * 400 / 512)


class Trainer:
    """Engine of the port's training workloads (cartseg_tpu_torch.workloads)."""

    def __init__(self, cfg: TrainConfig, bn_lane: str = "torch"):
        """bn_lane: every BatchNorm's lane (models/norm.py), fixed for the
        Trainer's life; the workloads' entry point picks it."""
        check_supported(cfg)
        self.cfg = cfg
        self.bn_lane = bn_lane
        self.device = resolve_device(cfg.device)
        self.dtype = _DTYPES[cfg.compute_dtype]
        self.aug_cfg = {"train_512": AugmentConfig.train_512,
                        "train_224": AugmentConfig.train_224}.get(
            cfg.augment, AugmentConfig.none)(cfg.imagenet_norm)
        self.val_aug_cfg = AugmentConfig.none(cfg.imagenet_norm)
        self.loss_fn = resolve_loss(cfg.loss)
        # raises early if the encoder, decoder or lane is unknown
        build_model(cfg.encoder, cfg.classes, bn_lane, cfg.decoder)

    # ------------------------------------------------------------ setup

    def init_state(self) -> TrainState:
        """The model from a seeded init (the global RNG is forked, not
        reseeded), or from init_torch_checkpoint, then the encoder from
        pretrained_encoder where given, on the device."""
        cfg = self.cfg
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            model = build_model(cfg.encoder, cfg.classes, self.bn_lane,
                                cfg.decoder)
        if cfg.init_torch_checkpoint:
            sd = torch.load(cfg.init_torch_checkpoint, map_location="cpu",
                            weights_only=True)
            model.load_state_dict(sd.get("model_state_dict", sd))
        if cfg.pretrained_encoder:
            # encoder_weights="imagenet" from the user's file, after the
            # init checkpoint, as the JAX engine orders them
            # (engine.py:158-177); the decoder and head stay as they are
            load_pretrained_encoder(
                model, load_encoder_state_dict(cfg.pretrained_encoder),
                cfg.encoder)
        model = model.to(self.device)
        if self.device.type == "cuda":
            # NHWC storage: the augmented batch already is NHWC, and
            # cuDNN needs no layout transposes around the convolutions
            model = model.to(memory_format=torch.channels_last)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        return TrainState(model=model,
                          opt=init_adamw(dict(model.named_parameters())),
                          gen=gen)

    def group_ids(self, state: TrainState) -> Dict[str, int]:
        return group_ids(param_groups(state.model))

    def build_datasets(self):
        """(train_ds, val_ds, sampler, src_of_global): the mixed-source
        mode (sampler and src_of_global set) or the single / multi-root
        pair mode (both None), as the JAX engine builds them
        (engine.py:187-280)."""
        cfg = self.cfg
        if cfg.synthetic:
            from cartseg_tpu_torch.utils.synthetic import make_png_pair_tree
            ir, mr = make_png_pair_tree(
                cfg.out_path() / "synthetic", cfg.synthetic_sessions,
                cfg.synthetic_per_session, synthetic_frame_hw(cfg.img_size),
                seed=cfg.seed)
            cfg = dataclasses.replace(cfg, images_root=str(ir),
                                      masks_root=str(mr))
            self.cfg = cfg
        if cfg.sources_json:
            specs = json.loads(Path(cfg.sources_json).read_text())
            cfg = dataclasses.replace(
                cfg, sources=[SourceSpec(**s) for s in specs])
            self.cfg = cfg
        if cfg.sources:
            return self._mixed_datasets(cfg)
        if cfg.image_roots:
            pairs = gather_pairs_multiroot(
                [Path(r) for r in cfg.image_roots], Path(cfg.masks_root),
                seed=cfg.seed)
        else:
            # reference trees hold .jpeg frames (nvJPEG on a card, cv2
            # on the CPU); the port's synthetic trees hold .png
            ir, mr = Path(cfg.images_root), Path(cfg.masks_root)
            pairs = gather_pairs(ir, mr) or gather_pairs(ir, mr, "*.png")
        if not pairs:
            raise RuntimeError("no image/mask pairs found")
        if cfg.split == "session_sorted":
            tr, va = session_split(pairs, cfg.val_frac)
        elif cfg.split == "session_seeded":
            tr, va = session_split_seeded(pairs, cfg.val_frac, cfg.seed)
        else:
            tr, va = random_split(len(pairs), cfg.val_frac, cfg.seed)
        size, pad = cfg.img_size, cfg.side_padding_ratio
        return (SegmentationDataset([pairs[i] for i in tr], size, pad),
                SegmentationDataset([pairs[i] for i in va], size, pad),
                None, None)

    @staticmethod
    def _mixed_datasets(cfg: TrainConfig):
        """Each source's mirrored pairs; the val source (named by
        val_source, else the first; a name that matches no source falls
        back to the first, as JAX's engine.py:223-224 does) split by
        random_split; per-sample weights ratio / length times the
        source's oversample factor; the sources' train pairs concatenated
        in order, with the source of each global index."""
        per = [gather_pairs_mirror(Path(s.images_root), Path(s.masks_root))
               for s in cfg.sources]
        want = cfg.val_source or cfg.sources[0].name
        vi = next((i for i, s in enumerate(cfg.sources) if s.name == want),
                  0)
        tr_idx, va_idx = random_split(len(per[vi]), cfg.val_frac, cfg.seed)
        val_pairs = [per[vi][i] for i in va_idx]
        per[vi] = [per[vi][i] for i in tr_idx]
        mixed = [MixedSource(s.name, len(p), s.ratio, s.loss_weight)
                 for s, p in zip(cfg.sources, per)]
        ov = np.concatenate([[s.oversample] * len(p)
                             for s, p in zip(cfg.sources, per)])
        sampler = WeightedSampler(mixed_sample_weights(mixed) * ov,
                                  num_samples=sum(len(p) for p in per),
                                  seed=cfg.seed)
        table = mixed_index_table(mixed)
        size, pad = cfg.img_size, cfg.side_padding_ratio
        train_ds = SegmentationDataset([per[si][li] for si, li in table],
                                       size, pad)
        src_of_global = np.asarray([si for si, _ in table], np.int32)
        return (train_ds, SegmentationDataset(val_pairs, size, pad),
                sampler, src_of_global)

    # ------------------------------------------------------------ steps

    def _forward(self, model, x_nhwc):
        """NHWC float input -> NHWC float32 logits [B,H,W,C]. With remat,
        a train-mode forward that records a graph keeps no activations
        and runs again in the backward (the JAX jax.checkpoint of the
        forward, engine.py:296-297)."""
        x = x_nhwc.permute(0, 3, 1, 2)
        with torch.autocast(self.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            if self.cfg.remat and model.training and \
                    torch.is_grad_enabled():
                out = torch.utils.checkpoint.checkpoint(
                    model, x, use_reentrant=False,
                    context_fn=functools.partial(remat_contexts, model))
            else:
                out = model(x)
        return out.to(torch.float32).permute(0, 2, 3, 1)

    def train_step(self, state: TrainState, images_u8, masks, sample_w,
                   lrs, active, gids):
        """One step in place on `state`; returns (loss, ok, components)
        as device tensors."""
        cfg = self.cfg
        model = state.model.train()
        imgs, m = augment_batch(state.gen, images_u8, masks, self.aug_cfg)
        logits = self._forward(model, imgs)
        loss, comps = self.loss_fn(logits, m, sample_w)
        params = state.params
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if cfg.clip_grad_norm > 0:
            gnorm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(list(grads.values()))))
            scale = torch.clamp(cfg.clip_grad_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
            torch._foreach_mul_(list(grads.values()), scale)
        ok = None
        if cfg.skip_nonfinite:
            # a bad batch must not poison params or moments: gate the
            # whole update on a finite loss, on the device
            ok = torch.isfinite(loss).to(torch.float32)
            for g in grads.values():
                torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
            loss = torch.where(ok > 0, loss, 0.0)
        adamw_update(params, grads, state.opt, gids, lrs, active,
                     cfg.weight_decay, ok)
        state.step += 1
        ok = ok if ok is not None else torch.ones((), device=loss.device)
        return (loss.detach(), ok,
                {k: v.detach() for k, v in comps.items()})

    @torch.no_grad()
    def eval_step(self, state: TrainState, images_u8, masks, w):
        """Val loss and weighted metric sums; w: per-sample weights [B]
        (0 for cycle-padded tail duplicates)."""
        model = state.model.eval()
        imgs = normalize_batch(images_u8.to(torch.float32),
                               self.val_aug_cfg.mean, self.val_aug_cfg.std)
        logits = self._forward(model, imgs)
        loss, _ = self.loss_fn(logits, masks, w)
        sums, n = M.eval_suite_sums(logits, masks, w)
        return loss, n, sums

    @torch.no_grad()
    def sweep_step(self, state: TrainState, images_u8, masks, w,
                   thresholds: torch.Tensor):
        model = state.model.eval()
        imgs = normalize_batch(images_u8.to(torch.float32),
                               self.val_aug_cfg.mean, self.val_aug_cfg.std)
        logits = self._forward(model, imgs)
        return M.threshold_sweep_sums(logits, masks, thresholds, w)

    # ------------------------------------------------------ checkpoints

    @staticmethod
    def _opt_cpu(state: TrainState) -> Dict[str, Any]:
        opt = state.opt
        return {"mu": ckpt_lib.to_cpu(opt.mu), "nu": ckpt_lib.to_cpu(opt.nu),
                "count": opt.count.cpu()}

    def _last_snapshot(self, state: TrainState, **meta) -> Dict[str, Any]:
        return {"model_state_dict": ckpt_lib.to_cpu(state.model.state_dict()),
                "opt": self._opt_cpu(state),
                "gen_state": state.gen.get_state(), "step": state.step,
                **meta}

    # ------------------------------------------------------------- fit

    def fit(self, state: Optional[TrainState] = None,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
        cfg = self.cfg
        out = cfg.out_path()
        train_ds, val_ds, sampler, src_of_global = self.build_datasets()
        cfg = self.cfg
        log(f"train={len(train_ds)} val={len(val_ds)} pairs; "
            f"device={self.device}")
        if sampler is not None:
            log("sources: " + ", ".join(
                f"{s.name} {int((src_of_global == i).sum())}"
                for i, s in enumerate(cfg.sources)))

        state = state if state is not None else self.init_state()
        gids = self.group_ids(state)
        phase = FreezePhase(cfg.freeze_encoder_epochs,
                            cfg.unfreeze_encoder_lr_scale)
        dev = self.device
        loader = Loader(train_ds, cfg.batch_size, device=dev,
                        num_threads=cfg.num_threads)
        val_loader = Loader(val_ds, cfg.batch_size, device=dev,
                            drop_last=True, num_threads=cfg.num_threads)

        def val_order():
            """Every val sample once, the tail batch cycle-padded to a
            full batch; the duplicates weigh 0, so the mean is exact."""
            n = len(val_ds)
            if n == 0:
                return np.zeros((0,), np.int64)
            pad = (-n) % cfg.batch_size
            return np.concatenate([np.arange(n), np.arange(pad) % n])

        def val_weights(bi: int, b: int) -> torch.Tensor:
            pos = np.arange(bi * cfg.batch_size, bi * cfg.batch_size + b)
            return torch.from_numpy(
                (pos < len(val_ds)).astype(np.float32)).to(dev)

        csv_log = CSVLogger(out / "training_metrics.csv",
                            SCHEMAS[cfg.metrics_schema])
        history = JSONHistory(out / "history.json")

        best_dice, best_epoch, no_improve = -1.0, -1, 0
        start_epoch = images_seen = 0
        best_pth = ckpt_lib.best_path(out, cfg.checkpoint_name)
        last_pth = ckpt_lib.last_path(out, cfg.checkpoint_name)
        if cfg.resume and last_pth.exists():
            # true continuation: the resumed run is step-identical to
            # the uninterrupted one
            snap = ckpt_lib.load(last_pth)
            state.model.load_state_dict(snap["model_state_dict"])
            state.opt = AdamWState.from_state_dict(snap["opt"], dev)
            state.gen.set_state(snap["gen_state"])
            state.step = int(snap["step"])
            best_dice = float(snap["best_dice"])
            best_epoch = int(snap["best_epoch"])
            no_improve = int(snap["no_improve"])
            start_epoch = int(snap["epoch"]) + 1
            images_seen = int(snap["images_seen"])
            log(f"Resumed continuation at epoch {start_epoch} "
                f"(best_dice {best_dice:.4f} @ epoch {best_epoch + 1}, "
                f"no_improve {no_improve}).")
        elif cfg.resume and best_pth.exists():
            # the reference's restart from the BEST checkpoint
            # (finetune_pseudo_hard_clean.py:196-200): the generator and
            # the early-stop counter start fresh
            snap = ckpt_lib.load(best_pth)
            state.model.load_state_dict(snap["model_state_dict"])
            if "optimizer_state_dict" in snap:
                state.opt = AdamWState.from_state_dict(
                    snap["optimizer_state_dict"], dev)
            best_dice = float(snap.get("val_dice", -1.0))
            best_epoch = int(snap.get("epoch", -1))
            start_epoch = best_epoch + 1
            log(f"Resumed from best epoch {best_epoch} "
                f"(val_dice {best_dice:.4f}).")

        t_start = time.time()
        ones = torch.ones((cfg.batch_size,), device=dev)
        base_w = np.asarray([s.loss_weight for s in cfg.sources] or [1.0],
                            np.float32)
        for epoch in range(start_epoch, cfg.epochs):
            lr_epoch = cosine_epoch_lr(cfg.lr, epoch, cfg.epochs)
            enc_s, dec_s, head_s = phase.lr_scales(
                epoch, cfg.encoder_lr_scale, cfg.head_lr_scale)
            lrs = [lr_epoch * enc_s, lr_epoch * dec_s, lr_epoch * head_s]
            active = [1.0 if phase.encoder_on(epoch) else 0.0, 1.0, 1.0]
            # the epoch plan (engine.py:498-510): the sampler keyed by
            # epoch in mixed mode, so a resumed run draws the same orders
            if sampler is not None:
                order = sampler.epoch(epoch)
            else:
                order = epoch_order(cfg.seed, epoch, len(train_ds))
            w_epoch = base_w.copy()
            if cfg.use_curriculum and len(w_epoch) >= 3:
                w_epoch[-1] = curriculum_weight(
                    epoch, cfg.pseudo_w_start, cfg.pseudo_w_end,
                    cfg.pseudo_ramp_epochs)
            if sampler is not None:
                log(f"epoch {epoch + 1} loss weights: " + ", ".join(
                    f"{s.name} {w:.4g}" for s, w in zip(cfg.sources,
                                                        w_epoch)))

            losses, oks, comps_acc = [], [], []
            timer = StepTimer()
            with maybe_trace(cfg.trace_dir if epoch == 0 else None, dev):
                for bi, (imgs, masks) in enumerate(loader(order)):
                    b = imgs.shape[0]
                    if src_of_global is not None:
                        sw = torch.from_numpy(w_epoch[src_of_global[
                            order[bi * cfg.batch_size:
                                  bi * cfg.batch_size + b]]]).to(dev)
                    else:
                        sw = ones[:b]
                    loss, ok, comps = self.train_step(
                        state, imgs, masks, sw, lrs, active, gids)
                    losses.append(loss)
                    oks.append(ok)
                    if comps:
                        comps_acc.append(comps)
                    images_seen += b
                    timer.step(b)

            vlosses, vns, sum_acc = [], [], []
            for bi, (imgs, masks) in enumerate(val_loader(val_order())):
                w = val_weights(bi, imgs.shape[0])
                vloss, n_b, sums = self.eval_step(state, imgs, masks, w)
                vlosses.append(vloss * n_b)
                vns.append(n_b)
                sum_acc.append(sums)

            # one host sync per epoch; skipped (non-finite) batches are
            # left out of the mean
            if losses:
                n_ok = torch.clamp(torch.stack(oks).sum(), min=1.0)
                train_loss = float(torch.stack(losses).sum() / n_ok)
            else:
                train_loss = 0.0
            if vlosses:
                n_tot = torch.clamp(torch.stack(vns).sum(), min=1.0)
                val_loss = float(torch.stack(vlosses).sum() / n_tot)
                suite = {k: float(torch.stack([s[k] for s in sum_acc]).sum()
                                  / n_tot) for k in sum_acc[0]}
            else:
                val_loss, suite = 0.0, {}

            row = {"epoch": epoch + 1, "train_loss": train_loss,
                   "val_loss": val_loss, "val_dice": suite.get("dice", 0.0),
                   "val_iou": suite.get("iou", 0.0),
                   "phase": int(phase.encoder_on(epoch)),
                   "val_precision": suite.get("precision", 0.0),
                   "val_recall": suite.get("recall", 0.0),
                   "val_f1": suite.get("f1", 0.0),
                   "lr_encoder": lrs[0], "lr_decoder": lrs[1],
                   "lr_head": lrs[2]}
            if comps_acc:
                for k in comps_acc[0]:
                    row[{"region": "region_loss", "boundary": "boundary_loss"
                         }.get(k, k)] = float(
                        torch.stack([c[k] for c in comps_acc]).mean())
                if "boundary_used" in comps_acc[0]:
                    row["boundary_skip_rate"] = 1.0 - float(torch.stack(
                        [c["boundary_used"] for c in comps_acc]).mean())
            if cfg.log_throughput:
                # wall-clock epoch rate, train + val, after the sync above
                row["images_per_sec"] = round(
                    timer.rates()["images_per_sec"], 2)
            csv_log.append(row)
            history.append(row)
            log(f"Epoch {epoch + 1}/{cfg.epochs} | Train {train_loss:.4f} | "
                f"Val {val_loss:.4f} | Dice {row['val_dice']:.4f} | "
                f"IoU {row['val_iou']:.4f}")

            stop_early = False
            if row["val_dice"] > best_dice:
                best_dice, best_epoch, no_improve = row["val_dice"], epoch, 0
                ckpt_lib.save_best(
                    best_pth, state.model, epoch, row["val_dice"],
                    row["val_iou"],
                    self._opt_cpu(state) if cfg.save_optimizer_state
                    else None)
            else:
                no_improve += 1
                stop_early = no_improve >= cfg.patience

            if cfg.save_last:
                ckpt_lib.save(self._last_snapshot(
                    state, epoch=epoch, best_dice=best_dice,
                    best_epoch=best_epoch, no_improve=no_improve,
                    images_seen=images_seen), last_pth)

            if stop_early:
                log(f"Early stopping at epoch {epoch + 1}.")
                break
            if (cfg.stop_after_epoch is not None
                    and epoch + 1 - start_epoch >= cfg.stop_after_epoch):
                log(f"Stopping after {cfg.stop_after_epoch} epoch(s) of "
                    "this run (stop_after_epoch).")
                return {"interrupted": True, "epoch": epoch,
                        "best_val_dice": best_dice, "best_epoch": best_epoch,
                        "checkpoint": str(best_pth), "state": state}

        elapsed = time.time() - t_start
        # ---- threshold sweep on the best checkpoint
        state.model.load_state_dict(
            ckpt_lib.load(best_pth)["model_state_dict"])
        lo, hi, n = cfg.threshold_sweep
        thresholds = np.linspace(lo, hi, int(n))
        ts = torch.from_numpy(thresholds.astype(np.float32)).to(dev)
        dsum, isum, nsum = [], [], []
        for bi, (imgs, masks) in enumerate(val_loader(val_order())):
            d, i, n_b = self.sweep_step(state, imgs, masks,
                                        val_weights(bi, imgs.shape[0]), ts)
            dsum.append(d)
            isum.append(i)
            nsum.append(n_b)
        if dsum:
            n_tot = max(float(torch.stack(nsum).sum()), 1.0)
            dice_t = torch.stack(dsum).sum(0).cpu().numpy() / n_tot
            iou_t = torch.stack(isum).sum(0).cpu().numpy() / n_tot
        else:
            dice_t = iou_t = np.zeros(len(thresholds), np.float32)
        k = int(np.argmax(dice_t))
        ckpt_lib.save_threshold_sidecar(best_pth, thresholds[k],
                                        float(dice_t[k]), float(iou_t[k]))
        log(f"Best threshold: {thresholds[k]:.2f} | Dice {dice_t[k]:.4f}")

        return {"best_val_dice": best_dice, "best_epoch": best_epoch,
                "threshold": float(thresholds[k]),
                "threshold_dice": float(dice_t[k]),
                "checkpoint": str(best_pth), "state": state,
                "train_time_s": elapsed, "images_seen": images_seen,
                "images_per_sec": images_seen / max(elapsed, 1e-9)}
