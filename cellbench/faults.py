"""Faults planted under a cell's timed path, to show that the check
catches them: each takes a driver's set-up context and breaks the
program it drives, in place. Used by the calibration tool on the card
and by the tests on the CPU; the benchmark's own runs never plant one.

pseudo_label:
  altered_answer  the first frame's cleaned mask has a 32 x 32 block
                  inverted where the program produces it
  half_batch      the program labels the first half of the batch only;
                  the rest of its outputs are zeros
  flip_skipped    the program's TTA skips the mirrored frames and takes
                  the frames' own probabilities for theirs
train:
  unchanged_state the step computes its loss and leaves the model and
                  the optimizer as they were
  half_batch      the loss is taken over the first half of the batch
                  only (its mean over the rest of the rows)
"""

from __future__ import annotations

import torch


def _pseudo_altered(ctx):
    program = ctx.program

    def altered(images, threshold):
        pred, probs, stats = program(images, threshold)
        pred = pred.clone()
        pred[0, :32, :32] = ~pred[0, :32, :32]
        return pred, probs, stats

    ctx.program = altered


def _pseudo_half(ctx):
    program = ctx.program

    def half(images, threshold):
        n = images.shape[0] // 2
        pred, probs, stats = program(images[:n], threshold)
        pad = lambda t: torch.cat([t, torch.zeros_like(t)])  # noqa: E731
        return pad(pred), pad(probs), {k: pad(v) for k, v in stats.items()}

    ctx.program = half


def _pseudo_flip_skipped(ctx):
    from cartseg_tpu_torch.infer import engine

    def no_mirror(forward):
        def forward_tta(images_u8):
            probs = forward(images_u8)
            return probs, probs

        return forward_tta

    t, tta = ctx.cell.traffic, engine._tta
    engine._tta = no_mirror
    try:
        ctx.program = engine.pseudo_label_program(
            ctx.members, ctx.mean, ctx.std, ctx.min_area,
            edge_method="canny", canny_low=t["canny_low"],
            canny_high=t["canny_high"])
    finally:
        engine._tta = tta


def _train_unchanged(ctx):
    tr = ctx.trainer

    def step(state, images_u8, masks, sample_w, lrs, active, gids):
        from cartseg_tpu_torch.data.augment import augment_batch

        imgs, m = augment_batch(state.gen, images_u8, masks, tr.aug_cfg)
        with torch.no_grad():
            loss, comps = tr.loss_fn(tr._forward(state.model.train(), imgs),
                                     m, sample_w)
        state.step += 1
        return loss, torch.ones((), device=loss.device), comps

    tr.train_step = step


def _train_half(ctx):
    tr = ctx.trainer
    loss_fn = tr.loss_fn

    def half(logits, masks, w):
        n = logits.shape[0] // 2
        return loss_fn(logits[:n], masks[:n], w[:n])

    tr.loss_fn = half


FAULTS = {
    "pseudo_label": {"altered_answer": _pseudo_altered,
                     "half_batch": _pseudo_half,
                     "flip_skipped": _pseudo_flip_skipped},
    "train": {"unchanged_state": _train_unchanged,
              "half_batch": _train_half},
}


def plant(ctx, name: str) -> None:
    FAULTS[ctx.kind][name](ctx)
