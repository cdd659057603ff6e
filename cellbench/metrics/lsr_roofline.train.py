"""% of their roofline that the label-smoothed CE kernels reach at the
ABL call's shapes (logits [B*H*W, 8] float32, int64 labels, smoothing
0.2, ignore 255): (bound fwd + bound bwd) / (time `lsr_fwd` + time
`lsr_bwd`), each bound the inputs read once and the outputs written once
at the card's HBM rate, CUDA events after the window. None outside the
ABL trainer and on a card the peaks table lacks."""

import torch

from cellbench.counts import lsr_bwd_bytes, lsr_fwd_bytes, peaks
from cellbench.timing import call_ms

REPS = 50
CLASSES, SMOOTHING, IGNORE = 8, 0.2, 255


def read(ctx):
    if getattr(ctx, "kind", None) != "train" or ctx.device.type != "cuda" \
            or ctx.cell.traffic["loss"]["name"] != "bce_dice_abl":
        return None
    peak = peaks(torch.cuda.get_device_name(ctx.device))
    if peak is None:
        return None
    from cartseg_tpu_torch.ops.cuda.lsr import lsr_bwd, lsr_fwd

    n = ctx.batch * ctx.size * ctx.size
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    x = torch.randn((n, CLASSES), generator=gen, device=ctx.device)
    lab = torch.randint(0, CLASSES, (n,), generator=gen, device=ctx.device)
    g = torch.rand((n,), generator=gen, device=ctx.device)
    fwd = call_ms(lambda: lsr_fwd(x, lab, SMOOTHING, IGNORE), REPS,
                  ctx.device)
    bwd = call_ms(lambda: lsr_bwd(x, lab, g, SMOOTHING, IGNORE), REPS,
                  ctx.device)
    rate = peak["hbm_bytes_per_s"]
    bound_ms = (lsr_fwd_bytes(n, CLASSES, 8) + lsr_bwd_bytes(n, CLASSES, 8)) \
        / rate * 1e3
    return 100.0 * bound_ms / (fwd + bwd)
