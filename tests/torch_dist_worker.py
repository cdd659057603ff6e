"""One rank of the port's data-parallel checks (tests/test_torch_parallel.py):
a gloo process group over file:// rendezvous, torch on one thread, no
JAX. Every case runs in the same pair of processes; a case that raises is
recorded with its message and the others go on.

    python tests/torch_dist_worker.py <rank> <world> <init_file> <out_dir>

Writes <out_dir>/rank<r>.pt: {case: result, ...}. The inputs come from
the seeded makers below, which the test calls too for the single-process
counterparts.
"""

import sys
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

GLOBAL_BS = 8
BN_SHAPE = (GLOBAL_BS, 5, 6, 7)
STEP_HW = 32
ABL_SHAPE = (GLOBAL_BS, 32, 32, 1)
CLASSIC_HW = 16


def bn_inputs():
    """x [8,5,6,7] (channel means and scales apart), weight, bias, the
    upstream gradient g."""
    r = np.random.default_rng(11)
    x = (r.standard_normal(BN_SHAPE) * (1 + np.arange(5))[None, :, None, None]
         + np.arange(5)[None, :, None, None]).astype(np.float32)
    w = (1 + 0.1 * r.standard_normal(5)).astype(np.float32)
    b = (0.1 * r.standard_normal(5)).astype(np.float32)
    g = r.standard_normal(BN_SHAPE).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, w, b, g)]


def run_bn(lane: str, x, w, b, g, group):
    """y, dx, dgamma, dbeta and the running statistics of one train-mode
    BN of `lane` on x under `group` (None: one process)."""
    from cartseg_tpu_torch.models.norm import batch_norm, sync_batch_norm

    bn = batch_norm(x.shape[1], 1e-5, lane)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    sync_batch_norm(bn, group)
    bn.train()
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * g).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dgamma": bn.weight.grad,
            "dbeta": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def step_batch():
    """uint8 frames and blob masks [8,32,32]."""
    from cartseg_tpu_torch.utils.synthetic import blob_masks, frame

    r = np.random.default_rng(5)
    imgs = np.stack([frame(r, (STEP_HW, STEP_HW)) for _ in range(GLOBAL_BS)])
    masks = blob_masks(r, (GLOBAL_BS, STEP_HW, STEP_HW), n=2)[..., None]
    return torch.from_numpy(imgs), torch.from_numpy(masks.astype(np.float32))


def step_config(**kw):
    from cartseg_tpu_torch.train import LossSpec, TrainConfig

    base = dict(encoder="resnet18", img_size=(STEP_HW, STEP_HW),
                batch_size=GLOBAL_BS, compute_dtype="float32",
                augment="train_512", loss=LossSpec("bce_dice"), seed=0,
                device="cpu", num_threads=1)
    base.update(kw)
    return TrainConfig(**base)


def run_step(cfg, rows: slice):
    """One Trainer step on `rows` of step_batch(): the gradients (read
    from the first moment, (1 - b1) g after one step) and the state after
    it."""
    from cartseg_tpu_torch.train import Trainer

    tr = Trainer(cfg)
    st = tr.init_state()
    imgs, masks = step_batch()
    tr.train_step(st, imgs[rows], masks[rows],
                  torch.ones(rows.stop - rows.start), [1e-3] * 3,
                  [1.0] * 3, tr.group_ids(st))
    return {"grads": {k: v / 0.1 for k, v in st.opt.mu.items()},
            "state": {k: v.clone() for k, v in st.model.state_dict().items()}}


def run_step64(rows: slice, group):
    """step_config()'s step in float64, the torch lane: the model's
    gradient on `rows` of the augmented step_batch() (draws at the global
    batch), through DDP under `group` (train/engine.py `_Replica`, BN
    synced), or alone on every row."""
    from torch.nn.parallel import DistributedDataParallel

    from cartseg_tpu_torch.data.augment import AugmentConfig, augment_batch
    from cartseg_tpu_torch.models import build_model
    from cartseg_tpu_torch.models.norm import sync_batch_norm
    from cartseg_tpu_torch.train.engine import _Replica, resolve_loss

    cfg = step_config()
    # the Trainer's init (train/engine.py init_state) and augmentation
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg.encoder, cfg.classes, "torch", cfg.decoder)
    model = model.double().train()
    imgs, masks = step_batch()
    x, m = augment_batch(torch.Generator().manual_seed(cfg.seed),
                         imgs[rows], masks[rows],
                         AugmentConfig.train_512(cfg.imagenet_norm), rows,
                         GLOBAL_BS)
    run = model
    if group is not None:
        sync_batch_norm(model, group)
        run = DistributedDataParallel(_Replica(model, False),
                                      process_group=group)
    logits = run(x.double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    loss, _ = resolve_loss(cfg.loss)(logits, m.double(), torch.ones(len(x)))
    loss.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def fit_config(out_dir, **kw):
    """tests/test_distributed.py's fit (2 sessions x 8 synthetic frames, no
    augmentation, 2 epochs at lr 1e-3) on step_config()'s model."""
    return step_config(lr=1e-3, epochs=2, synthetic=True,
                       synthetic_sessions=2, synthetic_per_session=8,
                       augment="none", out_dir=str(out_dir), **kw)


def run_fit(cfg):
    from cartseg_tpu_torch.train import Trainer

    res = Trainer(cfg).fit(log=lambda *a: None)
    return {"state": {k: v.clone() for k, v in
                      res["state"].model.state_dict().items()},
            "best_val_dice": res["best_val_dice"],
            "threshold": res["threshold"]}


def abl_inputs():
    """Logits [8,32,32,1] and blob targets."""
    from cartseg_tpu_torch.utils.synthetic import blob_masks

    r = np.random.default_rng(3)
    t = blob_masks(r, ABL_SHAPE[:3], n=2)[..., None].astype(np.float32)
    logits = (4.0 * (t - 0.5) + r.standard_normal(ABL_SHAPE)
              ).astype(np.float32)
    return torch.from_numpy(logits), torch.from_numpy(t)


def run_abl(logits, t, group):
    from cartseg_tpu_torch.losses.abl import bce_dice_abl_over

    x = logits.clone().requires_grad_(True)
    total, comps = bce_dice_abl_over(group, x, t)
    total.backward()
    return {"total": total.detach(), "grad": x.grad,
            **{k: v.detach() for k, v in comps.items()}}


def classic_batch():
    """test_parallel.py:31-32's inputs: x normal [8,16,16,3], y in {0,1}."""
    r = np.random.default_rng(0)
    x = r.normal(size=(GLOBAL_BS, CLASSIC_HW, CLASSIC_HW, 3)).astype(
        np.float32)
    y = (r.random((GLOBAL_BS, CLASSIC_HW, CLASSIC_HW, 1)) > 0.5).astype(
        np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def classic_loss(model, x, y):
    """test_parallel.py:34-38: BCE+Dice on the logits of the classic UNet's
    probabilities."""
    from cartseg_tpu_torch.losses import bce_dice_loss

    out = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    eps = 1e-6
    logits = torch.log(out + eps) - torch.log1p(-out + eps)
    return bce_dice_loss(logits, y)


def run_classic(sd, rows: slice, group):
    """The classic UNet's gradient from state dict sd on `rows` of
    classic_batch(), through DDP under `group`."""
    from torch.nn.parallel import DistributedDataParallel

    from cartseg_tpu_torch.models import build_model

    model = build_model("classic")
    model.load_state_dict(sd)
    x, y = classic_batch()

    class Loss(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, x, y):
            return classic_loss(self.m, x, y)

    run = Loss(model)
    if group is not None:
        run = DistributedDataParallel(run, process_group=group)
    run(x[rows], y[rows]).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _case(results: dict, name: str, fn) -> None:
    try:
        results[name] = fn()
    except Exception:  # recorded for the test to show
        results[name] = {"error": traceback.format_exc()}


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, out = sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from cartseg_tpu_torch.parallel import mesh

    backend = mesh.init_distributed(rank, world, f"file://{init_file}",
                                    "cpu", log=lambda *a: None)
    group = dist.group.WORLD
    rows = mesh.host_batch_slice(GLOBAL_BS)
    res = {"backend": backend, "rows": (rows.start, rows.stop)}

    x, w, b, g = bn_inputs()
    for lane in ("torch", "channel_sums"):
        _case(res, f"bn_{lane}",
              lambda lane=lane: run_bn(lane, x[rows], w, b, g[rows], group))

    logits, t = abl_inputs()
    _case(res, "abl", lambda: run_abl(logits[rows], t[rows], group))

    sd = torch.load(out / "classic_sd.pt", weights_only=True)
    _case(res, "classic", lambda: run_classic(sd, rows, group))

    _case(res, "step", lambda: run_step(step_config(), rows))
    _case(res, "step64", lambda: run_step64(rows, group))

    # every rank writes into one out_dir; rank 0 alone may write files
    from cartseg_tpu_torch.train import checkpoint as ckpt_lib
    from cartseg_tpu_torch.utils import io as io_lib

    writes = []

    def spy(owner, name):
        real = getattr(owner, name)

        def f(*a, **kw):
            writes.append(name)
            return real(*a, **kw)
        setattr(owner, name, f)

    for owner, name in ((ckpt_lib, "save"),
                        (ckpt_lib, "save_threshold_sidecar"),
                        (io_lib.CSVLogger, "append"),
                        (io_lib.JSONHistory, "append")):
        spy(owner, name)
    _case(res, "fit", lambda: run_fit(fit_config(out / "fit")))
    res["writes"] = writes

    def refused(**kw):
        from cartseg_tpu_torch.train import Trainer
        try:
            Trainer(step_config(**kw))
        except ValueError as e:
            return str(e)
        return None

    res["odd_batch"] = refused(batch_size=GLOBAL_BS - 1)
    res["no_mesh"] = refused(use_mesh=False)
    torch.save(res, out / f"rank{rank}.pt")
    mesh.barrier("done")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
