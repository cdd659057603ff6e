"""Workload configuration (counterpart of cartseg_tpu/train/config.py).

The same dataclasses, fields and defaults as the JAX package, so a
workload's `CONFIG` literal and its CLI read the same, plus `device`:
"cuda" by default, and `--device cpu` is the only way onto the CPU.
Every field is overridable from the CLI (``--field value``).

A field the port does not run (an Orbax `init_checkpoint`) is accepted
at its default and raises `NotImplementedError` when set
(`check_supported`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class LossSpec:
    """Named loss + kwargs, resolved by the engine.

    names: bce_dice | bce_dice_per_sample | focal_dice | boundary |
    bce_dice_abl."""
    name: str = "bce_dice"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SourceSpec:
    """A mixed-training data source (finetune_for_224.py:145-161)."""
    name: str
    images_root: str
    masks_root: str
    ratio: float = 1.0
    loss_weight: float = 1.0
    oversample: float = 1.0


DECODERS = ("unet", "unetpp", "unetpp_ds")


@dataclasses.dataclass
class TrainConfig:
    # --- model (train_bce_dice.py:293-301 defaults)
    encoder: str = "resnet34"
    decoder: str = "unet"  # unet | unetpp | unetpp_ds (deep supervision)
    classes: int = 1
    compute_dtype: str = "bfloat16"   # autocast dtype; fp32 params
    remat: bool = False
    init_checkpoint: Optional[str] = None       # flax ckpt dir (JAX only)
    init_torch_checkpoint: Optional[str] = None  # reference .pth
    pretrained_encoder: Optional[str] = None

    # --- data
    images_root: Optional[str] = None
    masks_root: Optional[str] = None
    image_roots: List[str] = dataclasses.field(default_factory=list)
    sources: List[SourceSpec] = dataclasses.field(default_factory=list)
    sources_json: str = ""
    img_size: Tuple[int, int] = (512, 512)
    side_padding_ratio: float = 0.1
    imagenet_norm: bool = False
    batch_size: int = 6
    val_frac: float = 0.2
    split: str = "session_sorted"  # session_sorted | session_seeded | random
    val_source: Optional[str] = None
    num_threads: int = 4
    synthetic: bool = False            # generate a synthetic PNG tree
    synthetic_sessions: int = 4
    synthetic_per_session: int = 8

    # --- optimization (train_bce_dice.py:34-38)
    epochs: int = 50
    lr: float = 1e-4
    weight_decay: float = 1e-4
    patience: int = 7
    seed: int = 42
    clip_grad_norm: float = 0.0   # >0 enables global-norm clipping
    skip_nonfinite: bool = True   # drop updates from non-finite losses
    loss: LossSpec = dataclasses.field(default_factory=LossSpec)
    encoder_lr_scale: float = 1.0
    head_lr_scale: float = 1.0
    freeze_encoder_epochs: int = 0
    unfreeze_encoder_lr_scale: float = 1.0
    pseudo_w_start: float = 0.4
    pseudo_w_end: float = 0.6
    pseudo_ramp_epochs: int = 4
    use_curriculum: bool = False

    # --- augmentation
    augment: str = "train_512"  # train_512 | train_224 | none

    # --- output
    out_dir: str = "runs/default"
    checkpoint_name: str = "model"
    save_optimizer_state: bool = True  # ref saves it (train_bce_dice.py:371)
    # resume=True continues from <name>.last.pth exactly (params, BN
    # buffers, moments, generator state, early-stop counters); with only
    # a best <name>.pth it restarts from the best epoch
    resume: bool = False
    save_last: bool = True     # write <name>.last.pth every epoch
    stop_after_epoch: Optional[int] = None
    metrics_schema: str = "basic"  # basic | prf1 | abl
    threshold_sweep: Tuple[float, float, int] = (0.2, 0.8, 13)
    # the port's best checkpoint is always the reference .pth; the JAX
    # switch for its optional export has nothing left to switch
    save_torch_checkpoint: bool = False

    # --- parallelism
    # train over the initialised process group (DDP, BN statistics summed
    # over the ranks, each rank its rows of every global batch); nothing
    # changes in a single process. False under a group of several ranks
    # raises, as does a global batch that does not divide over them
    use_mesh: bool = True

    # --- observability
    trace_dir: str = ""
    log_throughput: bool = True

    # --- the port's own: the device the run uses (cuda | cpu)
    device: str = "cuda"

    def out_path(self) -> Path:
        p = Path(self.out_dir)
        p.mkdir(parents=True, exist_ok=True)
        return p

    def with_overrides(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: TrainConfig) -> None:
    """Raise for a field set to a value the port does not run (never
    ignore it silently): an Orbax `init_checkpoint` (ROADMAP.md Queue 1
    item 1) and a decoder that names no model family."""
    todo = []
    if cfg.decoder not in DECODERS:
        todo.append(f"decoder {cfg.decoder!r} (one of {DECODERS})")
    if cfg.init_checkpoint:
        todo.append("init_checkpoint: an Orbax directory of the JAX "
                    "package; give a .pth as init_torch_checkpoint")
    if todo:
        raise NotImplementedError(
            "cartseg_tpu_torch does not run these settings: "
            + "; ".join(todo))


def apply_cli_overrides(cfg: TrainConfig, argv: List[str]) -> TrainConfig:
    """`--field value` overrides; booleans accept true/false; tuples and
    lists parsed from comma-separated values."""
    kw: Dict[str, Any] = {}
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        name = arg[2:].replace("-", "_")
        if name not in fields:
            raise SystemExit(f"unknown config field {name!r}")
        f = fields[name]
        if f.type == "bool" or isinstance(getattr(cfg, name), bool):
            if i + 1 < len(argv) and argv[i + 1].lower() in ("true", "false"):
                kw[name] = argv[i + 1].lower() == "true"
                i += 2
            else:
                kw[name] = True
                i += 1
            continue
        val = argv[i + 1]
        cur = getattr(cfg, name)
        if isinstance(cur, tuple):
            parts = val.split(",")
            if not cur:
                kw[name] = tuple(parts)
            elif len(parts) == 1 and len(cur) > 1 and \
                    len({type(c) for c in cur}) == 1:
                # a single value broadcasts over a homogeneous tuple
                # (--img_size 64 means 64x64)
                kw[name] = tuple(type(cur[0])(parts[0]) for _ in cur)
            elif len(parts) != len(cur):
                raise SystemExit(
                    f"--{name} expects {len(cur)} comma-separated "
                    f"values (got {len(parts)}: {val!r})")
            else:
                kw[name] = tuple(type(c)(p) for c, p in zip(cur, parts))
        elif isinstance(cur, list):
            kw[name] = val.split(",") if val else []
        elif isinstance(cur, int) and not isinstance(cur, bool):
            kw[name] = int(val)
        elif isinstance(cur, float):
            kw[name] = float(val)
        elif isinstance(cur, LossSpec):
            kw[name] = LossSpec(name=val)
        elif f.type == "Optional[int]":
            # the JAX parser keeps the string here (--stop_after_epoch 1
            # then fails in the epoch loop); the port parses the int
            kw[name] = int(val)
        else:
            kw[name] = val
        i += 2
    return cfg.with_overrides(**kw)
