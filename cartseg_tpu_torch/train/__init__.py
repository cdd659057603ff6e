"""Training: config, schedules, per-group AdamW, checkpoints and the
engine (counterpart of cartseg_tpu/train)."""

from cartseg_tpu_torch.train.config import LossSpec, TrainConfig  # noqa: F401
from cartseg_tpu_torch.train.engine import Trainer  # noqa: F401
