"""Training: config, schedules, per-group AdamW, checkpoints and the
engine (counterpart of cartseg_tpu/train)."""

from cartseg_tpu_torch.train.config import (LossSpec, SourceSpec,  # noqa: F401
                                            TrainConfig)
from cartseg_tpu_torch.train.engine import Trainer  # noqa: F401
