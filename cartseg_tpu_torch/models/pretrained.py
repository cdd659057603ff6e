"""ImageNet-format encoder checkpoints (counterpart of
cartseg_tpu/models/torch_import.py:169-227 and train/engine.py:94-105):
smp's `encoder_weights="imagenet"` (train_bce_dice.py:297;
src/train_with_pretrained.py:317-325) from a file the user gives.

The file holds a raw torchvision resnet34/resnet18 or timm
efficientnet_b0 state dict, without the "encoder." prefix. The port's
encoders carry those names (models/resnet.py, models/efficientnet.py),
so each tensor is copied into `model.encoder` under its own name. The
classifier (top-level fc.*, classifier.*, conv_head.*, bn2.*) and the
BN `num_batches_tracked` counters are not read; a block's own bn2
(blocks.g.r.bn2) is. The decoder and the head keep their fresh init.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn as nn

# top-level modules of the ImageNet classifiers that the encoder lacks
CLASSIFIER_PREFIXES = ("fc.", "classifier.", "conv_head.", "bn2.")
# the JAX import's check against a file that matched almost nothing
MIN_TENSORS = 50


def load_encoder_state_dict(path) -> Dict[str, torch.Tensor]:
    """A raw encoder checkpoint: a .pth (torch.load, weights only) or an
    .npz of torch-named arrays. A {'state_dict': ...} or
    {'model_state_dict': ...} wrapper is unwrapped."""
    p = Path(path)
    if p.suffix == ".npz":
        with np.load(p) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    sd = torch.load(p, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd.get("model_state_dict", sd))
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _skipped(key: str) -> bool:
    return key.startswith(CLASSIFIER_PREFIXES) or \
        key.endswith("num_batches_tracked")


@torch.no_grad()
def load_pretrained_encoder(model: nn.Module, state_dict,
                            encoder: str) -> int:
    """Copy a raw torchvision/timm state dict into `model.encoder` in
    place; returns the number of tensors copied. Every encoder parameter
    and BN buffer must be in the file (KeyError), with its shape
    (ValueError); a file key the encoder lacks raises KeyError too."""
    if not (encoder.startswith("resnet") or encoder == "efficientnet-b0"):
        raise ValueError(f"no ImageNet checkpoint format for {encoder!r}")
    target = {k: v for k, v in model.encoder.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    given = {k: v for k, v in state_dict.items() if not _skipped(k)}
    missing = sorted(set(target) - set(given))
    if missing:
        raise KeyError(f"{encoder} checkpoint lacks {len(missing)} encoder "
                       f"tensors, e.g. {missing[:3]}")
    extra = sorted(set(given) - set(target))
    if extra:
        raise KeyError(f"{encoder} checkpoint has {len(extra)} tensors the "
                       f"encoder lacks, e.g. {extra[:3]}")
    for k, dst in target.items():
        src = torch.as_tensor(given[k])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape mismatch at encoder.{k}: model "
                             f"{tuple(dst.shape)} vs checkpoint "
                             f"{tuple(src.shape)}")
    if len(target) <= MIN_TENSORS:
        raise ValueError(f"suspiciously small encoder import: "
                         f"{len(target)} tensors")
    for k, dst in target.items():
        dst.copy_(torch.as_tensor(given[k]).to(dst.dtype))
    return len(target)
