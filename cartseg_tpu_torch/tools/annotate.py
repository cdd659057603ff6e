"""The SAM entry point of the annotation tools (counterpart of
cartseg_tpu/tools/annotate.py `load_sam`).

`load_sam` builds the port's SAM ViT-B predictor (models/sam.py) from an
official `sam_vit_b_*.pth` checkpoint on the given device. The JAX
package's host `segment_anything` backend is not ported: the port's own
predictor is the only backend. The cv2 UI (`run_ui`), `seg_friendly`,
`smooth_mask`, `fill_holes`, `AnnotationSession`, `PrefetchWorker` and
`TPUProposer` are not ported yet (ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from cartseg_tpu_torch.models.sam import SamConfig, load_sam_checkpoint


def load_sam(checkpoint: Optional[Path] = None, model_type: str = "vit_b",
             *, device="cuda", cfg: Optional[SamConfig] = None):
    """A predictor with the SamPredictor interface, or None without a
    checkpoint or for a model type other than vit_b (as the JAX
    package's TPU backend). Runs on `device`: the card by default, the
    CPU only when asked."""
    if checkpoint is None or model_type != "vit_b":
        return None
    return load_sam_checkpoint(checkpoint, cfg, device=device)
