"""Export a trained segmenter to a self-contained `torch.export` artifact
(counterpart of cartseg_tpu/serve/export.py, whose artifact is a JAX
StableHLO module).

The exported program is the full device-side inference path: uint8
letterboxed [B,H,W,3] -> normalise -> model forward (eval-mode BN) in
`compute_dtype` -> fp32 sigmoid probabilities [B,H,W], at one static
batch, traced by `torch.export.export` on the device it will serve on
and saved by `torch.export.save`. The weights are in the program; the
artifact runs with PyTorch alone, without the port's model code.

Artifact layout:
    <dir>/model.pt2       torch.export program (weights embedded)
    <dir>/manifest.json   encoder, img hw, batch, dtype, threshold,
                          normalisation, the devices exported for

The input is a port `.pth` (reference names, as the trainers save it) or
an in-memory state dict; the decision threshold comes from the
`<name>.threshold.json` sidecar (infer/engine.py
`read_threshold_sidecar`), 0.5 without one. The JAX package's
`embed_params=False` (weights as a msgpack sidecar) served relayed,
remote-compile runtimes that refuse large literal blobs (its
export.py:14-19); the port raises NotImplementedError for it.

    python -m cartseg_tpu_torch.serve.export --checkpoint run/model.pth \\
        --out artifact [--encoder resnet34 --img 512 --batch_size 16 \\
        --compute_dtype bfloat16 --device cuda]
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from cartseg_tpu_torch import geometry
from cartseg_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.infer.engine import (model_input, prepare_model,
                                            read_threshold_sidecar)
from cartseg_tpu_torch.models.factory import build_model

# artifact schema version: bump on any incompatible manifest or program
# change; loaders refuse artifacts from a NEWER schema than they know
ARTIFACT_FORMAT = "cartseg_tpu_torch.segmenter"
ARTIFACT_VERSION = 1
PROGRAM = "model.pt2"
# the JAX package's artifact, which this loader refuses by name
JAX_FORMAT, JAX_PROGRAM = "cartseg_tpu.segmenter", "model.stablehlo"
_REQUIRED_MANIFEST_KEYS = ("batch_size", "img_hw", "threshold")
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def validate_manifest(artifact_dir) -> dict:
    """Load and check an artifact directory's manifest before the program
    is read: a clear error here beats a deserializer's trace (or serving
    with a wrong threshold) later."""
    d = Path(artifact_dir)
    mpath = d / "manifest.json"
    if not mpath.exists():
        raise ValueError(f"{d}: not a serving artifact "
                         "(manifest.json missing)")
    try:
        manifest = json.loads(mpath.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(f"{mpath}: corrupt manifest ({e})") from e
    fmt = manifest.get("format", ARTIFACT_FORMAT)
    if fmt == JAX_FORMAT or (d / JAX_PROGRAM).exists():
        raise ValueError(
            f"{d}: a JAX serving artifact ({JAX_PROGRAM}, format "
            f"{JAX_FORMAT!r}) is not a {ARTIFACT_FORMAT!r} artifact; "
            "re-export the checkpoint with python -m "
            "cartseg_tpu_torch.serve.export")
    if fmt != ARTIFACT_FORMAT:
        raise ValueError(f"{d}: unknown artifact format {fmt!r} "
                         f"(expected {ARTIFACT_FORMAT!r})")
    ver = int(manifest.get("artifact_version", 1))
    if ver > ARTIFACT_VERSION:
        raise ValueError(
            f"{d}: artifact_version {ver} is newer than this loader "
            f"supports ({ARTIFACT_VERSION}) - upgrade cartseg_tpu_torch")
    missing = [k for k in _REQUIRED_MANIFEST_KEYS if k not in manifest]
    if missing:
        raise ValueError(f"{d}: manifest missing keys {missing}")
    if not (d / PROGRAM).exists():
        raise ValueError(f"{d}: {PROGRAM} missing")
    if not manifest.get("embed_params", True):
        raise ValueError(f"{d}: manifest says embed_params=false but "
                         "params.msgpack is missing (the port's artifacts "
                         "embed their weights)")
    return manifest


class InferenceModule(nn.Module):
    """uint8 [B,H,W,3] letterboxed RGB -> fp32 [B,H,W] probabilities: the
    module `export_segmenter` exports, and its eager counterpart. The
    math is the pseudo-labeller's for one member (infer/engine.py
    `_ensemble_forward`)."""

    def __init__(self, model: nn.Module, mean, std):
        super().__init__()
        self.model = model
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32))

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        x = model_input((x_u8.to(torch.float32) / 255.0 - self.mean)
                        / self.std)
        dtype = next(self.model.parameters()).dtype
        logits = self.model(x.to(dtype))
        return torch.sigmoid(logits[:, 0].to(torch.float32))


def inference_module(state_dict, encoder: str, device, compute_dtype: str,
                     imagenet_norm: bool) -> InferenceModule:
    """The eval model from a reference-named state dict on `device` in
    `compute_dtype` (infer/engine.py `prepare_model`), normalisation in
    front and the sigmoid behind."""
    model = build_model(encoder)
    model.load_state_dict(state_dict)
    model = prepare_model(model, device, _DTYPES[compute_dtype])
    mean = IMAGENET_MEAN if imagenet_norm else (0.0, 0.0, 0.0)
    std = IMAGENET_STD if imagenet_norm else (1.0, 1.0, 1.0)
    return InferenceModule(model, mean, std).to(resolve_device(device))


def export_segmenter(
    out_dir,
    checkpoint=None,
    state_dict=None,
    encoder: str = "resnet34",
    img_hw: Tuple[int, int] = (512, 512),
    batch_size: int = 16,
    threshold: Optional[float] = None,
    imagenet_norm: bool = False,
    compute_dtype: str = "bfloat16",
    device="cuda",
    embed_params: bool = True,
) -> Path:
    """Build the artifact from a `.pth` (with its `.threshold.json`
    sidecar) or an in-memory state dict, on `device`. Returns the
    artifact path."""
    if not embed_params:
        raise NotImplementedError(
            "embed_params=False (weights shipped as a msgpack sidecar) "
            "served relayed, remote-compile runtimes that refuse large "
            "literal blobs (cartseg_tpu/serve/export.py:14-19); the port's "
            "torch.export artifact embeds its weights")
    if img_hw[0] != img_hw[1]:
        raise ValueError(f"img_hw {tuple(img_hw)}: the letterbox is square")
    if state_dict is None:
        if checkpoint is None:
            raise ValueError("need checkpoint or state_dict")
        sd = torch.load(str(checkpoint), map_location="cpu",
                        weights_only=True)
        state_dict = sd.get("model_state_dict", sd)
        if threshold is None:
            threshold = read_threshold_sidecar(Path(checkpoint))
    threshold = 0.5 if threshold is None else float(threshold)
    dev = resolve_device(device)
    module = inference_module(state_dict, encoder, dev, compute_dtype,
                              imagenet_norm)
    example = torch.zeros((batch_size, img_hw[0], img_hw[1], 3),
                          dtype=torch.uint8, device=dev)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out / PROGRAM))
    (out / "manifest.json").write_text(json.dumps({
        "format": ARTIFACT_FORMAT,
        "artifact_version": ARTIFACT_VERSION,
        "encoder": encoder,
        "img_hw": list(img_hw),
        "batch_size": batch_size,
        "threshold": threshold,
        "imagenet_norm": imagenet_norm,
        "compute_dtype": compute_dtype,
        "platforms": [dev.type],
        "embed_params": True,
        "torch": torch.__version__,
        "input": "uint8 [B,H,W,3] letterboxed RGB",
        "output": "float32 [B,H,W] sigmoid probabilities",
    }, indent=1))
    return out


class ServedSegmenter:
    """A loaded artifact: the fixed-batch program on its device, and the
    geometry around it.

    `predict_probs(batch_u8)` pads a ragged batch to the exported batch
    with zeros (the program has one static shape) and strips the padding
    after. `segment(image)` runs one RGB frame of any size end to end:
    letterbox (the native loader) -> infer -> threshold -> inverse
    letterbox (nearest)."""

    def __init__(self, artifact_dir, device=None):
        d = Path(artifact_dir)
        self.manifest = validate_manifest(d)
        platforms = self.manifest.get("platforms") or ["cuda"]
        dev = resolve_device(platforms[0] if device is None else device)
        if dev.type not in platforms:
            raise ValueError(f"{d}: exported for {platforms}, not for "
                             f"{dev.type}; export it on that device")
        self.device = dev
        self.batch_size = int(self.manifest["batch_size"])
        self.img_hw = tuple(self.manifest["img_hw"])
        self.threshold = float(self.manifest["threshold"])
        self._program = torch.export.load(str(d / PROGRAM)).module()
        if dev.type == "cuda":
            self._program = self._program.to(dev)

    def predict_probs(self, batch_u8) -> np.ndarray:
        """uint8 [n,H,W,3] (numpy or a tensor), n <= batch_size -> fp32
        [n,H,W] probabilities (numpy)."""
        x = torch.as_tensor(batch_u8)
        n = x.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch {n} > exported {self.batch_size}")
        x = x.to(self.device)
        if n < self.batch_size:
            x = torch.cat([x, x.new_zeros((self.batch_size - n,)
                                          + tuple(x.shape[1:]))])
        with torch.inference_mode():
            probs = self._program(x)
        return probs[:n].cpu().numpy()

    def segment(self, image: np.ndarray) -> np.ndarray:
        """HxWx3 uint8 RGB at any resolution -> HxW uint8 {0,255} mask
        at the original resolution."""
        h, w = image.shape[:2]
        x = geometry.letterbox_resize(image, self.img_hw[0])
        probs = self.predict_probs(x[None])[0]
        mask = (probs >= self.threshold).astype(np.uint8) * 255
        return geometry.remove_letterbox(mask, orig_w=w, orig_h=h)


def load_segmenter(artifact_dir, device=None) -> ServedSegmenter:
    return ServedSegmenter(artifact_dir, device)


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a checkpoint to a serving artifact")
    ap.add_argument("--checkpoint", required=True,
                    help="the trainer's .pth (reference names)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--encoder", default="resnet34")
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--imagenet_norm", action="store_true")
    ap.add_argument("--threshold", type=float, default=None,
                    help="override the .threshold.json sidecar")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=sorted(_DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no_embed_params", action="store_true",
                    help="not supported by the port (the JAX package's "
                         "relay-only weights sidecar)")
    args = ap.parse_args(argv)
    out = export_segmenter(
        args.out, checkpoint=args.checkpoint, encoder=args.encoder,
        img_hw=(args.img, args.img), batch_size=args.batch_size,
        threshold=args.threshold, imagenet_norm=args.imagenet_norm,
        compute_dtype=args.compute_dtype, device=args.device,
        embed_params=not args.no_embed_params)
    print(f"artifact: {out}")
    print((out / "manifest.json").read_text())
    return out


if __name__ == "__main__":
    main()
