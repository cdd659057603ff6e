"""Port parity: models/pretrained.py (ImageNet-format encoder files)
against cartseg_tpu.models.torch_import.load_pretrained_encoder, and the
train_with_pretrained workload with such a file.

The files are seeded raw-named torchvision resnet34 and timm
efficientnet_b0 encoders (benchmarks/torch_smp.py's modules, BN
randomised) with their classifier keys, as .pth (bare and wrapped) and
.npz. JAX's merged variables come back to torch names through
models/convert.jax_variables_to_state_dict. Tolerance: none; the
encoder is copied, so it is bit-equal, and the decoder and head keep
the port's own fresh init bit for bit.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cartseg_tpu.models import build_model as j_build
from cartseg_tpu.models import init_model
from cartseg_tpu.models.torch_import import \
    load_pretrained_encoder as j_load_pretrained

from cartseg_tpu_torch.models import build_model
from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict
from cartseg_tpu_torch.models.pretrained import (load_encoder_state_dict,
                                                 load_pretrained_encoder)
from cartseg_tpu_torch.workloads import train_with_pretrained as t_workload
from torch_port_helpers import (jax_tree_to_numpy,  # noqa: F401
                                one_torch_thread, png_pair_tree)

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
from torch_smp import (EfficientNetB0EncoderTimm, ResNet34EncoderTV,  # noqa
                       randomize_bn_stats)

ENCODERS = {"resnet34": ResNet34EncoderTV,
            "efficientnet-b0": EfficientNetB0EncoderTimm}
CLASSIFIER = {
    "resnet34": {"fc.weight": (1000, 512), "fc.bias": (1000,)},
    "efficientnet-b0": {
        "conv_head.weight": (1280, 320, 1, 1), "bn2.weight": (1280,),
        "bn2.bias": (1280,), "bn2.running_mean": (1280,),
        "bn2.running_var": (1280,), "classifier.weight": (1000, 1280),
        "classifier.bias": (1000,)},
}


def imagenet_state_dict(encoder: str, seed: int) -> dict:
    """A raw-named encoder from a seeded init, BN randomised, with the
    classifier's keys and the BN counters."""
    torch.manual_seed(seed)
    enc = ENCODERS[encoder]()
    randomize_bn_stats(enc, seed=seed + 1)
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    g = torch.Generator().manual_seed(seed + 2)
    for k, shape in CLASSIFIER[encoder].items():
        sd[k] = torch.randn(shape, generator=g)
    sd["bn2.num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.fixture(scope="module", params=list(ENCODERS))
def jax_merged(request):
    """(encoder, file state dict, JAX's merged variables in torch
    names)."""
    encoder = request.param
    sd = imagenet_state_dict(encoder, 3)
    fresh = init_model(j_build(encoder), jax.random.key(0), (1, 32, 32, 3))
    merged = j_load_pretrained(fresh, sd, encoder)
    return encoder, sd, jax_variables_to_state_dict(
        jax_tree_to_numpy(merged), encoder)


def _saved(kind: str, sd: dict, tmp_path: Path) -> Path:
    if kind == "npz":
        p = tmp_path / "enc.npz"
        np.savez(p, **{k: v.numpy() for k, v in sd.items()})
    elif kind == "pth":
        p = tmp_path / "enc.pth"
        torch.save(sd, p)
    else:
        p = tmp_path / f"enc_{kind}.pth"
        torch.save({kind: sd}, p)
    return p


@pytest.mark.parametrize("kind", ["pth", "npz", "state_dict",
                                  "model_state_dict"])
def test_encoder_bit_equal_to_jax_import(jax_merged, kind, tmp_path):
    encoder, sd, want = jax_merged
    torch.manual_seed(0)
    model = build_model(encoder)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = load_pretrained_encoder(
        model, load_encoder_state_dict(_saved(kind, sd, tmp_path)), encoder)
    got = model.state_dict()
    enc_keys = [k for k in got if k.startswith("encoder.")
                and not k.endswith("num_batches_tracked")]
    assert n == len(enc_keys) > 50
    for k in enc_keys:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k[len("encoder."):]]), k
    for k in got:
        if not k.startswith("encoder."):
            assert torch.equal(got[k], before[k]), k   # decoder, head


def test_missing_key_and_shape_mismatch_raise(jax_merged):
    encoder, sd, _ = jax_merged
    first = next(k for k in sd if k.endswith("weight"))
    model = build_model(encoder)
    short = {k: v for k, v in sd.items() if k != first}
    with pytest.raises(KeyError, match="lacks"):
        load_pretrained_encoder(model, short, encoder)
    bad = dict(sd)
    bad[first] = torch.zeros(tuple(sd[first].shape) + (1,))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_encoder(model, bad, encoder)
    extra = dict(sd, **{"layer9.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="encoder lacks"):
        load_pretrained_encoder(model, extra, encoder)


def test_classic_encoder_has_no_imagenet_format():
    with pytest.raises(ValueError, match="ImageNet"):
        load_pretrained_encoder(build_model("resnet18"), {}, "classic")


def test_workload_starts_from_the_file_and_keeps_it_frozen(png_pair_tree,
                                                           tmp_path):
    """The CLI at 64^2 for 1 epoch on the CPU: the artifacts, and the
    encoder's parameters in model.pth equal the file's (frozen for the
    first 8 epochs); its BN running stats moved in train mode."""
    sd = imagenet_state_dict("efficientnet-b0", 5)
    f = tmp_path / "effnet_b0_imagenet.pth"
    torch.save(sd, f)
    ir, mr = png_pair_tree
    out = tmp_path / "run"
    res = t_workload.main(
        ["--images_root", str(ir), "--masks_root", str(mr), "--out_dir",
         str(out), "--device", "cpu", "--img_size", "64", "--batch_size",
         "2", "--epochs", "1", "--num_threads", "2",
         "--pretrained_encoder", str(f)], log=lambda *a: None)
    assert np.isfinite(res["best_val_dice"])
    for name in ("training_metrics.csv", "history.json", "model.pth",
                 "model.threshold.json", "model.last.pth"):
        assert (out / name).exists(), name
    got = torch.load(out / "model.pth", weights_only=False)[
        "model_state_dict"]
    params = {n for n, _ in build_model("efficientnet-b0")
              .named_parameters()}
    moved = 0
    for k, v in sd.items():
        key = "encoder." + k
        if key in params:
            assert torch.equal(got[key], v), key
        elif k.endswith("running_mean") and key in got:
            moved += not torch.equal(got[key], v)
    assert moved > 0
