"""SAM ViT-B on the port's training path (a MedSAM box-prompted fine-tune
through `Trainer.train_step`) against the plain reference of the
benchmark, cellbench/reference/sam.py, on the CPU in float32, at a small
config on seeded weights (cellbench/weights_sam.py): img 128 in 8-px
patches (a 16 x 16 grid, so the global block takes the flash lane's
plain version), 2 blocks with the second global, 64 wide.

Tolerances, each measured here first (float32; the two sides sum in
other orders, and the port scales q before the decoder attention's
product), and what the same step computing in bf16 reads:
  - logits: max |l - l_ref| within 1e-5 of max |l_ref| (measured 3.5e-7;
    bf16 8.5e-3);
  - loss: 1e-5 relative (measured 1.3e-7; bf16 4.6e-4);
  - gradients: each trained leaf's relative L2 within 1e-4 (measured at
    most 2.0e-6; bf16 0.31);
  - one AdamW step: the update of each trained leaf, p - p0, within 2e-3
    relative L2 of the reference's (measured at most 3.9e-4: the update
    is read as a difference of float32 parameters, and an ulp of a
    weight near 0.1, 7.5e-9, is 7.5e-5 of the 1e-4 step; bf16 0.58, where
    Adam's first step, lr sign(g), follows the gradients' flipped signs).
`test_bf16_compute_breaks_the_tolerances` checks the last claims. The
attention's key biases (the decoder's `k_proj` biases, the middle third
of each encoder `qkv` bias) have no gradient: a bias on every key adds
one constant to a softmax row. Theirs is rounding noise, whose sign
Adam's first step follows, so they are left out of the gradient and
update comparisons (`_signal`); `test_the_key_biases_have_no_gradient`
holds them to that.
"""

import json

import pytest
import torch

from cartseg_tpu_torch.data.augment import AugmentConfig, draw_augment
from cartseg_tpu_torch.models.factory import build_model, param_groups
from cartseg_tpu_torch.models.sam import Sam, SamConfig
from cartseg_tpu_torch.train import LossSpec, TrainConfig, Trainer
from cartseg_tpu_torch.train.engine import (BOX_JITTER, TrainState,
                                            mask_boxes)
from cartseg_tpu_torch.train.optim import init_adamw
from cellbench.inputs import blob_frames, blob_masks
from cellbench.reference import sam as ref
from cellbench.tests.tiny import REPO
from cellbench.weights_sam import make_weights
from torch_port_helpers import one_torch_thread  # noqa: F401

SMALL = dict(img_size=128, patch_size=8, encoder_dim=64, encoder_depth=2,
             encoder_heads=2, window_size=6, global_attn_indexes=(1,),
             prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64)
SIZES = ref.Sizes(**SMALL)
TRAFFIC = json.loads((REPO / "cellbench/traffic/train_medsam.bs16_1024.json")
                     .read_text())
SEED, AUG_SEED = 2 ** 31 + 41, 2 ** 31 + 7
TOL = {"logits": 1e-5, "loss": 1e-5, "grad": 1e-4, "update": 2e-3}


def _config(**kw):
    base = dict(encoder="sam_vit_b", img_size=(128, 128), imagenet_norm=True,
                batch_size=3, compute_dtype="float32", weight_decay=0.01,
                loss=LossSpec("bce_dice", {"bce_weight": 0.5, "smooth": 1.0}),
                device="cpu")
    return TrainConfig(**dict(base, **kw))


def _inputs():
    """Seeded weights, one batch of blob frames and masks (one mask empty,
    one a rectangle on the border)."""
    gen = torch.Generator().manual_seed(SEED)
    params = make_weights(SIZES, gen, "cpu")
    images = blob_frames(gen, 3, 128, 8, "cpu")
    masks = blob_masks(gen, 3, 128, 3, "cpu")
    masks[1] = 0.0
    masks[2] = 0.0
    masks[2, 90:, 40:100] = 1.0
    return params, images, masks


def _port_step(dtype=torch.float32):
    """One Trainer.train_step of the small SAM from the seeded weights:
    (state before as tensors, logits of the step, the state after)."""
    params, images, masks = _inputs()
    trainer = Trainer(_config())
    model = Sam(SamConfig(**SMALL, global_attn_flash=True), dtype)
    model.load_state_dict(params)
    state = TrainState(model=model,
                       opt=init_adamw(dict(model.named_parameters())),
                       gen=torch.Generator().manual_seed(AUG_SEED))
    gids = trainer.group_ids(state)
    kept = {}

    def keep(module, inputs, out):
        kept["logits"] = out.detach().to(torch.float32)
        kept["boxes"] = inputs[1].clone()

    model.register_forward_hook(keep)
    loss, ok, _ = trainer.train_step(state, images, masks, torch.ones(3),
                                     [1e-4] * 3, [1.0] * 3, gids)
    return params, state, gids, dict(kept, loss=float(loss), ok=float(ok))


@pytest.fixture(scope="module")
def steps():
    """The port's float32 step and the reference's, on the same weights,
    batch and generator seed."""
    params, state, gids, port = _port_step()
    _, images, masks = _inputs()
    want = ref.follow(SIZES, params, [(images, masks)], AUG_SEED, TRAFFIC,
                      chunk=100)
    return params, state, gids, port, want


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _signal(name, t):
    """Leaf `name` without its key-bias part, whose gradient is 0."""
    if name.endswith("k_proj.bias"):
        return t[:0]
    if name.endswith("attn.qkv.bias"):
        d = t.shape[0] // 3
        return torch.cat([t[:d], t[2 * d:]])
    return t


def _key_bias(name, t):
    return t[t.shape[0] // 3:2 * t.shape[0] // 3] \
        if name.endswith("attn.qkv.bias") else t


def _gaps(params, state, gids, port, want):
    """The four compared numbers of a port step against the reference."""
    b1 = TRAFFIC["optimizer"]["b1"]
    ref_logits = want["logits"].permute(0, 3, 1, 2)
    grads = {k: state.opt.mu[k] / (1 - b1) for k in gids}
    moved = dict(state.model.named_parameters())
    return {
        "logits": float((port["logits"] - ref_logits).abs().max()
                        / ref_logits.abs().max()),
        "loss": abs(port["loss"] - want["losses"][0]) / want["losses"][0],
        "grad": max(_rel(_signal(k, grads[k]),
                         _signal(k, want["first_grad"][k])) for k in gids),
        "update": max(_rel(_signal(k, moved[k].detach() - params[k]),
                           _signal(k, want["params"][k] - params[k]))
                      for k in gids),
    }


@pytest.mark.parametrize("number", sorted(TOL))
def test_the_step_matches_the_reference(steps, number):
    params, state, gids, port, want = steps
    assert port["ok"] == 1.0
    assert set(gids) == set(want["first_grad"])
    got = _gaps(params, state, gids, port, want)[number]
    assert got <= TOL[number], (number, got)


def test_the_key_biases_have_no_gradient(steps):
    """Each key bias's reference gradient is under 1e-5 of the median
    leaf's: rounding alone."""
    _, _, gids, _, want = steps
    g = want["first_grad"]
    med = float(torch.tensor([float(v.norm()) for v in g.values()]).median())
    keys = [k for k in gids if k.endswith(("k_proj.bias", "attn.qkv.bias"))]
    assert len(keys) == 7 + 2
    for k in keys:
        assert float(_key_bias(k, g[k]).norm()) < 1e-5 * med, k


def test_bf16_compute_breaks_the_tolerances(steps):
    """The same step computing in bf16 misses every tolerance by 10x or
    more, so a float32 program that slipped into bf16 would fail above."""
    params, _, _, _, want = steps
    _, state, gids, port = _port_step(torch.bfloat16)
    got = _gaps(params, state, gids, port, want)
    assert all(got[k] > 10 * TOL[k] for k in TOL), got


def test_the_step_takes_the_reference_boxes(steps):
    _, _, _, port, want = steps
    assert torch.equal(port["boxes"], want["boxes"][0])
    # the empty mask stays empty through the augmentation: the frame
    assert port["boxes"][1].tolist() == [0.0, 0.0, 128.0, 128.0]


@pytest.mark.parametrize("prefix", ["prompt_encoder.",
                                    "mask_decoder.iou_prediction_head."])
def test_frozen_parameters_come_out_bit_equal(steps, prefix):
    params, state, gids, _, _ = steps
    frozen = [k for k in params if k.startswith(prefix)]
    assert frozen and not set(frozen) & set(gids)
    sd = state.model.state_dict()
    for k in frozen:
        assert torch.equal(sd[k], params[k]), k


@pytest.mark.parametrize("jitter", [0, 20])
def test_boxes_match_the_reference_rule(jitter):
    """mask_boxes against reference/sam.py `box_prompts` on fixed masks
    and the same draws: a blob, an empty mask, one pixel, a mask on the
    border, a full one."""
    masks = torch.zeros((5, 48, 40, 1))
    masks[0] = blob_masks(torch.Generator().manual_seed(3), 1, 48, 3,
                          "cpu")[0, :, :40]
    masks[2, 17, 9] = 1.0
    masks[3, 30:, :12] = 1.0
    masks[4] = 1.0
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    got = mask_boxes(masks, g1 if jitter else None, jitter)
    want = ref.box_prompts(masks.permute(0, 3, 1, 2), g2, jitter)
    assert torch.equal(got, want)
    if jitter == 0:
        assert got[1].tolist() == [0.0, 0.0, 40.0, 48.0]
        assert got[2].tolist() == [9.0, 17.0, 9.0, 17.0]
        assert got[3].tolist() == [0.0, 30.0, 11.0, 47.0]
        # no draw without jitter; one [B, 4] draw with it
        assert torch.equal(g1.get_state(), g2.get_state())
    else:
        assert (got[:, :2] >= 0).all() and (got[:, 2] <= 40).all()
        assert (got[:, 3] <= 48).all()


def _draws_after_augment(gen, cfg, b, h, w, extra=None):
    """The generator's state after the augmentation's draws (and `extra`)
    from a copy of `gen`."""
    g = torch.Generator().manual_seed(0)
    g.set_state(gen.get_state())
    draw_augment(g, b, h, w, cfg, "cpu")
    if extra is not None:
        extra(g)
    return g.get_state()


@pytest.mark.parametrize("encoder", ["resnet18", "sam_vit_b"])
def test_the_step_draws_the_augmentation_then_the_boxes(encoder):
    """A UNet step draws the augmentation's draws and nothing else, as
    before SAM; a SAM step the same draws, then one [B, 4] box draw."""
    if encoder == "sam_vit_b":
        params, images, masks = _inputs()
        trainer = Trainer(_config())
        model = Sam(SamConfig(**SMALL, global_attn_flash=True))
        model.load_state_dict(params)
        extra = (lambda g: torch.randint(0, 21, (3, 4), generator=g))
    else:
        gen = torch.Generator().manual_seed(5)
        images = blob_frames(gen, 2, 32, 4, "cpu")
        masks = blob_masks(gen, 2, 32, 4, "cpu")
        trainer = Trainer(TrainConfig(encoder="resnet18", img_size=(32, 32),
                                      batch_size=2, compute_dtype="float32",
                                      device="cpu"))
        model = build_model("resnet18")
        extra = None
    state = TrainState(model=model,
                       opt=init_adamw(dict(model.named_parameters())),
                       gen=torch.Generator().manual_seed(9))
    b, h, w, _ = images.shape
    want = _draws_after_augment(state.gen, trainer.aug_cfg, b, h, w, extra)
    trainer.train_step(state, images, masks, torch.ones(b), [1e-4] * 3,
                       [1.0] * 3, trainer.group_ids(state))
    assert torch.equal(state.gen.get_state(), want)


def test_build_model_and_param_groups_at_the_published_widths():
    model = build_model("sam_vit_b", dtype=torch.bfloat16)
    assert isinstance(model, Sam) and model.dtype == torch.bfloat16
    assert model.cfg == SamConfig(global_attn_flash=True)
    published = ref.Sizes()
    for key in ("img_size", "patch_size", "encoder_dim", "encoder_depth",
                "encoder_heads", "window_size", "global_attn_indexes",
                "prompt_dim", "decoder_heads", "decoder_mlp_dim",
                "decoder_depth"):
        assert getattr(model.cfg, key) == getattr(published, key), key
    conf = json.loads((REPO / "cellbench/configs/sam_vit_b.json").read_text())
    n = sum(p.numel() for p in model.parameters())
    n += sum(b.numel() for b in model.buffers())
    assert n == conf["parameters"]
    groups = param_groups(model)
    names = dict(model.named_parameters())
    assert sum(names[k].numel() for k in groups) == \
        conf["trained_parameters"]
    for k in names:
        if k.startswith("image_encoder."):
            assert groups[k] == "encoder", k
        elif ref.trained(k):
            assert groups[k] == "decoder", k
        else:
            assert k not in groups, k


@pytest.mark.parametrize("kw", [{"img_size": (128, 96)},
                                {"img_size": (120, 120)},
                                {"imagenet_norm": False}, {"remat": True},
                                {"classes": 2}, {"decoder": "unetpp"},
                                {"pretrained_encoder": "enc.pth"}])
def test_unsupported_sam_settings_raise(kw):
    with pytest.raises(NotImplementedError):
        Trainer(_config(**kw))


def test_the_finetune_workload_config():
    from cartseg_tpu_torch.workloads import finetune_sam
    c = finetune_sam.CONFIG
    assert (c.encoder, c.img_size, c.imagenet_norm, c.batch_size, c.lr,
            c.weight_decay, c.loss.name) == ("sam_vit_b", (1024, 1024),
                                             True, 16, 1e-4, 0.01,
                                             "bce_dice")
    # MedSAM's jitter, which the benchmark's traffic gives its reference
    assert BOX_JITTER == TRAFFIC["box_jitter"] == 20
    assert TRAFFIC["batch"] == c.batch_size
    trainer = Trainer(_config(img_size=c.img_size, batch_size=c.batch_size))
    assert trainer.promptable
    assert trainer.aug_cfg == AugmentConfig.train_512(True)
