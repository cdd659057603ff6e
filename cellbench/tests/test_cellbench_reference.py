"""The plain reference against the port at a tiny size on the CPU, where
both compute in float32: the UNets, the pseudo-labelling batch, the
augmentation at given draws, the losses and the AdamW step."""

import pytest
import torch

from cellbench.inputs import blob_frames, blob_masks
from cellbench.reference import pseudo_label as ref_pl
from cellbench.reference import train as ref_tr
from cellbench.reference.unet import Net
from cellbench.weights import make_weights, port_state_dict

ENCODERS = ("resnet34", "efficientnet-b0")


def _port_model(encoder, params):
    from cartseg_tpu_torch.models.factory import build_model
    model = build_model(encoder)
    model.load_state_dict(port_state_dict(params))
    return model


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("train", (False, True))
def test_unet_matches_the_port(encoder, train):
    gen = torch.Generator().manual_seed(2 ** 31 + 3)
    params = make_weights(encoder, 1, gen, "cpu")[0]
    x = torch.randn((2, 3, 64, 64), generator=gen)
    model = _port_model(encoder, params).train(train)
    with torch.no_grad():
        a = model(x)
        b = Net(encoder, params, train=train, remat=train)(x)
    assert (a - b).abs().max() <= 1e-3 * b.abs().max()


def test_pseudo_label_batch_matches_the_port():
    from cartseg_tpu_torch.infer.engine import (EnsembleMember,
                                                prepare_model,
                                                pseudo_label_program)
    gen = torch.Generator().manual_seed(11)
    params = make_weights("efficientnet-b0", 2, gen, "cpu", head_gain=8.0)
    images = blob_frames(gen, 2, 64, 8, "cpu")
    members = [EnsembleMember(prepare_model(
        _port_model("efficientnet-b0", p), "cpu"), 1.0) for p in params]
    program = pseudo_label_program(members, ref_pl.IMAGENET_MEAN,
                                   ref_pl.IMAGENET_STD, 4)
    pred, probs, stats = program(images, 0.5)
    rpred, rprobs, rstats, rflip = ref_pl.pseudo_label(
        "efficientnet-b0", params, [1.0, 1.0], images, 0.5, 4, 50.0, 150.0)
    assert torch.equal(pred, rpred)
    assert (probs - rprobs).abs().max() < 1e-5
    mirrored = program(images.flip(2), 0.5)[1].flip(-1)
    assert (mirrored - rflip).abs().max() < 1e-5
    for k, v in rstats.items():
        assert (stats[k] - v).abs().max() < 1e-5, k


def test_components_and_cleanup_match_the_port():
    from cartseg_tpu_torch.ops.connected_components import (
        connected_components, remove_small_components)
    gen = torch.Generator().manual_seed(5)
    mask = torch.rand((3, 40, 56), generator=gen) > 0.55
    lab = ref_pl.components(mask)
    port = connected_components(mask).to(torch.int64)
    assert torch.equal(torch.where(mask, lab, 40 * 56), port)
    assert torch.equal(ref_pl.clean(mask, 7),
                       remove_small_components(mask, 7))


def test_canny_matches_the_port():
    from cartseg_tpu_torch.ops.edges import canny_edges, rgb_to_gray
    gen = torch.Generator().manual_seed(6)
    images = blob_frames(gen, 2, 64, 8, "cpu")
    assert torch.equal(ref_pl.canny(images, 50.0, 150.0),
                       canny_edges(rgb_to_gray(images), 50.0, 150.0))


def test_augmentation_matches_the_port_at_the_same_draws():
    import json

    from cartseg_tpu_torch.data.augment import AugmentConfig, augment_batch
    from cellbench.tests.tiny import REPO
    t = json.loads((REPO / "cellbench/traffic/train_bce_dice.bs128_512.json")
                   .read_text())
    for seed in range(4):
        gen = torch.Generator().manual_seed(seed)
        images = blob_frames(gen, 3, 48, 8, "cpu")
        masks = blob_masks(gen, 3, 48, 4, "cpu")
        g1 = torch.Generator().manual_seed(100 + seed)
        g2 = torch.Generator().manual_seed(100 + seed)
        x1, m1 = augment_batch(g1, images, masks, AugmentConfig.train_512())
        x2, m2 = ref_tr.augment(images, masks, t["augment_params"],
                                *ref_tr.draws(g2, 3, 48, 48, "cpu"))
        assert (x1.permute(0, 3, 1, 2) - x2).abs().max() < 1e-4
        assert torch.equal(m1.permute(0, 3, 1, 2), m2)


def test_losses_match_the_port():
    from cartseg_tpu_torch.losses.abl import bce_dice_abl
    from cartseg_tpu_torch.losses.region import bce_dice_loss
    gen = torch.Generator().manual_seed(8)
    logits = torch.randn((2, 48, 48, 1), generator=gen) * 3
    masks = blob_masks(gen, 2, 48, 4, "cpu")
    assert abs(float(bce_dice_loss(logits, masks))
               - float(ref_tr.bce_dice(logits, masks, 0.5, 1.0))) < 1e-6
    total, comps = bce_dice_abl(logits, masks)
    b, used = ref_tr.abl(logits, (masks[..., 0] > 0.5).to(torch.int64))
    assert used == bool(comps["boundary_used"])
    assert abs(float(comps["boundary"]) - float(b)) <= 1e-5 * abs(float(b))


def test_edt_is_exact():
    from scipy import ndimage
    gen = torch.Generator().manual_seed(9)
    seeds = torch.rand((2, 30, 41), generator=gen) > 0.97
    want = torch.stack([torch.from_numpy(ndimage.distance_transform_edt(
        ~s.numpy())).to(torch.float32) for s in seeds])
    assert torch.allclose(ref_tr.edt(seeds), want)


def test_adamw_matches_the_port():
    from cartseg_tpu_torch.train.optim import adamw_update, init_adamw
    gen = torch.Generator().manual_seed(10)
    params = {"encoder.w": torch.randn(5, generator=gen),
              "decoder.w": torch.randn(3, generator=gen),
              "segmentation_head.0.bias": torch.randn(1, generator=gen)}
    gids = {k: ref_tr.group_of(k) for k in params}
    opt = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.01}
    lrs = [1e-3, 2e-3, 3e-3]
    port = {k: v.clone() for k, v in params.items()}
    state = init_adamw(port)
    mine = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in mine.items()}
    nu = {k: torch.zeros_like(v) for k, v in mine.items()}
    for t in (1, 2, 3):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params.items()}
        adamw_update(port, grads, state, gids, lrs, [1.0, 1.0, 1.0],
                     opt["weight_decay"])
        ref_tr.adamw(mine, grads, mu, nu, t, lrs, opt)
    for k in mine:
        assert torch.allclose(port[k], mine[k], atol=1e-7)


@pytest.mark.parametrize("name", ["unet_effb0", "unet_r34"])
def test_configuration_files_give_the_reference_widths(name):
    """A configuration's file states the widths that the reference
    builds, so the two cannot drift apart unseen."""
    import json

    from cellbench.reference import unet
    from cellbench.tests.tiny import REPO
    conf = json.loads((REPO / f"cellbench/configs/{name}.json").read_text())
    enc = conf["encoder"]
    assert tuple(conf["encoder_channels"]) == unet.ENCODER_CHANNELS[enc]
    assert tuple(conf["decoder_channels"]) == unet.DECODER_CHANNELS
    assert conf["encoder_bn_eps"] == unet.BN_EPS[enc]
    assert conf["decoder_bn_eps"] == unet.DECODER_BN_EPS
    if enc == "resnet34":
        assert tuple(conf["encoder_stages"]) == unet.R34_STAGES
        assert tuple(conf["encoder_widths"]) == unet.R34_WIDTHS
    else:
        assert tuple(map(tuple, conf["encoder_blocks"])) == unet.B0_BLOCKS
        assert conf["se_ratio"] == unet.SE_RATIO
