"""The SAM ViT-B predictor slice of the port (cartseg_tpu_torch/models/
sam.py, ops/flash_attention.py, tools/annotate.py) against the JAX
package on the CPU.

Both sides get the same numpy inputs and the same weights: a seeded
official-named state dict, turned into JAX variables by the JAX
package's own `convert_torch_sam`. The test config is SAM shrunk to
img 256 (a 16x16 grid, so the JAX `supported` predicate sends the global
block to the flash lane, whose JAX side runs in Pallas interpret mode)
with window 6, which pads the grid to 18 as window 14 pads 64 to 70.

Tolerances: flash plain lane 2e-5 (the JAX flash test's own), encoder
and features 5e-5, decoder logits and IoU 1e-4 (float32 sums in other
orders through two transformers), _postprocess 1e-5, cv2 resize 1 LSB
(cv2's 11-bit fixed-point weights).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.models import sam as jsam
from cartseg_tpu.ops.pallas import flash_attention as jfa
from cartseg_tpu_torch.models import sam as tsam
from cartseg_tpu_torch.models.convert import jax_sam_to_state_dict
from cartseg_tpu_torch.ops import flash_attention as tfa
from cartseg_tpu_torch.tools.annotate import load_sam
from cartseg_tpu_torch.utils.image_io import resize_bilinear_u8
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                sam_mask_downscaling_shapes,
                                sam_official_state_dict)

CFG_KW = dict(img_size=256, patch_size=16, encoder_dim=64, encoder_depth=2,
              encoder_heads=2, global_attn_indexes=(1,), window_size=6,
              prompt_dim=32, mask_in_chans=16, decoder_heads=2,
              decoder_mlp_dim=64, global_attn_flash=True)
TCFG = tsam.SamConfig(**CFG_KW)
JCFG = jsam.SamConfig(**CFG_KW)
FRAME_HW = (192, 256)         # longest side == img_size: no resize

REQUESTS = {
    "points": dict(point_coords=np.array([[60.0, 50.0], [180.0, 120.0],
                                          [20.0, 170.0]]),
                   point_labels=np.array([1, 1, 0])),
    "box": dict(box=np.array([30.0, 20.0, 200.0, 150.0])),
    "box_point": dict(point_coords=np.array([[100.0, 80.0]]),
                      point_labels=np.array([1]),
                      box=np.array([30.0, 20.0, 200.0, 150.0])),
}


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _frame():
    r = np.random.default_rng(3)
    h, w = FRAME_HW
    yy, xx = np.mgrid[:h, :w]
    img = r.integers(0, 40, (h, w, 3))
    img[(yy - 90) ** 2 + (xx - 120) ** 2 < 50 ** 2] += 150
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def sam_pair():
    """JAX and port predictors on the same weights, each after
    set_image on the same frame (the JAX encode compiles once here)."""
    sd = sam_official_state_dict(TCFG, seed=0)
    jvars = jsam.convert_torch_sam(_numpy_sd(sd), JCFG)
    jpred = jsam.TpuSamPredictor(jvars, JCFG)
    tpred = tsam.SamPredictor(sd, TCFG, device="cpu")
    frame = _frame()
    jfeat = np.asarray(jpred.set_image(frame))
    tfeat = tpred.set_image(frame)
    return types.SimpleNamespace(sd=sd, jvars=jvars, jpred=jpred,
                                 tpred=tpred, jfeat=jfeat, tfeat=tfeat)


# ------------------------------------------------------ flash attention

@pytest.mark.parametrize("g", [4, 14, 16, 32, 64, 70])
@pytest.mark.parametrize("hd", [32, 64, 12])
def test_supported_predicate_matches_jax(g, hd):
    for S in (g * g, g * g - 1):
        assert tfa.supported(g, S, hd) == jfa.supported(g, S, hd)


def _flash_inputs(g, hd, bnh=3, seed=0):
    r = np.random.default_rng(seed)
    S = g * g
    q, k, v = (r.standard_normal((bnh, S, hd)).astype(np.float32)
               for _ in range(3))
    rh, rw = (0.5 * r.standard_normal((bnh, S, g)).astype(np.float32)
              for _ in range(2))
    return q, k, v, rh, rw


@pytest.mark.parametrize("g,hd", [(16, 32), (16, 64)])
def test_plain_flash_matches_jax_kernel(g, hd):
    arrs = _flash_inputs(g, hd)
    scale = hd ** -0.5
    want = jfa.flash_attention_relpos(*map(jnp.asarray, arrs), scale=scale,
                                      grid_size=g)
    got = tfa.flash_attention_relpos(*map(torch.from_numpy, arrs),
                                     scale=scale, grid_size=g)
    assert got.dtype == torch.float32 and got.shape == (3, g * g, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_vit_attention_flash_lane_matches_plain_lane_with_grads():
    """ViTAttention on the CPU: the flash lane (plain version) equals the
    plain attention lane, outputs and gradients; the CPU flash lane is
    differentiable."""
    torch.manual_seed(0)
    plain = tsam.ViTAttention(64, 2, 16, use_flash=False)
    with torch.no_grad():
        plain.rel_pos_h.normal_(0, 0.3)
        plain.rel_pos_w.normal_(0, 0.3)
    flash = tsam.ViTAttention(64, 2, 16, use_flash=True)
    flash.load_state_dict(plain.state_dict())
    lanes = [plain, flash]
    x = torch.randn(1, 16, 16, 64)
    outs, grads = [], []
    for m in lanes:
        xi = x.clone().requires_grad_(True)
        y = m(xi)
        (y ** 2).sum().backward()
        outs.append(y.detach())
        grads.append((xi.grad, m.rel_pos_h.grad, m.qkv.weight.grad))
    torch.testing.assert_close(outs[1], outs[0], atol=3e-5, rtol=3e-5)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------- weights

def test_bridge_round_trip_is_bit_equal():
    """official dict -> JAX convert_torch_sam -> jax_sam_to_state_dict
    gives the dict back, minus the mask_downscaling keys, bit for bit
    (the transposed-conv kernels are flipped there and back)."""
    sd = sam_official_state_dict(TCFG, seed=1)
    back = jax_sam_to_state_dict(jsam.convert_torch_sam(_numpy_sd(sd), JCFG),
                                 TCFG)
    want = tsam.strip_mask_downscaling(sd)
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


@pytest.mark.parametrize("which", ["test", "vit_b"])
def test_port_names_are_the_official_keys(which):
    tc = TCFG if which == "test" else tsam.SamConfig()
    jc = JCFG if which == "test" else jsam.SamConfig()
    with torch.device("meta"):
        keys = set(tsam.Sam(tc).state_dict())
    official = set(jsam.official_sam_keys(jc))
    assert keys == official - set(sam_mask_downscaling_shapes(tc))
    if which == "vit_b":
        with torch.device("meta"):
            sd = tsam.Sam(tc).state_dict()
        extra = sum(int(np.prod(s))
                    for s in sam_mask_downscaling_shapes(tc).values())
        total = sum(v.numel() for v in sd.values())
        enc = sum(v.numel() for k, v in sd.items()
                  if k.startswith("image_encoder"))
        # the published ViT-B sizes (tests/test_sam.py pins the same)
        assert enc == 89_670_912 and total + extra == 93_735_728


def test_load_sam_checkpoint_strict(tmp_path, sam_pair):
    p = tmp_path / "sam_vit_b_synth.pth"
    torch.save(sam_pair.sd, p)
    pred = load_sam(p, device="cpu", cfg=TCFG)
    got = pred.model.state_dict()
    for k, v in tsam.strip_mask_downscaling(sam_pair.sd).items():
        assert torch.equal(got[k], v), k
    assert load_sam(None, device="cpu") is None
    assert load_sam(p, "vit_h", device="cpu") is None

    sd = dict(sam_pair.sd)
    sd.pop("image_encoder.blocks.1.attn.rel_pos_w")
    torch.save(sd, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        tsam.load_sam_checkpoint(tmp_path / "missing.pth", TCFG,
                                 device="cpu")
    sd = dict(sam_pair.sd)
    sd["mask_decoder.extra.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "extra.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tsam.load_sam_checkpoint(tmp_path / "extra.pth", TCFG, device="cpu")


def test_load_sam_defaults_to_the_card(tmp_path, sam_pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    p = tmp_path / "sam.pth"
    torch.save(sam_pair.sd, p)
    with pytest.raises(RuntimeError, match="CUDA device was asked for"):
        load_sam(p, cfg=TCFG)


# ------------------------------------------------------------- encoder

def test_encoder_matches_jax_through_the_flash_lane(sam_pair, monkeypatch):
    x = np.random.default_rng(5).standard_normal(
        (1, 256, 256, 3)).astype(np.float32)
    want = jsam.ImageEncoderViT(JCFG).apply(
        {"params": sam_pair.jvars["params"]["image_encoder"]},
        jnp.asarray(x))
    calls = []
    real = tfa.flash_attention_relpos

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_relpos", counted)
    with torch.no_grad():
        got = sam_pair.tpred.model.image_encoder(torch.from_numpy(x))
    assert calls == [(2, 256, 32)]          # the one global block
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                               rtol=5e-5)


def test_window_partition_pads_and_round_trips():
    x = torch.arange(2 * 5 * 7 * 3, dtype=torch.float32).reshape(2, 5, 7, 3)
    wins, pad_hw = tsam._window_partition(x, 3)
    assert wins.shape == (2 * 2 * 3, 3, 3, 3) and pad_hw == (6, 9)
    want, _ = jsam._window_partition(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(want))
    assert torch.equal(tsam._window_unpartition(wins, 3, pad_hw, (5, 7)), x)


def test_bf16_softmax_lane_tracks_fp32():
    """attn_softmax_fp32=False in a bf16 model (bf16 logits, fp32 row
    sum) stays within JAX's own bound of the fp32 encoder (8 %)."""
    cfg = dataclasses.replace(TCFG, global_attn_flash=False)
    sd = tsam.strip_mask_downscaling(sam_official_state_dict(cfg, seed=2))
    enc = tsam.Sam(cfg)
    enc.load_state_dict(sd)
    enc_b = tsam.Sam(dataclasses.replace(cfg, attn_softmax_fp32=False),
                     dtype=torch.bfloat16)
    enc_b.load_state_dict(sd)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 256, 256, 3)).astype(np.float32))
    with torch.no_grad():
        ya = enc.encode_image(x)
        yb = enc_b.encode_image(x)
    rel = float((ya - yb.float()).abs().max() / ya.abs().max())
    assert yb.dtype == torch.bfloat16 and rel < 0.08, rel


# ----------------------------------------------------------- predictor

def test_predictor_features_match_jax(sam_pair):
    t = sam_pair.tfeat
    assert t.shape == (1, 16, 16, 32) and t.dtype == torch.float32
    assert sam_pair.tpred.get_image_embedding() is t
    np.testing.assert_allclose(t.numpy(), sam_pair.jfeat, atol=5e-5,
                               rtol=5e-5)


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("request_name", list(REQUESTS))
def test_predictor_requests_match_jax(sam_pair, request_name, multimask):
    kw = dict(REQUESTS[request_name], multimask_output=multimask)
    jl, ji, _ = sam_pair.jpred.predict(return_logits=True, **kw)
    tl, ti, none = sam_pair.tpred.predict(return_logits=True, **kw)
    n = 3 if multimask else 1
    assert none is None and tl.shape == (n,) + FRAME_HW == jl.shape
    assert tl.dtype == np.float32 and ti.shape == (n,)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ti, ji, atol=1e-4, rtol=0)
    jm, _, _ = sam_pair.jpred.predict(**kw)
    tm, _, _ = sam_pair.tpred.predict(**kw)
    assert tm.dtype == bool and tm.shape == jm.shape
    far = np.abs(jl) >= 1e-4
    np.testing.assert_array_equal(tm[far], jm[far])


def test_injected_features_give_the_same_predict(sam_pair):
    """The prefetch thread's `.features` injection (tools/annotate.py)."""
    kw = dict(REQUESTS["points"], multimask_output=True, return_logits=True)
    want, wi, _ = sam_pair.tpred.predict(**kw)
    other = tsam.SamPredictor(sam_pair.sd, TCFG, device="cpu")
    other.features = sam_pair.tpred.features
    other._orig_hw = sam_pair.tpred._orig_hw
    other._input_hw = sam_pair.tpred._input_hw
    got, gi, _ = other.predict(**kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gi, wi)


def test_predictor_official_token_list(sam_pair):
    p = sam_pair.tpred
    _, lab = p._prompt_tokens(np.array([[10, 10]]), np.array([1]), None)
    assert list(lab) == [1, -1]                # point + the real pad point
    c, lab = p._prompt_tokens(np.array([[10, 10]]), np.array([1]),
                              np.array([5, 5, 30, 30]))
    assert list(lab) == [1, 2, 3]              # point + corners, no pad
    _, lab = p._prompt_tokens(None, None, np.array([5, 5, 30, 30]))
    assert list(lab) == [2, 3]
    assert c.dtype == np.float32 and c.shape == (3, 2)


def test_predictor_refuses_what_the_tools_never_send(sam_pair):
    with pytest.raises(ValueError, match="point_coords and/or box"):
        sam_pair.tpred.predict(multimask_output=False)
    with pytest.raises(NotImplementedError, match="mask prompts"):
        sam_pair.tpred.predict(box=np.array([1, 1, 9, 9]),
                               mask_input=np.zeros((1, 64, 64)))
    fresh = tsam.SamPredictor(sam_pair.sd, TCFG, device="cpu")
    with pytest.raises(RuntimeError, match="set_image"):
        fresh.predict(box=np.array([1, 1, 9, 9]))


@pytest.mark.parametrize("orig_hw", [(400, 300), (160, 120)])
def test_postprocess_matches_jax(sam_pair, orig_hw):
    """The last resize goes up at 400x300 and down (antialiased in
    jax.image.resize) at 160x120."""
    oh, ow = orig_hw
    s = TCFG.img_size / max(oh, ow)
    input_hw = (int(round(oh * s)), int(round(ow * s)))
    jp = jsam.TpuSamPredictor(sam_pair.jvars, JCFG)
    tp = tsam.SamPredictor(sam_pair.sd, TCFG, device="cpu")
    for p in (jp, tp):
        p._orig_hw, p._input_hw = orig_hw, input_hw
    lr = np.random.default_rng(7).standard_normal(
        (1, 4, 64, 64)).astype(np.float32) * 4
    want = np.asarray(jp._postprocess(jnp.asarray(lr)))
    got = tp._postprocess(torch.from_numpy(lr)).numpy()
    assert got.shape == (1, 4, oh, ow) == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [((37, 53), (100, 80)),
                                     ((200, 150), (64, 50)),
                                     ((512, 512), (1024, 1024)),
                                     ((48, 64), (48, 64))])
def test_resize_bilinear_u8_matches_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(8).integers(0, 256, src + (3,), np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    got = resize_bilinear_u8(torch.from_numpy(img), dst).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
