"""The SAM encoder fine-tune slice of the port (cartseg_tpu_torch/ops/cuda/
flash_attention.py's training forward and backward, ops/flash_attention.py's
autograd Function, models/sam.py's compute dtype) against the JAX package
on the CPU.

The step is benchmarks/sam_train_bench.py's `build_lane`: `Sam(cfg,
dtype)`, `encode_image(preprocess(x))`, the loss mean(feats^2) in float32
and its gradient over every parameter. Both sides get the same numpy
inputs and the same weights (a seeded official-named state dict, turned
into JAX variables by `convert_torch_sam`); JAX's gradient tree comes back
to the official names through `jax_sam_to_state_dict`, whose maps are
linear. The config is tests/test_torch_sam.py's (img 256, a 16x16 grid,
one global block), so JAX's global block takes its flash lane in Pallas
interpret mode, custom VJP and backward kernels included.

Tolerances: lse 1e-5 and out 2e-5 (the JAX flash test's forward bound);
the five flash gradients 3e-5 (JAX's own, tests/test_flash_attention.py:
130-132); ViTAttention gradients 5e-5 (:151-175); the float32 step: loss
1e-5 relative, every encoder gradient within 5e-5 of its largest |value|
(measured 3.5e-6); the bf16 step: loss 1e-2 relative (measured 7e-5) and
each encoder gradient's relative L2 within 0.06 (measured at most 0.031
on rel_pos_h: bf16 keeps 8 significant bits, 2^-8 = 3.9e-3 a rounding,
and the two frameworks round at different places through two blocks).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.models import sam as jsam
from cartseg_tpu.ops.pallas import flash_attention as jfa
from cartseg_tpu_torch.models import sam as tsam
from cartseg_tpu_torch.models.convert import jax_sam_to_state_dict
from cartseg_tpu_torch.ops import flash_attention as tfa
from cartseg_tpu_torch.ops.cuda import build
from cartseg_tpu_torch.ops.cuda import flash_attention as cfa
from torch_port_helpers import (jax_tree_to_numpy,  # noqa: F401
                                one_torch_thread, sam_official_state_dict)

CFG_KW = dict(img_size=256, patch_size=16, encoder_dim=64, encoder_depth=2,
              encoder_heads=2, global_attn_indexes=(1,), window_size=6,
              prompt_dim=32, mask_in_chans=16, decoder_heads=2,
              decoder_mlp_dim=64, global_attn_flash=True)
TCFG = tsam.SamConfig(**CFG_KW)
JCFG = jsam.SamConfig(**CFG_KW)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
G = 16


def _flash_inputs(hd, bnh=2, seed=3):
    """q, k, v ~ N(0,1), rel factors 0.5 N(0,1) and a N(0,1) cotangent,
    drawn with numpy (the JAX flash tests' recipe)."""
    r = np.random.default_rng(seed)
    S = G * G
    q, k, v = (r.standard_normal((bnh, S, hd)).astype(np.float32)
               for _ in range(3))
    rh, rw = (0.5 * r.standard_normal((bnh, S, G)).astype(np.float32)
              for _ in range(2))
    cot = r.standard_normal((bnh, S, hd)).astype(np.float32)
    return (q, k, v, rh, rw), cot


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------ flash forward / backward

@pytest.mark.parametrize("hd", [32, 64])
def test_fwd_lse_plain_matches_jax(hd):
    arrs, _ = _flash_inputs(hd)
    scale = hd ** -0.5
    jo, jl = jfa._fwd_call(*map(jnp.asarray, arrs), scale, G, with_lse=True)
    out, lse = cfa.flash_relpos_fwd_lse_plain(*_t(arrs), scale, G)
    assert lse.dtype == torch.float32 and lse.shape == (2, G * G)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0],
                               atol=1e-5, rtol=1e-5)
    # the wrapper on CPU tensors: the plain versions, nothing launched
    build.reset_launch_counts()
    got, got_lse = cfa.flash_relpos_fwd(*_t(arrs), scale, G, with_lse=True)
    assert torch.equal(got, out) and torch.equal(got_lse, lse)
    assert torch.equal(cfa.flash_relpos_fwd(*_t(arrs), scale, G),
                       cfa.flash_relpos_fwd_plain(*_t(arrs), scale, G))
    assert build.LAUNCHES["flash_fwd"] == 0


@functools.lru_cache(maxsize=None)
def _jax_flash_grads(hd):
    arrs, cot = _flash_inputs(hd)

    def f(*a):
        return jfa.flash_attention_relpos(*a, scale=hd ** -0.5, grid_size=G)

    _, vjp = jax.vjp(f, *map(jnp.asarray, arrs))
    return [np.asarray(x) for x in vjp(jnp.asarray(cot))]


def _port_bwd(hd, fn):
    arrs, cot = _flash_inputs(hd)
    scale = hd ** -0.5
    o, lse = cfa.flash_relpos_fwd_lse_plain(*_t(arrs), scale, G)
    return fn(*_t(arrs), o, lse, torch.from_numpy(cot), scale, G)


@pytest.mark.parametrize("hd", [32, 64])
def test_bwd_plain_matches_jax_vjp(hd):
    got = _port_bwd(hd, cfa.flash_relpos_bwd_plain)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got,
                          _jax_flash_grads(hd)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=3e-5, rtol=3e-5,
                                   err_msg=name)


@pytest.mark.parametrize("hd", [32, 64])
def test_bwd_plain_matches_autograd_of_the_plain_forward(hd):
    arrs, cot = _flash_inputs(hd)
    ts = [t.requires_grad_(True) for t in _t(arrs)]
    out = cfa.flash_relpos_fwd_plain(*ts, hd ** -0.5, G)
    want = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    got = _port_bwd(hd, cfa.flash_relpos_bwd_plain)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, want):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=3e-5, msg=name)


def test_bwd_wrappers_on_cpu_take_the_plain_versions():
    build.reset_launch_counts()
    got = _port_bwd(32, cfa.flash_relpos_bwd)
    want = _port_bwd(32, cfa.flash_relpos_bwd_plain)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert build.LAUNCHES["flash_bwd_dq"] == build.LAUNCHES[
        "flash_bwd_dkv"] == 0


def test_bwd_plain_keeps_the_input_types():
    """bf16 inputs: fp32 products and softmax, gradients in bf16 (JAX: dq,
    dk, dv in q/k/v's type, drel in rel_h's)."""
    arrs, cot = _flash_inputs(32)
    ts = [t.to(torch.bfloat16) for t in _t(arrs)]
    o, lse = cfa.flash_relpos_fwd_lse_plain(*ts, 32 ** -0.5, G)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    do = torch.from_numpy(cot).to(torch.bfloat16)
    got = cfa.flash_relpos_bwd_plain(*ts, o, lse, do, 32 ** -0.5, G)
    assert all(t.dtype == torch.bfloat16 for t in got)
    want = _port_bwd(32, cfa.flash_relpos_bwd_plain)
    for a, b in zip(got, want):
        rel = float((a.float() - b).abs().max() / b.abs().max())
        assert rel < 0.03, rel


def test_autograd_function_runs_the_training_forward_and_backward(
        monkeypatch):
    """`_FlashRelposCuda` on CPU tensors (its wrappers then take the plain
    versions): the forward asks for the lse only when a gradient is
    needed, and the backward takes a strided gradient."""
    arrs, cot = _flash_inputs(32)
    asked = []
    real = tfa.flash_relpos_fwd

    def spy(*a, with_lse=False):
        asked.append(with_lse)
        return real(*a, with_lse=with_lse)

    monkeypatch.setattr(tfa, "flash_relpos_fwd", spy)
    scale = 32 ** -0.5
    with torch.no_grad():
        tfa._FlashRelposCuda.apply(*_t(arrs), scale, G)
    ts = [t.requires_grad_(True) for t in _t(arrs)]
    out = tfa._FlashRelposCuda.apply(*ts, scale, G)
    assert asked == [False, True]
    # the gradient as it comes back through a permute: not contiguous
    up = torch.from_numpy(cot).permute(1, 0, 2).contiguous().permute(1, 0, 2)
    assert not up.is_contiguous()
    got = torch.autograd.grad(out, ts, up)
    ref = [t.detach().clone().requires_grad_(True) for t in ts]
    want = torch.autograd.grad(cfa.flash_relpos_fwd_plain(*ref, scale, G),
                               ref, up)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=3e-5)


def test_vit_attention_flash_grads_match_jax():
    """ViTAttention's flash lane at (1,16,16,64), 2 heads: the input's
    and every parameter's gradient of sum(y^2) against JAX's
    (tests/test_flash_attention.py:151-175), weights 0.1 N(0,1)."""
    r = np.random.default_rng(12)
    x = r.standard_normal((1, 16, 16, 64)).astype(np.float32)
    w = {"qkv": 0.1 * r.standard_normal((64, 192)),
         "qkv_b": 0.1 * r.standard_normal(192),
         "proj": 0.1 * r.standard_normal((64, 64)),
         "proj_b": 0.1 * r.standard_normal(64),
         "rel_pos_h": 0.1 * r.standard_normal((31, 32)),
         "rel_pos_w": 0.1 * r.standard_normal((31, 32))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    jvar = {"params": {"qkv": {"kernel": w["qkv"], "bias": w["qkv_b"]},
                       "proj": {"kernel": w["proj"], "bias": w["proj_b"]},
                       "rel_pos_h": w["rel_pos_h"],
                       "rel_pos_w": w["rel_pos_w"]}}
    jmod = jsam.ViTAttention(64, 2, 16, dtype=jnp.float32, use_flash=True)
    jg, jgx = jax.grad(lambda v, xx: jnp.sum(jmod.apply(v, xx) ** 2),
                       argnums=(0, 1))(jvar, jnp.asarray(x))
    jg = jax_tree_to_numpy(jg)["params"]

    mod = tsam.ViTAttention(64, 2, 16, use_flash=True)
    mod.load_state_dict({
        "qkv.weight": torch.from_numpy(w["qkv"].T.copy()),
        "qkv.bias": torch.from_numpy(w["qkv_b"]),
        "proj.weight": torch.from_numpy(w["proj"].T.copy()),
        "proj.bias": torch.from_numpy(w["proj_b"]),
        "rel_pos_h": torch.from_numpy(w["rel_pos_h"]),
        "rel_pos_w": torch.from_numpy(w["rel_pos_w"])})
    xt = torch.from_numpy(x).requires_grad_(True)
    (mod(xt) ** 2).sum().backward()
    pairs = [(xt.grad, np.asarray(jgx)),
             (mod.qkv.weight.grad, jg["qkv"]["kernel"].T),
             (mod.qkv.bias.grad, jg["qkv"]["bias"]),
             (mod.proj.weight.grad, jg["proj"]["kernel"].T),
             (mod.proj.bias.grad, jg["proj"]["bias"]),
             (mod.rel_pos_h.grad, jg["rel_pos_h"]),
             (mod.rel_pos_w.grad, jg["rel_pos_w"])]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-5, rtol=5e-5,
                                   err_msg=str(i))


# ------------------------------------------------------ encoder step

def _frame():
    return np.random.default_rng(4).integers(0, 256, (1, 256, 256, 3),
                                             np.uint8)


@pytest.fixture(scope="module")
def state_dict():
    return tsam.strip_mask_downscaling(sam_official_state_dict(TCFG, 0))


@pytest.fixture(scope="module")
def jax_steps(state_dict):
    """JAX's loss and gradient (official names) per dtype, each compiled
    once: benchmarks/sam_train_bench.py:46-63's step."""
    jvars = jsam.convert_torch_sam({k: v.numpy()
                                    for k, v in state_dict.items()}, JCFG)
    x = jnp.asarray(_frame())
    out = {}
    for name, (_, jdt) in DTYPES.items():
        model = jsam.Sam(JCFG, dtype=jdt)

        def loss_fn(v, xx, model=model):
            f = model.apply(v, model.preprocess(xx),
                            method=model.encode_image)
            return jnp.mean(jnp.square(f.astype(jnp.float32)))

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jvars, x)
        out[name] = (float(loss), jax_sam_to_state_dict(
            {"params": jax_tree_to_numpy(grads["params"])}, TCFG))
    return out


def _port_step(state_dict, dtype):
    model = tsam.Sam(TCFG, dtype=dtype)
    model.load_state_dict(state_dict)
    feats = model.encode_image(model.preprocess(torch.from_numpy(_frame())))
    loss = (feats.float() ** 2).mean()
    loss.backward()
    return model, feats, float(loss.detach())


def test_encoder_step_fp32_matches_jax(state_dict, jax_steps):
    jloss, jgrads = jax_steps["float32"]
    model, feats, loss = _port_step(state_dict, torch.float32)
    assert feats.dtype == torch.float32 and feats.shape == (1, 16, 16, 32)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    n = 0
    for k, p in model.named_parameters():
        if not k.startswith("image_encoder."):
            assert p.grad is None, k      # the step never reaches them
            assert not jgrads[k].any(), k
            continue
        want = jgrads[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=5e-5 * np.abs(want).max(),
                                   err_msg=k)
        n += 1
    # patch embed 2, pos_embed, 14 a block, neck 6
    assert n == 3 + 14 * TCFG.encoder_depth + 6


def test_encoder_step_bf16_matches_jax(state_dict, jax_steps):
    jloss, jgrads = jax_steps["bfloat16"]
    model, feats, loss = _port_step(state_dict, torch.bfloat16)
    assert feats.dtype == torch.bfloat16
    assert abs(loss - jloss) <= 1e-2 * abs(jloss), (loss, jloss)
    for k, p in model.named_parameters():
        if not k.startswith("image_encoder."):
            assert p.grad is None, k
            continue
        assert p.dtype == p.grad.dtype == torch.float32, k
        want = jgrads[k].double()
        rel = float((p.grad.double() - want).norm() / want.norm())
        assert rel <= 0.06, (k, rel)


def test_bf16_sam_keeps_fp32_params_and_returns_bf16_features(state_dict):
    model = tsam.Sam(TCFG, dtype=torch.bfloat16)
    model.load_state_dict(state_dict)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        x = model.preprocess(torch.from_numpy(_frame()))
        assert x.dtype == torch.float32
        feats = model.encode_image(x)
        coords = torch.tensor([[[60.0, 50.0], [0.0, 0.0]]])
        masks, iou = model.decode(feats, coords, torch.tensor([[1, -1]]))
    assert feats.dtype == torch.bfloat16 and feats.shape == (1, 16, 16, 32)
    assert masks.shape == (1, 4, 64, 64) and iou.shape == (1, 4)
    assert torch.isfinite(masks.float()).all()
    assert torch.isfinite(iou.float()).all()


def test_default_dtype_is_float32(state_dict):
    a, b = tsam.Sam(TCFG), tsam.build_sam_vit_b(torch.float32, TCFG)
    a.load_state_dict(state_dict)
    b.load_state_dict(state_dict)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 256, 256, 3)).astype(np.float32))
    with torch.no_grad():
        fa, fb = a.encode_image(x), b.encode_image(x)
    assert a.dtype == b.dtype == torch.float32 and fa.dtype == torch.float32
    assert torch.equal(fa, fb)
    assert tsam.build_sam_vit_b().cfg == tsam.SamConfig()


def test_predictor_stays_fp32_without_grad(state_dict):
    p = tsam.SamPredictor(state_dict, TCFG, device="cpu")
    assert p.model.dtype == torch.float32
    feats = p.set_image(np.zeros((192, 256, 3), np.uint8))
    assert feats.dtype == torch.float32 and not feats.requires_grad
    cfg = dataclasses.replace(TCFG, global_attn_flash=False)
    assert tsam.SamPredictor(state_dict, cfg, device="cpu").model.dtype \
        == torch.float32
