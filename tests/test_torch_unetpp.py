"""Port parity: UNet++ (with and without deep supervision) and the
classic UNet (cartseg_tpu_torch models/{unetpp,classic_unet,factory,
convert}.py) against the JAX package on the CPU.

Weights: the JAX package's own init of UNet++ on a resnet18 encoder at
64^2, kernels rescaled and BN randomised with numpy, carried into the
port by `jax_variables_to_state_dict`; the classic UNet (base 16, 32^2)
from one seeded torch state dict, read by JAX's `import_classic_unet`
and by the port's `load_state_dict`. JAX runs its plain decoder lane
(fused_decoder=False); the fused lane holds the same parameters.

Tolerances (float32): logits rtol 1e-4 / atol 1e-5 in eval mode and
in train mode, where train-mode BN over few values lifts the roundoff
of both frameworks above that, within twice the port's own distance
from its float64 forward, at most 1e-4 (see the test); BN running stats
after one train-mode forward rtol 1e-4 / atol 1e-5 (the two frameworks'
convolutions sum in different orders); the classic UNet's probabilities
atol 1e-5; the 2x upsample bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.models import ClassicUNet as JClassic
from cartseg_tpu.models import build_model as jax_build
from cartseg_tpu.models import init_model
from cartseg_tpu.models import param_groups as jax_param_groups
from cartseg_tpu.models.torch_import import import_classic_unet
from cartseg_tpu.models.unet import _upsample2x

from cartseg_tpu_torch.models import build_model, param_groups
from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict
from cartseg_tpu_torch.models.norm import BN_LANES
from cartseg_tpu_torch.models.unetpp import upsample2x
from torch_port_helpers import (jax_tree_to_numpy,  # noqa: F401
                                one_torch_thread, randomize_bn)

HW, BS = 64, 2


@functools.lru_cache(maxsize=1)
def _jax_unetpp_ds():
    """numpy variables of resnet18 UNet++ with deep supervision (the
    plain UNet++'s are the same without the aux heads)."""
    model = jax_build("resnet18", decoder="unetpp_ds", fused_decoder=False)
    v = jax_tree_to_numpy(init_model(model, jax.random.key(3),
                                     (1, HW, HW, 3)))
    r = np.random.default_rng(4)

    def walk(t):
        return {k: walk(x) if isinstance(x, dict) else
                (x * (1 + 0.2 * r.standard_normal(x.shape[-1]))).astype(
                    np.float32) if k == "kernel" else x
                for k, x in t.items()}

    return randomize_bn({"params": walk(v["params"]),
                         "batch_stats": v["batch_stats"]}, 5)


def _variables(decoder):
    v = _jax_unetpp_ds()
    if decoder == "unetpp_ds":
        return v
    return {"params": {k: x for k, x in v["params"].items()
                       if not k.startswith("aux_head")},
            "batch_stats": v["batch_stats"]}


def _input():
    return np.random.default_rng(6).normal(
        size=(BS, HW, HW, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(decoder, train):
    """(logits NHWC, updated batch_stats or None) of the JAX model."""
    model = jax_build("resnet18", decoder=decoder, fused_decoder=False)
    v = jax.tree_util.tree_map(jnp.asarray, _variables(decoder))
    x = jnp.asarray(_input())
    if train:
        y, upd = jax.jit(lambda v, x: model.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
        return np.asarray(y), jax_tree_to_numpy(upd["batch_stats"])
    y = jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x)
    return np.asarray(y), None


def _port(decoder, lane):
    m = build_model("resnet18", 1, lane, decoder)
    m.load_state_dict(jax_variables_to_state_dict(_variables(decoder),
                                                  "resnet18"))
    return m


@pytest.mark.parametrize("decoder", ["unetpp", "unetpp_ds"])
def test_state_dict_names_match_the_converted_jax_tree(decoder):
    port = set(build_model("resnet18", 1, "torch", decoder).state_dict())
    conv = set(jax_variables_to_state_dict(_variables(decoder), "resnet18"))
    assert port - conv == {k for k in port
                           if k.endswith("num_batches_tracked")}
    assert conv <= port
    n_aux = sum(k.startswith("aux_head_") for k in conv)
    assert n_aux == (6 if decoder == "unetpp_ds" else 0)


@pytest.mark.parametrize("decoder", ["unetpp", "unetpp_ds"])
def test_eval_forward_matches_jax(decoder):
    want, _ = _jax_forward(decoder, False)
    with torch.no_grad():
        got = _port(decoder, "torch").eval()(
            torch.from_numpy(_input()).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def _f64_spread(decoder, x):
    """max |fp32 - float64| of the port's train-mode logits on x: the
    roundoff this forward carries in float32."""
    out = []
    for dt in (torch.float32, torch.float64):
        m = _port(decoder, "torch").to(dt).train()
        with torch.no_grad():
            out.append(m(x.to(dt)).double())
    return float((out[0] - out[1]).abs().max())


@pytest.mark.parametrize("lane", BN_LANES)
@pytest.mark.parametrize("decoder", ["unetpp", "unetpp_ds"])
def test_train_forward_and_bn_stats_match_jax(decoder, lane):
    """One train-mode forward in each BN lane of the port: the logits,
    and every running mean and var, against flax's batch_stats update.
    Train-mode BN over layer4's 8 values a channel (64^2, bs2) amplifies
    float32 roundoff: both frameworks' logits lie ~2e-5 from the port's
    float64 forward at unetpp (measured 2.1e-5 port, 2.5e-5 JAX), above
    atol 1e-5. So the logits agree within rtol 1e-4 / atol 1e-5 or
    within twice the port's own float32 distance from float64, and never
    beyond 1e-4; a wrong network is off by O(0.1)."""
    want, stats = _jax_forward(decoder, True)
    m = _port(decoder, lane).train()
    x = torch.from_numpy(_input()).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = m(x).permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want)
    if not np.all(err <= 1e-5 + 1e-4 * np.abs(want)):
        spread = _f64_spread(decoder, x)
        assert err.max() <= min(2 * spread, 1e-4), (err.max(), spread)
    conv = jax_variables_to_state_dict({"params": {}, "batch_stats": stats},
                                       "resnet18")
    sd = m.state_dict()
    assert len(conv) == 2 * 42
    for k, w in conv.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("decoder", ["unetpp", "unetpp_ds"])
def test_param_groups_match_jax_labels(decoder):
    jl = jax.tree_util.tree_leaves_with_path(
        jax_param_groups(_variables(decoder)["params"]))
    counts = {}
    for _, lab in jl:
        counts[lab] = counts.get(lab, 0) + 1
    tcounts = {}
    for lab in param_groups(build_model("resnet18", 1, "torch",
                                        decoder)).values():
        tcounts[lab] = tcounts.get(lab, 0) + 1
    assert tcounts == counts
    assert counts["head"] == (8 if decoder == "unetpp_ds" else 2)


def test_upsample_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 5, 3, 4)).astype(np.float32)
    want = np.asarray(_upsample2x(jnp.asarray(x)))
    got = upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_node_input_order_is_row_first_then_up():
    """The first conv of x_0_2 reads [X00, X01, up2(X11)]: zeroing the
    weight columns of one input removes that input alone."""
    m = build_model("resnet18", 1, "torch", "unetpp").eval()
    node = m.decoder.x_0_2
    # X00: 64 (resnet stem), X01: 16, up2(X11): 32 channels
    assert node.conv1.in_channels == 64 + 16 + 32
    ref = {k: v.clone() for k, v in node.state_dict().items()}
    x00 = torch.randn(1, 64, 8, 8)
    x01 = torch.randn(1, 16, 8, 8)
    x11 = torch.randn(1, 32, 4, 4)
    with torch.no_grad():
        node.conv1.weight[:, 64 + 16:] = 0
        a = node([x00, x01], x11)
        b = node([x00, x01], torch.randn(1, 32, 4, 4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    node.load_state_dict(ref)


# ------------------------------------------------------------ classic

def _classic(base):
    from cartseg_tpu_torch.models.classic_unet import ClassicUNet

    return ClassicUNet(out_channels=1, base=base)


@pytest.fixture(scope="module")
def classic():
    torch.manual_seed(8)
    port = _classic(16).eval()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jv = import_classic_unet(sd)
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(JClassic(out_channels=1, base=16).apply(
        jax.tree_util.tree_map(jnp.asarray, jv), jnp.asarray(x)))
    return port, jv, x, want


def test_classic_unet_matches_jax(classic):
    port, _, x, want = classic
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert float(got.min()) >= 0 and float(got.max()) <= 1   # probabilities
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5)


def test_classic_unet_converts_back_from_jax(classic):
    """JAX variables -> the port's names: the exact inverse of
    import_classic_unet (ConvTranspose kernels flipped back)."""
    port, jv, _, _ = classic
    back = jax_variables_to_state_dict(jax_tree_to_numpy(jv), "classic")
    sd = port.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_classic_unet_is_the_factorys_and_all_decoder():
    m = build_model("classic", 1, "torch", "unetpp_ds")
    assert type(m).__name__ == "ClassicUNet"
    assert m.head.in_channels == 64 and m.bottleneck.conv1.out_channels == 1024
    assert set(param_groups(m).values()) == {"decoder"}
