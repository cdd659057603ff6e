"""Port parity: the efficientnet-b0 UNet (cartseg_tpu_torch.models)
against the flax model at identical weights, bridged by
models/convert.py.

Tolerance: logits atol/rtol 2e-4 in fp32, as tests/test_torch_parity.py
holds the JAX model against its torch twin (convolution sums run in
another order in the two frameworks)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.torch_smp import SmpUnetTorch
from cartseg_tpu.models.torch_import import export_flax_to_torch_naming

from cartseg_tpu_torch.models import build_model
from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict
from torch_port_helpers import jax_effnet_variables


@pytest.fixture(scope="module")
def effnet():
    return jax_effnet_variables(seed=0)


def test_unet_logits_match_jax_at_full_width(effnet):
    jmodel, v = effnet
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, jnp.asarray(x)))

    model = build_model("efficientnet-b0")
    model.load_state_dict(jax_variables_to_state_dict(v))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_encoder_stages_match_jax(effnet):
    jmodel, v = effnet
    r = np.random.default_rng(2)
    x = r.standard_normal((1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jmodel.encoder.apply(v, x, train=False))(
        {"params": v["params"]["encoder"],
         "batch_stats": v["batch_stats"]["encoder"]}, jnp.asarray(x))
    model = build_model("efficientnet-b0")
    model.load_state_dict(jax_variables_to_state_dict(v))
    with torch.no_grad():
        got = model.eval().encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=2e-4, rtol=2e-4)


def test_convert_equals_jax_export(effnet):
    """Same keys and values as the JAX package's own exporter."""
    _, v = effnet
    ours = jax_variables_to_state_dict(v)
    ref = export_flax_to_torch_naming(v, "efficientnet-b0")
    assert set(ours) == set(ref)
    for k, t in ours.items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)


def test_state_dict_naming_is_the_reference_checkpoints():
    """timm/smp key names and shapes, so a reference .pth loads as is
    (benchmarks/torch_smp.py replicates the checkpoint naming)."""
    ours = build_model("efficientnet-b0").state_dict()
    ref = SmpUnetTorch("efficientnet-b0").state_dict()
    assert set(ours) == set(ref)
    for k in ours:
        assert ours[k].shape == ref[k].shape, k
    # and a reference-model state dict loads strictly
    build_model("efficientnet-b0").load_state_dict(ref)


@pytest.mark.parametrize("enc", ["classic"])
def test_unported_encoders_name_the_roadmap_item(enc):
    """The last encoder that raised with its ROADMAP item, "classic", is
    ported (ROADMAP.md Queue 1 item 5, done): it builds the classic UNet
    with the reference's state-dict names, and an unknown encoder
    raises."""
    model = build_model(enc)
    assert type(model).__name__ == "ClassicUNet"
    assert {"downs.0.conv1.weight", "ups.0.weight", "head.bias"} <= set(
        model.state_dict())
    with pytest.raises(ValueError, match="unknown encoder"):
        build_model("resnet50")
