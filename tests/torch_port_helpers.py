"""Shared helpers for the port's tests (tests/test_torch_*.py)."""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card for tests marked `cuda`; decided here, at run time, so
    every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is "
                    "false); run on the GPU machine: "
                    "python -m pytest -m cuda tests/test_torch_*.py")
    return torch.device("cuda")


def jax_tree_to_numpy(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def randomize_bn(variables, seed: int):
    """Non-trivial BN running stats and affine params (fresh ones are
    mean 0 / var 1 / scale 1 / bias 0 and would hide layout bugs),
    drawn with numpy. A BN param dict is the one holding 'scale'."""
    r = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict) and "scale" in v:
                out[k] = {"scale": (1 + 0.1 * r.standard_normal(
                    v["scale"].shape)).astype(np.float32),
                    "bias": (0.1 * r.standard_normal(
                        v["bias"].shape)).astype(np.float32)}
            elif isinstance(v, dict) and "mean" in v:
                out[k] = {"mean": (0.1 * r.standard_normal(
                    v["mean"].shape)).astype(np.float32),
                    "var": (r.random(v["var"].shape) * 0.5
                            + 0.75).astype(np.float32)}
            elif isinstance(v, dict):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}


@functools.lru_cache(maxsize=1)
def _jax_effnet_init():
    import jax

    from cartseg_tpu.models import build_model, init_model

    model = build_model("efficientnet-b0")
    v = init_model(model, jax.random.key(0), (1, 32, 32, 3))
    return model, jax_tree_to_numpy(v)


def jax_effnet_variables(seed: int):
    """(flax model, numpy variables) of the efficientnet-b0 UNet: the
    JAX package's own init (compiled once per process), every conv
    kernel rescaled per output channel and BN randomised with numpy
    from `seed`, so members with different seeds differ."""
    model, v = _jax_effnet_init()
    r = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(x) if isinstance(x, dict) else
                (x * (1 + 0.2 * r.standard_normal(x.shape[-1]))).astype(
                    np.float32) if k == "kernel" else x
                for k, x in t.items()}

    v = {"params": walk(v["params"]), "batch_stats": v["batch_stats"]}
    return model, randomize_bn(v, seed + 100)


def port_effnet_and_jax_twin(seed: int):
    """A port efficientnet-b0 UNet from torch's seeded init with
    numpy-randomised BN, and the same weights as JAX variables through
    the JAX package's own importer (no JAX init compile)."""
    from cartseg_tpu.models import build_model as jax_build
    from cartseg_tpu.models.torch_import import import_smp_unet

    from cartseg_tpu_torch.models import build_model

    torch.manual_seed(seed)
    model = build_model("efficientnet-b0")
    r = np.random.default_rng(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.weight.data = torch.from_numpy(
                (1 + 0.1 * r.standard_normal(c)).astype(np.float32))
            m.bias.data = torch.from_numpy(
                (0.1 * r.standard_normal(c)).astype(np.float32))
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * r.standard_normal(c)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                (r.random(c) * 0.5 + 0.75).astype(np.float32)))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax_tree_to_numpy(import_smp_unet(sd, "efficientnet-b0"))
    return model.eval(), jax_build("efficientnet-b0"), variables


def imported_modules(path: Path):
    """Top-level module names imported anywhere in a source file."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def jax_train_state_to_port(state, encoder: str = "efficientnet-b0"):
    """A JAX `TrainState` -> the port's pieces, all numpy or torch on the
    CPU: the model state dict (params + BN running stats, through
    models/convert.py), the AdamW moments `mu`/`nu` as numpy in the same
    (torch) layout as the weights, keyed by parameter name, and the
    per-group step `count` [3]."""
    from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict

    tree = jax_tree_to_numpy({"params": state.params,
                              "batch_stats": state.batch_stats})
    sd = jax_variables_to_state_dict(tree, encoder)

    def moments(t):
        conv = jax_variables_to_state_dict(
            {"params": jax_tree_to_numpy(t)}, encoder)
        return {k: v.numpy() for k, v in conv.items()}

    return {"state_dict": sd, "mu": moments(state.opt.mu),
            "nu": moments(state.opt.nu),
            "count": np.asarray(state.opt.count)}


def load_jax_state_into_port(port_state, converted) -> None:
    """Put `jax_train_state_to_port`'s output into a port TrainState."""
    from cartseg_tpu_torch.train.optim import AdamWState

    port_state.model.load_state_dict(converted["state_dict"])
    port_state.opt = AdamWState(
        mu={k: torch.from_numpy(v.copy()) for k, v in converted["mu"].items()},
        nu={k: torch.from_numpy(v.copy()) for k, v in converted["nu"].items()},
        count=torch.from_numpy(converted["count"].astype(np.int32)))


@pytest.fixture(scope="module")
def png_pair_tree(tmp_path_factory):
    """The synthetic training tree of utils/synthetic.py (as chip_smoke.py
    writes it at 512x400): 3 sessions x 4 frames of 64x50, letterboxed to
    exactly 64^2, so nothing resizes. Returns (images_root, masks_root)."""
    from cartseg_tpu_torch.utils.synthetic import make_png_pair_tree

    return make_png_pair_tree(tmp_path_factory.mktemp("pairs"), 3, 4,
                              (64, 50), seed=0)


@pytest.fixture
def jax_pth_members_f32(monkeypatch):
    """The JAX CLIs' .pth members (`load_torch_member`, bf16 by default)
    in float32, the port's CPU dtype, for the length of a test."""
    import jax.numpy as jnp

    from cartseg_tpu.infer import engine
    from cartseg_tpu.workloads import create_pseudo_labels

    load = functools.partial(engine.load_torch_member, dtype=jnp.float32)
    monkeypatch.setattr(engine, "load_torch_member", load)
    monkeypatch.setattr(create_pseudo_labels, "load_torch_member", load)


@pytest.fixture(scope="module", autouse=True)
def pinned_jax_native(tmp_path_factory):
    """The JAX package's native library, built by its own loader into a
    file of this module's alone, for the length of a test module.

    cartseg_tpu.native compiles `_cartseg_native.so` in place beside its
    sources and remembers a failed build or load for the life of the
    process, so pytest workers that build or load that one file at once
    can leave a worker whose JAX dataset falls back to cv2 for good.
    Autouse in every module that imports it: those whose comparisons
    depend on the JAX native lane (its dataset's letterbox + resize)."""
    from cartseg_tpu import native as JN

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_SO", tmp_path_factory.mktemp("jax_native")
                   / JN._SO.name)
        mp.setattr(JN, "_lib", None)
        mp.setattr(JN, "_tried", False)
        if JN.get_lib() is None:
            pytest.fail("the JAX package's native library did not build")
        yield JN


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's torch CPU ops on one thread. The suite runs
    six pytest workers on a few cores; torch's default of one OpenMP
    thread per core then oversubscribes them, and its workers spin at
    every parallel region (a 3 s CPU training run took 330 s that way).
    Autouse in every module that imports it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, to nearest, ties away from zero: the int32 view
    plus 0x1000, the low 13 bits cleared, as the split-TF32 flash kernels
    round (csrc/flash_tf32x3_common.cuh)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)): hi + lo holds x to ~2^-22."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor,
              terms: int = 3) -> torch.Tensor:
    """a @ b as the split-TF32 kernels' products: hi lo + lo hi, then
    + hi hi, in fp32 (a product of two TF32 values is exact in fp32);
    `terms` = 1 keeps hi hi alone (one TF32 product)."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    if terms == 1:
        return ah @ bh
    return (ah @ bl + al @ bh) + ah @ bh


def sam_mask_downscaling_shapes(cfg) -> dict:
    """Official-checkpoint shapes of the mask-prompt path
    (`prompt_encoder.mask_downscaling.*`), which neither package builds."""
    mic, pd = cfg.mask_in_chans, cfg.prompt_dim
    p = "prompt_encoder.mask_downscaling"
    return {f"{p}.0.weight": (mic // 4, 1, 2, 2), f"{p}.0.bias": (mic // 4,),
            f"{p}.1.weight": (mic // 4,), f"{p}.1.bias": (mic // 4,),
            f"{p}.3.weight": (mic, mic // 4, 2, 2), f"{p}.3.bias": (mic,),
            f"{p}.4.weight": (mic,), f"{p}.4.bias": (mic,),
            f"{p}.6.weight": (pd, mic, 1, 1), f"{p}.6.bias": (pd,)}


def sam_official_state_dict(cfg, seed: int = 0) -> dict:
    """A full official-named SAM state dict (mask_downscaling included)
    of float32 CPU tensors drawn with numpy from `seed`. The shapes are
    the port's own `Sam(cfg)` (built on the meta device) plus the
    mask-prompt path's. Scales keep a forward pass lively: matrices
    N(0, 1/fan_in), norm weights 1 + 0.1 N, biases 0.02 N, embeddings and
    the Fourier matrix N(0, 1), rel-pos tables 0.3 N, pos_embed 0.1 N."""
    from cartseg_tpu_torch.models.sam import Sam

    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in Sam(cfg).state_dict().items()}
    shapes.update(sam_mask_downscaling_shapes(cfg))
    r = np.random.default_rng(seed)
    sd = {}
    for k, sh in shapes.items():
        z = r.standard_normal(sh)
        if k.endswith((".rel_pos_h", ".rel_pos_w")):
            a = 0.3 * z
        elif k.endswith(".pos_embed"):
            a = 0.1 * z
        elif k.endswith(".bias"):
            a = 0.02 * z
        elif len(sh) == 1:
            a = 1.0 + 0.1 * z
        elif (k.endswith(("_embed.weight", "_token.weight",
                          "_tokens.weight", "gaussian_matrix"))
              or ".point_embeddings." in k):
            a = z
        else:
            a = z / np.sqrt(np.prod(sh[1:]))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd
