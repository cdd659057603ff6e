"""JAX variables -> the port's state dicts, without importing JAX: the
UNet's and UNet++'s (with or without deep supervision) with an
efficientnet-b0, resnet34 or resnet18 encoder (the UNet's the inverse of
cartseg_tpu/models/torch_import.py:249-343), the classic UNet's (the
inverse of `import_classic_unet`, :230-246) and SAM's
(`jax_sam_to_state_dict`, the inverse of convert_torch_sam).

`variables_np` is the JAX package's {"params", "batch_stats"} tree with
numpy leaves (e.g. `jax.tree_util.tree_map(np.asarray, variables)`).
Layout rules:

  flax conv kernel [H,W,I,O] -> torch Conv2d weight [O,I,H,W]
    (a depthwise [H,W,1,C] becomes [C,1,H,W])
  flax ConvTranspose kernel [H,W,I,O] (the classic UNet's `up{i}`) ->
    torch ConvTranspose2d weight [I,O,H,W], flipped in space
  BN scale/bias -> weight/bias; batch_stats mean/var ->
    running_mean/running_var

The result loads into `build_model(encoder, decoder=...)` with plain
`load_state_dict` (BN's num_batches_tracked is filled in by torch). The
decoder needs no argument: UNet++'s variables name their nodes
(`decoder/x_{i}_{j}`, `decoder/final`, `aux_head_{j}`).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# (expand_ratio, repeats) per B0 block group
_B0_GROUPS = ((1, 1), (6, 2), (6, 2), (6, 3), (6, 3), (6, 4), (6, 1))
_BN_LEAF = {"scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _effnet_key(mod, leaf: str) -> str:
    m = mod[0]
    if m == "stem_conv":
        return "encoder.conv_stem.weight"
    if m == "stem_bn":
        return f"encoder.bn1.{_BN_LEAF[leaf]}"
    g, r = m[len("block"):].split("_")
    sub = mod[1]
    if sub in ("se_reduce", "se_expand"):
        name = "conv_reduce" if sub == "se_reduce" else "conv_expand"
        return (f"encoder.blocks.{g}.{r}.se.{name}."
                f"{'bias' if leaf == 'bias' else 'weight'}")
    if _B0_GROUPS[int(g)][0] == 1:
        names = {"dw_conv": "conv_dw", "project_conv": "conv_pw",
                 "dw_bn": "bn1", "project_bn": "bn2"}
    else:
        names = {"expand_conv": "conv_pw", "dw_conv": "conv_dw",
                 "project_conv": "conv_pwl", "expand_bn": "bn1",
                 "dw_bn": "bn2", "project_bn": "bn3"}
    tname = names[sub]
    if sub.endswith("_bn"):
        return f"encoder.blocks.{g}.{r}.{tname}.{_BN_LEAF[leaf]}"
    return f"encoder.blocks.{g}.{r}.{tname}.weight"


def _resnet_key(mod, leaf: str) -> str:
    """encoder/conv1, encoder/bn1, encoder/layer{l}_{b}/<sub>
    (resnet.py:24-68) -> torchvision names."""
    if mod[0] == "conv1":
        return "encoder.conv1.weight"
    if mod[0] == "bn1":
        return f"encoder.bn1.{_BN_LEAF[leaf]}"
    layer, blk = mod[0].split("_")
    tname = {"conv1": "conv1", "conv2": "conv2", "bn1": "bn1", "bn2": "bn2",
             "downsample_conv": "downsample.0",
             "downsample_bn": "downsample.1"}[mod[1]]
    if mod[1] in ("bn1", "bn2", "downsample_bn"):
        return f"encoder.{layer}.{blk}.{tname}.{_BN_LEAF[leaf]}"
    return f"encoder.{layer}.{blk}.{tname}.weight"


def _conv_leaf(leaf: str) -> str:
    return "bias" if leaf == "bias" else "weight"


def _decoder_key(mod, leaf: str) -> str:
    """decoder/block{i}/{conv,bn}{1,2} (UNet, smp names) or
    decoder/{x_i_j,final}/{conv,bn}{1,2} (UNet++, the JAX names)."""
    if mod[0].startswith("block"):
        i, sub = mod[0][len("block"):], mod[1]
        if sub.startswith("conv"):
            return f"decoder.blocks.{i}.{sub}.0.weight"
        return f"decoder.blocks.{i}.conv{sub[len('bn'):]}.1.{_BN_LEAF[leaf]}"
    if mod[1].startswith("bn"):
        return f"decoder.{mod[0]}.{mod[1]}.{_BN_LEAF[leaf]}"
    return f"decoder.{mod[0]}.{mod[1]}.weight"


def _classic_key(mod, leaf: str) -> str:
    """down{i}/conv{c}, bottleneck/conv{c}, up{i}, updc{i}/conv{c}, head
    -> the names import_classic_unet reads."""
    m = mod[0]
    if m == "head" or m == "bottleneck":
        name = m
    elif m.startswith("updc"):
        name = f"updcs.{m[len('updc'):]}"
    elif m.startswith("up"):
        name = f"ups.{m[len('up'):]}"
    else:
        name = f"downs.{m[len('down'):]}"
    sub = "".join(f".{x}" for x in mod[1:])
    return f"{name}{sub}.{_conv_leaf(leaf)}"


def _torch_key(path: tuple, encoder: str) -> str:
    mod, leaf = path[:-1], path[-1]
    if encoder == "classic":
        return _classic_key(mod, leaf)
    if mod[0] == "encoder":
        if encoder.startswith("resnet"):
            return _resnet_key(mod[1:], leaf)
        return _effnet_key(mod[1:], leaf)
    if mod[0] == "decoder":
        return _decoder_key(mod[1:], leaf)
    if mod[0] == "segmentation_head" or mod[0].startswith("aux_head_"):
        return f"{mod[0]}.0.{_conv_leaf(leaf)}"
    raise KeyError(f"unexpected JAX variable {'/'.join(path)}")


def jax_variables_to_state_dict(variables_np: Mapping,
                                encoder: str = "efficientnet-b0"
                                ) -> Dict[str, torch.Tensor]:
    """JAX {"params","batch_stats"} numpy tree -> torch state dict for
    build_model(encoder, decoder=...): the UNet or UNet++ on an
    efficientnet-b0, resnet34 or resnet18 encoder, or encoder "classic"."""
    if encoder not in ("efficientnet-b0", "resnet34", "resnet18", "classic"):
        raise ValueError(f"convert: unknown encoder {encoder!r}")
    leaves = {**_flatten(variables_np["params"]),
              **_flatten(variables_np.get("batch_stats", {}))}
    sd = {}
    for path, v in leaves.items():
        key = _torch_key(path, encoder)
        if path[-1] == "kernel" and v.ndim == 4:
            # the classic UNet's ConvTranspose kernels ("ups.{i}")
            v = (np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
                 if key.startswith("ups.") else np.transpose(v, (3, 2, 0, 1)))
        sd[key] = torch.from_numpy(np.array(v, np.float32))
    return sd


def jax_sam_to_state_dict(variables_np: Mapping,
                          cfg=None) -> Dict[str, torch.Tensor]:
    """JAX SAM {"params"} numpy tree -> the official-named state dict of
    models/sam.py `Sam(cfg)`: the exact inverse of
    cartseg_tpu/models/sam.py `convert_torch_sam` (no mask_downscaling
    keys, which that converter drops). Linear kernels [in,out] -> weight
    [out,in]; conv kernels [kh,kw,in,out] -> [out,in,kh,kw]; transposed-
    conv kernels are un-flipped in space and go back to [in,out,kh,kw].

    Every one of those maps is linear (a transpose, a reshape or a flip),
    so the same function maps a JAX gradient tree, `{"params":
    grads["params"]}`, onto the official names of the port's `.grad`s."""
    from cartseg_tpu_torch.models.sam import SamConfig

    c = cfg or SamConfig()
    p = variables_np["params"]
    sd = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))

    def lin(prefix, t):
        put(f"{prefix}.weight", np.asarray(t["kernel"]).T)
        put(f"{prefix}.bias", t["bias"])

    def conv(prefix, t):
        put(f"{prefix}.weight", np.asarray(t["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in t:
            put(f"{prefix}.bias", t["bias"])

    def conv_t(prefix, t):
        k = np.asarray(t["kernel"])[::-1, ::-1]
        put(f"{prefix}.weight", k.transpose(2, 3, 0, 1))
        put(f"{prefix}.bias", t["bias"])

    def ln(prefix, t):
        put(f"{prefix}.weight", t["scale"])
        put(f"{prefix}.bias", t["bias"])

    enc = p["image_encoder"]
    conv("image_encoder.patch_embed.proj", enc["patch_embed_proj"])
    put("image_encoder.pos_embed", enc["pos_embed"])
    for i in range(c.encoder_depth):
        b, pre = enc[f"block{i}"], f"image_encoder.blocks.{i}"
        ln(f"{pre}.norm1", b["norm1"])
        ln(f"{pre}.norm2", b["norm2"])
        lin(f"{pre}.attn.qkv", b["attn"]["qkv"])
        lin(f"{pre}.attn.proj", b["attn"]["proj"])
        put(f"{pre}.attn.rel_pos_h", b["attn"]["rel_pos_h"])
        put(f"{pre}.attn.rel_pos_w", b["attn"]["rel_pos_w"])
        lin(f"{pre}.mlp.lin1", b["mlp_lin1"])
        lin(f"{pre}.mlp.lin2", b["mlp_lin2"])
    conv("image_encoder.neck.0", enc["neck_conv1"])
    ln("image_encoder.neck.1", enc["neck_ln1"])
    conv("image_encoder.neck.2", enc["neck_conv2"])
    ln("image_encoder.neck.3", enc["neck_ln2"])

    pe = p["prompt_encoder"]
    put("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
        pe["pe_gaussian"])
    for i in range(4):
        put(f"prompt_encoder.point_embeddings.{i}.weight",
            np.asarray(pe["point_embeddings"])[i:i + 1])
    put("prompt_encoder.not_a_point_embed.weight", pe["not_a_point_embed"])
    put("prompt_encoder.no_mask_embed.weight", pe["no_mask_embed"])

    dec = p["mask_decoder"]
    tr, tpre = dec["transformer"], "mask_decoder.transformer"

    def attn(prefix, t):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{prefix}.{name}", t[name])

    for i in range(c.decoder_depth):
        lay, pre = tr[f"layer{i}"], f"{tpre}.layers.{i}"
        for a in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            attn(f"{pre}.{a}", lay[a])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            ln(f"{pre}.{n}", lay[n])
        lin(f"{pre}.mlp.lin1", lay["mlp_lin1"])
        lin(f"{pre}.mlp.lin2", lay["mlp_lin2"])
    attn(f"{tpre}.final_attn_token_to_image", tr["final_attn_token_to_image"])
    ln(f"{tpre}.norm_final_attn", tr["norm_final_attn"])
    put("mask_decoder.iou_token.weight", dec["iou_token"])
    put("mask_decoder.mask_tokens.weight", dec["mask_tokens"])
    conv_t("mask_decoder.output_upscaling.0", dec["upscale_conv1"])
    ln("mask_decoder.output_upscaling.1", dec["upscale_ln"])
    conv_t("mask_decoder.output_upscaling.3", dec["upscale_conv2"])
    for i in range(c.num_mask_tokens):
        for j in range(3):
            lin(f"mask_decoder.output_hypernetworks_mlps.{i}.layers.{j}",
                dec[f"hyper_mlp{i}_lin{j}"])
    for j in range(3):
        lin(f"mask_decoder.iou_prediction_head.layers.{j}",
            dec[f"iou_mlp_lin{j}"])
    return sd
