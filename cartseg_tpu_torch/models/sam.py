"""SAM ViT-B (Segment Anything) for the annotation tools: the PyTorch
counterpart of cartseg_tpu/models/sam.py.

The annotation tools run SAM as an interactive assistant: `set_image`
computes the ViT-B image embedding once per frame, then every click or
box is a `predict` call against the cached embedding. This module holds
the same three parts (image encoder, prompt encoder, mask decoder) as
torch modules named exactly as the official `segment_anything`
checkpoint names them (`image_encoder.blocks.{i}.attn.qkv`,
`image_encoder.neck.{0..3}`, `mask_decoder.output_upscaling.{0,1,3}`,
...), so an official `sam_vit_b_*.pth` loads with `load_state_dict`
after dropping its `prompt_encoder.mask_downscaling.*` keys (the
mask-prompt path, which the tools never use and JAX ignores too).

Numerics follow the JAX package, which is the reference, where it
differs from upstream: q is scaled before the product in the decoder
attention, the encoder and neck LayerNorms use eps 1e-6 and the decoder
ones 1e-5, GELU is exact. Public tensors keep the JAX layouts: images
[B,H,W,3], image features [B,g,g,C].

With `SamConfig.global_attn_flash` the global blocks run the decomposed
rel-pos flash attention (ops/flash_attention.py): the hand-written CUDA
kernels on the card (forward, and the two backward kernels when a
gradient is taken), their plain versions on the CPU. The bare config
keeps it off; `SamPredictor` turns it on, as `TpuSamPredictor` does.

`Sam(cfg, dtype)` takes a compute dtype with flax's meaning (JAX's
`Sam(cfg, dtype=)`): the parameters stay float32; every Linear and Conv
casts its input, weight and bias to `dtype` and returns `dtype` (flax
`nn.Dense` / `nn.Conv` with `dtype=`), every LayerNorm computes in
float32 and returns `dtype` (flax `nn.LayerNorm(dtype=)`), and the
residual stream follows. Only those layers cast, so `torch.autocast`
(which keeps layer_norm outputs in float32) is not used.

`Sam.forward(images, boxes)` is the training forward of a box-prompted
fine-tune (MedSAM, arXiv:2304.12306): one box a frame, one mask out,
the low-resolution logits upsampled to the input size. The trainer
(train/engine.py) runs it through `Trainer.train_step`. Its layers are
spans (utils/profiling.py `span`): `sam.image_encoder`, inside it
`sam.window_attn` around each windowed block's attention with its
partition and unpartition and `sam.global_attn` around each global
block's, and `sam.mask_decoder` around the prompt embedding, the
decoder and the upsample.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cartseg_tpu_torch.device import resolve_device
from cartseg_tpu_torch.ops import flash_attention as fa
from cartseg_tpu_torch.utils.profiling import span

__all__ = ["SamConfig", "Sam", "ImageEncoderViT", "PromptEncoder",
           "MaskDecoder", "SamEmbedding", "SamPredictor", "build_sam_vit_b",
           "load_sam_checkpoint", "MASK_DOWNSCALING_PREFIX"]

# official checkpoint keys of the mask-prompt path, which is not built
MASK_DOWNSCALING_PREFIX = "prompt_encoder.mask_downscaling."


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """ViT-B defaults (cartseg_tpu/models/sam.py:61-107); shrink for
    tests (img_size=256, depth=2, ...)."""

    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 768
    encoder_depth: int = 12
    encoder_heads: int = 12
    encoder_mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    prompt_dim: int = 256
    mask_in_chans: int = 16
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    decoder_depth: int = 2
    num_multimask_outputs: int = 3
    mask_threshold: float = 0.0
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    # fp32 softmax in the ViT attention's plain lane (official numerics);
    # False keeps bf16 logits with an fp32 row sum when the model runs
    # in bf16
    attn_softmax_fp32: bool = True
    # the global blocks through the flash-attention lane
    global_attn_flash: bool = False

    @property
    def embed_hw(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


# ------------------------------------------ layers with a compute dtype

def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class _Linear(nn.Linear):
    """flax nn.Dense(dtype=): float32 parameters; input, weight and bias
    cast to `compute_dtype`, the output in it."""

    def __init__(self, fin: int, fout: int, bias: bool = True,
                 compute_dtype=torch.float32):
        super().__init__(fin, fout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class _Conv2d(nn.Conv2d):
    """flax nn.Conv(dtype=), as `_Linear`."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class _ConvTranspose2d(nn.ConvTranspose2d):
    """flax nn.ConvTranspose(dtype=), as `_Linear`."""

    def __init__(self, *args, compute_dtype=torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class _LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm(dtype=): statistics and affine in float32, the
    output in `compute_dtype`."""

    def __init__(self, dim: int, eps: float, compute_dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        f = torch.float32
        return F.layer_norm(x.to(f), self.normalized_shape,
                            self.weight.to(f), self.bias.to(f),
                            self.eps).to(self.compute_dtype)


# ------------------------------------------------ image encoder (ViT)

def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """(2*size-1, head_dim) table -> (q_size, k_size, head_dim) lookup;
    q_size == k_size everywhere in SAM, so no interpolation."""
    dev = rel_pos.device
    coords = (torch.arange(q_size, device=dev)[:, None]
              - torch.arange(k_size, device=dev)[None, :] + (k_size - 1))
    return rel_pos[coords]


def _add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, hw):
    """attn: (B*nH, q_hw, k_hw); q: (B*nH, q_hw, head_dim)."""
    h, w = hw
    rh = _get_rel_pos(h, h, rel_pos_h)
    rw = _get_rel_pos(w, w, rel_pos_w)
    bnh = q.shape[0]
    r_q = q.reshape(bnh, h, w, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.reshape(bnh, h, w, h, w)
            + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :])
    return attn.reshape(bnh, h * w, h * w)


class ViTAttention(nn.Module):
    """Multi-head attention over a (B, H, W, C) grid with decomposed
    relative position embeddings (official image_encoder.Attention)."""

    def __init__(self, dim: int, num_heads: int, input_size: int,
                 softmax_fp32: bool = True, use_flash: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.input_size = input_size
        self.softmax_fp32 = softmax_fp32
        self.use_flash = use_flash
        head_dim = dim // num_heads
        self.qkv = _Linear(dim, dim * 3, compute_dtype=dtype)
        self.proj = _Linear(dim, dim, compute_dtype=dtype)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1,
                                                  head_dim))

    def forward(self, x):
        b, h, w, dim = x.shape
        nh = self.num_heads
        hd = dim // nh
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        flash = (self.use_flash and h == w == self.input_size
                 and fa.supported(h, h * w, hd))
        if flash:
            qkv = qkv.contiguous()      # the kernel reads dense rows
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)

        if flash:
            # the two small einsum factors the plain lane computes; the
            # kernel rebuilds the (S, S) bias from them tile by tile
            bnh = q.shape[0]
            r_q = q.reshape(bnh, h, w, hd)
            rh = _get_rel_pos(h, h, self.rel_pos_h.to(q.dtype))
            rw = _get_rel_pos(w, w, self.rel_pos_w.to(q.dtype))
            rel_hf = torch.einsum("bhwc,hkc->bhwk", r_q, rh).reshape(
                bnh, h * w, h)
            rel_wf = torch.einsum("bhwc,wkc->bhwk", r_q, rw).reshape(
                bnh, h * w, w)
            out = fa.flash_attention_relpos(
                q, k, v, rel_hf.contiguous(), rel_wf.contiguous(),
                scale=hd ** -0.5, grid_size=h)
        else:
            attn = (q * (hd ** -0.5)) @ k.transpose(1, 2)
            attn = _add_decomposed_rel_pos(
                attn, q, self.rel_pos_h.to(attn.dtype),
                self.rel_pos_w.to(attn.dtype), (h, w))
            if self.softmax_fp32 or attn.dtype == torch.float32:
                attn = torch.softmax(attn.float(), dim=-1)
            else:
                # bf16 logits end to end, only the row sum in fp32
                amax = attn.amax(dim=-1, keepdim=True).detach()
                e = torch.exp(attn - amax)
                s = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
                attn = e / s.to(e.dtype)
            out = attn.to(v.dtype) @ v
        out = out.reshape(b, nh, h, w, hd).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(b, h, w, dim))


def _window_partition(x, window: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % window, (-w) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def _window_unpartition(wins, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp // window * wp // window)
    x = wins.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act: nn.Module,
                 dtype=torch.float32):
        super().__init__()
        self.lin1 = _Linear(dim, hidden, compute_dtype=dtype)
        self.lin2 = _Linear(hidden, dim, compute_dtype=dtype)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, grid_size: int,
                 softmax_fp32: bool = True, use_flash: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.window_size = window_size          # 0 => global attention
        self.norm1 = _LayerNorm(dim, 1e-6, dtype)
        attn_size = window_size if window_size > 0 else grid_size
        self.attn = ViTAttention(dim, num_heads, attn_size,
                                 softmax_fp32=softmax_fp32,
                                 use_flash=use_flash and window_size == 0,
                                 dtype=dtype)
        self.norm2 = _LayerNorm(dim, 1e-6, dtype)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio),
                            nn.GELU(approximate="none"), dtype)

    def forward(self, x):
        shortcut = x
        y = self.norm1(x)
        if self.window_size > 0:
            with span("sam.window_attn", y.device):
                h, w = y.shape[1], y.shape[2]
                y, pad_hw = _window_partition(y, self.window_size)
                y = self.attn(y)
                y = _window_unpartition(y, self.window_size, pad_hw, (h, w))
        else:
            with span("sam.global_attn", y.device):
                y = self.attn(y)
        x = shortcut + y
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (official
    common.LayerNorm2d), in float32, the output in `dtype`."""

    def __init__(self, channels: int, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x):
        f = torch.float32
        y = F.layer_norm(x.permute(0, 2, 3, 1).to(f), x.shape[1:2],
                         self.weight.to(f), self.bias.to(f), self.eps)
        return y.to(self.compute_dtype).permute(0, 3, 1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.proj = _Conv2d(3, dim, patch, stride=patch, compute_dtype=dtype)

    def forward(self, x_nhwc):
        return self.proj(x_nhwc.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=torch.float32):
        super().__init__()
        c = cfg
        g = c.embed_hw
        self.patch_embed = PatchEmbed(c.patch_size, c.encoder_dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, c.encoder_dim))
        self.blocks = nn.ModuleList([
            ViTBlock(c.encoder_dim, c.encoder_heads, c.encoder_mlp_ratio,
                     0 if i in c.global_attn_indexes else c.window_size, g,
                     softmax_fp32=c.attn_softmax_fp32,
                     use_flash=c.global_attn_flash, dtype=dtype)
            for i in range(c.encoder_depth)])
        self.neck = nn.Sequential(
            _Conv2d(c.encoder_dim, c.prompt_dim, 1, bias=False,
                    compute_dtype=dtype),
            LayerNorm2d(c.prompt_dim, dtype=dtype),
            _Conv2d(c.prompt_dim, c.prompt_dim, 3, padding=1, bias=False,
                    compute_dtype=dtype),
            LayerNorm2d(c.prompt_dim, dtype=dtype))

    def forward(self, x):
        """x: (B, img, img, 3) preprocessed floats -> (B, g, g, C) in the
        compute dtype."""
        with span("sam.image_encoder", x.device):
            y = self.patch_embed(x)
            y = y + self.pos_embed.to(y.dtype)
            for blk in self.blocks:
                y = blk(y)
            return self.neck(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ----------------------------------------------------- prompt encoder

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_feats: int):
        super().__init__()
        # a buffer in the official code, so it is in the checkpoint
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_feats))


class PromptEncoder(nn.Module):
    """Point/box/dense prompt embeddings (official prompt_encoder.py).
    Labels: 1 positive point, 0 negative point, -1 padding, 2/3 box
    corners."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.prompt_dim
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, d) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def _pe_encoding(self, coords01):
        """coords01 in [0,1] -> (..., prompt_dim) Fourier features."""
        gm = self.pe_layer.positional_encoding_gaussian_matrix
        coords = 2.0 * coords01 - 1.0
        coords = coords @ gm.to(coords.dtype)
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def dense_pe(self):
        """(1, g, g, prompt_dim) positional encoding of the image grid."""
        g = self.cfg.embed_hw
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        xs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self._pe_encoding(grid)[None]

    def embed_points(self, coords, labels):
        """coords: (B, N, 2) pixel xy in the model input frame; labels:
        (B, N) int. Returns (B, N, prompt_dim)."""
        coords = (coords + 0.5) / self.cfg.img_size
        pe = self._pe_encoding(coords.to(torch.float32))
        lab = labels[..., None]
        out = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for i, emb in enumerate(self.point_embeddings):
            out = torch.where(lab == i, out + emb.weight[0], out)
        return out

    def dense_no_mask(self, batch: int):
        g = self.cfg.embed_hw
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, g, g, self.cfg.prompt_dim)


# ------------------------------------------------------- mask decoder

class DecoderAttention(nn.Module):
    """q/k/v-projected attention with internal downsampling (official
    transformer.Attention)."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1,
                 dtype=torch.float32):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = _Linear(dim, inner, compute_dtype=dtype)
        self.k_proj = _Linear(dim, inner, compute_dtype=dtype)
        self.v_proj = _Linear(dim, inner, compute_dtype=dtype)
        self.out_proj = _Linear(inner, dim, compute_dtype=dtype)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        nh = self.num_heads
        hd = q.shape[-1] // nh

        def split(x):
            b, n, _ = x.shape
            return x.reshape(b, n, nh, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = (q / math.sqrt(hd)) @ k.transpose(2, 3)
        attn = torch.softmax(attn.float(), dim=-1)
        out = attn.to(v.dtype) @ v
        b, _, n, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, nh * hd))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool, dtype=torch.float32):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        # decoder LayerNorms: torch's default eps 1e-5 (official
        # TwoWayTransformer), unlike the encoder's 1e-6
        self.self_attn = DecoderAttention(dim, num_heads, dtype=dtype)
        self.norm1 = _LayerNorm(dim, 1e-5, dtype)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2,
                                                          dtype)
        self.norm2 = _LayerNorm(dim, 1e-5, dtype)
        self.mlp = MLPBlock(dim, mlp_dim, nn.ReLU(), dtype)
        self.norm3 = _LayerNorm(dim, 1e-5, dtype)
        self.norm4 = _LayerNorm(dim, 1e-5, dtype)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2,
                                                          dtype)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                 queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=torch.float32):
        super().__init__()
        d = cfg.prompt_dim
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(d, cfg.decoder_heads, cfg.decoder_mlp_dim,
                                 skip_first_layer_pe=(i == 0), dtype=dtype)
            for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = DecoderAttention(
            d, cfg.decoder_heads, 2, dtype)
        self.norm_final_attn = _LayerNorm(d, 1e-5, dtype)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe: (B, g, g, C); point_embedding:
        (B, N, C). Returns (queries (B,N,C), keys (B,g*g,C))."""
        b, g1, g2, ch = image_embedding.shape
        keys = image_embedding.reshape(b, g1 * g2, ch)
        key_pe = image_pe.reshape(1, g1 * g2, ch).expand(keys.shape)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, dims, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            [_Linear(a, b, compute_dtype=dtype)
             for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig, dtype=torch.float32):
        super().__init__()
        d, nm = cfg.prompt_dim, cfg.num_mask_tokens
        self.transformer = TwoWayTransformer(cfg, dtype)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(nm, d)
        self.output_upscaling = nn.Sequential(
            _ConvTranspose2d(d, d // 4, 2, stride=2, compute_dtype=dtype),
            LayerNorm2d(d // 4, dtype=dtype),
            nn.GELU(approximate="none"),
            _ConvTranspose2d(d // 4, d // 8, 2, stride=2,
                             compute_dtype=dtype),
            nn.GELU(approximate="none"))
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP((d, d, d, d // 8), dtype) for _ in range(nm)])
        self.iou_prediction_head = MLP((d, d, d, nm), dtype)

    def forward(self, image_embeddings, image_pe, sparse_prompt,
                dense_prompt):
        """image_embeddings, dense_prompt: (B, g, g, C); sparse_prompt:
        (B, N, C). Returns (masks (B, nm, 4g, 4g), iou (B, nm))."""
        b = sparse_prompt.shape[0]
        nm = self.mask_tokens.weight.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1),
                            sparse_prompt], dim=1)
        src = image_embeddings + dense_prompt
        hs, src = self.transformer(src, image_pe, tokens)
        iou_out, mask_out = hs[:, 0], hs[:, 1:1 + nm]

        g = image_embeddings.shape[1]
        src = src.transpose(1, 2).reshape(b, -1, g, g)
        up = self.output_upscaling(src)             # (B, d//8, 4g, 4g)
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)],
                            dim=1)                   # (B, nm, d//8)
        masks = (hyper @ up.flatten(2)).reshape(b, nm, 4 * g, 4 * g)
        return masks, self.iou_prediction_head(iou_out)


# ------------------------------------------------------------ wrapper

class Sam(nn.Module):
    """The three parts. The predictor calls them separately, so the
    image embedding is computed once per frame.

    `dtype` is the compute dtype, as JAX's `Sam(cfg, dtype=)`: the
    parameters stay float32 and `Sam(cfg, dtype=torch.bfloat16)` computes
    the linears, convolutions and residual stream in bf16 (LayerNorm
    statistics in float32, and the attention softmax unless
    `attn_softmax_fp32=False`). `Sam(cfg).to(
    torch.bfloat16)` is not that: it stores bf16 parameters and still
    computes in float32."""

    def __init__(self, cfg: Optional[SamConfig] = None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg or SamConfig()
        self.dtype = dtype
        self.image_encoder = ImageEncoderViT(self.cfg, dtype)
        self.prompt_encoder = PromptEncoder(self.cfg)
        self.mask_decoder = MaskDecoder(self.cfg, dtype)

    def preprocess(self, x_u8):
        """(B, H, W, 3) uint8/float RGB (longest side already at
        img_size) -> normalised, zero-padded (B, img, img, 3) float32."""
        c = self.cfg
        x = x_u8.to(torch.float32)
        mean = torch.tensor(c.pixel_mean, device=x.device)
        std = torch.tensor(c.pixel_std, device=x.device)
        x = (x - mean) / std
        return F.pad(x, (0, 0, 0, c.img_size - x.shape[2],
                         0, c.img_size - x.shape[1]))

    def encode_image(self, x):
        return self.image_encoder(x)

    def forward(self, images, boxes):
        """The box-prompted training forward (MedSAM's `MedSAM.forward`):
        images (B, img, img, 3) already normalised (`preprocess`'s
        (x - pixel_mean) / pixel_std, unpadded); boxes (B, 4) xyxy in
        input pixels, one a frame, embedded as the official two corner
        tokens (labels 2 and 3, as `SamPredictor._prompt_tokens` gives
        them) beside the no-mask dense embedding. Returns the first mask
        token's logits (`multimask_output=False`), upsampled bilinearly
        from (4g)^2 to img^2 with half-pixel centres (the official
        `postprocess_masks` resize): (B, 1, img, img) in the compute
        dtype."""
        feats = self.image_encoder(images)
        with span("sam.mask_decoder", images.device):
            b = boxes.shape[0]
            # made on the device: a host tensor's copy would wait for it
            labels = torch.arange(2, 4, device=boxes.device).expand(b, 2)
            masks, _ = self.decode(feats, boxes.reshape(b, 2, 2), labels)
            size = (self.cfg.img_size, self.cfg.img_size)
            return F.interpolate(masks[:, :1], size=size, mode="bilinear",
                                 align_corners=False)

    def decode(self, features, coords, labels):
        """features (1 or B, g, g, C); coords (B, N, 2) in the model
        input frame; labels (B, N). Every token is attended (the official
        predictor's single label -1 pad point is a real token)."""
        pe_mod = self.prompt_encoder
        dt = features.dtype
        sparse = pe_mod.embed_points(coords, labels).to(dt)
        dense = pe_mod.dense_no_mask(coords.shape[0]).to(dt)
        feats = features.expand((coords.shape[0],) + features.shape[1:])
        return self.mask_decoder(feats, pe_mod.dense_pe().to(dt), sparse,
                                 dense)


def build_sam_vit_b(dtype=torch.float32,
                    cfg: Optional[SamConfig] = None) -> Sam:
    """JAX's `build_sam_vit_b(dtype=jnp.float32, cfg=None)`."""
    return Sam(cfg or SamConfig(), dtype)


def strip_mask_downscaling(state_dict: Mapping) -> dict:
    """The official state dict without the mask-prompt path's keys."""
    return {k: v for k, v in state_dict.items()
            if not k.startswith(MASK_DOWNSCALING_PREFIX)}


# ----------------------------------------------------------- predictor

@dataclasses.dataclass(frozen=True)
class SamEmbedding:
    """An image's embedding with the geometry its prompts and masks are
    mapped through: features (1, g, g, C), the image's (h, w) and its
    resized (h, w) before the encoder's padding."""

    features: torch.Tensor
    orig_hw: Tuple[int, int]
    input_hw: Tuple[int, int]


class SamPredictor:
    """Drop-in for `segment_anything.SamPredictor` as the annotation tool
    drives it (cartseg_tpu/tools/annotate.py): `set_image`,
    `get_image_embedding`, `.features` injection and
    `predict(point_coords, point_labels, box, mask_input,
    multimask_output, return_logits)`, like `TpuSamPredictor`.

    `embed(image)` computes an image's `SamEmbedding` and leaves the
    predictor's state alone; `set_embedding(e)` installs one; `set_image`
    is the two together. A thread that embeds images ahead of the one
    that prompts them (tools/annotate.py `PrefetchWorker`) uses `embed`,
    so a prompt always decodes against its own image's embedding.

    `state_dict` is an official-named SAM state dict (the
    `mask_downscaling` keys may be present and are dropped; any other
    missing or unexpected key raises). The model runs in float32 on
    `device` ("cuda" by default; "cpu" only when asked). Prompts run
    eagerly on the real token list: JAX's jit pad ladder is not needed.
    """

    def __init__(self, state_dict: Mapping, cfg: Optional[SamConfig] = None,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or SamConfig(global_attn_flash=True)
        model = Sam(self.cfg)
        model.load_state_dict(strip_mask_downscaling(state_dict))
        self.model = model.to(self.device).eval()
        self.features: Optional[torch.Tensor] = None
        self._orig_hw: Optional[Tuple[int, int]] = None
        self._input_hw: Optional[Tuple[int, int]] = None

    @torch.inference_mode()
    def embed(self, image_rgb: np.ndarray) -> SamEmbedding:
        """The ViT-B embedding of an HxWx3 uint8 RGB image (resized so
        its long side is img_size), without touching the predictor's
        state."""
        from cartseg_tpu_torch.utils.image_io import resize_bilinear_u8

        h, w = image_rgb.shape[:2]
        scale = self.cfg.img_size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        img = torch.from_numpy(np.ascontiguousarray(image_rgb)).to(
            self.device)
        img = resize_bilinear_u8(img, (nh, nw))
        feats = self.model.encode_image(self.model.preprocess(img[None]))
        return SamEmbedding(feats, (h, w), (nh, nw))

    def set_embedding(self, embedding: SamEmbedding) -> None:
        """Install an embedding from `embed`: later prompts decode
        against it."""
        self.features = embedding.features
        self._orig_hw = embedding.orig_hw
        self._input_hw = embedding.input_hw

    # --- SamPredictor API
    def set_image(self, image_rgb: np.ndarray):
        self.set_embedding(self.embed(image_rgb))
        return self.features

    def get_image_embedding(self):
        return self.features

    def _prompt_tokens(self, point_coords, point_labels, box):
        """The official token list in the model input frame: the points,
        then the two box corners (labels 2, 3) if a box is given, else
        ONE real (0, 0) / label -1 pad point."""
        if point_coords is None and box is None:
            raise ValueError(
                "predict() needs point_coords and/or box "
                "(SamPredictor.predict has the same requirement)")
        oh, ow = self._orig_hw
        scale = self.cfg.img_size / max(oh, ow)
        pts, labs = [], []
        if point_coords is not None:
            pts.append(np.asarray(point_coords, np.float32) * scale)
            labs.append(np.asarray(point_labels, np.int32))
        if box is None:
            pts.append(np.zeros((1, 2), np.float32))
            labs.append(np.asarray([-1], np.int32))
        else:
            pts.append(np.asarray(box, np.float32).reshape(2, 2) * scale)
            labs.append(np.asarray([2, 3], np.int32))
        return np.concatenate(pts, axis=0), np.concatenate(labs, axis=0)

    @torch.inference_mode()
    def predict(self, point_coords=None, point_labels=None, box=None,
                mask_input=None, multimask_output: bool = True,
                return_logits: bool = False):
        if self.features is None:
            raise RuntimeError("call set_image first")
        if mask_input is not None:
            raise NotImplementedError(
                "mask prompts are not used by the annotation tools")
        coords, labels = self._prompt_tokens(point_coords, point_labels, box)
        masks, iou = self.model.decode(
            self.features, torch.from_numpy(coords)[None].to(self.device),
            torch.from_numpy(labels)[None].to(self.device))
        masks, iou = self._postprocess(masks)[0], iou[0]
        sel = slice(1, None) if multimask_output else slice(0, 1)
        masks, iou = masks[sel], iou[sel]
        if not return_logits:
            masks = masks > self.cfg.mask_threshold
        return masks.cpu().numpy(), iou.cpu().numpy(), None

    def _postprocess(self, masks):
        """(B, nm, 4g, 4g) low-res logits -> original resolution (official
        Sam.postprocess_masks): upsample to img_size, crop the un-padded
        region, resize to the original size. Bilinear with half-pixel
        centres, antialiased where it downsamples, as jax.image.resize."""
        c = self.cfg
        ih, iw = self._input_hw
        oh, ow = self._orig_hw
        m = _resize_bilinear(masks, (c.img_size, c.img_size))
        return _resize_bilinear(m[:, :, :ih, :iw], (oh, ow))


def _resize_bilinear(x, size):
    """jax.image.resize(..., "bilinear") on the last two axes of NCHW."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    down = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=down)


def load_sam_checkpoint(checkpoint_path, cfg: Optional[SamConfig] = None,
                        *, device="cuda") -> SamPredictor:
    """A SamPredictor from an official `sam_vit_b_*.pth` state dict
    (cartseg_tpu/models/sam.py `load_tpu_sam`)."""
    sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    return SamPredictor(sd, cfg, device=device)
