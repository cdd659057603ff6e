"""Plain PyTorch SAM ViT-B (Kirillov et al., arXiv:2304.02643; the
official `segment_anything` modeling code, `build_sam_vit_b`) with its
prompt encoder's box path and its mask decoder, and the MedSAM
fine-tune step (Ma et al., arXiv:2304.12306): the train_512 augmentation
of reference/train.py, one jittered box a frame from its augmented mask,
the box-prompted forward, BCE+Dice on the logits upsampled to the input
size, gradients by autograd, AdamW on the image encoder and the mask
decoder.

Functions over a flat dict of tensors in the official checkpoint naming
(`image_encoder.blocks.2.attn.qkv.weight`, `mask_decoder.transformer.
layers.0.self_attn.q_proj.bias`, ...). It is the yardstick the port is
held to: it imports nothing of the port, computes in float32 with TF32
off (`fp32_flags`), and has no flash attention and no kernel. `quant`,
where given, rounds both operands of every product (linears,
convolutions, the attention's two products, the rel-pos einsums);
`quant_grad` rounds the gradient each product's output receives: the
control runs the same functions with fp8 operands.

Departures from the official code, none of which changes the
mathematics:
  - the global attention runs in chunks of query rows, and with `remat`
    each block and each chunk is recomputed in the backward
    (torch.utils.checkpoint), so that a float32 step at the published
    widths fits on the card;
  - a batch pairs each frame's embedding with its own prompt (MedSAM's
    mask decoder; the official one repeats each image for all prompts);
  - the IoU head is not computed: the loss does not read it, so it gets
    no gradient and AdamW leaves it (MedSAM's step likewise).
The port computes in rounding-level other ways (it scales q before the
decoder attention's product, its bf16 residual stream); the LayerNorm
eps are the official ones (1e-6 in the encoder, neck and upscaling,
torch's 1e-5 in the decoder's transformer) and GELU is exact.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from cellbench.reference import train as ref_train
from cellbench.reference.unet import fp32_flags

Params = Dict[str, torch.Tensor]
ENC_EPS, DEC_EPS = 1e-6, 1e-5
IOU_HEAD = "mask_decoder.iou_prediction_head."


@dataclasses.dataclass(frozen=True)
class Sizes:
    """SAM ViT-B's published sizes (`build_sam_vit_b`); img_size may be
    cut for a test, every width stays."""
    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 768
    encoder_depth: int = 12
    encoder_heads: int = 12
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    prompt_dim: int = 256
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    decoder_depth: int = 2
    num_mask_tokens: int = 4

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def sizes_of(config: dict, img_size: int) -> Sizes:
    """The sizes a configuration file states, for img_size² frames."""
    keys = {f.name for f in dataclasses.fields(Sizes)} - {"img_size"}
    kw = {k: config[k] for k in keys if k in config}
    kw["global_attn_indexes"] = tuple(kw.get("global_attn_indexes",
                                             Sizes.global_attn_indexes))
    return Sizes(img_size=img_size, **kw)


# ------------------------------------------------------------ the specs

def _lin(out: List, name: str, fin: int, fout: int, bias: bool = True):
    out.append((name + ".weight", (fout, fin), ("linear", fin)))
    if bias:
        out.append((name + ".bias", (fout,), ("bias", fin)))


def _ln(out: List, name: str, c: int):
    out.append((name + ".weight", (c,), ("gamma", c)))
    out.append((name + ".bias", (c,), ("beta", c)))


def _dec_attn(out: List, name: str, d: int, down: int):
    inner = d // down
    for proj in ("q_proj", "k_proj", "v_proj"):
        _lin(out, f"{name}.{proj}", d, inner)
    _lin(out, f"{name}.out_proj", inner, d)


def param_specs(s: Sizes) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, (kind, fan-in)) of every parameter and buffer of the
    model the port loads, in a fixed order. kind: linear | conv | convT |
    bias | gamma | beta | embed | pos | rel_pos | gauss."""
    out: List = []
    d, g, p = s.encoder_dim, s.grid, s.patch_size
    hd = d // s.encoder_heads
    e = "image_encoder"
    out.append((f"{e}.patch_embed.proj.weight", (d, 3, p, p),
                ("conv", 3 * p * p)))
    out.append((f"{e}.patch_embed.proj.bias", (d,), ("bias", 3 * p * p)))
    out.append((f"{e}.pos_embed", (1, g, g, d), ("pos", d)))
    for i in range(s.encoder_depth):
        b = f"{e}.blocks.{i}"
        size = g if i in s.global_attn_indexes else s.window_size
        _ln(out, b + ".norm1", d)
        _lin(out, b + ".attn.qkv", d, 3 * d)
        _lin(out, b + ".attn.proj", d, d)
        for axis in ("h", "w"):
            out.append((f"{b}.attn.rel_pos_{axis}", (2 * size - 1, hd),
                        ("rel_pos", hd)))
        _ln(out, b + ".norm2", d)
        hidden = int(d * s.mlp_ratio)
        _lin(out, b + ".mlp.lin1", d, hidden)
        _lin(out, b + ".mlp.lin2", hidden, d)
    c = s.prompt_dim
    out.append((f"{e}.neck.0.weight", (c, d, 1, 1), ("conv", d)))
    _ln(out, f"{e}.neck.1", c)
    out.append((f"{e}.neck.2.weight", (c, c, 3, 3), ("conv", 9 * c)))
    _ln(out, f"{e}.neck.3", c)
    pe = "prompt_encoder"
    out.append((f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
                (2, c // 2), ("gauss", 2)))
    for i in range(4):
        out.append((f"{pe}.point_embeddings.{i}.weight", (1, c),
                    ("embed", c)))
    out.append((f"{pe}.not_a_point_embed.weight", (1, c), ("embed", c)))
    out.append((f"{pe}.no_mask_embed.weight", (1, c), ("embed", c)))
    md, t = "mask_decoder", "mask_decoder.transformer"
    for i in range(s.decoder_depth):
        b = f"{t}.layers.{i}"
        _dec_attn(out, b + ".self_attn", c, 1)
        _ln(out, b + ".norm1", c)
        _dec_attn(out, b + ".cross_attn_token_to_image", c, 2)
        _ln(out, b + ".norm2", c)
        _lin(out, b + ".mlp.lin1", c, s.decoder_mlp_dim)
        _lin(out, b + ".mlp.lin2", s.decoder_mlp_dim, c)
        _ln(out, b + ".norm3", c)
        _ln(out, b + ".norm4", c)
        _dec_attn(out, b + ".cross_attn_image_to_token", c, 2)
    _dec_attn(out, f"{t}.final_attn_token_to_image", c, 2)
    _ln(out, f"{t}.norm_final_attn", c)
    nm = s.num_mask_tokens
    out.append((f"{md}.iou_token.weight", (1, c), ("embed", c)))
    out.append((f"{md}.mask_tokens.weight", (nm, c), ("embed", c)))
    out.append((f"{md}.output_upscaling.0.weight", (c, c // 4, 2, 2),
                ("convT", c)))
    out.append((f"{md}.output_upscaling.0.bias", (c // 4,), ("bias", c)))
    _ln(out, f"{md}.output_upscaling.1", c // 4)
    out.append((f"{md}.output_upscaling.3.weight", (c // 4, c // 8, 2, 2),
                ("convT", c // 4)))
    out.append((f"{md}.output_upscaling.3.bias", (c // 8,),
                ("bias", c // 4)))
    for i in range(nm):
        for j, (a, b_) in enumerate(((c, c), (c, c), (c, c // 8))):
            _lin(out, f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", a,
                 b_)
    for j, (a, b_) in enumerate(((c, c), (c, c), (c, nm))):
        _lin(out, f"{md}.iou_prediction_head.layers.{j}", a, b_)
    return out


def trained(name: str) -> bool:
    """The parameters MedSAM's AdamW moves: the image encoder and the
    mask decoder, whose IoU head the mask loss gives no gradient."""
    return name.startswith(("image_encoder.", "mask_decoder.")) \
        and not name.startswith(IOU_HEAD)


def group_of(name: str) -> int:
    """encoder 0 (the image encoder), decoder 1 (the mask decoder)."""
    return 0 if name.startswith("image_encoder.") else 1


# ---------------------------------------------------------- the forward

def _rel_pos(size: int, table: torch.Tensor) -> torch.Tensor:
    """The official get_rel_pos at equal query and key sizes: [size,
    size, hd], entry (i, j) the table's row i - j + size - 1."""
    i = torch.arange(size, device=table.device)
    return table[i[:, None] - i[None, :] + (size - 1)]


class Model:
    """The box-prompted forward of one SAM over `params`. quant: applied
    to both operands of every product; quant_grad: to every product's
    output (the gradient its backward receives). remat: each encoder
    block, and each query chunk of a global block, recomputed in the
    backward. chunk: query rows a global block's softmax holds at once
    (None: all)."""

    def __init__(self, s: Sizes, params: Params,
                 quant: Optional[Callable] = None,
                 quant_grad: Optional[Callable] = None,
                 remat: bool = False, chunk: Optional[int] = None):
        self.s, self.P = s, params
        self.quant, self.quant_grad = quant, quant_grad
        self.remat, self.chunk = remat, chunk

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    def _q(self, *ts):
        return ts if self.quant is None else tuple(self.quant(t) for t in ts)

    def _out(self, y):
        return y if self.quant_grad is None else self.quant_grad(y)

    def mm(self, a, b):
        a, b = self._q(a, b)
        return self._out(a @ b)

    def einsum(self, eq, a, b):
        a, b = self._q(a, b)
        return self._out(torch.einsum(eq, a, b))

    def linear(self, name, x):
        x, w = self._q(x, self.P[name + ".weight"])
        return self._out(F.linear(x, w, self.P.get(name + ".bias")))

    def conv(self, name, x, stride=1, pad=0):
        x, w = self._q(x, self.P[name + ".weight"])
        return self._out(F.conv2d(x, w, self.P.get(name + ".bias"), stride,
                                  pad))

    def conv_t(self, name, x):
        x, w = self._q(x, self.P[name + ".weight"])
        return self._out(F.conv_transpose2d(x, w, self.P[name + ".bias"],
                                            stride=2))

    def ln(self, name, x, eps):
        """LayerNorm over the last axis, written out."""
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps) * self.P[name + ".weight"] \
            + self.P[name + ".bias"]

    def ln2d(self, name, x):
        """The official LayerNorm2d over the channels of NCHW, eps 1e-6."""
        u = x.mean(1, keepdim=True)
        v = (x - u).square().mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(v + ENC_EPS)
        return self.P[name + ".weight"][:, None, None] * x \
            + self.P[name + ".bias"][:, None, None]

    # ------------------------------------------------------ the encoder

    def vit_attention(self, p, x):
        """The official image_encoder.Attention with decomposed rel-pos
        over x [b, h, w, dim] (a window or the whole grid)."""
        b, h, w, dim = x.shape
        nh = self.s.encoder_heads
        hd = dim // nh
        bnh, n = b * nh, h * w
        qkv = self.linear(p + ".qkv", x).reshape(b, n, 3, nh, hd) \
            .permute(2, 0, 3, 1, 4).reshape(3, bnh, n, hd)
        q, k, v = qkv.unbind(0)
        r_q = q.reshape(bnh, h, w, hd)
        rel_h = self.einsum("bhwc,hkc->bhwk", r_q,
                            _rel_pos(h, self.P[p + ".rel_pos_h"]))
        rel_w = self.einsum("bhwc,wkc->bhwk", r_q,
                            _rel_pos(w, self.P[p + ".rel_pos_w"]))
        rel_h, rel_w = rel_h.reshape(bnh, n, h), rel_w.reshape(bnh, n, w)
        scale = hd ** -0.5

        def rows(qc, rhc, rwc):
            m = qc.shape[1]
            attn = self.mm(qc * scale, k.transpose(1, 2)).reshape(bnh, m, h,
                                                                  w)
            attn = attn + rhc[:, :, :, None] + rwc[:, :, None, :]
            attn = torch.softmax(attn.reshape(bnh, m, n), dim=-1)
            return self.mm(attn, v)

        step = self.chunk or n
        out = torch.cat([self._run(rows, q[:, i:i + step],
                                   rel_h[:, i:i + step], rel_w[:, i:i + step])
                         for i in range(0, n, step)], 1)
        out = out.reshape(b, nh, h, w, hd).permute(0, 2, 3, 1, 4)
        return self.linear(p + ".proj", out.reshape(b, h, w, dim))

    def block(self, i, x):
        p = f"image_encoder.blocks.{i}"
        ws = self.s.window_size
        shortcut = x
        y = self.ln(p + ".norm1", x, ENC_EPS)
        if i in self.s.global_attn_indexes:
            y = self.vit_attention(p + ".attn", y)
        else:
            b, h, w, c = y.shape
            ph, pw = (-h) % ws, (-w) % ws
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.reshape(b, hp // ws, ws, wp // ws, ws, c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
            y = self.vit_attention(p + ".attn", y)
            y = y.reshape(b, hp // ws, wp // ws, ws, ws, c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
        x = shortcut + y
        z = self.linear(p + ".mlp.lin1", self.ln(p + ".norm2", x, ENC_EPS))
        return x + self.linear(p + ".mlp.lin2", F.gelu(z))

    def encode(self, x_nhwc):
        """Normalised frames [B, img, img, 3] -> embeddings [B, C, g, g]."""
        e = "image_encoder"
        y = self.conv(f"{e}.patch_embed.proj", x_nhwc.permute(0, 3, 1, 2),
                      self.s.patch_size).permute(0, 2, 3, 1)
        y = y + self.P[f"{e}.pos_embed"]
        for i in range(self.s.encoder_depth):
            y = self._run(functools.partial(self.block, i), y)
        y = self.ln2d(f"{e}.neck.1", self.conv(f"{e}.neck.0",
                                               y.permute(0, 3, 1, 2)))
        return self.ln2d(f"{e}.neck.3", self.conv(f"{e}.neck.2", y, 1, 1))

    # ------------------------------------------------- prompts, decoder

    def pe(self, coords01):
        """The official PositionEmbeddingRandom._pe_encoding."""
        c = 2.0 * coords01 - 1.0
        c = 2.0 * math.pi * (c @ self.P[
            "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"])
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def prompts(self, boxes):
        """(sparse [B, 2, C], dense [B, C, g, g], image_pe [1, C, g, g])
        of the official PromptEncoder for one box a frame."""
        pe = "prompt_encoder"
        b, g, size = boxes.shape[0], self.s.grid, self.s.img_size
        corners = self.pe((boxes.reshape(b, 2, 2) + 0.5) / size)
        corners = torch.stack(
            [corners[:, 0] + self.P[f"{pe}.point_embeddings.2.weight"][0],
             corners[:, 1] + self.P[f"{pe}.point_embeddings.3.weight"][0]], 1)
        dense = self.P[f"{pe}.no_mask_embed.weight"].reshape(1, -1, 1, 1) \
            .expand(b, -1, g, g)
        ones = torch.ones((g, g), device=boxes.device)
        ys = (ones.cumsum(0) - 0.5) / g
        xs = (ones.cumsum(1) - 0.5) / g
        image_pe = self.pe(torch.stack([xs, ys], -1)).permute(2, 0, 1)[None]
        return corners, dense, image_pe

    def dec_attention(self, p, q, k, v):
        """The official transformer.Attention."""
        q = self.linear(p + ".q_proj", q)
        k = self.linear(p + ".k_proj", k)
        v = self.linear(p + ".v_proj", v)
        nh = self.s.decoder_heads

        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, nh, c // nh).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = self.mm(q, k.permute(0, 1, 3, 2)) / math.sqrt(q.shape[-1])
        out = self.mm(torch.softmax(attn, dim=-1), v)
        b, _, n, hd = out.shape
        return self.linear(p + ".out_proj",
                           out.transpose(1, 2).reshape(b, n, nh * hd))

    def two_way(self, i, queries, keys, query_pe, key_pe):
        """The official TwoWayAttentionBlock."""
        p = f"mask_decoder.transformer.layers.{i}"
        if i == 0:
            queries = self.dec_attention(p + ".self_attn", queries, queries,
                                         queries)
        else:
            q = queries + query_pe
            queries = queries + self.dec_attention(p + ".self_attn", q, q,
                                                   queries)
        queries = self.ln(p + ".norm1", queries, DEC_EPS)
        q, k = queries + query_pe, keys + key_pe
        queries = self.ln(p + ".norm2", queries + self.dec_attention(
            p + ".cross_attn_token_to_image", q, k, keys), DEC_EPS)
        mlp = self.linear(p + ".mlp.lin2", F.relu(self.linear(
            p + ".mlp.lin1", queries)))
        queries = self.ln(p + ".norm3", queries + mlp, DEC_EPS)
        q, k = queries + query_pe, keys + key_pe
        keys = self.ln(p + ".norm4", keys + self.dec_attention(
            p + ".cross_attn_image_to_token", k, q, queries), DEC_EPS)
        return queries, keys

    def decode(self, embeddings, sparse, dense, image_pe):
        """The official MaskDecoder.predict_masks, each frame with its own
        prompt: the mask logits [B, num_mask_tokens, 4g, 4g]."""
        md, t = "mask_decoder", "mask_decoder.transformer"
        b, c, g, _ = embeddings.shape
        out_tokens = torch.cat([self.P[f"{md}.iou_token.weight"],
                                self.P[f"{md}.mask_tokens.weight"]], 0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], 1)
        src = embeddings + dense
        keys = src.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for i in range(self.s.decoder_depth):
            queries, keys = self.two_way(i, queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.ln(f"{t}.norm_final_attn", queries + self.dec_attention(
            f"{t}.final_attn_token_to_image", q, k, keys), DEC_EPS)
        nm = self.s.num_mask_tokens
        up = keys.transpose(1, 2).reshape(b, c, g, g)
        up = F.gelu(self.ln2d(f"{md}.output_upscaling.1", self.conv_t(
            f"{md}.output_upscaling.0", up)))
        up = F.gelu(self.conv_t(f"{md}.output_upscaling.3", up))
        hyper = []
        for i in range(nm):
            h = queries[:, 1 + i]
            p = f"{md}.output_hypernetworks_mlps.{i}.layers"
            h = F.relu(self.linear(p + ".0", h))
            h = F.relu(self.linear(p + ".1", h))
            hyper.append(self.linear(p + ".2", h))
        hyper = torch.stack(hyper, 1)
        bu, cu, hu, wu = up.shape
        return self.mm(hyper, up.reshape(bu, cu, hu * wu)).reshape(
            b, nm, hu, wu)

    def __call__(self, x_nhwc, boxes):
        """Normalised frames [B, img, img, 3] and boxes [B, 4] (xyxy
        pixels) -> the first mask's logits [B, 1, img, img], upsampled
        bilinearly with half-pixel centres (the official
        postprocess_masks' resize)."""
        sparse, dense, image_pe = self.prompts(boxes)
        masks = self.decode(self.encode(x_nhwc), sparse, dense, image_pe)
        size = (self.s.img_size, self.s.img_size)
        return F.interpolate(masks[:, :1], size=size, mode="bilinear",
                             align_corners=False)


# ---------------------------------------------------------------- steps

def box_prompts(m: torch.Tensor, gen: Optional[torch.Generator],
                jitter: int) -> torch.Tensor:
    """MedSAM's box of each augmented mask m [B, 1, H, W]: the smallest
    and largest column and row of its foreground (> 0.5), moved outward
    by one [B, 4] draw of integers in [0, jitter] (x0, y0, x1, y1 order;
    none at jitter 0), clipped to [0, W] x [0, H]; the whole frame where
    a mask is empty. float32 [B, 4]."""
    B, _, H, W = m.shape
    d = torch.randint(0, jitter + 1, (B, 4), generator=gen,
                      device=m.device).tolist() if jitter > 0 \
        else [[0] * 4] * B
    out = []
    for b in range(B):
        ys, xs = torch.nonzero(m[b, 0] > 0.5, as_tuple=True)
        if len(ys) == 0:
            out.append([0, 0, W, H])
            continue
        x0, y0 = int(xs.min()) - d[b][0], int(ys.min()) - d[b][1]
        x1, y1 = int(xs.max()) + d[b][2], int(ys.max()) + d[b][3]
        out.append([min(max(x0, 0), W), min(max(y0, 0), H),
                    min(max(x1, 0), W), min(max(y1, 0), H)])
    return torch.tensor(out, dtype=torch.float32, device=m.device)


@torch.no_grad()
def adamw(P, grads, mu, nu, t: int, lrs, opt: dict) -> None:
    """AdamW step t (from 1) in place over the keys of grads, each
    parameter at its group's learning rate (`group_of`)."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    for k, g in grads.items():
        mu[k] = b1 * mu[k] + (1 - b1) * g
        nu[k] = b2 * nu[k] + (1 - b2) * g * g
        mhat = mu[k] / (1 - b1 ** t)
        vhat = nu[k] / (1 - b2 ** t)
        P[k] = P[k] - lrs[group_of(k)] * (mhat / (vhat.sqrt() + eps)
                                          + wd * P[k])


def follow(s: Sizes, params: Params, batches: List, aug_seed: int,
           traffic: dict, quant=None, quant_grad=None, yard=None,
           chunk: Optional[int] = None) -> dict:
    """The fine-tune's first len(batches) steps from `params`: each
    step's loss (and again as `regions`, the shape reference/train.py's
    `gaps` reads), its boxes, the first step's logits (NHWC), gradient
    and augmented masks, and the trained parameters after the last step;
    with `yard`, also the first step's logits with every product's
    operands rounded by it. The generator is seeded as the program's and
    drawn in its order: the augmentation's draws, then the boxes'."""
    opt = traffic["optimizer"]
    lrs = [opt["lr"] * f for f in opt["group_lr_scales"]]
    kw = traffic["loss"]["kwargs"]
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(aug_seed)
    P = {k: v.detach().clone() for k, v in params.items()}
    names = [k for k in P if trained(k)]
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    out = {"losses": [], "boxes": [], "first_grad": None, "yard_logits": None}
    with fp32_flags():
        for t, (images_u8, masks) in enumerate(batches, start=1):
            B, H, W, _ = images_u8.shape
            x, m = ref_train.augment(images_u8, masks,
                                     traffic["augment_params"],
                                     *ref_train.draws(gen, B, H, W, device))
            boxes = box_prompts(m, gen, traffic["box_jitter"])
            x = x.permute(0, 2, 3, 1)
            leaves = {k: P[k].requires_grad_(True) for k in names}
            logits = Model(s, P, quant, quant_grad, remat=True,
                           chunk=chunk)(x, boxes)
            loss = ref_train.bce_dice(logits.permute(0, 2, 3, 1),
                                      m.permute(0, 2, 3, 1),
                                      kw.get("bce_weight", 0.5),
                                      kw.get("smooth", 1.0))
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[k] for k in names])))
            out["losses"].append(float(loss.detach()))
            out["boxes"].append(boxes)
            if out["first_grad"] is None:
                out["first_grad"] = {k: g.clone() for k, g in grads.items()}
                out["first_masks"] = m.permute(0, 2, 3, 1)
                out["logits"] = logits.detach().permute(0, 2, 3, 1)
                if yard is not None:
                    with torch.no_grad():
                        out["yard_logits"] = Model(
                            s, P, yard, chunk=chunk)(x, boxes).permute(
                                0, 2, 3, 1)
            del logits, loss
            for k in names:
                P[k] = P[k].detach()
            adamw(P, grads, mu, nu, t, lrs, opt)
    out["regions"] = list(out["losses"])
    out["params"] = {k: P[k].detach() for k in names}
    return out


def box_gap(program: List[torch.Tensor], reference: List[torch.Tensor]
            ) -> float:
    """The largest |coordinate difference| in pixels between the
    program's boxes and the reference's, over the steps."""
    return max(float((a.to(b.device) - b).abs().max())
               for a, b in zip(program, reference))
