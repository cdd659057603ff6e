"""Flash attention with SAM's decomposed relative-position bias, forward
and backward: the CUDA kernels' wrappers and their plain PyTorch
versions.

Counterpart of cartseg_tpu/ops/pallas/flash_attention.py (`_kernel`,
`_bwd_dq_kernel`, `_bwd_dkv_kernel`). For q, k, v [bnh, S, hd] with
S = g*g and the two bias factors rel_h, rel_w [bnh, S, g]:

    out = softmax(scale * q @ k^T + bias) @ v,
    bias[i, kh*g + kw] = rel_h[i, kh] + rel_w[i, kw],

with an fp32 softmax whatever the input type and the output in q's type.
The training forward also gives each row's fp32 logsumexp `lse`; the
backward recomputes P = exp(logits - lse) tile by tile (Dao et al.):

    D = rowsum(dO * O),  dS = P * (dO @ v^T - D),
    dq = scale * dS @ k,  dk = scale * dS^T @ q,  dv = P^T @ dO,
    drel_h[i, kh] = sum_kw dS[i, kh*g+kw],  drel_w[i, kw] = sum_kh (same),

the gradients in their inputs' types. Kernels: for the forward,
csrc/flash_relpos.cu, whose C entry point runs float32 on the tensor cores
as split-TF32 products (`flash_fwd_tf32x3`, counted as `flash_fwd`) and
hands bfloat16 to the tensor-core kernel of csrc/flash_relpos_fwd_tc.cu
(`flash_fwd_tc`: P rounded to bf16 as the operand of P V, as
FlashAttention does); for the backward (`flash_bwd_dq`: dq, drel_h,
drel_w; `flash_bwd_dkv`: dk, dv), csrc/flash_relpos_bwd.cu, whose C entry
points run float32 on the tensor cores as split-TF32 products
(`flash_bwd_dq_tf32x3`, `flash_bwd_dkv_tf32x3`) and hand bfloat16 to the
tensor-core kernels of csrc/flash_relpos_bwd_tc.cu (P and dS rounded to
bf16 as the operands of the second products). Split TF32
(csrc/flash_tf32x3_common.cuh): each fp32 operand cut into two TF32
halves, hi lo + lo hi + hi hi summed in fp32, the softmax, P, dS and every
sum fp32; within 1e-5 of the plain versions (tests/test_torch_flash_fwd_
tf32x3.py and tests/test_torch_flash_bwd_tf32x3.py emulate it on the CPU).
D stays one PyTorch expression, as JAX leaves it to XLA. A wrapper given
CPU tensors runs the plain version, which materialises the (bnh, S, S)
logits; given CUDA tensors it launches its kernel or raises. Nothing falls
back.
"""

from __future__ import annotations

import torch

from cartseg_tpu_torch.ops.cuda import build as B

HEAD_DIMS = (32, 64)
# the largest grid the kernels take: flash_bwd_dq's shared-memory tiles
# ([64, g] drel sums beside the row tiles) fit the SM up to here on both
# routes; SAM's 1024^2 input is g = 64, and 2048^2 is 128
MAX_GRID = 128
_DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------- plain versions

def _logits_plain(q, k, rel_h, rel_w, scale: float) -> torch.Tensor:
    """fp32 (bnh, S, S) logits, scale on the product as the kernels."""
    bnh, S, _ = q.shape
    f = torch.float32
    bias = rel_h.to(f)[:, :, :, None] + rel_w.to(f)[:, :, None, :]
    return (q.to(f) @ k.to(f).transpose(1, 2)) * scale + bias.reshape(
        bnh, S, S)


def flash_relpos_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, rel_h: torch.Tensor,
                           rel_w: torch.Tensor, scale: float,
                           grid_size: int) -> torch.Tensor:
    """The forward kernel's function with the logits materialised: fp32
    softmax, fp32 product with v, cast to q's type."""
    p = torch.softmax(_logits_plain(q, k, rel_h, rel_w, scale), dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def flash_relpos_fwd_lse_plain(q, k, v, rel_h, rel_w, scale: float,
                               grid_size: int):
    """The training forward: (out in q's type, fp32 lse [bnh, S]), with
    P = exp(logits - lse) written out."""
    logits = _logits_plain(q, k, rel_h, rel_w, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    return (p @ v.to(torch.float32)).to(q.dtype), lse


def _recompute_plain(q, k, v, rel_h, rel_w, do, lse, delta, scale):
    """fp32 (bnh, S, S) P and dS from the saved lse and D."""
    f = torch.float32
    p = torch.exp(_logits_plain(q, k, rel_h, rel_w, scale) - lse[..., None])
    dp = do.to(f) @ v.to(f).transpose(1, 2)
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_plain(q, k, v, rel_h, rel_w, do, lse, delta, scale: float,
                       grid_size: int):
    """`flash_bwd_dq`'s function: (dq, drel_h, drel_w)."""
    bnh, S, _ = q.shape
    g = int(grid_size)
    _, ds = _recompute_plain(q, k, v, rel_h, rel_w, do, lse, delta, scale)
    dq = (ds @ k.to(torch.float32)) * scale
    ds4 = ds.reshape(bnh, S, g, g)
    return (dq.to(q.dtype), ds4.sum(-1).to(rel_h.dtype),
            ds4.sum(-2).to(rel_w.dtype))


def flash_bwd_dkv_plain(q, k, v, rel_h, rel_w, do, lse, delta, scale: float,
                        grid_size: int):
    """`flash_bwd_dkv`'s function: (dk, dv)."""
    f = torch.float32
    p, ds = _recompute_plain(q, k, v, rel_h, rel_w, do, lse, delta, scale)
    dk = (ds.transpose(1, 2) @ q.to(f)) * scale
    return dk.to(k.dtype), (p.transpose(1, 2) @ do.to(f)).to(v.dtype)


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O), fp32 [bnh, S]: the backward's one PyTorch
    expression (JAX computes it in XLA, outside its kernels)."""
    return (do.to(torch.float32) * o.to(torch.float32)).sum(-1)


def flash_relpos_bwd_plain(q, k, v, rel_h, rel_w, o, lse, do, scale: float,
                           grid_size: int):
    """The backward's function: (dq, dk, dv, drel_h, drel_w)."""
    delta = row_delta(o, do)
    args = (q, k, v, rel_h, rel_w, do, lse, delta, scale, grid_size)
    dq, drh, drw = flash_bwd_dq_plain(*args)
    dk, dv = flash_bwd_dkv_plain(*args)
    return dq, dk, dv, drh, drw


# ------------------------------------------------------------- wrappers

def _check(what: str, grid_size: int, q, k, v, rel_h, rel_w, like_q=(),
           rows=()) -> None:
    """Raise on what the kernels do not take. like_q: more tensors of q's
    shape and type (dO); rows: fp32 [bnh, S] tensors (lse, D)."""
    ts = (q, k, v, rel_h, rel_w, *like_q)
    if q.dim() != 3:
        raise ValueError(f"{what}: need q [bnh,S,hd], got {tuple(q.shape)}")
    bnh, S, hd = q.shape
    g = int(grid_size)
    if S != g * g:
        raise ValueError(f"{what}: S = {S} is not grid_size^2 = {g * g}")
    if g > MAX_GRID:
        raise ValueError(f"{what}: grid_size {g} above {MAX_GRID}")
    if any(t.shape != q.shape for t in (k, v, *like_q)):
        raise ValueError(f"{what}: k, v, dO "
                         f"{[tuple(t.shape) for t in (k, v, *like_q)]} "
                         f"must match q {tuple(q.shape)}")
    if rel_h.shape != (bnh, S, g) or rel_w.shape != (bnh, S, g):
        raise ValueError(f"{what}: need rel_h, rel_w [{bnh},{S},{g}], got "
                         f"{tuple(rel_h.shape)}, {tuple(rel_w.shape)}")
    if any(t.shape != (bnh, S) or t.dtype != torch.float32 for t in rows):
        raise ValueError(f"{what}: need lse and D float32 [{bnh},{S}], got "
                         f"{[(tuple(t.shape), t.dtype) for t in rows]}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: need one type, float32 or bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    ts = ts + tuple(rows)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: tensors must start 16-byte aligned")
    if bnh > 65535:
        raise ValueError(f"{what}: bnh {bnh} above the grid's 65535")


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def flash_relpos_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rel_h: torch.Tensor, rel_w: torch.Tensor, scale: float,
                     grid_size: int, with_lse: bool = False):
    """[bnh,S,hd] attention output, and with `with_lse` also the fp32
    [bnh,S] logsumexp for the backward (the inference call writes none).
    CUDA: `flash_fwd_tf32x3` in csrc/flash_relpos.cu (float32, counted in
    LAUNCHES["flash_fwd"]), `flash_fwd_tc` in csrc/flash_relpos_fwd_tc.cu
    (bfloat16, LAUNCHES["flash_fwd_tc"]); CPU: the plain versions. No
    autograd on the CUDA lane (see `flash_attention_relpos` in
    ops/flash_attention.py)."""
    if _on_cpu(q, k, v, rel_h, rel_w):
        fn = flash_relpos_fwd_lse_plain if with_lse else flash_relpos_fwd_plain
        return fn(q, k, v, rel_h, rel_w, scale, grid_size)
    _check("flash_relpos_fwd", grid_size, q, k, v, rel_h, rel_w)
    bnh, S, hd = q.shape
    lib = B.load_library()
    out = torch.empty_like(q)
    lse = (torch.empty((bnh, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        rc = lib.cartseg_flash_relpos_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bnh, S, int(grid_size),
            hd, int(q.dtype == torch.bfloat16), float(scale), B.stream_of(q))
    B.check(rc, "flash_relpos_fwd")
    B.LAUNCHES["flash_fwd_tc" if q.dtype == torch.bfloat16
               else "flash_fwd"] += 1
    return (out, lse) if with_lse else out


def flash_bwd_dq(q, k, v, rel_h, rel_w, do, lse, delta, scale: float,
                 grid_size: int):
    """(dq, drel_h, drel_w). CUDA: `flash_bwd_dq_tf32x3` in
    csrc/flash_relpos_bwd.cu (float32), `flash_bwd_dq_tc` in
    csrc/flash_relpos_bwd_tc.cu (bfloat16); CPU: `flash_bwd_dq_plain`."""
    args = (q, k, v, rel_h, rel_w, do, lse, delta)
    if _on_cpu(*args):
        return flash_bwd_dq_plain(*args, scale, grid_size)
    _check("flash_bwd_dq", grid_size, q, k, v, rel_h, rel_w, (do,),
           (lse, delta))
    bnh, S, hd = q.shape
    lib = B.load_library()
    dq, drh, drw = (torch.empty_like(t) for t in (q, rel_h, rel_w))
    with torch.cuda.device(q.device):
        rc = lib.cartseg_flash_relpos_bwd_dq(
            *(t.data_ptr() for t in args + (dq, drh, drw)), bnh, S,
            int(grid_size), hd, int(q.dtype == torch.bfloat16), float(scale),
            B.stream_of(q))
    B.check(rc, "flash_bwd_dq")
    B.LAUNCHES["flash_bwd_dq"] += 1
    return dq, drh, drw


def flash_bwd_dkv(q, k, v, rel_h, rel_w, do, lse, delta, scale: float,
                  grid_size: int):
    """(dk, dv). CUDA: `flash_bwd_dkv_tf32x3` in csrc/flash_relpos_bwd.cu
    (float32), `flash_bwd_dkv_tc` in csrc/flash_relpos_bwd_tc.cu
    (bfloat16); CPU: `flash_bwd_dkv_plain`."""
    args = (q, k, v, rel_h, rel_w, do, lse, delta)
    if _on_cpu(*args):
        return flash_bwd_dkv_plain(*args, scale, grid_size)
    _check("flash_bwd_dkv", grid_size, q, k, v, rel_h, rel_w, (do,),
           (lse, delta))
    bnh, S, hd = q.shape
    lib = B.load_library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = lib.cartseg_flash_relpos_bwd_dkv(
            *(t.data_ptr() for t in args + (dk, dv)), bnh, S,
            int(grid_size), hd, int(q.dtype == torch.bfloat16), float(scale),
            B.stream_of(q))
    B.check(rc, "flash_bwd_dkv")
    B.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_relpos_bwd(q, k, v, rel_h, rel_w, o, lse, do, scale: float,
                     grid_size: int):
    """(dq, dk, dv, drel_h, drel_w) from the forward's inputs, its output
    `o` and `lse`, and the output's gradient `do` (contiguous, q's shape
    and type). CUDA: D, then the two kernels; CPU: the plain versions."""
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_relpos_bwd: o {tuple(o.shape)} and dO "
                         f"{tuple(do.shape)} must match q {tuple(q.shape)}")
    args = (q, k, v, rel_h, rel_w, do, lse, row_delta(o, do), scale,
            grid_size)
    dq, drh, drw = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    return dq, dk, dv, drh, drw
