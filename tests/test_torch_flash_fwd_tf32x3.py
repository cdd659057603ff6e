"""The split-TF32 arithmetic of the float32 flash-attention forward kernel
(cartseg_tpu_torch/ops/cuda/csrc/flash_relpos.cu, `flash_fwd_tf32x3`),
emulated in plain PyTorch on the CPU, against the port's plain forward and
JAX's.

The kernel runs only on the card (tests/test_torch_kernels_cuda.py holds it
against the plain version there). What it does to the numbers can be
checked here: `_split_tf32_forward` below repeats its arithmetic tile by
tile. Q, each 64-key tile of K and V, and each tile's P are cut into hi =
tf32(x) and lo = tf32(x - hi) (tests/torch_port_helpers.py `split_tf32`,
the kernel's rounding), and each product is hi lo + lo hi, then + hi hi,
summed in fp32 (`mm_tf32x3`). The online softmax is fp32 in the log2
domain: logits t = scale log2(e) s + bias log2(e), keys past S at -inf,
the running max m from -1e30, alpha = exp2(m - m_new), P = exp2(t -
m_new), l = alpha l + rowsum(P); each tile's P V is summed from zero and
then joins acc = alpha acc + P V, as the kernel adds it on the FP32 pipes.
out = acc / l and lse = m ln 2 + log(l).

Tolerance: max abs difference over the reference's max |value|, within
1e-5 for out and lse: the fp32 route's own bound against the plain version
(FLASH_TOL[float32] in chip_smoke.py), not loosened for the tensor cores.
The emulation measured at most 9.6e-7 (out, at [2,4096,64]) and 2.0e-7
(lse) against the plain version, and 7.0e-7 / 1.3e-7 against JAX at
[2,256,64]. One TF32 product (hi hi alone) lands 4.8e-4 to 6.7e-4 away,
which `test_one_tf32_product_does_not_hold_fp32` pins, so the tolerance
does tell the two apart.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.ops.pallas import flash_attention as jfa
from cartseg_tpu_torch.ops.cuda import flash_attention as cfa
from torch_port_helpers import mm_tf32x3, one_torch_thread  # noqa: F401

FP32_TOL = 1e-5
LOG2E = math.log2(math.e)
TILE = 64  # the kernel's keys a tile


def _inputs(bnh, g, hd, seed=0):
    """The card tests' recipe, drawn with numpy: q, k, v ~ N(0,1), the rel
    factors 0.5 N(0,1), fp32."""
    r = np.random.default_rng(seed)
    S = g * g
    arrs = [r.standard_normal((bnh, S, hd)).astype(np.float32)
            for _ in range(3)]
    arrs += [0.5 * r.standard_normal((bnh, S, g)).astype(np.float32)
             for _ in range(2)]
    return [torch.from_numpy(a) for a in arrs]


def _split_tf32_forward(q, k, v, rel_h, rel_w, scale: float, grid_size: int,
                        terms: int = 3):
    """(out, lse) with the kernel's arithmetic, one 64-key tile at a time."""
    f = torch.float32
    bnh, S, hd = q.shape
    g = int(grid_size)
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(bnh, S, S)
    sl2 = torch.tensor(scale * LOG2E, dtype=f)
    m = torch.full((bnh, S, 1), -1e30, dtype=f)
    l = torch.zeros((bnh, S, 1), dtype=f)
    acc = torch.zeros((bnh, S, hd), dtype=f)
    for k0 in range(0, S, TILE):
        # the kernel's last tile is padded with zero keys, masked to -inf
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        t = mm_tf32x3(q, kt.transpose(1, 2), terms) * sl2 \
            + bias[:, :, k0:k0 + TILE] * LOG2E
        m_new = torch.maximum(m, t.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm_tf32x3(p, vt, terms)
        m = m_new
    return acc / l, (m * math.log(2.0) + torch.log(l))[..., 0]


def _rel_err(got, want) -> float:
    want = torch.as_tensor(want).double()
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("bnh,g,hd", [(2, 16, 64), (1, 23, 32), (2, 64, 64)])
def test_split_tf32_within_fp32_tolerance_of_plain(bnh, g, hd):
    """[2,256,64], [1,529,32] (a ragged grid: the last tile holds 17 keys)
    and [2,4096,64] (SAM's grid): out and lse against
    flash_relpos_fwd_lse_plain."""
    ts = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    out, lse = _split_tf32_forward(*ts, scale, g)
    want, want_lse = cfa.flash_relpos_fwd_lse_plain(*ts, scale, g)
    assert out.dtype == lse.dtype == torch.float32
    assert out.shape == want.shape and lse.shape == want_lse.shape
    errs = (_rel_err(out, want), _rel_err(lse, want_lse))
    assert max(errs) <= FP32_TOL, errs


def test_one_tf32_product_does_not_hold_fp32():
    """[2,256,64]: hi hi alone (plain TF32) misses the fp32 tolerance by
    more than an order of magnitude, so the split is what holds it."""
    bnh, g, hd = 2, 16, 64
    ts = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    out, _ = _split_tf32_forward(*ts, scale, g, terms=1)
    want = cfa.flash_relpos_fwd_plain(*ts, scale, g)
    assert _rel_err(out, want) > 10 * FP32_TOL


def test_split_tf32_within_fp32_tolerance_of_jax():
    """[2,256,64]: out and lse against JAX's forward with lse
    (`_fwd_call(..., with_lse=True)`, its Pallas kernel in interpret mode),
    as the backward's emulation test runs it."""
    bnh, g, hd = 2, 16, 64
    ts = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    jo, jl = jfa._fwd_call(*[jnp.asarray(t.numpy()) for t in ts], scale, g,
                           with_lse=True)
    out, lse = _split_tf32_forward(*ts, scale, g)
    errs = (_rel_err(out, np.array(jo)), _rel_err(lse, np.array(jl)[..., 0]))
    assert max(errs) <= FP32_TOL, errs
