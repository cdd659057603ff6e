"""The rounding points of the bfloat16 flash-attention forward kernel
(cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_fwd_tc.cu), emulated in
plain PyTorch on the CPU, against the port's plain forward, float64 and
JAX's.

The tensor-core kernel runs only on the card (tests/test_torch_kernels_
cuda.py holds it against the plain version there). What it does to the
numbers can be checked here: `_tensor_core_forward` below repeats its
arithmetic at the points where it rounds. The logits are fp32 (bf16
inputs, products summed in fp32); per 64-key tile the running max m_t
takes the tile's row max, P_t = exp(logits - m_t) is rounded to bf16
once, as the A operand of P V, whose sums stay fp32; l sums the fp32 P;
O and l are rescaled by exp(m_t - m_final); the output O / l is rounded
to bf16 once and lse = m_final + log(l). The plain version
(`flash_relpos_fwd_plain`) and JAX's forward keep P in fp32 and round
only the output.

Tolerance: the output's max abs difference over the reference's max
|value|, within 1e-2 (FLASH_TOL[bf16] in chip_smoke.py): bf16 keeps 8
significant bits, so the rounding of P moves each term of P V by up to
2^-9 relative, and the output's own rounding adds up to 2^-9 of a
value. The emulation measured at most 7.7e-3 of max |plain| at these
inputs (3.9e-3 of max |float64|, where the plain version is 3.7e-3).
The lse within 1e-5 absolute of the plain logsumexp: both are fp32 sums of the
same fp32 exps in another order (about 1e-6 at these inputs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.ops.pallas import flash_attention as jfa
from cartseg_tpu_torch.ops.cuda import flash_attention as cfa
from torch_port_helpers import one_torch_thread  # noqa: F401

BF16_TOL = 1e-2
LSE_TOL = 1e-5
TILE = 64


def _inputs(bnh, g, hd, seed=0):
    """The card tests' recipe, drawn with numpy: q, k, v ~ N(0,1), the rel
    factors 0.5 N(0,1), all rounded to bf16."""
    r = np.random.default_rng(seed)
    S = g * g
    arrs = [r.standard_normal((bnh, S, hd)).astype(np.float32)
            for _ in range(3)]
    arrs += [0.5 * r.standard_normal((bnh, S, g)).astype(np.float32)
             for _ in range(2)]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


def _tensor_core_forward(q, k, v, rel_h, rel_w, scale: float,
                         grid_size: int):
    """(out bf16, lse fp32) with the kernel's rounding points."""
    f = torch.float32
    logits = cfa._logits_plain(q, k, rel_h, rel_w, scale)
    bnh, S, _ = logits.shape
    nt = -(-S // TILE)
    pad = nt * TILE - S
    x = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    x = x.reshape(bnh, S, nt, TILE)
    # the running max after each tile, from -1e30 as the kernel
    m = torch.cummax(x.amax(-1).clamp_min(-1e30), dim=-1).values
    p = torch.exp(x - m[..., None])                    # fp32, per tile
    scale_t = torch.exp(m - m[..., -1:])               # rescale to m_final
    l = (p.sum(-1) * scale_t).sum(-1)
    p16 = p.to(torch.bfloat16).to(f) * scale_t[..., None]
    vp = torch.nn.functional.pad(v.to(f), (0, 0, 0, pad))
    o = p16.reshape(bnh, S, nt * TILE) @ vp
    return (o / l[..., None]).to(q.dtype), m[..., -1] + torch.log(l)


def _reference64(q, k, v, rel_h, rel_w, scale: float):
    d = torch.float64
    bnh, S, _ = q.shape
    bias = (rel_h.to(d)[:, :, :, None] + rel_w.to(d)[:, :, None, :]).reshape(
        bnh, S, S)
    p = torch.softmax(q.to(d) @ k.to(d).transpose(1, 2) * scale + bias, -1)
    return p @ v.to(d)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("bnh,g,hd", [(2, 16, 64), (1, 23, 32), (2, 64, 64)])
def test_rounding_points_within_bf16_tolerance(bnh, g, hd):
    """[2,256,64], [1,529,32] (a ragged last tile) and [2,4096,64] (SAM's
    g = 64): the emulation against flash_relpos_fwd_plain and float64,
    and its lse against flash_relpos_fwd_lse_plain's."""
    ts = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    out, lse = _tensor_core_forward(*ts, scale, g)
    plain, lse_plain = cfa.flash_relpos_fwd_lse_plain(*ts, scale, g)
    assert out.dtype == plain.dtype == torch.bfloat16
    assert out.shape == plain.shape and lse.shape == lse_plain.shape
    assert _rel(out, plain) <= BF16_TOL
    assert float((lse - lse_plain).abs().max()) <= LSE_TOL
    ref = _reference64(*ts, scale)
    # the rounding of P costs about as much as the output's own rounding
    assert _rel(out, ref) <= BF16_TOL
    assert _rel(plain, ref) <= BF16_TOL


def test_rounding_points_within_bf16_tolerance_of_jax():
    """[2,256,64]: the emulation against JAX's flash forward in bf16 (its
    Pallas kernel in interpret mode), output and lse."""
    bnh, g, hd = 2, 16, 64
    ts = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    jin = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]
    jo, jl = jfa._fwd_call(*jin, scale, g, with_lse=True)
    out, lse = _tensor_core_forward(*ts, scale, g)
    assert _rel(out, np.array(jo.astype(jnp.float32))) <= BF16_TOL
    assert float((lse - torch.from_numpy(np.array(jl)[..., 0])).abs().max()
                 ) <= LSE_TOL
