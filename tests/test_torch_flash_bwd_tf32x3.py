"""The split-TF32 arithmetic of the float32 flash-attention backward
kernels (cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd.cu,
`flash_bwd_dq_tf32x3` and `flash_bwd_dkv_tf32x3`), emulated in plain
PyTorch on the CPU, against the port's plain backward and JAX's.

The kernels run only on the card (tests/test_torch_kernels_cuda.py holds
them against the plain version there). What they do to the numbers can be
checked here: `_split_tf32_numerics` below repeats their arithmetic. Each
fp32 operand x of a product is cut into hi = tf32(x) and lo = tf32(x - hi),
both rounded to nearest with ties away from zero (`tf32` of
tests/torch_port_helpers.py: the int32 view plus 0x1000, the low 13 bits
cleared, as the kernels do), and each product
is hi lo + lo hi, then + hi hi, summed in fp32 (the products of two TF32
values are exact in fp32). P = exp2(scale log2(e) s + bias log2(e) -
lse log2(e)) and dS = P (dP - D) stay fp32, as do drel_h and drel_w,
summed from the fp32 dS. The plain version (`flash_relpos_bwd_plain`) and
JAX's backward take full fp32 products.

Tolerance: each gradient's max abs difference over the reference's max
|value|, within 1e-5: the fp32 route's own bound against the plain version
(FLASH_BWD_TOL[float32] in chip_smoke.py), not loosened for the tensor
cores. hi + lo holds an operand to ~2^-22 of it and the dropped lo lo term
is ~2^-22 of a product, so the split products sit near fp32's own 2^-24.
The emulation measured at most 1.9e-6 against the plain version (dq at
[1,529,32]; 1.1e-6 at [2,256,64], 1.9e-6 at [2,4096,64]) and 1.1e-6
against JAX at [2,256,64]: 5x inside the tolerance. A single TF32 product
(hi hi alone) lands 3.5e-4 to 1.9e-3 away at the same inputs, which
`test_one_tf32_product_does_not_hold_fp32` pins, so the tolerance does
tell the two apart.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.ops.pallas import flash_attention as jfa
from cartseg_tpu_torch.ops.cuda import flash_attention as cfa
from torch_port_helpers import (  # noqa: F401
    mm_tf32x3, one_torch_thread, split_tf32, tf32)

FP32_TOL = 1e-5
NAMES = ("dq", "dk", "dv", "drel_h", "drel_w")
LOG2E = math.log2(math.e)


def _inputs(bnh, g, hd, seed=0):
    """The card tests' recipe, drawn with numpy: q, k, v ~ N(0,1), the rel
    factors 0.5 N(0,1), dO ~ N(0,1), fp32."""
    r = np.random.default_rng(seed)
    S = g * g
    arrs = [r.standard_normal((bnh, S, hd)).astype(np.float32)
            for _ in range(3)]
    arrs += [0.5 * r.standard_normal((bnh, S, g)).astype(np.float32)
             for _ in range(2)]
    do = r.standard_normal((bnh, S, hd)).astype(np.float32)
    return [torch.from_numpy(a) for a in arrs], torch.from_numpy(do)


def _split_tf32_numerics(q, k, v, rel_h, rel_w, o, lse, do, scale: float,
                         grid_size: int, terms: int = 3):
    """(dq, dk, dv, drel_h, drel_w) with the kernels' arithmetic."""
    f = torch.float32
    bnh, S, _ = q.shape
    g = int(grid_size)
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(bnh, S, S)
    sl2 = torch.tensor(scale * LOG2E, dtype=f)
    s = mm_tf32x3(q, k.transpose(1, 2), terms)
    p = torch.exp2(s * sl2 + (bias * LOG2E - lse[..., None] * LOG2E))
    delta = cfa.row_delta(o, do)
    ds = p * (mm_tf32x3(do, v.transpose(1, 2), terms) - delta[..., None])
    dq = mm_tf32x3(ds, k, terms) * scale
    dk = mm_tf32x3(ds.transpose(1, 2), q, terms) * scale
    dv = mm_tf32x3(p.transpose(1, 2), do, terms)
    ds4 = ds.reshape(bnh, S, g, g)
    return dq, dk, dv, ds4.sum(-1), ds4.sum(-2)


def _rel_errs(got, want) -> dict:
    return {name: float((a.double() - torch.as_tensor(b).double()).abs()
                        .max() / torch.as_tensor(b).double().abs().max())
            for name, a, b in zip(NAMES, got, want)}


def test_tf32_rounding_is_to_nearest_ties_away():
    """The bit trick against exact rounding of the 23-bit mantissa to 10
    bits: to nearest, halfway cases away from zero, carries into the
    exponent; lo, itself a TF32, holds the rest to 2^-22 of x."""
    man = np.array([0, 0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x3000, 0x7FF000,
                    0x7FFFFF], np.int64)
    for sign in (0, 1):
        bits = (sign << 31) | (127 << 23) | man
        x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
        got = tf32(x).view(torch.int32).numpy().astype(np.int64) \
            & 0xFFFFFFFF
        kept = (man + 0x1000) >> 13 << 13
        want = (sign << 31) | ((127 << 23) + kept)
        assert np.array_equal(got, want), (sign, got, want)
        hi, lo = split_tf32(x)
        err = (hi.double() + lo.double() - x.double()).abs()
        assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
        assert not (lo.view(torch.int32) & 0x1FFF).any()


@pytest.mark.parametrize("bnh,g,hd", [(2, 16, 64), (1, 23, 32), (2, 64, 64)])
def test_split_tf32_within_fp32_tolerance_of_plain(bnh, g, hd):
    """[2,256,64], [1,529,32] (a ragged grid) and [2,4096,64] (SAM's grid):
    the emulation against flash_relpos_bwd_plain on the plain forward's
    output and lse."""
    ts, do = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    o, lse = cfa.flash_relpos_fwd_lse_plain(*ts, scale, g)
    got = _split_tf32_numerics(*ts, o, lse, do, scale, g)
    want = cfa.flash_relpos_bwd_plain(*ts, o, lse, do, scale, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
    errs = _rel_errs(got, want)
    assert max(errs.values()) <= FP32_TOL, errs


def test_one_tf32_product_does_not_hold_fp32():
    """[2,256,64]: hi hi alone (plain TF32) misses the fp32 tolerance by
    more than an order of magnitude (1.9e-3 measured), so the split is
    what holds it."""
    bnh, g, hd = 2, 16, 64
    ts, do = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    o, lse = cfa.flash_relpos_fwd_lse_plain(*ts, scale, g)
    got = _split_tf32_numerics(*ts, o, lse, do, scale, g, terms=1)
    want = cfa.flash_relpos_bwd_plain(*ts, o, lse, do, scale, g)
    assert max(_rel_errs(got, want).values()) > 10 * FP32_TOL


def test_split_tf32_within_fp32_tolerance_of_jax_vjp():
    """[2,256,64]: the emulation against jax.vjp of flash_attention_relpos
    in fp32 (its Pallas backward kernels in interpret mode), on JAX's own
    forward output and lse."""
    bnh, g, hd = 2, 16, 64
    ts, do = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    jin = [jnp.asarray(t.numpy()) for t in ts]
    jo, jl = jfa._fwd_call(*jin, scale, g, with_lse=True)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention_relpos(
        *a, scale=scale, grid_size=g), *jin)
    want = [np.array(x) for x in vjp(jnp.asarray(do.numpy()))]
    o = torch.from_numpy(np.array(jo))
    lse = torch.from_numpy(np.array(jl)[..., 0])
    got = _split_tf32_numerics(*ts, o, lse, do, scale, g)
    errs = _rel_errs(got, want)
    assert max(errs.values()) <= FP32_TOL, errs
