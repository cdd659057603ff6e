"""The rounding points of the bfloat16 flash-attention backward kernels
(cartseg_tpu_torch/ops/cuda/csrc/flash_relpos_bwd_tc.cu), emulated in
plain PyTorch on the CPU, against the port's plain backward and JAX's.

The tensor-core kernels run only on the card (tests/test_torch_kernels_
cuda.py holds them against the plain version there). What they do to the
numbers can be checked here: `_tensor_core_numerics` below repeats their
arithmetic at the points where it rounds. P and dS are fp32, from bf16
inputs whose products are summed in fp32; P and dS are rounded to bf16
once each, as the A operands of dS K, P^T dO and dS^T Q, whose sums stay
fp32; drel_h and drel_w are summed from the fp32 dS; each output is
rounded once to bf16. The plain version (`flash_relpos_bwd_plain`) and
JAX's bf16 backward keep P and dS in fp32 and round only the outputs.

Tolerance: each gradient's max abs difference over the reference's max
|value|, within 1e-2. That is the kernels' own bf16 bound against the
plain version (FLASH_BWD_TOL in chip_smoke.py): bf16 keeps 8 significant
bits, so one rounding of P and dS moves a product's terms by up to 2^-9
relative, and the outputs' own rounding adds up to 2^-9 of a value. The
emulation measured at most 5.4e-3 at these inputs. Against JAX the
emulation takes JAX's own forward output and lse, so the two differ only
where the emulation rounds and JAX does not, plus fp32 summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.ops.pallas import flash_attention as jfa
from cartseg_tpu_torch.ops.cuda import flash_attention as cfa
from torch_port_helpers import one_torch_thread  # noqa: F401

BF16_TOL = 1e-2
NAMES = ("dq", "dk", "dv", "drel_h", "drel_w")


def _inputs(bnh, g, hd, seed=0):
    """The card tests' recipe, drawn with numpy: q, k, v ~ N(0,1), the rel
    factors 0.5 N(0,1), dO ~ N(0,1), all rounded to bf16."""
    r = np.random.default_rng(seed)
    S = g * g
    arrs = [r.standard_normal((bnh, S, hd)).astype(np.float32)
            for _ in range(3)]
    arrs += [0.5 * r.standard_normal((bnh, S, g)).astype(np.float32)
             for _ in range(2)]
    do = r.standard_normal((bnh, S, hd)).astype(np.float32)
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            torch.from_numpy(do).to(torch.bfloat16))


def _tensor_core_numerics(q, k, v, rel_h, rel_w, o, lse, do, scale: float,
                          grid_size: int):
    """(dq, dk, dv, drel_h, drel_w) with the kernels' rounding points."""
    f = torch.float32
    bnh, S, _ = q.shape
    g = int(grid_size)
    bias = (rel_h.to(f)[:, :, :, None] + rel_w.to(f)[:, :, None, :]).reshape(
        bnh, S, S)
    p = torch.exp((q.to(f) @ k.to(f).transpose(1, 2)) * scale + bias
                  - lse[..., None])
    delta = (do.to(f) * o.to(f)).sum(-1)
    ds = p * (do.to(f) @ v.to(f).transpose(1, 2) - delta[..., None])
    p16, ds16 = (t.to(torch.bfloat16).to(f) for t in (p, ds))
    dq = (ds16 @ k.to(f)) * scale
    dk = (ds16.transpose(1, 2) @ q.to(f)) * scale
    dv = p16.transpose(1, 2) @ do.to(f)
    ds4 = ds.reshape(bnh, S, g, g)
    return tuple(t.to(torch.bfloat16)
                 for t in (dq, dk, dv, ds4.sum(-1), ds4.sum(-2)))


def _rel_errs(got, want) -> dict:
    return {name: float((a.float() - torch.as_tensor(b).float()).abs().max()
                        / torch.as_tensor(b).float().abs().max())
            for name, a, b in zip(NAMES, got, want)}


@pytest.mark.parametrize("bnh,g,hd", [(2, 16, 64), (1, 23, 32)])
def test_rounding_points_within_bf16_tolerance_of_plain(bnh, g, hd):
    """[2,256,64] and [1,529,32] (a ragged grid): the emulation against
    flash_relpos_bwd_plain on the plain forward's output and lse."""
    ts, do = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    o, lse = cfa.flash_relpos_fwd_lse_plain(*ts, scale, g)
    got = _tensor_core_numerics(*ts, o, lse, do, scale, g)
    want = cfa.flash_relpos_bwd_plain(*ts, o, lse, do, scale, g)
    for name, a, b in zip(NAMES, got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
    errs = _rel_errs(got, want)
    assert max(errs.values()) <= BF16_TOL, errs
    # drel is summed from the fp32 dS on both sides, in the same order
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


def test_rounding_points_within_bf16_tolerance_of_jax_vjp():
    """[2,256,64]: the emulation against jax.vjp of flash_attention_relpos
    in bf16 (its Pallas backward kernels in interpret mode), on JAX's own
    forward output and lse."""
    bnh, g, hd = 2, 16, 64
    ts, do = _inputs(bnh, g, hd)
    scale = hd ** -0.5
    jin = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in ts]
    jo, jl = jfa._fwd_call(*jin, scale, g, with_lse=True)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention_relpos(
        *a, scale=scale, grid_size=g), *jin)
    want = [np.array(x.astype(jnp.float32))
            for x in vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))]
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    lse = torch.from_numpy(np.array(jl)[..., 0])
    got = _tensor_core_numerics(*ts, o, lse, do, scale, g)
    errs = _rel_errs(got, want)
    assert max(errs.values()) <= BF16_TOL, errs
