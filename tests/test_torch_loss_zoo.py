"""Port parity: the loss zoo of cartseg_tpu_torch.losses against the JAX
package on the CPU, value and gradient, at small sizes. The same numpy
inputs, made from a seed, go to both.

Where the JAX package has a Pallas kernel (focal, soft-Dice, the
smoothed one-hot, mish/swish/hswish), the port's CPU lane (the kernel's
plain version) is held against both JAX lanes: the XLA form the
package's public function takes off the TPU, and the Pallas kernel in
interpret mode, as tests/test_pallas_kernels.py runs it.

Tolerances (float32 on the CPU):
  * elementwise losses and activations, and their gradients: rtol 1e-5,
    atol 1e-6 (the frameworks' exp/log1p/tanh differ by ulps, and the
    XLA forms write softplus and the log sigmoid in other forms than
    the Pallas kernels the port follows);
  * hswish: bit-equal to the Pallas lane, which the interpreter jits:
    under jit XLA compiles the division by 6 as a multiplication by
    float32(1/6), as the port does (and as PyTorch's CUDA division by a
    Python number does); within two float32 ulps (rtol 2^-22) of the
    eager XLA lane, which divides;
  * reductions (soft-Dice, LSR, Taylor, large-margin, Lovász, LayerNorm):
    rtol 1e-5 on values, atol 1e-6 on gradients (sums in another order);
  * the smoothed one-hot: bit-equal to the Pallas lane; within one
    float32 ulp of the XLA lane, whose `oh * (pos - neg) + neg` rounds
    lb_pos once more;
  * ohem_labels: bit-equal, ties included (both sorts are stable).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cartseg_tpu.losses as JL
from cartseg_tpu.ops.pallas import (focal_pallas, hswish_pallas,
                                    mish_pallas, smooth_one_hot_pallas,
                                    soft_dice_pallas, swish_pallas)

import cartseg_tpu_torch.losses as TL
from torch_port_helpers import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _vjp_jax(fn, x, g):
    """fn(x) and the vector-Jacobian product with g, as numpy."""
    out, pull = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(pull(jnp.asarray(g))[0])


def _vjp_torch(fn, x, g):
    t = torch.from_numpy(x).requires_grad_(True)
    out = fn(t)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), t.grad.numpy()


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ------------------------------------------------------------ focal

def _focal_inputs(seed=0):
    """[2,8,8,1] logits ~ 3 N(0,1) and {0,1} targets, with edge rows:
    y == p at x = 0, y = 0.5 and at x = 30, y = 1 (p rounds to 1); a
    large negative logit; both signs at the log-sigmoid branch."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(2, 8, 8, 1)) * 3).astype(np.float32)
    y = (r.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    edges = [(0.0, 0.5), (30.0, 1.0), (-30.0, 0.0), (-30.0, 1.0),
             (0.0, 1.0), (-1e-8, 0.0), (20.0, 0.0)]
    for k, (xv, yv) in enumerate(edges):
        x[0, 0, k, 0], y[0, 0, k, 0] = xv, yv
    g = r.normal(size=x.shape).astype(np.float32)
    return x, y, g


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.5)])
@pytest.mark.parametrize("lane", ["xla", "pallas"])
def test_focal_loss_kernel_matches_jax(gamma, alpha, lane):
    x, y, g = _focal_inputs()
    jy = jnp.asarray(y)
    jfn = (JL.focal_loss_kernel if lane == "xla" else focal_pallas)
    jv, jg = _vjp_jax(lambda v: jfn(v, jy, gamma, alpha), x, g)
    tv, tg = _vjp_torch(lambda v: TL.focal_loss_kernel(
        v, torch.from_numpy(y), gamma, alpha), x, g)
    assert np.isfinite(tv).all() and np.isfinite(tg).all()
    _close(tv, jv)
    _close(tg, jg)


def test_focal_loss_kernel_at_y_equal_p():
    """At x = 0, y = 0.5 (p == y) the loss and gradient are exactly 0."""
    x = torch.zeros((1, 1, 1, 1), requires_grad=True)
    loss = TL.focal_loss_kernel(x, torch.full((1, 1, 1, 1), 0.5))
    loss.sum().backward()
    assert float(loss.detach()) == 0.0 and float(x.grad) == 0.0


def test_focal_loss_kernel_grad_keeps_the_logits_dtype():
    x = torch.randn((2, 4, 4, 1)).to(torch.bfloat16).requires_grad_(True)
    loss = TL.focal_loss_kernel(x, (torch.rand((2, 4, 4, 1)) > 0.5).float())
    loss.sum().backward()
    assert loss.dtype == torch.float32 and x.grad.dtype == torch.bfloat16


# ------------------------------------------------------------ soft-Dice

def _dice_inputs(seed=1):
    """[3,8,8,1] logits and {0,1} labels; sample 2 has no foreground."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(3, 8, 8, 1)) * 2).astype(np.float32)
    y = (r.random((3, 8, 8, 1)) > 0.6).astype(np.float32)
    y[2] = 0.0
    g = r.normal(size=(3,)).astype(np.float32)
    return x, y, g


@pytest.mark.parametrize("p", [1.0, 2.0])
@pytest.mark.parametrize("lane", ["xla", "pallas"])
def test_soft_dice_loss_matches_jax(p, lane):
    x, y, g = _dice_inputs()
    jy = jnp.asarray(y)
    jfn = JL.soft_dice_loss if lane == "xla" else soft_dice_pallas
    jv, jg = _vjp_jax(lambda v: jfn(v, jy, p, 1.0), x, g)
    tv, tg = _vjp_torch(lambda v: TL.soft_dice_loss(
        v, torch.from_numpy(y), p, 1.0), x, g)
    assert tv.shape == (3,)
    _close(tv, jv)
    _close(tg, jg)


# ------------------------------------------------------------ activations

def _act_inputs(shape, seed=2):
    """5 N(0,1) values with hswish's breakpoints (exactly -3 and 3, and
    their float32 neighbours), mish's softplus guard at 20 and its
    neighbours, and large magnitudes, in the first row."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=shape) * 5).astype(np.float32)
    edges = np.array([-3.0, 3.0, np.nextafter(-3.0, 0, dtype=np.float32),
                      np.nextafter(-3.0, -4, dtype=np.float32),
                      np.nextafter(3.0, 0, dtype=np.float32),
                      np.nextafter(3.0, 4, dtype=np.float32), 20.0,
                      np.nextafter(20.0, 0, dtype=np.float32),
                      np.nextafter(20.0, 21, dtype=np.float32), 0.0,
                      -20.0, 25.0, -100.0, 100.0], np.float32)
    x.reshape(-1)[:edges.size] = edges
    return x, r.normal(size=shape).astype(np.float32)


_PALLAS = {"mish": mish_pallas, "swish": swish_pallas, "hswish": hswish_pallas}


@pytest.mark.parametrize("shape", [(4, 37), (8, 128)])
@pytest.mark.parametrize("lane", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["mish", "swish", "hswish"])
def test_activations_match_jax(kind, lane, shape):
    x, g = _act_inputs(shape)
    jfn = getattr(JL, kind) if lane == "xla" else _PALLAS[kind]
    jv, jg = _vjp_jax(jfn, x, g)
    tv, tg = _vjp_torch(getattr(TL, kind), x, g)
    if kind == "hswish" and lane == "pallas":
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tg, jg)
    elif kind == "hswish":
        _close(tv, jv, rtol=2.0 ** -22, atol=0)
        _close(tg, jg, rtol=2.0 ** -22, atol=0)
    else:
        _close(tv, jv)
        _close(tg, jg)


@pytest.mark.parametrize("kind", ["mish", "swish", "hswish"])
def test_activations_compute_in_fp32_and_keep_the_dtype(kind):
    x32, g32 = _act_inputs((4, 16))
    x = torch.from_numpy(x32).to(torch.bfloat16).requires_grad_(True)
    y = getattr(TL, kind)(x)
    y.backward(torch.from_numpy(g32).to(torch.bfloat16))
    assert y.dtype == x.grad.dtype == torch.bfloat16
    xf = x.detach().float().requires_grad_(True)
    yf = getattr(TL, kind)(xf)
    yf.backward(torch.from_numpy(g32).to(torch.bfloat16).float())
    assert torch.equal(y, yf.to(torch.bfloat16))
    assert torch.equal(x.grad, xf.grad.to(torch.bfloat16))


# ------------------------------------------------------------ one-hot

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("C,lb_smooth,ignore", [(8, 0.2, 255), (8, 0.1, -100),
                                                (5, 0.3, 255), (19, 0.05, 255)])
def test_smooth_one_hot_matches_both_jax_lanes(dtype, C, lb_smooth, ignore):
    r = np.random.default_rng(3)
    lab = r.integers(0, C, (3, 7, 5)).astype(dtype)
    lab[0, :2] = ignore
    got = TL.smooth_one_hot(torch.from_numpy(lab), C, lb_smooth,
                            ignore).numpy()
    pallas = np.asarray(smooth_one_hot_pallas(jnp.asarray(lab), C,
                                              lb_smooth, ignore))
    xla = np.asarray(JL.smooth_one_hot(jnp.asarray(lab), C, lb_smooth,
                                       ignore))
    assert got.dtype == np.float32 and got.shape == lab.shape + (C,)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_allclose(got, xla, rtol=2.0 ** -23, atol=0)
    assert (got[0, :2] == 0).all()


# ------------------------------------------------------------ LSR, fused

def _cls_inputs(C=8, seed=4, ignore=255):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(2, 6, 5, C)) * 3).astype(np.float32)
    lab = r.integers(0, C, (2, 6, 5)).astype(np.int64)
    lab[0, :2] = ignore
    return x, lab, r.normal(size=(2, 6, 5)).astype(np.float32)


@pytest.mark.parametrize("lb_smooth", [0.1, 0.2])
def test_lsr_cross_entropy_fused_matches_jax(lb_smooth):
    x, lab, g = _cls_inputs()
    jl = jnp.asarray(lab)
    jv, jg = _vjp_jax(lambda v: JL.lsr_cross_entropy_fused(
        v, jl, lb_smooth, 255), x, g)
    tv, tg = _vjp_torch(lambda v: TL.lsr_cross_entropy_fused(
        v, torch.from_numpy(lab), lb_smooth, 255), x, g)
    _close(tv, jv)
    _close(tg, jg)


# ------------------------------------------------------------ Taylor

@pytest.mark.parametrize("n", [2, 4])
def test_taylor_softmax_matches_jax(n):
    x, _, _ = _cls_inputs(C=5)
    _close(TL.taylor_softmax(torch.from_numpy(x), n).numpy(),
           np.asarray(JL.taylor_softmax(jnp.asarray(x), n)))
    _close(TL.log_taylor_softmax(torch.from_numpy(x), n).numpy(),
           np.asarray(JL.log_taylor_softmax(jnp.asarray(x), n)))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("lb_smooth", [0.0, 0.1])
def test_taylor_cross_entropy_matches_jax(lb_smooth, reduction):
    x, lab, g = _cls_inputs(C=5, ignore=-100)
    if reduction != "none":
        g = np.asarray(g.sum(), np.float32)
    jl = jnp.asarray(lab)
    jv, jg = _vjp_jax(lambda v: JL.taylor_cross_entropy(
        v, jl, 2, lb_smooth, -100, reduction), x, g)
    tv, tg = _vjp_torch(lambda v: TL.taylor_cross_entropy(
        v, torch.from_numpy(lab), 2, lb_smooth, -100, reduction), x, g)
    _close(tv, jv)
    _close(tg, jg)


# ------------------------------------------------------------ OHEM

@pytest.mark.parametrize("thresh,n_min", [(0.7, 4), (0.3, 16), (0.5, 0),
                                          (0.7, 1000)])
def test_ohem_labels_bit_equal_with_ties(thresh, n_min):
    """Rows 0-5 repeat one logit row and rows 6-9 another, with one label
    each: tied scores, ranked by position in both frameworks."""
    r = np.random.default_rng(5)
    x = (r.normal(size=(2, 8, 6, 4)) * 2).astype(np.float32)
    lab = r.integers(0, 4, (2, 8, 6)).astype(np.int64)
    flat_x, flat_l = x.reshape(-1, 4), lab.reshape(-1)
    flat_x[1:6], flat_l[1:6] = flat_x[0], flat_l[0]
    flat_x[7:10], flat_l[7:10] = flat_x[6], flat_l[6]
    flat_l[20:24] = 255
    want = np.asarray(JL.ohem_labels(jnp.asarray(x), jnp.asarray(lab),
                                     thresh, n_min, 255))
    got = TL.ohem_labels(torch.from_numpy(x), torch.from_numpy(lab),
                         thresh, n_min, 255)
    assert got.dtype == torch.int64 and got.shape == lab.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ Lovász

def _lovasz_inputs(ties: bool, seed=6):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(2, 6, 7, 3)) * 2).astype(np.float32)
    lab = r.integers(0, 3, (2, 6, 7)).astype(np.int64)
    lab[1, 0, :3] = -100
    if ties:   # equal probabilities: errors tied between fg and bg pixels
        x[0, :3] = 0.0
    return x, lab


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("classes,per_image", [("present", True),
                                               ("all", True),
                                               ("present", False)])
def test_lovasz_softmax_matches_jax(classes, per_image, ties):
    x, lab = _lovasz_inputs(ties)
    g = np.asarray(0.7, np.float32)
    jl = jnp.asarray(lab)
    jv, jg = _vjp_jax(lambda v: JL.lovasz_softmax(
        v, jl, classes, per_image, -100), x, g)
    tv, tg = _vjp_torch(lambda v: TL.lovasz_softmax(
        v, torch.from_numpy(lab), classes, per_image, -100), x, g)
    _close(tv, jv)
    _close(tg, jg)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("per_image", [True, False])
def test_lovasz_hinge_matches_jax(per_image, ties):
    r = np.random.default_rng(7)
    x = (r.normal(size=(3, 6, 7)) * 2).astype(np.float32)
    lab = (r.random((3, 6, 7)) > 0.5).astype(np.int64)
    lab[2, 0, :4] = 255
    if ties:   # zero logits: every error is 1
        x[0] = 0.0
    g = np.asarray(1.3, np.float32)
    jl = jnp.asarray(lab)
    jv, jg = _vjp_jax(lambda v: JL.lovasz_hinge(v, jl, per_image, 255), x, g)
    tv, tg = _vjp_torch(lambda v: TL.lovasz_hinge(
        v, torch.from_numpy(lab), per_image, 255), x, g)
    _close(tv, jv)
    _close(tg, jg)


# ------------------------------------------------------------ large margin

@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_large_margin_softmax_matches_jax(reduction):
    x, lab, g = _cls_inputs(C=6, ignore=-100)
    if reduction != "none":
        g = np.asarray(g.sum(), np.float32)
    jl = jnp.asarray(lab)
    jv, jg = _vjp_jax(lambda v: JL.large_margin_softmax(
        v, jl, 0.3, -100, reduction), x, g)
    tv, tg = _vjp_torch(lambda v: TL.large_margin_softmax(
        v, torch.from_numpy(lab), 0.3, -100, reduction), x, g)
    _close(tv, jv)
    _close(tg, jg)


# ------------------------------------------------------------ LayerNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """Value and the gradients of x, weight and bias; in bfloat16 the
    output and dx round once to bf16 on both sides (atol one bf16 step
    of the values, 2^-8 * max |.|)."""
    r = np.random.default_rng(8)
    x = (r.normal(size=(3, 5, 16)) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * r.normal(size=16)).astype(np.float32)
    b = (0.1 * r.normal(size=16)).astype(np.float32)
    g = r.normal(size=x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, pull = jax.vjp(lambda a, c, d: JL.layer_norm(a, c, d, 1e-5),
                        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    jgrads = pull(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tout = TL.layer_norm(tx, tw, tb, 1e-5)
    tout.backward(torch.from_numpy(g).to(tdt))
    assert tout.dtype == tdt and tx.grad.dtype == tdt
    pairs = [(tout, out)] + list(zip((tx.grad, tw.grad, tb.grad), jgrads))
    for k, (t, j) in enumerate(pairs):
        t = t.detach().float().numpy()
        j = np.asarray(j, np.float32)
        if dtype == "float32":
            _close(t, j, atol=1e-5 if k == 0 else ATOL)
        else:
            np.testing.assert_allclose(t, j, rtol=0,
                                       atol=2.0 ** -8 * np.abs(j).max())


# ------------------------------------------------------------ the API

def test_the_port_exports_every_name_of_the_jax_loss_zoo():
    """Every name, with the JAX function's parameter names and defaults."""
    missing = set(JL.__all__) - set(TL.__all__)
    assert not missing, sorted(missing)
    for name in JL.__all__:
        want, got = (inspect.signature(getattr(m, name)).parameters
                     for m in (JL, TL))
        assert [(p.name, p.default) for p in got.values()] == \
            [(p.name, p.default) for p in want.values()], name
