"""Two of the port's kernels emulated on the CPU in their own form and
order of operations: the focal loss (ops/cuda/csrc/focal.cu) and the
soft-Dice sums (ops/cuda/csrc/soft_dice.cu).

The focal kernel's form: one exp an element, e = exp(-|x|), r = 1 /
(1 + e), p = r where x >= 0 and e r below, log p = -log1p(e) or
x - log1p(e); the exponent's route (`route`: gamma 2 as a a and a,
gamma 1 as a and 1, any other gamma by pow). Held against `focal_plain`
and the JAX package's Pallas kernel (`focal_pallas`, interpret mode on
the CPU) at gamma 2, 1, 1.5 and 3 on 3 N(0,1) logits with the loss zoo's
edge rows and x in {+-30, +-1e-3, 0, -100}: rtol 1e-5, atol 1e-6, as
tests/test_torch_loss_zoo.py holds the plain version against JAX (the
frameworks' exp and log1p differ by ulps, and p moves by an ulp where
x < 0). log p is bit for bit the two-branch form's; at y == p the loss
is an exact zero on every route, and the gradient too where gamma > 1
(at gamma 1, |y - p|^0 = 1 leaves d_coeff p (1 - p) in both).

The soft-Dice kernel's one-launch schedule: `plan`'s P CTAs a sample,
CTA q summing its range [q L, (q + 1) L) (thread t the loads at
q L + t V + k 256 V, in k order, fma(2p, y, sn) and sd + (p^pexp + y)),
shuffles and then the warps in order into its partial, and the last
CTA's fold of the P partials (thread t the partials t, t + 256, ... in
order, then shuffles and the warps in order). Held within 1e-6 relative
a sample (chip_smoke.py's DICE_TOL for the kernel: fp32 sums of
non-negative terms in another order) against `soft_dice_sums_plain`,
its loss within 1e-6 against `soft_dice_pallas`, and run twice for the
same bits.

Both plans: every element of [0, n) (focal) or of a sample (soft-Dice)
read exactly once over the walk above, for B in {1, 6, 300}, ragged n and
M, M < 4, and the unaligned route.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.ops.pallas import focal_pallas, soft_dice_pallas

from cartseg_tpu_torch.ops.cuda import focal as FO
from cartseg_tpu_torch.ops.cuda import soft_dice as SD
from cartseg_tpu_torch.ops.cuda.focal import focal_plain, route
from cartseg_tpu_torch.ops.cuda.soft_dice import soft_dice_sums_plain
from torch_port_helpers import one_torch_thread  # noqa: F401

THREADS = 256
WARPS = THREADS // 32
RTOL, ATOL = 1e-5, 1e-6
DICE_TOL = 1e-6
GAMMAS = (2.0, 1.0, 1.5, 3.0)


# ------------------------------------------------------------------ focal

def focal_kernel_form(x: torch.Tensor, y: torch.Tensor, gamma: float,
                      alpha: float):
    """csrc/focal.cu `focal<route(gamma)>`, op for op in float32."""
    g = route(gamma)
    e = torch.exp(-x.abs())
    r = 1.0 / (1.0 + e)
    lg = torch.log1p(e)
    pos = x >= 0
    prob = torch.where(pos, r, e * r)
    log_p = torch.where(pos, -lg, x - lg)
    ce = y * alpha * log_p + (1.0 - y) * (1.0 - alpha) * (log_p - x)
    a = (y - prob).abs()
    if g == 2:
        ag, ag1 = a * a, a
    elif g == 1:
        ag, ag1 = a, torch.ones_like(a)
    else:
        ag, ag1 = a ** gamma, a ** (gamma - 1.0)
    coeff = -ag
    loss = coeff * ce
    d_ce = y * alpha - prob * (1.0 - y - alpha + 2.0 * y * alpha)
    d_coeff = gamma * ag1 * prob * (1.0 - prob)
    d_coeff = torch.where(y < prob, -d_coeff, d_coeff)
    return loss, d_coeff * ce + coeff * d_ce, log_p


# the loss zoo's edge rows (y == p at x = 0, y = 0.5 and at x = 30, y = 1
# first), then x in {+-30, +-1e-3, 0, -100} against both labels
EDGES = ([(0.0, 0.5), (30.0, 1.0), (-30.0, 0.0), (-30.0, 1.0), (0.0, 1.0),
          (-1e-8, 0.0), (20.0, 0.0)]
         + [(x, y) for x in (30.0, -30.0, 1e-3, -1e-3, 0.0, -100.0)
            for y in (0.0, 1.0)])


def _focal_inputs(seed=0):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(2, 8, 8, 1)) * 3).astype(np.float32)
    y = (r.random((2, 8, 8, 1)) > 0.5).astype(np.float32)
    xf, yf = x.reshape(-1), y.reshape(-1)
    for k, (xv, yv) in enumerate(EDGES):
        xf[k], yf[k] = xv, yv
    return x, y


def test_focal_routes():
    assert [route(g) for g in (2.0, 2, 1.0, 1, 1.5, 3.0, 0.0, 2.5)] == \
        [2, 2, 1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("gamma", GAMMAS)
def test_focal_kernel_form_matches_plain_and_jax(gamma):
    alpha = 0.25
    x, y = _focal_inputs()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    loss, grad, log_p = focal_kernel_form(xt, yt, gamma, alpha)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    two_branch = torch.where(xt >= 0, -torch.log1p(torch.exp(-xt)),
                             xt - torch.log1p(torch.exp(xt)))
    assert torch.equal(log_p, two_branch)
    p_loss, p_grad = focal_plain(xt, yt, gamma, alpha)
    np.testing.assert_allclose(loss, p_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad, p_grad, rtol=RTOL, atol=ATOL)
    j_loss, pull = jax.vjp(lambda v: focal_pallas(v, jnp.asarray(y), gamma,
                                                  alpha), jnp.asarray(x))
    j_grad = pull(jnp.ones_like(j_loss))[0]
    np.testing.assert_allclose(loss, np.asarray(j_loss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(grad, np.asarray(j_grad), rtol=RTOL,
                               atol=ATOL)
    # y == p: x = 0, y = 0.5 and x = 30, y = 1 (p rounds to 1)
    lf, gf = loss.view(-1), grad.view(-1)
    assert float(lf[0]) == 0.0 and float(lf[1]) == 0.0
    if gamma > 1.0:
        assert float(gf[0]) == 0.0 and float(gf[1]) == 0.0
    else:
        assert float(gf[0]) == float(p_grad.view(-1)[0]) != 0.0


def _walk(j0: int, j1: int, V: int, loads: int) -> torch.Tensor:
    """[threads, steps, V] element offsets a CTA's threads read for the
    range [j0, j1), in each thread's order (the rounds of `loads` loads in
    k order, then the load's V elements); -1 past j1."""
    step = THREADS * V
    steps = max(0, -(-(j1 - j0) // step))
    steps = -(-steps // loads) * loads
    idx = (j0 + torch.arange(THREADS)[:, None, None] * V
           + step * torch.arange(steps)[None, :, None]
           + torch.arange(V)[None, None, :])
    return torch.where(idx < j1, idx, -1)


def _focal_hits(n: int, p) -> torch.Tensor:
    loads = FO.UNROLL if p.vec == 4 else 4 * FO.UNROLL
    idx = torch.cat([_walk(b * p.L, min(n, (b + 1) * p.L), p.vec,
                           loads).reshape(-1) for b in range(p.ctas)])
    return torch.bincount(idx[idx >= 0], minlength=n)


@pytest.mark.parametrize("n", [1, 3, 5, 4096, 4097, 70001, 1003520,
                               1572864])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [132, 4])
def test_focal_plan_reads_every_element_once(n, aligned, sms):
    p = FO.plan(n, aligned, sms)
    assert p.vec == (4 if aligned else 1)
    assert p.L % 4 == 0 and (p.ctas - 1) * p.L < n <= p.ctas * p.L
    assert p.ctas <= sms * FO.BLOCKS_PER_SM
    hits = _focal_hits(n, p)
    assert hits.shape == (n,) and bool((hits == 1).all())


def test_focal_plan_fills_one_wave_at_most():
    """A CTA takes at least one round of UNROLL loads a thread, and the
    grid at most one wave; past that, equal ranges of one wave."""
    for n in (1003520, 6 * 512 * 512, 64 * 512 * 512):
        p = FO.plan(n, True)
        rounds = -(-n // (THREADS * 4 * FO.UNROLL))
        assert p.ctas == min(rounds, FO.SMS * FO.BLOCKS_PER_SM)
        assert p.L >= THREADS * 4 * FO.UNROLL
        assert p.L - -(-n // p.ctas) < 4


# -------------------------------------------------------------- soft-Dice

def _fma(x: torch.Tensor, y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fmaf(x, y, s) in fp32: the product of two fp32 values is exact in
    float64, so one float64 add and one rounding to fp32 (ties of that
    double rounding aside, far rarer than the tolerance needs)."""
    return (x.double() * y.double() + s.double()).float()


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """[..., 32] -> [...]: __shfl_down_sync at 16, 8, 4, 2, 1, lane 0."""
    n = 32
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def _block_sum(t: torch.Tensor) -> torch.Tensor:
    """[..., 256] thread values -> the warps' shuffles, then the warps in
    order (thread 0)."""
    w = _warp_sum(t.reshape(*t.shape[:-1], WARPS, 32))
    s = torch.zeros(t.shape[:-1], dtype=torch.float32)
    for k in range(WARPS):
        s = s + w[..., k]
    return s


def schedule_soft_dice(x: torch.Tensor, y: torch.Tensor, pexp: float, p):
    """csrc/soft_dice.cu on plan p: x, y [B, M] fp32 -> (numer, denor)."""
    Bn, M = x.shape
    loads = SD.UNROLL if p.vec == 4 else 4 * SD.UNROLL
    # [P, threads, steps, V] offsets of each CTA's threads, -1 past its
    # range
    walks = [_walk(q * p.L, min(M, (q + 1) * p.L), p.vec, loads)
             for q in range(p.P)]
    steps = max(w.shape[1] for w in walks)
    idx = torch.stack([torch.nn.functional.pad(
        w, (0, 0, 0, steps - w.shape[1]), value=-1) for w in walks])
    ok = idx >= 0
    safe = idx.clamp(min=0)
    xs = x[:, safe]                                 # [B, P, 256, steps, V]
    ys = y[:, safe]
    prob = 1.0 / (1.0 + torch.exp(-xs))
    pp = (prob if pexp == 1.0 else prob * prob if pexp == 2.0
          else prob ** pexp)
    sn = torch.zeros(xs.shape[:3], dtype=torch.float32)
    sd = torch.zeros_like(sn)
    for s in range(steps):
        for v in range(p.vec):
            keep = ok[..., s, v]
            sn = torch.where(keep, _fma(2.0 * prob[..., s, v],
                                        ys[..., s, v], sn), sn)
            sd = torch.where(keep, sd + (pp[..., s, v] + ys[..., s, v]), sd)
    part = (_block_sum(sn), _block_sum(sd))          # [B, P] each
    out = []
    for t in part:
        lanes = torch.zeros((Bn, THREADS), dtype=torch.float32)
        for q0 in range(0, p.P, THREADS):
            chunk = t[:, q0:q0 + THREADS]
            lanes[:, :chunk.shape[1]] = lanes[:, :chunk.shape[1]] + chunk
        out.append(_block_sum(lanes))
    return out[0], out[1]


def _dice_inputs(Bn, M, seed):
    r = np.random.default_rng(seed)
    m = (r.random((Bn, M)) > 0.6).astype(np.float32)
    m[0] = 0.0                               # a sample without foreground
    x = (r.standard_normal((Bn, M)) * 2 + (2 * m - 1) * 1.5
         ).astype(np.float32)
    return x, m


def _dice_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert bool(((g - w).abs() <= DICE_TOL * w.abs()).all()), \
            float(((g - w).abs() / w.abs().clamp(min=1e-30)).max())


@pytest.mark.parametrize("pexp", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("Bn,M,aligned,sms", [
    (6, 512 * 512, True, 132),      # the path shape: 64 CTAs a sample
    (3, 20001, True, 132),          # M % 4 != 0: one element a load
    (2, 40000, False, 132),         # unaligned: one element a load
    (1, 100003, True, 1),           # one SM: ranges of many rounds
    (300, 1001, True, 132)])        # more samples than a wave: P = 1
def test_soft_dice_schedule_matches_plain_and_jax_twice(Bn, M, aligned,
                                                        sms, pexp):
    x, y = _dice_inputs(Bn, M, seed=M)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    p = SD.plan(Bn, M, aligned, sms)
    got = schedule_soft_dice(xt, yt, pexp, p)
    _dice_close(got, soft_dice_sums_plain(xt, yt, pexp))
    assert float(got[0][0]) == 0.0
    again = schedule_soft_dice(xt, yt, pexp, p)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    if Bn <= 6:
        loss = 1.0 - (got[0] + 1.0) / (got[1] + 1.0)
        want = np.asarray(soft_dice_pallas(jnp.asarray(x), jnp.asarray(y),
                                           pexp, 1.0))
        np.testing.assert_allclose(loss.numpy(), want, rtol=DICE_TOL,
                                   atol=DICE_TOL)


def _dice_hits(M: int, p) -> torch.Tensor:
    loads = SD.UNROLL if p.vec == 4 else 4 * SD.UNROLL
    idx = torch.cat([_walk(q * p.L, min(M, (q + 1) * p.L), p.vec,
                           loads).reshape(-1) for q in range(p.P)])
    return torch.bincount(idx[idx >= 0], minlength=M)


@pytest.mark.parametrize("M", [1, 3, 4, 5, 1001, 4096, 4097, 262144,
                               262147])
@pytest.mark.parametrize("Bn", [1, 6, 300, 65535])
@pytest.mark.parametrize("aligned", [True, False])
def test_soft_dice_plan_reads_every_element_once(Bn, M, aligned):
    p = SD.plan(Bn, M, aligned, 132)
    assert p.vec == (4 if aligned and M % 4 == 0 else 1)
    assert p.L % 4 == 0 and (p.P - 1) * p.L < M <= p.P * p.L
    assert Bn * p.P <= max(Bn, 132 * SD.BLOCKS_PER_SM)
    hits = _dice_hits(M, p)
    assert hits.shape == (M,) and bool((hits == 1).all())


def test_soft_dice_schedule_counts_on_ones():
    """Logits of 30 (p rounds to 1) and labels of 1: every element adds 2
    to both sums, exactly, over a plan of many CTAs a sample."""
    x = torch.full((2, 70001), 30.0)
    y = torch.ones((2, 70001))
    p = SD.plan(2, 70001, True, 1)
    assert p.P > 1 and p.vec == 1
    numer, denor = schedule_soft_dice(x, y, 2.0, p)
    assert torch.equal(numer, torch.full((2,), 140002.0))
    assert torch.equal(denor, numer)
