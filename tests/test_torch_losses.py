"""Port parity: the losses of the ABL training path (losses/region.py,
losses/label_smooth.py, losses/abl.py of cartseg_tpu_torch) against the
JAX package on the CPU, forward and gradient w.r.t. the logits.

Tolerances (float32 on the CPU, the same numpy inputs to both):
  * region losses and LSR CE: rtol 1e-5 on values, atol 1e-6 on
    gradients (the sums run in another order per framework);
  * `lsr_ce` (plain route) against `lsr_ce_pallas` in interpret mode:
    atol 1e-5 forward, 1e-6 gradient;
  * ABL boundaries, distance maps and n_valid: exact (integer labels,
    the bit-equal EDT, one closed-form eps); loss rtol 1e-5 and
    gradients atol 1e-7 (they are ~1e-4 in size).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.losses import abl as JA
from cartseg_tpu.losses import label_smooth as JLS
from cartseg_tpu.losses import region as JR
from cartseg_tpu.ops.pallas import lsr_ce_pallas

from cartseg_tpu_torch.losses import abl as TA
from cartseg_tpu_torch.losses import label_smooth as TLS
from cartseg_tpu_torch.losses import region as TR
from torch_port_helpers import one_torch_thread  # noqa: F401


def _masks(rng, b, h, w, empty=()):
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((b, h, w, 1), np.float32)
    for i in range(b):
        if i in empty:
            continue
        for _ in range(2):
            cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(
                w // 4, 3 * w // 4)
            r = rng.integers(4, max(5, min(h, w) // 4))
            m[i, ..., 0] = np.maximum(m[i, ..., 0],
                                      (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r)
    return m


def _logits(rng, m, noise=2.0, signal=1.5):
    return (rng.normal(size=m.shape) * noise
            + (m * 2 - 1) * signal).astype(np.float32)


def _torch_value_and_grad(fn, x):
    t = torch.from_numpy(x).requires_grad_(True)
    out = fn(t)
    val = out[0] if isinstance(out, tuple) else out
    val.backward()
    if isinstance(out, tuple):
        return (out[0].detach(), {k: v.detach() for k, v in out[1].items()}
                ), t.grad.numpy()
    return out.detach(), t.grad.numpy()


# ------------------------------------------------------------ region

@pytest.mark.parametrize("bce_weight", [0.5, 0.3])
def test_bce_dice_loss_and_grad_match_jax(bce_weight):
    r = np.random.default_rng(0)
    m = _masks(r, 2, 24, 32)
    x = _logits(r, m)
    jv, jg = jax.value_and_grad(lambda l: JR.bce_dice_loss(
        l, jnp.asarray(m), bce_weight=bce_weight))(jnp.asarray(x))
    tv, tg = _torch_value_and_grad(lambda l: TR.bce_dice_loss(
        l, torch.from_numpy(m), bce_weight=bce_weight), x)
    assert float(tv) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("name", ["bce_dice_per_sample", "focal_dice_loss",
                                  "bce_with_logits"])
def test_other_region_losses_match_jax(name):
    r = np.random.default_rng(1)
    m = _masks(r, 3, 16, 20)
    x = _logits(r, m)

    def jf(l):
        return jnp.sum(getattr(JR, name)(l, jnp.asarray(m)))

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(x))
    tv, tg = _torch_value_and_grad(
        lambda l: getattr(TR, name)(l, torch.from_numpy(m)).sum(), x)
    assert float(tv) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(tg, np.asarray(jg), atol=1e-6)


# ------------------------------------------------------- label smooth

def _lsr_inputs(C, seed=2, shape=(3, 5, 7)):
    r = np.random.default_rng(seed)
    x = (r.normal(size=shape + (C,)) * 3).astype(np.float32)
    lab = r.integers(0, C, shape).astype(np.int32)
    lab[0, :2] = 255
    g = r.normal(size=shape).astype(np.float32)
    return x, lab, g


@pytest.mark.parametrize("ignore", [255, -100])
def test_smooth_one_hot_matches_jax(ignore):
    _, lab, _ = _lsr_inputs(8)
    lab = np.where(lab == 255, ignore, lab)
    want = np.asarray(JLS.smooth_one_hot(jnp.asarray(lab), 8, 0.2, ignore))
    got = TLS.smooth_one_hot(torch.from_numpy(lab), 8, 0.2, ignore)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_lsr_cross_entropy_matches_jax(reduction):
    x, lab, g = _lsr_inputs(8)

    def jf(l):
        out = JLS.lsr_cross_entropy(l, jnp.asarray(lab), 0.2, reduction, 255)
        return jnp.sum(out * (g if reduction == "none" else 1.0)), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    out = TLS.lsr_cross_entropy(t, torch.from_numpy(lab).long(), 0.2,
                                reduction, 255)
    (out * (torch.from_numpy(g) if reduction == "none" else 1.0)).sum() \
        .backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("C", [8, 2])
def test_lsr_ce_plain_route_matches_pallas_interpret(C):
    x, lab, g = _lsr_inputs(C, seed=C)
    jout, vjp = jax.vjp(lambda l: lsr_ce_pallas(l, jnp.asarray(lab), 0.2,
                                                255), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    out = TLS.lsr_ce(t, torch.from_numpy(lab).long(), 0.2, 255)
    out.backward(torch.from_numpy(g))
    assert out.shape == lab.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-6)
    assert np.all(out.detach().numpy()[lab == 255] == 0)
    assert np.all(t.grad.numpy()[lab == 255] == 0)


def test_lsr_ce_equals_autograd_of_v1_math():
    x, lab, g = _lsr_inputs(8, seed=9)
    lt = torch.from_numpy(lab).long()
    a = torch.from_numpy(x).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    fa = TLS.lsr_ce(a, lt, 0.2, 255)
    fb = TLS.lsr_cross_entropy(b, lt, 0.2, "none", 255)
    (fa * torch.from_numpy(g)).sum().backward()
    (fb * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(fa.detach().numpy(), fb.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6)


# -------------------------------------------------------------- ABL

# One shape for every ABL case: JAX compiles each eager op of its
# vmapped EDT once per shape, and that compile is the cost of this file.
ABL_SHAPE = (3, 48, 48)
CASES = {  # name: (samples without foreground, seed)
    "one_empty": ((2,), 0),
    "seed1": ((), 1),
    "seed2": ((), 2),
}


@pytest.fixture(scope="module")
def abl_runs():
    """Each case through JAX once: bce_dice_abl's value, components and
    gradient, and the ABL pieces."""
    out = {}
    for name, (empty, seed) in CASES.items():
        r = np.random.default_rng(seed)
        m = _masks(r, *ABL_SHAPE, empty)
        # noise 1: larger logits saturate the neighbour KL, and a
        # saturated batch has no KL above the adaptive eps
        x = _logits(r, m, noise=1.0)
        (jt, jc), jg = jax.value_and_grad(
            lambda l: JA.bce_dice_abl(l, jnp.asarray(m)), has_aux=True)(
            jnp.asarray(x))
        tgt = (m[..., 0] > 0.5).astype(np.int32)
        jl, jn = JA.active_boundary_loss(jnp.asarray(x), jnp.asarray(tgt))
        pf = jax.nn.sigmoid(jnp.asarray(x[..., 0]))
        jb = JA.gt2boundary(jnp.asarray(tgt))
        out[name] = dict(
            m=m, x=x, tgt=tgt, total=float(jt),
            comps={k: float(v) for k, v in jc.items()}, grad=np.asarray(jg),
            loss=float(jl), n_valid=int(jn), gt_bound=np.asarray(jb),
            dist=np.asarray(JA.gt_dist_maps(jb)),
            pred_bound=np.asarray(JA.logits2boundary(
                jnp.stack([1 - pf, pf], -1))))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_abl_boundaries_and_distance_maps_match_jax(abl_runs, case):
    j = abl_runs[case]
    tgt = torch.from_numpy(j["tgt"])
    gb = TA.gt2boundary(tgt)
    np.testing.assert_array_equal(gb.numpy(), j["gt_bound"])
    np.testing.assert_array_equal(TA.gt_dist_maps(gb).numpy(), j["dist"])
    pf = torch.sigmoid(torch.from_numpy(j["x"][..., 0]))
    pb = TA.logits2boundary(torch.stack([1 - pf, pf], -1))
    np.testing.assert_array_equal(pb.numpy(), j["pred_bound"])
    assert j["pred_bound"].any()


@pytest.mark.parametrize("case", list(CASES))
def test_active_boundary_loss_matches_jax(abl_runs, case):
    j = abl_runs[case]
    loss, n_valid = TA.active_boundary_loss(torch.from_numpy(j["x"]),
                                            torch.from_numpy(j["tgt"]))
    assert int(n_valid) == j["n_valid"] > 0
    assert float(loss) == pytest.approx(j["loss"], rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_bce_dice_abl_and_grad_match_jax(abl_runs, case):
    j = abl_runs[case]
    (total, comps), grad = _torch_value_and_grad(
        lambda l: TA.bce_dice_abl(l, torch.from_numpy(j["m"])), j["x"])
    assert float(total) == pytest.approx(j["total"], rel=1e-5)
    for k, v in j["comps"].items():
        assert float(comps[k]) == pytest.approx(v, rel=1e-5, abs=1e-7)
    assert j["comps"]["boundary_used"] == 1.0
    np.testing.assert_allclose(grad, j["grad"], atol=1e-7)
    assert np.abs(j["grad"]).max() > 1e-5


def test_abl_empty_boundary_skip_matches_jax():
    """Flat logits: no KL edge exceeds eps, n_valid is 0 and the
    composite drops the boundary term (the reference's None)."""
    x = np.zeros(ABL_SHAPE + (1,), np.float32)
    m = _masks(np.random.default_rng(3), *ABL_SHAPE)
    tgt = (m[..., 0] > 0.5).astype(np.int32)
    jl, jn = JA.active_boundary_loss(jnp.asarray(x), jnp.asarray(tgt))
    tl, tn = TA.active_boundary_loss(torch.from_numpy(x),
                                     torch.from_numpy(tgt))
    assert int(jn) == int(tn) == 0
    total, comps = TA.bce_dice_abl(torch.from_numpy(x), torch.from_numpy(m))
    assert float(comps["boundary_used"]) == 0.0
    assert float(comps["boundary"]) == 0.0
    assert float(total) == pytest.approx(float(comps["region"]), abs=0)


def test_abl_top_k_budget_is_whole_batch():
    """The eps budget is one image's area counted over the WHOLE batch
    (abl.py:73-94): a sample's predicted boundary depends on the other
    samples. Duplicating a sample halves its share, and JAX agrees."""
    r = np.random.default_rng(4)
    m = _masks(r, 1, 48, 48)
    x1 = _logits(r, m, noise=1.0)
    x2 = np.concatenate([x1, x1])

    def jb(x):
        pf = jax.nn.sigmoid(jnp.asarray(x[..., 0]))
        return np.asarray(JA.logits2boundary(jnp.stack([1 - pf, pf], -1)))

    def tb(x):
        pf = torch.sigmoid(torch.from_numpy(x[..., 0]))
        return TA.logits2boundary(torch.stack([1 - pf, pf], -1)).numpy()

    one, two = tb(x1), tb(x2)
    np.testing.assert_array_equal(one, jb(x1))
    np.testing.assert_array_equal(two, jb(x2))
    assert 0 < two[0].sum() < one[0].sum()
    np.testing.assert_array_equal(two[0], two[1])
