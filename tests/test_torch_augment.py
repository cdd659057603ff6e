"""Port parity: the on-device augmentation of cartseg_tpu_torch
(data/augment.py) against the JAX package.

The random streams cannot match (jax.random against torch.Generator),
so each op is held at JAX's own drawn parameters: the test rebuilds the
JAX draws from the key the way augment_batch makes them (augment.py:
288-289, :248, :359-363) and hands them to the port's `apply_augment`.
The marginals of the port's own draws are held by the KS pattern of
tests/test_augment_dist.py.

Tolerances (images on the 0..255 scale before normalisation, float32):
  * photometric ops and normalisation: atol 1e-3 (the same float ops);
  * the affine warp: atol 1e-2 on 99.9 % of the pixels (cos/sin of
    the drawn angle may differ by an ulp between frameworks, which can
    move a bilinear tap across a pixel edge where a coordinate lands on
    one) and masks equal on 99.9 %.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from cartseg_tpu.data import augment as JA

from cartseg_tpu_torch.data import augment as TA
from torch_port_helpers import one_torch_thread  # noqa: F401

B, H, W = 4, 40, 48
ALL_OFF = dict(hflip_p=0.0, rotate_p=0.0, scale_p=0.0,
               brightness_contrast_p=0.0, hsv_p=0.0, noise_p=0.0,
               motion_blur_p=0.0, shift_scale_rotate_p=0.0,
               color_jitter_p=0.0)


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    img = (60 + 2 * xx[..., None] + r.integers(0, 60, (B, H, W, 3))
           ).clip(0, 255).astype(np.uint8)
    m = np.zeros((B, H, W, 1), np.float32)
    for b in range(B):
        m[b, 8 + b:25 + b, 10:30 + 2 * b] = 1.0
    return img, m


def _jax_draws(key, cfg):
    """augment_batch's draws for `key`: U [17,B], u [9], noise."""
    kw, kps, kn = jax.random.split(key, 3)
    U = np.array(jax.random.uniform(kps, (17, B)))
    u = np.array(jax.random.uniform(kw, (9,)))
    kd = jax.random.key_data(kn)
    rk = jax.random.wrap_key_data(
        jnp.concatenate([kd, kd ^ jnp.uint32(0x9E3779B9)]), impl="rbg")
    noise = np.array(jax.random.normal(rk, (B, H, W, 3)))
    return U, u, noise


def _both(cfg_j, cfg_t, seed=3):
    img, m = _inputs()
    key = jax.random.key(seed)
    ji, jm = JA.augment_batch(key, jnp.asarray(img), jnp.asarray(m), cfg_j)
    U, u, noise = _jax_draws(key, cfg_j)
    ti, tm = TA.apply_augment(torch.from_numpy(img), torch.from_numpy(m),
                              cfg_t, torch.from_numpy(U),
                              torch.from_numpy(u), torch.from_numpy(noise))
    return (np.asarray(ji), np.asarray(jm)), (ti.numpy(), tm.numpy()), U


def _cfgs(**on):
    return (JA.AugmentConfig(**{**ALL_OFF, **on}),
            TA.AugmentConfig(**{**ALL_OFF, **on}))


@pytest.mark.parametrize("op", ["hflip", "brightness_contrast", "hsv",
                                "motion_blur", "noise", "color_jitter"])
def test_photometric_op_at_jax_draws(op):
    cj, ct = _cfgs(**{f"{op}_p": 0.6})
    gate_row = {"hflip": 0, "brightness_contrast": 1, "hsv": 4,
                "color_jitter": 8, "noise": 13, "motion_blur": 15}[op]
    # the first key whose draws leave some samples on and some off
    seed = next(k for k in range(3, 64) if 0 < (_jax_draws(
        jax.random.key(k), cj)[0][gate_row] < 0.6).sum() < B)
    (ji, jm), (ti, tm), U = _both(cj, ct, seed)
    np.testing.assert_allclose(ti, ji, atol=1e-3)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_shared_affine_warp_at_jax_draws(seed):
    cj, ct = _cfgs(rotate_p=1.0, scale_p=1.0, shift_scale_rotate_p=1.0)
    (ji, jm), (ti, tm), _ = _both(cj, ct, seed)
    close = np.abs(ti - ji) <= 1e-2
    assert close.mean() >= 0.999, np.abs(ti - ji).max()
    assert (tm == jm).mean() >= 0.999
    assert not np.allclose(ji, _inputs()[0])     # the warp moved pixels


def test_shared_affine_warp_reflect101_direct():
    """The warp function itself at fixed parameters, uint8 images and
    masks, with a rotation large enough to fold the border."""
    img, m = _inputs(seed=4)
    args = (30.0, 0.8, 3.0, -2.0)
    ji, jm = JA._shared_affine_warp(jnp.asarray(img), jnp.asarray(m),
                                    *[jnp.float32(a) for a in args])
    ti, tm = TA._shared_affine_warp(torch.from_numpy(img),
                                    torch.from_numpy(m),
                                    *[torch.tensor(a) for a in args])
    assert (np.abs(ti.numpy() - np.asarray(ji)) <= 1e-2).mean() >= 0.999
    assert (tm.numpy() == np.asarray(jm)).mean() >= 0.999
    assert ti.dtype == torch.float32 and tm.shape == (B, H, W, 1)


def test_full_train_512_pipeline_at_jax_draws():
    cfg = dict(mean=JA.IMAGENET_MEAN, std=JA.IMAGENET_STD,
               hflip_p=0.5, rotate_p=0.5, scale_p=0.5,
               brightness_contrast_p=0.5, hsv_p=0.5, noise_p=0.5,
               motion_blur_p=0.5)
    (ji, jm), (ti, tm), _ = _both(JA.AugmentConfig(**cfg),
                                  TA.AugmentConfig(**cfg), seed=11)
    # normalised units: 1e-2 on 0..255 is ~2e-4 here
    assert (np.abs(ti - ji) <= 2e-4).mean() >= 0.999
    assert (tm == jm).mean() >= 0.999


def test_hsv_round_trip_matches_jax():
    r = np.random.default_rng(6)
    rgb = r.random((5, 7, 3)).astype(np.float32)
    rgb[0, 0] = (0.5, 0.5, 0.5)            # gray: zero saturation
    rgb[0, 1] = 0.0                        # black
    jh, js, jv = JA._rgb_to_hsv(jnp.asarray(rgb))
    th, ts, tv = TA._rgb_to_hsv(torch.from_numpy(rgb))
    for a, b in ((th, jh), (ts, js), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    back = TA._hsv_to_rgb(th, ts, tv).numpy()
    np.testing.assert_allclose(back, np.asarray(JA._hsv_to_rgb(jh, js, jv)),
                               atol=1e-6)
    np.testing.assert_allclose(back, rgb, atol=1e-5)


def test_normalize_batch_matches_jax():
    img = np.random.default_rng(7).integers(0, 256, (2, 3, 4, 3)).astype(
        np.float32)
    want = JA.normalize_batch(jnp.asarray(img), JA.IMAGENET_MEAN,
                              JA.IMAGENET_STD)
    got = TA.normalize_batch(torch.from_numpy(img), TA.IMAGENET_MEAN,
                             TA.IMAGENET_STD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_augment_configs_equal_jax():
    for name in ("train_512", "train_224", "none"):
        for norm in (False, True):
            j = getattr(JA.AugmentConfig, name)(norm)
            t = getattr(TA.AugmentConfig, name)(norm)
            assert {k: tuple(v) if isinstance(v, tuple) else v
                    for k, v in vars(j).items()} == vars(t), name


# ------------------------------------------------------ distributions

def _check_mixture(vals, p, lo, hi, ident):
    """tests/test_augment_dist.py: vals ~ ident w.p. (1-p), else
    U(lo,hi): the application rate (binomial 4-sigma) and KS of the
    conditional uniform."""
    applied = vals[vals != ident]
    rate = len(applied) / len(vals)
    assert abs(rate - p) < 4 * np.sqrt(p * (1 - p) / len(vals))
    ks = stats.kstest(applied, stats.uniform(loc=lo, scale=hi - lo).cdf)
    assert ks.pvalue > 1e-3, ks


def _port_warp_draws(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((9, n), generator=g)
    return [t.numpy() for t in TA.draw_warp_params(u, cfg, 224, 224)]


def test_rotate_and_zoom_marginals_train_512():
    cfg = TA.AugmentConfig.train_512()
    a, s, _, _ = _port_warp_draws(cfg, 8000)
    _check_mixture(a, cfg.rotate_p, -20.0, 20.0, 0.0)
    _check_mixture(s, cfg.scale_p, 1.0 - 0.12, 1.0 + 0.12, 1.0)


def test_ssr_marginals_train_224():
    cfg = TA.AugmentConfig.train_224()
    a, s, ty, tx = _port_warp_draws(cfg, 8000, seed=2)
    _check_mixture(a, cfg.shift_scale_rotate_p, -5.0, 5.0, 0.0)
    _check_mixture(s, cfg.shift_scale_rotate_p, 0.88, 1.12, 1.0)
    _check_mixture(ty, cfg.shift_scale_rotate_p, -0.02 * 224, 0.02 * 224,
                   0.0)
    _check_mixture(tx, cfg.shift_scale_rotate_p, -0.02 * 224, 0.02 * 224,
                   0.0)


def test_per_sample_gates_of_augment_batch():
    """Flip and brightness/contrast gates drawn by the port's generator
    fire at their p, per sample."""
    cfg = TA.AugmentConfig(**{**ALL_OFF, "hflip_p": 0.5})
    g = torch.Generator().manual_seed(0)
    img = torch.zeros((64, 4, 6, 3), dtype=torch.uint8)
    img[..., 0, :] = 255                     # left column lit
    m = torch.zeros((64, 4, 6, 1))
    flips = []
    for _ in range(40):
        out, _ = TA.augment_batch(g, img, m, cfg)
        flips.append((out[:, 0, -1, 0] > 0.5).numpy())
    rate = np.concatenate(flips).mean()
    assert abs(rate - 0.5) < 4 * np.sqrt(0.25 / (64 * 40))
    # consecutive batches draw new gates
    assert not all(np.array_equal(flips[0], f) for f in flips[1:])


# ------------------------------------------------- per-sample warp

PER_SAMPLE = dict(rotate_p=1.0, scale_p=1.0, shift_scale_rotate_p=1.0,
                  per_sample_warp=True)


def _jax_draws_per_sample(key):
    """augment_batch's draws with per_sample_warp: U [17,B], u [9,B]."""
    kw, kps, _ = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(kps, (17, B))),
            np.array(jax.random.uniform(kw, (9, B))))


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_per_sample_warp_at_jax_draws(seed):
    """JAX's own per-sample draws for a key (u now [9,B]) through the
    port's apply_augment, against JAX's augment_batch with
    per_sample_warp, at the shared warp's tolerance."""
    cj, ct = _cfgs(**PER_SAMPLE)
    img, m = _inputs()
    key = jax.random.key(seed)
    ji, jm = JA.augment_batch(key, jnp.asarray(img), jnp.asarray(m), cj)
    U, u = _jax_draws_per_sample(key)
    ti, tm = TA.apply_augment(torch.from_numpy(img), torch.from_numpy(m),
                              ct, torch.from_numpy(U), torch.from_numpy(u),
                              None)
    ti, tm, ji, jm = ti.numpy(), tm.numpy(), np.asarray(ji), np.asarray(jm)
    assert (np.abs(ti - ji) <= 1e-2).mean() >= 0.999, np.abs(ti - ji).max()
    assert (tm == jm).mean() >= 0.999
    # the rows were warped differently
    angles = TA.draw_warp_params(torch.from_numpy(u), ct, H, W)[0].numpy()
    assert len(np.unique(angles)) == B


def test_per_sample_affine_warp_direct():
    """The warp alone at fixed [B] parameters against JAX's
    `_per_sample_affine_warp` (as the shared warp's direct test), and
    each row equal to the shared warp of that row alone."""
    img, m = _inputs(seed=4)
    params = [np.array(v, np.float32) for v in (
        (30.0, -12.0, 5.0, 0.0), (0.8, 1.1, 0.95, 1.0),
        (3.0, 0.0, -1.5, 2.0), (-2.0, 1.0, 0.0, 4.0))]
    ji, jm = JA._per_sample_affine_warp(jnp.asarray(img), jnp.asarray(m),
                                        *[jnp.asarray(p) for p in params])
    tp = [torch.from_numpy(p) for p in params]
    ti, tm = TA._per_sample_affine_warp(torch.from_numpy(img),
                                        torch.from_numpy(m), *tp)
    assert (np.abs(ti.numpy() - np.asarray(ji)) <= 1e-2).mean() >= 0.999
    assert (tm.numpy() == np.asarray(jm)).mean() >= 0.999
    assert ti.dtype == torch.float32 and tm.shape == (B, H, W, 1)
    for b in range(B):
        si, sm = TA._shared_affine_warp(torch.from_numpy(img[b:b + 1]),
                                        torch.from_numpy(m[b:b + 1]),
                                        *[p[b] for p in tp])
        assert torch.equal(ti[b:b + 1], si) and torch.equal(tm[b:b + 1], sm)


def _port_per_sample_draws(cfg, batch, n, seed=0):
    """n batches of the port's per-sample warp parameters, as
    augment_batch draws them (draw_augment's u [9,B])."""
    g = torch.Generator().manual_seed(seed)
    out = [[] for _ in range(4)]
    for _ in range(n):
        _, u, _ = TA.draw_augment(g, batch, 224, 224, cfg, "cpu")
        assert u.shape == (9, batch)
        for acc, t in zip(out, TA.draw_warp_params(u, cfg, 224, 224)):
            acc.append(t.numpy())
    return [np.stack(v) for v in out]


def test_per_sample_marginals_and_independence():
    """tests/test_augment_dist.py's checks on the port's per-sample
    draws: the Rotate / zoom / ShiftScaleRotate mixtures at their p and
    limits, distinct values within a batch, lag-1 autocorrelation ~ 0."""
    cfg = dataclasses.replace(TA.AugmentConfig.train_512(),
                              per_sample_warp=True)
    a, s, _, _ = _port_per_sample_draws(cfg, 8, 1000)
    _check_mixture(a.ravel(), cfg.rotate_p, -20.0, 20.0, 0.0)
    _check_mixture(s.ravel(), cfg.scale_p, 0.88, 1.12, 1.0)
    cfg224 = dataclasses.replace(TA.AugmentConfig.train_224(),
                                 per_sample_warp=True)
    a, s, ty, tx = _port_per_sample_draws(cfg224, 8, 250, seed=2)
    _check_mixture(a.ravel(), 0.2, -5.0, 5.0, 0.0)
    _check_mixture(s.ravel(), 0.2, 0.88, 1.12, 1.0)
    _check_mixture(ty.ravel(), 0.2, -0.02 * 224, 0.02 * 224, 0.0)
    _check_mixture(tx.ravel(), 0.2, -0.02 * 224, 0.02 * 224, 0.0)
    a = _port_per_sample_draws(cfg, 64, 1, seed=3)[0][0]
    applied = a[a != 0.0]
    assert len(np.unique(applied)) == len(applied) > 10
    r = np.corrcoef(applied[:-1], applied[1:])[0, 1]
    assert abs(r) < 0.35


def test_per_sample_warp_differs_across_batch():
    """tests/test_data.py's check: identical inputs come out different
    with per_sample_warp and identical without it."""
    img = torch.zeros((4, 32, 32, 3), dtype=torch.uint8)
    img[:, 8:24, 8:24] = 255
    m = torch.zeros((4, 32, 32, 1))
    m[:, 8:24, 8:24] = 1.0
    off = {**ALL_OFF, "rotate_p": 1.0, "rotate_limit": 30.0}
    for per_sample in (True, False):
        cfg = TA.AugmentConfig(**off, per_sample_warp=per_sample)
        _, om = TA.augment_batch(torch.Generator().manual_seed(5), img, m,
                                 cfg)
        om = om.numpy()
        assert set(np.unique(om)) <= {0.0, 1.0}
        same = all(np.array_equal(om[0], om[b]) for b in range(1, 4))
        assert same != per_sample


def test_per_sample_warp_ranks_take_their_rows():
    """Under data parallelism each rank draws at the global batch and
    keeps its rows: two ranks' halves equal the one-process batch."""
    cfg = TA.AugmentConfig(**{**ALL_OFF, **PER_SAMPLE, "hflip_p": 0.5,
                              "noise_p": 0.5})
    img, m = (torch.from_numpy(a) for a in _inputs(seed=8))
    whole = TA.augment_batch(torch.Generator().manual_seed(9), img, m, cfg)
    for rows in (slice(0, 2), slice(2, 4)):
        part = TA.augment_batch(torch.Generator().manual_seed(9), img[rows],
                                m[rows], cfg, rows=rows, batch=B)
        assert torch.equal(part[0], whole[0][rows])
        assert torch.equal(part[1], whole[1][rows])
