"""Port parity: the jump-flood EDT of cartseg_tpu_torch (ops/edt.py, the
plain version of ops/cuda/edt.py on the CPU) against the JAX package.

Tolerance: none against the XLA lane (`edt`, `jax.vmap(edt)`): the
port computes the same integers in the same candidate order, so the
maps are compared bit for bit. Against the Pallas kernel in interpret
mode, the JAX suite's own atol=1e-4 (tests/test_edt_ops.py): that lane
fills with a far coordinate instead of skipping, which the JAX package
holds equal only within that tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.ops.edt import distance_transform_edt as jdte
from cartseg_tpu.ops.edt import edt as jedt
from cartseg_tpu.ops.pallas.edt import edt_batch_pallas

from cartseg_tpu_torch.ops.cuda.cc import _shift_fill
from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, jfa_steps
from cartseg_tpu_torch.ops.edt import distance_transform_edt, edt, edt_batch
from cartseg_tpu_torch.utils.synthetic import blob_masks
from torch_port_helpers import one_torch_thread  # noqa: F401


KINDS = ("random", "dense", "none", "single", "all", "blob_edges",
         "jfa_order")


def _seeds(kind, shape, seed=0):
    r = np.random.default_rng(seed)
    if kind == "random":
        return r.random(shape) < 0.01
    if kind == "dense":
        return r.random(shape) < 0.3
    if kind == "none":
        return np.zeros(shape, bool)
    if kind == "single":
        s = np.zeros(shape, bool)
        s[..., shape[-2] // 3, shape[-1] // 4] = True
        return s
    if kind == "all":
        return np.ones(shape, bool)
    if kind == "blob_edges":
        m = blob_masks(r, shape, n=3)
        edge = np.zeros_like(m)
        edge[:, :-1] |= m[:, :-1] != m[:, 1:]
        edge[:, :, :-1] |= m[:, :, :-1] != m[:, :, 1:]
        return edge
    if kind == "jfa_order":
        # an input where the step-start JFA differs from 1+JFA as JAX
        # writes it (test_candidates_apply_one_after_another)
        return np.random.default_rng(12).random(shape) < 0.01
    raise ValueError(kind)


def _jax_batch(seeds):
    """The JAX XLA lane, eager (an XLA compile of the 80 unrolled
    candidates takes longer than running them)."""
    return np.asarray(jax.vmap(jedt)(jnp.asarray(seeds)))


@pytest.fixture(scope="module")
def kinds_batch():
    """Every kind at 48x64 in one batch, through JAX once."""
    s = np.concatenate([_seeds(k, (1, 48, 64)) for k in KINDS])
    return s, _jax_batch(s)


@pytest.mark.parametrize("kind", KINDS)
def test_edt_batch_bit_equal_to_jax(kinds_batch, kind):
    s, want = kinds_batch
    i = KINDS.index(kind)
    got = edt_batch(torch.from_numpy(s[i:i + 1]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want[i:i + 1])


@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 1, 1), (2, 1, 77),
                                   (1, 33, 20)])
def test_edt_odd_and_non_square_sizes(shape):
    s = _seeds("random", shape, seed=3)
    s[0, 0, 0] = True
    np.testing.assert_array_equal(edt_batch(torch.from_numpy(s)).numpy(),
                                  _jax_batch(s))


def test_edt_single_image_and_no_seed_sentinel(kinds_batch):
    s, want = kinds_batch
    i = KINDS.index("blob_edges")
    np.testing.assert_array_equal(edt(torch.from_numpy(s[i])).numpy(),
                                  want[i])
    empty = edt(torch.zeros((8, 9), dtype=torch.bool))
    # sqrt(float32(1e12)) rounds to exactly 1e6, in both frameworks
    assert torch.all(empty == 1e6)
    assert np.all(want[KINDS.index("none")] == 1e6)


def test_edt_matches_pallas_interpret_lane(kinds_batch):
    s = kinds_batch[0][[KINDS.index(k)
                        for k in ("random", "blob_edges", "none")]]
    want = np.asarray(edt_batch_pallas(jnp.asarray(s)))
    np.testing.assert_allclose(edt_batch(torch.from_numpy(s)).numpy(), want,
                               atol=1e-4)


def test_distance_transform_edt_matches_jax():
    m = ~_seeds("blob_edges", (1, 40, 24), seed=2)[0]
    np.testing.assert_array_equal(
        distance_transform_edt(torch.from_numpy(m)).numpy(),
        np.asarray(jdte(jnp.asarray(m))))
    # no zero pixel: all zeros (the JAX guard, edt.py:115-117)
    ones = torch.ones((5, 6), dtype=torch.bool)
    assert torch.equal(distance_transform_edt(ones), torch.zeros((5, 6)))


def _textbook_jfa(seeds: np.ndarray) -> np.ndarray:
    """JFA that compares all 8 candidates of a step against the state at
    the START of the step: a different function from 1+JFA as the JAX
    package writes it (ops/edt.py:48-67)."""
    s = torch.from_numpy(seeds)
    _, H, W = s.shape
    ys = torch.arange(H)[:, None].expand(H, W)
    xs = torch.arange(W)[None].expand(H, W)
    by, bx = torch.where(s, ys, 0), torch.where(s, xs, 0)
    d2 = torch.where(s, 0.0, 1e12)
    for k in jfa_steps(H, W):
        sby, sbx, sd2 = by, bx, d2
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cby, cbx = _shift_fill(sby, dy, dx, 0), _shift_fill(
                    sbx, dy, dx, 0)
                cd2 = _shift_fill(sd2, dy, dx, 1e12)
                nd2 = torch.where(cd2 < 1e12, ((ys - cby) ** 2
                                               + (xs - cbx) ** 2).float(),
                                  1e12)
                better = nd2 < d2
                by = torch.where(better, cby, by)
                bx = torch.where(better, cbx, bx)
                d2 = torch.where(better, nd2, d2)
    return torch.sqrt(d2).numpy()


def test_candidates_apply_one_after_another(kinds_batch):
    """An input on which applying the 8 candidates against the step-start
    state gives other distances: the port must follow JAX there."""
    i = KINDS.index("jfa_order")
    s, want = kinds_batch[0][i:i + 1], kinds_batch[1][i:i + 1]
    assert not np.array_equal(_textbook_jfa(s), want)
    np.testing.assert_array_equal(edt_batch(torch.from_numpy(s)).numpy(),
                                  want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="bool"):
        edt_batch_jfa(torch.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match=r"\[B,H,W\]"):
        edt_batch_jfa(torch.zeros((4, 4), dtype=torch.bool))
