"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a card.

This file imports no JAX (the GPU machines have none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerance: none for CC, reach, median and EDT. Those kernels and their
plain versions compute integer labels, booleans, the same fp32 order
statistics and the same integer squared distances under an IEEE sqrt,
so they are compared with torch.equal after a synchronize. The LSR
kernels use expf/logf, which differ from torch's by ulps: loss atol
1e-5 and gradient atol 2e-6 at unit g (measured on an H100: 3.8e-6 and
4.2e-7 at [6,512,512,8]). The flash-attention kernel sums its fp32
products and its online softmax in another order than the plain
version's materialised softmax: max abs error within 1e-5 of the plain
output's max |value| in float32, 3e-2 in bfloat16 (one bf16 rounding of
the output, the JAX flash test's own bound). The two backward kernels against
`flash_relpos_bwd_plain`, each gradient's max abs error over the plain
one's max |value|: 1e-5 in float32 (as the forward), 1e-2 in bfloat16
(both sides sum in fp32 from the same bf16 inputs and round once to bf16,
so they differ by at most one bf16 step, 2^-7 = 7.8e-3 of a value).
The channel-sums kernel against `channel_sums_plain`: 1e-5 of sum |a|
and of sum |a*b| per channel (fp32 accumulation in another order; bf16
inputs are widened exactly on both sides), and the same bits on a
second run (fixed-order partial sums, no atomics).
"""

import numpy as np
import pytest
import torch

from cartseg_tpu_torch.ops.channel_sums import (channel_sums,
                                                channel_sums_plain)
from cartseg_tpu_torch.ops.cuda import build
from cartseg_tpu_torch.ops.cuda.cc import (cc_batch, cc_batch_plain,
                                           reach_batch, reach_batch_plain)
from cartseg_tpu_torch.ops.cuda.edt import edt_batch_jfa, edt_batch_plain
from cartseg_tpu_torch.ops.cuda.flash_attention import (
    MAX_GRID, flash_relpos_bwd, flash_relpos_bwd_plain, flash_relpos_fwd,
    flash_relpos_fwd_lse_plain, flash_relpos_fwd_plain)
from cartseg_tpu_torch.ops.cuda.lsr import (lsr_bwd, lsr_bwd_plain, lsr_fwd,
                                            lsr_fwd_plain)
from cartseg_tpu_torch.ops.cuda.median import median_rows, median_rows_plain
from cartseg_tpu_torch.utils.synthetic import (blob_masks, ring_cuts_mask,
                                               spiral_mask)
from torch_port_helpers import cuda_device, sam_official_state_dict  # noqa: F401

pytestmark = pytest.mark.cuda


def _masks(kind, shape=(4, 48, 64)):
    r = np.random.default_rng(1)
    if kind == "noise":
        return r.random(shape) < 0.45
    if kind == "dense":
        return r.random(shape) < 0.7
    if kind == "blobs":
        return blob_masks(r, shape)
    if kind == "all_bg":
        return np.zeros(shape, bool)
    if kind == "all_fg":
        return np.ones(shape, bool)
    if kind == "spiral":
        return spiral_mask(97)[None]
    if kind == "ring_cuts":
        return ring_cuts_mask(97)[None]
    raise ValueError(kind)


@pytest.mark.parametrize("conn", [8, 4])
@pytest.mark.parametrize("kind", ["noise", "dense", "blobs", "all_bg",
                                  "all_fg", "spiral", "ring_cuts"])
def test_cc_kernel_equals_plain(cuda_device, kind, conn):
    m = torch.from_numpy(_masks(kind)).to(cuda_device)
    got = cc_batch(m, connectivity=conn)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, cc_batch_plain(m, connectivity=conn))


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 1, 77), (2, 77, 1),
                                   (3, 37, 53), (1, 130, 257)])
def test_cc_kernel_odd_shapes(cuda_device, shape):
    m = torch.from_numpy(_masks("noise", shape)).to(cuda_device)
    for conn in (8, 4):
        assert torch.equal(cc_batch(m, conn), cc_batch_plain(m, conn))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reach_kernel_equals_plain(cuda_device, seed):
    r = np.random.default_rng(seed)
    weak = r.random((3, 40, 56)) < 0.5
    strong = weak & (r.random((3, 40, 56)) < 0.1)
    w = torch.from_numpy(weak).to(cuda_device)
    for s in (strong, strong | ~weak):
        s = torch.from_numpy(s).to(cuda_device)
        got = reach_batch(w, s)
        torch.cuda.synchronize()
        assert torch.equal(got, reach_batch_plain(w, s))


def test_reach_kernel_spiral(cuda_device):
    weak = torch.from_numpy(spiral_mask(129)[None]).to(cuda_device)
    strong = torch.zeros_like(weak)
    strong[0, 0, 0] = True
    assert torch.equal(reach_batch(weak, strong), weak)


@pytest.mark.parametrize("B,N", [(5, 50177), (3, 1), (2, 2), (1, 128),
                                 (4, 262144)])
def test_median_kernel_equals_plain(cuda_device, B, N):
    r = np.random.default_rng(N)
    x = np.abs(r.normal(size=(B, N))).astype(np.float32)
    x[0, ::3] = 0.0
    if B > 2:
        x[1] = 0.0
        x[2] = np.round(x[2] * 4) / 4          # heavy duplicates
    t = torch.from_numpy(x).to(cuda_device)
    got = median_rows(t)
    torch.cuda.synchronize()
    assert torch.equal(got, median_rows_plain(t))


@pytest.mark.parametrize("kind", ["random", "blobs", "none", "single",
                                  "all"])
@pytest.mark.parametrize("shape", [(3, 48, 64), (2, 37, 53), (1, 1, 1),
                                   (2, 1, 77), (1, 130, 257)])
def test_edt_kernel_equals_plain(cuda_device, kind, shape):
    r = np.random.default_rng(2)
    if kind == "random":
        s = r.random(shape) < 0.02
    elif kind == "blobs":
        m = blob_masks(r, shape)
        s = np.zeros_like(m)
        s[:, :-1] |= m[:, :-1] != m[:, 1:]
        s[:, :, :-1] |= m[:, :, :-1] != m[:, :, 1:]
    elif kind == "single":
        s = np.zeros(shape, bool)
        s[..., shape[1] // 2, shape[2] // 3] = True
    else:
        s = np.full(shape, kind == "all")
    t = torch.from_numpy(s).to(cuda_device)
    got = edt_batch_jfa(t)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, edt_batch_plain(t))


@pytest.mark.parametrize("C", [8, 2, 5])
def test_lsr_kernels_within_tolerance_of_plain(cuda_device, C):
    g = torch.Generator(device="cpu").manual_seed(C)
    n = 4099
    x = (torch.randn((n, C), generator=g) * 3).to(cuda_device)
    lab = torch.randint(0, C, (n,), generator=g)
    lab[::7] = 255
    lab = lab.to(cuda_device)
    up = torch.randn((n,), generator=g).to(cuda_device)
    f = lsr_fwd(x, lab, 0.2, 255)
    torch.cuda.synchronize()
    assert (f - lsr_fwd_plain(x, lab, 0.2, 255)).abs().max() <= 1e-5
    ones = torch.ones_like(up)
    b = lsr_bwd(x, lab, ones, 0.2, 255)
    assert (b - lsr_bwd_plain(x, lab, ones, 0.2, 255)).abs().max() <= 2e-6
    b = lsr_bwd(x, lab, up, 0.2, 255)
    assert (b - lsr_bwd_plain(x, lab, up, 0.2, 255)).abs().max() <= 1e-5
    assert torch.all(f[::7] == 0) and torch.all(b[::7] == 0)


def test_lsr_ce_autograd_runs_both_kernels(cuda_device):
    from cartseg_tpu_torch.losses.label_smooth import lsr_ce

    build.reset_launch_counts()
    x = torch.randn((2, 16, 16, 8), device=cuda_device, requires_grad=True)
    lab = torch.randint(0, 8, (2, 16, 16), device=cuda_device)
    lsr_ce(x, lab, 0.2, 255).sum().backward()
    assert build.LAUNCHES["lsr_fwd"] == 1 and build.LAUNCHES["lsr_bwd"] == 1
    ref = x.detach().clone().requires_grad_(True)
    from cartseg_tpu_torch.losses.label_smooth import lsr_cross_entropy
    lsr_cross_entropy(ref, lab, 0.2, "none", 255).sum().backward()
    assert (x.grad - ref.grad).abs().max() <= 2e-6
    build.reset_launch_counts()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    m = torch.zeros((2, 8, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cc_batch(m.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        median_rows(torch.zeros((8, 4), device=cuda_device).T)
    with pytest.raises(ValueError, match="contiguous"):
        edt_batch_jfa(m.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        lsr_fwd(torch.zeros((8, 4), device=cuda_device).T,
                torch.zeros(4, dtype=torch.int64, device=cuda_device),
                0.2, 255)


def test_launch_counters_count_kernel_launches_only(cuda_device):
    build.reset_launch_counts()
    m = torch.ones((1, 8, 8), dtype=torch.bool)
    cc_batch(m)                                   # CPU: plain version
    edt_batch_jfa(m)
    assert build.LAUNCHES["cc"] == build.LAUNCHES["edt"] == 0
    cc_batch(m.to(cuda_device))
    reach_batch(m.to(cuda_device), m.to(cuda_device))
    median_rows(torch.ones((1, 4), device=cuda_device))
    edt_batch_jfa(m.to(cuda_device))
    x = torch.zeros((3, 8), device=cuda_device)
    lab = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    lsr_fwd(x, lab, 0.2, 255)
    lsr_bwd(x, lab, torch.ones(3, device=cuda_device), 0.2, 255)
    fa = [t.to(cuda_device) for t in _flash_inputs(1, 4, 32, torch.float32)]
    out, lse = flash_relpos_fwd(*fa, 0.125, 4, with_lse=True)
    flash_relpos_bwd_plain(*fa, out, lse, out, 0.125, 4)  # plain: no count
    flash_relpos_bwd(*fa, out, lse, out, 0.125, 4)
    a = torch.ones((2, 3, 4, 5))
    channel_sums(a, a)                            # CPU: plain version
    channel_sums(a.to(cuda_device), a.to(cuda_device))
    assert build.LAUNCHES == {"cc": 1, "reach": 1, "median": 1, "edt": 1,
                              "lsr_fwd": 1, "lsr_bwd": 1, "flash_fwd": 1,
                              "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                              "channel_sums": 1}
    build.reset_launch_counts()


def _flash_inputs(bnh, g, hd, dtype, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    S = g * g
    q, k, v = (torch.randn((bnh, S, hd), generator=gen) for _ in range(3))
    rh, rw = (0.5 * torch.randn((bnh, S, g), generator=gen)
              for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, rh, rw)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bnh,g,hd", [(3, 16, 32), (3, 16, 64),
                                      (12, 64, 64), (2, 10, 64),
                                      (1, 23, 32)])
def test_flash_kernel_within_tolerance_of_plain(cuda_device, bnh, g, hd,
                                                dtype):
    """The ViT-B global block [12,4096,64], the tests' g = 16 shapes, and
    grids whose S is not a multiple of the 64-row tiles."""
    ts = [t.to(cuda_device) for t in _flash_inputs(bnh, g, hd, dtype)]
    got = flash_relpos_fwd(*ts, hd ** -0.5, g)
    torch.cuda.synchronize()
    want = flash_relpos_fwd_plain(*ts, hd ** -0.5, g)
    assert got.dtype == dtype and got.shape == (bnh, g * g, hd)
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert rel <= (1e-5 if dtype == torch.float32 else 3e-2), rel


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    ts = [t.to(cuda_device) for t in _flash_inputs(2, 8, 48, torch.float32)]
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_relpos_fwd(*ts, 0.1, 8)
    ts = [t.to(cuda_device) for t in _flash_inputs(2, 8, 32, torch.float32)]
    with pytest.raises(TypeError, match="one type"):
        flash_relpos_fwd(*[t.half() for t in ts], 0.1, 8)
    with pytest.raises(ValueError, match="tensors on"):
        flash_relpos_fwd(ts[0], ts[1].cpu(), *ts[2:], 0.1, 8)
    q = ts[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_relpos_fwd(q, *ts[1:], 0.1, 8)
    with pytest.raises(ValueError, match="grid_size"):
        flash_relpos_fwd(*ts, 0.1, 7)

    # the backward: the same checks, and lse / D fp32 [bnh,S], dO like q
    out, lse = flash_relpos_fwd(*ts, 0.1, 8, with_lse=True)
    with pytest.raises(ValueError, match="lse and D"):
        flash_relpos_bwd(*ts, out, lse[:, :-1], out, 0.1, 8)
    with pytest.raises(ValueError, match="lse and D"):
        flash_relpos_bwd(*ts, out, lse.double(), out, 0.1, 8)
    with pytest.raises(TypeError, match="one type"):
        flash_relpos_bwd(*ts, out, lse, out.to(torch.bfloat16), 0.1, 8)
    with pytest.raises(ValueError, match="contiguous"):
        flash_relpos_bwd(*ts, out, lse, q, 0.1, 8)
    with pytest.raises(ValueError, match="must match q"):
        flash_relpos_bwd(*ts, out, lse, out[:, :, :16], 0.1, 8)
    with pytest.raises(ValueError, match="tensors on"):
        flash_relpos_bwd(*ts, out, lse.cpu(), out, 0.1, 8)
    g = MAX_GRID + 1
    big = [t.to(cuda_device) for t in _flash_inputs(1, g, 32, torch.float32)]
    with pytest.raises(ValueError, match="grid_size"):
        flash_relpos_fwd(*big, 0.1, g)
    with pytest.raises(ValueError, match="grid_size"):
        flash_relpos_bwd(*big, big[0], big[0][..., 0].contiguous(), big[0],
                         0.1, g)


def _flash_grads(bnh, g, hd, dtype, dev):
    """Inputs, the forward kernel's output and lse, a seeded dO, and the
    backward kernels' and the plain version's five gradients."""
    ts = [t.to(dev) for t in _flash_inputs(bnh, g, hd, dtype)]
    gen = torch.Generator(device="cpu").manual_seed(7)
    do = torch.randn((bnh, g * g, hd), generator=gen).to(dtype).to(dev)
    out, lse = flash_relpos_fwd(*ts, hd ** -0.5, g, with_lse=True)
    got = flash_relpos_bwd(*ts, out, lse, do, hd ** -0.5, g)
    torch.cuda.synchronize()
    want = flash_relpos_bwd_plain(*ts, out, lse, do, hd ** -0.5, g)
    return ts, (out, lse, do), got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bnh,g,hd", [(3, 16, 32), (2, 64, 64),
                                      (1, 64, 32), (2, 10, 64),
                                      (1, 23, 32)])
def test_flash_bwd_kernels_within_tolerance_of_plain(cuda_device, bnh, g, hd,
                                                     dtype):
    """flash_bwd_dq and flash_bwd_dkv against flash_relpos_bwd_plain at
    g 16 and 64 and at grids whose S is not a multiple of the 64-row
    tiles; the gradients keep their inputs' types and are the same bits
    from run to run (no atomics)."""
    ts, (out, lse, do), got, want = _flash_grads(bnh, g, hd, dtype,
                                                 cuda_device)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for name, a, b, like in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got,
                                want, (ts[0], ts[1], ts[2], ts[3], ts[4])):
        assert a.dtype == dtype and a.shape == like.shape, name
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert rel <= tol, (name, rel)
    again = flash_relpos_bwd(*ts, out, lse, do, hd ** -0.5, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_writes_the_lse_only_when_asked(cuda_device, dtype):
    ts = [t.to(cuda_device) for t in _flash_inputs(2, 23, 64, dtype)]
    plain = flash_relpos_fwd(*ts, 0.125, 23)
    out, lse = flash_relpos_fwd(*ts, 0.125, 23, with_lse=True)
    _, want = flash_relpos_fwd_lse_plain(*ts, 0.125, 23)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (2, 23 * 23)
    assert float((lse - want).abs().max() / want.abs().max()) <= 1e-5


def test_vit_attention_backward_on_the_card_runs_both_kernels(
        cuda_device, monkeypatch):
    """loss.backward() through ViTAttention's flash lane: one launch of
    each kernel, no plain version, gradients as the plain lane's."""
    from cartseg_tpu_torch.models.sam import ViTAttention
    from cartseg_tpu_torch.ops.cuda import flash_attention as cfa

    torch.manual_seed(0)
    plain = ViTAttention(64, 2, 16, use_flash=False)
    with torch.no_grad():
        plain.rel_pos_h.normal_(0, 0.3)
        plain.rel_pos_w.normal_(0, 0.3)
    flash = ViTAttention(64, 2, 16, use_flash=True)
    flash.load_state_dict(plain.state_dict())
    x = torch.randn(1, 16, 16, 64, device=cuda_device)
    grads = []
    for m in (plain.to(cuda_device), flash.to(cuda_device)):
        xi = x.clone().requires_grad_(True)
        if m is flash:
            for name in ("flash_relpos_fwd_plain", "flash_relpos_bwd_plain",
                         "flash_bwd_dq_plain", "flash_bwd_dkv_plain"):
                monkeypatch.setattr(cfa, name, None)
            build.reset_launch_counts()
        (m(xi) ** 2).sum().backward()
        grads.append((xi.grad, m.rel_pos_h.grad, m.qkv.weight.grad))
    assert build.LAUNCHES["flash_fwd"] == 1
    assert build.LAUNCHES["flash_bwd_dq"] == build.LAUNCHES[
        "flash_bwd_dkv"] == 1
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    build.reset_launch_counts()


def test_sam_predictor_on_the_card_matches_the_cpu(cuda_device):
    """A small SAM (img 256, one global block on the flash kernel) on the
    card in fp32 against the CPU's plain lanes: features and logits."""
    from cartseg_tpu_torch.device import set_fp32_policy
    from cartseg_tpu_torch.models.sam import SamConfig, SamPredictor

    set_fp32_policy()
    cfg = SamConfig(img_size=256, encoder_dim=64, encoder_depth=2,
                    encoder_heads=2, global_attn_indexes=(1,), window_size=6,
                    prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64,
                    global_attn_flash=True)
    sd = sam_official_state_dict(cfg, seed=0)
    img = np.random.default_rng(0).integers(0, 256, (128, 96, 3), np.uint8)
    out = {}
    build.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        p = SamPredictor(sd, cfg, device=dev)
        f = p.set_image(img).float().cpu()
        m, iou, _ = p.predict(point_coords=np.array([[40, 50]]),
                              point_labels=np.array([1]),
                              box=np.array([10, 10, 80, 100]),
                              return_logits=True)
        out[str(dev)] = (f, m, iou)
    assert build.LAUNCHES["flash_fwd"] == 1
    (fc, mc, ic), (fg, mg, ig) = out["cpu"], out[str(cuda_device)]
    assert (fg - fc).abs().max() <= 1e-4
    assert np.abs(mg - mc).max() <= 1e-3 and np.abs(ig - ic).max() <= 1e-4
    build.reset_launch_counts()


# ---------------------------------------------------------- channel sums

def _sums_inputs(shape, dtypes, layout, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(shape, generator=gen) * 2 + 0.5
    b = torch.randn(shape, generator=gen)
    fmt = (torch.channels_last if layout == "nhwc"
           else torch.contiguous_format)
    return [t.to(d).to(dev).contiguous(memory_format=fmt)
            for t, d in zip((a, b), dtypes)]


def _check_sums(a, b):
    got = channel_sums(a, b)
    torch.cuda.synchronize()
    want = channel_sums_plain(a, b)
    af, bf = a.float(), b.float()
    tol = (1e-5 * af.abs().sum((0, 2, 3)),
           1e-5 * (af * bf).abs().sum((0, 2, 3)))
    for g, w, t in zip(got, want, tol):
        assert g.dtype == torch.float32 and g.shape == (a.shape[1],)
        assert bool(((g - w).abs() <= t).all()), float((g - w).abs().max())
    again = channel_sums(a, b)
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    return got


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("shape", [(2, 3, 17, 9), (6, 16, 64, 48),
                                   (3, 64, 31, 33), (4, 512, 8, 8),
                                   (1, 16, 1, 1)])
def test_channel_sums_kernel_within_tolerance_of_plain(cuda_device, shape,
                                                       layout, dtype, same):
    a, b = _sums_inputs(shape, (dtype, dtype), layout, cuda_device)
    build.reset_launch_counts()
    _check_sums(a, a if same else b)
    assert build.LAUNCHES["channel_sums"] == 2
    build.reset_launch_counts()


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_channel_sums_kernel_mixed_types_and_misaligned(cuda_device, layout):
    """(bf16, fp32) in both orders, and a view one element past an
    aligned start, which takes the one-element loads."""
    for dtypes in ((torch.bfloat16, torch.float32),
                   (torch.float32, torch.bfloat16)):
        _check_sums(*_sums_inputs((3, 24, 20, 12), dtypes, layout,
                                  cuda_device))
    big = torch.randn(1 + 2 * 16 * 8 * 8, device=cuda_device)
    a = big[1:].view(2, 16, 8, 8)
    if layout == "nhwc":
        a = big[1:].view(2, 8, 8, 16).permute(0, 3, 1, 2)
    _check_sums(a, a)


def test_channel_sums_kernel_past_2_31_elements(cuda_device):
    """[2,17,8192,8192] bf16, 2.3e9 elements (4.6 GB): int64 offsets in
    both memory orders."""
    a = torch.empty((2, 17, 8192, 8192), dtype=torch.bfloat16,
                    device=cuda_device)
    a.normal_(0.5, 1.0, generator=torch.Generator(cuda_device).manual_seed(0))
    assert a.numel() > 2 ** 31
    got = channel_sums(a, a)
    torch.cuda.synchronize()
    for c in (0, 16):                 # the plain sums a channel at a time
        ac = a[:, c:c + 1].float()
        want = channel_sums_plain(ac, ac)
        tol = (1e-5 * float(ac.abs().sum()), 1e-5 * float((ac * ac).sum()))
        for g, w, t in zip(got, want, tol):
            assert abs(float(g[c]) - float(w[0])) <= t
        del ac
    cl = a.contiguous(memory_format=torch.channels_last)
    del a
    got_cl = channel_sums(cl, cl)
    for g, h in zip(got, got_cl):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=0)


def test_channel_sums_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    a = torch.zeros((2, 4, 6, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        channel_sums(a.transpose(2, 3), a.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous"):
        channel_sums(a, a.contiguous(memory_format=torch.channels_last))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        channel_sums(a.half(), a.half())
    with pytest.raises(ValueError):
        channel_sums(a, a.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_lane_bn_on_the_card_matches_the_torch_lane(cuda_device,
                                                           dtype,
                                                           monkeypatch):
    """One channels_last train step through ChannelSumsBatchNorm2d: two
    launches (forward stats, backward sums), no plain version, and y,
    dx, dgamma, dbeta and the running stats as the torch lane's. fp32:
    1e-4. bf16: y and dx within 0.05, JAX's own bound for its bf16
    TpuBatchNorm (the kernel lane rounds each elementwise op to bf16 as
    flax does, cuDNN once); dgamma, dbeta and the running stats, fp32
    sums of the same bf16 values, within 1e-3."""
    from cartseg_tpu_torch.models.norm import batch_norm
    from cartseg_tpu_torch.ops import channel_sums as ops_cs

    gen = torch.Generator(device="cpu").manual_seed(0)
    x = (torch.randn((6, 32, 40, 24), generator=gen) * 2 + 0.5).to(dtype)
    dy = torch.randn(x.shape, generator=gen).to(dtype)
    lanes = {}
    for lane in ("torch", "channel_sums"):
        bn = batch_norm(32, 1e-5, lane).to(cuda_device).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 32))
            bn.bias.copy_(torch.linspace(-1, 1, 32))
        xi = x.to(cuda_device).contiguous(
            memory_format=torch.channels_last).requires_grad_(True)
        build.reset_launch_counts()
        if lane == "channel_sums":
            monkeypatch.setattr(ops_cs, "channel_sums_plain", None)
        y = bn(xi)
        y.backward(dy.to(cuda_device).contiguous(
            memory_format=torch.channels_last))
        torch.cuda.synchronize()
        lanes[lane] = (y.float(), xi.grad.float(), bn.weight.grad,
                       bn.bias.grad, bn.running_mean, bn.running_var,
                       build.LAUNCHES["channel_sums"])
    t, k = lanes["torch"], lanes["channel_sums"]
    assert t[-1] == 0 and k[-1] == 2
    for i, (a, b) in enumerate(zip(k[:-1], t[:-1])):
        tol = (1e-4 if dtype == torch.float32 else
               0.05 if i < 2 else 1e-3)
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    build.reset_launch_counts()
