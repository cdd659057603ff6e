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
4.2e-7 at [6,512,512,8]). The flash-attention forward sums its
products and its online softmax in another order than the plain
version's materialised softmax: max abs error within 1e-5 of the plain
output's max |value| in float32 (tensor cores as split-TF32 products, the
softmax and every sum fp32; a CPU emulation of that arithmetic, tests/
test_torch_flash_fwd_tf32x3.py, lands within 9.6e-7 of max |plain|), 1e-2 in
bfloat16 (tensor cores: P rounded to bf16 once as the operand of P V,
then the output once; the plain version rounds only the output; a CPU
emulation of these rounding points, tests/test_torch_flash_fwd_
rounding.py, lands within 7.7e-3 of max |plain|), and the bf16 training
forward's lse within 1e-5 absolute of the plain logsumexp (the backward
recomputes P from it). The two backward kernels against
`flash_relpos_bwd_plain`, each gradient's max abs error over the plain
one's max |value|: 1e-5 in float32 (as the forward; the fp32 route runs
each product as three TF32 products on the tensor cores, hi lo + lo hi +
hi hi, and keeps P, dS and every sum in fp32; a CPU emulation of that
arithmetic, tests/test_torch_flash_bwd_tf32x3.py, lands within 1.9e-6 of
max |plain|, the card within 5.2e-6 at [12,4096,64]), 1e-2 in bfloat16.
The bf16 route runs on the tensor
cores and rounds P and dS to bf16 once each, as the A operands of dS K,
P^T dO and dS^T Q, then each output once; the plain version rounds only
the outputs. One bf16 rounding is up to 2^-9 of a value; a CPU emulation
of these rounding points (tests/test_torch_flash_bwd_rounding.py) lands
within 6.2e-3 of max |plain| at [2,256,64], [1,529,32] and [2,4096,64].
The channel-sums kernel against `channel_sums_plain`: 1e-5 of sum |a|
and of sum |a*b| per channel (fp32 accumulation in another order; bf16
inputs are widened exactly on both sides), and the same bits on a
second run (fixed-order partial sums, no atomics).

The loss-zoo kernels against their plain versions: the smoothed one-hot
and hswish (forward and backward) bit for bit (selects, and hswish's
add, multiplies and float32(1/6) in the plain version's order); focal
(loss and gradient), mish and swish (forward, and g * f' backward)
within 2e-6 of the plain output's max |value|, about 4 float32 ulps of
it: both use IEEE expf/log1pf/tanhf/powf, but nvcc contracts a*b+c into
FMAs where eager PyTorch rounds twice; soft-Dice's per-sample sums
within 1e-6 relative (fp32 sums of non-negative terms in another order,
about twenty additions deep), and the same bits on a second run.

The bilateral filter (csrc/bilateral.cu) against `bilateral_u8_plain`
bit for bit: the same float32 multiplies, adds, fused multiply-adds and
division in the same tap order, each an explicitly rounded intrinsic in
the kernel and emulated exactly in the plain lane.
"""

from collections import Counter

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
from cartseg_tpu_torch.ops.cuda.median import (MAX_SLICE, MedianPlan,
                                               _launch, _plan, median_rows,
                                               median_rows_plain, plan)
from cartseg_tpu_torch.ops.cuda.activations import (act_bwd, act_bwd_plain,
                                                    act_fwd, act_fwd_plain)
from cartseg_tpu_torch.ops.cuda.focal import focal_fwd, focal_plain
from cartseg_tpu_torch.ops.cuda.one_hot import one_hot, one_hot_plain
from cartseg_tpu_torch.ops.filters import bilateral_u8, bilateral_u8_plain
from cartseg_tpu_torch.ops.cuda.soft_dice import (soft_dice_sums,
                                                  soft_dice_sums_plain)
from cartseg_tpu_torch.utils.profiling import graph_nodes
from cartseg_tpu_torch.utils.synthetic import (blob_masks, edt_seeds,
                                               ring_cuts_mask, spiral_mask)
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


def _path_masks(kind, shape=(64, 512, 512)):
    r = np.random.default_rng(3)
    if kind == "blobs":
        return blob_masks(r, shape, n=8)
    if kind == "all_fg":
        return np.ones(shape, bool)
    return r.random(shape) < 0.45


@pytest.mark.parametrize("kind", ["blobs", "all_fg", "noise"])
def test_cc_reach_kernels_path_shape_equal_plain_twice(cuda_device, kind):
    """The pseudo-label path's [64,512,512] (32-row strips, 16 a
    image): CC at both connectivities and reach with 1 % seeds, bit for
    bit, and the same bits on a second call."""
    m = torch.from_numpy(_path_masks(kind)).to(cuda_device)
    for conn in (8, 4):
        got = cc_batch(m, conn)
        again = cc_batch(m, conn)
        torch.cuda.synchronize()
        assert torch.equal(got, cc_batch_plain(m, conn))
        assert torch.equal(got, again)
    strong = m & (torch.rand(m.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(0), device=cuda_device) < 0.01)
    got = reach_batch(m, strong)
    again = reach_batch(m, strong)
    torch.cuda.synchronize()
    assert torch.equal(got, reach_batch_plain(m, strong))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(2, 500, 512), (2, 300, 77),
                                   (2, 300, 513), (1, 40, 3000),
                                   (2, 2000, 1)])
def test_cc_reach_kernels_ragged_tiles(cuda_device, shape):
    """H not a multiple of the strip, W of 77 and 513 (no 16-byte
    loads), tiles side by side (W above 1024 columns) and one-column
    images: blobs and noise, bit for bit."""
    for kind in ("blobs", "noise"):
        m = torch.from_numpy(_path_masks(kind, shape)).to(cuda_device)
        for conn in (8, 4):
            assert torch.equal(cc_batch(m, conn), cc_batch_plain(m, conn))
        strong = m & torch.from_numpy(
            np.random.default_rng(4).random(shape) < 0.02).to(cuda_device)
        assert torch.equal(reach_batch(m, strong),
                           reach_batch_plain(m, strong))


def test_cc_reach_kernels_2048_spiral(cuda_device):
    """One spiral arm over [1,2048,2048] (16 x 1024 tiles, two across):
    every arm pixel takes label 0, the arm's first pixel; reach from the
    outer end takes the whole arm, from off the arm nothing."""
    weak = torch.from_numpy(spiral_mask(2048)[None]).to(cuda_device)
    n = 2048 * 2048
    want = torch.where(weak, 0, n).to(torch.int32)
    for conn in (8, 4):
        assert torch.equal(cc_batch(weak, conn), want)
    strong = torch.zeros_like(weak)
    strong[0, 0, 0] = True
    assert torch.equal(reach_batch(weak, strong), weak)
    strong[0, 0, 0] = False
    strong[0, 1, 5] = True                 # the gap under the first side
    assert not weak[0, 1, 5]
    assert not reach_batch(weak, strong).any()


@pytest.mark.parametrize("which", ["cc8", "cc4", "reach"])
def test_cc_reach_calls_run_at_most_three_kernels(cuda_device, which):
    """One call at [64,512,512] runs cc_tiles, cc_borders, cc_tiles (the
    first version ran 3 for CC, 5 and a memset for reach), and reach no
    memset."""
    m = torch.from_numpy(_path_masks("blobs")).to(cuda_device)
    fn = ((lambda: reach_batch(m, m)) if which == "reach"
          else (lambda: cc_batch(m, int(which[2]))))
    per_call = _kernels_a_call(fn)
    assert 1 <= sum(per_call.values()) <= 3, per_call
    assert any("cc_tiles" in n for n in per_call), per_call
    assert not any("memset" in n.lower() for n in per_call), per_call


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


def _conf_rows(B, N, seed=0):
    """|p - 0.5| * 2 rows as the pseudo-label path makes them: skewed
    toward 1, so the first radix digits crowd a few bins."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = torch.sigmoid(3 * torch.randn((B, N), generator=g))
    return (p - 0.5).abs() * 2.0


def test_median_kernel_path_shape_equal_plain_twice(cuda_device):
    """[64,262144] on the cluster route (8 CTAs of 32768): the path's
    skewed rows, rows with many duplicates, rows of two values and
    all-zero rows, bit for bit, and the same bits on a second call."""
    x = _conf_rows(64, 512 * 512)
    x[40:56] = torch.round(x[40:56] * 16) / 16
    x[56:60] = torch.where(x[56:60] > 0.5, 1.0, 0.0)
    x[60:] = 0.0
    t = x.to(cuda_device)
    assert plan(t.shape[1]) == MedianPlan("cluster", 8, 32768)
    got = median_rows(t)
    again = median_rows(t)
    torch.cuda.synchronize()
    assert torch.equal(got, median_rows_plain(t))
    assert torch.equal(got, again)


@pytest.mark.parametrize("n,cluster", [(4099, 1), (50177, 2), (100001, 4),
                                       (200003, 8), (9, 8)])
def test_median_kernel_each_cluster_size(cuda_device, n, cluster):
    """Each cluster size `plan` picks, rows not 16-byte aligned (odd N),
    and N = 9 on 8 CTAs of 2 (three CTAs hold nothing)."""
    p = plan(n) if n > 9 else _plan(n, slice_cap=1)
    assert (p.route, p.cluster) == ("cluster", cluster)
    t = _conf_rows(5, n, seed=n).to(cuda_device)
    got = _launch(t, p)
    torch.cuda.synchronize()
    assert torch.equal(got, median_rows_plain(t))
    assert torch.equal(_launch(t, p), got)


def test_median_kernel_long_rows_take_the_stream_route(cuda_device):
    """Rows past what a cluster of 8 holds (8 x MAX_SLICE elements) go
    the stream route, chosen by `plan` from N before the launch."""
    n = 8 * MAX_SLICE + 1
    assert plan(n) == MedianPlan("stream", 0, 0)
    t = _conf_rows(3, n, seed=1).to(cuda_device)
    t[1] = 0.0
    got = median_rows(t)
    torch.cuda.synchronize()
    assert torch.equal(got, median_rows_plain(t))
    assert torch.equal(median_rows(t), got)


def test_median_call_runs_one_kernel_and_no_memset(cuda_device):
    """At the path's [64,262144] one call is one CUDA kernel (the first
    version ran 13 and 4 memsets)."""
    t = _conf_rows(64, 512 * 512).to(cuda_device)
    per_call = _kernels_a_call(lambda: median_rows(t))
    assert sum(per_call.values()) == 1, per_call
    assert any("median_cluster" in n for n in per_call), per_call


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C,offset", [(8, 0), (2, 0), (16, 0), (5, 0),
                                      (8, 1)])
def test_lsr_bwd_routes_within_tolerance_of_plain(cuda_device, C, offset,
                                                  label_dtype):
    """The vector route (C = 2, 8, 16 on aligned rows) and the general
    route (C = 5, and C = 8 on rows that start 4 bytes past a 16-byte
    boundary), with int32 and int64 labels read as they are; ignored rows
    zero."""
    from cartseg_tpu_torch.ops.cuda.lsr import route

    g = torch.Generator(device="cpu").manual_seed(C + offset)
    n = 4098
    flat = torch.randn((n * C + offset,), generator=g) * 3
    x = flat.to(cuda_device)[offset:].view(n, C)
    assert route(x) == ("vector" if C != 5 and not offset else "general")
    lab = torch.randint(0, C, (n,), generator=g)
    lab[::7] = 255
    lab = lab.to(label_dtype).to(cuda_device)
    up = torch.randn((n,), generator=g).to(cuda_device)
    ones = torch.ones_like(up)
    b = lsr_bwd(x, lab, ones, 0.2, 255)
    torch.cuda.synchronize()
    assert (b - lsr_bwd_plain(x, lab, ones, 0.2, 255)).abs().max() <= 2e-6
    b = lsr_bwd(x, lab, up, 0.2, 255)
    assert (b - lsr_bwd_plain(x, lab, up, 0.2, 255)).abs().max() <= 1e-5
    assert torch.all(b[::7] == 0)


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C,offset,n", [(8, 0, 4098), (2, 0, 4098),
                                        (4, 0, 4099), (16, 0, 4099),
                                        (5, 0, 4098), (8, 1, 4098),
                                        (2, 0, 4099)])
def test_lsr_fwd_routes_within_tolerance_of_plain(cuda_device, C, offset, n,
                                                  label_dtype):
    """The forward's vector route (C = 2, 4, 8, 16 on aligned rows, n even
    at C = 2) and its general route (C = 5, rows 4 bytes past a 16-byte
    boundary, odd n at C = 2), int32 and int64 labels read as they are,
    ignored rows 0 and a label past C: within 1e-5 of the plain version,
    one CUDA kernel a call (`lsr_fwd_vec` or `lsr_fwd`), no conversion."""
    from cartseg_tpu_torch.ops.cuda.lsr import route

    g = torch.Generator(device="cpu").manual_seed(C + offset + n)
    flat = torch.randn((n * C + offset,), generator=g) * 3
    x = flat.to(cuda_device)[offset:].view(n, C)
    vec = C in (2, 4, 8, 16) and not offset and (C != 2 or n % 2 == 0)
    assert route(x) == ("vector" if vec else "general")
    lab = torch.randint(0, C, (n,), generator=g)
    lab[::7] = 255
    lab[3] = C + 2
    lab = lab.to(label_dtype).to(cuda_device)
    f = lsr_fwd(x, lab, 0.2, 255)
    torch.cuda.synchronize()
    assert (f - lsr_fwd_plain(x, lab, 0.2, 255)).abs().max() <= 1e-5
    assert torch.all(f[::7] == 0)
    per_call = _kernels_a_call(lambda: lsr_fwd(x, lab, 0.2, 255))
    assert sum(per_call.values()) == 1, per_call
    want = "lsr_fwd_vec" if vec else "lsr_fwd"
    assert all(want in k for k in per_call), per_call


def test_lsr_fwd_int64_labels_launch_one_vector_kernel(cuda_device):
    """An int64-label forward at the ABL path's [6*512*512, 8] is the one
    `lsr_fwd_vec` kernel (the first version converted the labels first:
    two kernels)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 6 * 512 * 512
    x = (torch.randn((n, 8), generator=g) * 3).to(cuda_device)
    lab = torch.randint(0, 8, (n,), generator=g)
    lab[::7] = 255
    lab = lab.to(cuda_device)
    assert lab.dtype == torch.int64
    per_call = _kernels_a_call(lambda: lsr_fwd(x, lab, 0.2, 255))
    assert sum(per_call.values()) == 1, per_call
    assert all("lsr_fwd_vec" in n for n in per_call), per_call
    f = lsr_fwd(x, lab, 0.2, 255)
    assert (f - lsr_fwd_plain(x, lab, 0.2, 255)).abs().max() <= 1e-5


def test_lsr_bwd_int64_labels_launch_no_conversion(cuda_device):
    """An int64-label call at the ABL path's [6*512*512, 8] is the one
    vector-route kernel: no label conversion, no copy."""
    g = torch.Generator(device="cpu").manual_seed(0)
    n = 6 * 512 * 512
    x = (torch.randn((n, 8), generator=g) * 3).to(cuda_device)
    lab = torch.randint(0, 8, (n,), generator=g).to(cuda_device)
    up = torch.randn((n,), generator=g).to(cuda_device)
    assert lab.dtype == torch.int64
    per_call = _kernels_a_call(lambda: lsr_bwd(x, lab, up, 0.2, 255))
    assert sum(per_call.values()) == 1, per_call
    assert all("lsr_bwd_vec" in n for n in per_call), per_call


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


@pytest.mark.parametrize("shape", [(6, 512, 512), (2, 400, 512),
                                   (3, 37, 53), (1, 2048, 2048),
                                   (1, 1, 1)])
def test_edt_kernel_path_shapes_equal_plain_twice(cuda_device, shape):
    """The path's [6,512,512] (residue classes mod 4, then 64-pixel tiles
    with a 12-pixel halo), frames before the letterbox, a one-block
    image, the largest side (classes mod 16, a 48-pixel halo) and one
    pixel: bit for bit, and the same bits on a second call."""
    seeds = edt_seeds(np.random.default_rng(0), shape)
    t = torch.from_numpy(seeds).to(cuda_device)
    got = edt_batch_jfa(t)
    again = edt_batch_jfa(t)
    torch.cuda.synchronize()
    assert torch.equal(got, edt_batch_plain(t))
    assert torch.equal(got, again)


def _kernels_a_call(fn):
    """Each operation's count in one call of fn (a kernel by its mangled
    symbol, a memset or copy by its kind), from a CUDA graph of the call:
    unlike the profiler's trace, it loses no event."""
    fn()
    return dict(Counter(sym for _, sym in graph_nodes(fn)))


def test_edt_call_runs_at_most_three_kernels(cuda_device):
    """One edt_batch_jfa call at [6,512,512] runs the class stage and the
    tile stage: two CUDA kernels (the old schedule ran 82)."""
    t = torch.from_numpy(
        edt_seeds(np.random.default_rng(0), (6, 512, 512))).to(cuda_device)
    per_call = _kernels_a_call(lambda: edt_batch_jfa(t))
    assert 1 <= sum(per_call.values()) <= 3, per_call
    assert any("edt_classes" in n for n in per_call), per_call


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
    flash_relpos_fwd(*(t.to(torch.bfloat16) for t in fa), 0.125, 4)
    out, lse = flash_relpos_fwd(*fa, 0.125, 4, with_lse=True)
    flash_relpos_bwd_plain(*fa, out, lse, out, 0.125, 4)  # plain: no count
    flash_relpos_bwd(*fa, out, lse, out, 0.125, 4)
    a = torch.ones((2, 3, 4, 5))
    channel_sums(a, a)                            # CPU: plain version
    channel_sums(a.to(cuda_device), a.to(cuda_device))
    v = torch.ones((2, 8))
    focal_fwd(v, v, 2.0, 0.25)                    # CPU: plain version
    soft_dice_sums(v, v, 1.0)
    one_hot(v.long(), 8, 0.1, 255)
    act_fwd(v, "mish")
    vc = v.to(cuda_device)
    focal_fwd(vc, vc, 2.0, 0.25)
    soft_dice_sums(vc, vc, 1.0)
    one_hot(vc.long(), 8, 0.1, 255)
    for kind in ("mish", "swish", "hswish"):
        act_fwd(vc, kind)
        act_bwd(vc, vc, kind)
    img = torch.zeros((4, 5, 3), dtype=torch.uint8)
    bilateral_u8(img)                             # CPU: plain version
    bilateral_u8_plain(img.to(cuda_device))       # plain: no count
    bilateral_u8(img.to(cuda_device))
    assert build.LAUNCHES == {"cc": 1, "reach": 1, "median": 1, "edt": 1,
                              "lsr_fwd": 1, "lsr_bwd": 1, "flash_fwd": 1,
                              "flash_fwd_tc": 1, "flash_bwd_dq": 1,
                              "flash_bwd_dkv": 1,
                              "channel_sums": 1, "focal": 1, "soft_dice": 1,
                              "one_hot": 1, "mish_fwd": 1, "mish_bwd": 1,
                              "swish_fwd": 1, "swish_bwd": 1,
                              "hswish_fwd": 1, "hswish_bwd": 1,
                              "bilateral": 1}
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
    assert rel <= (1e-5 if dtype == torch.float32 else 1e-2), rel


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


def test_flash_bwd_bf16_at_the_largest_grid(cuda_device):
    """A bf16 backward at g = MAX_GRID (S = 16384): the tensor-core
    kernels' shared memory (dq: Q, dO, two stages of K and V, the block's
    bias rows, the fp32 drel sums and the staged dS) fits, and the five
    gradients match the plain version."""
    g = MAX_GRID
    ts, _, got, want = _flash_grads(1, g, 64, torch.bfloat16, cuda_device)
    for name, a, b, like in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got,
                                want, ts):
        assert a.dtype == torch.bfloat16 and a.shape == like.shape, name
        rel = float((a.float() - b.float()).abs().max()
                    / b.float().abs().max())
        assert rel <= 1e-2, (name, rel)


def test_flash_bwd_fp32_at_the_largest_grid(cuda_device):
    """An fp32 backward at g = MAX_GRID (S = 16384), head_dim 64: the
    split-TF32 kernels' general-g shared memory (dq: Q, dO, two stages of K
    and V, the fp32 drel sums and the staged dS, 191 KB) fits, and the five
    gradients are within 1e-5 of the plain version's max |value| and the
    same bits on a second run."""
    g = MAX_GRID
    ts, (out, lse, do), got, want = _flash_grads(1, g, 64, torch.float32,
                                                 cuda_device)
    for name, a, b, like in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got,
                                want, ts):
        assert a.dtype == torch.float32 and a.shape == like.shape, name
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= 1e-5, (name, rel)
    again = flash_relpos_bwd(*ts, out, lse, do, 64 ** -0.5, g)
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


@pytest.mark.parametrize("bnh,g,hd", [(12, 64, 64), (1, 23, 32)])
def test_flash_fwd_bf16_tensor_cores(cuda_device, bnh, g, hd):
    """The bf16 forward (flash_fwd_tc) at the ViT-B global block and a
    ragged grid, with and without lse: within 1e-2 of max |plain|, lse
    within 1e-5 absolute of the plain logsumexp, the same bits twice, one
    flash_fwd_tc launch a call."""
    ts = [t.to(cuda_device) for t in _flash_inputs(bnh, g, hd,
                                                   torch.bfloat16)]
    scale = hd ** -0.5
    build.reset_launch_counts()
    out = flash_relpos_fwd(*ts, scale, g)
    out2, lse = flash_relpos_fwd(*ts, scale, g, with_lse=True)
    again = flash_relpos_fwd(*ts, scale, g)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd_tc"] == 3
    assert build.LAUNCHES["flash_fwd"] == 0
    want, lse_want = flash_relpos_fwd_lse_plain(*ts, scale, g)
    assert out.dtype == torch.bfloat16 and out.shape == (bnh, g * g, hd)
    rel = float((out.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert rel <= 1e-2, rel
    assert torch.equal(out, out2) and torch.equal(out, again)
    assert float((lse - lse_want).abs().max()) <= 1e-5
    build.reset_launch_counts()


def test_flash_fwd_fp32_at_the_largest_grid(cuda_device):
    """An fp32 forward at g = MAX_GRID (S = 16384), head_dim 64, with and
    without lse: the split-TF32 kernel's general-g path (the bias factors
    read for each logit) within 1e-5 of the plain version's max |value|,
    lse within 1e-5 relative, the same bits on a second call, one
    flash_fwd launch a call."""
    g = MAX_GRID
    ts = [t.to(cuda_device) for t in _flash_inputs(1, g, 64, torch.float32)]
    build.reset_launch_counts()
    out = flash_relpos_fwd(*ts, 0.125, g)
    out2, lse = flash_relpos_fwd(*ts, 0.125, g, with_lse=True)
    out3, lse3 = flash_relpos_fwd(*ts, 0.125, g, with_lse=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_fwd"] == 3
    want, lse_want = flash_relpos_fwd_lse_plain(*ts, 0.125, g)
    assert out.dtype == torch.float32 and out.shape == (1, g * g, 64)
    assert float((out - want).abs().max() / want.abs().max()) <= 1e-5
    assert float((lse - lse_want).abs().max() / lse_want.abs().max()) <= 1e-5
    assert torch.equal(out, out2) and torch.equal(out2, out3)
    assert torch.equal(lse, lse3)
    build.reset_launch_counts()


def test_flash_fwd_routes_by_type(cuda_device):
    """float32 runs the split-TF32 kernel (flash_fwd_tf32x3, counted as
    flash_fwd), bfloat16 the tensor-core kernel (flash_fwd_tc): one launch
    a call."""
    for dt, sym in ((torch.float32, "flash_fwd_tf32x3"),
                    (torch.bfloat16, "flash_fwd_tc")):
        ts = [t.to(cuda_device) for t in _flash_inputs(2, 16, 64, dt)]
        per_call = _kernels_a_call(lambda: flash_relpos_fwd(*ts, 0.125, 16))
        assert len(per_call) == 1 and sym in next(iter(per_call)), per_call
        assert sum(per_call.values()) == 1, per_call


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


def _check_sums(a, b, call=channel_sums):
    got = call(a, b)
    torch.cuda.synchronize()
    want = channel_sums_plain(a, b)
    af, bf = a.float(), b.float()
    tol = (1e-5 * af.abs().sum((0, 2, 3)),
           1e-5 * (af * bf).abs().sum((0, 2, 3)))
    for g, w, t in zip(got, want, tol):
        assert g.dtype == torch.float32 and g.shape == (a.shape[1],)
        assert bool(((g - w).abs() <= t).all()), float((g - w).abs().max())
    again = call(a, b)
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    return got


SUMS_SHAPES = [(2, 3, 17, 9), (6, 16, 64, 48), (3, 64, 31, 33),
               (4, 512, 8, 8), (1, 16, 1, 1)]


@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("shape", SUMS_SHAPES)
def test_channel_sums_kernel_within_tolerance_of_plain(cuda_device, shape,
                                                       layout, dtype, same):
    a, b = _sums_inputs(shape, (dtype, dtype), layout, cuda_device)
    build.reset_launch_counts()
    _check_sums(a, a if same else b)
    assert build.LAUNCHES["channel_sums"] == 2
    build.reset_launch_counts()


def _sums_cases(dev):
    """Every input kind the kernel takes: the shapes of
    test_channel_sums_kernel_within_tolerance_of_plain in both orders and
    types, (x, x) and (dy, x); mixed types; a misaligned view."""
    for shape in SUMS_SHAPES:
        for layout in ("nhwc", "nchw"):
            for dtype in (torch.float32, torch.bfloat16):
                a, b = _sums_inputs(shape, (dtype, dtype), layout, dev)
                yield (shape, layout, dtype, "same"), a, a
                yield (shape, layout, dtype, "dy"), b, a
    for layout in ("nhwc", "nchw"):
        for dtypes in ((torch.bfloat16, torch.float32),
                       (torch.float32, torch.bfloat16)):
            yield ((layout, dtypes),
                   *_sums_inputs((3, 24, 20, 12), dtypes, layout, dev))
    big = torch.randn(1 + 2 * 16 * 8 * 8, device=dev)
    yield "misaligned nchw", big[1:].view(2, 16, 8, 8), big[1:].view(
        2, 16, 8, 8)
    nhwc = big[1:].view(2, 8, 8, 16).permute(0, 3, 1, 2)
    yield "misaligned nhwc", nhwc, nhwc


def test_channel_sums_call_is_one_kernel_no_memset_counters_zero(
        cuda_device):
    """Each input kind: one CUDA kernel a call (sums_nhwc or sums_nchw; the
    first version ran two) and no memset, by a CUDA graph of the call; the
    stream's arrival counters back at zero after every call."""
    from cartseg_tpu_torch.ops.cuda import channel_sums as cs

    for tag, a, b in _sums_cases(cuda_device):
        channel_sums(a, b)
        nodes = graph_nodes(lambda: channel_sums(a, b))
        kinds = Counter(kind for kind, _ in nodes)
        assert kinds == {"KERNEL": 1}, (tag, nodes)
        assert "sums_n" in nodes[0][1], (tag, nodes)
        torch.cuda.synchronize()
        buf = cs._COUNTERS[torch.device(cuda_device).index or 0]
        assert int(buf.count_nonzero()) == 0, tag


def test_channel_sums_same_bits_after_graph_capture(cuda_device):
    """A call captured into a CUDA graph and replayed twice gives the bits
    of the same call run eagerly, at the decoder top's bf16 NHWC inputs
    and at layer4's (the capture stream takes its own counters)."""
    for shape in ((6, 16, 512, 512), (6, 512, 16, 16)):
        x, dy = _sums_inputs(shape, (torch.bfloat16,) * 2, "nhwc",
                             cuda_device)
        for a, b in ((x, x), (dy, x)):
            want = channel_sums(a, b)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                channel_sums(a, b)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = channel_sums(a, b)
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            del graph


def test_channel_sums_forced_plans_give_the_plain_sums(cuda_device):
    """Plans the sizing never picks at these sizes, launched by `_launch`:
    one CTA, many CTAs a column, the narrowest columns, tc 256 (C =
    4096)."""
    from cartseg_tpu_torch.ops.cuda.channel_sums import Plan, _launch

    x, dy = _sums_inputs((6, 64, 48, 40), (torch.bfloat16,) * 2, "nhwc",
                         cuda_device)
    for p in (Plan(True, 8, 1, 8, 1), Plan(True, 8, 700, 8, 1),
              Plan(True, 8, 37, 1, 8), Plan(True, 8, 5, 2, 4)):
        _check_sums(dy, x, lambda a, b, p=p: _launch(a, b, p))
    x, _ = _sums_inputs((2, 4096, 3, 3), (torch.bfloat16,) * 2, "nhwc",
                        cuda_device)
    _check_sums(x, x)


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


# ------------------------------------------------------------ loss zoo

ELEM_TOL = 2e-6      # of the plain output's max |value|
DICE_TOL = 1e-6      # relative, per sample


def _within(name, got, want, tol=ELEM_TOL):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, name
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= tol * scale, (name, err, scale)


def _focal_inputs(shape, dev, seed=0):
    """3 N(0,1) logits and {0,1} targets; the first elements are edges:
    y == p (x = 0, y = 0.5; x = 30, y = 1), saturated logits, both
    branches of the log sigmoid."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 3
    y = (torch.rand(shape, generator=gen) > 0.5).float()
    edges = [(0.0, 0.5), (30.0, 1.0), (-30.0, 0.0), (-30.0, 1.0),
             (0.0, 1.0), (-1e-8, 0.0), (20.0, 0.0), (-100.0, 1.0)]
    xf, yf = x.view(-1), y.view(-1)
    for k, (xv, yv) in enumerate(edges[:xf.numel()]):
        xf[k], yf[k] = xv, yv
    return x.to(dev), y.to(dev)


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.25), (1.5, 0.5)])
@pytest.mark.parametrize("shape", [(6, 64, 64, 1), (3, 37, 1), (5,)])
def test_focal_kernel_within_tolerance_of_plain(cuda_device, shape, gamma,
                                                alpha):
    x, y = _focal_inputs(shape, cuda_device)
    loss, grad = focal_fwd(x, y, gamma, alpha)
    want = focal_plain(x, y, gamma, alpha)
    _within("focal loss", loss, want[0])
    _within("focal grad", grad, want[1])
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    assert float(loss.view(-1)[0]) == 0.0 and float(grad.view(-1)[0]) == 0.0


def test_focal_kernel_unaligned_and_empty(cuda_device):
    x, y = _focal_inputs((4099,), cuda_device)
    xs, ys = x[1:], y[1:]                       # 4-byte offset: scalar path
    loss, grad = focal_fwd(xs, ys, 2.0, 0.25)
    want = focal_plain(xs, ys, 2.0, 0.25)
    _within("focal loss", loss, want[0])
    _within("focal grad", grad, want[1])
    build.reset_launch_counts()
    e = torch.empty((0, 3), device=cuda_device)
    loss, grad = focal_fwd(e, e, 2.0, 0.25)
    assert loss.shape == grad.shape == (0, 3)
    assert build.LAUNCHES["focal"] == 0


@pytest.mark.parametrize("pexp", [1.0, 2.0, 1.5])
@pytest.mark.parametrize("B,M", [(6, 4096), (3, 1001), (2, 262144), (1, 1)])
def test_soft_dice_kernel_within_tolerance_of_plain(cuda_device, B, M, pexp):
    """Sample 0 has no foreground (its numer is 0 in both); the same bits
    on a second call."""
    gen = torch.Generator(device="cpu").manual_seed(M)
    x = (torch.randn((B, M), generator=gen) * 2).to(cuda_device)
    y = (torch.rand((B, M), generator=gen) > 0.6).float().to(cuda_device)
    y[0] = 0.0
    numer, denor = soft_dice_sums(x, y, pexp)
    again = soft_dice_sums(x, y, pexp)
    want = soft_dice_sums_plain(x, y, pexp)
    torch.cuda.synchronize()
    for got, w, h in zip((numer, denor), want, again):
        assert got.shape == (B,) and got.dtype == torch.float32
        assert bool(((got - w).abs() <= DICE_TOL * w.abs()).all()), (got, w)
        assert torch.equal(got, h)
    assert float(numer[0]) == 0.0


def test_soft_dice_kernel_unaligned_and_empty(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn((2, 4097), generator=gen).to(cuda_device)
    y = (torch.rand((2, 4097), generator=gen) > 0.5).float().to(cuda_device)
    xs = x.view(-1)[1:8193].view(2, 4096)       # 4-byte offset
    ys = y.view(-1)[1:8193].view(2, 4096)
    for got, w in zip(soft_dice_sums(xs, ys, 2.0),
                      soft_dice_sums_plain(xs, ys, 2.0)):
        torch.cuda.synchronize()
        assert bool(((got - w).abs() <= DICE_TOL * w.abs()).all())
    build.reset_launch_counts()
    n, d = soft_dice_sums(x[:, :0].contiguous(), y[:, :0].contiguous(), 1.0)
    assert n.shape == d.shape == (2,) and float(n.abs().sum()) == 0.0
    assert build.LAUNCHES["soft_dice"] == 0


# the focal kernel's exponent routes: 2 (a a, a), 1 (a, 1), 0 (powf) at
# gamma 1.5 and 3
FOCAL_GAMMAS = (2.0, 1.0, 1.5, 3.0)


@pytest.mark.parametrize("gamma", FOCAL_GAMMAS)
def test_focal_kernel_each_gamma_route(cuda_device, gamma):
    """Each route at a path-like shape, at an odd size one element past a
    16-byte boundary (the scalar route) and on edge logits (+-30, +-1e-3,
    0, -100 against both labels): within ELEM_TOL of max |plain|; at
    y == p (x = 0, y = 0.5; x = 30, y = 1) the loss is an exact zero, and
    the gradient too where gamma > 1."""
    x, y = _focal_inputs((6, 64, 64, 1), cuda_device)
    big_x, big_y = _focal_inputs((4100,), cuda_device, seed=1)
    ex = torch.tensor([0.0, 30.0] + [v for v in (30.0, -30.0, 1e-3, -1e-3,
                                                 0.0, -100.0)
                                     for _ in range(2)], device=cuda_device)
    ey = torch.tensor([0.5, 1.0] + [0.0, 1.0] * 6, device=cuda_device)
    for xs, ys in ((x, y), (big_x[1:], big_y[1:]), (ex, ey)):
        loss, grad = focal_fwd(xs, ys, gamma, 0.25)
        want = focal_plain(xs, ys, gamma, 0.25)
        _within(f"focal loss gamma {gamma}", loss, want[0])
        _within(f"focal grad gamma {gamma}", grad, want[1])
        assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
        lf, gf = loss.view(-1), grad.view(-1)
        assert float(lf[0]) == 0.0
        if gamma > 1.0:
            assert float(gf[0]) == 0.0
    assert float(loss[1]) == 0.0
    if gamma > 1.0:
        assert float(grad[1]) == 0.0


def test_focal_forced_plans_give_the_plain_values(cuda_device):
    """Plans the sizing never picks at these sizes, launched by `_launch`:
    one CTA for every element, many small CTAs, the scalar route on
    aligned inputs, and a plan of more CTAs than a wave holds."""
    from cartseg_tpu_torch.ops.cuda.focal import Plan, _launch

    x, y = _focal_inputs((70003,), cuda_device)
    want = focal_plain(x, y, 2.0, 0.25)
    n = x.numel()
    for p in (Plan(4, 1, 70004), Plan(4, 17501, 4), Plan(1, 35, 2004),
              Plan(4, 1945, 36)):
        loss, grad = _launch(x, y, 2.0, 0.25, p, torch.empty_like(x),
                             torch.empty_like(x))
        assert (p.ctas - 1) * p.L < n <= p.ctas * p.L
        _within(f"focal loss {p}", loss, want[0])
        _within(f"focal grad {p}", grad, want[1])


def _dice_inputs(B, M, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((B, M), generator=gen) * 2).to(dev)
    y = (torch.rand((B, M), generator=gen) > 0.6).float().to(dev)
    return x, y


def _dice_close(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(((g - w).abs() <= DICE_TOL * w.abs()).all()), (g, w)


def test_zoo_calls_are_one_kernel_no_memset(cuda_device):
    """One CUDA kernel a call and no memset, by a CUDA graph of the call:
    focal on each route, aligned and one element past a 16-byte boundary;
    soft-Dice at p = 1, 2 and 1.5 at the path shape (64 CTAs a sample),
    at an odd M and unaligned (the first version ran two kernels). The
    soft-Dice arrival counters are back at zero after every call."""
    from cartseg_tpu_torch.ops.cuda import soft_dice as sd

    x, y = _focal_inputs((6, 64, 64, 1), cuda_device)
    for gamma in FOCAL_GAMMAS:
        for xs, ys in ((x, y), (x.view(-1)[1:], y.view(-1)[1:])):
            calls = _kernels_a_call(lambda: focal_fwd(xs, ys, gamma, 0.25))
            assert len(calls) == 1 and "focal_fwd_bwd" in next(iter(calls))
            assert sum(calls.values()) == 1, calls
    x, y = _dice_inputs(6, 512 * 512, cuda_device)
    odd_x, odd_y = _dice_inputs(3, 1001, cuda_device)
    cases = ((x, y), (odd_x, odd_y),
             (x.view(-1)[1:8193].view(2, 4096), y.view(-1)[1:8193].view(
                 2, 4096)))
    for pexp in (1.0, 2.0, 1.5):
        for xs, ys in cases:
            calls = _kernels_a_call(lambda: soft_dice_sums(xs, ys, pexp))
            assert len(calls) == 1 and "dice_sums" in next(iter(calls))
            assert sum(calls.values()) == 1, calls
            torch.cuda.synchronize()
            buf = sd._ARRIVALS.buffers[torch.device(cuda_device).index or 0]
            assert int(buf.count_nonzero()) == 0


def test_soft_dice_same_bits_on_a_stream_and_after_graph_capture(
        cuda_device):
    """The path shape and a ragged one: the bits of an eager call on a
    second stream, and of a call captured into a CUDA graph and replayed
    twice (each stream takes its own counters), equal the first call's;
    the counters are back at zero afterwards."""
    from cartseg_tpu_torch.ops.cuda import soft_dice as sd

    for B, M in ((6, 512 * 512), (5, 77777)):
        x, y = _dice_inputs(B, M, cuda_device, seed=B)
        for pexp in (1.0, 2.0):
            want = soft_dice_sums(x, y, pexp)
            _dice_close(want, soft_dice_sums_plain(x, y, pexp))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                other = soft_dice_sums(x, y, pexp)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(other, want))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = soft_dice_sums(x, y, pexp)
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            del graph
    torch.cuda.synchronize()
    buf = sd._ARRIVALS.buffers[torch.device(cuda_device).index or 0]
    assert int(buf.count_nonzero()) == 0


def test_soft_dice_forced_plans_give_the_plain_sums(cuda_device):
    """Plans the sizing never picks, launched by `_launch`: one CTA a
    sample, the most CTAs a sample (one load each), the scalar route on
    aligned inputs, and many CTAs over one sample."""
    from cartseg_tpu_torch.ops.cuda.soft_dice import Plan, _launch

    x, y = _dice_inputs(4, 65536, cuda_device)
    for p in (Plan(4, 1, 65536), Plan(4, 16384, 4), Plan(1, 33, 2000),
              Plan(4, 298, 220)):
        assert (p.P - 1) * p.L < 65536 <= p.P * p.L
        for pexp in (1.0, 2.0):
            _dice_close(_launch(x, y, pexp, p),
                        soft_dice_sums_plain(x, y, pexp))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("C,lb_smooth,ignore", [(8, 0.2, 255), (8, 0.1, -100),
                                                (5, 0.3, 255), (1, 0.0, 255)])
def test_one_hot_kernel_equals_plain(cuda_device, dtype, C, lb_smooth,
                                     ignore):
    """Ignored rows, labels outside [0, C) and an empty batch."""
    gen = torch.Generator(device="cpu").manual_seed(C)
    lab = torch.randint(0, C, (6, 4099), generator=gen).to(dtype)
    lab[:, ::7] = ignore
    lab[0, 1] = C
    lab[0, 2] = -1
    lab = lab.to(cuda_device)
    got = one_hot(lab, C, lb_smooth, ignore)
    torch.cuda.synchronize()
    assert got.shape == (6, 4099, C) and got.dtype == torch.float32
    assert torch.equal(got, one_hot_plain(lab, C, lb_smooth, ignore))
    assert bool((got[:, ::7] == 0).all())
    assert one_hot(lab[:0], C, lb_smooth, ignore).shape == (0, 4099, C)


def _act_inputs(shape, dev, seed=2):
    """5 N(0,1) values, led by hswish's breakpoints -3 and 3 and their
    float32 neighbours, mish's guard at 20 and its neighbours, and large
    magnitudes; a seeded upstream gradient."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 5
    edges = torch.tensor([-3.0, 3.0, -2.9999998, -3.0000002, 2.9999998,
                          3.0000002, 20.0, 19.999998, 20.000002, 0.0, -20.0,
                          25.0, -100.0, 100.0])
    x.view(-1)[:edges.numel()] = edges[:x.numel()]
    return x.to(dev), torch.randn(shape, generator=gen).to(dev)


@pytest.mark.parametrize("shape", [(6, 64, 64, 16), (1000003,), (12, 2048)])
@pytest.mark.parametrize("kind", ["mish", "swish", "hswish"])
def test_activation_kernels_against_plain(cuda_device, kind, shape):
    x, g = _act_inputs(shape, cuda_device)
    fwd, bwd = act_fwd(x, kind), act_bwd(x, g, kind)
    want_f, want_b = act_fwd_plain(x, kind), act_bwd_plain(x, g, kind)
    torch.cuda.synchronize()
    if kind == "hswish":
        assert torch.equal(fwd, want_f) and torch.equal(bwd, want_b)
        # f' at -3, 3, -3 + ulp, -3 - ulp, 3 - ulp, 3 + ulp: <= and >=
        # decide the breakpoints
        d = act_bwd(x, torch.ones_like(x), kind).view(-1)[:6].tolist()
        assert d[0] == 0.0 and d[1] == 1.0 and d[3] == 0.0 and d[5] == 1.0
        assert abs(d[2] + 0.5) < 1e-6 and abs(d[4] - 1.5) < 1e-6
    else:
        _within(f"{kind} forward", fwd, want_f)
        _within(f"{kind} backward", bwd, want_b)


@pytest.mark.parametrize("kind", ["mish", "swish", "hswish"])
def test_activation_kernels_unaligned(cuda_device, kind):
    x, g = _act_inputs((4103,), cuda_device)
    xs, gs = x[1:], g[1:]
    _within(f"{kind} forward", act_fwd(xs, kind), act_fwd_plain(xs, kind))
    _within(f"{kind} backward", act_bwd(xs, gs, kind),
            act_bwd_plain(xs, gs, kind))


def test_zoo_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        focal_fwd(x.T, x.T, 2.0, 0.25)
    with pytest.raises(TypeError, match="float32"):
        focal_fwd(x.double(), x.double(), 2.0, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        soft_dice_sums(x.T, x.T, 1.0)
    with pytest.raises(ValueError):
        soft_dice_sums(x, x.cpu(), 1.0)
    with pytest.raises(TypeError, match="int32 or int64"):
        one_hot(x.to(torch.uint8), 8, 0.1, 255)
    with pytest.raises(ValueError, match="contiguous"):
        act_fwd(x.T, "mish")
    with pytest.raises(ValueError, match="unknown activation"):
        act_fwd(x, "gelu")
    with pytest.raises(TypeError, match="float32"):
        act_bwd(x, x.half(), "swish")


def test_loss_zoo_on_the_card_launches_the_kernels(cuda_device):
    """The public losses on CUDA tensors launch their kernels, and their
    values and gradients agree with the same calls on the CPU."""
    import cartseg_tpu_torch.losses as TL

    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((2, 16, 16, 1), generator=gen) * 2
    y = (torch.rand((2, 16, 16, 1), generator=gen) > 0.5).float()
    z = torch.randn((2, 16, 16, 8), generator=gen) * 2
    lab = torch.randint(0, 8, (2, 16, 16), generator=gen)
    lab[0, :2] = 255
    calls = {
        "focal_loss_kernel": lambda a, t, *_: TL.focal_loss_kernel(a, t),
        "soft_dice_loss": lambda a, t, *_: TL.soft_dice_loss(a, t, 2.0),
        "mish": lambda a, *_: TL.mish(a),
        "swish": lambda a, *_: TL.swish(a),
        "hswish": lambda a, *_: TL.hswish(a),
        "taylor_cross_entropy": lambda _a, _t, c, lb: TL.taylor_cross_entropy(
            c, lb, 2, 0.1, 255),
        "lsr_cross_entropy_fused": lambda _a, _t, c, lb:
            TL.lsr_cross_entropy_fused(c, lb, 0.1, 255),
    }
    build.reset_launch_counts()
    for name, fn in calls.items():
        res = {}
        for dev in ("cpu", cuda_device):
            a = x.to(dev).clone().requires_grad_(True)
            c = z.to(dev).clone().requires_grad_(True)
            out = fn(a, y.to(dev), c, lab.to(dev))
            out.sum().backward()
            grad = a.grad if a.grad is not None else c.grad
            res[str(dev)] = (out.detach().cpu(), grad.cpu())
        (o1, g1), (o2, g2) = res.values()
        torch.testing.assert_close(o2, o1, rtol=1e-5, atol=1e-5, msg=name)
        torch.testing.assert_close(g2, g1, rtol=1e-5, atol=1e-5, msg=name)
    assert torch.equal(TL.smooth_one_hot(lab.to(cuda_device), 8, 0.1, 255).cpu(),
                       TL.smooth_one_hot(lab, 8, 0.1, 255))
    for k in ("focal", "soft_dice", "one_hot", "mish_fwd", "mish_bwd",
              "swish_fwd", "swish_bwd", "hswish_fwd", "hswish_bwd",
              "lsr_fwd", "lsr_bwd"):
        assert build.LAUNCHES[k] > 0, k
    build.reset_launch_counts()


@pytest.mark.parametrize("h,w,smooth", [(720, 1280, 0), (720, 1280, 1),
                                        (37, 53, 0), (5, 3, 0), (1, 11, 0)])
def test_bilateral_kernel_bit_equal_plain(cuda_device, h, w, smooth):
    """csrc/bilateral.cu against bilateral_u8_plain on the card: the same
    float32 operations in the same order, bit for bit (noise, and noise
    averaged over 4x4 blocks, whose flat areas put many quotients near a
    half)."""
    x = torch.from_numpy(np.random.default_rng(h + w).integers(
        0, 256, (h, w, 3), np.uint8)).to(cuda_device)
    if smooth:
        x = x.float().permute(2, 0, 1)[None]
        x = torch.nn.functional.avg_pool2d(x, 4, 1, padding=2)[0]
        x = x[:, :h, :w].round().to(torch.uint8).permute(1, 2, 0)
        x = x.contiguous()
    build.reset_launch_counts()
    got = bilateral_u8(x)
    assert build.LAUNCHES["bilateral"] == 1
    want = bilateral_u8_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
