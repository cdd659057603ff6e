"""Port parity: the resnet UNets, both BatchNorm lanes and the
channel-sums op (cartseg_tpu_torch models/{resnet,norm,factory,convert}
.py, ops/channel_sums.py, workloads/train_bce_dice.py) against the JAX
package on the CPU.

The JAX side runs `TpuBatchNorm` as the JAX package's own tests do
(tests/test_models.py:285-359): its `channel_sums` takes the Pallas
kernel in interpret mode where `supported()` holds, XLA elsewhere; a
whole JAX model takes that lane when CARTSEG_PALLAS_BN=force is set
while it is traced. The port's kernel lane takes `channel_sums_plain`
here (CPU tensors).

Tolerances (float32 unless stated):
  * channel sums: 1e-5 of sum |a| and of sum |a*b| per channel (fp32
    accumulation in another order; bf16 inputs are rounded alike on both
    sides, so the same bound);
  * one BN layer against `TpuBatchNorm`: y, batch mean and var, running
    stats rtol/atol 1e-5 (stats atol 1e-6); dx, dgamma, dbeta rtol/atol
    2e-4; bf16 y within 0.05 (JAX's own bf16 test);
  * resnet UNets: eval logits and the 5 encoder stages 2e-4, as
    tests/test_torch_models.py; train-mode logits 2e-4 and running stats
    1e-4 (rtol and atol); the BCE+Dice gradient within 2e-3 relative L2
    as a whole and per leaf holding >= 1e-2 of the largest leaf's norm,
    1e-2 for smaller leaves, or within twice the port's own spread
    between two summation orders where that is larger (a ReLU input
    within roundoff of 0; see `_assert_grads_close`);
  * one Trainer step against the JAX Trainer's: loss rel 1e-4, the
    gradient as above, params after AdamW within 2 lr + 1e-6 (a
    near-zero gradient may take either sign), BN stats 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.torch_smp import SmpUnetTorch
from cartseg_tpu.losses.region import bce_dice_loss as j_bce_dice
from cartseg_tpu.models import build_model as jax_build
from cartseg_tpu.models import param_groups as jax_param_groups
from cartseg_tpu.models.norm import TpuBatchNorm, bn_train
from cartseg_tpu.models.torch_import import export_flax_to_torch_naming
from cartseg_tpu.ops.pallas.channel_sums import (channel_sums_pallas,
                                                 channel_sums_xla, supported)
from cartseg_tpu.train import TrainConfig as JConfig
from cartseg_tpu.train import Trainer as JTrainer
from cartseg_tpu.train.engine import TrainState as JState
from cartseg_tpu.train.optim import group_id_tree, init_adamw
from cartseg_tpu.workloads import train_bce_dice as j_workload

from cartseg_tpu_torch.losses.region import bce_dice_loss
from cartseg_tpu_torch.models import build_model
from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict
from cartseg_tpu_torch.models.norm import (BatchNorm2d, BNTrain,
                                           ChannelSumsBatchNorm2d,
                                           batch_norm)
from cartseg_tpu_torch.ops.channel_sums import (channel_sums,
                                                channel_sums_plain)
from cartseg_tpu_torch.ops.cuda.channel_sums import (BLOCKS_PER_SM,
                                                     FINISH_FLOATS,
                                                     MIN_COLUMN_BYTES, SMS,
                                                     THREADS, memory_order,
                                                     plan)
from cartseg_tpu_torch.train import TrainConfig as TConfig
from cartseg_tpu_torch.train import Trainer as TTrainer
from cartseg_tpu_torch.workloads import _runner
from cartseg_tpu_torch.workloads import train_bce_dice as t_workload
from torch_port_helpers import (jax_train_state_to_port,  # noqa: F401
                                jax_tree_to_numpy, load_jax_state_into_port,
                                one_torch_thread, pinned_jax_native,
                                png_pair_tree)

HW, BS = 64, 2
LANES = ("torch", "channel_sums")
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _nchw(x_nhwc: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> an NCHW view of a channels_last tensor."""
    return torch.from_numpy(np.array(x_nhwc)).to(dtype).permute(0, 3, 1, 2)


# --------------------------------------------------------- channel sums

@functools.lru_cache(maxsize=None)
def _jax_sums(shape, same: bool, dtype: str):
    """(numpy a, numpy b as rounded to dtype, [(lane, sums)]) from JAX:
    the XLA lane, and the Pallas kernel (interpret mode) where
    `supported` holds."""
    r = np.random.default_rng([*shape, int(same)])
    a = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    b = a if same else r.standard_normal(shape).astype(np.float32)
    ja = jnp.asarray(a, _JDT[dtype])
    jb = ja if same else jnp.asarray(b, _JDT[dtype])
    lanes = [("xla", channel_sums_xla(ja, jb))]
    if supported(shape):
        lanes.append(("pallas", channel_sums_pallas(ja, jb)))
    return (np.asarray(ja, np.float32), np.asarray(jb, np.float32),
            [(k, tuple(np.asarray(s) for s in v)) for k, v in lanes])


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("shape", [(8, 16, 16, 16),    # Pallas lane
                                   (2, 5, 7, 3)])      # XLA lane
def test_channel_sums_plain_matches_jax(shape, same, dtype, layout):
    a, b, lanes = _jax_sums(shape, same, dtype)
    assert [k for k, _ in lanes] == (["xla", "pallas"] if supported(shape)
                                     else ["xla"])
    ta = _nchw(a, _TDT[dtype])          # channels_last memory
    tb = ta if same else _nchw(b, _TDT[dtype])
    if layout == "contiguous":
        ta, tb = ta.contiguous(), tb.contiguous()
        assert memory_order(ta) == "nchw"
    else:
        assert memory_order(ta) == "nhwc"
    got = channel_sums(ta, tb)
    plain = channel_sums_plain(ta, tb)
    tol = (1e-5 * np.abs(a).sum((0, 1, 2)),
           1e-5 * np.abs(a * b).sum((0, 1, 2)))
    for i, (g, p, t) in enumerate(zip(got, plain, tol)):
        assert g.dtype == torch.float32 and g.shape == (shape[-1],)
        assert torch.equal(g, p)          # CPU tensors take the plain lane
        for name, want in lanes:
            np.testing.assert_array_less(np.abs(g.numpy() - want[i]), t,
                                         err_msg=name)


@pytest.mark.parametrize("shape,nhwc,dtypes,vec,ctas", [
    ((6, 16, 512, 512), True, (torch.bfloat16,) * 2, 8, 528),  # decoder top
    ((6, 16, 512, 512), False, (torch.bfloat16,) * 2, 8, 528),
    ((6, 64, 256, 256), True, (torch.float32,) * 2, 4, 528),
    ((6, 64, 256, 256), True, (torch.bfloat16, torch.float32), 4, 528),
    ((2, 3, 7, 5), True, (torch.float32,) * 2, 1, 1),         # C=3
    ((2, 3, 7, 5), False, (torch.bfloat16,) * 2, 1, 3),       # odd H*W
    ((128, 512, 7, 7), True, (torch.bfloat16,) * 2, 8, 192),
    ((2, 16, 8192, 8192), False, (torch.bfloat16,) * 2, 8, 528),
    ((6, 512, 16, 16), True, (torch.bfloat16,) * 2, 8, 48),    # layer4
    ((6, 256, 32, 32), True, (torch.bfloat16,) * 2, 8, 96),    # layer3
    ((6, 128, 64, 64), True, (torch.bfloat16,) * 2, 8, 192),   # layer2
    ((6, 64, 128, 128), True, (torch.bfloat16,) * 2, 8, 384),  # layer1
    ((1, 16, 1, 1), True, (torch.float32,) * 2, 4, 1),
    ((2, 4096, 3, 3), True, (torch.bfloat16,) * 2, 8, 4)])
def test_kernel_plan_takes_every_shape(shape, nhwc, dtypes, vec, ctas):
    """The launch plan the wrapper hands the kernel: 16-byte loads where
    the contiguous extent and the pointers allow; CTAs sized from the
    bytes, MIN_LOADS loads a thread (so a few dozen on layer4's 1.5 MB),
    one wave of BLOCKS_PER_SM an SM at most (the stem, the decoder top);
    NHWC columns of a power-of-two tc group lanes that cover every channel
    group, narrowed while the finishing CTA would read more than
    FINISH_FLOATS partials; every row or element covered. A misaligned
    pointer takes one element at a time."""
    p = plan(shape, nhwc, dtypes, (256, 512))
    assert p.vec == vec and p.nhwc == nhwc
    assert p.P >= 1 and p.P * p.gy == ctas
    assert ctas <= SMS * BLOCKS_PER_SM
    N, C, H, W = shape
    if nhwc:
        G, M = C // vec, N * H * W
        assert p.tc & (p.tc - 1) == 0 and p.tc <= THREADS
        assert p.gy == -(-G // p.tc) and (p.gy - 1) * p.tc < G
        assert p.P * -(-M // p.P) >= M and p.P <= -(-M // p.rows)
        assert (p.P * 2 * p.width <= FINISH_FLOATS or p.tc == 1
                or p.tc // 2 * vec * min(d.itemsize for d in dtypes)
                < MIN_COLUMN_BYTES)
    else:
        assert (H * W) % p.vec == 0 and p.gy == C
        assert p.P <= max(1, -(-N * H * W // (THREADS * vec)))
    assert plan(shape, nhwc, dtypes, (2, 512)).vec == 1


@pytest.mark.parametrize("shape,sms,steps", [
    ((6, 512, 16, 16), 132, 8),      # layer4: 48 CTAs, two unrolled rounds
    ((6, 16, 512, 512), 132, 24),    # decoder top: one wave, 6 rounds
    ((6, 32, 256, 256), 132, 12),    # three rounds
    ((2, 24, 8, 8), 132, 2),         # the remainder loop alone
    ((6, 64, 128, 130), 16, 49)])    # 12 rounds and a remainder of 1
def test_kernel_plan_sizes_the_rows_a_lane_walks(shape, sms, steps):
    """NHWC bf16: each row lane walks ceil(ceil(M / P) / R) rows, UNROLL
    independent loads at a time and the rest one by one; layer4's plan
    keeps MIN_LOADS a thread, and a card with fewer SMs gives each CTA
    more rows."""
    p = plan(shape, True, (torch.bfloat16,) * 2, (256, 512), sms)
    N, C, H, W = shape
    M = N * H * W
    assert -(-(-(-M // p.P)) // p.rows) == steps
    assert p.P * p.gy <= sms * BLOCKS_PER_SM


# ------------------------------------------------------ one BN layer

def _bn_params(C: int, r):
    return {"scale": (1.5 + r.standard_normal(C)).astype(np.float32),
            "bias": r.standard_normal(C).astype(np.float32),
            "mean": (0.1 * r.standard_normal(C)).astype(np.float32),
            "var": (r.random(C) * 0.5 + 0.75).astype(np.float32)}


def _port_bn(p, C: int) -> ChannelSumsBatchNorm2d:
    bn = batch_norm(C, 1e-5, "channel_sums")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))
    return bn


def _jax_bn_vars(p):
    return {"params": {"scale": jnp.asarray(p["scale"]),
                       "bias": jnp.asarray(p["bias"])},
            "batch_stats": {"mean": jnp.asarray(p["mean"]),
                            "var": jnp.asarray(p["var"])}}


@pytest.mark.parametrize("shape", [(8, 16, 16, 16), (2, 5, 7, 3)])
def test_kernel_lane_bn_forward_stats_and_eval_match_tpu_batch_norm(shape):
    r = np.random.default_rng(3)
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    p = _bn_params(shape[-1], r)
    jbn = TpuBatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = _jax_bn_vars(p)
    jy, upd = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    _, jmean, jvar = bn_train(jnp.asarray(x), v["params"]["scale"],
                              v["params"]["bias"], 1e-5)
    bn = _port_bn(p, shape[-1]).train()
    ty = bn(_nchw(x))
    _, tmean, tvar = BNTrain.apply(_nchw(x), bn.weight, bn.bias, 1e-5)
    np.testing.assert_allclose(ty.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-5, atol=1e-5)
    for t, j in ((tmean, jmean), (tvar, jvar)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    for t, k in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    # eval mode on the updated statistics
    jeval = TpuBatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5)
    je = jeval.apply({"params": v["params"],
                      "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    with torch.no_grad():
        te = bn.eval()(_nchw(x))
    np.testing.assert_allclose(te.permute(0, 2, 3, 1).numpy(),
                               np.asarray(je), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 16, 16, 16), (2, 5, 7, 3)])
def test_kernel_lane_bn_grads_match_tpu_batch_norm(shape):
    r = np.random.default_rng(4)
    x = r.standard_normal(shape).astype(np.float32)
    w = r.standard_normal(shape).astype(np.float32)
    p = _bn_params(shape[-1], r)
    jbn = TpuBatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = _jax_bn_vars(p)

    def loss(xx, params):
        y, _ = jbn.apply({"params": params,
                          "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])
        return jnp.sum(y * w)

    jdx, jdp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), v["params"])
    bn = _port_bn(p, shape[-1]).train()
    tx = _nchw(x).requires_grad_(True)
    (bn(tx) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jdx), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(jdp["scale"]), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(jdp["bias"]), rtol=2e-4,
                               atol=2e-4)


def test_kernel_lane_bn_bf16_close_to_tpu_batch_norm():
    r = np.random.default_rng(5)
    shape = (8, 8, 16, 32)
    x = r.standard_normal(shape).astype(np.float32)
    p = _bn_params(shape[-1], r)
    jbn = TpuBatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.bfloat16)
    jy, _ = jbn.apply(_jax_bn_vars(p), jnp.asarray(x),
                      mutable=["batch_stats"])
    ty = _port_bn(p, shape[-1]).train()(_nchw(x, torch.bfloat16))
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    np.testing.assert_allclose(
        ty.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(jy, np.float32), rtol=0.05, atol=0.05)


# ------------------------------------------------------- resnet UNets

@functools.lru_cache(maxsize=None)
def _jax_resnet(encoder: str, seed: int):
    """(flax model, numpy variables): the JAX model's variable tree (its
    init traced by eval_shape, not compiled) filled with numpy draws from
    `seed`: conv kernels N(0, 2/fan_in), biases 0.1 N, BN scale 1 + 0.1 N,
    bias 0.1 N, running mean 0.1 N, running var U(0.75, 1.25)."""
    model = jax_build(encoder)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    r = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        z = r.standard_normal(s.shape)
        if leaf == "kernel":
            a = z * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * z
        elif leaf == "var":
            a = r.random(s.shape) * 0.5 + 0.75
        else:
            a = 0.1 * z
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, jax_tree_to_numpy(v)


def _port_resnet(encoder: str, lane: str, v) -> torch.nn.Module:
    model = build_model(encoder, bn_lane=lane)
    model.load_state_dict(jax_variables_to_state_dict(v, encoder))
    return model


def _batch(seed: int, hw: int = HW):
    r = np.random.default_rng(seed)
    x = r.standard_normal((BS, hw, hw, 3)).astype(np.float32)
    yy, xx = np.mgrid[:hw, :hw]
    m = np.zeros((BS, hw, hw, 1), np.float32)
    m[0, ..., 0] = (yy - 30) ** 2 + (xx - 26) ** 2 <= 15 ** 2
    m[1, 10:40, 20:50, 0] = 1.0
    return x, m


@functools.lru_cache(maxsize=None)
def _jax_eval(encoder: str, hw: int):
    model, v = _jax_resnet(encoder, 0)
    x, _ = _batch(1, hw)
    enc_v = {"params": v["params"]["encoder"],
             "batch_stats": v["batch_stats"]["encoder"]}
    logits, stages = jax.jit(lambda v, ev, x: (
        model.apply(v, x, train=False),
        model.encoder.apply(ev, x, train=False)))(v, enc_v, jnp.asarray(x))
    return x, np.asarray(logits), [np.asarray(s) for s in stages]


@pytest.mark.parametrize("lane", LANES)
def test_resnet18_unet_eval_logits_and_stages_match_jax(lane):
    x, want, stages = _jax_eval("resnet18", HW)
    model = _port_resnet("resnet18", lane, _jax_resnet("resnet18", 0)[1])
    with torch.no_grad():
        got = model.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
        feats = model.encoder(_nchw(x))
    assert got.shape == want.shape == (BS, HW, HW, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    assert len(feats) == len(stages) == 5
    for g, w in zip(feats, stages):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=2e-4, rtol=2e-4)


@functools.lru_cache(maxsize=None)
def _jax_train_grad():
    """One train-mode BCE+Dice forward and gradient of the JAX resnet18
    UNet with `TpuBatchNorm` (CARTSEG_PALLAS_BN=force while the function
    is traced)."""
    model, v = _jax_resnet("resnet18", 0)
    x, m = _batch(2)

    def loss(params, stats, x, m):
        out, upd = model.apply({"params": params, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        return j_bce_dice(out, m, 0.5, 1.0), (out, upd["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("CARTSEG_PALLAS_BN", "force")
        (lv, (out, stats)), grads = fn(v["params"], v["batch_stats"],
                                       jnp.asarray(x), jnp.asarray(m))
    finally:
        mp.undo()
    return (float(lv), np.asarray(out),
            jax_variables_to_state_dict(jax_tree_to_numpy(
                {"params": v["params"], "batch_stats": stats}), "resnet18"),
            {k: t.numpy() for k, t in jax_variables_to_state_dict(
                {"params": jax_tree_to_numpy(grads)}, "resnet18").items()})


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_grads_close(got: dict, want: dict, alt: dict):
    """got, alt: the port's gradient summed in two orders (one and four
    CPU threads); want: JAX's. Every leaf holding >= 1e-2 of the largest
    leaf's norm, and the whole gradient, within 2e-3 relative L2 of JAX
    or within twice the port's own spread between the two orders,
    whichever is larger; smaller leaves within 1e-2 (or twice the
    spread); leaves under 1e-6 of the largest are roundoff. 2e-3, not
    1e-3: the JAX `TpuBatchNorm` lane's var = E[x^2] - mean^2 cancels,
    and its gradient sits about 1e-3 from JAX's own flax lane on these
    inputs. The spread is the yardstick beyond that because a ReLU
    whose input lies within roundoff of 0 passes or stops its gradient
    depending on the summation order, and train-mode BN over the 8
    values of a layer4 channel spreads that to every leaf upstream: one
    such flip moves the whole gradient far beyond roundoff, while a
    wrong gradient is off by O(1)."""
    top = max(np.linalg.norm(w) for w in want.values())
    bad = {}
    for k, w in want.items():
        n = np.linalg.norm(w) / top
        e, spread = _rel(got[k], w), _rel(alt[k], got[k])
        if n >= 1e-6 and e > max(2e-3 if n >= 1e-2 else 1e-2, 2 * spread):
            bad[k] = (e, spread)
    assert not bad, bad

    def whole(d):
        return np.concatenate([d[k].ravel() for k in want])

    e = _rel(whole(got), whole(want))
    spread = _rel(whole(alt), whole(got))
    assert e <= max(2e-3, 2 * spread), (e, spread)


def _port_train_grad(lane: str, threads: int):
    """(model after one train-mode forward, loss, logits NHWC, gradient
    by name) of the port's resnet18 UNet, summed on `threads` threads."""
    model = _port_resnet("resnet18", lane, _jax_resnet("resnet18", 0)[1])
    x, m = _batch(2)
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        out = model.train()(_nchw(x)).permute(0, 2, 3, 1)
        loss = bce_dice_loss(out, torch.from_numpy(m), 0.5, 1.0)
        loss.backward()
    finally:
        torch.set_num_threads(before)
    return (model, float(loss.detach()), out.detach().numpy(),
            {k: p.grad.numpy() for k, p in model.named_parameters()})


@pytest.mark.parametrize("lane", LANES)
def test_resnet18_unet_train_step_matches_jax_tpu_batch_norm(lane):
    """Train-mode logits, the running statistics after the forward and
    the BCE+Dice gradient of both port lanes against the JAX model in
    its `TpuBatchNorm` lane (the flax lane: the Trainer step below)."""
    loss, logits, stats, grads = _jax_train_grad()
    model, tl, out, got = _port_train_grad(lane, 1)
    assert tl == pytest.approx(loss, rel=1e-5)
    np.testing.assert_allclose(out, logits, rtol=2e-4, atol=2e-4)
    sd = model.state_dict()
    n_stats = 0
    for k, w in stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
            n_stats += 1
    assert n_stats == 2 * sum(isinstance(mod, torch.nn.BatchNorm2d)
                              for mod in model.modules())
    _assert_grads_close(got, grads, _port_train_grad(lane, 4)[3])


def test_resnet34_bridge_equals_jax_export_and_reference_naming():
    """Bit for bit the JAX package's exporter; the key set and shapes of
    the reference checkpoints (benchmarks/torch_smp.py), whose state
    dict loads strictly in either lane."""
    _, v = _jax_resnet("resnet34", 0)
    ours = jax_variables_to_state_dict(v, "resnet34")
    ref = export_flax_to_torch_naming(v, "resnet34")
    assert set(ours) == set(ref)
    for k, t in ours.items():
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)
    smp = SmpUnetTorch("resnet34").state_dict()
    for lane in LANES:
        model = build_model("resnet34", bn_lane=lane)
        sd = model.state_dict()
        assert set(sd) == set(smp)
        assert all(sd[k].shape == smp[k].shape for k in sd)
        model.load_state_dict(smp)
        model.load_state_dict(ours, strict=False)
    assert set(smp) - set(ours) == {k for k in smp
                                    if k.endswith("num_batches_tracked")}


def test_resnet34_unet_eval_matches_jax():
    x, want, _ = _jax_eval("resnet34", 32)
    model = _port_resnet("resnet34", "channel_sums",
                         _jax_resnet("resnet34", 0)[1])
    with torch.no_grad():
        got = model.eval()(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("encoder", ["resnet34", "resnet18",
                                     "efficientnet-b0"])
@pytest.mark.parametrize("lane", LANES)
def test_factory_puts_every_bn_in_the_lane(encoder, lane):
    model = build_model(encoder, bn_lane=lane)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    want = BatchNorm2d if lane == "torch" else ChannelSumsBatchNorm2d
    assert bns and all(type(m) is want for m in bns)
    if encoder == "resnet34":
        assert len(bns) == 46          # 36 in the encoder, 10 decoder
    with pytest.raises(ValueError, match="lane"):
        build_model(encoder, bn_lane="pallas")


# ------------------------------------------------ one Trainer step

def _step_cfg(**kw):
    return dict(encoder="resnet18", img_size=(HW, HW), batch_size=BS,
                compute_dtype="float32", augment="none", use_mesh=False,
                imagenet_norm=False, lr=1e-4, loss=j_workload.CONFIG.loss,
                **kw)


def _step_inputs():
    r = np.random.default_rng(5)
    imgs = r.integers(0, 256, (BS, HW, HW, 3)).astype(np.uint8)
    _, m = _batch(0)
    imgs[m[..., 0] > 0] //= 3                     # the object is darker
    return imgs, m


@functools.lru_cache(maxsize=None)
def _jax_trainer_step():
    """The JAX Trainer's compiled step (flax BN lane) on the resnet18
    config from the numpy variables, as the port's state before and
    after it."""
    jtr = JTrainer(JConfig(**_step_cfg(out_dir="/nonexistent")))
    _, v = _jax_resnet("resnet18", 7)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = JState(params=params,
                   batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                      v["batch_stats"]),
                   opt=init_adamw(params), step=jnp.zeros((), jnp.int32))
    gids = group_id_tree(jax_param_groups(state.params))
    imgs, m = _step_inputs()
    before = jax_train_state_to_port(state, "resnet18")
    state, loss, ok, _ = jtr._train_step_fn()(
        state, jnp.asarray(imgs), jnp.asarray(m), jnp.ones((BS,)),
        jax.random.key(0), jnp.asarray([1e-4, 2e-4, 3e-4]),
        jnp.ones((3,)), gids)
    return before, jax_train_state_to_port(state, "resnet18"), float(loss)


def _port_trainer_step(lane: str, threads: int):
    """The port Trainer's step from the JAX state before the JAX step,
    summed on `threads` threads: (state, loss, ok)."""
    before, _, _ = _jax_trainer_step()
    tr = TTrainer(TConfig(**_step_cfg(out_dir="/nonexistent",
                                      device="cpu")), bn_lane=lane)
    st = tr.init_state()
    load_jax_state_into_port(st, before)
    imgs, m = _step_inputs()
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        tl, ok, _ = tr.train_step(st, torch.from_numpy(imgs),
                                  torch.from_numpy(m), torch.ones(BS),
                                  [1e-4, 2e-4, 3e-4], [1.0] * 3,
                                  tr.group_ids(st))
    finally:
        torch.set_num_threads(old)
    return st, float(tl), float(ok)


@pytest.mark.parametrize("lane", LANES)
def test_trainer_step_matches_the_jax_trainer(lane):
    """Loss, gradient (the first moment after one step from zero is 0.1
    times the gradient), params after AdamW, BN stats and step counts."""
    _, after, loss = _jax_trainer_step()
    st, tl, ok = _port_trainer_step(lane, 1)
    alt, _, _ = _port_trainer_step(lane, 4)
    assert ok == 1.0
    assert tl == pytest.approx(loss, rel=1e-4)
    _assert_grads_close({k: v.numpy() for k, v in st.opt.mu.items()},
                        after["mu"],
                        {k: v.numpy() for k, v in alt.opt.mu.items()})
    sd = st.model.state_dict()
    for k, w in after["state_dict"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                       atol=2 * 3e-4 + 1e-6, err_msg=k)
    np.testing.assert_array_equal(st.opt.count.numpy(), after["count"])


# ------------------------------------------------------------ workload

def test_workload_config_equals_the_jax_literal():
    port = dataclasses.asdict(t_workload.CONFIG)
    assert port.pop("device") == "cuda"
    assert port == dataclasses.asdict(j_workload.CONFIG)


@pytest.mark.parametrize("value,lane", [
    (None, "torch"), ("0", "torch"), ("true", "torch"),
    ("1", "channel_sums"), ("force", "channel_sums")])
def test_entry_point_reads_the_jax_switch(value, lane):
    env = {} if value is None else {"CARTSEG_PALLAS_BN": value}
    assert _runner.bn_lane_from_env(env) == lane


@pytest.mark.parametrize("value,lane", [(None, "torch"),
                                        ("force", "channel_sums")])
def test_entry_point_hands_the_lane_to_the_trainer(monkeypatch, value, lane):
    seen = []

    class Recorder:
        def __init__(self, cfg, bn_lane):
            seen.append((cfg.encoder, bn_lane))

        def fit(self, log):
            return {"best_val_dice": 0.0, "threshold": 0.5,
                    "images_per_sec": 0.0}

    if value is None:
        monkeypatch.delenv("CARTSEG_PALLAS_BN", raising=False)
    else:
        monkeypatch.setenv("CARTSEG_PALLAS_BN", value)
    monkeypatch.setattr(_runner, "Trainer", Recorder)
    t_workload.main(["--device", "cpu"])
    assert seen == [("resnet34", lane)]


def test_workload_cpu_run_writes_the_artifacts(png_pair_tree, tmp_path,
                                               monkeypatch):
    """A CPU run through the entry point on the synthetic tree, with
    CARTSEG_PALLAS_BN=force: the `basic` CSV, model.pth, its threshold
    sidecar and model.last.pth, and only kernel-lane BNs."""
    monkeypatch.setenv("CARTSEG_PALLAS_BN", "force")
    ir, mr = png_pair_tree
    result = t_workload.main(
        ["--images_root", str(ir), "--masks_root", str(mr),
         "--out_dir", str(tmp_path), "--img_size", str(HW),
         "--batch_size", str(BS), "--epochs", "1", "--device", "cpu"],
        log=lambda m: None)
    rows = (tmp_path / "training_metrics.csv").read_text().splitlines()
    assert rows[0] == "epoch,train_loss,val_loss,val_dice,val_iou"
    assert len(rows) == 2
    assert all(np.isfinite(float(x)) for x in rows[1].split(","))
    for f in ("model.pth", "model.threshold.json", "model.last.pth"):
        assert (tmp_path / f).exists(), f
    assert 0.2 <= result["threshold"] <= 0.8
    bns = [m for m in result["state"].model.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 46
    assert all(type(m) is ChannelSumsBatchNorm2d for m in bns)
