"""Port parity: mixed-source fine-tuning (cartseg_tpu_torch data/
sampling.py, train/engine.py's mixed mode, the four finetune workloads),
`remat` and `trace_dir`, against the JAX package on the CPU.

Bit-equal: the sampling functions and WeightedSampler's orders, the
mixed split (pairs, val pairs, src_of_global, sampler weights), each
batch's sample weights in a fit with the curriculum, the workloads'
CONFIG literals, and a resumed mixed run against an uninterrupted one.
One bce_dice_per_sample train step of a resnet18 UNet with non-uniform
sample weights at tests/test_torch_train.py's step tolerances (loss rel
1e-4; the gradient, read from the first AdamW moment, within 1e-3
relative L2, or, where float32 roundoff is larger in this ill-
conditioned model, within twice the port's own distance from its
float64 gradient; params after AdamW within 2 lr + 1e-6; BN running
stats rtol 1e-4 / atol 1e-5). A remat step against the plain step:
loss, gradients and BN running stats within 1e-6 in both BN lanes.
"""

import csv
import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.data import sampling as JS
from cartseg_tpu.models import param_groups as jax_param_groups
from cartseg_tpu.train import TrainConfig as JConfig
from cartseg_tpu.train import Trainer as JTrainer
from cartseg_tpu.train.engine import TrainState as JState
from cartseg_tpu.train.optim import group_id_tree, init_adamw

from cartseg_tpu_torch.data import sampling as TS
from cartseg_tpu_torch.models.norm import BN_LANES
from cartseg_tpu_torch.train import TrainConfig as TConfig
from cartseg_tpu_torch.train import Trainer as TTrainer
from cartseg_tpu_torch.train.engine import SCHEMAS
from cartseg_tpu_torch.utils.profiling import TRACE_NAME, maybe_trace
from torch_port_helpers import (jax_train_state_to_port,  # noqa: F401
                                one_torch_thread)

HW, BS = 64, 2
FINETUNES = ("finetune_bce_dice_abl", "finetune_pseudo",
             "finetune_pseudo_hard_clean", "finetune_for_224")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _plain(v):
    if isinstance(v, list):
        return [_plain(x) for x in v]
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _workloads(name):
    return (importlib.import_module(f"cartseg_tpu.workloads.{name}"),
            importlib.import_module(f"cartseg_tpu_torch.workloads.{name}"))


# ------------------------------------------------------------ sampling

@pytest.mark.parametrize("seed,epoch", [(42, 0), (42, 1), (1337, 5),
                                        (0, 19)])
def test_weighted_sampler_orders_bit_equal(seed, epoch):
    r = np.random.default_rng(seed + epoch)
    w = r.random(37) * np.repeat([3.0, 1.0, 0.5], [10, 12, 15])
    j = JS.WeightedSampler(w, 40, seed).epoch(epoch)
    t = TS.WeightedSampler(w, 40, seed).epoch(epoch)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)


def test_sampling_functions_bit_equal():
    spec = [("hard", 22, 0.5, 1.0), ("clean", 0, 0.25, 1.0),
            ("pseudo", 7, 0.25, 0.4)]
    js = [JS.MixedSource(*s) for s in spec]
    ts = [TS.MixedSource(*s) for s in spec]
    np.testing.assert_array_equal(TS.mixed_sample_weights(ts),
                                  JS.mixed_sample_weights(js))
    assert TS.mixed_index_table(ts) == JS.mixed_index_table(js)
    np.testing.assert_array_equal(TS.oversample_weights([3, 4], [2.0, 1.0]),
                                  JS.oversample_weights([3, 4], [2.0, 1.0]))
    for e in range(6):
        for args in ((), (0.4, 0.6, 4), (0.1, 0.9, 0), (1.0, 0.5, 3)):
            assert TS.curriculum_weight(e, *args) == \
                JS.curriculum_weight(e, *args)


# ----------------------------------------------------- mixed datasets

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Three mirrored PNG sources (hard, clean, pseudo) of 2 sessions x
    3 frames of 64x50 (letterboxed to exactly 64^2), each from its own
    seed, and a sources.json with finetune_for_224's ratios and loss
    weights."""
    from cartseg_tpu_torch.utils.synthetic import make_png_pair_tree

    root = tmp_path_factory.mktemp("sources")
    specs = []
    for i, (name, ratio, lw) in enumerate([("hard", 0.5, 1.0),
                                           ("clean", 0.25, 1.0),
                                           ("pseudo", 0.25, 0.4)]):
        ir, mr = make_png_pair_tree(root / name, 2, 3, (HW, 50), seed=i)
        specs.append({"name": name, "images_root": str(ir),
                      "masks_root": str(mr), "ratio": ratio,
                      "loss_weight": lw})
    (root / "sources.json").write_text(json.dumps(specs))
    return root / "sources.json"


@pytest.mark.parametrize("val_source", ["hard", "pseudo", None, "nope"])
def test_mixed_split_bit_equal(sources, val_source, tmp_path):
    """The mixed build_datasets of both engines: train and val pairs,
    src_of_global, sampler weights and three epochs' orders. A
    val_source that names no source falls back to the first, as JAX."""
    kw = dict(sources_json=str(sources), val_source=val_source,
              img_size=(HW, HW), val_frac=0.34, seed=7,
              out_dir=str(tmp_path))
    jtr, jv, js, jsrc = JTrainer(JConfig(use_mesh=False, **kw)
                                 ).build_datasets()
    ttr, tv, ts, tsrc = TTrainer(TConfig(device="cpu", **kw)
                                 ).build_datasets()
    assert [p.astuple() for p in ttr.pairs] == [p.astuple() for p in jtr.pairs]
    assert [p.astuple() for p in tv.pairs] == [p.astuple() for p in jv.pairs]
    assert len(tv) == 2 and len(ttr) == 16
    vi = {"pseudo": 2}.get(val_source, 0)
    assert all(p.image.is_relative_to(sources.parent / ("hard", "clean",
                                                        "pseudo")[vi])
               for p in tv.pairs)
    assert tsrc.dtype == jsrc.dtype
    np.testing.assert_array_equal(tsrc, jsrc)
    np.testing.assert_array_equal(ts.p, js.p)
    assert ts.num_samples == js.num_samples == 16
    for e in range(3):
        np.testing.assert_array_equal(ts.epoch(e), js.epoch(e))


def test_oversampling_folds_into_the_weights(sources, tmp_path):
    """hard x2 (finetune_pseudo_hard_clean): ratio / len cancels the
    lengths, so hard holds 2/3 of the probability."""
    specs = json.loads(sources.read_text())[:2]
    specs[0].update(ratio=1.0, oversample=2.0)
    specs[1]["ratio"] = 1.0
    (tmp_path / "s.json").write_text(json.dumps(specs))
    kw = dict(sources_json=str(tmp_path / "s.json"), img_size=(HW, HW),
              val_frac=0.12, out_dir=str(tmp_path))
    _, _, js, jsrc = JTrainer(JConfig(use_mesh=False, **kw)).build_datasets()
    _, _, ts, tsrc = TTrainer(TConfig(device="cpu", **kw)).build_datasets()
    np.testing.assert_array_equal(ts.p, js.p)
    assert float(ts.p[tsrc == 0].sum()) == pytest.approx(2 / 3)


# ------------------------------------------------------- fit and resume

def _run(name, sources, out, *extra, spy=None):
    _, t_mod = _workloads(name)
    argv = ["--sources_json", str(sources), "--out_dir", str(out),
            "--device", "cpu", "--img_size", str(HW), "--batch_size",
            str(BS), "--epochs", "2", "--num_threads", "2",
            "--log_throughput", "false", *extra]
    if spy is None:
        return t_mod.main(argv, log=lambda *a: None)
    orig = TTrainer.train_step

    def record(self, state, imgs, masks, sample_w, *a):
        spy.append(sample_w.clone())
        return orig(self, state, imgs, masks, sample_w, *a)

    TTrainer.train_step = record
    try:
        return t_mod.main(argv, log=lambda *a: None)
    finally:
        TTrainer.train_step = orig


@pytest.fixture(scope="module")
def for_224_run(sources, tmp_path_factory):
    """finetune_for_224 for 2 epochs at 64^2 bs2 with a trace_dir, each
    step's sample weights recorded."""
    out = tmp_path_factory.mktemp("for_224")
    seen = []
    res = _run("finetune_for_224", sources, out, "--trace_dir",
               str(out / "trace"), spy=seen)
    return out, res, seen


def _jax_sample_weights(sources, tmp_path, epochs):
    """Each batch's weights as the JAX engine forms them
    (engine.py:505-523): w_epoch[src_of_global[order[batch]]]."""
    j_mod, _ = _workloads("finetune_for_224")
    cfg = dataclasses.replace(j_mod.CONFIG, sources_json=str(sources),
                              img_size=(HW, HW), batch_size=BS,
                              use_mesh=False, out_dir=str(tmp_path))
    jt = JTrainer(cfg)
    train_ds, _, sampler, src = jt.build_datasets()
    cfg = jt.cfg
    base_w = np.asarray([s.loss_weight for s in cfg.sources], np.float32)
    out = []
    for epoch in range(epochs):
        order = sampler.epoch(epoch)
        w_epoch = base_w.copy()
        w_epoch[-1] = JS.curriculum_weight(epoch, cfg.pseudo_w_start,
                                           cfg.pseudo_w_end,
                                           cfg.pseudo_ramp_epochs)
        for bi in range(len(order) // BS):
            out.append(w_epoch[src[order[bi * BS:(bi + 1) * BS]]])
    return out


def test_sample_weights_bit_equal_with_the_curriculum(sources, for_224_run,
                                                      tmp_path):
    _, res, seen = for_224_run
    want = _jax_sample_weights(sources, tmp_path, 2)
    assert len(seen) == len(want) == res["state"].step == 16
    for t, w in zip(seen, want):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), w)
    # the pseudo weight on the ramp: 0.45 in epoch 1, 0.5 in epoch 2
    vals = [set(np.concatenate([s.numpy() for s in seen[e * 8:(e + 1) * 8]])
                .tolist()) for e in range(2)]
    assert vals == [{1.0, float(np.float32(0.45))}, {1.0, 0.5}]


def test_for_224_writes_its_artifacts(for_224_run):
    out, res, _ = for_224_run
    with open(out / "training_metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == SCHEMAS["basic"] and len(rows) == 3
    for f in ("history.json", "model.pth", "model.threshold.json",
              "model.last.pth"):
        assert (out / f).exists(), f
    side = json.loads((out / "model.threshold.json").read_text())
    assert side["threshold"] == pytest.approx(res["threshold"])
    assert round(side["threshold"] / 0.05) in range(1, 20)


def test_trace_dir_traces_epoch_0_only(for_224_run):
    """One Chrome trace, of epoch 0, in a 2-epoch run; a run resumed at
    epoch 1 writes none."""
    out, _, _ = for_224_run
    assert [p.name for p in (out / "trace").iterdir()] == [TRACE_NAME]
    events = json.loads((out / "trace" / TRACE_NAME).read_text())[
        "traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


def test_mixed_resume_equals_an_uninterrupted_run(sources, for_224_run,
                                                  tmp_path):
    """stop_after_epoch 1, then resume: the same CSV rows, sample
    weights and best weights as the uninterrupted run (the sampler is
    keyed by epoch); the resumed run, at epoch 1, writes no trace."""
    a, ra, seen_a = for_224_run
    seen_b = []
    rb1 = _run("finetune_for_224", sources, tmp_path, "--stop_after_epoch",
               "1", spy=seen_b)
    assert rb1["interrupted"] is True
    rb = _run("finetune_for_224", sources, tmp_path, "--resume",
              "--trace_dir", str(tmp_path / "trace"), spy=seen_b)
    assert not (tmp_path / "trace").exists()
    assert (a / "training_metrics.csv").read_text() == \
        (tmp_path / "training_metrics.csv").read_text()
    assert len(seen_b) == len(seen_a)
    for x, y in zip(seen_a, seen_b):
        assert torch.equal(x, y)
    assert ra["threshold"] == rb["threshold"]
    sa = torch.load(a / "model.pth", weights_only=False)["model_state_dict"]
    sb = torch.load(tmp_path / "model.pth",
                    weights_only=False)["model_state_dict"]
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("name", [n for n in FINETUNES
                                  if n != "finetune_for_224"])
def test_finetune_cli_writes_its_artifacts(name, sources, for_224_run,
                                           tmp_path):
    """The other three CLIs for 1 epoch at 64^2 bs2 on the CPU: the CSV
    in the workload's schema, history, .pth, sidecar, .last.pth;
    finetune_pseudo_hard_clean from finetune_for_224's model.pth (the
    state before its first step equals the file's)."""
    j_mod, t_mod = _workloads(name)
    n = {"finetune_pseudo": 3}.get(name, 2)
    specs = json.loads(sources.read_text())[:n]
    for s, js in zip(specs, j_mod.CONFIG.sources):
        s.update(ratio=js.ratio, loss_weight=js.loss_weight,
                 oversample=js.oversample)
    (tmp_path / "s.json").write_text(json.dumps(specs))
    extra, first = [], {}
    orig = TTrainer.init_state
    if name == "finetune_pseudo_hard_clean":
        pth = for_224_run[0] / "model.pth"
        extra = ["--init_torch_checkpoint", str(pth)]

        def init(self):
            st = orig(self)
            first.update({k: v.clone() for k, v in
                          st.model.state_dict().items()})
            return st

        TTrainer.init_state = init
    try:
        res = _run(name, tmp_path / "s.json", tmp_path / "run", "--epochs",
                   "1", *extra)
    finally:
        TTrainer.init_state = orig
    out = tmp_path / "run"
    assert np.isfinite(res["best_val_dice"])
    with open(out / "training_metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == SCHEMAS[t_mod.CONFIG.metrics_schema]
    assert len(rows) == 2 and all(np.isfinite(float(x)) for x in rows[1])
    for f in ("history.json", "model.pth", "model.threshold.json",
              "model.last.pth"):
        assert (out / f).exists(), f
    if extra:
        sd = torch.load(pth, weights_only=False)["model_state_dict"]
        assert first.keys() == sd.keys()
        for k, v in sd.items():
            assert torch.equal(first[k], v), k


@pytest.mark.parametrize("name", FINETUNES)
def test_finetune_config_literal_equals_jax(name):
    j_mod, t_mod = _workloads(name)
    j, t = _fields(j_mod.CONFIG), _fields(t_mod.CONFIG)
    assert set(t) - set(j) == {"device"} and t["device"] == "cuda"
    for k in j:
        assert _plain(t[k]) == _plain(j[k]), k
    TTrainer(dataclasses.replace(t_mod.CONFIG, device="cpu"))


# --------------------------------------------------------------- traces

def test_an_exception_in_the_traced_epoch_reaches_the_caller(tmp_path):
    """maybe_trace catches nothing: the block's own exception comes out
    as it went in (JAX's `except Exception: yield` turns it into
    contextlib's "generator didn't stop after throw()"), and no trace is
    written."""
    err = ValueError("a bad batch")
    with pytest.raises(ValueError) as info:
        with maybe_trace(str(tmp_path / "t"), "cpu"):
            torch.ones(3).sum()
            raise err
    assert info.value is err
    assert not (tmp_path / "t" / TRACE_NAME).exists()
    with maybe_trace("", "cpu") as prof:
        assert prof is None


# -------------------------------------------------------------- remat

def _step_batch():
    r = np.random.default_rng(5)
    imgs = r.integers(0, 256, (BS, HW, HW, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:HW, :HW]
    m = np.zeros((BS, HW, HW, 1), np.float32)
    m[0, ..., 0] = (yy - 30) ** 2 + (xx - 26) ** 2 <= 15 ** 2
    m[1, 10:40, 20:50, 0] = 1.0
    imgs[m[..., 0] > 0] //= 3
    return torch.from_numpy(imgs), torch.from_numpy(m)


@pytest.mark.parametrize("lane", BN_LANES)
def test_remat_step_equals_the_plain_step(lane):
    """One fp32 train step (train_512 augmentation, BCE+Dice) with and
    without remat from the same weights and generator: loss, every
    gradient (from the first moment) and every BN running statistic and
    counter within 1e-6. The recompute reruns each BN's forward (in the
    channel-sums lane its autograd Function) and must not update the
    running statistics a second time."""
    imgs, m = _step_batch()
    out = {}
    for remat in (False, True):
        cfg = TConfig(encoder="resnet18", img_size=(HW, HW), batch_size=BS,
                      compute_dtype="float32", remat=remat, device="cpu",
                      out_dir="/nonexistent")
        tr = TTrainer(cfg, bn_lane=lane)
        st = tr.init_state()
        loss, _, _ = tr.train_step(st, imgs, m, torch.ones(BS), [1e-4] * 3,
                                   [1.0] * 3, tr.group_ids(st))
        out[remat] = (float(loss), {k: v / 0.1 for k, v in st.opt.mu.items()},
                      {k: v for k, v in st.model.state_dict().items()
                       if "running" in k or "num_batches" in k})
        n_bn = sum(isinstance(x, torch.nn.BatchNorm2d)
                   for x in st.model.modules())
    (lp, gp, sp), (lr, gr, sr) = out[False], out[True]
    assert lr == pytest.approx(lp, rel=1e-6, abs=1e-7)
    assert len(sp) == 3 * n_bn and n_bn == 30
    for k in gp:
        torch.testing.assert_close(gr[k], gp[k], rtol=1e-6, atol=1e-6)
    for k in sp:
        torch.testing.assert_close(sr[k], sp[k], rtol=1e-6, atol=1e-6)
    assert all(int(v) == 1 for k, v in sr.items() if "num_batches" in k)


# --------------------------------------------------- weighted JAX step

def _weighted_cfg(mod, **kw):
    """The step config with finetune_for_224's loss (bce_dice_per_sample)
    from the JAX or the port's workload module; resnet18, whose JAX step
    compiles in a third of efficientnet-b0's time."""
    return dict(encoder="resnet18", img_size=(HW, HW), batch_size=BS,
                compute_dtype="float32", augment="none", imagenet_norm=True,
                lr=1e-4, loss=mod.CONFIG.loss, **kw)


def _port_weights(tr):
    """The port's seeded init with numpy-randomised BN (fresh BN is 0/1
    and would hide layout faults), and the same weights as JAX variables
    through the JAX package's own importer."""
    from cartseg_tpu.models.torch_import import import_smp_unet
    from torch_port_helpers import jax_tree_to_numpy

    st = tr.init_state()
    r = np.random.default_rng(11)
    for m in st.model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(
                    (1 + 0.1 * r.standard_normal(c)).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    (0.1 * r.standard_normal(c)).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    (0.1 * r.standard_normal(c)).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    (r.random(c) * 0.5 + 0.75).astype(np.float32)))
    sd = {k: v.clone() for k, v in st.model.state_dict().items()}
    v = jax_tree_to_numpy(import_smp_unet(
        {k: x.numpy() for k, x in sd.items()}, "resnet18"))
    return sd, v


def _f64_mu(ttr, sd0, imgs, m, w):
    """0.1 x the port's gradient in float64 on the step's batch: the
    yardstick of float32 roundoff (the first moment after one step from
    zero moments is 0.1 g)."""
    from cartseg_tpu_torch.data.augment import augment_batch
    from cartseg_tpu_torch.models import build_model

    model = build_model("resnet18")
    model.load_state_dict(sd0)
    model = model.double().train()
    x, mm = augment_batch(torch.Generator().manual_seed(0), imgs, m,
                          ttr.aug_cfg)
    out = model(x.double().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    loss, _ = ttr.loss_fn(out, mm.double(), torch.from_numpy(w).double())
    names = [k for k, _ in model.named_parameters()]
    return {k: 0.1 * g.numpy() for k, g in zip(
        names, torch.autograd.grad(loss, list(model.parameters())))}


def test_weighted_step_matches_jax():
    """One bce_dice_per_sample step with sample weights (0.45, 1.0) (a
    pseudo and a hard sample) from the same state in both engines. This
    resnet18's float32 gradient at 64^2 bs2 is ill conditioned (train-
    mode BN over layer4's 8 values a channel): the port's and JAX's each
    lie 2e-3 to 5e-3 (relative L2) from the port's float64 gradient on
    some BN leaves. So, as chip_smoke.py phase 4e holds its BN lanes,
    the gradient (whole, and each leaf holding >= 1e-2 of the largest
    leaf's norm) agrees with JAX within 1e-3 or within twice the port's
    own float32 distance from float64, and never beyond 2e-2; a wrong
    gradient is off by O(1)."""
    j_mod, t_mod = _workloads("finetune_for_224")
    assert t_mod.CONFIG.loss.name == "bce_dice_per_sample"
    ttr = TTrainer(TConfig(**_weighted_cfg(t_mod, out_dir="/nonexistent",
                                           device="cpu")))
    sd0, v = _port_weights(ttr)
    jtr = JTrainer(JConfig(**_weighted_cfg(j_mod, out_dir="/nonexistent",
                                           use_mesh=False)))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = JState(params=params,
                   batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                      v["batch_stats"]),
                   opt=init_adamw(params), step=jnp.zeros((), jnp.int32))
    gids = group_id_tree(jax_param_groups(state.params))
    imgs, m = _step_batch()
    w = np.asarray([0.45, 1.0], np.float32)
    lrs, active = [1e-4, 2e-4, 3e-4], [1.0, 1.0, 1.0]
    state, jloss, _, _ = jtr._train_step_fn()(
        state, jnp.asarray(imgs.numpy()), jnp.asarray(m.numpy()),
        jnp.asarray(w), jax.random.key(0), jnp.asarray(lrs),
        jnp.asarray(active), gids)
    after = jax_train_state_to_port(state, "resnet18")

    st = ttr.init_state()
    st.model.load_state_dict(sd0)
    tl, _, _ = ttr.train_step(st, imgs, m, torch.from_numpy(w), lrs, active,
                              ttr.group_ids(st))
    assert float(tl) == pytest.approx(float(jloss), rel=1e-4)

    want = after["mu"]
    got = {k: x.numpy() for k, x in st.opt.mu.items()}
    f64 = _f64_mu(ttr, sd0, imgs, m, w)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    def whole(d):
        return np.concatenate([d[k].ravel() for k in want])

    e, d = rel(whole(got), whole(want)), rel(whole(got), whole(f64))
    assert e <= max(1e-3, 2 * d) and e <= 2e-2, (e, d)
    top = max(np.linalg.norm(x) for x in want.values())
    for k, x in want.items():
        if np.linalg.norm(x) >= 1e-2 * top:
            e, d = rel(got[k], x), rel(got[k], f64[k])
            assert e <= max(1e-3, 2 * d) and e <= 2e-2, (k, e, d)
    sd = st.model.state_dict()
    for k, x in after["state_dict"].items():
        tol = dict(rtol=1e-4, atol=1e-5) if "running" in k else \
            dict(rtol=0, atol=2 * 3e-4 + 1e-6)
        np.testing.assert_allclose(sd[k].numpy(), x.numpy(), err_msg=k,
                                   **tol)
