"""Port parity: the ABL training path of cartseg_tpu_torch (train/,
data/, metrics.py, models/norm.py, workloads/train_bce_dice_abl.py)
against the JAX package on the CPU, plus the port's run artifacts,
resume and device rules.

Tolerances (float32 on the CPU, same weights through models/convert.py):
  * BN running stats after one train-mode forward: atol 1e-6;
  * one full train step: loss and components rel 1e-4; each gradient
    leaf above 1e-2 of the largest and the whole gradient (read from the
    first AdamW moment, mu = 0.1 g) within relative L2 1e-3 of JAX's or
    within twice the port's own spread under another summation order,
    smaller (partly cancelled) leaves within 1e-2 (see the test);
    BN running stats rtol 1e-4 / atol 1e-5; the two
    models' convolutions sum in different orders (logits agree to ~1e-5);
  * AdamW on identical gradients: atol 1e-7;
  * metrics sums: rtol 1e-6.
"""

import csv
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from cartseg_tpu import metrics as JM
from cartseg_tpu.data import make_synthetic_tree
from cartseg_tpu.data import pairing as JP
from cartseg_tpu.data.dataset import SegmentationDataset as JDataset
from cartseg_tpu.models import param_groups as jax_param_groups
from cartseg_tpu.train import TrainConfig as JConfig
from cartseg_tpu.train import Trainer as JTrainer
from cartseg_tpu.train.config import apply_cli_overrides as j_overrides
from cartseg_tpu.train.engine import TrainState as JState
from cartseg_tpu.train.optim import adamw_update as j_adamw
from cartseg_tpu.train.optim import group_id_tree, init_adamw
from cartseg_tpu.workloads import train_bce_dice_abl as j_workload

from cartseg_tpu_torch import metrics as TM
from cartseg_tpu_torch.data import pairing as TP
from cartseg_tpu_torch.data.dataset import SegmentationDataset as TDataset
from cartseg_tpu_torch.infer.engine import load_member
from cartseg_tpu_torch.models import build_model, param_groups
from cartseg_tpu_torch.models.norm import BatchNorm2d
from cartseg_tpu_torch.train import TrainConfig as TConfig
from cartseg_tpu_torch.train import Trainer as TTrainer
from cartseg_tpu_torch.train.config import apply_cli_overrides as t_overrides
from cartseg_tpu_torch.train.engine import epoch_order
from cartseg_tpu_torch.train.optim import AdamWState
from cartseg_tpu_torch.train.optim import adamw_update as t_adamw
from cartseg_tpu_torch.workloads import train_bce_dice_abl as t_workload
from cartseg_tpu_torch.train.engine import SCHEMAS
from torch_port_helpers import (jax_effnet_variables,  # noqa: F401
                                jax_train_state_to_port,
                                load_jax_state_into_port, one_torch_thread,
                                png_pair_tree)

HW, BS = 64, 2


# ------------------------------------------------------------ BN fault

@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_bn_running_stats_follow_flax(eps):
    """After one train-mode forward the running mean and var equal
    flax's batch_stats update (biased variance, momentum 0.9); stock
    nn.BatchNorm2d blends in the unbiased variance instead."""
    r = np.random.default_rng(0)
    x = (r.normal(size=(2, 5, 6, 7)) * 2 + 1).astype(np.float32)   # NHWC
    mean0 = r.normal(size=7).astype(np.float32) * 0.1
    var0 = (r.random(7) + 0.5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=eps)
    v = {"params": {"scale": jnp.ones(7), "bias": jnp.zeros(7)},
         "batch_stats": {"mean": jnp.asarray(mean0),
                         "var": jnp.asarray(var0)}}
    jy, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    t = BatchNorm2d(7, eps=eps).train()
    t.running_mean.copy_(torch.from_numpy(mean0))
    t.running_var.copy_(torch.from_numpy(var0))
    ty = t(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(t.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(t.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6)
    np.testing.assert_allclose(ty.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(jy), atol=1e-5)
    stock = torch.nn.BatchNorm2d(7, eps=eps).train()
    stock.running_var.copy_(torch.from_numpy(var0))
    stock(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert not np.allclose(stock.running_var.numpy(),
                           np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    assert int(t.num_batches_tracked) == 1


def test_model_uses_the_flax_bn_everywhere():
    model = build_model("efficientnet-b0")
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(isinstance(m, BatchNorm2d) for m in bns)


# ------------------------------------------------------ one train step

def _step_cfg(**kw):
    return dict(encoder="efficientnet-b0", img_size=(HW, HW),
                batch_size=BS, compute_dtype="float32", augment="none",
                use_mesh=False, imagenet_norm=True, lr=1e-4,
                loss=j_workload.CONFIG.loss, **kw)


def _step_inputs():
    r = np.random.default_rng(5)
    imgs = r.integers(0, 256, (BS, HW, HW, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:HW, :HW]
    m = np.zeros((BS, HW, HW, 1), np.float32)
    m[0, ..., 0] = (yy - 30) ** 2 + (xx - 26) ** 2 <= 15 ** 2
    m[1, 10:40, 20:50, 0] = 1.0
    imgs[m[..., 0] > 0] //= 3                     # the object is darker
    return imgs, m


@pytest.fixture(scope="module")
def step_runs():
    """Two steps of the JAX Trainer's compiled train step from
    numpy-randomised effnet-b0 variables, and the same two steps of the
    port, each started from the JAX state before it (through
    `jax_train_state_to_port`)."""
    jtr = JTrainer(JConfig(**_step_cfg(out_dir="/nonexistent")))
    _, v = jax_effnet_variables(21)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = JState(params=params,
                   batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                      v["batch_stats"]),
                   opt=init_adamw(params), step=jnp.zeros((), jnp.int32))
    gids = group_id_tree(jax_param_groups(state.params))
    step = jtr._train_step_fn()
    imgs, m = _step_inputs()
    args = (jnp.asarray(imgs), jnp.asarray(m), jnp.ones((BS,), jnp.float32))
    lrs, active = [1e-4, 2e-4, 3e-4], [1.0, 1.0, 1.0]

    ttr = TTrainer(TConfig(**_step_cfg(out_dir="/nonexistent",
                                       device="cpu")))
    tstate = ttr.init_state()
    tgids = ttr.group_ids(tstate)
    runs = []
    for i in range(2):
        before = jax_train_state_to_port(state)
        load_jax_state_into_port(tstate, before)
        # donate_argnums: the step consumes `state`
        state, loss, ok, comps = step(state, *args, jax.random.key(i),
                                      jnp.asarray(lrs), jnp.asarray(active),
                                      gids)
        after = jax_train_state_to_port(state)
        tl, tok, tc = ttr.train_step(tstate, torch.from_numpy(imgs),
                                     torch.from_numpy(m), torch.ones(BS),
                                     lrs, active, tgids)
        runs.append(dict(
            before=before, after=after, loss=float(loss), ok=float(ok),
            comps={k: float(c) for k, c in comps.items()},
            t_loss=float(tl), t_ok=float(tok),
            t_comps={k: float(c) for k, c in tc.items()},
            t_sd={k: x.detach().clone() for k, x in
                  tstate.model.state_dict().items()},
            t_mu={k: x.clone() for k, x in tstate.opt.mu.items()},
            t_mu_alt=_port_mu_other_order(ttr, before, imgs, m, lrs, active,
                                          tgids),
            t_count=tstate.opt.count.clone()))
    return runs


def _port_mu_other_order(ttr, before, imgs, m, lrs, active, gids):
    """The port's first moment after the same step summed in another
    order (four CPU threads instead of one): the yardstick for how far
    float32 roundoff alone moves this model's gradient."""
    st = ttr.init_state()
    load_jax_state_into_port(st, before)
    torch.set_num_threads(4)
    try:
        ttr.train_step(st, torch.from_numpy(imgs), torch.from_numpy(m),
                       torch.ones(BS), lrs, active, gids)
    finally:
        torch.set_num_threads(1)
    return {k: x.clone() for k, x in st.opt.mu.items()}


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_loss_matches_jax(step_runs, i):
    r = step_runs[i]
    assert r["ok"] == r["t_ok"] == 1.0
    assert r["t_loss"] == pytest.approx(r["loss"], rel=1e-4)
    assert set(r["t_comps"]) == set(r["comps"])
    for k, v in r["comps"].items():
        assert r["t_comps"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    # the ABL term is live, so its gradient is part of what is compared
    assert r["comps"]["boundary_used"] == 1.0


def _grad_errors(r):
    """Per leaf: (relative L2 error of the port against JAX, the same for
    the port against itself summed in another order, norm relative to
    the largest leaf). mu after a step is b1*mu0 + 0.1*g; with mu0
    shared, the moment carries the gradient leaf by leaf."""
    out, top = {}, 0.0
    for k, want in r["after"]["mu"].items():
        mu0 = 0.9 * r["before"]["mu"][k]
        w = want - mu0
        t = r["t_mu"][k].numpy() - mu0
        alt = r["t_mu_alt"][k].numpy() - mu0
        den = max(np.linalg.norm(w), 1e-30)
        out[k] = (np.linalg.norm(t - w) / den, np.linalg.norm(alt - t) / den,
                  np.linalg.norm(w))
        top = max(top, np.linalg.norm(w))
    return {k: (e, sp, n / top) for k, (e, sp, n) in out.items()}


def _whole(r):
    """Whole-gradient relative L2: (port vs JAX, port vs itself summed
    in another order)."""
    def g(mu):
        return np.concatenate([
            (np.asarray(mu[k]) - 0.9 * r["before"]["mu"][k]).ravel()
            for k in r["after"]["mu"]])

    w, t, alt = g(r["after"]["mu"]), g(r["t_mu"]), g(r["t_mu_alt"])
    n = np.linalg.norm(w)
    return np.linalg.norm(t - w) / n, np.linalg.norm(alt - t) / n


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_gradients_match_jax(step_runs, i):
    """Step 0 starts from the converted init, step 1 from JAX's state
    after step 0 (nonzero moments and counts, through
    jax_train_state_to_port). This model's float32 gradient is ill
    conditioned at 64^2 bs2 (train-mode BN over few values): summing in
    another order moves the port's own gradient by ~1e-3 relative L2
    (measured 8e-4 to 4e-3 between thread counts), with dL/dlogits
    stable to 6e-6. So every leaf holding >= 1e-2 of the largest
    leaf's norm, and the whole gradient, must agree with JAX within
    1e-3 or within twice the port's own spread, whichever is larger; a
    wrong gradient is off by O(1). Smaller leaves within 1e-2; leaves
    below 1e-6 of the largest are zero up to roundoff and not
    compared."""
    r = step_runs[i]
    errs = _grad_errors(r)
    assert len(errs) == len(r["t_mu"]) > 200
    live = {k: v for k, v in errs.items() if v[2] >= 1e-6}
    assert len(live) >= len(errs) - 16
    # leaves under 1e-2 of the largest are BN biases whose gradient the
    # next train-mode BN mostly cancels: relative error of a remainder
    bad = {k: (e, sp) for k, (e, sp, n) in live.items()
           if e > (max(1e-3, 2 * sp) if n >= 1e-2 else 1e-2)}
    assert not bad, bad
    whole, spread = _whole(r)
    assert whole <= max(1e-3, 2 * spread) and whole <= 5e-3, (whole, spread)


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_params_and_bn_stats_match_jax(step_runs, i):
    r = step_runs[i]
    want, got = r["after"]["state_dict"], r["t_sd"]
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            # |update| <= lr per element; a near-zero gradient may take
            # either sign in the two frameworks
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       atol=2 * 3e-4 + 1e-6, err_msg=k)
    np.testing.assert_array_equal(r["t_count"].numpy(), r["after"]["count"])


# --------------------------------------------------------------- AdamW

@pytest.mark.parametrize("gated", [True, False])
def test_adamw_matches_jax_with_a_frozen_group_and_a_skipped_step(gated):
    """gated: the finite-loss gate is a device tensor, and step 2 is
    skipped; else the update runs ungated (skip_nonfinite=False)."""
    r = np.random.default_rng(3)
    shapes = {"encoder.w": (4, 3), "decoder.w": (5,), "segmentation_head.b":
              (2, 2)}
    groups = {"encoder.w": 0, "decoder.w": 1, "segmentation_head.b": 2}
    p = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jopt = init_adamw(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    topt = AdamWState(mu={k: torch.zeros(s) for k, s in shapes.items()},
                      nu={k: torch.zeros(s) for k, s in shapes.items()},
                      count=torch.zeros(3, dtype=torch.int32))
    lrs = [1e-3, 2e-3, 3e-3]
    for step in range(4):
        g = {k: r.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        active = [0.0 if step < 2 else 1.0, 1.0, 1.0]
        ok = 0.0 if step == 2 and gated else 1.0   # a non-finite loss
        jp, jopt = j_adamw(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           jopt, groups, jnp.asarray(lrs),
                           jnp.asarray(active) * ok, 1e-2)
        t_adamw(tp, {k: torch.from_numpy(v) for k, v in g.items()}, topt,
                groups, lrs, active, 1e-2,
                ok=torch.tensor(ok) if gated else None)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, err_msg=f"{k} {step}")
            np.testing.assert_allclose(topt.mu[k].numpy(),
                                       np.asarray(jopt.mu[k]), atol=1e-7)
            np.testing.assert_allclose(topt.nu[k].numpy(),
                                       np.asarray(jopt.nu[k]), atol=1e-7)
        np.testing.assert_array_equal(topt.count.numpy(),
                                      np.asarray(jopt.count))
    # the encoder was frozen for two steps (and one step skipped)
    assert topt.count.tolist() == ([1, 3, 3] if gated else [2, 4, 4])


def test_param_groups_match_jax_labels():
    _, v = jax_effnet_variables(21)
    jl = jax.tree_util.tree_leaves_with_path(jax_param_groups(v["params"]))
    counts = {}
    for _, lab in jl:
        counts[lab] = counts.get(lab, 0) + 1
    tl = param_groups(build_model("efficientnet-b0"))
    tcounts = {}
    for lab in tl.values():
        tcounts[lab] = tcounts.get(lab, 0) + 1
    assert tcounts == counts


# ------------------------------------------------------------- metrics

def _metric_inputs():
    r = np.random.default_rng(8)
    logits = (r.normal(size=(3, 16, 20, 1)) * 2).astype(np.float32)
    t = (r.random((3, 16, 20, 1)) < 0.4).astype(np.float32)
    w = np.asarray([1.0, 1.0, 0.0], np.float32)
    return logits, t, w


def test_eval_suite_sums_match_jax():
    logits, t, w = _metric_inputs()
    js, jn = JM.eval_suite_sums(jnp.asarray(logits), jnp.asarray(t),
                                jnp.asarray(w))
    ts, tn = TM.eval_suite_sums(torch.from_numpy(logits),
                                torch.from_numpy(t), torch.from_numpy(w))
    assert set(ts) == set(js) and float(tn) == float(jn) == 2.0
    for k in js:
        assert float(ts[k]) == pytest.approx(float(js[k]), rel=1e-6), k


def test_threshold_sweep_sums_match_jax():
    logits, t, w = _metric_inputs()
    thr = np.linspace(0.2, 0.8, 13)
    jd, ji, jn = JM.threshold_sweep_sums(jnp.asarray(logits), jnp.asarray(t),
                                         thr, jnp.asarray(w))
    td, ti, tn = TM.threshold_sweep_sums(
        torch.from_numpy(logits), torch.from_numpy(t),
        torch.from_numpy(thr.astype(np.float32)), torch.from_numpy(w))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6)
    assert float(tn) == float(jn)


# ---------------------------------------------------- config and data

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _plain(v):
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_train_config_defaults_equal_jax():
    j, t = _fields(JConfig()), _fields(TConfig())
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    assert t["device"] == "cuda"
    for k in j:
        assert _plain(t[k]) == _plain(j[k]), k


def test_workload_config_literal_equals_jax():
    j, t = _fields(j_workload.CONFIG), _fields(t_workload.CONFIG)
    for k in j:
        assert _plain(t[k]) == _plain(j[k]), k


def test_cli_overrides_equal_jax():
    argv = ["--epochs", "3", "--lr", "1e-3", "--img_size", "64",
            "--synthetic", "true", "--image_roots", "a,b",
            "--threshold_sweep", "0.1,0.9,5", "--loss", "bce_dice_abl",
            "--use_mesh", "false", "--batch_size", "4", "--split",
            "random", "--resume"]
    j = _fields(j_overrides(j_workload.CONFIG, argv))
    t = _fields(t_overrides(t_workload.CONFIG, argv + ["--device", "cpu"]))
    for k in j:
        assert _plain(t[k]) == _plain(j[k]), k
    assert t["device"] == "cpu" and t["img_size"] == (64, 64)
    with pytest.raises(SystemExit):
        t_overrides(t_workload.CONFIG, ["--nope", "1"])
    # the JAX parser keeps Optional[int] values as strings
    assert t_overrides(TConfig(), ["--stop_after_epoch", "2"]
                       ).stop_after_epoch == 2


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("jtree")
    return make_synthetic_tree(root, n_sessions=5, per_session=3, seed=4,
                               with_store=True)


def test_pairs_and_splits_bit_equal(jax_tree):
    ir, mr = jax_tree
    assert JP.gather_pairs(ir, mr) == []      # store_*/session_* layout
    jm = JP.gather_pairs_multiroot([ir], mr, seed=3)
    tm = TP.gather_pairs_multiroot([ir], mr, seed=3)
    assert [p.astuple() for p in tm] == [p.astuple() for p in jm]
    assert len(jm) == 15
    for split in ("session_split", "session_split_seeded"):
        assert getattr(TP, split)(tm, 0.4) == getattr(JP, split)(jm, 0.4)
    assert TP.random_split(15, 0.2, 9) == JP.random_split(15, 0.2, 9)
    flat = Path(str(ir).replace("images", "flat"))
    ir2, mr2 = make_synthetic_tree(flat, n_sessions=2, per_session=2)
    assert [p.astuple() for p in TP.gather_pairs(ir2, mr2)] == \
        [p.astuple() for p in JP.gather_pairs(ir2, mr2)]


def test_epoch_permutations_bit_equal():
    for seed, epoch, n in ((1337, 0, 48), (1337, 5, 48), (0, 3, 7)):
        # the JAX engine's plan, cartseg_tpu/train/engine.py:501-503
        want = np.random.default_rng(
            np.random.SeedSequence([seed, 7, epoch])).permutation(n)
        np.testing.assert_array_equal(epoch_order(seed, epoch, n), want)


def test_dataset_items_match_jax(jax_tree):
    ir, mr = jax_tree
    pairs_j = JP.gather_pairs_multiroot([ir], mr)
    pairs_t = TP.gather_pairs_multiroot([ir], mr)
    # the JAX dataset's default: its native letterbox + resize, which the
    # port's dataset takes too (cv2's resize differs by 1 LSB in places)
    dj = JDataset(pairs_j[:3], (64, 64))
    assert dj._native is not None
    dt = TDataset(pairs_t[:3], (64, 64))
    for i in range(3):
        (ji, jmask), (ti, tmask) = dj[i], dt[i]
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tmask.astype(np.float32), jmask)


# ------------------------------------------------------- the workload

def _run(tree, out, *extra):
    ir, mr = tree
    return t_workload.main(
        ["--images_root", str(ir), "--masks_root", str(mr), "--out_dir",
         str(out), "--device", "cpu", "--img_size", str(HW), "--batch_size",
         str(BS), "--epochs", "2", "--num_threads", "2", *extra],
        log=lambda *a: None)


def test_cli_run_writes_every_artifact(png_pair_tree, tmp_path):
    res = _run(png_pair_tree, tmp_path)
    with open(tmp_path / "training_metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "train_loss", "region_loss",
                       "boundary_loss", "boundary_skip_rate", "val_loss",
                       "val_dice", "val_iou"]
    assert len(rows) == 3
    for row in rows[1:]:
        assert all(np.isfinite(float(x)) for x in row)
    hist = json.loads((tmp_path / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [1, 2]
    assert all(h["images_per_sec"] > 0 for h in hist)
    pth = tmp_path / "model.pth"
    ck = torch.load(pth, weights_only=False)
    assert {"epoch", "model_state_dict", "val_dice", "val_iou"} <= set(ck)
    side = json.loads((tmp_path / "model.threshold.json").read_text())
    assert side["threshold"] == pytest.approx(res["threshold"])
    assert (tmp_path / "model.last.pth").exists()
    # the trained checkpoint feeds the port's pseudo-labeller as it is
    member = load_member(pth, device="cpu")
    assert member.threshold == pytest.approx(side["threshold"])


def test_resume_equals_an_uninterrupted_run(png_pair_tree, tmp_path):
    """stop_after_epoch=1, then resume=True: the same CSV rows, best
    weights and threshold as one 2-epoch run (generator state, moments,
    BN buffers and counters all carried in .last.pth)."""
    a, b = tmp_path / "a", tmp_path / "b"
    ra = _run(png_pair_tree, a, "--log_throughput", "false")
    rb1 = _run(png_pair_tree, b, "--log_throughput", "false",
               "--stop_after_epoch", "1")
    assert rb1["interrupted"] is True
    rb = _run(png_pair_tree, b, "--log_throughput", "false", "--resume")
    assert (a / "training_metrics.csv").read_text() == \
        (b / "training_metrics.csv").read_text()
    assert ra["threshold"] == rb["threshold"]
    assert ra["best_epoch"] == rb["best_epoch"]
    sa = torch.load(a / "model.pth", weights_only=False)["model_state_dict"]
    sb = torch.load(b / "model.pth", weights_only=False)["model_state_dict"]
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_resume_falls_back_to_the_best_checkpoint(png_pair_tree, tmp_path):
    """Without .last.pth (save_last false), resume restarts from the best
    .pth as the reference does: params and moments from it, the epoch
    after the best, a fresh generator."""
    _run(png_pair_tree, tmp_path, "--save_last", "false", "--epochs", "1")
    assert not (tmp_path / "model.last.pth").exists()
    logs = []
    ir, mr = png_pair_tree
    t_workload.main(
        ["--images_root", str(ir), "--masks_root", str(mr), "--out_dir",
         str(tmp_path), "--device", "cpu", "--img_size", str(HW),
         "--batch_size", str(BS), "--epochs", "2", "--resume"],
        log=logs.append)
    assert any("Resumed from best epoch 0" in m for m in logs)
    hist = json.loads((tmp_path / "history.json").read_text())
    assert [h["epoch"] for h in hist] == [1, 2]


def test_grad_clipping_bounds_the_gradient():
    """clip_grad_norm scales the whole gradient to at most the norm; the
    first moment after one step is 0.1 * the clipped gradient."""
    tr = TTrainer(TConfig(**_step_cfg(out_dir="/nonexistent", device="cpu",
                                      clip_grad_norm=1e-3)))
    st = tr.init_state()
    imgs, m = _step_inputs()
    tr.train_step(st, torch.from_numpy(imgs), torch.from_numpy(m),
                  torch.ones(BS), [1e-4] * 3, [1.0] * 3, tr.group_ids(st))
    g = torch.cat([v.reshape(-1) for v in st.opt.mu.values()]) / 0.1
    assert float(g.norm()) == pytest.approx(1e-3, rel=1e-3)


def test_cuda_is_refused_without_a_card(png_pair_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ir, mr = png_pair_tree
    with pytest.raises(RuntimeError, match="cuda"):
        t_workload.main(["--images_root", str(ir), "--masks_root", str(mr),
                         "--out_dir", str(tmp_path), "--img_size", str(HW)])


@pytest.mark.parametrize("field,value", [
    ("init_checkpoint", "orbax_dir"), ("decoder", "fpn")])
def test_out_of_scope_settings_raise(field, value, tmp_path):
    cfg = t_overrides(t_workload.CONFIG, [f"--{field}", value, "--device",
                                          "cpu"])
    with pytest.raises(NotImplementedError):
        TTrainer(cfg)


@pytest.mark.parametrize("field,value", [
    ("sources_json", "s.json"), ("decoder", "unetpp"), ("remat", "true"),
    ("trace_dir", "t"), ("encoder", "classic")])
def test_once_out_of_scope_settings_build_a_trainer(field, value, tmp_path,
                                                    png_pair_tree):
    """Mixed sources, UNet++, remat, traces and the classic UNet: each
    setting builds a Trainer, and --sources_json reads its file."""
    if field == "sources_json":
        ir, mr = png_pair_tree
        value = str(tmp_path / value)
        Path(value).write_text(json.dumps([
            {"name": "hard", "images_root": str(ir), "masks_root": str(mr),
             "ratio": 1.0, "loss_weight": 1.0}]))
    elif field == "trace_dir":
        value = str(tmp_path / value)
    cfg = t_overrides(t_workload.CONFIG, [f"--{field}", value, "--device",
                                          "cpu", "--out_dir", str(tmp_path)])
    tr = TTrainer(cfg)
    model = tr.init_state().model
    if field == "sources_json":
        train_ds, val_ds, sampler, src = tr.build_datasets()
        assert [s.name for s in tr.cfg.sources] == ["hard"]
        assert len(train_ds) + len(val_ds) == 12 and set(src) == {0}
        assert sampler.num_samples == len(train_ds)
    elif field == "decoder":
        assert type(model).__name__ == "UNetPlusPlus"
    elif field == "encoder":
        assert type(model).__name__ == "ClassicUNet"


def test_use_mesh_default_is_accepted():
    assert TConfig().use_mesh is True
    TTrainer(TConfig(encoder="efficientnet-b0", device="cpu"))


# ------------------------------------ the workloads that need only CONFIG

NEW_WORKLOADS = {
    "train_with_pretrained": "prf1",
    "train_with_focal_dice": "prf1",
    "train_with_focal_dice_unfrozen": "prf1",
    "train_pseudo": "basic",
    "train_bce_dice_abl_unlettered": "abl",
}


def _workloads(name):
    import importlib

    return (importlib.import_module(f"cartseg_tpu.workloads.{name}"),
            importlib.import_module(f"cartseg_tpu_torch.workloads.{name}"))


@pytest.mark.parametrize("name", list(NEW_WORKLOADS))
def test_new_workload_config_literal_equals_jax(name):
    j_mod, t_mod = _workloads(name)
    j, t = _fields(j_mod.CONFIG), _fields(t_mod.CONFIG)
    assert set(t) - set(j) == {"device"} and t["device"] == "cuda"
    for k in j:
        assert _plain(t[k]) == _plain(j[k]), k
    assert t_mod.CONFIG.metrics_schema == NEW_WORKLOADS[name]


@pytest.mark.parametrize("name", list(NEW_WORKLOADS))
def test_new_workload_cli_writes_its_artifacts(name, png_pair_tree,
                                               tmp_path):
    """Each new CLI at 64^2 for 1 epoch on the CPU: the CSV of its
    schema with one finite row, history, .pth, sidecar and .last.pth.
    train_pseudo reads two image roots against one mask root."""
    import shutil

    ir, mr = png_pair_tree
    if name == "train_pseudo":
        roots = [tmp_path / "root_a", tmp_path / "root_b"]
        for i, sess in enumerate(sorted(p for p in ir.iterdir())):
            shutil.copytree(sess, roots[i // 2] / sess.name)
        data = ["--image_roots", ",".join(map(str, roots))]
    else:
        data = ["--images_root", str(ir)]
    out = tmp_path / "run"
    _, t_mod = _workloads(name)
    res = t_mod.main(data + [
        "--masks_root", str(mr), "--out_dir", str(out), "--device", "cpu",
        "--img_size", str(HW), "--batch_size", str(BS), "--epochs", "1",
        "--num_threads", "2"], log=lambda *a: None)
    assert np.isfinite(res["best_val_dice"])
    with open(out / "training_metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == SCHEMAS[NEW_WORKLOADS[name]] and len(rows) == 2
    assert all(np.isfinite(float(x)) for x in rows[1])
    for f in ("history.json", "model.pth", "model.threshold.json",
              "model.last.pth"):
        assert (out / f).exists(), f
    if name == "train_with_focal_dice_unfrozen":
        row = dict(zip(rows[0], map(float, rows[1])))
        assert row["phase"] == 1
        assert row["lr_encoder"] == pytest.approx(0.1 * row["lr_decoder"])
        assert row["lr_head"] == pytest.approx(3.0 * row["lr_decoder"])
    if name == "train_pseudo":
        hist = json.loads((out / "history.json").read_text())
        assert [h["epoch"] for h in hist] == [1]

