"""Port parity: the pseudo-label program, Canny front end, host loop and
CLI of cartseg_tpu_torch against the JAX package, plus the port's
import and device rules.

Tolerances (fp32 on the CPU, same weights bridged by models/convert.py):
  * probs atol 1e-4 — two effnet-b0 UNets whose convolutions sum in a
    different order per framework (logits agree to ~2e-4, and the
    sigmoid's slope is at most 1/4);
  * pred equal wherever |p - thr| > 1e-4 (a pixel within the probs
    tolerance of the threshold may flip);
  * stats atol 1e-3;
  * Canny edge maps >= 99.9 % equal: the Sobel front end is a float
    convolution in both frameworks and a last-bit difference can flip a
    threshold or NMS comparison; reach itself is bit-exact on shared
    weak/strong maps.
"""

import copy
import csv
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.infer import engine as JE
from cartseg_tpu.ops import edges as JEd
from cartseg_tpu.ops.pallas.cc import reach_batch_pallas

import cartseg_tpu_torch
from cartseg_tpu_torch.device import require_cuda, resolve_device
from cartseg_tpu_torch.infer import engine as TE
from cartseg_tpu_torch.infer.pseudo_labels import (
    IMAGENET_MEAN, IMAGENET_STD, QC_HEADER, PseudoLabelConfig, QCThresholds,
    generate_pseudo_labels, should_accept)
from cartseg_tpu_torch.ops import edges as TEd
from cartseg_tpu_torch.ops.cuda.cc import reach_batch
from cartseg_tpu_torch.utils.synthetic import frame, make_png_tree
from cartseg_tpu_torch.workloads import create_pseudo_labels as cli
from torch_port_helpers import imported_modules, port_effnet_and_jax_twin

HW = 64


@pytest.fixture(scope="module")
def pair():
    """Two effnet-b0 members at identical weights in both frameworks
    (the flax-init bridge through models/convert.py is held in
    tests/test_torch_models.py; here the JAX importer supplies the twin
    to spare a second init compile)."""
    jm, tm = [], []
    for i, w in enumerate((1.0, 3.0)):
        model, jmodel, v = port_effnet_and_jax_twin(seed=10 + i)
        jm.append(JE.EnsembleMember(jmodel, v, w, 0.5))
        tm.append(TE.EnsembleMember(TE.prepare_model(model, "cpu"), w, 0.5))
    return jm, tm


@pytest.fixture(scope="module")
def frames():
    r = np.random.default_rng(4)
    return np.stack([frame(r, (HW, HW)) for _ in range(2)])


@pytest.fixture(scope="module")
def torch_run(pair, frames):
    _, tm = pair
    prog = TE.pseudo_label_program(tm, IMAGENET_MEAN, IMAGENET_STD,
                                   min_area=6)
    x = torch.from_numpy(frames)
    # a threshold inside the probs' range, so the masks have structure
    thr = float(prog(x, 0.5)[1].median())
    pred, probs, stats = prog(x, thr)
    return thr, pred.numpy(), probs.numpy(), {k: v.numpy()
                                              for k, v in stats.items()}


@pytest.fixture(scope="module")
def jax_run(pair, frames, torch_run):
    jm, _ = pair
    prog = JE.pseudo_label_program(jm, IMAGENET_MEAN, IMAGENET_STD,
                                   min_area=6)
    pred, probs, stats = prog(jnp.asarray(frames), jnp.float32(torch_run[0]))
    return np.asarray(pred), np.asarray(probs), \
        {k: np.asarray(v) for k, v in stats.items()}


def test_program_probs_match_jax(jax_run, torch_run):
    np.testing.assert_allclose(torch_run[2], jax_run[1], atol=1e-4)


def test_program_pred_matches_jax_away_from_threshold(jax_run, torch_run):
    pred_j, probs_j, _ = jax_run
    thr, pred_t = torch_run[:2]
    far = np.abs(probs_j - thr) > 1e-4
    assert 0.05 < pred_j.mean() < 0.95
    np.testing.assert_array_equal(pred_t[far], pred_j[far])


@pytest.mark.parametrize("key", ["fg_area", "fg_conf", "mean_entropy",
                                 "tta_iou", "edge_hit"])
def test_program_stats_match_jax(jax_run, torch_run, key):
    got, want = torch_run[3][key], jax_run[2][key]
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_prepare_model_keeps_the_cpu_nchw(pair):
    """On the CPU the members stay NCHW (the card stores them NHWC,
    tests/test_torch_infer_cuda.py): every 4-D weight NCHW-contiguous,
    the 3x3 ones not also channels_last."""
    _, tm = pair
    for m in tm:
        weights = [p for p in m.model.parameters() if p.dim() == 4]
        assert weights and all(p.is_contiguous() for p in weights)
        assert not all(p.is_contiguous(memory_format=torch.channels_last)
                       for p in weights)


def test_channels_last_members_give_the_same_probs(pair, frames):
    """The same members stored channels_last give the NCHW members'
    flip-TTA probabilities within fp32 roundoff: the layout changes the
    storage order alone."""
    _, tm = pair
    nhwc = [TE.EnsembleMember(
        copy.deepcopy(m.model).to(memory_format=torch.channels_last),
        m.weight, m.threshold) for m in tm]
    x = torch.from_numpy(frames)
    want = TE.ensemble_probs_fn(tm, IMAGENET_MEAN, IMAGENET_STD,
                                tta_flip=True)(x)
    got = TE.ensemble_probs_fn(nhwc, IMAGENET_MEAN, IMAGENET_STD,
                               tta_flip=True)(x)
    assert any(p.dim() == 4 and not p.is_contiguous()
               for p in nhwc[0].model.parameters())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_canny_edge_maps_agree(frames):
    gray_j = JEd.rgb_to_gray(jnp.asarray(frames).astype(jnp.float32))
    want = np.asarray(JEd.canny_edges(gray_j, 50.0, 150.0))
    got = TEd.canny_edges(TEd.rgb_to_gray(torch.from_numpy(frames)),
                          50.0, 150.0).numpy()
    assert want.any()
    assert (got == want).mean() >= 0.999


def _weak_strong(gray_np):
    """Canny's NMS and double threshold with the JAX package's ops, up
    to the hysteresis input (ops/edges.py:89-114)."""
    gx, gy = JEd._sobel_replicate(jnp.asarray(gray_np))
    gx, gy = np.asarray(gx), np.asarray(gy)
    ax, ay = np.abs(gx), np.abs(gy)
    mag = ax + ay
    t = 0.4142135623730951
    horiz, vert = ay <= t * ax, ax <= t * ay
    diag, same = ~(horiz | vert), gx * gy >= 0

    def nb(dy, dx):
        return np.asarray(JEd._shift(jnp.asarray(mag), dy, dx))

    keep = np.where(horiz, (mag > nb(0, 1)) & (mag >= nb(0, -1)),
                    np.where(vert, (mag > nb(1, 0)) & (mag >= nb(-1, 0)),
                             np.where(same & diag,
                                      (mag > nb(1, 1)) & (mag >= nb(-1, -1)),
                                      (mag > nb(1, -1)) & (mag >= nb(-1, 1)))))
    return keep & (mag > 50.0), keep & (mag > 150.0)


def test_reach_bit_exact_on_canny_maps(frames):
    gray = np.asarray(JEd.rgb_to_gray(jnp.asarray(frames, jnp.float32)))
    weak, strong = _weak_strong(gray)
    assert strong.any() and (weak & ~strong).any()
    want = np.asarray(reach_batch_pallas(jnp.asarray(weak),
                                         jnp.asarray(strong)))
    np.testing.assert_array_equal(
        want, np.asarray(JEd._hysteresis(jnp.asarray(weak),
                                         jnp.asarray(strong))))
    got = reach_batch(torch.from_numpy(weak), torch.from_numpy(strong))
    np.testing.assert_array_equal(got.numpy(), want)


def test_qc_stats_match_numpy():
    """The QC formulas on random probs (tests/test_infer.py pattern)."""
    r = np.random.default_rng(0)
    probs = r.random((2, 32, 32)).astype(np.float32)
    flip = r.random((2, 32, 32)).astype(np.float32)
    imgs = r.integers(0, 255, (2, 32, 32, 3), np.uint8)
    out = TE.qc_stats_fn()(torch.from_numpy(probs), torch.from_numpy(flip),
                           torch.from_numpy(imgs), 0.5)
    for b in range(2):
        p = probs[b]
        assert float(out["fg_area"][b]) == pytest.approx((p >= .5).mean(),
                                                         abs=1e-6)
        assert float(out["fg_conf"][b]) == pytest.approx(
            np.median(np.abs(p - 0.5) * 2.0), abs=1e-6)
        pe = np.clip(p, 1e-6, 1 - 1e-6)
        ent = -(pe * np.log(pe) + (1 - pe) * np.log(1 - pe)).mean()
        assert float(out["mean_entropy"][b]) == pytest.approx(ent, abs=1e-5)
        a, f = p >= 0.5, flip[b] >= 0.5
        assert float(out["tta_iou"][b]) == pytest.approx(
            (a & f).sum() / max((a | f).sum(), 1), abs=1e-6)


def test_should_accept_gates():
    t = QCThresholds()
    good = dict(fg_area=0.1, fg_conf=0.9, mean_entropy=0.1,
                tta_iou=0.9, edge_hit=0.5)
    assert should_accept(**good, t=t)
    for k, bad in (("fg_area", 0.001), ("fg_area", 0.7), ("fg_conf", 0.5),
                   ("mean_entropy", 0.5), ("tta_iou", 0.5),
                   ("edge_hit", 0.05)):
        assert not should_accept(**{**good, k: bad}, t=t)


def _accept_all():
    return QCThresholds(min_fg_area=0, max_fg_area=1, min_fg_conf=0,
                        max_mean_entropy=10, min_tta_iou=0, min_edge_hit=0)


def test_generate_pseudo_labels_end_to_end(pair, tmp_path):
    _, tm = pair
    root = make_png_tree(tmp_path, n_sessions=2, per_session=3, hw=(40, 32))
    cfg = PseudoLabelConfig(
        images_root=str(root), out_dir=str(tmp_path / "pseudo"),
        overlay_dir=str(tmp_path / "overlays"), img_size=32, threshold=0.5,
        batch_size=4, qc=_accept_all(), max_per_bucket=2)
    out = generate_pseudo_labels(tm, cfg, device="cpu", log=lambda *a: None)
    assert out["accepted"] == 4
    assert all(v <= 2 for v in out["buckets"].values())
    pseudo = tmp_path / "pseudo"
    with open(pseudo / "qc_scores.csv") as f:
        rows = list(csv.reader(f))
    # the JAX workload's header (cartseg_tpu/infer/pseudo_labels.py:152)
    assert rows[0] == QC_HEADER == [
        "image", "fg_area", "fg_conf", "mean_entropy", "tta_iou",
        "edge_hit", "accepted", "threshold"]
    assert len(rows) == 5 and all(r[-2] == "1" and r[-1] == "0.50"
                                  for r in rows[1:])
    masks = sorted(pseudo.rglob("session_*/*.png"))
    assert len(masks) == 4
    assert len(list(pseudo.rglob("*_prob.npz"))) == 4
    # overlays sit flat in one folder, named by stem (as in the JAX loop)
    assert {p.name for p in (tmp_path / "overlays").glob("*.png")} == \
        {f"{m.stem}_overlay_512.png" for m in masks}
    prob = np.load(next(pseudo.rglob("*_prob.npz")))["prob"]
    assert prob.shape == (32, 32) and prob.dtype == np.float16


def test_rejected_frames_route_to_uncertain(pair, tmp_path):
    _, tm = pair
    root = make_png_tree(tmp_path, n_sessions=1, per_session=2, hw=(32, 32))
    cfg = PseudoLabelConfig(
        images_root=str(root), out_dir=str(tmp_path / "p"), img_size=32,
        batch_size=4, qc=QCThresholds(min_fg_conf=2.0))
    out = generate_pseudo_labels(tm, cfg, device="cpu", log=lambda *a: None)
    assert out["accepted"] == 0
    assert len(list((tmp_path / "p" / "uncertain").rglob("*.png"))) == 2


def test_main_with_saved_pth(pair, tmp_path):
    _, tm = pair
    root = make_png_tree(tmp_path, n_sessions=1, per_session=3, hw=(32, 32))
    ckpt = tmp_path / "m.pth"
    torch.save({"model_state_dict": tm[0].model.state_dict()}, ckpt)
    ckpt.with_suffix(".threshold.json").write_text('{"threshold": 0.35}')
    out = cli.main(["--images_root", str(root), "--out_dir",
                    str(tmp_path / "o"), "--checkpoints", str(ckpt),
                    "--img_size", "32", "--batch_size", "2",
                    "--device", "cpu"])
    assert out["threshold"] == pytest.approx(0.35)
    with open(tmp_path / "o" / "qc_scores.csv") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 4 and rows[1][-1] == "0.35"


def test_cuda_is_refused_without_a_card(pair, tmp_path):
    """No silent CPU: asking for cuda on a machine without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        require_cuda()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    ckpt = tmp_path / "m.pth"
    torch.save(pair[1][0].model.state_dict(), ckpt)
    with pytest.raises(RuntimeError):
        TE.load_member(ckpt, device="cuda")
    with pytest.raises(RuntimeError):
        cli.main(["--images_root", str(tmp_path), "--checkpoints",
                  str(ckpt)])


def test_orbax_directory_names_the_converter(tmp_path):
    with pytest.raises(ValueError, match="convert.py"):
        TE.load_member(tmp_path, device="cpu")


def test_port_never_imports_jax():
    """AST scan: the package imports no jax, flax or cartseg_tpu (the
    test process itself has jax loaded, so sys.modules says nothing)."""
    pkg = Path(cartseg_tpu_torch.__file__).parent
    files = sorted(pkg.rglob("*.py"))
    assert len(files) > 15
    # the data-parallel and serving subsystems among them
    assert {"parallel", "serve"} <= {f.relative_to(pkg).parts[0]
                                     for f in files}
    banned = {"jax", "jaxlib", "flax", "optax", "cartseg_tpu"}
    for f in files:
        bad = imported_modules(f) & banned
        assert not bad, f"{f.relative_to(pkg)} imports {bad}"
    chip_smoke = pkg.parent / "chip_smoke.py"
    assert not imported_modules(chip_smoke) & banned
