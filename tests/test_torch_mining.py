"""Port parity: hard-case mining and soft-prob ranking of
cartseg_tpu_torch against the JAX package on the CPU.

Tolerances (fp32 on the CPU, the same weights in both frameworks):
  * the mining program's probs atol 1e-4 (two effnet-b0 UNets that sum
    their convolutions in a different order, as tests/test_torch_infer.py);
  * the metric body fed the same probs: components equal, every other
    metric within atol 1e-6;
  * the mine_hard_cases CLIs from one .pth on frames whose letterbox is
    a whole multiple of img_size (where the two frame loaders are
    bit-equal by design): the same paths in the same order wherever the
    composites differ by more than 1e-5, the numbers within atol 1e-4,
    the sampling list byte-equal;
  * ranking.csv: the same bytes where the scores are distinct.

The JAX CLIs build their .pth members in bf16 (load_torch_member's
default); the tests load them in float32, the port's CPU dtype.
"""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.infer import engine as JE
from cartseg_tpu.infer import mining as JMi
from cartseg_tpu.infer import ranking as JR
from cartseg_tpu.workloads import get_best_pseudo_masks as j_rank_cli
from cartseg_tpu.workloads import mine_hard_cases as j_mine_cli

from cartseg_tpu_torch.infer import engine as TE
from cartseg_tpu_torch.infer import mining as TMi
from cartseg_tpu_torch.infer.pseudo_labels import IMAGENET_MEAN, IMAGENET_STD
from cartseg_tpu_torch.utils import image_io
from cartseg_tpu_torch.utils.synthetic import frame
from cartseg_tpu_torch.workloads import get_best_pseudo_masks as t_rank_cli
from cartseg_tpu_torch.workloads import mine_hard_cases as t_mine_cli
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (jax_pth_members_f32,  # noqa: F401
                                port_effnet_and_jax_twin)

HW = 32
# 60 x 80 frames: side pad 8, a 96^2 letterbox, 3x img_size
FRAME_HW = (60, 80)
METRICS = ("entropy_mean", "frac_near_0p5", "tta_var_mean", "components",
           "hole_fraction", "perimeter_over_area", "composite")


@pytest.fixture(scope="module")
def members():
    jm, tm = [], []
    for i, w in enumerate((1.0, 2.0)):
        model, jmodel, v = port_effnet_and_jax_twin(seed=30 + i)
        jm.append(JE.EnsembleMember(jmodel, v, w, 0.5))
        tm.append(TE.EnsembleMember(TE.prepare_model(model, "cpu"), w, 0.5))
    return jm, tm


@pytest.fixture(scope="module")
def frames():
    r = np.random.default_rng(12)
    return np.stack([frame(r, (HW, HW)) for _ in range(3)])


@pytest.fixture(scope="module")
def runs(members, frames):
    """(threshold, JAX probs pair, port probs pair, JAX program out, port
    program out); the threshold is the port's median mean prob, so the
    masks have structure."""
    jm, tm = members
    fwd = TE.ensemble_probs_fn(tm, IMAGENET_MEAN, IMAGENET_STD, tta_flip=True)
    tp = fwd(torch.from_numpy(frames))
    thr = float(((tp[0] + tp[1]) / 2).median())
    jfwd = JE.ensemble_probs_fn(jm, IMAGENET_MEAN, IMAGENET_STD,
                                tta_flip=True)
    jp = tuple(np.asarray(p) for p in jfwd(jnp.asarray(frames)))
    jout = JMi.mining_program(jm, IMAGENET_MEAN, IMAGENET_STD, thr, 0.05)(
        jnp.asarray(frames))
    tout = TMi.mining_program(tm, IMAGENET_MEAN, IMAGENET_STD, thr, 0.05)(
        torch.from_numpy(frames))
    return thr, jp, tuple(p.numpy() for p in tp), \
        {k: np.asarray(v) for k, v in jout.items()}, \
        {k: v.numpy() for k, v in tout.items()}


def test_mining_probs_match_jax(runs):
    _, jp, tp, _, _ = runs
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("key", METRICS)
def test_mining_program_matches_jax(runs, key):
    _, _, _, jout, tout = runs
    assert tout[key].shape == jout[key].shape == (3,)
    if key == "components":
        np.testing.assert_array_equal(tout[key], jout[key])
    else:
        np.testing.assert_allclose(tout[key], jout[key], atol=1e-4)


def test_metric_body_on_the_same_probs(runs):
    """Every metric within atol 1e-6 of JAX's. The mean entropy (and the
    composite, 0.35 of it) is held to its float64 value instead: JAX's
    float32 mean over a plane of near-equal entropies (~ln 2 here) sums
    them one after another and drifts from the float64 mean by up to
    ~6e-6 at 32^2, the port's by < 1e-7; the port is then within
    JAX's own drift (+1e-6) of JAX."""
    thr, jp, _, _, _ = runs
    want = {k: np.asarray(v) for k, v in
            JMi._metrics_body(thr, 0.05)(*map(jnp.asarray, jp)).items()}
    got = {k: v.numpy() for k, v in TMi.metrics_body(thr, 0.05)(
        *(torch.from_numpy(np.array(p)) for p in jp)).items()}
    assert set(got) == set(want) == set(METRICS)
    assert want["components"].max() > 1 and want["hole_fraction"].max() > 0
    np.testing.assert_array_equal(got["components"], want["components"])
    assert got["components"].dtype == np.int32
    p = np.clip((jp[0].astype(np.float64) + jp[1]) / 2, 1e-7, 1 - 1e-7)
    ent64 = -(p * np.log(p) + (1 - p) * np.log(1 - p)).mean((1, 2))
    np.testing.assert_allclose(got["entropy_mean"], ent64, rtol=0, atol=1e-6)
    drift = np.abs(want["entropy_mean"] - ent64)
    for k, share in (("entropy_mean", 1.0), ("composite", 0.35)):
        assert (np.abs(got[k] - want[k]) <= share * drift + 1e-6).all(), k
    for k in set(METRICS) - {"entropy_mean", "composite"}:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def pth(members, tmp_path_factory):
    d = tmp_path_factory.mktemp("pth")
    torch.save({"model_state_dict": members[1][0].model.state_dict()},
               d / "m.pth")
    return d / "m.pth"


@pytest.fixture(scope="module")
def jpeg_free_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("mine") / "images"
    r = np.random.default_rng(13)
    for i in range(7):
        d = root / f"session_{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        image_io.write_png(d / f"f{i}.png", frame(r, FRAME_HW))
    return root


def test_mine_hard_cases_cli_matches_jax(pth, jpeg_free_tree, runs, tmp_path,
                                         jax_pth_members_f32):
    common = ["--images_root", str(jpeg_free_tree), "--checkpoints",
              str(pth), "--img_size", str(HW), "--batch_size", "3",
              "--sample_size", "6", "--threshold", f"{runs[0]:.6f}"]
    # batch 3 does not divide over the test process's 8 CPU devices: the
    # JAX CLI warns and runs on one device
    with pytest.warns(UserWarning, match="mesh DISABLED"):
        j_mine_cli.main(common + ["--out_dir", str(tmp_path / "j")])
    rows = t_mine_cli.main(common + ["--out_dir", str(tmp_path / "t"),
                                     "--device", "cpu"])
    want = _read_csv(tmp_path / "j" / "hard_candidates.csv")
    got = _read_csv(tmp_path / "t" / "hard_candidates.csv")
    assert list(got[0]) == list(want[0]) == ["path", *sorted(METRICS)]
    assert len(got) == len(want) == len(rows) == 6
    comp = np.array([float(r["composite"]) for r in want])
    assert (comp[:-1] >= comp[1:]).all()
    apart = np.abs(np.diff(comp)) > 1e-5
    for i, (g, w) in enumerate(zip(got, want)):
        if (i == 0 or apart[i - 1]) and (i == len(got) - 1 or apart[i]):
            assert g["path"] == w["path"]
        by_path = next(r for r in got if r["path"] == w["path"])
        np.testing.assert_allclose([float(by_path[k]) for k in METRICS],
                                   [float(w[k]) for k in METRICS], atol=1e-4)
    names = [p.name for p in (tmp_path / "j" / "sampling").iterdir()]
    assert names == ["sampled_images_seed1337_n6.txt"]
    assert (tmp_path / "t" / "sampling" / names[0]).read_bytes() == \
        (tmp_path / "j" / "sampling" / names[0]).read_bytes()


def test_mining_previews_need_cv2(members, jpeg_free_tree, tmp_path,
                                  monkeypatch):
    """The previews need no OpenCV now: with cv2 refused, mine_hard_cases
    writes one image | JET heat | contours panel a row, each what the
    JAX module's cv2 calls draw from the same probabilities."""
    tm = members[1]
    thr = 0.5
    fwd = TE.ensemble_probs_fn(tm, IMAGENET_MEAN, IMAGENET_STD,
                               tta_flip=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    cfg = TMi.MiningConfig(images_root=str(jpeg_free_tree),
                           out_dir=str(tmp_path), save_previews=True,
                           img_size=HW, batch_size=3, threshold=thr)
    rows = TMi.mine_hard_cases(tm, cfg, device="cpu")
    monkeypatch.delitem(sys.modules, "cv2")
    import cv2

    previews = sorted((tmp_path / "previews").iterdir())
    assert len(previews) == len(rows) == 7
    for rank, row in enumerate(rows):
        img = TMi.load_frame(row["path"], HW, 0.1, "cpu")
        probs, flip = fwd(torch.from_numpy(img[None]))
        p = ((probs + flip) / 2.0)[0].numpy()
        overlay = img.copy()
        cnts, _ = cv2.findContours((p > thr).astype(np.uint8),
                                   cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(overlay, cnts, -1, (255, 0, 0), 2)
        heat = cv2.applyColorMap((p * 255).astype(np.uint8),
                                 cv2.COLORMAP_JET)[..., ::-1]
        name = f"{rank:04d}_{Path(row['path']).stem}.png"
        np.testing.assert_array_equal(
            image_io.decode_png((tmp_path / "previews" / name).read_bytes()),
            np.concatenate([img, heat, overlay], axis=1))


def test_mining_config_has_no_mesh():
    # use_mesh is ported now: the JAX default, and a batch's rows split
    # over this process's cards (one on the CPU: the program unchanged)
    assert TMi.MiningConfig().use_mesh is True
    assert TMi.MiningConfig(use_mesh=False).use_mesh is False


def test_mining_cuda_is_refused_without_a_card(pth, jpeg_free_tree,
                                               tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_mine_cli.main(["--images_root", str(jpeg_free_tree),
                         "--checkpoints", str(pth), "--out_dir",
                         str(tmp_path)])


@pytest.fixture(scope="module")
def prob_tree(tmp_path_factory):
    """store/session trees of *_prob.npz + mask PNGs with distinct
    scores, one prob without a mask, one unreadable prob."""
    root = tmp_path_factory.mktemp("rank") / "src"
    r = np.random.default_rng(14)
    for i in range(9):
        d = root / f"store_{i % 2}" / f"session_{i % 3}"
        d.mkdir(parents=True, exist_ok=True)
        p = np.clip(r.beta(0.3 + 0.2 * i, 0.5, (16, 16)), 0, 1)
        np.savez_compressed(d / f"img{i}_prob.npz", prob=p.astype(np.float16))
        if i != 8:
            image_io.write_png(d / f"img{i}.png",
                               (p > 0.5).astype(np.uint8) * 255)
    (root / "store_0" / "session_0" / "bad_prob.npz").write_bytes(b"no")
    image_io.write_png(root / "store_0" / "session_0" / "bad.png",
                       np.zeros((4, 4), np.uint8))
    return root


def test_ranking_csv_and_copies_match_jax(prob_tree, tmp_path):
    j_rank_cli.main(["--src_root", str(prob_tree), "--dst_root",
                     str(tmp_path / "j"), "--top_k", "5"])
    rows = t_rank_cli.main(["--src_root", str(prob_tree), "--dst_root",
                            str(tmp_path / "t"), "--top_k", "5"])
    scores = [r["score"] for r in rows]
    assert len(rows) == 8 and len(set(scores)) == 8
    assert scores == sorted(scores, reverse=True)
    assert (tmp_path / "t" / "ranking.csv").read_bytes() == \
        (tmp_path / "j" / "ranking.csv").read_bytes()
    want = sorted(p.relative_to(tmp_path / "j")
                  for p in (tmp_path / "j").rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path / "t")
                 for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert got == want and len(got) == 11          # csv + 5 masks + 5 probs


def test_score_sample_and_metrics_equal_jax():
    from cartseg_tpu_torch.infer import ranking as TR

    p = np.random.default_rng(15).random((9, 7)).astype(np.float32)
    assert TR.compute_metrics(p, 0.4) == JR.compute_metrics(p, 0.4)
    for a in (0.001, 0.1, 0.7):
        assert TR.score_sample(a, 0.8, 0.2) == JR.score_sample(a, 0.8, 0.2)
