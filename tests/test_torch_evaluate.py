"""Port parity: checkpoint evaluation, the Sobel QC gate and the
pseudo-label CLI's outputs of cartseg_tpu_torch against the JAX package
on the CPU, from one reference-naming .pth.

Tolerances (fp32 on the CPU):
  * evaluate's JSON: every number within atol 1e-4 (two effnet-b0 UNets
    that sum their convolutions in a different order), the swept best
    threshold equal;
  * the Sobel lane's QC stats atol 1e-3, as the Canny lane's
    (tests/test_torch_infer.py); Sobel edge maps >= 99.9 % equal (a
    float convolution in both frameworks; a last-bit difference can flip
    a pixel at the threshold);
  * create_pseudo_labels: the same files, the same qc_scores.csv rows in
    the same order, `image` and `accepted` byte-equal, each rounded
    number equal or one unit of its last printed digit apart.

Frames are 60 x 80, whose 96^2 letterbox is 3x img_size: there the JAX
loader (cv2 INTER_LINEAR) and the port's native loader are bit-equal by
design. The JAX CLIs build their .pth members in bf16
(load_torch_member's default); the tests load them in float32, the
port's CPU dtype.
"""

import csv

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cartseg_tpu.infer import engine as JE
from cartseg_tpu.ops import edges as JEd
from cartseg_tpu.workloads import create_pseudo_labels as j_pseudo_cli
from cartseg_tpu.workloads import evaluate as j_eval_cli

from cartseg_tpu_torch.infer import engine as TE
from cartseg_tpu_torch.infer.pseudo_labels import IMAGENET_MEAN, IMAGENET_STD
from cartseg_tpu_torch.ops import edges as TEd
from cartseg_tpu_torch.utils.synthetic import frame, make_png_pair_tree
from cartseg_tpu_torch.workloads import create_pseudo_labels as t_pseudo_cli
from cartseg_tpu_torch.workloads import evaluate as t_eval_cli
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import pinned_jax_native  # noqa: F401
from torch_port_helpers import (jax_pth_members_f32,  # noqa: F401
                                port_effnet_and_jax_twin)

HW = 32
FRAME_HW = (60, 80)
QC_KEYS = ("fg_area", "fg_conf", "mean_entropy", "tta_iou", "edge_hit")


@pytest.fixture(scope="module")
def twin():
    return port_effnet_and_jax_twin(seed=40)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return make_png_pair_tree(tmp_path_factory.mktemp("eval"), 2, 3,
                              FRAME_HW, seed=41)


@pytest.fixture(scope="module")
def pth(twin, pairs, tmp_path_factory):
    """The twin's weights with the segmentation head rescaled so that the
    logits on the tree spread around 0 (std 2): the probs then cross the
    thresholds of evaluate's sweep and of the QC gates."""
    from cartseg_tpu_torch.data.dataset import SegmentationDataset
    from cartseg_tpu_torch.data.pairing import gather_pairs_mirror

    ds = SegmentationDataset(gather_pairs_mirror(*pairs), (HW, HW))
    x = torch.from_numpy(ds.batch(range(len(ds)))[0]).to(torch.float32)
    x = ((x / 255 - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD))
    with torch.no_grad():
        logits = twin[0](x.permute(0, 3, 1, 2))
    sd = {k: v.clone() for k, v in twin[0].state_dict().items()}
    scale = 2.0 / float(logits.std())
    sd["segmentation_head.0.weight"] *= scale
    sd["segmentation_head.0.bias"] = (sd["segmentation_head.0.bias"]
                                      - float(logits.median())) * scale
    path = tmp_path_factory.mktemp("ckpt") / "m.pth"
    torch.save({"model_state_dict": sd}, path)
    path.with_suffix(".threshold.json").write_text('{"threshold": 0.45}')
    return path


def test_evaluate_cli_matches_jax(pth, pairs, tmp_path, jax_pth_members_f32):
    args = ["--images_root", str(pairs[0]), "--masks_root", str(pairs[1]),
            "--checkpoint", str(pth), "--img_size", str(HW),
            "--batch_size", "3", "--sweep"]
    want = j_eval_cli.main(args + ["--out_json", str(tmp_path / "j.json")])
    got = t_eval_cli.main(args + ["--out_json", str(tmp_path / "t.json"),
                                  "--device", "cpu"])
    assert list(got) == list(want)
    assert got["threshold"] == want["threshold"] == 0.45
    assert got["n_images"] == want["n_images"] == 6
    assert got["best_threshold"] == want["best_threshold"] != 0.05
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert (tmp_path / "t.json").exists()


def test_evaluate_takes_the_threshold_flag(pth, pairs, tmp_path):
    out = t_eval_cli.main(["--images_root", str(pairs[0]), "--masks_root",
                           str(pairs[1]), "--checkpoint", str(pth),
                           "--img_size", str(HW), "--batch_size", "4",
                           "--threshold", "0.3", "--device", "cpu"])
    assert out["threshold"] == 0.3 and "best_threshold" not in out
    assert out["n_images"] == 6


def test_evaluate_refuses_orbax_and_cuda(pth, pairs, tmp_path):
    args = ["--images_root", str(pairs[0]), "--masks_root", str(pairs[1])]
    with pytest.raises(ValueError, match="convert.py"):
        t_eval_cli.main(args + ["--checkpoint", str(tmp_path),
                                "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_eval_cli.main(args + ["--checkpoint", str(pth)])


@pytest.fixture(scope="module")
def sobel_runs(twin):
    model, jmodel, v = twin
    r = np.random.default_rng(42)
    frames = np.stack([frame(r, (HW, HW)) for _ in range(2)])
    tm = [TE.EnsembleMember(TE.prepare_model(model, "cpu"), 1.0, 0.5)]
    jm = [JE.EnsembleMember(jmodel, v, 1.0, 0.5)]
    prog = TE.pseudo_label_program(tm, IMAGENET_MEAN, IMAGENET_STD, 6,
                                   edge_method="sobel", edge_threshold=100.0)
    thr = float(prog(torch.from_numpy(frames), 0.5)[1].median())
    _, _, stats = prog(torch.from_numpy(frames), thr)
    jprog = JE.pseudo_label_program(jm, IMAGENET_MEAN, IMAGENET_STD, 6,
                                    edge_method="sobel", edge_threshold=100.0)
    _, _, jstats = jprog(jnp.asarray(frames), jnp.float32(thr))
    return frames, {k: v.numpy() for k, v in stats.items()}, \
        {k: np.asarray(v) for k, v in jstats.items()}


@pytest.mark.parametrize("key", QC_KEYS)
def test_sobel_program_stats_match_jax(sobel_runs, key, monkeypatch):
    _, got, want = sobel_runs
    assert got[key].shape == want[key].shape == (2,)
    np.testing.assert_allclose(got[key], want[key], atol=1e-3)


def test_sobel_gate_launches_no_reach(twin, monkeypatch):
    def refuse(*a):
        raise AssertionError("the Sobel gate called reach_batch")

    monkeypatch.setattr(TEd, "reach_batch", refuse)
    stats = TE.qc_stats_fn(edge_method="sobel")(
        torch.rand(1, 16, 16), torch.rand(1, 16, 16),
        torch.randint(0, 255, (1, 16, 16, 3), dtype=torch.uint8), 0.5)
    assert stats["edge_hit"].shape == (1,)


def test_sobel_edges_and_hit_rate_agree(sobel_runs):
    frames = sobel_runs[0]
    gray = TEd.rgb_to_gray(torch.from_numpy(frames))
    got = TEd.sobel_edges(gray, 100.0).numpy()
    want = np.asarray(JEd.sobel_edges(jnp.asarray(gray.numpy()), 100.0))
    assert want.any() and (~want).any()
    assert (got == want).mean() >= 0.999
    # zero padding: a flat frame has edges only at its border
    flat = torch.full((1, 8, 8), 200.0)
    edge = TEd.sobel_edges(flat, 100.0)[0]
    assert edge[0].all() and not edge[1:-1, 1:-1].any()
    mask = np.zeros((HW, HW), bool)
    mask[8:24, 6:20] = True
    for method in ("canny", "sobel"):
        g = float(TEd.edge_hit_rate(torch.from_numpy(frames[0]),
                                    torch.from_numpy(mask), method=method))
        w = float(JEd.edge_hit_rate(jnp.asarray(frames[0]),
                                    jnp.asarray(mask), method=method))
        assert g == pytest.approx(w, abs=1e-3), method
    assert float(TEd.edge_hit_rate(torch.from_numpy(frames[0]),
                                   torch.zeros(HW, HW, dtype=torch.bool))) == 0


def _qc_rows(out_dir):
    with open(out_dir / "qc_scores.csv") as f:
        return list(csv.reader(f))


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file() and p.name != "qc_scores.csv")


def test_create_pseudo_labels_outputs_match_jax(pth, pairs, tmp_path,
                                                jax_pth_members_f32):
    args = ["--images_root", str(pairs[0]), "--checkpoints", str(pth),
            "--img_size", str(HW), "--batch_size", "4", "--threshold",
            "0.5", "--max_per_bucket", "1000"]
    with pytest.warns(UserWarning, match="mesh DISABLED"):
        j_pseudo_cli.main(args + ["--out_dir", str(tmp_path / "j")])
    t_pseudo_cli.main(args + ["--out_dir", str(tmp_path / "t"),
                              "--device", "cpu"])
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    want, got = _qc_rows(tmp_path / "j"), _qc_rows(tmp_path / "t")
    assert got[0] == want[0] and len(got) == len(want) == 7
    for g, w in zip(got[1:], want[1:]):
        assert (g[0], g[6], g[7]) == (w[0], w[6], w[7])
        for a, b in zip(g[1:6], w[1:6]):
            unit = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= unit * 1.001, (g, w)


@pytest.mark.parametrize("name,args", [
    ("soft_dice", ()), ("iou_at", (0.4,)), ("dice_iou_at", (0.5,)),
    ("binary_dice_at", (0.3,)), ("precision_recall_f1", (0.6,)),
    ("eval_suite", (0.45,)),
    ("threshold_sweep_stats", (np.linspace(0.05, 0.95, 19),)),
    ("threshold_sweep_dice_smooth", (np.linspace(0.05, 0.95, 19),))])
def test_metrics_match_jax(name, args):
    """The metrics evaluate and the trainers read, rtol and atol 1e-6."""
    from cartseg_tpu import metrics as JM

    from cartseg_tpu_torch import metrics as TM

    r = np.random.default_rng(43)
    logits = (3 * r.standard_normal((3, 16, 16, 1))).astype(np.float32)
    targets = (r.random((3, 16, 16, 1)) > 0.5).astype(np.float32)
    want = getattr(JM, name)(jnp.asarray(logits), jnp.asarray(targets), *args)
    got = getattr(TM, name)(torch.from_numpy(logits),
                            torch.from_numpy(targets), *args)
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    elif not isinstance(want, tuple):
        got, want = [got], [want]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
