"""Data parallelism of the port (cartseg_tpu_torch/parallel, the synced
BatchNorm of models/norm.py, the DDP Trainer, ABL over the ranks, the
row-split inference program) on the CPU.

The process-group cases run once, in two gloo ranks of
tests/torch_dist_worker.py (file:// rendezvous under tmp_path, no fixed
port), and are held against the same calls in this one process:
  * synced BN, each lane, 2 ranks x 4 rows against one process on the 8
    rows: y, dx and the ranks' summed dgamma and dbeta within 1e-5 of
    max |.|, the running statistics within 1e-6;
  * one Trainer step (resnet18-UNet 32^2, global batch 8, fp32,
    train_512): parameters, buffers and gradients bit-identical across
    the ranks. The same step in float64 (the model's, through DDP and the
    synced BN): the gradient within 1e-10 relative L2 of the one-process
    step. In fp32 this model's gradient is ill conditioned (a ReLU input
    within roundoff of 0 flips; train-mode BN over a layer4 channel's 8
    values spreads it upstream): the one-process step lies 4e-3 from
    float64 and moves 5e-3 between one and four threads, so the fp32 DDP
    gradient is held as chip_smoke.py phase 4e holds a BN lane: no
    farther from the float64 gradient than twice the one-process fp32
    step is;
  * a 2-epoch fit at lr 1e-3, tests/test_distributed.py's (no
    augmentation): within 5e-3 per leaf (AdamW is sign-sensitive at its
    first steps, that test's reasoning) and best val Dice within 1e-4;
  * bce_dice_abl over the ranks: the global eps and n_valid, the mean of
    the ranks' losses and their gradients (over world size) the one
    process's;
  * the classic UNet's DDP gradient against JAX's single-device gradient
    at tests/test_parallel.py:22-56's setup, through models/convert.py,
    within 2e-4 (tests/test_torch_parity.py's tolerance).
"""

import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_worker as W
from cartseg_tpu_torch.data.augment import AugmentConfig, augment_batch
from cartseg_tpu_torch.data.pipeline import Loader
from cartseg_tpu_torch.device import fp32_policy
from cartseg_tpu_torch.infer import engine as TE
from cartseg_tpu_torch.infer import mining as TMi
from cartseg_tpu_torch.infer import pseudo_labels as TPL
from cartseg_tpu_torch.models import build_model
from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict
from cartseg_tpu_torch.parallel import mesh
from cartseg_tpu_torch.utils.synthetic import frame, make_png_tree
from torch_port_helpers import jax_tree_to_numpy, one_torch_thread  # noqa

REPO = Path(__file__).resolve().parent.parent
WORLD = 2


def _max_rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _rel_l2(a: dict, b: dict) -> float:
    return float(torch.cat([(a[k] - b[k]).reshape(-1) for k in b]).norm()
                 / torch.cat([b[k].reshape(-1) for k in b]).norm())


@pytest.fixture(scope="module")
def classic_jax():
    """tests/test_parallel.py:22-56: the classic UNet's single-device
    gradient in JAX, and the same weights as a port state dict."""
    from cartseg_tpu.losses import bce_dice_loss
    from cartseg_tpu.models import build_model as jax_build, init_model

    model = jax_build("classic", dtype=jnp.float32)
    v = init_model(model, jax.random.key(0), (1, 16, 16, 3))
    x, y = (t.numpy() for t in W.classic_batch())

    def loss_fn(params, x, y):
        out = model.apply({"params": params}, x)
        eps = 1e-6
        logits = jnp.log(out + eps) - jnp.log1p(-out + eps)
        return bce_dice_loss(logits, y)

    g = jax.jit(jax.grad(loss_fn))(v["params"], jnp.asarray(x),
                                   jnp.asarray(y))
    sd = jax_variables_to_state_dict(jax_tree_to_numpy(v), "classic")
    grads = jax_variables_to_state_dict(
        {"params": jax_tree_to_numpy(g)}, "classic")
    return sd, grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, classic_jax):
    """Both ranks' results (tests/torch_dist_worker.py)."""
    out = tmp_path_factory.mktemp("dist")
    torch.save(classic_jax[0], out / "classic_sd.pt")
    init = out / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(init), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(REPO))
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for r, (p, lg) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{lg[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _ok(res: dict, case: str):
    got = res[case]
    assert "error" not in got, got.get("error")
    return got


def test_ranks_ran_gloo_on_their_rows(ranks):
    assert [r["backend"] for r in ranks] == ["gloo"] * WORLD
    assert [r["rows"] for r in ranks] == [(0, 4), (4, 8)]


@pytest.mark.parametrize("lane", ["torch", "channel_sums"])
def test_synced_bn_equals_one_process(ranks, lane):
    x, w, b, g = W.bn_inputs()
    want = W.run_bn(lane, x, w, b, g, None)
    got = [_ok(r, f"bn_{lane}") for r in ranks]
    for k in ("y", "dx"):
        assert _max_rel(torch.cat([o[k] for o in got]), want[k]) <= 1e-5, k
    for k in ("dgamma", "dbeta"):
        # each rank holds its rows' share; DDP averages them
        assert _max_rel(got[0][k] + got[1][k], want[k]) <= 1e-5, k
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[0][k], got[1][k])
        assert float((got[0][k] - want[k]).abs().max()) <= 1e-6, k


def test_ddp_step_float64_equals_one_process(ranks):
    want = W.run_step64(slice(0, W.GLOBAL_BS), None)
    got = [_ok(r, "step64") for r in ranks]
    for k, v in got[0].items():
        assert torch.equal(v, got[1][k]), k
    assert _rel_l2(got[0], want) <= 1e-10


def test_ddp_step_equals_one_process(ranks):
    want = W.run_step(W.step_config(), slice(0, W.GLOBAL_BS))
    g64 = W.run_step64(slice(0, W.GLOBAL_BS), None)
    got = [_ok(r, "step") for r in ranks]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    for k, v in got[0]["grads"].items():
        assert torch.equal(v, got[1]["grads"][k]), k
    e_one = _rel_l2({k: v.double() for k, v in want["grads"].items()}, g64)
    e_ddp = _rel_l2({k: v.double() for k, v in got[0]["grads"].items()},
                    g64)
    assert e_ddp <= max(1e-5, 2 * e_one), (e_ddp, e_one)
    # the BN buffers took the global batch's statistics
    for k, v in want["state"].items():
        if k.endswith(("running_mean", "running_var")):
            assert float((got[0]["state"][k] - v).abs().max()) <= 1e-5, k


def test_ddp_fit_equals_one_process(ranks, tmp_path):
    want = W.run_fit(W.fit_config(tmp_path))
    got = [_ok(r, "fit") for r in ranks]
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
        np.testing.assert_allclose(v.double().numpy(),
                                   want["state"][k].double().numpy(),
                                   atol=5e-3, rtol=5e-3, err_msg=k)
    assert got[0]["best_val_dice"] == got[1]["best_val_dice"]
    assert abs(got[0]["best_val_dice"] - want["best_val_dice"]) < 1e-4
    assert got[0]["threshold"] == want["threshold"]


def test_files_are_written_by_rank_zero_only(ranks):
    assert ranks[1]["writes"] == []
    assert {"save", "save_threshold_sidecar", "append"} <= set(
        ranks[0]["writes"])


def test_indivisible_batch_and_lone_ranks_raise(ranks):
    for r in ranks:
        assert "not divisible by process_count 2" in r["odd_batch"]
        assert "use_mesh=False" in r["no_mesh"]


def test_abl_over_ranks_equals_one_process(ranks):
    logits, t = W.abl_inputs()
    want = W.run_abl(logits, t, None)
    got = [_ok(r, "abl") for r in ranks]
    assert float(want["boundary_used"]) == 1.0
    for k in ("total", "region", "boundary"):
        mean = (got[0][k] + got[1][k]) / WORLD
        assert abs(float(mean - want[k])) <= 1e-6 * max(
            1.0, abs(float(want[k]))), k
    # the boundary term and its gate are global: equal on both ranks
    assert torch.equal(got[0]["boundary"], got[1]["boundary"])
    grad = torch.cat([o["grad"] for o in got]) / WORLD
    assert _max_rel(grad, want["grad"]) <= 1e-5


def test_sharded_step_matches_jax(ranks, classic_jax):
    _, want = classic_jax
    got = [_ok(r, "classic") for r in ranks]
    for k, v in want.items():
        assert torch.equal(got[0][k], got[1][k]), k
        np.testing.assert_allclose(got[0][k].numpy(), v.numpy(), atol=2e-4,
                                   rtol=2e-4, err_msg=k)


def test_dryrun_two_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "cartseg_tpu_torch.parallel.dryrun", "--n",
         "2", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "ok" in proc.stdout.split()


# ------------------------------------------------------ one process

def test_single_process_helpers():
    assert not mesh.is_initialized()
    assert mesh.process_count() == 1 and mesh.process_index() == 0
    assert mesh.is_main_process()
    mesh.barrier("unit-test")
    assert mesh.host_batch_slice(7) == slice(0, 7)
    assert mesh.backend_for("cpu", 1) == "gloo"
    assert mesh.backend_for("cuda", torch.cuda.device_count() + 1) == "gloo"
    assert mesh.training_group(True, 7) is None
    assert mesh.local_device("cpu") == torch.device("cpu")
    assert not mesh.maybe_initialize_distributed("cpu")


def test_global_draws_give_each_rank_its_rows():
    """A rank's augmentation of its rows, from draws at the global batch,
    is the one process's augmentation of those rows."""
    imgs, masks = W.step_batch()
    cfg = AugmentConfig.train_512()
    g1 = torch.Generator().manual_seed(3)
    want = augment_batch(g1, imgs, masks, cfg)
    for rows in (slice(0, 4), slice(4, 8)):
        g = torch.Generator().manual_seed(3)
        got = augment_batch(g, imgs[rows], masks[rows], cfg, rows, 8)
        assert torch.equal(got[0], want[0][rows])
        assert torch.equal(got[1], want[1][rows])


def test_loader_reads_its_rows_of_each_batch():
    class DS:
        def load(self, i, device):
            return (np.full((2, 2, 3), i, np.uint8),
                    np.zeros((2, 2), np.float32))

    loader = Loader(DS(), 4, device="cpu", num_threads=1,
                    rows=lambda n: slice(2, 4))
    order = np.arange(10)[::-1]
    got = [imgs[:, 0, 0, 0].tolist() for imgs, _ in loader(order)]
    assert got == [[7, 6], [3, 2]]


@pytest.fixture(scope="module")
def members():
    out = []
    for i, w in enumerate((1.0, 2.0)):
        torch.manual_seed(20 + i)
        out.append(TE.EnsembleMember(
            TE.prepare_model(build_model("efficientnet-b0"), "cpu"), w, 0.5))
    return out


@pytest.fixture(scope="module")
def frames():
    r = np.random.default_rng(9)
    return torch.from_numpy(np.stack([frame(r, (32, 32)) for _ in range(4)]))


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_sharded_programs_bit_equal_on_two_cpus(members, frames):
    prog = TE.pseudo_label_program(members, TPL.IMAGENET_MEAN,
                                   TPL.IMAGENET_STD, min_area=4)
    mine = TMi.mining_program(members, TPL.IMAGENET_MEAN, TPL.IMAGENET_STD,
                              0.5, 0.05)
    for p, args in ((prog, (0.5,)), (mine, ())):
        sharded = mesh.shard_inference_program(p, 4, ["cpu", "cpu"],
                                               log=lambda *a: None)
        assert sharded is not p
        assert _equal(sharded(frames, *args), p(frames, *args))
        # a replica on another device entry is a copy of the members
        rep = p.replicate(torch.device("cpu"))
        assert _equal(rep(frames, *args), p(frames, *args))


def test_shard_leaves_one_device_and_odd_batches_alone(members):
    prog = TE.pseudo_label_program(members, (0, 0, 0), (1, 1, 1), 4)
    assert mesh.shard_inference_program(prog, 4) is prog
    assert mesh.shard_inference_program(prog, 4, ["cpu"]) is prog
    with pytest.warns(UserWarning, match="sharding DISABLED"):
        assert mesh.shard_inference_program(prog, 3, ["cpu", "cpu"]) is prog


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_pseudo_label_tree_with_use_mesh_equals_without(members, tmp_path,
                                                        monkeypatch):
    images = make_png_tree(tmp_path / "src", 2, 3, (32, 32), seed=2)
    real = mesh.shard_inference_program
    split = []

    def two_cpus(program, batch_size, devices=None, **kw):
        split.append(batch_size)
        return real(program, batch_size, ["cpu", "cpu"], **kw)

    monkeypatch.setattr(TPL, "shard_inference_program", two_cpus)
    trees = []
    for use_mesh in (True, False):
        out = tmp_path / f"out_{use_mesh}"
        cfg = TPL.PseudoLabelConfig(
            images_root=str(images), out_dir=str(out), img_size=32,
            batch_size=4, threshold=0.5, max_per_bucket=1000,
            use_mesh=use_mesh)
        TPL.generate_pseudo_labels(members, cfg, device="cpu",
                                   log=lambda *a: None)
        trees.append(_tree(out))
    assert split == [4]
    assert trees[0] == trees[1] and len(trees[0]) > 6


def test_programs_restore_the_tf32_flags(members, frames):
    """The inference programs turn TF32 off for their call only (ROADMAP
    Queue 3's set_fp32_policy repair)."""
    prog = TE.pseudo_label_program(members, (0, 0, 0), (1, 1, 1), 4)
    mine = TMi.mining_program(members, (0, 0, 0), (1, 1, 1), 0.5, 0.05)
    seen = []
    real = TE.remove_small_components

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **kw)

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for state in ((True, True), (False, True), (True, False)):
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = state
            TE.remove_small_components = spy
            try:
                prog(frames, 0.5)
            finally:
                TE.remove_small_components = real
            mine(frames)
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == state
            assert seen[-1] == (False, False)
            with fp32_policy():
                pass
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == state
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TE.pseudo_label_program(members, (0, 0, 0), (1, 1, 1), 4)
    assert flags == (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
