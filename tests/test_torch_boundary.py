"""Port parity: the SDF boundary loss of cartseg_tpu_torch
(losses/boundary.py) against the JAX package on the CPU, and the
`train_with_boundary_loss` workload.

Every JAX call here runs its EDT at one shape, [4,24,32] (JAX's eager
EDT compiles each of its ops once per new shape, 6-8 s; `jax.vmap` of
`signed_distance_map` runs the same batched ops as `batch_sdf`).

Tolerances (float32 on the CPU, the same numpy inputs to both):
  * signed_distance_map and batch_sdf: bit-equal (the port's EDT equals
    JAX's XLA lane bit for bit; the rest is a select, a subtraction and
    one division);
  * symmetric_boundary_loss and composite_seg_loss: rtol 1e-5 on the
    value, atol 1e-7 on the gradient w.r.t. the logits (means over 3072
    elements, summed in another order; the gradient is ~1e-4 in size).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.losses import boundary as JB
from cartseg_tpu.workloads import train_with_boundary_loss as j_workload

from cartseg_tpu_torch.losses import boundary as TB
from cartseg_tpu_torch.train.engine import resolve_loss
from cartseg_tpu_torch.train import LossSpec
from cartseg_tpu_torch.utils.synthetic import blob_masks
from cartseg_tpu_torch.workloads import train_with_boundary_loss as t_workload
from torch_port_helpers import one_torch_thread, png_pair_tree  # noqa: F401
from torch_port_helpers import pinned_jax_native  # noqa: F401

SHAPE = (4, 24, 32)
HW, BS = 64, 2


def _masks():
    """[4,24,32,1] float masks: two of blobs, one all background and one
    all foreground (the degenerate SDFs)."""
    m = np.zeros(SHAPE + (1,), np.float32)
    m[:2, ..., 0] = blob_masks(np.random.default_rng(0), (2,) + SHAPE[1:],
                               n=3)
    m[3] = 1.0
    return m


def _logits(m, seed=1):
    r = np.random.default_rng(seed)
    return (r.normal(size=m.shape) * 2 + (2 * m - 1) * 1.5).astype(np.float32)


def test_signed_distance_map_bit_equal():
    m = _masks()[..., 0]
    want = np.asarray(jax.vmap(JB.signed_distance_map)(jnp.asarray(m)))
    got = np.stack([TB.signed_distance_map(torch.from_numpy(mi)).numpy()
                    for mi in m])
    np.testing.assert_array_equal(got, want)
    assert (got[2:] == 0).all() and (got[0] < 0).any() and (got[0] > 0).any()


def test_batch_sdf_bit_equal_with_degenerate_masks():
    m = _masks()
    want = np.asarray(JB.batch_sdf(jnp.asarray(m)))
    got = TB.batch_sdf(torch.from_numpy(m))
    assert got.shape == m.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[2:] == 0).all()


def _check_value_and_grad(jfn, tfn):
    m = _masks()
    x = _logits(m)
    jv, jg = jax.value_and_grad(lambda v: jfn(v, jnp.asarray(m)))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = tfn(t, torch.from_numpy(m))
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("kw", [{}, {"t": 0.3, "w_pred": 0.8,
                                     "use_abs": False, "scale": 2.0}])
def test_symmetric_boundary_loss_matches_jax(kw):
    _check_value_and_grad(
        lambda v, m: JB.symmetric_boundary_loss(v, m, **kw),
        lambda v, m: TB.symmetric_boundary_loss(v, m, **kw))


def test_composite_seg_loss_matches_jax():
    """At the workload's weights, with a symmetric-loss argument passed
    through."""
    kw = {"bce_weight": 0.5, "boundary_weight": 0.3, "w_gt": 0.5}
    _check_value_and_grad(
        lambda v, m: JB.composite_seg_loss(v, m, **kw),
        lambda v, m: TB.composite_seg_loss(v, m, **kw))


def test_engine_resolves_the_boundary_name():
    m = torch.from_numpy(_masks())
    x = torch.from_numpy(_logits(_masks()))
    kw = {"bce_weight": 0.5, "boundary_weight": 0.3}
    loss, comps = resolve_loss(LossSpec("boundary", kw))(x, m, None)
    assert comps == {}
    assert torch.equal(loss, TB.composite_seg_loss(x, m, **kw))


def test_workload_config_equals_the_jax_literal():
    port = dataclasses.asdict(t_workload.CONFIG)
    assert port.pop("device") == "cuda"
    assert port == dataclasses.asdict(j_workload.CONFIG)


def test_workload_cpu_run_writes_the_artifacts(png_pair_tree, tmp_path):
    """A CPU run through the entry point at 64^2 bs2 for 2 epochs (both in
    the freeze phase): the `prf1` CSV, history, model.pth, its threshold
    sidecar and model.last.pth."""
    ir, mr = png_pair_tree
    result = t_workload.main(
        ["--images_root", str(ir), "--masks_root", str(mr),
         "--out_dir", str(tmp_path), "--img_size", str(HW),
         "--batch_size", str(BS), "--epochs", "2", "--device", "cpu"],
        log=lambda m: None)
    rows = (tmp_path / "training_metrics.csv").read_text().splitlines()
    assert rows[0].split(",") == [
        "epoch", "phase", "train_loss", "val_loss", "val_dice", "val_iou",
        "val_precision", "val_recall", "val_f1", "lr_encoder",
        "lr_decoder", "lr_head"]
    assert len(rows) == 3
    for row in rows[1:]:
        vals = [float(v) for v in row.split(",")]
        assert all(np.isfinite(vals))
        assert vals[1] == 0 and vals[9] == 0.0     # encoder frozen
    for f in ("history.json", "model.pth", "model.threshold.json",
              "model.last.pth"):
        assert (tmp_path / f).exists(), f
    assert 0.2 <= result["threshold"] <= 0.8


def test_cuda_is_refused_without_a_card(png_pair_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ir, mr = png_pair_tree
    with pytest.raises(RuntimeError, match="cuda"):
        t_workload.main(["--images_root", str(ir), "--masks_root", str(mr),
                         "--out_dir", str(tmp_path), "--img_size", str(HW)])
