"""The pseudo-labeller's members on the card: stored NHWC
(`channels_last`) by `prepare_model`, fed the permuted NHWC frames with
no NCHW copy (infer/engine.py `model_input`). Every test here is marked
`cuda` and skips without a card.

This file imports no JAX (the GPU machines have none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_infer_cuda.py

One layout transpose stays: cuDNN writes the one-channel head's output
through `nhwcToNchw` in either layout (a profiler trace maps it to the
head's `cudnn_convolution`), once a member's forward.

The NHWC members' flip-TTA probabilities are held to a float32 NCHW copy
of the same members against the bf16 NCHW path's own distance from it:
at most 6 times as far (the `probs_ratio` limit of the benchmark's
pseudo-label check). The exported serving artifact is held to its eager
module as chip_smoke.py's phase 4k holds it: equal, or within 2^-8.
"""

import copy
import time

import pytest
import torch

from cartseg_tpu_torch.device import fp32_policy
from cartseg_tpu_torch.infer.engine import (EnsembleMember,
                                            ensemble_probs_fn,
                                            prepare_model,
                                            pseudo_label_program)
from cartseg_tpu_torch.models.factory import build_model
from cartseg_tpu_torch.serve import export_segmenter, load_segmenter
from cartseg_tpu_torch.serve.export import inference_module
from cartseg_tpu_torch.utils.profiling import device_kernels

pytestmark = pytest.mark.cuda

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
BS, HW, WEIGHTS = 4, 256, (1.0, 3.0)
# the kernels of the NCHW path: cuDNN's layout transposes and ATen's
# depthwise convolution
NCHW_KERNELS = ("nchwToNhwc", "nhwcToNchw", "conv_depthwise2d")
# cuDNN's transpose of the one-channel head's output, in either layout
HEAD_TRANSPOSE = "nhwcToNchw"
PROBS_RATIO = 6.0
EXPORT_TOL = 2.0 ** -8


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is "
                    "false); run on the GPU machine: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_infer_cuda.py")
    return torch.device("cuda")


def _state_dicts():
    """Two effnet-b0 UNets from seeds, their heads' weights 1000x wider
    and their biases 0, so that the logits spread over several units (at
    the default init they lie within 0.01 of the bias)."""
    out = []
    for seed in (21, 22):
        torch.manual_seed(seed)
        model = build_model("efficientnet-b0")
        with torch.no_grad():
            model.segmentation_head[0].weight.mul_(1000.0)
            model.segmentation_head[0].bias.zero_()
        out.append(model.state_dict())
    return out


@pytest.fixture(scope="module")
def state_dicts(card):
    return _state_dicts()


def _members(state_dicts, device, dtype=None):
    members = []
    for sd, w in zip(state_dicts, WEIGHTS):
        model = build_model("efficientnet-b0")
        model.load_state_dict(sd)
        members.append(EnsembleMember(prepare_model(model, device, dtype), w))
    return members


@pytest.fixture(scope="module")
def members(state_dicts, card):
    return _members(state_dicts, card)


@pytest.fixture(scope="module")
def frames(card):
    g = torch.Generator(device=card).manual_seed(7)
    return torch.randint(0, 256, (BS, HW, HW, 3), generator=g, device=card,
                         dtype=torch.uint8)


def _kernels(fn) -> dict:
    """device_kernels of one call of fn after a warm call, taken again
    where torch.profiler lost the whole window."""
    fn()
    for i in range(6):
        time.sleep(0.5 * i)
        got = device_kernels(fn)
        if got:
            return got
    pytest.fail("torch.profiler returned no kernel in 6 windows")


def _nchw(members):
    """The same members and their input in NCHW on the card (the layout
    before `channels_last`): each member casts a contiguous NCHW copy."""
    models = [copy.deepcopy(m.model).to(memory_format=torch.contiguous_format)
              for m in members]
    ws = [m.weight / sum(WEIGHTS) for m in members]

    @torch.inference_mode()
    def forward_tta(images_u8):
        x = torch.cat([images_u8, images_u8.flip(2)], 0)
        m = torch.tensor(MEAN, device=x.device)
        s = torch.tensor(STD, device=x.device)
        x = ((x.to(torch.float32) / 255.0 - m) / s).permute(0, 3, 1, 2)
        x = x.contiguous()
        p = sum(w * torch.sigmoid(model(x.to(next(model.parameters()).dtype))
                                  [:, 0].to(torch.float32))
                for model, w in zip(models, ws))
        return p[:BS], p[BS:].flip(-1)

    return forward_tta


def test_prepare_model_stores_the_card_members_nhwc(members):
    for m in members:
        weights = [p for p in m.model.parameters() if p.dim() == 4]
        assert weights and all(
            p.is_contiguous(memory_format=torch.channels_last)
            for p in weights)
        assert next(m.model.parameters()).dtype == torch.bfloat16


def test_program_runs_no_aten_depthwise_and_only_the_heads_transpose(
        members, frames):
    program = pseudo_label_program(members, MEAN, STD, min_area=64)
    with torch.inference_mode():
        got = _kernels(lambda: program(frames, 0.5))
    hit = sorted(n for n in got if any(k in n for k in NCHW_KERNELS)
                 and HEAD_TRANSPOSE not in n)
    assert not hit, hit
    # at most the head's, one launch a member
    assert sum(n for name, (n, _) in got.items()
               if HEAD_TRANSPOSE in name) <= len(members)
    # the names are the ones the NCHW path launches
    old = _kernels(lambda: _nchw(members)(frames))
    for k in NCHW_KERNELS:
        assert any(k in n for n in old), (k, sorted(old))
    assert sum(n for name, (n, _) in old.items()
               if HEAD_TRANSPOSE in name) > len(members)


def test_nhwc_probs_within_the_bf16_gap_of_nchw(members, state_dicts,
                                                frames):
    with fp32_policy():
        want = _nchw(_members(state_dicts, frames.device,
                              torch.float32))(frames)
        got = ensemble_probs_fn(members, MEAN, STD, tta_flip=True)(frames)
        nchw = _nchw(members)(frames)
    for g, n, w in zip(got, nchw, want):
        gap = float((n - w).abs().mean())
        assert gap > 0.0
        assert float((g - w).abs().mean()) <= PROBS_RATIO * gap


def test_exported_artifact_on_the_card(state_dicts, frames, tmp_path):
    art = export_segmenter(tmp_path / "artifact", state_dict=state_dicts[0],
                           encoder="efficientnet-b0", img_hw=(HW, HW),
                           batch_size=BS, compute_dtype="bfloat16",
                           device="cuda")
    served = load_segmenter(art)
    eager = inference_module(state_dicts[0], "efficientnet-b0", "cuda",
                             "bfloat16", False)
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in eager.model.parameters() if p.dim() == 4)
    with torch.inference_mode():
        want = eager(frames)
        got = torch.from_numpy(served.predict_probs(frames.cpu().numpy()))
    err = float((got - want.cpu()).abs().max())
    assert err <= EXPORT_TOL, err
