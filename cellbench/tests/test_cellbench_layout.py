"""The reader of `layout_transpose_ms.pseudo_label`: off a card it gives
None; on a stubbed `device_kernels` it sums the device time of cuDNN's
two layout transposes alone, a batch of PROFILE_UNITS, and reads 0.0
where kernels came back and none is a transpose. CPU only:

    python -m pytest --noconftest cellbench/tests/test_cellbench_layout.py
"""

from types import SimpleNamespace

import pytest
import torch

from cellbench import harness
from cellbench.tests.tiny import REPO
from cartseg_tpu_torch.utils import profiling

NAME = "layout_transpose_ms.pseudo_label"
NCHW_TO_NHWC = ("void cudnn::engines_precompiled::nchwToNhwcKernel"
                "<__nv_bfloat16>(cudnn::engines_precompiled::"
                "nchw2nhwc_params_t)")
NHWC_TO_NCHW = ("void cudnn::engines_precompiled::nhwcToNchwKernel"
                "<__nv_bfloat16>(cudnn::engines_precompiled::"
                "nhwc2nchw_params_t)")


@pytest.fixture(scope="module")
def reader():
    return harness._load_module(REPO / "cellbench" / "metrics" / f"{NAME}.py",
                                f"cellbench_metric_{NAME}")


def _ctx(device: str, units: list):
    def profiled_unit(ctx):
        return (lambda: units.append(1)), (lambda: None)

    return SimpleNamespace(kind="pseudo_label", device=torch.device(device),
                           cell=SimpleNamespace(driver=SimpleNamespace(
                               profiled_unit=profiled_unit)))


def _stub(monkeypatch, reader, answers: list):
    """device_kernels answering `answers` in turn, each after its calls of
    fn; the reader's pauses between retakes skipped."""
    calls = []

    def device_kernels(fn, calls_=1):
        for _ in range(calls_):
            fn()
        calls.append(calls_)
        return answers[min(len(calls), len(answers)) - 1]

    monkeypatch.setattr(profiling, "device_kernels", device_kernels)
    monkeypatch.setattr(reader.time, "sleep", lambda s: None)
    return calls


def test_none_off_a_card(reader):
    units = []
    assert reader.read(_ctx("cpu", units)) is None
    assert units == []
    assert reader.read(SimpleNamespace(kind="train",
                                       device=torch.device("cuda"))) is None


def test_sums_the_two_transposes_a_unit(monkeypatch, reader):
    kernels = {NCHW_TO_NHWC: (96, 111_550.0), NHWC_TO_NCHW: (96, 89_880.0),
               "void at::native::conv_depthwise2d_forward_kernel": (
                   48, 118_610.0),
               "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
               "nhwc": (120, 116_180.0)}
    units = []
    calls = _stub(monkeypatch, reader, [kernels])
    got = reader.read(_ctx("cuda", units))
    assert calls == [harness.PROFILE_UNITS]
    assert len(units) == harness.PROFILE_UNITS
    assert got == pytest.approx((111_550.0 + 89_880.0) * 1e-3
                                / harness.PROFILE_UNITS)


def test_zero_where_no_kernel_is_a_transpose(monkeypatch, reader):
    kernels = {"sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_"
               "nhwckrsc_nhwc": (120, 116_180.0),
               "Memcpy DtoH (Device -> Pageable)": (12, 125_531.0)}
    _stub(monkeypatch, reader, [kernels])
    assert reader.read(_ctx("cuda", [])) == 0.0


def test_an_empty_window_is_taken_again(monkeypatch, reader):
    calls = _stub(monkeypatch, reader, [{}, {}, {NHWC_TO_NCHW: (4, 400.0)}])
    assert reader.read(_ctx("cuda", [])) == pytest.approx(
        0.4 / harness.PROFILE_UNITS)
    assert len(calls) == 3
    calls = _stub(monkeypatch, reader, [{}])
    assert reader.read(_ctx("cuda", [])) is None
    assert len(calls) == reader.PROFILE_TRIES
