"""The SAM fine-tune cell's own pieces on the CPU: its configuration file
against the reference's sizes, the yardstick's counts, the flash
roofline's reading of a kernel table, the reference's float32 flags, its
faults' registration, and the spans of a traced run of the tiny cut (on
the CPU a span's device interval is its host interval, so the numbers
mean nothing of the card)."""

import json

import pytest
import torch

from cellbench import counts_sam, faults, harness, spans
from cellbench.reference import sam as ref
from cellbench.tests.tiny import REPO, make_root, tiny_name
from cellbench.weights_sam import make_weights

CELL = "train_medsam.vitb.bs16_1024"
SEED = 2 ** 31 + 53
TINY = ref.Sizes(img_size=64, patch_size=8, encoder_dim=32, encoder_depth=2,
                 encoder_heads=2, window_size=3, global_attn_indexes=(1,),
                 prompt_dim=16, decoder_heads=2, decoder_mlp_dim=32)


def _flash_reader():
    return harness._load_module(
        REPO / "cellbench/metrics/flash_roofline.train_sam.py", "flash_rf")


def test_configuration_file_gives_the_reference_sizes():
    conf = json.loads((REPO / "cellbench/configs/sam_vit_b.json").read_text())
    assert conf["reduced"] == []
    assert ref.sizes_of(conf, conf["img_size"]) == ref.Sizes()
    specs = ref.param_specs(ref.Sizes())
    assert sum(torch.Size(s).numel() for _, s, _ in specs) == \
        conf["parameters"] == 93731044
    assert sum(torch.Size(s).numel() for n, s, _ in specs
               if ref.trained(n)) == conf["trained_parameters"]


def test_attention_flops_by_hand():
    # bnh 2 x 2, S 64 (an 8 x 8 grid), d 16, one global block: 12 bnh S^2 d
    assert counts_sam.attention_flops(TINY, 2) == 12 * 4 * 64 * 64 * 16
    published = counts_sam.attention_flops(ref.Sizes(), 16)
    assert published == 12 * 16 * 12 * 4096 ** 2 * 64 * 4


def test_step_flops_grow_with_the_batch_and_hold_three_passes():
    one, two, three = (counts_sam.step_flops(TINY, b) for b in (1, 2, 3))
    # the grid's position encoding is made once a batch
    assert three - two == two - one < one
    # the encoder's linears alone, 2 FLOPs a multiply-add: the backward
    # adds two products a forward one, so a step holds at least 3x them
    d, g, w = TINY.encoder_dim, TINY.grid, TINY.window_size
    padded = (-(-g // w) * w) ** 2
    mlp = 2 * d * int(d * TINY.mlp_ratio)
    linears = 2 * (padded * 4 * d * d + g * g * mlp) \
        + 2 * (g * g * (4 * d * d + mlp))
    assert one > 3 * linears


def test_flash_us_reads_each_kernel_once_a_launch():
    read = _flash_reader()
    table = {"void flash_fwd_tc<64>(...)": (8, 100.0),
             "flash_bwd_dq_tc": (8, 200.0), "flash_bwd_dkv_tc": (8, 300.0),
             "ampere_bf16_gemm": (50, 1000.0)}
    assert read.flash_us(table, 8) == 600.0
    assert read.flash_us(table, 4) is None
    assert read.flash_us({k: v for k, v in table.items()
                          if "dkv" not in k}, 8) is None


def test_the_reference_runs_with_tf32_off(monkeypatch):
    seen = []
    model_call = ref.Model.__call__

    def spy(self, *args):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return model_call(self, *args)

    monkeypatch.setattr(ref.Model, "__call__", spy)
    traffic = json.loads((REPO / "cellbench/traffic/train_medsam.bs16_1024"
                          ".json").read_text())
    gen = torch.Generator().manual_seed(1)
    params = make_weights(TINY, gen, "cpu")
    batch = (torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8),
             (torch.rand((2, 64, 64, 1)) > 0.5).to(torch.float32))
    out = ref.follow(TINY, params, [batch], 5, traffic, chunk=16)
    assert seen == [(False, False)] and len(out["losses"]) == 1


def test_the_driver_registers_the_train_faults_it_takes():
    from cellbench.drivers import train_sam  # noqa: F401
    assert faults.FAULTS["train_sam"] == {
        "half_batch": faults.FAULTS["train"]["half_batch"]}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("cellbench_sam"))


def test_the_spans_of_a_traced_run(root):
    """Each step holds the image encoder's span with one windowed or
    global attention span a block, and the mask decoder's, all under
    `train.forward`; a name that repeats sums within its step."""
    kept = {}
    r = harness.run_cell(tiny_name(CELL), SEED, 0.2, True, "cpu", root,
                         log=lambda m: None,
                         hook=lambda ctx: kept.setdefault("ctx", ctx))
    assert r["correct"] is True
    for name in ("global_attn_span_ms.train_sam",
                 "window_attn_span_ms.train_sam",
                 "mask_decoder_span_ms.train_sam"):
        assert r["metrics"][name]["value"] > 0.0, name
    got = kept["ctx"].span_readings
    units = {}
    for rec in got.records:
        units.setdefault(rec.unit, []).append(rec)
    assert len(units) == spans.UNITS
    conf = json.loads((REPO / "cellbench/configs/sam_vit_b.json").read_text())
    n_global = len(conf["global_attn_indexes"])
    for recs in units.values():
        by_id = {x.id: x for x in recs}
        names = [x.name for x in recs]
        assert names.count("sam.global_attn") == n_global
        assert names.count("sam.window_attn") == \
            conf["encoder_depth"] - n_global
        assert names.count("sam.image_encoder") == 1
        assert names.count("sam.mask_decoder") == 1
        for x in recs:
            if x.name in ("sam.image_encoder", "sam.mask_decoder"):
                assert by_id[x.parent].name == "train.forward"
            elif x.name.startswith("sam."):
                assert by_id[x.parent].name == "sam.image_encoder"
        attn = [x for x in recs if x.name == "sam.global_attn"]
        summed = got.spans["sam.global_attn"]
        assert summed["units"] == spans.UNITS
        assert sum(x.host_ms for x in attn) > max(x.host_ms for x in attn)
