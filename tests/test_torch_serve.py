"""Serving in the port (cartseg_tpu_torch/serve) on the CPU, against the
JAX package's serve/ and as tests/test_serve.py holds it.

The port's artifact (torch.export, fp32, resnet18 at 64^2, batch 4,
threshold 0.4, as tests/test_serve.py:21-29) from JAX's init through
models/convert.py, against JAX's `export_segmenter` artifact of the same
variables: probabilities within 2e-4 (tests/test_torch_parity.py's
tolerance for these models); `segment`'s masks equal wherever the
letterboxed probability is more than that away from the threshold (a
100x160 frame letterboxes to 192^2, an integer multiple of 64, where the
native loader equals JAX's cv2 letterbox bit for bit). The artifact is
bit-equal to the eager module it was exported from. The MicroBatcher,
service, manifest and HTTP cases are tests/test_serve.py's, in the port.
"""

import json
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartseg_tpu.models import build_model as jax_build, init_model
from cartseg_tpu.serve import export_segmenter as jax_export
from cartseg_tpu.serve import load_segmenter as jax_load

from cartseg_tpu_torch import geometry
from cartseg_tpu_torch.models.convert import jax_variables_to_state_dict
from cartseg_tpu_torch.serve import (MicroBatcher, SegmentationService,
                                     export_segmenter, load_segmenter,
                                     validate_manifest)
from cartseg_tpu_torch.serve import export as export_mod
from cartseg_tpu_torch.serve import server as server_mod
from cartseg_tpu_torch.utils import image_io
from torch_port_helpers import jax_tree_to_numpy, one_torch_thread  # noqa

HW, BS, THR = 64, 4, 0.4


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port artifact dir, JAX artifact dir, port state dict)."""
    model = jax_build("resnet18", dtype=jnp.float32)
    variables = init_model(model, jax.random.key(0), (1, HW, HW, 3))
    jd = tmp_path_factory.mktemp("jax_artifact")
    jax_export(jd, variables=variables, encoder="resnet18", img_hw=(HW, HW),
               batch_size=BS, threshold=THR, compute_dtype="float32")
    sd = jax_variables_to_state_dict(jax_tree_to_numpy(variables),
                                     "resnet18")
    td = tmp_path_factory.mktemp("port_artifact")
    export_segmenter(td, state_dict=sd, encoder="resnet18", img_hw=(HW, HW),
                     batch_size=BS, threshold=THR, compute_dtype="float32",
                     device="cpu")
    return td, jd, sd


@pytest.fixture(scope="module")
def served(artifacts):
    return load_segmenter(artifacts[0])


def _frames(rng, n):
    return rng.integers(0, 255, (n, HW, HW, 3)).astype(np.uint8)


def test_manifest_carries_the_port_format(artifacts, served, tmp_path):
    m = served.manifest
    assert m["format"] == "cartseg_tpu_torch.segmenter"
    assert m["artifact_version"] == 1 and m["platforms"] == ["cpu"]
    assert (m["threshold"], m["batch_size"], m["img_hw"]) == (THR, BS,
                                                              [HW, HW])
    assert served.device == torch.device("cpu")
    # an artifact is served on the device it was exported for
    d = tmp_path / "card_only"
    shutil.copytree(artifacts[0], d)
    (d / "manifest.json").write_text(json.dumps({**m,
                                                 "platforms": ["cuda"]}))
    with pytest.raises(ValueError, match="exported for"):
        load_segmenter(d, device="cpu")


def test_artifact_matches_jax_artifact(artifacts, served, rng):
    x = _frames(rng, BS)
    want = np.asarray(jax_load(artifacts[1]).predict_probs(x))
    np.testing.assert_allclose(served.predict_probs(x), want, atol=2e-4,
                               rtol=2e-4)


def test_segment_agrees_with_jax_away_from_threshold(artifacts, served,
                                                     rng):
    jsv = jax_load(artifacts[1])
    for _ in range(2):
        img = rng.integers(0, 255, (100, 160, 3)).astype(np.uint8)
        got, want = served.segment(img), jsv.segment(img)
        assert got.shape == want.shape == (100, 160)
        assert set(np.unique(got)) <= {0, 255}
        # the letterboxed probabilities within the tolerance of the
        # threshold, taken back to the frame as the masks are
        lb = geometry.letterbox_resize(img, HW)
        p = np.asarray(jsv.predict_probs(lb[None]))[0]
        near = geometry.remove_letterbox(
            (np.abs(p - THR) <= 2e-4).astype(np.uint8), orig_w=160,
            orig_h=100) > 0
        assert not ((got != want) & ~near).any()


def test_artifact_bit_equal_to_eager(artifacts, served, rng):
    eager = export_mod.inference_module(artifacts[2], "resnet18", "cpu",
                                        "float32", False)
    x = _frames(rng, BS)
    with torch.no_grad():
        want = eager(torch.from_numpy(x)).numpy()
    assert np.array_equal(served.predict_probs(x), want)


def test_ragged_batch_padding(served, rng):
    x = _frames(rng, 2)
    probs = served.predict_probs(x)
    assert probs.shape == (2, HW, HW)
    full = served.predict_probs(np.concatenate([x, np.zeros_like(x)]))
    np.testing.assert_allclose(probs, full[:2], atol=1e-6)
    with pytest.raises(ValueError):
        served.predict_probs(_frames(rng, 5))


def test_export_cli_reads_the_sidecar(artifacts, tmp_path):
    pth = tmp_path / "model.pth"
    torch.save({"epoch": 0, "model_state_dict": artifacts[2]}, pth)
    (tmp_path / "model.threshold.json").write_text('{"threshold": 0.35}')
    out = export_mod.main(["--checkpoint", str(pth), "--out",
                           str(tmp_path / "a"), "--encoder", "resnet18",
                           "--img", str(HW), "--batch_size", "2",
                           "--compute_dtype", "float32", "--device", "cpu"])
    m = validate_manifest(out)
    assert (m["threshold"], m["batch_size"]) == (0.35, 2)
    with pytest.raises(NotImplementedError, match="relay"):
        export_mod.main(["--checkpoint", str(pth), "--out",
                         str(tmp_path / "b"), "--no_embed_params",
                         "--device", "cpu"])


def test_micro_batcher_batches_and_preserves_order():
    seen = []

    def run(items):
        seen.append(len(items))
        return [i * 10 for i in items]

    mb = MicroBatcher(run, batch_size=4, max_latency_ms=50)
    futs = [mb.submit(i) for i in range(6)]
    assert [f.result(timeout=5) for f in futs] == [0, 10, 20, 30, 40, 50]
    mb.close()
    assert sum(seen) == 6
    assert max(seen) <= 4


def test_micro_batcher_flushes_on_the_timer():
    seen = []
    mb = MicroBatcher(lambda items: seen.append(len(items)) or items,
                      batch_size=8, max_latency_ms=30)
    assert mb.submit(1).result(timeout=5) == 1
    mb.close()
    assert seen == [1]


def test_micro_batcher_propagates_errors():
    def run(items):
        raise RuntimeError("device fell over")

    mb = MicroBatcher(run, batch_size=2, max_latency_ms=10)
    f = mb.submit(1)
    with pytest.raises(RuntimeError, match="fell over"):
        f.result(timeout=5)
    mb.close()


def test_micro_batcher_per_item_error_isolation():
    def run(items):
        return [ValueError(f"bad {i}") if i == 2 else i * 10
                for i in items]

    mb = MicroBatcher(run, batch_size=4, max_latency_ms=50)
    futs = [mb.submit(i) for i in range(4)]
    assert futs[0].result(timeout=5) == 0
    assert futs[1].result(timeout=5) == 10
    with pytest.raises(ValueError, match="bad 2"):
        futs[2].result(timeout=5)
    assert futs[3].result(timeout=5) == 30
    mb.close()


def test_service_concurrent_requests_equal_segment(artifacts, served, rng):
    svc = SegmentationService(artifacts[0], max_latency_ms=30,
                              warmup_iters=1)
    imgs = [rng.integers(0, 255, (48 + 8 * i, 80, 3)).astype(np.uint8)
            for i in range(6)]
    futs = [svc.submit(im) for im in imgs]
    for im, f in zip(imgs, futs):
        got = f.result(timeout=30)
        assert got.shape == im.shape[:2]
        assert np.array_equal(got, served.segment(im))
    assert svc.requests == 6 and 2 <= svc.device_calls <= 6
    svc.close()


def test_service_isolates_bad_geometry(artifacts, rng):
    """A request whose inverse letterbox blows up fails alone; the other
    requests of its device batch still succeed."""
    svc = SegmentationService(artifacts[0], max_latency_ms=100,
                              warmup_iters=1)
    real = geometry.remove_letterbox

    def flaky(mask, orig_w, orig_h):
        if orig_w == 13:  # poison pill
            raise RuntimeError("geometry exploded")
        return real(mask, orig_w=orig_w, orig_h=orig_h)

    svc._geo = type("G2", (), {
        "remove_letterbox": staticmethod(flaky),
        "letterbox_resize": staticmethod(geometry.letterbox_resize)})
    good = rng.integers(0, 255, (40, 60, 3)).astype(np.uint8)
    bad = rng.integers(0, 255, (40, 13, 3)).astype(np.uint8)
    futs = [svc.submit(good), svc.submit(bad), svc.submit(good)]
    assert futs[0].result(timeout=30).shape == (40, 60)
    with pytest.raises(RuntimeError, match="geometry exploded"):
        futs[1].result(timeout=30)
    assert futs[2].result(timeout=30).shape == (40, 60)
    svc.close()


def test_manifest_validation(artifacts, tmp_path):
    """Loading refuses: a missing manifest, corrupt JSON, a wrong format,
    a newer artifact_version, missing keys, a missing program, a params
    sidecar the manifest asks for, and a JAX artifact by name."""
    d, jd, _ = artifacts
    assert validate_manifest(d)["artifact_version"] == 1

    def copy_with(mutate):
        dst = tmp_path / f"art_{mutate.__name__}"
        shutil.copytree(d, dst)
        mf = json.loads((dst / "manifest.json").read_text())
        mutate(dst, mf)
        return dst

    def no_manifest(dst, mf):
        (dst / "manifest.json").unlink()

    def corrupt(dst, mf):
        (dst / "manifest.json").write_text("{nope")

    def wrong_format(dst, mf):
        mf["format"] = "other.thing"
        (dst / "manifest.json").write_text(json.dumps(mf))

    def future_version(dst, mf):
        mf["artifact_version"] = 99
        (dst / "manifest.json").write_text(json.dumps(mf))

    def drop_key(dst, mf):
        del mf["threshold"]
        (dst / "manifest.json").write_text(json.dumps(mf))

    def no_program(dst, mf):
        (dst / "model.pt2").unlink()

    def sidecar_gone(dst, mf):
        mf["embed_params"] = False
        (dst / "manifest.json").write_text(json.dumps(mf))

    for mutate, msg in ((no_manifest, "manifest.json missing"),
                        (corrupt, "corrupt manifest"),
                        (wrong_format, "unknown artifact format"),
                        (future_version, "newer than this loader"),
                        (drop_key, "missing keys"),
                        (no_program, "model.pt2 missing"),
                        (sidecar_gone, "params.msgpack is missing")):
        with pytest.raises(ValueError, match=msg):
            validate_manifest(copy_with(mutate))
    # JAX's own artifact, and its manifest beside the port's program
    for bad in (jd, copy_with(lambda dst, mf: (dst / "manifest.json")
                              .write_text(json.dumps(
                                  {**mf, "format": "cartseg_tpu.segmenter"}
                              )))):
        with pytest.raises(ValueError, match="JAX serving artifact"):
            validate_manifest(bad)
    with pytest.raises(ValueError, match="JAX serving artifact"):
        load_segmenter(jd)


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/segment",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_http_concurrent_posts_one_device_call(artifacts, rng):
    """Four simultaneous POSTs with batch 4 coalesce into exactly one
    device call (after the warmup)."""
    svc = SegmentationService(artifacts[0], max_latency_ms=500,
                              warmup_iters=1)
    calls = []
    real_predict = svc.model.predict_probs
    svc.model.predict_probs = lambda xs: (calls.append(xs.shape[0]),
                                          real_predict(xs))[1]
    srv = server_mod.make_http_server(svc, 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        img = rng.integers(0, 255, (80, 100, 3)).astype(np.uint8)
        body = image_io.encode_png(img)
        results, errs = [], []

        def post():
            try:
                results.append(_post(port, body))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=post) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs and len(results) == 4
        # all four coalesced into one full device batch
        assert calls == [4], calls
        want = svc.model.segment(img)
        for b in results:
            assert np.array_equal(image_io.decode_png(b), want)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_http_endpoint(artifacts, served, rng):
    import cv2

    svc = SegmentationService(artifacts[0], max_latency_ms=10,
                              warmup_iters=1)
    srv = server_mod.make_http_server(svc, 0)  # a free port
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["batch_size"] == BS
        img = rng.integers(0, 255, (90, 120, 3)).astype(np.uint8)
        mask = image_io.decode_png(_post(port, image_io.encode_png(img)))
        assert np.array_equal(mask, served.segment(img))
        # a JPEG body (cv2 decodes it on the CPU, nvJPEG on a card)
        ok, jpg = cv2.imencode(".jpg", img[:, :, ::-1])
        assert ok
        mask = image_io.decode_png(_post(port, jpg.tobytes()))
        assert mask.shape == (90, 120)
        with pytest.raises(urllib.error.HTTPError, match="400"):
            _post(port, b"not an image")
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_batch_mode_cli(artifacts, served, rng, tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    imgs = {f"f{i}": rng.integers(0, 255, (70, 90, 3)).astype(np.uint8)
            for i in range(3)}
    for k, im in imgs.items():
        image_io.write_png(src / f"{k}.png", im)
    server_mod.main(["--artifact", str(artifacts[0]), "--input_dir",
                     str(src), "--out_dir", str(tmp_path / "out")])
    for k, im in imgs.items():
        got = image_io.read_gray(tmp_path / "out" / f"{k}_mask.png")
        assert np.array_equal(got, served.segment(im))
