"""Micro-batching segmentation server over an exported artifact
(counterpart of cartseg_tpu/serve/server.py).

The device program has one static batch shape. Requests land in a
queue; a collector thread flushes when a full batch has gathered OR
`max_latency_ms` has passed since the batch's first request, pads the
tail, runs the device call and resolves each request's future.
Throughput comes from the batching, tail latency is bounded by the
timer.

Three frontends over one service:
  * Python: `SegmentationService.submit(image) -> Future`;
  * batch mode: `python -m cartseg_tpu_torch.serve.server --artifact D
      --input_dir IN --out_dir OUT` (masks written as PNGs);
  * HTTP (stdlib): `--port 8000` (0 binds a free port); POST /segment
    with a PNG or JPEG body answers the PNG mask at the original
    resolution; GET /healthz answers the manifest.

No OpenCV or PIL on this path: PNG bodies decode with the port's zlib
codec (utils/image_io.py), JPEG bodies on the card with nvJPEG
(utils/jpeg.py; cv2 on the CPU), and the mask is encoded by the port's
own PNG encoder. Frames are RGB throughout (the JAX server flips cv2's
BGR).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Optional

import numpy as np

from cartseg_tpu_torch import geometry
from cartseg_tpu_torch.serve.export import load_segmenter
from cartseg_tpu_torch.utils import image_io


class MicroBatcher:
    """Fixed-batch collector: submit(item) -> Future; `run_fn` receives
    a list of at most batch_size items and returns one result per item.
    A returned item that IS an Exception resolves only that request's
    future with it (one request's error stays its own); an exception
    raised by run_fn fails the whole batch (the device call itself
    died)."""

    def __init__(self, run_fn, batch_size: int, max_latency_ms: float = 20.0):
        self._run = run_fn
        self.batch_size = batch_size
        self.max_latency = max_latency_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        self._q.put((item, fut))
        return fut

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _loop(self):
        while not self._stop.is_set():
            batch = []
            try:
                batch.append(self._q.get(timeout=0.05))
            except queue.Empty:
                continue
            deadline = time.monotonic() + self.max_latency
            while len(batch) < self.batch_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            futs = [b[1] for b in batch]
            try:
                results = self._run([b[0] for b in batch])
                for f, r in zip(futs, results):
                    if isinstance(r, Exception):
                        f.set_exception(r)
                    else:
                        f.set_result(r)
            except Exception as e:  # noqa: BLE001 - to every request
                for f in futs:
                    f.set_exception(e)


class SegmentationService:
    """Letterbox + batched device inference + inverse letterbox, over the
    micro-batcher. Thread-safe; one device program. `device_calls` and
    `requests` count the program's calls and the requests they served."""

    def __init__(self, artifact_dir, max_latency_ms: float = 20.0,
                 warmup_iters: int = 10, device=None):
        self._geo = geometry
        self.model = load_segmenter(artifact_dir, device)
        self.device_calls = self.requests = 0
        self._batcher = MicroBatcher(self._run_batch,
                                     self.model.batch_size, max_latency_ms)
        if warmup_iters:
            self.warmup(warmup_iters)

    def warmup(self, iters: int = 10):
        """Run the device program to steady state before serving (the
        allocator's pools, cuDNN's algorithm choice): the first real
        requests then see the steady-state latency."""
        h, w = self.model.img_hw
        zeros = np.zeros((self.model.batch_size, h, w, 3), np.uint8)
        for _ in range(iters):
            self.model.predict_probs(zeros)

    def _run_batch(self, prepped):
        xs = np.stack([p[0] for p in prepped])
        probs = self.model.predict_probs(xs)
        self.device_calls += 1
        self.requests += len(prepped)
        out = []
        for p, (_, (w, h)) in zip(probs, prepped):
            # a request with bad geometry must not fail its batch-mates
            # (they share the device call only)
            try:
                mask = (p >= self.model.threshold).astype(np.uint8) * 255
                out.append(self._geo.remove_letterbox(mask, orig_w=w,
                                                      orig_h=h))
            except Exception as e:  # noqa: BLE001
                out.append(e)
        return out

    def submit(self, image: np.ndarray) -> Future:
        """HxWx3 uint8 RGB, any resolution -> Future of the HxW uint8
        mask at that resolution."""
        h, w = image.shape[:2]
        x = self._geo.letterbox_resize(image, self.model.img_hw[0])
        return self._batcher.submit((x, (w, h)))

    def segment(self, image: np.ndarray) -> np.ndarray:
        return self.submit(image).result()

    def close(self):
        self._batcher.close()


# ---------------------------------------------------------------- HTTP

def make_http_server(service: SegmentationService, port: int,
                     host: str = "127.0.0.1", decode_threads: int = 4):
    """stdlib http.server endpoint on (host, port); port 0 binds a free
    one (`server_address[1]`). POST /segment: image body (PNG or JPEG)
    -> PNG mask; GET /healthz -> manifest JSON. Bodies are decoded by
    `decode_threads` long-lived threads: each keeps its nvJPEG state and
    buffers on a card (a request's own thread would build them anew,
    allocating device and pinned memory on every request)."""
    import http.server
    from concurrent.futures import ThreadPoolExecutor

    manifest = dict(service.model.manifest)
    device = service.model.device
    decoders = ThreadPoolExecutor(decode_threads,
                                  thread_name_prefix="segment-decode")

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, body: bytes, kind: str):
            self.send_response(200)
            self.send_header("Content-Type", kind)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            self._reply(json.dumps(manifest).encode(), "application/json")

        def do_POST(self):
            if self.path != "/segment":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(n)
            try:
                img = decoders.submit(image_io.decode_rgb, raw,
                                      device).result()
            except (ValueError, RuntimeError) as e:
                self.send_error(400, f"undecodable image ({e})")
                return
            if img is None:
                self.send_error(400, "undecodable image (PNG or JPEG)")
                return
            mask = service.segment(img)
            self._reply(image_io.encode_png(mask), "image/png")

    class Server(http.server.ThreadingHTTPServer):
        daemon_threads = True

        def server_close(self):
            super().server_close()
            decoders.shutdown(wait=True)

    return Server((host, port), Handler)


# ----------------------------------------------------------------- CLI

def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--input_dir", help="batch mode: segment every image")
    ap.add_argument("--out_dir", help="batch mode: where masks go")
    ap.add_argument("--port", type=int, help="HTTP mode (0: a free port)")
    ap.add_argument("--max_latency_ms", type=float, default=20.0)
    ap.add_argument("--device", default=None,
                    help="default: the device the artifact was exported for")
    args = ap.parse_args(argv)

    service = SegmentationService(args.artifact, args.max_latency_ms,
                                  device=args.device)
    if args.input_dir:
        out = Path(args.out_dir or (args.input_dir + "_masks"))
        out.mkdir(parents=True, exist_ok=True)
        paths = sorted(p for p in Path(args.input_dir).rglob("*")
                       if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
        futs = []
        for p in paths:
            img = image_io.read_rgb(p, service.model.device)
            if img is None:
                continue
            futs.append((p, service.submit(img)))
        for p, f in futs:
            image_io.write_png(out / (p.stem + "_mask.png"), f.result())
        print(f"segmented {len(futs)} images -> {out}")
        service.close()
        return
    if args.port is not None:
        srv = make_http_server(service, args.port)
        print(f"serving on 127.0.0.1:{srv.server_address[1]} "
              f"(batch {service.model.batch_size})", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
            service.close()
        return
    ap.error("need --input_dir or --port")


if __name__ == "__main__":
    main()
