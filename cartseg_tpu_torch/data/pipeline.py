"""Device input pipeline (counterpart of cartseg_tpu/data/pipeline.py): a
thread-prefetched loader one batch ahead of the step.

The host side (decode + letterbox + resize, uint8) runs in a small
thread pool whose threads read the files for the run's device (a JPEG
on a card is decoded by nvJPEG, each thread with its own decode state
and stream); each batch is stacked into pinned memory (on a CUDA
device) and copied with `non_blocking=True` to the explicit device
while the previous step computes. Augmentation and normalisation run on
the device. Under data parallelism (`rows`, parallel/mesh.py
`host_batch_slice`) each rank reads only its contiguous rows of every
global batch; the order stays global (cartseg_tpu/data/pipeline.py:
60-100).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch


class Loader:
    """Iterates (images_u8 [B,H,W,3], masks float32 [B,H,W,1]) on
    `device`. order: an index array (epoch plan) over the dataset; the
    trailing partial batch is dropped when drop_last. rows(n): the slice
    of a global batch of n indices that this rank reads (all of them when
    None)."""

    def __init__(self, dataset, batch_size: int, *, device,
                 drop_last: bool = True, num_threads: int = 4,
                 prefetch: int = 2,
                 rows: Optional[Callable[[int], slice]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = rows
        self.device = torch.device(device)
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch

    def _batches(self, order: Sequence[int]):
        bs = self.batch_size
        n = len(order)
        end = (n // bs) * bs if self.drop_last else n
        for i in range(0, end, bs):
            idxs = list(order[i:i + bs])
            yield idxs if self.rows is None else idxs[self.rows(len(idxs))]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def __call__(self, order: Sequence[int]) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded put that aborts when the consumer has left."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def read(idx):
            return self.dataset.load(idx, self.device)

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in self._batches(order):
                        if stop.is_set():
                            return
                        items = list(pool.map(read, idxs))
                        imgs = np.stack([it[0] for it in items])
                        masks = np.stack([it[1] for it in items])[..., None]
                        put = (self._to_device(imgs),
                               self._to_device(masks).to(torch.float32))
                        if not _put(put):
                            return
            except BaseException as e:  # surfaced to the consumer
                _put(e)
            finally:
                _put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join()

    def steps_per_epoch(self, n: int) -> int:
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)
