"""How far the port's seg_friendly lies from cv2's on the JPEG fixtures.

    python -m cartseg_tpu_torch.tools.seg_friendly_against_cv2 [--threads N]

Needs OpenCV (cv2), which it compares with, and runs the port on the CPU
(whose lanes the card's kernels equal bit for bit). For each 1280x720
fixture frame's stored cv2 decode it prints the values where the port's
bilateral filter (ops/filters.py) and its whole seg_friendly
(tools/annotate.py) differ from cv2.bilateralFilter and from the cv2
chain (make_jpeg_fixtures.cv2_seg_friendly), with the largest |d|.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cartseg_tpu_torch.ops.filters import bilateral_u8
from cartseg_tpu_torch.tools import annotate
from cartseg_tpu_torch.tools.make_jpeg_fixtures import (N_FRAMES, OUT,
                                                        cv2_seg_friendly)
from cartseg_tpu_torch.utils.image_io import decode_png


def _diff(a: np.ndarray, b: np.ndarray) -> str:
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return f"{int((d > 0).sum())} of {d.size} values, max |d| {int(d.max())}"


def main(argv=None) -> None:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=torch.get_num_threads())
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for k in range(N_FRAMES):
        rgb = decode_png((OUT / f"frame_{k}.cv2.png").read_bytes())
        bgr = np.ascontiguousarray(rgb[..., ::-1])
        bil = bilateral_u8(torch.from_numpy(bgr)).numpy()
        ref = cv2.bilateralFilter(bgr, 15, 100, 15)
        chain = annotate.seg_friendly(bgr, "cpu")
        print(f"frame_{k}: bilateral {_diff(bil, ref)}; seg_friendly "
              f"{_diff(chain, cv2_seg_friendly(bgr))}", flush=True)


if __name__ == "__main__":
    main()
