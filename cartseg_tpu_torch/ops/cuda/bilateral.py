"""cv2.bilateralFilter of an 8-bit three-channel image: the CUDA
kernel's wrapper.

Counterpart of no TPU kernel: the JAX package calls cv2 on the host
(cartseg_tpu/tools/annotate.py:49). The plain version is ops/filters.py
`bilateral_u8_plain`, and `bilateral_u8` there takes it for a CPU
tensor; this wrapper takes a CUDA tensor and launches csrc/bilateral.cu
or raises. The two are bit-equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cartseg_tpu_torch.ops.cuda import build as B


@functools.lru_cache(maxsize=8)
def _device_tables(device: torch.device, colour: bytes, offsets: bytes,
                   space: bytes):
    """The tables on `device`, copied once per device and parameters."""
    def put(buf, dtype):
        return torch.from_numpy(np.frombuffer(buf, dtype).copy()).to(device)

    return put(colour, np.float32), put(offsets, np.int32), put(space,
                                                                np.float32)


def bilateral_u8_cuda(image: torch.Tensor, colour: np.ndarray,
                      offsets: np.ndarray, space: np.ndarray) -> torch.Tensor:
    """[H, W, 3] uint8 on a card -> the same, filtered with the tables of
    ops/filters.py `bilateral_tables`: one launch."""
    if not image.is_cuda:
        raise ValueError(f"bilateral_u8_cuda: tensor on {image.device}")
    if image.dtype != torch.uint8 or image.dim() != 3 or image.shape[2] != 3:
        raise ValueError("bilateral_u8_cuda takes a uint8 [H, W, 3] tensor, "
                         f"got {image.dtype} {tuple(image.shape)}")
    if colour.shape != (768,) or offsets.ndim != 2 or \
            len(offsets) != len(space):
        raise ValueError("bilateral_u8_cuda: malformed tables")
    image = image.contiguous()
    h, w = image.shape[:2]
    out = torch.empty_like(image)
    if image.numel() == 0:
        return out
    c, o, s = _device_tables(image.device, colour.tobytes(),
                             offsets.tobytes(), space.tobytes())
    lib = B.load_library()
    with torch.cuda.device(image.device):
        rc = lib.cartseg_bilateral_u8(image.data_ptr(), out.data_ptr(), h, w,
                                      c.data_ptr(), o.data_ptr(),
                                      s.data_ptr(), len(space),
                                      int(np.abs(offsets).max()),
                                      B.stream_of(image))
    B.check(rc, "bilateral_u8")
    B.LAUNCHES["bilateral"] += 1
    return out
