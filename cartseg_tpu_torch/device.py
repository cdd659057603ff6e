"""Device plumbing: an explicit device everywhere, and no silent CPU.

The main path (the workload and `chip_smoke.py`) asks for
`device="cuda"`; `require_cuda()` raises when no card is visible
instead of quietly running on the CPU. The CPU is taken only when a
caller asks for it by name (the tests do).
"""

from __future__ import annotations

import contextlib

import torch


def require_cuda() -> torch.device:
    """Return the CUDA device, or raise when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cartseg_tpu_torch: a CUDA device was asked for but "
            "torch.cuda.is_available() is False (CPU-only PyTorch build "
            "or no visible GPU); pass device='cpu' explicitly to run the "
            "plain PyTorch versions")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """'cuda' / 'cuda:N' -> checked CUDA device; 'cpu' -> CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def set_fp32_policy() -> None:
    """Keep float32 math in full float32 on the card, for the rest of the
    process: cuDNN convolutions would otherwise take TF32 by default, and
    the Canny front end (the fp32 Sobel convolution and the gray matmul)
    compares gradient magnitudes against thresholds, where TF32's 10-bit
    mantissa flips pixels. The model itself runs in bf16, where TF32 does
    not apply. The inference programs take `fp32_policy()` around each
    call instead, which gives the flags back."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def fp32_policy():
    """`set_fp32_policy` for the block's length: the TF32 flags are the
    caller's again after it, whatever they were."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    set_fp32_policy()
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
