"""Where the port runs: `cuda` unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU; without one this raises instead of falling
    back to the CPU. Pass `"cpu"` to run the plain PyTorch versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is unavailable")
    return dev


@contextlib.contextmanager
def fp32_numerics():
    """Full fp32 for convolutions and matmuls on the GPU (cuDNN defaults to
    TF32 for fp32 convolutions); the previous settings are restored. Every
    entry point that runs a model in fp32 enters it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
