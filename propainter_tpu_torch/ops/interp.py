"""Resizing and pooling with torch `F.interpolate` / pooling semantics on
NHWC tensors. Counterpart of `propainter_tpu/ops/interp.py`.

Nearest resize indexes with the source positions computed in float64
(`floor(dst * in / out)`), as the JAX package does, so both pick the same
pixel for any size ratio.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    out = np.arange(out_size, dtype=np.float64)
    idx = np.floor(out * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize(x, size, method: str = "bilinear", align_corners: bool = False):
    """Resize (..., H, W, C) to (..., size[0], size[1], C)."""
    *lead, H, W, C = x.shape
    Ho, Wo = size
    if (Ho, Wo) == (H, W):
        return x
    xb = x.reshape(-1, H, W, C)
    if method == "nearest":
        iy = torch.as_tensor(_nearest_index(H, Ho), device=x.device)
        ix = torch.as_tensor(_nearest_index(W, Wo), device=x.device)
        out = xb.index_select(1, iy).index_select(2, ix)
    elif method == "bilinear":
        out = F.interpolate(xb.permute(0, 3, 1, 2), size=(Ho, Wo),
                            mode="bilinear", align_corners=align_corners)
        out = out.permute(0, 2, 3, 1)
    else:
        raise ValueError(f"unsupported method: {method}")
    return out.reshape(*lead, Ho, Wo, C)


def avg_pool2d(x, window: int = 2, stride: int | None = None):
    """F.avg_pool2d over (H, W) of an NHWC tensor (no padding)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return out.permute(0, 2, 3, 1)


def max_pool2d(x, window, stride=None, padding=(0, 0)):
    """F.max_pool2d over (H, W) of an NHWC tensor (floor mode, -inf pad)."""
    out = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride or window,
                       padding)
    return out.permute(0, 2, 3, 1)
