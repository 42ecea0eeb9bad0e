"""Canny edges of a single-channel image (NHWC public layout), the
training targets of the flow completion's edge head. Counterpart of
`propainter_tpu/ops/canny.py`: the same separable 5x5 Gaussian blur
(reflect padding), un-normalised Sobel gradients (replicate padding),
directional non-maximum suppression over 8 kernels (zero padding), double
threshold and conv-based hysteresis repeated until nothing changes. Plain
PyTorch on either device: the JAX function has no kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _conv_same(x, kernel: np.ndarray, pad_mode: str):
    """Correlate x (B, H, W, 1) with a (kh, kw) or (K, kh, kw) kernel
    stack -> (B, H, W, K)."""
    k = np.asarray(kernel, np.float32)
    if k.ndim == 2:
        k = k[None]
    K, kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    xc = x.permute(0, 3, 1, 2)
    if pad_mode == "zeros":
        pad = (ph, pw)
    else:
        xc = F.pad(xc, (pw, pw, ph, ph), mode=pad_mode)
        pad = 0
    w = torch.as_tensor(k[:, None], dtype=x.dtype, device=x.device)
    return F.conv2d(xc, w, padding=pad).permute(0, 2, 3, 1)


_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = _SOBEL_X.T

# index d compares the centre against the neighbour at d * 45 degrees
_DIRS = [(1, 2), (2, 2), (2, 1), (2, 0), (1, 0), (0, 0), (0, 1), (0, 2)]
_NMS = np.zeros((8, 3, 3), np.float32)
_NMS[:, 1, 1] = 1.0
_HYST = np.zeros((8, 3, 3), np.float32)
for _d, (_r, _c) in enumerate(_DIRS):
    _NMS[_d, _r, _c] = -1.0
    _HYST[_d, _r, _c] = 1.0


def _nms(x, eps: float, sigma: float):
    """The blurred image's gradient magnitude (B, H, W) and its margin over
    the larger of its two neighbours along the gradient's direction (> 0
    at a local maximum)."""
    gk = _gaussian_kernel1d(5, sigma)
    blurred = _conv_same(x, gk[None, :], "reflect")
    blurred = _conv_same(blurred, gk[:, None], "reflect")

    gx = _conv_same(blurred, _SOBEL_X, "replicate")[..., 0]
    gy = _conv_same(blurred, _SOBEL_Y, "replicate")[..., 0]

    magnitude = torch.sqrt(gx * gx + gy * gy + eps)
    angle = torch.atan2(gy, gx) * (180.0 / math.pi)
    angle = torch.round(angle / 45.0) * 45.0

    nms = _conv_same(magnitude[..., None], _NMS, "zeros")     # (B, H, W, 8)
    pos_idx = torch.remainder(angle / 45.0, 8).long()
    neg_idx = torch.remainder(angle / 45.0 + 4, 8).long()
    sel_pos = torch.gather(nms, -1, pos_idx[..., None])[..., 0]
    sel_neg = torch.gather(nms, -1, neg_idx[..., None])[..., 0]
    return magnitude, torch.minimum(sel_pos, sel_neg)


@torch.no_grad()
def canny_edges(x, low_threshold: float = 0.1, high_threshold: float = 0.2,
                hysteresis: bool = True, eps: float = 1e-6,
                sigma: float = 1.0):
    """x (B, H, W, 1) grayscale in [0, 1] -> (B, H, W, 1) edges in {0, 1}
    ({0, 0.5, 1} without hysteresis). sigma: the blur's std (the flow
    trainer's is 2)."""
    magnitude, margin = _nms(x, eps, sigma)
    magnitude = magnitude * (margin > 0.0)

    edges = ((magnitude > low_threshold) * 0.5
             + (magnitude > high_threshold) * 0.5).to(x.dtype)
    if not hysteresis:
        return edges[..., None]

    while True:
        weak = (edges == 0.5).to(x.dtype)
        strong = (edges == 1.0).to(x.dtype)
        hyst = _conv_same(edges[..., None], _HYST, "zeros")
        connected = (hyst == 1.0).any(dim=-1).to(x.dtype)
        mag = connected * weak + strong
        new_edges = mag + (mag == 0) * weak * 0.5
        if torch.equal(new_edges, edges):
            break
        edges = new_edges
    # the converged map without its weak-only residue
    return torch.where(edges == 0.5, 0.0, edges)[..., None]
