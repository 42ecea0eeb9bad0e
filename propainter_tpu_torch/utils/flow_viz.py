"""Optical-flow -> RGB visualization (Baker et al. colorwheel): a copy of
`propainter_tpu/utils/flow_viz.py` (jax-free; pinned to the original by
tests/test_torch_eval_metrics.py).

Re-implements the behavior of reference RAFT/utils/flow_viz_pt.py:6 /
RAFT/utils/flow_viz.py (the standard Middlebury flow color coding) in numpy,
for the RAFT demo's PNGs.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """55x3 uint-range colorwheel (Middlebury flow color coding)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3), np.float32)
    col = 0

    def ramp(n, up):
        r = np.floor(np.arange(n, dtype=np.float32) / n * 255.0)
        return r if up else 255.0 - r

    wheel[col : col + RY, 0] = 255.0
    wheel[col : col + RY, 1] = ramp(RY, True)
    col += RY
    wheel[col : col + YG, 0] = ramp(YG, False)
    wheel[col : col + YG, 1] = 255.0
    col += YG
    wheel[col : col + GC, 1] = 255.0
    wheel[col : col + GC, 2] = ramp(GC, True)
    col += GC
    wheel[col : col + CB, 1] = ramp(CB, False)
    wheel[col : col + CB, 2] = 255.0
    col += CB
    wheel[col : col + BM, 2] = 255.0
    wheel[col : col + BM, 0] = ramp(BM, True)
    col += BM
    wheel[col : col + MR, 2] = ramp(MR, False)
    wheel[col : col + MR, 0] = 255.0
    return wheel


_COLORWHEEL = make_colorwheel()


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """Flow (..., H, W, 2) float -> uint8 RGB (..., H, W, 3).

    Normalizes by the max flow magnitude over the whole input (matching
    reference flow_viz_pt.flow_to_image's per-call max_norm).
    """
    flow = np.asarray(flow, np.float32)
    squeeze = flow.ndim == 3
    if squeeze:
        flow = flow[None]
    if flow.shape[-1] != 2:
        raise ValueError(f"expected trailing flow dim 2, got {flow.shape}")

    max_norm = np.sqrt(np.sum(flow ** 2, axis=-1)).max()
    eps = np.finfo(np.float32).eps
    nf = flow / (max_norm + eps)

    u, v = nf[..., 0], nf[..., 1]
    rad = np.sqrt(u * u + v * v)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _COLORWHEEL.shape[0]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int64)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = _COLORWHEEL[k0, c] / 255.0
        col1 = _COLORWHEEL[k1, c] / 255.0
        col = (1.0 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1.0 - rad[idx] * (1.0 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255.0 * col).astype(np.uint8)
    if squeeze:
        img = img[0]
    return img
