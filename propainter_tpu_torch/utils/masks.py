"""Mask reading, binarisation, dilation and outpainting preparation
(host-side, numpy).

scipy's binary dilation with its default cross-shaped structuring element,
iterated, as the reference's inference script uses. A copy of
`propainter_tpu/utils/masks.py` (a test pins each function to the
original); reading masks needs `cv2`.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.ndimage


def binary_mask(mask: np.ndarray, th: float = 0.1) -> np.ndarray:
    return (mask > th).astype(np.uint8)


def binary_dilation_cross(mask: np.ndarray, iterations: int) -> np.ndarray:
    """scipy-style binary dilation (connectivity-1 cross), iterated."""
    if iterations <= 0:
        return binary_mask(mask)
    return scipy.ndimage.binary_dilation(
        mask, iterations=iterations).astype(np.uint8)


def _load_mask_image(path: str, size: tuple[int, int] | None) -> np.ndarray:
    """Load a mask image as (H, W) uint8 grayscale, optionally resized
    (nearest) to size=(W, H)."""
    import cv2

    m = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if m is None:
        raise FileNotFoundError(path)
    if size is not None and (m.shape[1], m.shape[0]) != size:
        m = cv2.resize(m, size, interpolation=cv2.INTER_NEAREST)
    return m


def read_masks(
    mpath: str,
    length: int,
    size: tuple[int, int] | None = None,
    flow_mask_dilates: int = 8,
    mask_dilates: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """Read mask(s) and produce (flow_masks, masks_dilated), each (T, H, W)
    uint8 in {0, 1}. Single-image masks broadcast to all frames.
    Reference inference_propainter.py:77-114."""
    if mpath.lower().endswith((".jpg", ".jpeg", ".png")):
        paths = [mpath]
    else:
        paths = [os.path.join(mpath, p) for p in sorted(os.listdir(mpath))]

    flow_masks, masks_dilated = [], []
    for p in paths:
        m = _load_mask_image(p, size)
        if flow_mask_dilates > 0:
            fm = binary_dilation_cross(m, flow_mask_dilates)
        else:
            fm = binary_mask(m)
        flow_masks.append(fm)
        if mask_dilates > 0:
            md = binary_dilation_cross(m, mask_dilates)
        else:
            md = binary_mask(m)
        masks_dilated.append(md)

    if len(paths) == 1:
        flow_masks = flow_masks * length
        masks_dilated = masks_dilated * length
    return np.stack(flow_masks), np.stack(masks_dilated)


def prepare_outpainting(
    frames: np.ndarray, scale: tuple[float, float]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, tuple[int, int]]:
    """Pad frames into a larger canvas and build border masks for
    video outpainting. Reference inference_propainter.py:117-156.

    Args:
      frames: (T, H, W, 3) uint8.
      scale: (scale_h, scale_w).
    Returns:
      (frames_ext (T, H', W', 3), flow_masks (T, H', W'),
       masks_dilated (T, H', W'), (W', H')).
    """
    T, H, W, _ = frames.shape
    H_ext = int(scale[0] * H)
    W_ext = int(scale[1] * W)
    H_ext = H_ext - H_ext % 8
    W_ext = W_ext - W_ext % 8
    h0 = (H_ext - H) // 2
    w0 = (W_ext - W) // 2

    out = np.zeros((T, H_ext, W_ext, 3), np.uint8)
    out[:, h0 : h0 + H, w0 : w0 + W] = frames

    dil_h = 4 if h0 > 10 else 0
    dil_w = 4 if w0 > 10 else 0
    flow_mask = np.ones((H_ext, W_ext), np.uint8)
    flow_mask[h0 + dil_h : h0 + H - dil_h, w0 + dil_w : w0 + W - dil_w] = 0
    mask = flow_mask.copy()
    mask[h0 : h0 + H, w0 : w0 + W] = 0

    return (out, np.repeat(flow_mask[None], T, 0),
            np.repeat(mask[None], T, 0), (W_ext, H_ext))
