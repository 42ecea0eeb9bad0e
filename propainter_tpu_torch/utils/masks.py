"""Mask binarisation and dilation (host-side, numpy).

scipy's binary dilation with its default cross-shaped structuring element,
iterated, as the reference's inference script uses.
"""

from __future__ import annotations

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
