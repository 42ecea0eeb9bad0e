"""Overlapping patch extraction/combination with F.unfold/F.fold semantics
on NHWC tensors. Counterpart of `propainter_tpu/ops/patches.py` (its TPU
lowerings — fold as matmuls or as a transposed conv — are not ported; these
compute the same values).

The unfolded channel order is torch's: c * (kh * kw) + i * kw + j.
"""

from __future__ import annotations

import torch.nn.functional as F


def unfold_output_size(size: int, kernel: int, stride: int,
                       padding: int) -> int:
    return (size + 2 * padding - (kernel - 1) - 1) // stride + 1


def unfold(x, kernel_size, stride, padding):
    """(B, H, W, C) -> (B, L, C*kh*kw)."""
    out = F.unfold(x.permute(0, 3, 1, 2), kernel_size, padding=padding,
                   stride=stride)
    return out.transpose(1, 2)


def fold(y, output_size, kernel_size, stride, padding):
    """(B, L, C*kh*kw) -> (B, H, W, C), overlapping taps summed."""
    out = F.fold(y.transpose(1, 2), output_size, kernel_size,
                 padding=padding, stride=stride)
    return out.permute(0, 2, 3, 1)


def overlap_renorm(y, output_size, kernel_size, stride, padding):
    """unfold(fold(y) / fold(ones)): each tap becomes the mean of the taps
    that cover its pixel (the FusionFeedForward renormalisation)."""
    summed = F.fold(y.transpose(1, 2), output_size, kernel_size,
                    padding=padding, stride=stride)
    ones = y.new_ones(1, y.shape[2], y.shape[1])
    cover = F.fold(ones, output_size, kernel_size, padding=padding,
                   stride=stride)
    out = F.unfold(summed / cover, kernel_size, padding=padding,
                   stride=stride)
    return out.transpose(1, 2)
