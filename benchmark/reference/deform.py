"""Modulated deformable convolution (DCNv2, 3x3, stride/pad/dilation 1)
in plain PyTorch, and the conv_offset channel split.

Layouts (NHWC):
  x:      (B, H, W, C), channel c in deform group c // (C / dg);
  offset: (B, H, W, dg, 9, 2), last dim (dy, dx), tap k = 3*i + j;
  mask:   (B, H, W, dg, 9), already sigmoided;
  weight: (3, 3, C, O) HWIO.
Sampling is bilinear with zeros outside the image (torchvision
deform_conv2d semantics).
"""

from __future__ import annotations

import torch

from .warp import _gather2d


def split_offset_mask_channels(raw, deform_groups: int,
                               max_residue_magnitude: float, flow=None):
    """conv_offset output (B, H, W, 27*dg) -> offset (B, H, W, dg, 9, 2)
    (dy, dx) and mask (B, H, W, dg, 9).

    The first 18*dg channels are offsets (max_residue_magnitude * tanh),
    interleaved (dy, dx) per tap per group; the last 9*dg the modulation
    (sigmoid), [g][k]. The reference's chunk-3/re-cat is an identity on this
    order. flow: optional (B, H, W, 2) (dx, dy) added to every tap as
    (dy, dx), as the reference adds flow.flip(1)."""
    dg = deform_groups
    B, H, W, _ = raw.shape
    offset = max_residue_magnitude * torch.tanh(raw[..., :18 * dg])
    offset = offset.reshape(B, H, W, dg, 9, 2)
    if flow is not None:
        offset = offset + flow.flip(-1)[:, :, :, None, None, :]
    mask = torch.sigmoid(raw[..., 18 * dg:]).reshape(B, H, W, dg, 9)
    return offset, mask


def _tap_coords(offset):
    """Absolute sample coordinates (sy, sx), each (B, H, W, dg, 9), of the
    3x3 taps (k = 3*i + j at (h + i - 1, w + j - 1)) moved by offset."""
    _, H, W = offset.shape[:3]
    dev, dt = offset.device, offset.dtype
    tap = torch.arange(3, dtype=dt, device=dev) - 1.0
    ky = tap.repeat_interleave(3)       # k = 3*i + j -> i - 1
    kx = tap.repeat(3)                  # -> j - 1
    py = torch.arange(H, dtype=dt, device=dev)[:, None, None, None] + ky
    px = torch.arange(W, dtype=dt, device=dev)[None, :, None, None] + kx
    return py + offset[..., 0], px + offset[..., 1]


def _deform_sample_plain(x, sy, sx, mask, dg):
    B, H, W, C = x.shape
    _, Ho, Wo, _, K = sy.shape
    Cg = C // dg
    x_g = x.reshape(B, H, W, dg, Cg).permute(0, 3, 1, 2, 4)
    x_g = x_g.reshape(B * dg, H, W, Cg)
    sy_g = sy.permute(0, 3, 1, 2, 4).reshape(B * dg, Ho, Wo * K)
    sx_g = sx.permute(0, 3, 1, 2, 4).reshape(B * dg, Ho, Wo * K)

    y0 = torch.floor(sy_g)
    x0 = torch.floor(sx_g)
    wy1 = sy_g - y0
    wx1 = sx_g - x0

    def corner(yc, xc, wgt):
        valid = ((xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1))
        g = _gather2d(x_g, yc.long().clamp(0, H - 1),
                      xc.long().clamp(0, W - 1))
        return g * (wgt * valid)[..., None]

    sampled = (corner(y0, x0, (1 - wy1) * (1 - wx1))
               + corner(y0, x0 + 1, (1 - wy1) * wx1)
               + corner(y0 + 1, x0, wy1 * (1 - wx1))
               + corner(y0 + 1, x0 + 1, wy1 * wx1))   # (B*dg, Ho, Wo*K, Cg)
    sampled = sampled.reshape(B, dg, Ho, Wo, K, Cg)
    sampled = sampled * mask.permute(0, 3, 1, 2, 4)[..., None]
    return sampled.permute(0, 2, 3, 1, 4, 5)          # (B, Ho, Wo, dg, K, Cg)


def _contract(sampled, weight, bias):
    """(B, H, W, dg, 9, Cg) samples x the HWIO (3, 3, C, O) weight -> (B,
    H, W, O). The weight's rows are put in the samples' (group, tap,
    channel) order, so the large tensor is not transposed."""
    B, H, W, dg, K, Cg = sampled.shape
    O = weight.shape[-1]
    w = weight.reshape(K, dg, Cg, O).transpose(0, 1).reshape(dg * K * Cg, O)
    out = sampled.reshape(B * H * W, dg * K * Cg) @ w
    if bias is not None:
        out = out + bias
    return out.reshape(B, H, W, O)


def _modulated_deform_conv2d_plain(x, offset, mask, weight, bias):
    sy, sx = _tap_coords(offset)
    return _contract(_deform_sample_plain(x, sy, sx, mask, offset.shape[3]),
                     weight, bias)


def modulated_deform_conv2d_opt2(x, offset, mask, weight, bias=None):
    """DCNv2 3x3: bilinear samples of every tap times the mask, then one
    matrix product with the weight."""
    return _modulated_deform_conv2d_plain(x, offset, mask, weight, bias)
