"""Bilinear/nearest sampling and flow warping (NHWC public layout), fp32.

Bilinear warps go through `F.grid_sample` (align_corners=True, zeros
padding: the reference's `flow_warp`). Nearest samples take
`floor(x + 0.5)`, where `F.grid_sample(mode="nearest")` rounds half to
even and would pick the other pixel on a .5 tie.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord, size: int, align_corners: bool):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _gather2d(img, yi, xi):
    """img[b, yi[b, ...], xi[b, ...], :] for img (B, H, W, C)."""
    B, H, W, C = img.shape
    idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, C)
    out = torch.gather(img.reshape(B, H * W, C), 1, idx)
    return out.reshape(*yi.shape, C)


def _flow_grid(flow):
    """Normalized sampling grid for a (B, H, W, 2) (dx, dy) pixel flow, with
    the reference's max(size - 1, 1) guard."""
    B, H, W, _ = flow.shape
    gx = torch.arange(W, dtype=flow.dtype, device=flow.device)
    gy = torch.arange(H, dtype=flow.dtype, device=flow.device)
    nx = 2.0 * (gx[None, None, :] + flow[..., 0]) / max(W - 1, 1) - 1.0
    ny = 2.0 * (gy[None, :, None] + flow[..., 1]) / max(H - 1, 1) - 1.0
    return torch.stack([nx, ny], dim=-1)


def flow_warp_nchw(x, flow):
    """Bilinear backward warp of x (B, C, H, W) by flow (B, H, W, 2)."""
    return F.grid_sample(x, _flow_grid(flow), mode="bilinear",
                         padding_mode="zeros", align_corners=True)


def flow_warp_bilinear_nearest(xb, xn, flow):
    """Warp xb bilinearly and xn nearest by the same flow from one set of
    four corners (zeros padding, align_corners=True). The nearest sample
    `floor(x + 0.5)` is always one of the bilinear corners; the select uses
    that exact rounding."""
    B, H, W, Cb = xb.shape
    img = torch.cat([xb, xn], dim=-1)
    grid = _flow_grid(flow)
    x = _unnormalize(grid[..., 0], W, True)
    y = _unnormalize(grid[..., 1], H, True)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    sel_x = (torch.floor(x + 0.5) > x0)[..., None]
    sel_y = (torch.floor(y + 0.5) > y0)[..., None]

    def corner(yc, xc):
        valid = ((xc >= 0) & (xc <= W - 1) & (yc >= 0)
                 & (yc <= H - 1)).to(img.dtype)[..., None]
        g = _gather2d(img, yc.long().clamp(0, H - 1),
                      xc.long().clamp(0, W - 1))
        return g, valid

    g00, v00 = corner(y0, x0)
    g01, v01 = corner(y0, x0 + 1.0)
    g10, v10 = corner(y0 + 1.0, x0)
    g11, v11 = corner(y0 + 1.0, x0 + 1.0)
    wx0, wy0 = 1.0 - fx, 1.0 - fy
    out_b = (g00[..., :Cb] * (wy0 * wx0 * v00)
             + g01[..., :Cb] * (wy0 * fx * v01)
             + g10[..., :Cb] * (fy * wx0 * v10)
             + g11[..., :Cb] * (fy * fx * v11))
    n0 = torch.where(sel_x, g01[..., Cb:] * v01, g00[..., Cb:] * v00)
    n1 = torch.where(sel_x, g11[..., Cb:] * v11, g10[..., Cb:] * v10)
    return out_b, torch.where(sel_y, n1, n0)


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32):
    """(B, H, W, 2) pixel-coordinate grid, last dim (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                            torch.arange(wd, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(batch, -1, -1, -1)


def length_sq(x):
    return torch.sum(x * x, dim=-1, keepdim=True)


def fb_consistency_from_warped(flow_fw, flow_bw_warped, alpha1: float = 0.01,
                               alpha2: float = 0.5):
    """(B, H, W, 1) mask, 1 where the forward flow and the backward flow
    bilinearly warped by it agree."""
    mag_sq = length_sq(flow_fw) + length_sq(flow_bw_warped)
    thresh = alpha1 * mag_sq + alpha2
    return (length_sq(flow_fw + flow_bw_warped) < thresh).to(flow_fw.dtype)
