"""RAFT all-pairs correlation in plain PyTorch: the pyramid (fmap1·fmap2ᵀ/√D,
then 2x2 average pools) and the radius-r window lookup fused with the
motion encoder's convc1.

Pyramid levels are stored per query row: level l is (B*H*W, H/2^l, W/2^l)
fp32, row n = b*H*W + p holding query p's correlation with every key pixel.
Window channel order (kept for convc1's weight rows): channel
l*81 + i*9 + j samples at (x + i - r, y + j - r), the x offset major.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """All-pairs correlation pyramid of NHWC feature maps (B, H, W, D):
    [level0, level1, ...], level0 = fmap1·fmap2ᵀ/√D in fp32."""
    B, H, W, D = fmap1.shape
    f1 = fmap1.reshape(B, H * W, D).float() * (1.0 / math.sqrt(D))
    f2 = fmap2.reshape(B, H * W, D).float()
    levels = [torch.bmm(f1, f2.transpose(1, 2)).view(B * H * W, H, W)]
    for _ in range(num_levels - 1):
        levels.append(F.avg_pool2d(levels[-1][:, None], 2, 2)[:, 0])
    return levels


def _corr_lookup_plain(pyramid, coords, radius: int = 4):
    """The lookup's (B, H, W, levels*(2r+1)^2) values: at each level the
    (2r+1)^2 window around coords / 2^level, bilinear (rows, then
    columns), zeros outside the map."""
    B, H, W, _ = coords.shape
    N = B * H * W
    r = radius
    n = 2 * r + 1
    cx = coords[..., 0].reshape(N).float()
    cy = coords[..., 1].reshape(N).float()
    s = torch.arange(n + 1, device=coords.device) - r   # integer taps
    outs = []
    for lvl, corr in enumerate(pyramid):
        Hl, Wl = corr.shape[1:]
        x = cx / (2.0 ** lvl)
        y = cy / (2.0 ** lvl)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[:, None, None]
        fy = (y - y0)[:, None, None].to(corr.dtype)
        # windows wholly outside the map stay wholly outside after the
        # clamp, which keeps the integer indices small
        xs = x0.clamp(-(r + 2), Wl + r).long()[:, None] + s   # (N, n+1)
        ys = y0.clamp(-(r + 2), Hl + r).long()[:, None] + s
        valid = (((ys >= 0) & (ys < Hl))[:, :, None]
                 & ((xs >= 0) & (xs < Wl))[:, None, :])
        idx = (ys.clamp(0, Hl - 1)[:, :, None] * Wl
               + xs.clamp(0, Wl - 1)[:, None, :])
        g = torch.gather(corr.reshape(N, Hl * Wl), 1, idx.reshape(N, -1))
        g = g.reshape(N, n + 1, n + 1) * valid             # [y, x]
        gy = (g[:, :-1] * (1.0 - fy) + g[:, 1:] * fy).float()  # (N, n_y, n+1)
        v = gy[:, :, :-1] * (1.0 - fx) + gy[:, :, 1:] * fx   # (N, n_y, n_x)
        outs.append(v.transpose(1, 2).reshape(N, n * n))     # x-major
    return torch.cat(outs, dim=-1).reshape(B, H, W, -1)


def _corr_lookup_moenc_plain(pyramid, coords, weight, bias, radius):
    corr = _corr_lookup_plain(pyramid, coords, radius)
    B, H, W, C = corr.shape
    out = torch.addmm(bias, corr.reshape(-1, C), weight)
    return torch.relu(out).reshape(B, H, W, -1)


def corr_lookup_moenc(pyramid, coords, weight, bias, radius: int = 4):
    """relu(lookup(pyramid, coords) @ weight + bias): the bilinear
    (2r+1)^2 window lookup at each level (zeros outside), then convc1 (1x1,
    324 -> 256) and relu. weight (324, F); returns (B, H, W, F)."""
    return _corr_lookup_moenc_plain(pyramid, coords, weight, bias, radius)
