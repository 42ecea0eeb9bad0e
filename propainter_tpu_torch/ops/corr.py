"""RAFT all-pairs correlation: pyramid build (kernel K2), the radius-r
window lookup (kernel K7) and the same lookup fused with the motion
encoder's convc1 (kernel K1).

Counterpart of `propainter_tpu/ops/corr.py` + `ops/corr_pallas.py`.
Pyramid levels are stored per query row: level l is (B*H*W, H/2^l, W/2^l)
fp32, row n = b*H*W + p holding query p's correlation with every key pixel
(the JAX CPU layout without its trailing unit dim).

Window channel order (kept for convc1's weight rows): the reference adds a
(dy, dx)-ordered delta to (x, y) coords, so channel l*81 + i*9 + j samples
at (x + i - r, y + j - r) — the x offset is the major index.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from propainter_tpu_torch import _build


def corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """All-pairs correlation pyramid of NHWC feature maps (B, H, W, D).

    The level-0 volume fmap1·fmap2ᵀ/√D is one batched GEMM (`torch.bmm`);
    the 1/√D scale is applied to fmap1 first, which is exact for D = 256
    (a power of two). Levels 1.. come from `corr_pyramid_build` (K2)."""
    B, H, W, D = fmap1.shape
    f1 = fmap1.reshape(B, H * W, D).float() * (1.0 / math.sqrt(D))
    f2 = fmap2.reshape(B, H * W, D).float()
    level0 = torch.bmm(f1, f2.transpose(1, 2)).view(B * H * W, H, W)
    return corr_pyramid_build(level0, num_levels)


def _corr_pyramid_build_plain(level0, num_levels: int):
    levels = [level0]
    for _ in range(num_levels - 1):
        levels.append(F.avg_pool2d(levels[-1][:, None], 2, 2)[:, 0])
    return levels


def corr_pyramid_build(level0, num_levels: int = 4):
    """Levels 1..num_levels-1 by repeated 2x2 average pooling (floor sizes,
    as F.avg_pool2d) of a (N, H, W) fp32 level-0 volume. Returns
    [level0, level1, ...].

    Kernel K2 (`csrc/corr_pyramid_build.cu`) replaces the TPU pyramid build,
    `propainter_tpu/ops/corr_pallas.py:_flatten_copy_kernel` with the pools
    around it (`corr_pyramid_t`). One block per query row reads its level-0
    map once and writes levels 1-3 from shared memory: bound by bytes
    (reading level 0, about 250 MB per RAFT chunk at 432x240)."""
    if level0.device.type == "cpu":
        return _corr_pyramid_build_plain(level0, num_levels)
    _build.require_cuda(level0)
    if num_levels != 4:
        raise ValueError("the K2 kernel builds exactly 4 levels")
    if level0.dtype != torch.float32 or not level0.is_contiguous():
        raise ValueError("level0 must be contiguous float32")
    N, H, W = level0.shape
    sizes = [(H, W)]
    for _ in range(3):
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    if min(min(s) for s in sizes) < 1:
        raise ValueError(f"volume {H}x{W} too small for 4 levels")
    outs = [torch.empty((N, h, w), dtype=torch.float32, device=level0.device)
            for h, w in sizes[1:]]
    fn = _build.function("corr_pyramid_build", "corr_pyramid_build", 4, 3)
    _build.launch(fn, "corr_pyramid_build", level0, level0.data_ptr(),
                  *[o.data_ptr() for o in outs], N, H, W)
    corr_pyramid_build.launches += 1
    return [level0] + outs


corr_pyramid_build.launches = 0


def _corr_lookup_plain(pyramid, coords, radius: int = 4):
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
        fy = (y - y0)[:, None, None]
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
        gy = g[:, :-1] * (1.0 - fy) + g[:, 1:] * fy          # (N, n_y, n+1)
        v = gy[:, :, :-1] * (1.0 - fx) + gy[:, :, 1:] * fx   # (N, n_y, n_x)
        outs.append(v.transpose(1, 2).reshape(N, n * n))     # x-major
    return torch.cat(outs, dim=-1).reshape(B, H, W, -1)


def corr_lookup(pyramid, coords, radius: int = 4):
    """Bilinear (2r+1)^2 window lookup at each level, zeros outside.

    pyramid: levels (B*H*W, Hl, Wl); coords (B, H, W, 2) pixel (x, y).
    Returns (B, H, W, levels*(2r+1)^2) fp32, x-major window channels.

    Kernel K7 (`csrc/corr_lookup.cu`) replaces
    `propainter_tpu/ops/corr_pallas.py:_lookup_kernel` as
    `corr_lookup_fused` calls it without the convc1 epilogue (the JAX
    RAFT's `corr_layout="batched"`). One warp per query gathers each
    level's 10 x 10 integer window once and lerps it (rows, then columns,
    as here, with no FMA contraction) into the level's 81 values, which
    leave as contiguous 128-bit stores. Bound: bytes (the 324 outputs of
    each query, 50 MB per RAFT iteration at 432x240, and the in-range
    taps it reads)."""
    if coords.device.type == "cpu":
        return _corr_lookup_plain(pyramid, coords, radius)
    _build.require_cuda(coords, *pyramid)
    B, H, W, _ = coords.shape
    N = B * H * W
    if radius != 4 or len(pyramid) != 4:
        raise ValueError("K7 takes radius 4 and 4 levels")
    tensors = (*pyramid, coords)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("K7 inputs must be contiguous float32")
    if any(p.shape[0] != N for p in pyramid):
        raise ValueError("pyramid rows must equal the number of queries")
    out = torch.empty((B, H, W, 324), dtype=torch.float32,
                      device=coords.device)
    dims = [d for p in pyramid for d in p.shape[1:]]
    fn = _build.function("corr_lookup", "corr_lookup", 6, 9)
    _build.launch(fn, "corr_lookup", coords,
                  *[t.data_ptr() for t in tensors], out.data_ptr(), N, *dims)
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0


def _corr_lookup_moenc_plain(pyramid, coords, weight, bias, radius):
    corr = _corr_lookup_plain(pyramid, coords, radius)
    B, H, W, C = corr.shape
    out = torch.addmm(bias, corr.reshape(-1, C), weight)
    return torch.relu(out).reshape(B, H, W, -1)


def corr_lookup_moenc(pyramid, coords, weight, bias, radius: int = 4):
    """relu(corr_lookup(pyramid, coords) @ weight + bias): the RAFT lookup
    with the motion encoder's convc1 (1x1 conv, 324 -> 256) fused.

    weight: (levels*(2r+1)^2, F) = convc1's kernel as rows; bias: (F,).
    Returns (B, H, W, F) fp32.

    Kernel K1 (`csrc/corr_lookup_moenc.cu`) replaces
    `propainter_tpu/ops/corr_pallas.py:_lookup_kernel` (moenc epilogue): a
    GEMM of N queries x 256 outputs x 324 window values on the tensor cores
    in 3xTF32, whose A rows are built in shared memory and never reach
    device memory. Persistent blocks walk 32-query tiles; one warp per
    (query, level) reads the 10 x 10 integer window once and lerps it
    (rows, then columns, as here) into the level's 81 values, the next
    level's loads in flight under the current level's products; the
    weight streams through a `cp.async` ring. Bound by operations: 3 x
    2*324*256 TF32 FLOPs per query (19.4 GFLOP per RAFT iteration at
    432x240). Unlike the TPU epilogue it does not round its operands to
    bf16."""
    if coords.device.type == "cpu":
        return _corr_lookup_moenc_plain(pyramid, coords, weight, bias, radius)
    _build.require_cuda(coords, weight, bias, *pyramid)
    B, H, W, _ = coords.shape
    N = B * H * W
    C, Fo = weight.shape
    if radius != 4 or len(pyramid) != 4 or C != 324 or Fo != 256:
        raise ValueError("K1 takes radius 4, 4 levels, a (324, 256) weight")
    tensors = (*pyramid, coords, weight, bias)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors) or weight.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("K1 inputs must be contiguous float32, the weight "
                         "and bias 16-byte aligned")
    if any(p.shape[0] != N for p in pyramid):
        raise ValueError("pyramid rows must equal the number of queries")
    out = torch.empty((B, H, W, Fo), dtype=torch.float32, device=coords.device)
    dims = [d for p in pyramid for d in p.shape[1:]]
    fn = _build.function("corr_lookup_moenc", "corr_lookup_moenc", 8, 9)
    _build.launch(fn, "corr_lookup_moenc", coords,
                  *[t.data_ptr() for t in tensors], out.data_ptr(), N, *dims)
    corr_lookup_moenc.launches += 1
    return out


corr_lookup_moenc.launches = 0
