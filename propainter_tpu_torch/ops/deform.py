"""Modulated deformable convolution (DCNv2, 3x3, stride/pad/dilation 1),
its sampling step alone, its two differentiable dispatchers, and the
conv_offset channel split. Counterpart of `propainter_tpu/ops/deform.py` +
`ops/deform_pallas.py`.

Layouts (the JAX package's, NHWC):
  x:      (B, H, W, C), channel c in deform group c // (C / dg);
  offset: (B, H, W, dg, 9, 2), last dim (dy, dx), tap k = 3*i + j;
  mask:   (B, H, W, dg, 9), already sigmoided;
  weight: (3, 3, C, O) HWIO.
Sampling is bilinear with zeros outside the image (torchvision
deform_conv2d semantics).
"""

from __future__ import annotations

import torch

from propainter_tpu_torch import _build
from propainter_tpu_torch.ops.warp import _gather2d


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


K3_POSITIONS = 64        # output positions per K3 block
K3_CHUNK = 32            # channels per K3 K-chunk
K3_MAX_SPLIT = 8         # blocks per K3 cluster (the portable limit)
GROUP_WIDTHS = (4, 8, 16, 32)    # Cg = C / dg that K3 and K6 take
_INT32 = 2 ** 31


def k3_split(n_pos: int, C: int, slots: int) -> int:
    """Blocks per cluster over which K3 splits each 64-position tile's
    9 * C / 32 channel chunks: the most (up to 8) that divide the chunks
    evenly and keep the whole grid resident at once in `slots` (SMs x
    resident blocks per SM); 1 when the tiles alone fill them. A cluster
    waits for its slowest block, and blocks past the resident slots run in
    a second round."""
    tiles = -(-n_pos // K3_POSITIONS)
    chunks = 9 * C // K3_CHUNK
    return max((s for s in range(1, K3_MAX_SPLIT + 1)
                if chunks % s == 0 and tiles * s <= slots), default=1)


def k3_launch_info(cg: int, device=None) -> tuple:
    """K3's launch facts for group width cg on a CUDA device: (resident
    blocks per SM, dynamic shared memory bytes, threads per block,
    positions per block, most blocks per cluster)."""
    import ctypes

    with torch.cuda.device(device):
        info = (ctypes.c_int * 5)()
        fn = _build.function("deform_conv",
                             "modulated_deform_conv2d_launch_info", 1, 1)
        _build.check(fn(ctypes.addressof(info), cg, None),
                     "modulated_deform_conv2d_launch_info")
    return tuple(info)


_k3_slots: dict = {}


def _resident_k3_blocks(device, cg: int) -> int:
    key = (device.index, cg)
    if key not in _k3_slots:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        _k3_slots[key] = n_sm * k3_launch_info(cg, device)[0]
    return _k3_slots[key]


def _check_kernel_inputs(what, tensors):
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.data_ptr() % 16 or t.numel() >= _INT32 for t in tensors):
        raise ValueError(f"{what} inputs must be contiguous float32, "
                         f"16-byte aligned, with fewer than 2^31 elements")


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, split=None):
    """DCNv2 3x3 with stride, padding and dilation 1 -> (B, H, W, O).

    Kernel K3 (`csrc/deform_conv.cu`) replaces
    `propainter_tpu/ops/deform_pallas.py:_kernel_out`: a (B*H*W) x 128 x
    (9*C) GEMM on the tensor cores in 3xTF32 whose A operand, the modulated
    bilinear samples, is built in shared memory 32 channels of one tap at
    a time and never reaches device memory; the weight streams through a
    cp.async ring. Each 64-position tile's chunks are split over a cluster
    of `split` blocks (default: `k3_split` for this card's resident blocks)
    whose partial sums meet in distributed shared memory; the bias is added
    there. Takes C % 32 == 0, C / dg in GROUP_WIDTHS and O = 128. Bound:
    operations (3 x 2 * 9 * C * 128 FLOPs per position on the tensor cores
    in TF32)."""
    if x.device.type == "cpu":
        return _modulated_deform_conv2d_plain(x, offset, mask, weight, bias)
    _build.require_cuda(x, offset, mask, weight, bias)
    B, H, W, C = x.shape
    dg = offset.shape[3]
    O = weight.shape[-1]
    if weight.shape != (3, 3, C, O) or O != 128:
        raise ValueError(f"K3 takes a (3, 3, C, 128) weight, got "
                         f"{tuple(weight.shape)}")
    if C % K3_CHUNK or C % dg or C // dg not in GROUP_WIDTHS:
        raise ValueError(f"K3 needs C % {K3_CHUNK} == 0 and C / dg in "
                         f"{GROUP_WIDTHS} (C={C}, dg={dg})")
    if offset.shape != (B, H, W, dg, 9, 2) or mask.shape != (B, H, W, dg, 9):
        raise ValueError("offset/mask shapes do not match x")
    if split is None:
        split = k3_split(B * H * W, C,
                         _resident_k3_blocks(x.device, C // dg))
    if not 1 <= split <= min(K3_MAX_SPLIT, 9 * C // K3_CHUNK):
        raise ValueError(f"K3 takes 1 to {K3_MAX_SPLIT} blocks per cluster "
                         f"and at most one per chunk, got {split}")
    if bias is None:
        bias = torch.zeros(O, dtype=x.dtype, device=x.device)
    tensors = (x, offset, mask, weight, bias)
    _check_kernel_inputs("K3", tensors)
    out = torch.empty((B, H, W, O), dtype=torch.float32, device=x.device)
    fn = _build.function("deform_conv", "modulated_deform_conv2d", 6, 6)
    _build.launch(fn, "modulated_deform_conv2d", x,
                  *[t.data_ptr() for t in tensors], out.data_ptr(), B, H, W,
                  C, dg, split)
    modulated_deform_conv2d.launches += 1
    return out


modulated_deform_conv2d.launches = 0


def deform_sample(x, sy, sx, mask, dg: int):
    """Bilinear samples of x (B, H, W, C) at the absolute coordinates sy, sx
    (B, Ho, Wo, dg, K) of each group's taps, zero outside the image, times
    mask (B, Ho, Wo, dg, K) -> (B, Ho, Wo, dg, K, C / dg), x's dtype.

    Kernel K6 (`deform_sample` in `csrc/deform_conv.cu`) replaces
    `propainter_tpu/ops/deform_pallas.py:_kernel`: one thread per
    (position, group, tap, 4-channel quad), each reading its four corners
    and writing its quad as 128-bit accesses, so the output is written
    coalesced; it shares K3's corner code. Takes C / dg in GROUP_WIDTHS.
    Bound: bytes (the output is K times the size of x). The TPU kernel's
    position-block choice (`_pick_pos_block`, `DEFORM_PB`) has no
    counterpart."""
    if x.device.type == "cpu":
        return _deform_sample_plain(x, sy, sx, mask, dg)
    _build.require_cuda(x, sy, sx, mask)
    B, H, W, C = x.shape
    if sy.ndim != 5 or sy.shape[0] != B or sy.shape[3] != dg or C % dg:
        raise ValueError(f"K6 takes sy (B, Ho, Wo, dg, K) with dg dividing "
                         f"C, got {tuple(sy.shape)} for x {tuple(x.shape)}")
    if C // dg not in GROUP_WIDTHS:
        raise ValueError(f"K6 takes C / dg in {GROUP_WIDTHS}, got "
                         f"{C // dg}")
    _, Ho, Wo, _, K = sy.shape
    if sx.shape != sy.shape or mask.shape != sy.shape:
        raise ValueError("sy, sx and mask shapes differ")
    if sy.numel() * C // dg >= _INT32:
        raise ValueError("K6 output has 2^31 elements or more")
    tensors = (x, sy, sx, mask)
    _check_kernel_inputs("K6", tensors)
    out = torch.empty((B, Ho, Wo, dg, K, C // dg), dtype=torch.float32,
                      device=x.device)
    fn = _build.function("deform_conv", "deform_sample", 5, 8)
    _build.launch(fn, "deform_sample", x, *[t.data_ptr() for t in tensors],
                  out.data_ptr(), B, H, W, C, Ho, Wo, dg, K)
    deform_sample.launches += 1
    return out


deform_sample.launches = 0


def modulated_deform_conv2d_fused(x, offset, mask, weight, bias=None):
    """DCNv2 3x3 (stride, padding, dilation 1) as K6's samples followed by
    one (B*H*W, 9*C) x (9*C, O) `torch.matmul` and the bias, as the JAX
    function of this name leaves its contraction to XLA."""
    sy, sx = _tap_coords(offset)
    return _contract(deform_sample(x, sy.contiguous(), sx.contiguous(),
                                   mask, offset.shape[3]), weight, bias)


class _DeformConv(torch.autograd.Function):
    """`forward_fn`'s value; the gradient of the plain version, recomputed
    from the saved inputs (the kernels have no backward, as the TPU ones
    have none)."""

    @staticmethod
    def forward(ctx, forward_fn, x, offset, mask, weight, bias):
        ctx.save_for_backward(x, offset, mask, weight, bias)
        return forward_fn(x, offset, mask, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = _modulated_deform_conv2d_plain(*inputs)
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, *[next(grads) if t is not None and t.requires_grad
                        else None for t in inputs])


def modulated_deform_conv2d_opt(x, offset, mask, weight, bias=None):
    """Differentiable DCNv2 through K6 (`modulated_deform_conv2d_fused`);
    the plain version on the CPU. Backward: autograd of the plain version.
    Counterpart of the JAX dispatcher of this name."""
    return _DeformConv.apply(modulated_deform_conv2d_fused, x, offset, mask,
                             weight, bias)


def modulated_deform_conv2d_opt2(x, offset, mask, weight, bias=None):
    """Differentiable DCNv2 through K3 (`modulated_deform_conv2d`); the
    plain version on the CPU. Backward: autograd of the plain version. The
    JAX dispatcher's `row_chunk` only bounds the memory of its XLA
    formulation and has no counterpart here."""
    return _DeformConv.apply(modulated_deform_conv2d, x, offset, mask,
                             weight, bias)
