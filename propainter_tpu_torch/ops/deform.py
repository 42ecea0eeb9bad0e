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


BLOCK_POSITIONS = 32   # output positions per K3 block (the one compiled)


def modulated_deform_conv2d(x, offset, mask, weight, bias=None):
    """DCNv2 3x3 with stride, padding and dilation 1 -> (B, H, W, O).

    Kernel K3 (`csrc/deform_conv.cu`) replaces
    `propainter_tpu/ops/deform_pallas.py:_kernel_out`. One block per
    BLOCK_POSITIONS output positions and one thread per output
    channel: the block samples (bilinear weight x modulation, zero outside)
    the 9 taps of a 64-channel slice into shared memory, contracts them
    with the matching rows of the (9*C, O) weight in registers, and moves
    on to the next slice — the sampled (P, 9*C) tensor never reaches device
    memory. Bias added in the
    epilogue. Bound: operations (2 * 9 * C * O fp32 FLOPs per position,
    about 1.9 GFLOP per call at both ProPainter call sites)."""
    if x.device.type == "cpu":
        return _modulated_deform_conv2d_plain(x, offset, mask, weight, bias)
    _build.require_cuda(x, offset, mask, weight, bias)
    B, H, W, C = x.shape
    dg = offset.shape[3]
    O = weight.shape[-1]
    if weight.shape != (3, 3, C, O) or O != 128:
        raise ValueError(f"K3 takes a (3, 3, C, 128) weight, got "
                         f"{tuple(weight.shape)}")
    if C % 64 or C % dg or 64 % (C // dg):
        raise ValueError(f"K3 needs C % 64 == 0 and groups that tile 64 "
                         f"channels (C={C}, dg={dg})")
    if offset.shape != (B, H, W, dg, 9, 2) or mask.shape != (B, H, W, dg, 9):
        raise ValueError("offset/mask shapes do not match x")
    if bias is None:
        bias = torch.zeros(O, dtype=x.dtype, device=x.device)
    tensors = (x, offset, mask, weight, bias)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("K3 inputs must be contiguous float32")
    out = torch.empty((B, H, W, O), dtype=torch.float32, device=x.device)
    fn = _build.function("deform_conv", "modulated_deform_conv2d", 6, 6)
    _build.check(fn(*[t.data_ptr() for t in tensors], out.data_ptr(),
                    B, H, W, C, dg, BLOCK_POSITIONS, _build.stream_of(x)),
                 "modulated_deform_conv2d")
    modulated_deform_conv2d.launches += 1
    return out


modulated_deform_conv2d.launches = 0


def deform_sample(x, sy, sx, mask, dg: int):
    """Bilinear samples of x (B, H, W, C) at the absolute coordinates sy, sx
    (B, Ho, Wo, dg, K) of each group's taps, zero outside the image, times
    mask (B, Ho, Wo, dg, K) -> (B, Ho, Wo, dg, K, C / dg), x's dtype.

    Kernel K6 (`deform_sample` in `csrc/deform_conv.cu`) replaces
    `propainter_tpu/ops/deform_pallas.py:_kernel`. It shares K3's sampling
    code with the contraction switched off: one thread per output value,
    consecutive threads on consecutive channels, so reads of x and writes
    of the output are coalesced. Bound: bytes (the output is K times the
    size of x). The TPU kernel's position-block choice (`_pick_pos_block`,
    `DEFORM_PB`) has no counterpart."""
    if x.device.type == "cpu":
        return _deform_sample_plain(x, sy, sx, mask, dg)
    _build.require_cuda(x, sy, sx, mask)
    B, H, W, C = x.shape
    if sy.ndim != 5 or sy.shape[0] != B or sy.shape[3] != dg or C % dg:
        raise ValueError(f"K6 takes sy (B, Ho, Wo, dg, K) with dg dividing "
                         f"C, got {tuple(sy.shape)} for x {tuple(x.shape)}")
    _, Ho, Wo, _, K = sy.shape
    if sx.shape != sy.shape or mask.shape != sy.shape:
        raise ValueError("sy, sx and mask shapes differ")
    tensors = (x, sy, sx, mask)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("K6 inputs must be contiguous float32")
    out = torch.empty((B, Ho, Wo, dg, K, C // dg), dtype=torch.float32,
                      device=x.device)
    fn = _build.function("deform_conv", "deform_sample", 5, 8)
    _build.check(fn(*[t.data_ptr() for t in tensors], out.data_ptr(),
                    B, H, W, C, Ho, Wo, dg, K, _build.stream_of(x)),
                 "deform_sample")
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
