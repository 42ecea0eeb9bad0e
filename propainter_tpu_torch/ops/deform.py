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


def _modulated_deform_conv2d_bf16_plain(x, offset, mask, weight, bias):
    """The TPU kernel's bf16 rounding points (`deform_pallas.py:173-204`,
    `:256-258`, `:276-280`), in fp32 arithmetic between them."""
    B, H, W, C = x.shape
    dg = offset.shape[3]
    Cg = C // dg
    sy, sx = _tap_coords(offset.float())
    sy = sy.to(torch.bfloat16).float()             # (B, H, W, dg, 9)
    sx = sx.to(torch.bfloat16).float()
    y0, x0 = torch.floor(sy), torch.floor(sx)

    def weight_of(s, c, size):          # max(1 - |s - c|, 0), 0 outside
        w = (1.0 - (s - c).abs()).clamp_min(0.0)
        return w * ((c >= 0) & (c <= size - 1))

    wx0 = weight_of(sx, x0, W).to(torch.bfloat16).float()
    wx1 = weight_of(sx, x0 + 1.0, W).to(torch.bfloat16).float()
    wy0, wy1 = weight_of(sy, y0, H), weight_of(sy, y0 + 1.0, H)
    xg = x.float().reshape(B, H, W, dg, Cg).permute(0, 3, 1, 2, 4)
    xg = xg.reshape(B * dg, H, W, Cg)

    def per_group(a):                   # (B, H, W, dg, 9) -> (B*dg, H, W*9)
        return a.permute(0, 3, 1, 2, 4).reshape(B * dg, H, W * 9)

    def at(yc, xc):
        return _gather2d(xg, per_group(yc).long().clamp(0, H - 1),
                         per_group(xc).long().clamp(0, W - 1))

    def g_(a):
        return per_group(a)[..., None]

    t0 = at(y0, x0) * g_(wx0) + at(y0, x0 + 1.0) * g_(wx1)
    t1 = at(y0 + 1.0, x0) * g_(wx0) + at(y0 + 1.0, x0 + 1.0) * g_(wx1)
    val = (t0 * g_(wy0) + t1 * g_(wy1)) * g_(mask.float())
    val = val.reshape(B, dg, H, W, 9, Cg).permute(0, 2, 3, 1, 4, 5)
    out = _contract(val.to(torch.bfloat16).float(), weight.float(), None)
    out = out.to(torch.bfloat16)
    return out if bias is None else out + bias


def modulated_deform_conv2d_bf16(x, offset, mask, weight, bias=None):
    """`modulated_deform_conv2d` in bf16, as the TPU kernel computes it in
    the JAX bf16 pipeline: every tensor bf16; each tap position (h + i - 1
    + dy, in fp32) rounded to bf16, the column weights rounded to bf16,
    the modulated samples rounded to bf16, a bf16 x bf16 contraction with
    fp32 sums over every group and tap, the sum rounded to bf16, then the
    bias added in bf16. Returns (B, H, W, O) bf16.

    Kernel K3's bf16 form (`modulated_deform_conv2d_bf16` in
    `csrc/deform_conv.cu`): one block per 32 positions x 128 outputs, K
    walked in 32-channel chunks of one tap whose samples are built in
    shared memory, one m16n8k16 bf16 pass on the tensor cores; no cluster
    split. Takes C % 32 == 0, C / dg in GROUP_WIDTHS and O = 128. Bound:
    operations (2 * 9 * C * 128 FLOPs per position at the bf16
    tensor-core rate)."""
    if x.device.type == "cpu":
        return _modulated_deform_conv2d_bf16_plain(x, offset, mask, weight,
                                                   bias)
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
    if bias is None:
        bias = torch.zeros(O, dtype=x.dtype, device=x.device)
    tensors = (x, offset, mask, weight, bias)
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.data_ptr() % 16 or t.numel() >= _INT32 for t in tensors):
        raise ValueError("K3's bf16 form takes contiguous bfloat16 inputs, "
                         "16-byte aligned, with fewer than 2^31 elements")
    out = torch.empty((B, H, W, O), dtype=torch.bfloat16, device=x.device)
    fn = _build.function("deform_conv", "modulated_deform_conv2d_bf16", 6, 5)
    _build.launch(fn, "modulated_deform_conv2d_bf16", x,
                  *[t.data_ptr() for t in tensors], out.data_ptr(), B, H, W,
                  C, dg)
    modulated_deform_conv2d_bf16.launches += 1
    return out


modulated_deform_conv2d_bf16.launches = 0


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
    """Differentiable DCNv2 through K3 (`modulated_deform_conv2d`, or its
    bf16 form `modulated_deform_conv2d_bf16` for bf16 x); the plain version
    on the CPU. Backward: autograd of the fp32 plain version. The JAX
    dispatcher's `row_chunk` only bounds the memory of its XLA formulation
    and has no counterpart here."""
    forward_fn = (modulated_deform_conv2d_bf16 if x.dtype == torch.bfloat16
                  else modulated_deform_conv2d)
    return _DeformConv.apply(forward_fn, x, offset, mask, weight, bias)
