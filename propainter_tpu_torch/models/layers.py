"""Shared building blocks (NCHW / NCDHW inside the models).

Counterpart of `propainter_tpu/models/layers.py`. Parameter names are the
reference's torch names, so `state_dict()` keys are the checkpoints' keys.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from propainter_tpu_torch.ops.deform import (
    modulated_deform_conv2d_opt2, split_offset_mask_channels)


def conv2d(in_ch: int, out_ch: int, kernel_size, stride=1, padding=0,
           groups: int = 1, bias: bool = True, dilation=1) -> nn.Conv2d:
    """nn.Conv2d with the argument order of the JAX helper."""
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, dilation,
                     groups, bias)


class Deconv(nn.Module):
    """2x bilinear (align_corners=True) upsample + 3x3 conv (the
    reference's `deconv`)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = conv2d(in_ch, out_ch, 3, 1, 1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="bilinear",
                                       align_corners=True))


class GemmConv2d(nn.Conv2d):
    """nn.Conv2d (stride 1) computed as unfold + one (grouped) matmul.

    For some fp32 shapes on the main path — RAFT's motion-encoder 3x3 convs
    over 256 channels at 1/8 resolution, the inpainting encoder's group
    fusion convs over 512-768 channels at 1/4 — cuDNN without TF32 picks an
    FFT algorithm that issues thousands of launches per call; with RAFT's
    two convs as GEMMs the RAFT stage fell from ~4.0 s to ~1.6 s on an
    H100 (PERF.md, Findings). Same parameters and state_dict keys as
    nn.Conv2d. The batch
    is processed in slices that keep the unfolded input under 2^28 floats.

    Which layers use it is fixed by hand from fp32 end-to-end runs at
    432x240 only; the choice must be measured again for other
    resolutions. In bf16 every such layer runs as one cuDNN convolution:
    there cuDNN's bf16 implicit GEMM on the tensor cores took 0.11-0.98
    ms a call where the unfold + matmul took 0.60-3.61 ms (H100, PERF.md,
    Findings; `chip_smoke.py --phases ...,profile`). On the CPU it
    computes the same function.

    min_batch: below this batch the fp32 layer also runs as one cuDNN
    convolution: where cuDNN's fp32 pick depends on the batch (the
    generator's propagation fuse conv: an implicit GEMM at 11 and 12
    frames, faster than the unfold + matmul, an FFT storm of 8326 kernels
    a call at 13 and 21, 30x slower; PERF.md, Findings, PR 13)."""

    MAX_COLS = 1 << 28

    def __init__(self, in_ch: int, out_ch: int, kernel_size, padding=0,
                 groups: int = 1, min_batch: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, 1, padding,
                         groups=groups)
        self.min_batch = min_batch

    def forward(self, x):
        if x.dtype != torch.float32 or x.shape[0] < self.min_batch:
            return super().forward(x)
        return self.gemm(x)

    def gemm(self, x):
        """The convolution as unfold + one (grouped) matmul, in x's dtype."""
        B, C, H, W = x.shape
        (kh, kw), (ph, pw) = self.kernel_size, self.padding
        Ho, Wo = H + 2 * ph - kh + 1, W + 2 * pw - kw + 1
        g = self.groups
        w = self.weight.view(g, self.out_channels // g, -1)
        step = max(1, self.MAX_COLS // (C * kh * kw * Ho * Wo))
        outs = []
        for xs in x.split(step):
            cols = F.unfold(xs, self.kernel_size, padding=self.padding)
            cols = cols.view(xs.shape[0], g, -1, Ho * Wo)
            outs.append(torch.matmul(w, cols).view(
                xs.shape[0], self.out_channels, Ho * Wo))
        out = torch.cat(outs) + self.bias[:, None]
        return out.view(B, self.out_channels, Ho, Wo)


class SplitGroupConv2d(GemmConv2d):
    """Grouped 3x3 conv over per-group input slices.

    Group i reads slice i of the inputs; the slices are concatenated in
    order — the reference encoder's interleaved group concat
    (x0 group slice, out group slice, for each group) — and one grouped
    convolution runs over them (as a GEMM, see GemmConv2d). The weight is
    (O, C_in / g, 3, 3), the released layout."""

    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__(in_ch, out_ch, 3, 1, groups=groups)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(xs) != self.groups:
            raise ValueError(f"expected {self.groups} slices, got {len(xs)}")
        return super().forward(torch.cat(list(xs), dim=1))


class Conv3d(nn.Conv3d):
    """nn.Conv3d; `replicate_pad` pads edge-mode first, then runs unpadded
    (torch padding_mode='replicate', as the flow completion's first conv)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), bias=True,
                 replicate_pad: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride,
                         0 if replicate_pad else padding, dilation, bias=bias)
        self._replicate = tuple(padding) if replicate_pad else None

    def forward(self, x):
        if self._replicate is not None:
            pd, ph, pw = self._replicate
            x = F.pad(x, (pw, pw, ph, ph, pd, pd), mode="replicate")
        return super().forward(x)


class InstanceNorm(nn.Module):
    """InstanceNorm2d (affine=False, eps=1e-5) with one-pass statistics,
    var = max(E[x^2] - mean^2, 0) in fp32, as RAFT's feature encoder uses in
    the JAX package."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean
        var = var.clamp_min(0.0)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d / BatchNorm3d in eval mode: the running statistics are
    fixed; the channel axis is dim 1 of an input of any rank (NCHW, NCDHW).
    Keeps BatchNorm's state_dict keys (weight, bias, running_mean,
    running_var, num_batches_tracked)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shape = (-1,) + (1,) * (x.dim() - 2)
        return ((x - self.running_mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def deform_align(x, raw, weight, bias, dg, max_residue_magnitude, flow=None):
    """Modulated deform conv of x (B, C, H, W) with offsets/masks from the
    conv_offset output raw (B, 27*dg, H, W) -> (B, O, H, W), through the
    differentiable dispatcher the JAX models call (kernel K3 forward)."""
    offset, mask = split_offset_mask_channels(
        raw.permute(0, 2, 3, 1), dg, max_residue_magnitude, flow)
    out = modulated_deform_conv2d_opt2(
        x.permute(0, 2, 3, 1).contiguous(), offset.contiguous(),
        mask.contiguous(), weight.permute(2, 3, 1, 0).contiguous(), bias)
    return out.permute(0, 3, 1, 2)
