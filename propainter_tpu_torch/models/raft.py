"""RAFT optical flow (big model), NCHW inside. Counterpart of
`propainter_tpu/models/raft.py`.

`state_dict()` keys are raft-things.pth's (without its DataParallel
`module.` prefix). Public methods take and return NHWC, as the JAX module:
`forward(image1, image2, iters)` -> (flow_low, flow_up), flows (B, h, w, 2)
as (dx, dy).

Numerics follow the JAX package: one-pass InstanceNorm in the feature
encoder, the convex-upsample mask head applied once to the final hidden
state (the reference computes it every iteration and uses only the last),
and, in the default `corr_layout="flat"`, the correlation lookup fused
with convc1 (kernel K1, over a pyramid built by K2).

bf16 (the JAX bf16 pipeline's RAFT): a copy of the module cast to bf16
encodes with `compute_dtype=torch.bfloat16` (InstanceNorm statistics stay
fp32) and refines bf16 features; the coordinate carry and the convex
upsample's products stay fp32. The correlation volume is computed in fp32
and stored in `corr_volume_dtype` (the JAX attribute; bf16 through K2's
bf16 form), whatever dtype the refinement computes in: the JAX pipeline
stores it in bf16 under precision="bf16" off the CPU, and keeps it fp32
on the CPU (`propainter_tpu/models/raft.py:319-331`); the port's pipeline
sets the attribute by the same rule.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from propainter_tpu_torch.models.layers import (
    FrozenBatchNorm, GemmConv2d, InstanceNorm, conv2d)
from propainter_tpu_torch.ops.corr import (
    corr_lookup, corr_lookup_bf16, corr_lookup_moenc, corr_lookup_moenc_bf16,
    corr_lookup_moenc_bf16_volume, corr_pyramid)
from propainter_tpu_torch.ops.warp import coords_grid


def _norm(norm_fn: str, features: int) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "batch":
        return FrozenBatchNorm(features)
    raise ValueError(norm_fn)


class ResidualBlock(nn.Module):
    """Reference RAFT/extractor.py:6-56. `norm3` is registered both as an
    attribute and inside `downsample`, as in the reference, so the
    checkpoint's duplicate keys load."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        self.conv1 = conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                conv2d(in_planes, planes, 1, stride, 0), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 encoder. Reference RAFT/extractor.py:118-192."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.conv1 = conv2d(3, 64, 7, 2, 3)
        self.norm1 = _norm(norm_fn, 64)
        layers = []
        in_planes = 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            layers.append(nn.Sequential(
                ResidualBlock(in_planes, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1)))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.conv2 = conv2d(128, output_dim, 1, 1, 0)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    """Reference RAFT/update.py:79-97. Given the pyramid and coords, the
    correlation lookup and convc1 + relu run fused (K1) and the (N, 324)
    window tensor is never stored; given precomputed windows (K7's), convc1
    is one `addmm` over them, then relu."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.radius = corr_radius
        self.convc1 = conv2d(cor_planes, 256, 1, 1, 0)
        self.convc2 = GemmConv2d(256, 192, 3, 1)
        self.convf1 = conv2d(2, 128, 7, 1, 3)
        self.convf2 = conv2d(128, 64, 3, 1, 1)
        self.conv = GemmConv2d(64 + 192, 128 - 2, 3, 1)

    def forward(self, flow, pyramid=None, coords=None, windows=None):
        """flow (B, 2, h, w); pyramid levels (B*h*w, ., .) and coords NHWC,
        or windows (B, h, w, 324) NHWC. The fused lookup's fp32 output is
        cast to flow's dtype (a no-op in fp32): over an fp32 pyramid
        through K1 with convc1's parameters in fp32; over a bf16 one
        through K1's bf16 form with bf16 parameters, or with fp32 ones
        through its form for a bf16 volume (the parameters' dtype is the
        refinement's)."""
        w = self.convc1.weight.view(self.convc1.out_channels, -1)
        if windows is None:
            if pyramid[0].dtype == torch.bfloat16:
                lookup = (corr_lookup_moenc_bf16 if w.dtype == torch.bfloat16
                          else corr_lookup_moenc_bf16_volume)
                cor = lookup(pyramid, coords, w.t(), self.convc1.bias,
                             self.radius)
            else:
                cor = corr_lookup_moenc(
                    pyramid, coords, w.t().float().contiguous(),
                    self.convc1.bias.float(), self.radius)
            cor = cor.to(flow.dtype)
        else:
            B, h, w_, C = windows.shape
            cor = torch.relu(torch.addmm(self.convc1.bias,
                                         windows.reshape(-1, C), w.t()))
            cor = cor.reshape(B, h, w_, -1)
        cor = F.relu(self.convc2(cor.permute(0, 3, 1, 2)))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """1x5 then 5x1 separable GRU. Reference RAFT/update.py:33-60."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 128 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        for sfx, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{sfx}",
                        conv2d(c, hidden_dim, k, 1, p))

    def forward(self, h, x):
        for sfx in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{sfx}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{sfx}")(hx))
            q = torch.tanh(getattr(self, f"convq{sfx}")(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    """Reference RAFT/update.py:6-14."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = conv2d(input_dim, hidden_dim, 3, 1, 1)
        self.conv2 = conv2d(hidden_dim, 2, 3, 1, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """Reference RAFT/update.py:114-136. `mask` (the convex-upsample head)
    is applied by RAFT.refine once after the loop."""

    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(conv2d(128, 256, 3, 1, 1),
                                  nn.ReLU(inplace=True),
                                  conv2d(256, 64 * 9, 1, 1, 0))

    def forward(self, net, inp, flow, pyramid=None, coords=None,
                windows=None):
        motion = self.encoder(flow, pyramid, coords, windows)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


def upsample_flow_convex(flow, mask):
    """Convex-combination 8x upsampling. Reference RAFT/raft.py:73-84.

    flow (B, 2, h, w); mask (B, 64*9, h, w) laid out (k, i, j).
    Returns (B, 2, 8h, 8w)."""
    B, _, H, W = flow.shape
    m = torch.softmax(mask.view(B, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8.0 * flow, (3, 3), padding=1).view(B, 2, 9, 1, 1, H, W)
    up = torch.sum(m * up, dim=2)                   # (B, 2, 8, 8, H, W)
    up = up.permute(0, 1, 4, 2, 5, 3)               # (B, 2, H, 8, W, 8)
    return up.reshape(B, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """RAFT-big: hidden = context = 128, 4 levels, radius 4.

    corr_layout: the form of the correlation lookup in each iteration.
      'flat'    (default) — the lookup with convc1 + relu fused (K1).
      'batched' — the (B, h, w, 324) windows (K7), then convc1 as one
                  `addmm` and relu: the JAX RAFT's `corr_layout="batched"`
                  (`propainter_tpu/models/raft.py:273-278`), which its
                  pipeline picks under `shard_inference`. Here the name
                  selects the lookup's form only: both read the same
                  pyramid; fp32 refinement only (see `refine`).
    corr_volume_dtype: the pyramid's storage dtype, torch.float32
      (default) or torch.bfloat16 (the JAX attribute,
      `propainter_tpu/models/raft.py:272`).
    Neither is part of the state dict."""

    CORR_LAYOUTS = ("flat", "batched")

    def __init__(self, corr_layout: str = "flat",
                 corr_volume_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.corr_layout = corr_layout
        self.corr_volume_dtype = corr_volume_dtype
        self.hidden_dim = 128
        self.context_dim = 128
        self.corr_levels = 4
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch")
        self.update_block = BasicUpdateBlock(self.hidden_dim)

    def encode(self, images, compute_dtype=None):
        """images (N, 3, H, W) -> fmap (N, 256, h, w), net, inp (N, 128, h,
        w). Callers encode each unique frame once and pair the features.
        compute_dtype: the images' dtype for the encoders (default fp32);
        bfloat16 with the module's parameters in bf16."""
        images = images.to(compute_dtype or torch.float32)
        fmap = self.fnet(images)
        c = self.cnet(images)
        net = torch.tanh(c[:, :self.hidden_dim])
        inp = torch.relu(c[:, self.hidden_dim:])
        return fmap, net, inp

    def refine(self, fmap1, fmap2, net, inp, iters: int = 20):
        """Iterative GRU refinement from encoded features (NCHW) in the
        dtype of net and of the module's parameters, over a pyramid stored
        in `corr_volume_dtype`; the coordinates stay fp32. Returns
        (flow_low (B, 2, h, w), flow_up (B, 2, 8h, 8w)), fp32.

        The lookup by (layout, volume, refinement dtype): 'flat' runs K1
        in the form for its volume and parameters (`BasicMotionEncoder`);
        'batched' runs K7 (its bf16 form over a bf16 volume), then convc1
        in fp32. A bf16 refinement in 'batched' raises: the JAX package
        cannot run it either (its batched lookup returns fp32 windows,
        `corr_pallas.py:363-366`, so convc1, a plain conv at
        `propainter_tpu/models/raft.py:122`, promotes them and the GRU's
        bf16 carry to fp32, and `nn.scan` refuses the changed carry,
        `:226-229`)."""
        if self.corr_layout not in self.CORR_LAYOUTS:
            raise ValueError(f"corr_layout must be one of "
                             f"{self.CORR_LAYOUTS}, got {self.corr_layout!r}")
        if self.corr_layout == "batched" and net.dtype != torch.float32:
            raise NotImplementedError(
                "corr_layout='batched' refines in fp32 only: the JAX "
                "package's batched lookup returns fp32 windows, and its "
                "convc1 (propainter_tpu/models/raft.py:122) promotes them "
                "and the GRU's bf16 carry to fp32, which nn.scan refuses "
                "(:226-229); refine in fp32 (raft_bf16_refine=False)")
        pyramid = corr_pyramid(fmap1.permute(0, 2, 3, 1),
                               fmap2.permute(0, 2, 3, 1), self.corr_levels,
                               self.corr_volume_dtype)
        B, _, h, w = net.shape
        coords0 = coords_grid(B, h, w, device=net.device)
        coords1 = coords0.clone()
        for _ in range(iters):
            flow = (coords1 - coords0).permute(0, 3, 1, 2).to(net.dtype)
            coords = coords1.contiguous()
            if self.corr_layout == "batched":
                lookup = (corr_lookup_bf16
                          if pyramid[0].dtype == torch.bfloat16
                          else corr_lookup)
                net, delta = self.update_block(
                    net, inp, flow, windows=lookup(pyramid, coords))
            else:
                net, delta = self.update_block(net, inp, flow, pyramid,
                                               coords)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        up_mask = 0.25 * self.update_block.mask(net)
        flow_low = (coords1 - coords0).permute(0, 3, 1, 2)
        return flow_low, upsample_flow_convex(flow_low, up_mask)

    def forward(self, image1, image2, iters: int = 20):
        """NHWC images -> (flow_low, flow_up) NHWC."""
        fmap1, net, inp = self.encode(image1.permute(0, 3, 1, 2).float())
        fmap2 = self.fnet(image2.permute(0, 3, 1, 2).float())
        flow_low, flow_up = self.refine(fmap1, fmap2, net, inp, iters)
        return flow_low.permute(0, 2, 3, 1), flow_up.permute(0, 2, 3, 1)
