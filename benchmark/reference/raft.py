"""RAFT optical flow (big model) in plain PyTorch, NCHW inside, fp32.

`state_dict()` keys are raft-things.pth's (without its DataParallel
`module.` prefix). The feature encoder's InstanceNorm takes one-pass
statistics; the convex-upsample mask head is applied once to the final
hidden state (the reference computes it every iteration and uses only
the last).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .corr import corr_lookup_moenc, corr_pyramid
from .layers import FrozenBatchNorm, GemmConv2d, InstanceNorm, conv2d
from .warp import coords_grid


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
    """Reference RAFT/update.py:79-97; the correlation lookup and convc1
    run together (`corr_lookup_moenc`)."""

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.radius = corr_radius
        self.convc1 = conv2d(cor_planes, 256, 1, 1, 0)
        self.convc2 = GemmConv2d(256, 192, 3, 1)
        self.convf1 = conv2d(2, 128, 7, 1, 3)
        self.convf2 = conv2d(128, 64, 3, 1, 1)
        self.conv = GemmConv2d(64 + 192, 128 - 2, 3, 1)

    def forward(self, flow, pyramid, coords):
        """flow (B, 2, h, w); pyramid levels (B*h*w, ., .); coords NHWC."""
        w = self.convc1.weight.view(self.convc1.out_channels, -1)
        cor = corr_lookup_moenc(pyramid, coords, w.t(), self.convc1.bias,
                                self.radius)
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

    def forward(self, net, inp, flow, pyramid, coords):
        motion = self.encoder(flow, pyramid, coords)
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
    """RAFT-big: hidden = context = 128, 4 levels, radius 4."""

    def __init__(self):
        super().__init__()
        self.hidden_dim = 128
        self.context_dim = 128
        self.corr_levels = 4
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(self.hidden_dim + self.context_dim, "batch")
        self.update_block = BasicUpdateBlock(self.hidden_dim)

    def encode(self, images):
        """images (N, 3, H, W) -> fmap (N, 256, h, w), net, inp (N, 128, h,
        w). Callers encode each unique frame once and pair the features."""
        fmap = self.fnet(images)
        c = self.cnet(images)
        net = torch.tanh(c[:, :self.hidden_dim])
        inp = torch.relu(c[:, self.hidden_dim:])
        return fmap, net, inp

    def refine(self, fmap1, fmap2, net, inp, iters: int = 20):
        """Iterative GRU refinement from encoded features (NCHW). Returns
        (flow_low (B, 2, h, w), flow_up (B, 2, 8h, 8w))."""
        pyramid = corr_pyramid(fmap1.permute(0, 2, 3, 1),
                               fmap2.permute(0, 2, 3, 1), self.corr_levels)
        B, _, h, w = net.shape
        coords0 = coords_grid(B, h, w, device=net.device)
        coords1 = coords0.clone()
        for _ in range(iters):
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, delta = self.update_block(net, inp, flow, pyramid,
                                           coords1.contiguous())
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        up_mask = 0.25 * self.update_block.mask(net)
        flow_low = (coords1 - coords0).permute(0, 3, 1, 2)
        return flow_low, upsample_flow_convex(flow_low, up_mask)
