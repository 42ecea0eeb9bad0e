"""Recurrent flow completion network, NCDHW / NCHW inside. Counterpart of
`propainter_tpu/models/flow_completion.py`; `state_dict()` keys are
recurrent_flow_completion.pth's.

`RecurrentFlowCompleteNet.forward(masked_flows (B, T, H, W, 2), masks
(B, T, H, W, 1))` -> completed flows (B, T, H, W, 2). The second-order
propagation is a Python loop over frames; its deformable alignment is
kernel K3.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from propainter_tpu_torch.models.layers import (
    Conv3d, Deconv, conv2d, deform_align, leaky_relu)


class P3DBlock(nn.Module):
    """(1,3,3) spatial conv + (3,1,1) dilated temporal conv.
    Reference model/recurrent_flow_completion.py:148-169."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Sequential(Conv3d(in_ch, out_ch, (1, 3, 3),
                                          (1, stride, stride), (0, 1, 1)))
        self.conv2 = nn.Sequential(Conv3d(out_ch, out_ch, (3, 1, 1),
                                          (1, 1, 1), (2, 0, 0),
                                          dilation=(2, 1, 1)))

    def forward(self, x):
        return self.conv2(leaky_relu(self.conv1(x), 0.2))


def _conv_offset(in_ch: int, c: int, dg: int) -> nn.Sequential:
    return nn.Sequential(
        conv2d(in_ch, c, 3, 1, 1), nn.LeakyReLU(0.1, inplace=True),
        conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1, inplace=True),
        conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.1, inplace=True),
        conv2d(c, 27 * dg, 3, 1, 1))


class SecondOrderDeformableAlignment(nn.Module):
    """Deformable alignment conditioned on the current and two previous
    features. Reference model/recurrent_flow_completion.py:9-44:
    x (B, 2C, H, W) = (prop_{t-1}, prop_{t-2}); cond (B, 3C, H, W)."""

    def __init__(self, channels: int, deform_groups: int = 16,
                 max_residue_magnitude: float = 5.0):
        super().__init__()
        self.dg = deform_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.weight = nn.Parameter(torch.empty(channels, 2 * channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.kaiming_normal_(self.weight)
        self.conv_offset = _conv_offset(3 * channels, channels, deform_groups)

    def forward(self, x, cond):
        return deform_align(x, self.conv_offset(cond), self.weight,
                            self.bias, self.dg, self.max_residue_magnitude)


class BidirectionalPropagation3D(nn.Module):
    """Backward then forward second-order propagation + 1x1 fusion.
    Reference model/recurrent_flow_completion.py:46-124."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(("backward_", "forward_")):
            self.deform_align[name] = SecondOrderDeformableAlignment(channels)
            self.backbone[name] = nn.Sequential(
                conv2d((2 + i) * channels, channels, 3, 1, 1),
                nn.LeakyReLU(0.1, inplace=True),
                conv2d(channels, channels, 3, 1, 1))
        self.fusion = conv2d(2 * channels, channels, 1, 1, 0)

    def _run(self, name, frames, extra):
        zeros = torch.zeros_like(frames[0])
        outs = []
        for i, cur in enumerate(frames):
            prop1 = outs[-1] if i > 0 else zeros
            prop2 = outs[-2] if i > 1 else zeros
            if i > 0:
                cond = torch.cat([prop1, cur, prop2], dim=1)
                feat_prop = self.deform_align[name](
                    torch.cat([prop1, prop2], dim=1), cond)
            else:
                feat_prop = zeros
            feat = torch.cat([cur] + ([extra[i]] if extra else [])
                             + [feat_prop], dim=1)
            outs.append(feat_prop + self.backbone[name](feat))
        return outs

    def forward(self, x):
        """x (B, C, T, H, W) -> (B, C, T, H, W)."""
        frames = list(x.unbind(2))
        back = self._run("backward_", frames[::-1], None)[::-1]
        fwd = self._run("forward_", frames, back)
        fused = [self.fusion(torch.cat([b, f], dim=1))
                 for b, f in zip(back, fwd)]
        return torch.stack(fused, dim=2) + x


class EdgeDetection(nn.Module):
    """Flow-edge head, used in training only. Reference :172-200."""

    def __init__(self, in_ch: int = 2, out_ch: int = 1, mid_ch: int = 16):
        super().__init__()
        self.projection = nn.Sequential(conv2d(in_ch, mid_ch, 3, 1, 1),
                                        nn.LeakyReLU(0.2, inplace=True))
        self.mid_layer_1 = nn.Sequential(conv2d(mid_ch, mid_ch, 3, 1, 1),
                                         nn.LeakyReLU(0.2, inplace=True))
        self.mid_layer_2 = nn.Sequential(conv2d(mid_ch, mid_ch, 3, 1, 1))
        self.out_layer = conv2d(mid_ch, out_ch, 1, 1, 0)

    def forward(self, flow):
        x = self.projection(flow)
        e = self.mid_layer_2(self.mid_layer_1(x))
        return torch.sigmoid(self.out_layer(leaky_relu(x + e, 0.01)))


class RecurrentFlowCompleteNet(nn.Module):
    """Complete masked optical flow. Reference :203-309."""

    def __init__(self):
        super().__init__()
        self.downsample = nn.Sequential(
            Conv3d(3, 32, (1, 5, 5), (1, 2, 2), (0, 2, 2),
                   replicate_pad=True),
            nn.LeakyReLU(0.2, inplace=True))
        self.encoder1 = nn.Sequential(
            P3DBlock(32, 32, 1), nn.LeakyReLU(0.2, inplace=True),
            P3DBlock(32, 64, 2), nn.LeakyReLU(0.2, inplace=True))
        self.encoder2 = nn.Sequential(
            P3DBlock(64, 64, 1), nn.LeakyReLU(0.2, inplace=True),
            P3DBlock(64, 128, 2), nn.LeakyReLU(0.2, inplace=True))
        self.mid_dilation = nn.Sequential(
            Conv3d(128, 128, (1, 3, 3), padding=(0, 3, 3),
                   dilation=(1, 3, 3)), nn.LeakyReLU(0.2, inplace=True),
            Conv3d(128, 128, (1, 3, 3), padding=(0, 2, 2),
                   dilation=(1, 2, 2)), nn.LeakyReLU(0.2, inplace=True),
            Conv3d(128, 128, (1, 3, 3), padding=(0, 1, 1)),
            nn.LeakyReLU(0.2, inplace=True))
        self.feat_prop_module = BidirectionalPropagation3D(128)
        self.decoder2 = nn.Sequential(
            conv2d(128, 128, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            Deconv(128, 64), nn.LeakyReLU(0.2, inplace=True))
        self.decoder1 = nn.Sequential(
            conv2d(64, 64, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            Deconv(64, 32), nn.LeakyReLU(0.2, inplace=True))
        self.upsample = nn.Sequential(
            conv2d(32, 32, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            Deconv(32, 2))
        self.edgeDetector = EdgeDetection(2, 1, 16)

    def forward(self, masked_flows, masks):
        """(B, T, H, W, 2), (B, T, H, W, 1) -> (B, T, H, W, 2)."""
        B, T, H, W, _ = masked_flows.shape
        x = torch.cat([masked_flows, masks], dim=-1).permute(0, 4, 1, 2, 3)
        x = self.downsample(x)
        e1 = self.encoder1(x)
        m = self.mid_dilation(self.encoder2(e1))
        prop = self.feat_prop_module(m)                 # (B, C, T, h, w)

        def frames(t):  # (B, C, T, h, w) -> (B*T, C, h, w)
            return t.transpose(1, 2).reshape(B * T, t.shape[1],
                                              *t.shape[3:])

        d2 = self.decoder2(frames(prop)) + frames(e1)
        d1 = self.decoder1(d2)
        flow = self.upsample(d1)                        # (B*T, 2, H, W)
        return flow.view(B, T, 2, H, W).permute(0, 1, 3, 4, 2)


def forward_bidirect_flow(model, masked_flows_bi, masks):
    """Complete both directions in one batched call (the forward flows
    stacked with the time-reversed backward flows). Reference :312-337.

    masked_flows_bi: (flows_f, flows_b), each (B, T-1, H, W, 2);
    masks: (B, T, H, W, 1). Returns [pred_f, pred_b]."""
    masks_f, masks_b = masks[:, :-1], masks[:, 1:]
    mf = masked_flows_bi[0] * (1 - masks_f)
    mb = masked_flows_bi[1] * (1 - masks_b)
    B = mf.shape[0]
    pred = model(torch.cat([mf, mb.flip(1)], dim=0),
                 torch.cat([masks_f, masks_b.flip(1)], dim=0))
    return [pred[:B], pred[B:].flip(1)]


def combine_flow(masked_flows_bi, pred_flows_bi, masks):
    """pred * mask + observed * (1 - mask). Reference :340-347."""
    masks_f, masks_b = masks[:, :-1], masks[:, 1:]
    f = pred_flows_bi[0] * masks_f + masked_flows_bi[0] * (1 - masks_f)
    b = pred_flows_bi[1] * masks_b + masked_flows_bi[1] * (1 - masks_b)
    return f, b
