"""InceptionI3d (NCDHW inside) for the VFID metric.

Counterpart of `propainter_tpu/models/i3d.py`; the architecture follows
reference core/metrics.py:334-569 (the public pytorch-i3d port of the
Kinetics I3D): Unit3D = TF-style dynamic SAME pad -> conv3d VALID -> frozen
BatchNorm(eps=1e-3) -> relu; Inception modules; the VFID feature is the
(T, H, W)-mean of Mixed_5c (1024-d), as the reference's
extract_features('Logits') computes (core/metrics.py:555-567).

Children keep the released names (`Conv3d_1a_7x7.conv3d`, `Mixed_3b.b1b.bn`,
...), so `state_dict()` keys are those of i3d_rgb_imagenet.pt without its
`logits.*` head, which the feature never uses (the loader drops it). The
convolutions are cuDNN's: the JAX package computes them with
`lax.conv_general_dilated`, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from propainter_tpu_torch.models.layers import FrozenBatchNorm


def _same_pad(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF SAME padding (reference Unit3D.compute_pad, core/metrics.py:259-263)."""
    if size % stride == 0:
        pad = max(kernel - stride, 0)
    else:
        pad = max(kernel - size % stride, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x, kernel, stride):
    """Zero-pad x (B, C, T, H, W) as TF SAME pads it: `pad // 2` before,
    the rest after, per axis (asymmetric at odd pads, which nn.Conv3d's
    symmetric `padding` cannot express)."""
    pads = [_same_pad(n, k, s) for n, k, s in zip(x.shape[2:], kernel, stride)]
    return F.pad(x, [p for pair in reversed(pads) for p in pair])


def _max_pool_same(x, kernel, stride):
    """Max pooling over the zero-padded input, as the JAX package pads it
    (`_pad_same`, zeros, not -inf)."""
    return F.max_pool3d(_pad_same(x, kernel, stride), kernel, stride)


class Unit3D(nn.Module):
    """SAME-padded conv3d (no bias) -> FrozenBatchNorm(eps=1e-3) -> relu."""

    def __init__(self, in_ch: int, out_ch: int, kernel_shape=(1, 1, 1),
                 stride=(1, 1, 1)):
        super().__init__()
        self.kernel_shape, self.stride = tuple(kernel_shape), tuple(stride)
        self.conv3d = nn.Conv3d(in_ch, out_ch, kernel_shape, stride,
                                bias=False)
        self.bn = FrozenBatchNorm(out_ch, eps=1e-3)

    def forward(self, x):
        x = _pad_same(x, self.kernel_shape, self.stride)
        return F.relu(self.bn(self.conv3d(x)))


class InceptionModule(nn.Module):
    def __init__(self, in_ch: int, out_channels: tuple[int, ...]):
        super().__init__()
        oc = out_channels
        self.out_ch = oc[0] + oc[2] + oc[4] + oc[5]
        self.b0 = Unit3D(in_ch, oc[0])
        self.b1a = Unit3D(in_ch, oc[1])
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_ch, oc[3])
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3b = Unit3D(in_ch, oc[5])

    def forward(self, x):
        b3 = _max_pool_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), self.b3b(b3)], dim=1)


# (name, Inception module's branch widths), in order; a max pool (kernel,
# stride) precedes the modules named as keys of _POOLS_BEFORE
_MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32)),
          ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
          ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
          ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
          ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
          ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
          ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5c", (384, 192, 384, 48, 128, 128)))
_POOLS_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)),
                 "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                 "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3d(nn.Module):
    """forward(video (B, T, H, W, 3) in [-1, 1]) -> (B, 1024) VFID feature."""

    def __init__(self):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        in_ch = 192
        for name, widths in _MIXED:
            module = InceptionModule(in_ch, widths)
            self.add_module(name, module)
            in_ch = module.out_ch

    def forward(self, video):
        x = video.permute(0, 4, 1, 2, 3).float()
        x = self.Conv3d_1a_7x7(x)
        x = _max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name, _ in _MIXED:
            if name in _POOLS_BEFORE:
                x = _max_pool_same(x, *_POOLS_BEFORE[name])
            x = getattr(self, name)(x)
        # VFID feature: mean over (T, H, W) — reference core/metrics.py:565
        return x.mean(dim=(2, 3, 4))
