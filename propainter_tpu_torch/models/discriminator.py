"""T-PatchGAN discriminators (spectral-norm 3-D convolutions), NHWC in and
out, NCDHW inside. Counterpart of `propainter_tpu/models/discriminator.py`;
`state_dict()` keys are the reference's dis_*.pth keys (`conv.{i}.
weight_orig`, `weight_u`, `weight_v` of each spectral-norm conv,
`conv.10.weight` and `.bias` of the last).

The spectral norm is flax's `nn.SpectralNorm` (the JAX module's), not
`torch.nn.utils.spectral_norm`: every call runs one power step from the
stored u, whatever the module's train/eval mode, and stores the new u only
when the caller asks (`update_stats`). With the weight as the (out, in *
kd * kh * kw) matrix W, the step is v = n(Wᵀu), u' = n(W v), sigma =
u'ᵀ W v, with n(x) = x * rsqrt(sum(x²) + 1e-12) and u', v held constant
for the gradient; the conv runs with W / sigma. Flax orders W's columns
as (kd, kh, kw, in): a permutation of these, which leaves u', sigma and
the step unchanged. `weight_v` keeps the last stored step's v for the
reference's layout; the step does not read it.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

SN_EPS = 1e-12


def _l2_normalize(x):
    return x * torch.rsqrt(torch.sum(x * x) + SN_EPS)


class SpectralNormConv3d(nn.Module):
    """Conv3d without bias whose weight is divided by its spectral norm
    estimate (module docstring)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride,
                 padding):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight_orig = nn.Parameter(
            torch.empty(out_ch, in_ch, *kernel_size))
        nn.init.kaiming_uniform_(self.weight_orig, a=math.sqrt(5))
        self.register_buffer("weight_u", torch.randn(out_ch))
        self.register_buffer("weight_v", _l2_normalize(
            torch.randn(self.weight_orig[0].numel())))

    def forward(self, x, update_stats: bool):
        w = self.weight_orig
        wm = w.flatten(1)
        with torch.no_grad():
            v = _l2_normalize(wm.t() @ self.weight_u)
            u = _l2_normalize(wm @ v)
            if update_stats:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        sigma = torch.dot(u, wm @ v)
        w_sn = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return F.conv3d(x, w_sn, None, self.stride, self.padding)


class Discriminator(nn.Module):
    """3-D temporal PatchGAN: five spectral-norm Conv3d k=(kd, 5, 5)
    s=(1, 2, 2) and a plain one. Reference model/propainter.py:378-451
    (kd 3) and Discriminator_2D, :454-527 (kd 1).

    forward(x (B, T, H, W, C), update_stats) -> (B, T', H', W', 128),
    sigmoid probabilities when use_sigmoid (gan_type other than hinge)."""

    def __init__(self, in_channels: int = 3, use_sigmoid: bool = False,
                 nf: int = 32, kd: int = 3):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        pd = (kd - 1) // 2
        pad0 = (1, 1, 1) if kd == 3 else (0, 2, 2)
        chans = [in_channels, nf, nf * 2, nf * 4, nf * 4, nf * 4]
        layers = []
        for i in range(5):
            layers += [SpectralNormConv3d(chans[i], chans[i + 1],
                                          (kd, 5, 5), (1, 2, 2),
                                          pad0 if i == 0 else (pd, 2, 2)),
                       nn.LeakyReLU(0.2)]
        layers.append(nn.Conv3d(nf * 4, nf * 4, (kd, 5, 5), (1, 2, 2),
                                (pd, 2, 2)))
        self.conv = nn.Sequential(*layers)

    def forward(self, x, update_stats: bool = True):
        x = x.permute(0, 4, 1, 2, 3)
        for layer in self.conv:
            x = (layer(x, update_stats)
                 if isinstance(layer, SpectralNormConv3d) else layer(x))
        if self.use_sigmoid:
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 4, 1)


def Discriminator2D(**kwargs) -> Discriminator:
    """The k=(1, 5, 5) variant. Reference model/propainter.py:454-527."""
    return Discriminator(kd=1, **kwargs)
