"""VGG feature extractor and the LPIPS network (NHWC in and out, NCHW
inside), for the perceptual losses. Counterpart of
`propainter_tpu/models/vgg.py`. `VGGFeatureExtractor.state_dict()` keys
are torchvision's (`features.{i}.weight`, the layer's index in
`VGG_LAYOUTS`); `LPIPSVgg`'s are the lpips package's linear heads
(`lin{i}.model.1.weight`) beside its VGG16 under `net.`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

# torchvision's VGG `features` layouts (reference model/vgg_arch.py:8-31)
VGG_LAYOUTS = {
    "vgg16": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
        "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3",
        "pool3",
        "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3",
        "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
        "pool5",
    ],
    "vgg19": [
        "conv1_1", "relu1_1", "conv1_2", "relu1_2", "pool1",
        "conv2_1", "relu2_1", "conv2_2", "relu2_2", "pool2",
        "conv3_1", "relu3_1", "conv3_2", "relu3_2", "conv3_3", "relu3_3",
        "conv3_4", "relu3_4", "pool3",
        "conv4_1", "relu4_1", "conv4_2", "relu4_2", "conv4_3", "relu4_3",
        "conv4_4", "relu4_4", "pool4",
        "conv5_1", "relu5_1", "conv5_2", "relu5_2", "conv5_3", "relu5_3",
        "conv5_4", "relu5_4", "pool5",
    ],
}

_CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGGFeatureExtractor(nn.Module):
    """VGG up to the deepest requested layer, returning the named
    activations. Reference model/vgg_arch.py:51-157.

    layer_names: the activations returned (e.g. ('relu1_2', 'conv5_4'));
    vgg_type: 'vgg16' | 'vgg19'; use_input_norm: ImageNet-normalise the
    [0, 1] input; range_norm: map a [-1, 1] input to [0, 1] first."""

    def __init__(self, layer_names: Sequence[str] = ("conv5_4",),
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        layout = VGG_LAYOUTS[vgg_type]
        self.names = layout[:max(layout.index(n) for n in layer_names) + 1]
        layers, in_ch = [], 3
        for name in self.names:
            if name.startswith("conv"):
                out_ch = _CHANNELS[int(name[4])]
                layers.append(nn.Conv2d(in_ch, out_ch, 3, padding=1))
                in_ch = out_ch
            elif name.startswith("relu"):
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        """x (B, H, W, 3) -> {name: (B, h, w, c)}."""
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
        x = x.permute(0, 3, 1, 2)
        out = {}
        for name, layer in zip(self.names, self.features):
            x = layer(x)
            if name in self.layer_names:
                out[name] = x.permute(0, 2, 3, 1)
        return out


class _NetLin(nn.Module):
    """The lpips package's linear head (dropout, 1x1 conv without bias):
    only its weight is used, as |w|, like the JAX module."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)


class LPIPSVgg(nn.Module):
    """LPIPS distance with a VGG16 backbone, as `lpips.LPIPS(net='vgg',
    spatial=False)` (reference core/loss.py:122): inputs scaled by LPIPS's
    ScalingLayer, VGG16 features at relu{1_2, 2_2, 3_3, 4_3, 5_3},
    normalised over channels, squared difference, a non-negative linear
    head per tap, spatial mean, summed over taps."""

    TAPS = ("relu1_2", "relu2_2", "relu3_3", "relu4_3", "relu5_3")
    SHIFT = (-0.030, -0.088, -0.188)
    SCALE = (0.458, 0.448, 0.450)

    def __init__(self):
        super().__init__()
        self.net = VGGFeatureExtractor(self.TAPS, "vgg16",
                                       use_input_norm=False, range_norm=False)
        for i, tap in enumerate(self.TAPS):
            self.add_module(f"lin{i}", _NetLin(_CHANNELS[int(tap[4])]))

    def forward(self, pred, target):
        """pred / target (B, H, W, 3) in [-1, 1] -> (B,) distances."""
        shift, scale = pred.new_tensor(self.SHIFT), pred.new_tensor(self.SCALE)
        fa = self.net((pred - shift) / scale)
        fb = self.net((target - shift) / scale)
        total = 0.0
        for i, tap in enumerate(self.TAPS):
            diff = (_unit_normalize(fa[tap]) - _unit_normalize(fb[tap])) ** 2
            w = getattr(self, f"lin{i}").model[1].weight.reshape(-1)
            total = total + torch.mean(torch.sum(diff * torch.abs(w), dim=-1),
                                       dim=(1, 2))
        return total


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


def lpips_state_dict(lpips_sd, vgg_sd) -> dict:
    """An `LPIPSVgg` state dict from an lpips package checkpoint
    (`lin{i}.model.1.weight` or `lins.{i}.model.1.weight`) and a
    torchvision vgg16 state dict (`features.{i}.*`); load it strictly."""
    out = {f"net.{k}": v for k, v in vgg_sd.items()
           if k.startswith("features.")}
    for i in range(len(LPIPSVgg.TAPS)):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lpips_sd:
                out[f"lin{i}.model.1.weight"] = lpips_sd[key]
                break
        else:
            raise KeyError(f"lin{i} weight not found in the lpips state dict")
    return out
