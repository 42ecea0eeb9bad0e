"""Cutie, the demo's video-object-segmentation tracker, in NCHW.
Counterpart of `propainter_tpu/models/cutie.py`.

A query-transformer VOS network: resnet pixel and mask encoders with frozen
batch norm, an anisotropic-L2 key memory read by top-k softmax, object
summaries, a sensory (GRU) memory and a skip-connected mask decoder.

Children keep the released names (`pixel_encoder.res2.0.conv1`,
`mask_encoder.fuser.block1.conv`, `object_transformer.blocks.0.
read_from_pixel.cross_attn.in_proj_weight`, `object_transformer.query_init`
...), so `state_dict()` keys are those of cutie-base-mega.pth and
`load_cutie_state_dict` loads one strictly, after dropping what the JAX
converter skips (`CUTIE_SKIP`).

Layouts:
  * shared ("x") features: (B, C, H, W);
  * per-object ("g") features: (B, N, C, H, W), folded to (B*N, C, H, W)
    around convolutions;
  * memory keys (B, Ck, T) and values (B, N, Cv, T), the token axis last.

Cutie calls no kernel of `ops/`: its convolutions are cuDNN's, its
products `torch.matmul`, its top-k `torch.topk`. Inference-time memory
management lives in demo/cutie_core.py.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from propainter_tpu_torch.models.layers import FrozenBatchNorm, conv2d
from propainter_tpu_torch.ops.interp import resize


@dataclasses.dataclass(frozen=True)
class CutieConfig:
    """The demo's model config (the release's: resnet50 pixel trunk,
    resnet18 mask trunk, 3 query-transformer blocks of 16 queries)."""

    pixel_mean: tuple = (0.485, 0.456, 0.406)
    pixel_std: tuple = (0.229, 0.224, 0.225)
    pixel_dim: int = 256
    key_dim: int = 64
    value_dim: int = 256
    sensory_dim: int = 256
    embed_dim: int = 256
    pixel_encoder_type: str = "resnet50"
    ms_dims: tuple = (1024, 512, 256)
    mask_encoder_type: str = "resnet18"
    mask_encoder_final_dim: int = 256
    pixel_pe_scale: float = 32.0
    pixel_pe_temperature: float = 128.0
    ot_ff_dim: int = 2048
    ot_num_heads: int = 8
    ot_num_blocks: int = 3
    ot_num_queries: int = 16
    up_dims: tuple = (256, 128, 128)


# ---------------------------------------------------------------------------
# ResNet trunk (frozen BN)
# ---------------------------------------------------------------------------


class _BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = nn.Sequential(
            conv2d(inplanes, planes, 1, stride, 0, bias=False),
            FrozenBatchNorm(planes)) if has_downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class _Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 1, 1, 0, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv2d(planes, planes * 4, 1, 1, 0, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = nn.Sequential(
            conv2d(inplanes, planes * 4, 1, stride, 0, bias=False),
            FrozenBatchNorm(planes * 4)) if has_downsample else None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


def _max_pool_3x3s2(x):
    """MaxPool2d(kernel=3, stride=2, padding=1): -inf padding."""
    return F.max_pool2d(x, 3, 2, 1)


class ResNetTrunk(nn.Module):
    """conv1 .. layer3 of a torchvision-layout resnet, its layers as
    attributes named `layer_names` (the pixel encoder calls layer1 'res2',
    as the release does). `trunk(x)` returns [f4, f8, f16]."""

    def __init__(self, arch: str, in_ch: int = 3,
                 layer_names: Sequence[str] = ("layer1", "layer2",
                                               "layer3")):
        super().__init__()
        block = _BasicBlock if arch == "resnet18" else _Bottleneck
        counts = (2, 2, 2) if arch == "resnet18" else (3, 4, 6)
        self.conv1 = conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer_names = tuple(layer_names)
        inplanes = 64
        for lname, n, planes, stride in zip(layer_names, counts,
                                            (64, 128, 256), (1, 2, 2)):
            blocks = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                ds = bi == 0 and (s != 1
                                  or inplanes != planes * block.expansion)
                blocks.append(block(inplanes, planes, s, ds))
                inplanes = planes * block.expansion
            setattr(self, lname, nn.Sequential(*blocks))

    def trunk(self, x):
        x = _max_pool_3x3s2(F.relu(self.bn1(self.conv1(x))))
        feats = []
        for lname in self.layer_names:
            x = getattr(self, lname)(x)
            feats.append(x)
        return feats


# ---------------------------------------------------------------------------
# Group helpers
# ---------------------------------------------------------------------------


def _fold(g):
    """(B, N, C, H, W) -> (B*N, C, H, W)."""
    return g.flatten(0, 1)


def _unfold(x, like):
    return x.view(like.shape[:2] + x.shape[1:])


def _bilinear(x, size):
    """Bilinear, align_corners=False, on an NCHW tensor (through the
    port's NHWC `resize`)."""
    return resize(x.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)


def upsample_groups(g, ratio: int = 2):
    x = _fold(g)
    H, W = x.shape[-2:]
    return _unfold(_bilinear(x, (H * ratio, W * ratio)), g)


def avg_pool_area(x, factor: int):
    """F.interpolate(mode='area') at an integer factor: average pooling."""
    return F.avg_pool2d(x, factor)


def downsample_groups(g, factor: int = 2):
    return _unfold(avg_pool_area(_fold(g), factor), g)


class GroupResBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = conv2d(in_dim, out_dim, 3, 1, 1)
        self.conv2 = conv2d(out_dim, out_dim, 3, 1, 1)
        self.downsample = (conv2d(in_dim, out_dim, 1)
                           if in_dim != out_dim else None)

    def forward(self, g):
        x = _fold(g)
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return _unfold(y + x, g)


class CAResBlock(nn.Module):
    """Channel-attention res block: two 3x3 convs scaled by an eca gate (a
    k-tap Conv1d over the channel axis of the pooled features)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        t = int((abs(math.log2(out_dim)) + 1) // 2)
        k = t if t % 2 else t + 1
        self.conv1 = conv2d(in_dim, out_dim, 3, 1, 1)
        self.conv2 = conv2d(out_dim, out_dim, 3, 1, 1)
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        self.downsample = (conv2d(in_dim, out_dim, 1)
                           if in_dim != out_dim else None)

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(F.relu(x))))
        w = torch.sigmoid(self.conv(y.mean(dim=(2, 3))[:, None])[:, 0])
        r = x if self.downsample is None else self.downsample(x)
        return y * w[:, :, None, None] + r


class _Distributor(nn.Module):
    """x (shared) and g (grouped) 1x1 transforms, added."""

    def __init__(self, x_dim: int, g_dim: int, out_dim: int):
        super().__init__()
        self.x_transform = conv2d(x_dim, out_dim, 1)
        self.g_transform = conv2d(g_dim, out_dim, 1)

    def forward(self, x, g):
        return (_unfold(self.g_transform(_fold(g)), g)
                + self.x_transform(x)[:, None])


class GroupFeatureFusionBlock(nn.Module):
    """x (shared) + g (grouped) -> fused grouped features."""

    def __init__(self, x_dim: int, g_dim: int, out_dim: int):
        super().__init__()
        self.distributor = _Distributor(x_dim, g_dim, out_dim)
        self.block1 = CAResBlock(out_dim, out_dim)
        self.block2 = CAResBlock(out_dim, out_dim)

    def forward(self, x, g):
        g = self.distributor(x, g)
        return _unfold(self.block2(self.block1(_fold(g))), g)


def _recurrent_update(h, values):
    """GRU-style sensory update over the channel axis (dim 2)."""
    dim = values.shape[2] // 3
    forget = torch.sigmoid(values[:, :, :dim])
    update = torch.sigmoid(values[:, :, dim:2 * dim])
    new_value = torch.tanh(values[:, :, 2 * dim:])
    return forget * h * (1 - update) + update * new_value


class SensoryDeepUpdater(nn.Module):
    def __init__(self, g_dim: int, sensory_dim: int):
        super().__init__()
        self.transform = conv2d(g_dim + sensory_dim, sensory_dim * 3, 3, 1, 1)

    def forward(self, g, h):
        x = torch.cat([g, h], dim=2)
        return _recurrent_update(h, _unfold(self.transform(_fold(x)), x))


class SensoryUpdater(nn.Module):
    """Multi-scale decoder-driven sensory update."""

    def __init__(self, g_dims: Sequence[int], mid_dim: int,
                 sensory_dim: int):
        super().__init__()
        self.g16_conv = conv2d(g_dims[0], mid_dim, 1)
        self.g8_conv = conv2d(g_dims[1], mid_dim, 1)
        self.g4_conv = conv2d(g_dims[2], mid_dim, 1)
        self.transform = conv2d(mid_dim + sensory_dim, sensory_dim * 3, 3, 1,
                                1)

    def forward(self, g16, g8, g4, h):
        def gconv(conv, g):
            return _unfold(conv(_fold(g)), g)

        g = (gconv(self.g16_conv, g16)
             + gconv(self.g8_conv, downsample_groups(g8, 2))
             + gconv(self.g4_conv, downsample_groups(g4, 4)))
        x = torch.cat([g, h], dim=2)
        return _recurrent_update(h, _unfold(self.transform(_fold(x)), x))


# ---------------------------------------------------------------------------
# Positional encoding
# ---------------------------------------------------------------------------


def positional_encoding_2d(h: int, w: int, dim: int, scale: float,
                           temperature: float) -> np.ndarray:
    """(h, w, 2*ceil(dim/4)*2) sin/cos embedding, normalized coords."""
    d = int(np.ceil(dim / 4) * 2)
    inv_freq = 1.0 / (temperature ** (np.arange(0, d, 2, np.float32) / d))
    eps = 1e-6
    pos_y = np.arange(h, dtype=np.float32)
    pos_x = np.arange(w, dtype=np.float32)
    pos_y = pos_y / (pos_y[-1] + eps) * scale
    pos_x = pos_x / (pos_x[-1] + eps) * scale

    def emb(pos):
        sin_inp = pos[:, None] * inv_freq[None, :]
        e = np.stack([np.sin(sin_inp), np.cos(sin_inp)], -1)
        return e.reshape(pos.shape[0], -1)

    emb_y = emb(pos_y)[:, None, :]  # (h, 1, d)
    emb_x = emb(pos_x)[None, :, :]  # (1, w, d)
    out = np.zeros((h, w, d * 2), np.float32)
    out[:, :, :d] = emb_x
    out[:, :, d:] = np.broadcast_to(emb_y, (h, w, d))
    return out


def _pe(h: int, w: int, cfg: CutieConfig, device) -> torch.Tensor:
    return torch.from_numpy(positional_encoding_2d(
        h, w, cfg.embed_dim, cfg.pixel_pe_scale,
        cfg.pixel_pe_temperature)).to(device)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (fused `in_proj_weight` /
    `in_proj_bias`, `out_proj`), batch first, no dropout."""

    def __init__(self, dim: int, nhead: int):
        super().__init__()
        self.dim, self.nhead = dim, nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, attn_mask=None):
        """q (B', Tq, C), k / v (B', Tk, C); attn_mask (B'*h, Tq, Tk) bool,
        True = blocked (set to -inf before the softmax)."""
        E, h = self.dim, self.nhead
        w, b = self.in_proj_weight, self.in_proj_bias
        B = q.shape[0]

        def heads(x, i):
            y = F.linear(x, w[i * E:(i + 1) * E], b[i * E:(i + 1) * E])
            return y.view(B, y.shape[1], h, E // h).transpose(1, 2)

        qh, kh, vh = heads(q, 0), heads(k, 1), heads(v, 2)
        att = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(E // h)
        if attn_mask is not None:
            att = att.masked_fill(attn_mask.view(att.shape), float("-inf"))
        out = torch.matmul(torch.softmax(att, dim=-1), vh)
        return self.out_proj(out.transpose(1, 2).reshape(B, -1, E))


class SelfAttention(nn.Module):
    """Pre-LN self attention; positional encodings on q and k."""

    def __init__(self, dim: int, nhead: int):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, nhead)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x, pe):
        x = self.norm(x)
        xpe = x + pe
        return x + self.self_attn(xpe, xpe, x)


class CrossAttention(nn.Module):
    """(Pre-LN) cross attention from x to mem; positional encodings on q and
    k."""

    def __init__(self, dim: int, nhead: int, norm: bool = True):
        super().__init__()
        self.cross_attn = MultiheadAttention(dim, nhead)
        self.norm = nn.LayerNorm(dim) if norm else None

    def forward(self, x, mem, x_pe, mem_pe, attn_mask=None):
        if self.norm is not None:
            x = self.norm(x)
        return x + self.cross_attn(x + x_pe, mem + mem_pe, mem, attn_mask)


class FFN(nn.Module):
    def __init__(self, dim: int, dim_ff: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, dim_ff)
        self.linear2 = nn.Linear(dim_ff, dim)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        return x + self.linear2(F.relu(self.linear1(self.norm(x))))


class PixelFFN(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = CAResBlock(dim, dim)

    def forward(self, pixel, pixel_flat):
        """pixel (B, N, C, H, W) gives the shape; pixel_flat (B*N, H*W, C)
        is transformed."""
        B, N, C, H, W = pixel.shape
        x = pixel_flat.view(B * N, H, W, C).permute(0, 3, 1, 2)
        return self.conv(x).view(B, N, C, H, W)


# ---------------------------------------------------------------------------
# Big modules
# ---------------------------------------------------------------------------


class PixelEncoder(ResNetTrunk):
    def __init__(self, config: CutieConfig):
        super().__init__(config.pixel_encoder_type,
                         layer_names=("res2", "layer2", "layer3"))

    def forward(self, image):
        f4, f8, f16 = self.trunk(image)
        return f16, f8, f4


class KeyProjection(nn.Module):
    def __init__(self, config: CutieConfig):
        super().__init__()
        mid = config.pixel_dim
        self.pix_feat_proj = conv2d(config.ms_dims[0], mid, 1)
        self.key_proj = conv2d(mid, config.key_dim, 3, 1, 1)
        self.d_proj = conv2d(mid, 1, 3, 1, 1)
        self.e_proj = conv2d(mid, config.key_dim, 3, 1, 1)

    def forward(self, f16, need_s: bool = True, need_e: bool = True):
        x = self.pix_feat_proj(f16)
        shrinkage = self.d_proj(x) ** 2 + 1 if need_s else None
        selection = torch.sigmoid(self.e_proj(x)) if need_e else None
        return self.key_proj(x), shrinkage, selection


class MaskEncoder(ResNetTrunk):
    """The mask trunk (image + mask + others, 5 channels) with the fuser
    and the deep sensory update."""

    def __init__(self, config: CutieConfig):
        super().__init__(config.mask_encoder_type, in_ch=5)
        trunk_out = 256 if config.mask_encoder_type == "resnet18" else 1024
        self.fuser = GroupFeatureFusionBlock(config.pixel_dim, trunk_out,
                                             config.value_dim)
        self.sensory_update = SensoryDeepUpdater(config.value_dim,
                                                 config.sensory_dim)

    def forward(self, image, pix_feat, sensory, masks, others,
                deep_update: bool = True):
        """image (B, 3, H, W) normalized; pix_feat (B, pixel_dim, h, w);
        sensory (B, N, sensory_dim, h, w); masks / others (B, N, H, W)."""
        g = torch.stack([masks, others], dim=2)
        img = image[:, None].expand(-1, g.shape[1], -1, -1, -1)
        g = torch.cat([img, g], dim=2)
        g16 = _unfold(self.trunk(_fold(g))[2], g)
        g = self.fuser(pix_feat, g16)
        new_sensory = (self.sensory_update(g, sensory) if deep_update
                       else sensory)
        return g, new_sensory


class PixelFeatureFuser(nn.Module):
    def __init__(self, config: CutieConfig):
        super().__init__()
        self.fuser = GroupFeatureFusionBlock(
            config.pixel_dim, config.value_dim, config.embed_dim)
        self.sensory_compress = conv2d(config.sensory_dim + 2,
                                       config.value_dim, 1)

    def forward(self, pix_feat, pixel_memory, sensory_memory, last_mask,
                last_others):
        """pix_feat (B, C, h, w); pixel_memory (B, N, value_dim, h, w);
        sensory_memory (B, N, sensory_dim, h, w); last_mask / last_others
        (B, N, h, w)."""
        g = torch.stack([last_mask, last_others], dim=2)
        x = torch.cat([sensory_memory, g], dim=2)
        p16 = pixel_memory + _unfold(self.sensory_compress(_fold(x)), x)
        return self.fuser(pix_feat, p16)


class ObjectSummarizer(nn.Module):
    def __init__(self, config: CutieConfig):
        super().__init__()
        self.config = config
        E, ns = config.embed_dim, config.ot_num_queries
        self.input_proj = nn.Linear(config.value_dim, E)
        self.feature_pred = nn.Sequential(nn.Linear(E, E), nn.ReLU(),
                                          nn.Linear(E, E))
        self.weights_pred = nn.Sequential(nn.Linear(E, E), nn.ReLU(),
                                          nn.Linear(E, ns))

    def forward(self, masks, value):
        """masks (B, N, H0, W0) in [0, 1]; value (B, N, value_dim, h, w).
        Returns summaries (B, N, num_summaries, embed_dim + 1)."""
        cfg = self.config
        h, w = value.shape[-2:]
        m = avg_pool_area(masks, masks.shape[2] // h)[..., None]
        ns = cfg.ot_num_queries
        repeated = torch.cat([m.expand(-1, -1, -1, -1, ns // 2),
                              (1 - m).expand(-1, -1, -1, -1, ns // 2)], -1)
        v = self.input_proj(value.permute(0, 1, 3, 4, 2))
        v = v + _pe(h, w, cfg, v.device)
        f = self.feature_pred(v)
        weights = torch.sigmoid(self.weights_pred(v)) * repeated
        wf = weights.flatten(2, 3)                    # (B, N, hw, ns)
        sums = torch.matmul(wf.transpose(-1, -2), f.flatten(2, 3))
        area = wf.sum(dim=2)[..., None]
        return torch.cat([sums, area], dim=-1)


def aggregate(prob, dim: int):
    """Soft-aggregation logits: the background as the product of the
    complements, each channel clipped to [1e-7, 1 - 1e-7]."""
    bg = torch.prod(1 - prob, dim=dim, keepdim=True)
    new_prob = torch.cat([bg, prob], dim).clamp(1e-7, 1 - 1e-7)
    return torch.log(new_prob / (1 - new_prob))


class QueryTransformerBlock(nn.Module):
    def __init__(self, config: CutieConfig):
        super().__init__()
        E, nh = config.embed_dim, config.ot_num_heads
        self.read_from_pixel = CrossAttention(E, nh)
        self.self_attn = SelfAttention(E, nh)
        self.ffn = FFN(E, config.ot_ff_dim)
        self.read_from_query = CrossAttention(E, nh, norm=False)
        self.pixel_ffn = PixelFFN(E)

    def forward(self, x, pixel, query_pe, pixel_pe, attn_mask):
        pixel_flat = pixel.flatten(3, 4).flatten(0, 1).transpose(1, 2)
        x = self.read_from_pixel(x, pixel_flat, query_pe, pixel_pe,
                                 attn_mask)
        x = self.ffn(self.self_attn(x, query_pe))
        pixel_flat = self.read_from_query(pixel_flat, x, pixel_pe, query_pe)
        return x, self.pixel_ffn(pixel, pixel_flat)


class QueryTransformer(nn.Module):
    def __init__(self, config: CutieConfig):
        super().__init__()
        self.config = config
        E, Q = config.embed_dim, config.ot_num_queries
        self.query_init = nn.Embedding(Q, E)
        self.query_emb = nn.Embedding(Q, E)
        self.summary_to_query_init = nn.Linear(E, E)
        self.summary_to_query_emb = nn.Linear(E, E)
        self.pixel_init_proj = conv2d(E, E, 1)
        self.pixel_emb_proj = conv2d(E, E, 1)
        self.blocks = nn.ModuleList(QueryTransformerBlock(config)
                                    for _ in range(config.ot_num_blocks))
        self.mask_pred = nn.ModuleList(
            nn.Sequential(nn.ReLU(), conv2d(E, 1, 1))
            for _ in range(config.ot_num_blocks + 1))

    def forward(self, pixel, obj_summaries, selector=None):
        """pixel (B, N, E, H, W); obj_summaries (B, N, T, Q, E + 1).
        Returns (pixel', aux logits list)."""
        cfg = self.config
        B, N, E, H, W = pixel.shape
        Q = cfg.ot_num_queries
        obj = obj_summaries.reshape(B * N, -1, Q, E + 1)
        obj_values = obj[..., :-1].sum(dim=1) / (obj[..., -1:].sum(dim=1)
                                                 + 1e-4)
        query = self.query_init.weight[None] + self.summary_to_query_init(
            obj_values)
        query_emb = self.query_emb.weight[None] + self.summary_to_query_emb(
            obj_values)

        pf = _fold(pixel)
        pixel = _unfold(self.pixel_init_proj(pf), pixel)
        pe = _pe(H, W, cfg, pf.device).permute(2, 0, 1)
        pixel_pe = (pe[None] + self.pixel_emb_proj(pf)).flatten(2).transpose(
            1, 2)

        aux_logits = []

        def mask_pred(p, i):
            return _unfold(self.mask_pred[i](_fold(p)), p)[:, :, 0]

        lg = mask_pred(pixel, 0)
        aux_logits.append(lg)
        attn_mask = self._aux_mask(lg, selector)
        for i, block in enumerate(self.blocks):
            query, pixel = block(query, pixel, query_emb, pixel_pe,
                                 attn_mask)
            lg = mask_pred(pixel, i + 1)
            aux_logits.append(lg)
            attn_mask = self._aux_mask(lg, selector)
        return pixel, aux_logits

    def _aux_mask(self, logits, selector):
        """The queries' attention mask from the aux logits, True = blocked:
        the first half of the queries see only each object's foreground
        (its aggregated logit >= the max over objects and background), the
        second half only the rest; fully blocked rows are unblocked."""
        cfg = self.config
        B, N, H, W = logits.shape
        prob = torch.sigmoid(logits)
        if selector is not None:
            prob = prob * selector
        agg = aggregate(prob, dim=1)
        fg = (agg[:, 1:] >= agg.max(dim=1, keepdim=True).values).view(
            B, N, 1, 1, H * W)
        shape = (B, N, cfg.ot_num_heads, cfg.ot_num_queries // 2, H * W)
        mask = torch.cat([(~fg).expand(shape), fg.expand(shape)], dim=3)
        mask = mask & ~mask.all(dim=-1, keepdim=True)
        return mask.reshape(B * N * cfg.ot_num_heads, cfg.ot_num_queries,
                            H * W)


class _DecoderFeatureProcessor(nn.Module):
    def __init__(self, decoder_dims, final_dims):
        super().__init__()
        self.transforms = nn.ModuleList(
            conv2d(d, p, 1) for d, p in zip(decoder_dims, final_dims))


class MaskUpsampleBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.out_conv = GroupResBlock(in_dim, out_dim)

    def forward(self, in_g, skip_f):
        return self.out_conv(upsample_groups(in_g, 2) + skip_f[:, None])


class MaskDecoder(nn.Module):
    def __init__(self, config: CutieConfig):
        super().__init__()
        up = config.up_dims
        self.decoder_feat_proc = _DecoderFeatureProcessor(
            config.ms_dims[1:], up[:-1])
        self.up_16_8 = MaskUpsampleBlock(up[0], up[1])
        self.up_8_4 = MaskUpsampleBlock(up[1], up[2])
        self.pred = conv2d(up[-1], 1, 3, 1, 1)
        self.sensory_update = SensoryUpdater(
            (up[0], up[1], up[2] + 1), config.sensory_dim,
            config.sensory_dim)

    def forward(self, f16, f8, f4, memory_readout, sensory,
                update_sensory: bool = True):
        t8, t4 = self.decoder_feat_proc.transforms
        p16 = memory_readout
        p8 = self.up_16_8(p16, t8(f8))
        p4 = self.up_8_4(p8, t4(f4))
        logits = _unfold(self.pred(F.relu(_fold(p4))), p4)
        if update_sensory:
            sensory = self.sensory_update(
                p16, p8, torch.cat([p4, logits], dim=2), sensory)
        return sensory, logits[:, :, 0]


# ---------------------------------------------------------------------------
# Memory math
# ---------------------------------------------------------------------------


def get_similarity(mk, ms, qk, qe):
    """Anisotropic L2 similarity.

    mk (B, Ck, N); ms (B, 1, N) or None; qk (B, Ck, P); qe (B, Ck, P) or
    None. Returns (B, N, P)."""
    CK = mk.shape[1]
    mk_t = mk.transpose(1, 2)
    if qe is not None:
        a_sq = torch.matmul(mk_t ** 2, qe)
        two_ab = 2 * torch.matmul(mk_t, qk * qe)
        b_sq = (qe * qk ** 2).sum(dim=1, keepdim=True)
        similarity = -a_sq + two_ab - b_sq
    else:
        a_sq = (mk ** 2).sum(dim=1)[..., None]
        similarity = -a_sq + 2 * torch.matmul(mk_t, qk)
    if ms is not None:
        return similarity * ms.transpose(1, 2) / math.sqrt(CK)
    return similarity / math.sqrt(CK)


def topk_softmax(similarity, top_k: Optional[int]):
    """Softmax over the memory-token axis (dim 1) of each pixel's top_k
    similarities, the rest 0; the top value is subtracted before exp."""
    if top_k is None:
        return torch.softmax(similarity, dim=1)
    k = min(top_k, similarity.shape[1])
    values, indices = torch.topk(similarity.transpose(1, 2), k, dim=-1)
    x_exp = torch.exp(values - values[..., :1])
    x_exp = x_exp / x_exp.sum(dim=-1, keepdim=True)
    aff = torch.zeros_like(similarity.transpose(1, 2)).scatter_(
        -1, indices, x_exp)
    return aff.transpose(1, 2)


def readout(affinity, mv):
    """affinity (B, N, P); mv (B, N_obj, C, N) -> (B, N_obj, C, P)."""
    B, O, C, N = mv.shape
    return torch.matmul(mv.reshape(B, O * C, N), affinity).view(B, O, C, -1)


# ---------------------------------------------------------------------------
# Top-level CUTIE
# ---------------------------------------------------------------------------


class CUTIE(nn.Module):
    """Cutie's inference methods; the memory that feeds them is
    demo/cutie_core.py's."""

    def __init__(self, config: CutieConfig = CutieConfig()):
        super().__init__()
        self.config = config
        self.pixel_encoder = PixelEncoder(config)
        self.pix_feat_proj = conv2d(config.ms_dims[0], config.pixel_dim, 1)
        self.key_proj = KeyProjection(config)
        self.mask_encoder = MaskEncoder(config)
        self.mask_decoder = MaskDecoder(config)
        self.pixel_fuser = PixelFeatureFuser(config)
        self.object_transformer = QueryTransformer(config)
        self.object_summarizer = ObjectSummarizer(config)

    def _normalize(self, image):
        mean = torch.tensor(self.config.pixel_mean, device=image.device)
        std = torch.tensor(self.config.pixel_std, device=image.device)
        return (image - mean[:, None, None]) / std[:, None, None]

    def encode_image(self, image):
        """image (B, 3, H, W) in [0, 1] -> ((f16, f8, f4), pix_feat)."""
        f16, f8, f4 = self.pixel_encoder(self._normalize(image))
        return (f16, f8, f4), self.pix_feat_proj(f16)

    def transform_key(self, f16, need_s: bool = True, need_e: bool = True):
        return self.key_proj(f16, need_s, need_e)

    def encode_mask(self, image, pix_feat, sensory, masks,
                    deep_update: bool = True):
        """masks (B, N, H, W) in [0, 1]. Returns (value (B, N, Cv, h, w),
        new sensory, object summaries (B, N, Q, E + 1))."""
        image = self._normalize(image)
        others = (masks.sum(dim=1, keepdim=True) - masks).clamp(0, 1)
        value, new_sensory = self.mask_encoder(
            image, pix_feat, sensory, masks, others, deep_update=deep_update)
        return value, new_sensory, self.object_summarizer(masks, value)

    def read_first(self, pix_feat, visual_readout, sensory, last_mask,
                   obj_memory):
        """Pixel fusion and the object transformer's readout.
        visual_readout (B, N, Cv, h, w); last_mask (B, N, H, W) full
        resolution; obj_memory (B, N, 1, Q, E + 1)."""
        lm = avg_pool_area(last_mask, last_mask.shape[2] // sensory.shape[3])
        last_others = (lm.sum(dim=1, keepdim=True) - lm).clamp(0, 1)
        pixel_readout = self.pixel_fuser(pix_feat, visual_readout, sensory,
                                         lm, last_others)
        return self.object_transformer(pixel_readout, obj_memory)[0]

    def segment(self, f16, f8, f4, memory_readout, sensory,
                update_sensory: bool = True):
        """Returns (new sensory, prob with background (B, N+1, H, W))."""
        sensory, logits = self.mask_decoder(
            f16, f8, f4, memory_readout, sensory,
            update_sensory=update_sensory)
        agg = aggregate(torch.sigmoid(logits), dim=1)
        h4, w4 = agg.shape[-2:]
        return sensory, torch.softmax(_bilinear(agg, (h4 * 4, w4 * 4)),
                                      dim=1)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

# released keys with no parameter here (the JAX converter's skip list):
# the predictor's normalisation buffers, the training-only aux heads and
# the positional encodings' buffers (recomputed)
CUTIE_SKIP = (r"pixel_mean", r"pixel_std", r"aux_computer", r"\.inv_freq$",
              r"cached_penc")


def load_cutie_state_dict(path: str,
                          config: CutieConfig | None = None) -> dict:
    """A released cutie-base-mega.pth (or any file of its keys) without the
    keys `CUTIE_SKIP` names, checked by loading it with strict=True into a
    `CUTIE` of `config` built on the meta device. Returns the state dict on
    the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    sd = {k: v for k, v in sd.items()
          if not any(re.search(p, k) for p in CUTIE_SKIP)}
    with torch.device("meta"):
        model = CUTIE(config or CutieConfig())
    model.load_state_dict(sd, strict=True, assign=True)
    return sd
