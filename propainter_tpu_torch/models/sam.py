"""Segment Anything (SAM): promptable image segmentation, the demo's
first-frame segmenter. Counterpart of `propainter_tpu/models/sam.py`.

Three parts, as the published architecture has them (vit_b / vit_l /
vit_h):

  * `ImageEncoderViT`: a 16x16 patch ViT with 14x14 windowed attention,
    decomposed relative position biases, global attention at four depths,
    and a two-conv LayerNorm neck to 256 channels;
  * `PromptEncoder`: random-Fourier point and box-corner embeddings, and a
    small conv stack for dense mask prompts;
  * `MaskDecoder`: a two-way (token <-> image) transformer, hypernetwork
    mask heads over a 4x upscaled embedding, and an IoU head.

Children keep the released names (`image_encoder.blocks.N.attn.qkv`,
`prompt_encoder.pe_layer.positional_encoding_gaussian_matrix`,
`mask_decoder.output_upscaling.0`, ...), so `state_dict()` keys are those
of sam_vit_{b,l,h}_*.pth and `load_sam_state_dict` loads one with
strict=True. Images are NCHW at the patch conv and the neck; inside the ViT
tokens are (B, H, W, C), as in the release. Every product is a
`torch.matmul` / `nn.Linear` / convolution and every softmax is fp32: SAM
calls no kernel of `ops/`.

Prompts follow the JAX package: labels 1 foreground, 0 background, -1 "not
a point" (padding), 2 / 3 box corners; coordinates are pixels of the
model's `img_size` frame, shifted by +0.5 to pixel centres here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """Architecture hyperparameters (segment_anything/build_sam.py)."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    img_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    mlp_ratio: float = 4.0
    out_chans: int = 256           # prompt/decoder embedding dim
    mask_in_chans: int = 16
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @staticmethod
    def vit_b() -> "SamConfig":
        return SamConfig()

    @staticmethod
    def vit_l() -> "SamConfig":
        return SamConfig(embed_dim=1024, depth=24, num_heads=16,
                         global_attn_indexes=(5, 11, 17, 23))

    @staticmethod
    def vit_h() -> "SamConfig":
        return SamConfig(embed_dim=1280, depth=32, num_heads=16,
                         global_attn_indexes=(7, 15, 23, 31))


sam_config_registry = {
    "vit_b": SamConfig.vit_b,
    "vit_l": SamConfig.vit_l,
    "vit_h": SamConfig.vit_h,
}

# SamPredictor preprocessing constants (segment_anything/modeling/sam.py)
SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map: eps 1e-6, biased
    variance."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    """lin1 -> act -> lin2: exact-erf GELU in the ViT, ReLU in the
    two-way transformer."""

    def __init__(self, dim: int, mlp_dim: int, act: str = "gelu"):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = F.gelu if act == "gelu" else F.relu

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------


def _rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, d) relative position table: [i, j] -> row (i - j) +
    size - 1 of `rel_pos`, linearly resized first (align_corners) if it
    was stored for another extent than 2 * size - 1 rows."""
    need = 2 * size - 1
    if rel_pos.shape[0] != need:
        src = rel_pos.shape[0]
        pos = torch.linspace(0.0, src - 1.0, need, device=rel_pos.device)
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=src - 1)
        w = (pos - lo).to(rel_pos.dtype)[:, None]
        rel_pos = rel_pos[lo] * (1 - w) + rel_pos[hi] * w
    idx = (torch.arange(size, device=rel_pos.device)[:, None]
           - torch.arange(size, device=rel_pos.device)[None, :] + size - 1)
    return rel_pos[idx]


class ViTAttention(nn.Module):
    """Multi-head attention over (B, H, W, C) tokens with decomposed
    relative position biases (image_encoder.py Attention +
    add_decomposed_rel_pos)."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1,
                                                  head_dim))

    def forward(self, x):
        B, H, W, C = x.shape
        nh = self.num_heads
        d = C // nh
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                          # (B, nh, N, d)
        attn = (q @ k.transpose(-2, -1)) * self.scale    # (B, nh, N, N)
        r_q = q.reshape(B, nh, H, W, d)
        rel_h = torch.einsum("bnhwd,hkd->bnhwk", r_q,
                             _rel_pos_table(self.rel_pos_h, H))
        rel_w = torch.einsum("bnhwd,wkd->bnhwk", r_q,
                             _rel_pos_table(self.rel_pos_w, W))
        biased = attn.view(B, nh, H, W, H, W)
        biased += rel_h[..., :, None]
        biased += rel_w[..., None, :]
        attn = attn.softmax(dim=-1)
        out = (attn @ v).view(B, nh, H, W, d).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(B, H, W, C))


def _window_partition(x, ws: int):
    """(B, H, W, C) -> (B * nW, ws, ws, C), H and W zero-padded up to
    multiples of ws. Returns (windows, padded (Hp, Wp))."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def _window_unpartition(wins, ws: int, padded, hw):
    Hp, Wp = padded
    H, W = hw
    B = wins.shape[0] // ((Hp // ws) * (Wp // ws))
    x = wins.view(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class ViTBlock(nn.Module):
    """Pre-norm transformer block, windowed (window_size > 0) or global."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, input_size: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, num_heads,
                                 window_size if window_size else input_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size:
            H, W = x.shape[1:3]
            x, padded = _window_partition(x, self.window_size)
            x = _window_unpartition(self.attn(x), self.window_size, padded,
                                    (H, W))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)

    def forward(self, x):
        """(B, 3, S, S) -> (B, S/p, S/p, C) tokens."""
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """(B, 3, img_size, img_size), normalized -> (B, out_chans, grid,
    grid)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg.embed_dim, cfg.patch_size)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim))
        self.blocks = nn.ModuleList([
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                     0 if i in cfg.global_attn_indexes else cfg.window_size,
                     cfg.grid)
            for i in range(cfg.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, cfg.out_chans, 1, bias=False),
            LayerNorm2d(cfg.out_chans),
            nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1,
                      bias=False),
            LayerNorm2d(cfg.out_chans))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2]]
        for block in self.blocks:
            x = block(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding of [0, 1] coordinates."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def pe(self, coords01):
        """(..., 2) [0, 1] xy -> (..., 2 * num_pos_feats)."""
        c = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    """Point / box-corner / mask prompts -> sparse tokens (B, N, C) and a
    dense map (B, C, grid, grid)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.config = cfg
        C, m = cfg.out_chans, cfg.mask_in_chans
        self.pe_layer = PositionEmbeddingRandom(C // 2)
        # 0: negative point, 1: positive point, 2 / 3: box corners
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, C) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, C)
        self.no_mask_embed = nn.Embedding(1, C)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, m // 4, kernel_size=2, stride=2),
            LayerNorm2d(m // 4), nn.GELU(),
            nn.Conv2d(m // 4, m, kernel_size=2, stride=2),
            LayerNorm2d(m), nn.GELU(),
            nn.Conv2d(m, C, kernel_size=1))

    def dense_pe(self):
        """(1, C, grid, grid) positional map of the image embedding."""
        g = self.config.grid
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        t = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        grid = torch.stack([t[None, :].expand(g, g), t[:, None].expand(g, g)],
                           dim=-1)                      # (g, g, [x, y])
        return self.pe_layer.pe(grid).permute(2, 0, 1)[None]

    def embed_points(self, coords, labels):
        """coords (B, N, 2) pixel xy in the model frame, labels (B, N) ->
        (B, N, C): the point's encoding plus its label's embedding; label
        -1 gives the not-a-point embedding alone."""
        pe = self.pe_layer.pe((coords + 0.5) / float(self.config.img_size))
        lab = labels[..., None]
        out = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for i, emb in enumerate(self.point_embeddings):
            out = out + torch.where(lab == i, emb.weight[0], 0.0)
        return out

    def embed_masks(self, masks):
        """(B, 1, 4 grid, 4 grid) mask logits -> (B, C, grid, grid)."""
        return self.mask_downscaling(masks)

    def forward(self, coords, labels, mask_input=None):
        sparse = self.embed_points(coords, labels)
        if mask_input is None:
            g = self.config.grid
            dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
                coords.shape[0], -1, g, g)
        else:
            dense = self.embed_masks(mask_input)
        return sparse, dense


# ---------------------------------------------------------------------------
# mask decoder (two-way transformer)
# ---------------------------------------------------------------------------


class DecoderAttention(nn.Module):
    """Multi-head attention with the inner width cut by downsample_rate
    (transformer.py Attention)."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _heads(self, x):
        B, N, C = x.shape
        return x.reshape(B, N, self.num_heads, C // self.num_heads
                         ).transpose(1, 2)

    def forward(self, q, k, v):
        q = self._heads(self.q_proj(q))
        k = self._heads(self.k_proj(k))
        v = self._heads(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = (attn.softmax(dim=-1) @ v).transpose(1, 2).flatten(2)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, mlp_dim, act="relu")
        self.norm3 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2)
        self.norm4 = nn.LayerNorm(dim)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(dim, num_heads, mlp_dim, i == 0)
            for i in range(depth)])
        self.final_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, C, H, W), point_embedding (B, N,
        C) -> (queries (B, N, C), keys (B, H * W, C))."""
        keys = image_embedding.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class HyperMLP(nn.Module):
    """ReLU MLP (mask_decoder.py MLP)."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 num_layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(
            [nn.Linear(dims[i], dims[i + 1]) for i in range(num_layers)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        C = cfg.out_chans
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.transformer = TwoWayTransformer(
            cfg.decoder_depth, C, cfg.decoder_num_heads, cfg.decoder_mlp_dim)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, C)
        # kernel 2 stride 2: no overlap, weight (I, O, 2, 2) as released
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, kernel_size=2, stride=2),
            LayerNorm2d(C // 4), nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, kernel_size=2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [HyperMLP(C, C, C // 8) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = HyperMLP(C, C, self.num_mask_tokens)

    def forward(self, image_embeddings, image_pe, sparse, dense):
        """image_embeddings (1 or B, C, g, g), image_pe (1, C, g, g),
        sparse (B, N, C), dense (B, C, g, g) -> (masks (B, 4, 4g, 4g),
        iou_pred (B, 4)): all four masks; the caller slices multimask
        [1:] or single [0:1]."""
        nm = self.num_mask_tokens
        B = sparse.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(B, -1, -1), sparse],
                           dim=1)
        src = image_embeddings.expand(B, -1, -1, -1) + dense
        pos = image_pe.expand(B, -1, -1, -1)
        hs, src = self.transformer(src, pos, tokens)
        g = image_embeddings.shape[-1]
        upscaled = self.output_upscaling(
            src.transpose(1, 2).reshape(B, -1, g, g))     # (B, C/8, 4g, 4g)
        hyper_in = torch.stack(
            [mlp(hs[:, 1 + i]) for i, mlp in
             enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = upscaled.shape
        masks = (hyper_in @ upscaled.reshape(b, c, h * w)).reshape(b, nm, h,
                                                                   w)
        return masks, self.iou_prediction_head(hs[:, 0])


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


class Sam(nn.Module):
    """Full SAM; `encode_image` once per image, `decode` per prompt."""

    def __init__(self, config: SamConfig = SamConfig.vit_b()):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoderViT(config)
        self.prompt_encoder = PromptEncoder(config)
        self.mask_decoder = MaskDecoder(config)

    def encode_image(self, x):
        """x (B, 3, img_size, img_size), mean/std-normalized."""
        return self.image_encoder(x)

    def decode(self, image_embeddings, coords, labels, mask_input=None):
        """coords (B, N, 2) xy in the model frame, labels (B, N) in {-1, 0,
        1, 2, 3}, mask_input optional (B, 1, 4g, 4g) logits ->
        (low_res_masks (B, 4, 4g, 4g), iou_pred (B, 4))."""
        sparse, dense = self.prompt_encoder(coords, labels, mask_input)
        return self.mask_decoder(image_embeddings,
                                 self.prompt_encoder.dense_pe(), sparse,
                                 dense)

    def forward(self, x, coords, labels, mask_input=None):
        return self.decode(self.encode_image(x), coords, labels, mask_input)


def load_sam_state_dict(path: str, model_type: str = "vit_h",
                        config: SamConfig | None = None) -> dict:
    """A released sam_vit_{b,l,h}_*.pth (or any file of its keys), checked
    by loading it with strict=True into a `Sam` of `model_type` (or
    `config`), built on the meta device. The predictor's `pixel_mean` /
    `pixel_std`, where a file has them, are dropped: `SamSegmenter`
    normalizes with `SAM_PIXEL_MEAN` / `SAM_PIXEL_STD`. Returns the state
    dict on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if k not in ("pixel_mean", "pixel_std")}
    with torch.device("meta"):
        model = Sam(config or sam_config_registry[model_type]())
    model.load_state_dict(sd, strict=True, assign=True)
    return sd
