"""ProPainter inpainting generator in plain PyTorch, NCHW inside;
`state_dict()` keys are ProPainter.pth's. Inference only.

Tokens between SoftSplit and SoftComp are channel-last, (B, T, h, w, C).
The sparse window attention computes, as the reference
sparse_transformer.py does, branch A (a window holding a hole token
attends over the selected frames' window, rolled-band and pooled tokens)
for the dirty windows only, and branch B (within window, same frame) for
the rest.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .flash_attention import NEG_INF, flash_window_attention
from .interp import max_pool2d, resize
from .layers import Deconv, GemmConv2d, SplitGroupConv2d, conv2d, deform_align
from .warp import (fb_consistency_from_warped, flow_warp_bilinear_nearest,
                   flow_warp_nchw)

KERNEL = (7, 7)
STRIDE = (3, 3)
PADDING = (3, 3)


def unfold_output_size(size: int, kernel: int, stride: int,
                       padding: int) -> int:
    return (size + 2 * padding - (kernel - 1) - 1) // stride + 1


def binary_mask(mask, th: float = 0.1):
    return (mask > th).to(mask.dtype)


# ---------------------------------------------------------------------------
# Encoder / decoder
# ---------------------------------------------------------------------------


class Encoder(nn.Module):
    """Stride-4 encoder whose last four convs are grouped over the
    interleaved concat of the stage-8 features and the running output.
    Reference model/propainter.py:193-232."""

    def __init__(self):
        super().__init__()
        self.layers = nn.Sequential(
            conv2d(5, 64, 3, 2, 1), nn.LeakyReLU(0.2, inplace=True),
            conv2d(64, 64, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            conv2d(64, 128, 3, 2, 1), nn.LeakyReLU(0.2, inplace=True),
            conv2d(128, 256, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            conv2d(256, 384, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            SplitGroupConv2d(640, 512, 2), nn.LeakyReLU(0.2, inplace=True),
            SplitGroupConv2d(768, 384, 4), nn.LeakyReLU(0.2, inplace=True),
            SplitGroupConv2d(640, 256, 8), nn.LeakyReLU(0.2, inplace=True),
            SplitGroupConv2d(512, 128, 1), nn.LeakyReLU(0.2, inplace=True))

    def forward(self, x):
        out = x
        x0 = None
        for i, layer in enumerate(self.layers):
            if i == 8:
                x0 = out
            if isinstance(layer, SplitGroupConv2d):
                g = layer.groups
                out = layer([torch.cat(pair, dim=1) for pair in
                             zip(x0.chunk(g, dim=1), out.chunk(g, dim=1))])
            else:
                out = layer(out)
        return out


# ---------------------------------------------------------------------------
# Soft split / soft comp tokenizers
# ---------------------------------------------------------------------------


class SoftSplit(nn.Module):
    """Overlapping 7x7 / stride-3 patches -> Linear. Reference
    sparse_transformer.py:7-31. The Linear over unfolded patches is one
    strided conv with the Linear's weight (the im2col identity)."""

    def __init__(self, channel: int = 128, hidden: int = 512):
        super().__init__()
        self.channel = channel
        self.embedding = nn.Linear(channel * KERNEL[0] * KERNEL[1], hidden)

    def forward(self, x, b: int):
        """x (B*T, C, h, w) -> tokens (b, T, fh, fw, hidden)."""
        w = self.embedding.weight.view(-1, self.channel, *KERNEL)
        y = F.conv2d(x, w, self.embedding.bias, STRIDE, PADDING)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(b, -1, *y.shape[1:])


class SoftComp(nn.Module):
    """Linear -> fold (overlapping taps summed) -> 3x3 conv. Reference
    sparse_transformer.py:34-61."""

    def __init__(self, channel: int = 128, hidden: int = 512):
        super().__init__()
        self.embedding = nn.Linear(hidden, channel * KERNEL[0] * KERNEL[1])
        self.bias_conv = conv2d(channel, channel, 3, 1, 1)

    def forward(self, x, output_size):
        """tokens (b, t, fh, fw, hidden) -> (b*t, C, h, w)."""
        feat = self.embedding(x.flatten(0, 1).flatten(1, 2))
        feat = F.fold(feat.transpose(1, 2), output_size, KERNEL,
                      padding=PADDING, stride=STRIDE)
        return self.bias_conv(feat)


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


class FusionFeedForward(nn.Module):
    """fc1 -> fold / coverage -> unfold -> GELU -> fc2. Reference
    sparse_transformer.py:64-101."""

    def __init__(self, dim: int = 512, hidden_dim: int = 1960):
        super().__init__()
        self.fc1 = nn.Sequential(nn.Linear(dim, hidden_dim))
        self.fc2 = nn.Sequential(nn.GELU(), nn.Linear(hidden_dim, dim))

    def forward(self, x, output_size):
        """x (b, n, dim) with n = T * fh * fw tokens."""
        fh = unfold_output_size(output_size[0], KERNEL[0], STRIDE[0],
                                PADDING[0])
        fw = unfold_output_size(output_size[1], KERNEL[1], STRIDE[1],
                                PADDING[1])
        x = self.fc1(x)
        b, n, c = x.shape
        frames = x.reshape(-1, fh * fw, c).transpose(1, 2)
        ones = x.new_ones(1, c, fh * fw)
        cover = F.fold(ones, output_size, KERNEL, padding=PADDING,
                       stride=STRIDE)
        folded = F.fold(frames, output_size, KERNEL, padding=PADDING,
                        stride=STRIDE)
        x = F.unfold(folded / cover, KERNEL, padding=PADDING, stride=STRIDE)
        x = x.transpose(1, 2).reshape(b, n, c)
        return self.fc2(x)


def _valid_rolled_indices(window, expand) -> np.ndarray:
    """Indices of rolled-window tokens outside the centre window.
    Reference sparse_transformer.py:142-153."""
    eh, ew = expand
    ms = []
    for rows, cols in ((slice(None, -eh), slice(None, -ew)),
                       (slice(None, -eh), slice(ew, None)),
                       (slice(eh, None), slice(None, -ew)),
                       (slice(eh, None), slice(ew, None))):
        m = np.ones(window, np.bool_)
        m[rows, cols] = False
        ms.append(m)
    return np.nonzero(np.stack(ms, 0).reshape(-1))[0]


def _window_gather_indices(nwh, nww, window, expand, valid_idx) -> np.ndarray:
    """(nW, win + n_valid_rolled) flat-grid indices: each window's centre
    tokens, then the valid band of its four rolled (wrap-around) copies."""
    wh, ww = window
    H, W = nwh * wh, nww * ww
    eh, ew = expand
    shifts = [(-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)]
    a = np.arange(wh)[:, None]
    b = np.arange(ww)[None, :]
    idx = []
    for wi in range(nwh):
        for wj in range(nww):
            center = ((wi * wh + a) * W + (wj * ww + b)).reshape(-1)
            rolled = np.concatenate([
                (((wi * wh + a - sy) % H) * W + (wj * ww + b - sx) % W
                 ).reshape(-1) for sy, sx in shifts])[valid_idx]
            idx.append(np.concatenate([center, rolled]))
    return np.asarray(idx, np.int64)


def _frame_selection(static_sel, device):
    """A block's temporal dilation (`static_sel`, a (T,) bool array) as
    frame indices on `device`."""
    return torch.as_tensor(np.nonzero(static_sel)[0], device=device)


def token_masks(masks):
    """(B, l_t, h, w, 1) masks on the encoder's feature grid -> (B, l_t,
    h', w', 1) on the transformer's token grid (the soft split's max
    pool)."""
    B, l_t, h, w, _ = masks.shape
    pooled = max_pool2d(masks.reshape(B * l_t, h, w, 1), KERNEL, STRIDE,
                        PADDING)
    return pooled.reshape(B, l_t, *pooled.shape[1:])


def window_occupancy(mask, window_size):
    """(B, l_t, H, W, 1) token-grid masks of the local frames -> (B, nW)
    occupancy: each window's max summed over the frames (> 0 = dirty),
    on the grid zero-padded to whole windows."""
    B, l_t, H, W, _ = mask.shape
    wh, ww = window_size
    pad_b, pad_r = (-H) % wh, (-W) % ww
    if pad_b or pad_r:
        mask = F.pad(mask, (0, 0, 0, pad_r, 0, pad_b))
    mp = max_pool2d(mask.reshape(B * l_t, H + pad_b, W + pad_r, 1),
                    window_size, window_size)
    return mp.reshape(B, l_t, -1).sum(dim=1)


class SparseWindowAttention(nn.Module):
    """Mask-guided sparse window attention. Reference
    sparse_transformer.py:117-281: a window with a hole token in any local
    frame (its occupancy > 0) attends over the selected frames' window,
    the valid band of its four rolled copies and the pooled tokens (branch
    A); any other window attends within itself and its frame (branch
    B)."""

    def __init__(self, dim: int = 512, n_head: int = 4,
                 window_size=(5, 9), pool_size=(4, 4)):
        super().__init__()
        self.n_head = n_head
        self.window_size = tuple(window_size)
        self.key = nn.Linear(dim, dim)
        self.query = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.pool_layer = nn.Conv2d(dim, dim, pool_size, pool_size, 0,
                                    groups=dim)
        self.expand = ((window_size[0] + 1) // 2, (window_size[1] + 1) // 2)
        self._valid_idx = _valid_rolled_indices(self.window_size, self.expand)
        self.register_buffer("valid_ind_rolled",
                             torch.as_tensor(self._valid_idx))

    def forward(self, x, mask, static_sel, frame_valid=None,
                q_frames: int | None = None):
        """x (B, T, H, W, C) tokens; mask (B, l_t, H, W, 1) pooled local
        masks; static_sel (T,) numpy bool: frames visible to branch A;
        frame_valid (T,) or (B, T) bool or None: False masks padded
        reference frames' keys; q_frames: the queries of only the first
        q_frames frames (keys and values from all T)."""
        B, T, H, W, C = x.shape
        Tq = T if q_frames is None else q_frames
        wh, ww = self.window_size
        nh = self.n_head
        ch = C // nh
        nwh, nww = math.ceil(H / wh), math.ceil(W / ww)
        new_h, new_w = nwh * wh, nww * ww
        pad_b, pad_r = new_h - H, new_w - W
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))

        q, k, v = self.query(x[:, :Tq]), self.key(x), self.value(x)
        pool_x = self.pool_layer(
            x.reshape(B * T, new_h, new_w, C).permute(0, 3, 1, 2))
        p_h, p_w = pool_x.shape[2:]
        pool_x = pool_x.permute(0, 2, 3, 1).reshape(B, T, p_h * p_w, C)
        pool_k, pool_v = self.key(pool_x), self.value(pool_x)

        occ = window_occupancy(mask, self.window_size)          # (B, nW)
        out = self._windows(q, k, v, pool_k, pool_v, occ, static_sel,
                            frame_valid)
        out = out.reshape(B, nwh, nww, nh, Tq, wh, ww, ch)
        out = out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, Tq, new_h,
                                                          new_w, C)
        if pad_b or pad_r:
            out = out[:, :, :H, :W]
        return self.proj(out)

    def _windows(self, q, k, v, pool_k, pool_v, occ, static_sel,
                 frame_valid):
        """Branch B for every window, then branch A for each batch row's
        dirty windows over it -> (B, nW, head, Tq, win, ch)."""
        B, Tq, new_h, new_w, C = q.shape
        T = k.shape[1]
        wh, ww = self.window_size
        nh = self.n_head
        ch = C // nh
        nwh, nww = new_h // wh, new_w // ww
        win, P = wh * ww, pool_k.shape[2]
        idx_all = torch.as_tensor(_window_gather_indices(
            nwh, nww, self.window_size, self.expand, self._valid_idx),
            device=q.device)
        idx_q = idx_all[:, :win]
        n_idx = idx_all.shape[1]

        def gather_windows(t, idx):
            """(B, T', H', W', C) -> (B, nW, head, T', n_idx, ch)."""
            tf = t.reshape(B, t.shape[1], new_h * new_w, C)
            g = tf.index_select(2, idx.reshape(-1))
            g = g.reshape(B, t.shape[1], idx.shape[0], idx.shape[1], nh, ch)
            return g.permute(0, 2, 4, 1, 3, 5)

        win_q = gather_windows(q, idx_q)
        scale = 1.0 / math.sqrt(ch)
        # branch B: within window, same frame
        att_b = torch.softmax(
            win_q @ gather_windows(k[:, :Tq], idx_q).transpose(-1, -2)
            * scale, dim=-1)
        out = att_b @ gather_windows(v[:, :Tq], idx_q)

        sel = _frame_selection(static_sel, q.device)
        Ts = sel.numel()
        for b in range(B):
            dirty = torch.nonzero(occ[b] > 0).flatten()
            if dirty.numel() == 0:
                continue
            nWa = dirty.numel()
            rows = idx_all[dirty].reshape(-1)

            def gather_a(t):
                g = t[b].index_select(0, sel).reshape(Ts, new_h * new_w, C)
                g = g[:, rows].reshape(Ts, nWa, n_idx, nh, ch)
                return g.permute(1, 3, 0, 2, 4)   # (nWa, head, Ts, n_idx, ch)

            def pool_windows(p):
                p = p[b].index_select(0, sel).reshape(Ts, P, nh, ch)
                return p.permute(2, 0, 1, 3)[None].expand(nWa, nh, Ts, P, ch)

            k_all = torch.cat([gather_a(k), pool_windows(pool_k)], dim=3)
            v_all = torch.cat([gather_a(v), pool_windows(pool_v)], dim=3)
            k_tok = k_all.shape[3]
            bias = None
            if frame_valid is not None:
                fv = frame_valid.to(q.device).expand(B, T)[b].index_select(
                    0, sel)
                bias = torch.where(fv, 0.0, NEG_INF).to(torch.float32)
                bias = bias.repeat_interleave(k_tok)[None]
            out_a = flash_window_attention(
                win_q[b, dirty].reshape(1, nWa * nh, Tq * win, ch),
                k_all.reshape(1, nWa * nh, Ts * k_tok, ch),
                v_all.reshape(1, nWa * nh, Ts * k_tok, ch), bias, scale)
            out[b, dirty] = out_a.reshape(nWa, nh, Tq, win, ch)
        return out


class TemporalSparseTransformer(nn.Module):
    """Pre-LN attention + FusionFeedForward block. Reference :284-314."""

    def __init__(self, dim: int = 512, n_head: int = 4, window_size=(5, 9),
                 pool_size=(4, 4)):
        super().__init__()
        self.attention = SparseWindowAttention(dim, n_head, window_size,
                                               pool_size)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = FusionFeedForward(dim)

    def forward(self, x, fold_x_size, mask, static_sel, frame_valid=None,
                out_frames: int | None = None):
        """out_frames: only the first out_frames frames come out (their
        queries, shortcut and MLP; keys from all frames)."""
        B, T, H, W, C = x.shape
        att = self.attention(self.norm1(x), mask, static_sel, frame_valid,
                             out_frames)
        if out_frames is not None:
            x, T = x[:, :out_frames], out_frames
        x = x + att
        y = self.mlp(self.norm2(x).reshape(B, T * H * W, C), fold_x_size)
        return x + y.reshape(B, T, H, W, C)


class TemporalSparseTransformerBlock(nn.Module):
    """Blocks with alternating temporal dilation. Reference :317-344."""

    def __init__(self, dim: int = 512, n_head: int = 4, window_size=(5, 9),
                 pool_size=(4, 4), depths: int = 8):
        super().__init__()
        self.transformer = nn.Sequential(*[
            TemporalSparseTransformer(dim, n_head, window_size, pool_size)
            for _ in range(depths)])

    def forward(self, x, fold_x_size, l_mask, t_dilation: int = 2,
                frame_valid=None, out_frames: int | None = None):
        """out_frames: the last block emits only the first out_frames
        frames (the decoder reads no others)."""
        T = x.shape[1]
        last = len(self.transformer) - 1
        for i, block in enumerate(self.transformer):
            static_sel = np.zeros(T, np.bool_)
            static_sel[i % t_dilation::t_dilation] = True
            x = block(x, fold_x_size, l_mask, static_sel, frame_valid,
                      out_frames if i == last else None)
        return x


# ---------------------------------------------------------------------------
# Propagation
# ---------------------------------------------------------------------------


def image_propagation(x, flows_forward, flows_backward, mask):
    """Non-learnable bidirectional pixel propagation with forward-backward
    consistency gating. Reference model/propainter.py:104-190
    (learnable=False): pixels warped nearest, flows and masks bilinearly.

    x (B, T, H, W, 3) masked frames; flows (B, T-1, H, W, 2); mask
    (B, T, H, W, 1). Returns (prop_frames, updated_masks), NHWC."""

    def run(frames, masks, flows_prop, flows_check):
        feat_prop, mask_prop = frames[0], masks[0]
        feats, out_masks = [feat_prop], [mask_prop]
        for i in range(1, len(frames)):
            flow_prop, flow_check = flows_prop[i - 1], flows_check[i - 1]
            bundle = torch.cat([flow_check, mask_prop], dim=-1)
            warped, feat_warped = flow_warp_bilinear_nearest(
                bundle, feat_prop, flow_prop)
            flow_valid = fb_consistency_from_warped(flow_prop,
                                                    warped[..., :2])
            mask_prop_valid = binary_mask(warped[..., 2:3])
            union = binary_mask(masks[i] * flow_valid * (1 - mask_prop_valid))
            feat_prop = union * feat_warped + (1 - union) * frames[i]
            mask_prop = binary_mask(
                masks[i] * (1 - flow_valid * (1 - mask_prop_valid)))
            feats.append(feat_prop)
            out_masks.append(mask_prop)
        return feats, out_masks

    frames = list(x.unbind(1))
    masks = list(mask.unbind(1))
    ff = list(flows_forward.unbind(1))
    fb = list(flows_backward.unbind(1))
    back_f, back_m = run(frames[::-1], masks[::-1], ff[::-1], fb[::-1])
    fwd_f, fwd_m = run(back_f[::-1], back_m[::-1], fb, ff)
    return torch.stack(fwd_f, dim=1), torch.stack(fwd_m, dim=1)


class DeformableAlignment(nn.Module):
    """Flow-guided deformable alignment. Reference
    model/propainter.py:34-69."""

    def __init__(self, channel: int = 128, deform_groups: int = 16,
                 max_residue_magnitude: float = 3.0):
        super().__init__()
        self.dg = deform_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.weight = nn.Parameter(torch.empty(channel, channel, 3, 3))
        self.bias = nn.Parameter(torch.zeros(channel))
        nn.init.kaiming_normal_(self.weight)
        self.conv_offset = nn.Sequential(
            conv2d(2 * channel + 2 + 1 + 2, channel, 3, 1, 1),
            nn.LeakyReLU(0.1, inplace=True),
            conv2d(channel, channel, 3, 1, 1), nn.LeakyReLU(0.1, inplace=True),
            conv2d(channel, channel, 3, 1, 1), nn.LeakyReLU(0.1, inplace=True),
            conv2d(channel, 27 * deform_groups, 3, 1, 1))

    def forward(self, x, cond, flow):
        """x (B, C, H, W); cond (B, 2C+5, H, W); flow (B, H, W, 2)."""
        return deform_align(x, self.conv_offset(cond), self.weight,
                            self.bias, self.dg, self.max_residue_magnitude,
                            flow)


class FeaturePropagation(nn.Module):
    """Learnable bidirectional feature propagation. Reference
    model/propainter.py:72-190 (learnable=True)."""

    def __init__(self, channel: int = 128):
        super().__init__()
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for name in ("backward_1", "forward_1"):
            self.deform_align[name] = DeformableAlignment(channel)
            self.backbone[name] = nn.Sequential(
                conv2d(2 * channel + 2, channel, 3, 1, 1),
                nn.LeakyReLU(0.2, inplace=True),
                conv2d(channel, channel, 3, 1, 1))
        self.fuse = nn.Sequential(
            GemmConv2d(2 * channel + 2, channel, 3, 1),
            nn.LeakyReLU(0.2, inplace=True),
            conv2d(channel, channel, 3, 1, 1))

    def _step(self, name, cur, m, feat_prop, flow_prop, flow_check):
        """One propagation step; feat_prop None at the first frame."""
        if feat_prop is None:
            feat_prop = cur
        else:
            warped = flow_warp_nchw(
                torch.cat([flow_check.permute(0, 3, 1, 2), feat_prop],
                          dim=1), flow_prop)
            flow_valid = fb_consistency_from_warped(
                flow_prop, warped[:, :2].permute(0, 2, 3, 1))
            cond = torch.cat([cur, warped[:, 2:],
                              flow_prop.permute(0, 3, 1, 2),
                              flow_valid.permute(0, 3, 1, 2), m], dim=1)
            feat_prop = self.deform_align[name](feat_prop, cond, flow_prop)
        feat = torch.cat([cur, feat_prop, m], dim=1)
        return feat_prop + self.backbone[name](feat)

    def _run(self, name, frames, masks, flows_prop, flows_check):
        outs = []
        for i, (cur, m) in enumerate(zip(frames, masks)):
            args = (name, cur, m) + ((None, None, None) if i == 0 else (
                outs[-1], flows_prop[i - 1], flows_check[i - 1]))
            outs.append(self._step(*args))
        return outs

    def forward(self, x, flows_forward, flows_backward, mask):
        """x (B, T, C, h, w); flows (B, T-1, h, w, 2); mask (B, T, 2, h, w)
        (mask_in, mask_updated). Returns (B, T, C, h, w)."""
        frames, masks = list(x.unbind(1)), list(mask.unbind(1))
        ff, fb = list(flows_forward.unbind(1)), list(flows_backward.unbind(1))
        back = self._run("backward_1", frames[::-1], masks[::-1], ff[::-1],
                         fb[::-1])[::-1]
        fwd = self._run("forward_1", back, masks, fb, ff)
        fused = torch.cat([torch.stack(back, 1), torch.stack(fwd, 1), mask],
                          dim=2).flatten(0, 1)
        out = self.fuse(fused) + x.flatten(0, 1)
        return out.view_as(x)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------



class InpaintGenerator(nn.Module):
    """Encoder -> feature propagation -> sparse transformer -> decoder.
    Reference model/propainter.py:256-372, inference."""

    def __init__(self, channel: int = 128, hidden: int = 512,
                 depths: int = 8, num_heads: int = 4, window_size=(5, 9),
                 pool_size=(4, 4)):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = nn.Sequential(
            Deconv(channel, 128), nn.LeakyReLU(0.2, inplace=True),
            conv2d(128, 64, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            Deconv(64, 64), nn.LeakyReLU(0.2, inplace=True),
            conv2d(64, 3, 3, 1, 1))
        self.ss = SoftSplit(channel, hidden)
        self.sc = SoftComp(channel, hidden)
        self.feat_prop_module = FeaturePropagation(channel)
        self.transformers = TemporalSparseTransformerBlock(
            hidden, num_heads, window_size, pool_size, depths)

    def encode(self, frames, masks_in, masks_updated):
        """(N, H, W, 3), (N, H, W, 1), (N, H, W, 1) -> encoder features (N,
        c, h, w); the encoder is per frame."""
        x = torch.cat([frames, masks_in, masks_updated], dim=-1)
        return self.encoder(x.permute(0, 3, 1, 2))

    def tokenize(self, feat):
        """(N, c, h, w) features -> (N, fh, fw, hidden) tokens; SoftSplit
        is per frame."""
        return self.ss(feat, 1)[0]

    def forward(self, masked_frames, completed_flows, masks_in, masks_updated,
                num_local_frames: int, ref_feat, ref_tokens, frame_valid,
                t_dilation: int = 2):
        """One window: masked_frames, masks_in, masks_updated (1, l_t, H,
        W, .) of its local frames, in [-1, 1] / binary; completed_flows
        (flows_f, flows_b), each (1, l_t-1, H, W, 2); ref_feat (1, R, c,
        h, w) and ref_tokens (1, R, fh, fw, hidden): the reference frames'
        encoder features and tokens (each frame's own: the encoder and
        SoftSplit are per frame); frame_valid (1, l_t + R) bool, False on
        padded reference slots. Returns (1, l_t, H, W, 3) in [-1, 1]."""
        l_t = num_local_frames
        B, _, H, W, _ = masks_in.shape
        local = self.encode(*(x.flatten(0, 1) for x in (
            masked_frames, masks_in, masks_updated)))
        local = local.view(B, l_t, *local.shape[1:])
        c, h, w = local.shape[2:]
        fold_size = (h, w)

        flows_f, flows_b = completed_flows
        ds_ff = resize(flows_f, (h, w), "bilinear") / 4.0
        ds_fb = resize(flows_b, (h, w), "bilinear") / 4.0
        ds_mask_in = resize(masks_in, (h, w), "nearest")
        ds_mask_upd = resize(masks_updated, (h, w), "nearest")
        mask_pool_l = token_masks(ds_mask_in)

        prop_mask = torch.cat([ds_mask_in, ds_mask_upd], dim=-1)
        local = self.feat_prop_module(local, ds_ff, ds_fb,
                                      prop_mask.permute(0, 1, 4, 2, 3))
        tokens = torch.cat([self.ss(local.flatten(0, 1), B), ref_tokens],
                           dim=1)
        # the decoder reads the local frames only: the last block's queries
        # are theirs
        tokens = self.transformers(tokens, fold_size, mask_pool_l,
                                   t_dilation, frame_valid, l_t)
        trans = self.sc(tokens, fold_size).view(B, l_t, c, h, w)
        out = torch.tanh(self.decoder((local + trans).flatten(0, 1)))
        return out.view(B, l_t, 3, H, W).permute(0, 1, 3, 4, 2)
