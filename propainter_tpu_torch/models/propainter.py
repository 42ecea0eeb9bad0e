"""ProPainter inpainting generator, NCHW inside. Counterpart of
`propainter_tpu/models/propainter.py`; `state_dict()` keys are
ProPainter.pth's.

Tokens between SoftSplit and SoftComp are channel-last, (B, T, h, w, C).
The sparse window attention has three forms (`attention_impl`): 'flash'
computes branch A (masked windows attend over the selected frames'
window, rolled-band and pooled tokens) through kernel K4, for every
window or for a bucket of the dirty ones (`masked_windows`), and branch B
(within window, same frame) as a plain batched softmax, and selects per
window by occupancy; 'xla' computes branch A the same way with a plain,
differentiable softmax in place of K4 (the JAX package's training form);
'pallas' lets kernel K5 take each window's branch. Feature propagation's
deformable alignment is kernel K3.

Training (`InpaintGenerator.forward(..., train=True)`) runs 'flash' as
'xla', pools the masks of all T frames, and folds and decodes all T frames;
`remat=True` checkpoints each transformer block and each feature
propagation step under autograd.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from propainter_tpu_torch.models.layers import (
    Deconv, GemmConv2d, SplitGroupConv2d, conv2d, deform_align)
from propainter_tpu_torch.ops.attention import (
    sparse_window_attention, sparse_window_attention_bf16)
from propainter_tpu_torch.ops.flash_attention import (
    NEG_INF, _flash_window_attention_plain, flash_window_attention,
    flash_window_attention_bf16)
from propainter_tpu_torch.ops.interp import max_pool2d, resize
from propainter_tpu_torch.ops.patches import unfold_output_size
from propainter_tpu_torch.ops.warp import (
    fb_consistency_from_warped, flow_warp, flow_warp_bilinear_nearest,
    flow_warp_nchw)

KERNEL = (7, 7)
STRIDE = (3, 3)
PADDING = (3, 3)


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


@functools.cache
def _frame_selection(static_sel: bytes, device, as_index: bool):
    """A block's temporal dilation (`static_sel`, a (T,) bool array's
    bytes) on `device`: its frame indices, or the (T,) bool mask. Made
    once per (selection, device) outside inference mode, so an attention
    call in a captured CUDA graph makes no host data into a tensor and
    training may index with it. Never evicted: a captured graph reads the
    tensor by address for as long as it lives."""
    sel = np.frombuffer(static_sel, np.bool_)
    with torch.inference_mode(False):
        return torch.as_tensor(np.nonzero(sel)[0] if as_index
                               else sel.copy(), device=device)


def _window_partition(x, window, n_head):
    """(B, T, H, W, C) -> (B, nW, n_head, T, wh*ww, C/n_head), head-major
    channel split. Reference sparse_transformer.py:104-115."""
    B, T, H, W, C = x.shape
    wh, ww = window
    nh, nw = H // wh, W // ww
    x = x.reshape(B, T, nh, wh, nw, ww, n_head, C // n_head)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(B, nh * nw, n_head, T, wh * ww, C // n_head)


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


def masked_window_bitmap(masks_in_local, window_size=(5, 9)):
    """(B, l_t, H, W, 1) 0/1 dilated masks of the local frames at image
    resolution -> (B, nW) bool: which attention windows hold a hole token.
    The occupancy `SparseWindowAttention` derives, bit for bit: the
    nearest resize to the encoder grid (two stride-2 convs: ceil/2
    twice), `token_masks`, `window_occupancy`. Counterpart of
    `propainter_tpu/models/propainter.py:masked_window_bitmap`."""
    def half(n):    # a stride-2 3x3 convolution with padding 1
        return -(-n // 2)

    H, W = masks_in_local.shape[2:4]
    ds = resize(masks_in_local, (half(half(H)), half(half(W))), "nearest")
    return window_occupancy(token_masks(ds), window_size) > 0


ATTENTION_IMPLS = ("flash", "xla", "pallas")


def _check_attention_impl(impl: str) -> None:
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                         f"got {impl!r}")


class SparseWindowAttention(nn.Module):
    """Mask-guided sparse window attention. Reference
    sparse_transformer.py:117-281.

    attention_impl:
      'flash'  (default) — both branches, selected per window by
               occupancy: branch A (over the selected frames' window,
               rolled-band and pooled tokens) through kernel K4, for every
               window or a bucket of the dirty ones, branch B (within
               window and frame) a plain batched softmax.
      'xla'    — the same two branches with branch A a plain softmax over
               fp32 logits (the JAX module's dense form, which training
               differentiates); no kernel.
      'pallas' — one kernel, K5, that takes each window's branch itself,
               so branch-A work scales with the dirty windows; its inputs
               are the window partition of q/k/v and of four rolled copies
               of k/v on the padded token grid. No gradient.
    The JAX module's default is 'xla'; the port's is 'flash', the JAX
    pipeline's default."""

    def __init__(self, dim: int = 512, n_head: int = 4,
                 window_size=(5, 9), pool_size=(4, 4),
                 attention_impl: str = "flash"):
        super().__init__()
        _check_attention_impl(attention_impl)
        self.attention_impl = attention_impl
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
        # kept for the checkpoint's keys; the indices are static
        self.register_buffer("valid_ind_rolled",
                             torch.as_tensor(self._valid_idx))
        # K5's mask of the rolled band's tokens outside the centre window
        roll_valid = torch.zeros(4 * window_size[0] * window_size[1],
                                 dtype=torch.bool)
        roll_valid[self._valid_idx] = True
        self.register_buffer("roll_valid", roll_valid, persistent=False)
        self._gather_idx: dict = {}   # (nwh, nww, device) -> indices

    def forward(self, x, mask, static_sel, frame_valid=None,
                masked_windows=None, q_frames: int | None = None,
                attention_impl: str | None = None):
        """x (B, T, H, W, C) tokens; mask (B, l_t, H, W, 1) pooled local
        masks; static_sel (T,) numpy bool — frames visible to branch A (the
        temporal dilation); frame_valid (T,) or (B, T) bool tensor or None
        — False masks padded reference frames' keys (per batch row when
        (B, T): stage 4 batches windows with their own padding).

        'flash' only ('pallas' ignores masked_windows and refuses
        q_frames, the JAX rule):
        masked_windows: (idx (B, m_b) int64, valid (B, m_b) bool) or None
          — a bucket holding every dirty window (`masked_window_bitmap`;
          slots past the dirty ones repeat them, an all-False row leaves
          the row to branch B). Branch A then runs on those m_b windows
          only and is scattered over branch B's output: the same result
          as the dense form.
        q_frames: the queries of only the first q_frames frames (keys and
          values still from all T); the output is (B, q_frames, H, W, C),
          exact for those frames.
        attention_impl: this call's form (None: the module's)."""
        impl = attention_impl or self.attention_impl
        B, T, H, W, C = x.shape
        if q_frames is not None and impl == "pallas":
            raise AssertionError(
                "q_frames shrink not wired for the opt-in pallas kernel")
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

        if impl == "pallas":
            out = self._sparse_windows(q, k, v, pool_k, pool_v, occ,
                                       static_sel, frame_valid)
        else:
            out = self._dense_windows(q, k, v, pool_k, pool_v, occ,
                                      static_sel, frame_valid,
                                      masked_windows, impl == "xla")
        out = out.reshape(B, nwh, nww, nh, Tq, wh, ww, ch)
        out = out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(B, Tq, new_h,
                                                          new_w, C)
        if pad_b or pad_r:
            out = out[:, :, :H, :W]
        return self.proj(out)

    def _dense_windows(self, q, k, v, pool_k, pool_v, occ, static_sel,
                       frame_valid, masked_windows=None, plain=False):
        """'flash' (plain: 'xla'): branch A for every window, or for the
        bucket `masked_windows`, through K4 (plain: its plain version),
        branch B for every window -> (B, nW, head, Tq, win, ch), Tq = q's
        frames."""
        B, Tq, new_h, new_w, C = q.shape
        T = k.shape[1]
        wh, ww = self.window_size
        nh = self.n_head
        ch = C // nh
        nwh, nww = new_h // wh, new_w // ww
        nW, win, P = nwh * nww, wh * ww, pool_k.shape[2]
        key = (nwh, nww, q.device)
        if key not in self._gather_idx:
            self._gather_idx[key] = torch.as_tensor(_window_gather_indices(
                nwh, nww, self.window_size, self.expand, self._valid_idx),
                device=q.device)
        idx_all = self._gather_idx[key]
        idx_q = idx_all[:, :win]
        n_idx = idx_all.shape[1]

        def gather_windows(t, idx):
            """(B, T', H', W', C) -> (B, nW, head, T', n_idx, ch)."""
            tf = t.reshape(B, t.shape[1], new_h * new_w, C)
            g = tf.index_select(2, idx.reshape(-1))
            g = g.reshape(B, t.shape[1], idx.shape[0], idx.shape[1], nh, ch)
            return g.permute(0, 2, 4, 1, 3, 5)

        win_q = gather_windows(q, idx_q)
        # branch B is same-frame: only the query frames' keys
        win_k = gather_windows(k[:, :Tq], idx_q)
        win_v = gather_windows(v[:, :Tq], idx_q)
        scale = 1.0 / math.sqrt(ch)

        # branch A: the windows over the selected frames' window, rolled
        # band and pooled tokens (kernel K4) for the bucket's windows, or
        # for every window (the bucket of all nW, its dirty slots valid),
        # gathered row by row from the flat token grid
        sel = _frame_selection(static_sel.tobytes(), q.device, True)
        Ts = sel.numel()
        if masked_windows is None:
            masked_windows = (torch.arange(nW, device=q.device).expand(B, nW),
                              occ > 0)
        mw_idx, mw_valid = masked_windows
        nWa = mw_idx.shape[1]
        bidx = torch.arange(B, device=q.device)[:, None]
        win_q_a = win_q[bidx, mw_idx]
        rows = idx_all[mw_idx].reshape(B, nWa * n_idx)

        def gather_a(t):
            tf = t.reshape(B, t.shape[1], new_h * new_w, C)
            g = tf[bidx, :, rows]          # (B, nWa * n_idx, T', C)
            g = g.reshape(B, nWa, n_idx, t.shape[1], nh, ch)
            return g.permute(0, 1, 4, 3, 2, 5)

        def pool_windows(p):
            p = p.index_select(1, sel).reshape(B, Ts, P, nh, ch)
            p = p.permute(0, 3, 1, 2, 4)[:, None]
            return p.expand(B, nWa, nh, Ts, P, ch)

        k_all = torch.cat([gather_a(k.index_select(1, sel)),
                           pool_windows(pool_k)], dim=4)
        v_all = torch.cat([gather_a(v.index_select(1, sel)),
                           pool_windows(pool_v)], dim=4)
        k_tok = k_all.shape[4]
        bias = None
        if frame_valid is not None:     # K4's (B, Ts * k_tok) key bias
            fv = frame_valid.to(q.device).expand(B, T).index_select(1, sel)
            bias = torch.where(fv, 0.0, NEG_INF).to(torch.float32)
            bias = bias.repeat_interleave(k_tok, dim=1).contiguous()
        if plain:
            attend = _flash_window_attention_plain
        elif q.dtype == torch.bfloat16:
            attend = flash_window_attention_bf16
        else:
            attend = flash_window_attention
        out_a = attend(
            win_q_a.reshape(B, nWa * nh, Tq * win, ch).contiguous(),
            k_all.reshape(B, nWa * nh, Ts * k_tok, ch).contiguous(),
            v_all.reshape(B, nWa * nh, Ts * k_tok, ch).contiguous(),
            bias, scale)
        out_a = out_a.reshape(B, nWa, nh, Tq, win, ch)

        # branch B: within window, same frame (bf16 logits in bf16, as the
        # JAX module's, `propainter.py:583, 612-619`)
        att_b = torch.softmax(win_q @ win_k.transpose(-1, -2) * scale, dim=-1)
        out_b = att_b @ win_v

        # the bucket's windows over branch B's: an invalid slot writes back
        # the value it reads, and repeated slots write equal values (each
        # K4 problem is computed on its own)
        keep = mw_valid[:, :, None, None, None, None]
        return out_b.index_put(
            (bidx, mw_idx), torch.where(keep, out_a, out_b[bidx, mw_idx]))

    def _sparse_windows(self, q, k, v, pool_k, pool_v, occ, static_sel,
                        frame_valid):
        """'pallas': each window's branch inside kernel K5 (its bf16 form
        on bf16 windows) -> (B, nW, head, T, win, ch)."""
        B, T, _, _, C = q.shape
        nh = self.n_head
        ch = C // nh
        eh, ew = self.expand
        shifts = ((-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew))

        def bh(a):   # (B, nW, head, ...) -> (B*head, nW, ...)
            a = a.transpose(1, 2)
            return a.reshape(B * nh, *a.shape[2:]).contiguous()

        def windows(t):
            return _window_partition(t, self.window_size, nh)

        def rolled(t):   # the four rolled copies on the padded grid
            return bh(torch.stack([windows(torch.roll(t, s, dims=(2, 3)))
                                   for s in shifts], dim=3))

        def pool_bh(p):  # (B, T, P, C) -> (B*head, T, P, ch)
            p = p.reshape(B, T, p.shape[2], nh, ch).permute(0, 3, 1, 2, 4)
            return p.reshape(B * nh, T, -1, ch).contiguous()

        frame_select = _frame_selection(static_sel.tobytes(), q.device,
                                        False).expand(B, T)   # K5's (B, T)
        if frame_valid is not None:
            frame_select = frame_select & frame_valid.to(q.device).expand(
                B, T)
        attend = (sparse_window_attention_bf16 if q.dtype == torch.bfloat16
                  else sparse_window_attention)
        out = attend(
            bh(windows(q)), bh(windows(k)), bh(windows(v)), rolled(k),
            rolled(v), pool_bh(pool_k), pool_bh(pool_v), self.roll_valid,
            occ, frame_select, nh)
        return out.reshape(B, nh, *out.shape[1:]).transpose(1, 2)


class TemporalSparseTransformer(nn.Module):
    """Pre-LN attention + FusionFeedForward block. Reference :284-314."""

    def __init__(self, dim: int = 512, n_head: int = 4, window_size=(5, 9),
                 pool_size=(4, 4), attention_impl: str = "flash"):
        super().__init__()
        self.attention = SparseWindowAttention(dim, n_head, window_size,
                                               pool_size, attention_impl)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = FusionFeedForward(dim)

    def forward(self, x, fold_x_size, mask, static_sel, frame_valid=None,
                masked_windows=None, out_frames: int | None = None,
                attention_impl: str | None = None):
        """out_frames: only the first out_frames frames come out (their
        queries, shortcut and MLP; keys from all frames), exact for
        those. attention_impl: this call's form (None: the module's)."""
        B, T, H, W, C = x.shape
        att = self.attention(self.norm1(x), mask, static_sel, frame_valid,
                             masked_windows, out_frames, attention_impl)
        if out_frames is not None:
            x, T = x[:, :out_frames], out_frames
        x = x + att
        y = self.mlp(self.norm2(x).reshape(B, T * H * W, C), fold_x_size)
        return x + y.reshape(B, T, H, W, C)


class TemporalSparseTransformerBlock(nn.Module):
    """Blocks with alternating temporal dilation. Reference :317-344.
    remat: under autograd each block is checkpointed (only its input is
    kept for the backward pass), as the JAX module's `nn.remat`."""

    def __init__(self, dim: int = 512, n_head: int = 4, window_size=(5, 9),
                 pool_size=(4, 4), depths: int = 8,
                 attention_impl: str = "flash", remat: bool = False):
        super().__init__()
        self.remat = remat
        self.transformer = nn.Sequential(*[
            TemporalSparseTransformer(dim, n_head, window_size, pool_size,
                                      attention_impl)
            for _ in range(depths)])

    def forward(self, x, fold_x_size, l_mask, t_dilation: int = 2,
                frame_valid=None, masked_windows=None,
                out_frames: int | None = None,
                attention_impl: str | None = None):
        """out_frames: the last block emits only the first out_frames
        frames (the decoder reads no others)."""
        T = x.shape[1]
        last = len(self.transformer) - 1
        remat = self.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.transformer):
            static_sel = np.zeros(T, np.bool_)
            static_sel[i % t_dilation::t_dilation] = True
            args = (x, fold_x_size, l_mask, static_sel, frame_valid,
                    masked_windows, out_frames if i == last else None,
                    attention_impl)
            x = (checkpoint(block, *args, use_reentrant=False) if remat
                 else block(*args))
        return x


# ---------------------------------------------------------------------------
# Propagation
# ---------------------------------------------------------------------------


def image_propagation(x, flows_forward, flows_backward, mask,
                      interpolation: str = "nearest"):
    """Non-learnable bidirectional pixel propagation with forward-backward
    consistency gating. Reference model/propainter.py:104-190
    (learnable=False).

    x (B, T, H, W, 3) masked frames; flows (B, T-1, H, W, 2); mask
    (B, T, H, W, 1); interpolation: the pixel warp's, 'nearest' or
    'bilinear' (the flow and mask warps are bilinear either way). Returns
    (prop_frames, updated_masks), NHWC."""
    if interpolation not in ("nearest", "bilinear"):
        raise ValueError(f"unsupported interpolation: {interpolation}")

    def run(frames, masks, flows_prop, flows_check):
        feat_prop, mask_prop = frames[0], masks[0]
        feats, out_masks = [feat_prop], [mask_prop]
        for i in range(1, len(frames)):
            flow_prop, flow_check = flows_prop[i - 1], flows_check[i - 1]
            bundle = torch.cat([flow_check, mask_prop], dim=-1)
            if interpolation == "bilinear":
                warped = flow_warp(torch.cat([bundle, feat_prop], dim=-1),
                                   flow_prop)
                feat_warped = warped[..., 3:]
            else:
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
    """Flow-guided deformable alignment. Reference model/propainter.py:34-69."""

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
    model/propainter.py:72-190 (learnable=True). remat: under autograd
    each propagation step is checkpointed (K3 runs again in the backward
    pass), as the JAX module's `nn.remat(_FeatPropStep)`."""

    def __init__(self, channel: int = 128, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for name in ("backward_1", "forward_1"):
            self.deform_align[name] = DeformableAlignment(channel)
            self.backbone[name] = nn.Sequential(
                conv2d(2 * channel + 2, channel, 3, 1, 1),
                nn.LeakyReLU(0.2, inplace=True),
                conv2d(channel, channel, 3, 1, 1))
        # over the window's l_t frames: a GEMM from 13 frames, where fp32
        # cuDNN turns to FFT (the evaluation protocol's 13-21 frames)
        self.fuse = nn.Sequential(
            GemmConv2d(2 * channel + 2, channel, 3, 1, min_batch=13),
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
        remat = self.remat and torch.is_grad_enabled()
        outs = []
        for i, (cur, m) in enumerate(zip(frames, masks)):
            args = (name, cur, m) + ((None, None, None) if i == 0 else (
                outs[-1], flows_prop[i - 1], flows_check[i - 1]))
            outs.append(checkpoint(self._step, *args, use_reentrant=False)
                        if remat else self._step(*args))
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
    Reference model/propainter.py:256-372.
    attention_impl: the sparse window attention's form, 'flash', 'xla' or
    'pallas' (SparseWindowAttention). remat: checkpoint each feature
    propagation step and each transformer block under autograd (the
    trainer's setting)."""

    def __init__(self, channel: int = 128, hidden: int = 512,
                 depths: int = 8, num_heads: int = 4, window_size=(5, 9),
                 pool_size=(4, 4), attention_impl: str = "flash",
                 remat: bool = False):
        super().__init__()
        self.encoder = Encoder()
        self.decoder = nn.Sequential(
            Deconv(channel, 128), nn.LeakyReLU(0.2, inplace=True),
            conv2d(128, 64, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            Deconv(64, 64), nn.LeakyReLU(0.2, inplace=True),
            conv2d(64, 3, 3, 1, 1))
        self.ss = SoftSplit(channel, hidden)
        self.sc = SoftComp(channel, hidden)
        self.feat_prop_module = FeaturePropagation(channel, remat)
        self.transformers = TemporalSparseTransformerBlock(
            hidden, num_heads, window_size, pool_size, depths,
            attention_impl, remat)

    def set_attention_impl(self, impl: str) -> None:
        """Switch every transformer block to `impl` (the same weights)."""
        _check_attention_impl(impl)
        for block in self.transformers.transformer:
            block.attention.attention_impl = impl

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
                num_local_frames: int, t_dilation: int = 2, frame_valid=None,
                precomputed_enc_feat=None, precomputed_ref_feat=None,
                precomputed_ref_tokens=None, masked_windows=None,
                train: bool = False):
        """masked_frames (B, T, H, W, 3) in [-1, 1]; completed_flows
        (flows_f, flows_b) each (B, l_t-1, H, W, 2); masks_in / masks_updated
        (B, T, H, W, 1); frame_valid (T,) or (B, T) bool or None (False =
        padded reference frame, per batch row when (B, T)). Returns (B,
        l_t, H, W, 3) in [-1, 1], under train (B, T, H, W, 3).

        train (`propainter_tpu/models/propainter.py:1058-1121`): the
        attention masks pool the masks of all T frames, 'flash' runs as
        'xla', and every frame is folded and decoded; no precomputed
        inputs.

        Stage 4's schedule (`propainter_tpu/models/propainter.py:982-1111`):
        precomputed_enc_feat: (B, T, c, h, w) encoder features of the l_t
          local frames, then the references; nothing is encoded, the mask
          inputs need only the local frames and masked_frames may be None.
        precomputed_ref_feat: (B, T - l_t, c, h, w) the references'
          features; the frame and mask inputs are the l_t local frames.
        precomputed_ref_tokens: (B, T - l_t, fh, fw, hidden) the
          references' tokens; only the local frames are tokenized.
        masked_windows: (idx, valid), each (B, m_b): the bucket of dirty
          windows branch A runs on under 'flash'
          (`SparseWindowAttention`)."""
        l_t = num_local_frames
        B, _, H, W, _ = masks_in.shape
        if train and any(p is not None for p in (
                precomputed_enc_feat, precomputed_ref_feat,
                precomputed_ref_tokens, masked_windows)):
            raise ValueError("train takes no precomputed inputs")
        if precomputed_enc_feat is not None:
            enc = precomputed_enc_feat
            local, ref = enc[:, :l_t], enc[:, l_t:]
        elif precomputed_ref_feat is not None:
            if masked_frames.shape[1] != l_t:
                raise ValueError("with precomputed_ref_feat the frames are "
                                 "the l_t local ones")
            local = self.encode(*(x.flatten(0, 1) for x in (
                masked_frames, masks_in, masks_updated)))
            local = local.view(B, l_t, *local.shape[1:])
            ref = precomputed_ref_feat.to(masked_frames.dtype)
        else:
            enc = self.encode(*(x.flatten(0, 1) for x in (
                masked_frames, masks_in, masks_updated)))
            enc = enc.view(B, -1, *enc.shape[1:])
            local, ref = enc[:, :l_t], enc[:, l_t:]
        c, h, w = local.shape[2:]
        fold_size = (h, w)

        flows_f, flows_b = completed_flows
        ds_ff = resize(flows_f, (h, w), "bilinear") / 4.0
        ds_fb = resize(flows_b, (h, w), "bilinear") / 4.0
        ds_mask_in = resize(masks_in if train else masks_in[:, :l_t], (h, w),
                            "nearest")
        ds_mask_upd = resize(masks_updated[:, :l_t], (h, w), "nearest")
        mask_pool_l = token_masks(ds_mask_in)
        ds_mask_in = ds_mask_in[:, :l_t]

        prop_mask = torch.cat([ds_mask_in, ds_mask_upd], dim=-1)
        local = self.feat_prop_module(local, ds_ff, ds_fb,
                                      prop_mask.permute(0, 1, 4, 2, 3))
        enc = torch.cat([local, ref], dim=1)

        if precomputed_ref_tokens is not None:
            tokens = torch.cat([self.ss(local.flatten(0, 1), B),
                                precomputed_ref_tokens.to(local.dtype)],
                               dim=1)
        else:
            tokens = self.ss(enc.flatten(0, 1), B)
        # the last block's queries shrink to the local frames, except under
        # 'pallas' and in training (the JAX package's rule,
        # `propainter.py:1091-1101`)
        impl = self.transformers.transformer[0].attention.attention_impl
        if train and impl == "flash":
            impl = "xla"
        tokens = self.transformers(
            tokens, fold_size, mask_pool_l, t_dilation, frame_valid,
            masked_windows, None if train or impl == "pallas" else l_t, impl)
        t_out = tokens.shape[1] if train else l_t
        trans = self.sc(tokens[:, :t_out], fold_size).view(B, t_out, c, h, w)
        dec_in = (enc[:, :t_out] + trans).flatten(0, 1)
        out = torch.tanh(self.decoder(dec_in))
        return out.view(B, t_out, 3, H, W).permute(0, 1, 3, 4, 2)
