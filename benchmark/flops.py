"""The model's operations per clip: the floating-point operations of the
products (convolutions, linear layers, matrix products; 2 per
multiply-add) that ProPainter inference needs for one clip, counted from
the clip's shapes and its masks, as the plain reference computes them
(`reference/`): RAFT on each chunk, every frame encoded once; flow
completion on each chunk; image propagation (no products); stage 4 with
every reference frame encoded and tokenized once, the last transformer
block's queries the window's own frames, and the attention's full branch
on the attention windows that hold a hole token only. Normalisations,
activations, resampling and the softmax are not counted.

`torch.utils.flop_counter.FlopCounterMode` over the reference counts the
same (benchmark/tests/test_bench_work.py).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.pipeline import (Config, _chunks,
                                          get_short_clip_len, windows)
from benchmark.reference.propainter import _valid_rolled_indices


# stage 4's attention: windows of 5 x 9 tokens on the token grid of the
# soft split (7 x 7 patches, stride 3, padding 3) over the encoder's 1/4
# grid
TOKEN_WINDOW = (5, 9)
PATCH = (7, 3, 3)


def _token_grid(masks: np.ndarray) -> np.ndarray:
    """(T, H, W) 0/1 image-resolution masks -> (T, h', w') bool on the
    transformer's token grid: the nearest resize to the encoder's grid
    (ceil(ceil(n/2)/2)), then the soft split's max pool."""
    T, H, W = masks.shape
    h, w = -(-(-(-H // 2)) // 2), -(-(-(-W // 2)) // 2)
    iy = np.minimum(np.floor(np.arange(h) * (H / h)).astype(int), H - 1)
    ix = np.minimum(np.floor(np.arange(w) * (W / w)).astype(int), W - 1)
    enc = masks[:, iy][:, :, ix] > 0
    k, s, p = PATCH
    th, tw = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    padded = np.zeros((T, h + 2 * p, w + 2 * p), bool)
    padded[:, p:p + h, p:p + w] = enc
    out = np.zeros((T, th, tw), bool)
    for i in range(k):
        for j in range(k):
            out |= padded[:, i:i + s * th:s, j:j + s * tw:s][:, :th, :tw]
    return out


def signature(masks_dilated: np.ndarray, stride: int = 5) -> tuple:
    """For each stage-4 window of frames (centres 0, stride, 2 stride,
    ...; the frames within stride of it), the number of attention windows
    holding a hole token in any of its frames: the work of the
    attention's full branch, and what the program's CUDA graphs of stage
    4 are keyed by."""
    tok = _token_grid(masks_dilated)
    T, th, tw = tok.shape
    wh, ww = TOKEN_WINDOW
    nh, nw = -(-th // wh), -(-tw // ww)
    grid = np.zeros((T, nh * wh, nw * ww), bool)
    grid[:, :th, :tw] = tok
    dirty = grid.reshape(T, nh, wh, nw, ww).any(axis=(2, 4))   # (T, nh, nw)
    s = stride
    return tuple(int(dirty[max(0, f - s):min(T, f + s + 1)].any(0).sum())
                 for f in range(0, T, s))


def _up(n: int) -> int:
    """A stride-2 convolution's output size (ceil)."""
    return -(-n // 2)


def conv(cout: int, cin: int, k: int, pixels: int) -> int:
    """A dense convolution with a k-tap kernel (k = kh * kw * kd)."""
    return 2 * cout * cin * k * pixels


def raft_encoder(H: int, W: int) -> int:
    """One frame through one of RAFT's BasicEncoders (256 out)."""
    p2 = _up(H) * _up(W)
    p4 = _up(_up(H)) * _up(_up(W))
    p8 = _up(_up(_up(H))) * _up(_up(_up(W)))
    return (conv(64, 3, 49, p2) + 4 * conv(64, 64, 9, p2)
            + conv(96, 64, 9, p4) + 3 * conv(96, 96, 9, p4)
            + conv(96, 64, 1, p4)
            + conv(128, 96, 9, p8) + 3 * conv(128, 128, 9, p8)
            + conv(128, 96, 1, p8) + conv(256, 128, 1, p8))


def raft_chunk(n: int, H: int, W: int, iters: int) -> int:
    """RAFT over a chunk of n frames: both encoders on each frame, the
    2(n-1) pair-directions' volume, `iters` refinements, the mask head."""
    B = 2 * (n - 1)
    hw = _up(_up(_up(H))) * _up(_up(_up(W)))
    step = (2 * 324 * 256                              # convc1 on the windows
            + conv(192, 256, 9, 1) + conv(128, 2, 49, 1)
            + conv(64, 128, 9, 1) + conv(126, 256, 9, 1)
            + 6 * conv(128, 384, 5, 1)                 # the separable GRU
            + conv(256, 128, 9, 1) + conv(2, 256, 9, 1))
    head = conv(256, 128, 9, 1) + conv(576, 256, 1, 1)
    return (2 * n * raft_encoder(H, W) + 2 * B * hw * hw * 256
            + B * hw * (iters * step + head))


def flow_completion_chunk(n: int, H: int, W: int) -> int:
    """The flow completion over n flow frames, both directions (a batch of
    2)."""
    p2 = n * _up(H) * _up(W)
    p4 = n * _up(_up(H)) * _up(_up(W))
    p8 = n * _up(_up(_up(H))) * _up(_up(_up(W)))
    f8 = p8 // n
    enc = (conv(32, 3, 25, p2)
           + conv(32, 32, 9, p2) + conv(32, 32, 3, p2)
           + conv(64, 32, 9, p4) + conv(64, 64, 3, p4)
           + conv(64, 64, 9, p4) + conv(64, 64, 3, p4)
           + conv(128, 64, 9, p8) + conv(128, 128, 3, p8)
           + 3 * conv(128, 128, 9, p8))
    aligned = (conv(128, 384, 9, f8) + 2 * conv(128, 128, 9, f8)
               + conv(432, 128, 9, f8) + 2 * f8 * 9 * 256 * 128)
    prop = ((n - 1) * 2 * aligned
            + n * (conv(128, 256, 9, f8) + conv(128, 384, 9, f8)
                   + 2 * conv(128, 128, 9, f8))
            + n * conv(128, 256, 1, f8))
    dec = (conv(128, 128, 9, p8) + conv(64, 128, 9, p4)
           + conv(64, 64, 9, p4) + conv(32, 64, 9, p2)
           + conv(32, 32, 9, p2) + conv(2, 32, 9, n * H * W))
    return 2 * (enc + prop + dec)


def generator_encoder(H: int, W: int) -> int:
    """One frame through the generator's encoder."""
    p2 = _up(H) * _up(W)
    p4 = _up(_up(H)) * _up(_up(W))
    return (conv(64, 5, 9, p2) + conv(64, 64, 9, p2) + conv(128, 64, 9, p4)
            + conv(256, 128, 9, p4) + conv(384, 256, 9, p4)
            + conv(512, 320, 9, p4) + conv(384, 192, 9, p4)
            + conv(256, 80, 9, p4) + conv(128, 512, 9, p4))


def token_grid(H: int, W: int) -> dict:
    """The transformer's token grid of an H x W frame, padded to whole
    5 x 9 windows, and its 4 x 4 pooled tokens."""
    h4, w4 = _up(_up(H)), _up(_up(W))
    th, tw = (h4 + 6 - 7) // 3 + 1, (w4 + 6 - 7) // 3 + 1
    nh, nw = -(-th // 5), -(-tw // 9)
    ph, pw = (nh * 5 - 4) // 4 + 1, (nw * 9 - 4) // 4 + 1
    return dict(h4=h4, w4=w4, tokens=th * tw, padded=nh * 5 * nw * 9,
                windows=nh * nw, pooled=ph * pw)


def window(l_t: int, refs: int, dirty: int, H: int, W: int) -> int:
    """One stage-4 window: the local frames encoded, propagated and
    tokenized, 8 transformer blocks over them and the references' tokens,
    soft composition and decoding of the local frames."""
    g = token_grid(H, W)
    f4 = g["h4"] * g["w4"]
    C, D, nh, ch, win = 128, 512, 4, 128, 45
    aligned = (conv(C, 2 * C + 5, 9, f4) + 2 * conv(C, C, 9, f4)
               + conv(432, C, 9, f4) + 2 * f4 * 9 * C * C)
    backbone = conv(C, 2 * C + 2, 9, f4) + conv(C, C, 9, f4)
    prop = (2 * ((l_t - 1) * aligned + l_t * backbone)
            + l_t * (conv(C, 2 * C + 2, 9, f4) + conv(C, C, 9, f4)))
    T = l_t + refs
    k_tok = win + len(_valid_rolled_indices((5, 9), (3, 5))) + g["pooled"]
    blocks = 0
    for i in range(8):
        Tq = l_t if i == 7 else T
        Ts = len(range(i % 2, T, 2))
        blocks += (2 * D * D * g["padded"] * (Tq + 2 * T)      # q, k, v
                   + 2 * D * 16 * T * g["pooled"]              # pool conv
                   + 2 * 2 * D * D * T * g["pooled"]           # pooled k, v
                   + 4 * g["windows"] * nh * Tq * win * win * ch  # branch B
                   + 4 * dirty * nh * Tq * win * Ts * k_tok * ch  # branch A
                   + 2 * D * D * Tq * g["tokens"]              # proj
                   + 2 * 2 * D * 1960 * Tq * g["tokens"])      # MLP
    p2, p1 = _up(H) * _up(W), H * W
    out = (2 * D * C * 49 * g["tokens"] + 2 * D * C * 49 * g["tokens"]
           + conv(C, C, 9, f4))                                 # ss, sc
    dec = (conv(128, 128, 9, p2) + conv(64, 128, 9, p2)
           + conv(64, 64, 9, p1) + conv(3, 64, 9, p1))
    return (l_t * generator_encoder(H, W) + prop + blocks
            + l_t * (out + dec))


def clip_flops(masks_dilated: np.ndarray, settings: dict) -> int:
    """The products' operations of the clip whose dilated masks are
    `masks_dilated` (T, H, W) under the inference settings `settings`
    (ref_stride, neighbor_length, subvideo_length, raft_iter)."""
    return count(*masks_dilated.shape, masks_dilated, Config(**settings))


def count(T: int, H: int, W: int, masks_dilated: np.ndarray,
          cfg: Config) -> int:
    """The products' operations of one T-frame H x W clip whose dilated
    masks are `masks_dilated`."""
    clip = get_short_clip_len(W)
    total = 0
    if T <= clip:
        total += raft_chunk(T, H, W, cfg.raft_iter)
    else:
        for f in range(0, T, clip):
            s = f if f == 0 else f - 1
            total += raft_chunk(min(T, f + clip) - s, H, W, cfg.raft_iter)
    for s, e, _, _ in _chunks(T - 1, cfg.subvideo_length, 5):
        total += flow_completion_chunk(e - s, H, W)
    plan = windows(T, cfg)
    union = {r for _, refs in plan for r in refs}
    g = token_grid(H, W)
    total += len(union) * (generator_encoder(H, W)
                           + 2 * 512 * 128 * 49 * g["tokens"])
    dirty = signature(masks_dilated, cfg.neighbor_length // 2)
    for (nb, refs), d in zip(plan, dirty):
        total += window(len(nb), len(refs), d, H, W)
    return int(total)

