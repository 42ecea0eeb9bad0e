"""The hand-written kernels' bounds: the least time the chip could take for
a call, the larger of its bytes over the memory rate and its operations
over the rate of the units that run them (a copy of the arithmetic of the
port's kernel table, PERF.md):

  fp32 forms  products in 3xTF32 on the tensor cores (three TF32 passes
              at 495 TFLOP/s), the rest on CUDA cores at 67 TFLOP/s;
  bf16 forms  products on the bf16 tensor cores at 989 TFLOP/s.

Peaks are one H100 SXM's published dense rates at 700 W. Each input byte
is counted read once and each output byte written once. K1 reads, of its
pyramid, the taps of each query's 10 x 10 windows that lie inside the
maps; the count takes the queries' coordinates at their own grid
positions, where the seeded RAFT's flows of a fraction of a pixel
(`weights.py`) leave them.

`clip_calls` gives the calls of the work a clip needs, from the cell's
shapes and its masks: the share counts the work, not the implementation
(K4's work is the attention windows that hold a hole token; the program
pads them to buckets of 4 and pads the reference frames).
"""

from __future__ import annotations

import numpy as np

from benchmark.flops import _up, signature, token_grid
from benchmark.reference.pipeline import (Config, _chunks,
                                          get_short_clip_len, windows)
from benchmark.reference.propainter import _valid_rolled_indices

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
# the whole step's peak for `mfu`: bf16 on the tensor cores, and for fp32
# the fastest fp32-accurate product on the card, 3xTF32 (495 / 3)
PEAK_FLOPS = {"bf16": PEAK_BF16_FLOPS, "fp32": PEAK_TF32_FLOPS / 3}
# the launch counter of each kernel in each precision
COUNTERS = {
    "fp32": {"k1": "corr_lookup_moenc", "k2": "corr_pyramid_build",
             "k3": "modulated_deform_conv2d",
             "k4": "flash_window_attention"},
    "bf16": {"k1": "corr_lookup_moenc_bf16", "k2": "corr_pyramid_build_bf16",
             "k3": "modulated_deform_conv2d_bf16",
             "k4": "flash_window_attention_bf16"},
}
ELEM = {"fp32": 4, "bf16": 2}


def bound_s(n_bytes: float, products: float, cuda_core_ops: float,
            precision: str) -> float:
    """Seconds: max(bytes / 3.35 TB/s, operations / their peak)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    if precision == "fp32":
        t_ops = max(3 * products / PEAK_TF32_FLOPS,
                    cuda_core_ops / PEAK_FP32_FLOPS)
    else:
        t_ops = max(products / PEAK_BF16_FLOPS,
                    cuda_core_ops / PEAK_FP32_FLOPS)
    return max(t_bytes, t_ops)


def k2(n_pairs: int, h: int, w: int, precision: str) -> float:
    """The pyramid of n_pairs pair-directions' (h*w, h, w) fp32 level 0:
    level 0 read, levels 1-3 written (the bf16 form writes level 0 too, in
    bf16), 4 operations a pooled value."""
    n = n_pairs * h * w
    sizes = [(h >> i, w >> i) for i in range(4)]
    pooled = sum(a * b for a, b in sizes[1:]) * n
    if precision == "fp32":
        n_bytes = 4 * n * h * w + 4 * pooled
    else:
        n_bytes = 4 * n * h * w + 2 * (n * h * w + pooled)
    return bound_s(n_bytes, 0, 4 * pooled, "fp32" if precision == "fp32"
                   else "bf16")


def in_range_taps(h: int, w: int) -> int:
    """The taps of every query's 10 x 10 windows at each of the 4 levels
    that lie inside the level's map, for queries at their own grid
    positions."""
    total = 0
    for lvl in range(4):
        hl, wl = h >> lvl, w >> lvl

        def per_axis(n, size):
            c0 = np.floor(np.arange(n) / 2 ** lvl)
            return (np.clip(c0 + 6, 0, size) - np.clip(c0 - 4, 0, size)
                    ).clip(0)

        total += int(per_axis(h, hl).sum() * per_axis(w, wl).sum())
    return total


def k1(n_pairs: int, h: int, w: int, precision: str) -> float:
    """One RAFT iteration's lookup with convc1 (324 -> 256) and relu over
    n_pairs pair-directions at h x w."""
    n_q = n_pairs * h * w
    e = ELEM[precision]
    n_bytes = (e * n_pairs * in_range_taps(h, w) + 4 * 2 * n_q
               + e * (324 * 256 + 256) + 4 * 256 * n_q)
    return bound_s(n_bytes, n_q * 2 * 324 * 256,
                   n_q * 324 * (7 if precision == "fp32" else 10), precision)


def k3(b: int, h: int, w: int, c: int, precision: str, dg: int = 16,
       out: int = 128) -> float:
    """A 3x3 modulated deformable convolution of a (b, h, w, c) map into
    `out` channels with dg groups."""
    n = b * h * w
    e = ELEM[precision]
    n_bytes = e * (n * c + n * dg * 9 * 3 + 9 * c * out + out + n * out)
    return bound_s(n_bytes, n * 2 * 9 * c * out, n * 9 * c * 12, precision)


def k4(problems: int, tq: int, tk: int, precision: str, ch: int = 128
       ) -> float:
    """Windowed attention of `problems` heads x windows, tq query rows over
    tk keys, with an fp32 key bias."""
    e = ELEM[precision]
    n_bytes = e * problems * ch * (2 * tq + 2 * tk) + 4 * tk
    return bound_s(n_bytes, problems * 4 * tq * tk * ch,
                   problems * 5 * tq * tk, precision)


def clip_calls(T: int, H: int, W: int, settings: dict, precision: str,
               dirty: tuple) -> dict:
    """{kernel: [bound seconds of each call]} of the work one T-frame H x W
    clip needs of K1 (RAFT's lookup with convc1), K2 (the pyramid), K3 (the
    deformable convolution) and K4 (the attention's full branch: each
    stage-4 window's 8 blocks over its dirty attention windows, `dirty`,
    its real frames' queries and the selected frames' keys)."""
    cfg = Config(**settings)
    h8, w8 = _up(_up(_up(H))), _up(_up(_up(W)))
    h4, w4 = _up(_up(H)), _up(_up(W))
    clip = get_short_clip_len(W)
    chunks = ([T] if T <= clip else
              [min(T, f + clip) - (f if f == 0 else f - 1)
               for f in range(0, T, clip)])
    calls = {"k1": [], "k2": [], "k3": [], "k4": []}
    for n in chunks:
        calls["k2"].append(k2(2 * (n - 1), h8, w8, precision))
        calls["k1"] += [k1(2 * (n - 1), h8, w8, precision)] * cfg.raft_iter
    for s, e, _, _ in _chunks(T - 1, cfg.subvideo_length, 5):
        calls["k3"] += [k3(2, h8, w8, 256, precision)] * (2 * (e - s - 1))
    k_tok = (45 + len(_valid_rolled_indices((5, 9), (3, 5)))
             + token_grid(H, W)["pooled"])
    for (nb, refs), d in zip(windows(T, cfg), dirty):
        calls["k3"] += [k3(1, h4, w4, 128, precision)] * (2 * (len(nb) - 1))
        frames = len(nb) + len(refs)
        for i in range(8):
            rows = (len(nb) if i == 7 else frames) * 45
            keys = len(range(i % 2, frames, 2)) * k_tok
            if d:
                calls["k4"].append(k4(4 * d, rows, keys, precision))
    return calls


def share(events: list, launches: dict, masks: list, settings: dict,
          precision: str, notes: list):
    """Σ bound / Σ device time of the hand kernels' work in a trace of the
    clips whose dilated masks (T, H, W) are `masks`, %: the bounds of the
    work the clips need (`clip_calls`), the time of K1-K4's records of the
    cell's precision. A launch count other than the work's calls is
    noted."""
    import re

    from benchmark.trace import KERNELS

    c = COUNTERS[precision]
    work = {k: [] for k in c}
    for m in masks:
        calls = clip_calls(*m.shape, settings, precision,
                           signature(m, settings["neighbor_length"] // 2))
        for k, b in calls.items():
            work[k] += b
    for k, b in work.items():
        if launches.get(c[k], 0) != len(b):
            notes.append(f"roofline: {c[k]} launched "
                         f"{launches.get(c[k], 0)} times in the trace; the "
                         f"work's calls are {len(b)}")
    bound = sum(sum(b) for b in work.values())
    pat = re.compile(r"\b(" + "|".join(
        KERNELS[c[k]] for k in ("k1", "k2", "k3", "k4")) + r")\b")
    device_ns = sum(d for name, _, d in events if pat.search(name))
    if not device_ns:
        return None
    return 100.0 * bound / (device_ns / 1e9)
