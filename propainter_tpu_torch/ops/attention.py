"""Mask-guided sparse window attention, the generator's `attention_impl=
"pallas"` form. Counterpart of `propainter_tpu/ops/attention.py`.

Per (batch*head, window) the queries of all frames take one of two paths:
  * dirty window (occupancy > 0): one softmax over, for every frame the
    batch row selects, the window's keys, the valid keys of its four rolled
    copies and the pooled tokens;
  * clean window: each frame's queries attend within the window and frame.

Layouts (the JAX package's; ch = C / n_head, BH = B * n_head, head minor):
  win_q/k/v:    (BH, nW, T, win, ch)
  roll_k/v:     (BH, nW, 4, T, win, ch), valid where roll_valid (4 * win,)
  pool_k/v:     (BH, T, P, ch)
  occupancy:    (B, nW), counted as int32 (a sum below 1 is clean)
  frame_select: (B, T) bool
Output:         (BH, nW, T, win, ch), win_q's dtype.

The windows are fp32 (`sparse_window_attention`, kernel K5) or bf16
(`sparse_window_attention_bf16`, K5's bf16 form: the JAX bf16 pipeline's
windows, upcast inside, the arithmetic fp32, the output bf16).
"""

from __future__ import annotations

import math

import torch

from propainter_tpu_torch import _build

NEG_INF = -1e9   # the TPU kernel's mask value and initial running max


def _sparse_window_attention_plain(win_q, win_k, win_v, roll_k, roll_v,
                                   pool_k, pool_v, roll_valid, occupancy,
                                   frame_select, n_head):
    """The TPU kernel's recurrence step by step, over all windows at once:
    the dirty branch streams frame by frame with masked logits set to -1e9
    and the running max starting at -1e9, the clean branch is a per-frame
    softmax; the occupancy then picks one per window."""
    BH, nW, T, win, ch = win_q.shape
    P = pool_k.shape[2]
    B = BH // n_head
    scale = 1.0 / math.sqrt(ch)
    q = win_q.float() * scale
    qf = q.reshape(BH, nW, T * win, ch)
    ones = torch.ones(win, dtype=torch.bool, device=q.device)
    key_valid = torch.cat([ones, roll_valid.to(q.device, torch.bool),
                           ones.new_ones(P)])                   # (ktok,)
    fsel = frame_select.reshape(B, T).bool().repeat_interleave(n_head, 0)

    m = q.new_full((BH, nW, T * win, 1), NEG_INF)
    s = q.new_zeros((BH, nW, T * win, 1))
    acc = q.new_zeros((BH, nW, T * win, ch))
    for t in range(T):
        def keys(c, r, p):
            return torch.cat([c[:, :, t].float(),
                              r[:, :, :, t].reshape(BH, nW, 4 * win, ch).float(),
                              p[:, None, t].float().expand(BH, nW, P, ch)],
                             dim=2)

        kt, vt = keys(win_k, roll_k, pool_k), keys(win_v, roll_v, pool_v)
        logits = qf @ kt.transpose(-1, -2)                # (BH, nW, Tw, ktok)
        live = key_valid[None, None, None, :] & fsel[:, t, None, None, None]
        logits = torch.where(live, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        s = s * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p @ vt
        m = m_new
    dirty = (acc / s.clamp_min(1e-30)).reshape(BH, nW, T, win, ch)

    logits = q @ win_k.float().transpose(-1, -2)            # (.., T, win, win)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    clean = (p / p.sum(-1, keepdim=True)) @ win_v.float()

    occ = occupancy.reshape(B, nW).to(torch.int32).repeat_interleave(n_head, 0)
    out = torch.where((occ > 0)[:, :, None, None, None], dirty, clean)
    return out.to(win_q.dtype)


def sparse_window_attention(win_q, win_k, win_v, roll_k, roll_v, pool_k,
                            pool_v, roll_valid, occupancy, frame_select,
                            n_head: int):
    """Sparse window attention (layouts in the module docstring), fp32.

    Kernel K5 (`csrc/sparse_window_attention.cu`) replaces
    `propainter_tpu/ops/attention.py:_kernel`. The TPU kernel runs one
    program per (batch*head, window), 64 at 432x240; here a cluster of two
    blocks per (batch*head, window, 64-query tile) streams 32-key tiles
    through an online softmax whose products run on the tensor cores in
    3xTF32 (the tile code K4 uses). A dirty window's pair walks only the
    selected frames and the valid rolled keys, half each, and merges the
    halves, which is exactly what the TPU kernel's -1e9 masking gives
    (their weight underflows to 0); a clean window's pair attends per
    frame, half the rows each. Bound: operations, which scale with
    the number of dirty windows (3 x 4 * T*win * keys * ch FLOPs per dirty
    (window, head), 3 x 4 * T * win^2 * ch per clean one, at the TF32
    tensor-core rate)."""
    if win_q.device.type == "cpu":
        return _sparse_window_attention_plain(
            win_q, win_k, win_v, roll_k, roll_v, pool_k, pool_v, roll_valid,
            occupancy, frame_select, n_head)
    out = _launch(torch.float32, "sparse_window_attention", win_q, win_k,
                  win_v, roll_k, roll_v, pool_k, pool_v, roll_valid,
                  occupancy, frame_select, n_head)
    sparse_window_attention.launches += 1
    return out


sparse_window_attention.launches = 0


def sparse_window_attention_bf16(win_q, win_k, win_v, roll_k, roll_v,
                                 pool_k, pool_v, roll_valid, occupancy,
                                 frame_select, n_head: int):
    """`sparse_window_attention` on bf16 windows, as the TPU kernel
    computes it in the JAX bf16 pipeline: q, k and v upcast to fp32, every
    product and the softmax in fp32, the output rounded to bf16
    (`propainter_tpu/ops/attention.py:51, 62-68, 98-99, 197`); its plain
    version is `_sparse_window_attention_plain`, which upcasts the same way.

    Kernel K5's bf16 form (`sparse_window_attention_bf16` in
    `csrc/sparse_window_attention.cu`, on the wgmma tile of
    `csrc/attention_wgmma.cuh`): one block per (batch*head, window,
    128-query tile), a producer warpgroup gathering the same keys as K5
    by cp.async into a ring of 64-key stages, two consumer warpgroups of
    64 rows. q·kᵀ is one bf16 wgmma pass with fp32 sums (exact products),
    scaled in fp32; p, fp32 in the TPU kernel, goes into P·V as bf16 hi +
    lo (two passes, 16 significant bits). Bound: operations (1.5 x the
    product FLOPs at the bf16 tensor-core rate) where windows are
    dirty."""
    if win_q.device.type == "cpu":
        return _sparse_window_attention_plain(
            win_q, win_k, win_v, roll_k, roll_v, pool_k, pool_v, roll_valid,
            occupancy, frame_select, n_head)
    out = _launch(torch.bfloat16, "sparse_window_attention_bf16", win_q,
                  win_k, win_v, roll_k, roll_v, pool_k, pool_v, roll_valid,
                  occupancy, frame_select, n_head)
    sparse_window_attention_bf16.launches += 1
    return out


sparse_window_attention_bf16.launches = 0


def _launch(dtype, symbol, win_q, win_k, win_v, roll_k, roll_v, pool_k,
            pool_v, roll_valid, occupancy, frame_select, n_head):
    """Checks the windows (all of `dtype`) and launches the C entry
    `symbol` of K5's library; returns the output."""
    _build.require_cuda(win_q, win_k, win_v, roll_k, roll_v, pool_k, pool_v,
                        roll_valid, occupancy, frame_select)
    BH, nW, T, win, ch = win_q.shape
    P = pool_k.shape[2]
    B = BH // n_head
    if ch != 128 or BH != B * n_head or T > 64 or win > 64:
        raise ValueError(f"K5 takes ch = 128, T <= 64 and win <= 64, got "
                         f"{tuple(win_q.shape)} with {n_head} heads")
    if (win_k.shape != win_q.shape or win_v.shape != win_q.shape
            or roll_k.shape != (BH, nW, 4, T, win, ch)
            or roll_v.shape != roll_k.shape
            or pool_k.shape != (BH, T, P, ch) or pool_v.shape != pool_k.shape
            or roll_valid.shape != (4 * win,)
            or occupancy.shape != (B, nW) or frame_select.shape != (B, T)):
        raise ValueError("K5 input shapes do not match the window layout")
    tensors = (win_q, win_k, win_v, roll_k, roll_v, pool_k, pool_v)
    if any(t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16
           for t in tensors):
        raise ValueError(f"{symbol} takes contiguous {dtype} windows, "
                         f"16-byte aligned")
    valid = roll_valid.to(torch.uint8).contiguous()
    occ = occupancy.to(torch.int32).contiguous()
    fsel = frame_select.to(torch.int32).contiguous()
    out = torch.empty_like(win_q)
    fn = _build.function("sparse_window_attention", symbol, 11, 6, 1)
    _build.launch(fn, symbol, win_q, *[t.data_ptr() for t in tensors],
                  valid.data_ptr(), occ.data_ptr(), fsel.data_ptr(),
                  out.data_ptr(), BH, n_head, nW, T, win, P,
                  1.0 / math.sqrt(ch))
    return out
