"""Attention for the sparse window attention's full branch (branch A):
softmax(q·kᵀ·scale + key_bias)·v with fp32 logits and softmax."""

from __future__ import annotations

import torch

NEG_INF = -1e9


def _flash_window_attention_plain(q, k, v, key_bias, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_window_attention(q, k, v, key_bias, scale: float):
    """q (B, G, Tq, ch), k / v (B, G, Tk, ch), key_bias (B, Tk) or None."""
    return _flash_window_attention_plain(q, k, v, key_bias, scale)
