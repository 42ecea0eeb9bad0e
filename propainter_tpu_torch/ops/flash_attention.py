"""Attention for the sparse window attention's full branch (branch A):
softmax(q·kᵀ·scale + key_bias)·v with fp32 logits and softmax.
Counterpart of `propainter_tpu/ops/flash_attention.py`.
"""

from __future__ import annotations

import torch

from propainter_tpu_torch import _build

NEG_INF = -1e9


def _flash_window_attention_plain(q, k, v, key_bias, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_window_attention(q, k, v, key_bias, scale: float):
    """q: (B, G, Tq, ch); k, v: (B, G, Tk, ch); key_bias: (B, Tk) additive
    logit bias shared over the G problems (0 live, -1e9 masked) or None.
    Returns (B, G, Tq, ch).

    Kernel K4 (`csrc/window_attention.cu`) replaces
    `propainter_tpu/ops/flash_attention.py:_kernel`. A problem's K/V
    (2380 x 128 fp32, 1.2 MB each at 432x240) does not fit in shared
    memory, so unlike the TPU kernel it streams K/V in 32-key tiles with an
    online softmax, one block per (problem, 64-query tile); both products
    run on the tensor cores in 3xTF32 (fp32-level error), the softmax in
    fp32, and the (Tq, Tk) logits never reach device memory. Keys past Tk
    are excluded; the bias is applied per key. Bound: operations (3 x 4 *
    Tq * Tk * ch FLOPs per problem at the TF32 tensor-core rate)."""
    if q.device.type == "cpu":
        return _flash_window_attention_plain(q, k, v, key_bias, scale)
    _build.require_cuda(q, k, v, key_bias)
    B, G, Tq, ch = q.shape
    Tk = k.shape[2]
    if ch != 128 or k.shape != (B, G, Tk, ch) or v.shape != k.shape:
        raise ValueError(f"K4 takes ch = 128 and matching k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if key_bias is not None and key_bias.shape != (B, Tk):
        raise ValueError(f"key_bias must be (B, Tk), got "
                         f"{tuple(key_bias.shape)}")
    tensors = (q, k, v) + (() if key_bias is None else (key_bias,))
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("K4 inputs must be contiguous float32")
    out = torch.empty_like(q)
    fn = _build.function("window_attention", "window_attention", 5, 4, 1)
    bias_ptr = None if key_bias is None else key_bias.data_ptr()
    _build.launch(fn, "window_attention", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bias_ptr, out.data_ptr(), B * G, G, Tq, Tk,
                  float(scale))
    flash_window_attention.launches += 1
    return out


flash_window_attention.launches = 0


def _flash_window_attention_bf16_plain(q, k, v, key_bias, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(torch.bfloat16)
    return torch.matmul(p.float(), v.float()).to(torch.bfloat16)


def flash_window_attention_bf16(q, k, v, key_bias, scale: float):
    """`flash_window_attention` on bf16 q, k, v, as the TPU kernel computes
    it in the JAX bf16 pipeline (`flash_attention.py:36-48`): the logits
    q·kᵀ·scale + key_bias and the softmax in fp32, the probabilities
    rounded to bf16, p·v with fp32 sums, the output rounded to bf16.
    key_bias: (B, Tk) fp32 or None. Returns (B, G, Tq, ch) bf16.

    Kernel K4's bf16 form (`window_attention_bf16` in
    `csrc/window_attention.cu`, on the wgmma tile of
    `csrc/attention_wgmma.cuh`): one block per (problem, 128-query tile),
    a producer warpgroup bringing Q, K and V in by TMA (3-D tensor maps
    encoded for each call) into a ring of 128-key stages, two consumer
    warpgroups of 64 rows running both products as one bf16 wgmma pass and
    the online softmax in fp32. It rounds the running, unnormalised
    probabilities and divides at the end, where the TPU kernel normalises
    first: the two differ by a bf16 step. Bound: operations (4 * Tq * Tk *
    ch FLOPs per problem at the bf16 tensor-core rate)."""
    if q.device.type == "cpu":
        return _flash_window_attention_bf16_plain(q, k, v, key_bias, scale)
    _build.require_cuda(q, k, v, key_bias)
    B, G, Tq, ch = q.shape
    Tk = k.shape[2]
    if ch != 128 or k.shape != (B, G, Tk, ch) or v.shape != k.shape:
        raise ValueError(f"K4 takes ch = 128 and matching k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if key_bias is not None and (key_bias.shape != (B, Tk)
                                 or key_bias.dtype != torch.float32
                                 or not key_bias.is_contiguous()):
        raise ValueError("key_bias must be a contiguous (B, Tk) float32 "
                         "tensor")
    if any(t.dtype != torch.bfloat16 or not t.is_contiguous()
           or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K4's bf16 form takes contiguous bfloat16 q, k, v, "
                         "16-byte aligned")
    out = torch.empty_like(q)
    fn = _build.function("window_attention", "window_attention_bf16", 5, 4,
                         1)
    bias_ptr = None if key_bias is None else key_bias.data_ptr()
    _build.launch(fn, "window_attention_bf16", q, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), bias_ptr, out.data_ptr(), B * G, G, Tq, Tk,
                  float(scale))
    flash_window_attention_bf16.launches += 1
    return out


flash_window_attention_bf16.launches = 0
