"""The four stages of ProPainter inference in plain PyTorch, fp32 (reference
inference_propainter.py): the yardstick the benchmark holds the program's
outputs to. It imports nothing of the program, and takes from it nothing
but the inputs both are handed.

  stage 1  bidirectional RAFT flow, chunked by clip length (by width);
  stage 2  flow completion, chunked by subvideo_length with 5-frame overlap;
  stage 3  image propagation, chunked with 10-frame overlap;
  stage 4  sliding windows through the generator, each with the video's
           reference frames, composited into uint8 frames in window order.

`run` returns every stage's output. Products run with TF32 off. Run under
a mode that rounds every product's operands to a lower precision, the
same code is the benchmark's control.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .flow_completion import RecurrentFlowCompleteNet, complete_flows
from .propainter import InpaintGenerator, image_propagation
from .raft import RAFT


@dataclasses.dataclass
class Config:
    """The inference settings (inference_propainter.py's flags)."""

    ref_stride: int = 10
    neighbor_length: int = 10
    subvideo_length: int = 80
    raft_iter: int = 20


def get_short_clip_len(width: int) -> int:
    """RAFT chunk length by width. Reference
    inference_propainter.py:302-309."""
    if width <= 640:
        return 12
    if width <= 720:
        return 8
    if width <= 1280:
        return 4
    return 2


def get_ref_index(mid_neighbor_id, neighbor_ids, length, ref_stride=10,
                  ref_num=-1):
    """Global reference frames. Reference inference_propainter.py:159-173."""
    ref_index = []
    if ref_num == -1:
        for i in range(0, length, ref_stride):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start_idx = max(0, mid_neighbor_id - ref_stride * (ref_num // 2))
        end_idx = min(length, mid_neighbor_id + ref_stride * (ref_num // 2))
        for i in range(start_idx, end_idx, ref_stride):
            if i not in neighbor_ids:
                if len(ref_index) > ref_num:
                    break
                ref_index.append(i)
    return ref_index


def windows(T: int, cfg: Config) -> list:
    """Stage 4's windows in order: (neighbour frame ids, reference frame
    ids). The reference list is capped at ceil(min(T, subvideo_length) /
    ref_stride) frames."""
    stride = cfg.neighbor_length // 2
    ref_num = (cfg.subvideo_length // cfg.ref_stride
               if T > cfg.subvideo_length else -1)
    ref_cap = max(1, -(-min(T, cfg.subvideo_length) // cfg.ref_stride))
    out = []
    for f in range(0, T, stride):
        nb = list(range(max(0, f - stride), min(T, f + stride + 1)))
        out.append((nb, get_ref_index(f, nb, T, cfg.ref_stride,
                                      ref_num)[:ref_cap]))
    return out


@contextlib.contextmanager
def fp32_products():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls; the previous
    settings restored."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def build_models(device) -> dict:
    """The three models, their parameters as constructed (the caller loads
    the weights), in eval mode on `device`."""
    with torch.device(device):
        models = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
                  "inpaint": InpaintGenerator()}
    return {k: m.eval() for k, m in models.items()}


def _raft_bi(raft, frames, iters: int):
    """frames (1, T, H, W, 3) in [-1, 1] -> (flows_f, flows_b), each (1,
    T-1, H, W, 2): every frame encoded once, the forward pairs (t, t+1)
    and backward pairs (t+1, t) refined in one batch."""
    _, T, H, W, _ = frames.shape
    fmap, net, inp = raft.encode(frames[0].permute(0, 3, 1, 2))
    f1, f2 = fmap[:-1], fmap[1:]
    n1, n2 = net[:-1], net[1:]
    i1, i2 = inp[:-1], inp[1:]
    _, flow = raft.refine(torch.cat([f1, f2]), torch.cat([f2, f1]),
                          torch.cat([n1, n2]), torch.cat([i1, i2]), iters)
    flow = flow.permute(0, 2, 3, 1)
    return (flow[:T - 1].reshape(1, T - 1, H, W, 2),
            flow[T - 1:].reshape(1, T - 1, H, W, 2))


def compute_flows(raft, frames, cfg: Config):
    """Stage 1: chunks of get_short_clip_len(W) frames overlapping by one.
    Reference inference_propainter.py:302-330."""
    T, W = frames.shape[1], frames.shape[3]
    clip = get_short_clip_len(W)
    if T <= clip:
        return _raft_bi(raft, frames, cfg.raft_iter)
    fs, bs = [], []
    for f in range(0, T, clip):
        s = f if f == 0 else f - 1
        ff, fb = _raft_bi(raft, frames[:, s:min(T, f + clip)], cfg.raft_iter)
        fs.append(ff)
        bs.append(fb)
    return torch.cat(fs, dim=1), torch.cat(bs, dim=1)


def _chunks(n: int, sub: int, pad: int) -> list:
    """[(start, end, keep_from, keep_to)] of a stage chunked by `sub` with
    `pad` frames of overlap trimmed (the whole of n when n <= sub)."""
    if n <= sub:
        return [(0, n, 0, n)]
    out = []
    for f in range(0, n, sub):
        s, e = max(0, f - pad), min(n, f + sub + pad)
        out.append((s, e, f - s, e - s - (e - min(n, f + sub))))
    return out


def complete(flowcomp, flows, flow_masks, cfg: Config):
    """Stage 2. Reference inference_propainter.py:341-368."""
    flows_f, flows_b = flows
    pred_f, pred_b = [], []
    for s, e, a, b in _chunks(flows_f.shape[1], cfg.subvideo_length, 5):
        pf, pb = complete_flows(flowcomp, (flows_f[:, s:e], flows_b[:, s:e]),
                                flow_masks[:, s:e + 1])
        pred_f.append(pf[:, a:b])
        pred_b.append(pb[:, a:b])
    return torch.cat(pred_f, dim=1), torch.cat(pred_b, dim=1)


def propagate(frames, flows, masks, cfg: Config):
    """Stage 3. Reference inference_propainter.py:371-404."""
    flows_f, flows_b = flows
    out_f, out_m = [], []
    for s, e, a, b in _chunks(frames.shape[1],
                              min(100, cfg.subvideo_length), 10):
        m = masks[:, s:e]
        masked = frames[:, s:e] * (1 - m)
        prop, upd = image_propagation(masked, flows_f[:, s:e - 1],
                                      flows_b[:, s:e - 1], m)
        out_f.append((masked + prop * m)[:, a:b])
        out_m.append(upd[:, a:b])
    return torch.cat(out_f, dim=1), torch.cat(out_m, dim=1)


def generate(inpaint, updated, flows, masks, updated_masks, ori, cfg: Config):
    """Stage 4. Reference inference_propainter.py:407-452: per window

        img  = floor((pred + 1) / 2 * 255) clipped, inside the mask; the
               original pixel outside it
        comp = img                    on a frame's first visit
        comp = floor(comp/2 + img/2)  on each revisit

    The reference frames' encoder features and tokens are each frame's
    own, so every reference frame of the video is encoded and tokenized
    once. ori (T, H, W, 3) uint8. Returns (T, H, W, 3) uint8."""
    T = updated.shape[1]
    ff, fb = flows
    plan = windows(T, cfg)
    union = sorted({r for _, refs in plan for r in refs})
    row = {r: i for i, r in enumerate(union)}
    ref_feat = inpaint.encode(updated[0, union], masks[0, union],
                              updated_masks[0, union])
    ref_tok = inpaint.tokenize(ref_feat)
    comp = torch.zeros(ori.shape, dtype=torch.float32, device=ori.device)
    visited = [False] * T
    for nb, refs in plan:
        rows = [row[r] for r in refs]
        l_t = len(nb)
        pred = inpaint(updated[:, nb], (ff[:, nb[:-1]], fb[:, nb[:-1]]),
                       masks[:, nb], updated_masks[:, nb], l_t,
                       ref_feat[rows][None], ref_tok[rows][None],
                       torch.ones(1, l_t + len(refs), dtype=torch.bool,
                                  device=ori.device))[0]
        m = masks[0, nb]
        img = torch.floor((pred + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0)
        img = img * m + ori[nb].float() * (1.0 - m)
        for i, t in enumerate(nb):
            comp[t] = (torch.floor(0.5 * comp[t] + 0.5 * img[i])
                       if visited[t] else img[i])
            visited[t] = True
    return comp.to(torch.uint8)


@torch.inference_mode()
def run(models: dict, frames_u8, flow_masks, masks_dilated,
        cfg: Config | None = None) -> dict:
    """frames_u8 (T, H, W, 3) uint8; flow_masks / masks_dilated (T, H, W),
    1 = hole; all on the models' device. Returns each stage's output:
    raft (flows_f, flows_b) (1, T-1, H, W, 2); flow_completion the
    completed pair; image_propagation (frames (1, T, H, W, 3) in [-1, 1],
    masks (1, T, H, W, 1)); frames (T, H, W, 3) uint8."""
    cfg = cfg or Config()
    with fp32_products():
        frames = (frames_u8.float() / 255.0 * 2.0 - 1.0)[None]
        fm = flow_masks.float()[None, ..., None]
        md = masks_dilated.float()[None, ..., None]
        gt = compute_flows(models["raft"], frames, cfg)
        pred = complete(models["flowcomp"], gt, fm, cfg)
        upd, upd_m = propagate(frames, pred, md, cfg)
        comp = generate(models["inpaint"], upd, pred, md, upd_m, frames_u8,
                        cfg)
    return {"raft": gt, "flow_completion": pred,
            "image_propagation": (upd, upd_m), "frames": comp}
