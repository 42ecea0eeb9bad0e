"""End-to-end video inpainting (the reference's 4-stage schedule), in fp32
or bf16. Counterpart of `propainter_tpu/pipeline.py`.

  stage 1  bidirectional RAFT flow, chunked by clip length (by width);
  stage 2  flow completion, chunked by subvideo_length with 5-frame overlap;
  stage 3  image propagation, chunked with 10-frame overlap;
  stage 4  sliding-window generation with capped, padded global reference
           frames and sequential uint8 compositing; consecutive windows of
           equal length run `window_batch` at a time.

`shard_inference` is the JAX package's multi-device layout: RAFT in the
'batched' corr layout and, over a mesh of more than one device
(`parallel.make_mesh`), RAFT's frames and pairs, stage 2-3 chunks and
stage-4 window batches split across it.

precision='bf16' is the JAX package's bf16 pipeline: the flow completion
and the generator run with their parameters cast to bf16 once and their
inputs cast to bf16 (`propainter_tpu/pipeline.py:237-248, 347-442`), in
either attention form; RAFT's parameters stay fp32 and, off the CPU, RAFT
encodes and refines with a bf16 copy of them (`raft_bf16_encode`,
`raft_bf16_refine`, the JAX rule `use_bf16 = ... and backend != "cpu"`,
here `device.type != "cpu"`: the JAX package's own semantics, under which
a CPU run keeps RAFT fp32). Off the CPU RAFT's correlation volume is then
stored in bf16 (`RAFT.corr_volume_dtype`, as
`propainter_tpu/pipeline.py:224-226` sets it), under a bf16 refinement or,
with raft_bf16_refine=False, under an fp32 one. bf16 with shard_inference runs only with
raft_bf16_refine=False: the JAX package cannot refine in bf16 in the
batched corr layout (`RAFT.refine`).

Stage 4 runs the JAX package's schedule (`propainter_tpu/pipeline.py:
658-849`, `plan_stage4`): the reference frames' union is encoded and
tokenized once per video; with `occupancy_bucketing` the windows' dirty
attention windows come back to the host in one readback and branch A runs
on a bucket of them (`plan_bucket_subruns`); with `encoder_carry` a
sub-run of regularly strided single windows encodes only each window's
new frames; the last transformer block computes the local frames' queries
only ('flash'). The JAX tests pin each as output-identical to the plain
schedule, and so do the port's (`tests/test_torch_stage4.py`).

`raft_clip_len` and `unchunked` are the JAX package's evaluation protocol:
a fixed RAFT chunk, and stages 2-3 whole with uncapped references.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time

import numpy as np
import torch

from propainter_tpu_torch.device import resolve_device
from propainter_tpu_torch.models.flow_completion import (
    combine_flow, forward_bidirect_flow)
from propainter_tpu_torch.models.propainter import (
    image_propagation, masked_window_bitmap)
from propainter_tpu_torch.parallel import (
    canonical_device, make_mesh, map_shards, replicate)


def get_short_clip_len(width: int) -> int:
    """RAFT chunk length by width. Reference inference_propainter.py:302-309."""
    if width <= 640:
        return 12
    if width <= 720:
        return 8
    if width <= 1280:
        return 4
    return 2


def equal_chunk_schedule(length: int, n_chunks: int, pad: int
                         ) -> list[tuple[int, int, int, int]] | None:
    """Equal-length overlapping chunks [(start, end, out_start, out_end)]
    with every output frame >= pad frames from its chunk's border (except at
    the video's ends), or None when the video is too short to split."""
    if n_chunks < 2:
        return None
    step = -(-length // n_chunks)
    L = min(length, step + 2 * pad)
    if L >= length:
        return None
    starts = [i * (length - L) // (n_chunks - 1) for i in range(n_chunks)]
    if any(starts[i] + L - starts[i + 1] < 2 * pad
           for i in range(n_chunks - 1)):
        return None
    bounds = ([0]
              + [(starts[i] + starts[i + 1] + L) // 2
                 for i in range(n_chunks - 1)]
              + [length])
    return [(starts[i], starts[i] + L, bounds[i], bounds[i + 1])
            for i in range(n_chunks)]


def plan_bucket_subruns(bm: np.ndarray) -> list[tuple[int, list[int]]]:
    """Split a window run into consecutive same-bucket sub-runs for stage
    4's occupancy bucketing. Copy of `propainter_tpu/pipeline.py:89-122`.

    bm: (n_windows, nW) bool masked-window bitmaps, in execution order.
    Returns [(bucket, [window rows])]: buckets are the per-window masked
    counts rounded up to multiples of 4 (at least 4, at most nW); adjacent
    sub-runs merge greedily while upgrading their windows to the larger
    bucket costs at most two 4-window steps. Execution order is kept (the
    0.5/0.5 revisit average is sequential)."""
    nW = bm.shape[1]
    buckets = np.minimum(-(-bm.sum(axis=1).astype(int) // 4) * 4, nW)
    buckets = np.maximum(buckets, 4)
    subruns: list[tuple[int, list[int]]] = []
    for gi, b in enumerate(buckets):
        if subruns and subruns[-1][0] == b:
            subruns[-1][1].append(gi)
        else:
            subruns.append((int(b), [gi]))

    def upgrade_steps(a, b):
        bm_ = max(a[0], b[0])
        return (len(a[1]) * (bm_ - a[0]) + len(b[1]) * (bm_ - b[0])) // 4

    merged: list[tuple[int, list[int]]] = []
    for sr in subruns:
        while merged and upgrade_steps(merged[-1], sr) <= 2:
            prev = merged.pop()
            sr = (max(prev[0], sr[0]), prev[1] + sr[1])
        merged.append(sr)
    return merged


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


@dataclasses.dataclass
class SubRun:
    """Consecutive stage-4 windows of one length run the same way.

    windows: [(neighbor ids, reference-union rows, frame_valid)], padded
    reference slots at union row 0 and False in frame_valid. bucket: the
    occupancy bucket m_b (None without bucketing); masked: (idx, valid),
    each (n_windows, m_b), when m_b < nW, else None (branch A over every
    window). carry: the encoder carry's stride, or None."""

    l_t: int
    windows: list
    bucket: int | None
    masked: tuple | None
    carry: int | None


@dataclasses.dataclass
class Stage4Plan:
    """The generator calls of one video's stage 4, in order: each sub-run's
    windows, `window_batch` at a time."""

    ref_union: list
    subruns: list
    window_batch: int


@dataclasses.dataclass
class PipelineConfig:
    """Every field of the JAX package's `PipelineConfig`, with its
    defaults."""

    ref_stride: int = 10
    neighbor_length: int = 10
    subvideo_length: int = 80
    raft_iter: int = 20
    precision: str = "fp32"   # 'fp32' | 'bf16'
    # a fixed RAFT chunk length (the JAX package's evaluation protocol
    # chunks by 60); None = the width-based length (get_short_clip_len)
    raft_clip_len: int | None = None
    # the evaluation protocol: stages 2-3 whole-video (no subvideo chunks,
    # no mesh split) and uncapped reference frames
    unchunked: bool = False
    # the generator's sparse window attention: 'flash' (kernel K4 over
    # the dirty windows' bucket, or every window, then the occupancy
    # selects) or 'pallas' (kernel K5 takes each window's branch); the
    # pipeline sets it on its generator when it is built
    attention_impl: str = "flash"
    # stage-4 windows of equal length run this many at a time as one
    # batched generator call; a tail batch is padded by repeating its
    # windows with weight 0, which the compositing skips. The JAX package
    # measured it slower than one window at a time on one chip; it is the
    # unit of multi-device splitting (over a mesh of more than one device,
    # 1 means the mesh size)
    window_batch: int = 1
    # the JAX package's multi-device inference layout: RAFT's lookup in the
    # 'batched' form (kernel K7, then convc1 as one matrix product) and,
    # over a mesh of more than one device, RAFT's frames and pairs, stage
    # 2-3 chunks (equal_chunk_schedule) and stage-4 window batches split
    # across it
    shard_inference: bool = False
    # stage 4: each window's dirty attention windows (masked_window_bitmap,
    # one readback a video) bucketed in multiples of 4; under 'flash'
    # branch A runs on the bucket only (plan_bucket_subruns)
    occupancy_bucketing: bool = True
    # stage 4: with window_batch 1, a sub-run of regularly strided windows
    # encodes only each window's stride new frames and carries the
    # features of the l_t - stride it shares with the previous window
    encoder_carry: bool = True
    # bf16 only, off the CPU: RAFT's refinement, and with it its encoders,
    # in bf16 (see the module docstring); fp32 otherwise
    raft_bf16_refine: bool = True
    raft_bf16_encode: bool = True

    def __post_init__(self):
        if self.precision not in ("fp32", "bf16"):
            raise ValueError(f"precision must be 'fp32' or 'bf16', got "
                             f"{self.precision!r}")


@contextlib.contextmanager
def _fp32_numerics():
    """Full fp32 for convolutions and matmuls on the GPU (cuDNN defaults to
    TF32 for fp32 convolutions); the previous settings are restored."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class ProPainterPipeline:
    """The three models and the four stages.

    raft / flowcomp / inpaint: `RAFT`, `RecurrentFlowCompleteNet`,
    `InpaintGenerator` modules with their weights loaded. They are moved to
    `device` (None = the GPU; without one this raises) and set to eval;
    the generator is switched to the config's `attention_impl` and RAFT to
    the corr layout of `shard_inference` and the volume dtype of
    `precision` (a module shared by two pipelines runs the later one's
    form).

    mesh: the devices `shard_inference` splits over (`parallel.make_mesh`;
    None = every visible GPU, or the CPU once when `device` is the CPU).
    Each distinct device holds a replica of the models; with one device
    nothing is split."""

    def __init__(self, raft, flowcomp, inpaint,
                 config: PipelineConfig | None = None, *, device=None,
                 mesh=None):
        self.config = config or PipelineConfig()
        bf16 = self.config.precision == "bf16"
        if (bf16 and self.config.shard_inference
                and self.config.raft_bf16_refine):
            raise NotImplementedError(
                "precision='bf16' with shard_inference needs "
                "raft_bf16_refine=False: the JAX package cannot refine in "
                "bf16 in the batched corr layout (its convc1, "
                "propainter_tpu/models/raft.py:122, promotes the GRU's bf16 "
                "carry to fp32, which nn.scan refuses)")
        self._dtype = torch.bfloat16 if bf16 else torch.float32
        self.device = canonical_device(resolve_device(device))
        # off the CPU a bf16 run stores RAFT's volume in bf16, whichever
        # module refines (the fp32 one with raft_bf16_refine=False)
        bf16_raft = bf16 and self.device.type != "cpu"
        inpaint.set_attention_impl(self.config.attention_impl)
        raft.corr_layout = ("batched" if self.config.shard_inference
                            else "flat")
        raft.corr_volume_dtype = (
            torch.bfloat16 if bf16_raft and not self.config.raft_bf16_refine
            else torch.float32)
        if not self.config.shard_inference:
            if mesh is not None:
                raise ValueError("a mesh is used only with shard_inference")
            mesh = [self.device]
        elif mesh is None:
            mesh = make_mesh(device=self.device)
        self.mesh = [canonical_device(d) for d in mesh]
        if any(d.type != self.device.type for d in self.mesh):
            raise ValueError(f"mesh {self.mesh} is not on {self.device.type}")
        self._window_batch = max(1, self.config.window_batch)
        if len(self.mesh) > 1 and self.config.window_batch == 1:
            # windows are the unit of multi-device splitting: one a device
            self._window_batch = len(self.mesh)
        self.raft = raft.to(self.device).eval()
        self.flowcomp = flowcomp.to(self.device).eval()
        self.inpaint = inpaint.to(self.device).eval()
        # bf16: the flow completion and the generator run on copies of
        # their parameters cast once (the caller's modules stay fp32); off
        # the CPU RAFT refines, and encodes, on a bf16 copy
        self._raft_bf16 = None
        if bf16:
            self.flowcomp = copy.deepcopy(self.flowcomp).to(torch.bfloat16)
            self.inpaint = copy.deepcopy(self.inpaint).to(torch.bfloat16)
            if bf16_raft and self.config.raft_bf16_refine:
                self._raft_bf16 = copy.deepcopy(self.raft).to(torch.bfloat16)
                self._raft_bf16.corr_volume_dtype = torch.bfloat16
        self._replicas = {name: replicate(getattr(self, name), self.mesh)
                          for name in ("raft", "flowcomp", "inpaint")}

    def _sync(self):
        for dev in set(self.mesh) | {self.device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _sharded(self, model, fn, *tensors):
        """fn(replica of `model` (a name) or None, *tensors) -> a tuple of
        tensors, with the tensors' leading axis split over the mesh when it
        has more than one device (`parallel.map_shards`, gathered on the
        pipeline's device), else one call on the pipeline's own module."""
        if len(self.mesh) == 1:
            return fn(None if model is None else getattr(self, model),
                      *tensors)
        return map_shards(fn, self.mesh, tensors, self.device,
                          None if model is None else self._replicas[model])

    # ---- stages ----------------------------------------------------------

    def _raft_bi(self, frames, iters: int):
        """frames (B, T, H, W, 3) in [-1, 1] -> (flows_f, flows_b), each
        (B, T-1, H, W, 2). Each frame is encoded once; the forward pairs
        (t, t+1) and backward pairs (t+1, t) refine in one batch."""
        B, T, H, W, C = frames.shape
        flat = frames.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
        raft_bf16 = self._raft_bf16
        if raft_bf16 is not None and self.config.raft_bf16_encode:
            fmap, net, inp = raft_bf16.encode(flat, torch.bfloat16)
        else:
            fmap, net, inp = self._sharded(
                "raft", lambda m, x: m.encode(x), flat)

        def pairs(x):
            x = x.reshape(B, T, *x.shape[1:])
            return (x[:, :-1].flatten(0, 1), x[:, 1:].flatten(0, 1))

        (f1, f2), (n1, n2), (i1, i2) = pairs(fmap), pairs(net), pairs(inp)
        features = (torch.cat([f1, f2]), torch.cat([f2, f1]),
                    torch.cat([n1, n2]), torch.cat([i1, i2]))
        if raft_bf16 is not None:
            features = tuple(f.to(torch.bfloat16) for f in features)
            (flow,) = raft_bf16.refine(*features, iters)[1:]
        else:
            (flow,) = self._sharded(
                "raft", lambda m, *a: m.refine(*a, iters)[1:], *features)
        flow = flow.permute(0, 2, 3, 1)
        n = B * (T - 1)
        return (flow[:n].reshape(B, T - 1, H, W, 2),
                flow[n:].reshape(B, T - 1, H, W, 2))

    def compute_flows(self, frames):
        """Stage 1: chunked bidirectional RAFT (chunks overlap by one frame).
        Reference inference_propainter.py:302-330."""
        T, W = frames.shape[1], frames.shape[3]
        clip = self.config.raft_clip_len or get_short_clip_len(W)
        iters = self.config.raft_iter
        if T <= clip:
            return self._raft_bi(frames, iters)
        fs, bs = [], []
        for f in range(0, T, clip):
            s = f if f == 0 else f - 1
            ff, fb = self._raft_bi(frames[:, s:min(T, f + clip)], iters)
            fs.append(ff)
            bs.append(fb)
        return torch.cat(fs, dim=1), torch.cat(bs, dim=1)

    def _complete_flow(self, flows_f, flows_b, flow_masks, flowcomp=None):
        dt = self._dtype
        flows = (flows_f.to(dt), flows_b.to(dt))
        masks = flow_masks.to(dt)
        pred = forward_bidirect_flow(flowcomp or self.flowcomp, flows, masks)
        return combine_flow(flows, pred, masks)

    # ---- multi-device chunk splitting (stages 2 and 3) -------------------

    def _complete_flow_batched(self, chunks):
        cat = [torch.cat([c[i] for c in chunks]) for i in range(3)]
        return self._sharded(
            "flowcomp", lambda m, *a: self._complete_flow(*a, m), *cat)

    def _img_prop_batched(self, chunks):
        cat = [torch.cat([c[i] for c in chunks]) for i in range(4)]
        return self._sharded(None, lambda _, *a: self._img_prop(*a), *cat)

    def _sharded_chunks(self, batched_call, length: int, pad: int,
                        slice_fn):
        """Run a chunked stage as one batched call over equal-length chunks
        (`equal_chunk_schedule`), the chunk axis split over the mesh; the
        chunks are independent up to the pad-frame overlap trim (reference
        inference_propainter.py:341-404). Returns None when the video is
        too short to split, and the caller runs the sequential schedule.

        Quality guard: every chunk keeps at least subvideo_length frames
        of context (the recurrent nets degrade on shorter clips), so the
        video must hold that many chunks, in multiples of the mesh size."""
        n_dev = len(self.mesh)
        n_chunks = (length // self.config.subvideo_length) // n_dev * n_dev
        sched = equal_chunk_schedule(length, n_chunks, pad)
        if sched is None:
            return None
        outs = batched_call([slice_fn(s, e) for s, e, _, _ in sched])
        pieces = [tuple(x[i:i + 1, os - s:oe - s] for x in outs)
                  for i, (s, e, os, oe) in enumerate(sched) if oe > os]
        return tuple(torch.cat(xs, dim=1) for xs in zip(*pieces))

    def complete_flows(self, gt_flows_bi, flow_masks):
        """Stage 2: chunked flow completion with 5-frame overlap trim.
        Reference inference_propainter.py:341-368. Over a mesh of more than
        one device, equal chunks split across it when the video is long
        enough (`_sharded_chunks`); `unchunked` runs the whole video."""
        flows_f, flows_b = gt_flows_bi
        n = flows_f.shape[1]
        sub = self.config.subvideo_length
        unchunked = self.config.unchunked
        if len(self.mesh) > 1 and not unchunked:
            out = self._sharded_chunks(
                self._complete_flow_batched, n, 5,
                lambda s, e: (flows_f[:, s:e], flows_b[:, s:e],
                              flow_masks[:, s:e + 1]))
            if out is not None:
                return out
        if unchunked or n <= sub:
            return self._complete_flow(flows_f, flows_b, flow_masks)
        pred_f, pred_b = [], []
        pad = 5
        for f in range(0, n, sub):
            s, e = max(0, f - pad), min(n, f + sub + pad)
            ps, pe = f - s, e - min(n, f + sub)
            pf, pb = self._complete_flow(flows_f[:, s:e], flows_b[:, s:e],
                                         flow_masks[:, s:e + 1])
            pred_f.append(pf[:, ps:e - s - pe])
            pred_b.append(pb[:, ps:e - s - pe])
        return torch.cat(pred_f, dim=1), torch.cat(pred_b, dim=1)

    def _img_prop(self, frames, flows_f, flows_b, masks):
        dt = self._dtype
        frames, flows_f, flows_b, masks = (
            t.to(dt) for t in (frames, flows_f, flows_b, masks))
        masked = frames * (1 - masks)
        prop, updated = image_propagation(masked, flows_f, flows_b, masks)
        return masked + prop * masks, updated

    def propagate_images(self, frames, pred_flows_bi, masks_dilated):
        """Stage 3: chunked image propagation with 10-frame overlap trim.
        Reference inference_propainter.py:371-404. Split over a mesh, or
        run whole, as stage 2 is."""
        T = frames.shape[1]
        sub = min(100, self.config.subvideo_length)
        flows_f, flows_b = pred_flows_bi
        unchunked = self.config.unchunked
        if len(self.mesh) > 1 and not unchunked:
            out = self._sharded_chunks(
                self._img_prop_batched, T, 10,
                lambda s, e: (frames[:, s:e], flows_f[:, s:e - 1],
                              flows_b[:, s:e - 1], masks_dilated[:, s:e]))
            if out is not None:
                return out
        if unchunked or T <= sub:
            return self._img_prop(frames, flows_f, flows_b, masks_dilated)
        upd_frames, upd_masks = [], []
        pad = 10
        for f in range(0, T, sub):
            s, e = max(0, f - pad), min(T, f + sub + pad)
            ps, pe = f - s, e - min(T, f + sub)
            uf, um = self._img_prop(frames[:, s:e], flows_f[:, s:e - 1],
                                    flows_b[:, s:e - 1],
                                    masks_dilated[:, s:e])
            upd_frames.append(uf[:, ps:e - s - pe])
            upd_masks.append(um[:, ps:e - s - pe])
        return torch.cat(upd_frames, dim=1), torch.cat(upd_masks, dim=1)

    def stage4_plan(self, masks_dilated) -> Stage4Plan:
        """Stage 4's windows and generator calls, as the JAX package plans
        them (`propainter_tpu/pipeline.py:670-841`). masks_dilated (1, T,
        H, W, 1) on the device; with `occupancy_bucketing` each window's
        masked-window bitmap comes back to the host in one readback for
        the whole video (neighbour lists padded to the longest by repeating
        a frame, which leaves the union unchanged)."""
        cfg = self.config
        T = masks_dilated.shape[1]
        stride = cfg.neighbor_length // 2
        ref_num = (cfg.subvideo_length // cfg.ref_stride
                   if not cfg.unchunked and T > cfg.subvideo_length else -1)
        ref_cap = T if cfg.unchunked else min(T, cfg.subvideo_length)
        ref_pad = max(1, -(-ref_cap // cfg.ref_stride))
        specs = []
        for f in range(0, T, stride):
            nb = list(range(max(0, f - stride), min(T, f + stride + 1)))
            specs.append((nb, get_ref_index(f, nb, T, cfg.ref_stride,
                                            ref_num)[:ref_pad]))
        # the union of the truncated lists; a video with no reference keeps
        # one entry for the padded slots
        ref_union = sorted({r for _, refs in specs for r in refs}) or [0]
        pos = {r: i for i, r in enumerate(ref_union)}
        windows = [(nb, [pos[r] for r in refs] + [0] * (ref_pad - len(refs)),
                    [True] * (len(nb) + len(refs))
                    + [False] * (ref_pad - len(refs)))
                   for nb, refs in specs]
        runs = []   # consecutive windows of equal length
        for w in windows:
            if runs and len(runs[-1][0][0]) == len(w[0]):
                runs[-1].append(w)
            else:
                runs.append([w])

        bitmaps = None
        if cfg.occupancy_bucketing:
            l_max = max(len(w[0]) for w in windows)
            nb_all = torch.as_tensor(
                [w[0] + [w[0][-1]] * (l_max - len(w[0])) for w in windows],
                device=masks_dilated.device)
            window = self.inpaint.transformers.transformer[0].attention
            bitmaps = masked_window_bitmap(masks_dilated[0][nb_all],
                                           window.window_size).cpu().numpy()
        wb = self._window_batch
        subruns, row = [], 0
        for run in runs:
            l_t = len(run[0][0])
            parts = [(None, list(range(len(run))))]
            if bitmaps is not None:
                bm = bitmaps[row:row + len(run)]
                parts = plan_bucket_subruns(bm)
            row += len(run)
            for m_b, rows in parts:
                sub = [run[i] for i in rows]
                masked = None
                if m_b is not None and m_b < bm.shape[1]:
                    idx = np.zeros((len(sub), m_b), np.int64)
                    valid = np.zeros((len(sub), m_b), np.bool_)
                    for si, gi in enumerate(rows):
                        dirty = np.nonzero(bm[gi])[0]
                        if len(dirty):
                            # repeats of real dirty windows: repeated
                            # scatter slots write equal values
                            idx[si] = np.resize(dirty, m_b)
                            valid[si] = True
                    masked = (idx, valid)
                carry = None
                if cfg.encoder_carry and wb == 1 and len(sub) > 1:
                    nbs = [w[0] for w in sub]
                    s = nbs[1][0] - nbs[0][0]
                    if 0 < s < l_t and all(
                            nbs[k + 1] == [x + s for x in nbs[k]]
                            for k in range(len(nbs) - 1)):
                        carry = s
                subruns.append(SubRun(l_t, sub, m_b, masked, carry))
        return Stage4Plan(ref_union, subruns, wb)

    def generate(self, updated_frames, pred_flows_bi, masks_dilated,
                 updated_masks, ori_frames):
        """Stage 4: sliding windows through the generator on the plan of
        `stage4_plan`, composited into uint8 frames in window order.
        Reference inference_propainter.py:407-452:

            img  = floor((pred + 1) / 2 * 255) clipped, inside the mask;
                   the original pixel outside it
            comp = img                     on a frame's first visit
            comp = floor(comp/2 + img/2)   on each revisit

        The reference union's features and tokens are computed once and
        gathered per window. Consecutive windows of a sub-run run
        `window_batch` at a time as one generator call with a (batch,
        frames) frame_valid, the batch (with its references' features and
        tokens and its bucket rows) split over the mesh; a tail batch is
        padded by repeating its windows with weight 0, and the compositing
        skips them. A carried sub-run runs one window a call.

        ori_frames: (T, H, W, 3) uint8 tensor on the device. Returns
        (T, H, W, 3) uint8 on the device."""
        _, T, H, W, _ = updated_frames.shape
        plan = self.stage4_plan(masks_dilated)
        dt = self._dtype
        dev = self.device
        uf, md, um = (x[0].to(dt) for x in (updated_frames, masks_dilated,
                                            updated_masks))
        ff, fb = (x[0].to(dt) for x in pred_flows_bi)
        masks_bin = masks_dilated[0]
        gen = self.inpaint

        def encode(ids):
            return gen.encode(uf[ids], md[ids], um[ids])

        ru = torch.as_tensor(plan.ref_union, device=dev)
        ref_feat = encode(ru)
        ref_tok = gen.tokenize(ref_feat)
        comp = torch.zeros((T, H, W, 3), dtype=torch.float32, device=dev)
        visited = torch.zeros(T, dtype=torch.bool)
        ori = ori_frames.float()
        wb = plan.window_batch
        for sr in plan.subruns:
            l_t, s = sr.l_t, sr.carry
            if s:   # the seed: the first window's first l_t - s frames
                carry = encode(torch.as_tensor(sr.windows[0][0][:l_t - s],
                                               device=dev))
            for start in range(0, len(sr.windows), wb):
                rows = list(range(start, min(start + wb, len(sr.windows))))
                n_real = len(rows)
                rows = (rows * wb)[:wb]   # tail: repeats of weight 0
                batch = [sr.windows[i] for i in rows]
                nb, rp, valid = (torch.as_tensor([w[i] for w in batch],
                                                 device=dev)
                                 for i in range(3))
                mw = () if sr.masked is None else tuple(
                    torch.as_tensor(a[rows], device=dev) for a in sr.masked)
                if s:
                    local = torch.cat([carry, encode(nb[0, l_t - s:])])
                    carry = local[s:]
                    pred = gen(None, (ff[nb[:, :-1]], fb[nb[:, :-1]]),
                               md[nb], um[nb], l_t, frame_valid=valid,
                               precomputed_enc_feat=torch.cat(
                                   [local[None], ref_feat[rp]], dim=1),
                               precomputed_ref_tokens=ref_tok[rp],
                               masked_windows=mw or None)
                else:
                    (pred,) = self._sharded(
                        "inpaint", lambda m, x, f_, b_, mi, mu, fv, rf, rt,
                        *mw_: (m(x, (f_, b_), mi, mu, l_t, frame_valid=fv,
                                 precomputed_ref_feat=rf,
                                 precomputed_ref_tokens=rt,
                                 masked_windows=mw_ or None),),
                        uf[nb], ff[nb[:, :-1]], fb[nb[:, :-1]], md[nb],
                        um[nb], valid, ref_feat[rp], ref_tok[rp], *mw)
                img8 = torch.floor((pred.float() + 1.0) / 2.0 * 255.0).clamp(
                    0.0, 255.0)
                for w in range(n_real):
                    for j, t in enumerate(batch[w][0]):
                        m = masks_bin[t]
                        img = img8[w, j] * m + ori[t] * (1.0 - m)
                        if visited[t]:
                            img = torch.floor(0.5 * comp[t] + 0.5 * img)
                        comp[t] = img
                        visited[t] = True
        return comp.to(torch.uint8)

    # ---- whole pipeline --------------------------------------------------

    @torch.inference_mode()
    def inpaint_video(self, frames_np: np.ndarray, flow_masks_np: np.ndarray,
                      masks_dilated_np: np.ndarray,
                      timings: dict | None = None) -> list[np.ndarray]:
        """frames_np (T, H, W, 3) uint8; flow_masks_np / masks_dilated_np
        (T, H, W) bool/uint8, 1 = hole. `timings` receives per-stage wall
        seconds (raft, flow_completion, image_propagation, generation,
        readback), each ending in a device synchronize. Returns a list of
        (H, W, 3) uint8 frames."""
        # Below 128 px the coarsest RAFT level degenerates: pad frames
        # (edge) and masks (zeros, never hole) to 128 and crop the output.
        T0, H0, W0 = frames_np.shape[:3]
        pad_h, pad_w = max(0, 128 - H0), max(0, 128 - W0)
        if pad_h or pad_w:
            frames_np = np.pad(frames_np, ((0, 0), (0, pad_h), (0, pad_w),
                                           (0, 0)), mode="edge")
            flow_masks_np, masks_dilated_np = (
                np.pad(np.asarray(m), ((0, 0), (0, pad_h), (0, pad_w)))
                for m in (flow_masks_np, masks_dilated_np))

        def upload(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint8)
                                    ).to(self.device)

        def timed(key, fn):
            t0 = time.perf_counter()
            out = fn()
            self._sync()
            if timings is not None:
                timings[key] = (timings.get(key, 0.0)
                                + time.perf_counter() - t0)
            return out

        with _fp32_numerics():
            ori = upload(frames_np)
            frames = (ori.float() / 255.0 * 2.0 - 1.0)[None]
            flow_masks = upload(flow_masks_np).float()[None, ..., None]
            masks_dilated = upload(masks_dilated_np).float()[None, ..., None]
            gt_flows = timed("raft", lambda: self.compute_flows(frames))
            pred_flows = timed("flow_completion",
                               lambda: self.complete_flows(gt_flows,
                                                           flow_masks))
            updated_frames, updated_masks = timed(
                "image_propagation",
                lambda: self.propagate_images(frames, pred_flows,
                                              masks_dilated))
            out = timed("generation",
                        lambda: self.generate(updated_frames, pred_flows,
                                              masks_dilated, updated_masks,
                                              ori))
            out_np = timed("readback", lambda: out.cpu().numpy())
        if pad_h or pad_w:
            out_np = out_np[:, :H0, :W0]
        return list(out_np)
