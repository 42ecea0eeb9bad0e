"""Cutie inference engine: working-memory VOS tracking, host-driven.
Counterpart of `propainter_tpu/demo/cutie_core.py`.

The demo's configuration of the reference InferenceCore + MemoryManager
(no long-term memory, mem_every=5, max_mem_frames=5, top_k=30,
stagger_updates=5), with every object registered on the first frame:

  * permanent memory: the first annotated frame's tokens, never evicted;
  * working memory: FIFO over later memory frames, capped at
    (max_mem_frames - 1) frames' worth of tokens;
  * object memory: the object summaries, summed as they stream in;
  * sensory memory: each object's GRU state, updated on staggered frames.

The memory stays on the device as tensors; keys (1, Ck, T), shrinkage
(1, 1, T), values (1, N_obj, Cv, T). Model passes run under
`device.fp32_numerics()`.

On CUDA a step's model passes run as three regions, each replayed from a
CUDA graph per call key (`graphs.StageGraphs`), the counterpart of the
JAX core's six jit sites in their three groups:
  encode  encode_image + transform_key, every frame; key: the padded
          frame's shape;
  read    the top-k memory read, read_first and segment, every frame
          after the first; key: the memory length T (at most
          max_mem_frames distinct values) and update_sensory;
  write   encode_mask, on memory frames; key: the frame's shape and the
          number of objects.
The memory append and FIFO trim, the first frame's softmax and the
transfers stay eager. Each region reads only its arguments and the
model's parameters.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from propainter_tpu_torch.device import fp32_numerics, resolve_device
from propainter_tpu_torch.graphs import StageGraphs
from propainter_tpu_torch.models.cutie import (
    CUTIE, CutieConfig, aggregate, get_similarity, readout, topk_softmax)

# every region is replayed from CUDA graphs by default: the card measured
# each one's graphed median below its eager minimum (`chip_smoke.py` phase
# `track`; PERF.md section 7)
CUTIE_REGIONS = ("encode", "read", "write")


def pad_divide_by(x: np.ndarray, d: int = 16):
    """Center-pad (H, W, ...) to multiples of d
    (reference tracker/utils/tensor_utils.py:7-25)."""
    h, w = x.shape[:2]
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh = (new_h - h) // 2
    uh = new_h - h - lh
    lw = (new_w - w) // 2
    uw = new_w - w - lw
    pad = ((lh, uh), (lw, uw)) + ((0, 0),) * (x.ndim - 2)
    return np.pad(x, pad), (lh, uh, lw, uw)


def unpad(x: np.ndarray, pads):
    lh, uh, lw, uw = pads
    return x[lh : x.shape[0] - uh or None, lw : x.shape[1] - uw or None]


@dataclasses.dataclass
class CutieCoreConfig:
    mem_every: int = 5
    max_mem_frames: int = 5
    top_k: int = 30
    stagger_updates: int = 5


class CutieCore:
    """step(image, mask=None) -> (num_objects+1, H, W) probabilities.

    `cutie` is a `CUTIE` or a state dict with the released keys (a `CUTIE`
    of `model_config` is built for it). `device` defaults to the GPU and
    raises without one; pass "cpu" to run on the CPU.

    cuda_graphs: the regions (of `CUTIE_REGIONS`) replayed from CUDA
    graphs on CUDA; () runs eagerly; no effect on the CPU. The graphs of
    the keys the last track used are kept (`clear_memory` starts a
    track)."""

    def __init__(self, cutie, model_config: CutieConfig | None = None,
                 config: CutieCoreConfig | None = None, device=None,
                 cuda_graphs=CUTIE_REGIONS):
        self.cfg = config or CutieCoreConfig()
        self.device = resolve_device(device)
        self.graphs = StageGraphs(cuda_graphs, CUTIE_REGIONS, self.device)
        if isinstance(cutie, CUTIE):
            model = cutie
        else:
            with torch.device("meta"):
                model = CUTIE(model_config or CutieConfig())
            model.load_state_dict(cutie, strict=True, assign=True)
        self.model = model.to(self.device).eval()
        self.clear_memory()

        # stagger schedule (inference_core.py:36-40)
        if self.cfg.stagger_updates >= self.cfg.mem_every:
            self._stagger_ti = set(range(1, self.cfg.mem_every + 1))
        else:
            self._stagger_ti = set(
                np.round(np.linspace(1, self.cfg.mem_every,
                                     self.cfg.stagger_updates)).astype(int))

    # ---- state -----------------------------------------------------------

    def clear_memory(self):
        self.graphs.begin_video()
        self.curr_ti = -1
        self.last_mem_ti = 0
        self.engaged = False
        self.mem_key = None  # (1, Ck, N_tokens)
        self.mem_shrinkage = None  # (1, 1, N_tokens)
        self.mem_value = None  # (1, N_obj, Cv, N_tokens)
        self.perm_tokens = 0
        self.obj_v = None  # (1, N_obj, Q, C+1) streaming sums
        self.sensory = None  # (1, N_obj, Cs, h, w)
        self.last_mask = None  # (1, N_obj, Hp, Wp)

    # ---- memory ops ------------------------------------------------------

    def _encode(self, image):
        """Region `encode`: (f16, f8, f4, pix_feat, key, shrinkage,
        selection)."""
        (f16, f8, f4), pix_feat = self.model.encode_image(image)
        return (f16, f8, f4, pix_feat) + tuple(self.model.transform_key(f16))

    def _read_visual(self, key, selection, mem_key, mem_shrinkage,
                     mem_value):
        """Each pixel's top-k readout of the memory values:
        (1, N_obj, Cv, h, w)."""
        h, w = key.shape[-2:]
        sim = get_similarity(mem_key, mem_shrinkage, key.flatten(2),
                             selection.flatten(2))
        out = readout(topk_softmax(sim, self.cfg.top_k), mem_value)
        return out.view(out.shape[:3] + (h, w))

    def _read(self, f16, f8, f4, pix_feat, key, selection, mem_key,
              mem_shrinkage, mem_value, sensory, last_mask, obj_v, *,
              update_sensory: bool):
        """Region `read`: the memory read and the segmentation,
        (sensory, prob with background (1, N+1, Hp, Wp))."""
        visual = self._read_visual(key, selection, mem_key, mem_shrinkage,
                                   mem_value)
        mem_readout = self.model.read_first(pix_feat, visual, sensory,
                                            last_mask, obj_v[:, :, None])
        return self.model.segment(f16, f8, f4, mem_readout, sensory,
                                  update_sensory)

    def _add_memory(self, image, pix_feat, prob, key, shrinkage,
                    is_deep_update: bool = True):
        """The memory write: encode the mask, append the tokens, FIFO-trim
        the working memory, sum the object summaries
        (inference_core.py:70-120)."""
        if self.sensory is None:
            h, w = key.shape[-2:]
            self.sensory = torch.zeros(
                (1, prob.shape[1], self.model.config.sensory_dim, h, w),
                device=self.device)
        value, sensory, summaries = self.graphs(
            "write", self.model.encode_mask,
            (image, pix_feat, self.sensory, prob))
        if is_deep_update:
            self.sensory = sensory

        kf = key.flatten(2)
        sf = shrinkage.flatten(2)
        vf = value.flatten(3)
        if self.mem_key is None:
            self.mem_key, self.mem_shrinkage, self.mem_value = kf, sf, vf
            self.perm_tokens = kf.shape[-1]  # as_permanent='first'
        else:
            self.mem_key = torch.cat([self.mem_key, kf], -1)
            self.mem_shrinkage = torch.cat([self.mem_shrinkage, sf], -1)
            self.mem_value = torch.cat([self.mem_value, vf], -1)
            # FIFO trim of the non-permanent tokens to (max_mem_frames - 1)
            # frames' worth (memory_manager.py:38, :230: the permanent
            # first frame does not count)
            hw = key.shape[-2] * key.shape[-1]
            max_work = (self.cfg.max_mem_frames - 1) * hw
            excess = (self.mem_key.shape[-1] - self.perm_tokens) - max_work
            if excess > 0:
                p = self.perm_tokens

                def keep(x):
                    return torch.cat([x[..., :p], x[..., p + excess:]], -1)

                self.mem_key = keep(self.mem_key)
                self.mem_shrinkage = keep(self.mem_shrinkage)
                self.mem_value = keep(self.mem_value)

        # streaming object-summary sum (memory_manager.py:246-268)
        self.obj_v = summaries if self.obj_v is None else (self.obj_v
                                                           + summaries)
        self.engaged = True
        self.last_mem_ti = self.curr_ti

    # ---- main step -------------------------------------------------------

    @torch.no_grad()
    def step(self, image: np.ndarray, mask: Optional[np.ndarray] = None
             ) -> np.ndarray:
        """image (H, W, 3) uint8/float; mask (N_obj, H, W) binary on the
        first (annotation) frame, None afterwards.
        Returns (N_obj+1, H, W) probabilities (channel 0 = background)."""
        self.curr_ti += 1
        img = np.asarray(image, np.float32)
        if img.max() > 1.5:
            img = img / 255.0
        img_p, pads = pad_divide_by(img, 16)
        image_t = torch.from_numpy(np.ascontiguousarray(
            img_p.transpose(2, 0, 1)))[None].to(self.device)

        is_mem_frame = ((self.curr_ti - self.last_mem_ti >= self.cfg.mem_every)
                        or (mask is not None))
        need_segment = mask is None
        update_sensory = ((self.curr_ti - self.last_mem_ti)
                          in self._stagger_ti)

        with fp32_numerics():
            f16, f8, f4, pix_feat, key, shrinkage, selection = self.graphs(
                "encode", self._encode, (image_t,))

            if need_segment:
                assert self.engaged, "call step(image, mask) first"
                sensory, prob_with_bg = self.graphs(
                    "read", functools.partial(self._read,
                                              update_sensory=update_sensory),
                    (f16, f8, f4, pix_feat, key, selection, self.mem_key,
                     self.mem_shrinkage, self.mem_value, self.sensory,
                     self.last_mask, self.obj_v),
                    (update_sensory,))
                if update_sensory:
                    self.sensory = sensory
                pred_prob_with_bg = prob_with_bg[0]  # (N+1, Hp, Wp)
            else:
                m, _ = pad_divide_by(
                    np.moveaxis(np.asarray(mask, np.float32), 0, -1), 16)
                m = torch.from_numpy(np.ascontiguousarray(
                    np.moveaxis(m, -1, 0))).to(self.device)
                logits = aggregate(m[None], dim=1)[0]
                pred_prob_with_bg = torch.softmax(logits, dim=0)

            self.last_mask = pred_prob_with_bg[None, 1:]  # (1, N, Hp, Wp)

            if is_mem_frame:
                self._add_memory(image_t, pix_feat, self.last_mask, key,
                                 shrinkage, is_deep_update=True)

        out = np.moveaxis(pred_prob_with_bg.cpu().numpy(), 0, -1)
        out = unpad(out, pads)
        return np.moveaxis(out, -1, 0)
