"""Segment -> track -> inpaint facade for interactive object removal.
Counterpart of `propainter_tpu/demo/tracking.py`.

  * ClickSegmenter — first-frame mask from clicks / a box via cv2 GrabCut
    (the weight-free stand-in for SAM; a copy of the JAX package's);
  * FlowMaskTracker — propagates the first-frame mask by warping it with
    the port's RAFT flow (K2 once and K1 `raft_iter` times a frame pair),
    gated by forward-backward consistency, re-anchored by GrabCut on the
    host (the weight-free stand-in for Cutie);
  * CutieTracker — memory-based VOS tracking with the port's Cutie
    (models/cutie.py + demo/cutie_core.py);
  * TrackingFacade — SAM or GrabCut, Cutie or the flow tracker, and
    `api.ProInpainter`, chosen by which weights are present, as the
    reference TrackingAnything composes them;
  * load_demo_models — the inpainting models plus the demo's optional SAM
    and Cutie checkpoints.

Model passes run on the GPU unless the caller passes `device="cpu"`, and
raise without one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from propainter_tpu_torch.device import fp32_numerics, resolve_device


class ClickSegmenter:
    """First-frame interactive segmentation via GrabCut.

    API mirrors the reference SamControler facade
    (web-demos/hugging_face/tools/interact_tools.py): positive/negative
    points (labels 1/0) and an optional box seed the foreground model.
    """

    def __init__(self, iterations: int = 5, seed_radius: int = 12):
        self.iterations = iterations
        self.seed_radius = seed_radius

    def first_frame_click(
        self,
        image: np.ndarray,
        points: np.ndarray,
        labels: np.ndarray,
        box: Sequence[int] | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """
        Args:
          image: (H, W, 3) uint8 RGB.
          points: (N, 2) [x, y] click coordinates.
          labels: (N,) 1 = foreground, 0 = background.
          box: optional [x0, y0, x1, y1] bounding box.
        Returns:
          (mask (H, W) uint8, logit (H, W) float32 soft mask, painted image).
        """
        import cv2

        H, W = image.shape[:2]
        gc_mask = np.full((H, W), cv2.GC_PR_BGD, np.uint8)
        if box is not None:
            x0, y0, x1, y1 = [int(v) for v in box]
            gc_mask[:] = cv2.GC_BGD
            gc_mask[y0:y1, x0:x1] = cv2.GC_PR_FGD
        for (x, y), lab in zip(np.asarray(points, int),
                               np.asarray(labels, int)):
            val = cv2.GC_FGD if lab == 1 else cv2.GC_BGD
            cv2.circle(gc_mask, (int(x), int(y)), self.seed_radius, int(val),
                       -1)
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        bgr = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
        try:
            cv2.grabCut(bgr, gc_mask, None, bgd, fgd, self.iterations,
                        cv2.GC_INIT_WITH_MASK)
        except cv2.error:
            # degenerate seeds (e.g. all-foreground): fall back to the seeds
            pass
        mask = ((gc_mask == cv2.GC_FGD) | (gc_mask == cv2.GC_PR_FGD)).astype(
            np.uint8)
        logit = cv2.GaussianBlur(mask.astype(np.float32), (9, 9), 0)
        return mask, logit, paint_mask(image, mask)


class FlowMaskTracker:
    """Video object mask tracking by optical-flow warping with
    forward-backward consistency gating and appearance re-anchoring.

    Per frame:
      1. warp the running mask with backward RAFT flow
         (mask_t = mask_{t-1} sampled at x + flow_{t->t-1}(x));
      2. gate by fb-consistency (|f_bwd + warp(f_fwd)| small): inconsistent
         pixels (occlusions, disocclusions) keep a soft vote instead of a
         hard one;
      3. re-anchor appearance with GrabCut seeded from the warped mask
         (eroded core = FG, dilated complement = BG), falling back to the
         flow mask when GrabCut degenerates.

    The flow is RAFT's in fp32 on one pair batch of 2 (a -> b and b -> a):
    K2 once and K1 `raft_iter` times a frame. Frames whose sides are not
    multiples of 8 (DAVIS's 480x854) are edge-padded to them for RAFT and
    the flows cropped back; the JAX tracker runs RAFT on the frame as it
    is, and there RAFT's stride-8 flow comes back wider than the mask
    (856 for 854) and the warp fails.
    """

    def __init__(self, raft=None, raft_iter: int = 20,
                 threshold: float = 0.5, close_kernel: int = 5,
                 reanchor: bool = True, flow_fn=None,
                 fb_alpha1: float = 0.01, fb_alpha2: float = 0.5,
                 device=None):
        """raft: a `RAFT` or a state dict with raft-things.pth's keys; the
        tracker runs its own fp32 copy ('flat' lookup, fp32 volume), so a
        pipeline sharing the module cannot change its kernels.
        flow_fn: optional override `(frame_a, frame_b) -> (H, W, 2)` pixel
        flow a->b (e.g. a classical estimator for weight-free
        environments); when given, raft is unused. device: None = the GPU
        (raises without one); 'cpu' runs the plain PyTorch versions."""
        self.device = resolve_device(device)
        self.raft_iter = raft_iter
        self.threshold = threshold
        self.close_kernel = close_kernel
        self.reanchor = reanchor
        self.fb_alpha1 = fb_alpha1
        self.fb_alpha2 = fb_alpha2

        if flow_fn is not None:
            self._pair_flows = lambda a, b: (flow_fn(a, b), flow_fn(b, a))
        else:
            assert raft is not None
            from propainter_tpu_torch.models.raft import RAFT

            sd = (raft.state_dict() if isinstance(raft, torch.nn.Module)
                  else raft)
            self.raft = RAFT()
            self.raft.load_state_dict(sd, strict=True)
            self.raft = self.raft.to(self.device).eval()
            self._pair_flows = self._raft_pair
        self._prev_frame: np.ndarray | None = None
        self._mask: np.ndarray | None = None

    @torch.no_grad()
    def _raft_pair(self, a8: np.ndarray, b8: np.ndarray):
        """Pixel flows a -> b and b -> a, (H, W, 2) each, one RAFT call."""
        H, W = a8.shape[:2]
        pad = ((0, -H % 8), (0, -W % 8), (0, 0))
        a, b = (torch.from_numpy(np.pad(x, pad, mode="edge")[None].astype(
            np.float32) / 255 * 2 - 1).to(self.device) for x in (a8, b8))
        with fp32_numerics():
            flow = self.raft(torch.cat([a, b]), torch.cat([b, a]),
                             iters=self.raft_iter)[1]
        f = flow[:, :H, :W].cpu().numpy()
        return f[0], f[1]

    def _gate(self, mask, flow_ab, flow_ba):
        """Warp the mask along a->b flow and fb-consistency-gate it
        (reference model/propainter.py:22-31 fbConsistencyCheck)."""
        from propainter_tpu_torch.ops.warp import flow_warp

        fab = flow_ab[None]
        fba = flow_ba[None]
        fwd_at_a = flow_warp(fba, fab, "bilinear")
        err = torch.sum(torch.square(fab + fwd_at_a), -1, keepdim=True)
        mag = (torch.sum(torch.square(fab), -1, keepdim=True)
               + torch.sum(torch.square(fwd_at_a), -1, keepdim=True))
        valid = (err < self.fb_alpha1 * mag + self.fb_alpha2).float()
        soft = flow_warp(mask[None, ..., None], fab, "bilinear")
        return soft[0, ..., 0], valid[0, ..., 0]

    def clear_memory(self):
        """Reset tracking state (reference BaseTracker.clear_memory)."""
        self._prev_frame = None
        self._mask = None

    def _grabcut_refine(self, frame: np.ndarray,
                        mask: np.ndarray) -> np.ndarray:
        """Appearance re-anchor: GrabCut seeded by the flow-warped mask."""
        import cv2

        area = int(mask.sum())
        if area < 16:
            return mask
        r = max(3, int(np.sqrt(area) * 0.15))
        k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1,) * 2)
        core = cv2.erode(mask, k)
        halo = cv2.dilate(mask, k)
        if core.sum() == 0:
            core = mask
        gc = np.full(mask.shape, cv2.GC_BGD, np.uint8)
        gc[halo > 0] = cv2.GC_PR_BGD
        gc[mask > 0] = cv2.GC_PR_FGD
        gc[core > 0] = cv2.GC_FGD
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        bgr = frame[..., ::-1].copy()
        try:
            cv2.grabCut(bgr, gc, None, bgd, fgd, 3, cv2.GC_INIT_WITH_MASK)
        except cv2.error:
            return mask
        ref = ((gc == cv2.GC_FGD) | (gc == cv2.GC_PR_FGD)).astype(np.uint8)
        # sanity: reject blow-ups/collapses (textureless scenes confuse the
        # color model) and keep the flow answer instead
        if not (0.3 * area <= ref.sum() <= 2.5 * area):
            return mask
        return ref

    @torch.no_grad()
    def track(self, frame: np.ndarray, first_frame_annotation=None):
        """Track one frame. First call must pass the template mask.

        Args:
          frame: (H, W, 3) uint8.
          first_frame_annotation: (H, W) mask on the first call.
        Returns:
          (mask (H, W) uint8, logit (H, W) float32, painted image) — the
          reference BaseTracker.track return shape.
        """
        import cv2

        if first_frame_annotation is not None:
            self._mask = (np.asarray(first_frame_annotation) > 0).astype(
                np.uint8)
            self._prev_frame = frame
            logit = self._mask.astype(np.float32)
            return self._mask, logit, paint_mask(frame, self._mask)

        assert self._mask is not None, "call track(frame, template) first"
        flow_ab, flow_ba = self._pair_flows(frame, self._prev_frame)
        soft, valid = self._gate(
            *(torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
              for x in (self._mask, flow_ab, flow_ba)))
        soft_np = soft.cpu().numpy()
        valid_np = valid.cpu().numpy()
        # consistent pixels vote hard; occluded ones keep a weaker vote so
        # the object is not eaten frame-by-frame at motion boundaries
        score = soft_np * (0.5 + 0.5 * valid_np)
        mask = (score > self.threshold * 0.5).astype(np.uint8)
        if self.close_kernel:
            k = cv2.getStructuringElement(
                cv2.MORPH_ELLIPSE, (self.close_kernel, self.close_kernel))
            mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, k)
        if self.reanchor:
            mask = self._grabcut_refine(frame, mask)
        self._mask = mask
        self._prev_frame = frame
        return mask, soft_np, paint_mask(frame, mask)


class CutieTracker:
    """Memory-based VOS tracking with the port's Cutie — the reference
    BaseTracker's per-frame track() API (id-label masks in and out).

    cutie: a `CUTIE` or a state dict with cutie-base-mega.pth's keys
    (`load_cutie_state_dict`); core_kwargs: `CutieCoreConfig` fields."""

    def __init__(self, cutie, model_config=None, device=None,
                 **core_kwargs):
        from propainter_tpu_torch.demo.cutie_core import (
            CutieCore, CutieCoreConfig)

        self._core = CutieCore(
            cutie, model_config=model_config,
            config=CutieCoreConfig(**core_kwargs) if core_kwargs else None,
            device=device)
        self._labels: list[int] | None = None

    def clear_memory(self):
        self._core.clear_memory()
        self._labels = None

    def track(self, frame: np.ndarray, first_frame_annotation=None):
        """frame (H, W, 3) uint8; first_frame_annotation (H, W) int labels
        on the first call (0 = background). Returns (mask, logit, painted)
        like the reference BaseTracker.track."""
        if first_frame_annotation is not None:
            ann = np.asarray(first_frame_annotation)
            # MaskMapper equivalent (tracker/utils/mask_mapper.py): split an
            # id-mask into per-object binary channels
            self._labels = [int(v) for v in np.unique(ann) if v != 0]
            if not self._labels:
                self._labels = [1]
            masks = np.stack([(ann == l).astype(np.float32)
                              for l in self._labels])
            prob = self._core.step(frame, masks)
        else:
            assert self._labels is not None, "seed with an annotation first"
            prob = self._core.step(frame)
        idx = np.argmax(prob, axis=0)  # 0 = background
        mask = np.zeros(idx.shape, np.uint8)
        for i, l in enumerate(self._labels):
            mask[idx == i + 1] = l
        logit = 1.0 - prob[0]
        return mask, logit.astype(np.float32), paint_mask(frame, mask)


class TrackingFacade:
    """Compose segmenter + tracker + inpainter.

    Mirrors reference TrackingAnything (track_anything.py:9-35):
    `first_frame_click` seeds a mask, `generator` tracks it through all
    frames, `inpaint` removes the object. `models` holds 'raft', 'flowcomp'
    and 'inpaint' modules, and optionally 'sam' and 'cutie' state dicts:
    with 'sam' the segmenter is SAM's (`SamControler`), else GrabCut's;
    with 'cutie' the tracker is `CutieTracker`, else `FlowMaskTracker` on
    the RAFT. device: None = the GPU (raises without one); 'cpu' runs the
    plain PyTorch versions."""

    def __init__(self, models: dict, segmenter=None, tracker=None,
                 precision: str = "bf16", sam_model_type: str = "vit_h",
                 device=None):
        from propainter_tpu_torch.api import ProInpainter

        self.device = resolve_device(device)
        if segmenter is None:
            if models.get("sam") is not None:
                from propainter_tpu_torch.demo.segmenter import (
                    SamControler, SamSegmenter)

                segmenter = SamControler(SamSegmenter(
                    models["sam"], model_type=sam_model_type,
                    device=self.device))
            else:
                segmenter = ClickSegmenter()
        self.segmenter = segmenter
        if tracker is None:
            tracker = (CutieTracker(models["cutie"], device=self.device)
                       if models.get("cutie") is not None
                       else FlowMaskTracker(models["raft"],
                                            device=self.device))
        self.tracker = tracker
        self.inpainter = ProInpainter(models, precision=precision,
                                      device=self.device)

    def first_frame_click(self, image, points, labels, box=None):
        return self.segmenter.first_frame_click(image, points, labels,
                                                box=box)

    def generator(self, images: Sequence[np.ndarray],
                  template_mask: np.ndarray):
        """Track template_mask through images.
        Returns (masks, logits, painted_images) like the reference."""
        masks, logits, painted = [], [], []
        self.tracker.clear_memory()
        for i, img in enumerate(images):
            m, l, p = self.tracker.track(
                img, template_mask if i == 0 else None)
            masks.append(m)
            logits.append(l)
            painted.append(p)
        return masks, logits, painted

    def inpaint(self, frames: np.ndarray, masks: np.ndarray, **kw):
        return self.inpainter.inpaint(np.asarray(frames), np.asarray(masks),
                                      **kw)


def load_demo_models(weights_dir: str) -> tuple[dict, str]:
    """The inpainting models of `cli.inference.load_models` plus the demo's
    optional segmenter and tracker checkpoints (sam_vit_*.pth and
    cutie-base-mega.pth beside the ProPainter weights, as the reference
    demo downloads them).

    Returns (models, sam_model_type): 'raft', 'flowcomp', 'inpaint'
    modules, and 'sam' / 'cutie' state dicts where their files are present
    (without them the facade falls back to GrabCut and the flow tracker).
    """
    import glob
    import os

    from propainter_tpu_torch.cli.inference import load_models

    models = dict(load_models(weights_dir))
    sam_type = "vit_h"
    if weights_dir != "random":
        cutie = os.path.join(weights_dir, "cutie-base-mega.pth")
        if os.path.exists(cutie):
            from propainter_tpu_torch.models.cutie import (
                load_cutie_state_dict)

            models["cutie"] = load_cutie_state_dict(cutie)
        sams = sorted(glob.glob(os.path.join(weights_dir, "sam_vit_*.pth")))
        if sams:
            from propainter_tpu_torch.models.sam import load_sam_state_dict

            name = os.path.basename(sams[-1])
            for t in ("vit_b", "vit_l", "vit_h"):
                if name.startswith(f"sam_{t}"):
                    sam_type = t
            models["sam"] = load_sam_state_dict(sams[-1], sam_type)
    return models, sam_type


def paint_mask(image: np.ndarray, mask: np.ndarray,
               color=(255, 63, 63), alpha: float = 0.5) -> np.ndarray:
    """Overlay a mask on an image (reference tools/painter.py behavior)."""
    out = image.astype(np.float32).copy()
    m = (np.asarray(mask) > 0)[..., None].astype(np.float32)
    out = out * (1 - m * alpha) + np.asarray(color, np.float32) * m * alpha
    return out.astype(np.uint8)
