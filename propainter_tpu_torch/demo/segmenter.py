"""Interactive SAM predictor: the demo's first-frame segmenter.
Counterpart of `propainter_tpu/demo/segmenter.py`.

The image embedding (the ViT pass) is computed once per image and stays on
the device; every click runs only the prompt encoder and the mask decoder.
Prompts are padded with SAM's "not a point" embedding (label -1): exactly
one pad point by default, the reference SamPredictor's scheme, or, with
`points_bucket=k`, up to k tokens (the extra pad tokens take part in the
decoder's attention and move the masks slightly). Masks are upsampled
(256 -> 1024 -> the original size) on the device with the port's
`ops.interp.resize`. Model passes run under `device.fp32_numerics()`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from propainter_tpu_torch.device import fp32_numerics, resolve_device
from propainter_tpu_torch.models.sam import (
    SAM_PIXEL_MEAN, SAM_PIXEL_STD, Sam, SamConfig, sam_config_registry)
from propainter_tpu_torch.ops.interp import resize


class SamSegmenter:
    """`BaseSegmenter`-compatible promptable segmentation: `set_image`,
    `reset_image`, `predict(prompts, mode, multimask)` returning (masks
    (n, H, W) bool, scores (n,), logits (n, 256, 256)).

    `sam` is a `Sam` or a state dict with the released keys (a `Sam` of
    `model_type`, or of `config`, is built for it). `device` defaults to the
    GPU and raises without one; pass "cpu" to run on the CPU."""

    def __init__(self, sam, model_type: str = "vit_h",
                 points_bucket: Optional[int] = None,
                 config: Optional[SamConfig] = None, device=None):
        self.device = resolve_device(device)
        if isinstance(sam, Sam):
            model = sam
        else:
            with torch.device("meta"):
                model = Sam(config or sam_config_registry[model_type]())
            model.load_state_dict(sam, strict=True, assign=True)
        self.model = model.to(self.device).eval()
        self.config = model.config
        self.points_bucket = points_bucket
        self.embedded = False
        self._embedding = None
        self.orignal_image: Optional[np.ndarray] = None  # sic (reference)

    # -- image embedding ----------------------------------------------------

    @staticmethod
    def _preprocess_shape(h: int, w: int, long_side: int) -> tuple[int, int]:
        """ResizeLongestSide.get_preprocess_shape."""
        scale = long_side / max(h, w)
        return (int(h * scale + 0.5), int(w * scale + 0.5))

    @torch.no_grad()
    def set_image(self, image: np.ndarray):
        """image (H, W, 3) uint8 RGB. Embeds once; repeat calls are no-ops
        until reset_image (reference BaseSegmenter.set_image:31-40)."""
        if self.embedded:
            print("repeat embedding, please reset_image.")
            return
        self.orignal_image = image
        cfg = self.config
        H, W = image.shape[:2]
        nh, nw = self._preprocess_shape(H, W, cfg.img_size)
        import cv2

        resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
        x = (resized.astype(np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
        pad = np.zeros((cfg.img_size, cfg.img_size, 3), np.float32)
        pad[:nh, :nw] = x
        x = torch.from_numpy(pad).permute(2, 0, 1)[None].to(self.device)
        with fp32_numerics():
            self._embedding = self.model.encode_image(x)
        self.original_size = (H, W)
        self.input_size = (nh, nw)
        self.embedded = True

    def reset_image(self):
        self._embedding = None
        self.embedded = False

    # -- prompting ----------------------------------------------------------

    def _pack_points(self, coords, labels):
        """Click coords scaled into the model frame and padded with label -1
        (SAM's not-a-point embedding): exactly one pad token by default,
        or up to `points_bucket`. Returns ((1, n, 2) float32, (1, n)
        int32) tensors on the segmenter's device."""
        n = 0 if coords is None else len(coords)
        if self.points_bucket is None:
            bucket = n + 1
        else:
            bucket = max(self.points_bucket, n + 1)
        c = np.zeros((1, bucket, 2), np.float32)
        l = np.full((1, bucket), -1, np.int32)
        if n:
            scale_h = self.input_size[0] / self.original_size[0]
            scale_w = self.input_size[1] / self.original_size[1]
            c[0, :n, 0] = np.asarray(coords, np.float32)[:, 0] * scale_w
            c[0, :n, 1] = np.asarray(coords, np.float32)[:, 1] * scale_h
            l[0, :n] = np.asarray(labels, np.int32)
        return (torch.from_numpy(c).to(self.device),
                torch.from_numpy(l).to(self.device))

    @torch.no_grad()
    def predict(self, prompts: dict, mode: str, multimask: bool = True):
        """Reference BaseSegmenter.predict:47-78.

        prompts keys: 'point_coords' (N, 2), 'point_labels' (N,),
        'mask_input' (1, 256, 256) logits. mode: 'point' | 'mask' | 'both'.
        Returns (masks (n, H, W) bool, scores (n,), logits (n, 256, 256)).
        """
        assert self.embedded, \
            "prediction is called before set_image (feature embedding)."
        assert mode in ("point", "mask", "both"), \
            "mode must be point, mask, or both"
        use_points = mode in ("point", "both")
        coords, labels = self._pack_points(
            prompts.get("point_coords") if use_points else None,
            prompts.get("point_labels") if use_points else None)
        mask_input = None
        if mode in ("mask", "both"):
            mi = np.array(prompts["mask_input"], np.float32)
            mask_input = torch.from_numpy(mi)[:, None].to(self.device)
        with fp32_numerics():
            low_res, iou = self.model.decode(self._embedding, coords, labels,
                                             mask_input)
        sl = slice(1, None) if multimask else slice(0, 1)
        low_res = low_res[0, sl]    # (n, 256, 256)
        iou = iou[0, sl]
        masks = self._postprocess(low_res)
        return ((masks > 0.0).cpu().numpy(), iou.cpu().numpy(),
                low_res.cpu().numpy())

    def _postprocess(self, low_res):
        """SamPredictor postprocess_masks: 256 -> img_size, crop the
        unpadded region, -> original size."""
        cfg = self.config
        x = resize(low_res[..., None], (cfg.img_size, cfg.img_size))
        x = x[:, : self.input_size[0], : self.input_size[1]]
        x = resize(x, self.original_size)
        return x[..., 0]


class SamControler:
    """first_frame_click facade (reference tools/interact_tools.py:33-80):
    one call = embed (if needed) + predict + pick the best mask."""

    def __init__(self, segmenter: SamSegmenter):
        self.sam_controler = segmenter

    def first_frame_click(self, image: np.ndarray, points: np.ndarray,
                          labels: np.ndarray, multimask: bool = True,
                          box=None, mask_color: int = 3):
        """Returns (mask (H, W) uint8, logit (H, W) float32, painted).

        Matches the reference SamControler.first_frame_click
        (interact_tools.py:46-90): the dense-prompt refine pass ('both')
        runs only when the LAST click is positive, and the painted preview
        overlays the mask plus positive/negative click dots with the
        reference's palette indices."""
        from propainter_tpu_torch.demo.painters import (
            mask_painter, point_painter)

        seg = self.sam_controler
        if not seg.embedded:
            seg.set_image(image)
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        labs = np.asarray(labels, np.int32).reshape(-1)
        if box is not None:
            # box corners use SAM's corner embeddings (labels 2/3)
            x0, y0, x1, y1 = [float(v) for v in box]
            pts = np.concatenate(
                [pts, np.array([[x0, y0], [x1, y1]], np.float32)], 0)
            labs = np.concatenate([labs, np.array([2, 3], np.int32)])
        prompts = {"point_coords": pts, "point_labels": labs}
        masks, scores, logits = seg.predict(prompts, "point", multimask)
        best = int(np.argmax(scores))
        if labs[-1] == 1:
            # refine with the best mask as a dense prompt
            # (interact_tools.py:54-68)
            prompts["mask_input"] = logits[best][None]
            masks, scores, logits = seg.predict(prompts, "both", multimask)
            best = int(np.argmax(scores))
        mask = masks[best].astype(np.uint8)
        logit_full = resize(
            torch.from_numpy(logits[best][..., None]).to(seg.device),
            seg.original_size)[..., 0].cpu().numpy()
        # reference paint constants (interact_tools.py:18-27)
        painted = mask_painter(image.copy(), mask, mask_color, 0.7, 2, 5)
        pos = pts[labs == 1].astype(int)   # box corners (2/3) aren't dots
        neg = pts[labs == 0].astype(int)
        if len(pos):
            painted = point_painter(painted, pos, 8, 0.9, 15, 2, 5)
        if len(neg):
            painted = point_painter(painted, neg, 50, 0.9, 15, 2, 5)
        return mask, logit_full.astype(np.float32), painted
