"""Library-style inpainting API (the web demo's ProInpainter facade).
Counterpart of `propainter_tpu/api.py`: numpy frames and masks in,
inpainted uint8 frames out, with the reference's knobs.
"""

from __future__ import annotations

import numpy as np

from propainter_tpu_torch.pipeline import PipelineConfig, ProPainterPipeline
from propainter_tpu_torch.utils.masks import binary_dilation_cross


class ProInpainter:
    def __init__(self, models: dict, precision: str = "fp32", device=None):
        """models: {'raft': RAFT, 'flowcomp': RecurrentFlowCompleteNet,
        'inpaint': InpaintGenerator} with weights loaded. device: None = the
        GPU (raises without one); 'cpu' runs the plain PyTorch versions."""
        self.models = models
        self.precision = precision
        self.device = device
        self._pipelines: dict[tuple, ProPainterPipeline] = {}

    def _pipeline(self, ref_stride, neighbor_length, subvideo_length,
                  raft_iter) -> ProPainterPipeline:
        key = (ref_stride, neighbor_length, subvideo_length, raft_iter)
        pipe = self._pipelines.get(key)
        if pipe is None:
            pipe = ProPainterPipeline(
                self.models["raft"], self.models["flowcomp"],
                self.models["inpaint"],
                PipelineConfig(ref_stride=ref_stride,
                               neighbor_length=neighbor_length,
                               subvideo_length=subvideo_length,
                               raft_iter=raft_iter,
                               precision=self.precision),
                device=self.device)
            self._pipelines[key] = pipe
        return pipe

    def inpaint(self, frames: np.ndarray, masks: np.ndarray,
                ratio: float = 1.0, dilate_radius: int = 4,
                raft_iter: int = 20, subvideo_length: int = 80,
                neighbor_length: int = 10,
                ref_stride: int = 10) -> np.ndarray:
        """frames (T, H, W, 3) uint8; masks (T, H, W) or (T, H, W, 1),
        1 = remove. ratio rescales for processing (sizes floored to
        multiples of 8). Returns (T, H', W', 3) uint8."""
        if masks.ndim == 4:
            masks = masks[..., 0]
        T, H, W = masks.shape
        w = int(W * ratio) // 8 * 8
        h = int(H * ratio) // 8 * 8
        if (w, h) != (W, H):
            import cv2

            frames = np.stack([
                cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                for f in frames])
            masks = np.stack([
                cv2.resize(m.astype(np.uint8), (w, h),
                           interpolation=cv2.INTER_NEAREST) for m in masks])
        flow_masks = np.stack([binary_dilation_cross(m, dilate_radius)
                               for m in masks])
        pipe = self._pipeline(ref_stride, neighbor_length, subvideo_length,
                              raft_iter)
        return np.stack(pipe.inpaint_video(frames, flow_masks, flow_masks))
