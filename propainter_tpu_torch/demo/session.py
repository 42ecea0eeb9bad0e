"""Two-step Track -> Inpaint session state for the interactive demo.

Re-implements the reference Gradio app's separate tracking and inpainting
stages (web-demos/hugging_face/app.py:203-262 ``vos_tracking_video`` and
:264-296 ``inpaint_video``) as a gradio-free object so a bad track can be
inspected (painted preview video) and re-done before paying for a full
inpaint, and so the logic is testable without gradio.

Reference semantics preserved:
  * tracking runs from the selected template frame to the optional end
    frame; the full-video mask array keeps zeros outside that range
    (app.py:212-216, 239-246);
  * the preview is the FULL video with the tracked ranges painted and the
    untracked prefix left as the original frames (app.py:231-248);
  * inpainting consumes the FULL video and the full-video mask array, with
    mask ids not in the current dropdown selection zeroed out
    (app.py:272-284) — so tracking once and inpainting different mask
    subsets works without re-tracking.
"""

from __future__ import annotations

import numpy as np

from propainter_tpu_torch.demo.multimask import MultiMaskSession


class TwoStepSession:
    """Holds per-video tracking state between the Track and Inpaint steps."""

    def __init__(self, facade):
        self.facade = facade
        self.multi = MultiMaskSession()
        self.reset([])

    def reset(self, frames):
        """New video uploaded (reference get_frames_from_video state init)."""
        self.frames = [np.asarray(f) for f in frames]
        n = len(self.frames)
        self.masks = [None] * n       # full-video id-labeled masks
        self.painted = list(self.frames)
        self.tracked = False
        self.multi.remove_all()

    # -- app.py vos_tracking_video:203-262 -----------------------------------
    def track(self, selected: list[str], select_frame: int,
              track_end: int | None = None,
              single_mask: np.ndarray | None = None):
        """Track the composed template mask through the video.

        Args:
          selected: dropdown selection (empty -> first mask, app.py:213-214).
          select_frame: template frame index.
          track_end: exclusive end frame (None/0 -> end of video).
          single_mask: fallback template when no masks were Added (the
            reference uses video_state["masks"][select] in that case).
        Returns:
          painted full-video preview frames (list of (H, W, 3) uint8).
        """
        if self.multi.masks:
            template = self.multi.template_mask(
                list(selected) or [self.multi.mask_names[0]])
        elif single_mask is not None:
            template = np.asarray(single_mask).astype(np.uint8)
        else:
            raise ValueError(
                "add at least one mask by clicking the image first")
        end = int(track_end) if track_end else len(self.frames)
        following = self.frames[select_frame:end]
        masks, _, painted = self.facade.generator(following, template)
        self.masks[select_frame:end] = [np.asarray(m) for m in masks]
        self.painted = list(self.frames)
        self.painted[select_frame:end] = [np.asarray(p) for p in painted]
        self.tracked = True
        return self.painted

    # -- app.py inpaint_video:264-296 -----------------------------------------
    def inpaint(self, selected: list[str], **inpaint_kw) -> np.ndarray:
        """Inpaint the full video using the tracked masks, keeping only the
        mask ids currently selected in the dropdown."""
        if not self.tracked:
            raise ValueError("run tracking first (Track button)")
        h, w = self.frames[0].shape[:2]
        masks = np.stack([
            m if m is not None else np.zeros((h, w), np.uint8)
            for m in self.masks])
        if self.multi.masks:
            keep = {n + 1 for n in
                    self.multi._numbers(list(selected)
                                        or [self.multi.mask_names[0]])}
            ids = np.unique(masks)
            for i in ids:
                if i != 0 and int(i) not in keep:
                    masks[masks == i] = 0
        return self.facade.inpaint(np.stack(self.frames), masks,
                                   **inpaint_kw)
