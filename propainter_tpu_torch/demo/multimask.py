"""Multi-mask session state for the interactive demo (gradio-free).

Re-implements the reference Gradio app's multi-mask management
(web-demos/hugging_face/app.py:166-201 add_multi_mask/remove_multi_mask/
show_mask and the template-mask composition in vos_tracking_video,
app.py:210-230) as a plain object, so the logic is testable without gradio
and reusable from any UI (our demo/app.py wires it to sliders/buttons).
"""

from __future__ import annotations

import numpy as np


class MultiMaskSession:
    """Accumulates single-object masks and composes them into the id-labeled
    template mask the tracker consumes.

    Mask ids are 1-based like the reference's "mask_001" names; the painted
    preview colors each mask with palette entry (id + 1), matching
    app.py:197 (mask_color=mask_number+2)."""

    def __init__(self):
        self.masks: list[np.ndarray] = []
        self.mask_names: list[str] = []

    # -- app.py add_multi_mask:166-177 --------------------------------------
    def add_mask(self, mask: np.ndarray) -> str:
        """Add the currently-displayed mask; returns its dropdown name."""
        if mask is None:
            raise ValueError(
                "no mask to add — click the image to generate one first")
        self.masks.append(np.asarray(mask).astype(np.uint8))
        name = "mask_{:03d}".format(len(self.masks))
        self.mask_names.append(name)
        return name

    # -- app.py remove_multi_mask:185-189 -----------------------------------
    def remove_all(self):
        self.masks = []
        self.mask_names = []

    @staticmethod
    def _numbers(selected: list[str]) -> list[int]:
        return [int(name.split("_")[1]) - 1 for name in sorted(selected)]

    # -- app.py show_mask:191-201 --------------------------------------------
    def show(self, frame: np.ndarray, selected: list[str]) -> np.ndarray:
        """Paint every selected mask over the frame, palette entry id+1."""
        from propainter_tpu_torch.demo.painters import mask_painter

        out = frame
        for n in self._numbers(selected):
            out = mask_painter(out, self.masks[n].astype("uint8"),
                               mask_color=n + 2)
        return out

    # -- app.py vos_tracking_video template composition:216-224 --------------
    def template_mask(self, selected: list[str] | None = None) -> np.ndarray:
        """Compose the selected masks into one id-labeled template:
        mask k contributes label (k+1); overlaps clip to the LATER id in
        sorted order (reference np.clip accumulation)."""
        if not self.masks:
            raise ValueError("no masks added")
        selected = selected or [self.mask_names[0]]
        nums = self._numbers(selected)
        template = self.masks[nums[0]] * (nums[0] + 1)
        for n in nums[1:]:
            template = np.clip(template + self.masks[n] * (n + 1), 0, n + 1)
        return template
