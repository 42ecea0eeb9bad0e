"""The interactive object-removal demo, part 1: SAM's click-to-mask
segmenter and the gradio-free session state. Counterpart of
`propainter_tpu/demo/`.

`SamSegmenter` / `SamControler` (demo/segmenter.py) turn clicks on one
frame into a mask with the port's SAM; `MultiMaskSession` and
`TwoStepSession` (demo/multimask.py, demo/session.py) keep the app's masks
and its track-then-inpaint state; demo/painters.py draws the previews.
Tracking (Cutie, the flow tracker), the facade and the app are not ported
yet.
"""

from propainter_tpu_torch.demo.multimask import MultiMaskSession
from propainter_tpu_torch.demo.segmenter import SamControler, SamSegmenter
from propainter_tpu_torch.demo.session import TwoStepSession

__all__ = ["MultiMaskSession", "SamControler", "SamSegmenter",
           "TwoStepSession"]
