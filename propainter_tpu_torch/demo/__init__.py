"""The interactive object-removal demo. Counterpart of
`propainter_tpu/demo/`.

Part 1, click to mask: `SamSegmenter` / `SamControler` (demo/segmenter.py)
turn clicks on one frame into a mask with the port's SAM; `ClickSegmenter`
is the GrabCut stand-in. Part 2, track and inpaint (demo/tracking.py):
`CutieTracker` (the port's Cutie, demo/cutie_core.py) or the RAFT-flow
`FlowMaskTracker` carries the mask through the video, and
`TrackingFacade` composes segmenter, tracker and `api.ProInpainter`;
`load_demo_models` loads their weights. `MultiMaskSession` and
`TwoStepSession` (demo/multimask.py, demo/session.py) keep the app's
masks and its track-then-inpaint state; demo/painters.py draws the
previews; demo/app.py is the gradio app.
"""

from propainter_tpu_torch.demo.multimask import MultiMaskSession
from propainter_tpu_torch.demo.segmenter import SamControler, SamSegmenter
from propainter_tpu_torch.demo.session import TwoStepSession
from propainter_tpu_torch.demo.tracking import (
    ClickSegmenter, CutieTracker, FlowMaskTracker, TrackingFacade,
    load_demo_models)

__all__ = ["ClickSegmenter", "CutieTracker", "FlowMaskTracker",
           "MultiMaskSession", "SamControler", "SamSegmenter",
           "TrackingFacade", "TwoStepSession", "load_demo_models"]
