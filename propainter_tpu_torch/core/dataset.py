"""The evaluation dataset: a copy of `TestDataset` from
`propainter_tpu/core/dataset.py` (host-side numpy and cv2; pinned to the
original by tests/test_torch_eval_metrics.py). Items are uint8 frames and
masks, the layout `cli/evaluate.py` feeds the pipeline."""

from __future__ import annotations

import json
import os

import numpy as np

from propainter_tpu_torch.utils.flow_io import flowread


class TestDataset:
    """Full-video eval items with on-disk masks dilated by a cv2 cross kernel
    (iterations=4). Reference core/dataset.py:141-232."""

    def __init__(self, video_root: str, mask_root: str, json_path: str,
                 w: int = 432, h: int = 240, flow_root: str | None = None,
                 load_flow: bool = False):
        self.video_root = video_root
        self.mask_root = mask_root
        self.w, self.h = w, h
        self.flow_root = flow_root
        self.load_flow = load_flow
        with open(json_path) as f:
            self.video_dict = json.load(f)
        self.video_names = sorted(self.video_dict.keys())

    def __len__(self):
        return len(self.video_names)

    def __getitem__(self, index) -> dict:
        import cv2

        video_name = self.video_names[index]
        vdir = os.path.join(self.video_root, video_name)
        frame_files = sorted(os.listdir(vdir))
        frames = []
        for ff in frame_files:
            img = cv2.imread(os.path.join(vdir, ff))
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (self.w, self.h),
                             interpolation=cv2.INTER_LINEAR)
            frames.append(img)

        mdir = os.path.join(self.mask_root, video_name)
        mask_files = sorted(os.listdir(mdir))
        kernel = cv2.getStructuringElement(cv2.MORPH_CROSS, (3, 3))
        masks = []
        for mf in mask_files[: len(frames)]:
            m = cv2.imread(os.path.join(mdir, mf), cv2.IMREAD_GRAYSCALE)
            m = cv2.resize(m, (self.w, self.h),
                           interpolation=cv2.INTER_NEAREST)
            m = (m > 0).astype(np.uint8)
            m = cv2.dilate(m, kernel, iterations=4)
            masks.append(m)

        item = {
            "frames": np.stack(frames),  # uint8 (T, H, W, 3)
            "masks": np.stack(masks),    # uint8 (T, H, W)
            "video_name": video_name,
        }
        if self.load_flow:
            flows_f, flows_b = [], []
            for i in range(len(frames) - 1):
                cur = frame_files[i][:-4]
                nxt = frame_files[i + 1][:-4]
                flows_f.append(flowread(os.path.join(
                    self.flow_root, video_name, f"{cur}_{nxt}_f.flo")))
                flows_b.append(flowread(os.path.join(
                    self.flow_root, video_name, f"{nxt}_{cur}_b.flo")))
            item["flows_f"] = np.stack(flows_f)
            item["flows_b"] = np.stack(flows_b)
        return item
