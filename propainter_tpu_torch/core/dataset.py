"""Training and evaluation datasets and the prefetching batch loader
(host-side numpy and cv2): copies of `TrainDatasetConfig`, `TrainDataset`,
`TestDataset` and `PrefetchLoader` from `propainter_tpu/core/dataset.py`,
pinned to the originals by source (tests/test_torch_eval_metrics.py,
tests/test_torch_train.py). Items are NHWC numpy arrays: training items
float frames in [-1, 1] and 0/1 masks, the layout the trainer takes;
evaluation items uint8 frames and masks, the layout `cli/evaluate.py` feeds
the pipeline."""

from __future__ import annotations

import json
import os
import queue
import random
import threading
from dataclasses import dataclass

import numpy as np

from propainter_tpu_torch.core.mask_synthesis import (
    create_random_shape_with_random_motion)
from propainter_tpu_torch.utils.flow_io import flowread, resize_flow


@dataclass
class TrainDatasetConfig:
    video_root: str
    json_path: str
    flow_root: str | None = None
    num_local_frames: int = 10
    num_ref_frames: int = 6
    w: int = 432
    h: int = 240
    load_flow: bool = False


class TrainDataset:
    """Per-item: synthesize a random moving mask sequence, sample
    num_local_frames contiguous + num_ref_frames random frames, resize to
    (w, h), 50% temporal reverse, 50% flow-aware horizontal flip, normalize
    frames to [-1, 1]. Reference core/dataset.py:19-138."""

    def __init__(self, config: TrainDatasetConfig):
        self.cfg = config
        with open(config.json_path) as f:
            video_dict = json.load(f)
        names = sorted(video_dict.keys())
        self.video_dict: dict[str, int] = {}
        self.frame_dict: dict[str, list[str]] = {}
        min_len = config.num_local_frames + config.num_ref_frames
        for v in names:
            vdir = os.path.join(config.video_root, v)
            if not os.path.isdir(vdir):
                continue
            frame_list = sorted(os.listdir(vdir))
            if len(frame_list) > min_len:
                self.video_dict[v] = len(frame_list)
                self.frame_dict[v] = frame_list
        self.video_names = list(self.video_dict.keys())

    def __len__(self):
        return len(self.video_names)

    def _sample_index(self, length, sample_length, num_ref):
        pivot = random.randint(0, length - sample_length)
        local_idx = list(range(pivot, pivot + sample_length))
        remain = sorted(set(range(length)) - set(local_idx))
        ref_index = sorted(random.sample(remain, num_ref))
        return local_idx + ref_index

    def __getitem__(self, index) -> dict:
        import cv2

        cfg = self.cfg
        video_name = self.video_names[index % len(self.video_names)]
        length = self.video_dict[video_name]
        all_masks = create_random_shape_with_random_motion(
            length, image_height=cfg.h, image_width=cfg.w)
        selected = self._sample_index(
            length, cfg.num_local_frames, cfg.num_ref_frames)

        frames, masks = [], []
        flows_f, flows_b = [], []
        frame_list = self.frame_dict[video_name]
        for n, idx in enumerate(selected):
            img = cv2.imread(
                os.path.join(cfg.video_root, video_name, frame_list[idx]))
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (cfg.w, cfg.h),
                             interpolation=cv2.INTER_LINEAR)
            frames.append(img)
            masks.append(all_masks[idx])

            if cfg.load_flow and n <= cfg.num_local_frames - 2:
                cur = frame_list[idx][:-4]
                nxt = frame_list[idx + 1][:-4]
                ff = flowread(os.path.join(
                    cfg.flow_root, video_name, f"{cur}_{nxt}_f.flo"))
                fb = flowread(os.path.join(
                    cfg.flow_root, video_name, f"{nxt}_{cur}_b.flo"))
                flows_f.append(resize_flow(ff, (cfg.h, cfg.w)))
                flows_b.append(resize_flow(fb, (cfg.h, cfg.w)))

            if n == cfg.num_local_frames - 1 and random.random() < 0.5:
                frames.reverse()
                masks.reverse()
                if cfg.load_flow:
                    flows_f.reverse()
                    flows_b.reverse()
                    flows_f, flows_b = flows_b, flows_f

        # flow-aware horizontal flip (core/utils.py:98-111)
        if random.random() < 0.5:
            frames = [f[:, ::-1] for f in frames]
            masks = [m[:, ::-1] for m in masks]
            if cfg.load_flow:
                # mirror flow: flip spatially and negate the x component
                flows_f = [f[:, ::-1] * np.array([-1, 1], np.float32)
                           for f in flows_f]
                flows_b = [f[:, ::-1] * np.array([-1, 1], np.float32)
                           for f in flows_b]

        item = {
            "frames": np.ascontiguousarray(
                np.stack(frames), np.float32) / 255.0 * 2.0 - 1.0,
            "masks": np.ascontiguousarray(
                np.stack(masks), np.float32)[..., None],
        }
        if cfg.load_flow:
            item["flows_f"] = np.ascontiguousarray(np.stack(flows_f), np.float32)
            item["flows_b"] = np.ascontiguousarray(np.stack(flows_b), np.float32)
        return item


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


class PrefetchLoader:
    """Thread-pool batch loader with a bounded prefetch queue.
    Replaces reference core/prefetch_dataloader.py:7-81.

    Sampling follows torch DistributedSampler semantics (reference
    core/trainer.py:40-43): one shared permutation per epoch (seeded
    seed+epoch, identical across shards), padded by wrapping to a multiple
    of num_shards, then strided by shard — every item is seen exactly once
    per epoch per shard set. A trailing partial batch rolls into the next
    epoch's order (no item is dropped)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0
        self._order: list[int] = []
        self._pos = 0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_workers)
        ]
        self._lock = threading.Lock()
        for t in self._threads:
            t.start()

    def _refill(self):
        """New epoch: reshuffle (same permutation on every shard) and take
        this shard's stride. Called with self._lock held."""
        rng = random.Random(self.seed + self.epoch)
        order = list(range(len(self.dataset)))
        rng.shuffle(order)
        # pad by wrapping so shards stay equal-sized (DistributedSampler)
        total = -(-len(order) // self.num_shards) * self.num_shards
        order += order[: total - len(order)]
        self._order.extend(order[self.shard_index :: self.num_shards])
        self.epoch += 1

    def _next_indices(self) -> list[int]:
        with self._lock:
            while len(self._order) - self._pos < self.batch_size:
                self._refill()
            idxs = self._order[self._pos : self._pos + self.batch_size]
            self._pos += self.batch_size
            if self._pos > 4 * self.batch_size:  # keep the list bounded
                del self._order[: self._pos]
                self._pos = 0
        return idxs

    def _worker(self):
        while not self._stop.is_set():
            idxs = self._next_indices()
            items = [self.dataset[i] for i in idxs]
            batch = {
                k: np.stack([it[k] for it in items])
                for k in items[0]
                if isinstance(items[0][k], np.ndarray)
            }
            while not self._stop.is_set():
                try:
                    self.queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        return self.queue.get()

    def stop(self):
        self._stop.set()
