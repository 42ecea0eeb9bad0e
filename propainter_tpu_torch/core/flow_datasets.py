"""Optical-flow benchmark datasets + augmentation for standalone RAFT
training/evaluation (Sintel / FlyingChairs / FlyingThings3D / KITTI /
HD1K).

Torch-free re-design of reference RAFT/datasets.py and
RAFT/utils/augmentor.py: the directory layouts, sampling recipes, and
augmentation semantics match the reference; the implementation is a
numpy host pipeline (explicit np.random.Generator, index-builder
functions + one dataset class) that feeds device batches the same way
core/dataset.py does for the inpainting trainers.

Layout references:
  * Sintel      reference RAFT/datasets.py:102-118
  * FlyingChairs            RAFT/datasets.py:121-134
  * FlyingThings3D          RAFT/datasets.py:137-158
  * KITTI (sparse)          RAFT/datasets.py:161-177
  * HD1K  (sparse)          RAFT/datasets.py:180-196
  * stage recipes           RAFT/datasets.py:199-230
  * dense/sparse augmentors RAFT/utils/augmentor.py:15-246
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass, field
from glob import glob

import numpy as np

from propainter_tpu_torch.utils.flow_io import read_flow_any


# ---------------------------------------------------------------------------
# Index builders: (image_pairs, flow_paths, extra_info, sparse)
# ---------------------------------------------------------------------------


@dataclass
class FlowIndex:
    """A flat list of (img1, img2) pairs with ground-truth flow paths.

    flow_paths is empty for test splits (images only); sparse marks
    KITTI-style 16-bit PNG flow with a validity channel.
    """

    image_pairs: list[tuple[str, str]] = field(default_factory=list)
    flow_paths: list[str] = field(default_factory=list)
    extra: list[tuple] = field(default_factory=list)
    sparse: bool = False

    def __len__(self):
        return len(self.image_pairs)

    def __mul__(self, k: int) -> "FlowIndex":
        return FlowIndex(self.image_pairs * k, self.flow_paths * k,
                         self.extra * k, self.sparse)

    __rmul__ = __mul__

    def __add__(self, other: "FlowIndex") -> "FlowIndex":
        if self.sparse != other.sparse:
            raise ValueError(
                "cannot concatenate sparse and dense FlowIndex — combine "
                "FlowPairDatasets with ConcatFlowDataset instead")
        return FlowIndex(self.image_pairs + other.image_pairs,
                         self.flow_paths + other.flow_paths,
                         self.extra + other.extra, self.sparse)


def sintel_index(root: str, split: str = "training",
                 dstype: str = "clean") -> FlowIndex:
    """MPI-Sintel: <root>/<split>/<dstype>/<scene>/*.png with per-scene
    .flo under <root>/<split>/flow/<scene>/ (reference :102-118)."""
    idx = FlowIndex()
    image_root = osp.join(root, split, dstype)
    flow_root = osp.join(root, split, "flow")
    for scene in sorted(os.listdir(image_root)):
        frames = sorted(glob(osp.join(image_root, scene, "*.png")))
        for i in range(len(frames) - 1):
            idx.image_pairs.append((frames[i], frames[i + 1]))
            idx.extra.append((scene, i))
        if split != "test":
            idx.flow_paths += sorted(
                glob(osp.join(flow_root, scene, "*.flo")))
    return idx


def flying_chairs_index(root: str, split: str = "training",
                        split_file: str | None = None) -> FlowIndex:
    """FlyingChairs: paired *.ppm + *.flo in one directory; the official
    chairs_split.txt (1 = train, 2 = validation) selects the split
    (reference :121-134). split_file defaults to <root>/chairs_split.txt."""
    idx = FlowIndex()
    images = sorted(glob(osp.join(root, "*.ppm")))
    flows = sorted(glob(osp.join(root, "*.flo")))
    if len(images) != 2 * len(flows):
        raise ValueError(
            f"FlyingChairs at {root}: {len(images)} images vs "
            f"{len(flows)} flows (expect 2:1)")
    split_file = split_file or osp.join(root, "chairs_split.txt")
    tags = np.loadtxt(split_file, dtype=np.int32)
    want = 1 if split == "training" else 2
    for i, flow in enumerate(flows):
        if tags[i] == want:
            idx.image_pairs.append((images[2 * i], images[2 * i + 1]))
            idx.flow_paths.append(flow)
    return idx


def flying_things_index(root: str,
                        dstype: str = "frames_cleanpass") -> FlowIndex:
    """FlyingThings3D TRAIN split, left camera, both time directions;
    flow is color-PFM (reference :137-158)."""
    idx = FlowIndex()
    for direction in ("into_future", "into_past"):
        image_dirs = sorted(glob(osp.join(root, dstype, "TRAIN/*/*")))
        flow_dirs = sorted(glob(osp.join(root, "optical_flow/TRAIN/*/*")))
        for idir, fdir in zip(
                [osp.join(d, "left") for d in image_dirs],
                [osp.join(d, direction, "left") for d in flow_dirs]):
            frames = sorted(glob(osp.join(idir, "*.png")))
            flows = sorted(glob(osp.join(fdir, "*.pfm")))
            for i in range(len(flows) - 1):
                if direction == "into_future":
                    idx.image_pairs.append((frames[i], frames[i + 1]))
                    idx.flow_paths.append(flows[i])
                else:
                    idx.image_pairs.append((frames[i + 1], frames[i]))
                    idx.flow_paths.append(flows[i + 1])
    return idx


def kitti_index(root: str, split: str = "training") -> FlowIndex:
    """KITTI-2015: image_2/*_10.png -> *_11.png pairs, sparse flow_occ
    PNGs for the training split (reference :161-177)."""
    idx = FlowIndex(sparse=True)
    base = osp.join(root, split)
    first = sorted(glob(osp.join(base, "image_2", "*_10.png")))
    second = sorted(glob(osp.join(base, "image_2", "*_11.png")))
    for a, b in zip(first, second):
        idx.image_pairs.append((a, b))
        idx.extra.append((osp.basename(a),))
    if split == "training":
        idx.flow_paths = sorted(glob(osp.join(base, "flow_occ", "*_10.png")))
    return idx


def hd1k_index(root: str) -> FlowIndex:
    """HD1K: hd1k_input/image_2 + hd1k_flow_gt/flow_occ, sequences by
    %06d prefix (reference :180-196)."""
    idx = FlowIndex(sparse=True)
    seq = 0
    while True:
        flows = sorted(glob(
            osp.join(root, "hd1k_flow_gt", "flow_occ", f"{seq:06d}_*.png")))
        frames = sorted(glob(
            osp.join(root, "hd1k_input", "image_2", f"{seq:06d}_*.png")))
        if not flows:
            break
        for i in range(len(flows) - 1):
            idx.flow_paths.append(flows[i])
            idx.image_pairs.append((frames[i], frames[i + 1]))
        seq += 1
    return idx


# ---------------------------------------------------------------------------
# Augmentation (numpy, explicit RNG)
# ---------------------------------------------------------------------------


def _color_jitter(rng: np.random.Generator, imgs: np.ndarray,
                  brightness: float, contrast: float, saturation: float,
                  hue: float) -> np.ndarray:
    """ColorJitter-equivalent on a uint8 HxWx3 stack: the four factors are
    sampled uniformly and applied in a random order (torchvision
    semantics; reference augmentor.py:32,135)."""
    import cv2

    img = imgs.astype(np.float32)
    ops = list(range(4))
    rng.shuffle(ops)
    for op in ops:
        if op == 0 and brightness > 0:
            img = img * rng.uniform(1 - brightness, 1 + brightness)
        elif op == 1 and contrast > 0:
            f = rng.uniform(1 - contrast, 1 + contrast)
            gray = cv2.cvtColor(
                np.clip(img, 0, 255).astype(np.uint8),
                cv2.COLOR_RGB2GRAY).mean()
            img = img * f + gray * (1 - f)
        elif op == 2 and saturation > 0:
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = cv2.cvtColor(
                np.clip(img, 0, 255).astype(np.uint8),
                cv2.COLOR_RGB2GRAY).astype(np.float32)[..., None]
            img = img * f + gray * (1 - f)
        elif op == 3 and hue > 0:
            shift = rng.uniform(-hue, hue) * 180.0  # cv2 H range [0,180)
            hsv = cv2.cvtColor(
                np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
            hsv = hsv.astype(np.float32)
            hsv[..., 0] = (hsv[..., 0] + shift) % 180.0
            img = cv2.cvtColor(
                hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


@dataclass
class FlowAugmentor:
    """Dense-flow augmentation: photometric + eraser + scale/stretch/flip/
    crop, same parameters and probabilities as reference
    RAFT/utils/augmentor.py:15-120."""

    crop_size: tuple[int, int]
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    spatial_aug_prob: float = 0.8
    stretch_prob: float = 0.8
    max_stretch: float = 0.2
    h_flip_prob: float = 0.5
    v_flip_prob: float = 0.1
    asymmetric_color_aug_prob: float = 0.2
    eraser_aug_prob: float = 0.5
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.5 / 3.14

    def color(self, rng, img1, img2):
        jit = lambda im: _color_jitter(rng, im, self.brightness,
                                       self.contrast, self.saturation,
                                       self.hue)
        if rng.random() < self.asymmetric_color_aug_prob:
            return jit(img1), jit(img2)
        both = jit(np.concatenate([img1, img2], axis=0))
        return both[:img1.shape[0]], both[img1.shape[0]:]

    def eraser(self, rng, img1, img2, bounds=(50, 100)):
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            img2 = img2.copy()
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx] = mean_color
        return img1, img2

    def spatial(self, rng, img1, img2, flow):
        import cv2

        ht, wd = img1.shape[:2]
        floor = max((self.crop_size[0] + 8) / ht,
                    (self.crop_size[1] + 8) / wd)
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, floor), max(sy, floor)

        if rng.random() < self.spatial_aug_prob:
            rs = lambda a: cv2.resize(a, None, fx=sx, fy=sy,
                                      interpolation=cv2.INTER_LINEAR)
            img1, img2 = rs(img1), rs(img2)
            flow = rs(flow) * np.array([sx, sy], np.float32)

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            if rng.random() < self.v_flip_prob:
                img1, img2 = img1[::-1], img2[::-1]
                flow = flow[::-1] * np.array([1.0, -1.0], np.float32)

        ch, cw = self.crop_size
        y0 = rng.integers(0, img1.shape[0] - ch)
        x0 = rng.integers(0, img1.shape[1] - cw)
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        return (np.ascontiguousarray(img1[sl]),
                np.ascontiguousarray(img2[sl]),
                np.ascontiguousarray(flow[sl]))

    def __call__(self, rng, img1, img2, flow):
        img1, img2 = self.color(rng, img1, img2)
        img1, img2 = self.eraser(rng, img1, img2)
        return self.spatial(rng, img1, img2, flow)


def resize_sparse_flow(flow: np.ndarray, valid: np.ndarray,
                       fx: float, fy: float):
    """Point-wise sparse-flow resize: move each valid measurement to its
    scaled integer location instead of interpolating (reference
    augmentor.py:166-200 — interpolation would bleed flow into invalid
    pixels)."""
    ht, wd = flow.shape[:2]
    ys, xs = np.nonzero(valid >= 1)
    f = flow[ys, xs]
    ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
    xx = np.round(xs * fx).astype(np.int32)
    yy = np.round(ys * fy).astype(np.int32)
    keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
    out_f = np.zeros((ht1, wd1, 2), np.float32)
    out_v = np.zeros((ht1, wd1), np.float32)
    out_f[yy[keep], xx[keep]] = f[keep] * np.array([fx, fy], np.float32)
    out_v[yy[keep], xx[keep]] = 1.0
    return out_f, out_v


@dataclass
class SparseFlowAugmentor(FlowAugmentor):
    """KITTI/HD1K variant: symmetric-only color jitter, sparse-aware
    resize, margin-biased crop (reference augmentor.py:122-246)."""

    do_flip: bool = False
    asymmetric_color_aug_prob: float = 0.0
    brightness: float = 0.3
    contrast: float = 0.3
    saturation: float = 0.3
    hue: float = 0.3 / 3.14

    def spatial_sparse(self, rng, img1, img2, flow, valid):
        import cv2

        ht, wd = img1.shape[:2]
        floor = max((self.crop_size[0] + 1) / ht,
                    (self.crop_size[1] + 1) / wd)
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = max(scale, floor)

        if rng.random() < self.spatial_aug_prob:
            rs = lambda a: cv2.resize(a, None, fx=sx, fy=sy,
                                      interpolation=cv2.INTER_LINEAR)
            img1, img2 = rs(img1), rs(img2)
            flow, valid = resize_sparse_flow(flow, valid, sx, sy)

        if self.do_flip and rng.random() < 0.5:
            img1, img2 = img1[:, ::-1], img2[:, ::-1]
            flow = flow[:, ::-1] * np.array([-1.0, 1.0], np.float32)
            valid = valid[:, ::-1]

        ch, cw = self.crop_size
        y0 = int(np.clip(rng.integers(0, img1.shape[0] - ch + 20),
                         0, img1.shape[0] - ch))
        x0 = int(np.clip(rng.integers(-50, img1.shape[1] - cw + 50),
                         0, img1.shape[1] - cw))
        sl = np.s_[y0:y0 + ch, x0:x0 + cw]
        return (np.ascontiguousarray(img1[sl]),
                np.ascontiguousarray(img2[sl]),
                np.ascontiguousarray(flow[sl]),
                np.ascontiguousarray(valid[sl]))

    def __call__(self, rng, img1, img2, flow, valid):
        img1, img2 = self.color(rng, img1, img2)
        img1, img2 = self.eraser(rng, img1, img2)
        return self.spatial_sparse(rng, img1, img2, flow, valid)


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


def _read_image(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = np.tile(img[..., None], (1, 1, 3))
    elif img.shape[-1] >= 3:
        img = cv2.cvtColor(img[..., :3], cv2.COLOR_BGR2RGB)
    return np.ascontiguousarray(img[..., :3]).astype(np.uint8)


class FlowPairDataset:
    """Samples (img1, img2, flow, valid) float32 HWC numpy arrays.

    Images are uint8-range floats (0..255, the RAFT convention); valid is
    read from sparse flow or derived as |flow| < 1000 (reference
    RAFT/datasets.py:55-91). Compatible with core/dataset.PrefetchLoader.
    """

    def __init__(self, index: FlowIndex,
                 augmentor: FlowAugmentor | None = None, seed: int = 0):
        if index.flow_paths and \
                len(index.flow_paths) != len(index.image_pairs):
            raise ValueError(
                f"index mismatch: {len(index.image_pairs)} pairs vs "
                f"{len(index.flow_paths)} flows")
        self.index = index
        self.augmentor = augmentor
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i: int) -> dict:
        i = i % len(self.index)
        a, b = self.index.image_pairs[i]
        img1, img2 = _read_image(a), _read_image(b)
        if not self.index.flow_paths:  # test split: images only
            return {"image1": img1.astype(np.float32),
                    "image2": img2.astype(np.float32),
                    "extra": self.index.extra[i] if self.index.extra
                    else (i,)}
        if self.index.sparse:
            flow, valid = read_flow_any(self.index.flow_paths[i])
        else:
            flow = read_flow_any(self.index.flow_paths[i])
            valid = None
        if self.augmentor is not None:
            if self.index.sparse:
                img1, img2, flow, valid = self.augmentor(
                    self._rng, img1, img2, flow, valid)
            else:
                img1, img2, flow = self.augmentor(
                    self._rng, img1, img2, flow)
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        return {"image1": img1.astype(np.float32),
                "image2": img2.astype(np.float32),
                "flow": flow.astype(np.float32),
                "valid": np.asarray(valid, np.float32)}


class ConcatFlowDataset:
    """Concatenation of FlowPairDatasets (each keeps its own augmentor /
    sparse handling) — the mixture mechanism behind the reference's
    weighted `100*sintel + 200*kitti + ...` sums (RAFT/datasets.py:220)."""

    def __init__(self, parts: list):
        self.parts = parts
        self._sizes = np.array([len(p) for p in parts])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])

    def __len__(self):
        return int(self._sizes.sum())

    def __getitem__(self, i: int) -> dict:
        i = i % len(self)
        part = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.parts[part][i - int(self._offsets[part])]


# ---------------------------------------------------------------------------
# Stage recipes (reference RAFT/datasets.py:199-230)
# ---------------------------------------------------------------------------


def fetch_flow_dataset(stage: str, crop_size: tuple[int, int],
                       roots: dict | None = None, seed: int = 0,
                       train_ds: str = "C+T+K+S+H"):
    """Build the training dataset for a RAFT curriculum stage with the
    reference's per-stage augmentation ranges and mixture weights."""
    r = {
        "chairs": "datasets/FlyingChairs_release/data",
        "things": "datasets/FlyingThings3D",
        "sintel": "datasets/Sintel",
        "kitti": "datasets/KITTI",
        "hd1k": "datasets/HD1k",
        **(roots or {}),
    }
    if stage == "chairs":
        aug = FlowAugmentor(crop_size, -0.1, 1.0, True)
        return FlowPairDataset(
            flying_chairs_index(r["chairs"], "training"), aug, seed)
    if stage == "things":
        aug = FlowAugmentor(crop_size, -0.4, 0.8, True)
        idx = (flying_things_index(r["things"], "frames_cleanpass")
               + flying_things_index(r["things"], "frames_finalpass"))
        return FlowPairDataset(idx, aug, seed)
    if stage == "sintel":
        aug = FlowAugmentor(crop_size, -0.2, 0.6, True)
        dense_idx = (100 * sintel_index(r["sintel"], "training", "clean")
                     + 100 * sintel_index(r["sintel"], "training", "final")
                     + flying_things_index(r["things"], "frames_cleanpass"))
        dense = FlowPairDataset(dense_idx, aug, seed)
        if train_ds != "C+T+K+S+H":
            return dense
        kitti = FlowPairDataset(
            200 * kitti_index(r["kitti"], "training"),
            SparseFlowAugmentor(crop_size, -0.3, 0.5, True), seed + 1)
        hd1k = FlowPairDataset(
            5 * hd1k_index(r["hd1k"]),
            SparseFlowAugmentor(crop_size, -0.5, 0.2, True), seed + 2)
        return ConcatFlowDataset([dense, kitti, hd1k])
    if stage == "kitti":
        aug = SparseFlowAugmentor(crop_size, -0.2, 0.4, False)
        return FlowPairDataset(kitti_index(r["kitti"], "training"), aug,
                               seed)
    raise ValueError(f"unknown stage: {stage}")
