"""The clip generator of the traffic files that name `"generator":
"clips"` (the default): a seeded scene under a camera pan with one moving
object, driven by the file's parameters (`benchmark/traffic/<name>.json`).

A clip is a seeded textured scene under a seeded camera pan with one
object on it, and the object's mask: frames (T, H, W, 3) uint8, and the
flow mask and the dilated mask (T, H, W) uint8 (1 = hole), each the
object's mask dilated by `mask_dilation` with scipy's cross, as the
reference's inference script (and the program's CLI) makes both.

The object is an ellipse of `object_area` of the frame (DAVIS object
scale) and aspect `aspect`, moving along the traffic file's `path` (its
centre at the first and the last frame, as fractions of the frame).

Same work for every seed. Stage 4 of ProPainter attends, in each of its
windows of frames, over every attention window that holds a hole token in
any of them, so the work of a clip depends on which attention windows its
mask touches (`flops.signature`: how many, for each stage-4 window),
and the program's CUDA graphs are keyed by those counts. So the mask is
the traffic file's alone, the same in every clip of every seed (a mirror
image of the path already touches other windows), and the seed draws the
scene: the background's and the object's textures and the pan's speed
and direction. Every clip of every seed has the same work; the seed moves
only what the work is done on.

Frame sizes are floored to multiples of 8, as the reference's inference
script does (854 x 480 -> 848 x 480).
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import scipy.ndimage

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A traffic file's parameters (see `benchmark/traffic/*.json`)."""

    name: str
    frames: int
    width: int
    height: int
    pool: int
    mask_dilation: int
    object_area: float
    aspect: float
    path: tuple
    pan: tuple

    @property
    def size(self) -> tuple:
        """(H, W) floored to multiples of 8."""
        return self.height - self.height % 8, self.width - self.width % 8


def load(name: str, root: Path = TRAFFIC) -> Traffic:
    """The traffic mix `name` from `<root>/<name>.json`."""
    return traffic(json.loads((root / f"{name}.json").read_text()), name)


def traffic(d: dict, name: str = "") -> Traffic:
    """A traffic file's parameters as a `Traffic`."""
    return Traffic(name=name, frames=int(d["frames"]), width=int(d["width"]),
                   height=int(d["height"]), pool=int(d["pool"]),
                   mask_dilation=int(d["mask_dilation"]),
                   object_area=float(d["object_area"]),
                   aspect=float(d["aspect"]),
                   path=tuple(tuple(map(float, p)) for p in d["path"]),
                   pan=tuple(map(float, d["pan"])))


def _texture(rng, H: int, W: int) -> np.ndarray:
    """(H, W, 3) uint8: smooth colour fields at two scales and fine
    grain."""
    out = np.zeros((H, W, 3))
    for cell, amp in ((32, 70.0), (8, 35.0)):
        coarse = rng.normal(size=(H // cell + 2, W // cell + 2, 3))
        out += amp * scipy.ndimage.zoom(coarse, (cell, cell, 1),
                                        order=1)[:H, :W]
    out += rng.normal(scale=8.0, size=(H, W, 3))
    return np.clip(out + rng.uniform(60, 190, size=3), 0, 255).astype(
        np.uint8)


def object_masks(t: Traffic) -> np.ndarray:
    """(T, H, W) bool: the ellipse on the path."""
    H, W = t.size
    T = t.frames
    a = math.sqrt(t.object_area * H * W / math.pi * t.aspect)   # x semi-axis
    b = a / t.aspect
    (x0, y0), (x1, y1) = t.path
    out = np.zeros((T, H, W), bool)
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    for f in range(T):
        s = f / max(1, T - 1)
        cx, cy = (x0 + (x1 - x0) * s) * W, (y0 + (y1 - y0) * s) * H
        out[f] = ((xs - cx) / a) ** 2 + ((ys - cy) / b) ** 2 <= 1.0
    return out


def _dilate(masks: np.ndarray, iterations: int) -> np.ndarray:
    """Each frame dilated by scipy's cross, `iterations` times (uint8)."""
    if iterations <= 0:
        return masks.astype(np.uint8)
    return np.stack([scipy.ndimage.binary_dilation(m, iterations=iterations)
                     for m in masks]).astype(np.uint8)


def _scene(t: Traffic, rng, masks: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) uint8: the background panning under the camera, the
    object drawn over it where `masks` is set."""
    H, W = t.size
    T = t.frames
    speed = rng.uniform(*t.pan) * rng.choice([-1.0, 1.0], size=2)
    speed[1] *= 0.25
    span_x = int(math.ceil(abs(speed[0]) * T)) + 1
    span_y = int(math.ceil(abs(speed[1]) * T)) + 1
    bg = _texture(rng, H + span_y, W + span_x)
    obj = _texture(rng, H, W)
    frames = np.empty((T, H, W, 3), np.uint8)
    for f in range(T):
        ox = int(round(speed[0] * f)) % span_x
        oy = int(round(speed[1] * f)) % span_y
        frames[f] = bg[oy:oy + H, ox:ox + W]
        frames[f][masks[f]] = obj[masks[f]]
    return frames


def masks(t: Traffic) -> np.ndarray:
    """(T, H, W) uint8: the object's mask dilated by `mask_dilation`, the
    flow mask and the dilated mask of every clip of `t`."""
    return _dilate(object_masks(t), t.mask_dilation)


def clip(t: Traffic, seed: int, index: int, obj=None, dilated=None) -> dict:
    """Clip `index` of seed `seed`: {'frames', 'flow_masks',
    'masks_dilated'}. obj, dilated: `object_masks(t)` and its dilation, if
    already made."""
    obj = object_masks(t) if obj is None else obj
    dilated = _dilate(obj, t.mask_dilation) if dilated is None else dilated
    rng = np.random.default_rng([seed, index])
    return {"frames": _scene(t, rng, obj), "flow_masks": dilated,
            "masks_dilated": dilated}


def pool(t: Traffic | dict, seed: int) -> list:
    """The `t.pool` distinct clips of a run, in the order the window
    cycles through them. t: a `Traffic` or a traffic file's parameters."""
    t = traffic(t) if isinstance(t, dict) else t
    obj = object_masks(t)
    dilated = _dilate(obj, t.mask_dilation)
    return [clip(t, seed, i, obj, dilated) for i in range(t.pool)]
