"""Video/frame IO (host-side). Reference inference_propainter.py:26-67,454-472.

A copy of `propainter_tpu/utils/video.py` (the port imports nothing of the
JAX package; a test pins each function to the original). Needs `cv2`;
`imageio` is optional (`write_video` falls back to cv2's writer).
"""

from __future__ import annotations

import os

import numpy as np


def read_frames(path: str) -> tuple[np.ndarray, float | None, tuple[int, int], str]:
    """Read an mp4/mov/avi file or a folder of frames.

    Returns:
      (frames (T, H, W, 3) uint8 RGB, fps or None, (W, H), video_name).
    """
    import cv2

    if path.lower().endswith((".mp4", ".mov", ".avi")):
        name = os.path.basename(path)[:-4]
        cap = cv2.VideoCapture(path)
        fps = cap.get(cv2.CAP_PROP_FPS) or None
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        arr = np.stack(frames)
    else:
        name = os.path.basename(os.path.normpath(path))
        fps = None
        frames = []
        for fr in sorted(os.listdir(path)):
            img = cv2.imread(os.path.join(path, fr))
            if img is None:
                continue
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        arr = np.stack(frames)
    h, w = arr.shape[1:3]
    return arr, fps, (w, h), name


def resize_frames(
    frames: np.ndarray, size: tuple[int, int] | None = None
) -> tuple[np.ndarray, tuple[int, int], tuple[int, int]]:
    """Snap (W, H) to multiples of 8 and resize.
    Reference inference_propainter.py:34-45.

    Args:
      frames: (T, H, W, 3) uint8; size: (W, H) target or None.
    Returns:
      (frames, process_size (W, H), out_size (W, H)).
    """
    import cv2

    T, H, W, _ = frames.shape
    out_size = size if size is not None else (W, H)
    process_size = (out_size[0] - out_size[0] % 8, out_size[1] - out_size[1] % 8)
    if (W, H) != process_size:
        frames = np.stack([
            cv2.resize(f, process_size, interpolation=cv2.INTER_LINEAR)
            for f in frames
        ])
    return frames, process_size, out_size


def write_video(frames: list[np.ndarray], path: str, fps: float = 24.0,
                quality: int = 7):
    """Write frames to an mp4.

    Prefers imageio/ffmpeg (quality=7 like the reference,
    inference_propainter.py:466-471); falls back to cv2.VideoWriter when no
    ffmpeg backend is installed (the TPU image bundles cv2's codecs only).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, quality=quality)
        return
    except (ValueError, ImportError):
        pass
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                         float(fps), (w, h))
    if not vw.isOpened():
        raise RuntimeError(f"no mp4 writer available for {path}")
    for f in frames:
        vw.write(cv2.cvtColor(np.asarray(f, np.uint8), cv2.COLOR_RGB2BGR))
    vw.release()


def write_frames(frames: list[np.ndarray], out_dir: str,
                 out_size: tuple[int, int] | None = None):
    """Save frames as zero-padded PNGs (cubic-resized to out_size)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for idx, f in enumerate(frames):
        if out_size is not None and (f.shape[1], f.shape[0]) != out_size:
            f = cv2.resize(f, out_size, interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(os.path.join(out_dir, f"{idx:04d}.png"),
                    cv2.cvtColor(f, cv2.COLOR_RGB2BGR))


def overlay_mask_green(frames: np.ndarray, masks: np.ndarray,
                       alpha: float = 0.6) -> list[np.ndarray]:
    """Green overlay visualization of masked regions.
    Reference inference_propainter.py:251-261."""
    out = []
    green = np.zeros_like(frames[0])
    green[:, :, 1] = 255
    for img, m in zip(frames, masks):
        m3 = np.repeat(m[..., None], 3, axis=2).astype(np.float32)
        fuse = (1 - alpha) * img + alpha * green
        out.append((m3 * fuse + (1 - m3) * img).astype(np.uint8))
    return out
