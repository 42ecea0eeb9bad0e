"""Middlebury .flo flow file IO with optional fp16 quantization, and the
PFM / KITTI readers: a copy of `propainter_tpu/utils/flow_io.py` (jax-free;
each function's source is pinned to the original by
tests/test_torch_eval_metrics.py).

Same file format and conventions as reference utils/flow_util.py:28-99
(magic 'PIEH' float 202021.25, little-endian W, H, then H*W*2 floats; the
`quantize` variant stores fp16 payload as the reference's compute_flow.py
does for precomputed training flows).
"""

from __future__ import annotations

import os

import numpy as np

_MAGIC = 202021.25


def flowread(path: str, quantize: bool | None = None) -> np.ndarray:
    """Read a .flo file -> (H, W, 2) float32.

    quantize: True = fp16 payload, False = fp32; None (default) detects the
    payload width from the file size (both variants share the 12-byte
    header, so the remaining byte count is unambiguous).
    """
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if magic != _MAGIC:
            raise ValueError(f"invalid .flo magic in {path}: {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        if quantize is None:
            quantize = os.path.getsize(path) - 12 == h * w * 2 * 2
        if quantize:
            data = np.frombuffer(f.read(h * w * 2 * 2), np.float16)
            flow = data.astype(np.float32)
        else:
            flow = np.frombuffer(f.read(h * w * 2 * 4), np.float32).copy()
        return flow.reshape(h, w, 2)


def flowwrite(flow: np.ndarray, path: str, quantize: bool = False):
    """Write (H, W, 2) flow to a .flo file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(_MAGIC).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        if quantize:
            f.write(flow.astype(np.float16).tobytes())
        else:
            f.write(flow.astype(np.float32).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> (H, W[, 3]) float32 (FlyingThings3D flow stores
    (u, v, 0) as color PFM). Same format as reference
    RAFT/utils/frame_utils.py:33-76: 'PF'/'Pf' header, dims line, scale
    line (sign = endianness), rows bottom-up."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(f.read(), dtype=endian + "f4")
    data = data.reshape(h, w, channels) if channels == 3 else \
        data.reshape(h, w)
    return np.flipud(data).astype(np.float32)


def write_pfm(arr: np.ndarray, path: str):
    """Write (H, W) or (H, W, 3) float32 as little-endian PFM."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(arr, np.float32)
    header = b"PF" if arr.ndim == 3 else b"Pf"
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{arr.shape[1]} {arr.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.flipud(arr).astype("<f4").tobytes())


def read_flow_kitti(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read KITTI sparse flow: 16-bit PNG, channels (v*64+2^15, u*64+2^15,
    valid) in BGR file order -> ((H, W, 2) float32 flow, (H, W) float32
    valid). Reference RAFT/utils/frame_utils.py:102-107 semantics."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise FileNotFoundError(path)
    raw = raw.astype(np.float32)
    flow = (raw[..., 2:0:-1] - 2 ** 15) / 64.0   # BGR -> (u, v)
    valid = raw[..., 0]
    return flow, valid


def write_flow_kitti(flow: np.ndarray, path: str,
                     valid: np.ndarray | None = None):
    """Write (H, W, 2) flow (+ optional valid mask) as a KITTI 16-bit PNG."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), np.float32)
    enc = np.zeros((h, w, 3), np.uint16)
    q = np.clip(flow * 64.0 + 2 ** 15, 0, 2 ** 16 - 1)
    enc[..., 2] = q[..., 0]                       # u in the R channel
    enc[..., 1] = q[..., 1]                       # v in the G channel
    enc[..., 0] = valid.astype(np.uint16)
    cv2.imwrite(path, enc)


def read_flow_any(path: str):
    """Dispatch on extension: .flo -> (H, W, 2); .pfm -> first two channels
    of the color PFM; .png -> KITTI sparse (flow, valid) TUPLE."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".flo":
        return flowread(path)
    if ext == ".pfm":
        return read_pfm(path)[..., :2].copy()
    if ext == ".png":
        return read_flow_kitti(path)
    raise ValueError(f"unknown flow format: {path}")


def resize_flow(flow: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize (H, W, 2) flow to `size`=(H', W'), scaling components.

    Matches reference utils/flow_util.py:6-25 (bilinear resize, multiply u by
    W'/W and v by H'/H).
    """
    import cv2

    h, w = flow.shape[:2]
    nh, nw = size
    out = cv2.resize(flow, (nw, nh), interpolation=cv2.INTER_LINEAR)
    out = out * np.array([nw / w, nh / h], np.float32)
    return out
