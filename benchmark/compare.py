"""The comparison that decides `correct`, and the control's lower precision.

What is measured, for the clip the seed samples from those the window ran
(`numbers`), program against the plain reference on the same inputs:

  flow_rel    RAFT's flows, both directions: |prog - ref| / |ref| (L2)
  cflow_rel   the completed flows, as flow_rel
  prop_rel    the propagated frames inside the dilated mask, as flow_rel
  pmask_flip  the share of the propagated masks' pixels that differ
  frame_lsb   the final uint8 frames: the worst frame's mean |prog - ref|
              over its dilated-mask pixels, in LSB
  clip_lsb    the final uint8 frames: the mean |prog - ref| over every
              frame's dilated-mask pixels, in LSB (steadier from seed to
              seed than the worst frame's)

A cell compares those its limits file names (`benchmark/limits/<cell>.json`),
each against its own limit; the others are printed beside them.
Besides, every clip of the window is checked whole (`malformed`): (T, H,
W, 3) uint8 frames that equal the input outside the dilated mask.

The control (`Products`) is the reference with every product's operands
(convolutions, linear layers, matrix products) rounded to the precision
below the configuration's: TF32 (10-bit mantissa) for fp32, fp8 e4m3
with a per-tensor scale for bf16. The products accumulate in fp32, as
the tensor cores do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

NAMES = ("flow_rel", "cflow_rel", "prop_rel", "pmask_flip", "frame_lsb",
         "clip_lsb")
# the precision below each configuration's precision
CONTROL = {"fp32": "tf32", "bf16": "fp8_e4m3"}
FP8_MAX = 448.0


def _rel(got, want) -> float:
    got = [g.double() for g in got]
    want = [w.double() for w in want]
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    den = sum(float((w ** 2).sum()) for w in want)
    return (num / den) ** 0.5 if den > 0 else float(num > 0)


def numbers(prog: dict, ref: dict, masks_dilated) -> dict:
    """`NAMES` for one clip. prog / ref: {'raft': (flows_f, flows_b),
    'flow_completion': (f, b), 'image_propagation': (frames, masks),
    'frames': (T, H, W, 3) uint8}, tensors on any device (compared on the
    CPU); masks_dilated (T, H, W) 0/1."""
    def cpu(x):
        return tuple(t.detach().float().cpu() for t in x)

    hole = torch.as_tensor(np.asarray(masks_dilated)).bool()
    p_frames, p_masks = cpu(prog["image_propagation"])
    r_frames, r_masks = cpu(ref["image_propagation"])
    h5 = hole[None, ..., None]
    out_p = prog["frames"].detach().cpu().int()
    out_r = ref["frames"].detach().cpu().int()
    diff = (out_p - out_r).abs().float().sum(-1) / 3.0         # (T, H, W)
    per_frame = ((diff * hole).sum((1, 2))
                 / hole.sum((1, 2)).clamp_min(1)).max()
    per_clip = (diff * hole).sum() / hole.sum().clamp_min(1)
    return {
        "flow_rel": _rel(cpu(prog["raft"]), cpu(ref["raft"])),
        "cflow_rel": _rel(cpu(prog["flow_completion"]),
                          cpu(ref["flow_completion"])),
        "prop_rel": _rel([p_frames * h5], [r_frames * h5]),
        "pmask_flip": float(((p_masks > 0.5) != (r_masks > 0.5)).float()
                            .mean()),
        "frame_lsb": float(per_frame),
        "clip_lsb": float(per_clip),
    }


def malformed(frames: list, frames_in, masks_dilated) -> str | None:
    """Why a clip's output is malformed, or None: not T uint8 frames of
    the input's shape, or changed outside the dilated mask."""
    if len(frames) != len(frames_in):
        return f"{len(frames)} frames for {len(frames_in)}"
    out = np.stack(frames)
    if out.dtype != np.uint8 or out.shape != frames_in.shape:
        return f"frames {out.dtype} {out.shape}, want uint8 {frames_in.shape}"
    keep = np.asarray(masks_dilated) == 0
    if not np.array_equal(out[keep], frames_in[keep]):
        return "pixels outside the dilated mask changed"
    return None


def verdict(values: dict, limits: dict) -> bool:
    """Every number within its limit (a number missing fails)."""
    return all(values.get(k, float("inf")) <= limits[k] for k in limits)


def lines(values: dict, limits: dict) -> list:
    """'name value' for each number not compared, then 'name value <=
    limit' for each compared one."""
    return ([f"{k} {v:.6g} (not compared)" for k, v in values.items()
             if k not in limits]
            + [f"{k} {values.get(k, float('nan')):.6g} <= {limits[k]:.6g}"
               for k in limits])


def _round_tf32(x):
    """fp32 -> the nearest TF32 (10-bit mantissa), ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x):
    """fp32 -> fp8 e4m3 under a per-tensor scale (amax -> 448) and back."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUND = {"tf32": _round_tf32, "fp8_e4m3": _round_fp8}
# each product and the positions of its two operands
_PRODUCTS = {
    torch.conv2d: (0, 1), torch.conv3d: (0, 1), F.conv2d: (0, 1),
    F.conv3d: (0, 1), F.linear: (0, 1), torch.matmul: (0, 1),
    torch.Tensor.matmul: (0, 1), torch.Tensor.__matmul__: (0, 1),
    torch.bmm: (0, 1), torch.mm: (0, 1), torch.addmm: (1, 2),
    torch.baddbmm: (1, 2), torch.Tensor.bmm: (0, 1),
}


class Products(TorchFunctionMode):
    """Inside it, each product's two float operands are rounded to
    `precision` ('tf32' or 'fp8_e4m3') first."""

    def __init__(self, precision: str):
        super().__init__()
        self.round = ROUND[precision]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pos = _PRODUCTS.get(func)
        if pos is not None:
            args = list(args)
            for i in pos:
                if (i < len(args) and isinstance(args[i], torch.Tensor)
                        and args[i].is_floating_point()):
                    args[i] = self.round(args[i])
        return func(*args, **kwargs)
