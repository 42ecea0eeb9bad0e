"""Video inpainting CLI of the PyTorch port — the flags of
`propainter_tpu/cli/inference.py` (the reference script's,
inference_propainter.py:181-217), with `--device` in place of
`--platform`:

  python -m propainter_tpu_torch.cli.inference -i <video|frame_dir> \\
      -m <mask|mask_dir> [-o results] [--resize_ratio r] [--height H \\
      --width W] [--mask_dilation 4] [--ref_stride 10] [--neighbor_length 10]
      [--subvideo_length 80] [--raft_iter 20]
      [--mode video_inpainting|video_outpainting] [--scale_h 1.0 \\
      --scale_w 1.2] [--save_fps 24] [--save_frames] [--bf16]
      [--weights DIR|random] [--device cuda|cpu]

Writes masked_in.mp4 and inpaint_out.mp4 (and frames/*.png with
--save_frames) under <output>/<video_name>/, as the JAX CLI does.

Weights: --weights DIR loads the reference's released checkpoints
(raft-things.pth, recurrent_flow_completion.pth, ProPainter.pth) straight
into the port's modules with strict=True, RAFT's DataParallel `module.`
prefix stripped; --weights random gives seeded random weights
(`weights.seeded_init_`). The default device is the GPU: without one this
raises unless --device cpu is given. Video I/O needs cv2.
"""

from __future__ import annotations

import argparse
import os

CHECKPOINTS = {"raft": "raft-things.pth",
               "flowcomp": "recurrent_flow_completion.pth",
               "inpaint": "ProPainter.pth"}


def load_checkpoint(module, path: str, drop_prefixes=()):
    """Load the released checkpoint `path` into `module` with strict=True:
    a `state_dict` wrapper unwrapped, RAFT's DataParallel `module.` prefix
    stripped, keys under `drop_prefixes` (I3D's unused `logits.` head)
    dropped, and missing `num_batches_tracked` counters (checkpoints saved
    before PyTorch kept them) taken from the module, as torch's BatchNorm
    does. Returns the module."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    sd = {k: v for k, v in sd.items()
          if not k.startswith(tuple(drop_prefixes))}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
    module.load_state_dict(sd, strict=True)
    return module


def load_models(weights: str) -> dict:
    """{'raft', 'flowcomp', 'inpaint'} modules with the released weights
    of the directory `weights`, or seeded random ones for 'random'."""
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    models = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
              "inpaint": InpaintGenerator()}
    if weights == "random":
        for seed, module in enumerate(models.values()):
            seeded_init_(module, seed)
        return models
    for name, module in models.items():
        path = os.path.join(weights, CHECKPOINTS[name])
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"missing {path}; place the released checkpoints in "
                f"{weights} or pass --weights random")
        load_checkpoint(module, path)
    return models


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-i", "--video", type=str,
                   default="inputs/object_removal/bmx-trees")
    p.add_argument("-m", "--mask", type=str,
                   default="inputs/object_removal/bmx-trees_mask")
    p.add_argument("-o", "--output", type=str, default="results")
    p.add_argument("--resize_ratio", type=float, default=1.0)
    p.add_argument("--height", type=int, default=-1)
    p.add_argument("--width", type=int, default=-1)
    p.add_argument("--mask_dilation", type=int, default=4)
    p.add_argument("--ref_stride", type=int, default=10)
    p.add_argument("--neighbor_length", type=int, default=10)
    p.add_argument("--subvideo_length", type=int, default=80)
    p.add_argument("--raft_iter", type=int, default=20)
    p.add_argument("--mode", default="video_inpainting",
                   choices=["video_inpainting", "video_outpainting"])
    p.add_argument("--scale_h", type=float, default=1.0)
    p.add_argument("--scale_w", type=float, default=1.2)
    p.add_argument("--save_fps", type=int, default=24)
    p.add_argument("--save_frames", action="store_true")
    p.add_argument("--fp16", "--bf16", dest="bf16", action="store_true",
                   help="half precision (bf16)")
    p.add_argument("--weights", type=str, default="weights",
                   help="directory of the released .pth checkpoints, or "
                        "'random'")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu (the "
                        "plain PyTorch versions of the kernels)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)
    from propainter_tpu_torch.utils.masks import (prepare_outpainting,
                                                  read_masks)
    from propainter_tpu_torch.utils.video import (overlay_mask_green,
                                                  read_frames, resize_frames,
                                                  write_frames, write_video)

    frames, fps, size, video_name = read_frames(args.video)
    if args.width != -1 and args.height != -1:
        size = (args.width, args.height)
    if args.resize_ratio != 1.0:
        size = (int(args.resize_ratio * size[0]),
                int(args.resize_ratio * size[1]))
    frames, process_size, out_size = resize_frames(frames, size)
    fps = args.save_fps if fps is None else fps

    if args.mode == "video_inpainting":
        flow_masks, masks_dilated = read_masks(
            args.mask, len(frames), process_size,
            flow_mask_dilates=args.mask_dilation,
            mask_dilates=args.mask_dilation)
    else:
        frames, flow_masks, masks_dilated, process_size = prepare_outpainting(
            frames, (args.scale_h, args.scale_w))
        out_size = process_size

    models = load_models(args.weights)
    pipe = ProPainterPipeline(
        models["raft"], models["flowcomp"], models["inpaint"],
        PipelineConfig(
            ref_stride=args.ref_stride,
            neighbor_length=args.neighbor_length,
            subvideo_length=args.subvideo_length,
            raft_iter=args.raft_iter,
            precision="bf16" if args.bf16 else "fp32",
        ), device=args.device)

    print(f"Processing: {video_name} [{len(frames)} frames] "
          f"at {process_size} on {pipe.device}...")
    comp_frames = pipe.inpaint_video(frames, flow_masks, masks_dilated)

    save_root = os.path.join(args.output, video_name)
    os.makedirs(save_root, exist_ok=True)

    if args.save_frames:
        write_frames(comp_frames, os.path.join(save_root, "frames"), out_size)

    import cv2

    masked = overlay_mask_green(frames, masks_dilated)
    masked = [cv2.resize(f, out_size) for f in masked]
    comp = [cv2.resize(f, out_size) for f in comp_frames]
    write_video(masked, os.path.join(save_root, "masked_in.mp4"), fps)
    write_video(comp, os.path.join(save_root, "inpaint_out.mp4"), fps)
    print(f"All results are saved in {save_root}")


if __name__ == "__main__":
    main()
