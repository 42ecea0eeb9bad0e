"""Standalone RAFT flow demo on the PyTorch port: RAFT over consecutive
frame pairs in a folder, a Middlebury-colour PNG per pair (+ optional
.flo). The flags of `propainter_tpu/cli/raft_demo.py` (the reference's
RAFT/demo.py:50-67), plus `--device`.

  python -m propainter_tpu_torch.cli.raft_demo --path <frames_dir> \\
      --output <out_dir> [--iters 20] [--save_flo] \\
      [--weights weights/raft-things.pth | random] [--device cuda|cpu]

Frames are replicate-padded to multiples of 8 (top and sides, `pad8`) and
the flow cropped back; RAFT runs at batch 1 (K2 and K1 on the card), as
`compute_flow.RaftPairFlow`'s region `raft_pair`: replayed from a CUDA
graph per padded frame shape on the card.
--weights random gives seeded random weights (`weights.seeded_init_`,
seed 0). The default device is the GPU: without one this raises unless
--device cpu is given.
"""

from __future__ import annotations

import argparse
import os


def pad8(img):
    """Replicate-pad H/W up to multiples of 8 (reference
    RAFT/utils/utils.py InputPadder 'sintel' mode pads top+sides)."""
    import numpy as np

    h, w = img.shape[:2]
    ph = (8 - h % 8) % 8
    pw = (8 - w % 8) % 8
    return (np.pad(img, ((ph, 0), (pw // 2, pw - pw // 2), (0, 0)),
                   mode="edge"), (ph, pw))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", required=True, help="frame folder (png/jpg)")
    p.add_argument("--output", required=True)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--weights", default="weights/raft-things.pth",
                   help="'random' = seeded random weights (smoke mode)")
    p.add_argument("--save_flo", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import cv2
    import numpy as np
    import torch

    from propainter_tpu_torch.cli.compute_flow import RaftPairFlow
    from propainter_tpu_torch.cli.inference import load_checkpoint
    from propainter_tpu_torch.device import resolve_device
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.utils.flow_io import flowwrite
    from propainter_tpu_torch.utils.flow_viz import flow_to_image
    from propainter_tpu_torch.weights import seeded_init_

    device = resolve_device(args.device)
    raft = RAFT()
    if args.weights == "random":
        seeded_init_(raft, 0)
    else:
        load_checkpoint(raft, args.weights)
    raft = raft.to(device).eval()
    flow_pair = RaftPairFlow(raft, args.iters, device)

    files = sorted(
        f for f in os.listdir(args.path)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".ppm")))
    if len(files) < 2:
        raise SystemExit(f"need >= 2 frames in {args.path}")
    os.makedirs(args.output, exist_ok=True)

    prev = None
    prev_name = None
    for name in files:
        img = cv2.cvtColor(cv2.imread(os.path.join(args.path, name)),
                           cv2.COLOR_BGR2RGB)
        padded, (ph, pw) = pad8(img)
        cur = torch.from_numpy(
            padded[None].astype(np.float32) / 255.0 * 2 - 1).to(device)
        if prev is not None:
            flow = flow_pair(prev, cur)
            flow = flow[ph:, pw // 2: flow.shape[1] - (pw - pw // 2)]
            stem = os.path.splitext(prev_name)[0]
            viz = flow_to_image(flow)
            cv2.imwrite(os.path.join(args.output, f"{stem}_flow.png"),
                        cv2.cvtColor(viz, cv2.COLOR_RGB2BGR))
            if args.save_flo:
                flowwrite(flow,
                          os.path.join(args.output, f"{stem}.flo"))
            print(f"{stem}: flow |max| {np.abs(flow).max():.2f}",
                  flush=True)
        prev, prev_name = cur, name


if __name__ == "__main__":
    main()
