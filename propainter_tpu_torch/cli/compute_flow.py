"""Offline RAFT flow precomputation for training datasets, on the PyTorch
port: the flags of `propainter_tpu/cli/compute_flow.py` (the reference's
scripts/compute_flow.py), plus `--device`.

  python -m propainter_tpu_torch.cli.compute_flow --root <JPEGImages> \\
      --save_path <flow_root> [--height 240 --width 432] [--raft_iter 20] \\
      [--raft_path weights/raft-things.pth] [--device cuda|cpu]

For every video folder: frames resized to (width, height), RAFT forward and
backward per consecutive pair at batch 1 (K2 and K1 on the card), fp16
.flo files named {cur}_{next}_f.flo / {next}_{cur}_b.flo. Each RAFT call
is `RaftPairFlow`'s region `raft_pair`, replayed from a CUDA graph per
frame shape on the card. The default device is the GPU: without one this
raises unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os

import torch

from propainter_tpu_torch.device import fp32_numerics
from propainter_tpu_torch.graphs import StageGraphs

# graphed by default: kept by the card's keep-or-drop rule (PERF.md
# section 7)
RAFT_PAIR_REGIONS = ("raft_pair",)


class RaftPairFlow:
    """RAFT's flow of one ordered frame pair at batch 1, the call of
    `compute_flow` and `raft_demo` (the JAX CLIs' jitted `flow_pair`,
    `propainter_tpu/cli/compute_flow.py:44`, `raft_demo.py:76`), as the
    region `raft_pair`: on CUDA replayed from a CUDA graph per call key
    (`graphs.StageGraphs`: the frames' shape, and the iterations).

    raft: a `RAFT` on `device`, in eval mode. cuda_graphs: the regions (of
    `RAFT_PAIR_REGIONS`) replayed from CUDA graphs on CUDA; () runs
    eagerly; no effect on the CPU. The graphs of the keys the last video
    used are kept (`begin_video` starts a video)."""

    def __init__(self, raft, iters: int, device,
                 cuda_graphs=RAFT_PAIR_REGIONS):
        self.raft, self.iters = raft, iters
        self.graphs = StageGraphs(cuda_graphs, RAFT_PAIR_REGIONS, device)

    def __call__(self, im1, im2):
        """(1, H, W, 3) frames in [-1, 1] on the device -> RAFT's upsampled
        flow im1 -> im2, (H, W, 2) on the host."""
        with torch.inference_mode(), fp32_numerics():
            flow = self.graphs("raft_pair", self._flow, (im1, im2),
                               (self.iters,))
        return flow[0].cpu().numpy()

    def _flow(self, im1, im2):
        return self.raft(im1, im2, iters=self.iters)[1]

    def begin_video(self) -> None:
        self.graphs.begin_video()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=432)
    p.add_argument("--raft_iter", type=int, default=20)
    p.add_argument("--raft_path", default="weights/raft-things.pth")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import cv2
    import numpy as np

    from propainter_tpu_torch.cli.inference import load_checkpoint
    from propainter_tpu_torch.device import resolve_device
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.utils.flow_io import flowwrite

    device = resolve_device(args.device)
    raft = load_checkpoint(RAFT(), args.raft_path).to(device).eval()
    flow_pair = RaftPairFlow(raft, args.raft_iter, device)

    for video in sorted(os.listdir(args.root)):
        vdir = os.path.join(args.root, video)
        if not os.path.isdir(vdir):
            continue
        out_dir = os.path.join(args.save_path, video)
        os.makedirs(out_dir, exist_ok=True)
        flow_pair.begin_video()
        frame_files = sorted(os.listdir(vdir))
        frames = []
        for ff in frame_files:
            img = cv2.imread(os.path.join(vdir, ff))
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            img = cv2.resize(img, (args.width, args.height),
                             interpolation=cv2.INTER_LINEAR)
            frames.append(torch.from_numpy(
                img.astype(np.float32) / 255.0 * 2 - 1)[None].to(device))
        for i in range(len(frames) - 1):
            a, b = frames[i], frames[i + 1]
            cur = frame_files[i][:-4]
            nxt = frame_files[i + 1][:-4]
            flowwrite(flow_pair(a, b),
                      os.path.join(out_dir, f"{cur}_{nxt}_f.flo"),
                      quantize=True)
            flowwrite(flow_pair(b, a),
                      os.path.join(out_dir, f"{nxt}_{cur}_b.flo"),
                      quantize=True)
        print(f"{video}: {len(frames)} frames", flush=True)


if __name__ == "__main__":
    main()
