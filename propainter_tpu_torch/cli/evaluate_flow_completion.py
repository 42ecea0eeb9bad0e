"""Flow-completion EPE evaluation on the PyTorch port: the flags of
`propainter_tpu/cli/evaluate_flow_completion.py` (the reference's
scripts/evaluate_flow_completion.py), plus `--device`.

  python -m propainter_tpu_torch.cli.evaluate_flow_completion \\
      --dataset davis --video_root <JPEGImages> --mask_root <masks> \\
      [--json_path datasets/davis/test.json] [--weights DIR|random] \\
      [--device cuda|cpu]

For each test video: bidirectional RAFT flow on the ground-truth frames
(K2, K1), completion of the masked flow by RecurrentFlowCompleteNet (K3),
and the end-point error of the completed flow against the RAFT flow,
averaged over both directions; the last line is `avg epe: ...; avg
s/frame: ...`. The default device is the GPU: without one this raises
unless --device cpu is given.
"""

from __future__ import annotations

import argparse
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="davis")
    p.add_argument("--video_root", required=True)
    p.add_argument("--mask_root", required=True)
    p.add_argument("--json_path", default=None)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=432)
    p.add_argument("--raft_iter", type=int, default=20)
    p.add_argument("--weights", default="weights")
    p.add_argument("--max_videos", type=int, default=-1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None) -> dict:
    """Runs the evaluation; returns {'epe': mean EPE, 's_per_frame': ...,
    'videos': [(name, epe)]}."""
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from propainter_tpu_torch.cli.inference import load_models
    from propainter_tpu_torch.core.dataset import TestDataset
    from propainter_tpu_torch.core.metrics import calculate_epe
    from propainter_tpu_torch.device import fp32_numerics, resolve_device
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    device = resolve_device(args.device)
    json_path = args.json_path or os.path.join(
        "datasets", args.dataset, "test.json")
    dataset = TestDataset(args.video_root, args.mask_root, json_path,
                          w=args.width, h=args.height)
    models = load_models(args.weights)
    # eager stages, as `evaluate`'s: each video once, in many lengths
    pipe = ProPainterPipeline(
        models["raft"], models["flowcomp"], models["inpaint"],
        PipelineConfig(raft_iter=args.raft_iter), device=device,
        cuda_graphs=())

    epes = []
    total_frames, total_time = 0, 0.0
    n = len(dataset) if args.max_videos < 0 else min(args.max_videos,
                                                     len(dataset))
    for vi in range(n):
        item = dataset[vi]
        frames = (torch.from_numpy(item["frames"][None]).to(device).float()
                  / 255.0 * 2 - 1)
        masks = torch.from_numpy(item["masks"][None, ..., None]).to(
            device).float()

        t0 = time.perf_counter()
        with torch.inference_mode(), fp32_numerics():
            gt_flows_bi = pipe.compute_flows(frames)
            pred_flows_bi = pipe.complete_flows(gt_flows_bi, masks)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        gt, pred = ([f.cpu().numpy() for f in flows]
                    for flows in (gt_flows_bi, pred_flows_bi))

        epe = (calculate_epe(pred[0], gt[0])
               + calculate_epe(pred[1], gt[1])) / 2
        epes.append((item["video_name"], epe))
        total_frames += item["frames"].shape[0]
        total_time += dt
        print(f"[{vi + 1}/{n}] {item['video_name']}: epe {epe:.4f}",
              flush=True)

    mean_epe = float(np.mean([e for _, e in epes]))
    s_per_frame = total_time / max(total_frames, 1)
    print(f"avg epe: {mean_epe:.4f}; avg s/frame: {s_per_frame:.4f}")
    return dict(epe=mean_epe, s_per_frame=s_per_frame, videos=epes)


if __name__ == "__main__":
    main()
