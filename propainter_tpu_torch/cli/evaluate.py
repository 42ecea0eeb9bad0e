"""DAVIS / YouTube-VOS evaluation on the PyTorch port: the flags of
`propainter_tpu/cli/evaluate.py` (the reference's
scripts/evaluate_propainter.py), plus `--device`.

  python -m propainter_tpu_torch.cli.evaluate --dataset davis \\
      --video_root <path>/JPEGImages --mask_root <path>/test_masks \\
      --json_path datasets/davis/test.json [--weights DIR|random] \\
      [--task video_completion|object_removal] [--save_results] \\
      [--warp_error] [--profile DIR] [--device cuda|cpu]

Per video: the 4-stage pipeline under the reference evaluation protocol
(with --subvideo_length <= 0, the default: whole-video flow completion and
image propagation, uncapped references, RAFT chunks of 60 frames), per-frame
PSNR/SSIM, the I3D features of the ground-truth and inpainted videos
(--i3d_path, for video_completion) for the final VFID, and with
--warp_error the warping error of the output under RAFT's flow of it.
Writes {output}/{dataset}_rs_{ref_stride}_nl_{neighbor_length}/
{dataset}_metrics.txt with the JAX CLI's lines; --profile DIR traces the
second video with torch.profiler (op input shapes recorded) into DIR.
The default device is the GPU: without one this raises unless --device
cpu is given.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

# the metrics file's number formats (the JAX CLI's); the other lines as str()
METRIC_FORMATS = {"avg s/frame": ".4f", "psnr": ".4f", "ssim": ".4f",
                  "ewarp": ".6f", "vfid": ".4f"}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="davis",
                   choices=["davis", "youtube-vos"])
    p.add_argument("--video_root", required=True)
    p.add_argument("--mask_root", required=True)
    p.add_argument("--json_path", default=None)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=432)
    p.add_argument("--ref_stride", type=int, default=10)
    p.add_argument("--neighbor_length", type=int, default=20)
    p.add_argument("--subvideo_length", type=int, default=-1,
                   help="-1 (default) = UNCHUNKED flow completion and image "
                        "propagation, the reference eval protocol "
                        "(scripts/evaluate_propainter.py:127-131 runs both "
                        "whole-video; RAFT still chunks by 60 frames, :108). "
                        "Set a positive value to eval under the inference "
                        "chunking schedule instead.")
    p.add_argument("--raft_iter", type=int, default=20)
    p.add_argument("--task", default="video_completion",
                   choices=["video_completion", "object_removal"])
    p.add_argument("--weights", default="weights")
    p.add_argument("--i3d_path", default="weights/i3d_rgb_imagenet.pt")
    p.add_argument("--save_results", action="store_true")
    p.add_argument("--output", default="results_eval")
    p.add_argument("--max_videos", type=int, default=-1)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the 2nd video "
                        "(after the first has warmed up) to DIR")
    p.add_argument("--warp_error", action="store_true",
                   help="also compute E_warp on the inpainted output "
                        "(native; the reference delegates this to an "
                        "external repo, README.md:281)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None) -> dict:
    """Runs the evaluation; returns {'metrics': the metrics file's values,
    'videos': [{'name', 'frames', 'seconds', 'stages'}]}."""
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from propainter_tpu_torch.cli.inference import load_checkpoint, load_models
    from propainter_tpu_torch.core.dataset import TestDataset
    from propainter_tpu_torch.core.metrics import (calc_psnr_and_ssim,
                                                   calculate_vfid,
                                                   calculate_warping_error)
    from propainter_tpu_torch.device import fp32_numerics, resolve_device
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    device = resolve_device(args.device)
    json_path = args.json_path or os.path.join(
        "datasets", args.dataset, "test.json")
    dataset = TestDataset(args.video_root, args.mask_root, json_path,
                          w=args.width, h=args.height)

    models = load_models(args.weights)
    # reference eval protocol: whole-video stages 2+3 + uncapped refs
    # (unchunked=True), RAFT chunked by 60 frames
    # (scripts/evaluate_propainter.py:29-34,108,127-137)
    unchunked = args.subvideo_length <= 0
    pipe = ProPainterPipeline(
        models["raft"], models["flowcomp"], models["inpaint"],
        PipelineConfig(ref_stride=args.ref_stride,
                       neighbor_length=args.neighbor_length,
                       subvideo_length=(80 if unchunked
                                        else args.subvideo_length),
                       unchunked=unchunked,
                       raft_clip_len=60 if unchunked else None,
                       raft_iter=args.raft_iter), device=device)

    i3d = None
    if args.task == "video_completion" and os.path.exists(args.i3d_path):
        from propainter_tpu_torch.models.i3d import InceptionI3d

        i3d = load_checkpoint(InceptionI3d(), args.i3d_path,
                              drop_prefixes=("logits.",)).to(device).eval()

    def to_device(video):
        """(T, H, W, 3) uint8 -> (1, T, H, W, 3) in [-1, 1] on the device."""
        return (torch.from_numpy(np.ascontiguousarray(video)[None]).to(device)
                .float() / 255.0 * 2 - 1)

    def i3d_features(video):
        with torch.inference_mode(), fp32_numerics():
            return i3d(to_device(video)).cpu().numpy().ravel()

    out_dir = os.path.join(
        args.output,
        f"{args.dataset}_rs_{args.ref_stride}_nl_{args.neighbor_length}")
    os.makedirs(out_dir, exist_ok=True)

    all_psnr, all_ssim, all_ewarp = [], [], []
    real_acts, fake_acts = [], []
    total_frames, total_time = 0, 0.0
    videos = []

    n = len(dataset) if args.max_videos < 0 else min(args.max_videos,
                                                     len(dataset))
    for vi in range(n):
        item = dataset[vi]
        frames, masks = item["frames"], item["masks"]
        name = item["video_name"]

        stage_times: dict = {}
        profiling = args.profile and vi == 1  # 2nd video: the 1st warmed up
        tracer = contextlib.nullcontext()
        if profiling:
            from torch.profiler import ProfilerActivity, profile

            tracer = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else []),
                record_shapes=True)
        with tracer:
            t0 = time.perf_counter()
            comp = pipe.inpaint_video(frames, masks, masks,
                                      timings=stage_times)
            dt = time.perf_counter() - t0
        if profiling:
            os.makedirs(args.profile, exist_ok=True)
            tracer.export_chrome_trace(
                os.path.join(args.profile, f"{name}.trace.json"))
            print(f"profiler trace written to {args.profile}")
        total_frames += len(frames)
        total_time += dt
        videos.append(dict(name=name, frames=len(frames), seconds=dt,
                           stages=stage_times))

        if args.task == "video_completion":
            for gt, pred in zip(frames, comp):
                psnr, ssim = calc_psnr_and_ssim(
                    gt.astype(np.float64), pred.astype(np.float64))
                all_psnr.append(psnr)
                all_ssim.append(ssim)
            if i3d is not None:
                real_acts.append(i3d_features(frames))
                fake_acts.append(i3d_features(np.stack(comp)))

        if args.warp_error:
            comp_arr = np.stack(comp)
            with torch.inference_mode(), fp32_numerics():
                ewf, ewb = pipe.compute_flows(to_device(comp_arr))
                all_ewarp.append(calculate_warping_error(
                    comp_arr, ewf[0], ewb[0], device=device))

        if args.save_results:
            from propainter_tpu_torch.utils.video import write_frames
            write_frames(comp, os.path.join(out_dir, name))

        stages = " ".join(f"{k}={v:.2f}s" for k, v in stage_times.items())
        msg = (f"[{vi + 1}/{n}] {name}: {len(frames)} frames, "
               f"{dt / len(frames):.3f} s/frame [{stages}]")
        if all_psnr:
            msg += (f", psnr {np.mean(all_psnr):.4f}, "
                    f"ssim {np.mean(all_ssim):.4f}")
        print(msg, flush=True)

    metrics = {"task": args.task, "videos": n,
               "avg s/frame": total_time / max(total_frames, 1)}
    if all_psnr:
        metrics.update(psnr=float(np.mean(all_psnr)),
                       ssim=float(np.mean(all_ssim)))
    if all_ewarp:
        metrics["ewarp"] = float(np.mean(all_ewarp))
    if real_acts:
        metrics["vfid"] = calculate_vfid(real_acts, fake_acts)
    report = "\n".join(f"{k}: {v:{METRIC_FORMATS.get(k, '')}}"
                       for k, v in metrics.items())
    with open(os.path.join(out_dir, f"{args.dataset}_metrics.txt"), "w") as f:
        f.write(report + "\n")
    print(report)
    return dict(metrics=metrics, videos=videos)


if __name__ == "__main__":
    main()
