#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`propainter_tpu_torch`) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases build,kernels --out-dir results

Phases:
  device      card name and `nvidia-smi` name / power limit;
  build       compile every CUDA kernel (one nvcc per source, in parallel);
              for the tensor-core kernels K1, K3, K4 and K5 print registers,
              spills and shared memory (`-Xptxas -v`), the HMMA
              (mma.sync) and HGMMA (wgmma) counts of their SASS, resident
              blocks per SM and the waves of each main-path grid (K4's
              at each bucketed shape of `K4_BUCKET_SHAPES`), for K7
              (CUDA cores) registers, spills and shared memory; fails if a
              tensor-core kernel has neither instruction, or any kernel
              spills; K7's bf16 form (persistent) also its blocks per SM
              and waves;
  kernels     each kernel at the main path's shapes against its plain
              PyTorch version on the card (max abs error within a stated
              tolerance), timed beside the plain version and a library
              yardstick (K1, K3, K6 and K7 by CUDA-graph replay, K3's, K6's
              and K7's calls being shorter than their host-side launch); K1
              and K7 also at a ragged 8 x 13 map with far-off coordinates,
              beside the reference RAFT's F.grid_sample route (+ addmm for
              K1); K3 also beside the
              unfused K6 + GEMM route and at every cluster split, K3 and
              K6 at a ragged image with far-off coordinates; K4 and its
              bf16 form at the bucketed main path's shapes (buckets of 8
              and 4 windows, the last block's 11 local frames' queries)
              with their bounds, SDPA and waves, at the 64-problem shape
              of a run without bucketing, and at ragged shapes (a partial
              query and key tile, a bias masking a whole key tile); K5 at
              three occupancies and both
              temporal-dilation parities, and A/B against K4 plus branch
              B; the bf16 forms of K1-K5 and K7, and K1 over a bf16
              volume with fp32 parameters, against their bf16 plain
              versions (two bf16 steps of the output scale; K7's fp32
              output within 1e-6), beside the bf16 library routes
              (F.grid_sample + addmm for K1, F.grid_sample for K7, SDPA
              for K4 and K5) and, for K5, the fp32 K5; K3's bf16 form
              also at every cluster split at both sites (timed), at 65
              positions at every group width and at 21 (one partial
              tile, one cluster) at every split, offsets to 40 px; K1's
              bf16 forms and K7's bf16 form also at the far-off 8 x 13
              map and at an 8 x 9 map with every coordinate outside every
              level, K7's bf16 form also at a 9 x 27 map (odd widths),
              with a sector floor beside its bound; K2 and K1 also at
              the evaluation protocol's 60-frame RAFT chunks (118
              pair-directions) and K4 at `K4_EVAL_SHAPE` (each kernel's
              `eval` record);
  deform_opt  K6's path: the differentiable deform dispatchers
              (`modulated_deform_conv2d_opt` through K6, `_opt2` through
              K3) forward and backward at both call sites' shapes; values
              and gradients against autograd of the plain version;
  pipeline    `ProPainterPipeline.inpaint_video` at 80 frames of 432x240,
              full-width models with seeded random weights, in seven
              configurations on the same weights and clip: fp32 'flash',
              'pallas', and shard_inference with window_batch 4 on the
              card's one-device mesh, the same three in bf16
              (shard_inference with raft_bf16_refine=False), and bf16
              'flash' with raft_bf16_refine=False; each warmed up until
              its CUDA graphs are captured (two videos) and measured once
              (phase `graphs` times fp32 and bf16 'flash' in pairs), each
              of the five others then against one eager run of its
              configuration (outputs, launches, graphs as in phase
              `graphs`), each pipeline's graphs released after its turn;
              then fp32 and bf16 'flash' on the plain stage-4 schedule
              (occupancy_bucketing and encoder_carry off) for their stage
              times and output differences (reported, not gated); each
              configuration's stage-4 plan printed (frames encoded and
              tokenized, generator calls, sub-runs with their buckets and
              carries); output shape/dtype, unmasked pixels unchanged,
              every kernel of each path launched (K1 once per RAFT
              iteration and K7 never, except under shard_inference, the
              reverse; K4, or K5 under 'pallas', once per transformer
              block of each generator call of the pipeline's plan, K4 at
              the plan's (problems, query rows); in bf16 the bf16 forms as
              often as the fp32 run of the configuration launches the
              fp32 ones, and no fp32 form), the fp32 outputs within 12
              max / 0.5 mean LSB of 'flash' (bf16's differences reported,
              not gated);
  graphs      the main path's stages replayed from CUDA graphs
              (`pipeline.ProPainterPipeline(cuda_graphs=...)`,
              `graphs.StageGraphs`) against eager on the pipeline phase's
              clip and weights: in its seven configurations one graphed
              and one eager run after their warm-ups, the uint8 outputs
              equal (or within 12 max / 0.5 mean LSB, reported), the launch
              counts and K4's calls by shape equal, the graphs by stage
              against the plan's call keys (`_graph_keys`), and the
              graphed run's kernels in a profiler trace against its launch
              counts (a replay's counts are accounting); fp32 and bf16
              'flash' on new pipelines: each one's first video, graphs by
              stage, capture seconds and the graphs' GiB against the eager
              peak, the graphs replayed on a second clip of the same
              shape and plan (other frames) against eager, then 3 / 5
              alternating pairs with each stage's decision (graphed median
              below the eager minimum), and one profiled run of each: the
              device's busy share; the evaluation protocol (fp32) over
              videos of four lengths, then the first two again, through
              one pipeline against eager: each video's output, seconds,
              graphs and GiB held;
  small       a 6-frame 144x160 clip on the GPU (kernels) and on the CPU
              (plain versions), fan-in scaled weights, in the three
              configurations ('flash' through `ProInpainter`): uint8
              outputs within 12 max / 0.5 mean LSB, a std of at least 10
              LSB inside the hole, and the float outputs of RAFT, flow
              completion and one generator window within 1e-3 of their
              scale; the golden fixture's clip and schedule in bf16
              ('flash' and 'pallas') on the GPU within 24 max / 1.0 mean
              LSB of fp32 on the CPU; one RAFT chunk with
              raft_bf16_refine=False in both corr layouts (K1 over a bf16
              volume, K7's bf16 form), its flow drift from the fp32 refine
              reported;
  cli         the port's CLI on the fixture clip on the GPU, --weights
              random --bf16 --save_frames (the CLI's I/O needs cv2);
  eval        the evaluation path through the four evaluation CLIs' main()
              on a synthetic DAVIS-layout dataset of two 432x240 videos
              (104 and 73 frames, `EVAL_VIDEOS`) written under build/, with
              seeded .pth files and a seeded i3d_rgb_imagenet.pt (its
              logits head dropped by the loader), TF32 flags at PyTorch's
              defaults (the CLIs must turn TF32 off themselves):
              `evaluate` at the protocol's settings (unchunked, RAFT chunks
              of 60, neighbor_length 20, raft_iter 20) with I3D,
              --warp_error and --profile: finite psnr, ssim, ewarp and
              vfid, the trace written, avg s/frame and each video's stage
              seconds; K1, K2, K3 and K4 launched as the protocol's plans
              say (`_eval_launches`; K4 at the plans' shapes, among them
              `K4_EVAL_SHAPE`), K5 and K7 never; `evaluate_flow_completion`
              on the same videos with its launch counts; `compute_flow`
              on 10 frames and `raft_demo` on the fixture clip (K1 on a
              15 x 27 map), their RAFT region graphed against eager in 3
              alternating pairs (launches, files bit for bit, keep or
              drop), and I3D's region likewise on the two videos; GPU
              against CPU: `evaluate`'s PSNR
              and SSIM on the fixture clip at 96x128, `compute_flow`'s
              .flo files and I3D's features (`_eval_gpu_vs_cpu`);
  train       training on the card (`phase_train`): a few steps of each
              stage of configs/train_*.json at full width (RAFT-big, the
              flow completion, the generator of hidden 512 and depth 8
              with remat, the T-PatchGAN with hinge; 432x240, l_t 10 with
              1 or 6 reference frames, batch 1 per card), the step's
              CUDA-graph regions (`targets`, `update`) against eager in
              alternating pairs from one state with each region's keep or
              drop, capture s and the pool: seconds per step, the
              trainee's forward and backward by CUDA events, peak memory,
              and K1, K2 and K3 launched per step as `_train_launches`
              says (a replayed step's also in a profiler trace), K4, K5
              and K7 never; the plain K3
              backward's time at both sites; one step of each stage at
              32x48 on the GPU against the CPU (losses within 1e-4
              relative, gradients within 1e-3 of scale); the 40-step
              overfit halving the loss; the train CLI for 2 steps of each
              stage on a synthetic YouTube-VOS-layout set written under
              build/, and its resume at step 2;
  dist        data-parallel training (`phase_dist`), both stages at the
              configs' full widths on a global batch of 2 whose holes
              cover 2.3% and 40.5% of the frame: (a) the step in an NCCL
              group of one rank against the plain one-process step
              (within 1e-6), timed at batch 2 from CUDA graphs, and an
              NCCL all-reduce of
              the trainee's gradients; (b) two gloo ranks on the one card,
              a sample each (rank 1 from other weights, rank 0's reaching
              it by broadcast), eager, against the one-process step on
              the batch of 2 (losses within 1e-5 relative, parameters within 1e-4
              of scale where Adam's update is determined), each rank's ms
              a step, all-reduce ms a step, peak memory and K1, K2 and K3
              launches as `_train_launches` says; (c) NCCL with one rank
              per GPU where two or more are visible (else one line says
              it was not run); (d) the train CLI under torchrun's
              environment at world size 1: 2 steps, the step-2
              checkpoint from rank 0, the resume;
  flow_data   RAFT's training data (`phase_flow_data`): synthetic
              FlyingChairs, Sintel, FlyingThings3D, KITTI and HD1K
              layouts at their own frame sizes under build/, each
              curriculum stage's `fetch_flow_dataset` at its crop through
              two shards of `PrefetchLoader` (disjoint), the port's RAFT
              on a batch of 2 (K2 once, K1 20 times), and K1 and K2 at
              each crop's 1/8 map against their plain versions; the
              loader's and RAFT's ms a batch;
  demo        the demo's click-to-mask path (`phase_demo`): SAM vit_h at
              1024x1024 in fp32 with seeded weights through `SamSegmenter`
              and `SamControler` on a synthetic 480x854 frame with two
              positive clicks and one negative: the encoder's ms a frame
              (median and min-max) against its fp32 bound, the decoder's
              ms a click, first_frame_click's ms, the peak memory, no
              launch of K1-K7; GPU against the same model on the CPU
              (1e-3 of scale): the tokens after block 7, the embedding
              (all 32 blocks unless the CPU's projected time is over
              `DEMO_CPU_BUDGET_S`, then the cut is printed), the decoder's
              4 mask logits and IoUs, first_frame_click's logit, and its
              mask wherever |logit| is above the tolerance; SAM's two
              CUDA-graph regions (`SamSegmenter(cuda_graphs=...)`)
              against eager in alternating rounds, in the demo's click
              sequence (3 frames, on each the clicks growing 1, 2, 3; a
              new segmenter a sequence, captures included): the encoder,
              the decoder with `points_bucket` None and 8, each one's
              keep or drop on the segmenter's ms over the sequence, the
              GiB its graphs hold against the eager peak, every mask and
              logit graphed = eager bit for bit, the default regions
              failing if the rule drops one;
  track       the demo's second part (`phase_track`) on a synthetic 480x854
              clip (DAVIS's size) of a textured background and two moving
              objects, seeded weights: `CutieTracker` with the release's
              Cutie (resnet50, nothing cut; norm scales 1 + N(0, 0.1^2),
              its key projection scaled) on 2 objects over 28 frames, so
              the first FIFO trim fires (frame 25) and frames 26-27 read
              the trimmed memory: ms a frame and its split (encode, memory
              read, segment, memory write), memory tokens per write and
              at the trim, peak memory, no launch of K1-K7, its kernels by
              device time, GPU against CPU step by step from the GPU's
              state and on its top-k and foreground decisions (where the
              CPU's own differ, ties within TIE_TOL), the first frames,
              the writes at 5 and 25 (the trim) and the reads after
              them first, the rest as the CPU's budget allows
              (probabilities within STAGE_REL_TOL, masks equal where the
              winner leads by more), these passes eager; Cutie's three
              CUDA-graph regions (`CutieCore(cuda_graphs=...)`) against
              eager over 60 frames in alternating pairs: ms a frame, after
              the first trim too, each region's replay ms and keep or
              drop (a default region dropped fails), the device's busy
              share in a read frame, captures,
              capture s and the graphs' GiB against the eager peak, the
              probabilities graphed = eager bit for bit, also on a second
              clip replayed on the same graphs; `FlowMaskTracker` with
              RAFT in fp32 at raft_iter 20 over 8 frames, its two regions
              against eager in alternating pairs (ms a frame, each
              region's keep or drop, a default one dropped failing, masks
              graphed = eager bit for bit),
              K1 / K2 launches a frame by the counters against RAFT's 20
              and 1 a pair batch and a replayed frame's in a profiler
              trace, one pair's flow GPU against CPU; then
              `TrackingFacade` end to end with the owners' default
              regions: SAM vit_h's click, Cutie's
              track, the bf16 inpaint, with K1-K4's bf16 launches against
              the pipeline's plan and every frame outside the dilated
              mask equal to the (resized) input; then the inpaint again
              with each of K1-K4's bf16 wrappers held against its plain
              version at every distinct shape the video gives it
              (BF16_REL_TOL of scale);
  profile     (only when named) the main path under torch.profiler in fp32
              and bf16: device time by kernel, the device's busy share, and
              host and device time by op shape for one RAFT chunk and one
              generator window; the GemmConv2d layers against cuDNN in fp32
              and bf16.

Prints one line per kernel, then the `{"kernels": [...]}` JSON line (each
kernel's `launches` on the main path, 'flash' or the configuration of
`KERNEL_PATH`, `eval_launches` on the eval phase's `evaluate`,
`train_launches`, each stage's launches in one train step,
`dist_launches`, rank 0's in one step of the two gloo ranks,
`flow_data`, K1's and K2's times at the four RAFT crops, and
`track_launches`, the track phase's, summed: the flow tracker's fp32 K1 /
K2 over the TRACK_FLOW_FRAMES - 1 = 7 tracked frames of its first graphed
track and the facade's bf16 inpaint of its 28 frames, timed once), the
`nvidia-smi` line, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, without that line, if any phase fails or there is no GPU.
Imports nothing of JAX or of `propainter_tpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

PHASES = ("device", "build", "kernels", "deform_opt", "pipeline", "graphs",
          "small", "cli", "eval", "train", "dist", "flow_data", "demo",
          "track")
EXTRA_PHASES = ("profile",)
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 on CUDA cores,
# dense TF32 on the tensor cores and HBM3 bandwidth — the denominators of
# every bound_ms below.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 kernels against their fp32 plain versions: the differences are
# summation order (up to 2304 terms in K3), the online softmax in K4 and
# K5, and K3's, K4's and K5's 3xTF32 products (~2^-21 of each product), a
# few ulp of the largest term; 1e-4 of the output scale leaves > 10x room (one
# pass of TF32 would not: tests/test_torch_kernels.py).
REL_TOL = 1e-4
# bf16 kernels against their bf16 plain versions: both round at the same
# points, so what differs is fp32 summation order, which can move a value
# across a bf16 rounding boundary (one bf16 step, up to 2^-7 of a value),
# twice where the output is rounded again (K3's bias add), and K4's
# rounding of unnormalised probabilities: two bf16 steps of the output
# scale.
BF16_REL_TOL = 2.0 ** -6
# GPU (kernels) vs CPU (plain) on the small clip, uint8 LSB: the fp32
# tolerance of the JAX package's on-chip golden check.
SMALL_MAX_LSB, SMALL_MEAN_LSB = 12, 0.5
# bf16 against fp32 on the golden fixture's clip: the JAX package's bf16
# golden gate (tools/tpu_golden_check.py:17-20)
GOLDEN_BF16_MAX_LSB, GOLDEN_BF16_MEAN_LSB = 24, 1.0
# least std (uint8 LSB) of the small clip's output inside the hole; the
# fan-in scaled weights give ~30 on the CPU
SMALL_MIN_HOLE_STD = 10.0
# GPU vs CPU float stage outputs on the small clip, relative to the output
# scale: fp32 summation order through RAFT's iterations and a few dozen
# layers; on the CPU, transposing convc1's taps moves RAFT's flows by 1.09
# of their scale and swapping the deform weight's kh/kw moves the
# generator's output by 8.0e-2 (the uint8 output by only 5 LSB).
STAGE_REL_TOL = 1e-3


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 50) -> float:
    """Device ms per call of fn: `reps` calls captured in one CUDA graph,
    replayed between two events, so a call shorter than its host-side
    launch is not timed as the host's pace (the wrappers allocate, check
    and launch through ctypes: tens of microseconds)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tensor_core_bounds(n_bytes: float, product_flops: float,
                        cuda_core_ops: float) -> dict:
    """The bounds of a kernel whose products run in 3xTF32 (K1, K3, K4,
    K5): `bound_ms` is "operations (3xTF32)", the larger of the bytes over
    the memory rate and the operations (the products three times over at
    the TF32 tensor-core rate, or the rest on CUDA cores, whichever takes
    longer); `fp32_bound_ms` all operations on CUDA cores, the bound of an
    fp32 kernel."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(3 * product_flops / PEAK_TF32_FLOPS,
                cuda_core_ops / PEAK_FP32_FLOPS) * 1e3
    fp32_ms, fp32_by = _bound(n_bytes, product_flops + cuda_core_ops)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_basis="operations (3xTF32)",
                fp32_bound_ms=fp32_ms, fp32_bound_by=fp32_by)


def _bf16_bounds(n_bytes: float, product_flops: float,
                 cuda_core_ops: float, pv_passes: int = 1) -> dict:
    """The bounds of a bf16 kernel: the larger of the bytes over the
    memory rate and the operations (the products at the bf16 tensor-core
    rate, or the rest on CUDA cores, whichever takes longer). The products
    run once, or for attention with `pv_passes` = 2 (K5's bf16 form, p as
    bf16 hi + lo) Q·Kᵀ, half of `product_flops`, once and P·V, the other
    half, twice."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max((1 + pv_passes) / 2 * product_flops / PEAK_BF16_FLOPS,
                cuda_core_ops / PEAK_FP32_FLOPS) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_basis=("bf16 tensor cores" if pv_passes == 1 else
                             f"bf16 tensor cores, 1 + {pv_passes} passes"))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _compare(name, got, ref, rel_tol=REL_TOL) -> float:
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    ok = err <= rel_tol * scale
    print(f"  {name}: max_abs_err={err:.3e} (tolerance "
          f"{rel_tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# K3's two call sites: (name, positions B * H * W, C, C / dg)
DEFORM_SITES = (("generator", 60 * 108, 128, 8),
                ("flow completion", 2 * 30 * 54, 256, 16))


# K1's queries per RAFT iteration on the main path: 12 frame pairs x 2
# directions of 30 x 54 (1/8 of 240 x 432)
K1_QUERIES = 24 * 30 * 54

# K4's (problems, query rows, keys) on the main path's 11-frame windows
# under occupancy bucketing: 4 heads x a bucket of 8 or 4 dirty windows;
# 19 frames (11 local + 8 reference) of 45 window tokens, or on the last
# block the 11 local frames' only; keys of 10 or 9 selected frames (the
# temporal dilation), 238 a frame (45 window + 148 rolled band + 45
# pooled). The pipeline phase checks that the run launches each.
K4_BUCKET_SHAPES = ((32, 855, 2380), (16, 855, 2380), (32, 495, 2142),
                    (16, 495, 2142))
# K4's largest (problems, query rows, keys) under the evaluation protocol
# (`cli/evaluate.py`: neighbor_length 20, uncapped references) on the eval
# phase's 104-frame video: 4 heads x a bucket of 8 windows, 32 frames (21
# local + 11 references) of 45 window tokens, 16 selected frames of 238
# keys; 63 of the video's 88 calls
K4_EVAL_SHAPE = (32, 1440, 3808)


def _tensor_core_launches(n_sm: int) -> list:
    """The main path's launches of the tensor-core kernels: (library,
    kernel symbol, site, launch-info symbol and its int arguments,
    grid(info)), info = {resident blocks per SM, dynamic shared memory
    bytes, threads per block, rows per block, blocks per row tile}. K1 and
    its bf16 form: the 32- and 64-query tiles of one RAFT iteration (their
    persistent blocks, one per resident slot, walk them, so their waves are
    rounds of tiles); K4 and K5: 16 windows x 4 heads of 855 query rows;
    K3 and its bf16 form: each call site's positions in 64-position tiles,
    times the cluster split the wrapper picks for this card's resident
    blocks."""
    from propainter_tpu_torch.ops import deform

    def attention_grid(info, rows=855, problems=64):
        return -(-rows // info[3]) * info[4] * problems

    def bucketed(symbol, prefix=""):
        return [("window_attention", symbol,
                 f"{prefix}bucketed, {g} problems x {rows} rows",
                 symbol.replace("_kernel", "_launch_info"), (),
                 lambda info, r=rows, g=g: attention_grid(info, r, g))
                for g, rows, _ in K4_BUCKET_SHAPES]

    launches = [("corr_lookup_moenc", "corr_lookup_moenc_kernel",
                 "main path, tiles", "corr_lookup_moenc_launch_info", (),
                 lambda info: -(-K1_QUERIES // info[3]))]
    launches += [(lib, f"{lib}_kernel", "main path", f"{lib}_launch_info",
                  (), attention_grid)
                 for lib in ("window_attention", "sparse_window_attention")]
    launches += bucketed("window_attention_kernel")
    g, rows, _ = K4_EVAL_SHAPE
    launches.append(("window_attention", "window_attention_kernel",
                     f"eval, {g} problems x {rows} rows",
                     "window_attention_launch_info", (),
                     lambda info: attention_grid(info, rows, g)))
    for site, n_pos, C, cg in DEFORM_SITES:
        launches.append((
            "deform_conv", "deform_conv_kernel", site,
            "modulated_deform_conv2d_launch_info", (cg,),
            lambda info, n=n_pos, c=C: -(-n // info[3]) * deform.k3_split(
                n, c, n_sm * info[0])))
    # the bf16 forms: K1's 64-query tiles (its persistent blocks,
    # `corr.k1_bf16_grid`, walk them); one block per row tile for K4 and K5
    # (128-query tiles of the wgmma tile, attention_wgmma.cuh); K3's
    # 64-position tiles times the wrapper's split of their 64-channel chunks
    launches += [
        ("corr_lookup_moenc", "corr_lookup_moenc_bf16_kernel",
         "bf16 main path, tiles", "corr_lookup_moenc_bf16_launch_info", (),
         lambda info: -(-K1_QUERIES // info[3])),
        ("window_attention", "window_attention_bf16_kernel",
         "bf16 main path", "window_attention_bf16_launch_info", (),
         attention_grid),
        ("sparse_window_attention", "sparse_window_attention_bf16_kernel",
         "bf16 main path", "sparse_window_attention_bf16_launch_info", (),
         attention_grid)]
    launches += bucketed("window_attention_bf16_kernel", "bf16 ")
    for site, n_pos, C, cg in DEFORM_SITES:
        launches.append((
            "deform_conv", "deform_conv_bf16_kernel", f"{site}, bf16",
            "modulated_deform_conv2d_bf16_launch_info", (cg,),
            lambda info, n=n_pos, c=C: -(-n // info[3]) * deform.k3_split(
                n, c, n_sm * info[0], deform.K3_BF16_CHUNK)))
    return launches


def _ptxas_report(log: str) -> dict:
    """{kernel symbol: registers, spill stores/loads and static shared
    memory in bytes} from `-Xptxas -v` output."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                report[fn].update(spill_stores=int(m[1]),
                                  spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[fn]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                report[fn]["static_smem"] = int(m[1])
    return report


def _sass_counts(sass: str, opcode: str) -> dict:
    """{kernel symbol: instructions with `opcode`} in `cuobjdump -sass`."""
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def phase_build(state: dict) -> None:
    """Compile every kernel, then report on the tensor-core kernels (K1,
    K3, K4, K5 and their bf16 forms): registers, spills and shared memory,
    the tensor-core instructions of their SASS (HMMA: mma.sync; HGMMA:
    wgmma), resident blocks per SM and the waves of each main-path grid on
    this card's SMs; and on K7 and its bf16 form (CUDA cores only)
    registers, spills and shared memory. Fails if a tensor-core kernel has
    neither an HMMA nor an HGMMA instruction, or fits no block on an SM,
    or any of them spills."""
    import ctypes

    import torch
    from propainter_tpu_torch import _build

    times = _build.build()
    print(f"  built {sorted(times)} in "
          f"{max(times.values(), default=0.0):.1f} s")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    report, failures = {}, []
    for lib, symbol, site, info_fn, args, grid_of in _tensor_core_launches(
            n_sm):
        if symbol not in report:
            ptxas = {fn: r for fn, r in
                     _ptxas_report(_build.build_log(lib)).items()
                     if symbol in fn}
            sass = _build.sass(lib)
            hmma, hgmma = (sum(n for fn, n in
                               _sass_counts(sass, opcode).items()
                               if symbol in fn)
                           for opcode in ("HMMA", "HGMMA"))
            report[symbol] = dict(ptxas=ptxas, hmma=hmma, hgmma=hgmma,
                                  sites={})
            for fn, r in ptxas.items():
                print(f"  {fn}: {r.get('registers')} registers, "
                      f"{r.get('spill_stores')} B spill stores, "
                      f"{r.get('spill_loads')} B spill loads, "
                      f"{r.get('static_smem', 0)} B static shared memory")
            print(f"  {symbol}: {hmma} HMMA, {hgmma} HGMMA instructions")
            if not ptxas:
                failures.append(f"{symbol}: no -Xptxas -v report")
            if hmma == 0 and hgmma == 0:
                failures.append(f"{symbol}: no HMMA or HGMMA instruction")
            if any(r.get("spill_stores", 0) for r in ptxas.values()):
                failures.append(f"{symbol}: spills")
            # ptxas says when it had to serialize a kernel's wgmma
            for line in _build.build_log(lib).splitlines():
                if "wgmma" in line and symbol in line:
                    print(f"  {symbol}: {line.strip()}")
        info = (ctypes.c_int * 5)()
        fn = _build.function(lib, info_fn, 1, len(args))
        _build.check(fn(ctypes.addressof(info), *args, None), info_fn)
        blocks_per_sm, smem, threads, block_rows, split = info
        grid = grid_of(info)
        waves = grid / (n_sm * blocks_per_sm) if blocks_per_sm else math.inf
        report[symbol]["sites"][site] = dict(
            dynamic_smem=smem, threads=threads, rows_per_block=block_rows,
            blocks_per_sm=blocks_per_sm, grid=grid, sms=n_sm, waves=waves,
            grid_per_sm=grid / n_sm)
        print(f"  {symbol} ({site}): {smem} B dynamic shared memory, "
              f"{threads} threads x {blocks_per_sm} blocks per SM; grid "
              f"{grid} blocks of {block_rows} rows = {grid / n_sm:.2f} per "
              f"SM, {waves:.2f} waves of {n_sm * blocks_per_sm} resident "
              f"blocks on {n_sm} SMs")
        if blocks_per_sm < 1:
            failures.append(f"{symbol} ({site}): no block fits on an SM")
    # K7 and its bf16 form run on CUDA cores: registers, spills and shared
    # memory; for the bf16 form also its persistent grid at the main path
    for symbol in ("corr_lookup_kernel", "corr_lookup_bf16_kernel"):
        ptxas = {fn: r for fn, r in
                 _ptxas_report(_build.build_log("corr_lookup")).items()
                 if symbol in fn}
        report[symbol] = dict(ptxas=ptxas)
        for fn, r in ptxas.items():
            print(f"  {fn}: {r.get('registers')} registers, "
                  f"{r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads, "
                  f"{r.get('static_smem', 0)} B static shared memory")
        if not ptxas:
            failures.append(f"{symbol}: no -Xptxas -v report")
        if any(r.get("spill_stores", 0) for r in ptxas.values()):
            failures.append(f"{symbol}: spills")
    info = (ctypes.c_int * 5)()
    fn = _build.function("corr_lookup", "corr_lookup_bf16_launch_info", 1, 0)
    _build.check(fn(ctypes.addressof(info), None),
                 "corr_lookup_bf16_launch_info")
    blocks_per_sm, smem, threads, in_flight, slots = info
    grid = min(slots, -(-K1_QUERIES // (threads // 32)))
    report["corr_lookup_bf16_kernel"]["sites"] = {"main path": dict(
        dynamic_smem=smem, threads=threads, queries_in_flight=in_flight,
        blocks_per_sm=blocks_per_sm, grid=grid, sms=n_sm,
        waves=grid / slots, queries_per_warp=K1_QUERIES / (
            grid * threads // 32))}
    print(f"  corr_lookup_bf16_kernel (main path): {smem} B dynamic shared "
          f"memory ({in_flight} queries in flight a warp), {threads} threads "
          f"x {blocks_per_sm} blocks per SM; persistent grid {grid} blocks = "
          f"{grid / slots:.2f} waves of {slots} resident blocks on {n_sm} "
          f"SMs, {K1_QUERIES / (grid * threads // 32):.2f} queries a warp")
    if blocks_per_sm < 1:
        failures.append("corr_lookup_bf16_kernel: no block fits on an SM")
    state["build"] = report
    if failures:
        raise AssertionError("; ".join(failures))


def phase_kernels(records: dict, state: dict) -> None:
    """Each kernel against its plain version at the main path's shapes;
    K7 bf16's sector floor into `state`."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.ops import flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    # ---- K2 + K1: one RAFT chunk at 432x240 (12 pairs x 2 directions),
    # and one of the evaluation protocol's 60-frame chunks (118)
    level0 = _level0(randn, 24)
    pyr, records["corr_pyramid_build"] = _check_k2(level0)
    records["corr_lookup_moenc"] = _check_k1(randn, pyr)
    level0_eval = _level0(randn, EVAL_RAFT_PAIRS)
    pyr_eval, k2_eval = _check_k2(level0_eval)
    records["corr_pyramid_build"]["eval"] = k2_eval
    records["corr_lookup_moenc"]["eval"] = _check_k1(randn, pyr_eval)
    del level0_eval, pyr_eval
    torch.cuda.empty_cache()

    records["corr_lookup"] = _check_k7(randn, pyr)

    records["modulated_deform_conv2d"], records["deform_sample"] = (
        _check_deform(randn))

    # ---- K4: one transformer block of one window (16 windows x 4 heads)
    Gp, Tq, Tk, ch = 64, 855, 2380, 128
    q, k, v = (randn(1, Gp, T_, ch) for T_ in (Tq, Tk, Tk))
    kb = torch.zeros(1, Tk, device=dev)
    kb[:, -238:] = flash_attention.NEG_INF      # one padded reference frame
    scale = 1.0 / math.sqrt(ch)
    got = flash_attention.flash_window_attention(q, k, v, kb, scale)
    want = flash_attention._flash_window_attention_plain(q, k, v, kb, scale)
    err = _compare("flash_window_attention", got, want)
    got_nb = flash_attention.flash_window_attention(q, k, v, None, scale)
    want_nb = flash_attention._flash_window_attention_plain(
        q, k, v, None, scale)
    err = max(err, _compare("flash_window_attention (no bias)", got_nb,
                            want_nb))
    # ragged: a partial query tile and a partial key tile, and a bias that
    # masks a whole 32-key tile
    qr, kr, vr = (randn(1, 3, T_, ch) for T_ in (130, 70, 70))
    kbr = torch.zeros(1, 70, device=dev)
    kbr[:, 32:64] = flash_attention.NEG_INF
    for b_, what in ((kbr, "bias"), (None, "no bias")):
        err = max(err, _compare(
            f"flash_window_attention Tq 130 Tk 70 ({what})",
            flash_attention.flash_window_attention(qr, kr, vr, b_, scale),
            flash_attention._flash_window_attention_plain(qr, kr, vr, b_,
                                                          scale)))
    mask4 = kb[:, None, None, :]
    dense = dict(
        shape=f"q {tuple(q.shape)} k {tuple(k.shape)}",
        ms=_time_ms(lambda: flash_attention.flash_window_attention(
            q, k, v, kb, scale), 10),
        plain_ms=_time_ms(
            lambda: flash_attention._flash_window_attention_plain(
                q, k, v, kb, scale), 5),
        library_ms=_time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                                   scale=scale), 10),
        **_tensor_core_bounds(_nbytes(q, k, v, kb, got),
                              Gp * 4 * Tq * Tk * ch, Gp * 5 * Tq * Tk))
    print(f"  flash_window_attention without bucketing {dense['shape']}: "
          f"{dense['ms']:.4f} ms (bound {dense['bound_ms']:.4f})")
    records["flash_window_attention"] = _k4_record(
        "flash_window_attention", err, dense,
        _check_k4_shapes(randn, state),
        eval=_check_k4_shapes(randn, state, shapes=(K4_EVAL_SHAPE,),
                              site="eval")[0])
    records["sparse_window_attention"] = _check_k5(randn)
    records.update(_check_bf16(randn, level0, state))
    for r in records.values():
        for site, rr in (("", r), (" (flow completion)",
                                   r.get("flow_completion_site"))):
            if rr is None:
                continue
            tc = (f", {rr['bound_basis']}; fp32 "
                  f"{rr['fp32_bound_ms']:.4f}" if "fp32_bound_ms" in rr
                  else " on bf16 tensor cores"
                  if rr.get("bound_basis") == "bf16 tensor cores" else "")
            eager = (f", eager {rr['eager_ms']:.4f} ms" if "eager_ms" in rr
                     else "")
            print(f"  {r['name']}{site}: {rr['ms']:.4f} ms{eager} (plain "
                  f"{rr['plain_ms']:.3f}, bound {rr['bound_ms']:.4f} by "
                  f"{rr['bound_by']}{tc}, library {rr['library_ms']})")


def _level0(randn, B: int, H8: int = 30, W8: int = 54, D: int = 256):
    """RAFT's level-0 correlation volume of B pair-directions at 1/8 of
    432 x 240: (B * H8 * W8, H8, W8), fmap1 . fmap2 / sqrt(D)."""
    import torch

    fmap1, fmap2 = randn(B, H8 * W8, D), randn(B, H8 * W8, D)
    level0 = torch.bmm(fmap1 / math.sqrt(D), fmap2.transpose(1, 2))
    return level0.reshape(B * H8 * W8, H8, W8).contiguous()


def _check_k2(level0):
    """K2 on `level0` against its plain version, timed beside it, with its
    bound: (the pyramid, the record)."""
    from propainter_tpu_torch.ops import corr

    pyr = corr.corr_pyramid_build(level0, 4)
    ref = corr._corr_pyramid_build_plain(level0, 4)
    n = level0.shape[0] // (level0.shape[1] * level0.shape[2])
    err = max(_compare(f"corr_pyramid_build ({n} pair-directions) L{i}",
                       a, b)
              for i, (a, b) in enumerate(zip(pyr[1:], ref[1:]), 1))
    del ref
    ms = _time_ms(lambda: corr.corr_pyramid_build(level0, 4), 20)
    plain_ms = _time_ms(lambda: corr._corr_pyramid_build_plain(level0, 4), 20)
    n_pool = sum(p.numel() for p in pyr[1:])
    bound_ms, bound_by = _bound(_nbytes(*pyr), 4 * n_pool)
    return pyr, dict(
        name="corr_pyramid_build", route="cuda",
        source="propainter_tpu_torch/csrc/corr_pyramid_build.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:63",
        shape=f"level0 {tuple(level0.shape)}", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)


def _lookup_library(pyr, coords):
    """The reference RAFT's route to K7's function (its `bilinear_sampler`),
    as one function of no arguments (its sampling grids prepared outside
    it): `F.grid_sample` of each level (align_corners=True, zeros outside)
    at the 9 x 9 window, x offset major -> (N, 324). Over bf16 levels the
    grids are bf16 too (`F.grid_sample` takes one dtype), so they sample
    at other points than the lookup: a yardstick of time only."""
    import torch
    import torch.nn.functional as F

    N = pyr[0].shape[0]
    d = torch.arange(-4, 5, device=coords.device, dtype=torch.float32)
    c = coords.reshape(N, 2)
    maps, grids = [], []
    for lvl, p in enumerate(pyr):
        Hl, Wl = p.shape[1:]
        gx = (c[:, 0, None, None] / 2 ** lvl + d[:, None]) * (2 / (Wl - 1))
        gy = (c[:, 1, None, None] / 2 ** lvl + d[None, :]) * (2 / (Hl - 1))
        grids.append(torch.stack([(gx - 1).expand(N, 9, 9),
                                  (gy - 1).expand(N, 9, 9)], -1).to(p.dtype))
        maps.append(p[:, None])

    def library():
        return torch.cat([
            F.grid_sample(m, gr, mode="bilinear", padding_mode="zeros",
                          align_corners=True).reshape(N, 81)
            for m, gr in zip(maps, grids)], 1)

    return library


def _k1_library(pyr, coords, w, bias):
    """The reference RAFT's route to K1's function: `_lookup_library`, then
    convc1 as one `addmm` and relu (in bf16 over bf16 levels)."""
    import torch

    windows = _lookup_library(pyr, coords)
    return lambda: torch.relu(torch.addmm(bias, windows(), w))


def _in_range_taps(pyr, coords) -> int:
    """The integer taps of every query's 10 x 10 windows that lie inside
    its maps: the bytes a lookup must read (zeros outside are not read)."""
    import torch

    def in_range(c, size):   # in-range taps of c0-4 .. c0+5
        c0 = torch.floor(c)
        return ((c0 + 6).clamp(0, size) - (c0 - 4).clamp(0, size)).clamp(0)

    return int(sum(
        (in_range(coords[..., 0] / 2 ** lvl, p.shape[2])
         * in_range(coords[..., 1] / 2 ** lvl, p.shape[1])).sum().item()
        for lvl, p in enumerate(pyr)))


def _far_off_case(randn):
    """A ragged 8 x 13 map (104 queries; level 3 is 1 x 1) with
    coordinates up to 40 pixels outside it: (pyramid, coords)."""
    import torch
    from propainter_tpu_torch.ops import corr
    from propainter_tpu_torch.ops.warp import coords_grid

    dev = torch.device("cuda")
    f1, f2 = randn(1, 8, 13, 256), randn(1, 8, 13, 256)
    small = corr.corr_pyramid(f1, f2, 4)
    far = coords_grid(1, 8, 13, device=dev) + randn(1, 8, 13, 2, std=15.0)
    far[0, 0, :3] = torch.tensor([[-40.0, 3.0], [52.0, 47.0], [6.5, -40.0]],
                                 device=dev)
    return small, far.contiguous()


def _check_k7(randn, pyr) -> dict:
    """K7 at one RAFT iteration of the main path (the pyramid of 24
    pair-directions at 30 x 54) against its plain version, timed by
    CUDA-graph replay (`eager_ms` beside) and beside the reference RAFT's
    four `F.grid_sample` calls (`_lookup_library`, first held to the plain
    version); also at the ragged, far-off 8 x 13 map."""
    from propainter_tpu_torch.ops import corr
    from propainter_tpu_torch.ops.warp import coords_grid

    dev = pyr[0].device
    N, H8, W8 = pyr[0].shape
    B = N // (H8 * W8)
    coords = (coords_grid(B, H8, W8, device=dev)
              + randn(B, H8, W8, 2, std=3.0)).contiguous()

    def run():
        return corr.corr_lookup(pyr, coords)

    def plain():
        return corr._corr_lookup_plain(pyr, coords)

    got, want = run(), plain()
    err = _compare("corr_lookup", got, want)
    library = _lookup_library(pyr, coords)
    _compare("grid_sample yardstick vs plain corr_lookup",
             library().reshape(want.shape), want)
    ms, eager_ms = _graph_ms(run), _time_ms(run, 50)
    plain_ms = _time_ms(plain, 5)
    library_ms = _graph_ms(library)
    small, far = _far_off_case(randn)
    err = max(err, _compare(
        "corr_lookup maps 8 x 13, coordinates to 40 px outside",
        corr.corr_lookup(small, far), corr._corr_lookup_plain(small, far)))
    n_q = coords.shape[0] * H8 * W8
    bound_ms, bound_by = _bound(
        4 * _in_range_taps(pyr, coords) + _nbytes(coords, got),
        n_q * 324 * 7)
    return dict(
        name="corr_lookup", route="cuda",
        source="propainter_tpu_torch/csrc/corr_lookup.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:363",
        shape=f"coords {tuple(coords.shape)}", max_abs_err=err, ms=ms,
        eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by)


def _check_k1(randn, pyr) -> dict:
    """K1 at one RAFT iteration of the main path (the pyramid of 24
    pair-directions at 30 x 54) against its plain version, timed by
    CUDA-graph replay (`eager_ms` beside) and beside the reference RAFT's
    route (`_k1_library`, first held to the plain version); also at a
    ragged 8 x 13 map (104 queries: three full 32-query tiles and a partial
    one; level 3 is 1 x 1) with coordinates up to 40 pixels outside it."""
    from propainter_tpu_torch.ops import corr
    from propainter_tpu_torch.ops.warp import coords_grid

    dev = pyr[0].device
    N, H8, W8 = pyr[0].shape
    B = N // (H8 * W8)
    coords = (coords_grid(B, H8, W8, device=dev)
              + randn(B, H8, W8, 2, std=3.0)).contiguous()
    w = randn(324, 256, std=0.02)
    bias = randn(256, std=0.02)

    def run():
        return corr.corr_lookup_moenc(pyr, coords, w, bias)

    def plain():
        return corr._corr_lookup_moenc_plain(pyr, coords, w, bias, 4)

    got, want = run(), plain()
    err = _compare("corr_lookup_moenc", got, want)
    library = _k1_library(pyr, coords, w, bias)
    _compare("grid_sample + addmm yardstick vs plain corr_lookup_moenc",
             library().reshape(want.shape), want)
    ms, eager_ms = _graph_ms(run), _time_ms(run, 50)
    plain_ms = _time_ms(plain, 5)
    library_ms = _graph_ms(library)

    small, far = _far_off_case(randn)
    err = max(err, _compare(
        "corr_lookup_moenc maps 8 x 13, coordinates to 40 px outside",
        corr.corr_lookup_moenc(small, far, w, bias),
        corr._corr_lookup_moenc_plain(small, far, w, bias, 4)))
    n_q = coords.shape[0] * H8 * W8
    return dict(
        name="corr_lookup_moenc", route="cuda",
        source="propainter_tpu_torch/csrc/corr_lookup_moenc.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:166",
        shape=f"coords {tuple(coords.shape)}", max_abs_err=err, ms=ms,
        eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
        **_tensor_core_bounds(4 * _in_range_taps(pyr, coords)
                              + _nbytes(coords, w, bias, got),
                              n_q * 2 * 324 * 256, n_q * 324 * 7))


def _deform_inputs(randn, Bd, Hd, Wd, C, dg, max_res):
    """x, offset (max_res * tanh of noise plus one flow-like shift per
    position), mask, weight and bias of a deform call site."""
    import torch

    x = randn(Bd, Hd, Wd, C)
    off = (max_res * torch.tanh(randn(Bd, Hd, Wd, dg, 9, 2))
           + randn(Bd, Hd, Wd, 1, 1, 2, std=2.0)).contiguous()
    msk = torch.sigmoid(randn(Bd, Hd, Wd, dg, 9))
    return x, off, msk, randn(3, 3, C, 128, std=0.02), randn(128, std=0.02)


def _check_deform(randn) -> tuple:
    """K3 and K6 records at both call sites on the same inputs: the
    generator's feature propagation (the record) and the flow completion's
    (`flow_completion_site`). K3 is timed beside its plain version, the
    unfused route (`modulated_deform_conv2d_fused`: K6 plus one cuBLAS
    GEMM, context only: two calls the main path never takes) and at every
    cluster split; K6 beside F.grid_sample x mask (its yardstick). Both are
    also held to their plain versions at a ragged 5 x 13 image with
    coordinates far outside it, K3 at every group width."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.ops import deform

    k3, k6 = [], []
    for Bd, Hd, Wd, C, dg, max_res in ((1, 60, 108, 128, 16, 3.0),
                                       (2, 30, 54, 256, 16, 5.0)):
        x, off, msk, wt, bs = _deform_inputs(randn, Bd, Hd, Wd, C, dg,
                                             max_res)
        shape = f"x {(Bd, Hd, Wd, C)} dg {dg}"
        got = deform.modulated_deform_conv2d(x, off, msk, wt, bs)
        want = deform._modulated_deform_conv2d_plain(x, off, msk, wt, bs)
        err = _compare(f"modulated_deform_conv2d {shape}", got, want)

        def run_k3(split=None):
            return deform.modulated_deform_conv2d(x, off, msk, wt, bs,
                                                  split=split)

        ms, eager_ms = _graph_ms(run_k3), _time_ms(run_k3, 50)
        plain_ms = _time_ms(
            lambda: deform._modulated_deform_conv2d_plain(
                x, off, msk, wt, bs), 5)
        unfused_ms = _graph_ms(lambda: deform.modulated_deform_conv2d_fused(
            x, off, msk, wt, bs))
        n_chunks = 9 * C // deform.K3_CHUNK
        split_ms = {s: _graph_ms(lambda: run_k3(s))
                    for s in range(1, deform.K3_MAX_SPLIT + 1)
                    if n_chunks % s == 0}
        n_pos = Bd * Hd * Wd
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        slots = n_sm * deform.k3_launch_info(C // dg)[0]
        k3.append(dict(
            shape=shape, max_abs_err=err, ms=ms, eager_ms=eager_ms,
            plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms,
            split=deform.k3_split(n_pos, C, slots), split_ms=split_ms,
            **_tensor_core_bounds(_nbytes(x, off, msk, wt, bs, got),
                                  n_pos * 2 * 9 * C * 128,
                                  n_pos * 9 * C * 12)))
        by_split = ", ".join(f"{s}: {t:.4f}" for s, t in split_ms.items())
        print(f"  modulated_deform_conv2d {shape}: split {k3[-1]['split']}; "
              f"device ms by split {by_split}; eager {eager_ms:.4f} ms; "
              f"unfused (K6 + GEMM) {unfused_ms:.4f} ms")

        sy, sx = (c.contiguous() for c in deform._tap_coords(off))
        s6 = deform.deform_sample(x, sy, sx, msk, dg)
        err = _compare(f"deform_sample {shape}", s6,
                       deform._deform_sample_plain(x, sy, sx, msk, dg))
        _compare(f"modulated_deform_conv2d_fused vs K3 {shape}",
                 deform.modulated_deform_conv2d_fused(x, off, msk, wt, bs),
                 got)
        def run_k6():
            return deform.deform_sample(x, sy, sx, msk, dg)

        ms, eager_ms = _graph_ms(run_k6), _time_ms(run_k6, 50)
        plain_ms = _time_ms(
            lambda: deform._deform_sample_plain(x, sy, sx, msk, dg), 5)
        # yardstick: F.grid_sample per group with the 9 taps along the
        # width, times the mask (the layouts prepared outside the timing)
        Cg = C // dg
        xg = x.reshape(Bd, Hd, Wd, dg, Cg).permute(0, 3, 4, 1, 2)
        xg = xg.reshape(Bd * dg, Cg, Hd, Wd).contiguous()

        def per_group(a):
            return a.permute(0, 3, 1, 2, 4).reshape(Bd * dg, Hd, Wd * 9)

        grid = torch.stack([per_group(sx) * (2.0 / (Wd - 1)) - 1.0,
                            per_group(sy) * (2.0 / (Hd - 1)) - 1.0], -1)
        mg = per_group(msk)[:, None].contiguous()

        def library():
            return F.grid_sample(xg, grid, mode="bilinear",
                                 padding_mode="zeros",
                                 align_corners=True) * mg

        lib = library().reshape(Bd, dg, Cg, Hd, Wd, 9)
        _compare(f"grid_sample yardstick vs K6 {shape}",
                 lib.permute(0, 3, 4, 1, 5, 2), s6)
        library_ms = _graph_ms(library)
        bound_ms, bound_by = _bound(_nbytes(x, sy, sx, msk, s6),
                                    12 * s6.numel())
        k6.append(dict(shape=shape, max_abs_err=err, ms=ms,
                       eager_ms=eager_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms))

    # ragged: 65 positions (one full tile and one of a single position),
    # every group width, coordinates up to 40 pixels outside the image
    for C, dg in ((128, 32), (128, 16), (256, 16), (128, 4)):
        x, off, msk, wt, bs = _deform_inputs(randn, 1, 5, 13, C, dg, 3.0)
        off = (off * 8.0).contiguous()
        what = f"x (1, 5, 13, {C}) dg {dg}, offsets to 40 px"
        k3[0]["max_abs_err"] = max(k3[0]["max_abs_err"], _compare(
            f"modulated_deform_conv2d {what}",
            deform.modulated_deform_conv2d(x, off, msk, wt, bs),
            deform._modulated_deform_conv2d_plain(x, off, msk, wt, bs)))
        if C // dg in (8, 16):
            sy, sx = (c.contiguous() for c in deform._tap_coords(off))
            k6[0]["max_abs_err"] = max(k6[0]["max_abs_err"], _compare(
                f"deform_sample {what}",
                deform.deform_sample(x, sy, sx, msk, dg),
                deform._deform_sample_plain(x, sy, sx, msk, dg)))
    common = dict(route="cuda",
                  source="propainter_tpu_torch/csrc/deform_conv.cu")
    return (dict(name="modulated_deform_conv2d", **common,
                 replaces="propainter_tpu/ops/deform_pallas.py:173",
                 **k3[0], flow_completion_site=k3[1]),
            dict(name="deform_sample", **common,
                 replaces="propainter_tpu/ops/deform_pallas.py:38", **k6[0],
                 flow_completion_site=k6[1]))


def _smoke_occupancy():
    """(1, 16) occupancy of the main path's middle generator window (the
    local frames of the window centred on frame 40), through the
    generator's own mask chain: the dilated masks resized to the encoder's
    feature grid (1/4 of the frame), `token_masks`, `window_occupancy`."""
    import numpy as np
    import torch
    from propainter_tpu_torch.models.propainter import (token_masks,
                                                        window_occupancy)
    from propainter_tpu_torch.ops.interp import resize
    from propainter_tpu_torch.pipeline import PipelineConfig
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    T, H, W = 80, 240, 432
    _, mask = _synthetic_clip(T, H, W, seed=0)
    stride = PipelineConfig().neighbor_length // 2
    local = mask[40 - stride:40 + stride + 1]
    m = np.stack([binary_dilation_cross(f, 4) for f in local])
    m = torch.from_numpy(m).float().cuda()[None, ..., None]
    feat = resize(m, (H // 4, W // 4), "nearest")
    return window_occupancy(token_masks(feat), (5, 9))


def _check_k5(randn, dtype=None) -> dict:
    """K5 at one transformer block of one generator window of the 'pallas'
    path: 16 windows x 4 heads, 19 frames (11 local, 8 reference, the last
    one padded), 45 tokens per window, 45 pooled tokens. Against its plain
    version at the smoke clip's occupancy, all clean and all dirty, for
    both temporal-dilation parities; timed beside its plain version and
    F.scaled_dot_product_attention over the dirty problems (the
    yardstick). In fp32 also beside the 'flash' path's K4 plus branch B on
    the same inputs (the A/B); with dtype=bfloat16 K5's bf16 form on bf16
    windows (BF16_REL_TOL, SDPA in bf16), beside the fp32 K5 on the same
    values."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.models.propainter import _valid_rolled_indices
    from propainter_tpu_torch.ops import attention, flash_attention

    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    attend = (attention.sparse_window_attention_bf16 if bf16
              else attention.sparse_window_attention)
    tol = BF16_REL_TOL if bf16 else REL_TOL
    n_head, nW, T, win, P, ch = 4, 16, 19, 45, 45, 128
    BH = n_head
    wq, wk, wv = (randn(BH, nW, T, win, ch).to(dtype) for _ in range(3))
    rk, rv = (randn(BH, nW, 4, T, win, ch).to(dtype) for _ in range(2))
    pk, pv = (randn(BH, T, P, ch).to(dtype) for _ in range(2))
    valid_idx = torch.as_tensor(_valid_rolled_indices((5, 9), (3, 5)),
                                device=dev)
    roll_valid = torch.zeros(4 * win, dtype=torch.bool, device=dev)
    roll_valid[valid_idx] = True
    frame_valid = torch.ones(T, dtype=torch.bool, device=dev)
    frame_valid[-1] = False                      # one padded reference frame

    def static_sel(parity):
        s = torch.zeros(T, dtype=torch.bool, device=dev)
        s[parity::2] = True
        return s

    occs = {"smoke": _smoke_occupancy(),
            "all clean": torch.zeros(1, nW, device=dev),
            "all dirty": torch.ones(1, nW, device=dev)}
    inputs = (wq, wk, wv, rk, rv, pk, pv, roll_valid)
    name = "sparse_window_attention" + ("_bf16" if bf16 else "")

    def k5(occ, fsel):
        return attend(*inputs, occ, fsel, n_head)

    err = 0.0
    for occ_name, occ in occs.items():
        for parity in (0, 1):
            fsel = (static_sel(parity) & frame_valid)[None]
            err = max(err, _compare(
                f"{name} {occ_name}, parity {parity}",
                k5(occ, fsel), attention._sparse_window_attention_plain(
                    *inputs, occ, fsel, n_head), tol))
    # every window dirty, one selected frame or none (the mean of v)
    one = torch.zeros(1, T, dtype=torch.bool, device=dev)
    one[0, 3] = True
    for what, fsel in (("one selected frame", one),
                       ("no selected frame", torch.zeros_like(one))):
        err = max(err, _compare(
            f"{name} all dirty, {what}", k5(occs["all dirty"], fsel),
            attention._sparse_window_attention_plain(
                *inputs, occs["all dirty"], fsel, n_head), tol))
    fsel = (static_sel(0) & frame_valid)[None]
    scale = 1.0 / math.sqrt(ch)

    def bound(occ):
        """Bounds from the operations and bytes this run's occupancy and
        frame selection need (with K4's count of 5 per logit for the
        softmax). Every window reads its queries and writes its output; a
        clean window reads its own keys and values of every frame; a dirty
        one those of the selected frames, their valid rolled rows, and
        (once per batch·head) their pooled tokens."""
        dirty = int((occ.to(torch.int32) > 0).sum())
        Ts = int(fsel.sum())
        keys = Ts * (win + len(valid_idx) + P)
        logits = (dirty * n_head * T * win * keys
                  + (nW - dirty) * n_head * T * win * win)
        rows = BH * (2 * nW * T * win                            # q, out
                     + 2 * (nW - dirty) * T * win                # clean k, v
                     + 2 * dirty * Ts * (win + len(valid_idx))   # dirty k, v
                     + (2 * Ts * P if dirty else 0))             # pooled k, v
        n_bytes = rows * ch * wq.element_size() + _nbytes(
            occ, fsel, roll_valid)
        if not bf16:
            return _tensor_core_bounds(n_bytes, 4 * ch * logits, 5 * logits)
        fp32_ms, fp32_by = _bound(n_bytes, 4 * ch * logits + 5 * logits)
        return dict(_bf16_bounds(n_bytes, 4 * ch * logits, 5 * logits,
                                 pv_passes=2),
                    fp32_bound_ms=fp32_ms, fp32_bound_by=fp32_by)

    # yardstick: the dirty problems' branch A in one library call, over
    # the selected frames' 270 keys each, invalid rolled keys masked out
    sel = fsel[0].nonzero()[:, 0]
    Ts = sel.numel()

    def all_keys(c, r, p):
        r = r[:, :, :, sel].transpose(2, 3).reshape(BH, nW, Ts, 4 * win, ch)
        p = p[:, sel][:, None].expand(BH, nW, Ts, P, ch)
        return torch.cat([c[:, :, sel], r, p], 3).reshape(BH, nW, -1, ch)

    k_all, v_all = all_keys(wk, rk, pk), all_keys(wv, rv, pv)
    key_ok = torch.cat([roll_valid.new_ones(win), roll_valid,
                        roll_valid.new_ones(P)]).repeat(Ts)[None]

    def sdpa_ms(occ):
        dirty = (occ[0].to(torch.int32) > 0).nonzero()[:, 0]
        q_d = wq[:, dirty].reshape(BH, -1, T * win, ch)
        k_d, v_d = k_all[:, dirty], v_all[:, dirty]

        def library():
            return F.scaled_dot_product_attention(
                q_d, k_d, v_d, attn_mask=key_ok, scale=scale)

        _compare(f"SDPA yardstick vs {name}, {int(dirty.numel())} dirty "
                 f"windows", library(),
                 k5(occ, fsel)[:, dirty].reshape(q_d.shape), tol)
        return _time_ms(library, 10)

    # A/B: the 'flash' form on the same inputs — K4 over every window on
    # the static parity's frames (the padded one masked by a -1e9 bias) and
    # its valid keys, branch B for every window, then the occupancy picks
    static = static_sel(0).nonzero()[:, 0]
    Tf = static.numel()

    def valid_keys(c, r, p):
        r = r[:, :, :, static].transpose(2, 3)
        r = r.reshape(BH, nW, Tf, 4 * win, ch)[:, :, :, valid_idx]
        p = p[:, static][:, None].expand(BH, nW, Tf, P, ch)
        return torch.cat([c[:, :, static], r, p], 3).reshape(
            1, BH * nW, -1, ch).contiguous()

    k4_k, k4_v = valid_keys(wk, rk, pk), valid_keys(wv, rv, pv)
    k4_bias = torch.where(frame_valid[static], 0.0, flash_attention.NEG_INF)
    k4_bias = k4_bias.repeat_interleave(k4_k.shape[2] // Tf)[None]
    k4_q = wq.reshape(1, BH * nW, T * win, ch)

    def flash_form(occ):
        out_a = flash_attention.flash_window_attention(k4_q, k4_k, k4_v,
                                                       k4_bias, scale)
        att_b = torch.softmax(wq @ wk.transpose(-1, -2) * scale, dim=-1)
        out_b = att_b @ wv
        dirty = (occ > 0).expand(BH, nW)[:, :, None, None, None]
        return torch.where(dirty, out_a.reshape(out_b.shape), out_b)

    fp32_inputs = tuple(t.float() for t in inputs[:7]) + (roll_valid,)

    def fp32_k5(occ):
        return attention.sparse_window_attention(*fp32_inputs, occ, fsel,
                                                 n_head)

    timing = {}
    for occ_name, occ in occs.items():
        if bf16:
            other = dict(fp32_k5_ms=_time_ms(lambda: fp32_k5(occ), 10))
        else:
            _compare(f"K4 + branch B vs K5, {occ_name}", flash_form(occ),
                     k5(occ, fsel))
            other = dict(k4_plus_branch_b_ms=_time_ms(
                lambda: flash_form(occ), 10))
        timing[occ_name] = dict(
            ms=_time_ms(lambda: k5(occ, fsel), 10), **other,
            library_ms=(sdpa_ms(occ) if occ.max() > 0 else None),
            dirty_windows=int((occ > 0).sum()), **bound(occ))
        r = timing[occ_name]
        other_text = (f"fp32 K5 {r['fp32_k5_ms']:.3f} ms" if bf16 else
                      f"K4 + branch B {r['k4_plus_branch_b_ms']:.3f} ms")
        print(f"  {name} {occ_name} ({r['dirty_windows']}/{nW} dirty): "
              f"{r['ms']:.3f} ms, {other_text}, SDPA over the dirty windows "
              f"{r['library_ms']}, bound {r['bound_ms']:.3f} by "
              f"{r['bound_by']} ({r['bound_basis']}; fp32 "
              f"{r['fp32_bound_ms']:.3f})")
    plain_ms = _time_ms(lambda: attention._sparse_window_attention_plain(
        *inputs, occs["smoke"], fsel, n_head), 3)
    smoke = timing.pop("smoke")
    return dict(
        name=name, route="cuda",
        source="propainter_tpu_torch/csrc/sparse_window_attention.cu",
        replaces="propainter_tpu/ops/attention.py:42",
        shape=f"windows {tuple(wq.shape)} rolled {tuple(rk.shape)} pooled "
              f"{tuple(pk.shape)}{', bf16' if bf16 else ''}, smoke "
              f"occupancy {smoke['dirty_windows']}/{nW} dirty",
        max_abs_err=err, plain_ms=plain_ms, **smoke, occupancies=timing)


def _check_bf16(randn, level0, state: dict) -> dict:
    """The bf16 forms of K2, K1, K3, K4, K5 and K7, and K1 over a bf16
    volume with fp32 parameters, at the main path's shapes against their
    bf16 plain versions (BF16_REL_TOL; K7's fp32 output from the same bf16
    taps within 1e-6), timed beside the plain version and the bf16
    library route (`_k1_library` over the bf16 levels for K1,
    `_lookup_library` for K7, F.scaled_dot_product_attention for K4 and
    K5); K1 and K7 also at ragged, far-off cases (`_k1_ragged_cases`), K3
    at every cluster split (timed) and at ragged images at every group
    width and split, K4 at ragged shapes, K5 at three occupancies."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.ops import corr, deform, flash_attention
    from propainter_tpu_torch.ops.warp import coords_grid

    bf = torch.bfloat16
    records = {}
    # ---- K2: one RAFT chunk's volume, every level stored in bf16
    pyr = corr.corr_pyramid_build_bf16(level0, 4)
    ref = corr._corr_pyramid_build_bf16_plain(level0, 4)
    err = max(_compare(f"corr_pyramid_build_bf16 L{i}", a, b, BF16_REL_TOL)
              for i, (a, b) in enumerate(zip(pyr, ref)))
    ms = _time_ms(lambda: corr.corr_pyramid_build_bf16(level0, 4), 20)
    plain_ms = _time_ms(
        lambda: corr._corr_pyramid_build_bf16_plain(level0, 4), 20)
    n_pool = sum(p.numel() for p in pyr[1:])
    records["corr_pyramid_build_bf16"] = dict(
        name="corr_pyramid_build_bf16", route="cuda",
        source="propainter_tpu_torch/csrc/corr_pyramid_build.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:63",
        shape=f"level0 {tuple(level0.shape)} -> bf16", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **_bf16_bounds(_nbytes(level0, *pyr), 0, 4 * n_pool))

    # ---- K1: one RAFT iteration over that pyramid
    N, H8, W8 = pyr[0].shape
    B = N // (H8 * W8)
    coords = (coords_grid(B, H8, W8, device=level0.device)
              + randn(B, H8, W8, 2, std=3.0)).contiguous()
    w = randn(324, 256, std=0.02).to(bf)
    bias = randn(256, std=0.02).to(bf)

    def run_k1():
        return corr.corr_lookup_moenc_bf16(pyr, coords, w, bias)

    def plain_k1():
        return corr._corr_lookup_moenc_bf16_plain(pyr, coords, w, bias, 4)

    got = run_k1()
    err = _compare("corr_lookup_moenc_bf16", got, plain_k1(), BF16_REL_TOL)
    ragged = _k1_ragged_cases(randn)
    for what, small, far in ragged:
        err = max(err, _compare(
            f"corr_lookup_moenc_bf16 {what}",
            corr.corr_lookup_moenc_bf16(small, far, w, bias),
            corr._corr_lookup_moenc_bf16_plain(small, far, w, bias, 4),
            BF16_REL_TOL))
    library = _k1_library(pyr, coords, w, bias)
    n_q = B * H8 * W8
    records["corr_lookup_moenc_bf16"] = dict(
        name="corr_lookup_moenc_bf16", route="cuda",
        source="propainter_tpu_torch/csrc/corr_lookup_moenc.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:166",
        shape=f"coords {tuple(coords.shape)}, bf16 levels", max_abs_err=err,
        ms=_graph_ms(run_k1), eager_ms=_time_ms(run_k1, 50),
        plain_ms=_time_ms(plain_k1, 5), library_ms=_graph_ms(library),
        **_bf16_bounds(2 * _in_range_taps(pyr, coords)
                       + _nbytes(coords, w, bias, got),
                       n_q * 2 * 324 * 256, n_q * 324 * 10))

    # ---- K3: both call sites at every cluster split, then ragged images
    k3 = []
    for Bd, Hd, Wd, C, dg, max_res in ((1, 60, 108, 128, 16, 3.0),
                                       (2, 30, 54, 256, 16, 5.0)):
        x, off, msk, wt, bs = (t.to(bf).contiguous() for t in _deform_inputs(
            randn, Bd, Hd, Wd, C, dg, max_res))
        shape = f"x {(Bd, Hd, Wd, C)} dg {dg}, bf16"

        def run_k3(split=None):
            return deform.modulated_deform_conv2d_bf16(x, off, msk, wt, bs,
                                                       split=split)

        def plain_k3():
            return deform._modulated_deform_conv2d_bf16_plain(x, off, msk,
                                                              wt, bs)

        want = plain_k3()
        err = _compare(f"modulated_deform_conv2d_bf16 {shape}", run_k3(),
                       want, BF16_REL_TOL)
        splits = _k3_bf16_splits(C)
        for sp in splits:
            err = max(err, _compare(
                f"modulated_deform_conv2d_bf16 {shape}, split {sp}",
                run_k3(sp), want, BF16_REL_TOL))
        split_ms = {sp: _graph_ms(lambda: run_k3(sp)) for sp in splits}
        n_pos = Bd * Hd * Wd
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        slots = n_sm * deform.k3_launch_info(C // dg, bf16=True)[0]
        split = deform.k3_split(n_pos, C, slots, deform.K3_BF16_CHUNK)
        k3.append(dict(shape=shape, max_abs_err=err, ms=_graph_ms(run_k3),
                       eager_ms=_time_ms(run_k3, 50),
                       plain_ms=_time_ms(plain_k3, 5), library_ms=None,
                       split=split, split_ms=split_ms,
                       **_bf16_bounds(_nbytes(x, off, msk, wt, bs, want),
                                      n_pos * 2 * 9 * C * 128,
                                      n_pos * 9 * C * 12)))
        by_split = ", ".join(f"{sp}: {t:.4f}" for sp, t in split_ms.items())
        print(f"  modulated_deform_conv2d_bf16 {shape}: split {split}; "
              f"device ms by split {by_split}")
    # ragged: 65 positions (a full 64-position tile and one of a single
    # position) at every group width, and 21 positions (one partial tile:
    # the whole grid is one cluster) at every split; offsets to 40 pixels
    # outside the image
    for (Hd, Wd, C, dg), splits in (
            *(((5, 13, C, dg), (None,))
              for C, dg in ((128, 32), (128, 16), (256, 16), (128, 4))),
            ((3, 7, 128, 16), _k3_bf16_splits(128))):
        x, off, msk, wt, bs = _deform_inputs(randn, 1, Hd, Wd, C, dg, 3.0)
        x, off, msk, wt, bs = (t.to(bf).contiguous()
                               for t in (x, off * 8.0, msk, wt, bs))
        want = deform._modulated_deform_conv2d_bf16_plain(x, off, msk, wt, bs)
        for sp in splits:
            k3[0]["max_abs_err"] = max(k3[0]["max_abs_err"], _compare(
                f"modulated_deform_conv2d_bf16 x (1, {Hd}, {Wd}, {C}) dg "
                f"{dg}, offsets to 40 px" + (f", split {sp}" if sp else ""),
                deform.modulated_deform_conv2d_bf16(x, off, msk, wt, bs,
                                                    split=sp),
                want, BF16_REL_TOL))
    records["modulated_deform_conv2d_bf16"] = dict(
        name="modulated_deform_conv2d_bf16", route="cuda",
        source="propainter_tpu_torch/csrc/deform_conv.cu",
        replaces="propainter_tpu/ops/deform_pallas.py:173", **k3[0],
        flow_completion_site=k3[1])

    # ---- K4: one transformer block of one window, bf16 q, k, v
    Gp, Tq, Tk, ch = 64, 855, 2380, 128
    q, k, v = (randn(1, Gp, T_, ch).to(bf) for T_ in (Tq, Tk, Tk))
    kb = torch.zeros(1, Tk, device=level0.device)
    kb[:, -238:] = flash_attention.NEG_INF
    scale = 1.0 / math.sqrt(ch)
    got = flash_attention.flash_window_attention_bf16(q, k, v, kb, scale)
    err = _compare("flash_window_attention_bf16", got,
                   flash_attention._flash_window_attention_bf16_plain(
                       q, k, v, kb, scale), BF16_REL_TOL)
    err = max(err, _compare(
        "flash_window_attention_bf16 (no bias)",
        flash_attention.flash_window_attention_bf16(q, k, v, None, scale),
        flash_attention._flash_window_attention_bf16_plain(q, k, v, None,
                                                           scale),
        BF16_REL_TOL))
    # ragged: partial query and key tiles, a bias masking most keys; 4
    # batch rows of different biases (the shard path's window batch), one
    # masking the whole first 128-key tile
    qr, kr, vr = (randn(1, 3, T_, ch).to(bf) for T_ in (130, 70, 70))
    kbr = torch.zeros(1, 70, device=level0.device)
    kbr[:, :64] = flash_attention.NEG_INF
    q4, k4_, v4 = (randn(4, 3, T_, ch).to(bf) for T_ in (130, 200, 200))
    kb4 = torch.zeros(4, 200, device=level0.device)
    kb4[0, 64:128] = flash_attention.NEG_INF
    kb4[1, :150] = flash_attention.NEG_INF
    kb4[3, 10:] = flash_attention.NEG_INF
    for (qq, kk, vv), b_, what in (((qr, kr, vr), kbr, "Tq 130 Tk 70, bias"),
                                   ((qr, kr, vr), None, "Tq 130 Tk 70"),
                                   ((q4, k4_, v4), kb4,
                                    "B 4 Tq 130 Tk 200, biases")):
        err = max(err, _compare(
            f"flash_window_attention_bf16 {what}",
            flash_attention.flash_window_attention_bf16(qq, kk, vv, b_,
                                                        scale),
            flash_attention._flash_window_attention_bf16_plain(
                qq, kk, vv, b_, scale), BF16_REL_TOL))
    mask4 = kb[:, None, None, :].to(bf)
    dense = dict(
        shape=f"q {tuple(q.shape)} k {tuple(k.shape)}, bf16",
        ms=_time_ms(lambda: flash_attention.flash_window_attention_bf16(
            q, k, v, kb, scale), 10),
        plain_ms=_time_ms(
            lambda: flash_attention._flash_window_attention_bf16_plain(
                q, k, v, kb, scale), 5),
        library_ms=_time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask4, scale=scale), 10),
        **_bf16_bounds(_nbytes(q, k, v, kb, got), Gp * 4 * Tq * Tk * ch,
                       Gp * 5 * Tq * Tk))
    print(f"  flash_window_attention_bf16 without bucketing "
          f"{dense['shape']}: {dense['ms']:.4f} ms (bound "
          f"{dense['bound_ms']:.4f})")
    records["flash_window_attention_bf16"] = _k4_record(
        "flash_window_attention_bf16", err, dense,
        _check_k4_shapes(randn, state, bf16=True),
        encode_us=_k4_bf16_encode_us(q, k, v))

    records["sparse_window_attention_bf16"] = _check_k5(randn, bf)
    records["corr_lookup_bf16"] = _check_k7_bf16(randn, pyr, coords,
                                                 ragged, state)
    records["corr_lookup_moenc_bf16_volume"] = _check_k1_bf16_volume(
        randn, pyr, coords, ragged)
    return records


def _check_k4_shapes(randn, state: dict, bf16: bool = False,
                     shapes=K4_BUCKET_SHAPES, site: str = "bucketed") -> list:
    """K4 (or its bf16 form) at each of `shapes` (the bucketed main path's,
    or `K4_EVAL_SHAPE` with site "eval") with one padded reference frame's
    keys masked, against its plain version (REL_TOL, or BF16_REL_TOL),
    timed beside the plain version and SDPA, with its bound and its grid's
    waves (from the build phase, when it ran)."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.ops import flash_attention as fa

    if bf16:
        dt, run, plain = (torch.bfloat16, fa.flash_window_attention_bf16,
                          fa._flash_window_attention_bf16_plain)
        symbol, prefix, tol = "window_attention_bf16_kernel", "bf16 ", \
            BF16_REL_TOL
    else:
        dt, run, plain = (torch.float32, fa.flash_window_attention,
                          fa._flash_window_attention_plain)
        symbol, prefix, tol = "window_attention_kernel", "", REL_TOL
    sites = state.get("build", {}).get(symbol, {}).get("sites", {})
    scale = 1.0 / math.sqrt(128)
    out = []
    for G, Tq, Tk in shapes:
        q, k, v = (randn(1, G, n, 128).to(dt) for n in (Tq, Tk, Tk))
        kb = torch.zeros(1, Tk, device=q.device)
        kb[:, -238:] = fa.NEG_INF
        got = run(q, k, v, kb, scale)
        name = f"{run.__name__} {G} problems x {Tq} rows, {Tk} keys"
        err = _compare(name, got, plain(q, k, v, kb, scale), tol)
        mask4 = kb[:, None, None, :].to(dt)
        bounds = (_bf16_bounds if bf16 else _tensor_core_bounds)(
            _nbytes(q, k, v, kb, got), G * 4 * Tq * Tk * 128,
            G * 5 * Tq * Tk)
        grid = sites.get(f"{prefix}{site}, {G} problems x {Tq} rows", {})
        rec = dict(shape=f"q {tuple(q.shape)} k {tuple(k.shape)}",
                   max_abs_err=err,
                   ms=_time_ms(lambda: run(q, k, v, kb, scale), 20),
                   plain_ms=_time_ms(lambda: plain(q, k, v, kb, scale), 3),
                   library_ms=_time_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask4, scale=scale), 20),
                   **bounds)
        print(f"  {name}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f}, "
              f"SDPA {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} "
              f"by {rec['bound_by']}, {rec['bound_ms'] / rec['ms']:.0%} of "
              f"it; grid {grid.get('grid')} blocks, {grid.get('waves')} "
              f"waves)")
        out.append(rec)
    return out


def _k4_record(name: str, dense_err: float, dense: dict, shapes: list,
               **extra) -> dict:
    """K4's kernels-line record: the numbers of the main path's commonest
    shape (bucket 8, the first of `K4_BUCKET_SHAPES`, named in `basis`),
    every bucketed shape's and those of the 64-problem shape K4 ran before
    bucketing beside them. Measured numbers and bounds only: the grids'
    waves stay in the build phase's record."""
    main = shapes[0]
    return dict(
        name=name, route="cuda",
        source="propainter_tpu_torch/csrc/window_attention.cu",
        replaces="propainter_tpu/ops/flash_attention.py:36",
        basis="the top-level ms, bounds and library_ms are those of the "
              "bucket-8 shape (32 problems x 855 rows), not of the "
              "64-problem shape K4 ran before bucketing (under 'dense')",
        **{k: main[k] for k in main if k != "max_abs_err"},
        max_abs_err=max([dense_err] + [r["max_abs_err"] for r in shapes]),
        bucketed=shapes, dense=dense, **extra)


def _k3_bf16_splits(C: int) -> list:
    """Every cluster split K3's bf16 form takes at C channels: the counts
    up to 8 that divide its 9 * C / 64 chunks."""
    from propainter_tpu_torch.ops import deform

    n_chunks = 9 * C // deform.K3_BF16_CHUNK
    return [sp for sp in range(1, deform.K3_MAX_SPLIT + 1)
            if n_chunks % sp == 0]


def _k1_ragged_cases(randn) -> list:
    """The ragged inputs of K1's bf16 forms and of K7's bf16 form, (what,
    bf16 pyramid, coords): the far-off 8 x 13 map (104 queries: a full
    64-query tile and a partial one, fewer than the card's SMs) and an 8
    x 9 map (72 queries) whose every coordinate lies 200 pixels outside
    every level's map."""
    import torch
    from propainter_tpu_torch.ops import corr
    from propainter_tpu_torch.ops.warp import coords_grid

    small, far = _far_off_case(randn)
    f1, f2 = randn(1, 8, 9, 256), randn(1, 8, 9, 256)
    outside = coords_grid(1, 8, 9, device=f1.device)
    sign = torch.where(torch.arange(72, device=f1.device).reshape(1, 8, 9, 1)
                       % 2 == 0, 1.0, -1.0)
    outside = (outside + 200.0 * sign).contiguous()
    return [(what, [p.to(torch.bfloat16).contiguous() for p in pyr], c)
            for what, pyr, c in (
                ("maps 8 x 13, coordinates to 40 px outside", small, far),
                ("maps 8 x 9, every coordinate outside every level",
                 corr.corr_pyramid(f1, f2, 4), outside))]


# K7's bf16 form against its plain version: the same bf16 taps and the
# same rounding, fp32 out, so equal but for an fp32 ulp of summation order
K7_BF16_ABS_TOL = 1e-6


def _k4_bf16_encode_us(q, k, v, reps: int = 1000) -> float:
    """Host microseconds to encode the three TMA tensor maps of one call of
    K4's bf16 form (done on every call), over `reps` encodings."""
    from propainter_tpu_torch import _build

    fn = _build.function("window_attention", "window_attention_bf16_encode",
                         3, 4)
    B, G, Tq, _ = q.shape
    t0 = time.perf_counter()
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B * G, Tq,
                    k.shape[2], reps, None), "window_attention_bf16_encode")
    return (time.perf_counter() - t0) / reps * 1e6


def _odd_width_case(randn) -> tuple:
    """A 9 x 27 map of 2 pairs (486 queries; levels 9 x 27, 4 x 13, 2 x 6,
    1 x 3: odd widths, and an odd level-0 map, so rows and queries' maps
    start at both 2-byte alignments of a 4-byte word), coordinates moved
    by N(0, 4^2) pixels and three of them off the map: (bf16 pyramid,
    coords)."""
    import torch
    from propainter_tpu_torch.ops import corr
    from propainter_tpu_torch.ops.warp import coords_grid

    f1, f2 = randn(2, 9, 27, 256), randn(2, 9, 27, 256)
    coords = coords_grid(2, 9, 27, device=f1.device) + randn(2, 9, 27, 2,
                                                            std=4.0)
    coords[1, 8, -3:] = torch.tensor([[-9.5, 8.25], [31.0, -5.0],
                                      [26.75, 8.5]], device=f1.device)
    return (corr.corr_pyramid(f1, f2, 4, out_dtype=torch.bfloat16),
            coords.contiguous())


def _sector_bytes(pyr, coords, elem: int = 2, sector: int = 32) -> int:
    """The bytes of the `sector`-byte blocks that every query's in-range
    window rows touch in levels of `elem`-byte values, each block of one
    query's window once (the rows of a narrow map share blocks), every
    level starting on a block: with 32-byte sectors, what a lookup must
    move from device memory, as `_in_range_taps` counts the taps
    themselves."""
    import torch

    N = coords.shape[0] * coords.shape[1] * coords.shape[2]
    c = coords.reshape(N, 2).float()
    n = torch.arange(N, device=c.device)
    sectors = 0
    for lvl, p in enumerate(pyr):
        H, W = p.shape[1:]
        xs = torch.floor(c[:, 0] / 2 ** lvl).clamp(-6, W + 4).long() - 4
        ys = torch.floor(c[:, 1] / 2 ** lvl).clamp(-6, H + 4).long() - 4
        c0, c1 = xs.clamp(min=0), (xs + 9).clamp(max=W - 1)
        last = torch.full_like(n, -1)     # the window's last sector so far
        for r in range(10):
            y = ys + r
            live = (y >= 0) & (y < H) & (c0 <= c1)
            row = (n * H + y) * W
            s0 = torch.maximum((row + c0) * elem // sector, last + 1)
            s1 = ((row + c1 + 1) * elem - 1) // sector
            sectors += int(torch.where(live, (s1 - s0 + 1).clamp(min=0),
                                       0).sum().item())
            last = torch.where(live, s1, last)
    return sector * sectors


def _check_k7_bf16(randn, pyr, coords, ragged, state: dict) -> dict:
    """K7's bf16 form over the bf16 pyramid of one RAFT chunk at one
    iteration's coordinates, at K1's ragged cases (the far-off 8 x 13
    map, and every coordinate outside every level of an 8 x 9 map) and at
    the odd-width 9 x 27 map (`_odd_width_case`), against its plain
    version (K7_BF16_ABS_TOL), timed by CUDA-graph replay beside four
    bf16 `F.grid_sample` calls (`_lookup_library`). Beside the bound (each
    in-range tap read once), printed and kept in
    `state["corr_lookup_bf16_floor"]` (not in the kernel's record): the
    sector floor, the 32-byte sectors the in-range window rows touch
    (`_sector_bytes`), the coords and the output, at the memory rate."""
    from propainter_tpu_torch.ops import corr

    def run():
        return corr.corr_lookup_bf16(pyr, coords)

    def plain():
        return corr._corr_lookup_plain(pyr, coords)

    got = run()
    err = 0.0
    for what, p, c in [("main path", pyr, coords), *ragged,
                       ("maps 9 x 27, odd widths", *_odd_width_case(randn))]:
        e = (corr.corr_lookup_bf16(p, c)
             - corr._corr_lookup_plain(p, c)).abs().max().item()
        print(f"  corr_lookup_bf16 {what}: max_abs_err={e:.3e} (tolerance "
              f"{K7_BF16_ABS_TOL:.0e})")
        err = max(err, e)
    if err > K7_BF16_ABS_TOL:
        raise AssertionError("corr_lookup_bf16 disagrees with its plain "
                             "version")
    n_q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    bound_ms, bound_by = _bound(
        2 * _in_range_taps(pyr, coords) + _nbytes(coords, got),
        n_q * 324 * 10)
    floor = dict(sector_bytes=_sector_bytes(pyr, coords),
                 block64_bytes=_sector_bytes(pyr, coords, sector=64),
                 tap_bytes=2 * _in_range_taps(pyr, coords))
    floor["sector_floor_ms"] = ((floor["sector_bytes"] + _nbytes(coords, got))
                                / PEAK_BYTES_PER_S * 1e3)
    state["corr_lookup_bf16_floor"] = floor
    print(f"  corr_lookup_bf16 sector floor: {floor['sector_floor_ms']:.4f} "
          f"ms ({floor['sector_bytes'] / 1e6:.1f} MB of sectors, "
          f"{floor['block64_bytes'] / 1e6:.1f} MB in 64-byte blocks, "
          f"{floor['tap_bytes'] / 1e6:.1f} MB of taps; bound "
          f"{bound_ms:.4f} ms)")
    return dict(
        name="corr_lookup_bf16", route="cuda",
        source="propainter_tpu_torch/csrc/corr_lookup.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:363",
        shape=f"coords {tuple(coords.shape)}, bf16 levels", max_abs_err=err,
        ms=_graph_ms(run), eager_ms=_time_ms(run, 50),
        plain_ms=_time_ms(plain, 5),
        library_ms=_graph_ms(_lookup_library(pyr, coords)),
        bound_ms=bound_ms, bound_by=bound_by)


def _check_k1_bf16_volume(randn, pyr, coords, ragged) -> dict:
    """K1 over the bf16 pyramid of one RAFT chunk with convc1's parameters
    in fp32 (RAFT's fp32 refinement over a bf16 volume), and at K1's
    ragged cases (`_k1_ragged_cases`), against its plain version
    (BF16_REL_TOL), timed by CUDA-graph replay beside the bf16 library
    route (`_k1_library` with the parameters in bf16)."""
    from propainter_tpu_torch.ops import corr

    w = randn(324, 256, std=0.02)
    bias = randn(256, std=0.02)

    def run():
        return corr.corr_lookup_moenc_bf16_volume(pyr, coords, w, bias)

    def plain():
        return corr._corr_lookup_moenc_bf16_plain(pyr, coords, w, bias, 4)

    got = run()
    err = _compare("corr_lookup_moenc_bf16_volume", got, plain(),
                   BF16_REL_TOL)
    for what, small, far in ragged:
        err = max(err, _compare(
            f"corr_lookup_moenc_bf16_volume {what}",
            corr.corr_lookup_moenc_bf16_volume(small, far, w, bias),
            corr._corr_lookup_moenc_bf16_plain(small, far, w, bias, 4),
            BF16_REL_TOL))
    n_q = coords.shape[0] * coords.shape[1] * coords.shape[2]
    library = _k1_library(pyr, coords, w.to(pyr[0].dtype),
                          bias.to(pyr[0].dtype))
    return dict(
        name="corr_lookup_moenc_bf16_volume", route="cuda",
        source="propainter_tpu_torch/csrc/corr_lookup_moenc.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:166",
        shape=f"coords {tuple(coords.shape)}, bf16 levels, fp32 weight",
        max_abs_err=err, ms=_graph_ms(run), eager_ms=_time_ms(run, 50),
        plain_ms=_time_ms(plain, 5), library_ms=_graph_ms(library),
        **_bf16_bounds(2 * _in_range_taps(pyr, coords)
                       + _nbytes(coords, w, bias, got),
                       n_q * 2 * 324 * 256, n_q * 324 * 10))


def _launch_counters():
    from propainter_tpu_torch.ops import attention, corr, deform, flash_attention

    return {
        "corr_pyramid_build": corr.corr_pyramid_build,
        "corr_lookup_moenc": corr.corr_lookup_moenc,
        "corr_lookup": corr.corr_lookup,
        "modulated_deform_conv2d": deform.modulated_deform_conv2d,
        "flash_window_attention": flash_attention.flash_window_attention,
        "sparse_window_attention": attention.sparse_window_attention,
        "deform_sample": deform.deform_sample,
        "corr_pyramid_build_bf16": corr.corr_pyramid_build_bf16,
        "corr_lookup_moenc_bf16": corr.corr_lookup_moenc_bf16,
        "modulated_deform_conv2d_bf16": deform.modulated_deform_conv2d_bf16,
        "flash_window_attention_bf16":
            flash_attention.flash_window_attention_bf16,
        "sparse_window_attention_bf16":
            attention.sparse_window_attention_bf16,
        "corr_lookup_bf16": corr.corr_lookup_bf16,
        "corr_lookup_moenc_bf16_volume": corr.corr_lookup_moenc_bf16_volume,
    }


# the driven run whose launches each kernel's record reports: the main
# path in its seven configurations ('flash', 'pallas', 'shard', the
# shard_inference layout, 'bf16', precision='bf16' under 'flash',
# 'bf16_pallas', 'bf16_shard', bf16 shard_inference with an fp32 RAFT
# refinement, and 'bf16_fp32_refine', bf16 'flash' with an fp32 RAFT
# refinement), and the deform dispatchers
KERNEL_PATH = {"corr_pyramid_build": "flash", "corr_lookup_moenc": "flash",
               "corr_lookup": "shard",
               "modulated_deform_conv2d": "flash",
               "flash_window_attention": "flash",
               "sparse_window_attention": "pallas",
               "deform_sample": "deform_opt",
               "corr_pyramid_build_bf16": "bf16",
               "corr_lookup_moenc_bf16": "bf16",
               "modulated_deform_conv2d_bf16": "bf16",
               "flash_window_attention_bf16": "bf16",
               "sparse_window_attention_bf16": "bf16_pallas",
               "corr_lookup_bf16": "bf16_shard",
               "corr_lookup_moenc_bf16_volume": "bf16_fp32_refine"}


def _zero_launches() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def _read_launches() -> dict:
    return {k: fn.launches for k, fn in _launch_counters().items()}


def _synthetic_clip(T: int, H: int, W: int, seed: int):
    """Textured frames panning right and a moving rectangular hole."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (H // 8, W // 8, 3), np.uint8)
    frames = np.stack([
        np.roll(np.kron(base, np.ones((8, 8, 1), np.uint8)), 3 * t, axis=1)
        for t in range(T)])
    mask = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        y0 = H // 3
        x0 = (W // 4 + 2 * t) % (W // 2)
        mask[t, y0:y0 + H // 4, x0:x0 + W // 3] = 1
    return frames, mask


def _models(seed: int, fan_in_scaled: bool = False):
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    mods = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
            "inpaint": InpaintGenerator()}
    for i, m in enumerate(mods.values()):
        seeded_init_(m, seed + i, fan_in_scaled)
    return mods


def _main_path_inputs():
    import numpy as np
    from propainter_tpu_torch.pipeline import (ProPainterPipeline,
                                               PipelineConfig)
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    T, H, W = 80, 240, 432
    frames, mask = _synthetic_clip(T, H, W, seed=0)
    flow_masks = np.stack([binary_dilation_cross(m, 4) for m in mask])
    mods = _models(seed=1)
    pipe = ProPainterPipeline(mods["raft"], mods["flowcomp"], mods["inpaint"],
                              PipelineConfig(), device="cuda")
    return pipe, frames, flow_masks


def _pallas_pipeline(pipe):
    """`pipe` in the 'pallas' form: the same RAFT and flow completion, and
    a copy of its generator (the same weights), so each pipeline keeps its
    own generator's attention form."""
    import copy

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    return ProPainterPipeline(pipe.raft, pipe.flowcomp,
                              copy.deepcopy(pipe.inpaint),
                              PipelineConfig(attention_impl="pallas"),
                              device="cuda")


def _shard_pipeline(pipe):
    """`pipe` in the shard_inference configuration with window_batch 4 on
    the card's one-device mesh (RAFT's lookup through K7, then convc1 as
    one addmm; stage 4 four windows a call): copies of its RAFT and
    generator (the same weights), so each pipeline keeps its own forms, and
    its flow completion."""
    import copy

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    return ProPainterPipeline(copy.deepcopy(pipe.raft), pipe.flowcomp,
                              copy.deepcopy(pipe.inpaint),
                              PipelineConfig(shard_inference=True,
                                             window_batch=4),
                              device="cuda")


def _bf16_pipeline(pipe):
    """`pipe` with precision='bf16' ('flash'): the same modules, of which
    the pipeline makes its bf16 copies (RAFT's, the flow completion's and
    the generator's), so the fp32 pipelines keep theirs."""
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    return ProPainterPipeline(pipe.raft, pipe.flowcomp, pipe.inpaint,
                              PipelineConfig(precision="bf16"),
                              device="cuda")


def _bf16_pallas_pipeline(pipe):
    """`pipe` with precision='bf16' under 'pallas': its RAFT and flow
    completion (the pipeline makes its bf16 copies of them) and a copy of
    its generator, so `pipe`'s generator keeps its attention form."""
    import copy

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    return ProPainterPipeline(pipe.raft, pipe.flowcomp,
                              copy.deepcopy(pipe.inpaint),
                              PipelineConfig(precision="bf16",
                                             attention_impl="pallas"),
                              device="cuda")


def _bf16_shard_pipeline(pipe):
    """`pipe` with precision='bf16' in the shard_inference configuration,
    window_batch 4 and raft_bf16_refine=False (the JAX package's only bf16
    form of it: RAFT refines in fp32 over a bf16 volume, through K7's bf16
    form): copies of its RAFT and generator, so each pipeline keeps its
    own forms, and its flow completion."""
    import copy

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    return ProPainterPipeline(copy.deepcopy(pipe.raft), pipe.flowcomp,
                              copy.deepcopy(pipe.inpaint),
                              PipelineConfig(precision="bf16",
                                             shard_inference=True,
                                             window_batch=4,
                                             raft_bf16_refine=False),
                              device="cuda")


def _bf16_fp32_refine_pipeline(pipe):
    """`pipe` with precision='bf16' under 'flash' and
    raft_bf16_refine=False: RAFT encodes and refines in fp32 over a bf16
    volume (K1 over a bf16 volume). Copies of its RAFT and generator, so
    `pipe` keeps its forms, and its flow completion."""
    import copy

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    return ProPainterPipeline(copy.deepcopy(pipe.raft), pipe.flowcomp,
                              copy.deepcopy(pipe.inpaint),
                              PipelineConfig(precision="bf16",
                                             raft_bf16_refine=False),
                              device="cuda")


# kernel forms of each precision; a bf16 run launches none of the fp32
# ones (RAFT's fp32 refinement over a bf16 volume runs bf16 forms)
FP32_FORMS = ("corr_pyramid_build", "corr_lookup_moenc", "corr_lookup",
              "modulated_deform_conv2d", "flash_window_attention",
              "sparse_window_attention")


def phase_deform_opt(state: dict) -> None:
    """K6's path: the differentiable deform dispatchers, forward and
    backward, at both call sites' shapes, as a training step calls them;
    launches counted from zero over just that. Then each value and gradient
    against autograd of the plain version on the same inputs."""
    import torch
    from propainter_tpu_torch.ops import deform

    g = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    cases = []
    for Bd, Hd, Wd, C, dg in ((1, 60, 108, 128, 16), (2, 30, 54, 256, 16)):
        off = 3.0 * torch.tanh(randn(Bd, Hd, Wd, dg, 9, 2))
        inputs = (randn(Bd, Hd, Wd, C), off.contiguous(),
                  torch.sigmoid(randn(Bd, Hd, Wd, dg, 9)),
                  randn(3, 3, C, 128, std=0.02), randn(128, std=0.02))
        cases.append((f"x {(Bd, Hd, Wd, C)} dg {dg}", inputs))

    def value_and_grads(fn, inputs):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        (out ** 2).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    names = ("modulated_deform_conv2d_opt", "modulated_deform_conv2d_opt2")
    _zero_launches()
    got = {(name, shape): value_and_grads(getattr(deform, name), inputs)
           for shape, inputs in cases for name in names}
    torch.cuda.synchronize()
    launches = _read_launches()
    state.setdefault("launches", {})["deform_opt"] = launches
    print(f"  launches: {launches}")
    if (launches["deform_sample"] != len(cases)
            or launches["modulated_deform_conv2d"] != len(cases)):
        raise AssertionError("each dispatcher's forward must launch its "
                             "kernel once per call")
    for shape, inputs in cases:
        want = value_and_grads(deform._modulated_deform_conv2d_plain, inputs)
        for name in names:
            for what, a, b in zip(("value", "d x", "d offset", "d mask",
                                   "d weight", "d bias"),
                                  got[(name, shape)], want):
                _compare(f"{name} {shape} {what}", a, b)


@contextlib.contextmanager
def _k4_calls(record: dict):
    """While active, counts K4's launches by (problems, query rows, keys)
    into `record` (both forms), from the wrappers' `shapes` tallies, which
    a CUDA-graph replay advances as it does their launch counts."""
    from propainter_tpu_torch.ops import flash_attention as fa

    fns = (fa.flash_window_attention, fa.flash_window_attention_bf16)
    before = [dict(fn.shapes) for fn in fns]
    try:
        yield record
    finally:
        for fn, was in zip(fns, before):
            for key, n in fn.shapes.items():
                if n != was.get(key, 0):
                    record[key] = record.get(key, 0) + n - was.get(key, 0)


def _spread(values) -> dict:
    return dict(median=statistics.median(values), min=min(values),
                max=max(values))


def _warm_up(p, frames, flow_masks) -> None:
    """Run `p` on the clip until every call key of its graphed stages is
    captured (two videos from new: the first sights, then the stages that
    run once a video), so a measured run replays only."""
    p.inpaint_video(frames, flow_masks, flow_masks)
    while p.graphs.stages and (sum(p.graphs.counts().values())
                               < len(p.graphs.keys())):
        p.inpaint_video(frames, flow_masks, flow_masks)


def _release(p) -> None:
    """Drop `p`'s graphs and their pool (one pipeline's graphs hold about
    its eager peak: phase `graphs`), so the pipelines a phase keeps do not
    add up on the card."""
    p.graphs.clear()
    _graph_memory()


def _measured_run(pipe, frames, flow_masks, smi: str, repeats: int = 1):
    """`repeats` main-path runs, each with the launch counts zeroed just
    before and read just after (they must agree), K4's calls by shape
    recorded over the first (`_graph_run`): (uint8 output of the last,
    launches, stage summary with each stage's median and min-max over the
    runs)."""
    import numpy as np

    T, H, W = frames.shape[:3]
    graphed = [_graph_run(pipe, frames, flow_masks) for _ in range(repeats)]
    out, k4 = graphed[-1]["out"], graphed[0]["k4"]
    runs = [(r["wall"], r["stages"], r["launches"]) for r in graphed]
    launches = runs[0][2]
    cfg = pipe.config
    impl = (f"shard_inference, window_batch {cfg.window_batch}, mesh of "
            f"{len(pipe.mesh)}" if cfg.shard_inference
            else f"attention_impl={cfg.attention_impl!r}")
    if not (cfg.occupancy_bucketing and cfg.encoder_carry):
        impl += (f", occupancy_bucketing={cfg.occupancy_bucketing}, "
                 f"encoder_carry={cfg.encoder_carry}")
    print(f"  launches ({impl}): {launches}")
    if any(r[2] != launches for r in runs):
        raise AssertionError(f"launches differ between runs: "
                             f"{[r[2] for r in runs]}")
    if out.shape != (T, H, W, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    keep = flow_masks == 0
    if not np.array_equal(out[keep], frames[keep]):
        raise AssertionError("unmasked pixels changed")
    seconds = [r[0] for r in runs]
    stages = {k: _spread([r[1][k] for r in runs]) for k in runs[0][1]}
    total = _spread(seconds)
    fmt = (lambda d: f"{d['median']:.3f} s" if repeats == 1 else
           f"{d['median']:.3f} s ({d['min']:.3f}-{d['max']:.3f})")
    print(f"  pipeline {T}x{W}x{H} {cfg.precision}, {impl}"
          + (f", median (min-max) of {repeats} runs" if repeats > 1 else "")
          + f": {fmt(total)}, {T / total['median']:.3f} fps ("
          + ", ".join(f"{k} {fmt(v)}" for k, v in stages.items())
          + f") on {smi}")
    summary = dict(seconds=total["median"], fps=T / total["median"],
                   stages={k: v["median"] for k, v in stages.items()},
                   runs=[dict(seconds=r[0], stages=r[1]) for r in runs],
                   spread=dict(total=total, **stages),
                   k4_calls=[[*key, n] for key, n in sorted(k4.items())])
    return out, launches, summary


def _raft_launches(pipe, frames) -> int:
    """RAFT lookups of one run: one per iteration of each clip chunk."""
    T, W = frames.shape[0], frames.shape[2]
    return _raft_chunks(pipe.config, T, W) * pipe.config.raft_iter


def _plan_counts(plan) -> dict:
    """What the stage-4 plan spends: generator calls (each sub-run's
    windows, window_batch at a time); frames through the encoder (the
    reference union once; a carried sub-run its first window's first l_t
    - stride frames, then stride a window; any other, l_t a window of each
    batch, tail repeats included); frames through SoftSplit (the union
    once, then l_t a window of each batch)."""
    wb = plan.window_batch
    batches = [-(-len(sr.windows) // wb) for sr in plan.subruns]
    n_ref = len(plan.ref_union)
    return dict(
        calls=sum(batches),
        encoded=n_ref + sum(
            sr.l_t - sr.carry + len(sr.windows) * sr.carry if sr.carry
            else n * wb * sr.l_t for sr, n in zip(plan.subruns, batches)),
        tokenized=n_ref + sum(n * wb * sr.l_t
                              for sr, n in zip(plan.subruns, batches)))


def _graph_keys(pipe, plan, T: int, W: int) -> dict:
    """The call keys of `pipe.graphs` one T-frame video of width W gives
    each stage: RAFT's distinct chunk lengths, the distinct chunk lengths
    of flow completion and image propagation (one each when a stage runs
    the video whole), and stage 4's distinct (l_t, masked bucket width,
    carry) over the plan's sub-runs (its calls' operands are gathered per
    window: window_batch and the reference count are the plan's, and a
    tail batch has its sub-run's shapes)."""
    from propainter_tpu_torch.pipeline import get_short_clip_len

    cfg = pipe.config

    def chunks(n, sub, pad):
        if cfg.unchunked or n <= sub:
            return {n}
        return {min(n, f + sub + pad) - max(0, f - pad)
                for f in range(0, n, sub)}

    clip = cfg.raft_clip_len or get_short_clip_len(W)
    raft = {T} if T <= clip else {min(T, f + clip) - (f if f == 0 else f - 1)
                                  for f in range(0, T, clip)}
    generation = {(sr.l_t, None if sr.masked is None
                   else sr.masked[0].shape[1], sr.carry)
                  for sr in plan.subruns}
    return {"raft": len(raft),
            "flow_completion": len(chunks(T - 1, cfg.subvideo_length, 5)),
            "image_propagation": len(chunks(
                T, min(100, cfg.subvideo_length), 10)),
            "generation": len(generation)}


def _stage4_plan(pipe, flow_masks):
    """The stage-4 plan `pipe` builds for this clip (its masked-window
    bitmaps and `plan_bucket_subruns`), printed: frames through the encoder
    and SoftSplit (beside the count of a schedule that encodes every
    window's own l_t + ref_pad frames), generator calls and each sub-run's
    (l_t, windows, bucket, carry)."""
    import torch

    masks = torch.from_numpy(flow_masks.astype("float32")).to(pipe.device)
    plan = pipe.stage4_plan(masks[None, ..., None])
    every_window = sum(len(w[0]) + len(w[1]) for sr in plan.subruns
                       for w in sr.windows)
    subruns = [(sr.l_t, len(sr.windows),
                sr.bucket if sr.masked is not None else "dense", sr.carry)
               for sr in plan.subruns]
    n = _plan_counts(plan)
    print(f"  stage 4 plan: {n['encoded']} frames encoded "
          f"(every window's own: {every_window}), "
          f"{n['tokenized']} tokenized, {n['calls']} "
          f"generator calls; sub-runs (l_t, windows, bucket, carry): "
          f"{subruns}")
    return plan


def _plan_launches(plan, pipe) -> dict:
    """What the plan makes the attention launch: one K4 (under 'flash') or
    K5 (under 'pallas') call per transformer block of each generator call,
    and K4's calls by (problems, query rows): n_head x the sub-run's
    bucket of windows (every window's without bucketing: not predicted
    here), the l_t + ref_pad frames' rows on every block but the last, the
    l_t local frames' on the last."""
    blocks = pipe.inpaint.transformers.transformer
    n_head = blocks[0].attention.n_head
    win = math.prod(blocks[0].attention.window_size)
    calls = _plan_counts(plan)["calls"] * len(blocks)
    shapes: dict = {}
    for sr in plan.subruns:
        if sr.bucket is None:
            return dict(calls=calls, shapes=None)
        n = -(-len(sr.windows) // plan.window_batch)
        T = sr.l_t + len(sr.windows[0][1])
        for i in range(len(blocks)):
            key = (n_head * sr.bucket,
                   (sr.l_t if i == len(blocks) - 1 else T) * win)
            shapes[key] = shapes.get(key, 0) + n
    return dict(calls=calls, shapes=shapes)


def _check_k4_calls(summary: dict, want: dict,
                    required=K4_BUCKET_SHAPES) -> None:
    """K4's calls by (problems, query rows) in a measured run (its
    `k4_calls`: [problems, query rows, keys, calls]) against the plan's,
    and the (problems, rows, keys) shapes `required` (the kernels phase's)
    among them."""
    got: dict = {}
    seen = set()
    for g, q, k, n in summary["k4_calls"]:
        got[(g, q)] = got.get((g, q), 0) + n
        seen.add((g, q, k))
    print(f"  K4 calls by (problems, query rows): {dict(sorted(got.items()))}"
          f" (the plan's: {dict(sorted(want['shapes'].items()))})")
    if got != want["shapes"]:
        raise AssertionError("K4 ran at other shapes than the plan's")
    missing = set(required) - seen
    if missing:
        raise AssertionError(f"the kernels phase's K4 shapes {missing} are "
                             f"not on the main path")


def phase_pipeline(state: dict, smi: str) -> None:
    """The main path at full size in its fp32 configurations on the same
    weights and clip ('flash', 'pallas', and shard_inference with
    window_batch 4 on the card's one-device mesh), then bf16 'flash' and
    the other bf16 configurations (`_bf16_other_configs`), each warmed
    up until its graphs are captured (`_warm_up`: cuDNN plans, lazy
    module loading, two videos), then measured once, the five others also
    against an eager run (`_versus_eager`), each pipeline's graphs then
    released (`_release`); then fp32 and bf16 'flash' with
    occupancy_bucketing and encoder_carry off (the plain stage-4
    schedule, `_schedule_ab`). Every kernel of each path must launch in
    its measured run, K1 under 'flash' and 'pallas' and K7 under
    shard_inference once per RAFT iteration, the other never; K4 and K5 as
    often as the pipeline's own stage-4 plan says (`_plan_launches`), K4
    at the plan's shapes."""
    import numpy as np

    pipe, frames, flow_masks = _main_path_inputs()
    want_lookups = _raft_launches(pipe, frames)
    state["main_path"] = (pipe, frames, flow_masks)
    t0 = time.perf_counter()
    _warm_up(pipe, frames, flow_masks)
    print(f"  warm-up runs (graphs captured): {time.perf_counter() - t0:.3f} "
          f"s")
    out, launches, state["pipeline"] = _measured_run(pipe, frames,
                                                     flow_masks, smi)
    _release(pipe)
    plan = _stage4_plan(pipe, flow_masks)
    want = _plan_launches(plan, pipe)
    state["pipeline"]["plan"] = _plan_counts(plan)
    state.setdefault("launches", {})["flash"] = launches
    missing = [k for k, path in KERNEL_PATH.items()
               if path == "flash" and launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if (launches["corr_lookup_moenc"] != want_lookups
            or launches["corr_lookup"] != 0
            or launches["flash_window_attention"] != want["calls"]):
        raise AssertionError(f"'flash' must launch K1 {want_lookups} times, "
                             f"K4 {want['calls']} and K7 never: {launches}")
    _check_k4_calls(state["pipeline"], want)

    sparse = _pallas_pipeline(pipe)
    state["main_path_pallas"] = sparse
    _warm_up(sparse, frames, flow_masks)
    out_p, launches, state["pipeline_pallas"] = _measured_run(
        sparse, frames, flow_masks, smi)
    _versus_eager(state, "pallas", sparse, frames, flow_masks,
                  _as_graph_run(out_p, launches, state["pipeline_pallas"]))
    _release(sparse)
    state["launches"]["pallas"] = launches
    # one K5 launch per transformer block of every generator call
    want_k5 = _plan_launches(_stage4_plan(sparse, flow_masks),
                             sparse)["calls"]
    diff = np.abs(out_p.astype(int) - out.astype(int))
    print(f"  'pallas' vs 'flash' output: max {diff.max()} LSB, mean "
          f"{diff.mean():.4f} LSB (limits {SMALL_MAX_LSB} / "
          f"{SMALL_MEAN_LSB}); K5 launches {launches['sparse_window_attention']}"
          f" (want {want_k5}), K4 launches "
          f"{launches['flash_window_attention']} (want 0)")
    state["pipeline_pallas"].update(max_lsb_vs_flash=int(diff.max()),
                                    mean_lsb_vs_flash=float(diff.mean()))
    missing = [k for k in ("corr_pyramid_build", "modulated_deform_conv2d")
               if launches[k] == 0]
    if (missing or launches["sparse_window_attention"] != want_k5
            or launches["flash_window_attention"] != 0
            or launches["corr_lookup_moenc"] != want_lookups
            or launches["corr_lookup"] != 0):
        raise AssertionError(f"the 'pallas' path launched {launches}")
    if diff.max() > SMALL_MAX_LSB or diff.mean() > SMALL_MEAN_LSB:
        raise AssertionError("'pallas' and 'flash' outputs disagree")

    shard = _shard_pipeline(pipe)
    state["main_path_shard"] = shard
    _warm_up(shard, frames, flow_masks)
    out_s, launches, state["pipeline_shard"] = _measured_run(
        shard, frames, flow_masks, smi)
    _versus_eager(state, "shard", shard, frames, flow_masks,
                  _as_graph_run(out_s, launches, state["pipeline_shard"]))
    _release(shard)
    state["launches"]["shard"] = launches
    # one K4 launch per transformer block of every window batch of the plan
    want_s = _plan_launches(_stage4_plan(shard, flow_masks), shard)
    diff = np.abs(out_s.astype(int) - out.astype(int))
    print(f"  shard_inference vs 'flash' output: max {diff.max()} LSB, mean "
          f"{diff.mean():.4f} LSB (limits {SMALL_MAX_LSB} / "
          f"{SMALL_MEAN_LSB}); K7 launches {launches['corr_lookup']} (want "
          f"{want_lookups}), K1 launches {launches['corr_lookup_moenc']} "
          f"(want 0), K4 launches {launches['flash_window_attention']} (want "
          f"{want_s['calls']})")
    state["pipeline_shard"].update(max_lsb_vs_flash=int(diff.max()),
                                   mean_lsb_vs_flash=float(diff.mean()))
    missing = [k for k in ("corr_pyramid_build", "modulated_deform_conv2d")
               if launches[k] == 0]
    if (missing or launches["corr_lookup"] != want_lookups
            or launches["corr_lookup_moenc"] != 0
            or launches["flash_window_attention"] != want_s["calls"]
            or launches["sparse_window_attention"] != 0):
        raise AssertionError(f"the shard_inference path launched {launches}")
    if diff.max() > SMALL_MAX_LSB or diff.mean() > SMALL_MEAN_LSB:
        raise AssertionError("shard_inference and 'flash' outputs disagree")
    _check_k4_calls(state["pipeline_shard"], want_s)

    bf16 = _bf16_pipeline(pipe)
    state["main_path_bf16"] = bf16
    _warm_up(bf16, frames, flow_masks)
    out_b, launches, state["pipeline_bf16"] = _measured_run(
        bf16, frames, flow_masks, smi)
    _release(bf16)
    state["launches"]["bf16"] = launches
    # the bf16 forms launch as often as the fp32 ones under 'flash'; no
    # fp32 form of them launches
    flash = state["launches"]["flash"]
    pairs = {k + "_bf16": k for k in ("corr_pyramid_build",
                                      "corr_lookup_moenc",
                                      "modulated_deform_conv2d",
                                      "flash_window_attention")}
    diff = np.abs(out_b.astype(int) - out.astype(int))
    print(f"  bf16 vs fp32 'flash' output (reported, not gated): max "
          f"{diff.max()} LSB, mean {diff.mean():.4f} LSB; launches "
          + ", ".join(f"{k} {launches[k]} (fp32 'flash': {flash[v]})"
                      for k, v in pairs.items()))
    state["pipeline_bf16"].update(max_lsb_vs_flash=int(diff.max()),
                                  mean_lsb_vs_flash=float(diff.mean()))
    wrong = [k for k, v in pairs.items()
             if launches[k] != flash[v] or launches[v] != 0]
    if wrong or launches["corr_lookup"] or launches["sparse_window_attention"]:
        raise AssertionError(f"the bf16 path launched {launches}")
    _check_k4_calls(state["pipeline_bf16"],
                    _plan_launches(_stage4_plan(bf16, flow_masks), bf16))

    _bf16_other_configs(state, frames, flow_masks, out, out_b, smi)
    _schedule_ab(state, frames, flow_masks, out, out_b, smi)


def _bf16_other_configs(state, frames, flow_masks, out, out_b,
                        smi) -> None:
    """The other bf16 configurations of the pipeline phase, each once to
    warm up, then measured: 'pallas' (K5's bf16 form once per transformer
    block of each generator call, K4 in neither form; RAFT, flow
    completion and K3 as bf16 'flash'), shard_inference with window_batch
    4 and raft_bf16_refine=False (K7's bf16 form once per RAFT iteration,
    K1 in no form, K4's bf16 form once per block of each window batch of
    its plan, K3's bf16 form as fp32 shard_inference launches K3), and
    'flash' with raft_bf16_refine=False (K1 over a bf16 volume once per
    RAFT iteration, in place of K1's bf16 form); none launches an fp32
    kernel form. Their outputs' differences from bf16 'flash' and from
    fp32 'flash' are reported, not gated."""
    import numpy as np

    pipe = state["main_path"][0]
    flash, bf16 = state["launches"]["flash"], state["launches"]["bf16"]
    want_lookups = _raft_launches(pipe, frames)
    runs = (("bf16_pallas", _bf16_pallas_pipeline),
            ("bf16_shard", _bf16_shard_pipeline),
            ("bf16_fp32_refine", _bf16_fp32_refine_pipeline))
    for name, make in runs:
        p = make(pipe)
        state[f"main_path_{name}"] = p
        _warm_up(p, frames, flow_masks)
        out_x, launches, state[f"pipeline_{name}"] = _measured_run(
            p, frames, flow_masks, smi)
        _versus_eager(state, name, p, frames, flow_masks, _as_graph_run(
            out_x, launches, state[f"pipeline_{name}"]))
        _release(p)
        state["launches"][name] = launches
        calls = _plan_launches(_stage4_plan(p, flow_masks), p)["calls"]
        if name == "bf16_pallas":
            want = dict(sparse_window_attention_bf16=calls,
                        flash_window_attention_bf16=0,
                        corr_lookup_moenc_bf16=want_lookups,
                        corr_lookup_bf16=0,
                        corr_pyramid_build_bf16=bf16[
                            "corr_pyramid_build_bf16"],
                        modulated_deform_conv2d_bf16=bf16[
                            "modulated_deform_conv2d_bf16"])
        elif name == "bf16_fp32_refine":
            want = {k: bf16[k] for k in ("corr_pyramid_build_bf16",
                                         "modulated_deform_conv2d_bf16",
                                         "flash_window_attention_bf16")}
            want.update(corr_lookup_moenc_bf16_volume=want_lookups,
                        corr_lookup_moenc_bf16=0, corr_lookup_bf16=0,
                        sparse_window_attention_bf16=0)
        else:
            want = dict(corr_lookup_bf16=want_lookups,
                        corr_lookup_moenc_bf16=0,
                        corr_lookup_moenc_bf16_volume=0,
                        corr_pyramid_build_bf16=flash["corr_pyramid_build"],
                        flash_window_attention_bf16=calls,
                        sparse_window_attention_bf16=0,
                        modulated_deform_conv2d_bf16=state["launches"][
                            "shard"]["modulated_deform_conv2d"])
        want.update({k: 0 for k in FP32_FORMS})
        wrong = {k: (launches[k], v) for k, v in want.items()
                 if launches[k] != v}
        d_b = np.abs(out_x.astype(int) - out_b.astype(int))
        d_f = np.abs(out_x.astype(int) - out.astype(int))
        print(f"  {name} vs bf16 'flash' output (reported, not gated): max "
              f"{d_b.max()} LSB, mean {d_b.mean():.4f} LSB; vs fp32 "
              f"'flash': max {d_f.max()} LSB, mean {d_f.mean():.4f} LSB; "
              f"launches as wanted: {not wrong}")
        state[f"pipeline_{name}"].update(
            max_lsb_vs_bf16_flash=int(d_b.max()),
            mean_lsb_vs_bf16_flash=float(d_b.mean()),
            max_lsb_vs_flash=int(d_f.max()),
            mean_lsb_vs_flash=float(d_f.mean()))
        if wrong:
            raise AssertionError(f"the {name} path launched (got, want) "
                                 f"{wrong}")


def _schedule_ab(state, frames, flow_masks, out, out_b, smi) -> None:
    """fp32 and bf16 'flash' on the plain stage-4 schedule
    (occupancy_bucketing and encoder_carry off: every window encodes its
    local frames, branch A over every window), warmed up, then measured
    once, as the scheduled runs: stage times beside
    the scheduled runs', and the outputs' differences from them (reported,
    not gated); K4 once per block of every window."""
    import numpy as np

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    pipe = state["main_path"][0]
    for name, precision, repeats, scheduled in (
            ("plain_schedule", "fp32", 1, out),
            ("bf16_plain_schedule", "bf16", 1, out_b)):
        p = ProPainterPipeline(pipe.raft, pipe.flowcomp, pipe.inpaint,
                               PipelineConfig(precision=precision,
                                              occupancy_bucketing=False,
                                              encoder_carry=False),
                               device="cuda")
        _warm_up(p, frames, flow_masks)
        out_x, launches, summary = _measured_run(p, frames, flow_masks, smi,
                                                 repeats)
        _release(p)
        plan = _stage4_plan(p, flow_masks)
        key = ("flash_window_attention" if precision == "fp32"
               else "flash_window_attention_bf16")
        want = _plan_launches(plan, p)["calls"]
        d = np.abs(out_x.astype(int) - scheduled.astype(int))
        base = state["pipeline" if precision == "fp32" else "pipeline_bf16"]
        print(f"  {precision} 'flash', plain schedule against scheduled "
              f"(reported, not gated): output max {d.max()} LSB, mean "
              f"{d.mean():.4f} LSB; generation {summary['stages']['generation']:.3f}"
              f" s against {base['stages']['generation']:.3f} s (medians), "
              f"whole run {summary['seconds']:.3f} s against "
              f"{base['seconds']:.3f} s; K4 launches {launches[key]} (want "
              f"{want})")
        summary.update(max_lsb_vs_scheduled=int(d.max()),
                       mean_lsb_vs_scheduled=float(d.mean()),
                       plan=_plan_counts(plan))
        state[f"pipeline_{name}"] = summary
        if launches[key] != want:
            raise AssertionError(f"the plain schedule launched K4 "
                                 f"{launches[key]} times, want {want}")


# each launch counter's kernel symbol in a profiler trace (K1 over a bf16
# volume is an instance of K1 bf16's kernel)
TRACE_KERNELS = {
    "corr_pyramid_build": "corr_pyramid_build_kernel",
    "corr_lookup_moenc": "corr_lookup_moenc_kernel",
    "corr_lookup": "corr_lookup_kernel",
    "modulated_deform_conv2d": "deform_conv_kernel",
    "flash_window_attention": "window_attention_kernel",
    "sparse_window_attention": "sparse_window_attention_kernel",
    "corr_pyramid_build_bf16": "corr_pyramid_build_bf16_kernel",
    "corr_lookup_moenc_bf16": "corr_lookup_moenc_bf16_kernel",
    "modulated_deform_conv2d_bf16": "deform_conv_bf16_kernel",
    "flash_window_attention_bf16": "window_attention_bf16_kernel",
    "sparse_window_attention_bf16": "sparse_window_attention_bf16_kernel",
    "corr_lookup_bf16": "corr_lookup_bf16_kernel"}
# counters whose launches show in a trace under another counter's symbol
TRACE_SHARED = {"corr_lookup_moenc_bf16_volume": "corr_lookup_moenc_bf16"}


def _trace_counters(launches: dict) -> dict:
    """A run's launch counts as a profiler trace can show them: by
    `TRACE_KERNELS`' keys, with `TRACE_SHARED`'s folded in."""
    out = {k: launches[k] for k in TRACE_KERNELS}
    for k, into in TRACE_SHARED.items():
        out[into] += launches[k]
    return out


# the graphed main path against eager (phase `graphs`): alternating pairs
# in fp32 and bf16 'flash' (a stage's graph is kept when its graphed
# median is below its eager minimum), one run each of the other five
# configurations, and the evaluation protocol over four video lengths
# through one reused pipeline
GRAPH_PAIRS = {"flash": 3, "bf16": 3}
GRAPH_CONFIGS = (("pallas", _pallas_pipeline), ("shard", _shard_pipeline),
                 ("bf16_pallas", _bf16_pallas_pipeline),
                 ("bf16_shard", _bf16_shard_pipeline),
                 ("bf16_fp32_refine", _bf16_fp32_refine_pipeline))
GRAPH_EVAL_CONFIG = dict(neighbor_length=20, ref_stride=10, unchunked=True,
                         raft_clip_len=60, raft_iter=20)
# phase eval's two lengths, then two more: an evaluation set's videos come
# in many lengths
GRAPH_EVAL_LENGTHS = (104, 73, 90, 66)
# the seed of the second clip a graphed pipeline replays (the main path's
# clip is seed 0; the masks do not depend on the seed)
SECOND_CLIP_SEED = 7


def _twin(p, cuda_graphs):
    """A pipeline of `p`'s configuration on `p`'s modules (a bf16 one
    copies them again) whose graphed stages are `cuda_graphs`."""
    from propainter_tpu_torch.pipeline import ProPainterPipeline

    return ProPainterPipeline(p.raft, p.flowcomp, p.inpaint, p.config,
                              device="cuda", cuda_graphs=cuda_graphs)


def _graph_run(p, frames, flow_masks) -> dict:
    """One main-path run of `p`, its launch counts zeroed just before and
    read just after: uint8 output, wall s, stage s, launches, K4's calls by
    shape."""
    import numpy as np
    import torch

    _zero_launches()
    timings: dict = {}
    k4: dict = {}
    torch.cuda.synchronize()
    with _k4_calls(k4):
        t0 = time.perf_counter()
        out = np.stack(p.inpaint_video(frames, flow_masks, flow_masks,
                                       timings=timings))
        wall = time.perf_counter() - t0
    return dict(out=out, wall=wall, stages=timings, launches=_read_launches(),
                k4=k4)


def _stage_diffs(p, eager, frames, flow_masks) -> dict:
    """Where a graphed pipeline's output parts from its eager twin's: each
    stage of both on the same inputs (the eager pipeline's earlier stages'
    outputs), the largest absolute difference of its outputs."""
    import torch

    from propainter_tpu_torch.device import fp32_numerics

    diffs = {}
    with torch.inference_mode(), fp32_numerics():
        ori = torch.from_numpy(frames).to(p.device)
        x = (ori.float() / 255.0 * 2.0 - 1.0)[None]
        m = torch.from_numpy(flow_masks).to(p.device).float()[
            None, ..., None]
        calls = (
            ("raft", lambda q: q.compute_flows(x)),
            ("flow_completion", lambda q: q.complete_flows(outs["raft"], m)),
            ("image_propagation", lambda q: q.propagate_images(
                x, outs["flow_completion"], m)),
            ("generation", lambda q: (q.generate(
                outs["image_propagation"][0], outs["flow_completion"], m,
                outs["image_propagation"][1], ori),)))
        outs = {}
        for stage, call in calls:
            for _ in range(2):      # the graphed side's capture, then replay
                got = call(p)
            outs[stage] = want = call(eager)
            diffs[stage] = max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want))
    return diffs


def _same_run(name: str, got: dict, want: dict, p=None, eager=None,
              frames=None, flow_masks=None) -> dict:
    """A graphed run against an eager one: the uint8 outputs (identical,
    or within the 'pallas'-against-'flash' limits, each stage's difference
    then reported by `_stage_diffs` when the pipelines are given), the
    launch counts and K4's calls by shape (equal)."""
    d = abs(got["out"].astype(int) - want["out"].astype(int))
    same = dict(identical=bool(d.max() == 0), max_lsb=int(d.max()),
                mean_lsb=float(d.mean()),
                launches_equal=got["launches"] == want["launches"],
                k4_equal=got["k4"] == want["k4"])
    if d.max() and p is not None:
        same["stage_diffs"] = _stage_diffs(p, eager, frames, flow_masks)
        print(f"  {name}: graphed and eager outputs differ (max {d.max()} "
              f"LSB, {int((d > 0).sum())} values); each stage's largest "
              f"difference on the same inputs: {same['stage_diffs']}")
    if not (same["launches_equal"] and same["k4_equal"]):
        raise AssertionError(f"{name}: graphed launches {got['launches']} "
                             f"{got['k4']}, eager {want['launches']} "
                             f"{want['k4']}")
    if d.max() > SMALL_MAX_LSB or d.mean() > SMALL_MEAN_LSB:
        raise AssertionError(f"{name}: graphed and eager outputs differ by "
                             f"{d.max()} / {d.mean():.4f} LSB")
    return same


def _graph_memory() -> float:
    """GiB the caching allocator holds after releasing what it can: the
    live tensors, the graphs' pools and their static inputs."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 30


def _check_graph_keys(name: str, p, frames, flow_masks) -> dict:
    """`p`'s graphs by stage against the call keys its plan gives its
    graphed stages (`_graph_keys`), every key captured."""
    counts = p.graphs.counts()
    expect = {k: v for k, v in _graph_keys(
        p, _stage4_plan(p, flow_masks), frames.shape[0],
        frames.shape[2]).items() if k in p.graphs.stages}
    if counts != expect:
        raise AssertionError(f"{name}: graphs {counts}, keys {expect}")
    return counts


def _held_to_trace(name: str, p, frames, flow_masks, counters: dict,
                   trace: dict | None = None) -> list:
    """A graphed run of `p`'s kernels in a profiler trace against its
    launch counts (`counters`, `_trace_counters`): a replay's counts
    are the capture's, added back by `graphs.StageGraphs`, and the trace
    shows what ran. `trace`: the counts of a profiled run already taken,
    else one is (both through `_device_trace`). A trace can lose kernel
    records (an H100 trace of a graphed bf16 run once held 126 of its 128
    K4 launches while the replays gave eager's output bit for bit), so a
    trace that differs is taken again, and the second must agree. Returns
    the traces."""
    def profiled(label):
        return _profile_run(p, frames, flow_masks, label, show=0,
                            host=False)[4]

    traces = [trace if trace is not None else profiled(f"{name} graphed")]
    if traces[0] != counters:
        traces.append(profiled(f"{name} graphed, again"))
    shown = [k for k in TRACE_KERNELS
             if counters[k] or any(t[k] for t in traces)]
    print(f"  {name} graphed: kernels in the trace "
          + " then ".join(str({k: t[k] for k in shown}) for t in traces)
          + f", launch counts {({k: counters[k] for k in shown})}")
    if traces[-1] != counters:
        raise AssertionError(f"{name}: the trace's kernels differ from the "
                             f"launch counts")
    return traces


def _graph_ab(name: str, p, frames, flow_masks, smi: str) -> dict:
    """fp32 or bf16 'flash' graphed against eager on new pipelines of
    `p`'s configuration and modules: each one's first video (the graphed
    one's warm-up and in-video captures) and the graphed one's second
    (stages 2 and 3 captured), graphs by stage against the plan's keys,
    capture seconds, the graphs' GiB against the eager run's peak; the
    graphs replayed on a second clip of the same shape and masks (so the
    same plan and keys; frames of another seed) against eager on it; then
    GRAPH_PAIRS[name] alternating pairs (graphed first in even pairs),
    outputs and launches checked in each (`_same_run`), with each stage's
    decision; then one profiled run of each: the device's busy share, and
    the graphed run's kernels in the trace against its launch counts
    (`_held_to_trace`)."""
    import torch

    from propainter_tpu_torch.graphs import STAGES

    t0 = time.perf_counter()
    eager, graphed = _twin(p, ()), _twin(p, STAGES)
    base = _graph_memory()
    torch.cuda.reset_peak_memory_stats()
    first_e = _graph_run(eager, frames, flow_masks)
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
    first_g = _graph_run(graphed, frames, flow_masks)
    second_g = _graph_run(graphed, frames, flow_masks)
    gib = _graph_memory() - base
    same = _same_run(name, second_g, first_e, graphed, eager, frames,
                     flow_masks)
    _same_run(name, first_g, first_e)
    counts = _check_graph_keys(name, graphed, frames, flow_masks)
    frames2 = _synthetic_clip(*frames.shape[:3], seed=SECOND_CLIP_SEED)[0]
    n_keys = len(graphed.graphs.keys())
    other = _same_run(f"{name} second clip",
                      _graph_run(graphed, frames2, flow_masks),
                      _graph_run(eager, frames2, flow_masks), graphed,
                      eager, frames2, flow_masks)
    if (graphed.graphs.counts() != counts
            or len(graphed.graphs.keys()) != n_keys):
        raise AssertionError(f"{name}: the second clip did not replay only "
                             f"the first clip's graphs")
    print(f"  {name}: first video eager {first_e['wall']:.3f} s, graphed "
          f"{first_g['wall']:.3f} s (warm-up and in-video captures), second "
          f"{second_g['wall']:.3f} s; outputs identical {same['identical']} "
          f"(max {same['max_lsb']} LSB), launches and K4 calls equal; a "
          f"second clip (seed {SECOND_CLIP_SEED}) replayed: identical to "
          f"eager {other['identical']} (max {other['max_lsb']} LSB); graphs "
          f"by stage {counts} (the plan's keys), capture "
          f"{graphed.graphs.capture_seconds:.3f} s; graphs' memory "
          f"{gib:.2f} GiB (eager peak allocated {peak_e:.2f} GiB) on {smi}")
    t1 = time.perf_counter()
    runs = {"graphed": [], "eager": []}
    for i in range(GRAPH_PAIRS[name]):
        order = ("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")
        for side in order:
            run = _graph_run(graphed if side == "graphed" else eager, frames,
                             flow_masks)
            _same_run(name, run, first_e)
            runs[side].append(dict(wall=run["wall"], stages=run["stages"]))
    decisions = {}
    for stage in ("total",) + STAGES:
        def times(side):
            return [r["wall"] if stage == "total" else r["stages"][stage]
                    for r in runs[side]]
        g, e = times("graphed"), times("eager")
        decisions[stage] = dict(graphed=_spread(g), eager=_spread(e),
                                keep=statistics.median(g) < min(e))
        print(f"  {name} {stage}: graphed median {statistics.median(g):.4f} "
              f"s ({min(g):.4f}-{max(g):.4f}), eager min {min(e):.4f} s "
              f"(median {statistics.median(e):.4f}) over "
              f"{GRAPH_PAIRS[name]} pairs: "
              + ("keep the graph" if decisions[stage]["keep"] else
                 "stays eager"))
    t2 = time.perf_counter()
    busy, traces = {}, []
    counters = _trace_counters(second_g["launches"])
    for side, q in (("graphed", graphed), ("eager", eager)):
        _, _, wall_ms, busy_ms, trace = _profile_run(
            q, frames, flow_masks, f"{name} {side}", show=4, host=False)
        busy[side] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                          share=busy_ms / wall_ms)
        if side == "graphed":
            traces = _held_to_trace(name, graphed, frames, flow_masks,
                                    counters, trace)
    print(f"  {name}: device busy graphed {100 * busy['graphed']['share']:.1f}"
          f"% of {busy['graphed']['wall_ms']:.1f} ms, eager "
          f"{100 * busy['eager']['share']:.1f}% of "
          f"{busy['eager']['wall_ms']:.1f} ms; seconds: first videos and "
          f"second clip {t1 - t0:.1f}, pairs {t2 - t1:.1f}, profiled runs "
          f"{time.perf_counter() - t2:.1f}")
    result = dict(same, first_video_eager_s=first_e["wall"],
                  first_video_graphed_s=first_g["wall"],
                  second_video_graphed_s=second_g["wall"],
                  second_clip=other, graphs=counts,
                  capture_s=graphed.graphs.capture_seconds,
                  graphs_gib=gib, eager_peak_gib=peak_e, pairs=runs,
                  decisions=decisions, busy=busy, traces=traces)
    del graphed, eager
    _graph_memory()
    return result


def _graph_eval(pipe, smi: str) -> dict:
    """The evaluation protocol (`GRAPH_EVAL_CONFIG`, fp32 as
    `cli/evaluate.py`) over videos of GRAPH_EVAL_LENGTHS in two passes:
    an eager pipeline, then a graphed one (the default stages) reused
    across the videos as the CLI reuses its pipeline, with process-wide
    cuDNN and cuBLAS plans warm, which favours the graphed pass. Each
    graphed video's uint8 output against the eager pass's (`_same_run`);
    each video's seconds; after each graphed
    video, the graphs by stage, capture seconds and the GiB the pipeline
    holds (its cache keeps the last video's keys); each pass's peak
    allocated GiB; the graphed total against the eager one."""
    import numpy as np
    import torch

    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    clips = {}
    for T in GRAPH_EVAL_LENGTHS:
        frames, mask = _synthetic_clip(T, 240, 432, seed=T)
        clips[T] = (frames, np.stack([binary_dilation_cross(m, 4)
                                      for m in mask]))
    order = GRAPH_EVAL_LENGTHS
    cfg = PipelineConfig(**GRAPH_EVAL_CONFIG)
    passes, want, rows = {}, {}, []
    for side in ("eager", "graphed"):
        q = ProPainterPipeline(pipe.raft, pipe.flowcomp, pipe.inpaint, cfg,
                               device="cuda", **(
                                   {} if side == "graphed"
                                   else dict(cuda_graphs=())))
        base = _graph_memory()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i, T in enumerate(order):
            run = _graph_run(q, *clips[T])
            walls.append(run["wall"])
            if side != "graphed":
                want.setdefault(T, run)
                continue
            same = _same_run(f"eval protocol, {T} frames", run, want[T])
            rows.append(dict(frames=T, wall=run["wall"],
                             eager_wall=want[T]["wall"],
                             identical=same["identical"],
                             max_lsb=same["max_lsb"],
                             graphs=q.graphs.counts(),
                             keys=len(q.graphs.keys()),
                             capture_s=q.graphs.capture_seconds,
                             graphs_gib=_graph_memory() - base))
            print(f"  eval protocol, video {i + 1} ({T} frames): graphed "
                  f"{run['wall']:.3f} s (first eager pass "
                  f"{want[T]['wall']:.3f} s), identical {same['identical']} "
                  f"(max {same['max_lsb']} LSB); graphs by stage "
                  f"{rows[-1]['graphs']} of {rows[-1]['keys']} keys held, "
                  f"capture {rows[-1]['capture_s']:.3f} s so far, graphs' "
                  f"memory {rows[-1]['graphs_gib']:.2f} GiB")
        passes[side] = dict(
            walls=walls, total=sum(walls),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del q
        _graph_memory()
    pays = passes["graphed"]["total"] < passes["eager"]["total"]
    print(f"  eval protocol over {len(order)} videos ({order} frames): "
          + ", ".join(f"{k} {v['total']:.3f} s (peak allocated "
                      f"{v['peak_gib']:.2f} GiB)" for k, v in passes.items())
          + f": graphs {'pay' if pays else 'do not pay'} on {smi}")
    return dict(order=list(order), runs=rows, passes=passes, graphs_pay=pays)


def _versus_eager(state: dict, name: str, p, frames, flow_masks,
                  got: dict) -> None:
    """`got`, a graphed run of `p` with every call key captured (its
    output, launches and K4's calls), against one eager run of its
    configuration (`_twin` with no stage graphed): `_same_run`, the
    graphs by stage against the plan's call keys, and a graphed run's
    kernels in a profiler trace against `got`'s launch counts
    (`_held_to_trace`), into state["graphs"]["configs"][name]."""
    t0 = time.perf_counter()
    eager = _twin(p, ())
    want = _graph_run(eager, frames, flow_masks)
    same = _same_run(name, got, want, p, eager, frames, flow_masks)
    del eager
    counts = _check_graph_keys(name, p, frames, flow_masks)
    capture_s = p.graphs.capture_seconds
    print(f"  {name} graphed against eager: {got['wall']:.3f} s against "
          f"{want['wall']:.3f} s; outputs identical {same['identical']} "
          f"(max {same['max_lsb']} LSB, mean {same['mean_lsb']:.4f}); "
          f"launches and K4 calls equal; graphs by stage {counts} (the "
          f"plan's keys), capture {capture_s:.3f} s")
    traces = _held_to_trace(name, p, frames, flow_masks,
                            _trace_counters(got["launches"]))
    print(f"  {name}: the eager run and the trace in "
          f"{time.perf_counter() - t0:.1f} s")
    state.setdefault("graphs", {}).setdefault("configs", {})[name] = dict(
        same, graphed_s=got["wall"], eager_s=want["wall"], graphs=counts,
        capture_s=capture_s, traces=traces)


def _as_graph_run(out, launches, summary) -> dict:
    """A `_measured_run`'s first run as `_graph_run` gives it."""
    return dict(out=out, launches=launches, wall=summary["runs"][0]["seconds"],
                k4={tuple(c[:3]): c[3] for c in summary["k4_calls"]})


def phase_graphs(state: dict, smi: str) -> None:
    """The main path's stages from CUDA graphs (`graphs.StageGraphs`)
    against eager (`_twin` with no stage graphed) on the pipeline phase's
    clip and weights, in its seven configurations: fp32 and bf16 'flash'
    measured in pairs (`_graph_ab`); the five others of `GRAPH_CONFIGS`
    (the pipeline phase's pipelines, else new ones) warmed up until every
    key is captured, then one graphed and one eager run; in each the
    uint8 outputs and the launch counts and K4's calls equal
    (`_same_run`), the graphs by stage against the plan's call keys, the
    graphed run's kernels in a trace against its launch counts
    (`_held_to_trace`); then the evaluation protocol over four lengths
    (`_graph_eval`). The pipeline
    phase, when it ran, compared the five others after its measured runs
    (`_versus_eager`). Each pipeline's graphs are released after its
    turn."""
    if "main_path" not in state:
        state["main_path"] = _main_path_inputs()
    pipe, frames, flow_masks = state["main_path"]
    report = state.setdefault("graphs", {})
    parts = report["seconds"] = {}
    for name in GRAPH_PAIRS:
        t0 = time.perf_counter()
        p = pipe if name == "flash" else state.get(f"main_path_{name}")
        if p is None:
            p = state[f"main_path_{name}"] = _bf16_pipeline(pipe)
        report[name] = _graph_ab(name, p, frames, flow_masks, smi)
        parts[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name, make in GRAPH_CONFIGS:
        if name in report.get("configs", {}):
            continue
        key = f"main_path_{name}"
        p = state.get(key)
        if p is None:
            p = state[key] = make(pipe)
        _warm_up(p, frames, flow_masks)
        _versus_eager(state, name, p, frames, flow_masks,
                      _graph_run(p, frames, flow_masks))
        _release(p)
    parts["configs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["eval"] = _graph_eval(pipe, smi)
    parts["eval"] = time.perf_counter() - t0
    print("  graphs phase seconds by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))


# seconds the device idles at each edge of a checked trace (`_device_trace`)
TRACE_MARGIN_S = 0.05


@contextlib.contextmanager
def _device_trace(host: bool = False):
    """torch.profiler over the block (host=False: the device's activity
    only), the device synchronized and idle for TRACE_MARGIN_S after the
    trace starts and again before it stops. The profiler drops a device
    record that its clock places outside the trace's window (kineto's
    "Out-of-range" record count), and the device's clock drifts from the
    host's over a process, so a trace stopped as soon as a graphed run
    returned could lose the run's last kernels (a generator call's K3 and
    K4 launches), in both of `_held_to_trace`'s takes.
    tools/torch_trace_window.py counts such losses."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host else [])) as prof:
        time.sleep(TRACE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def _trace_rows(prof, device=None) -> list:
    """(name, device ms, launches) of each kernel, copy and fill in a
    torch.profiler trace (`device`: the DeviceType read, CUDA by default),
    summed by name, the most time first: read from the profiler's raw
    events, since building its event tree for `key_averages` took 7-27 s
    a main-path trace (an H100 run)."""
    from torch.autograd import DeviceType

    device = DeviceType.CUDA if device is None else device
    totals: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device:
            ms, n = totals.get(e.name(), (0.0, 0))
            totals[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in totals.items()),
                  key=lambda r: -r[1])


def _profile_run(pipe, frames, flow_masks, label: str,
                 show: int = 21, host: bool = True):
    """One main-path run of `pipe` under torch.profiler (host=False: the
    device's activity only, a smaller trace): (report lines, device ms of
    the port's kernels, wall ms, device busy ms, the kernels' launches in
    the trace by launch counter, `TRACE_KERNELS`), traced by
    `_device_trace`."""
    timings: dict = {}
    with _device_trace(host) as prof:
        t0 = time.perf_counter()
        pipe.inpaint_video(frames, flow_masks, flow_masks, timings=timings)
        wall = time.perf_counter() - t0
    kern = _trace_rows(prof)
    print(f"  {label}: the trace stopped and read in "
          f"{time.perf_counter() - t0 - wall:.1f} s")
    busy = sum(r[1] for r in kern)
    # whole-symbol match: "window_attention_kernel" must not count
    # "sparse_window_attention_kernel"
    ours = {k: sum(r[1] for r in kern
                   if re.search(rf"\b{k}_kernel\b", r[0]))
            for k in ("corr_lookup_moenc", "corr_lookup",
                      "corr_pyramid_build", "deform_conv", "deform_sample",
                      "window_attention", "sparse_window_attention",
                      "corr_lookup_moenc_bf16", "corr_pyramid_build_bf16",
                      "deform_conv_bf16", "window_attention_bf16")}
    lines = [f"{label}: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
             f"({100 * busy / (wall * 1e3):.1f}%), stages (s): " + ", ".join(
                 f"{k} {v:.3f}" for k, v in timings.items())]
    lines += [f"{ms:10.2f} ms {100 * ms / busy:5.1f}% x{n:<7d} {name[:100]}"
              for name, ms, n in kern]
    for line in lines[:show]:
        print("  " + line)
    print(f"  {label} port kernels (ms): {ours}")
    counts = {k: sum(r[2] for r in kern if re.search(rf"\b{sym}\b", r[0]))
              for k, sym in TRACE_KERNELS.items()}
    return lines, ours, wall * 1e3, busy, counts


def _gemm_conv_ab() -> list:
    """The GemmConv2d layers of the main path at their main-path input
    shapes, in fp32 and bf16: device ms of the layer's im2col GEMM
    (GemmConv2d.gemm, its fp32 form) against one cuDNN convolution
    (F.conv2d, its bf16 form) on the same input and weights, cuDNN's TF32
    off as in the pipeline."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.models.layers import GemmConv2d

    layers = (  # (site, batch, C_in, C_out, groups, H, W)
        ("RAFT convc2", 24, 256, 192, 1, 30, 54),
        ("RAFT motion conv", 24, 256, 126, 1, 30, 54),
        ("encoder group conv g2", 19, 640, 512, 2, 60, 108),
        ("encoder group conv g4", 19, 768, 384, 4, 60, 108),
        ("encoder group conv g8", 19, 640, 256, 8, 60, 108),
        ("encoder group conv g1", 19, 512, 128, 1, 60, 108))
    rows = []
    with torch.inference_mode():
        for site, n, cin, cout, g, h, w in layers:
            for dt in (torch.float32, torch.bfloat16):
                conv = GemmConv2d(cin, cout, 3, 1, groups=g).cuda().to(dt)
                x = torch.randn(n, cin, h, w, device="cuda").to(dt)
                gemm_ms = _time_ms(lambda: conv.gemm(x), 5)
                cudnn_ms = _time_ms(lambda: F.conv2d(
                    x, conv.weight, conv.bias, padding=1, groups=g), 5)
                rows.append(dict(site=site, dtype=str(dt).split(".")[1],
                                 gemm_ms=gemm_ms, cudnn_ms=cudnn_ms))
                print(f"  GemmConv2d {site} {rows[-1]['dtype']}: GEMM "
                      f"{gemm_ms:.3f} ms, cuDNN {cudnn_ms:.3f} ms")
                del conv, x
    torch.cuda.empty_cache()
    return rows


def phase_profile(state: dict) -> None:
    """The main path under torch.profiler in fp32 ('flash') and bf16:
    device time by kernel and the device's busy share of the wall time;
    one RAFT chunk and one generator window in each attention form and in
    bf16, host and device ms by op shape; and the GemmConv2d layers against
    cuDNN in both precisions (the full tables go to `profile.txt` in
    --out-dir, when given)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if "main_path" not in state:
        state["main_path"] = _main_path_inputs()
    pipe, frames, flow_masks = state["main_path"]
    bf16 = state.get("main_path_bf16") or _bf16_pipeline(pipe)
    for p in (pipe, bf16):
        _warm_up(p, frames, flow_masks)
    report = []
    runs = {}
    for label, p in (("fp32 'flash'", pipe), ("bf16 'flash'", bf16)):
        lines, ours, wall, busy, _ = _profile_run(p, frames, flow_masks,
                                                  label)
        report += lines
        runs[label] = dict(wall_ms=wall, device_busy_ms=busy,
                           kernels_ms=ours)

    # one RAFT chunk (13 frames) and one generator window (11 local + 8
    # reference frames) in both attention forms and in bf16, after a
    # warm-up call: host and device ms per op shape, and device ms by
    # kernel
    T, H, W = 19, frames.shape[1], frames.shape[2]
    x = (torch.from_numpy(frames[:T]).cuda().float() / 127.5 - 1)[None]
    m = torch.from_numpy(flow_masks[:T]).cuda().float()[None, ..., None]
    zero_flow = torch.zeros((1, 10, H, W, 2), device="cuda")
    valid = torch.ones(T, dtype=torch.bool, device="cuda")

    def window(generator, dt=torch.float32):
        xd, fd, md = x.to(dt), zero_flow.to(dt), m.to(dt)
        return lambda: generator(xd, (fd, fd), md, md, 11,
                                 frame_valid=valid)

    sparse = state.get("main_path_pallas") or _pallas_pipeline(pipe)
    iters = pipe.config.raft_iter
    work = {"RAFT chunk": lambda: pipe._raft_bi(x[:, :13], iters),
            "generator window": window(pipe.inpaint),
            "generator window ('pallas')": window(sparse.inpaint),
            "RAFT chunk (bf16)": lambda: bf16._raft_bi(x[:, :13], iters),
            "generator window (bf16)": window(bf16.inpaint, torch.bfloat16)}
    ops = ("aten::convolution", "aten::linear", "aten::matmul", "aten::bmm",
           "aten::col2im", "aten::im2col")
    for what, fn in work.items():
        with torch.inference_mode():
            fn()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                fn()
                torch.cuda.synchronize()
        rows = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key in ops]
        rows.sort(key=lambda e: -e.device_time_total)
        lines = [f"{what}: host ms / device ms / count / op / input shapes"]
        lines += [f"{e.cpu_time_total / 1e3:9.2f} "
                  f"{e.device_time_total / 1e3:9.2f} x{e.count:<5d} {e.key} "
                  f"{str(e.input_shapes)[:100]}" for e in rows]
        kern = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        lines += [f"{what}: device {sum(r[1] for r in kern):.2f} ms; by "
                  f"kernel"]
        lines += [f"{ms:10.2f} ms x{n:<6d} {name[:100]}"
                  for name, ms, n in kern]
        report += lines
        for line in lines[:14] + lines[len(lines) - len(kern) - 1:][:13]:
            print("  " + line)
    gemm = _gemm_conv_ab()
    report += [f"GemmConv2d {r['site']} {r['dtype']}: GEMM "
               f"{r['gemm_ms']:.3f} ms, cuDNN {r['cudnn_ms']:.3f} ms"
               for r in gemm]
    state["profile"] = dict(runs=runs, gemm_conv=gemm, report=report)


def _stage_outputs(pipe, frames, mask, given=None) -> dict:
    """Float outputs of RAFT, flow completion and the generator (one window
    of the first 4 frames plus 2 references) on the small clip, on
    `pipe`'s device. With `given` (another device's outputs) each stage
    takes the inputs that device's earlier stages produced, so each stage
    is compared on its own."""
    import torch

    dev = pipe.device
    x = (torch.from_numpy(frames).float() / 127.5 - 1.0)[None]
    m = torch.from_numpy(mask).float()[None, ..., None]
    x, m = x.to(dev), m.to(dev)
    src = {k: tuple(t.to(dev) for t in v) for k, v in (given or {}).items()}
    out = {}
    with torch.inference_mode():
        out["raft"] = pipe.compute_flows(x)
        flows = src.get("raft", out["raft"])
        out["flow_completion"] = pipe.complete_flows(flows, m)
        ff, fb = src.get("flow_completion", out["flow_completion"])
        l_t = 4
        valid = torch.ones(x.shape[1], dtype=torch.bool, device=dev)
        out["generator"] = (pipe.inpaint(
            x, (ff[:, :l_t - 1], fb[:, :l_t - 1]), m, m, l_t,
            frame_valid=valid),)
    return {k: tuple(t.cpu() for t in v) for k, v in out.items()}


def phase_small(state: dict) -> None:
    """The same small clip and weights on the GPU and on the CPU, in the
    three configurations ('flash' through the `ProInpainter` facade,
    'pallas' and shard_inference with window_batch 4 through the
    pipeline). The weights are fan-in scaled so the
    inpainted region varies (its spread must reach SMALL_MIN_HOLE_STD).
    The uint8 outputs are held to the golden check's limits, and the float
    outputs of RAFT, flow completion and one generator window to
    STAGE_REL_TOL of their scale."""
    import numpy as np
    from propainter_tpu_torch.api import ProInpainter
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    frames, mask = _synthetic_clip(6, 144, 160, seed=2)
    flow_masks = np.stack([binary_dilation_cross(m, 4) for m in mask])
    failures = []
    configs = {"flash": dict(attention_impl="flash"),
               "pallas": dict(attention_impl="pallas"),
               "shard": dict(shard_inference=True, window_batch=4)}
    for impl, options in configs.items():
        outs, stages = {}, {}
        for device in ("cpu", "cuda"):
            mods = _models(seed=5, fan_in_scaled=True)
            pipe = ProPainterPipeline(
                mods["raft"], mods["flowcomp"], mods["inpaint"],
                PipelineConfig(raft_iter=3, neighbor_length=4, ref_stride=3,
                               **options), device=device)
            if impl == "flash":
                outs[device] = ProInpainter(mods, precision="fp32",
                                            device=device).inpaint(
                    frames, mask, raft_iter=3, neighbor_length=4,
                    ref_stride=3)
            else:
                outs[device] = np.stack(pipe.inpaint_video(
                    frames, flow_masks, flow_masks))
            stages[device] = _stage_outputs(pipe, frames, mask,
                                            stages.get("cpu"))
        diff = np.abs(outs["cuda"].astype(int) - outs["cpu"].astype(int))
        hole_std = float(outs["cpu"][mask.astype(bool)].std())
        print(f"  small clip ({impl}) GPU vs CPU: max {diff.max()} LSB, "
              f"mean {diff.mean():.4f} LSB (limits {SMALL_MAX_LSB} / "
              f"{SMALL_MEAN_LSB}); std inside the hole {hole_std:.2f} LSB "
              f"(at least {SMALL_MIN_HOLE_STD})")
        stage_err = {}
        for key, want in stages["cpu"].items():
            got = stages["cuda"][key]
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            scale = max(max(w.abs().max().item() for w in want), 1.0)
            stage_err[key] = err / scale
            print(f"  {key} ({impl}) GPU vs CPU: max abs {err:.3e}, scale "
                  f"{scale:.3f} (relative limit {STAGE_REL_TOL})")
        state.setdefault("small", {})[impl] = dict(
            max_lsb=int(diff.max()), mean_lsb=float(diff.mean()),
            hole_std_lsb=hole_std, stage_rel_err=stage_err)
        if hole_std < SMALL_MIN_HOLE_STD:
            failures.append(f"{impl}: the inpainted region is too flat to "
                            f"compare")
        if diff.max() > SMALL_MAX_LSB or diff.mean() > SMALL_MEAN_LSB:
            failures.append(f"{impl}: GPU and CPU outputs disagree")
        bad = [k for k, e in stage_err.items() if e > STAGE_REL_TOL]
        if bad:
            failures.append(f"{impl}: GPU and CPU stages disagree: {bad}")
    failures += _golden_clip_bf16(state)
    failures += _raft_bf16_volume(state)
    if failures:
        raise AssertionError("; ".join(failures))


def _raft_bf16_volume(state: dict) -> list:
    """One RAFT chunk of the main path (12 frames of 432x240, fan-in
    scaled weights) on the GPU through `compute_flows` with
    precision='bf16' and raft_bf16_refine=False, in both corr layouts:
    RAFT refines in fp32 over a bf16 volume, through K1 over a bf16 volume
    ('flat') or K7's bf16 form ('batched', shard_inference), once per
    iteration; launches counted from zero over each run. The flows'
    drift from the fp32 pipeline's on the same weights is reported in px
    and relative to the flow scale (not gated)."""
    import torch
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    frames, _ = _synthetic_clip(12, 240, 432, seed=0)
    x = (torch.from_numpy(frames).float() / 127.5 - 1.0)[None].cuda()
    mods = _models(seed=5, fan_in_scaled=True)
    configs = {"fp32": dict(),
               "flat": dict(precision="bf16", raft_bf16_refine=False),
               "batched": dict(precision="bf16", raft_bf16_refine=False,
                               shard_inference=True)}
    kernel = {"flat": "corr_lookup_moenc_bf16_volume",
              "batched": "corr_lookup_bf16"}
    flows, report, failures = {}, {}, []
    for name, options in configs.items():
        pipe = ProPainterPipeline(mods["raft"], mods["flowcomp"],
                                  mods["inpaint"], PipelineConfig(**options),
                                  device="cuda")
        _zero_launches()
        with torch.inference_mode():
            flows[name] = torch.cat(pipe.compute_flows(x), 1)
        torch.cuda.synchronize()
        launches = _read_launches()
        if name == "fp32":
            continue
        iters = pipe.config.raft_iter
        others = {k: v for k, v in launches.items()
                  if k not in (kernel[name], "corr_pyramid_build_bf16") and v}
        diff = (flows[name] - flows["fp32"]).abs()
        scale = flows["fp32"].abs().max().item()
        report[name] = dict(max_px=diff.max().item(),
                            mean_px=diff.mean().item(), flow_scale_px=scale,
                            launches={k: v for k, v in launches.items() if v})
        print(f"  RAFT chunk ({name}, fp32 refine over a bf16 volume) vs "
              f"the fp32 refine: max {report[name]['max_px']:.4f} px, mean "
              f"{report[name]['mean_px']:.5f} px, flows up to {scale:.2f} "
              f"px ({report[name]['max_px'] / max(scale, 1e-6):.2e} of "
              f"them); {kernel[name]} {launches[kernel[name]]} launches "
              f"(want {iters}), others {others}")
        if launches[kernel[name]] != iters or others:
            failures.append(f"RAFT chunk ({name}): launched {launches}")
        if not torch.isfinite(flows[name]).all():
            failures.append(f"RAFT chunk ({name}): flows not finite")
    state.setdefault("small", {})["raft_bf16_volume"] = report
    return failures


def _golden_clip():
    """The golden fixture's clip and mask (tests/test_golden_e2e.py): 6
    frames of 144 x 160, a textured frame panning right, a hole moving
    right."""
    import numpy as np

    T, H, W = 6, 144, 160
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (H // 8, W // 8, 3), np.uint8)
    frames = np.stack([
        np.roll(np.kron(base, np.ones((8, 8, 1), np.uint8)), 3 * t, axis=1)
        for t in range(T)])
    mask = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        mask[t, 50:90, 40 + 4 * t:100 + 4 * t] = 1
    return frames, mask


def _golden_clip_bf16(state: dict) -> list:
    """The golden fixture's run (its clip, schedule and weight scale) in
    bf16 on the GPU, under 'flash' and under 'pallas', against the fp32
    run on the CPU (the plain versions,
    which the CPU tests hold to the golden within 2 LSB), within the bf16
    golden gate (GOLDEN_BF16_MAX_LSB / GOLDEN_BF16_MEAN_LSB). The golden's
    own weights come from jax.random, which this machine does not have:
    the port's seeded weights of the same scale (N(0, 0.02^2)) stand in."""
    import numpy as np
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    frames, mask = _golden_clip()
    outs = {}
    for device, precision, impl in (("cpu", "fp32", "flash"),
                                    ("cuda", "bf16", "flash"),
                                    ("cuda", "bf16", "pallas")):
        mods = _models(seed=11)
        pipe = ProPainterPipeline(
            mods["raft"], mods["flowcomp"], mods["inpaint"],
            PipelineConfig(ref_stride=3, neighbor_length=4, raft_iter=3,
                           precision=precision, attention_impl=impl),
            device=device)
        outs[precision, impl] = np.stack(pipe.inpaint_video(frames, mask,
                                                             mask))
    failures = []
    for impl in ("flash", "pallas"):
        diff = np.abs(outs["bf16", impl].astype(int)
                      - outs["fp32", "flash"].astype(int))
        print(f"  golden clip: GPU bf16 '{impl}' vs CPU fp32: max "
              f"{diff.max()} LSB, mean {diff.mean():.4f} LSB (limits "
              f"{GOLDEN_BF16_MAX_LSB} / {GOLDEN_BF16_MEAN_LSB})")
        key = "golden_clip_bf16" + ("" if impl == "flash" else f"_{impl}")
        state.setdefault("small", {})[key] = dict(
            max_lsb=int(diff.max()), mean_lsb=float(diff.mean()))
        if (diff.max() > GOLDEN_BF16_MAX_LSB
                or diff.mean() > GOLDEN_BF16_MEAN_LSB):
            failures.append(f"golden clip: bf16 '{impl}' on the GPU and "
                            f"fp32 disagree")
    return failures


# ---- the evaluation path (`cli/evaluate.py` and the other evaluation CLIs)

# the evaluation protocol's videos at 432 x 240: the longest and the median
# DAVIS test videos (datasets/davis/test.json: 50 videos of 25-104 frames,
# median 73); sorted by name the 104-frame video comes first, so --profile
# traces the 73-frame one
EVAL_VIDEOS = (("video_104", 104), ("video_73", 73))
EVAL_SEEDS = {"raft": 41, "flowcomp": 42, "inpaint": 43, "i3d": 44}
# K1's and K2's pair-directions in one 60-frame RAFT chunk of the
# evaluation (`raft_clip_len` 60): 59 pairs x 2 directions
EVAL_RAFT_PAIRS = 118
# GPU against CPU on the fixture clip (fp32 both): PSNR and SSIM of the
# evaluation (dB and SSIM units), I3D's features relative to their scale
EVAL_GPU_CPU_TOL = 1e-3


def _write_eval_dataset(root: Path, videos=EVAL_VIDEOS, H=240, W=432):
    """A DAVIS-layout dataset of `_synthetic_clip` videos: JPEGImages/<v>/
    %05d.jpg, Annotations/<v>/%05d.png (0 / 255) and test.json."""
    import cv2

    names = {}
    for i, (name, T) in enumerate(videos):
        frames, mask = _synthetic_clip(T, H, W, seed=10 + i)
        for sub in ("JPEGImages", "Annotations"):
            (root / sub / name).mkdir(parents=True)
        for t in range(T):
            cv2.imwrite(str(root / "JPEGImages" / name / f"{t:05d}.jpg"),
                        cv2.cvtColor(frames[t], cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(root / "Annotations" / name / f"{t:05d}.png"),
                        mask[t] * 255)
        names[name] = T
    (root / "test.json").write_text(json.dumps(names))


def _write_eval_weights(root: Path) -> None:
    """The three released checkpoint files of seeded weights (RAFT's keys
    under DataParallel's `module.`), and a seeded i3d_rgb_imagenet.pt with
    the released file's `logits.*` head, which the loader drops; I3D's
    weights are fan-in scaled with batch-norm scales U(0.5, 1.5), so its
    features stay O(1) through its 57 layers."""
    import torch
    from propainter_tpu_torch.cli.inference import CHECKPOINTS
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.i3d import InceptionI3d
    from propainter_tpu_torch.models.layers import FrozenBatchNorm
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    root.mkdir(parents=True, exist_ok=True)
    for name, module in (("raft", RAFT()),
                         ("flowcomp", RecurrentFlowCompleteNet()),
                         ("inpaint", InpaintGenerator())):
        sd = seeded_init_(module, EVAL_SEEDS[name]).state_dict()
        if name == "raft":
            sd = {"module." + k: v for k, v in sd.items()}
        torch.save(sd, root / CHECKPOINTS[name])
    i3d = seeded_init_(InceptionI3d(), EVAL_SEEDS["i3d"], fan_in_scaled=True)
    gen = torch.Generator().manual_seed(EVAL_SEEDS["i3d"])
    for bn in i3d.modules():
        if isinstance(bn, FrozenBatchNorm):
            bn.weight.data = torch.rand(bn.weight.shape, generator=gen) + 0.5
    sd = dict(i3d.state_dict())
    sd["logits.conv3d.weight"] = torch.randn(400, 1024, 1, 1, 1,
                                             generator=gen) * 0.03
    sd["logits.conv3d.bias"] = torch.zeros(400)
    torch.save(sd, root / "i3d_rgb_imagenet.pt")


def _eval_pipeline(**options):
    """A CPU pipeline of `cli.evaluate`'s configuration under the protocol
    (unchunked, RAFT chunks of 60, neighbor_length 20, ref_stride 10),
    for its stage-4 plans (masks only)."""
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    cfg = dict(neighbor_length=20, ref_stride=10, unchunked=True,
               raft_clip_len=60, raft_iter=20)
    cfg.update(options)
    return ProPainterPipeline(RAFT(), RecurrentFlowCompleteNet(),
                              InpaintGenerator(), PipelineConfig(**cfg),
                              device="cpu")


def _flow_completion_deforms(n_flows: int, cfg) -> int:
    """K3's launches in stage 2 over n_flows flows: one per frame but the
    first of each direction of each call (its recurrent propagation), the
    call the whole video under `unchunked`, else each subvideo_length
    chunk with its 5-flow overlap."""
    sub = cfg.subvideo_length
    if cfg.unchunked or n_flows <= sub:
        return 2 * (n_flows - 1)
    return sum(2 * (min(n_flows, f + sub + 5) - max(0, f - 5) - 1)
               for f in range(0, n_flows, sub))


def _raft_chunks(cfg, T: int, W: int) -> int:
    """`compute_flows`' RAFT calls on T frames of width W under `cfg`."""
    from propainter_tpu_torch.pipeline import get_short_clip_len

    return len(range(0, T, cfg.raft_clip_len or get_short_clip_len(W)))


def _eval_launches(pipe, T: int, W: int, plan, warp_error: bool) -> dict:
    """The launches one video of T frames of width W gives in
    `cli.evaluate` on `pipe`'s configuration: K2 once per RAFT call and K1
    once per iteration of it (the video's RAFT chunks, twice with
    --warp_error); K3 in flow completion (`_flow_completion_deforms`) and
    in the generator's feature propagation (2 x (l_t - 1) a generator
    call); K4 as `_plan_launches` says; K5 and K7 never."""
    cfg = pipe.config
    raft_calls = _raft_chunks(cfg, T, W) * (2 if warp_error else 1)
    wb = plan.window_batch
    gen = sum(-(-len(sr.windows) // wb) * 2 * (sr.l_t - 1)
              for sr in plan.subruns)
    k4 = _plan_launches(plan, pipe)
    return dict(corr_pyramid_build=raft_calls,
                corr_lookup_moenc=raft_calls * cfg.raft_iter,
                modulated_deform_conv2d=_flow_completion_deforms(T - 1, cfg)
                + gen,
                flash_window_attention=k4["calls"], sparse_window_attention=0,
                corr_lookup=0, k4_shapes=k4["shapes"])


@contextlib.contextmanager
def _tf32_flags(cudnn: bool, matmul: bool):
    """PyTorch's TF32 flags set as given, restored afterwards."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _check_launches(what: str, got: dict, want: dict) -> None:
    """The launch counts `want` names (the others: any) in `got`."""
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    print(f"  {what} launches: "
          + ", ".join(f"{k} {got[k]} (want {v})" for k, v in want.items()))
    if bad:
        raise AssertionError(f"{what}: launches (got, want) {bad}")


# cuDNN's FFT convolutions: the FFTs, the complex GEMMs between them and
# their tiling transforms (kernel names of the H100's cuDNN)
FFT_KERNELS = re.compile(r"fft|cf32|region_transform", re.IGNORECASE)


def _trace_summary(path: Path, top: int = 12) -> dict:
    """Device time by kernel in a torch.profiler chrome trace: the kernels'
    summed ms, the span from the first kernel's start to the last's end,
    the busy share of that span, the `top` kernels by time, and the
    launches and ms of cuDNN's FFT convolution kernels (`FFT_KERNELS`; a
    launch storm of them is the fp32 failure mode `GemmConv2d` works
    around), those also by the op that launched them (name, input dims
    and scalar arguments, when the trace recorded shapes)."""
    events = json.loads(path.read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kern:
        return dict(kernels=0)
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    by_name: dict = {}
    by_op: dict = {}
    for e in kern:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
        if FFT_KERNELS.search(e["name"]):
            op = ops.get(e.get("args", {}).get("External id"), {})
            a = op.get("args", {})
            key = (f"{op.get('name', '?')} {a.get('Input Dims', '')} "
                   f"{a.get('Concrete Inputs', '')}")
            ms, n = by_op.get(key, (0.0, 0))
            by_op[key] = (ms + e["dur"] / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    span = (max(e["ts"] + e["dur"] for e in kern)
            - min(e["ts"] for e in kern)) / 1e3
    fft = [(ms, n) for name, (ms, n) in by_name.items()
           if FFT_KERNELS.search(name)]

    def ranked(d, n):
        return [[k[:300], ms, c] for k, (ms, c) in sorted(
            d.items(), key=lambda kv: -kv[1][0])[:n]]

    return dict(kernels=len(kern), busy_ms=busy, span_ms=span,
                busy_share=busy / span if span else None,
                fft_launches=sum(n for _, n in fft),
                fft_ms=sum(ms for ms, _ in fft),
                top=ranked(by_name, top), fft_by_op=ranked(by_op, top))


def _device_kernels(fn) -> dict:
    """fn() once under torch.profiler after one warm-up call: its device
    ms, its kernel launches, the launches and ms of cuDNN's FFT
    convolution kernels among them, and the six kernels with the most
    device ms (name, ms, launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with _device_trace() as prof:
        fn()
    kern = _trace_rows(prof)
    fft = [r for r in kern if FFT_KERNELS.search(r[0])]
    return dict(device_ms=sum(r[1] for r in kern),
                launches=sum(r[2] for r in kern),
                fft_launches=sum(r[2] for r in fft),
                fft_ms=sum(r[1] for r in fft),
                top=[[name[:100], ms, n] for name, ms, n in kern[:6]])


def _metrics_file(path: Path) -> dict:
    """{name: value} of an evaluation's metrics file."""
    return dict(line.split(": ", 1)
                for line in path.read_text().strip().splitlines())


def _eval_gpu_vs_cpu(tmp: Path, weights: Path) -> dict:
    """The evaluation CLIs and I3D on the GPU against the CPU, fp32 both:
    `evaluate` on the fixture clip (12 frames at 96 x 128, the protocol's
    other settings) PSNR and SSIM within EVAL_GPU_CPU_TOL; `compute_flow`'s
    .flo files (3 fixture frames at 128 x 128) within one fp16 step +
    1e-3 px; I3D's features on a seeded (1, 16, 112, 112) video within
    EVAL_GPU_CPU_TOL of their scale."""
    import numpy as np
    import torch
    from propainter_tpu_torch.cli import compute_flow, evaluate
    from propainter_tpu_torch.cli.inference import CHECKPOINTS, load_checkpoint
    from propainter_tpu_torch.device import fp32_numerics
    from propainter_tpu_torch.models.i3d import InceptionI3d
    from propainter_tpu_torch.utils.flow_io import flowread

    clip = Path(__file__).resolve().parent / "assets" / "demo_clip"
    ds = tmp / "fixture"
    for sub, src in (("JPEGImages", "frames"), ("Annotations", "masks")):
        (ds / sub).mkdir(parents=True)
        (ds / sub / "clip").symlink_to(clip / src)
    (ds / "test.json").write_text(json.dumps({"clip": 12}))
    out = {}
    for dev in ("cuda", "cpu"):
        res = evaluate.main([
            "--video_root", str(ds / "JPEGImages"), "--mask_root",
            str(ds / "Annotations"), "--json_path", str(ds / "test.json"),
            "--height", "96", "--width", "128", "--weights", str(weights),
            "--i3d_path", str(tmp / "none.pt"), "--output",
            str(tmp / f"fixture_{dev}"), "--device", dev])
        out[dev] = res["metrics"]
    diff = {k: abs(out["cuda"][k] - out["cpu"][k]) for k in ("psnr", "ssim")}
    print(f"  evaluate on the fixture clip, GPU vs CPU: psnr "
          f"{out['cuda']['psnr']:.6f} / {out['cpu']['psnr']:.6f}, ssim "
          f"{out['cuda']['ssim']:.6f} / {out['cpu']['ssim']:.6f} (limit "
          f"{EVAL_GPU_CPU_TOL})")
    if max(diff.values()) > EVAL_GPU_CPU_TOL:
        raise AssertionError(f"evaluate GPU vs CPU: {diff}")

    vids = tmp / "fixture_flow_in" / "clip"
    vids.mkdir(parents=True)
    for i in range(3):
        (vids / f"{i:05d}.png").symlink_to(clip / "frames" / f"{i:05d}.png")
    for dev in ("cuda", "cpu"):
        compute_flow.main([
            "--root", str(vids.parent), "--save_path",
            str(tmp / f"flow_{dev}"), "--height", "128", "--width", "128",
            "--raft_path", str(weights / CHECKPOINTS["raft"]),
            "--device", dev])
    flo_err = 0.0
    for f in sorted((tmp / "flow_cpu" / "clip").glob("*.flo")):
        a, b = (flowread(str(tmp / f"flow_{d}" / "clip" / f.name))
                for d in ("cuda", "cpu"))
        step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(
            np.float16)).astype(np.float32)
        excess = (np.abs(a - b) - step - 1e-3).max()
        flo_err = max(flo_err, float(np.abs(a - b).max()))
        if excess > 0:
            raise AssertionError(f"compute_flow GPU vs CPU: {f.name} beyond "
                                 f"one fp16 step + 1e-3 px by {excess}")
    print(f"  compute_flow GPU vs CPU: max {flo_err:.3e} px (limit one "
          f"fp16 step + 1e-3 px)")

    i3d = load_checkpoint(InceptionI3d(), str(weights / "i3d_rgb_imagenet.pt"),
                          drop_prefixes=("logits.",)).eval()
    g = torch.Generator().manual_seed(5)
    video = torch.rand(1, 16, 112, 112, 3, generator=g) * 2 - 1
    feats = {}
    for dev in ("cuda", "cpu"):
        with torch.inference_mode(), fp32_numerics():
            feats[dev] = i3d.to(dev)(video.to(dev)).cpu()
    scale = feats["cpu"].abs().max().item()
    err = (feats["cuda"] - feats["cpu"]).abs().max().item()
    print(f"  I3D features (1, 16, 112, 112) GPU vs CPU: max {err:.3e} of "
          f"scale {scale:.3e} (limit {EVAL_GPU_CPU_TOL} of it)")
    if err > EVAL_GPU_CPU_TOL * scale:
        raise AssertionError("I3D features GPU vs CPU disagree")
    return dict(evaluate=out, flo_max_px=flo_err, i3d_err=err,
                i3d_scale=scale)


def phase_eval(state: dict, smi: str) -> None:
    """The evaluation path on the card through the four evaluation CLIs'
    main(), with seeded checkpoint files and a synthetic DAVIS-layout
    dataset (`EVAL_VIDEOS`, 432 x 240), under PyTorch's own TF32 flags (the
    CLIs must turn TF32 off themselves):
    `evaluate` at the protocol's defaults with an I3D checkpoint,
    --warp_error and --profile: finite psnr, ssim, ewarp and vfid, the
    trace written, and K1-K4 launched as `_eval_launches` says (K4 at the
    plans' shapes, `K4_EVAL_SHAPE` among them), K5 and K7 never;
    `evaluate_flow_completion` on the same videos with its K1, K2 and K3
    launches; `compute_flow` on 10 frames and `raft_demo` on the fixture
    clip (120 x 216, no padding), their RAFT calls graphed against eager
    (`_raft_pair_graphs`), and I3D's region (`_i3d_graphs`), each with
    its keep or drop held to its owner's default; then
    `_eval_gpu_vs_cpu`."""
    import shutil
    import tempfile

    import numpy as np
    from propainter_tpu_torch.cli import (compute_flow, evaluate,
                                          evaluate_flow_completion, raft_demo)
    from propainter_tpu_torch.core.dataset import TestDataset
    from propainter_tpu_torch.pipeline import PipelineConfig

    root = Path(__file__).resolve().parent
    build = root / "build"
    build.mkdir(exist_ok=True)
    report = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp, \
            _tf32_flags(*state["tf32_defaults"]):
        tmp = Path(tmp)
        ds, weights = tmp / "davis", tmp / "weights"
        t0 = time.perf_counter()
        _write_eval_dataset(ds)
        _write_eval_weights(weights)
        print(f"  dataset {dict(EVAL_VIDEOS)} at 432 x 240 and weights "
              f"written in {time.perf_counter() - t0:.1f} s")
        data = ["--video_root", str(ds / "JPEGImages"), "--mask_root",
                str(ds / "Annotations"), "--json_path", str(ds / "test.json")]

        # expected launches: the protocol's plans on the CPU (masks only)
        plan_pipe = _eval_pipeline()
        items = TestDataset(*data[1::2])
        want = {}
        for i in range(len(items)):
            item = items[i]
            w = _eval_launches(plan_pipe, len(item["frames"]),
                               item["frames"].shape[2],
                               _stage4_plan(plan_pipe, item["masks"]), True)
            for k, v in w.items():
                if k == "k4_shapes":
                    shapes = want.setdefault(k, {})
                    for s, n in v.items():
                        shapes[s] = shapes.get(s, 0) + n
                else:
                    want[k] = want.get(k, 0) + v
        del plan_pipe

        _zero_launches()
        k4: dict = {}
        with _k4_calls(k4):
            t0 = time.perf_counter()
            res = evaluate.main(data + [
                "--weights", str(weights), "--i3d_path",
                str(weights / "i3d_rgb_imagenet.pt"), "--warp_error",
                "--profile", str(tmp / "trace"), "--output",
                str(tmp / "results")])
            seconds = time.perf_counter() - t0
        launches = _read_launches()
        metrics = _metrics_file(tmp / "results" / "davis_rs_10_nl_20"
                                / "davis_metrics.txt")
        traces = list((tmp / "trace").glob("*.json"))
        print(f"  evaluate (2 videos, {sum(n for _, n in EVAL_VIDEOS)} "
              f"frames): {seconds:.3f} s, avg s/frame "
              f"{res['metrics']['avg s/frame']:.4f}; metrics {metrics}; on "
              f"{smi}")
        for v in res["videos"]:
            print(f"  {v['name']}: {v['frames']} frames, {v['seconds']:.3f} "
                  f"s, {v['seconds'] / v['frames']:.4f} s/frame ("
                  + ", ".join(f"{k} {s:.3f} s" for k, s in v["stages"].items())
                  + f") on {smi}")
        bad = [k for k in ("psnr", "ssim", "ewarp", "vfid")
               if not np.isfinite(float(metrics.get(k, "nan")))]
        if bad:
            raise AssertionError(f"metrics missing or not finite: {bad}")
        if not traces or traces[0].stat().st_size == 0:
            raise AssertionError("--profile wrote no trace")
        trace = _trace_summary(traces[0])
        print(f"  profile trace {traces[0].name}: "
              f"{traces[0].stat().st_size / 2 ** 20:.1f} MiB, "
              f"{trace['kernels']} kernels, device busy "
              f"{trace.get('busy_ms', 0):.1f} ms of a "
              f"{trace.get('span_ms', 0):.1f} ms span; cuDNN FFT "
              f"{trace.get('fft_launches')} launches, "
              f"{trace.get('fft_ms', 0):.1f} ms")
        for name, ms, n in trace.get("top", []):
            print(f"    {ms:9.2f} ms x{n:<6d} {name[:100]}")
        print("  cuDNN FFT kernels by the op that launched them:")
        for op, ms, n in trace.get("fft_by_op", []):
            print(f"    {ms:9.2f} ms x{n:<6d} {op}")
        _check_launches("evaluate", launches,
                        {k: v for k, v in want.items() if k != "k4_shapes"})
        _check_k4_calls({"k4_calls": [[*key, n] for key, n in k4.items()]},
                        {"shapes": want["k4_shapes"]}, (K4_EVAL_SHAPE,))
        report["evaluate"] = dict(
            seconds=seconds, metrics=metrics, videos=res["videos"],
            trace=trace,
            launches=launches, k4_calls=[[*key, n] for key, n in
                                         sorted(k4.items())])
        state.setdefault("launches", {})["eval"] = launches

        # the other CLIs on the card
        _zero_launches()
        t0 = time.perf_counter()
        efc = evaluate_flow_completion.main(data + ["--weights", str(weights)])
        launches = _read_launches()
        fc_cfg = PipelineConfig()       # the CLI's: raft_iter 20, chunked
        n_raft = sum(_raft_chunks(fc_cfg, n, 432) for _, n in EVAL_VIDEOS)
        _check_launches("evaluate_flow_completion", launches, dict(
            corr_pyramid_build=n_raft, corr_lookup_moenc=20 * n_raft,
            modulated_deform_conv2d=sum(
                _flow_completion_deforms(n - 1, fc_cfg)
                for _, n in EVAL_VIDEOS),
            corr_lookup=0))
        print(f"  evaluate_flow_completion: avg epe {efc['epe']:.4f}, "
              f"{efc['s_per_frame']:.4f} s/frame "
              f"({time.perf_counter() - t0:.3f} s with set-up) on {smi}")
        report["evaluate_flow_completion"] = efc

        flow_in = tmp / "flow_in" / "video_73"
        flow_in.mkdir(parents=True)
        for f in sorted((ds / "JPEGImages" / "video_73").iterdir())[:10]:
            shutil.copy(f, flow_in)
        failures: list = []
        report["raft_pair"] = _raft_pair_graphs(tmp, weights, root, smi,
                                                failures)
        report["i3d"] = _i3d_graphs(weights, items, smi, failures)
        if failures:
            raise AssertionError("; ".join(failures))

        report["gpu_vs_cpu"] = _eval_gpu_vs_cpu(tmp, weights)
        report["fp32_convs"] = _eval_conv_shapes(weights, items[0]["frames"])
    state["eval"] = report


def _raft_pair_graphs(tmp: Path, weights: Path, root: Path, smi: str,
                      failures: list) -> dict:
    """`compute_flow` (10 frames of 432 x 240 from `tmp/flow_in`: 18 RAFT
    calls at batch 1) and `raft_demo` (the fixture clip, 12 frames of 120
    x 216: 11 calls) through main(), their `raft_pair` region graphed
    against eager, REGION_PAIRS alternating runs each (a new CLI run, so
    each graphed run captures): each run's K1 / K2 launches, its written
    files equal bit for bit to the first eager run's, the region's ms
    over the run (CUDA events around each call, `_RegionTimes`) kept or
    dropped (`_decide`) and held to `RaftPairFlow`'s default
    (`_check_defaults`)."""
    from propainter_tpu_torch.cli import compute_flow, raft_demo

    made = []
    plain = compute_flow.RaftPairFlow

    class Timed(plain):
        regions = ()

        def __init__(self, raft, iters, device, cuda_graphs=None):
            super().__init__(raft, iters, device, cuda_graphs=Timed.regions)
            self.graphs = _RegionTimes(self.graphs)
            made.append(self)

    clis = {
        "compute_flow": (compute_flow.main, [
            "--root", str(tmp / "flow_in"), "--raft_path",
            str(weights / "raft-things.pth"), "--save_path"],
            dict(corr_pyramid_build=18, corr_lookup_moenc=360,
                 corr_lookup=0), ("*/*.flo", 18)),
        "raft_demo": (raft_demo.main, [
            "--path", str(root / "assets" / "demo_clip" / "frames"),
            "--weights", str(weights / "raft-things.pth"), "--save_flo",
            "--output"],
            dict(corr_pyramid_build=11, corr_lookup_moenc=220,
                 corr_lookup=0), ("*_flow.png", 11))}
    report = {}
    compute_flow.RaftPairFlow = Timed
    try:
        for cli, (main, argv, want, (pattern, n_files)) in clis.items():
            runs: dict = {"graphed": [], "eager": []}
            files: dict = {"graphed": [], "eager": []}
            for i in range(REGION_PAIRS):
                order = (("graphed", "eager") if i % 2 == 0
                         else ("eager", "graphed"))
                for side in order:
                    Timed.regions = (compute_flow.RAFT_PAIR_REGIONS
                                     if side == "graphed" else ())
                    out = tmp / f"{cli}_{side}_{i}"
                    _zero_launches()
                    t0 = time.perf_counter()
                    main(argv + [str(out)])
                    wall = 1e3 * (time.perf_counter() - t0)
                    _check_launches(f"{cli} ({side})", _read_launches(), want)
                    if len(list(out.glob(pattern))) != n_files:
                        raise AssertionError(f"{cli} wrote "
                                             f"{len(list(out.glob(pattern)))} "
                                             f"{pattern}, not {n_files}")
                    ms = made[-1].graphs.take()
                    runs[side].append(dict(raft_pair=sum(ms["raft_pair"]),
                                           run=wall))
                    files[side].append({
                        str(f.relative_to(out)): f.read_bytes()
                        for f in sorted(out.rglob("*")) if f.is_file()})
            same = all(f == files["eager"][0]
                       for side in files for f in files[side])
            if not same:
                failures.append(f"{cli}: graphed and eager runs wrote "
                                f"different files")
            decisions = _decide(f"{cli} (its RAFT calls' ms a run)", runs,
                                ("raft_pair",), smi)
            _check_defaults(cli, plain, decisions, failures)
            print(f"  {cli}: {n_files} files a run, equal bit for bit in "
                  f"every run {same}; whole runs (ms, with set-up) graphed "
                  f"{[round(r['run'], 1) for r in runs['graphed']]}, eager "
                  f"{[round(r['run'], 1) for r in runs['eager']]}")
            report[cli] = dict(runs=runs, decisions=decisions,
                               files_equal=same, files=n_files)
    finally:
        compute_flow.RaftPairFlow = plain
    return report


def _i3d_graphs(weights: Path, items, smi: str, failures: list) -> dict:
    """`evaluate.I3DFeatures` on the evaluation's traffic, graphed against
    eager: each video of `items` (the two synthetic 432 x 240 videos) its
    true frames and a stand-in for its inpainted ones (the hole grey),
    `begin_video` before each, a new owner a round, REGION_PAIRS
    alternating rounds: the features bit for bit against the first eager
    round's, the region's ms over the round (CUDA events,
    `_RegionTimes`) kept or dropped (`_decide`) and held to
    `I3DFeatures`' default (`_check_defaults`); capture seconds."""
    import numpy as np
    import torch
    from propainter_tpu_torch.cli.evaluate import I3D_REGIONS, I3DFeatures
    from propainter_tpu_torch.cli.inference import load_checkpoint
    from propainter_tpu_torch.models.i3d import InceptionI3d

    i3d = load_checkpoint(InceptionI3d(), str(weights / "i3d_rgb_imagenet.pt"),
                          drop_prefixes=("logits.",)).cuda().eval()
    videos = []
    for i in range(len(items)):
        frames, masks = items[i]["frames"], items[i]["masks"]
        videos.append((frames, np.where(masks[..., None] > 0, 128,
                                        frames).astype(np.uint8)))
    runs: dict = {"graphed": [], "eager": []}
    feats: dict = {"graphed": [], "eager": []}
    capture = []
    for i in range(REGION_PAIRS):
        order = ("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")
        for side in order:
            owner = I3DFeatures(i3d, torch.device("cuda"), cuda_graphs=(
                I3D_REGIONS if side == "graphed" else ()))
            owner.graphs = _RegionTimes(owner.graphs)
            got = []
            for true, comp in videos:
                owner.begin_video()
                got += [owner(true), owner(comp)]
            runs[side].append(dict(i3d=sum(owner.graphs.take()["i3d"])))
            feats[side].append(got)
            if side == "graphed":
                capture.append(owner.graphs.capture_seconds)
            del owner
    _graph_memory()
    same = all(_same_arrays(f"I3D features, {side} round {i}", got,
                            feats["eager"][0], failures)
               for side in feats for i, got in enumerate(feats[side]))
    decisions = _decide("I3D (its ms over the two videos' four calls)", runs,
                        ("i3d",), smi)
    _check_defaults("I3D", I3DFeatures, decisions, failures)
    print(f"  I3D over {[len(v[0]) for v in videos]} frames: features "
          f"equal bit for bit {same}; capture "
          f"{[round(c, 3) for c in capture]} s a graphed round")
    return dict(runs=runs, decisions=decisions, features_equal=same,
                capture_s=capture)


def _eval_conv_shapes(weights: Path, video) -> dict:
    """The evaluation's fp32 convolution shapes that no other phase runs,
    each profiled for cuDNN FFT kernels (the launch storms `GemmConv2d`
    works around): RAFT at batch 1 (`compute_flow`, one 432 x 240 pair, 20
    iterations) and I3D on `video` (the 104-frame ground truth), in the
    CLIs' numerics."""
    import torch
    from propainter_tpu_torch.cli.inference import load_checkpoint
    from propainter_tpu_torch.device import fp32_numerics
    from propainter_tpu_torch.models.i3d import InceptionI3d
    from propainter_tpu_torch.models.raft import RAFT

    raft = load_checkpoint(RAFT(), str(weights / "raft-things.pth"))
    raft = raft.cuda().eval()
    i3d = load_checkpoint(InceptionI3d(), str(weights / "i3d_rgb_imagenet.pt"),
                          drop_prefixes=("logits.",)).cuda().eval()
    v = torch.from_numpy(video[None]).cuda().float() / 127.5 - 1
    out = {}
    with torch.inference_mode(), fp32_numerics():
        for what, fn in (("RAFT batch 1", lambda: raft(v[:, 0], v[:, 1])),
                         (f"I3D {tuple(v.shape[:4])}", lambda: i3d(v))):
            out[what] = r = _device_kernels(fn)
            print(f"  {what}: device {r['device_ms']:.2f} ms in "
                  f"{r['launches']} launches; cuDNN FFT {r['fft_launches']}"
                  f" launches, {r['fft_ms']:.2f} ms")
        del raft, i3d, v
        out["fuse A/B"] = _prop_fuse_ab()
    return out


def _prop_fuse_ab() -> list:
    """The generator's feature-propagation fuse conv (258 -> 128 channels,
    3 x 3, at 60 x 108) over l_t frames: 11 (the main path's windows), 12,
    13 (its `GemmConv2d.min_batch`) and 21 (the evaluation protocol's), as
    one cuDNN call (TF32 off) and as `GemmConv2d`'s im2col GEMM: device ms
    (CUDA events) and cuDNN's FFT kernels per call."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.models.layers import GemmConv2d

    rows = []
    for n in (11, 12, 13, 21):
        conv = GemmConv2d(258, 128, 3, 1).cuda()
        x = torch.randn(n, 258, 60, 108, device="cuda")

        def cudnn():
            return F.conv2d(x, conv.weight, conv.bias, padding=1)

        err = (conv.gemm(x) - cudnn()).abs().max().item()
        r = dict(frames=n, gemm_ms=_time_ms(lambda: conv.gemm(x), 5),
                 cudnn_ms=_time_ms(cudnn, 5), max_abs_diff=err,
                 cudnn_fft_launches=_device_kernels(cudnn)["fft_launches"])
        rows.append(r)
        print(f"  propagation fuse conv over {n} frames: GEMM "
              f"{r['gemm_ms']:.3f} ms, cuDNN {r['cudnn_ms']:.3f} ms "
              f"({r['cudnn_fft_launches']} FFT kernels a call); max diff "
              f"{err:.2e}")
        del conv, x
    torch.cuda.empty_cache()
    return rows


def phase_cli(state: dict, out_dir) -> None:
    """The port's CLI as a user runs it on the GPU: `main()` on the
    fixture clip (12 frames of 120 x 216) with --weights random --bf16
    --save_frames; both videos and 12 frames of 120 x 216 must appear. The
    CLI's video I/O needs cv2 (imageio optional)."""
    import tempfile

    import cv2
    from propainter_tpu_torch.cli.inference import main as cli_main

    root = Path(__file__).resolve().parent
    clip = root / "assets" / "demo_clip"
    base = Path(out_dir) if out_dir else root / "build"
    base.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=base) as tmp:
        t0 = time.perf_counter()
        cli_main(["--video", str(clip / "frames"), "--mask",
                  str(clip / "masks"), "--output", tmp, "--weights",
                  "random", "--bf16", "--save_frames"])
        seconds = time.perf_counter() - t0
        root = Path(tmp) / "frames"
        pngs = sorted((root / "frames").glob("*.png"))
        shapes = {cv2.imread(str(p)).shape for p in pngs}
        videos = [(root / n).exists() for n in ("masked_in.mp4",
                                                "inpaint_out.mp4")]
    print(f"  cli --bf16 on the fixture clip: {seconds:.3f} s, "
          f"{len(pngs)} frames of {shapes}, videos {videos}")
    state["cli"] = dict(seconds=seconds, frames=len(pngs))
    if len(pngs) != 12 or shapes != {(120, 216, 3)} or not all(videos):
        raise AssertionError("the CLI's outputs are missing or misshapen")


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

# the JAX package's train configurations, which the phase and the CLI run
TRAIN_CONFIGS = {"flowcomp": "configs/train_flowcomp.json",
                 "propainter": "configs/train_propainter.json"}
TRAIN_SEEDS = {"raft": 61, "flowcomp": 62, "trainee": 63, "dis": 64}
# full-width train steps of each stage, graphed against eager
# (`_train_full_width`): a first sight and a capture, then TRAIN_GRAPH_PAIRS
# alternating pairs; a learning-rate milestone at the fourth update, so the
# last two replays run at the scaled rate; each step from one state,
# graphed and eager losses within TRAIN_GRAPH_LOSS_TOL relative and the
# parameters within TRAIN_GRAPH_PARAM_TOL of each tensor's scale where the
# gradient is sure (`_compare_steps`); the gradients are reported: the
# backward's atomics move a single-element sum (the discriminator's last
# bias) by up to 1.6e-5 of it between two runs
TRAIN_GRAPH_PAIRS = 3
TRAIN_STEPS = 2 + TRAIN_GRAPH_PAIRS
TRAIN_GRAPH_MILESTONES = {3: 0.1}
TRAIN_GRAPH_LOSS_TOL, TRAIN_GRAPH_PARAM_TOL = 1e-5, 1e-5
# GPU (kernels) against CPU (plain versions), one fp32 step each: losses
# relative, gradients of each tensor's largest magnitude (or 1e-4 of the
# model's largest, where a gradient that is 0 in exact arithmetic is
# rounding noise)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# the synthetic YouTube-VOS-layout videos the CLI and the steps read
TRAIN_VIDEOS = (("train_a", 24), ("train_b", 20))
# the overfit: steps, and the local frames of its 4-frame clip
OVERFIT_STEPS, OVERFIT_L_T = 40, 3


def _train_launches(stage: str, l_t: int = 10, raft_iters: int = 20) -> dict:
    """One train step's launches: RAFT's pyramid (K2) once and its lookup
    (K1) once per iteration on the l_t local frames' 2 (l_t - 1)
    pair-directions; K3 in each deform align of the trainee's recurrent
    propagation (both directions, every step but the first) twice, the
    forward and its recompute in the backward pass under remat (the
    plain backward launches nothing), and in the ProPainter stage once
    more in the frozen flow completion's; K4, K5 and K7 never (training's
    attention is 'xla')."""
    flow_deforms = 2 * (l_t - 2)      # l_t - 1 flows, both directions
    k3 = (2 * flow_deforms if stage == "flowcomp"
          else flow_deforms + 2 * 2 * (l_t - 1))
    return dict(corr_pyramid_build=1, corr_lookup_moenc=raft_iters,
                modulated_deform_conv2d=k3, flash_window_attention=0,
                sparse_window_attention=0, corr_lookup=0)


def _write_train_dataset(root: Path, videos=TRAIN_VIDEOS, H=240, W=432):
    """A YouTube-VOS-layout training set of `_synthetic_clip` videos:
    videos/<v>/%05d.jpg and datasets/youtube-vos/train.json ({video:
    frames}), the CLI's layout (run from root)."""
    import cv2

    names = {}
    for i, (name, T) in enumerate(videos):
        frames, _ = _synthetic_clip(T, H, W, seed=30 + i)
        (root / "videos" / name).mkdir(parents=True)
        for t in range(T):
            cv2.imwrite(str(root / "videos" / name / f"{t:05d}.jpg"),
                        cv2.cvtColor(frames[t], cv2.COLOR_RGB2BGR))
        names[name] = T
    (root / "datasets" / "youtube-vos").mkdir(parents=True)
    (root / "datasets" / "youtube-vos" / "train.json").write_text(
        json.dumps(names))


def _train_config(stage: str, root: Path, weights: Path) -> Path:
    """configs/train_<stage>.json with what one card and this run need:
    the batch per card (the reference's 8 over 8 GPUs: 1), the synthetic
    video root, the seeded checkpoints, a log line a step and a
    checkpoint every 2 steps, 2 loader workers. Written to
    root/train_<stage>.json; the CLI's run directory is then
    experiments_model/<net>_train_<stage>."""
    src = Path(__file__).resolve().parent / TRAIN_CONFIGS[stage]
    config = json.loads(src.read_text())
    config["train_data_loader"]["video_root"] = str(root / "videos")
    config["model"]["raft_path"] = str(weights / "raft-things.pth")
    if stage == "propainter":
        config["model"]["flowcomp_path"] = str(
            weights / "recurrent_flow_completion.pth")
    config["trainer"].update(batch_size=1, num_workers=2, log_freq=1,
                             save_freq=2)
    path = root / f"train_{stage}.json"
    path.write_text(json.dumps(config, indent=1))
    return path


def _metrics_jsonl(path: Path) -> list:
    """The rows of a training run's logs/metrics.jsonl."""
    return [json.loads(line) for line in path.read_text().splitlines()]


def _train_modules(stage: str, device, gen=None):
    """The stage's seeded models (fan-in scaled) on `device`: RAFT, the
    frozen flow completion (ProPainter stage), the trainee with remat
    (`gen` for the default generator) and the discriminator."""
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    def seeded(module, name):
        return seeded_init_(module, TRAIN_SEEDS[name], fan_in_scaled=True)

    mods = dict(raft=seeded(RAFT(), "raft"))
    if stage == "flowcomp":
        mods["trainee"] = seeded(RecurrentFlowCompleteNet(remat=True),
                                 "trainee")
    else:
        from propainter_tpu_torch.models.discriminator import Discriminator

        mods["flowcomp"] = seeded(RecurrentFlowCompleteNet(), "flowcomp")
        mods["trainee"] = seeded(gen or InpaintGenerator(remat=True),
                                 "trainee")
        mods["dis"] = seeded(Discriminator(), "dis")
    return {k: v.to(device) for k, v in mods.items()}


def _train_state(stage: str, mods: dict, device, raft_iters: int = 20,
                 cuda_graphs=None, **config):
    """(state, step function) of the stage from `mods` (flows precomputed
    without a 'raft'; the step's regions graphed as `cuda_graphs` says,
    None for the step maker's default); config overrides the train config
    (the defaults are the JAX package's)."""
    from propainter_tpu_torch.core import trainer as TT

    flows = dict(raft_iters=raft_iters,
                 use_precomputed_flows=mods.get("raft") is None)
    if cuda_graphs is not None:
        flows["cuda_graphs"] = cuda_graphs
    if stage == "flowcomp":
        cfg = TT.FlowTrainConfig(**config)
        return (TT.init_flow_state(cfg, mods.get("raft"), mods["trainee"],
                                   device=device),
                TT.make_flow_train_step(cfg, **flows))
    cfg = TT.PropainterTrainConfig(**config)
    return (TT.init_propainter_state(cfg, mods.get("raft"), mods["flowcomp"],
                                     mods["trainee"], mods.get("dis"),
                                     device=device),
            TT.make_propainter_train_step(cfg, **flows))


@contextlib.contextmanager
def _fwd_bwd_events(module):
    """CUDA events around each forward of `module` and each backward()
    while active: {'fwd': [(start, end)], 'bwd': [(start, end)]}."""
    import torch

    marks = {"fwd": [], "bwd": []}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    pre = module.register_forward_pre_hook(
        lambda *_: marks["fwd"].append([event()]))
    post = module.register_forward_hook(
        lambda *_: marks["fwd"][-1].append(event()))
    backward = torch.Tensor.backward

    def timed_backward(self, *args, **kwargs):
        start = event()
        backward(self, *args, **kwargs)
        marks["bwd"].append([start, event()])

    torch.Tensor.backward = timed_backward
    try:
        yield marks
    finally:
        torch.Tensor.backward = backward
        pre.remove()
        post.remove()


def _full_width_batch(stage: str, root: Path) -> tuple:
    """(item 0 of the synthetic train set as a batch of 1 on the card, the
    stage's data config)."""
    import random

    import numpy as np
    import torch
    from propainter_tpu_torch.core.dataset import (TrainDataset,
                                                   TrainDatasetConfig)

    config = json.loads((Path(__file__).resolve().parent
                         / TRAIN_CONFIGS[stage]).read_text())
    data = config["train_data_loader"]
    ds = TrainDataset(TrainDatasetConfig(
        video_root=str(root / "videos"),
        json_path=str(root / "datasets" / "youtube-vos" / "train.json"),
        num_local_frames=data["num_local_frames"],
        num_ref_frames=data["num_ref_frames"], w=data["w"], h=data["h"]))
    random.seed(0)
    np.random.seed(0)
    return ({k: torch.from_numpy(v[None]).cuda() for k, v in ds[0].items()},
            data)


def _trained_tensors(stage: str, mods: dict) -> dict:
    """The trained models' parameters by name."""
    return {f"{n}.{k}": p for n in ("trainee", "dis") if n in mods
            for k, p in mods[n].named_parameters()}


def _copy_train_state_(dst, src) -> None:
    """`src`'s trained models (parameters and buffers) and optimizers'
    states and rates into `dst`'s tensors, in place: a graph of `dst`'s
    step reads them by address."""
    import torch

    pairs = ([(dst.model, src.model, dst.opt, src.opt)] if hasattr(dst, "opt")
             else [(dst.gen, src.gen, dst.gen_opt, src.gen_opt)]
             + ([(dst.dis, src.dis, dst.dis_opt, src.dis_opt)]
                if dst.dis is not None else []))
    with torch.no_grad():
        for m_d, m_s, o_d, o_s in pairs:
            for t_d, t_s in zip(m_d.state_dict().values(),
                                m_s.state_dict().values()):
                t_d.copy_(t_s)
            o_d.param_groups[0]["lr"].copy_(o_s.param_groups[0]["lr"])
            for p_d, p_s in zip(m_d.parameters(), m_s.parameters()):
                for k, v in o_s.state[p_s].items():
                    o_d.state[p_d][k].copy_(v)


def _step_result(stage: str, mods: dict, metrics: dict) -> dict:
    """A step's result as `_compare_steps` reads it: its metrics, each
    trained model's gradients and parameters on the CPU."""
    trained = _dist_trained(stage, mods)
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: {k: p.grad.detach().to("cpu", copy=True)
                   for k, p in m.named_parameters() if p.grad is not None}
               for n, m in trained.items()},
        params={n: {k: p.detach().to("cpu", copy=True)
                    for k, p in m.named_parameters()}
                for n, m in trained.items()})


def _train_full_width(stage: str, root: Path, smi: str,
                      failures: list) -> dict:
    """TRAIN_STEPS steps of the stage at its config's full width and
    shapes on the card (batch 1 per card, 432 x 240, l_t 10 with 1 or 6
    reference frames, RAFT run with 20 iterations, the discriminator on
    with hinge), both regions graphed against eager on two states from
    one seeded state dict, in turns: the first sight and the capture,
    then TRAIN_GRAPH_PAIRS alternating pairs (graphed first in even
    ones), the eager side's state copied into the graphed side's tensors
    before each step; a milestone at the fourth update
    (TRAIN_GRAPH_MILESTONES). Each step's losses graphed against eager,
    each step's learning rate against the schedule, the last step's
    gradients and parameters as phase dist compares two runs of a step
    (`_compare_steps`; bit for bit printed); each region's ms (CUDA
    events around its calls) and the step's seconds, kept or dropped by
    the rule (`_decide`, `_check_defaults`); capture seconds
    and the graphs' GiB against the eager peak; the eager side's trainee
    forward and backward by CUDA events and its launches, a replayed
    step's launch counts and its kernels in a profiler trace against
    `_train_launches`; the flow stage's hysteresis rounds."""
    import contextlib
    import copy

    import torch
    from propainter_tpu_torch.core import trainer as TT
    from propainter_tpu_torch.graphs import StageGraphs

    batch, data = _full_width_batch(stage, root)
    l_t = data["num_local_frames"]
    mods = _train_modules(stage, "cuda")
    sides, times = {}, {}
    for side, regions in (("graphed", TT.TRAIN_REGIONS), ("eager", ())):
        m = copy.deepcopy(mods)
        st, step = _train_state(stage, m, "cuda", num_local_frames=l_t,
                                milestones=TRAIN_GRAPH_MILESTONES,
                                cuda_graphs=regions)
        step.graphs = times[side] = _RegionTimes(StageGraphs(
            regions, TT.TRAIN_REGIONS, "cuda", flush=True))
        sides[side] = (st, step, m)
    del mods
    opt_of = (lambda st: st.opt) if stage == "flowcomp" else (
        lambda st: st.gen_opt)
    schedule = TT.multistep_lr(TT.FlowTrainConfig.lr if stage == "flowcomp"
                               else TT.PropainterTrainConfig.lr,
                               TRAIN_GRAPH_MILESTONES)
    runs = {"graphed": [], "eager": []}
    metrics = {"graphed": [], "eager": []}
    fwd, bwd, rounds, lr_bad = [], [], [], []
    gib = {}
    for i in range(TRAIN_STEPS):
        order = ("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")
        # both sides step from one state: Adam at beta1 0 moves a weight by
        # ~lr whatever its gradient's size, so a gradient within rounding
        # of 0 (the backward's atomics) takes either sign, and free-running
        # states part by ~1e-4 of scale in a few steps
        _copy_train_state_(sides["graphed"][0], sides["eager"][0])
        for side in order:
            st, step, m = sides[side]
            if side == "eager" and i == 0:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            if side == "eager" and i == TRAIN_STEPS - 1:
                _zero_launches()
            hooks = (_fwd_bwd_events(m["trainee"]) if side == "eager"
                     else contextlib.nullcontext({"fwd": [], "bwd": []}))
            with hooks as marks:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, mt, _ = step(st, batch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if side == "eager":
                if i == 0:
                    gib["eager_peak"] = (torch.cuda.max_memory_allocated()
                                         / 2 ** 30)
                if i == TRAIN_STEPS - 1:
                    eager_launches = _read_launches()
                fwd.append(sum(a.elapsed_time(b) for a, b in marks["fwd"]))
                bwd.append([a.elapsed_time(b) for a, b in marks["bwd"]])
            elif stage == "flowcomp":
                rounds.append(list(step.hysteresis_rounds))
            row = {r: sum(v) for r, v in times[side].take().items()}
            row["step"] = 1e3 * wall
            runs[side].append(row)
            metrics[side].append({k: float(v) for k, v in mt.items()})
            lr = float(opt_of(st).param_groups[0]["lr"])
            if abs(lr - schedule(i + 1)) > 1e-6 * schedule(i + 1):
                lr_bad.append((side, i, lr, schedule(i + 1)))
        if i == 0:
            gib["before_capture"] = _graph_memory()
        elif i == 1:
            gib["graphs"] = _graph_memory() - gib["before_capture"]
    graphed_step = sides["graphed"][1]
    capture_s = graphed_step.graphs.capture_seconds
    counts = graphed_step.graphs.counts()
    loss_err = max(abs(g[k] - e[k]) / max(abs(e[k]), 1e-12)
                   for g, e in zip(metrics["graphed"], metrics["eager"])
                   for k in e)
    # the last step's gradients and parameters, compared as phase dist
    # compares two runs of a step
    err = _compare_steps(*(_step_result(stage, sides[side][2],
                                        metrics[side][-1])
                           for side in ("graphed", "eager")))
    param_err = max(v for k, v in err.items() if k.endswith("param"))
    grad_err = max(v for k, v in err.items() if k.endswith("grad"))
    exact = all(torch.equal(p, q) for p, q in zip(
        _trained_tensors(stage, sides["graphed"][2]).values(),
        _trained_tensors(stage, sides["eager"][2]).values()))
    # a replayed step's launches: by the counters, and in a trace
    _zero_launches()
    with _device_trace() as prof:
        graphed_step(sides["graphed"][0], batch)
    replay_launches = _read_launches()
    trace = {k: sum(n for name, _, n in _trace_rows(prof)
                    if re.search(rf"\b{sym}\b", name))
             for k, sym in TRACE_KERNELS.items()}
    want = _train_launches(stage, l_t)
    T = l_t + data["num_ref_frames"]
    eager_s = [r["step"] / 1e3 for r in runs["eager"]]
    steady = _spread(eager_s[1:])
    print(f"  {stage} step (B 1, T {T}, {data['w']} x {data['h']}, "
          f"raft_iters 20), eager: {steady['median']:.3f} s median "
          f"({steady['min']:.3f}-{steady['max']:.3f}) of {TRAIN_STEPS - 1} "
          f"after a first of {eager_s[0]:.3f} s; trainee forward "
          f"{statistics.median(fwd[1:]):.1f} ms, backward "
          + " + ".join(f"{statistics.median(b[j] for b in bwd[1:]):.1f}"
                       for j in range(len(bwd[-1])))
          + f" ms; peak {gib['eager_peak']:.2f} GiB; on {smi}")
    print(f"  {stage} graphed against eager over {TRAIN_STEPS} steps, "
          f"each from one state: losses within {loss_err:.2e} relative "
          f"(limit {TRAIN_GRAPH_LOSS_TOL}); the last step's gradients "
          f"{grad_err[0]:.2e} of scale ({grad_err[1]}; reported: the "
          f"backward's atomics), parameters "
          f"{param_err[0]:.2e} of scale where the gradient is sure "
          f"({param_err[1]}; limit {TRAIN_GRAPH_PARAM_TOL}), bit for bit "
          f"{exact}; the learning rate the schedule's at every step "
          f"{not lr_bad} (milestone {TRAIN_GRAPH_MILESTONES}, steps 4-5 "
          f"replayed at it); graphs {counts}, capture {capture_s:.3f} s, "
          f"the graphs' pool {gib['graphs']:.2f} GiB against the eager "
          f"peak {gib['eager_peak']:.2f} GiB allocated")
    if stage == "flowcomp":
        print(f"  flowcomp hysteresis rounds (forward, backward) a step: "
              f"{rounds}")
    print(f"  {stage} losses by step (eager): "
          + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in mt.items())
                      for mt in metrics["eager"]))
    print(f"  {stage} replayed step: launch counts "
          f"{ {k: replay_launches[k] for k in want} }, in the trace "
          f"{ {k: trace[k] for k in want if k in trace} }; want {want}")
    pairs = {side: r[2:] for side, r in runs.items()}
    decisions = _decide(f"{stage} train step", pairs,
                        ("targets", "update", "step"), smi)
    _check_defaults(f"{stage} train step",
                    TT.make_flow_train_step if stage == "flowcomp"
                    else TT.make_propainter_train_step,
                    {k: v for k, v in decisions.items() if k != "step"},
                    failures)
    bad = [k for mt in metrics["eager"] + metrics["graphed"]
           for k, v in mt.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{stage}: losses not finite: {bad}")
    _check_launches(f"{stage} train step (eager)", eager_launches, want)
    _check_launches(f"{stage} train step (replayed)", replay_launches, want)
    if any(trace[k] != v for k, v in want.items() if k in trace):
        raise AssertionError(f"{stage}: the replayed step's trace {trace} "
                             f"differs from {want}")
    if (loss_err > TRAIN_GRAPH_LOSS_TOL
            or param_err[0] > TRAIN_GRAPH_PARAM_TOL or lr_bad):
        raise AssertionError(f"{stage}: graphed and eager steps disagree: "
                             f"losses {loss_err}, the last step {err}, "
                             f"learning rates {lr_bad}")
    del sides, graphed_step, times
    _graph_memory()
    return dict(seconds=eager_s, step_s=steady, forward_ms=fwd,
                backward_ms=bwd, peak_bytes=gib["eager_peak"] * 2 ** 30,
                launches=eager_launches, replay_launches=replay_launches,
                trace=trace, metrics=metrics["eager"],
                graphed_metrics=metrics["graphed"], frames=T,
                loss_rel=loss_err,
                last_step={k: v if k == "loss" else v[0]
                           for k, v in err.items()}, bit_exact=exact,
                pairs=runs, decisions=decisions, graphs=counts,
                capture_s=capture_s, graphs_gib=gib["graphs"],
                hysteresis_rounds=rounds)


def _plain_k3_backward_ms() -> dict:
    """The K3 dispatcher's backward (`_DeformConv.backward`: the plain
    version recomputed and differentiated on the card) at both sites'
    training shapes, by CUDA events: the generator's propagation x (1,
    60, 108, 128), the flow completion's (2, 30, 54, 256), dg 16."""
    import torch
    from propainter_tpu_torch.ops import deform

    g = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    out = {}
    for site, (B, H, W, C) in (("generator", (1, 60, 108, 128)),
                               ("flow_completion", (2, 30, 54, 256))):
        inputs = _deform_inputs(randn, B, H, W, C, 16, 3.0)
        grad = randn(B, H, W, 128)

        def backward():
            leaves = [t.detach().requires_grad_() for t in inputs]
            y = deform._modulated_deform_conv2d_plain(*leaves)
            torch.autograd.grad(y, leaves, grad)

        out[site] = _time_ms(backward, 10)
        print(f"  plain K3 backward at the {site}'s x {(B, H, W, C)}: "
              f"{out[site]:.3f} ms a call")
    return out


def _grad_tree(module) -> dict:
    return {k: p.grad.detach().cpu() for k, p in module.named_parameters()
            if p.grad is not None}


def _train_gpu_vs_cpu() -> dict:
    """One step of each stage on the GPU (kernels) and on the CPU (plain
    versions) from the same seeded weights and batch, both in fp32: a
    reduced generator (hidden 128, depth 2) at 32 x 48, B 1, T 4, l_t 3,
    and the flow completion on 2 x 3 flows at 32 x 48, precomputed flows
    (RAFT's GPU-vs-CPU check is the small phase's): losses within
    TRAIN_LOSS_TOL relative, every trainee and discriminator gradient
    within TRAIN_GRAD_TOL of its tensor's scale."""
    import copy

    import torch
    from propainter_tpu_torch.models.propainter import InpaintGenerator

    g = torch.Generator().manual_seed(7)
    H, W = 32, 48
    frames = torch.nn.functional.interpolate(
        torch.rand(4, 3, 4, 6, generator=g) * 1.6 - 0.8, size=(H, W),
        mode="bilinear").permute(0, 2, 3, 1)[None]
    masks = torch.zeros(1, 4, H, W, 1)
    masks[:, :, 8:20, 10:30] = 1.0
    flows = torch.zeros(2, 3, H, W, 2)
    flows[..., 0] = 0.5
    flows[:, :, 6:22, 12:34] = torch.tensor([3.0, -2.0])
    flows += torch.randn(flows.shape, generator=g) * 0.05
    batches = {
        "propainter": dict(frames=frames, masks=masks,
                           flows_f=torch.randn(1, 2, H, W, 2, generator=g),
                           flows_b=torch.randn(1, 2, H, W, 2, generator=g)),
        "flowcomp": dict(frames=torch.cat([frames, frames]),
                         masks=torch.cat([masks, masks]), flows_f=flows,
                         flows_b=-flows.flip(1))}
    report = {}
    for stage, batch in batches.items():
        mods = _train_modules(stage, "cpu", gen=InpaintGenerator(
            hidden=128, depths=2, remat=True))
        mods.pop("raft")
        l_t = 4 if stage == "flowcomp" else 3
        results = {}
        for dev in ("cuda", "cpu"):
            m = {k: copy.deepcopy(v).to(dev) for k, v in mods.items()}
            state, step = _train_state(stage, m, dev, num_local_frames=l_t)
            _, metrics, _ = step(state, {k: v.to(dev)
                                         for k, v in batch.items()})
            results[dev] = ({k: float(v) for k, v in metrics.items()},
                            {name: _grad_tree(m[name])
                             for name in ("trainee", "dis") if name in m})
        loss_err = max(abs(results["cuda"][0][k] - v) / max(abs(v), 1e-12)
                       for k, v in results["cpu"][0].items())
        grad_err = {}
        for name, want in results["cpu"][1].items():
            got = results["cuda"][1][name]
            floor = 1e-4 * max(t.abs().max().item() for t in want.values())
            grad_err[name] = max(
                ((got[k] - w).abs().max().item()
                 / max(w.abs().max().item(), floor), k)
                for k, w in want.items())
        print(f"  {stage} step GPU vs CPU: losses within {loss_err:.2e} "
              f"relative (limit {TRAIN_LOSS_TOL}); gradients within "
              + ", ".join(f"{n} {e:.2e} of scale ({k})"
                          for n, (e, k) in grad_err.items())
              + f" (limit {TRAIN_GRAD_TOL})")
        report[stage] = dict(
            loss_rel=loss_err, grad_rel={n: e for n, (e, _) in
                                         grad_err.items()},
            metrics={dev: r[0] for dev, r in results.items()})
        if loss_err > TRAIN_LOSS_TOL or any(
                e > TRAIN_GRAD_TOL for e, _ in grad_err.values()):
            raise AssertionError(f"{stage} step GPU vs CPU disagree")
    return report


def _flax_like_init_(module, seed: int):
    """In place, flax's default initialisers' variances, which the JAX
    test's generator has: weights of rank >= 2 ~ N(0, 1 / fan_in) (lecun
    normal's variance, untruncated), LayerNorm scales 1, biases 0."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                p.copy_(torch.randn(p.shape, generator=g)
                        / math.sqrt(p[0].numel()))
            elif ".norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return module


def _overfit_setup(device) -> tuple[dict, dict]:
    """The overfit's batch (smooth frames, 20% holes, precomputed flows;
    B 1, T 4, l_t 3, 32 x 48) and models (the frozen flow completion,
    the full-width generator with remat) on `device`."""
    import torch
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.weights import seeded_init_

    g = torch.Generator().manual_seed(1)
    B, T, l_t, H, W = 1, 4, OVERFIT_L_T, 32, 48
    small = torch.rand(B * T, 3, 4, 6, generator=g) * 1.6 - 0.8
    frames = torch.nn.functional.interpolate(
        small, size=(H, W), mode="bilinear").permute(0, 2, 3, 1)
    batch = {"frames": frames.reshape(B, T, H, W, 3),
             "masks": (torch.rand(B, T, H, W, 1, generator=g) > 0.8).float(),
             "flows_f": 0.5 * torch.randn(B, l_t - 1, H, W, 2, generator=g),
             "flows_b": 0.5 * torch.randn(B, l_t - 1, H, W, 2, generator=g)}
    mods = dict(flowcomp=seeded_init_(RecurrentFlowCompleteNet(),
                                      TRAIN_SEEDS["flowcomp"],
                                      fan_in_scaled=True),
                trainee=_flax_like_init_(InpaintGenerator(remat=True),
                                         TRAIN_SEEDS["trainee"]))
    return ({k: v.to(device) for k, v in batch.items()},
            {k: v.to(device) for k, v in mods.items()})


def _overfit_losses(batch: dict, mods: dict, device, **config) -> list:
    """gen_loss of each of the overfit's steps (the ProPainter step
    without the discriminator; config overrides the train config)."""
    state, step = _train_state("propainter", mods, device,
                               num_local_frames=OVERFIT_L_T,
                               use_discriminator=False, **config)
    return [float(step(state, batch)[1]["gen_loss"])
            for _ in range(OVERFIT_STEPS)]


def _train_overfit() -> dict:
    """The 40-step overfit of the JAX package's train test
    (tests/test_train_parity.py:289) on the card: the full-width
    generator (remat, `_flax_like_init_`) without the discriminator, one
    batch of smooth frames at 32 x 48 (B 1, T 4, l_t 3) with precomputed
    flows; the mean of the last 5 gen_loss values below half the first
    5's. The learning rate is the train config's, 1e-4: at the JAX
    test's 3e-4 Adam (beta1 0) moves every weight by about lr a step and
    the loss swings by +-40% for the first 25 steps, so whether 40 steps
    halve it is chance, for the JAX step as for the port's
    (tests/overfit_spread.py measures the ratio's spread over runs
    whose weights differ by 1e-6)."""
    batch, mods = _overfit_setup("cuda")
    t0 = time.perf_counter()
    losses = _overfit_losses(batch, mods, "cuda")
    seconds = time.perf_counter() - t0
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    from propainter_tpu_torch.core import trainer as TT

    print(f"  40-step overfit (full-width generator, 32 x 48; regions "
          f"graphed by default, {TT.TRAIN_REGIONS}): gen_loss "
          f"{first:.4f} -> {last:.4f} (first / last 5 means) in "
          f"{seconds:.1f} s")
    if not all(map(math.isfinite, losses)) or last >= 0.5 * first:
        raise AssertionError(f"the overfit did not halve the loss: {losses}")
    return dict(losses=losses, seconds=seconds)


def _train_cli(root: Path, weights: Path, smi: str) -> dict:
    """`python -m propainter_tpu_torch.cli.train -c <derived config>
    --max_iters 2` for each stage (`main()` in this process, from root):
    train.log, a metrics.jsonl line a step and the step-2 checkpoint in
    the reference's gen/dis/opt layout; then --max_iters 3 resumes at
    step 2 and writes step 3."""
    import os

    from propainter_tpu_torch.cli import train

    report = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for stage in ("flowcomp", "propainter"):
            cfg = str(_train_config(stage, root, weights))
            t0 = time.perf_counter()
            first = train.main(["-c", cfg, "--max_iters", "2"])
            t1 = time.perf_counter()
            resumed = train.main(["-c", cfg, "--max_iters", "3"])
            t2 = time.perf_counter()
            run = root / first["save_dir"]
            rows = _metrics_jsonl(run / "logs" / "metrics.jsonl")
            files = sorted(p.name for p in (run / "ckpt").iterdir())
            print(f"  cli {stage}: 2 steps in {t1 - t0:.1f} s with set-up, "
                  f"resumed at {resumed['start']} for 1 in {t2 - t1:.1f} "
                  f"s; metrics steps {[r['step'] for r in rows]}; "
                  f"checkpoints {files}; on {smi}")
            kinds = ("gen", "opt") + (("dis",) if stage == "propainter"
                                      else ())
            want = {f"{k}_{n:06d}.pth" for k in kinds for n in (2,)}
            if (resumed["start"] != 2 or [r["step"] for r in rows]
                    != [1, 2, 3] or not want <= set(files)
                    or not (run / "train.log").stat().st_size):
                raise AssertionError(f"cli {stage}: logs, checkpoint or "
                                     f"resume missing")
            report[stage] = dict(seconds=[t1 - t0, t2 - t1], rows=rows,
                                 files=files)
    finally:
        os.chdir(cwd)
    return report


def phase_train(state: dict, smi: str) -> None:
    """Training on the card: `_train_full_width` for both stages at the
    JAX configs' full widths, graphed against eager (K1, K2 and K3
    launched as `_train_launches` says, eager and replayed, K4, K5 and K7
    never), the plain K3 backward's time (`_plain_k3_backward_ms`),
    `_train_gpu_vs_cpu`, `_train_overfit`, and the CLI (`_train_cli`) on a
    synthetic YouTube-VOS-layout set (`TRAIN_VIDEOS` at 432 x 240)
    written under build/ with seeded checkpoints; the overfit and the
    CLI at the steps' default regions. Fails when a region graphed by
    default fails the keep-or-drop rule."""
    import tempfile

    import torch
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    report = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root, weights = Path(tmp), Path(tmp) / "weights"
        weights.mkdir()
        _write_train_dataset(root)
        raft = seeded_init_(RAFT(), TRAIN_SEEDS["raft"], fan_in_scaled=True)
        torch.save({f"module.{k}": v for k, v in raft.state_dict().items()},
                   weights / "raft-things.pth")
        torch.save(seeded_init_(RecurrentFlowCompleteNet(),
                                TRAIN_SEEDS["flowcomp"],
                                fan_in_scaled=True).state_dict(),
                   weights / "recurrent_flow_completion.pth")
        failures: list = []
        for stage in ("flowcomp", "propainter"):
            report[stage] = _train_full_width(stage, root, smi, failures)
            state.setdefault("launches", {})[f"train_{stage}"] = (
                report[stage]["launches"])
        report["plain_k3_backward_ms"] = _plain_k3_backward_ms()
        report["gpu_vs_cpu"] = _train_gpu_vs_cpu()
        report["overfit"] = _train_overfit()
        report["cli"] = _train_cli(root, weights, smi)
    state["train"] = report
    if failures:
        raise AssertionError("; ".join(failures))


# data-parallel training (`phase_dist`): one NCCL rank against the plain
# one-process step (losses relative, parameters of scale; its gradients
# within DIST_GRAD_TOL of scale, beside a second plain step's: the
# backward's atomics move them by ~1e-6 of scale from run to run); two
# gloo ranks against the one-process step on their batch of 2 (the
# training tests' tolerances: losses relative, parameters of scale where
# their gradient is at least 1e-4 of its tensor's largest and 1e-5, 1000
# x Adam's eps: below either, Adam's first update lr g / (|g| + eps)
# turns on the gradient's rounding)
DIST_ONE_RANK_TOL, DIST_GRAD_TOL = 1e-6, 1e-5
DIST_LOSS_TOL, DIST_PARAM_TOL = 1e-5, 1e-4
DIST_STEPS = 2
# the two samples' holes (y, x, h, w) at 432 x 240: 2.3% and 40.5% of the
# frame, so a normaliser taken per rank would differ from the batch's
DIST_HOLES = ((100, 180, 40, 60), (45, 70, 150, 280))


def _dist_batch(stage: str, root: Path) -> dict:
    """The global batch of 2 at the stage's full width: items 0 and 1 of
    the synthetic train set (`_write_train_dataset`), their masks
    replaced by the `DIST_HOLES` rectangles on every frame; CPU
    tensors."""
    import random

    import numpy as np
    import torch
    from propainter_tpu_torch.core.dataset import (TrainDataset,
                                                   TrainDatasetConfig)

    data = json.loads((Path(__file__).resolve().parent
                       / TRAIN_CONFIGS[stage]).read_text())["train_data_loader"]
    ds = TrainDataset(TrainDatasetConfig(
        video_root=str(root / "videos"),
        json_path=str(root / "datasets" / "youtube-vos" / "train.json"),
        num_local_frames=data["num_local_frames"],
        num_ref_frames=data["num_ref_frames"], w=data["w"], h=data["h"]))
    random.seed(0)
    np.random.seed(0)
    items = [ds[i] for i in range(2)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in items[0]}
    batch["masks"].zero_()
    for i, (y, x, h, w) in enumerate(DIST_HOLES):
        batch["masks"][i, :, y:y + h, x:x + w] = 1
    return batch


def _dist_trained(stage: str, mods: dict) -> dict:
    return {n: mods[n] for n in ("trainee", "dis") if n in mods}


def _dist_step(stage: str, batch: dict, device,
               other_weights: bool = False) -> tuple:
    """One train step of the stage (`_train_modules`, `_train_state`) on
    `batch` from the seeded weights (other seeds with `other_weights`):
    (result, state, step, batch on the device, mods); result holds the
    metrics, and each trained model's gradients and parameters after the
    step on the CPU."""
    from propainter_tpu_torch.weights import seeded_init_

    l_t = json.loads((Path(__file__).resolve().parent / TRAIN_CONFIGS[stage])
                     .read_text())["train_data_loader"]["num_local_frames"]
    mods = _train_modules(stage, device)
    if other_weights:
        for i, m in enumerate(mods.values()):
            seeded_init_(m, 90 + i)
    state, step = _train_state(stage, mods, device, num_local_frames=l_t)
    batch = {k: v.to(device) for k, v in batch.items()}
    _, metrics, _ = step(state, batch)
    trained = _dist_trained(stage, mods)
    result = dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: {k: p.grad.detach().to("cpu", copy=True)
                   for k, p in m.named_parameters() if p.grad is not None}
               for n, m in trained.items()},
        params={n: {k: p.detach().to("cpu", copy=True)
                    for k, p in m.named_parameters()}
                for n, m in trained.items()})
    return result, state, step, batch, mods


def _loss_err(metrics: dict, want: dict) -> float:
    """The largest relative difference of two steps' losses."""
    return max(abs(metrics[k] - v) / max(abs(v), 1e-12)
               for k, v in want.items())


def _compare_steps(got: dict, want: dict) -> dict:
    """Two steps' results (`_dist_step`): the losses' largest relative
    difference; each model's gradients' (of each tensor's largest, or of
    1e-4 of the model's largest where that is more); its parameters'
    after the step where the gradient is at least 1e-4 of its tensor's
    largest and 1e-5 (of each tensor's largest parameter), with the
    tensor."""
    import torch

    out = {"loss": _loss_err(got["metrics"], want["metrics"])}
    for name, grads in want["grads"].items():
        floor = 1e-4 * max(g.abs().max().item() for g in grads.values())
        out[f"{name} grad"] = max(
            ((got["grads"][name][k] - g).abs().max().item()
             / max(g.abs().max().item(), floor), k)
            for k, g in grads.items())
        errs = []
        for k, p in want["params"][name].items():
            g = grads.get(k)
            sure = (torch.ones_like(p, dtype=torch.bool) if g is None
                    else g.abs() >= max(1e-4 * g.abs().max().item(), 1e-5))
            diff = (got["params"][name][k] - p).abs()[sure]
            errs.append((diff.max().item() if diff.numel() else 0.0)
                        / max(p.abs().max().item(), 1e-12))
        out[f"{name} param"] = max(zip(errs, want["params"][name]))
    return out


def _timed_steps(stage: str, state, step, batch) -> dict:
    """DIST_STEPS more steps after a warm-up: seconds a step (host clock
    around a synchronize), the all-reduce of the gradients a step
    (`trainer._average_grads` timed on the host around synchronizes, at
    more than one rank: at one the step's regions replay from CUDA graphs,
    which hold no synchronize, and the average is a no-op), peak memory,
    the last step's launches, and the step's graphs by region."""
    import torch
    from propainter_tpu_torch.core import trainer as TT
    from propainter_tpu_torch.parallel.mesh import world_size

    average = TT._average_grads
    reduce_s = []

    def timed(module):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average(module)
        torch.cuda.synchronize()
        reduce_s[-1] += time.perf_counter() - t0

    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    if world_size() > 1:
        TT._average_grads = timed
    try:
        for i in range(DIST_STEPS):
            reduce_s.append(0.0)
            if i == DIST_STEPS - 1:
                _zero_launches()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = _read_launches()
    finally:
        TT._average_grads = average
    return dict(step_ms=1e3 * statistics.median(seconds),
                step_ms_all=[1e3 * x for x in seconds],
                allreduce_ms=(1e3 * statistics.median(reduce_s)
                              if world_size() > 1 else None),
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, graphs=step.graphs.counts(),
                graph_keys=len(step.graphs.keys()))


def _dist_rank(rank: int, world: int, init: str, out_dir: str,
               backend: str, batches: dict) -> None:
    """A spawned rank of `phase_dist`: one GPU (its own under NCCL, the
    one card under gloo), the group at `init`, then for each stage one
    step on its sample of the saved batch of 2 from the seeded weights
    (rank 1 starts from other weights: rank 0's reach it by broadcast),
    `_timed_steps`; rank 0 saves its results, every rank its timings and
    a sum of each parameter (equal across ranks)."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    try:
        out = {}
        for stage, path in batches.items():
            batch = torch.load(path)
            per = 2 // world
            shard = {k: v[rank * per:(rank + 1) * per]
                     for k, v in batch.items()}
            result, state, step, shard, mods = _dist_step(
                stage, shard, "cuda", other_weights=rank > 0)
            sums = {n: {k: float(p.double().sum()) for k, p in ps.items()}
                    for n, ps in result["params"].items()}
            timing = _timed_steps(stage, state, step, shard)
            out[stage] = dict(timing, sums=sums, **(
                result if rank == 0 else {"metrics": result["metrics"]}))
            del state, step, shard, mods, result
            torch.cuda.empty_cache()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dist_ranks(world: int, backend: str, batches: dict, tmp: Path) -> list:
    """`_dist_rank` on `world` spawned processes; each rank's saved
    output."""
    import torch
    import torch.multiprocessing as mp

    out = tmp / f"{backend}_{world}"
    out.mkdir()
    mp.start_processes(_dist_rank, args=(
        world, f"file://{tmp / f'init_{backend}_{world}'}", str(out),
        backend, batches), nprocs=world, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _check_ranks(label: str, ranks: list, refs: dict, smi: str) -> dict:
    """Each stage of the ranks' run against the one-process step on the
    batch of 2: every rank's losses, rank 0's gradients and parameters,
    every rank's parameter sums equal to rank 0's; prints each rank's
    ms a step, all-reduce ms a step, peak GiB and launches."""
    report = {}
    for stage, ref in refs.items():
        rows = [r[stage] for r in ranks]
        err = _compare_steps(rows[0], ref)
        err["loss"] = max(_loss_err(r["metrics"], ref["metrics"])
                          for r in rows)
        same = all(r["sums"] == rows[0]["sums"] for r in rows)
        print(f"  {label} {stage}: losses within {err['loss']:.2e} "
              f"relative (limit {DIST_LOSS_TOL}); "
              + "; ".join(f"{k} {v[0]:.2e} of scale ({v[1]})"
                          for k, v in err.items() if k != "loss")
              + f" (parameters' limit {DIST_PARAM_TOL}); the ranks' "
              f"parameters {'equal' if same else 'DIFFER'}")
        for r, row in enumerate(rows):
            _check_launches(f"{label} {stage} rank {r}", row["launches"],
                            _train_launches(stage))
            print(f"  {label} {stage} rank {r}: {row['step_ms']:.1f} ms a "
                  f"step (median of {DIST_STEPS}: "
                  + ", ".join(f"{x:.1f}" for x in row["step_ms_all"])
                  + f"), all-reduce {row['allreduce_ms']:.1f} ms a step, "
                  f"peak {row['peak_bytes'] / 2 ** 30:.2f} GiB; eager "
                  f"({row['graph_keys']} graph keys: the step graphs "
                  f"nothing across ranks); on {smi}")
            if row["graph_keys"]:
                raise AssertionError(f"{label} {stage} rank {r}: a step "
                                     f"across ranks used its graphs")
        report[stage] = dict(
            errors={k: v if k == "loss" else v[0] for k, v in err.items()},
            ranks=[{k: row[k] for k in ("step_ms", "step_ms_all",
                                        "allreduce_ms", "peak_bytes",
                                        "launches", "metrics",
                                        "graph_keys")}
                   for row in rows])
        params = [v[0] for k, v in err.items() if k.endswith("param")]
        if (not same or err["loss"] > DIST_LOSS_TOL
                or max(params) > DIST_PARAM_TOL):
            raise AssertionError(f"{label} {stage}: the ranks disagree "
                                 f"with the one-process step: {err}")
    return report


def _dist_cli(root: Path, weights: Path, smi: str) -> dict:
    """The train CLI (flow completion stage) under torchrun's environment
    at world size 1 (MASTER_ADDR, MASTER_PORT, RANK, LOCAL_RANK,
    WORLD_SIZE: an NCCL group of one): 2 steps with the step-2
    checkpoint, then a rerun to 3 that resumes at step 2."""
    import os

    from propainter_tpu_torch.cli import train
    from propainter_tpu_torch.parallel import mesh

    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(mesh.free_port()),
               RANK="0", LOCAL_RANK="0", WORLD_SIZE="1")
    saved = {k: os.environ.get(k) for k in env}
    cwd = os.getcwd()
    os.environ.update(env)
    os.chdir(root)
    try:
        cfg = str(_train_config("flowcomp", root, weights))
        t0 = time.perf_counter()
        first = train.main(["-c", cfg, "--max_iters", "2"])
        resumed = train.main(["-c", cfg, "--max_iters", "3"])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run = root / first["save_dir"]
    rows = _metrics_jsonl(run / "logs" / "metrics.jsonl")
    files = sorted(p.name for p in (run / "ckpt").iterdir())
    print(f"  cli under torchrun's environment (world size 1, NCCL): "
          f"resumed at {resumed['start']}; metrics steps "
          f"{[r['step'] for r in rows]}; checkpoints {files}; "
          f"{seconds:.1f} s with set-up; on {smi}")
    if (resumed["start"] != 2 or [r["step"] for r in rows] != [1, 2, 3]
            or not {"gen_000002.pth", "opt_000002.pth"} <= set(files)):
        raise AssertionError("cli under torchrun: logs, checkpoint or "
                             "resume missing")
    return dict(rows=rows, files=files, seconds=seconds)


def phase_dist(state: dict, smi: str) -> None:
    """Data-parallel training on the card at the configs' full widths
    (432 x 240, l_t 10, RAFT 20 iterations, fp32, TF32 off), both
    stages, on a global batch of 2 whose holes cover 2.3% and 40.5% of
    the frame (`_dist_batch`): (a) the step inside an NCCL group of one
    rank against the plain one-process step (losses and parameters
    within DIST_ONE_RANK_TOL, gradients within DIST_GRAD_TOL, a second
    plain step's differences beside), timed with its regions replayed
    from CUDA graphs (the step's default at one rank), and an NCCL
    all-reduce of the trainee's gradients at world size 1; (b) two gloo
    ranks on the one card, a sample each, eager (no region graphed
    across ranks), against the one-process step on the batch of 2
    (`_check_ranks`); (c) NCCL
    with one rank per GPU where two or more are visible; (d) the train
    CLI under torchrun's environment (`_dist_cli`). K1, K2 and K3 launch
    per rank as `_train_launches` says."""
    import tempfile

    import torch
    import torch.distributed as dist
    from propainter_tpu_torch import _build
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.parallel import mesh
    from propainter_tpu_torch.weights import seeded_init_

    _build.build()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    report = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        _write_train_dataset(tmp)
        refs, batches, one = {}, {}, {}
        for stage in TRAIN_CONFIGS:
            batch = _dist_batch(stage, tmp)
            batches[stage] = str(tmp / f"batch_{stage}.pt")
            torch.save(batch, batches[stage])
            refs[stage] = _dist_step(stage, batch, "cuda")[0]
            torch.cuda.empty_cache()
            noise = _compare_steps(_dist_step(stage, batch, "cuda")[0],
                                   refs[stage])
            torch.cuda.empty_cache()
            dist.init_process_group(
                "nccl", init_method=f"tcp://localhost:{mesh.free_port()}",
                world_size=1, rank=0)
            try:
                got, st, step, b, mods = _dist_step(stage, batch, "cuda")
                err = _compare_steps(got, refs[stage])
                timing = _timed_steps(stage, st, step, b)
                grads = [p.grad for p in mods["trainee"].parameters()
                         if p.grad is not None]
                nccl_ms = _time_ms(lambda: mesh._flat_collective(
                    grads, dist.all_reduce), 5)
            finally:
                dist.destroy_process_group()
            del st, step, b, mods, grads
            _graph_memory()
            print(f"  (a) one NCCL rank, {stage}: losses within "
                  f"{err['loss']:.2e} relative; "
                  + "; ".join(f"{k} {v[0]:.2e} of scale"
                              for k, v in err.items() if k != "loss")
                  + f" (limits {DIST_ONE_RANK_TOL}, gradients "
                  f"{DIST_GRAD_TOL}); a second plain step: losses "
                  f"{noise['loss']:.2e}, "
                  + "; ".join(f"{k} {v[0]:.2e}"
                              for k, v in noise.items() if k != "loss")
                  + f"; batch 2, the step's regions from CUDA graphs "
                  f"{timing['graphs']}: "
                  f"{timing['step_ms']:.1f} ms a step, peak "
                  f"{timing['peak_bytes'] / 2 ** 30:.2f} GiB; an NCCL "
                  f"all-reduce of the trainee's gradients (world size 1) "
                  f"{nccl_ms:.3f} ms; on {smi}")
            _check_launches(f"(a) {stage}", timing["launches"],
                            _train_launches(stage))
            if set(timing["graphs"].values()) != {1}:
                raise AssertionError(f"(a) {stage}: one NCCL rank replays "
                                     f"{timing['graphs']}, not one graph "
                                     f"a region")
            if (max([err["loss"]] + [v[0] for k, v in err.items()
                                     if k.endswith("param")])
                    > DIST_ONE_RANK_TOL
                    or max(v[0] for k, v in err.items()
                           if k.endswith("grad")) > DIST_GRAD_TOL):
                raise AssertionError(f"(a) {stage}: {err}")
            one[stage] = dict(timing, nccl_allreduce_ms=nccl_ms,
                              errors={k: v if k == "loss" else v[0]
                                      for k, v in err.items()},
                              plain_noise={k: v if k == "loss" else v[0]
                                           for k, v in noise.items()})
        report["one_rank_nccl"] = one
        report["two_ranks_gloo"] = _check_ranks(
            "(b) two gloo ranks on one card",
            _dist_ranks(2, "gloo", batches, tmp), refs, smi)
        if torch.cuda.device_count() >= 2:
            report["two_ranks_nccl"] = _check_ranks(
                "(c) NCCL, one rank per GPU",
                _dist_ranks(2, "nccl", batches, tmp), refs, smi)
        else:
            print(f"  (c) NCCL with one rank per GPU: not run, "
                  f"{torch.cuda.device_count()} GPU visible")
        weights = tmp / "weights"
        weights.mkdir()
        raft = seeded_init_(RAFT(), TRAIN_SEEDS["raft"], fan_in_scaled=True)
        torch.save({f"module.{k}": v for k, v in raft.state_dict().items()},
                   weights / "raft-things.pth")
        torch.save(seeded_init_(RecurrentFlowCompleteNet(),
                                TRAIN_SEEDS["flowcomp"],
                                fan_in_scaled=True).state_dict(),
                   weights / "recurrent_flow_completion.pth")
        report["cli"] = _dist_cli(tmp, weights, smi)
    state["dist"] = report
    state.setdefault("launches", {}).update({
        f"dist_{stage}": report["two_ranks_gloo"][stage]["ranks"][0]
        ["launches"] for stage in TRAIN_CONFIGS})


# RAFT's training data (`core/flow_datasets.py`): each dataset's own frame
# size (W x H) and the reference's crop (H x W) of each curriculum stage
# (RAFT/train.py's stage flags); the synthetic layouts written under build/
FLOW_FRAMES = {"chairs": (512, 384), "sintel": (1024, 436),
               "things": (960, 540), "kitti": (1242, 375),
               "hd1k": (2560, 1080)}
FLOW_CROPS = {"chairs": (368, 496), "things": (400, 720),
              "sintel": (368, 768), "kitti": (288, 960)}
FLOW_RAFT_ITERS = 20


def _write_flow_datasets(root: Path) -> dict:
    """Miniature FlyingChairs (5 training pairs), MPI-Sintel (one scene
    of 5 frames, clean and final), FlyingThings3D (one sequence of 4
    frames, both passes, both directions), KITTI-2015 (4 pairs) and HD1K
    (one sequence of 2 frames) in their own layouts and frame sizes
    (`FLOW_FRAMES`), seeded images (8 x 8 texture blocks) and smooth
    flows (.flo, 3-channel .pfm, KITTI 16-bit PNG with 70% valid); the
    roots `fetch_flow_dataset` takes."""
    import cv2
    import numpy as np
    from propainter_tpu_torch.utils.flow_io import (flowwrite,
                                                    write_flow_kitti,
                                                    write_pfm)

    rng = np.random.default_rng(70)
    r = {k: root / k for k in FLOW_FRAMES}

    def image(path: Path, kind: str):
        W, H = FLOW_FRAMES[kind]
        path.parent.mkdir(parents=True, exist_ok=True)
        base = rng.integers(0, 255, (-(-H // 8), -(-W // 8), 3), np.uint8)
        cv2.imwrite(str(path), np.kron(base, np.ones((8, 8, 1), np.uint8))
                    [:H, :W])

    def flow(kind: str, channels: int = 2):
        W, H = FLOW_FRAMES[kind]
        small = rng.normal(0, 8, (6, 10, channels)).astype(np.float32)
        return cv2.resize(small, (W, H), interpolation=cv2.INTER_LINEAR
                          ).reshape(H, W, channels)

    def sparse(path: Path, kind: str):
        f = flow(kind)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_flow_kitti(f, str(path),
                         (rng.random(f.shape[:2]) < 0.7).astype(np.float32))

    for i in range(5):
        for k in (1, 2):
            image(r["chairs"] / f"{i:05d}_img{k}.ppm", "chairs")
        flowwrite(flow("chairs"), str(r["chairs"] / f"{i:05d}_flow.flo"))
    np.savetxt(r["chairs"] / "chairs_split.txt", [1] * 5, fmt="%d")
    for i in range(5):
        for dstype in ("clean", "final"):
            image(r["sintel"] / "training" / dstype / "alley_1"
                  / f"frame_{i:04d}.png", "sintel")
    for i in range(4):
        flowwrite(flow("sintel"), str(r["sintel"] / "training" / "flow"
                                      / "alley_1" / f"frame_{i:04d}.flo"))
    seq = Path("TRAIN") / "A" / "0000"
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for i in range(4):
            image(r["things"] / dstype / seq / "left" / f"{i:04d}.png",
                  "things")
    for direction in ("into_future", "into_past"):
        for i in range(4):
            path = (r["things"] / "optical_flow" / seq / direction / "left"
                    / f"{i:04d}.pfm")
            path.parent.mkdir(parents=True, exist_ok=True)
            write_pfm(flow("things", 3), str(path))
    for i in range(4):
        for k in (10, 11):
            image(r["kitti"] / "training" / "image_2" / f"{i:06d}_{k}.png",
                  "kitti")
        sparse(r["kitti"] / "training" / "flow_occ" / f"{i:06d}_10.png",
               "kitti")
    for i in range(2):
        image(r["hd1k"] / "hd1k_input" / "image_2" / f"000000_{i:02d}.png",
              "hd1k")
        sparse(r["hd1k"] / "hd1k_flow_gt" / "flow_occ"
               / f"000000_{i:02d}.png", "hd1k")
    return {k: str(v) for k, v in r.items()}


def _shard_batches(dataset_fn, batch: int = 2) -> tuple:
    """One batch of `batch` from each of two shards of `PrefetchLoader`
    (one worker, a dataset each from `dataset_fn`), the indices each
    drew, and the loader's ms a batch (the first batch of each shard,
    from the loader's start: reads, decodes and augments at the
    datasets' own frame sizes)."""
    from propainter_tpu_torch.core.dataset import PrefetchLoader

    class Recorded(PrefetchLoader):
        def _next_indices(self):
            idxs = super()._next_indices()
            self.drawn = getattr(self, "drawn", []) + [idxs]
            return idxs

    batches, drawn, ms = [], [], []
    for shard in (0, 1):
        t0 = time.perf_counter()
        loader = Recorded(dataset_fn(), batch, num_workers=1, prefetch=1,
                          seed=0, shard_index=shard, num_shards=2)
        try:
            batches.append(loader.next())
            ms.append((time.perf_counter() - t0) * 1e3)
            drawn.append(loader.drawn[0])
        finally:
            loader.stop()
    return batches, drawn, ms


def _check_k1_k2_at(randn, B: int, H8: int, W8: int) -> dict:
    """K2 and K1 on a random level-0 volume of B pair-directions at an
    H8 x W8 map against their plain versions, timed beside them, with
    their bounds (`_check_k2`, `_check_k1`)."""
    pyr, k2 = _check_k2(_level0(randn, B, H8, W8))
    k1 = _check_k1(randn, pyr)
    del pyr
    keep = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"corr_pyramid_build": {k: k2[k] for k in keep},
            "corr_lookup_moenc": {k: k1[k] for k in keep}}


def phase_flow_data(state: dict, smi: str) -> None:
    """RAFT's training data on the card: `_write_flow_datasets` under
    build/, then for each curriculum stage (`FLOW_CROPS`: chairs, things,
    sintel with its KITTI and HD1K mixture, kitti) `fetch_flow_dataset`
    at the stage's crop, one batch of 2 from each of two shards of
    `PrefetchLoader` (the shards' indices disjoint; images, flow and
    valid of the crop's shape, finite), the port's RAFT (seeded, fp32,
    20 iterations) on shard 0's batch with K2 launched once and K1 once
    an iteration, finite flow of the crop's shape; and K2 and K1 at each
    crop's 1/8 map (2 pair-directions) against their plain versions
    (`_check_k1_k2_at`). Prints the loader's and RAFT's ms a batch."""
    import tempfile

    import numpy as np
    import torch
    from propainter_tpu_torch.core import flow_datasets
    from propainter_tpu_torch.device import fp32_numerics
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    raft = seeded_init_(RAFT(), TRAIN_SEEDS["raft"], fan_in_scaled=True)
    raft = raft.cuda().eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(71)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    report, kernels = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.perf_counter()
        roots = _write_flow_datasets(Path(tmp))
        print(f"  synthetic flow datasets written in "
              f"{time.perf_counter() - t0:.1f} s")
        for stage, crop in FLOW_CROPS.items():
            n = len(flow_datasets.fetch_flow_dataset(stage, crop,
                                                     roots=roots))
            batches, drawn, loader_ms = _shard_batches(
                lambda: flow_datasets.fetch_flow_dataset(
                    stage, crop, roots=roots, seed=1))
            if set(drawn[0]) & set(drawn[1]):
                raise AssertionError(f"{stage}: shards overlap {drawn}")
            for b in batches:
                want = {"image1": (2, *crop, 3), "image2": (2, *crop, 3),
                        "flow": (2, *crop, 2), "valid": (2, *crop)}
                got = {k: v.shape for k, v in b.items()}
                if got != want or not all(np.isfinite(v).all()
                                          for v in b.values()):
                    raise AssertionError(f"{stage}: batch {got}")
            im1, im2 = (torch.from_numpy(batches[0][k]).cuda() / 127.5 - 1
                        for k in ("image1", "image2"))
            with torch.no_grad(), fp32_numerics():
                raft(im1, im2, FLOW_RAFT_ITERS)          # warm-up
                _zero_launches()
                _, flow = raft(im1, im2, FLOW_RAFT_ITERS)
                launches = _read_launches()
                raft_ms = _time_ms(lambda: raft(im1, im2, FLOW_RAFT_ITERS),
                                   3, warmup=0)
            _check_launches(f"flow_data {stage} RAFT", launches, dict(
                corr_pyramid_build=1, corr_lookup_moenc=FLOW_RAFT_ITERS,
                corr_lookup=0))
            if (tuple(flow.shape) != (2, *crop, 2)
                    or not torch.isfinite(flow).all()):
                raise AssertionError(f"{stage}: RAFT flow {flow.shape}")
            H8, W8 = crop[0] // 8, crop[1] // 8
            kernels[stage] = _check_k1_k2_at(randn, 2, H8, W8)
            k2 = kernels[stage]["corr_pyramid_build"]
            k1 = kernels[stage]["corr_lookup_moenc"]
            print(f"  flow_data {stage}: {n} items, crop {crop[0]} x "
                  f"{crop[1]} (map {H8} x {W8}); shards drew {drawn}; "
                  f"loader {loader_ms[0]:.1f} / {loader_ms[1]:.1f} ms a "
                  f"batch of 2 (first batch, two shards); RAFT "
                  f"{raft_ms:.1f} ms a batch of 2 ({FLOW_RAFT_ITERS} "
                  f"iterations); K2 {k2['ms']:.4f} ms (plain "
                  f"{k2['plain_ms']:.3f}, bound {k2['bound_ms']:.4f}), K1 "
                  f"{k1['ms']:.4f} ms (plain {k1['plain_ms']:.3f}, bound "
                  f"{k1['bound_ms']:.4f}); on {smi}")
            report[stage] = dict(items=n, crop=crop, drawn=drawn,
                                 loader_ms=loader_ms, raft_ms=raft_ms,
                                 launches=launches)
    state["flow_data"] = dict(report, kernels=kernels)


# the demo phase: SAM vit_h at 1024x1024, fp32 (`phase_demo`)
DEMO_MODEL = "vit_h"
DEMO_SEED = 71
DEMO_FRAME = (480, 854)          # DAVIS's frame size (H, W)
# (x, y) clicks on the frame: two positive, one negative; the last click is
# positive, so first_frame_click runs its dense-prompt refine pass
DEMO_CLICKS = ((300.0, 200.0), (610.0, 330.0), (500.0, 260.0))
DEMO_LABELS = (1, 0, 1)
DEMO_CUT_BLOCKS = 8              # blocks 0-7: windowed ones and global 7
DEMO_CPU_BUDGET_S = 40.0         # the CPU's whole-encoder projection limit
DEMO_REPEATS = 5


def _sam_model(cfg, seed: int):
    """A seeded SAM on the CPU: `seeded_init_(fan_in_scaled=True)` over a
    meta-built model, then every LayerNorm weight 1 + N(0, 0.1^2) (at
    N(0, 0.1^2) each mask comes out one sign)."""
    import torch
    from propainter_tpu_torch.models.sam import LayerNorm2d, Sam
    from propainter_tpu_torch.weights import seeded_init_

    with torch.device("meta"):
        model = Sam(cfg)
    model = seeded_init_(model.to_empty(device="cpu"), seed,
                         fan_in_scaled=True).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, LayerNorm2d)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=gen))
    return model


def _sam_frame(H: int, W: int, seed: int):
    """A synthetic RGB frame: a smooth gradient with three bright blobs and
    noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([40 + 80 * x / W, 60 + 60 * y / H,
                    np.full_like(x, 90)], -1)
    for cx, cy, r, color in ((300, 200, 90, (230, 60, 50)),
                             (620, 330, 70, (40, 200, 80)),
                             (480, 120, 50, (250, 240, 90))):
        inside = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[inside] = color
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _sam_encoder_work(cfg, n_params: int) -> dict:
    """The image encoder's fp32 operations (2 per multiply-add) and bytes
    (its `n_params` weights and the input read once, the embedding written
    once) at 1024x1024:
    the patch conv, each block's qkv and proj on its padded tokens
    (windowed: 70x70 at window 14), attention products 4 N L C over
    windows of L tokens, the decomposed relative positions, the MLP on the
    64x64 tokens, and the neck."""
    g, C, ws = cfg.grid, cfg.embed_dim, cfg.window_size
    N = g * g
    hidden = int(C * cfg.mlp_ratio)
    ops = 2 * N * C * 3 * cfg.patch_size ** 2
    per_block = []
    for i in range(cfg.depth):
        if i in cfg.global_attn_indexes:
            side, Np, L = g, N, N
        else:
            side = ws
            Np = (-(-g // ws) * ws) ** 2
            L = ws * ws
        block = (2 * Np * C * 3 * C + 4 * Np * L * C + 2 * 2 * Np * side * C
                 + 2 * Np * C * C + 2 * 2 * N * C * hidden)
        per_block.append(block)
    ops += sum(per_block)
    ops += 2 * N * C * cfg.out_chans + 2 * N * cfg.out_chans ** 2 * 9
    n_bytes = 4 * (n_params + 3 * cfg.img_size ** 2 + N * cfg.out_chans)
    return dict(ops=ops, bytes=n_bytes, per_block=per_block)


def _rel_err(got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, max |want|)."""
    scale = want.float().abs().max().item()
    return (got.float().cpu() - want.float().cpu()).abs().max().item() / \
        scale, scale


# the demo's CUDA-graph regions against eager (`_pairs`, `_decide`): a
# region is kept where its graphed median over REGION_PAIRS alternating
# pairs in one process lies below its eager minimum (PERF.md section 7)
REGION_PAIRS = 3
# the demo's click sequence (`_sam_graphs`, `_sam_session`): SAM_APP_IMAGES
# frames (seeds DEMO_SEED, DEMO_SEED + 1, ...), on each the clicks growing
# one at a time (DEMO_CLICKS' first n for n in DEMO_CLICK_COUNTS); the
# configurations graphed, (points_bucket, regions), each against the eager
# segmenter of its points_bucket
SAM_APP_IMAGES = 3
DEMO_CLICK_COUNTS = (1, 2, 3)
# rounds of SAM's click sequence per configuration
SAM_ROUNDS = 2
SAM_CONFIGS = ((None, ("encode",)), (None, ("decode",)), (8, ("decode",)))


class _RegionTimes:
    """An owner's `graphs` (a `graphs.StageGraphs`) with each region call
    between two CUDA events; `take()` gives the ms of the calls since the
    last take, by region. Around a replay the events time the replay,
    its inputs' copies and its outputs' clones; around an eager call, its
    launches as the device ran them, gaps waiting on the host included."""

    def __init__(self, graphs):
        self.graphs, self.marks = graphs, []

    def __call__(self, region, fn, tensors, static=()):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.graphs(region, fn, tensors, static)
        end.record()
        self.marks.append((region, start, end))
        return out

    def __getattr__(self, name):
        return getattr(self.graphs, name)

    def take(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out: dict = {}
        for region, start, end in self.marks:
            out.setdefault(region, []).append(start.elapsed_time(end))
        self.marks = []
        return out


def _timed_regions(owners: dict) -> dict:
    """Each owner (a `CutieCore`, `FlowMaskTracker` or `SamSegmenter`)
    with its graphs wrapped in `_RegionTimes`."""
    for owner in owners.values():
        owner.graphs = _RegionTimes(owner.graphs)
    return owners


def _pairs(run, owners: dict, pairs: int = REGION_PAIRS) -> dict:
    """`pairs` alternating runs of run(owner) on owners["graphed"] and
    owners["eager"], graphed first in even pairs: {side: [runs]}."""
    runs: dict = {"graphed": [], "eager": []}
    for i in range(pairs):
        order = ("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")
        for side in order:
            runs[side].append(run(owners[side]))
    return runs


def _decide(name: str, runs: dict, parts, smi: str) -> dict:
    """Each part's graphed runs against its eager ones (`_pairs`; each
    run a dict with one number per part, ms): kept where the graphed
    median lies below the eager minimum."""
    decisions = {}
    for part in parts:
        g = [r[part] for r in runs["graphed"]]
        e = [r[part] for r in runs["eager"]]
        keep = statistics.median(g) < min(e)
        decisions[part] = dict(graphed=_spread(g), eager=_spread(e),
                               keep=keep)
        print(f"  {name} {part}: graphed median {statistics.median(g):.4f} "
              f"ms ({min(g):.4f}-{max(g):.4f}), eager min {min(e):.4f} ms "
              f"(median {statistics.median(e):.4f}) over {len(g)} pairs: "
              + ("keep the graph" if keep else "stays eager") + f"; on {smi}")
    return decisions


def _busy(step) -> dict:
    """step() once under torch.profiler (the device's activity only): wall
    ms, the device's busy ms (its kernels and copies), the busy share and
    the launches."""
    import torch

    with _device_trace() as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = _trace_rows(prof)
    busy = sum(r[1] for r in kern)
    return dict(wall_ms=wall, busy_ms=busy, share=busy / wall,
                launches=sum(r[2] for r in kern))


def _same_arrays(what: str, got: list, want: list, failures: list) -> bool:
    """Arrays (or tuples of arrays) equal bit for bit, item by item; a
    difference is added to `failures` with the items it is in."""
    import numpy as np

    def equal(a, b):
        if isinstance(a, tuple):
            return all(equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    bad = [i for i, (g, w) in enumerate(zip(got, want)) if not equal(g, w)]
    if bad or len(got) != len(want):
        failures.append(f"{what}: graphed and eager differ at items "
                        f"{bad[:12]} of {len(want)}")
    return not bad


def _check_defaults(name: str, owner_cls, decisions: dict,
                    failures: list) -> None:
    """Each region `owner_cls` graphs by default must be kept by this run's
    rule (`decisions[region]["keep"]`), else a failure; a region the rule
    keeps that is off by default is printed. The default is the
    owner's `cuda_graphs` default."""
    import inspect

    default = tuple(inspect.signature(owner_cls).parameters[
        "cuda_graphs"].default)
    dropped = [r for r in default if not decisions[r]["keep"]]
    if dropped:
        failures.append(f"{name}: the default regions {dropped} failed the "
                        f"keep-or-drop rule")
    extra = [r for r, d in decisions.items()
             if d["keep"] and r not in default]
    print(f"  {name} default regions {list(default)}: kept by the rule "
          f"{not dropped}" + (f"; kept by the rule, off by default: {extra}"
                              if extra else ""))


def _sam_session(model, bucket, regions, frames, clicks, labels) -> dict:
    """The demo's click sequence on a new `SamControler` of `model` (a new
    app): on each of `frames` the image reset, then first_frame_click with
    the first n clicks for each n in DEMO_CLICK_COUNTS (the first click
    embeds the frame; the app's on_click). Each click's wall ms, painted
    preview included, and the segmenter's part of it (set_image and
    predict; predict reads its results back); each region call's event
    ms by image (`_RegionTimes`); the masks and logits; the graphs'
    captures and capture s; the GiB the segmenter holds after the
    sequence (its graphs' pool and static inputs, the embedding) and its
    peak allocated, both above what was held before it."""
    import torch
    from propainter_tpu_torch.demo import SamControler, SamSegmenter

    base = _graph_memory()
    base_alloc = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seg = SamSegmenter(model, points_bucket=bucket, device="cuda",
                       cuda_graphs=regions)
    seg.graphs = _RegionTimes(seg.graphs)
    sam_ms = []
    for method in ("set_image", "predict"):
        def timed(*args, _fn=getattr(seg, method), **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            sam_ms[-1] += (time.perf_counter() - t0) * 1e3
            return out
        setattr(seg, method, timed)
    ctrl = SamControler(seg)
    out, click_ms, region_ms = [], [], []
    for frame in frames:
        seg.reset_image()
        for n in DEMO_CLICK_COUNTS:
            sam_ms.append(0.0)
            t0 = time.perf_counter()
            mask, logit, _ = ctrl.first_frame_click(frame, clicks[:n],
                                                    labels[:n])
            click_ms.append((time.perf_counter() - t0) * 1e3)
            out.append((mask, logit))
        region_ms.append(seg.graphs.take())
    k = len(DEMO_CLICK_COUNTS)
    last = region_ms[-1]
    run = dict(sam=sum(sam_ms), click=sum(click_ms),
               sam_images=[sum(sam_ms[i:i + k])
                           for i in range(0, len(sam_ms), k)],
               worst_click=max(click_ms),
               last_image_ms_a_call={r: statistics.mean(v)
                                     for r, v in last.items()},
               graphs=seg.graphs.counts(),
               capture_s=seg.graphs.capture_seconds,
               peak_gib=(torch.cuda.max_memory_allocated() - base_alloc)
               / 2 ** 30)
    run["held_gib"] = _graph_memory() - base
    del seg, ctrl
    _graph_memory()
    return dict(run, out=out)


def _sam_graphs(model, frames: list, clicks, labels, smi: str,
                failures: list) -> dict:
    """SAM's two regions from CUDA graphs against eager in the demo's own
    click sequence (`_sam_session`: SAM_APP_IMAGES frames, the clicks
    growing on each, a new segmenter a sequence), for each configuration
    of SAM_CONFIGS against the eager segmenter of its `points_bucket`,
    SAM_ROUNDS rounds of every configuration in alternating order. With
    `points_bucket` None (the default) a click count recurs only on the
    next frame: the graphs capture on the second frame and replay from
    the third. Each configuration's decision on the segmenter's ms over
    the sequence, captures included (`_decide`); the whole clicks' ms,
    the segmenter's ms by frame, each region's event ms a call on the last
    frame, the captures, capture s and the GiB the graphs hold against
    the eager peak; every mask and logit of a graphed sequence equal to
    the eager one's bit for bit; SAM's default regions against the
    decisions of `points_bucket` None (`_check_defaults`)."""
    from propainter_tpu_torch.demo.segmenter import SamSegmenter

    buckets = list(dict.fromkeys(b for b, _ in SAM_CONFIGS))
    eager_of = {b: "eager" if b is None else f"eager_bucket{b}"
                for b in buckets}
    # each eager segmenter before the graphed ones in the first round
    configs = [(eager_of[b], b, ()) for b in buckets] + [
        ("+".join(regions) + ("" if bucket is None else f"_bucket{bucket}"),
         bucket, regions) for bucket, regions in SAM_CONFIGS]
    runs: dict = {name: [] for name, _, _ in configs}
    want: dict = {}
    for i in range(SAM_ROUNDS):
        for name, bucket, regions in (configs if i % 2 == 0
                                      else configs[::-1]):
            run = _sam_session(model, bucket, regions, frames, clicks,
                               labels)
            out = run.pop("out")
            if regions:
                _same_arrays(f"SAM {name}", out, want[bucket], failures)
            else:
                want.setdefault(bucket, out)
            runs[name].append(run)
    decisions, report = {}, dict(images=len(frames),
                                 clicks=list(DEMO_CLICK_COUNTS), configs={})
    for name, bucket, regions in configs:
        if not regions:
            continue
        eager = eager_of[bucket]
        got = _decide(f"SAM {name} over the click sequence",
                      dict(graphed=runs[name], eager=runs[eager]),
                      ("sam",), smi)["sam"]
        if bucket is None and len(regions) == 1:
            decisions[regions[0]] = got

        def med(side, pick):
            return statistics.median(pick(r) for r in runs[side])

        def per_image(side):
            return " / ".join(f"{med(side, lambda r: r['sam_images'][j]):.2f}"
                              for j in range(len(frames)))

        def calls(side):
            return ", ".join(
                f"{r} {med(side, lambda x: x['last_image_ms_a_call'][r]):.3f}"
                for r in regions)

        g = runs[name][0]
        print(f"  SAM {name} (points_bucket {bucket}), {len(frames)} frames "
              f"x clicks {list(DEMO_CLICK_COUNTS)}, medians: the "
              f"segmenter's ms by frame graphed {per_image(name)} against "
              f"eager {per_image(eager)}; whole clicks (painted preview "
              f"included) {med(name, lambda r: r['click']):.2f} against "
              f"{med(eager, lambda r: r['click']):.2f} ms a sequence, worst "
              f"click {med(name, lambda r: r['worst_click']):.2f} against "
              f"{med(eager, lambda r: r['worst_click']):.2f}; on the last "
              f"frame ms a call "
              f"{calls(name)} against eager {calls(eager)}; graphs "
              f"{g['graphs']}, capture {g['capture_s']:.3f} s; held after "
              f"the sequence {g['held_gib']:.3f} GiB (eager "
              f"{runs[eager][0]['held_gib']:.3f}), peak allocated "
              f"{g['peak_gib']:.3f} GiB against eager "
              f"{runs[eager][0]['peak_gib']:.3f}; on {smi}")
        report["configs"][name] = dict(bucket=bucket, regions=list(regions),
                                       runs=runs[name], eager=runs[eager],
                                       decision=got)
    _check_defaults("SamSegmenter", SamSegmenter, decisions, failures)
    print(f"  SAM regions: masks and logits graphed = eager bit for bit "
          f"{not any(f.startswith('SAM') for f in failures)}; on {smi}")
    report["decisions"] = decisions
    return report


def phase_demo(state: dict, smi: str) -> None:
    """The demo's click-to-mask path (`SamSegmenter`, `SamControler`) at
    SAM vit_h, 1024x1024, fp32, seeded weights (`_sam_model`), on a
    synthetic 480x854 frame (`_sam_frame`) with two positive and one
    negative click (`DEMO_CLICKS`). On the GPU: the encoder's ms a frame
    (CUDA events; median and min-max of `DEMO_REPEATS` runs after a
    warm-up) beside its fp32 bound (`_sam_encoder_work`) and its device
    time by kernel (`_device_kernels`), the decoder's ms a click (prompt
    encoder and mask decoder), first_frame_click's ms with the image
    embedded (two decoder passes, the upsampling, the painted preview)
    beside one predict's, the peak memory, and no launch of K1-K7. Against
    the same model on the CPU, each within STAGE_REL_TOL of its scale: the
    tokens after block 7 (`DEMO_CUT_BLOCKS`), the embedding (when the
    CPU's projected whole-encoder time is within `DEMO_CPU_BUDGET_S`; else
    the cut is printed and the CPU decodes the GPU's embedding), the
    decoder's 4 mask logits and IoUs, and first_frame_click's logit; its
    mask must equal the CPU's wherever |logit| is above the tolerance.
    The segmenter runs its default CUDA-graph regions (none); then the
    encoder and the decoder graphed against eager in the demo's click
    sequence over SAM_APP_IMAGES frames, each region's keep or drop
    (`_sam_graphs`)."""
    import numpy as np
    import torch
    from propainter_tpu_torch.demo import SamControler, SamSegmenter
    from propainter_tpu_torch.device import fp32_numerics
    from propainter_tpu_torch.models.sam import sam_config_registry

    cfg = sam_config_registry[DEMO_MODEL]()
    t0 = time.perf_counter()
    cpu_model = _sam_model(cfg, DEMO_SEED)
    torch.cuda.reset_peak_memory_stats()
    seg = SamSegmenter(cpu_model.state_dict(), config=cfg, device="cuda")
    n_params = sum(p.numel() for p in seg.model.parameters())
    print(f"  SAM {DEMO_MODEL} ({n_params / 1e6:.1f} M parameters) seeded "
          f"and on the GPU in {time.perf_counter() - t0:.1f} s")
    work = _sam_encoder_work(cfg, sum(
        p.numel() for p in seg.model.image_encoder.parameters()))
    bound_ms, bound_by = _bound(work["bytes"], work["ops"])
    frame = _sam_frame(*DEMO_FRAME, seed=DEMO_SEED)
    clicks = np.array(DEMO_CLICKS, np.float32)
    labels = np.array(DEMO_LABELS, np.int32)
    failures = []
    report: dict = dict(model=DEMO_MODEL, img_size=cfg.img_size,
                        frame=list(DEMO_FRAME), precision="fp32")

    _zero_launches()
    enc = seg.model.image_encoder
    cut = DEMO_CUT_BLOCKS - 1
    captured: dict = {}
    hooks = [enc.register_forward_pre_hook(
                 lambda m, args: captured.setdefault("x", args[0])),
             enc.blocks[cut].register_forward_hook(
                 lambda m, args, out: captured.setdefault("tokens", out))]
    seg.set_image(frame)
    for hook in hooks:
        hook.remove()
    emb_gpu, x_gpu = seg._embedding, captured["x"]
    with torch.no_grad(), fp32_numerics():
        enc_ms = []
        for _ in range(DEMO_REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            seg.model.encode_image(x_gpu)
            end.record()
            torch.cuda.synchronize()
            enc_ms.append(start.elapsed_time(end))
        breakdown = _device_kernels(lambda: seg.model.encode_image(x_gpu))
    enc_t = _spread(enc_ms)
    print(f"  encoder {DEMO_MODEL} {cfg.img_size}x{cfg.img_size} fp32: "
          f"{enc_t['median']:.2f} ms a frame ({enc_t['min']:.2f}-"
          f"{enc_t['max']:.2f}, {DEMO_REPEATS} runs); bound {bound_ms:.2f} "
          f"ms ({bound_by}: {work['ops'] / 1e12:.3f} TFLOP at "
          f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32, TF32 off), "
          f"{bound_ms / enc_t['median']:.1%} of it; on {smi}")
    print(f"  encoder device time (torch.profiler, one pass): "
          f"{breakdown['device_ms']:.2f} ms in {breakdown['launches']} "
          f"launches; largest: " + "; ".join(
              f"{name} {ms:.2f} ms ({n})" for name, ms, n in breakdown["top"]))

    # the same encoder on the CPU, block by block, timed
    enc_cpu = cpu_model.image_encoder
    t0 = time.perf_counter()
    with torch.no_grad():
        h = enc_cpu.patch_embed(x_gpu.cpu())
        h = h + enc_cpu.pos_embed[:, :h.shape[1], :h.shape[2]]
        for i in range(DEMO_CUT_BLOCKS):
            h = enc_cpu.blocks[i](h)
    t_cut = time.perf_counter() - t0
    err_cut, scale_cut = _rel_err(captured["tokens"], h)
    print(f"  tokens after block {cut} (windowed blocks and global block "
          f"{cut}) GPU vs CPU: {err_cut:.3e} of scale {scale_cut:.3f} "
          f"(limit {STAGE_REL_TOL}); CPU {t_cut:.1f} s")
    report["tokens_block_rel_err"] = {str(cut): err_cut}
    if err_cut > STAGE_REL_TOL:
        failures.append(f"encoder tokens after block {cut} disagree")
    projected = t_cut * work["ops"] / (
        2 * 3 * cfg.patch_size ** 2 * cfg.grid ** 2 * cfg.embed_dim
        + sum(work["per_block"][:DEMO_CUT_BLOCKS]))
    if projected <= DEMO_CPU_BUDGET_S:
        t0 = time.perf_counter()
        with torch.no_grad():
            for blk in enc_cpu.blocks[DEMO_CUT_BLOCKS:]:
                h = blk(h)
            emb_cpu = enc_cpu.neck(h.permute(0, 3, 1, 2))
        t_cpu = t_cut + time.perf_counter() - t0
        err, scale = _rel_err(emb_gpu, emb_cpu)
        print(f"  embedding ({cfg.depth} blocks and the neck) GPU vs CPU: "
              f"{err:.3e} of scale {scale:.3f} (limit {STAGE_REL_TOL}); "
              f"CPU encoder {t_cpu:.1f} s")
        report.update(embedding_rel_err=err, cpu_encoder_s=t_cpu,
                      cpu_blocks=cfg.depth)
        if err > STAGE_REL_TOL:
            failures.append("the image embedding disagrees")
    else:
        emb_cpu = emb_gpu.cpu()
        print(f"  CUT: the CPU runs only blocks 0-{cut} (projected "
              f"{projected:.0f} s for all {cfg.depth}, over "
              f"{DEMO_CPU_BUDGET_S:.0f} s); the CPU decodes the GPU's "
              f"embedding")
        report.update(cpu_blocks=DEMO_CUT_BLOCKS, cpu_projected_s=projected)

    # the decoder: all 4 mask logits and IoUs, GPU vs CPU
    coords, labs = seg._pack_points(clicks, labels)
    with torch.no_grad(), fp32_numerics():
        masks_gpu, iou_gpu = seg.model.decode(emb_gpu, coords, labs)
        dec_ms = _time_ms(lambda: seg.model.decode(emb_gpu, coords, labs),
                          reps=20)
        masks_cpu, iou_cpu = cpu_model.decode(emb_cpu, coords.cpu(),
                                              labs.cpu())
    for name, got, want in (("mask logits", masks_gpu, masks_cpu),
                            ("IoU", iou_gpu, iou_cpu)):
        err, scale = _rel_err(got, want)
        print(f"  decoder {name} {tuple(got.shape)} GPU vs CPU: {err:.3e} "
              f"of scale {scale:.3f} (limit {STAGE_REL_TOL})")
        report[f"decoder_{name.split()[0].lower()}_rel_err"] = err
        if err > STAGE_REL_TOL:
            failures.append(f"decoder {name} disagree")

    # first_frame_click, the image embedded: GPU (timed, and one predict
    # alone: decode, upsampling, readback) vs CPU
    ctrl = SamControler(seg)
    ctrl.first_frame_click(frame, clicks, labels)
    click_ms, predict_ms = [], []
    prompts = {"point_coords": clicks, "point_labels": labels}
    for _ in range(DEMO_REPEATS):
        t0 = time.perf_counter()
        mask_g, logit_g, painted = ctrl.first_frame_click(frame, clicks,
                                                          labels)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        seg.predict(prompts, "point")
        torch.cuda.synchronize()
        click_ms.append((t1 - t0) * 1e3)
        predict_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = _read_launches()
    # the CPU segmenter's encoder returns the CPU's embedding from above
    # (the GPU's, when the CPU ran only the first blocks)
    given = torch.nn.Module()
    given.forward = lambda x: emb_cpu
    cpu_model.image_encoder = given
    seg_cpu = SamSegmenter(cpu_model, device="cpu")
    mask_c, logit_c, _ = SamControler(seg_cpu).first_frame_click(
        frame, clicks, labels)
    err, scale = _rel_err(torch.from_numpy(logit_g),
                          torch.from_numpy(logit_c))
    sure = np.abs(logit_c) > STAGE_REL_TOL * scale
    flipped = int((mask_g != mask_c)[sure].sum())
    print(f"  first_frame_click {DEMO_FRAME[1]}x{DEMO_FRAME[0]}, clicks "
          f"{list(DEMO_LABELS)}: mask {mask_g.mean():.1%} of the frame; "
          f"logit GPU vs CPU {err:.3e} of scale {scale:.3f} (limit "
          f"{STAGE_REL_TOL}); masks differ at {flipped} pixels outside "
          f"|logit| <= {STAGE_REL_TOL * scale:.3e} "
          f"({int((~sure).sum())} pixels inside)")
    if (mask_g.shape != DEMO_FRAME or painted.shape != frame.shape
            or not np.isfinite(logit_g).all()):
        failures.append("first_frame_click output shapes or values")
    if err > STAGE_REL_TOL or flipped:
        failures.append("first_frame_click disagrees with the CPU")
    if any(launches.values()):
        failures.append(f"SAM launched a port kernel: {launches}")
    clk, pred = _spread(click_ms), _spread(predict_ms)
    print(f"  demo {DEMO_MODEL}: encoder {enc_t['median']:.2f} ms a frame "
          f"({bound_ms / enc_t['median']:.1%} of its {bound_ms:.2f} ms "
          f"bound), decoder {dec_ms:.3f} ms a click, first_frame_click "
          f"{clk['median']:.2f} ms ({clk['min']:.2f}-{clk['max']:.2f}; one "
          f"predict {pred['median']:.2f} ms), peak "
          f"{peak:.2f} GiB; K1-K7 launches {sum(launches.values())}; on "
          f"{smi}")
    report.update(encoder_ms=enc_t, encoder_bound_ms=bound_ms,
                  encoder_bound_by=bound_by, encoder_tflop=work["ops"] / 1e12,
                  encoder_share=bound_ms / enc_t["median"], decoder_ms=dec_ms,
                  first_frame_click_ms=clk, predict_ms=pred,
                  encoder_kernels=breakdown, peak_gib=peak,
                  mask_fraction=float(mask_g.mean()),
                  logit_rel_err=err, mask_pixels_flipped=flipped,
                  launches=launches, smi=smi)
    report["graphs"] = _sam_graphs(
        seg.model, [frame] + [_sam_frame(*DEMO_FRAME, seed=DEMO_SEED + i)
                              for i in range(1, SAM_APP_IMAGES)],
        clicks, labels, smi, failures)
    state["demo"] = report
    if failures:
        raise AssertionError("; ".join(failures))


TRACK_SEED = 81
TRACK_FRAMES = 28               # memory frames 0, 5, ..., 25: the trim at 25
TRACK_CORE = dict(mem_every=5, max_mem_frames=5, top_k=30,
                  stagger_updates=5)          # the demo's CutieCoreConfig
TRACK_CPU_BUDGET_S = 40.0       # the CPU engine's projected time limit
TRACK_FLOW_FRAMES = 8
# Cutie graphed against eager (`_cutie_graphs`): every memory length (1-5
# frames' tokens) by frame 21, the first trim at 25 (`TRACK_CORE`), then
# 34 frames of the steady state from CUTIE_STEADY
CUTIE_GRAPH_FRAMES = 60
CUTIE_STEADY = TRACK_CORE["mem_every"] * TRACK_CORE["max_mem_frames"] + 1
CUTIE_SECOND_SEED = TRACK_SEED + 1
# Cutie's two hard decisions, replayed on the CPU from the GPU: the top-k
# token set of each pixel's memory read and the query transformer's
# foreground mask (`>=` against the max of the aggregated logits). Where
# the CPU's own decision differs, the CPU's values must lie within this
# share of their scale of its decision's boundary (fp32 rounding through a
# few dozen layers is 1e-7-1e-5 of it): a near-tie flips either way, and a
# flip moved a step's output by up to 5.5e-3 on the card (PERF.md,
# Findings)
TIE_TOL = 1e-5
# the facade's (x, y) clicks on 480x854: on the first object, on the
# second (negative), on the first again
TRACK_CLICKS = ((240.0, 200.0), (600.0, 120.0), (255.0, 215.0))
TRACK_LABELS = (1, 0, 1)
TRACK_INPAINT = dict(ratio=1.0, dilate_radius=4, raft_iter=20,
                     subvideo_length=80, neighbor_length=10, ref_stride=10)
# K1 and K2's fp32 kernels by name in a profiler trace (the bf16 forms'
# names end in _bf16_kernel)
K1_KERNEL = re.compile(r"corr_lookup_moenc_kernel")
K2_KERNEL = re.compile(r"corr_pyramid_build_kernel")


def _track_clip(T: int, H: int, W: int, seed: int):
    """A smooth textured background panning 2 px a frame, a red disk
    moving right and a green textured box moving down-left (placed for
    480x854, scaled to H x W); (frames (T, H, W, 3) uint8, the first
    frame's masks (2, H, W))."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    y, x = y * 480 / H, x * 854 / W
    bg = np.stack([110 + 50 * np.sin(x / (31 + 7 * c) + c)
                   * np.cos(y / (23 + 5 * c)) for c in range(3)], -1)
    tex = rng.normal(0, 12, (H, W, 3)).astype(np.float32)
    frames, masks = [], None
    for t in range(T):
        img = np.roll(bg + tex, 2 * t, axis=1)
        disk = (x - (240 + 6 * t)) ** 2 + (y - 210) ** 2 < 70 ** 2
        box = (abs(x - (620 - 4 * t)) < 80) & (abs(y - (150 + 3 * t)) < 55)
        img[disk] = (220, 60, 50) + tex[disk] * 0.5
        img[box] = (40, 190, 90) + tex[box]
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
        if t == 0:
            masks = np.stack([disk & ~box, box]).astype(np.float32)
    return np.stack(frames), masks


def _cutie_model(seed: int):
    """The release's Cutie on the CPU, seeded: `seeded_init_(fan_in_scaled
    =True)` over a meta-built model, every batch-norm and LayerNorm weight
    1 + N(0, 0.1^2) (at N(0, 0.1^2) the features fade through the trunks
    and the masks come out one sign), and its key projection scaled:
    d_proj x0.05 (shrinkage ~1), key_proj x3. At the JAX parity test's
    x0.3 the affinity over the top 30 tokens is nearly flat here, so a
    near-tie at the 30th token moves a pixel's readout as much as any
    token does (two correct fp32 tracks parted by 0.695, PERF.md,
    Findings); at x3 it is spread but not flat, most pixels' top weight still
    below 0.9 (the phase checks it)."""
    import torch
    from propainter_tpu_torch.models.cutie import CUTIE, CutieConfig
    from propainter_tpu_torch.models.layers import FrozenBatchNorm
    from propainter_tpu_torch.weights import seeded_init_

    with torch.device("meta"):
        model = CUTIE(CutieConfig())
    model = seeded_init_(model.to_empty(device="cpu"), seed,
                         fan_in_scaled=True).eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, FrozenBatchNorm)):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=gen))
        kp = model.key_proj
        kp.d_proj.weight.mul_(0.05)
        kp.d_proj.bias.mul_(0.05)
        kp.key_proj.weight.mul_(3.0)
    return model


# CutieCore's state between steps
CORE_STATE = ("curr_ti", "last_mem_ti", "engaged", "mem_key",
              "mem_shrinkage", "mem_value", "perm_tokens", "obj_v",
              "sensory", "last_mask")


def _core_state(core) -> dict:
    """A copy of `core`'s memory and counters on the CPU."""
    import torch

    return {k: (v.cpu().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in ((k, getattr(core, k)) for k in CORE_STATE)}


def _timed_parts(core, marks: list) -> None:
    """Wrap `core`'s model passes with CUDA events, appending (part, start,
    end) to `marks`: encode (encode_image, transform_key), read (the
    top-k readout and read_first), segment, write (_add_memory)."""
    import torch

    def wrap(obj, name, part):
        fn = getattr(obj, name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks.append((part, start, end))
            return out

        setattr(obj, name, timed)

    wrap(core.model, "encode_image", "encode")
    wrap(core.model, "transform_key", "encode")
    wrap(core, "_read_visual", "read")
    wrap(core.model, "read_first", "read")
    wrap(core.model, "segment", "segment")
    wrap(core, "_add_memory", "write")


def _margin_sure(prob, tol: float):
    """Pixels whose winning probability leads the next by more than tol."""
    import numpy as np

    top2 = np.sort(prob, axis=0)[-2:]
    return top2[1] - top2[0] > tol


def _topk_inversion(sim, idx):
    """How far the token sets `idx` (..., k) are from a top-k of `sim`
    (..., N) along the last axis: the largest value left out less the
    smallest taken, 0 where none left out is larger. A token dropped from
    the top counts as much as one taken from below."""
    left = sim.scatter(-1, idx, float("-inf")).max(dim=-1).values
    return (left - sim.gather(-1, idx).min(dim=-1).values).clamp_min(0)


def _foreground_margin(logits, selector):
    """(each object's distance from `_aux_mask`'s foreground boundary, the
    aggregated logits (B, N + 1, H * W)): object n is foreground where its
    aggregated logit is the max, so its margin is that logit against the
    largest other channel, background included, whichever side it is on."""
    import torch
    from propainter_tpu_torch.models.cutie import aggregate

    B, N = logits.shape[:2]
    prob = torch.sigmoid(logits)
    if selector is not None:
        prob = prob * selector
    agg = aggregate(prob, dim=1).view(B, N + 1, -1)
    top2 = agg.topk(2, dim=1).values
    obj = agg[:, 1:]
    other = torch.where(obj >= top2[:, :1], top2[:, 1:], top2[:, :1])
    return (obj - other).abs(), agg


@contextlib.contextmanager
def _decision_hooks(topk, aux):
    """CutieCore's top-k softmax and the query transformer's `_aux_mask`
    replaced by `topk` and `aux` (same signatures, each given the real
    function first); restored afterwards."""
    from propainter_tpu_torch.demo import cutie_core
    from propainter_tpu_torch.models.cutie import QueryTransformer

    real_topk = cutie_core.topk_softmax
    real_aux = QueryTransformer._aux_mask
    cutie_core.topk_softmax = lambda *a: topk(real_topk, *a)
    QueryTransformer._aux_mask = lambda self, *a: aux(real_aux, self, *a)
    try:
        yield
    finally:
        cutie_core.topk_softmax = real_topk
        QueryTransformer._aux_mask = real_aux


def _track_cutie(frames, masks0, cpu_model, failures: list) -> dict:
    """Cutie over the clip on the GPU twice, eagerly (`cuda_graphs=()`:
    the passes wrap methods a CUDA-graph replay never calls): a timed
    pass (ms a frame and by part, memory tokens, the trim, launches,
    peak) and a checked pass recording the state before each step, each
    read's top-k choice and its affinity's spread; then the same engine
    on the CPU, step by step from the checked pass's states and top-k
    choices."""
    import numpy as np
    import torch
    from propainter_tpu_torch.demo.cutie_core import (CutieCore,
                                                      CutieCoreConfig)

    torch.cuda.reset_peak_memory_stats()
    core = CutieCore(cpu_model.state_dict(), config=CutieCoreConfig(
        **TRACK_CORE), device="cuda", cuda_graphs=())
    marks, tokens, trims = [], [], []
    _timed_parts(core, marks)
    add = core._add_memory

    def counting(*args, **kwargs):
        before = 0 if core.mem_key is None else core.mem_key.shape[-1]
        add(*args, **kwargs)
        tokens.append(core.mem_key.shape[-1])
        hw = args[3].shape[-2] * args[3].shape[-1]
        if before + hw != tokens[-1]:
            trims.append((core.curr_ti, before + hw, tokens[-1]))

    core._add_memory = counting
    _zero_launches()
    frame_ms, parts = [], []
    for t, f in enumerate(frames):
        marks.clear()
        t0 = time.perf_counter()
        core.step(f, masks0 if t == 0 else None)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        split = {}
        for part, start, end in marks:
            split[part] = split.get(part, 0.0) + start.elapsed_time(end)
        parts.append(split)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hw = core.mem_key.shape[-1] // TRACK_CORE["max_mem_frames"]
    for obj, names in ((core.model, ("encode_image", "transform_key",
                                     "read_first", "segment")),
                       (core, ("_read_visual", "_add_memory"))):
        for name in names:
            delattr(obj, name)          # the class's methods again
    kernels = _device_kernels(lambda: core.step(frames[-1]))
    later = frame_ms[1:]
    # frame 1 is the first read (cuDNN's algorithm search); the write runs
    # on every fifth frame
    split = {k: statistics.median(p[k] for p in parts[2:])
             for k in ("encode", "read", "segment")}
    split["write"] = statistics.mean(p["write"] for p in parts[1:]
                                     if "write" in p)
    print(f"  Cutie (release config) {frames.shape[2]}x{frames.shape[1]}, "
          f"2 objects, {len(frames)} frames: {statistics.median(later):.2f} "
          f"ms a frame ({min(later):.2f}-{max(later):.2f}); stream ms (median "
          f"from frame 2; write: mean of the writes): " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in split.items())
          + f"; memory tokens after each write {tokens} ({hw} a frame); "
          f"trims (frame, before, after) {trims}; peak {peak:.2f} GiB; "
          f"K1-K7 launches {sum(launches.values())}")
    print(f"  Cutie device time (one step, torch.profiler): "
          f"{kernels['device_ms']:.2f} ms in {kernels['launches']} launches, "
          f"cuDNN FFT {kernels['fft_launches']} ({kernels['fft_ms']:.2f} "
          f"ms); largest: " + "; ".join(f"{n} {ms:.2f} ms ({c})"
                                       for n, ms, c in kernels["top"]))
    if any(launches.values()):
        failures.append(f"Cutie launched a port kernel: {launches}")
    if not trims or trims[0][0] != 25 or trims[0][2] != 5 * hw:
        failures.append(f"the FIFO trim is not the expected one: {trims}")

    # the checked pass
    core = CutieCore(cpu_model.state_dict(), config=CutieCoreConfig(
        **TRACK_CORE), device="cuda", cuda_graphs=())
    chosen, spread, aux = {}, [], {}

    def record_topk(real, similarity, top_k):
        k = min(top_k, similarity.shape[1])
        chosen[core.curr_ti] = torch.topk(similarity.transpose(1, 2), k,
                                          dim=-1).indices
        aff = real(similarity, top_k)
        spread.append((aff.max(dim=1).values < 0.9).float().mean())
        return aff

    def record_aux(real, qt, logits, selector):
        mask = real(qt, logits, selector)
        aux.setdefault(core.curr_ti, []).append(mask)
        return mask

    probs, before = [], []
    with _decision_hooks(record_topk, record_aux):
        for t, f in enumerate(frames):
            before.append(_core_state(core))
            probs.append(core.step(f, masks0 if t == 0 else None))
    chosen = {t: i.cpu() for t, i in chosen.items()}
    aux = {t: [m.cpu() for m in ms] for t, ms in aux.items()}
    spread = [x.item() for x in spread]
    fg = [float((p.argmax(0) > 0).mean()) for p in probs]
    print(f"  reads with most pixels' top affinity < 0.9: "
          f"{sum(x > 0.5 for x in spread)} of {len(spread)} (shares "
          f"{min(spread):.2f}-{max(spread):.2f}); foreground share a frame "
          f"{min(fg):.3f}-{max(fg):.3f}")
    if not all(0.0 < x < 1.0 for x in fg):
        failures.append("a tracked mask is empty or full")
    if sum(x > 0.5 for x in spread) < len(spread) / 2:
        failures.append("the top-k affinity is near one-hot")

    # the CPU, step by step from the GPU's state before each step and on
    # its two hard decisions (two free-running tracks of random weights
    # part after a few memory frames: PERF.md, Findings), the frames the
    # budget allows, through the first read after the trim (26) where it
    # can
    cpu = CutieCore(cpu_model, config=CutieCoreConfig(**TRACK_CORE),
                    device="cpu")
    ties = dict(topk_pixels=0, topk_worst=0.0, aux_pixels=0, aux_worst=0.0)
    calls: list = []

    def replay_topk(real, similarity, top_k):
        sim = similarity.transpose(1, 2)
        idx = chosen[cpu.curr_ti]
        vals = sim.gather(-1, idx)
        gap = _topk_inversion(sim, idx)
        ties["topk_pixels"] += int((gap > 0).sum())
        ties["topk_worst"] = max(ties["topk_worst"], gap.max().item()
                                 / sim.abs().max().item())
        x = torch.exp(vals - vals.max(dim=-1, keepdim=True).values)
        x = x / x.sum(dim=-1, keepdim=True)
        return torch.zeros_like(sim).scatter_(-1, idx, x).transpose(1, 2)

    def replay_aux(real, qt, logits, selector):
        gpu = aux[cpu.curr_ti][len(calls)]
        calls.append(1)
        own = real(qt, logits, selector)
        B, N, H, W = logits.shape
        diff = (own != gpu).view(B, N, -1, H * W).any(dim=2)
        if diff.any():
            gap, agg = _foreground_margin(logits, selector)
            ties["aux_pixels"] += int(diff.sum())
            ties["aux_worst"] = max(ties["aux_worst"], gap[diff].max().item()
                                    / agg.abs().max().item())
        return gpu

    # each step starts from the GPU's state, so any frame can be checked
    # alone: the first ones, the memory writes at 5 and 25 (the trim) and
    # the reads after them first, then the rest while the budget lasts
    order = [0, 1, 2, 5, 6, 25, 26, 27]
    order += [t for t in range(len(frames)) if t not in order]
    errs, flipped, unsure, t_cpu, checked = [], 0, 0, [], []
    with _decision_hooks(replay_topk, replay_aux):
        for t in order:
            if len(t_cpu) > 2 and (sum(t_cpu) + statistics.mean(t_cpu[1:])
                                   > TRACK_CPU_BUDGET_S):
                break
            for k, v in before[t].items():
                setattr(cpu, k, v)
            calls.clear()
            t0 = time.perf_counter()
            p = cpu.step(frames[t], masks0 if t == 0 else None)
            t_cpu.append(time.perf_counter() - t0)
            checked.append(t)
            errs.append(float(np.abs(p - probs[t]).max()))
            sure = _margin_sure(p, STAGE_REL_TOL)
            flipped += int((p.argmax(0) != probs[t].argmax(0))[sure].sum())
            unsure += int((~sure).sum())
    left = sorted(set(range(len(frames))) - set(checked))
    cut = f"; CUT: frames {left} not checked (CPU budget " \
        f"{TRACK_CPU_BUDGET_S:.0f} s)" if left else ""
    worst = checked[int(np.argmax(errs))]
    print(f"  Cutie GPU vs CPU, each step from the GPU's state and on its "
          f"top-k and foreground decisions, {len(checked)} frames: "
          f"probabilities max {max(errs):.3e} (frame {worst}; limit "
          f"{STAGE_REL_TOL}); masks differ at {flipped} pixels where the "
          f"winner leads by more than {STAGE_REL_TOL} ({unsure} pixels "
          f"within); the CPU's own decisions differ at "
          f"{ties['topk_pixels']} top-k reads and {ties['aux_pixels']} "
          f"foreground pixels, each a tie within {ties['topk_worst']:.1e} / "
          f"{ties['aux_worst']:.1e} of scale (limit {TIE_TOL}); CPU "
          f"{sum(t_cpu):.1f} s{cut}")
    if max(errs) > STAGE_REL_TOL or flipped:
        failures.append("Cutie disagrees with the CPU")
    if 26 not in checked:
        failures.append("the CPU did not reach the read after the trim")
    if max(ties["topk_worst"], ties["aux_worst"]) > TIE_TOL:
        failures.append("the GPU's top-k or foreground decisions are not "
                        "the CPU's up to ties")
    return dict(ms_a_frame=_spread(later), split_ms=split,
                memory_tokens=tokens, tokens_a_frame=hw, trims=trims,
                peak_gib=peak, launches=launches, device=kernels,
                affinity_spread=spread, foreground_share=fg,
                cpu_frames=checked, cpu_s=sum(t_cpu),
                gpu_vs_cpu=dict(zip(checked, errs)),
                topk_ties=ties,
                mask_pixels_flipped=flipped), core


def _cutie_run(core, frames, masks0) -> dict:
    """One track of `core` (its graphs `_RegionTimes`): the probabilities
    a frame, the ms a frame on the host's clock (a step returns its
    probabilities on the host) over every frame after the first
    (`frame`) and after the first FIFO trim (`steady`), and each region's
    mean ms a call."""
    core.clear_memory()
    core.graphs.take()
    probs, ms = [], []
    for t, f in enumerate(frames):
        t0 = time.perf_counter()
        probs.append(core.step(f, masks0 if t == 0 else None))
        ms.append((time.perf_counter() - t0) * 1e3)
    regions = core.graphs.take()
    return dict(probs=probs, ms=ms, frame=statistics.mean(ms[1:]),
                steady=statistics.mean(ms[CUTIE_STEADY:]),
                **{r: statistics.mean(v) for r, v in regions.items()})


def _cutie_graphs(cpu_model, failures: list, smi: str) -> dict:
    """Cutie's three regions from CUDA graphs against eager: two
    `CutieCore`s of the release's Cutie (`cpu_model`'s weights), graphed
    (`CUTIE_REGIONS`) and eager (`cuda_graphs=()`), on 2 objects over
    CUTIE_GRAPH_FRAMES frames of 480x854 (`_track_clip`), each region
    timed by events (`_RegionTimes`): the eager track (the reference, its
    peak memory), the graphed one's first track (its first sights and
    captures: encode 1, read one a memory length, write 1, every key
    captured within it), then REGION_PAIRS alternating pairs, every
    graphed track's probabilities equal to the eager reference bit for
    bit; a second clip (another seed) replayed on the same graphs
    against eager on it, with no new key; one profiled read frame each
    way (the device's busy share); captures, capture s and the graphs'
    GiB (pool and static inputs) against the eager peak; each region's
    and the frame's decision."""
    import torch
    from propainter_tpu_torch.demo.cutie_core import (
        CUTIE_REGIONS, CutieCore, CutieCoreConfig)

    frames, masks0 = _track_clip(CUTIE_GRAPH_FRAMES, *DEMO_FRAME,
                                 seed=TRACK_SEED)
    sd = cpu_model.state_dict()
    cores = _timed_regions({side: CutieCore(
        sd, config=CutieCoreConfig(**TRACK_CORE), device="cuda",
        cuda_graphs=regions) for side, regions in (
            ("eager", ()), ("graphed", CUTIE_REGIONS))})
    graphs = cores["graphed"].graphs
    base = _graph_memory()
    torch.cuda.reset_peak_memory_stats()
    want = _cutie_run(cores["eager"], frames, masks0)
    peak_e = torch.cuda.max_memory_allocated() / 2 ** 30
    first = _cutie_run(cores["graphed"], frames, masks0)
    _same_arrays("Cutie's first graphed track", first["probs"],
                 want["probs"], failures)
    counts, keys = graphs.counts(), graphs.keys()
    expect = dict(encode=1, read=TRACK_CORE["max_mem_frames"], write=1)
    if counts != expect or len(keys) != sum(expect.values()):
        failures.append(f"Cutie's graphs {counts} of {len(keys)} keys, "
                        f"expected {expect}")

    def track(core):
        run = _cutie_run(core, frames, masks0)
        if core is cores["graphed"]:
            _same_arrays("Cutie graphed", run["probs"], want["probs"],
                         failures)
        return {k: v for k, v in run.items() if k != "probs"}

    runs = _pairs(track, cores)
    frames2, masks2 = _track_clip(CUTIE_GRAPH_FRAMES, *DEMO_FRAME,
                                  seed=CUTIE_SECOND_SEED)
    other = [_cutie_run(cores[side], frames2, masks2)["probs"]
             for side in ("graphed", "eager")]
    second_same = _same_arrays("Cutie's second clip", *other, failures)
    if graphs.counts() != counts or graphs.keys() != keys:
        failures.append("Cutie's second clip did not replay only the "
                        "first clip's graphs")
    busy = {}
    for side, core in cores.items():
        core.step(frames[-1])       # frame 60, a memory write
        busy[side] = _busy(lambda: core.step(frames[-2]))   # a read
    for core in cores.values():
        core.clear_memory()         # the graphs of the last track stay
    gib = _graph_memory() - base
    decisions = _decide("Cutie", runs, ("frame", "steady") + CUTIE_REGIONS,
                        smi)
    _check_defaults("CutieCore", CutieCore,
                    {r: decisions[r] for r in CUTIE_REGIONS}, failures)
    med = {k: statistics.median(r[k] for r in runs["graphed"])
           for k in ("frame", "steady") + CUTIE_REGIONS}
    print(f"  Cutie graphed {DEMO_FRAME[1]}x{DEMO_FRAME[0]}, 2 objects, "
          f"{CUTIE_GRAPH_FRAMES} frames: {med['frame']:.2f} ms a frame, "
          f"{med['steady']:.2f} after the first trim (frames "
          f"{CUTIE_STEADY}-{CUTIE_GRAPH_FRAMES - 1}); replays (ms a call) "
          + ", ".join(f"{r} {med[r]:.3f}" for r in CUTIE_REGIONS)
          + f"; eager {statistics.median(r['frame'] for r in runs['eager']):.2f}"
          f" / {statistics.median(r['steady'] for r in runs['eager']):.2f} "
          f"ms; first graphed track {first['frame']:.2f} ms a frame "
          f"(captures); graphs by region {counts}, capture "
          f"{graphs.capture_seconds:.3f} s, graphs' memory {gib:.2f} GiB "
          f"(eager peak allocated {peak_e:.2f} GiB); device busy in a read "
          f"frame graphed {100 * busy['graphed']['share']:.1f}% of "
          f"{busy['graphed']['wall_ms']:.2f} ms ({busy['graphed']['launches']}"
          f" launches), eager {100 * busy['eager']['share']:.1f}% of "
          f"{busy['eager']['wall_ms']:.2f} ms ({busy['eager']['launches']}); "
          f"probabilities graphed = eager bit for bit over every track and "
          f"a second clip (seed {CUTIE_SECOND_SEED}): "
          f"{not any(f.startswith('Cutie') for f in failures)}; on {smi}")
    report = dict(frames=CUTIE_GRAPH_FRAMES, runs=runs, decisions=decisions,
                  first_track_ms=first["frame"], graphs=counts,
                  capture_s=graphs.capture_seconds, graphs_gib=gib,
                  eager_peak_gib=peak_e, busy=busy,
                  second_clip_identical=second_same)
    del cores, graphs
    _graph_memory()
    return report


def _flow_run(tracker, frames, template) -> dict:
    """One track of `tracker` (its graphs `_RegionTimes`): each frame's
    mask and soft mask, the ms a frame on the host's clock over the
    tracked frames (`frame`), and each region's mean ms a call. OpenCV's
    RNG is seeded first: GrabCut's k-means draws from it, so two tracks
    of one process otherwise part by a few pixels."""
    import cv2

    cv2.setRNGSeed(0)
    tracker.clear_memory()
    tracker.graphs.take()
    out, ms = [], []
    for t, f in enumerate(frames):
        t0 = time.perf_counter()
        mask, soft, _ = tracker.track(f, template if t == 0 else None)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append((mask, soft))
    regions = tracker.graphs.take()
    return dict(out=out, ms=ms, frame=statistics.mean(ms[1:]),
                **{r: statistics.mean(v) for r, v in regions.items()})


def _flow_trace(tracker, frame) -> tuple:
    """One more tracked frame of `tracker` under torch.profiler: (K1, K2)
    kernels in the trace, (K1, K2) by the launch counters."""
    _zero_launches()
    with _device_trace() as prof:
        tracker.track(frame)
    n = _read_launches()
    kern = _trace_rows(prof)
    return ((sum(n for name, _, n in kern if K1_KERNEL.search(name)),
             sum(n for name, _, n in kern if K2_KERNEL.search(name))),
            (n["corr_lookup_moenc"], n["corr_pyramid_build"]))


def _track_flow(frames, template, raft, failures: list, smi: str) -> dict:
    """FlowMaskTracker with RAFT in fp32 at raft_iter 20 on the GPU, its
    two regions from CUDA graphs (`FLOW_TRACKER_REGIONS`) against an eager
    twin (`cuda_graphs=()`), each region timed by events
    (`_RegionTimes`): the eager track (the reference), the graphed one's
    first (first sights and captures; its K1 / K2 launches by the
    counters against 20 / 1 a frame), REGION_PAIRS alternating pairs,
    every graphed track's masks and soft masks equal to the eager ones
    bit for bit, each region's and the frame's decision; a replayed
    frame's K1 / K2 in a profiler trace against its counters (20 / 1);
    one pair's flows against the CPU."""
    import numpy as np
    from propainter_tpu_torch.demo.tracking import (FLOW_TRACKER_REGIONS,
                                                    FlowMaskTracker)

    trackers = _timed_regions({side: FlowMaskTracker(
        raft, raft_iter=20, device="cuda", cuda_graphs=regions)
        for side, regions in (("eager", ()),
                              ("graphed", FLOW_TRACKER_REGIONS))})
    graphed = trackers["graphed"]
    want = _flow_run(trackers["eager"], frames, template)
    _zero_launches()
    first = _flow_run(graphed, frames, template)
    launches = _read_launches()
    _same_arrays("the flow tracker's first graphed track", first["out"],
                 want["out"], failures)
    n = len(frames) - 1

    def track(tracker):
        run = _flow_run(tracker, frames, template)
        if tracker is graphed:
            _same_arrays("the flow tracker graphed", run["out"], want["out"],
                         failures)
        return {k: v for k, v in run.items() if k != "out"}

    runs = _pairs(track, trackers)
    traces = [_flow_trace(graphed, frames[-1])]
    if traces[0][0] != traces[0][1]:    # a trace can lose records
        traces.append(_flow_trace(graphed, frames[-2]))
    (k1, k2), counted = traces[-1]
    decisions = _decide("FlowMaskTracker", runs,
                        ("frame",) + FLOW_TRACKER_REGIONS, smi)
    _check_defaults("FlowMaskTracker", FlowMaskTracker,
                    {r: decisions[r] for r in FLOW_TRACKER_REGIONS},
                    failures)
    t0 = time.perf_counter()
    cpu = FlowMaskTracker(raft, raft_iter=20, device="cpu")
    want_flow = cpu._raft_pair(frames[-1], frames[-2])
    t_cpu = time.perf_counter() - t0
    got = graphed._raft_pair(frames[-1], frames[-2])
    errs = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want_flow)]
    area = [float(m.mean()) for m, _ in first["out"]]
    med = {side: {k: statistics.median(r[k] for r in runs[side])
                  for k in ("frame",) + FLOW_TRACKER_REGIONS}
           for side in runs}
    print(f"  FlowMaskTracker (RAFT fp32, raft_iter 20) "
          f"{frames.shape[2]}x{frames.shape[1]}, {n} tracked frames, medians"
          f" (ms): " + "; ".join(
              f"{side} {m['frame']:.2f} a frame, RAFT's pair "
              f"{m['raft_pair']:.2f}, gate {m['gate']:.3f}"
              for side, m in med.items())
          + f"; the rest host: GrabCut and the transfers; mask share "
          f"{min(area):.3f}-{max(area):.3f}; graphs by region "
          f"{graphed.graphs.counts()}, capture "
          f"{graphed.graphs.capture_seconds:.3f} s; masks graphed = eager "
          f"bit for bit {not any(f.startswith('the flow') for f in failures)}"
          f"; K1 / K2 a frame: counters {launches['corr_lookup_moenc'] / n:g}"
          f" / {launches['corr_pyramid_build'] / n:g}, a replayed frame's "
          f"trace {k1} / {k2} against its counters {counted[0]} / "
          f"{counted[1]} (RAFT on a pair batch of 2: 20 / 1); one pair's "
          f"flows GPU vs CPU {max(errs):.3e} of scale (limit "
          f"{STAGE_REL_TOL}; CPU {t_cpu:.1f} s); on {smi}")
    want_l = {k: 0 for k in launches}
    want_l.update(corr_lookup_moenc=20 * n, corr_pyramid_build=n)
    _check_launches("FlowMaskTracker (graphed)", launches, want_l)
    if (k1, k2) != counted or counted != (20, 1):
        failures.append(f"a replayed frame's trace K1 / K2 {k1} / {k2}, "
                        f"counters {counted}")
    if max(errs) > STAGE_REL_TOL:
        failures.append("the flow tracker's flows disagree with the CPU")
    report = dict(ms_a_frame=_spread([r["frame"] for r in runs["graphed"]]),
                  runs=runs, decisions=decisions, medians=med,
                  launches=launches,
                  traces=traces, graphs=graphed.graphs.counts(),
                  capture_s=graphed.graphs.capture_seconds,
                  flow_rel_err=max(errs), cpu_s=t_cpu, mask_share=area)
    del trackers, graphed
    _graph_memory()
    return report


def _facade_want(pipe, frames, masks) -> tuple:
    """What the facade's bf16 inpaint of `masks` launches, and the frames
    and dilated masks the pipeline receives: `ProInpainter.inpaint`'s
    resize to multiples of 8 and dilation, then `_eval_launches`' counts
    (RAFT chunks, flow completion and generator deforms, the stage-4
    plan's K4 calls) in the bf16 forms, every other form 0."""
    import cv2
    import numpy as np
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    T, H, W = masks.shape
    h, w = H // 8 * 8, W // 8 * 8
    fr = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR)
                   for f in frames])
    ms = np.stack([cv2.resize(m.astype(np.uint8), (w, h),
                              interpolation=cv2.INTER_NEAREST)
                   for m in masks])
    dil = np.stack([binary_dilation_cross(m, TRACK_INPAINT["dilate_radius"])
                    for m in ms])
    plan = _stage4_plan(pipe, dil)
    ev = _eval_launches(pipe, T, w, plan, warp_error=False)
    want = {k: 0 for k in _launch_counters()}
    want.update(corr_pyramid_build_bf16=ev["corr_pyramid_build"],
                corr_lookup_moenc_bf16=ev["corr_lookup_moenc"],
                modulated_deform_conv2d_bf16=ev["modulated_deform_conv2d"],
                flash_window_attention_bf16=ev["flash_window_attention"])
    return want, fr, dil


def _facade_kernels() -> dict:
    """The bf16 wrappers the facade's inpaint launches, each with its plain
    version: name -> (wrapper, plain)."""
    from propainter_tpu_torch.ops import corr, deform, flash_attention as fa

    return {
        "corr_pyramid_build_bf16": (corr.corr_pyramid_build_bf16,
                                    corr._corr_pyramid_build_bf16_plain),
        "corr_lookup_moenc_bf16": (corr.corr_lookup_moenc_bf16,
                                   corr._corr_lookup_moenc_bf16_plain),
        "modulated_deform_conv2d_bf16": (
            deform.modulated_deform_conv2d_bf16,
            deform._modulated_deform_conv2d_bf16_plain),
        "flash_window_attention_bf16": (fa.flash_window_attention_bf16,
                                        fa._flash_window_attention_bf16_plain),
    }


def _shape_key(v):
    """Shapes and dtypes of a call's tensors (nested in lists), other
    arguments as they are."""
    import torch

    if isinstance(v, torch.Tensor):
        return tuple(v.shape), str(v.dtype)
    if isinstance(v, (list, tuple)):
        return tuple(_shape_key(x) for x in v)
    return v


def _lead_shape(key):
    """The first tensor's shape in a `_shape_key`."""
    while not (isinstance(key, tuple) and len(key) == 2
               and isinstance(key[1], str)):
        key = key[0]
    return key[0]


@contextlib.contextmanager
def _checked_wrappers(wrappers: dict, found: dict):
    """Each of `wrappers` (name -> (wrapper, plain)) replaced, wherever a
    module of the port binds it, by a call that holds the wrapper's output
    at the first call of each distinct input shape against its plain
    version on the same tensors: found[name][shape key] = (max abs error,
    tolerance), the tolerance BF16_REL_TOL of the plain output's scale as
    in `_compare`.
    A wrapper counts its launch on the name it is bound to in its module,
    so this pass's launches go to the hooks' own counters and the
    wrappers' counts stay as they were; all restored after."""
    import inspect

    def checked(name, real, plain):
        sig = inspect.signature(real)
        params = list(inspect.signature(plain).parameters)

        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            inputs = [bound.arguments[p] for p in params]
            key = _shape_key(inputs)
            seen = found.setdefault(name, {})
            if key not in seen:
                want = plain(*inputs)
                pairs = (list(zip(out, want)) if isinstance(out, list)
                         else [(out, want)])
                err = max((g.float() - w.float()).abs().max().item()
                          for g, w in pairs)
                scale = max([1.0] + [w.float().abs().max().item()
                                     for _, w in pairs])
                seen[key] = (err, BF16_REL_TOL * scale)
            return out

        call.launches = 0
        call.shapes = {}    # K4's forms count by shape too
        return call

    patched = []
    for name, (real, plain) in wrappers.items():
        hook = checked(name, real, plain)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("propainter_tpu_torch"):
                for attr, v in list(vars(mod).items()):
                    if v is real:
                        setattr(mod, attr, hook)
                        patched.append((mod, attr, real))
    try:
        yield
    finally:
        for mod, attr, real in patched:
            setattr(mod, attr, real)


def phase_track(state: dict, smi: str) -> None:
    """The demo's second part at DAVIS's 480x854 with seeded weights
    (`_track_clip`, `_cutie_model`, `_models`, `_sam_model`): Cutie over
    28 frames through its first FIFO trim, eagerly, against the CPU
    (`_track_cutie`), Cutie's CUDA-graph regions against eager over 60
    frames (`_cutie_graphs`), the RAFT flow tracker's against eager
    (`_track_flow`), then `TrackingFacade` end to end on the GPU with its
    owners' default regions: SAM vit_h's first_frame_click, Cutie's
    generator, the bf16 inpaint,
    with K1-K4's bf16 launches against the pipeline's plan
    (`_facade_want`) and every output frame equal to its (resized) input
    outside the dilated mask (the pipeline's compositing keeps those
    pixels: pipeline.generate); seconds a step and the peak memory; then
    the inpaint again, each bf16 kernel against its plain version at each
    of its shapes (`_checked_wrappers`)."""
    import numpy as np
    import torch
    from propainter_tpu_torch.demo.tracking import TrackingFacade
    from propainter_tpu_torch.models.sam import sam_config_registry

    frames, masks0 = _track_clip(TRACK_FRAMES, *DEMO_FRAME, seed=TRACK_SEED)
    failures: list = []
    report: dict = dict(frame=list(DEMO_FRAME), frames=TRACK_FRAMES,
                        core=TRACK_CORE, smi=smi)
    cpu_cutie = _cutie_model(TRACK_SEED)
    report["cutie"], core = _track_cutie(frames, masks0, cpu_cutie,
                                         failures)
    report["cutie_graphs"] = _cutie_graphs(cpu_cutie, failures, smi)
    mods = _models(seed=TRACK_SEED + 2)
    report["flow"] = _track_flow(frames[:TRACK_FLOW_FRAMES], masks0[0],
                                 mods["raft"], failures, smi)

    # the facade: SAM vit_h (the demo phase's seeded model), this Cutie,
    # the seeded inpainting models in bf16
    t0 = time.perf_counter()
    sam = _sam_model(sam_config_registry[DEMO_MODEL](), DEMO_SEED)
    t_sam = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    facade = TrackingFacade(dict(mods, sam=sam, cutie=core.model),
                            precision="bf16", sam_model_type=DEMO_MODEL,
                            device="cuda")
    _zero_launches()
    t0 = time.perf_counter()
    scale = np.array([DEMO_FRAME[1] / 854, DEMO_FRAME[0] / 480], np.float32)
    mask, _, _ = facade.first_frame_click(
        frames[0], np.array(TRACK_CLICKS, np.float32) * scale,
        np.array(TRACK_LABELS, np.int32))
    t_click = time.perf_counter() - t0
    t0 = time.perf_counter()
    masks, _, _ = facade.generator(list(frames), mask)
    t_track = time.perf_counter() - t0
    owner_graphs = dict(sam=facade.segmenter.sam_controler.graphs.counts(),
                        cutie=facade.tracker._core.graphs.counts())
    masks = np.stack(masks)
    seg_launches = _read_launches()
    pipe = facade.inpainter._pipeline(
        TRACK_INPAINT["ref_stride"], TRACK_INPAINT["neighbor_length"],
        TRACK_INPAINT["subvideo_length"], TRACK_INPAINT["raft_iter"])
    want, resized, dilated = _facade_want(pipe, frames, masks)
    _zero_launches()
    t0 = time.perf_counter()
    out = facade.inpaint(frames, masks, **TRACK_INPAINT)
    t_inpaint = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    share = masks.reshape(len(masks), -1).mean(1)
    keep = dilated == 0
    changed = int((out != resized)[keep].sum())
    inside = int((out != resized).any(-1)[~keep].sum())
    print(f"  facade: SAM {DEMO_MODEL} seeded on the CPU in {t_sam:.1f} s; "
          f"first_frame_click (embedding + click) {t_click:.2f} s, mask "
          f"{mask.mean():.1%} of the frame; generator (Cutie, "
          f"{len(frames)} frames) {t_track:.2f} s, mask share a frame "
          f"{share.min():.3f}-{share.max():.3f}; inpaint (bf16, "
          f"{out.shape[2]}x{out.shape[1]}, first call) {t_inpaint:.2f} s; "
          f"peak {peak:.2f} GiB; output pixels changed outside the dilated "
          f"mask {changed}, inside {inside} of {int((~keep).sum())}; the "
          f"demo's graphs by region after the click and the track "
          f"{owner_graphs}; on {smi}")
    _check_launches("facade inpaint (bf16)", launches, want)
    # the same inpaint again, each bf16 kernel held against its plain
    # version at every distinct shape this video gives it, on an eager
    # pipeline of the same configuration: the check reads each kernel's
    # output inside the call, where a CUDA-graph capture has run nothing
    found: dict = {}
    facade.inpainter._pipelines[tuple(TRACK_INPAINT[k] for k in (
        "ref_stride", "neighbor_length", "subvideo_length",
        "raft_iter"))] = _twin(pipe, ())
    with _checked_wrappers(_facade_kernels(), found):
        facade.inpaint(frames, masks, **TRACK_INPAINT)
    kernel_errs = {}
    for name in _facade_kernels():
        seen = found.get(name, {})
        worst = max(seen.values(), key=lambda e: e[0] / e[1],
                    default=(math.inf, 0.0))
        lead = [_lead_shape(k) for k in seen]
        kernel_errs[name] = dict(shapes=lead, max_abs_err=worst[0],
                                 tolerance=worst[1])
        print(f"  facade {name} against its plain version at {len(seen)} "
              f"shapes (first input {', '.join(map(str, lead))}): worst "
              f"max_abs_err {worst[0]:.3e} (tolerance {worst[1]:.3e})")
        if not seen or any(e > tol for e, tol in seen.values()):
            failures.append(f"the facade's {name} disagrees with its plain "
                            f"version, or did not run")
    if any(seg_launches.values()):
        failures.append(f"SAM or Cutie launched a port kernel: "
                        f"{seg_launches}")
    if not (0.0 < share.min() and share.max() < 1.0):
        failures.append("a tracked facade mask is empty or full")
    if out.shape != resized.shape or out.dtype != np.uint8:
        failures.append(f"inpaint output {out.shape} {out.dtype}")
    elif changed or not inside:
        failures.append("the inpaint changed pixels outside the dilated "
                        "mask, or none inside")
    report["facade"] = dict(
        click_s=t_click, track_s=t_track, inpaint_s=t_inpaint, sam_seed_s=t_sam,
        peak_gib=peak, mask_share=[float(share.min()), float(share.max())],
        launches=launches, want=want, outside_changed=changed,
        inside_changed=inside, kernels_vs_plain=kernel_errs,
        graphs=owner_graphs)
    state.setdefault("launches", {})["track"] = {
        k: report["flow"]["launches"][k] + launches[k] for k in launches}
    state["track"] = report
    if failures:
        raise AssertionError("; ".join(failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of "
                         f"{','.join(PHASES + EXTRA_PHASES)}")
    ap.add_argument("--out-dir", default=None,
                    help="also write chip_smoke.json (and profile.txt with "
                         "the profile phase) to this directory")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import propainter_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    # PyTorch's own TF32 flags (the eval phase runs the CLIs under them),
    # then full fp32 for every other phase
    state: dict = {"tf32_defaults": (torch.backends.cudnn.allow_tf32,
                                     torch.backends.cuda.matmul.allow_tf32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = _smi_line()
    print(f"device: {kind}, count {torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}", flush=True)
    records: dict = {}
    failed = []
    for phase in phases:
        if phase == "device":
            continue
        print(f"[{phase}]", flush=True)
        t0 = time.perf_counter()
        try:
            if phase == "build":
                phase_build(state)
            elif phase == "kernels":
                phase_kernels(records, state)
            elif phase == "deform_opt":
                phase_deform_opt(state)
            elif phase == "pipeline":
                phase_pipeline(state, smi)
            elif phase == "graphs":
                phase_graphs(state, smi)
            elif phase == "small":
                phase_small(state)
            elif phase == "cli":
                phase_cli(state, args.out_dir)
            elif phase == "eval":
                phase_eval(state, smi)
            elif phase == "train":
                phase_train(state, smi)
            elif phase == "dist":
                phase_dist(state, smi)
            elif phase == "flow_data":
                phase_flow_data(state, smi)
            elif phase == "demo":
                phase_demo(state, smi)
            elif phase == "track":
                phase_track(state, smi)
            elif phase == "profile":
                phase_profile(state)
            _graph_memory()     # what the phase's pipelines and graphs held
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            failed.append(phase)
        print(f"  [{phase}] {time.perf_counter() - t0:.1f} s", flush=True)

    launches = state.get("launches", {})
    kernels = []
    for key, r in records.items():
        kernels.append(dict(r, launches=launches.get(KERNEL_PATH[key], {})
                            .get(key), eval_launches=launches.get(
                                "eval", {}).get(key),
                            train_launches={
                                stage: launches.get(f"train_{stage}", {})
                                .get(key) for stage in TRAIN_CONFIGS},
                            dist_launches={
                                stage: launches.get(f"dist_{stage}", {})
                                .get(key) for stage in TRAIN_CONFIGS},
                            flow_data={
                                stage: k[key] for stage, k in state.get(
                                    "flow_data", {}).get("kernels", {})
                                .items() if key in k} or None,
                            track_launches=launches.get("track", {})
                            .get(key)))
    for key in ("main_path", "main_path_pallas", "main_path_shard",
                "main_path_bf16", "main_path_bf16_pallas",
                "main_path_bf16_shard", "main_path_bf16_fp32_refine"):
        state.pop(key, None)
    if args.out_dir:
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        report = state.get("profile", {}).pop("report", None)
        if report:
            (out / "profile.txt").write_text("\n".join(report) + "\n")
        (out / "chip_smoke.json").write_text(json.dumps(
            {"smi": smi, "kernels": kernels, **state}, indent=1))
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
