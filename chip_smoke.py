#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`propainter_tpu_torch`) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases build,kernels --out-dir results

Phases:
  device    card name and `nvidia-smi` name / power limit;
  build     compile every CUDA kernel (one nvcc per source, in parallel);
  kernels   each kernel at the main path's shapes against its plain PyTorch
            version on the card (max abs error within a stated tolerance),
            timed beside the plain version and a library yardstick;
  pipeline  `ProPainterPipeline.inpaint_video` at 80 frames of 432x240,
            fp32, full-width models with seeded random weights: output
            shape/dtype, unmasked pixels unchanged, every kernel launched;
  small     a 6-frame 144x160 clip through `ProInpainter` on the GPU
            (kernels) and on the CPU (plain versions), fan-in scaled
            weights: uint8 outputs within 12 max / 0.5 mean LSB, a std of
            at least 10 LSB inside the hole, and the float outputs of
            RAFT, flow completion and one generator window within 1e-3
            of their scale;
  profile   (only when named) one main-path run under torch.profiler:
            device time by kernel, the device's busy share, and host and
            device time by op shape for one RAFT chunk and one generator
            window.

Prints one line per kernel, then the `{"kernels": [...]}` JSON line, the
`nvidia-smi` line, and as the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero, without that line, if any phase fails or there is no GPU.
Imports nothing of JAX or of `propainter_tpu`.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

PHASES = ("device", "build", "kernels", "pipeline", "small")
EXTRA_PHASES = ("profile",)
# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 on CUDA cores
# and HBM3 bandwidth — the denominators of every bound_ms below.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 kernels against their fp32 plain versions: the only differences are
# summation order (up to 2304 terms in K3) and the online softmax in K4, a
# few ulp of the largest term; 1e-4 of the output scale leaves > 10x room.
REL_TOL = 1e-4
# GPU (kernels) vs CPU (plain) on the small clip, uint8 LSB: the fp32
# tolerance of the JAX package's on-chip golden check.
SMALL_MAX_LSB, SMALL_MEAN_LSB = 12, 0.5
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


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _compare(name, got, ref) -> float:
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    ok = err <= REL_TOL * scale
    print(f"  {name}: max_abs_err={err:.3e} (tolerance "
          f"{REL_TOL * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def phase_kernels(records: dict) -> None:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.ops import corr, deform, flash_attention
    from propainter_tpu_torch.ops.warp import coords_grid

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    # ---- K2 + K1: one RAFT chunk at 432x240 (12 pairs x 2 directions)
    B, H8, W8, D = 24, 30, 54, 256
    fmap1, fmap2 = randn(B, H8, W8, D), randn(B, H8, W8, D)
    f1 = fmap1.reshape(B, H8 * W8, D) / math.sqrt(D)
    level0 = torch.bmm(f1, fmap2.reshape(B, H8 * W8, D).transpose(1, 2))
    level0 = level0.reshape(B * H8 * W8, H8, W8).contiguous()
    pyr = corr.corr_pyramid_build(level0, 4)
    ref = corr._corr_pyramid_build_plain(level0, 4)
    err = max(_compare(f"corr_pyramid_build L{i}", a, b)
              for i, (a, b) in enumerate(zip(pyr[1:], ref[1:]), 1))
    ms = _time_ms(lambda: corr.corr_pyramid_build(level0, 4), 20)
    plain_ms = _time_ms(lambda: corr._corr_pyramid_build_plain(level0, 4), 20)
    n_pool = sum(p.numel() for p in pyr[1:])
    bound_ms, bound_by = _bound(_nbytes(*pyr), 4 * n_pool)
    records["corr_pyramid_build"] = dict(
        name="corr_pyramid_build", route="cuda",
        source="propainter_tpu_torch/csrc/corr_pyramid_build.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:63",
        shape=f"level0 {tuple(level0.shape)}", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)

    coords = (coords_grid(B, H8, W8, device=dev) + randn(B, H8, W8, 2, std=3.0)
              ).contiguous()
    w = randn(324, 256, std=0.02)
    bias = randn(256, std=0.02)
    got = corr.corr_lookup_moenc(pyr, coords, w, bias)
    want = corr._corr_lookup_moenc_plain(pyr, coords, w, bias, 4)
    err = _compare("corr_lookup_moenc", got, want)
    ms = _time_ms(lambda: corr.corr_lookup_moenc(pyr, coords, w, bias), 20)
    plain_ms = _time_ms(
        lambda: corr._corr_lookup_moenc_plain(pyr, coords, w, bias, 4), 5)
    # bytes this data needs: the in-range integer taps of each query's
    # 10 x 10 windows (zeros outside are not read), coords, weight, output
    def in_range(c, size):   # in-range taps of c0-4 .. c0+5
        c0 = torch.floor(c)
        return ((c0 + 6).clamp(0, size) - (c0 - 4).clamp(0, size)).clamp(0)

    n_taps = sum(
        (in_range(coords[..., 0] / 2 ** lvl, p.shape[2])
         * in_range(coords[..., 1] / 2 ** lvl, p.shape[1])).sum().item()
        for lvl, p in enumerate(pyr))
    n_q = coords.shape[0] * H8 * W8
    bound_ms, bound_by = _bound(
        4 * n_taps + _nbytes(coords, w, bias, got),
        n_q * (2 * 324 * 256 + 324 * 7))
    records["corr_lookup_moenc"] = dict(
        name="corr_lookup_moenc", route="cuda",
        source="propainter_tpu_torch/csrc/corr_lookup_moenc.cu",
        replaces="propainter_tpu/ops/corr_pallas.py:166",
        shape=f"coords {tuple(coords.shape)}", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None)

    # ---- K3 at both call sites: the generator's feature propagation (the
    # record) and the flow completion's (an extra entry in the record)
    k3 = []
    for Bd, Hd, Wd, C, dg, max_res in ((1, 60, 108, 128, 16, 3.0),
                                       (2, 30, 54, 256, 16, 5.0)):
        x = randn(Bd, Hd, Wd, C)
        off = (max_res * torch.tanh(randn(Bd, Hd, Wd, dg, 9, 2))
               + randn(Bd, Hd, Wd, 1, 1, 2, std=2.0)).contiguous()
        msk = torch.sigmoid(randn(Bd, Hd, Wd, dg, 9))
        wt = randn(3, 3, C, 128, std=0.02)
        bs = randn(128, std=0.02)
        shape = f"x {(Bd, Hd, Wd, C)} dg {dg}"
        got = deform.modulated_deform_conv2d(x, off, msk, wt, bs)
        want = deform._modulated_deform_conv2d_plain(x, off, msk, wt, bs)
        err = _compare(f"modulated_deform_conv2d {shape}", got, want)
        ms = _time_ms(
            lambda: deform.modulated_deform_conv2d(x, off, msk, wt, bs), 20)
        plain_ms = _time_ms(
            lambda: deform._modulated_deform_conv2d_plain(
                x, off, msk, wt, bs), 5)
        bound_ms, bound_by = _bound(
            _nbytes(x, off, msk, wt, bs, got),
            Bd * Hd * Wd * (2 * 9 * C * 128 + 9 * C * 12))
        k3.append(dict(shape=shape, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None))
    records["modulated_deform_conv2d"] = dict(
        name="modulated_deform_conv2d", route="cuda",
        source="propainter_tpu_torch/csrc/deform_conv.cu",
        replaces="propainter_tpu/ops/deform_pallas.py:173", **k3[0],
        flow_completion_site=k3[1])

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
    ms = _time_ms(
        lambda: flash_attention.flash_window_attention(q, k, v, kb, scale), 10)
    plain_ms = _time_ms(
        lambda: flash_attention._flash_window_attention_plain(
            q, k, v, kb, scale), 5)
    mask4 = kb[:, None, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                               scale=scale), 10)
    bound_ms, bound_by = _bound(_nbytes(q, k, v, kb, got),
                                Gp * (4 * Tq * Tk * ch + 5 * Tq * Tk))
    records["flash_window_attention"] = dict(
        name="flash_window_attention", route="cuda",
        source="propainter_tpu_torch/csrc/window_attention.cu",
        replaces="propainter_tpu/ops/flash_attention.py:36",
        shape=f"q {tuple(q.shape)} k {tuple(k.shape)}", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms)
    for r in records.values():
        print(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
              f"bound {r['bound_ms']:.3f} by {r['bound_by']}, library "
              f"{r['library_ms']})")


def _launch_counters():
    from propainter_tpu_torch.ops import corr, deform, flash_attention

    return {
        "corr_pyramid_build": corr.corr_pyramid_build,
        "corr_lookup_moenc": corr.corr_lookup_moenc,
        "modulated_deform_conv2d": deform.modulated_deform_conv2d,
        "flash_window_attention": flash_attention.flash_window_attention,
    }


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


def phase_pipeline(state: dict, smi: str) -> None:
    """The main path at full size, once to warm up (cuDNN plans, lazy
    module loading), then measured; every kernel must launch in the
    measured run."""
    import numpy as np
    import torch

    pipe, frames, flow_masks = _main_path_inputs()
    state["main_path"] = (pipe, frames, flow_masks)
    T, H, W = frames.shape[:3]
    t0 = time.perf_counter()
    pipe.inpaint_video(frames, flow_masks, flow_masks)
    print(f"  warm-up run: {time.perf_counter() - t0:.3f} s")
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    timings: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = np.stack(pipe.inpaint_video(frames, flow_masks, flow_masks,
                                      timings=timings))
    total = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    state["launches"] = launches
    print(f"  launches: {launches}")
    if out.shape != (T, H, W, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    keep = flow_masks == 0
    if not np.array_equal(out[keep], frames[keep]):
        raise AssertionError("unmasked pixels changed")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
    print(f"  pipeline {T}x{W}x{H} fp32: {total:.3f} s, {T / total:.3f} fps "
          f"({stages}) on {smi}")
    state["pipeline"] = dict(seconds=total, fps=T / total, stages=timings)


def phase_profile(state: dict) -> None:
    """One main-path run under torch.profiler: device time by kernel and
    the device's busy share of the wall time (the full tables go to
    `profile.txt` in --out-dir, when given)."""
    from torch.profiler import ProfilerActivity, profile

    if "main_path" not in state:
        pipe, frames, flow_masks = _main_path_inputs()
        pipe.inpaint_video(frames, flow_masks, flow_masks)   # warm-up
    else:
        pipe, frames, flow_masks = state["main_path"]
    timings: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.inpaint_video(frames, flow_masks, flow_masks, timings=timings)
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kern = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    ours = {k: sum(r[1] for r in kern if k + "_kernel" in r[0])
            for k in ("corr_lookup_moenc", "corr_pyramid_build",
                      "deform_conv", "window_attention")}
    lines = [f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
             f"({100 * busy / (wall * 1e3):.1f}%), stages (s): " + ", ".join(
                 f"{k} {v:.3f}" for k, v in timings.items())]
    lines += [f"{ms:10.2f} ms {100 * ms / busy:5.1f}% x{n:<7d} {name[:100]}"
              for name, ms, n in kern]
    report = list(lines)
    for line in lines[:21]:
        print("  " + line)
    print(f"  port kernels (ms): {ours}")

    # one RAFT chunk (13 frames) and one generator window (11 local + 8
    # reference frames) with input shapes: host and device ms per op shape
    import torch

    T, H, W = 19, frames.shape[1], frames.shape[2]
    x = (torch.from_numpy(frames[:T]).cuda().float() / 127.5 - 1)[None]
    m = torch.from_numpy(flow_masks[:T]).cuda().float()[None, ..., None]
    zero_flow = torch.zeros((1, 10, H, W, 2), device="cuda")
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    work = {"RAFT chunk": lambda: pipe.compute_flows(x[:, :13]),
            "generator window": lambda: pipe.inpaint(
                x, (zero_flow, zero_flow), m, m, 11, frame_valid=valid)}
    ops = ("aten::convolution", "aten::linear", "aten::matmul", "aten::bmm",
           "aten::col2im", "aten::im2col")
    for what, fn in work.items():
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
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
        report += lines
        for line in lines[:14]:
            print("  " + line)
    state["profile"] = dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                            kernels_ms=ours, report=report)


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
    """The same small clip and weights on the GPU and on the CPU. The
    weights are fan-in scaled so the inpainted region varies (its spread
    must reach SMALL_MIN_HOLE_STD). The uint8 outputs are held to the
    golden check's limits, and the float outputs of RAFT, flow completion
    and one generator window to STAGE_REL_TOL of their scale."""
    import numpy as np
    from propainter_tpu_torch.api import ProInpainter
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    frames, mask = _synthetic_clip(6, 144, 160, seed=2)
    outs, stages = {}, {}
    for device in ("cpu", "cuda"):
        mods = _models(seed=5, fan_in_scaled=True)
        outs[device] = ProInpainter(mods, device=device).inpaint(
            frames, mask, raft_iter=3, neighbor_length=4, ref_stride=3)
        pipe = ProPainterPipeline(mods["raft"], mods["flowcomp"],
                                  mods["inpaint"],
                                  PipelineConfig(raft_iter=3), device=device)
        stages[device] = _stage_outputs(pipe, frames, mask,
                                        stages.get("cpu"))
    diff = np.abs(outs["cuda"].astype(int) - outs["cpu"].astype(int))
    hole_std = float(outs["cpu"][mask.astype(bool)].std())
    print(f"  small clip GPU vs CPU: max {diff.max()} LSB, mean "
          f"{diff.mean():.4f} LSB (limits {SMALL_MAX_LSB} / "
          f"{SMALL_MEAN_LSB}); std inside the hole {hole_std:.2f} LSB "
          f"(at least {SMALL_MIN_HOLE_STD})")
    stage_err = {}
    for key, want in stages["cpu"].items():
        got = stages["cuda"][key]
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(max(w.abs().max().item() for w in want), 1.0)
        stage_err[key] = err / scale
        print(f"  {key} GPU vs CPU: max abs {err:.3e}, scale {scale:.3f} "
              f"(relative limit {STAGE_REL_TOL})")
    state["small"] = dict(max_lsb=int(diff.max()), mean_lsb=float(diff.mean()),
                          hole_std_lsb=hole_std, stage_rel_err=stage_err)
    if hole_std < SMALL_MIN_HOLE_STD:
        raise AssertionError("the inpainted region is too flat to compare")
    if diff.max() > SMALL_MAX_LSB or diff.mean() > SMALL_MEAN_LSB:
        raise AssertionError("GPU and CPU outputs disagree")
    bad = [k for k, e in stage_err.items() if e > STAGE_REL_TOL]
    if bad:
        raise AssertionError(f"GPU and CPU stages disagree: {bad}")


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
        from propainter_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = _smi_line()
    print(f"device: {kind}, count {torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}", flush=True)
    records: dict = {}
    state: dict = {}
    failed = []
    for phase in phases:
        if phase == "device":
            continue
        print(f"[{phase}]", flush=True)
        t0 = time.perf_counter()
        try:
            if phase == "build":
                times = _build.build()
                print(f"  built {sorted(times)} in "
                      f"{max(times.values(), default=0.0):.1f} s")
            elif phase == "kernels":
                phase_kernels(records)
            elif phase == "pipeline":
                phase_pipeline(state, smi)
            elif phase == "small":
                phase_small(state)
            elif phase == "profile":
                phase_profile(state)
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            failed.append(phase)
        print(f"  [{phase}] {time.perf_counter() - t0:.1f} s", flush=True)

    launches = state.get("launches", {})
    kernels = []
    for key, r in records.items():
        kernels.append(dict(r, launches=launches.get(key)))
    state.pop("main_path", None)
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
