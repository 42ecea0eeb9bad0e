#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`propainter_tpu_torch`) on one GPU.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases build,kernels --out-dir results

Phases:
  device      card name and `nvidia-smi` name / power limit;
  build       compile every CUDA kernel (one nvcc per source, in parallel);
              for the tensor-core kernels K1, K3, K4 and K5 print registers,
              spills and shared memory (`-Xptxas -v`), the HMMA count of
              their SASS, resident blocks per SM and the waves of each
              main-path grid, for K7 (CUDA cores) registers, spills and
              shared memory; fails if a tensor-core kernel has no HMMA
              instruction, or any kernel spills;
  kernels     each kernel at the main path's shapes against its plain
              PyTorch version on the card (max abs error within a stated
              tolerance), timed beside the plain version and a library
              yardstick (K1, K3, K6 and K7 by CUDA-graph replay, K3's, K6's
              and K7's calls being shorter than their host-side launch); K1
              and K7 also at a ragged 8 x 13 map with far-off coordinates,
              beside the reference RAFT's F.grid_sample route (+ addmm for
              K1); K3 also beside the
              unfused K6 + GEMM route and at every cluster split, K3 and
              K6 at a ragged image with far-off coordinates; K4 also at
              ragged shapes (a partial query and key tile, a bias masking
              a whole key tile); K5 at three occupancies and both
              temporal-dilation parities, and A/B against K4 plus branch
              B; the bf16 forms of K1-K4 against their bf16 plain versions
              (two bf16 steps of the output scale), beside the bf16
              library routes (F.grid_sample + addmm for K1, SDPA for K4);
  deform_opt  K6's path: the differentiable deform dispatchers
              (`modulated_deform_conv2d_opt` through K6, `_opt2` through
              K3) forward and backward at both call sites' shapes; values
              and gradients against autograd of the plain version;
  pipeline    `ProPainterPipeline.inpaint_video` at 80 frames of 432x240,
              full-width models with seeded random weights, in four
              configurations on the same weights and clip: fp32 'flash',
              'pallas', and shard_inference with window_batch 4 on the
              card's one-device mesh, and bf16 'flash'; output
              shape/dtype, unmasked pixels unchanged, every kernel of each
              path launched (K1 once per RAFT iteration and K7 never,
              except under shard_inference, the reverse; K5 once per
              transformer block and K4 never under 'pallas'; in bf16 the
              bf16 forms of K1-K4 as often as fp32 'flash' launches K1-K4,
              and no fp32 form), the fp32 outputs within 12 max / 0.5 mean
              LSB of 'flash' (bf16's difference reported, not gated);
  small       a 6-frame 144x160 clip on the GPU (kernels) and on the CPU
              (plain versions), fan-in scaled weights, in the three
              configurations ('flash' through `ProInpainter`): uint8
              outputs within 12 max / 0.5 mean LSB, a std of at least 10
              LSB inside the hole, and the float outputs of RAFT, flow
              completion and one generator window within 1e-3 of their
              scale; and the golden fixture's clip and schedule in bf16
              on the GPU within 24 max / 1.0 mean LSB of fp32 on the CPU;
  cli         the port's CLI on the fixture clip on the GPU, --weights
              random --bf16 --save_frames (the CLI's I/O needs cv2);
  profile     (only when named) the main path under torch.profiler in fp32
              and bf16: device time by kernel, the device's busy share, and
              host and device time by op shape for one RAFT chunk and one
              generator window; the GemmConv2d layers against cuDNN in fp32
              and bf16.

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
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

PHASES = ("device", "build", "kernels", "deform_opt", "pipeline", "small",
          "cli")
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
    """The bounds of a kernel whose products run in 3xTF32 (K3, K4, K5):
    `bound_ms` is "operations (3xTF32)", the larger of the bytes over the
    memory rate and the operations (the products three times over at the
    TF32 tensor-core rate, or the rest on CUDA cores, whichever takes
    longer); `fp32_bound_ms` all operations on CUDA cores, the bound of an
    fp32 kernel."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(3 * product_flops / PEAK_TF32_FLOPS,
                cuda_core_ops / PEAK_FP32_FLOPS) * 1e3
    fp32_ms, fp32_by = _bound(n_bytes, product_flops + cuda_core_ops)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_basis="operations (3xTF32)", fp32_bound_ms=fp32_ms,
                fp32_bound_by=fp32_by)


def _bf16_bounds(n_bytes: float, product_flops: float,
                 cuda_core_ops: float) -> dict:
    """The bounds of a bf16 kernel: the larger of the bytes over the
    memory rate and the operations (the products once at the bf16
    tensor-core rate, or the rest on CUDA cores, whichever takes
    longer)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(product_flops / PEAK_BF16_FLOPS,
                cuda_core_ops / PEAK_FP32_FLOPS) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_basis="bf16 tensor cores")


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


def _tensor_core_launches(n_sm: int) -> list:
    """The main path's launches of the tensor-core kernels: (library,
    kernel symbol, site, launch-info symbol and its int arguments,
    grid(info)), info = {resident blocks per SM, dynamic shared memory
    bytes, threads per block, rows per block, blocks per row tile}. K1: the
    32-query tiles of one RAFT iteration (its persistent blocks, one per
    resident slot, walk them, so its waves are rounds of tiles); K4 and
    K5: 16 windows x 4 heads of 855 query rows; K3: each call site's
    positions in 64-position tiles, times the cluster split the wrapper
    picks for this card's resident blocks."""
    from propainter_tpu_torch.ops import deform

    def attention_grid(info):
        return -(-855 // info[3]) * info[4] * 64

    launches = [("corr_lookup_moenc", "corr_lookup_moenc_kernel",
                 "main path, tiles", "corr_lookup_moenc_launch_info", (),
                 lambda info: -(-K1_QUERIES // info[3]))]
    launches += [(lib, f"{lib}_kernel", "main path", f"{lib}_launch_info",
                  (), attention_grid)
                 for lib in ("window_attention", "sparse_window_attention")]
    for site, n_pos, C, cg in DEFORM_SITES:
        launches.append((
            "deform_conv", "deform_conv_kernel", site,
            "modulated_deform_conv2d_launch_info", (cg,),
            lambda info, n=n_pos, c=C: -(-n // info[3]) * deform.k3_split(
                n, c, n_sm * info[0])))
    # the bf16 forms: one block per row tile
    launches += [
        ("corr_lookup_moenc", "corr_lookup_moenc_bf16_kernel",
         "bf16 main path", "corr_lookup_moenc_bf16_launch_info", (),
         lambda info: -(-K1_QUERIES // info[3])),
        ("window_attention", "window_attention_bf16_kernel",
         "bf16 main path", "window_attention_bf16_launch_info", (),
         attention_grid)]
    for site, n_pos, C, cg in DEFORM_SITES:
        launches.append((
            "deform_conv", "deform_conv_bf16_kernel", f"{site}, bf16",
            "modulated_deform_conv2d_bf16_launch_info", (cg,),
            lambda info, n=n_pos: -(-n // info[3])))
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
    K3, K4, K5): registers, spills and shared memory, the tensor-core (HMMA)
    instructions of their SASS, resident blocks per SM and the waves of
    each main-path grid on this card's SMs; and on K7 (CUDA cores only)
    registers, spills and shared memory. Fails if a tensor-core kernel has
    no HMMA instruction, or fits no block on an SM, or any of them
    spills."""
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
            hmma = sum(n for fn, n in
                       _sass_counts(_build.sass(lib), "HMMA").items()
                       if symbol in fn)
            report[symbol] = dict(ptxas=ptxas, hmma=hmma, sites={})
            for fn, r in ptxas.items():
                print(f"  {fn}: {r.get('registers')} registers, "
                      f"{r.get('spill_stores')} B spill stores, "
                      f"{r.get('spill_loads')} B spill loads, "
                      f"{r.get('static_smem', 0)} B static shared memory")
            print(f"  {symbol}: {hmma} HMMA instructions")
            if not ptxas:
                failures.append(f"{symbol}: no -Xptxas -v report")
            if hmma == 0:
                failures.append(f"{symbol}: no HMMA instruction")
            if any(r.get("spill_stores", 0) for r in ptxas.values()):
                failures.append(f"{symbol}: spills")
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
    # K7 runs on CUDA cores: registers, spills and shared memory only
    ptxas = {fn: r for fn, r in
             _ptxas_report(_build.build_log("corr_lookup")).items()
             if "corr_lookup_kernel" in fn}
    report["corr_lookup_kernel"] = dict(ptxas=ptxas)
    for fn, r in ptxas.items():
        print(f"  {fn}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores, "
              f"{r.get('spill_loads')} B spill loads, "
              f"{r.get('static_smem', 0)} B static shared memory")
    if not ptxas:
        failures.append("corr_lookup_kernel: no -Xptxas -v report")
    if any(r.get("spill_stores", 0) for r in ptxas.values()):
        failures.append("corr_lookup_kernel: spills")
    state["build"] = report
    if failures:
        raise AssertionError("; ".join(failures))


def phase_kernels(records: dict) -> None:
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.ops import corr, deform, flash_attention

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

    records["corr_lookup_moenc"] = _check_k1(randn, pyr)
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
    ms = _time_ms(
        lambda: flash_attention.flash_window_attention(q, k, v, kb, scale), 10)
    plain_ms = _time_ms(
        lambda: flash_attention._flash_window_attention_plain(
            q, k, v, kb, scale), 5)
    mask4 = kb[:, None, None, :]
    library_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                               scale=scale), 10)
    records["flash_window_attention"] = dict(
        name="flash_window_attention", route="cuda",
        source="propainter_tpu_torch/csrc/window_attention.cu",
        replaces="propainter_tpu/ops/flash_attention.py:36",
        shape=f"q {tuple(q.shape)} k {tuple(k.shape)}", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **_tensor_core_bounds(_nbytes(q, k, v, kb, got),
                              Gp * 4 * Tq * Tk * ch, Gp * 5 * Tq * Tk))
    records["sparse_window_attention"] = _check_k5(randn)
    records.update(_check_bf16(randn, level0))
    for r in records.values():
        for site, rr in (("", r), (" (flow completion)",
                                   r.get("flow_completion_site"))):
            if rr is None:
                continue
            tc = (f" on tensor cores in 3xTF32, fp32 "
                  f"{rr['fp32_bound_ms']:.4f}" if "fp32_bound_ms" in rr
                  else " on bf16 tensor cores"
                  if rr.get("bound_basis") == "bf16 tensor cores" else "")
            eager = (f", eager {rr['eager_ms']:.4f} ms" if "eager_ms" in rr
                     else "")
            print(f"  {r['name']}{site}: {rr['ms']:.4f} ms{eager} (plain "
                  f"{rr['plain_ms']:.3f}, bound {rr['bound_ms']:.4f} by "
                  f"{rr['bound_by']}{tc}, library {rr['library_ms']})")


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


def _check_k5(randn) -> dict:
    """K5 at one transformer block of one generator window of the 'pallas'
    path: 16 windows x 4 heads, 19 frames (11 local, 8 reference, the last
    one padded), 45 tokens per window, 45 pooled tokens. Against its plain
    version at the smoke clip's occupancy, all clean and all dirty, for
    both temporal-dilation parities; timed beside its plain version,
    F.scaled_dot_product_attention over the dirty problems (the yardstick)
    and the 'flash' path's K4 plus branch B on the same inputs (the A/B)."""
    import torch
    import torch.nn.functional as F
    from propainter_tpu_torch.models.propainter import _valid_rolled_indices
    from propainter_tpu_torch.ops import attention, flash_attention

    dev = torch.device("cuda")
    n_head, nW, T, win, P, ch = 4, 16, 19, 45, 45, 128
    BH = n_head
    wq, wk, wv = (randn(BH, nW, T, win, ch) for _ in range(3))
    rk, rv = (randn(BH, nW, 4, T, win, ch) for _ in range(2))
    pk, pv = (randn(BH, T, P, ch) for _ in range(2))
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

    def k5(occ, fsel):
        return attention.sparse_window_attention(*inputs, occ, fsel, n_head)

    err = 0.0
    for name, occ in occs.items():
        for parity in (0, 1):
            fsel = (static_sel(parity) & frame_valid)[None]
            err = max(err, _compare(
                f"sparse_window_attention {name}, parity {parity}",
                k5(occ, fsel), attention._sparse_window_attention_plain(
                    *inputs, occ, fsel, n_head)))
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
        return _tensor_core_bounds(n_bytes, 4 * ch * logits, 5 * logits)

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

        _compare(f"SDPA yardstick vs K5, {int(dirty.numel())} dirty "
                 f"windows", library(),
                 k5(occ, fsel)[:, dirty].reshape(q_d.shape))
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

    timing = {}
    for name, occ in occs.items():
        _compare(f"K4 + branch B vs K5, {name}", flash_form(occ),
                 k5(occ, fsel))
        timing[name] = dict(
            ms=_time_ms(lambda: k5(occ, fsel), 10),
            k4_plus_branch_b_ms=_time_ms(lambda: flash_form(occ), 10),
            library_ms=(sdpa_ms(occ) if occ.max() > 0 else None),
            dirty_windows=int((occ > 0).sum()), **bound(occ))
        r = timing[name]
        print(f"  sparse_window_attention {name} "
              f"({r['dirty_windows']}/{nW} dirty): K5 {r['ms']:.3f} ms, K4 "
              f"+ branch B {r['k4_plus_branch_b_ms']:.3f} ms, SDPA over the "
              f"dirty windows {r['library_ms']}, bound {r['bound_ms']:.3f} "
              f"by {r['bound_by']} (3xTF32; fp32 {r['fp32_bound_ms']:.3f})")
    plain_ms = _time_ms(lambda: attention._sparse_window_attention_plain(
        *inputs, occs["smoke"], fsel, n_head), 3)
    smoke = timing.pop("smoke")
    return dict(
        name="sparse_window_attention", route="cuda",
        source="propainter_tpu_torch/csrc/sparse_window_attention.cu",
        replaces="propainter_tpu/ops/attention.py:42",
        shape=f"windows {tuple(wq.shape)} rolled {tuple(rk.shape)} pooled "
              f"{tuple(pk.shape)}, smoke occupancy "
              f"{smoke['dirty_windows']}/{nW} dirty",
        max_abs_err=err, plain_ms=plain_ms, **smoke, occupancies=timing)


def _check_bf16(randn, level0) -> dict:
    """The bf16 forms of K2, K1, K3 and K4 at the main path's shapes
    against their bf16 plain versions (BF16_REL_TOL), timed beside the
    plain version and the bf16 library route (`_k1_library` over the bf16
    levels for K1, F.scaled_dot_product_attention for K4); K1, K3 also at ragged,
    far-off cases and K4 at ragged shapes, K3 at every group width."""
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
    small, far = _far_off_case(randn)
    small = [p.to(bf).contiguous() for p in small]
    err = max(err, _compare(
        "corr_lookup_moenc_bf16 maps 8 x 13, coordinates to 40 px outside",
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

    # ---- K3: both call sites, then ragged images at every group width
    k3 = []
    for Bd, Hd, Wd, C, dg, max_res in ((1, 60, 108, 128, 16, 3.0),
                                       (2, 30, 54, 256, 16, 5.0)):
        x, off, msk, wt, bs = (t.to(bf).contiguous() for t in _deform_inputs(
            randn, Bd, Hd, Wd, C, dg, max_res))
        shape = f"x {(Bd, Hd, Wd, C)} dg {dg}, bf16"

        def run_k3():
            return deform.modulated_deform_conv2d_bf16(x, off, msk, wt, bs)

        def plain_k3():
            return deform._modulated_deform_conv2d_bf16_plain(x, off, msk,
                                                              wt, bs)

        got = run_k3()
        err = _compare(f"modulated_deform_conv2d_bf16 {shape}", got,
                       plain_k3(), BF16_REL_TOL)
        n_pos = Bd * Hd * Wd
        k3.append(dict(shape=shape, max_abs_err=err, ms=_graph_ms(run_k3),
                       eager_ms=_time_ms(run_k3, 50),
                       plain_ms=_time_ms(plain_k3, 5), library_ms=None,
                       **_bf16_bounds(_nbytes(x, off, msk, wt, bs, got),
                                      n_pos * 2 * 9 * C * 128,
                                      n_pos * 9 * C * 12)))
    for C, dg in ((128, 32), (128, 16), (256, 16), (128, 4)):
        x, off, msk, wt, bs = _deform_inputs(randn, 1, 5, 13, C, dg, 3.0)
        x, off, msk, wt, bs = (t.to(bf).contiguous()
                               for t in (x, off * 8.0, msk, wt, bs))
        k3[0]["max_abs_err"] = max(k3[0]["max_abs_err"], _compare(
            f"modulated_deform_conv2d_bf16 x (1, 5, 13, {C}) dg {dg}, "
            f"offsets to 40 px",
            deform.modulated_deform_conv2d_bf16(x, off, msk, wt, bs),
            deform._modulated_deform_conv2d_bf16_plain(x, off, msk, wt, bs),
            BF16_REL_TOL))
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
    qr, kr, vr = (randn(1, 3, T_, ch).to(bf) for T_ in (130, 70, 70))
    kbr = torch.zeros(1, 70, device=level0.device)
    kbr[:, 32:64] = flash_attention.NEG_INF
    for b_, what in ((kbr, "bias"), (None, "no bias")):
        err = max(err, _compare(
            f"flash_window_attention_bf16 Tq 130 Tk 70 ({what})",
            flash_attention.flash_window_attention_bf16(qr, kr, vr, b_,
                                                        scale),
            flash_attention._flash_window_attention_bf16_plain(
                qr, kr, vr, b_, scale), BF16_REL_TOL))
    mask4 = kb[:, None, None, :].to(bf)
    records["flash_window_attention_bf16"] = dict(
        name="flash_window_attention_bf16", route="cuda",
        source="propainter_tpu_torch/csrc/window_attention.cu",
        replaces="propainter_tpu/ops/flash_attention.py:36",
        shape=f"q {tuple(q.shape)} k {tuple(k.shape)}, bf16",
        max_abs_err=err,
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
    return records


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
    }


# the driven run whose launches each kernel's record reports: the main
# path in its four configurations ('flash', 'pallas', 'shard', the
# shard_inference layout, and 'bf16', precision='bf16' under 'flash'),
# and the deform dispatchers
KERNEL_PATH = {"corr_pyramid_build": "flash", "corr_lookup_moenc": "flash",
               "corr_lookup": "shard",
               "modulated_deform_conv2d": "flash",
               "flash_window_attention": "flash",
               "sparse_window_attention": "pallas",
               "deform_sample": "deform_opt",
               "corr_pyramid_build_bf16": "bf16",
               "corr_lookup_moenc_bf16": "bf16",
               "modulated_deform_conv2d_bf16": "bf16",
               "flash_window_attention_bf16": "bf16"}


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


def _measured_run(pipe, frames, flow_masks, smi: str):
    """One main-path run with the launch counts zeroed just before and
    read just after: (uint8 output, launches, stage summary)."""
    import numpy as np
    import torch

    T, H, W = frames.shape[:3]
    _zero_launches()
    timings: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = np.stack(pipe.inpaint_video(frames, flow_masks, flow_masks,
                                      timings=timings))
    total = time.perf_counter() - t0
    launches = _read_launches()
    cfg = pipe.config
    impl = (f"shard_inference, window_batch {cfg.window_batch}, mesh of "
            f"{len(pipe.mesh)}" if cfg.shard_inference
            else f"attention_impl={cfg.attention_impl!r}")
    print(f"  launches ({impl}): {launches}")
    if out.shape != (T, H, W, 3) or out.dtype != np.uint8:
        raise AssertionError(f"output {out.shape} {out.dtype}")
    keep = flow_masks == 0
    if not np.array_equal(out[keep], frames[keep]):
        raise AssertionError("unmasked pixels changed")
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
    print(f"  pipeline {T}x{W}x{H} {cfg.precision}, {impl}: "
          f"{total:.3f} s, {T / total:.3f} fps ({stages}) on {smi}")
    return out, launches, dict(seconds=total, fps=T / total, stages=timings)


def _raft_launches(pipe, frames) -> int:
    """RAFT lookups of one run: one per iteration of each clip chunk."""
    from propainter_tpu_torch.pipeline import get_short_clip_len

    T, W = frames.shape[0], frames.shape[2]
    return len(range(0, T, get_short_clip_len(W))) * pipe.config.raft_iter


def phase_pipeline(state: dict, smi: str) -> None:
    """The main path at full size in its three configurations on the same
    weights and clip ('flash', 'pallas', and shard_inference with
    window_batch 4 on the card's one-device mesh), each once to warm up
    (cuDNN plans, lazy module loading), then measured; every kernel of each
    path must launch in its measured run, K1 under 'flash' and 'pallas' and
    K7 under shard_inference once per RAFT iteration, the other never."""
    import numpy as np

    pipe, frames, flow_masks = _main_path_inputs()
    want_lookups = _raft_launches(pipe, frames)
    state["main_path"] = (pipe, frames, flow_masks)
    t0 = time.perf_counter()
    pipe.inpaint_video(frames, flow_masks, flow_masks)
    print(f"  warm-up run: {time.perf_counter() - t0:.3f} s")
    out, launches, state["pipeline"] = _measured_run(pipe, frames,
                                                     flow_masks, smi)
    state.setdefault("launches", {})["flash"] = launches
    missing = [k for k, path in KERNEL_PATH.items()
               if path == "flash" and launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if (launches["corr_lookup_moenc"] != want_lookups
            or launches["corr_lookup"] != 0):
        raise AssertionError(f"'flash' must launch K1 {want_lookups} times "
                             f"and K7 never: {launches}")

    sparse = _pallas_pipeline(pipe)
    state["main_path_pallas"] = sparse
    sparse.inpaint_video(frames, flow_masks, flow_masks)    # warm-up
    out_p, launches, state["pipeline_pallas"] = _measured_run(
        sparse, frames, flow_masks, smi)
    state["launches"]["pallas"] = launches
    # one K5 launch per transformer block of every generator window
    n_windows = len(range(0, frames.shape[0],
                          sparse.config.neighbor_length // 2))
    want_k5 = n_windows * len(sparse.inpaint.transformers.transformer)
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
    shard.inpaint_video(frames, flow_masks, flow_masks)    # warm-up
    out_s, launches, state["pipeline_shard"] = _measured_run(
        shard, frames, flow_masks, smi)
    state["launches"]["shard"] = launches
    # one K4 launch per transformer block of every window batch
    want_k4 = (_window_batches(frames.shape[0], shard)
               * len(shard.inpaint.transformers.transformer))
    diff = np.abs(out_s.astype(int) - out.astype(int))
    print(f"  shard_inference vs 'flash' output: max {diff.max()} LSB, mean "
          f"{diff.mean():.4f} LSB (limits {SMALL_MAX_LSB} / "
          f"{SMALL_MEAN_LSB}); K7 launches {launches['corr_lookup']} (want "
          f"{want_lookups}), K1 launches {launches['corr_lookup_moenc']} "
          f"(want 0), K4 launches {launches['flash_window_attention']} (want "
          f"{want_k4})")
    state["pipeline_shard"].update(max_lsb_vs_flash=int(diff.max()),
                                   mean_lsb_vs_flash=float(diff.mean()))
    missing = [k for k in ("corr_pyramid_build", "modulated_deform_conv2d")
               if launches[k] == 0]
    if (missing or launches["corr_lookup"] != want_lookups
            or launches["corr_lookup_moenc"] != 0
            or launches["flash_window_attention"] != want_k4
            or launches["sparse_window_attention"] != 0):
        raise AssertionError(f"the shard_inference path launched {launches}")
    if diff.max() > SMALL_MAX_LSB or diff.mean() > SMALL_MEAN_LSB:
        raise AssertionError("shard_inference and 'flash' outputs disagree")

    bf16 = _bf16_pipeline(pipe)
    state["main_path_bf16"] = bf16
    bf16.inpaint_video(frames, flow_masks, flow_masks)    # warm-up
    out_b, launches, state["pipeline_bf16"] = _measured_run(
        bf16, frames, flow_masks, smi)
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


def _window_batches(T: int, pipe) -> int:
    """Stage 4's generator calls: batches of up to window_batch consecutive
    windows of equal length."""
    stride = pipe.config.neighbor_length // 2
    lengths = [min(T, f + stride + 1) - max(0, f - stride)
               for f in range(0, T, stride)]
    runs = [1]
    for a, b in zip(lengths, lengths[1:]):
        if a == b:
            runs[-1] += 1
        else:
            runs.append(1)
    return sum(-(-n // pipe._window_batch) for n in runs)


def _profile_run(pipe, frames, flow_masks, label: str):
    """One main-path run of `pipe` under torch.profiler: (report lines,
    device ms of the port's kernels, wall ms, device busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    timings: dict = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.inpaint_video(frames, flow_masks, flow_masks, timings=timings)
        wall = time.perf_counter() - t0
    kern = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
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
    for line in lines[:21]:
        print("  " + line)
    print(f"  {label} port kernels (ms): {ours}")
    return lines, ours, wall * 1e3, busy


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
        pipe, frames, flow_masks = _main_path_inputs()
        pipe.inpaint_video(frames, flow_masks, flow_masks)   # warm-up
    else:
        pipe, frames, flow_masks = state["main_path"]
    bf16 = state.get("main_path_bf16")
    if bf16 is None:
        bf16 = _bf16_pipeline(pipe)
        bf16.inpaint_video(frames, flow_masks, flow_masks)   # warm-up
    report = []
    runs = {}
    for label, p in (("fp32 'flash'", pipe), ("bf16 'flash'", bf16)):
        lines, ours, wall, busy = _profile_run(p, frames, flow_masks, label)
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
    work = {"RAFT chunk": lambda: pipe.compute_flows(x[:, :13]),
            "generator window": window(pipe.inpaint),
            "generator window ('pallas')": window(sparse.inpaint),
            "RAFT chunk (bf16)": lambda: bf16.compute_flows(x[:, :13]),
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
    if failures:
        raise AssertionError("; ".join(failures))


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
    bf16 on the GPU against the fp32 run on the CPU (the plain versions,
    which the CPU tests hold to the golden within 2 LSB), within the bf16
    golden gate (GOLDEN_BF16_MAX_LSB / GOLDEN_BF16_MEAN_LSB). The golden's
    own weights come from jax.random, which this machine does not have:
    the port's seeded weights of the same scale (N(0, 0.02^2)) stand in."""
    import numpy as np
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    frames, mask = _golden_clip()
    outs = {}
    for device, precision in (("cpu", "fp32"), ("cuda", "bf16")):
        mods = _models(seed=11)
        pipe = ProPainterPipeline(
            mods["raft"], mods["flowcomp"], mods["inpaint"],
            PipelineConfig(ref_stride=3, neighbor_length=4, raft_iter=3,
                           precision=precision), device=device)
        outs[precision] = np.stack(pipe.inpaint_video(frames, mask, mask))
    diff = np.abs(outs["bf16"].astype(int) - outs["fp32"].astype(int))
    print(f"  golden clip: GPU bf16 vs CPU fp32: max {diff.max()} LSB, mean "
          f"{diff.mean():.4f} LSB (limits {GOLDEN_BF16_MAX_LSB} / "
          f"{GOLDEN_BF16_MEAN_LSB})")
    state.setdefault("small", {})["golden_clip_bf16"] = dict(
        max_lsb=int(diff.max()), mean_lsb=float(diff.mean()))
    if (diff.max() > GOLDEN_BF16_MAX_LSB
            or diff.mean() > GOLDEN_BF16_MEAN_LSB):
        return ["golden clip: bf16 on the GPU and fp32 disagree"]
    return []


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
                phase_build(state)
            elif phase == "kernels":
                phase_kernels(records)
            elif phase == "deform_opt":
                phase_deform_opt(state)
            elif phase == "pipeline":
                phase_pipeline(state, smi)
            elif phase == "small":
                phase_small(state)
            elif phase == "cli":
                phase_cli(state, args.out_dir)
            elif phase == "profile":
                phase_profile(state)
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            failed.append(phase)
        print(f"  [{phase}] {time.perf_counter() - t0:.1f} s", flush=True)

    launches = state.get("launches", {})
    kernels = []
    for key, r in records.items():
        kernels.append(dict(r, launches=launches.get(KERNEL_PATH[key], {})
                            .get(key)))
    for key in ("main_path", "main_path_pallas", "main_path_shard",
                "main_path_bf16"):
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
