"""The pieces of `chip_smoke.py` that run without a GPU: the build phase's
readers of the compiler's and the disassembler's output and its grids, the
kernels' bounds, and the main path's expected launch counts from the
pipeline's own stage-4 plan."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from propainter_tpu_torch.ops import corr, deform
from propainter_tpu_torch.pipeline import PipelineConfig

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 199 registers, 1552 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, 352 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif
        /*0b30*/                   HMMA.1688.F32.TF32 R24, R176, R8, R24 ;
        /*0b40*/                   HMMA.1688.F32.TF32 R28, R176, R10, R28 ;
        /*0b50*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _Z5otherv
        /*0010*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _Z12wgmma_kernelv
        /*0200*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R88, R152, gdesc[UR8], R88, gsb0 ;
        /*0220*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
"""


def test_ptxas_report_reads_each_entry_function():
    report = chip_smoke._ptxas_report(PTXAS_LOG)
    k4 = report["_ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif"]
    assert k4 == dict(spill_stores=8, spill_loads=4, registers=199,
                      static_smem=1552)
    assert report["_Z5otherv"] == dict(spill_stores=0, spill_loads=0,
                                       registers=12)


def test_sass_counts_per_function():
    """mma.sync assembles to HMMA, wgmma to HGMMA: each count sees only its
    own opcode."""
    k4 = "_ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif"
    assert chip_smoke._sass_counts(SASS, "HMMA") == {
        k4: 2, "_Z5otherv": 0, "_Z12wgmma_kernelv": 0}
    assert chip_smoke._sass_counts(SASS, "HGMMA") == {
        k4: 0, "_Z5otherv": 0, "_Z12wgmma_kernelv": 2}


def test_attention_bounds_at_the_main_path_shape():
    """K4 at q (64, 855), k/v (64, 2380), ch 128: the products three times
    over at 495 TFLOP/s (0.40 ms) bound it, above its bytes (0.03 ms);
    on CUDA cores alone it would be 1.005 ms."""
    Gp, Tq, Tk, ch = 64, 855, 2380, 128
    n_bytes = 4 * Gp * (2 * Tq * ch + 2 * Tk * ch) + 4 * Tk
    b = chip_smoke._tensor_core_bounds(n_bytes, Gp * 4 * Tq * Tk * ch,
                                       Gp * 5 * Tq * Tk)
    assert b["bound_by"] == "operations"
    assert b["bound_basis"] == "operations (3xTF32)"
    assert math.isclose(b["bound_ms"], 3 * Gp * 4 * Tq * Tk * ch / 495e9,
                        rel_tol=1e-9)
    assert math.isclose(b["fp32_bound_ms"], 1.0049, rel_tol=1e-3)
    assert b["fp32_bound_by"] == "operations"


def test_deform_conv_bounds_at_the_main_path_shapes():
    """K3 at both call sites: 3 x 2 * 9 * C * 128 FLOPs per position at 495
    TFLOP/s, 0.0116 ms at both (the generator's 6480 positions at C 128,
    the flow completion's 3240 at C 256), above the bytes and the
    sampling's 9 * C * 12 operations on CUDA cores; fp32 0.030 ms."""
    for n_pos, C in ((60 * 108, 128), (2 * 30 * 54, 256)):
        dg = 16
        n_bytes = 4 * (n_pos * (C + dg * 27 + 128) + 9 * C * 128 + 128)
        b = chip_smoke._tensor_core_bounds(n_bytes, n_pos * 2 * 9 * C * 128,
                                           n_pos * 9 * C * 12)
        assert b["bound_by"] == "operations"
        assert b["bound_basis"] == "operations (3xTF32)"
        assert math.isclose(b["bound_ms"], 0.011583, rel_tol=1e-4)
        assert math.isclose(b["fp32_bound_ms"], 0.0299, rel_tol=2e-3)


def test_corr_lookup_moenc_bounds_at_the_main_path_shape():
    """K1 at one RAFT iteration (24 pair-directions of 30 x 54 queries): 3 x
    2 * 324 * 256 FLOPs per query at 495 TFLOP/s (0.0391 ms) bound it, above
    its bytes (the output alone is 40 MB, 0.012 ms); the fp32 CUDA-core
    bound, with the lerps' 324 * 7 operations, is 0.0976 ms."""
    n_q = chip_smoke.K1_QUERIES
    assert n_q == 38880
    n_bytes = 4 * (n_q * (4 * 100 + 2 + 256) + 324 * 256 + 256)
    b = chip_smoke._tensor_core_bounds(n_bytes, n_q * 2 * 324 * 256,
                                       n_q * 324 * 7)
    assert b["bound_by"] == "operations"
    assert b["bound_basis"] == "operations (3xTF32)"
    assert math.isclose(b["bound_ms"], 0.0391, rel_tol=1e-3)
    assert math.isclose(b["fp32_bound_ms"], 0.0976, rel_tol=1e-3)
    assert b["fp32_bound_by"] == "operations"


def test_tensor_core_launch_grids():
    """The build phase's grids on 132 SMs: K1 1215 32-query tiles (walked by
    its persistent blocks), K4 14 query tiles x 64 problems, K5 twice that
    (two blocks a tile), K3 its position tiles times the wrapper's split
    for 2 resident blocks per SM at each call site; the bf16 forms: K1's
    608 64-query tiles (walked by one persistent block of 1024 threads per
    SM), K3's 64-position tiles times the split of their 64-channel chunks
    for 2 resident blocks per SM (2 at the generator, 4 at the flow
    completion: 204 blocks each), and K4's and K5's 7 tiles of 128 query
    rows x 64 problems on the wgmma tile (one block of 384 threads per SM;
    the launch facts the card reported); K4 and its bf16 form also at the
    bucketed main path's 32 and 16 problems of 855 and (last block) 495
    rows: 14 or 8 64-row tiles, 7 or 4 128-row tiles, a problem."""
    info = {"corr_lookup_moenc_kernel": [2, 93696, 128, 32, 1],
            "window_attention_kernel": [2, 107520, 128, 64, 1],
            "sparse_window_attention_kernel": [2, 107520, 128, 64, 2],
            "deform_conv_kernel": [2, 67584, 128, 64, 8],
            "corr_lookup_moenc_bf16_kernel": [1, 216128, 1024, 64, 1],
            "window_attention_bf16_kernel": [1, 164936, 384, 128, 1],
            "deform_conv_bf16_kernel": [2, 74752, 128, 64, 8],
            "sparse_window_attention_bf16_kernel": [1, 132200, 384, 128, 1]}
    grids = {(symbol, site): grid_of(info[symbol])
             for _, symbol, site, _, _, grid_of
             in chip_smoke._tensor_core_launches(132)}
    assert grids == {
        ("corr_lookup_moenc_kernel", "main path, tiles"): 1215,
        ("window_attention_kernel", "main path"): 14 * 64,
        ("sparse_window_attention_kernel", "main path"): 14 * 2 * 64,
        ("deform_conv_kernel", "generator"): 102 * 2,
        ("deform_conv_kernel", "flow completion"): 51 * 4,
        ("corr_lookup_moenc_bf16_kernel", "bf16 main path, tiles"): 608,
        ("window_attention_bf16_kernel", "bf16 main path"): 7 * 64,
        ("deform_conv_bf16_kernel", "generator, bf16"): 102 * 2,
        ("deform_conv_bf16_kernel", "flow completion, bf16"): 51 * 4,
        ("sparse_window_attention_bf16_kernel", "bf16 main path"): 7 * 64,
        **{("window_attention_kernel",
            f"bucketed, {g} problems x {rows} rows"): tiles * g
           for g, rows, tiles in ((32, 855, 14), (16, 855, 14),
                                  (32, 495, 8), (16, 495, 8))},
        **{("window_attention_bf16_kernel",
            f"bf16 bucketed, {g} problems x {rows} rows"): tiles * g
           for g, rows, tiles in ((32, 855, 7), (16, 855, 7),
                                  (32, 495, 4), (16, 495, 4))}}
    assert grids[("window_attention_bf16_kernel",
                  "bf16 bucketed, 16 problems x 495 rows")] == 64


@pytest.mark.parametrize("n_pos, C, slots, want", [
    (60 * 108, 128, 2 * 132, 2), (2 * 30 * 54, 256, 2 * 132, 4),
    (60 * 108, 128, 3 * 132, 3), (2 * 30 * 54, 256, 3 * 132, 6),
    (60 * 108, 128, 132, 1), (21, 128, 2 * 132, 6)])
def test_k3_bf16_split_fills_the_sms(n_pos, C, slots, want):
    """K3's bf16 form splits the 9 * C / 64 chunks of each 64-position tile
    over the most blocks (up to 8) that divide them evenly and keep the
    grid resident: at both call sites on 132 SMs with 2 resident blocks
    per SM, 204 blocks, more than the SMs and within the 264 slots (3 per
    SM: 306 of 396); with 1 per SM the generator's 102 tiles alone; a
    single partial tile (21 positions) becomes one cluster of 6."""
    split = deform.k3_split(n_pos, C, slots, deform.K3_BF16_CHUNK)
    assert split == want
    chunks = 9 * C // deform.K3_BF16_CHUNK
    assert chunks % split == 0
    assert -(-n_pos // deform.K3_POSITIONS) * split <= slots


@pytest.mark.parametrize("n_query, slots, want", [
    (chip_smoke.K1_QUERIES, 132, 132), (104, 132, 2), (64, 132, 1),
    (chip_smoke.K1_QUERIES, 2 * 132, 264)])
def test_k1_bf16_persistent_grid(n_query, slots, want):
    """K1's bf16 forms launch one persistent block per resident slot, or
    one per 64-query tile when there are fewer: the main path's 608 tiles
    fill the 132 SMs, each block walking 4 or 5 of them."""
    blocks = corr.k1_bf16_grid(n_query, slots)
    assert blocks == want
    tiles = -(-n_query // corr.K1_BF16_QUERIES)
    assert 1 <= blocks <= min(tiles, slots)
    per_block = [len(range(b, tiles, blocks)) for b in range(blocks)]
    assert max(per_block) - min(per_block) <= 1 and sum(per_block) == tiles


def test_deform_conv_bf16_bounds_at_the_main_path_shapes():
    """K3's bf16 form, every tensor bf16: at the generator's 6480 positions
    (C 128) its 9.2 MB at 3.35 TB/s bound it (0.0027 ms), above its
    products (2 * 9 * C * 128 FLOPs a position at 989 TFLOP/s, 0.0019
    ms); at the flow completion's 3240 (C 256) the products do (0.0019
    ms), above its 5.9 MB."""
    for n_pos, C, by, ms in ((60 * 108, 128, "bytes", 0.0027497),
                             (2 * 30 * 54, 256, "operations", 0.0019323)):
        dg = 16
        n_bytes = 2 * (n_pos * (C + dg * 27 + 128) + 9 * C * 128 + 128)
        b = chip_smoke._bf16_bounds(n_bytes, n_pos * 2 * 9 * C * 128,
                                    n_pos * 9 * C * 12)
        assert b["bound_by"] == by
        assert b["bound_basis"] == "bf16 tensor cores"
        assert math.isclose(b["bound_ms"], ms, rel_tol=1e-4)


def test_corr_lookup_moenc_bf16_bound_at_the_main_path_shape():
    """K1's bf16 forms at one RAFT iteration: bytes bound them, the
    in-range bf16 taps, the fp32 output (40 MB) and the coordinates, at
    3.35 TB/s, above the products at 989 TFLOP/s (0.0065 ms). On the grid
    coordinates 229.6 of each query's 400 window taps lie inside its maps
    (level 3 is 3 x 6): 0.01736 ms; moved by N(0, 3^2) pixels, as in the
    smoke's kernel check, 0.0172 ms."""
    from propainter_tpu_torch.ops.warp import coords_grid

    n_q = chip_smoke.K1_QUERIES
    pyr = [SimpleNamespace(shape=(n_q, h, w))
           for h, w in ((30, 54), (15, 27), (7, 13), (3, 6))]
    grid = coords_grid(24, 30, 54)
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
        grid.shape).astype(np.float32)) * 3.0
    for coords, ms in ((grid, 0.017356), (grid + noise, 0.0172)):
        taps = chip_smoke._in_range_taps(pyr, coords)
        n_bytes = (2 * taps + 4 * (2 * n_q + 256 * n_q)
                   + 2 * (324 * 256 + 256))
        b = chip_smoke._bf16_bounds(n_bytes, n_q * 2 * 324 * 256,
                                    n_q * 324 * 10)
        assert b["bound_by"] == "bytes"
        assert math.isclose(b["bound_ms"], ms, rel_tol=2e-3)
    assert chip_smoke._in_range_taps(pyr, grid) == round(229.598148 * n_q)


def test_corr_lookup_bound_at_the_main_path_shape():
    """K7 at one RAFT iteration with every tap in range: 324 outputs, 400
    taps and 2 coordinates of 4 bytes per query, 112.9 MB at 3.35 TB/s
    (0.0337 ms), above its lerps on CUDA cores."""
    n_q = chip_smoke.K1_QUERIES
    ms, by = chip_smoke._bound(4 * n_q * (324 + 400 + 2), n_q * 324 * 7)
    assert by == "bytes"
    assert math.isclose(ms, 0.0337, rel_tol=1e-3)


def _brute_sector_bytes(shapes, coords, elem, sector):
    """Every in-range tap's byte address, as a set of `sector`-byte blocks
    per query and level."""
    total = 0
    for q, (cx, cy) in enumerate(coords.reshape(-1, 2).tolist()):
        for lvl, (H, W) in enumerate(shapes):
            xs = int(min(max(math.floor(cx / 2 ** lvl), -6), W + 4)) - 4
            ys = int(min(max(math.floor(cy / 2 ** lvl), -6), H + 4)) - 4
            total += len({((q * H + y) * W + x) * elem // sector
                          for y in range(max(ys, 0), min(ys + 10, H))
                          for x in range(max(xs, 0), min(xs + 10, W))})
    return sector * total


@pytest.mark.parametrize("elem, sector", [(2, 32), (4, 32), (2, 64)])
def test_sector_bytes_counts_each_window_sector_once(elem, sector):
    """K7's bf16 sector floor counts the 32-byte sectors (or 64-byte
    blocks) of each query's in-range window taps once (rows of the narrow
    levels share them), against every tap's address: a 9 x 27 map of 2
    pairs (odd widths), coordinates near the map and up to 40 pixels off
    it."""
    rng = np.random.default_rng(3)
    shapes = ((9, 27), (4, 13), (2, 6), (1, 3))
    n_q = 2 * 9 * 27
    pyr = [SimpleNamespace(shape=(n_q, h, w)) for h, w in shapes]
    ys, xs = np.meshgrid(np.arange(9), np.arange(27), indexing="ij")
    coords = (np.stack([xs, ys], -1)[None]
              + rng.standard_normal((2, 9, 27, 2)) * 6.0).astype(np.float32)
    coords[0, 0, :3] = [[-40.0, 3.0], [52.0, 47.0], [6.5, -40.0]]
    assert chip_smoke._sector_bytes(pyr, torch.from_numpy(coords), elem,
                                    sector) == _brute_sector_bytes(
        shapes, coords, elem, sector)


def test_corr_lookup_bf16_sector_floor_at_the_main_path_shape():
    """K7's bf16 form at one RAFT iteration on the grid coordinates: the
    in-range taps are 17.85 MB, the sectors that hold them 42.60 MB (2.39
    x; 59.41 MB in 64-byte blocks), so with the coords and the 50.4 MB
    fp32 output the sector floor, 0.0279 ms at 3.35 TB/s, lies above the
    counted bound, 0.0205 ms."""
    from propainter_tpu_torch.ops.warp import coords_grid

    n_q = chip_smoke.K1_QUERIES
    pyr = [SimpleNamespace(shape=(n_q, h, w))
           for h, w in ((30, 54), (15, 27), (7, 13), (3, 6))]
    grid = coords_grid(24, 30, 54)
    out_bytes = 4 * n_q * (324 + 2)
    sectors = chip_smoke._sector_bytes(pyr, grid)
    taps = 2 * chip_smoke._in_range_taps(pyr, grid)
    assert sectors == 42_601_344 and taps == 17_853_552
    assert chip_smoke._sector_bytes(pyr, grid, sector=64) == 59_407_104
    floor_ms = (sectors + out_bytes) / chip_smoke.PEAK_BYTES_PER_S * 1e3
    bound_ms, by = chip_smoke._bound(taps + out_bytes, n_q * 324 * 10)
    assert by == "bytes"
    assert math.isclose(floor_ms, 0.027851, rel_tol=1e-4)
    assert math.isclose(bound_ms, 0.020464, rel_tol=1e-4)


@pytest.fixture(scope="module")
def smoke_plans():
    """The stage-4 plans a full-size pipeline on the CPU builds for the
    smoke clip's masks (80 x 240 x 432, dilated by 4), in the smoke's
    fp32 configurations."""
    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.pipeline import ProPainterPipeline
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    _, mask = chip_smoke._synthetic_clip(80, 240, 432, seed=0)
    flow_masks = np.stack([binary_dilation_cross(m, 4) for m in mask])
    plans = {}
    for name, options in (
            ("flash", {}), ("pallas", dict(attention_impl="pallas")),
            ("shard", dict(shard_inference=True, window_batch=4)),
            ("plain", dict(occupancy_bucketing=False,
                           encoder_carry=False))):
        pipe = ProPainterPipeline(RAFT(), RecurrentFlowCompleteNet(),
                                  InpaintGenerator(),
                                  PipelineConfig(**options), device="cpu")
        plans[name] = (pipe, chip_smoke._stage4_plan(pipe, flow_masks))
    return plans


def test_main_path_launch_counts(smoke_plans):
    """80 frames of 432 x 240: 7 RAFT chunks of 20 iterations (140 lookups,
    K1's or K7's). Stage 4 as the pipeline plans it: 16 windows (6, 11 x
    14 and 10 frames) with 6 6 4 4 4 6 6 6 6 6 8 8 4 4 4 4 of their 16
    attention windows dirty, so buckets of 8 and 4; the 14-window run
    splits into sub-runs of 1, 3, 7 and 3 windows (buckets 8, 4, 8, 4),
    and each sub-run of more than one window carries its encoder features:
    8 references + 6 + 11 + (6 + 3 x 5) + (6 + 7 x 5) + (6 + 3 x 5) + 10
    = 118 frames encoded, where every window encoding its own 11 + 8 was
    298. K4 (or K5) once per block of each of the 16 generator calls, or of
    the 7 batches of window_batch 4 (one a sub-run, two for the 7)."""
    frames = SimpleNamespace(shape=(80, 240, 432, 3))
    pipe, plan = smoke_plans["flash"]
    assert chip_smoke._raft_launches(pipe, frames) == 140
    assert [(sr.l_t, len(sr.windows), sr.bucket, sr.carry)
            for sr in plan.subruns] == [
        (6, 1, 8, None), (11, 1, 8, None), (11, 3, 4, 5), (11, 7, 8, 5),
        (11, 3, 4, 5), (10, 1, 4, None)]
    assert all(sr.masked is not None for sr in plan.subruns)
    assert plan.ref_union == list(range(0, 80, 10))
    counts = chip_smoke._plan_counts(plan)
    assert counts["encoded"] == 118
    assert counts["tokenized"] == 8 + 6 + 11 * 14 + 10
    assert sum(len(w[0]) + len(w[1]) for sr in plan.subruns
               for w in sr.windows) == 298
    for name, calls in (("flash", 16), ("pallas", 16), ("shard", 7),
                        ("plain", 16)):
        pipe, plan = smoke_plans[name]
        assert chip_smoke._plan_counts(plan)["calls"] == calls
        assert chip_smoke._plan_launches(plan, pipe)["calls"] == 8 * calls
    # window_batch 4: no carry; a tail batch is encoded whole
    shard, plain = (chip_smoke._plan_counts(smoke_plans[name][1])
                    for name in ("shard", "plain"))
    assert shard["encoded"] == 8 + 4 * (6 + 11 * (1 + 1 + 2 + 1) + 10)
    assert plain["encoded"] == 8 + 170
    assert [sr.bucket for sr in smoke_plans["plain"][1].subruns] == [None] * 3


def test_k4_calls_of_the_plan(smoke_plans):
    """K4's calls by (problems, query rows), as the plan predicts them: 4
    heads x the bucket; 19 frames' rows (11 local + 8 references) on the
    first 7 blocks of an 11-frame window, its 11 local frames' on the last
    (14 / 6 and 18 / 10 at the ends). The smoke's check passes the run's
    record when it matches (keys from 10 or 9 selected frames) and fails
    on another shape or a missing `K4_BUCKET_SHAPES` entry."""
    pipe, plan = smoke_plans["flash"]
    want = chip_smoke._plan_launches(plan, pipe)
    assert want["shapes"] == {
        (32, 14 * 45): 7, (32, 6 * 45): 1, (32, 855): 8 * 7,
        (32, 495): 8, (16, 855): 6 * 7, (16, 495): 6, (16, 18 * 45): 7,
        (16, 10 * 45): 1}
    assert sum(want["shapes"].values()) == want["calls"] == 128
    record = []
    for (g, rows), n in want["shapes"].items():
        # the last block's rows: 9 selected frames; the others' 4 of 7
        # blocks 10, 3 of 7 blocks 9
        even = 0 if rows in (270, 495, 450) else n * 4 // 7
        record += [[g, rows, keys, count]
                   for keys, count in ((10 * 238, even), (9 * 238, n - even))
                   if count]
    chip_smoke._check_k4_calls({"k4_calls": record}, want)
    bad = [[64 if r[:3] == [32, 855, 2380] else r[0], *r[1:]]
           for r in record]
    with pytest.raises(AssertionError, match="other shapes"):
        chip_smoke._check_k4_calls({"k4_calls": bad}, want)
    short = [[*r[:2], 2380 if r[:3] == [16, 495, 2142] else r[2], r[3]]
             for r in record]
    with pytest.raises(AssertionError, match="not on the main path"):
        chip_smoke._check_k4_calls({"k4_calls": short}, want)


def test_sparse_window_attention_bf16_bound_at_the_main_path_shape():
    """K5's bf16 form at the smoke occupancy's operations (6 dirty windows
    of 16, 9 live frames of 19, 148 valid rolled keys): Q·Kᵀ, half the
    product FLOPs, is one bf16 pass and P·V, the other half, two (p as bf16
    hi + lo), so the operations bound is 1.5 x the product FLOPs at 989
    TFLOP/s, 0.035 ms, above the bytes that occupancy reads."""
    n_head, nW, T, win, P, ch, dirty, Ts = 4, 16, 19, 45, 45, 128, 6, 9
    keys = Ts * (win + 148 + P)
    logits = (dirty * n_head * T * win * keys
              + (nW - dirty) * n_head * T * win * win)
    rows = n_head * (2 * nW * T * win + 2 * (nW - dirty) * T * win
                     + 2 * dirty * Ts * (win + 148) + 2 * Ts * P)
    b = chip_smoke._bf16_bounds(2 * ch * rows, 4 * ch * logits, 5 * logits,
                                pv_passes=2)
    assert b["bound_basis"] == "bf16 tensor cores, 1 + 2 passes"
    assert b["bound_by"] == "operations"
    assert math.isclose(b["bound_ms"], 1.5 * 4 * ch * logits / 989e9,
                        rel_tol=1e-9)
    assert math.isclose(b["bound_ms"], 0.035, rel_tol=0.03)
    one = chip_smoke._bf16_bounds(2 * ch * rows, 4 * ch * logits, 5 * logits)
    assert one["bound_basis"] == "bf16 tensor cores"
    assert math.isclose(b["bound_ms"], 1.5 * one["bound_ms"], rel_tol=1e-9)
