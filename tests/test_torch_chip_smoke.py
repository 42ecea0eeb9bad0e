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
    rows: 14 or 8 64-row tiles, 7 or 4 128-row tiles, a problem; K4 also
    at the evaluation protocol's 32 problems of 1440 rows (23 tiles)."""
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
        ("window_attention_kernel", "eval, 32 problems x 1440 rows"): 23 * 32,
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


@pytest.fixture(scope="module")
def eval_plans(tmp_path_factory):
    """The evaluation protocol's stage-4 plans (a full-size pipeline on the
    CPU, masks only) for the eval phase's two videos, from the dataset the
    phase writes, read back by the port's `TestDataset`."""
    from propainter_tpu_torch.core.dataset import TestDataset

    root = tmp_path_factory.mktemp("eval_ds")
    chip_smoke._write_eval_dataset(root)
    ds = TestDataset(str(root / "JPEGImages"), str(root / "Annotations"),
                     str(root / "test.json"))
    pipe = chip_smoke._eval_pipeline()
    items = [ds[i] for i in range(len(ds))]
    return pipe, [(it, chip_smoke._stage4_plan(pipe, it["masks"]))
                  for it in items]


def test_eval_launch_counts(eval_plans):
    """The eval phase's `evaluate` (104 and 73 frames at 432 x 240, RAFT
    chunks of 60, --warp_error): 2 chunks a video, each RAFT'd twice (4 K2
    and 80 K1 launches a video); K3 2 x (T - 2) in the unchunked flow
    completion plus 2 x (l_t - 1) a generator call (windows of 11, 9 x 21
    and 14 local frames at 104 frames; 11, 6 x 21, 13 at 73); K4 once per
    block of each generator call, 63 of the 104-frame video's 88 at
    `K4_EVAL_SHAPE`'s 32 problems x 1440 rows (21 local + 11 reference
    frames), whose keys are 16 selected frames of 238."""
    pipe, plans = eval_plans
    assert [(it["video_name"], len(it["frames"])) for it, _ in plans] == \
        list(chip_smoke.EVAL_VIDEOS)
    assert [[(sr.l_t, len(sr.windows)) for sr in plan.subruns]
            for _, plan in plans] == [[(11, 1), (21, 9), (14, 1)],
                                      [(11, 1), (21, 6), (13, 1)]]
    got = [chip_smoke._eval_launches(pipe, len(it["frames"]), 432, plan,
                                     True) for it, plan in plans]
    for g, T, gen in zip(got, (104, 73),
                         (2 * 10 + 9 * 2 * 20 + 2 * 13,
                          2 * 10 + 6 * 2 * 20 + 2 * 12)):
        assert g["corr_pyramid_build"] == 4
        assert g["corr_lookup_moenc"] == 80
        assert g["modulated_deform_conv2d"] == 2 * (T - 2) + gen
        assert g["sparse_window_attention"] == g["corr_lookup"] == 0
        assert sum(g["k4_shapes"].values()) == g["flash_window_attention"]
    assert [g["flash_window_attention"] for g in got] == [88, 64]
    G, rows, keys = chip_smoke.K4_EVAL_SHAPE
    assert got[0]["k4_shapes"][(G, rows)] == 63
    assert rows == (21 + 11) * 45 and keys == 16 * 238
    assert max(got[0]["k4_shapes"], key=lambda s: s[0] * s[1]) == (G, rows)
    record = [[*shape, keys if shape == (G, rows) else 1, n]
              for shape, n in got[0]["k4_shapes"].items()]
    chip_smoke._check_k4_calls({"k4_calls": record},
                               {"shapes": got[0]["k4_shapes"]},
                               (chip_smoke.K4_EVAL_SHAPE,))
    record = [[*r[:2], 1, r[3]] for r in record]
    with pytest.raises(AssertionError, match="not on the main path"):
        chip_smoke._check_k4_calls({"k4_calls": record},
                                   {"shapes": got[0]["k4_shapes"]},
                                   (chip_smoke.K4_EVAL_SHAPE,))


@pytest.mark.parametrize("unchunked", [True, False])
def test_flow_completion_deform_count(unchunked, monkeypatch):
    """`_flow_completion_deforms` against the deform aligns that stage 2
    really runs on the CPU (12 flows of 32 x 32 at subvideo_length 5: three
    chunks of 10, 12 and 7 flows with their 5-flow overlaps, or the whole
    video); and the
    eval-phase counts: 2 x 102 unchunked at 104 frames, 168 + 54 in
    chunks of 80 (`evaluate_flow_completion`'s default)."""
    from propainter_tpu_torch.models import flow_completion

    calls = []
    real = flow_completion.deform_align
    monkeypatch.setattr(flow_completion, "deform_align",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pipe = chip_smoke._eval_pipeline(unchunked=unchunked,
                                     subvideo_length=5)
    torch.manual_seed(0)
    flows = (torch.randn(1, 12, 32, 32, 2), torch.randn(1, 12, 32, 32, 2))
    masks = (torch.rand(1, 13, 32, 32, 1) > 0.5).float()
    with torch.inference_mode():
        pipe.complete_flows(flows, masks)
    assert len(calls) == chip_smoke._flow_completion_deforms(12, pipe.config)
    assert len(calls) == (22 if unchunked else 2 * (9 + 11 + 6))
    assert chip_smoke._flow_completion_deforms(
        103, PipelineConfig(unchunked=True)) == 204
    assert chip_smoke._flow_completion_deforms(103, PipelineConfig()) == 222
    assert chip_smoke._flow_completion_deforms(72, PipelineConfig()) == 142


def test_metrics_file_reader(tmp_path):
    """The eval phase reads the metrics file `cli/evaluate.py` writes."""
    p = tmp_path / "davis_metrics.txt"
    p.write_text("task: video_completion\nvideos: 2\navg s/frame: 0.0500\n"
                 "psnr: 20.1234\nssim: 0.5000\newarp: 0.001000\n"
                 "vfid: 1.2345\n")
    m = chip_smoke._metrics_file(p)
    assert list(m) == ["task", "videos", "avg s/frame", "psnr", "ssim",
                       "ewarp", "vfid"]
    assert m["task"] == "video_completion" and float(m["vfid"]) == 1.2345


def test_trace_summary(tmp_path):
    """The eval phase's reader of the CLI's torch.profiler trace: device
    time by kernel, the busy share of the kernels' span, and cuDNN's FFT
    convolution kernels (FFTs, complex GEMMs, tiling transforms) by the op
    that launched them, matched by External id."""
    import json

    conv = {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution",
            "ts": 0, "dur": 50, "args": {"External id": 7,
                                         "Input Dims": [[1, 8, 9, 9]],
                                         "Concrete Inputs": ["", "[1, 1]"]}}
    kernels = [("fft2d_r2c_32x32", 10, 10, 7),
               ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n", 20, 30, 7),
               ("window_attention_kernel", 60, 40, 8),
               ("region_transform_ABC_val", 110, 10, 9)]
    events = [conv] + [{"ph": "X", "cat": "kernel", "name": n, "ts": ts,
                        "dur": dur, "args": {"External id": ext}}
                       for n, ts, dur, ext in kernels]
    path = tmp_path / "t.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = chip_smoke._trace_summary(path)
    assert got["kernels"] == 4
    assert got["busy_ms"] == pytest.approx(0.09)
    assert got["span_ms"] == pytest.approx(0.11)
    assert got["fft_launches"] == 3 and got["fft_ms"] == pytest.approx(0.05)
    assert got["top"][0] == ["window_attention_kernel", 0.04, 1]
    (op, ms, n), (other, ms2, n2) = got["fft_by_op"]
    assert op.startswith("aten::cudnn_convolution [[1, 8, 9, 9]]")
    assert (ms, n) == (pytest.approx(0.04), 2)
    assert other.startswith("?") and n2 == 1


@pytest.mark.parametrize("stage", ["flowcomp", "propainter"])
def test_train_launch_counts(stage, monkeypatch):
    """`_train_launches` against one real train step on the CPU (RAFT
    with 2 iterations at 64 x 96, l_t 4, a reduced generator), its
    kernels' calls counted where the wrappers would launch them on the
    card: K2 once, K1 once per RAFT iteration, K3 in every forward of a
    deform align, the recomputes under remat among them; K4, K5 and K7
    never."""
    from propainter_tpu_torch.models import propainter as gen_module
    from propainter_tpu_torch.models import raft as raft_module
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.ops import corr as corr_module

    calls = dict.fromkeys(chip_smoke._train_launches(stage), 0)

    def counted(module, name, key):
        real = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[key] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    counted(corr_module, "corr_pyramid_build", "corr_pyramid_build")
    counted(raft_module, "corr_lookup_moenc", "corr_lookup_moenc")
    counted(raft_module, "corr_lookup", "corr_lookup")
    counted(deform, "modulated_deform_conv2d", "modulated_deform_conv2d")
    counted(gen_module, "flash_window_attention", "flash_window_attention")
    counted(gen_module, "sparse_window_attention", "sparse_window_attention")
    torch.set_num_threads(1)
    torch.manual_seed(0)
    l_t, T, H, W = 4, 4 + (1 if stage == "flowcomp" else 2), 64, 96
    mods = chip_smoke._train_modules(stage, "cpu", gen=InpaintGenerator(
        hidden=128, depths=2, remat=True))
    state, step = chip_smoke._train_state(stage, mods, "cpu", raft_iters=2,
                                          num_local_frames=l_t)
    frames = torch.rand(1, T, H, W, 3) * 2 - 1
    masks = torch.zeros(1, T, H, W, 1)
    masks[:, :, 20:40, 30:60] = 1.0
    _, metrics, _ = step(state, {"frames": frames, "masks": masks})
    assert all(torch.isfinite(v) for v in metrics.values())
    assert calls == chip_smoke._train_launches(stage, l_t, raft_iters=2)
    assert chip_smoke._train_launches("flowcomp")["modulated_deform_conv2d"] \
        == 32
    assert chip_smoke._train_launches("propainter")[
        "modulated_deform_conv2d"] == 16 + 36


def test_train_config_writer_and_dataset(tmp_path):
    """`_train_config` keeps configs/train_*.json but for the batch per
    card (1), the synthetic video root, the seeded checkpoints and the
    run's cadence; `_write_train_dataset` writes a YouTube-VOS layout
    that the port's TrainDataset reads."""
    import json

    from propainter_tpu_torch.core.dataset import (TrainDataset,
                                                   TrainDatasetConfig)

    chip_smoke._write_train_dataset(tmp_path, (("v", 18),), H=32, W=48)
    weights = tmp_path / "weights"
    for stage, src in chip_smoke.TRAIN_CONFIGS.items():
        path = chip_smoke._train_config(stage, tmp_path, weights)
        assert path.name == f"train_{stage}.json"
        got = json.loads(path.read_text())
        want = json.loads((chip_smoke.Path(chip_smoke.__file__).parent
                           / src).read_text())
        assert got["trainer"]["batch_size"] == 1
        assert want["trainer"]["batch_size"] == 8
        assert {k: v for k, v in got["trainer"].items()
                if k not in ("batch_size", "num_workers", "log_freq",
                             "save_freq")} == {
            k: v for k, v in want["trainer"].items()
            if k not in ("batch_size", "num_workers", "log_freq",
                         "save_freq")}
        assert got["train_data_loader"]["video_root"] == str(
            tmp_path / "videos")
        assert {k: v for k, v in got["train_data_loader"].items()
                if k != "video_root"} == {
            k: v for k, v in want["train_data_loader"].items()
            if k != "video_root"}
        assert got["model"]["raft_path"] == str(weights / "raft-things.pth")
        assert got["losses"] == want["losses"]
    ds = TrainDataset(TrainDatasetConfig(
        video_root=str(tmp_path / "videos"),
        json_path=str(tmp_path / "datasets" / "youtube-vos" / "train.json"),
        num_local_frames=10, num_ref_frames=6, w=48, h=32))
    item = ds[0]
    assert item["frames"].shape == (16, 32, 48, 3)
    assert item["masks"].shape == (16, 32, 48, 1)


def test_train_metrics_reader(tmp_path):
    """`_metrics_jsonl` reads the rows the CLI's MetricLogger writes."""
    from propainter_tpu_torch.utils.tb import MetricLogger

    log = MetricLogger(str(tmp_path), use_tensorboard=False)
    for step in (1, 2):
        log.add("loss/gen_loss", 0.5 / step)
        log.flush_scalars(step)
    log.close()
    rows = chip_smoke._metrics_jsonl(tmp_path / "metrics.jsonl")
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[1]["loss/gen_loss"] == 0.25


def test_sam_encoder_work_counts_every_product():
    """The demo phase's bound: `_sam_encoder_work` at vit_h, 1024x1024
    (the windowed blocks on their 70x70 padded tokens) equals PyTorch's
    own count of the encoder's matmul and convolution FLOPs on the meta
    device, ~5.96 TFLOP, which at 67 TFLOP/s is ~89 ms."""
    from torch.utils.flop_counter import FlopCounterMode
    from propainter_tpu_torch.models.sam import Sam, sam_config_registry

    cfg = sam_config_registry["vit_h"]()
    with torch.device("meta"):
        enc = Sam(cfg).image_encoder
        with FlopCounterMode(display=False) as flops, torch.no_grad():
            enc(torch.zeros(1, 3, cfg.img_size, cfg.img_size))
    n_params = sum(p.numel() for p in enc.parameters())
    work = chip_smoke._sam_encoder_work(cfg, n_params)
    assert work["ops"] == flops.get_total_flops()
    assert len(work["per_block"]) == 32
    assert work["bytes"] == 4 * (n_params + 3 * 1024 ** 2 + 64 * 64 * 256)
    bound_ms, by = chip_smoke._bound(work["bytes"], work["ops"])
    assert by == "operations" and bound_ms == pytest.approx(88.97, abs=0.01)


def _facade_calls(rn):
    """One call of each of the facade's bf16 kernels through the bindings
    the models use, K2 at two grids and twice at the first."""
    from propainter_tpu_torch.models import propainter, raft

    bf = torch.bfloat16
    for H, W in ((8, 8), (8, 8), (8, 16)):
        pyr = corr.corr_pyramid(rn(1, H, W, 16), rn(1, H, W, 16), 4,
                                out_dtype=bf)
    coords = (rn(1, 8, 16, 2, std=3.0) + torch.stack(torch.meshgrid(
        torch.arange(16.0), torch.arange(8.0), indexing="xy"), -1))
    raft.corr_lookup_moenc_bf16(pyr, coords, rn(324, 32, std=0.02),
                                rn(32, std=0.02))
    x, off, msk, wt, bs = chip_smoke._deform_inputs(rn, 1, 5, 7, 32, 4, 2.0)
    deform.modulated_deform_conv2d_opt2(*(t.to(bf) for t in (x, off, msk, wt,
                                                             bs)))
    q, k, v = (rn(1, 2, n, 16).to(bf) for n in (5, 9, 9))
    propainter.flash_window_attention_bf16(q, k, v, None, 0.25)


def test_checked_wrappers_hold_each_shape_against_its_plain_version(
        monkeypatch):
    """The track phase's `_checked_wrappers`: every binding of the facade's
    four bf16 wrappers in the port's modules is hooked inside the block
    and restored after; the first call at each distinct shape is held
    against the plain version (on the CPU the wrapper computes its plain
    version: error 0) and a repeated shape is not; a wrapper that
    disagrees shows an error over its tolerance."""
    from propainter_tpu_torch.models import propainter, raft

    g = torch.Generator().manual_seed(0)

    def rn(*shape, std=1.0):
        return torch.randn(*shape, generator=g) * std

    wrappers = chip_smoke._facade_kernels()
    before = corr.corr_pyramid_build_bf16.launches
    found = {}
    with chip_smoke._checked_wrappers(wrappers, found):
        assert (raft.corr_lookup_moenc_bf16
                is not wrappers["corr_lookup_moenc_bf16"][0])
        # a wrapper on a CUDA tensor adds to the counter its module binds
        corr.corr_pyramid_build_bf16.launches += 1
        _facade_calls(rn)
    assert raft.corr_lookup_moenc_bf16 is wrappers["corr_lookup_moenc_bf16"][0]
    assert (propainter.flash_window_attention_bf16
            is wrappers["flash_window_attention_bf16"][0])
    assert chip_smoke._facade_kernels() == wrappers
    assert corr.corr_pyramid_build_bf16.launches == before
    assert {k: len(v) for k, v in found.items()} == {
        "corr_pyramid_build_bf16": 2, "corr_lookup_moenc_bf16": 1,
        "modulated_deform_conv2d_bf16": 1, "flash_window_attention_bf16": 1}
    assert sorted(chip_smoke._lead_shape(k)
                  for k in found["corr_pyramid_build_bf16"]) == [
        (64, 8, 8), (128, 8, 16)]
    assert [chip_smoke._lead_shape(k) for k in found[
        "flash_window_attention_bf16"]] == [(1, 2, 5, 16)]
    assert all(err == 0.0 and tol >= chip_smoke.BF16_REL_TOL
               for seen in found.values() for err, tol in seen.values())

    real = corr.corr_pyramid_build_bf16
    monkeypatch.setattr(corr, "corr_pyramid_build_bf16",
                        lambda level0, num_levels=4: [
                            lvl * 1.1 for lvl in real(level0, num_levels)])
    found = {}
    with chip_smoke._checked_wrappers(chip_smoke._facade_kernels(), found):
        _facade_calls(rn)
    assert all(err > tol for err, tol
               in found["corr_pyramid_build_bf16"].values())


def test_topk_inversion_counts_tokens_dropped_from_the_top():
    """The track phase's top-k tie measure: 0 for the CPU's own top-k set
    in any order and for a swap of exactly tied tokens; a set that drops
    the largest token for the next one below the k-th is off by the gap
    from the dropped token, not by the small gap below the k-th."""
    sim = torch.tensor([[5.0, 4.0, 3.0, 2.75, 1.0, 1.0]])
    gap = lambda *idx: chip_smoke._topk_inversion(sim, torch.tensor([idx]))
    assert gap(0, 1, 2).item() == 0.0 and gap(2, 0, 1).item() == 0.0
    assert chip_smoke._topk_inversion(
        sim, torch.tensor([[0, 1, 2, 3, 4]])).item() == 0.0
    assert gap(1, 2, 3).item() == 5.0 - 2.75
    assert gap(0, 1, 3).item() == 3.0 - 2.75
    assert gap(0, 1, 2, 3, 5).item() == 0.0


def test_foreground_margin_measures_both_directions():
    """The track phase's foreground tie measure: each object's aggregated
    logit against the largest other channel, so a pixel where the object
    is the max (a GPU dropping it to the background) has the same margin
    as one where it is not (a GPU taking it), and an exact tie has 0."""
    from propainter_tpu_torch.models.cutie import aggregate

    logits = torch.tensor([[[[3.0, -2.0, 0.5, 1.0]], [[-1.0, 2.5, 0.5,
                                                        -4.0]]]])
    margin, agg = chip_smoke._foreground_margin(logits, None)
    want = aggregate(torch.sigmoid(logits), dim=1).view(1, 3, -1)
    torch.testing.assert_close(agg, want)
    for n in range(2):
        rest = torch.cat([want[:, :n + 1], want[:, n + 2:]], 1)
        torch.testing.assert_close(
            margin[:, n], (want[:, n + 1] - rest.max(dim=1).values).abs())
    fg = want[:, 1:] >= want.max(dim=1, keepdim=True).values
    assert fg[0, 0, 0] and margin[0, 0, 0] > 1.0
    assert margin[0, 0, 2] == 0.0 and margin[0, 1, 2] == 0.0
    sel = torch.tensor([1.0, 0.0])[None, :, None, None]
    margin, agg = chip_smoke._foreground_margin(logits, sel)
    torch.testing.assert_close(agg, aggregate(torch.sigmoid(logits) * sel,
                                              dim=1).view(1, 3, -1))
