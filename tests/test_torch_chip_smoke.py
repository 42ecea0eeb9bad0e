"""The pieces of `chip_smoke.py` that run without a GPU: the build phase's
readers of the compiler's and the disassembler's output and its grids, the
kernels' bounds, and the main path's expected launch counts."""

import math
from types import SimpleNamespace

import chip_smoke
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
"""


def test_ptxas_report_reads_each_entry_function():
    report = chip_smoke._ptxas_report(PTXAS_LOG)
    k4 = report["_ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif"]
    assert k4 == dict(spill_stores=8, spill_loads=4, registers=199,
                      static_smem=1552)
    assert report["_Z5otherv"] == dict(spill_stores=0, spill_loads=0,
                                       registers=12)


def test_sass_counts_per_function():
    counts = chip_smoke._sass_counts(SASS, "HMMA")
    assert counts == {
        "_ZN12_GLOBAL__N_123window_attention_kernelEPKfS2_S2_S2_Pfiiif": 2,
        "_Z5otherv": 0}


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
    for 2 resident blocks per SM at each call site; the bf16 forms one
    block per tile: K1's 608 64-query tiles, K4's as K4's, K3's 32-position
    tiles (the launch facts the card reported)."""
    info = {"corr_lookup_moenc_kernel": [2, 93696, 128, 32, 1],
            "window_attention_kernel": [2, 107520, 128, 64, 1],
            "sparse_window_attention_kernel": [2, 107520, 128, 64, 2],
            "deform_conv_kernel": [2, 67584, 128, 64, 8],
            "corr_lookup_moenc_bf16_kernel": [2, 0, 256, 64, 1],
            "window_attention_bf16_kernel": [3, 0, 128, 64, 1],
            "deform_conv_bf16_kernel": [8, 0, 128, 32, 1]}
    grids = {(symbol, site): grid_of(info[symbol])
             for _, symbol, site, _, _, grid_of
             in chip_smoke._tensor_core_launches(132)}
    assert grids == {
        ("corr_lookup_moenc_kernel", "main path, tiles"): 1215,
        ("window_attention_kernel", "main path"): 14 * 64,
        ("sparse_window_attention_kernel", "main path"): 14 * 2 * 64,
        ("deform_conv_kernel", "generator"): 102 * 2,
        ("deform_conv_kernel", "flow completion"): 51 * 4,
        ("corr_lookup_moenc_bf16_kernel", "bf16 main path"): 608,
        ("window_attention_bf16_kernel", "bf16 main path"): 14 * 64,
        ("deform_conv_bf16_kernel", "generator, bf16"): 203,
        ("deform_conv_bf16_kernel", "flow completion, bf16"): 102}


def test_corr_lookup_bound_at_the_main_path_shape():
    """K7 at one RAFT iteration with every tap in range: 324 outputs, 400
    taps and 2 coordinates of 4 bytes per query, 112.9 MB at 3.35 TB/s
    (0.0337 ms), above its lerps on CUDA cores."""
    n_q = chip_smoke.K1_QUERIES
    ms, by = chip_smoke._bound(4 * n_q * (324 + 400 + 2), n_q * 324 * 7)
    assert by == "bytes"
    assert math.isclose(ms, 0.0337, rel_tol=1e-3)


def test_main_path_launch_counts():
    """80 frames of 432 x 240: 7 RAFT chunks of 20 iterations (140 lookups,
    K1's or K7's); 16 generator windows (lengths 6, 11 x 14, 10), in 6
    batches at window_batch 4 (1 + 4 + 1) and 16 at 1."""
    frames = SimpleNamespace(shape=(80, 240, 432, 3))
    pipe = SimpleNamespace(config=PipelineConfig(), _window_batch=1)
    assert chip_smoke._raft_launches(pipe, frames) == 140
    assert chip_smoke._window_batches(80, pipe) == 16
    pipe._window_batch = 4
    assert chip_smoke._window_batches(80, pipe) == 6
