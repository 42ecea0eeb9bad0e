"""The pieces of `chip_smoke.py` that run without a GPU: the build phase's
readers of the compiler's and the disassembler's output, and K4's and K5's
bounds."""

import math

import chip_smoke

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
    b = chip_smoke._attention_bounds(n_bytes, Gp * 4 * Tq * Tk * ch,
                                     Gp * 5 * Tq * Tk)
    assert b["bound_by"] == "operations"
    assert b["bound_basis"] == "operations (3xTF32)"
    assert math.isclose(b["bound_ms"], 3 * Gp * 4 * Tq * Tk * ch / 495e9,
                        rel_tol=1e-9)
    assert math.isclose(b["fp32_bound_ms"], 1.0049, rel_tol=1e-3)
    assert b["fp32_bound_by"] == "operations"
