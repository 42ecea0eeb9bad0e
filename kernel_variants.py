#!/usr/bin/env python3
"""Time variants of a CUDA kernel of the port against its source as it is,
in one process on one GPU.

    python3 kernel_variants.py k1      # K1's bf16 form and its variants
    python3 kernel_variants.py k3      # K3's bf16 form and its variants
    python3 kernel_variants.py k7      # K7's bf16 form and its variants

A variant is a set of string edits of one `propainter_tpu_torch/csrc/`
source: the source as it is and each variant are copied with every header
into `build/variants/<name>/`, built there by their own `nvcc` (all
started together), then every form is timed by CUDA-graph replay
(`chip_smoke._graph_ms`) at the main path's shapes, in turns (the source
first), `--reps` rounds, and held to the bf16 plain version (its max abs
error is printed, not gated: an ablation that removes work is wrong by
design). Prints the card's `nvidia-smi` line, one line per timing and a
JSON object of the times; exits non-zero without a GPU.

The variants are the alternatives measured against the kept designs (the
source notes of `csrc/corr_lookup_moenc.cu`, `csrc/deform_conv.cu` and
`csrc/corr_lookup.cu` cite them) and ablations that remove one part of a
kernel to show what bounds it.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
_PACKAGE_CSRC = ROOT / "propainter_tpu_torch" / "csrc"
_PACKAGE_BUILD = ROOT / "build" / "kernels"

K1_SOURCE = "corr_lookup_moenc"
K3_SOURCE = "deform_conv"
K7_SOURCE = "corr_lookup"

_K1_PRODUCTS = """        wga::mma_ss_n64(acc, da + kk * kABlock / 16, db + kk * kWBlock / 16,
                        kk > 0);"""
_K1_STORES = """      if (n >= n_query) continue;"""
_K1_LEVEL_LOOP = """#pragma unroll 1
      for (int l = 0; l < kLevels; ++l) {
        const float scale = 1.f / static_cast<float>(1 << l);
        float gv[kQPW][4];
#pragma unroll
        for (int q = 0; q < kQPW; ++q) {
          const int n = tile * kBQb + pw + kProducerWarps * q;
          load_window(lv, l, n, n < n_query && glane,
                      cx[q] * scale, cy[q] * scale, r, c, gv[q]);
        }"""
_K1_PREFETCH = """      float gn[kQPW][4];
#pragma unroll
      for (int q = 0; q < kQPW; ++q) {
        const int n = tile * kBQb + pw + kProducerWarps * q;
        load_window(lv, 0, n, n < n_query && glane, cx[q], cy[q], r, c,
                    gn[q]);
      }
#pragma unroll 1
      for (int l = 0; l < kLevels; ++l) {
        const float scale = 1.f / static_cast<float>(1 << l);
        float gv[kQPW][4];
#pragma unroll
        for (int q = 0; q < kQPW; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) gv[q][k] = gn[q][k];
        if (l + 1 < kLevels) {
          const float s1 = 0.5f * scale;
#pragma unroll
          for (int q = 0; q < kQPW; ++q) {
            const int n = tile * kBQb + pw + kProducerWarps * q;
            load_window(lv, l + 1, n, n < n_query && glane, cx[q] * s1,
                        cy[q] * s1, r, c, gn[q]);
          }
        }"""
# ablations skip work behind a condition that is false at run time
_K1_NO_PRODUCTS = [(_K1_PRODUCTS, "        if (n_query < 0)\n" + _K1_PRODUCTS)]
_K1_NO_STORES = [(_K1_STORES, "      if (n >= n_query || n_query > 0) continue;")]

# K7's bf16 body
_K7_TAP = ("      t[l][k] = in ? __ldg(m + static_cast<unsigned>(off)) : "
           "0u;")
_K7_MATH = ("      const float v = __fadd_rn(__fmul_rn(g, omfx), "
            "__fmul_rn(right, fx));")
_K7_LERP = "  lerp(lv, coords, q, t, o, lane);"
_K7_BULK = "  if (lane == 0 && live) {"
_K7_NO_STORES = [(_K7_BULK, "  if (lane == 0 && live && q < 0) {")]
# the taps consumed only by a test that never holds, so their loads stay
_K7_GATHER_ONLY = [(_K7_LERP, """  uint32_t x = 0;
#pragma unroll
  for (int l = 0; l < kLevels; ++l)
#pragma unroll
    for (int k = 0; k < 4; ++k) x ^= t[l][k] << (l + k);
  if (x == 0x12345678u) o[lane] = 0.f;""")]
# each warp walks its own contiguous run (its round count its own, so the
# shuffles sit in branches the compiler cannot prove uniform)
_K7_RUNS = [
    ("  const int rounds = (b1 - b0 + kWarpsB - 1) / kWarpsB;",
     "  const int w0 = b0 + (b1 - b0) * warp / kWarpsB;\n"
     "  const int w1 = b0 + (b1 - b0) * (warp + 1) / kWarpsB;\n"
     "  const int rounds = w1 - w0;"),
    ("    return min(b0 + i * kWarpsB + warp, b1 - 1);",
     "    return min(w0 + i, w1 - 1);"),
    ("  const auto live = [&](int i) { return b0 + i * kWarpsB + warp < "
     "b1; };", "  const auto live = [&](int i) { return w0 + i < w1; };")]
# float4 stores of the row instead of the bulk store and its proxy fence
_K7_FLOAT4 = [
    ("""  // the bulk store of two queries ago has read this output row
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
  __syncwarp();
""", ""),
    ("""  // the values written here are read by the bulk copy (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
""", """  __syncwarp();
  if (live) {
    float4* const dst = reinterpret_cast<float4*>(
        out + static_cast<size_t>(q) * kC);
    const float4* const src = reinterpret_cast<const float4*>(o);
    for (int j = lane; j < kC / 4; j += 32) dst[j] = src[j];
  }
"""),
    (_K7_BULK, "  if (lane == 0 && live && q < 0) {")]

VARIANTS = {
    "k1": (K1_SOURCE, {
        "8 producer warps": [("constexpr int kProducerWarps = 16;",
                              "constexpr int kProducerWarps = 8;")],
        "level loop unrolled": [(_K1_LEVEL_LOOP, _K1_LEVEL_LOOP.replace(
            "#pragma unroll 1", "#pragma unroll"))],
        "next level's taps prefetched": [(_K1_LEVEL_LOOP, _K1_PREFETCH)],
        "gather only (no products, no stores)": _K1_NO_PRODUCTS
        + _K1_NO_STORES,
        "no tap loads": [("    gv[k] = in ? __uint_as_float",
                          "    gv[k] = (in && n < 0) ? __uint_as_float")],
    }),
    "k3": (K3_SOURCE, {
        "3 resident blocks per SM": [("constexpr int kBlocksPerSmB = 2;",
                                      "constexpr int kBlocksPerSmB = 3;")],
        "4 stages": [("constexpr int kStagesB = 3;",
                      "constexpr int kStagesB = 4;")],
    }),
    "k7": (K7_SOURCE, {
        "float4 stores": _K7_FLOAT4,
        "5 blocks per SM": [("__launch_bounds__(kThreadsB, 4)\n",
                             "__launch_bounds__(kThreadsB, 5)\n")],
        "4 warps a block": [("constexpr int kWarpsB = 8;",
                             "constexpr int kWarpsB = 4;")],
        "contiguous runs a warp": _K7_RUNS,
        "streaming tap loads (ld.global.cs)": [
            (_K7_TAP, _K7_TAP.replace("__ldg", "__ldcs"))],
        "no tap loads": [
            (_K7_TAP, _K7_TAP.replace("in ?", "(in && n < 0) ?"))],
        "no lerp arithmetic": [(_K7_MATH, "      const float v = "
                                "__uint_as_float(t[l][k]);")],
        "no stores": _K7_NO_STORES,
        "gather only (no lerps, no stores)": _K7_GATHER_ONLY + _K7_NO_STORES,
        "lerps only (no tap loads, no stores)": [
            (_K7_TAP, _K7_TAP.replace("in ?", "(in && n < 0) ?"))]
        + _K7_NO_STORES,
    }),
}


def _variant_dir(name: str, source: str, edits) -> Path:
    """A copy of the package's csrc/ under build/variants/ with `edits`
    applied to `source`.cu."""
    d = ROOT / "build" / "variants" / re.sub(r"\W+", "_", name).strip("_")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_PACKAGE_CSRC, d / "csrc")
    path = d / "csrc" / f"{source}.cu"
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name!r}: edit does not apply")
        text = text.replace(old, new)
    path.write_text(text)
    return d


def _use(d: Path | None) -> None:
    """Load kernels from variant directory d (None: the package's own)."""
    from propainter_tpu_torch import _build
    from propainter_tpu_torch.ops import corr, deform

    _build.CSRC = d / "csrc" if d else _PACKAGE_CSRC
    _build.BUILD_DIR = d / "kernels" if d else _PACKAGE_BUILD
    _build._libs.clear()
    _build._fns.clear()
    corr._k1_slots.clear()
    deform._k3_slots.clear()


def _build_all(dirs, source: str) -> None:
    """One nvcc per form, all started together, and the package's own
    kernels (the inputs' pyramid is K2's); the registers and spills of each
    bf16 kernel printed."""
    from propainter_tpu_torch import _build

    procs = []
    for d in dirs:
        _use(d)
        out = _build._target(source)
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build._tool("nvcc"), *_build.NVCC_FLAGS, "-o", str(out),
               str(_build.CSRC / f"{source}.cu")]
        procs.append((d, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    _use(None)
    _build.build()
    import chip_smoke

    for d, out, p in procs:
        log = p.communicate()[0].decode()
        out.with_suffix(".log").write_text(log)
        if p.returncode:
            raise RuntimeError(f"{d.name}: nvcc failed\n{log[-4000:]}")
        for fn, r in chip_smoke._ptxas_report(log).items():
            if "bf16_kernel" in fn:
                print(f"  {d.name}: {r}")


def _raft_iteration(dev):
    """One RAFT iteration of the main path (24 pair-directions at 30 x 54):
    the fp32 level 0, coordinates moved by N(0, 3^2) pixels, and the
    seeded `randn` that made them."""
    import torch
    from propainter_tpu_torch.ops.warp import coords_grid

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    B, H8, W8, D = 24, 30, 54, 256
    f1, f2 = randn(B, H8, W8, D), randn(B, H8, W8, D)
    level0 = torch.bmm(f1.reshape(B, H8 * W8, D) / 16,
                       f2.reshape(B, H8 * W8, D).transpose(1, 2))
    coords = (coords_grid(B, H8, W8, device=dev)
              + randn(B, H8, W8, 2, std=3.0)).contiguous()
    return level0.reshape(B * H8 * W8, H8, W8).contiguous(), coords, randn


def _k1_cases(dev):
    """K1's bf16 form at one RAFT iteration of the main path: one call, and
    its plain version."""
    import torch
    from propainter_tpu_torch.ops import corr

    level0, coords, randn = _raft_iteration(dev)
    pyr = corr.corr_pyramid_build_bf16(level0, 4)
    w = randn(324, 256, std=0.02).to(torch.bfloat16)
    bias = randn(256, std=0.02).to(torch.bfloat16)
    return {"RAFT iteration": (
        lambda: corr.corr_lookup_moenc_bf16(pyr, coords, w, bias),
        corr._corr_lookup_moenc_bf16_plain(pyr, coords, w, bias, 4))}


def _k7_cases(dev):
    """K7's bf16 form at one RAFT iteration of the main path; as yardsticks
    (no variant edits them) the fp32 K7 over the fp32 pyramid of the same
    volume and PyTorch's `fill_` of an output of the same size."""
    from propainter_tpu_torch.ops import corr

    import torch

    level0, coords, _ = _raft_iteration(dev)
    pyr = corr.corr_pyramid_build_bf16(level0, 4)
    pyr32 = corr.corr_pyramid_build(level0, 4)
    out = torch.empty(coords.shape[:3] + (324,), device=dev)
    return {
        "RAFT iteration": (lambda: corr.corr_lookup_bf16(pyr, coords),
                           corr._corr_lookup_plain(pyr, coords)),
        "fp32 K7, RAFT iteration": (lambda: corr.corr_lookup(pyr32, coords),
                                    corr._corr_lookup_plain(pyr32, coords)),
        # the output's 50 MB written alone: what the stores cost at best
        "output fill_ alone": (lambda: out.fill_(0.0),
                               torch.zeros_like(out))}


def _k3_cases(dev):
    """K3's bf16 form at both call sites (chip_smoke's inputs)."""
    import torch
    import chip_smoke
    from propainter_tpu_torch.ops import deform

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    cases = {}
    for site, (Bd, Hd, Wd, C, dg, max_res) in (
            ("generator", (1, 60, 108, 128, 16, 3.0)),
            ("flow completion", (2, 30, 54, 256, 16, 5.0))):
        args = [t.to(torch.bfloat16).contiguous() for t in
                chip_smoke._deform_inputs(randn, Bd, Hd, Wd, C, dg, max_res)]
        cases[site] = (
            lambda a=args: deform.modulated_deform_conv2d_bf16(*a),
            deform._modulated_deform_conv2d_bf16_plain(*args))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=2,
                    help="rounds of timings, each form once a round")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    print(chip_smoke._smi_line(), flush=True)
    source, variants = VARIANTS[args.kernel]
    forms = {name: _variant_dir(name, source, edits)
             for name, edits in {"as it is": [], **variants}.items()}
    _build_all(list(forms.values()), source)
    dev = torch.device("cuda")
    cases = {"k1": _k1_cases, "k3": _k3_cases}.get(args.kernel,
                                                   _k7_cases)(dev)
    times: dict = {}
    for _ in range(args.reps):
        for form, d in forms.items():
            _use(d)
            for case, (fn, want) in cases.items():
                err = (fn().float() - want.float()).abs().max().item()
                ms = chip_smoke._graph_ms(fn)
                times.setdefault(f"{form}, {case}", []).append(ms)
                print(f"  {form}, {case}: {ms:.4f} ms (max abs err "
                      f"{err:.3e})", flush=True)
    _use(None)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
