#!/usr/bin/env python3
"""Time variants of a CUDA kernel of the port against its source as it is,
in one process on one GPU.

    python3 kernel_variants.py k1      # K1's bf16 form and its variants
    python3 kernel_variants.py k3      # K3's bf16 form and its variants

A variant is a set of string edits of one `propainter_tpu_torch/csrc/`
source: each is copied with every header into `build/variants/<name>/`,
built there by its own `nvcc` (all started together), then every form is
timed by CUDA-graph replay (`chip_smoke._graph_ms`) at the main path's
shapes, in turns (the source first), `--reps` rounds, and held to the
bf16 plain version (its max abs error is printed, not gated: an ablation
that removes work is wrong by design). Prints the card's `nvidia-smi`
line, one line per timing and a JSON object of the times; exits non-zero
without a GPU.

The variants are the alternatives measured against the kept designs (the
source notes of `csrc/corr_lookup_moenc.cu` and `csrc/deform_conv.cu`
cite them) and ablations that remove one part of a kernel to show what
bounds it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

K1_SOURCE = "corr_lookup_moenc"
K3_SOURCE = "deform_conv"

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
}


def _variant_dir(name: str, source: str, edits) -> Path:
    """A copy of csrc/ under build/variants/ with `edits` applied to
    `source`.cu."""
    from propainter_tpu_torch import _build

    d = ROOT / "build" / "variants" / name.replace(" ", "_").replace(
        "(", "").replace(")", "").replace(",", "").replace("'", "")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d / "csrc")
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

    root = Path(_build.__file__).resolve().parent
    _build.CSRC = d / "csrc" if d else root / "csrc"
    _build.BUILD_DIR = d / "kernels" if d else root.parent / "build" / "kernels"
    _build._libs.clear()
    _build._fns.clear()
    corr._k1_slots.clear()
    deform._k3_slots.clear()


def _build_all(dirs, source: str) -> None:
    """One nvcc per variant, all started together; the registers and spills
    of each bf16 kernel printed."""
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
    _build.build((source,))
    import chip_smoke

    for d, out, p in procs:
        log = p.communicate()[0].decode()
        out.with_suffix(".log").write_text(log)
        if p.returncode:
            raise RuntimeError(f"{d.name}: nvcc failed\n{log[-4000:]}")
        for fn, r in chip_smoke._ptxas_report(log).items():
            if "bf16_kernel" in fn:
                print(f"  {d.name}: {r}")


def _k1_cases(dev):
    """K1's bf16 form at one RAFT iteration of the main path (24
    pair-directions at 30 x 54): one call, and its plain version."""
    import torch
    from propainter_tpu_torch.ops import corr
    from propainter_tpu_torch.ops.warp import coords_grid

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device=dev) * std

    B, H8, W8, D = 24, 30, 54, 256
    f1, f2 = randn(B, H8, W8, D), randn(B, H8, W8, D)
    level0 = torch.bmm(f1.reshape(B, H8 * W8, D) / 16,
                       f2.reshape(B, H8 * W8, D).transpose(1, 2))
    pyr = corr.corr_pyramid_build_bf16(
        level0.reshape(B * H8 * W8, H8, W8).contiguous(), 4)
    coords = (coords_grid(B, H8, W8, device=dev)
              + randn(B, H8, W8, 2, std=3.0)).contiguous()
    w = randn(324, 256, std=0.02).to(torch.bfloat16)
    bias = randn(256, std=0.02).to(torch.bfloat16)
    return {"RAFT iteration": (
        lambda: corr.corr_lookup_moenc_bf16(pyr, coords, w, bias),
        corr._corr_lookup_moenc_bf16_plain(pyr, coords, w, bias, 4))}


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
    dirs = {name: _variant_dir(name, source, edits)
            for name, edits in variants.items()}
    _build_all(list(dirs.values()), source)
    dev = torch.device("cuda")
    cases = (_k1_cases if args.kernel == "k1" else _k3_cases)(dev)
    forms = {"as it is": None, **dirs}
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
