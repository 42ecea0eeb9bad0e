"""The bf16 forms of K5 and K7, and K1 over a bf16 volume with fp32
parameters, against the JAX package on the CPU: the configurations the JAX
package runs in bf16 besides 'flash' with a bf16 RAFT refinement.

Kernels: the plain versions (the CPU path of the wrappers, and what the
CUDA kernels are held to on the card) against the TPU kernels run on the
same bf16 inputs in Pallas interpret mode. Modules: the generator's
'pallas' form with bf16 parameters is in tests/test_torch_bf16.py; here
RAFT refining in fp32 over a bf16 volume in both corr layouts against the
JAX fp32 refine, and the JAX package's own bf16 refine in the batched
layout failing, which is why the port refuses it. The golden fixture in
bf16 under 'pallas' and under shard_inference:
tests/test_torch_bf16_pipeline.py. Each tolerance is a measured bound,
its measurement in the docstring.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from propainter_tpu.models.raft import RAFT as JaxRAFT
from propainter_tpu.ops.attention import sparse_window_attention_pallas
from propainter_tpu.ops.corr_pallas import (corr_lookup_flat_moenc,
                                            corr_lookup_fused,
                                            corr_pyramid_flat)
from tests.test_torch_bf16 import _bf16, _corr_case, _jax_bf16_tree, _rel_err
from tests.test_torch_kernels import _sparse_attention_inputs
from tests.test_torch_models import _fill, _load, _raft_tree

from propainter_tpu_torch.models.propainter import _valid_rolled_indices
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.ops import attention, corr
from propainter_tpu_torch.weights import RAFT_RENAMES

BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs this file beside
    other pytest-xdist workers, and PyTorch's default of one OpenMP thread
    per core in every worker oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- kernels: plain versions against the TPU kernels ---------------------


@pytest.mark.parametrize("case", ["dirty", "all_clean", "frame0_off"])
def test_sparse_window_attention_bf16_plain_matches_jax_kernel(case):
    """K5's bf16 form against the TPU sparse window attention kernel on
    bf16 windows (interpret mode), which upcasts them and writes bf16:
    mixed dirty and clean windows, all clean, and frame 0 unselected.
    Both compute in fp32 and round once, so they differ only where fp32
    summation order moves a value across a bf16 rounding boundary (one
    bf16 step). Measured: 8, 6 and 15 of 46080 values one bf16 step apart,
    at most 1.4e-3 of the output scale."""
    *arrays, n_head = _sparse_attention_inputs(case)
    windows, rest = [_bf16(a) for a in arrays[:7]], arrays[7:]
    want = sparse_window_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in windows),
        *map(jnp.asarray, rest), n_head, interpret=True)
    got = attention.sparse_window_attention_bf16(
        *(torch.from_numpy(a).to(BF) for a in windows),
        *map(torch.from_numpy, rest), n_head)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_err(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) <= 2 ** -8


def _k5_bf16_kernel_emulation(q, k, v, rk, rv, pk, pv, roll_valid, occ,
                              fsel, n_head, split_p):
    """The arithmetic of K5's bf16 CUDA kernel in numpy, block by block:
    128 query rows a block, keys streamed in tiles of 64 through an online
    softmax in log2 units; q·k as exact products summed in fp32, the scale
    applied to the fp32 logits; p as bf16 hi + bf16 lo (split_p) or one
    bf16 rounding; fp32 sums, the division at the end. Dirty windows walk
    the selected frames' window, valid rolled and pooled keys, clean ones
    the frames the block's rows span with pairs across frames masked.
    Returns the fp32 output before its final rounding."""
    BH, nW, T, win, ch = q.shape
    c = np.float32(np.log2(np.e) / np.sqrt(ch))
    valid = np.asarray(roll_valid, bool)
    out = np.zeros(q.shape, np.float32)

    def bf16(x):
        return _bf16(x).astype(np.float64)

    for bh in range(BH):
        b = bh // n_head
        sel = np.flatnonzero(fsel[b])
        for w in range(nW):
            dirty = int(occ[b, w]) > 0
            assert not dirty or sel.size, "the mean branch is not emulated"
            qw = q[bh, w].reshape(T * win, ch).astype(np.float64)
            if dirty:
                def gathered(c, r, p):
                    return np.concatenate([np.concatenate([
                        c[bh, w, t], r[bh, w, :, t].reshape(4 * win, ch)[valid],
                        p[bh, t]]) for t in sel])

                kk, vv = gathered(k, rk, pk), gathered(v, rv, pv)
            for q0 in range(0, T * win, 128):
                rows = np.arange(q0, min(q0 + 128, T * win))
                if not dirty:
                    f0, f1 = rows[0] // win, rows[-1] // win
                    kk = k[bh, w, f0:f1 + 1].reshape(-1, ch)
                    vv = v[bh, w, f0:f1 + 1].reshape(-1, ch)
                    key_frame = f0 + np.arange(len(kk)) // win
                m = np.full(len(rows), -np.inf, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), ch), np.float32)
                for k0 in range(0, len(kk), 64):
                    kt = kk[k0:k0 + 64].astype(np.float64)
                    x = ((qw[rows] @ kt.T).astype(np.float32) * c)
                    if not dirty:
                        x[(rows // win)[:, None]
                          != key_frame[None, k0:k0 + 64]] = -np.inf
                    m_new = np.maximum(m, x.max(1))
                    with np.errstate(invalid="ignore"):   # -inf - -inf
                        alpha = np.where(m == -np.inf, 0, np.exp2(
                            m - m_new)).astype(np.float32)
                        p = np.where(x == -np.inf, 0, np.exp2(
                            x - m_new[:, None])).astype(np.float32)
                    l = l * alpha + p.sum(1, dtype=np.float32)
                    hi = bf16(p)
                    parts = hi + bf16(p - hi) if split_p else hi
                    pv_ = (parts @ vv[k0:k0 + 64].astype(np.float64))
                    acc = acc * alpha[:, None] + pv_.astype(np.float32)
                    m = m_new
                out[bh, w].reshape(T * win, ch)[rows] = acc / l[:, None]
    return out


@pytest.mark.parametrize("case", ["dirty", "all_clean", "frame0_off"])
def test_sparse_window_attention_bf16_kernel_arithmetic(case):
    """The arithmetic of K5's bf16 kernel (one bf16 q·k pass with fp32
    sums, the scale after, p into P·V as bf16 hi + lo) against the TPU
    kernel in interpret mode on the same bf16 values, which upcasts them
    and keeps p in fp32 (run here on fp32 copies of the bf16 windows: its
    output before the final bf16 rounding). hi + lo carries 16 significant
    bits of p, so the two differ in fp32 rounding only; one bf16 rounding
    of p, as K4's bf16 form makes, lands further off, which is why K5's
    form pays for the second pass. Measured: hi + lo within 1.2e-6 to
    2.6e-6 of the output scale (the TPU kernel streams frame by frame, the
    CUDA kernel in 64-key tiles), one rounding 7.4e-4 to 1.2e-3, 460-640
    times as far."""
    *arrays, n_head = _sparse_attention_inputs(case)
    windows, rest = [_bf16(a) for a in arrays[:7]], arrays[7:]
    want = np.asarray(sparse_window_attention_pallas(
        *map(jnp.asarray, windows), *map(jnp.asarray, rest), n_head,
        interpret=True))
    hi_lo = _k5_bf16_kernel_emulation(*windows, *rest, n_head, split_p=True)
    single = _k5_bf16_kernel_emulation(*windows, *rest, n_head,
                                       split_p=False)
    assert _rel_err(hi_lo, want) <= 1e-5
    assert _rel_err(single, want) >= 100 * _rel_err(hi_lo, want)
    # rounded to bf16, hi + lo gives the bf16 kernel's output
    got = attention.sparse_window_attention_bf16(
        *(torch.from_numpy(a).to(BF) for a in windows),
        *map(torch.from_numpy, rest), n_head)
    assert _rel_err(_bf16(hi_lo), got.float().numpy()) <= 2 ** -8


def test_corr_lookup_bf16_plain_matches_jax_kernel():
    """K7's bf16 form against the TPU lookup kernel without the convc1
    epilogue (`corr_lookup_fused`, the pallas_call at corr_pallas.py:363,
    interpret mode) over the same bf16 pyramid in its per-pair layout
    (the JAX RAFT's batched layout under precision='bf16'): a ragged 8 x
    13 map (level 3 is 1 x 1), coordinates up to 40 pixels outside it. The
    row lerp rounds to bf16 at the same points and the column lerp is
    fp32 on both sides. Measured: 2.4e-7 (an fp32 ulp of the sums)."""
    f1, f2, coords, _, _ = _corr_case()
    B, Hc, Wc, _ = f1.shape
    pyr = corr.corr_pyramid(torch.from_numpy(f1).to(BF),
                            torch.from_numpy(f2).to(BF), 4,
                            out_dtype=torch.bfloat16)
    # (B*P, Hl, Wl) rows -> the JAX per-pair layout (B, Hl, Wl, P)
    jpyr = [jnp.asarray(lvl.float().numpy().reshape(
        B, Hc * Wc, *lvl.shape[1:]).transpose(0, 2, 3, 1), jnp.bfloat16)
        for lvl in pyr]
    want = corr_lookup_fused(jpyr, jnp.asarray(coords), interpret=True)
    got = corr.corr_lookup_bf16(pyr, torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == (B, Hc, Wc, 324)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _round_bf16(x):
    """Values rounded to bf16 (to nearest even) in one step from float64,
    as __hmul_rn and __hadd_rn round the exact product and sum."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.rint(m * 256.0), e - 8)


def _k7_bf16_kernel_emulation(levels, coords):
    """The arithmetic of K7's bf16 CUDA kernel in numpy. Lane (r, c) of a
    query's warp loads tap (r + 3k, c) of each level's 10 x 10 window by
    its absolute element index in the level (query n's map starts at n H_l
    W_l, odd at several levels), zero outside the map; rows lerp in bf16,
    each product and the sum rounded once from its exact value (as
    __hmul_rn and __hadd_rn round), the row below from lane r + 1 or from
    the next load's lane; columns lerp in fp32. levels: (N, H_l, W_l)
    float32 holding bf16 values; coords (N, 2). Returns (N, 324)
    float32."""
    N = coords.shape[0]
    n = np.arange(N)[:, None, None]
    r, c = np.arange(3), np.arange(10)
    outs = []
    for lvl, level in enumerate(levels):
        _, H, W = level.shape
        flat = level.reshape(-1)
        x = coords[:, 0].astype(np.float32) / np.float32(2 ** lvl)
        y = coords[:, 1].astype(np.float32) / np.float32(2 ** lvl)
        fx = x - np.floor(x)
        fy = _round_bf16(y - np.floor(y))[:, None]
        omfy = _round_bf16(1.0 - fy)
        xs = np.clip(np.floor(x), -6, W + 4).astype(np.int64) - 4
        ys = np.clip(np.floor(y), -6, H + 4).astype(np.int64) - 4
        # the four loads of lane (r, c): rows r, r + 3, r + 6, r + 9
        loads = np.zeros((N, 4, 3, 10))
        for k in range(4):
            yy = (ys[:, None] + r + 3 * k)[:, :, None]          # (N, 3, 1)
            xx = (xs[:, None] + c)[:, None, :]                  # (N, 1, 10)
            ok = ((r + 3 * k < 10)[None, :, None] & (yy >= 0) & (yy < H)
                  & (xx >= 0) & (xx < W))
            idx = np.where(ok, n * H * W + yy * W + xx, 0)
            loads[:, k] = np.where(ok, flat[idx], 0.0)
        taps = loads.reshape(N, 12, 10)[:, :10]                 # rows 0-9
        gy = _round_bf16(_round_bf16(taps[:, :-1] * omfy[:, :, None])
                         + _round_bf16(taps[:, 1:] * fy[:, :, None])
                         ).astype(np.float32)
        v = (gy[:, :, :-1] * (np.float32(1) - fx)[:, None, None]
             + gy[:, :, 1:] * fx[:, None, None])                # [y, x]
        outs.append(v.transpose(0, 2, 1).reshape(N, 81))        # x-major
    return np.concatenate(outs, 1)


def _k7_bf16_case(case):
    """bf16 pyramid (port layout), coords, and the map's (B, Hc, Wc): the
    ragged 8 x 13 map with coordinates up to 40 pixels outside it, or a
    9 x 27 map (levels 9 x 27, 4 x 13, 2 x 6, 1 x 3: odd widths, and an
    odd level-0 map, so rows and queries' maps start at both 2-byte
    alignments of a 4-byte word)."""
    if case == "8 x 13 far off":
        f1, f2, coords, _, _ = _corr_case()
    else:
        rng = np.random.default_rng(15)
        B, Hc, Wc = 2, 9, 27
        f1, f2 = (_bf16(rng.standard_normal((B, Hc, Wc, 256)))
                  for _ in range(2))
        grid = np.stack(np.meshgrid(np.arange(Wc), np.arange(Hc)), -1)
        coords = (grid[None] + rng.standard_normal((B, Hc, Wc, 2)) * 4.0
                  ).astype(np.float32)
        coords[1, 8, -3:] = [[-9.5, 8.25], [31.0, -5.0], [26.75, 8.5]]
    pyr = corr.corr_pyramid(torch.from_numpy(f1).to(BF),
                            torch.from_numpy(f2).to(BF), 4,
                            out_dtype=torch.bfloat16)
    return pyr, coords, f1.shape[:3]


@pytest.mark.parametrize("case", ["8 x 13 far off", "9 x 27 odd widths"])
def test_corr_lookup_bf16_kernel_arithmetic(case):
    """The arithmetic of K7's bf16 kernel (`_k7_bf16_kernel_emulation`:
    taps loaded by absolute element index and masked, the bf16 row lerp
    rounded once per product and sum, the fp32 column lerp) against the
    TPU lookup kernel without the convc1 epilogue (`corr_lookup_fused`,
    interpret mode) on the same bf16 pyramid, within K7's bf16 tolerance
    on the card (chip_smoke.py's K7_BF16_ABS_TOL, 1e-6), and against the
    plain version, which rounds the fp32 sums. Measured: 2.4e-7 from the
    TPU kernel, 0 from the plain version."""
    pyr, coords, (B, Hc, Wc) = _k7_bf16_case(case)
    levels = [lvl.float().numpy() for lvl in pyr]
    got = _k7_bf16_kernel_emulation(levels, coords.reshape(-1, 2))
    jpyr = [jnp.asarray(lvl.reshape(B, Hc * Wc, *lvl.shape[1:]).transpose(
        0, 2, 3, 1), jnp.bfloat16) for lvl in levels]
    want = np.asarray(corr_lookup_fused(jpyr, jnp.asarray(coords),
                                        interpret=True))
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=1e-6)
    plain = corr._corr_lookup_plain(pyr, torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got.reshape(plain.shape), plain, rtol=0,
                               atol=1e-6)


def test_corr_lookup_moenc_bf16_volume_plain_matches_jax_kernel():
    """K1 over a bf16 volume with fp32 convc1 parameters (not
    bf16-representable) against the TPU lookup kernel with its convc1
    epilogue over the bf16 flat pyramid (interpret mode): both round the
    window values and the weight to bf16, sum in fp32 and add the fp32
    bias. Measured: 1.6e-7 of the output scale."""
    f1, f2, coords, _, _ = _corr_case()
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((324, 256)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(256) * 0.05).astype(np.float32)
    pyr = corr_pyramid_flat(jnp.asarray(f1, jnp.bfloat16),
                            jnp.asarray(f2, jnp.bfloat16), 4,
                            out_dtype=jnp.bfloat16, interpret=True)
    want = corr_lookup_flat_moenc(pyr, jnp.asarray(coords), jnp.asarray(w),
                                  jnp.asarray(b), interpret=True)
    tpyr = corr.corr_pyramid(torch.from_numpy(f1).to(BF),
                             torch.from_numpy(f2).to(BF), 4,
                             out_dtype=torch.bfloat16)
    got = corr.corr_lookup_moenc_bf16_volume(
        tpyr, torch.from_numpy(coords), torch.from_numpy(w),
        torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 13, 256)
    assert _rel_err(got.numpy(), want) < 2 ** -8


# ---- RAFT: an fp32 refinement over a bf16 volume --------------------------


def _refine_case():
    """RAFT's weights and features of two pairs on a 16 x 16 grid: the
    second map of each pair is the first one shifted (by 2 and by -1
    columns), so the flows follow a clear correlation peak."""
    tree = _fill(_raft_tree(), 0)
    rng = np.random.default_rng(9)
    f1 = rng.standard_normal((2, 16, 16, 256)).astype(np.float32)
    f2 = np.stack([np.roll(f1[0], 2, axis=1), np.roll(f1[1], -1, axis=1)])
    net = np.tanh(rng.standard_normal((2, 16, 16, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((2, 16, 16, 128)), 0).astype(
        np.float32)
    return tree, (f1, f2, net, inp)


@functools.lru_cache(maxsize=1)
def _jax_fp32_refine():
    tree, args = _refine_case()
    _, up = JaxRAFT().apply({"params": tree},
                            *(jnp.asarray(a) for a in args), 4,
                            method="refine")
    return np.asarray(up)


@pytest.mark.parametrize("layout", ["flat", "batched"])
def test_raft_fp32_refine_over_bf16_volume_matches_jax(layout):
    """RAFT with fp32 parameters refining over a bf16 volume
    (`corr_volume_dtype=torch.bfloat16`, the JAX bf16 pipeline's RAFT with
    raft_bf16_refine=False): 'flat' through K1 over a bf16 volume,
    'batched' through K7's bf16 form and an fp32 convc1. The JAX package
    builds a bf16 volume only off the CPU; on the CPU its refine is fp32
    throughout, which is the oracle here, so the difference is the
    volume's rounding (and, in 'flat', convc1's bf16 operands). Measured:
    flows up to 8.2 px, max drift 0.0054 px (6.6e-4 of the flow scale) in
    'flat', 0.0041 px (4.9e-4) in 'batched'; the port's fp32 refine is
    6.2e-6 px from the JAX one."""
    tree, args = _refine_case()
    model = _load(RAFT(corr_layout=layout, corr_volume_dtype=BF), tree,
                  RAFT_RENAMES)
    with torch.no_grad():
        _, up = model.refine(*(torch.from_numpy(a).permute(0, 3, 1, 2)
                               for a in args), 4)
    assert up.dtype == torch.float32
    want = _jax_fp32_refine()
    drift = np.abs(up.permute(0, 2, 3, 1).numpy() - want).max()
    scale = np.abs(want).max()
    assert scale > 1.0                # the flows follow the shifts
    assert drift <= 0.02 and drift / scale <= 3e-3, (drift, scale)


def test_jax_bf16_refine_in_the_batched_layout_raises():
    """The JAX package cannot refine in bf16 in the batched corr layout:
    its lookup returns fp32 windows, convc1 (a plain conv,
    propainter_tpu/models/raft.py:122) promotes them and the GRU's bf16
    carry to fp32, and `nn.scan` refuses the changed carry at trace time.
    So the port's pipeline refuses precision='bf16' with shard_inference
    unless raft_bf16_refine=False, and its RAFT refuses a bf16 refinement
    in the batched layout."""
    tree, (f1, _, net, _) = _refine_case()
    feat = jnp.asarray(f1[:1, :8, :8], jnp.bfloat16)
    hid = jnp.asarray(net[:1, :8, :8], jnp.bfloat16)
    with pytest.raises(TypeError, match="carry"):
        JaxRAFT(corr_layout="batched", corr_volume_dtype="bfloat16").apply(
            {"params": _jax_bf16_tree(tree)}, feat, feat, hid, hid, 1,
            method="refine")
    model = RAFT(corr_layout="batched").to(BF)
    feat_t = torch.zeros(1, 256, 8, 8, dtype=BF)
    hid_t = torch.zeros(1, 128, 8, 8, dtype=BF)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="raft.py:122"):
        model.refine(feat_t, feat_t, hid_t, hid_t, 1)


# ---- on the card: the kernels against their plain versions ---------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on a GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the bf16 kernels' tolerance relative to the output scale (chip_smoke.py's
# BF16_REL_TOL): two bf16 steps
_BF16_REL_TOL = 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("frames", ["every other 0", "every other 1", "one"])
@pytest.mark.parametrize("occupancy", ["clean", "dirty", "mixed"])
def test_cuda_sparse_window_attention_bf16_kernel(cuda, occupancy, frames):
    """K5's bf16 form at T * win = 855 query rows (19 frames of 45 tokens,
    7 query tiles of 128, the last partial) and 8 pooled tokens: every
    window clean, every window dirty, or both kinds; every other frame
    selected from either parity, or one frame."""
    rng = np.random.default_rng(12)
    n_head, nW, T, win, P, ch = 2, 3, 19, 45, 8, 128
    q, k, v = (rng.standard_normal((n_head, nW, T, win, ch))
               for _ in range(3))
    rk, rv = (rng.standard_normal((n_head, nW, 4, T, win, ch))
              for _ in range(2))
    pk, pv = (rng.standard_normal((n_head, T, P, ch)) for _ in range(2))
    windows = [torch.from_numpy(a).to(cuda, BF)
               for a in (q, k, v, rk, rv, pk, pv)]
    roll_valid = torch.zeros(4 * win, dtype=torch.bool, device=cuda)
    roll_valid[torch.as_tensor(_valid_rolled_indices((5, 9), (3, 5)))] = True
    occ = torch.tensor([{"clean": [0.0] * nW, "dirty": [1.0] * nW,
                         "mixed": [1.0, 0.0, 2.0]}[occupancy]], device=cuda)
    t = torch.arange(T, device=cuda)
    fsel = {"every other 0": t % 2 == 0, "every other 1": t % 2 == 1,
            "one": t == 7}[frames][None]
    got = attention.sparse_window_attention_bf16(*windows, roll_valid, occ,
                                                 fsel, n_head)
    want = attention._sparse_window_attention_plain(*windows, roll_valid,
                                                    occ, fsel, n_head)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= _BF16_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["most keys masked", "shard rows"])
def test_cuda_window_attention_bf16_ragged(cuda, case):
    """K4's bf16 form at ragged shapes: Tq 130 and Tk 70 (a partial query
    tile of the 128-row block and a partial key tile) with a bias that
    masks 64 of the 70 keys; and B = 4 batch rows of different biases
    over 3 problems each, as the shard path calls it (64 middle keys
    masked; the whole first 128-key tile and more masked; one tail window
    all but masked)."""
    from propainter_tpu_torch.ops import flash_attention

    rng = np.random.default_rng(13)
    B, G, Tq, Tk = (1, 3, 130, 70) if case == "most keys masked" else (
        4, 3, 130, 200)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, G, T_, 128))).to(
        cuda, BF) for T_ in (Tq, Tk, Tk))
    bias = torch.zeros(B, Tk, device=cuda)
    if case == "most keys masked":
        bias[:, :64] = flash_attention.NEG_INF
    else:
        bias[0, 64:128] = flash_attention.NEG_INF
        bias[1, :150] = flash_attention.NEG_INF
        bias[3, 10:] = flash_attention.NEG_INF
    got = flash_attention.flash_window_attention_bf16(q, k, v, bias, 0.088)
    want = flash_attention._flash_window_attention_bf16_plain(q, k, v, bias,
                                                              0.088)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= _BF16_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "far", "outside", "odd widths"])
def test_cuda_corr_lookup_bf16_kernel(cuda, case):
    """K7's bf16 form against its plain version on a ragged 8 x 13 map
    (level 3 is 1 x 1), with coordinates near the grid, up to 40 pixels
    outside it, or every one 200 pixels outside every level; and on the
    9 x 27 map of `_k7_bf16_case` (odd widths): the same bf16 taps and
    rounding, fp32 out."""
    f1, f2, coords, _, _ = _corr_case()
    rng = np.random.default_rng(13)
    if case == "far":
        coords = (coords + rng.standard_normal(coords.shape) * 15.0).astype(
            np.float32)
        coords[0, 0, :3] = [[-40.0, 3.0], [52.0, 47.0], [6.5, -40.0]]
    elif case == "outside":
        sign = np.where(np.arange(coords[..., :1].size).reshape(
            coords[..., :1].shape) % 2 == 0, 1.0, -1.0)
        coords = (coords + 200.0 * sign).astype(np.float32)
    if case == "odd widths":
        pyr, coords, _ = _k7_bf16_case("9 x 27 odd widths")
        pyr = [lvl.to(cuda) for lvl in pyr]
    else:
        f1, f2 = (torch.from_numpy(a).to(cuda, BF) for a in (f1, f2))
        pyr = corr.corr_pyramid(f1, f2, 4, out_dtype=torch.bfloat16)
    coords = torch.from_numpy(coords).to(cuda)
    got = corr.corr_lookup_bf16(pyr, coords)
    want = corr._corr_lookup_plain(pyr, coords)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "far", "outside"])
@pytest.mark.parametrize("form", ["bf16", "bf16 volume"])
def test_cuda_corr_lookup_moenc_bf16_kernel(cuda, form, case):
    """K1's bf16 forms (bf16 convc1 parameters, and fp32 ones over a bf16
    volume: one kernel template) against their plain version on a ragged
    8 x 13 map of 2 pairs (208 queries: three full 64-query tiles and a
    partial one, fewer than the card's SMs; level 3 is 1 x 1), with
    coordinates near the grid, up to 40 pixels outside it, or every one
    200 pixels outside every level; within two bf16 steps of the output
    scale."""
    f1, f2, coords, w, b = _corr_case()
    rng = np.random.default_rng(14)
    if case == "far":
        coords = (coords + rng.standard_normal(coords.shape) * 15.0).astype(
            np.float32)
        coords[0, 0, :3] = [[-40.0, 3.0], [52.0, 47.0], [6.5, -40.0]]
    elif case == "outside":
        sign = np.where(np.arange(coords[..., :1].size).reshape(
            coords[..., :1].shape) % 2 == 0, 1.0, -1.0)
        coords = (coords + 200.0 * sign).astype(np.float32)
    f1, f2 = (torch.from_numpy(a).to(cuda, BF) for a in (f1, f2))
    coords = torch.from_numpy(coords).to(cuda)
    pyr = corr.corr_pyramid(f1, f2, 4, out_dtype=torch.bfloat16)
    w, b = (torch.from_numpy(a).to(cuda) for a in (w, b))
    if form == "bf16":
        w, b = w.to(BF), b.to(BF)
        got = corr.corr_lookup_moenc_bf16(pyr, coords, w, b)
    else:
        got = corr.corr_lookup_moenc_bf16_volume(pyr, coords, w, b)
    want = corr._corr_lookup_moenc_bf16_plain(pyr, coords, w, b, 4)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 13, 256)
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= _BF16_REL_TOL
