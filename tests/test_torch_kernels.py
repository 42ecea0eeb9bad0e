"""Each CUDA kernel's plain PyTorch version against the JAX kernel function
it replaces, run as the JAX package's own tests run it on the CPU (Pallas
interpret mode), at tiny shapes. The kernels themselves run only on a GPU:
the `cuda`-marked tests hold them against their plain versions there and
skip on a host without one.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import jax

from propainter_tpu.ops.attention import sparse_window_attention_pallas
from propainter_tpu.ops.corr import corr_pyramid as jax_corr_pyramid
from propainter_tpu.ops.corr_pallas import (
    corr_lookup_flat, corr_lookup_fused, corr_pyramid_flat, corr_pyramid_t)
from propainter_tpu.ops.deform import (
    split_offset_mask_channels as jax_split_offset_mask)
from propainter_tpu.ops import deform_pallas
from propainter_tpu.ops.deform_pallas import modulated_deform_conv2d_fused_out
from propainter_tpu.ops.flash_attention import (
    flash_window_attention as jax_flash_attention)

from propainter_tpu_torch.models.propainter import _valid_rolled_indices
from propainter_tpu_torch.ops import attention, corr, deform, flash_attention
from propainter_tpu_torch.ops.warp import coords_grid


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _corr_inputs(seed=0):
    rng = np.random.default_rng(seed)
    B, H, W, D = 2, 16, 16, 32
    f1, f2 = _rand(rng, B, H, W, D), _rand(rng, B, H, W, D)
    coords = (np.asarray(coords_grid(B, H, W)) + _rand(rng, B, H, W, 2,
                                                       scale=3.0))
    coords[0, 0, :4] = [[-7.0, 2.0], [20.0, 3.5], [3.25, -6.0], [40.0, 40.0]]
    w = _rand(rng, 324, 256, scale=0.05)
    b = _rand(rng, 256, scale=0.05)
    return f1, f2, coords, w, b


def _deform_inputs(seed=1):
    rng = np.random.default_rng(seed)
    B, H, W, C, dg = 1, 6, 10, 64, 16
    x = _rand(rng, B, H, W, C)
    raw = _rand(rng, B, H, W, 27 * dg)
    flow = _rand(rng, B, H, W, 2, scale=2.0)
    weight = _rand(rng, 3, 3, C, 128, scale=0.05)
    bias = _rand(rng, 128, scale=0.1)
    return x, raw, flow, weight, bias, dg


def _attention_inputs(seed=2):
    rng = np.random.default_rng(seed)
    B, G, Tq, Tk, ch = 1, 3, 50, 150, 128
    q, k, v = (_rand(rng, B, G, T_, ch) for T_ in (Tq, Tk, Tk))
    bias = np.zeros((B, Tk), np.float32)
    bias[:, 100:] = -1e9
    return q, k, v, bias, 1.0 / math.sqrt(ch)


# (occupancy, frame_select) per batch row; "frame0_off" leaves frame 0 of
# both rows unselected (the odd-block temporal dilation), the -1e9 path of
# the TPU kernel's running max; "none_selected" gives row 0's dirty windows
# no frame at all (every logit -1e9: the mean of all values)
_SPARSE_CASES = {
    "dirty": ([[2.0, 0.0, 0.5, 1.0], [0.0, 3.0, 1.0, 0.0]],
              [[1, 0, 1, 1], [1, 1, 1, 0]]),
    "all_clean": ([[0.0] * 4, [0.0, 0.0, 0.9, 0.0]],
                  [[1, 0, 1, 1], [1, 1, 1, 0]]),
    "frame0_off": ([[1.0] * 4, [2.0] * 4], [[0, 1, 0, 1], [0, 0, 1, 1]]),
    "none_selected": ([[1.0, 0.0, 1.0, 1.0], [1.0] * 4],
                      [[0, 0, 0, 0], [1, 0, 1, 0]]),
}


def _sparse_attention_inputs(case, seed=3, ch=16):
    """Two batch rows of two heads, 2x2 windows of (5, 9) tokens, 4 frames,
    8 pooled tokens: the shapes of tests/test_pallas_attention.py."""
    rng = np.random.default_rng(seed)
    B, n_head, nW, T, win, P = 2, 2, 4, 4, 45, 8
    BH = B * n_head
    q, k, v = (_rand(rng, BH, nW, T, win, ch) for _ in range(3))
    rk, rv = (_rand(rng, BH, nW, 4, T, win, ch) for _ in range(2))
    pk, pv = (_rand(rng, BH, T, P, ch) for _ in range(2))
    roll_valid = np.zeros(4 * win, np.bool_)
    roll_valid[_valid_rolled_indices((5, 9), (3, 5))] = True
    occ, fsel = _SPARSE_CASES[case]
    return (q, k, v, rk, rv, pk, pv, roll_valid,
            np.asarray(occ, np.float32), np.asarray(fsel, np.bool_), n_head)


def _deform_sample_inputs(seed=4):
    """Coordinates around each tap, some far outside the image."""
    rng = np.random.default_rng(seed)
    B, H, W, C, dg, K = 2, 6, 10, 32, 4, 9
    x = _rand(rng, B, H, W, C)
    base_y = np.arange(H, dtype=np.float32)[None, :, None, None, None]
    base_x = np.arange(W, dtype=np.float32)[None, None, :, None, None]
    sy = (base_y + _rand(rng, B, H, W, dg, K, scale=3.0)).astype(np.float32)
    sx = (base_x + _rand(rng, B, H, W, dg, K, scale=3.0)).astype(np.float32)
    sy[0, 0, 0, 0, :3] = [-1.5, H - 0.25, 40.0]
    mask = rng.uniform(0, 1, (B, H, W, dg, K)).astype(np.float32)
    return x, sy, sx, mask, dg


def test_corr_pyramid_build_plain_matches_jax():
    """K2: levels 1-3 by 2x2 average pooling of the level-0 volume."""
    f1, f2, *_ = _corr_inputs()
    want = jax_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = corr.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    for j, t in zip(want, got):
        np.testing.assert_allclose(np.asarray(j)[..., 0], t.numpy(), rtol=0,
                                   atol=2e-5)


def test_corr_lookup_moenc_plain_matches_jax_kernel():
    """K1 against the TPU lookup kernel (interpret mode) over the flat
    pyramid, followed by convc1 in fp32 (the TPU epilogue's bf16 operand
    rounding is not part of the fp32 semantics)."""
    f1, f2, coords, w, b = _corr_inputs()
    pyr = corr_pyramid_flat(jnp.asarray(f1), jnp.asarray(f2), 4,
                            interpret=True)
    window = np.asarray(corr_lookup_flat(pyr, jnp.asarray(coords),
                                         interpret=True))
    want = np.maximum(window.reshape(-1, 324) @ w + b, 0.0)
    tpyr = corr.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    got = corr.corr_lookup_moenc(tpyr, torch.from_numpy(coords),
                                 torch.from_numpy(w), torch.from_numpy(b))
    # window values agree to fp32 noise; the 324-term product adds its own
    np.testing.assert_allclose(
        corr.corr_lookup(tpyr, torch.from_numpy(coords)).numpy(), window,
        rtol=0, atol=3e-5)
    np.testing.assert_allclose(got.numpy().reshape(-1, 256), want, rtol=0,
                               atol=5e-5)


def test_corr_lookup_plain_matches_jax_kernel():
    """K7 against the TPU lookup kernel without the convc1 epilogue
    (`corr_lookup_fused` over `corr_pyramid_t`, the pallas_call at
    corr_pallas.py:363, in interpret mode) on a ragged 8 x 13 map (level 3
    is 1 x 1) with coordinates up to 40 pixels outside it."""
    f1, f2, coords, _, _ = _k1_case("far")
    want = corr_lookup_fused(
        corr_pyramid_t(jnp.asarray(f1), jnp.asarray(f2), 4),
        jnp.asarray(coords), interpret=True)
    pyr = corr.corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    got = corr.corr_lookup(pyr, torch.from_numpy(coords))
    assert got.shape == (1, 8, 13, 324)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-5)


def test_modulated_deform_conv2d_plain_matches_jax_kernel():
    """K3 against the fused TPU deform kernel (interpret mode)."""
    x, raw, flow, weight, bias, dg = _deform_inputs()
    j_off, j_mask = jax_split_offset_mask(jnp.asarray(raw), dg, 3.0,
                                          jnp.asarray(flow))
    want = modulated_deform_conv2d_fused_out(
        jnp.asarray(x), j_off, j_mask, jnp.asarray(weight),
        jnp.asarray(bias), interpret=True)
    t_off, t_mask = deform.split_offset_mask_channels(
        torch.from_numpy(raw), dg, 3.0, torch.from_numpy(flow))
    np.testing.assert_allclose(t_off.numpy(), np.asarray(j_off), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(t_mask.numpy(), np.asarray(j_mask), rtol=0,
                               atol=1e-6)
    got = deform.modulated_deform_conv2d(
        torch.from_numpy(x), t_off, t_mask, torch.from_numpy(weight),
        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("with_bias", [True, False])
def test_flash_window_attention_plain_matches_jax_kernel(with_bias):
    """K4 against the TPU flash attention kernel (interpret mode)."""
    q, k, v, bias, scale = _attention_inputs()
    bias = bias if with_bias else None
    want = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), scale, interpret=True)
    got = flash_attention.flash_window_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", list(_SPARSE_CASES))
def test_sparse_window_attention_plain_matches_jax_kernel(case):
    """K5 against the TPU sparse window attention kernel (interpret mode):
    mixed dirty/clean windows (a fractional occupancy counts as clean), all
    clean, and frame 0 unselected. fp32 softmax over at most 1080 keys;
    only summation order differs."""
    *arrays, n_head = _sparse_attention_inputs(case)
    want = sparse_window_attention_pallas(
        *map(jnp.asarray, arrays), n_head, interpret=True)
    got = attention.sparse_window_attention(*map(torch.from_numpy, arrays),
                                            n_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# REL_TOL of chip_smoke.py: a kernel against its plain version, relative to
# the output scale max(1, max |ref|)
_REL_TOL = 1e-4


def _tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b from TF32 operands with exact products summed in wide
    precision and rounded to fp32, as an mma accumulator holds them: one
    pass (big·big) or three (big·big + big·small + small·big)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_big, b_big = _tf32(a), _tf32(b)
    terms = [(a_big, b_big)]
    if passes == 3:
        terms += [(a_big, _tf32(b - b_big)), (_tf32(a - a_big), b_big)]
    return sum(x.astype(np.float64) @ y.astype(np.float64)
               for x, y in terms).astype(np.float32)


def _tf32_attention(q, k, v, bias, scale, passes):
    """K4's arithmetic: both products from TF32 operands, fp32 softmax."""
    s = _tf32_matmul(q, np.swapaxes(k, -1, -2), passes) * np.float32(scale)
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    return _tf32_matmul(p, v, passes) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("with_bias", [True, False])
def test_3xtf32_attention_within_tolerance_of_jax_kernel(with_bias):
    """The numerics of the K4/K5 tile: 3xTF32 products stay within the
    kernels' tolerance of the TPU flash attention kernel (interpret mode),
    and one pass of TF32 does not."""
    q, k, v, bias, scale = _attention_inputs()
    bias = bias if with_bias else None
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), scale, interpret=True))
    tol = _REL_TOL * max(1.0, np.abs(want).max())
    err3 = np.abs(_tf32_attention(q, k, v, bias, scale, 3) - want).max()
    err1 = np.abs(_tf32_attention(q, k, v, bias, scale, 1) - want).max()
    assert err3 <= tol / 10, (err3, tol)
    assert err1 > tol, (err1, tol)


def test_3xtf32_deform_conv_within_tolerance_of_jax_kernel():
    """The numerics of K3: fp32 samples x mask, contracted with the weight
    in 3xTF32 in the kernel's tap-major K order (row k * C + c), stay within
    a tenth of the kernels' tolerance of the fused TPU deform kernel
    (interpret mode) at the flow completion's width: C 256, dg 16, 2304
    terms per output."""
    rng = np.random.default_rng(9)
    B, H, W, C, dg = 1, 4, 6, 256, 16
    x = _rand(rng, B, H, W, C)
    raw = _rand(rng, B, H, W, 27 * dg)
    flow = _rand(rng, B, H, W, 2, scale=2.0)
    weight = _rand(rng, 3, 3, C, 128, scale=0.05)
    bias = _rand(rng, 128, scale=0.1)
    j_off, j_mask = jax_split_offset_mask(jnp.asarray(raw), dg, 5.0,
                                          jnp.asarray(flow))
    want = np.asarray(modulated_deform_conv2d_fused_out(
        jnp.asarray(x), j_off, j_mask, jnp.asarray(weight),
        jnp.asarray(bias), interpret=True)).reshape(-1, 128)
    off = torch.from_numpy(np.array(j_off))
    sy, sx = deform._tap_coords(off)
    samples = deform._deform_sample_plain(
        torch.from_numpy(x), sy, sx, torch.from_numpy(np.array(j_mask)), dg)
    # (B, H, W, dg, 9, Cg) -> (positions, 9 * C), column k * C + g * Cg + c
    a = samples.permute(0, 1, 2, 4, 3, 5).reshape(B * H * W, 9 * C).numpy()
    got = _tf32_matmul(a, weight.reshape(9 * C, 128), passes=3) + bias
    tol = _REL_TOL * max(1.0, np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol / 10, (err, tol)


def _k1_k_order():
    """K1's K order: k-step 2p + h of 16-channel group p takes channel 16p +
    4t + 2h in slot t and the next channel in slot t + 4; 336 channels, the
    last 12 zero padding."""
    return np.asarray([16 * p + 4 * (s % 4) + 2 * h + s // 4
                       for p in range(21) for h in range(2)
                       for s in range(8)])


def test_3xtf32_corr_lookup_moenc_within_tolerance_of_jax_kernel():
    """The numerics of K1: the TPU lookup kernel's windows (interpret mode),
    contracted with convc1's weight in 3xTF32 in the kernel's K order (324
    terms zero-padded to 336), stay within a tenth of the kernels'
    tolerance of convc1 in fp32; one pass of TF32 does not."""
    f1, f2, coords, w, b = _corr_inputs()
    pyr = corr_pyramid_flat(jnp.asarray(f1), jnp.asarray(f2), 4,
                            interpret=True)
    window = np.asarray(corr_lookup_flat(pyr, jnp.asarray(coords),
                                         interpret=True)).reshape(-1, 324)
    want = np.maximum(window @ w + b, 0.0)
    order = _k1_k_order()
    a = np.pad(window, ((0, 0), (0, 12)))[:, order]
    wk = np.pad(w, ((0, 12), (0, 0)))[order]
    tol = _REL_TOL * max(1.0, np.abs(want).max())
    err3 = np.abs(np.maximum(_tf32_matmul(a, wk, 3) + b, 0.0) - want).max()
    err1 = np.abs(np.maximum(_tf32_matmul(a, wk, 1) + b, 0.0) - want).max()
    assert sorted(order) == list(range(336))
    assert err3 <= tol / 10, (err3, tol)
    assert err1 > tol, (err1, tol)


@pytest.mark.parametrize("n_pos, C, slots, want", [
    (60 * 108, 128, 264, 2),         # generator: 102 tiles x 36 chunks
    (2 * 30 * 54, 256, 264, 4),      # flow completion: 51 tiles x 72
    (60 * 108, 128, 396, 3),         # the two at 3 blocks per SM
    (2 * 30 * 54, 256, 396, 6),
    (64 * 300, 128, 264, 1),         # the tiles alone fill the card
    (10, 32, 264, 3),                # one tile of 9 chunks
])
def test_k3_split_keeps_the_grid_resident(n_pos, C, slots, want):
    split = deform.k3_split(n_pos, C, slots)
    assert split == want
    chunks = 9 * C // deform.K3_CHUNK
    assert chunks % split == 0 and split <= deform.K3_MAX_SPLIT


def test_deform_sample_plain_matches_jax_kernel():
    """K6 against the TPU deform sampling kernel (interpret mode)."""
    x, sy, sx, mask, dg = _deform_sample_inputs()
    want = deform_pallas.deform_sample_pallas(
        *map(jnp.asarray, (x, sy, sx, mask)), dg, interpret=True)
    got = deform.deform_sample(*map(torch.from_numpy, (x, sy, sx, mask)), dg)
    assert got.shape == want.shape == (2, 6, 10, 4, 9, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_modulated_deform_conv2d_fused_matches_jax():
    """K6 + one matmul against the JAX function of that name (interpret
    mode); 576-term products, fp32 noise."""
    x, raw, flow, weight, bias, dg = _deform_inputs()
    j_off, j_mask = jax_split_offset_mask(jnp.asarray(raw), dg, 3.0,
                                          jnp.asarray(flow))
    want = deform_pallas.modulated_deform_conv2d_fused(
        jnp.asarray(x), j_off, j_mask, jnp.asarray(weight),
        jnp.asarray(bias), interpret=True)
    got = deform.modulated_deform_conv2d_fused(
        torch.from_numpy(x), torch.from_numpy(np.array(j_off)),
        torch.from_numpy(np.array(j_mask)), torch.from_numpy(weight),
        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("name", ["modulated_deform_conv2d_opt",
                                  "modulated_deform_conv2d_opt2"])
def test_deform_dispatchers_match_jax_grad(name):
    """The differentiable dispatchers: values and the gradients of a
    squared-sum loss in every input against jax.grad of the JAX
    dispatcher of the same name (its CPU path, the XLA formulation)."""
    x, raw, flow, weight, bias, dg = _deform_inputs(seed=6)
    off, mask = (np.array(a) for a in jax_split_offset_mask(
        jnp.asarray(raw), dg, 3.0, jnp.asarray(flow)))
    inputs = (x, off, mask, weight, bias)
    jax_fn = getattr(deform_pallas, name)
    want, want_grads = jax.value_and_grad(
        lambda *a: jnp.sum(jax_fn(*a) ** 2), argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    loss = (getattr(deform, name)(*leaves) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for leaf, g in zip(leaves, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=0,
                                   atol=2e-4 * max(1.0, np.abs(g).max()))


def test_wrappers_refuse_other_devices():
    """A tensor neither on the CPU nor on a GPU is refused, never moved."""
    t = torch.empty((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError):
        corr.corr_lookup_moenc([t] * 4, t, t, t)
    with pytest.raises(ValueError):
        corr.corr_lookup([t] * 4, t)
    with pytest.raises(ValueError):
        corr.corr_pyramid_build(torch.empty((4, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        deform.modulated_deform_conv2d(t, t, t, t, None)
    with pytest.raises(ValueError):
        flash_attention.flash_window_attention(t, t, t, None, 1.0)
    with pytest.raises(ValueError):
        deform.deform_sample(t, t, t, t, 1)
    w = torch.empty((1, 1, 1, 1, 1), device="meta")
    with pytest.raises(ValueError):
        attention.sparse_window_attention(w, w, w, w, w, w, w, w, w, w, 1)


# ---- on the card: each kernel against its plain version ------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on a GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _to(dev, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


@pytest.mark.cuda
def test_cuda_corr_kernels(cuda):
    f1, f2, coords, w, b = _to(cuda, *_corr_inputs())
    level0 = corr.corr_pyramid(f1, f2, 4)[0]
    pyr = corr.corr_pyramid_build(level0, 4)
    for got, want in zip(pyr, corr._corr_pyramid_build_plain(level0, 4)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    got = corr.corr_lookup_moenc(pyr, coords, w, b)
    want = corr._corr_lookup_moenc_plain(pyr, coords, w, b, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def _k1_case(case, seed=11):
    """K1's inputs on the card: 'ragged' 8 x 13 maps (104 queries: three
    full 32-query tiles and a partial one; level 3 is 1 x 1), 'far' the same
    with coordinates to 40 pixels outside, 'main_path' one RAFT iteration of
    the main path (24 pair-directions at 30 x 54: 1215 tiles, more than the
    card's persistent blocks)."""
    rng = np.random.default_rng(seed)
    B, H, W = (24, 30, 54) if case == "main_path" else (1, 8, 13)
    f1, f2 = _rand(rng, B, H, W, 64), _rand(rng, B, H, W, 64)
    coords = np.asarray(coords_grid(B, H, W)) + _rand(
        rng, B, H, W, 2, scale=15.0 if case == "far" else 3.0)
    if case == "far":
        coords[0, 0, :3] = [[-40.0, 3.0], [52.0, 47.0], [6.5, -40.0]]
    return (f1, f2, coords.astype(np.float32),
            _rand(rng, 324, 256, scale=0.05), _rand(rng, 256, scale=0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "far", "main_path"])
def test_cuda_corr_lookup_moenc_kernel(cuda, case):
    f1, f2, coords, w, b = _to(cuda, *_k1_case(case))
    pyr = corr.corr_pyramid(f1, f2, 4)
    got = corr.corr_lookup_moenc(pyr, coords, w, b)
    want = corr._corr_lookup_moenc_plain(pyr, coords, w, b, 4)
    tol = _REL_TOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "far", "main_path"])
def test_cuda_corr_lookup_kernel(cuda, case):
    """K7 against its plain version on K1's cases."""
    f1, f2, coords, _, _ = _to(cuda, *_k1_case(case))
    pyr = corr.corr_pyramid(f1, f2, 4)
    got = corr.corr_lookup(pyr, coords)
    want = corr._corr_lookup_plain(pyr, coords)
    tol = _REL_TOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_cuda_deform_kernel(cuda):
    x, raw, flow, weight, bias, dg = _deform_inputs()
    x, raw, flow, weight, bias = _to(cuda, x, raw, flow, weight, bias)
    off, mask = deform.split_offset_mask_channels(raw, dg, 3.0, flow)
    off, mask = off.contiguous(), mask.contiguous()
    got = deform.modulated_deform_conv2d(x, off, mask, weight, bias)
    want = deform._modulated_deform_conv2d_plain(x, off, mask, weight, bias)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
def test_cuda_attention_kernel(cuda, with_bias):
    q, k, v, bias, scale = _attention_inputs()
    q, k, v, bias = _to(cuda, q, k, v, bias if with_bias else None)
    got = flash_attention.flash_window_attention(q, k, v, bias, scale)
    want = flash_attention._flash_window_attention_plain(q, k, v, bias,
                                                         scale)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
def test_cuda_attention_kernel_ragged(cuda, with_bias):
    """A partial query tile (130 rows), a partial key tile (70 keys) and a
    bias that masks a whole 32-key tile."""
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, 1, 3, T_, 128) for T_ in (130, 70, 70))
    bias = np.zeros((1, 70), np.float32)
    bias[:, 32:64] = -1e9
    q, k, v, bias = _to(cuda, q, k, v, bias if with_bias else None)
    scale = 1.0 / math.sqrt(128)
    got = flash_attention.flash_window_attention(q, k, v, bias, scale)
    want = flash_attention._flash_window_attention_plain(q, k, v, bias,
                                                         scale)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_sparse_window_attention_kernel_main_path_rows(cuda):
    """T * win = 855 query rows per window (19 frames of 45 tokens), as on
    the main path: the last query tile is partial; one dirty and one clean
    window, every other frame selected."""
    rng = np.random.default_rng(8)
    n_head, nW, T, win, P, ch = 2, 2, 19, 45, 8, 128
    q, k, v = (_rand(rng, n_head, nW, T, win, ch) for _ in range(3))
    rk, rv = (_rand(rng, n_head, nW, 4, T, win, ch) for _ in range(2))
    pk, pv = (_rand(rng, n_head, T, P, ch) for _ in range(2))
    roll_valid = np.zeros(4 * win, np.bool_)
    roll_valid[_valid_rolled_indices((5, 9), (3, 5))] = True
    occ = np.asarray([[1.0, 0.0]], np.float32)
    fsel = (np.arange(T) % 2 == 0)[None]
    tensors = _to(cuda, q, k, v, rk, rv, pk, pv, roll_valid, occ, fsel)
    got = attention.sparse_window_attention(*tensors, n_head)
    want = attention._sparse_window_attention_plain(*tensors, n_head)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SPARSE_CASES))
def test_cuda_sparse_window_attention_kernel(cuda, case):
    *arrays, n_head = _sparse_attention_inputs(case, ch=128)
    tensors = _to(cuda, *arrays)
    got = attention.sparse_window_attention(*tensors, n_head)
    want = attention._sparse_window_attention_plain(*tensors, n_head)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_deform_sample_kernel(cuda):
    x, sy, sx, mask, dg = _deform_sample_inputs()
    x, sy, sx, mask = _to(cuda, x, sy, sx, mask)
    got = deform.deform_sample(x, sy, sx, mask, dg)
    want = deform._deform_sample_plain(x, sy, sx, mask, dg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _ragged_deform_inputs(C, dg, seed=10):
    """A 5 x 13 image (65 positions: a full 64-position tile and one more)
    whose offsets reach 40 pixels outside it."""
    rng = np.random.default_rng(seed)
    B, H, W = 1, 5, 13
    x = _rand(rng, B, H, W, C)
    off = _rand(rng, B, H, W, dg, 9, 2, scale=15.0)
    off[0, 0, 0, 0, :3] = [[-40.0, 3.0], [2.0, 40.0], [40.0, -40.0]]
    mask = rng.uniform(0, 1, (B, H, W, dg, 9)).astype(np.float32)
    weight = _rand(rng, 3, 3, C, 128, scale=0.05)
    bias = _rand(rng, 128, scale=0.1)
    return x, off, mask, weight, bias


@pytest.mark.cuda
@pytest.mark.parametrize("C, dg", [(128, 32), (128, 16), (256, 16),
                                   (64, 2)])
def test_cuda_deform_kernel_ragged(cuda, C, dg):
    """K3 at group widths 4, 8, 16 and 32, a ragged position count and
    coordinates far outside the image, at every cluster split."""
    x, off, mask, weight, bias = _to(cuda, *_ragged_deform_inputs(C, dg))
    want = deform._modulated_deform_conv2d_plain(x, off, mask, weight, bias)
    tol = _REL_TOL * max(1.0, want.abs().max().item())
    for split in range(1, deform.K3_MAX_SPLIT + 1):
        got = deform.modulated_deform_conv2d(x, off, mask, weight, bias,
                                             split=split)
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C, dg", [(128, 16), (256, 16)])
def test_cuda_deform_sample_kernel_ragged(cuda, C, dg):
    """K6 at group widths 8 and 16 on the ragged image."""
    x, off, mask, _, _ = _ragged_deform_inputs(C, dg)
    x, off, mask = _to(cuda, x, off, mask)
    sy, sx = (c.contiguous() for c in deform._tap_coords(off))
    got = deform.deform_sample(x, sy, sx, mask, dg)
    want = deform._deform_sample_plain(x, sy, sx, mask, dg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
