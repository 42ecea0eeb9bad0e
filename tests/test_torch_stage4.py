"""Stage 4 of the PyTorch port scheduled as the JAX package schedules it:
the occupancy bitmap and the bucket planner against the JAX originals, the
generator's bucketed branch A, last-block query shrink and precomputed
features against the JAX generator and against its own plain call, and
`ProPainterPipeline.generate` under every (occupancy_bucketing,
encoder_carry) combination against the JAX package's plan and output.

On the CPU with the plain versions of the kernels; the JAX generator runs
its Pallas kernel in interpret mode. Full width (hidden 512, 4 heads,
window 5 x 9), depth 2, 144 x 160 frames: a 12 x 14 token grid, padded to
nW = 6 windows.
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu import pipeline as jax_pipeline
from propainter_tpu.models.propainter import (
    InpaintGenerator as JaxGenerator,
    masked_window_bitmap as jax_masked_window_bitmap)
from tests.test_torch_models import _fill, _generator_tree, _load

from propainter_tpu_torch import pipeline as torch_pipeline
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import (
    InpaintGenerator, masked_window_bitmap)
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.weights import INPAINT_RENAMES

H, W = 144, 160
HOLE = (slice(50, 90), slice(40, 100))   # 4 of the 6 windows dirty


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs this file beside
    other pytest-xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _tree():
    return _fill(_generator_tree(2), 21)


def _generator(attention_impl="flash"):
    return _load(InpaintGenerator(depths=2, attention_impl=attention_impl),
                 _tree(), INPAINT_RENAMES)


@pytest.mark.parametrize("size", [(144, 160), (58, 74)],
                         ids=["whole windows", "ragged"])
def test_masked_window_bitmap_matches_jax(size):
    """The port's bitmap equals the JAX package's on seeded masks (sparse
    dots, so some windows stay clean). 58 x 74: odd halvings, a token grid
    of 5 x 7 padded to one 5 x 9 window."""
    h, w = size
    rng = np.random.default_rng(4)
    masks = (rng.uniform(size=(2, 3, h, w, 1)) > 0.9995).astype(np.float32)
    masks[1, 0, : h // 3, : w // 4] = 1.0
    got = masked_window_bitmap(torch.from_numpy(masks)).numpy()
    want = np.asarray(jax_masked_window_bitmap(jnp.asarray(masks)))
    assert got.dtype == np.bool_ and 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nW", [16, 6])
def test_plan_bucket_subruns_matches_jax(nW):
    """The port's copy of the bucket planner equals the original on seeded
    bitmaps: runs of 1-20 windows, each window 0-nW dirty windows, some
    runs dirtier in the middle."""
    rng = np.random.default_rng(nW)
    for _ in range(40):
        n = int(rng.integers(1, 21))
        counts = rng.integers(0, nW + 1, n)
        if rng.uniform() < 0.5:
            counts[n // 3: 2 * n // 3] = nW
        bm = np.arange(nW)[None, :] < counts[:, None]
        bm = bm[:, rng.permutation(nW)]
        assert (torch_pipeline.plan_bucket_subruns(bm)
                == jax_pipeline.plan_bucket_subruns(bm))


def _window_inputs(seed, B=1, T=5, l_t=3, size=(H, W)):
    """B windows of T frames (the last a padded reference); window 0 has a
    hole dirtying 2 of the 6 attention windows at 144 x 160, the others
    none."""
    h, w = size
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (B, T, h, w, 3)).astype(np.float32)
    ff = rng.normal(0, 2, (B, l_t - 1, h, w, 2)).astype(np.float32)
    fb = rng.normal(0, 2, (B, l_t - 1, h, w, 2)).astype(np.float32)
    m_in = np.zeros((B, T, h, w, 1), np.float32)
    m_in[0, :, h * 5 // 12:h * 5 // 9, w * 5 // 16:w * 7 // 16] = 1
    m_upd = m_in.copy()
    m_upd[:, :, h * 4 // 9:h * 35 // 72] = 0
    valid = np.array([[True] * (T - 1) + [False]] * B)
    return frames, (ff, fb), m_in, m_upd, valid


def _port(gen, inputs, l_t, **kw):
    frames, (ff, fb), m_in, m_upd, valid = inputs
    t = torch.from_numpy
    with torch.no_grad():
        return gen(None if frames is None else t(frames), (t(ff), t(fb)),
                   t(m_in), t(m_upd), l_t,
                   frame_valid=t(valid), **kw)


@functools.lru_cache(maxsize=1)
def _bucket_case():
    """Two windows in one batch: window 0's bucket of 4 slots cycles its 2
    dirty windows, window 1 (no hole) has an all-False bucket. Returns the
    bucket, the port's bucketed and dense outputs and the JAX generator's
    bucketed output (jitted: its interpret-mode kernel runs 5x slower
    eagerly)."""
    l_t = 3
    inputs = _window_inputs(6, B=2)
    m_in = inputs[2]
    bm = masked_window_bitmap(torch.from_numpy(m_in[:, :l_t])).numpy()
    idx = np.zeros((2, 4), np.int64)
    valid = np.zeros((2, 4), np.bool_)
    idx[0], valid[0] = np.resize(np.nonzero(bm[0])[0], 4), True
    gen = _generator()
    got = _port(gen, inputs, l_t, masked_windows=(torch.from_numpy(idx),
                                                  torch.from_numpy(valid)))
    dense = _port(gen, inputs, l_t)
    jax_gen = JaxGenerator(depths=2, attention_impl="flash")
    want = jax.jit(lambda p, x, f, mi, mu, fv, i, v: jax_gen.apply(
        {"params": p}, x, f, mi, mu, l_t, frame_valid=fv,
        masked_windows=(i, v)))(_tree(), *inputs, jnp.asarray(idx, jnp.int32),
                                valid)
    return bm, got, dense, np.asarray(want)


@pytest.mark.parametrize("row", [0, 1], ids=["dirty", "empty"])
def test_generator_masked_windows_matches_jax(row):
    """'flash' with a bucket of masked windows and the last block's query
    shrink (the generator's default, as the JAX generator's): against the
    JAX generator with the same bucket within 1e-4 of the output scale,
    and equal to the port's own dense call. 'dirty': 2 dirty windows of 6
    in a bucket of 4 slots; 'empty': no hole and an all-False bucket, which
    leaves every window to branch B."""
    bm, got, dense, want = _bucket_case()
    assert bm.shape == (2, 6) and bm[row].sum() == (2, 0)[row]
    # branch A's K4 problems are the bucket's 4 windows instead of 6;
    # PyTorch's CPU bmm computes each problem on its own, so the rows
    # agree exactly
    torch.testing.assert_close(got[row], dense[row], rtol=0, atol=0)
    scale = max(1.0, float(np.abs(want[row]).max()))
    np.testing.assert_allclose(got[row].numpy(), want[row], rtol=0,
                               atol=1e-4 * scale)


def test_last_block_query_shrink_is_exact():
    """The transformer stack with out_frames=l_t gives the first l_t frames
    of the full stack's output: the last block's other queries, shortcut
    and MLP rows feed nothing those frames read."""
    gen = _generator()
    rng = np.random.default_rng(9)
    T, l_t = 5, 3
    tokens = torch.from_numpy(
        rng.standard_normal((1, T, 12, 14, 512)).astype(np.float32))
    mask = torch.zeros(1, l_t, 12, 14, 1)
    mask[:, 1, 3:6, 2:9] = 1
    valid = torch.tensor([True] * (T - 1) + [False])
    with torch.no_grad():
        full = gen.transformers(tokens, (36, 40), mask, 2, valid)
        shrunk = gen.transformers(tokens, (36, 40), mask, 2, valid,
                                  out_frames=l_t)
    assert shrunk.shape == (1, l_t, 12, 14, 512)
    torch.testing.assert_close(shrunk, full[:, :l_t], rtol=0, atol=0)
    pallas = _generator("pallas").transformers
    with pytest.raises(AssertionError, match="q_frames shrink not wired"):
        with torch.no_grad():
            pallas(tokens, (36, 40), mask, 2, valid, out_frames=l_t)


@pytest.mark.parametrize("given", ["enc_feat", "ref_feat", "ref_tokens"])
@pytest.mark.parametrize("attention_impl", ["flash", "pallas"])
def test_generator_precomputed_inputs(given, attention_impl):
    """precomputed_enc_feat (every frame's features: nothing is encoded,
    local frames' masks only, no frames), precomputed_ref_feat (the references'
    features: local frames' inputs only) and precomputed_ref_tokens (the
    references' tokens) give the plain call's output."""
    l_t = 3
    inputs = _window_inputs(7, size=(64, 96))
    gen = _generator(attention_impl)
    want = _port(gen, inputs, l_t)
    frames, flows, m_in, m_upd, valid = inputs
    t = torch.from_numpy
    with torch.no_grad():
        feat = gen.encode(t(frames[0]), t(m_in[0]), t(m_upd[0]))[None]
        tokens = gen.tokenize(feat[0])[None]
    local = (frames[:, :l_t], flows, m_in[:, :l_t], m_upd[:, :l_t], valid)
    kw, run_on = {"enc_feat": (dict(precomputed_enc_feat=feat),
                               (None,) + local[1:]),
                  "ref_feat": (dict(precomputed_ref_feat=feat[:, l_t:]),
                               local),
                  "ref_tokens": (dict(precomputed_ref_tokens=tokens[:, l_t:]),
                                 inputs)}[given]
    got = _port(gen, run_on, l_t, **kw)
    # SoftSplit's convolution over the 3 local frames instead of all 5:
    # PyTorch's CPU convolution picks its blocking by batch size, which
    # moves the tokens by a few ulp (the encoder's does not)
    atol = 1e-6 * float(want.abs().max()) if given == "ref_tokens" else 0
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


# ---- stage 4 as a whole ----------------------------------------------------

T4 = 10
COMBOS = [(False, False), (True, True), (False, True), (True, False)]


@functools.lru_cache(maxsize=1)
def _stage4_inputs():
    """10 frames with a static hole (4 of the 6 windows dirty in every
    window), random flows; the updated masks clear part of the hole."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 255, (T4, H, W, 3), np.uint8)
    mask = np.zeros((T4, H, W), np.uint8)
    mask[(slice(None),) + HOLE] = 1
    upd = mask.copy()
    upd[:, 60:70] = 0
    x = (frames.astype(np.float32) / 255.0 * 2.0 - 1.0)[None]
    m = mask.astype(np.float32)[None, ..., None]
    u = upd.astype(np.float32)[None, ..., None]
    flows = tuple(rng.normal(0, 1.5, (1, T4 - 1, H, W, 2)).astype(np.float32)
                  for _ in range(2))
    return frames, x, flows, m, u


def _config(pkg, bucketing, carry):
    return pkg.PipelineConfig(ref_stride=4, neighbor_length=4,
                              occupancy_bucketing=bucketing,
                              encoder_carry=carry)


@functools.lru_cache(maxsize=None)
def _port_stage4(bucketing, carry):
    """The port's generate: (uint8 output, plan, frames through the
    encoder and SoftSplit as hooks count them, the attention's
    (bucket, q_frames) calls)."""
    frames, x, flows, m, u = _stage4_inputs()
    gen = _generator()
    pipe = torch_pipeline.ProPainterPipeline(
        RAFT(), RecurrentFlowCompleteNet(), gen,
        _config(torch_pipeline, bucketing, carry), device="cpu")
    counts = {"encoder": 0, "ss": 0}

    def count(name):
        def hook(_, args):
            counts[name] += args[0].shape[0]
        return hook

    gen.encoder.register_forward_pre_hook(count("encoder"))
    gen.ss.register_forward_pre_hook(count("ss"))
    attention = []
    for block in gen.transformers.transformer:
        block.attention.register_forward_pre_hook(
            lambda _, a: attention.append(
                (None if a[4] is None else a[4][0].shape[1], a[5])))
    t = torch.from_numpy
    with torch.inference_mode():
        out = pipe.generate(t(x), (t(flows[0]), t(flows[1])), t(m), t(u),
                            t(frames)).numpy()
    plan = pipe.stage4_plan(t(m))
    return out, plan, counts, attention


def _jax_plan(config, x, flows, m, u, frames):
    """The JAX package's stage-4 plan under `config`: its generate with the
    encoder, tokenizer and window-group executables replaced by recorders
    (its bitmap readback runs). Returns (reference union length, [(l_t,
    n_steps, window_batch, bucket or None, carry stride or None, seed
    length)])."""
    pipe = jax_pipeline.ProPainterPipeline(
        None, None, None, config,
        inpaint=JaxGenerator(depths=2, attention_impl="flash"))
    union, groups = [], []
    pipe._encode_all = lambda _, f, *a: union.append(f.shape[1]) or f
    pipe._ss_tokens = lambda _, feat: feat

    def group(_, comp, visited, *a, l_t, stride=None):
        nb, mi, seed = a[6], a[10], a[14]
        groups.append((l_t, nb.shape[0], nb.shape[1],
                       None if mi is None else mi.shape[-1], stride,
                       seed.shape[0]))
        return comp, visited

    pipe._generate_group = group
    pipe.generate(jnp.asarray(x), tuple(map(jnp.asarray, flows)),
                  jnp.asarray(m), jnp.asarray(u), frames)
    return union[0], groups


def _port_groups(plan):
    """The port's plan in `_jax_plan`'s terms."""
    wb = plan.window_batch
    return [(sr.l_t, -(-len(sr.windows) // wb), wb,
             None if sr.masked is None else sr.bucket, sr.carry,
             sr.l_t - sr.carry if sr.carry else 0) for sr in plan.subruns]


def _jax_encoded(ref_len, groups):
    """The frames the JAX plan encodes: the union once, then a carried
    group's seed and `stride` a step, any other's l_t a window of each
    batch."""
    return ref_len + sum(seed + n * stride if stride else n * wb * l_t
                         for l_t, n, wb, _, stride, seed in groups)


@pytest.mark.parametrize("window_batch", [1, 4])
def test_smoke_clip_plan_matches_jax(window_batch):
    """chip_smoke.py's 80-frame 432 x 240 clip (a moving hole dilated by
    4) at the default settings: the port plans the sub-runs, buckets and
    carries the JAX package plans, and so encodes the frames it encodes
    (118 at window_batch 1: 8 references and 110 local frames)."""
    import chip_smoke
    from propainter_tpu_torch.utils.masks import binary_dilation_cross

    _, mask = chip_smoke._synthetic_clip(80, 240, 432, seed=0)
    m = np.stack([binary_dilation_cross(f, 4) for f in mask]).astype(
        np.float32)[None, ..., None]
    config = dict(window_batch=window_batch)
    pipe = torch_pipeline.ProPainterPipeline(
        RAFT(), RecurrentFlowCompleteNet(), InpaintGenerator(),
        torch_pipeline.PipelineConfig(**config), device="cpu")
    plan = pipe.stage4_plan(torch.from_numpy(m))
    x = np.zeros((1, 80, 240, 432, 3), np.float32)
    flows = (np.zeros((1, 79, 240, 432, 2), np.float32),) * 2
    ref_len, groups = _jax_plan(jax_pipeline.PipelineConfig(**config), x,
                                flows, m, m,
                                np.zeros((80, 240, 432, 3), np.uint8))
    assert len(plan.ref_union) == ref_len == 8
    assert _port_groups(plan) == groups
    encoded = chip_smoke._plan_counts(plan)["encoded"]
    assert encoded == _jax_encoded(ref_len, groups)
    if window_batch == 1:
        assert encoded == 118


@functools.lru_cache(maxsize=1)
def _jax_stage4():
    """The JAX package's default generate (bucketing and carry on)."""
    frames, x, flows, m, u = _stage4_inputs()
    pipe = jax_pipeline.ProPainterPipeline(
        None, None, _tree(), _config(jax_pipeline, True, True),
        inpaint=JaxGenerator(depths=2, attention_impl="flash"))
    return np.asarray(pipe.generate(
        jnp.asarray(x), tuple(map(jnp.asarray, flows)), jnp.asarray(m),
        jnp.asarray(u), frames))


@pytest.mark.parametrize("bucketing, carry", COMBOS)
def test_stage4_schedule_matches_jax(bucketing, carry):
    """Windows of 3, 5, 5, 5 and 4 frames (neighbor_length 4), references
    from a 3-frame union (ref_stride 4). Under each combination the port
    plans what the JAX package plans (bucket 4 of 6 windows under
    bucketing, the three 5-frame windows one carried sub-run under carry)
    and its encoder and SoftSplit see exactly the frames that plan names;
    its output equals the plain schedule's and is within 2 LSB of the JAX
    package's default generate."""
    out, plan, counts, attention = _port_stage4(bucketing, carry)
    frames, x, flows, m, u = _stage4_inputs()
    ref_len, groups = _jax_plan(_config(jax_pipeline, bucketing, carry), x,
                                flows, m, u, frames)
    assert len(plan.ref_union) == ref_len == 3
    assert _port_groups(plan) == groups
    assert [g[0] for g in groups] == [3, 5, 4]
    assert all((g[3] == 4) == bucketing for g in groups)
    assert (groups[1][4] == 2) == carry
    jax_encoded = _jax_encoded(ref_len, groups)
    assert counts["encoder"] == jax_encoded
    assert jax_encoded == (19 if carry else 25)
    assert counts["ss"] == 3 + 3 + 15 + 4
    # every block of 5 windows ran; the bucketed branch A under bucketing;
    # the last block's queries the local frames' only
    assert len(attention) == 5 * 2
    assert {b for b, _ in attention} == ({4} if bucketing else {None})
    assert [q for _, q in attention[1::2]] == [3, 5, 5, 5, 4]
    assert all(q is None for _, q in attention[0::2])

    plain = _port_stage4(False, False)[0]
    np.testing.assert_array_equal(out, plain)
    hole = (slice(None),) + HOLE
    assert (out[hole] != frames[hole]).mean() > 0.5
    diff = np.abs(out.astype(int) - _jax_stage4().astype(int))
    assert diff.max() <= 2, (diff.max(), diff.mean())
