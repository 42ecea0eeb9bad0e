"""The PyTorch port's bf16 path against the JAX package's, on the CPU.

Kernels: the bf16 plain versions of K2, K1, K3 and K4 (the CPU path of
their bf16 wrappers, and what the CUDA kernels are held to on the card)
against the TPU kernels run on bf16 inputs in Pallas interpret mode.
Modules: RAFT's encode and refine, the flow completion and the generator
with bf16 parameters against the JAX modules on the CPU. Guards: the
combinations that have no bf16 form yet raise, and so does a tensor of
one precision given to the other's kernel (on the card). The pipeline on
the golden fixture: tests/test_torch_bf16_pipeline.py.

XLA on the CPU may keep excess precision between bf16 operations
(`xla_allow_excess_precision`), and PyTorch rounds after each one, so the
two agree to a bf16 step, not bit for bit. Each tolerance below is a
measured bound (with its measurement in the comment), stated relative to
the output's scale where the scale is not 1.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu import pipeline as jax_pipeline
from propainter_tpu.models.flow_completion import (
    RecurrentFlowCompleteNet as JaxFlowComplete)
from propainter_tpu.models.propainter import InpaintGenerator as JaxGenerator
from propainter_tpu.models.raft import RAFT as JaxRAFT
from propainter_tpu.ops.corr_pallas import (corr_lookup_flat_moenc,
                                            corr_pyramid_flat)
from propainter_tpu.ops.deform_pallas import modulated_deform_conv2d_fused_out
from propainter_tpu.ops.flash_attention import (
    flash_window_attention as jax_flash_attention)
from tests.test_torch_models import (_fill, _flowcomp_tree, _generator_tree,
                                     _load, _raft_tree)

from propainter_tpu_torch import pipeline as torch_pipeline
from propainter_tpu_torch.api import ProInpainter
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.ops import attention, corr, deform, flash_attention
from propainter_tpu_torch.ops.warp import coords_grid
from propainter_tpu_torch.weights import (FLOWCOMP_RENAMES, INPAINT_RENAMES,
                                          RAFT_RENAMES)

BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs this file beside
    other pytest-xdist workers, and PyTorch's default of one OpenMP thread
    per core in every worker oversubscribes the host (these tests took 20x
    their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    """A numpy array rounded to bf16 (as float32), the value both sides
    take."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _jax_bf16_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


# ---- kernels: bf16 plain versions against the TPU kernels ------------------


def _corr_case(seed=0):
    """Feature maps of bf16 values on a ragged 8 x 13 map (level 3 is
    1 x 1), coordinates up to 40 pixels outside it, and convc1."""
    rng = np.random.default_rng(seed)
    B, Hc, Wc, D = 2, 8, 13, 256
    f1, f2 = (_bf16(rng.standard_normal((B, Hc, Wc, D))) for _ in range(2))
    coords = (np.asarray(coords_grid(B, Hc, Wc))
              + rng.standard_normal((B, Hc, Wc, 2)) * 3.0).astype(np.float32)
    coords[0, 0, :4] = [[-7.0, 2.0], [20.0, 3.5], [3.25, -6.0], [40.0, 40.0]]
    w = _bf16(rng.standard_normal((324, 256)) * 0.05)
    b = _bf16(rng.standard_normal(256) * 0.05)
    return f1, f2, coords, w, b


def _port_levels(flat, B, Hc, Wc):
    """The JAX flat layout (1, Hl, Wl, B * Pq) -> the port's (B*Hc*Wc, Hl,
    Wl) rows."""
    P = Hc * Wc
    out = []
    for lvl in flat:
        a = np.asarray(lvl.astype(jnp.float32))[0]
        Hl, Wl, BPq = a.shape
        a = a.reshape(Hl, Wl, B, BPq // B)[..., :P]
        out.append(a.transpose(2, 3, 0, 1).reshape(B * P, Hl, Wl))
    return out


def test_corr_pyramid_bf16_plain_matches_jax_kernel():
    """K2's bf16 form against `corr_pyramid_flat(out_dtype=bfloat16)`:
    every level pooled in fp32 and rounded once. Measured: equal but for
    1 of 4992 level-1 values, one bf16 step apart (4.6e-3 of the value)."""
    f1, f2, *_ = _corr_case()
    B, Hc, Wc, _ = f1.shape
    want = _port_levels(corr_pyramid_flat(
        jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16), 4,
        out_dtype=jnp.bfloat16, interpret=True), B, Hc, Wc)
    got = corr.corr_pyramid(torch.from_numpy(f1).to(BF),
                            torch.from_numpy(f2).to(BF), 4,
                            out_dtype=torch.bfloat16)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.bfloat16
        # one bf16 step (at most 2^-7 of a value) where the two fp32 sums
        # fall on either side of a rounding boundary
        np.testing.assert_allclose(g.float().numpy(), w_, rtol=2 ** -7,
                                   atol=0)


def test_corr_lookup_moenc_bf16_plain_matches_jax_kernel():
    """K1's bf16 form against the TPU lookup kernel with its convc1
    epilogue over the bf16 flat pyramid (interpret mode). Measured: 1.5e-7
    of the output scale."""
    f1, f2, coords, w, b = _corr_case()
    pyr = corr_pyramid_flat(jnp.asarray(f1, jnp.bfloat16),
                            jnp.asarray(f2, jnp.bfloat16), 4,
                            out_dtype=jnp.bfloat16, interpret=True)
    want = corr_lookup_flat_moenc(pyr, jnp.asarray(coords),
                                  jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16),
                                  interpret=True)
    tpyr = corr.corr_pyramid(torch.from_numpy(f1).to(BF),
                             torch.from_numpy(f2).to(BF), 4,
                             out_dtype=torch.bfloat16)
    got = corr.corr_lookup_moenc_bf16(
        tpyr, torch.from_numpy(coords), torch.from_numpy(w).to(BF),
        torch.from_numpy(b).to(BF))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 13, 256)
    assert _rel_err(got.numpy(), want) < 2 ** -8


def test_modulated_deform_conv2d_bf16_plain_matches_jax_kernel():
    """K3's bf16 form against the fused TPU deform kernel on bf16 x,
    offset, mask and weight (interpret mode): bf16 positions up to 40
    pixels outside the image. Measured: equal."""
    rng = np.random.default_rng(1)
    B, Hd, Wd, C, dg, O = 1, 6, 10, 64, 8, 128
    x = _bf16(rng.standard_normal((B, Hd, Wd, C)))
    off = _bf16(np.tanh(rng.standard_normal((B, Hd, Wd, dg, 9, 2))) * 3.0
                + rng.standard_normal((B, Hd, Wd, 1, 1, 2)) * 4.0)
    off[0, 0, 0, 0, :3, 0] = [-40.0, 40.0, 9.5]
    msk = _bf16(rng.uniform(0, 1, (B, Hd, Wd, dg, 9)))
    wt = _bf16(rng.standard_normal((3, 3, C, O)) * 0.05)
    bs = _bf16(rng.standard_normal(O) * 0.1)
    want = modulated_deform_conv2d_fused_out(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, off, msk, wt, bs)),
        interpret=True)
    got = deform.modulated_deform_conv2d_bf16(
        *(torch.from_numpy(a).to(BF) for a in (x, off, msk, wt, bs)))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) <= 2 ** -7


def _deform_bf16_case(C, dg, seed=1, Hd=6, Wd=10):
    """bf16 x, offset (positions up to 40 pixels outside the image), mask,
    HWIO weight and bias of K3 at C channels in dg groups."""
    rng = np.random.default_rng(seed)
    B, O = 1, 128
    x = _bf16(rng.standard_normal((B, Hd, Wd, C)))
    off = np.tanh(rng.standard_normal((B, Hd, Wd, dg, 9, 2))) * 3.0 \
        + rng.standard_normal((B, Hd, Wd, 1, 1, 2)) * 4.0
    off[0, 0, 0, 0, :3, 0] = [-40.0, 40.0, 9.5]
    off = _bf16(off)
    msk = _bf16(rng.uniform(0, 1, (B, Hd, Wd, dg, 9)))
    wt = _bf16(rng.standard_normal((3, 3, C, O)) * 0.05)
    bs = _bf16(rng.standard_normal(O) * 0.1)
    return x, off, msk, wt, bs


def _k3_bf16_kernel_emulation(x, off, msk, wt, bs, n_split):
    """The arithmetic of K3's bf16 kernel: its bf16 samples
    (`_deform_samples_bf16_plain`) times the HWIO weight in 64-channel
    chunks of one tap (tap-major K, as the kernel walks it), block r of a
    cluster of n_split summing chunks [n r / n_split, n (r + 1) / n_split)
    in fp32 (a chunk's 64 products are exact; summed in float64 and added
    in fp32), the blocks' partial sums added in rank order in fp32, the sum
    rounded to bf16, then + bias in bf16."""
    samples = deform._deform_samples_bf16_plain(
        *(torch.from_numpy(a).to(BF) for a in (x, off, msk))).float().numpy()
    B, H, W, dg, K, Cg = samples.shape
    a = samples.transpose(0, 1, 2, 4, 3, 5).reshape(-1, K * dg * Cg)
    w = wt.reshape(K * dg * Cg, -1)
    n_chunks = a.shape[1] // deform.K3_BF16_CHUNK
    total = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for rank in range(n_split):
        part = np.zeros_like(total)
        for j in range(n_chunks * rank // n_split,
                       n_chunks * (rank + 1) // n_split):
            ck = slice(deform.K3_BF16_CHUNK * j, deform.K3_BF16_CHUNK * (j + 1))
            part = part + (a[:, ck].astype(np.float64)
                           @ w[ck].astype(np.float64)).astype(np.float32)
        total = total + part
    return _bf16(_bf16(total) + bs).reshape(B, H, W, -1)


@pytest.mark.parametrize("C, dg, split", [(128, 16, 2), (256, 16, 4)],
                         ids=["generator Cg 8", "flow completion Cg 16"])
def test_modulated_deform_conv2d_bf16_kernel_arithmetic(C, dg, split):
    """The summation order of K3's bf16 kernel (fp32 partial sums over its
    64-channel chunks, split over the cluster's blocks and added in rank
    order) against the fused TPU deform kernel on the same bf16 inputs
    (interpret mode), at both call sites' group widths and channel counts
    with their main-path splits, and unsplit. Any fp32 order is the TPU
    kernel's (it sums its groups in fp32 across its grid), so the two
    differ only where an fp32 sum falls on the other side of a bf16
    rounding boundary: within one bf16 step of the output scale (2^-8).
    Measured: equal, or 1 of 7680 values one step apart (9.2e-4 and
    4.3e-5 of the scale)."""
    arrays = _deform_bf16_case(C, dg)
    want = np.asarray(modulated_deform_conv2d_fused_out(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays),
        interpret=True).astype(jnp.float32))
    for n_split in (1, split):
        got = _k3_bf16_kernel_emulation(*arrays, n_split)
        assert _rel_err(got, want) <= 2 ** -8
        assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("with_bias", [True, False])
def test_flash_window_attention_bf16_plain_matches_jax_kernel(with_bias):
    """K4's bf16 form against the TPU flash attention kernel on bf16 q, k,
    v (interpret mode). Measured: equal with the bias, 2.2e-7 of the
    output scale without (one bf16 step of a small value)."""
    rng = np.random.default_rng(2)
    Bq, G, Tq, Tk, ch = 1, 3, 50, 150, 128
    q, k, v = (_bf16(rng.standard_normal((Bq, G, T_, ch)))
               for T_ in (Tq, Tk, Tk))
    bias = None
    if with_bias:
        bias = np.zeros((Bq, Tk), np.float32)
        bias[:, 100:] = -1e9
    scale = 1.0 / math.sqrt(ch)
    want = jax_flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), scale, interpret=True)
    got = flash_attention.flash_window_attention_bf16(
        *(torch.from_numpy(a).to(BF) for a in (q, k, v)),
        None if bias is None else torch.from_numpy(bias), scale)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) <= 2 ** -7


# ---- modules with bf16 parameters ----------------------------------------


def test_raft_bf16_encode_and_refine_match_jax():
    """RAFT's encode with compute_dtype=bfloat16 against the JAX module's
    (bf16 parameters, fp32 InstanceNorm statistics in both). Its refine
    with bf16 parameters and features: the JAX bf16 refine cannot run on
    the CPU (its lookup there is fp32, which promotes the GRU's carry to
    fp32 and breaks its scan; the JAX pipeline keeps RAFT fp32 on the CPU),
    so the port's is held against the JAX refine in fp32 on the same
    bf16-valued parameters and features. Measured: features up to 2.6e-2
    of their scale (bf16 steps through 18 layers); flows 0.074 px from the
    fp32 refine's on flows up to 31.6 px (2.4e-3 of their scale)."""
    tree = _fill(_raft_tree(), 0)
    jtree = _jax_bf16_tree(tree)
    model = _load(RAFT(), tree, RAFT_RENAMES).to(BF)
    rng = np.random.default_rng(1)
    im = rng.uniform(-1, 1, (3, 128, 128, 3)).astype(np.float32)
    im[1] = np.roll(im[0], 3, axis=1)
    im[2] = np.roll(im[0], -2, axis=0)
    j_feats = JaxRAFT().apply({"params": jtree}, jnp.asarray(im),
                              compute_dtype=jnp.bfloat16, method="encode")
    with torch.no_grad():
        t_feats = model.encode(torch.from_numpy(im).permute(0, 3, 1, 2),
                               torch.bfloat16)
    for j, t in zip(j_feats, t_feats):
        assert t.dtype == torch.bfloat16
        assert _rel_err(t.float().permute(0, 2, 3, 1).numpy(),
                        np.asarray(j.astype(jnp.float32))) < 4e-2
    # refine pairs (0, 1) and (0, 2) of the JAX features, so both sides
    # refine the same bf16 values
    fmap, net, inp = (np.asarray(a.astype(jnp.float32)) for a in j_feats)
    args = [fmap[[0, 0]], fmap[[1, 2]], net[[0, 0]], inp[[0, 0]]]
    f32_tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jtree)
    _, j_up = JaxRAFT().apply({"params": f32_tree},
                              *(jnp.asarray(a) for a in args), 4,
                              method="refine")
    with torch.no_grad():
        _, t_up = model.refine(
            *(torch.from_numpy(a).permute(0, 3, 1, 2).to(BF) for a in args),
            4)
    assert t_up.dtype == torch.float32
    j_up = np.asarray(j_up)
    err = np.abs(t_up.permute(0, 2, 3, 1).numpy() - j_up).max()
    assert err / np.abs(j_up).max() < 1e-2, (err, np.abs(j_up).max())


def test_flow_completion_bf16_matches_jax():
    """RecurrentFlowCompleteNet with bf16 parameters and inputs (fan-in
    scaled weights, as the fp32 model test uses). Measured: 1.5e-2 of the
    output scale."""
    tree = _fill(_flowcomp_tree(), 2)
    model = _load(RecurrentFlowCompleteNet(), tree, FLOWCOMP_RENAMES).to(BF)
    rng = np.random.default_rng(3)
    flows = _bf16(rng.standard_normal((1, 5, 32, 48, 2)) * 2.0)
    masks = np.zeros((1, 5, 32, 48, 1), np.float32)
    masks[:, :, 8:20, 10:30] = 1.0
    want = JaxFlowComplete().apply({"params": _jax_bf16_tree(tree)},
                                   jnp.asarray(flows, jnp.bfloat16),
                                   jnp.asarray(masks, jnp.bfloat16))[0]
    with torch.no_grad():
        got, _ = model(torch.from_numpy(flows).to(BF),
                       torch.from_numpy(masks).to(BF))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) < 5e-2


@pytest.mark.parametrize("attention_impl", ["flash", "pallas"])
def test_generator_bf16_matches_jax(attention_impl):
    """InpaintGenerator (depths=2) with bf16 parameters and inputs, in
    both attention forms: K3 in its bf16 form, the warps at bf16
    positions, and 'flash' K4's bf16 form with branch B's logits in bf16,
    'pallas' K5's bf16 form (fp32 inside, bf16 out). Measured: 1.4e-2 of
    the output scale in 'flash', 1.5e-2 in 'pallas' (bf16 steps
    through the layers, rounded at other points by XLA)."""
    tree = _fill(_generator_tree(2), 4)
    model = _load(InpaintGenerator(depths=2, attention_impl=attention_impl),
                  tree, INPAINT_RENAMES).to(BF)
    rng = np.random.default_rng(5)
    Tn, l_t, Hg, Wg = 5, 3, 64, 64
    frames = _bf16(rng.uniform(-1, 1, (1, Tn, Hg, Wg, 3)))
    ff, fb = (_bf16(rng.standard_normal((1, l_t - 1, Hg, Wg, 2)) * 2.0)
              for _ in range(2))
    m_in = np.zeros((1, Tn, Hg, Wg, 1), np.float32)
    m_in[:, :, 20:40, 16:48] = 1.0
    m_upd = m_in.copy()
    m_upd[:, :, 28:32] = 0.0
    valid = np.array([True] * (Tn - 1) + [False])
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = JaxGenerator(depths=2, attention_impl=attention_impl).apply(
        {"params": _jax_bf16_tree(tree)}, jb(frames), (jb(ff), jb(fb)),
        jb(m_in), jb(m_upd), l_t, frame_valid=jnp.asarray(valid))
    tb = lambda a: torch.from_numpy(a).to(BF)
    with torch.no_grad():
        got = model(tb(frames), (tb(ff), tb(fb)), tb(m_in), tb(m_upd), l_t,
                    frame_valid=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32))) < 6e-2


# ---- guards ----------------------------------------------------------------


def test_bf16_guards():
    """The generator's 'pallas' form runs in bf16 (K5's bf16 form); RAFT
    refuses a bf16 refinement in the batched corr layout, which the JAX
    package cannot run either (tests/test_torch_bf16_forms.py; the
    pipeline's own guards are in tests/test_torch_pipeline.py);
    ProInpainter defaults to bf16; every field of the JAX package's config
    constructs, with its defaults and off them (the evaluation protocol's
    `raft_clip_len` and `unchunked` too, which the port now runs:
    tests/test_torch_pipeline.py)."""
    mods = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
            "inpaint": InpaintGenerator(depths=2)}
    assert ProInpainter(mods).precision == "bf16"
    gen = InpaintGenerator(depths=1, attention_impl="pallas").to(BF)
    z = torch.zeros(1, 3, 64, 64, 3, dtype=BF)
    f = torch.zeros(1, 1, 64, 64, 2, dtype=BF)
    m = torch.zeros(1, 3, 64, 64, 1, dtype=BF)
    with torch.no_grad():
        out = gen(z, (f, f), m, m, 2)
    assert out.dtype == BF and out.shape == (1, 2, 64, 64, 3)
    raft = RAFT(corr_layout="batched").to(BF)
    feat = torch.zeros(1, 256, 16, 16, dtype=BF)
    hid = torch.zeros(1, 128, 16, 16, dtype=BF)
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="raft.py:122"):
        raft.refine(feat, feat, hid, hid, 1)
    # every field of the JAX package's config, with its defaults
    fields = {fd.name: getattr(jax_pipeline.PipelineConfig(), fd.name)
              for fd in jax_pipeline.PipelineConfig.__dataclass_fields__
              .values()}
    cfg = torch_pipeline.PipelineConfig(**fields)
    assert cfg.raft_bf16_refine and cfg.raft_bf16_encode
    for name, value in (("raft_clip_len", 60), ("unchunked", True),
                        ("occupancy_bucketing", False),
                        ("encoder_carry", False)):
        cfg = torch_pipeline.PipelineConfig(**dict(fields, **{name: value}))
        assert getattr(cfg, name) == value


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(5, 13), (3, 7)],
                         ids=["65 positions", "one partial tile"])
@pytest.mark.parametrize("cg", [4, 8, 16, 32])
def test_cuda_modulated_deform_conv2d_bf16_ragged(cuda, cg, hw):
    """K3's bf16 form against its bf16 plain version at every group width
    (C 128) on ragged images: 65 positions (a full 64-position tile and a
    tile of one) and 21 (one partial tile: the whole grid one cluster),
    offsets to 40 pixels outside, at the wrapper's split and at every
    other split of the 18 chunks; within two bf16 steps of the output
    scale (chip_smoke.py's BF16_REL_TOL)."""
    x, off, msk, wt, bs = (torch.from_numpy(a).to(cuda, BF)
                           for a in _deform_bf16_case(128, 128 // cg, seed=5,
                                                      Hd=hw[0], Wd=hw[1]))
    want = deform._modulated_deform_conv2d_bf16_plain(x, off, msk, wt, bs)
    for split in (None, 1, 2, 3, 6):
        got = deform.modulated_deform_conv2d_bf16(x, off, msk, wt, bs,
                                                  split=split)
        assert got.dtype == BF and got.shape == want.shape
        assert _rel_err(got.float().cpu().numpy(),
                        want.float().cpu().numpy()) <= 2 ** -6


@pytest.mark.cuda
def test_cuda_bf16_kernels_and_dtype_guards(cuda):
    """On the card: each bf16 kernel against its bf16 plain version, and
    no wrapper reaching the other precision's kernel through a cast (a
    bf16 tensor to an fp32 kernel, an fp32 one to a bf16 kernel, raise)."""
    f1, f2, coords, w, b = _corr_case()
    f1, f2 = (torch.from_numpy(a).to(cuda, BF) for a in (f1, f2))
    coords = torch.from_numpy(coords).to(cuda)
    w, b = (torch.from_numpy(a).to(cuda, BF) for a in (w, b))
    level0 = corr.corr_pyramid(f1, f2, 4)[0]
    pyr = corr.corr_pyramid_build_bf16(level0)
    for got, want in zip(pyr, corr._corr_pyramid_build_bf16_plain(level0,
                                                                    4)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=0)
    got = corr.corr_lookup_moenc_bf16(pyr, coords, w, b)
    want = corr._corr_lookup_moenc_bf16_plain(pyr, coords, w, b, 4)
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) < 2 ** -8
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_bf16(rng.standard_normal((1, 5, 13, 128)))).to(
        cuda, BF)
    off = torch.from_numpy(_bf16(rng.standard_normal((1, 5, 13, 16, 9, 2))
                                 * 6.0)).to(cuda, BF)
    msk = torch.rand(1, 5, 13, 16, 9, device=cuda).to(BF)
    wt = (torch.randn(3, 3, 128, 128, device=cuda) * 0.05).to(BF)
    bs = (torch.randn(128, device=cuda) * 0.1).to(BF)
    got = deform.modulated_deform_conv2d_bf16(x, off, msk, wt, bs)
    want = deform._modulated_deform_conv2d_bf16_plain(x, off, msk, wt, bs)
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= 2 ** -6
    q, k = (torch.randn(1, 3, T_, 128, device=cuda).to(BF) for T_ in (130,
                                                                     70))
    got = flash_attention.flash_window_attention_bf16(q, k, k, None, 0.1)
    want = flash_attention._flash_window_attention_bf16_plain(q, k, k, None,
                                                              0.1)
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= 2 ** -6
    with pytest.raises(ValueError):
        flash_attention.flash_window_attention(q, k, k, None, 0.1)
    with pytest.raises(ValueError):
        flash_attention.flash_window_attention_bf16(q.float(), k.float(),
                                                    k.float(), None, 0.1)
    with pytest.raises(ValueError):
        deform.modulated_deform_conv2d(x, off, msk, wt, bs)
    with pytest.raises(ValueError):
        deform.modulated_deform_conv2d_bf16(x.float(), off.float(),
                                            msk.float(), wt.float(),
                                            bs.float())
    with pytest.raises(ValueError):
        corr.corr_lookup_moenc(pyr, coords, w, b)
    with pytest.raises(ValueError):
        corr.corr_lookup_moenc_bf16([p.float() for p in pyr], coords, w, b)
    with pytest.raises(ValueError):
        corr.corr_pyramid_build_bf16(level0.to(BF))
    # the forms added for the other bf16 configurations
    with pytest.raises(ValueError):
        corr.corr_lookup(pyr, coords)
    with pytest.raises(ValueError):
        corr.corr_lookup_bf16([p.float() for p in pyr], coords)
    with pytest.raises(ValueError):
        corr.corr_lookup_moenc_bf16_volume(pyr, coords, w, b)
    with pytest.raises(ValueError):
        corr.corr_lookup_moenc_bf16([p for p in pyr], coords, w.float(),
                                    b.float())
    wins = [torch.zeros(s, device=cuda, dtype=BF)
            for s in [(1, 1, 2, 45, 128)] * 3 + [(1, 1, 4, 2, 45, 128)] * 2
            + [(1, 2, 8, 128)] * 2]
    win_args = (torch.ones(180, dtype=torch.bool, device=cuda),
                torch.ones(1, 1, device=cuda),
                torch.ones(1, 2, dtype=torch.bool, device=cuda), 1)
    with pytest.raises(ValueError):
        attention.sparse_window_attention(*wins, *win_args)
    with pytest.raises(ValueError):
        attention.sparse_window_attention_bf16(*[t.float() for t in wins],
                                               *win_args)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on a GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
