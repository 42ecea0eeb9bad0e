"""The PyTorch port's models against the JAX package's, on the CPU, and the
weight bridge between them.

Weights: one seeded JAX parameter tree per model (kernels ~ N(0, 1/fan_in),
other leaves ~ N(0, 0.1^2), batch-norm variances ~ U(0.5, 1.5), so the
activations stay O(1) through the recurrences), loaded into the port with
`weights.state_dict_from_flax`. Tolerances are fp32 noise through a few
dozen layers.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu.convert import assert_tree_shapes_match
from propainter_tpu.models.flow_completion import (
    RecurrentFlowCompleteNet as JaxFlowComplete, convert_flowcomp_state_dict)
from propainter_tpu.models.propainter import (
    InpaintGenerator as JaxGenerator,
    SparseWindowAttention as JaxSparseWindowAttention,
    convert_inpaint_state_dict)
from propainter_tpu.models.raft import RAFT as JaxRAFT, convert_raft_state_dict

from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.layers import GemmConv2d
from propainter_tpu_torch.models.propainter import (
    InpaintGenerator, SparseWindowAttention)
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.weights import (
    FLOWCOMP_RENAMES, INPAINT_RENAMES, RAFT_RENAMES, seeded_init_,
    state_dict_from_flax)

KEY = jax.random.PRNGKey(0)


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if str(path[-1]) == "['var']":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if len(s.shape) >= 2:
            fan_in = np.prod(s.shape[:-1])
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)
                    ).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _raft_tree():
    return jax.eval_shape(lambda: JaxRAFT().init(
        KEY, jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 128, 128, 3)),
        iters=1))["params"]


def _flowcomp_tree():
    # train=True declares the edge head too (it is in the checkpoint)
    return jax.eval_shape(lambda: JaxFlowComplete().init(
        KEY, jnp.zeros((1, 2, 64, 64, 2)), jnp.zeros((1, 2, 64, 64, 1)),
        True))["params"]


def _generator_tree(depths=2):
    H = W = 64
    return jax.eval_shape(lambda: JaxGenerator(depths=depths).init(
        KEY, jnp.zeros((1, 3, H, W, 3)),
        (jnp.zeros((1, 1, H, W, 2)), jnp.zeros((1, 1, H, W, 2))),
        jnp.zeros((1, 3, H, W, 1)), jnp.zeros((1, 3, H, W, 1)),
        2))["params"]


def _load(module, tree, renames):
    module.load_state_dict(state_dict_from_flax(module, tree, renames),
                           strict=True)
    return module.eval()


def test_raft_matches_jax():
    tree = _fill(_raft_tree(), 0)
    model = _load(RAFT(), tree, RAFT_RENAMES)
    rng = np.random.default_rng(1)
    im1 = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    im2 = np.roll(im1, 3, axis=2)
    j_low, j_up = JaxRAFT().apply({"params": tree}, im1, im2, iters=3)
    with torch.no_grad():
        t_low, t_up = model(torch.from_numpy(im1), torch.from_numpy(im2),
                            iters=3)
    np.testing.assert_allclose(t_low.numpy(), np.asarray(j_low), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(t_up.numpy(), np.asarray(j_up), rtol=0,
                               atol=2e-5)


def test_raft_batched_layout_matches_jax():
    """corr_layout='batched': the windows (K7's plain version), then convc1
    as one addmm, against the JAX RAFT built with corr_layout='batched'."""
    tree = _fill(_raft_tree(), 0)
    model = _load(RAFT(corr_layout="batched"), tree, RAFT_RENAMES)
    rng = np.random.default_rng(6)
    im1 = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    im2 = np.roll(im1, -2, axis=1)
    j_low, j_up = JaxRAFT(corr_layout="batched").apply(
        {"params": tree}, im1, im2, iters=3)
    with torch.no_grad():
        t_low, t_up = model(torch.from_numpy(im1), torch.from_numpy(im2),
                            iters=3)
    np.testing.assert_allclose(t_low.numpy(), np.asarray(j_low), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(t_up.numpy(), np.asarray(j_up), rtol=0,
                               atol=2e-5)


def test_flow_completion_matches_jax():
    tree = _fill(_flowcomp_tree(), 2)
    model = _load(RecurrentFlowCompleteNet(), tree, FLOWCOMP_RENAMES)
    rng = np.random.default_rng(3)
    flows = rng.normal(0, 2, (2, 4, 64, 96, 2)).astype(np.float32)
    masks = (rng.uniform(size=(2, 4, 64, 96, 1)) > 0.7).astype(np.float32)
    want, _ = JaxFlowComplete().apply({"params": tree}, flows, masks)
    with torch.no_grad():
        got = model(torch.from_numpy(flows), torch.from_numpy(masks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("attention_impl", ["flash", "pallas"])
def test_generator_matches_jax(attention_impl):
    """Reduced depth (2 blocks, both temporal-dilation parities); a padded
    reference frame masked by frame_valid; the same attention form in the
    JAX module (its Pallas kernels in interpret mode) and in the port (the
    plain versions of K4 or K5), on one parameter tree."""
    tree = _fill(_generator_tree(), 4)
    model = _load(InpaintGenerator(depths=2, attention_impl=attention_impl),
                  tree, INPAINT_RENAMES)
    rng = np.random.default_rng(5)
    T, l_t, H, W = 5, 3, 64, 96
    frames = rng.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)
    ff = rng.normal(0, 2, (1, l_t - 1, H, W, 2)).astype(np.float32)
    fb = rng.normal(0, 2, (1, l_t - 1, H, W, 2)).astype(np.float32)
    m_in = np.zeros((1, T, H, W, 1), np.float32)
    m_in[:, :, 20:40, 30:60] = 1
    m_upd = m_in.copy()
    m_upd[:, :, 25:35] = 0
    valid = np.array([True] * (T - 1) + [False])
    want = JaxGenerator(depths=2, attention_impl=attention_impl).apply(
        {"params": tree}, frames, (ff, fb), m_in, m_upd, l_t,
        frame_valid=jnp.asarray(valid))
    with torch.no_grad():
        got = model(torch.from_numpy(frames),
                    (torch.from_numpy(ff), torch.from_numpy(fb)),
                    torch.from_numpy(m_in), torch.from_numpy(m_upd), l_t,
                    frame_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("attention_impl", ["flash", "pallas"])
def test_generator_batched_frame_valid_matches_jax(attention_impl):
    """Two windows in one batch, as stage 4's window batching runs them,
    each with its own (B, T) frame_valid row (one and two padded
    reference frames) and its own masks."""
    tree = _fill(_generator_tree(), 4)
    model = _load(InpaintGenerator(depths=2, attention_impl=attention_impl),
                  tree, INPAINT_RENAMES)
    rng = np.random.default_rng(12)
    B, T, l_t, H, W = 2, 5, 3, 64, 96
    frames = rng.uniform(-1, 1, (B, T, H, W, 3)).astype(np.float32)
    ff = rng.normal(0, 2, (B, l_t - 1, H, W, 2)).astype(np.float32)
    fb = rng.normal(0, 2, (B, l_t - 1, H, W, 2)).astype(np.float32)
    m_in = np.zeros((B, T, H, W, 1), np.float32)
    m_in[0, :, 20:40, 30:60] = 1
    m_in[1, :, 10:30, 50:90] = 1
    m_upd = m_in.copy()
    m_upd[:, :, 25:35] = 0
    valid = np.array([[True] * (T - 1) + [False],
                      [True] * (T - 2) + [False] * 2])
    want = JaxGenerator(depths=2, attention_impl=attention_impl).apply(
        {"params": tree}, frames, (ff, fb), m_in, m_upd, l_t,
        frame_valid=jnp.asarray(valid))
    with torch.no_grad():
        got = model(torch.from_numpy(frames),
                    (torch.from_numpy(ff), torch.from_numpy(fb)),
                    torch.from_numpy(m_in), torch.from_numpy(m_upd), l_t,
                    frame_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_sparse_window_attention_pallas_matches_jax():
    """attention_impl='pallas' on a 7x11 token grid, padded to 2x2 windows
    of (5, 9): the rolled copies wrap on the padded grid. Odd-block
    dilation (frame 0 unselected) and a padded reference frame."""
    rng = np.random.default_rng(8)
    B, T, l_t, Hg, Wg, C = 1, 5, 3, 7, 11, 64
    x = rng.standard_normal((B, T, Hg, Wg, C)).astype(np.float32)
    mask = np.zeros((B, l_t, Hg, Wg, 1), np.float32)
    mask[:, 1, 1:3, 2:4] = 1.0           # dirties window (0, 0) only
    static_sel = np.array([False, True, False, True, False])
    valid = np.array([True] * (T - 1) + [False])
    jax_mod = JaxSparseWindowAttention(C, 4, (5, 9), (4, 4), "pallas")
    tree = _fill(jax.eval_shape(lambda: jax_mod.init(
        KEY, x, mask, (static_sel, jnp.asarray(valid))))["params"], 9)
    want = jax_mod.apply({"params": tree}, x, mask,
                         (static_sel, jnp.asarray(valid)))
    model = _load(SparseWindowAttention(C, 4, attention_impl="pallas"), tree,
                  ())
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask), static_sel,
                    torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("name", ["raft", "flowcomp", "inpaint"])
def test_state_dict_bridge_round_trip(name):
    """port state_dict -> the JAX package's converter gives back the JAX
    tree key for key and value for value, so checkpoints in the released
    (torch) layout load into the port with strict=True."""
    make, shapes, renames, convert = {
        "raft": (RAFT, _raft_tree, RAFT_RENAMES, convert_raft_state_dict),
        "flowcomp": (RecurrentFlowCompleteNet, _flowcomp_tree,
                     FLOWCOMP_RENAMES, convert_flowcomp_state_dict),
        "inpaint": (InpaintGenerator, lambda: _generator_tree(8),
                    INPAINT_RENAMES, convert_inpaint_state_dict),
    }[name]
    ref = shapes()
    # the port's own seeded init -> the JAX layout
    sd = seeded_init_(make(), 7).state_dict()
    converted = convert({"module." + k if name == "raft" else k: v
                         for k, v in sd.items()})
    assert_tree_shapes_match(converted, ref)
    # and back: the converted tree reproduces the state dict exactly
    back = state_dict_from_flax(make(), converted, renames)
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    make().load_state_dict(back, strict=True)


def test_released_key_layout():
    """Spot-check keys of the released checkpoints."""
    raft = RAFT().state_dict()
    for key in ["fnet.conv1.weight", "fnet.layer1.0.conv1.weight",
                "cnet.norm1.running_mean", "cnet.layer2.0.norm3.weight",
                "cnet.layer2.0.downsample.1.running_var",
                "update_block.encoder.convc1.weight",
                "update_block.gru.convz1.weight",
                "update_block.flow_head.conv2.bias",
                "update_block.mask.2.weight"]:
        assert key in raft, key
    fc = RecurrentFlowCompleteNet().state_dict()
    for key in ["downsample.0.weight", "encoder1.0.conv1.0.weight",
                "feat_prop_module.deform_align.backward_.conv_offset.6.bias",
                "feat_prop_module.backbone.forward_.2.weight",
                "decoder2.2.conv.weight", "edgeDetector.out_layer.weight"]:
        assert key in fc, key
    gen = InpaintGenerator().state_dict()
    for key in ["encoder.layers.10.weight", "decoder.4.conv.weight",
                "ss.embedding.weight", "sc.bias_conv.bias",
                "feat_prop_module.deform_align.forward_1.weight",
                "transformers.transformer.7.attention.valid_ind_rolled",
                "transformers.transformer.0.attention.pool_layer.weight",
                "transformers.transformer.3.mlp.fc2.1.weight"]:
        assert key in gen, key


def test_fan_in_scaled_init():
    """seeded_init_(fan_in_scaled=True): weights ~ N(0, 1/fan_in), the
    other float tensors ~ N(0, 0.1^2), batch-norm variances in [0.5, 1.5];
    the same seed gives the same weights."""
    model = seeded_init_(RAFT(), 3, fan_in_scaled=True)
    sd = model.state_dict()
    w = sd["update_block.encoder.convc2.weight"]        # (192, 256, 3, 3)
    assert abs(w.std().item() * np.sqrt(256 * 9) - 1.0) < 0.02
    assert abs(sd["fnet.conv1.bias"].std().item() - 0.1) < 0.03
    var = sd["cnet.norm1.running_var"]
    assert var.min() >= 0.5 and var.max() <= 1.5
    again = seeded_init_(RAFT(), 3, fan_in_scaled=True).state_dict()
    for k in sd:
        torch.testing.assert_close(again[k], sd[k], rtol=0, atol=0)


@pytest.mark.parametrize("groups,kernel,pad", [(1, 3, 1), (2, 3, 1),
                                               (8, 3, 1), (1, 5, 0)])
def test_gemm_conv_matches_conv2d(groups, kernel, pad):
    """The im2col-GEMM convolution equals F.conv2d, also when the batch is
    processed in slices."""
    torch.manual_seed(0)
    conv = GemmConv2d(16, 24, kernel, pad, groups=groups)
    x = torch.randn(5, 16, 9, 11)
    want = torch.nn.functional.conv2d(x, conv.weight, conv.bias,
                                      padding=pad, groups=groups)
    torch.testing.assert_close(conv(x), want, rtol=0, atol=1e-5)
    conv.MAX_COLS = 1   # one sample per slice
    torch.testing.assert_close(conv(x), want, rtol=0, atol=1e-5)
