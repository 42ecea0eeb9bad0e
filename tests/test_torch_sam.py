"""The port's SAM (`propainter_tpu_torch.models.sam`) against the JAX
package's `propainter_tpu.models.sam.Sam` on the CPU.

Weights: every leaf of the JAX tree of the scaled-down `TINY` config
(tests/test_sam_parity.py: a 4x4 grid that pads to 6 under window 3, with
windowed and global blocks) is filled from a numpy seed (`sam_pair`), so the
relative position tables and `pos_embed` are not the init's zeros, and
carried into the port by `sam_state_dict_from_flax`. Forwards agree to rtol 1e-4 and
atol 1e-4 of the reference's largest magnitude; the weights round-trip
through `convert_sam_state_dict` exactly; the port's key schema of vit_b,
vit_l and vit_h converts onto the JAX init's tree (shapes only, on the meta
device); `load_sam_state_dict` loads a seeded `.pth` strictly.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu.convert import assert_tree_shapes_match
from propainter_tpu.models import sam as jax_sam
from tests.test_sam_parity import TINY as JAX_TINY
from tests.test_torch_models import _fill

from propainter_tpu_torch.models import sam as torch_sam
from propainter_tpu_torch.weights import sam_state_dict_from_flax

TINY = torch_sam.SamConfig(**{
    f.name: getattr(JAX_TINY, f.name)
    for f in dataclasses.fields(JAX_TINY)})
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch intra-op thread for the file, its module-scoped fixtures
    included (an autouse fixture is set up before the others of its
    scope): the suite runs this file beside other pytest-xdist workers,
    and PyTorch's default of one OpenMP thread per core in every worker
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init_shapes(cfg):
    g4 = 4 * cfg.grid
    return jax.eval_shape(lambda: jax_sam.Sam(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.img_size, cfg.img_size, 3)),
        jnp.zeros((1, 4, 2)), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, g4, g4, 1))))["params"]


def sam_pair(seed: int = 0):
    """(the JAX params tree, the port's `Sam` holding the same values):
    `_fill`'s fan-in scaled weights, with every LayerNorm scale 1 + N(0,
    0.1^2) (`_fill`'s N(0, 0.1^2) flattens each mask to one sign)."""
    rng = np.random.default_rng(seed + 1000)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: ((1 + 0.1 * rng.standard_normal(x.shape)).astype(
            np.float32) if str(path[-1]) == "['scale']" else np.asarray(x)),
        _fill(_jax_init_shapes(JAX_TINY), seed))
    net = torch_sam.Sam(TINY).eval()
    net.load_state_dict(sam_state_dict_from_flax(net, tree), strict=True)
    return tree, net


@pytest.fixture(scope="module")
def pair():
    return sam_pair()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, TINY.img_size, TINY.img_size, 3),
                              np.float32)
    coords = np.array([[[10.0, 20.0], [40.0, 33.0], [0.0, 0.0],
                        [5.0, 60.0], [50.0, 7.0]]], np.float32)
    labels = np.array([[1, 0, -1, 2, 3]], np.int32)  # fg, bg, pad, box
    return img, coords, labels


def assert_close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _port(net, img, coords, labels, mask_in=None):
    with torch.no_grad():
        return [t.numpy() for t in net(
            torch.from_numpy(np.moveaxis(img, -1, 1)),
            torch.from_numpy(coords), torch.from_numpy(labels),
            None if mask_in is None else torch.from_numpy(mask_in[:, None]))]


@pytest.mark.parametrize("with_mask", [False, True],
                         ids=["points", "mask_prompt"])
def test_forward_matches_jax(pair, inputs, with_mask):
    """Image encoder, prompt encoder (labels 1 / 0 / -1 / 2 / 3, and a
    dense mask prompt) and all four masks and IoUs of the decoder."""
    tree, net = pair
    img, coords, labels = inputs
    g4 = 4 * TINY.grid
    mask_in = (np.random.default_rng(1).standard_normal((1, g4, g4),
                                                        np.float32)
               if with_mask else None)
    j_masks, j_iou = jax_sam.Sam(JAX_TINY).apply(
        {"params": tree}, jnp.asarray(img), jnp.asarray(coords),
        jnp.asarray(labels),
        None if mask_in is None else jnp.asarray(mask_in[..., None]))
    t_masks, t_iou = _port(net, img, coords, labels, mask_in)
    assert t_masks.shape == (1, 4, g4, g4) and t_iou.shape == (1, 4)
    assert_close(t_masks, j_masks, "masks")
    assert_close(t_iou, j_iou, "iou")


def test_encoder_and_prompt_pieces_match_jax(pair, inputs):
    """The image embedding, the sparse point tokens and the dense
    positional map, each against the JAX module's method."""
    tree, net = pair
    img, coords, labels = inputs
    model = jax_sam.Sam(JAX_TINY)
    emb = model.apply({"params": tree}, jnp.asarray(img),
                      method=jax_sam.Sam.encode_image)
    sparse = model.apply(
        {"params": tree}, jnp.asarray(coords), jnp.asarray(labels),
        method=lambda m, c, l: m.prompt_encoder.embed_points(c, l))
    dense_pe = model.apply({"params": tree},
                           method=lambda m: m.prompt_encoder.dense_pe())
    with torch.no_grad():
        t_emb = net.encode_image(torch.from_numpy(np.moveaxis(img, -1, 1)))
        t_sparse = net.prompt_encoder.embed_points(
            torch.from_numpy(coords), torch.from_numpy(labels))
        t_pe = net.prompt_encoder.dense_pe()
    assert_close(t_emb.permute(0, 2, 3, 1).numpy(), emb, "embedding")
    assert_close(t_sparse.numpy(), sparse, "sparse")
    assert_close(t_pe[0].permute(1, 2, 0).numpy(), dense_pe, "dense_pe")


@pytest.mark.parametrize("stored, size", [(7, 6), (11, 4), (9, 5)])
def test_rel_pos_table_matches_jax(stored, size):
    """`_rel_pos_table`, the gather and its linear-resize branch (a table
    stored for another extent: up, down, and none)."""
    rel = np.random.default_rng(2).standard_normal((stored, 4), np.float32)
    want = np.asarray(jax_sam._rel_pos_table(jnp.asarray(rel), size))
    got = torch_sam._rel_pos_table(torch.from_numpy(rel), size).numpy()
    assert got.shape == (size, size, 4)
    assert_close(got, want)


def test_window_partition_pads_and_round_trips():
    """4x4 tokens pad to 6x6 under window 3 (zeros), and unpartition
    crops back, as the JAX functions do."""
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 5), np.float32)
    wins, padded = torch_sam._window_partition(torch.from_numpy(x), 3)
    j_wins, j_padded = jax_sam._window_partition(jnp.asarray(x), 3)
    assert padded == j_padded == (6, 6) and wins.shape == (8, 3, 3, 5)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(j_wins))
    back = torch_sam._window_unpartition(wins, 3, padded, (4, 4))
    np.testing.assert_array_equal(back.numpy(), x)


def test_weights_round_trip_exactly(pair):
    """`convert_sam_state_dict` of the port's state dict is the JAX tree,
    bit for bit."""
    tree, net = pair
    back = jax_sam.convert_sam_state_dict(net.state_dict())
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert flat_back.keys() == flat.keys()
    for path, arr in flat.items():
        np.testing.assert_array_equal(flat_back[path], arr,
                                      err_msg=jax.tree_util.keystr(path))


RELEASED_KEYS = (
    "image_encoder.patch_embed.proj.weight",
    "image_encoder.pos_embed",
    "image_encoder.blocks.0.attn.qkv.weight",
    "image_encoder.blocks.0.attn.rel_pos_h",
    "image_encoder.neck.0.weight",
    "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "prompt_encoder.point_embeddings.0.weight",
    "prompt_encoder.not_a_point_embed.weight",
    "prompt_encoder.mask_downscaling.0.weight",
    "mask_decoder.transformer.layers.0.self_attn.q_proj.weight",
    "mask_decoder.transformer.final_attn_token_to_image.q_proj.weight",
    "mask_decoder.iou_token.weight",
    "mask_decoder.mask_tokens.weight",
    "mask_decoder.output_upscaling.0.weight",
    "mask_decoder.output_hypernetworks_mlps.0.layers.0.weight",
    "mask_decoder.iou_prediction_head.layers.0.weight",
)


@pytest.mark.parametrize("variant", ["vit_b", "vit_l", "vit_h"])
def test_key_schema_matches_the_release(variant):
    """The port's `state_dict()` of each released variant (built on the
    meta device) has the released keys and shapes: the released keys
    tests/test_sam_parity.py spot-checks, the relative position tables of
    a windowed and a global block, one qkv per block, and a conversion by
    `convert_sam_state_dict` that matches the JAX init's tree (shapes
    only, no 1024x1024 forward)."""
    cfg = torch_sam.sam_config_registry[variant]()
    with torch.device("meta"):
        sd = torch_sam.Sam(cfg).state_dict()
    for key in RELEASED_KEYS:
        assert key in sd, key
    head_dim = cfg.embed_dim // cfg.num_heads
    g0 = cfg.global_attn_indexes[0]
    assert sd["image_encoder.blocks.0.attn.rel_pos_h"].shape == (27, head_dim)
    assert sd[f"image_encoder.blocks.{g0}.attn.rel_pos_w"].shape == (
        2 * cfg.grid - 1, head_dim)
    assert sd["mask_decoder.output_upscaling.0.weight"].shape == (256, 64, 2,
                                                                  2)
    assert len([k for k in sd if k.endswith(".attn.qkv.weight")]) == cfg.depth
    assert not any("pixel_" in k for k in sd)
    zeros = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
             for k, v in sd.items()}
    jax_cfg = jax_sam.sam_config_registry[variant]()
    assert_tree_shapes_match(jax_sam.convert_sam_state_dict(zeros),
                             _jax_init_shapes(jax_cfg))


def test_load_sam_state_dict_is_strict(tmp_path, pair):
    """A `.pth` of a seeded port model loads with strict=True (the
    predictor's pixel_mean / pixel_std dropped where a file has them); a
    missing or a misshapen key raises."""
    _, net = pair
    sd = net.state_dict()
    path = tmp_path / "sam_tiny.pth"
    torch.save({**sd, "pixel_mean": torch.zeros(3, 1, 1),
                "pixel_std": torch.ones(3, 1, 1)}, path)
    got = torch_sam.load_sam_state_dict(str(path), config=TINY)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    fresh = torch_sam.Sam(TINY)
    fresh.load_state_dict(got, strict=True)

    torch.save({k: v for k, v in sd.items()
                if k != "mask_decoder.iou_token.weight"}, path)
    with pytest.raises(RuntimeError, match="iou_token"):
        torch_sam.load_sam_state_dict(str(path), config=TINY)
    torch.save({**sd, "image_encoder.pos_embed": torch.zeros(1, 3, 3, 32)},
               path)
    with pytest.raises(RuntimeError, match="pos_embed"):
        torch_sam.load_sam_state_dict(str(path), config=TINY)
    with pytest.raises(RuntimeError, match="size mismatch"):
        torch_sam.load_sam_state_dict(str(path), "vit_b")
