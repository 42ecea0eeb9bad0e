"""The port's Cutie (`propainter_tpu_torch.models.cutie`) and its inference
engine (`propainter_tpu_torch.demo.cutie_core`) against the JAX package's,
on the CPU, in fp32 (JAX at 'highest' matmul precision).

Weights: the JAX `CUTIE` of a small config (`SMALL`: a resnet18 pixel
trunk with ms_dims (256, 128, 64), 32-wide features, 2 heads, 2 blocks of
4 queries) is filled from a numpy seed (`_fill`: kernels ~ N(0,
1/fan_in), other leaves ~ N(0, 0.1^2), batch-norm variances ~ U(0.5,
1.5)) and carried into the port by `weights.cutie_state_dict_from_flax`.
Modules and memory math agree within 1e-4 of the reference's largest
magnitude (`RTOL`): fp32 summation order through a few dozen layers. The
release config's key schema converts onto the JAX init's tree (shapes
only, on the meta device); the weights round-trip through
`convert_cutie_state_dict` exactly; `load_cutie_state_dict` drops what
the JAX converter skips and loads strictly.
"""

import ast
import functools
import inspect

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu.convert import assert_tree_shapes_match
from propainter_tpu.demo import cutie_core as jax_core
from propainter_tpu.models import cutie as jc
from tests.test_torch_models import _fill

from propainter_tpu_torch.demo import cutie_core as torch_core
from propainter_tpu_torch.models import cutie as tc
from propainter_tpu_torch.weights import cutie_state_dict_from_flax

SMALL_KW = dict(pixel_encoder_type="resnet18", ms_dims=(256, 128, 64),
                pixel_dim=32, key_dim=16, value_dim=32, sensory_dim=32,
                embed_dim=32, ot_ff_dim=64, ot_num_heads=2, ot_num_blocks=2,
                ot_num_queries=4, up_dims=(32, 16, 16))
JAX_SMALL = jc.CutieConfig(**SMALL_KW)
SMALL = tc.CutieConfig(**SMALL_KW)
H, W, N = 64, 96, 2
h, w = H // 16, W // 16
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch intra-op thread for the file, its module-scoped fixtures
    included (an autouse fixture is set up before the others of its
    scope): the suite runs this file beside other pytest-xdist workers,
    and PyTorch's default of one OpenMP thread per core in every worker
    oversubscribes the host (the CutieCore run took 10x its time alone
    when its fixture ran before a per-test thread setting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache
def _jax_init_shapes(cfg, H=H, W=W):
    return jax.eval_shape(lambda: jc.CUTIE(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H // 16, W // 16, cfg.pixel_dim)),
        jnp.zeros((1, N, H // 16, W // 16, cfg.sensory_dim)),
        jnp.zeros((1, N, H, W)), method="init_all_params"))["params"]


def cutie_pair(seed: int = 0):
    """(the JAX params tree, the port's `CUTIE` holding the same values) of
    the `SMALL` config: `_fill`'s weights with every batch-norm and
    LayerNorm scale 1 + N(0, 0.1^2) (at `_fill`'s N(0, 0.1^2) the features
    fade through the trunks, keys of different pixels come within
    rounding of each other and the top-k picks among ties)."""
    rng = np.random.default_rng(seed + 1000)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: ((1 + 0.1 * rng.standard_normal(x.shape)).astype(
            np.float32) if str(path[-1]) == "['scale']" else np.asarray(x)),
        _fill(_jax_init_shapes(JAX_SMALL), seed))
    net = tc.CUTIE(SMALL).eval()
    net.load_state_dict(cutie_state_dict_from_flax(net, tree), strict=True)
    return tree, net


@pytest.fixture(scope="module")
def pair():
    return cutie_pair()


@pytest.fixture(scope="module")
def jax_jit():
    """The JAX CUTIE's methods, jitted once for the file with the params
    an argument, so the module tests and the CutieCore run (other weights,
    the same shapes) share each compile."""
    model = jc.CUTIE(JAX_SMALL)

    def bind(method, static=()):
        return jax.jit(lambda params, *a: model.apply({"params": params}, *a,
                                                      method=method),
                       static_argnums=static)

    return {m: bind(m) for m in ("encode_image", "transform_key",
                                 "read_first")} | {
        "encode_mask": bind("encode_mask", (5,)),
        "segment": bind("segment", (6,))}


@pytest.fixture(scope="module")
def jax_methods(pair, jax_jit):
    tree, _ = pair
    return {m: functools.partial(f, tree) for m, f in jax_jit.items()}


# the JAX memory math, each jitted once for the file (one compile a shape,
# not one a primitive)
jax_similarity = jax.jit(jc.get_similarity)
jax_topk_softmax = jax.jit(jc.topk_softmax, static_argnums=1)
jax_readout = jax.jit(jc.readout)
jax_aggregate = jax.jit(jc.aggregate, static_argnums=1)


def assert_close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _t(a, axis=-1, to=1):
    """numpy channels-last -> torch channels at `to`."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, axis, to)))


def _n(t, frm=1):
    """torch channels at `frm` -> numpy channels-last."""
    return np.moveaxis(t.detach().numpy(), frm, -1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    return dict(
        img=rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32),
        sensory=rng.standard_normal((1, N, h, w, 32)).astype(np.float32),
        masks=(rng.uniform(size=(1, N, H, W)) > 0.7).astype(np.float32),
        visual=rng.standard_normal((1, N, h, w, 32)).astype(np.float32),
        obj=rng.standard_normal((1, N, 1, 4, 33)).astype(np.float32),
        f8=rng.standard_normal((1, 2 * h, 2 * w, 128)).astype(np.float32),
        f4=rng.standard_normal((1, 4 * h, 4 * w, 64)).astype(np.float32))


@pytest.fixture(scope="module")
def encoded(pair, jax_methods, inputs):
    """Both packages' encode_image on the same image."""
    _, net = pair
    (f16, f8, f4), pix = jax_methods["encode_image"](jnp.asarray(
        inputs["img"]))
    with torch.no_grad():
        tf, tpix = net.encode_image(_t(inputs["img"]))
    return (f16, f8, f4, pix), (*tf, tpix)


def test_encode_image_matches_jax(encoded):
    """The resnet18 pixel trunk (frozen BN, -inf max pool) at 1/16, 1/8,
    1/4 and the projected pixel features."""
    for name, j, t in zip(("f16", "f8", "f4", "pix_feat"), *encoded):
        assert t.shape[1] == j.shape[-1] and t.shape[2:] == j.shape[1:3]
        assert_close(_n(t), j, name)


def test_transform_key_matches_jax(pair, jax_methods, encoded):
    """Key, shrinkage (d^2 + 1) and selection (sigmoid) from f16."""
    _, net = pair
    jk = jax_methods["transform_key"](encoded[0][0])
    with torch.no_grad():
        tk = net.transform_key(encoded[1][0])
    for name, j, t in zip(("key", "shrinkage", "selection"), jk, tk):
        assert_close(_n(t), j, name)


@pytest.mark.parametrize("deep_update", [True, False],
                         ids=["deep_update", "no_update"])
def test_encode_mask_matches_jax(pair, jax_methods, encoded, inputs,
                                 deep_update):
    """The mask trunk (5 channels), the fuser, the deep sensory update (or
    the sensory passed through) and the object summaries."""
    _, net = pair
    pix, tpix = encoded[0][3], encoded[1][3]
    jv, js, jsum = jax_methods["encode_mask"](
        jnp.asarray(inputs["img"]), pix, jnp.asarray(inputs["sensory"]),
        jnp.asarray(inputs["masks"]), deep_update)
    with torch.no_grad():
        tv, ts, tsum = net.encode_mask(
            _t(inputs["img"]), tpix, _t(inputs["sensory"], to=2),
            torch.from_numpy(inputs["masks"]), deep_update=deep_update)
    assert_close(_n(tv, 2), jv, "value")
    assert_close(_n(ts, 2), js, "sensory")
    assert_close(tsum.numpy(), jsum, "summaries")
    if not deep_update:
        np.testing.assert_array_equal(_n(ts, 2), inputs["sensory"])


def test_read_first_matches_jax(pair, jax_methods, encoded, inputs):
    """Pixel fusion (sensory compress, last mask and others at 1/16) and
    the query transformer's readout over its aux-mask attention."""
    _, net = pair
    j = jax_methods["read_first"](
        encoded[0][3], jnp.asarray(inputs["visual"]),
        jnp.asarray(inputs["sensory"]), jnp.asarray(inputs["masks"]),
        jnp.asarray(inputs["obj"]))
    with torch.no_grad():
        t = net.read_first(encoded[1][3], _t(inputs["visual"], to=2),
                           _t(inputs["sensory"], to=2),
                           torch.from_numpy(inputs["masks"]),
                           torch.from_numpy(inputs["obj"]))
    assert_close(_n(t, 2), j, "memory readout")


@pytest.mark.parametrize("update_sensory", [True, False],
                         ids=["update", "keep"])
def test_segment_matches_jax(pair, jax_methods, encoded, inputs,
                             update_sensory):
    """The mask decoder (two upsample blocks with skips, the 3x3 head),
    the multi-scale sensory update (or none) and the aggregated, 4x
    upsampled, softmaxed probabilities with background."""
    _, net = pair
    rng = np.random.default_rng(4)
    ro = rng.standard_normal((1, N, h, w, 32)).astype(np.float32)
    js, jp = jax_methods["segment"](
        encoded[0][0], jnp.asarray(inputs["f8"]), jnp.asarray(inputs["f4"]),
        jnp.asarray(ro), jnp.asarray(inputs["sensory"]), update_sensory)
    with torch.no_grad():
        ts, tp = net.segment(encoded[1][0], _t(inputs["f8"]),
                             _t(inputs["f4"]), _t(ro, to=2),
                             _t(inputs["sensory"], to=2), update_sensory)
    assert tp.shape == (1, N + 1, H, W)
    assert_close(_n(ts, 2), js, "sensory")
    assert_close(tp.numpy(), jp, "prob")
    if not update_sensory:
        np.testing.assert_array_equal(_n(ts, 2), inputs["sensory"])


@pytest.mark.parametrize("case", ["mixed", "object_absent", "selector"])
def test_aux_mask_matches_jax(case):
    """The queries' attention mask: foreground by `>=` against the max of
    the aggregated logits, the second half of the queries on the rest,
    rows with nothing to see unblocked (an object absent everywhere), and
    a selector scaling the probabilities."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((1, N, h, w)).astype(np.float32) * 3
    selector = None
    if case == "object_absent":
        logits[:, 1] = -30.0
    if case == "selector":
        selector = np.array([1.0, 0.0], np.float32)[None, :, None, None]
    j = jc.QueryTransformer(JAX_SMALL)._aux_mask(
        jnp.asarray(logits), None if selector is None
        else jnp.asarray(selector))
    t = tc.QueryTransformer(SMALL)._aux_mask(
        torch.from_numpy(logits), None if selector is None
        else torch.from_numpy(selector))
    assert t.dtype == torch.bool and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    q2 = SMALL.ot_num_queries // 2
    assert t[:, :q2].any() and not t.all(dim=-1).any()


def test_positional_encoding_matches_jax():
    """The sin/cos table is the JAX package's, bit for bit (both numpy)."""
    for args in ((h, w, 32, 32.0, 128.0), (30, 54, 256, 32.0, 128.0)):
        np.testing.assert_array_equal(tc.positional_encoding_2d(*args),
                                      jc.positional_encoding_2d(*args))


@pytest.mark.parametrize("with_mask", [False, True], ids=["open", "masked"])
def test_multihead_attention_matches_jax(with_mask):
    """nn.MultiheadAttention's fused in_proj carried from the JAX q / k / v
    Dense layers, with a boolean mask (True = blocked) or none."""
    rng = np.random.default_rng(6)
    E, nh, B, Tq, Tk = 32, 2, 2, 5, 7
    q, k, v = (rng.standard_normal((B, T, E)).astype(np.float32)
               for T in (Tq, Tk, Tk))
    mask = None
    if with_mask:
        mask = rng.uniform(size=(B * nh, Tq, Tk)) > 0.6
        mask[..., 0] = False
    mod = jc.MultiheadAttention(E, nh)
    tree = _fill(jax.eval_shape(lambda: mod.init(
        jax.random.PRNGKey(0), q, k, v))["params"], 7)
    j = mod.apply({"params": tree}, q, k, v,
                  None if mask is None else jnp.asarray(mask))
    net = tc.MultiheadAttention(E, nh)
    net.load_state_dict(cutie_state_dict_from_flax(net, tree), strict=True)
    with torch.no_grad():
        t = net(*map(torch.from_numpy, (q, k, v)),
                None if mask is None else torch.from_numpy(mask))
    assert_close(t.numpy(), j)


MEM = dict(B=1, Ck=16, Nt=37, P=h * w, O=N, Cv=32)


@pytest.fixture(scope="module")
def memory():
    rng = np.random.default_rng(8)
    m = MEM
    return dict(
        mk=rng.standard_normal((m["B"], m["Ck"], m["Nt"])).astype(np.float32),
        ms=rng.uniform(1, 2, (m["B"], 1, m["Nt"])).astype(np.float32),
        qk=rng.standard_normal((m["B"], m["Ck"], m["P"])).astype(np.float32),
        qe=rng.uniform(0, 1, (m["B"], m["Ck"], m["P"])).astype(np.float32),
        mv=rng.standard_normal((m["B"], m["O"], m["Cv"], m["Nt"])).astype(
            np.float32))


@pytest.mark.parametrize("use_s, use_e", [(True, True), (True, False),
                                          (False, True), (False, False)],
                         ids=["s_e", "s", "e", "plain"])
def test_get_similarity_matches_jax(memory, use_s, use_e):
    """The anisotropic L2 similarity with and without shrinkage and
    selection."""
    args = [memory["mk"], memory["ms"] if use_s else None, memory["qk"],
            memory["qe"] if use_e else None]
    j = jax_similarity(*[None if a is None else jnp.asarray(a)
                         for a in args])
    t = tc.get_similarity(*[None if a is None else torch.from_numpy(a)
                            for a in args])
    assert t.shape == (1, MEM["Nt"], MEM["P"])
    assert_close(t.numpy(), j)


@pytest.mark.parametrize("top_k", [None, 1, 13, 37, 50],
                         ids=["dense", "k1", "k13", "k_eq_n", "k_gt_n"])
def test_topk_softmax_and_readout_match_jax(memory, top_k):
    """The top-k softmax over the memory tokens (the top value subtracted
    before exp; k > N takes every token), its scatter back, and the
    readout. The similarities are scaled so the affinity is spread: the
    largest weight of most pixels is below 0.9, and at ~-1e4 the
    unshifted exp would underflow to 0 / 0."""
    sim = jax_similarity(*map(jnp.asarray, (memory["mk"], memory["ms"],
                                            memory["qk"], memory["qe"])))
    sim = np.asarray(sim) * 0.05
    j = jax_topk_softmax(jnp.asarray(sim), top_k)
    t = tc.topk_softmax(torch.from_numpy(sim), top_k)
    assert_close(t.numpy(), j, "affinity")
    k = min(top_k or MEM["Nt"], MEM["Nt"])
    assert ((t > 0).sum(dim=1) == k).all()
    if k > 1:
        assert (t.max(dim=1).values < 0.9).float().mean() > 0.5
    far = torch.from_numpy(sim - 1e4)
    tf = tc.topk_softmax(far, top_k)
    assert torch.isfinite(tf).all()
    assert_close(tf.numpy(), jax_topk_softmax(jnp.asarray(sim - 1e4), top_k))
    jr = jax_readout(j, jnp.asarray(memory["mv"]))
    tr = tc.readout(t, torch.from_numpy(memory["mv"]))
    assert tr.shape == (1, MEM["O"], MEM["Cv"], MEM["P"])
    assert_close(tr.numpy(), jr, "readout")


def test_aggregate_matches_jax():
    """Soft aggregation: background = prod(1 - p), clipped, as logits;
    including probabilities of exactly 0 and 1 (the clip)."""
    rng = np.random.default_rng(9)
    prob = rng.uniform(0, 1, (1, 3, 8, 10)).astype(np.float32)
    prob[0, 0, 0, :3] = (0.0, 1.0, 0.5)
    for dim in (1, 0):
        assert_close(tc.aggregate(torch.from_numpy(prob), dim).numpy(),
                     jax_aggregate(jnp.asarray(prob), dim))


# ---------------------------------------------------------------------------
# CutieCore.step through the first FIFO trim
# ---------------------------------------------------------------------------

# memory frames at t = 0 (permanent), 3 and 6; after the t = 6 write the
# working memory holds 2 frames > max_mem_frames - 1 = 1, so the t = 3
# frame goes and t = 7, 8 read the trimmed memory; the sensory updates
# at 1 and 3 frames after a memory frame, not at 2
CORE = dict(mem_every=3, max_mem_frames=2, top_k=8, stagger_updates=2)
CORE_FRAMES = 9


def _core_clip():
    """Smooth random textures (no tied key tokens) drifting in
    brightness, and two rectangular objects on the first frame."""
    rng = np.random.default_rng(10)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for t in range(CORE_FRAMES):
        img = np.stack([0.5 + 0.3 * np.sin((x + 3 * t) / (5 + c) + c)
                        * np.cos(y / (7 - c)) for c in range(3)], -1)
        img = img + rng.uniform(-0.1, 0.1, img.shape)
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    mask0 = np.zeros((N, H, W), np.float32)
    mask0[0, 8:30, 10:40] = 1
    mask0[1, 34:58, 50:88] = 1
    return frames, mask0


@pytest.fixture(scope="module")
def core_runs(jax_jit):
    """Both engines over the clip: per-frame probabilities, the port's
    top affinity a pixel on every read, and both engines' memory after
    each step. The JAX engine's model passes are the file's jitted
    methods on its weights (the same functions it jits itself)."""
    tree, net = cutie_pair(seed=13)
    frames, mask0 = _core_clip()
    j = jax_core.CutieCore(tree, model_config=JAX_SMALL,
                           config=jax_core.CutieCoreConfig(**CORE))
    for m in ("encode_image", "transform_key", "read_first", "segment"):
        setattr(j, f"_{m}", functools.partial(jax_jit[m], tree))
    j._encode_mask = lambda *a: jax_jit["encode_mask"](tree, *a, True)
    t = torch_core.CutieCore(net, config=torch_core.CutieCoreConfig(**CORE),
                             device="cpu")
    tops, margins = [], []
    read = t._read_visual

    def recording(key, selection):
        sim = tc.get_similarity(t.mem_key, t.mem_shrinkage, key.flatten(2),
                                selection.flatten(2))
        tops.append(tc.topk_softmax(sim, t.cfg.top_k).max(dim=1).values)
        if sim.shape[1] > t.cfg.top_k:
            v = sim.sort(dim=1, descending=True).values
            margins.append((v[:, t.cfg.top_k - 1] - v[:, t.cfg.top_k]).min()
                           / v.abs().max())
        return read(key, selection)

    t._read_visual = recording
    out = []
    for i, f in enumerate(frames):
        m = mask0 if i == 0 else None
        pj, pt = j.step(f, m), t.step(f, m)
        out.append(dict(j=pj, t=pt, j_tokens=j.mem_key.shape[-1],
                        t_tokens=t.mem_key.shape[-1],
                        j_sensory=np.asarray(j.sensory),
                        t_sensory=t.sensory.numpy()))
    return dict(out=out, tops=tops, margins=margins, j=j, t=t)


def test_cutie_core_step_matches_jax(core_runs):
    """CutieCore.step over 9 frames: the permanent first frame, memory
    frames every 3, staggered sensory updates, and the first FIFO trim
    (t = 6) with two reads from the trimmed memory. Probabilities within
    1e-4 at each frame, the tracked masks neither empty nor full, the
    sensory memory within 1e-4 of scale."""
    for i, r in enumerate(core_runs["out"]):
        assert r["t"].shape == (N + 1, H, W)
        np.testing.assert_allclose(r["t"], r["j"], rtol=0, atol=RTOL,
                                   err_msg=f"frame {i}")
        labels = np.argmax(r["t"], axis=0)
        assert 0 < (labels > 0).sum() < labels.size, f"frame {i}"
        assert_close(np.moveaxis(r["t_sensory"], 2, -1), r["j_sensory"],
                     f"sensory, frame {i}")


def test_cutie_core_fifo_trim_and_stagger(core_runs):
    """Memory tokens per frame (one frame = h*w tokens): 1, 1, 1, 2, 2, 2,
    then 2 after the trim at t = 6 (the permanent frame and
    max_mem_frames - 1 = 1 working frame), equal in both engines; the
    kept tokens are the permanent frame's and the newest frame's;
    the sensory memory moves on update frames only; the reads' affinity
    is spread (most pixels' top weight below 0.9) and no read has a tie
    at its k-th token (the k-th and next similarities apart by 1e-6 of
    their scale, ~8 ulp: torch.topk and jax.lax.top_k may order ties
    differently)."""
    hw = h * w
    got = [r["t_tokens"] // hw for r in core_runs["out"]]
    assert got == [1, 1, 1, 2, 2, 2, 2, 2, 2]
    assert got == [r["j_tokens"] // hw for r in core_runs["out"]]
    j, t = core_runs["j"], core_runs["t"]
    assert t.perm_tokens == j.perm_tokens == hw
    assert_close(t.mem_key.numpy(), j.mem_key, "memory keys")
    assert_close(t.mem_value.numpy(), j.mem_value, "memory values")
    sens = [r["t_sensory"] for r in core_runs["out"]]
    moved = [not np.array_equal(a, b) for a, b in zip(sens, sens[1:])]
    # frames 1..8: an update at 1 and 3 frames after a memory frame (and
    # the deep update of every memory frame), none 2 frames after
    assert moved == [True, False, True, True, False, True, True, False]
    tops = torch.cat([x.flatten() for x in core_runs["tops"]])
    assert len(core_runs["tops"]) == CORE_FRAMES - 1
    assert (tops < 0.9).float().mean() > 0.5
    assert min(core_runs["margins"]) > 1e-6


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_release_key_schema_matches_jax_init():
    """The port's release-config CUTIE (built on the meta device), keyed
    as cutie-base-mega.pth, converts through `convert_cutie_state_dict`
    onto exactly the JAX init's tree, every leaf's shape equal."""
    with torch.device("meta"):
        net = tc.CUTIE(tc.CutieConfig())
    sd = {k: np.broadcast_to(np.float32(0), v.shape)
          for k, v in net.state_dict().items()}
    assert any(k.endswith(".in_proj_weight") for k in sd)
    assert "object_transformer.query_init.weight" in sd
    assert sd["object_transformer.blocks.0.pixel_ffn.conv.conv.weight"
              ].shape == (1, 1, 5)
    assert_tree_shapes_match(jc.convert_cutie_state_dict(sd),
                             _jax_init_shapes(jc.CutieConfig(), 48, 64))


def test_weights_round_trip_exactly(pair):
    """JAX params -> the port (`cutie_state_dict_from_flax`) ->
    `convert_cutie_state_dict` gives every leaf back bit for bit."""
    tree, net = pair
    back = jc.convert_cutie_state_dict(
        {k: v.numpy() for k, v in net.state_dict().items()})
    flat = jax.tree_util.tree_flatten_with_path
    got = {jax.tree_util.keystr(p): v for p, v in flat(back)[0]}
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in flat(tree)[0]}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_skip_list() -> tuple:
    """The `skip=[...]` literal of the JAX `convert_cutie_state_dict`."""
    fn = ast.parse(inspect.getsource(jc.convert_cutie_state_dict))
    for node in ast.walk(fn):
        if isinstance(node, ast.keyword) and node.arg == "skip":
            return tuple(ast.literal_eval(node.value))
    raise AssertionError("no skip list")


def test_load_cutie_state_dict_skips_what_jax_skips(pair, tmp_path):
    """`CUTIE_SKIP` is the JAX converter's skip list; a file holding the
    release's extra keys (the normalisation buffers, the aux heads, the
    positional encodings' buffers) and a 'module.' prefix loads with them
    dropped and every other tensor as saved; a missing or an unknown key
    fails the strict load."""
    assert tc.CUTIE_SKIP == _jax_skip_list()
    _, net = pair
    sd = net.state_dict()
    extra = {"pixel_mean": torch.zeros(1, 3, 1, 1),
             "pixel_std": torch.ones(1, 3, 1, 1),
             "aux_computer.sensory_aux.weight": torch.zeros(1, 32, 1, 1),
             "object_summarizer.pos_enc.inv_freq": torch.zeros(8),
             "object_transformer.spatial_pe.cached_penc": torch.zeros(1)}
    path = tmp_path / "cutie-base-mega.pth"
    torch.save({f"module.{k}": v for k, v in {**sd, **extra}.items()}, path)
    loaded = tc.load_cutie_state_dict(str(path), SMALL)
    assert loaded.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)
    short = dict(sd)
    short.pop("pix_feat_proj.bias")
    torch.save(short, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="Missing key"):
        tc.load_cutie_state_dict(str(tmp_path / "short.pth"), SMALL)
    torch.save({**sd, "mask_decoder.extra.weight": torch.zeros(1)},
               tmp_path / "long.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        tc.load_cutie_state_dict(str(tmp_path / "long.pth"), SMALL)


def test_copies_match_the_jax_package():
    """`pad_divide_by` and `unpad` are the JAX package's, by source."""
    for name in ("pad_divide_by", "unpad"):
        assert (inspect.getsource(getattr(torch_core, name))
                == inspect.getsource(getattr(jax_core, name)))


def test_core_needs_a_gpu_unless_told_cpu(pair, monkeypatch):
    """Built without device="cpu" on a machine without a GPU, CutieCore
    raises rather than running on the CPU."""
    _, net = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_core.CutieCore(net)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        torch_core.CutieCore(net, device="cuda")
    core = torch_core.CutieCore(net.state_dict(), model_config=SMALL,
                                device="cpu")
    assert core.device.type == "cpu"
