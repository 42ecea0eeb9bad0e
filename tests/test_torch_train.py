"""The PyTorch port's training against the JAX package on the CPU: Canny,
every loss, the discriminator and its spectral-norm stats, VGG and LPIPS,
the flow completion's and the generator's training forms, both train
steps against the jitted JAX steps, the optimizer against optax, the
train checkpoints, and the copied jax-free helpers pinned by source.

Weights are the port's, seeded (`weights.seeded_init_`, fan-in scaled so
activations stay O(1)), carried into the JAX package through its own
converters. The JAX steps run on a train state built directly, with an
optimizer that records the gradients as its state and leaves the
parameters unchanged, so the gradients compared are exactly the steps'.
Tolerances: losses 1e-5 relative; gradients 1e-4 of each tensor's largest
magnitude; forward outputs 1e-5 of their scale (each test says which).
"""

import inspect
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from propainter_tpu.core import dataset as jax_dataset
from propainter_tpu.core import losses as JL
from propainter_tpu.core import mask_synthesis as jax_masks
from propainter_tpu.core import trainer as JT
from propainter_tpu.models.discriminator import (
    Discriminator as JaxDiscriminator, convert_discriminator_state_dict)
from propainter_tpu.models.flow_completion import (
    RecurrentFlowCompleteNet as JaxFlowComplete, convert_flowcomp_state_dict,
    forward_bidirect_flow as jax_forward_bidirect_flow)
from propainter_tpu.models.propainter import (
    InpaintGenerator as JaxGenerator, convert_inpaint_state_dict)
from propainter_tpu.models.vgg import (
    LPIPSVgg as JaxLPIPS, VGGFeatureExtractor as JaxVGG,
    convert_lpips_state_dict, convert_vgg_state_dict)
from propainter_tpu.ops.canny import canny_edges as jax_canny
from propainter_tpu.utils import tb as jax_tb

from propainter_tpu_torch.checkpoints import TrainCheckpointManager
from propainter_tpu_torch.core import dataset as torch_dataset
from propainter_tpu_torch.core import losses as TL
from propainter_tpu_torch.core import mask_synthesis as torch_masks
from propainter_tpu_torch.core import trainer as TT
from propainter_tpu_torch.models.discriminator import Discriminator
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet, forward_bidirect_flow)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.vgg import (
    LPIPSVgg, VGGFeatureExtractor, lpips_state_dict)
from propainter_tpu_torch.ops.canny import canny_edges
from propainter_tpu_torch.utils import tb as torch_tb
from propainter_tpu_torch.weights import (
    discriminator_state_dict_from_flax, lpips_state_dict_from_flax,
    seeded_init_, vgg_state_dict_from_flax)

B, T, L_T, H, W = 1, 4, 3, 32, 48
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
SN_CONVS = (0, 2, 4, 6, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test (pytest-xdist runs this file
    beside other workers; see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-12)


def _scaled_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _j(a):
    return jnp.array(np.asarray(a))


def _sd(module) -> dict:
    """A copy of the module's state dict: the JAX converters' numpy arrays
    would share the parameters' memory, which the port's optimizer then
    updates in place while the JAX step, dispatched asynchronously, may
    still be reading them."""
    return {k: v.clone() for k, v in module.state_dict().items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth(rng, shape, lo=-0.8, hi=0.8):
    """(N, ..., H, W, C) smooth random images: 4 x 6 noise upsampled."""
    *lead, h, w, c = shape
    small = torch.from_numpy(rng.uniform(lo, hi, (int(np.prod(lead)), c, 4, 6)
                                         ).astype(np.float32))
    big = torch.nn.functional.interpolate(small, size=(h, w),
                                          mode="bilinear")
    return big.permute(0, 2, 3, 1).reshape(shape).numpy()


def _masks(shape):
    m = np.zeros(shape, np.float32)
    m[..., 8:20, 10:30, :] = 1.0
    return m


# ---------------------------------------------------------------------------
# Canny and the losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_canny_matches_jax(sigma):
    """Edges of smooth images and of a block's magnitude map (the flow
    trainer's kind of input) equal the JAX function's, with and without
    hysteresis, except at pixels within 1e-5 of a threshold: the double
    threshold's 0.1 and 0.2 on the magnitude, or the non-maximum
    suppression's 0 on the margin over the neighbours (relative to the
    largest magnitude). A block's edge between two pixel rows gives the
    two rows equal magnitudes, a tie the two summation orders break
    either way (at sigma 1, 48 such pixels of 1536)."""
    from propainter_tpu_torch.ops.canny import _nms

    rng = np.random.default_rng(0)
    x = (_smooth(rng, (2, H, W, 1), 0.0, 1.0) ** 2).astype(np.float32)
    mag = np.zeros((1, H, W, 1), np.float32)
    mag[0, 10:22, 12:30] = 1.0
    for img in (x, mag):
        magnitude, margin = (t.numpy()[..., None] for t in _nms(
            _t(img), 1e-6, sigma))
        tol = 1e-5 * magnitude.max()
        at_threshold = ((np.abs(margin) < tol)
                        | (np.abs(magnitude - 0.1) < 1e-5)
                        | (np.abs(magnitude - 0.2) < 1e-5))
        for hyst in (True, False):
            want = np.asarray(jax_canny(_j(img), sigma=sigma,
                                        hysteresis=hyst))
            got = canny_edges(_t(img), sigma=sigma, hysteresis=hyst).numpy()
            assert got.shape == want.shape and want.any()
            assert (got == want).mean() > 0.95
            np.testing.assert_array_equal(got[~at_threshold],
                                          want[~at_threshold])


def _loss_inputs():
    rng = np.random.default_rng(1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        pred=np.tanh(f(B, T, H, W, 3)), gt=np.tanh(f(B, T, H, W, 3)),
        mask=_masks((B, T, H, W, 1)),
        logits=f(2, 3, 4, 5, 8), logits2=f(2, 3, 4, 5, 8),
        flows=[f(2, L_T - 1, H, W, 2) for _ in range(4)],
        frames=np.tanh(f(2, L_T, H, W, 3)),
        fmasks=_masks((2, L_T, H, W, 1)),
        small=[f(2, L_T - 1, H // 4, W // 4, 2) for _ in range(2)],
        edges=[1 / (1 + np.exp(-f(2, L_T - 1, H, W, 1))) for _ in range(2)],
        gt_edges=[(f(2, L_T - 1, H, W, 1) > 1.0).astype(np.float32)
                  for _ in range(2)])


@pytest.fixture(scope="module")
def vgg_pair():
    """A VGG19 feature extractor (every conv, so the JAX converter finds
    each) and LPIPS, the port's seeded and the JAX package's converted."""
    names = ("relu1_2", "relu3_4", "conv5_4")
    vgg = seeded_init_(VGGFeatureExtractor(names, "vgg19", True, True), 5,
                       fan_in_scaled=True).eval()
    jvgg = JaxVGG(names, "vgg19", True, True)
    vgg_tree = convert_vgg_state_dict(_sd(vgg), "vgg19")
    lp = seeded_init_(LPIPSVgg(), 6, fan_in_scaled=True).eval()
    sd = lp.state_dict()
    lp_tree = convert_lpips_state_dict(
        {k: v for k, v in sd.items() if k.startswith("lin")},
        {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")})
    return dict(vgg=vgg,
                jvgg=jax.jit(lambda x: jvgg.apply({"params": vgg_tree}, x)),
                vgg_tree=vgg_tree, lpips=lp, lpips_tree=lp_tree,
                jlpips=jax.jit(lambda a, b: JaxLPIPS().apply(
                    {"params": lp_tree}, a, b)))


LOSSES = ["hole_valid_l1", "adversarial_hinge", "adversarial_lsgan",
          "adversarial_nsgan", "perceptual", "lpips", "charbonnier",
          "smoothness", "second_order", "ternary", "flow_loss",
          "flow_simple_loss", "edge_bce", "edge_loss"]


@pytest.mark.parametrize("name", LOSSES)
def test_loss_matches_jax(name, vgg_pair):
    """Each loss of `core/losses.py` within 1e-5 relative of the JAX
    function on the same inputs."""
    a = _loss_inputs()
    cf = a["flows"][0][:, 0]
    cm = a["fmasks"][:, 0]
    if name == "hole_valid_l1":
        pairs = zip(TL.hole_valid_l1(_t(a["pred"]), _t(a["gt"]),
                                     _t(a["mask"]), 0.7, 1.3),
                    JL.hole_valid_l1(_j(a["pred"]), _j(a["gt"]),
                                     _j(a["mask"]), 0.7, 1.3))
    elif name.startswith("adversarial"):
        kind = name.split("_")[1]
        real, fake = a["logits"], a["logits2"]
        if kind != "hinge":
            real, fake = 1 / (1 + np.exp(-real)), 1 / (1 + np.exp(-fake))
        pairs = [(TL.adversarial_g_loss(_t(fake), kind),
                  JL.adversarial_g_loss(_j(fake), kind)),
                 (TL.adversarial_d_loss(_t(real), _t(fake), kind),
                  JL.adversarial_d_loss(_j(real), _j(fake), kind))]
    elif name == "perceptual":
        x, gt = a["pred"][0, :2], a["gt"][0, :2]
        weights = {"relu1_2": 0.1, "relu3_4": 1.0, "conv5_4": 0.5}
        pairs = []
        for crit, style in (("l1", 0.0), ("l2", 1e6), ("fro", 1e3)):
            with torch.no_grad():
                got = TL.perceptual_loss(vgg_pair["vgg"], weights, _t(x),
                                         _t(gt), crit, style)
            want = JL.perceptual_loss(vgg_pair["jvgg"], weights, _j(x),
                                      _j(gt), crit, style)
            pairs += [(g, w) for g, w in zip(got, want) if w is not None]
    elif name == "lpips":
        x, gt = a["pred"][0], a["gt"][0]
        with torch.no_grad():
            got = TL.lpips_loss(vgg_pair["lpips"], _t(x), _t(gt), 0.5)
        pairs = [(got, JL.lpips_loss(vgg_pair["jlpips"], _j(x), _j(gt),
                                     0.5))]
    elif name == "charbonnier":
        pairs = [(TL.charbonnier(_t(cf), m), JL.charbonnier(_j(cf), jm))
                 for m, jm in ((None, None), (_t(cm), _j(cm)))]
    elif name in ("smoothness", "second_order"):
        fn = name + "_loss"
        pairs = [(getattr(TL, fn)(_t(cf), _t(cm)),
                  getattr(JL, fn)(_j(cf), _j(cm)))]
    elif name == "ternary":
        fr = a["frames"]
        args = (cf, a["flows"][1][:, 0], cm, fr[:, 0], fr[:, 1])
        pairs = [(TL.ternary_loss(*map(_t, args)),
                  JL.ternary_loss(*map(_j, args)))]
    elif name == "flow_loss":
        p, g = a["flows"][:2], a["flows"][2:]
        pairs = zip(TL.flow_loss([_t(f) for f in p], [_t(f) for f in g],
                                 _t(a["fmasks"]), _t(a["frames"])),
                    JL.flow_loss([_j(f) for f in p], [_j(f) for f in g],
                                 _j(a["fmasks"]), _j(a["frames"])))
    elif name == "flow_simple_loss":
        pairs = [(TL.flow_simple_loss([_t(f) for f in a["small"]],
                                      [_t(f) for f in a["flows"][:2]]),
                  JL.flow_simple_loss([_j(f) for f in a["small"]],
                                      [_j(f) for f in a["flows"][:2]]))]
    elif name == "edge_bce":
        e, g = a["edges"][0][:, 0], a["gt_edges"][0][:, 0]
        pairs = [(TL.edge_bce(_t(e), _t(g)), JL.edge_bce(_j(e), _j(g)))]
    else:
        pairs = [(TL.edge_loss([_t(e) for e in a["edges"]],
                               [_t(e) for e in a["gt_edges"]],
                               _t(a["fmasks"])),
                  JL.edge_loss([_j(e) for e in a["edges"]],
                               [_j(e) for e in a["gt_edges"]],
                               _j(a["fmasks"])))]
    pairs = list(pairs)
    assert pairs
    for got, want in pairs:
        assert abs(float(want)) > 1e-6
        assert _rel(got, want) < LOSS_RTOL, (name, float(got), float(want))


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def _dis_stats(dis) -> dict:
    """The JAX discriminator's spectral-norm stats holding the port's u."""
    sd = dis.state_dict()
    return {f"SpectralNorm_{j}": {
        f"conv_{i}/kernel/u": jnp.asarray(sd[f"conv.{i}.weight_u"].numpy()
                                          [None]),
        f"conv_{i}/kernel/sigma": jnp.ones(())}
        for j, i in enumerate(SN_CONVS)}


@pytest.mark.parametrize("kd,use_sigmoid", [(3, False), (3, True),
                                            (1, False), (1, True)])
def test_discriminator_matches_jax(kd, use_sigmoid):
    """The T-PatchGAN (kd 3) and its 2-D form (kd 1), with and without the
    sigmoid: outputs within 1e-5 of their scale of flax's, with
    update_stats off and on, each stored u after the update within 1e-5 of
    flax's; the state dict carried back from the flax tree and stats
    equals the port's, but for each v, which is the next power step's from
    the stored u (within 1e-6)."""
    dis = seeded_init_(Discriminator(kd=kd, use_sigmoid=use_sigmoid), 3,
                       fan_in_scaled=True)
    params = convert_discriminator_state_dict(_sd(dis))
    stats = _dis_stats(dis)
    back = discriminator_state_dict_from_flax(Discriminator(kd=kd), params,
                                              stats)
    sd = dis.state_dict()
    for k, v in sd.items():
        if k.endswith("_v"):
            v = sd[k[:-2] + "_orig"].flatten(1).t() @ sd[k[:-2] + "_u"]
            v = v / v.norm()
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6 if k.endswith("_v") else 0)
    jdis = JaxDiscriminator(kd=kd, use_sigmoid=use_sigmoid)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 5, H, W, 3)).astype(
        np.float32)
    want0 = jdis.apply({"params": params, "batch_stats": stats}, _j(x),
                       update_stats=False)
    want1, new = jdis.apply({"params": params, "batch_stats": stats}, _j(x),
                            update_stats=True, mutable=["batch_stats"])
    with torch.no_grad():
        got0 = dis(_t(x), update_stats=False)
        u0 = dis.state_dict()["conv.0.weight_u"].clone()
        got1 = dis(_t(x), update_stats=True)
    assert got0.shape == want0.shape
    assert _scaled_err(got0, want0) < 1e-5
    assert _scaled_err(got1, want1) < 1e-5
    assert not torch.equal(u0, dis.state_dict()["conv.0.weight_u"])
    for j, i in enumerate(SN_CONVS):
        u = np.asarray(new["batch_stats"][f"SpectralNorm_{j}"]
                       [f"conv_{i}/kernel/u"])[0]
        np.testing.assert_allclose(dis.state_dict()[f"conv.{i}.weight_u"],
                                   u, rtol=0, atol=1e-5)


def test_vgg_and_lpips_match_jax(vgg_pair):
    """VGG19 features (ImageNet- and range-normalised inputs) and LPIPS
    distances within 1e-5 of their scale of the JAX modules'; the state
    dicts carried back from the flax trees equal the port's, and the
    released layout (an lpips checkpoint beside a torchvision vgg16) loads
    strictly."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    with torch.no_grad():
        got = vgg_pair["vgg"](_t(x))
        dist = vgg_pair["lpips"](_t(x), _t(y))
    want = vgg_pair["jvgg"](_j(x))
    assert set(got) == set(want) == {"relu1_2", "relu3_4", "conv5_4"}
    for k in got:
        assert _scaled_err(got[k], want[k]) < 1e-5, k
    assert _scaled_err(dist, vgg_pair["jlpips"](_j(x), _j(y))) < 1e-5
    for module, tree, fn in (
            (vgg_pair["vgg"], vgg_pair["vgg_tree"], vgg_state_dict_from_flax),
            (vgg_pair["lpips"], vgg_pair["lpips_tree"],
             lpips_state_dict_from_flax)):
        back = fn(module, tree)
        assert back.keys() == module.state_dict().keys()
        for k, v in module.state_dict().items():
            assert torch.equal(back[k], v), k
    sd = vgg_pair["lpips"].state_dict()
    released = lpips_state_dict(
        {f"lins.{k[3]}.model.1.weight": v for k, v in sd.items()
         if k.startswith("lin")},
        {k[len("net."):]: v for k, v in sd.items() if k.startswith("net.")})
    LPIPSVgg().load_state_dict(released, strict=True)


def _flowcomp(seed=2, remat=False):
    return seeded_init_(RecurrentFlowCompleteNet(remat=remat), seed,
                        fan_in_scaled=True)


def test_flow_completion_train_form_matches_jax():
    """`forward_bidirect_flow(..., train=True)`: both directions' flows and
    edges within 1e-5 of their scale of the JAX module's; with train False
    the same flows and no edges."""
    fc = _flowcomp()
    tree = convert_flowcomp_state_dict(_sd(fc))
    rng = np.random.default_rng(6)
    flows = [rng.normal(0, 2, (2, L_T, H, W, 2)).astype(np.float32)
             for _ in range(2)]
    masks = _masks((2, L_T + 1, H, W, 1))
    jfc = JaxFlowComplete()
    apply = lambda mf, mk, train: jfc.apply({"params": tree}, mf, mk, train)
    wf, we = jax.jit(lambda f, m: jax_forward_bidirect_flow(
        apply, f, m, train=True))([_j(f) for f in flows], _j(masks))
    with torch.no_grad():
        gf, ge = forward_bidirect_flow(fc, [_t(f) for f in flows],
                                       _t(masks), train=True)
        gf0, ge0 = forward_bidirect_flow(fc, [_t(f) for f in flows],
                                         _t(masks))
    assert ge0 == [None, None]
    for g, g0, w in zip(gf, gf0, wf):
        assert torch.equal(g, g0)
        assert _scaled_err(g, w) < 1e-5
    for g, w in zip(ge, we):
        assert g.shape == (2, L_T, H, W, 1)
        assert _scaled_err(g, w) < 1e-5


def _generator(seed=1):
    return seeded_init_(InpaintGenerator(hidden=128, depths=2, remat=True),
                        seed, fan_in_scaled=True)


def _gen_inputs(rng):
    frames = _smooth(rng, (B, T, H, W, 3))
    masks = _masks((B, T, H, W, 1))
    flows = [rng.normal(0, 1, (B, L_T - 1, H, W, 2)).astype(np.float32)
             for _ in range(2)]
    return frames, masks, flows


def test_generator_train_form_matches_jax():
    """`InpaintGenerator.forward(..., train=True)` at depths 2, hidden 128
    under 'flash' (run as 'xla') and remat: all T frames within 1e-5 of
    their scale of the JAX module's 'xla' train forward. (Its parameter
    gradients are the ProPainter step's, compared below.) The inference
    form still decodes the l_t local frames only."""
    gen = _generator()
    tree = convert_inpaint_state_dict(_sd(gen))
    frames, masks, flows = _gen_inputs(np.random.default_rng(7))
    updated = masks * 0.5
    jgen = JaxGenerator(hidden=128, depths=2, remat=True)
    want = jax.jit(lambda p, *a: jgen.apply({"params": p}, *a, L_T,
                                            train=True))(
        tree, _j(frames), tuple(_j(f) for f in flows), _j(masks),
        _j(updated))
    args = (_t(frames), tuple(_t(f) for f in flows), _t(masks), _t(updated),
            L_T)
    got = gen(*args, train=True)
    assert got.shape == (B, T, H, W, 3)
    assert _scaled_err(got.detach(), want) < 1e-5
    with torch.no_grad():
        assert gen(*args).shape == (B, L_T, H, W, 3)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _grad_recorder():
    """An optax transformation whose state is the last gradient and whose
    updates are zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _compare_grads(module, jax_grads, convert):
    """Every parameter's gradient within GRAD_TOL of its tensor's largest
    magnitude, or of 1e-4 of the model's largest gradient where that is
    more: a gradient that is 0 in exact arithmetic is rounding noise in
    both, 1e-9 of the largest (the attention's key biases, which shift
    all logits of a query alike, and the last conv's bias under the hinge
    loss while every logit lies in (-1, 1)). Returns the worst ratio."""
    got = convert({k: p.grad if p.grad is not None else torch.zeros_like(p)
                   for k, p in module.named_parameters()})
    pairs = []

    def walk(g, w, path):
        if isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        pairs.append((np.asarray(g), np.asarray(w), path))

    walk(got, jax_grads, "")
    floor = 1e-4 * max(np.abs(w).max() for _, w, _ in pairs)
    worst = [(float(np.abs(g - w).max() / max(np.abs(w).max(), floor)), p)
             for g, w, p in pairs]
    bad = [(e, p) for e, p in worst if e > GRAD_TOL]
    assert not bad, bad[:10]
    return max(worst)[0]


def _step_batch(rng):
    frames, masks, flows = _gen_inputs(rng)
    return dict(frames=frames, masks=masks, flows_f=flows[0],
                flows_b=flows[1])


@pytest.mark.parametrize("gan_type,dis_2d", [("hinge", False),
                                             ("lsgan", True)])
def test_propainter_step_matches_jax(gan_type, dis_2d):
    """One ProPainter GAN step (precomputed flows, frozen flow completion,
    image propagation, generator at depths 2, discriminator) against the
    jitted JAX step: every loss within 1e-5 relative, every generator and
    discriminator gradient within 1e-4 of its tensor's largest magnitude,
    the spectral-norm u after the real and fake passes within 1e-5, and
    the optimizers stepped once."""
    cfg = TT.PropainterTrainConfig(num_local_frames=L_T, gan_type=gan_type,
                                   dis_2d=dis_2d)
    gen, fc = _generator(), _flowcomp()
    state = TT.init_propainter_state(cfg, None, fc, gen=gen, device="cpu")
    dis = seeded_init_(state.dis, 3, fan_in_scaled=True)
    assert dis.use_sigmoid == (gan_type != "hinge")
    batch = _step_batch(np.random.default_rng(8))

    rec = _grad_recorder()
    gen_tree = convert_inpaint_state_dict(_sd(gen))
    dis_tree = convert_discriminator_state_dict(_sd(dis))
    jstate = JT.PropainterTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen_tree,
        gen_opt=rec.init(gen_tree), dis_params=dis_tree,
        dis_stats=_dis_stats(dis), dis_opt=rec.init(dis_tree),
        raft_params=None,
        flowcomp_params=convert_flowcomp_state_dict(_sd(fc)))
    jstep = jax.jit(JT.make_propainter_train_step(
        JT.PropainterTrainConfig(num_local_frames=L_T, gan_type=gan_type,
                                 dis_2d=dis_2d),
        rec, rec, use_precomputed_flows=True,
        gen=JaxGenerator(hidden=128, depths=2, remat=True)))
    jnew, jm, jviz = jax.block_until_ready(
        jstep(jstate, {k: _j(v) for k, v in batch.items()}))

    step = TT.make_propainter_train_step(cfg, use_precomputed_flows=True)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    state, metrics, viz = step(state, {k: _t(v) for k, v in batch.items()})
    assert state.step == 1
    assert metrics.keys() == jm.keys() == {
        "hole_loss", "valid_loss", "gan_loss", "gen_loss", "dis_loss"}
    for k in metrics:
        assert _rel(metrics[k], jm[k]) < LOSS_RTOL, (k, float(metrics[k]),
                                                     float(jm[k]))
    _compare_grads(gen, jnew.gen_opt, convert_inpaint_state_dict)
    _compare_grads(dis, jnew.dis_opt, convert_discriminator_state_dict)
    for j, i in enumerate(SN_CONVS):
        u = np.asarray(jnew.dis_stats[f"SpectralNorm_{j}"]
                       [f"conv_{i}/kernel/u"])[0]
        np.testing.assert_allclose(dis.state_dict()[f"conv.{i}.weight_u"],
                                   u, rtol=0, atol=1e-5)
    assert viz.keys() == jviz.keys()
    for k in viz:
        assert _scaled_err(viz[k], jviz[k]) < 1e-5, k
    # Adam's first update with beta1 0 moves each parameter by lr * g /
    # (|g| + eps): by lr wherever the gradient is well above eps
    p = dict(gen.named_parameters())["decoder.6.bias"]
    moved = (p.detach() - before["decoder.6.bias"]).abs()
    assert torch.allclose(moved[p.grad.abs() > 1e-6], torch.tensor(cfg.lr),
                          rtol=1e-3)


def _flow_batch(rng):
    """Frames, masks and smooth flows with a moving block (flow magnitudes
    above 1, so the Canny targets hold edges)."""
    frames = _smooth(rng, (2, L_T + 1, H, W, 3))
    masks = _masks((2, L_T + 1, H, W, 1))
    flows = np.zeros((2, L_T, H, W, 2), np.float32)
    flows[..., 0] = 0.5
    flows[:, :, 6:22, 12:34] = (3.0, -2.0)
    flows += rng.normal(0, 0.05, flows.shape).astype(np.float32)
    return dict(frames=frames, masks=masks, flows_f=flows,
                flows_b=-flows[:, ::-1].copy())


def test_flow_step_matches_jax():
    """One flow completion step (precomputed flows, Canny targets, both
    directions with the edge head, remat) against the jitted JAX step:
    every loss within 1e-5 relative, every gradient within 1e-4 of its
    tensor's largest magnitude. The edge loss (and the total, which holds
    it) is held to its float64 value on the step's own predictions: the
    port within 1e-5, the JAX step within 5e-5, its fp32 sum of the 9216
    combined-edge BCE terms being 2.7e-5 off that value here (the port's
    1.6e-7)."""
    cfg = TT.FlowTrainConfig(num_local_frames=L_T + 1)
    fc = _flowcomp(remat=True)
    tree = convert_flowcomp_state_dict(_sd(fc))
    fc_before = _flowcomp()
    fc_before.load_state_dict(fc.state_dict())
    state = TT.init_flow_state(cfg, None, model=fc, device="cpu")
    batch = _flow_batch(np.random.default_rng(9))
    rec = _grad_recorder()
    jstate = JT.FlowTrainState(step=jnp.zeros((), jnp.int32), params=tree,
                               opt=rec.init(tree), raft_params=None)
    jstep = jax.jit(JT.make_flow_train_step(
        JT.FlowTrainConfig(num_local_frames=L_T + 1), rec,
        use_precomputed_flows=True))
    jnew, jm, jviz = jax.block_until_ready(
        jstep(jstate, {k: _j(v) for k, v in batch.items()}))
    state, metrics, viz = step_out = TT.make_flow_train_step(
        cfg, use_precomputed_flows=True)(
            state, {k: _t(v) for k, v in batch.items()})
    assert metrics.keys() == jm.keys() == {"flow_loss", "warp_loss",
                                           "edge_loss", "loss"}
    for k in ("flow_loss", "warp_loss"):
        assert _rel(metrics[k], jm[k]) < LOSS_RTOL, (k, float(metrics[k]),
                                                     float(jm[k]))
    with torch.no_grad():
        gt = [_t(batch["flows_f"]), _t(batch["flows_b"])]
        masks = _t(batch["masks"][:, :L_T + 1])
        _, edges = forward_bidirect_flow(fc_before, gt, masks, train=True)
        exact = TL.edge_loss([e.double() for e in edges],
                             [TT.flow_edges(f).double() for f in gt],
                             masks.double()).item()
    exact_total = (float(metrics["loss"]) - cfg.edge_weight
                   * float(metrics["edge_loss"]) + cfg.edge_weight * exact)
    for k, want in (("edge_loss", exact), ("loss", exact_total)):
        assert _rel(metrics[k], want) < LOSS_RTOL, (k, float(metrics[k]),
                                                    want)
        assert _rel(jm[k], want) < 5 * LOSS_RTOL, (k, float(jm[k]), want)
    _compare_grads(fc, jnew.opt, convert_flowcomp_state_dict)
    assert viz["pred_edge_f"].shape == (2, L_T, H, W, 1)
    for k in viz:
        assert _scaled_err(viz[k], jviz[k]) < 1e-5, k
    assert len(step_out) == 3 and state.step == 1


def test_flow_edges_match_jax():
    """The flow step's Canny targets (`flow_edges`) equal the JAX step's
    `get_edges` (read from its loss: an all-zero target gives edge_bce 0)
    on flows with a moving block, and are empty below a peak of 1."""
    flows = _flow_batch(np.random.default_rng(10))["flows_f"]
    edges = TT.flow_edges(_t(flows)).numpy()
    f = flows.reshape(-1, H, W, 2)
    mag = np.sqrt((f ** 2).sum(-1, keepdims=True))
    want = np.asarray(jax_canny(_j(mag / mag.max()), sigma=2.0))
    np.testing.assert_array_equal(edges.reshape(want.shape), want)
    assert edges.any()
    assert not TT.flow_edges(_t(flows * 0.01)).any()


# ---------------------------------------------------------------------------
# Optimizer and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheduler", ["multistep", "cosine"])
def test_optimizer_matches_optax(scheduler):
    """`make_optimizer` (Adam(0, 0.99) stepped with its LambdaLR) against
    optax.adam under the JAX schedule over 7 updates that cross the
    schedule's boundaries: the parameters within 1e-6 relative; the
    schedules' values at counts 0-12 within 1e-6 relative."""
    lr, milestones = 1e-2, {2: 0.5, 4: 0.1}
    periods, weights = [3, 5], [1.0, 0.5]
    if scheduler == "cosine":
        want_sched = JT.cosine_annealing_restart_lr(lr, periods, weights)
        got_sched = TT.cosine_annealing_restart_lr(lr, periods, weights)
    else:
        want_sched = JT.multistep_lr(lr, milestones)
        got_sched = TT.multistep_lr(lr, milestones)
    for c in range(13):
        assert _rel(got_sched(c), want_sched(c)) < 1e-6, c
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = rng.standard_normal((7, 3, 5)).astype(np.float32)
    tx = JT.make_optimizer(lr, milestones, scheduler=scheduler,
                           periods=periods, restart_weights=weights)
    jp, js = _j(p0), None
    js = tx.init(jp)
    p = torch.nn.Parameter(_t(p0.copy()))
    opt, sched = TT.make_optimizer([p], lr, milestones, scheduler=scheduler,
                                   periods=periods, restart_weights=weights)
    for g in grads:
        upd, js = tx.update(_j(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = _t(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def _train_state(seed):
    cfg = TT.PropainterTrainConfig(num_local_frames=L_T)
    torch.manual_seed(seed)
    gen = InpaintGenerator(hidden=128, depths=1, remat=True)
    return TT.init_propainter_state(cfg, None, _flowcomp(), gen=gen,
                                    device="cpu"), cfg


def test_train_checkpoint_round_trip(tmp_path):
    """`TrainCheckpointManager` saves a state after a step in the
    reference's gen/dis/opt layout with latest.ckpt, and restores it into a
    fresh state: the step, every parameter and buffer (the spectral-norm u
    and v among them), both optimizers' and schedulers' states; the next
    step from either state is the same; max_to_keep drops old steps."""
    state, cfg = _train_state(0)
    step = TT.make_propainter_train_step(cfg, use_precomputed_flows=True)
    batch = {k: _t(v) for k, v in _step_batch(np.random.default_rng(12))
             .items()}
    state = step(state, batch)[0]
    mgr = TrainCheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(state) is None
    mgr.save(1, state)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "dis_000001.pth", "gen_000001.pth", "latest.ckpt", "opt_000001.pth"]
    opt = torch.load(tmp_path / "ckpt" / "opt_000001.pth")
    assert set(opt) == {"optimG", "optimD", "scheG", "scheD", "iteration"}
    fresh, _ = _train_state(1)
    assert mgr.restore(fresh) is fresh and fresh.step == 1
    for a, b in ((state.gen, fresh.gen), (state.dis, fresh.dis)):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k
    for a, b in ((state.gen_opt, fresh.gen_opt),
                 (state.dis_sched, fresh.dis_sched)):
        assert str(a.state_dict()) == str(b.state_dict())
    _, m1, _ = step(state, batch)
    _, m2, _ = step(fresh, batch)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for n in (2, 3):
        mgr.save(n, state)
    assert mgr.latest_step() == 3 and mgr.steps() == [2, 3]


# ---------------------------------------------------------------------------
# Copies of the JAX package's jax-free helpers
# ---------------------------------------------------------------------------


COPIES = [(jax_masks, torch_masks, n) for n in (
    "_cubic_bezier", "get_random_shape", "get_random_velocity",
    "random_accelerate", "random_move_control_points",
    "create_random_shape_with_random_motion")]
COPIES += [(jax_dataset, torch_dataset, n) for n in (
    "TrainDatasetConfig", "TrainDataset", "PrefetchLoader")]
COPIES += [(jax_tb, torch_tb, "MetricLogger")]


@pytest.mark.parametrize("mod_j,mod_t,name", COPIES,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{n}"
                              for m, _, n in COPIES])
def test_copies_match_the_jax_package(mod_j, mod_t, name):
    assert (inspect.getsource(getattr(mod_t, name))
            == inspect.getsource(getattr(mod_j, name)))


def test_train_dataset_items_equal_the_jax_dataset(tmp_path):
    """`TrainDataset` items (synthesised masks, sampled frames, reversal
    and flip) equal the JAX dataset's from the same seeds, and the
    prefetching loader stacks them into batches."""
    import cv2

    rng = np.random.default_rng(13)
    names = {}
    for v in ("a", "b"):
        (tmp_path / v).mkdir()
        for i in range(9):
            cv2.imwrite(str(tmp_path / v / f"{i:05d}.jpg"),
                        rng.integers(0, 255, (40, 56, 3), np.uint8))
        names[v] = 9
    (tmp_path / "train.json").write_text(json.dumps(names))
    kw = dict(video_root=str(tmp_path), json_path=str(tmp_path / "train.json"),
              num_local_frames=L_T, num_ref_frames=2, w=W, h=H)
    ds_t = torch_dataset.TrainDataset(torch_dataset.TrainDatasetConfig(**kw))
    ds_j = jax_dataset.TrainDataset(jax_dataset.TrainDatasetConfig(**kw))
    for index in range(4):
        items = []
        for ds in (ds_t, ds_j):
            random.seed(index)
            np.random.seed(index)
            items.append(ds[index])
        assert items[0].keys() == {"frames", "masks"}
        for k in items[0]:
            np.testing.assert_array_equal(items[0][k], items[1][k])
    assert items[0]["frames"].shape == (L_T + 2, H, W, 3)
    loader = torch_dataset.PrefetchLoader(ds_t, 2, num_workers=1)
    try:
        batch = loader.next()
    finally:
        loader.stop()
    assert batch["frames"].shape == (2, L_T + 2, H, W, 3)
    assert batch["masks"].shape == (2, L_T + 2, H, W, 1)
