"""The demo's second part in the port (`propainter_tpu_torch.demo.tracking`,
`.app`) on the CPU: `FlowMaskTracker` against the JAX tracker on
tests/test_demo.py's moving-square clip with one set of seeded RAFT
weights carried across (and on a given flow, without RAFT);
`CutieTracker`'s id-label round trip against the JAX tracker's mapping on
tests/test_torch_cutie.py's small Cutie; the facade's choice among SAM,
Cutie and the stand-ins; a gradio-free composition and `TwoStepSession`
on the real facade with a tiny pipeline; `load_demo_models` on seeded
.pth files; `app.main` stopping at its gradio guard; the copied code
pinned by source; no JAX import; no silent fall-back to the CPU.
"""

import inspect
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu.demo import tracking as jax_tracking
from propainter_tpu.demo.cutie_core import (
    CutieCore as JaxCutieCore, CutieCoreConfig as JaxCoreConfig)
from propainter_tpu.models.raft import RAFT as JaxRAFT
from tests.test_demo import _scene
from tests.test_torch_cutie import JAX_SMALL, cutie_pair
from tests.test_torch_models import _fill
from tests.test_torch_sam import TINY

from propainter_tpu_torch.demo import (
    ClickSegmenter, CutieTracker, FlowMaskTracker, SamControler,
    SamSegmenter, TrackingFacade, TwoStepSession, load_demo_models)
from propainter_tpu_torch.demo import app as torch_app
from propainter_tpu_torch.demo import tracking as torch_tracking
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.models.sam import Sam
from propainter_tpu_torch.utils.masks import binary_dilation_cross
from propainter_tpu_torch.weights import (
    RAFT_RENAMES, seeded_init_, state_dict_from_flax)

H, W = 64, 96
RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch intra-op thread for the file, its module-scoped fixtures
    included (an autouse fixture is set up before the others of its
    scope): the suite runs this file beside other pytest-xdist workers,
    and PyTorch's default of one OpenMP thread per core in every worker
    oversubscribes the host (these tests took 20x their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _template():
    m = np.zeros((H, W), np.uint8)
    m[20:40, 20:40] = 1
    return m


@pytest.fixture(scope="module")
def raft_weights():
    """(JAX RAFT params, the port's state dict) of one seeded RAFT."""
    tree = _fill(jax.eval_shape(lambda: JaxRAFT().init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, H, W, 3)), iters=1))["params"], 21)
    return tree, state_dict_from_flax(RAFT(), tree, RAFT_RENAMES)


def _track(tracker, frames):
    out = [tracker.track(frames[0], _template())]
    return out + [tracker.track(f) for f in frames[1:]]


def test_flow_tracker_matches_jax(raft_weights):
    """RAFT's pair flows (a -> b and b -> a in one call of batch 2) within
    1e-4 of scale, the gated soft masks within 1e-4, the tracked masks
    (threshold, closing, GrabCut re-anchor) equal, over 4 frames of a
    square moving 2 px a frame, at raft_iter 2."""
    tree, sd = raft_weights
    frames = [_scene(t) for t in range(4)]
    jt = jax_tracking.FlowMaskTracker(tree, raft_iter=2)
    tt = FlowMaskTracker(sd, raft_iter=2, device="cpu")
    jf = jt._pair_flows(frames[1], frames[0])
    tf = tt._pair_flows(frames[1], frames[0])
    for j, t in zip(jf, tf):
        assert t.shape == (H, W, 2)
        np.testing.assert_allclose(t, j, rtol=RTOL,
                                   atol=RTOL * np.abs(j).max())
    for i, (j, t) in enumerate(zip(_track(jt, frames), _track(tt, frames))):
        assert t[0].dtype == np.uint8 and t[1].dtype == np.float32
        assert 0 < t[0].sum() < t[0].size, f"frame {i}"
        np.testing.assert_array_equal(t[0], j[0], err_msg=f"frame {i}")
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=RTOL,
                                   err_msg=f"frame {i}")
        np.testing.assert_array_equal(t[2], j[2])


def test_flow_tracker_pads_frames_for_raft(raft_weights):
    """At a width that is not a multiple of 8 (90; DAVIS's 854) the port
    pads the frames for RAFT and crops the flows: the flows equal those
    of the frames padded by hand, the masks keep the frame's size. The
    JAX tracker cannot run there: RAFT's flow comes back 96 wide and the
    warp of the 90-wide mask fails."""
    tree, sd = raft_weights
    frames = [_scene(t)[:, :90] for t in range(3)]
    tt = FlowMaskTracker(sd, raft_iter=2, device="cpu")
    out = [tt.track(frames[0], _template()[:, :90])]
    out += [tt.track(f) for f in frames[1:]]
    assert all(m.shape == (H, 90) and l.shape == (H, 90) for m, l, _ in out)
    fa, fb = tt._pair_flows(frames[1], frames[0])
    padded = [np.pad(f, ((0, 0), (0, 6), (0, 0)), mode="edge")
              for f in frames[:2]]
    ga, gb = tt._pair_flows(*padded[::-1])
    np.testing.assert_array_equal(fa, ga[:, :90])
    np.testing.assert_array_equal(fb, gb[:, :90])
    jt = jax_tracking.FlowMaskTracker(tree, raft_iter=2)
    jt.track(frames[0], _template()[:, :90])
    with pytest.raises(Exception):
        jt.track(frames[1])


@pytest.mark.parametrize("reanchor", [True, False],
                         ids=["reanchor", "flow_only"])
def test_flow_tracker_on_given_flow_matches_jax(reanchor):
    """With `flow_fn` (no RAFT): a shift of 2 px a frame with a
    disoccluded band, so the forward-backward gate is partly open; the
    soft and hard masks equal the JAX tracker's, with and without the
    GrabCut re-anchor."""
    def flow_fn(a, b):
        f = np.zeros((H, W, 2), np.float32)
        f[..., 0] = -2.0 if a.sum() >= b.sum() else 2.0
        f[:, :30, 0] *= 3
        return f

    frames = [_scene(t) for t in range(4)]
    jt = jax_tracking.FlowMaskTracker(flow_fn=flow_fn, raft_iter=2,
                                      reanchor=reanchor)
    tt = FlowMaskTracker(flow_fn=flow_fn, raft_iter=2, reanchor=reanchor,
                         device="cpu")
    for j, t in zip(_track(jt, frames), _track(tt, frames)):
        assert 0 < t[0].sum() < t[0].size
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=RTOL)
    tt.clear_memory()
    assert tt._mask is None and tt._prev_frame is None


def test_cutie_tracker_labels_round_trip():
    """Id labels {0, 3, 7} in, the same ids out: the port's CutieTracker
    against the JAX tracker's mapping over the JAX CutieCore of the same
    small Cutie; the masks equal wherever the winning probability leads
    by more than 1e-4, and neither empty nor full."""
    tree, net = cutie_pair(seed=13)
    core = dict(mem_every=2, max_mem_frames=3, top_k=8)
    tt = CutieTracker(net, device="cpu", **core)
    jt = jax_tracking.CutieTracker.__new__(jax_tracking.CutieTracker)
    jt._core = JaxCutieCore(tree, model_config=JAX_SMALL,
                            config=JaxCoreConfig(**core))
    jt._labels = None
    rng = np.random.default_rng(12)
    y, x = np.mgrid[0:H, 0:W]
    frames = [np.clip(128 + 60 * np.sin((x + 2 * t) / 6.0)[..., None]
                      * np.cos(y / 9.0)[..., None] * np.ones(3)
                      + rng.uniform(-20, 20, (H, W, 3)), 0,
                      255).astype(np.uint8) for t in range(4)]
    ann = np.zeros((H, W), np.uint8)
    ann[8:30, 10:40] = 3
    ann[34:58, 50:88] = 7
    probs = []
    step = tt._core.step
    tt._core.step = lambda *a: probs.append(step(*a)) or probs[-1]
    for i, f in enumerate(frames):
        a = ann if i == 0 else None
        tm, tl, tp = tt.track(f, a)
        jm, jl, _ = jt.track(f, a)
        assert tm.dtype == np.uint8 and tp.shape == f.shape
        assert set(np.unique(tm)) <= {0, 3, 7}
        assert 0 < (tm > 0).sum() < tm.size, f"frame {i}"
        np.testing.assert_allclose(tl, jl, rtol=0, atol=RTOL)
        top2 = np.sort(probs[-1], axis=0)[-2:]
        sure = top2[1] - top2[0] > RTOL
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(tm[sure], jm[sure])
    assert tt._labels == [3, 7]
    tt.clear_memory()
    assert tt._labels is None and not tt._core.engaged


def _tiny_models(seed: int = 0) -> dict:
    """RAFT, the flow completion and a generator at hidden 128, depth 2,
    seeded (fan-in scaled)."""
    mods = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
            "inpaint": InpaintGenerator(hidden=128, depths=2)}
    for i, m in enumerate(mods.values()):
        seeded_init_(m, seed + i, fan_in_scaled=True)
    return mods


@pytest.fixture(scope="module")
def tiny_models():
    return _tiny_models()


def test_facade_picks_sam_cutie_or_the_stand_ins(tiny_models):
    """Without 'sam' and 'cutie' the facade runs GrabCut and the flow
    tracker (on the models' RAFT); with them SAM's controller and Cutie;
    given ones are kept; the inpainter is ProInpainter on the models."""
    f = TrackingFacade(tiny_models, precision="fp32", device="cpu")
    assert isinstance(f.segmenter, ClickSegmenter)
    assert isinstance(f.tracker, FlowMaskTracker)
    for k, v in f.tracker.raft.state_dict().items():
        assert torch.equal(v, tiny_models["raft"].state_dict()[k])
    assert f.inpainter.models is tiny_models
    assert f.inpainter.precision == "fp32"
    _, cutie = cutie_pair(seed=13)
    sam = Sam(TINY).eval()
    f = TrackingFacade(dict(tiny_models, sam=sam, cutie=cutie),
                       device="cpu")
    assert isinstance(f.segmenter, SamControler)
    assert f.segmenter.sam_controler.model is sam
    assert isinstance(f.tracker, CutieTracker)
    assert f.tracker._core.model is cutie
    seg, trk = ClickSegmenter(), object()
    f = TrackingFacade(dict(tiny_models, sam=sam), segmenter=seg,
                       tracker=trk, device="cpu")
    assert f.segmenter is seg and f.tracker is trk


def _clip(T: int = 6):
    """The moving square on a texture (the pipeline needs some)."""
    rng = np.random.default_rng(14)
    tex = rng.integers(0, 60, (H, W, 3)).astype(np.uint8)
    return [np.maximum(_scene(t), tex) for t in range(T)]


def _square_flow(a, b):
    """The clip's true flow a -> b: the square's shift (a random RAFT's
    flow loses the mask within a few frames)."""
    def x0(img):
        return int(np.argmax(img[30, :, 0] == 220))

    f = np.zeros((H, W, 2), np.float32)
    f[..., 0] = x0(b) - x0(a)
    return f


def _facade(models):
    """The facade on the tiny pipeline in fp32, its flow tracker on the
    clip's true flow."""
    return TrackingFacade(
        models, tracker=FlowMaskTracker(flow_fn=_square_flow, device="cpu"),
        precision="fp32", device="cpu")


INPAINT_KW = dict(raft_iter=2, neighbor_length=4, ref_stride=4,
                  subvideo_length=10, dilate_radius=2)


def _outside_unchanged(out, frames, masks, dilate_radius):
    """The pipeline's compositing keeps every pixel outside the dilated
    mask as it was (reference inference_propainter.py:407-452)."""
    for t, (o, f, m) in enumerate(zip(out, frames, masks)):
        keep = binary_dilation_cross(np.asarray(m) > 0, dilate_radius) == 0
        np.testing.assert_array_equal(o[keep], f[keep], err_msg=f"frame {t}")
        assert (o[~keep] != f[~keep]).any()


def test_facade_click_track_inpaint_without_gradio(tiny_models):
    """The demo's flow on the real facade with GrabCut, the flow tracker
    (on the true flow) and a tiny fp32 pipeline: a click, the track, the inpaint; the output
    keeps the frame outside the dilated masks."""
    facade = _facade(tiny_models)
    frames = _clip()
    mask, logit, painted = facade.first_frame_click(
        frames[0], np.array([[30, 30]]), np.array([1]))
    assert mask[30, 30] == 1 and 0 < mask.sum() < mask.size
    masks, logits, painted = facade.generator(frames, mask)
    assert len(masks) == len(frames) and all(m.sum() for m in masks)
    out = facade.inpaint(np.stack(frames), np.stack(masks), **INPAINT_KW)
    assert out.shape == (len(frames), H, W, 3) and out.dtype == np.uint8
    _outside_unchanged(out, frames, masks, INPAINT_KW["dilate_radius"])


def test_two_step_session_on_the_real_facade(tiny_models):
    """TwoStepSession (the app's Track, then Inpaint) on the port's
    facade with Cutie (ids kept; the flow tracker tracks one binary
    mask): two added masks tracked from frame 1 to 5, the preview painted
    there, the inpaint of mask 2 alone on the full video with the app's
    keyword arguments."""
    _, cutie = cutie_pair(seed=13)
    facade = TrackingFacade(
        tiny_models, tracker=CutieTracker(cutie, device="cpu", mem_every=2,
                                          max_mem_frames=3, top_k=8),
        precision="fp32", device="cpu")
    frames = _clip()
    s = TwoStepSession(facade)
    s.reset(frames)
    m1 = np.zeros((H, W), np.uint8)
    m1[20:40, 22:42] = 1
    m2 = np.zeros((H, W), np.uint8)
    m2[44:56, 60:80] = 1
    s.multi.add_mask(m1)
    s.multi.add_mask(m2)
    painted = s.track(["mask_001", "mask_002"], select_frame=1, track_end=5)
    assert len(painted) == len(frames)
    np.testing.assert_array_equal(painted[0], frames[0])
    assert (painted[2] != frames[2]).any()
    assert s.masks[0] is None and s.masks[5] is None
    assert set(np.unique(s.masks[1])) == {0, 1, 2}
    out = s.inpaint(["mask_002"], ratio=1.0, **INPAINT_KW)
    assert out.shape == (len(frames), H, W, 3)
    sent = [np.where(m == 2, 1, 0) if m is not None
            else np.zeros((H, W), np.uint8) for m in s.masks]
    _outside_unchanged(out[1:5], frames[1:5], sent[1:5],
                       INPAINT_KW["dilate_radius"])
    np.testing.assert_array_equal(out[0], frames[0])


def _seeded_file(path, state: dict, seed: int):
    """A .pth of `state`'s keys and shapes, each tensor a seeded value
    broadcast to its shape (a stride-0 view: the file stays small)."""
    gen = torch.Generator().manual_seed(seed)
    torch.save({k: (torch.randn(1, generator=gen).to(v.dtype)
                    if v.is_floating_point() else torch.zeros(1, dtype=v.dtype)
                    ).reshape((1,) * v.dim()).expand(v.shape)
                for k, v in state.items()}, path)


def test_load_demo_models_from_seeded_files(tmp_path):
    """The three ProPainter checkpoints by `cli.inference`'s names, Cutie
    (with the release's extra keys, dropped) and SAM vit_b (its type from
    the file name) load strictly; 'random' and a directory without the
    demo's files give the ProPainter models alone."""
    from propainter_tpu_torch.cli.inference import CHECKPOINTS
    from propainter_tpu_torch.models.cutie import CUTIE, CutieConfig
    from propainter_tpu_torch.models.sam import sam_config_registry

    with torch.device("meta"):
        shapes = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
                  "inpaint": InpaintGenerator(), "cutie": CUTIE(CutieConfig()),
                  "sam": Sam(sam_config_registry["vit_b"]())}
    names = dict(CHECKPOINTS, cutie="cutie-base-mega.pth",
                 sam="sam_vit_b_01ec64.pth")
    for seed, (k, m) in enumerate(shapes.items()):
        state = m.state_dict()
        if k == "cutie":
            state["pixel_mean"] = torch.zeros(1, 3, 1, 1)
        _seeded_file(tmp_path / names[k], state, seed)
    # RAFT's own (its norm3 / downsample.1 keys alias one tensor)
    torch.save(seeded_init_(RAFT(), 5).state_dict(), tmp_path / names["raft"])
    models, sam_type = load_demo_models(str(tmp_path))
    assert sam_type == "vit_b"
    assert set(models) == {"raft", "flowcomp", "inpaint", "cutie", "sam"}
    raft = torch.load(tmp_path / names["raft"], weights_only=True)
    for k, v in models["raft"].state_dict().items():
        assert torch.equal(v, raft[k])
    assert "pixel_mean" not in models["cutie"]
    assert models["cutie"].keys() == shapes["cutie"].state_dict().keys()
    assert models["sam"].keys() == shapes["sam"].state_dict().keys()
    for f in ("cutie-base-mega.pth", "sam_vit_b_01ec64.pth"):
        (tmp_path / f).unlink()
    models, sam_type = load_demo_models(str(tmp_path))
    assert set(models) == {"raft", "flowcomp", "inpaint"}
    assert sam_type == "vit_h"
    models, _ = load_demo_models("random")
    assert set(models) == {"raft", "flowcomp", "inpaint"}


def test_app_main_stops_at_its_gradio_guard(monkeypatch):
    """Without gradio, `app.main` exits with the gradio-free recipe before
    loading anything."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    monkeypatch.setattr(torch_tracking, "load_demo_models",
                        lambda *a: pytest.fail("loaded past the guard"))
    with pytest.raises(SystemExit, match="gradio is not installed") as e:
        torch_app.main(["--weights", "random", "--device", "cpu"])
    assert "TrackingFacade(models" in str(e.value)
    with pytest.raises(ImportError):
        torch_app.build_app(object())


@pytest.mark.parametrize("name", [
    "ClickSegmenter", "paint_mask", "FlowMaskTracker._grabcut_refine"])
def test_copies_match_the_jax_package(name):
    """The GrabCut segmenter, the painter and the flow tracker's re-anchor
    are the JAX package's, by source."""
    def source(mod):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part)
        return inspect.getsource(obj)

    assert source(torch_tracking) == source(jax_tracking)


def test_new_modules_import_without_jax():
    """Cutie, its engine, the tracking facade and the app import with jax,
    flax and the JAX package unavailable, and pull in none of them."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax",
                     "propainter_tpu"):
            sys.modules[name] = None
        for name in ("propainter_tpu_torch.models.cutie",
                     "propainter_tpu_torch.weights",
                     "propainter_tpu_torch.demo",
                     "propainter_tpu_torch.demo.cutie_core",
                     "propainter_tpu_torch.demo.tracking",
                     "propainter_tpu_torch.demo.app"):
            importlib.import_module(name)
        bad = [n for n in sys.modules
               if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                      "orbax", "propainter_tpu")
               and sys.modules[n] is not None]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_trackers_and_facade_need_a_gpu_unless_told_cpu(tiny_models,
                                                        monkeypatch):
    """Built without device="cpu" on a machine without a GPU, the
    trackers, the facade and a SAM segmenter raise rather than running on
    the CPU."""
    _, cutie = cutie_pair(seed=13)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: FlowMaskTracker(tiny_models["raft"]),
                  lambda: FlowMaskTracker(flow_fn=lambda a, b: None),
                  lambda: CutieTracker(cutie),
                  lambda: TrackingFacade(tiny_models),
                  lambda: SamSegmenter(Sam(TINY))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        TrackingFacade(tiny_models, device="cuda")
    assert FlowMaskTracker(tiny_models["raft"], device="cpu"
                           ).device.type == "cpu"
