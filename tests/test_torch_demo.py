"""The port's demo layer, part 1 (`propainter_tpu_torch.demo`), on the CPU:
`SamSegmenter` / `SamControler` against the JAX package's on the same
48x64 image, clicks and seeded `TINY` SAM weights (tests/test_torch_sam.py);
the copies of the jax-free painters and sessions pinned to the originals by
source, and the sessions run with a stub facade, as tests/test_demo.py runs
the JAX ones; the new modules importing no JAX; and no silent fall-back to
the CPU.
"""

import inspect
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from propainter_tpu.demo import multimask as jax_multimask
from propainter_tpu.demo import painters as jax_painters
from propainter_tpu.demo import session as jax_session
from propainter_tpu.demo.segmenter import (
    SamControler as JaxControler, SamSegmenter as JaxSegmenter)
from tests.test_torch_sam import JAX_TINY, TINY, assert_close, sam_pair

from propainter_tpu_torch.demo import (
    MultiMaskSession, SamControler, SamSegmenter, TwoStepSession)
from propainter_tpu_torch.demo import multimask as torch_multimask
from propainter_tpu_torch.demo import painters as torch_painters
from propainter_tpu_torch.demo import session as torch_session


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


IMAGE = np.random.default_rng(5).integers(0, 255, (48, 64, 3), np.uint8)
CLICKS = np.array([[30.0, 20.0], [50.0, 36.0], [12.0, 40.0]], np.float32)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's state dict) of one seeded TINY SAM."""
    tree, net = sam_pair(seed=5)
    return tree, net.state_dict()


def _segmenters(weights, points_bucket=None):
    tree, sd = weights
    j = JaxSegmenter(tree, config=JAX_TINY, points_bucket=points_bucket)
    t = SamSegmenter(sd, config=TINY, points_bucket=points_bucket,
                     device="cpu")
    j.set_image(IMAGE)
    t.set_image(IMAGE)
    return j, t


@pytest.fixture(scope="module")
def segmenters(weights):
    return _segmenters(weights)


@pytest.mark.parametrize("points_bucket", [None, 8], ids=["exact", "bucket"])
def test_pack_points_matches_jax(weights, points_bucket):
    """n clicks + exactly one not-a-point pad (the reference predictor's
    scheme), or padded up to the bucket; coordinates scaled into the
    model frame of the resized image."""
    j, t = _segmenters(weights, points_bucket)
    assert t.input_size == j.input_size and t.original_size == (48, 64)
    labels = np.array([1, 0, 1], np.int32)
    for n in (0, 1, 3):
        jc, jl = j._pack_points(CLICKS[:n] if n else None,
                                labels[:n] if n else None)
        tc, tl = t._pack_points(CLICKS[:n] if n else None,
                                labels[:n] if n else None)
        assert tc.shape == (1, points_bucket or n + 1, 2)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("mode, multimask", [
    ("point", True), ("point", False), ("both", True), ("both", False)])
def test_predict_matches_jax(segmenters, mode, multimask):
    """Masks equal, scores and low-res logits within 1e-4 of scale, in
    'point' and 'both' (the refine pass's dense prompt: the JAX best
    logits of a point prediction), with three masks or one."""
    j, t = segmenters
    prompts = {"point_coords": CLICKS[:2], "point_labels": np.array([1, 0])}
    if mode == "both":
        _, scores, logits = j.predict(prompts, "point")
        prompts["mask_input"] = logits[np.argmax(scores)][None]
    jm, js, jl = j.predict(prompts, mode, multimask)
    tm, ts, tl = t.predict(prompts, mode, multimask)
    n = 3 if multimask else 1
    g4 = 4 * TINY.grid
    assert tm.shape == (n, 48, 64) and tm.dtype == bool
    assert ts.shape == (n,) and tl.shape == (n, g4, g4)
    assert 0 < tm.sum() < tm.size
    np.testing.assert_array_equal(tm, jm)
    assert_close(ts, js, "scores")
    assert_close(tl, jl, "logits")


@pytest.mark.parametrize("labels, box", [
    ([1, 0, 1], None), ([1, 1, 0], None), ([1], (8, 6, 40, 30))],
    ids=["refine", "last_negative", "box"])
def test_first_frame_click_matches_jax(weights, labels, box):
    """The mask exactly, the full-size logit within 1e-4 of scale and the
    painted preview exactly: with the refine pass (last click positive),
    without it (last click negative), and with a box (corner labels 2 /
    3, no dots)."""
    tree, sd = weights
    labels = np.array(labels, np.int32)
    clicks = CLICKS[:len(labels)]
    jm, jl, jp = JaxControler(JaxSegmenter(
        tree, config=JAX_TINY)).first_frame_click(IMAGE, clicks, labels,
                                                  box=box)
    seg = SamSegmenter(sd, config=TINY, device="cpu")
    tm, tl, tp = SamControler(seg).first_frame_click(IMAGE, clicks, labels,
                                                      box=box)
    assert seg.embedded and tm.shape == (48, 64) and tm.dtype == np.uint8
    assert tl.shape == (48, 64) and tl.dtype == np.float32
    assert 0 < tm.sum() < tm.size
    np.testing.assert_array_equal(tm, jm)
    assert_close(tl, jl, "logit")
    assert tp.shape == IMAGE.shape and (tp != IMAGE).any()
    np.testing.assert_array_equal(tp, jp)


def test_set_image_embeds_once(weights, capsys):
    """A second set_image is a no-op until reset_image, as in the
    reference; predict before set_image asserts."""
    _, sd = weights
    seg = SamSegmenter(sd, config=TINY, device="cpu")
    with pytest.raises(AssertionError):
        seg.predict({"point_coords": CLICKS[:1],
                     "point_labels": np.array([1])}, "point")
    seg.set_image(IMAGE)
    emb = seg._embedding
    seg.set_image(IMAGE[::-1])
    assert seg._embedding is emb
    assert "repeat embedding" in capsys.readouterr().out
    seg.reset_image()
    assert not seg.embedded and seg._embedding is None
    seg.set_image(IMAGE[:40])
    assert seg.original_size == (40, 64)


COPIES = [(jax_painters, torch_painters), (jax_multimask, torch_multimask),
          (jax_session, torch_session)]


@pytest.mark.parametrize("mod_j, mod_t", COPIES,
                         ids=["painters", "multimask", "session"])
def test_copies_match_the_jax_package(mod_j, mod_t):
    """The port's painters, multimask and session modules are the JAX
    package's, but for the package name in their imports."""
    assert (inspect.getsource(mod_t).replace("propainter_tpu_torch.",
                                             "propainter_tpu.")
            == inspect.getsource(mod_j))


def test_multimask_session_add_show_template():
    """Names, the id-labelled template (overlaps to the later id), the
    painted preview and remove_all (reference app.py:166-230)."""
    H, W = 48, 64
    m1 = np.zeros((H, W), np.uint8)
    m1[10:20, 10:30] = 1
    m2 = np.zeros((H, W), np.uint8)
    m2[15:30, 25:45] = 1
    s = MultiMaskSession()
    assert s.add_mask(m1) == "mask_001"
    assert s.add_mask(m2) == "mask_002"
    t = s.template_mask(["mask_001", "mask_002"])
    assert set(np.unique(t)) == {0, 1, 2}
    assert t[16, 26] == 2 and t[11, 11] == 1
    assert set(np.unique(s.template_mask(["mask_002"]))) <= {0, 2}
    frame = np.full((H, W, 3), 128, np.uint8)
    painted = s.show(frame.copy(), ["mask_002", "mask_001"])
    want = jax_multimask.MultiMaskSession()
    want.add_mask(m1)
    want.add_mask(m2)
    np.testing.assert_array_equal(
        painted, want.show(frame.copy(), ["mask_002", "mask_001"]))
    assert (painted != frame).any()
    s.remove_all()
    assert s.masks == [] and s.mask_names == []
    with pytest.raises(ValueError):
        s.template_mask(["mask_001"])


class _RecordingFacade:
    """Facade stub: the tracker labels every frame with the template mask
    unchanged; painted frames are the originals + 100."""

    def __init__(self):
        self.inpaint_calls = []

    def generator(self, images, template_mask):
        masks = [np.asarray(template_mask)] * len(images)
        painted = [np.asarray(im) + 100 for im in images]
        return masks, [None] * len(images), painted

    def inpaint(self, frames, masks, **kw):
        self.inpaint_calls.append((np.asarray(masks).copy(), kw))
        return np.asarray(frames)


def test_two_step_session_track_then_inpaint():
    """Track stores full-video masks and a painted preview; inpaint takes
    the full video and keeps only the selected mask ids, without
    re-tracking (reference app.py:203-296)."""
    H, W = 48, 64
    frames = [np.full((H, W, 3), 10 * t, np.uint8) for t in range(6)]
    m1 = np.zeros((H, W), np.uint8)
    m1[5:15, 5:25] = 1
    m2 = np.zeros((H, W), np.uint8)
    m2[20:35, 30:50] = 1
    facade = _RecordingFacade()
    s = TwoStepSession(facade)
    s.reset(frames)
    s.multi.add_mask(m1)
    s.multi.add_mask(m2)
    with pytest.raises(ValueError):
        s.inpaint(["mask_001"])
    painted = s.track(["mask_001", "mask_002"], select_frame=2, track_end=5)
    assert len(painted) == 6
    np.testing.assert_array_equal(painted[0], frames[0])
    np.testing.assert_array_equal(painted[2], frames[2] + 100)
    np.testing.assert_array_equal(painted[5], frames[5])
    assert s.masks[0] is None and s.masks[2] is not None
    s.inpaint(["mask_002"], dilate_radius=3)
    sent, kw = facade.inpaint_calls[-1]
    assert sent.shape == (6, H, W) and kw == {"dilate_radius": 3}
    assert set(np.unique(sent[2])) == {0, 2}
    assert sent[0].max() == 0 and sent[5].max() == 0
    s.inpaint(["mask_001", "mask_002"])
    assert set(np.unique(facade.inpaint_calls[-1][0][2])) == {0, 1, 2}
    s.inpaint([])
    assert set(np.unique(facade.inpaint_calls[-1][0][2])) == {0, 1}


def test_two_step_session_single_mask_fallback():
    """With no added masks, track falls back to the click mask."""
    frames = [np.zeros((32, 40, 3), np.uint8) for _ in range(3)]
    mask = np.zeros((32, 40), np.uint8)
    mask[4:10, 4:10] = 1
    facade = _RecordingFacade()
    s = TwoStepSession(facade)
    s.reset(frames)
    with pytest.raises(ValueError):
        s.track([], 0)
    s.track([], 0, single_mask=mask)
    np.testing.assert_array_equal(s.masks[0], mask)
    s.inpaint([])
    np.testing.assert_array_equal(facade.inpaint_calls[-1][0][1], mask)


def test_new_modules_import_without_jax():
    """SAM, the weight bridge and the demo modules import with jax, flax
    and the JAX package unavailable, and pull in none of them."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax",
                     "propainter_tpu"):
            sys.modules[name] = None
        for name in ("propainter_tpu_torch.models.sam",
                     "propainter_tpu_torch.weights",
                     "propainter_tpu_torch.demo",
                     "propainter_tpu_torch.demo.segmenter",
                     "propainter_tpu_torch.demo.painters",
                     "propainter_tpu_torch.demo.multimask",
                     "propainter_tpu_torch.demo.session"):
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


def test_segmenter_needs_a_gpu_unless_told_cpu(weights, monkeypatch):
    """Built without device="cpu" on a machine without a GPU, the
    segmenter raises rather than running on the CPU."""
    _, sd = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamSegmenter(sd, config=TINY)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        SamSegmenter(sd, config=TINY, device="cuda")
    assert SamSegmenter(sd, config=TINY, device="cpu").device.type == "cpu"
