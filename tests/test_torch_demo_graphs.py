"""The demo's CUDA-graph regions (`CutieCore`'s encode / read / write,
`FlowMaskTracker`'s raft_pair / gate, `SamSegmenter`'s encode / decode) on
the CPU, through the stand-in graphs of tests/torch_graph_standins.py: a
captured call runs again at each replay under the guard, and must read the
tensors its capture read.

(a) capture safety: each of the seven regions, its caches warm (the first
    sight runs eagerly), is captured and replayed under `NoHostData` and
    reads at each replay what its capture read;
(b) Cutie graphed against eager: 14 frames at mem_every 2 and
    max_mem_frames 3 (two FIFO trims), then a second clip on the same
    graphs, equal bit for bit, memory included;
(c) the graphed Cutie against the JAX `CutieCore` (run as
    tests/test_torch_cutie.py runs it) within that file's 1e-4;
(d) the graphed flow tracker (4 frames, twice) and the graphed segmenter
    (two images, clicks with and without `points_bucket`) against their
    eager selves exactly, and against the JAX tracker and segmenter within
    the 1e-4 of tests/test_torch_tracking.py and tests/test_torch_demo.py;
(e) the keys: Cutie's reads by memory length and update_sensory, one key
    set a track (`clear_memory`) or an image (`reset_image`), unknown
    names refused;
(f) no owner graphs anything on the CPU by default.

Each with one object and two (Cutie), at the small configurations of those
files.
"""

import functools
import inspect

import cv2
import numpy as np
import pytest
import torch

from propainter_tpu.demo import tracking as jax_tracking
from propainter_tpu.demo.cutie_core import (
    CutieCore as JaxCutieCore, CutieCoreConfig as JaxCoreConfig)
from propainter_tpu.demo.segmenter import SamSegmenter as JaxSegmenter
from tests.test_demo import _scene
from tests.test_torch_cutie import JAX_SMALL, cutie_pair, jax_jit  # noqa: F401
from tests.test_torch_sam import JAX_TINY, TINY, assert_close, sam_pair
from tests.test_torch_tracking import raft_weights  # noqa: F401
from tests.torch_graph_standins import CPUGraphs, CountingGraphs

from propainter_tpu_torch.demo.cutie_core import (
    CUTIE_REGIONS, CutieCore, CutieCoreConfig)
from propainter_tpu_torch.demo.segmenter import SAM_REGIONS, SamSegmenter
from propainter_tpu_torch.demo.tracking import (
    FLOW_TRACKER_REGIONS, FlowMaskTracker)
from propainter_tpu_torch.graphs import StageGraphs

H, W = 64, 96
h, w = H // 16, W // 16
RTOL = 1e-4
# memory frames every 2 (0, 2, 4, ...), at most 3 frames of memory (the
# permanent one and 2 working ones: the trims at 6, 8, ...), the sensory
# memory updated 1 frame after a memory frame and not 2, so the reads take
# both update_sensory values
CORE = dict(mem_every=2, max_mem_frames=3, top_k=8, stagger_updates=1)
FRAMES = 14


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


def _clip(T: int, seed: int, n_obj: int, size=(H, W)):
    """Smooth random textures drifting in brightness (as
    tests/test_torch_cutie.py's), and `n_obj` rectangles on the first
    frame."""
    Hc, Wc = size
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:Hc, 0:Wc].astype(np.float32)
    frames = []
    for t in range(T):
        img = np.stack([0.5 + 0.3 * np.sin((x + 3 * t) / (5 + c) + c)
                        * np.cos(y / (7 - c)) for c in range(3)], -1)
        img = img + rng.uniform(-0.1, 0.1, img.shape)
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    mask0 = np.zeros((2, Hc, Wc), np.float32)
    mask0[0, 8:30, 10:40] = 1
    mask0[1, 34:58, 50:88] = 1
    return frames, mask0[:n_obj]


def _track(core, frames, mask0):
    """Probabilities a frame, and the memory after the track."""
    core.clear_memory()
    probs = [core.step(f, mask0 if i == 0 else None)
             for i, f in enumerate(frames)]
    return probs, {k: getattr(core, k).clone() for k in (
        "mem_key", "mem_shrinkage", "mem_value", "obj_v", "sensory",
        "last_mask")}


@functools.lru_cache(maxsize=None)
def _cutie_runs(n_obj: int):
    """An eager and a stand-in-graphed CutieCore on one seeded small
    Cutie over two clips: (eager tracks, graphed tracks, graphed core,
    the keys after the first clip)."""
    _, net = cutie_pair(seed=13)
    eager = CutieCore(net, config=CutieCoreConfig(**CORE), device="cpu")
    graphed = CutieCore(net, config=CutieCoreConfig(**CORE), device="cpu")
    graphed.graphs = CountingGraphs(CUTIE_REGIONS, CUTIE_REGIONS)
    clips = [_clip(FRAMES, seed, n_obj) for seed in (10, 11)]
    runs_e = [_track(eager, *c) for c in clips]
    runs_g = [_track(graphed, *clips[0])]
    keys = graphed.graphs.keys()
    runs_g.append(_track(graphed, *clips[1]))
    return runs_e, runs_g, graphed, keys


@pytest.mark.parametrize("n_obj", [1, 2])
def test_cutie_graphed_equals_eager(n_obj):
    """(b) Every frame's probabilities and the memory after each clip
    (two FIFO trims a clip) equal the eager core's bit for bit; the
    second clip replays the first clip's graphs and captures none."""
    runs_e, runs_g, graphed, keys = _cutie_runs(n_obj)
    for (pe, me), (pg, mg) in zip(runs_e, runs_g):
        assert len(pg) == FRAMES
        for i, (a, b) in enumerate(zip(pg, pe)):
            assert a.shape == (n_obj + 1, H, W)
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
        for k in me:
            torch.testing.assert_close(mg[k], me[k], rtol=0, atol=0,
                                       msg=k)
    assert graphed.graphs.keys() == keys


@pytest.mark.parametrize("n_obj", [1, 2])
def test_cutie_regions_hold_no_host_data(n_obj):
    """(a) Each of Cutie's three regions was captured under the guard
    (host data made into a tensor, a value read back or a data-dependent
    shape raise) and replayed, each replay reading what its capture read:
    encode once a frame after the first, write on memory frames, the
    reads of the lengths that recur."""
    _, _, graphed, _ = _cutie_runs(n_obj)
    counts = graphed.graphs.counts()
    assert counts == {"encode": 1, "read": 6, "write": 1}
    # a capture replays at once. Clip 1: encode from frame 1 (13), write
    # at 2, 4, ..., 12 (6), the reads of 3hw tokens from their second
    # sight (frames 7-13: 7); clip 2: every encode (14), write (7) and
    # read (13)
    assert graphed.graphs.replays == {"encode": 13 + 14, "write": 6 + 7,
                                      "read": 7 + 13}


@pytest.mark.parametrize("n_obj", [1, 2])
def test_cutie_read_keys_are_the_memory_lengths(n_obj):
    """(e) The read keys are the memory lengths hw, 2hw, 3hw (at most
    max_mem_frames frames) crossed with update_sensory; one encode key
    (the padded frame) and one write key (the frame and the object
    count)."""
    _, _, _, keys = _cutie_runs(n_obj)
    reads = {(k[2][6][0][-1], k[1]) for k in keys if k[0] == "read"}
    assert reads == {(t * h * w, (u,)) for t in (1, 2, 3)
                     for u in (True, False)}
    assert [k[2] for k in keys if k[0] == "encode"] == [
        (((1, 3, H, W), torch.float32),)]
    (write,) = [k[2] for k in keys if k[0] == "write"]
    assert write[3][0] == (1, n_obj, H, W)


@pytest.fixture(scope="module")
def jax_cutie_runs(jax_jit):
    """The JAX CutieCore over the first clip, with one object and two,
    its model passes the jitted methods of tests/test_torch_cutie.py."""
    tree, _ = cutie_pair(seed=13)
    out = {}
    for n_obj in (1, 2):
        frames, mask0 = _clip(FRAMES, 10, n_obj)
        j = JaxCutieCore(tree, model_config=JAX_SMALL,
                         config=JaxCoreConfig(**CORE))
        for m in ("encode_image", "transform_key", "read_first",
                  "segment"):
            setattr(j, f"_{m}", functools.partial(jax_jit[m], tree))
        j._encode_mask = lambda *a: jax_jit["encode_mask"](tree, *a, True)
        out[n_obj] = [j.step(f, mask0 if i == 0 else None)
                      for i, f in enumerate(frames)]
    return out


@pytest.mark.parametrize("n_obj", [1, 2])
def test_cutie_graphed_matches_jax(n_obj, jax_cutie_runs):
    """(c) The graphed core's probabilities within 1e-4 of the JAX core's
    at every frame of the first clip, the tracked masks neither empty nor
    full."""
    _, runs_g, _, _ = _cutie_runs(n_obj)
    for i, (t, j) in enumerate(zip(runs_g[0][0], jax_cutie_runs[n_obj])):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=RTOL,
                                   err_msg=f"frame {i}")
        labels = np.argmax(t, axis=0)
        assert 0 < (labels > 0).sum() < labels.size, f"frame {i}"


def test_cutie_keeps_the_last_tracks_keys():
    """(e) `clear_memory` starts a track: after a track at 64 x 96 and
    one at 48 x 80, the next track holds only the 48 x 80 keys, and a
    track at 64 x 96 sees its keys for the first time again."""
    _, net = cutie_pair(seed=13)
    core = CutieCore(net, config=CutieCoreConfig(**CORE), device="cpu")
    core.graphs = CPUGraphs(CUTIE_REGIONS, CUTIE_REGIONS)

    def shapes():
        return {k[2][0][0] for k in core.graphs.keys() if k[0] == "encode"}

    small = _clip(5, 10, 1, (48, 80))
    _track(core, *_clip(5, 10, 1))
    _track(core, *small)
    assert shapes() == {(1, 3, 64, 96), (1, 3, 48, 80)}
    _track(core, *small)
    assert shapes() == {(1, 3, 48, 80)}
    assert core.graphs.counts()["encode"] == 1


@pytest.fixture(scope="module")
def flow_runs(raft_weights):  # noqa: F811
    """The flow tracker over two tracks of 4 frames (a square moving 2 px
    a frame, then 3 px), eager, stand-in-graphed and JAX, raft_iter 2:
    each frame's (mask, soft mask) and the graphed tracker."""
    tree, sd = raft_weights
    template = np.zeros((H, W), np.uint8)
    template[20:40, 20:40] = 1
    tracks = [[_scene(t) for t in range(4)],
              [_scene(t) for t in range(0, 12, 3)]]
    graphed = FlowMaskTracker(sd, raft_iter=2, device="cpu")
    graphed.graphs = CountingGraphs(FLOW_TRACKER_REGIONS,
                                    FLOW_TRACKER_REGIONS)
    trackers = dict(eager=FlowMaskTracker(sd, raft_iter=2, device="cpu"),
                    graphed=graphed,
                    jax=jax_tracking.FlowMaskTracker(tree, raft_iter=2))
    out = {}
    for name, tracker in trackers.items():
        out[name] = []
        for frames in tracks:
            cv2.setRNGSeed(0)       # GrabCut's k-means draws from it
            tracker.clear_memory()
            out[name].append([tracker.track(f, template if i == 0 else None)
                              [:2] for i, f in enumerate(frames)])
    return out, graphed


def test_flow_tracker_graphed_equals_eager_and_matches_jax(flow_runs):
    """(d) Over both tracks the graphed tracker's masks and soft masks
    equal the eager tracker's bit for bit; against the JAX tracker the
    masks are equal and the soft masks within 1e-4."""
    out, _ = flow_runs
    for t, (g_track, e_track, j_track) in enumerate(zip(
            out["graphed"], out["eager"], out["jax"])):
        for i, (g, e, j) in enumerate(zip(g_track, e_track, j_track)):
            what = f"track {t}, frame {i}"
            assert 0 < g[0].sum() < g[0].size, what
            np.testing.assert_array_equal(g[0], e[0], err_msg=what)
            np.testing.assert_array_equal(g[1], e[1], err_msg=what)
            np.testing.assert_array_equal(g[0], j[0], err_msg=what)
            np.testing.assert_allclose(g[1], j[1], rtol=0, atol=RTOL,
                                       err_msg=what)


def test_flow_tracker_regions_hold_no_host_data(flow_runs):
    """(a) raft_pair and gate were captured under the guard on their
    second frame and replayed after it, each replay reading what its
    capture read: one key each, 3 + 3 calls, 2 + 3 replays (a capture
    replays at once)."""
    _, graphed = flow_runs
    assert graphed.graphs.counts() == {"gate": 1, "raft_pair": 1}
    assert graphed.graphs.replays == {"raft_pair": 5, "gate": 5}
    (key,) = [k for k in graphed.graphs.keys() if k[0] == "raft_pair"]
    assert key[1] == (2,) and key[2][0][0] == (1, H, W, 3)


IMAGES = [np.random.default_rng(s).integers(0, 255, (48, 64, 3), np.uint8)
          for s in (5, 6)]
CLICKS = np.array([[30.0, 20.0], [50.0, 36.0], [12.0, 40.0]], np.float32)
LABELS = np.array([1, 0, 1], np.int32)


def _session(seg):
    """Images 0, 1 and 0 again; on each, clicks 1, 2 and 3 in 'point'
    mode then in 'both' (the best logits of the point pass as the dense
    prompt), twice: every (masks, scores, logits)."""
    out = []
    for image in (IMAGES[0], IMAGES[1], IMAGES[0]):
        seg.reset_image()
        seg.set_image(image)
        for _ in range(2):
            for n in (1, 2, 3):
                prompts = {"point_coords": CLICKS[:n],
                           "point_labels": LABELS[:n]}
                m, s, lg = seg.predict(prompts, "point")
                out.append((m, s, lg))
                prompts["mask_input"] = np.asarray(lg)[
                    int(np.argmax(s))][None]
                out.append(seg.predict(prompts, "both"))
    return out


@functools.lru_cache(maxsize=None)
def _sam_runs(points_bucket):
    """The session through an eager, a stand-in-graphed and the JAX
    segmenter on one seeded TINY SAM, and the graphed segmenter."""
    tree, net = sam_pair(seed=5)
    sd = net.state_dict()
    graphed = SamSegmenter(sd, config=TINY, points_bucket=points_bucket,
                           device="cpu")
    graphed.graphs = CountingGraphs(SAM_REGIONS, SAM_REGIONS)
    out = dict(
        eager=_session(SamSegmenter(sd, config=TINY,
                                    points_bucket=points_bucket,
                                    device="cpu")),
        graphed=_session(graphed),
        jax=_session(JaxSegmenter(tree, config=JAX_TINY,
                                  points_bucket=points_bucket)))
    return out, graphed


@pytest.mark.parametrize("points_bucket", [None, 8], ids=["exact", "bucket"])
def test_segmenter_graphed_equals_eager_and_matches_jax(points_bucket):
    """(d) Every prediction of the session: masks, scores and low-res
    logits of the graphed segmenter equal the eager one's bit for bit;
    against the JAX segmenter scores and logits within 1e-4 of scale and
    the masks equal wherever the JAX logits, upsampled as the masks are,
    lie further than that from 0 (each 'both' pass takes its own
    segmenter's point-pass logits, so a pixel within rounding of 0 may
    take either side)."""
    out, graphed = _sam_runs(points_bucket)
    assert len(out["graphed"]) == 3 * 2 * 6
    for i, (g, e, j) in enumerate(zip(out["graphed"], out["eager"],
                                      out["jax"])):
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b, err_msg=f"prediction {i}")
        assert 0 < g[0].sum() < g[0].size
        logit = np.array(j[2])
        sure = np.abs(graphed._postprocess(torch.from_numpy(
            logit)).numpy()) > RTOL * np.abs(logit).max()
        np.testing.assert_array_equal(g[0][sure], np.asarray(j[0])[sure])
        assert_close(g[1], j[1], f"scores, prediction {i}")
        assert_close(g[2], j[2], f"logits, prediction {i}")


@pytest.mark.parametrize("points_bucket", [None, 8], ids=["exact", "bucket"])
def test_segmenter_regions_hold_no_host_data(points_bucket):
    """(a) The encoder was captured under the guard on the second image
    and replayed for it and the third; the decoder's keys (the padded
    point count, whether a mask is given) captured on their second sight
    on each image and replayed. With the bucket every click count pads to
    8 tokens: two decode keys; without it, one a count and mode (6). (e)
    `reset_image` keeps the keys of the last image only, which here are
    all of them."""
    _, graphed = _sam_runs(points_bucket)
    n_keys = 2 if points_bucket else 6
    assert graphed.graphs.counts() == {"encode": 1, "decode": n_keys}
    assert graphed.graphs.replays["encode"] == 2
    # 36 decode calls: each key's first sight, on the first image, is no
    # replay; its capture replays at once
    assert graphed.graphs.replays["decode"] == 36 - n_keys
    counts = sorted(k[2][1][0][1] for k in graphed.graphs.keys()
                    if k[0] == "decode")
    assert counts == ([8, 8] if points_bucket else [2, 2, 3, 3, 4, 4])


def test_segmenter_keeps_the_last_images_keys():
    """(e) After a click of 1 and then of 2 points on one image, and of 2
    on the next, `reset_image` drops the 1-point key."""
    _, net = sam_pair(seed=5)
    seg = SamSegmenter(net.state_dict(), config=TINY, device="cpu")
    seg.graphs = CPUGraphs(SAM_REGIONS, SAM_REGIONS)

    def decode_points():
        return sorted(k[2][1][0][1] for k in seg.graphs.keys()
                      if k[0] == "decode")

    for clicks in ((1, 2), (2,), ()):
        seg.reset_image()
        seg.set_image(IMAGES[0])
        for n in clicks:
            seg.predict({"point_coords": CLICKS[:n],
                         "point_labels": LABELS[:n]}, "point")
        if clicks == (2,):
            assert decode_points() == [2, 3]
    assert decode_points() == [3]


@pytest.mark.parametrize("owner, names", [
    ("cutie", CUTIE_REGIONS), ("flow", FLOW_TRACKER_REGIONS),
    ("sam", SAM_REGIONS)])
def test_regions_are_checked_and_eager_on_the_cpu(owner, names):
    """(e) An unknown region name raises, on the CPU too; (f) on the CPU
    an owner graphs nothing, whatever `cuda_graphs` asks, and by default;
    each default names known regions."""
    _, net = cutie_pair(seed=13) if owner == "cutie" else (None, None)
    make = dict(
        cutie=lambda **kw: CutieCore(net, device="cpu", **kw),
        flow=lambda **kw: FlowMaskTracker(flow_fn=lambda a, b: None,
                                          device="cpu", **kw),
        sam=lambda **kw: SamSegmenter(sam_pair(seed=5)[1], config=TINY,
                                      device="cpu", **kw))[owner]
    with pytest.raises(ValueError, match="unknown stages"):
        make(cuda_graphs=("encoder",))
    with pytest.raises(ValueError, match="unknown stages"):
        StageGraphs(["generation"], names)
    assert make().graphs.stages == frozenset()
    assert make(cuda_graphs=names).graphs.stages == frozenset()
    default = inspect.signature(dict(
        cutie=CutieCore, flow=FlowMaskTracker, sam=SamSegmenter)[owner]
    ).parameters["cuda_graphs"].default
    assert set(default) <= set(names)
    assert StageGraphs(names, names, device="cpu").stages == frozenset()
    assert StageGraphs(names, names).stages == frozenset(names)
