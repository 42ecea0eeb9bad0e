"""The pipeline's CUDA-graph stages (`propainter_tpu_torch/graphs.py`) on
the CPU, where no graph can be captured: each captured call is replaced by
a stand-in that runs the call once at capture and again at each replay
(the launch counters left as they were, as a real replay runs no Python),
and holds every tensor the capture read besides those it made: a replay
must read the same tensors, by address, as a graph does.

The stand-ins (`tests/torch_graph_standins.py`) serve the demo's regions
too (tests/test_torch_demo_graphs.py).

(a) capture safety: every graphed region, with its caches warm, makes no
    host data into a tensor, reads no value back and takes no data-
    dependent shape ('flash', 'pallas', shard_inference, bf16, with and
    without the encoder carry), reads at each replay what its capture
    read, and the replayed pipeline gives the eager pipeline's output
    exactly, also after the device index caches took many other shapes;
(b) stage 4's vectorised compositing against the per-frame loop it
    replaced, exactly (overlapping windows, window_batch 4 with a padded
    tail, a carried sub-run); against the JAX `upd` through the golden
    tests (tests/test_torch_pipeline.py, tests/test_torch_stage4.py);
(c) the cache's keys against `chip_smoke._graph_keys` (the RAFT chunk
    lengths, stages 2 and 3, the plan's distinct generator calls), and
    the cache keeping only the keys of the last video;
(d) the launch accounting around a capture, through a stand-in for
    `torch.cuda.CUDAGraph`: a capture adds nothing, a replay its deltas.

Small models: RAFT and the flow completion at their fixed widths on 8
frames of 128 x 128 (RAFT chunks of 3, 2 iterations), the generator at
hidden 128 and depth 2 (windows of 3, 5, 5 and 4 frames).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from propainter_tpu_torch import graphs
from propainter_tpu_torch import pipeline as torch_pipeline
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models import propainter as torch_propainter
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.ops import flash_attention, interp
from propainter_tpu_torch.utils.masks import binary_dilation_cross
from propainter_tpu_torch.weights import seeded_init_
from tests.torch_graph_standins import CPUGraphs, NoHostData

T, H, W = 8, 128, 128


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


CONFIGS = {
    "flash": {},
    "flash_no_carry": dict(encoder_carry=False),
    "pallas": dict(attention_impl="pallas"),
    "shard": dict(shard_inference=True, window_batch=2),
    "bf16": dict(precision="bf16"),
}


@functools.lru_cache(maxsize=1)
def _state_dicts():
    mods = dict(raft=RAFT(), flowcomp=RecurrentFlowCompleteNet(),
                inpaint=InpaintGenerator(hidden=128, depths=2))
    return {k: seeded_init_(m, i, fan_in_scaled=True).state_dict()
            for i, (k, m) in enumerate(mods.items())}


def _pipeline(name: str):
    mods = dict(raft=RAFT(), flowcomp=RecurrentFlowCompleteNet(),
                inpaint=InpaintGenerator(hidden=128, depths=2))
    for k, m in mods.items():
        m.load_state_dict(_state_dicts()[k])
    cfg = torch_pipeline.PipelineConfig(
        raft_iter=2, raft_clip_len=3, neighbor_length=4, ref_stride=4,
        **CONFIGS[name])
    return torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"], cfg, device="cpu")


@functools.lru_cache(maxsize=1)
def _clip():
    """Frames panning right and a hole moving across them (dilated by 2),
    so the windows' buckets differ."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (H // 8, W // 8, 3), np.uint8)
    frames = np.stack([
        np.roll(np.kron(base, np.ones((8, 8, 1), np.uint8)), 3 * t, axis=1)
        for t in range(T)])
    mask = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        mask[t, 36:76, 8 + 6 * t:44 + 6 * t] = 1
    return frames, np.stack([binary_dilation_cross(m, 2) for m in mask])


@functools.lru_cache(maxsize=None)
def _runs(name: str):
    """(eager output, the outputs of two videos through CPUGraphs, the
    cache's keys and its captured graphs by stage, the pipeline)."""
    frames, mask = _clip()
    pipe = _pipeline(name)
    eager = np.stack(pipe.inpaint_video(frames, mask, mask))
    pipe.graphs = CPUGraphs(graphs.STAGES)
    outs = [np.stack(pipe.inpaint_video(frames, mask, mask))
            for _ in range(2)]
    return eager, outs, pipe.graphs.keys(), pipe.graphs.counts(), pipe


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graphed_regions_hold_no_host_data(name):
    """(a) Every key of every stage is captured by the second video, each
    capture and replay ran under `_NoHostData`, each replay read what its
    capture read, and both videos' uint8 outputs equal the eager
    pipeline's."""
    eager, outs, keys, counts, _ = _runs(name)
    assert counts == {s: sum(k[0] == s for k in keys) for s in graphs.STAGES}
    assert all(counts.values())
    for out in outs:
        np.testing.assert_array_equal(out, eager)


def test_the_guard_sees_host_data():
    """(a) The guard raises on the host work the regions no longer do."""
    x = torch.arange(6.0)
    for bad in (lambda: torch.as_tensor(np.arange(3)),
                lambda: torch.tensor([1, 2]), lambda: x.sum().item(),
                lambda: torch.nonzero(x), lambda: x[x > 2]):
        with pytest.raises(AssertionError, match="graphed region"):
            with NoHostData():
                bad()


def test_the_guard_refuses_torch_equal_in_a_region():
    """(a) `torch.equal` hands its bool back without a
    `_local_scalar_dense` (a host loop's exit test, as Canny's hysteresis
    has): eager at the key's first sight, refused at its capture."""
    region = CPUGraphs(("raft",))
    x = torch.arange(6.0)
    assert region("raft", lambda t: torch.equal(t, t), (x,)) is True
    with pytest.raises(AssertionError, match="aten.equal"):
        region("raft", lambda t: torch.equal(t, t), (x,))
    with pytest.raises(AssertionError, match="graphed region"):
        with NoHostData():
            torch.equal(x, x)


def test_a_stand_in_capture_writes_nothing():
    """A capture runs nothing on the device: what the stand-in's capture
    writes into tensors it did not make is put back, so a region that
    updates state in place (a train step's optimizer) applies once a
    call, first sight, capture and replays alike."""
    region = CPUGraphs(("raft",))
    acc = torch.zeros(3)
    views = acc[1:]

    def step(t):
        acc.add_(t)
        views.mul_(2.0)
        return acc.sum()

    outs = [float(region("raft", step, (torch.ones(3),))) for _ in range(3)]
    want = torch.zeros(3)
    for _ in range(3):
        want += 1
        want[1:] *= 2
    assert torch.equal(acc, want)
    assert outs[-1] == float(want.sum())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cache_keys_are_the_plans(name):
    """(c) The keys one video gives: RAFT's chunk lengths (3, 4 and 3 of
    8 frames at chunks of 3), stages 2 and 3 once each, and
    the plan's distinct (l_t, masked bucket width, carry) at its one
    window_batch and reference count, a tail batch sharing its sub-run's
    key - `chip_smoke._graph_keys`, which the card's `graphs` phase checks
    its graph counts against."""
    _, _, keys, _, pipe = _runs(name)
    frames, mask = _clip()
    plan = pipe.stage4_plan(torch.from_numpy(mask.astype(np.float32))[
        None, ..., None])
    want = chip_smoke._graph_keys(pipe, plan, T, W)
    got = {s: sum(k[0] == s for k in keys) for s in graphs.STAGES}
    assert got == want
    assert want["raft"] == 2
    assert {k[1] for k in keys if k[0] == "generation"} == {
        (sr.l_t, sr.carry) for sr in plan.subruns}
    assert {k[2][0][0][0] for k in keys if k[0] == "generation"} == {
        plan.window_batch}


def _loop_composite(comp, visited, pred, nb, n_real, masks_bin, ori):
    """The per-frame compositing the vectorised form replaced."""
    img8 = torch.floor((pred.float() + 1.0) / 2.0 * 255.0).clamp(0.0, 255.0)
    for w in range(n_real):
        for j, t in enumerate(nb[w].tolist()):
            m = masks_bin[t]
            img = img8[w, j] * m + ori[t] * (1.0 - m)
            if visited[t]:
                img = torch.floor(0.5 * comp[t] + 0.5 * img)
            comp[t] = img
            visited[t] = True


@pytest.mark.parametrize("config", [
    dict(),                                        # a carried sub-run
    dict(encoder_carry=False),                     # overlapping windows
    dict(window_batch=4),                          # a padded tail batch
])
def test_composite_windows_equals_the_per_frame_loop(config):
    """(b) Over a whole plan, in its order, with random predictions
    (beyond [-1, 1], so the clip acts) and a random mask and original:
    the vectorised compositing (`window_images` on each call's gathered
    windows, then `composite_windows`) equals the per-frame loop bit for
    bit."""
    frames, mask = _clip()
    cfg = torch_pipeline.PipelineConfig(neighbor_length=4, ref_stride=4,
                                        **config)
    pipe = torch_pipeline.ProPainterPipeline(
        RAFT(), RecurrentFlowCompleteNet(),
        InpaintGenerator(hidden=128, depths=2), cfg, device="cpu")
    masks = torch.from_numpy(mask.astype(np.float32))[None, ..., None]
    plan = pipe.stage4_plan(masks)
    _, subruns = pipe._plan_tensors(plan, T)
    g = torch.Generator().manual_seed(3)
    masks_bin = (torch.rand(T, 16, 24, 1, generator=g) > 0.5).float()
    ori = torch.randint(0, 256, (T, 16, 24, 3), generator=g,
                        dtype=torch.uint8)
    comp = torch.zeros(T, 16, 24, 3)
    ref = comp.clone()
    visited = torch.zeros(T, dtype=torch.bool)
    n_calls, tails = 0, 0
    for sr, (_, batches) in zip(plan.subruns, subruns):
        for n_real, index in batches:
            nb, revisit = index[0], index[3]
            pred = torch.rand(nb.shape + (16, 24, 3), generator=g) * 2.4 - 1.2
            img = torch_pipeline.window_images(pred, masks_bin[nb], ori[nb])
            comp = torch_pipeline.composite_windows(comp, img, nb, revisit,
                                                    n_real)
            _loop_composite(ref, visited, pred, nb, n_real, masks_bin,
                            ori.float())
            n_calls += 1
            tails += n_real < nb.shape[0]
    torch.testing.assert_close(comp, ref, rtol=0, atol=0)
    assert bool(visited.all())
    if config.get("window_batch") == 4:
        assert tails > 0
    elif config.get("encoder_carry", True):
        assert any(sr.carry for sr in plan.subruns)
    assert n_calls > 1


def test_capture_adds_nothing_and_each_replay_its_deltas(monkeypatch):
    """(d) Through `StageGraphs._capture_graph` with `torch.cuda`'s graph,
    pool and streams replaced by stand-ins (a replay that runs nothing): the first call runs eagerly and counts its launches; the
    second captures (the capture's counts taken back) and replays, adding
    the capture's deltas; the third replays, adding them again. Each
    replay copies its tensors into the static inputs and returns a copy
    of the graph's outputs."""
    replays, pools = [], []

    class Graph:
        def capture_begin(self, pool):
            pools.append(pool)

        def capture_end(self):
            pass

        def replay(self):
            replays.append(1)

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    k4 = flash_attention.flash_window_attention
    shape = (8, 90, 360)

    def stage(x):
        k4.launches += 2
        k4.shapes[shape] = k4.shapes.get(shape, 0) + 1
        return x * 2.0, x + 1.0

    cache = graphs.StageGraphs(["generation"])
    launches, by_shape = k4.launches, k4.shapes.get(shape, 0)
    x = torch.arange(4.0)
    out = cache("generation", stage, (x,))
    assert (k4.launches, k4.shapes[shape]) == (launches + 2, by_shape + 1)
    assert cache.counts() == {"generation": 0} and not replays
    out = cache("generation", stage, (x + 10.0,))
    assert len(replays) == 1 and pools == ["pool"]
    assert (k4.launches, k4.shapes[shape]) == (launches + 4, by_shape + 2)
    # the stand-in replay runs nothing, so each replay returns a copy of
    # what the capture left in the graph's output buffer
    kept = out[0].clone()
    out[0].zero_()
    out = cache("generation", stage, (x + 20.0,))
    assert len(replays) == 2 and cache.counts() == {"generation": 1}
    assert (k4.launches, k4.shapes[shape]) == (launches + 6, by_shape + 3)
    torch.testing.assert_close(out[0], kept, equal_nan=True)
    (graph,) = [g for g in cache._graphs.values() if g is not None]
    torch.testing.assert_close(graph.inputs[0], x + 20.0)   # copied in
    # a stage not graphed runs eagerly; another shape is a key of its own
    cache("raft", stage, (x,))
    cache("generation", stage, (torch.arange(5.0),))
    assert len(replays) == 2 and len(cache.keys()) == 2
    assert (k4.launches, k4.shapes[shape]) == (launches + 10, by_shape + 5)


def test_static_values_are_part_of_the_key():
    """Two calls with tensors of one shape but other static values (two
    stage-4 sub-runs' carry strides) are two keys, each eager, captured
    and replayed on its own."""
    cache = CPUGraphs(["generation"])
    x = torch.arange(3.0)
    for n in (2.0, 3.0, 2.0):
        for _ in range(3):
            out = cache("generation", lambda t, n=n: t * n, (x,), (n,))
            torch.testing.assert_close(out, x * n, rtol=0, atol=0)
    assert len(cache.keys()) == 2 and cache.counts() == {"generation": 2}


def test_stages_are_checked_and_eager_on_the_cpu():
    """An unknown stage name raises; a CPU pipeline graphs nothing,
    whatever `cuda_graphs` asks; the defaults name known stages."""
    with pytest.raises(ValueError, match="unknown stages"):
        graphs.StageGraphs(["rafts"])
    pipe = torch_pipeline.ProPainterPipeline(
        RAFT(), RecurrentFlowCompleteNet(),
        InpaintGenerator(hidden=128, depths=2), device="cpu",
        cuda_graphs=graphs.STAGES)
    assert pipe.graphs.stages == frozenset()
    assert set(torch_pipeline.CUDA_GRAPHS) <= set(graphs.STAGES)


def test_replays_survive_the_index_caches_taking_other_shapes():
    """(a) The device index caches a captured region reads by address
    (`models/propainter._frame_selection`, `ops/interp._nearest_index_on`)
    keep their tensors while other shapes come and go: between the
    captures and a third video, each takes 100 other keys, and the third
    video's replays read the tensors their captures read and give the
    eager output."""
    eager, _, _, counts, pipe = _runs("flash")
    cpu = torch.device("cpu")
    for n in range(1, 101):
        torch_propainter._frame_selection(np.ones(n, np.bool_).tobytes(),
                                          cpu, True)
        torch_propainter._frame_selection(np.ones(n, np.bool_).tobytes(),
                                          cpu, False)
        interp._nearest_index_on(n, n + 1, cpu)
    frames, mask = _clip()
    out = np.stack(pipe.inpaint_video(frames, mask, mask))
    np.testing.assert_array_equal(out, eager)
    assert pipe.graphs.counts() == counts


def test_the_cache_keeps_the_last_videos_keys():
    """(c) `begin_video` drops every key the last video did not use, and
    the static inputs only dropped keys read: over videos of shapes a, a,
    b, b, a, the key of a is captured on the second video, dropped after
    the fourth, and seen for the first time again on the fifth."""
    cache = CPUGraphs(["raft"])
    a, b = torch.arange(3.0), torch.arange(4.0)

    def video(x):
        cache.begin_video()
        for _ in range(2):
            torch.testing.assert_close(
                cache("raft", lambda t: t * 2.0, (x,)), x * 2.0)
        return ({k[2][0][0] for k in cache.keys()},
                sorted(k[2] for k in cache._inputs))

    assert video(a) == ({(3,)}, [(3,)])
    assert video(a) == ({(3,)}, [(3,)])
    assert video(b) == ({(3,), (4,)}, [(3,), (4,)])
    assert video(b) == ({(4,)}, [(4,)])
    assert video(a) == ({(3,), (4,)}, [(3,), (4,)])
    assert cache.counts() == {"raft": 2}
