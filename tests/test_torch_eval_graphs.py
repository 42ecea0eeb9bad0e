"""The evaluation CLIs' CUDA-graph regions on the CPU: `evaluate`'s I3D
(`I3DFeatures`, region `i3d`) and the RAFT pair of `compute_flow` and
`raft_demo` (`RaftPairFlow`, region `raft_pair`), through the stand-in
graphs of tests/torch_graph_standins.py: a captured region runs again at
each replay under the guard, and must read the tensors its capture read.

(a) each region's stand-in replays equal its eager calls bit for bit;
(b) the keys: I3D's the video's shape, one video's true and inpainted
    frames sharing one (captured at the second), `begin_video` dropping
    the last video's; RAFT's pair the frames' shape and the iterations;
(c) `compute_flow`'s and `raft_demo`'s files on the CPU unchanged: equal
    to RAFT called as the CLIs called it before, and to their graphed
    runs;
(d) the defaults: `raft_pair` graphed, I3D eager, nothing graphed on the
    CPU, unknown names refused.

Small sizes: I3D on 10 frames of 64 x 64, RAFT at 2 iterations on 64 x
64 frames (the CLIs' fixture clip for (c)).
"""

import inspect
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from tests.torch_graph_standins import CountingGraphs

from propainter_tpu_torch.cli import compute_flow, raft_demo
from propainter_tpu_torch.cli.compute_flow import (RAFT_PAIR_REGIONS,
                                                   RaftPairFlow)
from propainter_tpu_torch.cli.evaluate import I3D_REGIONS, I3DFeatures
from propainter_tpu_torch.device import fp32_numerics
from propainter_tpu_torch.models.i3d import InceptionI3d
from propainter_tpu_torch.models.layers import FrozenBatchNorm
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.utils.flow_io import flowwrite
from propainter_tpu_torch.weights import seeded_init_

CLIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo_clip")
ITERS = 2


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


@pytest.fixture(scope="module")
def i3d():
    """A seeded I3D, batch-norm scales U(0.5, 1.5) as
    tests/test_torch_eval_cli.py's, so its features stay O(1)."""
    net = seeded_init_(InceptionI3d(), 33, fan_in_scaled=True)
    g = torch.Generator().manual_seed(34)
    for m in net.modules():
        if isinstance(m, FrozenBatchNorm):
            m.weight.data.uniform_(0.5, 1.5, generator=g)
    return net.eval()


@pytest.fixture(scope="module")
def raft():
    return seeded_init_(RAFT(), 35, fan_in_scaled=True).eval()


def _video(T: int, seed: int, size=(64, 64)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (T, 4, 4, 3)).astype(np.float32)
    return np.stack([cv2.resize(f, size[::-1]) for f in small]).astype(
        np.uint8)


def test_i3d_region_replays_eager(i3d):
    """(a, b) Videos of 10, 8 and 10 frames: each video's true and
    inpainted frames (one key, captured at the second call); the third
    video's `begin_video` drops the 10-frame key, which the 8-frame video
    did not use, so it is seen anew; every feature vector equal to the
    eager owner's."""
    eager = I3DFeatures(i3d, torch.device("cpu"))
    graphed = I3DFeatures(i3d, torch.device("cpu"))
    graphed.graphs = CountingGraphs(I3D_REGIONS, I3D_REGIONS)
    videos = [(_video(10, 1), _video(10, 2)), (_video(8, 3), _video(8, 4)),
              (_video(10, 5), _video(10, 6))]
    keys = []
    for true, comp in videos:
        for owner in (eager, graphed):
            owner.begin_video()
        for v in (true, comp):
            want, got = eager(v), graphed(v)
            assert got.shape == (1024,) and np.isfinite(got).all()
            np.testing.assert_array_equal(got, want)
        keys.append(graphed.graphs.keys())
    assert graphed.graphs.replays == {"i3d": 3}
    shape = ((1, 10, 64, 64, 3), torch.float32)
    assert keys[0] == [("i3d", (), (shape,))]
    assert [[k[2][0][0][1] for k in ks] for ks in keys] == [[10], [10, 8],
                                                            [8, 10]]
    assert graphed.graphs.counts() == {"i3d": 2}


def _pair(seed: int):
    a, b = (torch.from_numpy(v.astype(np.float32) / 255 * 2 - 1)
            for v in _video(2, seed))
    return a[None], b[None]


def test_raft_pair_region_replays_eager(raft):
    """(a, b) Both directions of two pairs through the region (one key:
    the frames' shape and the iterations; captured at the second call)
    equal the eager owner's flows; other iterations are another key."""
    eager = RaftPairFlow(raft, ITERS, torch.device("cpu"))
    graphed = RaftPairFlow(raft, ITERS, torch.device("cpu"))
    graphed.graphs = CountingGraphs(RAFT_PAIR_REGIONS, RAFT_PAIR_REGIONS)
    for seed in (7, 8):
        a, b = _pair(seed)
        for x, y in ((a, b), (b, a)):
            want, got = eager(x, y), graphed(x, y)
            assert got.shape == (64, 64, 2) and np.abs(got).max() > 0
            np.testing.assert_array_equal(got, want)
    assert graphed.graphs.replays == {"raft_pair": 3}
    shape = ((1, 64, 64, 3), torch.float32)
    assert graphed.graphs.keys() == [("raft_pair", (ITERS,), (shape, shape))]
    other = RaftPairFlow(raft, 1, torch.device("cpu"))
    other.graphs = graphed.graphs
    other(*_pair(7))
    assert [k[1] for k in graphed.graphs.keys()] == [(ITERS,), (1,)]


def _direct_flow(net, a, b):
    """RAFT as the CLIs called it before `RaftPairFlow`."""
    with torch.inference_mode(), fp32_numerics():
        return net(a, b, iters=ITERS)[1][0].cpu().numpy()


def _files(root) -> dict:
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.fixture
def graphed_pairs(monkeypatch):
    """`RaftPairFlow` inside the CLIs with its region through the
    stand-ins, counting the replays."""
    made = []

    class Graphed(RaftPairFlow):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.graphs = CountingGraphs(RAFT_PAIR_REGIONS,
                                         RAFT_PAIR_REGIONS)
            made.append(self)

    monkeypatch.setattr(compute_flow, "RaftPairFlow", Graphed)
    return made


def test_compute_flow_files_unchanged(tmp_path, raft, graphed_pairs):
    """(c) `compute_flow` on 3 fixture frames at 64 x 64: its .flo files
    equal those of RAFT called directly, as the CLI did, bit for bit,
    and its graphed run's (the 4 calls: eager, capture, 2 replays)."""
    vdir = tmp_path / "videos" / "clip"
    vdir.mkdir(parents=True)
    for i in range(3):
        shutil.copy(os.path.join(CLIP, "frames", f"{i:05d}.png"), vdir)
    weights = tmp_path / "raft.pth"
    torch.save(raft.state_dict(), weights)
    args = ["--root", str(tmp_path / "videos"), "--height", "64", "--width",
            "64", "--raft_iter", str(ITERS), "--raft_path", str(weights),
            "--device", "cpu", "--save_path"]
    compute_flow.main(args + [str(tmp_path / "graphed")])
    assert graphed_pairs[0].graphs.replays == {"raft_pair": 3}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compute_flow, "RaftPairFlow", RaftPairFlow)
        compute_flow.main(args + [str(tmp_path / "eager")])
    frames = []
    for i in range(3):
        img = cv2.cvtColor(cv2.imread(str(vdir / f"{i:05d}.png")),
                           cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (64, 64), interpolation=cv2.INTER_LINEAR)
        frames.append(torch.from_numpy(img.astype(np.float32) / 255.0 * 2
                                       - 1)[None])
    ref = tmp_path / "direct" / "clip"
    ref.mkdir(parents=True)
    for i in range(2):
        a, b = frames[i], frames[i + 1]
        flowwrite(_direct_flow(raft, a, b),
                  str(ref / f"{i:05d}_{i + 1:05d}_f.flo"), quantize=True)
        flowwrite(_direct_flow(raft, b, a),
                  str(ref / f"{i + 1:05d}_{i:05d}_b.flo"), quantize=True)
    want = _files(tmp_path / "direct")
    assert len(want) == 4
    assert _files(tmp_path / "graphed") == want
    assert _files(tmp_path / "eager") == want


def test_raft_demo_files_unchanged(tmp_path, raft, graphed_pairs):
    """(c) `raft_demo` on 3 fixture frames cropped to 60 x 100 (padded to
    64 x 104): its PNGs and .flo files equal those its eager run and
    RAFT called directly give, its graphed run's too."""
    from propainter_tpu_torch.utils.flow_viz import flow_to_image

    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        im = cv2.imread(os.path.join(CLIP, "frames", f"{i:05d}.png"))
        cv2.imwrite(str(src / f"{i:05d}.png"), im[:60, :100])
    weights = tmp_path / "raft.pth"
    torch.save(raft.state_dict(), weights)
    args = ["--path", str(src), "--iters", str(ITERS), "--save_flo",
            "--weights", str(weights), "--device", "cpu", "--output"]
    raft_demo.main(args + [str(tmp_path / "graphed")])
    assert graphed_pairs[0].graphs.replays == {"raft_pair": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compute_flow, "RaftPairFlow", RaftPairFlow)
        raft_demo.main(args + [str(tmp_path / "eager")])
    ref = tmp_path / "direct"
    ref.mkdir()
    padded = []
    for i in range(3):
        img = cv2.cvtColor(cv2.imread(str(src / f"{i:05d}.png")),
                           cv2.COLOR_BGR2RGB)
        p, (ph, pw) = raft_demo.pad8(img)
        padded.append(torch.from_numpy(p[None].astype(np.float32) / 255.0
                                       * 2 - 1))
    for i in range(2):
        flow = _direct_flow(raft, padded[i], padded[i + 1])
        flow = flow[ph:, pw // 2: flow.shape[1] - (pw - pw // 2)]
        cv2.imwrite(str(ref / f"{i:05d}_flow.png"),
                    cv2.cvtColor(flow_to_image(flow), cv2.COLOR_RGB2BGR))
        flowwrite(flow, str(ref / f"{i:05d}.flo"))
    want = _files(ref)
    assert len(want) == 4
    assert _files(tmp_path / "graphed") == want
    assert _files(tmp_path / "eager") == want


def test_region_defaults():
    """(d) `raft_pair` graphed by default and I3D eager (the card's
    keep-or-drop, PERF.md section 7); on the CPU neither graphs anything;
    unknown region names are refused."""
    def default(owner):
        return inspect.signature(owner).parameters["cuda_graphs"].default

    assert default(RaftPairFlow) == RAFT_PAIR_REGIONS == ("raft_pair",)
    assert default(I3DFeatures) == () and I3D_REGIONS == ("i3d",)
    cpu = torch.device("cpu")
    assert RaftPairFlow(None, ITERS, cpu).graphs.stages == frozenset()
    assert I3DFeatures(None, cpu, cuda_graphs=I3D_REGIONS).graphs.stages \
        == frozenset()
    with pytest.raises(ValueError, match="unknown stages"):
        RaftPairFlow(None, ITERS, cpu, cuda_graphs=("i3d",))
    with pytest.raises(ValueError, match="unknown stages"):
        I3DFeatures(None, cpu, cuda_graphs=("raft_pair",))
