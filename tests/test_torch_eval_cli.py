"""The PyTorch port's evaluation CLIs (`evaluate`, `evaluate_flow_completion`,
`compute_flow`, `raft_demo`) on the CPU through their argparse main(), as
a user runs them, on the fixture clip `assets/demo_clip` at tiny sizes.
Seeded checkpoints in the released `.pth` layout feed both the port and
the JAX CLIs, whose outputs the port's are held to. The JAX `evaluate`
is not run here (78 s on the CPU): the pipeline it drives under the
evaluation protocol (`unchunked`, `raft_clip_len`) is held to the JAX
pipeline by tests/test_torch_pipeline.py, and the evaluation's metrics
are recomputed here with the JAX package's functions.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from propainter_tpu.core import metrics as jax_metrics
from propainter_tpu.core.dataset import TestDataset as JaxTestDataset

from propainter_tpu_torch.cli import (compute_flow, evaluate,
                                      evaluate_flow_completion, raft_demo)
from propainter_tpu_torch.cli.inference import CHECKPOINTS
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.i3d import InceptionI3d
from propainter_tpu_torch.models.layers import FrozenBatchNorm
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.utils.flow_io import flowread
from propainter_tpu_torch.weights import seeded_init_

CLIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo_clip")


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
def weights(tmp_path_factory):
    """The three released checkpoint files of seeded weights (RAFT's keys
    with its DataParallel `module.` prefix, as raft-things.pth has them),
    and a seeded i3d_rgb_imagenet.pt with a `logits.*` head; batch-norm
    scales U(0.5, 1.5) keep I3D's features O(1) through its 57 layers."""
    root = tmp_path_factory.mktemp("weights")
    for seed, (name, module) in enumerate((
            ("raft", RAFT()), ("flowcomp", RecurrentFlowCompleteNet()),
            ("inpaint", InpaintGenerator()))):
        sd = seeded_init_(module, 30 + seed).state_dict()
        if name == "raft":
            sd = {"module." + k: v for k, v in sd.items()}
        torch.save(sd, root / CHECKPOINTS[name])
    i3d = seeded_init_(InceptionI3d(), 33, fan_in_scaled=True)
    gen = torch.Generator().manual_seed(33)
    for child in i3d.modules():
        if isinstance(child, FrozenBatchNorm):
            child.weight.data.uniform_(0.5, 1.5, generator=gen)
    sd = dict(i3d.state_dict())
    sd["logits.conv3d.weight"] = torch.zeros(400, 1024, 1, 1, 1)
    sd["logits.conv3d.bias"] = torch.zeros(400)
    torch.save(sd, root / "i3d_rgb_imagenet.pt")
    return root


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two videos in the DAVIS layout with a test.json: the fixture clip
    and its first 6 frames (VFID needs two videos: the covariance of one
    is undefined)."""
    root = tmp_path_factory.mktemp("eval_ds")
    for name, n in (("clip", 12), ("clip_short", 6)):
        for kind in ("frames", "masks"):
            dst = root / ("videos" if kind == "frames" else "masks") / name
            dst.mkdir(parents=True)
            for f in sorted(os.listdir(os.path.join(CLIP, kind)))[:n]:
                shutil.copy(os.path.join(CLIP, kind, f), dst)
    with open(root / "test.json", "w") as f:
        json.dump({"clip": 12, "clip_short": 6}, f)
    return root


def _dataset_args(ds):
    return ["--video_root", str(ds / "videos"), "--mask_root",
            str(ds / "masks"), "--json_path", str(ds / "test.json")]


def _flo_close(got, want):
    """Within one fp16 step of the larger value (the files' fp16 payload
    rounds a flow that moved across a step) + 1e-3 px."""
    step = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(
        np.float16)).astype(np.float32)
    np.testing.assert_array_less(np.abs(got - want), step + 1e-3)


def test_evaluate_flow_completion_matches_jax_cli(dataset, weights,
                                                  monkeypatch):
    """`avg epe` of the port (1 video, 64 x 96, raft_iter 2) within 1e-3
    relative of the JAX CLI's on the same checkpoints; the JAX value is
    recorded unrounded from its `calculate_epe` calls."""
    from propainter_tpu.cli.evaluate_flow_completion import main as jax_main

    args = [*_dataset_args(dataset), "--height", "64", "--width", "96",
            "--raft_iter", "2", "--max_videos", "1", "--weights",
            str(weights)]
    got = evaluate_flow_completion.main(args + ["--device", "cpu"])
    epes = []

    def record(a, b):
        epes.append(calc(a, b))
        return epes[-1]

    calc = jax_metrics.calculate_epe
    monkeypatch.setattr(jax_metrics, "calculate_epe", record)
    jax_main(args)
    want = (epes[0] + epes[1]) / 2
    assert len(epes) == 2 and np.isfinite(want) and want > 0
    assert got["epe"] == pytest.approx(want, rel=1e-3)


def test_compute_flow_matches_jax_cli(tmp_path, weights):
    """`compute_flow`'s fp16 .flo files (3 frames at 128 x 128, raft_iter
    2) within one fp16 step + 1e-3 px of the JAX CLI's on the same
    raft-things.pth, with the reference's names."""
    from propainter_tpu.cli.compute_flow import main as jax_main

    vdir = tmp_path / "videos" / "clip"
    vdir.mkdir(parents=True)
    for i in range(3):
        shutil.copy(os.path.join(CLIP, "frames", f"{i:05d}.png"), vdir)
    args = ["--root", str(tmp_path / "videos"), "--height", "128",
            "--width", "128", "--raft_iter", "2", "--raft_path",
            str(weights / CHECKPOINTS["raft"])]
    compute_flow.main(args + ["--save_path", str(tmp_path / "port"),
                              "--device", "cpu"])
    jax_main(args + ["--save_path", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax" / "clip"))
    assert names == ["00000_00001_f.flo", "00001_00000_b.flo",
                     "00001_00002_f.flo", "00002_00001_b.flo"]
    assert sorted(os.listdir(tmp_path / "port" / "clip")) == names
    for n in names:
        got = flowread(str(tmp_path / "port" / "clip" / n))
        assert got.shape == (128, 128, 2) and np.abs(got).max() > 0.1
        _flo_close(got, flowread(str(tmp_path / "jax" / "clip" / n)))


def test_raft_demo_matches_jax_cli(tmp_path, weights):
    """`raft_demo` on 3 frames cropped to 60 x 100 (padded to 64 x 104 and
    cropped back): the .flo files within one fp16 step + 1e-3 px of the JAX
    CLI's on the same raft-things.pth, the colour PNGs within 1 LSB."""
    import cv2

    from propainter_tpu.cli.raft_demo import main as jax_main

    src = tmp_path / "frames"
    src.mkdir()
    for i in range(3):
        im = cv2.imread(os.path.join(CLIP, "frames", f"{i:05d}.png"))
        cv2.imwrite(str(src / f"{i:05d}.png"), im[:60, :100])
    args = ["--path", str(src), "--iters", "2", "--save_flo", "--weights",
            str(weights / CHECKPOINTS["raft"])]
    raft_demo.main(args + ["--output", str(tmp_path / "port"),
                           "--device", "cpu"])
    jax_main(args + ["--output", str(tmp_path / "jax")])
    for stem in ("00000", "00001"):
        got = flowread(str(tmp_path / "port" / f"{stem}.flo"))
        assert got.shape == (60, 100, 2)
        _flo_close(got, flowread(str(tmp_path / "jax" / f"{stem}.flo")))
        png = [cv2.imread(str(tmp_path / d / f"{stem}_flow.png")).astype(int)
               for d in ("port", "jax")]
        assert np.abs(png[0] - png[1]).max() <= 1


def test_evaluate_cli(dataset, weights, tmp_path):
    """`evaluate` on the port (2 videos, 96 x 128, raft_iter 2,
    neighbor_length 4, a seeded I3D checkpoint, --save_results
    --warp_error): the metrics file has the JAX CLI's lines in its order,
    and its psnr / ssim equal the JAX package's `calc_psnr_and_ssim` over
    the saved frames and the JAX `TestDataset`'s ground truth to 1e-9."""
    import cv2

    out = tmp_path / "results_eval"
    res = evaluate.main([
        *_dataset_args(dataset), "--height", "96", "--width", "128",
        "--raft_iter", "2", "--neighbor_length", "4", "--weights",
        str(weights), "--i3d_path", str(weights / "i3d_rgb_imagenet.pt"),
        "--save_results", "--warp_error", "--output", str(out),
        "--device", "cpu"])
    mtxt = out / "davis_rs_10_nl_4" / "davis_metrics.txt"
    lines = mtxt.read_text().strip().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == [
        "task", "videos", "avg s/frame", "psnr", "ssim", "ewarp", "vfid"]
    metrics = dict(ln.split(": ") for ln in lines)
    assert metrics["task"] == "video_completion" and metrics["videos"] == "2"
    for k in ("avg s/frame", "psnr", "ssim", "ewarp", "vfid"):
        assert np.isfinite(float(metrics[k])), k
        assert float(metrics[k]) == pytest.approx(res["metrics"][k],
                                                  abs=1e-4), k
    assert res["metrics"]["ewarp"] > 0 and res["metrics"]["vfid"] > 0

    gt_set = JaxTestDataset(str(dataset / "videos"), str(dataset / "masks"),
                            str(dataset / "test.json"), w=128, h=96)
    scores = []
    for i in range(2):
        item = gt_set[i]
        saved = sorted((out / "davis_rs_10_nl_4" / item["video_name"]).glob(
            "*.png"))
        assert len(saved) == len(item["frames"])
        scores += [jax_metrics.calc_psnr_and_ssim(
            g.astype(np.float64),
            cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB).astype(
                np.float64)) for g, p in zip(item["frames"], saved)]
    assert res["metrics"]["psnr"] == pytest.approx(
        np.mean([s[0] for s in scores]), abs=1e-9)
    assert res["metrics"]["ssim"] == pytest.approx(
        np.mean([s[1] for s in scores]), abs=1e-9)


@pytest.mark.parametrize("cli", [evaluate, evaluate_flow_completion,
                                 compute_flow, raft_demo],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_cli_needs_a_gpu_by_default(cli, dataset, weights, tmp_path):
    """Without --device cpu each CLI runs on the GPU, and without one it
    raises before doing any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    args = {
        evaluate: [*_dataset_args(dataset), "--weights", str(weights),
                   "--output", str(tmp_path)],
        evaluate_flow_completion: [*_dataset_args(dataset), "--weights",
                                   str(weights)],
        compute_flow: ["--root", str(dataset / "videos"), "--save_path",
                       str(tmp_path), "--raft_path",
                       str(weights / CHECKPOINTS["raft"])],
        raft_demo: ["--path", str(dataset / "videos" / "clip"), "--output",
                    str(tmp_path), "--weights", "random"],
    }[cli]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args)
