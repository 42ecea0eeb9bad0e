"""The port's training CLI (`propainter_tpu_torch.cli.train`) on the CPU, as
a user runs it: the JAX CLI's config layout over a synthetic
YouTube-VOS-layout dataset, seeded RAFT and flow completion checkpoints in
the released layout, two steps of each stage, then a rerun that resumes
from the checkpoint; the ProPainter stage warm-started from gen_path and
dis_path. Without a GPU the default device raises, and a global batch
that does not divide over the ranks raises. (Training on several ranks:
tests/test_torch_distributed.py.)"""

import json

import numpy as np
import pytest
import torch

from propainter_tpu_torch.cli import train
from propainter_tpu_torch.models.discriminator import Discriminator
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.weights import seeded_init_

H, W = 64, 96


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test (pytest-xdist runs this file
    beside other workers; see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """Two videos of 14 JPEG frames, datasets/smoke/train.json, and seeded
    raft-things.pth (under DataParallel's `module.`),
    recurrent_flow_completion.pth, gen.pth and dis.pth."""
    import cv2

    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    names = {}
    for v in ("vid0", "vid1"):
        (root / "videos" / v).mkdir(parents=True)
        for i in range(14):
            cv2.imwrite(str(root / "videos" / v / f"{i:05d}.jpg"),
                        rng.integers(0, 255, (H, W, 3), np.uint8))
        names[v] = 14
    (root / "datasets" / "smoke").mkdir(parents=True)
    (root / "datasets" / "smoke" / "train.json").write_text(json.dumps(names))
    raft = seeded_init_(RAFT(), 1).state_dict()
    torch.save({f"module.{k}": v for k, v in raft.items()},
               root / "raft-things.pth")
    for name, module, seed in (
            ("recurrent_flow_completion.pth", RecurrentFlowCompleteNet(), 2),
            ("gen.pth", InpaintGenerator(), 3), ("dis.pth", Discriminator(), 4)):
        torch.save(seeded_init_(module, seed).state_dict(), root / name)
    return root


def _config(root, stage: str) -> str:
    flow = stage == "flowcomp"
    model = ({"net": "recurrent_flow_completion"} if flow else
             {"net": "propainter", "no_dis": 0, "interp_mode": "nearest",
              "flowcomp_path": str(root / "recurrent_flow_completion.pth"),
              "gen_path": str(root / "gen.pth"),
              "dis_path": str(root / "dis.pth")})
    model["raft_path"] = str(root / "raft-things.pth")
    config = {
        "seed": 7,
        "train_data_loader": {"name": "smoke", "video_root":
                              str(root / "videos"), "w": W, "h": H,
                              "num_local_frames": 4,
                              "num_ref_frames": 1 if flow else 2,
                              "load_flow": 0},
        "losses": {"flow_weight": 0.25} if flow else {
            "hole_weight": 1, "valid_weight": 1, "adversarial_weight": 0.01,
            "GAN_LOSS": "hinge", "perceptual_weight": 0},
        "model": model,
        "trainer": {"version": "trainer_flow_w_edge" if flow else "trainer",
                    "lr": 5e-5 if flow else 1e-4, "batch_size": 1,
                    "num_workers": 1, "log_freq": 1, "viz_freq": 2,
                    "save_freq": 2, "iterations": 700e3, "raft_iters": 2},
    }
    path = root / f"train_{stage}_smoke.json"
    path.write_text(json.dumps(config))
    return str(path)


@pytest.mark.parametrize("stage", ["flowcomp", "propainter"])
def test_train_cli_two_steps_then_resumes(stage, train_root, monkeypatch,
                                          capsys):
    """Two steps write train.log, metrics.jsonl (one finite line a step)
    and the step-2 checkpoint in the reference's layout; a rerun with
    --max_iters 3 resumes at step 2 and writes step 3."""
    monkeypatch.chdir(train_root)
    cfg = _config(train_root, stage)
    out = train.main(["-c", cfg, "--max_iters", "2", "--device", "cpu"])
    assert out["start"] == 0 and out["iterations"] == 2
    run = train_root / out["save_dir"]
    assert run.name == ("recurrent_flow_completion" if stage == "flowcomp"
                        else "propainter") + f"_train_{stage}_smoke"
    ckpt = run / "ckpt"
    assert (ckpt / "latest.ckpt").read_text().strip() == "2"
    kinds = {"gen", "opt"} | ({"dis"} if stage == "propainter" else set())
    assert {p.name for p in ckpt.glob("*_000002.pth")} == {
        f"{k}_000002.pth" for k in kinds}
    if stage == "propainter":
        assert "warm-started G" in capsys.readouterr().out
    out = train.main(["-c", cfg, "--max_iters", "3", "--device", "cpu"])
    assert out["start"] == 2
    assert "resumed from step 2" in capsys.readouterr().out
    lines = [json.loads(line) for line in
             (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [line["step"] for line in lines] == [1, 2, 3]
    key = "loss/loss" if stage == "flowcomp" else "loss/gen_loss"
    assert all(np.isfinite(line[key]) for line in lines)
    assert (run / "train.log").exists()


def test_train_cli_guards(train_root, monkeypatch):
    """The default device is the GPU: without one the CLI raises rather
    than training on the CPU. The JAX CLI's multi-host flags reach the
    process group (gloo on the CPU), and a global batch of 1 over 2 ranks
    raises with the JAX CLI's message before any training."""
    import torch.distributed as dist

    from propainter_tpu_torch.parallel import mesh

    monkeypatch.chdir(train_root)
    cfg = _config(train_root, "flowcomp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["-c", cfg, "--max_iters", "1"])
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    with pytest.raises(ValueError,
                       match="global batch 1 must divide over 2 processes"):
        train.main(["-c", cfg, "--coordinator_address", "localhost:1",
                    "--num_processes", "2", "--process_id", "0",
                    "--device", "cpu"])
    assert calls == [dict(backend="gloo", init_method="tcp://localhost:1",
                          world_size=2, rank=0)]
