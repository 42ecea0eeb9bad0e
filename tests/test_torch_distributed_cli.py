"""The port's train CLI on several ranks, on the CPU: two gloo ranks under
torchrun's environment (rank 0 alone writes, each rank loads its own
shard, a resume works on both), the CLI's own rank spawning by the JAX
CLI's device rule, and the JAX CLI's unsharded loader (a fault of the
reference the port does not copy). The ranks are spawns of
tests/torch_dist_worker.py, as in tests/test_torch_distributed.py.
"""

import json
import random

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as worker


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test (pytest-xdist runs this file
    beside other workers; see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The train CLI on two ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """The flow completion stage's CLI layout (tests/test_torch_train_cli
    's fixture at a global batch of 2, 2 steps a save): two videos of 10
    frames at 64 x 96 and a seeded raft-things.pth."""
    import cv2

    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.weights import seeded_init_

    root = tmp_path_factory.mktemp("dist_cli")
    rng = np.random.default_rng(0)
    for v in ("vid0", "vid1"):
        (root / "videos" / v).mkdir(parents=True)
        for i in range(10):
            cv2.imwrite(str(root / "videos" / v / f"{i:05d}.jpg"),
                        rng.integers(0, 255, (64, 96, 3), np.uint8))
    (root / "datasets" / "smoke").mkdir(parents=True)
    (root / "datasets" / "smoke" / "train.json").write_text(
        json.dumps({"vid0": 10, "vid1": 10}))
    torch.save({f"module.{k}": v for k, v in
                seeded_init_(RAFT(), 1).state_dict().items()},
               root / "raft-things.pth")
    config = {
        "seed": 7,
        "train_data_loader": {"name": "smoke", "video_root":
                              str(root / "videos"), "w": 96, "h": 64,
                              "num_local_frames": 3, "num_ref_frames": 1},
        "model": {"net": "recurrent_flow_completion",
                  "raft_path": str(root / "raft-things.pth")},
        "trainer": {"version": "trainer_flow_w_edge", "lr": 5e-5,
                    "batch_size": 2, "num_workers": 1, "log_freq": 1,
                    "viz_freq": 2, "save_freq": 2, "iterations": 700e3,
                    "raft_iters": 2},
    }
    (root / "train_dist.json").write_text(json.dumps(config))
    return root


def test_train_cli_two_ranks_under_torchrun_env(cli_root, tmp_path):
    """The CLI on two gloo ranks under torchrun's environment (global
    batch 2, a sample a rank): 2 steps, then a rerun to 3 that resumes at
    step 2 on both ranks. Rank 0 alone writes: metrics.jsonl holds one
    line a step, train.log one line a step, the checkpoint is the step-2
    triple; each rank's loader is its own shard and draws its stride of
    the epoch's permutation."""
    cfg = str(cli_root / "train_dist.json")
    argvs = [["-c", cfg, "--max_iters", n, "--device", "cpu"]
             for n in ("2", "3")]
    ranks = worker.spawn(tmp_path, "train_cli", group=False, argvs=argvs,
                         rdzv_dir=str(tmp_path), cwd=str(cli_root))()
    for r, res in enumerate(ranks):
        assert [o["start"] for o in res["outs"]] == [0, 2]
        assert res["shards"] == [(r, 2), (r, 2)]
    order = [0, 1]
    random.Random(0).shuffle(order)
    assert [ranks[r]["drawn"][0] for r in (0, 1)] == [[order[0]],
                                                      [order[1]]]
    run = cli_root / ranks[0]["outs"][0]["save_dir"]
    rows = [json.loads(line) for line in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [row["step"] for row in rows] == [1, 2, 3]
    assert all(np.isfinite(row["loss/loss"]) for row in rows)
    log = (run / "train.log").read_text().splitlines()
    assert [line.split()[3] for line in log] == ["1", "2", "3"]
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == [
        "gen_000002.pth", "latest.ckpt", "opt_000002.pth"]


def test_cli_starts_a_rank_per_gpu_by_the_jax_rule(cli_root, monkeypatch,
                                                   capsys):
    """Without a process group and with several GPUs the CLI spawns one
    rank per GPU on the largest GPU count that divides the batch (the
    JAX CLI's rule, printed as it prints it), each under torchrun's
    environment."""
    from propainter_tpu_torch.cli import train

    assert [train.data_parallel_devices(8, n) for n in (1, 2, 3, 4, 8, 16)
            ] == [1, 2, 2, 4, 8, 8]
    spawned = []
    monkeypatch.chdir(cli_root)
    monkeypatch.setattr(train, "_run", lambda *a: pytest.fail("no spawn"))
    monkeypatch.setattr(mp, "start_processes",
                        lambda fn, args, nprocs, start_method:
                        spawned.append((fn, args, nprocs)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    for name in worker.ENV:
        monkeypatch.delenv(name, raising=False)
    argv = ["-c", str(cli_root / "train_dist.json"), "--max_iters", "1"]
    out = train.main(argv)
    assert "using 2/3 devices (batch 2)" in capsys.readouterr().out
    assert out["ranks"] == 2 and len(spawned) == 1
    fn, (world, port, child_argv), nprocs = spawned[0]
    assert fn is train._rank_main and (world, nprocs) == (2, 2)
    assert child_argv == argv


# ---------------------------------------------------------------------------
# A fault of the reference: the JAX CLI's loader is not sharded
# ---------------------------------------------------------------------------


def test_jax_cli_loader_is_unsharded_under_jax_distributed(monkeypatch,
                                                           tmp_path):
    """Under jax.distributed with two processes the JAX CLI gives its
    PrefetchLoader the per-process batch but no shard
    (propainter_tpu/cli/train.py:122-127): num_shards stays 1, so every
    process reads the same samples, against the loader's DistributedSampler
    contract. The port passes rank and world size (test above)."""
    import propainter_tpu.core.dataset as jax_dataset
    from propainter_tpu.cli import train as jax_train

    class Stop(Exception):
        pass

    got = {}

    def loader(dataset, batch_size, num_workers=4, prefetch=4, seed=0,
               shard_index=0, num_shards=1):
        got.update(batch_size=batch_size, shard_index=shard_index,
                   num_shards=num_shards)
        raise Stop

    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: None)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax_dataset, "TrainDataset", lambda cfg: None)
    monkeypatch.setattr(jax_dataset, "PrefetchLoader", loader)
    monkeypatch.chdir(tmp_path)
    cfg = {"trainer": {"version": "trainer_flow_w_edge", "batch_size": 8,
                       "lr": 1e-4, "iterations": 1},
           "train_data_loader": {"name": "x", "video_root": "x",
                                 "num_local_frames": 2, "num_ref_frames": 1,
                                 "w": 32, "h": 32},
           "model": {"net": "flowcomp"}}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    with pytest.raises(Stop):
        jax_train.main(["-c", str(tmp_path / "cfg.json"),
                        "--coordinator_address", "1.2.3.4:999",
                        "--num_processes", "2", "--process_id", "1"])
    assert got == dict(batch_size=4, shard_index=0, num_shards=1)
