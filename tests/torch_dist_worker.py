"""Ranks of tests/test_torch_distributed.py: the functions that
`torch.multiprocessing` spawns, and the seeded models and batches that the
test and its ranks build alike. Imports no JAX, so a rank starts in a few
seconds; not collected by pytest.

`spawn` starts the ranks: each joins a gloo group through a `file://`
rendezvous (or leaves that to the function it runs), runs one function
with one intra-op thread, and saves what it returns as `rank<r>.pt` in
the output directory.

Every wait has a deadline: a rank's rendezvous `RANK_TIMEOUT`, the
caller's wait for the ranks `JOIN_DEADLINE_S`, after which the ranks are
terminated and the test fails instead of hanging.
"""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from propainter_tpu_torch.core import trainer as TT
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.weights import seeded_init_

T, L_T, H, W = 4, 3, 32, 48
# a rank's wait for its peers at a rendezvous, and the caller's wait for
# the ranks to finish: a few times a rank's normal 10-40 s on a loaded
# host, far below the whole suite's limit
RANK_TIMEOUT = datetime.timedelta(seconds=120)
JOIN_DEADLINE_S = 300.0
# what configures a process group (parallel.mesh.maybe_initialize_distributed)
ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
       "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
       "LOCAL_RANK")


def _smooth(rng, shape, lo=-0.8, hi=0.8):
    """(N, ..., H, W, C) smooth random images: 4 x 6 noise upsampled."""
    *lead, h, w, c = shape
    small = torch.from_numpy(rng.uniform(lo, hi, (int(np.prod(lead)), c, 4, 6)
                                         ).astype(np.float32))
    big = torch.nn.functional.interpolate(small, size=(h, w),
                                          mode="bilinear")
    return big.permute(0, 2, 3, 1).reshape(shape).numpy()


def uneven_masks(frames: int) -> np.ndarray:
    """(2, frames, H, W, 1) holes: sample 0 a 4 x 8 block (2% of the
    frame), sample 1 a 20 x 36 block (47%), so a normaliser taken per
    sample or per rank differs from the batch's."""
    m = np.zeros((2, frames, H, W, 1), np.float32)
    m[0, :, 10:14, 12:20] = 1.0
    m[1, :, 6:26, 6:42] = 1.0
    return m


def propainter_batch() -> dict:
    """The global batch of 2 of the ProPainter step (precomputed flows)."""
    rng = np.random.default_rng(8)
    flows = [rng.normal(0, 1, (2, L_T - 1, H, W, 2)).astype(np.float32)
             for _ in range(2)]
    return dict(frames=_smooth(rng, (2, T, H, W, 3)), masks=uneven_masks(T),
                flows_f=flows[0], flows_b=flows[1])


def flow_batch() -> dict:
    """The global batch of 2 of the flow step: smooth flows with a moving
    block, sample 0's at a fifth of the magnitude, so its own peak is
    below 1 (its Canny targets would be empty) while the batch's is
    above."""
    rng = np.random.default_rng(9)
    flows = np.zeros((2, L_T, H, W, 2), np.float32)
    flows[..., 0] = 0.5
    flows[:, :, 6:22, 12:34] = (3.0, -2.0)
    flows += rng.normal(0, 0.05, flows.shape).astype(np.float32)
    flows[0] *= 0.2
    return dict(frames=_smooth(rng, (2, L_T + 1, H, W, 3)),
                masks=uneven_masks(L_T + 1), flows_f=flows,
                flows_b=-flows[:, ::-1].copy())


def models(stage: str) -> dict:
    """The stage's seeded models (fan-in scaled), as tests/test_torch_train
    builds them: the generator at hidden 128, depth 2 with remat, the
    frozen flow completion and the discriminator; or the flow completion
    with remat."""
    if stage == "flow":
        return dict(model=seeded_init_(RecurrentFlowCompleteNet(remat=True),
                                       2, fan_in_scaled=True))
    mods = dict(gen=seeded_init_(InpaintGenerator(hidden=128, depths=2,
                                                  remat=True),
                                 1, fan_in_scaled=True),
                flowcomp=seeded_init_(RecurrentFlowCompleteNet(), 2,
                                      fan_in_scaled=True))
    mods["dis"] = seeded_init_(TT._make_discriminator(
        TT.PropainterTrainConfig(num_local_frames=L_T)), 3,
        fan_in_scaled=True)
    return mods


def state_and_step(stage: str, mods: dict):
    """(state, step) of the stage on the CPU from `mods`, flows
    precomputed."""
    if stage == "flow":
        cfg = TT.FlowTrainConfig(num_local_frames=L_T + 1)
        return (TT.init_flow_state(cfg, None, model=mods["model"],
                                   device="cpu"),
                TT.make_flow_train_step(cfg, use_precomputed_flows=True))
    cfg = TT.PropainterTrainConfig(num_local_frames=L_T)
    return (TT.init_propainter_state(cfg, None, mods["flowcomp"],
                                     gen=mods["gen"], dis=mods["dis"],
                                     device="cpu"),
            TT.make_propainter_train_step(cfg, use_precomputed_flows=True))


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def train_step(rank: int, world: int, stage: str) -> dict:
    """One step of the stage on this rank's shard of the global batch:
    the metrics, each trained model's gradients (averaged over the ranks)
    and its state after the step."""
    mods = models(stage)
    if rank:  # rank 0's weights must reach the others by broadcast
        for m in mods.values():
            seeded_init_(m, 99 + rank)
    state, step = state_and_step(stage, mods)
    batch = propainter_batch() if stage == "propainter" else flow_batch()
    per = 2 // world
    shard = {k: torch.from_numpy(np.ascontiguousarray(
        v[rank * per:(rank + 1) * per])) for k, v in batch.items()}
    _, metrics, _ = step(state, shard)
    trained = ("model",) if stage == "flow" else ("gen", "dis")
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: _numpy({k: p.grad for k, p in mods[n].named_parameters()
                          if p.grad is not None}) for n in trained},
        after={n: _numpy(mods[n].state_dict()) for n in trained})


def train_cli(rank: int, world: int, argvs: list, rdzv_dir: str,
              cwd: str) -> dict:
    """The train CLI under torchrun's environment, once per argv (it
    makes its own process group each time); the shards this rank's
    loaders were given and the indices they drew.

    Each call gets a store of its own: rank 0 hosts it on a port the OS
    picks and publishes the port in `rdzv_dir` only once its previous
    call has returned; the CLI's env:// rendezvous on rank 0 reuses the
    store (torch's TCPStore server is multi-tenant per process and port),
    so no port is chosen, released and bound again, and no call meets the
    keys of another call's rendezvous."""
    import propainter_tpu_torch.core.dataset as dataset
    from propainter_tpu_torch.cli import train

    drawn, shards = [], []

    class Recorder(dataset.PrefetchLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            shards.append((self.shard_index, self.num_shards))

        def _next_indices(self):
            idxs = super()._next_indices()
            drawn.append(idxs)
            return idxs

    dataset.PrefetchLoader = Recorder
    os.environ.update(MASTER_ADDR="localhost", RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    os.chdir(cwd)
    outs = []
    for i, argv in enumerate(argvs):
        store = None
        if rank == 0:
            store = dist.TCPStore("localhost", 0, world, True,
                                  timeout=RANK_TIMEOUT, multi_tenant=True,
                                  wait_for_workers=False)
            _publish(rdzv_dir, f"port{i}", store.port)
        os.environ["MASTER_PORT"] = str(
            store.port if store is not None
            else _await(rdzv_dir, f"port{i}"))
        outs.append(train.main(argv))
        del store
    return dict(outs=outs, shards=shards, drawn=drawn)


def _publish(directory: str, name: str, value: int) -> None:
    tmp = os.path.join(directory, f".{name}.tmp")
    with open(tmp, "w") as f:
        f.write(str(value))
    os.replace(tmp, os.path.join(directory, name))


def _await(directory: str, name: str) -> int:
    """The value `_publish` wrote, waiting up to RANK_TIMEOUT for it."""
    path = os.path.join(directory, name)
    deadline = time.monotonic() + RANK_TIMEOUT.total_seconds()
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written within {RANK_TIMEOUT}")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def run(rank: int, world: int, init_file: str | None, out_dir: str, fn: str,
        kwargs: dict) -> None:
    """A spawned rank: join the gloo group at `init_file` (None: `fn`
    makes its own), run `fn`, save its result."""
    torch.set_num_threads(1)
    if init_file is not None:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=RANK_TIMEOUT)
    try:
        result = globals()[fn](rank, world, **kwargs)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(tmp_path, fn: str, world: int = 2, group: bool = True,
          **kwargs):
    """Start `run` on `world` spawned ranks; returns a function that
    waits for them and gives each rank's result (so the caller's JAX
    oracle can compile meanwhile)."""
    out = tmp_path / f"out_{fn}"
    out.mkdir()
    init = str(tmp_path / f"init_{fn}") if group else None
    ctx = mp.start_processes(run, args=(world, init, str(out), fn, kwargs),
                             nprocs=world, join=False, start_method="spawn")

    def results() -> list:
        deadline = time.monotonic() + JOIN_DEADLINE_S
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise AssertionError(f"{fn}: the ranks did not finish "
                                     f"within {JOIN_DEADLINE_S:.0f} s")
        return [torch.load(out / f"rank{r}.pt", weights_only=False)
                for r in range(world)]

    return results


