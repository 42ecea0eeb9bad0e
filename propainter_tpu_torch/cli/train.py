"""Training CLI of the PyTorch port, the flags of `propainter_tpu/cli/train.py`
with `--device` in place of `--platform`:

  python -m propainter_tpu_torch.cli.train -c configs/train_flowcomp.json
  python -m propainter_tpu_torch.cli.train -c configs/train_propainter.json \\
      [--max_iters N] [--device cuda|cpu]
  torchrun --nproc_per_node N -m propainter_tpu_torch.cli.train -c ...

The config files are the JAX CLI's. Run from the directory that holds
`datasets/<train_data_loader.name>/train.json`; the frames are under
`train_data_loader.video_root`. Writes under
`experiments_model/<model.net>_<config name>/`: `train.log`,
`logs/metrics.jsonl` (and TensorBoard events where
`torch.utils.tensorboard` imports), and checkpoints under `ckpt/`
(`checkpoints.TrainCheckpointManager`) every `trainer.save_freq`
iterations; a rerun resumes from the latest. Without a checkpoint, the
ProPainter stage warm-starts the generator and discriminator from
`model.gen_path` / `model.dis_path` (the reference's .pth files) when
given. The frozen networks load from `model.raft_path` and
`model.flowcomp_path`, RAFT's DataParallel `module.` prefix stripped.

Data parallelism: `trainer.batch_size` is the global batch, which must
divide over the ranks; each rank is one process on one device, loads
`batch_size / ranks` samples a step from its own stride of each epoch's
permutation, and the steps average their gradients
(`core/trainer.py`). Ranks come from `torchrun`'s environment, from
JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS, or from the JAX CLI's
flags (`--coordinator_address host:port --num_processes N --process_id
i [--local_device_ids g]`; `parallel.mesh.maybe_initialize_distributed`).
Without them, on a machine with several GPUs, the CLI starts one rank
per GPU on the largest number of GPUs that divides the batch (the JAX
CLI's device count); with one GPU it trains in this process. Only rank
0 writes logs and checkpoints; every rank resumes from the same
checkpoint. The default device is the GPU: without one this raises
unless --device cpu is given (gloo ranks on the CPU).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np


def _parse(argv):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--max_iters", type=int, default=None,
                   help="override config iterations (for smoke runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # multi-process bootstrap, the JAX CLI's flags (reference core/dist.py
    # env discovery + train.py:41-45 init_process_group)
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0 for torch.distributed; also "
                        "honors JAX_COORDINATOR_ADDRESS and torchrun's "
                        "environment")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--local_device_ids", type=str, default=None,
                   help="this rank's GPU index")
    return p.parse_args(argv)


def data_parallel_devices(batch_size: int, avail: int) -> int:
    """The JAX CLI's device count: the largest one that divides the
    global batch, at most `avail` (propainter_tpu/cli/train.py:93-106)."""
    return next(n for n in range(min(avail, batch_size), 0, -1)
                if batch_size % n == 0)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)

    import torch
    import torch.distributed as dist

    from propainter_tpu_torch.device import resolve_device
    from propainter_tpu_torch.parallel import mesh

    device = resolve_device(args.device)
    with open(args.config) as f:
        config = json.load(f)
    distributed = mesh.maybe_initialize_distributed(
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id,
        local_device_ids=args.local_device_ids, device=device.type)
    try:
        batch_size = config["trainer"]["batch_size"]
        if distributed:
            n_proc = mesh.world_size()
            if mesh.is_main():
                print(f"torch.distributed initialized: {n_proc} ranks",
                      flush=True)
        elif device.type == "cuda" and torch.cuda.device_count() > 1:
            avail = torch.cuda.device_count()
            n_dev = data_parallel_devices(batch_size, avail)
            if n_dev != avail:
                print(f"using {n_dev}/{avail} devices (batch {batch_size})")
            if n_dev > 1:
                return _spawn_ranks(n_dev, argv, config, args.config)
            n_proc = 1
        else:
            n_proc = 1
        if batch_size % n_proc:
            raise ValueError(f"global batch {batch_size} must divide over "
                             f"{n_proc} processes")
        return _run(args, config, device, batch_size // n_proc)
    finally:
        if distributed:
            dist.destroy_process_group()


def _save_dir(config: dict, config_path: str) -> str:
    return os.path.join(
        "experiments_model",
        f"{config['model']['net']}_{os.path.basename(config_path)[:-5]}")


def _rank_main(local_rank: int, world: int, port: int, argv: list) -> None:
    """One spawned rank: torchrun's environment, then `main`."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world))
    main(argv)


def _spawn_ranks(n_dev: int, argv: list, config: dict,
                 config_path: str) -> dict:
    """Train on GPUs 0..n_dev-1, one spawned process each, and wait."""
    import torch.multiprocessing as mp

    from propainter_tpu_torch.parallel.mesh import free_port

    mp.start_processes(_rank_main, args=(n_dev, free_port(), argv),
                       nprocs=n_dev, start_method="spawn")
    return dict(save_dir=_save_dir(config, config_path), ranks=n_dev)


def _run(args, config: dict, device, rank_batch: int) -> dict:
    """Train in this process, rank 0 logging to train.log."""
    from propainter_tpu_torch.parallel import mesh

    save_dir = _save_dir(config, args.config)
    log = logging.getLogger(__name__)
    log.setLevel(logging.INFO)
    log_file = None
    if mesh.is_main():
        os.makedirs(save_dir, exist_ok=True)
        log_file = logging.FileHandler(os.path.join(save_dir, "train.log"))
        log_file.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        log.addHandler(log_file)
    try:
        return _train(args, config, save_dir, device, log, rank_batch)
    finally:
        if log_file is not None:
            log.removeHandler(log_file)
            log_file.close()


def _train(args, config: dict, save_dir: str, device, log,
           rank_batch: int) -> dict:
    import torch

    from propainter_tpu_torch.checkpoints import TrainCheckpointManager
    from propainter_tpu_torch.cli.inference import load_checkpoint
    from propainter_tpu_torch.core.dataset import (
        PrefetchLoader, TrainDataset, TrainDatasetConfig)
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.parallel import mesh
    from propainter_tpu_torch.utils.flow_viz import flow_to_image
    from propainter_tpu_torch.utils.tb import MetricLogger

    trainer_version = config["trainer"]["version"]
    train_args = config["trainer"]
    data_args = config["train_data_loader"]
    model_args = config["model"]
    ds_cfg = TrainDatasetConfig(
        video_root=data_args["video_root"],
        json_path=os.path.join("datasets", data_args["name"], "train.json"),
        flow_root=data_args.get("flow_root"),
        num_local_frames=data_args["num_local_frames"],
        num_ref_frames=data_args["num_ref_frames"],
        w=data_args["w"], h=data_args["h"],
        load_flow=data_args.get("load_flow", False),
    )
    dataset = TrainDataset(ds_cfg)
    torch.manual_seed(config.get("seed", 2023))
    iterations = args.max_iters or int(train_args["iterations"])
    ckpt = TrainCheckpointManager(os.path.join(save_dir, "ckpt"))
    raft = load_checkpoint(RAFT(), model_args.get(
        "raft_path", "weights/raft-things.pth"))
    raft_iters = int(train_args.get("raft_iters", 20))

    if trainer_version == "trainer_flow_w_edge":
        from propainter_tpu_torch.core.trainer import (
            FlowTrainConfig, init_flow_state, make_flow_train_step)

        tcfg = FlowTrainConfig(num_local_frames=ds_cfg.num_local_frames,
                               lr=train_args["lr"])
        state = init_flow_state(tcfg, raft, device=device)
        step_fn = make_flow_train_step(
            tcfg, raft_iters=raft_iters,
            use_precomputed_flows=ds_cfg.load_flow)
    else:
        from propainter_tpu_torch.core.trainer import (
            PropainterTrainConfig, init_propainter_state,
            make_propainter_train_step)
        from propainter_tpu_torch.models.flow_completion import (
            RecurrentFlowCompleteNet)

        flowcomp = load_checkpoint(RecurrentFlowCompleteNet(), model_args.get(
            "flowcomp_path", "weights/recurrent_flow_completion.pth"))
        losses = config.get("losses", {})
        tcfg = PropainterTrainConfig(
            num_local_frames=ds_cfg.num_local_frames,
            lr=train_args["lr"],
            hole_weight=losses.get("hole_weight", 1.0),
            valid_weight=losses.get("valid_weight", 1.0),
            adversarial_weight=losses.get("adversarial_weight", 0.01),
            perceptual_weight=losses.get("perceptual_weight", 0.0),
            gan_type=losses.get("GAN_LOSS", "hinge"),
            use_discriminator=not model_args.get("no_dis", False),
            dis_2d=model_args.get("dis_2d", False))
        lpips = None
        if tcfg.perceptual_weight > 0:
            # reference core/trainer.py:66-69 gates LPIPS the same way
            from propainter_tpu_torch.models.vgg import (
                LPIPSVgg, lpips_state_dict)

            lpips = LPIPSVgg()
            lpips.load_state_dict(lpips_state_dict(*(
                torch.load(model_args[k], map_location="cpu",
                           weights_only=True)
                for k in ("lpips_path", "vgg16_path"))))
            lpips.to(device)
        state = init_propainter_state(tcfg, raft, flowcomp, device=device)
        step_fn = make_propainter_train_step(
            tcfg, raft_iters=raft_iters,
            use_precomputed_flows=ds_cfg.load_flow, lpips=lpips)

    main_rank = mesh.is_main()
    latest = ckpt.latest_step()
    if latest is not None:
        ckpt.restore(state)
        if main_rank:
            print(f"resumed from step {latest}")
    elif trainer_version != "trainer_flow_w_edge":
        # warm start from released checkpoints, on every rank
        # (reference core/trainer.py:248-268 gen_path / dis_path)
        if model_args.get("gen_path"):
            load_checkpoint(state.gen, model_args["gen_path"])
            if main_rank:
                print(f"warm-started G from {model_args['gen_path']}")
        if model_args.get("dis_path") and state.dis is not None:
            load_checkpoint(state.dis, model_args["dis_path"])
            if main_rank:
                print(f"warm-started D from {model_args['dis_path']}")

    save_freq = int(train_args.get("save_freq", 10000))
    log_freq = int(train_args.get("log_freq", 100))
    viz_freq = int(train_args.get("viz_freq", 200))
    # this rank's stride of each epoch's permutation (DistributedSampler
    # semantics; the JAX CLI passes no shard and every process reads the
    # same samples, ROADMAP.md section 3)
    loader = PrefetchLoader(dataset, rank_batch,
                            num_workers=train_args.get("num_workers", 4),
                            shard_index=mesh.rank(),
                            num_shards=mesh.world_size())
    # the steps' metrics are the ranks' means: rank 0 logs them
    tb = MetricLogger(os.path.join(save_dir, "logs")) if main_rank else None

    t0 = time.time()
    start = state.step
    try:
        for it in range(start, iterations):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in loader.next().items()}
            state, metrics, viz = step_fn(state, batch)
            if (it + 1) % save_freq == 0:
                ckpt.save(it + 1, state)
            if not main_rank:
                continue
            for k, v in metrics.items():
                tb.add(f"loss/{k}", v)
            if (it + 1) % log_freq == 0:
                m = tb.flush_scalars(it + 1)
                rate = (it + 1 - start) / (time.time() - t0)
                log.info("iter %d %s %.2f it/s", it + 1, m, rate)
                print(f"[{it + 1}/{iterations}] "
                      f"{ {k: round(v, 4) for k, v in m.items()} } "
                      f"({rate:.2f} it/s)", flush=True)
            if (it + 1) % viz_freq == 0:
                # image / flow grids (reference core/trainer.py:449-478)
                v = {k: x.cpu().numpy() for k, x in viz.items()}
                for key in ("comp_local", "masked_local", "gt_local"):
                    if key in v:
                        tb.add_images(f"img/{key}", (v[key][0] + 1) / 2,
                                      it + 1)
                for key in ("pred_flow_f", "gt_flow_f"):
                    if key in v:
                        tb.add_images(f"flow/{key}",
                                      flow_to_image(v[key][0]), it + 1)
                if "pred_edge_f" in v:
                    tb.add_images("img/pred_edge_f",
                                  np.repeat(v["pred_edge_f"][0], 3, -1),
                                  it + 1)
    finally:
        loader.stop()
        if tb is not None:
            tb.close()
    if main_rank:
        print("End training.")
    return dict(save_dir=save_dir, start=start, iterations=iterations)


if __name__ == "__main__":
    main()
