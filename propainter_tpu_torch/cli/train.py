"""Training CLI of the PyTorch port, the flags of `propainter_tpu/cli/train.py`
with `--device` in place of `--platform`:

  python -m propainter_tpu_torch.cli.train -c configs/train_flowcomp.json
  python -m propainter_tpu_torch.cli.train -c configs/train_propainter.json \\
      [--max_iters N] [--device cuda|cpu]

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

One process trains on one device, the config's `trainer.batch_size` at a
time. The JAX CLI's multi-host flags are accepted and raise
NotImplementedError: multi-card training is ROADMAP.md queue 1 item 4.
The default device is the GPU: without one this raises unless --device cpu
is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np

MULTI_CARD = ("multi-card and multi-host training are not ported "
              "(ROADMAP.md, queue 1 item 4): the port trains in one process "
              "on one device")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--max_iters", type=int, default=None,
                   help="override config iterations (for smoke runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    for flag in ("--coordinator_address", "--num_processes", "--process_id",
                 "--local_device_ids"):
        p.add_argument(flag, default=None, help=MULTI_CARD)
    args = p.parse_args(argv)
    if any(getattr(args, f) is not None for f in (
            "coordinator_address", "num_processes", "process_id",
            "local_device_ids")):
        raise NotImplementedError(MULTI_CARD)

    from propainter_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    with open(args.config) as f:
        config = json.load(f)
    save_dir = os.path.join(
        "experiments_model",
        f"{config['model']['net']}_{os.path.basename(args.config)[:-5]}")
    os.makedirs(save_dir, exist_ok=True)
    log = logging.getLogger(__name__)
    log.setLevel(logging.INFO)
    log_file = logging.FileHandler(os.path.join(save_dir, "train.log"))
    log_file.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    log.addHandler(log_file)
    try:
        return _train(args, config, save_dir, device, log)
    finally:
        log.removeHandler(log_file)
        log_file.close()


def _train(args, config: dict, save_dir: str, device, log) -> dict:
    import torch

    from propainter_tpu_torch.checkpoints import TrainCheckpointManager
    from propainter_tpu_torch.cli.inference import load_checkpoint
    from propainter_tpu_torch.core.dataset import (
        PrefetchLoader, TrainDataset, TrainDatasetConfig)
    from propainter_tpu_torch.models.raft import RAFT
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

    latest = ckpt.latest_step()
    if latest is not None:
        ckpt.restore(state)
        print(f"resumed from step {latest}")
    elif trainer_version != "trainer_flow_w_edge":
        # warm start from released checkpoints
        # (reference core/trainer.py:248-268 gen_path / dis_path)
        if model_args.get("gen_path"):
            load_checkpoint(state.gen, model_args["gen_path"])
            print(f"warm-started G from {model_args['gen_path']}")
        if model_args.get("dis_path") and state.dis is not None:
            load_checkpoint(state.dis, model_args["dis_path"])
            print(f"warm-started D from {model_args['dis_path']}")

    save_freq = int(train_args.get("save_freq", 10000))
    log_freq = int(train_args.get("log_freq", 100))
    viz_freq = int(train_args.get("viz_freq", 200))
    loader = PrefetchLoader(dataset, train_args["batch_size"],
                            num_workers=train_args.get("num_workers", 4))
    tb = MetricLogger(os.path.join(save_dir, "logs"))

    t0 = time.time()
    start = state.step
    try:
        for it in range(start, iterations):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in loader.next().items()}
            state, metrics, viz = step_fn(state, batch)
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
            if (it + 1) % save_freq == 0:
                ckpt.save(it + 1, state)
    finally:
        loader.stop()
        tb.close()
    print("End training.")
    return dict(save_dir=save_dir, start=start, iterations=iterations)


if __name__ == "__main__":
    main()
