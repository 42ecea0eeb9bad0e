"""The spread of the 40-step overfit's loss ratio (`chip_smoke.py`'s
`_train_overfit`: the mean of the last 5 gen_loss values over the first
5's), for the port's ProPainter step or the JAX package's, over runs
whose generator weights differ by a relative 1e-6 (run 0: unchanged).
Each run starts from the same weights and batch in both; only rounding
and chaos separate the runs. Not collected by pytest; run by hand:

    JAX_PLATFORMS=cpu python tests/overfit_spread.py --impl jax \\
        --lr 3e-4 1e-4 --runs 9
    python tests/overfit_spread.py --impl torch --device cpu \\
        --lr 3e-4 1e-4 --runs 9
    python tests/overfit_spread.py --impl torch --device cuda \\
        --lr 3e-4 1e-4 --runs 6 --out chiprun_out/overfit_spread.json

The last line is a JSON object: {lr: [ratio of each run]}.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _perturbed(mods: dict, run: int) -> dict:
    """A copy of mods whose generator weights are scaled by 1 + 1e-6 x
    N(0, 1) from seed 1000 + run (run 0: an unchanged copy)."""
    import copy

    import torch

    out = {k: copy.deepcopy(v) for k, v in mods.items()}
    if run:
        g = torch.Generator().manual_seed(1000 + run)
        with torch.no_grad():
            for p in out["trainee"].parameters():
                noise = torch.randn(p.shape, generator=g).to(p.device)
                p.mul_(1 + 1e-6 * noise)
    return out


def _jax_losses(batch: dict, mods: dict, lr: float) -> list:
    """The JAX package's jitted step from the same weights and batch."""
    import jax
    import jax.numpy as jnp

    from propainter_tpu.core import trainer as JT
    from propainter_tpu.models.flow_completion import (
        convert_flowcomp_state_dict)
    from propainter_tpu.models.propainter import convert_inpaint_state_dict

    def tree(module, convert):
        sd = {k: v.detach().cpu().clone()
              for k, v in module.state_dict().items()}
        return jax.tree.map(jnp.asarray, convert(sd))

    cfg = JT.PropainterTrainConfig(num_local_frames=chip_smoke.OVERFIT_L_T,
                                   use_discriminator=False, lr=lr)
    gen = tree(mods["trainee"], convert_inpaint_state_dict)
    tx = JT.make_optimizer(cfg.lr, cfg.milestones)
    state = JT.PropainterTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen, gen_opt=tx.init(gen),
        dis_params={}, dis_stats={}, dis_opt=tx.init({}), raft_params=None,
        flowcomp_params=tree(mods["flowcomp"], convert_flowcomp_state_dict))
    step = jax.jit(JT.make_propainter_train_step(
        cfg, tx, tx, use_precomputed_flows=True))
    jbatch = {k: jnp.asarray(v.cpu().numpy()) for k, v in batch.items()}
    losses = []
    for _ in range(chip_smoke.OVERFIT_STEPS):
        state, metrics, _ = step(state, jbatch)
        losses.append(float(metrics["gen_loss"]))
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", default="cuda",
                    help="the port's device (--impl torch)")
    ap.add_argument("--lr", type=float, nargs="+", default=[3e-4, 1e-4])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    device = "cpu" if args.impl == "jax" else args.device

    if device == "cuda":  # the kernels build at their first launch
        print(f"on {chip_smoke._smi_line()}", flush=True)
    batch, mods = chip_smoke._overfit_setup(device)
    result = {}
    for lr in args.lr:
        ratios = []
        for run in range(args.runs):
            m = _perturbed(mods, run)
            t0 = time.perf_counter()
            losses = (_jax_losses(batch, m, lr) if args.impl == "jax" else
                      chip_smoke._overfit_losses(batch, m, device, lr=lr))
            ratios.append(statistics.mean(losses[-5:])
                          / statistics.mean(losses[:5]))
            print(f"{args.impl} {device} lr {lr:g} run {run}: ratio "
                  f"{ratios[-1]:.4f} ({time.perf_counter() - t0:.1f} s); "
                  f"losses {json.dumps(losses)}", flush=True)
        result[f"{lr:g}"] = ratios
        print(f"{args.impl} {device} lr {lr:g}: ratio {min(ratios):.4f}-"
              f"{max(ratios):.4f}, {sum(r >= 0.5 for r in ratios)} of "
              f"{len(ratios)} at 0.5 or above", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
