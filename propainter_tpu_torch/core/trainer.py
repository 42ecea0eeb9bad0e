"""Training: train states and steps for both stages. Counterpart of
`propainter_tpu/core/trainer.py`, which redesigns the reference's
core/trainer.py (the ProPainter GAN stage) and core/trainer_flow_w_edge.py
(the flow completion stage):

  * the frozen models (RAFT, and the flow completion in stage 2) run under
    `torch.no_grad()`, as the JAX steps hold them under `stop_gradient`;
  * Adam(beta1=0, beta2=0.99, eps=1e-8) under the JAX package's schedules
    (optax's piecewise-constant multistep and the cosine restarts), the
    learning rate of update n being the schedule at n, as optax counts;
  * data parallelism over ranks (`parallel.mesh`: one process per device)
    in place of the JAX trainer's batch sharded over a mesh: each rank
    steps on its shard of the batch; `init_*_state` broadcasts rank 0's
    parameters and buffers; each gradient is averaged over the ranks
    after its backward and before its optimizer step (one flat buffer a
    model, an explicit all-reduce rather than DistributedDataParallel,
    whose hooks fire once per parameter and backward: the discriminator
    runs twice a step and remat recomputes forwards); the loss
    normalisers (`losses.batch_mean`) and the Canny targets' flow peak
    are taken over every rank's shard, as the JAX step takes them over
    the whole batch; the reported metrics are averaged over the ranks.
    With one rank (or no process group) none of this runs.

A step takes a batch dict of tensors on the state's device (this rank's
shard of the batch, B = the global batch over the ranks): frames (B, T,
H, W, 3) in [-1, 1], masks (B, T, H, W, 1), and with precomputed flows
flows_f / flows_b (B, l_t-1, H, W, 2). It updates the state in place and
returns (state, metrics, viz): metrics are detached scalar tensors (the
ranks' mean), viz detached tensors of this rank's batch. Every step runs under
`device.fp32_numerics`.

On CUDA at one rank a step replays two regions from CUDA graphs
(`graphs.StageGraphs`, `cuda_graphs=` of the step makers), the
counterparts of the JAX package's one `jax.jit` a step
(`propainter_tpu/cli/train.py:154`, `:193`): `targets` (RAFT's flows, and
the flow completion and image propagation of the ProPainter stage, or the
Canny thresholds of the flow stage) and `update` (zero_grad, the
trainee's forward, the losses, the backward, the gradient average and the
optimizers' steps). The flow stage's Canny hysteresis loops on the host
until its map stops changing and runs eagerly between them; the
schedulers step on the host after `update`, filling the learning-rate
tensor its graph reads. A step graphs one state: a call on another state
drops its graphs. Across ranks the step runs eagerly (gloo cannot be
captured).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from propainter_tpu_torch.core import losses as L
from propainter_tpu_torch.device import fp32_numerics, resolve_device
from propainter_tpu_torch.graphs import StageGraphs
from propainter_tpu_torch.models.discriminator import Discriminator
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet, combine_flow, forward_bidirect_flow)
from propainter_tpu_torch.models.propainter import (
    InpaintGenerator, image_propagation)
from propainter_tpu_torch.ops.canny import canny_thresholds, hysteresis_edges
from propainter_tpu_torch.parallel.mesh import (
    all_reduce_max, all_reduce_mean, broadcast_modules, world_size)

# a step's regions; both are graphed by default, each kept by the card's
# keep-or-drop rule (PERF.md section 7)
TRAIN_REGIONS = ("targets", "update")


def multistep_lr(base_lr: float, milestones: dict) -> Callable[[int], float]:
    """optax.piecewise_constant_schedule: base_lr times every scale whose
    boundary the update count has reached (core/lr_scheduler.py:9-47)."""
    def schedule(count: int) -> float:
        lr = base_lr
        for boundary, scale in sorted(milestones.items()):
            if count >= boundary:
                lr = lr * scale
        return lr

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: list[int],
                                restart_weights: list[float] | None = None,
                                eta_min: float = 1e-7
                                ) -> Callable[[int], float]:
    """Cosine decay to eta_min within each period, restarting at weight
    w_i (core/lr_scheduler.py:68-112)."""
    restart_weights = restart_weights or [1.0] * len(periods)
    if len(periods) != len(restart_weights):
        raise ValueError("one restart weight per period")
    starts = np.cumsum([0] + periods[:-1]).tolist()

    def schedule(count: int) -> float:
        lr = eta_min
        for start, period, w in zip(starts, periods, restart_weights):
            if count >= start:
                frac = min(max((count - start) / period, 0.0), 1.0)
                lr = eta_min + 0.5 * w * (base_lr - eta_min) * (
                    1 + math.cos(math.pi * frac))
        return lr

    return schedule


def make_optimizer(params, lr: float, milestones: dict | None = None,
                   b1: float = 0.0, b2: float = 0.99,
                   scheduler: str = "multistep",
                   periods: list[int] | None = None,
                   restart_weights: list[float] | None = None,
                   capturable: bool | None = None):
    """(torch.optim.Adam, LambdaLR): step the optimizer, then the
    scheduler, once per update.

    The learning rate is a 0-dim tensor on the parameters' device, which
    the scheduler fills in place (its base, `initial_lr`, a float: no read
    back a step). capturable (None: the parameters are on CUDA): Adam
    keeps its step counts on the device and computes its step sizes there
    from that tensor, so a CUDA graph of the step replays the rate the
    scheduler set (a float rate would be baked in at capture); graphed
    and eager steps run this same arithmetic. Off, the step sizes are the
    host's double arithmetic and the tensor float64: the float rate's
    values exactly. A loaded state dict keeps these settings and the
    tensor."""
    params = list(params)
    device = params[0].device
    if capturable is None:
        capturable = device.type == "cuda"
    if scheduler == "cosine":
        sched = cosine_annealing_restart_lr(
            lr, periods or [250_000, 250_000], restart_weights)
    else:
        sched = multistep_lr(lr, milestones or {})
    rate = torch.tensor(lr, device=device, dtype=torch.float32 if capturable
                        else torch.float64)
    # torch refuses a tensor rate with foreach unless capturable
    opt = torch.optim.Adam(params, lr=rate, betas=(b1, b2), eps=1e-8,
                           capturable=capturable,
                           foreach=None if capturable else False)
    for group in opt.param_groups:
        group["initial_lr"] = lr
    opt.register_load_state_dict_post_hook(functools.partial(
        _keep_settings, rate=rate, capturable=capturable))
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: sched(count) / lr)


def _keep_settings(opt, rate, capturable: bool) -> None:
    """After `load_state_dict` (whose groups are the saved ones): the
    loaded rate back in the optimizer's own tensor, `initial_lr` a float,
    capturable and foreach as made, and the step counts where Adam then
    keeps them (a checkpoint of an optimizer made otherwise, or on
    another device, resumes)."""
    (group,) = opt.param_groups
    rate.fill_(float(group["lr"]))
    group.update(lr=rate, initial_lr=float(group["initial_lr"]),
                 capturable=capturable,
                 foreach=None if capturable else False)
    for p in group["params"]:
        st = opt.state.get(p, {})
        if "step" in st:
            st["step"] = st["step"].to(
                device=p.device if capturable else "cpu",
                dtype=torch.float32)


class TrainStep:
    """A train step, `step(state, batch) -> (state, metrics, viz)`, whose
    regions (`TRAIN_REGIONS`) replay from CUDA graphs: `graphs` (a
    `graphs.StageGraphs`, made at the first call on the batch's device:
    off CUDA nothing is graphed; the cache emptied before a capture) keys
    each by its tensors' shapes and dtypes; the step's static values are
    its maker's. At more than one rank every region runs eagerly."""

    def __init__(self, body, cuda_graphs):
        """body(step, state, batch): the step, its regions through
        `step.region` (passed in, so that no closure holds the step: its
        graphs' memory goes when it does)."""
        StageGraphs(cuda_graphs, TRAIN_REGIONS)     # the names, now
        self._body = body
        self.cuda_graphs = tuple(cuda_graphs)
        self.graphs = None
        self._state = None

    def __call__(self, state, batch):
        if self.graphs is None:
            self.graphs = StageGraphs(self.cuda_graphs, TRAIN_REGIONS,
                                      batch["frames"].device, flush=True)
        if state is not self._state:
            self.graphs.clear()     # graphs read one state's tensors
            self._state = state
        with fp32_numerics():
            return self._body(self, state, batch)

    def region(self, name: str, fn, tensors: tuple):
        """fn(*tensors), from the graph of its key where graphed."""
        if world_size() > 1:
            return fn(*tensors)
        return self.graphs(name, fn, tensors)


def _frozen(module: torch.nn.Module, device) -> torch.nn.Module:
    return module.to(device).eval().requires_grad_(False)


def _average_grads(module: torch.nn.Module) -> None:
    """The module's gradients averaged over the ranks (the JAX step's
    gradient of the whole batch's loss)."""
    all_reduce_mean([p.grad for p in module.parameters()
                     if p.grad is not None])


def _metrics(metrics: dict) -> dict:
    """Detached copies of the step's scalars, averaged over the ranks."""
    out = {k: v.detach().clone() for k, v in metrics.items()}
    all_reduce_mean(list(out.values()))
    return out


def _batch_flows(batch, use_precomputed_flows: bool) -> tuple:
    """The batch's precomputed flows (forward, backward), or ()."""
    if use_precomputed_flows:
        return batch["flows_f"], batch["flows_b"]
    return ()


def _gt_flows(flows: tuple, raft, gt_local, iters: int):
    """The precomputed `flows`, or RAFT's bidirectional flows of the local
    frames (B, l_t, H, W, 3): the forward and backward pairs in one
    call."""
    if flows:
        return flows
    B, l_t, H, W, _ = gt_local.shape
    f1 = gt_local[:, :-1].reshape(-1, H, W, 3)
    f2 = gt_local[:, 1:].reshape(-1, H, W, 3)
    _, flow = raft(torch.cat([f1, f2]), torch.cat([f2, f1]), iters)
    n = f1.shape[0]
    return (flow[:n].reshape(B, l_t - 1, H, W, 2),
            flow[n:].reshape(B, l_t - 1, H, W, 2))


# ---------------------------------------------------------------------------
# ProPainter GAN stage
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PropainterTrainConfig:
    num_local_frames: int = 10
    lr: float = 1e-4
    milestones: dict = dataclasses.field(
        default_factory=lambda: {400_000: 0.1})
    hole_weight: float = 1.0
    valid_weight: float = 1.0
    adversarial_weight: float = 0.01
    gan_type: str = "hinge"
    use_discriminator: bool = True
    # the temporal-kernel-1 T-PatchGAN (reference core/trainer.py:89-90)
    dis_2d: bool = False
    interp_mode: str = "nearest"
    # LPIPS perceptual loss (reference core/trainer.py:66-69, 414-418; off
    # in configs/train_propainter.json)
    perceptual_weight: float = 0.0


@dataclasses.dataclass
class PropainterTrainState:
    step: int
    gen: InpaintGenerator
    gen_opt: torch.optim.Adam
    gen_sched: torch.optim.lr_scheduler.LambdaLR
    dis: Discriminator | None
    dis_opt: torch.optim.Adam | None
    dis_sched: torch.optim.lr_scheduler.LambdaLR | None
    # frozen
    raft: torch.nn.Module | None
    flowcomp: RecurrentFlowCompleteNet

    def checkpoint_items(self) -> dict:
        """What a train checkpoint holds, by the reference's names."""
        return dict(gen=self.gen, dis=self.dis, optimG=self.gen_opt,
                    scheG=self.gen_sched, optimD=self.dis_opt,
                    scheD=self.dis_sched)


def _make_discriminator(config: PropainterTrainConfig) -> Discriminator:
    """Reference core/trainer.py:88-96: Discriminator_2D when dis_2d, and
    use_sigmoid iff the GAN loss is not hinge."""
    return Discriminator(in_channels=3, kd=1 if config.dis_2d else 3,
                         use_sigmoid=config.gan_type != "hinge")


def init_propainter_state(config: PropainterTrainConfig, raft, flowcomp,
                          gen: InpaintGenerator | None = None,
                          dis: Discriminator | None = None,
                          device=None) -> PropainterTrainState:
    """The train state on `device` (None: the GPU): the generator
    (default `InpaintGenerator(remat=True)`) and, with use_discriminator,
    the discriminator (default per config) with their optimizers; raft
    (None with precomputed flows) and flowcomp frozen. Across ranks every
    model takes rank 0's parameters and buffers."""
    dev = resolve_device(device)
    gen = (gen or InpaintGenerator(remat=True)).to(dev).train()
    g_opt, g_sched = make_optimizer(gen.parameters(), config.lr,
                                    config.milestones)
    d_opt = d_sched = None
    if config.use_discriminator:
        dis = (dis or _make_discriminator(config)).to(dev).train()
        d_opt, d_sched = make_optimizer(dis.parameters(), config.lr,
                                        config.milestones)
    state = PropainterTrainState(
        step=0, gen=gen, gen_opt=g_opt, gen_sched=g_sched,
        dis=dis if config.use_discriminator else None, dis_opt=d_opt,
        dis_sched=d_sched,
        raft=None if raft is None else _frozen(raft, dev),
        flowcomp=_frozen(flowcomp, dev))
    broadcast_modules(state.gen, state.dis, state.raft, state.flowcomp)
    return state


def make_propainter_train_step(config: PropainterTrainConfig,
                               raft_iters: int = 20,
                               use_precomputed_flows: bool = False,
                               lpips=None,
                               cuda_graphs=TRAIN_REGIONS) -> TrainStep:
    """The ProPainter GAN train step, in the JAX step's order
    (reference core/trainer.py:350-445): RAFT and the flow completion
    frozen, image propagation, the generator update against the
    discriminator's stored spectral stats, then the discriminator update
    (its real pass updates the stats, its fake pass starts from them).

    lpips: an `LPIPSVgg` on the state's device, required iff
    perceptual_weight > 0 (reference core/trainer.py:66-69).
    cuda_graphs: the regions (of `TRAIN_REGIONS`) replayed from CUDA
    graphs on CUDA at one rank (`TrainStep`); () runs eagerly."""
    l_t = config.num_local_frames
    if config.perceptual_weight > 0:
        if lpips is None:
            raise ValueError("perceptual_weight > 0 requires lpips")
        lpips.eval().requires_grad_(False)
    use_dis = config.use_discriminator
    names = (["hole_loss", "valid_loss"]
             + ["perc_loss"] * (config.perceptual_weight > 0)
             + ["gan_loss"] * use_dis + ["gen_loss"] + ["dis_loss"] * use_dis)

    def targets(state, frames, masks, *flows):
        """Region `targets`, no gradient: the frozen flow stages and image
        propagation -> (completed flows forward, backward, the frames and
        masks the generator takes)."""
        masks = masks.to(frames.dtype)
        gt_local = frames[:, :l_t]
        local_masks = masks[:, :l_t]
        masked_frames = frames * (1 - masks)
        with torch.no_grad():
            gt_flows_bi = _gt_flows(flows, state.raft, gt_local, raft_iters)
            pred_flows_bi, _ = forward_bidirect_flow(
                state.flowcomp, gt_flows_bi, local_masks)
            pred_flows_bi = combine_flow(gt_flows_bi, pred_flows_bi,
                                         local_masks)
            prop_imgs, updated_local_masks = image_propagation(
                masked_frames[:, :l_t], pred_flows_bi[0], pred_flows_bi[1],
                local_masks, config.interp_mode)
            prop_local = gt_local * (1 - local_masks) + prop_imgs * local_masks
            updated_frames = torch.cat([prop_local, masked_frames[:, l_t:]],
                                       dim=1)
            updated_masks = torch.cat([updated_local_masks, masks[:, l_t:]],
                                      dim=1)
        return (*pred_flows_bi, updated_frames, updated_masks)

    def update(state, frames, masks, flow_f, flow_b, updated_frames,
               updated_masks):
        """Region `update`: the generator's and the discriminator's
        updates -> (the metrics by `names`, then the composited, masked
        and true local frames)."""
        masks = masks.to(frames.dtype)
        B, T, H, W, _ = frames.shape
        masked_frames = frames * (1 - masks)

        # generator step: the discriminator's parameters take no gradient
        dis = state.dis if use_dis else None
        if dis is not None:
            dis.requires_grad_(False)
        state.gen_opt.zero_grad(set_to_none=True)
        pred_imgs = state.gen(updated_frames, (flow_f, flow_b), masks,
                              updated_masks, l_t, train=True)
        comp_imgs = frames * (1 - masks) + pred_imgs * masks
        g_loss, hole, valid = L.hole_valid_l1(
            pred_imgs, frames, masks, config.hole_weight, config.valid_weight)
        metrics = {"hole_loss": hole, "valid_loss": valid}
        if config.perceptual_weight > 0:
            # reference core/trainer.py:414-417: LPIPS(pred, frames)
            perc = L.lpips_loss(lpips, pred_imgs.reshape(-1, H, W, 3),
                                frames.reshape(-1, H, W, 3),
                                loss_weight=config.perceptual_weight)
            g_loss = g_loss + perc
            metrics["perc_loss"] = perc
        if dis is not None:
            gan = L.adversarial_g_loss(dis(comp_imgs, update_stats=False),
                                       config.gan_type)
            g_loss = g_loss + config.adversarial_weight * gan
            metrics["gan_loss"] = gan
        g_loss.backward()
        _average_grads(state.gen)
        state.gen_opt.step()
        metrics["gen_loss"] = g_loss

        if dis is not None:
            dis.requires_grad_(True)
            state.dis_opt.zero_grad(set_to_none=True)
            comp_detached = comp_imgs.detach()
            real_logits = dis(frames, update_stats=True)
            fake_logits = dis(comp_detached, update_stats=True)
            d_loss = L.adversarial_d_loss(real_logits, fake_logits,
                                          config.gan_type)
            d_loss.backward()
            _average_grads(dis)
            state.dis_opt.step()
            metrics["dis_loss"] = d_loss
        metrics = _metrics(metrics)
        return (*(metrics[k] for k in names), comp_imgs[:, :l_t].detach(),
                masked_frames[:, :l_t], frames[:, :l_t])

    def body(step, state: PropainterTrainState, batch):
        frames, masks = batch["frames"], batch["masks"]
        flows = _batch_flows(batch, use_precomputed_flows)
        pred_f, pred_b, updated_frames, updated_masks = step.region(
            "targets", lambda *t: targets(state, *t), (frames, masks, *flows))
        out = step.region(
            "update", lambda *t: update(state, *t),
            (frames, masks, pred_f, pred_b, updated_frames, updated_masks))
        state.gen_sched.step()
        if use_dis:
            state.dis_sched.step()
        state.step += 1
        viz = dict(zip(("comp_local", "masked_local", "gt_local"),
                       out[len(names):]), pred_flow_f=pred_f)
        return state, dict(zip(names, out)), viz

    return TrainStep(body, cuda_graphs)


# ---------------------------------------------------------------------------
# Flow-completion stage
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlowTrainConfig:
    num_local_frames: int = 10
    lr: float = 5e-5
    milestones: dict = dataclasses.field(
        default_factory=lambda: {300_000: 0.2, 400_000: 0.2 ** 2,
                                 500_000: 0.2 ** 3, 600_000: 0.2 ** 4})
    flow_weight: float = 0.25
    warp_weight: float = 0.01
    edge_weight: float = 1.0


@dataclasses.dataclass
class FlowTrainState:
    step: int
    model: RecurrentFlowCompleteNet
    opt: torch.optim.Adam
    sched: torch.optim.lr_scheduler.LambdaLR
    raft: torch.nn.Module | None    # frozen

    def checkpoint_items(self) -> dict:
        """What a train checkpoint holds, by the reference's names."""
        return dict(gen=self.model, dis=None, optimG=self.opt,
                    scheG=self.sched, optimD=None, scheD=None)


def init_flow_state(config: FlowTrainConfig, raft,
                    model: RecurrentFlowCompleteNet | None = None,
                    device=None) -> FlowTrainState:
    """The train state on `device` (None: the GPU): the flow completion
    (default `RecurrentFlowCompleteNet(remat=True)`) and its optimizer;
    raft (None with precomputed flows) frozen. Across ranks both models
    take rank 0's parameters and buffers."""
    dev = resolve_device(device)
    model = (model or RecurrentFlowCompleteNet(remat=True)).to(dev).train()
    opt, sched = make_optimizer(model.parameters(), config.lr,
                                config.milestones)
    state = FlowTrainState(step=0, model=model, opt=opt, sched=sched,
                           raft=None if raft is None else _frozen(raft, dev))
    broadcast_modules(state.model, state.raft)
    return state


def flow_edge_thresholds(flows):
    """The Canny targets of `flow_edges` before the hysteresis: the
    double-threshold map (B, T, H, W, 1), 1 strong, 0.5 weak."""
    B, T, H, W, _ = flows.shape
    mag = torch.sqrt(torch.sum(torch.square(flows.reshape(-1, H, W, 2)),
                               dim=-1, keepdim=True))
    peak = all_reduce_max(torch.max(mag))
    mag = torch.where(peak < 1, torch.zeros_like(mag), mag / peak)
    return canny_thresholds(mag, sigma=2.0).reshape(B, T, H, W, 1)


def edges_from_thresholds(thresholds, rounds: list | None = None):
    """`flow_edge_thresholds`' map (B, T, H, W, 1) through Canny's
    hysteresis (`ops.canny.hysteresis_edges`, a host loop; its rounds
    appended to `rounds`) -> edges (B, T, H, W, 1) in {0, 1}."""
    B, T, H, W, _ = thresholds.shape
    return hysteresis_edges(thresholds.reshape(-1, H, W, 1),
                            rounds).reshape(B, T, H, W, 1)


def flow_edges(flows):
    """Canny edges (sigma 2, trainer_flow_w_edge.py:60) of the flow
    magnitude over its peak, zero when the peak is below 1
    (trainer_flow_w_edge.py:261-273): (B, T, H, W, 2) -> (B, T, H, W, 1).
    The peak is the whole batch's, over every rank's shard."""
    return edges_from_thresholds(flow_edge_thresholds(flows))


def make_flow_train_step(config: FlowTrainConfig, raft_iters: int = 20,
                         use_precomputed_flows: bool = False,
                         cuda_graphs=TRAIN_REGIONS) -> TrainStep:
    """The flow completion train step (core/trainer_flow_w_edge.py:276-322):
    RAFT's flows and their Canny edges as targets, both directions
    completed in one call with the edge head, the flow, warp and edge
    losses.

    cuda_graphs: the regions (of `TRAIN_REGIONS`) replayed from CUDA
    graphs on CUDA at one rank (`TrainStep`): `targets` ends at the
    edges' double threshold, the hysteresis runs eagerly after it (the
    step's `hysteresis_rounds`: the last step's rounds, forward and
    backward); () runs eagerly."""
    l_t = config.num_local_frames
    names = ("flow_loss", "warp_loss", "edge_loss", "loss")

    def targets(state, frames, *flows):
        """Region `targets`, no gradient: RAFT's flows (forward,
        backward) and their edges' double thresholds."""
        with torch.no_grad():
            gt_flows_bi = _gt_flows(flows, state.raft, frames[:, :l_t],
                                    raft_iters)
            return (*gt_flows_bi,
                    *(flow_edge_thresholds(f) for f in gt_flows_bi))

    def update(state, frames, masks, flow_f, flow_b, edge_f, edge_b):
        """Region `update`: the trainee's update -> (the metrics by
        `names`, the predicted forward flows and edges)."""
        masks = masks.to(frames.dtype)
        gt_local = frames[:, :l_t]
        local_masks = masks[:, :l_t]
        state.opt.zero_grad(set_to_none=True)
        pred_flows_bi, pred_edges_bi = forward_bidirect_flow(
            state.model, (flow_f, flow_b), local_masks, train=True)
        fl, warp = L.flow_loss(pred_flows_bi, (flow_f, flow_b), local_masks,
                               gt_local)
        el = L.edge_loss(pred_edges_bi, (edge_f, edge_b), local_masks)
        loss = (config.flow_weight * fl + config.warp_weight * warp
                + config.edge_weight * el)
        loss.backward()
        _average_grads(state.model)
        state.opt.step()
        metrics = _metrics({"flow_loss": fl, "warp_loss": warp,
                            "edge_loss": el, "loss": loss})
        return (*(metrics[k] for k in names), pred_flows_bi[0].detach(),
                pred_edges_bi[0].detach())

    def body(step, state: FlowTrainState, batch):
        frames, masks = batch["frames"], batch["masks"]
        flows = _batch_flows(batch, use_precomputed_flows)
        flow_f, flow_b, thr_f, thr_b = step.region(
            "targets", lambda *t: targets(state, *t), (frames, *flows))
        step.hysteresis_rounds = []
        edges = [edges_from_thresholds(t, step.hysteresis_rounds)
                 for t in (thr_f, thr_b)]
        out = step.region("update", lambda *t: update(state, *t),
                          (frames, masks, flow_f, flow_b, *edges))
        state.sched.step()
        state.step += 1
        viz = {"pred_flow_f": out[len(names)], "gt_flow_f": flow_f,
               "pred_edge_f": out[len(names) + 1]}
        return state, dict(zip(names, out)), viz

    step = TrainStep(body, cuda_graphs)
    step.hysteresis_rounds = []
    return step
