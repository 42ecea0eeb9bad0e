"""The train steps' CUDA-graph regions (`trainer.TrainStep`: `targets` and
`update` of each step) on the CPU, through the stand-in graphs of
tests/torch_graph_standins.py: a captured region runs again at each
replay under the guard, and must read the tensors its capture read.

(a) both steps, RAFT's flows included, over three steps (the first sight
    eager, the second captured and replayed, the third replayed) against
    the eager step from the same weights: the same losses, parameters,
    optimizer states and discriminator statistics, bit for bit, across a
    learning-rate milestone at the third update;
(b) Canny's hysteresis outside every region: it reads a bool back each
    round (`torch.equal`, which the guard refuses) and runs in every
    step, replayed ones too;
(c) the keys: one per region and batch shape;
(d) more than one rank: every region eager;
(e) the optimizer: the tensor learning rate that `LambdaLR` fills in
    place gives the float rate's parameters across a milestone, and keeps
    its tensor, value and settings through a checkpoint's resume.

Adam on CUDA is capturable (its step sizes computed on the device from
the rate tensor); torch allows that only on devices that capture, so (a)
builds the steps' optimizers capturable with the CPU added to torch's
list: the arithmetic the card's graphs replay. Small widths: the
generator at hidden 128 and depth 2, 32 x 48 frames, RAFT at 2
iterations.
"""

import copy
import inspect

import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    L_T, _flow_batch, _flowcomp, _generator, _masks, _smooth, _step_batch,
    _t)
from tests.torch_graph_standins import CountingGraphs

from propainter_tpu_torch.checkpoints import TrainCheckpointManager
from propainter_tpu_torch.core import trainer as TT
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.weights import seeded_init_

RAFT_ITERS = 2
# RAFT's four-level pyramid needs 1/8 of a side >= 8: its batches are
# 64 x 96, the others the training tests' 32 x 48
RAFT_FRAME = (64, 96)
# a milestone at the third update: the third step's replay must take it
MILESTONES = {2: 0.5}


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


@pytest.fixture
def capturable_cpu(monkeypatch):
    """torch's capturable Adam allowed on the CPU."""
    import torch.optim.adam as adam

    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu", "cuda"])


def _raft():
    return seeded_init_(RAFT(), 5, fan_in_scaled=True)


def _capturable(state, cfg):
    """The state's optimizers remade capturable (see the module
    docstring), as `make_optimizer` makes them on CUDA."""
    def remake(model):
        return TT.make_optimizer(model.parameters(), cfg.lr, cfg.milestones,
                                 capturable=True)

    if isinstance(state, TT.FlowTrainState):
        state.opt, state.sched = remake(state.model)
    else:
        state.gen_opt, state.gen_sched = remake(state.gen)
        state.dis_opt, state.dis_sched = remake(state.dis)
    return state


def _raft_batch(B: int, T: int, seed: int) -> dict:
    """Smooth frames with the training tests' hole, RAFT_FRAME."""
    rng = np.random.default_rng(seed)
    return dict(frames=_smooth(rng, (B, T, *RAFT_FRAME, 3)),
                masks=_masks((B, T, *RAFT_FRAME, 1)))


def _stage(stage: str, precomputed: bool = False):
    """(config, state maker, step maker, batch) of a stage at the small
    widths; the batch on the CPU, RAFT's flows unless precomputed."""
    if stage == "flow":
        cfg = TT.FlowTrainConfig(num_local_frames=L_T + 1,
                                 milestones=MILESTONES)
        batch = _flow_batch(np.random.default_rng(21))

        def state():
            return TT.init_flow_state(
                cfg, None if precomputed else _raft(),
                model=_flowcomp(remat=True), device="cpu")

        def step(**kw):
            return TT.make_flow_train_step(
                cfg, raft_iters=RAFT_ITERS,
                use_precomputed_flows=precomputed, **kw)
    else:
        cfg = TT.PropainterTrainConfig(num_local_frames=L_T,
                                       milestones=MILESTONES)
        batch = _step_batch(np.random.default_rng(22))

        def state():
            st = TT.init_propainter_state(
                cfg, None if precomputed else _raft(), _flowcomp(),
                gen=_generator(), device="cpu")
            seeded_init_(st.dis, 3, fan_in_scaled=True)
            return st

        def step(**kw):
            return TT.make_propainter_train_step(
                cfg, raft_iters=RAFT_ITERS,
                use_precomputed_flows=precomputed, **kw)
    if not precomputed:
        batch = (_raft_batch(2, L_T + 1, 23) if stage == "flow"
                 else _raft_batch(1, L_T + 1, 24))
    return cfg, state, step, {k: _t(v) for k, v in batch.items()}


def _trained(state) -> dict:
    """Every trained tensor of a state: parameters, buffers (the
    discriminator's spectral-norm stats), optimizer states."""
    out = {}
    mods = ({"model": state.model} if isinstance(state, TT.FlowTrainState)
            else {"gen": state.gen, "dis": state.dis})
    opts = ({"opt": state.opt} if isinstance(state, TT.FlowTrainState)
            else {"gen_opt": state.gen_opt, "dis_opt": state.dis_opt})
    for name, m in mods.items():
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    for name, opt in opts.items():
        for i, st in enumerate(opt.state.values()):
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()})
        out[f"{name}.lr"] = opt.param_groups[0]["lr"]
    return out


@pytest.mark.parametrize("stage", ["flow", "propainter"])
def test_regions_replay_the_eager_step(stage, capturable_cpu):
    """(a) Three steps with both regions through `CountingGraphs` (each
    replayed twice) against three eager steps from the same weights:
    every metric, every trained tensor and the viz equal bit for bit;
    the learning rate after the milestone is the schedule's."""
    cfg, make_state, make_step, batch = _stage(stage)
    base = make_state()
    states = {side: _capturable(copy.deepcopy(base), cfg)
              for side in ("eager", "graphed")}
    steps = {"eager": make_step(cuda_graphs=()), "graphed": make_step()}
    steps["graphed"].graphs = CountingGraphs(TT.TRAIN_REGIONS,
                                             TT.TRAIN_REGIONS)
    runs = {side: [steps[side](states[side], batch) for _ in range(3)]
            for side in steps}
    assert steps["graphed"].graphs.replays == {"targets": 2, "update": 2}
    for (_, m_e, v_e), (_, m_g, v_g) in zip(runs["eager"], runs["graphed"]):
        assert m_e.keys() == m_g.keys() and v_e.keys() == v_g.keys()
        for k in m_e:
            assert torch.equal(m_e[k], m_g[k]), k
        for k in v_e:
            assert torch.equal(v_e[k], v_g[k]), k
    want, got = (_trained(states[s]) for s in ("eager", "graphed"))
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert float(got["gen_opt.lr" if stage == "propainter" else "opt.lr"]) \
        == pytest.approx(cfg.lr * 0.5, rel=1e-7)
    # the schedulers step on the host once a step, outside the regions (a
    # replay runs no Python; the stand-in's capture runs it once more)
    for st in states.values():
        scheds = ([st.sched] if stage == "flow"
                  else [st.gen_sched, st.dis_sched])
        assert [sc.last_epoch for sc in scheds] == [3] * len(scheds)
    assert states["graphed"].step == 3


def test_hysteresis_runs_between_the_regions(capturable_cpu):
    """(b) The flow step's hysteresis reads a bool back each round
    (`torch.equal`: refused inside a region, so (a)'s regions do not hold
    it) and runs eagerly in every step, its rounds recorded for both
    directions, replayed steps included; the edges equal `flow_edges`."""
    cfg, make_state, make_step, batch = _stage("flow", precomputed=True)
    state = _capturable(make_state(), cfg)
    step = make_step()
    step.graphs = CountingGraphs(TT.TRAIN_REGIONS, TT.TRAIN_REGIONS)
    seen = []
    for _ in range(3):
        step(state, batch)
        seen.append(list(step.hysteresis_rounds))
    assert step.graphs.replays == {"targets": 2, "update": 2}
    assert all(len(r) == 2 and min(r) >= 1 for r in seen)
    assert seen[0] == seen[1] == seen[2]
    edges = TT.edges_from_thresholds(TT.flow_edge_thresholds(
        batch["flows_f"]))
    assert torch.equal(edges, TT.flow_edges(batch["flows_f"]))
    assert edges.any()


def test_keys_are_per_batch_shape(capturable_cpu):
    """(c) One key per region and batch shape (its tensors' shapes and
    dtypes): a second shape is a first sight, then captured; a step on
    another state drops the first state's graphs."""
    cfg, make_state, make_step, batch = _stage("flow", precomputed=True)
    state = _capturable(make_state(), cfg)
    step = make_step()
    step.graphs = CountingGraphs(TT.TRAIN_REGIONS, TT.TRAIN_REGIONS)
    short = {k: v[:1] for k, v in batch.items()}
    for b in (batch, batch, short, short):
        step(state, b)
    keys = step.graphs.keys()
    assert sorted(k[0] for k in keys) == ["targets", "targets", "update",
                                          "update"]
    assert {k[2][0][0][0] for k in keys} == {1, 2}     # the frames' batch
    assert all(k[1] == () for k in keys)
    assert step.graphs.counts() == {"targets": 2, "update": 2}
    other = _capturable(make_state(), cfg)
    step(other, batch)
    assert step.graphs.counts() == {"targets": 0, "update": 0}
    assert len(step.graphs.keys()) == 2


def test_more_than_one_rank_runs_eagerly(capturable_cpu, monkeypatch):
    """(d) At world size > 1 no region reaches the graphs (gloo cannot be
    captured, NCCL under capture is unproven): no key, no replay."""
    monkeypatch.setattr(TT, "world_size", lambda: 2)
    cfg, make_state, make_step, batch = _stage("propainter",
                                               precomputed=True)
    state = _capturable(make_state(), cfg)
    step = make_step()
    step.graphs = CountingGraphs(TT.TRAIN_REGIONS, TT.TRAIN_REGIONS)
    for _ in range(3):
        step(state, batch)
    assert step.graphs.keys() == [] and not step.graphs.replays


def test_nothing_is_graphed_on_the_cpu():
    """The default regions are both, and on the CPU none is graphed;
    unknown region names are refused."""
    for make in (TT.make_flow_train_step, TT.make_propainter_train_step):
        assert inspect.signature(make).parameters["cuda_graphs"].default \
            == TT.TRAIN_REGIONS == ("targets", "update")
    cfg, make_state, make_step, batch = _stage("flow", precomputed=True)
    step = make_step()
    step(make_state(), batch)
    assert step.graphs.stages == frozenset()
    with pytest.raises(ValueError, match="unknown stages"):
        make_step(cuda_graphs=("raft",))


@pytest.mark.parametrize("capturable", [False, True])
def test_tensor_rate_follows_the_schedule(capturable, monkeypatch):
    """(e) `make_optimizer`'s rate tensor, filled in place by its LambdaLR,
    against Adam at a float rate under the same schedule, over 6 updates
    across a milestone at the third: the same tensor object throughout,
    its value the schedule's; the parameters bit for bit off capturable
    (the host's double arithmetic on a float64 rate), within 1e-6
    relative capturable (the step sizes in float32 on the device)."""
    if capturable:
        import torch.optim.adam as adam

        monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                            lambda supports_xla=True: ["cpu", "cuda"])
    lr, milestones = 1e-2, {2: 0.1}
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = rng.standard_normal((6, 4, 5)).astype(np.float32)
    p = torch.nn.Parameter(_t(p0.copy()))
    q = torch.nn.Parameter(_t(p0.copy()))
    opt, sched = TT.make_optimizer([p], lr, milestones,
                                   capturable=capturable)
    rate = opt.param_groups[0]["lr"]
    assert isinstance(rate, torch.Tensor) and rate.dim() == 0
    ref = torch.optim.Adam([q], lr=lr, betas=(0.0, 0.99), eps=1e-8)
    ref_sched = torch.optim.lr_scheduler.LambdaLR(
        ref, lambda c: TT.multistep_lr(lr, milestones)(c) / lr)
    for g in grads:
        p.grad, q.grad = _t(g.copy()), _t(g.copy())
        opt.step()
        sched.step()
        ref.step()
        ref_sched.step()
        assert opt.param_groups[0]["lr"] is rate
        assert float(rate) == pytest.approx(ref.param_groups[0]["lr"],
                                            rel=1e-7)
        if capturable:
            torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6,
                                       atol=1e-8)
        else:
            assert torch.equal(p.detach(), q.detach())
    assert float(rate) == pytest.approx(lr * 0.1, rel=1e-7)


@pytest.mark.parametrize("saved_as", ["same", "float rate"])
def test_optimizer_state_survives_the_resume(saved_as, tmp_path,
                                             capturable_cpu):
    """(e) A state's optimizers through `TrainCheckpointManager` (the
    train CLI's resume) into a fresh state: each rate stays in the fresh
    optimizer's own tensor with the saved value, `initial_lr` a float,
    capturable and foreach as made, the step counts on the parameters'
    device; the next step equals the saved state's. "float rate": the
    checkpoint's optimizers were Adam at a float rate, not capturable
    (the form before the rate became a tensor)."""
    cfg, make_state, make_step, batch = _stage("propainter",
                                               precomputed=True)
    state = _capturable(make_state(), cfg)
    step = make_step(cuda_graphs=())
    for _ in range(3):
        step(state, batch)
    if saved_as == "float rate":
        for opt in (state.gen_opt, state.dis_opt):
            group = opt.param_groups[0]
            group.update(lr=float(group["lr"]), capturable=False,
                         foreach=False)
            for st in opt.state.values():
                st["step"] = st["step"].clone()
    mgr = TrainCheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state)
    fresh = _capturable(make_state(), cfg)
    rates = [fresh.gen_opt.param_groups[0]["lr"],
             fresh.dis_opt.param_groups[0]["lr"]]
    assert mgr.restore(fresh) is fresh and fresh.step == 3
    for opt, rate in zip((fresh.gen_opt, fresh.dis_opt), rates):
        group = opt.param_groups[0]
        assert group["lr"] is rate
        assert float(rate) == pytest.approx(cfg.lr * 0.5, rel=1e-7)
        assert type(group["initial_lr"]) is float
        assert group["capturable"] and group["foreach"] is None
        for st in opt.state.values():
            assert st["step"].dtype == torch.float32
            assert float(st["step"]) == 3.0
    if saved_as == "float rate":
        for opt in (state.gen_opt, state.dis_opt):
            group = opt.param_groups[0]
            group.update(lr=torch.tensor(group["lr"], dtype=torch.float32),
                         capturable=True, foreach=None)
    _, m1, _ = step(state, batch)
    _, m2, _ = step(fresh, batch)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(state.gen.parameters(), fresh.gen.parameters()):
        assert torch.equal(a, b)
