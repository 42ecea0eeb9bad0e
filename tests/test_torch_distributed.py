"""Data-parallel training of the PyTorch port on the CPU: the bootstrap
(`parallel.mesh.maybe_initialize_distributed`, as
tests/test_distributed_init.py pins the JAX one), the rank helpers, and
both train steps on two gloo ranks against the jitted JAX step over the
same global batch on a 2-device mesh. (The train CLI on several ranks:
tests/test_torch_distributed_cli.py.)

The ranks are `torch.multiprocessing` spawns of tests/torch_dist_worker.py
(no JAX in them), one intra-op thread each. Tolerances as
tests/test_torch_train.py: losses 1e-5 relative, gradients 1e-4 of each
tensor's largest magnitude (or of 1e-4 of the model's largest gradient,
where one is 0 in exact arithmetic); parameters after the step 1e-4 of
each tensor's scale where their gradient is (`_check_params`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_worker as worker
from propainter_tpu.core import trainer as JT
from propainter_tpu.models.discriminator import (
    convert_discriminator_state_dict)
from propainter_tpu.models.flow_completion import convert_flowcomp_state_dict
from propainter_tpu.models.propainter import (
    InpaintGenerator as JaxGenerator, convert_inpaint_state_dict)
from propainter_tpu.parallel.mesh import make_mesh as jax_make_mesh
from test_torch_train import (
    GRAD_TOL, LOSS_RTOL, _compare_grads, _dis_stats, _grad_recorder, _rel,
    _sd)

from propainter_tpu_torch.core import losses as TL
from propainter_tpu_torch.core import trainer as TT
from propainter_tpu_torch.models.flow_completion import forward_bidirect_flow
from propainter_tpu_torch.parallel import mesh

PARAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test (pytest-xdist runs this file
    beside other workers; see tests/test_torch_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean_env(monkeypatch):
    for name in worker.ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# The bootstrap and the rank helpers
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, **kwargs):
        self.calls.append(kwargs)


def test_noop_without_config(clean_env):
    """No flag and no environment: nothing is initialised, and every
    helper is its one-rank self."""
    def boom(**kwargs):
        raise AssertionError("init_process_group must not be called")

    clean_env.setattr(dist, "init_process_group", boom)
    assert mesh.maybe_initialize_distributed() is False
    assert (mesh.world_size(), mesh.rank(), mesh.is_main()) == (1, 0, True)
    t = [torch.ones(3)]
    assert mesh.all_reduce_mean(t) is t and torch.equal(t[0], torch.ones(3))
    mesh.barrier()


def test_explicit_flags_plumbed(clean_env):
    """The JAX CLI's flags reach init_process_group: a tcp:// rendezvous
    at the coordinator, gloo without a GPU."""
    rec = _Recorder()
    clean_env.setattr(dist, "init_process_group", rec)
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    assert mesh.maybe_initialize_distributed(
        coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2,
        device="cpu") is True
    assert rec.calls == [dict(backend="gloo",
                              init_method="tcp://10.0.0.1:1234",
                              world_size=4, rank=2)]


def test_env_var_triggers_init(clean_env):
    """JAX_COORDINATOR_ADDRESS with JAX_NUM_PROCESSES / JAX_PROCESS_ID
    configures the group as the flags do; a coordinator without a process
    count raises."""
    rec = _Recorder()
    clean_env.setattr(dist, "init_process_group", rec)
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    with pytest.raises(ValueError, match="process count"):
        mesh.maybe_initialize_distributed(device="cpu")
    clean_env.setenv("JAX_NUM_PROCESSES", "2")
    clean_env.setenv("JAX_PROCESS_ID", "1")
    assert mesh.maybe_initialize_distributed(device="cpu") is True
    assert rec.calls == [dict(backend="gloo",
                              init_method="tcp://10.0.0.1:1234",
                              world_size=2, rank=1)]


def test_torchrun_env_triggers_init_on_the_rank_gpu(clean_env):
    """torchrun's environment alone configures an env:// group; with GPUs
    the backend is nccl and LOCAL_RANK's GPU is made current, or
    local_device_ids' one index; two indices raise."""
    rec, current = _Recorder(), []
    clean_env.setattr(dist, "init_process_group", rec)
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 4)
    clean_env.setattr(torch.cuda, "set_device", current.append)
    for k, v in dict(MASTER_ADDR="h0", MASTER_PORT="29500", RANK="5",
                     WORLD_SIZE="8", LOCAL_RANK="1").items():
        clean_env.setenv(k, v)
    assert mesh.maybe_initialize_distributed() is True
    assert mesh.maybe_initialize_distributed(local_device_ids="3") is True
    assert rec.calls == [dict(backend="nccl", init_method="env://",
                              world_size=8, rank=5)] * 2
    assert current == [1, 3]
    with pytest.raises(ValueError, match="one GPU per rank"):
        mesh.maybe_initialize_distributed(local_device_ids="0,1")
    clean_env.delenv("LOCAL_RANK")
    mesh.maybe_initialize_distributed()
    assert current[-1] == 5 % 4


def test_one_rank_group_leaves_the_step_unchanged(tmp_path):
    """Inside a one-rank gloo group the flow step gives the same losses,
    gradients and parameters, bit for bit, as without a group."""
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in worker.flow_batch().items()}
    results = []
    for group in (False, True):
        if group:
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp_path / 'one'}",
                world_size=1, rank=0, timeout=worker.RANK_TIMEOUT)
        try:
            mods = worker.models("flow")
            state, step = worker.state_and_step("flow", mods)
            _, metrics, _ = step(state, batch)
            results.append((metrics, {k: p.grad.clone() for k, p in
                                      mods["model"].named_parameters()
                                      if p.grad is not None},
                            mods["model"].state_dict()))
        finally:
            if group:
                dist.destroy_process_group()
    (m0, g0, p0), (m1, g1, p1) = results
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k])
                                          for k in g0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


# ---------------------------------------------------------------------------
# Two gloo ranks against the JAX step on a 2-device mesh
# ---------------------------------------------------------------------------


def _on_mesh(jstep, jstate, batch):
    """The jitted JAX step with the batch sharded over a 2-device CPU
    mesh and the state replicated (the JAX CLI's layout)."""
    m = jax_make_mesh(2)
    jstate = jax.device_put(jstate, NamedSharding(m, P()))
    jbatch = {k: jax.device_put(jnp.asarray(v), NamedSharding(m, P("data")))
              for k, v in batch.items()}
    with m:
        return jax.block_until_ready(jstep(jstate, jbatch))


def _adam_first(p, g, lr: float):
    """One Adam(beta1 0, beta2 0.99, eps 1e-8) update from zero state:
    p - lr g / (|g| + eps), in float64."""
    g = np.asarray(g, np.float64)
    return np.asarray(p, np.float64) - lr * g / (np.abs(g) + 1e-8)


def _check_params(before: dict, rank_grads: dict, after: dict,
                  jax_grads: dict, lr: float, convert) -> float:
    """The parameters after the step: within 1e-6 of scale of one Adam
    update from `before` with the ranks' averaged gradients, and within
    PARAM_TOL of each tensor's scale of that update with the JAX
    gradients wherever a gradient is at least GRAD_TOL of its tensor's
    largest and 1e-5 (1000 eps): below either, the update
    lr g / (|g| + eps) turns on the gradient's rounding, anywhere in
    [-lr, lr] for the gradients that are 0 in exact arithmetic. Returns
    the worst JAX ratio."""
    own = 0.0
    for k, p in before.items():
        want = _adam_first(p, rank_grads.get(k, np.zeros_like(p)), lr)
        scale = max(np.abs(want).max(), 1e-12)
        own = max(own, float(np.abs(after[k] - want).max() / scale))
    assert own < 1e-6, own
    got = convert({k: torch.from_numpy(after[k]) for k in before})
    start = convert({k: torch.from_numpy(v) for k, v in before.items()})
    worst = []

    def walk(g, p, d, path):
        if isinstance(p, dict):
            for k in p:
                walk(g[k], p[k], d[k], f"{path}/{k}")
            return
        d = np.asarray(d)
        want = _adam_first(p, d, lr)
        sure = np.abs(d) >= max(GRAD_TOL * np.abs(d).max(), 1e-5)
        err = np.abs(np.asarray(g) - want)[sure]
        worst.append((float(err.max(initial=0.0)
                            / max(np.abs(want).max(), 1e-12)), path))

    walk(got, start, jax_grads, "")
    bad = [(e, p) for e, p in worst if e > PARAM_TOL]
    assert not bad, bad[:10]
    return max(worst)[0]


def test_two_ranks_propainter_step_match_jax(tmp_path):
    """The ProPainter GAN step on two gloo ranks, a sample each, rank 1
    starting from other weights (rank 0's reach it by broadcast), against
    the jitted JAX step on the global batch of 2 sharded over a 2-device
    mesh; the two samples' holes cover 2% and 47% of the frame. Every
    loss within 1e-5 relative; the ranks' averaged generator and
    discriminator gradients within 1e-4 of scale; both ranks' parameters
    equal and one Adam update with the averaged gradients, within 1e-4
    of scale of the update with the JAX gradients (`_check_params`); the
    spectral-norm u within 1e-5."""
    ranks = worker.spawn(tmp_path, "train_step", stage="propainter")
    mods = worker.models("propainter")
    gen, dis = mods["gen"], mods["dis"]
    batch = worker.propainter_batch()
    rec = _grad_recorder()
    gen_tree = convert_inpaint_state_dict(_sd(gen))
    dis_tree = convert_discriminator_state_dict(_sd(dis))
    jstate = JT.PropainterTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen_tree,
        gen_opt=rec.init(gen_tree), dis_params=dis_tree,
        dis_stats=_dis_stats(dis), dis_opt=rec.init(dis_tree),
        raft_params=None,
        flowcomp_params=convert_flowcomp_state_dict(_sd(mods["flowcomp"])))
    jstep = jax.jit(JT.make_propainter_train_step(
        JT.PropainterTrainConfig(num_local_frames=worker.L_T), rec, rec,
        use_precomputed_flows=True,
        gen=JaxGenerator(hidden=128, depths=2, remat=True)))
    jnew, jm, _ = _on_mesh(jstep, jstate, batch)

    ranks = ranks()
    for r in ranks:
        assert r["metrics"].keys() == jm.keys()
        for k, v in r["metrics"].items():
            assert _rel(v, jm[k]) < LOSS_RTOL, (k, v, float(jm[k]))
    for name in ("gen", "dis"):
        for k, v in ranks[0]["after"][name].items():
            np.testing.assert_array_equal(ranks[1]["after"][name][k], v)
    cfg = TT.PropainterTrainConfig()
    for name, module, jgrads, convert in (
            ("gen", gen, jnew.gen_opt, convert_inpaint_state_dict),
            ("dis", dis, jnew.dis_opt, convert_discriminator_state_dict)):
        for k, p in module.named_parameters():
            g = ranks[0]["grads"][name].get(k)
            p.grad = None if g is None else torch.from_numpy(g)
        _compare_grads(module, jgrads, convert)
        before = {k: v.detach().numpy() for k, v in
                  module.named_parameters()}
        _check_params(before, ranks[0]["grads"][name],
                      ranks[0]["after"][name], jgrads, cfg.lr, convert)
    for j, i in enumerate((0, 2, 4, 6, 8)):
        u = np.asarray(jnew.dis_stats[f"SpectralNorm_{j}"]
                       [f"conv_{i}/kernel/u"])[0]
        np.testing.assert_allclose(ranks[0]["after"]["dis"]
                                   [f"conv.{i}.weight_u"], u, rtol=0,
                                   atol=1e-5)


def test_two_ranks_flow_step_match_jax(tmp_path):
    """The flow completion step on two gloo ranks against the jitted JAX
    step on the global batch of 2 over a 2-device mesh; sample 0's flows
    peak below 1, the batch's above (the Canny targets' normaliser is the
    batch's). Flow and warp losses within 1e-5 relative of the JAX step's;
    the edge loss (and the total) within 1e-5 of its float64 value on
    the global batch, the JAX step's within 5e-5 (its fp32 sum,
    tests/test_torch_train.py); gradients within 1e-4 of scale; both
    ranks' parameters equal and one Adam update with the averaged
    gradients, within 1e-4 of scale of the update with the JAX gradients
    (`_check_params`)."""
    ranks = worker.spawn(tmp_path, "train_step", stage="flow")
    model = worker.models("flow")["model"]
    tree = convert_flowcomp_state_dict(_sd(model))
    batch = worker.flow_batch()
    rec = _grad_recorder()
    jstate = JT.FlowTrainState(step=jnp.zeros((), jnp.int32), params=tree,
                               opt=rec.init(tree), raft_params=None)
    jstep = jax.jit(JT.make_flow_train_step(
        JT.FlowTrainConfig(num_local_frames=worker.L_T + 1), rec,
        use_precomputed_flows=True))
    jnew, jm, _ = _on_mesh(jstep, jstate, batch)

    ranks = ranks()
    cfg = TT.FlowTrainConfig()
    with torch.no_grad():
        gt = [torch.from_numpy(batch[k]) for k in ("flows_f", "flows_b")]
        masks = torch.from_numpy(batch["masks"])
        _, edges = forward_bidirect_flow(model, gt, masks, train=True)
        targets = [TT.flow_edges(f) for f in gt]
        assert not TT.flow_edges(gt[0][:1]).any() and targets[0][0].any()
        exact = TL.edge_loss([e.double() for e in edges],
                             [t.double() for t in targets],
                             masks.double()).item()
    for r in ranks:
        m = r["metrics"]
        for k in ("flow_loss", "warp_loss"):
            assert _rel(m[k], jm[k]) < LOSS_RTOL, (k, m[k], float(jm[k]))
        exact_total = m["loss"] - cfg.edge_weight * (m["edge_loss"] - exact)
        for k, want in (("edge_loss", exact), ("loss", exact_total)):
            assert _rel(m[k], want) < LOSS_RTOL, (k, m[k], want)
            assert _rel(jm[k], want) < 5 * LOSS_RTOL, (k, float(jm[k]), want)
    for k, v in ranks[0]["after"]["model"].items():
        np.testing.assert_array_equal(ranks[1]["after"]["model"][k], v)
    for k, p in model.named_parameters():
        g = ranks[0]["grads"]["model"].get(k)
        p.grad = None if g is None else torch.from_numpy(g)
    _compare_grads(model, jnew.opt, convert_flowcomp_state_dict)
    before = {k: v.detach().numpy() for k, v in model.named_parameters()}
    _check_params(before, ranks[0]["grads"]["model"],
                  ranks[0]["after"]["model"], jnew.opt, cfg.lr,
                  convert_flowcomp_state_dict)
