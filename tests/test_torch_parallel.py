"""The port's `shard_inference` configuration on the CPU: the mesh helpers,
each split stage against the same work unsplit, and stages 2-3 against the
JAX package's sharded pipeline on its 8 virtual CPU devices (the golden
under this configuration is in test_torch_pipeline.py).

A CPU mesh is `make_mesh(n, device="cpu")`: n entries of the one CPU
device, over which the pipeline cuts its batches as it would over n GPUs
and runs the slices one after another.
"""

import numpy as np
import pytest
import jax
import torch

from propainter_tpu import pipeline as jax_pipeline
from tests.test_torch_models import _fill, _flowcomp_tree, _load

from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.parallel import (
    make_mesh, map_shards, replicate, split_batch)
from propainter_tpu_torch.pipeline import (
    PipelineConfig, ProPainterPipeline, equal_chunk_schedule)
from propainter_tpu_torch.weights import FLOWCOMP_RENAMES, seeded_init_

CPU = torch.device("cpu")


def _pipeline(config, mesh=None, flowcomp=None):
    """Fan-in scaled seeded weights (a 2-block generator), or the given
    flow completion."""
    raft, fc, gen = (seeded_init_(m, i, fan_in_scaled=True) for i, m in
                     enumerate((RAFT(), RecurrentFlowCompleteNet(),
                                InpaintGenerator(depths=2))))
    return ProPainterPipeline(raft, flowcomp or fc, gen, config,
                              device="cpu", mesh=mesh)


def test_make_mesh_and_shards_on_cpu():
    """A CPU mesh, contiguous shards on their mesh devices with each
    shard's work run once, one replica per distinct device, and the
    pipeline's defaults under a mesh."""
    assert make_mesh(device="cpu") == [CPU]
    assert make_mesh(4, device="cpu") == [CPU] * 4
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
    mesh = make_mesh(4, device="cpu")
    x, y = torch.arange(7.0)[:, None], torch.arange(7)
    shards = split_batch(mesh, x, y)
    assert [s[0].shape[0] for _, s in shards] == [2, 2, 2, 1]
    # a batch shorter than the mesh leaves shards out
    assert len(split_batch(mesh, x[:2], y[:2])) == 2
    seen = []

    def fn(replica, a, b):
        seen.append((replica, a.device, b.device, a.shape[0]))
        return a * 2, b + 1

    module = torch.nn.Linear(1, 1)
    replicas = replicate(module, mesh)
    assert replicas == {CPU: module}
    a, b = map_shards(fn, mesh, (x, y), CPU, replicas)
    torch.testing.assert_close(a, x * 2)
    torch.testing.assert_close(b, y + 1)
    assert seen == [(module, CPU, CPU, n) for n in (2, 2, 2, 1)]

    pipe = _pipeline(PipelineConfig(shard_inference=True), mesh)
    assert pipe.mesh == mesh and pipe._window_batch == 4
    assert pipe.raft.corr_layout == "batched"
    assert pipe._replicas["inpaint"] == {CPU: pipe.inpaint}
    plain = _pipeline(PipelineConfig(window_batch=3))
    assert plain.mesh == [CPU] and plain._window_batch == 3
    assert plain.raft.corr_layout == "flat"
    with pytest.raises(ValueError):
        _pipeline(PipelineConfig(), mesh)


def test_equal_chunk_schedule_matches_jax():
    """The port's copy of the schedule equals the JAX one, also on the JAX
    test's own cases (too short to split, fewer than two chunks)."""
    for length, n, pad in [(39, 8, 5), (80, 8, 10), (100, 4, 5), (17, 2, 5),
                           (64, 8, 10), (40, 8, 10), (7, 8, 5), (80, 1, 5),
                           (80, 0, 5)]:
        assert (equal_chunk_schedule(length, n, pad)
                == jax_pipeline.equal_chunk_schedule(length, n, pad))


def test_split_stage1_matches_unsplit():
    """RAFT's frames and pairs split over a 4-device CPU mesh (6
    pair-directions: shards of 2, 2, 1, 1) against one device, at 128 x
    128, where RAFT's coarsest level is valid."""
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(
        rng.uniform(-1, 1, (1, 4, 128, 128, 3)).astype(np.float32))
    cfg = PipelineConfig(raft_iter=2, shard_inference=True)
    whole = _pipeline(cfg, make_mesh(1, device="cpu"))
    split = _pipeline(cfg, make_mesh(4, device="cpu"))
    with torch.inference_mode():
        want = whole.compute_flows(frames)
        got = split.compute_flows(frames)
    for g, w in zip(got, want):
        assert g.shape == (1, 3, 128, 128, 2) and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_split_chunk_stages_match_sequential_and_jax():
    """Stages 2-3 as one batched call over equal chunks split over an
    8-device CPU mesh, against the same schedule run chunk by chunk in the
    port and against the JAX sharded pipeline on its 8 virtual devices
    (tests/test_sharded_inference.py: T = 40, sub = 4, 64 x 96; 8 chunks,
    the quality guard's (39 // 4) // 8 * 8)."""
    T, H, W, sub = 40, 64, 96, 4
    rng = np.random.default_rng(0)
    ff = rng.standard_normal((1, T - 1, H, W, 2)).astype(np.float32)
    fb = rng.standard_normal((1, T - 1, H, W, 2)).astype(np.float32)
    masks = (rng.uniform(size=(1, T, H, W, 1)) > 0.8).astype(np.float32)
    frames = rng.uniform(-1, 1, (1, T, H, W, 3)).astype(np.float32)
    tree = _fill(_flowcomp_tree(), 2)
    pipe = _pipeline(PipelineConfig(subvideo_length=sub, raft_iter=1,
                                    shard_inference=True),
                     make_mesh(8, device="cpu"),
                     _load(RecurrentFlowCompleteNet(), tree,
                           FLOWCOMP_RENAMES))
    t = [torch.from_numpy(a) for a in (ff, fb, masks, frames)]
    with torch.inference_mode():
        pf, pb = pipe.complete_flows((t[0], t[1]), t[2])
        uf, um = pipe.propagate_images(t[3], (pf, pb), t[2])
        sched = equal_chunk_schedule(T - 1, 8, 5)
        seq = [pipe._complete_flow(t[0][:, s:e], t[1][:, s:e],
                                   t[2][:, s:e + 1])
               for s, e, _, _ in sched]
        sched3 = equal_chunk_schedule(T, 8, 10)
        seq3 = [pipe._img_prop(t[3][:, s:e], pf[:, s:e - 1], pb[:, s:e - 1],
                               t[2][:, s:e]) for s, e, _, _ in sched3]
    assert sched is not None and sched3 is not None
    for got, chunks, sc in ((pf, [c[0] for c in seq], sched),
                            (pb, [c[1] for c in seq], sched),
                            (uf, [c[0] for c in seq3], sched3),
                            (um, [c[1] for c in seq3], sched3)):
        want = torch.cat([c[:, os - s:oe - s] for c, (s, _, os, oe)
                          in zip(chunks, sc) if oe > os], dim=1)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)

    assert len(jax.devices()) == 8
    jpipe = jax_pipeline.ProPainterPipeline(
        None, jax.tree.map(np.asarray, tree), None,
        jax_pipeline.PipelineConfig(subvideo_length=sub, raft_iter=1,
                                    shard_inference=True))
    assert jpipe._batch_sharding is not None
    jf, jb = jpipe.complete_flows((ff, fb), masks)
    ju, jm = jpipe.propagate_images(frames, (jf, jb), masks)
    for got, want in ((pf, jf), (pb, jb), (uf, ju), (um, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_sharded_matches_plain_within_one_lsb():
    """Stages 2-4 of the port split over a 4-device CPU mesh against the
    port on one device, both batching windows 4 at a time
    (tests/test_sharded_inference.py's configuration, with a 2-block
    generator): 1 uint8 LSB, the JAX test's own allowance."""
    T, H, W = 8, 64, 96
    rng = np.random.default_rng(0)
    frames_np = rng.integers(0, 255, (T, H, W, 3), np.uint8)
    mask = np.zeros((T, H, W), np.uint8)
    mask[:, 20:40, 30:60] = 1
    base = dict(ref_stride=4, neighbor_length=4, subvideo_length=6,
                raft_iter=2, window_batch=4)
    plain = _pipeline(PipelineConfig(**base))
    sharded = ProPainterPipeline(
        plain.raft, plain.flowcomp, plain.inpaint,
        PipelineConfig(**base, shard_inference=True), device="cpu",
        mesh=make_mesh(4, device="cpu"))
    frames = (torch.from_numpy(frames_np)[None].float() / 255.0 * 2.0 - 1.0)
    masks = torch.from_numpy(mask)[None, ..., None].float()
    flows = tuple(torch.from_numpy(
        rng.standard_normal((1, T - 1, H, W, 2)).astype(np.float32))
        for _ in range(2))
    outs = []
    with torch.inference_mode():
        for pipe in (plain, sharded):
            pred = pipe.complete_flows(flows, masks)
            uf, um = pipe.propagate_images(frames, pred, masks)
            outs.append(pipe.generate(uf, pred, masks, um,
                                      torch.from_numpy(frames_np)).numpy())
    np.testing.assert_array_equal(outs[0][0, :10, :20], frames_np[0, :10, :20])
    assert np.abs(outs[0].astype(int) - outs[1].astype(int)).max() <= 1
