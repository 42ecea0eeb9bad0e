"""The PyTorch port's pipeline against the JAX package's committed golden.

`tests/golden/pipeline_golden.npz` froze one tiny deterministic run of the
JAX pipeline on the CPU (seeded weights and inputs, 6 frames at 144x160,
all four stages and the compositing; tests/test_golden_e2e.py). The same
weights go through `propainter_tpu_torch.weights` into the port, which runs
on the CPU with its plain PyTorch kernels.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu import pipeline as jax_pipeline
from propainter_tpu.models.flow_completion import (
    RecurrentFlowCompleteNet as JaxFlowComplete)
from propainter_tpu.models.propainter import InpaintGenerator as JaxGenerator
from propainter_tpu.models.raft import RAFT as JaxRAFT
from tests.test_golden_e2e import GOLDEN, H, T, W, _seeded_params

from propainter_tpu_torch import pipeline as torch_pipeline
from propainter_tpu_torch.api import ProInpainter
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.parallel import make_mesh
from propainter_tpu_torch.utils.masks import binary_dilation_cross
from propainter_tpu_torch.weights import (
    FLOWCOMP_RENAMES, INPAINT_RENAMES, RAFT_RENAMES, state_dict_from_flax)


def _golden_modules():
    """The golden run's seeded JAX params, loaded into the port's modules.
    The flow completion's edge head (training only, absent from the golden
    tree) is filled with zeros; inference never reads it."""
    key = jax.random.PRNGKey(0)
    raft = _seeded_params(jax.eval_shape(lambda: JaxRAFT().init(
        key, jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)),
        iters=1))["params"], seed=1)
    fc = _seeded_params(jax.eval_shape(lambda: JaxFlowComplete().init(
        key, jnp.zeros((1, 2, H, W, 2)),
        jnp.zeros((1, 2, H, W, 1))))["params"], seed=2)
    edge = jax.eval_shape(lambda: JaxFlowComplete().init(
        key, jnp.zeros((1, 2, H, W, 2)), jnp.zeros((1, 2, H, W, 1)),
        True))["params"]["edgeDetector"]
    fc = dict(fc, edgeDetector=jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), edge))
    gen = _seeded_params(jax.eval_shape(lambda: JaxGenerator().init(
        key, jnp.zeros((1, 3, H, W, 3)),
        (jnp.zeros((1, 1, H, W, 2)), jnp.zeros((1, 1, H, W, 2))),
        jnp.zeros((1, 3, H, W, 1)), jnp.zeros((1, 3, H, W, 1)),
        2))["params"], seed=3)
    mods = {}
    for name, mod, tree, renames in (
            ("raft", RAFT(), raft, RAFT_RENAMES),
            ("flowcomp", RecurrentFlowCompleteNet(), fc, FLOWCOMP_RENAMES),
            ("inpaint", InpaintGenerator(), gen, INPAINT_RENAMES)):
        tree = jax.tree.map(np.asarray, tree)
        mod.load_state_dict(state_dict_from_flax(mod, tree, renames),
                            strict=True)
        mods[name] = mod
    return mods


def _golden_inputs():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (H // 8, W // 8, 3), np.uint8)
    frames = np.stack([
        np.roll(np.kron(base, np.ones((8, 8, 1), np.uint8)), 3 * t, axis=1)
        for t in range(T)])
    mask = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        mask[t, 50:90, 40 + 4 * t:100 + 4 * t] = 1
    return frames, mask


def _bucket_sizes(generator) -> list:
    """Records each generator call's masked_windows bucket (None = dense
    branch A)."""
    sizes = []
    generator.register_forward_pre_hook(
        lambda _, args, kw: sizes.append(
            None if kw.get("masked_windows") is None
            else tuple(kw["masked_windows"][0].shape)), with_kwargs=True)
    return sizes


@pytest.mark.parametrize("attention_impl", ["flash", "pallas"])
def test_golden_pipeline_output(attention_impl):
    """Both attention forms reproduce the golden, which the JAX pipeline
    froze with its defaults ('flash', occupancy bucketing): each of its
    three windows (3, 5 and 4 frames) has 4 of its 6 attention windows
    dirty, so each generator call takes a bucket of 4 (which 'pallas'
    does not read)."""
    mods = _golden_modules()
    pipe = torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"],
        torch_pipeline.PipelineConfig(ref_stride=3, neighbor_length=4,
                                      raft_iter=3,
                                      attention_impl=attention_impl),
        device="cpu")
    buckets = _bucket_sizes(pipe.inpaint)
    frames, mask = _golden_inputs()
    timings = {}
    out = np.stack(pipe.inpaint_video(frames, mask, mask, timings=timings))
    assert buckets == [(1, 4)] * 3
    golden = np.load(GOLDEN)["out"]
    assert out.shape == golden.shape == (T, H, W, 3)
    assert out.dtype == np.uint8
    keep = mask == 0
    np.testing.assert_array_equal(out[keep], frames[keep])
    assert set(timings) == {"raft", "flow_completion", "image_propagation",
                            "generation", "readback"}
    # 2 uint8 LSB: fp32 summation-order drift between XLA's and PyTorch's
    # CPU convolutions, the golden test's own allowance
    diff = np.abs(out.astype(int) - golden.astype(int))
    assert diff.max() <= 2, (
        f"max|diff|={diff.max()} mean={diff.mean():.4f} at "
        f"{np.unravel_index(diff.argmax(), diff.shape)}")


def test_golden_with_shard_inference():
    """The golden reproduced by the shard_inference configuration with
    window_batch 4 over a 2-device CPU mesh (`make_mesh(2, device="cpu")`).
    Each of the golden's three windows has its own length, so every batch
    is one real window and three of weight 0 (composited, they would move
    the output), each batch split into two shards of two windows."""
    mods = _golden_modules()
    pipe = torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"],
        torch_pipeline.PipelineConfig(ref_stride=3, neighbor_length=4,
                                      raft_iter=3, shard_inference=True,
                                      window_batch=4),
        device="cpu", mesh=make_mesh(2, device="cpu"))
    batches = []
    pipe.inpaint.register_forward_pre_hook(
        lambda _, args, kw: batches.append((args[0].shape[0],
                                            tuple(kw["frame_valid"].shape))),
        with_kwargs=True)
    buckets = _bucket_sizes(pipe.inpaint)
    frames, mask = _golden_inputs()
    out = np.stack(pipe.inpaint_video(frames, mask, mask))
    golden = np.load(GOLDEN)["out"]
    assert out.shape == golden.shape and out.dtype == np.uint8
    assert [b for b, _ in batches] == [2] * 6
    assert [fv[0] for _, fv in batches] == [2] * 6
    # each shard's rows of its batch's bucket (4 of 6 windows dirty)
    assert buckets == [(2, 4)] * 6
    keep = mask == 0
    np.testing.assert_array_equal(out[keep], frames[keep])
    diff = np.abs(out.astype(int) - golden.astype(int))
    assert diff.max() <= 2, (
        f"max|diff|={diff.max()} mean={diff.mean():.4f}")


def test_unchunked_reproduces_the_golden():
    """unchunked=True ignores a subvideo_length of 4 (stages 2-3 run
    whole, the references uncapped), so the 6-frame golden, which ran
    whole at the default of 80, comes back within its 2 LSB; the same
    subvideo_length without unchunked runs stage 2 in two chunks (of 5
    flows each: 4 or 1, padded by 5)."""
    mods = _golden_modules()
    options = dict(ref_stride=3, neighbor_length=4, raft_iter=3,
                   subvideo_length=4)
    pipe = torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"],
        torch_pipeline.PipelineConfig(unchunked=True, **options),
        device="cpu")
    calls = []
    pipe.flowcomp.register_forward_pre_hook(
        lambda _, args: calls.append(args[0].shape[1]))
    frames, mask = _golden_inputs()
    out = np.stack(pipe.inpaint_video(frames, mask, mask))
    assert calls == [T - 1]     # both directions in one call, whole
    diff = np.abs(out.astype(int) - np.load(GOLDEN)["out"].astype(int))
    assert diff.max() <= 2, (diff.max(), diff.mean())
    chunked = torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"],
        torch_pipeline.PipelineConfig(**options), device="cpu")
    calls.clear()
    flows = torch.zeros(1, T - 1, H, W, 2)
    with torch.inference_mode():
        chunked.complete_flows((flows, flows), torch.zeros(1, T, H, W, 1))
    assert calls == [T - 1, T - 1]


def test_raft_clip_len_matches_jax():
    """raft_clip_len=3 chunks RAFT's 6 frames as 0-2 and 2-5 (one frame
    of overlap), as the JAX package does: the port's compute_flows against
    the JAX pipeline's on the golden weights."""
    mods = _golden_modules()
    pipe = torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"],
        torch_pipeline.PipelineConfig(raft_iter=3, raft_clip_len=3),
        device="cpu")
    frames, _ = _golden_inputs()
    x = (frames.astype(np.float32) / 255.0 * 2.0 - 1.0)[None]
    chunks = []
    pipe.raft.fnet.register_forward_pre_hook(
        lambda _, args: chunks.append(args[0].shape[0]))
    with torch.inference_mode():
        got = pipe.compute_flows(torch.from_numpy(x))
    assert chunks == [3, 4]
    key = jax.random.PRNGKey(0)
    params = _seeded_params(jax.eval_shape(lambda: JaxRAFT().init(
        key, jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)),
        iters=1))["params"], seed=1)
    want = jax_pipeline.ProPainterPipeline(
        params, None, None, jax_pipeline.PipelineConfig(
            raft_iter=3, raft_clip_len=3)).compute_flows(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.shape == (1, T - 1, H, W, 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_schedule_helpers_match_jax():
    """The port's copies of the numpy schedule helpers equal the originals."""
    for width in (160, 432, 640, 641, 720, 1280, 1920):
        assert (torch_pipeline.get_short_clip_len(width)
                == jax_pipeline.get_short_clip_len(width))
    for length in (20, 79, 80, 161, 240):
        for n_chunks in (1, 2, 3, 4, 8):
            for pad in (5, 10):
                assert (torch_pipeline.equal_chunk_schedule(length, n_chunks,
                                                            pad)
                        == jax_pipeline.equal_chunk_schedule(length, n_chunks,
                                                             pad))
    for length in (6, 40, 80, 240):
        for f in range(0, length, 5):
            nb = list(range(max(0, f - 5), min(length, f + 6)))
            for stride, num in ((10, -1), (10, 8), (3, -1), (3, 2)):
                assert (torch_pipeline.get_ref_index(f, nb, length, stride,
                                                     num)
                        == jax_pipeline.get_ref_index(f, nb, length, stride,
                                                      num))


def test_precision_and_device_guards():
    mods = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
            "inpaint": InpaintGenerator(depths=2)}
    # bf16 runs 'pallas' (K5's bf16 form) and shard_inference with an fp32
    # RAFT refinement (K7's bf16 form); a bf16 refinement in the batched
    # corr layout raises, as the JAX package cannot run it
    for options in (dict(attention_impl="pallas"),
                    dict(shard_inference=True, raft_bf16_refine=False)):
        torch_pipeline.ProPainterPipeline(
            *mods.values(), torch_pipeline.PipelineConfig(
                precision="bf16", **options), device="cpu")
    with pytest.raises(NotImplementedError, match="raft.py:122"):
        torch_pipeline.ProPainterPipeline(
            *mods.values(), torch_pipeline.PipelineConfig(
                precision="bf16", shard_inference=True), device="cpu")
    with pytest.raises(ValueError):
        torch_pipeline.PipelineConfig(precision="fp16")
    # the dense differentiable form comes with training
    with pytest.raises(NotImplementedError):
        torch_pipeline.ProPainterPipeline(
            *mods.values(), torch_pipeline.PipelineConfig(
                attention_impl="xla"), device="cpu")
    if not torch.cuda.is_available():
        # no silent fallback: the default device is the GPU
        with pytest.raises(RuntimeError):
            torch_pipeline.ProPainterPipeline(*mods.values())
        with pytest.raises(RuntimeError):
            ProInpainter(mods).inpaint(np.zeros((2, 128, 128, 3), np.uint8),
                                       np.zeros((2, 128, 128), np.uint8))


def test_small_input_is_padded_and_cropped():
    """Below 128 px the pipeline pads into RAFT's valid domain and crops the
    output back (through the ProInpainter facade)."""
    mods = _golden_modules()
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 255, (3, 64, 80, 3), np.uint8)
    mask = np.zeros((3, 64, 80), np.uint8)
    mask[:, 20:40, 30:50] = 1
    out = ProInpainter(mods, device="cpu").inpaint(
        frames, mask, dilate_radius=2, raft_iter=2, neighbor_length=2,
        ref_stride=2)
    assert out.shape == frames.shape and out.dtype == np.uint8
    keep = np.stack([binary_dilation_cross(m, 2) for m in mask]) == 0
    np.testing.assert_array_equal(out[keep], frames[keep])
