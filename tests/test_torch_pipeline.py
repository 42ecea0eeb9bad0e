"""The PyTorch port's pipeline against the JAX package's committed golden.
The golden's other configurations (shard_inference, unchunked,
raft_clip_len) are in tests/test_torch_pipeline_modes.py.

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
from propainter_tpu_torch.utils.masks import binary_dilation_cross
from propainter_tpu_torch.weights import (
    FLOWCOMP_RENAMES, INPAINT_RENAMES, RAFT_RENAMES, state_dict_from_flax)


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs this file beside
    other pytest-xdist workers, and PyTorch's default of one OpenMP thread
    per core in every worker oversubscribes the host (these tests took 20x
    their time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    # the dense differentiable form (training's) is accepted, as the JAX
    # pipeline accepts it; an unknown form raises
    pipe = torch_pipeline.ProPainterPipeline(
        *mods.values(), torch_pipeline.PipelineConfig(attention_impl="xla"),
        device="cpu")
    assert pipe.inpaint.transformers.transformer[0].attention \
        .attention_impl == "xla"
    with pytest.raises(ValueError, match="attention_impl"):
        torch_pipeline.ProPainterPipeline(
            *mods.values(), torch_pipeline.PipelineConfig(
                attention_impl="dense"), device="cpu")
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
