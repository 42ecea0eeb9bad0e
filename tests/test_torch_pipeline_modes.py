"""The PyTorch port's pipeline in its other configurations against the JAX
package: the committed golden (`tests/golden/pipeline_golden.npz`, see
tests/test_torch_pipeline.py) under shard_inference and unchunked, and
RAFT's raft_clip_len chunks against the JAX pipeline's. Split from
tests/test_torch_pipeline.py so that each file is a shorter unit of
pytest-xdist's loadfile distribution.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from propainter_tpu import pipeline as jax_pipeline
from propainter_tpu.models.raft import RAFT as JaxRAFT
from tests.test_golden_e2e import GOLDEN, H, T, W, _seeded_params
from tests.test_torch_pipeline import (
    _bucket_sizes, _golden_inputs, _golden_modules)

from propainter_tpu_torch import pipeline as torch_pipeline
from propainter_tpu_torch.parallel import make_mesh


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
