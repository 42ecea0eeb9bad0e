"""The PyTorch port's bf16 pipeline on the golden fixture
(`tests/golden/pipeline_golden.npz`, the JAX pipeline's fp32 run of 6
frames at 144x160 on seeded weights; tests/test_golden_e2e.py), on the
CPU with the plain versions of the kernels, against the fp32 golden and
the JAX bf16 pipeline.
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
from tests.test_golden_e2e import GOLDEN, H, W, _seeded_params
from tests.test_torch_pipeline import _golden_inputs, _golden_modules

from propainter_tpu_torch import pipeline as torch_pipeline


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


def test_golden_pipeline_bf16():
    """The port's bf16 run of the golden fixture: within the bf16 golden
    gate (24 max / 1.0 mean uint8 LSB, tools/tpu_golden_check.py:17-20) of
    the fp32 golden, and against the JAX bf16 pipeline on the CPU (RAFT
    fp32 in both there). Measured: 1 max / 0.0053 mean LSB from the
    golden; 1 max / 0.0006 mean LSB from the JAX bf16 run."""
    mods = _golden_modules()
    frames, mask = _golden_inputs()
    pipe = torch_pipeline.ProPainterPipeline(
        mods["raft"], mods["flowcomp"], mods["inpaint"],
        torch_pipeline.PipelineConfig(ref_stride=3, neighbor_length=4,
                                      raft_iter=3, precision="bf16"),
        device="cpu")
    out = np.stack(pipe.inpaint_video(frames, mask, mask))
    keep = mask == 0
    np.testing.assert_array_equal(out[keep], frames[keep])
    # the caller's modules stay fp32
    assert all(p.dtype == torch.float32 for m in mods.values()
               for p in m.parameters())
    golden = np.load(GOLDEN)["out"]
    diff = np.abs(out.astype(int) - golden.astype(int))
    assert diff.max() <= 24 and diff.mean() <= 1.0, (diff.max(),
                                                     diff.mean())

    key = jax.random.PRNGKey(0)
    params = [
        _seeded_params(jax.eval_shape(lambda: JaxRAFT().init(
            key, jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)),
            iters=1))["params"], seed=1),
        _seeded_params(jax.eval_shape(lambda: JaxFlowComplete().init(
            key, jnp.zeros((1, 2, H, W, 2)),
            jnp.zeros((1, 2, H, W, 1))))["params"], seed=2),
        _seeded_params(jax.eval_shape(lambda: JaxGenerator().init(
            key, jnp.zeros((1, 3, H, W, 3)),
            (jnp.zeros((1, 1, H, W, 2)), jnp.zeros((1, 1, H, W, 2))),
            jnp.zeros((1, 3, H, W, 1)), jnp.zeros((1, 3, H, W, 1)),
            2))["params"], seed=3)]
    jax_out = np.stack(jax_pipeline.ProPainterPipeline(
        *params, jax_pipeline.PipelineConfig(
            ref_stride=3, neighbor_length=4, raft_iter=3,
            precision="bf16")).inpaint_video(frames, mask, mask))
    diff = np.abs(out.astype(int) - jax_out.astype(int))
    assert diff.max() <= 4 and diff.mean() <= 0.05, (diff.max(),
                                                     diff.mean())
