"""The plain reference: it loads nothing of the program or of JAX, and on
the CPU it computes what the program's plain path computes."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import ROOT, TINY_SETTINGS

FORBIDDEN = {"jax", "jaxlib", "flax", "propainter_tpu",
             "propainter_tpu_torch"}


def test_reference_loads_neither_the_program_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import benchmark.reference.pipeline, benchmark.compare, "
            "benchmark.weights, benchmark.generators.clips, benchmark.flops, "
            "benchmark.roofline; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    loaded = set(out.stdout.split())
    assert "benchmark" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def _tiny_clip(T=12, H=128, W=160):
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
    masks = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        masks[t, 30 + 2 * t:80 + 2 * t, 40 + 3 * t:100 + 3 * t] = 1
    return frames, masks


def test_reference_matches_the_programs_plain_path():
    """The port on the CPU (plain versions of its kernels) and the
    reference, on one seeded tiny clip with the same seeded weights:
    every stage's output, and the frames within 2 uint8 LSB (the port's
    tolerance against the JAX package's golden)."""
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    from benchmark import compare
    from benchmark.reference import pipeline as ref
    from benchmark.run import Recorder, build

    frames, masks = _tiny_clip()
    config = {"settings": TINY_SETTINGS, "pipeline": {"precision": "fp32"}}
    pipe = build(config, "cpu", 5)
    assert isinstance(pipe, ProPainterPipeline)
    assert pipe.config == PipelineConfig(**TINY_SETTINGS)
    rec = Recorder(pipe)
    rec.on = True
    out = np.stack(pipe.inpaint_video(frames, masks, masks))
    prog = dict(rec.outputs, frames=torch.from_numpy(out))
    models = ref.build_models("cpu")
    from benchmark.weights import fill_models_
    fill_models_(models, 5)
    want = ref.run(models, *(torch.from_numpy(a)
                             for a in (frames, masks, masks)),
                   ref.Config(**TINY_SETTINGS))
    diff = np.abs(out.astype(int) - want["frames"].numpy().astype(int))
    assert diff.max() <= 2, (diff.max(), diff.mean())
    got = compare.numbers(prog, want, masks)
    assert got["flow_rel"] < 1e-5 and got["cflow_rel"] < 1e-5, got
    assert got["prop_rel"] < 1e-5 and got["pmask_flip"] == 0.0, got
    assert got["frame_lsb"] < 0.05, got


@pytest.mark.parametrize("precision", ["tf32", "fp8_e4m3"])
def test_products_round_the_operands(precision):
    """The control's mode rounds both operands of each product and
    nothing else."""
    from benchmark.compare import ROUND, Products

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(8, 16, generator=g), torch.randn(16, 4, generator=g)
    conv_w = torch.randn(4, 3, 3, 3, generator=g)
    x = torch.randn(1, 3, 8, 8, generator=g)
    r = ROUND[precision]
    with Products(precision):
        got_mm = a @ b
        got_conv = torch.nn.functional.conv2d(x, conv_w)
        got_lin = torch.nn.functional.linear(a, b.t())
        got_add = a + 1.0
    torch.testing.assert_close(got_mm, r(a) @ r(b))
    torch.testing.assert_close(got_conv,
                               torch.nn.functional.conv2d(r(x), r(conv_w)))
    torch.testing.assert_close(got_lin, r(a) @ r(b))
    torch.testing.assert_close(got_add, a + 1.0)
    assert not torch.equal(got_mm, a @ b)
