"""The work counts: the model's operations (`flops.py`) against
FlopCounterMode over the plain reference, and the kernels' bounds
(`roofline.py`) against the bound column of PERF.md's kernel table."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, roofline
from benchmark.reference import pipeline as ref
from benchmark.weights import fill_models_


@pytest.mark.parametrize("T,H,W,settings", [
    # RAFT in two chunks, stages 2 and 3 in chunks, references capped
    (14, 128, 160, {"ref_stride": 4, "neighbor_length": 6,
                    "subvideo_length": 8, "raft_iter": 2}),
    # one RAFT chunk, whole stages, a token grid padded to whole windows
    (9, 136, 200, {"ref_stride": 4, "neighbor_length": 4,
                   "subvideo_length": 80, "raft_iter": 1}),
])
def test_flops_are_the_references_products(T, H, W, settings):
    cfg = ref.Config(**settings)
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (T, H, W, 3), dtype=np.uint8)
    masks = np.zeros((T, H, W), np.uint8)
    for t in range(T):
        masks[t, 20 + 3 * t:70 + 3 * t, 30 + 4 * t:90 + 4 * t] = 1
    models = fill_models_(ref.build_models("cpu"), 2)
    with FlopCounterMode(display=False) as counter:
        ref.run(models, *(torch.from_numpy(a) for a in (frames, masks,
                                                         masks)), cfg)
    assert flops.count(T, H, W, masks, cfg) == counter.get_total_flops()


# PERF.md's kernel table: (bound ms, relative tolerance) at its shapes;
# K1 bf16's bytes there counted the taps of coordinates with N(0, 3^2)
# motion, here those of coordinates at their grid positions
TABLE = [
    ("K1", lambda: roofline.k1(24, 30, 54, "fp32"), 0.0391, 0.002),
    ("K1 bf16", lambda: roofline.k1(24, 30, 54, "bf16"), 0.0172, 0.02),
    ("K2", lambda: roofline.k2(24, 30, 54, "fp32"), 0.0991, 0.002),
    ("K2 bf16", lambda: roofline.k2(24, 30, 54, "bf16"), 0.1247, 0.002),
    ("K3 generator", lambda: roofline.k3(1, 60, 108, 128, "fp32"),
     0.0116, 0.005),
    ("K3 flow completion", lambda: roofline.k3(2, 30, 54, 256, "fp32"),
     0.0116, 0.005),
    ("K3 bf16 generator", lambda: roofline.k3(1, 60, 108, 128, "bf16"),
     0.0027, 0.02),
    ("K3 bf16 flow completion",
     lambda: roofline.k3(2, 30, 54, 256, "bf16"), 0.0019, 0.02),
    ("K4 at 32 x 855 / 2380", lambda: roofline.k4(32, 855, 2380, "fp32"),
     0.2021, 0.002),
    ("K4 bf16", lambda: roofline.k4(32, 855, 2380, "bf16"), 0.0337, 0.002),
]


@pytest.mark.parametrize("name,bound,table_ms,rel", TABLE,
                         ids=[t[0] for t in TABLE])
def test_bounds_match_the_kernel_table(name, bound, table_ms, rel):
    assert abs(bound() * 1e3 - table_ms) <= rel * table_ms + 5e-5, (
        name, bound() * 1e3)


def test_clip_calls_are_the_programs_launch_counts():
    """K1, K2, K3 and K4 calls of an 80-frame 432x240 clip: PERF.md's
    launch column (140, 7, 464, 128: every stage-4 window has a dirty
    attention window)."""
    for precision in ("fp32", "bf16"):
        calls = roofline.clip_calls(80, 240, 432, {
            "ref_stride": 10, "neighbor_length": 10,
            "subvideo_length": 80, "raft_iter": 20}, precision, (1,) * 16)
        assert [len(calls[k]) for k in ("k1", "k2", "k3", "k4")] == [
            140, 7, 464, 128]
