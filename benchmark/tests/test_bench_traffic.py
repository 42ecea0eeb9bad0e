"""The default clip generator and the traffic files."""

import numpy as np
import pytest

from benchmark import flops
from benchmark.generators import clips
from benchmark.tests.conftest import ROOT

NAMES = sorted(p.stem for p in (ROOT / "benchmark" / "traffic").glob("*.json"))


def small(name):
    """The traffic mix at 16 frames (its sizes and shapes kept)."""
    t = clips.load(name)
    return clips.Traffic(**{**t.__dict__, "frames": 16})


@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_clips(name):
    t = small(name)
    a, b = clips.pool(t, 2 ** 31 + 9), clips.pool(t, 2 ** 31 + 9)
    for x, y in zip(a, b):
        for k in ("frames", "flow_masks", "masks_dilated"):
            assert np.array_equal(x[k], y[k])


@pytest.mark.parametrize("name", NAMES)
def test_other_seeds_other_scenes_same_work(name):
    t = small(name)
    a, b = clips.pool(t, 5), clips.pool(t, 6)
    assert not np.array_equal(a[0]["frames"], b[0]["frames"])
    assert not np.array_equal(a[0]["frames"], a[1]["frames"])
    # the mask, so the stage-4 work and the CUDA graphs' keys, is the
    # traffic's
    assert np.array_equal(a[0]["masks_dilated"], b[1]["masks_dilated"])


@pytest.mark.parametrize("name", NAMES)
def test_masks_and_sizes(name):
    t = clips.load(name)
    H, W = t.size
    assert H % 8 == 0 and W % 8 == 0
    assert (H, W) == (t.height - t.height % 8, t.width - t.width % 8)
    c = clips.clip(small(name), 1, 0)
    assert c["frames"].shape == (16, H, W, 3)
    assert c["frames"].dtype == np.uint8
    obj = clips.object_masks(small(name))
    share = obj.mean(axis=(1, 2))
    # an ellipse of object_area of the frame, inside it
    assert np.all(np.abs(share - t.object_area) < 0.01 * t.object_area + 1e-3)
    dil = c["masks_dilated"]
    assert np.array_equal(dil, c["flow_masks"])
    assert np.all(dil >= obj) and dil.mean() > obj.mean()
    assert set(np.unique(dil)) == {0, 1}


def test_854_is_floored_to_848():
    t = clips.load("clip80_848x480")
    assert (t.width, t.height) == (854, 480) and t.size == (480, 848)


@pytest.mark.parametrize("H,W", [(240, 432), (480, 848), (128, 160)])
def test_signature_is_the_programs_bitmap(H, W):
    """The work count's dirty attention windows per stage-4 window are
    what the program's `masked_window_bitmap` finds."""
    import torch

    from propainter_tpu_torch.models.propainter import masked_window_bitmap

    rng = np.random.default_rng(H + W)
    masks = np.zeros((12, H, W), np.uint8)
    for t in range(12):
        y, x = rng.integers(0, H - 40), rng.integers(0, W - 60)
        masks[t, y:y + 40, x:x + 60] = 1
    want = []
    for f in range(0, 12, 5):
        nb = list(range(max(0, f - 5), min(12, f + 6)))
        m = torch.from_numpy(masks[nb]).float()[None, ..., None]
        want.append(int(masked_window_bitmap(m).sum()))
    assert flops.signature(masks) == tuple(want)
