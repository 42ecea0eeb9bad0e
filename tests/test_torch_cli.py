"""The PyTorch port's inference CLI (`propainter_tpu_torch.cli.inference`)
on the CPU, run through its argparse main() as a user would, on the
committed fixture clip `assets/demo_clip` at tiny sizes, as
tests/test_cli_e2e.py runs the JAX CLI: inpainting with --save_frames,
outpainting, and --bf16. The inpainting run loads seeded checkpoints in
the released `.pth` layout, and the JAX CLI converts the same files
through its `convert_*_state_dict`: the frames of the two agree, which
also pins the port's key names to the reference checkpoints'. The copies
of the JAX package's I/O helpers are pinned to the originals.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from propainter_tpu.utils import masks as jax_masks
from propainter_tpu.utils import video as jax_video

from propainter_tpu_torch.cli.inference import CHECKPOINTS, main
from propainter_tpu_torch.models.flow_completion import (
    RecurrentFlowCompleteNet)
from propainter_tpu_torch.models.propainter import InpaintGenerator
from propainter_tpu_torch.models.raft import RAFT
from propainter_tpu_torch.utils import masks as torch_masks
from propainter_tpu_torch.utils import video as torch_video
from propainter_tpu_torch.weights import seeded_init_

CLIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo_clip")
SMALL = ["--raft_iter", "2", "--subvideo_length", "80",
         "--neighbor_length", "4", "--ref_stride", "4"]


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


def _frames(save_root):
    import cv2

    return np.stack([cv2.imread(str(p)) for p in
                     sorted((save_root / "frames").glob("*.png"))])


def _seeded_checkpoints(root):
    """The three released checkpoint files of seeded weights (RAFT's keys
    with its DataParallel `module.` prefix, as raft-things.pth has
    them)."""
    for seed, (name, module) in enumerate((
            ("raft", RAFT()), ("flowcomp", RecurrentFlowCompleteNet()),
            ("inpaint", InpaintGenerator()))):
        sd = seeded_init_(module, 20 + seed).state_dict()
        if name == "raft":
            sd = {"module." + k: v for k, v in sd.items()}
        torch.save(sd, root / CHECKPOINTS[name])


def test_cli_inpainting_save_frames_matches_jax_cli(tmp_path):
    """Inpainting with --save_frames from the released checkpoint layout:
    12 PNGs of 64 x 96 and both videos; the JAX CLI on the same files and
    flags gives frames within 2 LSB (the golden's allowance for fp32
    summation order between XLA's and PyTorch's CPU convolutions)."""
    from propainter_tpu.cli.inference import main as jax_main

    weights = tmp_path / "weights"
    weights.mkdir()
    _seeded_checkpoints(weights)
    args = ["--video", os.path.join(CLIP, "frames"),
            "--mask", os.path.join(CLIP, "masks"),
            "--height", "64", "--width", "96", *SMALL,
            "--weights", str(weights), "--save_frames"]
    main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    save_root = tmp_path / "port" / "frames"
    assert (save_root / "inpaint_out.mp4").exists()
    assert (save_root / "masked_in.mp4").exists()
    got = _frames(save_root)
    assert got.shape == (12, 64, 96, 3)

    jax_main(args + ["--output", str(tmp_path / "jax")])
    want = _frames(tmp_path / "jax" / "frames")
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2, (diff.max(), diff.mean())


def test_cli_outpainting(tmp_path):
    out = tmp_path / "results"
    main(["--video", os.path.join(CLIP, "frames"),
          "--mask", os.path.join(CLIP, "masks"),  # unused in outpainting
          "--output", str(out), "--mode", "video_outpainting",
          "--scale_h", "1.0", "--scale_w", "1.2",
          "--height", "64", "--width", "80", *SMALL,
          "--weights", "random", "--device", "cpu"])
    import cv2

    vid = cv2.VideoCapture(str(out / "frames" / "inpaint_out.mp4"))
    ok, frame = vid.read()
    assert ok
    # outpainted width: 80 * 1.2 = 96 (already /8-aligned)
    assert frame.shape[1] == 96 and frame.shape[0] == 64


def test_cli_bf16_and_device(tmp_path):
    """--bf16 runs (the flag the JAX package's users get by default); the
    default device is the GPU, so without one the CLI raises unless asked
    for the CPU."""
    out = tmp_path / "results"
    args = ["--video", os.path.join(CLIP, "frames"),
            "--mask", os.path.join(CLIP, "masks"), "--output", str(out),
            "--height", "64", "--width", "96", *SMALL, "--weights", "random",
            "--bf16", "--save_frames"]
    main(args + ["--device", "cpu"])
    frames = _frames(out / "frames")
    assert frames.shape == (12, 64, 96, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(args)


@pytest.mark.parametrize("name", ["read_frames", "resize_frames",
                                  "write_video", "write_frames",
                                  "overlay_mask_green", "_load_mask_image",
                                  "read_masks", "prepare_outpainting"])
def test_io_copies_match_the_jax_package(name):
    """The port's copies of the JAX package's jax-free I/O helpers have the
    originals' source, and the mask helpers their results on the
    fixture."""
    mod_j, mod_t = ((jax_video, torch_video) if hasattr(jax_video, name)
                    else (jax_masks, torch_masks))
    assert (inspect.getsource(getattr(mod_t, name))
            == inspect.getsource(getattr(mod_j, name)))
    if name == "read_masks":
        for a, b in zip(jax_masks.read_masks(os.path.join(CLIP, "masks"), 12,
                                             (96, 64), 4, 4),
                        torch_masks.read_masks(os.path.join(CLIP, "masks"),
                                               12, (96, 64), 4, 4)):
            np.testing.assert_array_equal(a, b)
    if name == "prepare_outpainting":
        f = np.random.default_rng(0).integers(0, 255, (2, 64, 80, 3),
                                              np.uint8)
        for a, b in zip(jax_masks.prepare_outpainting(f, (1.0, 1.2)),
                        torch_masks.prepare_outpainting(f, (1.0, 1.2))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
