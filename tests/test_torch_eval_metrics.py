"""The PyTorch port's evaluation pieces against the JAX package on the CPU:
the copies of the jax-free helpers (flow I/O, flow visualisation, the
numpy metrics, `TestDataset`, I3D's SAME padding, the RAFT demo's `pad8`)
pinned to the originals by source and by result, the warping error on
tensors, and `InceptionI3d` (VFID's feature network) against the JAX
module, from a flax tree and from a checkpoint in the released layout.
"""

import inspect
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from propainter_tpu.cli import raft_demo as jax_raft_demo
from propainter_tpu.core import dataset as jax_dataset
from propainter_tpu.core import metrics as jax_metrics
from propainter_tpu.models import i3d as jax_i3d
from propainter_tpu.utils import flow_io as jax_flow_io
from propainter_tpu.utils import flow_viz as jax_flow_viz

from propainter_tpu_torch.cli import raft_demo as torch_raft_demo
from propainter_tpu_torch.cli.inference import load_checkpoint
from propainter_tpu_torch.core import dataset as torch_dataset
from propainter_tpu_torch.core import metrics as torch_metrics
from propainter_tpu_torch.models import i3d as torch_i3d
from propainter_tpu_torch.models.layers import FrozenBatchNorm
from propainter_tpu_torch.utils import flow_io as torch_flow_io
from propainter_tpu_torch.utils import flow_viz as torch_flow_viz
from propainter_tpu_torch.weights import seeded_init_, state_dict_from_flax

CLIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "demo_clip")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch intra-op thread for the file, its module-scoped fixtures
    included (an autouse fixture is set up before the others of its
    scope): the suite runs this file beside other pytest-xdist workers,
    and PyTorch's default of one OpenMP thread per core in every worker
    oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COPIES = [(jax_flow_io, torch_flow_io, n) for n in (
    "flowread", "flowwrite", "read_pfm", "write_pfm", "read_flow_kitti",
    "write_flow_kitti", "read_flow_any", "resize_flow")]
COPIES += [(jax_flow_viz, torch_flow_viz, n)
           for n in ("make_colorwheel", "flow_to_image")]
COPIES += [(jax_metrics, torch_metrics, n) for n in (
    "calculate_psnr", "_ssim_single", "calculate_ssim", "calc_psnr_and_ssim",
    "calculate_epe", "calculate_vfid")]
COPIES += [(jax_dataset, torch_dataset, "TestDataset"),
           (jax_i3d, torch_i3d, "_same_pad"),
           (jax_raft_demo, torch_raft_demo, "pad8")]


@pytest.mark.parametrize("mod_j, mod_t, name", COPIES,
                         ids=[c[2] for c in COPIES])
def test_copies_match_the_jax_package(mod_j, mod_t, name):
    """The port's copies of the JAX package's jax-free helpers have the
    originals' source."""
    assert (inspect.getsource(getattr(mod_t, name))
            == inspect.getsource(getattr(mod_j, name)))


def test_frechet_distance_matches_jax():
    """The Frechet distance (its `sqrtm` call differs: SciPy 1.18 removed
    the JAX package's `disp=False`) equals the JAX function's to 1e-9
    relative on seeded 64-d statistics, and VFID over 20 videos too; the
    rest of its source is the original's."""
    import re

    rng = np.random.default_rng(6)
    a = [rng.standard_normal(64) for _ in range(20)]
    b = [x * 1.1 + 0.3 for x in a]
    for f in ("calculate_frechet_distance", "calculate_vfid"):
        args = ((np.mean(a, 0), np.cov(a, rowvar=False), np.mean(b, 0),
                 np.cov(b, rowvar=False)) if f.startswith("calculate_f")
                else (a, b))
        want = getattr(jax_metrics, f)(*args)
        assert want > 1.0
        assert getattr(torch_metrics, f)(*args) == pytest.approx(want,
                                                                rel=1e-9)
    code = [re.sub(r"#.*|\s+", "", inspect.getsource(
        m.calculate_frechet_distance).split('"""')[2])
        for m in (torch_metrics, jax_metrics)]
    assert code[0] == code[1].replace(
        "covmean,_=linalg.sqrtm(sigma1.dot(sigma2),disp=False)",
        "covmean=linalg.sqrtm(sigma1.dot(sigma2))")


def test_flow_io_and_viz_results(tmp_path):
    """The copies give the originals' results: .flo (fp32 and fp16), PFM
    and KITTI files written by one package read by the other, bit for bit,
    and the flow colours of one flow equal."""
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 8, (9, 13, 2)).astype(np.float32)
    for quantize in (False, True):
        p = str(tmp_path / f"a{int(quantize)}.flo")
        torch_flow_io.flowwrite(flow, p, quantize=quantize)
        np.testing.assert_array_equal(jax_flow_io.flowread(p),
                                      torch_flow_io.flowread(p))
        np.testing.assert_array_equal(
            torch_flow_io.flowread(p),
            flow.astype(np.float16).astype(np.float32) if quantize else flow)
    pfm = np.dstack([flow, np.zeros((9, 13, 1), np.float32)])
    jax_flow_io.write_pfm(pfm, str(tmp_path / "a.pfm"))
    png = str(tmp_path / "a.png")
    jax_flow_io.write_flow_kitti(flow, png)
    np.testing.assert_array_equal(
        torch_flow_io.read_flow_any(str(tmp_path / "a.pfm")),
        jax_flow_io.read_flow_any(str(tmp_path / "a.pfm")))
    for g, w in zip(torch_flow_io.read_flow_any(png),
                    jax_flow_io.read_flow_any(png)):   # (flow, valid)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(torch_flow_io.resize_flow(flow, (18, 26)),
                                  jax_flow_io.resize_flow(flow, (18, 26)))
    np.testing.assert_array_equal(torch_flow_viz.flow_to_image(flow),
                                  jax_flow_viz.flow_to_image(flow))


@pytest.fixture(scope="module")
def fixture_dataset(tmp_path_factory):
    """Two copies of the fixture clip in the DAVIS layout,
    with a test.json and each video's fp16 .flo files."""
    root = tmp_path_factory.mktemp("eval_ds")
    rng = np.random.default_rng(1)
    names = {}
    for v in ("clip_a", "clip_b"):
        shutil.copytree(os.path.join(CLIP, "frames"), root / "videos" / v)
        shutil.copytree(os.path.join(CLIP, "masks"), root / "masks" / v)
        files = sorted(os.listdir(root / "videos" / v))
        for cur, nxt in zip(files[:-1], files[1:]):
            for name in (f"{cur[:-4]}_{nxt[:-4]}_f.flo",
                         f"{nxt[:-4]}_{cur[:-4]}_b.flo"):
                torch_flow_io.flowwrite(
                    rng.normal(0, 4, (120, 216, 2)).astype(np.float32),
                    str(root / "flows" / v / name), quantize=True)
        names[v] = len(files)
    with open(root / "test.json", "w") as f:
        json.dump(names, f)
    return root


@pytest.mark.parametrize("load_flow", [False, True])
def test_test_dataset_items_equal_the_jax_dataset(fixture_dataset, load_flow):
    """`TestDataset` items (resized frames, dilated masks, and the .flo
    flows when asked) equal the JAX `TestDataset`'s exactly."""
    kw = dict(video_root=str(fixture_dataset / "videos"),
              mask_root=str(fixture_dataset / "masks"),
              json_path=str(fixture_dataset / "test.json"), w=96, h=64,
              flow_root=str(fixture_dataset / "flows"), load_flow=load_flow)
    got, want = torch_dataset.TestDataset(**kw), jax_dataset.TestDataset(**kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        assert a["frames"].shape == (12, 64, 96, 3)
        assert a["masks"].any()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_warping_error_matches_jax():
    """`calculate_warping_error` on tensors within 1e-6 relative of the JAX
    function on seeded frames and flows (T = 4, 32 x 48), from uint8 frames
    and from [0, 1] floats; fp32 sums in another order are all that
    differs."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (4, 32, 48, 3), np.uint8)
    ff = rng.normal(0, 3, (3, 32, 48, 2)).astype(np.float32)
    fb = (-ff + rng.normal(0, 1, ff.shape)).astype(np.float32)
    for f in (frames, frames.astype(np.float32) / 255.0):
        want = jax_metrics.calculate_warping_error(f, ff, fb)
        got = torch_metrics.calculate_warping_error(
            f, torch.from_numpy(ff), torch.from_numpy(fb), device="cpu")
        assert want > 0
        assert got == pytest.approx(want, rel=1e-6)


def test_frozen_batch_norm_ranks():
    """FrozenBatchNorm over NCDHW equals BatchNorm3d in eval mode (I3D's BN,
    eps 1e-3) to 1e-6, and over NCHW it gives what the 4-D form computed
    before, bit for bit."""
    torch.manual_seed(0)
    bn = FrozenBatchNorm(6, eps=1e-3)
    seeded_init_(bn, 3, fan_in_scaled=True)
    ref = torch.nn.BatchNorm3d(6, eps=1e-3).eval()
    ref.load_state_dict(bn.state_dict())
    x = torch.randn(2, 6, 3, 5, 7)
    torch.testing.assert_close(bn(x), ref(x), rtol=1e-6, atol=1e-6)
    x4 = torch.randn(2, 6, 5, 7)
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    before = ((x4 - bn.running_mean[:, None, None]) * inv[:, None, None]
              + bn.bias[:, None, None])
    assert torch.equal(bn(x4), before)


@pytest.fixture(scope="module")
def jax_i3d_apply():
    model = jax_i3d.InceptionI3d()
    return jax.jit(lambda p, v: model.apply({"params": p}, v))


def _seeded_flax_tree(shapes, rng):
    """A flax parameter tree of I3D's shapes with seeded values: conv
    kernels he-normal, every batch-norm leaf distinct (scale and variance
    around 1, bias and mean around 0), so a swap of two leaves shows."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-1])),
                              s.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _features(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def test_i3d_matches_jax_from_flax_tree(jax_i3d_apply):
    """InceptionI3d with the weights of a seeded flax tree
    (`state_dict_from_flax`, no renames) gives the JAX InceptionI3d's
    features within 1e-4 of their scale on a seeded (1, 8, 64, 64, 3)
    video (odd sizes through the network exercise the asymmetric SAME
    pads)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, 8, 64, 64, 3)).astype(np.float32)
    shapes = jax.eval_shape(jax_i3d.InceptionI3d().init,
                            jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tree = _seeded_flax_tree(shapes, rng)
    module = torch_i3d.InceptionI3d().eval()
    module.load_state_dict(state_dict_from_flax(module, tree), strict=True)
    got = _features(module, x)
    want = np.asarray(jax_i3d_apply(tree, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1024)
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_i3d_released_layout(tmp_path, jax_i3d_apply):
    """A seeded port checkpoint with a `logits.*` head, as
    i3d_rgb_imagenet.pt has one, and without batch-norm counters, loads
    into the port through its loader (head dropped, counters taken from
    the module) and into the JAX package through
    `convert_i3d_state_dict(load_torch_checkpoint(...))`, which pins the
    port's key names to the released layout; the features agree within
    1e-4 of their scale. Without the drop the strict load refuses the
    head."""
    from propainter_tpu.convert.torch_to_jax import load_torch_checkpoint

    module = torch_i3d.InceptionI3d()
    seeded_init_(module, 5, fan_in_scaled=True)
    gen = torch.Generator().manual_seed(5)
    for child in module.modules():
        if isinstance(child, FrozenBatchNorm):
            child.weight.data.uniform_(0.5, 1.5, generator=gen)
    # no `num_batches_tracked`: a checkpoint saved before PyTorch kept
    # the counter, which torch's BatchNorm (the reference's) loads
    sd = {k: v for k, v in module.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    sd["logits.conv3d.weight"] = torch.randn(400, 1024, 1, 1, 1,
                                             generator=gen) * 0.03
    sd["logits.conv3d.bias"] = torch.zeros(400)
    path = str(tmp_path / "i3d_rgb_imagenet.pt")
    torch.save(sd, path)

    loaded = load_checkpoint(torch_i3d.InceptionI3d(), path,
                             drop_prefixes=("logits.",)).eval()
    with pytest.raises(RuntimeError, match="logits"):
        load_checkpoint(torch_i3d.InceptionI3d(), path)
    params = jax_i3d.convert_i3d_state_dict(load_torch_checkpoint(path))
    x = np.random.default_rng(4).uniform(
        -1, 1, (1, 8, 64, 64, 3)).astype(np.float32)
    got = _features(loaded, x)
    want = np.asarray(jax_i3d_apply(params, jnp.asarray(x)))
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
