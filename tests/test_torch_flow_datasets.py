"""RAFT's training data in the PyTorch port against the JAX package on the
CPU: `core/flow_datasets.py` (the five index functions, both augmentors,
`resize_sparse_flow`, `FlowPairDataset`, `ConcatFlowDataset`,
`fetch_flow_dataset`'s chairs, sintel and kitti stages, and two shards of
`PrefetchLoader` over a stage), `utils/file_client.py` and
`utils/download.py`, each a copy of the jax-free original pinned by
source. One seeded miniature tree of every dataset's layout (the
directory layouts of tests/test_flow_datasets.py, with seeded images and
flows); the two packages' arrays are compared exactly, their samples
drawn in the same serial order (a `FlowPairDataset` shares one generator
between loader threads, so only a serial order is reproducible).
"""

import inspect
import os
import random

import numpy as np
import pytest

import propainter_tpu.core.dataset as jax_dataset
import propainter_tpu.core.flow_datasets as JF
import propainter_tpu.utils.download as jax_download
import propainter_tpu.utils.file_client as jax_file_client
from propainter_tpu.utils.flow_io import flowwrite, write_flow_kitti, write_pfm

import propainter_tpu_torch.core.dataset as torch_dataset
import propainter_tpu_torch.core.flow_datasets as TF
import propainter_tpu_torch.utils.download as torch_download
import propainter_tpu_torch.utils.file_client as torch_file_client

cv2 = pytest.importorskip("cv2")

H, W = 40, 56
CROP = (24, 32)


# ---------------------------------------------------------------------------
# Copies pinned by source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mod_j,mod_t", [
    (jax_file_client, torch_file_client), (jax_download, torch_download),
    (JF, TF)], ids=["file_client", "download", "flow_datasets"])
def test_copies_match_the_jax_package(mod_j, mod_t):
    """Each module is the original's source, flow_datasets but for the
    import of `read_flow_any` (the port's `utils/flow_io`)."""
    src_j, src_t = inspect.getsource(mod_j), inspect.getsource(mod_t)
    if mod_t is TF:
        src_j = src_j.replace("from propainter_tpu.utils.flow_io",
                              "from propainter_tpu_torch.utils.flow_io")
        assert "from propainter_tpu_torch.utils.flow_io import read_flow_any" \
            in src_t
    assert src_t == src_j


# ---------------------------------------------------------------------------
# file_client and download
# ---------------------------------------------------------------------------


def test_file_client_disk_and_errors(tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"\x01\x02")
    (tmp_path / "t.txt").write_text("text")
    fc = torch_file_client.FileClient("disk")
    assert fc.get(str(f)) == b"\x01\x02"
    assert fc.get_text(str(tmp_path / "t.txt")) == "text"
    with pytest.raises(ValueError, match="not supported"):
        torch_file_client.FileClient("nosuch")
    with pytest.raises(ImportError, match="lmdb"):
        torch_file_client.FileClient("lmdb", db_paths=str(tmp_path))


def test_file_client_memcached(tmp_path):
    """Against the in-process memcached of tests/test_misc_components.py:
    a miss reads the disk and fills the cache, a hit is served from it,
    and an unreachable server degrades to disk reads."""
    from test_misc_components import _FakeMemcached

    f = tmp_path / "x.bin"
    f.write_bytes(b"payload-123")
    fake = _FakeMemcached()
    try:
        fc = torch_file_client.FileClient(
            "memcached", server=f"127.0.0.1:{fake.port}")
        assert fc.get(str(f)) == b"payload-123"
        assert list(fake.store) == [
            torch_file_client.MemcachedBackend._key(str(f))]
        f.write_bytes(b"changed")
        assert fc.get(str(f)) == b"payload-123"
    finally:
        fake.close()
    fc2 = torch_file_client.FileClient("memcached", server="127.0.0.1:1",
                                       timeout=0.2)
    assert fc2.get(str(f)) == b"changed"


def test_download_offline(tmp_path):
    """A file already in model_dir short-circuits; an unreachable URL
    (a refused local port, a missing file://) raises with the offline
    instructions and leaves no partial file; a file:// URL of a local
    file lands in model_dir through urllib. Nothing leaves this host."""
    load = torch_download.load_file_from_url
    models = tmp_path / "weights"
    models.mkdir()
    (models / "x.pth").write_bytes(b"123")
    assert load("http://localhost:1/x.pth", str(models)) == str(
        models / "x.pth")
    for url in ("http://localhost:1/y.pth",
                (tmp_path / "missing.pth").as_uri()):
        with pytest.raises(RuntimeError, match="offline"):
            load(url, str(models), progress=False)
        assert sorted(os.listdir(models)) == ["x.pth"]
    src = tmp_path / "released" / "ProPainter.pth"
    src.parent.mkdir()
    src.write_bytes(b"weights")
    got = load(src.as_uri(), str(models), progress=False)
    assert got == str(models / "ProPainter.pth")
    assert open(got, "rb").read() == b"weights"
    paths = torch_download.ensure_checkpoints(str(models), ["ProPainter.pth"])
    assert paths == {"ProPainter.pth": got}


# ---------------------------------------------------------------------------
# The datasets
# ---------------------------------------------------------------------------


def _img(rng, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, rng.integers(0, 255, (H, W, 3), dtype=np.uint8))


def _flow(rng, channels=2):
    return (rng.standard_normal((H, W, channels)) * 3).astype(np.float32)


def _sparse(rng, path):
    write_flow_kitti(_flow(rng), path,
                     (rng.random((H, W)) > 0.3).astype(np.float32))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Sintel (2 scenes x 3 frames, clean and final), FlyingChairs (5
    pairs, split 1 2 1 1 1), FlyingThings3D (one sequence of 3 frames, both
    directions, both passes), KITTI (3 pairs), HD1K (2 sequences of 3):
    seeded images, .flo / .pfm / 16-bit PNG flows with random validity."""
    root = tmp_path_factory.mktemp("flow_data")
    rng = np.random.default_rng(0)
    r = {k: str(root / k) for k in ("sintel", "chairs", "things", "kitti",
                                    "hd1k")}
    for scene in ("alley_1", "market_2"):
        for i in range(3):
            for dstype in ("clean", "final"):
                _img(rng, os.path.join(r["sintel"], "training", dstype,
                                       scene, f"frame_{i:04d}.png"))
        for i in range(2):
            flowwrite(_flow(rng), os.path.join(
                r["sintel"], "training", "flow", scene, f"frame_{i:04d}.flo"))
    for i in range(5):
        for k in (1, 2):
            _img(rng, os.path.join(r["chairs"], f"{i:05d}_img{k}.ppm"))
        flowwrite(_flow(rng), os.path.join(r["chairs"], f"{i:05d}_flow.flo"))
    np.savetxt(os.path.join(r["chairs"], "chairs_split.txt"),
               [1, 2, 1, 1, 1], fmt="%d")
    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for i in range(3):
            _img(rng, os.path.join(r["things"], dstype, "TRAIN", "A", "0000",
                                   "left", f"{i:04d}.png"))
    for direction in ("into_future", "into_past"):
        for i in range(3):
            write_pfm(_flow(rng, 3), os.path.join(
                r["things"], "optical_flow", "TRAIN", "A", "0000", direction,
                "left", f"{i:04d}.pfm"))
    for i in range(3):
        for k in (10, 11):
            _img(rng, os.path.join(r["kitti"], "training", "image_2",
                                   f"{i:06d}_{k}.png"))
        _sparse(rng, os.path.join(r["kitti"], "training", "flow_occ",
                                  f"{i:06d}_10.png"))
    for seq in range(2):
        for i in range(3):
            _img(rng, os.path.join(r["hd1k"], "hd1k_input", "image_2",
                                   f"{seq:06d}_{i:02d}.png"))
            _sparse(rng, os.path.join(r["hd1k"], "hd1k_flow_gt", "flow_occ",
                                      f"{seq:06d}_{i:02d}.png"))
    return r


def _indices(mod, r) -> dict:
    return {
        "sintel_clean": mod.sintel_index(r["sintel"], "training", "clean"),
        "sintel_final": mod.sintel_index(r["sintel"], "training", "final"),
        "chairs_train": mod.flying_chairs_index(r["chairs"], "training"),
        "chairs_val": mod.flying_chairs_index(r["chairs"], "validation"),
        "things": mod.flying_things_index(r["things"], "frames_cleanpass"),
        "kitti": mod.kitti_index(r["kitti"], "training"),
        "hd1k": mod.hd1k_index(r["hd1k"]),
    }


def _fields(idx) -> tuple:
    return (idx.image_pairs, idx.flow_paths, idx.extra, idx.sparse)


def _assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_indices_and_items(roots):
    """Every index function gives the JAX package's pairs, flow paths,
    extras and sparsity; the index arithmetic too (a dense + sparse sum
    raises in both); every item of every index, unaugmented, is the JAX
    dataset's, array for array."""
    jidx, tidx = _indices(JF, roots), _indices(TF, roots)
    lens = {k: len(v) for k, v in tidx.items()}
    assert lens == dict(sintel_clean=4, sintel_final=4, chairs_train=4,
                        chairs_val=1, things=4, kitti=3, hd1k=4)
    for k in jidx:
        assert _fields(tidx[k]) == _fields(jidx[k]), k
    assert _fields(3 * tidx["sintel_clean"] + tidx["things"]) == _fields(
        3 * jidx["sintel_clean"] + jidx["things"])
    with pytest.raises(ValueError, match="sparse"):
        tidx["things"] + tidx["kitti"]
    for k in jidx:
        jds, tds = JF.FlowPairDataset(jidx[k]), TF.FlowPairDataset(tidx[k])
        for i in range(len(tds)):
            _assert_items_equal(tds[i], jds[i])


def test_augmentors_and_sparse_resize(roots):
    """FlowAugmentor and SparseFlowAugmentor (with and without flips)
    from equal generators give the JAX package's crops, bit for bit, over
    20 seeds; resize_sparse_flow moves each measurement as the
    original does, up and down."""
    rng = np.random.default_rng(1)
    img1, img2 = (rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
                  for _ in range(2))
    flow = _flow(rng)
    valid = (rng.random((H, W)) > 0.5).astype(np.float32)
    for fx, fy in ((1.7, 1.3), (0.6, 0.8)):
        for a, b in zip(TF.resize_sparse_flow(flow, valid, fx, fy),
                        JF.resize_sparse_flow(flow, valid, fx, fy)):
            np.testing.assert_array_equal(a, b)
    for seed in range(20):
        for kind, args in (("FlowAugmentor", (flow,)),
                           ("SparseFlowAugmentor", (flow, valid))):
            for flip in (True, False):
                got = getattr(TF, kind)(CROP, do_flip=flip)(
                    np.random.default_rng(seed), img1, img2, *args)
                want = getattr(JF, kind)(CROP, do_flip=flip)(
                    np.random.default_rng(seed), img1, img2, *args)
                assert got[0].shape == (*CROP, 3)
                for a, b in zip(got, want):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stage", ["chairs", "sintel", "kitti"])
def test_fetch_flow_dataset_stages(roots, stage):
    """fetch_flow_dataset at each stage's recipe (its augmentation ranges
    and mixture weights; sintel's 100 x clean + 100 x final + things,
    200 x kitti and 5 x hd1k through ConcatFlowDataset) has the JAX
    dataset's length, and 12 items drawn serially in the same order (the
    mixture's dense, KITTI and HD1K parts among them) equal the JAX
    dataset's."""
    jds = JF.fetch_flow_dataset(stage, CROP, roots=roots, seed=3)
    tds = TF.fetch_flow_dataset(stage, CROP, roots=roots, seed=3)
    assert type(tds).__name__ == type(jds).__name__
    assert len(tds) == len(jds)
    if stage == "sintel":
        assert len(tds) == 100 * 4 + 100 * 4 + 4 + 200 * 3 + 5 * 4
    order = np.random.default_rng(4).permutation(len(tds))[:12]
    if stage == "sintel":
        order = np.concatenate([order, [len(tds) - 1, 820]])
    for i in order:
        got, want = tds[int(i)], jds[int(i)]
        assert got["image1"].shape == (*CROP, 3)
        assert got["valid"].shape == CROP
        _assert_items_equal(got, want)


def test_two_shard_prefetch_loader(roots):
    """Two shards of the port's PrefetchLoader over the chairs stage
    (4 training pairs; one worker each, a dataset each): each shard's
    first epoch is its stride of the epoch's permutation, the two
    disjoint; its batches are the dataset's items at those indices drawn
    serially, and equal the JAX loader's for the same shard."""
    order = list(range(4))
    random.Random(6).shuffle(order)
    seen = []
    for shard in (0, 1):
        want = order[shard::2]
        ref = TF.fetch_flow_dataset("chairs", CROP, roots=roots, seed=5)
        ref = [ref[i] for i in want]
        loaders = [mod_d.PrefetchLoader(
            mod_f.fetch_flow_dataset("chairs", CROP, roots=roots, seed=5),
            1, num_workers=1, prefetch=2, seed=6, shard_index=shard,
            num_shards=2)
            for mod_d, mod_f in ((torch_dataset, TF), (jax_dataset, JF))]
        try:
            got = [[lo.next() for _ in want] for lo in loaders]
        finally:
            for lo in loaders:
                lo.stop()
        for item, port, jax_ in zip(ref, *got):
            assert port["image1"].shape == (1, *CROP, 3)
            _assert_items_equal(port, {k: v[None] for k, v in item.items()})
            _assert_items_equal(port, jax_)
        seen.append(set(want))
    assert not seen[0] & seen[1] and seen[0] | seen[1] == set(range(4))
