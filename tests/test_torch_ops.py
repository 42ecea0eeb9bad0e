"""The PyTorch port's tensor ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages; tolerances are
fp32 summation-order noise unless stated. Also: the port imports with jax
and the JAX package blocked, and its host-side copies equal the originals.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from propainter_tpu.ops import interp as jinterp
from propainter_tpu.ops import patches as jpatches
from propainter_tpu.ops import warp as jwarp
from propainter_tpu.utils import masks as jmasks

from propainter_tpu_torch.ops import interp as tinterp
from propainter_tpu_torch.ops import patches as tpatches
from propainter_tpu_torch.ops import warp as twarp
from propainter_tpu_torch.utils import masks as tmasks

ATOL = 1e-5


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), rtol=0,
                               atol=atol)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp(mode):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 9, 13, 4)
    flow = _rand(rng, 2, 9, 13, 2, scale=3.0)
    # exact .5 ties for the nearest rounding rule
    flow[0, :2, :3, 0] = 0.5
    flow[1, 3, :, 1] = -1.5
    _close(jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode),
           twarp.flow_warp(torch.from_numpy(x), torch.from_numpy(flow), mode))


def test_flow_warp_bilinear_nearest():
    rng = np.random.default_rng(1)
    xb, xn = _rand(rng, 1, 10, 12, 3), _rand(rng, 1, 10, 12, 3)
    flow = _rand(rng, 1, 10, 12, 2, scale=4.0)
    flow[0, 0, :4] = 0.5
    jb, jn = jwarp.flow_warp_bilinear_nearest(*map(jnp.asarray,
                                                    (xb, xn, flow)))
    tb, tn = twarp.flow_warp_bilinear_nearest(*map(torch.from_numpy,
                                                    (xb, xn, flow)))
    _close(jb, tb)
    _close(jn, tn, atol=0)


def test_fb_consistency_and_sampler():
    rng = np.random.default_rng(2)
    f1 = _rand(rng, 2, 8, 11, 2, scale=2.0)
    f2 = -f1 + _rand(rng, 2, 8, 11, 2, scale=0.5)
    _close(jwarp.fb_consistency_check(jnp.asarray(f1), jnp.asarray(f2)),
           twarp.fb_consistency_check(torch.from_numpy(f1),
                                      torch.from_numpy(f2)), atol=0)
    img = _rand(rng, 2, 8, 11, 3)
    coords = (np.asarray(jwarp.coords_grid(2, 8, 11))
              + _rand(rng, 2, 8, 11, 2, scale=2.0))
    _close(jwarp.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords)),
           twarp.bilinear_sampler(torch.from_numpy(img),
                                  torch.from_numpy(coords)))
    _close(jwarp.coords_grid(2, 8, 11), twarp.coords_grid(2, 8, 11), atol=0)


@pytest.mark.parametrize("size,method,align", [
    ((15, 27), "bilinear", False), ((60, 108), "bilinear", True),
    ((7, 9), "nearest", False), ((36, 40), "nearest", False)])
def test_resize(size, method, align):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 30, 54, 3)
    # bilinear: the JAX package takes source positions in float64 and
    # lerps as a*(1-w) + b*w, F.interpolate in float32 as a + w*(b-a):
    # a few ulp of |x| <= 5
    _close(jinterp.resize(jnp.asarray(x), size, method, align),
           tinterp.resize(torch.from_numpy(x), size, method, align),
           atol=3e-5)


def test_pools():
    rng = np.random.default_rng(4)
    x = _rand(rng, 3, 15, 27, 2)
    _close(jinterp.avg_pool2d(jnp.asarray(x), 2, 2),
           tinterp.avg_pool2d(torch.from_numpy(x), 2, 2))
    _close(jinterp.max_pool2d(jnp.asarray(x), (7, 7), (3, 3), (3, 3)),
           tinterp.max_pool2d(torch.from_numpy(x), (7, 7), (3, 3), (3, 3)),
           atol=0)


@pytest.mark.parametrize("op", ["unfold", "fold", "overlap_renorm"])
def test_patches(op):
    rng = np.random.default_rng(5)
    k, s, p, out = (7, 7), (3, 3), (3, 3), (20, 26)
    L = (jpatches.unfold_output_size(20, 7, 3, 3)
         * jpatches.unfold_output_size(26, 7, 3, 3))
    if op == "unfold":
        x = _rand(rng, 2, *out, 3)
        args = (k, s, p)
    else:
        x = _rand(rng, 2, L, 3 * 49)
        args = (out, k, s, p)
    _close(getattr(jpatches, op)(jnp.asarray(x), *args),
           getattr(tpatches, op)(torch.from_numpy(x), *args))


def test_mask_helpers_match():
    rng = np.random.default_rng(6)
    m = (rng.uniform(size=(20, 24)) > 0.9).astype(np.uint8)
    for it in (0, 1, 4):
        np.testing.assert_array_equal(jmasks.binary_dilation_cross(m, it),
                                      tmasks.binary_dilation_cross(m, it))
    np.testing.assert_array_equal(jmasks.binary_mask(m * 0.5),
                                  tmasks.binary_mask(m * 0.5))


def test_port_imports_without_jax():
    """The port and every module in it (`parallel/` among them) import with
    jax and the JAX package unavailable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "propainter_tpu"):
            sys.modules[name] = None
        import propainter_tpu_torch
        for m in pkgutil.walk_packages(propainter_tpu_torch.__path__,
                                       "propainter_tpu_torch."):
            importlib.import_module(m.name)
        bad = [n for n in sys.modules
               if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                      "propainter_tpu")
               and sys.modules[n] is not None]
        assert not bad, bad
        # the multi-device helpers and the pipeline that uses them
        for name in ("propainter_tpu_torch.parallel.mesh",
                     "propainter_tpu_torch.pipeline"):
            assert name in sys.modules, name
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
