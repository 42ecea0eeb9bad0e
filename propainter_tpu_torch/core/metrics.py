"""Evaluation metrics: PSNR, SSIM (skimage-exact, win_size=65), EPE, VFID,
and the warping error E_warp.

The numpy/scipy functions are copies of `propainter_tpu/core/metrics.py`
(pinned to the originals by tests/test_torch_eval_metrics.py; the Frechet
distance calls `sqrtm` as SciPy 1.18 still allows). They match
reference core/metrics.py:12-150 — in particular the SSIM convention
(uniform window 65, sample covariance, data_range=255, per-channel averaged)
that the published ProPainter numbers use. `calculate_warping_error` runs
on tensors over the port's `ops/warp.py`, on a device the caller names.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
from scipy import linalg


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR for [0, 255] images. Reference core/metrics.py:20-37."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


def _ssim_single(im1, im2, win_size=65, data_range=255.0):
    """skimage structural_similarity, gaussian_weights=False,
    use_sample_covariance=True (the defaults the reference hits)."""
    K1, K2 = 0.01, 0.03
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    def f(x):
        return scipy.ndimage.uniform_filter(x, size=win_size)

    ux = f(im1)
    uy = f(im2)
    uxx = f(im1 * im1)
    uyy = f(im2 * im2)
    uxy = f(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux ** 2 + uy ** 2 + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def calculate_ssim(img1: np.ndarray, img2: np.ndarray,
                   win_size: int = 65) -> float:
    """Multichannel SSIM, per-channel averaged (skimage multichannel=True).
    img1/img2: (H, W, C) in [0, 255]."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    vals = [
        _ssim_single(img1[..., c], img2[..., c], win_size)
        for c in range(img1.shape[-1])
    ]
    return float(np.mean(vals))


def calc_psnr_and_ssim(img1, img2):
    """Reference core/metrics.py:39-54."""
    return calculate_psnr(img1, img2), calculate_ssim(img1, img2)


def calculate_epe(flow1: np.ndarray, flow2: np.ndarray) -> float:
    """Mean end-point error; flows (..., 2). Reference core/metrics.py:12-17."""
    return float(np.mean(np.sqrt(np.sum((flow1 - flow2) ** 2, axis=-1))))


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """Frechet distance between gaussians (standard FID formula).
    Reference core/metrics.py:99-150. The JAX package's function, but for
    its `sqrtm(..., disp=False)` call, which SciPy 1.18 refuses."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # the JAX package's `sqrtm(..., disp=False)[0]`: SciPy 1.18 removed
    # `disp`, and without it every version returns the root alone
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_vfid(real_activations: list[np.ndarray],
                   fake_activations: list[np.ndarray]) -> float:
    """VFID over per-video I3D features. Reference core/metrics.py:85-97."""
    m1 = np.mean(real_activations, axis=0)
    m2 = np.mean(fake_activations, axis=0)
    s1 = np.cov(real_activations, rowvar=False)
    s2 = np.cov(fake_activations, rowvar=False)
    return calculate_frechet_distance(m1, s1, m2, s2)


def calculate_warping_error(frames, flows_f, flows_b, device=None) -> float:
    """Temporal warping error E_warp (Lai et al. 2018 formulation): for
    consecutive frames, the occlusion-masked MSE between frame t and frame
    t+1 backward-warped by the forward flow, the occlusion mask from
    forward-backward consistency (|F_f + warp(F_b)|^2 < 0.01 (|F_f|^2 +
    |warp(F_b)|^2) + 0.5). Counterpart of the JAX package's function
    (`propainter_tpu/core/metrics.py:110-138`), in fp32 on `device`.

    Args:
      frames: (T, H, W, 3) uint8 or [0,1] float, numpy array or tensor.
      flows_f: (T-1, H, W, 2) forward flow t -> t+1, array or tensor.
      flows_b: (T-1, H, W, 2) backward flow t+1 -> t.
      device: where to compute (default: flows_f's device, the CPU for a
        numpy array).
    Returns:
      mean occlusion-masked per-pixel MSE (frames scaled to [0, 1]).
    """
    import torch

    from propainter_tpu_torch.ops.warp import fb_consistency_check, flow_warp

    if device is None:
        device = flows_f.device if torch.is_tensor(flows_f) else "cpu"
    f, ff, fb = (torch.as_tensor(x).to(device=device, dtype=torch.float32)
                 for x in (frames, flows_f, flows_b))
    if f.max() > 1.5:
        f = f / 255.0
    cur, nxt = f[:-1], f[1:]
    warped = flow_warp(nxt, ff, "bilinear")
    valid = fb_consistency_check(ff, fb)  # (T-1, H, W, 1), 1 = non-occluded
    err = torch.sum(valid * torch.sum((cur - warped) ** 2, -1, keepdim=True))
    denom = torch.clamp(torch.sum(valid) * 3.0, min=1.0)
    return float(err / denom)
