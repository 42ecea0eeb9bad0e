"""Training losses (NHWC tensors). Counterpart of
`propainter_tpu/core/losses.py`, the reference's loss suite:
  * hole/valid L1 (core/trainer.py:403-427 weighting),
  * hinge / lsgan / nsgan adversarial (core/loss.py:144-180),
  * VGG perceptual and LPIPS (core/loss.py:6-141),
  * flow completion losses: masked L1, 1st/2nd-order Charbonnier
    smoothness, ternary census warp (model/modules/flow_comp_raft.py:59-204,
    flow_loss_utils.py:89-141),
  * pos/neg-weighted edge BCE (model/modules/flow_comp_raft.py:207-244).

Under data parallelism (`parallel.mesh`) each rank holds a shard of the
batch. The JAX steps take these losses over the whole batch, so the
losses divided by a mask's mean divide by its mean over every rank's
shard (`batch_mean`); every other term is a mean over the batch, which
the trainer's gradient average makes global.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from propainter_tpu_torch.ops.interp import constant_on
from propainter_tpu_torch.ops.warp import flow_warp
from propainter_tpu_torch.parallel.mesh import all_reduce_mean, world_size


# ---------------------------------------------------------------------------
# Generic / GAN
# ---------------------------------------------------------------------------


def l1(x, y):
    return torch.mean(torch.abs(x - y))


def batch_mean(x):
    """torch.mean(x) over the whole batch: on one rank torch.mean itself;
    across ranks (equal shards) the mean of every rank's mean. For masks,
    which carry no gradient."""
    if world_size() == 1:
        return torch.mean(x)
    return all_reduce_mean([torch.mean(x.detach())])[0]


def hole_valid_l1(pred, gt, mask, hole_weight=1.0, valid_weight=1.0):
    """ProPainter generator reconstruction losses (core/trainer.py:403-412)."""
    hole = l1(pred * mask, gt * mask) / batch_mean(mask)
    valid = l1(pred * (1 - mask), gt * (1 - mask)) / batch_mean(1 - mask)
    return hole_weight * hole + valid_weight * valid, hole, valid


def _bce(probs, target: float):
    """nn.BCELoss on probabilities, with its log clamp at -100."""
    logp = torch.clamp_min(torch.log(probs), -100.0)
    log1mp = torch.clamp_min(torch.log1p(-probs), -100.0)
    return -torch.mean(target * logp + (1.0 - target) * log1mp)


def adversarial_g_loss(fake_out, gan_type: str = "hinge"):
    """Generator-side GAN loss (core/loss.py:160-180, is_disc=False).
    fake_out: raw logits for 'hinge', sigmoid probabilities for 'nsgan' and
    'lsgan' (the discriminator's use_sigmoid = gan_type != 'hinge')."""
    if gan_type == "hinge":
        return -torch.mean(fake_out)
    if gan_type == "lsgan":
        return torch.mean((fake_out - 1.0) ** 2)
    if gan_type == "nsgan":
        return _bce(fake_out, 1.0)
    raise ValueError(gan_type)


def adversarial_d_loss(real_out, fake_out, gan_type: str = "hinge"):
    """Discriminator-side GAN loss, (real + fake) / 2
    (core/trainer.py:430-441). Inputs as in adversarial_g_loss."""
    if gan_type == "hinge":
        real = torch.mean(F.relu(1.0 - real_out))
        fake = torch.mean(F.relu(1.0 + fake_out))
        return (real + fake) / 2.0
    if gan_type == "lsgan":
        return (torch.mean((real_out - 1.0) ** 2)
                + torch.mean(fake_out ** 2)) / 2.0
    if gan_type == "nsgan":
        return (_bce(real_out, 1.0) + _bce(fake_out, 0.0)) / 2.0
    raise ValueError(gan_type)


# ---------------------------------------------------------------------------
# Perceptual losses (VGG / LPIPS)
# ---------------------------------------------------------------------------


def perceptual_loss(vgg, layer_weights: dict, x, gt, criterion: str = "l1",
                    style_weight: float = 0.0):
    """Layer-weighted VGG perceptual (+ optional Gram style) loss.
    Reference core/loss.py:6-114.

    vgg: images (B, H, W, 3) -> {layer_name: (B, h, w, c)}, e.g. a
    `VGGFeatureExtractor`. Returns (percep_loss, style_loss), style_loss
    None when style_weight is 0."""
    xf = vgg(x)
    with torch.no_grad():
        gf = vgg(gt)

    def crit(a, b):
        if criterion == "l1":
            return torch.mean(torch.abs(a - b))
        if criterion in ("l2", "mse"):
            return torch.mean(torch.square(a - b))
        if criterion == "fro":
            return torch.linalg.norm((a - b).reshape(-1))
        raise ValueError(criterion)

    percep = sum(crit(xf[k], gf[k]) * w for k, w in layer_weights.items())

    style = None
    if style_weight > 0:
        def gram(f):
            b, h, w, c = f.shape
            f2 = f.reshape(b, h * w, c)
            return torch.einsum("bnc,bnd->bcd", f2, f2) / (c * h * w)

        style = sum(
            crit(gram(xf[k]), gram(gf[k])) * w
            for k, w in layer_weights.items()) * style_weight
    return percep, style


def lpips_loss(lpips, pred, gt, loss_weight: float = 1.0,
               use_input_norm: bool = True, range_norm: bool = True):
    """LPIPS distance averaged over the batch, as the reference's
    LPIPSLoss(use_input_norm=True, range_norm=True): [-1, 1] inputs mapped
    to [0, 1] and ImageNet-normalised before the LPIPS net, which scales
    them again (a reference quirk kept). Reference core/loss.py:116-141.
    lpips: (pred, target) -> (B,) distances, e.g. an `LPIPSVgg`."""
    if range_norm:
        pred = (pred + 1.0) / 2.0
        gt = (gt + 1.0) / 2.0
    if use_input_norm:
        mean = pred.new_tensor([0.485, 0.456, 0.406])
        std = pred.new_tensor([0.229, 0.224, 0.225])
        pred = (pred - mean) / std
        gt = (gt - mean) / std
    return loss_weight * torch.mean(lpips(pred, gt.detach()))


# ---------------------------------------------------------------------------
# Flow-completion losses
# ---------------------------------------------------------------------------


def charbonnier(x, mask=None, alpha=0.45, beta=1.0, eps=0.001):
    """Generalised Charbonnier, normalised by the element count
    (model/modules/flow_comp_raft.py:94-110)."""
    norm = float(np.prod(x.shape))
    error = torch.pow(torch.square(x * beta) + eps * eps, alpha)
    if mask is not None:
        error = mask * error
    return torch.sum(error) / norm


def _conv2d_fixed(x, kernels):
    """(B, H, W, 1) correlated with a stack of 3x3 kernels, zero padding
    -> (B, H, W, K)."""
    k = constant_on(np.asarray(kernels, np.float32)[:, None], x.dtype,
                    x.device)
    return F.conv2d(x.permute(0, 3, 1, 2), k, padding=1).permute(0, 2, 3, 1)


_FILTER_X = np.array([[0, 0, 0], [0, 1, -1], [0, 0, 0]], np.float32)
_FILTER_Y = np.array([[0, 0, 0], [0, 1, 0], [0, -1, 0]], np.float32)
_FILTER_X2 = np.array([[0, 0, 0], [1, -2, 1], [0, 0, 0]], np.float32)
_FILTER_Y2 = np.array([[0, 1, 0], [0, -2, 0], [0, 1, 0]], np.float32)
_FILTER_D1 = np.array([[1, 0, 0], [0, -2, 0], [0, 0, 1]], np.float32)
_FILTER_D2 = np.array([[0, 0, 1], [0, -2, 0], [1, 0, 0]], np.float32)


def smoothness_loss(flow, cmask):
    """1st-order Charbonnier smoothness (flow (B, H, W, 2), cmask (B, H, W,
    1)). Reference flow_comp_raft.py:59-84, which computes but does not
    apply the border mask."""
    ks = np.stack([_FILTER_X, _FILTER_Y])
    du = _conv2d_fixed(flow[..., 0:1], ks)
    dv = _conv2d_fixed(flow[..., 1:2], ks)
    return charbonnier(du, cmask) + charbonnier(dv, cmask)


def second_order_loss(flow, cmask):
    """2nd-order Charbonnier smoothness. Reference flow_comp_raft.py:87-140."""
    ks = np.stack([_FILTER_X2, _FILTER_Y2, _FILTER_D1, _FILTER_D2])
    du = _conv2d_fixed(flow[..., 0:1], ks)
    dv = _conv2d_fixed(flow[..., 1:2], ks)
    return charbonnier(du, cmask) + charbonnier(dv, cmask)


def rgb2gray(img):
    """(B, H, W, 3) -> (B, H, W, 1), with the reference's 0.110 blue weight
    (flow_loss_utils.py:83-86)."""
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + 0.110 * img[..., 2]
    return g[..., None]


def ternary_transform(image, max_distance=1):
    """Census transform. Reference flow_loss_utils.py:89-99."""
    patch_size = 2 * max_distance + 1
    intensities = rgb2gray(image) * 255.0
    out_channels = patch_size * patch_size
    w = np.eye(out_channels, dtype=np.float32).reshape(
        out_channels, patch_size, patch_size)
    transf = _conv2d_fixed(intensities, w) - intensities
    return transf / torch.sqrt(0.81 + torch.square(transf))


def hamming_distance(t1, t2):
    dist = torch.square(t1 - t2)
    return torch.sum(dist / (0.1 + dist), dim=-1, keepdim=True)


def ternary_loss(flow_comp, flow_gt, mask, current_frame, shift_frame):
    """Census warp loss. Reference flow_comp_raft.py:163-171."""
    warped_sc = flow_warp(shift_frame, flow_gt)
    noc_mask = torch.exp(-50.0 * torch.square(torch.sum(
        torch.abs(current_frame - warped_sc), dim=-1)))[..., None]
    warped_comp_sc = flow_warp(shift_frame, flow_comp)
    dist = hamming_distance(ternary_transform(current_frame),
                            ternary_transform(warped_comp_sc))
    return torch.mean(dist * noc_mask * mask) / batch_mean(mask)


def flow_loss(pred_flows, gt_flows, masks, frames):
    """Flow-completion loss (L1 + smoothness, and the census warp loss).
    Reference flow_comp_raft.py:173-204.

    pred_flows / gt_flows: [fwd, bwd], each (B, T-1, H, W, 2); masks (B, T,
    H, W, 1); frames (B, T, H, W, 3). Returns (loss, warp_loss)."""
    loss = 0.0
    warp_loss = 0.0
    m = [masks[:, :-1], masks[:, 1:]]
    frames0, frames1 = frames[:, :-1], frames[:, 1:]
    currents = [frames0, frames1]
    nexts = [frames1, frames0]
    H, W = pred_flows[0].shape[2:4]

    for i in range(2):
        combined = pred_flows[i] * m[i] + gt_flows[i] * (1 - m[i])
        l1_loss = (l1(pred_flows[i] * m[i], gt_flows[i] * m[i])
                   / batch_mean(m[i]))
        l1_loss = l1_loss + (
            l1(pred_flows[i] * (1 - m[i]), gt_flows[i] * (1 - m[i]))
            / batch_mean(1 - m[i]))
        cf = combined.reshape(-1, H, W, 2)
        mf = m[i].reshape(-1, H, W, 1)
        loss = loss + l1_loss + smoothness_loss(cf, mf) + second_order_loss(
            cf, mf)
        warp_loss = warp_loss + ternary_loss(
            cf, gt_flows[i].reshape(-1, H, W, 2), mf,
            currents[i].reshape(-1, H, W, 3), nexts[i].reshape(-1, H, W, 3))
    return loss, warp_loss


def flow_simple_loss(pred_flows, gt_flows):
    """L1 of predicted flows against area-downscaled, magnitude-rescaled GT
    flows. Reference FlowSimpleLoss (flow_comp_raft.py:247-265), unused by
    the released configs.

    pred_flows / gt_flows: [fwd, bwd], each (B, T-1, h, w, 2) / (B, T-1, H,
    W, 2) with H / h == W / w an integer (area resize at an integer factor is
    average pooling)."""
    loss = 0.0
    for pf, gf in zip(pred_flows, gt_flows):
        h, w = pf.shape[2:4]
        H, W = gf.shape[2:4]
        if H % h or W % w:
            raise ValueError("area resize needs an integer factor")
        fy, fx = H // h, W // w
        g = gf.reshape(-1, h, fy, w, fx, 2).mean(dim=(2, 4)) * (h / H)
        loss = loss + torch.mean(torch.abs(pf.reshape(-1, h, w, 2) - g))
    return loss


def edge_bce(pred_edges, gt_edges):
    """Pos/neg-weighted BCE-with-logits of edges that are already
    probabilities (the reference passes sigmoided edges to
    BCEWithLogits). Reference flow_comp_raft.py:207-226."""
    mask = (gt_edges > 0.5).to(pred_edges.dtype)
    num_pos = torch.sum(mask, dim=(1, 2, 3))
    total = float(np.prod(mask.shape[1:]))
    num_neg = total - num_pos
    neg_w = (num_neg / total)[:, None, None, None]
    pos_w = (num_pos / total)[:, None, None, None]
    weight = neg_w * mask + pos_w * (1 - mask)
    x, y = pred_edges, gt_edges
    losses = torch.clamp_min(x, 0) - x * y + torch.log1p(
        torch.exp(-torch.abs(x)))
    return torch.mean(weight * losses)


def edge_loss(pred_edges, gt_edges, masks):
    """Edge loss over both directions. Reference flow_comp_raft.py:228-244."""
    loss = 0.0
    m = [masks[:, :-1], masks[:, 1:]]
    H, W = pred_edges[0].shape[2:4]
    for i in range(2):
        combined = pred_edges[i] * m[i] + gt_edges[i] * (1 - m[i])
        loss = loss + (edge_bce(pred_edges[i].reshape(-1, H, W, 1),
                                gt_edges[i].reshape(-1, H, W, 1))
                       + 5 * edge_bce(combined.reshape(-1, H, W, 1),
                                      gt_edges[i].reshape(-1, H, W, 1)))
    return loss
