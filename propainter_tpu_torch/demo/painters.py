"""Mask / point / contour painting for the interactive demo (pure numpy+cv2).

Behavior-equivalent rebuild of the reference's painting utilities
(web-demos/hugging_face/tools/painter.py:1-215 and tools/mask_painter.py:
1-288): the same Detectron-style 81-color map (generated here instead of a
literal table), the same distance-transform soft contours, and the same
alpha-compositing semantics, so painted frames are pixel-identical for the
demo's default settings. No torch/PIL dependency — everything is uint8
numpy; cv2 supplies distanceTransform/dilate/GaussianBlur only.
"""

from __future__ import annotations

import numpy as np


def colormap(rgb: bool = True) -> np.ndarray:
    """The 81-entry Detectron visualization palette, float 0-255.

    Generated: 19 named head colors, then the 1/3-step RGB lattice at three
    blue levels (minus already-present corners), then 6-step pure-channel
    ramps and a 7-step gray ramp. Three-decimal rounding matches the
    reference table exactly (0.333 * 255 truncates to 84, 1/3 * 255 to 85 —
    the demo's colors depend on it)."""
    head = [
        (0.000, 0.000, 0.000), (1.000, 1.000, 1.000),
        (1.000, 0.498, 0.313), (0.392, 0.581, 0.929),
        (0.000, 0.447, 0.741), (0.850, 0.325, 0.098),
        (0.929, 0.694, 0.125), (0.494, 0.184, 0.556),
        (0.466, 0.674, 0.188), (0.301, 0.745, 0.933),
        (0.635, 0.078, 0.184), (0.300, 0.300, 0.300),
        (0.600, 0.600, 0.600), (1.000, 0.000, 0.000),
        (1.000, 0.500, 0.000), (0.749, 0.749, 0.000),
        (0.000, 1.000, 0.000), (0.000, 0.000, 1.000),
        (0.667, 0.000, 1.000),
    ]
    third = lambda i: round(i / 3.0, 3)
    rows = list(head)
    for b, skip in ((0.0, "rg0"), (0.5, "origin"), (1.0, "corners")):
        for r3 in range(4):
            for g3 in range(4):
                r, g = third(r3), third(g3)
                if skip == "rg0" and (r3 == 0 or g3 == 0):
                    continue  # pure-channel rows live in the head/ramps
                if skip == "origin" and r3 == 0 and g3 == 0:
                    continue
                if skip == "corners" and ((r3 == 0 and g3 == 0)
                                          or (r3 == 3 and g3 == 3)):
                    continue
                rows.append((r, g, b))
    for ch in range(3):
        for i in range(1, 7):
            v = [0.0, 0.0, 0.0]
            v[ch] = round(i / 6.0, 3)
            rows.append(tuple(v))
    rows += [(round(i / 7.0, 3),) * 3 for i in range(1, 7)]
    out = np.asarray(rows, np.float32) * 255
    return out if rgb else out[:, ::-1]


color_list = colormap().astype("uint8").tolist()


def _soft_contour(mask_u8: np.ndarray, contour_radius: int) -> np.ndarray:
    """Distance-transform contour band in [0, 1] with the far field
    saturated to 1 (the reference's '...:::!!!:::...' profile)."""
    import cv2

    fore = cv2.distanceTransform(mask_u8, cv2.DIST_L2, 3)
    back = cv2.distanceTransform(1 - mask_u8, cv2.DIST_L2, 3)
    dist = fore - back
    r = contour_radius + 2
    contour = np.abs(np.clip(dist, -r, r))
    contour = contour / np.max(contour)
    contour[contour > 0.5] = 1.0
    return contour


def _blend(image: np.ndarray, mask, color_idx: int, alpha: float):
    """image[mask] <- lerp toward palette color (reference painter.py
    vis_add_mask)."""
    color = np.array(color_list[color_idx])
    m = mask > 0.5
    image[m] = image[m] * (1 - alpha) + color * alpha
    return image.astype("uint8")


def mask_painter(input_image: np.ndarray, input_mask: np.ndarray,
                 mask_color: int = 5, mask_alpha: float = 0.7,
                 contour_color: int = 1, contour_width: int = 3
                 ) -> np.ndarray:
    """Overlay a mask plus a solid contour ring (painter.py:136-157 —
    the variant app.py's multi-mask display uses)."""
    assert input_image.shape[:2] == input_mask.shape, "different shape"
    mask = np.clip(input_mask, 0, 1).astype("uint8")
    contour = _soft_contour(mask, (contour_width - 1) // 2)
    painted = _blend(input_image.copy().astype(np.float64), mask,
                     mask_color, mask_alpha)
    return _blend(painted.astype(np.float64), 1 - contour, contour_color,
                  1.0)


def point_painter(input_image: np.ndarray, input_points: np.ndarray,
                  point_color: int = 5, point_alpha: float = 0.9,
                  point_radius: int = 15, contour_color: int = 2,
                  contour_width: int = 5) -> np.ndarray:
    """Paint click points as dilated dots with contour rings
    (painter.py:108-134)."""
    import cv2

    h, w = input_image.shape[:2]
    pm = np.zeros((h, w), np.uint8)
    for x, y in np.asarray(input_points).reshape(-1, 2).astype(int):
        if 0 <= y < h and 0 <= x < w:
            pm[y, x] = 1
    kernel = cv2.getStructuringElement(2, (point_radius, point_radius))
    pm = cv2.dilate(pm, kernel)
    contour = _soft_contour(pm, (contour_width - 1) // 2)
    painted = _blend(input_image.copy().astype(np.float64), pm,
                     point_color, point_alpha)
    return _blend(painted.astype(np.float64), 1 - contour, contour_color,
                  1.0)


def background_remover(input_image: np.ndarray, input_mask: np.ndarray
                       ) -> np.ndarray:
    """RGBA cutout: alpha = mask (painter.py:159-171; returns an array, not
    PIL — callers can wrap)."""
    assert input_image.shape[:2] == input_mask.shape, "different shape"
    alpha = (np.clip(input_mask, 0, 1) * 255).astype("uint8")[..., None]
    return np.concatenate([input_image, alpha], axis=2)


def mask_painter_blur(input_image: np.ndarray, input_mask: np.ndarray,
                      background_alpha: float = 0.5,
                      background_blur_radius: int = 7,
                      contour_width: int = 3, contour_color: int = 3,
                      contour_alpha: float = 1.0, mode: str = "11"
                      ) -> np.ndarray:
    """The soft-background variant (mask_painter.py:183-240): darken the
    background with a distance-feathered alpha, highlight the contour band.
    mode: '00' hard contour / '01' soft contour / '10' feathered background
    + hard contour / '11' feathered background + soft contour."""
    import cv2

    assert input_image.shape[:2] == input_mask.shape, "different shape"
    assert background_blur_radius % 2 * contour_width % 2 > 0, \
        "background_blur_radius and contour_width must be ODD"
    assert mode in ("00", "01", "10", "11")

    hh, ww = input_image.shape[:2]
    ratio = min(1024.0 / max(hh, ww), 1.0)
    if ratio < 1.0:
        input_image = cv2.resize(input_image,
                                 (int(ww * ratio), int(hh * ratio)))
        input_mask = cv2.resize(input_mask,
                                (int(ww * ratio), int(hh * ratio)))
    msk = np.clip(input_mask, 0, 1).astype("uint8")

    fore = cv2.distanceTransform(msk, cv2.DIST_L2, 3)
    back = cv2.distanceTransform(1 - msk, cv2.DIST_L2, 3)
    dist = fore - back
    if mode[0] == "1":
        br = (background_blur_radius - 1) // 2
        bg = np.clip(dist, -br, br)
        bg = bg - np.min(bg)
        bg = bg / np.max(bg)
    else:
        bg = msk.astype(np.float32)
    cr = (contour_width - 1) // 2 + 2
    contour = np.abs(np.clip(dist, -cr, cr))
    contour = contour / np.max(contour)
    if mode[1] == "0":
        contour[contour > 0.5] = 1.0

    # blend into the uint8 array in place: every per-channel assignment
    # truncates, exactly like the reference's vis_add_mask
    # (mask_painter.py:104-119 writes through a uint8 view twice)
    img = input_image.copy()
    bg_color = np.array(color_list[0], np.float64)       # black background
    ct_color = np.array(color_list[contour_color], np.float64)
    ba, ca = background_alpha, contour_alpha
    for i in range(3):
        img[:, :, i] = (img[:, :, i] * (1 - ba + bg * ba)
                        + bg_color[i] * (ba - bg * ba))
        img[:, :, i] = (img[:, :, i] * (1 - ca + contour * ca)
                        + ct_color[i] * (ca - contour * ca))
    return img.astype("uint8")
