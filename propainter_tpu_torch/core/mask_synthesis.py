"""Random moving-blob mask synthesis for training (host-side numpy and cv2):
a copy of `propainter_tpu/core/mask_synthesis.py`, pinned to it by source
(tests/test_torch_train.py). It reproduces the distribution of the
reference's core/utils.py:178-356 (create_random_shape_with_random_motion)
without matplotlib.
"""

from __future__ import annotations

import random

import numpy as np
import cv2


def _cubic_bezier(p0, p1, p2, p3, n=24):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * p1
            + 3 * (1 - t) * t ** 2 * p2 + t ** 3 * p3)


def get_random_shape(edge_num=9, ratio=0.7, width=432, height=240) -> np.ndarray:
    """Random bezier blob as a cropped uint8 {0,255} mask (h, w).

    Same vertex construction as the reference (core/utils.py:269-306): 3*n+1
    points on the unit circle with radius perturbed uniformly in
    [1-ratio, 1+ratio]; consecutive triplets form cubic bezier segments.
    """
    points_num = edge_num * 3 + 1
    angles = np.linspace(0, 2 * np.pi, points_num)
    radii = 2 * ratio * np.random.random(points_num) + 1 - ratio
    verts = np.stack((np.cos(angles), np.sin(angles)), axis=1) * radii[:, None]
    verts[-1] = verts[0]

    # sample the piecewise cubic bezier densely into a polygon
    poly = []
    for i in range(edge_num):
        seg = verts[3 * i : 3 * i + 4]
        poly.append(_cubic_bezier(seg[0], seg[1], seg[2], seg[3]))
    poly = np.concatenate(poly, axis=0)

    # rasterize at a canvas matching the matplotlib pipeline's framing
    # (limits = [min, max]*1.1), then resize to (width, height)
    lo = poly.min() * 1.1
    hi = poly.max() * 1.1
    canvas = 256
    pts = ((poly - lo) / (hi - lo) * (canvas - 1)).astype(np.int32)
    img = np.zeros((canvas, canvas), np.uint8)
    cv2.fillPoly(img, [pts], 255)
    img = cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    img = (img > 0).astype(np.uint8) * 255

    ys, xs = np.where(img > 0)
    if len(ys) == 0:  # degenerate blob; fall back to a small box
        img[height // 3 : 2 * height // 3, width // 3 : 2 * width // 3] = 255
        ys, xs = np.where(img > 0)
    return img[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]


def get_random_velocity(max_speed=3, dist="uniform"):
    if dist == "uniform":
        speed = np.random.uniform(max_speed)
    else:
        speed = np.abs(np.random.normal(0, max_speed / 2))
    angle = np.random.uniform(0, 2 * np.pi)
    return (speed, angle)


def random_accelerate(velocity, max_acceleration, dist="guassian"):
    speed, angle = velocity
    d_speed, d_angle = max_acceleration
    if dist == "uniform":
        speed += np.random.uniform(-d_speed, d_speed)
        angle += np.random.uniform(-d_angle, d_angle)
    else:
        speed += np.random.normal(0, d_speed / 2)
        angle += np.random.normal(0, d_angle / 2)
    return (speed, angle)


def random_move_control_points(X, Y, image_height, image_width, velocity,
                               region_size, max_acceleration=(3, 0.5),
                               max_init_speed=3):
    region_h, region_w = region_size
    speed, angle = velocity
    X += int(speed * np.cos(angle))
    Y += int(speed * np.sin(angle))
    velocity = random_accelerate(velocity, max_acceleration, "guassian")
    if (X > image_height - region_h or X < 0
            or Y > image_width - region_w or Y < 0):
        velocity = get_random_velocity(max_init_speed, "guassian")
    return (int(np.clip(X, 0, image_height - region_h)),
            int(np.clip(Y, 0, image_width - region_w)), velocity)


def create_random_shape_with_random_motion(
    video_length: int, image_height=240, image_width=432
) -> np.ndarray:
    """(T, H, W) uint8 {0,1} mask sequence; 50% static, 50% moving."""
    height = random.randint(image_height // 3, image_height - 1)
    width = random.randint(image_width // 3, image_width - 1)
    edge_num = random.randint(6, 8)
    ratio = random.randint(6, 8) / 10
    region = get_random_shape(edge_num, ratio, width=width, height=height)
    rh, rw = region.shape

    x = random.randint(0, image_height - rh)
    y = random.randint(0, image_width - rw)
    velocity = get_random_velocity(max_speed=3)

    def paste(x, y):
        m = np.zeros((image_height, image_width), np.uint8)
        m[x : x + rh, y : y + rw] = region
        return (m > 0).astype(np.uint8)

    masks = [paste(x, y)]
    if random.uniform(0, 1) > 0.5:
        return np.repeat(masks[0][None], video_length, axis=0)
    for _ in range(video_length - 1):
        x, y, velocity = random_move_control_points(
            x, y, image_height, image_width, velocity, (rh, rw),
            max_acceleration=(3, 0.5), max_init_speed=3)
        masks.append(paste(x, y))
    return np.stack(masks)
