"""Rasterization primitives for tile rendering (a copy of the JAX
package's multigrid_tpu/utils/rendering.py, which holds no JAX).

Pure-numpy predicate-fill rasterizer, the same approach as the reference
(multigrid/utils/rendering.py): tiles are drawn by evaluating geometric
predicates over a supersampled pixel lattice, then downsampled. Host-side
only — frames are for humans; the hot path (observations) never rasterizes.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

Predicate = Callable[[float, float], bool]


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool an image by ``factor`` (utils/rendering.py:19-43)."""
    h, w, c = img.shape
    img = img.reshape(h // factor, factor, w // factor, factor, c)
    return img.mean(axis=(1, 3)).astype(img.dtype)


def fill_coords(img: np.ndarray, predicate: Predicate, color) -> np.ndarray:
    """Fill all pixels whose normalized center satisfies ``predicate``
    (utils/rendering.py:46-74)."""
    h, w = img.shape[:2]
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    # Vectorize the predicate over the lattice.
    yy, xx = np.meshgrid(ys, xs, indexing='ij')
    mask = np.vectorize(predicate)(xx, yy)
    img[mask] = color
    return img


def rotate_fn(fn: Predicate, cx: float, cy: float, theta: float) -> Predicate:
    """Rotate a predicate's coordinate frame about (cx, cy)
    (utils/rendering.py:76-104)."""
    cos_t, sin_t = math.cos(-theta), math.sin(-theta)

    def out(x, y):
        x = x - cx
        y = y - cy
        return fn(cx + x * cos_t - y * sin_t, cy + y * cos_t + x * sin_t)

    return out


def point_in_line(x0, y0, x1, y1, r) -> Predicate:
    """Points within distance r of segment (x0,y0)-(x1,y1)
    (utils/rendering.py:107-157)."""
    dx, dy = x1 - x0, y1 - y0
    length_sq = dx * dx + dy * dy

    def fn(x, y):
        t = 0.0 if length_sq == 0 else max(
            0.0, min(1.0, ((x - x0) * dx + (y - y0) * dy) / length_sq))
        px, py = x0 + t * dx, y0 + t * dy
        return (x - px) ** 2 + (y - py) ** 2 <= r * r

    return fn


def point_in_circle(cx, cy, r) -> Predicate:
    def fn(x, y):
        return (x - cx) ** 2 + (y - cy) ** 2 <= r * r
    return fn


def point_in_rect(xmin, xmax, ymin, ymax) -> Predicate:
    def fn(x, y):
        return xmin <= x <= xmax and ymin <= y <= ymax
    return fn


def point_in_triangle(a, b, c) -> Predicate:
    """Barycentric containment test (utils/rendering.py:209-253)."""
    ax, ay = a
    bx, by = b
    cx, cy = c
    v0 = (cx - ax, cy - ay)
    v1 = (bx - ax, by - ay)
    d00 = v0[0] * v0[0] + v0[1] * v0[1]
    d01 = v0[0] * v1[0] + v0[1] * v1[1]
    d11 = v1[0] * v1[0] + v1[1] * v1[1]
    denom = d00 * d11 - d01 * d01

    def fn(x, y):
        v2 = (x - ax, y - ay)
        d02 = v0[0] * v2[0] + v0[1] * v2[1]
        d12 = v1[0] * v2[0] + v1[1] * v2[1]
        u = (d11 * d02 - d01 * d12) / denom
        v = (d00 * d12 - d01 * d02) / denom
        return u >= 0 and v >= 0 and u + v < 1

    return fn


def highlight_img(img: np.ndarray, color=(255, 255, 255), alpha=0.30) -> np.ndarray:
    """Alpha-blend a highlight color over an image (utils/rendering.py:256-278)."""
    blend = img.astype(np.float32) + alpha * (
        np.asarray(color, dtype=np.float32) - img.astype(np.float32)
    )
    img[:] = blend.clip(0, 255).astype(img.dtype)
    return img
