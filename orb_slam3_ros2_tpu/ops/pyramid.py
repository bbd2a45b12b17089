"""Image pyramid + Gaussian blur (E1 part 1).

Reference behavior: `ORBextractor` builds an `nLevels`-deep pyramid with
geometric `scaleFactor` (settings keys in every YAML, e.g.
`/root/reference/config/Monocular-Inertial/EuRoC.yaml:59-62`: nLevels 8,
scaleFactor 1.2) and blurs each level with a 7x7 σ=2 Gaussian before BRIEF
sampling [upstream]. Here each level has a static shape computed at trace
time from the config, resize is `jax.image.resize` (bilinear — maps to XLA
gather/dot, fuses well), and the blur is two 1-D separable convolutions as
fused elementwise passes.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float
                 ) -> List[Tuple[int, int]]:
    """Static (H, W) per level; level 0 is the input resolution."""
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32)))
    return shapes


@functools.lru_cache(maxsize=None)
def _gauss_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect padding; img (H, W) float32."""
    k = jnp.asarray(_gauss_kernel1d(ksize, sigma))
    r = ksize // 2
    x = jnp.pad(img, ((r, r), (0, 0)), mode="reflect")
    # vertical pass: sum of shifted rows (unrolled, ksize is tiny and static)
    v = sum(k[i] * x[i : i + img.shape[0], :] for i in range(ksize))
    y = jnp.pad(v, ((0, 0), (r, r)), mode="reflect")
    h = sum(k[i] * y[:, i : i + img.shape[1]] for i in range(ksize))
    return h


def build_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float
                  ) -> List[jnp.ndarray]:
    """Return list of per-level images (each its own static shape).

    Levels are produced by successive resize from the previous level (the
    reference does the same chain-resize [upstream]), which keeps aliasing in
    check without an explicit pre-filter.
    """
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        prev = levels[-1]
        levels.append(
            jax.image.resize(prev, shapes[lvl], method="bilinear")
        )
    return levels


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor ** i for i in range(n_levels)], dtype=np.float32)


def features_per_level(n_features: int, n_levels: int, scale_factor: float
                       ) -> List[int]:
    """Geometric feature budget per level, summing to n_features.

    Mirrors the reference allocation: desired features per level decay with
    1/scaleFactor so coarse levels contribute fewer points [upstream
    ORBextractor ctor behavior implied by the nFeatures/scaleFactor keys].
    """
    inv = 1.0 / scale_factor
    total = (1.0 - inv ** n_levels) / (1.0 - inv)
    base = n_features * (1.0 - inv) / (1.0 - inv ** n_levels)
    counts = []
    acc = 0
    for lvl in range(n_levels - 1):
        c = int(round(base * inv ** lvl))
        counts.append(c)
        acc += c
    counts.append(max(n_features - acc, 0))
    del total
    return counts
