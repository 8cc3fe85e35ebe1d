"""FCOS location grids, flattened level-major (port of sylph_tpu/ops/locations.py).

Host-side numpy: one flat ``(K, 2)`` location array for a static canvas
(level-major, row-major over (h, w) within a level) plus per-location
stride, level and size-range metadata. The head flattens its outputs in the
same order, so candidate indices and ``Detections.locations`` match the JAX
package element for element.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

INF = 100000000.0


def level_hw(canvas_hw: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """Feature-map size of one FPN level for a static canvas."""
    h, w = canvas_hw
    return (-(-h // stride), -(-w // stride))


@dataclasses.dataclass(frozen=True)
class LocationGrid:
    """Static location metadata for one canvas size.

    locations:   (K, 2) float32 — (x, y) image coords of each location.
    strides:     (K,)   float32 — FPN stride of the owning level.
    level_ids:   (K,)   int32   — level index (0 = P3).
    size_ranges: (K, 2) float32 — size-of-interest [lo, hi] per location.
    level_sizes: list of (H, W) per level.
    """

    locations: np.ndarray
    strides: np.ndarray
    level_ids: np.ndarray
    size_ranges: np.ndarray
    level_sizes: List[Tuple[int, int]]

    @property
    def num_locations(self) -> int:
        return self.locations.shape[0]


def build_location_grid(canvas_hw: Tuple[int, int],
                        fpn_strides: Sequence[int],
                        sizes_of_interest: Sequence[int]) -> LocationGrid:
    """Location formula ``(stride//2 + x*stride, stride//2 + y*stride)``."""
    soi = [-1.0] + [float(s) for s in sizes_of_interest] + [INF]
    locs, strides, levels, ranges, level_sizes = [], [], [], [], []
    for li, stride in enumerate(fpn_strides):
        h, w = level_hw(canvas_hw, stride)
        level_sizes.append((h, w))
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        xy = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)
        xy = xy * stride + stride // 2
        locs.append(xy)
        k = h * w
        strides.append(np.full((k,), stride, np.float32))
        levels.append(np.full((k,), li, np.int32))
        ranges.append(np.tile(np.array([[soi[li], soi[li + 1]]], np.float32),
                              (k, 1)))
    return LocationGrid(
        locations=np.concatenate(locs, 0),
        strides=np.concatenate(strides, 0),
        level_ids=np.concatenate(levels, 0),
        size_ranges=np.concatenate(ranges, 0),
        level_sizes=level_sizes,
    )
