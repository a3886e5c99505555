"""Sliding-window patch-grid arithmetic (numpy).

The start range along each axis is ``range(0, dim - patch + stride,
stride)`` with ``stride = patch - overlap``; the final start may overhang
the volume, and the stitcher reflect-pads the volume so that every patch
is full-size (see :func:`..ops.stitch.reflect_pad_to_grid`).
"""

import itertools

import numpy as np


def patch_grid_ranges(img_shape, patch_shape, overlap):
    """Per-axis ``range`` objects of patch start coordinates.

    ``img_shape`` is the 3D spatial shape (D, H, W). The last start along an
    axis may overhang the volume, which guarantees the trailing edge of the
    volume is covered.
    """
    if len(img_shape) != 3:
        raise ValueError(f"expected 3D spatial shape, got {img_shape}")
    ranges = []
    for dim, patch, ov in zip(img_shape, patch_shape, overlap):
        stride = patch - ov
        if stride <= 0:
            raise ValueError(f"overlap {ov} must be < patch {patch}")
        ranges.append(range(0, dim - patch + stride, stride))
    return ranges


def count_patches(img_shape, patch_shape, overlap):
    """Number of patches in the sliding-window grid.

    Accepts a 5D (1, 1, D, H, W) shape or a bare 3D spatial shape.
    """
    spatial = img_shape[2:] if len(img_shape) == 5 else img_shape
    ranges = patch_grid_ranges(spatial, patch_shape, overlap)
    return int(np.prod([len(r) for r in ranges]))


def generate_patch_starts(img_shape, patch_shape, overlap):
    """Yield (z, y, x) start coordinates in row-major grid order.

    Accepts 5D or 3D shapes like :func:`count_patches`.
    """
    spatial = img_shape[2:] if len(img_shape) == 5 else img_shape
    ranges = patch_grid_ranges(spatial, patch_shape, overlap)
    yield from itertools.product(*ranges)


def patch_starts_array(img_shape, patch_shape, overlap):
    """All patch starts as an (N, 3) int32 array."""
    starts = list(generate_patch_starts(img_shape, patch_shape, overlap))
    return np.asarray(starts, dtype=np.int32).reshape(-1, 3)
