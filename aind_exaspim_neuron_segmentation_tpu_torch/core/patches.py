"""Sliding-window patch-grid arithmetic and center-based patches (numpy).

The start range along each axis is ``range(0, dim - patch + stride,
stride)`` with ``stride = patch - overlap``; the final start may overhang
the volume, and the stitcher reflect-pads the volume so that every patch
is full-size (see :func:`..ops.stitch.reflect_pad_to_grid`). The training
datasets cut center-based patches (:func:`get_patch`) and keep validation
centers inside the volume (:func:`is_contained`).
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


def slab_plan(z_starts, patch_z, trim, dim_z, max_rows):
    """Split z-start rows into slabs of <= max_rows owned rows.

    Each slab recomputes the trailing rows of the previous slab whose
    trimmed output reaches into its owned range -- ``back`` rows, where
    back = ceil(core / stride) - 1 and core = patch - 2*trim (one row for
    the default 96/32/8 grid). Only the owned output range ``[own_lo,
    own_hi)`` is kept; the union of owned ranges covers ``[0, dim_z)``.
    """
    plans = []
    n = len(z_starts)
    stride = z_starts[1] - z_starts[0] if n > 1 else patch_z
    core = patch_z - 2 * trim
    back = max(-(-core // stride) - 1, 0)
    for i0 in range(0, n, max_rows):
        i1 = min(i0 + max_rows, n)
        rows = list(range(max(i0 - back, 0), i1))
        own_lo = 0 if i0 == 0 else z_starts[i0] + trim
        own_hi = dim_z if i1 == n else z_starts[i1] + trim
        in_lo = z_starts[rows[0]]
        in_hi = z_starts[rows[-1]] + patch_z
        plans.append(
            dict(rows=rows, own=(own_lo, own_hi), in_range=(in_lo, in_hi))
        )
    return plans


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


def get_patch_slices(start, patch_shape, img_shape):
    """Slices for a start-based patch, clipped to the volume bounds."""
    return tuple(
        slice(s, min(s + p, d))
        for s, p, d in zip(start, patch_shape, img_shape)
    )


def get_slices(center, shape):
    """Slices for a center-based patch (start = center - shape // 2).

    Not clipped to any volume.
    """
    return tuple(
        slice(c - d // 2, c - d // 2 + d) for c, d in zip(center, shape)
    )


def get_patch(img, center, shape):
    """Extract a center-based patch from a 3D or 5D-indexed array.

    ``img`` may be any array-like supporting slice indexing (including a
    lazy zarr handle); 5D arrays are indexed as ``img[0, 0, z, y, x]``.
    """
    s = get_slices(center, shape)
    return img[s] if img.ndim == 3 else img[(0, 0, *s)]


def add_padding(patch, patch_shape):
    """Reflect-pad a clipped patch at the end of each axis to patch_shape
    (``mode='reflect'``, as the reference does despite its docstring)."""
    pad_width = [(0, p - s) for p, s in zip(patch_shape, patch.shape)]
    if any(w for _, w in pad_width):
        return np.pad(patch, pad_width, mode="reflect")
    return patch


def is_contained(voxel, shape, buffer=0):
    """True if voxel +/- buffer is in-bounds on every axis."""
    above = all(0 <= v + buffer < s for v, s in zip(voxel, shape))
    below = all(0 <= v - buffer < s for v, s in zip(voxel, shape))
    return above and below


def blend_weight_map(img_shape, patch_shape, overlap, trim):
    """Analytic per-voxel hit count of the trimmed overlap-blend stitch.

    Each patch of the grid contributes to ``[start + trim, start + patch
    - trim)`` clipped to the volume; voxels no core covers (the first
    ``trim`` of each axis, by default) have weight 0. Separable: the
    outer product of per-axis counts, O(D + H + W) to build.
    """
    axes = []
    for dim, patch, ov in zip(img_shape, patch_shape, overlap):
        counts = np.zeros(dim, dtype=np.int32)
        stride = patch - ov
        for s in range(0, dim - patch + stride, stride):
            lo = min(max(s + trim, 0), dim)
            hi = min(s + patch - trim, dim)
            counts[lo:hi] += 1
        axes.append(counts)
    return (
        axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    )
