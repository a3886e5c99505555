"""Host patch augmentation for training (numpy + scipy).

The port's own copy of the JAX package's host pipeline: the same
generator calls in the same order and the same scipy calls, so a seed
gives identical arrays in both packages. The device counterpart, used by
the Trainer when the dataset ships raw label patches, is
:mod:`..ops.augment_device`.

Transform set and parameters mirror reference
machine_learning/augmentation.py:19-346: joint RandomFlip3D +
RandomRotation3D on (image, label), then a fair coin between
(noise -> contrast) and (smooth -> contrast) on the image only.

Deviation (deliberate, documented): the reference feeds (1, D, H, W)
patches into transforms written for (D, H, W), so its flips/rotations
hit the channel axis -- axis 0 flips are no-ops and "rotations" in the
(channel, D) plane degenerate (reference augmentation.py:106-155). Here
the spatial axes are derived from the array rank, so (1, D, H, W)
patches flip/rotate in the three *spatial* planes as the docstrings
intend. The unused-and-buggy RandomScale3D (reference
augmentation.py:158-209, label indexed [1,...]) is provided in fixed
form but, like the reference, not wired into ImageTransforms.
"""

import numpy as np
from scipy.ndimage import gaussian_filter, rotate, zoom

# Module-level generator backs unseeded transforms; ImageTransforms(seed)
# threads its own generator for reproducible pipelines.
_GLOBAL_RNG = np.random.default_rng()


def _spatial_axes(arr):
    """Indices of the three spatial axes (supports (D,H,W) and (1,D,H,W))."""
    if arr.ndim == 3:
        return (0, 1, 2)
    if arr.ndim == 4:
        return (1, 2, 3)
    raise ValueError(f"expected 3D or 4D patch, got shape {arr.shape}")


class RandomFlip3D:
    """Flip each spatial axis independently with p=0.5."""

    def __call__(self, input_img, label_mask, rng=None):
        rng = rng or _GLOBAL_RNG
        for axis in _spatial_axes(input_img):
            if rng.random() > 0.5:
                input_img = np.flip(input_img, axis=axis)
                label_mask = np.flip(label_mask, axis=axis)
        return input_img, label_mask


def rotate3d(img, angle, axes):
    """Nearest-neighbor rotation, shape-preserving, grid-mirror edges.

    Reference: augmentation.py:319-346 (order=0 for image AND labels).
    """
    return rotate(
        img, angle, axes=axes, mode="grid-mirror", reshape=False, order=0
    )


class RandomRotation3D:
    """Per spatial plane: p=0.8 rotate by U(-45, 45) degrees, order 0."""

    def __init__(self, angles=(-45, 45)):
        self.angles = angles

    def __call__(self, input_img, label_mask, rng=None):
        rng = rng or _GLOBAL_RNG
        a = _spatial_axes(input_img)
        for axes in ((a[0], a[1]), (a[0], a[2]), (a[1], a[2])):
            if rng.random() <= 0.8:
                angle = rng.uniform(*self.angles)
                input_img = rotate3d(input_img, angle, axes)
                label_mask = rotate3d(label_mask, angle, axes)
        return input_img, label_mask


class RandomScale3D:
    """Random isotropic rescale (NOT wired into ImageTransforms; the
    reference's version is unused and indexes labels out of channel
    bounds -- kept for surface parity with the bug fixed)."""

    def __init__(self, scale_range=(0.9, 1.1)):
        self.scale_range = scale_range

    def __call__(self, input_img, label_mask, rng=None):
        rng = rng or _GLOBAL_RNG
        alpha = rng.uniform(*self.scale_range)
        factors = [alpha] * 3

        def apply(vol, order):
            # rank-aware like the module's other transforms: bare
            # (D, H, W) patches zoom directly; channel-leading arrays
            # keep the reference's channel-0 behavior
            if vol.ndim == 3:
                return _zoom_keep_shape(vol, factors, order)
            vol = vol.copy()
            vol[0] = _zoom_keep_shape(vol[0], factors, order)
            return vol

        return apply(input_img, 3), apply(label_mask, 0)


def _zoom_keep_shape(vol, factors, order):
    out = zoom(vol, factors, order=order)
    result = np.zeros_like(vol)
    sl = tuple(slice(0, min(a, b)) for a, b in zip(vol.shape, out.shape))
    result[sl] = out[sl]
    return result


class RandomContrast3D:
    """Scale intensities by U(0.8, 1.2), clip to [0, 1]."""

    def __init__(self, factor_range=(0.8, 1.2)):
        self.factor_range = factor_range

    def __call__(self, img, rng=None):
        rng = rng or _GLOBAL_RNG
        return np.clip(img * rng.uniform(*self.factor_range), 0, 1)


class RandomNoise3D:
    """Add Gaussian noise with sigma ~ U(0, 0.16)."""

    def __init__(self, max_std=0.16):
        self.max_std = max_std

    def __call__(self, img, rng=None):
        rng = rng or _GLOBAL_RNG
        std = rng.uniform(0, self.max_std)
        return img + rng.normal(0, std, img.shape)


class RandomSmooth3D:
    """Gaussian blur with sigma ~ U(0, 0.8)."""

    def __init__(self, max_sigma=0.8):
        self.max_sigma = max_sigma

    def __call__(self, img, rng=None):
        rng = rng or _GLOBAL_RNG
        return gaussian_filter(img, sigma=rng.uniform(0, self.max_sigma))


class ImageTransforms:
    """Default augmentation pipeline (reference augmentation.py:19-68).

    ``seed`` makes the whole pipeline reproducible (the transforms all
    draw from one generator).
    """

    def __init__(self, seed=None):
        self.rng = np.random.default_rng(seed)
        self.geometric_transforms = [RandomFlip3D(), RandomRotation3D()]
        self.intensity_transforms1 = [RandomNoise3D(), RandomContrast3D()]
        self.intensity_transforms2 = [RandomSmooth3D(), RandomContrast3D()]

    def __call__(self, input_img, label_mask):
        for t in self.geometric_transforms:
            input_img, label_mask = t(input_img, label_mask, rng=self.rng)
        chain = (
            self.intensity_transforms1
            if self.rng.random() < 0.5
            else self.intensity_transforms2
        )
        for t in chain:
            input_img = t(input_img, rng=self.rng)
        return input_img, label_mask
