"""Brightness clipping and percentile min-max normalization (host, numpy).

    x <- min(x, brightness_clip)
    mn, mx = percentile(x, (1, 99.9))          # linear interpolation
    x <- clip((x - mn) / (mx - mn + 1e-8), 0, 1)

``np.percentile`` is used on purpose: ``torch.quantile`` refuses inputs
above 2**24 elements, far below a real volume.
"""

import numpy as np

DEFAULT_PERCENTILES = (1, 99.9)


def clip_brightness(img, brightness_clip):
    """Elementwise ``min(img, brightness_clip)``."""
    return np.minimum(img, brightness_clip)


def normalize(img, apply_clip=True, percentiles=DEFAULT_PERCENTILES):
    """Percentile min-max normalize on the host."""
    mn, mx = np.percentile(img, percentiles)
    img = (img - mn) / (mx - mn + 1e-8)
    if apply_clip:
        return np.clip(img, 0, 1)
    return img
