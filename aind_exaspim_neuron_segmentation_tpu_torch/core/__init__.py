"""Patch-grid arithmetic, percentile normalize and affinity channels."""

from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (  # noqa: F401
    affinity_channels,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (  # noqa: F401
    count_patches,
    generate_patch_starts,
    patch_grid_ranges,
    patch_starts_array,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (  # noqa: F401
    DEFAULT_PERCENTILES,
    clip_brightness,
    normalize,
)
