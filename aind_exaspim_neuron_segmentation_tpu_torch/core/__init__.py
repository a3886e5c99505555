"""Patch-grid arithmetic, percentile normalize and affinity channels."""

from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (  # noqa: F401
    affinity_channels,
    get_affinity_channels,
    get_affinity_mask,
    get_offset_masks,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (  # noqa: F401
    add_padding,
    blend_weight_map,
    count_patches,
    generate_patch_starts,
    get_patch,
    get_patch_slices,
    get_slices,
    is_contained,
    patch_grid_ranges,
    patch_starts_array,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (  # noqa: F401
    DEFAULT_PERCENTILES,
    clip_brightness,
    normalize,
    normalize_device,
    preprocess_device,
    streaming_percentile,
)
