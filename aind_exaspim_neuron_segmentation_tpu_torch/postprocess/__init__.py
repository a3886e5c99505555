"""Affinity -> segmentation -> skeleton postprocessing on the host.

Python surface over the port's C++ engine (:mod:`..native`), at the
reference's external-dependency call sites:

* :func:`agglomerate` -- ``waterz.agglomerate``, a generator;
* :func:`remove_small_segments` -- the reference's min-size filter over
  the ``fastremap``-like ``unique`` / ``mask_except`` / ``renumber``;
* :func:`skeletonize` -- ``kimimaro.skeletonize`` (dense arrays and lazy
  label handles);
* :func:`segment_streaming` -- the beyond-RAM segmentation of a lazy
  affinity handle or digest-store pair (:mod:`.streaming`);
* :func:`segment_streaming_sharded` / :func:`skeletonize_sharded` -- the
  same segmentation and TEASAR split over the processes of a
  ``torch.distributed`` job, bit-identical to one process
  (:mod:`.distributed`).
"""

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch import native
from aind_exaspim_neuron_segmentation_tpu_torch.native import (  # noqa: F401
    mask_except,
    renumber,
    unique,
    watershed,
)
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.skeleton import (  # noqa: F401
    skeletonize,
)
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.streaming import (  # noqa: F401
    segment_streaming,
)
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.distributed import (  # noqa: F401,E501
    segment_streaming_sharded,
    skeletonize_sharded,
)


def agglomerate(affinities, thresholds, aff_threshold_low=0.1,
                aff_threshold_high=0.9999, quantile_pct=85):
    """Generator of one uint32 segmentation per threshold (ascending).

    As ``waterz.agglomerate``: seeded watershed fragments, then
    hierarchical agglomeration with score = 1 - quantile(affinity) (85th
    percentile by default), a snapshot at each requested threshold.
    """
    segs = native.agglomerate_all(
        affinities, thresholds,
        aff_threshold_low=aff_threshold_low,
        aff_threshold_high=aff_threshold_high,
        quantile_pct=quantile_pct,
    )
    for i in range(segs.shape[0]):
        yield segs[i]


def remove_small_segments(label_mask, min_size):
    """Drop segments of ``<= min_size`` voxels (strictly greater keeps),
    then renumber contiguously by first appearance."""
    ids, counts = unique(label_mask, return_counts=True)
    keep = [i for i, c in zip(ids, counts) if c > min_size and i != 0]
    masked = mask_except(label_mask, np.asarray(keep, np.uint32))
    out, _ = renumber(masked, preserve_zero=True, in_place=True)
    return out
