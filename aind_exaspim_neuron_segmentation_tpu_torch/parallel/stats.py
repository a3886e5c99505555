"""Exact order statistics and percentiles of a tensor split over ranks:
:mod:`..core.order_stats`'s radix select (re-exported, as the JAX package
has it here), each round's histogram summed by an ``all_reduce``."""

from aind_exaspim_neuron_segmentation_tpu_torch.core.order_stats import (  # noqa: F401
    lerp_plan,
    order_stat,
    order_stats,
    percentile_device,
    percentiles,
    rank_plan,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (
    all_reduce_sum,
)


def _psum(axis_names):
    return lambda v: all_reduce_sum(v, axis_names)


def percentile_sharded(x_local, qs, n_total, axis_name):
    """Exact percentiles of a tensor split over ranks.

    Every rank of ``axis_name`` calls it with its own part ``x_local`` and
    the global element count ``n_total``. ``axis_name`` names the ranks
    whose histograms are summed: a :class:`~.mesh.RankMesh` (all its
    ranks), a ``torch.distributed`` process group, or None for the whole
    job (torch has no implicit mesh context, so the group is given, where
    the JAX package names a ``shard_map`` axis). Interpolates in float32
    as :func:`percentile_device` does.
    """
    return percentiles(x_local, qs, n_total, _psum(axis_name))


def order_stats_sharded(x_local, ks, axis_names):
    """Exact k-th smallest values of a tensor split over ranks.

    ``ks``: 0-based global ranks. Elements a rank should NOT count
    (padding, halo duplicates) must be set to +inf by the caller; as long
    as every rank in ``ks`` is below the global count of finite elements,
    the +inf sentinels never win a radix round. ``axis_names``: the ranks
    to sum over, as in :func:`percentile_sharded`. Returns a stacked
    float32 tensor; :func:`lerp_plan` of its host values reproduces
    ``np.percentile`` bit for bit, which is how
    ``parallel.predict_sharded`` normalizes without densifying its input.
    """
    return order_stats(x_local, ks, _psum(axis_names))
