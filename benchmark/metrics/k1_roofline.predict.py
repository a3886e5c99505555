"""Kernel K1 (the blend scatter-add) against its bandwidth bound, %.

Minimal bytes of every launch (the batch's probabilities read once, the
union of its patch cores in the accumulator read and written once) at
the HBM rate, over K1's kernel time. None unless the trace holds one
launch per batch of every finished block.
"""

from benchmark import readers
from benchmark.counts import unet3d as counts


def read(rec):
    """Least time over measured time."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    starts, padded, batch = readers.predict_grid(rec)
    p = rec["cfg"]["predict"]
    core = (p["patch"] - 2 * p["trim"],) * 3
    per_block = [counts.k1_launch_bytes((3,) + padded, core,
                                        starts[i:i + batch], p["trim"])
                 for i in range(0, len(starts), batch)]
    blocks = rec["counters"]["blocks"]
    if t.count(readers.is_k1) != len(per_block) * blocks:
        return None
    return readers.share(sum(per_block) * blocks / rec["peaks"]["hbm_bytes_s"],
                         t.device_s(readers.is_k1))
