"""MedNeXt's per-channel GroupNorms against their roofline, %.

The least time of every GroupNorm the window ran (its minimal bytes at
the HBM rate: the map read once and written once, its scale and shift
read) over the device time of the kernels launched under the program's
``mednext.norm`` span.
"""

from benchmark import readers
from benchmark.counts import mednext as counts
from benchmark.models import mednext as arch

SPAN = "mednext.norm"


def read(rec):
    """Least time over measured time; None without the span."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    took = t.device_s(lambda n: n == SPAN)
    starts, _, batch = readers.predict_grid(rec)
    batches = len(starts) // batch * rec["counters"]["blocks"]
    work = counts.norm_work(rec["cfg"]["predict"]["patch"], batch,
                            **arch.widths(rec["cfg"]))
    least = batches * sum(readers.least_s(rec, f, b) for f, b in work)
    return readers.share(least, took)
