"""MedNeXt's depthwise convs (stride 1, stride 2 and transposed)
against their roofline, %.

The least time of every depthwise conv the window ran (each conv's FLOPs
at the dense bf16 peak or its minimal bytes at the HBM rate, the larger:
the map read, the weights and bias read, the output written) over the
device time of the kernels launched under the program's
``mednext.dwconv`` span.
"""

from benchmark import readers
from benchmark.counts import mednext as counts
from benchmark.models import mednext as arch

SPAN = "mednext.dwconv"


def read(rec):
    """Least time over measured time; None without the span."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    took = t.device_s(lambda n: n == SPAN)
    starts, _, batch = readers.predict_grid(rec)
    batches = len(starts) // batch * rec["counters"]["blocks"]
    work = counts.dwconv_work(rec["cfg"]["predict"]["patch"], batch,
                              **arch.widths(rec["cfg"]))
    least = batches * sum(readers.least_s(rec, f, b) for f, b in work)
    return readers.share(least, took)
