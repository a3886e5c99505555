"""SegMamba's selective scans against their roofline, %.

The least time of every Mamba layer's three directions the window ran,
from ``xz`` to the gated sum (each layer's FLOPs at the dense bf16 peak
or its minimal bytes at the HBM rate, the larger: ``xz`` read once, the
directions' weights read, the summed ``y`` written once; see
``benchmark/counts/segmamba.py``), over the device time of the kernels
launched under the program's ``segmamba.scan`` span (the causal convs,
``x_proj``, the scans, the gate and the sum).
"""

from benchmark import readers
from benchmark.counts import segmamba as counts
from benchmark.models import segmamba as arch

SPAN = "segmamba.scan"


def read(rec):
    """Least time over measured time; None without the span."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    took = t.device_s(lambda n: n == SPAN)
    starts, _, batch = readers.predict_grid(rec)
    batches = len(starts) // batch * rec["counters"]["blocks"]
    work = counts.scan_work(rec["cfg"]["predict"]["patch"], batch,
                            **arch.widths(rec["cfg"]))
    least = batches * sum(readers.least_s(rec, f, b) for f, b in work)
    return readers.share(least, took)
