"""MedNeXt's inverted-bottleneck MLPs (``conv2 -> GELU -> conv3``)
against their roofline, %.

The least time of every block's MLP the window ran (its two ``1^3``
convs' FLOPs at the dense bf16 peak or its minimal bytes at the HBM
rate, the larger: the block's ``C``-wide input read, its output written,
both weights read; never the ``rC``-wide hidden tensor, so the count
reads the same whatever kernel, fused or not, computes it) over the
device time of the kernels launched under the program's ``mednext.mlp``
span.
"""

from benchmark import readers
from benchmark.counts import mednext as counts
from benchmark.models import mednext as arch

SPAN = "mednext.mlp"


def read(rec):
    """Least time over measured time; None without the span."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    took = t.device_s(lambda n: n == SPAN)
    starts, _, batch = readers.predict_grid(rec)
    batches = len(starts) // batch * rec["counters"]["blocks"]
    work = counts.mlp_work(rec["cfg"]["predict"]["patch"], batch,
                           **arch.widths(rec["cfg"]))
    least = batches * sum(readers.least_s(rec, f, b) for f, b in work)
    return readers.share(least, took)
