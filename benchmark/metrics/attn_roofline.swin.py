"""The Swin UNETR's windowed attention core against its roofline, %.

The least time of the attention cores the window ran (``q @ k^T`` and
``attn @ v`` over the padded windows at the dense bf16 peak, or their
minimal bytes at the HBM rate: q, k and v read, the output written, the
bias tables and the shifted blocks' region ids read; whichever is
larger) over the device time of the kernels launched under the program's
``swin.attention`` span. The count is of the work, so it reads the same
whatever kernel computes the attention.
"""

from benchmark import readers
from benchmark.counts import swinunetr as counts
from benchmark.models import swinunetr as arch

SPAN = "swin.attention"


def read(rec):
    """Least time over measured time; None without the span."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    took = t.device_s(lambda n: n == SPAN)
    starts, _, batch = readers.predict_grid(rec)
    batches = len(starts) // batch * rec["counters"]["blocks"]
    patch = rec["cfg"]["predict"]["patch"]
    w = arch.widths(rec["cfg"])
    least = readers.least_s(
        rec, counts.attention_flops(patch, **w) * batch * batches,
        counts.attention_bytes(patch, batch, **w) * batches)
    return readers.share(least, took)
