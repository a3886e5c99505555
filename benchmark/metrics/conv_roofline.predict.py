"""cuDNN convolutions of predict against their roofline, %.

The least time of every conv the window ran (the valid-region decoder's
FLOPs at the dense bf16 peak, or its minimal bytes at the HBM rate,
whichever is larger) over the device time of the kernels launched under
``aten::convolution``.
"""

from benchmark import readers
from benchmark.counts import unet3d as counts


def read(rec):
    """Least time over measured time."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    starts, _, batch = readers.predict_grid(rec)
    layers = readers.predict_layers(rec)
    batches = len(starts) // batch * rec["counters"]["blocks"]
    least = readers.least_s(
        rec, counts.forward_flops(layers) * batch * batches,
        counts.conv_bytes(layers, batch) * batches)
    return readers.share(least, t.device_s(readers.is_conv))
