"""cuDNN convolutions of training against their roofline, %.

The least time of every conv's forward, data gradient and weight gradient
(FLOPs at the dense bf16 peak, or minimal bytes at the HBM rate, whichever
is larger) over the device time of the kernels launched under
``aten::convolution`` and ``aten::convolution_backward``.
"""

from benchmark import readers
from benchmark.counts import unet3d as counts


def read(rec):
    """Least time over measured time."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    layers = readers.train_layers(rec)
    batch = rec["cfg"]["train"]["batch_size"]
    steps = rec["counters"]["steps"]
    least = readers.least_s(
        rec, counts.conv_train_flops(layers) * batch * steps,
        counts.conv_bytes(layers, batch, train=True) * steps)
    return readers.share(least, t.device_s(readers.is_conv))
