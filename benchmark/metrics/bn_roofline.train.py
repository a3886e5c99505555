"""BatchNorm of training against its bandwidth bound, %.

Minimal bytes of every BatchNorm's forward (read x, write y) and backward
(read dy and x, write dx) in bf16, from the model's activation shapes, at
the HBM rate, over the device time of the kernels launched under aten
BatchNorm ops.
"""

from benchmark import readers
from benchmark.counts import unet3d as counts


def read(rec):
    """Least time over measured time."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    batch = rec["cfg"]["train"]["batch_size"]
    nbytes = counts.batchnorm_bytes(readers.train_layers(rec), batch) * \
        rec["counters"]["steps"]
    return readers.share(nbytes / rec["peaks"]["hbm_bytes_s"],
                         t.device_s(readers.is_batchnorm))
