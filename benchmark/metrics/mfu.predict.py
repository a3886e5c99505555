"""Whole-step model FLOP utilization of predict, % of the bf16 peak.

The FLOPs the trimmed output needs per real patch, as the architecture
counts them (the UNet3D's: the valid-region decoder's convs), times the
real patches of the traced window's finished blocks, over the window,
over the card's dense bf16 peak.
"""

from benchmark import readers


def read(rec):
    """Useful FLOP/s over the peak."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    flops = readers.model(rec).forward_flops(rec["cfg"], "predict") * \
        readers.real_patches(rec) * rec["counters"]["blocks"]
    return 100.0 * flops / t.window_s / rec["peaks"]["bf16_flops_s"]
