"""Whole-step model FLOP utilization of training, % of the bf16 peak.

3 x the full forward's FLOPs per patch (the forward, and two for the
backward), as the architecture counts them, times the patches of the
finished steps, over the traced window, over the card's dense bf16 peak.
"""

from benchmark import readers


def read(rec):
    """Useful FLOP/s over the peak."""
    t = readers.traced(rec)
    if t is None or rec["peaks"] is None:
        return None
    flops = 3 * readers.model(rec).forward_flops(rec["cfg"], "train") * \
        rec["work"]
    return 100.0 * flops / t.window_s / rec["peaks"]["bf16_flops_s"]
