"""Whole-step model FLOP utilization of SegMamba's predict, % of the bf16
peak.

The FLOPs of one real patch's forward as the architecture counts them
(every conv, transposed conv and linear: the stem, the downsamples, the
GSC convs, the Mamba layers' ``in_proj``, causal ``conv1d``s, ``x_proj``,
``dt_proj`` and ``out_proj``, the channel MLPs, the UNETR decoder and the
output conv; not the scan's own arithmetic), times the real patches of
the traced window's finished blocks, over the window, over the card's
dense bf16 peak.
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
