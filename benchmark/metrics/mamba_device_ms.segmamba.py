"""Device time of SegMamba's Mamba layers a batch-9 forward, ms.

Activities launched under the program's ``segmamba.mamba`` span (each
Mamba layer from its LayerNorm to the residual add: the token layout,
``in_proj``, the three directions' scans, ``out_proj``), over the batches
the window's finished blocks ran: the share of the forward the
state-space layers hold.
"""

from benchmark import readers

SPAN = "segmamba.mamba"


def read(rec):
    """Device time under the span a batch; None without the span."""
    t = readers.traced(rec)
    blocks = rec["counters"].get("blocks")
    if t is None or not blocks:
        return None
    took = t.device_s(lambda n: n == SPAN)
    starts, _, batch = readers.predict_grid(rec)
    batches = len(starts) // batch * blocks
    return 1e3 * took / batches if took else None
