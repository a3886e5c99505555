"""Device time a predict call of the Swin UNETR's windowed attention
core, ms.

Activities launched under the program's ``swin.attention`` span (from q,
k and v to each window's output before ``proj``), over the window's
finished blocks.
"""

from benchmark import readers

SPAN = "swin.attention"


def read(rec):
    """Device time under the span a call; None without the span."""
    t = readers.traced(rec)
    blocks = rec["counters"].get("blocks")
    if t is None or not blocks:
        return None
    took = t.device_s(lambda n: n == SPAN)
    return 1e3 * took / blocks if took else None
