"""Share of the traced window the card was idle while predict uploaded
its padded slab, %.

Idle time under the program's ``predict.upload`` span (the pinned copy
and the queued host-to-device copy), over the window.
"""

from benchmark import spans


def read(rec):
    """Idle time inside the span over the window."""
    return spans.idle_under_pct(rec, ("predict.upload",))
