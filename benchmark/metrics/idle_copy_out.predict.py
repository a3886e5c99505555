"""Share of the traced window the card was idle while predict copied its
affinities out, %.

Idle time under the program's ``predict.copy_out`` span (the wait for
the device-to-host copy and the host copy into the result), over the
window.
"""

from benchmark import spans


def read(rec):
    """Idle time inside the span over the window."""
    return spans.idle_under_pct(rec, ("predict.copy_out",))
