"""Share of the traced window the card was idle while predict prepared
its input on the host, %.

Idle time under the program's ``predict.normalize`` and ``predict.pad``
spans (the brightness clip, the percentile normalize, the reflect pad),
over the window: the part of ``device_idle.predict`` a device normalize
and pad would take away.
"""

from benchmark import spans


def read(rec):
    """Idle time inside the spans over the window."""
    return spans.idle_under_pct(rec, ("predict.normalize", "predict.pad"))
