"""Share of the traced window in which the card ran nothing, %."""

from benchmark import readers


def read(rec):
    """1 - (union of device activity) / window."""
    return readers.idle_pct(rec)
