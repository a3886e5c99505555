"""Training patches of the finished optimizer steps per second."""


def read(rec):
    """All patches of the finished steps over their span."""
    return rec["work"] / rec["window_s"]
