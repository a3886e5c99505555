"""Input voxels predicted per second over the window, in millions."""


def read(rec):
    """All voxels of the finished calls over their span."""
    return rec["work"] / rec["window_s"] / 1e6
