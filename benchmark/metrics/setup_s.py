"""Set-up: from the process's start to the first timed call, s."""


def read(rec):
    """The host clock's set-up time."""
    return rec["setup_s"]
