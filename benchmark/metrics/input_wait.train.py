"""Share of the window the Trainer waited for its sampler's batches, %.

``Trainer.input_wait_s`` (the program's counter), summed over the
window's epochs, over the window.
"""


def read(rec):
    """Waited seconds over the window."""
    wait = rec["counters"].get("input_wait_s")
    return None if wait is None else 100.0 * wait / rec["window_s"]
