"""Device time of one ``Trainer.train_batch``, ms.

CUDA events recorded by the benchmark before and after every timed call:
their total over the number of steps.
"""


def read(rec):
    """Mean of the event spans."""
    spans = rec["counters"].get("step_device_s") or []
    return 1e3 * sum(spans) / len(spans) if spans else None
