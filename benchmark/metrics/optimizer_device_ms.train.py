"""Device time a step of the optimizer, ms.

Activities launched under torch's own ``Optimizer.step#<class>.step``
annotation, over the window's steps.
"""

from benchmark import spans


def read(rec):
    """Device time under the optimizer's step a step."""
    return spans.device_ms_per_step(
        rec, lambda n: n.startswith("Optimizer.step#"))
