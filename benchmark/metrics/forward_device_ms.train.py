"""Device time a step of the train step's forward, ms.

Activities launched under the program's ``train.forward`` span (the
autocast forward and the loss), over the window's steps.
"""

from benchmark import spans

SPAN = "train.forward"


def read(rec):
    """Device time under the span a step."""
    return spans.device_ms_per_step(rec, lambda n: n == SPAN, SPAN)
