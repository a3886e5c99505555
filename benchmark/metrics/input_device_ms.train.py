"""Device time a step of the train step's input stage, ms.

Activities launched under the program's ``train.input`` span (the
upload, the augmentation, the targets), over the window's steps.
"""

from benchmark import spans

SPAN = "train.input"


def read(rec):
    """Device time under the span a step."""
    return spans.device_ms_per_step(rec, lambda n: n == SPAN, SPAN)
