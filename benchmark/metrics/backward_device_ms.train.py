"""Device time a step of the train step's backward, ms.

Activities launched under the program's ``train.backward`` span, or under
torch's ``autograd::engine::evaluate_function:`` ops (on CUDA the
autograd engine runs the backward on a thread of its own, outside the
span), over the window's steps.
"""

from benchmark import spans

SPAN = "train.backward"
ENGINE = "autograd::engine::evaluate_function:"


def read(rec):
    """Device time under the span or the engine's ops a step."""
    return spans.device_ms_per_step(
        rec, lambda n: n == SPAN or n.startswith(ENGINE), SPAN)
