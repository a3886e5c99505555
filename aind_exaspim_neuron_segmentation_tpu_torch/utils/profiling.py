"""Tracing and per-stage timing.

* :class:`StageTimer` -- named wall-clock stages with device
  synchronization, printable and loggable summary;
* :func:`trace` -- context manager around ``torch.profiler`` writing a
  TensorBoard-viewable trace of the host and the card;
* :func:`annotate` -- a named region in the profiler timeline.
"""

import contextlib
import time
from collections import OrderedDict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall-clock time per named stage.

    ``sync=True`` (default) waits for queued device work at stage
    boundaries (``torch.cuda.synchronize``), so the card's time is
    charged to the stage that queued it: CUDA launches return before the
    work runs, and unsynced timings lie.
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.totals = OrderedDict()
        self.counts = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name):
        """Context manager timing one named stage (device-synced)."""
        if self.sync:
            _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        """Human-readable per-stage totals/averages/percentages."""
        lines = []
        total = sum(self.totals.values())
        for name, t in self.totals.items():
            n = self.counts[name]
            lines.append(
                f"{name:>24}: {t:8.3f}s  ({n}x, {t / n * 1e3:8.1f} ms avg,"
                f" {100 * t / total if total else 0:5.1f}%)"
            )
        return "\n".join(lines)

    def as_dict(self):
        """Stage-name -> total-seconds mapping."""
        return dict(self.totals)


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``torch.profiler`` trace of the host and, where there is
    one, the card, written under ``log_dir`` for TensorBoard."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name):
    """Named region in the profiler timeline (``record_function``)."""
    return torch.profiler.record_function(name)
