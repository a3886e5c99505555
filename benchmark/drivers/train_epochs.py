"""Epochs of ``Trainer.train_step``, one after another: the user's loop.

The Trainer's own prefetching sampler feeds every step (one producer
thread, or ``num_workers`` processes as the configuration says), so the
sampler's stall at the start of each epoch and its pace against the
step are in the window. Each timed call is one epoch; the window ends
with the epoch in flight. Validation is left out of the window. The
UNet3D alone (:mod:`benchmark.training`).
"""

import torch

from benchmark import training


class Session(training.TrainSession):
    """Whole epochs through ``train_step``."""

    span = "bench.epoch"

    def __init__(self, ctx):
        super().__init__(ctx)
        self.input_wait_s = 0.0
        if ctx.trace:
            self._wrap_batches()

    def _wrap_batches(self):
        """Put the benchmark's ``bench.wait_batch`` span around each wait
        for the sampler's next batch."""
        inner = self.trainer._batches

        def batches(dataset):
            it = iter(inner(dataset))
            while True:
                with torch.profiler.record_function("bench.wait_batch"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch

        self.trainer._batches = batches

    def step(self):
        """One epoch; returns the patches of its finished steps."""
        before = self.rec.calls
        self.trainer.train_step(self.dataset, self.epoch)
        self.input_wait_s += self.trainer.input_wait_s
        self.epoch += 1
        return float((self.rec.calls - before)
                     * self.ctx.cfg["train"]["batch_size"])

    def counters(self):
        """Step times, and the sampler wait the Trainer counted."""
        out = super().counters()
        out["input_wait_s"] = self.input_wait_s
        return out


control_readings = training.control_readings


def setup(ctx):
    """Build the session of one run."""
    return Session(ctx)
