"""``Trainer.train_batch`` over a pool of batches the sampler drew.

The pool is the host batches the Trainer's own sampler produced during
set-up (its warm epochs), cycled in order; the epoch and step indices
advance, so every step draws fresh augmentation. The sampler is not in
the window: this is the step-bound regime of a job whose input keeps up.
The UNet3D alone (:mod:`benchmark.training`).
"""

from benchmark import training


class Session(training.TrainSession):
    """Steps through ``train_batch`` on the pooled batches."""

    def __init__(self, ctx):
        pool = ctx.traffic["pool_batches"]
        super().__init__(ctx)
        self.pool = self.rec.pool[:pool]
        if len(self.pool) < pool:
            raise ValueError(f"set-up drew {len(self.pool)} batches, the "
                             f"pool needs {pool}")
        self.k = 0

    def step(self):
        """One optimizer step; returns its patches."""
        xs, ys = self.pool[self.k % len(self.pool)]
        epoch = self.epoch + self.k // self.steps_per_epoch
        self.trainer.train_batch(xs, ys, epoch, self.k % self.steps_per_epoch)
        self.k += 1
        return float(self.ctx.cfg["train"]["batch_size"])


control_readings = training.control_readings


def setup(ctx):
    """Build the session of one run."""
    return Session(ctx)
