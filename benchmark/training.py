"""Training cells' shared set-up and check, for the UNet3D alone.

The training drivers, this module and :mod:`benchmark.reference.train`
build, step and check the UNet3D directly (``benchmark/models/unet3d.py``,
``benchmark/reference/unet3d.py``); a configuration of another
architecture is refused.

Set-up builds one ``Trainer`` and one ``TrainDataset`` over seeded tube
volumes, loads weights made from the seed on the device, and drives the
Trainer through ``warm_epochs`` epochs of its own ``train_step``: the
user's loop, which is also the warm-up. The first three optimizer steps
are recorded on the way: the host batches the sampler produced, each
step's loss and augmented input, the gradients the optimizer got at the
first step (from AdamW's first moment, ``exp_avg / (1 - beta1)``) and
the weights after the third, before the fourth moves them.

The check runs the plain reference (:mod:`benchmark.reference.train`)
from the same volumes, seed and starting weights: it draws the batches
again, augments them, and takes three float32 steps. Numbers compared:

* ``batch_mismatch``: elements of the sampler's batches that differ from
  the reference's draw (labels compared as partitions, since the program
  renumbers them), exact;
* ``input_gap``: the largest gap of the augmented inputs;
* ``loss_gap``: the largest relative gap of the three losses;
* ``grad_gap`` and ``update_gap``: by the worst leaf, the gap between the
  norms of the program's and the reference's first gradient (and change
  of the weights over the three steps), over the reference's norm of that
  leaf or of the median leaf, whichever is larger; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out of the
  change (their moves are round-off under Adam).
"""

import contextlib
import shutil
import tempfile

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.models import unet3d as model
from benchmark.reference import train as ref_train

CHECKED_STEPS = 3
BETA1 = 0.9


def unet3d_only(cfg):
    """Refuse a configuration of another architecture than the UNet3D."""
    arch = cfg["model"]["architecture"]
    if arch != "UNet3D":
        raise ValueError(f"the training cells run the UNet3D alone, not "
                         f"{arch!r}")


def host_copy(t):
    """A host copy of a tensor that later steps cannot change."""
    return t.detach().to("cpu", copy=True)


def make_volumes(cfg, seed):
    """The seeded (images, labels) the training cell trains on."""
    d = cfg["train_data"]
    pairs = [inputs.tube_volume(seed, k, d["size"], d["tubes"], d["radius"],
                                d["noise"], d["bright"])
             for k in range(d["volumes"])]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def reference_batches(cfg, imgs, labs, seed, steps=CHECKED_STEPS):
    """The reference's draw of the first ``steps`` batches, stacked."""
    t = cfg["train"]
    b = t["batch_size"]
    items = ref_train.sample_items(
        imgs, labs, seed, steps * b, (t["patch"],) * 3, t["clip"],
        tuple(t["percentiles"]))
    return [tuple(np.stack([it[j] for it in items[i * b:(i + 1) * b]])
                  for j in range(3)) for i in range(steps)]


def partition_mismatch(got, want):
    """Voxels where two label patches disagree as partitions: background
    placed differently, plus the excess of distinct label pairs over the
    distinct labels of either side."""
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    if got.shape != want.shape:
        return max(got.size, want.size)
    bad = int(((got == 0) != (want == 0)).sum())
    pairs = len(np.unique(got.astype(np.int64) * (1 << 32)
                          + want.astype(np.int64)))
    return bad + (pairs - len(np.unique(got))) + (pairs - len(np.unique(want)))


def batch_mismatch(got, want):
    """Differing elements between the program's recorded host batches
    ``((raw, scale), labels)`` and the reference's ``(raw, scale,
    labels)``."""
    bad = 0
    for (xs, ys), (raw, scale, lab) in zip(got, want):
        g_raw, g_scale = xs
        bad += int(g_raw.size != raw.size) or int(
            (np.asarray(g_raw, np.int64).reshape(raw.shape)
             != raw.astype(np.int64)).sum())
        bad += int(g_scale.size != scale.size) or int(
            (np.asarray(g_scale).reshape(scale.shape) != scale).sum())
        bad += sum(partition_mismatch(g, w) for g, w in zip(ys, lab))
    return bad


def norm_gaps(got, want, skip=()):
    """Per leaf not in ``skip``: ``|‖got‖ - ‖want‖| / max(‖want‖, median
    ‖want‖)``, by name."""
    norms = {k: float(want[k].double().norm()) for k in want}
    floor = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].double().norm()) - norms[k])
            / max(norms[k], floor, 1e-30) for k in want if k not in skip}


def compare(prog, ref, params0, worst_leaves=None):
    """Numbers of the check from the program's record ``prog`` and the
    reference's ``(losses, first gradients, weights, inputs)``; ``prog``
    holds ``losses``, ``grads``, ``weights`` and ``inputs`` alike.

    The losses' relative gaps: ``loss_gap_first`` of the first step (the
    forward alone) and ``loss_gap`` the largest of the later steps (which
    carry the updates' round-off). The norm gaps (:func:`norm_gaps`) of
    the first gradient and of the change over the steps: the worst leaf's
    (``grad_gap``, ``update_gap``) and the median leaf's. Leaves whose
    reference gradient is under a thousandth of the median leaf's (conv
    biases ahead of a train-mode BatchNorm, whose gradient is nought) are
    left out of the norm gaps: their gradients and moves are round-off.
    ``worst_leaves`` (a list) gets the worst leaf of each norm's gap.
    """
    losses, g_ref, w_ref, x_ref = ref
    got = np.asarray(prog["losses"], np.float64)
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, losses)]
    if len(got) != len(losses) or not np.isfinite(got).all():
        rel = [float("inf")] * len(losses)
    g_norm = {k: float(g.double().norm()) for k, g in g_ref.items()}
    median = float(np.median(list(g_norm.values())))
    still = {k for k, v in g_norm.items() if v < 1e-3 * median}
    d_ref = {k: w_ref[k] - params0[k].cpu() for k in w_ref}
    d_prog = {k: prog["weights"][k] - params0[k].cpu() for k in w_ref}
    grad = norm_gaps(prog["grads"], g_ref, still)
    update = norm_gaps(d_prog, d_ref, still)
    if worst_leaves is not None:
        worst_leaves += [max(grad, key=grad.get), max(update, key=update.get)]
    input_gap = max(float((a - b).abs().max())
                    for a, b in zip(prog["inputs"], x_ref))
    return [("input_gap", input_gap), ("loss_gap_first", rel[0]),
            ("loss_gap", max(rel[1:])),
            ("grad_gap", max(grad.values())),
            ("grad_gap_median", float(np.median(list(grad.values())))),
            ("update_gap", max(update.values())),
            ("update_gap_median", float(np.median(list(update.values()))))]


class Recorder:
    """Wraps ``trainer.train_batch``: in set-up it keeps every host batch
    (the pool) and the first steps' batches, losses, inputs, first
    gradients and weights; in the window, CUDA events around every call,
    inside a ``bench.train_batch`` span where ``span`` is set."""

    def __init__(self, trainer, device, span):
        self.trainer, self.device, self.span = trainer, device, span
        self.inner = trainer.train_batch
        self.events, self.pool, self.losses, self.inputs = [], [], [], []
        self.grads = self.weights = None
        self.timing = False
        self.calls = 0
        self.hook = trainer.model.register_forward_pre_hook(self._input)
        trainer.train_batch = self

    def _input(self, module, args):
        if len(self.inputs) < CHECKED_STEPS:
            self.inputs.append(host_copy(args[0].float()))

    def __call__(self, xs, ys, epoch=0, step=0):
        if self.timing:
            return self._timed(xs, ys, epoch, step)
        n = len(self.pool)
        out = self.inner(xs, ys, epoch, step)
        self.pool.append((xs, ys))
        if n < CHECKED_STEPS:
            self.losses.append(float(out[0]))
            opt = self.trainer.optimizer
            named = dict(self.trainer.model.named_parameters())
            if n == 0:
                # no first moment: the optimizer took no step
                self.grads = {k: host_copy(opt.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / (1 - BETA1))
                    for k, p in named.items()}
            if n == CHECKED_STEPS - 1:
                self.weights = {k: host_copy(p)
                                for k, p in named.items()}
                self.hook.remove()
        return out

    def _timed(self, xs, ys, epoch, step):
        self.calls += 1
        span = (torch.profiler.record_function("bench.train_batch")
                if self.span else contextlib.nullcontext())
        with span:
            if self.device.type != "cuda":
                return self.inner(xs, ys, epoch, step)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.inner(xs, ys, epoch, step)
            end.record()
            self.events.append((start, end))
            return out

    def step_device_s(self):
        """Device seconds between the events around each timed call."""
        return [s.elapsed_time(e) / 1e3 for s, e in self.events]


class TrainSession:
    """One Trainer, its dataset and the record of its first steps."""

    span = "bench.train_batch"

    def __init__(self, ctx):
        from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (  # noqa: E501
            data_handling,
            train,
        )

        self.ctx, cfg = ctx, ctx.cfg
        unet3d_only(cfg)
        t, m = cfg["train"], cfg["model"]
        clock = harness.Phases()
        self.imgs, self.labs = make_volumes(cfg, ctx.seed)
        clock.mark("volumes")
        self.dataset = data_handling.TrainDataset(
            self.imgs, self.labs, brightness_clip=t["clip"],
            normalization_percentiles=tuple(t["percentiles"]),
            patch_shape=(t["patch"],) * 3, seed=ctx.seed,
            return_label_patches=True)
        clock.mark("dataset")
        self.workdir = tempfile.mkdtemp(prefix="bench_train_")
        self.trainer = train.Trainer(
            self.workdir, batch_size=t["batch_size"], lr=t["lr"],
            use_amp=t["amp"], width_multiplier=m["width"], seed=ctx.seed,
            num_workers=t["num_workers"], device=ctx.device)
        clock.mark("trainer")
        self.params0 = model.conv_weights(ctx.seed, ctx.device, m["width"],
                                          m["out_channels"])
        self.trainer.model.load_state_dict(
            model.checkpoint_state(self.params0), strict=True)
        self.params0 = {k: host_copy(v) for k, v in
                        self.trainer.model.named_parameters()}
        clock.mark("weights")
        self.rec = Recorder(self.trainer, ctx.device,
                            span=self.span != "bench.train_batch")
        self.steps_per_epoch = -(-len(self.dataset) // t["batch_size"])
        self.epoch = 0
        for _ in range(ctx.traffic["warm_epochs"]):
            self.trainer.train_step(self.dataset, self.epoch)
            self.epoch += 1
            clock.mark(f"epoch{self.epoch - 1}")
        self.phases = clock.text()
        self.rec.timing = True
        self.patches = 0

    def counters(self):
        """The device time of every timed ``train_batch``."""
        return {"step_device_s": self.rec.step_device_s(),
                "steps": self.rec.calls}

    def describe(self):
        """One line on the window's steps."""
        batch = self.ctx.cfg["train"]["batch_size"]
        return (f"set-up {self.phases}; {self.rec.calls} steps of {batch} "
                f"patches")

    def free(self):
        """Drop the Trainer (model, optimizer state) and its files."""
        if self.trainer.writer is not None:
            self.trainer.writer.close()
        self.trainer = self.rec.trainer = self.rec.inner = None
        shutil.rmtree(self.workdir, ignore_errors=True)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The first steps against the reference's."""
        cfg, seed = self.ctx.cfg, self.ctx.seed
        want = reference_batches(cfg, self.imgs, self.labs, seed)
        numbers = [("batch_mismatch", batch_mismatch(
            self.rec.pool[:CHECKED_STEPS], want))]
        ref = ref_train.train_steps(
            self.params0, want,
            [(seed, 0, s) for s in range(CHECKED_STEPS)], self.ctx.device)
        prog = dict(losses=self.rec.losses, grads=self.rec.grads,
                    weights=self.rec.weights, inputs=self.rec.inputs)
        self.worst_leaves = []
        self.numbers = numbers + compare(prog, ref, self.params0,
                                         self.worst_leaves)
        return self.numbers


def control_readings(cfg, traffic, seed, device):
    """``{kind: [(name, value), ...]}`` of the control (the reference with
    float8 convolutions) and of the planted faults (half of the batch left
    out, the first example's targets inverted), each taken through the
    reference's three steps against the float32 reference's."""
    unet3d_only(cfg)
    imgs, labs = make_volumes(cfg, seed)
    m = cfg["model"]
    p0 = {k: v.cpu() for k, v in model.conv_weights(
        seed, device, m["width"], m["out_channels"]).items()
        if not k.endswith(("running_mean", "running_var"))}
    batches = reference_batches(cfg, imgs, labs, seed)
    keys = [(seed, 0, s) for s in range(CHECKED_STEPS)]
    ref = ref_train.train_steps(p0, batches, keys, device)
    out = {}
    for kind, kw in (("control_fp8", dict(quant="fp8")),
                     ("fault_half_batch", dict(fault="half_batch")),
                     ("fault_flip_targets", dict(fault="flip_targets"))):
        losses, grads, weights, xs = ref_train.train_steps(
            p0, batches, keys, device, **kw)
        prog = dict(losses=losses, grads=grads, weights=weights, inputs=xs)
        leaves = []
        out[kind] = compare(prog, ref, p0, leaves) + [
            ("worst_leaves", leaves)]
    return out
