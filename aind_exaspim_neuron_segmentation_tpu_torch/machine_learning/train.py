"""Training loop: UNet3D, AdamW, cosine schedule, metrics, checkpoints.

The training contract of the JAX package's ``machine_learning/train.py``
(and of the reference's train.py:29-309): BCE-with-logits loss,
AdamW(lr=1e-3, weight_decay=0.01), a cosine-annealing LR with period 25
epochs set per epoch, a per-run ``session-YYYYmmdd_HHMM`` directory,
TensorBoard scalars ``{train,val}_{loss,precision,recall,f1}``, epoch F1
= harmonic mean of the nan-mean precision and recall, and best-F1
checkpoints ``UNet3d-{date}-{epoch}-{f1:.4f}.pth`` holding the reference
state_dict keys.

On the card a step runs under ``torch.autocast`` in bfloat16 with float32
parameters (``use_amp``, the default); on the CPU it runs in float32.
Batches leave the host compact: integer labels (the affinity targets are
derived on the device) and, for a device-augment dataset of u8/u16
volumes, the brightness-clipped raw patch plus two float32 scalars per
example, normalized on the device with the host's exact formula
(:func:`..machine_learning.data_handling.reconstruct_normalized`).
Per-step metrics stay on the device until the epoch ends, so the host
does not wait for a step before it prepares the next batch.

``accumulate_grads_quirk=True`` reproduces the reference, which never
calls ``optimizer.zero_grad()``: ``.grad`` is not zeroed, so the
optimizer sees the running sum of every step's gradients.

``mesh=`` (a ``parallel.RankMesh``) trains data-parallel, one process per
rank, as the JAX package's ``Trainer(mesh=)`` does in one program: every
rank samples the identical host batch (same seeds), a ragged last batch
repeats its last example to fill the ranks (example weight 0), and each
rank takes its block of rows (``parallel.sharded_first_axis``).
Augmentation draws the global batch's parameters and applies this rank's
rows. The BatchNorms synchronize their statistics over the mesh
(``parallel.sync_batchnorm``), the loss is the global batch's weighted
mean, each rank's gradients are summed over the mesh with one
``all_reduce`` after the backward, and the parameters start from the
mesh's first rank (``parallel.replicated``), so every rank's AdamW takes
the single-process step. Per-example metrics are gathered in block order
at the end of an epoch. A mesh of one rank trains as without one.
"""

import math
import os
import time
from datetime import datetime

import numpy as np
import torch
import torch.nn.functional as F

from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
    affinity_channels,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.data_handling import (  # noqa: E501
    iterate_batches,
    prefetch_batches,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops.augment_device import (
    apply_augment,
    draw_augment_params,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    replicated,
    sharded_first_axis,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel.sync_batchnorm import (  # noqa: E501
    convert_sync_batchnorm,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils import util
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import annotate


def cosine_annealing_lr(base_lr, t_max=25, eta_min=0.0):
    """torch.optim.lr_scheduler.CosineAnnealingLR closed form."""

    def schedule(epoch):
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * epoch / t_max)
        ) / 2

    return schedule


def batch_precision_recall(logits_c0, labels_c0):
    """Per-example precision/recall with nan on empty denominators.

    Thresholds follow the reference (train.py:242-255): prediction =
    logits > 0 (i.e. sigmoid > 0.5), truth = label > 0, channel 0 only.
    """
    pred = logits_c0 > 0
    true = labels_c0 > 0
    dims = tuple(range(1, pred.dim()))
    tp = (pred & true).sum(dim=dims).float()
    pp = pred.sum(dim=dims).float()
    ap = true.sum(dim=dims).float()
    nan = torch.full_like(tp, float("nan"))
    precision = torch.where(pp > 0, tp / torch.clamp(pp, min=1), nan)
    recall = torch.where(ap > 0, tp / torch.clamp(ap, min=1), nan)
    return precision, recall


def _int_to_device(arr, device):
    """Integer batch -> int32 tensor on ``device``. uint16 travels as its
    int16 bit pattern (2 B/voxel) and is widened on the device, where
    torch's unsigned 16-bit support is limited."""
    if arr.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.to(device).to(torch.int32) & 0xFFFF
    return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(device)


class Trainer:
    """Training loop owner (reference train.py:29 surface).

    Parameters mirror the JAX package's Trainer; ``device`` (default
    ``cuda``, which raises without a card) is where the model trains, on
    every rank of ``mesh`` (``batch_size`` must divide by its size).
    """

    def __init__(
        self,
        output_dir,
        affinity_mode=True,
        batch_size=16,
        lr=1e-3,
        max_epochs=1000,
        use_amp=True,
        width_multiplier=1,
        accumulate_grads_quirk=False,
        seed=0,
        mesh=None,
        device_augment=None,
        prefetch=True,
        num_workers=0,
        wire_labels=True,
        device=None,
    ):
        self.device = resolve_device(device)
        if num_workers and not prefetch:
            raise ValueError(
                "num_workers>0 forks background producers, which "
                "prefetch=False explicitly disables -- pick one"
            )
        # data parallelism over the mesh's first axis; None when training
        # alone (a mesh of one rank included)
        self.mesh = mesh
        self._rows = None
        if mesh is not None:
            if batch_size % mesh.size != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide evenly over "
                    f"{mesh.size} ranks"
                )
            if mesh.size > 1:
                self._rows = sharded_first_axis(mesh, mesh.axis_names[0])
                self._rows.rows(batch_size)  # raises off the mesh
        exp_name = "session-" + datetime.today().strftime("%Y%m%d_%H%M")
        self.log_dir = os.path.join(output_dir, exp_name)
        util.mkdir(self.log_dir)

        self.affinity_mode = affinity_mode
        self.batch_size = batch_size
        self.base_lr = lr
        self.max_epochs = max_epochs
        self.best_f1 = 0.0
        self.epoch = 0
        self.seed = seed
        self.accumulate_grads_quirk = accumulate_grads_quirk
        # None = auto: on at the first train_step whenever the dataset
        # ships raw label patches (_resolve_device_augment); False opts
        # out; True fails fast on an ineligible dataset.
        self.device_augment = device_augment
        # A background producer (a thread, or num_workers forked
        # processes) samples the next batches while the device runs.
        self.prefetch = prefetch
        self.num_workers = num_workers
        # Compact integer label batches; the targets are derived on the
        # device (_apply_wire_mode).
        self.wire_labels = wire_labels
        self.input_wait_s = 0.0  # host time blocked waiting on batches
        self.use_amp = use_amp and self.device.type == "cuda"

        model = UNet3D(output_channels=3 if affinity_mode else 1,
                       width_multiplier=width_multiplier)
        init_weights(model, torch.Generator().manual_seed(seed))
        if self._rows is not None:
            convert_sync_batchnorm(model, mesh)
        self.model = model.to(self.device).train()
        if self._rows is not None:
            start = replicated(mesh)
            for t in self.model.state_dict().values():
                start.place(t)
        self.schedule = cosine_annealing_lr(lr, t_max=25)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=lr, weight_decay=0.01
        )
        self.writer = self._make_writer()

    # --- one batch ---

    def _targets_from_labels(self, y):
        """(N, 1, D, H, W) integer labels -> float32 targets on the
        device: affinity channels (label-equality tests, so any
        equality-preserving relabel gives the same targets) or the
        foreground mask."""
        if self.affinity_mode:
            return affinity_channels(y[:, 0])
        return (y > 0).float()

    def _shard(self, xs, ys, n_real):
        """(xs, ys, example mask) of this rank of a batch of ``n_real``
        examples: a ragged batch repeats its last example to fill the mesh
        (mask 0), then each rank keeps its block of rows. Alone, the batch
        and a mask of ones."""
        raw = isinstance(xs, tuple)
        pad = 0 if self._rows is None else -n_real % self._rows.blocks
        w = np.concatenate([np.ones(n_real, np.float32),
                            np.zeros(pad, np.float32)])
        if self._rows is None:
            return xs, ys, w

        def cut(a):
            if pad:
                a = np.concatenate([a, np.repeat(a[-1:], pad, 0)])
            lo, hi = self._rows.rows(len(a))
            return a[lo:hi]

        xs = tuple(cut(a) for a in xs) if raw else cut(xs)
        lo, hi = self._rows.rows(len(w))
        return xs, cut(ys), w[lo:hi]

    def _to_device_batch(self, xs, ys):
        """Host batch -> (x, y, example mask, real examples of the whole
        batch) on the device.

        ``xs`` is float32 patches, or a raw-wire ``(u16 patches, (N, 2)
        float32 [mn, inv])`` pair, reconstructed here as
        ``clip((x - mn) * inv, 0, 1)``. Integer ``ys`` stay integral
        (int32); float targets travel as float32. On a mesh, this rank's
        rows (:meth:`_shard`).
        """
        dev = self.device
        n_real = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
        xs, ys, w = self._shard(xs, ys, n_real)
        if isinstance(xs, tuple):
            raw, scale = xs
            x = _int_to_device(raw, dev).float()
            scale = torch.from_numpy(np.asarray(scale, np.float32)).to(dev)
            mn = scale[:, 0].view(-1, 1, 1, 1, 1)
            inv = scale[:, 1].view(-1, 1, 1, 1, 1)
            x = torch.clamp((x - mn) * inv, 0.0, 1.0)
        else:
            x = torch.from_numpy(np.ascontiguousarray(xs, np.float32)).to(dev)
        if ys.dtype.kind in "biu":
            y = _int_to_device(ys, dev)
        else:
            y = torch.from_numpy(np.ascontiguousarray(ys, np.float32)).to(dev)
        return x, y, torch.from_numpy(w).to(dev), n_real

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.use_amp)

    @staticmethod
    def _loss(logits, y, w, n_real):
        """Sum over examples (weighted by the mask ``w``) of the
        per-example BCE-with-logits mean, over the batch's ``n_real``
        real examples: the batch's weighted mean, or on a mesh this
        rank's share of it."""
        per_ex = F.binary_cross_entropy_with_logits(
            logits.float(), y, reduction="none"
        ).mean(dim=tuple(range(1, logits.dim())))
        return (per_ex * w).sum() / max(float(n_real), 1.0)

    def _augment_generator(self, epoch, step):
        """The ``torch.Generator`` (on the training device) of one train
        step's augmentation draws, keyed by ``(seed + 1, epoch * 100003 +
        step)``."""
        words = np.random.SeedSequence(
            [self.seed + 1, epoch * 100003 + step]
        ).generate_state(2, np.uint32)
        seed = int(words[0]) | int(words[1]) << 32
        return torch.Generator(device=self.device).manual_seed(seed)

    def train_batch(self, xs, ys, epoch=0, step=0):
        """One optimizer step on a host batch; returns the loss and the
        per-example precision and recall as device tensors (on a mesh:
        this rank's share of the loss and its rows' metrics)."""
        with annotate("train.input"):
            x, y, w, n_real = self._to_device_batch(xs, ys)
            if self.device_augment:
                n = x.shape[0] * (1 if self._rows is None
                                  else self._rows.blocks)
                params = draw_augment_params(
                    self._augment_generator(epoch, step), n, x.shape[2:])
                if self._rows is not None:
                    params = {k: self._rows.place(v)
                              for k, v in params.items()}
                x, label = apply_augment(x, y, params)
                y = self._targets_from_labels(label)
            elif not y.is_floating_point():
                y = self._targets_from_labels(y)
        running = None
        if self._rows is not None and self.accumulate_grads_quirk:
            # the running sum is summed over the mesh already
            running = [p.grad for p in self.model.parameters()]
        if self._rows is not None or not self.accumulate_grads_quirk:
            self.optimizer.zero_grad(set_to_none=True)
        with annotate("train.forward"):
            with self._autocast():
                logits = self.model(x)
            loss = self._loss(logits, y, w, n_real)
        with annotate("train.backward"):
            loss.backward()
        if self._rows is not None:
            self._reduce_grads(running)
        self.optimizer.step()
        precision, recall = batch_precision_recall(
            logits.detach()[:, 0].float(), y[:, 0]
        )
        return loss.detach(), precision, recall

    def _reduce_grads(self, running):
        """Sum this step's gradients over the mesh (one ``all_reduce``),
        then add ``running`` (the quirk's running sum, or None)."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        flat = all_reduce_sum(flat, self.mesh)
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p))
            at += p.numel()
        if running is not None:
            for p, g in zip(self.model.parameters(), running):
                if g is not None:
                    p.grad += g

    @torch.no_grad()
    def eval_batch(self, xs, ys):
        """Eval-mode loss and per-example precision and recall of a host
        batch, as device tensors."""
        x, y, w, n_real = self._to_device_batch(xs, ys)
        if not y.is_floating_point():
            y = self._targets_from_labels(y)
        self.model.eval()
        try:
            with self._autocast():
                logits = self.model(x)
        finally:
            self.model.train()
        precision, recall = batch_precision_recall(logits[:, 0].float(),
                                                   y[:, 0])
        return self._loss(logits, y, w, n_real), precision, recall

    # --- loop ---

    def run(self, train_dataset, val_dataset):
        """Train/validate for max_epochs (reference train.py:89-121)."""
        exp_name = os.path.basename(os.path.normpath(self.log_dir))
        print("\nExperiment:", exp_name)
        for epoch in range(self.epoch, self.max_epochs):
            self.epoch = epoch
            self._set_lr(self.schedule(epoch))
            train_stats = self.train_step(train_dataset, epoch)
            val_stats, new_best = self.validate_step(val_dataset, epoch)
            print(f"\nEpoch {epoch}: " + ("New Best!" if new_best else " "))
            self.report_stats(train_stats, is_train=True)
            self.report_stats(val_stats, is_train=False)
        return self.best_f1

    def _set_lr(self, lr):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _resolve_device_augment(self, dataset):
        """Resolve ``device_augment=None`` (auto) against the dataset:
        on exactly when it ships raw label patches. ``True`` against a
        host-transformed dataset is a contract error (its float targets
        cannot be re-augmented)."""
        eligible = bool(getattr(dataset, "return_label_patches", False))
        if self.device_augment is None and eligible:
            self.device_augment = True
        elif self.device_augment and not eligible:
            raise ValueError(
                "device_augment needs TrainDataset("
                "return_label_patches=True): this dataset ships "
                "host-transformed targets that cannot be re-augmented "
                "on device"
            )

    def _apply_wire_mode(self, dataset):
        """Switch a BaseDataset to the compact-label wire when enabled.

        Device-augment datasets (return_label_patches) also get the
        raw-image wire when every input volume is u8/u16 with an integral
        brightness clip: u16 patches plus per-patch f32 (mn, inv), 3.5
        B/voxel with the labels instead of 8.
        """
        if not (self.wire_labels and hasattr(dataset, "wire_labels")):
            return
        dataset.wire_labels = True
        if getattr(dataset, "return_label_patches", False):
            clip = dataset.brightness_clip
            dataset.wire_raw_images = float(clip) == int(clip) and all(
                np.dtype(getattr(img, "dtype", np.float32)).kind == "u"
                and np.dtype(img.dtype).itemsize <= 2
                for img in dataset.input_imgs
            )

    def _batches(self, dataset):
        if self.prefetch:
            return prefetch_batches(dataset, self.batch_size,
                                    num_workers=self.num_workers)
        return iterate_batches(dataset, self.batch_size)

    def _collect(self, pending, stats):
        """Fetch an epoch's device-resident metrics into ``stats``; on a
        mesh, every rank's in one ``all_gather`` (loss shares summed,
        per-example metrics in block order)."""
        if self._rows is not None and pending:
            # a ragged last batch has fewer rows a rank; every rank's
            # steps have the same sizes
            sizes = [1 + 2 * p.numel() for _, _, p, _ in pending]
            local = torch.cat([
                torch.cat([loss.view(1).float(), p.float(), r.float()])
                for _, loss, p, r in pending])
            rows = self._rows.gather(local[None])  # (blocks, sum(sizes))
            gathered, at = [], 0
            for (n_real, *_), size in zip(pending, sizes):
                part, b = rows[:, at:at + size], (size - 1) // 2
                gathered.append((n_real, part[:, 0].sum(),
                                 part[:, 1:1 + b].reshape(-1),
                                 part[:, 1 + b:].reshape(-1)))
                at += size
            pending = gathered
        for n_real, loss, precision, recall in pending:
            stats["loss"].append(float(loss))
            stats["precision"].extend(precision.cpu()[:n_real].tolist())
            stats["recall"].extend(recall.cpu()[:n_real].tolist())

    def train_step(self, train_dataset, epoch):
        """Run one training epoch; returns the epoch's metric stats."""
        stats = {"f1": None, "precision": [], "recall": [], "loss": []}
        self._resolve_device_augment(train_dataset)
        self._apply_wire_mode(train_dataset)
        pending = []
        self.input_wait_s = 0.0
        t_wait = time.perf_counter()
        for step, (xs, ys) in enumerate(self._batches(train_dataset)):
            self.input_wait_s += time.perf_counter() - t_wait
            n_real = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
            pending.append(
                (n_real,) + self.train_batch(xs, ys, epoch, step)
            )
            t_wait = time.perf_counter()
        self._collect(pending, stats)
        self.update_tensorboard(stats, epoch, "train_")
        return stats

    def validate_step(self, val_dataset, epoch):
        """Run one validation epoch; returns the epoch's metric stats and
        whether its F1 is a new best (then a ``.pth`` is written)."""
        stats = {"f1": None, "precision": [], "recall": [], "loss": []}
        self._apply_wire_mode(val_dataset)
        pending = [
            (xs.shape[0],) + self.eval_batch(xs, ys)
            for xs, ys in self._batches(val_dataset)
        ]
        self._collect(pending, stats)
        self.update_tensorboard(stats, epoch, "val_")
        if stats["f1"] > self.best_f1:
            self.best_f1 = stats["f1"]
            self.save_model(epoch)
            return stats, True
        return stats, False

    # --- reporting / checkpoints ---

    def report_stats(self, stats, is_train=True):
        """Print one-line epoch metrics (reference train.py formatting)."""
        summary = "   Train: " if is_train else "   Val: "
        summary += ", ".join(f"{k}={v:.4f}" for k, v in stats.items())
        print(summary)

    def update_tensorboard(self, stats, epoch, prefix):
        """Epoch F1 from nan-mean precision/recall (train.py:288-309)."""
        with np.errstate(invalid="ignore"):
            avg_p = np.nanmean(stats["precision"]) if stats["precision"] else np.nan
            avg_r = np.nanmean(stats["recall"]) if stats["recall"] else np.nan
        denom = avg_p + avg_r
        stats["f1"] = [2 * avg_p * avg_r / denom if denom > 0 else 0.0]
        for key, value in stats.items():
            with np.errstate(invalid="ignore"):
                stats[key] = float(np.nanmean(value)) if len(value) else 0.0
            if self.writer is not None:
                self.writer.add_scalar(prefix + key, stats[key], epoch)

    def _state_dict(self):
        return {k: v.detach().cpu() for k, v in
                self.model.state_dict().items()}

    def save_model(self, epoch):
        """Best-F1 ``.pth`` export (reference train.py:274-286 contract):
        the model's state_dict with the reference checkpoint keys."""
        date = datetime.today().strftime("%Y%m%d")
        filename = f"UNet3d-{date}-{epoch}-{self.best_f1:.4f}.pth"
        torch.save(self._state_dict(), os.path.join(self.log_dir, filename))

    def save_train_state(self, path=None):
        """Everything a resume needs, in one ``torch.save`` file: model,
        optimizer state, the ``.grad`` running sum under the quirk, epoch
        and best F1. Returns the path."""
        path = path or os.path.join(self.log_dir, "train_state.pt")
        state = {
            "model": self._state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "epoch": self.epoch,
            "best_f1": self.best_f1,
        }
        if self.accumulate_grads_quirk:
            state["grads"] = [
                None if p.grad is None else p.grad.detach().cpu()
                for p in self.model.parameters()
            ]
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        return path

    def restore_train_state(self, path):
        """Resume from :meth:`save_train_state`: the next :meth:`run`
        starts at the saved epoch + 1."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        if self.accumulate_grads_quirk:
            for p, g in zip(self.model.parameters(), state["grads"]):
                p.grad = g
        self.epoch = int(state["epoch"]) + 1
        self.best_f1 = float(state["best_f1"])
        return self

    def _make_writer(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            return None
        return SummaryWriter(log_dir=self.log_dir)


def toCPU(tensor, to_numpy=False):
    """Detached CPU copy of ``tensor``, as numpy with ``to_numpy``
    (reference train.py:313-333)."""
    tensor = tensor.detach().cpu()
    return tensor.numpy() if to_numpy else tensor
