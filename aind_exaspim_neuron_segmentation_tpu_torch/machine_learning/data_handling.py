"""Patch-sampling datasets for training and validation (numpy only).

The port's own copy of the JAX package's datasets: the same ``random`` and
numpy generator calls in the same order, so a seed gives the same samples
and batches, byte for byte. Nothing here touches torch: the forked
sampler workers of :func:`prefetch_batches` run this module in children
of a process that may have initialised CUDA.

Sampling semantics mirror reference machine_learning/data_handling.py:
* BaseDataset loads all volumes up front via ``img_util.read``
  (data_handling.py:67-89), extracts center-based patches, clips
  brightness (default 300 -- the train-side default, vs 1000 in predict,
  a deliberate reference inconsistency preserved here), percentile
  min-max normalizes per patch;
* TrainDataset draws volumes with probability proportional to their
  foreground voxel counts, biases 85% of draws toward foreground
  patches (> 10^3 foreground voxels) with <= 25 rejection-sampling
  attempts, reports ``len = 4 * n_volumes``, and computes affinity
  targets on the fly (data_handling.py:156-311);
* ValidateDataset enumerates a deterministic non-overlapping grid of
  patch centers, keeping every foreground example plus a random 25%
  count of background examples (data_handling.py:314-458).

Deliberate deviations (documented):
* volumes may be given as in-memory arrays, not only paths;
* ``normalization_percentiles`` is actually forwarded to the base class
  (the reference accepts-but-drops it, data_handling.py:194-200);
* ``transform`` accepts a callable and uses it (the reference's
  truthiness check replaces any callable with the default
  ImageTransforms, data_handling.py:203); ``transform=True`` selects the
  default pipeline;
* datasets accept a ``seed`` for reproducible sampling.
"""

import random as _random

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
    get_affinity_channels,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import normalize
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    generate_patch_starts,
    get_patch,
    is_contained,
)
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.augmentation import (  # noqa: E501
    ImageTransforms,
)

FOREGROUND_MIN_VOXELS = 10**3


def _load(volume_or_path):
    if isinstance(volume_or_path, str):
        from aind_exaspim_neuron_segmentation_tpu_torch.io import read

        return read(volume_or_path)
    return volume_or_path


def compact_labels(label_patch, min_dtype=np.uint16):
    """First-appearance relabel to the narrowest integer wire dtype.

    Label-EQUALITY is all the on-device affinity-target computation
    consumes, and the foreground test only needs zero-preservation, so
    the contiguous first-appearance renumber (native fastremap-parity
    engine) is exact; uint16 covers any patch with < 2^16 distinct
    segments (a 96^3 patch virtually always), uint32 otherwise.
    ``min_dtype=np.uint32`` skips the uint16 narrowing (datasets pin
    the wire dtype once promoted, so batches keep one dtype -- see
    :meth:`BaseDataset._compact_wire`).

    Ids wider than the native engine's uint32 (u64/i64 volumes --
    sparse global ids are common in external segmentations) are
    pre-compacted EXACTLY via ``np.unique`` before the renumber; a
    plain dtype cast would alias ids congruent mod 2^32 and fabricate
    affinities across segment boundaries. Negative ids are rejected
    (the foreground contract is ``label > 0``).
    """
    from aind_exaspim_neuron_segmentation_tpu_torch import native

    arr = np.asarray(label_patch)
    kind, size = arr.dtype.kind, arr.dtype.itemsize
    if kind not in "bui":
        raise ValueError(f"integer label patch expected, got {arr.dtype}")
    if kind == "i" and int(arr.min(initial=0)) < 0:
        raise ValueError(
            "negative label ids are not supported (foreground is "
            "label > 0)"
        )
    if kind == "b" or size <= 4:
        wire = np.ascontiguousarray(arr, dtype=np.uint32)
    else:
        # Exact first-appearance-preserving embed of wide ids into
        # uint32: unique ids (sorted) -> their rank, keeping 0 at 0.
        # The renumber below then assigns first-appearance order, which
        # is identical for any equality-preserving pre-map.
        uniq, inv = np.unique(arr.ravel(), return_inverse=True)
        inv = inv.astype(np.uint32)
        if uniq.size == 0 or uniq[0] != 0:
            inv += 1  # keep 0 meaning background only
        wire = inv.reshape(arr.shape)
    out, n = native.renumber(wire)
    if n < 2**16 and np.dtype(min_dtype) == np.uint16:
        return out.astype(np.uint16)
    return out


def reconstruct_normalized(patch, mn, inv):
    """f32 normalize from raw-wire components: clip((x - mn) * inv, 0, 1).

    The device-augment train path's normalization contract: the host
    fallback (wire off) and the train step on the device (wire on) both
    compute this exact f32 formula -- u16->f32 convert, subtract,
    multiply, clip are each correctly rounded in numpy and in torch's
    elementwise kernels alike, so wire on/off batches are BIT-IDENTICAL.
    It differs from
    :func:`core.normalize.normalize` (f64 arithmetic + division, the
    reference data_handling.py:114-132 semantics kept by the host-augment
    path) by ~1 ulp -- immaterial beneath the augmentation's intensity
    jitter; a deliberate deviation documented here.
    """
    x = patch.astype(np.float32)
    return np.clip((x - np.float32(mn)) * np.float32(inv), 0.0, 1.0)


class BaseDataset:
    """Shared volume loading + patch extraction (reference :22-153)."""

    def __init__(
        self,
        input_img_paths,
        label_mask_paths,
        affinity_mode=True,
        brightness_clip=300,
        normalization_percentiles=(1, 99.9),
        patch_shape=(96, 96, 96),
    ):
        self.affinity_mode = affinity_mode
        self.brightness_clip = brightness_clip
        self.normalization_percentiles = normalization_percentiles
        self.patch_shape = tuple(patch_shape)
        self.input_imgs = [_load(p) for p in input_img_paths]
        self.label_masks = [_load(p) for p in label_mask_paths]
        if len(self.input_imgs) != len(self.label_masks):
            raise ValueError("input and label volume counts differ")

    def get_patch(self, img, center):
        """(1, D, H, W) center-based patch (reference :91-112)."""
        return np.array(get_patch(img, center, self.patch_shape)[np.newaxis])

    def get_input_patch(self, i, center):
        """Clipped + per-patch-normalized input (reference :114-132)."""
        patch = self.get_patch(self.input_imgs[i], center)
        patch = np.minimum(patch, self.brightness_clip)
        return normalize(
            patch, percentiles=self.normalization_percentiles
        ).astype(np.float32)

    def get_raw_input_patch(self, i, center):
        """Clipped patch + f32 normalization scalars for the raw wire.

        Returns ``(patch, mn, inv)`` where ``patch`` is the
        brightness-clipped patch in its source dtype and
        ``reconstruct_normalized(patch, mn, inv)`` recovers the f32
        normalized input. The percentile bounds are computed exactly as
        :meth:`get_input_patch` computes them; the scale is folded into
        a single f32 multiplier so host and device reconstructions use
        only correctly-rounded f32 subtract/multiply/clip.
        """
        patch = self.get_patch(self.input_imgs[i], center)
        patch = np.minimum(patch, self.brightness_clip)
        mn, mx = np.percentile(patch, self.normalization_percentiles)
        return patch, np.float32(mn), np.float32(1.0 / (mx - mn + 1e-8))

    def get_label_patch(self, i, center):
        """Label patch; binarized when not in affinity mode (ref :134-153)."""
        patch = self.get_patch(self.label_masks[i], center)
        if not self.affinity_mode:
            patch = (patch > 0).astype(int)
        return patch

    def _volume_shape(self, i):
        shape = self.label_masks[i].shape
        if len(shape) == 5:
            return shape[2:]
        if len(shape) != 3:
            raise ValueError(
                f"expected 3D or 5D volumes, got shape {shape}"
            )
        return shape

    # Label-wire mode (set by the Trainer): targets leave the host as
    # COMPACT INTEGER LABELS and the train step derives the affinity /
    # foreground channels on the device. Affinities are pure label-equality
    # tests (core/affinities.py), so a first-appearance relabel is
    # exact and the wire shrinks from 12 B/voxel of f32 channels to
    # 2 B/voxel of uint16.
    wire_labels = False
    # Sticky wire dtype: compact_labels narrows to uint16 when a patch
    # has < 2^16 segments, but a lone dense patch must not flip the
    # batch dtype back and forth (np.stack promotes). Once a patch needs
    # uint32 the dataset ships uint32 for good -- the same batches the
    # JAX package's sampler ships.
    _label_wire_dtype = np.uint16

    def _compact_wire(self, label_patch):
        out = compact_labels(label_patch, min_dtype=self._label_wire_dtype)
        if out.dtype.itemsize > np.dtype(self._label_wire_dtype).itemsize:
            self._label_wire_dtype = out.dtype
        return out

    def _target(self, label_patch):
        if self.wire_labels:
            return self._compact_wire(label_patch)
        if self.affinity_mode:
            return get_affinity_channels(label_patch[0]).astype(np.float32)
        return label_patch.astype(np.float32)


class TrainDataset(BaseDataset):
    """Randomized foreground-biased patch sampler (reference :156-311)."""

    def __init__(
        self,
        input_img_paths,
        label_mask_paths,
        affinity_mode=True,
        brightness_clip=300,
        normalization_percentiles=(1, 99.9),
        patch_shape=(96, 96, 96),
        transform=None,
        seed=None,
        return_label_patches=False,
    ):
        super().__init__(
            input_img_paths,
            label_mask_paths,
            affinity_mode=affinity_mode,
            brightness_clip=brightness_clip,
            normalization_percentiles=normalization_percentiles,
            patch_shape=patch_shape,
        )
        if transform is True:
            self.transform = ImageTransforms(seed=seed)
        elif callable(transform):
            self.transform = transform
        else:
            self.transform = None
        self.rng = _random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        # Multi-process sampler support: the base seed (or, unseeded,
        # one OS-entropy draw captured up front -- it does NOT touch the
        # seeded streams above) keys per-worker RNG derivation in
        # reseed_worker.
        self._sampler_seed = seed
        self._worker_entropy = np.random.SeedSequence().entropy
        self._sampler_draw_round = 0
        self.wgts = self.compute_wgts()
        # Device-augmentation mode: hand back raw label patches so the
        # train step can flip jointly and compute affinity
        # targets on device (flipping precomputed affinities would not
        # preserve edge directions).
        self.return_label_patches = return_label_patches
        # Raw-image wire (set by the Trainer alongside wire_labels when
        # every input volume is u8/u16): device-augment batches ship the
        # brightness-clipped integer patch + two f32 scalars per example
        # (4x fewer image bytes); the train step reconstructs the
        # IDENTICAL f32 input (reconstruct_normalized).
        self.wire_raw_images = False

    def compute_wgts(self):
        """Per-volume sampling weights ~ foreground voxel count (ref :206)."""
        wgts = np.array(
            [float((m[:] > 0).sum()) for m in self.label_masks]
        )
        total = wgts.sum()
        if total == 0:
            return np.full(len(wgts), 1.0 / max(len(wgts), 1))
        return wgts / total

    def __len__(self):
        return 4 * len(self.label_masks)

    def __getitem__(self, _ignored):
        if self.return_label_patches:
            # Device-augment mode: raw labels (+ compact-label wire when
            # enabled) and the f32-formula normalized image, either
            # reconstructed here or shipped as raw u16 + scalars for the
            # train step to reconstruct -- bit-identical either way.
            i, center, label_patch = self._sample_location()
            if self.wire_labels:
                label = self._compact_wire(label_patch)
            else:
                # The train step consumes int32 and tests foreground
                # as label > 0: ids that don't embed exactly AND
                # non-negatively in int32 (u64/i64, or u32 >= 2^31)
                # must be compacted first -- a bare astype would alias
                # ids mod 2^32 / wrap foreground negative.
                dt = label_patch.dtype
                exact = dt.kind == "b" or (
                    dt.kind in "ui" and dt.itemsize <= 2
                ) or dt == np.int32
                if not exact and dt == np.uint32:
                    exact = label_patch.max(initial=0) < 2**31
                label = (
                    label_patch.astype(np.int32)
                    if exact
                    else compact_labels(
                        label_patch, min_dtype=np.uint32
                    ).astype(np.int32)
                )
            raw, mn, inv = self.get_raw_input_patch(i, center)
            if self.wire_raw_images:
                return (
                    (
                        np.ascontiguousarray(raw, dtype=np.uint16),
                        np.array([mn, inv], np.float32),
                    ),
                    label,
                )
            return reconstruct_normalized(raw, mn, inv), label
        _, input_patch, label_patch = self.sample_patch()
        if self.transform:
            input_patch, label_patch = self.transform(
                input_patch, label_patch
            )
            input_patch = np.ascontiguousarray(input_patch)
            label_patch = np.ascontiguousarray(label_patch)
        return input_patch.astype(np.float32), self._target(label_patch)

    def sample_patch(self):
        """85% foreground-biased rejection sampling (reference :259-292)."""
        i, center, label_patch = self._sample_location()
        return i, self.get_input_patch(i, center), label_patch

    def _sample_location(self):
        """The rejection-sampling loop of :meth:`sample_patch`, without
        materializing the normalized input patch (the raw-wire path
        normalizes on device instead)."""
        is_foreground = self.np_rng.random() > 0.15
        i = int(
            self.np_rng.choice(np.arange(len(self.input_imgs)), p=self.wgts)
        )
        center = None
        label_patch = None
        for _ in range(25):
            center = self.sample_center(self._volume_shape(i))
            label_patch = self.get_label_patch(i, center)
            fg = (label_patch > 0).sum()
            # Reference acceptance (data_handling.py:284-288): exactly
            # 10^3 foreground voxels satisfies NEITHER branch -> resample.
            if fg > FOREGROUND_MIN_VOXELS and is_foreground:
                break
            if fg < FOREGROUND_MIN_VOXELS and not is_foreground:
                break
        return i, center, label_patch

    def reseed_worker(self, worker_id, draw_round=0):
        """Re-key every RNG stream for one forked sampler worker.

        Called inside worker ``worker_id`` of the multi-process
        prefetcher (:func:`_prefetch_batches_mp`): forked children
        inherit IDENTICAL RNG state, so without this every worker would
        draw the same patches. Derivation is a
        ``SeedSequence([base, draw_round, worker_id])`` spawn per
        stream (np_rng / center rng / transform rng), where ``base`` is
        the constructor seed (reproducible across runs) or the captured
        OS entropy (independent, unseeded case) -- the torch
        DataLoader worker_init_fn contract.
        """
        base = (
            self._sampler_seed
            if self._sampler_seed is not None
            else self._worker_entropy
        )
        # SeedSequence rejects negative entropy (as does the
        # constructor's default_rng, so no valid dataset carries a
        # negative seed) -- the mask is belt-and-braces for any future
        # seed pathway.
        ss = np.random.SeedSequence([int(base) & ((1 << 63) - 1),
                                     int(draw_round), int(worker_id)])
        np_ss, center_ss, transform_ss = ss.spawn(3)
        self.np_rng = np.random.default_rng(np_ss)
        self.rng = _random.Random(
            int.from_bytes(center_ss.generate_state(4).tobytes(), "little")
        )
        if isinstance(self.transform, ImageTransforms):
            self.transform.rng = np.random.default_rng(transform_ss)

    def sample_center(self, shape):
        """Uniform center in the patch-fitting interior (reference :294).

        Deliberate deviation (reference bug, :309): the reference's
        inclusive ``randint(s//2, d - s//2)`` lets ODD patch shapes
        overhang the volume by one plane (numpy clips -> ragged
        batches). The upper bound here subtracts the ceil half
        (``s - s//2``) instead, which is identical for the even shapes
        the reference uses and in-bounds for odd ones.
        """
        lower = [s // 2 for s in self.patch_shape]
        upper = [
            d - (s - s // 2) for d, s in zip(shape, self.patch_shape)
        ]
        return np.array(
            [self.rng.randint(lo, hi) for lo, hi in zip(lower, upper)]
        )


class ValidateDataset(BaseDataset):
    """Deterministic grid-of-centers validation set (reference :314-458)."""

    def __init__(
        self,
        input_img_paths,
        label_mask_paths,
        affinity_mode=True,
        brightness_clip=300,
        normalization_percentiles=(1, 99.9),
        patch_shape=(96, 96, 96),
        containment_buffer=64,
        seed=0,
    ):
        super().__init__(
            input_img_paths,
            label_mask_paths,
            affinity_mode=affinity_mode,
            brightness_clip=brightness_clip,
            normalization_percentiles=normalization_percentiles,
            patch_shape=patch_shape,
        )
        self.containment_buffer = containment_buffer
        self.rng = _random.Random(seed)
        self.example_ids = self.generate_examples()

    def generate_examples(self):
        """All foreground examples + random 25%-count background sample."""
        foreground, background = [], []
        for i in range(len(self.input_imgs)):
            fg, bg = self.generate_examples_from_img(i)
            foreground.extend(fg)
            background.extend(bg)
        n_bg = min(int(len(foreground) * 0.25), len(background))
        return foreground + self.rng.sample(background, n_bg)

    def generate_examples_from_img(self, i):
        """Non-overlapping grid, interior-contained centers (ref :400-430)."""
        shape = self._volume_shape(i)
        foreground, background = [], []
        for start in generate_patch_starts(
            shape, self.patch_shape, (0, 0, 0)
        ):
            center = [
                s + p // 2 for s, p in zip(start, self.patch_shape)
            ]
            if not is_contained(
                center, shape, buffer=self.containment_buffer
            ):
                continue
            # The patch itself must fit (a small containment buffer on a
            # non-grid-aligned volume would otherwise admit overhanging
            # centers whose clipped patches break batching).
            if not all(
                c - p // 2 >= 0 and c - p // 2 + p <= d
                for c, p, d in zip(center, self.patch_shape, shape)
            ):
                continue
            patch = self.get_patch(self.label_masks[i], center)
            if (patch > 0).sum() > FOREGROUND_MIN_VOXELS:
                foreground.append((i, center))
            else:
                background.append((i, center))
        return foreground, background

    def __len__(self):
        return len(self.example_ids)

    def __getitem__(self, idx):
        i, center = self.example_ids[idx]
        input_patch = self.get_input_patch(i, center)
        label_patch = self.get_label_patch(i, center)
        return input_patch, self._target(label_patch)


def _stack_items(items):
    """Stack a list of (x, y) examples into one (xs, ys) batch."""
    if isinstance(items[0][0], tuple):
        # raw-wire examples: x is (u16 patch, f32 [mn, inv]) --
        # stack each component into its own batch array
        xs = tuple(
            np.stack([it[0][k] for it in items])
            for k in range(len(items[0][0]))
        )
    else:
        xs = np.stack([it[0] for it in items])
    ys = np.stack([it[1] for it in items])
    return xs, ys


def iterate_batches(dataset, batch_size, stacked=True):
    """Yield (inputs, targets) numpy batches from an indexable dataset.

    Replaces the reference's torch DataLoader (train.py:103-106: no
    shuffle, no workers).
    """
    n = len(dataset)
    for lo in range(0, n, batch_size):
        items = [dataset[j] for j in range(lo, min(lo + batch_size, n))]
        if not stacked:
            yield items
            continue
        yield _stack_items(items)


def prefetch_batches(dataset, batch_size, depth=2, num_workers=0):
    """:func:`iterate_batches` with background batch production.

    Patch sampling + host augmentation overlap the (async-dispatched)
    device step instead of serializing with it -- the role of the torch
    DataLoader's worker processes (reference train.py:103-106).

    * ``num_workers=0`` (default): ONE producer thread. Yields the same
      batches in the same order as ``iterate_batches`` -- bit-identical
      RNG streams -- because patch assembly is numpy-bound and a single
      producer suffices to hide it behind the device step on this
      class of host. A bounded queue (``depth``) caps host memory at
      depth+1 batches.
    * ``num_workers>0``: a FORKED PROCESS POOL (GIL-free sampling for
      multi-core hosts; see :func:`_prefetch_batches_mp`). Batch ``b``
      is produced by worker ``b % num_workers``; index-deterministic
      datasets (ValidateDataset) yield bit-identical batches, while
      draw-based samplers (TrainDataset) follow per-worker seeded RNG
      streams -- deterministic given (seed, num_workers, epoch) but a
      DIFFERENT stream than ``num_workers=0`` (the same contract as the
      torch DataLoader's worker_init_fn seeding).

    The consumer must drain the generator or call ``.close()`` (the
    producer thread is daemonic and worker processes are terminated on
    close, so an abandoned generator cannot hang interpreter exit).
    """
    if num_workers:
        yield from _prefetch_batches_mp(
            dataset, batch_size, depth, num_workers
        )
        return

    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()

    def produce():
        try:
            for batch in iterate_batches(dataset, batch_size):
                q.put(batch)
            q.put(_END)
        except BaseException as err:  # surfaced on the consumer side
            q.put(err)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
    thread.join()


def _prefetch_batches_mp(dataset, batch_size, depth, num_workers):
    """Multi-process sampler fan-out behind :func:`prefetch_batches`.

    Forked workers (volumes are shared copy-on-write -- no pickling of
    the dataset) each own the batches ``b % num_workers == w`` and push
    them in order onto a PER-WORKER bounded queue; the consumer cycles
    the queues in batch order, so ordering is strict, memory is capped
    at ``num_workers * depth`` buffered batches, and backpressure is
    natural. TrainDataset workers re-seed per (seed, draw-round,
    worker) via :meth:`TrainDataset.reseed_worker`, so streams are
    reproducible across runs and distinct across epochs.

    The sticky label-wire dtype (:attr:`BaseDataset._label_wire_dtype`)
    is harmonized on the consumer side: worker promotion to uint32 is
    per-process, so once any yielded batch is wider the consumer
    upcasts every later batch (and writes the promotion back to the
    parent dataset so the next epoch's fork inherits it) -- the batch
    dtype flips AT MOST once, exactly as in-process.

    Fork, not spawn: the children share the volumes copy-on-write
    instead of unpickling them, and follow the same per-worker streams
    as the JAX package's pool. Forking a parent that runs threads (CUDA,
    torch's pools) is safe HERE because workers only run numpy and the
    port's native library, never torch -- the posture of the torch
    DataLoader's forked workers.
    """
    import multiprocessing as _mp
    import queue as _queue

    ctx = _mp.get_context("fork")
    n = len(dataset)
    n_batches = (n + batch_size - 1) // batch_size
    if n_batches == 0:
        return
    num_workers = min(num_workers, n_batches)
    # Per-epoch draw round (bumped in the PARENT before forking) keeps
    # worker streams distinct across epochs while staying reproducible.
    draw_round = getattr(dataset, "_sampler_draw_round", 0)
    reseedable = hasattr(dataset, "reseed_worker")
    if reseedable:
        dataset._sampler_draw_round = draw_round + 1

    queues = [ctx.Queue(maxsize=max(1, depth)) for _ in range(num_workers)]

    def produce(w, q):
        try:
            if reseedable:
                dataset.reseed_worker(w, draw_round)
            for b in range(w, n_batches, num_workers):
                lo = b * batch_size
                items = [
                    dataset[j] for j in range(lo, min(lo + batch_size, n))
                ]
                q.put(("ok", _stack_items(items)))
        except BaseException as err:
            # Queue.put pickles in a FEEDER THREAD, not at the call
            # site: an unpicklable payload would be silently dropped
            # there and the consumer would only see a generic
            # worker-death timeout. Pre-check picklability so the real
            # error (at worst its repr) always crosses the pipe.
            import pickle

            try:
                pickle.dumps(err)
            except Exception:
                err = RuntimeError(repr(err))
            q.put(("err", err))

    procs = [
        ctx.Process(target=produce, args=(w, queues[w]), daemon=True)
        for w in range(num_workers)
    ]
    for p in procs:
        p.start()

    wire = bool(getattr(dataset, "wire_labels", False))
    sticky = None
    try:
        for b in range(n_batches):
            w = b % num_workers
            q, p = queues[w], procs[w]
            dead_retries = 0
            while True:
                try:
                    tag, payload = q.get(timeout=5.0)
                    break
                except _queue.Empty:
                    if not p.is_alive():
                        # One grace retry: the feeder thread may still
                        # be flushing the pipe after a clean exit.
                        dead_retries += 1
                        if dead_retries > 1:
                            raise RuntimeError(
                                f"sampler worker {w} died (exitcode "
                                f"{p.exitcode}) before producing batch "
                                f"{b}"
                            ) from None
            if tag == "err":
                raise payload
            xs, ys = payload
            if wire and isinstance(ys, np.ndarray) and ys.dtype.kind == "u":
                if sticky is None:
                    sticky = np.dtype(dataset._label_wire_dtype)
                if ys.dtype.itemsize > sticky.itemsize:
                    sticky = ys.dtype
                    dataset._label_wire_dtype = ys.dtype.type
                elif ys.dtype != sticky:
                    ys = ys.astype(sticky)
            yield xs, ys
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for q in queues:
            q.close()
            q.cancel_join_thread()
        for p in procs:
            p.join(timeout=5.0)
