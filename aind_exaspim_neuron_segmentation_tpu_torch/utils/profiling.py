"""Tracing and per-stage timing: one kind of span, ``annotate(name)``.

A span is a :func:`torch.profiler.record_function`. With no profiler
running it costs a few microseconds, so the spans stay on; under
``torch.profiler.profile`` they land on the profiler's timeline, beside
the device's kernels and copies. The program's spans, and the benchmark
metric (``benchmark/metrics/``) that reads each:

* ``inference.predict``, once per Z slab, in order (the copy-out once per
  streamed chunk of Z planes):

  - ``predict.normalize``: the brightness clip and percentile normalize
    (the whole volume in memory at the first slab; a lazy volume's
    streaming percentile at the first slab, then each slab's read and
    scale) -- ``idle_prep.predict``;
  - ``predict.pad``: the reflect pad to the patch grid --
    ``idle_prep.predict``;
  - ``predict.upload``: the pinned copy and the queued host-to-device
    copy -- ``idle_upload.predict``;
  - ``predict.copy_out``: the wait for a chunk's device-to-host copy (a
    digest's: its slab's) and the host copy into the result (or the
    append to the Zarr writers) -- ``idle_copy_out.predict``; the counter
    ``predict.copy_out_chunks`` counts the float chunks -- the tests;

* ``models.swin_unetr.SwinUNETR``'s forward, once per batch of patches:

  - ``swin.encoder``: the patch embedding through the last patch
    merging and the stage outputs' layer norms -- none (it holds the two
    spans below);
  - ``swin.window``: the zero pad, the cyclic roll, the window partition
    and its reverse, the roll back and the crop (and each stage's region
    ids) -- none;
  - ``swin.attention``: the windowed attention core, from q, k and v to
    each window's output before ``proj`` (the bias and region mask
    built, the fused attention) -- ``attn_device_ms.swin`` and
    ``attn_roofline.swin``;
  - ``swin.decoder``: the UNETR residual blocks, up blocks and output
    conv -- none;
  - the counter ``SwinUNETR.swin_windows``, which the forward increments
    by the (window, head, patch) triples it attended -- the tests, against
    ``benchmark/counts/swinunetr.py``;

* ``models.mednext.MedNeXt``'s forward, once per batch of patches:

  - ``mednext.encoder``: the stem, the encoder stages, the down blocks and
    the bottleneck -- none (it holds the three spans below);
  - ``mednext.decoder``: the up blocks, the skip adds, the decoder stages
    and ``out_0`` -- none;
  - ``mednext.dwconv``: each block's depthwise conv (stride 1, stride 2
    or transposed: one launch of ``ops.depthwise``'s kernel on a card) --
    ``dwconv_roofline.mednext``;
  - ``mednext.norm``: each block's per-channel GroupNorm --
    ``norm_roofline.mednext``;
  - ``mednext.mlp``: each block's ``conv2 -> GELU -> conv3`` --
    ``mlp_roofline.mednext``;
  - the counter ``MedNeXt.block_patches``, which the forward increments
    by (blocks run) x (patches in the batch), 62 a patch at MedNeXt-L's
    block counts -- the tests, against ``benchmark/counts/mednext.py``;
  - the counter ``ops.depthwise.depthwise3d.launches``, which each launch
    of the depthwise kernel increments, 62 a MedNeXt-L forward on a card
    whatever the batch (none on the CPU) -- the card tests and
    ``chip_smoke.py``;

* ``models.segmamba.SegMamba``'s forward, once per batch of patches:

  - ``segmamba.encoder``: ``vit``, the downsamples, GSC blocks, Mamba
    layers and stage MLPs -- none (it holds the two spans below);
  - ``segmamba.decoder``: the UNETR blocks, up blocks and output conv --
    none;
  - ``segmamba.mamba``: each Mamba layer, from its LayerNorm to the
    residual add -- ``mamba_device_ms.segmamba``;
  - ``segmamba.scan``: each layer's three directions, from ``xz`` to the
    gated sum (the causal convs, ``x_proj``, the scans, the gate) --
    ``scan_roofline.segmamba``;
  - the counter ``SegMamba.scan_tokens``, which the forward increments
    by the (token, direction) pairs it scanned, 1,797,120 a 128^3 patch
    -- the tests, against ``benchmark/counts/segmamba.py``;
  - the counter ``ops.selective_scan.selective_scan.launches``, which
    each scan of a direction on a card increments (its chunk scan, carry
    and output kernels), 24 a SegMamba forward whatever the batch (none
    on the CPU) -- the card tests and ``chip_smoke.py``;

* ``models.unet3d.UNet3D``'s forward, once per batch of patches: the
  counter ``UNet3D.ndhwc_forwards``, which the forward increments when
  every conv took an NDHWC (channels-last) input, as on a card behind
  ``inference.load_model`` -- the tests (one a batch of ``predict``'s;
  none in training);

* ``Trainer.train_batch``, once per step:

  - ``train.input``: the upload, the augmentation and the targets --
    ``input_device_ms.train``;
  - ``train.forward``: the autocast forward and the loss --
    ``forward_device_ms.train``;
  - ``train.backward``: ``loss.backward()`` -- ``backward_device_ms.train``
    (on CUDA the autograd engine runs the backward on its own thread,
    under torch's ``autograd::engine::evaluate_function:`` ops);
  - the optimizer carries torch's own ``Optimizer.step#AdamW.step`` --
    ``optimizer_device_ms.train``;

* :class:`StageTimer` stages, under the names their tables print:
  ``parallel.predict_sharded``'s ``load_slabs``, ``normalize``,
  ``forward`` and ``fetch_assemble``, and ``examples.run_pipeline``'s.
  No benchmark cell reaches them.

To see the spans, wrap a call in ``torch.profiler.profile`` and export
its chrome trace (``prof.export_chrome_trace(path)``).
"""

import contextlib
import time
from collections import OrderedDict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def annotate(name):
    """Named span in the profiler timeline (``record_function``)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Accumulates wall-clock time per named stage; each stage is also an
    :func:`annotate` span of the same name.

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
        with annotate(name):
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
