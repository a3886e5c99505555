"""The port's spans (``utils.profiling.annotate``) and the benchmark's
readers of them, on the CPU.

``inference.predict`` marks each Z slab's ``predict.normalize``,
``predict.pad`` and ``predict.upload``, and each streamed chunk's
``predict.copy_out``;
``Trainer.train_batch`` each step's ``train.input``, ``train.forward``
and ``train.backward``; ``StageTimer`` stages are spans of their own
names. The benchmark's span readers (``benchmark/spans.py`` and the
``metrics/`` files that use it) run on a hand-built trace whose answers
are known.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aind_exaspim_neuron_segmentation_tpu_torch import inference, io
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_grid_ranges,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import write_zarr
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import train
from aind_exaspim_neuron_segmentation_tpu_torch.ops import stitch
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    StageTimer,
    annotate,
)
from benchmark import harness
from benchmark.trace import Trace
from tests.test_torch_gpu import box_batch

PREDICT_SPANS = ("predict.normalize", "predict.pad", "predict.upload",
                 "predict.copy_out")
TRAIN_SPANS = ("train.input", "train.forward", "train.backward")
PKW = dict(patch_shape=(32, 32, 32), overlap=(16, 16, 16), trim=4,
           batch_size=2, verbose=False)


def _host_spans(prof, names):
    """``[(start, end, name), ...]`` of the profile's host events named in
    ``names``, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name in names)


@pytest.fixture(scope="module")
def runner():
    return inference.load_model(device="cpu", width_multiplier=0.25)


@pytest.fixture(scope="module")
def vol():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 300, (40, 36, 32)).astype(np.uint16)
    v[10:30, 12:24, 8:24] += 900
    return v


# the batch (one a patch row) after whose queueing each streamed chunk
# is fetched, by slab count: one slab of rows [0, 1] streams a chunk a
# row, both fetched after its last batch; two slabs, rows [0] then
# [0, 1] (the recomputed row 0 makes no chunk), stream one chunk each,
# the first slab's fetched after the second slab's last batch
FETCHED_AFTER = {1: [1, 1], 2: [2, 2]}


@pytest.mark.parametrize("lazy", [False, True], ids=["memory", "lazy"])
@pytest.mark.parametrize("slabs", [1, 2])
def test_predict_spans_once_per_slab_in_order(runner, vol, tmp_path, lazy,
                                              slabs, monkeypatch):
    """The prep spans once a slab, in order; ``predict.copy_out`` once a
    streamed chunk, each after the next slab's batches (the last slab's:
    its own) are queued (each batch marked by a span around its K1
    scatter)."""
    rows = len(patch_grid_ranges(vol.shape, PKW["patch_shape"],
                                 PKW["overlap"])[0])
    assert rows == 2
    src = vol
    if lazy:
        write_zarr(str(tmp_path / "v.zarr"), vol, chunks=(8, 8, 8))
        src = io.read(str(tmp_path / "v.zarr"))
    scatter = stitch.scatter_batch

    def marked_scatter(*args, **kwargs):
        with annotate("batch.scatter"):
            return scatter(*args, **kwargs)

    monkeypatch.setattr(stitch, "scatter_batch", marked_scatter)
    kw = dict(PKW, max_slab_rows=rows // slabs)
    before = inference.predict.copy_out_chunks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("call"):
            got = inference.predict(src, runner, **kw)
    chunks = inference.predict.copy_out_chunks - before
    assert chunks == len(FETCHED_AFTER[slabs])
    np.testing.assert_array_equal(got, inference.predict(vol, runner, **kw))
    (call,) = _host_spans(prof, ("call",))
    spans = _host_spans(prof, PREDICT_SPANS)
    for name in PREDICT_SPANS:
        want = chunks if name == "predict.copy_out" else slabs
        assert [s[2] for s in spans].count(name) == want, name
    assert all(call[0] <= s <= e <= call[1] for s, e, _ in spans)
    by_name = {n: [s for s in spans if s[2] == n] for n in PREDICT_SPANS}
    # the in-memory uint16 volume is prepared on the device: its raw
    # upload comes first
    order = PREDICT_SPANS[:3] if lazy else (
        "predict.upload", "predict.normalize", "predict.pad")
    for k in range(slabs):
        slab = [by_name[n][k] for n in order]
        # each stage ends before the next of the slab begins
        assert all(a[1] <= b[0] for a, b in zip(slab, slab[1:])), slab
        if k:  # slab k is prepared before slab k - 1's chunk (here
            # chunk k - 1) is copied out
            assert by_name[order[2]][k][1] <= \
                by_name["predict.copy_out"][k - 1][0]
    batches = _host_spans(prof, ("batch.scatter",))
    assert len(batches) == FETCHED_AFTER[slabs][-1] + 1
    copies = by_name["predict.copy_out"]
    assert all(a[1] <= b[0] for a, b in zip(copies, copies[1:]))
    for copy, after in zip(copies, FETCHED_AFTER[slabs]):
        assert batches[after][1] <= copy[0]


def test_train_batch_spans_once_per_step(tmp_path):
    tr = train.Trainer(str(tmp_path), batch_size=2, width_multiplier=0.25,
                       prefetch=False, device_augment=True, device="cpu")
    steps = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for step in range(steps):
            tr.train_batch(*box_batch(40 + step), step=step)
    if tr.writer is not None:
        tr.writer.close()
    names = TRAIN_SPANS + ("Optimizer.step#AdamW.step",)
    spans = _host_spans(prof, names)
    assert [s[2] for s in spans] == list(names) * steps
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_stage_timer_stages_are_spans():
    timer = StageTimer(sync=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("load"):
            with timer.stage("forward"):
                torch.ones(4).sum()
        with pytest.raises(RuntimeError):
            with timer.stage("forward"):
                raise RuntimeError("stage failed")
    spans = _host_spans(prof, ("load", "forward"))
    assert [s[2] for s in spans] == ["load", "forward", "forward"]
    load, inner, _ = spans
    assert load[0] <= inner[0] <= inner[1] <= load[1]
    assert timer.counts == {"load": 1, "forward": 2}
    assert set(timer.as_dict()) == {"load", "forward"}


# --- the benchmark's span readers on a hand-built trace -------------------


def _trace(device, host, start=0.0, end=1000.0):
    """A :class:`Trace` of the window ``[start, end]`` (us) holding the
    given ``device`` activities and window-thread ``host`` events."""
    t = Trace.__new__(Trace)
    t.start_us, t.end_us, t.thread = start, end, 1
    t.device, t.host, t._union = device, host, None
    return t


def _read(metric, rec):
    return harness.load_module("metrics", metric + ".py").read(rec)


# the device busy on [60, 70], [120, 200] and [300, 700]; the host in
# predict's spans, the last running past the window's end
PREDICT_TRACE = dict(
    device=[(60.0, 70.0, "kernel_n", ["aten::copy_"]),
            (120.0, 200.0, "kernel_a", ["aten::conv3d"]),
            (300.0, 700.0, "kernel_b", ["aten::conv3d"])],
    host=[(-50.0, 80.0, "predict.normalize"), (80.0, 100.0, "predict.pad"),
          (100.0, 150.0, "predict.upload"), (150.0, 690.0, "python"),
          (690.0, 1200.0, "predict.copy_out"),
          (700.0, 800.0, "aten::copy_")])

# per step of two: 5 ms input, 20 ms forward, 5 + 40 ms backward (the
# second linked only through the autograd engine's op), 2.5 ms optimizer,
# and 1 ms under no program span
TRAIN_TRACE = dict(
    device=[(0.0, 1e4, "k_in", ["aten::to", "train.input",
                                "bench.train_batch"]),
            (1e4, 5e4, "k_fwd", ["aten::cudnn_convolution", "aten::conv3d",
                                 "train.forward", "bench.train_batch"]),
            (5e4, 6e4, "k_seed", ["aten::ones_like", "train.backward",
                                  "bench.train_batch"]),
            (6e4, 14e4, "k_bwd", [
                "aten::convolution_backward",
                "autograd::engine::evaluate_function: "
                "ConvolutionBackward0"]),
            (14e4, 14.5e4, "k_opt", ["aten::_foreach_add_",
                                     "Optimizer.step#AdamW.step",
                                     "bench.train_batch"]),
            (14.5e4, 14.7e4, "k_metric", ["aten::mean",
                                          "bench.train_batch"])],
    host=[(0.0, 1e3, "train.input"), (1e3, 3e3, "train.forward"),
          (3e3, 4e3, "train.backward")],
    end=2e5)


@pytest.mark.parametrize("metric,want", [
    ("idle_prep.predict", 9.0),        # [0, 100) less [60, 70), of 1000
    ("idle_upload.predict", 2.0),      # [100, 120)
    ("idle_copy_out.predict", 30.0),   # [700, 1000)
])
def test_predict_idle_readers(metric, want):
    t = _trace(**PREDICT_TRACE)
    assert _read(metric, {"trace": t}) == pytest.approx(want)
    # they split the idle share, which is 51 % here
    assert 100.0 * (1 - t.busy_s / t.window_s) == pytest.approx(51.0)


@pytest.mark.parametrize("metric,want", [
    ("input_device_ms.train", 5.0),
    ("forward_device_ms.train", 20.0),
    ("backward_device_ms.train", 45.0),
    ("optimizer_device_ms.train", 2.5),
])
def test_train_device_readers(metric, want):
    rec = {"trace": _trace(**TRAIN_TRACE), "counters": {"steps": 2}}
    assert _read(metric, rec) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "idle_prep.predict", "idle_upload.predict", "idle_copy_out.predict",
    "input_device_ms.train", "forward_device_ms.train",
    "backward_device_ms.train", "optimizer_device_ms.train"])
def test_readers_return_none_without_trace_or_spans(metric):
    steps = {"steps": 2}
    assert _read(metric, {"trace": None, "counters": steps}) is None
    idle = _trace([], [(0.0, 1000.0, "predict.normalize"),
                       (0.0, 1000.0, "train.input")])
    assert _read(metric, {"trace": idle, "counters": steps}) is None
    # a program without the spans: the device ran, the host marked nothing
    bare = dict(PREDICT_TRACE if metric.endswith(".predict")
                else TRAIN_TRACE)
    bare["host"] = [h for h in bare["host"]
                    if not h[2].startswith(("predict.", "train."))]
    got = _read(metric, {"trace": _trace(**bare), "counters": steps})
    if metric == "optimizer_device_ms.train":  # torch's own annotation
        assert got == pytest.approx(2.5)
    else:
        assert got is None
