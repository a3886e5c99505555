"""SegMamba's analytic counts against walks of the port's and the plain
reference's full-width models on the ``meta`` device (shapes only, no
arithmetic), and the cell's readers on a hand-built trace."""

import ast
import math
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from aind_exaspim_neuron_segmentation_tpu_torch.models.segmamba import (
    SegMamba,
)
from benchmark import harness
from benchmark.counts import segmamba as counts
from benchmark.reference import segmamba as ref
from benchmark.trace import Trace

PATCH = 128
BATCH = 9
CELL = "segmamba_predict_ram_256"
FLOPS = 2_894_365_458_432


class Ops(TorchDispatchMode):
    """Records every convolution (input, weight and output shapes, whether
    transposed, the groups) and every matrix product (the operands'
    shapes) the forward calls."""

    def __init__(self):
        super().__init__()
        self.convs, self.mms = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "convolution":
            self.convs.append((tuple(args[0].shape), tuple(args[1].shape),
                               tuple(out.shape), bool(args[6]), args[8]))
        elif name in ("mm", "addmm", "bmm"):
            self.mms.append(tuple(out.shape))
        return out


def _walk(model_fn):
    x = torch.empty(1, 1, PATCH, PATCH, PATCH, device="meta")
    with Ops() as seen, torch.no_grad():
        model_fn(x)
    return seen


def _port(x):
    return SegMamba().to("meta")(x)


def _reference(x):
    p = {k: torch.empty(s, device="meta")
         for k, s in ref.param_shapes().items()}
    return ref.forward(p, x)


@pytest.mark.parametrize("model_fn", [_port, _reference],
                         ids=["port", "reference"])
def test_flops_match_the_flop_counter_on_meta(model_fn):
    """2.894e12 a 128^3 patch, whichever model is walked."""
    x = torch.empty(1, 1, PATCH, PATCH, PATCH, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model_fn(x)
    assert counts.forward_flops(PATCH) == fc.get_total_flops() == FLOPS


def test_conv_layers_match_a_walk():
    """Every conv the port's forward runs, in order: shapes, taps,
    voxels, groups and transposition."""
    seen = _walk(_port).convs
    layers = counts.conv_layers(PATCH)
    assert [(l["cin"], l["cout"], l["taps"], l["vout"], l["transposed"],
             l["groups"]) for l in layers] == [
        (i[1], o[1], int(np.prod(w[2:])), int(np.prod(o[2:])), tr, g)
        for i, w, o, tr, g in seen]
    assert {l["role"] for l in layers} == {"stem", "down", "gsc", "conv1d",
                                           "mlp", "unetr", "out"}


def test_published_stages_and_scan_work():
    """Maps 64, 32, 16, 8 with 48 .. 384 channels, 2 layers each; the
    scan's minimal bytes ``xz`` in, ``y`` out and the weights, about
    0.40 GB a patch; 1,797,120 (token, direction) pairs."""
    st = counts.stages(PATCH)
    assert [(s["side"], s["channels"], s["rank"], s["layers"])
            for s in st] == [(64, 48, 3, 2), (32, 96, 6, 2),
                             (16, 192, 12, 2), (8, 384, 24, 2)]
    work = counts.scan_work(PATCH, BATCH)
    assert len(work) == 8
    maps = sum(2 * s["tokens"] * 3 * s["inner"] * 2 for s in st)
    weights = sum(2 * 3 * s["inner"] * (4 + 1 + s["rank"] + 32 + s["rank"]
                                        + 1 + 16 + 1) * 2 for s in st)
    assert sum(b for _, b in work) == BATCH * maps + weights
    assert 0.39e9 < maps < 0.41e9
    assert counts.scan_tokens(PATCH, BATCH) == BATCH * 1_797_120
    linears = [l for l in counts.linear_layers(PATCH)]
    assert len(linears) == 8 * (1 + 2 * 3 + 1)
    assert sum(1 for m in _walk(_port).mms) == len(linears)
    assert all(l["fout"] == 2 * 2 * l["fin"] for l in linears[::8])
    assert math.ceil(48 / 16) == linears[2]["fin"]


def hand_record():
    """A traced record of the cell at its widths: 2 blocks of 3 batches,
    each batch one kernel under the scan span inside the Mamba span and
    one under the decoder."""
    spec = harness.load_spec()
    cfg, traffic = harness.cell_inputs(spec, CELL)
    device, now = [], 1000.0
    took = {"scan": 40e3, "mamba": 15e3, "decoder": 250e3}
    stacks = {"scan": ["exaspim::selective_scan", "segmamba.scan",
                       "segmamba.mamba", "segmamba.encoder"],
              "mamba": ["aten::linear", "segmamba.mamba",
                        "segmamba.encoder"],
              "decoder": ["aten::conv3d", "segmamba.decoder"]}
    for _ in range(2 * 3):
        for part, us in took.items():
            device.append((now, now + us, "kernel", stacks[part]))
            now += us + 5.0
    t = Trace.__new__(Trace)
    t.start_us, t.end_us, t.thread = 0.0, now + 1000.0, 1
    t.device, t.host, t._union = device, [], None
    peaks = harness.load_json("counts", "peaks.json")["NVIDIA H100"]
    return dict(setup_s=20.0, window_s=t.window_s, work=2 * 256 ** 3,
                calls=2, cfg=cfg, traffic=traffic, trace=t, peaks=peaks,
                counters={"blocks": 2}), took, peaks


def _read(metric, rec):
    return harness.load_module("metrics", metric + ".py").read(rec)


def test_scan_roofline_reads_a_share_of_the_span():
    rec, took, peaks = hand_record()
    least = 6 * sum(max(f / peaks["bf16_flops_s"], b / peaks["hbm_bytes_s"])
                    for f, b in counts.scan_work(PATCH, BATCH))
    got = _read("scan_roofline.segmamba", rec)
    assert got == pytest.approx(100 * least / (6 * took["scan"] / 1e6))
    assert 0 < got <= 100
    rec["trace"].device = [d for d in rec["trace"].device
                           if "segmamba.scan" not in d[3]]
    assert _read("scan_roofline.segmamba", rec) is None


def test_mamba_mfu_and_idle_readers():
    rec, took, peaks = hand_record()
    t = rec["trace"]
    assert _read("mamba_device_ms.segmamba", rec) == pytest.approx(
        (took["scan"] + took["mamba"]) / 1e3)
    mfu = _read("mfu.segmamba", rec)
    assert mfu == pytest.approx(100 * FLOPS * 27 * 2 / t.window_s
                                / peaks["bf16_flops_s"])
    idle = _read("device_idle.segmamba", rec)
    assert idle == pytest.approx(100 * (1 - 6 * sum(took.values()) / 1e6
                                        / t.window_s))
    rec["trace"].device = [d for d in rec["trace"].device
                           if "segmamba.mamba" not in d[3]]
    assert _read("mamba_device_ms.segmamba", rec) is None
    rec["trace"] = None
    for metric in ("mfu.segmamba", "device_idle.segmamba",
                   "scan_roofline.segmamba", "mamba_device_ms.segmamba"):
        assert _read(metric, rec) is None


def test_the_reference_imports_nothing_of_the_port():
    path = os.path.join(harness.HERE, "reference", "segmamba.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert names and not [n for n in names if n.startswith(
        ("aind_exaspim_neuron_segmentation_tpu", "jax"))]
    assert all(n in ("math", "torch", "torch.nn.functional")
               or n.startswith("benchmark.reference.") for n in names)
