"""MedNeXt's analytic counts against a walk of the port's full-width model
on the ``meta`` device (shapes only, no arithmetic), and the cell's
readers on a hand-built trace."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from aind_exaspim_neuron_segmentation_tpu_torch.models import mednext
from aind_exaspim_neuron_segmentation_tpu_torch.models.mednext import MedNeXt
from benchmark import harness
from benchmark.counts import mednext as counts
from benchmark.trace import Trace

PATCH = 128
BATCH = 9
CELL = "mednext_predict_ram_256"


class Convs(TorchDispatchMode):
    """Records every convolution the forward calls: input, weight and
    output shapes, whether transposed, the groups, and whether it has a
    bias."""

    def __init__(self):
        super().__init__()
        self.convs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ == "convolution":
            self.convs.append((tuple(args[0].shape), tuple(args[1].shape),
                               tuple(out.shape), bool(args[6]), args[8],
                               args[2] is not None))
        return out


@pytest.fixture
def plain_routes(monkeypatch):
    """torch's own depthwise convs in the place of the program's routes
    (``ops/depthwise.py``), so the walk sees the model's convs."""
    monkeypatch.setattr(
        mednext, "depthwise_conv3d", lambda x, w, b: F.conv3d(
            x, w, b, padding=w.shape[-1] // 2, groups=x.shape[1]))
    monkeypatch.setattr(
        mednext, "depthwise_conv_transpose3d",
        lambda x, w, b: F.conv_transpose3d(
            x, w, b, stride=2, padding=w.shape[-1] // 2, groups=x.shape[1]))


def _walk(batch=1):
    model = MedNeXt().to("meta")
    x = torch.empty(batch, 1, PATCH, PATCH, PATCH, device="meta")
    with Convs() as seen, torch.no_grad():
        model(x, valid_trim=8)
    return seen.convs


def test_published_geometry():
    """62 blocks (54, 4 down, 4 up); maps 128, 64, 32, 16, 8; an up
    block's depthwise output 2n - 1 an axis; the widths 32 .. 512."""
    rows = counts.blocks(PATCH)
    modes = [b["mode"] for b in rows]
    assert len(rows) == 62 and modes.count("down") == modes.count("up") == 4
    assert [round(b["vin"] ** (1 / 3)) for b in rows if b["mode"] == "down"] \
        == [128, 64, 32, 16]
    ups = [b for b in rows if b["mode"] == "up"]
    assert [round(b["vmid"] ** (1 / 3)) for b in ups] == [15, 31, 63, 127]
    assert [(b["cin"], b["cout"], b["ratio"]) for b in ups] == [
        (512, 256, 8), (256, 128, 8), (128, 64, 4), (64, 32, 3)]
    assert sorted({b["cin"] for b in rows}) == [32, 64, 128, 256, 512]
    assert counts.block_patches(BATCH) == 62 * BATCH


def test_conv_layers_match_a_walk(plain_routes):
    seen = _walk()
    layers = counts.conv_layers(PATCH)
    assert [(l["cin"], l["cout"], l["taps"], l["vin"], l["vout"],
             l["transposed"], l["groups"]) for l in layers] == [
        (i[1], o[1], int(np.prod(w[2:])), int(np.prod(i[2:])),
         int(np.prod(o[2:])), tr, g) for i, w, o, tr, g, _ in seen]
    assert all(bias for *_, bias in seen)
    batch = 2
    walked = sum(2 * (batch * (np.prod(i[1:]) + np.prod(o[1:]))
                      + np.prod(w) + o[1])
                 for i, w, o, *_ in seen)
    assert counts.conv_bytes(layers, batch) == walked
    assert {l["role"] for l in layers} == {"stem", "dw", "mlp", "res", "out"}


def test_work_counts_read_each_operand_once(plain_routes):
    """Depthwise: the walked conv's input, output, weight and bias once.
    MLP: the block's C-wide input and output and both convs' weights,
    never the rC-wide hidden tensor. Norm: the map in and out once."""
    seen = _walk()
    roles = [l["role"] for l in counts.conv_layers(PATCH)]
    dws = [s for s, r in zip(seen, roles) if r == "dw"]
    mlp = [s for s, r in zip(seen, roles) if r == "mlp"]
    assert len(dws) == 62 and len(mlp) == 2 * 62
    assert all(s[4] == s[0][1] for s in dws)
    want = [(2 * BATCH * np.prod(w) * np.prod((i if tr else o)[2:]),
             2 * (BATCH * (np.prod(i[1:]) + np.prod(o[1:])) + np.prod(w)
                  + o[1]))
            for i, w, o, tr, _, _ in dws]
    assert counts.dwconv_work(PATCH, BATCH) == want
    got = counts.mlp_work(PATCH, BATCH)
    for (fl, nb), up, down in zip(got, mlp[0::2], mlp[1::2]):
        assert up[2] == down[0]  # the hidden tensor between the two convs
        hidden = BATCH * np.prod(up[2][1:]) * 2
        assert fl == 2 * BATCH * np.prod(up[2][2:]) * (
            np.prod(up[1]) + np.prod(down[1]))
        assert nb == 2 * (BATCH * (np.prod(up[0][1:]) + np.prod(down[2][1:]))
                          + np.prod(up[1]) + up[1][0] + np.prod(down[1])
                          + down[1][0])
        assert nb < hidden
    norms = counts.norm_work(PATCH, BATCH)
    assert norms == [(0, 2 * (2 * BATCH * np.prod(o[1:]) + 2 * o[1]))
                     for _, _, o, *_ in dws]


@pytest.mark.parametrize("batch", [1, BATCH])
def test_block_count_matches_the_program_counter(batch):
    before = MedNeXt.block_patches
    with torch.no_grad():
        MedNeXt().to("meta")(torch.empty(batch, 1, PATCH, PATCH, PATCH,
                                         device="meta"))
    assert MedNeXt.block_patches - before == counts.block_patches(batch) \
        == 62 * batch


def hand_record():
    """A traced record of the cell at its widths: 2 blocks of 3 batches,
    each batch one kernel under each of the three spans."""
    spec = harness.load_spec()
    cfg, traffic = harness.cell_inputs(spec, CELL)
    device, now = [], 1000.0
    took = {"mednext.dwconv": 300e3, "mednext.mlp": 150e3,
            "mednext.norm": 40e3}
    for _ in range(2 * 3):
        for span, us in took.items():
            device.append((now, now + us, "kernel", ["aten::op", span,
                                                     "mednext.encoder"]))
            now += us + 5.0
    t = Trace.__new__(Trace)
    t.start_us, t.end_us, t.thread = 0.0, now + 1000.0, 1
    t.device, t.host, t._union = device, [], None
    peaks = harness.load_json("counts", "peaks.json")["NVIDIA H100"]
    return dict(setup_s=20.0, window_s=t.window_s, work=2 * 256 ** 3,
                calls=2, cfg=cfg, traffic=traffic, trace=t, peaks=peaks,
                counters={"blocks": 2}), took, peaks


@pytest.mark.parametrize("metric,span,work", [
    ("dwconv_roofline.mednext", "mednext.dwconv", counts.dwconv_work),
    ("mlp_roofline.mednext", "mednext.mlp", counts.mlp_work),
    ("norm_roofline.mednext", "mednext.norm", counts.norm_work)])
def test_roofline_readers(metric, span, work):
    rec, took, peaks = hand_record()
    least = 6 * sum(max(f / peaks["bf16_flops_s"], b / peaks["hbm_bytes_s"])
                    for f, b in work(PATCH, BATCH))
    got = harness.load_module("metrics", metric + ".py").read(rec)
    assert got == pytest.approx(100 * least / (6 * took[span] / 1e6))
    rec["trace"].device = [d for d in rec["trace"].device
                           if span not in d[3]]
    assert harness.load_module("metrics", metric + ".py").read(rec) is None


def test_mfu_and_idle_readers():
    rec, took, peaks = hand_record()
    t = rec["trace"]
    mfu = harness.load_module("metrics", "mfu.mednext.py").read(rec)
    assert mfu == pytest.approx(100 * counts.forward_flops(PATCH) * 27 * 2
                                / t.window_s / peaks["bf16_flops_s"])
    idle = harness.load_module("metrics", "device_idle.mednext.py").read(rec)
    assert idle == pytest.approx(100 * (1 - 6 * sum(took.values()) / 1e6
                                        / t.window_s))
    rec["trace"] = None
    assert harness.load_module("metrics", "mfu.mednext.py").read(rec) is None
