"""The Swin UNETR's analytic counts against a walk of the port's
full-width model on the ``meta`` device (shapes only, no arithmetic)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from aind_exaspim_neuron_segmentation_tpu_torch.models.swin_unetr import (
    SwinUNETR,
)
from benchmark import harness
from benchmark.counts import swinunetr as counts

PATCH = 96


class Shapes(TorchDispatchMode):
    """Records every convolution and matrix product the forward calls."""

    def __init__(self):
        super().__init__()
        self.convs, self.mms = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "convolution":
            self.convs.append((tuple(args[0].shape), tuple(args[1].shape),
                               tuple(out.shape), bool(args[6]),
                               args[2] is not None))
        elif name in ("mm", "addmm"):
            a, b = args[-2], args[-1]
            self.mms.append((a.shape[0], a.shape[1], b.shape[1],
                             name == "addmm"))
        return out


def _walk(batch=1):
    model = SwinUNETR().to("meta")
    x = torch.empty(batch, 1, PATCH, PATCH, PATCH, device="meta")
    with Shapes() as seen, torch.no_grad():
        model(x, valid_trim=8)
    return seen


def test_published_geometry():
    """Stage maps 48, 24, 12, 6; windows padded to 49, 28, 14 (stage 4's
    window clipped to its 6^3 map, unshifted); 343, 64, 8, 1 windows."""
    rows = counts.stages(PATCH)
    assert [s["side"] for s in rows] == [48, 24, 12, 6]
    assert [s["padded"] for s in rows] == [49, 28, 14, 6]
    assert [s["windows"] for s in rows] == [343, 64, 8, 1]
    assert [s["tokens"] for s in rows] == [343, 343, 343, 216]
    assert [s["shift"] for s in rows] == [3, 3, 3, 0]
    assert [s["channels"] // s["heads"] for s in rows] == [16] * 4


def test_forward_flops_match_flop_counter():
    model = SwinUNETR().to("meta")
    x = torch.empty(2, 1, PATCH, PATCH, PATCH, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, valid_trim=8)
    assert 2 * counts.forward_flops(PATCH) == fc.get_total_flops()


def test_conv_layers_match_a_walk():
    seen = _walk()
    layers = counts.conv_layers(PATCH)
    assert [(l["cin"], l["cout"], l["taps"], l["vin"], l["vout"],
             l["transposed"], l["bias"]) for l in layers] == [
        (w[0] if tr else w[1], w[1] if tr else w[0], int(np.prod(w[2:])),
         int(np.prod(i[2:])), int(np.prod(o[2:])), tr, bias)
        for i, w, o, tr, bias in seen.convs]
    batch = 2
    walked = sum(2 * (batch * np.prod(i[1:]) + np.prod(w)
                      + (w[1] if tr else w[0]) * bias
                      + batch * np.prod(o[1:]))
                 for i, w, o, tr, bias in seen.convs)
    assert counts.conv_bytes(layers, batch) == walked


def test_linear_layers_match_a_walk():
    seen = _walk()
    assert [(l["tokens"], l["fin"], l["fout"], l["bias"])
            for l in counts.linear_layers(PATCH)] == seen.mms


def test_attention_bytes_count_each_operand_once():
    batch = 16
    rows = counts.stages(PATCH)
    qkvo = sum(4 * batch * s["padded"] ** 3 * s["channels"] * 2
               * s["depth"] for s in rows)
    tables = sum(13 ** 3 * s["heads"] * 2 * s["depth"] for s in rows)
    ids = sum(4 * s["padded"] ** 3 for s in rows if s["shift"])
    assert counts.attention_bytes(PATCH, batch) == qkvo + tables + ids
    # the attention's least time is its bytes, not its FLOPs
    peaks = harness.load_json("counts", "peaks.json")["NVIDIA H100"]
    assert counts.attention_bytes(PATCH, batch) / peaks["hbm_bytes_s"] > \
        batch * counts.attention_flops(PATCH) / peaks["bf16_flops_s"]


@pytest.mark.parametrize("batch", [1, 16])
def test_window_count_matches_the_program_counter(batch):
    before = SwinUNETR.swin_windows
    model = SwinUNETR().to("meta")
    with torch.no_grad():
        model(torch.empty(batch, 1, PATCH, PATCH, PATCH, device="meta"))
    assert SwinUNETR.swin_windows - before == counts.attention_windows(
        PATCH, batch) == batch * 2 * (343 * 3 + 64 * 6 + 8 * 12 + 24)
