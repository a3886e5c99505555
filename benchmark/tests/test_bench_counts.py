"""The analytic counts against a walk of the port's full-width model on
the ``meta`` device (shapes only, no arithmetic)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import UNet3D
from benchmark.counts import unet3d as counts

PATCH = 96


class Shapes(TorchDispatchMode):
    """Records the shapes of every convolution and BatchNorm call."""

    def __init__(self):
        super().__init__()
        self.convs, self.norms = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name == "convolution":
            self.convs.append((tuple(args[0].shape), tuple(args[1].shape),
                               tuple(out.shape)))
        elif "batch_norm" in name and "backward" not in name:
            self.norms.append(tuple(args[0].shape))
        return out


def _forward(trim, batch=1, train=False):
    model = UNet3D(output_channels=3, fused_bn=not train).to("meta")
    model.train(train)
    x = torch.empty(batch, 1, PATCH, PATCH, PATCH, device="meta")
    return model, x


@pytest.mark.parametrize("trim", [0, 8])
def test_forward_flops_match_flop_counter(trim):
    model, x = _forward(trim)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x, valid_trim=trim)
    assert counts.forward_flops(counts.conv_layers(PATCH, trim)) \
        == fc.get_total_flops()


def test_train_flops_match_flop_counter():
    model, x = _forward(0, batch=2, train=True)
    with FlopCounterMode(display=False) as fc:
        model(x).sum().backward()
    per_patch = counts.conv_train_flops(counts.conv_layers(PATCH, 0))
    assert 2 * per_patch == fc.get_total_flops()


@pytest.mark.parametrize("trim", [0, 8])
def test_conv_bytes_match_a_walk(trim):
    batch = 2
    model, x = _forward(trim, batch)
    with Shapes() as seen, torch.no_grad():
        model(x, valid_trim=trim)
    walked = sum(2 * (np.prod(i) + np.prod(w) + w[0] + np.prod(o))
                 for i, w, o in seen.convs)
    assert counts.conv_bytes(counts.conv_layers(PATCH, trim), batch) \
        == walked
    layers = counts.conv_layers(PATCH, trim)
    assert [(l["cin"], l["cout"]) for l in layers] == [
        (w[1], w[0]) for _, w, _ in seen.convs]


def test_batchnorm_bytes_match_a_walk():
    batch = 2
    model, x = _forward(0, batch, train=True)
    with Shapes() as seen:
        model(x)
    assert counts.batchnorm_bytes(counts.conv_layers(PATCH, 0), batch) \
        == 5 * 2 * sum(int(np.prod(s)) for s in seen.norms)


def test_train_bytes_count_each_gradient_once():
    layers = counts.conv_layers(PATCH, 0)
    fwd = counts.conv_bytes(layers, 4)
    # the data gradient mirrors the forward's bytes but for the first
    # conv; the weight gradient reads dy and x and writes dw
    first = layers[0]
    first_fwd = 2 * (4 * first["vin"] + 28 * first["cout"]
                     + 4 * first["cout"] * first["vout"])
    assert counts.conv_bytes(layers, 4, train=True) == 3 * fwd - first_fwd


def test_k1_bytes_count_the_union_once():
    starts = np.array([[0, 0, 0], [0, 0, 64]])
    got = counts.k1_launch_bytes((3, 96, 96, 160), (80, 80, 80), starts, 8)
    union = 80 * 80 * (64 + 80)
    assert got == 2 * 3 * 80 ** 3 * 4 + 2 * union * 3 * 4
