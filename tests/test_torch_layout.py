"""The UNet3D laid out channels-last (NDHWC) against its NCDHW self, on the
CPU.

``inference.load_model`` lays a card's UNet3D out channels-last, so that
cuDNN's NDHWC conv kernels run with no transpose around them; the CPU
keeps NCDHW. Here a width-0.25 float32 model, BatchNorm folded and not, is
laid out both ways at 32^3: the same logits within float32 rounding, the
same checkpoint, and ``UNet3D.ndhwc_forwards`` counting only the NDHWC
forwards. The card's figures are in ``tests/test_torch_gpu.py``.
"""

import copy

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import train
from aind_exaspim_neuron_segmentation_tpu_torch.models.convert import (
    fold_batchnorm,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
    is_ndhwc,
)
from tests.test_torch_gpu import box_batch

WIDTH = 0.25
TRIMS = (0, 2, 4, 8)


def ncdhw_net(fused):
    """Seeded width-0.25 float32 UNet3D in eval mode, NCDHW; unfolded, its
    BatchNorms carry drawn running statistics."""
    net = UNet3D(output_channels=3, width_multiplier=WIDTH)
    init_weights(net, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.copy_(0.2 * torch.randn(
                    m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(
                    m.running_var.shape, generator=gen))
    if fused:
        state = fold_batchnorm(net.state_dict())
        net = UNet3D(output_channels=3, width_multiplier=WIDTH,
                     fused_bn=True)
        net.load_state_dict(state)
    return net.eval()


@pytest.fixture(scope="module", params=[False, True],
                ids=["bn", "folded"])
def nets(request):
    """(NCDHW net, the same net laid out channels-last)."""
    net = ncdhw_net(request.param)
    return net, copy.deepcopy(net).to(memory_format=torch.channels_last_3d)


@pytest.fixture(scope="module")
def patches():
    return torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32))


def conv_weights(net):
    """The 3^3 conv weights of more than one input channel: the stem's
    (one input channel) and ``outc``'s (1^3) lie both ways at once."""
    return [m.weight for m in net.modules()
            if isinstance(m, torch.nn.Conv3d)
            and m.weight.shape[1] > 1 and m.weight.shape[2] > 1]


def test_layout_is_the_weights_memory_format(nets):
    nc, cl = nets
    assert len(conv_weights(nc)) == 17
    assert not any(is_ndhwc(w) for w in conv_weights(nc))
    assert all(is_ndhwc(w) for w in conv_weights(cl))


@pytest.mark.parametrize("trim", TRIMS)
def test_ndhwc_forward_equals_ncdhw(nets, patches, trim):
    """Within MAE 1e-6 of the NCDHW forward, as the same logical NCDHW
    tensor, NCDHW in memory too; only the NDHWC forward is counted."""
    nc, cl = nets
    with torch.no_grad():
        before = UNet3D.ndhwc_forwards
        want = nc(patches, valid_trim=trim)
        assert UNet3D.ndhwc_forwards == before
        got = cl(patches, valid_trim=trim)
        assert UNet3D.ndhwc_forwards == before + 1
    assert got.shape == want.shape == (2, 3) + (32 - 2 * trim,) * 3
    assert got.dtype == want.dtype and got.is_contiguous()
    gap = (got - want).abs()
    assert float(gap.mean()) <= 1e-6, float(gap.mean())
    assert float(gap.max()) <= 1e-5, float(gap.max())


def test_ndhwc_state_dict_equals_ncdhw(nets):
    nc, cl = nets
    want, got = nc.state_dict(), cl.state_dict()
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        assert torch.equal(got[key], value), key


def test_ncdhw_runner_takes_an_ndhwc_checkpoint(nets, patches):
    """A checkpoint saved from the NDHWC module loads strictly into an
    NCDHW one and gives its logits bit for bit."""
    nc, cl = nets
    fresh = UNet3D(output_channels=3, width_multiplier=WIDTH,
                   fused_bn=nc.fused_bn)
    fresh.load_state_dict(cl.state_dict(), strict=True)
    with torch.no_grad():
        assert torch.equal(fresh.eval()(patches, valid_trim=4),
                           nc(patches, valid_trim=4))


def test_load_model_on_the_cpu_keeps_ncdhw(patches):
    runner = inference.load_model(device="cpu", width_multiplier=WIDTH)
    assert not any(is_ndhwc(w) for w in conv_weights(runner.module))
    before = UNet3D.ndhwc_forwards
    out = runner(patches)
    assert UNet3D.ndhwc_forwards == before
    assert out.shape == (2, 3, 32, 32, 32) and out.is_contiguous()


def test_train_batch_runs_ncdhw(tmp_path):
    """The Trainer builds its own NCDHW UNet3D: a step moves no NDHWC
    count."""
    tr = train.Trainer(str(tmp_path), batch_size=2, width_multiplier=WIDTH,
                       prefetch=False, device="cpu")
    before = UNet3D.ndhwc_forwards
    loss, _, _ = tr.train_batch(*box_batch(7))
    assert np.isfinite(float(loss))
    assert UNet3D.ndhwc_forwards == before
    assert not any(is_ndhwc(w) for w in conv_weights(tr.model))
