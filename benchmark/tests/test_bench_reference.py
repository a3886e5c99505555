"""The plain references against the port at width 0.25 and small sizes on
the CPU (the test imports both; the references import nothing of the
port)."""

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import normalize
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
    data_handling,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import UNet3D
from aind_exaspim_neuron_segmentation_tpu_torch.ops import augment_device
from benchmark import inputs, training
from benchmark.models import unet3d as arch
from benchmark.reference import predict as ref_predict
from benchmark.reference import train as ref_train
from benchmark.reference import unet3d as ref_unet

WIDTH = 0.25

@pytest.fixture(scope="module")
def block():
    return inputs.tube_volume(7, 0, 64, 3, 2, 120, 350)[0]

@pytest.fixture(scope="module")
def params(block):
    return arch.calibrated_weights(7, torch.device("cpu"), block,
                                   width=WIDTH)

def _port_model(params, train):
    model = UNet3D(output_channels=3, width_multiplier=WIDTH)
    sd = model.state_dict()
    sd.update({k: v for k, v in params.items()})
    model.load_state_dict(sd)
    return model.train(train)

@pytest.mark.parametrize("train", [False, True])
def test_unet_matches_the_port(params, train):
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 1, 32, 32, 32, generator=gen)
    p = {k: v.clone() for k, v in params.items()}
    with torch.no_grad():
        want = _port_model(params, train)(x)
        got = ref_unet.forward(p, x, train=train)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)

def test_calibrated_statistics_are_the_batch_statistics(params, block):
    # running_var is the unbiased variance of one train-mode forward
    assert all(float(params[k].min()) > 0 for k in params
               if k.endswith("running_var"))
    assert any(float(params[k].abs().max()) > 0 for k in params
               if k.endswith("running_mean"))

def test_normalize_matches_the_port(block):
    want = normalize(np.minimum(block, 1000)).astype(np.float32)
    got = ref_predict.normalize(block, 1000, (1, 99.9))
    np.testing.assert_array_equal(got, want)

def test_predict_matches_the_port(block, params):
    kw = dict(patch=(32,) * 3, overlap=(16,) * 3, trim=4, clip=1000,
              percentiles=(1, 99.9))
    runner = inference.load_model(
        arch.checkpoint(params), device="cpu",
        width_multiplier=WIDTH, fold_bn=False)
    want = inference.predict(block, runner, patch_shape=kw["patch"],
                             overlap=kw["overlap"], trim=4, batch_size=4,
                             verbose=False)
    got = ref_predict.predict(block, params, torch.device("cpu"),
                              arch.forward, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got == 0, want == 0)

def test_augmentation_matches_the_port():
    gen = torch.Generator().manual_seed(5)
    img = torch.rand(3, 1, 24, 20, 16, generator=gen)
    lab = torch.randint(0, 4, (3, 1, 24, 20, 16), generator=gen)
    key = (11, 2, 3)
    got = ref_train.augment(img, lab, ref_train.augment_generator(
        *key, torch.device("cpu")))
    params = augment_device.draw_augment_params(
        ref_train.augment_generator(*key, torch.device("cpu")), 3,
        img.shape[2:])
    want = augment_device.apply_augment(img, lab, params)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

def test_sampler_matches_the_port():
    pairs = [inputs.tube_volume(3, k, 64, 3, 3, 120, 350) for k in range(3)]
    imgs, labs = [p[0] for p in pairs], [p[1] for p in pairs]
    ds = data_handling.TrainDataset(imgs, labs, patch_shape=(32,) * 3,
                                    seed=9, return_label_patches=True)
    ds.wire_labels = ds.wire_raw_images = True
    want = [ds[i] for i in range(6)]
    got = ref_train.sample_items(imgs, labs, 9, 6, (32,) * 3, 300,
                                 (1, 99.9))
    for (xs, ys), (raw, scale, lab) in zip(want, got):
        np.testing.assert_array_equal(xs[0], raw)
        np.testing.assert_array_equal(xs[1], scale)
        assert training.partition_mismatch(ys, lab) == 0

def test_partition_mismatch_sees_a_merge():
    a = np.array([0, 1, 1, 2, 2])
    assert training.partition_mismatch(a, np.array([0, 5, 5, 9, 9])) == 0
    assert training.partition_mismatch(a, np.array([0, 5, 5, 5, 5])) == 1
    assert training.partition_mismatch(a, np.array([3, 5, 5, 9, 9])) == 1

def test_adamw_matches_torch():
    gen = torch.Generator().manual_seed(2)
    p = torch.randn(50, generator=gen)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.AdamW([q], lr=1e-3, weight_decay=0.01)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    for t in range(1, 4):
        g = torch.randn(50, generator=gen)
        q.grad = g.clone()
        opt.step()
        ref_train.adamw_(p, g, m, v, t)
    torch.testing.assert_close(p, q.detach(), rtol=0, atol=1e-7)

def test_sample_items_is_deterministic():
    pairs = [inputs.tube_volume(4, k, 64, 3, 3, 120, 350) for k in range(2)]
    imgs, labs = [p[0] for p in pairs], [p[1] for p in pairs]
    a = ref_train.sample_items(imgs, labs, 2, 3, (32,) * 3, 300, (1, 99.9))
    b = ref_train.sample_items(imgs, labs, 2, 3, (32,) * 3, 300, (1, 99.9))
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
