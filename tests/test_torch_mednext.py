"""The port's MedNeXt (``models/mednext.py``) on the CPU, float32.

Held to the plain reference of ``benchmark/reference/mednext.py`` on
seeded weights at MAE <= 1e-5 (the repo's parity bar) at a 32^3 patch,
``n_channels`` 4, block counts (1, 1, 2, 1, 1, 1, 2, 1, 1) and the
published ``exp_r``, at kernels 3 and 5: the whole forward and each kind
of block. The up block's one-voxel pad at the low end and the
per-channel GroupNorm are each knocked out of the port in turn, and
parity then fails. The plain version of ``ops/depthwise.py`` (the
kernel's CPU path) equals torch's own convs in each mode, and a CPU
forward never loads the kernel; ``load_model`` builds the model from a MedNeXt-keyed
checkpoint (strict, with or without ``dummy_tensor`` and the
deep-supervision heads) and still builds the UNet3D and the Swin UNETR,
bit for bit, from theirs; ``predict`` runs it against the reference's
patch loop; the counter and the FLOP count are held to
``benchmark/counts/mednext.py``.
"""

import io

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from aind_exaspim_neuron_segmentation_tpu_torch import cuda_build, inference
from aind_exaspim_neuron_segmentation_tpu_torch.models import mednext
from aind_exaspim_neuron_segmentation_tpu_torch.models.mednext import MedNeXt
from aind_exaspim_neuron_segmentation_tpu_torch.models.swin_unetr import (
    SwinUNETR,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import depthwise
from benchmark import inputs
from benchmark.counts import mednext as counts
from benchmark.models import mednext as arch
from benchmark.models import swinunetr as swin_arch
from benchmark.reference import mednext as ref
from benchmark.reference import predict as ref_predict

CPU = torch.device("cpu")
C = 4
COUNTS = (1, 1, 2, 1, 1, 1, 2, 1, 1)
EXP_R = (3, 4, 8, 8, 8, 8, 8, 4, 3)
PATCH = 32
SEED = 2**31 + 21


def _widths(k):
    return dict(n_channels=C, block_counts=COUNTS, kernel_size=k)


@pytest.fixture(scope="module", params=[3, 5], ids=["k3", "k5"])
def kernel(request):
    return request.param


@pytest.fixture(scope="module")
def params(kernel):
    """Seeded float32 weights by MedNeXt's key."""
    return arch.seeded_weights(SEED + kernel, CPU, **_widths(kernel))


@pytest.fixture(scope="module")
def runner(params):
    """The port's runner, built by ``load_model`` from the checkpoint."""
    return inference.load_model(arch.checkpoint(params), device="cpu",
                                dtype=torch.float32)


def _patches(n=2, seed=0, side=PATCH):
    img = inputs.tube_volume(seed, 0, 64, 3, 2, 120, 350)[0]
    img = ref_predict.normalize(img, 1000, (1, 99.9))
    return torch.from_numpy(np.stack(
        [img[16 * k:16 * k + side, :side, 8:8 + side]
         for k in range(n)])[:, None])


def _mae(a, b):
    return float((a.double() - b.double()).abs().mean())


def _map(channels, side, seed=3):
    gen = torch.Generator().manual_seed(seed)
    if isinstance(side, int):
        side = (side,) * 3
    return torch.randn((2, channels) + tuple(side), generator=gen)


@torch.no_grad()
def test_forward_matches_the_reference(runner, params):
    x = _patches()
    got = runner.module(x)
    want = ref.forward(params, x)
    assert got.shape == want.shape == (2, 3, PATCH, PATCH, PATCH)
    assert _mae(got, want) <= 1e-5


@pytest.mark.parametrize("name,mode,channels,side", [
    ("enc_block_0.0", "same", C, 32), ("bottleneck.0", "same", 16 * C, 2),
    ("dec_block_2.1", "same", 4 * C, 8), ("down_0", "down", C, 32),
    ("down_3", "down", 8 * C, 4), ("up_3", "up", 16 * C, 2),
    ("up_0", "up", 2 * C, 16)])
@torch.no_grad()
def test_each_block_matches_the_reference(runner, params, name, mode,
                                          channels, side):
    x = _map(channels, side)
    blk = runner.module.get_submodule(name)
    assert blk.mode == mode
    got, want = blk(x), ref.block(params, name + ".", x, mode)
    assert got.shape == want.shape
    scale = {"same": 1, "down": 0.5, "up": 2}[mode]
    assert got.shape[2:] == (int(side * scale),) * 3
    assert _mae(got, want) <= 1e-5


@pytest.mark.parametrize("side", [(4, 4, 4), (5, 5, 5), (3, 6, 5)],
                         ids=["even", "odd", "mixed"])
@pytest.mark.parametrize("pad", ["low", "high"])
@torch.no_grad()
def test_up_block_pad_is_at_the_low_end(runner, params, monkeypatch, side,
                                       pad):
    """An up block doubles each axis: the transposed conv gives 2n - 1
    and the pad one more at the low end. Padding at the high end instead
    keeps the shape and fails parity."""
    if pad == "high":
        monkeypatch.setattr(mednext, "LOW_PAD", (0, 1, 0, 1, 0, 1))
    x = _map(2 * C, side)
    got = runner.module.up_0(x)
    want = ref.block(params, "up_0.", x, "up")
    assert got.shape == want.shape == (2, C) + tuple(2 * s for s in side)
    gap = _mae(got, want)
    assert (gap <= 1e-5) if pad == "low" else (gap > 1e-3), gap


@pytest.mark.parametrize("norm", ["per_channel", "one_group", "no_affine"])
@torch.no_grad()
def test_group_norm_is_per_channel_and_affine(runner, params, norm):
    """``GroupNorm(C, C)`` with its scale and shift matches the written-out
    reference; one group over all channels, or no affine terms, does
    not."""
    blk = runner.module.get_submodule("enc_block_1.0")
    c = blk.norm.num_channels
    swap = {"per_channel": torch.nn.GroupNorm(c, c),
            "one_group": torch.nn.GroupNorm(1, c),
            "no_affine": torch.nn.GroupNorm(c, c, affine=False)}[norm]
    if swap.affine:
        swap.load_state_dict(blk.norm.state_dict())
    kept = blk.norm
    blk.norm = swap
    try:
        x = _map(c, 16)
        gap = _mae(blk(x), ref.block(params, "enc_block_1.0.", x))
    finally:
        blk.norm = kept
    assert (gap <= 1e-5) if norm == "per_channel" else (gap > 1e-3), gap


def _dw_case(k, shape):
    gen = torch.Generator().manual_seed(k)
    c = shape[1]
    return (torch.randn(shape, generator=gen),
            torch.randn((c, 1, k, k, k), generator=gen),
            torch.randn((c,), generator=gen))


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [(2, 3, 32, 8, 6), (1, 2, 48, 5, 7),
                                   (2, 3, 16, 9, 9)],
                         ids=["banded", "banded_3_tiles", "plain"])
@torch.no_grad()
def test_depthwise_route_equals_conv3d(k, shape):
    """The plain version of the stride-1 depthwise conv (the kernel's CPU
    path and oracle; the ids name the shapes of the library routes it
    replaced) equals torch's conv."""
    x, w, b = _dw_case(k, shape)
    got = depthwise.depthwise3d_reference(x, w, b, "same")
    want = F.conv3d(x, w, b, padding=k // 2, groups=shape[1])
    assert got.shape == want.shape and got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("side", [(4, 4, 4), (5, 3, 6), (1, 2, 1)],
                         ids=["even", "mixed", "tiny"])
@torch.no_grad()
def test_transposed_depthwise_route_equals_conv_transpose3d(k, side):
    """The plain version of the transposed conv, by its parity rule."""
    x, w, b = _dw_case(k, (2, 3) + side)
    got = depthwise.depthwise3d_reference(x, w, b, "up")
    want = F.conv_transpose3d(x, w, b, stride=2, padding=k // 2, groups=3)
    assert got.shape == want.shape == (2, 3) + tuple(2 * s - 1 for s in side)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("side", [(8, 6, 4), (7, 5, 9), (3, 1, 2)],
                         ids=["even", "odd", "tiny"])
@torch.no_grad()
def test_strided_depthwise_equals_conv3d_stride2(k, side):
    """The plain version of a down block's stride-2 conv."""
    x, w, b = _dw_case(k, (2, 3) + side)
    got = depthwise.depthwise3d_reference(x, w, b, "down")
    want = F.conv3d(x, w, b, stride=2, padding=k // 2, groups=3)
    assert got.shape == want.shape == (2, 3) + tuple(
        depthwise.output_side("down", s) for s in side)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("mode", ["same", "down", "up"])
def test_meta_depthwise_is_torch_conv_of_the_same_shapes(mode):
    """On ``meta`` (shapes only) the wrapper is torch's conv, so a walk of
    the model counts each depthwise conv as the conv it is."""
    x = torch.empty(2, 4, 9, 8, 7, device="meta")
    w = torch.empty(4, 1, 5, 5, 5, device="meta")
    got = depthwise.depthwise3d(x, w, torch.empty(4, device="meta"), mode)
    assert got.device.type == "meta"
    assert got.shape[2:] == tuple(depthwise.output_side(mode, s)
                                  for s in (9, 8, 7))


@pytest.mark.parametrize("bad", ["mode", "k", "weight", "bias", "devices"])
def test_depthwise_rejects_what_the_kernel_does_not_take(bad):
    x, w, b = _dw_case(5, (1, 2, 4, 4, 4))
    mode = "same"
    if bad == "mode":
        mode = "sideways"
    elif bad == "k":
        w = torch.zeros(2, 1, 4, 4, 4)
    elif bad == "weight":
        w = torch.zeros(3, 1, 5, 5, 5)
    elif bad == "bias":
        b = torch.zeros(3)
    else:
        b = b.to("meta")
    with pytest.raises(ValueError):
        depthwise.depthwise3d(x, w, b, mode)


@torch.no_grad()
def test_cpu_forward_never_loads_the_kernel_library(runner, monkeypatch):
    """A MedNeXt forward on the CPU runs the plain version: it neither
    builds nor loads ``csrc/depthwise3d.cu`` and launches nothing."""
    def refuse(name="scatter_blend"):
        raise AssertionError(f"loaded the {name} library on the CPU")

    monkeypatch.setattr(cuda_build, "load", refuse)
    before = depthwise.depthwise3d.launches
    got = runner.module(_patches(1))
    assert got.shape == (1, 3, PATCH, PATCH, PATCH)
    assert depthwise.depthwise3d.launches == before


def _state(params, extra=()):
    sd = {k: v.clone() for k, v in params.items()}
    gen = torch.Generator().manual_seed(7)
    for key in extra:
        if key == "dummy_tensor":
            sd[key] = torch.ones(1)
        else:  # a deep-supervision head out_i
            i = int(key[4])
            sd[key + ".conv_out.weight"] = torch.randn(
                (C * 2 ** i, 3, 1, 1, 1), generator=gen)
            sd[key + ".conv_out.bias"] = torch.randn((3,), generator=gen)
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    return buf, sd


@pytest.mark.parametrize("extra", [(), ("dummy_tensor",),
                                   ("out_1", "out_2", "out_3", "out_4"),
                                   ("dummy_tensor", "out_1", "out_2",
                                    "out_3", "out_4")],
                         ids=["plain", "dummy", "heads", "both"])
@torch.no_grad()
def test_load_model_reads_the_widths_and_loads_strictly(params, kernel,
                                                        extra):
    buf, sd = _state(params, extra)
    run = inference.load_model(buf, device="cpu", dtype=torch.float32)
    m = run.module
    assert isinstance(m, MedNeXt) and run.output_channels == 3
    heads = "out_1" in extra
    assert mednext.widths_from_state_dict(m.state_dict()) == dict(
        in_channels=1, out_channels=3, n_channels=C, exp_r=EXP_R,
        block_counts=COUNTS, kernel_size=kernel, deep_supervision=heads)
    state = m.state_dict()
    assert set(state) == set(sd) - {"dummy_tensor"}
    for k, v in sd.items():
        if k != "dummy_tensor":
            assert torch.equal(state[k], v), k
    # the heads are loaded and never run
    x = _patches(1)
    assert _mae(m(x), ref.forward(params, x)) <= 1e-5


def test_load_model_rejects_what_it_cannot_build(params):
    _, sd = _state(params)
    del sd["dec_block_2.1.norm.bias"]
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    with pytest.raises(RuntimeError, match="Missing key"):
        inference.load_model(buf, device="cpu")
    with pytest.raises(ValueError, match="width_multiplier"):
        inference.load_model(arch.checkpoint(params), device="cpu",
                             width_multiplier=0.5)
    with pytest.raises(ValueError, match="output channels"):
        inference.load_model(arch.checkpoint(params), device="cpu",
                             affinity_mode=False)


@torch.no_grad()
def test_valid_trim_returns_the_central_region(runner):
    x = _patches()
    full = runner.module(x)
    got = runner.module(x, valid_trim=4)
    assert torch.equal(got, full[:, :, 4:-4, 4:-4, 4:-4])
    with pytest.raises(ValueError, match="multiple of 16"):
        runner.module(torch.zeros(1, 1, 40, 32, 32))


def test_predict_matches_the_reference_patch_loop(runner, params):
    block = inputs.tube_volume(SEED, 1, 48, 3, 2, 120, 350)[0]
    kw = dict(patch=(PATCH,) * 3, overlap=(16,) * 3, trim=4, clip=1000,
              percentiles=(1, 99.9))
    got = inference.predict(block, runner, batch_size=2,
                            patch_shape=kw["patch"], overlap=kw["overlap"],
                            trim=4, verbose=False)
    want = ref_predict.predict(block, params, CPU, ref.forward, **kw)
    assert got.shape == want.shape == (3, 48, 48, 48)
    assert float(np.abs(got.astype(np.float64) - want).mean()) <= 1e-5


@torch.no_grad()
def test_the_block_counter_counts_what_the_counts_say(runner):
    before = MedNeXt.block_patches
    runner.module(_patches(3))
    assert MedNeXt.block_patches - before == counts.block_patches(
        3, COUNTS) == 3 * (sum(COUNTS) + 8)


@pytest.mark.parametrize("patch", [128, 96])
def test_flops_match_the_flop_counter_on_meta(patch):
    """The published model's FLOPs: the port's forward (its depthwise
    convs torch's own on ``meta``), and the plain reference's."""
    model = MedNeXt().to("meta")
    assert sum(p.numel() for p in model.parameters()) == 62_992_931
    x = torch.empty(1, 1, patch, patch, patch, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x)
    p = {k: torch.empty(s, device="meta")
         for k, s in ref.param_shapes().items()}
    with FlopCounterMode(display=False) as fc_ref, torch.no_grad():
        ref.forward(p, x)
    assert counts.forward_flops(patch) == fc.get_total_flops() == \
        fc_ref.get_total_flops()
    if patch == 128:
        assert counts.forward_flops(patch) == 1_117_847_580_672


@torch.no_grad()
def test_unet3d_checkpoint_still_builds_the_unet3d(tmp_path):
    net = UNet3D(output_channels=3, width_multiplier=0.25)
    init_weights(net, torch.Generator().manual_seed(4))
    path = tmp_path / "unet.pth"
    torch.save(net.state_dict(), path)
    got = inference.load_model(str(path), device="cpu",
                               width_multiplier=0.25, fold_bn=False)
    assert type(got.module) is UNet3D
    sd_got, sd_want = got.module.state_dict(), net.state_dict()
    assert list(sd_got) == list(sd_want)
    for k in sd_want:
        assert torch.equal(sd_got[k], sd_want[k]), k
    x = _patches()
    assert torch.equal(got.module(x, valid_trim=4),
                       net.eval()(x, valid_trim=4))


@torch.no_grad()
def test_swin_checkpoint_still_builds_the_swin():
    p = swin_arch.seeded_weights(SEED, CPU, feature_size=12)
    got = inference.load_model(swin_arch.checkpoint(p), device="cpu",
                               dtype=torch.float32)
    assert type(got.module) is SwinUNETR
    want = SwinUNETR(feature_size=12)
    want.load_state_dict(torch.load(swin_arch.checkpoint(p),
                                    weights_only=True), strict=True)
    sd_got, sd_want = got.module.state_dict(), want.state_dict()
    assert list(sd_got) == list(sd_want)
    for k in sd_want:
        assert torch.equal(sd_got[k], sd_want[k]), k
    x = _patches()
    assert torch.equal(got.module(x), want.eval()(x))
