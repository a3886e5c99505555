"""The port's Swin UNETR (``models/swin_unetr.py``) on the CPU, float32.

Held to the plain reference of ``benchmark/reference/swinunetr.py`` on
seeded weights at MAE <= 1e-5 (the repo's parity bar) at a 32^3 patch,
feature size 12 and the published heads, window and depths: stage 1
pads its 16^3 map to 21^3, stages 1-2 shift, stage 3's window is clipped
to its 4^3 map (so the bias takes ``index[:64, :64]`` of the 7^3
window's) and stage 4's to 2^3. The shift mask, the zero padding and the
merge order are each knocked out of the port in turn, and parity then
fails. ``load_model`` builds the model from a MONAI-keyed checkpoint
(strict) and still builds the UNet3D, bit for bit, from one of its own;
``predict`` runs it against the reference's patch loop; the counter and
the FLOP count are held to ``benchmark/counts/swinunetr.py``.
"""

import io

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.models import swin_unetr
from aind_exaspim_neuron_segmentation_tpu_torch.models.swin_unetr import (
    SwinUNETR,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from benchmark import inputs
from benchmark.counts import swinunetr as counts
from benchmark.models import swinunetr as arch
from benchmark.reference import predict as ref_predict
from benchmark.reference import swinunetr as ref

CPU = torch.device("cpu")
FS = 12
PATCH = 32
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def params():
    """Seeded float32 weights by MONAI's key, feature size 12."""
    return arch.seeded_weights(SEED, CPU, feature_size=FS)


@pytest.fixture(scope="module")
def runner(params):
    """The port's runner, built by ``load_model`` from the checkpoint."""
    return inference.load_model(arch.checkpoint(params), device="cpu",
                                dtype=torch.float32)


def _patches(n=2, seed=0):
    img = inputs.tube_volume(seed, 0, 64, 3, 2, 120, 350)[0]
    img = ref_predict.normalize(img, 1000, (1, 99.9))
    return torch.from_numpy(np.stack(
        [img[16 * k:16 * k + PATCH, :PATCH, 8:8 + PATCH]
         for k in range(n)])[:, None])


def _mae(a, b):
    return float((a.double() - b.double()).abs().mean())


@torch.no_grad()
def test_forward_matches_the_reference(runner, params):
    x = _patches()
    got = runner.module(x)
    want = ref.forward(params, x)
    assert got.shape == want.shape == (2, 3, PATCH, PATCH, PATCH)
    assert _mae(got, want) <= 1e-5


def _stage_input(params, stage, seed=3):
    """A channels-last map at ``stage``'s size and width."""
    side = PATCH // 2 // 2 ** (stage - 1)
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((2, side, side, side, FS * 2 ** (stage - 1)),
                       generator=gen)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
@pytest.mark.parametrize("block", [0, 1], ids=["plain", "shifted"])
@torch.no_grad()
def test_each_block_matches_the_reference(runner, params, stage, block):
    x = _stage_input(params, stage)
    layer = getattr(runner.module.swinViT, f"layers{stage}")[0]
    heads = layer.blocks[block].attn.num_heads
    window, shift, padded = ref.geometry(x.shape[1:4], 7)
    mask = ref.region_mask(padded, window, shift) if any(shift) else None
    want = ref.swin_block(params, f"swinViT.layers{stage}.0.blocks.{block}.",
                          x, heads, window, shift if block else (0, 0, 0),
                          ref.position_index(7), mask)
    ids = swin_unetr.region_ids(padded, window, shift, CPU) \
        if any(shift) else None
    got = layer.blocks[block](x, ids)
    assert _mae(got, want) <= 1e-5
    if stage == 3:  # the clipped window takes index[:64, :64]
        assert window == [4, 4, 4] and not any(shift)


@torch.no_grad()
def test_merge_matches_the_reference(runner, params):
    x = _stage_input(params, 1)
    got = runner.module.swinViT.layers1[0].downsample(x)
    want = ref.merge(params, "swinViT.layers1.0.", x)
    assert _mae(got, want) <= 1e-5


def _shifted_block_gap(runner, params):
    """Stage 1's shifted block, port against reference."""
    x = _stage_input(params, 1)
    blk = runner.module.swinViT.layers1[0].blocks[1]
    window, shift, padded = ref.geometry(x.shape[1:4], 7)
    want = ref.swin_block(params, "swinViT.layers1.0.blocks.1.", x,
                          blk.attn.num_heads, window, shift,
                          ref.position_index(7),
                          ref.region_mask(padded, window, shift))
    got = blk(x, swin_unetr.region_ids(padded, window, shift, CPU))
    return _mae(got, want)


class _PadWithOnes:
    """``torch.nn.functional`` whose ``pad`` fills with 1."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def pad(x, pads):
        return torch.nn.functional.pad(x, pads, value=1.0)


@pytest.mark.parametrize("knockout", ["none", "mask", "padding"])
@torch.no_grad()
def test_shift_mask_and_padding_are_pinned(runner, params, monkeypatch,
                                           knockout):
    """Stage 1's shifted block (16^3 padded to 21^3) against the
    reference: equal as it is; far apart with the region mask knocked out
    (one region everywhere), or with the windows padded by ones (the
    padded tokens are keys, so their values reach the output)."""
    if knockout == "mask":
        monkeypatch.setattr(
            swin_unetr, "region_ids",
            lambda dims, w, s, device: torch.zeros(
                (int(np.prod([d // k for d, k in zip(dims, w)])),
                 int(np.prod(w))), device=device))
    elif knockout == "padding":
        monkeypatch.setattr(swin_unetr, "F", _PadWithOnes())
    gap = _shifted_block_gap(runner, params)
    if knockout == "none":
        assert gap <= 1e-5
    else:
        assert gap > 1e-3, gap


@pytest.mark.parametrize("order", ["monai", "product"])
@torch.no_grad()
def test_merge_order_is_pinned(runner, params, monkeypatch, order):
    """The legacy order (two slices repeated) matches the reference; the
    plain product order (MONAI's v2 merge) does not."""
    assert swin_unetr.MERGE_ORDER == ref.MERGE == (
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))
    if order == "product":
        monkeypatch.setattr(swin_unetr, "MERGE_ORDER", tuple(
            (i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)))
    x = _stage_input(params, 1)
    gap = _mae(runner.module.swinViT.layers1[0].downsample(x),
               ref.merge(params, "swinViT.layers1.0.", x))
    assert (gap <= 1e-5) if order == "monai" else (gap > 1e-3), gap


def test_load_model_reads_the_widths_and_loads_strictly(runner, params):
    m = runner.module
    assert isinstance(m, SwinUNETR) and runner.output_channels == 3
    assert swin_unetr.widths_from_state_dict(m.state_dict()) == dict(
        in_channels=1, out_channels=3, feature_size=FS,
        depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window=7,
        patch_size=2, mlp_ratio=4.0)
    state = m.state_dict()
    for k, v in params.items():
        assert torch.equal(state[k], v), k
    assert torch.equal(
        state["swinViT.layers4.0.blocks.1.attn.relative_position_index"],
        ref.position_index(7))
    ckpt = torch.load(arch.checkpoint(params), weights_only=True)
    assert set(state) == set(ckpt)
    del ckpt["swinViT.layers2.0.blocks.1.attn.qkv.bias"]
    buf = io.BytesIO()
    torch.save(ckpt, buf)
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
    with pytest.raises(ValueError, match="multiple of 32"):
        runner.module(torch.zeros(1, 1, 48, 32, 32))


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
def test_the_window_counter_counts_what_the_counts_say(runner):
    before = SwinUNETR.swin_windows
    runner.module(_patches(3))
    assert SwinUNETR.swin_windows - before == counts.attention_windows(
        PATCH, 3, feature_size=FS) == 3 * (27 * 3 + 8 * 6 + 12 + 24) * 2


@pytest.mark.parametrize("patch,fs", [(32, 12), (96, 48)])
def test_flops_match_the_flop_counter_on_meta(patch, fs):
    model = SwinUNETR(feature_size=fs).to("meta")
    x = torch.empty(1, 1, patch, patch, patch, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x)
    assert counts.forward_flops(patch, feature_size=fs) == \
        fc.get_total_flops()
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    # on meta the attention runs as batched matmuls, and only it does
    assert by_op["aten.bmm"] == counts.attention_flops(patch,
                                                       feature_size=fs)
    assert by_op["aten.convolution"] == counts.conv_flops(
        counts.conv_layers(patch, feature_size=fs))


@pytest.mark.parametrize("fold_bn", [False, True], ids=["bn", "folded"])
@torch.no_grad()
def test_unet3d_checkpoint_still_builds_the_unet3d(tmp_path, fold_bn):
    from aind_exaspim_neuron_segmentation_tpu_torch.models.convert import (
        fold_batchnorm,
        load_pth,
    )

    net = UNet3D(output_channels=3, width_multiplier=0.25)
    init_weights(net, torch.Generator().manual_seed(4))
    path = tmp_path / "unet.pth"
    torch.save(net.state_dict(), path)
    got = inference.load_model(str(path), device="cpu",
                               width_multiplier=0.25, fold_bn=fold_bn)
    want = UNet3D(output_channels=3, width_multiplier=0.25)
    load_pth(str(path), want)
    if fold_bn:
        folded = fold_batchnorm(want.state_dict())
        want = UNet3D(output_channels=3, width_multiplier=0.25,
                      fused_bn=True)
        want.load_state_dict(folded, strict=True)
    want.eval()
    assert type(got.module) is UNet3D
    sd_got, sd_want = got.module.state_dict(), want.state_dict()
    assert list(sd_got) == list(sd_want)
    for k in sd_want:
        assert torch.equal(sd_got[k], sd_want[k]), k
    x = _patches()
    a, b = got.module(x, valid_trim=4), want(x, valid_trim=4)
    assert torch.equal(a, b)
