"""The port's SegMamba (``models/segmamba.py``) on the CPU, float32.

Held to the plain reference of ``benchmark/reference/segmamba.py`` on
seeded weights at a 32^3 patch, ``feat_size`` (8, 16, 32, 64),
``hidden_size`` 64: the whole forward within MAE 1e-6 and max-abs 2e-5
of the reference's logits. Computing the scan in bfloat16, dropping a
direction, or scanning the slice order as the forward one each fail
that parity. The scan's plain version (``ops/selective_scan.py``, the
kernels' CPU path and oracle) equals a step-by-step loop in each order,
and its causal conv torch's ``conv1d``; the slice order is SegMamba's
``chunk``/``stack``/``flatten`` and its inverse puts it back.
``load_model`` builds the model from a SegMamba-keyed checkpoint
(strict), reading every width back, and still builds the Swin UNETR,
whose decoder blocks moved to ``models/unetr_blocks.py``, bit for bit;
``predict`` runs it against the reference's patch loop; a CPU forward
loads no kernel; the scan counter counts what the counts say.
"""

import io

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from aind_exaspim_neuron_segmentation_tpu_torch import cuda_build, inference
from aind_exaspim_neuron_segmentation_tpu_torch.models import (
    segmamba,
    swin_unetr,
    unetr_blocks,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.segmamba import (
    SegMamba,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.swin_unetr import (
    SwinUNETR,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import selective_scan as ss
from benchmark import inputs
from benchmark.counts import segmamba as counts
from benchmark.models import segmamba as arch
from benchmark.models import swinunetr as swin_arch
from benchmark.reference import predict as ref_predict
from benchmark.reference import segmamba as ref

CPU = torch.device("cpu")
WIDTHS = dict(feat_size=(8, 16, 32, 64), hidden_size=64)
PATCH = 32
SEED = 2**31 + 23
MAE, MAX_ABS = 1e-6, 2e-5


@pytest.fixture(scope="module")
def params():
    """Seeded float32 weights by SegMamba's key."""
    return arch.seeded_weights(SEED, CPU, **WIDTHS)


@pytest.fixture(scope="module")
def runner(params):
    """The port's runner, built by ``load_model`` from the checkpoint."""
    return inference.load_model(arch.checkpoint(params), device="cpu",
                                dtype=torch.float32)


@pytest.fixture(scope="module")
def patches():
    """Two normalized 32^3 tube patches, (2, 1, 32, 32, 32)."""
    img = inputs.tube_volume(0, 0, 64, 3, 2, 120, 350)[0]
    img = ref_predict.normalize(img, 1000, (1, 99.9))
    return torch.from_numpy(np.stack(
        [img[16 * k:16 * k + PATCH, :PATCH, 8:8 + PATCH]
         for k in range(2)])[:, None])


@pytest.fixture(scope="module")
def want(params, patches):
    """The reference's logits of the two patches."""
    with torch.no_grad():
        return ref.forward(params, patches)


def _gaps(got, want):
    diff = (got.double() - want.double()).abs()
    return float(diff.mean()), float(diff.max())


def _bf16_scan(scan):
    def run(u, delta, A, Bm, Cm, D, chunk=ss.CHUNK):
        args = [t.bfloat16() for t in (u, delta, A, Bm, Cm, D)]
        return scan(*args, chunk).to(u.dtype)
    return run


def _slice_as_forward(token_order):
    def order(name, length, nslices):
        return token_order("forward" if name == "slice" else name, length,
                           nslices)
    return order


@pytest.mark.parametrize("knockout", ["none", "bf16_scan", "drop_direction",
                                      "slice_as_forward"])
@torch.no_grad()
def test_forward_matches_the_reference(runner, patches, want, monkeypatch,
                                       knockout):
    """The port's forward within the parity bar of the reference; each
    knockout of the scan's precision, a direction or the slice order
    breaks it."""
    if knockout == "bf16_scan":
        monkeypatch.setattr(ss, "scan_chunked", _bf16_scan(ss.scan_chunked))
    elif knockout == "drop_direction":
        monkeypatch.setattr(segmamba, "ORDERS", ss.ORDERS[:2])
    elif knockout == "slice_as_forward":
        monkeypatch.setattr(ss, "token_order",
                            _slice_as_forward(ss.token_order))
    got = runner.module(patches)
    assert got.shape == want.shape == (2, 3, PATCH, PATCH, PATCH)
    mae, worst = _gaps(got, want)
    if knockout == "none":
        assert mae <= MAE and worst <= MAX_ABS, (mae, worst)
    else:
        assert mae > 10 * MAE, (knockout, mae)


@pytest.mark.parametrize("stage,layer", [(0, 0), (1, 1), (3, 0)])
@torch.no_grad()
def test_each_mamba_layer_matches_the_reference(runner, params, stage,
                                                layer):
    c = WIDTHS["feat_size"][stage]
    side = PATCH // 2 ** (stage + 1)
    x = torch.randn((2, c, side, side, side),
                    generator=torch.Generator().manual_seed(stage))
    name = f"vit.stages.{stage}.{layer}"
    got = runner.module.get_submodule(name)(x)
    want = ref.mamba_layer(params, name + ".", x)
    mae, worst = _gaps(got, want)
    assert mae <= MAE and worst <= MAX_ABS, (mae, worst)


def _step_loop(u, dbl, dt_weight, dt_bias, A_log, D, order, nslices):
    """One direction's ``y`` by the recurrence, one position at a time, in
    float64, from the token map written out afresh."""
    b, length, d = u.shape
    r = dt_weight.shape[1]
    hw = length // nslices
    if order == "forward":
        toks = list(range(length))
    elif order == "backward":
        toks = list(range(length - 1, -1, -1))
    else:
        toks = [s * hw + i for i in range(hw) for s in range(nslices)]
    A = -torch.exp(A_log)
    h = torch.zeros((b, d, A.shape[1]), dtype=torch.float64)
    y = torch.zeros_like(u)
    for t in toks:
        delta = F.softplus(dbl[:, t, :r] @ dt_weight.T + dt_bias)
        h = (torch.exp(delta[..., None] * A) * h
             + (delta * u[:, t])[..., None] * dbl[:, t, None, r:r + 16])
        y[:, t] = (h * dbl[:, t, None, r + 16:]).sum(-1) + D * u[:, t]
    return y


def _scan_inputs(b, length, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    d, r = 2 * c, -(-c // 16)
    u = torch.randn((b, length, d), generator=g, dtype=torch.float64)
    dbl = torch.randn((b, length, r + 32), generator=g, dtype=torch.float64)
    dt_weight = (torch.rand((d, r), generator=g, dtype=torch.float64) * 2
                 - 1) / r ** 0.5
    dt_bias = torch.rand((d,), generator=g, dtype=torch.float64) * 4 - 5
    a_log = torch.log(torch.arange(1, 17, dtype=torch.float64)).repeat(d, 1)
    a_log = a_log + torch.rand((d, 16), generator=g, dtype=torch.float64)
    D = torch.randn((d,), generator=g, dtype=torch.float64)
    return u, dbl, dt_weight, dt_bias, a_log, D


@pytest.mark.parametrize("order", ss.ORDERS)
@pytest.mark.parametrize("b,length,c,nslices,chunk", [
    (2, 4 * 3 * 5, 8, 4, 7), (1, 2 * 4 * 4, 24, 2, 64),
    (2, 6 * 2 * 3, 8, 6, 5)],
    ids=["S4_HW15_chunk7", "S2_HW16_one_chunk", "S6_HW6_chunk5"])
def test_scan_equals_a_step_loop(order, b, length, c, nslices, chunk):
    """The plain version (reordered, chunked, carried, reordered back)
    against the recurrence stepped position by position: float64, to
    1e-12 of the output's largest value."""
    args = _scan_inputs(b, length, c)
    got = ss.scan_reference(*args, order, nslices, chunk=chunk)
    want = _step_loop(*args, order, nslices)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("length,nslices", [(24, 4), (60, 3), (8, 8),
                                            (7, 1)])
def test_slice_order_is_segmambas_and_inverts(length, nslices):
    """``token_order("slice")`` is SegMamba's ``chunk(nslices)``, stacked
    on a new last axis and flattened; each order's inverse puts the
    tokens back."""
    tokens = torch.arange(length)[None, :, None]
    segmamba_order = torch.stack(tokens.chunk(nslices, dim=1), dim=2) \
        .flatten(1, 2)
    assert torch.equal(ss.token_order("slice", length, nslices),
                       segmamba_order.flatten())
    for order in ss.ORDERS:
        perm = ss.token_order(order, length, nslices)
        inv = ss.inverse_order(order, length, nslices)
        assert torch.equal(perm[inv], torch.arange(length))
        assert torch.equal(inv[perm], torch.arange(length))


@pytest.mark.parametrize("order", ss.ORDERS)
def test_causal_conv_equals_conv1d_in_order(order):
    """``scan_conv``'s plain version is SiLU of torch's depthwise
    ``conv1d`` (padding 3, truncated to the sequence) in the order."""
    g = torch.Generator().manual_seed(1)
    b, length, d, nslices = 2, 3 * 4 * 2, 8, 3
    xz = torch.randn((b, length, 2 * d), generator=g)
    w = torch.randn((d, 1, 4), generator=g)
    bias = torch.randn((d,), generator=g)
    got = ss.scan_conv(xz, w, bias, order, nslices)
    perm = ss.token_order(order, length, nslices)
    x = xz[:, perm, :d].transpose(1, 2)
    y = F.silu(F.conv1d(x, w, bias, padding=3, groups=d)[..., :length])
    want = torch.empty_like(got)
    want[:, perm] = y.transpose(1, 2)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_the_accumulator_adds_and_gates():
    """``selective_scan`` writes ``y``, adds it to ``acc``, or adds and
    gates ``(acc + y) * SiLU(z)`` in the activation dtype."""
    g = torch.Generator().manual_seed(2)
    u, dbl, dtw, dtb, a_log, D = (t.float() for t in _scan_inputs(2, 24, 8))
    xz = torch.randn((2, 24, 32), generator=g)
    y = ss.selective_scan(u, dbl, dtw, dtb, a_log, D, "slice", 4)
    assert y.dtype == torch.float32
    acc = torch.randn(y.shape, generator=g)
    start = acc.clone()
    got = ss.selective_scan(u, dbl, dtw, dtb, a_log, D, "slice", 4, acc=acc)
    assert got is acc and torch.allclose(acc, start + y)
    gated = ss.selective_scan(u, dbl, dtw, dtb, a_log, D, "slice", 4,
                              acc=start, xz=xz)
    assert torch.allclose(gated, (start + y) * F.silu(xz[..., 16:]))


@pytest.mark.parametrize("bad", ["order", "nslices", "d_state", "gate"])
def test_the_ops_refuse_what_they_cannot_scan(bad):
    u, dbl, dtw, dtb, a_log, D = (t.float() for t in _scan_inputs(1, 24, 8))
    kw = dict(order="slice", nslices=4)
    if bad == "order":
        kw["order"] = "diagonal"
    elif bad == "nslices":
        kw["nslices"] = 5
    elif bad == "d_state":
        a_log = a_log[:, :8]
    else:
        kw["xz"] = torch.zeros((1, 24, 32))
    with pytest.raises(ValueError):
        ss.selective_scan(u, dbl, dtw, dtb, a_log, D, **kw)


def _buffer(sd):
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    return buf


@torch.no_grad()
def test_load_model_reads_the_widths_and_loads_strictly(params, runner,
                                                        tmp_path):
    m = runner.module
    assert isinstance(m, SegMamba) and runner.output_channels == 3
    assert segmamba.widths_from_state_dict(m.state_dict()) == dict(
        in_channels=1, out_channels=3, depths=(2, 2, 2, 2),
        feat_size=WIDTHS["feat_size"], hidden_size=WIDTHS["hidden_size"],
        d_state=16, d_conv=4, expand=2)
    state = m.state_dict()
    assert set(state) == set(params)
    for k, v in params.items():
        assert torch.equal(state[k], v), k
    path = tmp_path / "segmamba.pth"
    torch.save(params, path)
    from_file = inference.load_model(str(path), device="cpu",
                                     dtype=torch.float32)
    assert type(from_file.module) is SegMamba
    sd = dict(params)
    del sd["vit.stages.1.0.mamba.A_s_log"]
    with pytest.raises(RuntimeError, match="Missing key"):
        inference.load_model(_buffer(sd), device="cpu")
    sd = dict(params, **{"vit.extra.weight": torch.ones(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        inference.load_model(_buffer(sd), device="cpu")
    with pytest.raises(ValueError, match="width_multiplier"):
        inference.load_model(arch.checkpoint(params), device="cpu",
                             width_multiplier=0.5)
    with pytest.raises(ValueError, match="output channels"):
        inference.load_model(arch.checkpoint(params), device="cpu",
                             affinity_mode=False)


def test_published_widths_count_their_parameters_and_flops():
    """At the published widths (1 in, 3 out) ``load_model`` of a
    SegMamba-keyed checkpoint builds SegMamba's 67,362,723 parameters in
    the reference's shapes, and the model's FLOPs on ``meta`` are the
    counts'."""
    buf = io.BytesIO()
    torch.save(SegMamba().state_dict(), buf)
    buf.seek(0)
    model = inference.load_model(buf, device="cpu",
                                 dtype=torch.float32).module
    assert isinstance(model, SegMamba)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(s) for k, s in ref.param_shapes().items()}
    assert sum(p.numel() for p in model.parameters()) == 67_362_723
    model = SegMamba().to("meta")
    x = torch.empty(1, 1, 128, 128, 128, device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x)
    assert fc.get_total_flops() == counts.forward_flops(128)


@torch.no_grad()
def test_valid_trim_returns_the_central_region(runner, patches):
    full = runner.module(patches)
    got = runner.module(patches, valid_trim=4)
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
    assert float(np.abs(got.astype(np.float64) - want).mean()) <= 1e-6


@torch.no_grad()
def test_cpu_forward_loads_no_kernel_and_counts_its_scans(runner, patches,
                                                          monkeypatch):
    """A CPU forward runs the plain version (no kernel library built or
    loaded, no launch) and counts 3 (token, direction) pairs a token of
    every Mamba layer, as the counts do."""
    def refuse(name="scatter_blend"):
        raise AssertionError(f"loaded the {name} library on the CPU")

    monkeypatch.setattr(cuda_build, "load", refuse)
    launches, tokens = ss.selective_scan.launches, SegMamba.scan_tokens
    runner.module(patches)
    assert ss.selective_scan.launches == launches
    assert SegMamba.scan_tokens - tokens == counts.scan_tokens(
        PATCH, 2, **WIDTHS) == 3 * 2 * 2 * (16 ** 3 + 8 ** 3 + 4 ** 3 + 8)
    assert counts.scan_tokens(128, 1) == 1_797_120


@torch.no_grad()
def test_swin_decoder_blocks_moved_and_still_load():
    """The Swin UNETR's MONAI decoder blocks are the shared module's, its
    keys are unchanged, and its MONAI-keyed checkpoint loads strictly."""
    for name in ("ConvUnit", "UnetResBlock", "UnetrBasicBlock",
                 "UnetrUpBlock", "UnetOutBlock", "_norm"):
        assert getattr(swin_unetr, name) is getattr(unetr_blocks, name)
    p = swin_arch.seeded_weights(SEED, CPU, feature_size=12)
    got = inference.load_model(swin_arch.checkpoint(p), device="cpu",
                               dtype=torch.float32)
    assert type(got.module) is SwinUNETR
    assert isinstance(got.module.decoder1, unetr_blocks.UnetrUpBlock)
    state = got.module.state_dict()
    assert set(p) <= set(state)
    for k, v in p.items():
        assert torch.equal(state[k], v), k
