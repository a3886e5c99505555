"""The port's valid-region decoder against the JAX package's, on the CPU.

``ops/upsample.py`` (the row-ranged trilinear x2 upsample) is held to the
same rows of ``F.interpolate(mode="trilinear", align_corners=True)`` bit
for bit, and to the JAX package's ``ops/upsample.py`` within
:func:`jax_tol`: the JAX form weights rows by a float64 interpolation
matrix, PyTorch (and so the port) by float32 source indices ``i *
ratio``, whose rounding grows with the axis length (measured: 2.8e-6 at
16 rows, 1.05e-5 at 63, in ``F.interpolate`` as in the port). The
support trims and the ``ValueError`` cases equal the JAX package's.
``UNet3D(valid_trim=t)`` in eval mode equals the port's sliced full
forward bit for bit in float32 (measured: the unpadded convs and the
row-ranged upsample round as the padded forward does), and the JAX
``valid_trim`` forward within MAE 1e-5 / max-abs 1e-4; a ``predict``
whose grid runs the cascade (patch 32, trim 8) equals the JAX
``predict`` within MAE 1e-5. Figures print as ``{"parity": ...}`` lines
(``pytest -s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu.models import convert as jconvert
from aind_exaspim_neuron_segmentation_tpu.models.unet3d import (
    UNet3D as JaxUNet3D,
)
from aind_exaspim_neuron_segmentation_tpu.ops import upsample as jup
from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.models import convert
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import UNet3D
from aind_exaspim_neuron_segmentation_tpu_torch.ops import upsample as up
from tests.test_torch_gpu import parity_line
from tests.test_torch_port import perturbed_jax_variables

torch.set_num_threads(1)

WIDTH = 0.25
TRIMS = (1, 2, 4, 7, 8)


def jax_tol(n_in, x):
    """Max-abs bound of the port's resize against the JAX package's: the
    float32 source index of an ``n_in``-row axis is off by at most ~2
    roundings of ``n_in``, i.e. ``2 * n_in * 2**-24`` rows, which moves a
    lerp of two rows of ``x`` by twice that times ``2 max|x|``; plus 1e-6
    for the float32 lerp itself."""
    return 8 * n_in * 2.0 ** -24 * float(np.abs(x).max()) + 1e-6


def _ncdhw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _ndhwc(a):
    return np.moveaxis(np.asarray(a), 1, -1)


# --- ops/upsample.py -------------------------------------------------------


def test_trilinear_upsample_equals_jax_and_interpolate():
    """The case of ``tests/test_unet_parity.py``'s upsample test."""
    x = np.random.default_rng(0).standard_normal((2, 6, 7, 5, 3)).astype(
        np.float32)
    want = _ncdhw(jup.trilinear_upsample_x2(jnp.asarray(x)))
    xt = torch.from_numpy(_ncdhw(x).copy())
    got = up.trilinear_upsample_x2(xt)
    fig = parity_line("trilinear_upsample_x2 vs JAX (2,3,6,7,5)",
                      got.numpy(), want)
    assert fig["max_abs"] <= jax_tol(7, x)
    ref = F.interpolate(xt, scale_factor=2, mode="trilinear",
                        align_corners=True)
    assert torch.equal(got, ref)


def test_resize_in_range_equals_jax_and_full_columns():
    """The case of ``tests/test_unet_parity.py``'s in_range test, on the
    port's axis 2 (the JAX package's axis 1)."""
    x = np.random.default_rng(1).standard_normal((2, 16, 5, 4, 3)).astype(
        np.float32)
    xt = torch.from_numpy(_ncdhw(x).copy())
    full = up.linear_resize_axis(xt, 2, 32, out_range=(6, 26))
    s = up.x2_support_trim(16, 6, 26)
    assert s == jup.x2_support_trim(16, 6, 26) == 2
    part = up.linear_resize_axis(xt[:, :, s:16 - s], 2, 32,
                                 out_range=(6, 26), in_range=(s, 16 - s),
                                 nominal_in=16)
    assert torch.equal(full, part)
    want = _ncdhw(jup.linear_resize_axis(jnp.asarray(x), 1, 32,
                                         out_range=(6, 26)))
    fig = parity_line("linear_resize_axis rows 6:26 vs JAX", full.numpy(),
                      want)
    assert fig["max_abs"] <= jax_tol(16, x)
    with pytest.raises(ValueError, match="depend on"):
        up.linear_resize_axis(xt[:, :, 2:14], 2, 32, in_range=(2, 14),
                              nominal_in=16)
    with pytest.raises(ValueError, match="nominal_in"):
        up.linear_resize_axis(xt[:, :, 2:14], 2, 32, in_range=(2, 14))
    with pytest.raises(ValueError, match="does not match"):
        up.linear_resize_axis(xt[:, :, 2:13], 2, 32, in_range=(2, 14),
                              nominal_in=16)


def _grid():
    rng = np.random.default_rng(5)
    cases = [(1, 0, 2), (2, 0, 4), (16, 6, 26), (16, 5, 27), (16, 2, 30),
             (48, 6, 90), (48, 0, 96)]
    for _ in range(40):
        n = int(rng.integers(1, 64))
        lo = int(rng.integers(0, 2 * n))
        hi = int(rng.integers(lo + 1, 2 * n + 1))
        cases.append((n, lo, hi))
    return cases


def test_support_trim_and_row_ranges_on_a_seeded_grid():
    """On a seeded grid of ``(n_in, out_lo, out_hi)``: the support trim
    equals the JAX package's; the row-ranged resize equals those rows of
    ``F.interpolate`` bit for bit and the JAX rows within
    :func:`jax_tol`; with the
    support-trimmed input (and one row more trimmed, where that drops a
    weighted row) it equals, or raises, as the JAX package does."""
    rng = np.random.default_rng(6)
    worst = 0.0
    for n, lo, hi in _grid():
        s = up.x2_support_trim(n, lo, hi)
        assert s == jup.x2_support_trim(n, lo, hi), (n, lo, hi)
        x = rng.standard_normal((2, 3, n, 2, 3)).astype(np.float32)
        xt = torch.from_numpy(x)
        got = up.linear_resize_axis(xt, 2, 2 * n, out_range=(lo, hi))
        ref = F.interpolate(xt, size=(2 * n, 2, 3), mode="trilinear",
                            align_corners=True)[:, :, lo:hi]
        assert torch.equal(got, ref), (n, lo, hi)
        want = _ncdhw(jup.linear_resize_axis(
            jnp.asarray(_ndhwc(x)), 1, 2 * n, out_range=(lo, hi)))
        err = float(np.abs(got.numpy() - want).max())
        assert err <= jax_tol(n, x), (n, lo, hi, err)
        worst = max(worst, err)
        for trim in {s, s + 1}:
            if n - 2 * trim <= 0:
                continue
            kw = dict(out_range=(lo, hi), in_range=(trim, n - trim),
                      nominal_in=n)
            try:
                jwant = jup.linear_resize_axis(
                    jnp.asarray(_ndhwc(x)[:, trim:n - trim]), 1, 2 * n,
                    **kw)
            except ValueError:
                with pytest.raises(ValueError, match="depend on"):
                    up.linear_resize_axis(xt[:, :, trim:n - trim], 2,
                                          2 * n, **kw)
                continue
            part = up.linear_resize_axis(xt[:, :, trim:n - trim], 2, 2 * n,
                                         **kw)
            assert torch.equal(part, got), (n, lo, hi, trim)
            np.testing.assert_array_equal(_ncdhw(jwant), want)
    parity_line("linear_resize_axis seeded grid vs JAX",
                max_abs=worst, cases=len(_grid()))


def test_upsample_in_trim_and_ranges_equal_jax():
    x = np.random.default_rng(7).standard_normal((2, 24, 24, 24, 4)).astype(
        np.float32)
    ranges = ((6, 42), (6, 42), (6, 42))
    xt = torch.from_numpy(_ncdhw(x).copy())
    got = up.trilinear_upsample_x2(xt, out_ranges=ranges)
    want = _ncdhw(jup.trilinear_upsample_x2(jnp.asarray(x),
                                            out_ranges=ranges))
    assert np.abs(got.numpy() - want).max() <= jax_tol(24, x)
    full = F.interpolate(xt, scale_factor=2, mode="trilinear",
                         align_corners=True)[:, :, 6:42, 6:42, 6:42]
    assert torch.equal(got, full)
    s = up.x2_support_trim(24, 6, 42)
    assert s == 2
    big = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 2, 24, 24, 24)).astype(np.float32))
    got = up.trilinear_upsample_x2(big[:, :, s:-s, s:-s, s:-s],
                                   out_ranges=((6, 42),) * 3, in_trim=s)
    want = F.interpolate(big, scale_factor=2, mode="trilinear",
                         align_corners=True)[:, :, 6:42, 6:42, 6:42]
    assert torch.equal(got, want)
    jgot = _ncdhw(jup.trilinear_upsample_x2(
        jnp.asarray(_ndhwc(big.numpy())[:, s:-s, s:-s, s:-s]),
        out_ranges=((6, 42),) * 3, in_trim=s))
    fig = parity_line("trilinear_upsample_x2 in_trim 2 vs JAX", got.numpy(),
                      jgot)
    assert fig["max_abs"] <= jax_tol(24, big.numpy())
    with pytest.raises(ValueError, match="depend on"):
        up.trilinear_upsample_x2(big[:, :, 3:-3, 3:-3, 3:-3],
                                 out_ranges=((6, 42),) * 3, in_trim=3)


def test_reduced_precision_keeps_its_dtype():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 4, 6, 6, 6)).astype(np.float32))
    got = up.trilinear_upsample_x2(x.bfloat16())
    assert got.dtype == torch.bfloat16
    ref = up.trilinear_upsample_x2(x)
    fig = parity_line("trilinear_upsample_x2 bf16 vs float32",
                      got.float().numpy(), ref.numpy())
    assert fig["max_abs"] <= 2 ** -7 * float(ref.abs().max())


# --- UNet3D(valid_trim=) ---------------------------------------------------


@pytest.fixture(scope="module")
def nets():
    """(JAX variables (perturbed BatchNorm), JAX folded variables, port
    module, port folded module), width 0.25, eval mode."""
    variables = perturbed_jax_variables(True)
    folded = jconvert.fold_batchnorm(variables)
    net = UNet3D(output_channels=3, width_multiplier=WIDTH)
    net.load_state_dict(convert.state_dict_from_jax_variables(variables))
    fnet = UNet3D(output_channels=3, width_multiplier=WIDTH, fused_bn=True)
    fnet.load_state_dict(convert.state_dict_from_jax_variables(folded))
    return variables, folded, net.eval(), fnet.eval()


@pytest.fixture(scope="module")
def patches():
    return np.random.default_rng(1).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32)


def _up4_input_side(net, x, t):
    """The spatial side of the tensor up4's convs take at
    ``valid_trim=t`` (32 on the full path at 32^3)."""
    seen = []
    hook = net.up4.conv.register_forward_hook(
        lambda m, args, out: seen.append(args[0].shape[-1]))
    try:
        with torch.no_grad():
            net(x, valid_trim=t)
    finally:
        hook.remove()
    return seen[0]


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "folded"])
def test_valid_trim_equals_sliced_full_forward_and_jax(nets, patches,
                                                       fused):
    variables, folded, net, fnet = nets
    net = fnet if fused else net
    jvars = folded if fused else variables
    jnet = JaxUNet3D(output_channels=3, width_multiplier=WIDTH,
                     fused_bn=fused)
    x = torch.from_numpy(patches)
    with torch.no_grad():
        full = net(x)
    jx = jnp.asarray(_ndhwc(patches))
    for t in TRIMS:
        with torch.no_grad():
            fast = net(x, valid_trim=t)
        want = full[:, :, t:-t, t:-t, t:-t]
        assert fast.shape == want.shape
        parity_line(f"UNet3D valid_trim={t} fused={fused} vs sliced full",
                    fast.numpy(), want.numpy())
        assert torch.equal(fast, want), t
        # the cascade and the unpadded convs ran where the JAX Up takes
        # its fast path: up4's convs see dim - 2t + 4
        side = _up4_input_side(net, x, t)
        assert side == (32 if t < 2 else 32 - 2 * t + 4), (t, side)
        jout = _ncdhw(jnet.apply(jvars, jx, train=False, valid_trim=t))
        fig = parity_line(f"UNet3D valid_trim={t} fused={fused} vs JAX",
                          fast.numpy(), jout)
        assert fig["mae"] <= 1e-5 and fig["max_abs"] <= 1e-4, (t, fig)


def test_up3_cascade_decodes_only_up4s_support(nets, patches):
    """At trim 8 (and 7) on 32^3 up3 decodes 16 - 2 * 2 rows per side,
    as in the JAX package (x2_support_trim(16, 6, 26) == 2)."""
    _, _, net, _ = nets
    seen = []
    hook = net.up3.register_forward_hook(
        lambda m, args, out: seen.append(tuple(out.shape[2:])))
    try:
        with torch.no_grad():
            for t in (4, 7, 8):
                net(torch.from_numpy(patches), valid_trim=t)
    finally:
        hook.remove()
    assert seen == [(16, 16, 16), (12, 12, 12), (12, 12, 12)]


def test_x1_trim_without_the_fast_path_raises(nets):
    _, _, net, _ = nets
    x1 = torch.zeros((1, 8, 12, 12, 12))
    x2 = torch.zeros((1, 8, 32, 32, 32))
    with torch.no_grad(), pytest.raises(ValueError, match="x1_trim"):
        net.up4(x1, x2, valid_trim=1, x1_trim=2)
    net.up4.train()
    try:
        with torch.no_grad(), pytest.raises(ValueError, match="x1_trim"):
            net.up4(x1, x2, valid_trim=8, x1_trim=2)
    finally:
        net.up4.eval()
    with torch.no_grad():
        out = net.up4(x1, x2, valid_trim=8, x1_trim=2)
    assert out.shape == (1, 8, 16, 16, 16)


def test_train_mode_takes_the_full_forward(nets, patches):
    """In train mode ``valid_trim`` slices the full forward (the
    BatchNorm statistics span the whole patch), as the JAX Up does."""
    _, _, net, _ = nets
    x = torch.from_numpy(patches)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    try:
        net.train()
        with torch.no_grad():
            full = net(x)
            net.load_state_dict(state)
            cut = net(x, valid_trim=8)
        assert torch.equal(cut, full[:, :, 8:-8, 8:-8, 8:-8])
    finally:
        net.load_state_dict(state)
        net.eval()


def test_predict_on_the_cascade_equals_jax(tmp_path):
    """patch 32, overlap 16, trim 8: every batch runs up3's cascade."""
    module = JaxUNet3D(output_channels=3, width_multiplier=WIDTH,
                       dtype=jnp.float32)
    init = jax.jit(lambda x: module.init(jax.random.PRNGKey(0), x,
                                         train=False))
    jrun = jinf.ModelRunner(module, init(jnp.zeros((1, 16, 16, 16, 1))))
    path = str(tmp_path / "unet.pth")
    jconvert.save_pth_checkpoint(path, jax.tree.map(np.asarray,
                                                    jrun.variables))
    trun = inference.load_model(path, device="cpu", width_multiplier=WIDTH)
    vol = np.random.default_rng(4).uniform(0, 2000, (48, 64, 48)).astype(
        np.float32)
    kw = dict(patch_shape=(32, 32, 32), overlap=(16, 16, 16), trim=8,
              batch_size=4, verbose=False)
    want = jinf.predict(vol, jrun, **kw)
    got = inference.predict(vol, trun, **kw)
    assert got.shape == want.shape == (3,) + vol.shape
    fig = parity_line("predict patch 32 / overlap 16 / trim 8 vs JAX", got,
                      want)
    assert fig["mae"] <= 1e-5 and fig["max_abs"] <= 1e-4
