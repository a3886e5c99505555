"""The PyTorch port against the JAX package, on the CPU.

Inputs are made from seeds with numpy and go through both packages;
weights go from the JAX variables to the port through
``models.convert.state_dict_from_jax_variables``. Float results are held
to MAE <= 1e-5 and max-abs <= 1e-4 (float32, summation order differs);
integer results (folded weights, digest bytes) bit for bit. Each
comparison prints its figures as a JSON line; to read them::

    JAX_PLATFORMS=cpu python -m pytest -s -q tests/test_torch_port.py \
        tests/test_torch_scatter.py | grep '"parity"'

Cases that need a card are in ``tests/test_torch_gpu.py``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu.models import convert as jconvert
from aind_exaspim_neuron_segmentation_tpu.models.unet3d import (
    UNet3D as JaxUNet3D,
)
from aind_exaspim_neuron_segmentation_tpu.ops import predigest as jpredigest
from aind_exaspim_neuron_segmentation_tpu.ops import stitch as jstitch
from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_grid_ranges,
    slab_plan,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models import convert
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    pad_to_skip,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest, stitch
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "aind_exaspim_neuron_segmentation_tpu_torch"
PATCH = (32, 32, 32)
OVERLAP = (8, 8, 8)
TRIM = 4
WIDTH = 0.25


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_close(got, want, what):
    fig = parity_line(what, got, want)
    assert fig["mae"] <= 1e-5, f"{what}: MAE {fig['mae']}"
    assert fig["max_abs"] <= 1e-4, f"{what}: max abs {fig['max_abs']}"


def perturbed_jax_variables(trilinear):
    """JAX UNet3D variables (width 0.25, PRNGKey(0)) as numpy, with
    seeded, perturbed BatchNorm statistics and affine terms."""
    module = JaxUNet3D(output_channels=3, trilinear=trilinear,
                       width_multiplier=WIDTH)
    init = jax.jit(lambda x: module.init(jax.random.PRNGKey(0), x))
    variables = _np_tree(init(jnp.zeros((1, 16, 16, 16, 1))))
    rng = np.random.default_rng(11)
    draw = {
        "mean": lambda leaf: rng.normal(0, 0.2, leaf.shape),
        "var": lambda leaf: rng.uniform(0.5, 1.5, leaf.shape),
        "scale": lambda leaf: rng.uniform(0.7, 1.3, leaf.shape),
        "bias": lambda leaf: leaf + rng.normal(0, 0.1, leaf.shape),
    }
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: draw.get(path[-1].key, lambda v: v)(leaf).astype(
            np.float32),
        variables,
    )


@pytest.fixture(scope="module", params=[True, False],
                ids=["trilinear", "deconv"])
def jax_net(request):
    """(trilinear, numpy variables) with perturbed BatchNorm."""
    return request.param, perturbed_jax_variables(request.param)


@pytest.mark.parametrize("folded", [False, True], ids=["bn", "folded"])
def test_unet_logits_match_jax(jax_net, folded):
    trilinear, variables = jax_net
    jvars = (jconvert.fold_batchnorm(variables, trilinear=trilinear)
             if folded else variables)
    module = JaxUNet3D(output_channels=3, trilinear=trilinear,
                       width_multiplier=WIDTH, fused_bn=folded)
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 48, 16, 1)).astype(np.float32)
    apply = jax.jit(module.apply, static_argnames=("valid_trim",))
    want = np.asarray(apply(jvars, jnp.asarray(x)))
    want_core = np.asarray(apply(jvars, jnp.asarray(x), valid_trim=TRIM))

    net = UNet3D(output_channels=3, trilinear=trilinear,
                 width_multiplier=WIDTH, fused_bn=folded).eval()
    net.load_state_dict(
        convert.state_dict_from_jax_variables(jvars, trilinear=trilinear),
        strict=True,
    )
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    with torch.no_grad():
        got = net(xt).numpy()
        got_core = net(xt, valid_trim=TRIM).numpy()
    what = (f"UNet logits {'trilinear' if trilinear else 'deconv'} "
            f"{'folded' if folded else 'bn'} (2,32,48,16)")
    _assert_close(np.moveaxis(got, 1, -1), want, what)
    _assert_close(np.moveaxis(got_core, 1, -1), want_core,
                  f"{what} valid_trim={TRIM}")
    t = TRIM
    np.testing.assert_array_equal(got_core, got[:, :, t:-t, t:-t, t:-t])


def test_state_dict_keys_are_the_reference_checkpoint_keys(jax_net):
    trilinear, variables = jax_net
    ref = jconvert.variables_to_torch_state_dict(variables, trilinear)
    sd = convert.state_dict_from_jax_variables(variables, trilinear)
    net = UNet3D(output_channels=3, trilinear=trilinear,
                 width_multiplier=WIDTH)
    assert set(net.state_dict()) == set(ref) == set(sd)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_fold_batchnorm_bit_identical_to_jax(jax_net):
    trilinear, variables = jax_net
    want = convert.state_dict_from_jax_variables(
        jconvert.fold_batchnorm(variables, trilinear=trilinear), trilinear
    )
    got = convert.fold_batchnorm(
        convert.state_dict_from_jax_variables(variables, trilinear),
        trilinear=trilinear,
    )
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    parity_line(f"fold_batchnorm {'trilinear' if trilinear else 'deconv'}",
                bytes_equal=True)
    fused = UNet3D(output_channels=3, trilinear=trilinear,
                   width_multiplier=WIDTH, fused_bn=True)
    fused.load_state_dict(got, strict=True)


def test_folded_tree_with_batchnorm_params_rejected(jax_net):
    trilinear, variables = jax_net
    with pytest.raises(ValueError, match="batch_stats"):
        convert.state_dict_from_jax_variables(
            {"params": variables["params"]}, trilinear
        )


def test_pad_quirk_pads_h_by_d_and_w_by_h_mismatch():
    """The JAX Up block's pad (unet3d.py Up): the D mismatch pads H and
    the H mismatch pads W; D is never padded."""
    x1 = torch.arange(2 * 3 * 4 * 5 * 6, dtype=torch.float32).reshape(
        2, 3, 4, 5, 6)
    x2 = torch.zeros((2, 3, 5, 7, 9))
    d_y, d_x = 5 - 4, 7 - 5
    want = np.pad(x1.numpy(), ((0, 0), (0, 0), (0, 0),
                               (d_y // 2, d_y - d_y // 2),
                               (d_x // 2, d_x - d_x // 2)))
    np.testing.assert_array_equal(pad_to_skip(x1, x2).numpy(), want)
    assert pad_to_skip(x1, torch.zeros((2, 3, 4, 5, 6))) is x1


def test_sides_not_multiple_of_16_rejected_by_both():
    """Once the quirk pads, the concat sees unequal spatial shapes: both
    packages reject such inputs (36 x 40 x 44 here)."""
    x = np.zeros((1, 36, 40, 44, 1), np.float32)
    module = JaxUNet3D(output_channels=3, width_multiplier=WIDTH)
    with pytest.raises(TypeError):
        jax.jit(lambda v: module.init(jax.random.PRNGKey(0), v))(x)
    net = UNet3D(output_channels=3, width_multiplier=WIDTH).eval()
    with pytest.raises(RuntimeError), torch.no_grad():
        net(torch.zeros((1, 1, 36, 40, 44)))


# --- predict -------------------------------------------------------------


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """(JAX runner, port runner) with the same weights, via a .pth.

    The JAX runner is what ``load_model(width_multiplier=0.25,
    dtype=float32)`` builds (PRNGKey(0) init on a 16^3 dummy, BatchNorm
    unfolded), with the init jitted: eager init compiles op by op and
    takes tens of seconds.
    """
    module = JaxUNet3D(output_channels=3, width_multiplier=WIDTH,
                       dtype=jnp.float32)
    init = jax.jit(lambda x: module.init(jax.random.PRNGKey(0), x,
                                         train=False))
    jrun = jinf.ModelRunner(module, init(jnp.zeros((1, 16, 16, 16, 1))))
    path = str(tmp_path_factory.mktemp("ckpt") / "unet.pth")
    jconvert.save_pth_checkpoint(path, _np_tree(jrun.variables))
    trun = inference.load_model(path, affinity_mode=True, device="cpu",
                                width_multiplier=WIDTH)
    return jrun, trun


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 2000, size=(72, 56, 40)).astype(np.float32)


@pytest.fixture(scope="module")
def volumes(volume):
    """The float32 volume, and a uint16 one (above the clip in part),
    which ``predict`` prepares on the device."""
    rng = np.random.default_rng(1)
    u16 = rng.integers(0, 2000, size=volume.shape).astype(np.uint16)
    return {"float32": volume, "uint16": u16}


KW = dict(patch_shape=PATCH, overlap=OVERLAP, trim=TRIM, batch_size=4,
          verbose=False)


def test_load_model_cpu_defaults(runners):
    _, trun = runners
    assert trun.device == torch.device("cpu")
    assert trun.module.outc.conv.weight.dtype == torch.float32
    assert not trun.module.fused_bn
    folded = inference.load_model(device="cpu", width_multiplier=WIDTH,
                                  dtype=torch.bfloat16)
    assert folded.module.fused_bn
    assert folded.module.outc.conv.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("blend_mode, dtype", [
    pytest.param("uniform", "float32", id="uniform"),
    pytest.param("gaussian", "float32", id="gaussian"),
    pytest.param("uniform", "uint16", id="uniform-uint16"),
    pytest.param("gaussian", "uint16", id="gaussian-uint16"),
])
def test_predict_matches_jax(runners, volumes, blend_mode, dtype):
    """float32 input is prepared on the host, uint16 on the device (one
    slab counted)."""
    jrun, trun = runners
    vol = volumes[dtype]
    want = jinf.predict(vol, jrun, blend_mode=blend_mode, **KW)
    before = inference.predict.device_prep_slabs
    got = inference.predict(vol, trun, blend_mode=blend_mode, **KW)
    assert inference.predict.device_prep_slabs == before + (
        dtype == "uint16")
    assert got.shape == want.shape == (3,) + vol.shape
    assert got.dtype == np.float32
    _assert_close(got, want, f"predict {blend_mode} {dtype} (72,56,40)")
    assert (got[want == 0] == 0).all()
    assert (got[:, :TRIM] == 0).all() and (got[:, :, :TRIM] == 0).all()


class _LazyView:
    """A lazy handle over an in-memory volume (read by slicing)."""

    def __init__(self, arr):
        self.arr, self.shape, self.ndim = arr, arr.shape, arr.ndim

    def __getitem__(self, key):
        return self.arr[key]


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
def test_predict_slabbed_equals_full(runners, volumes, dtype):
    """Slabs recompute their boundary rows to the full call's numbers;
    uint16 input counts each slab prepared on the device, the float32
    volume and a lazy handle none."""
    _, trun = runners
    vol = volumes[dtype]
    n_slabs = len(slab_plan(
        list(patch_grid_ranges(vol.shape, PATCH, OVERLAP)[0]),
        PATCH[0], TRIM, vol.shape[0], 1))
    assert n_slabs > 1
    per_slab = int(dtype == "uint16")
    before = inference.predict.device_prep_slabs
    full = inference.predict(vol, trun, **KW)
    slabbed = inference.predict(vol, trun, max_slab_rows=1, **KW)
    assert inference.predict.device_prep_slabs == (
        before + per_slab * (1 + n_slabs))
    np.testing.assert_allclose(slabbed, full, atol=1e-6)
    before = inference.predict.device_prep_slabs
    lazy = inference.predict(_LazyView(vol), trun, max_slab_rows=1, **KW)
    assert inference.predict.device_prep_slabs == before
    np.testing.assert_allclose(lazy, full, atol=2e-6)


@pytest.mark.parametrize("rows", [None, 1])
def test_predict_predigest_equals_digest_of_floats(runners, volume, rows):
    _, trun = runners
    aff = inference.predict(volume, trun, **KW)
    plan, qaff = inference.predict(volume, trun, predigest=True,
                                   max_slab_rows=rows, **KW)
    want_plan, want_q = predigest.predigest_slab(torch.from_numpy(aff))
    assert plan.dtype == qaff.dtype == np.uint8
    np.testing.assert_array_equal(plan, want_plan.numpy())
    np.testing.assert_array_equal(qaff, want_q.numpy())


@pytest.mark.parametrize("predigest_", [False, True])
def test_predict_empty_grid_returns_zeros(runners, predigest_):
    jrun, trun = runners
    vol = np.zeros((72, 6, 40), np.float32)
    want = jinf.predict(vol, jrun, predigest=predigest_, **KW)
    got = inference.predict(vol, trun, predigest=predigest_, **KW)
    for g, w in zip(got if predigest_ else (got,),
                    want if predigest_ else (want,)):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert not g.any()


def test_predict_5d_input_and_mask_mode(volume):
    fg = inference.load_model(affinity_mode=False, device="cpu",
                              width_multiplier=WIDTH)
    out = inference.predict(volume[None, None], fg, affinity_mode=False,
                            **KW)
    assert out.shape == volume.shape and out.dtype == np.float32
    assert 0 <= out.min() and out.max() <= 1


BAD_CALLS = ["channels", "blend", "out_path", "lazy", "predigest_mask"]


def _bad_call(bad, runners, volume, tmp_path):
    """(img, runner, keywords) of a call ``predict`` and
    ``predict_sharded`` both refuse.
    ``out_path``: a digest needs two stores; ``lazy``: a lazy handle of
    the wrong rank."""
    from aind_exaspim_neuron_segmentation_tpu_torch import io

    _, trun = runners
    args = dict(KW)
    img = volume
    if bad == "channels":
        args["affinity_mode"] = False
    elif bad == "blend":
        args["blend_mode"] = "cosine"
    elif bad == "out_path":
        args.update(out_path="aff.zarr", predigest=True)
    elif bad == "lazy":
        path = str(tmp_path / "v4.zarr")
        io.write_zarr(path, volume[None, :8])
        img = io.read(path)
    else:
        args.update(affinity_mode=False, predigest=True)
        trun = inference.load_model(affinity_mode=False, device="cpu",
                                    width_multiplier=WIDTH)
    return img, trun, args


@pytest.mark.parametrize("bad", BAD_CALLS)
def test_predict_rejects(runners, volume, bad, tmp_path):
    img, trun, args = _bad_call(bad, runners, volume, tmp_path)
    with pytest.raises(ValueError):
        inference.predict(img, trun, **args)


@pytest.mark.parametrize("bad", BAD_CALLS)
def test_predict_sharded_rejects(runners, volume, bad, tmp_path):
    """The same calls on a one-rank mesh: both entries share their checks
    (``predict_sharded`` takes no ``verbose``)."""
    from aind_exaspim_neuron_segmentation_tpu_torch import parallel

    img, trun, args = _bad_call(bad, runners, volume, tmp_path)
    del args["verbose"]
    with pytest.raises(ValueError):
        parallel.predict_sharded(img, trun, mesh=parallel.make_mesh(1),
                                 **args)


@pytest.mark.parametrize("shape", [(72, 56, 40), (33, 56, 40), (58, 30, 9)])
def test_stitch_host_helpers_equal_jax(shape):
    vol = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    got, got_pads = stitch.reflect_pad_to_grid(vol, PATCH, OVERLAP)
    want, want_pads = jstitch.reflect_pad_to_grid(vol, PATCH, OVERLAP)
    assert got_pads == want_pads
    np.testing.assert_array_equal(got, want)
    windows = tuple(jstitch.gaussian_window(p, TRIM, p / 6.0) for p in PATCH)
    for w in (None, windows):
        for a, b in zip(
            stitch.separable_weights(shape, PATCH, OVERLAP, TRIM, w),
            jstitch.separable_weights(shape, PATCH, OVERLAP, TRIM, w),
        ):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(stitch.gaussian_window(32, 4, 5.0),
                                  jstitch.gaussian_window(32, 4, 5.0))


def test_model_runner_layouts(runners):
    _, trun = runners
    x = np.random.default_rng(2).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32)
    first = trun(x)
    last = trun(np.moveaxis(x, 1, -1))
    assert first.shape == (2, 3, 32, 32, 32)
    assert last.shape == (2, 32, 32, 32, 3)
    torch.testing.assert_close(last.movedim(-1, 1), first, rtol=0, atol=0)


def test_to_tensor():
    t = inference.to_tensor(np.ones((4, 4, 4), np.uint16), device="cpu")
    assert t.shape == (1, 1, 4, 4, 4) and t.dtype == torch.float32


# --- predigest -----------------------------------------------------------


def _noisy_affs(shape=(24, 20, 16), seed=0):
    rng = np.random.default_rng(seed)
    aff = rng.uniform(0, 1, (3,) + shape).astype(np.float32)
    flat = aff.ravel()  # exact-threshold and saturated values
    flat[rng.choice(aff.size, 200, replace=False)] = 0.1
    flat[rng.choice(aff.size, 100, replace=False)] = 0.9999
    flat[rng.choice(aff.size, 100, replace=False)] = 1.0
    return aff


@pytest.mark.parametrize("split", [None, 1, 7, 23])
def test_predigest_slab_bytes_equal_jax(split):
    aff = _noisy_affs(seed=3)
    d = aff.shape[1]
    bounds = ((0, d),) if split is None else ((0, split), (split, d))
    prev_j = prev_t = None
    for lo, hi in bounds:
        kw = dict(first_slab=(lo == 0), last_slab=(hi == d))
        jp, jq = jpredigest.predigest_slab(jnp.asarray(aff[:, lo:hi]),
                                           prev_j, **kw)
        tp, tq = predigest.predigest_slab(torch.from_numpy(aff[:, lo:hi]),
                                          prev_t, **kw)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        prev_j = jnp.asarray(aff[0, hi - 1])
        prev_t = torch.from_numpy(aff[0, hi - 1])
    parity_line(f"predigest_slab plan+qaff, split {split}", bytes_equal=True)


# --- import hygiene and no fallback --------------------------------------


def _is_forbidden(name):
    return any(name == p or name.startswith(p + ".")
               for p in ("jax", "flax", "aind_exaspim_neuron_segmentation_tpu"))


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        f"import {PORT}.inference, {PORT}.core, {PORT}.models.convert\n"
        f"import {PORT}.ops.scatter, {PORT}.cuda_build\n"
        f"import {PORT}.native, {PORT}.postprocess.skeleton\n"
        f"import {PORT}.core.affinities, {PORT}.postprocess.streaming\n"
        f"import {PORT}.io, {PORT}.io.zarr_lite, {PORT}.io.tiff_lite\n"
        f"import {PORT}.io.stores, {PORT}.utils.img_util\n"
        f"import {PORT}.utils.retry, {PORT}.ops.predigest, {PORT}.core.device\n"
        f"import {PORT}.__main__, {PORT}.machine_learning\n"
        f"import {PORT}.machine_learning.train\n"
        f"import {PORT}.machine_learning.data_handling\n"
        f"import {PORT}.ops.augment_device, {PORT}.utils.util\n"
        f"import {PORT}.parallel, {PORT}.parallel.stats\n"
        f"import {PORT}.parallel.mesh, {PORT}.parallel.sharded_inference\n"
        f"import {PORT}.utils.profiling, {PORT}.postprocess.distributed\n"
        f"import {PORT}.ops.upsample, {PORT}.models.unet3d\n"
        f"import {PORT}.parallel.sync_batchnorm, {PORT}.core.patches\n"
        f"import {PORT}.entry, {PORT}.parallel.launch, {PORT}.examples\n"
        f"import {PORT}.examples.run_pipeline\n"
        f"import {PORT}.examples.run_beyond_ram\n"
        f"import {PORT}.examples.run_multichip\n"
        f"import {PORT}.tools.beyond_ram_proof, {PORT}.tools.traffic_audit\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'aind_exaspim_neuron_segmentation_tpu') or m.startswith(('jax.', "
        "'flax.', 'aind_exaspim_neuron_segmentation_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_native_build_sources_lie_inside_the_port():
    from aind_exaspim_neuron_segmentation_tpu_torch.native import build

    port = os.path.join(REPO, PORT) + os.sep
    names = sorted(os.path.basename(p) for p in build.sources())
    assert names == ["agglomerate.cpp", "blosc_lite.cpp", "common.hpp",
                     "edt.cpp", "edt.hpp", "jpeg_lite.cpp", "rag.hpp",
                     "remap.cpp", "streamseg.cpp", "teasar.cpp"]
    for path in build.sources() + [build.lib_path()]:
        assert os.path.realpath(path).startswith(port), path
    # zlib always; zstd (and EXA_HAVE_ZSTD) only where the probe found it
    cflags, libs = build.flags()
    zstd = build.have_zstd()
    assert libs == (["-lz", "-lzstd"] if zstd else ["-lz"])
    assert ("-DEXA_HAVE_ZSTD" in cflags) == zstd


def test_engine_build_runs_once_across_processes(tmp_path):
    """Six processes ask for one missing library at once: the build lock
    lets one compiler run; the others wait and find its file."""
    count = tmp_path / "count"
    fake = tmp_path / "fake_cxx.py"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(count)!r}, 'a').write('x')\n"
        "time.sleep(1)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'lib')\n"
    )
    fake.chmod(0o755)
    code = (
        f"from {PORT}.native import build\n"
        f"build.BUILD_DIR = {str(tmp_path)!r}\n"
        f"build.CXX = {str(fake)!r}\n"
        "build.have_zstd = lambda: False\n"
        f"build._ensure_built({str(tmp_path / 'libexaspim_native_x.so')!r})\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO)
             for _ in range(6)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    assert count.read_text() == "x"
    assert (tmp_path / "libexaspim_native_x.so").read_bytes() == b"lib"


def test_port_and_chip_smoke_sources_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _is_forbidden(n)]
            assert not bad, f"{path} imports {bad}"


def _imports(path):
    """(module, names) of every import in a port source file, at module
    level or in a function; ``names`` are those a ``from`` import takes."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, []
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:  # relative: resolve against the file's package
                rel = os.path.relpath(path, REPO)[:-3].split(os.sep)
                module = ".".join(rel[: len(rel) - node.level]
                                  + ([module] if module else []))
            yield module, [alias.name for alias in node.names]


def _port_files(sub):
    root = os.path.join(REPO, PORT, sub)
    return [os.path.join(d, n) for d, _, names in os.walk(root)
            for n in names if n.endswith(".py")]


def test_layers_import_downward():
    """``core`` and ``ops`` import neither ``parallel`` nor ``inference``;
    ``parallel`` imports no private name of ``inference``."""
    upper = (PORT + ".parallel", PORT + ".inference")
    for path in _port_files("core") + _port_files("ops"):
        for module, names in _imports(path):
            targets = [module] + [f"{module}.{n}" for n in names]
            bad = [t for t in targets
                   if any(t == u or t.startswith(u + ".") for u in upper)]
            assert not bad, f"{path} imports {bad}"
    for path in _port_files("parallel"):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for module, names in _imports(path):
            if module == PORT + ".inference":
                assert not [n for n in names if n.startswith("_")], path
        # ``from PORT import inference`` then ``inference._name``
        aliases = {a.asname or a.name for node in ast.walk(tree)
                   if isinstance(node, ast.ImportFrom) and node.module == PORT
                   for a in node.names if a.name == "inference"}
        private = [node.attr for node in ast.walk(tree)
                   if isinstance(node, ast.Attribute)
                   and isinstance(node.value, ast.Name)
                   and node.value.id in aliases
                   and node.attr.startswith("_")]
        assert not private, f"{path} uses inference.{private}"


def test_cuda_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.load_model(width_multiplier=WIDTH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.to_tensor(np.ones((4, 4, 4)))
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
        Trainer,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(str(tmp_path), width_multiplier=WIDTH)
    assert not any(tmp_path.iterdir())


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
