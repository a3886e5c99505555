"""Cases of the PyTorch port that need a CUDA card (``gpu`` marker).

This module imports neither JAX nor the JAX package, so it also runs on a
machine with PyTorch and a card alone (``tests/conftest.py`` imports JAX,
hence ``--noconftest`` there)::

    python -m pytest -m gpu --noconftest -p no:cacheprovider \\
        tests/test_torch_gpu.py

Elsewhere every case skips. The K1 cases are shared with
``tests/test_torch_scatter.py``, which holds the plain version against the
JAX package on the CPU, and so is :func:`parity_line`, with which every
parity test prints its figures (``pytest -s``); predict's two input
preparations, :func:`host_prep` and :func:`device_prep`, are shared with
``tests/test_torch_prep.py``, and :func:`slab_at_once`, the reference for
predict's streamed copy-out, with ``tests/test_torch_copy_out.py``.
"""

import json

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (
    normalize,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (
    patch_grid_ranges,
    patch_starts_array,
    slab_plan,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    is_ndhwc,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import (
    predigest,
    prep,
    scatter,
    stitch,
)

K1_CASES = ("pallas_overlaps", "pallas_untouched", "random_overlapping",
            "grid_rows_aligned")


def k1_case(name):
    """(acc, probs, starts, trim) host arrays for K1, seeded."""
    if name == "grid_rows_aligned":
        # the first 16 of the 27 starts of a 36^3 grid (patch 20, overlap
        # 12, trim 4: cores 12^3 at 4, 12, 20): two Z rows, voxels under up
        # to 8 patches, every core x origin a multiple of 4
        rng = np.random.default_rng(3)
        starts = patch_starts_array((36,) * 3, (20,) * 3, (12,) * 3)[:16]
        return (
            rng.standard_normal((3, 36, 36, 36)).astype(np.float32),
            rng.standard_normal((16, 3, 12, 12, 12)).astype(np.float32),
            starts, 4,
        )
    if name == "pallas_overlaps":  # tests/test_pallas.py, first case
        rng = np.random.default_rng(0)
        return (
            rng.standard_normal((3, 32, 32, 32)).astype(np.float32),
            rng.standard_normal((4, 3, 8, 8, 8)).astype(np.float32),
            np.array([[0, 0, 0], [4, 4, 4], [4, 4, 4], [20, 16, 12]],
                     np.int32),
            2,
        )
    if name == "pallas_untouched":  # tests/test_pallas.py, second case
        return (
            np.random.default_rng(1).standard_normal(
                (1, 16, 16, 16)).astype(np.float32),
            np.ones((1, 1, 4, 4, 4), np.float32),
            np.array([[2, 2, 2]], np.int32),
            0,
        )
    # random overlapping batch with repeated starts and a non-cubic core
    rng = np.random.default_rng(2)
    core, trim, dims = (10, 12, 14), 3, (40, 44, 48)
    starts = np.stack([
        rng.integers(-trim, d - c - trim + 1, 24)
        for c, d in zip(core, dims)
    ], axis=1).astype(np.int32)
    starts[5] = starts[17] = starts[2]
    return (
        rng.standard_normal((3,) + dims).astype(np.float32),
        rng.standard_normal((24, 3) + core).astype(np.float32),
        starts, trim,
    )


def parity_line(what, got=None, want=None, **figures):
    """Print one parity figure as a JSON line: max-abs and MAE of ``got``
    against ``want`` where given, plus ``figures`` (e.g. bytes_equal)."""
    if got is not None:
        d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
        figures = dict(max_abs=float(d.max()), mae=float(d.mean()), **figures)
    print(json.dumps({"parity": what, **figures}))
    return figures


def host_prep(img, clip, patch_shape, overlap, percentiles=(1, 99.9)):
    """``predict``'s host preparation of an in-memory volume: the clip,
    the percentile normalize, the grid's reflect pad (float32)."""
    vol = normalize(np.minimum(img, clip), percentiles=percentiles)
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    return stitch.reflect_pad_to_grid(vol, patch_shape, overlap)[0]


def device_prep(img, clip, patch_shape, overlap, device,
                percentiles=(1, 99.9)):
    """The same of a uint8 / uint16 volume on ``device``, one slab, as
    ``predict`` runs it (:mod:`...ops.prep`); returned on the host."""
    cap = prep.histogram_cap(img.dtype, clip)
    raw = prep.upload(img, cap, device)
    mn, mx = prep.histogram_percentiles(
        prep.clip_histogram([raw], cap), img.size, percentiles, clip)
    pads, fills = stitch.reflect_pad_plan(raw.shape, patch_shape, overlap)
    buf = prep.normalize_padded(raw, mn, mx, clip, pads)
    return stitch.reflect_pad_device(buf, raw.shape, fills).cpu().numpy()


def slab_at_once(img, runner, *, patch_shape, overlap, trim, batch_size,
                 max_slab_rows=None, blend_mode="uniform",
                 affinity_mode=True, clip=1000):
    """``predict``'s float result of a float32 volume composed a slab at a
    time: each slab's whole accumulator
    (``stitch.accumulate_predictions``), then one
    ``stitch.divide_by_weights`` over its owned planes, copied to the
    host. The slabs and the host preparation are ``predict``'s."""
    device = runner.device
    dim = img.shape
    ranges = patch_grid_ranges(dim, patch_shape, overlap)
    z_starts = list(ranges[0])
    vol = np.ascontiguousarray(
        normalize(np.minimum(img, clip), percentiles=(1, 99.9)), np.float32)
    host_windows = windows = None
    if blend_mode == "gaussian":
        host_windows = tuple(stitch.gaussian_window(p, trim, p / 6.0)
                             for p in patch_shape)
        windows = tuple(stitch.host_to_device(w, device)
                        for w in host_windows)
    wz, wy, wx = (stitch.host_to_device(w, device)
                  for w in stitch.separable_weights(
                      dim, patch_shape, overlap, trim, windows=host_windows))
    channels = 3 if affinity_mode else 1
    out = np.zeros((channels,) + dim, np.float32)
    plans = slab_plan(z_starts, patch_shape[0], trim, dim[0],
                      max_slab_rows or len(z_starts))
    for plan in plans:
        in_lo, in_hi = plan["in_range"]
        slab = stitch.reflect_pad_to_grid(
            vol[in_lo:min(in_hi, dim[0])], patch_shape, overlap)[0]
        starts = [(z_starts[r] - in_lo, y, x) for r in plan["rows"]
                  for y in ranges[1] for x in ranges[2]]
        pad = (-len(starts)) % batch_size
        valid = np.repeat(np.float32([1, 0]), [len(starts), pad])
        with torch.inference_mode():
            acc = stitch.accumulate_predictions(
                runner.module, stitch.host_to_device(slab, device),
                np.asarray(starts + starts[:1] * pad, np.int32), valid,
                patch_shape=tuple(patch_shape), trim=trim,
                batch_size=batch_size, out_channels=channels,
                windows=windows)
            lo, hi = plan["own"]
            out[:, lo:hi] = stitch.divide_by_weights(
                acc[:, lo - in_lo: hi - in_lo, : dim[1], : dim[2]],
                wz[lo:hi], wy, wx).cpu().numpy()
    return out if affinity_mode else out[0]


def assert_same_bits(got, want):
    """Equal shapes and float32 bit patterns."""
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture
def cuda():
    """The first CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def no_tf32():
    """TF32 off in cuDNN and cuBLAS for one case, the flags restored
    after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.gpu
@pytest.mark.parametrize("name", K1_CASES)
def test_kernel_bit_identical_on_card(cuda, name):
    acc, probs, starts, trim = k1_case(name)
    acc_d = torch.from_numpy(acc).to(cuda)
    probs_d = torch.from_numpy(probs).to(cuda)
    want = scatter.scatter_batch_reference(acc_d.clone(), probs_d, starts,
                                           trim)
    before = scatter.scatter_batch.launches
    got = scatter.scatter_batch(acc_d.clone(), probs_d,
                                torch.from_numpy(starts).to(cuda), trim=trim,
                                host_starts=starts)
    torch.cuda.synchronize()
    assert scatter.scatter_batch.launches == before + 1
    assert scatter.scatter_batch.last_vec == scatter.launch_plan(
        acc.shape, probs.shape[2:], starts, trim)[2]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_strip_bit_identical_on_card(cuda):
    """One (z, y) row of 16 patches along x, as a ~1024-wide volume gives,
    scaled down: cores 16^3 at x = 4 + 12k overlap their neighbours by 4."""
    rng = np.random.default_rng(4)
    starts = np.array([(0, 0, 12 * k) for k in range(16)], np.int32)
    acc = torch.from_numpy(
        rng.standard_normal((3, 24, 24, 204)).astype(np.float32)).to(cuda)
    probs = torch.from_numpy(
        rng.standard_normal((16, 3, 16, 16, 16)).astype(np.float32)).to(cuda)
    want = scatter.scatter_batch_reference(acc.clone(), probs, starts, 4)
    got = scatter.scatter_batch(acc.clone(), probs,
                                torch.from_numpy(starts).to(cuda), trim=4,
                                host_starts=starts)
    torch.cuda.synchronize()
    assert scatter.scatter_batch.last_vec == 4
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_batch_over_launch_batch_on_card(cuda):
    """80 overlapping patches run as two launches (64, then 16), in order."""
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 13, (80, 3)).astype(np.int32) * 4
    acc = torch.from_numpy(
        rng.standard_normal((3, 72, 72, 72)).astype(np.float32)).to(cuda)
    probs = torch.from_numpy(
        rng.standard_normal((80, 3, 16, 16, 16)).astype(np.float32)).to(cuda)
    want = scatter.scatter_batch_reference(acc.clone(), probs, starts, 4)
    before = scatter.scatter_batch.launches
    got = scatter.scatter_batch(acc.clone(), probs,
                                torch.from_numpy(starts).to(cuda), trim=4,
                                host_starts=starts)
    torch.cuda.synchronize()
    assert scatter.scatter_batch.launches == before + 2
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_predict_on_card_matches_cpu(cuda, no_tf32):
    """float32 predict, TF32 off: card vs CPU within MAE 1e-5 (summation
    order differs); the card's digest equals the CPU digest of its
    floats."""
    kw = dict(width_multiplier=0.25, dtype=torch.float32)
    cpu = inference.load_model(device="cpu", **kw)
    gpu = inference.load_model(device=cuda, **kw)
    vol = np.random.default_rng(0).uniform(0, 2000, (72, 56, 40)).astype(
        np.float32)
    pkw = dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=4,
               batch_size=4, verbose=False)
    want = inference.predict(vol, cpu, **pkw)
    before = scatter.scatter_batch.launches
    got = inference.predict(vol, gpu, **pkw)
    assert scatter.scatter_batch.launches > before
    fig = parity_line("predict float32, card vs CPU", got, want)
    assert fig["mae"] <= 1e-5
    assert fig["max_abs"] <= 1e-4
    plan, qaff = inference.predict(vol, gpu, predigest=True, **pkw)
    want_plan, want_q = predigest.predigest_slab(torch.from_numpy(got))
    np.testing.assert_array_equal(plan, want_plan.numpy())
    np.testing.assert_array_equal(qaff, want_q.numpy())


@pytest.mark.gpu
def test_streamed_copy_out_on_card_equals_slab_at_once(cuda):
    """bf16 predict on the card, its copy-out streamed a chunk a patch
    row (one row a batch: the benchmark's 256^3 grid, and three slabs of
    a small one), holds the slab-at-once composition's bits on the same
    card."""
    runner = inference.load_model(device=cuda, width_multiplier=0.25)
    rng = np.random.default_rng(18)
    for shape, patch, overlap, trim, batch, rows, chunks in (
            ((256,) * 3, 96, 32, 8, 16, None, 4),
            ((64, 48, 48), 32, 16, 4, 4, 1, 3)):
        vol = rng.uniform(0, 1500, shape).astype(np.float32)
        pkw = dict(patch_shape=(patch,) * 3, overlap=(overlap,) * 3,
                   trim=trim, batch_size=batch, max_slab_rows=rows)
        before = inference.predict.copy_out_chunks
        got = inference.predict(vol, runner, verbose=False, **pkw)
        assert inference.predict.copy_out_chunks == before + chunks
        assert_same_bits(got, slab_at_once(vol, runner, **pkw))


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1000, 300, 300.5])
def test_device_prep_on_card_equals_host(cuda, clip):
    """A 256^3 uint16 block prepared on the card (raw upload, histogram
    percentiles, float64 normalize, reflect pad) holds the host's float32
    bits; through ``predict`` it counts one slab prepared there."""
    rng = np.random.default_rng(15)
    img = rng.integers(0, 120, (256,) * 3, dtype=np.uint16)
    img[40:200, 60:70, 100:110] += 350
    img[20:30, 20:30, 20:30] = 60000
    want = host_prep(img, clip, (96,) * 3, (32,) * 3)
    got = device_prep(img, clip, (96,) * 3, (32,) * 3, cuda)
    parity_line(f"device prep 256^3 uint16 clip {clip}, card vs host",
                got, want)
    assert_same_bits(got, want)
    runner = inference.load_model(device=cuda, width_multiplier=0.25)
    before = inference.predict.device_prep_slabs
    inference.predict(img[:96, :96, :96], runner, brightness_clip=clip,
                      verbose=False)
    assert inference.predict.device_prep_slabs == before + 1


@pytest.mark.gpu
def test_on_card_digest_segments_like_the_float_path(cuda):
    """Oracle affinities of two blocks and a bar, made and digested on the
    card: the digest pair segments bit-identically to the float path."""
    from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (
        affinity_channels,
    )

    lab = np.zeros((40, 36, 32), np.int32)
    lab[2:38, 2:12, 3:29] = 7
    lab[2:38, 20:30, 3:29] = 3
    lab[20, 14:18, 2:30] = 9
    aff = affinity_channels(torch.from_numpy(lab).to(cuda))
    plan, qaff = predigest.predigest_slab(aff)
    assert plan.device.type == qaff.device.type == "cuda"
    pair = inference.affinities_to_segmentation((plan, qaff),
                                                min_segment_size=50)
    want = inference.affinities_to_segmentation(aff, min_segment_size=50)
    assert pair.dtype == np.uint32 and pair.max() == 3
    np.testing.assert_array_equal(pair, want)


@pytest.mark.gpu
def test_lazy_out_path_predict_on_card_equals_dense(cuda, tmp_path):
    """A zarr volume streamed by ``predict`` on the card into ``out_path``
    stores (floats, then the digest pair) holds what the dense call
    returns on the same card."""
    from aind_exaspim_neuron_segmentation_tpu_torch import io

    vol = np.random.default_rng(6).integers(0, 1500, (72, 56, 40)).astype(
        np.uint16)
    path = str(tmp_path / "vol.zarr")
    io.write_zarr(path, vol, chunks=(16, 56, 40), compressor={
        "id": "blosc", "cname": "lz4", "shuffle": 1})
    runner = inference.load_model(device=cuda, width_multiplier=0.25)
    pkw = dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=4,
               batch_size=4, verbose=False, max_slab_rows=1)
    want = inference.predict(vol, runner, **pkw)
    got = inference.predict(io.read(path), runner,
                            out_path=str(tmp_path / "aff.zarr"), **pkw)
    fig = parity_line("lazy out_path predict on the card vs dense", got[:],
                      want)
    assert fig["max_abs"] <= 2e-6
    plan, qaff = inference.predict(vol, runner, predigest=True, **pkw)
    lazy_plan, lazy_qaff = inference.predict(
        io.read(path), runner, predigest=True,
        out_path=(str(tmp_path / "p.zarr"), str(tmp_path / "q.zarr")), **pkw)
    np.testing.assert_array_equal(lazy_plan[:], plan)
    np.testing.assert_array_equal(lazy_qaff[:], qaff)


def pre_bn_bias(name):
    """Conv biases that feed a train-mode BatchNorm: BatchNorm removes a
    bias, so their true gradient is zero and what is computed is
    rounding noise."""
    return name.endswith(("double_conv.0.bias", "double_conv.3.bias"))


def box_batch(seed, batch=2, shape=(16, 16, 16)):
    """NCDHW float32 patches in [0, 0.9] and uint16 labels of three boxes
    each (host arrays, as the datasets ship them). The intensities are
    continuous, never clipped: equal values would tie in the max-pools,
    whose gradient then follows the rounding of the forward."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 0.5, (batch, 1) + shape).astype(np.float32)
    y = np.zeros((batch, 1) + shape, np.uint16)
    for b in range(batch):
        for label in (1, 2, 3):
            lo = rng.integers(0, np.array(shape) - 6)
            hi = lo + rng.integers(4, 10, 3)
            y[b, 0, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = label
        x[b, 0][y[b, 0] > 0] += np.float32(0.4)
    return x, y


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda, no_tf32, tmp_path):
    """One float32 train step (TF32 off), width 0.25, 32^3, batch 2, from
    the same seeded weights: loss within 1e-5 relative; per tensor the
    gradients within 1e-3 of the tensor's max-abs gradient (cuDNN's
    float32 gradients lie up to ~2.6e-4 of a tensor's max from float64
    on ``chip_smoke.py``'s batch, where the CPU's lie ~1e-5), the
    pre-BatchNorm conv biases both <= 1e-6 of the largest gradient."""
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.train import (  # noqa: E501
        Trainer,
    )

    x, y = box_batch(5, shape=(32, 32, 32))
    out = {}
    for dev in ("cpu", cuda):
        tr = Trainer(str(tmp_path / str(dev)), batch_size=2,
                     width_multiplier=0.25, use_amp=False, prefetch=False,
                     device=dev)
        loss, _, _ = tr.train_batch(x, y)
        out[str(dev)] = (float(loss), {n: p.grad.cpu().numpy()
                                       for n, p in tr.model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda)]
    assert abs(l_gpu - l_cpu) / abs(l_cpu) <= 1e-5
    top = max(np.abs(g).max() for g in g_cpu.values())
    for name, g in g_cpu.items():
        if pre_bn_bias(name):
            assert np.abs(g).max() <= 1e-6 * top
            assert np.abs(g_gpu[name]).max() <= 1e-6 * top
        else:
            assert np.abs(g_gpu[name] - g).max() <= 1e-3 * np.abs(g).max(), \
                name


@pytest.mark.gpu
def test_augment_on_card_matches_cpu_given_the_draws(cuda):
    """The same draws on the card and the CPU: flips, rotations and labels
    bit-equal; noise, smoothing and contrast within max-abs 1e-6."""
    from aind_exaspim_neuron_segmentation_tpu_torch.ops import augment_device

    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.uniform(0, 1, (4, 1, 24, 20, 28)).astype(
        np.float32))
    lab = torch.from_numpy(rng.integers(0, 50, img.shape).astype(np.int32))
    params = augment_device.draw_augment_params(
        torch.Generator().manual_seed(5), 4, img.shape[2:])
    params["rotate"][0] = True
    dev_params = {k: v.to(cuda) for k, v in params.items()}
    gi_c, gl_c = augment_device.apply_geometric(img, lab, params)
    gi_g, gl_g = augment_device.apply_geometric(img.to(cuda), lab.to(cuda),
                                                dev_params)
    assert torch.equal(gi_g.cpu(), gi_c) and torch.equal(gl_g.cpu(), gl_c)
    want = augment_device.apply_intensity(gi_c, params)
    got = augment_device.apply_intensity(gi_g, dev_params).cpu()
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.gpu
def test_predict_sharded_nccl_world_one_equals_predict(cuda, no_tf32):
    """A process group of one rank over NCCL: ``predict_sharded`` on its
    (1,) mesh gives ``predict``'s floats (the mesh-wide order statistics
    ride NCCL's all_reduce) and digests them like the CPU does."""
    import socket

    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import parallel

    runner = inference.load_model(device=cuda, width_multiplier=0.25,
                                  dtype=torch.float32)
    vol = np.random.default_rng(6).uniform(0, 2000, (80, 56, 40)).astype(
        np.float32)
    kw = dict(patch_shape=(32,) * 3, overlap=(16, 8, 8), trim=2,
              batch_size=4)
    want = inference.predict(vol, runner, verbose=False, **kw)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh(1)
        assert mesh.group is not None
        before = scatter.scatter_batch.launches
        got = parallel.predict_sharded(vol, runner, mesh=mesh, **kw)
        assert scatter.scatter_batch.launches > before
        np.testing.assert_array_equal(got, want)
        plan, qaff = parallel.predict_sharded(vol, runner, mesh=mesh,
                                              predigest=True, **kw)
    finally:
        dist.destroy_process_group()
    want_plan, want_q = predigest.predigest_slab(torch.from_numpy(got))
    np.testing.assert_array_equal(plan, want_plan.numpy())
    np.testing.assert_array_equal(qaff, want_q.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last_3d],
                         ids=["ncdhw", "ndhwc"])
@pytest.mark.parametrize("fused", [False, True], ids=["bn", "folded"])
def test_valid_region_forward_on_card_equals_sliced_full(cuda, no_tf32,
                                                         fused, layout):
    """``UNet3D(valid_trim=t)`` on the card, float32 (TF32 off), width
    0.25, 32^3, laid out NCDHW or channels-last (as ``load_model`` lays it
    out on a card): within MAE 1e-5 of the sliced full forward. The
    row-ranged upsample is ``F.interpolate``'s own rows, so only cuDNN's
    choice of algorithm for the unpadded convs could move a value
    (measured on the H100: no value moves)."""
    from aind_exaspim_neuron_segmentation_tpu_torch.models.convert import (
        fold_batchnorm,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
        init_weights,
    )

    net = UNet3D(output_channels=3, width_multiplier=0.25)
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
        net = UNet3D(output_channels=3, width_multiplier=0.25, fused_bn=True)
        net.load_state_dict(state)
    net = net.to(cuda).eval().to(memory_format=layout)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1, 32, 32, 32)).astype(np.float32)).to(cuda)
    before = UNet3D.ndhwc_forwards
    with torch.no_grad():
        full = net(x)
        for t in (2, 4, 8):
            fast = net(x, valid_trim=t)
            fig = parity_line(
                f"valid_trim={t} fused={fused} on the card vs sliced full",
                fast.cpu().numpy(),
                full[:, :, t:-t, t:-t, t:-t].cpu().numpy())
            assert fig["mae"] <= 1e-5, (t, fig)
    ndhwc = layout == torch.channels_last_3d
    assert UNet3D.ndhwc_forwards - before == (4 if ndhwc else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_sync_batchnorm_world_one_on_card_equals_native(cuda, dtype):
    """The synchronized BatchNorm with no process group (world size 1)
    against ``nn.BatchNorm3d`` on the card, two train steps. Float32:
    outputs, input gradients, weight and bias gradients and running
    statistics within 1e-5 relative of the native module's. Bf16 input
    (float32 parameters, as under autocast): both held to the native
    module in float64 on the same bf16 values, the outputs and input
    gradients within 2^-7 relative (one bf16 rounding), the rest within
    1e-4 (float32 sums); the native bf16 module's own figures print
    beside them."""
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel.sync_batchnorm import (  # noqa: E501
        SyncBatchNorm3d,
    )

    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.normal(0.5, 1.5, (4, 8, 12, 12, 12)).astype(
        np.float32)).to(cuda, dtype)
    dy = torch.from_numpy(rng.standard_normal(x0.shape).astype(
        np.float32)).to(cuda, dtype)

    def run(cls, x0, dy, param_dtype):
        bn = cls(8).to(cuda, param_dtype).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 8))
            bn.bias.copy_(torch.linspace(-0.3, 0.3, 8))
        x = x0.clone().requires_grad_(True)
        for _ in range(2):
            bn(x).backward(dy)
        return dict(y=bn(x).detach(), dx=x.grad, dweight=bn.weight.grad,
                    dbias=bn.bias.grad, running_mean=bn.running_mean,
                    running_var=bn.running_var)

    def rel(got, want):
        return {k: float((got[k].double() - want[k].double()).abs().max()
                         / want[k].double().abs().max()) for k in want}

    native = run(torch.nn.BatchNorm3d, x0, dy, torch.float32)
    sync = run(SyncBatchNorm3d, x0, dy, torch.float32)
    if dtype == torch.float32:
        figures = rel(sync, native)
        parity_line("SyncBatchNorm3d world 1 vs nn.BatchNorm3d on the card "
                    "(float32)", **figures)
        assert max(figures.values()) <= 1e-5, figures
        return
    exact = run(torch.nn.BatchNorm3d, x0.double(), dy.double(),
                torch.float64)
    figures, native_figures = rel(sync, exact), rel(native, exact)
    parity_line("SyncBatchNorm3d world 1, bf16 input, vs float64 on the card",
                **figures)
    parity_line("nn.BatchNorm3d, bf16 input, vs float64 on the card",
                **native_figures)
    for key, value in figures.items():
        assert value <= (2 ** -7 if key in ("y", "dx") else 1e-4), (key,
                                                                   value)


@pytest.mark.gpu
def test_swin_unetr_bf16_forward_on_card_within_the_cell_limits(cuda):
    """The Swin UNETR at its published widths (feature size 48, depths
    2-2-2-2, heads 3-6-12-24, window 7), built by ``load_model`` from a
    MONAI-keyed checkpoint of seeded weights, bf16 on the card: one batch
    of 16 normalized 96^3 tube patches, whose affinities' central 80^3
    (trim 8) lie within the limits of ``swinunetr_affinity_infer`` of the
    plain float32 reference's (TF32 off)."""
    from benchmark import harness, inputs
    from benchmark.models import swinunetr as arch
    from benchmark.reference.precision import restore_tf32, tf32_off

    cfg = harness.load_json("configs", "swinunetr_affinity_infer.json")
    params = arch.weights(cfg, 17, cuda, None)
    runner = arch.runner(cfg, params, cuda)
    assert runner.module.out.conv.conv.weight.dtype == torch.bfloat16
    block = inputs.tube_volume(17, 0, 192, 32, 4, 120, 350)[0]
    img = normalize(np.minimum(block, 1000), percentiles=(1, 99.9))
    x = torch.from_numpy(np.stack([
        img[z:z + 96, y:y + 96, w:w + 96]
        for z in (0, 96) for y in (0, 48, 96) for w in (0, 32, 64, 96)
    ][:16])[:, None].astype(np.float32)).to(cuda)
    before = UNet3D.ndhwc_forwards
    with torch.inference_mode():
        got = torch.sigmoid(runner.module(x, valid_trim=8).float())
    assert UNet3D.ndhwc_forwards == before
    saved = tf32_off()
    try:
        with torch.no_grad():
            want = torch.cat([torch.sigmoid(arch.forward(params, part))
                              for part in x.split(4)])
    finally:
        restore_tf32(saved)
    want = want[:, :, 8:-8, 8:-8, 8:-8]
    fig = parity_line("Swin UNETR bf16 on the card vs float32 reference",
                      got.cpu().numpy(), want.cpu().numpy())
    limits = cfg["limits"]
    assert fig["mae"] <= limits["aff_mae"], fig
    assert fig["max_abs"] <= limits["aff_max_abs"], fig


def tube_patches(device):
    """16 normalized 96^3 patches of a seeded 192^3 uint16 tube volume
    (the benchmark's generator) and the volume itself."""
    from benchmark import inputs

    block = inputs.tube_volume(17, 0, 192, 32, 4, 120, 350)[0]
    img = normalize(np.minimum(block, 1000), percentiles=(1, 99.9))
    starts = [(z, y, w) for z in (0, 96) for y in (0, 48, 96)
              for w in (0, 32, 64, 96)][:16]
    return torch.from_numpy(img.astype(np.float32)).to(device), starts, block


@pytest.mark.gpu
def test_unet3d_runner_is_channels_last_and_within_the_cell_limits(cuda):
    """``load_model``'s UNet3D runner on the card is channels-last: at full
    width, bf16, BatchNorm folded (``unet3d_affinity_infer``), one
    ``forward_batch`` of 16 tube patches of 96^3 at trim 8 runs NDHWC and
    lies within that cell's limits of the plain float32 NCDHW reference's
    affinities (TF32 off)."""
    from benchmark import harness
    from benchmark.models import unet3d as arch
    from benchmark.reference.precision import restore_tf32, tf32_off

    cfg = harness.load_json("configs", "unet3d_affinity_infer.json")
    volume, starts, block = tube_patches(cuda)
    params = arch.weights(cfg, 17, cuda, block)
    runner = arch.runner(cfg, params, cuda)
    convs = [m.weight for m in runner.module.modules()
             if isinstance(m, torch.nn.Conv3d) and m.weight.shape[2] > 1
             and m.weight.shape[1] > 1]
    assert len(convs) == 17 and all(is_ndhwc(w) for w in convs)
    assert runner.module.outc.conv.weight.dtype == torch.bfloat16
    starts_dev = torch.tensor(starts, dtype=torch.int32, device=cuda)
    before = UNet3D.ndhwc_forwards
    with torch.inference_mode():
        got = stitch.forward_batch(
            runner.module, volume, starts_dev,
            torch.ones(16, device=cuda), patch_shape=(96,) * 3, trim=8)
    assert UNet3D.ndhwc_forwards == before + 1
    assert got.is_contiguous() and got.shape == (16, 3, 80, 80, 80)
    x = torch.stack([volume[z:z + 96, y:y + 96, w:w + 96]
                     for z, y, w in starts])[:, None]
    saved = tf32_off()
    try:
        with torch.no_grad():
            want = torch.cat([torch.sigmoid(arch.forward(params, part))
                              for part in x.split(4)])
    finally:
        restore_tf32(saved)
    want = want[:, :, 8:-8, 8:-8, 8:-8]
    fig = parity_line("UNet3D bf16 NDHWC on the card vs float32 reference",
                      got.cpu().numpy(), want.cpu().numpy())
    limits = cfg["limits"]
    assert fig["mae"] <= limits["aff_mae"], fig
    assert fig["max_abs"] <= limits["aff_max_abs"], fig


@pytest.mark.gpu
def test_predict_on_card_runs_every_batch_ndhwc(cuda):
    """``predict`` of a 256^3 block at the benchmark's grid (patch 96,
    overlap 32: 64 patches, batch 16) counts four NDHWC forwards."""
    runner = inference.load_model(device=cuda, width_multiplier=0.25)
    vol = np.random.default_rng(20).uniform(0, 1500, (256,) * 3).astype(
        np.float32)
    before = UNet3D.ndhwc_forwards
    inference.predict(vol, runner, patch_shape=(96,) * 3,
                      overlap=(32,) * 3, trim=8, batch_size=16,
                      verbose=False)
    assert UNet3D.ndhwc_forwards - before == 4
