"""Augmentation in the port against the JAX package, on the CPU.

* Host ``ImageTransforms`` and each host transform: the same generator
  calls and scipy calls, so a seed gives identical arrays (exact).
* Device augmentation (``ops.augment_device``) given the JAX package's
  own draws, rebuilt here from the key tree of ``augment_batch``
  (``split(key, (3, B))``; per example three ``split(k, 3)`` for the
  plane rotations; ``split(k, 5)`` for the intensity): flips exact;
  rotation index maps and rotated labels equal except where a float32
  coordinate lies at a ``.5`` tie, at most 0.5 % of voxels (the bound
  the JAX package's own tests allow against scipy); noise, smoothing and
  contrast within max-abs 1e-6.

Each comparison prints a ``{"parity": ...}`` line (``pytest -s``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from aind_exaspim_neuron_segmentation_tpu.machine_learning import (
    augmentation as jaug,
)
from aind_exaspim_neuron_segmentation_tpu.ops import augment_device as jdev
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
    augmentation as aug,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import augment_device
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

TIE_BOUND = 0.005


def assert_same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


# --- host pipeline ------------------------------------------------------


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_image_transforms_equal_jax(rank, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (12, 14, 10)).astype(np.float32)
    lab = (rng.uniform(0, 1, (12, 14, 10)) > 0.6).astype(np.uint32) * 5
    if rank == 4:
        img, lab = img[None], lab[None]
    port, ref = aug.ImageTransforms(seed=seed), jaug.ImageTransforms(seed=seed)
    for k in range(4):
        gi, gl = port(img, lab)
        wi, wl = ref(img, lab)
        assert_same(np.ascontiguousarray(gi), np.ascontiguousarray(wi),
                    f"image, call {k}")
        assert_same(np.ascontiguousarray(gl), np.ascontiguousarray(wl),
                    f"label, call {k}")
    parity_line(f"ImageTransforms seed {seed} rank {rank}, 4 calls",
                bytes_equal=True)


@pytest.mark.parametrize("name", ["RandomFlip3D", "RandomRotation3D",
                                  "RandomScale3D"])
def test_geometric_transforms_equal_jax(name):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (1, 10, 11, 12)).astype(np.float32)
    lab = (rng.uniform(0, 1, (1, 10, 11, 12)) > 0.5).astype(np.uint32)
    for seed in range(3):
        got = getattr(aug, name)()(img, lab, rng=np.random.default_rng(seed))
        want = getattr(jaug, name)()(img, lab,
                                     rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert_same(np.ascontiguousarray(g), np.ascontiguousarray(w),
                        name)


@pytest.mark.parametrize("name", ["RandomContrast3D", "RandomNoise3D",
                                  "RandomSmooth3D"])
def test_intensity_transforms_equal_jax(name):
    img = np.random.default_rng(4).uniform(0, 1, (9, 10, 11)).astype(
        np.float32)
    for seed in range(3):
        got = getattr(aug, name)()(img, rng=np.random.default_rng(seed))
        want = getattr(jaug, name)()(img, rng=np.random.default_rng(seed))
        assert_same(got, want, name)
    assert aug.RandomContrast3D((1.5, 1.5))(np.ones((4, 4, 4))).max() <= 1.0


# --- device pipeline given the JAX draws --------------------------------


def jax_draws(key, batch, shape):
    """The draws of the JAX package's ``augment_batch(key, ...)`` for a
    (batch, D, H, W, 1) input, as :func:`draw_augment_params` tensors."""
    keys = jax.random.split(key, (3, batch))
    out = {k: [] for k in ("flip", "rotate", "angle", "use_noise",
                           "noise_std", "noise", "sigma", "contrast")}
    for b in range(batch):
        out["flip"].append(np.asarray(
            jax.random.bernoulli(keys[0][b], 0.5, (3,))))
        k, rot, ang = keys[1][b], [], []
        for _ in range(3):
            k, k_coin, k_angle = jax.random.split(k, 3)
            rot.append(jax.random.uniform(k_coin, ()) <= jdev.ROTATE_PROB)
            ang.append(jax.random.uniform(
                k_angle, (), minval=-jdev.ROTATE_MAX_DEG,
                maxval=jdev.ROTATE_MAX_DEG))
        out["rotate"].append(np.asarray(rot))
        out["angle"].append(np.asarray(ang, np.float32))
        k_coin, k_std, k_noise, k_sigma, k_con = jax.random.split(
            keys[2][b], 5)
        out["use_noise"].append(np.asarray(jax.random.bernoulli(k_coin, 0.5)))
        out["noise_std"].append(np.asarray(jax.random.uniform(
            k_std, (), minval=0.0, maxval=jdev.NOISE_MAX_STD)))
        out["noise"].append(np.moveaxis(np.asarray(
            jax.random.normal(k_noise, tuple(shape) + (1,))), -1, 0))
        out["sigma"].append(np.asarray(jax.random.uniform(
            k_sigma, (), minval=0.0, maxval=jdev.SMOOTH_MAX_SIGMA)))
        out["contrast"].append(np.asarray(jax.random.uniform(
            k_con, (), minval=jdev.CONTRAST_RANGE[0],
            maxval=jdev.CONTRAST_RANGE[1])))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def _ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def batch_inputs(batch, shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (batch,) + shape + (1,)).astype(np.float32)
    # voxel ids as labels: every geometric map is readable off the output
    ids = np.arange(np.prod(shape), dtype=np.int32).reshape(shape) + 1
    return img, np.broadcast_to(ids[..., None], img.shape).copy()


def test_mirror_index_equals_jax():
    t = np.arange(-70, 71, dtype=np.int32)
    for n in (1, 2, 3, 7, 16):
        want = np.asarray(jdev._mirror_index(jnp.asarray(t), n))
        got = augment_device.mirror_index(torch.from_numpy(t).long(), n)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 16, 20), (13, 11, 9)])
def test_rotation_index_maps_equal_jax_but_ties(shape):
    worst = 0.0
    for a, b in augment_device.PLANES:
        h, w = shape[a], shape[b]
        angles = np.array([-44.9, -41.3, -17.0, -0.0, 9.6, 28.7, 45.0],
                          np.float32)
        got = augment_device.plane_rotation_indices(
            torch.from_numpy(angles), h, w).numpy()
        for k, angle in enumerate(angles):
            want = np.asarray(jdev._plane_rotation_indices(
                jnp.float32(angle), h, w))
            worst = max(worst, float(np.mean(got[k] != want)))
    parity_line(f"rotation index maps {shape}, 3 planes x 7 angles",
                mismatch_share=worst)
    assert worst <= TIE_BOUND


def test_rotation_matches_scipy_but_ties():
    rng = np.random.default_rng(7)
    vol = rng.integers(0, 1000, (13, 11, 9)).astype(np.float32)
    x = torch.from_numpy(vol)[None, None]
    for plane in augment_device.PLANES:
        for angle in (-41.3, -17.0, 9.6, 28.7, 44.9):
            h, w = vol.shape[plane[0]], vol.shape[plane[1]]
            idx = augment_device.plane_rotation_indices(
                torch.tensor([angle], dtype=torch.float32), h, w)
            got = augment_device.rotate_plane(x, idx, plane)[0, 0].numpy()
            want = aug.rotate3d(vol, angle, plane)
            assert np.mean(got != want) <= TIE_BOUND, (plane, angle)


def test_flips_equal_jax():
    img, lab = batch_inputs(4, (8, 10, 12), seed=1)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want_img, want_lab = jax.vmap(jdev._flip_one)(keys, jnp.asarray(img),
                                                  jnp.asarray(lab))
    params = {"flip": torch.from_numpy(np.stack([
        np.asarray(jax.random.bernoulli(k, 0.5, (3,))) for k in keys])),
        "rotate": torch.zeros((4, 3), dtype=torch.bool),
        "angle": torch.zeros((4, 3))}
    assert params["flip"].any() and not params["flip"].all()
    got_img, got_lab = augment_device.apply_geometric(
        _ncdhw(img), _ncdhw(lab), params)
    assert_same(_ndhwc(got_img), np.asarray(want_img), "flipped image")
    assert_same(_ndhwc(got_lab), np.asarray(want_lab), "flipped labels")
    parity_line("device flips (4, 8, 10, 12)", bytes_equal=True)


@pytest.mark.parametrize("sigma", [0.0005, 0.3, 0.7, 0.8])
def test_smooth_equals_jax_and_scipy(sigma):
    img = np.random.default_rng(1).uniform(0, 1, (2, 10, 9, 8, 1)).astype(
        np.float32)
    got = augment_device.smooth(_ncdhw(img), torch.full((2,), sigma))
    want = np.stack([np.asarray(jdev._smooth_one(jnp.asarray(v),
                                                 jnp.float32(sigma)))
                     for v in img])
    fig = parity_line(f"device smoothing sigma {sigma}", _ndhwc(got), want)
    assert fig["max_abs"] <= 1e-6
    if sigma >= 1e-3:
        scipy = ndimage.gaussian_filter(img[0, ..., 0], sigma=sigma,
                                        radius=3)
        np.testing.assert_allclose(got[0, 0].numpy(), scipy, atol=1e-5)


@pytest.mark.parametrize("batch,shape,seed", [(4, (16, 16, 16), 0),
                                              (3, (12, 16, 20), 6)])
def test_augment_batch_equals_jax_given_its_draws(batch, shape, seed):
    img, lab = batch_inputs(batch, shape, seed)
    key = jax.random.PRNGKey(seed)
    want_img, want_lab = jax.jit(jdev.augment_batch)(
        key, jnp.asarray(img), jnp.asarray(lab))
    want_img, want_lab = np.asarray(want_img), np.asarray(want_lab)
    params = jax_draws(key, batch, shape)
    assert params["rotate"].any() and params["use_noise"].any()
    assert not params["use_noise"].all()
    got_img, got_lab = augment_device.apply_augment(
        _ncdhw(img), _ncdhw(lab), params)
    got_img, got_lab = _ndhwc(got_img), _ndhwc(got_lab)
    assert got_lab.dtype == want_lab.dtype and got_img.dtype == np.float32
    # the labels are voxel ids: where they differ, a tie rounded the other
    # way; intensities are compared away from such voxels (smoothing
    # reaches 3 voxels)
    tie = got_lab != want_lab
    share = float(tie.mean())
    near_tie = np.stack([ndimage.binary_dilation(
        t[..., 0], np.ones((3, 3, 3), bool), iterations=3) for t in tie])
    d = np.abs(got_img[..., 0] - want_img[..., 0])[~near_tie]
    parity_line(f"augment_batch given JAX draws {(batch,) + shape}",
                got_img[..., 0][~near_tie], want_img[..., 0][~near_tie],
                label_mismatch_share=share)
    assert share <= TIE_BOUND
    assert d.size > 0.9 * near_tie.size and d.max() <= 1e-6


def test_draw_augment_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(3)
    p = augment_device.draw_augment_params(gen, 64, (4, 5, 6))
    assert p["flip"].shape == p["rotate"].shape == p["angle"].shape == (64, 3)
    assert p["flip"].dtype == p["rotate"].dtype == torch.bool
    assert p["noise"].shape == (64, 1, 4, 5, 6)
    assert p["angle"].abs().max() <= 45
    assert 0 <= p["noise_std"].min() and p["noise_std"].max() <= 0.16
    assert 0 <= p["sigma"].min() and p["sigma"].max() <= 0.8
    assert 0.8 <= p["contrast"].min() and p["contrast"].max() <= 1.2
    assert 0.6 < p["rotate"].float().mean() < 0.95
    again = augment_device.draw_augment_params(
        torch.Generator().manual_seed(3), 64, (4, 5, 6))
    for k in p:
        assert torch.equal(p[k], again[k]), k


def test_apply_augment_keeps_labels_and_range():
    img, lab = batch_inputs(3, (12, 12, 12), seed=2)
    lab = (lab % 7 == 0).astype(np.int32) * 9
    params = augment_device.draw_augment_params(
        torch.Generator().manual_seed(0), 3, (12, 12, 12))
    params["rotate"][:] = False
    out_img, out_lab = augment_device.apply_augment(_ncdhw(img), _ncdhw(lab),
                                                    params)
    assert out_img.shape == (3, 1, 12, 12, 12) and out_lab.dtype == torch.int32
    assert 0 <= out_img.min() and out_img.max() <= 1
    # flips alone permute voxels: the foreground count is kept
    np.testing.assert_array_equal((out_lab > 0).sum(dim=(1, 2, 3, 4)),
                                  (lab > 0).sum(axis=(1, 2, 3, 4)))
