"""Batched training augmentation on the device (torch, NCDHW).

The counterpart of the host ``machine_learning.augmentation`` pipeline
that the train step runs on the card: per-example random flips of
(image, label) over the three spatial axes, per spatial plane a p=0.8
rotation by U(-45, 45) degrees (order 0, grid-mirror edges), then
image-only intensity jitter -- a fair coin between gaussian noise
(sigma ~ U(0, 0.16)) and gaussian smoothing (sigma ~ U(0, 0.8)), then
contrast U(0.8, 1.2) clipped to [0, 1]. Labels take the geometric
transforms only; the affinity targets are computed after them, which
keeps edge directions consistent.

Two steps: :func:`draw_augment_params` draws every random number of a
batch from one ``torch.Generator`` (on its device), and
:func:`apply_augment` applies them -- deterministic given the draws, so
the same draws give the same batch on the card and on the CPU, and the
JAX package's own draws can be fed through it.

Rotation is one flat gather per plane: the output->input index map is
computed from the angle in float32 with the JAX package's operation
order, nearest sample by ``floor(x + 0.5)``, out-of-range indices folded
by grid mirror (:func:`mirror_index`). The angle's cosine and sine are
taken in float64 and rounded to float32, so the card and the CPU get the
same index maps.
"""

import math

import torch

NOISE_MAX_STD = 0.16
SMOOTH_MAX_SIGMA = 0.8
CONTRAST_RANGE = (0.8, 1.2)
SMOOTH_RADIUS = 3  # scipy's int(4 * sigma_max + 0.5) at 0.8
ROTATE_PROB = 0.8
ROTATE_MAX_DEG = 45.0
# spatial planes of a (D, H, W) patch, in the host pipeline's order
PLANES = ((0, 1), (0, 2), (1, 2))


def draw_augment_params(generator, batch, shape):
    """Every random draw of one batch, on ``generator``'s device.

    ``shape`` is the spatial (D, H, W) patch shape. Returns a dict of
    tensors: ``flip`` (B, 3) bool, ``rotate`` (B, 3) bool and ``angle``
    (B, 3) float32 degrees per plane of :data:`PLANES`, ``use_noise``
    (B,) bool, ``noise_std`` (B,), ``noise`` (B, 1, D, H, W) standard
    normal, ``sigma`` (B,) and ``contrast`` (B,).
    """
    kw = dict(generator=generator, device=generator.device)

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, **kw)

    return {
        "flip": torch.rand((batch, 3), **kw) < 0.5,
        "rotate": torch.rand((batch, 3), **kw) <= ROTATE_PROB,
        "angle": uniform(-ROTATE_MAX_DEG, ROTATE_MAX_DEG, (batch, 3)),
        "use_noise": torch.rand((batch,), **kw) < 0.5,
        "noise_std": uniform(0.0, NOISE_MAX_STD, (batch,)),
        "noise": torch.randn((batch, 1) + tuple(shape), **kw),
        "sigma": uniform(0.0, SMOOTH_MAX_SIGMA, (batch,)),
        "contrast": uniform(*CONTRAST_RANGE, (batch,)),
    }


def mirror_index(t, n):
    """Fold integer indices into [0, n) by grid mirror (scipy
    ``mode='grid-mirror'``, numpy ``'symmetric'``): period 2n with the
    edge sample repeated. ``torch.remainder`` is a floor modulo, as the
    fold needs for negative ``t``."""
    t = torch.remainder(t, 2 * n)
    return torch.where(t >= n, 2 * n - 1 - t, t)


def plane_rotation_indices(angle_deg, h, w):
    """(B, h*w) int64 flat gather maps for order-0, shape-preserving
    rotations of an (h, w) plane by the (B,) float32 angles.

    scipy.ndimage.rotate(angle, reshape=False, order=0,
    mode='grid-mirror') semantics: input coordinate = R @ (output -
    center) + center with R = [[cos, sin], [-sin, cos]], nearest sample
    by floor(x + 0.5), out-of-range indices grid-mirror folded.
    """
    dev = angle_deg.device
    rad = angle_deg * torch.tensor(math.pi / 180.0, dtype=torch.float32,
                                   device=dev)
    c = torch.cos(rad.double()).float()[:, None, None]
    s = torch.sin(rad.double()).float()[:, None, None]
    ci, cj = (h - 1) / 2.0, (w - 1) / 2.0
    oi = (torch.arange(h, dtype=torch.float32, device=dev) - ci)[:, None]
    oj = (torch.arange(w, dtype=torch.float32, device=dev) - cj)[None, :]
    ii = torch.floor(c * oi + s * oj + ci + 0.5)
    jj = torch.floor(-s * oi + c * oj + cj + 0.5)
    ii = mirror_index(ii.long(), h)
    jj = mirror_index(jj.long(), w)
    return (ii * w + jj).reshape(angle_deg.shape[0], h * w)


def rotate_plane(x, idx, plane):
    """Gather spatial ``plane`` (a pair of axes of D, H, W) of an
    (N, C, D, H, W) tensor through the (N, h*w) flat maps ``idx``."""
    a, b = plane[0] + 2, plane[1] + 2
    x = x.movedim((a, b), (-2, -1))
    moved = x.shape
    flat = x.reshape(moved[0], -1, moved[-2] * moved[-1])
    out = torch.gather(flat, 2, idx[:, None, :].expand_as(flat))
    return out.reshape(moved).movedim((-2, -1), (a, b))


def apply_geometric(img, label, params):
    """Flips, then the per-plane rotations, of an (N, C, D, H, W) image
    and label batch; the same maps for both."""
    flip = params["flip"]
    for axis in range(3):
        bit = flip[:, axis].view(-1, 1, 1, 1, 1)
        img = torch.where(bit, img.flip(axis + 2), img)
        label = torch.where(bit, label.flip(axis + 2), label)
    for k, plane in enumerate(PLANES):
        h, w = img.shape[plane[0] + 2], img.shape[plane[1] + 2]
        idx = plane_rotation_indices(params["angle"][:, k], h, w)
        keep = torch.arange(h * w, device=idx.device).expand_as(idx)
        idx = torch.where(params["rotate"][:, k, None], idx, keep)
        img = rotate_plane(img, idx, plane)
        label = rotate_plane(label, idx, plane)
    return img, label


def gaussian_kernels(sigma):
    """(B, 2R+1) normalized kernels; a delta where sigma < 1e-3."""
    r = SMOOTH_RADIUS
    offsets = torch.arange(-r, r + 1, dtype=torch.float32,
                           device=sigma.device)
    safe = torch.clamp(sigma, min=1e-4)[:, None]
    k = torch.exp(-0.5 * torch.square(offsets / safe))
    k = k / k.sum(dim=1, keepdim=True)
    delta = (offsets == 0).float().expand_as(k)
    return torch.where(sigma[:, None] < 1e-3, delta, k)


def smooth(img, sigma):
    """Separable gaussian blur of an (N, C, D, H, W) batch, one sigma per
    example. Edges repeat the edge sample (scipy's default
    ``mode='reflect'``), by index; the taps are summed in order."""
    k = gaussian_kernels(sigma)
    r = SMOOTH_RADIUS
    for axis in range(2, 5):
        n = img.shape[axis]
        pad = mirror_index(torch.arange(-r, n + r, device=img.device), n)
        x = img.index_select(axis, pad)
        acc = k[:, 0].view(-1, 1, 1, 1, 1) * x.narrow(axis, 0, n)
        for i in range(1, 2 * r + 1):
            acc = acc + k[:, i].view(-1, 1, 1, 1, 1) * x.narrow(axis, i, n)
        img = acc
    return img


def apply_intensity(img, params):
    """Noise or smoothing by the example's coin, then contrast and clip
    to [0, 1]."""
    per_ex = (-1, 1, 1, 1, 1)
    noisy = img + params["noise_std"].view(per_ex) * params["noise"]
    img = torch.where(params["use_noise"].view(per_ex), noisy,
                      smooth(img, params["sigma"]))
    return torch.clamp(img * params["contrast"].view(per_ex), 0.0, 1.0)


def apply_augment(img, label, params):
    """Augment an (N, 1, D, H, W) image and label batch with ``params``
    (:func:`draw_augment_params`); returns (image, label)."""
    img, label = apply_geometric(img, label, params)
    return apply_intensity(img, params), label
