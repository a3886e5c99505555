"""Inputs and weights made from ``--seed``: the same seed, the same bytes.

Volumes are made on the host in bulk (the program reads them from host
memory, as a user's block or training volume arrives); weights are made
on the run's device by one ``torch.Generator`` in a few large calls. Both
are handed to the program and to the reference alike.
"""

import numpy as np
import torch

from benchmark.reference import unet3d as ref_unet


def tube_labels(shape, n, radius, rng):
    """int32 labels of ``n`` straight tubes of ``radius`` along z, y and x
    in turn, each spanning the volume but 8 voxels at either end.

    Tube centres lie on two lattices 24 voxels apart, ``A`` (8 + 24 i)
    and ``B`` (20 + 24 i): along z at (y, x) in A x A, along y at (z, x)
    in A x B, along x at (z, y) in B x B, so no two tubes touch. Labels
    are distinct random ids.
    """
    lat_a = 8 + 24 * np.arange((min(shape) - 20) // 24)
    lat_b = lat_a + 12
    cells = {0: (lat_a, lat_a), 1: (lat_a, lat_b), 2: (lat_b, lat_b)}
    lab = np.zeros(shape, np.int32)
    ids = rng.choice(1 << 20, n, replace=False).astype(np.int32) + 1
    r = np.arange(-radius, radius + 1)
    disc = (r[:, None] ** 2 + r[None, :] ** 2) <= radius * radius
    used = {0: set(), 1: set(), 2: set()}
    for k in range(n):
        axis = k % 3
        u_lat, v_lat = cells[axis]
        while True:
            cell = (int(rng.choice(u_lat)), int(rng.choice(v_lat)))
            if cell not in used[axis]:
                used[axis].add(cell)
                break
        plane = np.zeros(tuple(s for a, s in enumerate(shape) if a != axis),
                         bool)
        u, v = cell
        plane[u - radius:u + radius + 1, v - radius:v + radius + 1] = disc
        span = [slice(None)] * 3
        span[axis] = slice(8, shape[axis] - 8)
        view = np.moveaxis(lab[tuple(span)], axis, 0)
        view[:, plane] = ids[k]
    return lab


def tube_volume(seed, k, size, tubes, radius, noise, bright):
    """(uint16 image, int32 labels) number ``k`` of ``seed``: uniform
    noise in ``[0, noise)`` with ``bright`` added on the tubes."""
    rng = np.random.default_rng([seed, k])
    lab = tube_labels((size,) * 3, tubes, radius, rng)
    img = rng.integers(0, noise, lab.shape, dtype=np.uint16)
    img[lab > 0] += np.uint16(bright)
    return img, lab


def conv_weights(seed, device, width=1.0, out_channels=3):
    """Conv weights and biases of the model, uniform in +-1/sqrt(fan_in)
    (PyTorch's default bound), drawn on ``device`` in one call; BatchNorm
    at weight 1, bias 0, mean 0, variance 1. float32, by checkpoint key."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ref_unet.param_shapes(width, out_channels)
    convs = [k for k in shapes if k.endswith(".weight")
             and len(shapes[k]) == 5]
    sizes = []
    for k in convs:
        sizes += [int(np.prod(shapes[k])), shapes[k][0]]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    parts = iter(torch.split(flat, sizes))
    p = {}
    for k in convs:
        w_shape = shapes[k]
        bound = float(np.prod(w_shape[1:])) ** -0.5
        p[k] = next(parts).view(w_shape) * bound
        p[k[:-len("weight")] + "bias"] = next(parts) * bound
    for k, s in shapes.items():
        if k in p:
            continue
        fill = 1.0 if k.endswith(("weight", "running_var")) else 0.0
        p[k] = torch.full(s, fill, device=device)
    return p


@torch.no_grad()
def calibrated_weights(seed, device, block, width=1.0, out_channels=3,
                       clip=1000, percentiles=(1, 99.9)):
    """Inference weights with the statistics a trained checkpoint carries.

    :func:`conv_weights`, BatchNorm affine terms drawn from the seed
    (weight U(0.8, 1.2), bias 0.1 N(0, 1)), and running statistics from
    one float32 train-mode forward over the two corner 96^3 patches of the
    normalized uint16 ``block`` (the batch's mean and unbiased variance),
    so that activations neither fade nor saturate layer by layer.
    """
    p = conv_weights(seed, device, width, out_channels)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    bn_w = [k for k in p if k.endswith(".weight") and p[k].dim() == 1]
    sizes = [p[k].numel() for k in bn_w]
    u = torch.split(torch.rand(sum(sizes), generator=gen, device=device),
                    sizes)
    n = torch.split(torch.randn(sum(sizes), generator=gen, device=device),
                    sizes)
    for k, a, b in zip(bn_w, u, n):
        p[k] = 0.8 + 0.4 * a
        p[k[:-len("weight")] + "bias"] = 0.1 * b
    img = np.minimum(block, clip)
    mn, mx = np.percentile(img, percentiles)
    img = np.clip((img - mn) / (mx - mn + 1e-8), 0, 1).astype(np.float32)
    x = torch.from_numpy(np.stack([img[:96, :96, :96],
                                   img[-96:, -96:, -96:]])[:, None])
    saved = ref_unet.tf32_off()
    try:
        ref_unet.forward(p, x.to(device), calibrate=True)
    finally:
        ref_unet.restore_tf32(saved)
    return p
