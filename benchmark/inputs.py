"""Volumes made from ``--seed``: the same seed, the same bytes.

Volumes are made on the host in bulk (the program reads them from host
memory, as a user's block or training volume arrives) and handed to the
program and to the reference alike. Weights are the architecture's
(``benchmark/models/``).
"""

import numpy as np


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

