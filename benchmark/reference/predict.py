"""Plain sliding-window affinity prediction of one block, in float32.

The published ``inference.predict`` semantics, written out without the
program: brightness clip, percentile min-max normalization over the whole
block (``np.percentile``, linear interpolation, float64 arithmetic), the
patch grid (starts ``range(0, dim - patch + stride, stride)``, the last
patch reflect-padded at its end), the architecture's plain float32
forward of each patch (the caller hands it in), sigmoid, a
``trim``-voxel border dropped, every patch's core added into an
accumulator in grid order, and the sum divided by the number of cores
that cover each voxel (0 where none does).
"""

import itertools

import numpy as np
import torch

from benchmark.reference.precision import restore_tf32, tf32_off


def normalize(block, clip, percentiles):
    """Clipped, percentile-normalized float32 copy of a uint16 block."""
    img = np.minimum(block, clip)
    mn, mx = np.percentile(img, percentiles)
    img = (img - mn) / (mx - mn + 1e-8)
    return np.clip(img, 0, 1).astype(np.float32)


def grid(shape, patch, overlap):
    """Patch starts of the grid, (z, y, x) in row-major order."""
    axes = [range(0, d - p + (p - o), p - o)
            for d, p, o in zip(shape, patch, overlap)]
    return list(itertools.product(*axes))


def cut_patch(img, start, patch):
    """The patch at ``start``, clipped to the block and reflect-padded at
    the end of each axis it overhangs."""
    sl = tuple(slice(s, s + p) for s, p in zip(start, patch))
    part = img[sl]
    pad = [(0, p - n) for p, n in zip(patch, part.shape)]
    return np.pad(part, pad, mode="reflect") if any(w for _, w in pad) \
        else part


@torch.no_grad()
def predict(block, params, device, forward, *, patch, overlap, trim, clip,
            percentiles, batch=8, quant=None):
    """(3, D, H, W) float32 affinities of a uint16 block, on the host.

    ``forward(params, x, quant=quant)`` gives the logits of a float32
    (N, 1, D, H, W) batch of patches from ``params``, the float32 weights
    by checkpoint key; ``batch`` patches run at a time (it changes no
    number).
    """
    img = normalize(block, clip, percentiles)
    starts = grid(block.shape, patch, overlap)
    core = tuple(p - 2 * trim for p in patch)
    acc = torch.zeros((3,) + block.shape, dtype=torch.float32,
                      device=device)
    hits = torch.zeros(block.shape, dtype=torch.float32, device=device)
    saved = tf32_off()
    try:
        for lo in range(0, len(starts), batch):
            part = starts[lo:lo + batch]
            x = torch.from_numpy(np.stack(
                [cut_patch(img, s, patch) for s in part])[:, None])
            prob = torch.sigmoid(forward(params, x.to(device), quant=quant))
            for (z, y, x0), pr in zip(part, prob):
                sl = tuple(slice(s + trim, min(s + trim + c, d))
                           for s, c, d in zip((z, y, x0), core, block.shape))
                keep = pr[(slice(None),) + tuple(
                    slice(trim, trim + (s.stop - s.start)) for s in sl)]
                acc[(slice(None),) + sl] += keep
                hits[sl] += 1
    finally:
        restore_tf32(saved)
    out = torch.where(hits > 0, acc / torch.clamp(hits, min=1), 0.0)
    return out.cpu().numpy()
