"""Plain training steps of the published Trainer, in float32.

The published ``machine_learning/train.py`` and ``data_handling.py``
contract, worked out again from the seed and the same inputs:

* :func:`sample_items` draws the sampler's patches: volume by foreground
  weight, 85 % foreground-biased rejection sampling (at most 25 tries,
  more than 10^3 foreground voxels for a foreground patch, fewer for a
  background one), the brightness clip and the per-patch percentile
  scale ``(mn, 1 / (mx - mn + 1e-8))`` in float32;
* :func:`augment` is a frozen copy of the augmentation arithmetic
  (flips, order-0 plane rotations with grid-mirror edges, noise or
  smoothing, contrast), its draws taken from the generator the step's
  ``(seed, epoch, step)`` keys;
* :func:`train_steps` runs the steps in float32 with TF32 off: the
  normalization ``clip((x - mn) * inv, 0, 1)``, the augmentation, the
  affinity targets, the train-mode forward, the per-example mean of the
  BCE with logits averaged over the batch, its gradients, and AdamW
  (lr 1e-3, betas 0.9 / 0.999, eps 1e-8, weight decay 0.01).
"""

import math
import random

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import unet3d as ref_unet
from benchmark.reference.precision import restore_tf32, tf32_off

FOREGROUND_MIN_VOXELS = 10**3


def sample_items(imgs, labs, seed, n_items, patch, clip, percentiles):
    """The first ``n_items`` patches a sampler seeded ``seed`` draws:
    ``(raw uint16 (1, p, p, p), [mn, inv] float32, labels (1, p, p, p))``."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)
    wgts = np.array([float((m > 0).sum()) for m in labs])
    wgts = wgts / wgts.sum()
    half = [s // 2 for s in patch]
    items = []
    for _ in range(n_items):
        is_fg = np_rng.random() > 0.15
        i = int(np_rng.choice(np.arange(len(imgs)), p=wgts))
        shape = labs[i].shape
        for _ in range(25):
            center = [rng.randint(h, d - (s - h))
                      for h, d, s in zip(half, shape, patch)]
            sl = tuple(slice(c - h, c - h + s)
                       for c, h, s in zip(center, half, patch))
            lab = labs[i][sl]
            fg = (lab > 0).sum()
            if fg > FOREGROUND_MIN_VOXELS and is_fg:
                break
            if fg < FOREGROUND_MIN_VOXELS and not is_fg:
                break
        raw = np.minimum(imgs[i][sl], clip)
        mn, mx = np.percentile(raw, percentiles)
        scale = np.array([mn, 1.0 / (mx - mn + 1e-8)], np.float32)
        items.append((raw[None], scale, lab[None]))
    return items


def augment_generator(seed, epoch, step, device):
    """The generator of one step's augmentation draws."""
    words = np.random.SeedSequence(
        [seed + 1, epoch * 100003 + step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(words[0]) | int(words[1]) << 32)


def _mirror(t, n):
    t = torch.remainder(t, 2 * n)
    return torch.where(t >= n, 2 * n - 1 - t, t)


def _rotation_map(angle, h, w):
    dev = angle.device
    rad = angle * torch.tensor(math.pi / 180.0, dtype=torch.float32,
                               device=dev)
    c = torch.cos(rad.double()).float()[:, None, None]
    s = torch.sin(rad.double()).float()[:, None, None]
    ci, cj = (h - 1) / 2.0, (w - 1) / 2.0
    oi = (torch.arange(h, dtype=torch.float32, device=dev) - ci)[:, None]
    oj = (torch.arange(w, dtype=torch.float32, device=dev) - cj)[None, :]
    ii = _mirror(torch.floor(c * oi + s * oj + ci + 0.5).long(), h)
    jj = _mirror(torch.floor(-s * oi + c * oj + cj + 0.5).long(), w)
    return (ii * w + jj).reshape(angle.shape[0], h * w)


def _rotate(x, idx, plane):
    a, b = plane[0] + 2, plane[1] + 2
    x = x.movedim((a, b), (-2, -1))
    moved = x.shape
    flat = x.reshape(moved[0], -1, moved[-2] * moved[-1])
    out = torch.gather(flat, 2, idx[:, None, :].expand_as(flat))
    return out.reshape(moved).movedim((-2, -1), (a, b))


def _smooth(img, sigma, r=3):
    offsets = torch.arange(-r, r + 1, dtype=torch.float32,
                           device=sigma.device)
    safe = torch.clamp(sigma, min=1e-4)[:, None]
    k = torch.exp(-0.5 * torch.square(offsets / safe))
    k = k / k.sum(dim=1, keepdim=True)
    delta = (offsets == 0).float().expand_as(k)
    k = torch.where(sigma[:, None] < 1e-3, delta, k)
    for axis in range(2, 5):
        n = img.shape[axis]
        pad = _mirror(torch.arange(-r, n + r, device=img.device), n)
        x = img.index_select(axis, pad)
        acc = k[:, 0].view(-1, 1, 1, 1, 1) * x.narrow(axis, 0, n)
        for i in range(1, 2 * r + 1):
            acc = acc + k[:, i].view(-1, 1, 1, 1, 1) * x.narrow(axis, i, n)
        img = acc
    return img


def augment(img, label, gen):
    """Augment an (N, 1, D, H, W) float32 image and integer label batch
    with draws from ``gen``; returns (image, label)."""
    b, shape = img.shape[0], img.shape[2:]
    kw = dict(generator=gen, device=gen.device)

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, **kw)

    flip = torch.rand((b, 3), **kw) < 0.5
    rotate = torch.rand((b, 3), **kw) <= 0.8
    angle = uniform(-45.0, 45.0, (b, 3))
    use_noise = torch.rand((b,), **kw) < 0.5
    noise_std = uniform(0.0, 0.16, (b,))
    noise = torch.randn((b, 1) + tuple(shape), **kw)
    sigma = uniform(0.0, 0.8, (b,))
    contrast = uniform(0.8, 1.2, (b,))
    for axis in range(3):
        bit = flip[:, axis].view(-1, 1, 1, 1, 1)
        img = torch.where(bit, img.flip(axis + 2), img)
        label = torch.where(bit, label.flip(axis + 2), label)
    for k, plane in enumerate(((0, 1), (0, 2), (1, 2))):
        h, w = img.shape[plane[0] + 2], img.shape[plane[1] + 2]
        idx = _rotation_map(angle[:, k], h, w)
        keep = torch.arange(h * w, device=idx.device).expand_as(idx)
        idx = torch.where(rotate[:, k, None], idx, keep)
        img = _rotate(img, idx, plane)
        label = _rotate(label, idx, plane)
    per_ex = (-1, 1, 1, 1, 1)
    noisy = img + noise_std.view(per_ex) * noise
    img = torch.where(use_noise.view(per_ex), noisy, _smooth(img, sigma))
    return torch.clamp(img * contrast.view(per_ex), 0.0, 1.0), label


def affinity_targets(label):
    """(N, 3, D, H, W) float32: 1 where a voxel and its next neighbour
    along z, y or x carry the same nonzero label (0 on the last plane)."""
    out = torch.zeros((label.shape[0], 3) + tuple(label.shape[2:]),
                      dtype=torch.float32, device=label.device)
    lab = label[:, 0]
    out[:, 0, :-1] = ((lab[:, 1:] == lab[:, :-1]) & (lab[:, 1:] != 0)).float()
    out[:, 1, :, :-1] = ((lab[:, :, 1:] == lab[:, :, :-1])
                         & (lab[:, :, 1:] != 0)).float()
    out[:, 2, :, :, :-1] = ((lab[:, :, :, 1:] == lab[:, :, :, :-1])
                            & (lab[:, :, :, 1:] != 0)).float()
    return out


def adamw_(p, g, m, v, t, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, wd=0.01):
    """One AdamW update of ``p`` in place (step number ``t`` from 1)."""
    p.mul_(1 - lr * wd)
    m.mul_(betas[0]).add_(g, alpha=1 - betas[0])
    v.mul_(betas[1]).add_(g * g, alpha=1 - betas[1])
    denom = (v / (1 - betas[1] ** t)).sqrt() + eps
    p.sub_(lr / (1 - betas[0] ** t) * m / denom)


def train_steps(params0, batches, keys, device, quant=None, fault=None):
    """Run one optimizer step per ``(raw, scale, labels)`` host batch.

    ``params0``: the starting weights by checkpoint key (float32, any
    device); ``keys``: ``(seed, epoch, step)`` of each step's
    augmentation. ``quant``: the forward's lower-precision control;
    ``fault``: ``"half_batch"`` (the loss over the first half of the
    batch only) or ``"flip_targets"`` (the first example's targets
    inverted), planted faults for the limits' upper readings.
    Returns ``(losses, first gradients, final weights, augmented
    inputs)``, the tensors on the host by key.
    """
    learn = {k: v.detach().to(device, torch.float32).clone()
             for k, v in params0.items() if not k.endswith(
                 ("running_mean", "running_var"))}
    m = {k: torch.zeros_like(v) for k, v in learn.items()}
    v2 = {k: torch.zeros_like(v) for k, v in learn.items()}
    losses, inputs, first = [], [], None
    saved = tf32_off()
    try:
        for t, ((raw, scale, lab), key) in enumerate(zip(batches, keys), 1):
            x = torch.from_numpy(raw.astype(np.float32)).to(device)
            sc = torch.from_numpy(scale).to(device)
            x = torch.clamp((x - sc[:, 0].view(-1, 1, 1, 1, 1))
                            * sc[:, 1].view(-1, 1, 1, 1, 1), 0.0, 1.0)
            y = torch.from_numpy(lab.astype(np.int64)).to(device)
            x, y = augment(x, y, augment_generator(*key, device))
            inputs.append(x.cpu())
            target = affinity_targets(y)
            if fault == "flip_targets":
                target[0] = 1 - target[0]
            if fault == "half_batch":
                x, target = x[: len(x) // 2], target[: len(x) // 2]
            p = {k: w.requires_grad_(True) for k, w in learn.items()}
            logits = ref_unet.forward(p, x, train=True, quant=quant)
            loss = F.binary_cross_entropy_with_logits(
                logits, target, reduction="none").mean(
                    dim=(1, 2, 3, 4)).mean()
            grads = torch.autograd.grad(loss, list(p.values()))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.cpu() for k, g in zip(p, grads)}
            with torch.no_grad():
                for (k, w), g in zip(p.items(), grads):
                    w.requires_grad_(False)
                    adamw_(w, g, m[k], v2[k], t)
            del logits, loss, grads
    finally:
        restore_tf32(saved)
    return losses, first, {k: v.cpu() for k, v in learn.items()}, inputs
