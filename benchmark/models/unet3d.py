"""The UNet3D behind the benchmark's architecture seam.

A configuration names its model in ``model.architecture``, and the
harness finds ``benchmark/models/<architecture in lower case>.py``
(:func:`benchmark.harness.model_module`). Such a module holds:

* ``PUBLISHED``: the architecture's published widths, which every
  configuration of it keeps (the layout tests hold the file to them);
* :func:`weights`: the seeded float32 weights by checkpoint key, made
  once and handed to the program and to the reference alike;
* :func:`runner`: the program's runner of those weights, built through
  the port's ``inference.load_model``;
* :func:`forward`: the plain float32 reference forward of one batch of
  patches (``quant="fp8"``: the control), from ``benchmark/reference/``;
* :func:`forward_flops` and :func:`conv_layers`: the analytic counts of
  one patch that the metric readers use.

The training cells' set-up (:mod:`benchmark.training`) is the UNet3D's
alone and calls :func:`conv_weights` and :func:`checkpoint_state` here.
"""

import io

import numpy as np
import torch

from benchmark.counts import unet3d as counts
from benchmark.reference import unet3d as ref_unet
from benchmark.reference.precision import restore_tf32, tf32_off

PUBLISHED = {"channels": [32, 64, 128, 256, 512], "width": 1.0}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

forward = ref_unet.forward


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
    saved = tf32_off()
    try:
        ref_unet.forward(p, x.to(device), calibrate=True)
    finally:
        restore_tf32(saved)
    return p


def weights(cfg, seed, device, block):
    """The predict cell's float32 weights: :func:`calibrated_weights` on
    the pool's first ``block``."""
    m, p = cfg["model"], cfg["predict"]
    return calibrated_weights(
        seed, device, block, width=m["width"],
        out_channels=m["out_channels"], clip=p["clip"],
        percentiles=tuple(p["percentiles"]))


def checkpoint_state(params):
    """A state dict of ``params`` under the checkpoint keys, with the
    BatchNorm counters a checkpoint carries."""
    sd = dict(params)
    for k in list(sd):
        if k.endswith(".running_mean"):
            sd[k[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return sd


def checkpoint(params):
    """A ``.pth`` in memory of float32 ``params``."""
    buf = io.BytesIO()
    torch.save(checkpoint_state({k: v.detach().cpu()
                                 for k, v in params.items()}), buf)
    buf.seek(0)
    return buf


def runner(cfg, params, device):
    """The program's runner: ``params`` saved as a checkpoint in memory
    and loaded through ``inference.load_model`` in the configured dtype,
    BatchNorm folded as configured."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    m = cfg["model"]
    return inference.load_model(
        checkpoint(params), affinity_mode=True, device=device,
        dtype=DTYPES[m["dtype"]], width_multiplier=m["width"],
        fold_bn=m["fold_bn"])


def conv_layers(cfg, kind):
    """The convs of one patch: ``kind="predict"`` as predict runs them
    (the valid-region decoder at the configured trim), ``"train"`` the
    full forward."""
    m, s = cfg["model"], cfg[kind]
    trim = s["trim"] if kind == "predict" else 0
    return counts.conv_layers(s["patch"], trim, m["width"],
                              m["out_channels"])


def forward_flops(cfg, kind):
    """FLOPs of one patch's forward (see :func:`conv_layers`)."""
    return counts.forward_flops(conv_layers(cfg, kind))
