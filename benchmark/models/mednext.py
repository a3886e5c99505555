"""MedNeXt behind the benchmark's architecture seam.

MedNeXt v1 (Roy et al., arXiv:2303.09975) as MIC-DKFZ/MedNeXt's
``create_mednext_v1(1, 3, "L", kernel_size=5)`` builds it. The module
holds what the seam asks of an architecture (:mod:`benchmark.models.unet3d`
lists it): ``PUBLISHED``, the seeded float32 :func:`weights` by MedNeXt's
checkpoint keys, the program's :func:`runner` through
``inference.load_model`` of a MedNeXt-keyed ``.pth`` in memory, the plain
:func:`forward` of ``benchmark/reference/mednext.py``, and the counts of
``benchmark/counts/mednext.py``.
"""

import io

import numpy as np
import torch

from benchmark.counts import mednext as counts
from benchmark.reference import mednext as ref

PUBLISHED = {"n_channels": 32, "exp_r": [3, 4, 8, 8, 8, 8, 8, 4, 3],
             "block_counts": [3, 4, 8, 8, 8, 8, 8, 4, 3], "kernel_size": 5}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

forward = ref.forward


def widths(cfg):
    """The model's widths from the configuration, as the reference's
    :func:`~benchmark.reference.mednext.param_shapes` and the counts take
    them."""
    m = cfg["model"]
    return dict(n_channels=m["n_channels"], exp_r=tuple(m["exp_r"]),
                block_counts=tuple(m["block_counts"]),
                kernel_size=m["kernel_size"], in_channels=m["in_channels"],
                out_channels=m["out_channels"])


def seeded_weights(seed, device, **kw):
    """float32 weights by MedNeXt's key, drawn on ``device`` from
    ``seed``: conv and transposed-conv weights and biases uniform in
    +-1/sqrt(fan_in) (PyTorch's fan-in: the weight's second dimension
    times its taps, so one tap set a depthwise channel), GroupNorm weights
    U(0.8, 1.2) and biases 0.1 N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ref.param_shapes(**kw)
    bound = {}
    for k, s in shapes.items():
        if len(s) == 5:
            bound[k] = float(np.prod(s[1:])) ** -0.5
            bound[k[:-len("weight")] + "bias"] = bound[k]
    norms = [k for k in shapes if k not in bound]

    def draw(keys, fn):
        sizes = [int(np.prod(shapes[k])) for k in keys]
        flat = fn(sum(sizes), generator=gen, device=device)
        return {k: t.view(shapes[k]) for k, t in
                zip(keys, torch.split(flat, sizes))}

    p = {k: (t * 2 - 1) * bound[k]
         for k, t in draw(list(bound), torch.rand).items()}
    u = draw(norms, torch.rand)
    n = draw(norms, torch.randn)
    p.update({k: 0.8 + 0.4 * u[k] if k.endswith("weight") else 0.1 * n[k]
              for k in norms})
    return {k: p[k] for k in shapes}


def weights(cfg, seed, device, block):
    """The predict cell's float32 weights (no statistics to calibrate:
    the model has no BatchNorm, so ``block`` is not read)."""
    return seeded_weights(seed, device, **widths(cfg))


def checkpoint(params):
    """A MedNeXt-keyed ``.pth`` in memory of float32 ``params``, with the
    ``dummy_tensor`` a MedNeXt training checkpoint carries."""
    sd = {k: v.detach().cpu() for k, v in params.items()}
    sd["dummy_tensor"] = torch.ones(1)
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    return buf


def runner(cfg, params, device):
    """The program's runner: ``params`` saved as a MedNeXt-keyed
    checkpoint in memory and loaded through ``inference.load_model`` in
    the configured dtype (it reads the widths from the checkpoint)."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    return inference.load_model(checkpoint(params), affinity_mode=True,
                                device=device,
                                dtype=DTYPES[cfg["model"]["dtype"]])


def conv_layers(cfg, kind):
    """The convs and transposed convs of one patch (the whole patch: the
    model computes it all, whatever the trim)."""
    return counts.conv_layers(cfg[kind]["patch"], **widths(cfg))


def forward_flops(cfg, kind):
    """FLOPs of one patch's forward: its convs and transposed convs."""
    return counts.forward_flops(cfg[kind]["patch"], **widths(cfg))
