"""SegMamba behind the benchmark's architecture seam.

SegMamba (Xing et al., arXiv:2401.13560) as ge-xing/SegMamba's
``SegMamba(in_chans=1, out_chans=3, depths=[2, 2, 2, 2],
feat_size=[48, 96, 192, 384])`` builds it. The module holds what the seam
asks of an architecture (:mod:`benchmark.models.unet3d` lists it):
``PUBLISHED``, the seeded float32 :func:`weights` by SegMamba's checkpoint
keys, the program's :func:`runner` through ``inference.load_model`` of a
SegMamba-keyed ``.pth`` in memory, the plain :func:`forward` of
``benchmark/reference/segmamba.py``, and the counts of
``benchmark/counts/segmamba.py``.
"""

import io
import math

import numpy as np
import torch

from benchmark.counts import segmamba as counts
from benchmark.reference import segmamba as ref

PUBLISHED = {"depths": [2, 2, 2, 2], "feat_size": [48, 96, 192, 384],
             "hidden_size": 768, "d_state": 16, "d_conv": 4, "expand": 2}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Mamba's dt_proj initialisation: dt log-uniform in [DT_MIN, DT_MAX]
DT_MIN, DT_MAX = 1e-3, 1e-1

forward = ref.forward


def widths(cfg):
    """The model's widths from the configuration, as the reference's
    :func:`~benchmark.reference.segmamba.param_shapes` and the counts
    take them."""
    m = cfg["model"]
    return dict(in_channels=m["in_channels"], out_channels=m["out_channels"],
                depths=tuple(m["depths"]), feat_size=tuple(m["feat_size"]),
                hidden_size=m["hidden_size"], d_state=m["d_state"],
                d_conv=m["d_conv"], expand=m["expand"])


def seeded_weights(seed, device, **kw):
    """float32 weights by SegMamba's key, drawn on ``device`` from
    ``seed``: conv, linear and transposed-conv weights and biases uniform
    in +-1/sqrt(fan_in) (PyTorch's fan-in: the weight's second dimension
    times its taps), LayerNorm weights U(0.8, 1.2) and biases 0.1 N(0, 1);
    Mamba's own initialisation elsewhere: ``A_log = log(1..16)`` for every
    channel, ``D = 1``, and ``dt_proj.bias = softplus^-1(dt)`` with ``dt``
    log-uniform in [1e-3, 1e-1]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ref.param_shapes(**kw)
    bound = {}
    for k, s in shapes.items():
        if k.endswith("weight") and len(s) >= 2:
            bound[k] = float(np.prod(s[1:])) ** -0.5
            b = k[:-len("weight")] + "bias"
            if b in shapes and ".dt_proj" not in b:
                bound[b] = bound[k]
    dt = [k for k in shapes if ".dt_proj" in k and k.endswith("bias")]
    a_log = [k for k in shapes if k.endswith("_log")]
    skips = [k for k in shapes if k.rsplit(".", 1)[-1] in ("D", "D_b", "D_s")]
    norms = [k for k in shapes
             if k not in bound and k not in dt + a_log + skips]

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
    lo, hi = math.log(DT_MIN), math.log(DT_MAX)
    for k, t in draw(dt, torch.rand).items():
        step = torch.exp(lo + (hi - lo) * t)
        p[k] = step + torch.log(-torch.expm1(-step))  # softplus^-1
    for k in a_log:
        d, states = shapes[k]
        p[k] = torch.log(torch.arange(1, states + 1, dtype=torch.float32,
                                      device=device)).repeat(d, 1)
    p.update({k: torch.ones(shapes[k], device=device) for k in skips})
    return {k: p[k] for k in shapes}


def weights(cfg, seed, device, block):
    """The predict cell's float32 weights (no statistics to calibrate:
    the model has no BatchNorm, so ``block`` is not read)."""
    return seeded_weights(seed, device, **widths(cfg))


def checkpoint(params):
    """A SegMamba-keyed ``.pth`` in memory of float32 ``params``."""
    buf = io.BytesIO()
    torch.save({k: v.detach().cpu() for k, v in params.items()}, buf)
    buf.seek(0)
    return buf


def runner(cfg, params, device):
    """The program's runner: ``params`` saved as a SegMamba-keyed
    checkpoint in memory and loaded through ``inference.load_model`` in
    the configured dtype (it reads the widths from the checkpoint)."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    return inference.load_model(checkpoint(params), affinity_mode=True,
                                device=device,
                                dtype=DTYPES[cfg["model"]["dtype"]])


def conv_layers(cfg, kind):
    """The convs, transposed convs and causal ``conv1d``s of one patch
    (the whole patch: the model computes it all, whatever the trim)."""
    return counts.conv_layers(cfg[kind]["patch"], **widths(cfg))


def forward_flops(cfg, kind):
    """FLOPs of one patch's forward: its convs and linears."""
    return counts.forward_flops(cfg[kind]["patch"], **widths(cfg))
