"""The Swin UNETR behind the benchmark's architecture seam.

MONAI's v1 ``SwinUNETR`` (Hatamizadeh et al., arXiv:2201.01266) at the
BTCV widths. The module holds what the seam asks of an architecture
(:mod:`benchmark.models.unet3d` lists it): ``PUBLISHED``, the seeded
float32 :func:`weights` by MONAI's checkpoint keys, the program's
:func:`runner` through ``inference.load_model`` of a MONAI-keyed
``.pth`` in memory, the plain :func:`forward` of
``benchmark/reference/swinunetr.py``, and the counts of
``benchmark/counts/swinunetr.py``.
"""

import io

import numpy as np
import torch

from benchmark.counts import swinunetr as counts
from benchmark.reference import swinunetr as ref

PUBLISHED = {"feature_size": 48, "depths": [2, 2, 2, 2],
             "num_heads": [3, 6, 12, 24], "window": 7, "patch_size": 2,
             "mlp_ratio": 4}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

forward = ref.forward


def widths(cfg):
    """The model's widths from the configuration, as the reference's
    :func:`~benchmark.reference.swinunetr.param_shapes` and the counts
    take them."""
    m = cfg["model"]
    return dict(feature_size=m["feature_size"], depths=tuple(m["depths"]),
                num_heads=tuple(m["num_heads"]), window=m["window"],
                patch_size=m["patch_size"], mlp_ratio=m["mlp_ratio"],
                out_channels=m["out_channels"])


def seeded_weights(seed, device, **kw):
    """float32 weights by MONAI's key, drawn on ``device`` from ``seed``:
    conv and linear weights and biases uniform in +-1/sqrt(fan_in) (a
    transposed conv's fan-in is its output channels times its taps, as
    PyTorch counts it), bias tables N(0, 0.02) clipped at +-0.04,
    LayerNorm weights U(0.8, 1.2) and biases 0.1 N(0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = ref.param_shapes(**kw)
    weights = [k for k, s in shapes.items() if len(s) >= 2
               and not k.endswith("relative_position_bias_table")]
    bound = {}
    for k in weights:
        bound[k] = float(np.prod(shapes[k][1:])) ** -0.5
        b = k[:-len("weight")] + "bias"
        if b in shapes:
            bound[b] = bound[k]
    tables = [k for k in shapes
              if k.endswith("relative_position_bias_table")]
    norms = [k for k in shapes if k not in bound and k not in tables]

    def draw(keys, fn):
        sizes = [int(np.prod(shapes[k])) for k in keys]
        flat = fn(sum(sizes), generator=gen, device=device)
        return {k: t.view(shapes[k]) for k, t in
                zip(keys, torch.split(flat, sizes))}

    p = {k: (t * 2 - 1) * bound[k]
         for k, t in draw(list(bound), torch.rand).items()}
    p.update({k: (t * 0.02).clamp(-0.04, 0.04)
              for k, t in draw(tables, torch.randn).items()})
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
    """A MONAI-keyed ``.pth`` in memory of float32 ``params``, with the
    ``relative_position_index`` buffers a checkpoint carries."""
    sd = {k: v.detach().cpu() for k, v in params.items()}
    window = ref.widths(sd)[3]
    index = ref.position_index(window)
    for k in list(sd):
        if k.endswith("relative_position_bias_table"):
            sd[k[:-len("bias_table")] + "index"] = index.clone()
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    return buf


def runner(cfg, params, device):
    """The program's runner: ``params`` saved as a MONAI-keyed checkpoint
    in memory and loaded through ``inference.load_model`` in the
    configured dtype (it reads the widths from the checkpoint)."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    m = cfg["model"]
    return inference.load_model(
        checkpoint(params), affinity_mode=True, device=device,
        dtype=DTYPES[m["dtype"]], fold_bn=m["fold_bn"])


def conv_layers(cfg, kind):
    """The convs and transposed convs of one patch (the whole patch: the
    model computes it all, whatever the trim)."""
    return counts.conv_layers(cfg[kind]["patch"], **widths(cfg))


def forward_flops(cfg, kind):
    """FLOPs of one patch's forward: convs, linears, attention."""
    return counts.forward_flops(cfg[kind]["patch"], **widths(cfg))
