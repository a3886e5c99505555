"""Shared arithmetic of the metric readers in ``metrics/``.

A reader's ``read(rec)`` gets the run's record: ``setup_s``,
``window_s`` (host clock), ``work`` (voxels or patches finished),
``calls``, ``counters`` (what the program counted), ``cfg``, ``traffic``,
``peaks`` (the card's published rates, None off a known card) and
``trace`` (a :class:`benchmark.trace.Trace` in a traced run, else None).
"""

import numpy as np

from benchmark import harness


def traced(rec):
    """The run's trace where the device ran something in it, else None."""
    t = rec.get("trace")
    return t if t is not None and t.busy_s > 0 else None


def idle_pct(rec):
    """Share of the traced window in which the device ran nothing, %."""
    t = traced(rec)
    return None if t is None else 100.0 * (1.0 - t.busy_s / t.window_s)


def is_conv(name):
    """An aten convolution op, forward or backward."""
    return name in ("aten::convolution", "aten::convolution_backward")


def is_batchnorm(name):
    """An aten BatchNorm op, forward or backward."""
    return name.startswith("aten::") and "batch_norm" in name


def is_k1(name):
    """Kernel K1, the blend scatter-add."""
    return "scatter_blend" in name


def share(least_s, took_s):
    """``least_s`` over ``took_s`` in %, None where nothing was timed."""
    return None if not took_s else 100.0 * least_s / took_s


def least_s(rec, flops, nbytes, flops_key="bf16_flops_s"):
    """The least time of ``flops`` and ``nbytes`` at the card's peaks."""
    p = rec["peaks"]
    return max(flops / p[flops_key], nbytes / p["hbm_bytes_s"])


def real_patches(rec):
    """Patches of the grid of one block of the predict cell."""
    p, block = rec["cfg"]["predict"], rec["traffic"]["block"]
    stride = p["patch"] - p["overlap"]
    return len(range(0, block - p["patch"] + stride, stride)) ** 3


def predict_grid(rec):
    """``(starts per block, padded block shape, batch)`` of the predict
    cell: the patch grid of one block, padded to whole batches with the
    first start, as ``predict`` runs it."""
    p, block = rec["cfg"]["predict"], rec["traffic"]["block"]
    stride = p["patch"] - p["overlap"]
    axis = list(range(0, block - p["patch"] + stride, stride))
    starts = np.array([(z, y, x) for z in axis for y in axis for x in axis])
    pad = (-len(starts)) % p["batch_size"]
    starts = np.concatenate([starts, np.repeat(starts[:1], pad, 0)])
    padded = (axis[-1] + p["patch"],) * 3
    return starts, padded, p["batch_size"]


def model(rec):
    """The module of the run's architecture (``benchmark/models/``)."""
    return harness.model_module(rec["cfg"])


def predict_layers(rec):
    """The convs of one patch of the predict cell, as its architecture
    counts them (the UNet3D's: the valid-region decoder at the configured
    trim)."""
    return model(rec).conv_layers(rec["cfg"], "predict")


def train_layers(rec):
    """The convs of one patch of a training cell (the full forward)."""
    return model(rec).conv_layers(rec["cfg"], "train")
