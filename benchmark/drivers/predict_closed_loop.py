"""Closed loop of ``inference.predict`` calls over a pool of blocks in RAM.

One caller, as a brain is processed block after block: each call starts
when the last has returned its affinities on the host. The blocks are
seeded uint16 tube volumes, cycled in order. The model is the
configuration's architecture (``benchmark/models/``): its weights made
from the seed, and its runner built from them through the program's
``load_model``.

The check: a sample of the window's calls, drawn from the seed
(reservoir sampling), is held to the plain reference's float32 affinities
of the same block (the architecture's reference forward): the mean and
the largest absolute gap.
"""

import random

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.reference import predict as ref_predict


def predict_kwargs(cfg):
    """``inference.predict``'s keyword arguments of the configuration."""
    p = cfg["predict"]
    return dict(batch_size=p["batch_size"], brightness_clip=p["clip"],
                normalization_percentiles=tuple(p["percentiles"]),
                patch_shape=(p["patch"],) * 3, overlap=(p["overlap"],) * 3,
                trim=p["trim"], blend_mode=p["blend"], verbose=False)


def make_inputs(cfg, traffic, seed, device, arch):
    """The block pool and the float32 weights of one seed."""
    t = traffic
    blocks = [inputs.tube_volume(seed, k, t["block"], t["tubes"],
                                 t["radius"], t["noise"], t["bright"])[0]
              for k in range(t["pool"])]
    return blocks, arch.weights(cfg, seed, device, blocks[0])


def reference(cfg, block, params, device, arch, quant=None):
    """The plain reference's affinities of ``block``."""
    p = cfg["predict"]
    return ref_predict.predict(
        block, params, device, arch.forward, patch=(p["patch"],) * 3,
        overlap=(p["overlap"],) * 3, trim=p["trim"], clip=p["clip"],
        percentiles=tuple(p["percentiles"]), quant=quant)


def gaps(got, want):
    """``[("aff_mae", ...), ("aff_max_abs", ...)]`` of two affinity
    arrays; a wrong shape or a non-finite value reads infinite."""
    if got.shape != want.shape or not np.isfinite(got).all():
        return [("aff_mae", float("inf")), ("aff_max_abs", float("inf"))]
    diff = np.abs(got.astype(np.float64) - want)
    return [("aff_mae", float(diff.mean())),
            ("aff_max_abs", float(diff.max()))]


def control_readings(cfg, traffic, seed, device):
    """``{"control_fp8": gaps}``: the reference with float8 convolutions
    put in the program's place, against the float32 reference, on the
    pool's first block."""
    arch = harness.model_module(cfg)
    blocks, params = make_inputs(cfg, traffic, seed, device, arch)
    want = reference(cfg, blocks[0], params, device, arch)
    got = reference(cfg, blocks[0], params, device, arch, quant="fp8")
    return {"control_fp8": gaps(got, want)}


class Session:
    """The program's runner and the block pool of one run."""

    span = "bench.predict"

    def __init__(self, ctx):
        from aind_exaspim_neuron_segmentation_tpu_torch import inference

        self.ctx, self.cfg, self.traffic = ctx, ctx.cfg, ctx.traffic
        self.predict = inference.predict
        clock = harness.Phases()
        self.arch = harness.model_module(self.cfg)
        self.blocks, self.params = make_inputs(
            self.cfg, self.traffic, ctx.seed, ctx.device, self.arch)
        clock.mark("inputs")
        self.runner = self.arch.runner(self.cfg, self.params, ctx.device)
        clock.mark("load_model")
        self.kw = predict_kwargs(self.cfg)
        self.rng = random.Random(ctx.seed)
        self.sample = []  # reservoir of (call, block index, affinities)
        self.calls = 0
        for _ in range(self.traffic["warm_calls"]):
            self.predict(self.blocks[0], self.runner, **self.kw)
            clock.mark("warm call")
        self.phases = clock.text()

    def step(self):
        """One ``predict`` call on the next block; returns its voxels."""
        k = self.calls % len(self.blocks)
        out = self.predict(self.blocks[k], self.runner, **self.kw)
        n = self.traffic["sample"]
        if len(self.sample) < n:
            self.sample.append((self.calls, k, out))
        else:
            j = self.rng.randrange(self.calls + 1)
            if j < n:
                self.sample[j] = (self.calls, k, out)
        self.calls += 1
        return float(self.blocks[k].size)

    def counters(self):
        """The blocks the window finished."""
        return {"blocks": self.calls}

    def describe(self):
        """One line on the window's calls."""
        block = self.traffic["block"]
        return f"set-up {self.phases}; {self.calls} blocks of {block}^3"

    def free(self):
        """Drop the program's model and cached device memory."""
        self.runner = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """The worst gaps of the sampled calls to the reference."""
        worst = {}
        cache = {}
        for _, k, out in self.sample:
            if k not in cache:
                cache[k] = reference(self.cfg, self.blocks[k], self.params,
                                     self.ctx.device, self.arch)
            for name, v in gaps(out, cache[k]):
                worst[name] = max(worst.get(name, 0.0), v)
        self.numbers = sorted(worst.items())
        return self.numbers


def setup(ctx):
    """Build the session of one run."""
    return Session(ctx)
