"""Readings that the limits of a cell's check are set from.

    python benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 21 22 23] [--seconds 2]

For every ``--seeds`` seed it runs the cell as ``run.py`` does, with a
short window, and prints each number its check compares (the program's
readings: the limit's lower end). For every ``--control-seeds`` seed it
prints the same numbers for the control, the plain reference computed
with float8 convolutions put in the program's place (the limit's upper
end), and, for a training cell, for the planted faults: half of the batch
left out, and the first example's targets inverted. One JSON object per
line on standard output. Needs the card, as the benchmark does.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def control_readings(cell, seed, device, overrides=None):
    """``{kind: [(name, value), ...]}`` of the control, and of a training
    cell's planted faults, on one seed."""
    spec = harness.load_spec()
    entry = next(w for w in spec["workloads"] if w["name"] == cell)
    overrides = overrides or {}
    cfg = harness.merged(
        harness.load_json("configs", entry["config"] + ".json"),
        overrides.get("config"))
    traffic = harness.merged(
        harness.load_json("traffic", entry["traffic"] + ".json"),
        overrides.get("traffic"))
    if "predict" in cfg:
        from benchmark.drivers import predict_closed_loop as drv

        blocks, params = drv.make_inputs(cfg, traffic, seed, device)
        want = drv.reference(cfg, blocks[0], params, device)
        got = drv.reference(cfg, blocks[0], params, device, quant="fp8")
        return {"control_fp8": drv.gaps(got, want)}
    from benchmark import inputs, training
    from benchmark.reference import train as ref_train

    imgs, labs = training.make_volumes(cfg, seed)
    m = cfg["model"]
    p0 = {k: v.cpu() for k, v in inputs.conv_weights(
        seed, device, m["width"], m["out_channels"]).items()
        if not k.endswith(("running_mean", "running_var"))}
    batches = training.reference_batches(cfg, imgs, labs, seed)
    keys = [(seed, 0, s) for s in range(training.CHECKED_STEPS)]
    ref = ref_train.train_steps(p0, batches, keys, device)
    out = {}
    for kind, kw in (("control_fp8", dict(quant="fp8")),
                     ("fault_half_batch", dict(fault="half_batch")),
                     ("fault_flip_targets", dict(fault="flip_targets"))):
        losses, grads, weights, xs = ref_train.train_steps(
            p0, batches, keys, device, **kw)
        prog = dict(losses=losses, grads=grads, weights=weights, inputs=xs)
        leaves = []
        out[kind] = training.compare(prog, ref, p0, leaves) + [
            ("worst_leaves", leaves)]
    return out


def main(argv=None):
    """Command line."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    harness.fix_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, _ = harness.run_cell(args.workload, seed, args.seconds, 0,
                                     quiet=True, keep=(sessions := []))
        print(json.dumps({"kind": "program", "seed": seed,
                          "correct": result["correct"],
                          "numbers": dict(sessions[0].numbers),
                          "worst_leaves": getattr(sessions[0],
                                                  "worst_leaves", None),
                          "s": time.perf_counter() - t0}), flush=True)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        for kind, numbers in control_readings(
                args.workload, seed, torch.device("cuda")).items():
            print(json.dumps({"kind": kind, "seed": seed,
                              "numbers": dict(numbers),
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
