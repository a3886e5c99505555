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
    cell's planted faults, on one seed: the cell's driver's own
    ``control_readings``."""
    cfg, traffic = harness.cell_inputs(harness.load_spec(), cell,
                                       overrides)
    driver = harness.load_module("drivers", traffic["driver"] + ".py")
    return driver.control_readings(cfg, traffic, seed, device)


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
