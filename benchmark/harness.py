"""The benchmark's runner: one cell, one seed, one process.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* the cell's ``config`` -> ``benchmark/configs/<config>.json`` (the
  model's sizes, the workflow's settings and the limits of its check),
  whose ``model.architecture`` names ``benchmark/models/<architecture in
  lower case>.py`` (the seeded weights, the program's runner, the plain
  reference forward and the analytic counts of that architecture);
* its ``traffic`` -> ``benchmark/traffic/<traffic>.json`` (the mix's
  parameters), whose ``driver`` names ``benchmark/drivers/<driver>.py``;
* each metric -> ``benchmark/metrics/<name>.py``, a reader with a
  ``read(rec)`` that returns the number, or ``None`` where it finds
  nothing to read (the metric is then left out of the line).

A driver's ``setup(ctx)`` builds the program's state and warms every
shape the cell uses, and returns a session: ``span`` (the name of the
benchmark's span around each timed call), ``step()`` (one timed call;
returns the work it finished), ``counters()`` (what the program counted
in the window), ``free()`` and ``check()`` (the comparison with the plain
reference, ``[(name, value), ...]``, each held to the config's limit).
A driver's ``control_readings(cfg, traffic, seed, device)`` gives the same
numbers for the control (and a training cell's planted faults), for
``calibrate.py`` and the tests.
"""

import contextlib
import importlib.util
import json
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "aind_exaspim_neuron_segmentation_tpu")
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv",
}


class Phases:
    """Host-clock marks of set-up's phases, for the run's log."""

    def __init__(self):
        self.last, self.marks = time.perf_counter(), []

    def mark(self, name):
        """End the phase ``name``."""
        t = time.perf_counter()
        self.marks.append(f"{name} {t - self.last:.3f} s")
        self.last = t

    def text(self):
        """The phases in order."""
        return ", ".join(self.marks)


def fix_cache_dirs():
    """Point every build and kernel cache at a fixed directory inside the
    checkout, so only a cell's first run there builds."""
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(base, sub)


def load_json(*parts):
    """A JSON file under ``benchmark/``."""
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_spec():
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(*parts):
    """A Python file under ``benchmark/`` as a module (its name may hold
    dots, as a metric's does)."""
    path = os.path.join(HERE, *parts)
    name = "benchmark._loaded." + "_".join(parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base, over):
    """``base`` with the keys of ``over`` replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def cell_inputs(spec, cell, overrides=None):
    """``(config, traffic)`` of ``cell``; ``overrides``
    (``{"config": {...}, "traffic": {...}}``) replaces settings."""
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    overrides = overrides or {}
    cfg = merged(load_json("configs", entry["config"] + ".json"),
                 overrides.get("config"))
    traffic = merged(load_json("traffic", entry["traffic"] + ".json"),
                     overrides.get("traffic"))
    return cfg, traffic


def model_module(cfg):
    """The module of the configuration's ``model.architecture``."""
    return load_module("models", cfg["model"]["architecture"].lower()
                       + ".py")


def cell_metrics(spec, cell, kind):
    """The ``end_to_end`` or ``per_layer`` entries the cell reports: those
    that list it, and, without a list, those whose end-to-end metric the
    cell reports (every cell, for an end-to-end metric)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if cell in m["workloads"]] + [
        m for m in spec["per_layer"]
        if "workloads" not in m and m["moves"] in names]


def forbidden_loaded():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    """The card's power limit in W, read by ``nvidia-smi`` (None where it
    cannot be read)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def peaks(kind):
    """The card's published peaks (``counts/peaks.json``), or None."""
    table = load_json("counts", "peaks.json")
    for name, row in table.items():
        if name == kind or name in kind:
            return row
    return None


def run_cell(cell, seed, seconds, trace, *, device="cuda", chips=1,
             process_t0=None, overrides=None, spec=None, quiet=False,
             keep=None):
    """Run one cell and return ``(result line, check lines)``.

    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces
    settings, for the CPU tests at small sizes; ``process_t0`` is the
    ``time.perf_counter()`` reading of the process's start; ``keep`` (a
    list) gets the driver's session.
    """
    import numpy as np
    import torch

    t0 = time.perf_counter() if process_t0 is None else process_t0
    spec = spec or load_spec()
    cfg, traffic = cell_inputs(spec, cell, overrides)
    driver = load_module("drivers", traffic["driver"] + ".py")
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ctx = types.SimpleNamespace(cfg=cfg, traffic=traffic, seed=int(seed),
                                device=dev, trace=bool(trace))
    session = driver.setup(ctx)
    if keep is not None:
        keep.append(session)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    work, calls, t_first, per_call = 0.0, 0, None, []
    with prof if prof is not None else contextlib.nullcontext():
        with torch.profiler.record_function("bench.window"):
            t_first = t_call = time.perf_counter()
            while True:
                with torch.profiler.record_function(session.span):
                    work += session.step()
                calls += 1
                now = time.perf_counter()
                per_call.append(now - t_call)
                t_call = now
                if now - t_first >= seconds:
                    break
            if on_card:
                torch.cuda.synchronize(dev)
            t_last = time.perf_counter()
    rec = dict(
        setup_s=t_first - t0, window_s=t_last - t_first, work=work,
        calls=calls, cfg=cfg, traffic=traffic, trace=None,
        counters=session.counters(),
    )
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rec["peaks"] = peaks(kind) if on_card else None
    device_line = dict(
        platform="gpu" if on_card else "cpu", kind=kind, count=chips,
        memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev))
        if on_card else 0,
        power_limit_w=power_limit_w() if on_card else None,
    )
    result = {"correct": False, "attempted": calls, "failed": 0,
              "metrics": {}, "device": device_line}
    if trace:
        from benchmark.trace import Trace

        t = Trace(prof)
        rec["trace"] = t
        device_line.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.gaps()}
    wanted = cell_metrics(spec, cell, "per_layer" if trace else "end_to_end")
    for m in wanted:
        value = load_module("metrics", m["name"] + ".py").read(rec)
        if value is not None:
            result["metrics"][m["name"]] = {"value": float(value),
                                            "unit": m["unit"]}
    if not quiet:
        print(f"bench: {cell} seed {seed}: {calls} calls, work {work:.6g} "
              f"in {rec['window_s']:.6f} s, set-up {rec['setup_s']:.6f} s; "
              f"per call median {np.median(per_call):.6f} s, highest "
              f"{max(per_call):.6f} s; {session.describe()}",
              file=sys.stderr)
    prof = rec["trace"] = None
    session.free()
    numbers = session.check()
    limits = cfg["limits"]
    checks, lines = {}, []
    for name, value in numbers:
        if name not in limits:
            print(f"reading {name} {float(value)!r} (not compared)",
                  file=sys.stderr)
            continue
        limit = limits[name]
        checks[name] = {"value": float(value), "limit": float(limit)}
        lines.append(f"check {name} {float(value)!r} limit {float(limit)!r}"
                     f" {'ok' if value <= limit else 'FAIL'}")
    failed = sum(1 for v in checks.values() if not v["value"] <= v["limit"])
    result["failed"] = failed
    result["correct"] = bool(checks) and failed == 0 and all(
        np.isfinite(v["value"]) for v in checks.values())
    result["checks"] = checks
    return result, lines


def main(argv=None, process_t0=None):
    """Command line: ``--workload --seed --seconds --trace``."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    entry = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < entry["chips"]:
        print(f"bench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             args.trace, device="cuda", chips=entry["chips"],
                             process_t0=process_t0, spec=spec)
    bad = forbidden_loaded()
    if bad:
        print(f"bench: modules loaded that the benchmark may not use: "
              f"{bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
