"""``BENCHMARK.json`` against its contract, and every piece a cell needs
found by name."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(SPEC) == KEYS
    with open(os.path.join(harness.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda v: v if isinstance(v, str)
                         else v.get("name"))
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[group]
    assert set(entry) <= allowed
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200
            assert "\n" not in entry[text] and "\t" not in entry[text]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    if group == "configs":
        assert all(NAME.match(k) for k in entry["reduced"])
        assert os.path.exists(os.path.join(harness.ROOT, entry["file"]))
    if group == "workloads":
        assert NAME.match(entry["traffic"]) and entry["chips"] == 1


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in SPEC["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_pieces_are_found_by_name(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    cfg = harness.load_json("configs", entry["config"] + ".json")
    traffic = harness.load_json("traffic", entry["traffic"] + ".json")
    assert hasattr(harness.load_module("drivers", traffic["driver"] + ".py"),
                   "setup")
    e2e = harness.cell_metrics(SPEC, cell, "end_to_end")
    layer = harness.cell_metrics(SPEC, cell, "per_layer")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert hasattr(harness.load_module("metrics", m["name"] + ".py"),
                       "read")
    for m in layer:
        assert m["moves"] in [x["name"] for x in e2e]
    assert cfg["limits"]


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files_hold_what_is_run(entry):
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    # the architecture's published widths, none of them cut
    published = harness.model_module(cfg).PUBLISHED
    assert {k: cfg["model"][k] for k in published} == published


ARCH_API = ("PUBLISHED", "weights", "runner", "forward", "conv_layers",
            "forward_flops")


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_architecture_module_is_found_by_name(entry):
    cfg = harness.load_json("configs", entry["name"] + ".json")
    arch = harness.model_module(cfg)
    for name in ARCH_API:
        assert hasattr(arch, name), name
    # the reference forward is plain: it lives under benchmark/reference/,
    # which imports nothing of the port (test_bench_imports)
    assert arch.forward.__module__.startswith("benchmark.reference."), \
        arch.forward.__module__


def test_layer_names_are_one_per_layer():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"device", "model", "kernels", "sampler", "train step"}
