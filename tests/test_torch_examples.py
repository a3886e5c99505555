"""The port's examples and tools against the JAX package's, on the CPU.

Rules:

* ``examples.run_pipeline`` at 64^3 (width 0.25, patch 32): its SWC zip
  equals, entry for entry and byte for byte, the JAX package's
  ``segmentation_to_zipped_swcs`` of the JAX segmentation of the same
  oracle affinities; ``synthetic_brain`` at its default 128^3 equals the
  JAX example's bit for bit;
* ``examples.run_beyond_ram`` (width 0.25, patch 32): the label store
  equals the dense segmentation of its affinity store, one zip entry per
  label; ``examples.run_multichip`` over 4 gloo ranks: the 1-D store
  within 1e-6 of one process's ``predict``;
* ``tools.beyond_ram_proof`` at N = 64: ``synth_store``'s files equal the
  JAX tool's byte for byte, and the single-process and ``--ranks 2`` zips
  are entry-identical;
* ``tools.traffic_audit``: ``minimal_traffic_model`` returns the JAX
  tool's figures at trim 0 and 8, and the per-op byte reckoning of a
  one-conv module under the CPU profiler counts the conv's input, weight,
  bias and output, an in-place op's tensor once each way and a
  concatenation's inputs and output.
"""

import importlib.util
import os
import zipfile

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu.utils import img_util as jimg
from aind_exaspim_neuron_segmentation_tpu_torch import inference, io
from aind_exaspim_neuron_segmentation_tpu_torch.examples import (
    run_beyond_ram,
    run_multichip,
    run_pipeline,
)
from aind_exaspim_neuron_segmentation_tpu_torch.tools import (
    beyond_ram_proof,
    traffic_audit,
)
from tests.test_torch_gpu import parity_line

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=2)


def _jax_script(rel):
    """A script of the repo's ``examples/`` or ``tools/`` as a module."""
    path = os.path.join(REPO, rel)
    name = "jax_" + os.path.basename(rel)[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entries(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_synthetic_brain_equals_jax_example():
    jex = _jax_script("examples/run_pipeline.py")
    for got, want in zip(run_pipeline.synthetic_brain(),
                         jex.synthetic_brain()):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_run_pipeline_zip_equals_jax(tmp_path):
    res = run_pipeline.main(str(tmp_path), "cpu", (64,) * 3, 0.25, **SMALL)
    _, lab = run_pipeline.synthetic_brain((64,) * 3)
    oracle = jimg.get_affinity_channels(lab).astype(np.float32)
    seg = jinf.affinities_to_segmentation(oracle)
    want = tmp_path / "jax.zip"
    jinf.segmentation_to_zipped_swcs(seg, str(want))
    got = _entries(res["zip"])
    assert got == _entries(str(want))
    assert sorted(got) == ["1.swc", "2.swc"] and res["n_segments"] == 2
    assert res["k1_launches"] == 0  # the CPU blends with the plain loop
    assert {"load_model", "predict", "segment",
            "skeletonize+zip"} <= set(res["stages_s"])
    parity_line("run_pipeline_zip_vs_jax", entries_equal=len(got))


def test_run_beyond_ram_labels_equal_dense(tmp_path):
    res = run_beyond_ram.main(str(tmp_path), "cpu", 0.25, **SMALL)
    aff = io.read(res["affinities"])[:]
    assert aff.shape == (3,) + run_beyond_ram.DIM
    want = inference.affinities_to_segmentation(aff, device="cpu")
    got = io.read(res["segmentation"])[:]
    assert np.array_equal(got, want)
    assert res["n_skeletons"] == len(_entries(res["zip"])) == int(
        want.max())


def test_run_multichip_1d_equals_predict(tmp_path):
    res = run_multichip.main(str(tmp_path), "cpu", ranks=4, timeout=300,
                             **SMALL)
    assert res["max_abs_1d"] <= 1e-6
    assert res["k1_launches"] == [0, 0, 0, 0] and res["n_segments"] >= 1
    for name in ("affinities", "affinities_2d", "plan", "qaff"):
        assert os.path.exists(os.path.join(tmp_path, f"{name}.zarr"))


def test_synth_store_bytes_equal_jax_tool(tmp_path):
    jtool = _jax_script("tools/beyond_ram_proof.py")
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    beyond_ram_proof.synth_store(64, str(ours))
    jtool.synth_store(64, str(theirs))
    got, want = _files(ours), _files(theirs)
    assert set(got) == set(want) and len(got) > 2
    assert got == want


def test_beyond_ram_proof_ranks_zip_identical(tmp_path):
    work = str(tmp_path)
    single = beyond_ram_proof.main_single(64, work, torch.device("cpu"))
    dist = beyond_ram_proof.main_distributed(64, work, 2,
                                             torch.device("cpu"),
                                             timeout=300)
    assert dist["entry_identical"] is True
    assert single["n_skeletons"] == dist["n_skeletons"] >= 1
    assert beyond_ram_proof.zips_identical(
        os.path.join(work, "proof_swcs.zip"),
        os.path.join(work, "proof_swcs_dist.zip"))
    assert single["peak_rss_gb"] > 0 and dist["peak_rss_gb"] > 0
    assert set(single["walls_s"]) == {"synth_s", "segment_s",
                                      "skeletonize_s"}


@pytest.mark.parametrize("trim", [0, 8])
def test_minimal_traffic_model_equals_jax_tool(trim):
    jtool = _jax_script("tools/traffic_audit.py")
    for params in (12_940_224, 1_000_003):
        assert (traffic_audit.minimal_traffic_model(16, trim, params)
                == jtool.minimal_traffic_model(16, trim, params))


def test_traffic_reckoning_of_one_conv_under_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    conv = torch.nn.Conv3d(2, 4, 3, padding=1)
    x = torch.randn(3, 2, 8, 8, 8)
    y_bytes = 3 * 4 * 8 ** 3 * 4
    with torch.inference_mode():
        conv(x)
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                     profile_memory=True) as prof:
            with record_function(traffic_audit.ANNOTATION):
                y = torch.nn.functional.leaky_relu(conv(x), inplace=True)
                torch.cat([y, y], 1)
    rows, kernels, orphans = traffic_audit.audit_rows(prof, "cpu", 1)
    assert kernels == orphans == []
    by_kind = {}
    for name, _, read, written, _, calls in rows:
        kind = ("conv" if "conv" in name else
                "relu" if "leaky_relu" in name else
                "cat" if "cat" in name else name)
        assert kind not in by_kind, rows
        by_kind[kind] = (read, written, calls)
    assert by_kind["conv"] == (x.numel() * 4 + 4 * 2 * 27 * 4 + 4 * 4,
                               y_bytes, 1)
    assert by_kind["relu"] == (y_bytes, y_bytes, 1)
    assert by_kind["cat"] == (2 * y_bytes, 2 * y_bytes, 1)
    assert set(by_kind) == {"conv", "relu", "cat"}, rows


def test_traffic_of_in_place_copies_and_fills():
    f32, bf16 = "float", "c10::BFloat16"
    shape = [2, 3, 4]
    # copy_ reads its source only; fill_ reads nothing; add_ reads both
    assert traffic_audit.op_traffic(
        "aten::copy_", [shape, shape, []], [bf16, f32, "Scalar"], 0) == (
            96, 48)
    assert traffic_audit.op_traffic(
        "aten::fill_", [shape, []], [f32, "Scalar"], 0) == (0, 96)
    assert traffic_audit.op_traffic(
        "aten::add_", [shape, [3, 1], []], [f32, f32, "Scalar"], 0) == (
            96 + 12, 96)
    # an out-of-place op writes what it allocated
    assert traffic_audit.op_traffic(
        "aten::sigmoid", [shape], [f32], 96) == (96, 96)
