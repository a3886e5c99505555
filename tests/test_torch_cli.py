"""The port's CLI (``python -m aind_exaspim_neuron_segmentation_tpu_torch``)
against the JAX package's CLI and the port's library path, on the CPU.

Every command runs in process through ``main([...])`` with ``--device
cpu``. ``segment`` and ``swc`` on the same stores give labels and zip
entries equal to the JAX CLI's bit for bit; ``predict`` of one ``.pth``
(the port's seeded weights) is held to the JAX CLI's float store at MAE
<= 1e-5; ``run`` equals the port's library calls on the same lazy handle.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu import io as jio
from aind_exaspim_neuron_segmentation_tpu.__main__ import main as jmain
from aind_exaspim_neuron_segmentation_tpu_torch import inference, io
from aind_exaspim_neuron_segmentation_tpu_torch.__main__ import main
from aind_exaspim_neuron_segmentation_tpu_torch.ops import predigest
from tests.test_streamseg import _blobby_affs
from tests.test_torch_gpu import parity_line

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = ["--patch", "32", "--overlap", "16,16,16", "--trim", "4",
         "--batch-size", "4", "--width-multiplier", "0.25", "--quiet"]
CPU = ["--device", "cpu"]


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _zip_entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.fixture(scope="module")
def volume_store(tmp_path_factory):
    """48^3 uint16 volume with a bright ball, as a blosc zarr store."""
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 300, (48, 48, 48)).astype(np.uint16)
    zz, yy, xx = np.ogrid[-10:11, -10:11, -10:11]
    vol[14:35, 14:35, 14:35][zz**2 + yy**2 + xx**2 < 100] = 1200
    path = str(tmp_path_factory.mktemp("cli") / "vol.zarr")
    io.write_zarr(path, vol, chunks=(16, 16, 16), compressor={
        "id": "blosc", "cname": "lz4", "shuffle": 1})
    return path


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The port's seeded width-0.25 weights as a reference ``.pth``."""
    net = inference.load_model(device="cpu", width_multiplier=0.25).module
    path = str(tmp_path_factory.mktemp("ckpt") / "unet.pth")
    torch.save(net.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def affinity_stores(tmp_path_factory):
    """(float store, plan store, qaff store) of blobby affinities."""
    root = tmp_path_factory.mktemp("affs")
    aff = _blobby_affs((28, 20, 20), r=4, seed=5, step=10)
    plan, qaff = predigest.predigest(aff, device="cpu")
    paths = [str(root / n) for n in ("affs.zarr", "plan.zarr", "qaff.zarr")]
    for p, a in zip(paths, (aff, plan, qaff)):
        io.write_zarr(p, a, chunks=(6,) * (a.ndim - 2) + a.shape[-2:])
    return paths


@pytest.mark.parametrize("source", ["float", "pair"])
def test_segment_and_swc_equal_jax_cli(affinity_stores, tmp_path, capsys,
                                       source):
    affs, plan, qaff = affinity_stores
    src = (["--affinities", affs] if source == "float"
           else ["--plan", plan, "--qaff", qaff])
    seg, jseg = str(tmp_path / "seg.zarr"), str(tmp_path / "jseg.zarr")
    main(CPU + ["segment", *src, "--output", seg, "--min-size", "10",
                "--quiet"])
    assert _json(capsys) == {"segment": seg}
    jmain(["--platform", "cpu", "segment", *src, "--output", jseg,
           "--min-size", "10", "--quiet"])
    capsys.readouterr()
    got, want = io.read(seg)[:], jio.read(jseg)[:]
    assert got.dtype == want.dtype == np.uint32 and got.max() > 1
    np.testing.assert_array_equal(got, want)

    zp, jzp = str(tmp_path / "sk.zip"), str(tmp_path / "jsk.zip")
    main(["swc", "--segmentation", seg, "--output", zp])
    out = _json(capsys)
    jmain(["swc", "--segmentation", seg, "--output", jzp])
    capsys.readouterr()
    entries = _zip_entries(zp)
    assert out == {"swc": zp, "n": len(entries)} and entries
    assert entries == _zip_entries(jzp)
    parity_line(f"CLI segment + swc ({source}) vs JAX CLI",
                labels=int(got.max()), entries=len(entries),
                bytes_equal=True)


def test_predict_within_mae_of_jax_cli(volume_store, checkpoint, tmp_path,
                                       capsys):
    out, jout = str(tmp_path / "a.zarr"), str(tmp_path / "ja.zarr")
    main(CPU + ["predict", "--input", volume_store, "--output", out,
                "--model", checkpoint] + PATCH)
    assert _json(capsys) == {"predict": out}
    jmain(["--platform", "cpu", "predict", "--input", volume_store,
           "--output", jout, "--model", checkpoint] + PATCH)
    capsys.readouterr()
    got, want = io.read(out), jio.read(jout)
    assert got.shape == want.shape == (3, 48, 48, 48)
    assert got.dtype == np.float32
    fig = parity_line("CLI predict vs JAX CLI (one .pth)", got[:], want[:])
    assert fig["mae"] <= 1e-5

    plan, qaff = str(tmp_path / "p.zarr"), str(tmp_path / "q.zarr")
    main(CPU + ["predict", "--input", volume_store, "--predigest-out", plan,
                qaff, "--model", checkpoint] + PATCH)
    assert _json(capsys) == {"predict": [plan, qaff]}
    want_plan, want_qaff = predigest.predigest(got[:], device="cpu")
    np.testing.assert_array_equal(io.read(plan)[:], want_plan)
    np.testing.assert_array_equal(io.read(qaff)[:], want_qaff)


def test_run_equals_library_path(volume_store, tmp_path, capsys):
    work, zp = str(tmp_path / "work"), str(tmp_path / "out.zip")
    main(CPU + ["run", "--input", volume_store, "--workdir", work,
                "--output", zp, "--min-size", "10"] + PATCH)
    got = _json(capsys)
    assert got["run"] == zp and got["workdir"] == work
    assert set(got["stages_s"]) == {"predict", "segment", "swc"}
    cli_seg = io.read(os.path.join(work, "segmentation.zarr"))[:]

    runner = inference.load_model(device="cpu", width_multiplier=0.25)
    plan, qaff = inference.predict(
        io.read(volume_store), runner, predigest=True, batch_size=4,
        patch_shape=(32, 32, 32), overlap=(16, 16, 16), trim=4,
        verbose=False)
    lib_seg = inference.affinities_to_segmentation((plan, qaff),
                                                   min_segment_size=10)
    np.testing.assert_array_equal(cli_seg, lib_seg)
    np.testing.assert_array_equal(io.read(os.path.join(work, "plan.zarr"))[:],
                                  plan)
    inference.segmentation_to_zipped_swcs(lib_seg, tmp_path / "lib.zip")
    entries = _zip_entries(zp)
    assert entries == _zip_entries(tmp_path / "lib.zip")
    parity_line("CLI run vs library path", labels=int(cli_seg.max()),
                entries=len(entries), bytes_equal=True)


@pytest.mark.parametrize("argv", [
    ["predict", "--input", "x.zarr"],
    ["predict", "--input", "x.zarr", "--output", "a.zarr",
     "--predigest-out", "p.zarr", "q.zarr"],
    ["segment", "--output", "y.zarr"],
    ["segment", "--affinities", "a.zarr", "--plan", "p.zarr",
     "--output", "y.zarr"],
    ["segment", "--affinities", "a.zarr", "--plan", "p.zarr", "--qaff",
     "q.zarr", "--output", "y.zarr"],
    ["run", "--input", "x.zarr", "--workdir", "w", "--output", "o.zip",
     "--foreground"],
    ["--device", "tpu", "swc", "--segmentation", "s.zarr", "--output",
     "o.zip"],
    # (named when the port had no train command; train's own error now)
    ["train", "--output", "o", "--images", "i.zarr", "--labels", "l.zarr",
     "--val-images", "v.zarr"],
    ["train", "--output", "o", "--images", "i.zarr", "--labels", "l.zarr",
     "m.zarr"],
    ["train", "--output", "o", "--images", "i.zarr", "--labels", "l.zarr",
     "--val-images", "v.zarr", "--val-labels", "a.zarr", "b.zarr"],
], ids=["predict_no_output", "predict_two_outputs", "segment_no_input",
        "segment_plan_without_qaff", "segment_affinities_and_plan",
        "run_foreground", "device_tpu", "no_train_command",
        "train_unpaired", "train_val_unpaired"])
def test_argument_errors_exit(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code != 0


def test_version_and_default_device(volume_store, tmp_path, capsys,
                                    monkeypatch):
    from aind_exaspim_neuron_segmentation_tpu_torch import __version__

    with pytest.raises(SystemExit) as exc:
        main(["--version"])
    assert exc.value.code == 0 and __version__ in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["predict", "--input", volume_store, "--output",
              str(tmp_path / "a.zarr")] + PATCH)


def test_help_in_a_fresh_process_imports_no_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['x', '--help']\n"
        "try:\n"
        "    runpy.run_module('aind_exaspim_neuron_segmentation_tpu_torch',"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax') or "
        "m.startswith(('jax.', 'flax.', "
        "'aind_exaspim_neuron_segmentation_tpu.')))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    res = subprocess.run(
        [sys.executable, "-m", "aind_exaspim_neuron_segmentation_tpu_torch",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "run" in res.stdout


def test_train_in_a_subprocess_writes_its_line_and_a_pth(tmp_path):
    """``train`` at a tiny size on the CPU, in its own process: the default
    path (raw label patches -> augmentation on the device, raw u16 wire)
    ends with the JSON line naming the run directory, which holds a
    best-F1 ``.pth`` that ``load_model`` takes strictly."""
    rng = np.random.default_rng(1)
    imgs, labs = [], []
    for k in range(2):
        lab = np.zeros((32, 32, 32), np.uint32)
        lab[4:28, 6 + 3 * k:20 + 3 * k, 4:28] = k + 1
        lab[18:28, 24:30, 6:26] = 5
        img = rng.integers(0, 90, lab.shape).astype(np.uint16)
        img[lab > 0] += np.uint16(400)
        for name, arr in (("img", img), ("lab", lab)):
            path = str(tmp_path / f"{name}{k}.zarr")
            io.write_zarr(path, arr, chunks=(16, 32, 32))
            (imgs if name == "img" else labs).append(path)
    out = tmp_path / "runs"
    res = subprocess.run(
        [sys.executable, "-m", "aind_exaspim_neuron_segmentation_tpu_torch",
         "--device", "cpu", "train", "--output", str(out), "--images", *imgs,
         "--labels", *labs, "--patch", "16", "--batch-size", "4",
         "--epochs", "3", "--lr", "1e-2", "--width-multiplier", "0.25",
         "--containment-buffer", "0", "--seed", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"),
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert os.path.dirname(got["train"]) == str(out)
    pths = sorted(os.listdir(got["train"]))
    pths = [p for p in pths if p.startswith("UNet3d-") and p.endswith(".pth")]
    assert pths, res.stdout
    runner = inference.load_model(os.path.join(got["train"], pths[-1]),
                                  device="cpu", width_multiplier=0.25)
    assert runner.output_channels == 3
