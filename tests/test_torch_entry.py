"""The port's entry points (``entry``, ``dryrun_multichip``) against the JAX
package's ``__graft_entry__``, on the CPU.

``dryrun_multichip(4, device="cpu")`` (four gloo rank processes) starts
once for the file, in a thread, and runs while the JAX references
compute here. Rules:

* ``entry(device="cpu")``: the bf16 full-width module in eval mode and a
  (1, 1, 96, 96, 96) float32 patch equal to the JAX entry's
  (1, 96, 96, 96, 1) one; with the JAX entry's own variables carried
  across (``convert.state_dict_from_jax_variables``) the port's module in
  float32 gives the JAX ``UNet3D(output_channels=3)``'s float32 sigmoid
  within MAE 1e-5 (the repo's parity bar), shape (1, 3, 96, 96, 96),
  finite, in [0, 1]. The bf16 forward itself is held to float32 on the
  card (``chip_smoke.py`` phase 16 (a)): a bf16 conv3d at full width is
  slow on the CPU;
* the dry run: its five phases' figures, phase 3's 1-D and 2-D
  affinities within 1e-6 of the port's single-process ``predict`` of the
  model the ranks trained, and its digest pair through the JAX package's
  ``affinities_to_segmentation`` and ``skeletonize`` equal to the port's
  labels and SWC zip entries bit for bit;
* a rank that fails or outlives its deadline raises with its log tail.
"""

import os
import sys
import threading
import zipfile

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import jax
import jax.numpy as jnp

from aind_exaspim_neuron_segmentation_tpu import inference as jinf
from aind_exaspim_neuron_segmentation_tpu.models.unet3d import (
    UNet3D as JUNet3D,
)
from aind_exaspim_neuron_segmentation_tpu_torch import entry as pentry
from aind_exaspim_neuron_segmentation_tpu_torch import inference, io
from aind_exaspim_neuron_segmentation_tpu_torch.models.convert import (
    state_dict_from_jax_variables,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import UNet3D
from aind_exaspim_neuron_segmentation_tpu_torch.parallel import launch
from tests.test_torch_gpu import parity_line


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """``dryrun_multichip(4, device="cpu")`` in a thread, started when the
    file's first test asks for it; ``result()`` waits for its figures."""
    work = str(tmp_path_factory.mktemp("dryrun"))
    box = {}

    def run():
        try:
            box["fig"] = pentry.dryrun_multichip(4, device="cpu",
                                                 work_dir=work, timeout=300)
        except BaseException as err:  # re-raised in the test's thread
            box["err"] = err

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    class Job:
        dir = work

        @staticmethod
        def result():
            thread.join(timeout=400)
            assert not thread.is_alive(), "dryrun_multichip did not return"
            if "err" in box:
                raise box["err"]
            return box["fig"]

    yield Job
    thread.join(timeout=400)


def test_entry_matches_jax_entry_in_float32(dryrun):
    jfwd, (variables, jx) = jentry.entry()
    forward_step, (module, x) = pentry.entry(device="cpu")
    assert module.outc.conv.weight.dtype == torch.bfloat16
    assert not module.training and module.output_channels == 3
    assert module.inc.double_conv[0].weight.shape == (32, 1, 3, 3, 3)
    assert x.dtype == torch.float32 and x.shape == (1, 1, 96, 96, 96)
    assert np.array_equal(x.numpy().ravel(), np.asarray(jx).ravel())

    want = np.asarray(jax.nn.sigmoid(JUNet3D(output_channels=3).apply(
        variables, jx, train=False).astype(jnp.float32)))
    module = module.float()
    module.load_state_dict(state_dict_from_jax_variables(variables))
    got = forward_step(module, x)
    assert got.shape == (1, 3, 96, 96, 96) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
    fig = parity_line("entry_float32_vs_jax", got,
                      np.moveaxis(want, -1, 1))
    assert fig["mae"] <= 1e-5, fig


def test_dryrun_figures(dryrun):
    fig = dryrun.result()
    assert np.isfinite(fig["loss"]) and fig["loss"] > 0
    assert fig["mesh"] == 4 and fig["mesh2"] == [2, 2]
    assert fig["forward_out"] == [2, 3, 16, 16, 16]
    assert fig["aff_1d"] == fig["aff_2d"] == [3, 48, 44, 20]
    assert fig["plan"] == [48, 44, 20] and fig["qaff"] == [3, 48, 44, 20]
    # on the CPU the blend is the plain loop: no kernel launch to count
    assert fig["k1_launches"] == [0, 0, 0, 0]
    seg = io.read(os.path.join(dryrun.dir, "dryrun_seg.zarr"))[:]
    assert fig["ranks"] == 4 and fig["n_segments"] == int(seg.max()) >= 1
    names = zipfile.ZipFile(os.path.join(dryrun.dir,
                                         "dryrun_swcs.zip")).namelist()
    assert fig["n_skeletons"] == len(names) >= 1


def test_dryrun_affinities_equal_single_process_predict(dryrun):
    dryrun.result()
    module = UNet3D(output_channels=3, width_multiplier=0.25)
    module.load_state_dict(torch.load(os.path.join(dryrun.dir,
                                                   "model.pth")))
    runner = inference.ModelRunner(module)
    vol = np.load(os.path.join(dryrun.dir, "volume.npy"))
    want = inference.predict(vol, runner, verbose=False,
                             **pentry.PREDICT_KW)
    for name in ("aff_1d", "aff_2d"):
        got = io.read(os.path.join(dryrun.dir, f"{name}.zarr"))[:]
        fig = parity_line(f"dryrun_{name}_vs_predict", got, want)
        assert fig["max_abs"] <= 1e-6, (name, fig)


def test_dryrun_digest_through_jax_gives_port_labels_and_swcs(dryrun):
    dryrun.result()
    pair = tuple(io.read(os.path.join(dryrun.dir, f"{n}.zarr"))[:]
                 for n in ("plan", "qaff"))
    want = jinf.affinities_to_segmentation(pair, min_segment_size=0)
    got = io.read(os.path.join(dryrun.dir, "dryrun_seg.zarr"))[:]
    assert np.array_equal(got, want)
    skels = jinf.skeletonize(want)
    with zipfile.ZipFile(os.path.join(dryrun.dir, "dryrun_swcs.zip")) as z:
        entries = {n: z.read(n) for n in z.namelist()}
    assert entries == {f"{k}.swc": s.to_swc().encode()
                       for k, s in skels.items()}
    parity_line("dryrun_digest_through_jax", labels_equal=True,
                n_segments=int(want.max()), swc_entries_equal=len(entries))


def test_rank_failure_raises_with_its_log(tmp_path):
    code = ("import os, sys; r = int(os.environ['RANK']); "
            "print('rank', r, 'of', os.environ['WORLD_SIZE']); "
            "sys.exit(3 if r == 1 else 0)")
    with pytest.raises(RuntimeError, match=r"rank 1 of 2") as err:
        launch.run([sys.executable, "-c", code], 2, str(tmp_path), "fail",
                   60)
    assert "exited [0, 3]" in str(err.value)


def test_rank_past_its_deadline_is_killed(tmp_path):
    code = "import time; time.sleep(60)"
    with pytest.raises(RuntimeError, match=r"\['timeout', 'timeout'\]"):
        launch.run([sys.executable, "-c", code], 2, str(tmp_path), "slow", 2)


def test_dryrun_needs_two_ranks(tmp_path):
    with pytest.raises(ValueError, match="at least 2 ranks"):
        pentry.dryrun_multichip(1, device="cpu", work_dir=str(tmp_path))
    assert not any(tmp_path.iterdir())


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pentry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pentry.dryrun_multichip(2, work_dir=str(tmp_path))
    assert not any(tmp_path.iterdir())
