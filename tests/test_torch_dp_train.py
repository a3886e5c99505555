"""The port's data-parallel training against one process and the JAX
package's ``Trainer(mesh=)``, on the CPU over gloo.

One job of two gloo ranks (``tests/torch_ranks.py``, the JAX package's
environment contract) and two processes of the CLI's ``train
--distributed`` (torchrun's) start once for the file and run while the
references compute here (the JAX package's run first, then the single
process's, then the ranks' results are read). Rules:

* the synchronized BatchNorm over 2 ranks (float64, two steps) against
  ``nn.BatchNorm3d`` over the concatenated batch: outputs, input
  gradients and running statistics within 1e-12, the weight and bias
  gradients summed over the ranks within 1e-12, ``num_batches_tracked``
  equal; in float32 within 1e-5 relative (measured: the float64 sums of
  float32 moments hold it);
* ``Trainer(mesh=make_mesh(2))`` (width 0.25, 16^3, batch 4, augmentation
  on the device, one even epoch): both ranks' state bit-equal; the first
  step's gradients within 1e-4 of each tensor's max-abs gradient of the
  single process's (the pre-BatchNorm conv biases, whose true gradient is
  0, both <= 1e-5 of the largest) and the running statistics the first
  forward leaves within 1e-5 relative; the final parameters within 2 lr
  per step of it (Adam steps a near-zero gradient by about +-lr
  whichever its rounding);
* the even epoch at lr 0 (every step from the initial weights): the
  per-example precision and recall lists of the train and validation
  epochs (the validation batches ragged) equal one process's in order
  and length, the losses within 1e-5 relative;
* the ragged step (the 3 examples of the ragged epoch's last batch, batch
  4: rank 1's second row repeats the last example with weight 0) against
  the JAX package's mesh train step in float64 on the same padded global
  batch, sharded over its 2-device mesh: the loss within 1e-6 relative;
  per tensor, the gradients summed over the ranks within 1e-3 of the
  tensor's max-abs float64 gradient (measured ~2e-4, the float32
  rounding of this batch); the pre-BatchNorm
  conv biases <= 1e-5 of the largest. Counting the repeated example in
  the loss moves the loss by 0.33 and the gradients by 0.8 of a tensor's
  max, per-rank BatchNorm statistics the gradients by 3, averaging the
  gradients over the ranks instead of summing them by 0.5;
* a ragged epoch (7 examples, batch 4) against the JAX package's
  ``Trainer(mesh=parallel.make_mesh(2))`` (float32) from the same
  weights: every parameter within 5e-3 (``tests/test_parallel.py``'s bar
  between the JAX package's mesh and single-device Trainers; two AdamW
  steps move an element at most ~2 lr each, so this bar only bounds
  the run), the first step's loss within 1e-5 relative and the ragged
  second step's within 1e-3 (measured 2.5e-5: one Adam step apart, the
  parameters differ where a gradient's sign is within rounding), the
  metric lists of the same length;
* the gathered metric lists run in block order and stop at ``n_real``;
* ``batch_size % world`` -> ``ValueError``;
* the CLI ``train --distributed``: one JSON line (rank 0's), rank 1's run
  under ``<output>/.rank1``, both best-F1 ``.pth`` files equal; with
  ``--mesh 1`` in a job of 2, rank 0 trains alone and rank 1 exits 0
  with a note, writing nothing.

Figures print as ``{"parity": ...}`` lines (``pytest -s``).
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu import parallel as jparallel
from aind_exaspim_neuron_segmentation_tpu.machine_learning import (
    train as jtrain,
)
from aind_exaspim_neuron_segmentation_tpu.models import convert as jconvert
from aind_exaspim_neuron_segmentation_tpu.models import unet3d as junet
from aind_exaspim_neuron_segmentation_tpu_torch import io
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import train
from aind_exaspim_neuron_segmentation_tpu_torch.models import convert
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from tests import torch_ranks
from tests.test_torch_gpu import box_batch, parity_line, pre_bn_bias
from tests.test_torch_train import jax_float64

torch.set_num_threads(1)

WIDTH = 0.25
LR = 1e-3
RAGGED_GRAD_TOL = 1e-3
TRAIN_KW = dict(batch_size=4, width_multiplier=WIDTH, max_epochs=1,
                prefetch=False)


def _volumes(n, seed):
    """``n`` uint16 32^3 volumes with boxes of labels, seeded."""
    rng = np.random.default_rng(seed)
    imgs, labs = [], []
    for k in range(n):
        lab = np.zeros((32, 32, 32), np.uint32)
        lab[4:28, 6 + 3 * k:20 + 3 * k, 4:28] = k + 1
        lab[18:28, 24:30, 6:26] = 5
        img = rng.integers(0, 90, lab.shape).astype(np.uint16)
        img[lab > 0] += np.uint16(120)
        imgs.append(img)
        labs.append(lab)
    return imgs, labs


def _bn_case(dtype):
    rng = np.random.default_rng(21)
    x = rng.normal(0.7, 1.3, (4, 5, 6, 5, 4)).astype(dtype)
    return dict(x=x, dy=rng.standard_normal(x.shape).astype(dtype),
                weight=rng.uniform(0.5, 1.5, 5).astype(dtype),
                bias=rng.normal(0, 0.3, 5).astype(dtype))


class Jobs:
    """The rank job and the CLI job of this file."""

    def __init__(self, root):
        self.root = root
        self.rank_dir = os.path.join(root, "ranks")
        os.makedirs(self.rank_dir)
        self.bn = {}
        for name, dtype in (("bn64", np.float64), ("bn32", np.float32)):
            self.bn[name] = _bn_case(dtype)
            np.savez(os.path.join(root, f"{name}.npz"), **self.bn[name])
        imgs, labs = _volumes(2, seed=1)
        np.savez(os.path.join(root, "vols.npz"),
                 **{f"img{k}": a for k, a in enumerate(imgs)},
                 **{f"lab{k}": a for k, a in enumerate(labs)})
        xs, ys = box_batch(40, batch=7)
        np.savez(os.path.join(root, "list.npz"), xs=xs, ys=ys)
        # the ragged epoch's last batch alone: its one step is ragged
        self.tail = (xs[4:], ys[4:])
        np.savez(os.path.join(root, "tail.npz"), xs=xs[4:], ys=ys[4:])
        net = UNet3D(output_channels=3, width_multiplier=WIDTH)
        init_weights(net, torch.Generator().manual_seed(5))
        self.init = {k: v.numpy().copy() for k, v in
                     net.state_dict().items()}
        torch.save(net.state_dict(), os.path.join(root, "init.pth"))
        self.even = dict(mode="volumes", volumes=2, patch=(16, 16, 16),
                         seed=3, data=os.path.join(root, "vols.npz"),
                         kw=dict(TRAIN_KW, seed=0),
                         out=os.path.join(root, "even"), mesh=2)
        self.ragged = dict(mode="list", data=os.path.join(root, "list.npz"),
                           init=os.path.join(root, "init.pth"),
                           kw=dict(TRAIN_KW, device_augment=False),
                           out=os.path.join(root, "ragged"), mesh=2)
        self.ragged_step = dict(self.ragged,
                                data=os.path.join(root, "tail.npz"),
                                out=os.path.join(root, "ragged_step"))
        # the even epoch at lr 0: every step sees the initial weights, so
        # the per-example metrics of one process and of the mesh are equal
        self.frozen = dict(self.even, kw=dict(self.even["kw"], lr=0.0),
                           out=os.path.join(root, "frozen"))
        steps = [
            ("bn64", "sync_bn", dict(input=os.path.join(root, "bn64.npz"),
                                     steps=2)),
            ("bn32", "sync_bn", dict(input=os.path.join(root, "bn32.npz"))),
            ("collect", "collect", dict(out=os.path.join(root, "collect"))),
            ("bad_batch", "bad_batch", dict(out=os.path.join(root, "bad"))),
            ("even", "train", self.even),
            ("ragged", "train", self.ragged),
            ("ragged_step", "train", self.ragged_step),
            ("frozen", "train", self.frozen),
        ]
        self.ranks = torch_ranks.launch(self.rank_dir, steps, 2)

        self.cli_dir = os.path.join(root, "cli")
        os.makedirs(self.cli_dir)
        paths = {"images": [], "labels": []}
        for k, (img, lab) in enumerate(zip(imgs, labs)):
            for kind, arr in (("images", img), ("labels", lab)):
                path = os.path.join(root, f"{kind}{k}.zarr")
                io.write_zarr(path, arr, chunks=(16, 32, 32))
                paths[kind].append(path)
        self.cli_out = os.path.join(self.cli_dir, "runs")
        argv = [sys.executable, "-m",
                "aind_exaspim_neuron_segmentation_tpu_torch", "--device",
                "cpu", "train", "--distributed", "--output", self.cli_out,
                "--images", *paths["images"], "--labels", *paths["labels"],
                "--patch", "16", "--batch-size", "4", "--epochs", "3",
                "--lr", "1e-2", "--width-multiplier", "0.25",
                "--containment-buffer", "0", "--seed", "3"]
        # and --mesh 1 in a job of 2: rank 0 trains alone, rank 1 leaves
        self.mesh1_dir = os.path.join(root, "cli_mesh1")
        os.makedirs(self.mesh1_dir)
        self.mesh1_out = os.path.join(self.mesh1_dir, "runs")
        mesh1 = list(argv)
        mesh1[mesh1.index(self.cli_out)] = self.mesh1_out
        mesh1[mesh1.index("--epochs") + 1] = "1"
        self.cli = {
            self.cli_dir: torch_ranks.launch(self.cli_dir, None, 2,
                                             contract="torchrun", argv=argv),
            self.mesh1_dir: torch_ranks.launch(self.mesh1_dir, None, 2,
                                               argv=mesh1 + ["--mesh", "1"]),
        }

    def rank_results(self, name):
        if self.ranks is not None:
            procs, self.ranks = self.ranks, None
            torch_ranks.wait(procs, self.rank_dir, timeout=300)
        return [torch_ranks.result(self.rank_dir, name, r) for r in (0, 1)]

    def cli_logs(self, job_dir):
        """Both processes' logs of the CLI job in ``job_dir``."""
        procs = self.cli.pop(job_dir, None)
        if procs is not None:
            torch_ranks.wait(procs, job_dir, timeout=300)
        logs = []
        for rank in (0, 1):
            with open(os.path.join(job_dir, f"log.r{rank}")) as f:
                logs.append(f.read())
        return logs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    j = Jobs(str(tmp_path_factory.mktemp("dp_train")))
    yield j
    for procs in (j.ranks, *j.cli.values()):
        for p in procs or ():
            p.kill()
            p.wait()


# --- the Trainer on a mesh -------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh(jobs):
    """The JAX package's ``Trainer(mesh=make_mesh(2))`` (float32, no event
    files: importing tensorboard costs ~15 s here). Its module init is
    jitted: eager, it compiles op by op for tens of seconds."""
    orig = junet.UNet3D.init

    def jitted_init(self, key, x, train=False):
        return jax.jit(lambda k, v: orig(self, k, v, train=train))(key, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(junet.UNet3D, "init", jitted_init)
        mp.setattr(jtrain.Trainer, "_make_writer", lambda self: None)
        return jtrain.Trainer(os.path.join(jobs.root, "jax"), use_amp=False,
                              device_augment=False,
                              mesh=jparallel.make_mesh(2), **TRAIN_KW)


def _replicate(jt, tree):
    return jax.device_put(jax.tree.map(jnp.asarray, tree), jt._replicated)


def _jax_mesh_run(jobs, jt):
    """One training epoch of the JAX mesh Trainer on the ragged list data
    from the port's initial weights; returns (its final torch-layout
    state, its epoch lists)."""
    variables = jconvert.torch_state_dict_to_variables(jobs.init)
    jt.params = _replicate(jt, variables["params"])
    jt.batch_stats = _replicate(jt, variables["batch_stats"])
    jt.opt_state = _replicate(jt, jt.tx.init(jt.params))
    torch_ranks.record_epochs(jt)
    data = np.load(jobs.ragged["data"])
    jt._set_lr(jt.schedule(0))
    jt.train_step(torch_ranks.ListDataset(data["xs"], data["ys"]), 0)
    state = convert.state_dict_from_jax_variables(
        {"params": jax.tree.map(np.asarray, jt.params),
         "batch_stats": jax.tree.map(np.asarray, jt.batch_stats)})
    return {k: v.numpy() for k, v in state.items()}, jt.epoch_lists


def _jax_mesh_float64_grads(jobs, jt):
    """The JAX mesh Trainer's train step in float64 on the ragged batch
    (3 examples padded to 4 by its ``_to_device_batch``, sharded over the
    2-device mesh), from the port's initial weights: (its loss, its
    gradients in torch layout). ``accumulate_grads_quirk`` makes the step
    hand back its gradients (the running sum from zero)."""
    module64 = junet.UNet3D(output_channels=3, width_multiplier=WIDTH,
                            dtype=jnp.float64)
    step64 = jtrain.Trainer._build_train_step(types.SimpleNamespace(
        module=module64, tx=jt.tx, accumulate_grads_quirk=True,
        device_augment=False, affinity_mode=True,
        _targets_from_labels=jtrain.Trainer._targets_from_labels))
    variables = jconvert.torch_state_dict_to_variables(
        {k: v.astype(np.float64) if v.dtype.kind == "f" else v
         for k, v in jobs.init.items()})
    x, y, w = jt._to_device_batch(*jobs.tail)
    assert x.shape[0] == 4 and np.asarray(w).tolist() == [1, 1, 1, 0]
    with jax_float64():
        params = _replicate(jt, variables["params"])
        out = step64(
            params, _replicate(jt, variables["batch_stats"]),
            _replicate(jt, jt.tx.init(params)),
            _replicate(jt, jax.tree.map(jnp.zeros_like, params)),
            jax.device_put(np.asarray(x, np.float64), x.sharding), y, w,
            jax.random.PRNGKey(0))
        grads = jax.tree.map(np.asarray, out[3])
        loss = float(out[4])
    state = convert.state_dict_from_jax_variables(
        {"params": grads, "batch_stats": variables["batch_stats"]})
    return loss, {k: v.numpy() for k, v in state.items()}


def test_ragged_step_equals_the_jax_mesh_step_in_float64(jobs, jax_mesh):
    """The ragged step's loss and summed gradients on the ranks against
    the JAX mesh Trainer's step on the same padded global batch, run in
    float64: the repeated example is in the BatchNorm statistics and out
    of the loss on both sides."""
    want_loss, want = _jax_mesh_float64_grads(jobs, jax_mesh)
    ranks = jobs.rank_results("ragged_step")
    got = ranks[0]["first_grads"]
    for name, g in got.items():
        np.testing.assert_array_equal(ranks[1]["first_grads"][name], g,
                                      err_msg=name)
    (stats,) = _lists(ranks[0], "train_")
    loss_rel = abs(stats["loss"][0] - want_loss) / want_loss
    assert len(stats["precision"]) == 3
    top = max(np.abs(want[n]).max() for n in got)
    grad_worst = noise = 0.0
    for name, g in got.items():
        if pre_bn_bias(name):
            noise = max(noise, float(np.abs(g).max() / top))
            continue
        rel = float(np.abs(g - want[name]).max() / np.abs(want[name]).max())
        grad_worst = max(grad_worst, rel)
    parity_line("Trainer(mesh=make_mesh(2)) ragged step (3 of 4 rows) vs "
                "the JAX mesh step in float64", loss_rel=loss_rel,
                grad_worst_rel=grad_worst, pre_bn_bias_noise=noise)
    assert grad_worst <= RAGGED_GRAD_TOL
    assert loss_rel <= 1e-6 and noise <= 1e-5


def test_ragged_epoch_tracks_the_jax_mesh_trainer(jobs, jax_mesh):
    want, jlists = _jax_mesh_run(jobs, jax_mesh)
    ranks = jobs.rank_results("ragged")
    for key, value in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][key], value,
                                      err_msg=key)
    worst = 0.0
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")):
            continue
        worst = max(worst, float(np.abs(ranks[0]["state"][key] - w).max()))
    (got,) = _lists(ranks[0], "train_")
    (jwant,) = [s for p, s in jlists if p == "train_"]
    assert len(got["precision"]) == len(jwant["precision"]) == 7
    assert len(got["loss"]) == len(jwant["loss"]) == 2
    loss_rel = [abs(a - b) / b for a, b in zip(got["loss"], jwant["loss"])]
    parity_line("Trainer(mesh=make_mesh(2)) ragged epoch vs JAX "
                "Trainer(mesh=make_mesh(2))", param_max_abs=worst,
                loss_rel=loss_rel)
    assert worst <= 5e-3
    assert loss_rel[0] <= 1e-5 and loss_rel[1] <= 1e-3


def _single(jobs, spec):
    """The port's single process on a train step's data (without event
    files, whose tensorboard import costs ~15 s here)."""
    with torch_ranks.one_thread(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(train.Trainer, "_make_writer", lambda self: None)
        out = "single_" + os.path.basename(spec["out"])
        return torch_ranks.run_train(spec, os.path.join(jobs.root, out),
                                     None)


def _lists(run, prefix):
    return [stats for p, stats in run["epochs"] if p == prefix]


def test_even_epoch_ranks_equal_and_track_one_process(jobs):
    ranks = jobs.rank_results("even")
    for key, value in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][key], value,
                                      err_msg=key)
    one = _single(jobs, jobs.even)
    top = max(np.abs(g).max() for g in one["first_grads"].values())
    grad_worst = noise = 0.0
    for name, want in one["first_grads"].items():
        got = ranks[0]["first_grads"][name]
        if pre_bn_bias(name):
            noise = max(noise, float(np.abs(got).max() / top),
                        float(np.abs(want).max() / top))
            continue
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel <= 1e-4, (name, rel)
        grad_worst = max(grad_worst, rel)
    stat_worst = max(
        float(np.abs(ranks[0]["first_stats"][k] - want).max()
              / np.abs(want).max())
        for k, want in one["first_stats"].items())
    param_worst = 0.0
    for key, want in one["state"].items():
        got = ranks[0]["state"][key]
        if key.endswith("num_batches_tracked"):
            assert got == want
        elif not key.endswith(("running_mean", "running_var")):
            param_worst = max(param_worst, float(np.abs(got - want).max()))
    (got,), (want,) = _lists(ranks[0], "train_"), _lists(one, "train_")
    assert len(got["precision"]) == len(want["precision"]) == 8
    # the first step's metrics come from the same weights
    assert got["precision"][:4] == want["precision"][:4]
    parity_line("Trainer(mesh=make_mesh(2)) even epoch vs one process",
                grad_worst_rel=grad_worst, pre_bn_bias_noise=noise,
                param_max_abs=param_worst,
                running_stats_rel=stat_worst, ranks_bit_equal=True)
    steps = len(got["loss"])
    assert param_worst <= 2 * LR * steps and stat_worst <= 1e-5
    assert noise <= 1e-5


def test_even_epoch_metrics_equal_one_process(jobs):
    ranks = jobs.rank_results("frozen")
    one = _single(jobs, jobs.frozen)
    for prefix in ("train_", "val_"):
        (got,), (want,) = _lists(ranks[0], prefix), _lists(one, prefix)
        assert len(got["precision"]) == len(want["precision"]) > 0
        for key in ("precision", "recall"):  # nan where a class is empty
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=prefix + key)
        assert len(got["loss"]) == len(want["loss"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    parity_line("even epoch at lr 0: metric lists vs one process",
                equal=True, n_train=len(_lists(one, "train_")[0]["precision"]))


def test_gathered_metrics_run_in_block_order(jobs):
    got = jobs.rank_results("collect")
    assert got[0] == got[1]
    assert got[0]["loss"] == [1.0, 21.0, 41.0]
    assert got[0]["precision"] == [0.0, 1.0, 2.0, 3.0, 100.0, 101.0, 102.0,
                                   200.0]
    assert got[0]["recall"] == [-0.0, -1.0, -2.0, -3.0, -100.0, -101.0,
                                -102.0, -200.0]


def test_batch_that_does_not_divide_raises(jobs):
    for res in jobs.rank_results("bad_batch"):
        assert res["error"] and "divide" in res["error"]


def test_cli_train_distributed(jobs):
    logs = jobs.cli_logs(jobs.cli_dir)
    lines = [ln for log in logs for ln in log.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, logs
    assert lines[0] in logs[0]
    run0 = json.loads(lines[0])["train"]
    assert os.path.dirname(run0) == jobs.cli_out
    rank1 = os.path.join(jobs.cli_out, ".rank1")
    (session1,) = os.listdir(rank1)
    pths = []
    for run in (run0, os.path.join(rank1, session1)):
        names = [n for n in os.listdir(run) if n.endswith(".pth")]
        assert names, run
        pths.append(torch.load(os.path.join(run, names[0])))
    for key, value in pths[0].items():
        assert torch.equal(pths[1][key], value), key
    parity_line("CLI train --distributed, 2 processes", json_lines=1,
                rank1_pth_equal=True)


def test_cli_train_mesh_below_the_job(jobs):
    """``--mesh 1`` in a job of 2: rank 0 trains alone and prints the one
    line, rank 1 exits 0 with a note and writes nothing."""
    logs = jobs.cli_logs(jobs.mesh1_dir)
    lines = [ln for ln in logs[0].splitlines() if ln.startswith("{")]
    assert len(lines) == 1, logs
    assert os.path.dirname(json.loads(lines[0])["train"]) == jobs.mesh1_out
    assert "not among the first 1 ranks" in logs[1]
    assert not any(ln.startswith("{") for ln in logs[1].splitlines())
    assert os.listdir(jobs.mesh1_out) == [os.path.basename(
        json.loads(lines[0])["train"])]


# --- the synchronized BatchNorm --------------------------------------------


def _native_bn(case, steps):
    """``nn.BatchNorm3d`` over the whole batch, ``steps`` forward and
    backward passes (the input gradient accumulates)."""
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    bn = torch.nn.BatchNorm3d(x.shape[1]).to(x.dtype).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(case["weight"]))
        bn.bias.copy_(torch.from_numpy(case["bias"]))
    for _ in range(steps):
        y = bn(x)
        y.backward(torch.from_numpy(case["dy"]))
    out = dict(y=y.detach().numpy(), dx=x.grad.numpy(),
               dweight=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy())
    out.update({k: v.numpy() for k, v in bn.state_dict().items()})
    return out


@pytest.mark.parametrize("name,steps,tol", [("bn64", 2, 1e-12),
                                            ("bn32", 1, 1e-5)])
def test_sync_batchnorm_equals_native_over_the_whole_batch(jobs, name, steps,
                                                           tol):
    got = jobs.rank_results(name)
    want = _native_bn(jobs.bn[name], steps)
    figures = {}
    for key in ("y", "dx"):
        both = np.concatenate([g[key] for g in got])
        scale = np.abs(want[key]).max()
        figures[key] = float(np.abs(both - want[key]).max() / scale)
    for key in ("dweight", "dbias"):
        both = got[0][key] + got[1][key]
        figures[key] = float(np.abs(both - want[key]).max()
                             / np.abs(want[key]).max())
    for key in ("running_mean", "running_var", "weight", "bias"):
        for g in got:
            np.testing.assert_array_equal(g[key], got[0][key])
        figures[key] = float(np.abs(got[0][key] - want[key]).max()
                             / np.abs(want[key]).max())
    for g in got:
        assert int(g["num_batches_tracked"]) == steps
    parity_line(f"sync BatchNorm over 2 gloo ranks vs nn.BatchNorm3d "
                f"({name}, relative)", **figures)
    assert max(figures.values()) <= tol, figures
