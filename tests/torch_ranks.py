"""Rank program of the port's multi-rank CPU tests (gloo).

Every process of a job runs::

    python -m tests.torch_ranks JOB_DIR

with the job in its environment (``parallel.initialize_distributed``'s
contracts: ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` or ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``). It reads the steps of ``JOB_DIR/job.pkl``, a list of ``(name,
kind, spec)``, runs them in order, and pickles each step's result on this
rank to ``JOB_DIR/<name>.r<rank>.pkl``. It imports neither JAX nor the JAX
package, so a job starts in a few seconds; the test that launched it holds
the results against the JAX package. A step that raises records the
error and the job goes on.
"""

import os
import pickle
import subprocess
import sys
import time
import traceback

import contextlib

import numpy as np
import torch

torch.set_num_threads(1)


@contextlib.contextmanager
def one_thread():
    """Run the block on one CPU thread, as every rank does: the CPU's
    float32 convolutions sum in an order that depends on the thread
    count, so a reference made in the test process must match it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _load_input(spec):
    from aind_exaspim_neuron_segmentation_tpu_torch import io

    path = spec["input"]
    if path.endswith(".npy"):
        return np.load(path)
    return io.read(path)


def _mesh(parallel, shape):
    if len(shape) == 1:
        return parallel.make_mesh(shape[0])
    return parallel.make_mesh_2d(tuple(shape))


class ListDataset:
    """A fixed list of (x, y) examples from ``xs`` / ``ys`` arrays: a
    dataset of any length, e.g. one whose last batch is ragged."""

    def __init__(self, xs, ys):
        self.xs, self.ys = xs, ys

    def __len__(self):
        return len(self.xs)

    def __getitem__(self, i):
        return self.xs[i], self.ys[i]


def record_epochs(trainer):
    """Keep each epoch's loss, precision and recall lists (``train_`` and
    ``val_``) in ``trainer.epoch_lists`` before the Trainer reduces them
    to means."""
    import copy

    trainer.epoch_lists = []
    reduce = trainer.update_tensorboard

    def update_tensorboard(stats, epoch, prefix):
        trainer.epoch_lists.append((prefix, copy.deepcopy(stats)))
        return reduce(stats, epoch, prefix)

    trainer.update_tensorboard = update_tensorboard


def record_first_step(trainer):
    """Keep what the optimizer's first step sees: the gradients (summed
    over the mesh) in ``trainer.first_grads`` and the BatchNorm running
    statistics the first forward left in ``trainer.first_stats``, by
    name."""
    step = trainer.optimizer.step
    trainer.first_grads = trainer.first_stats = None

    def first(*args, **kwargs):
        if trainer.first_grads is None:
            trainer.first_grads = {
                n: p.grad.detach().numpy().copy()
                for n, p in trainer.model.named_parameters()}
            trainer.first_stats = {
                n: b.numpy().copy() for n, b in trainer.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))}
        return step(*args, **kwargs)

    trainer.optimizer.step = first


def train_datasets(data, spec):
    """(train, validation) datasets of a train step's ``data`` npz."""
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
        data_handling as dh,
    )

    if spec["mode"] == "list":
        ds = ListDataset(data["xs"], data["ys"])
        return ds, ds
    imgs = [data[f"img{k}"] for k in range(spec["volumes"])]
    labs = [data[f"lab{k}"] for k in range(spec["volumes"])]
    patch = tuple(spec["patch"])
    return (dh.TrainDataset(imgs, labs, patch_shape=patch, seed=spec["seed"],
                            return_label_patches=True),
            dh.ValidateDataset(imgs, labs, patch_shape=patch,
                               containment_buffer=0))


def run_train(spec, out_dir, mesh):
    """A Trainer (on ``mesh``, or alone with None) run on a train step's
    data; its final state, first-step gradients and epoch lists."""
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
        train,
    )

    data = np.load(spec["data"])
    trainer = train.Trainer(out_dir, mesh=mesh, device="cpu", **spec["kw"])
    if spec.get("init"):
        trainer.model.load_state_dict(torch.load(spec["init"]))
    record_epochs(trainer)
    record_first_step(trainer)
    best = trainer.run(*train_datasets(data, spec))
    return dict(
        state={k: v.numpy().copy()
               for k, v in trainer.model.state_dict().items()},
        first_grads=trainer.first_grads, first_stats=trainer.first_stats,
        epochs=trainer.epoch_lists,
        best_f1=best, log_files=sorted(os.listdir(trainer.log_dir)))


def run_step(kind, spec, models):
    """One step's result on this rank (None where it has none)."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import (
        inference,
        parallel,
        postprocess,
    )

    if kind == "init":
        # a second call on the joined group changes nothing
        again = parallel.initialize_distributed(device="cpu")
        return dict(again=again, world=dist.get_world_size(),
                    rank=dist.get_rank(),
                    backend=dist.get_backend())
    if kind == "stats":
        mesh = _mesh(parallel, spec["mesh"])
        if mesh.coords is None:
            return None
        x = np.load(spec["input"])
        part = np.array_split(x.ravel(), mesh.size)[
            int(np.ravel_multi_index(mesh.coords, mesh.shape))]
        from aind_exaspim_neuron_segmentation_tpu_torch.parallel import stats

        ks = spec["ks"]
        vals = stats.order_stats_sharded(torch.from_numpy(part), ks, mesh)
        pct = stats.percentile_sharded(torch.from_numpy(part), spec["qs"],
                                       x.size, mesh)
        return dict(order=vals.numpy(), pct=pct.numpy())
    if kind == "predict":
        mesh = _mesh(parallel, spec["mesh"])
        if mesh.coords is None:
            return None
        key = (spec["ckpt"], spec.get("affinity_mode", True))
        if key not in models:
            models[key] = inference.load_model(
                key[0], affinity_mode=key[1], device="cpu",
                width_multiplier=0.25)
        try:
            out = parallel.predict_sharded(
                _load_input(spec), models[key], mesh=mesh, **spec["kw"])
        except ValueError as exc:
            return dict(error=str(exc))
        origin = mesh.coords == (0,) * len(mesh.shape)
        if isinstance(out, tuple):
            if isinstance(out[0], np.ndarray):
                return dict(arrays=out)
            return dict(arrays=tuple(np.asarray(h[:]) for h in out)
                        if origin else None)
        if isinstance(out, np.ndarray):
            return dict(arrays=(out,))
        return dict(arrays=(np.asarray(out[:]),) if origin else None)
    if kind == "segment":
        pair = spec.get("pair")
        affs = (tuple(_load_input(dict(input=p)) for p in pair) if pair
                else _load_input(spec))
        stats_out = {}
        out = postprocess.segment_streaming_sharded(
            affs, stats_out=stats_out, device="cpu", **spec["kw"])
        if isinstance(out, tuple):
            return dict(z0=out[0], labels=out[1], stats=stats_out)
        return dict(labels=np.asarray(out[:]), stats=stats_out)
    if kind == "skeleton":
        stats_out = {}
        local = postprocess.skeletonize_sharded(
            _load_input(spec), stats_out=stats_out, **spec["kw"])
        return dict(swc={k: v.to_swc() for k, v in local.items()},
                    stats=stats_out)
    if kind == "sync_bn":
        from aind_exaspim_neuron_segmentation_tpu_torch.parallel import (
            sync_batchnorm,
        )

        data = np.load(spec["input"])
        rank, world = dist.get_rank(), dist.get_world_size()
        x = torch.from_numpy(np.array_split(data["x"], world)[rank])
        dy = torch.from_numpy(np.array_split(data["dy"], world)[rank])
        bn = sync_batchnorm.SyncBatchNorm3d(
            x.shape[1], mesh=parallel.make_mesh()).to(x.dtype)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(data["weight"]))
            bn.bias.copy_(torch.from_numpy(data["bias"]))
        x.requires_grad_(True)
        out = {}
        for _ in range(spec.get("steps", 1)):
            y = bn(x)
            y.backward(dy)
        out.update(y=y.detach().numpy(), dx=x.grad.numpy(),
                   dweight=bn.weight.grad.numpy(),
                   dbias=bn.bias.grad.numpy())
        out.update({k: v.numpy() for k, v in bn.state_dict().items()})
        return out
    if kind == "train":
        rank = dist.get_rank()
        out_dir = os.path.join(spec["out"], f"r{rank}")
        return run_train(spec, out_dir, parallel.make_mesh(spec["mesh"]))
    if kind == "bad_batch":
        from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (  # noqa: E501
            train,
        )

        try:
            train.Trainer(spec["out"], batch_size=3, width_multiplier=0.25,
                          mesh=parallel.make_mesh(2), device="cpu")
        except ValueError as exc:
            return dict(error=str(exc))
        return dict(error=None)
    if kind == "collect":
        # every rank's per-example metrics, two ragged steps (the last
        # with one row a rank): the gathered lists must run in block
        # order and stop at n_real
        from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (  # noqa: E501
            train,
        )

        trainer = train.Trainer(spec["out"], batch_size=4,
                                width_multiplier=0.25,
                                mesh=parallel.make_mesh(2), device="cpu")
        rank = dist.get_rank()
        pending = [
            (n_real, torch.tensor(10.0 * step + rank),
             torch.tensor([100.0 * step + rows * rank + i
                           for i in range(rows)]),
             torch.tensor([-100.0 * step - rows * rank - i
                           for i in range(rows)]))
            for step, (n_real, rows) in enumerate(((4, 2), (3, 2), (1, 1)))]
        stats = {"loss": [], "precision": [], "recall": []}
        trainer._collect(pending, stats)
        return stats
    raise ValueError(f"unknown step kind {kind!r}")


def main(job_dir):
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import parallel

    if not parallel.initialize_distributed(device="cpu"):
        raise SystemExit("no multi-rank job in the environment")
    rank = dist.get_rank()
    with open(os.path.join(job_dir, "job.pkl"), "rb") as f:
        steps = pickle.load(f)
    models = {}
    for name, kind, spec in steps:
        try:
            result = run_step(kind, spec, models)
        except Exception:  # recorded for the test to report
            result = dict(raised=traceback.format_exc())
        with open(os.path.join(job_dir, f"{name}.r{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    dist.destroy_process_group()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job_dir, steps, world, contract="jax", argv=None):
    """Start ``world`` rank processes on the steps; returns the processes.

    ``contract``: which environment names carry the job, the JAX
    package's (``"jax"``) or torchrun's (``"torchrun"``). ``argv``: run
    this command in every rank instead of the rank program (``steps`` is
    then None), e.g. the port's CLI with ``--distributed``.
    """
    if argv is None:
        argv = [sys.executable, "-m", "tests.torch_ranks", job_dir]
        with open(os.path.join(job_dir, "job.pkl"), "wb") as f:
            pickle.dump(steps, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        if contract == "jax":
            env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES=str(world),
                       JAX_PROCESS_ID=str(rank))
        else:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank),
                       LOCAL_RANK=str(rank))
        log = open(os.path.join(job_dir, f"log.r{rank}"), "w")
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait(procs, job_dir, timeout):
    """Wait for every rank (killing all past ``timeout`` seconds); raise
    with the ranks' logs unless each exited 0."""
    deadline = time.time() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.time(), 1)))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if any(c != 0 for c in codes):
        logs = []
        for rank in range(len(procs)):
            with open(os.path.join(job_dir, f"log.r{rank}")) as f:
                logs.append(f"--- rank {rank} ({codes[rank]}):\n"
                            + f.read()[-3000:])
        raise RuntimeError("rank job failed:\n" + "\n".join(logs))


def result(job_dir, name, rank):
    """Rank ``rank``'s result of step ``name``; raises what the step
    raised."""
    with open(os.path.join(job_dir, f"{name}.r{rank}.pkl"), "rb") as f:
        out = pickle.load(f)
    if isinstance(out, dict) and "raised" in out:
        raise RuntimeError(f"step {name} on rank {rank}:\n{out['raised']}")
    return out


if __name__ == "__main__":
    main(sys.argv[1])
