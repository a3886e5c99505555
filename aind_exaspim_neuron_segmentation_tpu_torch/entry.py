"""Entry points: a one-device forward check and a multi-rank dry run.

:func:`entry` returns the flagship model's forward step and its inputs:
the full-width ``UNet3D`` in bfloat16 on one 96^3 patch.
:func:`dryrun_multichip` runs the multi-rank paths once at tiny shapes
over ``n`` rank processes: the data-parallel train step, a forward with
the batch split over a 2-D mesh, ``predict_sharded`` on a 1-D and a 2-D
mesh (and its on-device digest), then the distributed segmentation and
skeletonization, each held bit for bit to one process.

Run ``python -m aind_exaspim_neuron_segmentation_tpu_torch.entry [N]
[--device cpu]`` for ``dryrun_multichip(N)`` (default 8). On one card the
ranks share it over gloo (NCCL refuses two ranks on one device).
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import (
    UNet3D,
    init_weights,
)
from aind_exaspim_neuron_segmentation_tpu_torch.parallel import launch

MODULE = "aind_exaspim_neuron_segmentation_tpu_torch.entry"
PATCH = (16, 16, 16)
VOLUME = (48, 44, 20)
PREDICT_KW = dict(patch_shape=PATCH, overlap=(8, 8, 4), trim=2,
                  batch_size=4)


def entry(device=None):
    """(forward step on the flagship UNet3D, its arguments).

    ``module``: ``UNet3D(output_channels=3)`` at full width, bfloat16,
    eval mode, weights from a ``torch.Generator`` seeded 0; ``x``: one
    (1, 1, 96, 96, 96) float32 patch from ``np.random.default_rng(0)``.
    ``forward_step(module, x)`` returns the sigmoid of the float32 logits,
    (1, 3, 96, 96, 96). ``device`` defaults to ``cuda`` (raises without
    one).
    """
    dev = resolve_device(device)
    module = UNet3D(output_channels=3)
    init_weights(module, torch.Generator().manual_seed(0))
    module = module.to(device=dev, dtype=torch.bfloat16).eval()

    def forward_step(module, x):
        with torch.inference_mode():
            return torch.sigmoid(module(x).float())

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 1, 96, 96, 96)).astype(np.float32)).to(dev)
    return forward_step, (module, x)


def _rank_main(work, device):
    """One rank of :func:`dryrun_multichip`: phases 1-3 on this rank's
    device; its figures go to ``work/rank<r>.json`` and, from rank 0, the
    model to ``work/model.pth`` and the results to stores in ``work``."""
    import torch.distributed as dist

    from aind_exaspim_neuron_segmentation_tpu_torch import inference, parallel
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.train import (  # noqa: E501
        Trainer,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter
    from aind_exaspim_neuron_segmentation_tpu_torch.parallel.mesh import (
        all_reduce_sum,
    )

    parallel.initialize_distributed(device=device)
    n, rank = dist.get_world_size(), dist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    out = dict(rank=rank, backend=dist.get_backend())

    # Phase 1: the train step, data-parallel over the mesh.
    mesh = parallel.make_mesh(n)
    trainer = Trainer(os.path.join(work, f"trainer{rank}"), batch_size=n,
                      max_epochs=1, width_multiplier=0.25, use_amp=False,
                      mesh=mesh, device=dev)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((n, 1, *PATCH)).astype(np.float32)
    ys = (rng.uniform(size=(n, 3, *PATCH)) > 0.5).astype(np.float32)
    loss, _, _ = trainer.train_batch(xs, ys)
    out["loss"] = float(all_reduce_sum(loss.detach().clone(), mesh))

    # Phase 2: the eval forward with the batch split over the data axis of
    # a (data, space) mesh, gathered, against one process's forward of
    # each block (a batch of another size may round differently)
    space = 2 if n % 2 == 0 else 1
    data = n // space
    mesh2 = parallel.make_mesh_2d((data, space), axis_names=("data", "space"))
    rows = parallel.sharded_first_axis(mesh2, "data")
    x2 = torch.from_numpy(
        rng.standard_normal((data, 1, *PATCH)).astype(np.float32)).to(dev)
    module = trainer.model.eval()
    with torch.inference_mode():
        got = rows.gather(module(rows.place(x2)))
        size = data // rows.blocks
        want = torch.cat([module(x2[b * size:(b + 1) * size])
                          for b in range(rows.blocks)])
    if not torch.equal(got, want):
        raise RuntimeError(
            f"rank {rank}: data-split forward differs from one process's "
            f"(max abs {(got - want).abs().max().item()})")
    out["mesh2"] = [data, space]
    out["forward_out"] = list(got.shape)

    # Phase 3: predict_sharded over the 1-D and the 2-D mesh, then the
    # on-device digest, each into a shared store
    runner = inference.ModelRunner(module)
    vol = rng.uniform(0, 1000, VOLUME).astype(np.float32)
    if rank == 0:
        torch.save(module.state_dict(), os.path.join(work, "model.pth"))
        np.save(os.path.join(work, "volume.npy"), vol)
    mesh_b = (parallel.make_mesh_2d((n // 2, 2)) if n % 2 == 0
              else parallel.make_mesh(n))
    scatter.scatter_batch.launches = 0
    aff = parallel.predict_sharded(
        vol, runner, mesh=parallel.make_mesh(n),
        out_path=os.path.join(work, "aff_1d.zarr"), **PREDICT_KW)
    out["aff_1d"] = list(aff.shape)
    if n % 2 == 0:
        aff2 = parallel.predict_sharded(
            vol, runner, mesh=mesh_b,
            out_path=os.path.join(work, "aff_2d.zarr"), **PREDICT_KW)
        out["aff_2d"] = list(aff2.shape)
    plan, qaff = parallel.predict_sharded(
        vol, runner, mesh=mesh_b, predigest=True,
        out_path=(os.path.join(work, "plan.zarr"),
                  os.path.join(work, "qaff.zarr")), **PREDICT_KW)
    out["k1_launches"] = scatter.scatter_batch.launches
    out["plan"], out["qaff"] = list(plan.shape), list(qaff.shape)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dryrun_multichip(n_devices=8, device=None, work_dir=None, timeout=900):
    """Run the multi-rank paths once over ``n_devices`` rank processes.

    The ranks (``python -m ...entry --dryrun-rank``, gloo, on ``device``:
    default ``cuda``, raising without one; several ranks share a card)
    take 1. one data-parallel ``Trainer`` step (width 0.25, a seeded 16^3
    batch of ``n_devices``); 2. the eval forward with the batch split
    over the data axis of a (n/2, 2) mesh, bit-equal to one process's;
    3. ``predict_sharded`` of a (48, 44, 20) volume on a 1-D mesh, on a
    2-D mesh when ``n_devices`` is even, and with ``predigest=True``,
    each rank's K1 launches counted. This process then runs 4. the
    distributed segmentation of the digest over ``min(4, n)`` virtual
    ranks, bit-equal to ``affinities_to_segmentation``, and 5. the
    distributed skeletonization of its labels from a zarr store, every
    SWC text equal to ``skeletonize``'s.

    A rank that fails or outlives ``timeout`` seconds raises here with
    every rank's log tail. ``work_dir`` keeps the artifacts (the model,
    the volume, the stores, the labels and the SWC zip); default a
    temporary directory. Returns the per-phase figures and prints one
    line per phase.
    """
    if n_devices < 2:
        raise ValueError(f"a dry run needs at least 2 ranks, not {n_devices}")
    dev = resolve_device(device)
    if work_dir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return _dryrun(n_devices, dev, tmp, timeout)
    os.makedirs(work_dir, exist_ok=True)
    return _dryrun(n_devices, dev, work_dir, timeout)


def _dryrun(n, dev, work, timeout):
    from aind_exaspim_neuron_segmentation_tpu_torch import inference
    from aind_exaspim_neuron_segmentation_tpu_torch.io import zarr_lite
    from aind_exaspim_neuron_segmentation_tpu_torch.postprocess.distributed import (  # noqa: E501
        segment_streaming_virtual,
        skeletonize_virtual,
    )

    launch.run(launch.module_argv(MODULE, "--dryrun-rank", work,
                                  "--device", dev.type),
               n, work, "dryrun", timeout)
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    fig = dict(mesh=n, loss=r0["loss"], mesh2=r0["mesh2"],
               forward_out=r0["forward_out"], aff_1d=r0["aff_1d"],
               aff_2d=r0.get("aff_2d"), plan=r0["plan"], qaff=r0["qaff"],
               k1_launches=[r["k1_launches"] for r in ranks])
    print(f"dryrun_multichip phase 1 (dp train step): mesh={n} "
          f"loss={fig['loss']:.4f}")
    print(f"dryrun_multichip phase 2 (dp x sp forward): "
          f"mesh=({fig['mesh2'][0]}x{fig['mesh2'][1]}) "
          f"out={tuple(fig['forward_out'])}")
    msg = f"1-D out={tuple(fig['aff_1d'])}"
    if fig["aff_2d"]:
        msg += f", 2-D ({n // 2}x2) out={tuple(fig['aff_2d'])}"
    msg += (f", predigest plan={tuple(fig['plan'])} "
            f"qaff={tuple(fig['qaff'])}; K1 launches per rank "
            f"{fig['k1_launches']}")
    print(f"dryrun_multichip phase 3 (sharded inference): {msg}")

    # Phase 4: the distributed segmentation protocol over virtual ranks
    pair = (zarr_lite.open_zarr(os.path.join(work, "plan.zarr"))[:],
            zarr_lite.open_zarr(os.path.join(work, "qaff.zarr"))[:])
    n_ranks = min(4, n)
    seg = segment_streaming_virtual(pair, n_ranks, min_segment_size=0,
                                    device=dev)
    want = inference.affinities_to_segmentation(pair, min_segment_size=0)
    if not np.array_equal(seg, want):
        raise RuntimeError("distributed segmentation mismatch")
    fig.update(ranks=n_ranks, n_segments=int(seg.max()))
    print(f"dryrun_multichip phase 4 (distributed segmentation, "
          f"component-partitioned merge): ranks={n_ranks} "
          f"n_segments={fig['n_segments']} bit-identical")

    # Phase 5: the distributed skeletonization of a label store
    seg_path = os.path.join(work, "dryrun_seg.zarr")
    zarr_lite.write_zarr(seg_path, seg, chunks=(8,) + seg.shape[1:])
    skels = skeletonize_virtual(zarr_lite.open_zarr(seg_path), n_ranks)
    want_sk = inference.skeletonize(seg)
    if set(skels) != set(want_sk):
        raise RuntimeError("distributed skeleton label set")
    for lab, sk in want_sk.items():
        if sk.to_swc() != skels[lab].to_swc():
            raise RuntimeError(f"distributed skeleton mismatch, label {lab}")
    inference.skeletons_to_zipped_swcs(
        skels, os.path.join(work, "dryrun_swcs.zip"))
    fig["n_skeletons"] = len(skels)
    print(f"dryrun_multichip phase 5 (distributed skeletonization): "
          f"ranks={n_ranks} n_skeletons={fig['n_skeletons']} bit-identical")
    return fig


def main(argv):
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if argv[:1] == ["--dryrun-rank"]:
        return _rank_main(argv[1], resolve_device(device).type)
    fig = dryrun_multichip(int(argv[0]) if argv else 8, device=device)
    print(json.dumps(fig))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
