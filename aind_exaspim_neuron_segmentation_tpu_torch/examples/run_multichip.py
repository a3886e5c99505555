"""Multi-rank inference example.

Demonstrates the rank-mesh path end to end: a blosc-compressed Zarr
volume streams shard by shard through ``parallel.predict_sharded`` on a
1-D and a 2-D rank mesh, normalized by exact mesh-wide order statistics,
with the results streamed into Zarr stores; then the mesh's on-device
digest is segmented.

Every rank is a process driving one device. Under a launcher (torchrun,
or the JAX package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID``) each process is one rank of that job; run alone,
the example starts 8 local gloo ranks of itself, which share one card
(NCCL refuses two ranks on one device), and prints their result.

Usage::

    python -m aind_exaspim_neuron_segmentation_tpu_torch.examples.run_multichip \
        [output_dir] [--device cpu]
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from aind_exaspim_neuron_segmentation_tpu_torch import inference, parallel
from aind_exaspim_neuron_segmentation_tpu_torch.core.device import (
    resolve_device,
)
from aind_exaspim_neuron_segmentation_tpu_torch.examples import (
    parser,
    predict_kw,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read, zarr_lite
from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter
from aind_exaspim_neuron_segmentation_tpu_torch.parallel import launch

MODULE = "aind_exaspim_neuron_segmentation_tpu_torch.examples.run_multichip"
RANKS = 8


def rank_main(out_dir, device, width_multiplier=0.25, **kw):
    """The example on this rank of the job; rank 0 also segments the
    digest and compares the 1-D result with one process's ``predict``.
    Each rank's figures go to ``out_dir/rank<r>.json``."""
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device.type == "cuda" else device)

    # A blosc-compressed input store (the AIND production default).
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 1500, (96, 64, 48)).astype(np.uint16)
    in_path = os.path.join(out_dir, "input.zarr")
    if rank == 0:
        zarr_lite.write_zarr(
            in_path, vol, chunks=(32, 32, 32),
            compressor={"id": "blosc", "cname": "lz4", "clevel": 5,
                        "shuffle": 1},
        )
    dist.barrier()

    runner = inference.load_model(width_multiplier=width_multiplier,
                                  device=dev)
    kw = dict(kw, batch_size=4)
    out = dict(rank=rank)
    scatter.scatter_batch.launches = 0

    # 1-D Z-sharded, lazy in, zarr out.
    out_path = os.path.join(out_dir, "affinities.zarr")
    aff = parallel.predict_sharded(
        read(in_path), runner, mesh=parallel.make_mesh(world),
        out_path=out_path, **kw,
    )
    say = print if rank == 0 else (lambda *a: None)
    say(f"1-D mesh ({world}) -> {out_path}: shape {aff.shape}")

    # 2-D (Z x Y) mesh with gaussian blending, banded for bounded memory.
    mesh2 = (parallel.make_mesh_2d((world // 2, 2)) if world % 2 == 0
             else parallel.make_mesh(world))
    out_2d = os.path.join(out_dir, "affinities_2d.zarr")
    aff2 = parallel.predict_sharded(
        read(in_path), runner, mesh=mesh2, blend_mode="gaussian",
        max_band_rows=2, out_path=out_2d, **kw,
    )
    say(f"2-D mesh {mesh2.shape} (banded, gaussian) -> {out_2d}: shape "
        f"{aff2.shape}")

    # The volume->segmentation path: every rank digests its own blended
    # region on its device, so only 4 bytes/voxel leave it and the host
    # watershed replays pure integer work.
    plan, qaff = parallel.predict_sharded(
        read(in_path), runner, mesh=mesh2, predigest=True,
        out_path=(os.path.join(out_dir, "plan.zarr"),
                  os.path.join(out_dir, "qaff.zarr")), **kw,
    )
    out["k1_launches"] = scatter.scatter_batch.launches
    if rank == 0:
        seg = inference.affinities_to_segmentation((plan[:], qaff[:]))
        out["n_segments"] = int(seg.max())
        say(f"predigest -> segmentation: {seg.shape}, {seg.max()} segments")
        # The 1-D float path agrees with one process's predict.
        want = inference.predict(vol, runner, verbose=False, **kw)
        out["max_abs_1d"] = float(np.abs(aff[:] - want).max())
        say("1-D vs single-process max |diff|:", out["max_abs_1d"])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    return out


def main(out_dir="./multichip_out", device=None, width_multiplier=0.25,
         ranks=RANKS, timeout=900, **kw):
    """Run the example: as this rank of a launched job, or over ``ranks``
    local gloo ranks started here. ``kw``: ``predict_sharded``'s grid
    keywords (default patch 32, overlap 8, trim 2). Returns rank 0's
    result with every rank's K1 launches."""
    dev = resolve_device(device)
    kw = kw or dict(patch_shape=(32,) * 3, overlap=(8,) * 3, trim=2)
    os.makedirs(out_dir, exist_ok=True)
    if parallel.initialize_distributed(device=dev):
        try:
            return rank_main(out_dir, dev, width_multiplier, **kw)
        finally:
            dist.destroy_process_group()
    argv = launch.module_argv(
        MODULE, out_dir, "--device", dev.type, "--width", width_multiplier,
        "--patch", kw["patch_shape"][0], "--overlap", kw["overlap"][0],
        "--trim", kw["trim"])
    logs = launch.run(argv, ranks, out_dir, "multichip", timeout)
    print(logs[0], end="")
    results = []
    for r in range(ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    result = dict(results[0], k1_launches=[r["k1_launches"]
                                           for r in results])
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0], "./multichip_out", width=0.25,
                  patch=32, overlap=8, trim=2).parse_args(sys.argv[1:])
    main(args.out_dir, args.device, args.width, **predict_kw(args))
