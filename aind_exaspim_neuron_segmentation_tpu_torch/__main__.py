"""Command-line interface: the README workflows as one-line commands.

    python -m aind_exaspim_neuron_segmentation_tpu_torch predict \\
        --input vol.zarr --model weights.pth --output affs.zarr
    python -m aind_exaspim_neuron_segmentation_tpu_torch segment \\
        --affinities affs.zarr --output seg.zarr
    python -m aind_exaspim_neuron_segmentation_tpu_torch swc \\
        --segmentation seg.zarr --output skeletons.zip
    python -m aind_exaspim_neuron_segmentation_tpu_torch run \\
        --input vol.zarr --model weights.pth --workdir /tmp/job \\
        --output skeletons.zip
    python -m aind_exaspim_neuron_segmentation_tpu_torch train \\
        --images a.zarr b.zarr --labels a_seg.zarr b_seg.zarr \\
        --output runs/

Every path accepts what :func:`.io.read` accepts (zarr / N5 / TIFF,
local or gs:// / s3://); volume outputs stream to Zarr stores, so
beyond-RAM volumes work end to end (``run`` uses the on-device digest
and the streaming segmentation throughout). The model, the digest of
float affinities and training run on ``--device`` (before the
subcommand; default ``cuda``, which raises without a card). Each command
prints one JSON line as its result.

``--distributed`` (every subcommand): every process of a job runs the
same command, the job taken from the environment
(``parallel.initialize_distributed``: torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, or the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``), each process driving one device; ``--workdir`` and
the outputs must lie on a filesystem every process sees::

    torchrun --nproc_per_node 2 \\
        -m aind_exaspim_neuron_segmentation_tpu_torch --device cpu \\
        run --distributed --input vol.zarr --workdir /tmp/w --output o.zip

``train --distributed`` trains data-parallel over the job's ranks
(``Trainer(mesh=)``; ``--mesh N``: over its first N, the other ranks
exiting with a note); ranks other than 0 write their checkpoints and
events under ``<output>/.rank<r>``.
"""

import argparse
import json
import os
import sys
import time


def _emit(obj):
    """Print the command's ONE machine-readable result line.

    Under ``--distributed`` every process runs the same command; only
    rank 0 prints the line.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return
    print(json.dumps(obj))


def _init_distributed(args):
    """Join the job's process group (``--distributed``) before any work;
    a single process joins nothing."""
    if args.distributed:
        from aind_exaspim_neuron_segmentation_tpu_torch import parallel

        parallel.initialize_distributed(device=args.device)


def _triple(text):
    """'96' or '96,96,96' -> (96, 96, 96)."""
    parts = [int(p) for p in text.replace("x", ",").split(",")]
    if len(parts) == 1:
        parts = parts * 3
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected 1 or 3 ints: {text!r}")
    return tuple(parts)


def _read(path):
    from aind_exaspim_neuron_segmentation_tpu_torch import io

    return io.read(path)


def _add_predict_args(p):
    p.add_argument("--model", default=None,
                   help=".pth checkpoint (default: random weights)")
    p.add_argument("--foreground", action="store_true",
                   help="1-channel foreground mode instead of affinities")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch", type=_triple, default=(96, 96, 96),
                   metavar="D,H,W")
    p.add_argument("--overlap", type=_triple, default=(32, 32, 32),
                   metavar="D,H,W")
    p.add_argument("--trim", type=int, default=8)
    p.add_argument("--brightness-clip", type=float, default=1000)
    p.add_argument("--blend", choices=("uniform", "gaussian"),
                   default="uniform")
    p.add_argument("--width-multiplier", type=float, default=1,
                   help="channel-ladder scale (must match the checkpoint)")


def cmd_predict(args):
    """Volume -> affinity Zarr store (or digest plan + qaff stores)."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    _init_distributed(args)
    runner = inference.load_model(
        args.model, affinity_mode=not args.foreground, device=args.device,
        width_multiplier=args.width_multiplier,
    )
    img = _read(args.input)
    kw = dict(
        affinity_mode=not args.foreground,
        batch_size=args.batch_size,
        brightness_clip=args.brightness_clip,
        patch_shape=args.patch,
        overlap=args.overlap,
        trim=args.trim,
        blend_mode=args.blend,
        out_path=(tuple(args.predigest_out) if args.predigest_out
                  else args.output),
        predigest=bool(args.predigest_out),
    )
    if args.distributed:
        # the sliding window sharded over every rank of the job; each
        # writes its own Z rows into the shared store
        from aind_exaspim_neuron_segmentation_tpu_torch import parallel

        parallel.predict_sharded(img, runner, mesh=parallel.make_mesh(),
                                 **kw)
    else:
        inference.predict(img, runner, verbose=not args.quiet, **kw)
    _emit({"predict": args.predigest_out or args.output})


def cmd_segment(args):
    """Affinities (float store or digest pair) -> label Zarr store."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    _init_distributed(args)
    if args.plan:
        affs = (_read(args.plan), _read(args.qaff))
    else:
        affs = _read(args.affinities)
    kw = dict(
        agglomeration_thresholds=tuple(args.thresholds),
        min_segment_size=args.min_size,
        out_path=args.output,
        verbose=not args.quiet,
        device=args.device,
    )
    if args.distributed:
        from aind_exaspim_neuron_segmentation_tpu_torch import postprocess

        stats = {}
        postprocess.segment_streaming_sharded(affs, stats_out=stats, **kw)
        # transport vs compute, per rank (the stats_out ledger)
        _emit({"segment": args.output, "protocol": stats.get("ranks")})
    else:
        inference.affinities_to_segmentation(affs, **kw)
        _emit({"segment": args.output})


def cmd_swc(args):
    """Segmentation store -> zipped SWC skeletons."""
    from aind_exaspim_neuron_segmentation_tpu_torch import inference

    _init_distributed(args)
    seg = _read(args.segmentation)
    if args.distributed:
        from aind_exaspim_neuron_segmentation_tpu_torch import postprocess

        # each rank keeps only ITS labels' skeletons; rank 0 writes the
        # zip from the ranks' SWC texts
        stats = {}
        skeletons = postprocess.skeletonize_sharded(
            seg, anisotropy=tuple(args.anisotropy), zip_path=args.output,
            stats_out=stats,
        )
        _emit({"swc": args.output,
               "n": stats.get("n_skeletons", len(skeletons)),
               "protocol": stats.get("ranks")})
    else:
        skeletons = inference.segmentation_to_zipped_swcs(
            seg, args.output, anisotropy=tuple(args.anisotropy)
        )
        _emit({"swc": args.output, "n": len(skeletons)})


def cmd_run(args):
    """Input volume -> digest predict -> streaming segment -> SWC zip.

    The beyond-RAM configuration: the digests and the segmentation live
    in Zarr stores under ``--workdir``, never dense in host RAM.

    ``--distributed``: every stage runs across the ranks of the job
    (same command on every process; ``--workdir`` on a filesystem every
    process sees): the rank-sharded digest predict
    (``parallel.predict_sharded``), the multi-process streaming
    segmentation and the distributed TEASAR, rank 0 writing the zip.
    """
    from aind_exaspim_neuron_segmentation_tpu_torch import (
        inference,
        parallel,
        postprocess,
    )

    _init_distributed(args)
    os.makedirs(args.workdir, exist_ok=True)
    plan_p = os.path.join(args.workdir, "plan.zarr")
    qaff_p = os.path.join(args.workdir, "qaff.zarr")
    seg_p = os.path.join(args.workdir, "segmentation.zarr")

    runner = inference.load_model(
        args.model, affinity_mode=True, device=args.device,
        width_multiplier=args.width_multiplier,
    )
    img = _read(args.input)
    t0 = time.time()
    predict_kw = dict(
        batch_size=args.batch_size,
        brightness_clip=args.brightness_clip,
        patch_shape=args.patch, overlap=args.overlap, trim=args.trim,
        blend_mode=args.blend, predigest=True, out_path=(plan_p, qaff_p),
    )
    if args.distributed:
        plan, qaff = parallel.predict_sharded(
            img, runner, mesh=parallel.make_mesh(), **predict_kw
        )
    else:
        plan, qaff = inference.predict(
            img, runner, verbose=not args.quiet, **predict_kw
        )
    t1 = time.time()
    seg_kw = dict(
        agglomeration_thresholds=tuple(args.thresholds),
        min_segment_size=args.min_size,
        out_path=seg_p,
        verbose=not args.quiet,
    )
    seg_stats, sk_stats = {}, {}
    if args.distributed:
        seg = postprocess.segment_streaming_sharded(
            (plan, qaff), stats_out=seg_stats, **seg_kw
        )
    else:
        seg = inference.affinities_to_segmentation((plan, qaff), **seg_kw)
    t2 = time.time()
    if args.distributed:
        postprocess.skeletonize_sharded(
            seg, anisotropy=tuple(args.anisotropy), zip_path=args.output,
            stats_out=sk_stats,
        )
    else:
        inference.segmentation_to_zipped_swcs(
            seg, args.output, anisotropy=tuple(args.anisotropy)
        )
    t3 = time.time()
    out = {
        "run": args.output,
        "stages_s": {"predict": round(t1 - t0, 1),
                     "segment": round(t2 - t1, 1),
                     "swc": round(t3 - t2, 1)},
        "workdir": args.workdir,
    }
    if args.distributed:
        # per-rank per-pass walls and hub payload bytes of both
        # distributed stages
        out["segment_protocol"] = seg_stats.get("ranks")
        out["swc_protocol"] = sk_stats.get("ranks")
    _emit(out)


def cmd_train(args):
    """Train UNet3D on image/label volume pairs (reference train loop)."""
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
        data_handling,
    )
    from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning.train import (  # noqa: E501
        Trainer,
    )

    if len(args.images) != len(args.labels):
        raise SystemExit("--images and --labels must pair up")
    mesh = None
    output = args.output
    if args.distributed or args.mesh:
        import torch.distributed as dist

        from aind_exaspim_neuron_segmentation_tpu_torch import parallel

        _init_distributed(args)
        joined = dist.is_available() and dist.is_initialized()
        if (args.mesh or 1) > 1 and not joined:
            raise SystemExit(
                f"--mesh {args.mesh} needs {args.mesh} processes, one per "
                "device: run the same command in each with --distributed "
                "(e.g. torchrun --nproc_per_node N)"
            )
        if joined and dist.get_rank():
            # one writer per artifact: the other ranks keep their
            # (identical) checkpoints and events out of rank 0's way
            output = os.path.join(args.output, f".rank{dist.get_rank()}")
        mesh = parallel.make_mesh(args.mesh)  # None -> every rank
        if mesh.coords is None:
            print(f"rank {dist.get_rank()} is not among the first "
                  f"{args.mesh} ranks of --mesh: nothing to train",
                  file=sys.stderr)
            return
    # the Trainer first: without a card it raises before any volume loads
    trainer = Trainer(
        output,
        affinity_mode=not args.foreground,
        batch_size=args.batch_size,
        lr=args.lr,
        max_epochs=args.epochs,
        width_multiplier=args.width_multiplier,
        seed=args.seed,
        mesh=mesh,
        num_workers=args.num_workers,
        device=args.device,
    )
    common = dict(
        affinity_mode=not args.foreground,
        patch_shape=args.patch,
        brightness_clip=args.brightness_clip,
    )
    # Default: raw label patches, so the Trainer augments on the device
    # (and ships raw u16 patches when the volumes qualify);
    # --host-augment runs ImageTransforms on the host instead.
    train_ds = data_handling.TrainDataset(
        list(args.images), list(args.labels),
        transform=args.host_augment,
        return_label_patches=not args.host_augment,
        seed=args.seed, **common,
    )
    val_ds = data_handling.ValidateDataset(
        list(args.val_images or args.images),
        list(args.val_labels or args.labels),
        containment_buffer=args.containment_buffer,
        **common,
    )
    trainer.run(train_ds, val_ds)
    _emit({"train": trainer.log_dir})


def build_parser():
    """Build the top-level argparse parser with its five subcommands."""
    from aind_exaspim_neuron_segmentation_tpu_torch import __version__

    top = argparse.ArgumentParser(
        prog="python -m aind_exaspim_neuron_segmentation_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    top.add_argument("--version", action="version",
                     version=f"%(prog)s {__version__}")
    top.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the model, the digest of float affinities and "
             "training run (default cuda: raises without a card). Goes "
             "BEFORE the subcommand.",
    )
    sub = top.add_subparsers(dest="command", required=True)

    p = sub.add_parser("predict", help="volume -> affinity Zarr store")
    p.add_argument("--input", required=True)
    p.add_argument("--output", help="output .zarr path (float affinities)")
    p.add_argument(
        "--predigest-out", nargs=2, metavar=("PLAN", "QAFF"),
        help="stream on-device digests to these two .zarr paths instead "
             "of float affinities (4 bytes/voxel instead of 12)",
    )
    _add_predict_args(p)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="shard the sliding window over every rank of the job "
                        "(same command on every process; each writes its own "
                        "Z rows into the shared --output store; job from "
                        "MASTER_ADDR/WORLD_SIZE/RANK or "
                        "JAX_COORDINATOR_ADDRESS etc.)")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("segment",
                       help="affinities (or digests) -> label Zarr store")
    p.add_argument("--affinities", help="float (3,D,H,W) zarr/N5 store")
    p.add_argument("--plan", help="digest plan store (with --qaff)")
    p.add_argument("--qaff", help="digest qaff store (with --plan)")
    p.add_argument("--output", required=True, help="output .zarr path")
    p.add_argument("--thresholds", type=float, nargs="+",
                   default=(0.6, 0.8, 0.9))
    p.add_argument("--min-size", type=int, default=100)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="run the streaming engine across the processes of the "
                        "job (same command on every process)")
    p.set_defaults(fn=cmd_segment)

    p = sub.add_parser("swc", help="segmentation -> zipped SWC skeletons")
    p.add_argument("--segmentation", required=True)
    p.add_argument("--output", required=True, help="output .zip path")
    p.add_argument("--anisotropy", type=float, nargs=3, default=(1, 1, 1))
    p.add_argument("--distributed", action="store_true",
                   help="Z-partitioned bbox scan + label-partitioned TEASAR "
                        "across the processes of the job (rank 0 writes the "
                        "zip)")
    p.set_defaults(fn=cmd_swc)

    p = sub.add_parser(
        "run", help="volume -> segmentation -> SWC zip (beyond-RAM path)"
    )
    p.add_argument("--input", required=True)
    p.add_argument("--workdir", required=True,
                   help="directory for the intermediate Zarr stores")
    p.add_argument("--output", required=True, help="output SWC .zip path")
    _add_predict_args(p)
    p.add_argument("--thresholds", type=float, nargs="+",
                   default=(0.6, 0.8, 0.9))
    p.add_argument("--min-size", type=int, default=100)
    p.add_argument("--anisotropy", type=float, nargs=3, default=(1, 1, 1))
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--distributed", action="store_true",
                   help="run every stage across the processes of the job "
                        "(rank-sharded predict, multi-process segment + "
                        "TEASAR; --workdir on a shared filesystem; rank 0 "
                        "writes the zip)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("train", help="train UNet3D on volume/label pairs")
    p.add_argument("--output", required=True, help="runs directory")
    p.add_argument("--images", nargs="+", required=True)
    p.add_argument("--labels", nargs="+", required=True)
    p.add_argument("--val-images", nargs="+")
    p.add_argument("--val-labels", nargs="+")
    p.add_argument("--foreground", action="store_true")
    p.add_argument("--patch", type=_triple, default=(96, 96, 96),
                   metavar="D,H,W")
    p.add_argument("--brightness-clip", type=float, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--width-multiplier", type=float, default=1)
    p.add_argument("--containment-buffer", type=int, default=64,
                   help="validation-grid center containment margin "
                        "(reference default 64; use 0 for small volumes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--host-augment", action="store_true",
                   help="augment on the host (ImageTransforms) instead "
                        "of the default augmentation on the device")
    p.add_argument("--num-workers", type=int, default=0, metavar="N",
                   help="fork N sampler processes (0 = one producer "
                        "thread)")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="data-parallel Trainer(mesh=) over the first N "
                        "ranks of the job (default with --distributed: "
                        "every rank); one process per device")
    p.add_argument("--distributed", action="store_true",
                   help="join the job first (same command on every "
                        "process; batches shard over the ranks, gradients "
                        "and BatchNorm statistics are summed across them; "
                        "rank 0 owns --output)")
    p.set_defaults(fn=cmd_train)
    return top


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the subcommand."""
    args = build_parser().parse_args(argv)
    if args.command == "predict":
        if not (args.output or args.predigest_out):
            raise SystemExit("predict needs --output or --predigest-out")
        if args.output and args.predigest_out:
            raise SystemExit(
                "predict takes --output OR --predigest-out, not both"
            )
    if args.command == "segment":
        if (args.plan is None) != (args.qaff is None):
            raise SystemExit("--plan and --qaff must be given together")
        if args.affinities and args.plan:
            raise SystemExit(
                "segment takes --affinities OR --plan/--qaff, not both"
            )
        if not (args.affinities or args.plan):
            raise SystemExit(
                "segment needs --affinities or --plan + --qaff"
            )
    if args.command == "run" and args.foreground:
        raise SystemExit(
            "run is the affinity->segmentation pipeline; foreground "
            "output cannot feed segmentation (use `predict --foreground`)"
        )
    if args.command == "train":
        if (args.val_images is None) != (args.val_labels is None):
            raise SystemExit(
                "--val-images and --val-labels must be given together"
            )
        if args.val_images and len(args.val_images) != len(args.val_labels):
            raise SystemExit("--val-images and --val-labels must pair up")
    args.fn(args)


if __name__ == "__main__":
    main()
