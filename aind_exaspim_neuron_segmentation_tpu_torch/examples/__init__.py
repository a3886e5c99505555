"""Runnable examples of the port's workflows, on synthetic data.

Each runs as ``python -m
aind_exaspim_neuron_segmentation_tpu_torch.examples.<name> [dir]
[--device cpu]``; on a card, leave ``--device`` out:

* :mod:`.run_pipeline` -- volume -> affinities -> segmentation -> SWC zip
  in host RAM, with per-stage times;
* :mod:`.run_beyond_ram` -- zarr image -> zarr affinities -> zarr labels
  -> SWC zip, no volume dense in host RAM;
* :mod:`.run_multichip` -- ``predict_sharded`` over a 1-D and a 2-D rank
  mesh (8 local gloo ranks unless a launcher started the job).

``--width``, ``--patch``, ``--overlap`` and ``--trim`` shrink the model
and its patch grid for a quick run on the CPU. Each example ends with one
JSON line of its results.
"""

import argparse


def parser(description, out_dir, width=1.0, patch=96, overlap=32, trim=8):
    """The examples' shared command line (an ``ArgumentParser``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("out_dir", nargs="?", default=out_dir)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the host)")
    ap.add_argument("--width", type=float, default=width,
                    help="the model's width multiplier")
    ap.add_argument("--patch", type=int, default=patch)
    ap.add_argument("--overlap", type=int, default=overlap)
    ap.add_argument("--trim", type=int, default=trim)
    return ap


def predict_kw(args):
    """``predict``'s grid keywords from :func:`parser`'s parsed args."""
    return dict(patch_shape=(args.patch,) * 3, overlap=(args.overlap,) * 3,
                trim=args.trim)
