"""End-to-end example: volume -> affinities -> segmentation -> SWC zip.

Runs on synthetic data; swap in ``img_util.read("gs://.../brain.zarr")``
and a trained ``.pth`` for real use. Mirrors the reference README
workflows.

Usage::

    python -m aind_exaspim_neuron_segmentation_tpu_torch.examples.run_pipeline \
        [output_dir] [--device cpu] [--size 128] [--width 1] [--patch 96]

Writes ``neurons.zip`` and, where matplotlib is installed, two MIP PNGs;
prints the stage times and one JSON line (segments, K1 launches, stages).
"""

import importlib.util
import json
import os
import sys

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.examples import (
    parser,
    predict_kw,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter
from aind_exaspim_neuron_segmentation_tpu_torch.utils import img_util
from aind_exaspim_neuron_segmentation_tpu_torch.utils.profiling import (
    StageTimer,
)


def synthetic_brain(shape=(128, 128, 128), seed=0):
    """(image, labels): two bright boxes on a dim background. At the
    default 128^3 the boxes are ``[16:112, 20:52, 16:112]`` and ``[16:112,
    76:108, 16:112]``; other shapes scale them per axis."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.uint32)

    def box(*bounds):
        return tuple(slice(lo * d // 128, hi * d // 128)
                     for (lo, hi), d in zip(bounds, shape))

    lab[box((16, 112), (20, 52), (16, 112))] = 1
    lab[box((16, 112), (76, 108), (16, 112))] = 2
    img = rng.uniform(0, 120, shape).astype(np.float32)
    img[lab > 0] += rng.uniform(600, 1400, int((lab > 0).sum()))
    return img, lab


def main(out_dir="./pipeline_out", device=None, shape=(128, 128, 128),
         width_multiplier=1, **kw):
    """Run the pipeline; ``kw`` are ``predict``'s grid keywords. Returns
    the result line's fields."""
    os.makedirs(out_dir, exist_ok=True)
    timer = StageTimer()

    img, lab = synthetic_brain(shape)

    with timer.stage("load_model"):
        # No checkpoint: random weights demonstrate the flow; pass a
        # trained UNet3d-*.pth path for real affinities.
        model = inference.load_model(affinity_mode=True, device=device,
                                     width_multiplier=width_multiplier)

    scatter.scatter_batch.launches = 0
    with timer.stage("predict"):
        affinities = inference.predict(img, model, verbose=True, **kw)
    launches = scatter.scatter_batch.launches

    # With random weights the net's affinities are meaningless; use the
    # ground-truth-derived affinities downstream so the demo output is
    # interpretable. With a trained checkpoint, feed `affinities`.
    oracle = img_util.get_affinity_channels(lab).astype(np.float32)

    with timer.stage("segment"):
        seg = inference.affinities_to_segmentation(oracle)

    with timer.stage("skeletonize+zip"):
        zip_path = os.path.join(out_dir, "neurons.zip")
        inference.segmentation_to_zipped_swcs(seg, zip_path)

    plots = importlib.util.find_spec("matplotlib") is not None
    if plots:
        with timer.stage("visualize"):
            img_util.plot_mips(
                affinities[0], os.path.join(out_dir, "affinity_mips.png")
            )
            img_util.plot_segmentation_mips(
                seg, os.path.join(out_dir, "segmentation_mips.png")
            )

    print(timer.summary())
    print(f"\noutputs in {out_dir}: neurons.zip"
          + (" + MIP PNGs" if plots else " (matplotlib not installed: no "
             "MIP PNGs)"))
    result = dict(zip=zip_path, n_segments=int(seg.max()),
                  k1_launches=launches, stages_s=timer.as_dict())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = parser(__doc__.splitlines()[0], "./pipeline_out")
    ap.add_argument("--size", type=int, default=128,
                    help="edge of the synthetic cube")
    args = ap.parse_args(sys.argv[1:])
    main(args.out_dir, args.device, (args.size,) * 3, args.width,
         **predict_kw(args))
