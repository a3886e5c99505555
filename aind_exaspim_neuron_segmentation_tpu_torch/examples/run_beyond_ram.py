"""Beyond-RAM pipeline example: zarr image -> zarr affinities ->
zarr segmentation -> SWC zip, with NO volume ever dense in host memory.

Every stage streams Z slabs:

1. ``inference.predict(lazy_image, out_path=...)`` reads the image
   slab by slab (exact streaming percentile normalization) and appends
   blended affinities into a Zarr store;
2. ``inference.affinities_to_segmentation(lazy_affinities,
   out_path=...)`` runs the slab-streaming engine: the on-device digest,
   per-slab watershed with cross-slab stitching, the streamed RAG build,
   the merge loop, and a final relabel straight into a Zarr label store
   -- peak host RAM is O(RAG + slab);
3. ``inference.segmentation_to_zipped_swcs(lazy_labels, ...)``
   TEASAR-skeletonizes each label from its bounding-box crop.

Each streaming stage gives its dense counterpart's result. A pipeline
that densified at every joint would be capped at host RAM; this one's
cap is disk. Runs on synthetic data.

Usage::

    python -m aind_exaspim_neuron_segmentation_tpu_torch.examples.run_beyond_ram \
        [work_dir] [--device cpu] [--width 1] [--patch 96]
"""

import json
import os
import sys
import tempfile
import zipfile

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.examples import (
    parser,
    predict_kw,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read
from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import (
    ZarrAppendWriter,
)
from aind_exaspim_neuron_segmentation_tpu_torch.ops import scatter

DIM = (192, 128, 128)


def synthetic_image(path, dim=DIM, seed=0):
    """A slab-streamed uint16 image store (stand-in for an ExaSPIM
    acquisition; never dense): noise and a few bright blobs per 32-plane
    slab."""
    rng = np.random.default_rng(seed)
    writer = ZarrAppendWriter(path, dim, np.uint16)
    for _ in range(0, dim[0], 32):
        slab = rng.integers(0, 300, (32,) + dim[1:]).astype(np.uint16)
        for _ in range(4):  # a few bright blobs per slab
            cz, cy, cx = rng.integers(8, 24), *rng.integers(20, 108, 2)
            slab[cz - 6: cz + 7, cy - 6: cy + 7, cx - 6: cx + 7] = 1200
        writer.append(slab)
    writer.close()


def main(work=None, device=None, width_multiplier=1, **kw):
    """Run the three streaming stages in ``work`` (default a new temporary
    directory); ``kw`` are ``predict``'s grid keywords. Returns the result
    line's fields."""
    work = work or tempfile.mkdtemp()
    os.makedirs(work, exist_ok=True)

    img_path = os.path.join(work, "image.zarr")
    synthetic_image(img_path)
    print(f"image store: {img_path} {DIM}")

    # --- stage 1: streaming inference -----------------------------------
    runner = inference.load_model(affinity_mode=True, device=device,
                                  width_multiplier=width_multiplier)
    aff_path = os.path.join(work, "affinities.zarr")
    scatter.scatter_batch.launches = 0
    inference.predict(read(img_path), runner, out_path=aff_path,
                      verbose=False, **kw)
    launches = scatter.scatter_batch.launches
    print(f"affinities streamed to {aff_path}")

    # --- stage 2: streaming segmentation --------------------------------
    seg_path = os.path.join(work, "segmentation.zarr")
    labels = inference.affinities_to_segmentation(
        read(aff_path), out_path=seg_path, tmp_dir=work, device=device,
    )
    print(f"segmentation streamed to {seg_path} (shape {labels.shape})")

    # --- stage 3: streaming skeletonization -----------------------------
    zip_path = os.path.join(work, "swcs.zip")
    inference.segmentation_to_zipped_swcs(labels, zip_path)
    n = len(zipfile.ZipFile(zip_path).namelist())
    print(f"{n} skeletons -> {zip_path}")
    result = dict(image=img_path, affinities=aff_path, segmentation=seg_path,
                  zip=zip_path, n_skeletons=n, k1_launches=launches)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0], None).parse_args(sys.argv[1:])
    main(args.out_dir, args.device, args.width, **predict_kw(args))
