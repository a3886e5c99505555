"""Image utilities: the README's one-stop surface over the subsystems.

``img_util.read("brain.zarr")`` opens a lazy chunked handle (zarr / N5)
or reads a TIFF, as :func:`..io.read`. The patch, normalize, affinity
and small-segment helpers are re-exported from :mod:`..core` and
:mod:`..postprocess`; the maximum-intensity-projection plots
(matplotlib, imported when called) and the AIND block listing on GCS are
defined here.
"""

import numpy as np

from aind_exaspim_neuron_segmentation_tpu_torch.core.affinities import (  # noqa: F401
    get_affinity_channels,
    get_affinity_mask,
    get_offset_masks,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (  # noqa: F401
    normalize,
)
from aind_exaspim_neuron_segmentation_tpu_torch.core.patches import (  # noqa: F401
    add_padding,
    get_patch,
    get_patch_slices,
    get_slices,
    is_contained,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read  # noqa: F401
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess import (  # noqa: F401
    remove_small_segments,
)
from aind_exaspim_neuron_segmentation_tpu_torch.utils import util

AIND_BUCKET = "allen-nd-goog"


def make_segmentation_colormap(mask, seed=42):
    """ListedColormap: black background and a reproducible random color
    per label of ``mask``."""
    from matplotlib.colors import ListedColormap

    n_labels = int(mask.max()) + 1
    rng = np.random.default_rng(seed)
    colors = [(0, 0, 0)]
    colors += list(rng.uniform(0.2, 1.0, size=(max(n_labels - 1, 0), 3)))
    return ListedColormap(colors)


def _mips(img, axs, render):
    import matplotlib.pyplot as plt

    vol = img[0, 0] if img.ndim == 5 else img
    for i, name in enumerate(("XY", "XZ", "YZ")):
        render(axs[i], np.max(vol, axis=i))
        axs[i].set_title(name, fontsize=16)
        axs[i].set_xticks([])
        axs[i].set_yticks([])
    plt.tight_layout()


def _plot(img, render, output_path, show):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 3, figsize=(10, 4))
    _mips(img, axs, render)
    if output_path:
        plt.savefig(output_path, dpi=200)
    if show:
        plt.show()
    plt.close(fig)


def plot_mips(img, output_path=None, vmax=None, show=False):
    """Maximum-intensity projections along the three axes (``vmax``
    defaults to the 99.9th percentile)."""
    vmax = vmax or np.percentile(img, 99.9)
    _plot(img, lambda ax, mip: ax.imshow(mip, vmax=vmax), output_path, show)


def plot_segmentation_mips(segmentation, output_path=None, show=False):
    """Label-colored maximum-intensity projections of a segmentation."""
    cmap = make_segmentation_colormap(segmentation)
    _plot(segmentation,
          lambda ax, mip: ax.imshow(mip, cmap=cmap, interpolation="none"),
          output_path, show)


def list_block_paths(prefix, bucket=AIND_BUCKET, client=None):
    """(image paths, label paths) of the AIND blocks under ``prefix`` on
    GCS: each block directory's ``input.*`` and ``Fill_Label_Mask.*``."""
    img_paths, label_paths = [], []
    for block in util.list_gcs_subprefixes(bucket, prefix, client=client):
        img = util.find_subprefix_with_keyword(
            bucket, block, "input.", client=client
        )
        lab = util.find_subprefix_with_keyword(
            bucket, block, "Fill_Label_Mask.", client=client
        )
        img_paths.append(f"gs://{bucket}/{img}")
        label_paths.append(f"gs://{bucket}/{lab}")
    return img_paths, label_paths
