"""Image utilities: the README's one-stop surface over the subsystems.

``img_util.read("brain.zarr")`` opens a lazy chunked handle (zarr / N5)
or reads a TIFF, as :func:`..io.read`; ``normalize`` and
``remove_small_segments`` are re-exported from :mod:`..core.normalize`
and :mod:`..postprocess`.
"""

from aind_exaspim_neuron_segmentation_tpu_torch.core.normalize import (  # noqa: F401
    normalize,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io import read  # noqa: F401
from aind_exaspim_neuron_segmentation_tpu_torch.postprocess import (  # noqa: F401
    remove_small_segments,
)
