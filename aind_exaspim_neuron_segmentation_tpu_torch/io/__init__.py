"""Volumetric IO: read() dispatch over zarr / N5 / TIFF, local + cloud.

The port's own copy of the JAX package's ``io``: the same formats,
codecs and chunk bytes, over the port's C++ engine (:mod:`..native`).

Mirrors the reference dispatch surface (reference img_util.py:25-50):
``.zarr`` / ``.n5`` return lazy chunked handles, ``.tif``/``.tiff``
return eager ndarrays; ``gs://`` and ``s3://`` URIs route through
fsspec stores.
"""

from aind_exaspim_neuron_segmentation_tpu_torch.io.zarr_lite import (  # noqa: F401
    open_n5,
    open_zarr,
    write_n5,
    write_zarr,
    write_zarr3,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io.tiff_lite import (  # noqa: F401
    read_tiff,
    write_tiff,
)
from aind_exaspim_neuron_segmentation_tpu_torch.io.stores import (  # noqa: F401
    open_store,
)


def read(path):
    """Open a volume by extension (reference img_util.py:25-50 parity).

    Returns a lazy handle for ``.zarr``/``.n5`` and an eager ndarray for
    ``.tif``/``.tiff``.
    """
    # Substring dispatch like the reference (img_util.py:40-50), so
    # dataset sub-paths inside containers work: "fused.zarr/0",
    # "vol.n5/c0/s0".
    lower = path.lower().rstrip("/")
    if ".zarr" in lower:
        return open_zarr(path)
    if ".n5" in lower:
        return open_n5(path)
    if lower.endswith((".tif", ".tiff")):
        if path.startswith(("gs://", "s3://")):
            store_path, _, name = path.rpartition("/")
            data = open_store(store_path).get(name)
            if data is None:
                raise FileNotFoundError(path)
            return read_tiff(data)
        return read_tiff(path)
    raise ValueError(
        f"unsupported extension in {path!r}: expected .zarr, .n5, .tif(f)"
    )
