"""Key-value stores backing the volume formats.

zarr/N5 directories map keys ("0.0.0", ".zarray", "attributes.json") to
byte blobs. Local filesystem is always available; gs:// uses gcsfs and
s3:// uses s3fs when installed (an ``ImportError`` naming the package
otherwise); cloud paths are dispatched as the reference's are (reference
img_util.py:53-121).
"""

import os


class LocalStore:
    """Directory-backed store."""

    def __init__(self, root):
        self.root = root

    def get(self, key):
        """Return the bytes at ``key`` or None when absent."""
        path = os.path.join(self.root, key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def put(self, key, data):
        """Write ``data`` at ``key``, creating parent directories."""
        path = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)

    def exists(self, key):
        """True when ``key`` is present in the store."""
        return os.path.exists(os.path.join(self.root, key))


class FsspecStore:
    """Store over an fsspec filesystem (gcsfs / s3fs).

    Remote reads retry transient errors with exponential backoff (the
    reference has none; SURVEY.md section 5).
    """

    def __init__(self, fs, root):
        self.fs = fs
        self.root = root.rstrip("/")

    def _read(self, path):
        with self.fs.open(path, "rb") as f:
            return f.read()

    def get(self, key):
        """Return the bytes at ``key`` or None when absent (with retry)."""
        from aind_exaspim_neuron_segmentation_tpu_torch.utils.retry import retry

        path = f"{self.root}/{key}"
        try:
            return retry(self._read, path)
        except FileNotFoundError:
            return None

    def _write(self, path, data):
        with self.fs.open(path, "wb") as f:
            f.write(data)

    def put(self, key, data):
        """Write ``data`` at ``key`` on the remote filesystem (with retry)."""
        from aind_exaspim_neuron_segmentation_tpu_torch.utils.retry import retry

        retry(self._write, f"{self.root}/{key}", data)

    def exists(self, key):
        """True when ``key`` is present on the remote filesystem."""
        return self.fs.exists(f"{self.root}/{key}")


def open_store(path):
    """Dispatch a path/URI to a store (gs://, s3://, local)."""
    if path.startswith("gs://"):
        try:
            import gcsfs
        except ImportError as err:
            raise ImportError(
                "gs:// paths require gcsfs (pip install gcsfs)"
            ) from err
        return FsspecStore(gcsfs.GCSFileSystem(), path[len("gs://"):])
    if path.startswith("s3://"):
        try:
            import s3fs
        except ImportError as err:
            raise ImportError(
                "s3:// paths require s3fs (pip install s3fs)"
            ) from err
        # max_pool_connections mirrors reference img_util.py:71
        fs = s3fs.S3FileSystem(
            config_kwargs={"max_pool_connections": 50}
        )
        return FsspecStore(fs, path[len("s3://"):])
    return LocalStore(path)
