"""Filesystem helpers (``mkdir`` / ``rmdir``) and GCS listing.

The GCS helpers take a ``client`` (a ``google.cloud.storage.Client`` or
anything with its ``list_blobs``); without one they make one, which
needs ``google-cloud-storage``, credentials and the network.
"""

import os
import shutil


def mkdir(path, delete=False):
    """Create a directory, optionally deleting an existing one first.

    Unlike the reference's bare ``os.mkdir`` this creates intermediate
    directories too.
    """
    if delete:
        rmdir(path)
    os.makedirs(path, exist_ok=True)


def rmdir(path):
    """Remove a directory tree if it exists."""
    if os.path.exists(path):
        shutil.rmtree(path)


def _storage_client():
    try:
        from google.cloud import storage
    except ImportError as err:
        raise ImportError("GCS helpers require google-cloud-storage") from err
    return storage.Client()


def list_gcs_paths(bucket_name, prefix, client=None):
    """Names of the blobs under ``prefix`` that are not directories."""
    client = client or _storage_client()
    return [
        blob.name
        for blob in client.list_blobs(bucket_name, prefix=prefix)
        if not blob.name.endswith("/")
    ]


def list_gcs_subprefixes(bucket_name, prefix, client=None):
    """Direct subdirectories of ``prefix`` (normalized to end with '/',
    so its children are listed rather than the prefix itself)."""
    client = client or _storage_client()
    if prefix and not prefix.endswith("/"):
        prefix = prefix + "/"
    blobs = client.list_blobs(bucket_name, prefix=prefix, delimiter="/")
    list(blobs)  # iterating fills .prefixes
    depth = len(prefix.split("/"))
    return [
        p
        for p in blobs.prefixes
        if p.endswith("/") and len(p.split("/")) - 1 == depth
    ]


def find_subprefix_with_keyword(bucket_name, prefix, keyword, client=None):
    """First subdirectory, then blob, under ``prefix`` whose name holds
    ``keyword``; ``LookupError`` if none does."""
    client = client or _storage_client()
    for sub in list_gcs_subprefixes(bucket_name, prefix, client=client):
        if keyword in sub:
            return sub
    for path in list_gcs_paths(bucket_name, prefix, client=client):
        if keyword in path:
            return path
    raise LookupError(
        f"prefix with keyword {keyword!r} not found in {prefix}"
    )
