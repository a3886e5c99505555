"""Filesystem helpers (``mkdir`` / ``rmdir``).

The reference's google-cloud-storage listing helpers are not part of the
port yet.
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
