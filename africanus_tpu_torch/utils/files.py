"""File/cache-dir helpers (reference ``africanus/util/files.py`` +
``util/appdirs.py``).

The reference keys per-user cache/data directories off the ``appdirs``
package (used there to cache downloaded CUDA header libraries); here the
same layout is derived from XDG conventions with no extra dependency —
the framework has no downloads, but the dirs remain available for
user-side caching (e.g. compiled native cores, beam cubes).

A copy of ``africanus_tpu/utils/files.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from hashlib import sha1
from os.path import join as pjoin

__all__ = ["sha_hash_file", "user_data_dir", "downloads_dir", "include_dir"]

_xdg = os.environ.get("XDG_DATA_HOME", pjoin(os.path.expanduser("~"),
                                             ".local", "share"))
user_data_dir = pjoin(_xdg, "africanus-tpu-torch")
downloads_dir = pjoin(user_data_dir, "downloads")
include_dir = pjoin(user_data_dir, "include")


def sha_hash_file(filename, chunk_size=1024 * 1024):
    """SHA1 hex digest of a file, streamed in ``chunk_size`` blocks."""
    hash_sha = sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            hash_sha.update(chunk)
    return hash_sha.hexdigest()
