"""Host-side plan caching: content keys + a tiny LRU.

A copy of ``africanus_tpu/utils/plancache.py`` (numpy only; the port
may not import the JAX package). Planning steps — here the w-gridder's
per-sample geometry — are host computations over concrete metadata
arrays that repeat identically across imaging major cycles, so each
planning site keeps a small LRU keyed by a content hash of its inputs.

Cached values are shared objects: callers must treat them as
**read-only**.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["content_key", "LRUCache"]


def content_key(arrays, params=None):
    """16-byte blake2b digest of array contents + a params repr.

    ``arrays`` may contain None (hashed as a sentinel). Hashing costs
    ~ms for few-MB metadata vs the ~100 ms plan builds it guards.
    """
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        if a is None:
            h.update(b"\x00none")
        else:
            a = np.ascontiguousarray(a)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.view(np.uint8).data)
    if params is not None:
        h.update(repr(params).encode())
    return h.digest()


class LRUCache:
    """Minimal insertion-order LRU (dict-backed, host-side, not
    thread-safe — planning happens on the driver thread)."""

    def __init__(self, maxsize):
        self.maxsize = int(maxsize)
        self._d: dict = {}

    def get(self, key, default=None):
        """Return the cached value (refreshing its LRU position)."""
        hit = self._d.pop(key, _MISSING)
        if hit is _MISSING:
            return default
        self._d[key] = hit
        return hit

    def put(self, key, value):
        self._d.pop(key, None)
        self._d[key] = value
        while len(self._d) > self.maxsize:
            self._d.pop(next(iter(self._d)))
        return value

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


_MISSING = object()
