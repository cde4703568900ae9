"""Code/kernel caching helpers (reference ``africanus/util/code.py``).

A copy of ``africanus_tpu/utils/code.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from threading import Lock

__all__ = ["format_code", "memoize_on_key", "SingletonMixin"]


class SingletonMixin:
    __singleton_lock = Lock()
    __singleton_instance = None

    @classmethod
    def instance(cls):
        if not cls.__singleton_instance:
            with cls.__singleton_lock:
                if not cls.__singleton_instance:
                    cls.__singleton_instance = cls()
        return cls.__singleton_instance


def format_code(code):
    """Number the lines of a code string (used when dumping generated
    kernels on compile errors, reference code.py:26)."""
    lines = code.split("\n")
    width = len(str(len(lines)))
    return "\n".join(f"{i:{width}d} {l}" for i, l in enumerate(lines, 1))


class memoize_on_key:
    """Decorator memoising a function on a key derived from its arguments
    (reference code.py:45) — used to cache specialised kernels per
    dtype/shape signature. The cache is per-decorated-function and
    thread-safe."""

    def __init__(self, key_fn):
        self._key_fn = key_fn
        self._lock = Lock()
        self._cache = {}

    def __call__(self, fn):
        from functools import wraps

        @wraps(fn)
        def wrapper(*args, **kwargs):
            key = self._key_fn(*args, **kwargs)
            with self._lock:
                try:
                    return self._cache[key]
                except KeyError:
                    value = fn(*args, **kwargs)
                    self._cache[key] = value
                    return value

        return wrapper
