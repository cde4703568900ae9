"""Resource patterns: freeze, Multiton, LazyProxy.

Equivalents of reference ``africanus/util/patterns.py`` (freeze:13,
Multiton:29, LazyProxy:126, LazyProxyMultiton:391). LazyProxy lets
heavy-weight resources (file handles, pools) be embedded as lightweight
picklable references and instantiated on first attribute access — useful
for shipping beam-file handles into sharded/host-callback pipelines.

A copy of ``africanus_tpu/utils/patterns.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import inspect
import weakref
from collections import OrderedDict
from threading import Lock
from warnings import warn

import numpy as np

__all__ = ["freeze", "Multiton", "LazyProxy", "LazyProxyMultiton"]


def freeze(value):
    """Recursively convert ``value`` into a hashable cache key.

    ndarrays are keyed by (shape, dtype, contents); mappings become
    frozensets of frozen (key, value) pairs; sets are sorted then tupled;
    sequences become tuples. Anything else is assumed hashable as-is.
    """
    if isinstance(value, np.ndarray):
        if value.nbytes > 10:
            warn(
                f"an ndarray of {value.nbytes} bytes is being hashed into "
                f"a cache key — this scales poorly; key on a scalar "
                f"summary or a LazyProxy instead"
            )
        return (
            "ndarray",
            value.shape,
            str(value.dtype),
            tuple(value.ravel().tolist()),
        )
    if isinstance(value, (dict, OrderedDict)):
        return frozenset((freeze(k), freeze(v)) for k, v in value.items())
    if isinstance(value, set):
        return tuple(freeze(v) for v in sorted(value))
    if isinstance(value, (list, tuple)):
        return tuple(freeze(v) for v in value)
    return value


class Multiton(type):
    """Metaclass: one live instance per distinct constructor-argument key.

    The key is ``(freeze(args), freeze(kwargs))``. Instances are held
    weakly, so a cached instance disappears once the last user reference
    drops; creation is serialised by a per-class lock.
    """

    def __init__(cls, name, bases, namespace, **kwargs):
        super().__init__(name, bases, namespace, **kwargs)
        cls._instances = weakref.WeakValueDictionary()
        cls._instances_lock = Lock()

    def __call__(cls, *args, **kwargs):
        # A required positional argument passed by keyword lands in the
        # kwargs half of the key: the same logical call then maps to two
        # different keys and silently forks the cache — flag it.
        required = [
            p.name
            for p in inspect.signature(cls.__init__).parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD and p.default is p.empty
        ]
        misplaced = sorted(set(required) & set(kwargs))
        if misplaced:
            warn(
                f"{cls.__name__}: required positional argument(s) "
                f"{misplaced} passed by keyword — equivalent calls may "
                f"produce distinct cached instances"
            )

        key = (freeze(args), freeze(kwargs))
        inst = cls._instances.get(key)
        if inst is not None:
            return inst
        with cls._instances_lock:
            inst = cls._instances.get(key)
            if inst is None:
                inst = super().__call__(*args, **kwargs)
                cls._instances[key] = inst
            return inst


class LazyProxy:
    """Proxy that instantiates its target on first attribute access.

    ``LazyProxy(open, "f.txt", mode="r")`` behaves like the opened file but
    pickles as just (factory, args); ``LazyProxy((open, finaliser), ...)``
    additionally registers a weakref finaliser for cleanup.
    """

    __lazy_members__ = frozenset(
        (
            "__lazy_fn__",
            "__lazy_finaliser__",
            "__lazy_args__",
            "__lazy_kwargs__",
            "__lazy_object__",
            "__lazy_lock__",
        )
    )

    def __init__(self, fn, *args, **kwargs):
        ex = ValueError(
            "fn must be a callable or a tuple of two callables: "
            "(factory, finaliser)"
        )
        if isinstance(fn, tuple):
            if len(fn) != 2 or not all(callable(f) for f in fn):
                raise ex
            factory, finaliser = fn
        elif callable(fn):
            factory, finaliser = fn, None
        else:
            raise ex

        object.__setattr__(self, "__lazy_fn__", factory)
        object.__setattr__(self, "__lazy_finaliser__", finaliser)
        object.__setattr__(self, "__lazy_args__", args)
        object.__setattr__(self, "__lazy_kwargs__", kwargs)
        object.__setattr__(self, "__lazy_lock__", Lock())

    def __lazy_resolve__(self):
        try:
            return object.__getattribute__(self, "__lazy_object__")
        except AttributeError:
            pass
        with object.__getattribute__(self, "__lazy_lock__"):
            try:
                return object.__getattribute__(self, "__lazy_object__")
            except AttributeError:
                factory = object.__getattribute__(self, "__lazy_fn__")
                args = object.__getattribute__(self, "__lazy_args__")
                kwargs = object.__getattribute__(self, "__lazy_kwargs__")
                obj = factory(*args, **kwargs)
                object.__setattr__(self, "__lazy_object__", obj)
                finaliser = object.__getattribute__(self, "__lazy_finaliser__")
                if finaliser is not None:
                    weakref.finalize(self, finaliser, obj)
                return obj

    def __getattr__(self, name):
        if name in LazyProxy.__lazy_members__ or name == "__lazy_resolve__":
            return object.__getattribute__(self, name)
        return getattr(self.__lazy_resolve__(), name)

    def __setattr__(self, name, value):
        if name in LazyProxy.__lazy_members__:
            object.__setattr__(self, name, value)
        else:
            setattr(self.__lazy_resolve__(), name, value)

    def __call__(self, *args, **kwargs):
        return self.__lazy_resolve__()(*args, **kwargs)

    def __reduce__(self):
        finaliser = object.__getattribute__(self, "__lazy_finaliser__")
        factory = object.__getattribute__(self, "__lazy_fn__")
        fn = (factory, finaliser) if finaliser is not None else factory
        args = object.__getattribute__(self, "__lazy_args__")
        kwargs = object.__getattribute__(self, "__lazy_kwargs__")
        return (_rebuild_lazy_proxy, (type(self), fn, args, kwargs))


def _rebuild_lazy_proxy(cls, fn, args, kwargs):
    return cls(fn, *args, **kwargs)


class LazyProxyMultiton(LazyProxy, metaclass=Multiton):
    """LazyProxy whose unique (factory, args) yields a unique instance."""
