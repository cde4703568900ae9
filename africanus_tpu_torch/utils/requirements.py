"""Optional-dependency gating (reference ``africanus/util/requirements.py:31``).

``requires_optional("pkg", import_error)`` turns missing optional imports
into call-time errors, letting one install serve every feature subset.

A copy of ``africanus_tpu/utils/requirements.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import importlib
from functools import wraps

__all__ = ["requires_optional", "MissingPackageException"]


class MissingPackageException(Exception):
    """Raised when a function decorated with
    :func:`requires_optional` is CALLED while any of its optional
    dependencies is missing (import-time stays silent so one install
    serves all feature subsets — reference ``util/requirements.py``).
    """

    def __init__(self, fn_name, packages):
        super().__init__(
            f"{fn_name} requires installation of the following packages: "
            f"{packages}."
        )


def requires_optional(*requirements):
    """Decorator: raise MissingPackageException (or re-raise a captured
    ImportError) when the wrapped function is called with any of the named
    packages unavailable. ImportError instances among the requirements are
    re-raised at call time with their original traceback context."""
    have_errors = [e for e in requirements if isinstance(e, ImportError)]
    names = [r for r in requirements if isinstance(r, str)]

    missing = []
    for name in names:
        try:
            importlib.import_module(name.split(".")[0])
        except ImportError:
            missing.append(name)

    def decorator(fn):
        if not missing and not have_errors:
            return fn

        @wraps(fn)
        def wrapper(*args, **kwargs):
            for e in have_errors:
                raise e
            raise MissingPackageException(fn.__name__, missing)

        return wrapper

    return decorator
