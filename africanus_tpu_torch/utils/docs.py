"""Docstring templating shared across API variants.

Equivalent of reference ``africanus/util/docs.py``: one docstring serves
the plain and sharded variants of a function, with
``$(array_type)``-style substitutions.

A copy of ``africanus_tpu/utils/docs.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from string import Template

__all__ = ["DocstringTemplate", "doc_tuple_to_str", "mod_docs", "DefaultOut"]


class DocstringTemplate(Template):
    """``string.Template`` variant whose placeholders are written
    ``$(name)`` — the reference's docstring-substitution convention
    (``util/docs.py``), used to share one docstring across array-type
    variants by substituting e.g. ``$(array_type)``."""

    pattern = r"""
    \$(?:
      (?P<escaped>\$) |
      \((?P<named>[_a-z][_a-z0-9]*)\) |
      \((?P<braced>[_a-z][_a-z0-9]*)\) |
      (?P<invalid>)
    )
    """


class DefaultOut:
    """Repr helper for default output argument docs."""

    def __init__(self, arg):
        self.arg = arg

    def __repr__(self):
        return f"{self.arg}, optional"

    __str__ = __repr__


def mod_docs(docstring, replacements):
    """Return ``docstring`` with each (pattern, replacement) pair
    applied as a plain-text substitution — the reference's helper for
    rewriting numpy-variant docs into dask-variant docs
    (``util/docs.py`` mod_docs)."""
    for pattern, replacement in replacements:
        docstring = docstring.replace(pattern, replacement)
    return docstring


def doc_tuple_to_str(doc_tuple, replacements=None):
    """Join a namedtuple/dict of docstring sections into one docstring."""
    if hasattr(doc_tuple, "_asdict"):
        fields = doc_tuple._asdict().values()
    elif isinstance(doc_tuple, dict):
        fields = doc_tuple.values()
    else:
        raise TypeError(f"Unhandled doc_tuple type {type(doc_tuple)}")
    doc = "".join(fields)
    if replacements is not None:
        doc = mod_docs(doc, replacements)
    return doc
