"""RIME specification DSL.

Port of ``africanus_tpu/rime/fused/specification.py`` (pure Python).

Parses strings like ``"(Kpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"`` into term
instances — capability parity with reference
``africanus/experimental/rime/fused/specification.py`` (RimeSpecification
:177, parse_rime:78, TERM_STRING_REGEX:19). Term letters map via TERM_MAP
(K→Phase, B→Brightness, L→FeedRotation, E→BeamCubeDDE, G→Gaussian) and
the pq/p/q suffix selects the middle/left/right configuration; right
terms are conjugate-transposed in the chain.
"""

from __future__ import annotations

import re
import warnings

from africanus_tpu_torch.rime.fused.terms import (
    BeamCubeDDE,
    Brightness,
    FeedRotation,
    Gaussian,
    Phase,
    Term,
)

__all__ = ["RimeSpecification", "RimeParseError", "RimeSpecificationError",
           "parse_rime"]

TERM_STRING_REGEX = re.compile(r"([A-Z])(pq|p|q)")
_LIST_REGEX = re.compile(r"[\[\(]([^\]\)]*)[\]\)]")


class RimeParseError(ValueError):
    """The RIME specification string could not be parsed (malformed
    term tuple / polarisation block syntax)."""


class RimeSpecificationError(ValueError):
    """The parsed RIME specification is semantically invalid (unknown
    term, missing Phase/Brightness, bad stokes/correlation schema)."""


def _parse_str_list(text):
    m = _LIST_REGEX.search(text.strip())
    if m is None:
        raise RimeParseError(f"Expected a bracketed list, got {text!r}")
    return [t.strip() for t in m.group(1).split(",") if t.strip()]


def parse_rime(rime: str):
    """Split a spec string into (equation term strings, stokes, corrs)."""
    bits = [s.strip() for s in rime.split(":")]
    if len(bits) != 2:
        raise RimeParseError(
            f"RIME specification must look like "
            f"[Gp, (Kpq, Bpq), Gq]: [I,Q,U,V] -> [XX,XY,YX,YY]. Got {rime}."
        )
    rime_bits, polarisation_bits = bits

    pol_bits = [s.strip() for s in polarisation_bits.split("->")]
    if len(pol_bits) != 2:
        raise RimeParseError(
            f"Polarisation block must look like "
            f"[I,Q,U,V] -> [XX,XY,YX,YY]. Got {polarisation_bits}."
        )

    stokes = [s.upper() for s in _parse_str_list(pol_bits[0])]
    corrs = [c.upper() for c in _parse_str_list(pol_bits[1])]

    # the equation may nest brackets for readability — [Gp, (Kpq, Bpq), Gq]
    # — but terms chain left-to-right regardless, so flatten
    if not re.fullmatch(r"[\w\s,\[\]\(\)]+", rime_bits):
        raise RimeParseError(f"Invalid characters in equation {rime_bits!r}")
    flat = re.sub(r"[\[\]\(\)]", " ", rime_bits)
    equation = [t for t in re.split(r"[,\s]+", flat) if t]
    if not equation:
        raise RimeParseError(f"Empty RIME equation in {rime!r}")
    return equation, stokes, corrs


def _decompose_term_str(term_str):
    m = TERM_STRING_REGEX.match(term_str)
    if m is None:
        raise RimeParseError(
            f"{term_str} does not match {TERM_STRING_REGEX.pattern}"
        )
    return m.group(1), m.group(2)


class RimeSpecification:
    """A parsed RIME specification holding instantiated Term objects.

    Parameters
    ----------
    specification : str — e.g. ``"(Kpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"``
    terms : optional {letter: Term subclass or name} overrides/extensions
    """

    VALID_STOKES = {"I", "Q", "U", "V"}
    TERM_MAP = {
        "K": Phase,
        "B": Brightness,
        "L": FeedRotation,
        "E": BeamCubeDDE,
        "G": Gaussian,
    }

    def __init__(self, specification, terms=None):
        equation, stokes, corrs = parse_rime(specification)

        if not set(stokes).issubset(self.VALID_STOKES):
            raise RimeSpecificationError(
                f"{stokes} has unrecognised stokes parameters; "
                f"Only {self.VALID_STOKES} are accepted"
            )

        self._specification = specification
        self.equation = equation
        self.stokes = stokes
        self.corrs = corrs
        self.feed_type = self._feed_type(corrs)

        term_map = dict(self.TERM_MAP)
        if terms:
            for k, v in dict(terms).items():
                if isinstance(v, str):
                    # reference semantics: resolve by class name among
                    # known Term subclasses (specification.py search_types)
                    def _walk(cls):
                        yield cls
                        for sub in cls.__subclasses__():
                            yield from _walk(sub)

                    named = {c.__name__: c for c in _walk(Term)}
                    try:
                        v = named[v]
                    except KeyError:
                        raise RimeSpecificationError(
                            f"Can't find a type matching {v!r}"
                        ) from None
                if isinstance(v, type) and issubclass(v, Term):
                    term_map[k] = v
                else:
                    raise RimeSpecificationError(
                        f"Can't find a type matching {v!r}"
                    )

        import inspect

        self.terms = []
        for term_str in equation:
            char, cfg = _decompose_term_str(term_str)
            cfg = {"pq": "middle", "p": "left", "q": "right"}[cfg]
            try:
                cls = term_map[char]
            except KeyError as e:
                raise RimeSpecificationError(f"Unknown term {e}")

            sig = inspect.signature(cls.__init__)
            available = {
                "configuration": cfg,
                "stokes": stokes,
                "corrs": corrs,
                "feed_type": self.feed_type,
            }
            kwargs = {}
            for name in list(sig.parameters)[1:]:
                if name in available:
                    kwargs[name] = available[name]
            self.terms.append(cls(**kwargs))

        types_present = {type(t) for t in self.terms}
        if Phase not in types_present:
            warnings.warn("specification lacks a standard Phase term")
        if Brightness not in types_present:
            warnings.warn("specification lacks a standard Brightness term")

    @staticmethod
    def _feed_type(corrs):
        linear = {"XX", "XY", "YX", "YY"}
        circular = {"RR", "RL", "LR", "LL"}
        scorrs = set(corrs)
        if scorrs.issubset(linear):
            return "linear"
        if scorrs.issubset(circular):
            return "circular"
        raise RimeSpecificationError(
            f"Correlations {corrs} are not purely linear or circular"
        )

    def __str__(self):
        return self._specification

    def __repr__(self):
        return f'{type(self).__name__}("{self._specification}")'

    def __hash__(self):
        return hash(self._specification)

    def __eq__(self, other):
        return (
            isinstance(other, RimeSpecification)
            and self._specification == other._specification
        )
