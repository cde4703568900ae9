"""WSClean component-list reader.

Port of ``africanus_tpu/model/wsclean/file_model.py``, a numpy module,
kept here as its own copy so that the port needs nothing of the JAX
package. Host-side parser with capability parity to reference
``africanus/model/wsclean/file_model.py:197`` (load): reads the
``Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, ...``
header, applies per-column unit conversion (sexagesimal hours/degrees to
radians, arcsec axes to radians, bracketed SPI coefficient lists), honours
per-column defaults, and zeroes sources whose flux or spectral coefficients
are non-finite (log-SI sources zero to flux 1 so that log(1)=0).

See https://sourceforge.net/p/wsclean/wiki/ComponentList/ for the format.
"""

from __future__ import annotations

import math
import re
import warnings

import numpy as np

__all__ = ["load"]

_HMS = re.compile(r"([+-]?)(\d+):(\d+):(\d+(?:\.\d*)?)")
_DMS = re.compile(r"([+-]?)(\d+)\.(\d+)\.(\d+(?:\.\d*)?)")


def _ra_from_hms(text):
    m = _HMS.match(text)
    if m is None:
        raise ValueError(f"Error parsing '{text}'")
    sign, h, mi, s = m.groups()
    turns = float(h) / 24.0 + float(mi) / 1440.0 + float(s) / 86400.0
    return (-1.0 if sign == "-" else 1.0) * 2.0 * math.pi * turns


def _dec_from_dms(text):
    m = _DMS.match(text)
    if m is None:
        raise ValueError(f"Error parsing '{text}'")
    sign, d, mi, s = m.groups()
    turns = float(d) / 360.0 + float(mi) / 21600.0 + float(s) / 1296000.0
    return (-1.0 if sign == "-" else 1.0) * 2.0 * math.pi * turns


def _arcsec_to_rad(text="0.0"):
    return np.deg2rad(float(text) / 3600.0)


def _spi_list(text):
    inner = text.strip("[] ")
    return [float(tok) for tok in inner.split(",")] if inner else []


_CONVERTERS = {
    "Name": str,
    "Type": str,
    "Ra": _ra_from_hms,
    "Dec": _dec_from_dms,
    "I": float,
    "SpectralIndex": _spi_list,
    "LogarithmicSI": lambda text: text == "true",
    "ReferenceFrequency": float,
    "MajorAxis": _arcsec_to_rad,
    "MinorAxis": _arcsec_to_rad,
    "Orientation": lambda text="0.0": np.deg2rad(float(text)),
}

# Split fields on commas outside [] brackets
_FIELD_SPLIT = re.compile(r",\s*(?=[^\]]*(?:\[|$))")
# "Name" or "Name='default'"
_HEADER_COL = re.compile(r"^\s*(?P<name>.*?)(?:\s*=\s*'(?P<default>.*?)'\s*)?$")


def _read_header(line):
    key, _, descriptor = line.partition("=")
    if key.strip() != "Format":
        raise ValueError(f"'{key.strip()}' is not recognisable as a wsclean header line")

    names, defaults = [], []
    for col in descriptor.split(","):
        m = _HEADER_COL.search(col.strip())
        if m is None:
            raise ValueError(f"'{col}' is not a recognised column name")
        names.append(m.group("name"))
        defaults.append(m.group("default"))
    return names, defaults


def _sanitise(columns):
    """Zero sources whose flux/SPI contain non-finite values (in place)."""
    try:
        names = columns["Name"]
        flux = columns["I"]
        spis = columns["SpectralIndex"]
        log_si = columns["LogarithmicSI"]
    except KeyError as e:
        raise ValueError(f"wsclean component list lacks required column {e}")

    for i, name in enumerate(names):
        bad = not math.isfinite(flux[i])
        if bad:
            warnings.warn(
                f"non-finite flux I {flux[i]} on source {name}; "
                f"zeroing this component."
            )
        if not all(math.isfinite(c) for c in spis[i]):
            warnings.warn(
                f"non-finite spectral index {spis[i]} found on "
                f"source {name}; zeroing this component."
            )
            bad = True
        if bad:
            flux[i] = 1.0 if log_si[i] else 0.0
            spis[i] = [0.0] * len(spis[i])


def load(filename):
    """Load a WSClean component list.

    Parameters
    ----------
    filename : str or iterable of lines

    Returns
    -------
    list of (column_name, list_of_values) tuples; convert with ``dict()``.
    """
    if isinstance(filename, str):
        fh = open(filename, "r")
        own = True
    else:
        fh = iter(filename)
        own = False

    try:
        lines = iter(fh)
        header = ""
        line_nr = 1
        for raw in lines:
            header = raw.split("#", 1)[0].strip()
            if header:
                break
            line_nr += 1
        if not header:
            raise ValueError(f"'{filename}' has no parseable wsclean header line")

        names, defaults = _read_header(header)
        try:
            converters = [_CONVERTERS[n] for n in names]
        except KeyError as e:
            raise ValueError(f"no parser is registered for column {e}")

        columns = {n: [] for n in names}
        for line_nr, raw in enumerate(lines, line_nr + 1):
            line = raw.strip()
            if not line:
                continue
            fields = [f.strip() for f in _FIELD_SPLIT.split(line)]
            if len(fields) != len(names):
                raise ValueError(
                    f"line {line_nr} '{line}' should have {len(names)} components"
                )
            for name, field, conv, default in zip(names, fields, converters, defaults):
                if not field:
                    if default is None:
                        try:
                            columns[name].append(conv())
                        except Exception as e:
                            raise ValueError(
                                f"missing value for column '{name}' on "
                                f"line {line_nr}, no default exists, and "
                                f"generating one failed with {e}"
                            )
                        continue
                    field = default
                columns[name].append(conv(field))

        _sanitise(columns)
        return list(columns.items())
    finally:
        if own:
            fh.close()
