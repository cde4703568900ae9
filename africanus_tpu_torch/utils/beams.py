"""FITS beam-cube header parsing and filename schemas.

Equivalents of reference ``africanus/util/beams.py`` (FitsAxes:13,
BeamAxes:47, beam_grids:139, beam_filenames:259): interpret CTYPE/CRVAL/
CDELT/CRPIX axes (degrees → radians, irregular GFREQ grids), identify the
L/M/FREQ axes, and expand ``beam_$(corr)_$(reim).fits`` filename schemas.

``load_beam_cube`` reads the re/im FITS pairs into the (lw, mh, nud,
corr) complex cube + extents + frequency map expected by
:func:`africanus_tpu_torch.rime.beam_cube_dde`.

A copy of ``africanus_tpu/utils/beams.py`` (numpy only; the port may
not import the JAX package).
"""

from __future__ import annotations

import re
import string

import numpy as np

__all__ = [
    "FitsAxes",
    "BeamAxes",
    "axis_and_sign",
    "beam_grids",
    "beam_filenames",
    "load_beam_cube",
]


class FitsAxes:
    """Per-axis FITS header info with FORTRAN→C index conversion."""

    def __init__(self, header=None):
        self._ndims = ndims = 0 if header is None else header["NAXIS"]
        axr = list(range(1, ndims + 1))
        self._naxis = [header.get(f"NAXIS{n}") for n in axr]
        self._ctype = [str(header.get(f"CTYPE{n}", n)).strip() for n in axr]
        self._crval = [header.get(f"CRVAL{n}", 0) for n in axr]
        self._crpix = [header[f"CRPIX{n}"] - 1 for n in axr]
        self._cdelt = [header.get(f"CDELT{n}", 1) for n in axr]
        self._cunit = [str(header.get(f"CUNIT{n}", "")).strip().upper()
                       for n in axr]


def axis_and_sign(ax_str, default=None):
    """Split "-L" into ("L", -1.0); bare axes have sign +1."""
    if not ax_str:
        if default:
            return default, 1.0
        raise ValueError("a default is required when ax_str is None")
    if not isinstance(ax_str, str):
        raise TypeError("ax_str must be a str")
    return (ax_str[1:], -1.0) if ax_str[0] == "-" else (ax_str, 1.0)


class BeamAxes(FitsAxes):
    """Beam cube axes: degree axes converted to radians; grids built per
    axis, honouring irregular per-channel G<CTYPE><n> grids (GFREQ…)."""

    def __init__(self, header=None):
        super().__init__(header)

        irregular = [
            np.asarray(
                [
                    header.get(f"G{self._ctype[i]}{j}", None)
                    for j in range(1, self._naxis[i] + 1)
                ]
            )
            for i in range(self._ndims)
        ]
        self._irreg = [
            all(x is not None for x in irregular[i]) for i in range(self._ndims)
        ]

        self._grid = [None] * self._ndims
        for i in range(self._ndims):
            if self._cunit[i] == "DEG":
                self._cunit[i] = "RAD"
                self._crval[i] = np.deg2rad(self._crval[i])
                self._cdelt[i] = np.deg2rad(self._cdelt[i])
            if self._irreg[i]:
                self._grid[i] = irregular[i].astype(np.float64)
            else:
                r = np.arange(0.0, float(self._naxis[i]))
                self._grid[i] = (r - self._crpix[i]) * self._cdelt[i] + self._crval[i]

    ndims = property(lambda self: self._ndims)
    crpix = property(lambda self: self._crpix)
    naxis = property(lambda self: self._naxis)
    crval = property(lambda self: self._crval)
    cdelt = property(lambda self: self._cdelt)
    cunit = property(lambda self: self._cunit)
    ctype = property(lambda self: self._ctype)
    grid = property(lambda self: self._grid)


def beam_grids(header, l_axis=None, m_axis=None):
    """Locate the L/M/FREQ axes and return
    ((l_axis, l_grid), (m_axis, m_grid), (freq_axis, freq_grid)) with
    FORTRAN 1-indexed axis numbers (reference beams.py:139-210)."""
    beam_axes = BeamAxes(header)
    l = m = freq = None  # noqa: E741

    for i in range(beam_axes.ndims):
        ct = beam_axes.ctype[i].upper()
        if ct in ("L", "X", "PX"):
            l = i  # noqa: E741
        elif ct in ("M", "Y", "PY"):
            m = i
        elif ct == "FREQ":
            freq = i

    if l is None:
        raise ValueError("FITS header lacks an L/X/PX axis")
    if m is None:
        raise ValueError("FITS header lacks an M/Y/PY axis")
    if freq is None:
        raise ValueError("FITS header lacks a FREQ axis")

    l_sign = axis_and_sign(l_axis, "L")[1]
    m_sign = axis_and_sign(m_axis, "M")[1]

    return (
        (l + 1, beam_axes.grid[l] * l_sign),
        (m + 1, beam_axes.grid[m] * m_sign),
        (freq + 1, beam_axes.grid[freq]),
    )


class FitsFilenameTemplate(string.Template):
    """$(identifier) braced pattern used by FITS beam filename schemas."""

    pattern = r"""
    %(delim)s(?:
      (?P<escaped>%(delim)s)   |
      (?P<named>%(id)s)        |
      \((?P<braced>%(id)s)\)   |
      (?P<invalid>)
    )
    """ % {
        "delim": re.escape(string.Template.delimiter),
        "id": string.Template.idpattern,
    }


CIRCULAR_CORRELATIONS = ("rr", "rl", "lr", "ll")
LINEAR_CORRELATIONS = ("xx", "xy", "yx", "yy")
REIM = ("re", "im")


def _re_im_filenames(corr, template):
    filenames = []
    for ri in REIM:
        try:
            filenames.append(
                template.substitute(
                    corr=corr.lower(),
                    CORR=corr.upper(),
                    reim=ri.lower(),
                    REIM=ri.upper(),
                )
            )
        except KeyError:
            raise ValueError(
                f"Invalid filename schema '{template.template}'. "
                f"FITS Beam filename schemas must follow forms such as "
                f"'beam_$(corr)_$(reim).fits' or 'beam_$(CORR)_$(REIM).fits."
            )
    return tuple(filenames)


def beam_filenames(filename_schema, corr_types):
    """{correlation: (re_file, im_file)} from a schema and CASA corr ids
    (reference beams.py:259)."""
    from africanus_tpu_torch.utils.casa_types import STOKES_ID_MAP

    template = FitsFilenameTemplate(str(filename_schema))
    out = {}
    for corr_type in corr_types:
        try:
            corr = STOKES_ID_MAP[corr_type].lower()
        except KeyError:
            raise ValueError(f"Invalid correlation type {corr_type}")
        out[corr] = _re_im_filenames(corr, template)
    return out


def load_beam_cube(filename_schema, corr_types, l_axis=None, m_axis=None):
    """Read the re/im FITS files of a beam schema into the inputs of
    :func:`africanus_tpu_torch.rime.beam_cube_dde`.

    Returns
    -------
    beam : (lw, mh, nud, ncorr) complex numpy array
    beam_lm_extents : (2, 2) array [[l_low, l_high], [m_low, m_high]]
    beam_freq_map : (nud,) array
    """
    from africanus_tpu_torch.utils.fits import read_fits

    filenames = beam_filenames(filename_schema, corr_types)
    cubes = []
    extents = freq_map = None
    for corr, (re_file, im_file) in filenames.items():
        header, re_data = read_fits(re_file)
        _, im_data = read_fits(im_file)
        (l_ax, l_grid), (m_ax, m_grid), (f_ax, f_grid) = beam_grids(
            header, l_axis, m_axis
        )
        ndims = header["NAXIS"]
        # FITS data is C-ordered with NAXIS1 last: convert FORTRAN axis
        # numbers to C axis positions
        caxes = [ndims - l_ax, ndims - m_ax, ndims - f_ax]
        re_t = np.transpose(re_data, caxes)
        im_t = np.transpose(im_data, caxes)
        cubes.append(re_t + 1j * im_t)
        extents = np.array(
            [[l_grid[0], l_grid[-1]], [m_grid[0], m_grid[-1]]]
        )
        freq_map = f_grid
    beam = np.stack(cubes, axis=-1)
    return beam, extents, freq_map
