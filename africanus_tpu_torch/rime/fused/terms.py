"""Fused RIME terms.

Port of ``africanus_tpu/rime/fused/terms.py`` (reference
``africanus/experimental/rime/fused/terms/``: core.py Term:166,
phase.py:9, brightness.py, gaussian.py:9, feed_rotation.py:4,
cube_dde.py:19). Each term's ``sample`` returns a whole-grid
:class:`TermValue`: complex tensors broadcastable to (source, row, chan),
one per correlation, and the chain is folded with :func:`term_mul`. The
scalar/diag/full promotion table mirrors ``intrinsics.py:29-95``
(_jones_typ_map), and right-configured terms are conjugate-transposed as
``intrinsics.py:865-869`` does. The JAX package's split re/im pairs are
torch complex tensors here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from africanus_tpu_torch.model.shape.gaussian_shape import gaussian
from africanus_tpu_torch.model.spectral.spec_model import spectral_model
from africanus_tpu_torch.rime.fast_beam_cubes import beam_cube_dde
from africanus_tpu_torch.rime.phase import phase_delay

__all__ = [
    "TermValue",
    "term_mul",
    "hermitian",
    "Term",
    "Phase",
    "Brightness",
    "Gaussian",
    "FeedRotation",
    "BeamCubeDDE",
]


@dataclass
class TermValue:
    """A sampled term: complex components broadcastable to (source, row,
    chan).

    kind: "scalar" (1 corr), "diag" (2), "full" (4, row-major [00,01,10,11]).
    comps: tuple of complex tensors, one per correlation lane.
    """

    kind: str
    comps: tuple

    @property
    def ncorr(self):
        return {"scalar": 1, "diag": 2, "full": 4}[self.kind]


def hermitian(v: TermValue) -> TermValue:
    """Conjugate transpose of a term value in its packed representation.

    scalar -> conj; diag -> per-element conj; full 2x2 -> conj with the
    off-diagonal components swapped (reference ``fused/intrinsics.py:70-79``).
    """
    c = v.comps
    if v.kind == "scalar":
        return TermValue("scalar", (c[0].conj(),))
    if v.kind == "diag":
        return TermValue("diag", (c[0].conj(), c[1].conj()))
    return TermValue("full", (c[0].conj(), c[2].conj(), c[1].conj(), c[3].conj()))


def term_mul(a: TermValue, b: TermValue) -> TermValue:
    """Jones product with scalar/diag/full promotion (intrinsics.py:114)."""
    ac, bc = a.comps, b.comps
    key = (a.kind, b.kind)
    if key == ("scalar", "scalar"):
        return TermValue("scalar", (ac[0] * bc[0],))
    if key == ("scalar", "diag"):
        return TermValue("diag", (ac[0] * bc[0], ac[0] * bc[1]))
    if key == ("diag", "scalar"):
        return TermValue("diag", (ac[0] * bc[0], ac[1] * bc[0]))
    if key == ("scalar", "full"):
        return TermValue("full", tuple(ac[0] * x for x in bc))
    if key == ("full", "scalar"):
        return TermValue("full", tuple(x * bc[0] for x in ac))
    if key == ("diag", "diag"):
        return TermValue("diag", (ac[0] * bc[0], ac[1] * bc[1]))
    if key == ("diag", "full"):
        return TermValue(
            "full",
            (ac[0] * bc[0], ac[0] * bc[1], ac[1] * bc[2], ac[1] * bc[3]),
        )
    if key == ("full", "diag"):
        return TermValue(
            "full",
            (ac[0] * bc[0], ac[1] * bc[1], ac[2] * bc[0], ac[3] * bc[1]),
        )
    # full x full: 2x2 matmul on [00, 01, 10, 11]
    return TermValue(
        "full",
        (
            ac[0] * bc[0] + ac[1] * bc[2],
            ac[0] * bc[1] + ac[1] * bc[3],
            ac[2] * bc[0] + ac[3] * bc[2],
            ac[2] * bc[1] + ac[3] * bc[3],
        ),
    )


class Term:
    """Base class. Subclasses define ARGS/KWARGS (argument names pulled
    from the user's kwargs) and implement ``sample(state) -> TermValue``.
    ``configuration`` is "left"/"middle"/"right" from the spec string.

    ``SOURCE_ARGS`` names the subset of ARGS/KWARGS indexed by source on
    their leading axis — the fused core slices exactly these when
    evaluating in source blocks (``rime(..., source_block=N)``). Leave it
    ``None`` (the default) to let the core infer them by matching each
    argument's leading dimension against the source count.

    ``AXES``, ``KIND`` and :meth:`sample_bytes` give the memory a block
    of sources takes, from which the core chooses a source block: the
    axes of (source, row, chan) that the sampled components carry, their
    kind ("scalar", "diag", "full"; None: as many components as the
    specification's correlations), and the bytes its sampling holds
    beyond them, shared by a block's sources and a source. The defaults are a custom term's safe guess: full
    grids and two more complex grids a source while sampling.
    """

    ARGS: tuple = ()
    KWARGS: dict = {}
    SOURCE_ARGS: tuple | None = None
    AXES: str = "srf"
    KIND: str | None = None
    SAMPLE_GRIDS: float = 2.0

    def __init__(self, configuration: str = "middle"):
        self.configuration = configuration

    def validate(self, kwargs):
        missing = [a for a in self.ARGS if a not in kwargs]
        if missing:
            raise ValueError(
                f"{type(self).__name__} requires argument(s) {missing}"
            )

    def sample(self, state) -> TermValue:
        raise NotImplementedError

    def sample_bytes(self, state, nrow, nchan, itemsize):
        """Bytes :meth:`sample` holds at most beyond its output: (shared
        by a block's sources, a source); here none shared and
        ``SAMPLE_GRIDS`` complex (row, chan) grids of ``itemsize`` a
        source."""
        return 0, int(self.SAMPLE_GRIDS * nrow * nchan * itemsize)


class Phase(Term):
    """Phase Delay Term (terms/phase.py:9): e^{C·(ul+vm+(n−1)w)·ν}, the
    two-float compensated phase at float32."""

    ARGS = ("lm", "uvw", "chan_freq")
    SOURCE_ARGS = ("lm",)
    KWARGS = {"convention": "fourier"}
    KIND = "scalar"
    SAMPLE_GRIDS = 1.5  # the two-float reduction, cos and sin

    def sample(self, state) -> TermValue:
        k = phase_delay(state["lm"], state["uvw"], state["chan_freq"],
                        convention=state.get("convention", "fourier"))
        return TermValue("scalar", (k,))


# stokes -> correlation linear combinations (terms/brightness.py:11-21)
_STOKES_CONV = {
    "XX": (("I", 1.0), ("Q", 1.0)),
    "XY": (("U", 1.0), ("V", 1.0j)),
    "YX": (("U", 1.0), ("V", -1.0j)),
    "YY": (("I", 1.0), ("Q", -1.0)),
    "RR": (("I", 1.0), ("V", 1.0)),
    "RL": (("Q", 1.0), ("U", 1.0j)),
    "LR": (("Q", 1.0), ("U", -1.0j)),
    "LL": (("I", 1.0), ("V", -1.0)),
}


class Brightness(Term):
    """Brightness Term (terms/brightness.py): spectral model + stokes→corr."""

    ARGS = ("stokes", "chan_freq")
    SOURCE_ARGS = ("stokes", "spi", "ref_freq")
    KWARGS = {"spi": None, "ref_freq": None, "spi_base": "standard"}
    AXES = "sf"
    SAMPLE_GRIDS = 0.0

    def __init__(self, configuration, stokes, corrs):
        super().__init__(configuration)
        self.stokes_schema = stokes
        self.corr_schema = corrs

    def sample(self, state) -> TermValue:
        stokes = state["stokes"]  # (source, nstokes)
        freq = state["chan_freq"]
        spi = state.get("spi")
        ref_freq = state.get("ref_freq")
        base = state.get("spi_base", "standard")

        # per-stokes spectral model (source, chan, nstokes)
        if spi is not None and ref_freq is not None:
            spec = spectral_model(stokes, spi, ref_freq, freq,
                                  base={"standard": "std"}.get(base, base))
        else:
            spec = stokes[:, None, :].expand(
                stokes.shape[0], freq.shape[0], stokes.shape[1])

        sidx = {s: i for i, s in enumerate(self.stokes_schema)}
        comps = []
        for corr in self.corr_schema:
            try:
                conv = _STOKES_CONV[corr]
            except KeyError:
                raise ValueError(f"No conversion for correlation {corr}")
            re = 0.0
            im = 0.0
            for stokes_name, wgt in conv:
                if stokes_name not in sidx:
                    raise ValueError(
                        f"{corr} requires stokes parameter {stokes_name} "
                        f"but only {self.stokes_schema} are available"
                    )
                term = spec[:, None, :, sidx[stokes_name]]  # (src, 1, chan)
                re = re + term * float(np.real(wgt))
                im = im + term * float(np.imag(wgt))
            comps.append(torch.complex(re, im))

        kind = {1: "scalar", 2: "diag", 4: "full"}[len(comps)]
        return TermValue(kind, tuple(comps))


class Gaussian(Term):
    """Gaussian shape envelope term (scalar amplitude per
    (src, row, chan)) driven by ``gauss_shape`` (emaj, emin, angle);
    reference ``fused/terms/gaussian.py:9``."""

    ARGS = ("uvw", "chan_freq", "gauss_shape")
    SOURCE_ARGS = ("gauss_shape",)
    KIND = "scalar"
    SAMPLE_GRIDS = 1.5  # the envelope's exponent and its real value

    def sample(self, state) -> TermValue:
        env = gaussian(state["uvw"], state["chan_freq"], state["gauss_shape"])
        return TermValue("scalar", (torch.complex(env, torch.zeros_like(env)),))


class FeedRotation(Term):
    """Feed rotation term (terms/feed_rotation.py:4). Samples the per-row
    antenna's feed angles from the transformer-supplied ``feed_parangle``
    table of shape (utime, feed, ant, 2, 2) holding [[sin a, cos a],
    [sin b, cos b]] for the two receptors."""

    ARGS = ("feed_parangle",)
    SOURCE_ARGS = ()
    AXES = "r"
    KIND = "full"
    SAMPLE_GRIDS = 0.0

    def __init__(self, configuration, feed_type, corrs):
        if configuration not in {"left", "right"}:
            raise ValueError(
                f"FeedRotation configuration placement must be 'left' or "
                f"'right'. Got {configuration}"
            )
        if feed_type not in {"linear", "circular"}:
            raise ValueError(
                f"FeedRotation feed_type must be 'linear' or "
                f"'circular'. Got {feed_type}"
            )
        if len(corrs) != 4:
            raise ValueError(
                f"feed rotation needs 4 correlations; got "
                f"{corrs} were specified"
            )
        super().__init__(configuration)
        self.feed_type = feed_type

    def table(self, state):
        """L at every (utime, feed, ant): (utime, feed, ant, 4) complex,
        [00, 01, 10, 11], from ``feed_parangle``."""
        pa = state["feed_parangle"]  # (utime, feed, ant, 2, 2)
        sin_a, cos_a = pa[..., 0, 0], pa[..., 0, 1]
        sin_b, cos_b = pa[..., 1, 0], pa[..., 1, 1]
        zero = torch.zeros_like(sin_a)

        if self.feed_type == "linear":
            comps = (
                torch.complex(cos_a, zero),
                torch.complex(sin_a, zero),
                torch.complex(-sin_b, zero),
                torch.complex(cos_b, zero),
            )
        else:
            comps = (
                torch.complex(0.5 * (cos_a + cos_b), -0.5 * (sin_a + sin_b)),
                torch.complex(0.5 * (cos_a - cos_b), 0.5 * (sin_a - sin_b)),
                torch.complex(0.5 * (cos_a - cos_b), -0.5 * (sin_a - sin_b)),
                torch.complex(0.5 * (cos_a + cos_b), 0.5 * (sin_a + sin_b)),
            )
        return torch.stack(comps, dim=-1)

    def sample(self, state) -> TermValue:
        left = self.configuration == "left"
        t = state["time_inverse"]
        a = state["antenna1_inverse"] if left else state["antenna2_inverse"]
        f = state["feed1_inverse"] if left else state["feed2_inverse"]
        rows = self.table(state)[t, f, a]  # (row, 4)
        return TermValue("full", tuple(rows[None, :, None, i] for i in range(4)))


class BeamCubeDDE(Term):
    """Beam cube DDE term (terms/cube_dde.py:19): trilinear interpolation
    of the FITS beam cube at each source's rotated/scaled position
    (:func:`~africanus_tpu_torch.rime.fast_beam_cubes.beam_cube_dde`,
    through the ``beam_interp`` and ``beam_blend`` kernels on the card's
    chan-invariant route), gathered to rows via the time/antenna inverse
    indices."""

    ARGS = ("beam", "beam_lm_extents", "beam_freq_map", "lm", "chan_freq")
    SOURCE_ARGS = ("lm",)
    KWARGS = {
        "beam_parangle": None,
        "beam_point_errors": None,
        "beam_antenna_scaling": None,
    }

    def __init__(self, configuration, corrs):
        if configuration not in {"left", "right"}:
            raise ValueError(
                f"BeamCubeDDE configuration placement must be 'left' or "
                f"'right'. Got {configuration}"
            )
        super().__init__(configuration)
        self.corrs = corrs

    def sample_bytes(self, state, nrow, nchan, itemsize):
        """Shared: the kernels' copy of the cube ((lw, mh, nud) × 3·corr
        reals); a source: the sampled (time, ant, chan, corr) beam and
        the kernels' raw (time·ant, nud, 3·corr) sums, before the gather
        to rows."""
        beam = state["beam"]
        ncorr = int(np.prod(beam.shape[3:]))
        nta = state["utime"].shape[0] * state["uantenna"].shape[0]
        slabs = 3 * beam.shape[0] * beam.shape[1] * beam.shape[2] * ncorr // 2
        return (slabs * itemsize,
                nta * ncorr * (2 * nchan + 3 * beam.shape[2]) * itemsize // 2)

    def table(self, state):
        """E at every (source, utime, ant, chan): (src, utime, ant, chan,
        corr…) complex, through one :func:`beam_cube_dde` call."""
        beam = state["beam"]
        if not beam.is_complex():
            beam = torch.complex(beam, torch.zeros_like(beam))
        real = beam.real.dtype
        dev = beam.device
        freq = state["chan_freq"]
        nutime = state["utime"].shape[0]
        nant = state["uantenna"].shape[0]
        nchan = freq.shape[0]

        # the defaults are the same in every channel: the chan-invariant
        # route, where the cube spans the frequencies
        pa = state.get("beam_parangle")
        if pa is None:
            pa = torch.zeros((nutime, nant), dtype=real, device=dev)
        pe = state.get("beam_point_errors")
        if pe is None:
            pe = torch.zeros((nutime, nant, nchan, 2), dtype=real, device=dev)
        ascale = state.get("beam_antenna_scaling")
        if ascale is None:
            ascale = torch.ones((nant, nchan, 2), dtype=real, device=dev)

        return beam_cube_dde(
            beam, state["beam_lm_extents"], state["beam_freq_map"],
            state["lm"], pa, pe, ascale, freq,
        )

    def sample(self, state) -> TermValue:
        sampled = self.table(state)  # (src, utime, ant, chan, corr…)
        t = state["time_inverse"]
        left = self.configuration == "left"
        a = state["antenna1_inverse"] if left else state["antenna2_inverse"]
        ncorr = int(np.prod(sampled.shape[4:]))
        flat = sampled.reshape(sampled.shape[:4] + (ncorr,))
        # (src, row, chan) per correlation, gathered one at a time
        comps = tuple(flat[..., i][:, t, a] for i in range(ncorr))
        kind = {1: "scalar", 2: "diag", 4: "full"}[ncorr]
        return TermValue(kind, comps)
