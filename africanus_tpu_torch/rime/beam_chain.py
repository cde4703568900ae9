"""The config-3 beam DDE chain: E Jones from a beam cube × feed rotation.

Twin of ``bench.py``'s ``config3_beam`` (l.677-875), the E-Jones ×
feed-rotation chain of every direction-dependent predict, as
:mod:`africanus_tpu_torch.rime.flagship` is of config 2:

- :func:`beam_inputs` makes the bench's seeded numpy draws (l.686-711,
  and the secondary legs' pointing errors, l.798-812);
- :func:`from_numpy` carries them over to the port: a
  :class:`BeamDDEChain` holding the cube on the device, and the
  parallactic angles;
- :class:`BeamDDEChain` computes E·F (or E alone) through the route the
  caller names, as the bench's legs pass their flags;
- :func:`beam_oracle_f64` is the bench's float64 numpy oracle
  (``np_chain``, l.713-760), on all channels or a window of them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.ops.cuda_beam import beam_slabs
from africanus_tpu_torch.rime.fast_beam_cubes import _Cube, dde, freq_data
from africanus_tpu_torch.rime.feeds import feed_rotation

__all__ = ["BeamDDEChain", "beam_inputs", "from_numpy", "beam_oracle_f64"]

# the bench's cube (l.686-689) and sky
LW = MH = 129
NUD, NCORR = 8, 4
NSRC, NTIME = 8, 1


class BeamDDEChain(nn.Module):
    """E·F of a 2x2 beam cube (or E of a cube of any correlations) at
    fixed sources, pointing errors, antenna scalings and frequencies, for
    the parallactic angles of a call.

    Parameters
    ----------
    beam : (lw, mh, nud, corr…) complex tensor (complex64: the float32
        kernels; complex128: the float64 ones); 2x2 or flat 4 with a feed
        type, any correlations without one
    extents, freq_map, lm, point_errors, antenna_scaling, frequency : as
        :func:`~africanus_tpu_torch.rime.fast_beam_cubes.beam_cube_dde`
    feed_type : "linear", "circular", or None for E alone
    chan_invariant, cell_residual : the route, as the bench's legs pass
        it (None detects it from the inputs, which waits for the card)

    Buffers (moved by ``.to()``): ``slabs`` (the cube as
    :func:`~africanus_tpu_torch.ops.cuda_beam.beam_slabs`), ``extents``,
    ``freq_map``, ``lm``, ``point_errors``, ``antenna_scaling``,
    ``frequency``, all in the beam's real dtype, and the frequencies'
    ``freq_scale``, ``wlo`` and ``gc0`` (int32) from
    :func:`~africanus_tpu_torch.rime.fast_beam_cubes.freq_data`.
    """

    def __init__(self, beam, extents, freq_map, lm, point_errors,
                 antenna_scaling, frequency, feed_type="linear",
                 chan_invariant=True, cell_residual=None):
        super().__init__()
        beam = torch.as_tensor(beam)
        lw, mh, nud = beam.shape[:3]
        ncorr = beam[0, 0, 0].numel()
        if min(lw, mh, nud) < 2 or (feed_type is not None and ncorr != 4):
            raise ValueError("BeamDDEChain: lw, mh, nud >= 2, and a 2x2 beam "
                             "for feed rotation")
        self.lw, self.mh = lw, mh
        # the output's correlation axes: 2x2 for four correlations
        self.corrs = (2, 2) if ncorr == 4 else tuple(beam.shape[3:])
        self.feed_type = feed_type
        self.chan_invariant, self.cell_residual = chan_invariant, cell_residual
        dtype = beam.real.dtype
        self.register_buffer("slabs", beam_slabs(beam))
        for name, x in (("extents", extents), ("freq_map", freq_map), ("lm", lm),
                        ("point_errors", point_errors),
                        ("antenna_scaling", antenna_scaling),
                        ("frequency", frequency)):
            self.register_buffer(name, torch.as_tensor(x).to(beam.device, dtype))
        for name, x in zip(("freq_scale", "wlo", "gc0"),
                           freq_data(self.frequency, self.freq_map)):
            self.register_buffer(name, x)

    def _dde(self, pa, operands=None):
        cube = _Cube(self.slabs, self.lw, self.mh, self.extents, self.freq_map,
                     self.frequency, self.freq_scale, self.wlo, self.gc0)
        feed = (None if self.feed_type is None
                else feed_rotation(pa, self.feed_type).contiguous())
        return dde(cube, self.lm, pa, self.point_errors, self.antenna_scaling,
                   self.chan_invariant, self.cell_residual, feed, operands)

    def forward(self, parallactic_angles):
        """(src, time, ant, chan, 2, 2) complex E·F (E alone without a
        feed type) for (time, ant) parallactic angles; a cube of other
        than four correlations gives its own correlation axes in place of
        (2, 2)."""
        pa = parallactic_angles
        _, e = self._dde(pa)
        return e.reshape(self.lm.shape[0], *pa.shape, self.frequency.shape[0],
                         *self.corrs)

    def kernel_operands(self, parallactic_angles):
        """(route, {wrapper name: its positional operands}) of the kernels
        :meth:`forward` launches for these angles, in the order it launches
        them. Runs the route (the later operands are the earlier kernels'
        outputs)."""
        operands = {}
        route, _ = self._dde(parallactic_angles, operands)
        return route, operands


def beam_inputs(nant=64, nchan=4096, seed=3):
    """The bench's config-3 draws (bench.py:686-711 and 798-812), numpy.

    Returns a dict: ``beam`` (129, 129, 8, 4) complex128 — a smooth
    cos³-like taper with a spectral phase term —, ``extents`` (2, 2),
    ``fmap`` (8,), ``freq`` (nchan,) spanning the cube, ``lm`` (8, 2),
    ``pa`` (1, nant), ``pe`` (1, nant, nchan, 2) zeros, ``asc`` (nant,
    nchan, 2) ones, and the secondary legs' pointing errors: ``pe_tvar``
    (time-varying, the same in every channel) and ``pe_pc`` (per channel),
    both σ = 1e-4, float32.
    """
    rng = np.random.default_rng(seed)
    f32 = np.float32

    ll = np.linspace(-1, 1, LW)[:, None, None]
    mm = np.linspace(-1, 1, MH)[None, :, None]
    nn_ = np.linspace(-1, 1, NUD)[None, None, :]
    amp = np.cos(np.minimum(np.hypot(ll, mm + 0 * nn_), 1.0) * 1.2) ** 3
    phase = 0.3 * ll * nn_ + 0.2 * mm
    beam = (amp * np.cos(phase) + 1j * amp * np.sin(phase))
    beam = np.broadcast_to(beam[..., None], (LW, MH, NUD, NCORR)).copy()

    extents = np.array([[-0.02, 0.02], [-0.02, 0.02]])
    fmap = np.linspace(0.856e9, 1.712e9, NUD)
    freq = np.linspace(fmap[0], fmap[-1], nchan)
    lm = rng.uniform(-0.015, 0.015, (NSRC, 2))
    pa = rng.uniform(-np.pi, np.pi, (NTIME, nant))
    pe = np.zeros((NTIME, nant, nchan, 2))
    asc = np.ones((nant, nchan, 2))
    pe_tvar = np.broadcast_to(
        rng.normal(scale=1e-4, size=(NTIME, nant, 1, 2)),
        (NTIME, nant, nchan, 2),
    ).astype(f32)
    pe_pc = rng.normal(scale=1e-4, size=(NTIME, nant, nchan, 2)).astype(f32)
    return dict(beam=beam, extents=extents, fmap=fmap, freq=freq, lm=lm, pa=pa,
                pe=pe, asc=asc, pe_tvar=pe_tvar, pe_pc=pe_pc)


def from_numpy(args, device, feed_type="linear", chan_invariant=True,
               cell_residual=None):
    """Carry the bench's config-3 inputs over to the port.

    ``args`` is a :func:`beam_inputs` dict (``pe`` is the pointing-error
    table the chain uses: pass ``dict(args, pe=args["pe_pc"])`` for a
    secondary leg). Everything is cast to float32 (a complex64 beam), as
    the bench casts it, on ``device``. Returns ``(chain, pa)``: the
    :class:`BeamDDEChain` with the given feed type and route flags, and
    the (time, ant) parallactic angles, so that ``chain(pa)`` computes
    what the bench's leg computes.
    """
    beam = torch.as_tensor(args["beam"]).to(device, torch.complex64)

    def real(x):
        return torch.as_tensor(np.asarray(x)).to(device, torch.float32)

    chain = BeamDDEChain(beam, real(args["extents"]), real(args["fmap"]),
                         real(args["lm"]), real(args["pe"]), real(args["asc"]),
                         real(args["freq"]), feed_type=feed_type,
                         chan_invariant=chan_invariant, cell_residual=cell_residual)
    return chain, real(args["pa"])


def beam_oracle_f64(args, chans=None):
    """The bench's float64 numpy oracle of the chain with linear feeds
    (``np_chain``, bench.py:713-760), numpy in, numpy out.

    ``chans`` (optional) selects a window of channels. Uses the args'
    ``pe`` and ``asc`` and assumes every frequency inside the cube (no lm
    frequency scaling), as the bench does. Returns (src, time, ant, chan,
    2, 2) complex128.
    """
    fb = np.asarray(args["beam"])
    lw, mh, nud = fb.shape[:3]
    extents, fmap, lm, pa = (np.asarray(args[k], np.float64)
                             for k in ("extents", "fmap", "lm", "pa"))
    chans = slice(None) if chans is None else chans
    freq = np.asarray(args["freq"], np.float64)[chans]
    pe = np.asarray(args["pe"], np.float64)[:, :, chans]
    asc = np.asarray(args["asc"], np.float64)[:, chans]

    scale = np.ones(freq.shape[0])
    i1 = np.clip(np.searchsorted(fmap, freq), 1, nud - 1)
    g0 = i1 - 1
    wlo = (fmap[g0 + 1] - freq) / (fmap[g0 + 1] - fmap[g0])
    l = lm[:, 0][:, None, None, None]  # noqa: E741
    m = lm[:, 1][:, None, None, None]
    tl = l * scale + pe[None, ..., 0]
    tm = m * scale + pe[None, ..., 1]
    sp, cp = np.sin(pa), np.cos(pa)
    vl = tl * cp[None, :, :, None] - tm * sp[None, :, :, None]
    vm = tl * sp[None, :, :, None] + tm * cp[None, :, :, None]
    vl *= asc[None, None, :, :, 0]
    vm *= asc[None, None, :, :, 1]
    lsc = (lw - 1) / (extents[0, 1] - extents[0, 0])
    msc = (mh - 1) / (extents[1, 1] - extents[1, 0])
    vl = np.clip(lsc * (vl - extents[0, 0]), 0, lw - 1)
    vm = np.clip(msc * (vm - extents[1, 0]), 0, mh - 1)
    gl0 = np.floor(vl).astype(int)
    gm0 = np.floor(vm).astype(int)
    gl1 = np.minimum(gl0 + 1, lw - 1)
    gm1 = np.minimum(gm0 + 1, mh - 1)
    ld, md = vl - gl0, vm - gm0
    shape = ld.shape
    g0b = np.broadcast_to(g0, shape)
    g1b = g0b + 1
    wl = np.broadcast_to(wlo, shape)
    acc = 0
    absc = 0
    for gl, wa in ((gl0, 1 - ld), (gl1, ld)):
        for gm, wb in ((gm0, 1 - md), (gm1, md)):
            for gc, wc in ((g0b, wl), (g1b, 1 - wl)):
                w = (wa * wb * wc)[..., None]
                v = fb[gl, gm, gc]
                acc = acc + w * v
                absc = absc + w * np.abs(v)
    div = np.abs(acc)
    norm = np.where(div == 0, absc, absc / np.where(div == 0, 1, div))
    e = acc * norm
    # feed rotation (linear feeds)
    fr = np.zeros(pa.shape + (2, 2), complex)
    fr[..., 0, 0] = np.cos(pa)
    fr[..., 0, 1] = np.sin(pa)
    fr[..., 1, 0] = -np.sin(pa)
    fr[..., 1, 1] = np.cos(pa)
    e22 = e.reshape(shape + (2, 2))
    return np.einsum("stafij,tajk->stafik", e22, fr)
