"""Entry: ``rime.fused.rime`` on the direction-dependent specification
``[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]``, one row
chunk a call, with no source block given: the library chooses it.

Set-up draws the sky, the array and a pool of consecutive chunks of the
track on the device, and makes the configuration's analytic beam cube
there (:func:`perfbench.reference.dde.analytic_beam`, complex64) and one
beam scaling an antenna. Each chunk has its own dumps, uvw, parallactic
angles (from the hour angle of :func:`perfbench.traffic.observation` at
the site's latitude, one an antenna and dump: the beam's rotation and
the feeds') and pointing errors (an antenna and dump, the same in every
channel). The host columns (time in seconds, antennas) are numpy, as a
measurement set's reader hands them over. The window walks the pool in
order and wraps round. A kept call keeps some of its rows (the chunk's
longest baseline and rows drawn from the seed), every channel and
correlation, for the comparison with
:func:`perfbench.reference.dde.dde_rows`.
"""

from __future__ import annotations

import math

import torch

from perfbench import traffic as tr
from perfbench.reference import dde as ref
from perfbench.reference.arith import F64, TF32

NUMBERS = ("vis_err",)
SPEC = "[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"
# the controls ``correct`` has to reject: TF32 arithmetic, and the
# reference without E's off-diagonal terms or without the pointing errors
CONTROLS = {"tf32": dict(p=TF32), "no_leakage": dict(p=F64, leakage=False),
            "no_pointing": dict(p=F64, pointing=False)}


def parallactic_angle(hour_angle, latitude, declination):
    """The parallactic angle (radians) at ``hour_angle`` (a tensor)."""
    sl, cl = math.sin(latitude), math.cos(latitude)
    sd, cd = math.sin(declination), math.cos(declination)
    return torch.atan2(torch.sin(hour_angle) * cl,
                       sl * cd - cl * sd * torch.cos(hour_angle))


class Dde:
    def __init__(self, cfg, traffic, seed, device):
        from africanus_tpu_torch.rime.fused import rime

        self.rime = rime
        f32 = torch.float32
        gen = tr.generator(seed, device)
        nant, nchan = cfg["nant"], cfg["nchan"]
        self.freq = tr.frequencies(cfg, device)
        self.sky = tr.sky(traffic["sky"], gen)
        pos = tr.antennas(cfg, gen)
        nd, npool = cfg["chunk_dumps"], traffic["pool_chunks"]
        first = tr.track_start(cfg, gen, nd * npool)

        b = cfg["beam"]
        fmap = torch.linspace(*cfg["band_hz"], b["planes"], dtype=torch.float64,
                              device=device)
        cube = ref.analytic_beam(b["npix"], b["extent_rad"], fmap,
                                 math.radians(b["hpbw_arcmin"] / 60), b["hpbw_hz"],
                                 b["elongation"], b["leakage"], device)
        ext = b["extent_rad"]
        self.beam = {"beam": cube.to(torch.complex64),
                     "extents": torch.tensor([[-ext, ext], [-ext, ext]], dtype=f32,
                                             device=device),
                     "freq_map": fmap.to(f32)}
        scaling = 1 + tr.normal(gen, (nant, 1, 2), cfg["beam_scaling_sigma"])
        self.scaling = scaling.expand(nant, nchan, 2)

        lat, dec = math.radians(cfg["latitude_deg"]), math.radians(cfg["dec_deg"])
        self.chunks = []
        for k in range(npool):
            c = tr.observation(cfg, pos, first + k * nd, nd)
            dumps = torch.arange(first + k * nd, first + (k + 1) * nd,
                                 device=device, dtype=torch.float64)
            hour = tr.EARTH_ROTATION * (dumps * cfg["dump_s"] - cfg["track_s"] / 2)
            pa = parallactic_angle(hour, lat, dec)[:, None].expand(nd, nant)
            c["parangle"] = pa.to(f32).contiguous()
            sc = torch.stack([torch.sin(c["parangle"]), torch.cos(c["parangle"])], -1)
            c["feed_parangle"] = torch.stack([sc, sc], -2)[:, None]  # (nd, 1, ant, 2, 2)
            c["point_errors"] = tr.normal(gen, (nd, nant, 1, 2), cfg[
                "pointing_sigma_rad"]).expand(nd, nant, nchan, 2)
            c["host"] = {"time": (c["time"].to(torch.float64) * cfg["dump_s"]).cpu().numpy(),
                         "antenna1": c["antenna1"].cpu().numpy(),
                         "antenna2": c["antenna2"].cpu().numpy()}
            uv = c["uvw"][:, :2].to(torch.float64)
            c["longest"] = torch.argmax((uv * uv).sum(dim=1)).reshape(1)
            self.chunks.append(c)
        nrow = self.chunks[0]["uvw"].shape[0]
        self.nrow, self.kept_rows = nrow, traffic["kept_rows"]
        self.sample_gen = tr.generator(seed + 1, device)
        self.vis_per_call = nrow * nchan * cfg["ncorr"]
        # the problem's sizes, which perfbench/work/ reads each kernel's from
        self.shapes = {"sources": self.sky["lm"].shape[0], "rows": nrow,
                       "chan": nchan, "corr": cfg["ncorr"], "dde_times": nd,
                       "dde_antennas": nant, "dde_spi": self.sky["spi"].shape[1],
                       "beam_cube": tuple(cube.shape[:3])}

    def arguments(self, i):
        """The keyword arguments of ``rime(SPEC, ...)`` for call ``i``."""
        c = self.chunks[i % len(self.chunks)]
        return dict(**c["host"], uvw=c["uvw"], chan_freq=self.freq, **self.sky,
                    beam=self.beam["beam"], beam_lm_extents=self.beam["extents"],
                    beam_freq_map=self.beam["freq_map"],
                    beam_parangle=c["parangle"], beam_point_errors=c["point_errors"],
                    beam_antenna_scaling=self.scaling,
                    feed_parangle=c["feed_parangle"])

    def call(self, i):
        return self.rime(SPEC, **self.arguments(i))

    def keep(self, i, out):
        """What the comparison needs of call ``i``'s output."""
        k = i % len(self.chunks)
        drawn = torch.randint(0, self.nrow, (self.kept_rows - 1,),
                              generator=self.sample_gen,
                              device=self.sample_gen.device)
        rows = torch.cat([self.chunks[k]["longest"], drawn])
        return k, rows, out.index_select(0, rows)

    def release(self):
        pass

    def _reference(self, k, rows, p, **omit):
        c = self.chunks[k]
        beam = dict(self.beam, parangle=c["parangle"], feed_angle=c["parangle"],
                    point_errors=c["point_errors"], antenna_scaling=self.scaling)
        return ref.dde_rows(self.sky, {"uvw": c["uvw"][rows],
                                       "time": c["time"][rows] - c["time"].min(),
                                       "antenna1": c["antenna1"][rows],
                                       "antenna2": c["antenna2"][rows]},
                            self.freq, beam, p, **omit)

    def _readings(self, kept, got):
        err = 0.0
        for k, rows, out in kept:
            want = self._reference(k, rows, F64)
            diff = (got(k, rows, out).to(torch.complex128) - want).abs().max()
            err = max(err, float(diff / want.abs().max()))
        return {"vis_err": err}

    def readings(self, kept):
        """The program's numbers against the float64 reference."""
        return self._readings(kept, lambda k, rows, out: out)

    def control_readings(self, kept, control="tf32"):
        """A control's numbers, the control in the program's place: the
        reference in TF32 arithmetic (``"tf32"``), or in float64 without
        E's off-diagonal terms (``"no_leakage"``) or without the pointing
        errors (``"no_pointing"``)."""
        return self._readings(kept, lambda k, rows, out: self._reference(
            k, rows, **CONTROLS[control]))


def setup(cfg, traffic, seed, device):
    return Dde(cfg, traffic, seed, device)
