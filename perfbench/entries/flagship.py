"""Entry: ``rime.flagship.FlagshipPredict.forward``, one row chunk a call.

Set-up draws the sky, the array and a pool of consecutive chunks of the
track on the device (each chunk its own dumps, uvw and DIE gain phases);
the window walks the pool in order and wraps round. A kept call keeps
some of its rows (the chunk's longest baseline and rows drawn from the
seed), every channel and correlation, for the comparison with
:func:`perfbench.reference.rime.flagship_rows`.
"""

from __future__ import annotations

import torch

from perfbench import traffic as tr
from perfbench.reference import rime as ref
from perfbench.reference.arith import F64, TF32

NUMBERS = ("vis_err",)


class Flagship:
    def __init__(self, cfg, traffic, seed, device):
        from africanus_tpu_torch.rime.flagship import FlagshipPredict

        gen = tr.generator(seed, device)
        self.freq = tr.frequencies(cfg, device)
        self.sky = tr.sky(traffic["sky"], gen)
        pos = tr.antennas(cfg, gen)
        nd, npool = cfg["chunk_dumps"], traffic["pool_chunks"]
        first = tr.track_start(cfg, gen, nd * npool)
        gmax = traffic["gain_phase_max"]
        self.chunks = []
        for k in range(npool):
            c = tr.observation(cfg, pos, first + k * nd, nd)
            c["gain_phase"] = tr.uniform(
                gen, (nd, cfg["nant"], cfg["nchan"], cfg["ncorr"]), -gmax, gmax)
            uv = c["uvw"][:, :2].to(torch.float64)
            c["longest"] = torch.argmax((uv * uv).sum(dim=1)).reshape(1)
            self.chunks.append(c)
        self.model = FlagshipPredict(**self.sky).to(device)
        nrow = self.chunks[0]["uvw"].shape[0]
        self.nrow, self.kept_rows = nrow, traffic["kept_rows"]
        self.sample_gen = tr.generator(seed + 1, device)
        self.vis_per_call = nrow * cfg["nchan"] * cfg["ncorr"]
        # the problem's sizes, which perfbench/work/ reads each kernel's from
        self.shapes = {"sources": self.sky["lm"].shape[0], "rows": nrow,
                       "chan": cfg["nchan"], "corr": cfg["ncorr"]}

    def call(self, i):
        c = self.chunks[i % len(self.chunks)]
        return self.model(c["time"], c["antenna1"], c["antenna2"], c["uvw"],
                          self.freq, c["gain_phase"])

    def keep(self, i, out):
        """What the comparison needs of call ``i``'s output."""
        k = i % len(self.chunks)
        drawn = torch.randint(0, self.nrow, (self.kept_rows - 1,),
                              generator=self.sample_gen,
                              device=self.sample_gen.device)
        rows = torch.cat([self.chunks[k]["longest"], drawn])
        return k, rows, out.index_select(0, rows)

    def release(self):
        del self.model

    def _rows(self, k, rows):
        c = self.chunks[k]
        return {"uvw": c["uvw"][rows], "time": c["time"][rows] - c["time"].min(),
                "antenna1": c["antenna1"][rows], "antenna2": c["antenna2"][rows],
                "gain_phase": c["gain_phase"]}

    def _readings(self, kept, got):
        err = 0.0
        for k, rows, out in kept:
            want = ref.flagship_rows(self.sky, self._rows(k, rows), self.freq, F64)
            diff = (got(k, rows, out).to(torch.complex128) - want).abs().max()
            err = max(err, float(diff / want.abs().max()))
        return {"vis_err": err}

    def readings(self, kept):
        """The program's numbers against the float64 reference."""
        return self._readings(kept, lambda k, rows, out: out)

    def control_readings(self, kept):
        """The TF32 control's numbers, the control in the program's place."""
        return self._readings(kept, lambda k, rows, out: ref.flagship_rows(
            self.sky, self._rows(k, rows), self.freq, TF32))


def setup(cfg, traffic, seed, device):
    return Flagship(cfg, traffic, seed, device)
