"""Entry: ``gridding.wgridder.api.residual``, one full-band chunk a call:
the residual image of a major cycle, dirty(I − degrid(model)), with Stokes
I = (XX + YY) / 2 formed in the call.

Set-up draws the array from the seed and takes the track's chunks at the
cell's hour angles (``hour_angles_h``: the first and last of the track),
a true sky of point components on pixel centres and the model image (some
of them, their fluxes perturbed). The visibilities XX and YY are the true
sky's (made by the program's own degridding, since no check trusts them)
plus complex gaussian noise, on the device; uvw and the frequencies are
host numpy, as a measurement set's reader hands them over. Those
set-up calls build the chunks' plans (``make_plan``'s cache, which a
major cycle reuses) and their blocks of planes.

A call records the model visibilities its ``api.residual`` degrids (the
value ``api.degrid`` returns inside it; nothing else of the call
changes). A kept call keeps its chunk, rows (the chunk's longest baseline
and rows drawn from the seed) and pixels (in the outer corners, at model
components, uniform; drawn from the seed), the dirty image there and
those model visibilities. Once the window has closed, the model
visibilities are compared at the kept rows with
:func:`perfbench.reference.imaging.model_rows`, and the call's residual
visibilities I − model are the input of
:func:`perfbench.reference.imaging.dirty_pixels`, which the kept pixels
are compared with (the dirty image is held to the reference's image of
the call's own residual, as selfcal's CLEAN is held to the program's
dirty image).

The process's CUDA caching allocator maps its memory in expandable
segments (``PYTORCH_CUDA_ALLOC_CONF``, set here, before the card's
first allocation, unless the environment sets it): a block of planes'
grid and FFT are tens of GB, made and freed between tensors that stay
(the plans, the chunks' values), and in fixed segments a tensor that
stays, carved from a freed block's segment, leaves the rest of it too
small for the next block (an H100 ran out of memory in set-up with
25 GiB reserved and unused).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from perfbench import traffic as tr
from perfbench.reference import imaging as ref
from perfbench.work import grid_wstack as grid_work

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

NUMBERS = ("model_err", "dirty_err")
# the controls ``correct`` has to reject: the reference in float32,
# phases included, and the reference without the w-term
CONTROLS = {"float32": dict(dtype=torch.float32),
            "no_w": dict(dtype=torch.float64, w_term=False)}


class WStack:
    def __init__(self, cfg, traffic, seed, device):
        from africanus_tpu_torch.gridding.wgridder import api, core

        self.api, self.core = api, core
        img = cfg["imaging"]
        self.npix, self.eps = img["npix"], img["epsilon"]
        self.cell = math.radians(img["cell_arcsec"] / 3600)
        gen = tr.generator(seed, device)
        nd, nchan = cfg["chunk_dumps"], cfg["nchan"]
        self.freq = tr.frequencies(cfg, device)
        self.freq_host = self.freq.cpu().numpy()
        pos = tr.antennas(cfg, gen)
        total = int(round(cfg["track_s"] / cfg["dump_s"]))

        npix2 = self.npix * self.npix
        sky = traffic["sky"]
        self.pix = torch.randperm(npix2, generator=gen, device=device)[:sky["count"]]
        flux = tr.power_law(gen, sky["count"], *sky["flux_jy"], sky["count_slope"])
        true = torch.zeros(npix2, dtype=torch.float32, device=device)
        true[self.pix] = flux.to(torch.float32)
        m = traffic["model"]
        self.model_flux = (flux[:m["count"]] * (1 + tr.normal(
            gen, (m["count"],), m["flux_sigma"], torch.float64))).to(torch.float32)
        self.model_pix = self.pix[:m["count"]]
        model = torch.zeros(npix2, dtype=torch.float32, device=device)
        model[self.model_pix] = self.model_flux
        self.model = model.reshape(1, self.npix, self.npix)

        # every chunk's noise first, then the true sky's visibilities added:
        # what stays on the card is made before the program's first blocks
        self.chunks = []
        for h in traffic["hour_angles_h"]:
            first = min(max(int(round((h * 3600 + cfg["track_s"] / 2) / cfg["dump_s"])), 0),
                        total - nd)
            c = tr.observation(cfg, pos, first, nd)
            c["uvw_host"] = c["uvw"].cpu().numpy()
            nrow = c["uvw"].shape[0]
            c["xx"], c["yy"] = torch.view_as_complex(tr.normal(
                gen, (2, nrow, nchan, 2), traffic["noise_jy"])).unbind(0)
            uv = c["uvw"][:, :2].to(torch.float64)
            c["longest"] = torch.argmax((uv * uv).sum(dim=1)).reshape(1)
            self.chunks.append(c)
        for c in self.chunks:
            vis = self.api.model(c["uvw_host"], self.freq_host,
                                 true.reshape(1, self.npix, self.npix), [0], [nchan],
                                 self.cell, epsilon=self.eps)
            c["xx"] += vis
            c["yy"] += vis
            del vis
        del true

        nrow = self.chunks[0]["uvw"].shape[0]
        self.nrow, self.nchan = nrow, nchan
        self.kept_rows, self.kept_pixels = traffic["kept_rows"], traffic["kept_pixels"]
        # the pixel indices along an axis whose |l| passes corner_frac of
        # the half-width (npix / 2 cells)
        axis = torch.arange(self.npix, device=device)
        self.outer = axis[(axis - self.npix // 2).abs() > traffic["corner_frac"] * self.npix / 2]
        self.sample_gen = tr.generator(seed + 1, device)
        self.vis_per_call = nrow * nchan * 2
        # the problem's sizes, which perfbench/work/ reads each kernel's
        # from: the samples, the kernel's support, the grid, and the planes
        # and cells the samples' windows hold (the pool's means)
        plans = [self._plan(c) for c in self.chunks]
        feet = np.array([grid_work.footprint(c["uvw"], self.freq, p.nu, p.nv, self.cell,
                                             p.support, p.screen.w)
                         for c, p in zip(self.chunks, plans)], dtype=np.float64)
        self.shapes = {"rows": nrow, "chan": nchan, "wstack_samples": nrow * nchan,
                       "wstack_support": plans[0].support,
                       "wstack_grid": (plans[0].nu, plans[0].nv),
                       "wstack_planes": float(feet[:, 0].mean()),
                       "wstack_cells": float(feet[:, 1].mean())}
        self._mvis = None

    def _plan(self, c):
        """The chunk's plan, from ``make_plan``'s cache (as the call finds it)."""
        return self.core.make_plan(c["uvw_host"], self.freq_host, self.npix, self.npix,
                                   self.cell, self.cell, self.eps,
                                   device=self.model.device)

    def call(self, i):
        c = self.chunks[i % len(self.chunks)]
        self._mvis = None
        vis = (c["xx"] + c["yy"]) / 2
        degrid = self.api.degrid

        def recorded(*args, **kwargs):
            self._mvis = degrid(*args, **kwargs)
            return self._mvis

        self.api.degrid = recorded
        try:
            return self.api.residual(c["uvw_host"], self.freq_host, self.model, vis, [0],
                                     [self.nchan], self.cell, epsilon=self.eps)
        finally:
            self.api.degrid = degrid

    def _draw(self, n, hi):
        return torch.randint(0, hi, (n,), generator=self.sample_gen,
                             device=self.sample_gen.device)

    def keep(self, i, out):
        """What the comparison needs of call ``i``'s output."""
        k = i % len(self.chunks)
        rows = torch.cat([self.chunks[k]["longest"], self._draw(self.kept_rows - 1, self.nrow)])
        kp, n, outer = self.kept_pixels, self.npix, self.outer
        ci, cj = (outer[self._draw(kp["corners"], outer.numel())] for _ in range(2))
        comps = self.model_pix[self._draw(kp["components"], self.model_pix.numel())]
        pix = torch.cat([ci * n + cj, comps, self._draw(kp["uniform"], n * n)])
        return k, rows, pix, out.reshape(-1).index_select(0, pix), self._mvis

    def release(self):
        self._mvis = None

    def _reference_model(self, k, rows, **how):
        lm = ref.pixel_lm(self.model_pix, self.npix, self.npix, self.cell)
        return ref.model_rows(lm, self.model_flux, self.chunks[k]["uvw"][rows],
                              self.freq, **how)

    def _reference_dirty(self, k, pix, mvis, **how):
        c = self.chunks[k]
        resid = (c["xx"] + c["yy"]) / 2 - mvis
        lm = ref.pixel_lm(pix, self.npix, self.npix, self.cell)
        return ref.dirty_pixels(resid, c["uvw"], self.freq, lm, **how)

    def _readings(self, kept, side):
        """Each number's worst over the kept calls: ``side(k, rows, pix,
        dirty, mvis)`` gives (model visibilities at rows, dirty image at
        pix) of the side judged."""
        worst = dict.fromkeys(NUMBERS, 0.0)
        for k, rows, pix, dirty, mvis in kept:
            model, image = side(k, rows, pix, dirty, mvis)
            want_m = self._reference_model(k, rows)
            want_d = self._reference_dirty(k, pix, mvis)
            numbers = {
                "model_err": (model.to(torch.complex128) - want_m).abs().max()
                / want_m.abs().max(),
                "dirty_err": (image.to(torch.float64) - want_d).abs().max()
                / want_d.abs().max()}
            for name, x in numbers.items():
                worst[name] = max(worst[name], float(x))
        return worst

    def readings(self, kept):
        """The program's numbers against the float64 reference."""
        return self._readings(kept, lambda k, rows, pix, dirty, mvis: (
            mvis[rows], dirty))

    def control_readings(self, kept, control="float32"):
        """A control's numbers, the control in the program's place: the
        reference in float32, phases included (``"float32"``), or in
        float64 without the w-term (``"no_w"``); its dirty image made from
        the call's residual, as the program's is held."""
        how = CONTROLS[control]
        return self._readings(kept, lambda k, rows, pix, dirty, mvis: (
            self._reference_model(k, rows, **how),
            self._reference_dirty(k, pix, mvis, **how)))


def setup(cfg, traffic, seed, device):
    return WStack(cfg, traffic, seed, device)
