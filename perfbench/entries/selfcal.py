"""Entry: ``calibration.selfcal.SelfcalStep.forward``, one solution
interval a call.

Set-up draws the array, two dumps of the track and a sky of unpolarised
point sources (power-law fluxes, one spectral index each) on the device,
predicts the model visibilities with the float64 reference
(:func:`perfbench.reference.selfcal.predict`), and draws a pool
of observed data: new true gain phases and new noise on the same
geometry each. The program's host plans are made in set-up, as
``SelfcalStep`` makes them. A call takes the next draw of the pool. A
kept call keeps the solved gains, the dirty image, CLEAN's two images and
the re-predict, and the dirty image's pixels to compare (its peak and
pixels drawn from the seed).
"""

from __future__ import annotations

import torch

from perfbench import traffic as tr
from perfbench.reference import selfcal as ref
from perfbench.reference.arith import F64, TF32

NUMBERS = ("gains_err", "dirty_err", "clean_err", "model_err")


class Selfcal:
    def __init__(self, cfg, traffic, seed, device):
        from africanus_tpu_torch.calibration.selfcal import SelfcalStep

        gen = tr.generator(seed, device)
        nant, ntime = cfg["nant"], cfg["ntime"]
        nchan, ncorr = cfg["nchan"], cfg["ncorr"]
        self.cfg, self.npx = cfg, traffic["npx"]
        self.freq = tr.frequencies(cfg, device)
        pos = tr.antennas(cfg, gen)
        obs = tr.observation(cfg, pos, tr.track_start(cfg, gen, ntime), ntime)
        self.obs = obs
        self.time = obs["time"] - obs["time"].min()
        sky = traffic["sky"]
        nsrc = sky["count"]
        self.lm = tr.uniform(gen, (nsrc, 2), -sky["lm_max"], sky["lm_max"])
        flux = tr.power_law(gen, nsrc, *sky["flux_jy"], sky["count_slope"])
        alpha = sky["spi_mean"] + tr.normal(gen, (nsrc,), sky["spi_sigma"],
                                            torch.float64)
        ratio = self.freq.to(torch.float64) / sky["ref_freq"]
        spectra = flux[:, None] * ratio[None, :] ** alpha[:, None]
        self.image = spectra[:, :, None].expand(nsrc, nchan, ncorr).to(
            torch.float32).contiguous()  # unpolarised: XX = YY = I
        model = ref.predict(self.image, obs["uvw"], self.lm, self.freq, F64)
        self.model = model.to(torch.complex64)           # the inputs both
        self.draws = []                                  # sides are handed
        a1, a2 = obs["antenna1"], obs["antenna2"]
        for _ in range(traffic["pool_draws"]):
            phase = tr.uniform(gen, (ntime, nant, nchan, ncorr),
                               -traffic["true_phase_max"],
                               traffic["true_phase_max"], torch.float64)
            g = torch.polar(torch.ones_like(phase), phase)
            data = g[self.time, a1] * model * g[self.time, a2].conj()
            noise = tr.normal(gen, data.shape + (2,), traffic["noise_jy"],
                              torch.float64)
            self.draws.append((data + torch.view_as_complex(noise))
                              .to(torch.complex64))

        nbl = nant * (nant - 1) // 2
        cpu = {k: v.cpu().numpy() for k, v in
               (("uvw", obs["uvw"]), ("lm", self.lm), ("freq", self.freq),
                ("image", self.image))}
        nrow = nbl * ntime
        jones0 = torch.ones((ntime, nant, nchan, 1, ncorr), dtype=torch.complex64)
        self.step = SelfcalStep(
            torch.arange(ntime) * nbl, torch.full((ntime,), nbl),
            a1.cpu().numpy(), a2.cpu().numpy(), cpu["uvw"], cpu["lm"],
            cpu["freq"], cpu["image"], self.model[:, :, None, :].cpu(),
            torch.zeros((nrow, nchan, ncorr), dtype=torch.bool).numpy(),
            torch.ones((nrow, nchan, ncorr)).numpy(), jones0,
            npx=self.npx, gn_iters=cfg["gn_iters"]).to(device)
        self.pixels = traffic["dirty_pixels"]
        self.sample_gen = tr.generator(seed + 1, device)
        self.grid = ref.grid_lm(self.npx, cfg["image_extent_rad"],
                                torch.float32, device)
        self.vis_per_call = nrow * nchan * ncorr
        # the problem's sizes, which perfbench/work/ reads each kernel's from:
        # the residual image sums the correlations into one
        self.shapes = {"sources": nsrc, "rows": nrow, "chan": nchan,
                       "corr": ncorr, "pixels": self.npx ** 2, "image_corr": 1}
        self._predicted = None

    def call(self, i):
        return self.step(self.draws[i % len(self.draws)])

    def keep(self, i, out):
        gains, _, _, dirty, clean, residual_image, re_model = out
        drawn = torch.randint(0, self.npx ** 2, (self.pixels - 1,),
                              generator=self.sample_gen,
                              device=self.sample_gen.device)
        pix = torch.cat([torch.argmax(dirty).reshape(1), drawn])
        return (i % len(self.draws), pix, gains[:, :, :, 0], dirty, clean,
                residual_image, re_model)

    def release(self):
        del self.step

    def _solve(self, k, p):
        o = self.obs
        return ref.solve(self.draws[k], self.model, self.time, o["antenna1"],
                         o["antenna2"], self.cfg["ntime"], self.cfg["nant"],
                         self.cfg["gn_iters"], p)

    def _dirty(self, k, gains, pix, p):
        o = self.obs
        resid = ref.residual(self.draws[k], self.model, gains, self.time,
                             o["antenna1"], o["antenna2"], p)
        return ref.dirty_pixels(resid, o["uvw"], self.grid[pix], self.freq, p)

    def _clean(self, dirty, p):
        c = self.cfg["clean"]
        return ref.clean(dirty, c["gamma"], c["threshold"], c["niter"], p)

    def _predict(self, p):
        return ref.predict(self.image, self.obs["uvw"], self.lm, self.freq, p)

    def _readings(self, kept, side):
        """Each number's worst over the kept calls: ``side(k, pix, kept
        outputs)`` gives (gains, dirty at pix, clean, residual image,
        re-predict) of the side judged."""
        worst = dict.fromkeys(NUMBERS, 0.0)
        if self._predicted is None:
            self._predicted = self._predict(F64)
        want_model = self._predicted
        for k, pix, *outs in kept:
            gains, dirty, clean, res_img, re_model = side(k, pix, outs)
            g_ref = self._solve(k, F64)
            d_ref = self._dirty(k, g_ref, pix, F64)
            # CLEAN is held to the reference CLEAN of the dirty image it
            # was given: the dirty image itself is held above
            c_ref, r_ref = self._clean(outs[1].to(torch.float64), F64)
            scale = outs[1].abs().max().to(torch.float64)
            numbers = {
                "gains_err": (gains.to(torch.complex128) - g_ref).abs().max(),
                "dirty_err": (dirty.to(torch.float64) - d_ref).abs().max()
                / d_ref.abs().max(),
                "clean_err": torch.maximum(
                    (clean.to(torch.float64) - c_ref).abs().max(),
                    (res_img.to(torch.float64) - r_ref).abs().max()) / scale,
                "model_err": (re_model.to(torch.complex128) - want_model)
                .abs().max() / want_model.abs().max(),
            }
            for name, x in numbers.items():
                worst[name] = max(worst[name], float(x))
        return worst

    def readings(self, kept):
        """The program's numbers against the float64 reference."""
        def program(k, pix, outs):
            gains, dirty, clean, res_img, re_model = outs
            return gains, dirty.reshape(-1)[pix], clean, res_img, re_model
        return self._readings(kept, program)

    def control_readings(self, kept):
        """The TF32 control's numbers, the control in the program's place
        (its CLEAN given the program's dirty image, as the program's is)."""
        def control(k, pix, outs):
            gains = self._solve(k, TF32)
            clean, res_img = self._clean(outs[1].to(torch.float32), TF32)
            return (gains, self._dirty(k, gains, pix, TF32), clean, res_img,
                    self._predict(TF32))
        return self._readings(kept, control)


def setup(cfg, traffic, seed, device):
    return Selfcal(cfg, traffic, seed, device)
