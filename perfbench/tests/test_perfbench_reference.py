"""The plain references against direct float64 loops at a tiny size,
and the TF32 rounding."""

import cmath
import math

import torch

from perfbench.reference import rime, selfcal
from perfbench.reference.arith import F64, TF32, tf32_round

C = rime.LIGHTSPEED


def gen(seed=3):
    return torch.Generator().manual_seed(seed)


def rand(shape, lo, hi, g):
    return torch.rand(shape, generator=g, dtype=torch.float64) * (hi - lo) + lo


def test_flagship_rows_against_a_loop():
    g = gen()
    S, R, F, T, A = 3, 4, 5, 2, 3
    sky = {"lm": rand((S, 2), -0.01, 0.01, g), "stokes": rand((S, 4), 0.1, 1, g),
           "spi": rand((S, 1, 4), -0.5, 0.5, g),
           "ref_freq": torch.full((S,), 1.2e9, dtype=torch.float64),
           "gauss_shape": rand((S, 3), 0, 1e-4, g)}
    rows = {"uvw": rand((R, 3), -1000, 1000, g), "time": torch.tensor([0, 0, 1, 1]),
            "antenna1": torch.tensor([0, 0, 1, 0]), "antenna2": torch.tensor([1, 2, 2, 2]),
            "gain_phase": rand((T, A, F, 4), -0.1, 0.1, g)}
    freq = torch.linspace(0.9e9, 1.6e9, F, dtype=torch.float64)
    got = rime.flagship_rows(sky, rows, freq, F64, block=3)
    fw = 2 * math.sqrt(2 * math.log(2))
    for r in range(R):
        u, v, w = rows["uvw"][r].tolist()
        t, p, q = (int(rows[k][r]) for k in ("time", "antenna1", "antenna2"))
        for f in range(F):
            nu = float(freq[f])
            acc = [0j] * 4
            for s in range(S):
                l, m = sky["lm"][s].tolist()  # noqa: E741
                n = math.sqrt(1 - l * l - m * m)
                k = cmath.exp(-2j * math.pi * (u * l + v * m + w * (n - 1)) * nu / C)
                emaj, emin, ang = sky["gauss_shape"][s].tolist()
                u1 = (u * emaj * math.cos(ang) - v * emaj * math.sin(ang)) * emin / emaj
                v1 = u * emaj * math.sin(ang) + v * emaj * math.cos(ang)
                sc = nu * math.sqrt(2) * math.pi / (fw * C)
                env = math.exp(-((u1 * sc) ** 2 + (v1 * sc) ** 2))
                flux = [float(sky["stokes"][s, c]) * (nu / 1.2e9)
                        ** float(sky["spi"][s, 0, c]) for c in range(4)]
                i_, q_, u_, v_ = flux
                b = [i_ + q_, u_ + 1j * v_, u_ - 1j * v_, i_ - q_]
                for c in range(4):
                    acc[c] += k * env * b[c]
            for c in range(4):
                gp = cmath.exp(1j * float(rows["gain_phase"][t, p, f, c]))
                gq = cmath.exp(1j * float(rows["gain_phase"][t, q, f, c]))
                want = gp * acc[c] * gq.conjugate()
                assert abs(complex(got[r, f, c]) - want) < 1e-12


def test_selfcal_dfts_against_loops():
    g = gen(4)
    S, R, F, P = 2, 5, 3, 4
    uvw, lm = rand((R, 3), -4000, 4000, g), rand((S, 2), -0.01, 0.01, g)
    freq = torch.linspace(0.9e9, 1.6e9, F, dtype=torch.float64)
    image = rand((S, F, 2), 0.1, 1, g)
    vis = selfcal.predict(image, uvw, lm, freq, F64, block=1)
    resid = torch.complex(rand((R, F), -1, 1, g), rand((R, F), -1, 1, g))
    pix = rand((P, 2), -0.01, 0.01, g)
    dirty = selfcal.dirty_pixels(resid, uvw, pix, freq, F64, block=3)

    def delay(l, m, r):  # noqa: E741
        u, v, w = uvw[r].tolist()
        return u * l + v * m + w * (math.sqrt(1 - l * l - m * m) - 1)

    for r in range(R):
        for f in range(F):
            for c in range(2):
                want = sum(cmath.exp(-2j * math.pi * delay(*lm[s].tolist(), r)
                                     * float(freq[f]) / C) * float(image[s, f, c])
                           for s in range(S))
                assert abs(complex(vis[r, f, c]) - want) < 1e-12
    for x in range(P):
        want = sum((cmath.exp(2j * math.pi * delay(*pix[x].tolist(), r)
                              * float(freq[f]) / C) * complex(resid[r, f])).real
                   for r in range(R) for f in range(F)) / (R * F)
        assert abs(float(dirty[x]) - want) < 1e-12


def test_solve_one_step_against_a_loop():
    g = gen(5)
    nant, T, F, Cr = 3, 1, 2, 1
    a1, a2 = torch.tensor([0, 0, 1]), torch.tensor([1, 2, 2])
    time = torch.zeros(3, dtype=torch.int64)
    model = torch.complex(rand((3, F, Cr), -1, 1, g), rand((3, F, Cr), -1, 1, g))
    data = torch.complex(rand((3, F, Cr), -1, 1, g), rand((3, F, Cr), -1, 1, g))
    gains = selfcal.solve(data, model, time, a1, a2, T, nant, 1, F64)
    for a in range(nant):
        for f in range(F):
            num = den = 0.0
            for r in range(3):
                m, v = complex(model[r, f, 0]), complex(data[r, f, 0])
                im = (m.conjugate() * (v - m)).imag
                if int(a1[r]) == a:
                    num, den = num + im, den + abs(m) ** 2
                if int(a2[r]) == a:
                    num, den = num - im, den + abs(m) ** 2
            want = cmath.exp(0.5j * num / den)
            assert abs(complex(gains[0, a, f, 0]) - want) < 1e-12


def test_clean_against_a_loop():
    img = torch.tensor([[0.1, 0.9, 0.2], [0.3, 1.0, -0.5], [0.0, 0.2, 0.95]],
                       dtype=torch.float64)
    model, res = selfcal.clean(img, 0.1, 0.2, 20, F64)
    want_m, want_r = [[0.0] * 3 for _ in range(3)], [row[:] for row in img.tolist()]
    first = max(max(row) for row in want_r)
    for _ in range(21):
        peak = max(max(row) for row in want_r)
        if not abs(peak) > 0.2 * abs(first):
            break
        i, j = next((i, j) for i in range(3) for j in range(3) if want_r[i][j] == peak)
        want_m[i][j] += 0.1 * peak
        want_r[i][j] -= 0.1 * peak
    assert torch.allclose(model, torch.tensor(want_m, dtype=torch.float64), atol=1e-15)
    assert torch.allclose(res, torch.tensor(want_r, dtype=torch.float64), atol=1e-15)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 3 * 2 ** -12), 3.0e8])
    got = tf32_round(x).tolist()
    assert got[0] == 1.0 and got[1] == 1 + 2 ** -10  # a tie goes away from 0
    assert got[2] == 1.0 and got[3] == -(1 + 2 ** -10)
    assert abs(got[4] - 3.0e8) <= 3.0e8 * 2 ** -11
    assert TF32.mul(x, x).dtype == torch.float32
