"""beam_interp's launch layout (ops/cuda_beam.interp_layout, checked by
csrc/beam.cu's beam_interp_launch) replayed in numpy, as the kernel reads
it: block (bx, by) of (parts, rows, lanes) threads builds its row table
(one entry per row, the coordinate column k // per), then thread (x, y, z)
takes row by·rows + y and samples bx·lanes·spt + z + g·lanes, g < spt,
and part x of the values.

Shown here: every (sample, row, part) is written exactly once at ragged
shapes (rows not a multiple of the row tile, samples not a multiple of
the sample group, one row) and at config 3's three layouts; the layout
stays inside the kernel's limits and covers the card's SMs on the small
launches; and a replay of the kernel's arithmetic over the layout, in
float64 and in the kernel's order, equals the plain version.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from africanus_tpu_torch.ops import cuda_beam as cb

BEAM_CU = Path(cb.__file__).resolve().parents[1] / "csrc" / "beam.cu"
# (nsamp, nrows, ncol): ragged shapes, then config 3's three launches
# (512 samples: 4096 channels; 8 slabs on one column; 4 corners x 8 slabs)
RAGGED = [(1000, 300, 300), (37, 5, 5), (3, 1, 1), (1, 7, 7), (515, 33, 33),
          (513, 8, 1), (131, 32, 4), (700, 257, 257)]
CONFIG3 = [(512, 4096, 4096), (512, 8, 1), (512, 32, 4)]
# SMs of an H100 SXM (the card the port is measured on) and of an H100 PCIe
H100_SMS = 132
SMS = [H100_SMS, 114]


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", BEAM_CU.read_text())[1])


def _threads(lay, nsamp, nrows):
    """(s, k, x, valid) of every thread and sample step of a launch, as
    the kernel computes them from blockIdx, threadIdx and the layout."""
    gx, gy = lay.blocks
    bx, by, x, y, z, g = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(lay.parts),
                                     np.arange(lay.rows), np.arange(lay.lanes),
                                     np.arange(lay.spt), indexing="ij")
    k = by * lay.rows + y
    s = bx * lay.lanes * lay.spt + z + g * lay.lanes
    return s, k, x, (k < nrows) & (s < nsamp)


def _row_table(lay, nrows, ncol):
    """Each block's row table: the threads with flat index t < rows write
    entry t (column (k0 + t) // per) for rows that exist; None elsewhere."""
    per = nrows // ncol
    tables = []
    for by in range(lay.blocks[1]):
        x, y, z = np.meshgrid(np.arange(lay.parts), np.arange(lay.rows),
                              np.arange(lay.lanes), indexing="ij")
        t = (x + lay.parts * (y + lay.rows * z)).ravel()
        k0 = by * lay.rows
        writers = t[(t < lay.rows) & (k0 + t < nrows)]
        table = [None] * lay.rows
        for w in writers:
            assert table[w] is None  # one writer an entry
            table[w] = (k0 + w) // per
        tables.append(table)
    return tables


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("nsamp,nrows,ncol", RAGGED + CONFIG3)
def test_every_output_is_written_once(nsamp, nrows, ncol, normalize, sms):
    lay = cb.interp_layout(nsamp, nrows, normalize, sms)
    s, k, x, valid = _threads(lay, nsamp, nrows)
    written = np.bincount(((s * nrows + k) * lay.parts + x)[valid],
                          minlength=nsamp * nrows * lay.parts)
    assert written.shape == (nsamp * nrows * lay.parts,)
    assert (written == 1).all()
    # the row table holds every row a thread reads, with its column
    tables = _row_table(lay, nrows, ncol)
    rows = k[valid] // lay.rows, k[valid] % lay.rows
    cols = np.array([tables[b][r] for b, r in zip(*rows)])
    assert (cols == k[valid] // (nrows // ncol)).all()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("nsamp,nrows", [(n, r) for n, r, _ in RAGGED + CONFIG3]
                         + [(640_000, 4096), (2, 100_000)])
def test_layout_within_the_kernels_limits(nsamp, nrows, normalize, sms):
    """beam_interp_launch refuses a layout beyond INTERP_THREADS threads or
    INTERP_ROWS rows a block, or beyond the grid's limits; the parts are 1
    when normalised, else 3."""
    lay = cb.interp_layout(nsamp, nrows, normalize, sms)
    assert lay.parts == (1 if normalize else 3)
    assert 1 <= lay.rows <= _constant("INTERP_ROWS")
    assert lay.parts * lay.rows * lay.lanes <= _constant("INTERP_THREADS")
    assert lay.lanes >= 1 and 1 <= lay.spt <= cb._MAX_SPT
    gx, gy = lay.blocks
    assert gx == -(-nsamp // (lay.lanes * lay.spt)) and gy == -(-nrows // lay.rows)
    assert gx <= 2**31 - 1 and gy <= 65535


def test_wrapper_limits_match_the_kernel():
    assert cb._INTERP_THREADS == _constant("INTERP_THREADS")


def test_config3_layouts():
    """The general route on an H100: 256 channels a block, a row a thread,
    8 samples a thread, 1024 blocks."""
    gen = cb.interp_layout(512, 4096, True, H100_SMS)
    assert gen == cb.InterpLayout(1, 256, 1, 8, (64, 16))


@pytest.mark.parametrize("sms", SMS + [16, 1])
def test_small_launches_cover_the_sms(sms):
    """Config 3's small launches take at least one block per SM of the
    card (a thread per (sample, row) in blocks of 256 gave them 16 and 64),
    and whole warps while more than one lane is left."""
    for nrows in (8, 32):
        lay = cb.interp_layout(512, nrows, False, sms)
        assert lay.blocks[0] * lay.blocks[1] >= sms
        assert lay.parts * lay.rows * lay.lanes >= 32 or lay.lanes == 1


def _problem(rng, nsamp, ncol, per, ncorr, lw=9, mh=7, nud=5):
    cube = rng.normal(size=(lw, mh, nud, ncorr)) + 1j * rng.normal(size=(lw, mh, nud, ncorr))
    slabs = cb.beam_slabs(torch.as_tensor(cube))
    vl = rng.uniform(0, lw - 1, (nsamp, ncol))
    vm = rng.uniform(0, mh - 1, (nsamp, ncol))
    vl.flat[:3] = [0.0, lw - 1, 4.0][:vl.size]
    vm.flat[:3] = [mh - 1, 0.0, 2.0][:vm.size]
    nrows = ncol * per
    gc0 = rng.integers(-1, nud + 1, nrows).astype(np.int32)  # clamped, as the kernel
    gc1 = np.minimum(gc0 + 1, nud).astype(np.int32)
    wlo = rng.uniform(0, 1, nrows)
    return slabs, *(torch.as_tensor(a) for a in (vl, vm, gc0, gc1, wlo))


def _replay(slabs, vl, vm, gc0, gc1, wlo, normalize):
    """The kernel's arithmetic over its layout, thread by thread and
    sample step by sample step (float64, multiply then add)."""
    sl = slabs.numpy()
    nud, lw, mh, k3 = sl.shape
    ncorr = k3 // 3
    nsamp, ncol = vl.shape
    nrows = gc0.shape[0]
    lay = cb.interp_layout(nsamp, nrows, normalize, H100_SMS)
    kp = k3 if normalize else ncorr
    out = np.full((nsamp, nrows, k3), np.nan)
    s, k, x, valid = _threads(lay, nsamp, nrows)
    s, k, x = s[valid], k[valid], x[valid]
    col = k // (nrows // ncol)
    l, m = vl.numpy()[s, col], vm.numpy()[s, col]
    lf, mf = np.floor(l), np.floor(m)
    ld, md = l - lf, m - mf
    l0 = np.clip(lf.astype(int), 0, lw - 1)
    m0 = np.clip(mf.astype(int), 0, mh - 1)
    l1, m1 = np.minimum(l0 + 1, lw - 1), np.minimum(m0 + 1, mh - 1)
    wa = wlo.numpy()[k]
    q = {(0, 0): (1 - ld) * (1 - md), (0, 1): (1 - ld) * md,
         (1, 0): ld * (1 - md), (1, 1): ld * md}
    lanes = x[:, None] * kp + np.arange(kp)
    acc = None
    for g, w in ((gc0.numpy(), wa), (gc1.numpy(), 1 - wa)):
        slab = np.clip(g[k], 0, nud - 1)
        for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
            li, mi = (l0, l1)[i], (m0, m1)[j]
            term = (w * q[i, j])[:, None] * sl[slab[:, None], li[:, None], mi[:, None], lanes]
            acc = term if acc is None else acc + term
    out[s[:, None], k[:, None], lanes] = acc
    assert not np.isnan(out).any()
    if not normalize:
        return out
    re, im, amp = out[..., :ncorr], out[..., ncorr:2 * ncorr], out[..., 2 * ncorr:]
    div = np.sqrt(re * re + im * im)
    norm = np.where(div == 0, amp, amp / np.where(div == 0, 1.0, div))
    return re * norm + 1j * (im * norm)


@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("nsamp,ncol,per", [(37, 5, 1), (300, 1, 8), (45, 4, 8),
                                            (6, 300, 1)])
def test_replay_of_the_layout_equals_plain(rng, nsamp, ncol, per, ncorr, normalize):
    """The kernel and the plain version round each multiply and add once,
    in one order: the replay's raw sums equal the plain version's bit for
    bit. The normalised values to a few ulps: torch's CPU sqrt is not
    correctly rounded on every input (numpy's and the card's are)."""
    ops = _problem(rng, nsamp, ncol, per, ncorr)
    got = _replay(*ops, normalize)
    want = cb.beam_interp_reference(*ops, normalize).numpy()
    if normalize:
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_cell_corners_are_exact(rng, dtype):
    """The cell-corner layout (four columns, a row per slab) at integer
    coordinates: the plain version returns the corner values bit for bit,
    |v| lanes included, as the cell-residual route needs."""
    slabs = _problem(rng, 1, 1, 1, 4)[0].to(dtype)
    nud, lw, mh, _ = slabs.shape
    nsamp = 40
    li = torch.as_tensor(rng.integers(0, lw, (nsamp, 4)))
    mi = torch.as_tensor(rng.integers(0, mh, (nsamp, 4)))
    rows = torch.arange(nud, dtype=torch.int32).repeat(4)
    raw = cb.beam_interp(slabs, li.to(dtype), mi.to(dtype), rows, rows,
                         torch.ones(4 * nud, dtype=dtype), False)
    want = slabs.permute(1, 2, 0, 3)[li.repeat_interleave(nud, 1),
                                     mi.repeat_interleave(nud, 1), rows]
    assert torch.equal(raw, want)
