"""The work counts against hand counts at a tiny shape, and the least
time's bound."""

from perfbench import peaks
from perfbench.work import dft_adjoint, predict_kb


def test_predict_kb_by_hand():
    ops, nbytes = predict_kb.count(S=2, R=3, F=5, C=4)
    assert ops == 2 * 3 * 5 * 4 * 8
    # delay hi, lo, u', v' per (src, row); freq and its scale per chan;
    # B (src, chan, corr) and V (row, chan, corr) complex64
    assert nbytes == 2 * 3 * 16 + 5 * 8 + 2 * 5 * 4 * 8 + 3 * 5 * 4 * 8


def test_dft_adjoint_by_hand():
    ops, nbytes = dft_adjoint.count(P=4, R=3, F=2, C=1)
    assert ops == 4 * 3 * 2 * 1 * 4
    assert nbytes == 3 * 12 + 4 * 8 + 2 * 4 + 3 * 2 * 9 + 4 * 2 * 4


def test_least_time_takes_the_larger_bound():
    t, which = predict_kb.least_seconds(S=100, R=8064, F=4096, C=4)
    assert which == "bytes"
    assert t == predict_kb.count(100, 8064, 4096, 4)[1] / peaks.HBM_BYTES_PER_S
    t, which = dft_adjoint.least_seconds(P=4096, R=38612, F=16, C=1)
    assert which == "operations"
    assert t == dft_adjoint.count(4096, 38612, 16, 1)[0] / peaks.TF32_FLOPS


def test_kernel_sizes_from_an_entrys_problem_sizes():
    flagship = {"sources": 100, "rows": 8064, "chan": 4096, "corr": 4}
    selfcal = {"sources": 20, "rows": 38612, "chan": 16, "corr": 2,
               "pixels": 4096, "image_corr": 1}
    assert predict_kb.shape(flagship) == dict(S=100, R=8064, F=4096, C=4)
    assert dft_adjoint.shape(flagship) is None
    assert dft_adjoint.shape(selfcal) == dict(P=4096, R=38612, F=16, C=1)
