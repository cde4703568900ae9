"""The port's plot-filter and plot-taper scripts
(``africanus_tpu_torch/scripts``) against the JAX package's: the same
arguments draw the same data (each figure's lines and image equal the
JAX script's, bit for bit) and write the image file. They need
matplotlib, which the card's machine does not have: skipped without it.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest

REPO = __file__.rsplit("/tests/", 1)[0]


def _figure_data(module, argv):
    """The data of the figure ``module.main(argv)`` draws."""
    plt = pytest.importorskip("matplotlib.pyplot")
    plt.close("all")
    assert importlib.import_module(module).main(argv) == 0
    fig = plt.gcf()
    data = []
    for ax in fig.axes:
        data += [np.asarray(ln.get_ydata()) for ln in ax.lines]
        data += [np.asarray(im.get_array()) for im in ax.images]
    plt.close("all")
    return data


@pytest.mark.parametrize("script,argv", [
    ("plot_filter", ["-k", "kbsinc", "-w", "7", "-o", "15"]),
    ("plot_filter", ["-k", "hanningsinc", "-w", "5", "-o", "9"]),
    ("plot_taper", ["-k", "sinc", "-w", "7", "-o", "15", "-n", "32"]),
])
def test_port_script_draws_the_jax_scripts_data(tmp_path, script, argv):
    pytest.importorskip("matplotlib")
    out = tmp_path / "port.png"
    got = _figure_data(f"africanus_tpu_torch.scripts.{script}",
                       argv + ["--output", str(out)])
    want = _figure_data(f"africanus_tpu.scripts.{script}",
                        argv + ["--output", str(tmp_path / "jax.png")])
    assert out.stat().st_size > 0
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_port_script_runs_as_a_module(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "taper.png"
    run = subprocess.run(
        [sys.executable, "-m", "africanus_tpu_torch.scripts.plot_taper", "-n",
         "16", "--output", str(out)], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert f"wrote {out}" in run.stdout and out.stat().st_size > 0
