"""tools/dft_variants.py builds variants of csrc/dft.cu by text
substitution: every text it replaces must stand in the kernels' source,
once, or the variant would time the unchanged kernels (or another line)
under its name; a variant's host settings must be settings that
ops/cuda_dft.py has."""

import importlib.util
from pathlib import Path

import pytest

from africanus_tpu_torch.ops import cuda_dft as cd

ROOT = Path(__file__).resolve().parents[1]
DFT_CU = ROOT / "africanus_tpu_torch" / "csrc" / "dft.cu"


def _tool():
    path = ROOT / "tools" / "dft_variants.py"
    spec = importlib.util.spec_from_file_location("dft_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()


@pytest.mark.parametrize("name", sorted(TOOL.VARIANTS))
def test_port_dft_variant_substitutions_stand_once(name):
    text = DFT_CU.read_text()
    subs, settings = TOOL.VARIANTS[name]
    for old, new in subs:
        assert text.count(old) == 1, f"{name!r}: {old!r}"
        assert new != old
    assert TOOL.variant_source(name, text) != text or not subs
    for key, value in settings.items():
        assert hasattr(cd, key) and getattr(cd, key) != value


def test_port_dft_variant_kernel_is_the_source():
    assert TOOL.VARIANTS["kernel"] == ([], {})
    with pytest.raises(RuntimeError, match="not one"):
        TOOL.variant_source("adjoint at 5 blocks an SM", "no such text")
