"""tools/beam_interp_variants.py builds variants of csrc/beam.cu by text
substitution: every text it replaces must stand in the kernel's source,
once, or the variant would time the unchanged kernel (or another line)
under its name."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BEAM_CU = ROOT / "africanus_tpu_torch" / "csrc" / "beam.cu"


def _tool():
    path = ROOT / "tools" / "beam_interp_variants.py"
    spec = importlib.util.spec_from_file_location("beam_interp_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VARIANTS = _tool().VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_each_substitution_finds_its_text_once(name):
    text = BEAM_CU.read_text()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, f"{name!r}: {old!r}"
        assert new != old


def test_the_kernel_variant_is_the_source():
    assert VARIANTS["kernel"] == []
