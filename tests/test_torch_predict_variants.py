"""tools/predict_kb_variants.py builds variants of csrc/predict_kb.cu by
text substitution: a variant whose text does not stand once in the
source must not be built, or it would time the unchanged kernel (or
another line) under its name. Checked on texts made here, so that an
edit of the kernel's lines costs no test (the tool raises on the card)."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    path = ROOT / "tools" / "predict_kb_variants.py"
    spec = importlib.util.spec_from_file_location("predict_kb_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _tool()
VARIANTS = TOOL.VARIANTS


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_port_predict_variant_finds_its_text_once(name):
    olds = [old for old, _ in VARIANTS[name]]
    text = "// head\n" + "// between\n".join(olds) + "// tail\n"
    got = TOOL.variant_source(name, text)
    for old, new in VARIANTS[name]:
        assert new != old and new in got
    for old in olds:
        with pytest.raises(RuntimeError, match="has not one"):
            TOOL.variant_source(name, text.replace(old, ""))
        with pytest.raises(RuntimeError, match="has not one"):
            TOOL.variant_source(name, text + old)


def test_port_predict_kernel_variant_is_the_source():
    assert VARIANTS["kernel"] == []
    assert TOOL.variant_source("kernel", "any text") == "any text"
