"""``ops/_build.py``'s table is the one statement of the CUDA kernels' C
interface on the Python side, and ctypes checks none of it: a pointer
typed as an int is cut to 32 bits, and a call with one argument too many
passes it silently. So the table is held here against the ``extern "C"``
declarations of ``csrc/``, parameter by parameter, and the wrappers'
calls against the table: every mismatch shows here, on the CPU, and not
first on the card."""

import ast
import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from africanus_tpu_torch.ops import _build

OPS = Path(_build.__file__).parent
_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
# C scalar type -> the ctypes type that passes it
_SCALARS = {"int": ctypes.c_int, "float": ctypes.c_float, "double": ctypes.c_double,
            "long long": ctypes.c_longlong}


def _ctype(param):
    """The ctypes type that passes a C parameter declaration."""
    if "*" in param:
        return ctypes.c_void_p
    return _SCALARS[" ".join(param.replace("const ", "").split()[:-1])]


def _declared(name):
    """{C function: its parameter declarations, blanks collapsed} of the
    ``extern "C"`` functions in library ``name``'s sources."""
    out = {}
    for src in _build.LIBRARIES[name][0]:
        for fn, params in _DECL.findall((_build.CSRC / src).read_text()):
            out[fn] = [" ".join(p.split()) for p in params.split(",") if p.strip()]
    return out


ENTRIES = [(name, entry) for name, (_, entries) in _build.LIBRARIES.items()
           for entry in entries]


@pytest.mark.parametrize("name,entry", ENTRIES)
def test_entry_types_match_its_declaration(name, entry):
    params = _declared(name).get(f"{entry}_launch")
    assert params is not None, f"{entry}_launch is not in {name}'s sources"
    assert _build.LIBRARIES[name][1][entry] == [_ctype(p) for p in params]
    assert params[-1] == "void* stream"  # last, as launch() appends it


def test_every_source_is_one_librarys():
    owned = [s for sources, _ in _build.LIBRARIES.values() for s in sources]
    assert sorted(owned) == sorted(p.name for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", sorted(_build.LIBRARIES))
def test_every_exported_function_is_bound(name):
    """Each ``extern "C"`` function is a table entry's ``<entry>_launch``
    or the library's ``<name>_init()``, which takes nothing."""
    declared = _declared(name)
    launches = {f"{e}_launch" for e in _build.LIBRARIES[name][1]}
    assert set(declared) - launches <= {f"{name}_init"}
    assert declared.get(f"{name}_init", []) == []


@pytest.mark.parametrize("name", sorted(_build.LIBRARIES))
def test_init_is_run_exactly_where_declared(name):
    """_bind, given a build that exports what the sources declare, types
    every entry from the table and returns the init where, and only
    where, the library declares one."""
    lib = SimpleNamespace(**{fn: SimpleNamespace() for fn in _declared(name)})
    init, fns = _build._bind(name, lib)
    assert sorted(fns) == sorted(_build.LIBRARIES[name][1])
    for entry, fn in fns.items():
        assert fn.argtypes == _build.LIBRARIES[name][1][entry]
        assert fn.restype is ctypes.c_int
    if f"{name}_init" in _declared(name):
        assert init is getattr(lib, f"{name}_init")
        assert (init.argtypes, init.restype) == ([], ctypes.c_int)
    else:
        assert init is None


def _launch_calls():
    """(module, line, entry, arguments after the device, whether any is
    starred) of every ``_build.launch`` call with a literal entry in the
    kernel wrappers."""
    out = []
    for path in sorted(OPS.glob("cuda_*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                first = node.args[0]
                entry = first.value if isinstance(first, ast.Constant) else None
                out.append((path.name, node.lineno, entry, node.args[2:],
                            any(isinstance(a, ast.Starred) for a in node.args)))
    return out


def test_wrappers_launch_table_entries_with_their_arity():
    """Each literal entry a wrapper launches is in the table, and a call
    without starred arguments passes as many as the entry takes before
    the stream (a starred one no more); every entry is launched."""
    calls = _launch_calls()
    named = {entry for _, _, entry, _, _ in calls}
    for module, line, entry, args, starred in calls:
        if entry is None:
            continue
        assert entry in _build._OWNER, f"{module}:{line}: {entry!r} is not in the table"
        want = len(_build.LIBRARIES[_build._OWNER[entry]][1][entry]) - 1
        fixed = sum(not isinstance(a, ast.Starred) for a in args)
        assert (fixed <= want) if starred else (fixed == want), (
            f"{module}:{line}: {entry} takes {want} arguments, the call passes {fixed}")
    # beam_blend and beam_blend_cell are launched by the wrapper's name
    assert set(_build._OWNER) - named <= {"beam_blend", "beam_blend_cell"}
