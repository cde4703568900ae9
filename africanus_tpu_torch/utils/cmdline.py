"""Safe CLI literal parsing (reference ``africanus/util/cmdline.py:15``).

A copy of ``africanus_tpu/utils/cmdline.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import ast
import builtins

__all__ = ["parse_python_assigns"]

_BUILTIN_WHITELIST = frozenset(["slice"])
_missing = _BUILTIN_WHITELIST.difference(dir(builtins))
if _missing:
    raise ValueError(f"'{list(_missing)}' are not permitted builtin callables.")


def parse_python_assigns(assign_str):
    """Parse "a=1; b=[2,3]; s='x'" into {"a": 1, "b": [2, 3], "s": "x"}.

    Values must be python literals or whitelisted builtin calls (slice).
    Tuple-unpacking assignments are supported.
    """
    if not assign_str:
        return {}

    def eval_value(node):
        if isinstance(node, ast.Call):
            func_name = node.func.id
            if func_name not in _BUILTIN_WHITELIST:
                raise ValueError(
                    f"Function '{func_name}' in '{assign_str}' is not "
                    f"builtin. Available builtins: "
                    f"{list(_BUILTIN_WHITELIST)}"
                )
            args = tuple(ast.literal_eval(a) for a in node.args)
            kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
            return getattr(builtins, func_name)(*args, **kwargs)
        return ast.literal_eval(node)

    out = {}
    for i, stmt in enumerate(ast.parse(assign_str, mode="exec").body):
        if not isinstance(stmt, ast.Assign):
            raise ValueError(
                f"Statement {i} in '{assign_str}' is not a variable "
                f"assignment."
            )
        value = eval_value(stmt.value)
        for target in stmt.targets:
            if isinstance(target, ast.Name):
                out[target.id] = value
            elif isinstance(target, (ast.Tuple, ast.List)):
                try:
                    elements = list(value)
                except TypeError:
                    raise ValueError(
                        f"Unpacking non-iterable value {value!r} in "
                        f"'{assign_str}'"
                    )
                if len(target.elts) != len(elements):
                    raise ValueError(
                        f"Unpacking mismatch in '{assign_str}': "
                        f"{len(target.elts)} names, {len(elements)} values"
                    )
                for name, v in zip(target.elts, elements):
                    out[name.id] = v
            else:
                raise TypeError(f"Unhandled assignment target {target}")
    return out
