"""The check that no JAX and no module of the JAX package is loaded.

Top-level module names are compared whole: the measured package's name
begins with the JAX package's, and is allowed."""

from __future__ import annotations

import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "this_and_that_vdm_tpu")
PROGRAM = "this_and_that_vdm_tpu_torch"


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def reference_imports(root: Path = Path(__file__).resolve().parent / "reference") -> list:
    """``(file, line)`` of every import in ``reference/`` of the measured
    program or of a forbidden package."""
    import ast

    bad = []
    for path in sorted(root.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            if any(n.split(".")[0] in FORBIDDEN + (PROGRAM,) for n in names):
                bad.append((path.name, node.lineno))
    return bad


def check(where: str) -> None:
    """Exit with code 3 and name what was found if a forbidden module is
    loaded or the reference imports the program."""
    found = loaded_forbidden()
    bad = reference_imports()
    if found or bad:
        print(f"import guard ({where}): forbidden modules loaded {found}; "
              f"reference imports of the program {bad}", file=sys.stderr)
        raise SystemExit(3)
