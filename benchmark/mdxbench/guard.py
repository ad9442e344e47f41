"""What a run may not load: JAX, its libraries and the JAX package ``mdx``.

Names are compared by their top-level part, the text before the first dot,
whole: ``mdx_torch`` is the program and passes, ``mdx`` and ``mdx.core``
do not.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "mdx")


def loaded(forbidden=FORBIDDEN, modules=None) -> list[str]:
    """Names in ``modules`` (default ``sys.modules``) whose top-level part
    is one of ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in forbidden)


def imported_roots(folder: Path) -> set[str]:
    """Top-level names of every module that the ``.py`` files under
    ``folder`` import (relative imports count as the folder's own)."""
    roots = set()
    for path in Path(folder).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".", 1)[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".", 1)[0])
    return roots
