"""Minimal static lint (the image ships no ruff/pyflakes; zero egress).

Checks, per file:
  - syntax (ast.parse)
  - unused imports (module scope and function scope)
  - duplicate top-level definitions
  - `print(` in library code (the package must keep stdout for payload;
    status belongs on stderr — writer/CLI exempt where noted)

Suppress a line with `# noqa`. Exit code 1 on any finding.
"""

from __future__ import annotations

import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ["versatiles_glyphs_tpu", "tests", "scripts", "__graft_entry__.py", "chip_smoke.py"]


def iter_files():
    for t in TARGETS:
        p = os.path.join(ROOT, t)
        if os.path.isfile(p):
            yield p
        else:
            for dirpath, _, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(dirpath, f)


def check_file(path: str) -> list[str]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    rel = os.path.relpath(path, ROOT)
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: syntax error: {e.msg}"]
    noqa = {
        i + 1 for i, line in enumerate(src.splitlines()) if "# noqa" in line
    }
    problems: list[str] = []

    # Unused imports: collect per-scope; usage = any Name/Attribute root.
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            pass  # roots are Names, already collected
    src_has = src.__contains__
    is_init = rel.endswith("__init__.py")
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if node.lineno in noqa or is_init:
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = (alias.asname or alias.name).split(".")[0]
                if name in used:
                    continue
                # __future__ and side-effect imports are fine.
                if isinstance(node, ast.ImportFrom) and node.module == "__future__":
                    continue
                # Referenced only inside a docstring/string (e.g. doctest)?
                if f"{name}." in src or f"{name}(" in src or f"[{name}" in src:
                    continue
                problems.append(f"{rel}:{node.lineno}: unused import {name!r}")

    # Duplicate top-level defs.
    seen: dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name in seen and node.lineno not in noqa:
                problems.append(
                    f"{rel}:{node.lineno}: duplicate definition of "
                    f"{node.name!r} (first at line {seen[node.name]})"
                )
            seen.setdefault(node.name, node.lineno)
    return problems


def main() -> int:
    all_problems: list[str] = []
    n = 0
    for path in iter_files():
        n += 1
        all_problems.extend(check_file(path))
    for p in all_problems:
        print(p)
    print(f"lint: {n} files, {len(all_problems)} problem(s)", file=sys.stderr)
    return 1 if all_problems else 0


if __name__ == "__main__":
    sys.exit(main())
