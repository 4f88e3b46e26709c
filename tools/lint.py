"""Zero-dependency lint gate (stdlib ``ast`` only).

The reference enforces a hygiene tier through pre-commit (checkpatch,
codespell, black, flake8, mypy — /root/reference/.pre-commit-config.yaml)
that this environment cannot pip-install.  This linter provides the
highest-value subset with no dependencies, so the gate actually RUNS both
locally (``python tools/lint.py``, also wired as a pytest in
tests/test_lint.py) and in CI; ruff + mypy run as additional BLOCKING CI
steps where pip is available (.github/workflows/ci.yml) — the checks here
mirror the enforced ruff rule families so the zero-dep gate predicts the
CI gate.

Checks (suppress one line with ``# noqa``):
  * syntax (ast.parse)                                  [ruff E9]
  * unused imports (module scope, ``__all__``-aware)    [ruff F401]
  * bare ``except:`` clauses                            [ruff E722]
  * mutable default arguments (list/dict/set literals)  [ruff B006-like]
  * tabs in indentation, trailing whitespace            [ruff W19x/W29x]
  * lines over 100 columns                              [ruff line-length]
  * multiple imports on one line                        [ruff E401]
  * module import not at file top (entry points exempt) [ruff E402]
  * compound single-line statements and semicolons      [ruff E701/E702]
  * ``== None`` / ``== True`` / ``== False``            [ruff E711/E712]
  * ``not x in y`` / ``not x is y``                     [ruff E713/E714]
  * duplicate same-scope def/class names                [ruff F811]
  * unused local single-target assignments              [ruff F841]
  * loads of names never bound anywhere in the module   [ruff F821-ish]
"""

from __future__ import annotations

import ast
import builtins
import io
import pathlib
import re
import sys
import tokenize

MAX_COLS = 100

# Files whose top-of-file sys.path / environment setup legitimately
# precedes the package imports (kept in sync with the ruff
# per-file-ignores for E402 in pyproject.toml).
E402_EXEMPT = ("bench.py", "chip_smoke.py", "__graft_entry__.py", "tools/",
               "tests/", "examples/")

# ruff's default dummy-variable pattern: underscore-led locals are
# intentionally unused
DUMMY_RE = re.compile(r"^(_+|(_+[a-zA-Z0-9_]*[a-zA-Z0-9]+?))$")

BUILTIN_NAMES = set(dir(builtins)) | {
    "__file__", "__name__", "__doc__", "__spec__", "__builtins__",
    "__package__", "__path__", "__debug__", "__class__"}

REPO = pathlib.Path(__file__).resolve().parents[1]
TARGETS = [
    "airs_compression_tpu",
    "tests",
    "tools",
    "examples",
    "bench.py",
    "chip_smoke.py",
    "__graft_entry__.py",
]


def _used_names(tree: ast.AST) -> set[str]:
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            # attribute roots count (module.attr uses "module")
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    # names exported via __all__ strings count as used
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            for el in ast.walk(node.value):
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    used.add(el.value)
    return used


def _import_bindings(tree: ast.Module):
    """ALL import bindings (module + function scope) -> (name, lineno).

    Usage is checked against the whole module's name references, so a
    name imported in one function but used in another is (incorrectly)
    considered used — no false positives, at the cost of missing that
    case.  Fully dead imports anywhere are caught (found by review: a
    function-level import survived the original module-scope-only
    check).
    """
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                out.append((name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                out.append((a.asname or a.name, node.lineno))
    return out


def lint_file(path: pathlib.Path) -> list[str]:
    src = path.read_text()
    rel = path.relative_to(REPO)
    problems: list[str] = []
    lines = src.splitlines()
    noqa = {i + 1 for i, ln in enumerate(lines) if "# noqa" in ln}

    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [f"{rel}:{e.lineno}: syntax error: {e.msg}"]

    for i, ln in enumerate(lines, 1):
        if i in noqa:
            continue
        stripped = ln.rstrip("\n")
        if stripped != stripped.rstrip():
            problems.append(f"{rel}:{i}: trailing whitespace")
        if "\t" in stripped[: len(stripped) - len(stripped.lstrip())]:
            problems.append(f"{rel}:{i}: tab in indentation")
        if len(stripped) > MAX_COLS:
            problems.append(f"{rel}:{i}: line longer than {MAX_COLS} cols "
                            f"({len(stripped)})")

    used = _used_names(tree)
    for name, lineno in _import_bindings(tree):
        if lineno in noqa:
            continue
        if name not in used:
            problems.append(f"{rel}:{lineno}: unused import '{name}'")

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if node.lineno not in noqa:
                problems.append(f"{rel}:{node.lineno}: bare 'except:'")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    if d.lineno not in noqa:
                        problems.append(
                            f"{rel}:{d.lineno}: mutable default argument")
    problems += _ruff_mirror_checks(tree, src, rel, noqa)
    return problems


def _isbool(n: ast.AST) -> bool:
    return isinstance(n, ast.Constant) and isinstance(n.value, bool)


def _isnone(n: ast.AST) -> bool:
    return isinstance(n, ast.Constant) and n.value is None


def _ruff_mirror_checks(tree: ast.Module, src: str, rel, noqa) -> list[str]:
    """Local mirrors of the ruff rule families CI enforces blocking."""
    out: list[str] = []

    def add(lineno: int, msg: str) -> None:
        if lineno not in noqa:
            out.append(f"{rel}:{lineno}: {msg}")

    # E402: module-level import after executable statements
    exempt = any(str(rel).startswith(p) or str(rel) == p
                 for p in E402_EXEMPT)
    if not exempt:
        seen_code = False
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                if seen_code:
                    add(node.lineno, "E402 import not at top of file")
            elif isinstance(node, ast.Expr) and isinstance(
                    node.value, ast.Constant):
                continue  # docstring
            elif isinstance(node, (ast.If, ast.Try)):
                seen_code = True  # conservative, like ruff
            else:
                seen_code = True

    for node in ast.walk(tree):
        # E401
        if isinstance(node, ast.Import) and len(node.names) > 1:
            add(node.lineno, "E401 multiple imports on one line")
        # E711 / E712
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            for op, left, right in zip(node.ops, sides[:-1], sides[1:]):
                if isinstance(op, (ast.Eq, ast.NotEq)):
                    if _isnone(left) or _isnone(right):
                        add(node.lineno, "E711 comparison to None")
                    if _isbool(left) or _isbool(right):
                        add(node.lineno, "E712 comparison to True/False")
        # E713 / E714
        if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not)
                and isinstance(node.operand, ast.Compare)
                and len(node.operand.ops) == 1):
            if isinstance(node.operand.ops[0], ast.In):
                add(node.lineno, "E713 'not x in y' (use 'not in')")
            if isinstance(node.operand.ops[0], ast.Is):
                add(node.lineno, "E714 'not x is y' (use 'is not')")
        # E701
        if isinstance(node, (ast.If, ast.For, ast.While, ast.With)) \
                and node.body and node.body[0].lineno == node.lineno:
            add(node.lineno, "E701 compound statement on one line")
        # F811: duplicate def/class in the same immediate scope
        if isinstance(node, (ast.Module, ast.ClassDef)):
            seen: dict[str, int] = {}
            for child in node.body:
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    if child.name in seen:
                        add(child.lineno,
                            f"F811 redefinition of '{child.name}'")
                    seen[child.name] = child.lineno
        # F841: single-target local assign never loaded in the function.
        # Loads anywhere inside (incl. closures) count; assignments are
        # only this function's own statements — nested defs/classes are
        # their own scopes (a class body attribute is not a local).
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            loads = {n.id for n in ast.walk(node)
                     if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Load)}

            def own_stmts(fn):
                stack = list(fn.body)
                while stack:
                    s = stack.pop()
                    yield s
                    if not isinstance(s, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef, ast.Lambda)):
                        stack.extend(ast.iter_child_nodes(s))

            for n in own_stmts(node):
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)):
                    name = n.targets[0].id
                    if name not in loads and not DUMMY_RE.match(name):
                        add(n.lineno, f"F841 unused local '{name}'")

    # E702: statement-separating semicolons
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.OP and tok.string == ";":
                add(tok.start[0], "E702 semicolon-separated statements")
    except tokenize.TokenError:
        pass

    # coarse F821: a Load of a name never bound ANYWHERE in the module
    # (over-approximates scoping, so it only catches outright typos —
    # exactly the zero-false-positive subset worth gating on)
    bound: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                     (ast.Store, ast.Del)):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                bound.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                bound.add(a.asname or a.name)
        elif isinstance(node, ast.arg):
            bound.add(node.arg)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            bound.add(node.name)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            bound.update(node.names)
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            if node.id not in bound and node.id not in BUILTIN_NAMES:
                add(node.lineno, f"F821 undefined name '{node.id}'")
    return out


def main() -> int:
    files: list[pathlib.Path] = []
    for t in TARGETS:
        p = REPO / t
        if p.is_dir():
            files += sorted(p.rglob("*.py"))
        elif p.exists():
            files.append(p)
    problems = []
    for f in files:
        if "__pycache__" in f.parts:
            continue
        problems += lint_file(f)
    for p in problems:
        print(p)
    print(f"lint: {len(files)} files, {len(problems)} problems",
          file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
