"""AST-based repo lint for deep-copy discipline (DC2xx) — DESIGN.md §13.3.

Counterpart of ``repro/analysis/lint.py`` for torch sources: the same
rules, pragma grammar and entry points.  It walks python sources (default:
``src/repro_torch``) and flags the transfer-layer mistakes a reviewer
otherwise has to spot by eye:

  DC201  a raw transfer or sync primitive outside the engine / scheme /
         driver layer: ``torch.cuda.synchronize`` or any ``.synchronize()``
         (a stream, an event), a call with ``non_blocking=True``,
         ``.cuda()``, ``.pin_memory()`` or a ``pin_memory=`` that is not
         False, and ``.to()`` with a ``"cuda..."`` literal or a ``device=``
         keyword (a plain ``.to(dtype)`` is not one).  Every other module
         moves bytes through a :class:`TransferProgram` so the motion is
         ledgered and the one-sync discipline holds
  DC202  a fault-point string literal that is not in ``faultpoints.POINTS``
  DC203  a transfer-spec / policy string literal that does not parse
  DC204  an in-place write into an arena staging buffer
         (``entry.staging[...]`` / ``shard_views`` views) in a function
         that never calls ``mark_dirty`` / ``bump_version`` — the delta
         tracker would ship stale bytes

A site is waived with a pragma on its own line or the line above::

    torch.cuda.synchronize(dev)  # lint: allow=DC201 -- <why>

``python -m repro_torch.analysis.lint --strict`` exits non-zero on
findings.
"""
from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set

from ..faultpoints import POINTS
from .diagnostics import Diagnostic

REPO_ROOT = Path(__file__).resolve().parents[3]

# the engine layer: the only files allowed to touch torch's raw transfer /
# sync primitives (DC201), the counterpart of the reference's five, plus
# the device module's one sync helper.  Paths are relative to the repo root.
RAW_CALL_ALLOWLIST = frozenset({
    "src/repro_torch/core/engine.py",
    "src/repro_torch/core/schemes.py",
    "src/repro_torch/core/policy.py",
    "src/repro_torch/core/deepcopy.py",
    "src/repro_torch/scenarios/driver.py",
    "src/repro_torch/_device.py",
})

_POINTS = frozenset(POINTS)
_TRIP_FUNCS = frozenset({"trip", "_trip"})
_SPEC_PARSERS = frozenset({"TransferSpec"})
_POLICY_PARSERS = frozenset({"TransferPolicy"})
_POLICY_KWARGS = frozenset({"declared_policy"})
DEFAULT_ROOTS = ("src/repro_torch",)


def _attr_chain(node: ast.AST) -> List[str]:
    """``a.b.c`` -> ["a", "b", "c"]; empty when the base isn't a Name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_const(node: ast.AST, *values) -> bool:
    return isinstance(node, ast.Constant) and any(
        node.value is v for v in values)


def _raw_primitive(node: ast.Call) -> Optional[str]:
    """The DC201 primitive this call is, named as it reads, or None."""
    method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
    if method == "synchronize":
        return ".".join(_attr_chain(node.func)) or ".synchronize()"
    if method == "cuda":
        return ".cuda()"
    if method == "pin_memory":
        return ".pin_memory()"
    for kw in node.keywords:
        if kw.arg == "non_blocking" and not _is_const(kw.value, False, None):
            return "non_blocking=True"
        if kw.arg == "pin_memory" and not _is_const(kw.value, False, None):
            return "pin_memory=True"
    if method == "to":
        if any((_str_const(a) or "").startswith("cuda") for a in node.args):
            return '.to("cuda...")'
        if any(kw.arg == "device" for kw in node.keywords):
            return ".to(device=)"
    return None


class _Waivers:
    """``# lint: allow=DC201[,DC204]`` pragmas, effective on their own
    line and the line below (so a pragma can sit above a long call)."""

    def __init__(self, source: str):
        self._by_line: dict[int, Set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            marker = line.find("# lint: allow=")
            if marker < 0:
                continue
            codes = {c.strip() for c in
                     line[marker + len("# lint: allow="):]
                     .split("--")[0].split(",")}
            self._by_line[i] = codes
        self.unused = {i: set(c) for i, c in self._by_line.items()}

    def waived(self, line: int, code: str) -> bool:
        for src in (line, line - 1):
            codes = self._by_line.get(src)
            if codes and (code in codes or "*" in codes):
                self.unused.get(src, set()).discard(code)
                self.unused.get(src, set()).discard("*")
                return True
        return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, waivers: _Waivers):
        self.rel = rel
        self.waivers = waivers
        self.diags: List[Diagnostic] = []
        # functions enclosing the current node, innermost last; each entry
        # tracks whether that function body calls mark_dirty/bump_version
        # and the staging writes seen so far (for DC204).
        self._func_stack: List[dict] = []

    def _emit(self, code: str, line: int, message: str) -> None:
        if not self.waivers.waived(line, code):
            self.diags.append(
                Diagnostic(code, message, where=f"{self.rel}:{line}"))

    # -- function scope tracking (DC204) ---------------------------------
    def _visit_func(self, node) -> None:
        frame = {"has_dirty_call": False, "writes": []}
        self._func_stack.append(frame)
        self.generic_visit(node)
        self._func_stack.pop()
        if not frame["has_dirty_call"]:
            for line, target in frame["writes"]:
                self._emit(
                    "DC204", line,
                    f"in-place write to arena staging ({target}) in "
                    f"{node.name!r} without a reachable "
                    f"mark_dirty/bump_version call; the delta tracker "
                    f"will ship stale bytes")

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _note_staging_write(self, target: ast.AST, line: int) -> None:
        node = target
        while isinstance(node, (ast.Subscript, ast.Attribute, ast.Call)):
            if isinstance(node, ast.Attribute) \
                    and node.attr in ("staging", "shard_views"):
                if self._func_stack:
                    self._func_stack[-1]["writes"].append(
                        (line, ".".join(_attr_chain(node)) or node.attr))
                else:
                    self._emit(
                        "DC204", line,
                        f"module-level in-place write to arena staging "
                        f"without mark_dirty/bump_version")
                return
            node = node.func if isinstance(node, ast.Call) else node.value

    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                self._note_staging_write(target, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if isinstance(node.target, ast.Subscript):
            self._note_staging_write(node.target, node.lineno)
        self.generic_visit(node)

    # -- calls (DC201/DC202/DC203, dirty-call tracking) ------------------
    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        name = chain[-1] if chain else ""

        if name in ("mark_dirty", "bump_version") and self._func_stack:
            self._func_stack[-1]["has_dirty_call"] = True

        primitive = _raw_primitive(node)
        if primitive is not None and self.rel not in RAW_CALL_ALLOWLIST:
            self._emit(
                "DC201", node.lineno,
                f"raw {primitive} outside the engine layer; route the "
                f"transfer through a TransferProgram (or waive with "
                f"'# lint: allow=DC201 -- <why>')")

        if name in _TRIP_FUNCS and node.args:
            lit = _str_const(node.args[0])
            if lit is not None and lit not in _POINTS:
                self._emit(
                    "DC202", node.lineno,
                    f"unknown fault point {lit!r}; known points: "
                    f"{', '.join(POINTS)}")
        for kw in node.keywords:
            if kw.arg == "point":
                lit = _str_const(kw.value)
                if lit is not None and lit not in _POINTS:
                    self._emit(
                        "DC202", node.lineno,
                        f"unknown fault point {lit!r}; known points: "
                        f"{', '.join(POINTS)}")

        self._check_spec_literals(node, chain, name)
        self.generic_visit(node)

    def _check_spec_literals(self, node: ast.Call, chain: List[str],
                             name: str) -> None:
        owner = chain[-2] if len(chain) >= 2 else ""
        lit = _str_const(node.args[0]) if node.args else None
        if lit is not None:
            if name == "parse" and owner in _SPEC_PARSERS:
                self._parse_as(lit, node.lineno, policy=False)
            elif name == "parse" and owner in _POLICY_PARSERS:
                self._parse_as(lit, node.lineno, policy=True)
            elif name == "of" and owner in _POLICY_PARSERS:
                self._parse_as(lit, node.lineno, policy=False)
        for kw in node.keywords:
            klit = _str_const(kw.value)
            if klit is not None and kw.arg in _POLICY_KWARGS:
                self._parse_as(klit, node.lineno, policy=True)

    def _parse_as(self, text: str, line: int, *, policy: bool) -> None:
        from ..core.policy import TransferPolicy
        from ..core.spec import TransferSpec

        try:
            if policy:
                TransferPolicy.parse(text)
            else:
                TransferSpec.parse(text)
        except Exception as e:
            self._emit(
                "DC203", line,
                f"{'policy' if policy else 'spec'} literal {text!r} does "
                f"not parse: {e}")


def lint_source(source: str, rel: str) -> List[Diagnostic]:
    """Lint one file's source text (``rel`` is the repo-relative path used
    for the allowlist and in diagnostics)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Diagnostic("DC203", f"file does not parse: {e}",
                           where=f"{rel}:{e.lineno or 0}")]
    visitor = _Visitor(rel, _Waivers(source))
    visitor.visit(tree)
    visitor.diags.sort(key=lambda d: (d.where or "", d.code))
    return visitor.diags


def lint_paths(paths: Iterable[Path],
               root: Optional[Path] = None) -> List[Diagnostic]:
    """Lint files and directories (recursing into ``*.py``)."""
    root = root or REPO_ROOT
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out: List[Diagnostic] = []
    for f in files:
        try:
            rel = str(f.resolve().relative_to(root))
        except ValueError:
            rel = str(f)
        out.extend(lint_source(f.read_text(), rel))
    return out


def lint_repo(root: Optional[Path] = None) -> List[Diagnostic]:
    """Lint the default roots (``src/repro_torch``)."""
    root = root or REPO_ROOT
    return lint_paths([root / r for r in DEFAULT_ROOTS
                       if (root / r).exists()], root=root)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="DC2xx deep-copy lint over the port's sources.")
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {DEFAULT_ROOTS})")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any finding survives")
    args = ap.parse_args(argv)

    diags = (lint_paths([Path(p) for p in args.paths])
             if args.paths else lint_repo())
    for d in diags:
        print(d)
    print(f"{len(diags)} finding(s)")
    return 1 if (diags and args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
