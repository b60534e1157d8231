"""repro-lint engine: AST rule runner + per-line suppression parsing.

The engine is deliberately small and dependency-free (stdlib only — pinned
by the third-party-free subprocess test in tests/test_analysis.py): it walks
Python files, parses each one once, annotates the tree with parent links,
and hands a :class:`FileContext` to every rule whose module scope matches.
Rules yield :class:`Finding`s; the engine filters them through per-line
suppressions and aggregates per-rule wall time (surfaced by
``benchmarks/bench_analysis.py`` so the full-tree lint stays fast).

Suppression syntax
------------------
A finding is silenced by a comment **on the finding's line** or **on its own
line directly above** the offending statement::

    self._sock = None  # repro-lint: disable=lock-mutation -- close() is the
                       #   owner's last call; no reader can race it

    # repro-lint: disable=lock-blocking -- one in-flight request per
    # connection by design; the lock *is* the request pipeline
    line = self._rfile.readline()

The trailing ``-- reason`` is **required**: a suppression without a reason
(or naming an unknown rule) is itself a finding (``bad-suppression``).  This
is the enforcement half of the repo's measurement-hygiene contracts: every
deliberate exception to an invariant is visible, named, and justified
in-line, instead of living in a reviewer's memory.

Comments are found with :mod:`tokenize`, so the marker inside a string
literal (like the ones in this docstring) is never mistaken for a
suppression.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import time
import tokenize
from typing import Iterable, Iterator, Sequence

#: pseudo-rules the engine itself can emit (reported like rule findings)
ENGINE_RULES = ("parse-error", "bad-suppression")


# --------------------------------------------------------------------- data
@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    module: str = ""

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)


@dataclasses.dataclass(frozen=True)
class Suppression:
    """A parsed ``# repro-lint: disable=...`` comment."""

    target_line: int  #: findings on this line are silenced
    rules: tuple[str, ...]
    reason: str
    comment_line: int


@dataclasses.dataclass
class FileReport:
    """Lint outcome for one file."""

    path: str
    module: str
    findings: list[Finding]
    suppressed: int = 0


@dataclasses.dataclass
class LintResult:
    """Aggregated outcome over a set of paths."""

    findings: list[Finding]
    files: int
    suppressed: int
    elapsed_s: float
    rule_seconds: dict[str, float]

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


# ------------------------------------------------------------- suppressions
_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
    r"\s*(?:--\s*(.*))?$"
)
_MARKER_RE = re.compile(r"#\s*repro-lint:")


def parse_suppressions(
    source: str, known_rules: frozenset[str]
) -> tuple[dict[int, list[Suppression]], list[tuple[int, str]]]:
    """Extract suppressions from real comments (via tokenize).

    Returns ``(by_target_line, malformed)`` where malformed entries are
    ``(line, message)`` pairs destined to become ``bad-suppression`` findings.
    A suppression on a comment-only line applies to the next code line, so a
    reason can span continuation comment lines above the statement.
    """
    by_line: dict[int, list[Suppression]] = {}
    malformed: list[tuple[int, str]] = []
    lines = source.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return by_line, malformed  # the parse-error finding covers it
    for tok in tokens:
        if tok.type != tokenize.COMMENT or not _MARKER_RE.search(tok.string):
            continue
        comment_line = tok.start[0]
        m = _SUPPRESS_RE.search(tok.string)
        if m is None:
            malformed.append(
                (comment_line,
                 "malformed repro-lint comment: expected "
                 "'# repro-lint: disable=<rule>[,<rule>...] -- <reason>'")
            )
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        unknown = [r for r in rules if r not in known_rules]
        if unknown:
            malformed.append(
                (comment_line,
                 f"suppression names unknown rule(s) {', '.join(unknown)}")
            )
            continue
        if not reason:
            malformed.append(
                (comment_line,
                 f"suppression of {', '.join(rules)} is missing the required "
                 "'-- <reason>' justification")
            )
            continue
        standalone = tok.line[: tok.start[1]].strip() == ""
        target = comment_line
        if standalone:
            # Comment-only line: silence the next code line (skipping blanks
            # and further comment lines, so multi-line reasons compose).
            for ln in range(comment_line + 1, len(lines) + 1):
                text = lines[ln - 1].strip()
                if text and not text.startswith("#"):
                    target = ln
                    break
        by_line.setdefault(target, []).append(
            Suppression(target, rules, reason, comment_line)
        )
    return by_line, malformed


# ------------------------------------------------------------ AST utilities
def attach_parents(tree: ast.AST) -> ast.AST:
    """Annotate every node with a ``_pr_parent`` backlink (rules need scope)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._pr_parent = node  # type: ignore[attr-defined]
    return tree


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_pr_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_pr_parent", None)


def in_function(node: ast.AST) -> bool:
    """True when the node executes inside a function/lambda body (lazy code)."""
    return any(
        isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for a in ancestors(node)
    )


def in_type_checking(node: ast.AST) -> bool:
    """True inside an ``if TYPE_CHECKING:`` block (never executed at runtime)."""
    for a in ancestors(node):
        if isinstance(a, ast.If):
            test = a.test
            if isinstance(test, ast.Name) and test.id == "TYPE_CHECKING":
                return True
            if isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING":
                return True
    return False


def dotted_name(expr: ast.AST) -> str | None:
    """``Name``/``Attribute`` chains as a dotted string; None otherwise."""
    parts: list[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    """Dotted name of a call's target (``np.random.seed`` -> that string)."""
    return dotted_name(node.func)


# ----------------------------------------------------------------- context
class FileContext:
    """Everything a rule needs about one file: tree, lines, module, helpers."""

    def __init__(self, path: str, source: str, module: str, tree: ast.AST) -> None:
        self.path = path
        self.source = source
        self.module = module
        self.tree = tree
        self.lines = source.splitlines()

    def finding(self, rule: str, node, message: str) -> Finding:
        if isinstance(node, int):
            line, col = node, 0
        else:
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
        return Finding(
            rule=rule, path=self.path, line=line, col=col,
            message=message, module=self.module,
        )


# -------------------------------------------------------------------- rules
class Rule:
    """Base class: subclass, set ``name``/``description``/``scope``, register."""

    name: str = ""
    description: str = ""
    #: module-name prefixes this rule applies to; empty = every module
    scope: tuple[str, ...] = ()

    def applies(self, module: str) -> bool:
        if not self.scope:
            return True
        return any(
            module == p or module.startswith(p + ".") for p in self.scope
        )

    def check(self, ctx: FileContext) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


#: rule registry: name -> singleton instance
RULES: dict[str, Rule] = {}


def register(cls: type[Rule]) -> type[Rule]:
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    if cls.name in RULES:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    RULES[cls.name] = cls()
    return cls


def all_rules() -> list[Rule]:
    """Every registered rule, loading the built-in rule modules on first use."""
    from repro_torch.analysis import locks, rules  # noqa: F401  (registration side effect)

    return [RULES[name] for name in sorted(RULES)]


def known_rule_names() -> frozenset[str]:
    all_rules()
    return frozenset(RULES) | frozenset(ENGINE_RULES)


# ------------------------------------------------------------------ linting
def module_name_for(path: str) -> str:
    """Dotted module name for a file path (``src/repro/core/x.py`` -> ``repro_torch.core.x``)."""
    norm = os.path.normpath(path).replace(os.sep, "/")
    parts = [p for p in norm.split("/") if p]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    # The port's files name the port's modules; the reference's keep theirs.
    root = next((name for name in ("repro_torch", "repro") if name in parts), None)
    if root is not None:
        parts = parts[parts.index(root):]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) if parts else "<unknown>"


def lint_source(
    source: str,
    path: str = "<string>",
    module: str | None = None,
    rules: Sequence[Rule] | None = None,
    rule_seconds: dict[str, float] | None = None,
) -> FileReport:
    """Lint one source string; the unit every test fixture goes through."""
    if module is None:
        module = module_name_for(path)
    if rules is None:
        rules = all_rules()
    report = FileReport(path=path, module=module, findings=[])
    try:
        tree = ast.parse(source)
    except (SyntaxError, ValueError) as exc:
        line = getattr(exc, "lineno", 1) or 1
        report.findings.append(
            Finding("parse-error", path, line, 0, f"file does not parse: {exc}", module)
        )
        return report
    attach_parents(tree)
    ctx = FileContext(path, source, module, tree)
    suppressions, malformed = parse_suppressions(source, known_rule_names())
    raw: list[Finding] = []
    for rule in rules:
        if not rule.applies(module):
            continue
        t0 = time.perf_counter()
        raw.extend(rule.check(ctx))
        if rule_seconds is not None:
            rule_seconds[rule.name] = (
                rule_seconds.get(rule.name, 0.0) + time.perf_counter() - t0
            )
    for line, message in malformed:
        raw.append(ctx.finding("bad-suppression", line, message))
    for f in raw:
        silenced = any(
            f.rule in s.rules for s in suppressions.get(f.line, ())
        )
        if silenced:
            report.suppressed += 1
        else:
            report.findings.append(f)
    report.findings.sort(key=Finding.sort_key)
    return report


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    """Yield .py files under the given files/directories (skips __pycache__)."""
    for root in paths:
        if os.path.isfile(root):
            if root.endswith(".py"):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(
                d for d in dirnames
                if d != "__pycache__" and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def lint_paths(
    paths: Sequence[str],
    rules: Sequence[Rule] | None = None,
) -> LintResult:
    """Lint every Python file under ``paths``; the CLI/bench/CI entry point."""
    if rules is None:
        rules = all_rules()
    t0 = time.perf_counter()
    findings: list[Finding] = []
    suppressed = 0
    files = 0
    rule_seconds: dict[str, float] = {}
    for path in iter_python_files(paths):
        files += 1
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except (OSError, UnicodeDecodeError) as exc:
            findings.append(
                Finding("parse-error", path, 1, 0, f"unreadable file: {exc}",
                        module_name_for(path))
            )
            continue
        report = lint_source(
            source, path=path, rules=rules, rule_seconds=rule_seconds
        )
        findings.extend(report.findings)
        suppressed += report.suppressed
    findings.sort(key=Finding.sort_key)
    return LintResult(
        findings=findings,
        files=files,
        suppressed=suppressed,
        elapsed_s=time.perf_counter() - t0,
        rule_seconds=rule_seconds,
    )
