"""``python -m repro_torch.analysis`` — the repro-lint command line.

Exit status: 0 when no unsuppressed findings, 1 when there are findings,
2 on usage errors.  This is the CI gate (`.github/workflows/ci.yml`), the
``make lint`` target and ``scripts/lint.sh``, so keep the interface stable.
"""

from __future__ import annotations

import argparse
import sys
from typing import Sequence

from repro_torch.analysis.engine import all_rules, lint_paths
from repro_torch.analysis.reporters import render_json, render_text


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "repro-lint: statically enforce the repo's measurement-hygiene "
            "invariants (lazy jax imports, RNG discipline, float "
            "determinism, spawn-spec picklability, merge order, "
            "zero-overhead spans, lock discipline)"
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["src"],
        help="files or directories to lint (default: src)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format (json is the CI-gate schema)",
    )
    parser.add_argument(
        "--select", metavar="RULES",
        help="comma-separated rule names to run (default: all)",
    )
    parser.add_argument(
        "--ignore", metavar="RULES",
        help="comma-separated rule names to skip",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--statistics", action="store_true",
        help="append per-rule finding counts to the text report",
    )
    return parser


def main(argv: Sequence[str] | None = None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    rules = all_rules()
    if ns.list_rules:
        width = max(len(r.name) for r in rules)
        for rule in rules:
            scope = ", ".join(rule.scope) if rule.scope else "(all modules)"
            print(f"{rule.name:<{width}}  {rule.description}")
            print(f"{'':<{width}}  scope: {scope}")
        return 0
    known = {r.name for r in rules}
    for flag in ("select", "ignore"):
        raw = getattr(ns, flag)
        if raw is None:
            continue
        names = {n.strip() for n in raw.split(",") if n.strip()}
        unknown = names - known
        if unknown:
            parser.error(
                f"--{flag} names unknown rule(s): {', '.join(sorted(unknown))}"
            )
        if flag == "select":
            rules = [r for r in rules if r.name in names]
        else:
            rules = [r for r in rules if r.name not in names]
    result = lint_paths(ns.paths, rules=rules)
    if ns.format == "json":
        print(render_json(result))
    else:
        print(render_text(result, statistics=ns.statistics))
    return 1 if result.findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
