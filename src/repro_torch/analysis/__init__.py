"""repro-lint: static enforcement of the repo's measurement-hygiene contracts.

Stdlib-only by design (checked by the ``stdlib-only`` rule on itself and by
the import-blocker subprocess test): the linter must run on a bare Python
before any dependency installs, because it gates CI checkouts.

Public surface::

    from repro_torch.analysis import lint_paths, lint_source, all_rules
    result = lint_paths(["src"])          # LintResult
    report = lint_source(code, module="repro_torch.core.x")  # FileReport

CLI: ``python -m repro_torch.analysis [paths...] [--format json]``.
"""

from repro_torch.analysis.engine import (
    ENGINE_RULES,
    FileReport,
    Finding,
    LintResult,
    Rule,
    all_rules,
    known_rule_names,
    lint_paths,
    lint_source,
    parse_suppressions,
)
from repro_torch.analysis.reporters import SCHEMA_VERSION, render_json, render_text

__all__ = [
    "ENGINE_RULES",
    "FileReport",
    "Finding",
    "LintResult",
    "Rule",
    "SCHEMA_VERSION",
    "all_rules",
    "known_rule_names",
    "lint_paths",
    "lint_source",
    "parse_suppressions",
    "render_json",
    "render_text",
]
