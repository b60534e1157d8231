"""Text and JSON reporters for repro-lint results.

The JSON schema (``SCHEMA_VERSION``) is part of the CI contract — the gate
step parses it, and tests/test_analysis.py pins the shape — so bump the
version when fields change.
"""

from __future__ import annotations

import json

from repro_torch.analysis.engine import LintResult

SCHEMA_VERSION = 1


def render_text(result: LintResult, statistics: bool = False) -> str:
    """Human-oriented report: one ``path:line:col: rule: message`` per finding."""
    lines = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule}: {f.message}")
    if lines:
        lines.append("")
    counts = result.counts
    if statistics and counts:
        for rule in sorted(counts):
            lines.append(f"  {rule}: {counts[rule]}")
        lines.append("")
    summary = (
        f"{len(result.findings)} finding(s), {result.suppressed} suppressed, "
        f"{result.files} file(s) in {result.elapsed_s:.2f}s"
    )
    lines.append(summary)
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    """Machine-oriented report for the CI gate and the bench harness."""
    payload = {
        "schema_version": SCHEMA_VERSION,
        "files": result.files,
        "findings": [
            {
                "rule": f.rule,
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
                "module": f.module,
            }
            for f in result.findings
        ],
        "counts": result.counts,
        "suppressed": result.suppressed,
        "elapsed_s": round(result.elapsed_s, 6),
        "rule_seconds": {
            k: round(v, 6) for k, v in sorted(result.rule_seconds.items())
        },
    }
    return json.dumps(payload, indent=1, sort_keys=True)
