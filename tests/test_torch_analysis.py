"""The port's repro-lint (``src/repro_torch/analysis``) against the reference's.

``repro_torch.analysis`` is the reference's linter with every rule scoped to
the port's modules (``repro_torch.*``), plus ``no-eager-torch``, the torch
counterpart of ``no-eager-jax``.  Parity: every ``.py`` file of
``src/repro`` is linted by the reference as ``repro.X`` and, with the
package renamed as the port's copies rename it, by the port as
``repro_torch.X``; both must report the same rules at the same lines, but
for ``no-eager-torch``, which the reference lacks.  Then the port's own tree
must lint clean, and the modules the rule guards must import without torch.
"""

from __future__ import annotations

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import all_rules as ref_rules  # noqa: E402
from repro.analysis import lint_source as ref_lint  # noqa: E402
from repro_torch.analysis import all_rules, lint_paths, lint_source  # noqa: E402
from repro_torch.analysis.cli import main as cli_main  # noqa: E402
from repro_torch.analysis.engine import module_name_for  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
REF_FILES = sorted(str(p.relative_to(SRC / "repro")) for p in (SRC / "repro").rglob("*.py"))


def _as_port(source: str) -> str:
    """The package renamed as the port's copies rename it (``tests/test_torch_copies.py``)."""
    return re.sub(r"\brepro(?=\.|\s+import\b)", "repro_torch", source)


def _module(rel: str, package: str) -> str:
    parts = [package, *rel[: -len(".py")].split("/")]
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def rules_of(src: str, module: str) -> list[str]:
    report = lint_source(textwrap.dedent(src), module=module)
    return sorted({f.rule for f in report.findings})


@pytest.mark.parametrize("rel", REF_FILES)
def test_port_linter_agrees_with_the_reference_on_every_reference_file(rel):
    source = (SRC / "repro" / rel).read_text()
    ref = ref_lint(source, path=rel, module=_module(rel, "repro"))
    port = lint_source(_as_port(source), path=rel, module=_module(rel, "repro_torch"))
    assert ref.suppressed == port.suppressed
    assert sorted((f.rule, f.line) for f in port.findings if f.rule != "no-eager-torch") == sorted(
        (f.rule, f.line) for f in ref.findings)


#: port modules a rule covers beyond the reference's scope, renamed: the phase
#: recorder's call sites (``repro_torch.phases``), which have no reference counterpart
PORT_ONLY_SCOPE = {"obs-zero-overhead": ("repro_torch.train", "repro_torch.kernels", "repro_torch.phases")}


def test_every_reference_rule_is_kept_with_the_port_scopes():
    ref = {r.name: r for r in ref_rules()}
    port = {r.name: r for r in all_rules()}
    assert set(port) == set(ref) | {"no-eager-torch"}
    for name, rule in ref.items():
        want = tuple(_as_port(f"{s}.")[:-1] for s in rule.scope) + PORT_ONLY_SCOPE.get(name, ())
        assert port[name].scope == want, name
        assert port[name].description == _as_port(rule.description), name
    assert port["no-eager-torch"].scope == port["no-eager-jax"].scope
    assert all(s.startswith("repro_torch.") for r in port.values() for s in r.scope)


def test_module_names_follow_each_package():
    assert module_name_for("src/repro_torch/launch/serve.py") == "repro_torch.launch.serve"
    assert module_name_for("src/repro_torch/api/__init__.py") == "repro_torch.api"
    assert module_name_for("src/repro/core/x.py") == "repro.core.x"


# ------------------------------------------------------------ no-eager-torch
def test_no_eager_torch_flags_a_module_scope_import():
    assert rules_of("import torch\n", "repro_torch.api.x") == ["no-eager-torch"]
    assert rules_of("from torch import nn\n", "repro_torch.serving.x") == ["no-eager-torch"]


def test_no_eager_torch_allows_function_scope_and_type_checking():
    src = """
        from typing import TYPE_CHECKING

        if TYPE_CHECKING:
            import torch

        def f():
            import torch
            from repro_torch.models import transformer
            return torch, transformer
    """
    assert rules_of(src, "repro_torch.launch.serve") == []


def test_no_eager_torch_flags_an_eager_torch_port_module():
    """The transitive case: a port module that imports torch at module scope."""
    for src in ("from repro_torch.models import transformer\n", "import repro_torch.device\n",
                "from repro_torch.kernels.ops import flash_attention\n",
                "from repro_torch.train.steps import capture_serve_step\n",
                "from repro_torch.weights import from_jax_params\n"):
        assert "no-eager-torch" in rules_of(src, "repro_torch.core.x"), src


def test_no_eager_torch_allows_the_config_and_torch_free_port_modules():
    for src in ("from repro_torch.models.config import ModelConfig\n", "from repro_torch.models import config\n",
                "from repro_torch.core.torch_predict import resolve_backend\n"):
        assert rules_of(src, "repro_torch.api.x") == [], src


def test_no_eager_torch_stays_out_of_the_model_stack():
    assert rules_of("import torch\n", "repro_torch.models.transformer") == []
    assert rules_of("import torch\n", "repro_torch.kernels.ops") == []


def test_no_eager_jax_still_guards_the_port():
    assert rules_of("import jax\n", "repro_torch.api.x") == ["no-eager-jax"]
    assert rules_of("import numpy\n", "repro_torch.analysis.x") == ["stdlib-only"]


# ------------------------------------------------------------------ the tree
def test_port_tree_lints_clean(capsys):
    """Every rule applied to the port: 0 unsuppressed findings, and every
    suppression it counts carries its reason (else ``bad-suppression``)."""
    result = lint_paths([str(SRC / "repro_torch")])
    assert result.findings == []
    assert result.files >= 80 and result.suppressed >= 6
    assert cli_main([str(SRC / "repro_torch")]) == 0
    assert "0 finding(s)" in capsys.readouterr().out


def test_the_guarded_port_modules_import_without_torch():
    code = textwrap.dedent(
        """
        import sys
        import repro_torch.api, repro_torch.serving, repro_torch.launch.serve
        import repro_torch.accelerators, repro_torch.checkpoint.manager, repro_torch.obs.report
        import repro_torch.core.torch_predict, repro_torch.accelerators.torch_kernels
        from repro_torch.api import Campaign, CampaignSpec
        spec = CampaignSpec(platform="torch_device", layer_types=("dense",), n_samples=40,
                            platform_kwargs={"synthetic": True})
        oracle = Campaign(spec).run(predict_backend="numpy")
        oracle.predict("dense", [{"tokens": 96, "d_in": 384, "d_out": 160}])
        assert "torch" not in sys.modules and "jax" not in sys.modules, sorted(sys.modules)
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_analysis_imports_without_third_party():
    code = textwrap.dedent(
        """
        import sys
        BLOCKED = {"numpy", "torch", "jax", "jaxlib", "scipy"}
        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{name} blocked by test")
                return None
        sys.meta_path.insert(0, Blocker())
        import repro_torch.analysis
        import repro_torch.obs.report
        report = repro_torch.analysis.lint_source("import torch\\n", module="repro_torch.api.x")
        assert [f.rule for f in report.findings] == ["no-eager-torch"], report
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
