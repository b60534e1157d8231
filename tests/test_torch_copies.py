"""The estimation pipeline's copies in the port stay copies.

Most of the port's estimation modules are the reference's jax-free modules
with ``repro.`` rewritten to ``repro_torch.``; each is pinned here to its
original, so a change to either side shows as a failing test and not as a
quiet drift.  The modules in ``DIVERGENT`` differ on purpose, for the reason
given beside each; every other module of those packages must be a copy.
"""

import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

VERBATIM = (
    "registry.py",
    "api/registry.py",
    "api/cache.py",
    "obs/__init__.py",
    "obs/trace.py",
    "obs/metrics.py",
    "core/__init__.py",
    "core/batch.py",
    "core/prs.py",
    "core/steps.py",
    "core/sweeps.py",
    "core/features.py",
    "core/forest_fit.py",
    "core/estimator.py",
    "core/blocks.py",
    "core/network.py",
    "accelerators/base.py",
    "checkpoint/__init__.py",
)

DIVERGENT = {
    "core/torch_predict.py": "the counterpart of core/jax_predict.py, rewritten for torch",
    "core/forest.py": "predict's backend branch calls torch_predict, not jax_predict",
    "accelerators/torch_device.py": "the counterpart of accelerators/xla_cpu.py: times on the card",
    "accelerators/__init__.py": "registers torch_device only; the analytic platforms wait",
    "checkpoint/manager.py": "torch tensors go to the host; restoring onto a mesh is not ported",
    "api/oracle.py": "the backend default and branch go to torch_predict; a device field",
    "api/campaign.py": "a measurement runtime raises: repro.runtime is not ported",
    "api/hub.py": "journal compaction raises: repro.runtime is not ported",
    "api/__init__.py": "exports all but the runtime's names",
}

PACKAGES = ("api", "obs", "core", "accelerators", "checkpoint")


def _as_port(source: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", source)


@pytest.mark.parametrize("module", VERBATIM)
def test_copy_equals_its_reference(module):
    ref = (SRC / "repro" / module).read_text()
    port = (SRC / "repro_torch" / module).read_text()
    assert port == _as_port(ref), f"src/repro_torch/{module} drifted from src/repro/{module}"


@pytest.mark.parametrize("module", sorted(DIVERGENT))
def test_divergent_module_differs_from_its_reference(module):
    port = (SRC / "repro_torch" / module).read_text()
    ref = SRC / "repro" / module
    assert not ref.exists() or _as_port(ref.read_text()) != port


def test_every_estimation_module_is_pinned_or_named():
    port = SRC / "repro_torch"
    found = {str(p.relative_to(port)) for pkg in PACKAGES for p in (port / pkg).rglob("*.py")}
    found |= {"registry.py"}
    assert found == set(VERBATIM) | set(DIVERGENT)
