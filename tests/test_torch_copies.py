"""The estimation pipeline's copies in the port stay copies.

Most of the port's estimation modules are the reference's jax-free modules
with the package ``repro`` renamed ``repro_torch`` (``repro.x`` and ``from
repro import x`` alike); each is pinned here to its
original, so a change to either side shows as a failing test and not as a
quiet drift.  The analytic platforms in ``PATCHED`` are copies with one more
rewrite (their hooks import ``torch_kernels`` where the reference's import
``jax_kernels``) and lines added for the device their hooks run on: every
line of the rewritten original is kept, but for the lines listed beside
each; the linter's engine derives the port's module names from its paths.
The modules in ``DIVERGENT`` differ on purpose, for the reason given
beside each; every other module of those packages must be a copy.
"""

import difflib
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
    "core/advisor.py",
    "api/campaign.py",
    "api/hub.py",
    "runtime/__init__.py",
    "runtime/stats.py",
    "runtime/health.py",
    "runtime/faults.py",
    "runtime/journal.py",
    "runtime/workers.py",
    "runtime/scheduler.py",
    "runtime/testing.py",
    "serving/__init__.py",
    "serving/batcher.py",
    "serving/cache.py",
    "serving/metrics.py",
    "serving/transport.py",
    "analysis/__init__.py",
    "analysis/__main__.py",
    "analysis/cli.py",
    "analysis/locks.py",
    "analysis/reporters.py",
    "data/__init__.py",
    "data/pipeline.py",
    "roofline/__init__.py",
)

_STATELESS = (
    "        # Stateless constructor: the base recipe suffices; spelled out so the\n",
)
PATCHED = {
    "accelerators/ultratrail.py": _STATELESS + (
        '        return ("ultratrail", {}, "repro_torch.accelerators.ultratrail")\n',),
    "accelerators/vta.py": _STATELESS + ('        return ("vta", {}, "repro_torch.accelerators.vta")\n',),
    "accelerators/tpu_v5e.py": (
        "            # Jitted kernel when the jax predict backend is active (env or a\n",
        "            # ``predict_backend`` attribute); bitwise-identical, see\n",
    ),
    # the H100's datasheet figures added beside V5E_HW; no line dropped
    "roofline/analysis.py": (),
    # Histogram.values(): a copy of the window, for readers that take exact samples
    "obs/metrics.py": (),
    # a self-time column, the wall-clock epoch in --chrome output, and metrics snapshots rendered
    "obs/report.py": (
        "Reads the append-only JSONL trace written by :class:`repro_torch.obs.Tracer`,\n",
        "call count, total/mean/min/max milliseconds, and percent of the trace's wall\n",
        "window (first event start -> last event end).  ``--chrome`` additionally\n",
        "exports the Chrome/Perfetto ``trace_event`` JSON next to the table.\n",
        'this phase live", not "exclusive self time".\n',
        "              f\"{'mean_ms':>9}  {'min_ms':>9}  {'max_ms':>9}  {'%wall':>6}\")\n",
        "            f\"{row['max_us']/1e3:>9.3f}  {pct:>6.1f}\"\n",
        '    ap.add_argument("trace", help="path to the trace .jsonl file")\n',
    ),
    # a file under src/repro_torch/ names a module of the port
    "analysis/engine.py": (
        '    if "repro" in parts:\n',
        '        parts = parts[parts.index("repro"):]\n',
    ),
}

DIVERGENT = {
    "core/torch_predict.py": "the counterpart of core/jax_predict.py, rewritten for torch",
    "core/forest.py": "predict's backend branch calls torch_predict, not jax_predict",
    "accelerators/torch_device.py": "the counterpart of accelerators/xla_cpu.py: times on the card",
    "accelerators/__init__.py": "registers torch_device in place of xla_cpu beside the analytic platforms",
    "accelerators/torch_kernels.py": "the counterpart of accelerators/jax_kernels.py, rewritten for torch",
    "checkpoint/manager.py": "torch tensors go to the host, bf16 as the reference's |V2 words; "
                             "DTensor leaves are gathered and written by rank 0, and a restore onto a "
                             "mesh places them with distribute_tensor",
    "api/oracle.py": "the backend default and branch go to torch_predict; a device field",
    "api/__init__.py": "its docstring's example campaign runs torch_device, on the card",
    "serving/server.py": "a device field; backends torch or numpy, and network cache keys "
                         "scoped for torch with a log target (rtol 1e-12, not bitwise)",
    "obs/trace.py": "an in-memory Tracer(None), span ids with their parent and root, the epoch pair "
                    "as the trace's first record and in the Chrome export, wall_ns onto the "
                    "profiler's clock, and Chrome exports read back (tests/test_torch_phases.py)",
    "analysis/rules.py": "every scope names the port's modules (repro_torch.*), and no-eager-torch, "
                         "the torch counterpart of no-eager-jax (tests/test_torch_analysis.py), whose "
                         "heavy modules name distributed, launch.mesh and launch.train as the "
                         "reference's jax-heavy ones do",
}

PACKAGES = ("api", "obs", "core", "accelerators", "checkpoint", "runtime", "serving", "analysis", "data",
            "roofline")


def _as_port(source: str) -> str:
    return re.sub(r"\brepro(?=\.|\s+import\b)", "repro_torch", source)


@pytest.mark.parametrize("module", VERBATIM)
def test_copy_equals_its_reference(module):
    ref = (SRC / "repro" / module).read_text()
    port = (SRC / "repro_torch" / module).read_text()
    assert port == _as_port(ref), f"src/repro_torch/{module} drifted from src/repro/{module}"


@pytest.mark.parametrize("module", sorted(PATCHED))
def test_patched_copy_keeps_every_line_of_its_reference(module):
    ref = _as_port((SRC / "repro" / module).read_text()).replace("jax_kernels", "torch_kernels")
    port = (SRC / "repro_torch" / module).read_text()
    ref_lines, port_lines = ref.splitlines(keepends=True), port.splitlines(keepends=True)
    dropped = [line for tag, i1, i2, _, _ in
               difflib.SequenceMatcher(None, ref_lines, port_lines, autojunk=False).get_opcodes()
               if tag in ("replace", "delete") for line in ref_lines[i1:i2]]
    assert dropped == list(PATCHED[module]), f"src/repro_torch/{module} drifted from src/repro/{module}"
    if module.startswith("accelerators/"):
        assert "torch_kernels" in port and "device" in port


@pytest.mark.parametrize("module", sorted(DIVERGENT))
def test_divergent_module_differs_from_its_reference(module):
    port = (SRC / "repro_torch" / module).read_text()
    ref = SRC / "repro" / module
    assert not ref.exists() or _as_port(ref.read_text()) != port


def test_every_estimation_module_is_pinned_or_named():
    port = SRC / "repro_torch"
    found = {str(p.relative_to(port)) for pkg in PACKAGES for p in (port / pkg).rglob("*.py")}
    found |= {"registry.py"}
    assert found == set(VERBATIM) | set(PATCHED) | set(DIVERGENT)
