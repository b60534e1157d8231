"""Package contracts of the port: isolation, device policy, config copies."""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.models.config import reduced as jreduced  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import SHAPES, reduced  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        if parts[-1] == "__main__":  # importing it runs the program (``python -m``)
            continue
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and "repro_torch.launch.serve" in mods
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(bad)
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_no_source_imports_jax_or_repro():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert offenders == []


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """Without a card, asking for the default device raises; nothing quietly
    continues on the CPU.  The absence of a card is forced so that the test
    means the same on a machine that has one."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.generate(cfg, params, prompts, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2-1.5b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--serve-oracle", "--hub-dir", "unused", "--port", "0"])
    assert serve.generate(cfg, params, prompts, 2, device="cpu").shape == (1, 2)


def test_launcher_refuses_unported_paths(tmp_path, capsys):
    """``--fsck`` and ``--serve-oracle`` are ported: they need no ``--arch``,
    refuse to run without a journal or hub to read, and ``--fsck`` reports an
    absent journal as clean.  ``--serve-oracle`` without a card refuses to
    start; ``tests/test_torch_serving.py`` runs it on the CPU."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="--fsck requires --journal-dir or --hub-dir"):
        serve.main(["--fsck"])
    with pytest.raises(SystemExit, match="--serve-oracle requires --hub-dir"):
        serve.main(["--serve-oracle", "--device", "cpu"])
    assert serve.main(["--fsck", "--hub-dir", str(tmp_path)]) == 0
    assert '"exists": false' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--estimate-only"])
    assert "--arch is required unless --serve-oracle or --fsck is given" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-780m"])
def test_launcher_runs_reduced_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert rc == 0
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", JARCHS)
def test_configs_equal_the_reference(arch):
    assert ARCHS == JARCHS
    port, ref = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(reduced(port)) == dataclasses.asdict(jreduced(ref))
    assert port.param_count() == ref.param_count()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()
    }


@pytest.mark.parametrize("arch", [a for a in JARCHS if jget_config(a).family not in TT.PORTED_FAMILIES])
def test_unported_families_raise_naming_the_family(arch):
    cfg = reduced(get_config(arch))
    with pytest.raises(NotImplementedError, match=repr(cfg.family)):
        TT.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match=repr(cfg.family)):
        TT.forward({}, cfg, {"tokens": torch.zeros((1, 2), dtype=torch.long)})


def test_init_params_shapes_match_the_reference():
    import jax

    from repro.models import transformer as JT

    for arch in ("qwen2-1.5b", "granite-20b", "mamba2-780m"):
        jcfg = jreduced(jget_config(arch))
        jshapes = jax.eval_shape(lambda k, c=jcfg: JT.init_params(c, k), jax.random.PRNGKey(0))
        params = TT.init_params(reduced(get_config(arch)), torch.Generator().manual_seed(0), "cpu")
        assert params.keys() == jshapes.keys()
        assert len(params["layers"]) == jcfg.n_layers
        for name in ("embed", "final_norm"):
            assert tuple(params[name].shape) == jshapes[name].shape
        for group, leaves in jshapes["layers"].items():
            for i, layer in enumerate(params["layers"]):
                got = layer[group]
                if isinstance(leaves, dict):
                    assert got.keys() == leaves.keys()
                    for k, s in leaves.items():
                        assert tuple(got[k].shape) == s.shape[1:], (arch, group, k)
                else:
                    assert tuple(got.shape) == leaves.shape[1:]
