"""The kernel build is keyed by the content of its sources, on the CPU.

``repro_torch.kernels.build.build`` names each library by a hash of its
``.cu`` source, the ``csrc/*.cuh`` headers and the nvcc flags.  Here ``nvcc``
is a stub script that writes its ``-o`` file and logs each call, and the
sources and build directory live in a temporary directory, so the tests call
``build.build`` (the stub's file is no real library, so never ``load``).
"""

import os
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

STUB = """#!/bin/sh
echo call >> "{log}"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo "$STUB_TEXT" > "$2"; fi
  shift
done
"""


@pytest.fixture
def kernels(tmp_path, monkeypatch):
    """A csrc/ with one source, an empty build dir, and a stub nvcc: (csrc, calls())."""
    csrc, out, log = tmp_path / "csrc", tmp_path / "build", tmp_path / "nvcc.log"
    csrc.mkdir()
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(log=log))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(stub))
    monkeypatch.setenv("STUB_TEXT", "v1")
    (csrc / "k.cu").write_text("// version 1\n")

    def calls():
        return len(log.read_text().splitlines()) if log.exists() else 0

    return csrc, calls


def test_changed_source_rebuilds(kernels, monkeypatch):
    csrc, calls = kernels
    lib1, _, _ = build.build("k")
    (csrc / "k.cu").write_text("// version 2\n")
    monkeypatch.setenv("STUB_TEXT", "v2")
    lib2, _, _ = build.build("k")
    assert calls() == 2
    assert lib2 != lib1 and lib2.read_text() == "v2\n"
    # a header change rebuilds too
    (csrc / "common.cuh").write_text("// shared\n")
    lib3, _, _ = build.build("k")
    assert calls() == 3 and lib3 not in (lib1, lib2)


def test_unchanged_source_does_not_rebuild(kernels):
    _, calls = kernels
    lib1, _, secs1 = build.build("k")
    lib2, report, secs2 = build.build("k")
    assert calls() == 1
    assert lib2 == lib1 and lib1.name.startswith("libk-") and lib1.suffix == ".so"
    assert secs2 == 0.0 and report == ""
    assert not [p for p in lib1.parent.iterdir() if p.name.endswith(".tmp")]


def test_restored_older_source_gets_its_own_library(kernels, monkeypatch):
    """A checkout of an older source after a newer build loads the older library,
    though the newer file is the more recent one on disk."""
    csrc, calls = kernels
    old, _, _ = build.build("k")
    (csrc / "k.cu").write_text("// version 2\n")
    monkeypatch.setenv("STUB_TEXT", "v2")
    new, _, _ = build.build("k")
    os.utime(old, (1, 1))  # the older library is also older on disk
    (csrc / "k.cu").write_text("// version 1\n")
    back, _, _ = build.build("k")
    assert back == old and back != new and back.read_text() == "v1\n"
    assert calls() == 2
