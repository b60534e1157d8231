"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch_kernels/lib<name>-<key>.so`` at the root of the checkout,
for ``sm_90a``, with a plain C interface that the wrappers bind with
``ctypes``.  No source includes PyTorch's headers, so a build takes seconds,
not minutes.  ``<key>`` is a hash of the source, of every ``csrc/*.cuh`` and
of the nvcc flags, so a library is reused exactly when it was built from the
same text: checking out an older source finds (or builds) the older library,
never a newer one.  A new library is written under a temporary name and
renamed, so concurrent builds never load a torn file.

The loaded libraries are cached for the life of the process.  Each first
load is a ``kernels.load`` phase (``repro_torch.phases``; its span names
the kernel and whether nvcc ran) and counts in ``kernels.builds`` or
``kernels.cache_loads``, so a trace shows which kernel was built again.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from repro_torch import phases

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_key(name: str) -> str:
    """12 hex digits of a hash of ``csrc/<name>.cu``, every ``csrc/*.cuh`` and the nvcc flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build(name: str) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` if needed: (library path, ptxas report, seconds)."""
    src = CSRC / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}-{source_key(name)}.so"
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr, seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    with phases.phase("kernels.load") as ph:
        lib, _, seconds = build(name)
        built = seconds > 0
        if ph:
            ph.set(kernel=name, build="built" if built else "cached")
        loaded = ctypes.CDLL(str(lib))
    phases.count("kernels.builds" if built else "kernels.cache_loads")
    return loaded
