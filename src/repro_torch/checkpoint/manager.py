"""Fault-tolerant checkpointing: atomic, keep-k, elastic restore.

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json     -- pytree structure, shapes, dtypes, mesh metadata
        arrays.npz        -- flat leaf arrays keyed by path
    <dir>/step_000123.tmp -- staging dir, atomically renamed on completion

Guarantees:
  * atomicity -- a crash mid-save never corrupts the latest checkpoint (tmp
    staging + os.replace rename; restore only sees completed dirs);
  * keep-k garbage collection;
  * **elastic restore** -- arrays are saved unsharded (gathered); restore
    re-shards onto whatever mesh/rules the new job runs with, so a job can
    come back on a different number of pods after a failure.

On a multi-host deployment the gather-to-host becomes a per-host shard dump
keyed by process index; the single-process container exercises the same code
path with process count 1 (see DESIGN.md §5).

In the port a DTensor leaf (a sharded run) is gathered to its full value
leaf by leaf (``full_tensor``: every rank joins each gather), only rank 0
keeps the host array (the other ranks drop each gathered leaf before the
next gather, so the host holds one copy of the state, as the reference's
one process does), rank 0 writes, and every rank waits at a barrier; the
stored arrays and manifest are those of an unsharded run.
``restore(shardings=...)`` places each leaf with ``distribute_tensor`` onto
the mesh of its ``NamedSharding`` -- any mesh, so a run saved on one mesh
resumes on another.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
from typing import Any

import numpy as np


def journal_path(directory: str, name: str = "measurements") -> str:
    """Canonical measurement-journal location inside a checkpoint/hub dir.

    The journal (see :class:`repro_torch.runtime.MeasurementJournal`) lives next to
    the artifacts it protects: kill a campaign mid-run and the next run in the
    same directory resumes from it.
    """
    os.makedirs(directory, exist_ok=True)
    return os.path.join(directory, f"{name}.jsonl")


# numpy has no bfloat16: a bf16 leaf is stored as its raw 2-byte words, the
# npz dtype ``|V2`` that ``np.savez`` writes for the reference's jax bf16 leaves
_BF16_WORDS = np.dtype("V2")


def _is_dtensor(v: Any) -> bool:
    """A DTensor, told without importing torch."""
    if sys.modules.get("torch.distributed.tensor") is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def _rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    if sys.modules.get("torch.distributed") is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _barrier() -> None:
    if sys.modules.get("torch.distributed") is None:
        return
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _is_bf16(v: Any) -> bool:
    return _is_tensor(v) and str(v.dtype) == "torch.bfloat16"


def _is_tensor(v: Any) -> bool:
    """A torch tensor, told without importing torch: none exists before torch is imported."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(v, torch.Tensor)


def _to_host(v: Any, keep: bool = True) -> np.ndarray | None:
    """Gather one leaf to a host numpy array (a bf16 tensor as ``|V2`` words).

    A DTensor is gathered whatever ``keep`` says (the gather is collective:
    every rank joins it); without ``keep`` the gathered leaf is dropped
    here and None comes back.
    """
    if _is_dtensor(v):
        v = v.full_tensor()
    if not keep:
        return None
    if isinstance(v, (np.ndarray, np.generic, int, float, bool, list, tuple)):
        return np.asarray(v)
    if _is_tensor(v):
        import torch

        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(_BF16_WORDS)
        return v.numpy()
    return np.asarray(v)


def _from_host(a: np.ndarray, like: Any) -> Any:
    """A restored leaf: a bf16 tensor where the skeleton holds one, else the array."""
    if _is_bf16(like):
        import torch

        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(like.device)
    return a


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict[str, Any], skeleton: Any, prefix: str = "") -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}/") for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        seq = [_unflatten(flat, v, f"{prefix}{i}/") for i, v in enumerate(skeleton)]
        return type(skeleton)(seq)
    return _from_host(flat[prefix[:-1]], skeleton)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def journal_path(self, name: str = "measurements") -> str:
        """Measurement-journal path alongside this manager's checkpoints."""
        return journal_path(self.directory, name)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> str:
        """Write ``tree`` as step ``step``; every rank of a sharded run calls it
        (each leaf's gather is collective), rank 0 keeps the host arrays and
        writes, all return after it has."""
        flat = _flatten(tree)
        writer = _rank() == 0
        # leaf by leaf: beside what rank 0 keeps, a rank holds one gathered leaf at most
        arrays = {k: _to_host(v, keep=writer) for k, v in flat.items()}
        final = os.path.join(self.directory, f"step_{step:09d}")
        if not writer:
            _barrier()
            return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: "bfloat16" if _is_bf16(flat[k]) else str(a.dtype) for k, a in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()
        _barrier()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

    # ------------------------------------------------------------------ load
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, skeleton: Any, step: int | None = None, shardings: Any = None) -> tuple[Any, int]:
        """Restore into the structure of ``skeleton``.

        A leaf whose skeleton is a bf16 tensor comes back as a bf16 tensor
        (same bits, the skeleton's device); every other leaf as the stored
        numpy array, as in the reference.

        ``shardings``: optional tree of ``repro_torch.distributed.NamedSharding``
        (same structure; None for a leaf left as above): each array is
        placed with ``distribute_tensor`` onto its sharding's mesh, in the
        skeleton leaf's dtype -- this is the elastic-resharding path.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten(flat, skeleton)
        if shardings is not None:
            tree = _place(tree, shardings, skeleton)
        return tree, step


def _place(tree: Any, shardings: Any, skeleton: Any) -> Any:
    """Each restored leaf distributed by its sharding (a leaf with None stays as it is)."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k], skeleton[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(shardings, "placements"):
        return type(tree)(_place(v, s, k) for v, s, k in zip(tree, shardings, skeleton))
    if shardings is None:
        return tree
    import torch
    from torch.distributed.tensor import distribute_tensor

    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.asarray(tree))
    if _is_tensor(skeleton):
        t = t.to(skeleton.dtype)
    return distribute_tensor(t, shardings.mesh, shardings.placements)
