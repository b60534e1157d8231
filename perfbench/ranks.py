"""The rank frame: one cell on several chips, one process a chip.

``harness.run_cell`` calls ``run(cell)`` for a driver that gives
``run_rank(cell, world)`` in place of ``run(cell)`` (``calibrate.py`` calls
``run(cell, "readings_rank", (control,))``).  ``run`` starts
``cell.chips`` processes (``spawn``).  Each rank takes its card
(``torch.cuda.set_device(rank)``), joins one process group over NCCL (gloo
on the CPU, for the tests) at a localhost address, builds the
``DeviceMesh`` of the mix's ``mesh`` and ``axes`` and the port's sharding
rules for it (``repro_torch.distributed.for_mesh``, with the mix's
``fsdp``), and calls the driver's ``run_rank`` with that ``World``.  Rank
0's outcome comes back to the parent through a queue; every rank reports
the JAX modules it has loaded (``harness.banned_loaded``), which the parent
returns under ``banned``.

When a rank raises or dies, or ``limit_s`` passes before every rank has
reported, every rank is stopped (SIGTERM, then SIGKILL) and waited for, and
``run`` raises ``harness.RanksFailed``: ``run.py`` then exits non-zero and prints no
result.  A rank also dies with the parent (``PR_SET_PDEATHSIG`` on Linux),
so a parent that is killed leaves no rank on a card.

``setup_s`` runs from the parent's process start (``cell.t_start``) to a
rank's window: ``time.perf_counter`` is CLOCK_MONOTONIC on Linux, one clock
for every process of the machine, which ``run`` checks for each rank.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue as queue_module
import signal
import socket
import sys
import time
import traceback

from perfbench.harness import RanksFailed

#: the frame's time limit in seconds from the spawn: within the 1,200 s that a cell's first run
#: in a checkout may take (it builds the kernels); a rank that hangs is stopped after it
LIMIT_S = 1140.0
#: a collective that waits longer than this on a peer raises in the rank that waits
GROUP_TIMEOUT_S = 600
STOP_GRACE_S = 10.0


@dataclasses.dataclass
class World:
    """One rank's view: its index, the number of ranks, its device, the cell's mesh and sharding rules."""

    rank: int
    size: int
    device: object
    mesh: object
    rules: object

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def barrier(self) -> None:
        """Every rank here, and this rank's device work done."""
        import torch.distributed as dist

        self.sync()
        if self.cuda:
            dist.barrier(device_ids=[self.rank])
        else:
            dist.barrier()
        self.sync()

    def gather(self, obj) -> list:
        """``obj`` of every rank, in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when ``parent`` ends; end now if it already has."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(rank: int, cell, entry: str, args: tuple, port: int, results, parent: int) -> None:
    """One rank (see the module's note): reports ("done", rank, t_entered, banned, outcome of rank
    0) or ("failed", rank, traceback), then exits."""
    t_entered = time.perf_counter()
    _die_with_parent(parent)
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from perfbench import harness
        from repro_torch import distributed as D

        cuda = cell.device == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)  # the ranks share the CPU's cores
        dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=cell.chips, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
                                **({"device_id": torch.device("cuda", rank)} if cuda else {}))
        tr = cell.traffic
        mesh = init_device_mesh("cuda" if cuda else "cpu", tuple(tr["mesh"]), mesh_dim_names=tuple(tr["axes"]))
        world = World(rank, cell.chips, torch.device("cuda", rank) if cuda else torch.device("cpu"), mesh,
                      D.for_mesh(mesh, fsdp=bool(tr.get("fsdp", False))))
        outcome = getattr(harness.driver(tr["kind"], cell.here), entry)(cell, world, *args)
        dist.destroy_process_group()
        results.put(("done", rank, t_entered, harness.banned_loaded(), outcome if rank == 0 else None))
    except BaseException:  # reported first, before the peers see this rank go: the parent stops every rank
        results.put(("failed", rank, traceback.format_exc()))
        sys.exit(1)


def _stop(procs: list, wait_s: float) -> None:
    """Every rank process ended and waited for: ``wait_s`` to end by itself, then SIGTERM, then
    SIGKILL after a grace."""
    deadline = time.monotonic() + wait_s
    for p in procs:
        if p.pid is not None:
            p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + STOP_GRACE_S
    for p in procs:
        if p.pid is None:
            continue
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def run(cell, entry: str = "run_rank", args: tuple = (), limit_s: float = LIMIT_S) -> dict:
    """Rank 0's outcome of the cell's driver's ``entry(cell, world, *args)`` over ``cell.chips``
    ranks, with ``banned``: the union of the JAX modules that the ranks loaded (see the module's
    note)."""
    mesh = cell.traffic["mesh"]
    if math.prod(mesh) != cell.chips:
        raise ValueError(f"{cell.name}: a mesh {mesh} needs {math.prod(mesh)} chips; the cell asks for {cell.chips}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    t_spawn = time.perf_counter()
    procs = [ctx.Process(target=_rank_main, args=(r, cell, entry, args, port, results, os.getpid()),
                         name=f"perfbench-rank-{r}") for r in range(cell.chips)]
    reports: dict = {}
    pids: list[int] = []
    try:
        for p in procs:
            p.start()
        pids = [p.pid for p in procs]
        while len(reports) < cell.chips:
            try:
                report = results.get(timeout=1.0)
            except queue_module.Empty:
                gone = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode is not None and r not in reports]
                if gone:
                    raise RanksFailed(f"rank {gone[0][0]} exited with code {gone[0][1]} and reported nothing", pids)
                if time.perf_counter() - t_spawn > limit_s:
                    raise RanksFailed(f"ranks {sorted(set(range(cell.chips)) - set(reports))} did not finish "
                                      f"within the frame's limit of {limit_s} s", pids)
                continue
            if report[0] == "failed":
                raise RanksFailed(f"rank {report[1]} failed:\n{report[2]}", pids)
            reports[report[1]] = report
        now = time.perf_counter()
        for _, rank, t_entered, _, _ in reports.values():
            if not t_spawn <= t_entered <= now:
                raise RanksFailed(f"rank {rank} read time.perf_counter {t_entered} outside the parent's "
                                  f"[{t_spawn}, {now}]: the clock is not one across processes", pids)
    finally:
        _stop(procs, STOP_GRACE_S if len(reports) == cell.chips else 0.0)
        results.close()
    outcome = reports[0][4]
    outcome["banned"] = sorted({name for report in reports.values() for name in report[3]})
    return outcome
