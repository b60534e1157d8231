"""The sharded training driver: one training state over the cell's mesh, the same steps on every rank,
then its first steps against the reference.

Runs in every rank of ``perfbench/ranks.py`` (``run_rank``), which gives the
mesh of the mix's ``mesh`` and ``axes`` and the port's sharding rules (with
the mix's ``fsdp``).  Set-up makes the fp32 masters from the seed on every
rank (``weights.make``: the same values on each), places them and AdamW's
state by the port's rules (``repro_torch.launch.shardings.distribute_train_state``),
builds the step once (``make_train_step``, called under
``distributed.use_rules``) and drives that state through the first
``setup_steps`` steps through the window's own call and feed: each step's
rows, the whole global batch from the seed on every rank, placed by
``batch_specs`` (``distribute_tree``).  The comparison reads those steps,
each leaf gathered whole in turn (every rank takes part in each gather, as
``CheckpointManager.save`` does; rank 0 keeps the norms): each step's loss,
the first gradient as AdamW took it (its first moment over 1 - b1), and
each leaf's change after the last set-up step, from a sharded copy of the
start.

The window: each step holds collectives, so every rank runs the same number
of steps, fixed before the window from the last set-up step's time (a
barrier before it, the device synchronised after it), the largest over the
ranks: ceil(seconds / that time).  No step of the window waits for the host
or another rank where the program itself does not.  ``train_tok_s`` is the
global batch x seq x steps over rank 0's time between a barrier before the
window and one after it (the devices synchronised).  ``setup_s`` runs from
the parent's process start to the window.

A traced run wraps each window step in a span (which synchronises this
rank's device), records the kernels' calls, and profiles, on every rank, a
step of the window (another while that one's records of the port's kernels
are incomplete).  ``busy_s`` and ``window_s`` are the ranks' means; the
breakdown, and the NCCL kernels' device time by kernel (``nccl_s`` in the
metrics' ctx), are rank 0's.

Then the plain float32 reference (``follow``) in blocks of rows, one block a
rank: rank r computes rows [r B / W, (r + 1) B / W) of each step, and each
leaf's gradient is summed over the ranks onto the one rank that owns the
leaf (``torch.distributed.reduce`` as backward makes it, ``to_owner``) and
divided by W, which gives the whole batch's mean.  A leaf's owner alone
keeps its gradient, its start and AdamW's two moments and updates it, one
leaf at a time (the clip's global norm summed over the ranks), then sends
it to every rank.  So a rank holds the whole fp32 parameters, for the
forward, and a 1/W share of the rest: 4 + 16 / W bytes a parameter (8 at
W = 4) beside one block's activations and one leaf's update.

The window's stderr gives, by rank, each step's dispatch (the host's time in
the step's call), its device time (CUDA events after each step, read after
the window), the process's CPU seconds a second of the window and the
time that Python's cyclic collector took in it (``serve.GcClock``), which
tell a step that waits on the host from one that waits on the device or a
peer.
"""

from __future__ import annotations

import functools
import gc
import math
import statistics
import sys
import time

from perfbench import harness, trace, weights
from perfbench.drivers import train
from perfbench.drivers.serve import GcClock
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import model as ref

PROFILE_TRIES = 4
#: the traffic that a CPU run of the benchmark's tests shrinks to (16 rows: 8 a data rank of (2, 2))
SMALL = {"batch": 16, "seq": 64}
#: the model's sizes that such a run keeps at the configuration's (beside ``harness.EXECUTION_KEYS``)
SMALL_KEEPS = ()
#: the readings that ``calibrate.py`` takes beside the program's on its control seeds
#: (``readings_rank``), each with the multiple of the program's largest reading from which it counts
#: as an upper one
FAULTS = {"control": 3, "fault_half_batch": 10, "fault_no_exchange": 10, "fault_unchanged": 3}


def gathered_norms(world, tree, scale: float = 1.0, start: list | None = None) -> dict:
    """{path: L2 norm} of each leaf of ``tree`` (less the same leaf of ``start``), each gathered whole
    in turn; rank 0's, {} on the others (every rank must call it)."""
    import torch

    from repro_torch import distributed as D

    named = weights.named_leaves(tree)
    norms = []
    for i, (_, t) in enumerate(named):
        t = t.detach()
        whole = D.full_tensor(t if start is None else t - start[i])
        if world.rank == 0:
            norms.append(whole.float().norm())
    if world.rank != 0:
        return {}
    values = torch.stack(norms).cpu().tolist()
    return {path: v * scale for (path, _), v in zip(named, values)}


def first_steps(cell, world, cfg, step, feed) -> tuple:
    """Sharded masters from the seed, driven through the first ``setup_steps`` steps by ``step`` on
    the window's ``feed``: (params, optimizer state, the program's readings for
    ``train.training_gaps`` on rank 0, the last step's seconds)."""
    import torch

    from repro_torch import distributed as D
    from repro_torch.launch import shardings as SH

    m, tr, h = cell.model, cell.traffic, cell.config["train"]
    params, opt = SH.distribute_train_state(
        cfg, world.rules, lambda: weights.make(cell.config["family"], m, cell.seed, world.device, torch.float32))
    start = [t.detach().clone() for _, t in weights.named_leaves(params)]
    program = {"loss": []}
    step_s = None
    for k in range(tr["setup_steps"]):
        world.barrier()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, feed(k))
        program["loss"].append(float(D.full_tensor(metrics["loss"])))
        world.sync()
        step_s = time.perf_counter() - t0
        if k == 0:
            program["grad"] = gathered_norms(world, opt["m"], 1 / (1 - h["b1"]))
    program["change"] = gathered_norms(world, params, start=start)
    return params, opt, program, step_s


def owners(shapes: dict, size: int) -> dict:
    """{path: the rank that keeps the leaf's reference state}: the largest leaves first, each to the
    rank that keeps the fewest elements so far (the same on every rank)."""
    load = [0] * size
    out = {}
    for key in sorted(shapes, key=lambda k: (-shapes[k].numel(), k)):
        rank = min(range(size), key=lambda r: (load[r], r))
        out[key] = rank
        load[rank] += shapes[key].numel()
    return out


def to_owner(world, key: str, grad, owner: dict, kept: dict, exchange: bool = True) -> None:
    """Leaf ``key``'s gradient summed over the ranks onto its owner, divided by their number, and kept
    there (``kept``); without ``exchange``, the owner keeps its own block's.  Reduced as a contiguous
    tensor: NCCL takes no other (gloo takes any)."""
    import torch.distributed as dist

    grad = grad.detach().contiguous()
    if exchange:
        dist.reduce(grad, dst=owner[key])
        grad = grad / world.size
    if owner[key] == world.rank:
        kept[key] = grad


def follow(cell, world, matmul=ref.fp32_matmul, rows: int | None = None, exchange: bool = True) -> dict:
    """The reference's readings over the cell's first steps (as ``train.follow``'s, on rank 0; {} on
    the others), from the same masters and rows, each rank computing one block of the first ``rows``
    rows of each step (default: all) and keeping the state of the leaves it owns (the module's note).

    ``matmul`` and ``rows`` put a lower-precision product or a part of the batch in the reference's
    place, for the control and the faults; without ``exchange``, each leaf follows its owner's block
    alone and each rank reads its own block's loss: the exchange between chips left out.
    """
    import torch
    import torch.distributed as dist

    m, tr, dev, h = cell.model, cell.traffic, world.device, cell.config["train"]
    family = cell.config["family"]
    block = (tr["batch"] if rows is None else rows) // world.size
    mine_rows = slice(world.rank * block, (world.rank + 1) * block)
    params = dict(weights.named_leaves(weights.make(family, m, cell.seed, dev, torch.float32)))
    owner = owners(params, world.size)
    mine = [k for k in params if owner[k] == world.rank]
    start = {k: params[k].clone() for k in mine}
    state = ref_adamw.init({k: params[k] for k in mine})
    losses, first = [], {}
    with ref.fp32_matmuls():
        for k in range(tr["setup_steps"]):
            batch = train.rows_for(cell.seed, k, tr["batch"], tr["seq"], m["vocab"], dev)
            leaves = {key: p.detach().requires_grad_() for key, p in params.items()}
            grads: dict = {}

            def reduced(leaf, key: str) -> None:  # each leaf's gradient as soon as backward has made it
                to_owner(world, key, leaf.grad, owner, grads, exchange)
                leaf.grad = None

            hooks = [leaf.register_post_accumulate_grad_hook(functools.partial(reduced, key=key))
                     for key, leaf in leaves.items()]
            with torch.enable_grad():
                loss = ref.loss(family, weights.unflatten(leaves), m, batch["tokens"], batch["labels"], matmul,
                                mine_rows)
                loss.backward()
            for hook in hooks:
                hook.remove()
            del leaves, hooks
            loss = loss.detach()
            if exchange:
                dist.all_reduce(loss)
                loss = loss / world.size
            square = torch.zeros((), dtype=torch.float64, device=dev)
            for key in mine:
                square += grads[key].double().square().sum()
            dist.all_reduce(square)
            norm, t = float(square.sqrt()), state["step"]
            for key in mine:  # leaf by leaf: one leaf's old and new state whole at a time
                one = {"m": {key: state["m"].pop(key)}, "v": {key: state["v"].pop(key)}, "step": t}
                new, one, clipped = ref_adamw.update({key: params[key]}, {key: grads.pop(key)}, one, h, norm)
                params[key], state["m"][key], state["v"][key] = new[key], one["m"][key], one["v"][key]
                if k == 0:
                    first[key] = float(clipped[key].norm())
            state["step"] = t + 1
            for key, leaf in params.items():  # every rank takes each leaf from its owner
                dist.broadcast(leaf, src=owner[key])
            losses.append(float(loss))
    change = {key: float((params[key] - start[key]).norm()) for key in mine}
    found = world.gather((first, change))
    if world.rank != 0:
        return {}
    grad, moved = {}, {}
    for f, c in found:
        grad.update(f)
        moved.update(c)
    return {"loss": losses, "grad": {k: grad[k] for k in params}, "change": {k: moved[k] for k in params}}


def program_step(cell, world) -> tuple:
    """(the port's config, ``step(params, opt, rows)`` under the rules, ``feed(step_index)``): the
    training step built once, and each step's rows from the seed placed on the mesh."""
    from repro_torch import distributed as D
    from repro_torch.launch import shardings as SH
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cfg = harness.port_config(cell.config)
    batch, seq = cell.traffic["batch"], cell.traffic["seq"]
    if batch % world.size:
        raise ValueError(f"a global batch of {batch} rows does not split into {world.size} blocks")
    step_fn = make_train_step(cfg, AdamWConfig(**cell.config["train"]))

    def step(params, opt, rows):
        with D.use_rules(world.rules):
            return step_fn(params, opt, rows)

    def feed(step_index: int) -> dict:
        rows = train.rows_for(cell.seed, step_index, batch, seq, cell.model["vocab"], world.device)
        return SH.distribute_tree(world.rules, rows, SH.batch_specs(cfg, world.rules, rows))

    return cfg, step, feed


def free(world) -> None:
    import torch

    gc.collect()
    if world.cuda:
        torch.cuda.empty_cache()


def run_rank(cell, world) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops

    m, tr = cell.model, cell.traffic
    batch, seq = tr["batch"], tr["seq"]
    if cell.trace and not world.cuda:
        raise ValueError("a traced run profiles the card: it needs device cuda")
    cfg, step, feed = program_step(cell, world)

    t_steps = time.perf_counter()
    params, opt, program, step_s = first_steps(cell, world, cfg, step, feed)
    count = torch.tensor([max(1, math.ceil(cell.seconds / step_s))], device=world.device)
    dist.all_reduce(count, op=dist.ReduceOp.MAX)
    n_steps = int(count.item())

    spans = calls = kept = None
    if cell.trace:
        spans, calls = trace.Spans(), trace.KernelCalls(ops)
        calls.install()
    peak_setup = torch.cuda.max_memory_allocated() if world.cuda else 0
    if world.cuda:
        torch.cuda.reset_peak_memory_stats()
    world.barrier()
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    t0, cpu0 = time.perf_counter(), time.process_time()
    setup_s = t0 - cell.t_start
    if world.rank == 0:
        print(f"set-up: to the first steps {t_steps - cell.t_start:.3f} s, weights and {tr['setup_steps']} steps "
              f"{t0 - t_steps:.3f} s (the last {step_s:.3f} s): {n_steps} steps in the window", file=sys.stderr)
    dispatch, ends = [], [torch.cuda.Event(enable_timing=True)] if world.cuda else []
    for event in ends:
        event.record()
    for n in range(n_steps):
        rows = feed(tr["setup_steps"] + n)
        t_call = time.perf_counter()
        if spans is None:
            params, opt, _ = step(params, opt, rows)
        else:
            profiled = None
            if 1 <= n <= PROFILE_TRIES and not (kept and all(kept["complete"].values())):
                profiled = trace.Profiled(ops, calls)
                profiled.start()
            with spans.span("train_step", world.sync):
                params, opt, _ = step(params, opt, rows)
            if profiled is not None:
                result = profiled.stop()
                if kept is None or not all(kept["complete"].values()):
                    kept = result
        dispatch.append(time.perf_counter() - t_call)
        if world.cuda:
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
    world.barrier()
    t_end, cpu_s = time.perf_counter(), time.process_time() - cpu0
    gc.callbacks.remove(gc_clock)
    peak_window = torch.cuda.max_memory_allocated() if world.cuda else 0
    if calls is not None:
        calls.uninstall()

    peaks = world.gather((peak_setup, peak_window))
    busy = world.gather((kept["busy_s"], kept["window_s"]) if kept else None)
    profile = None
    if kept and all(busy):
        profile = {**kept, "busy_s": statistics.fmean(b for b, _ in busy),
                   "window_s": statistics.fmean(w for _, w in busy)}
    e2e = {"train_tok_s": batch * seq * n_steps / (t_end - t0), "setup_s": setup_s}
    ctx = {"model": m, "traffic": tr, "peak_bytes_window": max(w for _, w in peaks)}
    if spans is not None:
        nccl = {k: v for k, v in kept["kernel_s"].items() if k.lower().startswith("nccl")} if kept else None
        ctx.update(spans=dict(spans.by_name), profile=profile, nccl_s=nccl)
        if world.rank == 0:
            print(f"rank 0's profiled step: NCCL kernels {nccl} s; busy and window s by rank {busy}",
                  file=sys.stderr)
    device_s = [a.elapsed_time(b) / 1e3 for a, b in zip(ends, ends[1:])]
    by_rank = world.gather([round(f(x), 4) for x in (dispatch, device_s) if x for f in (statistics.median, max)]
                           + [round(cpu_s / (t_end - t0), 3), gc_clock.count, round(gc_clock.total, 3),
                              round(gc_clock.longest, 3)])
    if world.rank == 0:
        print(f"window: {n_steps} steps in {t_end - t0:.3f} s; set-up {setup_s:.3f} s; first losses "
              f"{program['loss']}; peaks by rank {peaks}", file=sys.stderr)
        print(f"a step's dispatch (median, max) and device time (median, max), s, the process's CPU seconds "
              f"a second of the window, and the collector's passes, seconds and longest pass, by rank: "
              f"{by_rank}; rank 0's dispatch s by step {[round(d, 3) for d in dispatch]}", file=sys.stderr)

    del params, opt
    free(world)
    reference = follow(cell, world)
    world.barrier()
    checks = {}
    if world.rank == 0:
        found = train.training_gaps(program, reference)
        for k in sorted(set(found) - set(cell.limits)):
            print(f"{k} (not compared, see PERF.md): {found[k]!r}", file=sys.stderr)
        checks = {k: (found[k], lim) for k, lim in cell.limits.items()}
    return {"e2e": e2e, "ctx": ctx, "profile": profile, "attempted": n_steps, "failed": 0,
            "device": harness.device_info(cell.device, max(max(p) for p in peaks), world.size), "checks": checks}


def readings_rank(cell, world, control: bool) -> dict:
    """``calibrate.py``'s readings of a cell of this kind (rank 0's; {} on the others): the program's
    first steps against the reference, as ``train.readings`` reads a one-card cell, and with
    ``control`` those of the fp8 control and the faults in ``FAULTS``, the exchange between chips
    left out among them (planted in the reference put in the program's place)."""
    from perfbench.reference.lowp import fp8_matmul

    cfg, step, feed = program_step(cell, world)
    params, opt, program, _ = first_steps(cell, world, cfg, step, feed)
    del params, opt
    free(world)
    runs = {"": follow(cell, world)}
    if control:
        runs["control."] = follow(cell, world, matmul=fp8_matmul)
        runs["fault_half_batch."] = follow(cell, world, rows=cell.traffic["batch"] // 2)
        runs["fault_no_exchange."] = follow(cell, world, exchange=False)
    world.barrier()
    if world.rank != 0:
        return {}
    reference = runs.pop("")
    out = dict(train.training_gaps(program, reference))
    for label, run in runs.items():
        out.update({label + k: v for k, v in train.training_gaps(run, reference).items()})
    if control:
        out.update(train.unchanged_readings(program, reference))
    return out
