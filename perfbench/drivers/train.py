"""The training driver: one training state driven step after step, then its first steps against the reference.

Set-up builds the training step once (``repro_torch.train.steps.make_train_step``:
``value_and_grad`` of ``transformer.loss_fn`` under the configuration's remat,
then ``optim.adamw.adamw_update`` on float32 masters), makes the masters on
the device from the seed, and drives that same state through the first
``setup_steps`` steps through the window's own call and feed.  Those steps
warm every shape the window uses, and the comparison reads them: each step's
loss, the first step's gradient as the optimizer took it (its first moment
over 1 - b1), and each leaf's change after the third step.  The window then
runs the same step on the same state, every step on new rows from the seed,
until ``--seconds`` have passed; the step in flight then is finished.

A traced run wraps each window step in a span, records the kernels' calls,
and profiles one step of the window, another if that one's records are
incomplete.

Then the plain float32 reference (``perfbench.reference``) follows the same
first steps from the same masters and rows, and each number that the cell's
limits name is compared with its limit (see ``training_gaps``).
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from perfbench import harness, trace, weights
from perfbench.reference import adamw as ref_adamw
from perfbench.reference import model as ref

PROFILE_TRIES = 4
#: the traffic that a CPU run of the benchmark's tests shrinks to (16 rows, so that half a batch left out shows)
SMALL = {"batch": 16, "seq": 64}
#: the model's sizes that such a run keeps at the configuration's (beside ``harness.EXECUTION_KEYS``)
SMALL_KEEPS = ()
#: the readings that ``calibrate.py`` takes beside the program's on its control seeds (``readings``),
#: each with the multiple of the program's largest reading from which it counts as an upper one
FAULTS = {"control": 3, "fault_half_batch": 10, "fault_unchanged": 3}
#: a leaf whose first gradient in the reference is below this share of the
#: median leaf's moves under Adam by rounding alone, and its change is not compared
STILL_LEAF = 1e-3


def rows_for(seed: int, step: int, batch: int, seq: int, vocab: int, device) -> dict:
    """Step ``step``'s rows: (batch, seq + 1) uniform token ids from the seed, split into tokens and labels."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(np.random.SeedSequence([seed, 2, step]).generate_state(1)[0]))
    ids = torch.randint(0, vocab, (batch, seq + 1), generator=gen, device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def leaf_norms(tree, scale: float = 1.0) -> dict:
    """{path: L2 norm} of a tree's leaves (one transfer from the device)."""
    import torch

    named = weights.named_leaves(tree)
    norms = torch.stack([t.detach().float().norm() for _, t in named]).cpu().tolist()
    return {path: n * scale for (path, _), n in zip(named, norms)}


def change_norms(after, before) -> dict:
    import torch

    a, b = weights.named_leaves(after), weights.named_leaves(before)
    norms = torch.stack([(x.float() - y.float()).norm() for (_, x), (_, y) in zip(a, b)]).cpu().tolist()
    return {path: n for (path, _), n in zip(a, norms)}


def run(cell) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cfg = harness.port_config(cell.config)
    m, tr, dev, h = cell.model, cell.traffic, cell.device, cell.config["train"]
    cuda = dev == "cuda"
    if cell.trace and not cuda:
        raise ValueError("a traced run profiles the card: it needs device cuda")
    batch, seq = tr["batch"], tr["seq"]
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t_steps = time.perf_counter()
    step_fn = make_train_step(cfg, AdamWConfig(**h))
    params, opt, program = first_steps(cell, step_fn)

    spans = calls = profiled = kept = None
    if cell.trace:
        spans, calls = trace.Spans(), trace.KernelCalls(ops)
        calls.install()
    sync()
    setup_s = time.perf_counter() - cell.t_start
    print(f"set-up: to the first steps {t_steps - cell.t_start:.3f} s, weights and {tr['setup_steps']} steps "
          f"{cell.t_start + setup_s - t_steps:.3f} s", file=sys.stderr)
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < cell.seconds:
        rows = rows_for(cell.seed, tr["setup_steps"] + n, batch, seq, m["vocab"], dev)
        if spans is None:
            params, opt, _ = step_fn(params, opt, rows)
        else:
            if n >= 1 and n <= PROFILE_TRIES and not (kept and all(kept["complete"].values())):
                profiled = trace.Profiled(ops, calls)
                profiled.start()
            with spans.span("train_step", sync):
                params, opt, _ = step_fn(params, opt, rows)
            if profiled is not None:
                result = profiled.stop()
                profiled = None
                if kept is None or not all(kept["complete"].values()):
                    kept = result
        n += 1
    sync()
    t_end = time.perf_counter()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    if calls is not None:
        calls.uninstall()

    e2e = {"train_tok_s": batch * seq * n / (t_end - t0), "setup_s": setup_s}
    print(f"window: {n} steps in {t_end - t0:.3f} s; set-up {setup_s:.3f} s; first losses {program['loss']}",
          file=sys.stderr)
    ctx = {"model": m, "traffic": tr, "peak_bytes_window": peak_window}
    if spans is not None:
        ctx.update(spans=dict(spans.by_name), profile=kept)

    del params, opt, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = follow(cell)
    found = training_gaps(program, reference)
    for k in sorted(set(found) - set(cell.limits)):
        print(f"{k} (not compared, see PERF.md): {found[k]!r}", file=sys.stderr)
    checks = {k: (found[k], lim) for k, lim in cell.limits.items()}
    return {"e2e": e2e, "ctx": ctx, "profile": kept, "attempted": n, "failed": 0,
            "device": harness.device_info(dev, max(peak_setup, peak_window)), "checks": checks}


def readings(cell, control: bool) -> dict:
    """``calibrate.py``'s readings: the program's first steps against the reference and, with
    ``control``, those of the fp8 control and the faults in ``FAULTS`` (half of the batch left out,
    planted in the reference put in the program's place; a state left unchanged, which reads 1 on
    the gradient and the change by their definition)."""
    import torch

    from perfbench.reference.lowp import fp8_matmul
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_step

    cfg = harness.port_config(cell.config)
    step_fn = make_train_step(cfg, AdamWConfig(**cell.config["train"]))
    params, opt, program = first_steps(cell, step_fn)
    del params, opt, step_fn
    gc.collect()
    if cell.device == "cuda":
        torch.cuda.empty_cache()
    reference = follow(cell)
    out = dict(training_gaps(program, reference))
    if control:
        for label, kwargs in (("control", {"matmul": fp8_matmul}),
                              ("fault_half_batch", {"rows": slice(0, cell.traffic["batch"] // 2)})):
            for k, v in training_gaps(follow(cell, **kwargs), reference).items():
                out[f"{label}.{k}"] = v
        out.update(unchanged_readings(program, reference))
    return out


def unchanged_readings(program: dict, reference: dict) -> dict:
    """The readings of a step that returns its state unchanged: no gradient and no change on any leaf."""
    unchanged = {"loss": program["loss"], "grad": dict.fromkeys(program["grad"], 0.0),
                 "change": dict.fromkeys(program["change"], 0.0)}
    found = training_gaps(unchanged, reference)
    return {f"fault_unchanged.{k}": v for k, v in found.items() if k != "loss_gap"}


def first_steps(cell, step_fn) -> tuple:
    """Masters from the seed, driven through the first ``setup_steps`` steps by ``step_fn`` on the
    window's feed: (params, optimizer state, the program's readings for ``training_gaps``)."""
    import torch

    from repro_torch.optim.adamw import adamw_init

    m, tr, dev, h = cell.model, cell.traffic, cell.device, cell.config["train"]
    params = weights.make(cell.config["family"], m, cell.seed, dev, torch.float32)
    opt = adamw_init(params)
    start = params
    program = {"loss": []}
    for k in range(tr["setup_steps"]):
        params, opt, metrics = step_fn(params, opt, rows_for(cell.seed, k, tr["batch"], tr["seq"], m["vocab"], dev))
        program["loss"].append(metrics["loss"])
        if k == 0:
            program["grad"] = leaf_norms(opt["m"], 1 / (1 - h["b1"]))
    program["change"] = change_norms(params, start)
    program["loss"] = [float(x) for x in program["loss"]]
    return params, opt, program


def follow(cell, matmul=ref.fp32_matmul, rows: slice | None = None) -> dict:
    """The reference's readings over the cell's first steps, from the same masters and rows.

    ``matmul`` and ``rows`` put a lower-precision product or a part of the
    batch in the reference's place, for the control and the faults.
    """
    import torch

    m, tr, dev, h = cell.model, cell.traffic, cell.device, cell.config["train"]
    family = cell.config["family"]
    params = dict(weights.named_leaves(weights.make(family, m, cell.seed, dev, torch.float32)))
    start = {k: p.clone() for k, p in params.items()}
    state = ref_adamw.init(params)
    out = {"loss": []}
    with ref.fp32_matmuls():
        for k in range(tr["setup_steps"]):
            batch = rows_for(cell.seed, k, tr["batch"], tr["seq"], m["vocab"], dev)
            leaves = {key: p.detach().requires_grad_() for key, p in params.items()}
            tree = weights.unflatten(leaves)
            with torch.enable_grad():
                loss = ref.loss(family, tree, m, batch["tokens"], batch["labels"], matmul, rows)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = {key: g.detach() for key, g in zip(leaves, grads)}
            params, state, clipped = ref_adamw.update({k2: p.detach() for k2, p in params.items()}, grads, state, h)
            out["loss"].append(float(loss.detach()))
            if k == 0:
                out["grad"] = {key: float(g.norm()) for key, g in clipped.items()}
            del leaves, tree, grads, clipped
    out["change"] = {key: float((params[key] - start[key]).norm()) for key in params}
    return out


def training_gaps(program: dict, reference: dict) -> dict:
    """The numbers compared, each relative to the reference:

    * ``loss_gap``: |loss - reference loss| / |reference loss|, the largest over the first steps;
    * ``grad_gap``: per leaf, |norm of the program's first gradient - the
      reference's| over the larger of the reference's norm of that leaf and
      of the median leaf; the worst leaf's;
    * ``change_gap``: the same of each leaf's change over the first steps,
      leaving out leaves whose first gradient in the reference is under
      ``STILL_LEAF`` of the median leaf's;
    * ``grad_median_gap``: the median leaf's of the per-leaf gaps of the
      first gradient, which the noise of one small leaf does not move.
    """
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["loss"], reference["loss"]))

    def per_leaf(prog: dict, want: dict, keys) -> dict:
        med = float(np.median([want[k] for k in keys]))
        return {k: abs(prog[k] - want[k]) / max(want[k], med) for k in keys}

    def worst(name: str, gaps: dict, prog: dict, want: dict) -> float:
        leaf = max(gaps, key=gaps.get)
        print(f"{name}: worst leaf {leaf}: {prog[leaf]!r} against {want[leaf]!r}", file=sys.stderr)
        return gaps[leaf]

    grad_med = float(np.median(list(reference["grad"].values())))
    moving = [k for k, g in reference["grad"].items() if g >= STILL_LEAF * grad_med]
    print(f"change_gap: {len(reference['grad']) - len(moving)} of {len(reference['grad'])} leaves left out "
          f"(first gradient under {STILL_LEAF} of the median leaf's)", file=sys.stderr)
    grad = per_leaf(program["grad"], reference["grad"], list(reference["grad"]))
    change = per_leaf(program["change"], reference["change"], moving)
    return {"loss_gap": loss_gap,
            "grad_gap": worst("grad_gap", grad, program["grad"], reference["grad"]),
            "change_gap": worst("change_gap", change, program["change"], reference["change"]),
            "grad_median_gap": float(np.median(list(grad.values())))}
