#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths and estimation pipeline on one NVIDIA GPU (the H100).

  python3 chip_smoke.py

Phases, each failing loudly (an exception or a non-zero exit):

1. refuse to run without CUDA or without ``src/repro_torch`` beside this
   script; print the card's name and power limit as nvidia-smi gives them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all started together, and print ptxas's register and
   spill lines;
3. hold each kernel against its plain PyTorch version on the card:
   flash attention at twelve shapes (among them the qwen2-1.5b and
   olmoe-1b-7b prefill shapes), every one in bf16 (the tensor-core
   kernel) and the fp32 ones in fp32 too (the CUDA-core kernel), and its
   refusal of a misaligned bf16 input; the SSD scan, for y and the final state, at
   the three shapes of ``tests/test_kernels.py``, the mamba2-780m slice shape,
   a ragged S with a nonzero initial state, the reduced shape, a part-filled
   tile of state rows, chunk 64 against chunk 128, one bf16 chunk (S below
   the chunk), a long chain of 16 chunks from a unit-scale initial state
   (batch 1, S 2,048), and a B that is not 16-byte aligned: bf16 cases run
   the tensor-core split (``ssd_chunk_state``, ``ssd_state_pass``,
   ``ssd_chunk_scan``), fp32 cases the CUDA-core kernels;
4. the slices, each at full width and full depth with random bf16 weights
   from a seeded ``torch.Generator``, serving batch 4, prompt 512, gen 32
   through ``repro_torch.launch.serve.generate``:

   * qwen2-1.5b (28 layers) on the flash route: 28 flash launches (one per
     layer, in the cached prefill); the prefill logits against the same
     prefill through the plain chunked attention route;
   * mamba2-780m (48 layers): 48 SSD-scan launches (one per layer, in the
     prefill; decode runs the O(1) recurrence in plain PyTorch); each of the
     prefill's 48 scan calls against its plain version on the same inputs,
     and the prefill logits against the same prefill with the scan's plain
     version in place of the kernel (inside this script only, restored
     afterwards), measured against the plain route's own gap under another
     chunking (see ``SSM_FLOOR_FACTOR``);
   * olmoe-1b-7b (16 layers, 64 experts, top-8) on the flash route: 16 flash
     launches; the prefill logits against the plain chunked route, where
     routing flips between the two routes measured against the plain route's
     own gap between its two attention cores (see ``MOE_FLOOR_FACTOR``), and,
     with the flash route's experts pinned, against the dense bar; every MoE
     layer's capacity, dropped entries and routing flips (recorded inside the
     block, inside this script only); ``moe_block`` at its decode and prefill
     shapes under ``torch.cuda.set_sync_debug_mode("error")``.

   ``generate`` runs the prefill eager and the decode step as a captured
   CUDA graph, replayed through no wrapper (decode launches neither kernel).
   Every launch counter is set to 0 just before ``generate`` and read just
   after; a slice's own kernel must show one launch per layer and the other
   kernel none.  The first generated token must be the prefill's argmax.  A
   reduced config of each model runs on the card against the CPU (qwen2 and
   olmoe prompt 24, olmoe's every ``moe_block`` call also on the card's
   inputs; mamba2 prompt 200, which crosses a chunk boundary with a ragged
   tail);
5. timings from CUDA events after a warm-up, per slice: prefill, decode,
   tok/s and peak memory, and a torch.profiler pass over one prefill and one
   decode step (wall time, device-busy time, the device's idle share, the top
   kernels); for olmoe one layer's ``moe_block`` at both shapes, split into
   router + dispatch, expert products and combine, beside its bounds; per
   kernel at each of its slices' shapes: the kernel beside its plain
   version, its bound and, where one PyTorch call computes the same function,
   that call (``scaled_dot_product_attention`` for flash, timed as a
   yardstick only: the port never calls it; none for the SSD scan); the SSD
   scan also at batch 1 x 2,048 tokens, with its split among its kernels.  Each of
   these is timed by its device time per call (``device_ms``: the kernels'
   own time in torch.profiler, summed over the kernels of 20 calls, over 20;
   the median of the three profiler sessions, among those that recorded the
   most kernels),
   with the back-to-back CUDA-event time per call beside it (``event_ms``),
   which also counts the host whenever a call's dispatch outlasts its kernels.
   The decode graph, per slice (``decode_graph``): one eager decode step
   under ``torch.cuda.set_sync_debug_mode("error")``; one replay's logits
   and cache against the eager step from the same state (bf16 bar); the
   tokens of ``generate`` against an eager-decode ``generate``; decode ms per
   step by CUDA events, eager and graph in turns; device-busy ms, idle share
   and kernels of one replayed and one eager step (the profiler must record
   the graph's kernels); capture seconds and peak memory;
6. the paper's estimation pipeline with the card as its measured black-box
   platform (``estimate_on_card``): ``Campaign.run`` of ``repro_torch.api``
   on ``TorchDevicePlatform(device="cuda", dtype="bfloat16")`` for
   ``"dense"``, once sampling the PR set and once at random (500 points
   each, seed 0, one shared measurement cache); 300 held-out random configs
   from another seed, measured; the discovered step widths, the cache's
   counts and measure seconds, each campaign's wall seconds, PR-MAPE and
   random-MAPE on the held-out set; the platform's repeatability (20 configs
   measured by two fresh platform objects); the ``"torch"`` backend's layer
   predictions on the card against the ``"numpy"`` backend's (bitwise), and
   network predictions for MLP stacks of dense blocks (rtol 1e-12).  The
   launch counters are set to 0 before it and read after it: the pipeline
   runs none of the port's kernels (cuBLAS runs the timed GEMMs); then
   (``analytic_on_card``) the analytic platforms ``tpu_v5e`` (white box,
   noise 0), ``ultratrail`` and ``vta`` with their torch hooks on the card,
   bitwise against the numpy path for every layer type at 1, 64, 257 and
   10,000 rows; a PR and a random ``ultratrail`` campaign with their MAPEs
   on 1,000 held-out configs (simulated cycle counts, not speeds); and
   ``estimate_decode_step`` for qwen2-1.5b with the oracle on the card
   against the numpy backend (rtol 1e-12), and its seconds;
7. the script's total seconds, a ``{"slice": ...}`` line per model (with its
   ``decode_graph``), a
   ``{"kernels": [...]}`` line (``launches`` sums ``launches_by_slice``; the
   top-level times are at the kernel's first slice's shape and ``by_slice``
   holds each slice's; ``ms``, ``plain_ms`` and ``library_ms`` are device
   times; ``event_ms`` and the other ``*_event_ms`` the CUDA-event times;
   ``bound_share`` is ``bound_ms / ms``), an ``{"estimation": ...}`` line,
   then the result line, last:
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 / fp32 FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # the reference's bf16 flash bar
F32_TOL = dict(atol=2e-5, rtol=2e-5)  # the reference's fp32 kernel bar
SSD_BF16_TOL = dict(atol=2e-2, rtol=5e-2)  # the reference's bf16 SSD bar (tests/test_kernels.py)
# End to end in bf16 layers: the flash route scales the fp32 scores where the
# plain chunked route rounds q*scale to bf16 (both round P to bf16 for P V),
# and the bf16 residual stream carries such 2^-8 steps through every layer;
# for qwen2-1.5b a relative L2 error of 2e-2 (five bf16 steps) admits that
# and no wrong function.
PREFILL_REL_L2 = 2e-2
# mamba2-780m's 48 layers amplify single bf16 rounding flips of the scan's
# output far more: the plain scan against itself with another chunking (the
# same function, its fp32 sums in another order) differs by more than 2e-2
# at full depth (this script prints it).  So every scan call of the kernel-route
# prefill is held against its plain version on the same inputs (the kernel's
# bf16 bar), and the end-to-end gap to the plain route may exceed the plain
# route's own gap under that change of order by at most this factor.
SSM_FLOOR_FACTOR = 1.25
# olmoe-1b-7b: a bf16 step that moves a router's logits across a near tie
# sends a token to another expert, a change far larger than a rounding step,
# and 16 layers of top-8-of-64 routing over 2,048 tokens hold many near ties.
# Where the flash route routes any (layer, token) otherwise than the plain
# route and misses PREFILL_REL_L2, its gap may exceed the plain route's own
# gap between its two attention cores (xla_full against xla_chunked, which
# flip routing the same way) by at most this factor; and with the flash
# route's experts pinned, the plain route must meet PREFILL_REL_L2.  The
# reduced model amplifies bf16 steps past BF16_TOL even without a flip (the
# CPU's own two plain routes differ by more; this script prints it), so there
# every moe_block call is held to BF16_TOL against the CPU on the same inputs
# and the logits to this factor times the CPU routes' own largest gap.
MOE_FLOOR_FACTOR = 1.25

# Phase 6: the campaigns' budget, the held-out set and the repeatability probe
EST_SAMPLES, EST_HELD_OUT, EST_REPEAT = 500, 300, 20
NET_RTOL = 1e-12  # networks on the card: index_add_ orders float64 sums freely
# Phase 6b: rows per analytic-platform hook call, the ultratrail held-out set,
# and the launcher estimate's campaign (the CLI's default; about 10 s on a CPU)
ANALYTIC_ROWS, ANALYTIC_HELD_OUT, ESTIMATE_SAMPLES = (1, 64, 257, 10_000), 1000, 400

BATCH, PROMPT, GEN, SEED = 4, 512, 32, 0
LONG_PROMPT = 2048  # one sequence of 16 scan chunks: the split's serial pass and parallelism
KERNELS = ("flash_attention", "ssd_scan")
SLICES = {  # arch -> (its kernel, reduced prompt length for the card-vs-CPU check)
    "qwen2-1.5b": ("flash_attention", 24),
    "mamba2-780m": ("ssd_scan", 200),
    "olmoe-1b-7b": ("flash_attention", 24),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, calls: int = 20, warmup: int = 3, sessions: int = 3) -> dict:
    """Device time per call of ``fn``: ``ms``, ``kernels`` launched per call,
    ``top`` [(kernel, ms per call)] heaviest first, ``sessions_ms`` and
    ``sessions_kernels``.

    The self device time of every kernel that ``calls`` back-to-back calls
    launch, from torch.profiler, summed and divided by ``calls``.  Unlike
    events around the calls it leaves out the host's dispatch and the gaps it
    makes.  Inputs stay warm in L2, as for ``cuda_time_ms``.  The profiler
    has been seen to lose kernel records (a whole session's, and the first
    call's of every session), which would time a call too fast; so each
    session traces one more call first and keeps only the ``calls`` after it
    (the profiler's warm-up step), and only the sessions that recorded the
    most kernels are kept, of those the one with the median time.  The
    warm-up call is synchronised before the window opens: a call that
    returns before its kernels run (a CUDA-graph replay) would otherwise
    spill them into it.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
            for i in range(1 + calls):
                fn()
                if i in (0, calls):  # a graph replay returns at once: keep its
                    torch.cuda.synchronize()  # warm-up call's kernels out of the window
                prof.step()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")]  # the schedule's step range, not a kernel
        total_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(((e.key, e.self_device_time_total / 1e3 / calls) for e in kernels), key=lambda t: -t[1])
        runs.append((total_us / 1e3 / calls, sum(e.count for e in kernels) / calls, top))
    full = sorted((r for r in runs if r[1] == max(q[1] for q in runs)), key=lambda r: r[0])
    ms, kernels, top = full[len(full) // 2]
    if ms <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return {"ms": ms, "kernels": kernels, "top": top, "sessions_ms": [r[0] for r in runs],
            "sessions_kernels": [r[1] for r in runs]}


def timed(fn, calls: int = 20) -> dict:
    """``fn`` by its device time (``device_ms``) and by CUDA events (``event_ms``)."""
    return {**device_ms(fn, calls), "event_ms": cuda_time_ms(fn, reps=calls)}


def _bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(q, k, causal: bool, q_offset: int = 0) -> tuple[float, str]:
    """Least time for the card: bytes of q, k, v, o once over HBM vs this run's FLOPs."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if causal:
        keys = sum(min(max(q_offset + i + 1, 0), skv) for i in range(sq))
    else:
        keys = sq * skv
    flops = 4.0 * b * h * d * keys  # QK^T and PV, 2 FLOPs per multiply-add
    return _bound(nbytes, flops, q.dtype)


def ssd_bound_ms(x, log_da, bmat, state0, chunk: int) -> tuple[float, str]:
    """Least time for the card: x, log_da, B, C, state0 read and y, state written once vs the FLOPs.

    FLOPs per (batch row, head, chunk of Q steps): C B^T and W x over the
    lower triangle (Q(Q+1)/2 pairs, 2N + 2P), C S^T and the state update
    (4QNP).  A ragged last chunk counts its true length.
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state_bytes = b * h * p * n * 4
    nbytes = (2 * x.numel() * x.element_size() + log_da.numel() * 4
              + 2 * bmat.numel() * bmat.element_size()
              + state_bytes * (2 if state0 is not None else 1))
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        flops += b * h * (q * (q + 1) / 2 * 2 * (n + p) + 4 * q * n * p)
    return _bound(nbytes, flops, x.dtype)


def check_flash() -> dict:
    """The flash kernel against its plain version at every test shape.

    Returns the largest error at each flash slice's prefill shape, by arch.
    """
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, b, sq, skv, h, kvh, d, dtype, causal, q_offset; an fp32 case runs in bf16 too
        ("qwen2-1.5b", BATCH, PROMPT, PROMPT + GEN, 12, 2, 128, torch.bfloat16, True, 0),
        ("olmoe-1b-7b", BATCH, PROMPT, PROMPT + GEN, 16, 16, 128, torch.bfloat16, True, 0),
        ("mha d64", 1, 128, 128, 4, 4, 64, torch.float32, True, 0),
        ("gqa d80", 2, 256, 256, 8, 2, 80, torch.bfloat16, True, 0),
        ("mqa ragged d128", 1, 200, 200, 6, 1, 128, torch.float32, True, 0),
        ("qwen2-like d96", 1, 384, 384, 12, 2, 96, torch.float32, True, 0),
        ("block sweep d64", 1, 256, 256, 4, 2, 64, torch.float32, True, 0),
        ("sq<skv d32", 2, 24, 28, 4, 2, 32, torch.float32, True, 0),
        ("q_offset d32", 2, 40, 100, 4, 2, 32, torch.float32, True, 37),
        ("non-causal ragged d64", 1, 128, 200, 4, 4, 64, torch.float32, False, 0),
        ("non-causal d64", 1, 128, 256, 4, 4, 64, torch.float32, False, 0),
        ("padded lanes d40", 2, 150, 150, 6, 1, 40, torch.bfloat16, True, 0),
    ]
    slice_err = {}
    for name, b, sq, skv, h, kvh, d, case_dt, causal, off in cases:
        for dt in (case_dt,) if case_dt == bf16 else (f32, bf16):
            q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
            k = torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(dt)
            v = torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(dt)
            o = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            r = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            tol = BF16_TOL if dt == bf16 else F32_TOL
            err = (o.float() - r.float()).abs().max().item()
            ok = torch.allclose(o.float(), r.float(), **tol) and o.dtype == dt
            log(f"kernel flash_attention [{name}] q{tuple(q.shape)} kv{tuple(k.shape)} "
                f"{str(dt)[6:]} causal={causal} q_offset={off}: max_abs_err={err:.3e} "
                f"(atol=rtol={tol['atol']:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention [{name}] {dt} disagrees with its plain version")
            if name in SLICES:
                slice_err[name] = err
    q = torch.zeros((1, 8, 2, 12), device="cuda")
    try:
        ops.flash_attention(q, q, q)
    except ValueError as e:
        log(f"kernel flash_attention refuses head dim 12: {e}")
    else:
        raise AssertionError("flash_attention accepted head dim 12")
    # a contiguous bf16 view that starts 2 bytes past its allocation
    shape = (1, 64, 2, 64)
    q_odd = torch.zeros(torch.Size(shape).numel() + 1, dtype=bf16, device="cuda")[1:].view(shape)
    assert q_odd.is_contiguous() and q_odd.data_ptr() % 16 == 2
    try:
        ops.flash_attention(q_odd, q_odd, q_odd)
    except ValueError as e:
        log(f"kernel flash_attention refuses a misaligned bf16 input: {e}")
    else:
        raise AssertionError("flash_attention accepted a bf16 input 2 bytes off a 16-byte boundary")
    return slice_err


def ssd_inputs(gen, b, s, h, p, n, dt, state: bool):
    """Inputs scaled as tests/test_kernels.py scales them; state0 N(0, 1) or None."""
    import torch

    x = (torch.randn((b, s, h, p), generator=gen, device="cuda") * 0.2).to(dt)
    la = -torch.randn((b, s, h), generator=gen, device="cuda").abs() * 0.1
    bm = (torch.randn((b, s, n), generator=gen, device="cuda") * 0.3).to(dt)
    cm = (torch.randn((b, s, n), generator=gen, device="cuda") * 0.3).to(dt)
    s0 = torch.randn((b, h, p, n), generator=gen, device="cuda") if state else None
    return x, la, bm, cm, s0


def check_ssd() -> dict:
    """The SSD-scan kernel against its plain version: y and the final state."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, b, s, h, p, n, dtype, state0, kernel chunk, plain chunk
        ("test_kernels f32 n64", 2, 256, 4, 64, 64, f32, False, 128, 128),
        ("test_kernels bf16 ragged", 1, 300, 8, 64, 128, bf16, False, 128, 128),
        ("test_kernels f32 n16", 1, 128, 2, 32, 16, f32, False, 128, 128),
        ("mamba2-780m", BATCH, PROMPT, 48, 64, 128, bf16, True, 128, 128),
        ("ragged s200 state0", 2, 200, 8, 64, 128, f32, True, 128, 128),
        ("reduced p32 n16", 2, 200, 8, 32, 16, bf16, True, 128, 128),
        ("part tile p24 n16", 1, 300, 4, 24, 16, f32, True, 64, 64),
        ("chunk 64 vs 128 f32", 2, 300, 8, 64, 128, f32, True, 64, 128),
        ("chunk 64 vs 128 slice", BATCH, PROMPT, 48, 64, 128, bf16, True, 64, 128),
        ("one chunk bf16", 2, 100, 8, 64, 128, bf16, True, 128, 128),
        ("long chain s2048", 1, LONG_PROMPT, 48, 64, 128, bf16, True, 128, 128),
    ]
    slice_err = None
    for name, b, s, h, p, n, dt, state, chunk, plain_chunk in cases:
        x, la, bm, cm, s0 = ssd_inputs(gen, b, s, h, p, n, dt, state)
        y, st = ops.ssd_scan(x, la, bm, cm, chunk=chunk, state0=s0)
        torch.cuda.synchronize()
        yr, str_ = ref.ssd_scan_ref(x, la, bm, cm, chunk=plain_chunk, state0=s0)
        torch.cuda.synchronize()
        tol = SSD_BF16_TOL if dt == bf16 else F32_TOL
        err_y = (y.float() - yr.float()).abs().max().item()
        err_s = (st - str_).abs().max().item()
        ok = torch.allclose(y.float(), yr.float(), **tol) and torch.allclose(st, str_, **tol)
        ok = ok and y.dtype == dt and st.dtype == f32 and bool(torch.isfinite(y).all())
        log(f"kernel ssd_scan [{name}] x{tuple(x.shape)} n={n} {str(dt)[6:]} state0={state} "
            f"chunk {chunk} vs plain chunk {plain_chunk}: max_abs_err y={err_y:.3e} "
            f"state={err_s:.3e} (atol={tol['atol']:g} rtol={tol['rtol']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"ssd_scan [{name}] disagrees with its plain version")
        if name == "mamba2-780m":
            slice_err = max(err_y, err_s)
    # B not 16-byte aligned: the kernel reads it element by element
    x, la, bm, cm, s0 = ssd_inputs(gen, 2, 300, 4, 64, 128, bf16, True)
    bm_odd = torch.empty(bm.numel() + 1, dtype=bf16, device="cuda")[1:].view(bm.shape)
    bm_odd.copy_(bm)
    assert bm_odd.data_ptr() % 16 != 0
    y, st = ops.ssd_scan(x, la, bm_odd, cm, state0=s0)
    yr, str_ = ref.ssd_scan_ref(x, la, bm, cm, state0=s0)
    ok = torch.allclose(y.float(), yr.float(), **SSD_BF16_TOL) and torch.allclose(st, str_, **SSD_BF16_TOL)
    log(f"kernel ssd_scan [misaligned B] x{tuple(x.shape)}: max_abs_err y="
        f"{(y.float() - yr.float()).abs().max().item():.3e} state={(st - str_).abs().max().item():.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ssd_scan [misaligned B] disagrees with its plain version")
    x = torch.zeros((1, 8, 2, 12), device="cuda")
    try:
        ops.ssd_scan(x, torch.zeros((1, 8, 2), device="cuda"), x[:, :, 0, :8].contiguous(),
                     x[:, :, 0, :8].contiguous())
    except ValueError as e:
        log(f"kernel ssd_scan refuses head dim 12: {e}")
    else:
        raise AssertionError("ssd_scan accepted head dim 12")
    return {"mamba2-780m": slice_err}


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def slice_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family in ("dense", "moe"):
        cfg = dataclasses.replace(cfg, attention_impl="flash_pallas")
    return cfg


@contextlib.contextmanager
def scan_replaced(fn):
    """Run the ssm family's ``ssd_chunked`` as ``fn`` inside the block; restore it after."""
    from repro_torch.models import ssm

    kept = ssm.ssd_chunked
    ssm.ssd_chunked = fn
    try:
        yield
    finally:
        ssm.ssd_chunked = kept


@contextlib.contextmanager
def plain_route(cfg, chunk: int | None = None, attention: str = "xla_chunked"):
    """The same model through its kernel's plain version: yields the config to run.

    ``chunk`` sets the plain SSD scan's chunk length (default: the config's);
    ``attention`` the plain attention core of the dense and moe families.
    """
    from repro_torch.kernels import ref

    if cfg.family in ("dense", "moe"):
        yield dataclasses.replace(cfg, attention_impl=attention)
        return

    def plain(x, la, bm, cm, cfg_chunk, state0=None):
        return ref.ssd_scan_ref(x, la, bm, cm, chunk=chunk or cfg_chunk, state0=state0)

    with scan_replaced(plain):
        yield cfg


@contextlib.contextmanager
def scans_checked(errors: list):
    """Hold every SSD-scan kernel call against its plain version on the same inputs."""
    import torch

    from repro_torch.kernels import ops, ref

    def checked(x, la, bm, cm, chunk, state0=None):
        y, st = ops.ssd_scan(x, la, bm, cm, chunk=chunk, state0=state0)
        yr, sr = ref.ssd_scan_ref(x, la, bm, cm, chunk=chunk, state0=state0)
        ok = torch.allclose(y.float(), yr.float(), **SSD_BF16_TOL) and torch.allclose(st, sr, **SSD_BF16_TOL)
        errors.append(((y.float() - yr.float()).abs().max().item(), (st - sr).abs().max().item(), ok))
        return y, st

    with scan_replaced(checked):
        yield


@contextlib.contextmanager
def moe_recorded(record: list):
    """Record each MoE block's routing inside the block: per call, its top-k
    experts (``top_i``), load-balance loss (``aux``), kept entries (``keep``)
    and capacity."""
    from repro_torch.models import moe

    route, dispatch = moe.route, moe.dispatch

    def recording_route(xf, w_router, top_k):
        out = route(xf, w_router, top_k)
        record.append({"top_i": out[1], "aux": out[2]})
        return out

    def recording_dispatch(xf, top_i, n_exp, cap):
        out = dispatch(xf, top_i, n_exp, cap)
        record[-1].update(keep=out[2], capacity=cap)
        return out

    moe.route, moe.dispatch = recording_route, recording_dispatch
    try:
        yield
    finally:
        moe.route, moe.dispatch = route, dispatch


@contextlib.contextmanager
def moe_pinned(record: list):
    """Route each MoE block to the experts of ``record`` (a recorded run of the
    same model and tokens), with this run's probabilities at those experts."""
    import torch

    from repro_torch.models import layers as L
    from repro_torch.models import moe

    route, calls = moe.route, iter(record)

    def pinned_route(xf, w_router, top_k):
        _, _, aux = route(xf, w_router, top_k)
        top_i = next(calls)["top_i"]
        top_p = torch.softmax(L.matmul_f32(xf, w_router), dim=-1).gather(1, top_i)
        return top_p / top_p.sum(dim=-1, keepdim=True), top_i, aux

    moe.route = pinned_route
    try:
        yield
    finally:
        moe.route = route


def routing_flips(a: list, b: list) -> float:
    """Share of (layer, token) pairs whose top-k expert sets differ between two recorded runs."""
    import torch

    assert len(a) == len(b) and a, (len(a), len(b))
    differ = [(x["top_i"].cpu().sort(-1).values != y["top_i"].cpu().sort(-1).values).any(-1)
              for x, y in zip(a, b)]
    return torch.cat(differ).float().mean().item()


@contextlib.contextmanager
def moe_blocks_checked(errors: list, routes: list):
    """Hold every ``moe_block`` call on the card against the same call on the
    CPU, on the same inputs; record the card's routing in ``routes``."""
    import torch

    from repro_torch.models import moe

    block = moe.moe_block

    def checked(x, p, cfg):
        y, aux = block(x, p, cfg)
        routes.append({"top_i": moe.route(x.reshape(-1, x.shape[-1]), p["w_router"], cfg.moe_top_k)[1]})
        y_cpu, aux_cpu = block(x.cpu(), to_device(p, "cpu"), cfg)
        errors.append(((y.float().cpu() - y_cpu.float()).abs().max().item(),
                       torch.allclose(y.float().cpu(), y_cpu.float(), **BF16_TOL)
                       and torch.allclose(aux.cpu(), aux_cpu, rtol=1e-5)))
        return y, aux

    moe.moe_block = checked
    try:
        yield
    finally:
        moe.moe_block = block


def check_reduced_against_cpu(arch: str, prompt: int) -> bool:
    """A small input through the whole model: the card (kernel) against the CPU (plain).

    For the moe family every ``moe_block`` call is also held against the CPU on
    the card's inputs; and where the logits miss ``BF16_TOL``, their largest
    error may exceed the CPU's own between two plain attention routes
    (xla_full against xla_chunked) by at most ``MOE_FLOOR_FACTOR``.
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.models.kvcache import init_cache

    cfg = reduced(slice_config(arch))
    params_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params_gpu = to_device(params_cpu, "cuda")
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, size=(2, prompt))
    moe_family = cfg.family == "moe"

    def logits_on(dev, params, run_cfg, ctx=contextlib.nullcontext()):
        cache = init_cache(cfg, 2, prompt + 4, dev)
        with torch.no_grad(), ctx:
            return T.forward(params, run_cfg, {"tokens": torch.as_tensor(prompts, device=dev)}, cache)[0].cpu()

    routes, block_errors = {"cpu": [], "cuda": []}, []
    cpu = logits_on("cpu", params_cpu, cfg, moe_recorded(routes["cpu"]) if moe_family else contextlib.nullcontext())
    with moe_blocks_checked(block_errors, routes["cuda"]) if moe_family else contextlib.nullcontext():
        card = logits_on("cuda", params_gpu, cfg)
    err = (card - cpu).abs().max().item()
    ok = torch.allclose(card, cpu, **BF16_TOL)
    log(f"reduced {arch} prompt {prompt} prefill logits, card vs CPU: max abs {err:.3e}, rel L2 "
        f"{((card - cpu).norm() / cpu.norm()).item():.3e} (atol=rtol={BF16_TOL['atol']:g}) {'ok' if ok else 'missed'}")
    if not moe_family:
        return ok
    full = logits_on("cpu", params_cpu, dataclasses.replace(cfg, attention_impl="xla_full"))
    chunked = logits_on("cpu", params_cpu, dataclasses.replace(cfg, attention_impl="xla_chunked"))
    floor = (full - chunked).abs().max().item()
    blocks_ok = all(e[1] for e in block_errors) and len(block_errors) == cfg.n_layers
    log(f"reduced {arch}: routing flips card vs CPU {routing_flips(routes['cuda'], routes['cpu']):.4f}; "
        f"each of {len(block_errors)} moe_block calls vs the CPU on the same inputs: max abs err "
        f"{max(e[0] for e in block_errors):.3e}, {sum(e[1] for e in block_errors)} ok; the CPU's plain routes, "
        f"xla_full vs xla_chunked: max abs {floor:.3e}, rel L2 {((full - chunked).norm() / chunked.norm()).item():.3e}; "
        f"card vs CPU {err:.3e} = {err / floor:.3f} x that (bar {MOE_FLOOR_FACTOR:g} x where {BF16_TOL} is missed)")
    return blocks_ok and (ok or err <= MOE_FLOOR_FACTOR * floor)


def serve_slice(arch: str) -> tuple[dict, int]:
    """Phases 4 and 5 for one model: (its slice line, its kernel's launches in generate)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache

    kernel, reduced_prompt = SLICES[arch]
    cfg = slice_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {arch}: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, size=(BATCH, PROMPT))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cuda")
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"generate {arch}: tokens {tuple(tokens.shape)}, launches {launches} "
        f"(expected {kernel} {cfg.n_layers}, others 0), peak memory {peak_gib:.2f} GiB")
    expected = {name: cfg.n_layers if name == kernel else 0 for name in KERNELS}
    assert launches == expected, f"{arch}: launches {launches}, expected {expected}"
    assert tokens.shape == (BATCH, GEN) and tokens.dtype == torch.long
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab

    tok_in = torch.as_tensor(prompts, device="cuda")

    def prefill_logits(run_cfg):
        return T.forward(params, run_cfg, {"tokens": tok_in}, init_cache(cfg, BATCH, PROMPT + GEN, "cuda"))[0]

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    def recorded(routes):
        return moe_recorded(routes) if cfg.family == "moe" else contextlib.nullcontext()

    scan_errors: list = []
    routes = {"flash": [], "xla_chunked": [], "xla_full": []}
    moe_line, prefill_ok = None, True
    with torch.no_grad():
        with scans_checked(scan_errors) if cfg.family == "ssm" else recorded(routes["flash"]):
            logits_k = prefill_logits(cfg)
        with plain_route(cfg) as plain_cfg, recorded(routes["xla_chunked"]):
            logits_p = prefill_logits(plain_cfg)
    assert logits_k.shape == (BATCH, PROMPT, cfg.vocab) and logits_k.dtype == torch.float32
    assert bool(torch.isfinite(logits_k).all()), "non-finite prefill logits"
    rel = rel_l2(logits_k, logits_p)
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"{arch} prefill logits, {kernel} vs plain route: rel L2 {rel:.3e}, "
        f"max abs {(logits_k - logits_p).abs().max().item():.3e}, "
        f"|logits| max {logits_p.abs().max().item():.3f}, argmax agreement {agree:.4f}")
    if cfg.family == "ssm":
        assert len(scan_errors) == cfg.n_layers, f"{len(scan_errors)} scan calls in the prefill"
        log(f"{arch} prefill, each of {len(scan_errors)} ssd_scan calls vs its plain version on the same "
            f"inputs: max abs err y {max(e[0] for e in scan_errors):.3e}, state "
            f"{max(e[1] for e in scan_errors):.3e} (atol={SSD_BF16_TOL['atol']:g} rtol={SSD_BF16_TOL['rtol']:g}), "
            f"{sum(e[2] for e in scan_errors)} of {len(scan_errors)} ok")
        assert all(e[2] for e in scan_errors), f"{arch}: an ssd_scan call disagrees with its plain version"
        with torch.no_grad(), plain_route(cfg, chunk=64) as plain_cfg:
            floor = rel_l2(prefill_logits(plain_cfg), logits_p)
        log(f"{arch} plain route, chunk 64 vs chunk {cfg.ssm_chunk}: rel L2 {floor:.3e}; kernel route "
            f"{rel:.3e} = {rel / floor:.3f} x that (bar {SSM_FLOOR_FACTOR:g} x)")
        assert rel <= SSM_FLOOR_FACTOR * floor, f"{arch}: the {kernel} prefill disagrees with the plain route"
    elif cfg.family == "moe":
        with torch.no_grad():
            with plain_route(cfg, attention="xla_full") as full_cfg, recorded(routes["xla_full"]):
                floor = rel_l2(prefill_logits(full_cfg), logits_p)
            with plain_route(cfg) as plain_cfg, moe_pinned(routes["flash"]):
                pinned = rel_l2(logits_k, prefill_logits(plain_cfg))
        flips = routing_flips(routes["flash"], routes["xla_chunked"])
        floor_flips = routing_flips(routes["xla_full"], routes["xla_chunked"])
        dropped = [int((~r["keep"]).sum()) for r in routes["flash"]]
        busiest = [int(torch.bincount(r["top_i"].flatten(), minlength=cfg.moe_experts).max())
                   for r in routes["flash"]]
        aux = [float(r["aux"]) for r in routes["flash"]]
        entries = BATCH * PROMPT * cfg.moe_top_k
        moe_line = {
            "capacity": {"prefill": routes["flash"][0]["capacity"],
                         "decode": moe.capacity(BATCH, cfg.moe_top_k, cfg.moe_experts, cfg.capacity_factor)},
            "dropped_entries": {"prefill": sum(dropped), "of": entries * cfg.n_layers, "per_layer": dropped,
                                "plain_route": sum(int((~r["keep"]).sum()) for r in routes["xla_chunked"])},
            "busiest_expert_entries": busiest, "aux_per_layer": aux,
            "routing_flips": flips, "plain_floor_rel_l2": floor, "plain_floor_routing_flips": floor_flips,
            "pinned_routing_rel_l2": pinned,
        }
        log(f"{arch} prefill routing: capacity {moe_line['capacity']}, dropped entries {sum(dropped)} of "
            f"{entries * cfg.n_layers} ({entries} a layer; per layer {dropped}); routing flips, flash vs "
            f"plain route: {flips:.5f} of (layer, token) pairs")
        log(f"{arch} prefill load: entries of the busiest expert per layer {busiest} (an even share is "
            f"{entries // cfg.moe_experts}); aux per layer (1 when even) {', '.join(f'{a:.3f}' for a in aux)}")
        log(f"{arch} plain route, xla_full vs xla_chunked: rel L2 {floor:.3e}, routing flips {floor_flips:.5f}; "
            f"kernel route {rel:.3e} = {rel / floor:.3f} x that; bar rel L2 {PREFILL_REL_L2:g}, or where "
            f"routing flipped {MOE_FLOOR_FACTOR:g} x the plain route's own gap")
        log(f"{arch} plain route with the flash route's experts: rel L2 {pinned:.3e} from the flash route "
            f"(bar {PREFILL_REL_L2:g})")
        # asserted after the timings, so that a failing run still reports them; with
        # the flash route's experts the plain route must meet the dense bar
        prefill_ok = (rel <= PREFILL_REL_L2 or (flips > 0 and rel <= MOE_FLOOR_FACTOR * floor)) \
            and pinned <= PREFILL_REL_L2
    else:
        log(f"{arch} prefill bar: rel L2 {PREFILL_REL_L2:g}")
        assert rel <= PREFILL_REL_L2, f"{arch}: the {kernel} prefill disagrees with the plain route"
    assert torch.equal(tokens[:, 0], logits_k[:, -1].argmax(-1)), "first token != prefill argmax"
    del logits_k, logits_p

    reduced_ok = check_reduced_against_cpu(arch, reduced_prompt)

    with torch.no_grad():
        cache = init_cache(cfg, BATCH, PROMPT + GEN, "cuda")
        len_prompt = torch.full((), PROMPT, dtype=torch.int32, device="cuda")

        def prefill():  # forward leaves the input cache's len (0) as it was
            return T.forward(params, cfg, {"tokens": tok_in}, cache)

        prefill_ms = cuda_time_ms(prefill, reps=5)
        step_tok = tokens[:, :1]

        def decode_run():
            c = {**cache, "len": len_prompt}
            for _ in range(GEN - 1):
                _, _, c = T.forward(params, cfg, {"tokens": step_tok}, c)

        decode_ms = cuda_time_ms(decode_run, reps=3, warmup=1) / (GEN - 1)
        gen_ms = cuda_time_ms(lambda: generate(cfg, params, prompts, GEN, device="cuda"), reps=3, warmup=1)

        def decode_step():
            return T.forward(params, cfg, {"tokens": step_tok}, {**cache, "len": len_prompt})

        breakdown = {}
        for name, fn, wall_ms in (("prefill", prefill, prefill_ms), ("decode step", decode_step, decode_ms)):
            # one warm call; the profiler slows the host, so the idle share is
            # taken against the unprofiled CUDA-event time of the same call
            prof = device_ms(fn, calls=1, warmup=1)
            busy_ms, n_kernels, top = prof["ms"], prof["kernels"], prof["top"]
            breakdown[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1.0 - busy_ms / wall_ms, "kernels": round(n_kernels)}
            log(f"profile {arch} {name}: {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
                f"idle share {1.0 - busy_ms / wall_ms:.3f}, {n_kernels:g} kernels; top: "
                + "; ".join(f"{k[:48]} {ms:.3f} ms" for k, ms in top[:6]))
        if cfg.family == "moe":
            decode_routes: list = []
            with moe_recorded(decode_routes):
                decode_step()
            moe_line["dropped_entries"]["decode_step"] = sum(int((~r["keep"]).sum()) for r in decode_routes)
            log(f"{arch} decode step routing: capacity {decode_routes[0]['capacity']}, dropped entries "
                f"{moe_line['dropped_entries']['decode_step']} of {BATCH * cfg.moe_top_k * cfg.n_layers}")
        graph_line = decode_graph(cfg, params, cache, step_tok, tokens, prompts, decode_ms, decode_run)
    if cfg.family == "moe":
        moe_line["sync_free"] = check_moe_sync_free(cfg, params["layers"][0]["moe"])
        moe_line["moe_block"] = time_moe(cfg, params["layers"][0]["moe"])
    log(f"{arch} prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms ({BATCH * PROMPT / prefill_ms * 1e3:.0f} tok/s); "
        f"decode: {decode_ms:.3f} ms/step ({BATCH / decode_ms * 1e3:.1f} tok/s at batch {BATCH}); "
        f"generate {BATCH}x{GEN}: {gen_ms:.3f} ms ({BATCH * GEN / gen_ms * 1e3:.1f} tok/s)")
    line = {"arch": arch, "batch": BATCH, "prompt": PROMPT, "gen": GEN, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "generate_ms": gen_ms, "peak_gib": peak_gib,
            "launches": launches, "profile": breakdown, "decode_graph": graph_line}
    if moe_line is not None:
        line["moe"] = moe_line
    assert prefill_ok, f"{arch}: the {kernel} prefill disagrees with the plain route"
    assert reduced_ok, f"reduced {arch} on the card disagrees with the CPU"
    return line, launches[kernel]


def eager_generate(cfg, params, prompts):
    """``generate`` with every decode step eager, as on the CPU: the graph's yardstick."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache
    from repro_torch.train.steps import make_serve_step

    cache = init_cache(cfg, BATCH, PROMPT + GEN, "cuda")
    logits, _, cache = T.forward(params, cfg, {"tokens": torch.as_tensor(prompts, device="cuda")}, cache)
    out, step = [logits[:, -1].argmax(-1)], make_serve_step(cfg)
    for _ in range(GEN - 1):
        nxt, cache = step(params, cache, {"tokens": out[-1][:, None]})
        out.append(nxt)
    return torch.stack(out, dim=1)


def decode_graph(cfg, params, cache, step_tok, gen_tokens, prompts, eager_ms, eager_run) -> dict:
    """The decode step as a CUDA graph, against the same step run eagerly.

    ``cache`` holds the prefill of ``step_tok``'s prompts; ``gen_tokens`` is
    ``generate``'s output (graph decode), ``eager_ms`` the eager decode time
    per step and ``eager_run`` its timed run of ``GEN - 1`` eager steps.
    Checks that an eager step synchronises nowhere (sync debug mode
    "error"), and holds one replay's logits and cache against the eager step
    from the same state (``BF16_TOL``); prints the tokens' agreement with an
    eager ``generate``, decode ms per step eager and graph in turns, capture
    seconds and peak memory, and a profile of one replayed and one eager step.
    """
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.steps import capture_serve_step, make_serve_step, serve_step_in_place

    def state_at(length: int) -> dict:
        return {**{k: v.clone() for k, v in cache.items()},
                "len": torch.full((), length, dtype=torch.int32, device="cuda")}

    probe = state_at(PROMPT)
    make_serve_step(cfg)(params, probe, {"tokens": step_tok})  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        make_serve_step(cfg)(params, probe, {"tokens": step_tok})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del probe

    graph_cache = state_at(PROMPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = capture_serve_step(cfg, params, graph_cache, {"tokens": step_tok})
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # one replay against the eager step from the state the replay starts from
    eager_cache, tok1 = {k: v.clone() for k, v in graph_cache.items()}, step.tokens.clone()
    step.replay()
    logits_e, _, eager_new = T.forward(params, cfg, {"tokens": tok1}, eager_cache)
    torch.cuda.synchronize()
    logits_err = (step.logits - logits_e).abs().max().item()
    cache_err = {k: (graph_cache[k].float() - eager_cache[k].float()).abs().max().item()
                 for k in graph_cache if k != "len"}
    lens = (int(graph_cache["len"]), int(eager_new["len"]))
    replay_ok = (torch.allclose(step.logits, logits_e, **BF16_TOL) and lens == (PROMPT + 2,) * 2
                 and all(torch.allclose(graph_cache[k].float(), eager_cache[k].float(), **BF16_TOL)
                         for k in cache_err))
    same_token = bool(torch.equal(step.tokens[:, 0], logits_e[:, -1].argmax(-1)))
    log(f"{cfg.name} decode graph: captured in {capture_s:.2f} s (the warm-up step included), peak "
        f"{capture_peak_gib:.2f} GiB; one replay vs the eager step from the same state: logits max abs "
        f"{logits_err:.3e}, cache max abs {max(cache_err.values()):.3e}, len {lens}, same next token "
        f"{same_token} (atol=rtol={BF16_TOL['atol']:g}) {'ok' if replay_ok else 'FAIL'}")
    del eager_cache, logits_e, eager_new

    eager_tokens = eager_generate(cfg, params, prompts)
    differ = (eager_tokens != gen_tokens).any(dim=0).nonzero()
    agreement = (eager_tokens == gen_tokens).float().mean().item()
    first_diff = int(differ[0]) if len(differ) else None
    log(f"{cfg.name} generate, graph decode vs eager decode: token agreement {agreement:.4f}, "
        f"first differing step {first_diff}")

    def graph_run():
        graph_cache["len"].fill_(PROMPT)
        step.tokens.copy_(step_tok)
        for _ in range(GEN - 1):
            step.replay()

    # in turns: eager (measured before), graph, eager, graph
    graph_ms = [cuda_time_ms(graph_run, reps=5, warmup=1) / (GEN - 1)]
    eager_list = [eager_ms, cuda_time_ms(eager_run, reps=2, warmup=0) / (GEN - 1)]
    graph_ms.append(cuda_time_ms(graph_run, reps=5, warmup=0) / (GEN - 1))

    # one replayed step and one eager step of the same body, profiled; each
    # call advances len by one, seven calls in all
    graph_cache["len"].fill_(PROMPT)
    prof_g = device_ms(step.replay, calls=1, warmup=1)
    eager_state, tok_buf = state_at(PROMPT), step_tok.clone()
    prof_e = device_ms(lambda: serve_step_in_place(cfg, params, eager_state, tok_buf), calls=1, warmup=1)
    profiles = {}
    for name, prof, wall in (("graph", prof_g, min(graph_ms)), ("eager", prof_e, min(eager_list))):
        profiles[name] = {"wall_ms": wall, "device_busy_ms": prof["ms"], "idle_share": 1.0 - prof["ms"] / wall,
                          "kernels": prof["kernels"], "sessions_kernels": prof["sessions_kernels"]}
        log(f"profile {cfg.name} decode step ({name}): {wall:.3f} ms, device busy {prof['ms']:.3f} ms, "
            f"idle share {1.0 - prof['ms'] / wall:.3f}, {prof['kernels']:g} kernels (sessions "
            f"{prof['sessions_kernels']}); top: " + "; ".join(f"{k[:40]} {ms:.3f}" for k, ms in prof["top"][:5]))
    kernels_match = prof_g["kernels"] == prof_e["kernels"]
    log(f"{cfg.name} decode ms per step by CUDA events, in turns: eager {', '.join(f'{x:.3f}' for x in eager_list)}; "
        f"graph {', '.join(f'{x:.3f}' for x in graph_ms)} ({min(eager_list) / min(graph_ms):.2f}x); "
        f"torch.profiler kernels of a replay {prof_g['kernels']:g} vs the eager step's {prof_e['kernels']:g} "
        f"({'match' if kernels_match else 'DIFFER'})")
    assert replay_ok, f"{cfg.name}: the captured decode step disagrees with the eager step"
    assert prof_g["kernels"] > 0, f"{cfg.name}: torch.profiler recorded no kernel of the replayed graph"
    return {"sync_free_eager_step": True, "capture_s": capture_s, "capture_peak_gib": capture_peak_gib,
            "replay_vs_eager": {"logits_max_abs": logits_err, "cache_max_abs": cache_err,
                                "len": list(lens), "same_next_token": same_token},
            "generate_token_agreement": agreement, "generate_first_differing_step": first_diff,
            "decode_ms_per_step": {"eager": eager_list, "graph": graph_ms},
            "profile": profiles, "profiler_kernels_match": kernels_match}


def moe_inputs(cfg, tokens: int):
    """x (BATCH, tokens // BATCH, D) bf16, N(0, 1) as an RMS-normed hidden state."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    return torch.randn((BATCH, tokens // BATCH, cfg.d_model), generator=gen, device="cuda").bfloat16()


def check_moe_sync_free(cfg, p: dict) -> bool:
    """``moe_block`` at its decode (T = BATCH) and prefill (T = BATCH x PROMPT) shapes
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises at any synchronisation."""
    import torch

    from repro_torch.models import moe

    xs = [moe_inputs(cfg, BATCH), moe_inputs(cfg, BATCH * PROMPT)]
    with torch.no_grad():
        for x in xs:  # warm: first calls may create library handles
            moe.moe_block(x, p, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for x in xs:
                y, aux = moe.moe_block(x, p, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert y.shape == xs[-1].shape and bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(aux))
    log(f"moe_block at T = {BATCH} and T = {BATCH * PROMPT} under sync debug mode 'error': no synchronisation")
    return True


def moe_bound_ms(cfg, tokens: int, cap: int) -> dict:
    """Least times of ``moe_block``'s expert products and of the whole block.

    Experts: the three weights (E, D, F) read once, the (E, C+1, D) buffer
    read and the output written, against 3 x 2 x E (C+1) D F FLOPs.  The block
    adds the router (D, E) and x and y (T, D) in bf16, and 2 T D E router FLOPs.
    """
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    w_bytes, slots = 3 * e * d * f * 2, e * (cap + 1)
    expert_flops = 3 * 2.0 * slots * d * f
    experts = _bound(w_bytes + 2 * slots * d * 2, expert_flops, "bfloat16")
    block = _bound(w_bytes + d * e * 2 + 2 * tokens * d * 2, expert_flops + 2.0 * tokens * d * e, "bfloat16")
    return {"experts": experts, "block": block}


def time_moe(cfg, p: dict) -> dict:
    """One layer's ``moe_block`` by device time at its decode and prefill shapes,
    split into router + dispatch, expert products and combine, beside its bounds."""
    from repro_torch.models import moe

    k, e = cfg.moe_top_k, cfg.moe_experts
    out = {}
    for shape, tokens in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
        x = moe_inputs(cfg, tokens)
        xf = x.reshape(tokens, -1)
        cap = moe.capacity(tokens, k, e, cfg.capacity_factor)
        top_p, top_i, _ = moe.route(xf, p["w_router"], k)
        buf, slot, keep = moe.dispatch(xf, top_i, e, cap)
        y_exp = moe.experts(buf, p)
        parts = {
            "route_dispatch": timed(lambda: moe.dispatch(xf, moe.route(xf, p["w_router"], k)[1], e, cap)),
            "experts": timed(lambda: moe.experts(buf, p)),
            "combine": timed(lambda: moe.combine(y_exp, top_i, top_p, slot, keep)),
            "block": timed(lambda: moe.moe_block(x, p, cfg)),
        }
        bounds = moe_bound_ms(cfg, tokens, cap)
        out[shape] = {"tokens": tokens, "capacity": cap,
                      **{f"{name}_ms": t["ms"] for name, t in parts.items()},
                      **{f"{name}_event_ms": t["event_ms"] for name, t in parts.items()},
                      **{f"{name}_kernels": t["kernels"] for name, t in parts.items()},
                      "experts_bound_ms": bounds["experts"][0], "experts_bound_by": bounds["experts"][1],
                      "block_bound_ms": bounds["block"][0], "block_bound_by": bounds["block"][1]}
        log(f"moe_block {shape} T={tokens} C={cap}, device ms per call (CUDA-event ms; kernels a call): "
            + ", ".join(f"{name} {t['ms']:.4f} ({t['event_ms']:.4f}; {t['kernels']:g})" for name, t in parts.items())
            + f"; bounds: experts {bounds['experts'][0]:.4f} ({bounds['experts'][1]}), block "
            f"{bounds['block'][0]:.4f} ({bounds['block'][1]})")
        log(f"moe_block {shape} top kernels: " + "; ".join(
            f"{kname[:56]} {ms:.4f}" for kname, ms in parts["block"]["top"][:8]))
    return out


def time_flash(arch: str) -> dict:
    """The flash kernel at ``arch``'s prefill shape: kernel, plain, SDPA, bound."""
    import torch

    from repro_torch.kernels import ops, ref

    cfg = slice_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q = torch.randn((BATCH, PROMPT, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    k = torch.randn((BATCH, PROMPT + GEN, cfg.n_kv_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    v = torch.randn_like(k)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    sdpa_err = (sdpa().transpose(1, 2).float() - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
    # kernel, SDPA, SDPA, kernel: each measured twice, in turns
    kernel = timed(lambda: ops.flash_attention(q, k, v, causal=True))
    library = timed(sdpa)
    library2 = timed(sdpa)
    kernel2 = timed(lambda: ops.flash_attention(q, k, v, causal=True))
    plain = timed(lambda: ref.flash_attention_ref(q, k, v, causal=True), calls=10)
    bound_ms, bound_by = flash_bound_ms(q, k, causal=True)
    log(f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal, device ms per call "
        f"(CUDA-event ms per call): kernel {kernel['ms']:.4f} / {kernel2['ms']:.4f} "
        f"({kernel['event_ms']:.4f} / {kernel2['event_ms']:.4f}), sdpa {library['ms']:.4f} / "
        f"{library2['ms']:.4f} ({library['event_ms']:.4f} / {library2['event_ms']:.4f}; "
        f"{library['kernels']:g} kernels a call; max abs vs plain {sdpa_err:.2e}), plain {plain['ms']:.4f} "
        f"({plain['event_ms']:.4f}), bound {bound_ms:.5f} ms ({bound_by})")
    log(f"flash_attention kernels: {[k for k, _ in kernel['top']]}; sdpa kernels: {[k for k, _ in library['top']]}")
    log("device ms per call in each profiler session: " + "; ".join(
        f"{name} {', '.join(f'{x:.4f}' for x in t['sessions_ms'])}"
        for name, t in (("kernel", kernel), ("sdpa", library), ("sdpa", library2), ("kernel", kernel2),
                        ("plain", plain))))
    return {"q": list(q.shape), "kv": list(k.shape), "ms": kernel["ms"], "event_ms": kernel["event_ms"],
            "plain_ms": plain["ms"], "plain_event_ms": plain["event_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library["ms"], "library_event_ms": library["event_ms"]}


def time_ssd() -> dict:
    """The SSD-scan kernel at mamba2-780m's prefill shape, chunk 128 and 64: kernel, plain, bound;
    and at batch 1 x ``LONG_PROMPT`` tokens.  Each with its device time split among its kernels.

    No single PyTorch call computes the SSD scan, so there is no library time.
    """
    import torch

    from repro_torch.kernels import ops, ref

    cfg = slice_config("mamba2-780m")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    h, p, n, chunk = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    x, la, bm, cm, _ = ssd_inputs(gen, BATCH, PROMPT, h, p, n, torch.bfloat16, state=False)
    s0 = torch.zeros((BATCH, h, p, n), device="cuda")
    kernel = timed(lambda: ops.ssd_scan(x, la, bm, cm, chunk=chunk, state0=s0))
    kernel64 = timed(lambda: ops.ssd_scan(x, la, bm, cm, chunk=64, state0=s0))
    plain = timed(lambda: ref.ssd_scan_ref(x, la, bm, cm, chunk=chunk, state0=s0), calls=10)
    bound_ms, bound_by = ssd_bound_ms(x, la, bm, s0, chunk)
    xl, lal, bml, cml, s0l = ssd_inputs(gen, 1, LONG_PROMPT, h, p, n, torch.bfloat16, state=True)
    long = timed(lambda: ops.ssd_scan(xl, lal, bml, cml, chunk=chunk, state0=s0l))
    long_bound_ms, long_bound_by = ssd_bound_ms(xl, lal, bml, s0l, chunk)

    def split(t):
        return "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in t["top"])

    log(f"ssd_scan x{tuple(x.shape)} n={n} bf16, state0 given, device ms per call "
        f"(CUDA-event ms per call): kernel {kernel['ms']:.4f} ({kernel['event_ms']:.4f}; "
        f"{kernel['kernels']:g} kernels a call) at chunk {chunk}, {kernel64['ms']:.4f} "
        f"({kernel64['event_ms']:.4f}) at chunk 64, plain {plain['ms']:.4f} ({plain['event_ms']:.4f}), "
        f"bound {bound_ms:.4f} ms ({bound_by}), library: none")
    log(f"ssd_scan x{tuple(xl.shape)} n={n} bf16, state0 given, chunk {chunk}: kernel {long['ms']:.4f} "
        f"device ms per call ({long['event_ms']:.4f} events; {long['kernels']:g} kernels a call), "
        f"bound {long_bound_ms:.4f} ms ({long_bound_by}), bound share {long_bound_ms / long['ms']:.3f}")
    log("ssd_scan device ms per call (kernels a call) in each profiler session: " + "; ".join(
        f"{name} " + ", ".join(f"{m:.4f} ({k:g})" for m, k in zip(t["sessions_ms"], t["sessions_kernels"]))
        for name, t in (("chunk 128", kernel), ("chunk 64", kernel64), ("long", long))))
    log(f"ssd_scan device ms per call by kernel, x{tuple(x.shape)} chunk {chunk}: {split(kernel)}")
    log(f"ssd_scan device ms per call by kernel, x{tuple(x.shape)} chunk 64: {split(kernel64)}")
    log(f"ssd_scan device ms per call by kernel, x{tuple(xl.shape)} chunk {chunk}: {split(long)}")
    return {"x": list(x.shape), "ms": kernel["ms"], "event_ms": kernel["event_ms"], "plain_ms": plain["ms"],
            "plain_event_ms": plain["event_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "library_event_ms": None, "chunk64_ms": kernel64["ms"]}


def estimate_on_card(smi: str) -> dict:
    """Phase 6: PR-sampled against randomly sampled estimators of the card's dense layers."""
    import numpy as np
    import torch

    from repro_torch.accelerators.torch_device import TorchDevicePlatform
    from repro_torch.api import Campaign, CampaignSpec, MeasurementCache
    from repro_torch.core import prs, sweeps
    from repro_torch.core.blocks import Block
    from repro_torch.core.forest import mape

    platform = TorchDevicePlatform(device="cuda", dtype="bfloat16")
    cache = MeasurementCache()
    oracles, walls, stats = {}, {}, {}
    t_all = time.perf_counter()
    for sampling in ("pr", "random"):
        campaign = Campaign(
            CampaignSpec(platform="torch_device", layer_types=("dense",), sampling=sampling,
                         n_samples=EST_SAMPLES, seed=SEED),
            platform=platform, cache=cache)
        t0 = time.perf_counter()
        oracles[sampling] = campaign.run(device="cuda")
        walls[sampling] = time.perf_counter() - t0
        stats[sampling] = campaign.stats()
        est = oracles[sampling].estimators["dense"]
        log(f"campaign {sampling}: {walls[sampling]:.2f} s wall, widths {dict(est.widths)}, "
            f"{est.n_sweep} sweep measurements, {est.mean_measure_seconds * 1e3:.3f} ms per "
            f"training point; cache {stats[sampling]}")
    campaign_s = time.perf_counter() - t_all
    # The sweeps again, all from the cache: what Algorithm 1 read its widths from
    sweep_ms = {}
    for p, (x, y) in sweeps.run_sweeps(campaign.platform, "dense").items():
        by_residue = [float(np.median(y[x % 8 == r])) * 1e3 for r in range(8)]
        sweep_ms[p] = {"window": [int(x[0]), int(x[-1])], "min": float(y.min()) * 1e3,
                       "max": float(y.max()) * 1e3, "median_by_residue_mod_8": by_residue}
        log(f"sweep {p} {x[0]}-{x[-1]}: ms min {y.min() * 1e3:.4f} max {y.max() * 1e3:.4f}; median by "
            f"{p} mod 8: {', '.join(f'{v:.4f}' for v in by_residue)}")
    assert campaign.stats()["misses"] == stats["random"]["misses"], "the sweep summary measured anew"
    space = platform.param_space("dense")
    held_out = prs.sample_random_batch(space, EST_HELD_OUT, np.random.default_rng(SEED + 1))
    t0 = time.perf_counter()
    y_true = campaign.platform.measure_many("dense", held_out)
    held_out_s = time.perf_counter() - t0
    mapes, predict_ms = {}, {}
    for sampling, oracle in oracles.items():
        for backend in ("numpy", "torch"):
            t0 = time.perf_counter()
            y = oracle.predict("dense", held_out, backend=backend)
            predict_ms[f"{sampling}_{backend}"] = (time.perf_counter() - t0) * 1e3
            if backend == "numpy":
                expect = y
        assert y.tobytes() == expect.tobytes(), (
            f"{sampling}: torch layer predictions on the card are not bitwise equal to numpy's, "
            f"max abs {np.max(np.abs(y - expect)):.3e}")
        mapes[sampling] = mape(y_true, y)
    log(f"held-out: {EST_HELD_OUT} random configs (seed {SEED + 1}) measured in {held_out_s:.2f} s; "
        f"PR-MAPE {mapes['pr']:.3f} %, random-MAPE {mapes['random']:.3f} %; torch layer "
        f"predictions bitwise equal to numpy on the card; predict ms {predict_ms}")

    # The noise floor: the same configs timed by two fresh platform objects.
    probe = prs.sample_random_batch(space, EST_REPEAT, np.random.default_rng(SEED + 2))
    first, second = (TorchDevicePlatform(device="cuda", dtype="bfloat16").measure_many("dense", probe)
                     for _ in range(2))
    rel = np.abs(second - first) / first
    log(f"repeatability over {EST_REPEAT} configs: median relative difference "
        f"{np.median(rel):.4f}, max {np.max(rel):.4f}")

    # Whole networks: MLP stacks of dense blocks at qwen2-1.5b's widths
    nets = [[Block(kind="mlp", layers=(
        ("dense", {"tokens": t, "d_in": 1536, "d_out": 8960}),
        ("dense", {"tokens": t, "d_in": 8960, "d_out": 1536}),
    ), repeat=28)] for t in (16, 128, 512, 1000, 2048, 4096)]
    net_rel = {}
    for sampling, oracle in oracles.items():
        got = oracle.predict_networks(nets, backend="torch")
        expect = oracle.predict_networks(nets, backend="numpy")
        np.testing.assert_allclose(got, expect, rtol=NET_RTOL, atol=0)
        net_rel[sampling] = float(np.max(np.abs(got - expect) / expect))
    log(f"networks ({len(nets)} MLP stacks of 28 dense blocks) on the card within rtol "
        f"{NET_RTOL:g} of numpy (max relative difference: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in net_rel.items())}); pr estimates ms "
        f"{[round(float(x) * 1e3, 4) for x in oracles['pr'].predict_networks(nets)]}")
    torch.cuda.empty_cache()
    pr_est = oracles["pr"].estimators["dense"]
    return {
        "platform": platform.cache_key(), "card": smi, "n_samples": EST_SAMPLES,
        "widths": dict(pr_est.widths), "n_sweep": pr_est.n_sweep, "sweep_ms": sweep_ms,
        "unique_measurements": stats["random"]["unique_measurements"],
        "measure_seconds": stats["random"]["measure_seconds"],
        "campaign_seconds": {**walls, "both": campaign_s},
        "mean_measure_seconds": {k: o.estimators["dense"].mean_measure_seconds for k, o in oracles.items()},
        "held_out": EST_HELD_OUT, "held_out_seconds": held_out_s,
        "pr_mape": mapes["pr"], "random_mape": mapes["random"],
        "repeatability": {"configs": EST_REPEAT, "median_rel": float(np.median(rel)),
                          "max_rel": float(np.max(rel))},
        "layer_bitwise": True, "network_max_rel": net_rel, "predict_ms": predict_ms,
    }


def analytic_on_card(smi: str) -> dict:
    """Phase 6b: the analytic platforms with their torch hooks on the card.

    Every layer type of ``tpu_v5e`` (white box, noise 0), ``ultratrail`` and
    ``vta``: ``measure_batch`` through the hook on the card against the numpy
    path (the same platform with ``predict_backend = "numpy"``), bitwise, at
    ``ANALYTIC_ROWS`` random configs.  Then a PR and a random ``ultratrail``
    campaign (seed 0) and their MAPEs on held-out configs, which are
    simulated cycle counts (reproduction numbers, not speeds); and the
    launcher's ``estimate_decode_step`` for qwen2-1.5b with the oracle on the
    card, its ``"torch"`` prediction against ``"numpy"``'s (``NET_RTOL``).
    """
    import tempfile

    import numpy as np
    import torch

    from repro_torch.accelerators import torch_kernels
    from repro_torch.api import Campaign, CampaignSpec, EstimatorHub, PerfOracle, get_platform
    from repro_torch.configs import get_config
    from repro_torch.core import prs
    from repro_torch.core.forest import mape
    from repro_torch.core.network import decompose
    from repro_torch.launch.serve import ESTIMATE_LAYER_TYPES, ESTIMATE_PLATFORM, estimate_decode_step
    from repro_torch.models.config import InputShape

    hooks = {"tpu_v5e": torch_kernels.tpu_measure_batch, "ultratrail": torch_kernels.ultratrail_measure_batch,
             "vta": torch_kernels.vta_measure_batch}
    rng = np.random.default_rng(SEED)
    cases, hook_ms = 0, {}
    for name, kw in (("tpu_v5e", {"knowledge": "white"}), ("ultratrail", {}), ("vta", {})):
        card = get_platform(name, device="cuda", **kw)
        host = get_platform(name, device="cuda", **kw)
        host.predict_backend = "numpy"
        for lt in card.layer_types():
            for n in ANALYTIC_ROWS:
                batch = prs.sample_random_batch(card.param_space(lt), n, rng)
                t0 = time.perf_counter()
                got = hooks[name](card, lt, batch)
                dt = time.perf_counter() - t0
                want = host.measure_batch(lt, batch)
                if got is None or got.tobytes() != want.tobytes():
                    diff = np.max(np.abs(got - want) / want) if got is not None else None
                    raise AssertionError(f"{name} {lt} n={n}: the torch hook on the card is not bitwise "
                                         f"equal to numpy (max relative difference {diff})")
                cases += 1
                if n == ANALYTIC_ROWS[-1]:
                    hook_ms[f"{name}/{lt}"] = dt * 1e3
    log(f"analytic platforms on the card: {cases} (platform, layer type, n) cases, n in "
        f"{ANALYTIC_ROWS}, torch hooks bitwise equal to numpy; host ms of one hook call at n = "
        f"{ANALYTIC_ROWS[-1]}: " + ", ".join(f"{k} {v:.2f}" for k, v in hook_ms.items()))

    platform = get_platform("ultratrail", device="cuda")
    held_out = prs.sample_random_batch(platform.param_space("conv1d"), ANALYTIC_HELD_OUT,
                                       np.random.default_rng(SEED + 1))
    y_true = platform.measure_batch("conv1d", held_out)
    ultratrail = {}
    for sampling in ("pr", "random"):
        t0 = time.perf_counter()
        oracle = Campaign(CampaignSpec(platform="ultratrail", layer_types=("conv1d",), sampling=sampling,
                                       n_samples=EST_SAMPLES, seed=SEED),
                          platform=platform).run(device="cuda")
        est = oracle.estimators["conv1d"]
        ultratrail[sampling] = {"seconds": time.perf_counter() - t0, "widths": dict(est.widths),
                                "mape": mape(y_true, oracle.predict("conv1d", held_out))}
    log(f"ultratrail campaigns ({EST_SAMPLES} samples, seed {SEED}) on the card: widths "
        f"{ultratrail['pr']['widths']}; PR-MAPE {ultratrail['pr']['mape']:.3f} %, random-MAPE "
        f"{ultratrail['random']['mape']:.3f} % on {ANALYTIC_HELD_OUT} held-out configs (simulated cycles); "
        f"seconds {ultratrail['pr']['seconds']:.2f} / {ultratrail['random']['seconds']:.2f}")

    cfg = get_config("qwen2-1.5b")
    with tempfile.TemporaryDirectory() as hub_dir:
        t0 = time.perf_counter()
        t_card = estimate_decode_step(cfg, BATCH, PROMPT + GEN, hub_dir=hub_dir, n_samples=ESTIMATE_SAMPLES,
                                      device="cuda")
        estimate_s = time.perf_counter() - t0
        oracle = PerfOracle.load(EstimatorHub(hub_dir), ESTIMATE_PLATFORM, ESTIMATE_LAYER_TYPES, device="cuda")
    blocks = decompose(cfg, InputShape(name="serve", seq_len=PROMPT + GEN, global_batch=BATCH, kind="decode"),
                       dp=1, tp=1)
    t_numpy, t_torch = (float(oracle.predict_networks([blocks], backend=b)[0]) for b in ("numpy", "torch"))
    np.testing.assert_allclose([t_card, t_torch], [t_numpy, t_numpy], rtol=NET_RTOL, atol=0)
    log(f"estimate_decode_step qwen2-1.5b batch {BATCH} seq {PROMPT + GEN} ({ESTIMATE_SAMPLES} samples, "
        f"oracle on the card): {t_card * 1e3:.4f} ms a decode step of the simulated tpu_v5e[gray] in "
        f"{estimate_s:.2f} s; numpy backend {t_numpy * 1e3:.4f} ms (relative difference "
        f"{abs(t_card - t_numpy) / t_numpy:.2e}, rtol {NET_RTOL:g})")
    torch.cuda.empty_cache()
    return {"card": smi, "rows": list(ANALYTIC_ROWS), "hook_cases_bitwise": cases,
            "hook_ms_at_max_rows": hook_ms,
            "ultratrail": {"n_samples": EST_SAMPLES, "held_out": ANALYTIC_HELD_OUT, **ultratrail},
            "estimate_decode_step": {"arch": "qwen2-1.5b", "n_samples": ESTIMATE_SAMPLES,
                                     "simulated_ms": t_card * 1e3, "numpy_ms": t_numpy * 1e3,
                                     "seconds": estimate_s}}


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing ({SRC / 'repro_torch'})", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    # fp32 products in the plain versions run as true fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"{count} x {kind}")

    # ---- 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, (lib, report, nvcc_s) in built.items():
        log(f"  {lib.name}: nvcc {nvcc_s:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions
    checks = {"flash_attention": check_flash(), "ssd_scan": check_ssd()}

    # ---- 4 and 5. the slices, and each kernel at each of its slices' shapes
    slices, launches = [], {name: {} for name in KERNELS}
    for arch, (kernel, _) in SLICES.items():
        line, launches[kernel][arch] = serve_slice(arch)
        slices.append(line)
        torch.cuda.empty_cache()
    timings = {name: {} for name in KERNELS}
    for arch, (kernel, _) in SLICES.items():
        timings[kernel][arch] = time_flash(arch) if kernel == "flash_attention" else time_ssd()

    # ---- 6. the estimation pipeline, the card as its black-box platform
    from repro_torch.kernels import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0
    estimation = estimate_on_card(smi)
    estimation["analytic"] = analytic_on_card(smi)
    estimation["kernel_launches"] = {name: getattr(ops, name).launches for name in KERNELS}

    # ---- 7. result lines
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:89"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:79"),
    }
    def per_shape(t: dict, err: float) -> dict:
        return {**t, "max_abs_err": err, "bound_share": t["bound_ms"] / t["ms"],
                "ms_over_library_ms": t["ms"] / t["library_ms"] if t["library_ms"] else None}

    # The top-level numbers are those at the kernel's first slice's shape (the
    # shape earlier runs timed); "by_slice" holds every slice's, launches included.
    kernels = []
    for name in KERNELS:
        by_slice = {arch: {"launches": launches[name][arch], **per_shape(t, checks[name][arch])}
                    for arch, t in timings[name].items()}
        first = next(iter(by_slice.values()))
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": sum(launches[name].values()), "launches_by_slice": launches[name],
            "max_abs_err": max(checks[name].values()),
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "event_ms",
                                     "plain_event_ms", "library_event_ms", "bound_share",
                                     "ms_over_library_ms")},
            "by_slice": by_slice,
        })
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    for line in slices:
        log(json.dumps({"slice": {**line, "card": smi}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"estimation": estimation}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
