#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one NVIDIA GPU (built for the H100).

  python3 chip_smoke.py

Phases, each failing loudly (an exception or a non-zero exit):

1. refuse to run without CUDA or without ``src/repro_torch`` beside this
   script; print the card's name and power limit as nvidia-smi gives them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all started together, and print ptxas's register and
   spill lines;
3. hold each kernel against its plain PyTorch version on the card:
   flash attention at eleven shapes, every one in bf16 (the tensor-core
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
     chunking (see ``SSM_FLOOR_FACTOR``).

   Every launch counter is set to 0 just before ``generate`` and read just
   after; a slice's own kernel must show one launch per layer and the other
   kernel none.  The first generated token must be the prefill's argmax.  A
   reduced config of each model runs on the card against the CPU (qwen2
   prompt 24; mamba2 prompt 200, which crosses a chunk boundary with a
   ragged tail);
5. timings from CUDA events after a warm-up, per slice: prefill, decode,
   tok/s and peak memory, and a torch.profiler pass over one prefill and one
   decode step (wall time, device-busy time, the device's idle share, the top
   kernels); per kernel at its slice shape: the kernel beside its plain
   version, its bound and, where one PyTorch call computes the same function,
   that call (``scaled_dot_product_attention`` for flash, timed as a
   yardstick only: the port never calls it; none for the SSD scan); the SSD
   scan also at batch 1 x 2,048 tokens, with its split among its kernels.  Each of
   these is timed by its device time per call (``device_ms``: the kernels'
   own time in torch.profiler, summed over the kernels of 20 calls, over 20;
   the median of the three profiler sessions, among those that recorded the
   most kernels),
   with the back-to-back CUDA-event time per call beside it (``event_ms``),
   which also counts the host whenever a call's dispatch outlasts its kernels;
6. a ``{"slice": ...}`` line per model, a ``{"kernels": [...]}`` line (``ms``,
   ``plain_ms`` and ``library_ms`` are device times; ``event_ms`` and the
   other ``*_event_ms`` the CUDA-event times; ``bound_share`` is
   ``bound_ms / ms``), then the result line, last:
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

BATCH, PROMPT, GEN, SEED = 4, 512, 32, 0
LONG_PROMPT = 2048  # one sequence of 16 scan chunks: the split's serial pass and parallelism
KERNELS = ("flash_attention", "ssd_scan")
SLICES = {  # arch -> (its kernel, reduced prompt length for the card-vs-CPU check)
    "qwen2-1.5b": ("flash_attention", 24),
    "mamba2-780m": ("ssd_scan", 200),
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
    most kernels are kept, of those the one with the median time.
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
                if i == calls:
                    torch.cuda.synchronize()
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
    """The flash kernel against its plain version at every test shape."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, b, sq, skv, h, kvh, d, dtype, causal, q_offset; an fp32 case runs in bf16 too
        ("slice prefill", BATCH, PROMPT, PROMPT + GEN, 12, 2, 128, torch.bfloat16, True, 0),
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
    slice_err = None
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
            if name == "slice prefill":
                slice_err = err
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
    return {"max_abs_err": slice_err}


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
        ("slice prefill", BATCH, PROMPT, 48, 64, 128, bf16, True, 128, 128),
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
        if name == "slice prefill":
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
    return {"max_abs_err": slice_err}


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
    if cfg.family == "dense":
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
def plain_route(cfg, chunk: int | None = None):
    """The same model through its kernel's plain version: yields the config to run.

    ``chunk`` sets the plain SSD scan's chunk length (default: the config's).
    """
    from repro_torch.kernels import ref

    if cfg.family == "dense":
        yield dataclasses.replace(cfg, attention_impl="xla_chunked")
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


def check_reduced_against_cpu(arch: str, prompt: int) -> None:
    """A small input through the whole model: the card (kernel) against the CPU (plain)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.models.kvcache import init_cache

    cfg = reduced(slice_config(arch))
    params_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params_gpu = to_device(params_cpu, "cuda")
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, size=(2, prompt))
    out = {}
    with torch.no_grad():
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            cache = init_cache(cfg, 2, prompt + 4, dev)
            logits, _, _ = T.forward(params, cfg, {"tokens": torch.as_tensor(prompts, device=dev)}, cache)
            out[dev] = logits.cpu()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    ok = torch.allclose(out["cuda"], out["cpu"], **BF16_TOL)
    log(f"reduced {arch} prompt {prompt} prefill logits, card vs CPU: max abs {err:.3e} "
        f"(atol=rtol={BF16_TOL['atol']:g}) {'ok' if ok else 'FAIL'}")
    assert ok, f"reduced {arch} on the card disagrees with the CPU"


def serve_slice(arch: str) -> tuple[dict, int]:
    """Phases 4 and 5 for one model: (its slice line, its kernel's launches in generate)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
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

    scan_errors: list = []
    with torch.no_grad():
        with scans_checked(scan_errors) if cfg.family == "ssm" else contextlib.nullcontext():
            logits_k = prefill_logits(cfg)
        with plain_route(cfg) as plain_cfg:
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
    else:
        log(f"{arch} prefill bar: rel L2 {PREFILL_REL_L2:g}")
        assert rel <= PREFILL_REL_L2, f"{arch}: the {kernel} prefill disagrees with the plain route"
    assert torch.equal(tokens[:, 0], logits_k[:, -1].argmax(-1)), "first token != prefill argmax"
    del logits_k, logits_p

    check_reduced_against_cpu(arch, reduced_prompt)

    with torch.no_grad():
        cache = init_cache(cfg, BATCH, PROMPT + GEN, "cuda")

        def prefill():
            cache["len"] = 0
            return T.forward(params, cfg, {"tokens": tok_in}, cache)

        prefill_ms = cuda_time_ms(prefill, reps=5)
        step_tok = tokens[:, :1]

        def decode_run():
            cache["len"] = PROMPT
            c = cache
            for _ in range(GEN - 1):
                _, _, c = T.forward(params, cfg, {"tokens": step_tok}, c)

        decode_ms = cuda_time_ms(decode_run, reps=3, warmup=1) / (GEN - 1)
        gen_ms = cuda_time_ms(lambda: generate(cfg, params, prompts, GEN, device="cuda"), reps=3, warmup=1)

        def decode_step():
            return T.forward(params, cfg, {"tokens": step_tok}, {**cache, "len": PROMPT})

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
    log(f"{arch} prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms ({BATCH * PROMPT / prefill_ms * 1e3:.0f} tok/s); "
        f"decode: {decode_ms:.3f} ms/step ({BATCH / decode_ms * 1e3:.1f} tok/s at batch {BATCH}); "
        f"generate {BATCH}x{GEN}: {gen_ms:.3f} ms ({BATCH * GEN / gen_ms * 1e3:.1f} tok/s)")
    line = {"arch": arch, "batch": BATCH, "prompt": PROMPT, "gen": GEN, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "generate_ms": gen_ms, "peak_gib": peak_gib,
            "launches": launches, "profile": breakdown}
    return line, launches[kernel]


def time_flash() -> dict:
    """The flash kernel at qwen2-1.5b's prefill shape: kernel, plain, SDPA, bound."""
    import torch

    from repro_torch.kernels import ops, ref

    cfg = slice_config("qwen2-1.5b")
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
    return {"ms": kernel["ms"], "event_ms": kernel["event_ms"], "plain_ms": plain["ms"],
            "plain_event_ms": plain["event_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library["ms"], "library_event_ms": library["event_ms"]}


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
    return {"ms": kernel["ms"], "event_ms": kernel["event_ms"], "plain_ms": plain["ms"],
            "plain_event_ms": plain["event_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "library_event_ms": None, "chunk64_ms": kernel64["ms"]}


def main() -> int:
    import torch

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

    # ---- 4 and 5. the slices, and each kernel at its slice shape
    slices, launches = [], {}
    for arch, (kernel, _) in SLICES.items():
        line, launches[kernel] = serve_slice(arch)
        slices.append(line)
        torch.cuda.empty_cache()
    timings = {"flash_attention": time_flash(), "ssd_scan": time_ssd()}

    # ---- 6. result lines
    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:89"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:79"),
    }
    kernels = []
    for name in KERNELS:
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": launches[name], "max_abs_err": checks[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "event_ms": t["event_ms"], "plain_event_ms": t["plain_event_ms"],
            "library_event_ms": t["library_event_ms"], "bound_share": t["bound_ms"] / t["ms"],
            "ms_over_library_ms": t["ms"] / t["library_ms"] if t["library_ms"] else None,
        })
    for line in slices:
        log(json.dumps({"slice": {**line, "card": smi}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
