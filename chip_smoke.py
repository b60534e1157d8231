#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths, estimation pipeline, runtime and service on one NVIDIA GPU (the H100).

  python3 chip_smoke.py

Phases, each failing loudly (an exception or a non-zero exit):

1. refuse to run without CUDA or without ``src/repro_torch`` beside this
   script; print the card's name and power limit as nvidia-smi gives them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
   one nvcc per source, all started together, and print ptxas's register and
   spill lines; then (2b) run ``python -m repro_torch.analysis src/repro_torch``,
   the port's repro-lint with every rule, which must report 0 findings;
3. hold each kernel against its plain PyTorch version on the card:
   flash attention at sixteen shapes (among them the prefill shapes of
   qwen2-1.5b, olmoe-1b-7b, zamba2-2.7b at head dim 80, the kernel's padded
   96-column tile, qwen2-vl-2b and whisper-medium at head dim 64), every one
   in bf16 (the tensor-core kernel) and the fp32 ones in fp32 too (the
   CUDA-core kernel), and its refusal of a misaligned bf16 input; the SSD
   scan, for y and the final state, at the three shapes of
   ``tests/test_kernels.py``, the mamba2-780m and zamba2-2.7b slice shapes,
   a ragged S with a nonzero initial state, the reduced shape, a part-filled
   tile of state rows, chunk 64 against chunk 128, one bf16 chunk (S below
   the chunk), a long chain of 16 chunks from a unit-scale initial state
   (batch 1, S 2,048), and a B that is not 16-byte aligned: bf16 cases run
   the tensor-core split (``ssd_chunk_state``, ``ssd_state_pass``,
   ``ssd_chunk_scan``), fp32 cases the CUDA-core kernels; and at
   mamba2-780m's training shape (x (2, 4,096, 48, 64));
3b. the scan's backward kernel (``csrc/ssd_scan_bwd.cu``) against its plain
   version (autograd of ``ssd_scan_ref``), every gradient (dx, dlog_da, dB,
   dC, dstate0) within ``SSD_BWD_TOL``, in fp32 and bf16, at the three shapes
   of ``tests/test_kernels.py``, mamba2-780m's training shape x (2, 4,096,
   48, 64) N 128, zamba2-2.7b's x (2, 4,096, 80, 64) N 64, a ragged S with a
   nonzero initial state and d(final state), chunk 64, a part-filled tile
   (P 24, N 16), batch 1 x 2,048 from a unit-scale initial state, P 128 /
   N 128, and B and C not 16-byte aligned (bf16 cases run the tensor-core
   kernels, fp32 cases the CUDA-core ones); two bf16 calls at the training
   shape bitwise equal; ``ops.ssd_scan`` under autograd
   launching the forward and then the backward kernel; ``matmul_f32``'s
   gradients at the lm_head's training shape against autograd of the fp32
   product (``MATMUL_GRAD_TOL``); flash attention's refusal of autograd;
3c. the Mamba2 mixer's two kernels (``csrc/ssm_mixer.cu``) against their
   plain versions by ``tests/test_torch_ssm_card.py`` in a subprocess; then,
   at mamba2-780m.prompt-2k's prefill shape (``MIXER_SHAPE``), each of them
   against its plain chain on the same inputs by the card tests' bars and
   both by CUDA-graph replay, beside the kernel's byte bound
   (``check_ssm_mixer``; the ``{"ssm_mixer": ...}`` line, which also carries
   each slice's launches);
3d. the dropless MoE's grouped expert products (``csrc/moe_grouped.cu``) at
   olmoe-1b-7b-0924.prompt-4k's shapes (``MOE_GROUPED_SHAPES``): the entry
   point for many rows an expert at the prefill's 8 x 4,080 tokens and the
   one for a few at a decode step's 8, each against the plain version on the
   same inputs (``moe_grouped_ok``), timed by CUDA-graph replay beside its
   bound over the experts hit, the plain version and, where this torch has
   it, ``torch._grouped_mm`` (a yardstick only), with the profiler's kernel
   names (``check_moe_grouped``; the ``{"moe_grouped": ...}`` line);
4. the slices, each at full width and full depth with random bf16 weights
   from a seeded ``torch.Generator``, serving batch 4, prompt 512, gen 32
   through ``repro_torch.launch.serve.generate``:

   * qwen2-1.5b (28 layers) on the flash route: 28 flash launches (one per
     layer, in the cached prefill); the prefill logits against the same
     prefill through the plain chunked attention route;
   * mamba2-780m (48 layers): 48 SSD-scan launches (one per layer, in the
     prefill; decode runs the O(1) recurrence in plain PyTorch) and 144 of
     each of the mixer's two kernels (``expected_launches``); each of the
     prefill's 48 scan calls and 48 calls of each mixer kernel against its
     plain version on the same inputs, and the prefill logits against the
     same prefill with the plain versions of the scan and the mixer's chain
     in place of the kernels (inside this script only, restored afterwards),
     measured against the plain route's own gap under another chunking (see
     ``SSM_FLOOR_FACTOR``);
   * olmoe-1b-7b (16 layers, 64 experts, top-8) on the flash route: 16 flash
     launches; the prefill logits against the plain chunked route, where
     routing flips between the two routes measured against the plain route's
     own gap between its two attention cores (see ``MOE_FLOOR_FACTOR``), and,
     with the flash route's experts pinned, against the dense bar; every MoE
     layer's capacity, dropped entries and routing flips (recorded inside the
     block, inside this script only); ``moe_block`` at its decode and prefill
     shapes under ``torch.cuda.set_sync_debug_mode("error")``;
   * zamba2-2.7b (54 mamba layers in nine groups, each followed by the one
     shared attention block, head dim 80): 54 SSD-scan, 9 flash and 162 of
     each mixer kernel's launches;
     the prefill logits against the plain route (plain scan and chunked
     attention), measured against the plain route's own gap under scan chunk
     64 and xla_full attention (see ``HYBRID_FLOOR_FACTOR``);
   * qwen2-vl-2b (28 layers, M-RoPE): text only through ``generate``, as the
     reference's launcher serves it, 28 flash launches; then one cached
     prefill through ``forward`` of 1,024 vision embeddings (a 32 x 32 patch
     grid at three distinct M-RoPE position streams) before 512 text
     tokens, with a cache sized for it (``vision_prefill``);
   * whisper-medium (24 encoder and 24 decoder layers) with 1,500 random
     frames and a prompt of 416 (416 + 32 = 448, its decoder context): 24
     flash launches, one per decoder self-attention; its encoder and every
     cross-attention are not causal and take the chunked route, as in the
     reference; every decode step reads the encoder's K/V from the cache.

   Every flash, scan and mixer-kernel call of each prefill is held against
   its plain version on the same inputs (the kernel's bf16 bar; the mixer's
   kernels by the card tests' bars).

   ``generate`` runs the prefill eager and the decode step as a captured
   CUDA graph, replayed through no wrapper (decode launches neither flash
   nor the scan; its mamba layers run the mixer's two kernels of phase 3c).
   Every launch counter is set to 0 just before ``generate`` and read just
   after; each kernel must show its launches of the slice
   (``expected_launches``) and no more.  The first generated token must be
   the prefill's argmax.  A reduced config of each model runs on the card
   against the CPU (prompt 24, olmoe's every ``moe_block`` call also on the
   card's inputs; mamba2 and zamba2 prompt 200, which crosses a chunk
   boundary with a ragged tail; the new slices' kernel calls held against
   their plain versions, see ``HYBRID_FLOOR_FACTOR``);
5b. olmoe-1b-7b-0924, the published OLMoE (QK-norm, raw top-8 of 64,
   dropless), at batch 4, prompt 512, gen 32: 16 flash and 48 grouped
   launches a ``generate`` (``expected_launches``), every grouped call of a
   prefill against the plain version, the first token against the prefill's
   argmax, the graph's tokens equal to eager decoding's, ``moe_block`` under
   sync debug mode "error", and its prefill, eager decode step and generate
   timed (``published_moe_slice``; the ``{"published_moe": ...}`` line);
5. timings from CUDA events after a warm-up, per slice: prefill, decode,
   tok/s and peak memory, and a torch.profiler pass over one prefill and one
   decode step (wall time, device-busy time, the device's idle share, the top
   kernels); for olmoe one layer's ``moe_block`` at both shapes, split into
   router + dispatch, expert products and combine, beside its bounds; per
   kernel at each of its slices' shapes: the kernel beside its plain
   version, its bound and, where one PyTorch call computes the same function,
   that call (``scaled_dot_product_attention`` for flash, timed as a
   yardstick only: the port never calls it; none for the SSD scan); the SSD
   scan also at batch 1 x 2,048 tokens (mamba2's shape), with its split
   among its kernels.  Each kernel, plain version and SDPA is timed by its
   device time per call from a CUDA graph of 20 back-to-back calls
   (``graph_ms``), beside its device time in torch.profiler (``device_ms``:
   the kernels' own time, summed over the kernels of 20 calls, over 20; the
   median of the three profiler sessions, among those that recorded the
   most kernels; None, "not measured", when no session recorded a kernel),
   and the back-to-back CUDA-event time per call
   (``event_ms``), which also counts the host whenever a call's dispatch
   outlasts its kernels; the MoE block's parts by ``device_ms``.
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
6c. the measurement runtime and the oracle service on the card, the launch
   counters set to 0 before and required to read 0 after: (a) phase 6's PR
   campaign again through ``RuntimeSpec(workers=1)`` and through a pool of
   two spawned workers, each with a journal and a trace: wall seconds, the
   pool's start-up, the runtime's counts and rate, the card's used memory
   over the run and each worker's allocator peaks, the two runs'
   measurements of the same configs against each other, and each run's
   PR-MAPE on phase 6's held-out configs; (b) ``ultratrail`` and
   ``tpu_v5e[gray]`` serial and pooled, predictions bitwise; a serial
   ``tpu_v5e[gray]`` run aborted by a fault plan and resumed from its journal
   by the pool, re-measuring no journaled row, then the launcher's ``--fsck``
   on that journal (exit 0); (c) ``python -m repro_torch.launch.serve
   --serve-oracle`` over the hub of (a) and (b), oracles on the card: eight
   client threads send predict requests, then ``predict_networks`` and
   ``autotune``, held against direct oracle calls (layers bitwise, networks
   within rtol 1e-12); latency, rate and batch sizes from ``stats``; SIGINT
   must drain it to exit code 0; (d) each trace of (a) through
   ``repro_torch.obs.report``.  Its findings are the ``"runtime"`` and
   ``"service"`` fields of the ``{"estimation": ...}`` line;
8. training (after 6c): (a) reduced mamba2-780m and qwen2-1.5b (remat
   "full", batch 2, seq 200): one train step on the card against the same
   step on the CPU, loss, grad norm and every gradient leaf within
   ``TRAIN_REL_L2``, and the scan launches the layers dictate (and no
   mixer kernel); (b)
   mamba2-780m at full width and depth through ``repro_torch.launch.train``'s
   ``Trainer``, batch 2 x 4,096 (``train_4k``'s sequence), random fp32
   masters from a seeded ``torch.Generator``, ``AdamWConfig(lr=1e-3,
   warmup_steps=0, total_steps=8)``: a run checkpointing every 2 steps fails
   at step 5 and resumes from step 4, and an uninterrupted run beside it
   must launch the forward scan 96 times a step (48 layers, and again in
   remat's recompute) and the backward 48 times, and neither of the mixer's
   kernels (training runs their plain chain), with finite losses, the
   last below the first, and the resumed losses and final parameters within
   ``RESUME_TOL`` of it; (c) qwen2-1.5b at full width and depth, 3 steps of
   ``make_train_step`` at the same shape, launching no kernel of the port.
   Each prints a ``train`` line: step ms (CUDA events, the median after the
   first step), tokens/s, peak memory, one step's device-busy ms, idle share
   and kernels (torch.profiler), launches per step, the losses and
   ``phase_seconds``; then the scan's forward and backward kernels are timed
   at the training shape beside their plain versions (CUDA events) and
   bounds; the resumed run's parameters wait on the host, so the
   uninterrupted run's peak is its own;
9. the dry run (after 8; ``dryrun_phase``): (a) the production cells of
   ``DRYRUN_CELLS``, each one full-depth step of ``repro_torch.launch.dryrun``
   as rank 0 of a fake process group of 256 (512) ranks over a ``"cuda"``
   mesh, on fake CUDA tensors (the kernels' fake implementations), printing
   per-rank argument and peak bytes, FLOPs, collective bytes by kind, the
   H100 roofline terms and the bottleneck, predictions for H100s; (b) the
   grounding cell, mamba2-780m at phase 8's shape on a 1 x 1 mesh, its
   predicted peak within ``DRYRUN_PEAK_TOL`` of phase 8's measured peak, its
   roofline step not above phase 8's median step, its FLOPs within
   ``DRYRUN_FLOP_RATIO`` of ``model_flops``; (c) no kernel launches; (d)
   within ``DRYRUN_SECONDS``;
7. the script's total seconds, a ``{"lint": ...}`` line, a ``{"slice": ...}``
   line per model (with its ``decode_graph`` and its seconds), a
   ``{"kernels": [...]}`` line (``launches`` sums ``launches_by_slice``, one
   entry per slice whose ``generate`` launched the kernel; the
   top-level times are at the kernel's first slice's shape and ``by_slice``
   holds each slice's; ``ms``, ``plain_ms`` and ``library_ms`` are device
   times per call by CUDA-graph replay (``graph_ms``, since slice 9: some
   profiler sessions recorded fewer kernels than were launched),
   ``profiler_ms`` and the other ``*_profiler_ms`` torch.profiler's
   (``device_ms``), ``event_ms`` and the other ``*_event_ms`` the CUDA-event
   times of back-to-back calls;
   ``bound_share`` is ``bound_ms / ms``; ``ssd_scan`` also counts the
   training run's launches and times, under ``"train mamba2-780m"``, and
   ``ssd_scan_bwd`` is timed at the training shape, its plain version by CUDA
   events, with its split among its kernels and its scratch bytes), a ``{"train": ...}`` line per model and a
   ``{"train_reduced": ...}`` line (phase 8), a ``{"dryrun": ...}`` line per
   cell and a ``{"dryrun_grounding": ...}`` line (phase 9), an
   ``{"estimation": ...}`` line,
   then the result line, last:
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import signal
import statistics
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
# zamba2-2.7b: 54 mamba layers and nine shared attention blocks amplify bf16
# steps as mamba2's 48 do, through both kernels; every scan and flash call of
# the kernel-route prefill is held against its plain version on the same
# inputs, and the end-to-end gap to the plain route may exceed the plain
# route's own gap under another scan chunking and the other attention core
# (chunk 64 and xla_full, both orders changed at once) by at most this factor.
# The reduced models of the new slices (zamba2's 12 mamba layers among them)
# are held likewise: BF16_TOL, or where it is missed this factor times the
# CPU's own gap between its plain routes, every kernel call on the card held
# against its plain version on the same inputs.
HYBRID_FLOOR_FACTOR = 1.25

# Phase 6: the campaigns' budget, the held-out set and the repeatability probe
EST_SAMPLES, EST_HELD_OUT, EST_REPEAT = 500, 300, 20
NET_RTOL = 1e-12  # networks on the card: index_add_ orders float64 sums freely
# Phase 6b: rows per analytic-platform hook call, the ultratrail held-out set,
# and the launcher estimate's campaign (the CLI's default; about 10 s on a CPU)
ANALYTIC_ROWS, ANALYTIC_HELD_OUT, ESTIMATE_SAMPLES = (1, 64, 257, 10_000), 1000, 400
# Phase 6c: the pool's size; how long a probe holds its worker (so that each
# of the pool's probes lands on a worker of its own); the submission ordinal
# from which the interrupted run's chunks all crash; the service's client
# threads, predict requests per thread and configs per request
RT_WORKERS, PROBE_HOLD_S, ABORT_AT = 2, 0.5, 6
SERVICE_CLIENTS, SERVICE_REQUESTS, SERVICE_CONFIGS = 8, 40, 16

BATCH, PROMPT, GEN, SEED = 4, 512, 32, 0
LONG_PROMPT = 2048  # one sequence of 16 scan chunks: the split's serial pass and parallelism
TRAIN_BATCH, TRAIN_SEQ = 2, 4096  # train_4k's sequence: 32 scan chunks a row
# Phase 8: mamba2-780m's runs (steps, checkpoint period, the step that fails),
# qwen2-1.5b's steps, and the kernels a training step may launch
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, QWEN_TRAIN_STEPS = 8, 2, 5, 3
TRAIN_KERNELS = ("flash_attention", "ssd_scan", "ssd_scan_bwd")
# The Mamba2 mixer's two kernels: serving launches them, a training step never
MIXER_KERNELS = ("ssm_conv_gate_in", "ssm_gate_norm")
# Every wrapper whose launches a phase counts
COUNTED_KERNELS = (*TRAIN_KERNELS, *MIXER_KERNELS)
# A reduced train step on the card against the CPU: loss, grad norm and every
# gradient leaf within a relative (L2) 2e-2, the CPU tests' bar against the
# reference (tests/test_torch_train.py); the card runs the bf16 scan kernels
# and cuBLAS, the CPU the plain fp32 scan, so their bf16 steps fall apart.
TRAIN_REL_L2 = 2e-2
# The resumed run against the uninterrupted one: every kernel of the step is
# deterministic (the scan's backward uses no atomics), so they should agree
# exactly; 1e-6 admits a library GEMM that picks another algorithm.
RESUME_TOL = 1e-6
WHISPER_PROMPT = 416  # prompt + GEN = 448 positions, whisper's decoder context
# The kernels a generate launches; the first two are also timed at each slice's shapes
KERNELS = ("flash_attention", "ssd_scan", *MIXER_KERNELS, "moe_grouped_mm")
SLICE_TIMED = KERNELS[:2]
SLICES = {  # arch -> (prompt length at full width, reduced prompt length for the card-vs-CPU check)
    "qwen2-1.5b": (PROMPT, 24),
    "mamba2-780m": (PROMPT, 200),
    "olmoe-1b-7b": (PROMPT, 24),
    "zamba2-2.7b": (PROMPT, 200),
    "qwen2-vl-2b": (PROMPT, 24),
    "whisper-medium": (WHISPER_PROMPT, 24),
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


def device_ms(fn, calls: int = 20, warmup: int = 3, sessions: int = 3, retries: int = 3) -> dict:
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
    spill them into it.  Sessions that all recorded no kernel are followed by
    up to ``retries`` more; if none of those records one either, ``ms`` is
    None ("not measured") and ``kernels`` 0.  Whole sessions have come back
    empty on the H100, three in a row once, with the kernels launched.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import phases

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    while len(runs) < sessions or (not any(r[1] for r in runs) and len(runs) < sessions + retries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls, repeat=1)) as prof:
            for i in range(1 + calls):
                fn()
                if i in (0, calls):  # a graph replay returns at once: keep its
                    torch.cuda.synchronize()  # warm-up call's kernels out of the window
                prof.step()
        # the port's phases are ranges of the profiler too (record_function), and each has a shadow
        # on the device's timeline under its own name: a range, not a kernel
        ranges = phases.names()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("ProfilerStep")  # the schedule's step range, not a kernel
                   and not e.is_user_annotation and e.key not in ranges]
        total_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(((e.key, e.self_device_time_total / 1e3 / calls) for e in kernels), key=lambda t: -t[1])
        runs.append((total_us / 1e3 / calls, sum(e.count for e in kernels) / calls, top))
    full = sorted((r for r in runs if r[1] == max(q[1] for q in runs)), key=lambda r: r[0])
    ms, kernels, top = full[len(full) // 2]
    if not kernels:
        log(f"torch.profiler recorded no kernel in {len(runs)} sessions: device time not measured")
        ms = None
    return {"ms": ms, "kernels": kernels, "top": top, "sessions_ms": [r[0] for r in runs],
            "sessions_kernels": [r[1] for r in runs]}


def fmt(x, spec: str = ".4f") -> str:
    """``x`` formatted, or "not measured" for a profiler time that is None."""
    return "not measured" if x is None else format(x, spec)


# On an H100 the profiler's kernel times over a CUDA-graph replay sum to up to 2.2 % more than the
# CUDA events around it; a profiler range counted as a kernel reads far lower (-0.29 and -1.30 seen)
IDLE_SLACK = 0.05


def idle_share(busy_ms, wall_ms: float):
    """The device's idle share of ``wall_ms``; raises outside [-IDLE_SLACK, 1], which no profile of
    the call's own kernels gives."""
    if busy_ms is None:
        return None
    share = 1.0 - busy_ms / wall_ms
    if not -IDLE_SLACK <= share <= 1.0:
        raise AssertionError(f"idle share {share:.3f} ({busy_ms:.3f} ms busy of {wall_ms:.3f}): the profile "
                             f"counts more than the call's kernels, or the wall time misses them")
    return share


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` back-to-back calls captured
    in one CUDA graph, its replays timed by CUDA events.  The host's dispatch
    stays out of the window (as in ``device_ms``), and no kernel can go
    missing from the count: torch.profiler sessions have recorded fewer
    kernels than the calls launched (SDPA 1.35 of its 2 a call), which
    times a call too fast.  Gaps between the graph's kernels are counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as torch.cuda.graphs asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def timed(fn, calls: int = 20, graph: bool = False) -> dict:
    """``fn`` by its device time (``device_ms``), by CUDA events (``event_ms``)
    and, with ``graph``, by CUDA-graph replay (``graph_ms``)."""
    out = {**device_ms(fn, calls), "event_ms": cuda_time_ms(fn, reps=calls)}
    if graph:
        out["graph_ms"] = graph_ms(fn, calls)
    return out


def _bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(q, k, causal: bool, q_offset: int = 0) -> tuple[float, str]:
    """Least time for the card: bytes of q, k, v, o once over HBM vs this run's
    FLOPs (``repro_torch.kernels.costs.flash_cost``, the kernel's FLOP formula)."""
    from repro_torch.kernels import costs

    b, sq, h, d = q.shape
    return _bound(*costs.flash_cost(b, sq, k.shape[1], h, k.shape[2], d, q.element_size(), causal, q_offset),
                  q.dtype)


def ssd_bound_ms(x, log_da, bmat, state0, chunk: int) -> tuple[float, str]:
    """Least time for the card: x, log_da, B, C, state0 read and y, state
    written once vs the FLOPs (``repro_torch.kernels.costs.ssd_cost``)."""
    from repro_torch.kernels import costs

    b, s, h, p = x.shape
    return _bound(*costs.ssd_cost(b, s, h, p, bmat.shape[-1], x.element_size(), chunk, state0 is not None),
                  x.dtype)


def check_flash() -> dict:
    """The flash kernel against its plain version at every test shape.

    Returns the largest error at each flash slice's prefill shape, by arch:
    zamba2's head dim 80 runs the kernel's padded 96-column tile, whisper's 64.
    """
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, b, sq, skv, h, kvh, d, dtype, causal, q_offset; an fp32 case runs in bf16 too
        ("qwen2-1.5b", BATCH, PROMPT, PROMPT + GEN, 12, 2, 128, torch.bfloat16, True, 0),
        ("olmoe-1b-7b", BATCH, PROMPT, PROMPT + GEN, 16, 16, 128, torch.bfloat16, True, 0),
        ("zamba2-2.7b", BATCH, PROMPT, PROMPT + GEN, 32, 32, 80, torch.bfloat16, True, 0),
        ("qwen2-vl-2b", BATCH, PROMPT, PROMPT + GEN, 12, 2, 128, torch.bfloat16, True, 0),
        ("whisper-medium", BATCH, WHISPER_PROMPT, WHISPER_PROMPT + GEN, 16, 16, 64, torch.bfloat16, True, 0),
        ("mha d80 fp32", 1, 200, 232, 4, 4, 80, torch.float32, True, 32),
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
        ("zamba2-2.7b", BATCH, PROMPT, 80, 64, 64, bf16, True, 128, 128),
        ("ragged s200 state0", 2, 200, 8, 64, 128, f32, True, 128, 128),
        ("reduced p32 n16", 2, 200, 8, 32, 16, bf16, True, 128, 128),
        ("part tile p24 n16", 1, 300, 4, 24, 16, f32, True, 64, 64),
        ("chunk 64 vs 128 f32", 2, 300, 8, 64, 128, f32, True, 64, 128),
        ("chunk 64 vs 128 slice", BATCH, PROMPT, 48, 64, 128, bf16, True, 64, 128),
        ("one chunk bf16", 2, 100, 8, 64, 128, bf16, True, 128, 128),
        ("long chain s2048", 1, LONG_PROMPT, 48, 64, 128, bf16, True, 128, 128),
        ("train mamba2-780m", TRAIN_BATCH, TRAIN_SEQ, 48, 64, 128, bf16, False, 128, 128),
    ]
    slice_err = {}
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
        if name in SLICES or name.startswith("train "):
            slice_err[name] = max(err_y, err_s)
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
    return slice_err


MIXER_SHAPE = (32, 2032, 48, 64, 128, 4)  # mamba2-780m.prompt-2k's prefill: batch, seq, heads, head dim, state, taps


def check_ssm_mixer() -> dict:
    """Phase 3c: the Mamba2 mixer's two kernels (``csrc/ssm_mixer.cu``) against their plain
    versions by ``tests/test_torch_ssm_card.py`` (pytest in a subprocess: bit for bit in
    99.9 % of elements and within one step of the dtype, or within one bf16 step, at
    four shapes), then timed (``time_ssm_mixer``)."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
         "tests/test_torch_ssm_card.py"],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    log(f"tests/test_torch_ssm_card.py: exit {proc.returncode}, {summary}")
    if proc.returncode != 0:
        raise AssertionError(f"the mixer's kernels fail their card tests:\n{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    return {**time_ssm_mixer(), "card_tests": summary, "seconds": time.perf_counter() - t0}


def time_ssm_mixer() -> dict:
    """Each of the mixer's kernels against its plain chain on the same inputs at ``MIXER_SHAPE``
    (the card tests' bars: ``mixer_front_ok``, ``mixer_back_ok``), then both by CUDA-graph
    replay, beside the kernel's byte bound (``costs.ssm_conv_gate_in_cost``,
    ``costs.ssm_gate_norm_cost``)."""
    import torch

    from repro_torch.kernels import costs, ops, ref

    b, s, h, p, n, k = MIXER_SHAPE
    ci, bf = h * p, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    f32 = dict(dtype=torch.float32, device="cuda")
    front = (rnd(b, s, ci), rnd(b, s, n), rnd(b, s, n), rnd(b, s, h), rnd(k, ci, scale=0.5), rnd(ci, scale=0.1),
             rnd(k, n, scale=0.5), rnd(n, scale=0.1), rnd(k, n, scale=0.5), rnd(n, scale=0.1),
             torch.full((h,), math.log(math.expm1(0.01)), **f32), torch.log(torch.linspace(1.0, 16.0, h, **f32)),
             torch.zeros((b, k - 1, ci), **f32), torch.zeros((b, k - 1, n), **f32), torch.zeros((b, k - 1, n), **f32))
    back = (rnd(b, s, h, p), front[0], rnd(b, s, ci), torch.ones((h,), **f32), torch.ones((ci,), **f32), 1e-5)
    out = {"shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "k": k}}
    for name, kernel, plain, args, cost, bars in (
        ("ssm_conv_gate_in", ops.ssm_conv_gate_in, ref.ssm_conv_gate_in_ref, front,
         costs.ssm_conv_gate_in_cost(b, s, ci, n, h, k, True), mixer_front_ok),
        ("ssm_gate_norm", ops.ssm_gate_norm, ref.ssm_gate_norm_ref, back, costs.ssm_gate_norm_cost(b, s, ci, h, True),
         mixer_back_ok),
    ):
        got = kernel(*args)
        torch.cuda.synchronize()
        ok, same, steps = bars(got, plain(*args))
        torch.cuda.synchronize()
        del got
        log(f"kernel {name} at prompt-2k's shape against its plain chain on the same inputs: least share "
            f"bit-equal {same:.6f}, most steps apart {steps} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain chain at prompt-2k's shape")
        ms, plain_ms = graph_ms(lambda: kernel(*args)), graph_ms(lambda: plain(*args), calls=5)
        bound_ms, bound_by = _bound(*cost, bf)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_share": bound_ms / ms, "bytes": cost[0], "share_bit_equal": same, "most_steps_apart": steps}
        log(f"kernel {name} at prompt-2k's shape (b {b}, s {s}, width {ci}, state {n}): {ms:.4f} ms a call by "
            f"CUDA-graph replay, plain chain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{cost[0] / 1e9:.3f} GB), bound share {bound_ms / ms:.3f}")
    return out


# The dropless MoE's grouped expert products (csrc/moe_grouped.cu) at olmoe-1b-7b-0924.prompt-4k's
# shapes, (tokens, top-k, experts, d_model, d_ff): the prefill's 8 x 4,080 tokens (the entry point for
# many rows an expert) and a decode step's 8 (the one for a few).
MOE_GROUPED_SHAPES = {"prefill": (8 * 4080, 8, 64, 2048, 1024), "decode": (8, 8, 64, 2048, 1024)}
# Both versions round each product once to bf16 and silu at each of its steps, but the tensor cores
# sum in another order than cuBLAS, so a sum that lies on a bf16 rounding boundary may round the
# other way: an element of h one step off moves y by one term in 1,024, and y's own sum may tip.  So
# every element within BF16_TOL, a relative L2 gap under MOE_GROUPED_REL_L2 (one bf16 step is 2^-8,
# 3.9e-3, of an element), and at least MOE_GROUPED_EQUAL of y's elements bit-equal.  A wrong row,
# expert or column reads about 1.
MOE_GROUPED_REL_L2 = 1e-2
MOE_GROUPED_EQUAL = 0.9
PUBLISHED_MOE = "olmoe-1b-7b-0924"


def moe_grouped_inputs(tokens: int, top_k: int, experts: int, d: int, f: int, seed: int):
    """``ops.moe_grouped_mm``'s arguments for ``tokens`` RMS-normed rows routed by a random router
    (raw top-k, ``models.moe.route``) and sorted by expert (``models.moe.sort_entries``), with
    N(0, 1/fan_in) experts; and the number of experts hit."""
    import torch

    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, fan_in):
        return (torch.randn(shape, generator=gen, device="cuda") / math.sqrt(fan_in)).bfloat16()

    x = rnd(tokens, d, fan_in=1)
    w_in, w_gate, w_out = rnd(experts, d, f, fan_in=d), rnd(experts, d, f, fan_in=d), rnd(experts, f, d, fan_in=f)
    _, top_i, _ = moe.route(x, rnd(d, experts, fan_in=d), top_k, False)
    src, dst, offsets = moe.sort_entries(top_i, experts)
    hit = int((offsets[1:] > offsets[:-1]).sum())
    return (x, w_in, w_gate, w_out, src, dst, offsets), hit


def moe_grouped_ok(got, want) -> tuple[bool, float, float]:
    """(within the bars, relative L2 gap, share of elements bit-equal)."""
    import torch

    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    same = (got == want).float().mean().item()
    close = torch.allclose(got.float(), want.float(), **BF16_TOL)
    return close and rel <= MOE_GROUPED_REL_L2 and same >= MOE_GROUPED_EQUAL, rel, same


def grouped_mm_library(args, calls: int):
    """The same function through ``torch._grouped_mm`` (the rows gathered, three grouped products, silu
    and the product in bf16, the rows scattered to their entries), by graph replay: (ms, how), or
    (None, why) where this torch has no such call or refuses the operands."""
    import torch
    import torch.nn.functional as F

    if not hasattr(torch, "_grouped_mm"):
        return None, "this torch has no _grouped_mm"
    x, w_in, w_gate, w_out, src, dst, offsets = args
    ends = offsets[1:]

    def run(wi, wg, wo):
        xs = x[src.long()]
        h = torch._grouped_mm(xs, wi, offs=ends) * F.silu(torch._grouped_mm(xs, wg, offs=ends))
        return torch.empty_like(xs).index_copy_(0, dst.long(), torch._grouped_mm(h, wo, offs=ends))

    why = ""
    for how in ("row-major weights", "column-major weights"):
        ws = (w_in, w_gate, w_out)
        if how.startswith("column"):
            ws = tuple(w.transpose(-2, -1).contiguous().transpose(-2, -1) for w in ws)
        try:
            run(*ws)
            torch.cuda.synchronize()
            return graph_ms(lambda: run(*ws), calls=calls, reps=3), how
        except RuntimeError as exc:
            why = f"{how}: {str(exc).splitlines()[0][:160]}"
    return None, why


def check_moe_grouped() -> dict:
    """Phase 3d: both entry points of the grouped expert products against the plain version on the
    same inputs at the cell's prefill and decode shapes (``moe_grouped_ok``), then timed by CUDA-graph
    replay beside the bound (``costs.moe_grouped_cost`` over the experts hit), the plain version (CUDA
    events: it reads the offsets on the host) and ``torch._grouped_mm``; the profiler's kernel names
    of one call."""
    import torch

    from repro_torch.kernels import costs, ops, ref

    t0 = time.perf_counter()
    out = {}
    for shape, (t, k, e, d, f) in MOE_GROUPED_SHAPES.items():
        args, hit = moe_grouped_inputs(t, k, e, d, f, SEED + 11)
        got, want = ops.moe_grouped_mm(*args), ref.moe_grouped_mm_ref(*args)
        torch.cuda.synchronize()
        ok, rel, same = moe_grouped_ok(got, want)
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        log(f"kernel moe_grouped_mm at the {shape} shape (T {t}, top {k} of {e}, D {d}, F {f}; {hit} experts hit) "
            f"against its plain version: rel L2 {rel:.3e}, share bit-equal {same:.6f}, max abs {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"moe_grouped_mm disagrees with its plain version at the {shape} shape")
        calls = 3 if shape == "prefill" else 20
        ms = graph_ms(lambda: ops.moe_grouped_mm(*args), calls=calls, reps=3)
        plain_ms = cuda_time_ms(lambda: ref.moe_grouped_mm_ref(*args), reps=3, warmup=1)
        library_ms, library_how = grouped_mm_library(args, calls)
        cost = costs.moe_grouped_cost(t * k, hit, d, f)
        bound_ms, bound_by = _bound(*cost, torch.bfloat16)
        prof = device_ms(lambda: ops.moe_grouped_mm(*args), calls=2, warmup=1, sessions=1)
        out[shape] = {"tokens": t, "rows": t * k, "experts_hit": hit, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "library": library_how, "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_share": bound_ms / ms, "bytes": cost[0], "flops": cost[1], "rel_l2": rel,
                      "share_bit_equal": same, "max_abs_err": err,
                      "kernels": [[name, kms] for name, kms in prof["top"][:4]]}
        log(f"kernel moe_grouped_mm {shape}: {ms:.4f} ms a call by CUDA-graph replay, plain {plain_ms:.4f} ms, "
            f"torch._grouped_mm {fmt(library_ms)} ms ({library_how}), bound {bound_ms:.4f} ms ({bound_by}), "
            f"bound share {bound_ms / ms:.3f}; profiled kernels "
            + "; ".join(f"{name[:48]} {kms:.4f}" for name, kms in prof["top"][:4]))
    out["seconds"] = time.perf_counter() - t0
    return out


def published_moe_slice() -> dict:
    """Phase 5b: olmoe-1b-7b-0924 (QK-norm, raw top-8 of 64, dropless) served at full width through
    ``generate``: its launches against ``expected_launches``, every grouped call of a prefill against
    the plain version on the same inputs, the first token against the prefill's argmax, the graph's
    tokens against eager decoding, ``moe_block`` under sync debug mode "error", and the prefill,
    decode step and generate timed."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = slice_config(PUBLISHED_MOE)
    expected = expected_launches(cfg)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, size=(BATCH, PROMPT))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cuda")
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"generate {PUBLISHED_MOE}: tokens {tuple(tokens.shape)}, launches {launches} (expected {expected}), "
        f"peak memory {peak_gib:.2f} GiB")
    assert launches == expected, f"{PUBLISHED_MOE}: launches {launches}, expected {expected}"

    errors = []
    launch = ops._moe_launch

    def checked(*args):
        y = launch(*args)
        errors.append(moe_grouped_ok(y, ref.moe_grouped_mm_ref(*args)))
        return y

    batch = {"tokens": torch.as_tensor(prompts, device="cuda")}
    ops._moe_launch = checked
    try:
        with torch.no_grad():
            logits = T.forward(params, cfg, batch, slice_cache(cfg, BATCH, PROMPT + GEN, "cuda"))[0]
    finally:
        ops._moe_launch = launch
    worst = max(e[1] for e in errors)
    log(f"{PUBLISHED_MOE} prefill: {len(errors)} grouped calls against the plain version, worst rel L2 {worst:.3e}, "
        f"least share bit-equal {min(e[2] for e in errors):.6f}")
    assert len(errors) == cfg.n_layers and all(e[0] for e in errors), f"{PUBLISHED_MOE}: a grouped call disagrees"
    assert torch.equal(tokens[:, 0], logits[:, -1].argmax(-1)), "first token != prefill argmax"
    del logits
    with torch.no_grad():
        eager = eager_generate(cfg, params, prompts, {}, PROMPT)
    assert torch.equal(eager, tokens), f"{PUBLISHED_MOE}: the graph's tokens differ from eager decoding"
    sync_free = check_moe_sync_free(cfg, params["layers"][0]["moe"])

    with torch.no_grad():
        cache = slice_cache(cfg, BATCH, PROMPT + GEN, "cuda")
        prefill_ms = cuda_time_ms(lambda: T.forward(params, cfg, batch, cache), reps=3)
        base = T.forward(params, cfg, batch, cache)[2]
        step_tok = tokens[:, :1]
        decode_ms = cuda_time_ms(lambda: T.forward(params, cfg, {"tokens": step_tok}, with_len(base, PROMPT)),
                                 reps=5)
        gen_ms = cuda_time_ms(lambda: generate(cfg, params, prompts, GEN, device="cuda"), reps=3, warmup=1)
    line = {"arch": PUBLISHED_MOE, "batch": BATCH, "prompt": PROMPT, "gen": GEN,
            "parameters": sum(t.numel() for t in _leaves(params)), "launches": launches, "peak_gib": peak_gib,
            "grouped_calls_worst_rel_l2": worst, "graph_tokens_equal_eager": True, "sync_free": sync_free,
            "prefill_ms": prefill_ms, "eager_decode_step_ms": decode_ms, "generate_ms": gen_ms,
            "generate_tok_s": BATCH * GEN / gen_ms * 1e3, "phase_seconds": time.perf_counter() - t0}
    log(f"{PUBLISHED_MOE} prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms; eager decode step {decode_ms:.3f} ms; "
        f"generate {BATCH}x{GEN}: {gen_ms:.3f} ms ({line['generate_tok_s']:.1f} tok/s)")
    return line


# The backward kernel's bars, each scaled by the largest magnitude of the
# gradient it holds (gradients of long chunks sum many terms, so an absolute
# bar fixed in advance would be loose for some and tight for others): fp32
# atol = 2e-5 * max|g_ref| and rtol 2e-4, the XLA twin's bar
# (tests/test_torch_ssm.py) scaled to the gradient; bf16 inputs
# atol = 2e-2 * max|g_ref| and rtol 5e-2, the scan's own bf16 bar.  Both
# versions start from the same (bf16-rounded) inputs.  In fp32 they differ by
# the order of their fp32 sums; in bf16 the kernel also rounds its operands
# at the points its source note lists (states, intra-chunk weights, decayed
# rows) and dx, dB, dC once on the way out.
SSD_BWD_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 5e-2)}
# matmul_f32's backward against autograd of the same product in fp32: both
# take one fp32 GEMM and round once to bf16, in cuBLAS's sum order each, so
# they may differ by one bf16 step (2^-8 relative) where a sum lands near a
# rounding boundary.
MATMUL_GRAD_TOL = dict(atol=0.0, rtol=2 ** -7)


def _within(got, want, atol_frac: float, rtol: float) -> tuple[bool, float]:
    """``got`` within atol = ``atol_frac`` * max|want| and ``rtol`` of ``want``, all finite; and the max abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol_frac * want.abs().max() + rtol * want.abs()).all()) and bool(got.isfinite().all())
    return ok, err.max().item()


def check_ssd_bwd() -> dict:
    """Phase 3b: the scan's backward kernel against its plain version
    (autograd of ``ssd_scan_ref``), every gradient within ``SSD_BWD_TOL``, at
    ten shapes in fp32 (the CUDA-core kernels) and bf16 (the tensor-core
    kernels); two bf16 calls at the training shape bitwise equal; B and C
    misaligned; ``matmul_f32``'s gradients; flash's refusal under autograd.
    Returns the largest error over the gradients at mamba2-780m's training
    shape."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, b, s, h, p, n, chunk, state0, d(final state); each in fp32 and bf16
        ("test_kernels n64", 2, 256, 4, 64, 64, 128, False, False),
        ("test_kernels ragged", 1, 300, 8, 64, 128, 128, False, False),
        ("test_kernels n16", 1, 128, 2, 32, 16, 128, False, False),
        ("mamba2-780m train", 2, TRAIN_SEQ, 48, 64, 128, 128, False, False),
        ("zamba2-2.7b train", 2, TRAIN_SEQ, 80, 64, 64, 128, False, False),
        ("ragged s200 state0 dstate", 2, 200, 8, 64, 128, 128, True, True),
        ("chunk 64", 2, 300, 8, 64, 128, 64, True, True),
        ("part tile p24 n16", 1, 300, 4, 24, 16, 64, True, True),
        ("long chain s2048", 1, LONG_PROMPT, 48, 64, 128, 128, True, True),
        ("p128 n128", 2, 300, 8, 128, 128, 128, True, True),
    ]
    names = ("dx", "dlog_da", "dB", "dC", "dstate0")
    train_err = 0.0
    for name, b, s, h, p, n, chunk, state, dstate in cases:
        for dt in (f32, bf16):
            x, la, bm, cm, s0 = ssd_inputs(gen, b, s, h, p, n, dt, state)
            dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dt)
            ds = torch.randn((b, h, p, n), generator=gen, device="cuda") if dstate else None
            got = ops.ssd_scan_bwd(x, la, bm, cm, dy, ds, chunk=chunk, state0=s0)
            torch.cuda.synchronize()
            zero = torch.zeros((b, h, p, n), device="cuda")
            want = ref.ssd_scan_bwd_ref(x, la, bm, cm, dy, zero if ds is None else ds, chunk=chunk, state0=s0)
            torch.cuda.synchronize()
            atol_frac, rtol = SSD_BWD_TOL[str(dt)[6:]]
            errs, ok = [], True
            for g_name, g, w in zip(names, got, want):
                good, err = _within(g, w, atol_frac, rtol)
                good = good and g.dtype == w.dtype and g.shape == w.shape
                errs.append(f"{g_name} {err:.2e} (max|g| {w.float().abs().max().item():.2e})")
                ok = ok and good
                if name == "mamba2-780m train" and dt == bf16:
                    train_err = max(train_err, err)
            log(f"kernel ssd_scan_bwd [{name}] x{tuple(x.shape)} n={n} {str(dt)[6:]} chunk {chunk} "
                f"state0={state} dstate={dstate}: max_abs_err {'; '.join(errs)} (atol={atol_frac:g} max|g_ref| "
                f"rtol={rtol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ssd_scan_bwd [{name}] {dt} disagrees with its plain version")
    # two bf16 calls at mamba2-780m's training shape return the same bits (no
    # atomics, every sum in a fixed order): the trainer's resume relies on it
    x, la, bm, cm, _ = ssd_inputs(gen, TRAIN_BATCH, TRAIN_SEQ, 48, 64, 128, bf16, False)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(bf16)
    first = ops.ssd_scan_bwd(x, la, bm, cm, dy, None)
    again = ops.ssd_scan_bwd(x, la, bm, cm, dy, None)
    same = all(torch.equal(u, v) for u, v in zip(first, again))
    log(f"kernel ssd_scan_bwd x{tuple(x.shape)} bf16, two calls on the same inputs: "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("ssd_scan_bwd is not bitwise repeatable")
    del x, la, bm, cm, dy, first, again
    # B and C not 16-byte aligned (the kernel loads them element by element)
    x, la, bm, cm, s0 = ssd_inputs(gen, 2, 300, 4, 64, 128, bf16, True)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(bf16)
    ds = torch.randn((2, 4, 64, 128), generator=gen, device="cuda")
    odd = []
    for t in (bm, cm):
        o = torch.empty(t.numel() + 1, dtype=bf16, device="cuda")[1:].view(t.shape)
        o.copy_(t)
        odd.append(o)
    assert all(o.data_ptr() % 16 for o in odd)
    got = ops.ssd_scan_bwd(x, la, *odd, dy, ds, state0=s0)
    want = ref.ssd_scan_bwd_ref(x, la, bm, cm, dy, ds, state0=s0)
    errs = [_within(g, w, *SSD_BWD_TOL["bfloat16"]) for g, w in zip(got, want)]
    ok = all(e[0] for e in errs)
    log(f"kernel ssd_scan_bwd [misaligned B and C] x{tuple(x.shape)} bf16: max_abs_err "
        f"{'; '.join(f'{n} {e[1]:.2e}' for n, e in zip(names, errs))} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ssd_scan_bwd [misaligned B and C] disagrees with its plain version")
    # through the autograd function: the forward kernel, then the backward kernel
    x, la, bm, cm, _ = ssd_inputs(gen, 2, 300, 8, 64, 128, bf16, False)
    leaves = [t.clone().requires_grad_() for t in (x, la, bm, cm)]
    fwd0, bwd0 = ops.ssd_scan.launches, ops.ssd_scan_bwd.launches
    y, _ = ops.ssd_scan(*leaves)
    y.float().square().sum().backward()
    launched = (ops.ssd_scan.launches - fwd0, ops.ssd_scan_bwd.launches - bwd0)
    want = ref.ssd_scan_bwd_ref(x, la, bm, cm, (2 * y.float()).to(bf16).detach(),
                                torch.zeros((2, 8, 64, 128), device="cuda"))
    ok = launched == (1, 1) and all(_within(t.grad, w, *SSD_BWD_TOL["bfloat16"])[0] for t, w in zip(leaves, want))
    log(f"ssd_scan under autograd: launches (forward, backward) {launched}; gradients "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ssd_scan's autograd function does not run the two kernels or disagrees")

    # matmul_f32: the lm_head's product at mamba2-780m's training shape
    m, k, nv = 2 * TRAIN_SEQ, 1536, 50280
    a = (torch.randn((m, k), generator=gen, device="cuda")).to(bf16).requires_grad_()
    w = (torch.randn((k, nv), generator=gen, device="cuda") * k ** -0.5).to(bf16).requires_grad_()
    g = torch.randn((m, nv), generator=gen, device="cuda") * 1e-3
    out = L.matmul_f32(a, w)
    ga, gw = torch.autograd.grad(out, (a, w), g)
    a2, w2 = a.detach().requires_grad_(), w.detach().requires_grad_()
    ra, rw = torch.autograd.grad(torch.mm(a2.float(), w2.float()), (a2, w2), g)
    ok = out.dtype == f32 and ga.dtype == gw.dtype == bf16 and all(
        torch.allclose(x_.float(), y_.float(), **MATMUL_GRAD_TOL) for x_, y_ in ((ga, ra), (gw, rw)))
    log(f"matmul_f32 ({m}x{k}) x ({k}x{nv}) gradients against autograd of the fp32 product: da max abs "
        f"{(ga.float() - ra.float()).abs().max().item():.3e}, dw {(gw.float() - rw.float()).abs().max().item():.3e} "
        f"(rtol {MATMUL_GRAD_TOL['rtol']:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("matmul_f32's gradients disagree with autograd of the fp32 product")
    del a, w, g, out, ga, gw, a2, w2, ra, rw

    q = torch.randn((1, 64, 2, 64), device="cuda", dtype=bf16).requires_grad_()
    try:
        ops.flash_attention(q, q, q)
    except RuntimeError as e:
        log(f"kernel flash_attention refuses autograd: {e}")
    else:
        raise AssertionError("flash_attention ran under autograd")
    with torch.no_grad():
        ops.flash_attention(q, q, q)  # and still runs without grad
    torch.cuda.empty_cache()
    return {"mamba2-780m": train_err}


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


def clone_tree(tree):
    """A cache with every tensor cloned (nested dicts and tuples kept)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def cache_tensors(tree, prefix: str = ""):
    """(path, tensor) of every cache buffer but the lengths."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k != "len":
                yield from cache_tensors(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from cache_tensors(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def set_len_(cache: dict, n: int) -> None:
    """Every ``len`` of ``cache`` (the hybrid's per-group lengths too) set to ``n`` in place."""
    cache["len"].fill_(n)
    if "attn" in cache:
        cache["attn"]["len"].fill_(n)


def with_len(cache: dict, n: int) -> dict:
    """The same buffers behind fresh ``len`` tensors set to ``n``."""
    import torch

    out = {**cache, "len": torch.full((), n, dtype=torch.int32, device=cache["len"].device)}
    if "attn" in cache:
        out["attn"] = {**cache["attn"], "len": torch.full_like(cache["attn"]["len"], n)}
    return out


def slice_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.family != "ssm":
        cfg = dataclasses.replace(cfg, attention_impl="flash_pallas")
    return cfg


def expected_launches(cfg) -> dict:
    """Each kernel's launches in one ``generate``: one per causal attention
    layer of the prefill (whisper's encoder and cross-attention are not
    causal; zamba2 runs its shared block once per group) and one scan per
    mamba layer; decode launches neither.  Each of the mixer's two kernels
    runs three times a mamba layer: in the prefill, in the decode step's
    eager warm-up and while the graph records (the replays go through no
    wrapper).  A prefill alone launches each of them once a mamba layer.
    The grouped expert products of a dropless MoE (``moe_grouped_mm``) run
    three times a MoE layer likewise, the prefill's call through the entry
    point for many rows an expert, the decode step's through the one for a
    few."""
    if cfg.family == "ssm":
        attn = 0
    elif cfg.family == "hybrid":
        attn = cfg.n_layers // cfg.attn_every
    else:
        attn = cfg.n_layers
    mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    dropless = cfg.n_layers if getattr(cfg, "moe_dropless", False) else 0
    return {"flash_attention": attn, "ssd_scan": mamba, **dict.fromkeys(MIXER_KERNELS, 3 * mamba),
            "moe_grouped_mm": 3 * dropless}


def slice_extras(cfg, batch: int, seed: int) -> dict:
    """``generate``'s other inputs, as the launcher makes them: whisper's
    0.1-scaled random frames (the conv frontend is a stub); none else."""
    import numpy as np

    if cfg.family != "audio":
        return {}
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1}


def slice_cache(cfg, batch: int, max_len: int, dev) -> dict:
    """A prefill's empty cache; whisper's encoder K/V come from the prefill."""
    from repro_torch.models.kvcache import init_cache

    cache = init_cache(cfg, batch, max_len, dev)
    cache.pop("enc_kv", None)
    return cache


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
    """The same model through its kernels' plain versions: yields the config to run.

    ``chunk`` sets the plain SSD scan's chunk length (default: the config's);
    ``attention`` the plain attention core of every family with attention.
    """
    from repro_torch.kernels import ref

    run_cfg = cfg if cfg.family == "ssm" else dataclasses.replace(cfg, attention_impl=attention)
    if cfg.family not in ("ssm", "hybrid"):
        yield run_cfg
        return

    def plain(x, la, bm, cm, cfg_chunk, state0=None):
        return ref.ssd_scan_ref(x, la, bm, cm, chunk=chunk or cfg_chunk, state0=state0)

    def gate_in(*args):
        return ref.ssm_conv_gate_in_ref(*args)

    def gate_norm(*args):
        return ref.ssm_gate_norm_ref(*args)

    with scan_replaced(plain), mixer_replaced(gate_in, gate_norm):
        yield run_cfg


@contextlib.contextmanager
def mixer_replaced(gate_in, gate_norm):
    """Run the Mamba2 mixer's chain through ``gate_in`` and ``gate_norm`` in place of
    ``ops.ssm_conv_gate_in`` and ``ops.ssm_gate_norm`` inside the block; restore them after.
    The kernels count their launches on the module's names, so each count moves to the
    replacement while it stands there, and back."""
    from repro_torch.kernels import ops

    kept = (ops.ssm_conv_gate_in, ops.ssm_gate_norm)
    for new, old in zip((gate_in, gate_norm), kept):
        new.launches = old.launches
    ops.ssm_conv_gate_in, ops.ssm_gate_norm = gate_in, gate_norm
    try:
        yield
    finally:
        for new, old in zip((gate_in, gate_norm), kept):
            old.launches = new.launches
        ops.ssm_conv_gate_in, ops.ssm_gate_norm = kept


@contextlib.contextmanager
def flashes_checked(errors: list):
    """Hold every flash-kernel call of the model against its plain version on the same inputs."""
    import torch

    from repro_torch.kernels import ops, ref

    kernel = ops.flash_attention

    def checked(q, k, v, *, causal=True, q_offset=0):
        o = kernel(q, k, v, causal=causal, q_offset=q_offset)
        r = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
        errors.append(((o.float() - r.float()).abs().max().item(), tuple(q.shape), tuple(k.shape),
                       torch.allclose(o.float(), r.float(), **BF16_TOL)))
        return o

    # the kernel counts its launches on the module's name, this wrapper while it stands there
    checked.launches = kernel.launches
    ops.flash_attention = checked
    try:
        yield
    finally:
        kernel.launches = checked.launches
        ops.flash_attention = kernel


def kernels_checked(stack: contextlib.ExitStack, cfg, scan_errors: list, flash_errors: list,
                    mixer_errors: list) -> None:
    """Enter the checks of every kernel that ``cfg``'s prefill launches."""
    expected = expected_launches(cfg)
    if expected["ssd_scan"]:
        stack.enter_context(scans_checked(scan_errors))
        stack.enter_context(mixers_checked(mixer_errors))
    if expected["flash_attention"]:
        stack.enter_context(flashes_checked(flash_errors))


def checked_summary(name: str, errors: list, tol: dict) -> str:
    """One line on a prefill's kernel calls held against their plain versions
    (each call's record: its largest error first, whether it is within ``tol`` last)."""
    if not errors:
        return f"no {name} calls"
    ok = sum(bool(e[-1]) for e in errors)
    return (f"each of {len(errors)} {name} calls vs its plain version on the same inputs: max abs err "
            f"{max(e[0] for e in errors):.3e} (atol={tol['atol']:g} rtol={tol['rtol']:g}), {ok} of {len(errors)} ok")


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


def mixer_bars():
    """``steps_apart`` of the mixer's card tests (``tests/torch_ssm_mixer_cases.py``) and the
    names of the front kernel's outputs, whose first five are values and last three conv buffers."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from torch_ssm_mixer_cases import FRONT_OUTS, steps_apart

    return steps_apart, FRONT_OUTS


def mixer_front_ok(got, want) -> tuple[bool, float, int]:
    """The front kernel's bars against its plain chain on the same inputs, as the card tests hold
    it: each value output equal bit for bit in at least 99.9 % of elements and within one step of
    its dtype everywhere, the conv buffers equal.  -> (ok, least share equal, most steps apart)."""
    import torch

    steps_apart, outs = mixer_bars()
    gaps = [steps_apart(g, w) for g, w in zip(got[:5], want[:5])]
    buffers = all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got[5:], want[5:]))
    same, steps = min(g[0] for g in gaps), max(g[1] for g in gaps)
    return buffers and len(got) == len(want) == len(outs) and same >= 0.999 and steps <= 1, same, steps


def mixer_back_ok(got, want) -> tuple[bool, float, int]:
    """The back kernel's bar against its plain chain on the same inputs: within one bf16 step
    everywhere.  -> (ok, share equal, most steps apart)."""
    steps_apart, _ = mixer_bars()
    same, steps = steps_apart(got, want)
    return steps <= 1, same, steps


@contextlib.contextmanager
def mixers_checked(errors: list):
    """Hold every call of the mixer's two kernels against its plain chain on the same inputs
    (``mixer_front_ok``, ``mixer_back_ok``); each record is (kernel, share equal, most steps
    apart, ok)."""
    from repro_torch.kernels import ops, ref

    front, back = ops.ssm_conv_gate_in, ops.ssm_gate_norm

    def gate_in(*args):
        got = front(*args)
        ok, same, steps = mixer_front_ok(got, ref.ssm_conv_gate_in_ref(*args))
        errors.append(("ssm_conv_gate_in", same, steps, ok))
        return got

    def gate_norm(*args):
        got = back(*args)
        ok, same, steps = mixer_back_ok(got, ref.ssm_gate_norm_ref(*args))
        errors.append(("ssm_gate_norm", same, steps, ok))
        return got

    with mixer_replaced(gate_in, gate_norm):
        yield


def mixer_summary(errors: list) -> str:
    """One line on a prefill's mixer-kernel calls held against their plain chain."""
    parts = []
    for name in MIXER_KERNELS:
        mine = [e for e in errors if e[0] == name]
        if mine:
            parts.append(f"each of {len(mine)} {name} calls vs its plain chain on the same inputs: least share "
                         f"bit-equal {min(e[1] for e in mine):.6f}, most steps apart {max(e[2] for e in mine)}, "
                         f"{sum(bool(e[-1]) for e in mine)} of {len(mine)} ok")
    return "; ".join(parts) or "no mixer calls"


def mixer_calls_ok(errors: list, cfg) -> bool:
    """Every mixer call within its bars, and one call of each kernel a mamba layer."""
    want = expected_launches(cfg)["ssd_scan"]
    return all(e[-1] for e in errors) and all(sum(e[0] == name for e in errors) == want for name in MIXER_KERNELS)


@contextlib.contextmanager
def moe_recorded(record: list):
    """Record each MoE block's routing inside the block: per call, its top-k
    experts (``top_i``), load-balance loss (``aux``), kept entries (``keep``)
    and capacity."""
    from repro_torch.models import moe

    route, dispatch = moe.route, moe.dispatch

    def recording_route(xf, w_router, top_k, renormalize=True):
        out = route(xf, w_router, top_k, renormalize)
        record.append({"top_i": out[1], "aux": out[2]})
        return out

    def recording_dispatch(xf, top_i, n_exp, cap, *args):
        out = dispatch(xf, top_i, n_exp, cap, *args)
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

    def pinned_route(xf, w_router, top_k, renormalize=True):
        _, _, aux = route(xf, w_router, top_k, renormalize)
        top_i = next(calls)["top_i"]
        top_p = torch.softmax(L.matmul_f32(xf, w_router), dim=-1).gather(1, top_i)
        return (top_p / top_p.sum(dim=-1, keepdim=True) if renormalize else top_p), top_i, aux

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
    """A small input through the whole model: the card (kernels) against the CPU (plain).

    For the moe family every ``moe_block`` call is also held against the CPU on
    the card's inputs; and where the logits miss ``BF16_TOL``, their largest
    error may exceed the CPU's own between two plain attention routes
    (xla_full against xla_chunked) by at most ``MOE_FLOOR_FACTOR``.  For the
    hybrid, vlm and audio families every kernel call on the card is held
    against its plain version on the same inputs, and where the logits miss
    ``BF16_TOL`` their largest error may exceed the CPU's own between its plain
    routes (xla_full against xla_chunked, and for the hybrid scan chunk 64
    against the config's as well) by at most ``HYBRID_FLOOR_FACTOR``.
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced

    cfg = reduced(slice_config(arch))
    params_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params_gpu = to_device(params_cpu, "cuda")
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, size=(2, prompt))
    extras = slice_extras(cfg, 2, SEED + 2)
    moe_family = cfg.family == "moe"
    new_family = cfg.family in ("hybrid", "vlm", "audio")

    def logits_on(dev, params, run_cfg, ctx=contextlib.nullcontext()):
        cache = slice_cache(cfg, 2, prompt + 4, dev)
        batch = {"tokens": torch.as_tensor(prompts, device=dev),
                 **{k: torch.as_tensor(v, device=dev) for k, v in extras.items()}}
        with torch.no_grad(), ctx:
            return T.forward(params, run_cfg, batch, cache)[0].cpu()

    routes, block_errors, scan_errors, flash_errors, mixer_errors = {"cpu": [], "cuda": []}, [], [], [], []
    cpu = logits_on("cpu", params_cpu, cfg, moe_recorded(routes["cpu"]) if moe_family else contextlib.nullcontext())
    with contextlib.ExitStack() as stack:
        if moe_family:
            stack.enter_context(moe_blocks_checked(block_errors, routes["cuda"]))
        if new_family:
            kernels_checked(stack, cfg, scan_errors, flash_errors, mixer_errors)
        card = logits_on("cuda", params_gpu, cfg)
    err = (card - cpu).abs().max().item()
    ok = torch.allclose(card, cpu, **BF16_TOL)
    log(f"reduced {arch} prompt {prompt} prefill logits, card vs CPU: max abs {err:.3e}, rel L2 "
        f"{((card - cpu).norm() / cpu.norm()).item():.3e} (atol=rtol={BF16_TOL['atol']:g}) {'ok' if ok else 'missed'}")
    if new_family:
        with plain_route(cfg, chunk=64 if cfg.family == "hybrid" else None, attention="xla_full") as other_cfg:
            other = logits_on("cpu", params_cpu, other_cfg)
        with plain_route(cfg) as plain_cfg:
            plain = logits_on("cpu", params_cpu, plain_cfg)
        floor = (other - plain).abs().max().item()
        expected = expected_launches(cfg)
        calls_ok = (all(e[-1] for e in flash_errors + scan_errors)
                    and len(flash_errors) == expected["flash_attention"] and len(scan_errors) == expected["ssd_scan"]
                    and (not expected["ssd_scan"] or mixer_calls_ok(mixer_errors, cfg)))
        log(f"reduced {arch} on the card: {checked_summary('flash_attention', flash_errors, BF16_TOL)}; "
            f"{checked_summary('ssd_scan', scan_errors, SSD_BF16_TOL)}; {mixer_summary(mixer_errors)}; "
            f"the CPU's plain routes against each "
            f"other: max abs {floor:.3e}; card vs CPU {err:.3e} = {err / floor:.3f} x that (bar "
            f"{HYBRID_FLOOR_FACTOR:g} x where {BF16_TOL} is missed)")
        return calls_ok and (ok or err <= HYBRID_FLOOR_FACTOR * floor)
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


def vision_prefill(cfg, params) -> dict:
    """qwen2-vl: one cached prefill of ``cfg.vision_tokens`` vision embeddings
    (a 32 x 32 patch grid) before ``PROMPT`` text tokens, at three distinct
    M-RoPE position streams, through ``forward`` with a cache sized for it
    (``generate`` sizes its cache from the prompt alone, as the reference's
    does, so it cannot take them).  Every flash call is held against its plain
    version, the logits against the plain route: ``PREFILL_REL_L2``, or where
    that is missed ``HYBRID_FLOOR_FACTOR`` times the plain route's own gap
    between its two attention cores (xla_full against xla_chunked)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    n_vis, side = cfg.vision_tokens, int(round(cfg.vision_tokens ** 0.5))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    vis = torch.randn((BATCH, n_vis, cfg.d_model), generator=gen, device="cuda") * 0.1
    tokens = torch.randint(1, cfg.vocab, (BATCH, PROMPT), generator=gen, device="cuda")
    grid = torch.arange(n_vis, device="cuda")
    text = side + torch.arange(PROMPT, device="cuda")
    pos = torch.stack([torch.cat([torch.zeros_like(grid), text]), torch.cat([grid // side, text]),
                       torch.cat([grid % side, text])])[:, None, :].expand(3, BATCH, n_vis + PROMPT)
    batch = {"tokens": tokens, "vision_embeds": vis, "positions": pos}

    def run(run_cfg):
        cache = slice_cache(cfg, BATCH, n_vis + PROMPT + GEN, "cuda")
        return T.forward(params, run_cfg, batch, cache)[0]

    errors: list = []
    with torch.no_grad():
        ops.flash_attention.launches = 0
        with flashes_checked(errors):
            logits_k = run(cfg)
        launches = ops.flash_attention.launches
        with plain_route(cfg) as plain_cfg:
            logits_p = run(plain_cfg)
        with plain_route(cfg, attention="xla_full") as full_cfg:
            floor = ((run(full_cfg) - logits_p).norm() / logits_p.norm()).item()
        ms = cuda_time_ms(lambda: run(cfg), reps=3, warmup=1)
    rel = ((logits_k - logits_p).norm() / logits_p.norm()).item()
    ok = (all(e[-1] for e in errors) and len(errors) == launches == cfg.n_layers
          and bool(torch.isfinite(logits_k).all())
          and (rel <= PREFILL_REL_L2 or rel <= HYBRID_FLOOR_FACTOR * floor))
    log(f"{cfg.name} vision prefill: {n_vis} vision + {PROMPT} text tokens x {BATCH}, q{errors[0][1]} "
        f"kv{errors[0][2]}, {launches} flash launches; {checked_summary('flash_attention', errors, BF16_TOL)}; "
        f"logits vs plain route rel L2 {rel:.3e}, the plain route's xla_full vs xla_chunked {floor:.3e} "
        f"(bar {PREFILL_REL_L2:g}, or {HYBRID_FLOOR_FACTOR:g} x that); {ms:.3f} ms "
        f"({BATCH * (n_vis + PROMPT) / ms * 1e3:.0f} tok/s) {'ok' if ok else 'FAIL'}")
    assert ok, f"{cfg.name}: the vision prefill disagrees with its plain route"
    return {"vision_tokens": n_vis, "text_tokens": PROMPT, "flash_launches": launches, "rel_l2": rel,
            "plain_floor_rel_l2": floor,
            "flash_max_abs_err": max(e[0] for e in errors), "prefill_ms": ms, "q": list(errors[0][1]),
            "kv": list(errors[0][2])}


def serve_slice(arch: str) -> tuple[dict, dict]:
    """Phases 4 and 5 for one model: (its slice line, each kernel's launches in generate)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    prompt, reduced_prompt = SLICES[arch]
    cfg = slice_config(arch)
    expected = expected_launches(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {arch}: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, size=(BATCH, prompt))
    extras = slice_extras(cfg, BATCH, SEED + 7)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in KERNELS:
        getattr(ops, name).launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cuda", extras=extras)
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in KERNELS}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"generate {arch}: tokens {tuple(tokens.shape)}, launches {launches} "
        f"(expected {expected}), peak memory {peak_gib:.2f} GiB")
    assert launches == expected, f"{arch}: launches {launches}, expected {expected}"
    assert tokens.shape == (BATCH, GEN) and tokens.dtype == torch.long
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab

    tok_in = torch.as_tensor(prompts, device="cuda")
    batch = {"tokens": tok_in, **{k: torch.as_tensor(v, device="cuda") for k, v in extras.items()}}

    def prefill_logits(run_cfg):
        return T.forward(params, run_cfg, batch, slice_cache(cfg, BATCH, prompt + GEN, "cuda"))[0]

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    def recorded(routes):
        return moe_recorded(routes) if cfg.family == "moe" else contextlib.nullcontext()

    scan_errors: list = []
    flash_errors: list = []
    mixer_errors: list = []
    routes = {"flash": [], "xla_chunked": [], "xla_full": []}
    moe_line, prefill_ok = None, True
    with torch.no_grad():
        with contextlib.ExitStack() as stack:
            kernels_checked(stack, cfg, scan_errors, flash_errors, mixer_errors)
            stack.enter_context(recorded(routes["flash"]))
            logits_k = prefill_logits(cfg)
        with plain_route(cfg) as plain_cfg, recorded(routes["xla_chunked"]):
            logits_p = prefill_logits(plain_cfg)
    assert logits_k.shape == (BATCH, prompt, cfg.vocab) and logits_k.dtype == torch.float32
    assert bool(torch.isfinite(logits_k).all()), "non-finite prefill logits"
    rel = rel_l2(logits_k, logits_p)
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    kernel_names = "+".join(name for name in KERNELS if expected[name])
    log(f"{arch} prefill logits, {kernel_names} vs plain route: rel L2 {rel:.3e}, "
        f"max abs {(logits_k - logits_p).abs().max().item():.3e}, "
        f"|logits| max {logits_p.abs().max().item():.3f}, argmax agreement {agree:.4f}")
    log(f"{arch} prefill, {checked_summary('flash_attention', flash_errors, BF16_TOL)}; "
        f"{checked_summary('ssd_scan', scan_errors, SSD_BF16_TOL)}; {mixer_summary(mixer_errors)}")
    assert len(flash_errors) == expected["flash_attention"] and len(scan_errors) == expected["ssd_scan"], \
        f"{arch}: {len(flash_errors)} flash and {len(scan_errors)} scan calls in the prefill"
    assert all(e[-1] for e in flash_errors), f"{arch}: a flash_attention call disagrees with its plain version"
    assert all(e[-1] for e in scan_errors), f"{arch}: an ssd_scan call disagrees with its plain version"
    assert not expected["ssd_scan"] or mixer_calls_ok(mixer_errors, cfg), \
        f"{arch}: the prefill's mixer calls miss their count or their bars: {mixer_summary(mixer_errors)}"
    floor = None
    if cfg.family in ("ssm", "hybrid"):
        factor = SSM_FLOOR_FACTOR if cfg.family == "ssm" else HYBRID_FLOOR_FACTOR
        attention = "xla_chunked" if cfg.family == "ssm" else "xla_full"
        with torch.no_grad(), plain_route(cfg, chunk=64, attention=attention) as plain_cfg:
            floor = rel_l2(prefill_logits(plain_cfg), logits_p)
        log(f"{arch} plain route, chunk 64 vs chunk {cfg.ssm_chunk}"
            + ("" if cfg.family == "ssm" else " and xla_full vs xla_chunked")
            + f": rel L2 {floor:.3e}; kernel route {rel:.3e} = {rel / floor:.3f} x that (bar {factor:g} x)")
        assert rel <= factor * floor, f"{arch}: the kernel prefill disagrees with the plain route"
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
        entries = BATCH * prompt * cfg.moe_top_k
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
        assert rel <= PREFILL_REL_L2, f"{arch}: the flash prefill disagrees with the plain route"
    assert torch.equal(tokens[:, 0], logits_k[:, -1].argmax(-1)), "first token != prefill argmax"
    del logits_k, logits_p

    reduced_ok = check_reduced_against_cpu(arch, reduced_prompt)
    vision_line = vision_prefill(cfg, params) if cfg.family == "vlm" else None

    with torch.no_grad():
        cache = slice_cache(cfg, BATCH, prompt + GEN, "cuda")

        def prefill():  # forward leaves the input cache's len (0) as it was
            return T.forward(params, cfg, batch, cache)

        prefill_ms = cuda_time_ms(prefill, reps=5)
        # the prefill's cache: its buffers, whisper's encoder K/V with them
        decode_base = prefill()[2]
        step_tok = tokens[:, :1]

        def decode_run():
            c = with_len(decode_base, prompt)
            for _ in range(GEN - 1):
                _, _, c = T.forward(params, cfg, {"tokens": step_tok}, c)

        decode_ms = cuda_time_ms(decode_run, reps=3, warmup=1) / (GEN - 1)
        gen_ms = cuda_time_ms(lambda: generate(cfg, params, prompts, GEN, device="cuda", extras=extras),
                              reps=3, warmup=1)

        def decode_step():
            return T.forward(params, cfg, {"tokens": step_tok}, with_len(decode_base, prompt))

        breakdown = {}
        for name, fn, wall_ms in (("prefill", prefill, prefill_ms), ("decode step", decode_step, decode_ms)):
            # one warm call; the profiler slows the host, so the idle share is
            # taken against the unprofiled CUDA-event time of the same call
            prof = device_ms(fn, calls=1, warmup=1)
            busy_ms, n_kernels, top = prof["ms"], prof["kernels"], prof["top"]
            breakdown[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "idle_share": idle_share(busy_ms, wall_ms), "kernels": round(n_kernels)}
            log(f"profile {arch} {name}: {wall_ms:.3f} ms, device busy {fmt(busy_ms, '.3f')} ms, "
                f"idle share {fmt(idle_share(busy_ms, wall_ms), '.3f')}, {n_kernels:g} kernels; top: "
                + "; ".join(f"{k[:48]} {ms:.3f} ms" for k, ms in top[:6]))
        if cfg.family == "moe":
            decode_routes: list = []
            with moe_recorded(decode_routes):
                decode_step()
            moe_line["dropped_entries"]["decode_step"] = sum(int((~r["keep"]).sum()) for r in decode_routes)
            log(f"{arch} decode step routing: capacity {decode_routes[0]['capacity']}, dropped entries "
                f"{moe_line['dropped_entries']['decode_step']} of {BATCH * cfg.moe_top_k * cfg.n_layers}")
        graph_line = decode_graph(cfg, params, decode_base, step_tok, tokens, prompts, extras, prompt,
                                  decode_ms, decode_run)
    if cfg.family == "moe":
        moe_line["sync_free"] = check_moe_sync_free(cfg, params["layers"][0]["moe"])
        moe_line["moe_block"] = time_moe(cfg, params["layers"][0]["moe"])
    log(f"{arch} prefill {BATCH}x{prompt}: {prefill_ms:.3f} ms ({BATCH * prompt / prefill_ms * 1e3:.0f} tok/s); "
        f"decode: {decode_ms:.3f} ms/step ({BATCH / decode_ms * 1e3:.1f} tok/s at batch {BATCH}); "
        f"generate {BATCH}x{GEN}: {gen_ms:.3f} ms ({BATCH * GEN / gen_ms * 1e3:.1f} tok/s)")
    line = {"arch": arch, "batch": BATCH, "prompt": prompt, "gen": GEN, "parameters": n_params,
            "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms, "generate_ms": gen_ms,
            "generate_tok_s": BATCH * GEN / gen_ms * 1e3, "peak_gib": peak_gib, "launches": launches,
            "prefill_rel_l2": rel, "plain_floor_rel_l2": floor,
            "flash_calls_max_abs_err": max((e[0] for e in flash_errors), default=None),
            "scan_calls_max_abs_err": max((max(e[0], e[1]) for e in scan_errors), default=None),
            "profile": breakdown, "decode_graph": graph_line}
    if cfg.family == "audio":
        line["encoder_frames"] = cfg.encoder_seq
    if vision_line is not None:
        line["vision_prefill"] = vision_line
    if moe_line is not None:
        line["moe"] = moe_line
    assert prefill_ok, f"{arch}: the flash prefill disagrees with the plain route"
    assert reduced_ok, f"reduced {arch} on the card disagrees with the CPU"
    return line, launches


def eager_generate(cfg, params, prompts, extras: dict, prompt: int):
    """``generate`` with every decode step eager, as on the CPU: the graph's yardstick."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.steps import make_serve_step

    cache = slice_cache(cfg, BATCH, prompt + GEN, "cuda")
    batch = {"tokens": torch.as_tensor(prompts, device="cuda"),
             **{k: torch.as_tensor(v, device="cuda") for k, v in extras.items()}}
    logits, _, cache = T.forward(params, cfg, batch, cache)
    out, step = [logits[:, -1].argmax(-1)], make_serve_step(cfg)
    for _ in range(GEN - 1):
        nxt, cache = step(params, cache, {"tokens": out[-1][:, None]})
        out.append(nxt)
    return torch.stack(out, dim=1)


def decode_graph(cfg, params, cache, step_tok, gen_tokens, prompts, extras, prompt, eager_ms, eager_run) -> dict:
    """The decode step as a CUDA graph, against the same step run eagerly.

    ``cache`` holds the prefill of ``step_tok``'s prompts (of ``prompt``
    tokens; for whisper with the encoder's K/V, which every replay reads from
    the same buffers); ``gen_tokens`` is ``generate``'s output (graph
    decode), ``eager_ms`` the eager decode time per step and ``eager_run``
    its timed run of ``GEN - 1`` eager steps.  Checks that an eager step
    synchronises nowhere (sync debug mode "error"), and holds one replay's
    logits and cache against the eager step from the same state
    (``BF16_TOL``); prints the tokens' agreement with an eager ``generate``,
    decode ms per step eager and graph in turns, capture seconds and peak
    memory, and a profile of one replayed and one eager step.
    """
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.steps import capture_serve_step, make_serve_step, serve_step_in_place

    def state_at(length: int) -> dict:
        state = clone_tree(cache)
        set_len_(state, length)
        return state

    probe = state_at(prompt)
    make_serve_step(cfg)(params, probe, {"tokens": step_tok})  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        make_serve_step(cfg)(params, probe, {"tokens": step_tok})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del probe

    graph_cache = state_at(prompt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step = capture_serve_step(cfg, params, graph_cache, {"tokens": step_tok})
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # one replay against the eager step from the state the replay starts from
    eager_cache, tok1 = clone_tree(graph_cache), step.tokens.clone()
    step.replay()
    logits_e, _, eager_new = T.forward(params, cfg, {"tokens": tok1}, eager_cache)
    torch.cuda.synchronize()
    logits_err = (step.logits - logits_e).abs().max().item()
    graph_bufs, eager_bufs = dict(cache_tensors(graph_cache)), dict(cache_tensors(eager_cache))
    cache_err = {k: (graph_bufs[k].float() - eager_bufs[k].float()).abs().max().item() for k in graph_bufs}
    lens = (int(graph_cache["len"]), int(eager_new["len"]))
    group_lens_ok = "attn" not in cache or (
        graph_cache["attn"]["len"].tolist() == eager_new["attn"]["len"].tolist() == [prompt + 2] * len(
            graph_cache["attn"]["len"]))
    replay_ok = (torch.allclose(step.logits, logits_e, **BF16_TOL) and lens == (prompt + 2,) * 2 and group_lens_ok
                 and all(torch.allclose(graph_bufs[k].float(), eager_bufs[k].float(), **BF16_TOL)
                         for k in cache_err))
    same_token = bool(torch.equal(step.tokens[:, 0], logits_e[:, -1].argmax(-1)))
    log(f"{cfg.name} decode graph: captured in {capture_s:.2f} s (the warm-up step included), peak "
        f"{capture_peak_gib:.2f} GiB; one replay vs the eager step from the same state: logits max abs "
        f"{logits_err:.3e}, cache max abs {max(cache_err.values()):.3e} over {len(cache_err)} buffers, len "
        f"{lens}, per-group lens ok {group_lens_ok}, same next token {same_token} "
        f"(atol=rtol={BF16_TOL['atol']:g}) {'ok' if replay_ok else 'FAIL'}")
    del eager_cache, logits_e, eager_new

    eager_tokens = eager_generate(cfg, params, prompts, extras, prompt)
    differ = (eager_tokens != gen_tokens).any(dim=0).nonzero()
    agreement = (eager_tokens == gen_tokens).float().mean().item()
    first_diff = int(differ[0]) if len(differ) else None
    log(f"{cfg.name} generate, graph decode vs eager decode: token agreement {agreement:.4f}, "
        f"first differing step {first_diff}")

    def graph_run():
        set_len_(graph_cache, prompt)
        step.tokens.copy_(step_tok)
        for _ in range(GEN - 1):
            step.replay()

    # in turns: eager (measured before), graph, eager, graph
    graph_ms = [cuda_time_ms(graph_run, reps=5, warmup=1) / (GEN - 1)]
    eager_list = [eager_ms, cuda_time_ms(eager_run, reps=2, warmup=0) / (GEN - 1)]
    graph_ms.append(cuda_time_ms(graph_run, reps=5, warmup=0) / (GEN - 1))

    # one replayed step and one eager step of the same body, profiled; each
    # call advances len by one, seven calls in all
    set_len_(graph_cache, prompt)
    prof_g = device_ms(step.replay, calls=1, warmup=1)
    eager_state, tok_buf = state_at(prompt), step_tok.clone()
    prof_e = device_ms(lambda: serve_step_in_place(cfg, params, eager_state, tok_buf), calls=1, warmup=1)
    profiles = {}
    for name, prof, wall in (("graph", prof_g, min(graph_ms)), ("eager", prof_e, min(eager_list))):
        profiles[name] = {"wall_ms": wall, "device_busy_ms": prof["ms"], "idle_share": idle_share(prof["ms"], wall),
                          "kernels": prof["kernels"], "sessions_kernels": prof["sessions_kernels"]}
        log(f"profile {cfg.name} decode step ({name}): {wall:.3f} ms, device busy {fmt(prof['ms'], '.3f')} ms, "
            f"idle share {fmt(idle_share(prof['ms'], wall), '.3f')}, {prof['kernels']:g} kernels (sessions "
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
            + ", ".join(f"{name} {fmt(t['ms'])} ({t['event_ms']:.4f}; {t['kernels']:g})" for name, t in parts.items())
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
    prompt = SLICES[arch][0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q = torch.randn((BATCH, prompt, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    k = torch.randn((BATCH, prompt + GEN, cfg.n_kv_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    v = torch.randn_like(k)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    sdpa_err = (sdpa().transpose(1, 2).float() - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
    # kernel, SDPA, SDPA, kernel: each measured twice, in turns
    kernel = timed(lambda: ops.flash_attention(q, k, v, causal=True), graph=True)
    library = timed(sdpa, graph=True)
    library2 = timed(sdpa, graph=True)
    kernel2 = timed(lambda: ops.flash_attention(q, k, v, causal=True), graph=True)
    plain = timed(lambda: ref.flash_attention_ref(q, k, v, causal=True), calls=10, graph=True)
    bound_ms, bound_by = flash_bound_ms(q, k, causal=True)
    log(f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal, ms per call by CUDA-graph "
        f"replay (torch.profiler; kernels a call it recorded; CUDA events): kernel {kernel['graph_ms']:.4f} / "
        f"{kernel2['graph_ms']:.4f} ({fmt(kernel['ms'])} / {fmt(kernel2['ms'])}; {kernel['kernels']:g}; "
        f"{kernel['event_ms']:.4f} / {kernel2['event_ms']:.4f}), sdpa {library['graph_ms']:.4f} / "
        f"{library2['graph_ms']:.4f} ({fmt(library['ms'])} / {fmt(library2['ms'])}; {library['kernels']:g}; "
        f"{library['event_ms']:.4f} / {library2['event_ms']:.4f}; max abs vs plain {sdpa_err:.2e}), plain "
        f"{plain['graph_ms']:.4f} ({fmt(plain['ms'])}; {plain['kernels']:g}; {plain['event_ms']:.4f}), "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    log(f"flash_attention kernels: {[k for k, _ in kernel['top']]}; sdpa kernels: {[k for k, _ in library['top']]}")
    log("device ms per call in each profiler session: " + "; ".join(
        f"{name} {', '.join(f'{x:.4f}' for x in t['sessions_ms'])}"
        for name, t in (("kernel", kernel), ("sdpa", library), ("sdpa", library2), ("kernel", kernel2),
                        ("plain", plain))))
    return {"q": list(q.shape), "kv": list(k.shape), "ms": kernel["graph_ms"], "profiler_ms": kernel["ms"],
            "event_ms": kernel["event_ms"], "plain_ms": plain["graph_ms"], "plain_profiler_ms": plain["ms"],
            "plain_event_ms": plain["event_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library["graph_ms"], "library_profiler_ms": library["ms"],
            "library_event_ms": library["event_ms"]}


def time_ssd(arch: str) -> dict:
    """The SSD-scan kernel at ``arch``'s prefill shape: kernel, plain, bound; for
    mamba2-780m also at chunk 64 and at batch 1 x ``LONG_PROMPT`` tokens.  Each
    with its device time split among its kernels.

    No single PyTorch call computes the SSD scan, so there is no library time.
    """
    import torch

    from repro_torch.kernels import ops, ref

    cfg = slice_config(arch)
    prompt = SLICES[arch][0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    h, p, n, chunk = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    x, la, bm, cm, _ = ssd_inputs(gen, BATCH, prompt, h, p, n, torch.bfloat16, state=False)
    s0 = torch.zeros((BATCH, h, p, n), device="cuda")
    kernel = timed(lambda: ops.ssd_scan(x, la, bm, cm, chunk=chunk, state0=s0), graph=True)
    plain = timed(lambda: ref.ssd_scan_ref(x, la, bm, cm, chunk=chunk, state0=s0), calls=10, graph=True)
    bound_ms, bound_by = ssd_bound_ms(x, la, bm, s0, chunk)

    def split(t):
        return "; ".join(f"{k[:60]} {ms:.4f}" for k, ms in t["top"])

    log(f"ssd_scan [{arch}] x{tuple(x.shape)} n={n} bf16, state0 given, ms per call by CUDA-graph replay "
        f"(torch.profiler; kernels a call it recorded, of 3; CUDA events): kernel {kernel['graph_ms']:.4f} "
        f"({fmt(kernel['ms'])}; {kernel['kernels']:g}; {kernel['event_ms']:.4f}) at chunk {chunk}, plain "
        f"{plain['graph_ms']:.4f} ({fmt(plain['ms'])}; {plain['event_ms']:.4f}), bound {bound_ms:.4f} ms "
        f"({bound_by}), bound share {bound_ms / kernel['graph_ms']:.3f}, library: none")
    log(f"ssd_scan [{arch}] device ms per call by kernel, x{tuple(x.shape)} chunk {chunk}: {split(kernel)}")
    out = {"x": list(x.shape), "n": n, "ms": kernel["graph_ms"], "profiler_ms": kernel["ms"],
           "event_ms": kernel["event_ms"], "plain_ms": plain["graph_ms"], "plain_profiler_ms": plain["ms"],
           "plain_event_ms": plain["event_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "library_profiler_ms": None, "library_event_ms": None}
    if arch != "mamba2-780m":
        return out
    kernel64 = timed(lambda: ops.ssd_scan(x, la, bm, cm, chunk=64, state0=s0), graph=True)
    xl, lal, bml, cml, s0l = ssd_inputs(gen, 1, LONG_PROMPT, h, p, n, torch.bfloat16, state=True)
    long = timed(lambda: ops.ssd_scan(xl, lal, bml, cml, chunk=chunk, state0=s0l), graph=True)
    long_bound_ms, long_bound_by = ssd_bound_ms(xl, lal, bml, s0l, chunk)
    log(f"ssd_scan x{tuple(x.shape)} chunk 64: kernel {kernel64['graph_ms']:.4f} by graph replay "
        f"({fmt(kernel64['ms'])} profiler; {kernel64['event_ms']:.4f} events)")
    log(f"ssd_scan x{tuple(xl.shape)} n={n} bf16, state0 given, chunk {chunk}: kernel {long['graph_ms']:.4f} "
        f"ms per call by graph replay ({fmt(long['ms'])} profiler, {long['kernels']:g} kernels a call; "
        f"{long['event_ms']:.4f} events), bound {long_bound_ms:.4f} ms ({long_bound_by}), bound share "
        f"{long_bound_ms / long['graph_ms']:.3f}")
    log("ssd_scan device ms per call (kernels a call) in each profiler session: " + "; ".join(
        f"{name} " + ", ".join(f"{m:.4f} ({k:g})" for m, k in zip(t["sessions_ms"], t["sessions_kernels"]))
        for name, t in (("chunk 128", kernel), ("chunk 64", kernel64), ("long", long))))
    log(f"ssd_scan device ms per call by kernel, x{tuple(x.shape)} chunk 64: {split(kernel64)}")
    log(f"ssd_scan device ms per call by kernel, x{tuple(xl.shape)} chunk {chunk}: {split(long)}")
    return {**out, "chunk64_ms": kernel64["graph_ms"], "long_ms": long["graph_ms"], "long_bound_ms": long_bound_ms}


def ssd_bwd_bound_ms(x, log_da, bmat, state0, dstate, chunk: int) -> tuple[float, str]:
    """Least time for the card for the scan's gradient: its inputs read and
    gradients written once vs its products (``repro_torch.kernels.costs.ssd_bwd_cost``)."""
    from repro_torch.kernels import costs

    b, s, h, p = x.shape
    return _bound(*costs.ssd_bwd_cost(b, s, h, p, bmat.shape[-1], x.element_size(), chunk,
                                      state0 is not None, dstate is not None), x.dtype)


def time_ssd_train() -> dict:
    """The scan's forward and backward kernels at mamba2-780m's training shape
    (x (2, 4096, 48, 64) bf16, N 128, no initial state, d(final state) zero,
    as the training step calls them), beside their plain versions and bounds."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x, la, bm, cm, _ = ssd_inputs(gen, TRAIN_BATCH, TRAIN_SEQ, 48, 64, 128, torch.bfloat16, state=False)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    zero = torch.zeros((TRAIN_BATCH, 48, 64, 128), device="cuda")
    def fwd():
        return ops.ssd_scan(x, la, bm, cm)

    def bwd():
        return ops.ssd_scan_bwd(x, la, bm, cm, dy, None)

    # kernel, kernel again; CUDA-graph replay, then CUDA events around back-to-back calls
    fwd_ms, bwd_ms, bwd2_ms = graph_ms(fwd, calls=10), graph_ms(bwd, calls=10), graph_ms(bwd, calls=10)
    fwd_ev, bwd_ev = cuda_time_ms(fwd, reps=10), cuda_time_ms(bwd, reps=10)
    plain_fwd = cuda_time_ms(lambda: ref.ssd_scan_ref(x, la, bm, cm), reps=3, warmup=1)
    plain_bwd = cuda_time_ms(lambda: ref.ssd_scan_bwd_ref(x, la, bm, cm, dy, zero), reps=3, warmup=1)
    fwd_bound, fwd_by = ssd_bound_ms(x, la, bm, None, 128)
    bwd_bound, bwd_by = ssd_bwd_bound_ms(x, la, bm, None, None, 128)
    # the backward's split among its five kernels, from torch.profiler; [] when it recorded none
    split = device_ms(bwd, calls=5, warmup=1, sessions=1)["top"]
    lib = ops._ssd_bwd_lib()
    scratch = {dt: lib.repro_ssd_scan_bwd_scratch_bytes(TRAIN_BATCH, TRAIN_SEQ, 48, 64, 128, 128, int(dt == "bf16"))
               for dt in ("bf16", "fp32")}
    log(f"ssd_scan x{tuple(x.shape)} n=128 bf16 (training shape), ms per call by CUDA-graph replay "
        f"(CUDA events): forward {fwd_ms:.4f} ({fwd_ev:.4f}), plain {plain_fwd:.4f} (events), bound "
        f"{fwd_bound:.4f} ({fwd_by}); backward {bwd_ms:.4f} / {bwd2_ms:.4f} ({bwd_ev:.4f}), plain "
        f"{plain_bwd:.4f} (events), bound {bwd_bound:.4f} ({bwd_by}), bound share {bwd_bound / bwd_ms:.4f}, "
        f"library: none")
    log("ssd_scan_bwd device ms per call by kernel: "
        + ("; ".join(f"{k[:60]} {ms:.4f}" for k, ms in split) or "not measured"))
    log(f"ssd_scan_bwd scratch a call at the training shape: {scratch['bf16']} bytes (bf16 path; the fp32 "
        f"path's layout {scratch['fp32']})")
    none = {"library_ms": None, "library_profiler_ms": None, "library_event_ms": None,
            "profiler_ms": None, "plain_profiler_ms": None}
    return {
        "ssd_scan": {"x": list(x.shape), "n": 128, "ms": fwd_ms, "event_ms": fwd_ev, "plain_ms": plain_fwd,
                     "plain_event_ms": plain_fwd, "bound_ms": fwd_bound, "bound_by": fwd_by, **none},
        "ssd_scan_bwd": {"x": list(x.shape), "n": 128, "ms": bwd_ms, "ms_again": bwd2_ms, "event_ms": bwd_ev,
                         "plain_ms": plain_bwd, "plain_event_ms": plain_bwd, "bound_ms": bwd_bound,
                         "bound_by": bwd_by, "split": split or None, "scratch_bytes": scratch["bf16"], **none},
    }


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
    return (held_out, y_true), {
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


def _worker_probe(hold_s: float) -> dict:
    """Runs in a pool worker: its pid, when its CUDA context was up (wall
    clock, shared across processes), and its allocator's peaks so far."""
    import os

    import torch

    torch.zeros(1, device="cuda")
    ready = time.time()
    time.sleep(hold_s)
    return {"pid": os.getpid(), "ready_wall": ready,
            "allocated_peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "reserved_peak_mib": torch.cuda.max_memory_reserved() / 2**20}


def _probe_pool(rt, workers: int) -> list:
    """One probe per worker of a runtime's pool, all submitted at once."""
    futures = [rt.executor._pool.submit(_worker_probe, PROBE_HOLD_S) for _ in range(workers)]
    probes = [f.result(timeout=600) for f in futures]
    if len({p["pid"] for p in probes}) != workers:
        raise AssertionError(f"the probes did not reach {workers} distinct workers: {probes}")
    return probes


@contextlib.contextmanager
def device_memory_peak():
    """Peak of the card's used memory (every process's contexts and
    allocations, ``cudaMemGetInfo``) over its level on entry, in MiB, polled
    every 10 ms from a thread; the yielded dict gets ``peak_over_entry_mib``."""
    import threading

    import torch

    def used() -> int:
        free, total = torch.cuda.mem_get_info()
        return total - free

    out, stop = {}, threading.Event()
    base, peak = used(), [0]

    def poll() -> None:
        while not stop.wait(0.01):
            peak[0] = max(peak[0], used())

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join(timeout=10)
        out["peak_over_entry_mib"] = (max(peak[0], used()) - base) / 2**20


def _journal_times(path) -> dict:
    """Every measurement a journal holds: (layer type, params, row) -> seconds."""
    from repro_torch.runtime import MeasurementJournal

    times = {}
    with MeasurementJournal(str(path)) as journal:
        for record in journal.iter_records():
            for row, sec in zip(record["rows"], record["seconds"]):
                times[(record["layer_type"], tuple(record["params"]), tuple(row))] = sec
    return times


def runtime_on_card(smi: str, held: tuple, work: Path) -> dict:
    """Phase 6c (a): the card's bf16 PR campaign through the runtime, serial
    against a pool of ``RT_WORKERS`` processes, each journaled and traced.

    The pool is built before the campaign and probed once (its start-up:
    spawn, torch import, platform, CUDA context) and once after (each
    worker's allocator peaks); the card's used memory is polled during each
    run.  Both runs' measurements of the same configs are compared, and each
    run's PR-MAPE is taken on phase 6's held-out configs (measured serially
    there).  Then (d): each run's trace through ``repro_torch.obs.report``.
    """
    import numpy as np

    from repro_torch import obs
    from repro_torch.accelerators.torch_device import TorchDevicePlatform
    from repro_torch.api import Campaign, CampaignSpec, MeasurementRuntime, RuntimeSpec
    from repro_torch.core.forest import mape
    from repro_torch.obs import report

    held_out, y_true = held
    runs = {}
    for workers in (1, RT_WORKERS):
        platform = TorchDevicePlatform(device="cuda", dtype="bfloat16")
        trace = work / f"runtime_w{workers}.jsonl"
        journal = work / f"torch_device_w{workers}.jsonl"
        rt = MeasurementRuntime(RuntimeSpec(workers=workers, journal_path=str(journal)), platform)
        try:
            run = {"workers": workers}
            if workers > 1:
                t0 = time.time()
                with device_memory_peak() as boot:
                    probes = _probe_pool(rt, workers)
                run["startup_s"] = max(p["ready_wall"] for p in probes) - t0
                run["startup_device_memory_mib"] = boot["peak_over_entry_mib"]
            # the serial run persists its estimators for the service, phase 6c (c)
            campaign = Campaign(
                CampaignSpec(platform="torch_device", layer_types=("dense",), sampling="pr",
                             n_samples=EST_SAMPLES, seed=SEED,
                             hub_dir=str(work / "hub") if workers == 1 else None),
                platform=platform)
            with obs.tracing(str(trace)), device_memory_peak() as mem:
                t0 = time.perf_counter()
                oracle = campaign.run(runtime=rt, device="cuda")
                run["wall_s"] = time.perf_counter() - t0
            if workers > 1:
                run["workers_after"] = _probe_pool(rt, workers)
        finally:
            rt.close()
        stats = campaign.last_run_stats
        run.update({k: stats[k] for k in ("measured", "cached", "chunks", "retries", "throughput_cfg_s",
                                          "exec_seconds")})
        run["device_memory_peak_over_entry_mib"] = mem["peak_over_entry_mib"]
        run["pr_mape"] = mape(y_true, oracle.predict("dense", held_out))
        run["widths"] = dict(oracle.estimators["dense"].widths)
        summary = report.summarize(obs.load_events(str(trace)))
        run["trace_top_ms"] = {name: row["total_us"] / 1e3 for name, row in sorted(
            summary["spans"].items(), key=lambda kv: -kv[1]["total_us"])[:8]}
        runs[workers] = run
        log(f"runtime workers={workers}: {run['wall_s']:.2f} s wall"
            + (f" (+ {run['startup_s']:.2f} s pool start-up, device memory +"
               f"{run['startup_device_memory_mib']:.0f} MiB)" if workers > 1 else "")
            + f"; {run['measured']} measured, {run['cached']} cached, {run['chunks']} chunks, "
            f"{run['throughput_cfg_s']:.1f} cfg/s; device memory peak +{run['device_memory_peak_over_entry_mib']:.0f} "
            f"MiB; widths {run['widths']}; PR-MAPE {run['pr_mape']:.3f} %")
        log(f"(d) trace of the workers={workers} run ({trace.name}) through repro_torch.obs.report:")
        if report.main([str(trace), "--limit", "12"]) != 0:
            raise AssertionError(f"repro_torch.obs.report found no events in {trace}")
    serial, pooled = runs[1], runs[RT_WORKERS]
    for p in pooled["workers_after"]:
        log(f"  worker pid {p['pid']}: allocator peak {p['allocated_peak_mib']:.1f} MiB, "
            f"reserved peak {p['reserved_peak_mib']:.1f} MiB")

    a, b = _journal_times(work / "torch_device_w1.jsonl"), _journal_times(work / f"torch_device_w{RT_WORKERS}.jsonl")
    common = sorted(set(a) & set(b))
    rel = np.array([abs(b[k] - a[k]) / a[k] for k in common])
    compare = {"configs": len(common), "median_rel": float(np.median(rel)),
               "p90_rel": float(np.percentile(rel, 90)), "max_rel": float(rel.max()),
               "share_over_10pct": float(np.mean(rel > 0.1))}
    log(f"pooled vs serial measurements of the same {len(common)} configs: median relative difference "
        f"{compare['median_rel']:.4f}, p90 {compare['p90_rel']:.4f}, max {compare['max_rel']:.4f}, "
        f"{100 * compare['share_over_10pct']:.1f} % over 10 %; pooled / serial wall "
        f"{pooled['wall_s'] / serial['wall_s']:.3f} (with start-up "
        f"{(pooled['wall_s'] + pooled['startup_s']) / serial['wall_s']:.3f})")
    return {"card": smi, "n_samples": EST_SAMPLES, "serial": serial, "pooled": pooled,
            "pooled_over_serial_wall": pooled["wall_s"] / serial["wall_s"],
            "pooled_with_startup_over_serial_wall": (pooled["wall_s"] + pooled["startup_s"]) / serial["wall_s"],
            "pooled_vs_serial_measurements": compare}


def deterministic_on_card(work: Path) -> dict:
    """Phase 6c (b): ``ultratrail`` and ``tpu_v5e[gray]`` with their hooks on
    the card, serial against pooled, bitwise.  The pooled ``tpu_v5e[gray]``
    run is a resume: a serial run aborted by a fault plan (every chunk
    submitted from ``ABORT_AT`` on crashes, so that chunk exhausts its
    retries; a serial executor submits in a fixed order, so the abort always
    falls after ``ABORT_AT`` journaled chunks) and resumed from its journal
    by a pool.  Then the launcher's ``--fsck`` on that journal."""
    import io

    import numpy as np

    from repro_torch.api import Campaign, CampaignSpec, FaultPlan, RuntimeSpec, get_platform
    from repro_torch.checkpoint.manager import journal_path
    from repro_torch.configs import get_config
    from repro_torch.core import prs
    from repro_torch.core.network import decompose
    from repro_torch.launch import serve
    from repro_torch.launch.serve import ESTIMATE_LAYER_TYPES
    from repro_torch.models.config import InputShape
    from repro_torch.runtime import FaultEvent, MeasurementError, MeasurementJournal
    from repro_torch.runtime.faults import CHUNK_SITE

    setups = {  # key -> (registry name, platform kwargs, layer types, samples)
        "ultratrail": ("ultratrail", {}, ("conv1d",), EST_SAMPLES),
        "tpu_v5e[gray]": ("tpu_v5e", {"knowledge": "gray", "noise": 0.001}, ESTIMATE_LAYER_TYPES,
                          ESTIMATE_SAMPLES),
    }
    blocks = decompose(get_config("qwen2-1.5b"),
                       InputShape(name="serve", seq_len=PROMPT + GEN, global_batch=BATCH, kind="decode"),
                       dp=1, tp=1)

    def run(key, workers, jdir, hub=None, **runtime):
        """One campaign on the card through the runtime: (campaign, oracle, seconds)."""
        name, kwargs, layer_types, n = setups[key]
        c = Campaign(CampaignSpec(platform=name, layer_types=layer_types, n_samples=n, seed=SEED,
                                  platform_kwargs={**kwargs, "device": "cuda"}, hub_dir=hub))
        spec = RuntimeSpec(workers=workers, chunk_size=32, journal_path=journal_path(str(jdir)),
                           chunk_timeout_s=600, **runtime)
        t0 = time.perf_counter()
        oracle = c.run(runtime=spec, device="cuda")
        return c, oracle, time.perf_counter() - t0

    def answers(oracle, key):
        name, kwargs, layer_types, _ = setups[key]
        platform = get_platform(name, device="cuda", **kwargs)
        rng = np.random.default_rng(SEED + 3)
        out = [oracle.predict(lt, prs.sample_random_batch(platform.param_space(lt), 500, rng))
               for lt in layer_types]
        if key == "tpu_v5e[gray]":
            out.append(oracle.predict_networks([blocks], backend="numpy"))
        return np.concatenate(out)

    result = {}
    for key in setups:
        # the serial tpu_v5e[gray] run persists its estimators for the service, phase 6c (c)
        serial, serial_oracle, serial_s = run(key, 1, work / f"{key}_w1",
                                              hub=str(work / "hub") if key != "ultratrail" else None)
        jdir = work / f"{key}_w{RT_WORKERS}"
        if key == "tpu_v5e[gray]":
            plan = FaultPlan([FaultEvent(CHUNK_SITE, i, "crash") for i in range(ABORT_AT, ABORT_AT + 64)])
            try:
                run(key, 1, jdir, fault_plan=plan, max_retries=2, retry_backoff_s=0.001)
                raise AssertionError("the fault plan did not interrupt the run")
            except MeasurementError as exc:
                log(f"{key}: interrupted as planned ({exc})")
            with MeasurementJournal(journal_path(str(jdir))) as journal:
                durable = journal.fsck()
            if durable["rows"] <= 0:
                raise AssertionError(f"the interrupted run journaled nothing: {durable}")
        pooled, pooled_oracle, pooled_s = run(key, RT_WORKERS, jdir)
        want, got = answers(serial_oracle, key), answers(pooled_oracle, key)
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"{key}: workers={RT_WORKERS} predictions are not bitwise the serial run's "
                                 f"(max relative difference {np.max(np.abs(got - want) / want):.3e})")
        s, p = serial.last_run_stats, pooled.last_run_stats
        entry = {"serial_s": serial_s, "pooled_s": pooled_s, "predictions": int(want.size), "bitwise": True,
                 "serial": {k: s[k] for k in ("measured", "chunks")},
                 "pooled": {k: p[k] for k in ("measured", "replayed", "chunks")}}
        if key == "tpu_v5e[gray]":
            if p["replayed"] != durable["rows"] or p["measured"] + p["replayed"] != s["measured"]:
                raise AssertionError(f"the resumed run re-measured journaled rows: {durable['rows']} journaled, "
                                     f"resumed {p}, uninterrupted {s}")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = serve.main(["--fsck", "--journal-dir", str(jdir)])
            report = json.loads(out.getvalue())
            if rc != 0:
                raise AssertionError(f"--fsck on the resumed journal exited {rc}: {report}")
            entry["interrupted"] = {"journaled_rows": durable["rows"], "journaled_records": durable["records"],
                                    "fsck_exit": rc, "fsck": {k: report[k] for k in (
                                        "records", "rows", "corrupt_lines", "torn_tail", "duplicate_keys")}}
        result[key] = entry
        log(f"{key} on the card: serial {serial_s:.2f} s ({s['measured']} measured), workers={RT_WORKERS} "
            f"{pooled_s:.2f} s ({p['measured']} measured, {p['replayed']} replayed); {want.size} predictions "
            f"bitwise equal" + (f"; resumed after {durable['rows']} journaled rows, re-measuring none; "
                                 f"--fsck exit 0" if key == "tpu_v5e[gray]" else ""))
    return result


def service_on_card(smi: str, hub_dir: Path) -> dict:
    """Phase 6c (c): ``--serve-oracle`` in a subprocess, oracles on the card.

    Two rounds: ``SERVICE_CLIENTS`` threads, each with its own socket
    client, send ``SERVICE_REQUESTS`` predict requests of
    ``SERVICE_CONFIGS`` configs, alternating the hub's two platforms and
    their layer types; the first round meets each oracle's forest engine
    cold on the card, the second (other configs, so no result-cache hits)
    warm.  Each request's latency is taken by its client.  Then
    ``predict_networks`` and ``autotune``.  Every answer is held against
    direct calls of the same oracles: layers bitwise, networks and
    autotune's seconds within ``NET_RTOL``.  Batch sizes come from
    ``stats``; SIGINT must drain the server and end it with exit code 0.
    """
    import os
    import threading

    import numpy as np

    from repro_torch.api import EstimatorHub, PerfOracle, get_platform
    from repro_torch.configs import get_config
    from repro_torch.core import prs
    from repro_torch.core.advisor import autotune
    from repro_torch.core.blocks import Block
    from repro_torch.core.network import decompose
    from repro_torch.launch.serve import ESTIMATE_PLATFORM
    from repro_torch.models.config import InputShape
    from repro_torch.serving import OracleClient

    platforms = ("torch_device", ESTIMATE_PLATFORM)
    hub = EstimatorHub(str(hub_dir))
    direct = {p: PerfOracle.load(hub, p, device="cuda") for p in platforms}
    rng = np.random.default_rng(SEED + 4)
    spaces = {"torch_device": get_platform("torch_device", device="cuda"),
              ESTIMATE_PLATFORM: get_platform("tpu_v5e", knowledge="gray", device="cuda")}
    rounds = {}
    for name in ("cold", "warm"):
        requests = []
        for i in range(SERVICE_CLIENTS * SERVICE_REQUESTS):
            platform = platforms[i % 2]
            lts = direct[platform].layer_types()
            lt = lts[(i // 2) % len(lts)]
            cfgs = prs.sample_random_batch(spaces[platform].param_space(lt), SERVICE_CONFIGS, rng).to_dicts()
            requests.append((platform, lt, [{k: int(v) for k, v in c.items()} for c in cfgs]))
        rounds[name] = requests
    stderr = open(hub_dir.parent / "service.stderr", "w+")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-oracle", "--hub-dir", str(hub_dir),
         "--port", "0", "--warm-platforms", *platforms],
        stdout=subprocess.PIPE, stderr=stderr, text=True,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(SRC), os.environ.get("PYTHONPATH")]))})
    try:
        line = proc.stdout.readline()
        startup_s = time.perf_counter() - t_start
        if not line.startswith("oracle server on "):
            stderr.seek(0)
            raise AssertionError(f"the service did not start: {line!r}\n{stderr.read()}")
        address = ("127.0.0.1", int(line.split()[3].split(":")[1]))
        log(f"service: {line.strip()} after {startup_s:.2f} s")
        load = {}
        for name, requests in rounds.items():
            served: list = [None] * len(requests)
            latency_ms = [0.0] * len(requests)
            errors: list = []

            def client_thread(k: int, requests: list, served: list, latency_ms: list) -> None:
                try:
                    with OracleClient(address=address, timeout=120) as client:
                        for i in range(k, len(requests), SERVICE_CLIENTS):
                            t = time.perf_counter()
                            served[i] = client.predict(*requests[i])
                            latency_ms[i] = (time.perf_counter() - t) * 1e3
                except Exception as exc:  # noqa: BLE001 - reported below, then raised
                    errors.append(repr(exc))

            threads = [threading.Thread(target=client_thread, args=(k, requests, served, latency_ms))
                       for k in range(SERVICE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"client threads failed: {errors}")
            for (platform, lt, cfgs), got in zip(requests, served):
                want = direct[platform].predict(lt, cfgs, backend="numpy")
                if np.asarray(got).tobytes() != want.tobytes():
                    raise AssertionError(f"served {platform} {lt} layers are not bitwise the oracle's")
            load[name] = {"requests": len(requests), "wall_s": wall, "requests_per_s": len(requests) / wall,
                          "p50_ms": float(np.percentile(latency_ms, 50)),
                          "p99_ms": float(np.percentile(latency_ms, 99)), "max_ms": max(latency_ms)}
            log(f"service, {name} round: {len(requests)} predict requests from {SERVICE_CLIENTS} clients in "
                f"{wall:.2f} s ({load[name]['requests_per_s']:.1f} requests/s); client latency p50 "
                f"{load[name]['p50_ms']:.3f} ms, p99 {load[name]['p99_ms']:.3f} ms, max {load[name]['max_ms']:.3f} ms")
        decode = InputShape(name="serve", seq_len=PROMPT + GEN, global_batch=BATCH, kind="decode")
        nets = {ESTIMATE_PLATFORM: [decompose(get_config(a), decode, dp=1, tp=1)
                                    for a in ("qwen2-1.5b", "mamba2-780m", "olmoe-1b-7b")],
                "torch_device": [[Block(kind="mlp", layers=(
                    ("dense", {"tokens": t, "d_in": 1536, "d_out": 8960}),
                    ("dense", {"tokens": t, "d_in": 8960, "d_out": 1536})), repeat=28)]
                    for t in (16, 512, 4096)]}
        shape = InputShape(name="serve", seq_len=4096, global_batch=8, kind="decode")
        with OracleClient(address=address, timeout=120) as client:
            net_rel = {}
            for platform, ns in nets.items():
                got = np.asarray(client.predict_networks(platform, ns))
                want = direct[platform].predict_networks(ns, backend="numpy")
                np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=0)
                net_rel[platform] = float(np.max(np.abs(got - want) / want))
            tuned = client.autotune(ESTIMATE_PLATFORM, "qwen2-1.5b", seq_len=4096, batch=8, chips=16)
            numpy_oracle = dataclasses.replace(direct[ESTIMATE_PLATFORM], predict_backend="numpy")
            ranked = autotune(numpy_oracle, get_config("qwen2-1.5b"), shape, chips=16)
            if [(r["dp"], r["tp"], r["microbatches"]) for r in tuned] != \
                    [(c.dp, c.tp, c.microbatches) for c, _ in ranked]:
                raise AssertionError("served autotune ranks other candidates than the oracle")
            pairs = [(r["seconds"], s) for r, (_, s) in zip(tuned, ranked) if r["seconds"] is not None]
            np.testing.assert_allclose(*zip(*pairs), rtol=NET_RTOL, atol=0)
            stats = client.stats()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        if rc != 0:
            stderr.seek(0)
            raise AssertionError(f"the service exited {rc} on SIGINT:\n{stderr.read()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stdout.close()
        stderr.close()
    metrics = stats["metrics"]
    ep = metrics["endpoints"]["predict"]
    result = {
        "card": smi, "clients": SERVICE_CLIENTS, "configs_per_request": SERVICE_CONFIGS, "startup_s": startup_s,
        "rounds": load,
        "server_predict": {k: ep[k] for k in ("requests", "errors", "p50_ms", "p99_ms")},
        "batches": metrics["batches"], "mean_batch_size": metrics["mean_batch_size"],
        "batch_size_hist": metrics["batch_size_hist"], "result_cache": stats["result_cache"],
        "network_max_rel": net_rel, "autotune_candidates": len(tuned), "sigint_exit": rc,
    }
    log(f"service on the card: server-side predict p50 {ep['p50_ms']:.3f} ms, p99 {ep['p99_ms']:.3f} ms over "
        f"{ep['requests']} requests; {metrics['batches']} admission batches, "
        f"mean size {metrics['mean_batch_size']:.2f}; layers bitwise, networks within rtol {NET_RTOL:g} "
        f"({net_rel}); autotune {len(tuned)} candidates; SIGINT: drained, exit 0")
    return result


class InjectedFailure(RuntimeError):
    """The crash that phase 8 injects into a training run."""


def train_batch_on(cfg, seq: int, batch: int, step: int, dev) -> dict:
    """``SyntheticLMData``'s batch for ``step`` (seed ``SEED``) on ``dev``, as the trainer feeds it."""
    import torch

    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.config import InputShape

    data = SyntheticLMData(cfg, InputShape("train", seq, batch, "train"), seed=SEED).batch(step)
    return {k: torch.as_tensor(v, device=dev).long() if v.dtype.kind == "i" else torch.as_tensor(v, device=dev)
            for k, v in data.items()}


def rel_l2(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def kernel_counts() -> dict:
    from repro_torch.kernels import ops

    return {name: getattr(ops, name).launches for name in COUNTED_KERNELS}


def zero_kernel_counts() -> None:
    from repro_torch.kernels import ops

    for name in COUNTED_KERNELS:
        getattr(ops, name).launches = 0


def check_train_reduced(arch: str) -> dict:
    """Phase 8a: one train step of the reduced config (remat "full", batch 2,
    seq 200: a chunk boundary with a ragged tail) on the card against the same
    step on the CPU: loss, grad norm and every gradient leaf within
    ``TRAIN_REL_L2``; the card's scan launches as the layers dictate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.train.steps import make_train_step, value_and_grad

    cfg = dataclasses.replace(reduced(get_config(arch)), remat="full")  # the full configs' remat
    params_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu", param_dtype=torch.float32)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=TRAIN_STEPS)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = to_device(params_cpu, dev)
        batch = train_batch_on(cfg, 200, 2, 0, dev)
        zero_kernel_counts()
        loss, _, grads = value_and_grad(cfg, params, batch)
        counts = kernel_counts()
        _, _, metrics = make_train_step(cfg, opt_cfg)(params, adamw_init(params), batch)
        runs[dev] = (float(loss), float(metrics["grad_norm"]), tree_leaves(grads), counts)
    (loss_c, norm_c, g_c, _), (loss_g, norm_g, g_g, counts) = runs["cpu"], runs["cuda"]
    leaf_errs = [rel_l2(a, b) for a, b in zip(g_g, g_c)]
    n_layers = cfg.n_layers if cfg.family == "ssm" else 0
    want = {"ssd_scan": 2 * n_layers, "ssd_scan_bwd": n_layers, "flash_attention": 0,
            **dict.fromkeys(MIXER_KERNELS, 0)}
    ok = (abs(loss_g - loss_c) <= TRAIN_REL_L2 * abs(loss_c) and abs(norm_g - norm_c) <= TRAIN_REL_L2 * norm_c
          and max(leaf_errs) <= TRAIN_REL_L2 and counts == want
          and all(torch.isfinite(g).all() for g in g_g))
    log(f"train reduced {arch} (remat full, batch 2, seq 200), card vs CPU: loss {loss_g:.6f} / {loss_c:.6f}, "
        f"grad norm {norm_g:.6f} / {norm_c:.6f}, {len(leaf_errs)} gradient leaves, largest rel L2 "
        f"{max(leaf_errs):.3e} (bar {TRAIN_REL_L2:g}); launches {counts} (want {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reduced {arch}'s train step on the card disagrees with the CPU")
    return {"loss": [loss_g, loss_c], "grad_norm": [norm_g, norm_c], "max_leaf_rel_l2": max(leaf_errs),
            "leaves": len(leaf_errs), "launches": counts}


def profile_train_step(step_fn, wall_ms: float) -> dict:
    """Device-busy ms of one train step (torch.profiler: two sessions, each
    tracing a warm-up step and then the step; the one that recorded more
    kernels is kept) and its idle share against the unprofiled step ms."""
    prof = device_ms(step_fn, calls=1, warmup=0, sessions=2)
    return {"device_busy_ms": prof["ms"], "idle_share": idle_share(prof["ms"], wall_ms), "kernels": round(prof["kernels"]),
            "sessions_ms": prof["sessions_ms"], "top": [(k[:60], ms) for k, ms in prof["top"][:8]]}


def train_line(arch: str, smi: str, step_ms: list, tokens: int, peak_bytes: int, losses: list,
               counts: dict, steps: int, profile: dict, **extra) -> dict:
    after_first = step_ms[1:] or step_ms
    med = statistics.median(after_first)
    line = {"arch": arch, "card": smi, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
            "step_ms": step_ms, "step_ms_median_after_first": med, "tokens_per_s": tokens / (med / 1e3),
            "peak_memory_gib": peak_bytes / 2**30, "losses": losses,
            "launches_per_step": {k: v / steps for k, v in counts.items()}, "profile": profile, **extra}
    log(f"train {arch} at full width and depth, batch {TRAIN_BATCH} x seq {TRAIN_SEQ} on {smi}: step "
        f"{med:.1f} ms (median of steps 2-{len(step_ms)}; CUDA events), {line['tokens_per_s']:.0f} tokens/s, "
        f"peak {line['peak_memory_gib']:.2f} GiB, one step's device busy {fmt(profile['device_busy_ms'], '.1f')} ms "
        f"(idle share {fmt(profile['idle_share'], '.3f')}, {profile['kernels']} kernels), launches per step "
        f"{line['launches_per_step']}, losses {[round(x, 4) for x in losses]}")
    log("  top kernels of one step: " + "; ".join(f"{k} {ms:.1f} ms" for k, ms in profile["top"]))
    return line


def _event_hook(events: list, fail_at: int | None = None):
    import torch

    def hook(step: int) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if step == fail_at:
            raise InjectedFailure(f"injected failure at step {step}")

    return hook


def _step_ms(events: list) -> list:
    import torch

    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def train_mamba2(smi: str) -> dict:
    """Phase 8b: mamba2-780m at full width and depth through the ``Trainer`` of
    ``repro_torch.launch.train``: random fp32 masters from a seeded generator,
    batch 2 x 4,096 (``train_4k``'s sequence, 32 scan chunks a row),
    ``AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=8)``.  A run that
    checkpoints every 2 steps fails at step 5 and resumes from step 4; an
    uninterrupted run beside it is timed and counted.  Losses finite and
    falling, 96 forward and 48 backward scan launches per step, the resumed
    losses and final parameters equal to the uninterrupted run's."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.config import InputShape
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.train.steps import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("mamba2-780m")
    shape = InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=TRAIN_STEPS)
    work = ROOT / "build"
    work.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        log(f"train mamba2-780m: checkpoints under {tmp}; disk free {shutil.disk_usage(tmp).free / 2**30:.1f} GiB")
        resume_dir = str(Path(tmp) / "resume")

        def trainer(directory, every, hook):
            tcfg = TrainerConfig(steps=TRAIN_STEPS, checkpoint_every=every, checkpoint_dir=directory, keep=1,
                                 seed=SEED, log_every=TRAIN_STEPS)
            return Trainer(cfg, shape, None, tcfg, opt_cfg, failure_hook=hook, device="cuda")

        t0 = time.perf_counter()
        first = trainer(resume_dir, TRAIN_CKPT_EVERY, _event_hook([], TRAIN_FAIL_AT))
        try:
            first.run()
        except InjectedFailure as e:
            log(f"train mamba2-780m: {e} after {len(first.history)} steps")
        else:
            raise AssertionError("the injected failure did not stop the run")
        latest = CheckpointManager(resume_dir).latest_step()
        if latest != TRAIN_FAIL_AT - TRAIN_FAIL_AT % TRAIN_CKPT_EVERY:
            raise AssertionError(f"latest checkpoint {latest} after a failure at step {TRAIN_FAIL_AT}")
        interrupted_s = time.perf_counter() - t0
        first_losses = [h["loss"] for h in first.history]
        del first
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = trainer(resume_dir, TRAIN_CKPT_EVERY, _event_hook([]))
        resumed.run()
        resumed_s = time.perf_counter() - t0
        # on the host, so the uninterrupted run's peak below is its own
        resumed_params, resumed_history = [t.cpu() for t in tree_leaves(resumed.params)], resumed.history
        del resumed
        torch.cuda.empty_cache()

        events: list = []
        straight = trainer(str(Path(tmp) / "straight"), TRAIN_STEPS, _event_hook(events))
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        t0 = time.perf_counter()
        straight.run()
        straight_s = time.perf_counter() - t0
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        step_ms = _step_ms(events)
    losses = [h["loss"] for h in straight.history]
    resumed_losses = [h["loss"] for h in resumed_history]
    loss_gap = max(abs(a - b) for a, b in zip(first_losses + resumed_losses, losses[:len(first_losses)] + losses[latest:]))
    param_gap = max((a - b.cpu()).abs().max().item() for a, b in zip(resumed_params,
                                                               tree_leaves(straight.params)))
    del resumed_params
    want = {"ssd_scan": 2 * cfg.n_layers * TRAIN_STEPS, "ssd_scan_bwd": cfg.n_layers * TRAIN_STEPS,
            "flash_attention": 0, **dict.fromkeys(MIXER_KERNELS, 0)}
    step_fn = make_train_step(cfg, opt_cfg)
    batch = train_batch_on(cfg, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, "cuda")
    profile = profile_train_step(lambda: step_fn(straight.params, straight.opt_state, batch),
                                 statistics.median(step_ms[1:]))
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0] and counts == want
          and loss_gap <= RESUME_TOL and param_gap <= RESUME_TOL and [h["step"] for h in resumed_history]
          == list(range(latest, TRAIN_STEPS)))
    log(f"train mamba2-780m resume: failed at step {TRAIN_FAIL_AT}, resumed from checkpoint {latest}; resumed "
        f"losses {[round(x, 6) for x in resumed_losses]} against the uninterrupted run's "
        f"{[round(x, 6) for x in losses[latest:]]}: max abs {loss_gap:.3e} (the interrupted run's steps "
        f"0-{len(first_losses) - 1} included); final parameters max abs "
        f"{param_gap:.3e} (bar {RESUME_TOL:g}); launches {counts} (want {want}) {'ok' if ok else 'FAIL'}")
    line = train_line("mamba2-780m", smi, step_ms, TRAIN_BATCH * TRAIN_SEQ, peak, losses, counts, TRAIN_STEPS,
                      profile, resume={"failed_at": TRAIN_FAIL_AT, "restored_step": latest,
                                       "loss_max_abs": loss_gap, "param_max_abs": param_gap},
                      run_seconds={"interrupted": interrupted_s, "resumed": resumed_s, "uninterrupted": straight_s},
                      step_time_s=[h["step_time_s"] for h in straight.history])
    if not ok:
        raise AssertionError("mamba2-780m's training run failed its checks")
    return line


def train_qwen2(smi: str) -> dict:
    """Phase 8c: qwen2-1.5b at full width and depth, ``QWEN_TRAIN_STEPS`` steps of
    ``make_train_step`` at batch 2 x 4,096 from fp32 masters; the chunked
    attention route, as the config has it: no kernel of the port launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = get_config("qwen2-1.5b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda", param_dtype=torch.float32)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=QWEN_TRAIN_STEPS))
    events, losses = [], []
    hook = _event_hook(events)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    for step in range(QWEN_TRAIN_STEPS):
        batch = train_batch_on(cfg, TRAIN_SEQ, TRAIN_BATCH, step, "cuda")
        hook(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    hook(QWEN_TRAIN_STEPS)
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = _step_ms(events)
    profile = profile_train_step(lambda: step_fn(params, opt_state, batch), statistics.median(step_ms[1:]))
    ok = all(math.isfinite(x) for x in losses) and not any(counts.values())
    line = train_line("qwen2-1.5b", smi, step_ms, TRAIN_BATCH * TRAIN_SEQ, peak, losses, counts,
                      QWEN_TRAIN_STEPS, profile)
    if not ok:
        raise AssertionError(f"qwen2-1.5b's training: losses {losses}, kernel launches {counts}")
    return line


#: phase 9(a): production cells of the dry run, on fake ranks of the production meshes
DRYRUN_CELLS = (
    ("mamba2-780m", "train_4k", "single"),    # the scan's forward and backward, heads 48 over tp 16
    ("granite-20b", "decode_32k", "single"),  # q_sharded, a sequence-sharded cache, decode_seq_sharded
    ("olmoe-1b-7b", "prefill_32k", "single"),  # 64 experts, 4 per rank
    ("zamba2-2.7b", "train_4k", "single"),    # fsdp, the scan and the shared attention
    ("qwen2-1.5b", "train_4k", "multi"),      # 512 ranks with the pod axis
)
#: phase 9(b): the grounding cell's bars against phase 8's measured run
DRYRUN_PEAK_TOL = 0.15
DRYRUN_FLOP_RATIO = (1.0, 2.0)
DRYRUN_SECONDS = 300


def dryrun_line(art: dict) -> dict:
    """The per-rank figures of one dry-run artifact (predictions for H100s)."""
    r, m = art["roofline"], art["memory_analysis"]
    return {"cell": f"{art['arch']}__{art['shape']}__{art['mesh']}__base", "chips": art["chips"],
            "dp": art["dp"], "tp": art["tp"], "fsdp": art["fsdp"],
            "argument_bytes": m["argument_size_in_bytes"], "peak_bytes": m["peak_bytes"],
            "fits_80gb": art["fits_80gb"], "flops": art["cost"]["flops"],
            "collective_bytes": art["collective"]["bytes"], "collective_counts": art["collective"]["counts"],
            "compute_s": r["compute_s"], "memory_s": r["memory_s"], "collective_s": r["collective_s"],
            "step_time_s": r["step_time_s"], "bottleneck": r["bottleneck"], "model_flops": r["model_flops"],
            "trace_s": art["trace_s"]}


def dryrun_phase(mamba_train: dict) -> dict:
    """Phase 9: the dry run on fake CUDA tensors.

    (a) the production cells of ``DRYRUN_CELLS``, each one full-depth step
    traced as rank 0 of a fake process group of 256 (512) ranks over a
    ``"cuda"`` mesh: per-rank argument and peak bytes, FLOPs, collective bytes
    by kind, the H100 roofline terms and the bottleneck (predictions);
    (b) the grounding cell: mamba2-780m at phase 8's shape (batch 2 x 4,096,
    fp32 masters, remat "full") on a 1 x 1 mesh, its predicted peak against
    phase 8's measured ``max_memory_allocated`` (within ``DRYRUN_PEAK_TOL``),
    its roofline step against phase 8's median step (not above it), its
    counted FLOPs over ``model_flops`` within ``DRYRUN_FLOP_RATIO``;
    (c) no kernel launches: a fake tensor computes nothing."""
    import dataclasses

    from repro_torch import distributed as D
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.config import InputShape

    zero_kernel_counts()
    out = {"cells": []}
    for arch, shape, mesh in DRYRUN_CELLS:
        t0 = time.perf_counter()
        line = dryrun_line(DR.lower_cell(arch, shape, mesh == "multi", DR.DryrunKnobs(), "cuda"))
        line["seconds"] = time.perf_counter() - t0
        log(f"dry run {line['cell']} ({line['chips']} fake ranks, dp {line['dp']} x tp {line['tp']}"
            f"{', fsdp' if line['fsdp'] else ''}; predictions for H100s, per rank): arguments "
            f"{line['argument_bytes'] / 2**30:.2f} GiB, peak {line['peak_bytes'] / 2**30:.2f} GiB, "
            f"{line['flops']:.4g} FLOPs, collectives "
            + ", ".join(f"{k} {v / 2**30:.3f} GiB x{line['collective_counts'][k]}"
                        for k, v in line["collective_bytes"].items() if v)
            + f"; roofline compute {line['compute_s'] * 1e3:.2f} ms, memory {line['memory_s'] * 1e3:.2f} ms, "
            f"collective {line['collective_s'] * 1e3:.2f} ms: {line['bottleneck']}-bound, step "
            f"{line['step_time_s'] * 1e3:.2f} ms; traced in {line['seconds']:.1f} s")
        out["cells"].append(line)

    cfg = get_config("mamba2-780m")
    shape = InputShape("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    with DR.fake_world(1, (1, 1), ("data", "model"), "cuda") as mesh:
        counts = DR.trace_step(cfg, shape, D.for_mesh(mesh), DR.DryrunKnobs(), "cuda")
    art = DR.artifact("mamba2-780m", "train_2x4096", "1x1", cfg, shape, 1, 1, 1, False, DR.DryrunKnobs(), counts)
    measured_peak = mamba_train["peak_memory_gib"] * 2**30
    measured_ms = mamba_train["step_ms_median_after_first"]
    ratio = art["cost"]["flops"] / art["roofline"]["model_flops"]
    peak_gap = art["memory_analysis"]["peak_bytes"] / measured_peak - 1
    ground = {**dryrun_line(art), "seconds": time.perf_counter() - t0,
              "measured_peak_bytes": measured_peak, "peak_gap": peak_gap,
              "measured_step_ms": measured_ms, "roofline_step_ms": art["roofline"]["step_time_s"] * 1e3,
              "flops_over_model_flops": ratio, "flops_by_op": art["flops_by_op"]}
    ok = (abs(peak_gap) <= DRYRUN_PEAK_TOL and ground["roofline_step_ms"] <= measured_ms
          and DRYRUN_FLOP_RATIO[0] <= ratio <= DRYRUN_FLOP_RATIO[1])
    log(f"dry run grounding: mamba2-780m batch {TRAIN_BATCH} x {TRAIN_SEQ} on a 1 x 1 mesh: predicted peak "
        f"{ground['peak_bytes'] / 2**30:.2f} GiB against phase 8's measured {measured_peak / 2**30:.2f} GiB "
        f"({peak_gap:+.3f}, bar {DRYRUN_PEAK_TOL}); roofline step {ground['roofline_step_ms']:.2f} ms "
        f"({ground['bottleneck']}) against the measured median {measured_ms:.1f} ms; counted FLOPs "
        f"{ground['flops']:.4g} = {ratio:.3f} x model_flops {ground['model_flops']:.4g} (bar {DRYRUN_FLOP_RATIO}); "
        f"arguments {ground['argument_bytes'] / 2**30:.2f} GiB; traced in {ground['seconds']:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    out["grounding"] = ground
    out["kernel_launches"] = kernel_counts()
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"the dry run launched kernels: {out['kernel_launches']}")
    if not ok:
        raise AssertionError("the dry run's grounding cell missed its bars")
    return out


def run_lint() -> dict:
    """``python -m repro_torch.analysis src/repro_torch``: every rule of the
    port's linter over the port; fails unless it reports 0 unsuppressed findings."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(SRC / "repro_torch"), "--format", "json"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    report = json.loads(proc.stdout)
    line = {"exit_code": proc.returncode, "files": report["files"], "findings": len(report["findings"]),
            "suppressed": report["suppressed"], "seconds": time.perf_counter() - t0}
    log(f"repro_torch.analysis src/repro_torch: exit {proc.returncode}, {line['findings']} finding(s), "
        f"{line['suppressed']} suppressed, {line['files']} file(s)")
    if proc.returncode != 0 or report["findings"]:
        raise AssertionError(f"repro-lint found {report['findings']}")
    return line


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
    to_build = (*TRAIN_KERNELS, "ssm_mixer", "moe_grouped")
    with ThreadPoolExecutor(len(to_build)) as pool:
        built = dict(zip(to_build, pool.map(build.build, to_build)))
    log(f"build: {len(to_build)} sources in {time.perf_counter() - t0:.1f} s")
    for name, (lib, report, nvcc_s) in built.items():
        log(f"  {lib.name}: nvcc {nvcc_s:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas: {line.strip()}")

    # ---- 2b. repro-lint of the port, on this machine's Python
    lint = run_lint()

    # ---- 3. kernels against their plain versions
    checks = {"flash_attention": check_flash(), "ssd_scan": check_ssd()}
    # ---- 3b. the scan's backward kernel, matmul_f32's gradient, flash's refusal of autograd
    t0 = time.perf_counter()
    checks["ssd_scan_bwd"] = check_ssd_bwd()
    log(f"phase 3b: {time.perf_counter() - t0:.1f} s")
    # ---- 3c. the mixer's two kernels: card tests, and timed at prompt-2k's shape
    mixer = check_ssm_mixer()
    # ---- 3d. the grouped expert products: both entry points at olmoe-1b-7b-0924.prompt-4k's shapes
    moe_grouped = check_moe_grouped()

    # ---- 4 and 5. the slices, and each kernel at each of its slices' shapes
    slices, launches = [], {name: {} for name in KERNELS}
    for arch in SLICES:
        t0 = time.perf_counter()
        line, by_kernel = serve_slice(arch)
        line["phase_seconds"] = time.perf_counter() - t0
        log(f"{arch}: {line['phase_seconds']:.1f} s")
        slices.append(line)
        for name, n in by_kernel.items():
            if n:
                launches[name][arch] = n
        torch.cuda.empty_cache()
    # ---- 5b. the published OLMoE, dropless, through generate
    published = published_moe_slice()
    launches["moe_grouped_mm"][PUBLISHED_MOE] = published["launches"]["moe_grouped_mm"]
    moe_grouped["launches_by_slice"] = launches["moe_grouped_mm"]
    torch.cuda.empty_cache()
    timings = {name: {} for name in SLICE_TIMED}
    for name in SLICE_TIMED:
        for arch in launches[name]:
            timings[name][arch] = time_flash(arch) if name == "flash_attention" else time_ssd(arch)
    train_timing = time_ssd_train()  # the scan's two kernels at the training shape of phase 8

    # ---- 6. the estimation pipeline, the card as its black-box platform
    from repro_torch.kernels import ops

    for name in KERNELS:
        getattr(ops, name).launches = 0
    held, estimation = estimate_on_card(smi)
    estimation["analytic"] = analytic_on_card(smi)
    estimation["kernel_launches"] = {name: getattr(ops, name).launches for name in KERNELS}

    # ---- 6c. the measurement runtime, the oracle service and the trace report
    import tempfile

    for name in KERNELS:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        estimation["runtime"] = runtime_on_card(smi, held, work)
        estimation["runtime"]["deterministic"] = deterministic_on_card(work)
        estimation["service"] = service_on_card(smi, work / "hub")
    launched = {name: getattr(ops, name).launches for name in KERNELS}
    if any(launched.values()):
        raise AssertionError(f"phase 6c launched the port's kernels: {launched}")
    estimation["runtime"]["kernel_launches"] = launched
    estimation["runtime"]["phase_seconds"] = time.perf_counter() - t0
    log(f"phase 6c: {estimation['runtime']['phase_seconds']:.1f} s; kernel launches {launched}")

    # ---- 8. training: reduced on the card against the CPU, then mamba2-780m and qwen2-1.5b at full size
    train = {"reduced": {}}
    t0 = time.perf_counter()
    for arch in ("mamba2-780m", "qwen2-1.5b"):
        train["reduced"][arch] = check_train_reduced(arch)
    train["reduced"]["phase_seconds"] = time.perf_counter() - t0
    train_lines = []
    for run in (train_mamba2, train_qwen2):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        line = run(smi)
        line["phase_seconds"] = time.perf_counter() - t0
        log(f"train {line['arch']}: {line['phase_seconds']:.1f} s")
        train_lines.append(line)
    mamba_train = train_lines[0]

    # ---- 9. the dry run: production cells on fake ranks, grounded on phase 8's mamba2 step
    t0 = time.perf_counter()
    dryrun = dryrun_phase(mamba_train)
    dryrun["phase_seconds"] = time.perf_counter() - t0
    log(f"phase 9: {dryrun['phase_seconds']:.1f} s (limit {DRYRUN_SECONDS} s)")
    if dryrun["phase_seconds"] > DRYRUN_SECONDS:
        raise AssertionError(f"phase 9 took {dryrun['phase_seconds']:.1f} s, over {DRYRUN_SECONDS} s")
    train_launches = {name: round(n * mamba_train["steps"]) for name, n in mamba_train["launches_per_step"].items()}
    launches["ssd_scan"]["train mamba2-780m"] = train_launches["ssd_scan"]
    mixer["launches_by_slice"] = {name: {**launches[name], "train mamba2-780m": train_launches[name]}
                                  for name in MIXER_KERNELS}
    timings["ssd_scan"]["train mamba2-780m"] = train_timing["ssd_scan"]

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
    # shape earlier runs timed); "by_slice" holds every slice's, launches included
    # (the training step's as "train mamba2-780m").
    kernels = []
    for name in SLICE_TIMED:
        by_slice = {arch: {"launches": launches[name][arch], **per_shape(t, checks[name][arch])}
                    for arch, t in timings[name].items()}
        first = next(iter(by_slice.values()))
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": sum(launches[name].values()), "launches_by_slice": launches[name],
            "max_abs_err": max(checks[name].values()),
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "event_ms",
                                     "plain_event_ms", "library_event_ms", "profiler_ms", "plain_profiler_ms",
                                     "library_profiler_ms", "bound_share", "ms_over_library_ms")},
            "by_slice": by_slice,
        })
    bwd = per_shape(train_timing["ssd_scan_bwd"], checks["ssd_scan_bwd"]["mamba2-780m"])
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "jax.grad of src/repro/models/ssm.py::ssd_chunked (:49)",
        "launches": train_launches["ssd_scan_bwd"],
        "launches_by_slice": {"train mamba2-780m": train_launches["ssd_scan_bwd"]},
        "max_abs_err": bwd["max_abs_err"],
        **{k: bwd[k] for k in ("ms", "ms_again", "plain_ms", "bound_ms", "bound_by", "library_ms", "event_ms",
                               "plain_event_ms", "profiler_ms", "bound_share", "x", "n", "split", "scratch_bytes")},
    })
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"lint": lint}))
    for line in slices:
        log(json.dumps({"slice": {**line, "card": smi}}))
    for line in train_lines:
        log(json.dumps({"train": line}))
    log(json.dumps({"train_reduced": train["reduced"]}))
    for line in dryrun["cells"]:
        log(json.dumps({"dryrun": line}))
    log(json.dumps({"dryrun_grounding": {**dryrun["grounding"], "phase_seconds": dryrun["phase_seconds"],
                                          "kernel_launches": dryrun["kernel_launches"]}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ssm_mixer": mixer}))
    log(json.dumps({"published_moe": {**published, "card": smi}}))
    log(json.dumps({"moe_grouped": moe_grouped}))
    log(json.dumps({"estimation": estimation}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
