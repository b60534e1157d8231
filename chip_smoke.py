#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU (built for the H100).

  python3 chip_smoke.py

Phases, each failing loudly (an exception or a non-zero exit):

1. refuse to run without CUDA or without ``src/repro_torch`` beside this
   script; print the card's name and power limit as nvidia-smi gives them;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. hold each kernel against its plain PyTorch version on the card;
4. the slice: qwen2-1.5b at full width (28 layers, random bf16 weights from a
   seeded ``torch.Generator``) serves batch 4, prompt 512, gen 32 through
   ``repro_torch.launch.serve.generate`` on the flash route.  The kernel's
   launch counter is set to 0 just before and read just after: 28 launches
   (one per layer, in the cached prefill).  The prefill logits are held
   against the same prefill through the plain attention route, and a reduced
   config's logits on the card against the CPU;
5. timings from CUDA events after a warm-up: prefill, decode, tok/s, the
   kernel at the slice shape beside its plain version and PyTorch's
   ``scaled_dot_product_attention`` (timed as a yardstick only: the port never
   calls it), and peak memory; a torch.profiler pass over one prefill and
   one decode step gives wall time, device-busy time, the device's idle
   share and the top kernels;
6. a ``{"kernels": [...]}`` line, then the result line, last:
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 / fp32 FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

BF16_TOL = dict(atol=2e-2, rtol=2e-2)  # the reference's bf16 kernel bar
F32_TOL = dict(atol=2e-5, rtol=2e-5)  # the reference's fp32 kernel bar
# End to end, 28 bf16 layers: the flash route keeps P in fp32 where the plain
# chunked route rounds q*scale and P to bf16, and the bf16 residual stream
# carries such 2^-8 steps through every layer; a relative L2 error of 2e-2
# (five bf16 steps) admits that and no wrong function.
PREFILL_REL_L2 = 2e-2

ARCH, BATCH, PROMPT, GEN, SEED = "qwen2-1.5b", 4, 512, 32, 0


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


def profile_ms(fn) -> tuple[float, int, list[tuple[str, float]]]:
    """One warm run of ``fn`` under torch.profiler: (device-busy ms, kernels launched, top kernels).

    Device-busy time sums the kernels' own device time, as the profiler's
    table totals it.  The profiler slows the host, so the idle share is taken
    against the unprofiled CUDA-event time of the same call.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in kernels), key=lambda t: -t[1])
    return busy_ms, sum(e.count for e in kernels), top


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
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(q.dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels() -> dict:
    """Phase 3: the flash kernel against its plain version at every test shape."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [
        # name, b, sq, skv, h, kvh, d, dtype, causal, q_offset
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
    ]
    slice_err = None
    for name, b, sq, skv, h, kvh, d, dt, causal, off in cases:
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, skv, kvh, d), generator=gen, device="cuda").to(dt)
        o = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        r = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        tol = BF16_TOL if dt == torch.bfloat16 else F32_TOL
        err = (o.float() - r.float()).abs().max().item()
        ok = torch.allclose(o.float(), r.float(), **tol)
        log(f"kernel flash_attention [{name}] q{tuple(q.shape)} kv{tuple(k.shape)} "
            f"{str(dt)[6:]} causal={causal} q_offset={off}: max_abs_err={err:.3e} "
            f"(atol=rtol={tol['atol']:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention [{name}] disagrees with its plain version")
        if name == "slice prefill":
            slice_err = err
    q = torch.zeros((1, 8, 2, 12), device="cuda")
    try:
        ops.flash_attention(q, q, q)
    except ValueError as e:
        log(f"kernel flash_attention refuses head dim 12: {e}")
    else:
        raise AssertionError("flash_attention accepted head dim 12")
    return {"max_abs_err": slice_err}


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


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
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache

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

    # ---- 2. build
    t0 = time.perf_counter()
    lib, report, nvcc_s = build.build("flash_attention")
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s (nvcc {nvcc_s:.1f} s)")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain versions
    flash = check_kernels()

    # ---- 4. the slice at full width
    cfg = dataclasses.replace(get_config(ARCH), attention_impl="flash_pallas")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"init {ARCH}: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab, size=(BATCH, PROMPT))

    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0
    tokens = generate(cfg, params, prompts, GEN, device="cuda")
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"generate: tokens {tuple(tokens.shape)}, flash_attention launches {launches} "
        f"(expected {cfg.n_layers}), peak memory {peak_gib:.2f} GiB")
    assert launches == cfg.n_layers, f"{launches} flash launches, expected {cfg.n_layers}"
    assert tokens.shape == (BATCH, GEN) and tokens.dtype == torch.long
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab

    tok_in = torch.as_tensor(prompts, device="cuda")
    with torch.no_grad():
        cache = init_cache(cfg, BATCH, PROMPT + GEN, "cuda")
        logits_f, _, _ = T.forward(params, cfg, {"tokens": tok_in}, cache)
        plain_cfg = dataclasses.replace(cfg, attention_impl="xla_chunked")
        cache = init_cache(cfg, BATCH, PROMPT + GEN, "cuda")
        logits_p, _, _ = T.forward(params, plain_cfg, {"tokens": tok_in}, cache)
    assert logits_f.shape == (BATCH, PROMPT, cfg.vocab) and logits_f.dtype == torch.float32
    assert bool(torch.isfinite(logits_f).all()), "non-finite prefill logits"
    rel = ((logits_f - logits_p).norm() / logits_p.norm()).item()
    agree = (logits_f.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"prefill logits, flash vs plain route: rel L2 {rel:.3e} (bar {PREFILL_REL_L2:g}), "
        f"max abs {(logits_f - logits_p).abs().max().item():.3e}, "
        f"|logits| max {logits_p.abs().max().item():.3f}, argmax agreement {agree:.4f}")
    assert rel <= PREFILL_REL_L2, "flash prefill disagrees with the plain route"
    assert torch.equal(tokens[:, 0], logits_f[:, -1].argmax(-1)), "first token != prefill argmax"
    del logits_f, logits_p, cache

    check_reduced_against_cpu()

    # ---- 5. timings
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
            busy_ms, n_kernels, top = profile_ms(fn)
            breakdown[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "idle_share": 1.0 - busy_ms / wall_ms, "kernels": n_kernels}
            log(f"profile {name}: {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
                f"idle share {1.0 - busy_ms / wall_ms:.3f}, {n_kernels} kernels; top: "
                + "; ".join(f"{k[:48]} {ms:.3f} ms" for k, ms in top[:6]))
    log(f"prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms ({BATCH * PROMPT / prefill_ms * 1e3:.0f} tok/s); "
        f"decode: {decode_ms:.3f} ms/step ({BATCH / decode_ms * 1e3:.1f} tok/s at batch {BATCH}); "
        f"generate {BATCH}x{GEN}: {gen_ms:.3f} ms ({BATCH * GEN / gen_ms * 1e3:.1f} tok/s)")

    q = torch.randn((BATCH, PROMPT, cfg.n_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    k = torch.randn((BATCH, PROMPT + GEN, cfg.n_kv_heads, cfg.head_dim), generator=gen, device="cuda").bfloat16()
    v = torch.randn_like(k)
    kernel_ms = cuda_time_ms(lambda: ops.flash_attention(q, k, v, causal=True), reps=20)
    plain_ms = cuda_time_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), reps=20)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    sdpa_err = (sdpa().transpose(1, 2).float() - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
    library_ms = cuda_time_ms(sdpa, reps=20)
    bound_ms, bound_by = flash_bound_ms(q, k, causal=True)
    log(f"flash_attention q{tuple(q.shape)} kv{tuple(k.shape)} bf16 causal: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (max abs vs plain {sdpa_err:.2e}), "
        f"bound {bound_ms:.4f} ms ({bound_by}); {launches} launches x {kernel_ms:.4f} ms "
        f"= {launches * kernel_ms:.3f} ms of the {prefill_ms:.3f} ms prefill")

    # ---- 6. result lines
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": launches,
        "max_abs_err": flash["max_abs_err"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    log(json.dumps({"slice": {"arch": ARCH, "batch": BATCH, "prompt": PROMPT, "gen": GEN,
                              "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
                              "generate_ms": gen_ms, "peak_gib": peak_gib, "profile": breakdown,
                              "card": smi}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def check_reduced_against_cpu() -> None:
    """A small input through the whole model: the card (kernel) against the CPU (plain)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.config import reduced
    from repro_torch.models.kvcache import init_cache

    cfg = dataclasses.replace(reduced(get_config(ARCH)), attention_impl="flash_pallas")
    params_cpu = T.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    params_gpu = to_device(params_cpu, "cuda")
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, size=(2, 24))
    out = {}
    with torch.no_grad():
        for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
            cache = init_cache(cfg, 2, 28, dev)
            logits, _, _ = T.forward(params, cfg, {"tokens": torch.as_tensor(prompts, device=dev)}, cache)
            out[dev] = logits.cpu()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    ok = torch.allclose(out["cuda"], out["cpu"], **BF16_TOL)
    log(f"reduced {ARCH} prefill logits, card vs CPU: max abs {err:.3e} "
        f"(atol=rtol={BF16_TOL['atol']:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "reduced model on the card disagrees with the CPU"


if __name__ == "__main__":
    sys.exit(main())
