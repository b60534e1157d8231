"""Serving launcher of the port: batched prefill + greedy decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
      --batch 4 --prompt-len 416 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --estimate-only --device cpu --hub-dir /tmp/hub --workers 2
  PYTHONPATH=src python -m repro_torch.launch.serve --fsck --hub-dir /tmp/hub
  PYTHONPATH=src python -m repro_torch.launch.serve --serve-oracle \
      --hub-dir /tmp/hub --port 7070 --warm-platforms 'tpu_v5e[gray]'

Ported from ``repro.launch.serve``: the model-run path of every family, and
the oracle estimate of a decode step.  It runs on ``cuda`` unless ``--device
cpu`` is given, and raises without a card.  On the card the decode step runs
as a captured CUDA graph (``generate``).  As in the reference, whisper's
prompt comes with random 0.1-scaled frames (``encoder_seq`` of them) and
qwen2-vl's with no vision embeddings.  One departure: ``--attention-impl``
(default ``flash_pallas``) overrides the config's attention route, so by
default every causal cached prefill runs the hand-written Hopper
flash-attention kernel; whisper's encoder and cross-attention are not
causal and take the chunked route.  A mamba layer's prefill (mamba2,
zamba2) runs the hand-written SSD-scan kernel on the card whatever the flag
says.

torch and the model stack are imported inside the functions that run a
model, so ``--estimate-only``, ``--fsck`` and ``--serve-oracle`` (and an
import of this module) do not load torch, as the reference keeps jax out.

``--estimate`` first prints a PR-oracle prediction of one decode step on
the simulated TPU-v5e platform (``tpu_v5e[gray]``, an analytic model, not
this machine), and ``--estimate-only`` stops there; ``--hub-dir`` reloads a
persisted oracle instead of training one, and the oracle predicts on
``--device``.  ``--workers`` > 1 measures the campaign through a pool of
spawned worker processes, and ``--journal-dir`` (or the hub, by default)
holds its crash-safe journal, from which a killed run resumes
(``repro_torch.runtime``).  ``--fsck`` checks that journal and ``--repair``
compacts it.

``--serve-oracle`` turns the launcher into the estimation service: it loads
the hub once and serves predict / predict_networks / autotune / stats over
line-delimited JSON (``--port`` for TCP, ``--unix-socket`` for a local
socket; see ``repro_torch.serving``), its oracles predicting on ``--device``;
SIGINT drains the requests in flight (``--drain-s``) and exits 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models.config import reduced


def generate(cfg, params, prompts, gen_len: int, device=None, extras: dict | None = None):
    """Greedy generation: prefill via forward-with-cache, then decode steps.

    prompts: (B, S) integer array or tensor; ``extras`` adds the batch's
    other inputs as the reference's ``generate`` does (``frames`` for
    whisper, ``vision_embeds`` for qwen2-vl), arrays or tensors.  Returns
    (B, gen_len) int64 tokens on ``device`` (default ``cuda``), where
    ``params`` must live.

    The cache holds S + gen_len positions, sized from the prompt alone as in
    the reference, so vision embeddings in front of the prompt overflow it:
    the reference fails there (``launch/serve.py:45``), and so does this
    function, with a ``ValueError`` before any work.

    The prefill runs eager, once.  On the card the decode step runs as the
    reference's runs under ``jax.jit``, compiled: one eager step warms up and
    captures a CUDA graph (``capture_serve_step``), which is replayed for
    the other ``gen_len - 2`` steps; a failed capture or replay raises.  On
    the CPU every step runs eager.

    The call records its phases (``repro_torch.phases``): ``serve.generate``
    around it all, ``serve.first_token`` from the call to the first token's
    ``argmax`` on the device, ``serve.prefill``, ``serve.capture`` and
    ``serve.decode`` (every later step), the first token on the device's
    clock too (and the decode, when a tracer is installed); the allocator's
    device allocations and frees
    since the previous call returned (``serve.device_allocs``); and the
    counters ``serve.batches``, ``serve.prompt_tokens``,
    ``serve.generated_tokens``, ``serve.graph_captures`` and
    ``serve.graph_replays``.  None of it waits for the device.
    """
    import torch

    from repro_torch import phases
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import init_cache
    from repro_torch.train.steps import capture_serve_step, make_serve_step

    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, generate asked for {dev}")
    with phases.phase("serve.generate") as call, torch.no_grad():
        with phases.phase("serve.first_token", dev):
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
            b, s = tokens.shape
            batch = {"tokens": tokens}
            for k, v in (extras or {}).items():
                batch[k] = v.to(dev) if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v), device=dev)
            # A decode step writes at the cache's device-side length with no bounds
            # check; this cache holds the prompt and every step's write (the last at
            # position s + gen_len - 2), which settles the room on the host, once.
            n_vis = batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0
            if n_vis + s + gen_len - 1 > s + gen_len:
                raise ValueError(
                    f"{n_vis} vision tokens before a prompt of {s} and {gen_len - 1} decode steps do not fit "
                    f"the cache of {s + gen_len} positions that generate sizes from the prompt, as the "
                    f"reference's does"
                )
            cache = init_cache(cfg, b, s + gen_len, dev)
            if cfg.family == "audio":
                cache.pop("enc_kv")  # computed by the prefill
            with phases.phase("serve.prefill"):
                logits, _, cache = T.forward(params, cfg, batch, cache)
            out = [torch.argmax(logits[:, -1, :], dim=-1)]
        graph = dev.type == "cuda" and gen_len > 1
        replays = gen_len - 2 if graph else 0
        if call:
            call.set(batch_id=phases.counter("serve.batches").value + 1, batch=b, prompt=s, gen=gen_len)
        if graph:
            with phases.phase("serve.capture"):
                step = capture_serve_step(cfg, params, cache, {"tokens": out[-1][:, None]})
            out.append(step.tokens[:, 0].clone())
            # timed on the device only when traced: a pair costs ~13 us of host time (phases)
            with phases.phase("serve.decode", dev if call else None) as ph:
                if ph:
                    ph.set(replays=replays)
                for _ in range(replays):
                    out.append(step.replay()[:, 0].clone())
            phases.count("serve.graph_captures")
            phases.count("serve.graph_replays", replays)
        else:
            serve_step = make_serve_step(cfg)
            with phases.phase("serve.decode"):
                for _ in range(gen_len - 1):
                    next_tok, cache = serve_step(params, cache, {"tokens": out[-1][:, None]})
                    out.append(next_tok)
        tokens_out = torch.stack(out, dim=1)
    phases.count("serve.batches")
    phases.count("serve.prompt_tokens", b * s)
    phases.count("serve.generated_tokens", b * gen_len)
    phases.allocator_calls("serve", dev)
    return tokens_out


#: the estimate's platform, as a hub names it, and the layer types it trains
ESTIMATE_PLATFORM = "tpu_v5e[gray]"
ESTIMATE_LAYER_TYPES = ("dense", "attention_decode", "moe_gemm", "ssd_scan", "embed")


def estimate_decode_step(cfg, batch: int, seq_len: int, hub_dir: str | None = None,
                         n_samples: int = 400, workers: int = 1, journal_dir: str | None = None,
                         device: str | None = None) -> float:
    """PR-oracle estimate of one decode step's time on the TPU-v5e platform.

    Loads a persisted oracle from ``hub_dir`` when one is available there,
    otherwise trains a small campaign in-process (and persists it to
    ``hub_dir`` for next time, if given).  The oracle predicts on ``device``
    (the card unless it is ``"cpu"``), and the campaign's platform, its pool
    workers' too, runs its hooks there.

    ``workers`` > 1 runs the campaign's measurements through the sharded
    runtime (process pool + crash-safe journal; see :mod:`repro_torch.runtime`);
    ``journal_dir`` pins the journal location (defaults to ``hub_dir`` when a
    hub is given).  A run killed mid-campaign resumes from the journal.
    """
    from repro_torch.api import Campaign, CampaignSpec, EstimatorHub, PerfOracle, RuntimeSpec
    from repro_torch.core.network import decompose
    from repro_torch.models.config import InputShape

    oracle = None
    if hub_dir:
        hub = EstimatorHub(hub_dir)
        if all(hub.has(ESTIMATE_PLATFORM, lt) for lt in ESTIMATE_LAYER_TYPES):
            oracle = PerfOracle.load(hub, ESTIMATE_PLATFORM, ESTIMATE_LAYER_TYPES, device=device)
    if oracle is None:
        spec = CampaignSpec(
            platform="tpu_v5e",
            layer_types=ESTIMATE_LAYER_TYPES,
            n_samples=n_samples,
            platform_kwargs={"knowledge": "gray", "noise": 0.001, "device": device},
            hub_dir=hub_dir,
        )
        runtime = None
        if workers > 1 or journal_dir:
            from repro_torch.checkpoint.manager import journal_path

            runtime = RuntimeSpec(
                workers=workers,
                journal_path=journal_path(journal_dir) if journal_dir else None,
            )
        campaign = Campaign(spec)
        oracle = campaign.run(runtime=runtime, device=device)
        if campaign.last_run_stats is not None:
            s = campaign.last_run_stats
            print(f"runtime: {s['measured']:.0f} measured, {s['cached']:.0f} cached, "
                  f"{s['replayed']:.0f} replayed over {s['chunks']:.0f} chunks "
                  f"({s['throughput_cfg_s']:.0f} cfg/s, workers={workers})")
    shape = InputShape(name="serve", seq_len=seq_len, global_batch=batch, kind="decode")
    blocks = decompose(cfg, shape, dp=1, tp=1)
    return oracle.predict_network(blocks)


def _metrics_reporter(server, interval_s: float):
    """Daemon loop: print a one-line metrics digest every ``interval_s``."""
    import threading

    from repro_torch import obs

    stop = threading.Event()

    def loop() -> None:
        while not stop.wait(interval_s):
            snap = server.metrics.snapshot()
            reqs = sum(ep["requests"] for ep in snap["endpoints"].values())
            errs = sum(ep["errors"] for ep in snap["endpoints"].values())
            counters = obs.metrics().snapshot()["counters"]
            print(f"[metrics] {reqs} requests ({errs} errors), "
                  f"{snap['batches']} batches "
                  f"(mean {snap['mean_batch_size']:.1f}), "
                  f"cache {snap['gauges'].get('result_cache')}, "
                  f"counters {counters}", flush=True)

    t = threading.Thread(target=loop, name="metrics-reporter", daemon=True)
    t.start()
    return stop


def fsck_journal(args) -> int:
    """Check (and with ``--repair`` compact) a measurement journal (``--fsck``).

    Prints the :meth:`repro_torch.runtime.MeasurementJournal.fsck` report as
    JSON; the exit code is 0 when the journal is healthy, 1 when issues were
    found (and left in place — rerun with ``--repair`` to compact them away).
    """
    import json

    from repro_torch.checkpoint.manager import journal_path
    from repro_torch.runtime import MeasurementJournal

    where = args.journal_dir or args.hub_dir
    if not where:
        raise SystemExit("--fsck requires --journal-dir or --hub-dir")
    journal = MeasurementJournal(journal_path(where))
    try:
        report = journal.fsck(repair=args.repair)
    finally:
        journal.close()
    print(json.dumps(report, indent=2, sort_keys=True))
    checked = report.get("after", report)
    issues = (
        checked["corrupt_lines"]
        + checked["duplicate_keys"]
        + (1 if checked["torn_tail"] else 0)
    )
    return 1 if issues else 0


def serve_oracle(args) -> None:
    """Run the oracle estimation service until interrupted (``--serve-oracle``).

    The hub's oracles predict on ``--device``: the card unless it is ``cpu``;
    without a card the server refuses to start.
    """
    import contextlib
    import os

    from repro_torch import obs
    from repro_torch.serving import OracleServer, OracleSocketServer, ServeSpec

    if not args.hub_dir:
        raise SystemExit("--serve-oracle requires --hub-dir (a trained EstimatorHub)")
    from repro_torch.device import resolve_device

    resolve_device(args.device)
    spec = ServeSpec(
        hub_dir=args.hub_dir,
        platforms=tuple(args.warm_platforms or ()),
        window_s=args.window_ms / 1e3,
        cache_capacity=args.cache_capacity,
        predict_backend=args.predict_backend,
        device=args.device,
        max_queue=args.max_queue if args.max_queue > 0 else None,
        default_deadline_s=(
            args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
        ),
    )
    server = OracleServer(spec=spec)
    sock = OracleSocketServer(
        server, host=args.host, port=args.port, unix_socket=args.unix_socket
    )
    where = sock.address if args.unix_socket else "%s:%d" % sock.address
    trace_ctx = contextlib.nullcontext()
    if args.trace_dir:
        trace_path = os.path.join(args.trace_dir, f"serve-{os.getpid()}.jsonl")
        trace_ctx = obs.tracing(trace_path)
        print(f"tracing to {trace_path} "
              f"(render: python -m repro_torch.obs.report {trace_path})")
    reporter = None
    if args.metrics_interval and args.metrics_interval > 0:
        reporter = _metrics_reporter(server, args.metrics_interval)
    print(f"oracle server on {where} (hub: {args.hub_dir}, "
          f"platforms: {server.platforms()['hub']}, "
          f"window: {args.window_ms:.1f} ms, device: {args.device})", flush=True)
    try:
        with trace_ctx:
            sock.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if reporter is not None:
            reporter.set()
        # Graceful drain: in-flight requests are answered (bounded by
        # --drain-s) before the listening socket goes away.
        sock.close(drain_s=args.drain_s)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--attention-impl", default="flash_pallas",
                    choices=("flash_pallas", "xla_chunked", "xla_full"),
                    help="attention route (default: the Hopper flash kernel)")
    ap.add_argument("--estimate", action="store_true",
                    help="print a PR-oracle decode step-time estimate first")
    ap.add_argument("--estimate-only", action="store_true",
                    help="estimate and exit without running the model")
    ap.add_argument("--hub-dir", default=None,
                    help="EstimatorHub directory to reload/persist the oracle")
    ap.add_argument("--workers", type=int, default=1,
                    help="measurement worker processes for the estimate campaign "
                         "(>1 enables the sharded runtime)")
    ap.add_argument("--journal-dir", default=None,
                    help="directory for the crash-safe measurement journal "
                         "(interrupted estimate campaigns resume from it)")
    ap.add_argument("--serve-oracle", action="store_true",
                    help="serve oracle estimates over NDJSON sockets instead of "
                         "running a model (see repro_torch.serving)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address for --serve-oracle TCP mode")
    ap.add_argument("--port", type=int, default=7070,
                    help="TCP port for --serve-oracle (0 = ephemeral)")
    ap.add_argument("--unix-socket", default=None,
                    help="serve on a unix socket path instead of TCP")
    ap.add_argument("--warm-platforms", nargs="*", default=None,
                    help="platforms to load eagerly at server startup")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="admission-batching window in milliseconds")
    ap.add_argument("--cache-capacity", type=int, default=65536,
                    help="LRU result-cache capacity (entries)")
    ap.add_argument("--predict-backend", default=None, choices=("torch", "numpy"),
                    help="inference engine for served oracles (default: torch, on --device)")
    ap.add_argument("--trace-dir", default=None,
                    help="write a span trace into this directory (serve-<pid>.jsonl "
                         "with --serve-oracle; serve-<pid>.json, Chrome/Perfetto, and "
                         "serve-<pid>.metrics.json for a model run); render with "
                         "python -m repro_torch.obs.report")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="print a metrics digest every N seconds (0 = off)")
    ap.add_argument("--max-queue", type=int, default=8192,
                    help="admission-queue bound; overflowing requests get an "
                         "explicit overload response (0 = unbounded)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="default per-request deadline in milliseconds; "
                         "requests may override with their own deadline_ms "
                         "(0 = no deadline)")
    ap.add_argument("--drain-s", type=float, default=5.0,
                    help="graceful-shutdown drain budget: seconds to wait for "
                         "in-flight requests before closing the socket")
    ap.add_argument("--fsck", action="store_true",
                    help="check the measurement journal (torn tail, corrupt "
                         "lines, duplicate keys) and exit; nonzero on issues")
    ap.add_argument("--repair", action="store_true",
                    help="with --fsck: compact the journal to drop corruption")
    args = ap.parse_args(argv)

    if args.fsck:
        return fsck_journal(args)
    if args.serve_oracle:
        serve_oracle(args)
        return 0
    if not args.arch:
        ap.error("--arch is required unless --serve-oracle or --fsck is given")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.estimate or args.estimate_only:
        t_step = estimate_decode_step(
            cfg, args.batch, args.prompt_len + args.gen, hub_dir=args.hub_dir,
            workers=args.workers, journal_dir=args.journal_dir, device=args.device,
        )
        print(f"oracle estimate (tpu_v5e[gray], dp=1 tp=1): "
              f"{t_step*1e3:.3f} ms/decode-step "
              f"(~{args.batch / max(t_step, 1e-12):.0f} tok/s)")
        if args.estimate_only:
            return 0
    import torch

    from repro_torch import obs, phases
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(args.batch, args.prompt_len))
    extras = {}
    if cfg.family == "audio":
        extras["frames"] = rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32) * 0.1
    tracer = obs.Tracer(None) if args.trace_dir else None
    with obs.tracing(tracer):
        t0 = time.perf_counter()
        tokens = generate(cfg, params, prompts, args.gen, dev, extras)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} on {dev} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)\n{tokens[:2].cpu().numpy()}")
    if tracer is not None:
        trace, snapshot = phases.write_trace(tracer, args.trace_dir, "serve")
        print(f"trace {trace}, metrics {snapshot} (render: python -m repro_torch.obs.report {trace})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
