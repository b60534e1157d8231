"""Serving launcher of the port: batched prefill + greedy decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --estimate-only --device cpu --hub-dir /tmp/hub

Ported from ``repro.launch.serve``: the model-run path for the dense, moe
and ssm families, and the oracle estimate of a decode step.  It runs on
``cuda`` unless ``--device cpu`` is given, and raises without a card.  On
the card the decode step runs as a captured CUDA graph (``generate``).  One
departure: ``--attention-impl`` (default ``flash_pallas``) overrides the
config's attention route, so by default the cached prefill of a dense or moe
model runs the hand-written Hopper flash-attention kernel.  A mamba2 prefill
runs the hand-written SSD-scan kernel on the card whatever the flag says.

``--estimate`` first prints a PR-oracle prediction of one decode step on
the simulated TPU-v5e platform (``tpu_v5e[gray]``, an analytic model, not
this machine), and ``--estimate-only`` stops there; ``--hub-dir`` reloads a
persisted oracle instead of training one, and the oracle predicts on
``--device``.  ``--workers`` > 1 and ``--journal-dir`` need the measurement
runtime, which is not ported yet and raises.  ``--serve-oracle`` and
``--fsck`` are not ported yet and exit non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced
from repro_torch.models.kvcache import init_cache
from repro_torch.train.steps import capture_serve_step, make_serve_step


@torch.no_grad()
def generate(cfg, params, prompts, gen_len: int, device: torch.device | str | None = None):
    """Greedy generation: prefill via forward-with-cache, then decode steps.

    prompts: (B, S) integer array or tensor.  Returns (B, gen_len) int64
    tokens on ``device`` (default ``cuda``), where ``params`` must live.

    The prefill runs eager, once.  On the card the decode step runs as the
    reference's runs under ``jax.jit``, compiled: one eager step warms up and
    captures a CUDA graph (``capture_serve_step``), which is replayed for
    the other ``gen_len - 2`` steps; a failed capture or replay raises.  On
    the CPU every step runs eager.
    """
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, generate asked for {dev}")
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    b, s = tokens.shape
    # A decode step writes at the cache's device-side length with no bounds
    # check; this cache holds the prompt and every step's write (the last at
    # position s + gen_len - 2), which settles the room on the host, once.
    cache = init_cache(cfg, b, s + gen_len, dev)

    logits, _, cache = T.forward(params, cfg, {"tokens": tokens}, cache)
    out = [torch.argmax(logits[:, -1, :], dim=-1)]
    if dev.type == "cuda" and gen_len > 1:
        step = capture_serve_step(cfg, params, cache, {"tokens": out[-1][:, None]})
        out.append(step.tokens[:, 0].clone())
        for _ in range(gen_len - 2):
            out.append(step.replay()[:, 0].clone())
        return torch.stack(out, dim=1)
    serve_step = make_serve_step(cfg)
    for _ in range(gen_len - 1):
        next_tok, cache = serve_step(params, cache, {"tokens": out[-1][:, None]})
        out.append(next_tok)
    return torch.stack(out, dim=1)


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
    (the card unless it is ``"cpu"``).  ``workers`` > 1 and ``journal_dir``
    would run the campaign through the measurement runtime, which is not
    ported yet: they raise.
    """
    from repro_torch.api import Campaign, CampaignSpec, EstimatorHub, PerfOracle
    from repro_torch.core.network import decompose
    from repro_torch.models.config import InputShape

    if workers > 1 or journal_dir:
        raise NotImplementedError(
            "the measurement runtime (repro.runtime) is not ported yet; see "
            "ROADMAP.md, queue 1, item 2 (the rest of the estimation pipeline)"
        )
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
        oracle = Campaign(spec).run(device=device)
    shape = InputShape(name="serve", seq_len=seq_len, global_batch=batch, kind="decode")
    blocks = decompose(cfg, shape, dp=1, tp=1)
    return oracle.predict_network(blocks)


_NOT_PORTED = ("serve_oracle", "fsck")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
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
                    help="measurement worker processes (> 1 needs the runtime: not ported)")
    ap.add_argument("--journal-dir", default=None,
                    help="measurement journal directory (needs the runtime: not ported)")
    for flag in _NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="not yet ported")
    args = ap.parse_args(argv)

    for flag in _NOT_PORTED:
        if getattr(args, flag):
            print(f"--{flag.replace('_', '-')} is not yet ported", file=sys.stderr)
            return 2
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.estimate or args.estimate_only:
        try:
            t_step = estimate_decode_step(
                cfg, args.batch, args.prompt_len + args.gen, hub_dir=args.hub_dir,
                workers=args.workers, journal_dir=args.journal_dir, device=args.device,
            )
        except NotImplementedError as e:
            print(e, file=sys.stderr)
            return 2
        print(f"oracle estimate (tpu_v5e[gray], dp=1 tp=1): "
              f"{t_step*1e3:.3f} ms/decode-step "
              f"(~{args.batch / max(t_step, 1e-12):.0f} tok/s)")
        if args.estimate_only:
            return 0
    cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, size=(args.batch, args.prompt_len))
    t0 = time.perf_counter()
    tokens = generate(cfg, params, prompts, args.gen, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} on {dev} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)\n{tokens[:2].cpu().numpy()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
