"""Serving launcher of the port: batched prefill + greedy decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
      --batch 4 --prompt-len 512 --gen 32

Ported from the model-run path of ``repro.launch.serve``, for the dense, moe
and ssm families.  It runs on ``cuda`` unless ``--device cpu`` is given, and
raises without a card.  One departure: ``--attention-impl`` (default
``flash_pallas``) overrides the config's attention route, so by default the
cached prefill of a dense or moe model runs the hand-written Hopper
flash-attention kernel.  A mamba2 prefill runs the hand-written SSD-scan
kernel on the card whatever the flag says.  The estimation paths
(``--estimate``, ``--estimate-only``, ``--serve-oracle``, ``--fsck``) are not
ported yet and exit non-zero.
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
from repro_torch.train.steps import make_serve_step


@torch.no_grad()
def generate(cfg, params, prompts, gen_len: int, device: torch.device | str | None = None):
    """Greedy generation: prefill via forward-with-cache, then decode steps.

    prompts: (B, S) integer array or tensor.  Returns (B, gen_len) int64
    tokens on ``device`` (default ``cuda``), where ``params`` must live.
    """
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, generate asked for {dev}")
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=dev)
    b, s = tokens.shape
    cache = init_cache(cfg, b, s + gen_len, dev)
    serve_step = make_serve_step(cfg)

    logits, _, cache = T.forward(params, cfg, {"tokens": tokens}, cache)
    out = [torch.argmax(logits[:, -1, :], dim=-1)]
    for _ in range(gen_len - 1):
        next_tok, cache = serve_step(params, cache, {"tokens": out[-1][:, None]})
        out.append(next_tok)
    return torch.stack(out, dim=1)


_NOT_PORTED = ("estimate", "estimate_only", "serve_oracle", "fsck")


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
