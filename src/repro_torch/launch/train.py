"""Training launcher, ported from ``repro.launch.train``.

Runs on the card unless ``--device cpu``.  On the CPU it runs the reduced
configs end to end; on the card the same entry point trains the full
configs that fit one (mamba2-780m, qwen2-1.5b, zamba2-2.7b, with fp32
parameters, gradients and AdamW moments).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --device cpu --steps 50 --batch 8 --seq 128 --ckpt checkpoints/qwen2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --steps 8 --batch 2 --seq 4096 --ckpt checkpoints/mamba2

``--production-mesh`` (``--multi-pod``) shards the run over the (16, 16)
((2, 16, 16)) production mesh of ``launch.mesh``: every process of a
256- (512-) rank world, started by torchrun across the nodes, runs this
entry point; on a world of another size it raises, naming the size it
needs.  Without them the trainer gets ``single_device_rules()``, as the
reference's does: on one device every sharding annotation is the identity.

``--trace-dir DIR`` keeps a span trace of the run in memory (the steps'
phases, ``repro_torch.phases``) and writes it at the end as
``DIR/train-<pid>.json`` (Chrome/Perfetto) with a snapshot of the metrics
registry, ``DIR/train-<pid>.metrics.json``; ``python -m
repro_torch.obs.report`` renders either.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

from repro_torch import obs, phases
from repro_torch.configs import get_config
from repro_torch.distributed import for_mesh, single_device_rules
from repro_torch.models.config import InputShape, reduced
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace-dir", default=None,
                    help="write train-<pid>.json (Chrome/Perfetto) and train-<pid>.metrics.json here")
    args = ap.parse_args(argv)

    if args.production_mesh or args.multi_pod:
        from repro_torch.launch.mesh import make_production_mesh

        rules = for_mesh(make_production_mesh(multi_pod=args.multi_pod,
                                              device_type="cpu" if args.device == "cpu" else "cuda"))
    else:
        rules = single_device_rules()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = InputShape("cli", args.seq, args.batch, "train")
    tcfg = TrainerConfig(
        steps=args.steps,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt,
        n_microbatches=args.microbatches,
    )
    trainer = Trainer(cfg, shape, rules, tcfg, AdamWConfig(lr=args.lr, total_steps=args.steps),
                      device=args.device)
    tracer = obs.Tracer(None) if args.trace_dir else None
    with obs.tracing(tracer):
        metrics = trainer.run()
    print("final:", metrics)
    if tracer is not None:
        trace, snapshot = phases.write_trace(tracer, args.trace_dir, "train")
        print(f"trace {trace}, metrics {snapshot} (render: python -m repro_torch.obs.report {trace})")


if __name__ == "__main__":
    main()
