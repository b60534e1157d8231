"""Fault-tolerant training loop, ported from ``repro.train.trainer``.

The Trainer owns: parameter and optimizer init (or restore from the latest
checkpoint), the train step, periodic atomic checkpoints, and a restart
path that survives injected failures.  Parameters are fp32 masters from a
seeded ``torch.Generator`` on the trainer's device (every use casts them to
bf16, as the reference's do); the checkpoint holds ``{"params", "opt"}``.

``rules`` (``repro_torch.distributed.ShardingRules``, or None for one
device) shard the run: on a multi-device mesh every rank builds the same
seeded parameters, keeps its shards by ``param_specs`` (with ``fsdp`` where
the rules say so), makes AdamW's moments as shards beside them
(``opt_specs``' placement; never whole) and keeps its part of each batch by
``batch_specs``; the step runs under ``use_rules``, checkpoints
hold the gathered arrays, and a restore re-shards them onto the current
mesh, whatever mesh saved them.  On one device (None, or
``single_device_rules()``) nothing is distributed.  The step runs eager;
the reference jits it.

``failure_hook`` lets tests inject a crash at an exact step to exercise the
checkpoint/restart path deterministically.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import distributed as D
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_map
from repro_torch.train.steps import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 2
    n_microbatches: int = 1
    seed: int = 0
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: InputShape,
        rules: Any,
        tcfg: TrainerConfig,
        opt_cfg: AdamWConfig | None = None,
        failure_hook: Callable[[int], None] | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        self.cfg = cfg
        self.rules = rules
        self.shape = shape
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.steps)
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.data = SyntheticLMData(cfg, shape, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        self.history: list[dict] = []

    def _specs(self, params) -> tuple[Any, Any]:
        from repro_torch.launch import shardings as SH

        p_specs = SH.param_specs(self.cfg, self.rules, params)
        return p_specs, SH.opt_specs(p_specs)

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)

        def make_params():
            return T.init_params(self.cfg, gen, self.device, param_dtype=torch.float32)

        if not D.is_distributed(self.rules):
            params = make_params()
            return params, adamw_init(params)
        from repro_torch.launch import shardings as SH

        return SH.distribute_train_state(self.cfg, self.rules, make_params)

    def _batch(self, step: int) -> dict:
        out = {}
        for k, v in self.data.batch(step).items():
            t = torch.from_numpy(v)
            out[k] = (t.long() if t.dtype == torch.int32 else t).to(self.device)
        if D.is_distributed(self.rules):
            from repro_torch.launch import shardings as SH

            out = SH.distribute_tree(self.rules, out, SH.batch_specs(self.cfg, self.rules, out))
        return out

    def _restore(self, params, opt_state):
        skeleton = {"params": params, "opt": opt_state}
        shardings = None
        if D.is_distributed(self.rules):
            from repro_torch.launch import shardings as SH

            p_specs, o_specs = self._specs(params)
            shardings = SH.to_shardings(self.rules, {"params": p_specs, "opt": o_specs}, skeleton)
        restored, step = self.ckpt.restore(skeleton, shardings=shardings)
        state = tree_map(lambda a, like: torch.as_tensor(a).to(like.device, like.dtype), restored, skeleton)
        return state["params"], state["opt"], step

    def run(self) -> dict:
        """Run (or resume) training; returns final metrics."""
        with D.use_rules(self.rules):
            return self._run()

    def _run(self) -> dict:
        params, opt_state = self._init_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            params, opt_state, start = self._restore(params, opt_state)
            log.info("resumed from checkpoint at step %d", start)

        step_fn = make_train_step(self.cfg, self.opt_cfg, self.tcfg.n_microbatches)
        metrics = {}
        for step in range(start, self.tcfg.steps):
            if self.failure_hook is not None:
                self.failure_hook(step)
            batch = self._batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(D.full_tensor(v)) for k, v in metrics.items()}
            metrics["step_time_s"] = time.perf_counter() - t0
            metrics["step"] = step
            self.history.append(metrics)
            if step % self.tcfg.log_every == 0:
                log.info("step %d: %s", step, metrics)
            if (step + 1) % self.tcfg.checkpoint_every == 0 or step + 1 == self.tcfg.steps:
                self.ckpt.save(step + 1, {"params": params, "opt": opt_state})
        self.params = params
        self.opt_state = opt_state
        return metrics
