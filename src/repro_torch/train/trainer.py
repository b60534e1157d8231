"""Fault-tolerant training loop, ported from ``repro.train.trainer``.

The Trainer owns: parameter and optimizer init (or restore from the latest
checkpoint), the train step, periodic atomic checkpoints, and a restart
path that survives injected failures.  Parameters are fp32 masters from a
seeded ``torch.Generator`` on the trainer's device (every use casts them to
bf16, as the reference's do); the checkpoint holds ``{"params", "opt"}``.

One device: ``rules`` must be None.  Sharding rules, and restoring onto
another mesh, wait for ROADMAP.md queue 1, item 5.  The step runs eager;
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
        if rules is not None:
            raise NotImplementedError(
                "sharding rules are not ported yet: the port trains on one device (rules=None); "
                "see ROADMAP.md, queue 1, item 5"
            )
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.steps)
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.data = SyntheticLMData(cfg, shape, seed=tcfg.seed)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep)
        self.history: list[dict] = []

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = T.init_params(self.cfg, gen, self.device, param_dtype=torch.float32)
        return params, adamw_init(params)

    def _batch(self, step: int) -> dict:
        out = {}
        for k, v in self.data.batch(step).items():
            t = torch.from_numpy(v)
            out[k] = (t.long() if t.dtype == torch.int32 else t).to(self.device)
        return out

    def run(self) -> dict:
        """Run (or resume) training; returns final metrics."""
        params, opt_state = self._init_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            skeleton = {"params": params, "opt": opt_state}
            restored, step = self.ckpt.restore(skeleton)
            state = tree_map(lambda a, like: torch.as_tensor(a).to(like.device, like.dtype), restored, skeleton)
            params, opt_state = state["params"], state["opt"]
            start = step
            log.info("resumed from checkpoint at step %d", step)

        step_fn = make_train_step(self.cfg, self.opt_cfg, self.tcfg.n_microbatches)
        metrics = {}
        for step in range(start, self.tcfg.steps):
            if self.failure_hook is not None:
                self.failure_hook(step)
            batch = self._batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
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
