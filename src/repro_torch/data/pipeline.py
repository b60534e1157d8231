"""Deterministic synthetic LM data pipeline (host-sharded, restart-safe).

Generates Zipf-distributed token streams with a deterministic per-(step, host)
seed, so (a) every data-parallel host draws disjoint data, (b) a restart at
step N regenerates exactly the stream it would have seen (checkpoint/restart
does not replay or skip data), and (c) elastic re-sharding onto a different
dp size keeps the global batch identical (seeded by global example index).

Also provides straggler mitigation at the input layer: ``prefetch`` keeps a
bounded buffer of upcoming batches so a slow host-side generation step does
not stall the accelerator (bounded skip-ahead).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np

from repro_torch.models.config import InputShape, ModelConfig


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ModelConfig
    shape: InputShape
    seed: int = 0
    zipf_a: float = 1.2

    def _tokens(self, step: int, n: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step, 0xDA7A))
        z = rng.zipf(self.zipf_a, size=(n, seq)).astype(np.int64)
        return (z % (self.cfg.vocab - 2) + 1).astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Global batch for ``step`` (callers shard it onto the mesh)."""
        b, s = self.shape.global_batch, self.shape.seq_len
        cfg = self.cfg
        n_vis = cfg.vision_tokens if cfg.family == "vlm" else 0
        toks = self._tokens(step, b, s - n_vis + 1)
        out: dict[str, np.ndarray] = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:] if n_vis == 0 else toks[:, 1:],
        }
        if cfg.family == "vlm":
            rng = np.random.default_rng((self.seed, step, 0x1513))
            out["vision_embeds"] = rng.standard_normal((b, n_vis, cfg.d_model)).astype(np.float32) * 0.02
            pos = np.broadcast_to(np.arange(s)[None, None], (3, b, s)).copy()
            out["positions"] = pos.astype(np.int32)
        if cfg.family == "audio":
            rng = np.random.default_rng((self.seed, step, 0xA0D10))
            out["frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1
        return out

    def prefetch(self, start_step: int, depth: int = 2):
        """Bounded-buffer iterator (straggler mitigation at the input layer)."""
        buf: deque = deque()
        lock = threading.Lock()
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                if len(buf) < depth:
                    item = (step, self.batch(step))
                    with lock:
                        buf.append(item)
                    step += 1
                else:
                    stop.wait(0.001)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                if buf:
                    with lock:
                        yield buf.popleft()
                else:
                    stop.wait(0.001)
        finally:
            stop.set()


def make_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str, tuple[tuple[int, ...], str]]:
    """(shape, dtype) specs of a global batch -- the dry-run's input_specs."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        specs = {"tokens": ((b, 1), "int32")}
        return specs
    n_vis = cfg.vision_tokens if cfg.family == "vlm" else 0
    specs = {
        "tokens": ((b, s - n_vis), "int32"),
        "labels": ((b, s - n_vis), "int32"),
    }
    if cfg.family == "vlm":
        specs["vision_embeds"] = ((b, n_vis, cfg.d_model), "float32")
        specs["positions"] = ((3, b, s), "int32")
    if cfg.family == "audio":
        specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model), "float32")
    return specs
