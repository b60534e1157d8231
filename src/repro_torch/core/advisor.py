"""PR-guided configuration advisor (the paper's NAS use-case, systems-level).

The paper positions its estimator inside an optimization loop (hardware-aware
NAS) where measuring every candidate is too expensive.  The framework analogue:
choosing a distribution configuration -- (dp, tp) mesh factors, microbatch
count -- normally requires compiling every candidate (minutes each on the
dry-run).  The advisor instead *estimates* every candidate's step time from
the PR-trained layer models in milliseconds and returns a ranking; only the
winner needs a compile.

``autotune`` returns candidates sorted by estimated step time.  It accepts
anything with a ``predict_network(blocks) -> float`` method — canonically a
:class:`repro_torch.api.PerfOracle` (e.g. from ``Campaign.run()`` or reloaded via
``PerfOracle.load``); the deprecated ``NetworkEstimator`` shim still works.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

from repro_torch.core.blocks import Block
from repro_torch.core.network import decompose, decompose_batch
from repro_torch.models.config import InputShape, ModelConfig


class NetworkPredictor(Protocol):
    """Structural type served by PerfOracle and NetworkEstimator alike."""

    def predict_network(self, blocks: Sequence[Block]) -> float: ...


@dataclasses.dataclass(frozen=True)
class Candidate:
    dp: int
    tp: int
    microbatches: int = 1

    def __str__(self) -> str:
        return f"dp={self.dp} tp={self.tp} micro={self.microbatches}"


def default_candidates(chips: int = 256) -> list[Candidate]:
    out = []
    tp = 1
    while tp <= chips:
        if chips % tp == 0:
            for micro in (1, 2, 4):
                out.append(Candidate(dp=chips // tp, tp=tp, microbatches=micro))
        tp *= 2
    return out


def _microbatch_infeasible(shape: InputShape, cand: Candidate) -> bool:
    return bool(
        shape.global_batch % (cand.dp * cand.microbatches)
        and shape.global_batch >= cand.dp
    )


def candidate_blocks(
    cfg: ModelConfig, shape: InputShape, cand: Candidate
) -> list[Block]:
    """Per-device building blocks of one candidate's microbatch step."""
    micro_shape = dataclasses.replace(
        shape, global_batch=max(1, shape.global_batch // cand.microbatches)
    )
    return decompose(cfg, micro_shape, cand.dp, cand.tp)


def candidate_block_batch(cfg: ModelConfig, shape: InputShape, cand: Candidate):
    """Columnar :func:`candidate_blocks`: one :class:`BlockBatch` per candidate,
    built without materialising ``Block`` objects."""
    micro_shape = dataclasses.replace(
        shape, global_batch=max(1, shape.global_batch // cand.microbatches)
    )
    return decompose_batch(cfg, micro_shape, cand.dp, cand.tp)


def estimate_candidate(
    estimator: NetworkPredictor,
    cfg: ModelConfig,
    shape: InputShape,
    cand: Candidate,
) -> float:
    """Estimated step time under a candidate distribution config."""
    if _microbatch_infeasible(shape, cand):
        return float("inf")
    blocks = candidate_blocks(cfg, shape, cand)
    return estimator.predict_network(blocks) * cand.microbatches


def autotune(
    estimator: NetworkPredictor,
    cfg: ModelConfig,
    shape: InputShape,
    candidates: Sequence[Candidate] | None = None,
    chips: int = 256,
) -> list[tuple[Candidate, float]]:
    """Rank candidate meshes by estimated step time, in one oracle call.

    Every feasible candidate's block decomposition joins one
    ``predict_networks`` batch (one forest pass per layer type across *all*
    candidates); predictors exposing only ``predict_network`` (third-party
    estimators) fall back to the per-candidate loop with identical scores.
    """
    candidates = list(candidates) if candidates is not None else default_candidates(chips)
    feasible = []
    for c in candidates:
        # feasibility: dp cannot exceed global batch; tp must divide d_ff-ish dims
        if c.dp > max(1, shape.global_batch):
            continue
        if cfg.d_ff and cfg.d_ff % c.tp not in (0,) and cfg.moe_experts == 0:
            continue
        feasible.append(c)
    scores = [float("inf")] * len(feasible)
    chosen = [
        (k, c)
        for k, c in enumerate(feasible)
        if not _microbatch_infeasible(shape, c)
    ]
    if chosen:
        predict_batch = getattr(estimator, "predict_network_batch", None)
        predict_many = getattr(estimator, "predict_networks", None)
        if predict_batch is not None:
            # Columnar-native: decompose each candidate straight into a
            # BlockBatch (no Block objects), merge, and score in one call.
            import numpy as np

            from repro_torch.core.batch import BlockBatch

            batches = [candidate_block_batch(cfg, shape, c) for _, c in chosen]
            merged = BlockBatch.concat(batches)
            net_id = np.repeat(
                np.arange(len(batches)), [len(b) for b in batches]
            )
            preds = predict_batch(merged, net_id=net_id, n_nets=len(batches))
        elif predict_many is not None:
            preds = predict_many([candidate_blocks(cfg, shape, c) for _, c in chosen])
        else:
            preds = [
                estimator.predict_network(candidate_blocks(cfg, shape, c))
                for _, c in chosen
            ]
        for (k, c), p in zip(chosen, preds):
            scores[k] = float(p) * c.microbatches
    return sorted(zip(feasible, scores), key=lambda x: x[1])
