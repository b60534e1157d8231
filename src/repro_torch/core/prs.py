"""Performance-Representative (PR) sets, sampling, and PR mapping (Eq. 2-8).

A layer's parameter space is a mapping ``param -> (lo, hi)`` (inclusive integer
ranges).  Given per-parameter step widths ``W`` (from Algorithm 1 or white-box
knowledge) the PR set is the grid ``{x_p * w_p : x_p in N}`` clipped to the
range (Eq. 2/4).  Estimation-time queries are mapped onto their PR with
``x_p = ceil(p / w_p)`` (Eq. 7/8).

Sampling and PR mapping are columnar: the batch entry points
(:func:`sample_pr_batch`, :func:`sample_random_batch`, :func:`map_to_pr_batch`)
draw and snap whole :class:`~repro_torch.core.batch.ConfigBatch` matrices with array
ops; the dict-based functions are exact-parity wrappers around them.  Batched
sampling consumes the ``numpy.random.Generator`` bitstream identically to the
historical per-config/per-param scalar loop (one bounded draw per matrix cell
in row-major order), so fixed seeds keep producing the same training sets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping

import numpy as np

from repro_torch.core.batch import Config, ConfigBatch


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Integer hyper-box of layer parameters, e.g. ``{"C": (1, 512)}``."""

    ranges: Mapping[str, tuple[int, int]]
    fixed: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @property
    def params(self) -> tuple[str, ...]:
        return tuple(self.ranges.keys())

    def size(self) -> int:
        n = 1
        for lo, hi in self.ranges.values():
            n *= hi - lo + 1
        return n

    def with_fixed(self, cfg: Config) -> Config:
        out = dict(self.fixed)
        out.update(cfg)
        return out


def pr_values(lo: int, hi: int, width: int) -> np.ndarray:
    """All PR values of one parameter within [lo, hi]."""
    if width <= 1:
        return np.arange(lo, hi + 1)
    first = max(width, int(math.ceil(lo / width)) * width)
    if first > hi:
        # Range too small to contain a full step; the only representative is hi.
        return np.array([hi])
    return np.arange(first, hi + 1, width)


def count_pr_configs(space: ParamSpace, widths: Mapping[str, int]) -> int:
    """|PR set| (the paper quotes e.g. 1 493 520 for UltraTrail Conv1D)."""
    n = 1
    for p, (lo, hi) in space.ranges.items():
        n *= len(pr_values(lo, hi, widths.get(p, 1)))
    return n


def map_to_pr_batch(
    batch: ConfigBatch, widths: Mapping[str, int], space: ParamSpace | None = None
) -> ConfigBatch:
    """Eq. 7/8 over a whole batch: snap every quantized column with array ops.

    With a ``space`` given, every quantized (``w > 1``) parameter lands on
    the PR grid of its range, i.e. every snapped value is in
    ``pr_values(lo, hi, W[p])`` — even for out-of-range query values, and in
    the degenerate cases where the range holds no multiple of the width
    (``hi < w``, or ``lo`` past the last in-range multiple), whose only
    representative is ``hi``.  Width-1 (linear) parameters pass through
    unsnapped.
    """
    vals = batch.values.copy()
    for j, p in enumerate(batch.params):
        w = widths.get(p, 1)
        if w <= 1:
            continue
        # ceil(v / w) * w via integer ceildiv (== the float formula for all
        # v < 2**53, i.e. everywhere in the integer config domain).
        snapped = -(-vals[:, j] // w) * w
        if space is not None and p in space.ranges:
            lo, hi = space.ranges[p]
            top = int(math.floor(hi / w)) * w  # largest multiple of w <= hi
            first = max(w, int(math.ceil(lo / w)) * w)  # smallest in-range PR
            if top < first:
                # No multiple of w inside [lo, hi]: hi is the sole PR.
                snapped[:] = hi
            else:
                # Clamp into [first, top] so even out-of-range query
                # values land on the grid (first == w for in-range ones).
                snapped = np.clip(snapped, first, top)
        vals[:, j] = snapped
    return ConfigBatch(params=batch.params, values=vals)


def map_to_pr(cfg: Config, widths: Mapping[str, int], space: ParamSpace | None = None) -> Config:
    """Eq. 7/8 for one dict config — a one-row wrapper of :func:`map_to_pr_batch`.

    Non-integer values (outside the ``Config`` contract but accepted by the
    historical scalar formula) keep their old behavior via the scalar branch.
    """
    try:
        batch = ConfigBatch.from_dicts([cfg])
    except ValueError:
        out = dict(cfg)
        for p, w in widths.items():
            if p in out and w > 1:
                snapped = int(math.ceil(out[p] / w)) * w
                if space is not None and p in space.ranges:
                    lo, hi = space.ranges[p]
                    top = int(math.floor(hi / w)) * w
                    first = max(w, int(math.ceil(lo / w)) * w)
                    snapped = hi if top < first else min(max(snapped, first), top)
                out[p] = snapped
        return out
    return map_to_pr_batch(batch, widths, space).row(0)


def sample_pr_batch(
    space: ParamSpace,
    widths: Mapping[str, int],
    n: int,
    rng: np.random.Generator,
) -> ConfigBatch:
    """Uniformly sample an ``n``-row batch from the PR set.

    One broadcast ``rng.integers`` call draws the whole index matrix; numpy
    consumes one bounded draw per cell in row-major order, exactly like the
    historical per-config ``rng.choice`` loop, so seeds stay reproducible
    across the scalar/batched paths.
    """
    per_param = [pr_values(lo, hi, widths.get(p, 1)) for p, (lo, hi) in space.ranges.items()]
    highs = np.array([len(v) for v in per_param], dtype=np.int64)
    idx = rng.integers(0, highs[None, :], size=(n, len(per_param)))
    values = np.empty((n, len(per_param)), dtype=np.int64)
    for j, vals in enumerate(per_param):
        values[:, j] = vals[idx[:, j]]
    batch = ConfigBatch(params=space.params, values=values)
    return batch.with_fixed(space.fixed)


def sample_pr_configs(
    space: ParamSpace,
    widths: Mapping[str, int],
    n: int,
    rng: np.random.Generator,
) -> list[Config]:
    """Uniformly sample ``n`` configurations from the PR set (dict wrapper)."""
    return sample_pr_batch(space, widths, n, rng).to_dicts()


def sample_random_batch(space: ParamSpace, n: int, rng: np.random.Generator) -> ConfigBatch:
    """Uniformly sample an ``n``-row batch from the *complete* space."""
    los = np.array([lo for lo, _ in space.ranges.values()], dtype=np.int64)
    his = np.array([hi for _, hi in space.ranges.values()], dtype=np.int64)
    vals = rng.integers(los[None, :], his[None, :] + 1, size=(n, len(los)))
    batch = ConfigBatch(params=space.params, values=vals)
    return batch.with_fixed(space.fixed)


def sample_random_configs(space: ParamSpace, n: int, rng: np.random.Generator) -> list[Config]:
    """Uniformly sample ``n`` configurations from the *complete* space."""
    return sample_random_batch(space, n, rng).to_dicts()


def configs_to_matrix(configs: Iterable[Config], params: tuple[str, ...]) -> np.ndarray:
    """Feature matrix in a fixed parameter order."""
    return np.array([[cfg[p] for p in params] for cfg in configs], dtype=np.float64)
