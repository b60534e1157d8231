"""Initial parameter-sweep benchmarks (the first phase in Fig. 1).

For each relevant parameter we sweep a stride-1 window (anchored at the
platform's default configuration) while holding every other parameter at its
default.  Stride-1 matters: a coarser stride can alias away small step widths
(e.g. the TPU sublane width of 8).  The window length just needs to cover a
handful of steps for the peak-distance estimate to be robust.

Sweeping is the most measurement-hungry phase of the pipeline; run it through
:mod:`repro_torch.api` (``Campaign.discover_widths``) to get memoization — a shared
``MeasurementCache`` deduplicates sweep points against training/evaluation
points and remembers discovered widths per (platform, layer type), so size
scans and repeated campaigns never re-sweep.  The functions below stay as the
low-level building blocks and operate on whatever ``Platform`` they are given
(cached or not).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.core import steps
from repro_torch.core.batch import ConfigBatch
from repro_torch.core.prs import Config
from repro_torch.obs.trace import span


def sweep_window(lo: int, hi: int, anchor: int, n_points: int = 384) -> np.ndarray:
    """Stride-1 integer window of ``n_points`` inside [lo, hi] near ``anchor``."""
    start = max(lo, min(anchor, hi - n_points + 1))
    stop = min(hi, start + n_points - 1)
    return np.arange(start, stop + 1)


def run_sweeps(
    platform: Platform,
    layer_type: str,
    params: Sequence[str] | None = None,
    n_points: int = 384,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Sweep each parameter of ``layer_type`` -> ``{param: (x, y)}``."""
    space = platform.param_space(layer_type)
    defaults = platform.defaults(layer_type)
    params = tuple(params) if params is not None else space.params
    anchor = space.with_fixed(defaults)
    # Build every window first, then measure all windows sharing a key set in
    # ONE platform call (per-row measurement models are order-independent and
    # the simulators' noise is seeded per configuration, so splicing windows
    # together cannot change a value; caching platforms dedup across windows).
    windows: list[tuple[str, np.ndarray, ConfigBatch]] = []
    for p in params:
        lo, hi = space.ranges[p]
        xs = sweep_window(lo, hi, defaults.get(p, lo), n_points)
        # One columnar batch per window: anchor rows with the swept column
        # replaced, instead of n_points dict copies.  Platforms may omit a
        # swept param from defaults(); seed the column so replace() can fill it.
        base_cfg = dict(anchor)
        base_cfg.setdefault(p, int(xs[0]))
        windows.append((p, xs, ConfigBatch.from_anchor(base_cfg, len(xs)).replace(p, xs)))
    by_keys: dict[tuple[str, ...], list[int]] = {}
    for i, (_, _, batch) in enumerate(windows):
        by_keys.setdefault(batch.params, []).append(i)
    ys_of: dict[int, np.ndarray] = {}
    for idxs in by_keys.values():
        merged = ConfigBatch.concat([windows[i][2] for i in idxs])
        ys = platform.measure_batch(layer_type, merged)
        off = 0
        for i in idxs:
            n = len(windows[i][2])
            ys_of[i] = np.asarray(ys[off : off + n], dtype=np.float64)
            off += n
    return {p: (xs, ys_of[i]) for i, (p, xs, _) in enumerate(windows)}


def discover_step_widths(
    platform: Platform,
    layer_type: str,
    threshold_linear: float = 0.02,
    n_points: int = 384,
) -> tuple[dict[str, int], dict[str, tuple[np.ndarray, np.ndarray]], int]:
    """Determine step widths per the knowledge tier (Fig. 3).

    * white box: documented widths, no sweeps needed;
    * gray box: documented widths for the documented dims, sweeps confirm
      them and discover the rest;
    * black box: everything from sweeps (Algorithm 1).

    Returns (widths, sweeps_run, n_measurements_spent).
    """
    known = platform.known_step_widths(layer_type) or {}
    space = platform.param_space(layer_type)
    if platform.knowledge == "white":
        widths = {p: known.get(p, 1) for p in space.params}
        return widths, {}, 0

    sp = span("phase.sweeps", cat="campaign")
    if sp:
        sp.set(layer_type=layer_type, n_points=n_points)
    with sp:
        sweeps = run_sweeps(platform, layer_type, n_points=n_points)
    n_meas = sum(len(x) for x, _ in sweeps.values())
    discovered = steps.determine_step_widths(sweeps, threshold_linear)
    widths = dict(discovered)
    for p, w in known.items():
        # Gray box: the documented quantisation wins over a noisy sweep
        # estimate (the sweep's role is confirmation, Fig. 3).
        if p in widths and w > 1:
            widths[p] = w
    return widths, sweeps, n_meas
