"""Algorithm 1 from the paper: determine PR step widths from parameter sweeps.

The paper's Algorithm 1 has three parts:
  * ``TestLinearBehavior`` -- fit a straight line between the sweep endpoints and
    declare the parameter "linear" when the RMSE of that line is below a
    threshold.  Linear parameters get step width ``w_p = 1``.
  * ``ExecutionTimeDelta`` -- consecutive differences of the sweep curve.
  * ``FindPeaks`` / ``PeakDistance`` -- peaks of the delta sequence mark step
    boundaries; the (median) spacing between peaks is the step width ``w_p``.

Note: the paper's pseudo-code line ``y_hat <- slope_avg * x + x_min`` is an
obvious typo (it would use an *x* value as the intercept); the intended line
passes through ``(x_min, y_min)``.  We implement the corrected form.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
from scipy.signal import find_peaks


def test_linear_behavior(
    x: np.ndarray,
    y: np.ndarray,
    threshold_linear: float = 0.02,
    *,
    relative: bool = True,
) -> bool:
    """Return True when the sweep curve is explained by a straight line.

    ``relative=True`` (default) interprets ``threshold_linear`` as a fraction of
    the observed dynamic range ``max(y) - min(y)`` which makes one threshold work
    across platforms whose absolute times differ by orders of magnitude.  With
    ``relative=False`` the paper's absolute-RMSE semantics are used verbatim.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 3:
        return True
    y_min, y_max = float(np.min(y)), float(np.max(y))
    x_min, x_max = float(np.min(x)), float(np.max(x))
    if x_max == x_min:
        return True
    span = y_max - y_min
    if span == 0.0:
        return True  # constant is trivially linear
    slope_avg = span / (x_max - x_min)
    y_hat = slope_avg * (x - x_min) + y_min  # corrected intercept (see module doc)
    rmse = float(np.sqrt(np.mean((y - y_hat) ** 2)))
    if relative:
        return rmse < threshold_linear * span
    return rmse < threshold_linear


def execution_time_delta(y: np.ndarray) -> np.ndarray:
    """Consecutive differences ``y[i+1] - y[i]`` (paper's ExecutionTimeDelta)."""
    y = np.asarray(y, dtype=np.float64)
    return np.diff(y)


def _peak_distance(x: np.ndarray, indices: np.ndarray) -> float:
    """Median spacing between peak locations, measured in *x* units."""
    if indices.size < 2:
        return 0.0
    # delta[i] corresponds to the jump between x[i] and x[i+1]; the step
    # boundary sits at x[i+1].
    boundary_x = x[indices + 1]
    return float(np.median(np.diff(boundary_x)))


def _linear_fit_rmse(x: np.ndarray, y: np.ndarray) -> float:
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return float(np.sqrt(np.mean((y - A @ coef) ** 2)))


def _staircase_fit_rmse_multi(
    x: np.ndarray, y: np.ndarray, widths: Sequence[int]
) -> np.ndarray:
    """Staircase-fit RMSE for several candidate widths in one vectorized pass.

    For each width the sweep is partitioned into steps (``ceil(x / w)``) and
    approximated by the per-step mean.  Instead of a Python loop over steps
    (and over candidate widths), step boundaries come from ``diff != 0`` runs,
    every candidate's group ids are offset into one disjoint id space, and a
    single ``bincount`` produces all per-step means at once.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if not np.all(np.diff(x) >= 0):  # run-detection needs ascending x
        order = np.argsort(x, kind="stable")
        x, y = x[order], y[order]
    w = np.maximum(1, np.asarray(widths, dtype=np.int64))
    g = np.ceil(x[None, :] / w[:, None]).astype(np.int64)  # (W, n), rows nondecreasing
    starts = np.diff(g, axis=1) != 0
    ids = np.concatenate(
        [np.zeros((len(w), 1), dtype=np.int64), np.cumsum(starts, axis=1)], axis=1
    )
    offsets = np.concatenate([[0], np.cumsum(ids[:, -1] + 1)[:-1]])
    flat = (ids + offsets[:, None]).ravel()
    sums = np.bincount(flat, weights=np.tile(y, len(w)))
    counts = np.bincount(flat)
    y_hat = (sums / counts)[flat].reshape(len(w), x.size)
    return np.sqrt(np.mean((y[None, :] - y_hat) ** 2, axis=1))


def _staircase_fit_rmse(x: np.ndarray, y: np.ndarray, width: int) -> float:
    return float(_staircase_fit_rmse_multi(x, y, [width])[0])


def _linear_rows(
    X: np.ndarray,
    Y: np.ndarray,
    threshold_linear: float = 0.02,
    *,
    relative: bool = True,
) -> np.ndarray:
    """Row-wise :func:`test_linear_behavior` over a stack of same-length sweeps.

    Same operations applied along ``axis=1`` (row reductions run over
    contiguous memory, so numpy's pairwise summation matches the scalar
    call), hence the same verdict per row.
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    out = np.ones(X.shape[0], dtype=bool)
    if X.shape[1] < 3:
        return out
    y_min, y_max = np.min(Y, axis=1), np.max(Y, axis=1)
    x_min, x_max = np.min(X, axis=1), np.max(X, axis=1)
    span = y_max - y_min
    trivial = (x_max == x_min) | (span == 0.0)
    dx = np.where(trivial, 1.0, x_max - x_min)
    slope_avg = span / dx
    y_hat = slope_avg[:, None] * (X - x_min[:, None]) + y_min[:, None]
    rmse = np.sqrt(np.mean((Y - y_hat) ** 2, axis=1))
    thr = threshold_linear * span if relative else np.full_like(span, threshold_linear)
    return trivial | (rmse < thr)


def _detect_width(x: np.ndarray, y: np.ndarray, min_rel_height: float) -> int:
    deltas = execution_time_delta(y)
    if deltas.size == 0:
        return 1
    max_jump = float(np.max(deltas))
    if max_jump <= 0:
        return 1
    indices, _ = find_peaks(deltas, height=min_rel_height * max_jump)
    if indices.size == 0:
        # A single dominant jump at the boundary is not a scipy "peak".
        indices = np.nonzero(deltas >= min_rel_height * max_jump)[0]
    width = _peak_distance(x, indices)
    if width <= 0:
        if indices.size == 1:
            # Only one boundary visible inside the window.
            width = float(x[indices[0] + 1] - x[0])
        else:
            return 1
    return max(1, int(round(width)))


def find_step_width(
    x: np.ndarray,
    y: np.ndarray,
    threshold_linear: float = 0.02,
    *,
    min_rel_height: float = 0.5,
) -> int:
    """Determine the step width of one parameter from its sweep (Algorithm 1).

    Returns 1 for linear behavior, otherwise the median peak spacing of the
    delta curve rounded to the nearest positive integer.

    Extensions over the paper's pseudo-code (both validated by tests):
      * multi-scale: a staircase with many small steps inside a long window is
        near-linear to the endpoint-chord test, so on a "linear" verdict the
        test recurses into prefix windows (halving, floor 24 points);
      * validation: a candidate width is accepted only if a staircase fit with
        that width explains the window markedly better than a straight line --
        this guards the multi-scale pass against declaring steps on noise.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)

    window = x.size
    while window >= 12:
        xs, ys = x[:window], y[:window]
        if not test_linear_behavior(xs, ys, threshold_linear):
            return _decide_at_window(xs, ys, window == x.size, min_rel_height)
        window //= 2
    return 1


def _decide_at_window(
    xs: np.ndarray, ys: np.ndarray, full_window: bool, min_rel_height: float
) -> int:
    """Width decision once a window has screened non-linear (Algorithm 1 tail).

    Shared by the scalar :func:`find_step_width` walk and the batched
    :func:`determine_step_widths` screen, so the two paths cannot diverge.
    """
    width = _detect_width(xs, ys, min_rel_height)
    if width <= 1:
        return 1  # non-linear but not step-wise
    # noise shifts individual peak positions by +-1; pick the
    # neighbouring width whose staircase fit explains the sweep best
    # (all candidates scored in one vectorized pass; argmin keeps the
    # first minimum like min(key=...) did, so ties break identically)
    cands = sorted({w for w in (width - 1, width, width + 1) if w >= 2})
    rmses = _staircase_fit_rmse_multi(xs, ys, cands)
    best = int(np.argmin(rmses))
    width = cands[best]
    if full_window:
        return width  # full-window detection needs no extra validation
    # multi-scale detection: accept only if the staircase fit clearly
    # beats a straight line (guards against declaring steps on noise)
    if rmses[best] < 0.7 * _linear_fit_rmse(xs, ys):
        return width
    return 1


def detect_pr_points(x: np.ndarray, y: np.ndarray, width: int) -> np.ndarray:
    """Return the sweep x-values that are PRs (last point of each step).

    Used for Fig.-2-style visualisation and by tests.
    """
    x = np.asarray(x)
    if width <= 1:
        return x.copy()
    return x[(x % width) == 0]


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """One parameter sweep: the swept values and the measured times."""

    param: str
    x: np.ndarray
    y: np.ndarray


def determine_step_widths(
    sweeps: Mapping[str, tuple[np.ndarray, np.ndarray]] | Sequence[SweepResult],
    threshold_linear: float = 0.02,
) -> dict[str, int]:
    """Algorithm 1 over all swept parameters -> ``{param: step width}``.

    The outer per-parameter loop is batched: parameters whose sweeps share a
    length stack into one matrix and every multi-scale halving level screens
    all of them with a single row-wise linearity test (:func:`_linear_rows`);
    only the rows that screen non-linear pay the per-parameter width decision.
    Same widths as the scalar :func:`find_step_width` loop (asserted in
    tests), since both share :func:`_decide_at_window`.
    """
    if not isinstance(sweeps, Mapping):
        sweeps = {s.param: (s.x, s.y) for s in sweeps}
    items = [
        (param, np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64))
        for param, (x, y) in sweeps.items()
    ]
    widths: dict[str, int] = {}
    by_size: dict[int, list[tuple[str, np.ndarray, np.ndarray]]] = {}
    for param, x, y in items:
        by_size.setdefault(x.size, []).append((param, x, y))
    for size, group in by_size.items():
        if len(group) == 1 or size < 12:
            for param, x, y in group:
                widths[param] = find_step_width(x, y, threshold_linear)
            continue
        X = np.stack([x for _, x, _ in group])
        Y = np.stack([y for _, _, y in group])
        active = np.arange(len(group))
        window = size
        while window >= 12 and active.size:
            lin = _linear_rows(X[active, :window], Y[active, :window], threshold_linear)
            for idx in active[~lin]:
                param, x, y = group[int(idx)]
                widths[param] = _decide_at_window(
                    x[:window], y[:window], window == size, min_rel_height=0.5
                )
            active = active[lin]
            window //= 2
        for idx in active:
            widths[group[int(idx)][0]] = 1
    return {param: widths[param] for param, _, _ in items}
