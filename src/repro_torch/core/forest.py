"""Random-Forest regression from scratch (numpy).

sklearn is not available in this environment, and the estimator is part of the
paper's substrate, so we implement CART regression trees + bagging ourselves.
Split search is the exact greedy variance-reduction criterion, vectorised with
prefix sums over per-feature sorted orders.  Predictions of a forest are the
mean over trees (each tree predicts the mean target of the reached leaf).

Forest prediction is a single vectorized traversal: all trees' node tables
are stacked into padded ``(n_trees, max_nodes)`` arrays so one descent loop
advances every (tree, sample) pair at once instead of looping tree by tree.
The per-tree accumulation order is preserved, so predictions stay bitwise
equal to the historical per-tree loop.

Forest *fitting* is likewise vectorized (:mod:`repro_torch.core.forest_fit`): each
tree argsorts the bootstrapped matrix once, children inherit sorted orders by
stable partition, and the split criterion is evaluated for all candidate
features of a node in one stacked pass.  :func:`_build_tree` below is the
frozen scalar reference builder the engine must match bitwise — it is kept
(unused by ``fit``) as the parity baseline for tests/test_forest_fit.py and
benchmarks/bench_forest.py.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import forest_fit
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.obs.trace import span


@dataclasses.dataclass
class _Tree:
    feature: np.ndarray  # (nodes,) int32, -1 for leaves
    threshold: np.ndarray  # (nodes,) float64
    left: np.ndarray  # (nodes,) int32
    right: np.ndarray  # (nodes,) int32
    value: np.ndarray  # (nodes,) float64

    def predict(self, X: np.ndarray) -> np.ndarray:
        n = X.shape[0]
        node = np.zeros(n, dtype=np.int32)
        # Iterate until every sample reached a leaf; tree depth bounds the loop.
        while True:
            feat = self.feature[node]
            active = feat >= 0
            if not np.any(active):
                break
            f = feat[active]
            go_left = X[active, f] <= self.threshold[node[active]]
            nxt = np.where(go_left, self.left[node[active]], self.right[node[active]])
            node[active] = nxt
        return self.value[node]


@dataclasses.dataclass
class _ForestStack:
    """All trees' node tables padded into ``(n_trees, max_nodes)`` arrays.

    Padding slots carry ``feature == -1`` (leaf) and are never reached: every
    traversal starts at node 0, which is real in every tree.
    """

    feature: np.ndarray  # (T, N) int32, -1 for leaves/padding
    threshold: np.ndarray  # (T, N) float64
    left: np.ndarray  # (T, N) int32
    right: np.ndarray  # (T, N) int32
    value: np.ndarray  # (T, N) float64

    @classmethod
    def from_trees(cls, trees: list[_Tree]) -> "_ForestStack":
        n_nodes = max(len(t.feature) for t in trees)
        T = len(trees)
        feature = np.full((T, n_nodes), -1, dtype=np.int32)
        threshold = np.zeros((T, n_nodes), dtype=np.float64)
        left = np.zeros((T, n_nodes), dtype=np.int32)
        right = np.zeros((T, n_nodes), dtype=np.int32)
        value = np.zeros((T, n_nodes), dtype=np.float64)
        for i, t in enumerate(trees):
            m = len(t.feature)
            feature[i, :m] = t.feature
            threshold[i, :m] = t.threshold
            left[i, :m] = t.left
            right[i, :m] = t.right
            value[i, :m] = t.value
        return cls(feature, threshold, left, right, value)

    def predict_all(self, X: np.ndarray) -> np.ndarray:
        """(T, n) leaf values: one descent loop for every (tree, sample) pair."""
        T = self.feature.shape[0]
        n = X.shape[0]
        node = np.zeros((T, n), dtype=np.int32)
        rows = np.arange(T)[:, None]
        cols = np.arange(n)[None, :]
        while True:
            feat = self.feature[rows, node]
            active = feat >= 0
            if not np.any(active):
                break
            x = X[cols, np.where(active, feat, 0)]
            go_left = x <= self.threshold[rows, node]
            nxt = np.where(go_left, self.left[rows, node], self.right[rows, node])
            node = np.where(active, nxt, node)
        return self.value[rows, node]


def _build_tree(
    X: np.ndarray,
    y: np.ndarray,
    rng: np.random.Generator,
    max_depth: int,
    min_samples_leaf: int,
    max_features: int,
) -> _Tree:
    """Frozen scalar reference builder (pre-vectorization).

    ``fit`` grows trees through :func:`repro_torch.core.forest_fit.grow_tree`; this
    implementation is the bitwise-parity baseline it is tested and benched
    against.  Do not "optimize" it — its per-node argsorts and sequential
    feature scan define the contract.
    """
    n_samples, n_features = X.shape
    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        return len(feature) - 1

    # Explicit stack instead of recursion: (node_id, sample_indices, depth).
    root = new_node()
    stack: list[tuple[int, np.ndarray, int]] = [(root, np.arange(n_samples), 0)]
    while stack:
        node_id, idx, depth = stack.pop()
        y_node = y[idx]
        value[node_id] = float(y_node.mean())
        if depth >= max_depth or idx.size < 2 * min_samples_leaf or np.all(y_node == y_node[0]):
            continue
        # repro-lint: disable=rng-discipline -- the per-node draw order IS the
        # v1 estimator stream contract: nodes pop in stack order and each
        # consumes one choice() draw; reordering re-keys every golden forest
        # (RNG contract v2 in ROADMAP is the sanctioned way to change this)
        feats = rng.choice(n_features, size=min(max_features, n_features), replace=False)
        best_gain = 0.0
        best_feat = -1
        best_thr = 0.0
        total_sum = y_node.sum()
        total_sq = float((y_node**2).sum())
        n = idx.size
        parent_sse = total_sq - total_sum**2 / n
        for f in feats:
            xs = X[idx, f]
            order = np.argsort(xs, kind="stable")
            xs_s = xs[order]
            ys_s = y_node[order]
            # candidate split after position i (1-based prefix)
            csum = np.cumsum(ys_s)
            csq = np.cumsum(ys_s**2)
            nl = np.arange(1, n)
            valid = xs_s[:-1] < xs_s[1:]  # only between distinct x values
            valid &= (nl >= min_samples_leaf) & ((n - nl) >= min_samples_leaf)
            if not np.any(valid):
                continue
            sum_l = csum[:-1]
            sq_l = csq[:-1]
            sse_l = sq_l - sum_l**2 / nl
            nr = n - nl
            sum_r = total_sum - sum_l
            sq_r = total_sq - sq_l
            sse_r = sq_r - sum_r**2 / nr
            gain = parent_sse - (sse_l + sse_r)
            gain = np.where(valid, gain, -np.inf)
            j = int(np.argmax(gain))
            if gain[j] > best_gain:
                best_gain = float(gain[j])
                best_feat = int(f)
                best_thr = float(0.5 * (xs_s[j] + xs_s[j + 1]))
        if best_feat < 0:
            continue
        mask = X[idx, best_feat] <= best_thr
        li, ri = idx[mask], idx[~mask]
        if li.size == 0 or ri.size == 0:
            continue
        lid, rid = new_node(), new_node()
        feature[node_id] = best_feat
        threshold[node_id] = best_thr
        left[node_id] = lid
        right[node_id] = rid
        stack.append((lid, li, depth + 1))
        stack.append((rid, ri, depth + 1))

    return _Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float64),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float64),
    )


class RandomForestRegressor:
    """Bagged CART regression forest (mean aggregation)."""

    def __init__(
        self,
        n_estimators: int = 32,
        max_depth: int = 18,
        min_samples_leaf: int = 1,
        max_features: float | str = 1.0,
        bootstrap: bool = True,
        seed: int = 0,
    ) -> None:
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.seed = seed
        self._trees = []

    # The tree list is a property so that direct assignment (fit, and the
    # EstimatorHub, which rebuilds ``forest._trees`` on load) invalidates the
    # cached stacked node tables.
    @property
    def _trees(self) -> list[_Tree]:
        return self.__trees

    @_trees.setter
    def _trees(self, trees: list[_Tree]) -> None:
        self.__trees = list(trees)
        self.__stack: _ForestStack | None = None

    def _stacked(self) -> _ForestStack:
        if self.__stack is None:
            self.__stack = _ForestStack.from_trees(self.__trees)
        return self.__stack

    def _n_features_per_split(self, n_features: int) -> int:
        """Candidate features drawn per split, sklearn-compatible semantics.

        The *type* of ``max_features`` selects the rule, exactly as in
        sklearn's ``RandomForestRegressor``:

        * ``"sqrt"`` — ``max(1, int(sqrt(n_features)))``;
        * a ``float`` is a **fraction** of the feature count —
          ``max_features=1.0`` means *all* features (the regression-forest
          default), ``0.5`` means half, rounded to nearest;
        * an ``int`` is an absolute **count** — ``max_features=1`` draws a
          single candidate feature per split (maximally randomized trees),
          which is very different from ``1.0``.

        Pinned by tests/test_forest.py::test_max_features_semantics — beware
        that ``bool`` is an ``int`` subclass and Python's ``1 == 1.0``: the
        branch order here (string, then float, then int) is what keeps the
        two ``1`` spellings distinct.
        """
        mf = self.max_features
        if mf == "sqrt":
            return max(1, int(np.sqrt(n_features)))
        if isinstance(mf, float):
            return max(1, int(round(mf * n_features)))
        return max(1, int(mf))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim != 2 or y.ndim != 1 or X.shape[0] != y.shape[0]:
            raise ValueError(f"bad shapes X={X.shape} y={y.shape}")
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        mf = self._n_features_per_split(X.shape[1])
        tree_hist = obs_metrics().histogram("fit.tree_seconds")
        self._trees = []
        sp = span("fit.forest", cat="fit")
        if sp:
            sp.set(n=n, n_estimators=self.n_estimators)
        with sp:
            for i in range(self.n_estimators):
                t0 = time.perf_counter()
                tree_sp = span("fit.tree", cat="fit")
                if tree_sp:
                    tree_sp.set(tree=i)
                with tree_sp:
                    if self.bootstrap:
                        # repro-lint: disable=rng-discipline -- `bootstrap` is
                        # a fit-time hyperparameter, constant for the whole
                        # fit: the draw count per tree is fixed per estimator
                        # config, exactly what the v1 stream contract freezes
                        idx = rng.integers(0, n, size=n)
                    else:
                        idx = np.arange(n)
                    # Vectorized growth (shared argsorts + stacked split search);
                    # bitwise-identical to the frozen ``_build_tree`` reference.  The
                    # bootstrap draw stays inside the loop: it shares the generator
                    # with the per-node feature draws, so hoisting it would shift
                    # every subsequent draw (see forest_fit's module docstring).
                    tree = _Tree(
                        *forest_fit.grow_tree(
                            X[idx], y[idx], rng, self.max_depth, self.min_samples_leaf, mf
                        )
                    )
                    self._trees.append(tree)
                tree_hist.observe(time.perf_counter() - t0)
        return self

    def predict(self, X: np.ndarray, backend=None) -> np.ndarray:
        """Mean over trees.  ``backend``: ``"numpy"``, ``"torch"`` (the
        default, on ``cuda``) or a ``torch.device`` (see
        :func:`repro_torch.core.torch_predict.resolve_backend`)."""
        X = np.asarray(X, dtype=np.float64)
        if not self._trees:
            raise RuntimeError("fit() before predict()")
        if X.shape[0]:
            from repro_torch.core import torch_predict

            # The traversal on a torch device unless numpy is asked for;
            # bitwise-identical to the fold below.
            device = torch_predict.resolve_backend(backend)
            if device != "numpy":
                return torch_predict.forest_predict_raw(self, X, device)
        per_tree = self._stacked().predict_all(X)
        # Accumulate tree by tree (not np.sum's pairwise order) so the mean is
        # bitwise equal to the historical ``acc += tree.predict(X)`` loop.
        acc = np.zeros(X.shape[0], dtype=np.float64)
        for row in per_tree:
            acc += row
        return acc / len(self._trees)


#: percentage errors divide by ``y_true``; ground truth this close to zero
#: (measured times are >= microseconds) means broken inputs, not fast layers
_DENOM_EPS = 1e-12


def _check_denominator(y_true: np.ndarray, metric: str) -> None:
    bad = int(np.count_nonzero(~(np.abs(y_true) > _DENOM_EPS)))
    if bad:
        raise ValueError(
            f"{metric}: y_true contains {bad} zero/near-zero value(s) "
            f"(|y| <= {_DENOM_EPS:g}) out of {y_true.size}; percentage error "
            "is undefined — check that the platform actually measured these "
            "configurations"
        )


def mape(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Mean absolute percentage error (paper's headline metric), in percent.

    Raises ``ValueError`` when ``y_true`` carries zero/near-zero entries: the
    headline metric must never be silently nan/inf (a platform returning 0.0
    ground truth is a measurement bug, not a fast configuration).
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    _check_denominator(y_true, "mape")
    return float(np.mean(np.abs((y_pred - y_true) / y_true)) * 100.0)


def rmspe(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Root-mean-square percentage error, in percent.

    Same zero/near-zero ``y_true`` guard as :func:`mape`.
    """
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    _check_denominator(y_true, "rmspe")
    return float(np.sqrt(np.mean(((y_pred - y_true) / y_true) ** 2)) * 100.0)
