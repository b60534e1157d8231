"""Torch predict path: the forest traversal and Eq. 9-12 on a torch device.

The counterpart of the reference's compiled predict path.  The predict path
(never the fit path) runs the stacked forest traversal and the whole-network
combination as float64 torch programs on the oracle's device, the H100
unless the caller asks for the CPU.

Backend selection
-----------------
``resolve_backend(backend, device)`` decides per call:

* an explicit ``backend=`` (on :meth:`PerfOracle.predict` and friends) wins,
  else the oracle's ``predict_backend``, else ``"torch"``;
* ``"torch"`` runs on ``device`` (the oracle's ``device`` field): ``cuda``
  unless it is ``"cpu"``, and it raises without a card
  (:func:`repro_torch.device.resolve_device`);
* ``"numpy"`` is the numpy fold of :meth:`RandomForestRegressor.predict`;
* a ``torch.device`` is a torch backend already resolved: that is how the
  oracle hands its device through ``LayerEstimator.predict`` to the forest.

Nothing falls back from torch to numpy because a card or a library is
missing.  :func:`predict_network_batch_torch` returns ``None`` only for
requests whose semantics the numpy path owns (stub estimators, empty
forests, blocks with no layers), and the caller continues there.

Parity contract (``tests/test_torch_estimation.py``, ``chip_smoke.py``)
---------------------------------------------------------------------
* **Layer predictions are bitwise equal to numpy**, on the CPU and on the
  card.  The traversal replays the numpy descent gather for gather in
  float64, adds the per-tree values in tree order as a left fold (no
  ``sum``, no ``cumsum``, no atomics: their orders differ), and divides by
  the tree count held in a device tensor (CUDA turns a division by a host
  scalar into a multiplication by its reciprocal, one ulp off).  The
  log-target inversion stays ``np.exp`` on the host, outside.
* **Whole-network predictions** run the traversal and the combination on
  the device, with ``torch.exp`` for log-target estimators.  On the CPU they
  are bitwise equal to numpy when no estimator has a log target
  (``index_add_`` adds in index order there, as ``np.bincount`` does) and
  within rtol 1e-12 otherwise; on the card within rtol 1e-12, because
  ``index_add_`` there adds with atomics in any order.

Eager torch does not retrace, so nothing here buckets rows or counts traces;
``torch.forest.calls`` and ``torch.network.calls`` count the calls.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.metrics import metrics as obs_metrics

BACKENDS = ("torch", "numpy")


def resolve_backend(
    backend: str | torch.device | None = None, device: str | torch.device | None = None
) -> str | torch.device:
    """``"numpy"``, or the ``torch.device`` the torch backend runs on.

    The numpy backend never imports torch.
    """
    if backend is not None and not isinstance(backend, str):
        import torch

        if isinstance(backend, torch.device):
            return backend
    choice = "torch" if backend is None else backend
    if choice not in BACKENDS:
        raise ValueError(f"unknown predict backend {choice!r}; expected one of {BACKENDS}")
    if choice == "numpy":
        return "numpy"
    from repro_torch.device import resolve_device

    return resolve_device(device)


# --------------------------------------------------------------- forest
def _max_depth(feature: np.ndarray, left: np.ndarray, right: np.ndarray) -> int:
    """Descent steps until every (tree, sample) pair of the stack sits on a leaf."""
    T, N = feature.shape
    level = np.zeros((T, N), dtype=bool)
    level[:, 0] = True
    depth = 0
    while True:
        rows, cols = np.nonzero(level & (feature >= 0))
        if rows.size == 0:
            return depth
        depth += 1
        level = np.zeros((T, N), dtype=bool)
        level[rows, left[rows, cols]] = True
        level[rows, right[rows, cols]] = True


class ForestEngine:
    """One stacked forest's node tables on one device, uploaded once.

    Engines are cached on the ``_ForestStack`` object (see :func:`_engine`),
    so the ``RandomForestRegressor._trees`` setter's stack invalidation
    retires them on refit and on a hub load.
    """

    def __init__(self, stack, n_trees: int, device: torch.device) -> None:
        import torch

        self.device = device
        self.feature = torch.as_tensor(stack.feature, dtype=torch.int64, device=device)
        self.threshold = torch.as_tensor(stack.threshold, device=device)
        self.left = torch.as_tensor(stack.left, dtype=torch.int64, device=device)
        self.right = torch.as_tensor(stack.right, dtype=torch.int64, device=device)
        self.value = torch.as_tensor(stack.value, device=device)
        self.n_trees = torch.tensor(float(n_trees), dtype=torch.float64, device=device)
        # The descent's trip count is known on the host once, so the loop
        # below never reads a flag back from the device.
        self.depth = _max_depth(stack.feature, stack.left, stack.right)

    def traverse(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) mean-over-trees raw prediction of float64 ``X`` (n, d) on the device.

        Every (tree, sample) pair advances while its node is not a leaf; a
        pair that reached its leaf stays there for the remaining steps.
        """
        import torch

        T = self.feature.shape[0]
        n = X.shape[0]
        Xt = X.t()  # (d, n): gather each pair's feature by row index
        node = torch.zeros((T, n), dtype=torch.int64, device=self.device)
        for _ in range(self.depth):
            feat = torch.gather(self.feature, 1, node)
            active = feat >= 0
            x = torch.gather(Xt, 0, torch.where(active, feat, 0))
            go_left = x <= torch.gather(self.threshold, 1, node)
            nxt = torch.where(go_left, torch.gather(self.left, 1, node),
                              torch.gather(self.right, 1, node))
            node = torch.where(active, nxt, node)
        per_tree = torch.gather(self.value, 1, node)
        acc = torch.zeros(n, dtype=torch.float64, device=self.device)
        for i in range(T):
            acc = acc + per_tree[i]
        return acc / self.n_trees


def _engine(forest, device: torch.device) -> ForestEngine:
    stack = forest._stacked()
    engines = getattr(stack, "_torch_engines", None)
    if engines is None:
        engines = stack._torch_engines = {}
    engine = engines.get(device)
    if engine is None:
        engine = engines[device] = ForestEngine(stack, len(forest._trees), device)
    return engine


def forest_predict_raw(forest, X: np.ndarray, device: torch.device) -> np.ndarray:
    """``RandomForestRegressor.predict``'s raw mean on ``device``, bitwise equal to numpy."""
    import torch

    obs_metrics().inc("torch.forest.calls")
    Xd = torch.as_tensor(np.asarray(X, dtype=np.float64), device=device)
    return _engine(forest, device).traverse(Xd).cpu().numpy()


# --------------------------------------------------------------- network
def predict_network_batch_torch(
    oracle, batch, net_id: np.ndarray, n_nets: int, device: torch.device
) -> np.ndarray | None:
    """Eq. 9-12 over a :class:`BlockBatch` on ``device``; None = use the numpy path.

    Returns None for stub estimators, empty forests, and blocks with zero
    layers: the numpy path owns those semantics (including the
    empty-overlap-block ``ValueError``).
    """
    import torch

    n_blocks = len(batch)
    counts = batch.layer_counts()
    if n_blocks == 0 or np.any(counts == 0):
        return None
    ests = []
    for lt in batch.group_types:
        try:
            est = oracle.estimators[lt]
        except KeyError:
            return None  # the numpy path raises the canonical KeyError
        forest = getattr(est, "forest", None)
        if not hasattr(est, "_features") or forest is None or not getattr(
            forest, "_trees", None
        ):
            return None
        ests.append(est)

    from repro_torch.core.blocks import block_ops_batch

    obs_metrics().inc("torch.network.calls")

    def dev(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # Eq. 7/8 per group, scattered into layer-table order
    times = torch.zeros(batch.n_layers, dtype=torch.float64, device=device)
    for g, (est, cfgs) in enumerate(zip(ests, batch.group_configs)):
        y = _engine(est.forest, device).traverse(dev(est._features(cfgs, snap=True)))
        if getattr(est, "log_target", False):
            y = torch.exp(y)
        times[dev(np.flatnonzero(batch.group_of == g), torch.int64)] = y

    # Eq. 10 first term / Eq. 9: per-block sums and maxes over the layer table
    seg = dev(batch.block_id, torch.int64)
    sums = torch.zeros(n_blocks, dtype=torch.float64, device=device).index_add_(0, seg, times)
    maxs = torch.full((n_blocks,), -torch.inf, dtype=torch.float64, device=device)
    maxs = maxs.scatter_reduce_(0, seg, times, "amax")
    launch = float(oracle.launch_overhead_s)
    counts_d = dev(counts)
    t = sums - launch * torch.clamp(counts_d - 1.0, min=0.0)
    fused = np.zeros(n_blocks, dtype=bool)
    w = np.zeros(n_blocks, dtype=np.float64)
    c = np.zeros(n_blocks, dtype=np.float64)
    for i, kind in enumerate(batch.kinds):
        fm = oracle.fusing.get(kind)
        if fm is not None and kind not in oracle.overlap_kinds:
            fused[i] = True
            w[i] = fm.w
            c[i] = fm.c
    if fused.any():
        fusing = dev(block_ops_batch(batch)) * dev(w) + dev(c)  # Eq. 10/11
        t = torch.where(dev(fused, torch.bool), t - fusing, t)
    overlap = np.array([k in oracle.overlap_kinds for k in batch.kinds], dtype=bool)
    t = torch.where(dev(overlap, torch.bool), maxs, t)  # Eq. 9
    t = torch.maximum(t, torch.where(counts_d > 0.0, torch.full_like(t, launch), torch.zeros_like(t)))
    # Eq. 12: per-network sum of block time x repeat
    net_id = np.asarray(net_id, dtype=np.int64)
    size = max(int(n_nets), int(net_id.max()) + 1)
    out = torch.zeros(size, dtype=torch.float64, device=device)
    out.index_add_(0, dev(net_id, torch.int64), t * dev(batch.repeat))
    return out.cpu().numpy()
