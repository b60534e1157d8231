"""Vectorized CART growth: the fit engine behind ``RandomForestRegressor``.

After the columnar measurement engine (PR 2) and the sharded measurement
runtime (PR 3), ``RandomForestRegressor.fit`` was the last scalar stage of the
campaign pipeline: the reference builder re-argsorts every candidate feature
at every node and walks the candidates in a Python loop.  This module grows
the identical tree with the presort/partition scheme classic CART
implementations use, fully vectorized:

* **Shared per-feature argsorts, once per tree.**  The bootstrapped training
  matrix is stable-argsorted column-wise a single time; no node ever sorts
  again.  The sorted *values* and sorted *targets* ride along as one packed
  ``(2F, m)`` band matrix, so a node's split search performs no gathers from
  ``X``/``y`` at all.
* **Stable partition of sorted state.**  When a node splits, the band matrix
  and the sorted orders are partitioned into the two children with one
  boolean take per side.  Because every node's index set preserves ascending
  bootstrap-row order, a stable partition of the parent's sorted order *is*
  the stable argsort of the child's values — equal values keep the exact
  tie-break the reference's per-node ``np.argsort(kind="stable")`` produces.
* **Stacked split search.**  The prefix-sum variance-reduction criterion is
  evaluated for *all* candidate features of a node in one ``(k, m)`` pass.
  Gains are computed in natural feature order and the reference's
  first-strictly-better scan over the drawn feature order is reproduced by
  taking the first argmax over the drawn permutation of the per-feature
  maxima (``argmax`` returns the first occurrence; the reference's strict
  ``>`` keeps the earliest of equal bests, which is the same element).
* **Index sets from the winner's sorted order.**  The chosen split's left
  child is the first ``j + 1`` entries of the winning feature's sorted order
  (sorted ascending), so the reference's ``X[idx, f] <= thr`` re-gather and
  boolean partition of ``idx`` disappear.  The one case where the two could
  disagree — a midpoint threshold rounding up onto the right neighbour, where
  the reference's ``<=`` mask extends the left child across every tied value
  (and leafs only when nothing remains on the right) — is reproduced with a
  ``searchsorted`` cut at the threshold.
* **Scalar fast path for tiny nodes.**  Deep trees are mostly nodes with a
  handful of rows, where numpy dispatch overhead dominates; nodes with at
  most 7 rows run an exact scalar replica instead (n < 8 numpy sums and
  cumsums are sequential left folds, elementwise arithmetic is per-element
  IEEE, and python's ``**`` matches ``np.float64.__pow__`` — both call libm
  pow), reading their rows straight from ``X.tolist()`` so their parents
  skip the band partition for them entirely.

Bitwise contract (asserted by tests/test_forest_fit.py and enforced as the
hard gate of benchmarks/bench_forest.py): node tables, prediction bytes and
hub checkpoint payloads are identical to the frozen reference builder
(:func:`repro_torch.core.forest._build_tree`) for every seed.

A note on the RNG stream: the forest draws each tree's bootstrap indices and
then, while growing that tree, one ``rng.choice`` per splittable node — all
from the same ``Generator``.  Hoisting the bootstrap draws into one up-front
``(n_trees, n)`` matrix would reorder those calls and change every subsequent
draw (bounded-integer sampling consumes a data-dependent amount of state), so
the draws stay interleaved at their historical stream positions; the
vectorization lives entirely between the draws.
"""

from __future__ import annotations

import numpy as np

#: node-table arrays in ``_Tree`` field order (feature, threshold, left,
#: right, value) — ``forest.RandomForestRegressor`` wraps them into ``_Tree``.
NodeArrays = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]

_NEG_INF = -np.inf


def grow_tree(
    X: np.ndarray,
    y: np.ndarray,
    rng: np.random.Generator,
    max_depth: int,
    min_samples_leaf: int,
    max_features: int,
) -> NodeArrays:
    """Grow one CART regression tree, bitwise-equal to the reference builder.

    ``X``/``y`` are the (already bootstrapped) training matrix and targets,
    assumed finite.  RNG consumption matches the reference exactly: one
    ``rng.choice`` per node that passes the leaf checks, in DFS stack order.
    """
    n_samples, n_features = X.shape
    F = n_features
    k_draw = min(max_features, n_features)
    full_draw = k_draw == n_features
    msl = min_samples_leaf
    choice = rng.choice
    # One stable argsort per feature for the whole tree (argsort of X.T's rows
    # == per-column argsort, but lands C-contiguous); every node below
    # inherits its sorted orders — and sorted value bands — by partition.
    # int32 orders halve the partition/gather traffic (n < 2**31 always).
    order0 = np.argsort(X.T, axis=1, kind="stable").astype(np.int32)
    vals0 = np.concatenate((np.take_along_axis(X.T, order0, axis=1), y[order0]), axis=0)
    member = np.zeros(n_samples, dtype=bool)  # reusable partition scratch
    nl_full = np.arange(1, n_samples if n_samples else 1)
    # nr == [m-1, ..., 1] for any node size m is the tail of one reversed
    # arange: a contiguous view instead of a per-node negative-stride slice.
    nr_full = np.arange(n_samples, 0, -1)

    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []
    f_app = feature.append
    t_app = threshold.append
    l_app = left.append
    r_app = right.append
    v_app = value.append

    def new_node() -> int:
        f_app(-1)
        t_app(0.0)
        l_app(-1)
        r_app(-1)
        v_app(0.0)
        return len(feature) - 1

    # Tiny nodes (m <= 7) take a scalar fast path: reading their few rows
    # straight from these row lists is cheaper than partitioning the parent's
    # band matrices, and every float op involved (n < 8 sums, cumsums, the
    # sse chain, libm pow for the parent SSE) is replicated exactly — see
    # tests/test_forest_fit.py for the bitwise evidence.
    Xl: list | None = None
    Yl: list | None = None

    # DFS stack mirrors the reference: numpy nodes are
    # (node_id, y_node, order, bands, depth); tiny scalar nodes are
    # (node_id, ids, y_values, depth).  ``y_node``/``y_values`` are the
    # node's targets in ascending-sample order (the reference's ``y[idx]``);
    # children the push-time checks prove to be leaves get their value
    # assigned immediately and are never pushed.
    root = new_node()
    stack = [(root, y, order0, vals0, 0)]
    push = stack.append
    pop = stack.pop
    while stack:
        entry = pop()
        if len(entry) == 4:
            # ---- scalar fast path: 2 <= m <= 7 ----
            # Every float op here is a bitwise replica of the reference's
            # numpy ops for these sizes: n < 8 sums/cumsums are sequential
            # left folds, elementwise arithmetic is per-element IEEE, and
            # scalar ** matches np.float64.** (both call libm pow) — fuzzed
            # and frozen in tests/test_forest_fit.py.  Reachable only via a
            # push, so depth < max_depth and m >= 2*msl already hold; only
            # the constant-target check remains.
            node_id, ids, yv, depth = entry
            m_s = len(ids)
            s = yv[0]
            for v in yv[1:]:
                s = s + v
            value[node_id] = s / m_s
            y0 = yv[0]
            for v in yv[1:]:
                if v != y0:
                    break
            else:
                continue  # constant target -> leaf
            # repro-lint: disable=rng-discipline -- scalar reference path:
            # one choice() draw per non-leaf node in stack-pop order is the
            # frozen v1 bitstream the vectorized path must reproduce exactly
            feats = choice(n_features, k_draw, False)
            tsq = y0 * y0
            for v in yv[1:]:
                tsq = tsq + v * v
            parent_sse = tsq - s**2 / m_s
            rows = [Xl[i] for i in ids]
            best_gain = 0.0
            best_f = -1
            for f in feats.tolist():
                pairs = [(rows[p][f], p) for p in range(m_s)]
                pairs.sort()  # ties fall back to position: the stable order
                gbest = _NEG_INF
                cs = 0.0
                cq = 0.0
                for j in range(m_s - 1):
                    xj, pj = pairs[j]
                    yj = yv[pj]
                    if j:
                        cs = cs + yj
                        cq = cq + yj * yj
                    else:
                        cs = yj
                        cq = yj * yj
                    if xj < pairs[j + 1][0]:
                        nl_s = j + 1
                        nr_s = m_s - nl_s
                        if nl_s >= msl and nr_s >= msl:
                            sse_l = cq - cs * cs / nl_s
                            sum_r = s - cs
                            g = parent_sse - (
                                sse_l + ((tsq - cq) - sum_r * sum_r / nr_s)
                            )
                            if g > gbest:  # first-occurrence max per feature
                                gbest = g
                                thr_f = 0.5 * (xj + pairs[j + 1][0])
                if gbest > best_gain:  # strictly-better scan over drawn order
                    best_gain = gbest
                    best_f = f
                    best_thr = thr_f
            if best_f < 0:
                continue
            # Partition by the reference's ``<= thr`` mask — when the midpoint
            # rounds up onto the right neighbour the mask extends the left
            # child across every tied value, and only an empty right child
            # (thr swallowed the node) makes this a leaf.  An empty left
            # child cannot happen: thr >= x_lo always.
            li = []
            ri = []
            lyv = []
            ryv = []
            for pos in range(m_s):
                if rows[pos][best_f] <= best_thr:
                    li.append(ids[pos])
                    lyv.append(yv[pos])
                else:
                    ri.append(ids[pos])
                    ryv.append(yv[pos])
            if not ri:
                continue
            lid, rid = new_node(), new_node()
            feature[node_id] = best_f
            threshold[node_id] = best_thr
            left[node_id] = lid
            right[node_id] = rid
            d1 = depth + 1
            n_l = len(li)
            if d1 < max_depth and n_l >= 2 * msl:
                push((lid, li, lyv, d1))
            else:
                sl = lyv[0]
                for v in lyv[1:]:
                    sl = sl + v
                value[lid] = sl / n_l
            n_r = len(ri)
            if d1 < max_depth and n_r >= 2 * msl:
                push((rid, ri, ryv, d1))
            else:
                sr = ryv[0]
                for v in ryv[1:]:
                    sr = sr + v
                value[rid] = sr / n_r
            continue
        node_id, y_node, order, bands, depth = entry
        m = y_node.size
        node_sum = y_node.sum()
        value[node_id] = float(node_sum / m)
        # min == max is the reference's np.all(y == y[0]) — same boolean on
        # finite targets, two allocation-free reductions instead of eq + all.
        if depth >= max_depth or m < 2 * msl or y_node.min() == y_node.max():
            continue
        # repro-lint: disable=rng-discipline -- positional draw mirrors the
        # reference's per-node stream consumption; the conditional structure
        # is the tree shape itself, which the v1 stream contract freezes
        feats = choice(n_features, k_draw, False)  # positional: same bitstream
        total_sum = node_sum
        total_sq = float((y_node * y_node).sum())
        parent_sse = total_sq - total_sum**2 / m
        # Full draws evaluate every feature in natural band order (no
        # gather); the drawn order only matters for tie-breaking, below.
        if full_draw:
            xs = bands[:F]
            ys = bands[F:]
            k = F
        else:
            sel = np.concatenate((feats, feats + F))
            bsel = bands[sel]
            xs = bsel[:k_draw]
            ys = bsel[k_draw:]
            k = k_draw
        csum = ys.cumsum(axis=1)
        csq = (ys * ys).cumsum(axis=1)
        nl = nl_full[: m - 1]
        valid = xs[:, :-1] < xs[:, 1:]  # only between distinct x values
        if msl > 1:
            # nl >= msl and m - nl >= msl, as index slices over nl = j + 1
            valid[:, : msl - 1] = False
            valid[:, m - msl :] = False
        sum_l = csum[:, :-1]
        sq_l = csq[:, :-1]
        sse_l = sq_l - sum_l * sum_l / nl
        nr = nr_full[n_samples - m + 1 :]  # the reference's n - nl == [m-1, ..., 1]
        sum_r = total_sum - sum_l
        sq_r = total_sq - sq_l
        sse_r = sq_r - sum_r * sum_r / nr
        gain = np.where(valid, parent_sse - (sse_l + sse_r), _NEG_INF)
        best_per_row = gain.max(axis=1)
        # The reference scans the drawn features sequentially, keeping the
        # first strictly-better gain: that is the first occurrence of the
        # maximum over the drawn order, i.e. argmax over the permuted maxima.
        cand = best_per_row[feats] if full_draw else best_per_row
        b = int(cand.argmax())
        if not cand[b] > 0.0:
            continue
        best_feat = int(feats[b])
        row = best_feat if full_draw else b
        jb = int(gain[row].argmax())  # first best position, as the reference
        xs_row = xs[row]
        x_hi = float(xs_row[jb + 1])
        best_thr = float(0.5 * (xs_row[jb] + x_hi))
        n_l = jb + 1
        if not best_thr < x_hi:
            # Midpoint rounded up onto the right neighbour: the reference's
            # ``<= thr`` mask extends the left child across every value tied
            # with the threshold.  (An empty *left* child cannot happen:
            # thr >= x_lo always.)
            n_l = int(np.searchsorted(xs_row, best_thr, side="right"))
            if n_l >= m:
                # no value above thr remains: the reference's empty-right-
                # child guard keeps the node a leaf
                continue
        os_row = order[best_feat]
        lid, rid = new_node(), new_node()
        feature[node_id] = best_feat
        threshold[node_id] = best_thr
        left[node_id] = lid
        right[node_id] = rid
        # Children that already fail the pop-time leaf checks never search a
        # split: give them their leaf value now and skip partition and push.
        # Tiny children (<= 7 rows) never touch the band matrices at all —
        # they are pushed as scalar nodes or folded to leaf values from the
        # row lists, so the parent partitions only for "big" children.
        n_r = m - n_l
        d1 = depth + 1
        need_l = d1 < max_depth and n_l >= 2 * msl
        need_r = d1 < max_depth and n_r >= 2 * msl
        small_l = n_l <= 7
        small_r = n_r <= 7
        big_l = need_l and not small_l
        big_r = need_r and not small_r
        if (small_l or small_r) and Yl is None:
            Xl = X.tolist()
            Yl = y.tolist()
        if big_l or big_r:
            li_np = os_row[:n_l].copy()  # == idx[mask] once sorted
            li_np.sort()
            member[li_np] = True
            take = member[order]
            member[li_np] = False
            bands2 = bands.reshape(2, F, m)
        # The reference pushes left then right (pop order: right subtree
        # first); preserve it — rng draws follow pop order.  Leaf sums fold
        # in ascending-sample order, exactly like the reference's y[idx].
        if big_l:
            push((
                lid, y[li_np],
                order[take].reshape(F, n_l),
                bands2[:, take].reshape(2 * F, n_l),
                d1,
            ))
        elif small_l:
            ids = os_row[:n_l].tolist()
            ids.sort()
            if need_l:
                push((lid, ids, [Yl[i] for i in ids], d1))
            else:
                sl = Yl[ids[0]]
                for i in ids[1:]:
                    sl = sl + Yl[i]
                value[lid] = sl / n_l
        else:
            li2 = os_row[:n_l].copy()
            li2.sort()
            value[lid] = float(y[li2].sum() / n_l)
        if big_r:
            drop = ~take
            ri_np = os_row[n_l:].copy()
            ri_np.sort()
            push((
                rid, y[ri_np],
                order[drop].reshape(F, n_r),
                bands2[:, drop].reshape(2 * F, n_r),
                d1,
            ))
        elif small_r:
            ids = os_row[n_l:].tolist()
            ids.sort()
            if need_r:
                push((rid, ids, [Yl[i] for i in ids], d1))
            else:
                sr = Yl[ids[0]]
                for i in ids[1:]:
                    sr = sr + Yl[i]
                value[rid] = sr / n_r
        else:
            ri2 = os_row[n_l:].copy()
            ri2.sort()
            value[rid] = float(y[ri2].sum() / n_r)

    return (
        np.asarray(feature, dtype=np.int32),
        np.asarray(threshold, dtype=np.float64),
        np.asarray(left, dtype=np.int32),
        np.asarray(right, dtype=np.int32),
        np.asarray(value, dtype=np.float64),
    )
