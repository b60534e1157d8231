"""Derived (platform-independent) features for the statistical models.

ANNETTE [11] -- the estimator family this paper builds on -- feeds its Random
Forests derived layer descriptors (op counts, output sizes) alongside the raw
layer parameters; raw parameters alone make trees interpolate products poorly.
These formulas use only layer *semantics* (no hardware knowledge), so they are
legitimate for black-box platforms too.  Features are computed on the
PR-snapped configuration for PR-trained models (the snap is what encodes the
hardware quantisation) and on the raw configuration for random-sampling
baselines.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.batch import Config, ConfigBatch


def _conv_out(size: int, f: int, s: int, pad: int) -> int:
    return max(1, (size + 2 * pad - f) // s + 1)


def derived_features(layer_type: str, cfg: Config) -> dict[str, float]:
    if layer_type == "conv1d":
        w_out = _conv_out(cfg["C_w"], cfg["F"], cfg.get("s", 1), cfg.get("pad", 0))
        macs = cfg["C"] * cfg["K"] * w_out * cfg["F"]
        return {"w_out": w_out, "macs": macs, "weights": cfg["C"] * cfg["K"] * cfg["F"]}
    if layer_type == "conv2d":
        h_out = _conv_out(cfg["C_h"], cfg["F"], cfg.get("s", 1), cfg.get("pad", 1))
        w_out = _conv_out(cfg["C_w"], cfg["F"], cfg.get("s", 1), cfg.get("pad", 1))
        macs = cfg["C"] * cfg["K"] * h_out * w_out * cfg["F"] ** 2
        return {"hw_out": h_out * w_out, "macs": macs, "weights": cfg["C"] * cfg["K"] * cfg["F"] ** 2}
    if layer_type == "fully_connected":
        return {"macs": cfg["in"] * cfg["out"], "weights": cfg["in"] * cfg["out"]}
    if layer_type == "dense":
        macs = cfg["tokens"] * cfg["d_in"] * cfg["d_out"]
        byt = cfg["tokens"] * (cfg["d_in"] + cfg["d_out"]) + cfg["d_in"] * cfg["d_out"]
        return {"macs": macs, "bytes": byt, "weights": cfg["d_in"] * cfg["d_out"]}
    if layer_type == "attention_prefill":
        kvh = max(1, cfg["H"] // cfg.get("kv_ratio", 4))
        macs = cfg["B"] * cfg["H"] * cfg["S"] ** 2 * cfg["Dh"]
        byt = cfg["B"] * cfg["S"] * cfg["Dh"] * (2 * cfg["H"] + 2 * kvh)
        return {"macs": macs, "bytes": byt}
    if layer_type == "attention_decode":
        kvh = max(1, cfg["H"] // cfg.get("kv_ratio", 4))
        macs = cfg["B"] * cfg["H"] * cfg["S_kv"] * cfg["Dh"]
        byt = cfg["B"] * kvh * cfg["S_kv"] * cfg["Dh"] * 2
        return {"macs": macs, "bytes": byt}
    if layer_type == "moe_gemm":
        per_expert = cfg["tokens"] * cfg["topk"] / max(1, cfg["E"])
        macs = 3 * cfg["tokens"] * cfg["topk"] * cfg["d_model"] * cfg["d_ff"]
        weights = 3 * cfg["E"] * cfg["d_model"] * cfg["d_ff"]
        return {"macs": macs, "weights": weights, "per_expert": per_expert}
    if layer_type == "ssd_scan":
        macs = cfg["B"] * cfg["S"] * cfg["H"] * cfg["P"] * (2 * cfg["N"] + 128)
        byt = cfg["B"] * cfg["S"] * (2 * cfg["H"] * cfg["P"] + 2 * cfg["N"])
        return {"macs": macs, "bytes": byt}
    if layer_type == "embed":
        return {"bytes": cfg["tokens"] * cfg["d_model"], "macs": cfg["tokens"] * cfg["d_model"]}
    return {}


def derived_features_batch(layer_type: str, batch: ConfigBatch) -> np.ndarray:
    """Columnar :func:`derived_features`: an ``(n, n_derived)`` float64 matrix.

    Column order matches the dict version's insertion order, and every
    formula mirrors the scalar arithmetic operation for operation so the
    matrix is bitwise-identical to stacking per-row dict results.
    """
    col = batch.column
    get = batch.get
    if layer_type == "conv1d":
        s, pad = get("s", 1), get("pad", 0)
        w_out = np.maximum(1, (col("C_w") + 2 * pad - col("F")) // s + 1)
        macs = col("C") * col("K") * w_out * col("F")
        weights = col("C") * col("K") * col("F")
        cols = [w_out, macs, weights]
    elif layer_type == "conv2d":
        s, pad = get("s", 1), get("pad", 1)
        h_out = np.maximum(1, (col("C_h") + 2 * pad - col("F")) // s + 1)
        w_out = np.maximum(1, (col("C_w") + 2 * pad - col("F")) // s + 1)
        macs = col("C") * col("K") * h_out * w_out * col("F") ** 2
        cols = [h_out * w_out, macs, col("C") * col("K") * col("F") ** 2]
    elif layer_type == "fully_connected":
        mw = col("in") * col("out")
        cols = [mw, mw]
    elif layer_type == "dense":
        macs = col("tokens") * col("d_in") * col("d_out")
        byt = col("tokens") * (col("d_in") + col("d_out")) + col("d_in") * col("d_out")
        cols = [macs, byt, col("d_in") * col("d_out")]
    elif layer_type == "attention_prefill":
        kvh = np.maximum(1, col("H") // get("kv_ratio", 4))
        macs = col("B") * col("H") * col("S") ** 2 * col("Dh")
        byt = col("B") * col("S") * col("Dh") * (2 * col("H") + 2 * kvh)
        cols = [macs, byt]
    elif layer_type == "attention_decode":
        kvh = np.maximum(1, col("H") // get("kv_ratio", 4))
        macs = col("B") * col("H") * col("S_kv") * col("Dh")
        byt = col("B") * kvh * col("S_kv") * col("Dh") * 2
        cols = [macs, byt]
    elif layer_type == "moe_gemm":
        per_expert = col("tokens") * col("topk") / np.maximum(1, col("E"))
        macs = 3 * col("tokens") * col("topk") * col("d_model") * col("d_ff")
        weights = 3 * col("E") * col("d_model") * col("d_ff")
        cols = [macs, weights, per_expert]
    elif layer_type == "ssd_scan":
        macs = col("B") * col("S") * col("H") * col("P") * (2 * col("N") + 128)
        byt = col("B") * col("S") * (2 * col("H") * col("P") + 2 * col("N"))
        cols = [macs, byt]
    elif layer_type == "embed":
        td = col("tokens") * col("d_model")
        cols = [td, td]
    else:
        return np.empty((len(batch), 0), dtype=np.float64)
    return np.stack([np.asarray(c, dtype=np.float64) for c in cols], axis=1)


def feature_names(layer_type: str, params: tuple[str, ...]) -> tuple[str, ...]:
    probe = {p: 2 for p in params}
    probe.setdefault("F", 1)
    return params + tuple(derived_features(layer_type, probe).keys())
