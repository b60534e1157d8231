"""TPU v5e analytical timing platform (the paper's methodology, TPU-native).

This is the hardware adaptation described in DESIGN.md §2: instead of an edge
ASIC's PE array, the tile quantisation comes from the TPU v5e memory/compute
hierarchy:

  * MXU: 128x128 systolic array -> matmul contraction/output dims pad to 128;
  * VREG sublanes: 8 -> the token/row dimension pads to 8;
  * KV caches are paged in 128-token pages -> decode S_kv pads to 128;
  * Mamba2 SSD runs in 128-token chunks;
  * MoE expert GEMMs pad tokens-per-expert to 8 -> the *token* step width of an
    (E, top-k) MoE layer is E*8/topk, a step width that is only discoverable by
    sweeps (gray/black-box) unless the mapping is documented (white-box).

Layer time = max(FLOP time, HBM time) + fixed launch overhead -- the v5e's
double-buffered DMA overlaps weight/activation streaming with MXU compute, so
a single kernel sits at its roofline point.  Multi-layer blocks executed as one
fused region share one launch overhead and overlap *across* layers too
(max of the summed terms); with sharding, an in-flight async collective term
joins the max (Eq. 9's two-overlapping-FU rule, TPU-style).

The same timing model is exposed under three knowledge tiers (Fig. 3): the
model is identical, only ``known_step_widths`` differs -- white box knows every
width, gray box knows only the documented MXU 128 quantisation, black box
knows nothing and must discover widths with Algorithm 1.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

from repro_torch.accelerators.base import Platform
from repro_torch.registry import register_platform
from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.core.prs import Config, ParamSpace


@dataclasses.dataclass(frozen=True)
class V5EChip:
    """Public TPU v5e hardware constants (per chip)."""

    peak_bf16_flops: float = 197e12  # FLOP/s
    hbm_bandwidth: float = 819e9  # bytes/s
    ici_bandwidth: float = 50e9  # bytes/s per link (one direction)
    ici_links: int = 4  # 2D torus: 4 links per chip (x+/x-/y+/y-)
    hbm_bytes: float = 16e9
    vmem_bytes: float = 128e6
    mxu: int = 128
    sublane: int = 8
    kv_page: int = 128
    ssd_chunk: int = 128
    launch_overhead_s: float = 3e-6


V5E = V5EChip()


def _pad(v: int, m: int) -> int:
    return int(math.ceil(v / m)) * m


def _pad_arr(v: np.ndarray, m: int) -> np.ndarray:
    # Integer ceildiv == the scalar float-ceil formula for all v < 2**53.
    return -(-v // m) * m


class TPUv5eSim(Platform):
    """Analytical timing model of one TPU v5e chip (optionally noisy)."""

    def __init__(
        self,
        knowledge: str = "white",
        noise: float = 0.0,
        moe_experts: int = 64,
        moe_topk: int = 8,
        kv_ratio: int = 4,
        chip: V5EChip = V5E,
        device: str | None = None,
    ) -> None:
        assert knowledge in ("white", "gray", "black")
        self.knowledge = knowledge
        self.name = f"tpu_v5e[{knowledge}]"
        self.noise = noise
        self.moe_experts = moe_experts
        self.moe_topk = moe_topk
        self.kv_ratio = kv_ratio
        self.chip = chip
        # Where the torch hook runs (``torch_kernels``): the card unless
        # "cpu".  It enters no name, cache key or number.
        self.device = device

    def cache_key(self) -> str:
        # The timing model depends on these beyond what `name` encodes.
        return (
            f"{self.name}|noise={self.noise}|E={self.moe_experts}"
            f"|topk={self.moe_topk}|kv={self.kv_ratio}"
        )

    def spawn_spec(self) -> tuple[str, dict, str]:
        # ``name`` is "tpu_v5e[<knowledge>]", not the registry name, so the
        # base recipe does not apply; every timing-model parameter rides along.
        kwargs = {
            "knowledge": self.knowledge,
            "noise": self.noise,
            "moe_experts": self.moe_experts,
            "moe_topk": self.moe_topk,
            "kv_ratio": self.kv_ratio,
            "device": self.device,
        }
        if self.chip is not V5E:
            kwargs["chip"] = self.chip  # frozen dataclass, pickles fine
        return ("tpu_v5e", kwargs, "repro_torch.accelerators.tpu_v5e")

    # ------------------------------------------------------------- capability
    def layer_types(self) -> tuple[str, ...]:
        return (
            "dense",
            "attention_prefill",
            "attention_decode",
            "moe_gemm",
            "ssd_scan",
            "embed",
        )

    def param_space(self, layer_type: str) -> ParamSpace:
        # Ranges cover the assigned architectures' per-device layer shapes --
        # Random Forests cannot extrapolate (paper Sec. 3.3), so the PR set
        # must span the region of interest.
        if layer_type == "dense":
            return ParamSpace(ranges={"tokens": (8, 131072), "d_in": (64, 16384), "d_out": (64, 16384)})
        if layer_type == "attention_prefill":
            return ParamSpace(
                ranges={"B": (1, 64), "S": (128, 32768), "H": (1, 64), "Dh": (32, 256)},
                fixed={"kv_ratio": self.kv_ratio},
            )
        if layer_type == "attention_decode":
            return ParamSpace(
                ranges={"B": (1, 256), "S_kv": (128, 524288), "H": (1, 64), "Dh": (32, 256)},
                fixed={"kv_ratio": self.kv_ratio},
            )
        if layer_type == "moe_gemm":
            return ParamSpace(
                ranges={"tokens": (64, 65536), "d_model": (128, 4096), "d_ff": (128, 8192)},
                fixed={"E": self.moe_experts, "topk": self.moe_topk},
            )
        if layer_type == "ssd_scan":
            return ParamSpace(
                ranges={"B": (1, 64), "S": (128, 32768), "H": (1, 128), "P": (32, 256), "N": (16, 256)}
            )
        if layer_type == "embed":
            return ParamSpace(ranges={"tokens": (8, 131072), "vocab": (1024, 262144), "d_model": (128, 8192)})
        raise KeyError(layer_type)

    def defaults(self, layer_type: str) -> Config:
        return {
            "dense": {"tokens": 2048, "d_in": 2048, "d_out": 2048},
            "attention_prefill": {"B": 8, "S": 2048, "H": 16, "Dh": 128, "kv_ratio": self.kv_ratio},
            "attention_decode": {"B": 32, "S_kv": 4096, "H": 16, "Dh": 128, "kv_ratio": self.kv_ratio},
            "moe_gemm": {"tokens": 4096, "d_model": 2048, "d_ff": 1024, "E": self.moe_experts, "topk": self.moe_topk},
            "ssd_scan": {"B": 8, "S": 2048, "H": 48, "P": 64, "N": 64},
            "embed": {"tokens": 8192, "vocab": 32000, "d_model": 2048},
        }[layer_type]

    def known_step_widths(self, layer_type: str) -> dict[str, int] | None:
        c = self.chip
        white = {
            "dense": {"tokens": c.sublane, "d_in": c.mxu, "d_out": c.mxu},
            "attention_prefill": {"B": 1, "S": c.mxu, "H": 1, "Dh": c.mxu},
            "attention_decode": {"B": c.sublane, "S_kv": c.kv_page, "H": 1, "Dh": c.mxu},
            "moe_gemm": {
                "tokens": max(1, self.moe_experts * c.sublane // self.moe_topk),
                "d_model": c.mxu,
                "d_ff": c.mxu,
            },
            "ssd_scan": {"B": 1, "S": c.ssd_chunk, "H": c.sublane, "P": c.mxu, "N": c.mxu},
            "embed": {"tokens": 1, "vocab": 1, "d_model": 1},
        }
        if self.knowledge == "white":
            return white[layer_type]
        if self.knowledge == "gray":
            # Only the MXU 128x128 quantisation is documented publicly; the
            # sublane/page/chunk widths must be confirmed by sweeps.
            gray = {k: v for k, v in white[layer_type].items() if v == self.chip.mxu}
            return gray or None
        return None

    # ------------------------------------------------------------- timing model
    def _terms(self, layer_type: str, cfg: Config) -> tuple[float, float]:
        """(flop_seconds, hbm_seconds) of one layer, after tile padding."""
        c = self.chip
        if layer_type == "dense":
            m = _pad(cfg["tokens"], c.sublane)
            k = _pad(cfg["d_in"], c.mxu)
            n = _pad(cfg["d_out"], c.mxu)
            flops = 2.0 * m * k * n
            bytes_ = 2.0 * (m * k + m * n + k * n)
        elif layer_type == "attention_prefill":
            b, h, dh = cfg["B"], cfg["H"], _pad(cfg["Dh"], c.mxu)
            kvh = max(1, h // cfg.get("kv_ratio", self.kv_ratio))
            s = _pad(cfg["S"], c.mxu)
            # causal flash attention: QK^T and PV, half the square each
            flops = 2.0 * b * h * s * s * dh  # = 2 * (0.5*s^2) * dh * 2 matmuls
            bytes_ = 2.0 * (b * h * s * dh + 2 * b * kvh * s * dh + b * h * s * dh)
        elif layer_type == "attention_decode":
            b = _pad(cfg["B"], c.sublane)
            h, dh = cfg["H"], _pad(cfg["Dh"], c.mxu)
            kvh = max(1, h // cfg.get("kv_ratio", self.kv_ratio))
            s = _pad(cfg["S_kv"], c.kv_page)
            flops = 4.0 * b * h * s * dh
            bytes_ = 2.0 * (2 * b * kvh * s * dh + 2 * b * h * dh)
        elif layer_type == "moe_gemm":
            e, topk = cfg["E"], cfg["topk"]
            per_expert = _pad(int(math.ceil(cfg["tokens"] * topk / e)), c.sublane)
            dm = _pad(cfg["d_model"], c.mxu)
            df = _pad(cfg["d_ff"], c.mxu)
            # gated MLP per expert: in+gate+out = 3 GEMMs
            flops = 3.0 * 2.0 * e * per_expert * dm * df
            bytes_ = 2.0 * (3 * e * dm * df + e * per_expert * (2 * dm + 2 * df))
        elif layer_type == "ssd_scan":
            b, h = cfg["B"], _pad(cfg["H"], c.sublane)
            p = _pad(cfg["P"], c.mxu)
            n = _pad(cfg["N"], c.mxu)
            s = _pad(cfg["S"], c.ssd_chunk)
            q = c.ssd_chunk
            nchunks = s // q
            # per chunk: C B^T (q x q), (L.(CB^T)) x (q x p), plus state in/out
            per_chunk = 2.0 * q * q * n + 2.0 * q * q * p + 4.0 * q * n * p
            flops = b * h * nchunks * per_chunk
            bytes_ = 2.0 * b * s * (h * p * 2 + 2 * n + h)  # x,y,B,C,dt
        elif layer_type == "embed":
            t, dm = cfg["tokens"], cfg["d_model"]
            flops = 0.0
            bytes_ = 2.0 * t * dm * 2 + 4.0 * t  # gather read+write, int32 ids
        else:
            raise KeyError(layer_type)
        return flops / c.peak_bf16_flops, bytes_ / c.hbm_bandwidth

    def _noise_factor(self, layer_type: str, cfg: Config) -> float:
        if self.noise <= 0:
            return 1.0
        # Deterministic per-configuration noise: a simulator is repeatable, but
        # different configs see different (fixed) perturbations.
        key = hashlib.blake2b(
            repr((layer_type, sorted(cfg.items()))).encode(), digest_size=8
        ).digest()
        rng = np.random.default_rng(int.from_bytes(key, "little"))
        return float(rng.lognormal(0.0, self.noise))

    def _terms_batch(
        self, layer_type: str, batch: ConfigBatch
    ) -> tuple[np.ndarray, np.ndarray]:
        """Columnar ``_terms``: (flop_seconds, hbm_seconds) per row.

        Every expression mirrors the scalar model operation for operation
        (same padding, same int/float promotion order), so the result is
        bitwise-identical to looping ``_terms`` over the rows.
        """
        c = self.chip
        col = batch.column
        get = batch.get
        if layer_type == "dense":
            m = _pad_arr(col("tokens"), c.sublane)
            k = _pad_arr(col("d_in"), c.mxu)
            n = _pad_arr(col("d_out"), c.mxu)
            flops = 2.0 * m * k * n
            bytes_ = 2.0 * (m * k + m * n + k * n)
        elif layer_type == "attention_prefill":
            b, h, dh = col("B"), col("H"), _pad_arr(col("Dh"), c.mxu)
            kvh = np.maximum(1, h // get("kv_ratio", self.kv_ratio))
            s = _pad_arr(col("S"), c.mxu)
            flops = 2.0 * b * h * s * s * dh
            bytes_ = 2.0 * (b * h * s * dh + 2 * b * kvh * s * dh + b * h * s * dh)
        elif layer_type == "attention_decode":
            b = _pad_arr(col("B"), c.sublane)
            h, dh = col("H"), _pad_arr(col("Dh"), c.mxu)
            kvh = np.maximum(1, h // get("kv_ratio", self.kv_ratio))
            s = _pad_arr(col("S_kv"), c.kv_page)
            flops = 4.0 * b * h * s * dh
            bytes_ = 2.0 * (2 * b * kvh * s * dh + 2 * b * h * dh)
        elif layer_type == "moe_gemm":
            e, topk = col("E"), col("topk")
            per_expert = _pad_arr(-(-(col("tokens") * topk) // e), c.sublane)
            dm = _pad_arr(col("d_model"), c.mxu)
            df = _pad_arr(col("d_ff"), c.mxu)
            flops = 3.0 * 2.0 * e * per_expert * dm * df
            bytes_ = 2.0 * (3 * e * dm * df + e * per_expert * (2 * dm + 2 * df))
        elif layer_type == "ssd_scan":
            b, h = col("B"), _pad_arr(col("H"), c.sublane)
            p = _pad_arr(col("P"), c.mxu)
            n = _pad_arr(col("N"), c.mxu)
            s = _pad_arr(col("S"), c.ssd_chunk)
            q = c.ssd_chunk
            nchunks = s // q
            per_chunk = 2.0 * q * q * n + 2.0 * q * q * p + 4.0 * q * n * p
            flops = b * h * nchunks * per_chunk
            bytes_ = 2.0 * b * s * (h * p * 2 + 2 * n + h)
        elif layer_type == "embed":
            t, dm = col("tokens"), col("d_model")
            flops = np.zeros(len(batch), dtype=np.float64)
            bytes_ = 2.0 * t * dm * 2 + 4.0 * t
        else:
            raise KeyError(layer_type)
        return flops / c.peak_bf16_flops, bytes_ / c.hbm_bandwidth

    def measure(self, layer_type: str, cfg: Config) -> float:
        flop_s, mem_s = self._terms(layer_type, cfg)
        t = max(flop_s, mem_s) + self.chip.launch_overhead_s
        return t * self._noise_factor(layer_type, cfg)

    def measure_batch(self, layer_type: str, batch: ConfigBatch) -> np.ndarray:
        if self.noise <= 0:
            # Torch program on ``device`` unless the platform's
            # ``predict_backend`` attribute is "numpy"; bitwise-identical, see
            # repro_torch.accelerators.torch_kernels.  Noisy mode stays numpy: the
            # per-config hash seeding is inherently scalar.
            from repro_torch.accelerators import torch_kernels

            t = torch_kernels.tpu_measure_batch(self, layer_type, batch)
            if t is not None:
                return t
        flop_s, mem_s = self._terms_batch(layer_type, batch)
        t = np.maximum(flop_s, mem_s) + self.chip.launch_overhead_s
        if self.noise > 0:
            # The per-config hash seeding is inherently scalar; noisy mode
            # pays a row loop for the factors only.
            t = t * np.array(
                [self._noise_factor(layer_type, cfg) for cfg in batch.to_dicts()]
            )
        return np.asarray(t, dtype=np.float64)

    def measure_block(self, layers, collective_bytes: float = 0.0, **kwargs) -> float:
        """Fused multi-layer block: overlapped compute/DMA/ICI (Eq. 9 analog)."""
        flop_s = 0.0
        mem_s = 0.0
        for lt, cfg in layers:
            f, m = self._terms(lt, cfg)
            flop_s += f
            mem_s += m
        ici_s = collective_bytes / (self.chip.ici_bandwidth * self.chip.ici_links)
        t = max(flop_s, mem_s, ici_s) + self.chip.launch_overhead_s
        return t * self._noise_factor("block", {"n": len(layers)})

    def measure_block_batch(self, batch: BlockBatch) -> np.ndarray:
        """Columnar fused-block model, bitwise-identical to ``measure_block``.

        Per-layer (flop, hbm) terms come from one ``_terms_batch`` call per
        layer group; ``np.bincount`` then accumulates each block's terms in
        layer-table order — the same left-fold the scalar ``+=`` loop runs —
        before the Eq.-9 max against the in-flight collective term.
        """
        # One _terms_batch per group computes both columns, so this keeps its
        # own scatter loop instead of two scatter_groups passes.
        flop = np.zeros(batch.n_layers, dtype=np.float64)
        mem = np.zeros(batch.n_layers, dtype=np.float64)
        for g, (lt, cfgs) in enumerate(zip(batch.group_types, batch.group_configs)):
            mask = batch.group_of == g
            f, m = self._terms_batch(lt, cfgs)
            flop[mask] = f
            mem[mask] = m
        flop_s = batch.sum_by_block(flop)
        mem_s = batch.sum_by_block(mem)
        ici_s = batch.collective_bytes / (self.chip.ici_bandwidth * self.chip.ici_links)
        t = np.maximum(np.maximum(flop_s, mem_s), ici_s) + self.chip.launch_overhead_s
        if self.noise > 0:
            # Per-block hash seeding is inherently scalar (same as measure_batch).
            t = t * np.array(
                [
                    self._noise_factor("block", {"n": int(c)})
                    for c in batch.layer_counts().tolist()
                ]
            )
        return np.asarray(t, dtype=np.float64)


register_platform("tpu_v5e", TPUv5eSim)
