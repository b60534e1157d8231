"""Three-term roofline analysis from a compiled (dry-run) artifact.

  compute term    = HLO_FLOPs / (chips x peak_FLOP/s)
  memory term     = HLO_bytes / (chips x HBM_bw)
  collective term = collective_bytes / (chips x link_bw)

HLO_FLOPs / HLO_bytes from ``compiled.cost_analysis()`` are **per-device** on
SPMD modules (calibrated empirically: a (1024,1024)^2 matmul sharded over 8
host devices reports 2MNK/8).  Terms are therefore per-device values over
per-chip peak rates; fleet totals (= per-device x chips) are also recorded.
collective_bytes is parsed from the optimized (per-device) HLO text: the
payload bytes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute.

Hardware constants: TPU v5e -- 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link
ICI (we report the conservative single-link figure; a 2D-torus axis can
stripe over 2 links).

NOTE the dry-run lowers layer stacks *unrolled* (scan_layers=False) so that
cost_analysis and the collective parse see every layer -- XLA's cost analysis
visits a while-loop body once and would undercount a scanned stack by ~n_layers.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# e.g. "bf16[16,4096,128]{2,1,0}"
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?P<result>\([^)]*\)|[\w\[\]{},: ]*?)\s*"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?P<suffix>-start|-done)?\("
)


def _shape_bytes(text: str) -> list[float]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        out.append(n * _DTYPE_BYTES[dtype])
    return out


def collective_bytes_from_hlo(hlo_text: str) -> dict[str, float]:
    """Per-device payload bytes per collective kind (sums max buffer per op)."""
    by_kind: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for m in _OP_RE.finditer(hlo_text):
        if m.group("suffix") == "-done":
            continue  # counted at -start
        sizes = _shape_bytes(m.group("result"))
        if not sizes:
            continue
        kind = m.group("op")
        by_kind[kind] += max(sizes)
        counts[kind] += 1
    by_kind["_counts"] = counts  # type: ignore[assignment]
    return by_kind


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12  # bf16 per chip
    hbm_bw: float = 819e9
    ici_bw: float = 50e9  # per link, one direction


V5E_HW = HW()

#: NVIDIA H100 SXM5 80GB at 700 W, datasheet figures: bf16 dense tensor-core
#: peak, HBM3, and the per-GPU 400 Gb/s InfiniBand NDR link (a 16-wide model
#: axis spans two 8-GPU NVLink nodes, so the network is the conservative
#: link).  The port's dry run passes ``hw=H100_HW``.
H100_HW = HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=50e9)


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # fleet-total HLO flops
    hbm_bytes: float  # fleet-total bytes accessed
    collective_bytes: float  # fleet-total collective payload
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    collective_detail: dict | None = None

    @property
    def step_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """Fraction of the pure-compute roofline achieved by the step."""
        ideal = (self.model_flops / self.chips) / V5E_HW.peak_flops
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def table_row(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def analyze_compiled(
    cost: dict[str, Any],
    hlo_text: str,
    chips: int,
    model_flops: float = 0.0,
    hw: HW = V5E_HW,
    collective_bytes: dict[str, float] | None = None,
) -> RooflineTerms:
    flops_pd = float(cost.get("flops", 0.0))  # per-device (see module doc)
    hbm_bytes_pd = float(cost.get("bytes accessed", 0.0))
    if collective_bytes is not None:
        coll = dict(collective_bytes)
        counts = coll.pop("_counts", {})
    else:
        coll = collective_bytes_from_hlo(hlo_text)
        counts = coll.pop("_counts")
    coll_pd = sum(coll.values())
    terms = RooflineTerms(
        flops=flops_pd * chips,
        hbm_bytes=hbm_bytes_pd * chips,
        collective_bytes=coll_pd * chips,
        chips=chips,
        compute_s=flops_pd / hw.peak_flops,
        memory_s=hbm_bytes_pd / hw.hbm_bw,
        collective_s=coll_pd / hw.ici_bw,
        bottleneck="",
        model_flops=model_flops,
        collective_detail={"bytes": coll, "counts": counts},
    )
    names = ["compute", "memory", "collective"]
    vals = [terms.compute_s, terms.memory_s, terms.collective_s]
    terms.bottleneck = names[int(max(range(3), key=lambda i: vals[i]))]
    return terms
