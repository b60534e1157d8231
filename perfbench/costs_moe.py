"""The yardstick of the dropless MoE's grouped expert products and of an OLMoE prefill's FLOPs.

A frozen copy, so a change to the program cannot move the yardstick:
``moe_grouped_cost`` copies ``src/repro_torch/kernels/costs.py``'s, and
``perfbench/tests/test_perfbench_costs.py`` pins the copy to the original at
the cell's shapes.  ``PREFILL_KERNEL`` is the base name of the grouped
kernels' entry point for many rows an expert (``csrc/moe_grouped.cu``): one
call of the wrapper launches it twice (gate and up with silu, then down), and
a prefill calls it once a MoE layer.  Plain Python over shapes.
"""

from __future__ import annotations

from perfbench import costs

PREFILL_KERNEL = "moe_grouped_prefill"


def moe_grouped_cost(rows: int, experts: int, d: int, f: int, elt: int = 2) -> tuple[float, float]:
    """(bytes, FLOPs) of the grouped expert products over ``rows`` routed entries that fall on
    ``experts`` distinct experts: those experts' gate, up and down weights (D x F each) read once,
    and the gathered rows in (D) and out (D) once, in ``elt`` bytes.  FLOPs: 2 D F for each of a
    row's three products."""
    nbytes = elt * (3 * experts * d * f + 2 * rows * d)
    return float(nbytes), 6.0 * rows * d * f


def prefill_grouped_least_ms(m: dict, batch: int, prompt: int) -> float:
    """The least time of one prefill's grouped products: every layer's call over the batch's
    T x k routed rows on all of the layer's experts."""
    rows = batch * prompt * m["moe_top_k"]
    per_call = costs.least_ms(*moe_grouped_cost(rows, m["moe_experts"], m["d_model"], m["d_ff"]))
    return m["n_layers"] * per_call


def moe_prefill_flops(m: dict, batch: int, prompt: int) -> float:
    """Model FLOPs of an OLMoE prefill of ``batch`` prompts of ``prompt`` tokens.

    Every product once: the attention's projections, the router, the top-k
    experts' three products of each token (the active ones only), causal
    attention by the flash formula (``costs.flash_cost``), and the head as
    the program computes it, at every position of the prompt.
    """
    d, f, v = m["d_model"], m["d_ff"], m["vocab"]
    hd, nh, nkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
    tokens = batch * prompt
    proj = 2.0 * tokens * d * (2 * nh * hd + 2 * nkv * hd)
    router = 2.0 * tokens * d * m["moe_experts"]
    active = 6.0 * tokens * m["moe_top_k"] * d * f
    attn = costs.flash_cost(batch, prompt, prompt, nh, nkv, hd, 2, True)[1]
    return m["n_layers"] * (proj + router + active + attn) + 2.0 * tokens * d * v
