"""Phase-time breakdown reporter for repro trace files.

  PYTHONPATH=src python -m repro_torch.obs.report runs/trace.jsonl
  PYTHONPATH=src python -m repro_torch.obs.report runs/trace.jsonl --chrome out.json

Reads the append-only JSONL trace written by :class:`repro_torch.obs.Tracer`,
aggregates the complete (``ph == "X"``) spans by name, and renders a table:
call count, total/mean/min/max milliseconds, and percent of the trace's wall
window (first event start -> last event end).  ``--chrome`` additionally
exports the Chrome/Perfetto ``trace_event`` JSON next to the table.

Nested spans overlap by design (``campaign.run`` contains everything), so
the ``%wall`` column can sum past 100 — it answers "how much of the run was
this phase live", not "exclusive self time".

stdlib + repro_torch.obs.trace only: the reporter must work on boxes without jax
(pinned by the no-eager-jax subprocess test).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.trace import export_chrome, load_events


def summarize(events: list[dict]) -> dict:
    """Aggregate complete spans by name -> {name: {count,total_ms,...}}."""
    spans: dict[str, dict] = {}
    t_min = None
    t_max = None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        ts = float(ev.get("ts", 0.0))
        dur = float(ev.get("dur", 0.0))
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = ts + dur if t_max is None else max(t_max, ts + dur)
        row = spans.get(ev["name"])
        if row is None:
            row = spans[ev["name"]] = {
                "count": 0, "total_us": 0.0, "min_us": dur, "max_us": dur,
            }
        row["count"] += 1
        row["total_us"] += dur
        row["min_us"] = min(row["min_us"], dur)
        row["max_us"] = max(row["max_us"], dur)
    wall_us = (t_max - t_min) if t_min is not None else 0.0
    return {"spans": spans, "wall_us": wall_us}


def render(summary: dict, sort: str = "total", limit: int = 0) -> str:
    """Render the aggregate as an aligned text table."""
    spans = summary["spans"]
    wall_us = summary["wall_us"]
    key = {
        "total": lambda kv: -kv[1]["total_us"],
        "count": lambda kv: -kv[1]["count"],
        "mean": lambda kv: -(kv[1]["total_us"] / kv[1]["count"]),
        "name": lambda kv: kv[0],
    }[sort]
    rows = sorted(spans.items(), key=key)
    if limit:
        rows = rows[:limit]
    name_w = max([len("span")] + [len(n) for n, _ in rows])
    header = (f"{'span':<{name_w}}  {'count':>7}  {'total_ms':>10}  "
              f"{'mean_ms':>9}  {'min_ms':>9}  {'max_ms':>9}  {'%wall':>6}")
    lines = [header, "-" * len(header)]
    for name, row in rows:
        total_ms = row["total_us"] / 1e3
        mean_ms = total_ms / row["count"]
        pct = 100.0 * row["total_us"] / wall_us if wall_us > 0 else 0.0
        lines.append(
            f"{name:<{name_w}}  {row['count']:>7d}  {total_ms:>10.3f}  "
            f"{mean_ms:>9.3f}  {row['min_us']/1e3:>9.3f}  "
            f"{row['max_us']/1e3:>9.3f}  {pct:>6.1f}"
        )
    lines.append("")
    lines.append(f"trace wall window: {wall_us/1e3:.3f} ms, "
                 f"{sum(r['count'] for r in spans.values())} spans, "
                 f"{len(spans)} distinct names")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="phase-time breakdown from a repro JSONL trace",
    )
    ap.add_argument("trace", help="path to the trace .jsonl file")
    ap.add_argument("--chrome", default=None, metavar="OUT",
                    help="also export Chrome/Perfetto trace_event JSON to OUT")
    ap.add_argument("--sort", default="total",
                    choices=("total", "count", "mean", "name"))
    ap.add_argument("--limit", type=int, default=0,
                    help="show only the first N rows (0 = all)")
    args = ap.parse_args(argv)

    events = load_events(args.trace)
    if not events:
        print(f"no events in {args.trace}", file=sys.stderr)
        return 1
    print(render(summarize(events), sort=args.sort, limit=args.limit))
    if args.chrome:
        n = export_chrome(args.trace, args.chrome)
        print(f"\nwrote {n} events to {args.chrome} "
              f"(open in https://ui.perfetto.dev or chrome://tracing)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
