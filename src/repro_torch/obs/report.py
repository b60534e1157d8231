"""Phase-time breakdown reporter for repro trace files.

  PYTHONPATH=src python -m repro_torch.obs.report runs/trace.jsonl
  PYTHONPATH=src python -m repro_torch.obs.report runs/trace.jsonl --chrome out.json
  PYTHONPATH=src python -m repro_torch.obs.report traces/serve-123.json
  PYTHONPATH=src python -m repro_torch.obs.report traces/serve-123.metrics.json

Reads the append-only JSONL trace written by :class:`repro_torch.obs.Tracer`
(or its Chrome/Perfetto export, as the launchers' ``--trace-dir`` writes it),
aggregates the complete (``ph == "X"``) spans by name, and renders a table:
call count, total/mean/min/max milliseconds, self milliseconds, and percent
of the trace's wall window (first event start -> last event end).
``--chrome`` additionally exports the Chrome/Perfetto ``trace_event`` JSON
next to the table, with the trace's wall-clock epoch under ``otherData``.

Nested spans overlap by design (``campaign.run`` contains everything), so
the ``%wall`` column can sum past 100 — it answers "how much of the run was
this phase live".  ``self_ms`` is the exclusive time: each span's duration
less the part of it that its child spans (the spans nested in it on its
own thread's track) cover.

A metrics snapshot (``MetricsRegistry.snapshot()`` as JSON, the launchers'
``<stem>-<pid>.metrics.json``) renders as its counters and histograms.

stdlib + repro_torch.obs.trace only: the reporter must work on boxes without jax
(pinned by the no-eager-jax subprocess test).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import export_chrome, load_events


def self_times(events: list[dict]) -> list[float]:
    """Per complete span of ``events`` (in order), its duration less the
    union of its children's intervals: the spans nested directly in it on
    the same (pid, tid) track."""
    spans = [(i, ev) for i, ev in enumerate(events) if ev.get("ph") == "X"]
    covered: dict[int, list] = {i: [] for i, _ in spans}
    tracks: dict[tuple, list] = {}
    for i, ev in spans:
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append((ts, -dur, i))
    for track in tracks.values():
        open_spans: list[tuple[float, int]] = []  # (end, index), outermost first
        for ts, neg_dur, i in sorted(track):
            while open_spans and open_spans[-1][0] <= ts:
                open_spans.pop()
            if open_spans:
                end, parent = open_spans[-1]
                covered[parent].append((ts, min(ts - neg_dur, end)))
            open_spans.append((ts - neg_dur, i))
    out = []
    for i, ev in spans:
        merged, last = 0.0, None
        for a, b in sorted(covered[i]):
            if last is not None and a < last:
                a = last
            if b > a:
                merged += b - a
                last = b
        out.append(max(float(ev.get("dur", 0.0)) - merged, 0.0))
    return out


def summarize(events: list[dict]) -> dict:
    """Aggregate complete spans by name -> {name: {count,total_ms,...}}."""
    spans: dict[str, dict] = {}
    t_min = None
    t_max = None
    own = iter(self_times(events))
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
                "self_us": 0.0,
            }
        row["count"] += 1
        row["total_us"] += dur
        row["self_us"] += next(own)
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
              f"{'mean_ms':>9}  {'min_ms':>9}  {'max_ms':>9}  {'self_ms':>10}  {'%wall':>6}")
    lines = [header, "-" * len(header)]
    for name, row in rows:
        total_ms = row["total_us"] / 1e3
        mean_ms = total_ms / row["count"]
        pct = 100.0 * row["total_us"] / wall_us if wall_us > 0 else 0.0
        lines.append(
            f"{name:<{name_w}}  {row['count']:>7d}  {total_ms:>10.3f}  "
            f"{mean_ms:>9.3f}  {row['min_us']/1e3:>9.3f}  "
            f"{row['max_us']/1e3:>9.3f}  {row['self_us']/1e3:>10.3f}  {pct:>6.1f}"
        )
    lines.append("")
    lines.append(f"trace wall window: {wall_us/1e3:.3f} ms, "
                 f"{sum(r['count'] for r in spans.values())} spans, "
                 f"{len(spans)} distinct names")
    return "\n".join(lines)


def render_metrics(snapshot: dict) -> str:
    """Render a metrics snapshot's counters and histograms as text tables."""
    lines = []
    counters = snapshot.get("counters") or {}
    if counters:
        width = max(len("counter"), *(len(n) for n in counters))
        lines += [f"{'counter':<{width}}  {'value':>12}"]
        lines += [f"{n:<{width}}  {v:>12}" for n, v in sorted(counters.items())]
        lines.append("")
    hists = snapshot.get("histograms") or {}
    if hists:
        width = max(len("histogram"), *(len(n) for n in hists))

        def num(v) -> str:
            return f"{v:>11.3f}" if isinstance(v, (int, float)) else f"{'-':>11}"

        lines.append(f"{'histogram':<{width}}  {'count':>7}  {'mean':>11}  {'p50':>11}  {'p95':>11}  {'p99':>11}")
        for n, h in sorted(hists.items()):
            lines.append(f"{n:<{width}}  {h.get('count', 0):>7}  {num(h.get('mean'))}  {num(h.get('p50'))}  "
                         f"{num(h.get('p95'))}  {num(h.get('p99'))}")
    return "\n".join(lines) if lines else "no counters or histograms"


def _snapshot(path: str) -> dict | None:
    """The metrics snapshot in ``path``, or None when the file is a trace."""
    try:
        with open(path, encoding="utf-8") as fh:
            record = json.load(fh)
    except ValueError:
        return None
    if isinstance(record, dict) and "histograms" in record and "traceEvents" not in record:
        return record
    return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="phase-time breakdown from a repro JSONL trace",
    )
    ap.add_argument("trace", help="path to the trace (.jsonl, or a Chrome .json export) or a "
                                  "metrics snapshot (.metrics.json)")
    ap.add_argument("--chrome", default=None, metavar="OUT",
                    help="also export Chrome/Perfetto trace_event JSON to OUT")
    ap.add_argument("--sort", default="total",
                    choices=("total", "count", "mean", "name"))
    ap.add_argument("--limit", type=int, default=0,
                    help="show only the first N rows (0 = all)")
    args = ap.parse_args(argv)

    snapshot = _snapshot(args.trace)
    if snapshot is not None:
        print(render_metrics(snapshot))
        return 0
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
