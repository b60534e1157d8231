"""What a traced run (``--trace 1``) records: spans, the kernels' calls, and one profiled part.

Spans are host-clock intervals that the benchmark's own wrappers record
around its calls into the program's layers (the program itself has none
yet); a span's wrapper synchronises the device on both sides, so the
interval holds the layer's device work.  They live in memory.

``KernelCalls`` records the arguments of every launch of the port's three
kernels, from wrappers around their launch functions, so a reader can give
each call its least time (``costs.call_least_ms``).

``Profiled`` is one stretch of the window under ``torch.profiler``: the
device operations in it (kernels, copies, fills), reduced to the busy time
(the union of their intervals), the longest idle gaps named by what the
host was doing, the heaviest operations, and each port kernel's records.
torch.profiler has been seen to drop records on the H100, so a stretch is
``complete`` only when each port kernel's records equal the launches that its
wrapper counted over the same stretch times its kernels a call
(``costs.KERNELS``); the drivers profile another stretch when one is not.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import sys
import time
from collections import defaultdict

from perfbench import costs

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120  # a breakdown's operation names are cut to this length (templated names run to kilobytes)


class Spans:
    """Host-clock spans by name, in seconds."""

    def __init__(self):
        self.by_name: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync):
        from torch.profiler import record_function

        sync()
        t0 = time.perf_counter()
        with record_function(f"pb.{name}"):
            yield
            sync()
        self.by_name[name].append(time.perf_counter() - t0)


class KernelCalls:
    """Arguments of every launch of the port's kernels while installed (see the module's note)."""

    def __init__(self, ops):
        self.ops = ops
        self.calls: list[tuple[str, tuple]] = []
        self._saved = {}

    def install(self) -> None:
        ops = self.ops
        self._saved = {"_flash_launch": ops._flash_launch, "_ssd_fwd_launch": ops._ssd_fwd_launch,
                       "_ssd_bwd_launch": ops._ssd_bwd_launch}
        flash, fwd, bwd = self._saved.values()

        def flash_launch(q, k, v, causal, q_offset):
            b, sq, h, d = q.shape
            self.calls.append(("flash_attention", (b, sq, k.shape[1], h, k.shape[2], d, q.element_size(),
                                                   bool(causal), int(q_offset))))
            return flash(q, k, v, causal, q_offset)

        def ssd_fwd_launch(xbar, log_da, bmat, cmat, state0, chunk):
            b, s, h, p = xbar.shape
            self.calls.append(("ssd_scan", (b, s, h, p, bmat.shape[-1], xbar.element_size(), chunk,
                                            state0 is not None)))
            return fwd(xbar, log_da, bmat, cmat, state0, chunk)

        def ssd_bwd_launch(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk):
            b, s, h, p = xbar.shape
            self.calls.append(("ssd_scan_bwd", (b, s, h, p, bmat.shape[-1], xbar.element_size(), chunk,
                                                state0 is not None, dstate is not None)))
            return bwd(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk)

        ops._flash_launch, ops._ssd_fwd_launch, ops._ssd_bwd_launch = flash_launch, ssd_fwd_launch, ssd_bwd_launch

    def uninstall(self) -> None:
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)


def launch_counts(ops) -> dict:
    """The wrappers' own launch counters, by kernel."""
    return {name: getattr(ops, name).launches for name in costs.KERNELS}


def base_name(kernel: str) -> str:
    """A device kernel's function name without return type, namespace, template or arguments."""
    name = re.sub(r"^void\s+", "", kernel).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip()


class Profiled:
    """One profiled stretch; ``start()`` then ``stop()`` around it (see the module's note)."""

    WINDOW = "pb.profiled"

    def __init__(self, ops, calls: KernelCalls):
        self.ops, self.kernel_calls = ops, calls
        self._prof = self._annotation = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._counts0 = launch_counts(self.ops)
        self._calls0 = len(self.kernel_calls.calls)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._annotation = record_function(self.WINDOW)
        self._annotation.__enter__()

    def stop(self) -> dict:
        import torch

        torch.cuda.synchronize()
        self._annotation.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        launches = {k: v - self._counts0[k] for k, v in launch_counts(self.ops).items()}
        calls = self.kernel_calls.calls[self._calls0:]
        result = reduce_profile(self._prof.profiler.kineto_results.events(), launches, calls)
        self._prof = None
        return result


def _merge(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _kinds(events) -> list[str]:
    """Each raw event's kineto activity, from its device, its name and whether it is a user
    annotation (a device event named as a host annotation is that annotation's shadow on the
    device's timeline, not a kernel)."""
    annotations = {e.name() for e in events if "CUDA" not in str(e.device_type()) and e.is_user_annotation()}
    kinds = []
    for e in events:
        name = e.name()
        if "CUDA" not in str(e.device_type()):
            kinds.append("user_annotation" if e.is_user_annotation() else "cpu_op")
        elif name in annotations or name.startswith("pb."):
            kinds.append("gpu_user_annotation")
        elif name.startswith("Memcpy"):
            kinds.append("gpu_memcpy")
        elif name.startswith("Memset"):
            kinds.append("gpu_memset")
        else:
            kinds.append("kernel")
    return kinds


def reduce_profile(events, launches: dict, calls: list) -> dict:
    """The profiled stretch's numbers from the profiler's raw events (see the module's note)."""
    window = None
    device, host_ops, spans = [], [], []
    activities = set()
    events = list(events)
    for e, kind in zip(events, _kinds(events)):
        activities.add(kind)
        start, dur = e.start_ns(), e.duration_ns()
        if kind == "user_annotation" and e.name() == Profiled.WINDOW:
            window = (start, start + dur)
        elif kind == "user_annotation" and e.name().startswith("pb."):
            spans.append((start, start + dur, e.name()[3:]))
        elif kind in DEVICE_ACTIVITIES:
            device.append((start, start + dur, e.name(), kind))
        elif kind == "cpu_op":
            host_ops.append((start, start + dur, e.name()))
    if window is None:
        raise RuntimeError(f"the profiler recorded no {Profiled.WINDOW} annotation (activities {sorted(activities)})")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in device if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _, _ in device])
    busy_ns = sum(e - s for s, e in busy)

    records = defaultdict(int)
    by_op = defaultdict(float)
    kernel_ns = defaultdict(float)
    n_kernels = 0
    for s, e, name, kind in device:
        by_op[name] += (e - s) / 1e9
        if kind == "kernel":
            n_kernels += 1
            base = base_name(name)
            records[base] += 1
            kernel_ns[base] += e - s
    complete = {}
    for kernel, (names, per_call) in costs.KERNELS.items():
        got = sum(records[n] for n in names)
        complete[kernel] = got == per_call * launches.get(kernel, 0)
        if not complete[kernel]:
            print(f"profiler: {got} records of {kernel}'s kernels {names}, want {per_call} x "
                  f"{launches.get(kernel, 0)} launches: this stretch's records are incomplete", file=sys.stderr)

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host_ops.sort()
    starts = [s for s, _, _ in host_ops]

    def doing(t: int) -> str:
        span = min((sp for sp in spans if sp[0] <= t < sp[1]), key=lambda sp: sp[1] - sp[0], default=None)
        i = bisect.bisect_right(starts, t)
        op = None
        for s, e, name in reversed(host_ops[max(0, i - 2000):i]):
            if e > t:
                op = name
                break
        return f"{span[2] if span else 'between spans'}: {op or 'no host op'}"

    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": n_kernels,
        "device_ops": [(n[:NAME_CHARS], t) for n, t in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [(doing((a + b) // 2), g / 1e9) for g, a, b in gaps[:10]],
        "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
        "launches": launches,
        "calls": calls,
        "complete": complete,
    }


def kernel_roofline(profile: dict | None, kernel: str) -> float | None:
    """Percent of ``kernel``'s least time (summed over its calls in the stretch) in its device time, or None."""
    if not profile or not profile["complete"].get(kernel) or not profile["launches"].get(kernel):
        return None
    names, _ = costs.KERNELS[kernel]
    device_s = sum(profile["kernel_s"].get(n, 0.0) for n in names)
    least_ms = sum(costs.call_least_ms(k, args) for k, args in profile["calls"] if k == kernel)
    if device_s <= 0:
        return None
    return 100.0 * least_ms / 1e3 / device_s


def idle_percent(profile: dict | None) -> float | None:
    """Percent of the profiled stretch with no device operation running, or None when its records are incomplete."""
    if not profile or not all(profile["complete"].values()) or profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
