"""The program's own spans and counters in a traced run, read beside the
kernel classes of `trace.py`.

The port records spans (`lidarnerf_tpu_torch/utils/tracing.py`) through
`torch.profiler.record_function` while a profile records, so the traced
window's chrome trace holds them as `user_annotation` events on the host's
clock, the clock of the device's activity. `SpanReading` extends `Reading`:

- Launch map: every device operation (`kernel`, `gpu_memcpy`, `gpu_memset`)
  goes through `args.correlation` to the runtime or driver call that
  launched it (`cudaLaunchKernel`, `cudaGraphLaunch`, `cudaMemcpyAsync`, ...).
  An operation whose correlation names no call is given to the latest
  `cudaGraphLaunch` that started before it, if any (`graph_fallback` counts
  them), else it is unmapped.
- Device time by span: each operation's time goes to the innermost program
  span (names starting with `PROGRAM`) that encloses its launch's start on
  the window's thread, the host's main thread; `OUTSIDE` where none does.
  `device_self_us` keeps the innermost span, `device_us` every enclosing one;
  `ops_us` splits the innermost span's time by the operation's name.
- Idle split: for each idle gap [a, b) of `Reading`'s, the operation that
  starts at b and its launch L: late = clamp(L.end - a, 0, b - a) (the host
  had not launched it yet), queued = the rest (it waited in the queue). The
  late part is spread over the host's timeline from a to a + late, to the
  innermost program span running at each instant or `OUTSIDE`; the queued
  part goes to the innermost span around L. The gap at the window's end,
  which no operation ends, is late (the harness closing the window). A gap
  whose operation has no launch is `unmapped_us`. late + queued + unmapped
  is the window's idle time.

`read(ctx)` computes this once for a per-layer reader and keeps it on the
readers' `ctx`, with no other effect: `spans` (per program span: calls, host
s, device s, self device s, late and queued idle s), `idle_late_s` and
`idle_queued_s` (the program's parts), `idle_split`, `counters` (the
program's host counters, added to only while the window's profile records).
It finds the trace in `run_cell`'s frame and raises where a window that ran
on a device finds none. A trace with no program span (a program without
them) leaves `ctx.spans` None, and the readers return None; so do the
readers of device time where the window ran nothing on a device
(`device_spans`).

The same readings, with each span's costliest operations (`top_ops`), of a
traced run's saved trace:

    python -m benchmark.program_spans bench_out/<cell>.seed<n>.trace.json [--units N]

writes `bench_out/<cell>.seed<n>.spans.json` and prints a table, ms a unit.
"""

import argparse
import bisect
import json
import sys
from pathlib import Path

from benchmark.trace import DEVICE_CATS, WINDOW_SPAN, Reading, merge

PROGRAM = ("pano.", "render.", "train.", "occ.")
OUTSIDE = "outside the program"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GRAPH_LAUNCH = "cudaGraphLaunch"
TOP_OPS = 12  # operations a span in spans.json's `top_ops`, by device time


def segments(spans):
    """[(t0, t1, name)] spans that nest -> disjoint [(t0, t1, stack)] in time
    order, `stack` the names of the spans open over [t0, t1), outermost first."""
    points = sorted({t for s in spans for t in s[:2]})
    by_start = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, active, k = [], [], 0
    for x, y in zip(points, points[1:]):
        while k < len(by_start) and by_start[k][0] <= x:
            active.append(by_start[k])
            k += 1
        active = [s for s in active if s[1] > x]
        if active:
            out.append((x, y, tuple(s[2] for s in sorted(active, key=lambda s: (s[0], -s[1])))))
    return out


class SpanReading(Reading):
    """`Reading` of a trace file, plus `spans` (name -> {"calls", "host_us"}),
    `device_us` and `device_self_us` (span, `OUTSIDE` or "unmapped" -> us),
    `ops_us` (the same keys -> operation name -> us),
    `late_us` and `queued_us` (span or `OUTSIDE` -> us), `unmapped_us`,
    `graph_fallback` (operations given to a graph launch by time)."""

    def __init__(self, path):
        super().__init__(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        win = next(e for e in events if e["name"] == WINDOW_SPAN)
        w0 = float(win["ts"])
        w1 = w0 + float(win["dur"])
        main = (win.get("pid"), win.get("tid"))
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                 if e.get("cat") == "user_annotation" and e["name"].startswith(PROGRAM)
                 and (e.get("pid"), e.get("tid")) == main and w0 <= float(e["ts"]) <= w1]
        self.spans = {}
        for t0, t1, name in spans:
            s = self.spans.setdefault(name, {"calls": 0, "host_us": 0.0})
            s["calls"] += 1
            s["host_us"] += t1 - t0
        self._segs = segments(spans)
        self._starts = [s[0] for s in self._segs]

        launches, graph = {}, []
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launches[corr] = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                if e["name"] == GRAPH_LAUNCH:
                    graph.append(launches[corr])
        graph.sort()
        graph_starts = [g[0] for g in graph]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) <= w1]
        self.graph_fallback = 0

        def launch_of(e):
            got = launches.get(e.get("args", {}).get("correlation"))
            if got is None and graph_starts:
                i = bisect.bisect_right(graph_starts, float(e["ts"])) - 1
                if i >= 0:
                    self.graph_fallback += 1
                    got = graph[i]
            return got

        self.device_us, self.device_self_us, self.ops_us = {}, {}, {}
        first = {}  # start -> (launch end, launch) of the operation starting there launched first
        for e in dev:
            ts, d = float(e["ts"]), float(e["dur"])
            L = launch_of(e)
            stack = ("unmapped",) if L is None else (self.stack_at(L[0]) or (OUTSIDE,))
            self.device_self_us[stack[-1]] = self.device_self_us.get(stack[-1], 0.0) + d
            ops = self.ops_us.setdefault(stack[-1], {})
            ops[e["name"]] = ops.get(e["name"], 0.0) + d
            for name in set(stack):
                self.device_us[name] = self.device_us.get(name, 0.0) + d
            if L is not None and (ts not in first or L[1] < first[ts][0]):
                first[ts] = (L[1], L)

        busy = merge([[float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)] for e in dev])
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        self.late_us, self.queued_us, self.unmapped_us = {}, {}, 0.0
        for a, b in gaps:
            if b in first:
                L = first[b][1]
                late = min(max(L[1] - a, 0.0), b - a)
                self._spread(a, a + late)
                if b - a > late:
                    name = (self.stack_at(L[0]) or (OUTSIDE,))[-1]
                    self.queued_us[name] = self.queued_us.get(name, 0.0) + (b - a - late)
            elif b == w1:
                self._spread(a, b)
            else:
                self.unmapped_us += b - a

    def stack_at(self, t):
        """The program spans open at host time t, outermost first."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._segs[i][1]:
            return self._segs[i][2]
        return ()

    def _spread(self, x, y):
        """Give [x, y) of host time to the innermost program span at each
        instant, the rest to `OUTSIDE`."""
        covered = 0.0
        i = max(bisect.bisect_right(self._starts, x) - 1, 0)
        while i < len(self._segs) and self._segs[i][0] < y:
            s0, s1, stack = self._segs[i]
            part = min(s1, y) - max(s0, x)
            if part > 0:
                self.late_us[stack[-1]] = self.late_us.get(stack[-1], 0.0) + part
                covered += part
            i += 1
        if y - x > covered:
            self.late_us[OUTSIDE] = self.late_us.get(OUTSIDE, 0.0) + (y - x - covered)


def _run_locals(ctx):
    """The harness's `run_cell` locals (trace path, cell, seed), from the
    calling frames: the harness hands its readers no trace path. Raises
    where a window that ran operations on a device finds no such frame, so
    that a changed harness fails the run and does not silence the readers."""
    frame = sys._getframe(1)
    while frame is not None:
        names = frame.f_locals
        if frame.f_code.co_name == "run_cell" and "trace_path" in names:
            return names["trace_path"], names["cell"]["name"], names["seed"]
        frame = frame.f_back
    if ctx.busy_s > 0:
        raise RuntimeError("program_spans: no `run_cell` frame with a `trace_path` above the reader")
    return None


def _counters():
    try:
        from lidarnerf_tpu_torch.utils import tracing
    except ImportError:  # a program without spans
        return {}
    return tracing.counters()


def spans_of(r):
    """A SpanReading's program spans: name -> calls, host, device, self
    device, late and queued idle (s)."""
    names = sorted(set(r.spans) | set(r.device_us) | set(r.late_us) | set(r.queued_us))
    return {n: {"calls": r.spans.get(n, {}).get("calls", 0),
                "host_s": r.spans.get(n, {}).get("host_us", 0.0) / 1e6,
                "device_s": r.device_us.get(n, 0.0) / 1e6,
                "self_device_s": r.device_self_us.get(n, 0.0) / 1e6,
                "late_idle_s": r.late_us.get(n, 0.0) / 1e6,
                "queued_idle_s": r.queued_us.get(n, 0.0) / 1e6} for n in names}


def idle_split(r):
    """A SpanReading's idle time (s) by late and queued, the program's and the
    harness's parts, and unmapped."""
    return {"idle_s": (r.window_us - r.busy_us) / 1e6,
            "late_program_s": sum(v for k, v in r.late_us.items() if k != OUTSIDE) / 1e6,
            "late_outside_s": r.late_us.get(OUTSIDE, 0.0) / 1e6,
            "queued_program_s": sum(v for k, v in r.queued_us.items() if k != OUTSIDE) / 1e6,
            "queued_outside_s": r.queued_us.get(OUTSIDE, 0.0) / 1e6,
            "unmapped_s": r.unmapped_us / 1e6, "busy_s": r.busy_us / 1e6,
            "graph_fallback": r.graph_fallback}


def read(ctx):
    """Fill ctx's program readings once (module docstring); returns ctx."""
    if hasattr(ctx, "spans"):
        return ctx
    ctx.spans = None
    ctx.counters = _counters()
    found = _run_locals(ctx)
    if found is None or found[0] is None:
        return ctx
    r = SpanReading(found[0])
    if not r.spans:
        return ctx
    ctx.spans = spans_of(r)
    ctx.idle_split = idle_split(r)
    ctx.idle_late_s = ctx.idle_split["late_program_s"]
    ctx.idle_queued_s = ctx.idle_split["queued_program_s"]
    return ctx


def device_spans(ctx):
    """ctx.spans where the traced window ran operations on a device, else None."""
    return read(ctx).spans if ctx.busy_s > 0 else None


def table(out):
    """A spans.json's readings as lines of text, ms per unit."""
    u = max(out["units"], 1)
    lines = [f"program spans over {out['units']} units (ms a unit): name calls host device "
             "self_device late_idle queued_idle"]
    for name, s in sorted(out["spans"].items(), key=lambda kv: -kv[1]["device_s"]):
        lines.append(f"  {name} {s['calls']} " + " ".join(
            f"{1e3 * s[k] / u:.4f}" for k in ("host_s", "device_s", "self_device_s",
                                              "late_idle_s", "queued_idle_s")))
    lines.append("idle split (s): " + ", ".join(f"{k} {v!r}" for k, v in out["idle"].items()))
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="Write <cell>.seed<n>.spans.json beside each traced "
                                "run's trace and print its table.")
    p.add_argument("traces", nargs="+", help="bench_out/<cell>.seed<n>.trace.json")
    p.add_argument("--units", type=int, default=1, help="steps or panos in the traced window")
    args = p.parse_args(argv)
    for path in args.traces:
        r = SpanReading(path)
        out = {"trace": Path(path).name, "units": args.units, "idle": idle_split(r),
               "spans": spans_of(r),
               "top_ops": {n: [[op[:160], us / 1e6] for op, us in sorted(
                   ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]] for n, ops in r.ops_us.items()}}
        with open(str(path).replace(".trace.json", "") + ".spans.json", "w") as f:
            json.dump(out, f)
        print(f"{path}\n{table(out)}")


if __name__ == "__main__":
    main()
