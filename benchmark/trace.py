"""From a `torch.profiler` chrome trace of the traced sub-window to device
time: busy time, time by kernel class (`kernel_classes.json`,
first pattern that matches; the rest is "other"), the device operations
that took most time, and the longest idle gaps by what the host was doing.
"""

import heapq
import json
import re

from benchmark.common import BENCH_DIR, load_json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW_SPAN = "bench.traced"


def classes():
    return [(name, re.compile(pat)) for name, pat in load_json(BENCH_DIR / "kernel_classes.json")]


def classify(name, table):
    for cls, pat in table:
        if pat.search(name):
            return cls
    return "other"


def merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Reading:
    """The traced window of one trace file: `window_us` (the span
    `bench.traced`), `busy_us`, `time_us` by class, `ops` (name -> [us,
    calls]) and `gaps` (host activity -> us idle)."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        win = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"]
        if not win:
            raise ValueError(f"{path}: no {WINDOW_SPAN} span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_us = w1 - w0
        table = classes()
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and w0 <= float(e["ts"]) <= w1]
        self.time_us, self.ops = {}, {}
        for e in dev:
            cls = classify(e["name"], table)
            d = float(e["dur"])
            self.time_us[cls] = self.time_us.get(cls, 0.0) + d
            op = self.ops.setdefault(e["name"], [0.0, 0])
            op[0] += d
            op[1] += 1
        busy = merge([[float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1)] for e in dev])
        self.busy_us = sum(b - a for a, b in busy)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                       and e["name"] != WINDOW_SPAN), key=lambda h: h[0])
        self.gaps = {}
        active, k = [], 0  # a heap of the started host events, latest start first
        for a, b in gaps:  # in time order
            mid = (a + b) / 2
            while k < len(host) and host[k][0] <= mid:
                heapq.heappush(active, (-host[k][0], host[k][1], host[k][2]))
                k += 1
            while active and active[0][1] < mid:  # ended: it ends before every later gap too
                heapq.heappop(active)
            # the innermost host event running at the gap's middle: the latest
            # started one that has not ended (calls nest on the host)
            name = active[0][2] if active else "host: no traced call"
            self.gaps[name] = self.gaps.get(name, 0.0) + (b - a)

    def breakdown(self, n=10):
        """The `breakdown` of the result line: seconds of the top device
        operations and of the idle gaps by host activity."""
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[name[:160], us / 1e6] for name, (us, _) in ops],
                "idle_gaps": [[name[:160], us / 1e6] for name, us in gaps]}
