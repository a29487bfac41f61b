"""`program_spans.SpanReading` on a hand-written chrome trace, a reader that
finds no harness above it, and a traced dry run that reads the program's
spans and counters, whose saved trace the module's command turns into
spans.json.

The fixture's window runs 100 us on thread 1. Program spans there:
pano.frame [5, 95) > pano.chunk [10, 60) > render.field [20, 40); the
harness's bench.pano [3, 97) and a program-named span on thread 2 are no
program spans of the window. Device operations (launch -> operation):

    K1 [15, 25)  cudaLaunchKernel [12, 14) in pano.chunk
    K2 [30, 35)  cudaLaunchKernel [22, 24) in render.field
    K0 [40, 43)  no launch (correlation 99), before any graph launch: unmapped
    K3 [56, 60)  cudaGraphLaunch [50, 54) in pano.chunk
    K4 [62, 68)  correlation 77 (none): the latest graph launch, the one above
    M  [92, 95)  cudaMemcpyAsync [90, 93) in pano.frame

Idle gaps, late / queued: [0, 15) 14 (outside 5, pano.frame 5, pano.chunk
4) / 1 (pano.chunk); [25, 30) 0 / 5 (render.field); [35, 40) unmapped 5;
[43, 56) 11 (pano.chunk) / 2 (pano.chunk); [60, 62) 0 / 2 (pano.chunk);
[68, 92) 24 (pano.frame) / 0; [95, 100), the window's end, 5 (outside).
"""

import json
import subprocess
import sys
from pathlib import Path

from types import SimpleNamespace

import pytest

from benchmark import program_spans
from benchmark.program_spans import OUTSIDE, SpanReading, segments
from benchmark.trace import Reading

ROOT = Path(__file__).resolve().parent.parent.parent


def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7 if cat in (
        "kernel", "gpu_memcpy") else 1, "tid": tid, "ts": ts, "dur": dur, "args": args}


EVENTS = [
    x("user_annotation", "bench.traced", 0, 100),
    x("user_annotation", "bench.pano", 3, 94),
    x("user_annotation", "pano.frame", 5, 90),
    x("user_annotation", "pano.chunk", 10, 50),
    x("user_annotation", "render.field", 20, 20),
    x("user_annotation", "render.field", 0, 100, tid=2),
    x("cpu_op", "aten::mm", 21, 3),
    x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
    x("cuda_runtime", "cudaLaunchKernel", 22, 2, correlation=2),
    x("cuda_runtime", "cudaGraphLaunch", 50, 4, correlation=3),
    x("cuda_runtime", "cudaMemcpyAsync", 90, 3, correlation=4),
    x("kernel", "k1", 15, 10, correlation=1),
    x("kernel", "k2", 30, 5, correlation=2),
    x("kernel", "k0", 40, 3, correlation=99),
    x("kernel", "k3", 56, 4, correlation=3),
    x("kernel", "k4", 62, 6, correlation=77),
    x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 92, 3, correlation=4),
    {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "pid": 1, "tid": 1, "ts": 12},
]


@pytest.fixture(scope="module")
def reading(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace") / "fixture.trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return path, SpanReading(path), Reading(path)


def near(a, b):
    return {k: v for k, v in a.items() if v} == pytest.approx(b)


def test_segments_give_each_instant_its_open_spans():
    got = segments([(5, 95, "a"), (10, 60, "b"), (20, 40, "c")])
    assert got == [(5, 10, ("a",)), (10, 20, ("a", "b")), (20, 40, ("a", "b", "c")),
                   (40, 60, ("a", "b")), (60, 95, ("a",))]


def test_device_time_goes_to_the_span_around_each_launch(reading):
    _, r, _ = reading
    assert r.spans == {"pano.frame": {"calls": 1, "host_us": 90.0},
                       "pano.chunk": {"calls": 1, "host_us": 50.0},
                       "render.field": {"calls": 1, "host_us": 20.0}}
    assert near(r.device_self_us, {"pano.chunk": 20.0, "render.field": 5.0, "pano.frame": 3.0,
                                   "unmapped": 3.0})
    assert near(r.device_us, {"pano.frame": 28.0, "pano.chunk": 25.0, "render.field": 5.0,
                              "unmapped": 3.0})
    assert r.graph_fallback == 1
    assert r.ops_us == {"pano.chunk": {"k1": 10.0, "k3": 4.0, "k4": 6.0}, "render.field": {"k2": 5.0},
                        "pano.frame": {"Memcpy DtoH (Device -> Pageable)": 3.0},
                        "unmapped": {"k0": 3.0}}


def test_idle_splits_into_late_queued_and_unmapped(reading):
    _, r, old = reading
    assert near(r.late_us, {OUTSIDE: 10.0, "pano.frame": 29.0, "pano.chunk": 15.0})
    assert near(r.queued_us, {"pano.chunk": 5.0, "render.field": 5.0})
    assert r.unmapped_us == pytest.approx(5.0)
    total = sum(r.late_us.values()) + sum(r.queued_us.values()) + r.unmapped_us
    assert total == pytest.approx(r.window_us - r.busy_us) == pytest.approx(sum(old.gaps.values()))


def test_the_reading_of_trace_py_is_unchanged(reading):
    _, r, old = reading
    assert (r.window_us, r.busy_us, r.time_us, r.ops, r.gaps) == (
        old.window_us, old.busy_us, old.time_us, old.ops, old.gaps)
    assert r.busy_us == pytest.approx(31.0)
    assert r.breakdown() == old.breakdown()


def test_a_reader_outside_the_harness_fails_where_the_window_ran_on_a_device():
    with pytest.raises(RuntimeError, match="run_cell"):
        program_spans.read(SimpleNamespace(busy_s=1.0))
    assert program_spans.read(SimpleNamespace(busy_s=0.0)).spans is None


def test_a_traced_serving_dry_run_reads_the_programs_counters_and_writes_its_spans():
    seed = 2 ** 31 + 11
    out = subprocess.run([sys.executable, "-m", "benchmark.tests.dryrun", "--workload",
                          "kitti360.serve", "--trace", "1", "--seed", str(seed)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-2])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["metrics"]["pad_pct.serve"] == {"value": 0.0, "unit": "%"}  # 16 x 64 in 512s
    for name in ("sample_ms.serve", "field_ms.serve", "late_idle_ms.serve"):
        assert name not in result["metrics"]  # nothing ran on a device
    assert "program spans over" not in out.stderr  # the readers print nothing
    trace = ROOT / "bench_out" / f"kitti360.serve.seed{seed}.trace.json"
    out = subprocess.run([sys.executable, "-m", "benchmark.program_spans", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "program spans over" in out.stdout
    spans = json.loads((ROOT / "bench_out" / f"kitti360.serve.seed{seed}.spans.json").read_text())
    frames = spans["spans"]["pano.frame"]["calls"]
    assert frames and spans["spans"]["pano.chunk"]["calls"] == 2 * frames
    assert {"render.sample", "render.field", "render.composite"} <= set(spans["spans"])
    assert spans["top_ops"] == {}  # nothing ran on a device
