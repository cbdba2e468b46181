"""The traced run by stage: the program's spans (``record_function`` ranges
that ``juliaraytracingsw_tpu_torch.utils.observability.span`` opens while
a profiler records) joined to the device's timeline by launch, and the
program's count of host waits.

    python3 -m portbench.stages --workload <cell> --seed <n> --seconds <s> --trace 1

runs the cell exactly as ``python3 -m portbench.run`` does (its result line
and checks unchanged), with the traced stretch reduced by ``summarize``
below, then prints one line a span on standard error and, last on standard
output, the stage keys and the span-fed metrics (``metrics/<name>.py``
for each name in ``METRICS``) as one JSON line.

``summarize`` returns ``trace.summarize``'s keys, computed from the same
events with the spans left out (so ``idle_gaps`` still names host
operations), and adds:

    stage_device_s  {span: seconds}: each device op's seconds put down to the
                    innermost span open at its launch: the host op whose
                    id is the op's ``linked_correlation_id``, else the CUDA
                    API call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
                    ...) of the op's own correlation id, where the
                    events carry no linked id;
                    '(outside spans)' where none is open, '(launch not
                    found)' where neither event is in the profile
    stage_idle_s    {span: seconds}: each idle gap put down to the innermost
                    span at its middle ('(outside spans)')
    stage_idle_ops  {span: [[host op, seconds], ...]}: the five host
                    operations (as ``idle_gaps`` names them) in flight in
                    most of each span's idle time
    sync_idle_s     the idle gaps that hold the end of a ``wait.*`` span:
                    where a wait drained the device and the host refills it
    spans           {name: [count, host seconds, self seconds]}; self is the
                    span's time less its child spans'

and the profiled stretch's ``host_waits``: the growth of the program's
``observability.waits`` (absent where the program has none).
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import heapq
import json
import sys
import time
from unittest import mock

import torch

from . import trace

__all__ = ["METRICS", "OUTSIDE", "NOT_FOUND", "events", "summarize", "profile_frames", "run_traced",
           "stage_report", "main"]

OUTSIDE = "(outside spans)"
NOT_FOUND = "(launch not found)"
NO_HOST_OP = "(no host operation)"
TOP_OPS = 5
WAIT_PREFIX = "wait."
# the span-fed metrics and their units
METRICS = {"driver.host_waits_per_step": "waits/step", "driver.sync_idle_pct": "%",
           "flow.step_ms_per_step": "ms/step", "rays.table_ms_per_step": "ms/step"}


def events(prof):
    """(kind, name, start_us, end_us, id, linked_correlation_id) of every
    profiler event: kind 'cuda' for device work (the annotation ranges
    ``record_function`` puts on the device's timeline left out), 'span'
    for a ``record_function`` range of the host other than the window's
    mark, 'cpu' for the rest."""
    for e in prof.events():
        annotation = getattr(e, "is_user_annotation", False)
        if e.device_type.name == "CUDA":
            if annotation or e.name == trace.WINDOW_MARK:
                continue
            kind = "cuda"
        else:
            kind = "span" if annotation and e.name != trace.WINDOW_MARK else "cpu"
        yield (kind, e.name, float(e.time_range.start), float(e.time_range.end), e.id,
               getattr(e, "linked_correlation_id", 0))


def _innermost(times, spans) -> list:
    """For each time, the name of the innermost span (latest start) open at
    it, or None; ``spans`` is [(start, end, name)]."""
    order = sorted(range(len(times)), key=times.__getitem__)
    spans = sorted(spans)
    out = [None] * len(times)
    heap: list = []
    i = 0
    for j in order:
        t = times[j]
        while i < len(spans) and spans[i][0] <= t:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out[j] = heap[0][2] if heap else None
    return out


def _span_times(spans) -> dict:
    """{name: [count, seconds, self seconds]} of properly nested spans."""
    out: dict = {}
    stack: list = []      # [end, name, duration, children's duration] (µs)

    def close():
        _, name, dur, child = stack.pop()
        c = out.setdefault(name, [0, 0.0, 0.0])
        c[0] += 1
        c[1] += dur / 1e6
        c[2] += (dur - child) / 1e6
        if stack:
            stack[-1][3] += dur

    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][0] <= s:
            close()
        stack.append([e, name, e - s, 0.0])
    while stack:
        close()
    return out


def summarize(events, window) -> dict:
    """``trace.summarize`` of the events without the spans, and the stage
    keys. An event is (kind, name, start_us, end_us[, id, linked]); a
    device op without ids is put down to '(launch not found)'."""
    w0, w1 = window
    summary = trace.summarize([ev[:4] for ev in events if ev[0] != "span"], window)
    spans = [(max(s, w0), min(e, w1), name) for kind, name, s, e, *_ in events
             if kind == "span" and e >= w0 and s <= w1]
    # a device op's launch: the host op whose id is its linked correlation
    # id, else the CUDA API call (``cu*``) of its own correlation id
    frontend, runtime = {}, {}
    for kind, name, s, e, *ids in events:
        if kind == "cuda" or len(ids) != 2:
            continue
        if name.startswith("cu"):
            runtime[ids[0]] = s
        elif not ids[1]:
            frontend[ids[0]] = s
    dev, launched = [], []
    for kind, name, s, e, *ids in events:
        if kind != "cuda" or e < w0 or s > w1:
            continue
        s, e = max(s, w0), min(e, w1)
        dev.append((s, e))
        t = None
        if len(ids) == 2:
            t = frontend.get(ids[1]) if ids[1] else None
            t = runtime.get(ids[0]) if t is None else t
        launched.append((e - s, t))
    stage_dev: dict = {}
    found = [t for _, t in launched if t is not None]
    names = iter(_innermost(found, spans))
    for sec, t in launched:
        key = NOT_FOUND if t is None else (next(names) or OUTSIDE)
        stage_dev[key] = stage_dev.get(key, 0.0) + sec / 1e6
    _, merged = trace.union_seconds(dev)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = [(s, e, name) for kind, name, s, e, *_ in events
            if kind == "cpu" and name != trace.WINDOW_MARK]
    mids = [0.5 * (a + b) for a, b in gaps]
    stage_idle: dict = {}
    stage_ops: dict = {}
    for (a, b), name, op in zip(gaps, _innermost(mids, spans), _innermost(mids, host)):
        key, sec = name or OUTSIDE, (b - a) / 1e6
        stage_idle[key] = stage_idle.get(key, 0.0) + sec
        ops = stage_ops.setdefault(key, {})
        ops[op or NO_HOST_OP] = ops.get(op or NO_HOST_OP, 0.0) + sec
    ends = sorted(e for s, e, name in spans if name.startswith(WAIT_PREFIX))
    sync = sum(b - a for a, b in gaps
               if bisect.bisect_right(ends, b) > bisect.bisect_left(ends, a)) / 1e6
    summary.update(stage_device_s=stage_dev, stage_idle_s=stage_idle, sync_idle_s=sync,
                   spans=_span_times(spans),
                   stage_idle_ops={k: sorted(v.items(), key=lambda kv: -kv[1])[:TOP_OPS]
                                   for k, v in stage_ops.items()})
    return summary


def _host_waits():
    """The program's host waits so far, or None where it counts none."""
    from juliaraytracingsw_tpu_torch.utils import observability

    waits = getattr(observability, "waits", None)
    return None if waits is None else sum(waits.values())


def profile_frames(run_frames, n_frames: int) -> dict:
    """``trace.profile_frames`` with the stage keys and ``host_waits``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    waits0 = _host_waits()
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW_MARK):
            t0 = time.perf_counter()
            run_frames(n_frames)
            if cuda:
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    waits1 = _host_waits()
    evs = list(events(prof))
    marks = [(s, e) for kind, name, s, e, *_ in evs if name == trace.WINDOW_MARK]
    if not marks:
        raise RuntimeError("the profile holds no window mark")
    summary = summarize(evs, marks[0])
    summary["host_window_s"] = host_s
    if waits0 is not None:
        summary["host_waits"] = waits1 - waits0
    return summary


@contextlib.contextmanager
def _staged():
    """For the scope, ``trace.profile_frames`` is this module's; yields a
    dict that gets the traced run's summary, whose ``counters`` (filled by
    ``run.run_cell``) gain ``host_waits`` once the scope ends."""
    kept: dict = {}

    def profile_and_keep(run_frames, n_frames):
        kept["summary"] = profile_frames(run_frames, n_frames)
        return kept["summary"]

    with mock.patch.object(trace, "profile_frames", profile_and_keep):
        yield kept
    summary = kept.get("summary")
    if summary is not None and "host_waits" in summary:
        summary["counters"]["host_waits"] = summary.pop("host_waits")


def run_traced(cell, bench: dict, seed: int, device: str = "cuda", t_start=None, log_fn=None):
    """``run.run_cell`` traced, with this module's reduction -> (result,
    checks, summary)."""
    from . import run

    with _staged() as kept:
        result, checks = run.run_cell(cell, bench, seed, 0.0, True, device, t_start, log_fn)
    return result, checks, kept["summary"]


def stage_report(summary, cell) -> dict:
    """The stage keys, the span-fed metrics that read something, and one
    line a span: count, host ms, self ms, device ms, idle ms."""
    from .spec import reader

    metrics = {}
    for name, unit in METRICS.items():
        v = reader(name)(summary, cell)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    dev, idle = summary["stage_device_s"], summary["stage_idle_s"]
    ops = summary["stage_idle_ops"]

    def idle_of(name):
        top = ", ".join(f"{op} {1e3 * sec:.1f}" for op, sec in ops.get(name, [])[:3])
        return f"idle_ms {1e3 * idle.get(name, 0.0)!r} ({top})"

    lines = [f"span {name} x{count} host_ms {1e3 * host!r} self_ms {1e3 * own!r} "
             f"device_ms {1e3 * dev.get(name, 0.0)!r} {idle_of(name)}"
             for name, (count, host, own) in sorted(summary["spans"].items())]
    for name in (OUTSIDE, NOT_FOUND):
        if name in dev or name in idle:
            lines.append(f"span {name} device_ms {1e3 * dev.get(name, 0.0)!r} {idle_of(name)}")
    keys = ("window_s", "busy_s", "steps", "frames", "stage_device_s", "stage_idle_s",
            "stage_idle_ops", "sync_idle_s", "spans", "counters")
    return {"stages": {k: summary[k] for k in keys}, "metrics": metrics, "lines": lines}


def main(argv=None) -> int:
    """``run.main`` traced by stage (``--trace 1`` only)."""
    from . import run
    from .spec import load_benchmark, load_cell

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--trace", type=int, default=1)
    known, _ = ap.parse_known_args(argv)
    if known.trace != 1:
        print("portbench.stages: the stages come from a traced run (--trace 1)",
              file=sys.stderr)
        return 2
    cell = load_cell(known.workload, load_benchmark(run.ROOT))
    with _staged() as kept:
        rc = run.main(argv)
    if rc or "summary" not in kept:
        return rc or 1
    report = stage_report(kept["summary"], cell)
    for line in report.pop("lines"):
        print(line, file=sys.stderr)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
