"""The traced run's reduction: one ``torch.profiler`` capture (CPU and
CUDA activities) of a stretch of frames, reduced to a small summary the
metric readers take. Nothing of the full trace is kept.

Summary keys:

    window_s      the profiled stretch on the host clock
    busy_s        the union of the device's intervals (kernels, copies, sets)
    frames, steps the frames and flow steps profiled
    device_ops    {name: [count, seconds]} of every device operation
    launch_calls  the host's kernel and graph launch API calls
    idle_gaps     [[label, seconds], ...] the device's idle time inside the
                  stretch, summed by the host operation in flight at each
                  gap's middle (the innermost one)
    counters      what the program counted over the stretch
    held_rows     the cells holding a packet, at the stretch's two ends
    n_packets, coupled, nx, interp, table_dtype, ray_method
"""
from __future__ import annotations

import heapq
import time

import torch

__all__ = ["LAUNCH_CALLS", "profile_frames", "summarize", "union_seconds", "label_gaps"]

# the host calls that put a kernel or a graph on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaLaunchCooperativeKernel")
WINDOW_MARK = "portbench.window"


def union_seconds(intervals) -> tuple[float, list]:
    """(total covered seconds, merged [start, end] list) of µs intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


def label_gaps(gaps, host) -> dict:
    """{label: seconds}: each gap (start, end) µs labelled by the innermost
    host operation (latest start) that spans its middle; ``host`` is
    [(start, end, name)]."""
    out: dict = {}
    host = sorted(host)
    heap: list = []
    i = 0
    for s, e in sorted(gaps, key=lambda g: g[0] + g[1]):
        m = 0.5 * (s + e)
        while i < len(host) and host[i][0] <= m:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < m:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "(no host operation)"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


def summarize(events, window) -> dict:
    """Reduce profiler events [(kind, name, start_us, end_us)] (kind 'cpu'
    or 'cuda') inside ``window`` = (start_us, end_us)."""
    w0, w1 = window
    dev, host, ops = [], [], {}
    n_launch = 0
    for kind, name, s, e in events:
        if e < w0 or s > w1:
            continue
        if kind == "cuda":
            s, e = max(s, w0), min(e, w1)
            dev.append((s, e))
            c = ops.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (e - s) / 1e6
        elif name != WINDOW_MARK:
            host.append((s, e, name))
            if name.startswith(LAUNCH_CALLS):
                n_launch += 1
    busy, merged = union_seconds(dev)
    gaps = [(a[1], b[0]) for a, b in zip(merged[:-1], merged[1:])]
    if merged:
        gaps = [(w0, merged[0][0])] + gaps + [(merged[-1][1], w1)]
    else:
        gaps = [(w0, w1)]
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy, device_ops=ops,
                launch_calls=n_launch,
                idle_gaps=sorted(label_gaps([g for g in gaps if g[1] > g[0]], host).items(),
                                 key=lambda kv: -kv[1]))


def _events(prof):
    """(kind, name, start_us, end_us) of every profiler event; the ranges
    that ``record_function`` marks on the device's timeline are no device
    work and are left out."""
    for e in prof.events():
        if e.device_type.name == "CUDA":
            if getattr(e, "is_user_annotation", False) or e.name == WINDOW_MARK:
                continue
            kind = "cuda"
        else:
            kind = "cpu"
        yield kind, e.name, float(e.time_range.start), float(e.time_range.end)


def profile_frames(run_frames, n_frames: int) -> dict:
    """Profile ``run_frames(n_frames)`` (which ends with the device idle)
    and reduce it; ``window_s`` is also timed on the host clock. Without a
    card (the CPU tests) only the host is traced."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW_MARK):
            t0 = time.perf_counter()
            run_frames(n_frames)
            if cuda:
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    events = list(_events(prof))
    marks = [(s, e) for kind, name, s, e in events if kind == "cpu" and name == WINDOW_MARK]
    if not marks:
        raise RuntimeError("the profile holds no window mark")
    summary = summarize(events, marks[0])
    summary["host_window_s"] = host_s
    return summary
