"""Reduction of a ``torch.profiler`` trace to device busy time, kernel counts and a breakdown.

Busy time is the union of the intervals in which a device operation (kernel,
copy or set) ran, not the sum of their durations. An idle gap is a stretch of
the timeline between two busy stretches; it is named by what the host was
doing at its middle: the CUDA runtime or driver call in progress there, or
none (the host was running Python or the library's own code).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import numpy as np

TOP = 10  # entries of each breakdown list
NAME_CHARS = 120


def kineto_events(prof) -> tuple[list, list]:
    """``(device ops [(name, kind, start_ns, dur_ns)], host runtime calls [(name, start_ns, dur_ns)])``."""
    from torch.autograd import DeviceType

    device, runtime = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else ""
        if e.device_type() == DeviceType.CUDA:
            if "memcpy" in kind or "memset" in kind:
                device.append((e.name(), "copy", e.start_ns(), e.duration_ns()))
            else:
                device.append((e.name(), "kernel", e.start_ns(), e.duration_ns()))
        elif "runtime" in kind or "driver" in kind or e.name().startswith("cu"):
            runtime.append((e.name(), e.start_ns(), e.duration_ns()))
    return device, runtime


def _segments(events):
    """Busy stretches ``(starts_ns, ends_ns)`` of the union of the events' intervals."""
    if not events:
        return np.zeros(0), np.zeros(0)
    s = np.array([e[2] for e in events], np.float64)
    e = s + np.array([x[3] for x in events], np.float64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    cm = np.maximum.accumulate(e)
    new = np.r_[True, s[1:] > cm[:-1]]
    starts = s[new]
    idx = np.flatnonzero(new)
    ends = np.maximum.reduceat(e, idx)
    ends = np.maximum.accumulate(ends)
    return starts, ends


def reduce(obs: dict) -> dict:
    """``busy_s``, ``window_s``, ``kernels``, device seconds by op name, and the breakdown."""
    events, runtime, window_s = obs["events"], obs["runtime"], obs["window_s"]
    starts, ends = _segments(events)
    busy_s = float((ends - starts).sum()) * 1e-9
    by_name = defaultdict(float)
    for name, _, _, dur in events:
        by_name[name] += dur * 1e-9
    device_ops = sorted(([n[:NAME_CHARS], v] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]
    runtime = sorted(runtime, key=lambda r: r[1])
    rt_starts = [r[1] for r in runtime]
    gaps = defaultdict(float)
    for a, b in zip(ends[:-1], starts[1:]):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(rt_starts, mid) - 1
        if k >= 0 and runtime[k][1] + runtime[k][2] >= mid:
            name = f"host in {runtime[k][0]}"
        else:
            name = "host outside the CUDA runtime"
        gaps[name[:NAME_CHARS]] += float(b - a) * 1e-9
    if len(starts):
        edges = window_s - float(ends[-1] - starts[0]) * 1e-9
        if edges > 0:
            gaps["before the first and after the last device op"] += edges
    idle_gaps = sorted(([n, v] for n, v in gaps.items()), key=lambda x: -x[1])[:TOP]
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": sum(1 for e in events if e[1] == "kernel"),
        "device_s_by_name": dict(by_name),
        "breakdown": {"device_ops": device_ops, "idle_gaps": idle_gaps},
    }
