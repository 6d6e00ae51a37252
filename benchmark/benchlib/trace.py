"""Reading a ``torch.profiler`` trace of the measured window.

The harness marks the window (``bench.window``) and its calls into each
layer (``bench.embed``, ``bench.search``, ``bench.append``) with
``record_function``. From the trace this module takes the device's busy
time (the union of its kernel and copy intervals: 1 - busy / wall is the
idle share), the device time inside each kind of span, the device
operations that took most time, and the idle gaps by what the host was
doing meanwhile.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from torch.autograd import DeviceType

SPAN = "bench."
WINDOW = "bench.window"
TOP = 10
NAME_CHARS = 160  # a kernel's name is its C++ signature; its start names it


def union(intervals) -> list[tuple[float, float]]:
    """Sorted disjoint intervals covering ``intervals``."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def overlap(a, b) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class Trace:
    window_s: float
    busy_s: float
    span_device_s: dict = field(default_factory=dict)  # span kind -> device s inside it
    device_ops: list = field(default_factory=list)  # [[name, s], ...] largest first
    idle_gaps: list = field(default_factory=list)  # [[host activity, s], ...] largest first


def _innermost(cpu, gaps):
    """For each gap (mid, seconds), the harness span and the innermost host
    event open at its midpoint, by one sweep over nested events."""
    stack: list = []
    i = 0
    out = defaultdict(float)
    for mid, secs in sorted(gaps):
        while i < len(cpu) and cpu[i][0] <= mid:
            while stack and stack[-1][1] < cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        spans = [name for _, _, name in stack if name.startswith(SPAN) and name != WINDOW]
        span = spans[-1][len(SPAN):] if spans else "between calls"
        inner = stack[-1][2] if stack else ""
        what = "host" if not inner or inner.startswith(SPAN) else inner
        out[f"{span}: {what}"] += secs
    return out


def read(prof) -> Trace:
    """The trace of ``prof`` (times in ns, as the profiler records them;
    read from its raw events, which a traced window holds by the million)."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w = window[0]
    w0, main = w.start_ns(), w.start_thread_id()
    w1 = w0 + w.duration_ns()
    device = []
    by_name = defaultdict(float)
    spans = defaultdict(list)
    cpu = []
    for e in events:
        name = e.name()
        lo = e.start_ns()
        hi = lo + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.start_thread_id() == main:
                cpu.append((lo, hi, name))
            if name.startswith(SPAN) and name != WINDOW:
                spans[name[len(SPAN):]].append((lo, hi))
        elif not name.startswith(SPAN) and not e.is_user_annotation():
            lo, hi = max(lo, w0), min(hi, w1)
            if hi > lo:
                device.append((lo, hi))
                by_name[name] += hi - lo
    busy = union(device)
    gaps = []
    edge = w0
    for lo, hi in busy + [(w1, w1)]:
        if lo > edge:
            gaps.append(((lo + edge) / 2, (lo - edge) / 1e9))
        edge = max(edge, hi)
    cpu.sort(key=lambda ev: (ev[0], -ev[1]))  # a parent before the child it starts with
    idle = _innermost(cpu, gaps)
    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(hi - lo for lo, hi in busy) / 1e9,
        span_device_s={k: overlap(busy, union(v)) / 1e9 for k, v in spans.items()},
        device_ops=[[n[:NAME_CHARS], ns / 1e9]
                    for n, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
    )
