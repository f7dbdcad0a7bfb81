"""A ``torch.profiler`` trace reduced to what the per-layer metrics read.

Busy time is the union of the device operations' intervals (kernels,
copies and fills), so operations that overlap count once; the idle share
is one minus busy time over the traced window.  Each idle gap between
device operations is put down to the innermost host operation running at
its middle (on the thread that issued most host operations), or to
"(python, between ops)" where none was.
"""
from __future__ import annotations

import collections
import dataclasses

BETWEEN_OPS = "(python, between ops)"
TOP = 10
NAME_CHARS = 160   # a breakdown's names are cut to this (grouped whole)


@dataclasses.dataclass(frozen=True)
class Span:
    start: float   # seconds, on the trace's clock
    end: float
    name: str


@dataclasses.dataclass(frozen=True)
class Summary:
    window_s: float
    busy_s: float
    device_ops: int
    top_ops: list        # [[name, seconds], ...] by summed device time
    idle_gaps: list      # [[host op, seconds], ...] by summed gap time

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def merged(spans) -> list[tuple[float, float]]:
    """The union of the spans' intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return [(a, b) for a, b in out]


def _innermost(host: list[Span], points: list[float]) -> list[str]:
    """For each sorted point, the name of the latest-started host span
    that contains it (host spans of one thread nest), else BETWEEN_OPS."""
    host = sorted(host, key=lambda s: (s.start, -s.end))
    names, stack, k = [], [], 0
    for p in points:
        while k < len(host) and host[k].start <= p:
            while stack and stack[-1].end <= host[k].start:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1].end < p:
            stack.pop()
        names.append(stack[-1].name if stack else BETWEEN_OPS)
    return names


def summarize(device: list[Span], host: list[Span],
              window_s: float) -> Summary:
    busy = merged(device)
    busy_s = sum(b - a for a, b in busy)
    by_name = collections.Counter()
    for s in device:
        by_name[s.name] += s.end - s.start
    gaps = [(a1, b0) for (_, a1), (b0, _) in zip(busy, busy[1:]) if b0 > a1]
    mids = [(a + b) / 2 for a, b in gaps]
    idle = collections.Counter()
    for (a, b), name in zip(gaps, _innermost(host, mids)):
        idle[name] += b - a
    return Summary(window_s=window_s, busy_s=busy_s, device_ops=len(device),
                   top_ops=[[k[:NAME_CHARS], v]
                            for k, v in by_name.most_common(TOP)],
                   idle_gaps=[[k, v] for k, v in idle.most_common(TOP)])


def spans(prof) -> tuple[list[Span], list[Span]]:
    """``(device, host)`` spans of a finished ``torch.profiler.profile``:
    device operations, and host operations of its busiest thread."""
    device, host = [], collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        s = Span(start, start + e.duration_ns() * 1e-9, e.name())
        if "CPU" in str(e.device_type()):
            host[e.start_thread_id()].append(s)
        elif e.duration_ns() > 0:
            device.append(s)
    busiest = max(host.values(), key=len) if host else []
    return device, busiest

