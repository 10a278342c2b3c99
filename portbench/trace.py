"""The traced run's reading of ``torch.profiler``: device intervals, the
device's busy and idle time over the traced window, and the breakdown.

Busy time is the union of the device's intervals (kernels, copies, sets)
inside the window, so overlapping items count once; an idle gap is labelled
by the innermost host span of the benchmark that was open when it began.
Every time here is in seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re


@contextlib.contextmanager
def profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield prof


def union(intervals: list) -> list:
    """Merged [(start, end)] of intervals, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    window: tuple  # (start, end) of the traced window
    device: list  # [(name, start, end)] of device items inside it
    spans: list  # [(name, start, end)] of the benchmark's host spans

    @classmethod
    def read(cls, prof, span_names: set) -> "Trace":
        """From a finished profiler: the window is the host span "window"."""
        from torch.autograd import DeviceType

        window, device, spans = None, [], []
        for ev in prof.events():
            s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
            if ev.device_type == DeviceType.CPU and ev.name in span_names:
                if ev.name == "window":
                    window = (s, e)
                else:
                    spans.append((ev.name, s, e))
            elif (ev.device_type != DeviceType.CPU and ev.name not in span_names
                  and not getattr(ev, "is_user_annotation", False)):
                device.append((ev.name, s, e))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = window
        device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
        return cls(window, device, spans)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in union([(s, e) for _, s, e in self.device]))

    def device_s(self, pattern: str | None = None, exclude: bool = False) -> float:
        """Summed seconds of the device items whose name matches ``pattern``
        (a regular expression; all items without one), or of the others with
        ``exclude``."""
        rx = None if pattern is None else re.compile(pattern)
        return sum(e - s for n, s, e in self.device
                   if rx is None or bool(rx.search(n)) != exclude)

    def count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, _, _ in self.device if rx.search(n))

    def idle_gaps(self) -> list:
        """[(host span open at the gap's start, seconds)] of every gap between
        the device's busy intervals in the window."""
        busy = union([(s, e) for _, s, e in self.device])
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted(self.spans, key=lambda x: x[1])
        out = []
        for g0, g1 in gaps:
            label = "between requests"
            for name, s, e in spans:
                if s > g0:
                    break
                if e > g0:
                    label = name  # the latest-opened span still open: the innermost
            out.append((label, g1 - g0))
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took the most time, and the idle
        time by the host span it began in (ten at most)."""
        ops, idle = {}, {}
        for n, s, e in self.device:
            ops[n] = ops.get(n, 0.0) + (e - s)
        for label, sec in self.idle_gaps():
            idle[label] = idle.get(label, 0.0) + sec
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
