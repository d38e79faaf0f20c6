"""The traced segment of a `--trace 1` run: `torch.profiler` (CUPTI) over
a fixed number of ticks, read into device intervals and host spans.

The chrome trace is written under TMPDIR and deleted once read.  Device
time is the union of the kernels', copies' and fills' intervals inside
the segment, which the harness marks with the span `bench.window`.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
WINDOW_SPAN = "bench.window"


class Event(NamedTuple):
    name: str
    ts: float    # us, the trace's clock
    dur: float   # us
    cat: str


class Trace:
    """Device and host events of one traced segment of `ticks` ticks."""

    def __init__(self, events: list, ticks: int):
        self.ticks = ticks
        span = [e for e in events if e.get("name") == WINDOW_SPAN
                and e.get("cat") == "user_annotation"]
        if not span:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        self.t0 = float(span[0]["ts"])
        self.t1 = self.t0 + float(span[0]["dur"])
        pick = lambda cats: sorted(  # noqa: E731
            (Event(e["name"], float(e["ts"]), float(e["dur"]), e["cat"])
             for e in events if e.get("cat") in cats and "dur" in e
             and self.t0 <= float(e["ts"]) <= self.t1),
            key=lambda e: e.ts)
        self.device = pick(DEVICE_CATS)
        self.kernels = [e for e in self.device if e.cat == "kernel"]
        self.host = [e for e in pick(HOST_CATS) if e.name != WINDOW_SPAN]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, clipped to the
        segment, as sorted disjoint (start, end) pairs in us."""
        out = []
        for e in self.device:
            a, b = e.ts, min(e.ts + e.dur, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_share(self, window: dict):
        """The device's idle share of the untraced window, %: 1 - the
        traced busy time a tick over the window's seconds a tick (the
        profiler slows the host's issue, so the traced segment's own
        idle share reads high)."""
        if not self.device or not window["ticks"]:
            return None
        per_tick = window["seconds"] / window["ticks"]
        return 100.0 * (1.0 - self.busy_s / self.ticks / per_tick)

    def kernels_named(self, stem: str) -> list:
        """The kernel events of the port's `<stem>_kernel`."""
        pat = re.compile(r"\b%s_kernel\b" % re.escape(stem))
        return [e for e in self.kernels if pat.search(e.name)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, by name, and
        the longest idle gaps of the device, each named by the innermost
        host span open at its middle."""
        total: dict = {}
        for e in self.device:
            key = short_name(e.name)
            total[key] = total.get(key, 0.0) + e.dur * 1e-6
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [e.ts for e in self.host]
        named = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            name = "host: no span open"
            # the innermost span open at mid: the latest-starting one
            # among those that started before it and have not ended
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                e = self.host[i]
                if e.ts + e.dur >= mid:
                    name = "host: " + short_name(e.name)
                    break
            named.append([name, (b - a) * 1e-6])
        return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=named)


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's or span's name without its parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:limit] or name[:limit]


def record(run_ticks, ticks: int, sync) -> Trace:
    """Trace `run_ticks()` (which runs `ticks` ticks) inside the span
    `bench.window`, closed by `sync()`; the chrome trace goes to TMPDIR
    and is deleted after it is read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            run_ticks()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return Trace(events, ticks)
