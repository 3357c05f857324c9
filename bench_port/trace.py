"""The traced run's reading of the device: a torch.profiler slice of
whole frames or steps, and the host waits of another slice.

A slice is profiled with CPU and CUDA activities, each unit inside a
`bench:<unit>` record_function span (the loops add `bench.<part>` spans
inside it). From its events: the device
operations (kernels, copies, fills) with their times, the union of their
intervals (busy), the span of the units (window), the device operations
by total time, and the idle time between device operations by what the
host was doing: each gap is named by the innermost bench span and the
innermost host op around its middle ("host" where no op holds it:
Python between ops), and the seconds are summed by name. The profiler has
lost every device event of a process before: a slice without device
events is profiled again, up to TRIES times, and then the run fails."""

from __future__ import annotations

import bisect
import contextlib
import warnings
from collections import defaultdict

import torch

TRIES = 3
TOP = 10


def profile_units(unit, n: int, name: str) -> dict:
    """Run unit() n times under the profiler; return the slice's
    reading. Raises when no try shows a device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                with record_function(f"bench:{name}"):
                    unit()
        dev, host = [], []
        for e in prof.events():
            rng = (e.time_range.start, e.time_range.end, e.name)
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                # a record_function span also shows on the device's
                # timeline; it is no device operation
                if not getattr(e, "is_user_annotation", False):
                    dev.append(rng)
            else:
                host.append(rng)
        if dev:
            return reading(dev, host, n)
    raise RuntimeError(f"torch.profiler saw no device event in {TRIES} "
                       f"slices of {n} {name} units")


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reading(dev, host, n: int) -> dict:
    """Busy and window seconds, device ops and named idle gaps of a slice;
    times of (start_us, end_us, name) events."""
    units = [(s, e) for s, e, nm in host if nm.startswith("bench:")]
    w0 = min(s for s, _ in units)
    w1 = max(e for _, e in units)
    dev = [(max(s, w0), min(e, w1), nm) for s, e, nm in dev
           if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in dev])
    by_op = defaultdict(float)
    for s, e, nm in dev:
        by_op[nm] += (e - s) * 1e-6
    gaps, edge = [], w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if w1 > edge:
        gaps.append((edge, w1))
    span_at = _innermost([h for h in host if h[2].startswith("bench")])
    op_at = _innermost([h for h in host if not h[2].startswith("bench")])
    by_gap = defaultdict(float)
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        name = f"{span_at(mid) or 'outside'}:{op_at(mid) or 'host'}"
        by_gap[name] += (ge - gs) * 1e-6
    return {
        "units": n,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": [(nm, (e - s) * 1e-6) for s, e, nm in dev],
        "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP],
    }


def _innermost(events):
    """A function of a time t: the name of the innermost of `events`
    ((start, end, name), nested as host ops are) that holds t, or None."""
    events = sorted(events, key=lambda ev: (ev[0], -ev[1]))
    starts = [ev[0] for ev in events]
    parent, stack = [], []
    for i, (s, _, _) in enumerate(events):
        while stack and events[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and events[i][1] < t:
            i = parent[i]
        return events[i][2] if i >= 0 else None
    return at


def count_waits(unit, n: int) -> int:
    """Host waits for the card in n calls of unit(): the synchronizing
    CUDA operations that torch.cuda.set_sync_debug_mode("warn") reports.
    unit() turns the mode on around the program's calls only
    (`waits_on`), so the harness's own synchronize is not counted."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(n):
            unit()
    return sum("synchroniz" in str(w.message) for w in caught)


def span(name: str, on: bool):
    """A `bench.<name>` record_function span where `on`, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"bench.{name}")


class waits_on:
    """Context that reports synchronizing CUDA operations as warnings."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("warn")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
