"""Profiling and metrics (port of utils/profiling.py): the program's spans
and counters, the editor's Developer Metrics panel
(`EditorLayer.cpp:100-165`) and a torch.profiler exporter.

- `span(name)`: a named interval of host time. It is on while a
  torch.profiler is recording or inside `recording()`; otherwise it is
  one shared no-op object returned after a single flag check. An on span
  goes into a bounded in-memory table (`spans()`, `span_totals()`,
  `clear()`) with its start and end (`time.perf_counter_ns`), its parent
  on the same thread and the id of the frame or step that holds it (the
  outermost `drt.frame` or `drt.step` span). Under a profiler it also
  enters `record_function(name)`, so it sits on the profiler's timeline
  with the card's kernels.
- `chain(name)`: a span with no `with` block, that runs until the next
  `chain()`, `end_chain()` or the end of its parent; `mark_backward`'s
  gradient hooks open one where the backward reaches a tensor, and so
  cut the backward into segments, the last of which ends with the
  backward.
- `count(name, n)`: a host counter, always on. `count_device(name, t)`:
  adds a device scalar into a device accumulator while spans are on,
  with no host wait. `device_timer(name, device)`: while spans are on,
  CUDA events on the card's current stream around a block, with no host
  wait. `counters()` reads all three (the timers as the ms between their
  events, summed), `host_counters()` the host's alone.
- `muted()`: spans and device counters off over a block, even under a
  profiler (a CUDA graph's capture, so that no hook or count is baked
  into the graph).
- `FrameStats`: running min/avg/max render rate, like the editor panel.
- `trace(log_dir)`: torch.profiler and `recording()` over a block;
  writes `trace.json` (Chrome trace) and `spans.json`.

Every span and counter name starts with `drt.`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _prof

MAX_SPANS = 1 << 18  # spans the table holds; older ones are dropped
UNITS = ("drt.frame", "drt.step")  # spans whose outermost one sets the id


class _Off:
    """The span returned when spans are off: enters and leaves at once."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording = 0      # depth of recording() blocks
_muted = 0          # depth of muted() blocks
# the table, the drops, the ids and the open frame or step: a span's
# backward children run on autograd's thread
_lock = threading.Lock()
_table = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_seq = 0            # span ids
_unit_seq = 0       # frame or step ids
_unit = None        # id of the frame or step open now
_chained = None     # the open chain() span, or None
_local = threading.local()
_host = {}          # host counters
_device = {}        # device counters: name -> {device: accumulator}
_timed = {}         # device timers: name -> [(start event, end event)]


def enabled() -> bool:
    """Whether spans are on: a torch.profiler is recording, or a
    recording() block is open, and no muted() block is."""
    return bool((_prof._is_profiler_enabled or _recording) and not _muted)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "sid", "parent", "unit", "t0", "rf", "stack",
                 "tid", "outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self._open(None)

    def _open(self, t0):
        """Open the span at t0 (now where None)."""
        global _seq, _unit_seq, _unit
        stack = _stack()
        self.stack = stack
        self.tid = threading.get_ident()
        self.parent = stack[-1].sid if stack else None
        with _lock:
            _seq += 1
            self.sid = _seq
            self.outer = self.name in UNITS and _unit is None
            if self.outer:
                _unit_seq += 1
                _unit = _unit_seq
            self.unit = _unit
        # the span's own record_function lies inside it, so that its
        # cost is no part of its parent's self time
        self.t0 = time.perf_counter_ns() if t0 is None else t0
        self.rf = None
        if _prof._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        stack = self.stack
        # spans left open above this one (a chain) end with it
        while stack and stack[-1] is not self:
            _close(stack[-1])
        if stack:
            stack.pop()
        _finish(self)
        return False


def _finish(s: _Span, t1: int | None = None) -> None:
    """Record s, ended at t1 (now, after its record_function, where
    None)."""
    global _dropped, _unit
    if s.rf is not None:
        s.rf.__exit__(None, None, None)
    if t1 is None:
        t1 = time.perf_counter_ns()
    with _lock:
        if len(_table) == _table.maxlen:
            _dropped += 1
        _table.append((s.name, s.t0, t1, s.sid, s.parent, s.unit, s.tid))
        if s.outer:
            _unit = None


def _close(s: _Span, t1: int | None = None) -> None:
    """End an open span that is no `with` block (a chain)."""
    global _chained
    if s in s.stack:
        s.stack.remove(s)
    if _chained is s:
        _chained = None
    _finish(s, t1)


def span(name: str):
    """A context manager that records `name` while spans are on, and the
    shared no-op object otherwise."""
    if not enabled():
        return _OFF
    return _Span(name)


def chain(name: str) -> None:
    """End the open chain span and open `name` on this thread, unless
    `name` is the one open. Returns None, so it can be a gradient hook's
    body. Nothing while spans are off."""
    global _chained
    if not enabled():
        return None
    if _chained is not None and _chained.name == name:
        return None
    t = time.perf_counter_ns()
    if _chained is not None:
        _close(_chained, t)
    _chained = _Span(name)._open(t)
    return None


def end_chain() -> None:
    """End the open chain span, if any."""
    if _chained is not None:
        _close(_chained)


def mark_backward(name: str, *tensors) -> None:
    """While spans are on, a gradient hook on each of `tensors` that
    requires grad opens the chain span `name` when the backward reaches
    it; the hook returns None, so the gradient is untouched. The hook
    queues end_chain for the backward's end, so no chain outlives its
    backward (or the profiler that recorded it)."""
    if not enabled():
        return

    def hook(_grad):
        torch.autograd.Variable._execution_engine.queue_callback(end_chain)
        chain(name)

    for t in tensors:
        if t.requires_grad:
            t.register_hook(hook)


@contextlib.contextmanager
def muted():
    """Spans, chains, gradient hooks, device counters and timers off over
    the block, whatever records; host counters stay on."""
    global _muted
    _muted += 1
    try:
        yield
    finally:
        _muted -= 1


@contextlib.contextmanager
def recording():
    """Spans on over the block, with no profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The table's spans, oldest first: dicts of name, start_ns, end_ns,
    id, parent (id or None), unit (frame or step id, or None), thread."""
    keys = ("name", "start_ns", "end_ns", "id", "parent", "unit", "thread")
    return [dict(zip(keys, row)) for row in list(_table)]


def dropped() -> int:
    """Spans dropped from the full table since the last clear()."""
    return _dropped


def span_totals(rows=None) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} over the table (or over
    `rows`, as spans() gives them). Self time is the duration less the
    durations of the span's children, which run on its thread."""
    rows = spans() if rows is None else rows
    child_ns = collections.defaultdict(int)
    for r in rows:
        if r["parent"] is not None:
            child_ns[r["parent"]] += r["end_ns"] - r["start_ns"]
    out = {}
    for r in rows:
        dur = r["end_ns"] - r["start_ns"]
        t = out.setdefault(r["name"], {"count": 0, "total_ms": 0.0,
                                       "self_ms": 0.0})
        t["count"] += 1
        t["total_ms"] += dur * 1e-6
        t["self_ms"] += (dur - child_ns.get(r["id"], 0)) * 1e-6
    return out


def count(name: str, n: int = 1) -> None:
    """Add n to the host counter `name`."""
    _host[name] = _host.get(name, 0) + n


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the device scalar `value` into the device counter `name`, while
    spans are on. The sum stays on value's device: no host wait."""
    if not enabled():
        return
    accs = _device.setdefault(name, {})
    acc = accs.get(value.device)
    if acc is None:
        # a plain tensor, so that it can be added to in and out of
        # inference_mode
        with torch.inference_mode(False):
            acc = torch.zeros((), dtype=value.dtype, device=value.device)
        accs[value.device] = acc
    acc.add_(value.detach())


class _Timer:
    """CUDA events on the current stream around a block."""

    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _timed.setdefault(self.name, []).append((self.start, end))
        return False


def device_timer(name: str | None, device):
    """While spans are on and `device` is a card (the current one, in the
    block): CUDA events on its current stream around the block, whose
    elapsed ms counters() adds into the counter `name` (a host wait at
    read time, none here). The shared no-op otherwise, and where `name`
    is None."""
    if name is None or not enabled() or \
            torch.device(device).type != "cuda":
        return _OFF
    return _Timer(name)


def host_counters(prefix: str = "drt.") -> dict:
    """The host counters whose name starts with `prefix` (no host wait)."""
    return {k: v for k, v in _host.items() if k.startswith(prefix)}


def counters(prefix: str = "drt.") -> dict:
    """The counters whose name starts with `prefix`: host counters, and
    device counters and timers read back (a host wait where there are
    any)."""
    out = host_counters(prefix)
    for k, accs in _device.items():
        if k.startswith(prefix):
            out[k] = sum(a.item() for a in accs.values())
    for k, pairs in _timed.items():
        if k.startswith(prefix):
            for _, end in pairs:
                end.synchronize()
            out[k] = sum(s.elapsed_time(e) for s, e in pairs)
    return out


def clear() -> None:
    """Empty the span table and reset every counter."""
    global _dropped
    end_chain()
    with _lock:
        _table.clear()
        _dropped = 0
    _host.clear()
    _device.clear()
    _timed.clear()


def device_ops(prof) -> list:
    """The device operations (kernels, copies, fills) of a finished
    torch.profiler: its CUDA events less the annotations that
    record_function, and so every span, puts on the device's timeline."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@dataclass
class FrameStats:
    """min/avg/max frequency tracker (`EditorLayer.cpp:135-163`)."""

    min_ms: float = float("inf")
    max_ms: float = 0.0
    total_ms: float = 0.0
    frames: int = 0
    _last: float = field(default=0.0, repr=False)

    def begin(self):
        self._last = time.perf_counter()

    def end(self):
        ms = (time.perf_counter() - self._last) * 1e3
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)
        self.total_ms += ms
        self.frames += 1
        return ms

    @property
    def avg_ms(self):
        return self.total_ms / max(self.frames, 1)

    def report(self) -> dict:
        avg = self.avg_ms
        return {
            "frames": self.frames,
            "ms_min": round(self.min_ms, 3) if self.frames else None,
            "ms_avg": round(avg, 3),
            "ms_max": round(self.max_ms, 3),
            "hz_max": round(1000.0 / self.min_ms, 2) if self.frames else None,
            "hz_avg": round(1000.0 / avg, 2) if avg else None,
            "hz_min": round(1000.0 / self.max_ms, 2) if self.max_ms else None,
        }


@contextlib.contextmanager
def trace(log_dir: str = "drt_trace"):
    """torch.profiler (CPU, and the card's kernels when there is one) and
    recording() over the block; writes `log_dir/trace.json`
    (chrome://tracing, Perfetto) and `log_dir/spans.json` (the block's
    spans, their totals and the counters) when the block ends, and
    yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = _seq + 1
    with recording(), torch.profiler.profile(activities=activities) as prof:
        yield prof
    end_chain()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    rows = [r for r in spans() if r["id"] >= first]
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump({"spans": rows, "totals": span_totals(rows),
                   "counters": counters(), "dropped": _dropped}, fh)
