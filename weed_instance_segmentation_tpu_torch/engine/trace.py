"""The program's spans and counters, and its profiler captures.

Port of ``weed_instance_segmentation_tpu/engine/trace.py``. That module
reads the device's busy share from a ``jax.profiler`` capture; here
:func:`device_busy_fraction` reads it from a ``torch.profiler`` Chrome
trace. Besides, this is the port's one recorder of its own spans and
counters:

- :func:`span` (a context manager) appends ``(name, id, parent, thread,
  start_ns, end_ns, events)`` to a bounded in-memory ring on exit, and
  counts the spans the ring dropped (:func:`dropped`). ``parent`` is the
  name of the span open around it on its thread; a span without an ``id``
  takes its parent's, so every span of one request or micro-step shares
  the root's. While a ``torch.profiler`` runs, the span also opens the
  ``record_function`` range of its name, so the trace's ranges are the
  spans; with no profiler running it opens none (a range costs several µs
  even then, and under ``torch.export`` none reaches the graph). A span
  given a CUDA ``device`` also records a pair of timing events on its
  edges, read only when asked (:func:`device_ms`), never waited for.
- :func:`count` is the one counter, :func:`counter` reads it and
  :func:`counters` every counter of a prefix.
- :func:`totals` sums each name's spans since the start of the process
  (count and seconds); it drops nothing.
- Stamps are ``time.perf_counter_ns``, the clock a caller times a window
  with: :func:`spans` selects the spans inside such a window.
- :func:`export_chrome` writes the ring as Chrome-trace events; on a
  profile's time base (:class:`Clock`, measured while the profile runs)
  they lie on the profiler's ranges, so every idle gap of a device trace
  lies under the span the host was in. :func:`start_profile` /
  :func:`stop_profile` take such a profile (``trace.json``) and write the
  spans beside it (``spans.json``).

The recorder is on from import: it is bounded, costs a few tenths of a µs
a span and runs on the host. :func:`enable` turns it off and on again.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

RING_SPANS = 1 << 16  # a 30 s window of training or serving records under 5,000
CLOCK_MARK = 'trace.clock'  # the range that ties the profiler's clock to the spans'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')

_now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    id: int | None
    parent: str | None
    thread: int
    start_ns: int
    end_ns: int
    events: tuple | None  # (start, end) torch.cuda.Event, or None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _State:
    """One thread's open spans, and what it appended (summed over threads
    on reading, so no thread updates another's)."""

    __slots__ = ('stack', 'thread', 'appended', 'totals', 'counts')

    def __init__(self):
        self.stack = []
        self.thread = threading.get_native_id()
        self.appended = 0
        self.totals = {}  # name → [count, ns]
        self.counts = {}


class _Thread(threading.local):
    def __init__(self, registry: list):
        self.s = _State()
        registry.append(self.s)


def _event(device: torch.device) -> torch.cuda.Event | None:
    if device.type != 'cuda':
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class _Open:
    """One span while it is open (:meth:`Recorder.span`)."""

    __slots__ = ('rec', 'name', 'id', 'device', 'parent', 'local', 'start', 'range', 'first')

    def __init__(self, rec: Recorder, name: str, id: int | None, device):
        self.rec, self.name, self.id, self.device = rec, name, id, device

    def __enter__(self):
        self.start = None
        if self.rec.on:
            self.local = local = self.rec.local.s
            stack = local.stack
            if stack:
                self.parent, parent_id = stack[-1]
                if self.id is None:
                    self.id = parent_id
            else:
                self.parent = None
            stack.append((self.name, self.id))
            self.first = None if self.device is None else _event(self.device)
            self.start = _now()
        # the range opens after the stamp, as it closes after the end stamp:
        # the operator that opens it releases the interpreter lock, and
        # another thread that takes it then delays the return, not the stamp
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            end = _now()
            local = self.local
            local.stack.pop()
            events = None if self.first is None else (self.first, _event(self.device))
            self.rec.ring.append((self.name, self.id, self.parent, local.thread, self.start, end,
                                  events))
            local.appended += 1
            total = local.totals.get(self.name)
            if total is None:
                local.totals[self.name] = [1, end - self.start]
            else:
                total[0] += 1
                total[1] += end - self.start
        if self.range is not None:
            self.range.__exit__(None, None, None)
        return False


class Recorder:
    """A ring of at most ``capacity`` spans, the counters, and each name's
    span totals. The module's functions use one for the process."""

    def __init__(self, capacity: int = RING_SPANS):
        self.ring = collections.deque(maxlen=capacity)
        self.threads = []
        self.local = _Thread(self.threads)
        self.on = True

    def span(self, name: str, id: int | None = None,
             device: torch.device | None = None) -> _Open:
        """A span named ``name`` over the ``with`` block; ``id`` (else the
        parent's) ties it to a request or micro-step; a CUDA ``device``
        adds the pair of timing events on that device's current stream."""
        return _Open(self, name, id, device)

    def count(self, name: str, n: int = 1) -> None:
        counts = self.local.s.counts
        counts[name] = counts.get(name, 0) + n

    def counter(self, name: str) -> int:
        return sum(t.counts.get(name, 0) for t in list(self.threads))

    def counters(self, prefix: str = '') -> dict:
        """{name: count} of every counter whose name starts with ``prefix``."""
        out = {}
        for t in list(self.threads):
            for name, n in list(t.counts.items()):
                if name.startswith(prefix):
                    out[name] = out.get(name, 0) + n
        return out

    def totals(self) -> dict:
        """{name: (spans, seconds)} of every span recorded so far."""
        out = {}
        for t in list(self.threads):
            for name, (n, ns) in list(t.totals.items()):
                have = out.get(name, (0, 0))
                out[name] = (have[0] + n, have[1] + ns)
        return {name: (n, ns / 1e9) for name, (n, ns) in out.items()}

    def dropped(self) -> int:
        return sum(t.appended for t in list(self.threads)) - len(self.ring)

    def spans(self, start_s: float | None = None, end_s: float | None = None) -> list:
        """The spans in the ring that lie inside [``start_s``, ``end_s``]
        (``time.perf_counter`` seconds; either open), oldest end first."""
        lo = -1 if start_s is None else start_s * 1e9
        hi = float('inf') if end_s is None else end_s * 1e9
        return [Span(*r) for r in list(self.ring) if r[4] >= lo and r[5] <= hi]


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
counter = RECORDER.counter
counters = RECORDER.counters
totals = RECORDER.totals
dropped = RECORDER.dropped
spans = RECORDER.spans


def enable(on: bool = True) -> None:
    """Turn the recording of spans on or off (the ranges a running
    profiler asks for are opened either way; counters always count)."""
    RECORDER.on = bool(on)


def device_ms(s: Span) -> float | None:
    """Device ms between the span's two timing events, or None where it
    has none or the device has not reached the second yet."""
    if s.events is None or not s.events[1].query():
        return None
    return s.events[0].elapsed_time(s.events[1])


# ---------------------------------------------------------------- Chrome traces


class Clock(NamedTuple):
    """A profiler trace's time base (``baseTimeNanoseconds``) and pairs of
    (``perf_counter_ns``, profiler ns) read together, which map a span's
    stamp onto the trace's µs ``ts``."""

    base_ns: int
    points: tuple

    def ts_us(self, perf_ns: int) -> float:
        (p0, q0), (p1, q1) = self.points[0], self.points[-1]
        slope = (q1 - q0) / (p1 - p0) if p1 > p0 else 1.0
        return (q0 + (perf_ns - p0) * slope - self.base_ns) / 1e3


def mark_clock() -> int:
    """Open a :data:`CLOCK_MARK` range and return the ``perf_counter_ns``
    of its middle: in a profile, :func:`clock_of` pairs the two."""
    a = _now()
    with _profiler.record_function(CLOCK_MARK):
        pass
    return (a + _now()) // 2


def clock_of(trace: dict, marks: list) -> Clock:
    """The :class:`Clock` of a profiler trace (its Chrome-trace dict) whose
    :data:`CLOCK_MARK` ranges were opened by :func:`mark_clock` calls that
    returned ``marks``, in order."""
    base = int(trace.get('baseTimeNanoseconds', 0))
    ranges = sorted(e['ts'] + e['dur'] / 2 for e in trace['traceEvents']
                    if e.get('ph') == 'X' and e.get('name') == CLOCK_MARK)
    if len(ranges) != len(marks):
        raise ValueError(f'{len(ranges)} {CLOCK_MARK} ranges in the trace for {len(marks)} marks')
    return Clock(base, tuple((m, base + round(1e3 * ts)) for m, ts in zip(marks, ranges)))


def export_chrome(path: str, clock: Clock | None = None) -> None:
    """Write the ring as Chrome-trace ``X`` events (category
    ``program_span``, on the recording thread's id, ``args`` the span's id,
    parent and device ms). On ``clock``'s time base they lie on the ranges
    of that profiler trace; without one, ``ts`` is ``perf_counter`` µs."""
    clock = clock or Clock(0, ((0, 0), (1, 1)))
    pid = os.getpid()
    events = []
    for s in RECORDER.spans():
        ts = clock.ts_us(s.start_ns)
        args = {'id': s.id, 'parent': s.parent}
        ms = device_ms(s)
        if ms is not None:
            args['device_ms'] = ms
        events.append({'ph': 'X', 'cat': 'program_span', 'name': s.name, 'pid': pid,
                       'tid': s.thread, 'ts': ts, 'dur': clock.ts_us(s.end_ns) - ts,
                       'args': args})
    with open(path, 'w') as f:
        json.dump({'traceEvents': events, 'baseTimeNanoseconds': clock.base_ns,
                   'displayTimeUnit': 'ms'}, f)


# ---------------------------------------------------------------- profiles


class Profile:
    """A running ``torch.profiler`` capture of the host (and of the device
    on CUDA), with the clock marks taken at its two ends."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.marks = []


def start_profile(device: torch.device) -> Profile:
    profile = Profile(device)
    profile.prof.start()
    profile.marks.append(mark_clock())
    return profile


def stop_profile(profile: Profile, profile_dir: str) -> float | None:
    """Stop ``profile``, write its trace (``trace.json``) and the ring on
    its time base (``spans.json``) into ``profile_dir``; return the
    device's busy share over the trace (:func:`device_busy_fraction`)."""
    if profile.device.type == 'cuda':
        torch.cuda.synchronize(profile.device)
    profile.marks.append(mark_clock())
    profile.prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, 'trace.json')
    profile.prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    export_chrome(os.path.join(profile_dir, 'spans.json'), clock_of(trace, profile.marks))
    print(f'\tProfiler trace written to {path}, the program spans beside it')
    return busy_fraction(trace['traceEvents'])


def busy_fraction(events: list) -> float | None:
    """The share of the events' span in which the device ran a kernel, copy
    or fill (their intervals merged); None if they hold no device work."""
    xs = [e for e in events if e.get('ph') == 'X']
    device = sorted((e['ts'], e['ts'] + e['dur']) for e in xs if e.get('cat') in DEVICE_CATS)
    if not device:
        return None
    busy, end = 0.0, -float('inf')
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    span_us = max(e['ts'] + e['dur'] for e in xs) - min(e['ts'] for e in xs)
    return busy / span_us if span_us > 0 else None


def device_busy_fraction(trace_path: str) -> float | None:
    """:func:`busy_fraction` of a Chrome trace file."""
    with open(trace_path) as f:
        return busy_fraction(json.load(f)['traceEvents'])
