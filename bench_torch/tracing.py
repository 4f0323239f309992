"""The traced slice: a ``torch.profiler`` trace of a few requests, passes
or one update after the window, and what per-layer readers take from it.

A device operation (kernel, copy or fill) belongs to a host range when the
call that launched it lies inside the range: the program's own
``record_function`` ranges, the benchmark's, or an operator's (a
registered kernel's ``wistpu::*`` call, an autograd node).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('user_annotation', 'cpu_op')


class Slice:
    """A parsed trace: device operations with their launch time and thread,
    host ranges, the slice's wall seconds and how many units of work (requests,
    micro-steps) it covered."""

    def __init__(self, events: list, wall_s: float, units: int):
        self.wall_s, self.units = wall_s, units
        xs = [e for e in events if e.get('ph') == 'X']
        launch = {e['args']['correlation']: (e['ts'], e.get('tid'))
                  for e in xs if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                  and 'correlation' in e.get('args', {})}
        self.device = []  # (start µs, duration µs, name, launch µs, launch thread)
        for e in xs:
            if e.get('cat') in DEVICE_CATS:
                ts, tid = launch.get(e.get('args', {}).get('correlation'), (None, None))
                self.device.append((e['ts'], e['dur'], e['name'], ts, tid))
        self.device.sort()
        self.ranges = sorted((e['ts'], e['ts'] + e['dur'], e['name'], e.get('tid'),
                              e.get('args', {})) for e in xs if e.get('cat') in HOST_CATS)

    def ranges_named(self, match) -> list:
        """Host ranges whose name satisfies ``match`` (a name or a predicate)."""
        pred = match if callable(match) else (lambda n: n == match)
        return [r for r in self.ranges if pred(r[2])]

    def device_s(self, match, same_thread: bool = False) -> float:
        """Seconds of device operations launched inside a range that
        ``match`` names (on the range's own thread if ``same_thread``)."""
        ranges = self.ranges_named(match)
        if not ranges:
            return 0.0
        starts = [r[0] for r in ranges]
        total = 0.0
        for _, dur, _, ts, tid in self.device:
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts)
            for a, b, _, rtid, _ in reversed(ranges[max(0, i - 64):i]):
                if a <= ts <= b and (not same_thread or rtid == tid):
                    total += dur
                    break
        return total / 1e6

    def host_s(self, match) -> float:
        """Seconds the host spent in ranges that ``match`` names."""
        return sum(b - a for a, b, *_ in self.ranges_named(match)) / 1e6

    def busy_intervals(self) -> list:
        merged = []
        for start, dur, *_ in self.device:
            end = start + dur
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s() / self.wall_s)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        between device work summed by the innermost host range open at
        each gap's middle."""
        ops = collections.Counter()
        for _, dur, name, *_ in self.device:
            ops[name[:160]] += dur / 1e6
        gaps = collections.Counter()
        busy = self.busy_intervals()
        starts = [r[0] for r in self.ranges]
        for (_, end), (start, _) in zip(busy, busy[1:]):
            mid = (end + start) / 2
            i = bisect.bisect_right(starts, mid)
            near = (r[2] for r in reversed(self.ranges[max(0, i - 4096):i]) if r[0] <= mid <= r[1])
            far = (r[2] for r in reversed(self.ranges[:max(0, i - 4096)]) if r[0] <= mid <= r[1])
            inner = next(near, None) or next(far, 'no host range')
            gaps[inner[:160]] += (start - end) / 1e6
        return {'device_ops': [[n, s] for n, s in ops.most_common(top)],
                'idle_gaps': [[n, s] for n, s in gaps.most_common(top)]}


def capture(fn, units: int, synchronize) -> Slice:
    """Run ``fn`` under the profiler (host and device, with operator
    shapes) and parse its trace; ``units`` is the work ``fn`` does."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        synchronize()
        t0 = time.perf_counter()
        fn()
        synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return Slice(events, wall, units)
