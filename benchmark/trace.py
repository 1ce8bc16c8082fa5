"""The traced window: a ``torch.profiler`` profile over every thread,
reduced to what the per-layer readers and the breakdown need.

- device work: every kernel, copy and set on the card's timeline (the
  program's ``record_function`` ranges also appear there as annotations,
  which are not device work and are left out);
- host ranges: each ``record_function`` range by name and thread (each of
  the port's ``obs`` spans and stage timers is one, and so are the
  harness's ``bench.*`` ranges);
- the device time of the kernels each host range launched, by the
  profiler's correlation of a kernel with the op that launched it.

The union of busy intervals and the idle split follow ``chip_smoke.py``'s
``merged_busy_us`` and ``stage_idle``.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Trace", "merged_busy_us", "profiler"]

WINDOW = "bench.window"
JOB = "bench.job"


def profiler():
    """A CPU and CUDA profiler over every thread of the process (the
    ingest's worker and builder threads hold ranges too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (TypeError, AttributeError):
        pass
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **kw)


def merged_busy_us(intervals: Iterable[Tuple[float, float]], lo: float,
                   hi: float) -> float:
    """Microseconds of [lo, hi] covered by the union of ``intervals``."""
    busy, end = 0.0, lo
    for start, stop in sorted(intervals):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            busy += stop - start
            end = stop
    return busy


def _merged(intervals, lo, hi) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        start, stop = max(start, lo), min(stop, hi)
        if stop <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


def _is_annotation(name: str) -> bool:
    return "::" not in name and not name.startswith("cu")


class Trace:
    """The reduced profile. Times are the profiler's microseconds."""

    def __init__(self, device: Sequence[Tuple[float, float, str]],
                 ranges: Dict[str, List[Tuple[int, float, float]]],
                 launched: Dict[str, List[Tuple[str, float]]],
                 window: Tuple[float, float]):
        self.device = sorted(device)  # (start, end, name)
        self.ranges = ranges  # name -> [(thread, start, end)]
        self.launched = launched  # range name -> [(kernel, us)]
        self.lo, self.hi = window

    @classmethod
    def from_profile(cls, prof, watched: Iterable[str] = ()) -> "Trace":
        """Reduce a finished profile. ``watched`` names the host ranges
        whose launched kernels are wanted (a kernel counts for every
        watched range among the launching op's ancestors)."""
        from torch.autograd import DeviceType

        events = prof.events()
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        cpu_names = {e.name for e in cpu}
        device = [(e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.name not in cpu_names]
        ranges: Dict[str, List[Tuple[int, float, float]]] = (
            collections.defaultdict(list))
        for e in cpu:
            if _is_annotation(e.name):
                ranges[e.name].append(
                    (e.thread, e.time_range.start, e.time_range.end))
        watched = set(watched)
        launched: Dict[str, List[Tuple[str, float]]] = (
            collections.defaultdict(list))
        for e in cpu:
            if not e.kernels or not watched:
                continue
            names, parent = set(), e
            while parent is not None:
                if parent.name in watched:
                    names.add(parent.name)
                parent = parent.cpu_parent
            for name in names:
                launched[name].extend((k.name, k.duration) for k in e.kernels)
        win = ranges.get(WINDOW)
        if not win:
            raise ValueError(f"the profile holds no {WINDOW} range")
        return cls(device, dict(ranges), dict(launched),
                   (win[0][1], win[0][2]))

    # -- readings --------------------------------------------------------

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def busy_us(self) -> float:
        return merged_busy_us(((a, b) for a, b, _ in self.device),
                              self.lo, self.hi)

    def union_us(self, names: Iterable[str],
                 prefix: Optional[str] = None) -> float:
        """Time covered by the named ranges (and those starting with
        ``prefix``), merged on each thread and summed over threads, so a
        range nested in another is counted once."""
        names = set(names)
        picked = [n for n in self.ranges
                  if n in names or (prefix and n.startswith(prefix))]
        by_thread = collections.defaultdict(list)
        for n in picked:
            for thread, a, b in self.ranges[n]:
                by_thread[thread].append((a, b))
        return sum(merged_busy_us(iv, self.lo, self.hi)
                   for iv in by_thread.values())

    def kernel_us(self, contains: Iterable[str]) -> float:
        """Device time of the kernels whose name holds any of ``contains``."""
        subs = tuple(contains)
        return sum(b - a for a, b, name in self.device
                   if any(s in name for s in subs))

    def launched_us(self, range_name: str,
                    contains: Iterable[str] = ()) -> float:
        """Device time of the kernels launched inside ``range_name`` (those
        whose name holds any of ``contains``, where given)."""
        subs = tuple(contains)
        return sum(us for name, us in self.launched.get(range_name, ())
                   if not subs or any(s in name for s in subs))

    # -- the breakdown -------------------------------------------------

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time: [name, seconds], a
        name cut to its first 160 characters."""
        by_name: Dict[str, float] = collections.defaultdict(float)
        for a, b, name in self.device:
            if b > self.lo and a < self.hi:
                by_name[name[:160]] += (min(b, self.hi) - max(a, self.lo)) / 1e6
        return [[n, s] for n, s in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def _host_segments(self) -> List[Tuple[float, float, str]]:
        """The job thread's timeline cut into segments, each labelled with
        the innermost range open over it."""
        jobs = self.ranges.get(JOB, ())
        if not jobs:
            return []
        thread = jobs[0][0]
        marks = []
        for name, spans in self.ranges.items():
            for t, a, b in spans:
                if t == thread:
                    marks.append((a, 1, b - a, name))
                    marks.append((b, 0, b - a, name))
        marks.sort(key=lambda m: (m[0], m[1], -m[2] if m[1] else m[2]))
        segments, stack, last = [], [], self.lo
        for t, opening, _, name in marks:
            if t > last:
                label = stack[-1] if stack else "no range"
                segments.append((last, t, label))
                last = t
            if opening:
                stack.append(name)
            elif name in stack:  # close the innermost range of that name
                del stack[len(stack) - 1 - stack[::-1].index(name)]
        if self.hi > last:
            segments.append((last, self.hi, "no range"))
        return segments

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Device-idle time inside the window, split by what the job's
        thread was doing (the innermost range open): [label, seconds]."""
        busy = _merged(((a, b) for a, b, _ in self.device), self.lo, self.hi)
        gaps, cursor = [], self.lo
        for a, b in busy:
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if self.hi > cursor:
            gaps.append((cursor, self.hi))
        by_label: Dict[str, float] = collections.defaultdict(float)
        segments = self._host_segments() or [(self.lo, self.hi, "no range")]
        i = 0
        for ga, gb in gaps:
            while i < len(segments) and segments[i][1] <= ga:
                i += 1
            j = i
            while j < len(segments) and segments[j][0] < gb:
                sa, sb, label = segments[j]
                overlap = min(gb, sb) - max(ga, sa)
                if overlap > 0:
                    by_label[label] += overlap / 1e6
                j += 1
        return [[n, s] for n, s in
                sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]
