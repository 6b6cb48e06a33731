"""Reading a ``torch.profiler`` trace of the traced stretch of a run.

The traced stretch runs inside one ``record_function`` range named
``WINDOW``, each call into the program inside a range named ``CALL``.
From the profile this module takes the device activities (kernels,
copies, sets) as ``(name, start_us, end_us)``, their union (the seconds
the device was busy), and the idle gaps between them, each gap's time
given to the host operation that overlapped it most (a top-level torch
operation of the program; ``host python`` where none ran).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "cepbench.window"
CALL = "cepbench.call"
# The kernels built from ``src/repro_torch/kernels/csrc/window_join.cu``.
KERNELS = ("packed_kernel", "join_kernel", "rowcount_kernel", "count_kernel",
           "select_kernel")


def _is_device(ev) -> bool:
    import torch

    return ev.device_type == torch.autograd.DeviceType.CUDA


def short_name(name: str) -> str:
    """A device activity's name without its return type, namespace noise,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in "<(":
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name.strip()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device and host activity of one traced stretch."""

    def __init__(self, prof):
        events = list(prof.events())
        spans = [e for e in events if e.name == WINDOW and not _is_device(e)]
        if not spans:
            raise RuntimeError(f"no {WINDOW!r} range in the profile")
        win = spans[0].time_range
        self.start_us, self.end_us = win.start, win.end
        self.device_ops: List[Tuple[str, float, float]] = [
            (e.name, e.time_range.start, e.time_range.end) for e in events
            if _is_device(e) and e.time_range.end > e.time_range.start
            and e.name not in (WINDOW, CALL)]
        self._host = [
            (e.name, e.time_range.start, e.time_range.end) for e in events
            if not _is_device(e) and not e.name.startswith("cepbench.")
            and (e.cpu_parent is None
                 or e.cpu_parent.name.startswith("cepbench."))]

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self):
        return _merge([(max(s, self.start_us), min(e, self.end_us))
                       for _, s, e in self.device_ops
                       if e > self.start_us and s < self.end_us])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, pick=lambda name: True) -> float:
        """Summed device time of the activities whose name ``pick``s."""
        return sum(e - s for n, s, e in self.device_ops if pick(n)) / 1e6

    def top_device_ops(self, n: int = 10):
        by = defaultdict(float)
        for name, s, e in self.device_ops:
            by[short_name(name)] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle device seconds by what the host was doing, largest first."""
        gaps, t = [], self.start_us
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end_us > t:
            gaps.append((t, self.end_us))
        # Top-level host operations run one after another on one thread,
        # so sorted by start they are sorted by end too.
        host = sorted(self._host, key=lambda h: h[1])
        by: Dict[str, float] = defaultdict(float)
        first = 0
        for g0, g1 in gaps:
            while first < len(host) and host[first][2] <= g0:
                first += 1
            covered = 0.0
            for name, s, e in host[first:]:
                if s >= g1:
                    break
                ov = min(e, g1) - max(s, g0)
                if ov > 0:
                    by[name] += ov / 1e6
                    covered += ov
            by["host python"] += max(g1 - g0 - covered, 0.0) / 1e6
        return sorted(([k, v] for k, v in by.items() if v > 0),
                      key=lambda kv: -kv[1])[:n]
