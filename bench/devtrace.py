"""Reduce ``torch.profiler`` records of whole calls to device numbers.

From the profiler's own records (no chrome trace is written).  A profile
of the device alone gives the device intervals (kernels, copies, sets),
their union (the busy seconds) and the device seconds by kernel name.  A
second profile, with host records, gives the idle gaps between device
work, each labelled by what the host was doing in its middle: the
benchmark's span (``bench.cost_draw``, ``bench.solve_call``) and the
innermost host operation open at that instant.  Recording every host
operation lengthens a call by half or more, so the busy and idle shares
come from the first profile only.  Arithmetic copied from
``chip_smoke.py::profiled`` (device records by ``device_type``), with the
busy time taken as the union of intervals rather than their sum.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class TraceSummary:
    window_s: float                      # host clock over the traced calls
    busy_s: float                        # union of device intervals
    by_name: dict[str, float]            # device seconds by kernel name
    idle_by_host: dict[str, float]       # idle seconds by host activity

    def kernel_s(self, needle: str) -> float:
        """Device seconds of every record whose name holds ``needle``."""
        return sum(s for name, s in self.by_name.items() if needle in name)

    def top_ops(self, count: int = 10) -> list:
        return sorted(([k, v] for k, v in self.by_name.items()),
                      key=lambda kv: -kv[1])[:count]

    def top_idle(self, count: int = 10) -> list:
        return sorted(([k, v] for k, v in self.idle_by_host.items()),
                      key=lambda kv: -kv[1])[:count]


def _records(prof):
    """``(device intervals, device seconds by name, host intervals)``."""
    import torch

    on_card = torch.autograd.DeviceType.CUDA
    device, host = [], []
    by_name: dict[str, float] = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == on_card:
            if e.name().startswith(SPAN_PREFIX):
                # the profiler mirrors a host span onto the device's
                # timeline; it is no work of the card's
                continue
            device.append((start, end))
            by_name[short(e.name())] += e.duration_ns() / 1e9
        elif e.duration_ns() > 0:
            host.append((start, end, e.name()))
    device.sort()
    merged: list[list[int]] = []
    for start, end in device:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged, dict(by_name), host


def summarize(prof, window_s: float) -> TraceSummary:
    """Busy seconds and device seconds by name of a profile of the device
    alone (no host records, whose cost would lengthen the window)."""
    merged, by_name, _ = _records(prof)
    busy = sum(end - start for start, end in merged) / 1e9
    return TraceSummary(window_s=window_s, busy_s=busy, by_name=by_name,
                        idle_by_host={})


def idle_by_host(prof) -> dict[str, float]:
    """Idle seconds between device records, by what the host was doing,
    from a profile with host records."""
    merged, _, host = _records(prof)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    return _label_gaps(gaps, host)


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 160 letters."""
    if name.endswith(")") and ("::" in name or "<" in name):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:160]


def _label_gaps(gaps, host) -> dict[str, float]:
    """Idle seconds by ``<benchmark span>/<innermost host op>`` open at
    each gap's midpoint (one sweep over both, in time order)."""
    host.sort()
    out: dict[str, float] = defaultdict(float)
    active: list = []
    j = 0
    for lo, hi in sorted(gaps):
        mid = (lo + hi) // 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        span = next((h[2] for h in active
                     if h[2].startswith(SPAN_PREFIX)), "outside")
        inner = next((h[2] for h in reversed(active)
                      if not h[2].startswith(SPAN_PREFIX)), "python")
        out[f"{span}/{inner}"] += (hi - lo) / 1e9
    return dict(out)
