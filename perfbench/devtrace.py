"""The device trace of a window: ``torch.profiler`` with CUDA activity only
(kernels and copies from CUPTI; the host's own operations are not
recorded, so the trace costs the host little), read into busy time, time
by device operation and idle gaps by what the host was doing.

The profiler drops the first few kernel records of a session, so the
trace starts with ``PRIMER`` empty kernels that are left out.  One more
empty kernel, launched right after a synchronize at a noted host time,
ties the device's clock to the host's (to within a launch, some
microseconds): that is how idle gaps are matched with the host spans open
at the time.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

PRIMER = 32

#: the port's CUDA kernel functions (``kernels/csrc/*.cu``) -> the name of
#: the wrapper that launches them (``kernels.LAUNCHES``)
PORT_KERNELS = {
    "predicate_scan_kernel": "predicate_scan",
    "predicate_scan_multi_kernel": "predicate_scan_multi",
    "fused_chain_kernel": "fused_chain_scan",
    "dict_lookup_kernel": "dict_lookup_scan",
    "dict_lookup_multi_kernel": "dict_lookup_scan_multi",
    "bitmap_setop_kernel": "bitmap_setop",
    "bitmap_setop_grouped_kernel": "bitmap_setop_grouped",
    "bitmap_inter_multi_kernel": "bitmap_inter_multi",
    "bitmap_union_stack_kernel": "bitmap_union_reduce",
}

_SYMBOL = re.compile(r"(\w+_kernel)\b")
_FUNC = re.compile(r"(?:void\s+)?([A-Za-z_][\w:]*)")


def op_name(raw: str) -> str:
    """A device operation's name: the port's wrapper name for its kernels,
    the copy's kind for a copy, else the function's qualified name."""
    sym = _SYMBOL.search(raw)
    if sym and sym.group(1) in PORT_KERNELS:
        return PORT_KERNELS[sym.group(1)]
    if raw.startswith(("Memcpy", "Memset")):
        return raw
    m = _FUNC.match(raw.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else raw[:80]


def _events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation in the trace."""
    from torch.autograd import DeviceType
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for ev in results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            if hasattr(ev, "start_ns"):
                s, d = ev.start_ns(), ev.duration_ns()
            else:
                s, d = ev.start_us() * 1000, ev.duration_us() * 1000
            out.append((ev.name(), int(s), int(s + d)))
        return out
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out.append((ev.name, int(ev.time_range.start * 1000),
                        int(ev.time_range.end * 1000)))
    return out


class DeviceTrace:
    """Context manager around a window: starts the profiler, launches the
    primer and the clock mark, and stops the profiler at exit."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(PRIMER):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        self.mark_ns = time.perf_counter_ns()
        torch.cuda._sleep(0)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.prof.stop()
        return False

    def summary(self, t0: float, t1: float,
                host_spans: Sequence[Tuple[str, float, float]]) -> Dict:
        """Busy time, port-kernel time, time by operation and idle time by
        host span over the host window ``[t0, t1]`` (perf_counter seconds).
        ``host_spans`` are (name, start, end) in perf_counter seconds."""
        evs = _events(self.prof)
        spins = [e for e in evs if "spin_kernel" in e[0]]
        if not spins:
            raise RuntimeError("the profiler recorded no primer kernel")
        mark = max(spins, key=lambda e: e[1])
        offset = mark[1] - self.mark_ns
        w0 = int(t0 * 1e9) + offset
        w1 = int(t1 * 1e9) + offset
        ops: Dict[str, float] = defaultdict(float)
        port_ns, port_launches = 0, defaultdict(int)
        spans = []
        for name, s, e in evs:
            if s <= mark[2] or e <= w0 or s >= w1:
                continue
            s, e = max(s, w0), min(e, w1)
            op = op_name(name)
            ops[op] += (e - s) / 1e9
            if op in PORT_KERNELS.values():
                port_ns += e - s
                port_launches[op] += 1
            spans.append((s, e))
        spans.sort()
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        gaps, prev = [], w0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        labels = _timeline([(n, int(a * 1e9) + offset, int(b * 1e9) + offset)
                            for n, a, b in host_spans])
        starts = [seg[0] for seg in labels]
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = (labels[i][2] if i >= 0 and labels[i][1] > mid
                    else "harness")
            idle[name] += (b - a) / 1e9
        return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
                "port_kernel_s": port_ns / 1e9,
                "port_launches": dict(port_launches),
                "ops": dict(ops), "idle": dict(idle)}


def _timeline(spans: Sequence[Tuple[str, int, int]]
              ) -> List[Tuple[int, int, str]]:
    """Nested spans -> (start, end, innermost span's name) segments,
    sorted; a span that outlasts its parent is cut at the parent's end."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    t = None
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            if end > t:
                out.append((t, end, nm))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        t = s
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        if end > t:
            out.append((t, end, nm))
            t = end
    return out


def top(d: Dict[str, float], k: int = 10) -> List[List]:
    return [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])[:k]]
