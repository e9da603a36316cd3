"""The traced run: torch.profiler's device activity over the measured
window, reduced to the device's busy time, its operations by name and
count, each kernel's device time by its exact function name, and the idle
gaps by the benchmark span the host was in.

Only the device's activity is recorded (CUPTI), which costs the host far
less than recording every operator would; the benchmark's own spans are
host-clock intervals, placed on the device's timeline by a marker kernel
launched at a known host time when the window opens."""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel, launched once as the window opens


def kernel_name(key: str) -> str:
    """A device operation's function name without template arguments or
    parameters (``conv_kernel<128, ...>(float const*, ...)`` -> ``conv_kernel``);
    the whole key where it has no parameter list."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", key.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else key


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length covered by the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """Device operations as (name, start_us, end_us, device index), host
    spans as (name, start_us, end_us) on the same timeline, the window's
    bounds and the number of devices the run used. Busy and idle time are
    averaged over the devices; operation counts and kernel times are summed."""

    def __init__(self, ops: List[Tuple[str, float, float, int]],
                 spans: List[Tuple[str, float, float]], lo: float, hi: float, n_devices: int = 1):
        self.ops = [(n, max(s, lo), min(e, hi), d) for n, s, e, d in ops if e > lo and s < hi]
        self.spans, self.lo, self.hi, self.n_devices = spans, lo, hi, n_devices

    def _by_device(self) -> List[List[Tuple[float, float]]]:
        out: Dict[int, List[Tuple[float, float]]] = {}
        for _, s, e, d in self.ops:
            out.setdefault(d, []).append((s, e))
        return list(out.values()) + [[]] * max(0, self.n_devices - len(out))

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(union_length(iv) for iv in self._by_device()) / self.n_devices / 1e6

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def kernel_s(self, names) -> Optional[float]:
        """Device seconds of the operations whose function name is in
        ``names``; None where none ran."""
        t = [e - s for n, s, e, _ in self.ops if kernel_name(n) in names]
        return sum(t) / 1e6 if t else None

    def top_ops(self, n: int = 10) -> List[list]:
        sums: Dict[str, float] = {}
        for name, s, e, _ in self.ops:
            key = kernel_name(name)
            sums[key] = sums.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, n: int = 10) -> List[list]:
        """Idle device time summed by the innermost benchmark span open at
        each gap's middle ("outside spans" where none is), averaged over the
        devices."""
        sums: Dict[str, float] = {}
        for intervals in self._by_device():
            for s, e in gaps(intervals, self.lo, self.hi):
                mid = (s + e) / 2
                inner = [(b - a, name) for name, a, b in self.spans if a <= mid < b]
                key = min(inner)[1] if inner else "outside spans"
                sums[key] = sums.get(key, 0.0) + (e - s) / 1e6 / self.n_devices
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def span(name: str, recorder: Optional["Recorder"]) -> Iterator[None]:
    """A host span the trace can see; nothing without a recorder."""
    if recorder is None:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        recorder.spans.append((name, start, time.perf_counter()))


class Recorder:
    """torch.profiler's device activity over the window on ``n_devices``
    CUDA devices: ``start`` as it opens, ``close_window`` once the devices
    have finished it, ``stop`` after; ``trace()`` then reduces the events."""

    def __init__(self, n_devices: int = 1):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.n_devices = torch, n_devices
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.spans: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.prof.__enter__()
        self._synchronize()
        self.t0 = time.perf_counter()
        self.torch.cuda._sleep(1)  # the marker: it starts on the device just after t0

    def close_window(self) -> None:
        """End the window (the device has finished the window's work)."""
        if self.t1 is None:
            self._synchronize()
            self.t1 = time.perf_counter()

    def _synchronize(self) -> None:
        for d in range(self.n_devices):
            self.torch.cuda.synchronize(d)

    def stop(self) -> None:
        self.close_window()
        self.prof.__exit__(None, None, None)

    def trace(self) -> Trace:
        from torch.autograd import DeviceType

        ops = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3,
                e.device_index()) for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        marks = [s for n, s, _, _ in ops if kernel_name(n) == MARKER]
        if not marks:
            raise RuntimeError("the trace holds no device operation (no marker kernel)")
        offset = min(marks) - self.t0 * 1e6  # device timeline = host clock (us) + offset

        def on_device(t: float) -> float:
            return t * 1e6 + offset

        spans = [(n, on_device(a), on_device(b)) for n, a, b in self.spans]
        ops = [op for op in ops if kernel_name(op[0]) != MARKER]
        return Trace(ops, spans, on_device(self.t0), on_device(self.t1), self.n_devices)
