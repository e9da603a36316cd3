"""Per-stage timers (port of ``prodiff_tpu/utils/profiling.py``) and RTF:
wall seconds per second of audio, the serving metric."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class Timer:
    """Context manager accumulating wall time by name; prints each span when
    ``enable``. Given a CUDA ``device``, it synchronises that device before
    reading the clock at both ends, so a span holds the work it queued."""

    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)

    def __init__(self, name: str, enable: bool = False,
                 device: Optional[torch.device] = None):
        self.name = name
        self.enable = enable
        self.device = torch.device(device) if device is not None else None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.time() - self.t0
        Timer.totals[self.name] += dt
        Timer.counts[self.name] += 1
        if self.enable:
            print(f"| {self.name}: {dt * 1000:.1f} ms "
                  f"(total {Timer.totals[self.name]:.3f}s / {Timer.counts[self.name]}x)")

    @classmethod
    def report(cls) -> Dict[str, float]:
        return dict(cls.totals)

    @classmethod
    def reset(cls):
        cls.totals.clear()
        cls.counts.clear()


def rtf(wall_seconds: float, n_samples: int, sample_rate: int) -> float:
    return wall_seconds / (n_samples / sample_rate)
