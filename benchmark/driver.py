"""What every driver shares. A driver is how a traffic mix drives the
program: ``drivers/<name>.py``, found by the mix's ``driver`` key and
loaded by name (``harness.driver_module``), defines ``DRIVER``, a
subclass of ``Driver``, and ``FAULTS``, the faults planted in its timed
path that its check has to catch (``control.py --fault``, the CPU tests).

A driver's ``setup`` builds the program and warms it up, ``window`` drives
it for the measured seconds and records what it did (the spans it opens are
the benchmark's own, around the calls into each layer), ``end_to_end``
gives the cell's end-to-end metrics but ``setup_s``, ``release`` frees the
program's state, and ``check`` holds what the window produced against the
plain reference (``reference/``). It is handed one device a chip the cell
asks for."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

UNMATCHED = 1e9  # the reading where the program's output has no counterpart to compare


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the reference's peak."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], names) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    g = {n: float(got[n].norm()) for n in names}
    w = {n: float(want[n].norm()) for n in names}
    med = float(np.median(list(w.values())))
    return max(abs(g[n] - w[n]) / max(w[n], med, 1e-30) for n in names)


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, devices: List[torch.device],
                 limits: dict):
        self.config, self.mix, self.seed, self.limits = config, mix, seed, limits
        self.devices = list(devices)
        self.device = self.devices[0]
        # the program's seed: its training draws are seeded seed * 2**32 + step
        self.program_seed = seed % 2 ** 32
        self.hp = dict(config.get("hparams", {}), seed=self.program_seed)
        self.record: dict = {}
        self.parts: Dict[str, float] = {}  # seconds of each part of the set-up
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self._t
        self._t = now

    def checks(self, readings: Dict[str, float]) -> Dict[str, dict]:
        return {k: {"value": v, "limit": self.limits[k]} for k, v in readings.items()}

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float, recorder=None) -> None:
        raise NotImplementedError

    def end_to_end(self) -> Dict[str, float]:
        raise NotImplementedError

    def attempted(self) -> int:
        raise NotImplementedError

    def release(self) -> None:
        pass

    def check(self) -> Dict[str, dict]:
        raise NotImplementedError
