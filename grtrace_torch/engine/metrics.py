"""Per-stage wall-clock timers for one render — the torch counterpart of
`grtrace.engine.metrics.RenderMetrics` (its stage timers; the TPU roofline
and profiler hooks are not ported).

PyTorch returns before the card finishes, so on a process that has started
CUDA a stage synchronizes the card before it reads the clock, at both ends:
the time a stage reports is the time its work took, not its enqueue.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class RenderMetrics:
    """Stage timings and ray/step counts for one render."""
    stages: Dict[str, float] = field(default_factory=dict)
    rays: int = 0
    geodesic_steps: int = 0

    @contextlib.contextmanager
    def stage(self, name: str):
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    @property
    def total_s(self) -> float:
        return sum(self.stages.values())
