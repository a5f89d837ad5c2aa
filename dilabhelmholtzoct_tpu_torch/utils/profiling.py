"""Step timing on the card.

Port of ``dilabhelmholtzoct_tpu/utils/profiling.py``'s ``StepTimer``: per-step
wall times with p50 / p95 / max summaries through the logging facade. The
card runs asynchronously, so the timer synchronises the device before it
reads the clock at each end of a step; a host clock without that measures
the enqueue.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class StepTimer:
    """Accumulates per-step wall times; reports percentile summaries. The
    first step (kernel builds, allocator warm-up) is left out of them."""

    def __init__(self, logger=None, prefix: str = "perf",
                 device: torch.device | None = None):
        self.times: list[float] = []
        self.logger = logger
        self.prefix = prefix
        self.device = device
        self._t0 = None

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        if not self.times:
            return {}
        steps = {f"{self.prefix}/steps": len(self.times) - 1}
        if len(self.times) < 2:
            return steps
        t = np.asarray(self.times[1:])
        return {
            **steps,
            f"{self.prefix}/step_ms_p50": float(np.percentile(t, 50) * 1e3),
            f"{self.prefix}/step_ms_p95": float(np.percentile(t, 95) * 1e3),
            f"{self.prefix}/step_ms_max": float(t.max() * 1e3),
        }

    def log_summary(self):
        if self.logger is not None and self.times:
            self.logger.log(self.summary())
        self.times.clear()
