"""Tracing / profiling: per-stage timers, rolling FPS, torch.profiler hooks
(port of ``adas_tpu/utils/profiling.py``).

``StageTimers`` and ``FPSCounter`` are the JAX package's, unchanged.
``device_trace`` wraps a region in a ``torch.profiler`` trace (CPU and,
where there is a card, CUDA activity) and writes it as a Chrome trace;
``annotate`` names a sub-region of it (``record_function``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np


class FPSCounter:
    """Rolling N-frame FPS (reference demo.py:84-99 semantics)."""

    def __init__(self, window: int = 30):
        self.window = window
        self.fps = 0.0
        self._count = 0
        self._start = time.time()

    def tick(self) -> float:
        self._count += 1
        if self._count >= self.window:
            now = time.time()
            self.fps = self._count / (now - self._start)
            self._count = 0
            self._start = now
        return self.fps


class StageTimers:
    """Named wall-clock stage timers with percentile summaries."""

    def __init__(self, keep: int = 1000):
        self.keep = keep
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            samples = self._samples[name]
            samples.append(time.perf_counter() - t0)
            if len(samples) > self.keep:
                del samples[: len(samples) - self.keep]

    def last(self, name: str) -> float:
        s = self._samples.get(name)
        return s[-1] if s else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._samples.items():
            arr = np.asarray(s)
            out[name] = {
                "n": len(arr),
                "mean_ms": float(arr.mean() * 1000),
                "p50_ms": float(np.percentile(arr, 50) * 1000),
                "p95_ms": float(np.percentile(arr, 95) * 1000),
            }
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace around the region and write it to
    ``log_dir/trace.json`` (Chrome trace format); a no-op when ``log_dir``
    is None so callers can leave the hook in place."""
    if log_dir is None:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named sub-region inside a device trace (``record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield
