"""Tracing/profiling subsystem (SURVEY.md §5 parity + device traces).

The reference measures wall-clock frame time for the window title
(app/main.cpp:368-404) and uses TfStopwatch/HD_TRACE in the Hydra path.
Here: FrameStats keeps the same ms/spp counters plus rolling averages and a
rays/s estimate, and device_trace() wraps jax.profiler for on-device
XLA op timelines (readable with tensorboard or the bundled
summarize_trace parser).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional


class Stopwatch:
    """TfStopwatch-style accumulating timer."""

    def __init__(self) -> None:
        self._start: Optional[float] = None
        self.total: float = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None
        return self.total


class FrameStats:
    """Per-frame timing + throughput counters (title-bar parity)."""

    def __init__(self, window: int = 32):
        self._times = deque(maxlen=window)
        self.frame_count = 0

    def add_frame(self, seconds: float, rays: int = 0) -> None:
        self._times.append((seconds, rays))
        self.frame_count += 1

    @property
    def ms(self) -> float:
        return self._times[-1][0] * 1e3 if self._times else 0.0

    @property
    def avg_ms(self) -> float:
        if not self._times:
            return 0.0
        return sum(t for t, _ in self._times) / len(self._times) * 1e3

    @property
    def mrays_per_sec(self) -> float:
        if not self._times:
            return 0.0
        t = sum(t for t, _ in self._times)
        r = sum(r for _, r in self._times)
        return r / t / 1e6 if t > 0 else 0.0

    def title(self, name: str = "Strelka", spp: int = 0) -> str:
        """app/main.cpp:399-403 window-title format + throughput."""
        extra = f" [{self.mrays_per_sec:.1f} Mray/s]" if self.mrays_per_sec else ""
        return f"{name} [{self.ms:.1f} ms] [{spp} spp]{extra}"


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Capture a jax.profiler device trace around a block."""
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def summarize_trace(trace_dir: str, top: int = 20):
    """Aggregate device op times from the newest trace under trace_dir.

    Returns [(name, total_ms)] sorted desc — no tensorboard required.
    """
    import collections
    import glob
    import gzip
    import json

    files = sorted(glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True))
    if not files:
        return []
    with gzip.open(files[-1], "rt") as f:
        data = json.load(f)
    per = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e:
            name = e.get("name", "?")
            if name.startswith(("$", "np", "jit", "PjitF")):
                continue
            per[name.split(".")[0]] += e["dur"]
    return [(name, dur / 1e3) for name, dur in per.most_common(top)]
