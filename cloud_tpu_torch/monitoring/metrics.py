"""The metrics registry (port of ``cloud_tpu/monitoring/metrics.py``).

Counters, gauges and distributions recorded from any thread and read as
one snapshot.  The reference has two registries with one surface: a
native C++ one, loaded through ctypes when its library builds, and a
pure-Python one.  The port carries the pure-Python registry only (the
native one is a host library, not a kernel; ROADMAP.md section A, item 6),
so :func:`backend` answers ``"python"``.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

_NUM_BUCKETS = 24


class _PurePythonRegistry:
    """The reference's pure-Python registry: the same semantics as its
    native one (exponential buckets, JSON-safe snapshot)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._dists: Dict[str, dict] = {}

    def counter_inc(self, name, delta=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(delta)

    def gauge_set(self, name, value):
        with self._lock:
            self._gauges[name] = float(value)

    def distribution_record(self, name, value):
        with self._lock:
            d = self._dists.setdefault(
                name,
                {
                    "count": 0,
                    "mean": 0.0,
                    "sum_squared_deviation": 0.0,
                    "buckets": [0] * _NUM_BUCKETS,
                },
            )
            d["count"] += 1
            delta = value - d["mean"]
            d["mean"] += delta / d["count"]
            d["sum_squared_deviation"] += delta * (value - d["mean"])
            if value == math.inf:
                idx = _NUM_BUCKETS - 1
            elif not math.isfinite(value) or value < 1.0:
                idx = 0
            else:
                idx = min(1 + int(math.floor(math.log2(value))),
                          _NUM_BUCKETS - 1)
            d["buckets"][idx] += 1

    def snapshot(self):
        # JSON has no inf/nan: clamp them, as the native registry does.
        def fin(v):
            return v if math.isfinite(v) else 0.0

        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": {k: fin(v) for k, v in self._gauges.items()},
                "distributions": {
                    k: {
                        **v,
                        "mean": fin(v["mean"]),
                        "sum_squared_deviation": fin(
                            v["sum_squared_deviation"]),
                        "buckets": list(v["buckets"]),
                    }
                    for k, v in self._dists.items()
                },
            }

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._dists.clear()


_registry = _PurePythonRegistry()


def backend() -> str:
    """Which registry records: always ``"python"`` in the port."""
    return "python"


class WindowedRate:
    """Events/sec gauge over a sliding window of ``window`` events:
    accumulate counts with :meth:`add`; the gauge updates each time a
    window fills, and :meth:`flush` publishes a partial window and
    restarts timing."""

    def __init__(self, name: str, window: int):
        self.name = name
        self.window = max(1, int(window))
        self._count = 0
        self._start: Optional[float] = None

    def restart(self, now: float) -> None:
        """Drop the current window and start timing from ``now``."""
        self._count = 0
        self._start = now

    def add(self, now: float, n: int = 1) -> None:
        if self._start is None:
            self._start = now
            return
        self._count += n
        if self._count >= self.window:
            self.flush(now)

    def flush(self, now: float) -> None:
        if self._count and self._start is not None and now > self._start:
            gauge_set(self.name, self._count / (now - self._start))
        self.restart(now)


def counter_inc(name: str, delta: int = 1) -> None:
    _registry.counter_inc(name, delta)


def gauge_set(name: str, value: float) -> None:
    _registry.gauge_set(name, value)


def distribution_record(name: str, value: float) -> None:
    _registry.distribution_record(name, value)


def snapshot() -> dict:
    return _registry.snapshot()


def reset() -> None:
    _registry.reset()
