"""Metrics registry: counters, gauges and a bounded histogram.

Port of the recording half of ``deepspeed_tpu/telemetry/registry.py``
(no exporters). Recording is host-only: callers pass host scalars and
never a device tensor, so recording never syncs the card.
"""

import math
import threading
from collections import deque


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, n=1.0):
        with self._lock:
            self.value += n


class Gauge:
    """Last-value-wins scalar; ``set_max`` keeps a high-water mark."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v):
        with self._lock:
            self.value = float(v)

    def set_max(self, v):
        with self._lock:
            self.value = max(self.value, float(v))


class Histogram:
    """Bounded-reservoir histogram with exact count/sum/min/max."""

    __slots__ = ("count", "sum", "min", "max", "_values", "_lock")

    def __init__(self, lock, maxlen=1024):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._values = deque(maxlen=maxlen)
        self._lock = lock

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._values.append(v)

    def summary(self):
        with self._lock:
            vals = sorted(self._values)
            count, total, lo, hi = self.count, self.sum, self.min, self.max
            last = self._values[-1] if self._values else None
        if not vals:
            return {"count": 0, "sum": 0.0}

        def pct(q):
            return vals[min(len(vals) - 1,
                            max(0, int(round(q / 100.0 * (len(vals) - 1)))))]
        return {"count": count, "sum": total, "mean": total / max(count, 1),
                "min": lo, "max": hi, "p50": pct(50), "p90": pct(90),
                "p99": pct(99), "last": last}


class MetricsRegistry:
    """Named metric store; names are ``/``-separated paths
    (``serving/ttft_s``)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters = {}
        self._gauges = {}
        self._histograms = {}

    def counter(self, name) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(self._lock)
            return self._counters[name]

    def gauge(self, name) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(self._lock)
            return self._gauges[name]

    def histogram(self, name, maxlen=1024) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(self._lock, maxlen)
            return self._histograms[name]

    def snapshot(self):
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = dict(self._histograms)
        return {"counters": counters, "gauges": gauges,
                "histograms": {k: h.summary() for k, h in hists.items()}}
