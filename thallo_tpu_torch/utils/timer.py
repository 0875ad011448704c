"""Phase timing + performance summary.

Mirrors the reference Timer/RunningStats machinery
(the reference tree's API/src/util.t:423-595) and the
Thallo_PerformanceSummary struct (API/release/include/
Thallo.h:85-104): named events aggregated into count/min/max/mean/stddev,
with the canonical phase names Total / Nonlinear Iteration / Nonlinear
Setup / Linear Solve / Nonlinear Finish.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class RunningStats:
    count: int = 0
    minimum: float = math.inf
    maximum: float = -math.inf
    total: float = 0.0
    total_sq: float = 0.0

    def push(self, v: float):
        self.count += 1
        self.minimum = min(self.minimum, v)
        self.maximum = max(self.maximum, v)
        self.total += v
        self.total_sq += v * v

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    @property
    def stddev(self):
        if self.count < 2:
            return 0.0
        m = self.mean
        var = max(self.total_sq / self.count - m * m, 0.0)
        return math.sqrt(var)

    def asdict(self):
        return {
            "count": self.count,
            "min_ms": self.minimum * 1e3 if self.count else 0.0,
            "max_ms": self.maximum * 1e3 if self.count else 0.0,
            "mean_ms": self.mean * 1e3,
            "stddev_ms": self.stddev * 1e3,
            "total_ms": self.total * 1e3,
        }


@dataclass
class PerfSummary:
    stats: Dict[str, dict] = field(default_factory=dict)

    def __getitem__(self, k):
        return self.stats[k]

    def get(self, k, default=None):
        return self.stats.get(k, default)

    def to_dict(self) -> Dict[str, dict]:
        """JSON-ready form (the C++ harness's perf.json,
        CombinedSolverBase.h:64-101)."""
        return dict(self.stats)

    def markdown(self) -> str:
        """Per-phase markdown table (reference util.t:546-559)."""
        lines = ["| Event | count | mean (ms) | min | max | stddev | total |",
                 "|---|---|---|---|---|---|---|"]
        for name, s in self.stats.items():
            lines.append(
                f"| {name} | {s['count']} | {s['mean_ms']:.3f} | {s['min_ms']:.3f} "
                f"| {s['max_ms']:.3f} | {s['stddev_ms']:.3f} | {s['total_ms']:.3f} |"
            )
        return "\n".join(lines)


class Timer:
    def __init__(self):
        self._stats: Dict[str, RunningStats] = {}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def event(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.push(name, time.perf_counter() - t)

    def push(self, name: str, seconds: float):
        """A row measured outside an event (a probe's or a profiler's
        time), into the same stats the events fill."""
        self._stats.setdefault(name, RunningStats()).push(seconds)

    def total_elapsed(self):
        return time.perf_counter() - self._t0

    def summary(self) -> PerfSummary:
        return PerfSummary({k: v.asdict() for k, v in self._stats.items()})
