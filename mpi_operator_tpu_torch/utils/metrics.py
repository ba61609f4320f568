"""Prometheus-style metrics registry (the port's copy of the part of
``mpi_operator_tpu/utils/metrics.py`` the trainer uses).

Counters, gauges and histograms in the client_golang text layout. Names
start with ``tpu_operator_``; counters end in ``_total``, histograms in
``_seconds``.
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Sequence

# client_golang's prometheus.DefBuckets.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_label_value(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class _Metric:
    kind = ""

    def __init__(self, name: str, help_: str, registry: Optional["Registry"],
                 label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}
        if registry is not None:
            registry.register(self)

    def _label_str(self, labels: Sequence[str]) -> str:
        return ",".join(
            f'{n}="{escape_label_value(v)}"'
            for n, v in zip(self.label_names, labels)
        )

    def _header(self) -> list[str]:
        return [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]

    def expose(self) -> str:
        lines = self._header()
        with self._lock:
            samples = sorted(self._values.items())
        if not samples and not self.label_names:
            samples = [((), 0.0)]
        for labels, value in samples:
            if labels:
                lines.append(f"{self.name}{{{self._label_str(labels)}}} {value}")
            else:
                lines.append(f"{self.name} {value}")
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, *labels: str) -> None:
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, *labels: str) -> None:
        with self._lock:
            self._values[labels] = value


class Histogram(_Metric):
    """Cumulative histogram: ``<name>_bucket{le=...}``, ``_sum``, ``_count``."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, registry: Optional["Registry"],
                 label_names: tuple[str, ...] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, registry, label_names)
        bounds = sorted(set(float(b) for b in buckets))
        if bounds and bounds[-1] == float("inf"):
            bounds.pop()  # +Inf is implicit
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket")
        self.buckets: tuple[float, ...] = tuple(bounds)
        # labels -> [per-bucket counts (not cumulative), sum, count]
        self._series: dict[tuple[str, ...], list] = {}

    def observe(self, value: float, *labels: str) -> None:
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            series = self._series.setdefault(
                labels, [[0] * (len(self.buckets) + 1), 0.0, 0]
            )
            series[0][idx] += 1
            series[1] += value
            series[2] += 1

    def expose(self) -> str:
        lines = self._header()
        with self._lock:
            items = sorted(
                (labels, s[0][:], s[1], s[2]) for labels, s in self._series.items()
            )
        if not items and not self.label_names:
            items = [((), [0] * (len(self.buckets) + 1), 0.0, 0)]
        bounds = [str(b) for b in self.buckets] + ["+Inf"]
        for labels, counts, sum_, count in items:
            base = self._label_str(labels)
            running = 0
            for bound, c in zip(bounds, counts):
                running += c
                le = f'le="{bound}"'
                lines.append(
                    f"{self.name}_bucket{{{base + ',' + le if base else le}}} "
                    f"{running}"
                )
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {sum_}")
            lines.append(f"{self.name}_count{suffix} {count}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            self._metrics.append(metric)

    def expose(self) -> str:
        with self._lock:
            return "\n".join(m.expose() for m in self._metrics) + "\n"


DEFAULT_REGISTRY = Registry()


def new_counter(name: str, help_: str, label_names: tuple[str, ...] = (),
                registry: Optional[Registry] = None) -> Counter:
    return Counter(name, help_, registry or DEFAULT_REGISTRY, label_names)


def new_gauge(name: str, help_: str, label_names: tuple[str, ...] = (),
              registry: Optional[Registry] = None) -> Gauge:
    return Gauge(name, help_, registry or DEFAULT_REGISTRY, label_names)


def new_histogram(name: str, help_: str, label_names: tuple[str, ...] = (),
                  registry: Optional[Registry] = None,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return Histogram(name, help_, registry or DEFAULT_REGISTRY, label_names,
                     buckets)
