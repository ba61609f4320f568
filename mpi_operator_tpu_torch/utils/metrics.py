"""Prometheus-style metrics registry (no external dependency).

Reference analog: the promauto counters/gauges in
/root/reference/v2/pkg/controller/mpi_job_controller.go:120-136 and the
/metrics endpoint in v2/cmd/mpi-operator/main.go:29-40.  Same metric names
with the ``tpu_operator_`` prefix, exposed in Prometheus text format.

Three metric kinds:

- ``Counter``: monotonic, with ``mirror_total`` for externally-owned totals;
- ``Gauge``: settable, with per-label-set removal (stale-series control);
- ``Histogram``: cumulative buckets + ``_sum``/``_count`` in the upstream
  client_golang layout (``le`` label, ``+Inf`` bucket), the substrate for
  every latency metric (workqueue, reconcile, train-step).

Naming contract (enforced by tests/test_lint.py): every registered name
starts with ``tpu_operator_``, counters end in ``_total``, histograms in
``_seconds``.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

# client_golang's prometheus.DefBuckets: tuned for request latencies in
# seconds, which is exactly what every histogram here measures.
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def escape_label_value(value: str) -> str:
    """Text exposition format escaping for label values: backslash,
    double-quote, and line feed must be escaped (in that order, so the
    backslashes the other two introduce are not re-escaped)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    """HELP lines escape backslash and line feed (not double-quote)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    return str(value)


class _Metric:
    def __init__(self, name: str, help_: str, registry: Optional["Registry"]):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}
        self._label_names: tuple[str, ...] = ()
        if registry is not None:
            registry.register(self)

    def _set_labels(self, label_names: tuple[str, ...]) -> None:
        self._label_names = tuple(label_names)

    @property
    def label_names(self) -> tuple[str, ...]:
        return self._label_names

    def _samples(self) -> list[tuple[tuple[str, ...], float]]:
        with self._lock:
            if not self._values and not self._label_names:
                return [((), 0.0)]
            return sorted(self._values.items())

    def _label_str(self, labels: Sequence[str]) -> str:
        return ",".join(
            f'{n}="{escape_label_value(v)}"'
            for n, v in zip(self._label_names, labels)
        )

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for labels, value in self._samples():
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

    def mirror_total(self, value: float, *labels: str) -> None:
        """Overwrite with an externally-accumulated monotonic total (a
        counter whose source of truth lives elsewhere, e.g. the REST
        client's retry count, mirrored on scrape). Never decreases —
        counter semantics survive a racy double-set."""
        with self._lock:
            if value > self._values.get(labels, 0.0):
                self._values[labels] = value

    def value(self, *labels: str) -> float:
        with self._lock:
            return self._values.get(labels, 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def labels(self, *label_values: str) -> "_GaugeView":
        return _GaugeView(self, label_values)

    def set(self, value: float, *labels: str) -> None:
        with self._lock:
            self._values[labels] = value

    def remove(self, *labels: str) -> None:
        """Drop a label set (prevents unbounded stale series)."""
        with self._lock:
            self._values.pop(labels, None)

    def remove_matching(self, *label_prefix: str) -> None:
        """Drop every series whose leading label values equal the given
        prefix — the bulk form of ``remove`` for when the caller knows
        the identity labels (namespace, job) but not the tail (e.g.
        condition type)."""
        with self._lock:
            for labels in [
                ls
                for ls in self._values
                if ls[: len(label_prefix)] == label_prefix
            ]:
                del self._values[labels]

    def value(self, *labels: str) -> float:
        with self._lock:
            return self._values.get(labels, 0.0)


class _GaugeView:
    def __init__(self, gauge: Gauge, label_values: tuple[str, ...]):
        self._gauge = gauge
        self._labels = label_values

    def set(self, value: float) -> None:
        self._gauge.set(value, *self._labels)


class _HistogramSeries:
    __slots__ = ("bucket_counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # per-bucket, not cumulative
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Cumulative histogram (client_golang layout).

    Exposes ``<name>_bucket{...,le="..."}`` series (cumulative, ending in
    ``le="+Inf"``), ``<name>_sum`` and ``<name>_count`` per label set.
    ``observe`` is O(log buckets); buckets are fixed at construction.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        registry: Optional["Registry"],
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help_, registry)
        bounds = sorted(set(float(b) for b in buckets))
        if bounds and bounds[-1] == float("inf"):
            bounds.pop()  # +Inf is implicit
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket")
        self._bounds: tuple[float, ...] = tuple(bounds)
        self._series: dict[tuple[str, ...], _HistogramSeries] = {}

    @property
    def buckets(self) -> tuple[float, ...]:
        return self._bounds

    def observe(self, value: float, *labels: str) -> None:
        import bisect

        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            series = self._series.get(labels)
            if series is None:
                series = self._series[labels] = _HistogramSeries(
                    len(self._bounds) + 1
                )
            series.bucket_counts[idx] += 1
            series.sum += value
            series.count += 1

    def time(self, *labels: str) -> "_HistogramTimer":
        """``with hist.time("label"): ...`` observes the block's wall time."""
        return _HistogramTimer(self, labels)

    # -- accessors (tests/debugging) ------------------------------------

    def sample_sum(self, *labels: str) -> float:
        with self._lock:
            series = self._series.get(labels)
            return series.sum if series else 0.0

    def sample_count(self, *labels: str) -> int:
        with self._lock:
            series = self._series.get(labels)
            return series.count if series else 0

    def sample_stats(self, *labels: str) -> tuple[int, float]:
        """(count, sum) from ONE lock acquisition.  Reading the two
        separate accessors back-to-back can pair a newer count with an
        older sum when an observe lands between them — callers deriving
        means or shares need the consistent pair."""
        with self._lock:
            series = self._series.get(labels)
            return (series.count, series.sum) if series else (0, 0.0)

    def cumulative_counts(self, *labels: str) -> list[int]:
        """Bucket counts as exposed: cumulative, last entry == count."""
        with self._lock:
            series = self._series.get(labels)
            counts = series.bucket_counts if series else [0] * (
                len(self._bounds) + 1
            )
            out, running = [], 0
            for c in counts:
                running += c
                out.append(running)
            return out

    def expose(self) -> str:
        lines = [
            f"# HELP {self.name} {escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(
                (labels, s.bucket_counts[:], s.sum, s.count)
                for labels, s in self._series.items()
            )
        if not items and not self._label_names:
            items = [((), [0] * (len(self._bounds) + 1), 0.0, 0)]
        bounds = list(self._bounds) + [float("inf")]
        for labels, counts, sum_, count in items:
            base = self._label_str(labels)
            running = 0
            for bound, c in zip(bounds, counts):
                running += c
                le = f'le="{_format_value(bound)}"'
                label_str = f"{base},{le}" if base else le
                lines.append(f"{self.name}_bucket{{{label_str}}} {running}")
            suffix = f"{{{base}}}" if base else ""
            lines.append(f"{self.name}_sum{suffix} {sum_}")
            lines.append(f"{self.name}_count{suffix} {count}")
        return "\n".join(lines)


class _HistogramTimer:
    def __init__(self, hist: Histogram, labels: tuple[str, ...]):
        self._hist = hist
        self._labels = labels

    def __enter__(self) -> "_HistogramTimer":
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import time

        self._hist.observe(time.perf_counter() - self._t0, *self._labels)


class Registry:
    def __init__(self):
        self._metrics: list[_Metric] = []
        self._hooks: list = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            self._metrics.append(metric)

    def on_scrape(self, fn) -> None:
        """Run ``fn`` at the top of every ``expose`` — the pull-model
        hook for values that live outside the metric objects (e.g. the
        REST client's retry/throttle counters)."""
        with self._lock:
            self._hooks.append(fn)

    def expose(self) -> str:
        with self._lock:
            hooks = list(self._hooks)
        for fn in hooks:  # outside the lock: hooks may set() metrics
            fn()
        with self._lock:
            return "\n".join(m.expose() for m in self._metrics) + "\n"


DEFAULT_REGISTRY = Registry()


def new_counter(
    name: str,
    help_: str,
    label_names: tuple[str, ...] = (),
    registry: Optional[Registry] = None,
) -> Counter:
    counter = Counter(name, help_, registry or DEFAULT_REGISTRY)
    counter._set_labels(label_names)
    return counter


def new_gauge(
    name: str,
    help_: str,
    label_names: tuple[str, ...] = (),
    registry: Optional[Registry] = None,
) -> Gauge:
    gauge = Gauge(name, help_, registry or DEFAULT_REGISTRY)
    gauge._set_labels(label_names)
    return gauge


def new_histogram(
    name: str,
    help_: str,
    label_names: tuple[str, ...] = (),
    registry: Optional[Registry] = None,
    buckets: Sequence[float] = DEFAULT_BUCKETS,
) -> Histogram:
    hist = Histogram(name, help_, registry or DEFAULT_REGISTRY, buckets=buckets)
    hist._set_labels(label_names)
    return hist
