"""Dependency-free metrics registry for the serving engine.

Port of ``repro.serve.telemetry.registry``, pure Python, its arithmetic
copied exactly (percentiles, the EWMA update, the Prometheus float
formatting), so equal observations give equal snapshots and equal text in
both packages.

Four metric kinds, all plain host-side objects (no device work — instrumentation must
never change what the engine computes):

* :class:`Counter` — monotonically increasing event count,
* :class:`Gauge` — last-written value (plus a ``set_max`` helper for
  peak-tracking gauges like pool-occupancy high-water marks),
* :class:`Histogram` — streaming count/sum/min/max plus a bounded sample
  reservoir from which p50/p95/p99 are derived with numpy-compatible linear
  interpolation (below ``max_samples`` observations the percentiles are
  *exact*; past it the reservoir keeps the most recent window, which is the
  right bias for serving latencies),
* :class:`BinnedHistogram` — fixed integer bins whose counts are produced
  elsewhere (typically a device-side reduction, e.g. the E8M0 scale-code
  histogram from ``telemetry.quant_health``) and set/merged wholesale,
* :class:`EwmaRate` — exponentially-weighted events/sec (half-life in
  seconds), for "tokens/sec right now" style gauges.

:class:`MetricsRegistry` is create-or-get by name with kind checking, and
renders two export formats: a JSON-able :meth:`snapshot` dict (consumed by
the sinks in ``telemetry.sinks`` — the JSON-lines stream and the benchmark
baseline both derive from it) and Prometheus text exposition
(:meth:`prometheus_text`).
"""

from __future__ import annotations

import bisect
import math
from collections import deque
from typing import Iterable

METRICS_SCHEMA = "repro.serve_metrics/v1"

# Cumulative-bucket ladder for the Prometheus exposition: log-spaced seconds
# covering everything we observe (10 µs ticks up to minute-scale request
# latencies; `tokens_per_decode_call` values land in the 1..32 decades).
DEFAULT_BUCKETS: tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    kind = "counter"
    __slots__ = ("help", "value")

    def __init__(self, help: str = ""):
        self.help = help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Gauge:
    kind = "gauge"
    __slots__ = ("help", "value")

    def __init__(self, help: str = ""):
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_max(self, v: float) -> None:
        """Peak-tracking update: keep the largest value ever set."""
        self.value = max(self.value, float(v))

    def set_min(self, v: float) -> None:
        """Trough-tracking update (e.g. free-page low watermark)."""
        self.value = min(self.value, float(v))


class Histogram:
    kind = "histogram"
    __slots__ = ("help", "count", "total", "vmin", "vmax", "_buf",
                 "buckets", "bucket_counts")

    def __init__(self, help: str = "", max_samples: int = 4096,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.help = help
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._buf: deque[float] = deque(maxlen=max_samples)
        # non-cumulative per-bucket counts; index len(buckets) is +Inf
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self._buf.append(v)
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1

    def percentile(self, q: float) -> float | None:
        """numpy-compatible linear interpolation over the retained samples
        (``np.quantile(xs, q)`` exactly while ``count <= max_samples``)."""
        if not self._buf:
            return None
        xs = sorted(self._buf)
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class BinnedHistogram:
    """Fixed integer bins set wholesale from an externally-computed count
    vector — the host-side face of a device-side histogram reduction."""

    kind = "binned"
    __slots__ = ("help", "n_bins", "counts", "samples")

    def __init__(self, n_bins: int, help: str = ""):
        self.help = help
        self.n_bins = n_bins
        self.counts = [0] * n_bins
        self.samples = 0  # number of set/merge calls that fed this histogram

    def set_counts(self, counts: Iterable[int]) -> None:
        """Replace with the latest sample (gauge-like: 'the pool right now')."""
        counts = [int(c) for c in counts]
        if len(counts) != self.n_bins:
            raise ValueError(f"expected {self.n_bins} bins, got {len(counts)}")
        self.counts = counts
        self.samples += 1

    def merge_counts(self, counts: Iterable[int]) -> None:
        """Accumulate (counter-like: 'everything ever observed')."""
        counts = [int(c) for c in counts]
        if len(counts) != self.n_bins:
            raise ValueError(f"expected {self.n_bins} bins, got {len(counts)}")
        self.counts = [a + b for a, b in zip(self.counts, counts)]
        self.samples += 1

    @property
    def nonzero_bins(self) -> int:
        return sum(1 for c in self.counts if c)

    def summary(self) -> dict:
        nz = [i for i, c in enumerate(self.counts) if c]
        return {
            "samples": self.samples,
            "total": sum(self.counts),
            "nonzero_bins": len(nz),
            "bin_min": nz[0] if nz else None,
            "bin_max": nz[-1] if nz else None,
            "counts": list(self.counts),
        }


class EwmaRate:
    """Exponentially-weighted events/sec.  ``mark(n, t)`` records ``n``
    events at time ``t``; the instantaneous rate over each inter-mark gap is
    blended with half-life ``halflife_s``.  Marks at a non-advancing clock
    accumulate into the next gap instead of dividing by zero."""

    kind = "ewma"
    __slots__ = ("help", "halflife_s", "_rate", "_last_t", "_pending")

    def __init__(self, halflife_s: float = 5.0, help: str = ""):
        self.help = help
        self.halflife_s = halflife_s
        self._rate: float | None = None
        self._last_t: float | None = None
        self._pending = 0.0

    def mark(self, n: float, t: float) -> None:
        if self._last_t is None:
            self._last_t = t
            self._pending = n
            return
        dt = t - self._last_t
        if dt <= 0:
            self._pending += n
            return
        inst = (self._pending + n) / dt
        alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
        self._rate = inst if self._rate is None else (
            self._rate + alpha * (inst - self._rate))
        self._last_t = t
        self._pending = 0.0

    @property
    def rate(self) -> float | None:
        return self._rate


class MetricsRegistry:
    """Create-or-get metric store.  Asking for an existing name with a
    different kind is a bug and raises; everything else is cheap dict ops."""

    def __init__(self, hist_max_samples: int = 4096):
        self._metrics: dict[str, object] = {}
        self._hist_max_samples = hist_max_samples
        self.meta: dict = {}  # static run context (arch, backend, …)

    def _get(self, name: str, cls, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(**kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(name, Histogram, help=help,
                         max_samples=self._hist_max_samples)

    def binned(self, name: str, n_bins: int, help: str = "") -> BinnedHistogram:
        return self._get(name, BinnedHistogram, n_bins=n_bins, help=help)

    def rate(self, name: str, halflife_s: float = 5.0, help: str = "") -> EwmaRate:
        return self._get(name, EwmaRate, halflife_s=halflife_s, help=help)

    def names(self, kind: str | None = None) -> list[str]:
        return sorted(n for n, m in self._metrics.items()
                      if kind is None or m.kind == kind)

    def reset(self) -> None:
        """Zero every metric in place (kinds and names survive — the schema
        is stable across a reset).  Used to drop warmup traffic from
        benchmark runs."""
        fresh = {}
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                fresh[name] = Counter(m.help)
            elif isinstance(m, Gauge):
                fresh[name] = Gauge(m.help)
            elif isinstance(m, Histogram):
                fresh[name] = Histogram(m.help, m._buf.maxlen, m.buckets)
            elif isinstance(m, BinnedHistogram):
                fresh[name] = BinnedHistogram(m.n_bins, m.help)
            elif isinstance(m, EwmaRate):
                fresh[name] = EwmaRate(m.halflife_s, m.help)
        self._metrics = fresh

    # -- exports ------------------------------------------------------------

    def snapshot(self, t: float = 0.0) -> dict:
        snap: dict = {"schema": METRICS_SCHEMA, "t": t,
                      "meta": dict(self.meta), "counters": {}, "gauges": {},
                      "histograms": {}, "binned": {}, "rates": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                snap["counters"][name] = m.value
            elif isinstance(m, Gauge):
                snap["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                snap["histograms"][name] = m.summary()
            elif isinstance(m, BinnedHistogram):
                snap["binned"][name] = m.summary()
            elif isinstance(m, EwmaRate):
                snap["rates"][name] = m.rate
        return snap

    def prometheus_text(self) -> str:
        """Prometheus-style text exposition (counters/gauges as-is,
        histograms as _count/_sum plus quantile-labelled gauges, binned
        histograms as le-labelled cumulative buckets)."""
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, EwmaRate):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {(m.rate or 0.0):g}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for bound, c in zip(m.buckets, m.bucket_counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{bound:g}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.total:g}")
                lines.append(f"{name}_count {m.count}")
            elif isinstance(m, BinnedHistogram):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for i, c in enumerate(m.counts):
                    if c:
                        cum += c
                        lines.append(f'{name}_bucket{{le="{i}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {sum(m.counts)}')
                lines.append(f"{name}_count {sum(m.counts)}")
        return "\n".join(lines) + "\n"


def merge_histograms(hists: list[Histogram]) -> Histogram:
    """Pool histograms sample-by-sample: counts/sums add, extrema combine,
    reservoirs concatenate (into a reservoir big enough to keep everything
    the sources retained), bucket counts add elementwise.  Percentiles of
    the merge are therefore computed over the POOLED samples — the
    statistically meaningful DP aggregate — not averaged per-source."""
    if not hists:
        raise ValueError("nothing to merge")
    first = hists[0]
    for h in hists[1:]:
        if h.buckets != first.buckets:
            raise ValueError("cannot merge histograms with different buckets")
    out = Histogram(first.help,
                    max_samples=max(1, sum(h._buf.maxlen for h in hists)),
                    buckets=first.buckets)
    for h in hists:
        out.count += h.count
        out.total += h.total
        out.vmin = min(out.vmin, h.vmin)
        out.vmax = max(out.vmax, h.vmax)
        out._buf.extend(h._buf)
        for i, c in enumerate(h.bucket_counts):
            out.bucket_counts[i] += c
    return out


def merge_registries(regs: list[MetricsRegistry]) -> MetricsRegistry:
    """Merge per-replica registries into one aggregate view (data-parallel
    serving: replicas handle disjoint traffic concurrently).

    * counters — summed,
    * gauges — ``*_peak``/``*_watermark`` keep their extreme (max / min
      respectively), everything else averages across replicas,
    * histograms — pooled via :func:`merge_histograms` (reservoirs and
      cumulative buckets concatenated/added, so aggregate percentiles are
      over all replicas' samples),
    * binned histograms — counts added elementwise,
    * EWMA rates — summed (replicas emit tokens concurrently).

    Metric names are unioned; a metric missing from some replicas merges
    over the replicas that have it.
    """
    if not regs:
        raise ValueError("nothing to merge")
    out = MetricsRegistry(hist_max_samples=regs[0]._hist_max_samples)
    out.meta = dict(regs[0].meta)
    out.meta["replicas"] = len(regs)
    names: dict[str, object] = {}
    for reg in regs:
        for name, m in reg._metrics.items():
            names.setdefault(name, m)
    for name, proto in sorted(names.items()):
        ms = [reg._metrics[name] for reg in regs if name in reg._metrics]
        if isinstance(proto, Counter):
            out.counter(name, proto.help).inc(sum(m.value for m in ms))
        elif isinstance(proto, Gauge):
            g = out.gauge(name, proto.help)
            if name.endswith("_peak"):
                g.set(max(m.value for m in ms))
            elif name.endswith("_watermark"):
                g.set(min(m.value for m in ms))
            else:
                g.set(sum(m.value for m in ms) / len(ms))
        elif isinstance(proto, Histogram):
            out._metrics[name] = merge_histograms(ms)
        elif isinstance(proto, BinnedHistogram):
            b = out.binned(name, proto.n_bins, proto.help)
            for m in ms:
                b.merge_counts(m.counts)
        elif isinstance(proto, EwmaRate):
            r = out.rate(name, proto.halflife_s, proto.help)
            rates = [m.rate for m in ms if m.rate is not None]
            r._rate = sum(rates) if rates else None
    return out
