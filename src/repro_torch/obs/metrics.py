"""Typed metrics: Counter / Gauge / Histogram under one registry lock.

The serving stack previously kept telemetry as plain ints mutated under
four different component locks, each exported by a hand-rolled
``stats()`` dict.  This module is the one typed substrate those surfaces
are now views over:

* **Counter** — monotone float/int accumulator (``inc``).
* **Gauge** — set/add instantaneous value (``set`` / ``inc`` / ``dec``).
* **Histogram** — log-bucketed latency distribution that also keeps the
  raw samples (up to ``max_samples``) so the benchmark-facing quantile
  API (``p50``/``p95``/``p99``/``summary``/``histogram``) stays *exact*
  for benchmark-sized runs and degrades to bucket interpolation only
  past the cap.  Histograms with equal bucket edges are mergeable
  (multi-replica aggregation).

Every instrument created through a :class:`MetricsRegistry` shares the
registry's single lock, so ``snapshot()`` / ``to_json()`` /
``to_prometheus()`` observe one consistent instant across *all*
instruments — the property the four component ``stats()`` snapshots had
individually but never jointly.  Instruments are keyed by ``(name,
label set)``: asking twice returns the same object, which is how
component compat properties stay cheap views.

A :class:`Histogram` constructed directly (no registry) carries its own
lock — that is the drop-in replacement for the old
``benchmarks.common.LatencyRecorder``.
"""

from __future__ import annotations

import json
import math
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

# default log-spaced bucket grid: 24 edges over [10us, 100s] — the same
# export grid the benchmarks' LatencyRecorder.histogram() used
DEFAULT_N_BUCKETS = 24
DEFAULT_LO = 1e-5
DEFAULT_HI = 100.0


def _log_edges(lo: float, hi: float, n: int) -> list[float]:
    """``n`` log-spaced bucket upper edges from ``lo`` to ``hi``."""
    if not 0 < lo < hi or n < 2:
        raise ValueError(f"need 0 < lo < hi and n >= 2, got "
                         f"({lo}, {hi}, {n})")
    llo, lhi = math.log10(lo), math.log10(hi)
    return [10.0 ** (llo + (lhi - llo) * i / (n - 1)) for i in range(n)]


def _labels_key(labels: dict | None) -> tuple:
    """Canonical hashable form of a label set."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared identity plumbing: name, labels, and the owning lock."""

    kind = "instrument"

    def __init__(self, name: str, labels: dict | None = None,
                 help: str = "", _lock: threading.Lock | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        self._lock = _lock if _lock is not None else threading.Lock()


class Counter(_Instrument):
    """Monotone accumulator; ``inc`` with a negative amount is refused."""

    kind = "counter"

    def __init__(self, name: str, labels: dict | None = None,
                 help: str = "", _lock: threading.Lock | None = None):
        super().__init__(name, labels, help, _lock)
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        """Current cumulative value."""
        with self._lock:
            return self._value

    def _read_locked(self) -> dict:
        return {"value": self._value}


class Gauge(_Instrument):
    """Instantaneous value: settable, incrementable, decrementable."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict | None = None,
                 help: str = "", _lock: threading.Lock | None = None):
        super().__init__(name, labels, help, _lock)
        self._value = 0

    def set(self, v: int | float) -> None:
        """Replace the gauge value."""
        with self._lock:
            self._value = v

    def inc(self, n: int | float = 1) -> None:
        """Add ``n`` (may be negative)."""
        with self._lock:
            self._value += n

    def dec(self, n: int | float = 1) -> None:
        """Subtract ``n``."""
        with self._lock:
            self._value -= n

    @property
    def value(self) -> int | float:
        """Current value."""
        with self._lock:
            return self._value

    def _read_locked(self) -> dict:
        return {"value": self._value}


class Histogram(_Instrument):
    """Log-bucketed, mergeable distribution with exact-sample quantiles.

    Drop-in for the former ``benchmarks.common.LatencyRecorder``: the
    ``record`` / ``observe`` / ``quantile`` / ``p50`` / ``p95`` /
    ``p99`` / ``summary()`` / ``histogram()`` surface is preserved
    byte-for-byte for runs under ``max_samples`` samples.  Past the cap
    the raw samples stop growing (bounded memory in a long-lived
    serving process) and quantiles interpolate inside the maintained
    log buckets instead — count / sum / min / max stay exact forever.
    """

    kind = "histogram"

    def __init__(self, name: str = "latency", labels: dict | None = None,
                 help: str = "", lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI,
                 n_buckets: int = DEFAULT_N_BUCKETS,
                 max_samples: int = 200_000,
                 _lock: threading.Lock | None = None):
        super().__init__(name, labels, help, _lock)
        self.edges = _log_edges(lo, hi, n_buckets)
        # counts has one overflow slot past the last edge
        self.counts = [0] * (n_buckets + 1)
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -----------------------------------------------------
    def _bucket_index(self, v: float) -> int:
        """Leftmost bucket whose upper edge is >= v (bisect, no numpy)."""
        lo, hi = 0, len(self.edges)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.edges[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def record(self, v: float) -> None:
        """Fold one sample (seconds, for latency histograms) in."""
        v = float(v)
        with self._lock:
            self._record_locked(v)

    def _record_locked(self, v: float) -> None:
        self.counts[self._bucket_index(v)] += 1
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)

    def observe(self, t0: float, t1: float) -> None:
        """Record the interval ``t1 - t0``."""
        self.record(t1 - t0)

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram (identical edges) into this one."""
        if other.edges != self.edges:
            raise ValueError(
                f"cannot merge histograms with different bucket edges "
                f"({self.name} vs {other.name})")
        if other._lock is self._lock:  # same registry: one acquisition
            with self._lock:
                self._merge_locked(list(other.counts),
                                   list(other._samples), other._count,
                                   other._sum, other._min, other._max)
            return self
        with other._lock:
            counts = list(other.counts)
            samples = list(other._samples)
            count, total = other._count, other._sum
            mn, mx = other._min, other._max
        with self._lock:
            self._merge_locked(counts, samples, count, total, mn, mx)
        return self

    def _merge_locked(self, counts, samples, count, total, mn, mx):
        """Fold copied peer state in (our lock held)."""
        for i, c in enumerate(counts):
            self.counts[i] += c
        self._count += count
        self._sum += total
        self._min = min(self._min, mn)
        self._max = max(self._max, mx)
        room = self.max_samples - len(self._samples)
        if room > 0:
            self._samples.extend(samples[:room])

    # -- reading -------------------------------------------------------
    def __len__(self) -> int:
        """Total recorded samples."""
        with self._lock:
            return self._count

    @property
    def samples(self) -> list[float]:
        """Raw recorded samples (truncated at ``max_samples``)."""
        with self._lock:
            return list(self._samples)

    @property
    def count(self) -> int:
        """Total recorded samples (never truncated)."""
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        """Exact sum of all recorded samples."""
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """The q-quantile: exact from samples when none were dropped,
        log-interpolated inside the maintained buckets otherwise."""
        with self._lock:
            if self._count == 0:
                return float("nan")
            if len(self._samples) == self._count:
                s = sorted(self._samples)
                # linear interpolation between order statistics — matches
                # np.quantile's default for the benchmark-compat surface
                pos = q * (len(s) - 1)
                i = int(math.floor(pos))
                frac = pos - i
                if i + 1 >= len(s):
                    return float(s[-1])
                return float(s[i] * (1 - frac) + s[i + 1] * frac)
            return self._bucket_quantile_locked(q)

    def _bucket_quantile_locked(self, q: float) -> float:
        target = q * self._count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target:
                lo = self.edges[i - 1] if i > 0 else min(
                    self._min, self.edges[0])
                hi = self.edges[i] if i < len(self.edges) else self._max
                frac = (target - seen) / max(c, 1)
                return float(lo + (hi - lo) * frac)
            seen += c
        return float(self._max)

    @property
    def p50(self) -> float:
        """Median."""
        return self.quantile(0.50)

    @property
    def p95(self) -> float:
        """95th percentile."""
        return self.quantile(0.95)

    @property
    def p99(self) -> float:
        """99th percentile."""
        return self.quantile(0.99)

    def summary(self) -> dict:
        """p50/p95/p99 + count/mean/max, keys flat for ``emit`` rows."""
        with self._lock:
            if self._count == 0:
                return {"count": 0, "mean_s": float("nan"),
                        "p50_s": float("nan"), "p95_s": float("nan"),
                        "p99_s": float("nan"), "max_s": float("nan")}
            count, total, mx = self._count, self._sum, self._max
        return {
            "count": int(count),
            "mean_s": float(total / count),
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
            "max_s": float(mx),
        }

    def histogram(self, n_buckets: int = DEFAULT_N_BUCKETS,
                  lo_s: float = DEFAULT_LO,
                  hi_s: float = DEFAULT_HI) -> dict:
        """Log-spaced export (bucket upper edges in seconds -> counts;
        samples above ``hi_s`` land in the final overflow bucket).

        Recomputed from raw samples at the requested grid while none
        were dropped; afterwards the maintained grid is returned (its
        own edges) — re-binning lossy bucket counts would fake
        precision.
        """
        with self._lock:
            complete = len(self._samples) == self._count
            samples = list(self._samples)
            if not complete:
                return {"edges_s": list(self.edges),
                        "counts": list(self.counts)}
        edges = _log_edges(lo_s, hi_s, n_buckets)
        counts = [0] * (n_buckets + 1)
        for v in samples:
            lo, hi = 0, len(edges)
            while lo < hi:
                mid = (lo + hi) // 2
                if edges[mid] < v:
                    lo = mid + 1
                else:
                    hi = mid
            counts[lo] += 1
        return {"edges_s": edges, "counts": counts}

    def _read_locked(self) -> dict:
        return {
            "count": self._count,
            "sum": self._sum,
            "min": None if self._count == 0 else self._min,
            "max": None if self._count == 0 else self._max,
            "edges": list(self.edges),
            "counts": list(self.counts),
        }


class MetricsRegistry:
    """Process-local instrument registry with one shared lock.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create by ``(name,
    labels)`` — a second caller with the same identity receives the
    *same* object (so e.g. the FrontDesk compat properties and the
    Prometheus endpoint read one counter, not two copies).  All
    instruments share the registry lock: ``snapshot()`` and both
    exporters are globally consistent cuts.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[tuple, _Instrument] = {}

    def _get(self, cls, name: str, labels: dict | None, help: str,
             **kwargs) -> _Instrument:
        key = (name, _labels_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels=labels, help=help,
                           _lock=self._lock, **kwargs)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r}{labels or {}} already registered "
                    f"as {inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, labels: dict | None = None,
                help: str = "") -> Counter:
        """Get-or-create a :class:`Counter`."""
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: dict | None = None,
              help: str = "") -> Gauge:
        """Get-or-create a :class:`Gauge`."""
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: dict | None = None,
                  help: str = "", **kwargs) -> Histogram:
        """Get-or-create a :class:`Histogram` (extra kwargs configure
        bucket edges on first creation only)."""
        return self._get(Histogram, name, labels, help, **kwargs)

    def instruments(self, name: str | None = None) -> list[_Instrument]:
        """All registered instruments (optionally filtered by name)."""
        with self._lock:
            return [i for i in self._instruments.values()
                    if name is None or i.name == name]

    def snapshot(self) -> dict:
        """One consistent cut: ``{name{labels}: reading}`` for every
        instrument, taken atomically under the registry lock."""
        with self._lock:
            out = {}
            for (name, lkey), inst in sorted(self._instruments.items()):
                label_s = ",".join(f"{k}={v}" for k, v in lkey)
                key = f"{name}{{{label_s}}}" if label_s else name
                out[key] = {"kind": inst.kind, **inst._read_locked()}
            return out

    def to_json(self) -> str:
        """The snapshot as a JSON document (machine-readable export)."""
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one consistent cut).

        Names are sanitized to ``[a-zA-Z_:][a-zA-Z0-9_:]*``; histograms
        emit the standard cumulative ``_bucket{le=...}`` series plus
        ``_sum`` and ``_count``.
        """
        with self._lock:
            by_name: dict[str, list[_Instrument]] = {}
            for inst in self._instruments.values():
                by_name.setdefault(inst.name, []).append(inst)
            lines: list[str] = []
            for name in sorted(by_name):
                insts = by_name[name]
                pname = _prom_name(name)
                if insts[0].help:
                    lines.append(f"# HELP {pname} {insts[0].help}")
                lines.append(f"# TYPE {pname} {insts[0].kind}")
                for inst in insts:
                    lines.extend(_prom_series_locked(pname, inst))
            return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    """Sanitize a dotted metric name for Prometheus exposition."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    """Render one ``{k="v",...}`` label block ('' when empty)."""
    items = {**labels, **(extra or {})}
    if not items:
        return ""
    body = ",".join(
        f'{_prom_name(str(k))}="{_escape(str(v))}"'
        for k, v in sorted(items.items()))
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _prom_series_locked(pname: str, inst: _Instrument) -> list[str]:
    """One instrument's exposition lines (registry lock held)."""
    if isinstance(inst, Histogram):
        r = inst._read_locked()
        lines = []
        acc = 0
        for edge, c in zip(r["edges"], r["counts"]):
            acc += c
            lines.append(f"{pname}_bucket"
                         f"{_prom_labels(inst.labels, {'le': repr(edge)})}"
                         f" {acc}")
        lines.append(f"{pname}_bucket"
                     f"{_prom_labels(inst.labels, {'le': '+Inf'})}"
                     f" {r['count']}")
        lines.append(f"{pname}_sum{_prom_labels(inst.labels)} {r['sum']}")
        lines.append(f"{pname}_count{_prom_labels(inst.labels)}"
                     f" {r['count']}")
        return lines
    return [f"{pname}{_prom_labels(inst.labels)} "
            f"{inst._read_locked()['value']}"]
