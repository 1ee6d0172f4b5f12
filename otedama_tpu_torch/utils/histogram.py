"""Cumulative-bucket latency histogram for hot paths (counterpart of
``otedama_tpu/utils/histogram.py``, copied whole; the consumers named
below are the reference's, which the port carries as their slices land).

One shape shared by everything that measures a latency distribution:
fixed upper bounds, CUMULATIVE per-bucket counts (Prometheus ``le``
semantics — `api/metrics.py` ``histogram_set`` consumes the dict
as-is), a running sum/count, and bucket-resolution quantiles. The
stratum client grew this ad hoc (`stratum/client.py latency_buckets`);
the pool servers' share-accept SLO histogram uses this class so both
sides of the wire export the same family shape.

``observe`` is a few adds under a lock — cheap enough for per-share
use on the event loop. The lock matters because readers (metrics loop,
bench tools) run on other threads.

The sharded stratum front-end (stratum/shard.py) adds a second
consumer shape: each acceptor worker process exports its histogram as
a plain-data ``state()`` dict over the share bus, and the supervisor
rebuilds (``from_state``) and ``merge``s them into the one histogram
`/metrics` exports — bucket-wise sums are exact for cumulative
fixed-bound histograms, so the merged quantiles are as truthful as any
single process's. ``merge_counters`` is the companion for the workers'
stats dicts.
"""

from __future__ import annotations

import threading

# upper bounds (seconds) bracketing the reference's 50 ms share-accept
# target (README.md:104) — same ladder the stratum client exports
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0
)


class LatencyHistogram:
    """Thread-safe fixed-bucket histogram with cumulative counts."""

    __slots__ = ("bounds", "_counts", "sum", "count", "_lock")

    def __init__(self, bounds: tuple[float, ...] = DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        self._counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.sum += seconds
            self.count += 1
            # cumulative: every bucket whose bound >= value ticks
            for i in range(len(self.bounds) - 1, -1, -1):
                if seconds <= self.bounds[i]:
                    self._counts[i] += 1
                else:
                    break

    def cumulative(self) -> dict[float, int]:
        """bound -> cumulative count (``le`` semantics); +Inf is implied
        by ``count`` (histogram_set adds it)."""
        with self._lock:
            return dict(zip(self.bounds, self._counts))

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (a
        conservative estimate: the true quantile is <= the returned
        bound). +Inf overflow returns float('inf'); empty returns 0."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = q * self.count
            for bound, cum in zip(self.bounds, self._counts):
                if cum >= rank:
                    return bound
            return float("inf")

    def snapshot(self) -> dict:
        """Compact form for server ``snapshot()`` surfaces."""
        with self._lock:
            count, total = self.count, self.sum
        return {
            "count": count,
            "sum_seconds": round(total, 6),
            "avg_ms": round(1e3 * total / count, 3) if count else 0.0,
            "p50_ms": 1e3 * self.quantile(0.5),
            "p99_ms": 1e3 * self.quantile(0.99),
        }

    # -- cross-process aggregation (sharded front-end) -----------------------

    def state(self) -> dict:
        """Plain-data form that survives a process boundary (the share
        bus ships it as JSON): bounds, per-bucket cumulative counts, and
        the running sum/count."""
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "sum": self.sum,
                "count": self.count,
            }

    @classmethod
    def from_state(cls, state: dict) -> "LatencyHistogram":
        """Rebuild a histogram from ``state()`` output, validating shape
        (a malformed worker snapshot must fail loudly, not corrupt the
        merged SLO surface)."""
        bounds = tuple(float(b) for b in state["bounds"])
        counts = [int(c) for c in state["counts"]]
        if len(counts) != len(bounds):
            raise ValueError(
                f"histogram state has {len(counts)} counts for "
                f"{len(bounds)} bounds"
            )
        if any(c < 0 for c in counts):
            raise ValueError("histogram counts must be non-negative")
        h = cls(bounds)
        h._counts = counts
        h.sum = float(state["sum"])
        h.count = int(state["count"])
        return h

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Bucket-wise sum of ``other`` into this histogram. Bounds must
        match exactly — cumulative counts over different ladders are not
        summable, and silently merging them would fabricate quantiles.
        Returns self for chaining over worker snapshots."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge histograms with different bounds: "
                f"{self.bounds} vs {other.bounds}"
            )
        with other._lock:
            counts = list(other._counts)
            osum, ocount = other.sum, other.count
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.sum += osum
            self.count += ocount
        return self


def merge_counters(dst: dict, src: dict) -> dict:
    """Merge one stats dict into another, summing numeric counters:
    ints/floats add (bools are NOT counters — first writer wins), nested
    dicts merge recursively (``share_rejects{reason}`` style families),
    and non-numeric leaves keep the first value seen. Mutates and
    returns ``dst`` so worker snapshots fold left into one surface."""
    for key, value in src.items():
        if isinstance(value, dict):
            cur = dst.setdefault(key, {})
            if isinstance(cur, dict):
                merge_counters(cur, value)
            # a type clash keeps dst's value: one worker's malformed
            # snapshot must not clobber the merged family
        elif isinstance(value, bool) or not isinstance(value, (int, float)):
            dst.setdefault(key, value)
        else:
            cur = dst.get(key, 0)
            if isinstance(cur, bool) or not isinstance(cur, (int, float)):
                cur = 0
            dst[key] = cur + value
    return dst
