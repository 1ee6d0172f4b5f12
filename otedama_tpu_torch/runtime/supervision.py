"""Per-device supervision: watchdog deadlines, quarantine, probes
(counterpart of ``otedama_tpu/runtime/supervision.py``).

A wedged card call never returns: an executor thread sits in the
backend's ``Event.synchronize()`` and nothing can cancel it. The only
honest recovery levers are (a) stop waiting, (b) stop dispatching to the
device, (c) periodically re-prove the device end to end before letting it
mine again. This module holds the per-device half of that design; the
engine (``engine/engine.py``) owns dispatch and the async lifecycle:

- ``DeviceSupervisor``: one per engine backend. Tracks an EWMA of call
  durations per call key (a grouped dispatch's key is its total lane
  count) and derives the watchdog deadline the engine arms on every
  dispatch (EWMA x multiplier with a floor; a large first-call deadline
  covers a cold first call, which may include the kernel build by
  ``nvcc`` through ``kernels/cuda_build.py``). Owns the HEALTHY ->
  SUSPECT -> QUARANTINED -> PROBING -> (HEALTHY | DEAD) state machine and
  the counters the snapshot exports. The quarantine is the device's
  circuit breaker: open while QUARANTINED, half-open during a probe,
  closed again on reintegration.
- probe helpers: a fixed easy-target probe job plus an exact host oracle
  (``utils.pow_host.pow_digest``) that a reintegration probe's device
  results must match bit for bit before the device rejoins — a device
  that answers quickly but WRONGLY (the ``corrupt`` fault mode, or real
  silent data corruption) stays quarantined.
- ``corrupt_result``: the wrong-result arm of the ``device.call`` fault
  point (``utils/faults``): winner digests are inverted past the device
  filter, what a flipped bit in device memory would produce.
- ``probe_cuda_devices``: per-device liveness probe on daemon threads (a
  wedged device's probe must not block process exit), for the rebuild
  of a multi-device backend over the devices that still answer.
"""

from __future__ import annotations

import enum
import struct
import threading
import time

from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.runtime.search import JobConstants, SearchResult, Winner
from otedama_tpu_torch.utils.histogram import LatencyHistogram

__all__ = [
    "DeviceHungError",
    "DeviceState",
    "DeviceSupervisor",
    "PROBE_BASE",
    "corrupt_result",
    "expected_probe_winners",
    "probe_cuda_devices",
    "probe_job_constants",
    "verify_probe_results",
]


class DeviceState(enum.Enum):
    HEALTHY = "healthy"          # mining; watchdog armed per dispatch
    SUSPECT = "suspect"          # deadline blown; detaching the searcher
    QUARANTINED = "quarantined"  # circuit open: no work dispatched
    PROBING = "probing"          # half-open: one verified probe in flight
    DEAD = "dead"                # probe budget exhausted; needs operator


class DeviceHungError(Exception):
    """A device call blew its watchdog deadline (the searcher detaches;
    the call itself keeps running on its executor thread and its late
    result is discarded)."""


# device calls run from milliseconds (one launch) to minutes (a cold
# build) — a wider ladder than the share-latency default
_CALL_BUCKETS = (
    0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0,
)

_EWMA_ALPHA = 0.3


class DeviceSupervisor:
    """State machine + call-duration model for ONE engine backend.

    ``observe_call`` runs on executor threads (under ``_lock``); every
    state transition happens on the event loop, so transitions need no
    lock of their own. ``cfg`` is the engine's live EngineConfig —
    shared by reference so runtime knob changes apply immediately.
    """

    def __init__(self, name: str, cfg):
        self.name = name
        self.cfg = cfg
        self.state = DeviceState.HEALTHY
        # counters (cumulative; exported via snapshot)
        self.quarantines = 0
        self.watchdog_timeouts = 0
        self.abandoned_calls = 0
        self.searcher_restarts = 0
        self.probes = 0                 # probe attempts, cumulative
        self.probes_failed = 0          # CONSECUTIVE failures this incident
        self.reintegrations = 0
        self.last_error: str | None = None
        self.quarantined_at = 0.0
        self.call_hist = LatencyHistogram(_CALL_BUCKETS)
        self.transitions: list[dict] = []
        self._ewma: dict[object, tuple[float, int]] = {}
        self._lock = threading.Lock()

    # -- call-duration model -------------------------------------------------

    def observe_call(self, key, seconds: float) -> None:
        """Feed one completed call (executor thread). MINING samples
        observed while the device is not mining-healthy are kept out of
        the EWMA: a wedged call that finally lands minutes later must
        not loosen the deadline the device will face after
        reintegration. Probe-shaped samples always record — a completed
        probe is by definition a valid duration for its own key, and
        ``has_samples`` on it is what retires the first-probe deadline
        allowance."""
        self.call_hist.observe(seconds)
        is_probe = isinstance(key, tuple) and key and key[0] == "probe"
        if not is_probe and self.state not in (
                DeviceState.HEALTHY, DeviceState.SUSPECT):
            return
        with self._lock:
            value, n = self._ewma.get(key, (0.0, 0))
            value = seconds if n == 0 else (
                _EWMA_ALPHA * seconds + (1 - _EWMA_ALPHA) * value
            )
            self._ewma[key] = (value, n + 1)

    def has_samples(self, key) -> bool:
        """Whether any call of this key has completed (a first probe may
        pay a cold build and gets the first-call deadline allowance)."""
        with self._lock:
            return key in self._ewma

    def deadline(self, key) -> float:
        """Watchdog deadline for the next call of this key: EWMA x
        multiplier, floored; until the EWMA has enough samples the
        first-call deadline applies. multiplier <= 0 disables the
        watchdog entirely."""
        cfg = self.cfg
        if cfg.watchdog_multiplier <= 0:
            return float("inf")
        with self._lock:
            entry = self._ewma.get(key)
        if entry is None or entry[1] < cfg.watchdog_min_samples:
            return max(cfg.watchdog_first_deadline, cfg.watchdog_floor)
        return max(cfg.watchdog_floor, entry[0] * cfg.watchdog_multiplier)

    # -- state machine -------------------------------------------------------

    def _transition(self, state: DeviceState, reason: str) -> None:
        self.state = state
        self.transitions.append({
            "at": round(time.time(), 3),
            "state": state.value,
            "reason": reason,
        })
        del self.transitions[:-8]

    @property
    def can_mine(self) -> bool:
        return self.state in (DeviceState.HEALTHY, DeviceState.SUSPECT)

    def on_hung(self, reason: str) -> None:
        """Blown watchdog deadline: SUSPECT for the record, then the
        circuit opens (QUARANTINED) — one blown deadline is the threshold
        because the deadline already embeds the multiplier's slack over
        the measured call-duration model."""
        self.last_error = reason
        self._transition(DeviceState.SUSPECT, reason)
        self._transition(DeviceState.QUARANTINED, "circuit opened")
        self.quarantines += 1
        self.probes_failed = 0
        self.quarantined_at = time.time()

    def next_probe_delay(self) -> float:
        """Exponential backoff between reintegration probes."""
        return min(
            self.cfg.probe_backoff * (2 ** self.probes_failed),
            self.cfg.probe_backoff_max,
        )

    def begin_probe(self) -> None:
        self.probes += 1
        self._transition(DeviceState.PROBING, f"probe #{self.probes}")

    def probe_failed(self, reason: str) -> None:
        self.last_error = reason
        self.probes_failed += 1
        self._transition(
            DeviceState.QUARANTINED, f"probe failed: {reason}"
        )

    def probe_interrupted(self) -> None:
        """A relayout cancelled the in-flight probe (not a verdict on the
        device): back to QUARANTINED, recorded in the audit trail,
        without consuming probe budget."""
        if self.state is DeviceState.PROBING:
            self._transition(
                DeviceState.QUARANTINED, "probe cancelled by relayout"
            )

    def reintegrate(self) -> None:
        self.probes_failed = 0
        self.reintegrations += 1
        self._transition(DeviceState.HEALTHY, "probe verified; reintegrated")

    def mark_dead(self) -> None:
        self._transition(
            DeviceState.DEAD,
            f"probe budget exhausted ({self.probes_failed} consecutive)",
        )

    def reset_state(self) -> None:
        """Engine (re)start: a full restart is itself a recovery action,
        so every device gets a fresh chance; cumulative counters stay."""
        self.probes_failed = 0
        if self.state is not DeviceState.HEALTHY:
            self._transition(DeviceState.HEALTHY, "engine restart")

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "state": self.state.value,
            "quarantines": self.quarantines,
            "watchdog_timeouts": self.watchdog_timeouts,
            "abandoned_calls": self.abandoned_calls,
            "searcher_restarts": self.searcher_restarts,
            "probes": self.probes,
            "consecutive_probe_failures": self.probes_failed,
            "reintegrations": self.reintegrations,
            "last_error": self.last_error,
            "call_seconds": {
                "buckets": self.call_hist.cumulative(),
                "sum": self.call_hist.sum,
                "count": self.call_hist.count,
            },
            "transitions": list(self.transitions),
        }


# -- probe construction + verification ----------------------------------------

# nonce base for probe batches: arbitrary but fixed, away from 0 so a
# backend that ignores `base` cannot pass by accident
PROBE_BASE = 0x00400000

# ~1 winner per 16 nonces: a probe batch is guaranteed winners to verify,
# and a corrupt/fabricating device is guaranteed a mismatch
_PROBE_TARGET = (1 << 252) - 1


def probe_job_constants(algorithm: str = "sha256d") -> JobConstants:
    """Fixed synthetic probe job with an easy target. STABLE bytes per
    algorithm (the name is folded into the header, so probe jobs are
    distinguishable across algorithms), so probe timings stay comparable
    across incidents."""
    tag = f"otedama-tpu/probe/{algorithm}".encode()[:64]
    header76 = tag + bytes(range(64 - len(tag))) + struct.pack(
        ">3I", 0x20000000, 0x6530D1B7, 0x1D00FFFF
    )
    return JobConstants.from_header_prefix(header76, target=_PROBE_TARGET)


# probe jobs are deliberately stable per algorithm, so the oracle winner
# set for a (job, range) never changes — cache it: probe retries fire as
# often as probe_backoff, and host scrypt digests are orders of magnitude
# pricier than sha256d
_EXPECTED_CACHE: dict[tuple, dict[int, bytes]] = {}


def expected_probe_winners(
    algorithm: str, jc: JobConstants, base: int, count: int
) -> dict[int, bytes]:
    """The exact host-oracle winner set for a probe range: nonce_word ->
    digest, computed independently of any device path."""
    from otedama_tpu_torch.utils.pow_host import pow_digests

    key = (algorithm, jc.header76, jc.target, jc.block_number, base, count)
    cached = _EXPECTED_CACHE.get(key)
    if cached is not None:
        return cached
    out: dict[int, bytes] = {}
    nonces = [(base + i) & 0xFFFFFFFF for i in range(count)]
    digests = pow_digests([jc.header_for(w) for w in nonces], algorithm,
                          jc.block_number)
    for w, digest in zip(nonces, digests):
        if tgt.hash_meets_target(digest, jc.target):
            out[w] = digest
    if len(_EXPECTED_CACHE) >= 32:  # bound: one entry per (algo, shape);
        # evict ONE entry, not the whole cache — a mixed-algorithm
        # deployment must not thrash its expensive scrypt entries
        _EXPECTED_CACHE.pop(next(iter(_EXPECTED_CACHE)))
    _EXPECTED_CACHE[key] = out
    return out


# algorithms whose host oracle (pow_digest) holds for ANY backend
# configuration. Any other algorithm's probe is verified structurally:
# ethash's backends pin an epoch context (possibly a miniature test epoch)
# that the height-0 oracle cannot reproduce, as in the reference.
_ORACLE_ALGORITHMS = frozenset({"sha256d", "sha256", "scrypt", "x11"})


def verify_probe_results(
    algorithm: str, jc: JobConstants, results, base: int, count: int
) -> bool:
    """True iff EVERY returned row matches the host oracle exactly —
    same winner set, same digests. Exactness (not subset) is the point:
    a device that silently drops winners is as broken as one that
    fabricates them. Algorithms outside the oracle set fall back to
    structural verification: well-formed rows whose winners sit inside
    the probed range and whose digests meet the probe target (enough to
    catch hangs, crashes and digest corruption; not wrong-but-plausible
    winners)."""
    rows = results if isinstance(results, list) else [results]
    if not rows:
        return False
    if algorithm not in _ORACLE_ALGORITHMS:
        for res in rows:
            if not isinstance(res, SearchResult):
                return False
            for w in res.winners:
                if not (base <= w.nonce_word < base + count):
                    return False
                if len(w.digest) != 32:
                    return False
                if not tgt.hash_meets_target(w.digest, jc.target):
                    return False
        return True
    expected = expected_probe_winners(algorithm, jc, base, count)
    for res in rows:
        got = {w.nonce_word: w.digest for w in res.winners}
        if set(got) != set(expected):
            return False
        if any(expected[n] != d for n, d in got.items()):
            return False
    return True


def corrupt_result(obj):
    """Wrong-result fault mode (``device.call`` corrupt action): invert
    every winner digest; a winnerless result grows one fabricated
    worst-difficulty winner so the corruption is observable either way.
    Recurses through the tuple/list shapes device calls return."""
    if isinstance(obj, tuple):
        return tuple(corrupt_result(x) for x in obj)
    if isinstance(obj, list):
        return [corrupt_result(x) for x in obj]
    if isinstance(obj, SearchResult):
        winners = [
            Winner(w.nonce_word, bytes(b ^ 0xFF for b in w.digest))
            for w in obj.winners
        ]
        if not winners:
            winners = [Winner(0xDEADBEEF, b"\xff" * 32)]
        return SearchResult(winners, obj.hashes, obj.best_hash_hi)
    return obj


def _round_trip(device) -> int:
    """One value to ``device`` and back. On a card the copies run on a
    stream of their own, from and to pinned buffers, and nothing else:
    work on the legacy default stream, or a kernel launch (which may load
    its module first), can wait for every stream of the card — a stream
    held by a wedged call included — and stall the other streams' work
    queued behind it meanwhile."""
    import torch

    src = torch.ones(1, dtype=torch.int32)
    if device.type != "cuda":
        return int(src.to(device)[0])
    stream = torch.cuda.Stream(device)
    src = src.pin_memory()
    back = torch.empty(1, dtype=torch.int32).pin_memory()
    with torch.cuda.stream(stream):
        back.copy_(src.to(device, non_blocking=True), non_blocking=True)
    stream.synchronize()
    return int(back[0])


def probe_cuda_devices(devices, timeout: float = 10.0) -> list:
    """Survivor census over individual torch devices: round-trip one
    value through each. All probes launch CONCURRENTLY and join against
    one shared deadline, so N wedged devices cost ~timeout, not N x
    timeout. Daemon threads — a wedged device's probe thread must never
    block interpreter exit. Returns the devices that answered, in their
    order."""
    import torch

    results: dict[int, list] = {}
    threads: list[threading.Thread] = []
    for i, device in enumerate(devices):
        done = results[i] = []

        def _touch(d=torch.device(device), out=done):
            out.append(_round_trip(d))

        t = threading.Thread(
            target=_touch, daemon=True, name=f"probe-{device}"
        )
        t.start()
        threads.append(t)
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    return [d for i, d in enumerate(devices) if results[i]]
