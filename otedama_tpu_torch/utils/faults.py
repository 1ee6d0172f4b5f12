"""Deterministic fault injection: named fault points + seeded fault plans
(counterpart of ``otedama_tpu/utils/faults.py``).

A process-global ``FaultInjector`` holds composable rules that fire at
named fault points threaded through the hot seams, and the whole schedule
derives from one seed, so a failing chaos run replays exactly. The port
carries the injector whole; ``REGISTRY`` lists only the points its
modules thread so far (the rest arrive with their slices).

Design constraints, in order:

1. **No-op when off.** The default path is one module-global load and a
   ``None`` check (``hit()`` returns immediately); no rule matching, no
   string formatting, no allocation. Production code pays nothing.
2. **Deterministic per point.** Each (rule, point) pair owns a dedicated
   ``random.Random`` seeded from (injector seed, rule index, point key),
   and every-Nth / one-shot schedules count per-point hits — so the fault
   pattern at a point depends only on the seed and that point's own hit
   sequence, never on cross-point async interleaving. Time-window rules
   are the one exception: they gate on wall time since ``activate()``.
3. **Call sites stay honest.** The injector never mutates state behind a
   caller's back: it raises injected errors directly, but drop / truncate
   / delay / corrupt come back as a ``Directive`` the call site applies.

Usage (tests / chaos drivers):

    inj = (FaultInjector(seed=1337)
           .error("validation.verify:sha256d", once=True)
           .delay("ledger.flush", seconds=2.0, window=(1.0, 3.0)))
    with active(inj):
        ... run the scenario ...
    print(inj.snapshot())   # per-point hit/fault counters
"""

from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import random
import threading
import time
from contextlib import contextmanager
from typing import Callable

__all__ = [
    "DEVICE",
    "Directive",
    "FaultInjectedError",
    "FaultInjector",
    "FaultPoint",
    "FaultRule",
    "POINT",
    "REGISTRY",
    "SEND_ASYNC",
    "SEND_SYNC",
    "STEP",
    "activate",
    "active",
    "deactivate",
    "get",
    "hit",
    "snapshot_active",
]


class FaultInjectedError(Exception):
    """Default exception raised by ``error`` rules."""


# What a call site can actually apply. A rule whose action a point does
# not support is SKIPPED (not counted as fired): a chaos run must never
# report a fault as injected when the seam silently ignored it.
POINT = frozenset({"error", "crash", "delay"})        # reads/checks/execs
STEP = frozenset({"error", "crash", "delay", "drop"})  # skippable steps
SEND_ASYNC = frozenset({"error", "crash", "delay", "drop", "truncate"})
SEND_SYNC = frozenset({"error", "crash", "drop", "truncate"})
# device calls on executor threads: delay = hang (sleeps the worker
# thread, the watchdog's target failure), error = backend crash,
# corrupt = wrong results past the device filter (silent data error)
DEVICE = frozenset({"error", "crash", "delay", "corrupt"})
# market feed fetches: a lossy+lying API (profit/feeds.py FEED_ACTIONS
# aliases this) — drop ages data toward staleness, corrupt feeds the
# sanitizer garbage, but a feed can't short-write (no truncate)
FEED = frozenset({"error", "crash", "delay", "drop", "corrupt"})


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One registered fault point. ``supports`` is the EXACT action set
    the call site passes to ``hit()`` — a chaos plan naming any other
    action at this point would be silently skipped."""

    point: str
    location: str    # module + seam, matching the docs table's Where
    tag: str         # tag semantics; "" = the point is untagged
    supports: frozenset


def _reg(*points: FaultPoint) -> dict:
    return {p.point: p for p in points}


# The fault points the port's modules thread, each with the EXACT action
# set its call site passes to ``hit()``.
REGISTRY: dict[str, FaultPoint] = _reg(
    FaultPoint("stratum.client.read", "stratum/client.py read loop",
               "host:port", POINT),
    FaultPoint("stratum.client.send", "stratum/client.py _send",
               "host:port", SEND_ASYNC),
    FaultPoint("stratum.server.read", "stratum/server.py per-client loop",
               "session id", POINT),
    FaultPoint("stratum.server.write", "stratum/server.py _write_line",
               "session id", SEND_SYNC),
    FaultPoint("region.handoff", "stratum/server.py _try_resume",
               "session id", POINT),
    FaultPoint("p2p.peer.send", "p2p/node.py writer",
               "peer id prefix (12 hex)", SEND_SYNC),
    FaultPoint("p2p.peer.recv", "p2p/node.py reader",
               "peer id prefix (12 hex)", POINT),
    FaultPoint("p2p.mem.send", "p2p/memnet.py MemoryWriter",
               "remote id prefix (8 hex)", SEND_SYNC),
    FaultPoint("p2p.share.verify", "p2p/pool.py _on_share",
               "share id prefix (12 hex)", STEP),
    FaultPoint("p2p.sync", "p2p/pool.py locator sync",
               "peer id prefix (12 hex)", STEP),
    FaultPoint("chain.persist",
               "p2p/chainstore.py journal/archive appends (writer thread)",
               "journal|archive", STEP),
    FaultPoint("chain.snapshot",
               "p2p/chainstore.py write_snapshot (writer thread)",
               "", STEP),
    FaultPoint("chain.fsync",
               "p2p/chainstore.py writer thread, per journal group-fsync",
               "", POINT),
    FaultPoint("db.execute", "db/database.py execute/executemany",
               "", POINT),
    FaultPoint("ledger.flush",
               "pool/manager.py on_share_batch, between validation and db",
               "", STEP),
    FaultPoint("validation.verify", "runtime/validate.py device verdict",
               "algorithm", DEVICE),
    FaultPoint("pool.submitter.submit", "pool/submitter.py retry loop",
               "", STEP),
    FaultPoint("pool.failover.check", "pool/failover.py check_pool",
               "pool name", POINT),
    FaultPoint("engine.batch", "engine/engine.py search loop",
               "backend name", STEP),
    FaultPoint("device.call", "engine/engine.py _call_device_sync",
               "backend name", DEVICE),
)


@dataclasses.dataclass
class Directive:
    """What a fault point must do, decided by the injector, applied by
    the call site (which owns the writer/loop the fault acts on)."""

    drop: bool = False        # swallow the send entirely
    truncate: int = -1        # >= 0: write only this many bytes, then fail
    delay: float = 0.0        # stall this long before proceeding
    crash: str | None = None  # component name whose crash handler fired
    corrupt: bool = False     # mangle the call's result (wrong-result mode)

    def sleep_sync(self) -> None:
        """Apply the delay on a synchronous (non-event-loop) path."""
        if self.delay > 0:
            time.sleep(self.delay)


@dataclasses.dataclass
class FaultRule:
    """One composable fault: WHERE (point glob), WHAT (action), WHEN
    (schedule). All schedule gates must pass for the rule to fire."""

    point: str                       # exact key or fnmatch glob
    action: str                      # error | delay | drop | truncate | crash
    # action parameters
    exc: Callable[[], BaseException] | type | None = None
    seconds: float = 0.0             # delay duration
    keep_bytes: int = 0              # truncate: bytes allowed through
    component: str = ""              # crash target
    # schedule
    # schedule gates are PER MATCHED POINT (per tagged key), like the
    # RNGs and hit counts: a glob rule with once/max_fires fires that
    # budget at EVERY point it matches, so the schedule at one point
    # never depends on which other point's task got scheduled first
    probability: float = 1.0         # per-eligible-hit firing chance
    every_nth: int = 0               # fire on hits N, 2N, 3N, ... (0 = off)
    once: bool = False               # first eligible hit per point only
    window: tuple[float, float] | None = None  # (start, end) s since activate
    max_fires: int = 0               # per-point fire cap (0 = no cap)
    # live state: total fires across all matched points (observability)
    fires: int = 0

    def make_exc(self) -> BaseException:
        if self.exc is None:
            return FaultInjectedError(f"injected fault at {self.point}")
        if isinstance(self.exc, type):
            return self.exc(f"injected fault at {self.point}")
        return self.exc()


@dataclasses.dataclass
class _PointStats:
    hits: int = 0
    faults: int = 0


class FaultInjector:
    """Seeded registry of fault rules with per-point accounting.

    Thread-safe: fault points fire from the event loop AND from executor
    threads (db writes, engine backends), so every mutation sits under
    one lock. The lock is only ever taken while an injector is active —
    the disabled path never reaches it.
    """

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultInjector":
        """Rebuild an injector from a plain-data plan in ANOTHER process.

        The shard supervisor (stratum/shard.py) ships seeded fault plans
        to its acceptor workers over process spawn args, so a chaos run
        stays deterministic per worker even though each worker owns its
        own process-global injector. Only data-only rules round-trip:
        ``exc`` callables cannot cross the boundary (error rules raise
        the default ``FaultInjectedError``), and crash components are
        names the RECEIVING process must register handlers for.

            {"seed": 7, "rules": [
                {"point": "worker.crash:*", "action": "crash",
                 "component": "worker", "every_nth": 4, "max_fires": 1}]}
        """
        inj = cls(seed=int(spec.get("seed", 0)))
        for r in spec.get("rules", []):
            window = r.get("window")
            inj.add(FaultRule(
                point=str(r["point"]),
                action=str(r["action"]),
                seconds=float(r.get("seconds", 0.0)),
                keep_bytes=int(r.get("keep_bytes", 0)),
                component=str(r.get("component", "")),
                probability=float(r.get("probability", 1.0)),
                every_nth=int(r.get("every_nth", 0)),
                once=bool(r.get("once", False)),
                window=(float(window[0]), float(window[1])) if window else None,
                max_fires=int(r.get("max_fires", 0)),
            ))
        return inj

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rules: list[FaultRule] = []
        self.points: dict[str, _PointStats] = {}
        self.armed_at = 0.0      # set by activate()
        self._lock = threading.RLock()
        self._rngs: dict[tuple[int, str], random.Random] = {}
        self._rule_hits: dict[tuple[int, str], int] = {}
        self._rule_fires: dict[tuple[int, str], int] = {}
        self._match_cache: dict[tuple[int, str], bool] = {}
        self._crash_handlers: dict[str, Callable[[], None]] = {}

    # -- plan construction (chainable) --------------------------------------

    def add(self, rule: FaultRule) -> "FaultInjector":
        self.rules.append(rule)
        return self

    def error(self, point: str, exc=None, **sched) -> "FaultInjector":
        return self.add(FaultRule(point, "error", exc=exc, **sched))

    def delay(self, point: str, seconds: float, **sched) -> "FaultInjector":
        return self.add(FaultRule(point, "delay", seconds=seconds, **sched))

    def drop(self, point: str, **sched) -> "FaultInjector":
        return self.add(FaultRule(point, "drop", **sched))

    def truncate(self, point: str, keep_bytes: int = 0, **sched) -> "FaultInjector":
        """a.k.a. short_write: let ``keep_bytes`` through, then fail."""
        return self.add(FaultRule(point, "truncate", keep_bytes=keep_bytes, **sched))

    short_write = truncate

    def corrupt(self, point: str, **sched) -> "FaultInjector":
        """Wrong-result mode: the call completes on time but the call
        site mangles its payload (device.call: winner digests inverted)
        — models silent data corruption the deadline cannot see."""
        return self.add(FaultRule(point, "corrupt", **sched))

    wrong_result = corrupt

    def crash(self, point: str, component: str, **sched) -> "FaultInjector":
        return self.add(FaultRule(point, "crash", component=component, **sched))

    def register_crash_handler(self, component: str,
                               fn: Callable[[], None]) -> None:
        """Register what "crash <component>" means (cancel its tasks,
        abort its transport, ...). Handlers must be synchronous; a crash
        rule firing with no handler raises FaultInjectedError instead."""
        self._crash_handlers[component] = fn

    # -- the fault point ----------------------------------------------------

    def _rng_for(self, idx: int, key: str) -> random.Random:
        rng = self._rngs.get((idx, key))
        if rng is None:
            digest = hashlib.sha256(
                f"{self.seed}|{idx}|{key}".encode()
            ).digest()
            rng = random.Random(int.from_bytes(digest[:8], "big"))
            self._rngs[(idx, key)] = rng
        return rng

    def _matches(self, idx: int, rule: FaultRule, point: str, key: str) -> bool:
        cached = self._match_cache.get((idx, key))
        if cached is None:
            cached = (
                rule.point == key
                or rule.point == point
                or fnmatch.fnmatchcase(key, rule.point)
            )
            self._match_cache[(idx, key)] = cached
        return cached

    def hit(self, point: str, tag: str | None = None,
            supports: frozenset | None = None) -> Directive | None:
        """Evaluate one fault-point hit. Raises for ``error``/handlerless
        ``crash`` rules; returns a Directive for drop/truncate/delay; None
        when nothing fires. First matching rule that fires wins.
        ``supports`` names the actions this seam can apply — rules with
        any other action are skipped WITHOUT counting as fired."""
        key = point if tag is None else f"{point}:{tag}"
        with self._lock:
            stats = self.points.get(key)
            if stats is None:
                stats = self.points[key] = _PointStats()
            stats.hits += 1
            now = time.monotonic() - self.armed_at
            for idx, rule in enumerate(self.rules):
                if supports is not None and rule.action not in supports:
                    continue
                if not self._matches(idx, rule, point, key):
                    continue
                if rule.window is not None and not (
                        rule.window[0] <= now < rule.window[1]):
                    continue
                fired = self._rule_fires.get((idx, key), 0)
                if rule.max_fires and fired >= rule.max_fires:
                    continue
                if rule.once and fired:
                    continue
                n = self._rule_hits.get((idx, key), 0) + 1
                self._rule_hits[(idx, key)] = n
                if rule.every_nth and n % rule.every_nth:
                    continue
                if rule.probability < 1.0 and (
                        self._rng_for(idx, key).random() >= rule.probability):
                    continue
                self._rule_fires[(idx, key)] = fired + 1
                rule.fires += 1
                stats.faults += 1
                return self._apply(rule, key)
        return None

    def _apply(self, rule: FaultRule, key: str) -> Directive | None:
        # called under the lock; only crash handlers run user code here,
        # and they are required to be quick + sync (abort/cancel calls)
        if rule.action == "error":
            raise rule.make_exc()
        if rule.action == "delay":
            return Directive(delay=rule.seconds)
        if rule.action == "drop":
            return Directive(drop=True)
        if rule.action == "truncate":
            return Directive(truncate=rule.keep_bytes)
        if rule.action == "corrupt":
            return Directive(corrupt=True)
        if rule.action == "crash":
            handler = self._crash_handlers.get(rule.component)
            if handler is None:
                raise FaultInjectedError(
                    f"injected crash of {rule.component!r} at {key} "
                    "(no crash handler registered)"
                )
            handler()
            return Directive(crash=rule.component)
        raise ValueError(f"unknown fault action {rule.action!r}")

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """Injector state for the API/engine snapshot: chaos runs are
        only trustworthy when you can SEE which seams actually fired.

        Beyond the hit/fault counters, this exposes what a chaos driver
        needs to verify its schedule actually ARMED before trusting a
        green audit: the registered crash-handler names (a crash rule
        with no handler degrades to a raise, which is usually not what
        the plan meant) and each rule's per-point remaining-fire budget
        (``once``/``max_fires`` rules that never reached their cap mean
        the scenario under-fired)."""
        with self._lock:
            rules = []
            for idx, r in enumerate(self.rules):
                cap = 1 if r.once else (r.max_fires or 0)
                entry = {
                    "point": r.point,
                    "action": r.action,
                    "fires": r.fires,
                    # 0 = unlimited; else the per-matched-point fire cap
                    "per_point_cap": cap,
                }
                if cap:
                    # keys this rule has fired at, with budget left;
                    # points never hit simply don't appear (full budget)
                    entry["remaining"] = {
                        key: cap - fired
                        for (i, key), fired in sorted(
                            self._rule_fires.items())
                        if i == idx
                    }
                rules.append(entry)
            return {
                "active": self is _active,
                "seed": self.seed,
                "crash_handlers": sorted(self._crash_handlers),
                "points": {
                    key: {"hits": s.hits, "faults": s.faults}
                    for key, s in sorted(self.points.items())
                },
                "rules": rules,
            }


# -- process-global activation ------------------------------------------------

_active: FaultInjector | None = None


def activate(injector: FaultInjector) -> FaultInjector:
    """Install the process-global injector (chaos runs only)."""
    global _active
    injector.armed_at = time.monotonic()
    _active = injector
    return injector


def deactivate() -> None:
    global _active
    _active = None


def get() -> FaultInjector | None:
    return _active


@contextmanager
def active(injector: FaultInjector):
    """``with faults.active(inj): ...`` — deterministic scope for tests."""
    activate(injector)
    try:
        yield injector
    finally:
        deactivate()


def hit(point: str, tag: str | None = None,
        supports: frozenset | None = None) -> Directive | None:
    """THE fault point. Disabled cost: one global load + None check."""
    inj = _active
    if inj is None:
        return None
    return inj.hit(point, tag, supports)


def snapshot_active() -> dict:
    """Snapshot provider shape for the API server (always callable)."""
    inj = _active
    if inj is None:
        return {"active": False}
    return inj.snapshot()
